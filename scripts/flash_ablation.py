#!/usr/bin/env python
"""One-line variants of the flash-attention kernels on a GPU: what a line
costs, and that the checks catch a broken kernel.

    python scripts/flash_ablation.py

Builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
and copies of it that each change one line (written to the git-ignored
``build/ablation/``), one ``nvcc`` each, started together, and loads each
through ``build.load``.  Every variant is launched by ``kernel.launch``
(the port's own C call, uncounted) and held against the plain version by
``chip_smoke.py``'s own functions.

The bf16 kernel, on bf16 inputs:

- the first bf16 case of the reference's test matrix (b 2, hq 4, hkv 4,
  s 256, dh 64, causal): its worst entry over ``chip_smoke.py``'s bound;
- the bf16 entries that differ from the float32 plain result rounded to
  bf16, over ``chip_smoke.py``'s bf16 matrix and ragged cases and
  qwen2-vl-2b's shape (b 2, hq 12, hkv 2, s 4096, dh 128; causal and
  window 512), against its limit ``BF16_DIFFER_SHARE``.

The kernel must keep both.  Each mutant (a skipped k tile at keys 64–127,
q tile 1 scaled by 1.01, P as ``P_hi`` alone) must break the bound on the
first case, and the copy with two P terms must exceed the share limit.

The float32 kernel, on float32 inputs: every float32 case of
``chip_smoke.py``'s flash check and qwen2-vl-2b's shape, each against the
float64 plain result.  The kernel must keep the bound on all; each f32
mutant (Q·Kᵀ, or P·V, without its smallest term product, q_0·k_2 or
p_0·v_2) must break it on the first float32 case of the matrix; the
f32 timing copy (``__expf`` for ``expf``) is read, not held.

Else the script exits 1.  All but the bf16 mutants are timed at
qwen2-vl-2b's shape with CUDA events, in two rounds of opposite order, on
bf16 inputs or float32 ones as the variant's role says: the difference of
a copy's time to the kernel's is what its line costs.  Prints the card's
nvidia-smi line and one JSON object; exits 1 without a CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import build, kernel  # noqa: E402

EXP = "expf(sc[i] - mx[h])"
TERMS = "constexpr int P_TERMS = 3;"
OUT = "__floats2bfloat162_rn(acc[4 * i + 2 * h] / denom, acc[4 * i + 2 * h + 1] / denom)"
SCALED = " * (iq == 1 ? 1.01f : 1.f)"
QK = "constexpr int QK_PRODUCTS = 6;"
PV = "constexpr int PV_PRODUCTS = 6;"
F32_EXP = "expf(st[j] - top[h])"
# name: (role, line of the source, its replacement); roles: "kernel" keeps
# every check, "terms" is the share limit's other reading, "timing" is
# only timed, "mutant" must break the bf16 bound; "f32 mutant" must break
# the float32 bound, "f32 timing" is only timed, on float32 inputs
VARIANTS = {
    "kernel": ("kernel", None, None),
    "p_terms_2": ("terms", TERMS, TERMS.replace("3", "2")),
    "fast_exp": ("timing", EXP, "__expf(sc[i] - mx[h])"),
    "no_exp": ("timing", EXP, "(sc[i] - mx[h])"),
    "skip_tile": ("mutant", "    unsigned live = 0xffffffffu;",
                  "    unsigned live = k_start == BK ? 0u : 0xffffffffu;"),
    "scale_q1": ("mutant", OUT, OUT.replace("/ denom,", f"/ denom{SCALED},")
                 .replace("/ denom)", f"/ denom{SCALED})")),
    "p_hi_only": ("mutant", TERMS, TERMS.replace("3", "1")),
    "f32_qk_products_5": ("f32 mutant", QK, QK.replace("6", "5")),
    "f32_pv_products_5": ("f32 mutant", PV, PV.replace("6", "5")),
    "f32_fast_exp": ("f32 timing", F32_EXP, f"__{F32_EXP}"),
}
F32_ROLES = ("f32 mutant", "f32 timing")
B, HQ, HKV, S, DH = smoke.LM_BATCH, 12, 2, smoke.LM_SEQ, 128
WINDOWS = (None, 512)


def sources() -> dict[str, pathlib.Path]:
    text = build.SOURCE.read_text()
    out_dir = ROOT / "build" / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (_, old, new) in VARIANTS.items():
        if old is None:
            paths[name] = build.SOURCE
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not one line of the source")
        path = out_dir / f"flash_attention_{name}.cu"
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def run(lib, q, k, v, causal, window):
    out = torch.empty_like(q)
    kernel.launch(lib, q, k, v, out, scale=q.shape[-1] ** -0.5, causal=causal,
                  window=window)
    return out


def checks(lib, cases, limit_share):
    """Worst entry over its bound of each group of ``cases``, and for bf16
    the entries that differ and their share."""
    worst, differ = {}, {}
    for tag, qkv, causal, window, ref in cases:
        _, ratio, n = smoke.flash_agreement(run(lib, *qkv, causal, window), ref)
        worst[tag] = max(worst.get(tag, 0.0), ratio)
        d = differ.setdefault(tag, [0, 0])
        d[0] += n
        d[1] += ref.numel()
    rep = {"worst_ratio": worst}
    if limit_share:
        rep.update(differ=differ, share={tag: n / total for tag, (n, total) in differ.items()})
    return rep


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = sources()
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = {name: build.load(lib) for name, (lib, _) in
                zip(paths, pool.map(nvcc.build, paths.values()))}
    dev = torch.device("cuda")
    # (tag, inputs, causal, window, plain result: float32 for bf16 inputs,
    # float64 for float32 ones): every case of chip_smoke.py's flash check,
    # with its seed, then qwen2-vl-2b's shape
    cases = {torch.bfloat16: [], torch.float32: []}
    for i, (shape, dtype, causal, window) in enumerate(smoke.flash_cases()):
        qkv = smoke._qkv(dev, dtype, *shape, seed=i)
        cases[dtype].append((smoke.flash_tag(shape), qkv, causal, window,
                             smoke.flash_ref(*qkv, causal, window)))
    main_qkv = {dtype: smoke._qkv(dev, dtype, B, HQ, HKV, S, S, DH, seed=7) for dtype in cases}
    for dtype, qkv in main_qkv.items():
        for window in WINDOWS:
            cases[dtype].append((f"main window={window}", qkv, True, window,
                                 smoke.flash_ref(*qkv, True, window)))

    report, failures = {}, []
    for name, lib in libs.items():
        role = VARIANTS[name][0]
        dtype = torch.float32 if role in F32_ROLES else torch.bfloat16
        tag, qkv, causal, window, ref = cases[dtype][0]
        first = smoke.flash_agreement(run(lib, *qkv, causal, window), ref)[1]
        rep = {"role": role, "first_case_ratio": first}
        if role in ("mutant", "f32 mutant"):
            if first <= 1.0:
                failures.append(f"mutant {name} keeps the bound ({first:.3f}x)")
        else:
            rep.update(checks(lib, cases[dtype], dtype == torch.bfloat16))
            worst, share = rep["worst_ratio"], rep.get("share", {})
            if role == "kernel":
                rep["f32"] = checks(lib, cases[torch.float32], False)
                if (max(worst.values()) > 1.0 or max(share.values()) > smoke.BF16_DIFFER_SHARE
                        or max(rep["f32"]["worst_ratio"].values()) > 1.0):
                    failures.append(f"the kernel misses a check: {rep}")
            if role == "terms" and max(share.values()) <= smoke.BF16_DIFFER_SHARE:
                failures.append(f"{name} keeps the share limit: {share}")
        rep["ms"] = {str(window): [] for window in WINDOWS}
        if role == "kernel":
            rep["f32_ms"] = {str(window): [] for window in WINDOWS}
        report[name] = rep
        design = smoke.flash_design(dtype == torch.bfloat16, lib)
        print(f"{name} ({role}): {design}; {rep}", flush=True)

    # (variant, key of its times, dtype): the bf16 copies but the mutants,
    # and the float32 ones with the kernel
    timed = [(name, "ms", torch.bfloat16) for name in libs
             if VARIANTS[name][0] in ("kernel", "terms", "timing")]
    timed += [(name, "ms" if VARIANTS[name][0] in F32_ROLES else "f32_ms", torch.float32)
              for name in libs if VARIANTS[name][0] in ("kernel", *F32_ROLES)]
    for order in (timed, timed[::-1]):
        for name, key, dtype in order:
            for window in WINDOWS:
                report[name][key][str(window)].append(smoke.time_ms(
                    lambda lib=libs[name], w=window, qkv=main_qkv[dtype]: run(lib, *qkv, True, w),
                    20))
    for name, key, dtype in timed:
        print(f"{name} {str(dtype)[6:]}: " + "; ".join(
            f"window={w} {' '.join(f'{t:.4f}' for t in ts)} ms"
            for w, ts in report[name][key].items()))
    print(smoke.nvidia_smi_line())
    print(json.dumps({"shape": [B, HQ, HKV, S, DH], "limit": smoke.BF16_DIFFER_SHARE,
                      "variants": report}))
    for msg in failures:
        print(f"flash_ablation: FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
