#!/usr/bin/env python
"""One-line variants of the bf16 flash-attention kernel on a GPU: what a
line costs, and that the checks catch a broken kernel.

    python scripts/flash_ablation.py

Builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
and copies of it that each change one line (written to the git-ignored
``build/ablation/``), one ``nvcc`` each, started together, and loads each
through ``build.load``.  Every variant is launched by ``kernel.launch``
(the port's own C call, uncounted) and held against the plain version by
``chip_smoke.py``'s own functions:

- the first bf16 case of the reference's test matrix (b 2, hq 4, hkv 4,
  s 256, dh 64, causal): its worst entry over ``chip_smoke.py``'s bound;
- the bf16 entries that differ from the float32 plain result rounded to
  bf16, over ``chip_smoke.py``'s bf16 matrix and ragged cases and
  qwen2-vl-2b's shape (b 2, hq 12, hkv 2, s 4096, dh 128; causal and
  window 512), against its limit ``BF16_DIFFER_SHARE``.

The kernel must keep both.  Each mutant (a skipped k tile at keys 64–127,
q tile 1 scaled by 1.01, P as ``P_hi`` alone) must break the bound on the
first case, and the copy with two P terms must exceed the share limit;
else the script exits 1.  All but the mutants are also timed at
qwen2-vl-2b's shape with CUDA events, in two rounds of opposite order: the
difference of a copy's time to the kernel's is what its line costs.
Prints the card's nvidia-smi line and one JSON object; exits 1 without a
CUDA device.
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
# name: (role, line of the source, its replacement); roles: "kernel" keeps
# every check, "terms" is the share limit's other reading, "timing" is
# only timed, "mutant" must break the bound
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
}
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
    # (tag, inputs, causal, window, plain float32 result): every bf16 case
    # of chip_smoke.py's flash check, with its seed
    cases = []
    for i, (shape, dtype, causal, window) in enumerate(smoke.flash_cases()):
        if dtype == torch.bfloat16:
            qkv = smoke._qkv(dev, dtype, *shape, seed=i)
            cases.append((smoke.flash_tag(shape), qkv, causal, window,
                          smoke.flash_ref(*qkv, causal, window)))
    main_qkv = smoke._qkv(dev, torch.bfloat16, B, HQ, HKV, S, S, DH, seed=7)
    for window in WINDOWS:
        cases.append((f"main window={window}", main_qkv, True, window,
                      smoke.flash_ref(*main_qkv, True, window)))

    report, failures = {}, []
    for name, lib in libs.items():
        role = VARIANTS[name][0]
        tag, qkv, causal, window, ref = cases[0]
        first = smoke.flash_agreement(run(lib, *qkv, causal, window), ref)[1]
        rep = {"role": role, "first_case_ratio": first}
        if role == "mutant":
            if first <= 1.0:
                failures.append(f"mutant {name} keeps the bound ({first:.3f}x)")
        else:
            worst, differ = {}, {}
            for tag, qkv, causal, window, ref in cases:
                _, ratio, n = smoke.flash_agreement(run(lib, *qkv, causal, window), ref)
                worst[tag] = max(worst.get(tag, 0.0), ratio)
                d = differ.setdefault(tag, [0, 0])
                d[0] += n
                d[1] += ref.numel()
            share = {tag: n / total for tag, (n, total) in differ.items()}
            rep.update(worst_ratio=worst, differ=differ, share=share)
            if role == "kernel" and (max(worst.values()) > 1.0
                                     or max(share.values()) > smoke.BF16_DIFFER_SHARE):
                failures.append(f"the kernel misses a check: {rep}")
            if role == "terms" and max(share.values()) <= smoke.BF16_DIFFER_SHARE:
                failures.append(f"{name} keeps the share limit: {share}")
            rep["ms"] = {str(window): [] for window in WINDOWS}
        report[name] = rep
        print(f"{name} ({role}): {smoke.flash_design(True, lib)}; {rep}", flush=True)

    timed = [name for name in libs if VARIANTS[name][0] != "mutant"]
    for order in (timed, timed[::-1]):
        for name in order:
            for window in WINDOWS:
                report[name]["ms"][str(window)].append(smoke.time_ms(
                    lambda lib=libs[name], w=window: run(lib, *main_qkv, True, w), 20))
    for name in timed:
        print(f"{name}: " + "; ".join(f"window={w} {' '.join(f'{t:.4f}' for t in ts)} ms"
                                      for w, ts in report[name]["ms"].items()))
    print(smoke.nvidia_smi_line())
    print(json.dumps({"shape": [B, HQ, HKV, S, DH], "limit": smoke.BF16_DIFFER_SHARE,
                      "variants": report}))
    for msg in failures:
        print(f"flash_ablation: FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
