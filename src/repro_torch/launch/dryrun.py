"""Dry run: walk every (arch × shape) cell of the production meshes on the
meta device and report its counted work, per-device memory and roofline,
the reference's ``launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod | --both-meshes] [--json out.json]

A cell is walked, not compiled: its step (``repro_torch.launch.specs``)
runs once on ``torch.device("meta")`` under the counting mode
(``repro_torch.utils.cost``), which gives its FLOPs, its bytes (each op's
inputs read and outputs written once: eager's traffic) and the peak of the
bytes its own tensors hold.  Nothing is allocated on any device.

Depth (the reference's two-point calibration, for the walk's time here:
falcon-mamba-7b's scan is one op a token a layer, so a full-depth walk of
prefill_32k alone would take minutes).  With per-body cost ``b`` and
non-loop cost ``c``, walks at 2 and 4 bodies give ``B2 = c + 2·b`` and
``B4 = c + 4·b``, so ``b = (B4 − B2)/2``, ``c = 2·B2 − B4`` and the
production count is ``c + L·b`` (``L``: :func:`n_bodies`), in integers,
exact where every body does the same work.  ``flops``, ``bytes`` and the
flash ops are extrapolated so.  The peak bytes are not a sum but a maximum
over the walk, and which point of the walk holds it can move with depth
(a train step's end of forward, where the activations of every layer are
live, against its optimizer update, where the gradients of every layer
are): :func:`extrapolate_peak` extrapolates the live bytes after every op
of the first and the last body of each loop over the layers, and of what
lies outside the loops, each of which grows linearly with depth, and
takes their maximum.  ``tests/test_torch_dryrun.py`` holds all four to
full-depth walks.

Per device: the walk is the whole (global) step, so FLOPs, bytes and the
peak bytes per device are the global counts over the chips, perfect
balance assumed.  (The reference's SPMD count also carries the compute
that replicated heads repeat on every ``model`` shard; this one does
not.)  Argument bytes per device (parameters, the train state, or
parameters and cache, and the inputs) are summed exactly from the specs
(``repro_torch.sharding.rules``), and the collective bytes per device are
counted from the specs of the production config by
``repro_torch.utils.roofline.collective_bytes``, which needs no walk.
The roofline divides those per-device counts by the H100's peaks, once.

Records keep the reference's keys where their meaning holds
(``flops_corrected``: counted and extrapolated, not compiled);
``output_bytes_per_device`` is null; there are no ``compile_*_s`` and no
``flops_raw_A`` (the walks' time is ``walk_s``).  The multi-pod mesh's
records are whole too: a walk does not depend on the mesh, so both meshes
read the same walks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import sys
import time

from repro_torch.configs import ARCH_IDS, SHAPES, cell_runnable, get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import (
    abstract_params,
    argument_bytes,
    build_cell,
    count_params,
    named_tensors,
)
from repro_torch.models import model
from repro_torch.sharding.rules import batch_axes, param_specs, rule_path
from repro_torch.utils.cost import NONLOOP, CostMode
from repro_torch.utils.roofline import (
    Roofline,
    collective_bytes,
    model_flops_decode,
    model_flops_train,
    roofline_line,
)

COUNTS = ("flops", "bytes", "flash_ops")
FLASH_OP = "repro_torch.flash_attention"


def calib_config(cfg, bodies: int = 2):
    """Variant of cfg with ``bodies`` layer bodies, for cost calibration."""
    changes = {"n_layers": bodies}
    if cfg.hybrid_attn_every:
        changes["n_layers"] = bodies * cfg.hybrid_attn_every  # groups
    if cfg.encoder:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=bodies)
    return dataclasses.replace(cfg, **changes)


def n_bodies(cfg) -> int:
    """Number of layer bodies in the production config."""
    if cfg.hybrid_attn_every:
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def body_label(cfg, path: str) -> int | None:
    """The layer body of the argument tensor at ``path`` (``named_tensors``):
    a layer's parameter, moment or cache (a hybrid's SSM layer ``i`` in
    group ``i // g``, whisper's encoder layer ``i`` in body ``i``);
    :data:`NONLOOP` for the rest; None for a hybrid's shared block, which
    runs in every body."""
    if "shared_attn" in path:
        return None
    if m := (re.search(r"enc_layers[./](\d+)", path)
             or re.search(r"(?:^|[./])(?:attn|cross)/(\d+)", path)):
        return int(m.group(1))
    if m := re.search(r"(?:^|[./])(?:layers|ssm)[./](\d+)", path):
        return int(m.group(1)) // (cfg.hybrid_attn_every or 1)
    return NONLOOP


def walk(cfg, shape) -> dict:
    """The cell's step walked once on meta under :class:`CostMode`: its
    ``flops``, ``bytes``, ``peak_bytes``, ``flash_ops``, ``walk_s`` and the
    mode's ``trace`` of live bytes by body.  The body labels are those of
    the arguments and, in a train step, of each parameter's gradient (a
    hook on the parameter labels it when autograd makes it)."""
    step, args, _, _ = build_cell(cfg, shape, make_host_mesh())
    labels, hooks = {}, []
    for path, t in named_tensors(args):
        label = body_label(cfg, path)
        if label is None:
            continue
        labels[t.untyped_storage()._cdata] = label
        if t.requires_grad:
            hooks.append(t.register_hook(
                lambda g, label=label: labels.__setitem__(g.untyped_storage()._cdata, label)))
    # whisper's sinusoid tables are made by the first step of a process and
    # cached (models/model.py): every walk makes them, whatever ran before
    model._sinusoid.cache_clear()
    t0 = time.perf_counter()
    try:
        with CostMode(labels=labels) as mode:
            step(*args)
    finally:
        for h in hooks:
            h.remove()
    return {**mode.counts(), "flash_ops": mode.ops[FLASH_OP],
            "walk_s": time.perf_counter() - t0, "trace": mode.trace}


def extrapolate(b2: int, b4: int, bodies: int) -> int:
    """``c + L·b`` from the counts at 2 and 4 bodies, in integers."""
    two = max(b4 - b2, 0)  # two bodies
    nonloop = max(b2 - two, 0)
    return nonloop + bodies * two // 2


def _ends(trace: list, last: int) -> dict:
    """A walk's live bytes after each op, in order, of what lies outside the
    loops over the layers (:data:`NONLOOP`), of body 0 and of body
    ``last`` (under 1); the middle bodies' are left out."""
    out: dict = {NONLOOP: [], 0: [], 1: []}
    for label, live in trace:
        if label in (NONLOOP, 0):
            out[label].append(live)
        elif label == last:
            out[1].append(live)
    return out


def extrapolate_peak(trace2: list, trace4: list, bodies: int) -> int:
    """The peak live bytes at ``bodies`` bodies from the traces of walks at 2
    and 4.  After the n-th op of the first or of the last body, or outside
    the loops, the live bytes are ``c + L·b`` (every other body leaves the
    same bytes behind, and the bodies between hold less than the two at
    the ends of a loop), so each such point extrapolates like a count;
    the peak is their maximum.  Raises ``ValueError`` where the two walks
    do not line up op for op."""
    two, four = _ends(trace2, 1), _ends(trace4, 3)
    if any(len(two[k]) != len(four[k]) for k in two):
        raise ValueError("the walks at 2 and 4 bodies differ outside their middle bodies")
    return max(a + (bodies - 2) * (b - a) // 2
               for k in two for a, b in zip(two[k], four[k]))


def corrected_counts(cfg, shape) -> dict:
    """The production depth's counts from walks at 2 and 4 bodies, and the
    walks' seconds."""
    two = walk(calib_config(cfg, 2), shape)
    four = walk(calib_config(cfg, 4), shape)
    out = {k: extrapolate(two[k], four[k], n_bodies(cfg)) for k in COUNTS}
    out["peak_bytes"] = extrapolate_peak(two["trace"], four["trace"], n_bodies(cfg))
    out["walk_s"] = two["walk_s"] + four["walk_s"]
    return out


def step_collectives(cfg, shape, mesh: dict, meta: dict) -> dict:
    """Per-device collective bytes of the cell's step, from the production
    config's parameter specs (``utils/roofline.py`` states the formula).
    A step reads the parameters it uses: prefill (features only) not the
    head; decode not the encoder nor the cross K/V weights (the cache
    holds the cross K/V)."""
    kind = meta["kind"]
    n_batch = math.prod(mesh[a] for a in batch_axes(mesh))
    rows = shape.global_batch
    if kind != "decode" or meta["batch_shardable"]:
        rows = rows / n_batch
    tokens = rows * (1 if kind == "decode" else shape.seq_len)
    groups = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 1
    params = abstract_params(cfg)
    specs = param_specs(params.named_parameters(), mesh, cfg.moe is not None)
    tensors = []
    for name, p in params.named_parameters():
        path = rule_path(name)
        if kind == "prefill" and path == "lm_head":
            continue
        if kind == "decode" and (path.startswith("enc_") or path.endswith(("cross/wk",
                                                                           "cross/wv"))):
            continue
        act = tokens
        if path.startswith("enc_"):
            act = rows * cfg.encoder.n_frames
        elif path.startswith("shared_attn/"):
            act = groups * tokens
        tensors.append((path, tuple(p.shape), p.element_size(), specs[name], act))
    return collective_bytes(tensors, mesh, train=kind == "train", d_model=cfg.d_model,
                            act_bytes=params.embed.element_size(),
                            top_k=cfg.moe.top_k if cfg.moe else 0)


def _mesh_name(mesh: dict) -> str:
    return "x".join(str(n) for n in mesh.values())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
             walks: dict | None = None) -> dict:
    """One cell's record; ``walks`` keeps each cell's corrected counts for
    the next mesh (a walk does not depend on the mesh)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        if verbose:
            print(f"--- {arch} × {shape_name}: SKIPPED ({why})")
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(mesh.values())
    corr = (walks or {}).get((arch, shape_name)) or corrected_counts(cfg, shape)
    if walks is not None:
        walks[(arch, shape_name)] = corr
    _, args, specs, meta = build_cell(cfg, shape, mesh)
    coll = step_collectives(cfg, shape, mesh, meta)
    roof = Roofline(flops=corr["flops"] / chips, bytes_accessed=corr["bytes"] / chips,
                    collective_bytes=coll["total"])

    total_p, active_p = count_params(cfg)
    kind, tokens = meta["kind"], meta["tokens"]
    mf = model_flops_train(active_p, tokens) if kind == "train" else model_flops_decode(
        active_p, tokens)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "status": "ok",
        "mesh": _mesh_name(mesh),
        "kind": kind,
        "chips": chips,
        "walk_s": corr["walk_s"],
        "bodies": n_bodies(cfg),
        "flops_corrected": corr["flops"],
        "bytes_corrected": corr["bytes"],
        "peak_bytes_corrected": corr["peak_bytes"],
        "flash_ops": corr["flash_ops"],
        "collective_bytes_corrected": coll["total"],
        "collective_detail": coll,
        "params_total": total_p,
        "params_active": active_p,
        "flops_per_device": roof.flops,
        "bytes_per_device": roof.bytes_accessed,
        "model_flops_per_device": mf / chips,
        "model_flops_util": (mf / chips) / max(roof.flops, 1.0),
        "temp_bytes_per_device": corr["peak_bytes"] / chips,
        "argument_bytes_per_device": argument_bytes(args, specs, mesh),
        "output_bytes_per_device": None,
        **roof.row(),
    }
    if verbose:
        print(f"--- {arch} × {shape_name} [{rec['mesh']}] ---")
        print(f"  walks at 2 and 4 bodies {corr['walk_s']:.1f}s; L={rec['bodies']} bodies")
        print(f"  memory: args={rec['argument_bytes_per_device']} "
              f"temp={rec['temp_bytes_per_device']:.4g}")
        print(f"  corrected: flops={corr['flops']:.3e} bytes={corr['bytes']:.3e} "
              f"coll={coll['total']:.3e}")
        print(f"  {roofline_line(rec)}")
        print(f"  model_flops_util={rec['model_flops_util']:.3f}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if args.both_meshes else [args.multipod]
    records = []
    failures = 0
    walks: dict = {}
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp, walks=walks)
            except Exception as e:  # a failure here is a port or sharding bug
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                       "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                print(f"--- {arch} × {shape} FAILED: {rec['error']}", file=sys.stderr)
            records.append(rec)
            sys.stdout.flush()

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (documented), {failures} failed ==")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
