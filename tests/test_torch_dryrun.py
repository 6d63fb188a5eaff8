"""The port's dry run on the CPU: the shape grid, parameter counts and
``estimate_cell`` against the JAX reference's, the counting mode's walks
on the meta device against real CPU runs of the same steps, against a
hand count, and the two-point depth extrapolation against full-depth
walks; the roofline's printed line against its JSON row, and the CLI.

Full-size configs are only built on meta (the port) and traced by
``jax.eval_shape`` (the reference): nothing is allocated.  Walks and runs
use the reduced configs (2 layers, d_model 128; a hybrid 4 layers) at
batch 2 and 64 positions.  FLOPs are counted by
``torch.utils.flop_counter``'s integer formulas, so every comparison here
is exact.
"""
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs import SHAPE_IDS as JAX_SHAPE_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_runnable as jax_cell_runnable
from repro.configs import get_config as jax_get_config
from repro.launch.specs import count_params as jax_count_params
from repro.utils.flops import estimate_cell as jax_estimate_cell
from repro_torch.configs import ARCH_IDS, SHAPE_IDS, SHAPES, ShapeSpec, cell_runnable, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import init_cache, init_cross_cache, init_params
from repro_torch.training import init_train_state
from repro_torch.utils import roofline
from repro_torch.utils.cost import CostMode
from repro_torch.utils.flops import estimate_cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("train", "prefill", "decode")
SMALL = {kind: ShapeSpec(f"small_{kind}", 64, 2, kind) for kind in KINDS}


def test_shape_grid_is_the_references():
    assert SHAPE_IDS == JAX_SHAPE_IDS
    for name in SHAPE_IDS:
        got, want = SHAPES[name], JAX_SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == (
            want.name, want.seq_len, want.global_batch, want.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_runnable_is_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for name in SHAPE_IDS:
        assert cell_runnable(cfg, SHAPES[name]) == jax_cell_runnable(jcfg, JAX_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_the_references(arch):
    """Total and active (experts at top_k / n_experts) at full size: the
    port's model on meta, the reference's from jax.eval_shape."""
    assert specs.count_params(get_config(arch)) == jax_count_params(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_estimate_cell_equals_the_references(arch):
    for name in SHAPE_IDS:
        got = estimate_cell(get_config(arch), SHAPES[name])
        want = jax_estimate_cell(jax_get_config(arch), JAX_SHAPES[name])
        assert (got.matmul_flops, got.attention_flops, got.ssm_scan_bytes) == (
            want.matmul_flops, want.attention_flops, want.ssm_scan_bytes), name
        assert got.total_flops == want.total_flops


def walked(cfg, shape):
    """The cell's step walked on meta: the mode and the step's output."""
    step, args, _, meta = specs.build_cell(cfg, shape, make_host_mesh())
    with CostMode() as mode:
        out = step(*args)
    return mode, out, meta


def real_args(cfg, shape):
    """The same step's arguments as real CPU tensors from fixed seeds."""
    gen = torch.Generator().manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    toks = torch.randint(0, cfg.vocab, (b, 1 if shape.kind == "decode" else s),
                         generator=gen).to(torch.int32)
    batch = {"tokens": toks}
    if cfg.encoder:
        batch["frames"] = torch.randn((b, cfg.encoder.n_frames, cfg.d_model),
                                      generator=gen).to(torch.bfloat16)
    if shape.kind == "train":
        return init_train_state(cfg, gen, device="cpu"), batch
    params = init_params(cfg, gen, device="cpu")
    if shape.kind == "prefill":
        return params, batch
    cache = init_cache(cfg, b, s, device="cpu")
    if cfg.encoder:
        enc = torch.randn((b, cfg.encoder.n_frames, cfg.d_model), generator=gen)
        with torch.no_grad():
            cache = dict(cache, cross=init_cross_cache(cfg, params, enc.to(params.embed.dtype)))
    return params, toks, cache


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_walk_counts_what_a_cpu_run_does(arch, kind):
    """build_cell's step on meta and the same step on real CPU tensors,
    each under CostMode: the same FLOPs, flash ops and peak bytes.  Bytes
    agree to 1e-3: a CPU kernel may give an output other strides than the
    meta function does, and a later reshape then copies on one device and
    views on the other (falcon-mamba-7b's train step: 0.08 %), and
    ``torch.tensor`` constants are made by other ops on the two devices."""
    cfg = get_config(arch).reduced()
    shape = SMALL[kind]
    mode, out, _ = walked(cfg, shape)
    step = specs.build_cell(cfg, shape, make_host_mesh())[0]
    args = real_args(cfg, shape)
    with CostMode() as real:
        got = step(*args)
    assert mode.flops == real.flops > 0
    assert mode.ops["repro_torch.flash_attention"] == real.ops["repro_torch.flash_attention"]
    assert mode.peak_bytes == real.peak_bytes
    assert abs(mode.bytes - real.bytes) <= 1e-3 * real.bytes
    if kind == "prefill":
        assert out.device.type == "meta" and got.shape == out.shape and got.dtype == out.dtype


def test_prefill_count_equals_a_hand_count():
    """qwen2-vl-2b reduced, prefill (features only) at b 2, s 64: 2 FLOPs a
    token for each matmul weight (wq, wk, wv, wo, wi, wg, wo of each layer;
    no head), and 4·dh a live causal (q, k) pair of each head for the
    flash op."""
    cfg = get_config("qwen2-vl-2b").reduced()
    b, s = 2, 64
    d, h, hk, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    weights = d * h * dh + 2 * d * hk * dh + h * dh * d + 3 * d * f
    pairs = s * (s + 1) // 2
    want = cfg.n_layers * (2 * b * s * weights + 4 * dh * b * h * pairs)
    mode, _, _ = walked(cfg, ShapeSpec("hand", s, b, "prefill"))
    assert mode.flops == want
    assert mode.ops["repro_torch.flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_two_point_extrapolation_equals_a_full_depth_walk(arch, kind):
    """Walks at 2 and 4 bodies extrapolated to 6 equal a walk at 6 bodies:
    FLOPs, bytes, peak bytes and flash ops."""
    cfg = get_config(arch).reduced()
    shape = ShapeSpec(f"depth_{kind}", 32, 2, kind)
    two = dryrun.walk(dryrun.calib_config(cfg, 2), shape)
    four = dryrun.walk(dryrun.calib_config(cfg, 4), shape)
    six = dryrun.walk(dryrun.calib_config(cfg, 6), shape)
    assert dryrun.n_bodies(dryrun.calib_config(cfg, 6)) == 6
    for key in dryrun.COUNTS:
        assert dryrun.extrapolate(two[key], four[key], 6) == six[key], key
    assert dryrun.extrapolate_peak(two["trace"], four["trace"], 6) == six["peak_bytes"]


def test_extrapolate_is_the_references_formula():
    # c = 10, b = 7: B2 = 24, B4 = 38, L = 30 → 220
    assert dryrun.extrapolate(24, 38, 30) == 10 + 30 * 7
    assert dryrun.extrapolate(24, 20, 30) == 24  # no body cost: clamped at 0


def test_roofline_divides_once():
    r = roofline.Roofline(flops=989e12, bytes_accessed=3.35e12, collective_bytes=900e9)
    row = r.row()
    assert (row["t_compute_s"], row["t_memory_s"], row["t_collective_s"]) == (1.0, 1.0, 2.0)
    assert row["dominant"] == "collective" and row["step_time_s"] == 2.0
    assert roofline.roofline_line(row) == (
        "roofline: compute=1.0000s memory=1.0000s collective=2.0000s dominant=collective")


def test_flash_bound_is_the_flash_flops():
    q = torch.empty((2, 12, 4096, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 2, 4096, 128), dtype=torch.bfloat16, device="meta")
    ms, by, flops, nbytes = roofline.flash_bound(q, k, True, None)
    assert flops == roofline.flash_flops(2, 12, 4096, 4096, 128, True, None) == (
        4 * 128 * 2 * 12 * 4096 * 4097 // 2)
    assert by == "operations" and ms == flops / roofline.BF16_TC_FLOPS * 1e3
    assert roofline.attention_pairs(8, 8, True, 3) == 1 + 2 + 3 * 6


@pytest.mark.slow
@pytest.mark.subprocess
def test_dryrun_cli_one_cell(tmp_path):
    """The CLI on qwen2-vl-2b × prefill_32k: 0 failed; the printed roofline
    line is the JSON row's, whose terms divide the per-device counts (the
    global counts over 256 chips) by the peaks once."""
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-vl-2b",
         "--shape", "prefill_32k", "--json", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "== dry-run: 1 ok, 0 skipped (documented), 0 failed ==" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["chips"] == 256
    line = next(x.strip() for x in proc.stdout.splitlines() if "roofline:" in x)
    assert line == roofline.roofline_line(rec)
    nums = [float(x) for x in re.findall(r"=([0-9.]+)s", line)]
    assert nums == [round(rec[k], 4) for k in ("t_compute_s", "t_memory_s", "t_collective_s")]
    assert rec["t_compute_s"] == rec["flops_corrected"] / 256 / roofline.BF16_TC_FLOPS
    assert rec["t_memory_s"] == rec["bytes_corrected"] / 256 / roofline.HBM_BYTES_PER_S
    assert rec["flash_ops"] == get_config("qwen2-vl-2b").n_layers
    assert not any(k.startswith("compile_") or k == "flops_raw_A" for k in rec)
    assert math.isclose(rec["model_flops_util"],
                        rec["model_flops_per_device"] / rec["flops_per_device"])
