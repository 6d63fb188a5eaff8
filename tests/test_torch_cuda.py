"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a GPU (marker ``cuda``): on a machine without one
they skip, decided inside the fixture.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine has none.  Tolerances: the
kernels sum each row in another order than the plain versions (a strided
warp sum against ``segment_reduce``), so results agree to float32 rounding of
the row sums: every entry within 1e-5 × (its |ref| + the mean |ref| of its
rank row).  The mean term covers entries near 0; a bound on max|ref| alone
would let a wrong entry far from a PPR seed pass.  The flash-attention and
LM tests at the end state their own bounds.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.distributed import (
    MeshOperands,
    ShardMesh,
    distributed_pagerank,
    distributed_pagerank_topk,
)
from repro_torch.core.pagerank import PartitionedGraph, l1_norm, pagerank_numpy
from repro_torch.core.solver import solve_variant
from repro_torch.ppr import ppr_numpy, teleport_from_seeds
from repro_torch.ppr.batched import bias_scaled, blocked_rows
from repro_torch.serving import PPREngine, make_query_stream
from repro_torch.graphs import Graph, make_dataset, rmat_graph
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    attention_ref,
    flash_attention,
)
from repro_torch.kernels.flash_attention import build as flash_build
from repro_torch.kernels.flash_attention import launch_counts as flash_counts
from repro_torch.kernels.flash_attention import reset_launch_counts as reset_flash_counts
from repro_torch.launch import serve
from repro_torch.models.model import decode_step, forward, init_cache, init_params
from repro_torch.kernels.spmv import (
    BlockedGraph,
    gs_pass,
    gs_pass_multi,
    gs_pass_multi_ref,
    gs_pass_ref,
    launch_counts,
    reset_launch_counts,
    spmv_csr_acc,
    spmv_csr_acc_ref,
    spmv_csr_rows,
    spmv_csr_rows_ref,
)

sys.path.append(str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import block_masks  # noqa: E402  (the kernel phase's masks)

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graphs():
    rng = np.random.default_rng(5)
    g = rmat_graph(10, avg_degree=8, seed=4)
    weighted = Graph.from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                                 weights=1.0 - rng.random(g.m),
                                 bias=rng.uniform(0.5, 1.5, g.n))
    # one hub with more in-edges than a shared-memory chunk holds
    n = 9000
    src = np.r_[np.arange(1, n), rng.integers(0, n, 3 * n)]
    dst = np.r_[np.zeros(n - 1, np.int64), rng.integers(0, n, 3 * n)]
    key = np.unique(src * n + dst)
    hub = Graph.from_edges(n, key // n, key % n)
    return {"rmat": g, "rmat_weighted": weighted, "hub": hub, "chain": _chain(256)}


def _rel_err(out, ref) -> float:
    """The largest error of an entry over its |ref| plus the mean |ref| of
    its rank row (the last axis of a batched ``(n_blocks, block, b)``
    state indexes rows)."""
    dims = (0, 1) if ref.dim() == 3 else None
    scale = ref.abs() + ref.abs().mean(dim=dims, keepdim=dims is not None)
    return float(((out - ref).abs() / scale).max())


@pytest.mark.parametrize("block", [64, 256, 1000])
@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub"])
def test_spmv_csr_acc_matches_plain(cuda, gname, block):
    g = _graphs()[gname]
    bg = BlockedGraph.build(g, block=block, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    contrib = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask
    out = spmv_csr_acc(contrib, bg.in_ptr, bg.src, bg.weights)
    ref = spmv_csr_acc_ref(contrib, bg.in_ptr, bg.src, bg.weights)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    assert torch.equal(out, spmv_csr_acc(contrib, bg.in_ptr, bg.src, bg.weights))


def _csr_case(case, ctas):
    """(graph, block) that walks one path of spmv_csr_acc's merge split:
    ``star``, a hub row with far more in-edges than one CTA's share of row
    ends and edges, so its sum is carried across many CTAs; ``aligned``,
    rows of 3 in-edges, 64 rows a CTA, so every CTA's share ends on a row
    end; ``sparse``, only every 7th row has in-edges; ``empty``, no edges."""
    rng = np.random.default_rng(11)
    if case == "star":
        n = 20000
        src = np.r_[np.arange(1, n), rng.integers(0, n, 2 * n)]
        dst = np.r_[np.zeros(n - 1, np.int64), rng.integers(1, n, 2 * n)]
        key = np.unique(src * n + dst)
        return Graph.from_edges(n, key // n, key % n), 256
    if case == "aligned":
        n, k = 64 * ctas, 3
        dst = np.repeat(np.arange(n), k)
        return Graph.from_edges(n, (dst + 1 + np.tile(np.arange(k), n)) % n, dst), 64
    if case == "sparse":
        n = 7000
        dst = 7 * rng.integers(0, n // 7, 4 * n)
        key = np.unique(rng.integers(0, n, 4 * n) * n + dst)
        return Graph.from_edges(n, key // n, key % n), 256
    return Graph.from_edges(1000, np.zeros(0, np.int64), np.zeros(0, np.int64)), 64


@pytest.mark.parametrize("case", ["star", "aligned", "sparse", "empty"])
def test_spmv_csr_acc_joins_rows_cut_between_ctas(cuda, case):
    from repro_torch.kernels.spmv import kernel

    ctas = kernel._spmv_ctas(kernel.build.load(), torch.cuda.current_device())
    g, block = _csr_case(case, ctas)
    bg = BlockedGraph.build(g, block=block, device=cuda)
    if case == "aligned":  # one share a CTA, each ending on a row end
        assert (bg.n_blocks * bg.block + g.m) % ctas == 0
    gen = torch.Generator(device=cuda).manual_seed(7)
    contrib = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask
    out = spmv_csr_acc(contrib, bg.in_ptr, bg.src, bg.weights)
    ref = spmv_csr_acc_ref(contrib, bg.in_ptr, bg.src, bg.weights)
    torch.cuda.synchronize()
    if case == "empty":
        assert not torch.any(out != 0)
    else:
        assert _rel_err(out, ref) <= RTOL
    assert torch.equal(out, spmv_csr_acc(contrib, bg.in_ptr, bg.src, bg.weights))


def _chain(block, n_blocks=12):
    """Each row of block k + 1 takes its in-edges from rows of block k only
    (two each), so a Gauss-Seidel pass carries every value down the chain
    one block a step: a block summed from a stale copy of the block just
    committed is off in every entry."""
    n = block * n_blocks
    v = np.arange(block, n)
    src = np.r_[v - block, (v - block + 1) % block + (v // block - 1) * block]
    dst = np.r_[v, v]
    return Graph.from_edges(n, src, dst)


@pytest.mark.parametrize("block", [64, 256])
def test_gs_pass_reads_the_block_just_committed(cuda, block):
    """Every edge of the chain comes from the block just below, which the
    helpers gathered before it committed: each must take the committed
    value from the kernel's window."""
    g = _chain(block)
    bg = BlockedGraph.build(g, block=block, device=cuda)
    pr = torch.zeros_like(bg.vmask)
    params = torch.tensor([1.0, 0.85, 0.0], device=cuda)
    args = (bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, bg.weights)
    out = gs_pass(pr, *args)
    ref = gs_pass_ref(pr, *args)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    # a block that read the block below before its commit would read the
    # previous pass's zeros and commit the base, 1: far outside the bound
    stale = torch.ones_like(ref)
    scale = ref.abs() + ref.abs().mean()
    assert float(((ref - stale).abs() / scale)[1:].min()) > 100 * RTOL


@pytest.mark.parametrize("b", [1, 8, 64])
def test_gs_pass_multi_reads_the_block_just_committed(cuda, b):
    g = _chain(256)
    bg = BlockedGraph.build(g, block=256, device=cuda)
    rng = np.random.default_rng(b)
    tele = torch.as_tensor(0.5 + rng.random((bg.n_blocks, bg.block, b)).astype(np.float32) / 2,
                           device=cuda)
    pr = torch.zeros_like(tele)
    coef = torch.full((b,), 1.0, device=cuda)
    args = (bg.inv_out, bg.vmask, tele, coef, 0.85, bg.in_ptr, bg.src, bg.weights)
    out = gs_pass_multi(pr, *args)
    ref = gs_pass_multi_ref(pr, *args)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    # a block that read the block above before it committed would read the
    # previous pass's zeros and commit tele · coef: far outside the bound
    stale = tele * coef
    scale = ref.abs() + ref.abs().mean(dim=(0, 1), keepdim=True)
    assert float(((ref - stale).abs() / scale)[1:].min()) > 100 * RTOL


@pytest.mark.parametrize("b", [1, 2, 5, 33, 64])
@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub"])
def test_gs_pass_multi_rows_across_ctas(cuda, gname, b):
    """Widths that are not a multiple of the rows a CTA owns, frozen rows
    among them, at block 256.  The hub's part of its block spans many
    rounds, so the other CTAs of its cluster commit their parts of that
    block while it still reads sources in it, which must keep their old
    values."""
    g = _graphs()[gname]
    bg = BlockedGraph.build(g, block=256, device=cuda)
    pr, tele, coef, frozen = _multi_inputs(g, bg, b, cuda, seed=10 + b)
    args = (bg.inv_out, bg.vmask, tele, coef, 0.85, bg.in_ptr, bg.src,
            bg.weights, frozen)
    out = gs_pass_multi(pr, *args)
    ref = gs_pass_multi_ref(pr, *args)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    assert torch.equal(out[..., frozen], pr[..., frozen])
    assert torch.equal(out, gs_pass_multi(pr, *args))


@pytest.mark.parametrize("block", [64, 256, 1000])
@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub"])
def test_gs_pass_matches_plain(cuda, gname, block):
    g = _graphs()[gname]
    bg = BlockedGraph.build(g, block=block, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    pr = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask / g.n
    frozen = (torch.rand(bg.vmask.shape, generator=gen, device=cuda) < 0.1) \
        & (bg.vmask > 0)
    d = 0.85
    params = torch.tensor([(1 - d) / g.n, d, 0.3 * d / g.n], device=cuda)
    out = gs_pass(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                  bg.weights, bg.bias, frozen)
    ref = gs_pass_ref(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                      bg.weights, bg.bias, frozen)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    assert torch.equal(out[frozen], pr[frozen])
    assert not torch.any(torch.where(bg.vmask == 0, out, 0.0) != 0)
    again = gs_pass(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                    bg.weights, bg.bias, frozen)
    assert torch.equal(out, again)


@pytest.mark.parametrize("mask", ["none", "random half", "all but the first",
                                  "all but the last", "runs of 1 and 9", "all"])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub", "chain"])
def test_gs_pass_under_whole_block_freezes(cuda, gname, block, mask):
    """The masks the adaptive schedule gives gs_pass: whole dst blocks
    frozen, in runs longer than the k blocks between a helper's gather
    and its sum.  A frozen block's values and q stay the input's, so the
    window and the helpers' gathers must hand them on unchanged."""
    g = _graphs()[gname]
    bg = BlockedGraph.build(g, block=block, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    pr = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask / g.n
    blocks = block_masks(bg.n_blocks)[mask]
    frozen = torch.as_tensor(blocks, device=cuda)[:, None].expand(
        bg.n_blocks, bg.block).contiguous()
    d = 0.85
    params = torch.tensor([(1 - d) / g.n, d, 0.3 * d / g.n], device=cuda)
    args = (pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, bg.weights,
            bg.bias, frozen)
    out = gs_pass(*args)
    ref = gs_pass_ref(*args)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    assert torch.equal(out[frozen], pr[frozen])
    if blocks.all():
        assert torch.equal(out, pr)
    assert torch.equal(out, gs_pass(*args))


def test_wrappers_count_their_launches(cuda):
    g = _graphs()["rmat"]
    bg = BlockedGraph.build(g, block=256, device=cuda)
    params = torch.tensor([0.15 / g.n, 0.85, 0.0], device=cuda)
    reset_launch_counts()
    spmv_csr_acc(bg.vmask, bg.in_ptr, bg.src)
    gs_pass(bg.vmask, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src)
    gs_pass(bg.vmask, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src)
    st = bg.vmask[..., None].expand(-1, -1, 2).contiguous()
    gs_pass_multi(st, bg.inv_out, bg.vmask, st, torch.ones(2, device=cuda),
                  0.85, bg.in_ptr, bg.src)
    assert launch_counts() == {"spmv_csr_acc": 1, "gs_pass": 2,
                               "gs_pass_multi": 1}


def test_wrappers_count_no_launch_on_empty_input(cuda):
    """An input with no vertices launches nothing, so it adds nothing to
    any count, and each wrapper still returns its (empty) result."""
    block = 256
    empty = torch.zeros(0, block, device=cuda)
    in_ptr = torch.zeros(1, dtype=torch.int32, device=cuda)
    src = torch.zeros(0, dtype=torch.int32, device=cuda)
    params = torch.tensor([0.15, 0.85, 0.0], device=cuda)
    st = torch.zeros(0, block, 2, device=cuda)
    reset_launch_counts()
    outs = (spmv_csr_acc(empty, in_ptr, src),
            gs_pass(empty, empty, empty, params, in_ptr, src),
            gs_pass_multi(st, empty, empty, st, torch.ones(2, device=cuda),
                          0.85, in_ptr, src))
    torch.cuda.synchronize()
    assert [tuple(o.shape) for o in outs] == [(0, block), (0, block), (0, block, 2)]
    assert launch_counts() == {"spmv_csr_acc": 0, "gs_pass": 0,
                               "gs_pass_multi": 0}


@pytest.mark.parametrize("vname", ["blocked", "blocked_nosync", "blocked_nosync_opt",
                                   "blocked_adaptive"])
@pytest.mark.parametrize("handle_dangling", [False, True])
def test_blocked_variants_on_card_match_oracle(cuda, vname, handle_dangling):
    g = rmat_graph(10, avg_degree=8, seed=4)
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    reset_launch_counts()
    r = solve_variant(vname, g, threshold=1e-8, handle_dangling=handle_dangling,
                      block=64, device=cuda)
    kernel = "spmv_csr_acc" if vname == "blocked" else "gs_pass"
    assert launch_counts()[kernel] == r.iterations > 0
    assert r.pr.device.type == "cuda"
    assert l1_norm(r.pr, ref) < (1e-3 if vname.endswith("_opt") else 1e-5)


@pytest.mark.parametrize("handle_dangling", [False, True])
def test_blocked_adaptive_on_card_matches_oracle_and_repeats(cuda, handle_dangling):
    from repro_torch.graphs import compute_order, permute_graph

    g = make_dataset("webStanford", scale_down=64)
    g = permute_graph(g, compute_order(g, "bfs"))
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    reset_launch_counts()
    a, b = (solve_variant("blocked_adaptive", g, threshold=1e-9,
                          handle_dangling=handle_dangling, block=64, device=cuda)
            for _ in range(2))
    assert launch_counts()["gs_pass"] == 2 * a.iterations > 0
    n_blocks = -(-g.n // 64)
    assert n_blocks <= a.sweeps < a.iterations * n_blocks  # some blocks skipped
    assert l1_norm(a.pr, ref) < 1e-5
    assert (a.iterations, a.sweeps) == (b.iterations, b.sweeps)
    assert torch.equal(a.pr, b.pr) and torch.equal(a.residuals, b.residuals)


@pytest.mark.parametrize("vname", ["barrier", "nosync", "blocked", "blocked_nosync",
                                   "blocked_adaptive"])
def test_same_input_solves_repeat_exactly(cuda, vname):
    # hub rows with thousands of in-edges: an atomic sum would reorder them
    g = make_dataset("webStanford", scale_down=4)
    a, b = (solve_variant(vname, g, threshold=1e-8, handle_dangling=True,
                          device=cuda) for _ in range(2))
    assert a.iterations == b.iterations > 0
    assert a.sweeps == b.sweeps
    assert torch.equal(a.pr, b.pr)
    assert torch.equal(a.residuals, b.residuals)


def _multi_inputs(g, bg, b, cuda, seed):
    rng = np.random.default_rng(seed)
    seeds = [tuple(rng.choice(g.n, size=1 + i % 3, replace=False)) for i in range(b)]
    t = bias_scaled(teleport_from_seeds(seeds, g.n), g.bias).astype(np.float32)
    tele = torch.as_tensor(blocked_rows(t, bg.n_blocks, bg.block), device=cuda)
    pr = torch.as_tensor(rng.random(tele.shape).astype(np.float32),
                         device=cuda) * bg.vmask[..., None] / g.n
    coef = torch.as_tensor((0.15 + 0.085 * rng.random(b)).astype(np.float32),
                           device=cuda)
    frozen = torch.as_tensor(np.arange(b) % 3 == 1, device=cuda)
    return pr, tele, coef, frozen


@pytest.mark.parametrize("b", [2, 8, 64])
def test_gs_pass_multi_plain_sums_a_wide_hub_as_float64(cuda, b):
    """A vertex of 40,000 in-edges: the plain version within RTOL / 10 of
    the same pass in float64, and the kernel within RTOL (RTOL / 10 above
    32 rows).  The plain version sums each row's segments as 1-D data: on
    a 2-D (edges, b) tensor CUDA's segment_reduce adds a segment's terms
    one by one in float, whose error grows with the segment's length.
    Above 32 rows the kernel sums a row in edge order, each round's run in
    double (scripts/ppr_sum_accuracy.py measures both on webStanford)."""
    n = 40_001
    star = Graph.from_edges(n, np.arange(1, n), np.zeros(n - 1, np.int64))
    bg = BlockedGraph.build(star, block=256, device=cuda)
    pr, tele, coef, frozen = _multi_inputs(star, bg, b, cuda, seed=b)
    args = (bg.inv_out, bg.vmask, tele, coef, 0.85, bg.in_ptr, bg.src,
            bg.weights, frozen)
    exact = gs_pass_multi_ref(pr.double(), *(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args))
    plain = gs_pass_multi_ref(pr, *args)
    out = gs_pass_multi(pr, *args)
    torch.cuda.synchronize()
    assert _rel_err(plain.double(), exact) <= RTOL / 10
    assert _rel_err(out.double(), exact) <= (RTOL / 10 if b > 32 else RTOL)


@pytest.mark.parametrize("b", [1, 2, 3, 8, 40])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub"])
def test_gs_pass_multi_matches_plain(cuda, gname, block, b):
    g = _graphs()[gname]
    bg = BlockedGraph.build(g, block=block, device=cuda)
    pr, tele, coef, frozen = _multi_inputs(g, bg, b, cuda, seed=b)
    args = (bg.inv_out, bg.vmask, tele, coef, 0.85, bg.in_ptr, bg.src,
            bg.weights, frozen)
    out = gs_pass_multi(pr, *args)
    ref = gs_pass_multi_ref(pr, *args)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= RTOL
    assert torch.equal(out[..., frozen], pr[..., frozen])
    assert not torch.any(torch.where(bg.vmask[..., None] == 0, out, 0.0) != 0)
    assert torch.equal(out, gs_pass_multi(pr, *args))


@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub", "chain"])
def test_gs_pass_multi_b1_is_gs_pass_on_card(cuda, gname):
    g = _graphs()[gname]
    bg = BlockedGraph.build(g, block=256, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    pr = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask / g.n
    base = float(np.float32(0.15 / g.n))
    params = torch.tensor([base, 0.85, 0.0], device=cuda)
    one = gs_pass(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, bg.weights)
    multi = gs_pass_multi(pr[..., None].contiguous(), bg.inv_out, bg.vmask,
                          bg.vmask[..., None].contiguous(),
                          torch.tensor([base], device=cuda), 0.85, bg.in_ptr,
                          bg.src, bg.weights)
    torch.cuda.synchronize()
    assert torch.equal(multi[..., 0], one)  # the same sums in the same order


def test_gs_pass_multi_rejects_what_does_not_fit(cuda):
    """block 8192 at b = 64 needs more shared memory than a CTA may opt
    into on the H100 (227 KB: a CTA stages two slices of each block); block
    256 at b = 64 fits and launches."""
    g = _graphs()["rmat"]
    for block, fits in ((8192, False), (256, True)):
        bg = BlockedGraph.build(g, block=block, device=cuda)
        st = torch.zeros(bg.n_blocks, bg.block, 64, device=cuda)
        args = (st, bg.inv_out, bg.vmask, st, torch.zeros(64, device=cuda),
                0.85, bg.in_ptr, bg.src)
        if fits:
            assert torch.equal(gs_pass_multi(*args), st)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                gs_pass_multi(*args)


@pytest.mark.parametrize("weighted", [False, True])
def test_gs_pass_rejects_what_does_not_fit(cuda, weighted):
    """At the largest block whose ring fits into a CTA's shared memory
    (found through gs_pass_plan) gs_pass launches and matches its plain
    version; one row more raises ValueError before any launch."""
    from repro_torch.kernels.spmv.kernel import MAX_BLOCK, gs_pass_plan

    def fits(block):
        try:
            gs_pass_plan(block, weighted, cuda)
        except ValueError:
            return False
        return True

    lo, hi = 1, MAX_BLOCK  # fits(lo); the largest block that fits is in [lo, hi]
    assert fits(lo) and not fits(hi)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    g = _graphs()["rmat_weighted" if weighted else "rmat"]
    for block, ok in ((lo, True), (lo + 1, False)):
        bg = BlockedGraph.build(g, block=block, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(block)
        pr = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask / g.n
        params = torch.tensor([0.15 / g.n, 0.85, 0.0], device=cuda)
        args = (pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, bg.weights, bg.bias)
        reset_launch_counts()
        if ok:
            out = gs_pass(*args)
            torch.cuda.synchronize()
            assert _rel_err(out, gs_pass_ref(*args)) <= RTOL
            assert launch_counts()["gs_pass"] == 1
        else:
            with pytest.raises(ValueError, match="shared memory"):
                gs_pass(*args)
            assert launch_counts()["gs_pass"] == 0


@pytest.mark.parametrize("handle_dangling", [False, True])
def test_ppr_blocked_on_card_matches_oracle_and_repeats(cuda, handle_dangling):
    g = rmat_graph(10, avg_degree=8, seed=4)
    seeds = [(3,), (10, 11, 12), (), (7, 3)]
    oracle, _ = ppr_numpy(g, teleport_from_seeds(seeds, g.n), threshold=1e-12,
                          handle_dangling=handle_dangling)
    reset_launch_counts()
    a, b = (solve_variant("ppr_blocked", g, threshold=1e-9, seeds=seeds,
                          handle_dangling=handle_dangling, block=64, device=cuda)
            for _ in range(2))
    assert launch_counts()["gs_pass_multi"] == 2 * a.iterations > 0
    assert a.pr.device.type == "cuda"
    for i in range(len(seeds)):
        assert np.abs(a.pr[i].double().cpu().numpy() - oracle[i]).sum() < 1e-5
    assert a.iterations == b.iterations and torch.equal(a.pr, b.pr)


@pytest.mark.parametrize("block", [64, 256])
def test_ppr_blocked_on_card_takes_more_rows_than_one_launch(cuda, block):
    """65 rows: more than one launch takes (MAX_BATCH, or fewer where the
    rows do not fit in shared memory), so every pass launches the kernel
    once per chunk of rows, and every row reaches the float64 oracle."""
    from repro_torch.kernels.spmv.kernel import MAX_BATCH, gs_pass_multi_max_batch

    g = rmat_graph(10, avg_degree=8, seed=4)
    rng = np.random.default_rng(65)
    seeds = [tuple(int(s) for s in rng.choice(g.n, rng.integers(1, 4), replace=False))
             for _ in range(MAX_BATCH + 1)]
    per_launch = gs_pass_multi_max_batch(block, cuda)
    launches_per_pass = -(-len(seeds) // per_launch)
    assert 1 <= per_launch <= MAX_BATCH and launches_per_pass >= 2
    oracle, _ = ppr_numpy(g, teleport_from_seeds(seeds, g.n), threshold=1e-12,
                          handle_dangling=True)
    reset_launch_counts()
    r = solve_variant("ppr_blocked", g, threshold=1e-9, seeds=seeds,
                      handle_dangling=True, block=block, device=cuda)
    assert launch_counts()["gs_pass_multi"] == launches_per_pass * r.iterations > 0
    l1 = np.abs(r.pr.double().cpu().numpy() - oracle).sum(axis=1)
    assert l1.shape == (len(seeds),) and l1.max() < 1e-5


def test_engine_kernel_backend_on_card_matches_torch_backend(cuda):
    g = make_dataset("webStanford", scale_down=64)
    qs = make_query_stream(g.n, 16, seed=0)
    reset_launch_counts()
    kern = PPREngine(g, slots=8, threshold=1e-7, backend="cuda",
                     handle_dangling=True, device=cuda).drain(qs)
    assert launch_counts()["gs_pass_multi"] > 0
    plain = PPREngine(g, slots=8, threshold=1e-7, backend="torch",
                      handle_dangling=True, device=cuda).drain(qs)
    by_qid = {r.qid: r for r in plain}
    assert sorted(by_qid) == sorted(r.qid for r in kern) == list(range(16))
    for r in kern:
        ref = ppr_numpy(g, teleport_from_seeds([r.seeds], g.n), threshold=1e-12,
                        handle_dangling=True)[0][0]
        kth = np.sort(ref)[::-1][r.indices.size - 1]
        assert (ref[r.indices] >= kth - 1e-6).all()
        assert np.abs(r.values - ref[r.indices]).max() < 1e-5
        assert np.abs(r.values - by_qid[r.qid].values).max() < 1e-5


# ---------------------------------------------------------------------------
# the distributed solvers and the sharded engine: several shards on one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 3, 4])
@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub"])
def test_spmv_csr_rows_matches_plain_on_partitions(cuda, gname, p):
    """Every partition of a real graph (the last one padded where p does
    not divide n), gathered from the whole vector: one launch each."""
    g = _graphs()[gname]
    pg = PartitionedGraph.from_graph(g, p=p, device=cuda)
    ops = MeshOperands.build(pg, ShardMesh((cuda,) * p))
    gen = torch.Generator(device=cuda).manual_seed(p)
    contrib = torch.rand(pg.n_pad, generator=gen, device=cuda)
    reset_launch_counts()
    for s in ops.shards:
        out = spmv_csr_rows(contrib, s.in_ptr, s.src, s.weights)
        ref = spmv_csr_rows_ref(contrib, s.in_ptr, s.src, s.weights)
        torch.cuda.synchronize()
        assert out.shape == (pg.vp,)
        assert _rel_err(out, ref) <= RTOL
    assert launch_counts()["spmv_csr_acc"] == p


@pytest.mark.parametrize("handle_dangling", [False, True])
def test_distributed_solvers_on_card_match_oracle(cuda, handle_dangling):
    g = rmat_graph(10, avg_degree=8, seed=4)
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    pg = PartitionedGraph.from_graph(g, p=4, device=cuda)
    mesh = ShardMesh((cuda,) * 4)
    for mode in ("barrier", "stale", "topk"):
        reset_launch_counts()
        kw = dict(threshold=1e-8, handle_dangling=handle_dangling)
        r = (distributed_pagerank_topk(pg, mesh, **kw) if mode == "topk"
             else distributed_pagerank(pg, mesh, mode=mode, **kw))
        assert launch_counts()["spmv_csr_acc"] == r.sweeps > 0, mode
        assert r.pr.device.type == "cuda"
        assert l1_norm(r.pr, ref) < 1e-5, mode


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_engine_on_card_matches_oracle(cuda, shards):
    g = make_dataset("webStanford", scale_down=64)
    qs = make_query_stream(g.n, 16, seed=0)
    reset_launch_counts()
    out = PPREngine(g, slots=8, threshold=1e-7, backend="cuda", handle_dangling=True,
                    mesh=ShardMesh((cuda,) * shards)).drain(qs)
    assert launch_counts()["gs_pass_multi"] > 0
    assert sorted(r.qid for r in out) == list(range(16))
    for r in out:
        ref = ppr_numpy(g, teleport_from_seeds([r.seeds], g.n), threshold=1e-12,
                        handle_dangling=True)[0][0]
        kth = np.sort(ref)[::-1][r.indices.size - 1]
        assert (ref[r.indices] >= kth - 1e-6).all()
        assert np.abs(r.values - ref[r.indices]).max() < 1e-5


# ---------------------------------------------------------------------------
# flash attention and the dense LM path (qwen2-vl-2b reduced)
# ---------------------------------------------------------------------------
#
# Bounds, entry-wise, with row = the dh values of one (b, head, query):
# float32: |out − ref| ≤ 1e-5·(|ref| + mean|ref| of its row), the kernel
# summing in another order than the plain version; bfloat16: held against
# the plain version's float32 result on the same bf16 inputs cast up,
# |out − ref32| ≤ 2⁻⁸·|ref32| + 1e-5·(|ref32| + mean|ref32|) — one
# rounding to bf16 (half an ulp, 2⁻⁸ relative) plus the float32 term.

def _flash_worst(out, q, k, v, causal, window, rows=None):
    """The largest entry error of ``out`` over its bound (≤ 1 passes), over
    the query ``rows`` (a boolean mask) or all."""
    ref = attention_ref(q.float(), k.float(), v.float(), scale=q.shape[-1] ** -0.5,
                        causal=causal, window=window)
    if rows is not None:
        out, ref = out[:, :, rows], ref[:, :, rows]
    mag = ref.abs()
    bound = 1e-5 * (mag + mag.mean(dim=-1, keepdim=True))
    if q.dtype == torch.bfloat16:
        bound = bound + 2.0**-8 * mag
    return float(((out.float() - ref).abs() / bound).max())


def _qkv(cuda, dtype, b, hq, hkv, sq, sk, dh, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None)])
def test_flash_attention_matches_plain(cuda, dtype, hq, hkv, causal, window):
    q, k, v = _qkv(cuda, dtype, 2, hq, hkv, 256, 256, 64, seed=hq + hkv)
    reset_flash_counts()
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _flash_worst(out, q, k, v, causal, window) <= 1.0
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (200, 200, True, None), (200, 200, True, 64), (200, 200, False, None),
    (96, 160, True, None), (160, 96, True, None), (96, 160, False, 48),
    (1, 37, False, None), (1, 1, True, None), (65, 300, True, 7),
])
def test_flash_attention_ragged_matches_plain(cuda, dtype, sq, sk, causal, window):
    q, k, v = _qkv(cuda, dtype, 2, 4, 2, sq, sk, 32, seed=sq * sk)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _flash_worst(out, q, k, v, causal, window) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_flash_attention_head_dims(cuda, dtype, dh):
    q, k, v = _qkv(cuda, dtype, 1, 12, 2, 192, 192, dh, seed=dh)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _flash_worst(out, q, k, v, True, None) <= 1.0


def _live_rows(sq, sk, causal, window, device):
    """Query rows that see at least one key (qpos − kpos < window, and
    kpos ≤ qpos when causal; positions from 0)."""
    qpos = torch.arange(sq, device=device)
    last = torch.clamp(qpos, max=sk - 1) if causal else torch.full_like(qpos, sk - 1)
    first = torch.clamp(qpos - window + 1, min=0) if window else torch.zeros_like(qpos)
    return first <= last


# the bf16 tensor-core kernel: head dims, GQA groups, a q tail that is not
# a multiple of its 64-row tile, k shorter than its 64-key tile, one query;
# rows without a live key (a window with sq > sk) are 0, as in the TPU
# kernel (the plain version gives the mean of v there), and the other rows
# are held against the plain version
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2), (12, 2)])
@pytest.mark.parametrize("sq,sk", [(130, 200), (60, 40), (1, 37)])
def test_bf16_tensor_core_kernel_matches_plain(cuda, dh, hq, hkv, sq, sk):
    q, k, v = _qkv(cuda, torch.bfloat16, 2, hq, hkv, sq, sk, dh, seed=dh + hq + sq)
    for causal, window in ((True, None), (True, 16), (False, None), (False, 24)):
        reset_flash_counts()
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_counts()["flash_attention"] == 1
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        live = _live_rows(sq, sk, causal, window, cuda)
        assert torch.equal(out[:, :, ~live], torch.zeros_like(out[:, :, ~live]))
        assert _flash_worst(out, q, k, v, causal, window, rows=live) <= 1.0
        assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))


def test_bf16_kernel_reports_its_p_terms(cuda):
    """The built library sums P as the 3 bf16 terms that the CPU emulation
    in tests/test_torch_flash_attention.py holds to the bound (bf16 q, k
    and v are one exact term each: Q·Kᵀ one product, P·V three); the
    float32 kernel splits q, k, v and P into 3 bf16 terms each and keeps 6
    term products of Q·Kᵀ and 6 of P·V, the emulation's KERNEL_F32_TERMS,
    KERNEL_QK_PRODUCTS and KERNEL_PV_PRODUCTS."""
    fields = ("p_terms", "terms", "qk_products", "pv_products")
    for dh in HEAD_DIMS:
        for bf16, want in ((True, (3, 1, 1, 3)), (False, (3, 3, 6, 6))):
            info = flash_build.kernel_info(dh, bf16)
            assert tuple(info[f] for f in fields) == want


# the float32 tensor-core kernel: a CTA is two warpgroups of 64 query rows,
# so a q tail shorter than 128 rows, a second warpgroup with no row below
# sq, and windows that its rows see in other tiles than the first's
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (12, 2)])
@pytest.mark.parametrize("sq,sk", [(130, 200), (60, 40), (1, 37), (200, 330)])
def test_f32_tensor_core_kernel_matches_plain(cuda, dh, hq, hkv, sq, sk):
    q, k, v = _qkv(cuda, torch.float32, 2, hq, hkv, sq, sk, dh, seed=dh + hq + sq)
    for causal, window in ((True, None), (True, 16), (False, None), (False, 24), (True, 100)):
        reset_flash_counts()
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_counts()["flash_attention"] == 1
        assert out.dtype == torch.float32 and out.shape == q.shape
        live = _live_rows(sq, sk, causal, window, cuda)
        assert torch.equal(out[:, :, ~live], torch.zeros_like(out[:, :, ~live]))
        assert _flash_worst(out, q, k, v, causal, window, rows=live) <= 1.0
        assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))


def test_f32_kernel_takes_operands_at_any_offset(cuda):
    """The float32 kernel reads q, k and v with plain loads (its tensor maps
    read the bf16 planes in its own scratch): a q 4 bytes past a 16-byte
    boundary gives the same result."""
    q, k, v = _qkv(cuda, torch.float32, 1, 4, 2, 100, 100, 64, seed=3)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    assert torch.equal(flash_attention(shifted, k, v), flash_attention(q, k, v))


def test_bf16_kernel_needs_16_byte_aligned_operands(cuda):
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 2, 2, 16, 16, 32, seed=0)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    reset_flash_counts()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, k, v)
    assert flash_counts()["flash_attention"] == 0


def test_flash_attention_rejects_other_head_dims(cuda):
    q, k, v = _qkv(cuda, torch.float32, 1, 2, 2, 16, 16, 96, seed=0)
    reset_flash_counts()
    with pytest.raises(ValueError, match=r"supported: \(32, 64, 80, 128\)"):
        flash_attention(q, k, v)
    assert flash_counts()["flash_attention"] == 0


# head dim 80 (stablelm-3b): the bf16 kernel's tiles are 128 columns wide,
# columns 80-127 zero-filled by the TMA; GQA and MHA, causal, windowed and
# full, ragged lengths, q tails shorter than a tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (256, 256, True, None), (256, 256, True, 64), (256, 256, False, None),
    (200, 200, True, 48), (96, 160, False, None), (160, 96, True, None), (1, 37, False, None),
])
def test_flash_attention_dh80_matches_plain(cuda, dtype, hq, hkv, sq, sk, causal, window):
    q, k, v = _qkv(cuda, dtype, 2, hq, hkv, sq, sk, 80, seed=sq + sk + hq)
    reset_flash_counts()
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _flash_worst(out, q, k, v, causal, window) <= 1.0
    assert torch.equal(out, flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("bf16", [True, False])
def test_flash_attention_info_dh80(cuda, bf16):
    """No spill at dh 80, and the shared memory the analysis mirror
    computes (both kernels' bf16 tiles 128 columns wide, as at dh 128)."""
    from repro_torch.analysis.kernels import flash_smem_bytes

    info = flash_build.kernel_info(80, bf16)
    assert info["spill_bytes"] == 0 and info["ctas_per_sm"] >= 1
    assert info["smem_bytes"] == flash_smem_bytes(80, bf16)
    assert info["smem_bytes"] == flash_build.kernel_info(128, bf16)["smem_bytes"]


def test_flash_attention_row_without_live_key_is_zero(cuda):
    """As the TPU kernel: l stays 0 and acc / max(l, 1e-30) is 0 (the plain
    versions give the mean of v there)."""
    q, k, v = _qkv(cuda, torch.float32, 1, 2, 2, 10, 4, 32, seed=1)
    out = flash_attention(q, k, v, causal=False, window=6)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :, 9], torch.zeros_like(out[:, :, 9]))
    assert _flash_worst(out[:, :, :9].contiguous(), q[:, :, :9].contiguous(), k, v,
                        False, 6) <= 1.0


def _lm(cuda, dtype="float32"):
    cfg = dataclasses.replace(get_config("qwen2-vl-2b").reduced(), dtype=dtype)
    return cfg, init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)


@pytest.mark.parametrize("s", [64, 200])
def test_forward_on_card_runs_the_kernel_once_per_layer(cuda, s):
    cfg, params = _lm(cuda)
    toks = torch.randint(0, cfg.vocab, (2, s), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(s))
    reset_flash_counts()
    out = forward(cfg, params, toks)
    assert flash_counts()["flash_attention"] == cfg.n_layers
    ref = forward(cfg, params, toks, use_flash_kernel=False)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == cfg.n_layers
    mag = ref.abs()
    # float32 logits: 1e-4 × (|ref| + mean|ref| of the token's row)
    assert float(((out - ref).abs() / (mag + mag.mean(-1, keepdim=True))).max()) <= 1e-4


@pytest.mark.parametrize("arch", ["starcoder2-3b", "phi3-medium-14b", "gemma2-2b",
                                  "stablelm-3b"])
def test_dense_arch_forward_on_card_matches_plain(cuda, arch):
    """Each dense arch reduced, float32: the kernel route launches the
    kernel once per layer (gemma2's softcapped attention never: the plain
    route, as in the reference) and gives the plain route's logits, at
    s 96, where the reduced window of 64 bites."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 96), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    reset_flash_counts()
    out = forward(cfg, params, toks)
    assert flash_counts()["flash_attention"] == (0 if arch == "gemma2-2b" else cfg.n_layers)
    ref = forward(cfg, params, toks, use_flash_kernel=False)
    torch.cuda.synchronize()
    mag = ref.abs()
    assert float(((out - ref).abs() / (mag + mag.mean(-1, keepdim=True))).max()) <= 1e-4


def test_starcoder2_full_width_window_on_card(cuda):
    """starcoder2-3b at its published width, cut to 2 layers, float32, at
    s 8192: a quarter of the causal (q, k) pairs lie outside its window of
    4096, and the kernel route gives the plain route's logits within
    1e-4·(|ref| + mean|ref| of the token's row)."""
    cfg = dataclasses.replace(get_config("starcoder2-3b"), n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (1, 8192), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(4))
    reset_flash_counts()
    out = forward(cfg, params, toks)
    assert flash_counts()["flash_attention"] == 2
    ref = forward(cfg, params, toks, use_flash_kernel=False)
    torch.cuda.synchronize()
    mag = ref.abs()
    mag += mag.mean(-1, keepdim=True)
    assert float(out.sub_(ref).abs_().div_(mag).max()) <= 1e-4


def test_decode_matches_forward_on_card(cuda):
    cfg, params = _lm(cuda)
    toks = torch.randint(0, cfg.vocab, (2, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    full = forward(cfg, params, toks)
    cache = init_cache(cfg, 2, 16, device=cuda)
    reset_flash_counts()
    outs = []
    for t in range(16):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    assert flash_counts()["flash_attention"] == 0  # decode runs no kernel
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


def test_serve_on_card_finishes_every_request(cuda):
    reset_flash_counts()
    rep = serve.run(["--requests", "3", "--max-new", "4"])
    assert rep["finished"] == 3 and rep["tokens"] == 12
    assert flash_counts()["flash_attention"] == 0


def _logits_worst(out, ref) -> float:
    """Worst entry of |out − ref| over |ref| + the mean |ref| of its row."""
    mag = ref.abs()
    return float(((out - ref).abs() / (mag + mag.mean(-1, keepdim=True))).max())


@pytest.mark.parametrize("moe_dispatch", ["sparse", "dense"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_arch_forward_on_card_matches_plain(cuda, arch, moe_dispatch):
    """Each MoE arch reduced, float32, s 96 (mixtral's window of 64 bites;
    the sparse dispatch's 120 slots an expert for 96 pairs on average):
    mixtral's kernel route launches the kernel once per layer, deepseek's
    MLA never (the plain route, as in the reference), and the logits are
    the plain route's within 1e-4 × (|ref| + mean|ref| of the token's
    row)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 96), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(5))
    reset_flash_counts()
    out = forward(cfg, params, toks, moe_dispatch=moe_dispatch)
    assert flash_counts()["flash_attention"] == (cfg.n_layers if arch == "mixtral-8x22b" else 0)
    ref = forward(cfg, params, toks, moe_dispatch=moe_dispatch, use_flash_kernel=False)
    torch.cuda.synchronize()
    assert _logits_worst(out, ref) <= 1e-4


def test_mixtral_full_width_flash_route_on_card(cuda):
    """mixtral-8x22b at its published width, cut to 2 layers, float32,
    dense dispatch, at s 8192 (a quarter of the causal pairs outside its
    window of 4096): the kernel route launches the kernel twice and gives
    the plain route's logits within 1e-4 × (|ref| + mean|ref| of the
    token's row) on every token that both routes send to the same experts.
    The two routes round attention differently, so a token at a tie of its
    router may go elsewhere: as in chip_smoke.py's moe phase
    (``routing_flips``), each token that first goes elsewhere in a layer
    must lie within ``FLIP_MARGIN`` (1e-5) of a tie there, and its rows are
    left out (at this seed a token of layer 1 at a tie goes elsewhere under
    the float32 tensor-core kernel)."""
    from chip_smoke import recorded_routing, routing_flips

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (1, 8192), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(6))
    reset_flash_counts()
    with recorded_routing() as routing:
        out = forward(cfg, params, toks, moe_dispatch="dense")
    assert flash_counts()["flash_attention"] == 2
    with recorded_routing() as routing_plain:
        ref = forward(cfg, params, toks, moe_dispatch="dense", use_flash_kernel=False)
    torch.cuda.synchronize()
    flipped, _ = routing_flips("mixtral-8x22b f32 kernel vs plain route", routing_plain, routing)
    out, ref = out[:, ~flipped], ref[:, ~flipped]
    mag = ref.abs()
    mag += mag.mean(-1, keepdim=True)
    assert float(out.sub_(ref).abs_().div_(mag).max()) <= 1e-4


@pytest.mark.parametrize("dispatch", ["moe_apply", "moe_apply_sparse"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_bf16_on_card_tracks_its_cpu_float32_result(cuda, arch, dispatch):
    """A reduced MoE layer in bf16 on the card (float32 router) against the
    same weights and input in float32 on the CPU, 256 tokens (the sparse
    dispatch drops pairs past 160 slots an expert): within 4 bf16 ulps
    (4·2⁻⁷) of max|ref|, and the router stays float32."""
    from repro_torch.models import mlp

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    card = mlp.moe_init(cfg, torch.bfloat16, generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    assert card.router.dtype == torch.float32 and card.wi.dtype == torch.bfloat16
    host = mlp.MoE(dataclasses.replace(cfg, dtype="float32"), dtype=torch.float32, device="cpu")
    host.load_state_dict({k: v.cpu().float() for k, v in card.state_dict().items()})
    x = torch.randn((2, 128, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda).to(torch.bfloat16)
    out = getattr(mlp, dispatch)(card, cfg, x)
    ref = getattr(mlp, dispatch)(host, cfg, x.cpu().float())
    assert out.dtype == torch.bfloat16
    assert float((out.cpu().float() - ref).abs().max()) <= 4 * 2.0**-7 * float(ref.abs().max())


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v2-236b"])
def test_moe_decode_at_b1_on_card_matches_dense_prefill(cuda, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (1, 24), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(7))
    full = forward(cfg, params, toks, moe_dispatch="dense")
    cache = init_cache(cfg, 1, 24, device=cuda)
    reset_flash_counts()
    outs = []
    for t in range(24):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    assert flash_counts()["flash_attention"] == 0  # decode runs no kernel
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_arch_on_card_matches_cpu(cuda, arch):
    """Each SSM arch reduced, float32, s 96 (zamba2-2.7b's Mamba-2 scan: a
    full SSD chunk and a padded one): the card's forward launches the
    flash kernel once per application of zamba2's shared block (2) and
    never in falcon-mamba-7b, and gives the CPU's logits on the same
    weights within 1e-4 × (|ref| + mean|ref| of the token's row); then 8
    decode steps at b 2 on each device, the logits held the same way and
    the last step's float32 states ``h`` within 1e-4 × max|ref|."""
    from repro_torch.models.model import DecoderLM

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    host = DecoderLM(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (2, 96), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(8))
    reset_flash_counts()
    out = forward(cfg, params, toks)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == (2 if arch == "zamba2-2.7b" else 0)
    assert _logits_worst(out.cpu(), forward(cfg, host, toks.cpu())) <= 1e-4
    cache, hcache = init_cache(cfg, 2, 8, device=cuda), init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        ref, hcache = decode_step(cfg, host, toks[:, t:t + 1].cpu(), hcache)
        assert _logits_worst(logits.cpu(), ref) <= 1e-4
    key = "layers" if arch == "falcon-mamba-7b" else "ssm"
    for lc, hc in zip(cache[key], hcache[key], strict=True):
        h, ref = lc["h"].cpu(), hc["h"]
        assert float((h - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_zamba2_shared_block_kernel_route_on_card(cuda):
    """zamba2-2.7b's shared block at its published width (d_model 2560, 32
    heads of 80, full causal, SwiGLU d_ff 10240), float32, b 1, s 2048:
    the kernel route launches flash_attention once and its output is the
    plain route's within 1e-4 × (|ref| + mean|ref| of the token's row)."""
    from repro_torch.models.blocks import decoder_block_apply, decoder_block_init

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(9)
    blk = decoder_block_init(cfg, torch.float32, generator=gen, device=cuda)
    x = torch.randn((1, 2048, cfg.d_model), generator=gen, device=cuda)
    pos = torch.arange(2048, device=cuda, dtype=torch.int32)[None]
    reset_flash_counts()
    out = decoder_block_apply(blk, cfg, x, pos)
    assert flash_counts()["flash_attention"] == 1
    ref = decoder_block_apply(blk, cfg, x, pos, use_kernel=False)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 1
    assert _logits_worst(out, ref) <= 1e-4


def _contracting_graph():
    """A webStanford surrogate whose plan contracts chains: its core is
    weighted and biased, with the full graph's out-degrees."""
    from repro_torch.graphs import DecompositionPlan

    g = make_dataset("webStanford", scale_down=64)
    plan = DecompositionPlan.from_graph(g)
    assert plan.contracted_m > 0
    assert plan.core.weights is not None and plan.core.bias is not None
    return g, plan


@pytest.mark.parametrize("inner", ["blocked", "blocked_nosync", "blocked_adaptive"])
@pytest.mark.parametrize("handle_dangling", [False, True])
def test_planned_blocked_on_card_matches_oracle(cuda, inner, handle_dangling):
    from repro_torch.core.solver import plan_build, plan_run

    g, _ = _contracting_graph()
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    bundle = plan_build(inner)(g, block=64, device=cuda)
    assert bundle.bundle.n == bundle.plan.core.n < g.n
    reset_launch_counts()
    r = plan_run(bundle, threshold=1e-9, handle_dangling=handle_dangling)
    kernel = "spmv_csr_acc" if inner == "blocked" else "gs_pass"
    assert launch_counts()[kernel] == r.iterations > 0
    assert r.pr.shape == (g.n,) and r.pr.dtype == np.float64
    assert l1_norm(r.pr, ref) < 1e-5


def test_gs_pass_on_plan_core_operands(cuda):
    """One pass on a plan core's operands (contracted d^k weights, folded
    biases, full out-degrees), under a per-lane and a whole-block freeze."""
    _, plan = _contracting_graph()
    core = plan.core
    bg = BlockedGraph.build(core, block=64, device=cuda)
    assert bg.weights is not None and bg.bias is not None
    gen = torch.Generator(device=cuda).manual_seed(3)
    pr = torch.rand(bg.vmask.shape, generator=gen, device=cuda) * bg.vmask / core.n
    d = 0.85
    params = torch.tensor([(1 - d) / core.n, d, 0.0], device=cuda)
    lanes = (torch.rand(bg.vmask.shape, generator=gen, device=cuda) < 0.1) \
        & (bg.vmask > 0)
    blocks = torch.as_tensor(block_masks(bg.n_blocks)["runs of 1 and 9"],
                             device=cuda)[:, None].expand(bg.n_blocks, bg.block)
    for frozen in (lanes, blocks.contiguous()):
        args = (pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src, bg.weights,
                bg.bias, frozen)
        out, ref = gs_pass(*args), gs_pass_ref(*args)
        torch.cuda.synchronize()
        assert _rel_err(out, ref) <= RTOL
        assert torch.equal(out[frozen], pr[frozen])


# ---------------------------------------------------------------------------
# dynamic updates: the kernels on graphs that change between launches
# ---------------------------------------------------------------------------


def test_incremental_blocked_nosync_on_card_matches_cpu_twin(cuda):
    """IncrementalPageRank on the card (gs_pass) against the same run on
    the CPU twin: one uniform batch, then a forced fallback (push budget
    0), whose warm solve runs gs_pass on the updated in-CSR."""
    from repro_torch.core.dynamic import IncrementalPageRank, random_update_batch

    g = make_dataset("webStanford", scale_down=64)
    reset_launch_counts()
    card = IncrementalPageRank(g, variant="blocked_nosync", tol=1e-8, device=cuda)
    assert launch_counts()["gs_pass"] > 0
    twin = IncrementalPageRank(g, variant="blocked_nosync", tol=1e-8, device="cpu")
    rngs = [np.random.default_rng(1), np.random.default_rng(1)]
    for budget in (10_000, 0):
        reps = []
        for ipr, rng in zip((card, twin), rngs):
            ipr.max_push_rounds = budget
            adds, dels = random_update_batch(ipr.g, rng, 200)
            reset_launch_counts()
            reps.append(ipr.apply(adds=adds, dels=dels))
            if ipr is card and budget == 0:
                assert launch_counts()["gs_pass"] > 0
        assert card.g.m == twin.g.m and np.array_equal(card.g.src, twin.g.src)
        assert reps[0].mode == reps[1].mode == ("push" if budget else "fallback")
        want, _ = pagerank_numpy(card.g, threshold=1e-13, max_iter=100_000)
        for ipr, rep in zip((card, twin), reps):
            assert np.abs(ipr.pagerank - want).sum() <= rep.l1_cert + 1e-9
        assert np.abs(card.pagerank - twin.pagerank).sum() \
            <= reps[0].l1_cert + reps[1].l1_cert


def test_engine_cuda_backend_updates_on_card_match_cpu_twin(cuda):
    """The engine's cuda backend before and after apply_updates, on the
    card and on the CPU twin: the same answers, the same warm-cache keys,
    and gs_pass_multi launched on the backend rebuilt for the new graph."""
    from repro_torch.core.dynamic import random_update_batch

    g = make_dataset("webStanford", scale_down=64)
    qs = make_query_stream(g.n, 12, seed=2)
    engines = [PPREngine(g, slots=8, threshold=1e-7, backend="cuda", device=dev)
               for dev in (cuda, "cpu")]
    adds, dels = random_update_batch(g, np.random.default_rng(3), 100)
    for phase in ("before", "after"):
        if phase == "after":
            for eng in engines:
                eng.apply_updates(adds=adds, dels=dels)
            assert set(engines[0]._cache) == set(engines[1]._cache)
        reset_launch_counts()
        card = {r.qid: r for r in engines[0].drain(qs)}
        assert launch_counts()["gs_pass_multi"] > 0
        twin = {r.qid: r for r in engines[1].drain(qs)}
        gv = engines[0].g
        for qid, r in card.items():
            ref = ppr_numpy(gv, teleport_from_seeds([r.seeds], gv.n),
                            threshold=1e-12)[0][0]
            kth = np.sort(ref)[::-1][r.indices.size - 1]
            assert (ref[r.indices] >= kth - 1e-6).all(), (phase, qid)
            assert np.abs(r.values - ref[r.indices]).max() < 1e-5
            assert np.abs(r.values - twin[qid].values).max() < 1e-5


@pytest.mark.parametrize("plan", [{}, {"sleeps": {(0, it): 5.0 for it in range(1, 200)}},
                                  {"failures": {1: 2}}])
@pytest.mark.parametrize("discipline", ["barrier", "nosync", "waitfree"])
def test_simulate_on_card_equals_cpu(cuda, discipline, plan):
    """The fault simulator's float64 sweeps on the card against the same
    call on the CPU: the same iterations, modelled time and work (the cost
    model branches on every sweep's residual), ranks within 1e-12 in L1."""
    from repro_torch.core.runtime import FaultPlan, simulate

    g = rmat_graph(10, avg_degree=6, seed=7)
    kw = dict(threshold=1e-8,
              max_iter=60 if discipline == "barrier" and plan.get("failures") else 1000)
    card = simulate(PartitionedGraph.from_graph(g, p=8, device=cuda), discipline,
                    FaultPlan(**plan), **kw)
    cpu = simulate(PartitionedGraph.from_graph(g, p=8, device="cpu"), discipline,
                   FaultPlan(**plan), **kw)
    assert (card.iterations, card.sim_time, card.work_done) == \
        (cpu.iterations, cpu.sim_time, cpu.work_done)
    assert l1_norm(card.pr, cpu.pr) <= 1e-12


@pytest.mark.parametrize("weighted", [False, True])
def test_blocked_graph_from_a_memmap_store_on_card(cuda, tmp_path, weighted):
    """BlockedGraph.build from a store's read-only memmaps on the card
    equals the build from the resident graph, tensor for tensor, and the
    blocked_nosync solve on it runs gs_pass to the same ranks."""
    from repro_torch.graphs import load_graph, save_graph

    g = make_dataset("webStanford", scale_down=64)
    if weighted:
        rng = np.random.default_rng(1)
        g = Graph.from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                              weights=1.0 - rng.random(g.m),
                              bias=rng.uniform(0.5, 1.5, g.n))
    save_graph(tmp_path / "s", g)
    h = load_graph(tmp_path / "s", mmap=True)
    assert h.is_memmap
    a = BlockedGraph.build(g, block=256, device=cuda)
    b = BlockedGraph.build(h, block=256, device=cuda)
    for f in dataclasses.fields(BlockedGraph):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert y.device.type == "cuda" and torch.equal(x, y), f.name
        else:
            assert x == y, f.name
    reset_launch_counts()
    ra = solve_variant("blocked_nosync", g, device=cuda, threshold=1e-8)
    rb = solve_variant("blocked_nosync", str(tmp_path / "s"), device=cuda,
                       threshold=1e-8)
    assert launch_counts()["gs_pass"] == ra.iterations + rb.iterations
    assert ra.iterations == rb.iterations and torch.equal(ra.pr, rb.pr)


def test_bfs_build_solved_on_card_equals_cpu(cuda, tmp_path):
    """A small BFS-ordered build (the out-of-core pipeline) solved from its
    memmap by blocked_nosync on the card takes the CPU twin's passes, one
    gs_pass launch each, and its ranks within 1e-6 L1 (float32 sums in
    another order)."""
    from repro_torch.graphs import BuildConfig, GraphStore, run_pipeline

    cfg = BuildConfig(scale=12, avg_degree=8, seed=3, chunk_edges=5000,
                      order="bfs", threads=8)
    res = run_pipeline(tmp_path / "b", cfg, log=lambda m: None)
    g = GraphStore(res["store"]).graph(mmap=True)
    assert g.is_memmap
    kw = dict(threshold=1e-7, handle_dangling=True)
    reset_launch_counts()
    card = solve_variant("blocked_nosync", g, device=cuda, **kw)
    assert launch_counts()["gs_pass"] == card.iterations
    cpu = solve_variant("blocked_nosync", g, device="cpu", **kw)
    assert card.iterations == cpu.iterations
    flat = lambda pr: pr.reshape(-1)[:g.n].double().cpu().numpy()  # noqa: E731
    assert l1_norm(flat(card.pr), flat(cpu.pr)) <= 1e-6


# ---------------------------------------------------------------------------
# The static-analysis passes on the card (repro_torch.analysis)
# ---------------------------------------------------------------------------


def test_kernel_audit_on_card_finds_no_drift_spill_or_overflow(cuda):
    """The mirror of every kernel's shared-memory layout equals the built
    library's at every block from 1 to one past the largest (gs_pass both
    weightings, gs_pass_multi), and every kernel at the path's blocks
    spills nothing and keeps a CTA resident."""
    from repro_torch.analysis.kernels import audit

    findings, reports = audit("cuda")
    assert [f.to_dict() for f in findings] == []
    for rep in reports.values():
        assert rep.card, rep.kernel
        for info in rep.card.values():
            assert info["spill_bytes"] == 0 and info["ctas_per_sm"] >= 1


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("block", [8, 256])
def test_spmv_kernel_info_at_the_paths_blocks(cuda, block, weighted):
    """spmv_kernel_info reports every device function of csrc/spmv.cu
    without spills at the launcher's and the trace lint's block; gs_pass's
    and gs_pass_multi's shared memory are the mirror's."""
    from repro_torch.analysis import kernels as mirror
    from repro_torch.kernels.spmv.build import KERNELS, kernel_info, load

    for name in KERNELS:
        info = kernel_info(name, block, weighted)
        assert info["spill_bytes"] == 0 and info["ctas_per_sm"] >= 1, (name, info)
    limit = load().smem_per_block_optin(torch.cuda.current_device())
    assert kernel_info("gs_pass", block, weighted)["smem_bytes"] == \
        mirror.gs_pass_plan(block, weighted, limit)[2]
    assert kernel_info("gs_pass_multi", block)["smem_bytes"] == mirror.multi_smem_bytes(block)
    assert kernel_info("spmv_csr_acc")["static_smem_bytes"] == mirror.csr_static_smem_bytes()


def test_trace_lint_on_card_is_within_every_contract(cuda):
    """Every non-numpy variant and both engine backends traced on the card:
    no unsuppressed finding, the adaptive partition schedule's order and
    skip-set read (a tolist(), unseen on the CPU) counted once a round, the
    device-counted sweeps read once a solve, and the seeds' teleport row
    uploaded once a solve."""
    from repro_torch.analysis import apply_suppressions, unsuppressed
    from repro_torch.analysis.trace_lint import trace_reports

    reports = {r.target: r for r in trace_reports("cuda")}
    findings = apply_suppressions([f for r in reports.values() for f in r.findings])
    assert [f.to_dict() for f in unsuppressed(findings)] == []
    assert len(reports) == 21
    r = reports["nosync_adaptive"]
    assert r.reads == 2 * r.iterations
    for name in ("nosync", "nosync_opt", "nosync_sticd", "ppr_nosync", "blocked_adaptive"):
        r = reports[name]
        assert r.reads == r.contract * r.iterations + 1, r.line()
    for r in reports.values():
        assert r.uploads == r.upload_contract == r.target.startswith("ppr_"), r.line()
    assert reports["blocked"].launches["spmv_csr_acc"] == reports["blocked"].iterations
    assert reports["serving_cuda"].launches["gs_pass_multi"] == 2


# ---------------------------------------------------------------------------
# whisper-medium and the training path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_whisper_encoder_shape(cuda, dtype):
    """whisper-medium's encoder self-attention at full size: b 2, 16 heads
    (MHA), 1,500 frames, head dim 64, no causal mask; 1,500 is no multiple
    of the tiles, so every key block ends in a masked tail.  One launch;
    every entry within the flash bounds above, a float32 output held
    against the plain version's float64 result (its own float32 sums over
    1,500 keys would take part of the bound)."""
    q, k, v = _qkv(cuda, dtype, 2, 16, 16, 1500, 1500, 64, seed=1500)
    reset_flash_counts()
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 1
    ct = torch.float64 if dtype == torch.float32 else torch.float32
    ref = attention_ref(q.to(ct), k.to(ct), v.to(ct), scale=0.125, causal=False)
    mag = ref.abs()
    bound = 1e-5 * (mag + mag.mean(dim=-1, keepdim=True))
    if dtype == torch.bfloat16:
        bound = bound + 2.0**-8 * mag
    assert float(((out.to(ct) - ref).abs() / bound).max()) <= 1.0


def test_flash_attention_raises_under_grad_on_card(cuda):
    """No backward, as the TPU kernel: a call that autograd would record
    raises instead of launching and dropping q's, k's and v's gradients."""
    q, k, v = _qkv(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 64, seed=3)
    reset_flash_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k.requires_grad_(True), v)
    assert flash_counts()["flash_attention"] == 0
    with torch.no_grad():
        flash_attention(q, k, v)
    assert flash_counts()["flash_attention"] == 1


def test_whisper_on_card_matches_cpu(cuda):
    """whisper-medium reduced, float32, b 2, 64 frames, 24 tokens: the
    card's forward launches the flash kernel once per encoder layer (not
    causal) and once per decoder layer (4), its logits the CPU's within
    1e-4 × (|ref| + mean|ref| of the token's row); then 8 decode steps
    through the cross cache on each device, held the same way."""
    from repro_torch.models.model import DecoderLM, encode, init_cross_cache

    cfg = dataclasses.replace(get_config("whisper-medium").reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    host = DecoderLM(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    gen = torch.Generator(device=cuda).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, 24), device=cuda, generator=gen)
    frames = torch.randn((2, 64, cfg.d_model), device=cuda, generator=gen)
    reset_flash_counts()
    out = forward(cfg, params, toks, frames=frames)
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 4
    assert _logits_worst(out.cpu(), forward(cfg, host, toks.cpu(), frames=frames.cpu())) <= 1e-4
    cache, hcache = init_cache(cfg, 2, 8, device=cuda), init_cache(cfg, 2, 8, device="cpu")
    cache["cross"] = init_cross_cache(cfg, params, encode(cfg, params, frames))
    hcache["cross"] = init_cross_cache(cfg, host, encode(cfg, host, frames.cpu()))
    for t in range(8):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        ref, hcache = decode_step(cfg, host, toks[:, t:t + 1].cpu(), hcache)
        assert _logits_worst(logits.cpu(), ref) <= 1e-4


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of stablelm-3b reduced, float32, b 2, s 65, on the
    card and on the CPU from the same weights and batch: the loss within
    1e-5 relative, the gradient norm within 1e-4 relative, no flash launch
    (training takes the plain route)."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.training import AdamWConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(), dtype="float32")
    card = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    host_model = DecoderLM(cfg, device="cpu")
    host_model.load_state_dict({k: v.detach().cpu() for k, v in card.params.state_dict().items()})
    host = init_train_state(cfg, params=host_model)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=torch.Generator().manual_seed(5))
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=2), ce_chunk=16)
    reset_flash_counts()
    _, got = step(card, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 0
    _, want = step(host, {"tokens": toks})
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
        1e-4 * abs(float(want["grad_norm"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_equal_on_card(cuda, dtype):
    """stablelm-3b reduced, b 2, s 65, on the card: the loss and every
    gradient with ``forward``'s ``remat=True`` (as ``loss_fn`` runs it)
    equal those with ``remat=False`` bit for bit.  The recompute runs the
    same kernels on the same inputs as the forward, and a kept product is
    the forward's own tensor, so nothing may differ."""
    from repro_torch.training import init_train_state
    from repro_torch.training.train_step import fused_chunked_ce

    cfg = dataclasses.replace(get_config("stablelm-3b").reduced(), dtype=dtype)
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=torch.Generator().manual_seed(5))
    toks = toks.to(cuda)
    named = dict(state.params.named_parameters())
    runs = []
    for remat in (True, False):
        feats = forward(cfg, state.params, toks, use_flash_kernel=False, features_only=True,
                        remat=remat)
        loss = fused_chunked_ce(cfg, state.params, feats[:, :-1], toks[:, 1:], 16)
        grads = torch.autograd.grad(loss, list(named.values()))
        runs.append((loss.detach(), grads))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for name, a, b in zip(named, runs[0][1], runs[1][1]):
        assert torch.equal(a, b), name


# the prefill shapes of PERF.md's flash table (chip_smoke.FLASH_TIMED):
# (b, hq, hkv, s, dh, window, causal)
FLASH_COUNTED = [
    (2, 12, 2, 4096, 128, None, True),  # qwen2-vl-2b
    (2, 32, 32, 4096, 80, None, True),  # stablelm-3b
    (2, 24, 2, 8192, 128, 4096, True),  # starcoder2-3b
    (1, 48, 8, 8192, 128, 4096, True),  # mixtral-8x22b
    (2, 16, 16, 1500, 64, None, False),  # whisper-medium's encoder
]


@pytest.mark.parametrize("b,hq,hkv,s,dh,window,causal", FLASH_COUNTED)
def test_flash_op_count_on_card_is_flash_flops(cuda, b, hq, hkv, s, dh, window, causal):
    """The counting mode sees the kernel's launch as one dispatcher op and
    counts ``flash_flops`` for it (4·dh a live pair), on the card as on
    meta; the call launches the kernel once."""
    from repro_torch.utils.cost import CostMode
    from repro_torch.utils.roofline import flash_flops

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, hq, s, dh), device=cuda, dtype=torch.bfloat16, generator=gen)
    k, v = (torch.randn((b, hkv, s, dh), device=cuda, dtype=torch.bfloat16, generator=gen)
            for _ in range(2))
    want = flash_flops(b, hq, s, s, dh, causal, window)
    reset_flash_counts()
    with CostMode() as card:
        flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
    assert flash_counts()["flash_attention"] == 1
    qm, km, vm = (t.to("meta") for t in (q, k, v))
    with CostMode() as meta:
        flash_attention(qm, km, vm, causal=causal, window=window)
    assert card.flops == meta.flops == want
    assert card.ops["repro_torch.flash_attention"] == 1
    assert card.bytes == meta.bytes == 2 * (2 * q.numel() + 2 * k.numel())


def test_reduced_prefill_counts_on_card_as_on_meta(cuda):
    """qwen2-vl-2b reduced, bf16, prefill at b 2, s 256 on the kernel route:
    build_cell's step walked on meta and run on the card under the same
    counting mode give the same FLOPs and peak bytes, and the flash ops
    the walk counts are the kernel's launches on the card."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.utils.cost import CostMode

    cfg = get_config("qwen2-vl-2b").reduced()
    step, args, _, _ = build_cell(cfg, ShapeSpec("small", 256, 2, "prefill"), make_host_mesh())
    with CostMode() as meta:
        step(*args)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    reset_flash_counts()
    with CostMode() as card:
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
    assert card.flops == meta.flops > 0
    assert card.peak_bytes == meta.peak_bytes
    assert card.ops["repro_torch.flash_attention"] == meta.ops["repro_torch.flash_attention"] \
        == flash_counts()["flash_attention"] == cfg.n_layers
