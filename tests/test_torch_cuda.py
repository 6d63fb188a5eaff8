"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a GPU (marker ``cuda``): on a machine without one
they skip, decided inside the fixture.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine has none.  Tolerances: the
kernels sum each row in another order than the plain versions (a strided
warp sum against ``segment_reduce``), so results agree to float32 rounding of
the row sums: every entry within 1e-5 × (its |ref| + the mean |ref| of its
rank row).  The mean term covers entries near 0; a bound on max|ref| alone
would let a wrong entry far from a PPR seed pass.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pagerank import l1_norm, pagerank_numpy
from repro_torch.core.solver import solve_variant
from repro_torch.ppr import ppr_numpy, teleport_from_seeds
from repro_torch.ppr.batched import bias_scaled, blocked_rows
from repro_torch.serving import PPREngine, make_query_stream
from repro_torch.graphs import Graph, make_dataset, rmat_graph
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
)

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
    return {"rmat": g, "rmat_weighted": weighted, "hub": hub}


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


@pytest.mark.parametrize("vname", ["blocked", "blocked_nosync", "blocked_nosync_opt"])
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


@pytest.mark.parametrize("vname", ["barrier", "nosync", "blocked", "blocked_nosync"])
def test_same_input_solves_repeat_exactly(cuda, vname):
    # hub rows with thousands of in-edges: an atomic sum would reorder them
    g = make_dataset("webStanford", scale_down=4)
    a, b = (solve_variant(vname, g, threshold=1e-8, handle_dangling=True,
                          device=cuda) for _ in range(2))
    assert a.iterations == b.iterations > 0
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


@pytest.mark.parametrize("b", [1, 3, 8, 40])
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


@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "hub"])
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
    """block 1024 at b = 64 needs more shared memory than a CTA may opt
    into on the H100 (227 KB); block 256 at b = 64 fits and launches."""
    g = _graphs()["rmat"]
    for block, fits in ((1024, False), (256, True)):
        bg = BlockedGraph.build(g, block=block, device=cuda)
        st = torch.zeros(bg.n_blocks, bg.block, 64, device=cuda)
        args = (st, bg.inv_out, bg.vmask, st, torch.zeros(64, device=cuda),
                0.85, bg.in_ptr, bg.src)
        if fits:
            assert torch.equal(gs_pass_multi(*args), st)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                gs_pass_multi(*args)


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
