"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a GPU (marker ``cuda``): on a machine without one
they skip, decided inside the fixture.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the card's machine has none.  Tolerances: the
kernels sum each row in another order than the plain versions (a strided
warp sum against ``segment_reduce``), so results agree to float32 rounding of
the row sums — max abs error ≤ 1e-5 × max|ref|.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pagerank import l1_norm, pagerank_numpy
from repro_torch.core.solver import solve_variant
from repro_torch.graphs import Graph, make_dataset, rmat_graph
from repro_torch.kernels.spmv import (
    BlockedGraph,
    gs_pass,
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
    return float((out - ref).abs().max() / ref.abs().max())


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
    assert launch_counts() == {"spmv_csr_acc": 1, "gs_pass": 2}


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
