"""The port's blocked kernel path (``repro_torch.kernels.spmv.ops``) on the
CPU against the JAX reference, on the three ``tests/test_solver.py``
surrogates with dangling redistribution off and on.

* ``blocked`` against ``pallas`` (interpret mode, block 64, tile_cap 128):
  the same iterations and sweeps, ``pr`` within 1e-6 max abs, residuals
  within 1e-6 × max|pr| (see tests/test_torch_solver.py for the
  tolerance and for why parity is checked at threshold 1e-7).
* ``blocked_nosync``/``_opt`` against ``nosync``/``_opt`` with one
  partition per dst block (``p = n_blocks``, ``block`` dividing ``n``) and
  ``thread_level=False``: the same iterations, ranks and residuals.
  Sweeps differ by design: a blocked pass counts one sweep, as the
  reference's ``pallas_nosync`` does, where ``nosync`` counts ``p``.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import PartitionedGraph as RefPartitionedGraph
from repro.core import pagerank_nosync as ref_pagerank_nosync
from repro.core.solver import solve_variant as ref_solve_variant
from repro_torch.core.pagerank import l1_norm, pagerank_numpy
from repro_torch.core.solver import solve_variant
from repro_torch.graphs import Graph, graph_from_arrays, rmat_graph
from repro_torch.kernels.spmv import BlockedGraph, pagerank_blocked
from test_solver import SURROGATES
from test_torch_solver import PARITY_THRESH, assert_parity

THRESH = 1e-8
CPU = "cpu"
BLOCKED = ("blocked", "blocked_nosync", "blocked_nosync_opt")
# a block dividing each surrogate's n, so p = n_blocks partitions line up
DIVIDING_BLOCK = {"rmat": 64, "lattice": 48, "dangling_heavy": 32}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
def test_blocked_matches_pallas(gname, handle_dangling):
    g = SURROGATES[gname]()
    kw = dict(threshold=PARITY_THRESH, handle_dangling=handle_dangling,
              block=64, tile_cap=128)
    ref = ref_solve_variant("pallas", g, interpret=True, **kw)
    got = solve_variant("blocked", port(g), device=CPU, **kw)
    assert_parity(ref, got)


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
@pytest.mark.parametrize("vname", ["blocked_nosync", "blocked_nosync_opt"])
def test_blocked_nosync_matches_partitioned_nosync(vname, gname, handle_dangling):
    g = SURROGATES[gname]()
    block = DIVIDING_BLOCK[gname]
    ref = ref_pagerank_nosync(
        RefPartitionedGraph.from_graph(g, p=g.n // block),
        threshold=PARITY_THRESH, thread_level=False,
        handle_dangling=handle_dangling, perforate=vname.endswith("_opt"))
    got = solve_variant(vname, port(g), threshold=PARITY_THRESH,
                        handle_dangling=handle_dangling, block=block, device=CPU)
    assert_parity(ref, got, sweeps=False)
    assert got.sweeps == got.iterations


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
@pytest.mark.parametrize("vname", BLOCKED)
def test_blocked_variants_reach_oracle_fixed_point(vname, gname, handle_dangling):
    g = port(SURROGATES[gname]())
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    r = solve_variant(vname, g, threshold=THRESH, handle_dangling=handle_dangling,
                      block=64, device=CPU)
    tol = 1e-3 if vname.endswith("_opt") else 1e-5
    assert l1_norm(r.pr, ref) < tol
    assert r.iterations >= 1 and r.pr.shape == (g.n,)
    if handle_dangling:  # redistributed mass keeps the ranks a distribution
        assert 0.9 < float(r.pr.double().sum()) < 1.0 + 1e-4


def test_blocked_nosync_iterations_not_worse_fig7():
    """Paper Fig 7: the fresh-read schedule needs no more iterations than
    the barrier schedule on the same kernel layout."""
    g = rmat_graph(9, avg_degree=6, seed=1)
    bg = BlockedGraph.build(g, block=128, device=CPU)
    rb = pagerank_blocked(bg, threshold=1e-7)
    rn = pagerank_blocked(bg, threshold=1e-7, schedule="nosync")
    ro = pagerank_blocked(bg, threshold=1e-7, schedule="nosync", perforate=True)
    ref, _ = pagerank_numpy(g, threshold=1e-12)
    assert l1_norm(rn.pr, ref) < 1e-3 and l1_norm(ro.pr, ref) < 1e-3
    assert rn.iterations <= rb.iterations
    assert ro.iterations <= rn.iterations


def test_blocked_warm_start_matches_pallas():
    g = SURROGATES["rmat"]()
    pr0, _ = pagerank_numpy(port(g), threshold=1e-4)
    kw = dict(threshold=PARITY_THRESH, block=64, tile_cap=128, pr0=pr0)
    ref = ref_solve_variant("pallas", g, interpret=True, **kw)
    got = solve_variant("blocked", port(g), device=CPU, **kw)
    assert_parity(ref, got)


def test_blocked_rejects_bad_schedules():
    bg = BlockedGraph.build(rmat_graph(6, avg_degree=4, seed=0), block=64,
                            device=CPU)
    with pytest.raises(ValueError, match="schedule"):
        pagerank_blocked(bg, schedule="warp")
    with pytest.raises(ValueError, match="perforate"):
        pagerank_blocked(bg, schedule="barrier", perforate=True)
    # the reference's check: adaptive needs the gain certificate
    with pytest.raises(ValueError, match="adaptive.*gain=True"):
        pagerank_blocked(bg, schedule="adaptive")
    with pytest.raises(ValueError, match="perforate"):
        pagerank_blocked(bg, schedule="adaptive", perforate=True)


def test_blocked_layout_is_the_in_csr():
    g = rmat_graph(7, avg_degree=5, seed=2)
    bg = BlockedGraph.build(g, block=48, tile_cap=4096, device=CPU)
    assert bg.n_blocks == 3 and bg.in_ptr.shape == (3 * 48 + 1,)
    np.testing.assert_array_equal(bg.in_ptr[:g.n + 1].numpy(), g.in_ptr)
    assert int(bg.in_ptr[-1]) == g.m  # padding rows are empty
    np.testing.assert_array_equal(bg.src.numpy(), g.src)
    assert bg.weights is None and bg.bias is None
    assert float(bg.vmask.sum()) == g.n


def test_empty_graph_through_blocked():
    g = Graph.from_edges(0, np.zeros(0, np.int32), np.zeros(0, np.int32))
    for vname in BLOCKED:
        r = solve_variant(vname, g, block=64, device=CPU)
        assert r.pr.shape == (0,) and r.iterations == 0


@pytest.mark.parametrize("vname", BLOCKED)
def test_zero_edge_graph_through_blocked(vname):
    n = 40
    g = Graph.from_edges(n, np.zeros(0, np.int32), np.zeros(0, np.int32))
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=True)
    r = solve_variant(vname, g, threshold=THRESH, handle_dangling=True,
                      block=16, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6
