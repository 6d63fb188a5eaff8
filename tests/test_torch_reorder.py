"""The port's vertex reordering (``repro_torch.graphs.reorder``) and the
out-CSR helpers it shares with the new variants are copies of the
reference's: the same graphs give array-equal orders, permuted graphs and
un-permuted ranks.  Host numpy only, so every comparison is exact.

Surrogates: webStanford at scale_down 256 (the adaptive tests' fixture
size) and ``tests/test_solver.py``'s dangling-heavy graph (vertices that
no in-edge reaches, so BFS re-seeds), each unweighted and with seeded
weights and biases (``permute_graph`` carries both).
"""
import jax  # noqa: F401  (imported with torch at the top, as every parity file)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.graphs import make_dataset as ref_make_dataset
from repro.graphs.csr import Graph as RefGraph
from repro.graphs.csr import _concat_ranges as ref_concat_ranges
from repro.graphs.reorder import ORDERS as REF_ORDERS
from repro.graphs.reorder import compute_order as ref_compute_order
from repro.graphs.reorder import invert_perm as ref_invert_perm
from repro.graphs.reorder import permute_graph as ref_permute_graph
from repro.graphs.reorder import unpermute_ranks as ref_unpermute_ranks
from repro_torch.graphs import (
    ORDERS,
    compute_order,
    graph_from_arrays,
    invert_perm,
    permute_graph,
    unpermute_ranks,
)
from repro_torch.graphs.csr import _concat_ranges
from test_solver import SURROGATES
from test_torch_graphs import assert_same_graph


def _weighted(g):
    rng = np.random.default_rng(4)
    return RefGraph.from_edges(g.n, g.src, g.dst,
                               weights=rng.uniform(0.2, 1.0, g.m),
                               bias=rng.uniform(0.5, 1.5, g.n))


REF_GRAPHS = {
    "webStanford": lambda: ref_make_dataset("webStanford", scale_down=256),
    "dangling_heavy": SURROGATES["dangling_heavy"],
}


@pytest.fixture(scope="module", params=[
    (name, weighted) for name in sorted(REF_GRAPHS) for weighted in (False, True)],
    ids=lambda p: f"{p[0]}-{'weighted' if p[1] else 'plain'}")
def pair(request):
    name, weighted = request.param
    ref = REF_GRAPHS[name]()
    if weighted:
        ref = _weighted(ref)
    return ref, graph_from_arrays(ref.n, ref.src, ref.dst, ref.out_degree,
                                  ref.in_ptr, ref.weights, ref.bias)


def test_orders_are_the_reference_list():
    assert ORDERS == REF_ORDERS


@pytest.mark.parametrize("kind", ["none", "bfs", "degree", "random"])
def test_compute_order_matches_reference(pair, kind):
    ref, got = pair
    want = ref_compute_order(ref, kind, seed=3)
    perm = compute_order(got, kind, seed=3)
    assert perm.dtype == want.dtype
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(np.sort(perm), np.arange(got.n))
    np.testing.assert_array_equal(invert_perm(perm), ref_invert_perm(want))


@pytest.mark.parametrize("kind", ["bfs", "random"])
def test_permute_graph_and_unpermute_ranks_match_reference(pair, kind):
    ref, got = pair
    perm = compute_order(got, kind)
    assert_same_graph(ref_permute_graph(ref, perm), permute_graph(got, perm))
    pr = np.random.default_rng(9).random((2, got.n))
    np.testing.assert_array_equal(unpermute_ranks(pr, perm),
                                  ref_unpermute_ranks(pr, perm))
    np.testing.assert_array_equal(unpermute_ranks(pr[0], perm),
                                  ref_unpermute_ranks(pr[0], perm))


def test_unpermute_inverts_permute(pair):
    """A rank vector solved on the permuted graph maps back to the
    original ids: permuting the indices of a per-vertex quantity and
    un-permuting it is the identity."""
    _, got = pair
    perm = compute_order(got, "bfs")
    pg = permute_graph(got, perm)
    stored = np.empty(got.n)
    stored[perm] = got.out_degree  # out-degree under the new ids
    np.testing.assert_array_equal(pg.out_degree, stored)
    np.testing.assert_array_equal(unpermute_ranks(stored, perm), got.out_degree)


def test_unknown_order_raises(pair):
    with pytest.raises(ValueError, match="unknown order"):
        compute_order(pair[1], "hilbert")


def test_concat_ranges_matches_reference(pair):
    ref, got = pair
    verts = np.random.default_rng(1).choice(got.n, size=min(40, got.n),
                                            replace=False)
    np.testing.assert_array_equal(_concat_ranges(got.in_ptr, verts),
                                  ref_concat_ranges(ref.in_ptr, verts))
    assert _concat_ranges(got.in_ptr, verts[:0]).size == 0


def test_out_csr_matches_reference(pair):
    ref, got = pair
    for a, b in zip(ref.out_csr(), got.out_csr()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    out_ptr, out_dst, slot = got.out_csr()
    # offsetList: the j-th src-sorted edge sits at slot[j] of the dst order
    np.testing.assert_array_equal(got.dst[slot], out_dst)
    np.testing.assert_array_equal(np.diff(out_ptr), got.out_degree)
