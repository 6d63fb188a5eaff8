"""The port's last vertex-centric variants, ``barrier_edge`` (Alg 2) and
``barrier_identical`` (STIC-D identical nodes), against the reference's
variants of the same name, on the CPU.

* ``Graph.in_neighbor_classes`` numbers classes exactly as the reference
  does (first appearance; weights and bias in the key): ``cls_of`` arrays
  are equal.
* Parity on the three ``tests/test_solver.py`` surrogates with dangling
  redistribution off and on, and on ``tests/test_weighted.py``'s
  weighted+biased graphs (weighted+biased+dangling contracts in neither
  package): the same iterations and sweeps, ``pr`` within 1e-6 max abs and
  residuals within 1e-6 × max|pr| at threshold 1e-7, as
  ``tests/test_torch_solver.py::assert_parity`` states.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core.pagerank import IdenticalNodePlan as RefIdenticalNodePlan
from repro.core.solver import solve_variant as ref_solve_variant
from repro_torch.core.pagerank import (
    EdgeCentricGraph,
    IdenticalNodePlan,
    l1_norm,
    pagerank_numpy,
)
from repro_torch.core.solver import get_variant, solve_variant
from repro_torch.graphs import Graph, graph_from_arrays
from test_solver import SURROGATES
from test_torch_solver import PARITY_THRESH, assert_parity
from test_weighted import random_weighted_graph

CPU = "cpu"
VARIANTS = ("barrier_edge", "barrier_identical")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


WEIGHTED = {
    "weighted_biased": lambda: random_weighted_graph(seed=3),
    "weighted": lambda: random_weighted_graph(seed=7, biased=False),
}


@pytest.mark.parametrize("gname", sorted(SURROGATES) + sorted(WEIGHTED))
def test_in_neighbor_classes_match_reference(gname):
    g = {**SURROGATES, **WEIGHTED}[gname]()
    cls_of = port(g).in_neighbor_classes()
    assert cls_of.dtype == np.int64
    np.testing.assert_array_equal(cls_of, g.in_neighbor_classes())


def test_identical_classes_split_by_weights_and_bias():
    # 1 and 2 share the in-neighbour set {0}: one class unweighted,
    # two once the in-edge weights or the biases differ
    src, dst = np.asarray([0, 0]), np.asarray([1, 2])
    cls = Graph.from_edges(3, src, dst).in_neighbor_classes()
    assert cls[1] == cls[2]
    cls = Graph.from_edges(3, src, dst,
                           weights=np.asarray([0.5, 1.0])).in_neighbor_classes()
    assert cls[1] != cls[2]
    cls = Graph.from_edges(3, src, dst,
                           bias=np.asarray([1.0, 1.0, 2.0])).in_neighbor_classes()
    assert cls[1] != cls[2]


@pytest.mark.parametrize("gname", sorted(SURROGATES) + sorted(WEIGHTED))
def test_identical_plan_keeps_the_reference_edges(gname):
    g = {**SURROGATES, **WEIGHTED}[gname]()
    ref = RefIdenticalNodePlan.from_graph(g)
    got = IdenticalNodePlan.from_graph(port(g), device=CPU)
    assert got.n_classes == ref.n_classes
    np.testing.assert_array_equal(got.cls_of.numpy(), np.asarray(ref.cls_of))
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(ref.src))
    lens = np.bincount(np.asarray(ref.dst_class), minlength=ref.n_classes)
    np.testing.assert_array_equal(np.diff(got.cls_ptr.numpy()), lens)


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
@pytest.mark.parametrize("vname", VARIANTS)
def test_variants_match_reference(vname, gname, handle_dangling):
    g = SURROGATES[gname]()
    kw = dict(threshold=PARITY_THRESH, handle_dangling=handle_dangling)
    ref = ref_solve_variant(vname, g, **kw)
    got = solve_variant(vname, port(g), device=CPU, **kw)
    assert_parity(ref, got)


@pytest.mark.parametrize("gname", sorted(WEIGHTED))
@pytest.mark.parametrize("vname", VARIANTS)
def test_variants_match_reference_weighted(vname, gname):
    g = WEIGHTED[gname]()
    ref = ref_solve_variant(vname, g, threshold=PARITY_THRESH)
    got = solve_variant(vname, port(g), device=CPU, threshold=PARITY_THRESH)
    assert_parity(ref, got)
    oracle, _ = pagerank_numpy(port(g), threshold=1e-13)
    assert l1_norm(solve_variant(vname, port(g), device=CPU, threshold=1e-9).pr,
                   oracle) < 1e-6


def test_weighted_dangling_matches_reference():
    """Weighted (unbiased) with dangling redistribution contracts in both
    packages (``tests/test_weighted.py::test_weighted_dangling_round_trip``)."""
    g = WEIGHTED["weighted"]()
    for vname in VARIANTS:
        kw = dict(threshold=PARITY_THRESH, handle_dangling=True)
        assert_parity(ref_solve_variant(vname, g, **kw),
                      solve_variant(vname, port(g), device=CPU, **kw))


def test_warm_start_matches_reference():
    g = SURROGATES["rmat"]()
    pr0, _ = pagerank_numpy(port(g), threshold=1e-4)
    for vname in VARIANTS:
        kw = dict(threshold=PARITY_THRESH, pr0=pr0)
        assert_parity(ref_solve_variant(vname, g, **kw),
                      solve_variant(vname, port(g), device=CPU, **kw))


def test_edge_layout_scatters_through_offset_list():
    g = port(SURROGATES["dangling_heavy"]())
    eg = EdgeCentricGraph.from_graph(g, device=CPU)
    # phase I writes each src-sorted edge to its dst-sorted slot: the slots
    # are a permutation, and the src written there is the edge's src
    slot = eg.edge_slot.numpy()
    np.testing.assert_array_equal(np.sort(slot), np.arange(g.m))
    np.testing.assert_array_equal(g.src[slot], eg.src_by_src.numpy())


def test_variants_registered():
    for vname, layout in (("barrier_edge", "edge"), ("barrier_identical", "identical")):
        v = get_variant(vname)
        assert (v.layout, v.backend, v.schedule) == (layout, "torch", "barrier")


@pytest.mark.parametrize("vname", VARIANTS)
def test_empty_and_edgeless_graphs(vname):
    n = 12
    g = Graph.from_edges(n, np.zeros(0, np.int32), np.zeros(0, np.int32))
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=True)
    r = solve_variant(vname, g, threshold=1e-9, handle_dangling=True, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6
