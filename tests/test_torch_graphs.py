"""The port's host graph code is a copy of the reference's: the same inputs
give array-equal graphs, so both packages solve the identical problem."""
import jax  # noqa: F401  (imported with torch at the top, as every parity file)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.graphs import make_dataset as ref_make_dataset
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.csr import Graph as RefGraph
from repro.graphs.csr import inv_out_and_dangling as ref_inv_out_and_dangling
from repro.graphs.rmat import rmat_edges as ref_rmat_edges
from repro_torch.graphs import (
    DATASETS,
    Graph,
    graph_from_arrays,
    inv_out_and_dangling,
    make_dataset,
    rmat_edges,
    rmat_graph,
)

FIELDS = ("src", "dst", "out_degree", "in_ptr")


def assert_same_graph(ref, got):
    assert got.n == ref.n and got.m == ref.m
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("weights", "bias"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


def weighted_ref_graph(seed=0):
    rng = np.random.default_rng(seed)
    n, m = 48, 200
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    return RefGraph.from_edges(n, src, dst, weights=rng.uniform(0.3, 1.0, m),
                               bias=rng.uniform(0.5, 1.5, n))


@pytest.mark.parametrize("scale,avg_degree,seed", [(8, 5, 3), (9, 6, 1), (7, 4, 0)])
def test_rmat_graph_bit_identical(scale, avg_degree, seed):
    assert_same_graph(ref_rmat_graph(scale, avg_degree=avg_degree, seed=seed),
                      rmat_graph(scale, avg_degree=avg_degree, seed=seed))


def test_rmat_edges_bit_identical():
    a = ref_rmat_edges(10, 3000, a=0.6, b=0.19, c=0.19, seed=7)
    b = rmat_edges(10, 3000, a=0.6, b=0.19, c=0.19, seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["webStanford", "roaditalyosm", "rmatSkew"])
def test_make_dataset_bit_identical(name):
    assert_same_graph(ref_make_dataset(name, scale_down=2048),
                      make_dataset(name, scale_down=2048))


def test_dataset_registry_matches_reference():
    from repro.graphs import DATASETS as REF_DATASETS

    assert set(DATASETS) == set(REF_DATASETS)
    for name, spec in REF_DATASETS.items():
        got = DATASETS[name]
        assert (got.n_vertices, got.n_edges, got.family) == \
            (spec.n_vertices, spec.n_edges, spec.family)


def test_make_dataset_cache_waits_for_the_store_slice(tmp_path):
    # the store slice has landed: the cache keeps a store, and a second
    # call loads it memmap-backed (tests/test_torch_store.py holds the rest)
    built = make_dataset("webStanford", scale_down=2048, cache_dir=str(tmp_path))
    hit = make_dataset("webStanford", scale_down=2048, cache_dir=str(tmp_path))
    assert hit.is_memmap and not built.is_memmap
    for name in ("src", "dst", "out_degree", "in_ptr"):
        assert np.array_equal(getattr(built, name), getattr(hit, name))


@pytest.mark.parametrize("n_pad", [None, 300])
def test_inv_out_and_dangling_equal(n_pad):
    g = ref_rmat_graph(8, avg_degree=5, seed=3)
    for a, b in zip(ref_inv_out_and_dangling(g.out_degree, n_pad),
                    inv_out_and_dangling(g.out_degree, n_pad)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["plain", "weighted_biased"])
def test_graph_from_arrays_round_trips_reference_graph(kind):
    ref = ref_rmat_graph(8, avg_degree=5, seed=3) if kind == "plain" \
        else weighted_ref_graph()
    got = graph_from_arrays(ref.n, ref.src, ref.dst, ref.out_degree,
                            ref.in_ptr, ref.weights, ref.bias)
    assert_same_graph(ref, got)
    # copies, not views: the port's graph cannot change under the reference
    assert not np.shares_memory(got.src, ref.src)


def test_from_edges_matches_reference_weighted():
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 40, 150), rng.integers(0, 40, 150)
    w, b = rng.uniform(0.3, 1.0, 150), rng.uniform(0.5, 1.5, 40)
    assert_same_graph(RefGraph.from_edges(40, src, dst, weights=w, bias=b),
                      Graph.from_edges(40, src, dst, weights=w, bias=b))


@pytest.mark.parametrize("breakage", ["unsorted", "in_ptr", "out_degree",
                                      "range", "weights", "bias"])
def test_graph_from_arrays_rejects_broken_invariants(breakage):
    g = weighted_ref_graph()
    a = dict(n=g.n, src=g.src.copy(), dst=g.dst.copy(),
             out_degree=g.out_degree.copy(), in_ptr=g.in_ptr.copy(),
             weights=g.weights.copy(), bias=g.bias.copy())
    if breakage == "unsorted":
        a["dst"] = a["dst"][::-1].copy()
    elif breakage == "in_ptr":
        a["in_ptr"][1] += 1
    elif breakage == "out_degree":
        a["out_degree"][0] += 1
    elif breakage == "range":
        a["src"][0] = g.n
    elif breakage == "weights":
        a["weights"] = a["weights"][:-1]
    else:
        a["bias"] = a["bias"][:-1]
    with pytest.raises(ValueError):
        graph_from_arrays(**a)


def test_from_edges_rejects_like_reference():
    for bad in (dict(weights=np.ones(1)), dict(bias=np.ones(1))):
        with pytest.raises(ValueError):
            RefGraph.from_edges(2, [0, 1], [1, 0], **bad)
        with pytest.raises(ValueError):
            Graph.from_edges(2, [0, 1], [1, 0], **bad)
    with pytest.raises(ValueError, match="out of range"):
        Graph.from_edges(2, [0, 2], [1, 0])
