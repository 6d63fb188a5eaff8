"""The port's forward-push PPR solvers against the JAX reference, on the CPU.

Both packages push in float64 numpy in the same order, so ``ppr_push`` and
``push_residual`` give ``est``, ``resid``, ``rounds`` and ``pushes`` equal
to the reference's bit for bit: FIFO and priority, unweighted, weighted and
weighted+biased, dangling redistribution off and on.  Also ported: the
``BucketQueue`` property tests of ``tests/test_adaptive.py``, the
certificate, top-k, batched-spec and empty-graph tests of
``tests/test_ppr.py``, the priority-pushes-fewer test on the BFS-ordered
webStanford surrogate, and the registry's ``(b, n)`` shape with pushes in
the ``sweeps`` slot.
"""
import jax  # noqa: F401
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, strategies as st

    def settings(**_kw):  # the shim runs a fixed number of examples anyway
        return lambda f: f

from repro.ppr import ppr_push as ref_ppr_push
from repro.ppr.push import push_residual as ref_push_residual
from repro.core.solver import solve_variant as ref_solve_variant
from repro.graphs import make_dataset as ref_make_dataset
from repro.graphs import rmat_graph as ref_rmat_graph
from repro_torch.core.pagerank import pagerank_numpy
from repro_torch.core.solver import get_variant, solve_variant
from repro_torch.graphs import Graph, compute_order, graph_from_arrays, permute_graph
from repro_torch.graphs import make_dataset, rmat_graph
from repro_torch.launch import pagerank_run
from repro_torch.ppr import BucketQueue, ppr_numpy, ppr_push, push_residual
from repro_torch.ppr import teleport_from_seeds, topk
from test_weighted import random_weighted_graph

CPU = "cpu"
D = 0.85
RMAX = 1e-8
# hypothesis draws stay out of the tracked example database
NO_DB = dict(database=None)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


PUSH_GRAPHS = {
    "rmat": lambda: ref_rmat_graph(8, avg_degree=6, seed=1),
    "webStanford_512": lambda: ref_make_dataset("webStanford", scale_down=512),
    "weighted": lambda: random_weighted_graph(seed=7, biased=False),
    "weighted_biased": lambda: random_weighted_graph(seed=3),
}


# ---------------------------------------------------------------------------
# bit-for-bit parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("priority", [False, True], ids=["fifo", "priority"])
@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(PUSH_GRAPHS))
def test_ppr_push_equals_reference(gname, handle_dangling, priority):
    g = PUSH_GRAPHS[gname]()
    pg = port(g)
    for seeds in ((3,), (10, 11), ()):
        kw = dict(rmax=1e-7, handle_dangling=handle_dangling, priority=priority)
        a, b = ppr_push(pg, seeds, **kw), ref_ppr_push(g, seeds, **kw)
        np.testing.assert_array_equal(a.est, b.est)
        np.testing.assert_array_equal(a.resid, b.resid)
        assert (a.rounds, a.pushes) == (b.rounds, b.pushes)
        assert a.l1_bound == b.l1_bound


@pytest.mark.parametrize("priority", [False, True], ids=["fifo", "priority"])
def test_push_residual_equals_reference(priority):
    """The shared frontier loop on an arbitrary start (a residual spread over
    many vertices, an estimate already banked), with max_rounds cutting it
    short and letting it run out."""
    g = random_weighted_graph(seed=11, biased=False)
    rng = np.random.default_rng(0)
    r0 = rng.random(g.n) / g.n
    est0 = rng.random(g.n) * 1e-3
    t = teleport_from_seeds([(1, 2)], g.n)[0]
    for max_rounds in (3, 10_000):
        outs = []
        for fn, graph in ((push_residual, port(g)), (ref_push_residual, g)):
            est, r = est0.copy(), r0.copy()
            counts = fn(graph, est, r, d=D, rmax=1e-6, teleport=t,
                        handle_dangling=True, max_rounds=max_rounds,
                        priority=priority)
            outs.append((est, r, counts))
        (ea, ra, ca), (eb, rb, cb) = outs
        np.testing.assert_array_equal(ea, eb)
        np.testing.assert_array_equal(ra, rb)
        assert ca == tuple(cb)


@pytest.mark.parametrize("vname", ["ppr_push", "ppr_push_priority"])
def test_registry_run_equals_reference(vname):
    g = PUSH_GRAPHS["rmat"]()
    seeds = [(1,), (2, 5), ()]
    a = solve_variant(vname, port(g), threshold=1e-8, seeds=seeds,
                      handle_dangling=True, device=CPU)
    b = ref_solve_variant(vname, g, threshold=1e-8, seeds=seeds,
                          handle_dangling=True)
    assert a.pr.shape == (3, g.n) and a.pr.dtype == np.float64
    np.testing.assert_array_equal(a.pr, np.asarray(b.pr))
    assert a.iterations == int(b.iterations) and a.sweeps == int(b.sweeps)
    assert a.err == float(b.err) and a.residuals is None


def test_push_variants_registered():
    for vname, schedule in (("ppr_push", "sequential"),
                            ("ppr_push_priority", "adaptive")):
        v = get_variant(vname)
        assert (v.layout, v.backend, v.schedule) == ("host", "numpy", schedule)
        assert v.options == ("seeds", "rmax")


# ---------------------------------------------------------------------------
# tests/test_ppr.py's push tests, ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("handle_dangling", (False, True))
def test_push_certificate_bounds_true_error(handle_dangling):
    g = rmat_graph(8, avg_degree=6, seed=1)
    for seeds in ((3,), (10, 11), ()):
        res = ppr_push(g, seeds, rmax=1e-7, handle_dangling=handle_dangling)
        ref = ppr_numpy(g, teleport_from_seeds([seeds], g.n), threshold=1e-13,
                        handle_dangling=handle_dangling)[0][0]
        err = np.abs(res.est - ref).sum()
        assert err <= res.l1_bound + 1e-12, (seeds, err, res.l1_bound)
        assert (res.est <= ref + 1e-12).all()


@st.composite
def small_graphs(draw):
    n = draw(st.integers(8, 64))
    m = draw(st.integers(n, 4 * n))
    edges = draw(st.lists(st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)),
                          min_size=m, max_size=m))
    src = np.array([e[0] for e in edges], dtype=np.int32)
    dst = np.array([e[1] for e in edges], dtype=np.int32)
    return Graph.from_edges(n, src, dst)


@settings(max_examples=20, deadline=None, **NO_DB)
@given(small_graphs())
def test_property_push_topk_agrees_with_oracle_within_bound(g):
    """Every oracle top-k vertex the push answer misses is within the push
    residual bound of the answer's k-th value."""
    k = 5
    res = ppr_push(g, (0,), rmax=1e-9, handle_dangling=True)
    ref = ppr_numpy(g, teleport_from_seeds([(0,)], g.n), threshold=1e-13,
                    handle_dangling=True)[0][0]
    idx, vals = res.topk(k)
    kth = vals[-1]
    for v in np.argsort(ref)[::-1][:k]:
        if v not in idx:
            assert ref[v] <= kth + 2 * res.l1_bound + 1e-12


def test_push_rejects_batched_seed_spec():
    g = rmat_graph(6, avg_degree=4, seed=0)
    with pytest.raises(ValueError, match="one seed set per call"):
        ppr_push(g, [(1,), (2,)])
    with pytest.raises(ValueError, match="one seed set per call"):
        ref_ppr_push(ref_rmat_graph(6, avg_degree=4, seed=0), [(1,), (2,)])
    batched = solve_variant("ppr_push", g, threshold=1e-8, seeds=[(1,), (2,)],
                            device=CPU)
    assert batched.pr.shape == (2, g.n)


def test_push_empty_graph():
    g = Graph.from_edges(0, np.zeros(0, np.int32), np.zeros(0, np.int32))
    res = ppr_push(g, ())
    assert res.est.shape == (0,) and res.rounds == 0 and res.pushes == 0


def test_weighted_push_certificate_holds():
    g = port(random_weighted_graph(seed=17, biased=False))
    ref, _ = pagerank_numpy(g, threshold=1e-14)
    res = ppr_push(g, None, rmax=1e-7)
    assert float(np.abs(res.est - ref).sum()) <= res.l1_bound + 1e-12
    assert res.l1_bound < 1e-4


def test_registry_shape_and_pushes_in_sweeps():
    """``(b, n)`` estimates, the pushes of every row in ``sweeps``, the most
    rounds of a row in ``iterations``, the largest bound in ``err``; rmax
    defaults to the threshold."""
    g = rmat_graph(7, avg_degree=5, seed=2)
    seeds = [(1,), (4, 9)]
    for vname, priority in (("ppr_push", False), ("ppr_push_priority", True)):
        r = solve_variant(vname, g, threshold=1e-7, seeds=seeds, device=CPU)
        rows = [ppr_push(g, s, rmax=1e-7, priority=priority) for s in seeds]
        assert r.pr.shape == (2, g.n)
        np.testing.assert_array_equal(r.pr, np.stack([x.est for x in rows]))
        assert r.sweeps == sum(x.pushes for x in rows)
        assert r.iterations == max(x.rounds for x in rows)
        assert r.err == max(x.l1_bound for x in rows)
        explicit = solve_variant(vname, g, threshold=1.0, rmax=1e-7, seeds=seeds,
                                 device=CPU)
        np.testing.assert_array_equal(explicit.pr, r.pr)


def test_topk_tie_break_deterministic():
    idx, vals = topk(np.asarray([0.5, 0.1, 0.1, 0.3]), 3)
    assert idx.tolist() == [0, 3, 1] and vals.tolist() == [0.5, 0.3, 0.1]


# ---------------------------------------------------------------------------
# tests/test_adaptive.py's priority frontier tests, ported
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def web64():
    g = make_dataset("webStanford", scale_down=64)
    return permute_graph(g, compute_order(g, "bfs"))


def test_priority_push_fewer_pushes_on_skewed_residuals(web64):
    fifo = ppr_push(web64, 0, rmax=1e-9)
    prio = ppr_push(web64, 0, rmax=1e-9, priority=True)
    assert prio.pushes < fifo.pushes, (prio.pushes, fifo.pushes)
    for res in (fifo, prio):
        assert (res.resid <= 1e-9).all()
        assert res.l1_bound <= web64.n * 1e-9


@settings(max_examples=20, deadline=None, **NO_DB)
@given(st.lists(st.floats(RMAX, 1.0), min_size=1, max_size=48))
def test_bucket_queue_pop_order_is_max_first(vals):
    q = BucketQueue(RMAX)
    values = np.asarray(vals)
    vertices = np.arange(values.size)
    q.push(vertices, values)
    assert len(q) == values.size
    remaining = dict(zip(vertices.tolist(), values.tolist()))
    prev_bucket = None
    while len(q):
        batch = q.pop_batch()
        assert batch.size > 0
        assert np.array_equal(batch, np.unique(batch))
        bvals = np.asarray([remaining.pop(int(v)) for v in batch])
        buckets = np.asarray(q.bucket_of(bvals))
        assert (buckets == buckets[0]).all()
        if prev_bucket is not None:
            assert buckets[0] < prev_bucket
        prev_bucket = int(buckets[0])
        assert bvals.max() <= 2.0 * bvals.min() * (1 + 1e-9)
        if remaining:
            assert max(remaining.values()) <= bvals.min() * (1 + 1e-9)
    assert not remaining
    assert q.pop_batch().size == 0


def test_bucket_queue_empty_single_and_validation():
    q = BucketQueue(1e-6)
    assert len(q) == 0
    assert q.pop_batch().size == 0
    q.push(np.zeros(0, np.int64), np.zeros(0))
    assert len(q) == 0
    q.push(5, 3e-5)
    assert len(q) == 1
    assert q.pop_batch().tolist() == [5]
    assert len(q) == 0 and q.pop_batch().size == 0
    with pytest.raises(ValueError, match="rmax"):
        BucketQueue(0.0)


def test_bucket_queue_all_equal_residuals():
    q = BucketQueue(1e-6)
    v = np.arange(33, dtype=np.int64)
    q.push(np.concatenate([v, v[::2]]), np.full(33 + 17, 4e-6))
    assert np.array_equal(q.pop_batch(), v)
    assert q.pop_batch().size == 0


def test_bucket_queue_lazy_repush_leaves_stale_entry():
    q = BucketQueue(1e-6)
    q.push(7, 4e-6)  # bucket 2
    q.push(7, 3e-6)  # bucket 1: the old entry stays
    assert len(q) == 2
    assert q.pop_batch().tolist() == [7]
    assert q.pop_batch().tolist() == [7]
    assert len(q) == 0


@settings(max_examples=10, deadline=None, **NO_DB)
@given(st.integers(0, 10_000), st.integers(16, 64), st.booleans())
def test_priority_drain_preserves_certificate(seed, n, dangling):
    rng = np.random.default_rng(seed)
    m = 4 * n
    g = Graph.from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m))
    s = int(rng.integers(0, n))
    exact = ppr_numpy(g, teleport_from_seeds([(s,)], g.n), threshold=1e-13,
                      handle_dangling=dangling)[0][0]
    rmax = 1e-6
    fifo = ppr_push(g, s, rmax=rmax, handle_dangling=dangling)
    prio = ppr_push(g, s, rmax=rmax, handle_dangling=dangling, priority=True)
    for res in (fifo, prio):
        assert np.abs(res.est - exact).sum() <= res.l1_bound + 1e-9
        assert (res.resid <= rmax * (1 + 1e-12)).all()
    assert np.abs(fifo.est - prio.est).sum() \
        <= fifo.l1_bound + prio.l1_bound + 1e-9


def test_bucket_queue_matches_reference():
    from repro.ppr.push import BucketQueue as RefBucketQueue

    rng = np.random.default_rng(1)
    vals = 10.0 ** rng.uniform(-9, 0, 200)
    verts = rng.integers(0, 50, 200)
    a, b = BucketQueue(1e-8), RefBucketQueue(1e-8)
    np.testing.assert_array_equal(a.bucket_of(vals), b.bucket_of(vals))
    for q in (a, b):
        q.push(verts[:120], vals[:120])
    while len(b):
        np.testing.assert_array_equal(a.pop_batch(), b.pop_batch())
        a.push(verts[120:130], vals[120:130])
        b.push(verts[120:130], vals[120:130])
        verts, vals = verts[10:], vals[10:]
    assert len(a) == 0


# ---------------------------------------------------------------------------
# the launcher's query subcommand
# ---------------------------------------------------------------------------


def test_launcher_query_push_on_cpu(capsys):
    rep = pagerank_run.run(["query", "--scale-down", "512", "--seeds", "7,42",
                            "--top-k", "3"])
    out = capsys.readouterr().out
    g = make_dataset("webStanford", scale_down=512)
    res = ppr_push(g, (7, 42), rmax=1e-8)
    idx, vals = res.topk(3)
    assert rep["top"] == [(int(v), float(x)) for v, x in zip(idx, vals)]
    assert (rep["rounds"], rep["pushes"]) == (res.rounds, res.pushes)
    assert f"solver=push: rounds={res.rounds} pushes={res.pushes}" in out
    assert f"#1   vertex {int(idx[0]):<8d}" in out


def test_launcher_query_batched_on_cpu(capsys):
    rep = pagerank_run.run(["query", "--scale-down", "512", "--seeds", "7,42",
                            "--top-k", "3", "--solver", "batched",
                            "--device", "cpu", "--handle-dangling"])
    g = make_dataset("webStanford", scale_down=512)
    ref = ppr_numpy(g, teleport_from_seeds([(7, 42)], g.n), threshold=1e-13,
                    handle_dangling=True)[0][0]
    idx, vals = topk(ref, 3)
    assert [v for v, _ in rep["top"]] == idx.tolist()
    assert np.abs(np.array([x for _, x in rep["top"]]) - vals).max() < 1e-6
    assert rep["iterations"] >= 1
    assert "solver=batched: iterations=" in capsys.readouterr().out
