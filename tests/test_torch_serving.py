"""The port's PPR serving engine (``repro_torch.serving.ppr_engine``) on the
CPU, against the JAX reference's ``PPREngine`` and the float64 oracle.

* The torch backend against the reference's ``backend="jax"`` on one
  query stream: the same qids in the same order, the same iterations and
  warm-start flags, equal top-k indices and values within 1e-6.  The
  engines run at threshold 1e-6, for the reason PPR parity does in
  tests/test_torch_ppr.py (a residual of 1e-7 is a few float32 ulps of a
  seed's rank).
* The cuda backend (its kernel's plain version on the CPU) against the
  oracle: answered vertices sit in the oracle's top-k value band (1e-6)
  and carry the oracle's scores within 1e-5.  The reference's ``pallas``
  backend does not trace under the installed JAX.
* The reference's engine checks (``tests/test_ppr.py``): warm starts,
  rejection when full, per-slot early exit, ``reset``, a malformed query.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.serving.ppr_engine import PPREngine as RefPPREngine
from repro.serving.ppr_engine import PPRQuery as RefPPRQuery
from repro.serving.ppr_engine import make_query_stream as ref_make_query_stream
from repro_torch.graphs import Graph, rmat_graph
from repro_torch.kernels.spmv import launch_counts
from repro_torch.ppr import ppr_numpy, teleport_from_seeds
from repro_torch.serving import PPREngine, PPRQuery, make_query_stream
from test_torch_solver import port
from test_torch_spmv import GRAPHS

CPU = "cpu"
PARITY_THRESH = 1e-6
BACKENDS = {"torch": {}, "cuda": {"block": 64}}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def engine(g, backend="torch", **kw):
    return PPREngine(g, backend=backend, device=CPU, **BACKENDS[backend], **kw)


def _oracle_band_check(g, resp, k, handle_dangling=False):
    ref = ppr_numpy(g, teleport_from_seeds([resp.seeds], g.n), threshold=1e-12,
                    handle_dangling=handle_dangling)[0][0]
    kth = np.sort(ref)[::-1][k - 1]
    assert (ref[resp.indices] >= kth - 1e-6).all(), resp.seeds
    assert np.abs(resp.values - ref[resp.indices]).max() < 1e-5, resp.seeds


@pytest.mark.parametrize("n,count,seed", [(256, 30, 0), (3, 30, 3), (1, 5, 1)])
def test_query_stream_is_the_reference_stream(n, count, seed):
    a = make_query_stream(n, count, seed=seed, top_k=7)
    b = ref_make_query_stream(n, count, seed=seed, top_k=7)
    assert [(q.qid, q.seeds, q.top_k) for q in a] == \
        [(q.qid, q.seeds, q.top_k) for q in b]


# not weighted+biased with dangling: re-teleporting dangling mass onto a
# biased row (row sum up to 1.5 here) is no contraction, in either package
@pytest.mark.parametrize("gname,handle_dangling", [
    ("rmat", False), ("rmat", True), ("dangling_heavy", False),
    ("dangling_heavy", True), ("rmat_weighted", False)])
def test_torch_backend_answers_like_the_reference(gname, handle_dangling):
    g = GRAPHS[gname][0]()
    qs = make_query_stream(g.n, 14, seed=0, top_k=8)
    kw = dict(slots=3, threshold=PARITY_THRESH, handle_dangling=handle_dangling)
    ref = RefPPREngine(g, backend="jax", **kw).drain(
        [RefPPRQuery(q.qid, q.seeds, q.top_k) for q in qs])
    got = engine(port(g), "torch", **kw).drain(qs)
    assert [r.qid for r in got] == [r.qid for r in ref]
    for a, b in zip(ref, got):
        assert b.iterations == a.iterations and b.warm_start == a.warm_start
        assert b.seeds == a.seeds
        np.testing.assert_array_equal(b.indices, a.indices)
        assert np.abs(b.values - a.values).max() <= 1e-6


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_mixed_batch_matches_oracle(backend, handle_dangling):
    g = rmat_graph(8, avg_degree=6, seed=7)
    eng = engine(g, backend, slots=3, threshold=1e-7,
                 handle_dangling=handle_dangling)
    k = 8
    seed_sets = [(3,), (10, 11), (), (5,), (42, 7, 9)]  # > slots: recycling
    before = launch_counts()
    responses = eng.drain([PPRQuery(qid=i, seeds=s, top_k=k)
                           for i, s in enumerate(seed_sets)])
    assert launch_counts() == before  # the CPU runs the plain version
    assert sorted(r.qid for r in responses) == list(range(len(seed_sets)))
    for r in responses:
        _oracle_band_check(g, r, k, handle_dangling)


def test_kernel_backend_weighted_biased_matches_oracle():
    g = port(GRAPHS["rmat_weighted"][0]())
    eng = engine(g, "cuda", slots=2, threshold=1e-7)
    for r in eng.drain([PPRQuery(qid=i, seeds=s, top_k=6)
                        for i, s in enumerate([(3,), (), (8, 9)])]):
        _oracle_band_check(g, r, 6)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_warm_start_reuses_cached_vector(backend):
    g = rmat_graph(8, avg_degree=6, seed=7)
    eng = engine(g, backend, slots=2, threshold=1e-7)
    cold = eng.drain([PPRQuery(qid=0, seeds=(3,), top_k=5)])[0]
    warm = eng.drain([PPRQuery(qid=1, seeds=(3, 3), top_k=5)])[0]
    assert not cold.warm_start and warm.warm_start
    assert eng.warm_hits == 1
    assert warm.iterations <= eng.iters_per_step < cold.iterations
    assert warm.indices.tolist() == cold.indices.tolist()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_rejects_when_full_then_recycles(backend):
    g = rmat_graph(7, avg_degree=5, seed=1)
    eng = engine(g, backend, slots=1, threshold=1e-6)
    assert eng.submit(PPRQuery(qid=0, seeds=(2,)))
    assert not eng.submit(PPRQuery(qid=1, seeds=(4,)))  # batch full
    assert eng.submit_rejections == 1
    done = []
    for _ in range(10_000):
        done += eng.step()
        if done:
            break
    assert done and done[0].qid == 0
    assert eng.slot_occupancy == 1.0
    assert eng.submit(PPRQuery(qid=1, seeds=(4,)))  # slot recycled


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_per_slot_early_exit(backend):
    """A dangling-seed query (its mass leaves at once) is harvested while
    a uniform query is still iterating: per-slot exit, not batch exit."""
    g = rmat_graph(8, avg_degree=6, seed=7)
    sinks = np.flatnonzero(g.out_degree == 0)
    assert sinks.size
    eng = engine(g, backend, slots=2, threshold=1e-8, iters_per_step=2)
    assert eng.submit(PPRQuery(qid=0, seeds=(int(sinks[0]),), top_k=3))
    assert eng.submit(PPRQuery(qid=1, seeds=(), top_k=3))
    first = []
    while not first:
        first = eng.step()
    assert [r.qid for r in first] == [0]  # easy row exits first
    assert eng.active_count == 1  # hard row still resident
    rest = eng.drain([])
    assert [r.qid for r in rest] == [1]
    assert 0.5 < eng.slot_occupancy < 1.0


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_step_with_no_pass_keeps_the_query(backend):
    """``iters_per_step=0`` runs no pass: every row's error stays ``inf``,
    so ``step`` answers nothing and the query stays active, as in the
    reference (its loop returns the initial all-``inf`` carry)."""
    g = rmat_graph(6, avg_degree=4, seed=0)
    eng = engine(g, backend, slots=2, iters_per_step=0)
    ref = RefPPREngine(g, slots=2, iters_per_step=0, backend="jax")
    for e, query in ((eng, PPRQuery), (ref, RefPPRQuery)):
        assert e.submit(query(qid=0, seeds=(3,), top_k=3))
        assert e.step() == [] and e.step() == []
        assert e.active_count == 1


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_reset_clears_warm_cache(backend):
    g = rmat_graph(7, avg_degree=5, seed=1)
    eng = engine(g, backend, slots=2, threshold=1e-6)
    eng.drain([PPRQuery(qid=0, seeds=(2,))])
    assert eng._cache
    eng.reset()
    assert not eng._cache and eng.warm_hits == 0 and eng.slot_occupancy == 0.0
    again = eng.drain([PPRQuery(qid=1, seeds=(2,))])[0]
    assert not again.warm_start  # measured run starts cold
    assert eng.submit(PPRQuery(qid=2, seeds=(3,)))
    with pytest.raises(RuntimeError, match="active"):
        eng.reset()


def test_engine_rejects_unknown_backend_empty_graph_and_later_slices():
    g = rmat_graph(6, avg_degree=4, seed=0)
    for bad in ("jax", "pallas", "triton"):
        with pytest.raises(ValueError, match="backend"):
            PPREngine(g, backend=bad, device=CPU)
    empty = Graph.from_edges(0, np.zeros(0, np.int32), np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="empty"):
        PPREngine(empty, device=CPU)
    with pytest.raises(NotImplementedError, match="not ported"):
        PPREngine(g, mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="not ported"):
        PPREngine(g, device=CPU).apply_updates(adds=[(0, 1)])
    with pytest.raises(TypeError):
        PPREngine(g, backend="torch", block=64, device=CPU)


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = rmat_graph(6, avg_degree=4, seed=0)
    for backend in sorted(BACKENDS):
        with pytest.raises(RuntimeError, match="CUDA"):
            PPREngine(g, backend=backend)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_malformed_query_cannot_poison_the_batch(backend):
    g = rmat_graph(7, avg_degree=5, seed=1)
    eng = engine(g, backend, slots=2, threshold=1e-6)
    bad = PPRQuery(qid=9, seeds=(g.n + 5,))
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(bad)
    assert eng.active_count == 0  # no half-allocated slot
    with pytest.raises(ValueError, match="out of range"):
        eng.drain([PPRQuery(qid=0, seeds=(2,)), bad])
    assert eng.active_count == 0  # nothing started before validation
    resp = eng.drain([PPRQuery(qid=0, seeds=(2,))])  # engine still healthy
    assert [r.qid for r in resp] == [0]
