"""The port's serving runtime, load generator and metrics
(``repro_torch.serving.{runtime,loadgen,metrics}``) and the launcher's
``serve`` subcommand, on the CPU, against the JAX reference.

Every scenario of ``tests/test_serving.py`` (admission and backpressure,
deadlines, the result cache and its invalidation contract — the stale-
answer regression, transitive invalidation on a connected graph, deletion
through the old graph's reachability, the whole cache under dangling
redistribution, the global entry — callback replacement, the engine's
counters, the load generator and the closed loop with mid-stream updates
on a ``VirtualClock``) runs on both packages, the reference's engine on
its ``jax`` backend and the port's on its ``torch`` backend, and must
give the same statuses, counters and cache keys; answers re-solved after
an update must match the float64 oracle of the updated graph.  The two
mesh tests of the engine are in tests/test_torch_serving.py; here the
runtime reports the mesh's size and ``serve --mesh-shards`` runs.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core.dynamic import make_update_injector as ref_make_update_injector
from repro.graphs import Graph as RefGraph
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.serving import loadgen as ref_loadgen
from repro.serving import runtime as ref_runtime
from repro.serving.metrics import ServingMetrics as RefServingMetrics
from repro.serving.ppr_engine import PPREngine as RefPPREngine
from repro.serving.ppr_engine import PPRQuery as RefPPRQuery
from repro.serving.ppr_engine import make_query_stream as ref_make_query_stream
from repro_torch.core.dynamic import make_update_injector, random_update_batch
from repro_torch.graphs import graph_from_arrays, make_dataset
from repro_torch.launch import pagerank_run
from repro_torch.ppr import ppr_numpy, teleport_from_seeds
from repro_torch.serving import (
    PPREngine,
    PPRQuery,
    ServingMetrics,
    ServingRuntime,
    loadgen,
    make_query_stream,
    runtime,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


class Pkg:
    """One package's serving API over a graph given in the reference's
    ``Graph`` (converted for the port)."""

    def __init__(self, name):
        self.name = name
        ref = name == "ref"
        self.Query = RefPPRQuery if ref else PPRQuery
        self.Runtime = ref_runtime.ServingRuntime if ref else ServingRuntime
        self.lg = ref_loadgen if ref else loadgen
        self.injector = ref_make_update_injector if ref else make_update_injector
        self.query_stream = ref_make_query_stream if ref else make_query_stream

    def engine(self, g, **kw):
        kw.setdefault("slots", 4)
        kw.setdefault("threshold", 1e-7)
        if self.name == "ref":
            return RefPPREngine(g, backend="jax", **kw)
        return PPREngine(port(g), backend="torch", device=CPU, **kw)


PKGS = [Pkg("ref"), Pkg("port")]


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages; the outcomes must be
    equal.  Returns the port's outcome."""
    ref, got = (scenario(p, *args) for p in PKGS)
    assert got == ref
    return got


def g64():
    return ref_rmat_graph(6, avg_degree=6, seed=3)


def _two_community_graph(n=128):
    """Two disconnected rings: an update in community B must not
    invalidate community A's cached answer (disjoint weak components)."""
    half = n // 2
    src = np.concatenate([np.arange(half), np.arange(half, n)])
    dst = np.concatenate([(np.arange(half) + 1) % half,
                          half + (np.arange(half) + 1) % half])
    return RefGraph.from_edges(n, src, dst)


def _drain(rt):
    out = []
    while rt.pending:
        out += rt.pump()
    return out


def _assert_matches_oracle(rt, fresh, seeds, k=8):
    """A re-solved answer is the float64 oracle's on the current graph."""
    g = rt.engine.g
    ref = ppr_numpy(g, teleport_from_seeds([seeds], g.n), threshold=1e-12,
                    handle_dangling=rt.engine.handle_dangling)[0][0]
    kth = np.sort(ref)[::-1][k - 1]
    assert (ref[fresh.indices] >= kth - 1e-6).all()
    assert np.abs(fresh.values - ref[fresh.indices]).max() < 1e-5


# ---------------------------------------------------------------------------
# admission queue: backpressure, deadlines
# ---------------------------------------------------------------------------


def _queue_full(pkg):
    rt = pkg.Runtime(pkg.engine(g64()), queue_depth=2)
    outcomes = [rt.offer(pkg.Query(qid=i, seeds=(i,))).status for i in range(4)]
    counts = (rt.metrics.count("rejected"), rt.metrics.count("offered"))
    _drain(rt)
    again = rt.offer(pkg.Query(qid=9, seeds=(9,))).status
    return outcomes, counts, again


def test_queue_full_rejects():
    outcomes, counts, again = both(_queue_full)
    assert outcomes == ["queued", "queued", "rejected", "rejected"]
    assert counts == (2, 4) and again == "queued"


def _deadline(pkg):
    vc = pkg.lg.VirtualClock()
    rt = pkg.Runtime(pkg.engine(g64()), deadline_s=0.5, clock=vc.now)
    rt.offer(pkg.Query(qid=0, seeds=(1,)))
    vc.advance(1.0)  # waited past its deadline before any slot freed
    first = rt.pump()
    expired, pending = rt.metrics.count("expired"), rt.pending
    rt.offer(pkg.Query(qid=1, seeds=(1,)))
    return len(first), expired, pending, [r.qid for r in _drain(rt)]


def test_deadline_expires_instead_of_solving():
    assert both(_deadline) == (0, 1, 0, [1])


# ---------------------------------------------------------------------------
# result cache: hits, evictions, and the stale-answer regression
# ---------------------------------------------------------------------------


def _cache_hit_and_eviction(pkg):
    rt = pkg.Runtime(pkg.engine(g64()), result_cache_size=2)
    first = rt.serve([pkg.Query(qid=i, seeds=(i,), top_k=5) for i in range(3)])
    evictions, length = rt.metrics.count("cache_evictions"), rt.result_cache_len
    statuses = {}
    for i in range(3):
        adm = rt.offer(pkg.Query(qid=10 + i, seeds=(i,), top_k=5))
        statuses[i] = adm.status
        if adm.status == "cached":
            assert adm.response.cached and adm.response.iterations == 0
            assert not adm.response.warm_start
            ref = next(r for r in first if r.seeds == (i,))
            np.testing.assert_array_equal(adm.response.indices, ref.indices)
            np.testing.assert_array_equal(adm.response.values, ref.values)
    return evictions, length, statuses, rt.metrics.count("cache_hits")


def test_result_cache_hit_and_eviction():
    evictions, length, statuses, hits = both(_cache_hit_and_eviction)
    assert (evictions, length, hits) == (1, 2, 2)
    assert sorted(statuses.values()) == ["cached", "cached", "queued"]


def _stale_never_served(pkg):
    rt = pkg.Runtime(pkg.engine(_two_community_graph()))
    rt.serve([pkg.Query(qid=0, seeds=(5,), top_k=8),
              pkg.Query(qid=1, seeds=(70,), top_k=8)])
    before = rt.result_cache_len
    delta, _ = rt.apply_updates(adds=np.array([[70, 90]]))
    inval = rt.metrics.count("cache_invalidations")
    kept = rt.offer(pkg.Query(qid=2, seeds=(5,), top_k=8)).status
    adm = rt.offer(pkg.Query(qid=3, seeds=(70,), top_k=8))
    (fresh,) = [r for r in _drain(rt) if r.qid == 3]
    assert not fresh.cached
    if pkg.name == "port":
        _assert_matches_oracle(rt, fresh, (70,))
    return before, delta.num_ops, inval, kept, adm.status, list(rt._results)


def test_stale_cached_topk_never_served_after_update():
    before, ops, inval, kept, status, keys = both(_stale_never_served)
    assert (before, ops, inval) == (2, 1, 1)
    assert kept == "cached" and status == "queued"
    assert keys == [((5,), 8), ((70,), 8)]


def _transitive(pkg):
    n, block = 128, 64
    g = RefGraph.from_edges(n, np.arange(n), (np.arange(n) + 1) % n)
    rt = pkg.Runtime(pkg.engine(g))
    rt.serve([pkg.Query(qid=0, seeds=(5,), top_k=8)])
    before = rt.result_cache_len
    delta, _ = rt.apply_updates(adds=np.array([[70, 90]]))
    # both endpoints in block 1, the entry's seeds and answers in block 0:
    # a dst-block intersection test would keep the entry
    assert not set(np.r_[delta.touched_src, delta.touched_dst] // block) & {0}
    inval = rt.metrics.count("cache_invalidations")
    status = rt.offer(pkg.Query(qid=1, seeds=(5,), top_k=8)).status
    (fresh,) = [r for r in _drain(rt) if r.qid == 1]
    assert not fresh.cached
    if pkg.name == "port":
        _assert_matches_oracle(rt, fresh, (5,))
    return before, inval, status


def test_connected_graph_invalidates_transitively():
    assert both(_transitive) == (1, 1, "queued")


def _deletion_through_old_graph(pkg):
    n, half = 64, 32
    src = np.r_[np.arange(half), [5, 40]]
    dst = np.r_[(np.arange(half) + 1) % half, [40, 41]]
    rt = pkg.Runtime(pkg.engine(RefGraph.from_edges(n, src, dst)))
    rt.serve([pkg.Query(qid=0, seeds=(5,), top_k=8)])
    rt.apply_updates(dels=np.array([[5, 40]]))
    return (rt.metrics.count("cache_invalidations"),
            rt.offer(pkg.Query(qid=1, seeds=(5,), top_k=8)).status)


def test_deletion_invalidates_through_old_graph_reachability():
    assert both(_deletion_through_old_graph) == (1, "queued")


def _dangling_drops_all(pkg):
    g2 = _two_community_graph()
    g = RefGraph.from_edges(g2.n + 1, g2.src, g2.dst)  # one dangling vertex
    rt = pkg.Runtime(pkg.engine(g, handle_dangling=True))
    out = rt.serve([pkg.Query(qid=0, seeds=(5,), top_k=8),
                    pkg.Query(qid=1, seeds=(70,), top_k=8)])
    if pkg.name == "port":
        for r in out:
            _assert_matches_oracle(rt, r, r.seeds)
    rt.apply_updates(adds=np.array([[70, 90]]))
    return (rt.metrics.count("cache_invalidations"), rt.result_cache_len,
            rt.offer(pkg.Query(qid=2, seeds=(5,), top_k=8)).status)


def test_handle_dangling_drops_whole_cache():
    assert both(_dangling_drops_all) == (2, 0, "queued")


def _callbacks(pkg):
    eng = pkg.engine(g64())
    rt1 = pkg.Runtime(eng)
    one = eng.update_callbacks == [rt1._invalidate]
    rt2 = pkg.Runtime(eng)
    two = eng.update_callbacks == [rt2._invalidate]
    rt2.close()
    closed = eng.update_callbacks == []
    rt2.close()  # idempotent
    return one, two, closed


def test_runtime_replaces_and_closes_update_callback():
    assert both(_callbacks) == (True, True, True)


def _global_entry(pkg):
    rt = pkg.Runtime(pkg.engine(_two_community_graph()))
    rt.serve([pkg.Query(qid=0, seeds=(), top_k=8)])
    rt.apply_updates(adds=np.array([[70, 90]]))
    return rt.offer(pkg.Query(qid=1, seeds=(), top_k=8)).status


def test_global_entry_invalidated_by_any_update():
    assert both(_global_entry) == "queued"


@pytest.mark.parametrize("scale,seed", [(6, 0), (9, 4)])
def test_weak_components_equal_reference(scale, seed):
    g = ref_rmat_graph(scale, avg_degree=2, seed=seed)
    np.testing.assert_array_equal(
        runtime._weak_components(g.n, g.src, g.dst),
        ref_runtime._weak_components(g.n, g.src, g.dst))


# ---------------------------------------------------------------------------
# engine counters
# ---------------------------------------------------------------------------


def _engine_counters(pkg):
    eng = pkg.engine(g64(), slots=2)
    subs = [eng.submit(pkg.Query(qid=i, seeds=(i + 1,))) for i in range(3)]
    eng.step()
    full = eng.slot_occupancy
    while eng.active_count:
        eng.step()
    return subs, eng.submit_rejections, full, eng.slot_occupancy


def test_engine_submit_rejections_and_occupancy():
    subs, rejections, full, occ = both(_engine_counters)
    assert subs == [True, True, False] and rejections == 1
    assert full == 1.0 and 0.0 < occ <= 1.0


# ---------------------------------------------------------------------------
# load generator and metrics
# ---------------------------------------------------------------------------


def test_percentile_empty_is_none():
    for lg in (loadgen, ref_loadgen):
        assert lg._percentile(np.asarray([]), 99) is None
        assert lg._percentile(np.asarray([5.0]), 99) == 5.0


@pytest.mark.parametrize("n,alpha", [(100, 1.1), (10, 0.0), (1, 2.0)])
def test_zipf_weights_equal_reference(n, alpha):
    w = loadgen.zipf_weights(n, alpha)
    np.testing.assert_array_equal(w, ref_loadgen.zipf_weights(n, alpha))
    assert w.shape == (n,) and abs(w.sum() - 1.0) < 1e-12
    assert (np.diff(w) <= 0).all()
    with pytest.raises(ValueError):
        loadgen.zipf_weights(0, alpha)


@pytest.mark.parametrize("kw", [
    dict(queries=200, qps=10.0, zipf_alpha=1.5, seed=4),
    dict(queries=200, qps=10.0, zipf_alpha=0.0, seed=4),
    dict(queries=50, qps=3.0, arrival="uniform", working_set=7, seed=1),
])
def test_make_workload_equals_reference(kw):
    q, a = loadgen.make_workload(1024, loadgen.LoadConfig(**kw))
    rq, ra = ref_loadgen.make_workload(1024, ref_loadgen.LoadConfig(**kw))
    assert [(x.qid, x.seeds, x.top_k) for x in q] == \
        [(x.qid, x.seeds, x.top_k) for x in rq]
    np.testing.assert_array_equal(a, ra)
    assert a[0] == 0.0 and (np.diff(a) >= 0).all()
    if kw.get("zipf_alpha", 0) > 1:  # heavy-tailed: a small hot set is reused
        single = [x.seeds[0] for x in q if len(x.seeds) == 1]
        assert len(set(single)) < len(single) / 2


@pytest.mark.parametrize("kw,match", [
    (dict(queries=0), "query"), (dict(qps=0.0), "qps"),
    (dict(arrival="bursty"), "arrival")])
def test_make_workload_errors_are_the_references(kw, match):
    for lg in (loadgen, ref_loadgen):
        with pytest.raises(ValueError, match=match):
            lg.make_workload(64, lg.LoadConfig(**kw))


def test_metrics_equal_reference():
    bags = []
    for cls in (ServingMetrics, RefServingMetrics):
        m = cls()
        m.incr("offered", 3)
        m.incr("completed")
        m.timers["solve"].add(0.5)
        m.timers["solve"].add(0.25)
        m.gauges["queue_depth"].sample(4)
        m.gauges["queue_depth"].sample(2)
        bags.append((m.to_dict(), m.summary(), m.count("offered"), m.count("x")))
    assert bags[0] == bags[1]


def _closed_loop(pkg, qps, queries=30):
    vc = pkg.lg.VirtualClock()
    rt = pkg.Runtime(pkg.engine(g64(), slots=2), queue_depth=4, clock=vc.now)
    qs, arr = pkg.lg.make_workload(
        64, pkg.lg.LoadConfig(queries=queries, qps=qps, seed=0))
    return pkg.lg.run_closed_loop(rt, qs, arr, clock=vc,
                                  step_cost_s=0.05).to_dict()


def test_closed_loop_saturates_and_sustains():
    low = both(_closed_loop, 1.0)
    assert low["rejected"] == 0 and low["completed"] == low["offered"]
    assert low["achieved_qps"] >= 0.9 * low["offered_qps"]
    high = both(_closed_loop, 200.0)
    assert high["rejected"] > 0  # backpressure engaged
    assert high["completed"] + high["rejected"] + high["expired"] == high["offered"]
    assert high["achieved_qps"] < high["offered_qps"]
    assert high["queue_depth_max"] >= low["queue_depth_max"]


def _midstream(pkg):
    vc = pkg.lg.VirtualClock()
    rt = pkg.Runtime(pkg.engine(g64()), queue_depth=32, clock=vc.now)
    cfg = pkg.lg.LoadConfig(queries=24, qps=50.0, repeat_fraction=0.5, seed=2)
    qs, arr = pkg.lg.make_workload(64, cfg)
    rep = pkg.lg.run_closed_loop(
        rt, qs, arr, clock=vc, step_cost_s=0.01,
        update_injector=pkg.injector(np.random.default_rng(0), 8),
        update_at=(8, 16)).to_dict()
    g = rt.engine.g
    return rep, list(rt._results), (g.src.tolist(), g.dst.tolist())


def test_closed_loop_midstream_updates():
    rep, keys, _ = both(_midstream)
    assert rep["update_batches"] == 2
    assert rep["completed"] + rep["rejected"] + rep["expired"] == rep["offered"] == 24
    assert rep["completed"] > 0 and rep["p99_ms"] is not None
    assert rep["cache_invalidations"] > 0 and keys


def _stats(pkg):
    rt = pkg.Runtime(pkg.engine(g64()))
    rt.serve(pkg.query_stream(64, 4, seed=0))
    s = rt.stats()
    return (sorted(s), s["counters"], s["mesh_shards"], s["backend"] != "",
            s["timers"]["solve"]["count"] > 0)


def test_runtime_stats_report_the_mesh_size():
    from repro_torch.core import ShardMesh

    eng = PPREngine(port(g64()), slots=4, threshold=1e-7, device=CPU,
                    mesh=ShardMesh((torch.device(CPU),) * 4))
    rt = ServingRuntime(eng)
    assert len(rt.serve(make_query_stream(64, 4, seed=0))) == 4
    assert rt.stats()["mesh_shards"] == 4


def test_runtime_stats_shape():
    keys, counters, shards, _, solved = both(_stats)
    for key in ("backend", "slots", "mesh_shards", "queue_depth_limit",
                "result_cache", "warm_hits", "submit_rejections",
                "slot_occupancy", "counters", "timers", "gauges"):
        assert key in keys, key
    assert counters["completed"] == 4 and shards == 1 and solved


# ---------------------------------------------------------------------------
# pagerank_run serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("qps", [0.0, 40.0], ids=["drain", "closed_loop"])
def test_serve_with_updates_answers_each_graph_version(backend, qps, capsys):
    rep = pagerank_run.run([
        "serve", "--device", "cpu", "--backend", backend, "--scale-down", "256",
        "--queries", "16", "--updates", "40", "--update-batches", "2",
        "--qps", str(qps), "--threshold", "1e-7"])
    out = capsys.readouterr().out
    assert ("achieved" in out) == (qps > 0) and "slots: occupancy=" in out
    # the graph of each version, from the launcher's seeded update stream
    graphs = [make_dataset("webStanford", scale_down=256)]
    rng = np.random.default_rng(0)
    for _ in range(2):
        adds, dels = random_update_batch(graphs[-1], rng, 20)
        graphs.append(graphs[-1].apply_updates(adds=adds, dels=dels)[0])
    assert rep["applied"] == 40
    assert (rep["n"], rep["m"]) == (graphs[-1].n, graphs[-1].m)
    assert len(rep["responses"]) == 16 == len(rep["versions"])
    assert max(rep["versions"]) == 2 and rep["invalidations"] > 0
    assert len(rep["launches"]) == 3  # on the CPU no kernel launches
    assert all(n == 0 for c in rep["launches"] for n in c.values())
    for v, r in zip(rep["versions"], rep["responses"]):
        gv = graphs[v]
        ref = ppr_numpy(gv, teleport_from_seeds([r.seeds], gv.n),
                        threshold=1e-12)[0][0]
        kth = np.sort(ref)[::-1][len(r.indices) - 1]
        assert (ref[r.indices] >= kth - 1e-6).all(), (v, r.seeds)
        assert np.abs(r.values - ref[r.indices]).max() < 1e-5


def test_serve_mesh_and_default_device():
    rep = pagerank_run.run(["serve", "--mesh-shards", "1", "--device", "cpu",
                            "--scale-down", "2048", "--queries", "4"])
    assert rep["stats"]["mesh_shards"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pagerank_run.run(["serve", "--scale-down", "2048"])
