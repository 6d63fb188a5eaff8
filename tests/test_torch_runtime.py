"""The port's fault-tolerance runtime (``repro_torch.core.runtime``) and
``bundle_partitions`` on the CPU, against the JAX reference's
``repro.core.runtime`` and ``repro.core.solver``.

* ``simulate``: every discipline under no fault, a sleeping worker, and a
  failure, on the reference's own test graph at p = 4 and a second graph
  at p = 8: iterations, ``sim_time`` and ``work_done`` equal, ranks within
  1e-12 in L1 (both sweep in float64 and add each vertex's in-edges in
  edge order, so they come out equal).
* ``simulate_jittered`` bit for bit, with the same ``ValueError``s;
  ``partition_sweep_costs`` and ``Graph.partition_ranges`` equal.
* ``SolverCheckpoint`` files read across the packages; ``reshard`` equal.
* The reference's qualitative tests (tests/test_distributed.py, Fig 8/9,
  and the stale-sweep tests of tests/test_adaptive.py) against the port.
* The reference's sweep reads only the edge mask, so on a weighted or
  biased graph it solves the unweighted graph: its ranks are 0.35
  (weighted) and 0.04 (biased) from the weighted oracle in L1 here.  The
  port raises ``ValueError`` on such a graph instead.
* ``bundle_partitions`` of every registered variant's bundle equals the
  reference's (``blocked*`` for ``pallas*``, ``ppr_blocked`` for
  ``ppr_pallas``).
"""
import numpy as np
import pytest

from repro.core import PartitionedGraph as RefPartitionedGraph
from repro.core import pagerank_numpy as ref_pagerank_numpy
from repro.core.runtime import FaultPlan as RefFaultPlan
from repro.core.runtime import SolverCheckpoint as RefSolverCheckpoint
from repro.core.runtime import partition_sweep_costs as ref_partition_sweep_costs
from repro.core.runtime import simulate as ref_simulate
from repro.core.runtime import simulate_jittered as ref_simulate_jittered
from repro.core.solver import build_variant as ref_build_variant
from repro.core.solver import bundle_partitions as ref_bundle_partitions
from repro.graphs import Graph as RefGraph
from repro.graphs import rmat_graph as ref_rmat_graph
from repro_torch.core import (
    FaultPlan,
    PartitionedGraph,
    SolverCheckpoint,
    bundle_partitions,
    build_variant,
    l1_norm,
    list_variants,
    pagerank_numpy,
    partition_sweep_costs,
    simulate,
    simulate_jittered,
)
from repro_torch.graphs import graph_from_arrays, rmat_graph

DISCIPLINES = ("barrier", "nosync", "waitfree")
PLANS = {
    "none": {},
    "sleeps": {"sleeps": {(0, it): 5.0 for it in range(1, 200)}},
    "failure 1 at 2": {"failures": {1: 2}},
    "failure 0 at 1": {"failures": {0: 1}},
}
GRAPHS = {"rmat8 p4": ((8, 5, 7), 4), "rmat9 p8": ((9, 6, 1), 8)}


def port_graph(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             weights=g.weights, bias=g.bias)


_PAIRS = {}


def pairs(key):
    """``(reference graph, its PartitionedGraph, the port's)`` of GRAPHS[key]."""
    if key not in _PAIRS:
        (scale, deg, seed), p = GRAPHS[key]
        g = ref_rmat_graph(scale, avg_degree=deg, seed=seed)
        _PAIRS[key] = (g, RefPartitionedGraph.from_graph(g, p=p),
                       PartitionedGraph.from_graph(port_graph(g), p=p, device="cpu"))
    return _PAIRS[key]


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("discipline", DISCIPLINES)
def test_simulate_equals_the_references(discipline, plan, graph):
    _, ref_pg, pg = pairs(graph)
    kw = dict(threshold=1e-8)
    if discipline == "barrier" and "failures" in PLANS[plan]:
        kw["max_iter"] = 50  # a failure deadlocks the barrier
    want = ref_simulate(ref_pg, discipline, RefFaultPlan(**PLANS[plan]), **kw)
    got = simulate(pg, discipline, FaultPlan(**PLANS[plan]), **kw)
    assert got.iterations == want.iterations
    assert got.sim_time == want.sim_time
    assert got.work_done == want.work_done
    assert got.pr.dtype == np.float64 and got.pr.shape == (pg.n,)
    assert l1_norm(got.pr, want.pr) <= 1e-12


def test_simulate_rejects_an_unknown_discipline():
    _, ref_pg, pg = pairs("rmat8 p4")
    with pytest.raises(ValueError, match="quantum"):
        ref_simulate(ref_pg, "quantum")
    with pytest.raises(ValueError, match="quantum"):
        simulate(pg, "quantum")


@pytest.mark.parametrize("field", ("weights", "bias"))
def test_the_references_sweep_drops_weights_and_bias_and_the_port_refuses(field):
    g = ref_rmat_graph(8, avg_degree=5, seed=7)
    plain, _ = ref_pagerank_numpy(g, threshold=1e-13)
    rng = np.random.default_rng(0)
    if field == "weights":
        g.weights = 1.0 - rng.random(g.m)
    else:
        g.bias = rng.uniform(0.5, 1.5, g.n)
    oracle, _ = ref_pagerank_numpy(g, threshold=1e-13)
    ref = ref_simulate(RefPartitionedGraph.from_graph(g, p=4), "barrier",
                       threshold=1e-10)
    # the reference solves the graph without the field: it lands on the
    # plain graph's ranks, far from the weighted oracle
    assert l1_norm(ref.pr, plain) < 1e-6
    assert l1_norm(ref.pr, oracle) > 1e-2
    pg = PartitionedGraph.from_graph(port_graph(g), p=4, device="cpu")
    with pytest.raises(ValueError, match="weighted or biased"):
        simulate(pg, "barrier")


JITTER_KW = {
    "plain": {},
    "rel_costs": {"rel_costs": "costs"},
    "active mask": {"active": "mask"},
    "active rate": {"active": 0.6},
    "stalls": {"stall_prob": 0.15, "stall_dur": 6.0},
    "all": {"rel_costs": "costs", "active": 0.6, "stall_prob": 0.2,
            "stall_dur": 3.0, "sigma": 0.5},
}


@pytest.mark.parametrize("kw", JITTER_KW)
@pytest.mark.parametrize("discipline",
                         ("sequential", "barrier", "nosync", "adaptive", "waitfree"))
def test_simulate_jittered_is_the_references_bit_for_bit(discipline, kw):
    g, ref_pg, pg = pairs("rmat9 p8")
    iters = 60
    args = dict(JITTER_KW[kw])
    if args.get("rel_costs") == "costs":
        args["rel_costs"] = ref_partition_sweep_costs(g, pg.p)
    if args.get("active") == "mask":
        args["active"] = np.random.default_rng(4).random((iters, pg.p)) < 0.5
    for seed in (0, 5):
        want = ref_simulate_jittered(ref_pg, discipline, iters, seed=seed, **args)
        got = simulate_jittered(pg, discipline, iters, seed=seed, **args)
        assert got == want and isinstance(got, float)


@pytest.mark.parametrize("kw,match", [
    ({"active": 0.0}, "rate"), ({"active": 1.5}, "rate"),
    ({"active": np.ones((3, 8), dtype=bool)}, "shape"),
    ({"rel_costs": np.ones(3)}, "rel_costs"), ({"discipline": "quantum"}, "quantum")])
def test_simulate_jittered_raises_as_the_reference(kw, match):
    _, ref_pg, pg = pairs("rmat9 p8")
    kw = dict(kw)
    discipline = kw.pop("discipline", "adaptive")
    for fn, bundle in ((ref_simulate_jittered, ref_pg), (simulate_jittered, pg)):
        with pytest.raises(ValueError, match=match):
            fn(bundle, discipline, 10, **kw)


@pytest.mark.parametrize("edge_balanced", (False, True))
@pytest.mark.parametrize("p", (1, 3, 8, 56))
def test_partition_ranges_and_sweep_costs_equal(p, edge_balanced):
    for g in (ref_rmat_graph(9, avg_degree=6, seed=1),
              RefGraph.from_edges(5, np.array([0, 1, 2]), np.array([1, 1, 4]))):
        t = port_graph(g)
        assert np.array_equal(t.partition_ranges(p, edge_balanced),
                              g.partition_ranges(p, edge_balanced))
        got = partition_sweep_costs(t, p, edge_balanced)
        want = ref_partition_sweep_costs(g, p, edge_balanced)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_checkpoint_files_read_across_packages(tmp_path, writer):
    pr = np.random.default_rng(2).random(37)
    path = str(tmp_path / "ck")
    if writer == "reference":
        RefSolverCheckpoint(pr=pr, round=12, n=37, p=4).save(path)
        ck = SolverCheckpoint.load(path)
        other = RefSolverCheckpoint.load(path + ".npz")
    else:
        SolverCheckpoint(pr=pr, round=12, n=37, p=4).save(path)
        ck = RefSolverCheckpoint.load(path)
        other = SolverCheckpoint.load(path + ".npz")
    for c in (ck, other):
        assert (c.round, c.n, c.p) == (12, 37, 4) and np.array_equal(c.pr, pr)
    for new_p in (1, 5, 8):
        a = SolverCheckpoint(pr=pr, round=12, n=37, p=4).reshard(new_p)
        b = RefSolverCheckpoint(pr=pr, round=12, n=37, p=4).reshard(new_p)
        assert (a.round, a.n, a.p) == (b.round, b.n, b.p) == (12, 37, new_p)
        assert a.pr.shape == b.pr.shape and np.array_equal(a.pr, b.pr)


def _ref_name(name: str) -> str:
    return name.replace("blocked", "pallas")


@pytest.mark.parametrize("name", list_variants())
def test_bundle_partitions_equal_the_references(name):
    g = ref_rmat_graph(7, avg_degree=5, seed=3)
    _, ref_bundle = ref_build_variant(_ref_name(name), g, threads=4)
    _, bundle = build_variant(name, port_graph(g), threads=4, device="cpu")
    assert bundle_partitions(bundle) == ref_bundle_partitions(ref_bundle)
    want = 4 if name in ("nosync", "nosync_opt", "nosync_adaptive", "ppr_nosync") else 1
    assert bundle_partitions(bundle) == want


# The reference's qualitative tests of the simulator, against the port
# (tests/test_distributed.py, Fig 8/9).


@pytest.fixture(scope="module")
def pg():
    return PartitionedGraph.from_graph(rmat_graph(8, avg_degree=5, seed=7), p=4,
                                       device="cpu")


def test_sim_all_disciplines_converge_clean(pg):
    for d in DISCIPLINES:
        r = simulate(pg, d, threshold=1e-8)
        assert r.iterations < 1000, d


def test_sim_sleep_hurts_barrier_not_waitfree(pg):
    """Fig 8: barrier time grows with injected sleep; wait-free stays flat."""
    sleep = {(0, it): 5.0 for it in range(1, 200)}
    base_b = simulate(pg, "barrier", threshold=1e-8).sim_time
    slow_b = simulate(pg, "barrier", FaultPlan(sleeps=sleep), threshold=1e-8).sim_time
    slow_w = simulate(pg, "waitfree", FaultPlan(sleeps=sleep), threshold=1e-8).sim_time
    assert slow_b > base_b * 3
    assert slow_w < slow_b  # helping absorbs the sleeping partition
    slow_n = simulate(pg, "nosync", FaultPlan(sleeps=sleep), threshold=1e-8).sim_time
    assert slow_n <= slow_b


def test_sim_failure_only_waitfree_survives(pg):
    """Fig 9: with a failed thread, wait-free completes; barrier does not."""
    plan = FaultPlan(failures={1: 2})
    rw = simulate(pg, "waitfree", plan, threshold=1e-8)
    assert rw.iterations < 1000
    ref, _ = pagerank_numpy(rmat_graph(8, avg_degree=5, seed=7), threshold=1e-12)
    assert l1_norm(rw.pr, ref) < 1e-2
    rb = simulate(pg, "barrier", plan, threshold=1e-8, max_iter=50)
    assert rb.iterations == 50  # never converges


def test_sim_waitfree_work_stealing(pg):
    """Helpers adopt the failed worker's partition (paper's helping)."""
    r = simulate(pg, "waitfree", FaultPlan(failures={0: 1}), threshold=1e-8)
    assert r.work_done[0] == 0 or r.work_done[0] < r.iterations
    assert sum(r.work_done.values()) >= r.iterations * pg.p


# tests/test_adaptive.py's stale-sweep tests of simulate_jittered


@pytest.fixture(scope="module")
def sim_pg():
    rng = np.random.default_rng(3)
    g = RefGraph.from_edges(64, rng.integers(0, 64, 320), rng.integers(0, 64, 320))
    return PartitionedGraph.from_graph(port_graph(g), 8, device="cpu")


def test_sim_adaptive_sheds_skipped_sweeps(sim_pg):
    barrier = simulate_jittered(sim_pg, "barrier", 200, seed=5)
    nosync = simulate_jittered(sim_pg, "nosync", 200, seed=5)
    adaptive = simulate_jittered(sim_pg, "adaptive", 200, seed=5, active=0.6)
    assert adaptive < nosync <= barrier
    full = np.ones((200, sim_pg.p), dtype=bool)
    assert simulate_jittered(sim_pg, "adaptive", 200, seed=5, active=full) == nosync
    half = full.copy()
    half[::2, :] = False
    assert simulate_jittered(sim_pg, "adaptive", 200, seed=5, active=half) < nosync


def test_sim_stalls_hit_barrier_hardest(sim_pg):
    kw = dict(seed=7, stall_prob=0.15, stall_dur=6.0)
    barrier = simulate_jittered(sim_pg, "barrier", 200, **kw)
    nosync = simulate_jittered(sim_pg, "nosync", 200, **kw)
    adaptive = simulate_jittered(sim_pg, "adaptive", 200, active=0.6, **kw)
    assert adaptive < nosync < barrier
    assert nosync > simulate_jittered(sim_pg, "nosync", 200, seed=7)
    assert barrier == simulate_jittered(sim_pg, "barrier", 200, **kw)
