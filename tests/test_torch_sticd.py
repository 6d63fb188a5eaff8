"""The port's STIC-D plan stage against the JAX reference, on the CPU.

* ``Graph.chain_nodes``, ``source_chain_nodes`` and ``dead_nodes`` equal
  the reference's masks.
* ``DecompositionPlan.from_graph`` equals the reference's array for array
  over every combination of its four flags, on unweighted, weighted and
  weighted+biased inputs; ``stats()`` is the same dict; ``reconstruct`` of
  one ``core_pr`` is within 1e-12 (float64) of the reference's and raises
  the same errors.
* ``tests/test_decomposition.py`` and the plan tests of
  ``tests/test_weighted.py``, ported: the composed leg runs
  ``blocked_nosync`` and ``blocked_adaptive`` on the CPU twin of the CUDA
  kernels in place of ``pallas_nosync``.
* ``barrier_sticd`` and ``nosync_sticd`` against the reference's variants:
  L1 between the two ≤ 1e-5, iterations within 2 (the float32 core solves
  of the two packages may stop one pass apart: the weighted core's
  residual at the stop rule is within a few ulps of the threshold), the
  same errors.
* Warm starts: ``warm_start_pr`` is the reference's, ``TestWarmStart``
  ported with ``barrier_sticd`` among its variants, and a plan re-planned
  for another ``d``.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core.solver import solve_variant as ref_solve_variant
from repro.core.solver import warm_start_pr as ref_warm_start_pr
from repro.graphs import DecompositionPlan as RefPlan
from repro.graphs import make_dataset as ref_make_dataset
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.csr import Graph as RefGraph
from repro_torch.core.pagerank import l1_norm, pagerank_numpy
from repro_torch.core.solver import (
    PlannedBundle,
    build_variant,
    get_variant,
    plan_build,
    plan_run,
    plan_stats,
    solve_variant,
    warm_start_pr,
)
from repro_torch.graphs import DecompositionPlan, Graph, graph_from_arrays, make_dataset
from repro_torch.launch import pagerank_run
from test_decomposition import chain_sink_heavy_graph
from test_solver import SURROGATES
from test_weighted import chains_across_partitions_graph, random_weighted_graph

CPU = "cpu"
THRESH = 1e-9
D = 0.85
STICD = ("barrier_sticd", "nosync_sticd")
FLAGS = ("identical", "chains", "dead", "contract")
PLAN_FIELDS = ("core_index", "full_to_core", "struct_pruned", "chain_mask",
               "source_mask", "dead_mask", "ident_members", "ident_reps")
CORE_FIELDS = ("src", "dst", "weights", "bias", "out_degree", "in_ptr")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


def cycles_and_self_loops() -> RefGraph:
    """Pure cycles, self-loops, a chain into a sink, a source chain and a
    hub: every analysis has cases to find and to refuse."""
    edges = [(0, 1), (1, 2), (2, 0),          # pure 3-cycle
             (3, 3), (3, 4), (4, 5), (5, 6),  # self-loop head, chain to sink 6
             (7, 8), (8, 9), (9, 11),         # source chain into the hub
             (10, 10),                        # lone self-loop
             (11, 12), (12, 11), (11, 13), (13, 11)]  # hub, two 2-cycles
    src, dst = zip(*edges)
    return RefGraph.from_edges(14, np.asarray(src), np.asarray(dst))


def random_graph(seed: int) -> RefGraph:
    rng = np.random.default_rng(seed)
    n = 60
    m = 90  # sparse: chains, sinks and sources occur
    return RefGraph.from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m))


MASK_GRAPHS = {
    **SURROGATES,
    "cycles_self_loops": cycles_and_self_loops,
    "random_0": lambda: random_graph(0),
    "random_1": lambda: random_graph(1),
    "chain_sink_heavy": chain_sink_heavy_graph,
    "chains_across_partitions": chains_across_partitions_graph,
    "webStanford_512": lambda: ref_make_dataset("webStanford", scale_down=512),
}


def weighted_input(g: RefGraph, weighting: str, seed: int = 3) -> RefGraph:
    """``g`` unweighted, with weights in [0.3, 1), or also with biases in
    [0.5, 1.5)."""
    if weighting == "unweighted":
        return g
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.3, 1.0, g.m)
    bias = rng.uniform(0.5, 1.5, g.n) if weighting == "weighted_biased" else None
    return RefGraph.from_edges(g.n, g.src, g.dst, weights=w, bias=bias)


def assert_plans_equal(got: DecompositionPlan, ref) -> None:
    assert got.n == ref.n and got.d == ref.d
    assert got.contracted_m == ref.contracted_m
    assert got.d_dependent == ref.d_dependent
    for f in PLAN_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.core.n == ref.core.n
    for f in CORE_FIELDS:
        a, b = getattr(got.core, f), getattr(ref.core, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert got.stats() == ref.stats()
    np.testing.assert_array_equal(got.pruned, ref.pruned)


# ---------------------------------------------------------------------------
# the analyses and the plan, array for array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gname", sorted(MASK_GRAPHS))
def test_masks_match_reference(gname):
    g = MASK_GRAPHS[gname]()
    pg = port(g)
    for name in ("chain_nodes", "source_chain_nodes", "dead_nodes"):
        got, want = getattr(pg, name)(), getattr(g, name)()
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_masks_find_cycles_and_self_loops():
    g = port(cycles_and_self_loops())
    chain, dead = g.chain_nodes(), g.dead_nodes()
    assert np.flatnonzero(chain).tolist() == [4, 5, 8, 9, 12, 13]  # headed runs
    assert np.flatnonzero(g.source_chain_nodes()).tolist() == [7]
    assert np.flatnonzero(dead).tolist() == [4, 5, 6]


@pytest.mark.parametrize("weighting", ["unweighted", "weighted", "weighted_biased"])
@pytest.mark.parametrize("flags", range(16), ids=lambda f: "".join(
    name[0] if f >> i & 1 else "-" for i, name in enumerate(FLAGS)))
def test_plan_matches_reference(flags, weighting):
    g = weighted_input(ref_make_dataset("webStanford", scale_down=512), weighting)
    kw = {name: bool(flags >> i & 1) for i, name in enumerate(FLAGS)}
    assert_plans_equal(DecompositionPlan.from_graph(port(g), **kw),
                       RefPlan.from_graph(g, **kw))


@pytest.mark.parametrize("gname", ["chain_sink_heavy", "chains_across_partitions",
                                   "cycles_self_loops", "random_0"])
def test_plan_matches_reference_on_synthetic_graphs(gname):
    g = MASK_GRAPHS[gname]()
    for d in (0.85, 0.6):
        assert_plans_equal(DecompositionPlan.from_graph(port(g), d=d),
                           RefPlan.from_graph(g, d=d))


@pytest.mark.parametrize("weighting", ["unweighted", "weighted", "weighted_biased"])
def test_reconstruct_matches_reference(weighting):
    g = weighted_input(ref_make_dataset("webStanford", scale_down=512), weighting)
    ref = RefPlan.from_graph(g)
    got = DecompositionPlan.from_graph(port(g))
    core_pr = np.random.default_rng(4).uniform(0.5, 1.5, ref.core.n) / ref.core.n
    for hd in (False, True):
        if hd and weighting == "weighted_biased":
            continue
        a = got.reconstruct(core_pr, d=D, handle_dangling=hd)
        b = ref.reconstruct(core_pr, d=D, handle_dangling=hd)
        assert a.dtype == np.float64 and a.shape == (g.n,)
        assert np.abs(a - b).max() <= 1e-12


def test_reconstruct_raises_the_reference_errors():
    g = weighted_input(chains_across_partitions_graph(seed=13), "weighted_biased")
    ref = RefPlan.from_graph(g, d=0.85)
    got = DecompositionPlan.from_graph(port(g), d=0.85)
    cases = [(dict(core_pr=np.zeros(ref.core.n + 1)), "core_pr"),
             (dict(core_pr=np.zeros(ref.core.n), d=0.6), "re-plan"),
             (dict(core_pr=np.zeros(ref.core.n), handle_dangling=True), "uniform")]
    for kw, match in cases:
        for plan in (ref, got):
            with pytest.raises(ValueError, match=match):
                plan.reconstruct(**kw)


def test_core_keeps_full_out_degrees_and_parallel_edges():
    """The core's out-degrees are the full graph's, not its own src counts,
    and a contracted edge duplicating a kept edge stays a parallel edge."""
    # core {0, 1, 2}, 0→1 again through the chain 0→3→1, 2 leaks to sink 4
    edges = [(0, 1), (1, 2), (2, 0), (2, 1), (1, 0), (0, 3), (3, 1), (2, 4)]
    src, dst = zip(*edges)
    g = Graph.from_edges(5, np.asarray(src), np.asarray(dst))
    plan = DecompositionPlan.from_graph(g)
    core = plan.core
    assert plan.contracted_m == 1 and core.n == 3
    np.testing.assert_array_equal(core.out_degree, g.out_degree[plan.core_index])
    assert not np.array_equal(core.out_degree, np.bincount(core.src, minlength=core.n))
    pairs = list(zip(core.src.tolist(), core.dst.tolist()))
    assert pairs.count((0, 1)) == 2
    ref, _ = pagerank_numpy(g, threshold=1e-14)
    r = solve_variant("barrier_sticd", g, threshold=1e-10, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6


# ---------------------------------------------------------------------------
# tests/test_decomposition.py, ported
# ---------------------------------------------------------------------------


def test_empty_graph():
    g = Graph.from_edges(0, np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert g.chain_nodes().shape == (0,) and g.dead_nodes().shape == (0,)
    plan = DecompositionPlan.from_graph(g)
    assert plan.core.n == 0
    assert plan.reconstruct(np.zeros(0), d=D).shape == (0,)
    r = solve_variant("barrier_sticd", g, threshold=THRESH, device=CPU)
    assert r.pr.shape == (0,) and r.iterations == 0


def test_pure_cycle_has_no_chain_head():
    g = Graph.from_edges(5, np.arange(5), (np.arange(5) + 1) % 5)
    assert not g.chain_nodes().any()
    assert not g.dead_nodes().any()
    plan = DecompositionPlan.from_graph(g)
    assert plan.core is g  # nothing pruned: the plan reuses the graph
    ref, _ = pagerank_numpy(g, threshold=1e-13)
    r = solve_variant("barrier_sticd", g, threshold=THRESH, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6


def test_self_loop_not_a_chain():
    g = Graph.from_edges(3, np.asarray([0, 1, 2]), np.asarray([0, 2, 1]))
    assert not g.chain_nodes().any()
    assert not g.dead_nodes().any()


def test_chain_into_dangling_vertex_closed_form():
    edges = [(0, 4), (4, 0), (0, 1), (1, 2), (2, 3)]
    src, dst = zip(*edges)
    g = Graph.from_edges(5, np.asarray(src), np.asarray(dst))
    chain = g.chain_nodes()
    assert chain[1] and chain[2] and chain[4]
    assert not chain[3] and not chain[0]
    dead = g.dead_nodes()
    assert dead[1] and dead[2] and dead[3] and not dead[0]
    plan = DecompositionPlan.from_graph(g)
    assert set(np.flatnonzero(plan.pruned)) == {1, 2, 3, 4}
    assert plan.core.n == 1 and plan.stats()["contracted_edges"] == 1
    assert plan.core.weights[0] == pytest.approx(D)
    assert plan.core.bias is not None
    legacy = DecompositionPlan.from_graph(g, contract=False)
    assert set(np.flatnonzero(legacy.pruned)) == {1, 2, 3}
    ref, _ = pagerank_numpy(g, threshold=1e-14)
    pr = solve_variant("barrier_sticd", g, threshold=1e-10, device=CPU).pr
    assert l1_norm(pr, ref) < 1e-6
    base = (1.0 - D) / g.n
    assert pr[1] == pytest.approx(base + D * pr[0] / 2, rel=1e-9)
    assert pr[2] == pytest.approx(base + D * pr[1], rel=1e-9)
    assert pr[3] == pytest.approx(base + D * pr[2], rel=1e-9)
    assert pr[4] == pytest.approx(base + D * pr[0] / 2, rel=1e-9)


def test_chain_crossing_partition_boundary():
    g = port(chain_sink_heavy_graph(n_core=24, chain_len=40, n_sinks=8))
    assert DecompositionPlan.from_graph(g).stats()["pruned_chain"] >= 40
    ref, _ = pagerank_numpy(g, threshold=1e-13)
    r = solve_variant("nosync_sticd", g, threshold=THRESH, threads=4, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-5


def test_identical_members_rewired_into_core():
    edges = [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (0, 4), (1, 4), (3, 0), (4, 2)]
    src, dst = zip(*edges)
    g = Graph.from_edges(5, np.asarray(src), np.asarray(dst))
    plan = DecompositionPlan.from_graph(g)
    assert plan.stats()["pruned_identical"] == 1 and plan.core.n == 4
    np.testing.assert_array_equal(plan.core.out_degree, g.out_degree[plan.core_index])
    for hd in (False, True):
        ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=hd)
        r = solve_variant("barrier_sticd", g, threshold=1e-10,
                          handle_dangling=hd, device=CPU)
        assert l1_norm(r.pr, ref) < 1e-6


def test_zero_edge_graph_fully_pruned():
    n = 40
    g = Graph.from_edges(n, np.zeros(0, np.int32), np.zeros(0, np.int32))
    plan = DecompositionPlan.from_graph(g)
    assert plan.core.n == 0 and plan.pruned.all()
    for hd in (False, True):
        ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=hd)
        for vname in STICD:
            r = solve_variant(vname, g, threshold=THRESH, threads=4,
                              handle_dangling=hd, device=CPU)
            assert l1_norm(r.pr, ref) < 1e-9
            assert r.iterations == 0


@pytest.mark.parametrize("vname", STICD)
@pytest.mark.parametrize("handle_dangling", [False, True])
def test_sticd_matches_oracle_chain_sink_heavy(vname, handle_dangling):
    g = port(chain_sink_heavy_graph())
    plan = DecompositionPlan.from_graph(g)
    s = plan.stats()
    assert s["core_n"] < g.n and s["pruned_chain"] > 0 and s["pruned_dead"] > 0
    ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=handle_dangling)
    r = solve_variant(vname, g, threshold=THRESH, threads=4,
                      handle_dangling=handle_dangling, device=CPU)
    pr = r.pr
    assert isinstance(pr, np.ndarray) and pr.dtype == np.float64
    assert pr.shape == (g.n,)
    assert l1_norm(pr, ref) < 1e-5
    assert np.isfinite(pr).all() and (pr[plan.pruned] > 0).all()
    assert np.abs(pr[plan.pruned] - ref[plan.pruned]).max() < 1e-6


@pytest.mark.parametrize("vname", STICD)
def test_sticd_matches_oracle_webstanford_scaledown(vname):
    g = make_dataset("webStanford", scale_down=512)
    assert DecompositionPlan.from_graph(g).stats()["core_n"] < g.n
    ref, _ = pagerank_numpy(g, threshold=1e-12)
    r = solve_variant(vname, g, threshold=1e-8, threads=8, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-5


@pytest.mark.parametrize("make,strict", [
    (lambda: make_dataset("webStanford", scale_down=512), True),
    (lambda: port(chain_sink_heavy_graph()), False),
])
def test_contracting_plan_prunes_at_least_suffix_only(make, strict):
    g = make()
    plan = DecompositionPlan.from_graph(g)
    legacy = DecompositionPlan.from_graph(g, contract=False)
    s, ls = plan.stats(), legacy.stats()
    assert int(plan.pruned.sum()) >= int(legacy.pruned.sum())
    assert s["pruned_edges"] >= ls["pruned_edges"]
    if strict:
        assert int(plan.pruned.sum()) > int(legacy.pruned.sum())
        assert s["pruned_edges"] > ls["pruned_edges"]
        assert s["core_n"] < ls["core_n"]
    ref, _ = pagerank_numpy(g, threshold=1e-12)
    for p in (plan, legacy):
        core_pr = solve_variant("barrier", p.core, threshold=1e-9, device=CPU).pr
        assert l1_norm(p.reconstruct(core_pr.numpy()), ref) < 1e-5


@pytest.mark.parametrize("inner", ["blocked_nosync", "blocked_adaptive"])
def test_plan_composes_with_other_bundles(inner):
    """plan_build with the blocked Gauss–Seidel bundles, whose sweep is the
    CUDA gs_pass (its plain version on the CPU): the core is blocked after
    the plan."""
    g = port(chain_sink_heavy_graph(n_core=32, chain_len=12, n_sinks=12))
    opts = dict(block=64, device=CPU)
    bundle = plan_build(inner)(g, **opts)
    assert plan_stats(bundle)["core_n"] == bundle.plan.core.n < g.n
    assert bundle.bundle.n == bundle.plan.core.n
    ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=True)
    r = plan_run(bundle, threshold=THRESH, handle_dangling=True, **opts)
    assert l1_norm(r.pr, ref) < 1e-5


def test_plan_flags_select_analyses():
    g = port(chain_sink_heavy_graph())
    none = DecompositionPlan.from_graph(g, identical=False, chains=False, dead=False)
    assert none.core.n == g.n and not none.pruned.any()
    assert DecompositionPlan.from_graph(g).core.n < g.n


def test_reconstruct_rejects_wrong_core_shape():
    plan = DecompositionPlan.from_graph(port(chain_sink_heavy_graph()))
    with pytest.raises(ValueError, match="core_pr"):
        plan.reconstruct(np.zeros(plan.core.n + 1), d=D)


# ---------------------------------------------------------------------------
# tests/test_weighted.py's plan tests, ported
# ---------------------------------------------------------------------------


def weighted_biased_chains(seed: int = 21) -> Graph:
    base_g = chains_across_partitions_graph(seed=seed)
    rng = np.random.default_rng(3)
    return Graph.from_edges(base_g.n, base_g.src, base_g.dst,
                            weights=rng.uniform(0.3, 1.0, base_g.m),
                            bias=rng.uniform(0.5, 1.5, base_g.n))


def test_sticd_on_weighted_input_graph():
    g = weighted_biased_chains()
    assert DecompositionPlan.from_graph(g).contracted_m > 0
    ref, _ = pagerank_numpy(g, threshold=1e-13)
    r = solve_variant("nosync_sticd", g, threshold=THRESH, threads=4, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6


def test_adaptive_variants_solve_sticd_core():
    """The contracted core (d^k weights, folded biases, full out-degrees)
    solved by the adaptive and priority variants matches the core's own
    float64 oracle."""
    plan = DecompositionPlan.from_graph(weighted_biased_chains())
    core = plan.core
    assert plan.contracted_m > 0 and core.weights is not None
    assert core.bias is not None
    ref, _ = pagerank_numpy(core, threshold=1e-13)
    for vname in ("nosync_adaptive", "blocked_adaptive", "ppr_push_priority"):
        r = solve_variant(vname, core, threshold=THRESH, threads=4, block=64,
                          device=CPU)
        pr = r.pr
        if pr.ndim == 2:  # the priority push answers the biased global query
            pr = pr[0]
        assert l1_norm(pr, ref) < 1e-6, vname


def test_mid_chain_contraction_prunes_strictly_more():
    g = port(chains_across_partitions_graph())
    plan = DecompositionPlan.from_graph(g)
    legacy = DecompositionPlan.from_graph(g, contract=False)
    assert int(plan.pruned.sum()) > int(legacy.pruned.sum())
    assert plan.stats()["pruned_edges"] > legacy.stats()["pruned_edges"]
    assert plan.stats()["contracted_edges"] == 6
    assert plan.core.weights is not None and plan.core.bias is not None
    ref, _ = pagerank_numpy(g, threshold=1e-13)
    for vname in STICD:
        r = solve_variant(vname, g, threshold=THRESH, threads=4, device=CPU)
        assert l1_norm(r.pr, ref) < 1e-6, vname


def test_mid_chain_contraction_equivalence_across_partition_boundaries():
    g = port(chains_across_partitions_graph(seed=11))
    for hd in (False, True):
        ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=hd)
        for p in (2, 4, 8):
            r = solve_variant("nosync_sticd", g, threshold=THRESH, threads=p,
                              handle_dangling=hd, device=CPU)
            assert l1_norm(r.pr, ref) < 1e-6, (hd, p)


def test_weighted_dangling_sticd_with_contraction():
    base_g = chains_across_partitions_graph(seed=23)
    rng = np.random.default_rng(5)
    src = np.r_[base_g.src, rng.integers(0, 20, 6).astype(np.int32)]
    dst = np.r_[base_g.dst, np.arange(base_g.n, base_g.n + 6, dtype=np.int32)]
    g = Graph.from_edges(base_g.n + 6, src, dst,
                         weights=rng.uniform(0.3, 1.0, src.size))
    plan = DecompositionPlan.from_graph(g)
    assert plan.contracted_m > 0 and (g.out_degree == 0).any()
    ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=True)
    r = solve_variant("nosync_sticd", g, threshold=THRESH, threads=4,
                      handle_dangling=True, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6


def test_source_chain_pruned_without_edge():
    edges = [(0, 1), (0, 1), (1, 0), (1, 0), (3, 4), (4, 0)]
    src, dst = zip(*edges)
    g = Graph.from_edges(5, np.asarray(src), np.asarray(dst))
    assert bool(g.source_chain_nodes()[3])
    plan = DecompositionPlan.from_graph(g)
    assert set(np.flatnonzero(plan.pruned)) == {2, 3, 4}
    assert plan.stats()["contracted_edges"] == 0 and plan.core.bias is not None
    ref, _ = pagerank_numpy(g, threshold=1e-14)
    pr = solve_variant("barrier_sticd", g, threshold=1e-10, device=CPU).pr
    assert l1_norm(pr, ref) < 1e-6
    base = (1 - D) / g.n
    assert pr[3] == pytest.approx(base, rel=1e-9)
    assert pr[4] == pytest.approx(base * (1 + D), rel=1e-9)


def test_plan_rebakes_on_damping_mismatch():
    g = port(chains_across_partitions_graph(seed=13))
    assert DecompositionPlan.from_graph(g).contracted_m > 0
    _, bundle = build_variant("barrier_sticd", g, d=0.6, device=CPU)
    assert bundle.plan.d == 0.6
    for d in (0.85, 0.6):
        ref, _ = pagerank_numpy(g, d=d, threshold=1e-13)
        r = solve_variant("barrier_sticd", g, d=d, threshold=THRESH, device=CPU)
        assert l1_norm(r.pr, ref) < 1e-6, d
    v = get_variant("barrier_sticd")
    _, stale = build_variant("barrier_sticd", g, device=CPU)  # bakes 0.85
    ref, _ = pagerank_numpy(g, d=0.6, threshold=1e-13)
    assert l1_norm(v.run(stale, d=0.6, threshold=THRESH).pr, ref) < 1e-6


def test_bundle_built_at_one_d_and_run_at_another_equals_a_fresh_build():
    """A bundle built at d=0.85 and run at d=0.5 re-plans: the same
    iterations and the same ranks as a bundle built at 0.5."""
    g = port(chains_across_partitions_graph(seed=13))
    for vname in STICD:
        v, stale = build_variant(vname, g, threads=4, device=CPU)
        _, fresh = build_variant(vname, g, d=0.5, threads=4, device=CPU)
        a = v.run(stale, d=0.5, threshold=THRESH)
        b = v.run(fresh, d=0.5, threshold=THRESH)
        assert stale.plan.d == 0.85 and fresh.plan.d == 0.5
        assert a.iterations == b.iterations and a.sweeps == b.sweeps
        np.testing.assert_array_equal(a.pr, b.pr)


def test_biased_graph_rejects_closed_form_dangling():
    g = port(random_weighted_graph(seed=5, biased=True))
    plan = DecompositionPlan.from_graph(g)
    assert plan.pruned.any()
    with pytest.raises(ValueError, match="uniform"):
        plan.reconstruct(np.zeros(plan.core.n), handle_dangling=True)


# ---------------------------------------------------------------------------
# parity with the reference's sticd variants
# ---------------------------------------------------------------------------


PARITY_GRAPHS = {**SURROGATES, "chains_across_partitions": chains_across_partitions_graph,
                 "webStanford_512": lambda: ref_make_dataset("webStanford", scale_down=512)}


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(PARITY_GRAPHS))
@pytest.mark.parametrize("vname", STICD)
def test_sticd_matches_reference(vname, gname, handle_dangling):
    g = PARITY_GRAPHS[gname]()
    kw = dict(threshold=1e-7, handle_dangling=handle_dangling, threads=4)
    ref = ref_solve_variant(vname, g, **kw)
    got = solve_variant(vname, port(g), device=CPU, **kw)
    assert got.pr.shape == (g.n,) and got.pr.dtype == np.float64
    assert l1_norm(got.pr, np.asarray(ref.pr)) <= 1e-5
    assert abs(got.iterations - int(ref.iterations)) <= 2
    oracle, _ = pagerank_numpy(port(g), threshold=1e-12,
                               handle_dangling=handle_dangling)
    assert l1_norm(got.pr, oracle) <= 1e-5


@pytest.mark.parametrize("vname", STICD)
def test_sticd_matches_reference_weighted_biased(vname):
    g = weighted_input(chains_across_partitions_graph(seed=21), "weighted_biased")
    ref = ref_solve_variant(vname, g, threshold=1e-7, threads=4)
    got = solve_variant(vname, port(g), device=CPU, threshold=1e-7, threads=4)
    assert l1_norm(got.pr, np.asarray(ref.pr)) <= 1e-5
    assert abs(got.iterations - int(ref.iterations)) <= 2


@pytest.mark.parametrize("vname", STICD)
def test_sticd_raises_the_reference_errors(vname):
    g = weighted_input(chains_across_partitions_graph(seed=21), "weighted_biased")
    pg = port(g)
    cases = [(dict(handle_dangling=True), ValueError, "uniform"),
             (dict(pr0=np.full(g.n + 1, 1.0 / g.n)), ValueError, "full-length"),
             (dict(perforate=True), TypeError, "perforate")]
    for kw, exc, match in cases:
        with pytest.raises(exc, match=match):
            ref_solve_variant(vname, g, threshold=1e-7, threads=4, **kw)
        with pytest.raises(exc, match=match):
            solve_variant(vname, pg, threshold=1e-7, threads=4, device=CPU, **kw)


def test_sticd_variants_registered():
    for vname, layout, schedule in (("barrier_sticd", "sticd_device", "barrier"),
                                    ("nosync_sticd", "sticd_partitioned", "nosync")):
        v = get_variant(vname)
        assert (v.layout, v.backend, v.schedule) == (layout, "torch", schedule)
    assert get_variant("nosync_sticd").options == ("thread_level",)


def test_nosync_sticd_passes_thread_level_to_the_core_solve():
    g = port(chains_across_partitions_graph(seed=11))
    kw = dict(threshold=1e-7, threads=4, device=CPU)
    on = solve_variant("nosync_sticd", g, thread_level=True, **kw)
    off = solve_variant("nosync_sticd", g, thread_level=False, **kw)
    assert on.iterations == off.iterations
    assert on.sweeps <= off.sweeps == 4 * off.iterations


def test_planned_bundle_wraps_the_partitioned_core():
    g = port(chains_across_partitions_graph())
    _, planned = build_variant("nosync_sticd", g, threads=4, device=CPU)
    assert isinstance(planned, PlannedBundle) and planned.bundle.p == 4
    assert planned.bundle.n == planned.plan.core.n
    assert plan_stats(planned) == planned.plan.stats()
    _, partitioned = build_variant("nosync", g, threads=4, device=CPU)
    assert plan_stats(partitioned) is None


def test_launcher_runs_barrier_sticd_on_cpu(capsys):
    rep = pagerank_run.run(["--scale-down", "512", "--variant", "barrier_sticd",
                            "--handle-dangling", "--device", "cpu"])
    out = capsys.readouterr().out
    s = rep["plan"]
    assert (f"plan: core n={s['core_n']} m={s['core_m']} (pruned identical="
            f"{s['pruned_identical']} chain={s['pruned_chain']} dead="
            f"{s['pruned_dead']}, contracted={s['contracted_edges']})") in out
    assert s["core_n"] < rep["n"] and rep["l1"] < 1e-5


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------


def test_warm_start_pr_matches_reference():
    g = ref_rmat_graph(8, avg_degree=6, seed=11)
    for gw, hd in ((g, False), (g, True),
                   (weighted_input(g, "weighted_biased"), False)):
        prev = np.random.default_rng(2).random(g.n) / g.n
        np.testing.assert_array_equal(
            warm_start_pr(port(gw), prev, handle_dangling=hd),
            ref_warm_start_pr(gw, prev, handle_dangling=hd))


class TestWarmStart:
    VARIANTS = ["sequential", "barrier", "nosync", "blocked", "barrier_sticd",
                "nosync_sticd"]

    def test_same_fixed_point_fewer_iterations(self):
        g = ref_rmat_graph(8, avg_degree=6, seed=11)
        prev, _ = pagerank_numpy(port(g), threshold=1e-13)
        g2, _ = g.apply_updates(adds=[[1, 2], [5, 9]],
                                dels=np.stack([g.src[:2], g.dst[:2]], 1))
        g2 = port(g2)
        ws = warm_start_pr(g2, prev)
        for v in self.VARIANTS:
            kw = dict(threshold=5e-9, max_iter=5000, threads=4, device=CPU)
            cold = solve_variant(v, g2, **kw)
            warm = solve_variant(v, g2, pr0=ws, **kw)
            l1 = l1_norm(cold.pr, warm.pr)
            assert l1 < 1e-5, (v, l1)
            assert warm.iterations <= cold.iterations, v

    def test_shape_validated(self):
        g = port(ref_rmat_graph(6, seed=0))
        with pytest.raises(ValueError, match="shape"):
            warm_start_pr(g, np.zeros(g.n + 1))
