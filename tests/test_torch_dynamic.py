"""The port's dynamic updates (``Graph.apply_updates``, ``GraphDelta``,
``DecompositionPlan.touched_by``/``patched``, the signed ``push_residual``
and ``repro_torch.core.dynamic``) against the JAX reference, on the CPU.

* ``Graph.apply_updates`` and its ``GraphDelta`` equal the reference's
  array for array, on the reference's hypothesis strategy and on weighted
  graphs with parallel edges and ``add_weights``; every error case raises
  the reference's ``ValueError``.
* The reference's ``random_update_batch`` draws deletes as edge
  positions, so on a graph with parallel edges it can delete one pair
  twice and its own ``apply_updates`` raises; the port draws among the
  distinct edge keys, and on graphs without parallel edges it emits the
  reference's batch.
* ``touched_by``/``patched`` equal the reference's; a patched plan
  reconstructs what a plan built afresh on the updated graph does.
* ``push_residual(signed=True, bank=1.0, touched=...)`` equals the
  reference's bit for bit.
* ``IncrementalPageRank``: the differential harness of
  ``tests/test_dynamic.py`` for every family (the blocked variants on the
  CPU twins of the CUDA kernels), the localized, fallback, STIC-D,
  metamorphic, no-op and ``handle_dangling`` cases, with the reference's
  modes and plan actions on the same stream.
* ``PPREngine.apply_updates`` on both backends.

``tests/test_dynamic.py::TestPatchBlockedCoo`` has no counterpart: the port
keeps the dst-sorted in-CSR and no blocked-COO tiles (the layout decision
of ROADMAP.md), so the graph ``apply_updates`` returns is already the
patched layout every device bundle reads.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_compat import given, strategies as st

    def settings(**_kw):
        return lambda f: f

from repro.core.dynamic import IncrementalPageRank as RefIPR
from repro.core.dynamic import random_update_batch as ref_random_update_batch
from repro.core.pagerank import pagerank_numpy as ref_pagerank_numpy
from repro.graphs import make_dataset as ref_make_dataset
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.csr import DecompositionPlan as RefPlan
from repro.graphs.csr import Graph as RefGraph
from repro.ppr.push import push_residual as ref_push_residual
from repro.serving.ppr_engine import PPREngine as RefPPREngine
from repro.serving.ppr_engine import PPRQuery as RefPPRQuery
from repro_torch.core import (
    IncrementalPageRank,
    exact_residual,
    make_update_injector,
    random_update_batch,
)
from repro_torch.graphs import DecompositionPlan, Graph, GraphDelta, graph_from_arrays
from repro_torch.ppr import ppr_numpy, push_residual, teleport_from_seeds
from repro_torch.serving import PPREngine, PPRQuery
from test_dynamic import graph_and_updates
from test_weighted import random_weighted_graph

CPU = "cpu"
TOL = 1e-8
D = 0.85
NO_DB = dict(database=None)  # hypothesis draws stay out of .hypothesis/
DELTA_FIELDS = ("added", "deleted", "added_weights", "touched_src",
                "touched_dst", "newly_dangling", "undangled")
GRAPH_FIELDS = ("src", "dst", "out_degree", "in_ptr", "weights", "bias")
PLAN_FIELDS = ("core_index", "full_to_core", "struct_pruned", "chain_mask",
               "source_mask", "dead_mask", "ident_members", "ident_reps")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


def assert_same_arrays(a, b, fields):
    for name in fields:
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype, (name, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=name)


def assert_same_update(ref_g, g, adds, dels, add_weights=None):
    """Both packages apply one batch: the same graph and delta, or the same
    ValueError."""
    try:
        rg2, rdelta = ref_g.apply_updates(adds=adds, dels=dels,
                                          add_weights=add_weights)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            g.apply_updates(adds=adds, dels=dels, add_weights=add_weights)
        assert str(got.value) == str(exc)
        return None
    g2, delta = g.apply_updates(adds=adds, dels=dels, add_weights=add_weights)
    assert g2.n == rg2.n and g2.m == rg2.m
    assert_same_arrays(rg2, g2, GRAPH_FIELDS)
    assert_same_arrays(rdelta, delta, DELTA_FIELDS)
    assert delta.num_ops == rdelta.num_ops
    np.testing.assert_array_equal(delta.touched_vertices(),
                                  rdelta.touched_vertices())
    for block in (1, 4, 16):
        np.testing.assert_array_equal(delta.touched_dst_blocks(block),
                                      rdelta.touched_dst_blocks(block))
    return g2, delta


def oracle(g) -> np.ndarray:
    """The reference's float64 Jacobi fixed point of ``g`` (either
    package's graph: it reads only the edge arrays)."""
    return ref_pagerank_numpy(g, threshold=1e-13, max_iter=200_000)[0]


# ---------------------------------------------------------------------------
# Graph.apply_updates and GraphDelta
# ---------------------------------------------------------------------------


@settings(**NO_DB)
@given(graph_and_updates())
def test_apply_updates_equals_reference(gau):
    g, adds, dels = gau
    assert_same_update(g, port(g), adds, dels)


@pytest.mark.parametrize("seed", range(6))
def test_weighted_apply_updates_equals_reference(seed):
    """Weighted graphs hold parallel edges: an add of an existing pair is
    a second copy, a delete removes the first copy in canonical order, and
    ``add_weights`` ride with the adds."""
    rng = np.random.default_rng(100 + seed)
    g = random_weighted_graph(n=24, m=90, seed=seed, biased=bool(seed % 2))
    pg = port(g)
    for _ in range(3):
        keys = np.unique(np.stack([g.src, g.dst], 1), axis=0)
        dels = keys[rng.choice(len(keys), size=5, replace=False)]
        pairs = rng.integers(0, g.n, size=(8, 2))
        pairs[:3] = keys[rng.choice(len(keys), size=3, replace=False)]  # parallel
        pairs = np.unique(pairs, axis=0)
        w = rng.uniform(0.2, 1.0, len(pairs))
        out = assert_same_update(g, pg, pairs, dels, add_weights=w)
        assert out is not None
        pg, _ = out
        g, _ = g.apply_updates(adds=pairs, dels=dels, add_weights=w)
    # with add_weights left out, a weighted graph adds weight-1 copies
    assert_same_update(g, pg, [[0, 1], [0, 2]], None)


def _line():
    return RefGraph.from_edges(3, np.array([0]), np.array([1]))


def _two():
    return RefGraph.from_edges(3, np.array([0, 1]), np.array([1, 2]))


def _empty():
    return RefGraph.from_edges(3, np.zeros(0, np.int32), np.zeros(0, np.int32))


def _weighted():
    return RefGraph.from_edges(3, np.array([0]), np.array([1]),
                               weights=np.array([0.5]))


@pytest.mark.parametrize("make,kw", [
    (_line, dict(adds=[[1, 2], [1, 2]])),                  # duplicate add
    (_line, dict(adds=[[0, 1]])),                          # already present
    (_line, dict(dels=[[2, 0]])),                          # nonexistent
    (_empty, dict(dels=[[2, 0]])),                         # nothing to delete
    (_two, dict(dels=[[0, 1], [0, 1]])),                   # duplicate delete
    (_line, dict(adds=[[0, 3]])),                          # out of range
    (_line, dict(adds=[[-1, 0]])),
    (_line, dict(adds=[[0, 1, 2]])),                       # not (k, 2)
    (_line, dict(adds=[[1, 2]], add_weights=[0.5])),       # unweighted graph
    (_weighted, dict(adds=[[1, 2]], add_weights=[0.5, 0.5])),  # wrong shape
    (_weighted, dict(adds=[[0, 1], [0, 1]])),              # duplicate, weighted
])
def test_apply_updates_errors_are_the_references(make, kw):
    g = make()
    with pytest.raises(ValueError) as ref:
        g.apply_updates(**kw)
    with pytest.raises(ValueError) as got:
        port(g).apply_updates(**kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("make,kw", [
    (_two, dict(adds=[[0, 1]], dels=[[0, 1]])),    # delete, then re-add
    (_two, dict(dels=[[0, 1]])),                    # 0 becomes dangling
    (_weighted, dict(adds=[[0, 1]], add_weights=[0.25])),
    (_line, dict()),                                # empty batch
])
def test_apply_updates_edge_cases_equal_reference(make, kw):
    g = make()
    before = port(g)
    snapshot = [getattr(before, f).copy() for f in ("src", "dst", "out_degree")]
    assert assert_same_update(g, before, kw.get("adds"), kw.get("dels"),
                              kw.get("add_weights")) is not None
    for f, a in zip(("src", "dst", "out_degree"), snapshot):
        np.testing.assert_array_equal(getattr(before, f), a)  # left unmodified


def test_out_degree_shifts_by_deltas_not_a_recount():
    """A plan's core keeps the full graph's out-degrees, which its own
    ``src`` does not give; an update must shift them, not recount them."""
    g = Graph.from_edges(4, np.array([0, 1]), np.array([1, 2]))
    g.out_degree = np.array([3, 2, 0, 0], np.int32)  # as a core's would be
    g2, delta = g.apply_updates(adds=[[0, 2]], dels=[[1, 2]])
    np.testing.assert_array_equal(g2.out_degree, [4, 1, 0, 0])
    assert delta.newly_dangling.size == 0 and delta.undangled.size == 0


# ---------------------------------------------------------------------------
# random_update_batch: the reference's multigraph fault, and parity
# ---------------------------------------------------------------------------


def test_reference_batch_on_a_multigraph_raises_and_the_ports_applies():
    """The falsifying example of the reference's own
    ``test_apply_updates_equals_full_rebuild``: ten copies of 0→0."""
    n = 10
    src = np.zeros(10, np.int32)
    g = RefGraph.from_edges(n, src, src.copy())
    adds, dels = ref_random_update_batch(g, np.random.default_rng(0), 4)
    np.testing.assert_array_equal(dels, [[0, 0], [0, 0]])
    with pytest.raises(ValueError, match="duplicate delete"):
        g.apply_updates(adds=adds, dels=dels)
    pg = port(g)
    adds, dels = random_update_batch(pg, np.random.default_rng(0), 4)
    np.testing.assert_array_equal(dels, [[0, 0]])  # one distinct key
    g2, delta = pg.apply_updates(adds=adds, dels=dels)
    assert g2.m == pg.m - 1 + len(adds) and delta.num_ops == 1 + len(adds)


def test_surrogate_batches_apply_where_the_references_raise():
    """The webStanford surrogate keeps parallel edges (``make_dataset``
    does not dedupe): large reference batches delete a pair twice."""
    g = ref_make_dataset("webStanford", scale_down=256)
    pg = port(g)
    raised = 0
    for seed in range(8):
        adds, dels = ref_random_update_batch(g, np.random.default_rng(seed), 1000)
        try:
            g.apply_updates(adds=adds, dels=dels)
        except ValueError as exc:
            assert "duplicate delete" in str(exc)
            raised += 1
        adds, dels = random_update_batch(pg, np.random.default_rng(seed), 1000)
        keys = dels[:, 1] * pg.n + dels[:, 0]
        assert np.unique(keys).size == keys.size
        pg.apply_updates(adds=adds, dels=dels)
    assert raised > 0


@pytest.mark.parametrize("localized", [False, True])
@pytest.mark.parametrize("scale,seed", [(6, 0), (8, 3), (10, 37)])
def test_random_update_batch_is_the_references_without_parallel_edges(
        scale, seed, localized):
    g = ref_rmat_graph(scale, avg_degree=4, seed=seed)
    pg = port(g)
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        ra, rd = ref_random_update_batch(g, rng_a, 24, localized=localized)
        pa, pd = random_update_batch(pg, rng_b, 24, localized=localized)
        for r, p in ((ra, pa), (rd, pd)):
            assert (r is None) == (p is None)
            if r is not None:
                np.testing.assert_array_equal(r, p)
        g, _ = g.apply_updates(adds=ra, dels=rd)
        pg, _ = pg.apply_updates(adds=pa, dels=pd)


def test_update_injector_samples_the_live_graph():
    pg = port(ref_rmat_graph(7, avg_degree=4, seed=2))
    inject = make_update_injector(np.random.default_rng(4), 10)
    again = make_update_injector(np.random.default_rng(4), 10)
    for _ in range(3):
        a, d = inject(pg)
        a2, d2 = again(pg)
        np.testing.assert_array_equal(a, a2)
        np.testing.assert_array_equal(d, d2)
        pg, _ = pg.apply_updates(adds=a, dels=d)


# ---------------------------------------------------------------------------
# DecompositionPlan.touched_by / patched
# ---------------------------------------------------------------------------


def _exact_core(plan) -> np.ndarray:
    """The core's fixed point by a dense float64 solve (base (1-d)/n_core,
    leaky), the input ``reconstruct`` expects."""
    c = plan.core
    inv = np.where(c.out_degree > 0, 1.0 / np.maximum(c.out_degree, 1), 0.0)
    w = np.ones(c.m) if c.weights is None else c.weights
    a = np.zeros((c.n, c.n))
    np.add.at(a, (c.dst, c.src), w * inv[c.src])
    base = (1 - D) / c.n * (np.ones(c.n) if c.bias is None else c.bias)
    return np.linalg.solve(np.eye(c.n) - D * a, base)


def _core_updates(plan, g, rng, k):
    """``k`` adds among ordinary core vertices (neither pruned nor an
    identical-class representative) that are not edges yet, and one delete
    of an existing such edge."""
    hot = plan.pruned.copy()
    hot[plan.ident_reps] = True
    cold = np.flatnonzero(~hot)
    have = set(zip(g.src.tolist(), g.dst.tolist()))
    adds = []
    while len(adds) < k:
        u, v = (int(x) for x in rng.choice(cold, 2, replace=False))
        if (u, v) not in have and [u, v] not in adds:
            adds.append([u, v])
    inner = [(u, v) for u, v in have if not hot[u] and not hot[v]]
    dels = [list(inner[int(rng.integers(len(inner)))])] if inner else None
    return np.array(adds), dels


@pytest.mark.parametrize("gname", ["rmat", "weighted"])
def test_plan_patch_equals_reference(gname):
    g = (ref_rmat_graph(8, avg_degree=6, seed=43) if gname == "rmat"
         else random_weighted_graph(n=60, m=260, seed=5, biased=False))
    rplan = RefPlan.from_graph(g)
    plan = DecompositionPlan.from_graph(port(g))
    rng = np.random.default_rng(1)
    pg = port(g)
    for _ in range(2):
        adds, dels = _core_updates(plan, pg, rng, 4)
        rg2, rdelta = g.apply_updates(adds=adds, dels=dels)
        pg2, delta = pg.apply_updates(adds=adds, dels=dels)
        assert not plan.touched_by(delta) and not rplan.touched_by(rdelta)
        rplan = rplan.patched(rg2, rdelta)
        plan = plan.patched(pg2, delta)
        assert_same_arrays(rplan, plan, PLAN_FIELDS)
        assert_same_arrays(rplan.core, plan.core, GRAPH_FIELDS)
        assert plan.full is pg2 and plan.stats() == rplan.stats()
        # the full graph's out-CSR is the updated graph's, not the old one's
        if plan.full_out is not None:
            for a, b in zip(plan.full_out, pg2.out_csr()):
                np.testing.assert_array_equal(a, b)
        # the patched plan reconstructs the updated graph's fixed point
        fresh = DecompositionPlan.from_graph(pg2)
        for hd in (False, True):
            np.testing.assert_allclose(
                plan.reconstruct(_exact_core(plan), handle_dangling=hd),
                fresh.reconstruct(_exact_core(fresh), handle_dangling=hd),
                rtol=0, atol=1e-12)
        g, pg = rg2, pg2


def test_plan_touched_by_pruned_vertex_equals_reference():
    g = ref_rmat_graph(8, avg_degree=6, seed=43)
    rplan, plan = RefPlan.from_graph(g), DecompositionPlan.from_graph(port(g))
    pruned = np.flatnonzero(plan.pruned)
    core_v = np.flatnonzero(~plan.pruned)
    cases = [dict(adds=[[int(core_v[0]), int(pruned[0])]]),
             dict(adds=[[int(pruned[1]), int(core_v[1])]]),
             dict()]
    if plan.ident_reps.size:
        rep = int(plan.ident_reps[0])
        other = int(core_v[core_v != rep][0])
        cases.append(dict(adds=[[other, rep]]))
    pg = port(g)
    for kw in cases:
        try:
            rg2, rdelta = g.apply_updates(**kw)
        except ValueError:  # the pair exists: delete it instead
            kw = dict(dels=kw["adds"])
            rg2, rdelta = g.apply_updates(**kw)
        pg2, delta = pg.apply_updates(**kw)
        assert plan.touched_by(delta) == rplan.touched_by(rdelta)
        assert plan.touched_by(delta) == bool(kw)
        if kw:
            with pytest.raises(ValueError, match="re-plan"):
                plan.patched(pg2, delta)
        else:
            assert plan.patched(pg2, delta).full is pg2


# ---------------------------------------------------------------------------
# push_residual: the signed repair drain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("priority", [False, True], ids=["fifo", "priority"])
@pytest.mark.parametrize("gname", ["rmat", "weighted"])
def test_signed_push_residual_equals_reference(gname, priority):
    g = (ref_rmat_graph(8, avg_degree=6, seed=1) if gname == "rmat"
         else random_weighted_graph(seed=11, biased=False))
    rng = np.random.default_rng(0)
    r0 = (rng.random(g.n) - 0.5) * 1e-4  # a signed defect
    est0 = rng.random(g.n) / g.n
    outs = []
    for fn, graph in ((push_residual, port(g)), (ref_push_residual, g)):
        est, r = est0.copy(), r0.copy()
        touched = np.zeros(g.n, dtype=bool)
        touched[:3] = True
        counts = fn(graph, est, r, d=D, rmax=1e-9, bank=1.0, signed=True,
                    handle_dangling=False, max_rounds=10_000, touched=touched,
                    priority=priority)
        outs.append((est, r, touched, tuple(counts)))
    (ea, ra, ta, ca), (eb, rb, tb, cb) = outs
    assert ca == cb and ca[1] > 0
    np.testing.assert_allclose(ea, eb, rtol=0, atol=1e-15)
    np.testing.assert_allclose(ra, rb, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(ta, tb)
    assert np.abs(ra).max() <= 1e-9


# ---------------------------------------------------------------------------
# IncrementalPageRank: the differential harness
# ---------------------------------------------------------------------------


def _stream_check(g, variant, *, ref_variant=None, ref_opts=None, batches=3,
                  per=24, seed=0, **opts):
    """Apply ``batches`` random batches to the port's engine (and, with
    ``ref_variant``, to the reference's on the same stream, with ``opts``
    and ``ref_opts``): after each, L1 to the float64 oracle of the updated
    graph < 1e-6 and within the certificate, and the reference's mode and
    plan action."""
    rng = np.random.default_rng(seed)
    ipr = IncrementalPageRank(port(g), variant=variant, tol=TOL, device=CPU,
                              **opts)
    ref = None
    if ref_variant is not None:
        ref = RefIPR(g, variant=ref_variant, tol=TOL, **opts, **(ref_opts or {}))
        ref_rng = np.random.default_rng(seed)
    for _ in range(batches):
        adds, dels = random_update_batch(ipr.g, rng, per)
        rep = ipr.apply(adds=adds, dels=dels)
        assert rep.converged, rep
        want = oracle(ipr.g)
        l1 = np.abs(ipr.pagerank - want).sum()
        assert l1 < 1e-6, (variant, l1)
        # the oracle itself is only converged to 1e-13, hence the slack
        assert l1 <= rep.l1_cert + 1e-9, (variant, l1, rep.l1_cert)
        if ref is not None:
            ra, rd = ref_random_update_batch(ref.g, ref_rng, per)
            np.testing.assert_array_equal(ra, adds)
            np.testing.assert_array_equal(rd, dels)
            rrep = ref.apply(adds=ra, dels=rd)
            assert (rep.mode, rep.plan_action) == (rrep.mode, rrep.plan_action)
            assert np.abs(ref.pagerank - ipr.pagerank).sum() < 2e-8
    return ipr


# The reference's counterpart of ``blocked`` is ``pallas`` (``spmv_blocked``,
# interpreted on the CPU).  ``blocked_nosync`` has no reference leg: the
# reference's ``pallas_nosync`` runs ``spmv_gs_pass``, which calls
# ``pl.load``, gone from jax 0.9 (ROADMAP.md, "Note on the reference's
# Gauss-Seidel kernels"), so it raises on the CPU; the port's run is held
# to the reference's float64 oracle alone.
INTERPRET = {"interpret": True}


@pytest.mark.parametrize("variant,ref_variant,opts", [
    ("sequential", "sequential", {}),
    ("barrier", "barrier", {}),
    ("nosync", "nosync", {"threads": 4}),
    ("blocked", "pallas", {"block": 32}),
    ("blocked_nosync", None, {"block": 32}),
    ("barrier_sticd", "barrier_sticd", {}),
    ("nosync_sticd", "nosync_sticd", {"threads": 4}),
])
def test_differential_rmat(variant, ref_variant, opts):
    g = ref_rmat_graph(8, avg_degree=6, seed=17)
    _stream_check(g, variant, ref_variant=ref_variant,
                  ref_opts=INTERPRET if ref_variant == "pallas" else None,
                  **opts)


def test_differential_webstanford():
    g = ref_make_dataset("webStanford", scale_down=256.0)
    _stream_check(g, "sequential", per=40, seed=1)


def test_weighted_stream():
    g = ref_rmat_graph(7, avg_degree=5, seed=23)
    rng = np.random.default_rng(2)
    g.weights = rng.random(g.m) * 0.9 + 0.1
    ipr = IncrementalPageRank(port(g), tol=TOL, device=CPU)
    for _ in range(3):
        adds, dels = random_update_batch(ipr.g, rng, 16)
        w = None if adds is None else rng.random(len(adds)) * 0.9 + 0.1
        rep = ipr.apply(adds=adds, dels=dels, add_weights=w)
        assert rep.converged
        assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() < 1e-6


@pytest.mark.parametrize("variant", ["sequential", "blocked_nosync"])
def test_metamorphic_inverse_restores_ranks(variant):
    g = port(ref_rmat_graph(8, avg_degree=6, seed=29))
    want = oracle(g)
    adds, dels = random_update_batch(g, np.random.default_rng(3), 30)
    ipr = IncrementalPageRank(g, variant=variant, tol=TOL, device=CPU)
    ipr.apply(adds=adds, dels=dels)
    ipr.apply(adds=dels, dels=adds)  # the inverse batch
    assert_same_arrays(g, ipr.g, GRAPH_FIELDS)
    assert np.abs(ipr.pagerank - want).sum() < 2 * TOL + 1e-9


def test_metamorphic_batch_split_agrees():
    g = port(ref_rmat_graph(8, avg_degree=6, seed=31))
    adds, dels = random_update_batch(g, np.random.default_rng(4), 32)
    one = IncrementalPageRank(g, tol=TOL, device=CPU)
    one.apply(adds=adds, dels=dels)
    split = IncrementalPageRank(g, tol=TOL, device=CPU)
    ka, kd = len(adds) // 2, len(dels) // 2
    split.apply(adds=adds[:ka], dels=dels[:kd])
    split.apply(adds=adds[ka:], dels=dels[kd:])
    assert_same_arrays(one.g, split.g, GRAPH_FIELDS)
    assert np.abs(one.pagerank - split.pagerank).sum() < 2 * TOL + 1e-9


@pytest.mark.parametrize("variant", ["sequential", "blocked_nosync"])
def test_localized_updates_stay_local(variant):
    g = ref_rmat_graph(10, avg_degree=4, seed=37)
    assert int((g.out_degree == 0).sum()) > 20  # sinks to target
    ipr = IncrementalPageRank(port(g), variant=variant, tol=TOL, device=CPU)
    ref = RefIPR(g, tol=TOL)
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        adds, dels = random_update_batch(ipr.g, rng, 24, localized=True)
        rep = ipr.apply(adds=adds, dels=dels)
        assert rep.mode == "push" and rep.converged
        assert rep.touched_frac < 0.10, rep
        rrep = ref.apply(*ref_random_update_batch(ref.g, ref_rng, 24,
                                                  localized=True))
        assert rrep.mode == rep.mode
    assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() < 1e-6


@pytest.mark.parametrize("variant,ref_variant", [
    ("barrier", "barrier"), ("blocked", "pallas"), ("blocked_nosync", None)])
def test_fallback_when_push_budget_exhausted(variant, ref_variant):
    g = ref_rmat_graph(8, avg_degree=6, seed=41)
    ipr = IncrementalPageRank(port(g), variant=variant, tol=TOL, device=CPU)
    rng = np.random.default_rng(6)
    adds, dels = random_update_batch(ipr.g, rng, 20)
    ipr.max_push_rounds = 0  # starve the push path
    rep = ipr.apply(adds=adds, dels=dels)
    assert rep.mode == "fallback" and rep.touched_frac == 1.0
    assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() <= rep.l1_cert + 1e-9
    if ref_variant is not None:
        ref = RefIPR(g, variant=ref_variant, tol=TOL,
                     **(INTERPRET if ref_variant == "pallas" else {}))
        ref.max_push_rounds = 0
        rrep = ref.apply(adds=adds, dels=dels)
        assert rrep.mode == "fallback"
        # each certificate bounds the L1 to the exact fixed point
        assert (np.abs(ref.pagerank - ipr.pagerank).sum()
                <= rep.l1_cert + rrep.l1_cert + 1e-12)
    ipr.max_push_rounds = 10_000
    rep2 = ipr.apply(*random_update_batch(ipr.g, rng, 10))
    assert rep2.converged
    assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() < 1e-6


@pytest.mark.parametrize("variant,opts", [("barrier_sticd", {}),
                                          ("nosync_sticd", {"threads": 4})])
def test_sticd_plan_patched_until_touched(variant, opts):
    """Core updates patch the plan, an update at a pruned vertex
    invalidates it, and the next fallback re-plans; the reference's
    variant takes the same actions on the same stream."""
    g = ref_rmat_graph(8, avg_degree=6, seed=43)
    plan = DecompositionPlan.from_graph(port(g))
    hot = plan.pruned.copy()
    hot[plan.ident_reps] = True
    cold_v = np.flatnonzero(~hot)
    a = next((u, v) for u in cold_v for v in cold_v
             if u != v and not ((g.src == u) & (g.dst == v)).any())
    pruned = np.flatnonzero(plan.pruned)
    core_v = np.flatnonzero(~plan.pruned)
    p = int(pruned[0])
    q = int(core_v[0]) if core_v[0] != p else int(core_v[1])
    exists = bool(((g.src == q) & (g.dst == p)).any())
    second = dict(dels=[[q, p]]) if exists else dict(adds=[[q, p]])
    batches = [dict(adds=[list(a)]), second]
    rng = np.random.default_rng(7)

    ipr = IncrementalPageRank(port(g), variant=variant, tol=TOL, device=CPU,
                              **opts)
    ref = RefIPR(g, variant=variant, tol=TOL, **opts)
    for kw, action in zip(batches, ("patched", "invalidated")):
        rep, rrep = ipr.apply(**kw), ref.apply(**kw)
        assert rep.plan_action == rrep.plan_action == action, rep
        assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() < 1e-6
    adds, dels = random_update_batch(ipr.g, rng, 12)
    ipr.max_push_rounds = ref.max_push_rounds = 0  # fallback: re-plan
    rep, rrep = ipr.apply(adds=adds, dels=dels), ref.apply(adds=adds, dels=dels)
    assert rep.mode == rrep.mode == "fallback"
    assert rep.plan_action == rrep.plan_action == "none"
    assert ipr._plan is not None and ipr._plan.full is ipr.g
    ipr.max_push_rounds = 10_000
    ipr._refine()
    assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() < 1e-6
    # a core-only batch now patches the re-baked plan, whose inner bundle
    # the next fallback rebuilds from build_opts on the same device
    plan = ipr._plan
    adds, dels = _core_updates(plan, ipr.g, rng, 3)
    ipr.max_push_rounds = 0
    rep = ipr.apply(adds=adds, dels=dels)
    assert (rep.mode, rep.plan_action) == ("fallback", "patched")
    assert ipr._bundle.plan is ipr._plan and ipr._plan.core.m == plan.core.m + 3 - 1
    assert np.abs(ipr.pagerank - oracle(ipr.g)).sum() <= rep.l1_cert + 1e-9


def test_handle_dangling_unsupported():
    g = ref_rmat_graph(6, seed=0)
    with pytest.raises(NotImplementedError, match="leaky"):
        RefIPR(g, handle_dangling=True)
    with pytest.raises(NotImplementedError, match="leaky"):
        IncrementalPageRank(port(g), handle_dangling=True, device=CPU)


def test_exact_residual_zero_at_fixed_point_and_validates():
    g = port(ref_rmat_graph(7, avg_degree=5, seed=47))
    assert np.abs(exact_residual(g, oracle(g))).sum() < 1e-11
    with pytest.raises(ValueError, match="shape"):
        exact_residual(g, np.zeros(g.n + 1))


def test_noop_batch_and_initial_report():
    g = port(ref_rmat_graph(6, seed=0))
    ipr = IncrementalPageRank(g, variant="blocked_nosync", tol=TOL, device=CPU,
                              block=16)
    rep = ipr.apply()
    assert rep.mode == "noop" and rep.num_ops == 0
    assert rep.l1_cert == ipr.certificate <= TOL
    r = ipr.init_report
    assert r["iterations"] > 0 and r["refine_pushes"] > 0
    assert r["solve_s"] >= 0 and r["refine_s"] >= 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        IncrementalPageRank(port(ref_rmat_graph(6, seed=0)), variant="blocked")


# ---------------------------------------------------------------------------
# PPREngine.apply_updates
# ---------------------------------------------------------------------------

BACKENDS = {"torch": {}, "cuda": {"block": 64}}


def _band_check(g, resp, k):
    ref = ppr_numpy(g, teleport_from_seeds([resp.seeds], g.n),
                    threshold=1e-12)[0][0]
    kth = np.sort(ref)[::-1][k - 1]
    assert (ref[resp.indices] >= kth - 1e-6).all()
    assert np.abs(resp.values - ref[resp.indices]).max() < 1e-5


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_answers_track_the_updated_graph(backend):
    g = port(ref_rmat_graph(8, avg_degree=6, seed=7))
    eng = PPREngine(g, slots=4, threshold=1e-8, backend=backend, device=CPU,
                    **BACKENDS[backend])
    k = 8
    eng.drain([PPRQuery(qid=0, seeds=(3,), top_k=k)])
    adds, dels = random_update_batch(eng.g, np.random.default_rng(8), 30)
    seen = []
    eng.update_callbacks.append(seen.append)
    delta = eng.apply_updates(adds=adds, dels=dels)
    assert delta.num_ops == 30 and seen == [delta] and isinstance(delta, GraphDelta)
    assert eng.device == torch.device(CPU)
    assert eng.cache_block == BACKENDS[backend].get("block", 256)
    r = eng.drain([PPRQuery(qid=1, seeds=(3,), top_k=k)])[0]
    _band_check(eng.g, r, k)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_drops_the_references_warm_cache_keys(backend):
    """The warm cache keeps rows whose seeds share no cache block with a
    touched vertex; the reference's engine (its jax backend, with the same
    ``block`` option as the invalidation width) drops the same keys."""
    g = ref_rmat_graph(8, avg_degree=6, seed=9)
    opts = BACKENDS[backend]
    eng = PPREngine(port(g), slots=3, threshold=1e-6, backend=backend,
                    device=CPU, **opts)
    ref = RefPPREngine(g, slots=3, threshold=1e-6, backend="jax", **opts)
    seed_sets = [(), (1,), (70,), (130, 131), (200,), (250, 3)]
    eng.drain([PPRQuery(qid=i, seeds=s, top_k=4) for i, s in enumerate(seed_sets)])
    ref.drain([RefPPRQuery(qid=i, seeds=s, top_k=4) for i, s in enumerate(seed_sets)])
    assert set(eng._cache) == set(ref._cache)
    rng_a, rng_b = np.random.default_rng(10), np.random.default_rng(10)
    for _ in range(3):
        eng.apply_updates(*random_update_batch(eng.g, rng_a, 2))
        ref.apply_updates(*ref_random_update_batch(ref.g, rng_b, 2))
        assert set(eng._cache) == set(ref._cache)
        assert () not in eng._cache
    assert eng.cache_block == ref.cache_block


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_engine_update_rejected_with_active_slots(backend):
    g = port(ref_rmat_graph(6, avg_degree=4, seed=11))
    eng = PPREngine(g, slots=2, threshold=1e-7, backend=backend, device=CPU,
                    **BACKENDS[backend])
    assert eng.submit(PPRQuery(qid=0, seeds=(1,), top_k=4))
    with pytest.raises(RuntimeError, match="active"):
        eng.apply_updates(adds=[[0, 1]])
    assert eng.g is g
    # drained, an empty batch keeps the graph and the backend
    eng.drain([])
    backend_obj = eng._backend
    assert eng.apply_updates().num_ops == 0 and eng._backend is backend_obj
