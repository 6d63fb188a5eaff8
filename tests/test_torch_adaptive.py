"""The port's residual-adaptive schedules against the JAX reference, on the
CPU.

* The gain certificates (``partition_gain_matrix``,
  ``vertex_gain_matrix``) are host numpy float64 copies: equal to the
  reference's (``np.array_equal``), weighted and unweighted; the bundles
  carry them rounded once to float32, equal to the reference's too.
* ``nosync_adaptive`` against the reference's ``nosync_adaptive`` (same
  ``threads``), with and without dangling redistribution: the same
  iterations and ranks within 2e-6 L1 at threshold 1e-7 (the parity
  threshold of ``tests/test_torch_solver.py``, well above the float32
  floor of these ranks).  Sweeps are compared too: they come out equal
  here.  The one place the two packages round differently inside the
  schedule is ``gain @ deltas`` (``torch.mv`` against XLA's dot), which
  could flip a unit whose bound sits within rounding of the cut.  The
  residual trajectory is held within ``1e-6 · max|pr| · (1 + d·‖gain‖∞)``:
  a swept unit's residual is a difference of ranks that agree to float32
  rounding (1e-6 × max|pr|, as in ``tests/test_torch_solver.py``), and a
  skipped unit's residual is its certified bound, ``d · gain @ Δ`` summed
  over rounds, which carries a delta's rounding times up to the gain's
  largest row sum.
* ``blocked_adaptive`` (``gs_pass_ref`` on the CPU) against the
  reference's own ``freeze_adaptive_schedule`` and ``solve``, driven by a
  test-local jnp blocked Gauss–Seidel sweep with the semantics of
  ``gs_pass_ref`` (the reference's Pallas pass does not trace under the
  installed jax): the same iterations and block sweeps, ranks within 1e-6
  max abs, and the residual trajectory within the bound above, with the
  block certificate's row sums.
* Every new variant within L1 < 1e-6 of the float64 oracle at threshold
  1e-9 on BFS-reordered webStanford and rmatSkew at scale_down 256, and on
  ``tests/test_adaptive.py``'s dangling graph with redistribution.
* The reference's headline on the port: at p = 16, tol 1e-8, BFS-reordered
  scale_down 64, ``nosync_adaptive`` takes at most 0.9× the partition
  sweeps of ``nosync`` and at most its iterations + 2.
* With dangling redistribution both adaptive schedules leave an L1 to the
  oracle that grows with n (their certificate is in max norm): on
  BFS-ordered webStanford the port's L1 is the reference's within 2 %, for
  ``nosync_adaptive`` at scale_down 64 and ``blocked_adaptive`` at
  scale_down 16, block 256.
"""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pagerank import PartitionedGraph as RefPartitionedGraph
from repro.core.pagerank import partition_gain_matrix as ref_partition_gain
from repro.core.pagerank import vertex_gain_matrix as ref_vertex_gain
from repro.core.solver import freeze_adaptive_schedule as ref_freeze_adaptive
from repro.core.solver import solve as ref_solve
from repro.core.solver import solve_variant as ref_solve_variant
from repro.graphs import make_dataset as ref_make_dataset
from repro.graphs.csr import Graph as RefGraph
from repro.graphs.reorder import compute_order as ref_compute_order
from repro.graphs.reorder import permute_graph as ref_permute_graph
from repro_torch.core.pagerank import (
    PartitionedGraph,
    l1_norm,
    pagerank_nosync_adaptive,
    pagerank_numpy,
    partition_gain_matrix,
    vertex_gain_matrix,
)
from repro_torch.core.solver import get_variant, list_variants, solve_variant
from repro_torch.graphs import (
    compute_order,
    graph_from_arrays,
    make_dataset,
    permute_graph,
)
from repro_torch.kernels.spmv import BlockedGraph, pagerank_blocked
from test_solver import SURROGATES
from test_torch_solver import PARITY_THRESH

CPU = "cpu"
THRESH = 1e-9
TOL = 1e-8
NEW_VARIANTS = ("nosync_adaptive", "blocked_adaptive", "barrier_edge",
                "barrier_identical")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


def ref_bfs(name, scale_down):
    g = ref_make_dataset(name, scale_down=scale_down)
    return ref_permute_graph(g, ref_compute_order(g, "bfs"))


def dangling_graph():
    """``tests/test_adaptive.py``'s graph: the top 8 ids keep out-degree 0."""
    rng = np.random.default_rng(11)
    n, m = 64, 280
    g = RefGraph.from_edges(n, rng.integers(0, n - 8, m), rng.integers(0, n, m))
    assert (g.out_degree == 0).any()
    return g


def weighted(g, seed=2):
    rng = np.random.default_rng(seed)
    return RefGraph.from_edges(g.n, g.src, g.dst,
                               weights=rng.uniform(0.2, 1.0, g.m),
                               bias=rng.uniform(0.5, 1.5, g.n))


GRAPHS = {
    "web256": lambda: ref_bfs("webStanford", 256),
    "skew256": lambda: ref_bfs("rmatSkew", 256),
    "dangling": dangling_graph,
}


@pytest.fixture(scope="module")
def graphs():
    return {name: make() for name, make in GRAPHS.items()}


# ---------------------------------------------------------------------------
# the gain certificates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_weighted", [False, True])
@pytest.mark.parametrize("gname", ["web256", "dangling"])
def test_gain_matrices_equal_reference(graphs, gname, is_weighted):
    ref = graphs[gname]
    if is_weighted:
        ref = weighted(ref)
    g = port(ref)
    for unit, p in ((64, -(-g.n // 64)), (16, -(-g.n // 16))):
        got = partition_gain_matrix(g, unit, p)
        assert got.dtype == np.float64 and got.shape == (p, p)
        assert np.array_equal(got, ref_partition_gain(ref, unit, p))
    for p in (4, 16):
        vp = -(-g.n // p)
        got = vertex_gain_matrix(g, vp, p, vp * p)
        assert got.dtype == np.float64 and got.shape == (vp * p, p)
        assert np.array_equal(got, ref_vertex_gain(ref, vp, p, vp * p))


def test_bundles_carry_the_reference_gain(graphs):
    ref = weighted(graphs["web256"])
    g = port(ref)
    pg = PartitionedGraph.from_graph(g, p=4, device=CPU)
    assert pg.gain.dtype == torch.float32
    assert np.array_equal(pg.gain.numpy(),
                          np.asarray(RefPartitionedGraph.from_graph(ref, p=4).gain))
    bg = BlockedGraph.build(g, block=64, device=CPU, gain=True)
    assert bg.gain.shape == (bg.n_blocks, bg.n_blocks)
    assert np.array_equal(bg.gain.numpy(),
                          ref_partition_gain(ref, 64, bg.n_blocks).astype(np.float32))
    assert BlockedGraph.build(g, block=64, device=CPU).gain is None


# ---------------------------------------------------------------------------
# nosync_adaptive against the reference's
# ---------------------------------------------------------------------------


def assert_residuals(got, ref, gain, d=0.85):
    """The residual trajectories agree within 1e-6 · max|pr| · (1 +
    d·‖gain‖∞) (module docstring), and both end at the same iteration."""
    it = int(ref.iterations)
    pr_max = float(np.abs(np.asarray(ref.pr)).max())
    tol = 1e-6 * pr_max * (1.0 + d * float(np.abs(gain).sum(axis=1).max()))
    res_ref = np.asarray(ref.residuals)[:it]
    assert np.abs(got.residuals.numpy()[:it] - res_ref).max() <= tol
    assert np.all(np.isinf(got.residuals.numpy()[it:]))


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_nosync_adaptive_matches_reference(graphs, gname, handle_dangling):
    ref_g = graphs[gname]
    kw = dict(threshold=PARITY_THRESH, handle_dangling=handle_dangling, threads=4)
    ref = ref_solve_variant("nosync_adaptive", ref_g, **kw)
    got = solve_variant("nosync_adaptive", port(ref_g), device=CPU, **kw)
    assert got.iterations == int(ref.iterations)
    assert got.sweeps == int(ref.sweeps)
    assert l1_norm(got.pr, np.asarray(ref.pr)) <= 2e-6
    vp = -(-ref_g.n // 4)
    assert_residuals(got, ref, ref_vertex_gain(ref_g, vp, 4, 4 * vp))


# ---------------------------------------------------------------------------
# blocked_adaptive against the reference's freeze_adaptive_schedule
# ---------------------------------------------------------------------------


def jnp_blocked_gs_sweep(g, block, d, handle_dangling):
    """A jnp blocked Gauss–Seidel pass with ``gs_pass_ref``'s semantics:
    dst blocks committed in order, each summing ``pr·inv_out`` of the state
    as it stands, frozen lanes keeping their value; ``frozen`` is the
    reference schedule's float mask."""
    n = g.n
    n_blocks = -(-n // block)
    n_pad = n_blocks * block
    inv = np.zeros(n_pad, np.float32)
    inv[:n] = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    dang = np.zeros(n_pad, np.float32)
    dang[:n] = g.out_degree == 0
    vm = (np.arange(n_pad) < n).astype(np.float32)
    ptr = np.full(n_pad + 1, g.m, np.int64)
    ptr[:n + 1] = g.in_ptr
    base = (1.0 - d) / n
    inv, dang, vmj = jnp.asarray(inv), jnp.asarray(dang), jnp.asarray(vm)

    def sweep(pr, frozen):
        dmass = (d * (jnp.sum(pr * dang.reshape(pr.shape)) / n)
                 if handle_dangling else jnp.asarray(0.0, jnp.float32))
        out = pr.reshape(-1)
        fz = frozen.reshape(-1) > 0
        for db in range(n_blocks):
            v0, v1 = db * block, (db + 1) * block
            e0, e1 = ptr[v0], ptr[v1]
            s = jnp.asarray(g.src[e0:e1])
            vals = out[s] * inv[s]
            seg = jnp.asarray(np.repeat(np.arange(block), np.diff(ptr[v0:v1 + 1])))
            acc = jax.ops.segment_sum(vals, seg, num_segments=block,
                                      indices_are_sorted=True)
            new = (base * vmj[v0:v1] + dmass + d * acc) * vmj[v0:v1]
            out = out.at[v0:v1].set(jnp.where(fz[v0:v1], out[v0:v1], new))
        return out.reshape(pr.shape)

    return sweep, n_blocks, jnp.asarray(vm.reshape(n_blocks, block)), dang


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_blocked_adaptive_matches_reference_schedule(graphs, gname,
                                                     handle_dangling):
    ref_g = graphs[gname]
    g = port(ref_g)
    block, d = 64 if g.n > 64 else 16, 0.85
    sweep, n_blocks, vm, dang = jnp_blocked_gs_sweep(ref_g, block, d,
                                                     handle_dangling)
    gain = jnp.asarray(ref_partition_gain(ref_g, block, n_blocks), jnp.float32)
    if handle_dangling:
        gain = gain + (jnp.sum(dang.reshape(n_blocks, block), axis=1) / g.n)[None, :]
    step = ref_freeze_adaptive(sweep, threshold=PARITY_THRESH, d=d, gain=gain)
    ref = ref_solve(step, jnp.full((n_blocks, block), 1.0 / g.n, jnp.float32) * vm,
                    n_units=n_blocks, threshold=PARITY_THRESH, max_iter=1000,
                    aux0=jnp.full((n_blocks,), jnp.inf, jnp.float32))
    bg = BlockedGraph.build(g, block=block, device=CPU, gain=True)
    got = pagerank_blocked(bg, d=d, threshold=PARITY_THRESH, max_iter=1000,
                           schedule="adaptive", handle_dangling=handle_dangling)
    assert got.iterations == int(ref.iterations)
    assert got.sweeps == int(ref.sweeps)
    pr_ref = np.asarray(ref.pr).reshape(-1)[:g.n]
    assert np.abs(got.pr.numpy() - pr_ref).max() <= 1e-6
    assert_residuals(got, ref._replace(pr=pr_ref), np.asarray(gain), d)


def test_blocked_adaptive_freezes_whole_blocks(graphs):
    """Late in a solve most blocks are frozen, and a frozen block's ranks
    are held: fewer block sweeps than passes × n_blocks."""
    g = port(graphs["web256"])
    bg = BlockedGraph.build(g, block=64, device=CPU, gain=True)
    r = pagerank_blocked(bg, threshold=TOL, schedule="adaptive")
    assert bg.n_blocks <= r.sweeps < r.iterations * bg.n_blocks


# ---------------------------------------------------------------------------
# fixed point: every new variant at the float64 oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gname", ["web256", "skew256"])
@pytest.mark.parametrize("vname", NEW_VARIANTS)
def test_new_variants_reach_oracle(graphs, gname, vname):
    g = port(graphs[gname])
    ref, _ = pagerank_numpy(g, threshold=1e-13)
    r = solve_variant(vname, g, threshold=THRESH, threads=4, block=64, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6, vname
    assert r.pr.shape == (g.n,) and r.iterations >= 1


@pytest.mark.parametrize("vname", NEW_VARIANTS)
def test_new_variants_reach_oracle_with_dangling(graphs, vname):
    """The dangling fold into the gain (``gain + |dangling ∩ j|/n``) keeps
    the skip certificate sound when redistributed mass moves with every
    update."""
    g = port(graphs["dangling"])
    ref, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=True)
    r = solve_variant(vname, g, threshold=THRESH, handle_dangling=True,
                      threads=4, block=16, device=CPU)
    assert l1_norm(r.pr, ref) < 1e-6, vname


# ---------------------------------------------------------------------------
# the reference's headline, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["webStanford", "rmatSkew"])
def test_nosync_adaptive_sheds_sweeps(name):
    g = make_dataset(name, scale_down=64)
    g = permute_graph(g, compute_order(g, "bfs"))
    rn = solve_variant("nosync", g, threshold=TOL, threads=16, device=CPU)
    ra = solve_variant("nosync_adaptive", g, threshold=TOL, threads=16, device=CPU)
    assert ra.err <= TOL and rn.err <= TOL
    assert ra.sweeps <= 0.9 * rn.sweeps, (ra.sweeps, rn.sweeps)
    assert ra.iterations <= rn.iterations + 2
    assert l1_norm(ra.pr, rn.pr) < 1e-5


def test_adaptive_dangling_l1_is_the_references():
    """With dangling redistribution the adaptive schedule leaves a one-signed
    residual of up to its cut at the vertices it skips (the dangling mass a
    skipped partition last saw), so its L1 to the oracle grows with n: the
    certificate is in max norm.  That is the reference's behaviour, not the
    port's: on BFS-ordered webStanford at scale_down 64, p = 16, threshold
    1e-7 (parity), both packages' L1 agree within 2 % and are at least 5×
    ``nosync``'s."""
    ref_g = ref_bfs("webStanford", 64)
    oracle, _ = pagerank_numpy(port(ref_g), threshold=1e-13, handle_dangling=True)
    kw = dict(threshold=PARITY_THRESH, handle_dangling=True, threads=16)
    ref = ref_solve_variant("nosync_adaptive", ref_g, **kw)
    got = solve_variant("nosync_adaptive", port(ref_g), device=CPU, **kw)
    plain = solve_variant("nosync", port(ref_g), device=CPU, **kw)
    l1_ref = l1_norm(np.asarray(ref.pr), oracle)
    l1_got = l1_norm(got.pr, oracle)
    assert got.iterations == int(ref.iterations) and got.sweeps == int(ref.sweeps)
    assert abs(l1_got - l1_ref) <= 0.02 * l1_ref
    assert l1_got >= 5 * l1_norm(plain.pr, oracle)


def test_blocked_adaptive_dangling_l1_is_the_references():
    """The same for the whole-block schedule, at the block size and order
    of ``chip_smoke.py``'s adaptive phase (block 256, BFS order) on
    webStanford at scale_down 16 (69 blocks), threshold 1e-7: the port's
    ``blocked_adaptive`` and the reference's ``freeze_adaptive_schedule``
    and ``solve`` over the jnp sweep take the same iterations and block
    sweeps, their L1 to the oracle agree within 2 %, and both are at least
    5× ``blocked_nosync``'s."""
    ref_g = ref_bfs("webStanford", 16)
    g = port(ref_g)
    block, d = 256, 0.85
    oracle, _ = pagerank_numpy(g, threshold=1e-13, handle_dangling=True)
    sweep, n_blocks, vm, dang = jnp_blocked_gs_sweep(ref_g, block, d, True)
    gain = jnp.asarray(ref_partition_gain(ref_g, block, n_blocks), jnp.float32)
    gain = gain + (jnp.sum(dang.reshape(n_blocks, block), axis=1) / g.n)[None, :]
    step = ref_freeze_adaptive(sweep, threshold=PARITY_THRESH, d=d, gain=gain)
    ref = ref_solve(step, jnp.full((n_blocks, block), 1.0 / g.n, jnp.float32) * vm,
                    n_units=n_blocks, threshold=PARITY_THRESH, max_iter=1000,
                    aux0=jnp.full((n_blocks,), jnp.inf, jnp.float32))
    bg = BlockedGraph.build(g, block=block, device=CPU, gain=True)
    kw = dict(d=d, threshold=PARITY_THRESH, handle_dangling=True)
    got = pagerank_blocked(bg, schedule="adaptive", **kw)
    plain = pagerank_blocked(bg, schedule="nosync", **kw)
    l1_ref = l1_norm(np.asarray(ref.pr).reshape(-1)[:g.n], oracle)
    l1_got = l1_norm(got.pr, oracle)
    assert got.iterations == int(ref.iterations) and got.sweeps == int(ref.sweeps)
    assert abs(l1_got - l1_ref) <= 0.02 * l1_ref
    assert l1_ref >= 5 * l1_norm(plain.pr, oracle)


# ---------------------------------------------------------------------------
# registry metadata and the build checks
# ---------------------------------------------------------------------------


def test_adaptive_variants_registered():
    assert {v for v in list_variants()
            if get_variant(v).schedule == "adaptive"} == {"nosync_adaptive",
                                                          "blocked_adaptive",
                                                          "ppr_push_priority"}
    v = get_variant("blocked_adaptive")
    assert (v.layout, v.backend) == ("blocked_gain", "cuda")
    v = get_variant("nosync_adaptive")
    assert (v.layout, v.backend) == ("partitioned", "torch")


def test_blocked_adaptive_keeps_the_warm_start():
    g = port(SURROGATES["rmat"]())
    pr0, _ = pagerank_numpy(g, threshold=1e-4)
    cold = solve_variant("blocked_adaptive", g, threshold=PARITY_THRESH,
                         block=64, device=CPU)
    warm = solve_variant("blocked_adaptive", g, threshold=PARITY_THRESH,
                         block=64, device=CPU, pr0=pr0)
    assert warm.iterations < cold.iterations
    assert l1_norm(warm.pr, pagerank_numpy(g, threshold=1e-12)[0]) < 1e-5


def test_nosync_adaptive_needs_the_gain():
    g = port(SURROGATES["rmat"]())
    pg = PartitionedGraph.from_graph(g, p=4, device=CPU)
    pg.gain = None
    with pytest.raises(ValueError, match="gain"):
        pagerank_nosync_adaptive(pg)
