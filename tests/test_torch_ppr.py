"""The port's batched PPR (``repro_torch.ppr``), its engine pieces
(``row_freeze``, ``batched_barrier_schedule``) and the plain version of the
``gs_pass_multi`` kernel, on the CPU, against the JAX reference on the
three ``tests/test_solver.py`` surrogates with dangling redistribution off
and on.

Tolerances:

* the seed/teleport helpers, ``ppr_numpy`` and ``topk`` are numpy copies:
  equal bit for bit;
* ``row_freeze`` and ``batched_barrier_schedule``: the same outputs on the
  same float32 tensors, bit for bit (elementwise ops and a max);
* ``ppr_barrier``/``ppr_nosync`` against the reference's at threshold
  ``PPR_PARITY_THRESH`` = 1e-6: the same iterations and sweeps, ranks
  within 1e-6 max abs.  Not at the global tests' 1e-7: a PPR row peaks at
  0.15–1.0 (the seed's own mass), where a float32 ulp is 1.5e-8–6e-8, so a
  residual of 1e-7 is a few ulps and the two packages' rounding (XLA
  contracts ``(1-d)·t + d·acc`` into a fused multiply-add, torch does
  not) decides whether it stops (lattice: 77 against 78 iterations at
  1e-7); 1e-6 is 16 or more ulps of the largest rank;
* ``gs_pass_multi_ref`` after ``k`` passes against the reference's
  ``ppr_nosync`` with one partition per dst block (the Pallas kernel does
  not trace under the installed JAX): within 1e-6 × max|pr|, float32 sums
  and the base ``tele·((1-d) + d·dmass)`` taken in another order;
* ``ppr_blocked`` against the float64 oracle: per-row L1 < 1e-5 at
  threshold 1e-9 (the reference's own bar for ``ppr_pallas``).
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import DeviceGraph as RefDeviceGraph
from repro.core import PartitionedGraph as RefPartitionedGraph
from repro.core.solver import batched_barrier_schedule as ref_bbs
from repro.core.solver import row_freeze as ref_row_freeze
from repro.core.solver import solve as ref_solve
from repro.ppr import batched as ref_batched
from repro.ppr import topk as ref_topk
from repro_torch.core.pagerank import (
    DeviceGraph,
    PartitionedGraph,
    l1_norm,
    pagerank_numpy,
)
from repro_torch.core.solver import (
    EngineState,
    batched_barrier_schedule,
    build_variant,
    get_variant,
    row_freeze,
    solve,
    solve_variant,
)
from repro_torch.graphs import Graph, rmat_graph
from repro_torch.kernels.spmv import (
    BlockedGraph,
    gs_pass_multi,
    gs_pass_multi_ref,
    gs_pass_ref,
    launch_counts,
)
from repro_torch.kernels.spmv.kernel import MAX_BATCH, gs_pass_multi_max_batch
from repro_torch.launch import pagerank_run
from repro_torch.ppr import batched, topk
from repro_torch.ppr.batched import (
    blocked_rows,
    ppr_barrier,
    ppr_blocked,
    ppr_nosync,
    read_blocked_row,
    unblocked_rows,
    write_blocked_row,
)
from test_solver import SURROGATES
from test_torch_solver import port
from test_torch_spmv import GRAPHS

D = 0.85
CPU = torch.device("cpu")
SEED_BATCH = [(3,), (10, 11, 12), (), (7, 3)]
PPR_PARITY_THRESH = 1e-6  # see the module docstring


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# host helpers: numpy copies, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, 3, np.int64(4), (3, 5), [(3,), (5, 6), ()],
                                  [], [7, (1, 1, 2)], [(9, 9)]])
def test_seed_helpers_match_reference(spec):
    assert batched.normalize_seeds(spec) == ref_batched.normalize_seeds(spec)
    for n_pad in (None, 16):
        a = batched.teleport_from_seeds(spec, 12, n_pad=n_pad)
        b = ref_batched.teleport_from_seeds(spec, 12, n_pad=n_pad)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_teleport_rejects_out_of_range_like_reference():
    for bad in ([(12,)], [(-1,)]):
        with pytest.raises(ValueError, match="out of range"):
            batched.teleport_from_seeds(bad, 12)
        with pytest.raises(ValueError, match="out of range"):
            ref_batched.teleport_from_seeds(bad, 12)


def test_teleport_like_and_bias_scaled_match_reference():
    rng = np.random.default_rng(0)
    t = rng.random((3, 10))
    for n_pad in (10, 13):
        np.testing.assert_array_equal(
            batched.teleport_from_seeds_like(t, 10, n_pad),
            ref_batched.teleport_from_seeds_like(t, 10, n_pad))
    bias = rng.uniform(0.5, 1.5, 10)
    padded = batched.teleport_from_seeds_like(t, 10, 13)
    for tele in (t, padded, padded[0], t.astype(np.float32)):
        for bz in (None, bias):
            np.testing.assert_array_equal(batched.bias_scaled(tele, bz),
                                          ref_batched.bias_scaled(tele, bz))


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_ppr_numpy_is_the_reference_oracle(gname, handle_dangling):
    g = GRAPHS[gname][0]()
    tele = ref_batched.teleport_from_seeds(SEED_BATCH, g.n)
    a, ia = ref_batched.ppr_numpy(g, tele, threshold=1e-12,
                                  handle_dangling=handle_dangling)
    b, ib = batched.ppr_numpy(port(g), tele, threshold=1e-12,
                              handle_dangling=handle_dangling)
    assert ia == ib
    np.testing.assert_array_equal(a, b)


def test_topk_matches_reference_with_ties():
    rng = np.random.default_rng(3)
    est = rng.integers(0, 5, 200).astype(np.float64) / 7
    for k in (0, 1, 10, 57, 200, 300):
        i_a, v_a = topk(est, k)
        i_b, v_b = ref_topk(est, k)
        np.testing.assert_array_equal(i_a, i_b)
        np.testing.assert_array_equal(v_a, v_b)
    idx, _ = topk(np.asarray([0.5, 0.1, 0.1, 0.3]), 3)
    assert idx.tolist() == [0, 3, 1]


# ---------------------------------------------------------------------------
# engine pieces: row_freeze and batched_barrier_schedule
# ---------------------------------------------------------------------------


def _freeze_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    old = rng.random(shape).astype(np.float32)
    # rows 0 and 2 barely move, row 1 moves, and part of row 3 is frozen
    scale = np.array([1e-9, 1e-2, 0.0, 1e-3], np.float32)
    new = old + rng.standard_normal(shape).astype(np.float32) * scale.reshape(
        [-1 if a == 0 else 1 for a in range(len(shape))])
    frozen = np.zeros(shape, bool)
    frozen[3] = rng.random(shape[1:]) < 0.5
    return old, new, frozen


@pytest.mark.parametrize("threshold", [1e-7, 1e-3])
@pytest.mark.parametrize("shape,axes", [((4, 9), (-1,)), ((4, 3, 5), (1, 2))])
def test_row_freeze_matches_reference(shape, axes, threshold):
    old, new, frozen = _freeze_inputs(shape, seed=len(shape))
    ref_new, ref_fz = ref_row_freeze(threshold, axes)(
        jax.numpy.asarray(old), jax.numpy.asarray(new), jax.numpy.asarray(frozen))
    got_new, got_fz = row_freeze(threshold, axes)(
        torch.as_tensor(old), torch.as_tensor(new), torch.as_tensor(frozen))
    np.testing.assert_array_equal(got_new.numpy(), np.asarray(ref_new))
    np.testing.assert_array_equal(got_fz.numpy(), np.asarray(ref_fz))


def test_row_freeze_masks_before_the_row_error():
    # a frozen lane's large proposed change must not keep its row live
    old = torch.zeros(2, 3)
    new = torch.tensor([[5.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    frozen = torch.tensor([[True, False, False], [False, False, False]])
    got_new, got_fz = row_freeze(1e-6)(old, new, frozen)
    assert got_new[0].tolist() == [0.0, 0.0, 0.0]
    assert got_fz[0].all() and not got_fz[1].any()


@pytest.mark.parametrize("row_axes", [None, (0, 2)])
def test_batched_barrier_schedule_matches_reference(row_axes):
    rng = np.random.default_rng(1)
    shape = (4, 6) if row_axes is None else (3, 4, 5)
    pr0 = rng.random(shape).astype(np.float32)
    coef = np.float32(0.5)

    def ref_err(new, old):
        return jax.numpy.max(jax.numpy.abs(new - old), axis=row_axes)

    def port_err(new, old):
        return torch.amax(torch.abs(new - old), dim=row_axes)

    thr = 1e-3
    axes = (-1,) if row_axes is None else row_axes
    ref_step = ref_bbs(lambda pr: pr * coef, (ref_row_freeze(thr, axes),),
                       row_error=None if row_axes is None else ref_err)
    port_step = batched_barrier_schedule(
        lambda pr: pr * coef, (row_freeze(thr, axes),),
        row_error=None if row_axes is None else port_err)
    b = shape[0] if row_axes is None else shape[1]
    ref = ref_solve(ref_step, jax.numpy.asarray(pr0), n_units=b, threshold=thr,
                    max_iter=50, track_frozen=True)
    got = solve(port_step, torch.as_tensor(pr0), n_units=b, threshold=thr,
                max_iter=50, track_frozen=True)
    assert got.iterations == int(ref.iterations) and got.sweeps == int(ref.sweeps)
    np.testing.assert_array_equal(got.pr.numpy(), np.asarray(ref.pr))
    it = got.iterations
    np.testing.assert_array_equal(got.residuals[:it].numpy(),
                                  np.asarray(ref.residuals)[:it])


def test_batched_barrier_schedule_reports_per_row_errors():
    step = batched_barrier_schedule(lambda pr: pr * torch.tensor([[0.5], [1.0]]))
    st = EngineState(torch.ones(2, 3), torch.zeros(0, dtype=torch.bool),
                     torch.full((2,), float("inf")), 0, 0)
    out = step(st)
    assert out.perr.tolist() == [0.5, 0.0] and out.it == 1 and out.sweeps == 1


# ---------------------------------------------------------------------------
# ppr_barrier / ppr_nosync against the reference's
# ---------------------------------------------------------------------------


def _assert_ppr_parity(ref, got, *, sweeps=True):
    assert got.iterations == int(ref.iterations)
    if sweeps:
        assert got.sweeps == int(ref.sweeps)
    pr_ref = np.asarray(ref.pr)
    assert got.pr.shape == pr_ref.shape
    assert np.abs(got.pr.numpy() - pr_ref).max() <= 1e-6


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
def test_ppr_barrier_matches_reference(gname, handle_dangling):
    g = SURROGATES[gname]()
    tele = ref_batched.teleport_from_seeds(SEED_BATCH, g.n)
    ref = ref_batched.ppr_barrier(RefDeviceGraph.from_graph(g), tele,
                                  threshold=PPR_PARITY_THRESH,
                                  handle_dangling=handle_dangling)
    got = ppr_barrier(DeviceGraph.from_graph(port(g), CPU), tele,
                      threshold=PPR_PARITY_THRESH, handle_dangling=handle_dangling)
    _assert_ppr_parity(ref, got)


@pytest.mark.parametrize("thread_level", [True, False])
@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
def test_ppr_nosync_matches_reference(gname, handle_dangling, thread_level):
    g = SURROGATES[gname]()
    ref_pg = RefPartitionedGraph.from_graph(g, p=4)
    tele = ref_batched.teleport_from_seeds(SEED_BATCH, g.n, n_pad=ref_pg.n_pad)
    ref = ref_batched.ppr_nosync(ref_pg, tele, threshold=PPR_PARITY_THRESH,
                                 thread_level=thread_level,
                                 handle_dangling=handle_dangling)
    got = ppr_nosync(PartitionedGraph.from_graph(port(g), p=4, device=CPU), tele,
                     threshold=PPR_PARITY_THRESH, thread_level=thread_level,
                     handle_dangling=handle_dangling)
    _assert_ppr_parity(ref, got)


@pytest.mark.parametrize("vname", ["ppr_barrier", "ppr_nosync"])
def test_weighted_biased_ppr_matches_reference(vname):
    g = GRAPHS["rmat_weighted"][0]()
    kw = dict(threshold=PPR_PARITY_THRESH, seeds=SEED_BATCH, handle_dangling=True,
              threads=4)
    from repro.core.solver import solve_variant as ref_solve_variant

    ref = ref_solve_variant(vname, g, **kw)
    got = solve_variant(vname, port(g), device=CPU, **kw)
    _assert_ppr_parity(ref, got)


# ---------------------------------------------------------------------------
# gs_pass_multi (plain version) against gs_pass and the reference
# ---------------------------------------------------------------------------


def _blocked(gname):
    make, block = GRAPHS[gname]
    g = make()
    return g, BlockedGraph.build(port(g), block=block, device=CPU)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_gs_pass_multi_b1_equals_gs_pass(gname):
    _, bg = _blocked(gname)
    n = bg.n
    rng = np.random.default_rng(2)
    pr = torch.as_tensor(rng.random(bg.vmask.shape).astype(np.float32) / n) * bg.vmask
    base = np.float32((1 - D) / n)
    params = torch.tensor([base, D, 0.0])
    one = gs_pass_ref(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                      bg.weights)
    multi = gs_pass_multi_ref(pr[..., None], bg.inv_out, bg.vmask,
                              bg.vmask[..., None].clone(), torch.tensor([base]),
                              D, bg.in_ptr, bg.src, bg.weights)
    assert torch.equal(multi[..., 0], one)
    # every row of a batch of identical rows is that same pass
    wide = gs_pass_multi_ref(pr[..., None].expand(-1, -1, 3).contiguous(),
                             bg.inv_out, bg.vmask,
                             bg.vmask[..., None].expand(-1, -1, 3).contiguous(),
                             torch.full((3,), float(base)), D, bg.in_ptr,
                             bg.src, bg.weights)
    for j in range(3):
        assert torch.equal(wide[..., j], one)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_gs_pass_multi_holds_frozen_rows(gname):
    g, bg = _blocked(gname)
    tele = torch.as_tensor(blocked_rows(
        batched.teleport_from_seeds(SEED_BATCH, g.n), bg.n_blocks, bg.block))
    rng = np.random.default_rng(4)
    pr = torch.as_tensor(rng.random(tele.shape).astype(np.float32)) * tele.sum()
    frozen = torch.tensor([True, False, True, False])
    coef = torch.full((4,), 1 - D)
    out = gs_pass_multi(pr, bg.inv_out, bg.vmask, tele, coef, D, bg.in_ptr,
                        bg.src, bg.weights, frozen)
    assert torch.equal(out[..., frozen], pr[..., frozen])
    assert not torch.equal(out[..., 1], pr[..., 1])
    live = gs_pass_multi(pr, bg.inv_out, bg.vmask, tele, coef, D, bg.in_ptr,
                         bg.src, bg.weights)
    # freezing rows does not change what the live rows compute
    assert torch.equal(out[..., ~frozen], live[..., ~frozen])


def _port_multi_passes(bg, tele, k, handle_dangling):
    pr = tele.clone()
    for _ in range(k):
        dmass = (torch.sum(pr * bg.dangling[..., None], dim=(0, 1))
                 if handle_dangling else torch.zeros(pr.shape[2]))
        pr = gs_pass_multi_ref(pr, bg.inv_out, bg.vmask, tele,
                               (1.0 - D) + D * dmass, D, bg.in_ptr, bg.src,
                               bg.weights)
    return pr


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_gs_pass_multi_matches_reference_ppr_nosync(gname, k, handle_dangling):
    g, bg = _blocked(gname)
    assert g.n % bg.block == 0
    t = batched.bias_scaled(batched.teleport_from_seeds(SEED_BATCH, g.n), g.bias)
    ref = np.asarray(ref_batched.ppr_nosync(
        RefPartitionedGraph.from_graph(g, p=bg.n_blocks),
        ref_batched.teleport_from_seeds(SEED_BATCH, g.n), threshold=0.0,
        max_iter=k, thread_level=False, handle_dangling=handle_dangling).pr)
    tele = torch.as_tensor(blocked_rows(t.astype(np.float32), bg.n_blocks, bg.block))
    got = unblocked_rows(_port_multi_passes(bg, tele, k, handle_dangling), g.n)
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("k", [1, 2])
def test_gs_pass_multi_reads_the_block_just_committed(k):
    """A chain of blocks: each row of block i + 1 takes its two in-edges
    from block i only, and the seeds sit in block 0, so one pass carries
    their mass down the chain a block a step and every block below the
    first reads the block committed just before it.  Held against the
    reference's ``ppr_nosync`` with one partition per block; a pass that
    summed a block from a copy of the block above taken before it
    committed would leave every block below the second without mass."""
    from repro.graphs.csr import Graph as RefGraph

    block, n_blocks = 16, 6
    n = block * n_blocks
    v = np.arange(block, n)
    src = np.r_[v - block, (v + 1) % block + (v // block - 1) * block]
    g = RefGraph.from_edges(n, src, np.r_[v, v])
    bg = BlockedGraph.build(port(g), block=block, device=CPU)
    seeds = [(0,), (1, 2), (5,)]
    ref = np.asarray(ref_batched.ppr_nosync(
        RefPartitionedGraph.from_graph(g, p=n_blocks),
        ref_batched.teleport_from_seeds(seeds, n), threshold=0.0, max_iter=k,
        thread_level=False, handle_dangling=False).pr)
    tele = torch.as_tensor(blocked_rows(
        batched.teleport_from_seeds(seeds, n).astype(np.float32), n_blocks, block))
    got = unblocked_rows(_port_multi_passes(bg, tele, k, False), n).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert (got.reshape(len(seeds), n_blocks, block).max(axis=2) > 0).all()


def test_gs_pass_multi_checks_operands():
    _, bg = _blocked("rmat")
    b = 2
    st = torch.zeros(bg.n_blocks, bg.block, b)
    coef = torch.zeros(b)
    args = (bg.inv_out, bg.vmask)
    with pytest.raises(ValueError, match="n_blocks, block, b"):
        gs_pass_multi(st[..., 0], *args, st[..., 0], coef, D, bg.in_ptr, bg.src)
    with pytest.raises(ValueError, match="coef"):
        gs_pass_multi(st, *args, st, coef[:1], D, bg.in_ptr, bg.src)
    with pytest.raises(ValueError, match="bool"):
        gs_pass_multi(st, *args, st, coef, D, bg.in_ptr, bg.src,
                      frozen_rows=torch.zeros(b))
    with pytest.raises(ValueError, match="tele"):
        gs_pass_multi(st, *args, st[:, :, :1], coef, D, bg.in_ptr, bg.src)
    wide = torch.zeros(bg.n_blocks, bg.block, MAX_BATCH + 1)
    with pytest.raises(ValueError, match="batch b"):
        gs_pass_multi(wide, *args, wide, torch.zeros(MAX_BATCH + 1), D,
                      bg.in_ptr, bg.src)


def test_gs_pass_multi_ref_rows_are_independent_at_any_width():
    """The plain version has no shared-memory limit: at block 1024 and
    b = 64 (a shape the card's kernel rejects, tests/test_torch_cuda.py)
    each row is its own single-row pass, bit for bit."""
    g = rmat_graph(7, avg_degree=4, seed=0)
    bg = BlockedGraph.build(g, block=1024, device=CPU)
    b = 64
    gen = torch.Generator().manual_seed(7)
    st = torch.rand(bg.n_blocks, bg.block, b, generator=gen) * bg.vmask[..., None]
    tele = torch.rand(st.shape, generator=gen) * bg.vmask[..., None]
    coef = torch.rand(b, generator=gen)
    frozen = torch.arange(b) % 5 == 0
    out = gs_pass_multi(st, bg.inv_out, bg.vmask, tele, coef, D, bg.in_ptr,
                        bg.src, frozen_rows=frozen)
    for j in range(b):
        one = gs_pass_multi_ref(st[..., j:j + 1].contiguous(), bg.inv_out,
                                bg.vmask, tele[..., j:j + 1].contiguous(),
                                coef[j:j + 1], D, bg.in_ptr, bg.src,
                                frozen_rows=frozen[j:j + 1])
        assert torch.equal(out[..., j], one[..., 0])


# ---------------------------------------------------------------------------
# ppr_blocked: the oracle, teleport linearity, layout helpers, registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
def test_ppr_blocked_reaches_oracle_per_row(gname, handle_dangling):
    g = port(SURROGATES[gname]())
    oracle, _ = batched.ppr_numpy(g, batched.teleport_from_seeds(SEED_BATCH, g.n),
                                  threshold=1e-12, handle_dangling=handle_dangling)
    before = launch_counts()
    r = solve_variant("ppr_blocked", g, threshold=1e-9, seeds=SEED_BATCH,
                      handle_dangling=handle_dangling, block=64, device=CPU)
    assert launch_counts() == before  # the CPU runs the plain version
    pr = r.pr.double().numpy()
    assert pr.shape == (len(SEED_BATCH), g.n) and r.sweeps == r.iterations > 0
    for i in range(len(SEED_BATCH)):
        assert np.abs(pr[i] - oracle[i]).sum() < 1e-5, i


def test_ppr_blocked_weighted_biased_reaches_oracle():
    g = port(GRAPHS["rmat_weighted"][0]())
    oracle, _ = batched.ppr_numpy(g, batched.teleport_from_seeds(SEED_BATCH, g.n),
                                  threshold=1e-12)
    r = solve_variant("ppr_blocked", g, threshold=1e-9, seeds=SEED_BATCH,
                      block=64, device=CPU)
    for i in range(len(SEED_BATCH)):
        assert np.abs(r.pr[i].double().numpy() - oracle[i]).sum() < 1e-5, i


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
def test_ppr_blocked_uniform_row_is_global_pagerank(gname, handle_dangling):
    """Teleport linearity: the uniform row of a batch is the global
    fixed point, the oracle's and the global ``blocked`` solve's."""
    g = port(SURROGATES[gname]())
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    r = solve_variant("ppr_blocked", g, threshold=1e-9, seeds=[(), (3,)],
                      handle_dangling=handle_dangling, block=64, device=CPU)
    glob = solve_variant("blocked", g, threshold=1e-9, block=64,
                         handle_dangling=handle_dangling, device=CPU)
    assert l1_norm(r.pr[0], ref) < 1e-5
    assert l1_norm(r.pr[0], glob.pr) < 1e-5


def test_ppr_blocked_row_freeze_exits_rows_independently():
    g = rmat_graph(7, avg_degree=5, seed=5)
    sinks = np.flatnonzero(g.out_degree == 0)
    sink = int(sinks[0]) if sinks.size else 0
    seeds = [(sink,), ()]
    oracle, _ = batched.ppr_numpy(g, batched.teleport_from_seeds(seeds, g.n),
                                  threshold=1e-12)
    bg = BlockedGraph.build(g, block=32, device=CPU)
    r = ppr_blocked(bg, batched.teleport_from_seeds(seeds, g.n), threshold=1e-9)
    for i in range(2):
        assert np.abs(r.pr[i].double().numpy() - oracle[i]).sum() < 1e-5


@pytest.mark.parametrize("b", [MAX_BATCH + 1, 2 * MAX_BATCH + 2])  # 65, 130
def test_ppr_blocked_takes_more_rows_than_one_launch(b):
    """A batch wider than one gs_pass_multi launch goes through in chunks
    of rows.  It matches the reference's ppr_nosync with one partition per
    dst block (the same passes), each row is what the first chunk alone gives it bit for
    bit (rows freeze one by one), and every row reaches the float64
    oracle within L1 1e-5 at threshold 1e-9."""
    g, bg = _blocked("rmat")
    assert gs_pass_multi_max_batch(bg.block, CPU) == MAX_BATCH < b
    rng = np.random.default_rng(b)
    seeds = [tuple(int(s) for s in rng.choice(g.n, rng.integers(1, 4), replace=False))
             for _ in range(b)]
    ref_pg = RefPartitionedGraph.from_graph(g, p=bg.n_blocks)
    ref = ref_batched.ppr_nosync(
        ref_pg, ref_batched.teleport_from_seeds(seeds, g.n, n_pad=ref_pg.n_pad),
        threshold=PPR_PARITY_THRESH, thread_level=False, handle_dangling=True)
    tele = batched.teleport_from_seeds(seeds, g.n)
    before = launch_counts()
    got = ppr_blocked(bg, tele, threshold=PPR_PARITY_THRESH, handle_dangling=True)
    assert launch_counts() == before  # the CPU runs the plain version
    # the same passes; the reference counts p sweeps a pass
    assert got.iterations == int(ref.iterations) and got.sweeps == got.iterations
    # each package stops a row within thr·d/(1-d) of its fixed point, so the
    # two lie within twice that (3.1e-6 apart at b = 4, with no chunks)
    assert np.abs(got.pr.numpy() - np.asarray(ref.pr)).max() <= (
        2 * PPR_PARITY_THRESH * D / (1 - D))
    head = ppr_blocked(bg, tele[:MAX_BATCH], threshold=PPR_PARITY_THRESH,
                       handle_dangling=True)
    assert torch.equal(got.pr[:MAX_BATCH], head.pr)

    oracle, _ = batched.ppr_numpy(port(g), tele, threshold=1e-12, handle_dangling=True)
    r = solve_variant("ppr_blocked", port(g), threshold=1e-9, seeds=seeds,
                      handle_dangling=True, block=bg.block, device=CPU)
    l1 = np.abs(r.pr.double().numpy() - oracle).sum(axis=1)
    assert l1.shape == (b,) and l1.max() < 1e-5


def test_ppr_blocked_empty_graph():
    g = Graph.from_edges(0, np.zeros(0, np.int32), np.zeros(0, np.int32))
    r = ppr_blocked(BlockedGraph.build(g, block=16, device=CPU), np.zeros((2, 0)))
    assert tuple(r.pr.shape) == (2, 0) and r.iterations == 0


def test_blocked_row_helpers_round_trip():
    rng = np.random.default_rng(5)
    rows = rng.random((3, 70))
    st = blocked_rows(rows, n_blocks=3, block=32)
    assert st.shape == (3, 32, 3) and st.dtype == np.float32
    # vertex-major: the b values of one vertex are contiguous
    assert np.array_equal(st.reshape(-1, 3)[5], rows[:, 5].astype(np.float32))
    assert not st.reshape(-1, 3)[70:].any()
    t = torch.as_tensor(st)
    np.testing.assert_array_equal(unblocked_rows(t, 70).numpy(),
                                  rows.astype(np.float32))
    write_blocked_row(t, 1, np.arange(70.0))
    np.testing.assert_array_equal(read_blocked_row(t, 1, 70), np.arange(70.0))
    np.testing.assert_array_equal(read_blocked_row(t, 0, 70),
                                  rows[0].astype(np.float32))


def test_registry_carries_the_ppr_variants():
    for name, backend, opts in (("ppr_barrier", "torch", ("seeds",)),
                                ("ppr_nosync", "torch", ("seeds", "thread_level")),
                                ("ppr_blocked", "cuda", ("seeds",))):
        v = get_variant(name)
        assert v.backend == backend and v.options == opts
    with pytest.raises(TypeError, match="interpret"):
        build_variant("ppr_blocked", port(SURROGATES["rmat"]()), interpret=True,
                      device=CPU)


def test_launcher_runs_ppr_blocked_with_a_uniform_row(capsys):
    rep = pagerank_run.run(["--scale-down", "2048", "--variant", "ppr_blocked",
                            "--handle-dangling", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "variant=ppr_blocked: iterations=" in out
    assert "gs_pass_multi=0" in out
    assert rep["l1"] < 1e-5 and len(rep["top5"]) == 5
