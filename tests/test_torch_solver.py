"""The port's engine, registry and vertex-centric variants against the JAX
reference, on the CPU, on the three ``tests/test_solver.py`` surrogates
(rmat, lattice, dangling_heavy) with dangling redistribution off and on.

Parity (``barrier``, ``barrier_opt``, ``nosync``, ``nosync_opt`` against
the reference registry's entries of the same name, same ``threads``):

* the same ``iterations`` and ``sweeps``;
* ``pr`` within 1e-6 max abs;
* ``residuals[:iterations]`` within 1e-6 × max|pr|: a residual is a max
  of differences of float32 ranks, and each rank agrees with the
  reference's to a few float32 ulps (2^-23 ≈ 1.2e-7 relative).

Parity is checked at threshold 1e-7.  At the reference tests' 1e-8 the
residual sits within a few ulps of the ranks (about 5e-10 at rank 4e-3),
so whether the last iteration stops is decided by rounding; at 1e-7 the
trajectory is well clear of it.  The fixed-point tests run at 1e-8.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core.solver import solve_variant as ref_solve_variant
from repro_torch.core import pagerank_numpy as port_pagerank_numpy
from repro_torch.core.pagerank import (
    DeviceGraph,
    PartitionedGraph,
    l1_norm,
    pagerank_nosync,
    pagerank_numpy,
)
from repro_torch.core.solver import (
    BACKENDS,
    EngineState,
    barrier_schedule,
    build_variant,
    get_variant,
    list_variants,
    register_variant,
    solve,
    solve_variant,
)
from repro_torch.graphs import graph_from_arrays, rmat_graph
from repro_torch.launch import pagerank_run
from test_solver import SURROGATES

PARITY_THRESH = 1e-7
THRESH = 1e-8
CPU = "cpu"
VERTEX_VARIANTS = ("barrier", "barrier_opt", "nosync", "nosync_opt")
ALL_VARIANTS = VERTEX_VARIANTS + ("blocked", "blocked_nosync", "blocked_nosync_opt")
SLICE_7_VARIANTS = ("barrier_edge", "barrier_identical", "nosync_adaptive",
                    "blocked_adaptive")
PPR_VARIANTS = ("ppr_barrier", "ppr_nosync", "ppr_blocked")
SLICE_8_VARIANTS = ("barrier_sticd", "nosync_sticd", "ppr_push",
                    "ppr_push_priority")
DISTRIBUTED_VARIANTS = ("distributed_barrier", "distributed_stale",
                        "distributed_topk")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port(g):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


def assert_parity(ref, got, *, sweeps=True):
    it = int(ref.iterations)
    assert got.iterations == it
    if sweeps:
        assert got.sweeps == int(ref.sweeps)
    pr_ref = np.asarray(ref.pr)
    assert np.abs(got.pr.numpy() - pr_ref).max() <= 1e-6
    res_ref = np.asarray(ref.residuals)[:it]
    res = got.residuals.numpy()[:it]
    assert np.abs(res - res_ref).max() <= 1e-6 * np.abs(pr_ref).max()
    assert np.all(np.isinf(got.residuals.numpy()[it:]))


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
@pytest.mark.parametrize("vname", VERTEX_VARIANTS)
def test_vertex_variants_match_reference(vname, gname, handle_dangling):
    g = SURROGATES[gname]()
    kw = dict(threshold=PARITY_THRESH, handle_dangling=handle_dangling, threads=4)
    ref = ref_solve_variant(vname, g, **kw)
    got = solve_variant(vname, port(g), device=CPU, **kw)
    assert_parity(ref, got)


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("gname", sorted(SURROGATES))
@pytest.mark.parametrize("vname", ("sequential",) + VERTEX_VARIANTS)
def test_vertex_variants_reach_oracle_fixed_point(vname, gname, handle_dangling):
    g = port(SURROGATES[gname]())
    ref, _ = pagerank_numpy(g, threshold=1e-12, handle_dangling=handle_dangling)
    r = solve_variant(vname, g, threshold=THRESH, handle_dangling=handle_dangling,
                      threads=4, device=CPU)
    tol = 1e-3 if vname.endswith("_opt") else 1e-5
    assert l1_norm(r.pr, ref) < tol
    assert r.iterations >= 1


def test_numpy_oracle_is_the_reference_oracle():
    from repro.core import pagerank_numpy as ref_oracle

    g = SURROGATES["dangling_heavy"]()
    for hd in (False, True):
        a, ia = ref_oracle(g, threshold=1e-12, handle_dangling=hd)
        b, ib = port_pagerank_numpy(port(g), threshold=1e-12, handle_dangling=hd)
        assert ia == ib
        np.testing.assert_array_equal(a, b)


def test_warm_start_matches_reference():
    g = SURROGATES["rmat"]()
    pr0, _ = pagerank_numpy(port(g), threshold=1e-4)
    for vname in ("barrier", "nosync"):
        kw = dict(threshold=PARITY_THRESH, threads=4, pr0=pr0)
        ref = ref_solve_variant(vname, g, **kw)
        got = solve_variant(vname, port(g), device=CPU, **kw)
        assert_parity(ref, got)
        cold = solve_variant(vname, port(g), device=CPU, threshold=PARITY_THRESH,
                             threads=4)
        assert got.iterations < cold.iterations


def test_thread_level_termination_sheds_sweeps_not_iterations():
    """Alg 3 l.17-19 as termination semantics: it may skip the tail sweeps
    of the last iteration but not change the fixed point.  (The reference's
    version of this test runs at 1e-9, below the float32 noise floor of
    these ranks, where the two packages' counts already differ; the
    parity threshold keeps the comparison about the schedule.)"""
    g = rmat_graph(8, avg_degree=5, seed=11)
    ref, _ = pagerank_numpy(g, threshold=1e-12)
    pg = PartitionedGraph.from_graph(g, p=6, device=CPU)
    r_on = pagerank_nosync(pg, threshold=PARITY_THRESH, thread_level=True)
    r_off = pagerank_nosync(pg, threshold=PARITY_THRESH, thread_level=False)
    assert l1_norm(r_on.pr, ref) < 1e-4 and l1_norm(r_off.pr, ref) < 1e-4
    assert r_on.iterations == r_off.iterations
    assert r_on.sweeps <= r_off.sweeps == 6 * r_off.iterations


def test_solve_stops_at_max_iter_and_pads_residuals():
    step = barrier_schedule(lambda pr: pr * 0.5)
    pr0 = torch.ones(4)
    r = solve(step, pr0, threshold=0.0, max_iter=3)
    assert r.iterations == 3 and r.sweeps == 3
    assert r.residuals.tolist() == [0.5, 0.25, 0.125]
    r0 = solve(step, pr0, threshold=0.0, max_iter=0)
    assert r0.iterations == 0 and r0.err == float("inf")
    assert r0.residuals.numel() == 0
    r = solve(step, pr0, threshold=0.2, max_iter=10)
    assert r.iterations == 3 and r.err == 0.125
    assert torch.isinf(r.residuals[3:]).all()


def test_engine_state_fields_match_reference():
    from repro.core.solver import EngineState as RefEngineState

    assert EngineState._fields == RefEngineState._fields
    assert EngineState._field_defaults == {"aux": ()}


def test_registry_lists_the_slice():
    names = set(list_variants())
    assert names == {"sequential", *ALL_VARIANTS, *PPR_VARIANTS,
                     *SLICE_7_VARIANTS, *SLICE_8_VARIANTS,
                     *DISTRIBUTED_VARIANTS}
    assert len(names) == 22
    for name in names:
        v = get_variant(name)
        assert v.description and v.layout and v.backend in BACKENDS
    assert {get_variant(n).backend for n in ALL_VARIANTS[4:]} == {"cuda"}
    assert get_variant("ppr_blocked").backend == "cuda"
    assert get_variant("blocked_adaptive").backend == "cuda"
    for name in DISTRIBUTED_VARIANTS:  # every shard's sweep is spmv_csr_acc
        assert (get_variant(name).layout, get_variant(name).backend) == (
            "distributed", "cuda")


def test_registry_does_not_touch_the_reference():
    from repro.core.solver import list_variants as ref_list_variants

    cuda_names = {"blocked", "blocked_nosync", "blocked_nosync_opt",
                  "blocked_adaptive", "ppr_blocked"}
    pallas_names = {"pallas", "pallas_nosync", "pallas_nosync_opt",
                    "pallas_adaptive", "ppr_pallas"}
    ref_names, names = set(ref_list_variants()), set(list_variants())
    assert not cuda_names & ref_names
    # all 22 of the reference's: the kernel variants under their port
    # names, every other name shared, none left unported
    assert names - cuda_names == ref_names - pallas_names
    assert len(ref_names) == 22 == len(names)


@pytest.mark.parametrize("bad", [dict(backend="jax"), dict(description=""),
                                 dict(layout=""), dict(schedule="warp")])
def test_register_variant_validates_metadata(bad):
    kw = dict(description="d", layout="l", backend="torch", schedule="barrier")
    kw.update(bad)
    with pytest.raises(ValueError, match="register_variant"):
        register_variant("bad_variant", build=lambda g, **_: g,
                         run=lambda b, **_: b, **kw)
    assert "bad_variant" not in list_variants()


def test_unknown_variant_raises():
    with pytest.raises(KeyError, match="unknown PageRank variant"):
        get_variant("nosync_quantum")


def test_unknown_option_raises_not_silently_dropped():
    g = port(SURROGATES["rmat"]())
    with pytest.raises(TypeError, match="handle_dangeling"):
        solve_variant("barrier", g, handle_dangeling=True, device=CPU)
    with pytest.raises(TypeError, match="perforate"):
        solve_variant("nosync", g, perforate=True, device=CPU)
    with pytest.raises(TypeError, match="interpret"):
        solve_variant("blocked", g, interpret=True, device=CPU)
    r = solve_variant("nosync", g, threshold=THRESH, threads=4,
                      thread_level=False, device=CPU)
    assert l1_norm(r.pr, pagerank_numpy(g, threshold=1e-12)[0]) < 1e-5


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = port(SURROGATES["rmat"]())
    for vname in ("barrier", "nosync", "blocked", "sequential"):
        with pytest.raises(RuntimeError, match="CUDA"):
            solve_variant(vname, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_variant("blocked_nosync", g, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceGraph.from_graph(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        pagerank_run.main(["--scale-down", "2048"])


def test_launcher_runs_the_solve_path_on_cpu(capsys):
    rep = pagerank_run.run(["--scale-down", "2048", "--variant", "blocked_nosync",
                            "--handle-dangling", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "variant=blocked_nosync: iterations=" in out and "L1 vs sequential" in out
    assert "kernel launches: spmv_csr_acc=0 gs_pass=0" in out
    assert rep["l1"] < 1e-5 and rep["iterations"] >= 1 and len(rep["top5"]) == 5
    assert pagerank_run.main(["--list"]) == 0
    assert "blocked_nosync_opt" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--store=/tmp/x"],
                                  ["--ckpt", "/tmp/x", "--device", "cpu"],
                                  ["build"], ["--store", "/tmp/x"],
                                  ["--ckpt=/tmp/x"]])
def test_launcher_rejects_later_slices(argv):
    with pytest.raises(NotImplementedError, match="not ported"):
        pagerank_run.main(argv)


def test_launcher_serves_on_a_mesh(capsys):
    # serve --mesh-shards runs since the distributed slice; the CPU is one
    # device, so the mesh has one shard
    rep = pagerank_run.run(["serve", "--mesh-shards", "2", "--device", "cpu",
                            "--scale-down", "2048", "--queries", "4"])
    assert "mesh_shards=1" in capsys.readouterr().out
    assert rep["stats"]["mesh_shards"] == 1 and len(rep["responses"]) == 4
