"""The port's two kernels, through their wrappers on the CPU (which run the
plain versions), held against the JAX reference on the same numpy inputs.

* ``spmv_csr_acc`` against the Pallas ``spmv_blocked`` in interpret mode:
  same graph, same contribution vector.  Tolerance: max abs error ≤
  1e-6 × max|acc| (float32 sums taken in another order).
* ``gs_pass`` against the reference's Alg-3 semantics: the Pallas GS kernel
  does not trace under the installed JAX, so it is held against
  ``pagerank_nosync`` on ``PartitionedGraph.from_graph(g, p=n_blocks)`` —
  one partition per dst block, ``thread_level=False`` (its default skips
  tail sweeps) and ``block`` dividing ``n`` (padding lanes differ: nosync
  writes ``base+dmass`` there, the blocked pass 0).  Tolerance: max abs
  error ≤ 1e-6 × max|pr| after 1 and 3 passes.
* the freeze mask against a float64 numpy blocked Gauss–Seidel pass
  written here.
"""
import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import PartitionedGraph as RefPartitionedGraph
from repro.core import pagerank_nosync as ref_pagerank_nosync
from repro.graphs import build_blocked_coo
from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.csr import Graph as RefGraph
from repro.kernels.spmv import spmv_blocked
from repro_torch.graphs import graph_from_arrays
from repro_torch.kernels.spmv import (
    BlockedGraph,
    build,
    gs_pass,
    gs_pass_ref,
    launch_counts,
    spmv_csr_acc,
    spmv_csr_acc_ref,
)
from test_solver import dangling_heavy_graph, lattice_graph

D = 0.85
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def weighted(g: RefGraph, seed: int = 0) -> RefGraph:
    rng = np.random.default_rng(seed)
    return RefGraph.from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                                weights=rng.uniform(0.3, 1.0, g.m),
                                bias=rng.uniform(0.5, 1.5, g.n))


# (graph, block dividing n)
GRAPHS = {
    "rmat": (lambda: ref_rmat_graph(8, avg_degree=5, seed=3), 64),
    "lattice": (lattice_graph, 48),
    "dangling_heavy": (dangling_heavy_graph, 32),
    "rmat_weighted": (lambda: weighted(ref_rmat_graph(8, avg_degree=5, seed=3)), 64),
}


def port(g: RefGraph):
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             g.weights, g.bias)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_spmv_csr_acc_matches_pallas_spmv_blocked(gname):
    make, block = GRAPHS[gname]
    g = make()
    coo = build_blocked_coo(g, block=block, tile_cap=128)
    lane_w = coo.tiles_valid if coo.tiles_weight is None else coo.tiles_weight
    rng = np.random.default_rng(1)
    contrib = rng.random((coo.n_blocks, block)).astype(np.float32)
    contrib.reshape(-1)[g.n:] = 0.0
    ref = np.asarray(spmv_blocked(
        contrib, coo.tiles_src_local, coo.tiles_dst_local, lane_w,
        coo.tile_src_block, coo.tile_dst_block, block=block, interpret=True))
    bg = BlockedGraph.build(port(g), block=block, device=CPU)
    got = spmv_csr_acc(torch.as_tensor(contrib), bg.in_ptr, bg.src, bg.weights)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    plain = spmv_csr_acc_ref(torch.as_tensor(contrib), bg.in_ptr, bg.src, bg.weights)
    assert torch.equal(got, plain)


def _port_passes(bg: BlockedGraph, k: int, handle_dangling: bool):
    n = bg.n
    pr = torch.full((bg.n_blocks, bg.block), 1.0 / n) * bg.vmask
    for _ in range(k):
        dmass = D * (torch.sum(pr * bg.dangling) / n) if handle_dangling \
            else torch.tensor(0.0)
        params = torch.stack([torch.tensor((1.0 - D) / n), torch.tensor(D),
                              dmass]).float()
        pr = gs_pass(pr, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                     bg.weights, bg.bias)
    return pr.reshape(-1).numpy()


@pytest.mark.parametrize("handle_dangling", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_gs_pass_matches_reference_nosync_semantics(gname, k, handle_dangling):
    make, block = GRAPHS[gname]
    g = make()
    assert g.n % block == 0
    ref = np.asarray(ref_pagerank_nosync(
        RefPartitionedGraph.from_graph(g, p=g.n // block), threshold=0.0,
        max_iter=k, thread_level=False, handle_dangling=handle_dangling).pr)
    got = _port_passes(BlockedGraph.build(port(g), block=block, device=CPU),
                       k, handle_dangling)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def numpy_blocked_gs(g, block, pr, params, frozen):
    """float64 numpy blocked Gauss–Seidel pass with a freeze mask."""
    base, d, dmass = (float(x) for x in params)
    n = g.n
    n_pad = pr.size
    out = pr.astype(np.float64).copy()
    inv = np.zeros(n_pad)
    inv[:n] = np.where(g.out_degree > 0, 1.0 / np.maximum(g.out_degree, 1), 0.0)
    bias = np.ones(n_pad) if g.bias is None else np.r_[g.bias, np.zeros(n_pad - n)]
    vmask = (np.arange(n_pad) < n).astype(np.float64)
    w = np.ones(g.m) if g.weights is None else g.weights
    for db in range(n_pad // block):
        v0, v1 = db * block, (db + 1) * block
        e0, e1 = g.in_ptr[min(v0, n)], g.in_ptr[min(v1, n)]
        acc = np.zeros(block)
        np.add.at(acc, g.dst[e0:e1] - v0, (out * inv)[g.src[e0:e1]] * w[e0:e1])
        new = (base * bias[v0:v1] + dmass + d * acc) * vmask[v0:v1]
        out[v0:v1] = np.where(frozen[v0:v1], out[v0:v1], new)
    return out


@pytest.mark.parametrize("gname", ["rmat", "rmat_weighted", "lattice"])
def test_gs_pass_freeze_mask_against_numpy(gname):
    make, _ = GRAPHS[gname]
    g = make()
    block = 40  # does not divide n: padding lanes must come out 0
    bg = BlockedGraph.build(port(g), block=block, device=CPU)
    rng = np.random.default_rng(4)
    n_pad = bg.n_blocks * block
    pr = (rng.random(n_pad) / g.n * (np.arange(n_pad) < g.n)).astype(np.float32)
    frozen = (rng.random(n_pad) < 0.3) & (np.arange(n_pad) < g.n)
    params = np.asarray([(1 - D) / g.n, D, 0.1 * D / g.n], np.float32)
    shape = (bg.n_blocks, block)
    pr_t = torch.as_tensor(pr).reshape(shape)
    args = (bg.inv_out, bg.vmask, torch.as_tensor(params), bg.in_ptr, bg.src,
            bg.weights, bg.bias)
    got = gs_pass(pr_t, *args, frozen=torch.as_tensor(frozen).reshape(shape)).reshape(-1)
    frozen_t = torch.as_tensor(frozen).reshape(shape)
    assert torch.equal(got, gs_pass_ref(pr_t, *args, frozen=frozen_t).reshape(-1))
    want = numpy_blocked_gs(g, block, pr, params, frozen)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert torch.equal(got[torch.as_tensor(frozen)], pr_t.reshape(-1)[frozen])
    assert float(got[g.n:].abs().sum()) == 0.0
    # all frozen holds every rank; an all-clear mask equals no mask
    all_frozen = gs_pass(pr_t, *args,
                         frozen=bg.vmask > 0)
    assert torch.equal(all_frozen, pr_t)
    clear = gs_pass(pr_t, *args,
                    frozen=torch.zeros(shape, dtype=torch.bool))
    assert torch.equal(clear, gs_pass(pr_t, *args))


def test_gs_pass_reads_lower_blocks_fresh():
    """A chain 0→1→…→5 with block 1 and base 1, d 1: one Gauss–Seidel pass
    from zeros carries each new value down the chain (vertex k reads k-1's
    new rank k and commits k+1), where one Jacobi sweep reads only zeros."""
    n = 6
    g = port(RefGraph.from_edges(n, np.arange(n - 1), np.arange(1, n)))
    bg = BlockedGraph.build(g, block=1, device=CPU)
    zeros = torch.zeros(n, 1)
    params = torch.tensor([1.0, 1.0, 0.0])  # base, d, dmass
    out = gs_pass(zeros, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src)
    assert out.reshape(-1).tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    acc = spmv_csr_acc(zeros, bg.in_ptr, bg.src)
    assert acc.reshape(-1).tolist() == [0.0] * n


def test_wrappers_check_operands():
    g = port(ref_rmat_graph(7, avg_degree=4, seed=0))
    bg = BlockedGraph.build(g, block=32, device=CPU)
    params = torch.tensor([0.1, 0.85, 0.0])
    with pytest.raises(ValueError, match="float32"):
        spmv_csr_acc(bg.vmask.double(), bg.in_ptr, bg.src)
    with pytest.raises(ValueError, match="shape"):
        spmv_csr_acc(bg.vmask, bg.in_ptr[:-1], bg.src)
    with pytest.raises(ValueError, match="int32"):
        spmv_csr_acc(bg.vmask, bg.in_ptr.long(), bg.src)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_csr_acc(bg.vmask.t().contiguous().t(), bg.in_ptr, bg.src)
    with pytest.raises(ValueError, match="shape"):
        gs_pass(bg.vmask, bg.inv_out, bg.vmask, params[:2], bg.in_ptr, bg.src)
    with pytest.raises(ValueError, match="bool"):
        gs_pass(bg.vmask, bg.inv_out, bg.vmask, params, bg.in_ptr, bg.src,
                frozen=bg.vmask)
    with pytest.raises(ValueError, match="device"):
        spmv_csr_acc(bg.vmask.to("meta"), bg.in_ptr, bg.src)


def test_cpu_path_launches_no_kernel():
    g = port(ref_rmat_graph(7, avg_degree=4, seed=0))
    bg = BlockedGraph.build(g, block=32, device=CPU)
    before = launch_counts()
    spmv_csr_acc(bg.vmask, bg.in_ptr, bg.src)
    gs_pass(bg.vmask, bg.inv_out, bg.vmask, torch.tensor([0.1, 0.85, 0.0]),
            bg.in_ptr, bg.src)
    assert launch_counts() == before


def test_build_targets_hopper_and_keys_on_source():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert build.SOURCE.is_file() and build.SOURCE.suffix == ".cu"


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_build_surfaces_compiler_errors(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_command", lambda out: ["nvcc"])
    monkeypatch.setattr(
        build.subprocess, "run",
        lambda cmd, **kw: build.subprocess.CompletedProcess(cmd, 1, "", "error"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert list(tmp_path.iterdir()) == []  # no half-built library left behind
