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
* ``gs_pass``'s order on the card, emulated in float32 numpy: the plain
  blocked order (4,096-edge chunks, lanes strided 32 apart, the warp's xor
  tree, chunk sums in order) and the kernel's schedule (each block's values
  gathered once every block up to k below it is committed, the sources in
  the k − 1 blocks below it taken from the window of committed values).
  The schedule must equal the plain blocked order bit for bit and
  ``gs_pass_ref`` within 1e-5·(|ref| + mean|ref|) in every entry; without
  the window it must miss that bound on a chain.
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
from repro_torch.kernels import nvcc
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


# ---------------------------------------------------------------------------
# spmv_csr_acc's order on the card (csrc/spmv.cu), emulated step by step
# ---------------------------------------------------------------------------

CSR_THREADS, CSR_TILE, WARP = 256, 256 * 16, 32


def merge_path_spmv(contrib, in_ptr, src, weights, ctas, f=np.float32):
    """The CUDA ``spmv_csr_acc`` in dtype ``f``: ``ctas`` equal shares of
    the merge path of row ends and edges, tiles of at most CSR_TILE items,
    each thread's equal run summed in sequence (thread 0 continuing the row
    its CTA's last tile left open), rows cut between threads joined by a
    segmented Kogge–Stone scan in each warp and the warp totals in order,
    and rows cut between CTAs by the CTAs' carries added in CTA order."""
    n_rows, m = len(in_ptr) - 1, len(src)
    val = contrib[src].astype(f)
    if weights is not None:
        val = (val * weights.astype(f)).astype(f)
    ends = in_ptr[1:].astype(np.int64)
    path_key = ends + np.arange(n_rows) + 1  # a row end's place on the path

    def coord(d):  # rows ended and edges consumed at diagonal d
        x = min(max(int(np.searchsorted(path_key, d, side="right")), d - m), n_rows)
        return x, d - x

    acc = np.zeros(n_rows, f)
    total = n_rows + m
    share = -(-total // ctas)
    carry_rows, carry_vals = [], []
    for c in range(ctas):
        d0 = min(c * share, total)
        d1 = min(d0 + share, total)
        n_tiles = max(1, -(-(d1 - d0) // CSR_TILE))
        tile_items = -(-(d1 - d0) // n_tiles)
        carry_key, carry = -1, f(0)
        for t in range(n_tiles):
            t0 = min(d0 + t * tile_items, d1)
            t1 = min(t0 + tile_items, d1)
            x0 = coord(t0)[0]
            ipt = -(-(t1 - t0) // CSR_THREADS)
            keys = np.zeros(CSR_THREADS, np.int64)
            runs = np.zeros(CSR_THREADS, f)
            emitted = {}
            for th in range(CSR_THREADS):
                dt = min(th * ipt, t1 - t0)
                x, y = coord(t0 + dt)
                start = x
                run = carry if th == 0 and carry_key == x0 else f(0)
                for _ in range(dt, min(dt + ipt, t1 - t0)):
                    if y < ends[x]:
                        run = f(run + val[y])
                        y += 1
                    else:
                        if start not in emitted:
                            emitted[start] = (th, run)
                        else:
                            acc[x] = run
                        run = f(0)
                        x += 1
                keys[th], runs[th] = x, run
            # inclusive segmented scan within each warp (keys never decrease)
            k = keys.reshape(-1, WARP)
            v = runs.reshape(-1, WARP).copy()
            for off in (1, 2, 4, 8, 16):
                up_k = np.full_like(k, -1)
                up_k[:, off:] = k[:, :-off]
                up_v = np.zeros_like(v)
                up_v[:, off:] = v[:, :-off]
                v = np.where(up_k == k, (up_v + v).astype(f), v)
            inc_v = v.reshape(-1)
            pre_key, pre_val, pre = -1, f(0), []
            for w in range(CSR_THREADS // WARP):  # warp totals joined in order
                pre.append((pre_key, pre_val))
                wk, wv = keys[w * WARP + WARP - 1], inc_v[w * WARP + WARP - 1]
                pre_key, pre_val = (wk, f(pre_val + wv)) if wk == pre_key else (wk, wv)
            full = inc_v.copy()
            for th in range(CSR_THREADS):
                pk, pv = pre[th // WARP]
                if pk == keys[th]:
                    full[th] = f(pv + inc_v[th])
            for start, (th, first) in emitted.items():
                ex_k, ex_v = pre[th // WARP] if th % WARP == 0 else (keys[th - 1], full[th - 1])
                acc[start] = f(ex_v + first) if ex_k == start else first
            carry_key, carry = keys[-1], full[-1]
        carry_rows.append(carry_key)
        carry_vals.append(carry)
    for c, row in enumerate(carry_rows):
        if 0 <= row < n_rows and (c == 0 or carry_rows[c - 1] != row):
            s = carry_vals[c]
            for k2 in range(c + 1, ctas):
                if carry_rows[k2] != row:
                    break
                s = f(s + carry_vals[k2])
            acc[row] = f(s + acc[row])
    return acc


def _hub_graph(n=30000, hub_in=25000, seed=0):
    rng = np.random.default_rng(seed)
    src = np.r_[np.arange(1, hub_in + 1), rng.integers(0, n, 3 * n)]
    dst = np.r_[np.zeros(hub_in, np.int64), rng.integers(1, n, 3 * n)]
    key = np.unique(src * n + dst)
    return RefGraph.from_edges(n, key // n, key % n)


# 132 SMs × 6 resident CTAs (one resident wave on the H100), and a grid so
# small that each CTA walks several tiles
@pytest.mark.parametrize("ctas", [792, 7])
@pytest.mark.parametrize("weighted_graph", [False, True])
def test_spmv_csr_acc_order_emulation_within_bound(ctas, weighted_graph):
    """The CUDA kernel's order, emulated: in float64 it is every row's exact
    sum (the split covers each edge once); in float32 every entry lies
    within the 1e-5 bound of ``chip_smoke.py`` against the plain version, on
    a hub of 25,000 in-edges carried across many CTAs."""
    g = _hub_graph()
    assert np.diff(g.in_ptr).max() >= 20000
    if weighted_graph:
        g = weighted(g, seed=2)
    bg = BlockedGraph.build(port(g), block=256, device=CPU)
    in_ptr, src = bg.in_ptr.numpy(), bg.src.numpy()
    w = None if bg.weights is None else bg.weights.numpy()
    rng = np.random.default_rng(3)
    contrib = (rng.random(bg.vmask.numel()) * bg.vmask.reshape(-1).numpy()).astype(np.float32)
    exact = merge_path_spmv(contrib.astype(np.float64), in_ptr, src,
                            None if w is None else w.astype(np.float64), ctas, np.float64)
    vals = contrib[src].astype(np.float64) * (1.0 if w is None else w)
    want = np.zeros(len(in_ptr) - 1)
    np.add.at(want, np.repeat(np.arange(len(in_ptr) - 1), np.diff(in_ptr)), vals)
    assert np.abs(exact - want).max() <= 1e-12 * np.abs(want).max()
    got = merge_path_spmv(contrib, in_ptr, src, w, ctas)
    ref = spmv_csr_acc_ref(torch.as_tensor(contrib).reshape(bg.vmask.shape),
                           bg.in_ptr, bg.src, bg.weights).reshape(-1).numpy()
    scale = np.abs(ref) + np.abs(ref).mean()
    assert (np.abs(got - ref) / scale).max() <= 1e-5


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
    path = nvcc.library_path(build.SOURCE)
    assert path.parent == nvcc.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("spmv_")
    flags = " ".join(nvcc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert build.SOURCE.is_file() and build.SOURCE.suffix == ".cu"


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(nvcc.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        nvcc.nvcc_path()


def test_build_surfaces_compiler_errors(monkeypatch, tmp_path):
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "nvcc_command", lambda source, out: ["nvcc"])
    monkeypatch.setattr(
        nvcc.subprocess, "run",
        lambda cmd, **kw: nvcc.subprocess.CompletedProcess(cmd, 1, "", "error"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert list(tmp_path.iterdir()) == []  # no half-built library left behind


# ---------------------------------------------------------------------------
# gs_pass's order on the card (csrc/spmv.cu), emulated step by step
# ---------------------------------------------------------------------------

CHUNK = 4096


def _chain(block, n_blocks=12):
    """Each row of block k + 1 takes its two in-edges from rows of block k,
    so a Gauss-Seidel pass carries every value one block a step: every
    edge's source is committed just before its block is summed."""
    n = block * n_blocks
    v = np.arange(block, n)
    src = np.r_[v - block, (v - block + 1) % block + (v // block - 1) * block]
    return RefGraph.from_edges(n, src, np.r_[v, v])


def warp_order_sums(vals, starts, ends, c0):
    """Each row's slice [starts, ends) of a chunk starting at edge c0, summed
    as one warp sums it: lane l adds the slice's edges l, l + 32, ...
    (from 0), then the xor tree's levels 16 .. 1 as lane 0 sees them."""
    f = np.float32
    rows = len(starts)
    lanes = np.zeros((rows, WARP), f)
    n = np.maximum(ends - starts, 0)
    if n.sum():
        row = np.repeat(np.arange(rows), n)
        off = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        val = vals[np.repeat(starts - c0, n) + off]
        for rnd in range(int(off.max()) // WARP + 1):
            sel = off // WARP == rnd  # one edge per (row, lane) a round
            lanes[row[sel], off[sel] % WARP] = (lanes[row[sel], off[sel] % WARP]
                                                + val[sel]).astype(f)
    for lvl in (16, 8, 4, 2, 1):
        lanes[:, :lvl] = (lanes[:, :lvl] + lanes[:, lvl:2 * lvl]).astype(f)
    return lanes[:, 0]


def emulated_gs_pass(bg, pr, params, frozen=None, k=None, window=True):
    """One pass in float32 in the kernel's order.  ``k`` None: each block
    reads the state as it stands (the plain blocked order).  Otherwise each
    block's values are gathered from q = pr·inv_out as it stood once block
    b − k was committed, and (``window``) the sources in blocks (b − k, b)
    are read from the committed values instead."""
    f = np.float32
    block = bg.block
    ptr = bg.in_ptr.numpy().astype(np.int64)
    src = bg.src.numpy().astype(np.int64)
    w = None if bg.weights is None else bg.weights.numpy()
    inv = bg.inv_out.numpy().reshape(-1)
    vm = bg.vmask.numpy().reshape(-1)
    bz = vm if bg.bias is None else bg.bias.numpy().reshape(-1)
    fz = np.zeros_like(vm, bool) if frozen is None else frozen.reshape(-1)
    base, d, dmass = (f(x) for x in params)
    out = pr.reshape(-1).astype(f).copy()
    q = (out * inv).astype(f)
    head = ((base * bz).astype(f) + dmass).astype(f)
    snaps = [q.copy()]  # snaps[i]: q once blocks below i are committed
    for b in range(bg.n_blocks):
        v0, v1 = b * block, (b + 1) * block
        e0, e1 = ptr[v0], ptr[v1]
        s = src[e0:e1]
        if k is None:
            vals = q[s]
        else:
            vals = snaps[max(b - k + 1, 0)][s].copy()
            if window:
                fix = (s >= (b - k + 1) * block) & (s < v0)
                vals[fix] = q[s[fix]]
        if w is not None:
            vals = (vals * w[e0:e1]).astype(f)
        acc = np.zeros(block, f)
        for c0 in range(e0, max(e1, e0 + 1), CHUNK):
            c1 = min(c0 + CHUNK, e1)
            lo = np.clip(ptr[v0:v1], c0, c1)
            hi = np.clip(ptr[v0 + 1:v1 + 1], c0, c1)
            acc = (acc + warp_order_sums(vals, lo - e0, hi - e0, 0)).astype(f)
        new = (((head[v0:v1] + (d * acc).astype(f)).astype(f)) * vm[v0:v1]).astype(f)
        keep = fz[v0:v1]
        out[v0:v1] = np.where(keep, out[v0:v1], new)
        q[v0:v1] = np.where(keep, q[v0:v1], (out[v0:v1] * inv[v0:v1]).astype(f))
        snaps.append(q.copy())
    return out.reshape(pr.shape)


def _emulation_case(name):
    """(blocked graph, pr, params, frozen) of an emulation case: the chain
    and the hub at block 256, an rmat graph (weighted and biased, or with a
    third of its lanes frozen) at block 64."""
    rng = np.random.default_rng(7)
    block = 256
    if name == "chain":
        g = _chain(256)
    elif name == "hub":
        g = _hub_graph()
    else:
        g = ref_rmat_graph(10, avg_degree=8, seed=4)
        g = weighted(g, seed=5) if name == "rmat_weighted" else g
        block = 64
    bg = BlockedGraph.build(port(g), block=block, device=CPU)
    n_pad = bg.n_blocks * bg.block
    live = np.arange(n_pad) < g.n
    pr = (rng.random(n_pad) / g.n * live).astype(np.float32).reshape(bg.n_blocks, bg.block)
    frozen = ((rng.random(n_pad) < 0.3) & live).reshape(pr.shape) if name == "frozen" else None
    params = np.asarray([(1 - D) / g.n, D, 0.2 * D / g.n], np.float32)
    return bg, pr, params, frozen


def _entry_ratio(got, ref):
    scale = np.abs(ref) + np.abs(ref).mean()
    return float((np.abs(got - ref) / scale).max()) / 1e-5


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", ["chain", "hub", "rmat_weighted", "frozen"])
def test_gs_pass_schedule_emulation_is_the_plain_order(name, k):
    """The kernel's schedule, values gathered k blocks ahead and fixed up
    from the window, equals the plain blocked order bit for bit and the
    plain version within the kernel bound."""
    bg, pr, params, frozen = _emulation_case(name)
    if name == "hub":  # a block of several chunks, rows cut between them
        assert np.diff(bg.in_ptr.numpy()[::bg.block]).max() > 4 * CHUNK
    plain_order = emulated_gs_pass(bg, pr, params, frozen)
    got = emulated_gs_pass(bg, pr, params, frozen, k=k)
    assert np.array_equal(got, plain_order)
    ref = gs_pass_ref(torch.as_tensor(pr), bg.inv_out, bg.vmask, torch.as_tensor(params),
                      bg.in_ptr, bg.src, bg.weights, bg.bias,
                      None if frozen is None else torch.as_tensor(frozen)).numpy()
    assert _entry_ratio(got, ref) <= 1.0
    if frozen is not None:
        assert np.array_equal(got[frozen], pr[frozen])


@pytest.mark.parametrize("k", [2, 4])
def test_gs_pass_schedule_emulation_needs_the_window(k):
    """Without the window every edge of the chain reads its source from
    before the commit of the block just below: far outside the bound."""
    bg, pr, params, frozen = _emulation_case("chain")
    ref = gs_pass_ref(torch.as_tensor(pr), bg.inv_out, bg.vmask, torch.as_tensor(params),
                      bg.in_ptr, bg.src).numpy()
    assert _entry_ratio(emulated_gs_pass(bg, pr, params, k=k), ref) <= 1.0
    assert _entry_ratio(emulated_gs_pass(bg, pr, params, k=k, window=False), ref) > 100.0


@pytest.mark.parametrize("group", [2, 4, 8])
def test_group_lanes_take_the_warp_xor_tree(group):
    """A row of at most 32 values summed by ``group`` lanes, each holding
    every group-th warp lane's value and taking the tree's levels down to
    ``group`` itself, the rest across the group (csrc/spmv.cu, kGroup): the
    warp's xor tree bit for bit."""
    f = np.float32
    rng = np.random.default_rng(group)
    for n in range(33):
        vals = (rng.random(n) * 10.0 ** rng.integers(-8, 2, n)).astype(f)
        warp = warp_order_sums(vals, np.array([0]), np.array([n]), 0)[0]
        p = np.zeros((group, WARP // group), f)  # p[g, i]: warp lane g + group * i
        for lane in range(n):
            p[lane % group, lane // group] = (f(0) + vals[lane]).astype(f)
        width = WARP // group
        while width > 1:  # levels 16 .. group, within each group lane
            width //= 2
            p[:, :width] = (p[:, :width] + p[:, width:2 * width]).astype(f)
        x = p[:, 0].copy()
        lvl = group // 2
        while lvl >= 1:  # levels below group, across the group's lanes
            x = (x + x[np.arange(group) ^ lvl]).astype(f)
            lvl //= 2
        assert np.array_equal(x, np.full(group, warp, f))


@pytest.mark.parametrize("launch,entry", [
    ("launch_spmv_csr_rows", "spmv_csr_acc"), ("launch_gs_pass", "gs_pass"),
    ("launch_gs_pass_multi", "gs_pass_multi")])
def test_each_launch_enters_its_operands_card(launch, entry):
    """The three launch helpers read alike: the library's entry point, the
    card's plan and the shared-memory query all run inside
    ``with torch.cuda.device(dev):``, ``dev`` the operands' device, so a
    launch lands on the card its tensors sit on, not the current one.  One
    card cannot show the fault and the CPU runs the plain versions, so the
    check reads the source."""
    import ast
    import inspect

    from repro_torch.kernels.spmv import kernel

    fn = ast.parse(inspect.getsource(getattr(kernel, launch))).body[0]
    guarded = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr) == "torch.cuda.device(dev)"
                for item in node.items):
            guarded |= {id(n) for n in ast.walk(node)}
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    entries = [c for c in calls if ast.unparse(c.func) == f"lib.{entry}"]
    assert len(entries) == 1 and id(entries[0]) in guarded
    # the launch parameters the card decides (its plan, its CTA count) are
    # asked of the same card
    for c in calls:
        if ast.unparse(c.func) in ("gs_pass_plan", "_spmv_ctas"):
            assert id(c) in guarded, ast.unparse(c)
