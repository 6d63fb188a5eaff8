"""The port's graph store (``repro_torch.graphs.store``), its dataset cache
and the launcher's ``--store`` / ``--ckpt``, on the CPU, against the JAX
reference's ``repro.graphs.store``.

* A store is the same bytes in both packages: every file of the port's
  ``save_graph`` equals the reference's (so the manifests and their
  CRC-32s are equal), unweighted, weighted + biased, and reordered with a
  ``perm``; each package loads and verifies the other's store, array for
  array (exact).
* A damaged shard raises ``StoreChecksumError``; a write without its
  manifest is not a store.
* A memmap-loaded graph solves exactly as the resident one through
  ``build_variant`` on a store path (same iterations, ranks bit for bit:
  the device arrays are equal), and building from a read-only memmap on
  the CPU warns of nothing and leaves the files as they were.
* The dataset cache: a hit is memmap-backed and equal to the resident
  build, a damaged entry is rebuilt, ``REPRO_DATASET_CACHE`` routes it,
  its directory is the reference's and so are its files.
* ``--store`` on a BFS-reordered store reports ranks in original ids: the
  resident solve's within 1e-6 L1 (float32 sums in another vertex order),
  the same top-5; ``--ckpt`` records ``bundle_partitions`` and the ranks.
"""
import filecmp
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.graphs import rmat_graph as ref_rmat_graph
from repro.graphs.datasets import dataset_cache_path as ref_dataset_cache_path
from repro.graphs.datasets import make_dataset as ref_make_dataset
from repro.graphs.reorder import compute_order as ref_compute_order
from repro.graphs.reorder import permute_graph as ref_permute_graph
from repro.graphs.store import is_store as ref_is_store
from repro.graphs.store import load_graph as ref_load_graph
from repro.graphs.store import save_graph as ref_save_graph
from repro_torch.core.pagerank import DeviceGraph, PartitionedGraph
from repro_torch.core.runtime import SolverCheckpoint
from repro_torch.core.solver import build_variant
from repro_torch.graphs import (
    GraphStore,
    StoreChecksumError,
    StoreError,
    StoreWriter,
    dataset_cache_path,
    graph_from_arrays,
    is_store,
    load_graph,
    make_dataset,
    save_graph,
)
from repro_torch.graphs.reorder import compute_order, permute_graph
from repro_torch.kernels.spmv import BlockedGraph
from repro_torch.launch import pagerank_run

CACHE_ARGS = dict(name="socEpinions1", scale_down=512.0, seed=0)


def port_graph(g):
    """The reference graph ``g`` as the port's ``Graph`` (copied arrays)."""
    return graph_from_arrays(g.n, g.src, g.dst, g.out_degree, g.in_ptr,
                             weights=g.weights, bias=g.bias)


def assert_same_graph(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    for name in ("src", "dst", "out_degree", "in_ptr", "weights", "bias"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            assert np.array_equal(np.asarray(va), np.asarray(vb)), name


def assert_same_files(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    match, mismatch, errors = filecmp.cmpfiles(dir_a, dir_b, names, shallow=False)
    assert mismatch == [] and errors == [] and sorted(match) == names


def _case(kind):
    """``(reference graph, perm, order)`` of one store case."""
    g = ref_rmat_graph(8, avg_degree=6, seed=3)
    if kind == "weighted+biased":
        rng = np.random.default_rng(0)
        g.weights = 1.0 - rng.random(g.m)
        g.bias = rng.uniform(0.5, 1.5, g.n)
    if kind == "perm":
        perm = ref_compute_order(g, "bfs")
        return ref_permute_graph(g, perm), perm, "bfs"
    return g, None, "none"


CASES = ("unweighted", "weighted+biased", "perm")


@pytest.mark.parametrize("kind", CASES)
def test_store_files_equal_the_references(tmp_path, kind):
    g, perm, order = _case(kind)
    extra = {"dataset": "rmat", "case": kind}
    ref_save_graph(tmp_path / "ref", g, perm=perm, order=order, extra=extra)
    st = save_graph(tmp_path / "port", port_graph(g), perm=perm, order=order,
                    extra=extra)
    assert_same_files(tmp_path / "ref", tmp_path / "port")
    meta = json.loads((tmp_path / "port" / "META.json").read_text())
    assert meta == json.loads((tmp_path / "ref" / "META.json").read_text())
    assert set(meta["arrays"]) == {"src", "dst", "out_degree", "in_ptr"} | (
        {"weights", "bias"} if kind == "weighted+biased" else set()) | (
        {"perm"} if perm is not None else set())
    assert (st.n, st.m, st.order) == (g.n, g.m, order)
    assert st.nbytes() == sum(os.path.getsize(tmp_path / "port" / r["file"])
                              for r in meta["arrays"].values())


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("writer", ("reference", "port"))
def test_each_package_loads_the_others_store(tmp_path, kind, writer):
    g, perm, order = _case(kind)
    path = tmp_path / "s"
    if writer == "reference":
        ref_save_graph(path, g, perm=perm, order=order)
        for mmap in (True, False):
            h = load_graph(path, mmap=mmap, verify=True)
            assert h.is_memmap == mmap
            assert_same_graph(g, h)
        st = GraphStore(path)
        st.verify()
        assert st.order == order
        got = st.perm()
        assert (got is None) == (perm is None)
        if perm is not None:
            assert np.array_equal(got, perm)
    else:
        save_graph(path, port_graph(g), perm=perm, order=order)
        assert ref_is_store(path)
        for mmap in (True, False):
            h = ref_load_graph(path, mmap=mmap, verify=True)
            assert h.is_memmap == mmap
            assert_same_graph(g, h)


def test_edge_chunks_equal_the_references():
    g, _, _ = _case("weighted+biased")
    t = port_graph(g)
    for size in (1, 7, 1 << 20):
        ours, theirs = list(t.edge_chunks(size)), list(g.edge_chunks(size))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                assert np.array_equal(x, y)
    with pytest.raises(ValueError):
        next(t.edge_chunks(0))


def test_a_damaged_shard_is_refused(tmp_path):
    g = port_graph(ref_rmat_graph(6, seed=2))
    save_graph(tmp_path / "s", g)
    with open(tmp_path / "s" / "src.bin", "r+b") as f:
        f.seek(4)
        f.write(b"\x99")
    with pytest.raises(StoreChecksumError, match="src.bin"):
        load_graph(tmp_path / "s", verify=True)
    with pytest.raises(StoreChecksumError):
        GraphStore(tmp_path / "s").verify()
    load_graph(tmp_path / "s", verify=False)  # the fast path trusts the manifest
    os.remove(tmp_path / "s" / "dst.bin")
    with pytest.raises(StoreChecksumError, match="missing"):
        GraphStore(tmp_path / "s").verify()


def test_a_write_without_its_manifest_is_not_a_store(tmp_path):
    g = port_graph(ref_rmat_graph(6, seed=2))
    w = StoreWriter(tmp_path / "s", g.n)
    for _, src, dst, _ in g.edge_chunks(50):
        w.append(src, dst)
    # interrupted before finalize: the shards are there, the manifest is not
    assert os.path.isfile(tmp_path / "s" / "src.bin")
    assert not is_store(tmp_path / "s") and not ref_is_store(tmp_path / "s")
    with pytest.raises(StoreError, match="META.json"):
        GraphStore(tmp_path / "s")
    st = w.finalize()
    assert is_store(tmp_path / "s")
    assert_same_graph(g, st.graph())
    with pytest.raises(StoreError, match="twice"):
        w.finalize()
    with pytest.raises(ValueError, match="order"):
        StoreWriter(tmp_path / "t", 4).append(np.array([1, 0], np.int32),
                                              np.array([2, 1], np.int32))


def test_a_newer_or_foreign_manifest_is_refused(tmp_path):
    g = port_graph(ref_rmat_graph(6, seed=2))
    save_graph(tmp_path / "s", g)
    meta_path = tmp_path / "s" / "META.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "version": 2}))
    with pytest.raises(StoreError, match="newer"):
        GraphStore(tmp_path / "s")
    meta_path.write_text(json.dumps({**meta, "format": "other"}))
    with pytest.raises(StoreError, match="format"):
        GraphStore(tmp_path / "s")


def test_an_empty_graph_round_trips(tmp_path):
    from repro_torch.graphs import Graph

    g = Graph.from_edges(4, np.zeros(0, np.int32), np.zeros(0, np.int32))
    save_graph(tmp_path / "s", g)
    assert_same_graph(g, load_graph(tmp_path / "s", verify=True))


VARIANTS = {"barrier": {}, "nosync": {"threads": 4}, "blocked": {"block": 32},
            "blocked_nosync": {"block": 32}, "distributed_barrier": {"threads": 4}}


@pytest.mark.parametrize("name", VARIANTS)
def test_a_memmap_store_solves_as_the_resident_graph(tmp_path, name):
    g = port_graph(ref_rmat_graph(8, avg_degree=5, seed=5))
    save_graph(tmp_path / "s", g)
    opts = dict(VARIANTS[name], device="cpu")
    runs = []
    for graph in (g, str(tmp_path / "s")):
        v, bundle = build_variant(name, graph, **opts)
        runs.append(v.run(bundle, threshold=1e-7, handle_dangling=True, **opts))
    a, b = runs
    assert a.iterations == b.iterations and a.iterations > 1
    assert torch.equal(torch.as_tensor(a.pr), torch.as_tensor(b.pr))


def test_builds_from_a_read_only_memmap_copy_and_warn_of_nothing(tmp_path):
    g = port_graph(ref_rmat_graph(8, avg_degree=5, seed=5))
    rng = np.random.default_rng(1)
    g.weights, g.bias = 1.0 - rng.random(g.m), rng.uniform(0.5, 1.5, g.n)
    save_graph(tmp_path / "s", g)
    h = load_graph(tmp_path / "s", mmap=True)
    assert h.is_memmap
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch warns on a non-writable array
        dg = DeviceGraph.from_graph(h, "cpu")
        bg = BlockedGraph.build(h, block=32, device="cpu")
        pg = PartitionedGraph.from_graph(h, p=4, device="cpu")
    assert torch.equal(dg.src, torch.as_tensor(g.src, dtype=torch.int64))
    assert torch.equal(bg.src, torch.as_tensor(g.src))
    assert torch.equal(bg.weights, torch.as_tensor(g.weights, dtype=torch.float32))
    # the tensors are copies: writing them leaves the store as it was
    for t in (dg.src, dg.in_ptr, dg.weights, bg.src, bg.in_ptr, bg.weights,
              pg.src_pad):
        t.zero_()
    GraphStore(tmp_path / "s").verify()
    assert_same_graph(g, h)


def test_dataset_cache_hit_is_the_memmap_of_the_build(tmp_path):
    resident = make_dataset(CACHE_ARGS["name"], CACHE_ARGS["scale_down"])
    first = make_dataset(cache_dir=str(tmp_path), **CACHE_ARGS)
    assert not first.is_memmap  # a miss returns what it built
    assert_same_graph(resident, first)
    path = dataset_cache_path(CACHE_ARGS["name"], CACHE_ARGS["scale_down"],
                              CACHE_ARGS["seed"], str(tmp_path))
    assert is_store(path)
    assert GraphStore(path).meta["extra"] == {"dataset": "socEpinions1",
                                              "scale_down": 512.0, "seed": 0}
    hit = make_dataset(cache_dir=str(tmp_path), **CACHE_ARGS)
    assert hit.is_memmap
    assert_same_graph(resident, hit)
    assert not make_dataset(cache_dir=str(tmp_path), mmap=False,
                            **CACHE_ARGS).is_memmap


def test_dataset_cache_entry_equals_the_references(tmp_path):
    make_dataset(cache_dir=str(tmp_path / "port"), **CACHE_ARGS)
    ref_make_dataset(cache_dir=str(tmp_path / "ref"), **CACHE_ARGS)
    entry = os.path.basename(dataset_cache_path(
        CACHE_ARGS["name"], CACHE_ARGS["scale_down"], CACHE_ARGS["seed"], "."))
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "ref") == [entry]
    assert_same_files(tmp_path / "port" / entry, tmp_path / "ref" / entry)


@pytest.mark.parametrize("damage", ("flip a byte", "drop the manifest's shard"))
def test_a_damaged_cache_entry_is_rebuilt(tmp_path, damage):
    make_dataset(cache_dir=str(tmp_path), **CACHE_ARGS)
    path = dataset_cache_path(CACHE_ARGS["name"], CACHE_ARGS["scale_down"],
                              CACHE_ARGS["seed"], str(tmp_path))
    if damage == "flip a byte":
        with open(os.path.join(path, "dst.bin"), "r+b") as f:
            f.write(b"\xde\xad\xbe\xef")
    else:
        os.remove(os.path.join(path, "in_ptr.bin"))
    g = make_dataset(cache_dir=str(tmp_path), **CACHE_ARGS)
    assert not g.is_memmap  # rebuilt, not loaded
    assert_same_graph(make_dataset(CACHE_ARGS["name"], CACHE_ARGS["scale_down"]), g)
    GraphStore(path).verify()  # the entry is whole again


def test_the_cache_variable_routes_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DATASET_CACHE", str(tmp_path))
    make_dataset(CACHE_ARGS["name"], CACHE_ARGS["scale_down"])
    assert is_store(dataset_cache_path(CACHE_ARGS["name"], CACHE_ARGS["scale_down"],
                                       0, str(tmp_path)))
    assert make_dataset(CACHE_ARGS["name"], CACHE_ARGS["scale_down"]).is_memmap
    monkeypatch.setenv("REPRO_DATASET_CACHE", "")  # empty: no cache
    assert not make_dataset(CACHE_ARGS["name"], CACHE_ARGS["scale_down"]).is_memmap


@pytest.mark.parametrize("name,scale_down,seed", [
    ("webStanford", 1, 0), ("webStanford", 1.5, 3), ("socLiveJournal1", 1.0, 0),
    ("D10", 2048, 7), ("rmatSkew", 0.5, 1)])
def test_dataset_cache_path_is_the_references(name, scale_down, seed):
    assert dataset_cache_path(name, scale_down, seed, "cache") == \
        ref_dataset_cache_path(name, scale_down, seed, "cache")


@pytest.fixture(scope="module")
def bfs_store(tmp_path_factory):
    """webStanford at scale_down 256 saved BFS-ordered with its perm, and
    the resident graph."""
    g = make_dataset("webStanford", scale_down=256)
    perm = compute_order(g, "bfs")
    path = tmp_path_factory.mktemp("stores") / "ws_bfs"
    save_graph(path, permute_graph(g, perm), perm=perm, order="bfs")
    return str(path), g


def test_launcher_store_reports_original_ids(bfs_store, capsys):
    path, g = bfs_store
    argv = ["--variant", "blocked_nosync", "--handle-dangling", "--device", "cpu",
            "--threshold", "1e-8"]
    rep = pagerank_run.run(["--store", path] + argv)
    assert f"store {path}: n={g.n} m={g.m} order=bfs (memmap)" in capsys.readouterr().out
    resident = pagerank_run.run(["--dataset", "webStanford", "--scale-down", "256"]
                                + argv)
    assert rep["n"] == g.n and rep["pr"].shape == (g.n,)
    assert np.abs(rep["pr"].astype(np.float64) - resident["pr"]).sum() < 1e-6
    assert rep["top5"] == resident["top5"]
    assert rep["l1"] < 1e-5


@pytest.mark.parametrize("variant,opts,p", [
    ("blocked_nosync", [], 1), ("nosync", ["--threads", "4"], 4),
    ("barrier_sticd", [], 1)])
def test_launcher_ckpt_records_bundle_partitions(bfs_store, tmp_path, capsys,
                                                  variant, opts, p):
    path, g = bfs_store
    rep = pagerank_run.run(["--store", path, "--variant", variant, "--device", "cpu",
                            "--ckpt", str(tmp_path / "pr")] + opts)
    assert f"checkpointed to {tmp_path / 'pr'}.npz (p={p})" in capsys.readouterr().out
    assert rep["ckpt"] == f"{tmp_path / 'pr'}.npz" and rep["ckpt_p"] == p
    ck = SolverCheckpoint.load(str(tmp_path / "pr"))
    assert (ck.n, ck.p, ck.round) == (g.n, p, rep["iterations"])
    assert np.array_equal(ck.pr, rep["pr"])
