"""The port's out-of-core build pipeline (``repro_torch.graphs.pipeline``),
its chunked R-MAT emitter and spill machinery, and the launcher's ``build``
and ``--store <build dir>``, on the CPU, against the JAX reference's
``repro.graphs.pipeline`` on the same inputs.

Everything here is host numpy in both packages, so every comparison is
exact: chunks bit for bit, spill files and stores byte for byte,
``PIPELINE.json`` and ``LAYOUT.json`` key for key.  The stated exceptions:

* ``PIPELINE.json`` differs in each stage's ``wall_s``, in the paths under
  each build directory, and in the layout stage's info, where the
  reference records its tile statistics (``occupancy``, ``n_tiles``) and
  the port its partitions' largest and mean in-edges; ``LAYOUT.json`` is
  compared on its three keys (``threads``, ``partition_bounds``,
  ``partition_edges``), as the port writes no ``tile_stats``.
* ``reorder_store`` records a config of its own in ``META.json``'s
  ``extra``, so its store equals a build's with ``extra`` aside.
* A BFS build's ranks, unpermuted, are within 1e-10 max-norm of the
  unordered graph's float64 oracle (the reference's bound); a ``--store``
  solve of a build directory within 1e-6 L1 of the resident solve's
  (float32 sums in another vertex order).
* The generate stage's peak of traced allocations (``tracemalloc``, which
  sees numpy's buffers) is within 1.1× the reference's at the same config.
"""
import filecmp
import json
import os
import re
import shutil
import tracemalloc

import numpy as np
import pytest

from repro.graphs import pipeline as ref_pipeline
from repro.graphs import rmat as ref_rmat
from repro.graphs import store as ref_store
from repro.graphs.datasets import _dataset_rmat_params as ref_dataset_rmat_params
from repro.graphs.datasets import make_dataset as ref_make_dataset
from repro.launch import pagerank_run as ref_pagerank_run
from repro_torch.core.pagerank import pagerank_numpy
from repro_torch.core.runtime import SolverCheckpoint
from repro_torch.graphs import (
    ORDERS,
    Graph,
    GraphStore,
    StoreError,
    dataset_cache_path,
    make_dataset,
    rmat_edges,
    rmat_graph,
    unpermute_ranks,
)
from repro_torch.graphs import pipeline, rmat, store
from repro_torch.graphs.pipeline import (
    BuildConfig,
    final_store_path,
    raw_store_path,
    reorder_store,
    reordered_store_path,
    run_pipeline,
)
from repro_torch.launch import pagerank_run

QUIET = dict(log=lambda msg: None)
# the reference's pipeline fixture (tests/test_store.py)
RMAT_CFG = dict(scale=9, avg_degree=6, seed=21, chunk_edges=700, threads=4)
SURROGATE = ("socEpinions1", 64.0)  # n 1,185, m 7,950
LAYOUT_KEYS = ("threads", "partition_bounds", "partition_edges")


def surrogate_cfg(module, name, scale_down, **kw):
    """The reference launcher's ``build --dataset`` config, in ``module``'s
    BuildConfig."""
    n, m, (a, b, c) = ref_dataset_rmat_params(name, scale_down)
    scale = max(6, int(np.ceil(np.log2(n))))
    return module.BuildConfig(scale=scale, n_edges=m, fold_n=n, a=a, b=b, c=c,
                              dedupe=False, **kw)


def configs(module, order):
    return {"rmat": module.BuildConfig(order=order, **RMAT_CFG),
            "surrogate": surrogate_cfg(module, *SURROGATE, order=order,
                                       chunk_edges=1000, threads=4)}


def assert_same_store(dir_a, dir_b, extra=True):
    """Every file of two stores byte for byte equal; ``META.json`` key for
    key, with ``extra`` aside when ``extra`` is False; ``LAYOUT.json`` on
    the port's three keys."""
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name == "META.json":
            ma, mb = (json.load(open(p, encoding="utf-8")) for p in (a, b))
            if not extra:
                ma.pop("extra"), mb.pop("extra")
            assert ma == mb
        elif name == "LAYOUT.json":
            la, lb = (json.load(open(p, encoding="utf-8")) for p in (a, b))
            assert {k: la[k] for k in LAYOUT_KEYS} == {k: lb[k] for k in LAYOUT_KEYS}
        else:
            assert filecmp.cmp(a, b, shallow=False), name


def assert_same_build(dir_a, dir_b):
    """Two build directories hold the same stores."""
    for sub in ("raw", "reordered"):
        a, b = os.path.join(dir_a, sub), os.path.join(dir_b, sub)
        assert os.path.isdir(a) == os.path.isdir(b), sub
        if os.path.isdir(a):
            assert_same_store(a, b)


def crcs(path):
    return {k: v["crc32"] for k, v in GraphStore(path).meta["arrays"].items()}


def normalized_progress(out_dir):
    """``PIPELINE.json`` without walls, with paths relative to ``out_dir``
    and without the layout stage's package-specific summary."""
    prog = json.load(open(os.path.join(out_dir, "PIPELINE.json"), encoding="utf-8"))
    for name, state in prog["stages"].items():
        state.pop("wall_s", None)
        for key in ("store", "adopted"):
            if key in state:
                state[key] = os.path.relpath(state[key], out_dir)
        if name == "layout":
            for key in ("occupancy", "n_tiles", "max_partition_edges",
                        "mean_partition_edges"):
                state.pop(key, None)
    return prog


# ---------------------------------------------------------------------------
# R-MAT chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_edges", [1, 577, 1024, 3000, 3005])
@pytest.mark.parametrize("seed", [0, 11])
def test_rmat_chunks_are_the_references_and_concatenate_to_rmat_edges(seed, chunk_edges):
    scale, m = 9, 3000  # chunk sizes 1, 577, 1024, m and m + 5
    assert np.array_equal(rmat.rmat_vertex_perm(scale, m, seed),
                          ref_rmat.rmat_vertex_perm(scale, m, seed))
    got = list(rmat.rmat_edge_chunks(scale, m, seed=seed, chunk_edges=chunk_edges))
    want = list(ref_rmat.rmat_edge_chunks(scale, m, seed=seed, chunk_edges=chunk_edges))
    assert len(got) == len(want) == -(-m // chunk_edges)
    for (lo, s, d), (rlo, rs, rd) in zip(got, want):
        assert lo == rlo and s.dtype == rs.dtype == np.int32
        assert np.array_equal(s, rs) and np.array_equal(d, rd)
    s_all, d_all = rmat_edges(scale, m, seed=seed)
    assert np.array_equal(np.concatenate([c[1] for c in got]), s_all)
    assert np.array_equal(np.concatenate([c[2] for c in got]), d_all)


@pytest.mark.parametrize("abc", [(0.57, 0.19, 0.19), (0.30, 0.25, 0.25)])
def test_an_arbitrary_slice_is_the_references(abc):
    scale, m = 8, 2000
    a, b, c = abc
    s_all, d_all = rmat_edges(scale, m, a=a, b=b, c=c, seed=4)
    perm = ref_rmat.rmat_vertex_perm(scale, m, seed=4)
    s, d = rmat.rmat_chunk(scale, m, 700, 1300, a=a, b=b, c=c, seed=4)
    rs, rd = ref_rmat.rmat_chunk(scale, m, 700, 1300, a=a, b=b, c=c, seed=4, perm=perm)
    assert np.array_equal(s, s_all[700:1300]) and np.array_equal(d, d_all[700:1300])
    assert np.array_equal(s, rs) and np.array_equal(d, rd)


@pytest.mark.parametrize("lo,hi", [(-1, 5), (10, 9), (0, 2001), (2001, 2001)])
def test_a_chunk_outside_the_stream_raises(lo, hi):
    for module in (rmat, ref_rmat):
        with pytest.raises(ValueError, match=rf"chunk \[{lo}, {hi}\) outside \[0, 2000\)"):
            module.rmat_chunk(8, 2000, lo, hi)


@pytest.mark.parametrize("chunk_edges", [0, -3])
def test_a_chunk_size_below_one_raises(chunk_edges):
    for module in (rmat, ref_rmat):
        with pytest.raises(ValueError, match="chunk_edges must be >= 1"):
            list(module.rmat_edge_chunks(8, 2000, chunk_edges=chunk_edges))


# ---------------------------------------------------------------------------
# Spill files and the merge
# ---------------------------------------------------------------------------


def _edges(seed, m=3000, n=97, weighted=False):
    """Edges with many duplicates (n small against m)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.random(m) if weighted else None
    return n, src, dst, w


@pytest.mark.parametrize("kind", ["unweighted", "weighted", "dedupe", "empty", "wide ids"])
def test_spill_files_are_the_references_bytes(tmp_path, kind):
    # "wide ids" spans the int32 range, where a sort key could overflow
    n, src, dst, w = _edges(1, n=2**31 - 1 if kind == "wide ids" else 97,
                            weighted=kind == "weighted")
    if kind == "empty":
        src, dst = src[:0], dst[:0]
    kw = dict(weights=w, dedupe=kind == "dedupe")
    rec = store.write_spill_chunk(tmp_path / "port.npy", src, dst, **kw)
    ref = ref_store.write_spill_chunk(tmp_path / "ref.npy", src, dst, **kw)
    assert rec == ref
    assert filecmp.cmp(tmp_path / "port.npy", tmp_path / "ref.npy", shallow=False)
    arr = np.load(tmp_path / "port.npy")
    key = arr["dst"].astype(np.int64) * n + arr["src"]
    assert np.all(np.diff(key) > 0) if kind == "dedupe" else np.all(np.diff(key) >= 0)
    assert rec["rows"] == (len(np.unique(key)) if kind == "dedupe" else src.size)
    assert not os.path.exists(tmp_path / "port.npy.tmp")


def test_dedupe_of_weighted_spills_raises_as_the_references(tmp_path):
    _, src, dst, w = _edges(2, weighted=True)
    for module in (store, ref_store):
        with pytest.raises(ValueError, match="dedupe of weighted edges is ambiguous"):
            module.write_spill_chunk(tmp_path / "x.npy", src, dst, weights=w, dedupe=True)
    assert not os.path.exists(tmp_path / "x.npy")


@pytest.mark.parametrize("block", [1, 7, 1 << 16])
@pytest.mark.parametrize("case", ["plain", "dedupe", "weighted"])
def test_merged_stores_are_the_references(tmp_path, case, block):
    """Five spill chunks whose duplicates straddle chunk boundaries, merged
    with small blocks (many rounds) and with one round's worth: the stores
    are the reference's file for file and the graph of all the edges
    (deduped where asked)."""
    n, src, dst, w = _edges(3, weighted=case == "weighted")
    dedupe = case == "dedupe"
    bounds = [0, 400, 401, 1500, 2200, 3000]
    for module, name in ((store, "port"), (ref_store, "ref")):
        files = []
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            path = tmp_path / f"{name}_chunk{i}.npy"
            module.write_spill_chunk(path, src[lo:hi], dst[lo:hi],
                                     weights=None if w is None else w[lo:hi],
                                     dedupe=dedupe)
            files.append(path)
        writer = module.StoreWriter(tmp_path / name, n, weighted=w is not None)
        module.merge_spill_chunks(files, n, writer, dedupe=dedupe, block=block)
        writer.finalize(order="none")
    assert_same_store(tmp_path / "port", tmp_path / "ref")
    g = GraphStore(tmp_path / "port").graph(mmap=False)
    key = dst.astype(np.int64) * n + src
    if dedupe:
        _, first = np.unique(key, return_index=True)
        want = Graph.from_edges(n, src[first], dst[first])
    else:
        want = Graph.from_edges(n, src, dst, weights=w)
    assert g.m == want.m and (g.m < 3000 if dedupe else g.m == 3000)
    for field in ("src", "dst", "out_degree", "in_ptr"):
        assert np.array_equal(getattr(g, field), getattr(want, field)), field
    if w is not None:
        # the same weights on each (dst, src) key: parallel edges from two
        # chunks may come out in either chunk's order
        def triples(h):
            order = np.lexsort((h.weights, h.src, h.dst))
            return h.dst[order], h.src[order], h.weights[order]

        for a, b in zip(triples(g), triples(want)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("damage", ["missing", "tampered", "no record", "other crc"])
def test_spill_set_rejects_a_chunk_it_cannot_trust(tmp_path, damage):
    spill = store.SpillSet(str(tmp_path / "spill"))
    _, src, dst, _ = _edges(4)
    rec = store.write_spill_chunk(spill.chunk_path(3), src, dst)
    assert spill.chunk_path(3).endswith("chunk_000003.npy")
    assert spill.valid(3, rec)
    assert spill.valid(3, rec) == ref_store.SpillSet(spill.dir).valid(3, rec)
    if damage == "missing":
        os.unlink(spill.chunk_path(3))
    elif damage == "tampered":
        with open(spill.chunk_path(3), "r+b") as f:
            f.seek(-4, os.SEEK_END)
            f.write(b"\xde\xad\xbe\xef")
    elif damage == "no record":
        rec = None
    else:
        rec = dict(rec, crc32=rec["crc32"] ^ 1)
    assert not spill.valid(3, rec)
    assert not ref_store.SpillSet(spill.dir).valid(3, rec)
    spill.cleanup()
    assert not os.path.exists(spill.dir)
    spill.cleanup()  # a second cleanup finds nothing to remove


# ---------------------------------------------------------------------------
# run_pipeline against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["rmat", "surrogate"])
@pytest.mark.parametrize("order", ORDERS)
def test_run_pipeline_is_the_references(tmp_path, order, source):
    port = run_pipeline(tmp_path / "port", configs(pipeline, order)[source], **QUIET)
    ref = ref_pipeline.run_pipeline(tmp_path / "ref", configs(ref_pipeline, order)[source],
                                    **QUIET)
    assert list(port["stages"]) == list(ref["stages"])
    assert os.path.relpath(port["store"], tmp_path / "port") == \
        os.path.relpath(ref["store"], tmp_path / "ref")
    assert_same_build(tmp_path / "port", tmp_path / "ref")
    assert normalized_progress(tmp_path / "port") == normalized_progress(tmp_path / "ref")
    layout = GraphStore(port["store"]).layout()
    assert sorted(layout) == sorted(LAYOUT_KEYS)
    g = GraphStore(port["store"]).graph(mmap=True)
    assert layout["partition_bounds"] == g.partition_ranges(4).tolist()
    assert sum(layout["partition_edges"]) == g.m
    assert not os.path.exists(tmp_path / "port" / "chunks")
    assert not os.path.exists(tmp_path / "port" / "reorder_chunks")


@pytest.mark.parametrize("source", ["rmat", "surrogate"])
def test_an_unordered_build_is_the_in_ram_graph(tmp_path, source):
    cfg = configs(pipeline, "none")[source]
    res = run_pipeline(tmp_path / "b", cfg, **QUIET)
    assert res["store"] == raw_store_path(tmp_path / "b")
    g = GraphStore(res["store"]).graph(mmap=False)
    if source == "rmat":
        want = rmat_graph(cfg.scale, cfg.avg_degree, seed=cfg.seed)
    else:
        want = make_dataset(*SURROGATE)
        assert_graphs_equal(want, ref_make_dataset(*SURROGATE))
    assert_graphs_equal(g, want)


def assert_graphs_equal(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    for name in ("src", "dst", "out_degree", "in_ptr"):
        assert np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))), name
    assert a.weights is None and b.weights is None and a.bias is None


@pytest.mark.parametrize("order", ["bfs", "degree", "random"])
def test_a_reordered_build_solves_to_the_unordered_oracle(tmp_path, order):
    cfg = BuildConfig(order=order, **RMAT_CFG)
    res = run_pipeline(tmp_path / "b", cfg, **QUIET)
    st = GraphStore(res["store"])
    assert res["store"] == reordered_store_path(tmp_path / "b") and st.order == order
    g = st.graph(mmap=True)
    assert g.is_memmap
    ref, _ = pagerank_numpy(rmat_graph(cfg.scale, cfg.avg_degree, seed=cfg.seed),
                            threshold=1e-13)
    pr, _ = pagerank_numpy(g, threshold=1e-13)
    assert np.abs(unpermute_ranks(pr, st.perm()) - ref).max() < 1e-10


# ---------------------------------------------------------------------------
# Resume
# ---------------------------------------------------------------------------


def test_a_build_resumed_between_stages_is_a_fresh_one(tmp_path):
    cfg = BuildConfig(order="bfs", **RMAT_CFG)
    first = run_pipeline(tmp_path / "killed", cfg, stages=["generate"], **QUIET)
    assert list(first["stages"]) == ["generate"]
    log = []
    a = run_pipeline(tmp_path / "killed", log=log.append)
    assert a["stages"]["generate"]["skipped"] and "generate: already complete, skipping" in log
    assert not any(s.get("skipped") for k, s in a["stages"].items() if k != "generate")
    b = run_pipeline(tmp_path / "fresh", cfg, **QUIET)
    assert crcs(a["store"]) == crcs(b["store"])
    assert_same_build(tmp_path / "killed", tmp_path / "fresh")
    again = run_pipeline(tmp_path / "killed", cfg, **QUIET)
    assert all(s["skipped"] for s in again["stages"].values())
    assert list(again["stages"]) == list(pipeline.STAGES)


class Interrupt(RuntimeError):
    pass


def _spill_killer(monkeypatch, module, after):
    """Make ``module``'s pipeline raise on its ``after + 1``-th spill write."""
    real = module.write_spill_chunk
    calls = {"n": 0}

    def write(*args, **kw):
        if calls["n"] == after:
            raise Interrupt("killed")
        calls["n"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(module, "write_spill_chunk", write)
    return lambda: monkeypatch.setattr(module, "write_spill_chunk", real)


@pytest.mark.parametrize("stage,n_chunks", [("generate", 5), ("reorder", 4)])
@pytest.mark.parametrize("mod", [pipeline, ref_pipeline], ids=["port", "ref"])
def test_a_build_killed_at_a_chunk_reuses_the_chunks_written(tmp_path, monkeypatch,
                                                              mod, stage, n_chunks):
    """Killed after 3 spill chunks of a stage (5 generate chunks of 700 of
    the 3,072 edges drawn, 4 reorder chunks of the 2,545 kept): the resume
    reuses exactly those 3 and ends file for file a fresh build."""
    cfg = mod.BuildConfig(order="bfs", **RMAT_CFG)
    out = tmp_path / "killed"
    if stage == "reorder":
        mod.run_pipeline(out, cfg, stages=["generate"], **QUIET)
    restore = _spill_killer(monkeypatch, mod, after=3)
    with pytest.raises(Interrupt):
        mod.run_pipeline(out, cfg, **QUIET)
    restore()
    prog = mod.load_progress(out)
    assert sorted(prog["stages"][stage]["chunks"]) == ["0", "1", "2"]
    log = []
    mod.run_pipeline(out, log=log.append)
    assert f"{stage}: resumed, reusing 3/{n_chunks} spill chunks" in log
    run_pipeline(tmp_path / "fresh", BuildConfig(order="bfs", **RMAT_CFG), **QUIET)
    assert_same_build(out, tmp_path / "fresh")


def test_a_tampered_spill_chunk_is_written_again(tmp_path, monkeypatch):
    cfg = BuildConfig(order="none", **RMAT_CFG)
    out = tmp_path / "killed"
    restore = _spill_killer(monkeypatch, pipeline, after=3)
    with pytest.raises(Interrupt):
        run_pipeline(out, cfg, **QUIET)
    restore()
    with open(out / "chunks" / "chunk_000001.npy", "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\x00" * 8)
    log = []
    run_pipeline(out, log=log.append)
    assert "generate: resumed, reusing 2/5 spill chunks" in log
    run_pipeline(tmp_path / "fresh", cfg, **QUIET)
    assert_same_build(out, tmp_path / "fresh")


@pytest.mark.parametrize("stage", ["generate", "reorder"])
@pytest.mark.parametrize("mod", [pipeline, ref_pipeline], ids=["port", "ref"])
def test_a_build_killed_in_the_merge_resumes(tmp_path, monkeypatch, mod, stage):
    """``StoreWriter.finalize`` raises once, after the merge wrote the edge
    files and before any manifest: the resume writes the stage again from
    its spill chunks (all reused) and ends file for file a fresh build."""
    cfg = mod.BuildConfig(order="bfs", **RMAT_CFG)
    out = tmp_path / "killed"
    if stage == "reorder":
        mod.run_pipeline(out, cfg, stages=["generate"], **QUIET)
    writer = store.StoreWriter if mod is pipeline else ref_store.StoreWriter
    real = writer.finalize

    def finalize(self, *args, **kw):
        # the edge files reach the disk, as they would before a kill; left
        # open, their buffers would flush over the resumed stage's files
        for part in (self._src, self._dst, self._w):
            if part is not None:
                part.fh.close()
        monkeypatch.setattr(writer, "finalize", real)
        raise Interrupt("killed in the merge")

    monkeypatch.setattr(writer, "finalize", finalize)
    with pytest.raises(Interrupt):
        mod.run_pipeline(out, cfg, **QUIET)
    sub = "raw" if stage == "generate" else "reordered"
    assert os.path.isfile(out / sub / "src.bin") and not os.path.exists(out / sub / "META.json")
    log = []
    mod.run_pipeline(out, log=log.append)
    n_chunks = 5 if stage == "generate" else 4
    assert f"{stage}: resumed, reusing {n_chunks}/{n_chunks} spill chunks" in log
    run_pipeline(tmp_path / "fresh", BuildConfig(order="bfs", **RMAT_CFG), **QUIET)
    assert_same_build(out, tmp_path / "fresh")


def _error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_a_config_mismatch_raises_the_references_error(tmp_path):
    msgs = []
    for mod, name in ((pipeline, "port"), (ref_pipeline, "ref")):
        out = tmp_path / name
        mod.run_pipeline(out, mod.BuildConfig(order="none", **RMAT_CFG),
                         stages=["generate"], **QUIET)
        other = mod.BuildConfig(order="none", **{**RMAT_CFG, "seed": 99})
        msgs.append(_error(lambda: mod.run_pipeline(out, other, **QUIET))
                    .replace(str(out), "<out>"))
    assert msgs[0] == msgs[1] and "different config" in msgs[0]


@pytest.mark.parametrize("stages,want", [(["reorder"], "needs 'generate'"),
                                         (["layout"], "needs 'generate'"),
                                         (["generate", "bogus"], "unknown stage")])
def test_an_out_of_order_or_unknown_stage_raises_the_references_error(tmp_path, stages,
                                                                      want):
    msgs = [_error(lambda: mod.run_pipeline(tmp_path / name,
                                            mod.BuildConfig(order="bfs", **RMAT_CFG),
                                            stages=stages, **QUIET))
            .replace(str(tmp_path / name), "<out>")
            for mod, name in ((pipeline, "port"), (ref_pipeline, "ref"))]
    assert msgs[0] == msgs[1] and want in msgs[0]


def test_a_resume_without_a_config_or_a_record_raises(tmp_path):
    msgs = [_error(lambda: mod.run_pipeline(tmp_path / name, **QUIET))
            .replace(str(tmp_path / name), "<out>")
            for mod, name in ((pipeline, "port"), (ref_pipeline, "ref"))]
    assert msgs[0] == msgs[1] and "no pipeline to resume" in msgs[0]
    for mod in (pipeline, ref_pipeline):
        with pytest.raises(ValueError, match="order 'hilbert' not in"):
            mod.BuildConfig(scale=4, order="hilbert")


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,second", [(ref_pipeline, pipeline), (pipeline, ref_pipeline)],
                         ids=["ref-then-port", "port-then-ref"])
@pytest.mark.parametrize("order", ["bfs", "none"])
def test_a_build_started_by_one_package_is_finished_by_the_other(tmp_path, first, second,
                                                                  order):
    cfg = first.BuildConfig(order=order, **RMAT_CFG)
    first.run_pipeline(tmp_path / "b", cfg, stages=["generate"], **QUIET)
    res = second.run_pipeline(tmp_path / "b", **QUIET)
    assert res["stages"]["generate"]["skipped"]
    for name, mod in (("port", pipeline), ("ref", ref_pipeline)):
        mod.run_pipeline(tmp_path / name, mod.BuildConfig(order=order, **RMAT_CFG), **QUIET)
        assert_same_build(tmp_path / "b", tmp_path / name)
    assert normalized_progress(tmp_path / "b")["config"] == cfg.to_dict()


# ---------------------------------------------------------------------------
# reorder_store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["bfs", "degree"])
def test_reorder_store_of_a_cache_entry_is_the_builds_reorder(tmp_path, order):
    name, scale_down = SURROGATE
    make_dataset(name, scale_down, cache_dir=str(tmp_path / "cache"))
    entry = dataset_cache_path(name, scale_down, 0, str(tmp_path / "cache"))
    res = reorder_store(entry, tmp_path / "reordered", order=order, threads=4, **QUIET)
    assert res["store"] == reordered_store_path(tmp_path / "reordered")
    assert list(res["stages"]) == ["reorder", "layout"]
    # the cache entry copied in as the raw stage, untouched
    assert_same_store(raw_store_path(tmp_path / "reordered"), entry)
    built = run_pipeline(tmp_path / "built",
                         surrogate_cfg(pipeline, name, scale_down, order=order,
                                       chunk_edges=1000, threads=4), **QUIET)
    assert_same_store(res["store"], built["store"], extra=False)
    assert np.array_equal(GraphStore(res["store"]).perm(), GraphStore(built["store"]).perm())
    ref = ref_pipeline.reorder_store(entry, tmp_path / "ref", order=order, threads=4, **QUIET)
    assert_same_store(res["store"], ref["store"])
    assert normalized_progress(tmp_path / "reordered") == normalized_progress(tmp_path / "ref")
    again = reorder_store(entry, tmp_path / "reordered", order=order, threads=4, **QUIET)
    assert all(s["skipped"] for s in again["stages"].values())


# ---------------------------------------------------------------------------
# Bounded memory
# ---------------------------------------------------------------------------


def _traced_peak(fn) -> int:
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_the_generate_stage_holds_no_edge_list(tmp_path):
    """Scale 17, m = 2^21 edges (16 a vertex), chunks of 2^18 edges (eight,
    above the merge's block of 65,536 rows): the port's generate stage
    peaks within 1.1× the reference's, and both under half of what
    rmat_edges + Graph.from_edges peak at for the same graph."""
    kw = dict(scale=17, avg_degree=16, seed=0, chunk_edges=1 << 18, dedupe=False,
              order="none")
    port = _traced_peak(lambda: run_pipeline(tmp_path / "port", BuildConfig(**kw),
                                             stages=["generate"], **QUIET))
    ref = _traced_peak(lambda: ref_pipeline.run_pipeline(
        tmp_path / "ref", ref_pipeline.BuildConfig(**kw), stages=["generate"], **QUIET))

    def in_ram():
        src, dst = rmat_edges(17, 1 << 21, seed=0)
        return Graph.from_edges(1 << 17, src, dst)

    whole = _traced_peak(in_ram)
    assert port <= 1.1 * ref, (port, ref)
    assert max(port, ref) < whole / 2, (port, ref, whole)
    assert crcs(raw_store_path(tmp_path / "port")) == crcs(raw_store_path(tmp_path / "ref"))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_builds_an_rmat_graph(tmp_path, capsys):
    out = str(tmp_path / "b")
    rep = pagerank_run.run(["build", "--scale", "9", "--out", out])
    text = capsys.readouterr().out
    g = rmat_graph(9)
    assert (rep["n"], rep["m"]) == (g.n, g.m) and rep["out"] == out
    assert rep["store"] == reordered_store_path(out)  # --order bfs by default
    assert rep["nbytes"] == GraphStore(rep["store"]).nbytes()
    assert list(rep["stages"]) == list(pipeline.STAGES)
    assert all(not s["skipped"] and s["wall_s"] >= 0 for s in rep["stages"].values())
    assert f"store: {rep['store']}  n={g.n} m={g.m} order=bfs bytes=" in text
    assert "layout: threads=56 partitions=56 partition_edges max=" in text
    assert pagerank_run.main(["build", "--scale", "9", "--out", out]) == 0


def test_launcher_builds_the_references_dataset_directory(tmp_path, capsys):
    argv = ["build", "--dataset", "webStanford", "--scale-down", "512", "--order", "bfs"]
    rep = pagerank_run.run(argv + ["--out", str(tmp_path / "port")])
    assert ref_pagerank_run.main(argv + ["--out", str(tmp_path / "ref")]) == 0
    assert_same_build(tmp_path / "port", tmp_path / "ref")
    assert normalized_progress(tmp_path / "port") == normalized_progress(tmp_path / "ref")
    g = make_dataset("webStanford", scale_down=512)
    assert (rep["n"], rep["m"]) == (g.n, g.m)
    assert_graphs_equal(GraphStore(raw_store_path(tmp_path / "port")).graph(), g)


def test_launcher_build_resumes_a_stage_subset(tmp_path, capsys):
    out = str(tmp_path / "b")
    argv = ["build", "--dataset", "socEpinions1", "--scale-down", "64", "--out", out,
            "--chunk-edges", "1000", "--threads", "4"]
    first = pagerank_run.run(argv + ["--stages", "generate"])
    assert list(first["stages"]) == ["generate"] and first["store"] == raw_store_path(out)
    assert "layout:" not in capsys.readouterr().out  # no layout yet
    rest = pagerank_run.run(argv)
    assert rest["stages"]["generate"]["skipped"]
    assert [s["skipped"] for s in rest["stages"].values()] == [True, False, False]
    assert rest["store"] == reordered_store_path(out)
    fresh = run_pipeline(tmp_path / "fresh", surrogate_cfg(
        pipeline, *SURROGATE, order="bfs", chunk_edges=1000, threads=4), **QUIET)
    assert crcs(rest["store"]) == crcs(fresh["store"])
    assert GraphStore(rest["store"]).layout()["threads"] == 4


@pytest.fixture(scope="module")
def ws_build(tmp_path_factory):
    out = tmp_path_factory.mktemp("builds") / "ws"
    pagerank_run.run(["build", "--dataset", "webStanford", "--scale-down", "256",
                      "--order", "bfs", "--out", str(out)])
    return str(out)


def test_launcher_store_on_a_build_directory_reports_original_ids(ws_build, tmp_path, capsys):
    argv = ["--variant", "blocked_nosync", "--handle-dangling", "--device", "cpu",
            "--threshold", "1e-8"]
    rep = pagerank_run.run(["--store", ws_build, "--ckpt", str(tmp_path / "pr")] + argv)
    text = capsys.readouterr().out
    assert f"store {reordered_store_path(ws_build)}: " in text and "order=bfs (memmap)" in text
    resident = pagerank_run.run(["--dataset", "webStanford", "--scale-down", "256"] + argv)
    assert np.abs(rep["pr"].astype(np.float64) - resident["pr"]).sum() < 1e-6
    assert rep["top5"] == resident["top5"] and rep["l1"] < 1e-5
    ck = SolverCheckpoint.load(str(tmp_path / "pr"))
    assert (ck.n, ck.p, ck.round) == (rep["n"], 1, rep["iterations"])
    assert np.array_equal(ck.pr, rep["pr"])
    # the raw store of the same directory: original order, the same ranks
    raw = pagerank_run.run(["--store", raw_store_path(ws_build)] + argv)
    assert np.abs(raw["pr"].astype(np.float64) - resident["pr"]).sum() < 1e-6


@pytest.mark.parametrize("argv", [["build", "--scale", "9"],
                                  ["build", "--out", "x", "--scale", "9", "--dataset", "D10"],
                                  ["build", "--out", "x", "--order", "hilbert", "--scale", "9"]])
def test_launcher_build_refuses_bad_arguments(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        pagerank_run.main(argv)
    assert exc.value.code == 2 and not os.path.exists(tmp_path / "x")


def test_launcher_store_names_a_path_that_is_no_store(tmp_path):
    (tmp_path / "b" / "raw").mkdir(parents=True)
    (tmp_path / "b" / "PIPELINE.json").write_text("{}")
    for path in (tmp_path / "b", tmp_path / "nowhere"):
        with pytest.raises(StoreError, match=re.escape(f"{path} is neither a graph store")):
            pagerank_run.main(["--store", str(path), "--device", "cpu"])
    shutil.rmtree(tmp_path / "b")
    assert final_store_path(tmp_path / "b") == raw_store_path(tmp_path / "b")

