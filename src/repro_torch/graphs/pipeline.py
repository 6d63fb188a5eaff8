"""Resumable out-of-core build pipeline: generate → reorder → layout.

A copy of the reference's staged path from nothing to a solve-ready graph
store (:mod:`repro_torch.graphs.store`), host numpy, bounded in memory and
interruptible at every step:

1. **generate** — streaming R-MAT: each bounded edge chunk is drawn from
   its slice of the random stream (:func:`repro_torch.graphs.rmat.rmat_chunk`),
   sorted, deduped within itself and spilled to disk; a k-way merge then
   writes the dst-sorted ``raw/`` store.  The edge list is never resident
   whole: peak RAM is O(chunk_edges + n).
2. **reorder** — a locality order (:mod:`repro_torch.graphs.reorder`, BFS
   by default) computed on the memmap-backed raw store, which is rewritten
   under it (chunked spills and the same merge) into ``reordered/`` with
   ``perm`` recorded, so ranks map back to original ids.
3. **layout** — the partition bounds of ``threads`` edge-balanced
   partitions (``Graph.partition_ranges``) and their in-edge counts,
   written as ``LAYOUT.json`` in the final store.

The layout stage writes no ``tile_stats``: those describe the reference's
one-hot ``(dst_block, src_block)`` tiles, which the port does not build
(its kernels read the in-CSR), and computing them keeps one int64 key per
distinct bucket, nearly one per edge on an unordered R-MAT graph, so the
stage that should be the cheapest would hold more than the in-RAM build.
``BuildConfig.block`` and ``tile_cap`` stay fields of the record, so a
``PIPELINE.json`` means the same in both packages; nothing in the port
reads them.

Progress lives in ``PIPELINE.json`` (rewritten atomically after every
chunk and stage): a killed build resumes where it stopped.  Completed
stages are skipped by their store manifests, and a stage cut short reuses
every spill chunk whose CRC-32 is its record's.  Chunks are deterministic
per ``(seed, chunk index)``, so a resumed build is bit for bit an
uninterrupted one.  The file, the stores and the spill chunks are the
reference's bytes, so a build started by either package is finished by
the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.graphs.reorder import ORDERS, compute_order, invert_perm
from repro_torch.graphs.rmat import rmat_chunk, rmat_vertex_perm
from repro_torch.graphs.store import (
    GraphStore,
    SpillSet,
    StoreWriter,
    is_store,
    merge_spill_chunks,
    write_spill_chunk,
)

STAGES = ("generate", "reorder", "layout")
PIPELINE_FILE = "PIPELINE.json"
PIPELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Parameters of one pipeline run, recorded in ``PIPELINE.json`` so a
    resume with other parameters is refused rather than mixing stores.

    ``fold_n`` folds generated vertex ids modulo a target that need not be
    a power of two (the dataset surrogates of
    :mod:`repro_torch.graphs.datasets`); the graph then has ``fold_n``
    vertices.  ``n_edges`` defaults to ``avg_degree · 2**scale``.
    ``block`` and ``tile_cap`` are the reference's tile parameters, kept
    so the record is the same in both packages; the port reads neither.
    """

    scale: int
    avg_degree: int = 8
    n_edges: Optional[int] = None
    a: float = 0.57
    b: float = 0.19
    c: float = 0.19
    seed: int = 0
    fold_n: Optional[int] = None
    dedupe: bool = True
    chunk_edges: int = 1 << 21
    order: str = "bfs"
    threads: int = 56
    block: int = 256
    tile_cap: int = 1024

    def __post_init__(self):
        if self.order not in ORDERS:
            raise ValueError(f"order {self.order!r} not in {ORDERS}")

    @property
    def n(self) -> int:
        return self.fold_n if self.fold_n is not None else 1 << self.scale

    @property
    def total_edges(self) -> int:
        return (self.n_edges if self.n_edges is not None
                else self.avg_degree * (1 << self.scale))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BuildConfig":
        return cls(**d)


# ---------------------------------------------------------------------------
# Progress file
# ---------------------------------------------------------------------------


def _progress_path(out_dir: str) -> str:
    return os.path.join(out_dir, PIPELINE_FILE)


def load_progress(out_dir: str) -> Optional[dict]:
    path = _progress_path(str(out_dir))
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _save_progress(out_dir: str, progress: dict) -> None:
    path = _progress_path(out_dir)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(progress, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def raw_store_path(out_dir: str) -> str:
    return os.path.join(str(out_dir), "raw")


def reordered_store_path(out_dir: str) -> str:
    return os.path.join(str(out_dir), "reordered")


def final_store_path(out_dir: str) -> str:
    """The store a solve should load: ``reordered/`` when that stage made
    one, ``raw/`` otherwise."""
    out_dir = str(out_dir)
    if is_store(reordered_store_path(out_dir)):
        return reordered_store_path(out_dir)
    return raw_store_path(out_dir)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _generate_stage(out_dir: str, cfg: BuildConfig, progress: dict,
                    log: Callable[[str], None]) -> dict:
    raw_dir = raw_store_path(out_dir)
    state = progress["stages"].setdefault("generate", {"chunks": {}})
    spill = SpillSet(os.path.join(out_dir, "chunks"))
    total = cfg.total_edges
    n_chunks = -(-total // cfg.chunk_edges) if total else 0
    perm = rmat_vertex_perm(cfg.scale, total, cfg.seed)
    reused = 0
    for ci in range(n_chunks):
        if spill.valid(ci, state["chunks"].get(str(ci))):
            reused += 1
            continue
        lo = ci * cfg.chunk_edges
        hi = min(lo + cfg.chunk_edges, total)
        src, dst = rmat_chunk(cfg.scale, total, lo, hi, a=cfg.a, b=cfg.b,
                              c=cfg.c, seed=cfg.seed, perm=perm)
        if cfg.fold_n is not None:
            src = (src % cfg.fold_n).astype(np.int32)
            dst = (dst % cfg.fold_n).astype(np.int32)
        state["chunks"][str(ci)] = write_spill_chunk(
            spill.chunk_path(ci), src, dst, dedupe=cfg.dedupe)
        _save_progress(out_dir, progress)  # the chunk-granular resume point
    if reused:
        log(f"generate: resumed, reusing {reused}/{n_chunks} spill chunks")

    writer = StoreWriter(raw_dir, cfg.n, weighted=False)
    merge_spill_chunks([spill.chunk_path(ci) for ci in range(n_chunks)],
                       cfg.n, writer, dedupe=cfg.dedupe)
    store = writer.finalize(order="none",
                            extra={"config": cfg.to_dict(), "stage": "generate"})
    spill.cleanup()
    return {"store": raw_dir, "n": store.n, "m": store.m}


def _reorder_stage(out_dir: str, cfg: BuildConfig, progress: dict,
                   log: Callable[[str], None]) -> dict:
    raw = GraphStore(raw_store_path(out_dir))
    g = raw.graph(mmap=True)
    perm = compute_order(g, cfg.order, seed=cfg.seed)
    inv = invert_perm(perm)

    state = progress["stages"].setdefault("reorder", {"chunks": {}})
    spill = SpillSet(os.path.join(out_dir, "reorder_chunks"))
    n_chunks = 0
    reused = 0
    for lo, src, dst, w in g.edge_chunks(cfg.chunk_edges):
        ci = lo // cfg.chunk_edges
        n_chunks = ci + 1
        if spill.valid(ci, state["chunks"].get(str(ci))):
            reused += 1
            continue
        state["chunks"][str(ci)] = write_spill_chunk(
            spill.chunk_path(ci),
            np.asarray(perm[src], dtype=np.int32),
            np.asarray(perm[dst], dtype=np.int32),
            weights=w,
        )
        _save_progress(out_dir, progress)
    if reused:
        log(f"reorder: resumed, reusing {reused}/{n_chunks} spill chunks")

    prev = raw.perm()
    total_perm = perm if prev is None else perm[prev]
    writer = StoreWriter(reordered_store_path(out_dir), g.n,
                         weighted=g.weights is not None)
    merge_spill_chunks([spill.chunk_path(ci) for ci in range(n_chunks)],
                       g.n, writer, dedupe=False)
    store = writer.finalize(
        out_degree=np.asarray(g.out_degree)[inv],
        bias=None if g.bias is None else np.asarray(g.bias)[inv],
        perm=total_perm,
        order=cfg.order,
        extra={"config": cfg.to_dict(), "stage": "reorder"},
    )
    spill.cleanup()
    return {"store": store.path, "order": cfg.order, "n": store.n,
            "m": store.m}


def _layout_stage(out_dir: str, cfg: BuildConfig, progress: dict,
                  log: Callable[[str], None]) -> dict:
    store = GraphStore(final_store_path(out_dir))
    g = store.graph(mmap=True)
    bounds = g.partition_ranges(cfg.threads)
    edges = np.diff(np.asarray(g.in_ptr)[bounds])
    store.write_layout({
        "threads": cfg.threads,
        "partition_bounds": bounds.tolist(),
        "partition_edges": edges.tolist(),
    })
    return {"store": store.path, "max_partition_edges": int(edges.max()),
            "mean_partition_edges": float(edges.mean())}


_STAGE_FNS = {
    "generate": _generate_stage,
    "reorder": _reorder_stage,
    "layout": _layout_stage,
}


def _stage_complete(out_dir: str, name: str, progress: dict) -> bool:
    done = progress["stages"].get(name, {}).get("done", False)
    if name == "generate":
        return done and is_store(raw_store_path(out_dir))
    if name == "reorder":
        return done and is_store(reordered_store_path(out_dir))
    return done and GraphStore(final_store_path(out_dir)).layout() is not None


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def run_pipeline(
    out_dir: str,
    cfg: Optional[BuildConfig] = None,
    stages: Optional[Sequence[str]] = None,
    log: Callable[[str], None] = print,
) -> dict:
    """Run (or resume) the staged build under ``out_dir``.

    ``stages`` selects a subset, run in the canonical order; a stage whose
    input stage has not completed raises.  Completed stages are skipped,
    so calling again after an interrupt, or with a later subset, resumes.
    ``cfg=None`` resumes with the recorded config; a config other than the
    recorded one raises (delete the directory to rebuild).

    Returns ``{"out", "store", "stages": {name: {..., "wall_s"}}}``; a
    skipped stage's entry is its record with ``skipped=True``.
    """
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    progress = load_progress(out_dir)
    if progress is None:
        if cfg is None:
            raise ValueError(f"{out_dir}: no pipeline to resume and no "
                             "config given")
        progress = {"version": PIPELINE_VERSION, "config": cfg.to_dict(),
                    "stages": {}}
        _save_progress(out_dir, progress)
    else:
        recorded = BuildConfig.from_dict(progress["config"])
        if cfg is None:
            cfg = recorded
        elif cfg != recorded:
            raise ValueError(
                f"{out_dir}: pipeline was started with a different config; "
                "resume without overriding it or rebuild in a fresh directory")

    selected = list(stages) if stages is not None else list(STAGES)
    unknown = set(selected) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stage(s) {sorted(unknown)}; "
                         f"expected from {STAGES}")
    selected = [s for s in STAGES if s in selected]
    if cfg.order == "none" and "reorder" in selected:
        selected.remove("reorder")  # the identity order: raw is final

    results: dict = {}
    for name in selected:
        for dep in STAGES[:STAGES.index(name)]:
            if dep == "reorder" and cfg.order == "none":
                continue
            if not _stage_complete(out_dir, dep, progress):
                raise ValueError(f"stage {name!r} needs {dep!r} first "
                                 f"(run it or pass stages={list(STAGES)})")
        if _stage_complete(out_dir, name, progress):
            log(f"{name}: already complete, skipping")
            results[name] = dict(progress["stages"][name], skipped=True)
            continue
        t0 = time.perf_counter()
        info = _STAGE_FNS[name](out_dir, cfg, progress, log)
        info["wall_s"] = round(time.perf_counter() - t0, 3)
        info["done"] = True
        state = progress["stages"].setdefault(name, {})
        state.update(info)
        state.pop("chunks", None)  # spill records are dead once merged
        _save_progress(out_dir, progress)
        log(f"{name}: done in {info['wall_s']:.2f}s "
            + " ".join(f"{k}={v}" for k, v in info.items()
                       if k not in ("wall_s", "done", "chunks")))
        results[name] = info
    return {"out": out_dir, "store": final_store_path(out_dir),
            "stages": results}


def reorder_store(src_store: str, out_dir: str, order: str = "bfs",
                  seed: int = 0, chunk_edges: int = 1 << 21,
                  threads: int = 56, block: int = 256, tile_cap: int = 1024,
                  log: Callable[[str], None] = print) -> dict:
    """Reorder and lay out an existing store (a dataset-cache entry, say)
    in a fresh pipeline directory with no generate stage: the store is
    copied in as the raw stage and the resume machinery runs the rest."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    src = GraphStore(src_store)
    raw_dir = raw_store_path(out_dir)
    if not is_store(raw_dir):
        shutil.copytree(src.path, raw_dir, dirs_exist_ok=True)
    g = src.graph(mmap=True)
    cfg = BuildConfig(
        scale=max(1, int(np.ceil(np.log2(max(g.n, 2))))),
        n_edges=g.m, fold_n=g.n, dedupe=False, order=order, seed=seed,
        chunk_edges=chunk_edges, threads=threads, block=block,
        tile_cap=tile_cap,
    )
    if load_progress(out_dir) is None:
        _save_progress(out_dir, {
            "version": PIPELINE_VERSION, "config": cfg.to_dict(),
            "stages": {"generate": {"done": True, "store": raw_dir,
                                    "adopted": src.path}}})
    return run_pipeline(out_dir, stages=["reorder", "layout"], log=log)
