"""On-disk graph store: a versioned directory format for massive graphs.

A copy of the reference's store format, numpy only: a store directory
holds the dst-sorted CSR arrays of one :class:`repro_torch.graphs.csr.Graph`
as raw little-endian binary files plus a ``META.json`` manifest, and loads
back as an ``np.memmap``-backed ``Graph``, so only the ranges a build
touches are paged in.  The file names, dtypes, manifest keys and CRC-32s
are the reference's: a store written by either package loads in the other.

Directory layout::

    <store>/
      META.json        # manifest: format, version, n, m, per-array shard
                       # records (file, dtype, shape, crc32), order, extra
      src.bin dst.bin  # (m,) int32 edge arrays, sorted by (dst, src)
      out_degree.bin   # (n,) int32 — may differ from bincount(src): a
                       # decomposition core carries FULL-graph degrees
      in_ptr.bin       # (n+1,) int64 CSR indptr over dst
      weights.bin      # (m,) float64, optional
      bias.bin         # (n,) float64, optional
      perm.bin         # (n,) int64, optional — perm[original] = stored id
      LAYOUT.json      # optional: the build pipeline's partition bounds

``META.json`` is written last and atomically (tmp + ``os.replace``), so its
presence marks a complete store: an interrupted write leaves no manifest.
Every array file carries a CRC-32 in the manifest; ``verify=True`` on load
(or :meth:`GraphStore.verify`) streams each file and rejects corruption.

``perm`` records the vertex reordering under which the store was written
(``perm[original_id] = stored_id``): ranks solved on the stored graph map
back to original ids as ``pr_original = pr_stored[perm]``
(:func:`repro_torch.graphs.reorder.unpermute_ranks`).

The module also holds the external-sort spill machinery that the build
pipeline's streaming stages (:mod:`repro_torch.graphs.pipeline`) share:
bounded edge chunks sorted by ``(dst, src)`` on disk
(:func:`write_spill_chunk`, the reference's structured dtype, so the
files are its bytes) and a k-way merge (:func:`merge_spill_chunks`) that
holds at most one ``block`` of rows per live chunk, never the whole edge
list.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import BinaryIO, Optional, Sequence, Union

import numpy as np

from repro_torch.graphs.csr import Graph

STORE_FORMAT = "repro-graph-store"
STORE_VERSION = 1
META_FILE = "META.json"
LAYOUT_FILE = "LAYOUT.json"

# Canonical dtypes of the format (little-endian, fixed for portability).
_DTYPES = {
    "src": "<i4",
    "dst": "<i4",
    "out_degree": "<i4",
    "in_ptr": "<i8",
    "weights": "<f8",
    "bias": "<f8",
    "perm": "<i8",
}

PathLike = Union[str, os.PathLike]


class StoreError(RuntimeError):
    """Malformed, incomplete, or version-incompatible store directory."""


class StoreChecksumError(StoreError):
    """An array file's bytes do not match the manifest CRC-32."""


def _atomic_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _file_crc32(path: str, blocksize: int = 1 << 22) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(blocksize)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


class _ArrayFile:
    """One append-only array shard: raw bytes + running CRC + length."""

    def __init__(self, dir_path: str, name: str):
        self.name = name
        self.file = f"{name}.bin"
        self.dtype = _DTYPES[name]
        self.path = os.path.join(dir_path, self.file)
        self.fh: Optional[BinaryIO] = open(self.path, "wb")
        self.crc = 0
        self.count = 0

    def append(self, arr: np.ndarray) -> None:
        buf = np.ascontiguousarray(arr, dtype=self.dtype).tobytes()
        self.fh.write(buf)
        self.crc = zlib.crc32(buf, self.crc)
        self.count += int(arr.shape[0])

    def close(self) -> dict:
        self.fh.close()
        self.fh = None
        return {"file": self.file, "dtype": self.dtype,
                "shape": [self.count], "crc32": self.crc}


class StoreWriter:
    """Streaming store writer: append dst-sorted edge blocks, then finalize.

    Blocks must arrive in global (dst, src) order, as
    :meth:`repro_torch.graphs.csr.Graph.edge_chunks` and
    :func:`merge_spill_chunks` give them.  The
    writer counts per-vertex dst/src occurrences as it goes (O(n) RAM), so
    ``finalize`` can derive ``in_ptr``/``out_degree`` without a second
    pass; callers with authoritative arrays (a decomposition core's
    full-graph degrees) pass them to ``finalize``.
    """

    def __init__(self, path: PathLike, n: int, weighted: bool = False):
        self.path = str(path)
        self.n = int(n)
        os.makedirs(self.path, exist_ok=True)
        self._src = _ArrayFile(self.path, "src")
        self._dst = _ArrayFile(self.path, "dst")
        self._w = _ArrayFile(self.path, "weights") if weighted else None
        self._dst_counts = np.zeros(self.n, dtype=np.int64)
        self._src_counts = np.zeros(self.n, dtype=np.int64)
        self._last_key = None  # (dst, src) of the last appended edge
        self._finalized = False

    @property
    def m(self) -> int:
        return self._src.count

    def append(self, src: np.ndarray, dst: np.ndarray,
               weights: Optional[np.ndarray] = None) -> None:
        if src.shape != dst.shape:
            raise ValueError("src/dst blocks must be parallel")
        if (self._w is None) != (weights is None):
            raise ValueError("weighted store requires weights on every block")
        if src.size == 0:
            return
        key = dst.astype(np.int64) * self.n + src
        if np.any(key[1:] < key[:-1]) or (
                self._last_key is not None and key[0] < self._last_key):
            raise ValueError("edge blocks must arrive in (dst, src) order")
        self._last_key = int(key[-1])
        self._src.append(src)
        self._dst.append(dst)
        if self._w is not None:
            self._w.append(weights)
        self._dst_counts += np.bincount(dst, minlength=self.n)
        self._src_counts += np.bincount(src, minlength=self.n)

    def finalize(
        self,
        out_degree: Optional[np.ndarray] = None,
        in_ptr: Optional[np.ndarray] = None,
        bias: Optional[np.ndarray] = None,
        perm: Optional[np.ndarray] = None,
        order: str = "none",
        extra: Optional[dict] = None,
    ) -> "GraphStore":
        """Write the per-vertex arrays + manifest; returns the opened store.

        ``META.json`` lands last and atomically: an interrupt anywhere
        before that leaves a directory :func:`is_store` rejects."""
        if self._finalized:
            raise StoreError("finalize called twice")
        self._finalized = True
        arrays = {"src": self._src.close(), "dst": self._dst.close()}
        if self._w is not None:
            arrays["weights"] = self._w.close()

        if out_degree is None:
            out_degree = self._src_counts
        if in_ptr is None:
            in_ptr = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(self._dst_counts, out=in_ptr[1:])
        per_vertex = {"out_degree": out_degree, "in_ptr": in_ptr}
        if bias is not None:
            per_vertex["bias"] = bias
        if perm is not None:
            per_vertex["perm"] = perm
        for name, arr in per_vertex.items():
            af = _ArrayFile(self.path, name)
            af.append(np.asarray(arr))
            arrays[name] = af.close()

        meta = {
            "format": STORE_FORMAT,
            "version": STORE_VERSION,
            "n": self.n,
            "m": self.m,
            "weighted": self._w is not None,
            "biased": bias is not None,
            "order": order,
            "arrays": arrays,
            "extra": extra or {},
        }
        _atomic_json(os.path.join(self.path, META_FILE), meta)
        return GraphStore(self.path)


def save_graph(path: PathLike, g: Graph, *,
               perm: Optional[np.ndarray] = None, order: str = "none",
               chunk_edges: int = 1 << 20,
               extra: Optional[dict] = None) -> "GraphStore":
    """Write ``g`` (resident or memmap-backed) to a store directory.

    Streams through :meth:`repro_torch.graphs.csr.Graph.edge_chunks`, so
    saving a memmap-loaded graph elsewhere never materializes its edge
    list.  The graph's own ``out_degree``/``in_ptr`` are written verbatim
    (a decomposition core's degrees differ from its edge counts on
    purpose)."""
    w = StoreWriter(path, g.n, weighted=g.weights is not None)
    for _, src, dst, weights in g.edge_chunks(chunk_edges):
        w.append(src, dst, weights)
    return w.finalize(out_degree=np.asarray(g.out_degree),
                      in_ptr=np.asarray(g.in_ptr),
                      bias=None if g.bias is None else np.asarray(g.bias),
                      perm=perm, order=order, extra=extra)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def is_store(path: PathLike) -> bool:
    """True when ``path`` is a complete store (its manifest is present)."""
    return os.path.isfile(os.path.join(str(path), META_FILE))


class GraphStore:
    """Handle on one store directory: manifest + lazy array access."""

    def __init__(self, path: PathLike):
        self.path = str(path)
        meta_path = os.path.join(self.path, META_FILE)
        if not os.path.isfile(meta_path):
            raise StoreError(f"{self.path}: no {META_FILE} — not a "
                             "(complete) graph store")
        with open(meta_path, encoding="utf-8") as f:
            self.meta = json.load(f)
        if self.meta.get("format") != STORE_FORMAT:
            raise StoreError(f"{self.path}: format "
                             f"{self.meta.get('format')!r} != {STORE_FORMAT!r}")
        if int(self.meta.get("version", -1)) > STORE_VERSION:
            raise StoreError(
                f"{self.path}: store version {self.meta['version']} is newer "
                f"than supported {STORE_VERSION}")

    @property
    def n(self) -> int:
        return int(self.meta["n"])

    @property
    def m(self) -> int:
        return int(self.meta["m"])

    @property
    def order(self) -> str:
        return self.meta.get("order", "none")

    def _array(self, name: str, mmap: bool = True) -> np.ndarray:
        rec = self.meta["arrays"][name]
        path = os.path.join(self.path, rec["file"])
        shape = tuple(rec["shape"])
        if int(np.prod(shape)) == 0:
            return np.zeros(shape, dtype=rec["dtype"])
        if mmap:
            return np.memmap(path, dtype=rec["dtype"], mode="r", shape=shape)
        return np.fromfile(path, dtype=rec["dtype"]).reshape(shape)

    def verify(self) -> None:
        """Stream every array file and compare against the manifest CRCs."""
        for name, rec in self.meta["arrays"].items():
            path = os.path.join(self.path, rec["file"])
            if not os.path.isfile(path):
                raise StoreChecksumError(f"{self.path}: missing shard "
                                         f"{rec['file']} ({name})")
            crc = _file_crc32(path)
            if crc != rec["crc32"]:
                raise StoreChecksumError(
                    f"{self.path}: {rec['file']} crc32 {crc:#x} != manifest "
                    f"{rec['crc32']:#x} ({name})")

    def graph(self, mmap: bool = True, verify: bool = False) -> Graph:
        """Load the stored graph; ``mmap=True`` (default) returns read-only
        ``np.memmap`` views, so nothing is paged in until touched."""
        if verify:
            self.verify()
        return Graph.from_arrays(
            n=self.n,
            src=self._array("src", mmap),
            dst=self._array("dst", mmap),
            out_degree=self._array("out_degree", mmap),
            in_ptr=self._array("in_ptr", mmap),
            weights=(self._array("weights", mmap)
                     if self.meta["weighted"] else None),
            bias=self._array("bias", mmap) if self.meta["biased"] else None,
        )

    def perm(self) -> Optional[np.ndarray]:
        """``perm[original_id] = stored_id`` when the store was reordered
        (``None`` otherwise); see
        :func:`repro_torch.graphs.reorder.unpermute_ranks`."""
        if "perm" not in self.meta["arrays"]:
            return None
        return np.asarray(self._array("perm", mmap=False))

    def layout(self) -> Optional[dict]:
        """The partition bounds written by the build pipeline's layout stage
        (``None`` when that stage has not run)."""
        path = os.path.join(self.path, LAYOUT_FILE)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def write_layout(self, layout: dict) -> None:
        _atomic_json(os.path.join(self.path, LAYOUT_FILE), layout)

    def nbytes(self) -> int:
        """Total bytes of the array shards on disk."""
        return sum(
            os.path.getsize(os.path.join(self.path, rec["file"]))
            for rec in self.meta["arrays"].values())


def load_graph(path: PathLike, mmap: bool = True,
               verify: bool = False) -> Graph:
    """One-call load: store directory → (memmap-backed) :class:`Graph`."""
    return GraphStore(path).graph(mmap=mmap, verify=verify)


# ---------------------------------------------------------------------------
# External-sort spill chunks + k-way merge (shared by the pipeline stages)
# ---------------------------------------------------------------------------


def _spill_dtype(weighted: bool) -> np.dtype:
    fields = [("dst", "<i4"), ("src", "<i4")]
    if weighted:
        fields.append(("w", "<f8"))
    return np.dtype(fields)


def write_spill_chunk(path: PathLike, src: np.ndarray, dst: np.ndarray,
                      weights: Optional[np.ndarray] = None,
                      dedupe: bool = False) -> dict:
    """Sort one edge chunk by ``(dst, src)`` and write it as a structured
    ``.npy`` spill file (atomically).  Returns ``{"rows", "crc32"}``, the
    pipeline's per-chunk resume record.

    ``dedupe`` drops duplicate ``(src, dst)`` pairs within the chunk (the
    merge drops those across chunks); weighted chunks refuse it, as their
    parallel edges are distinct contributions."""
    if dedupe and weights is not None:
        raise ValueError("dedupe of weighted edges is ambiguous")
    # the stable order of np.lexsort((src, dst)) for any int32 pair, from
    # one int64 key: half lexsort's time on chunks of 2**21 edges
    key = dst.astype(np.int64) * (1 << 32) + (src.astype(np.int64) + (1 << 31))
    order = np.argsort(key, kind="stable")
    rec = np.empty(src.shape[0], dtype=_spill_dtype(weights is not None))
    rec["src"] = src[order]
    rec["dst"] = dst[order]
    if weights is not None:
        rec["w"] = weights[order]
    if dedupe and rec.shape[0]:
        keep = np.r_[True, (rec["dst"][1:] != rec["dst"][:-1])
                     | (rec["src"][1:] != rec["src"][:-1])]
        rec = rec[keep]
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # np.save on a handle: no ".npy" suffixing
        np.save(f, rec)
    os.replace(tmp, path)
    return {"rows": int(rec.shape[0]), "crc32": _file_crc32(path)}


class _SpillStream:
    """Block-buffered reader over one sorted spill chunk (memmap-backed)."""

    def __init__(self, path: str, n: int, block: int):
        self.arr = np.load(path, mmap_mode="r")
        self.n = n
        self.block = block
        self.pos = 0
        self.buf: Optional[np.ndarray] = None  # the resident block
        self.keys: Optional[np.ndarray] = None

    def refill(self) -> bool:
        """Ensure a non-empty buffer; False when the chunk is exhausted."""
        if self.buf is not None and self.buf.shape[0]:
            return True
        if self.pos >= self.arr.shape[0]:
            return False
        end = min(self.pos + self.block, self.arr.shape[0])
        self.buf = np.asarray(self.arr[self.pos:end])
        self.keys = self.buf["dst"].astype(np.int64) * self.n + self.buf["src"]
        self.pos = end
        return True

    def take_upto(self, bound: int) -> np.ndarray:
        cut = int(np.searchsorted(self.keys, bound, side="right"))
        out, self.buf = self.buf[:cut], self.buf[cut:]
        self.keys = self.keys[cut:]
        return out


def merge_spill_chunks(
    chunk_files: Sequence[PathLike],
    n: int,
    writer: StoreWriter,
    dedupe: bool = False,
    block: int = 1 << 16,
) -> None:
    """K-way merge of sorted spill chunks into ``writer``, vectorized.

    Each round holds at most one ``block`` per live chunk, takes every
    buffered edge whose key is at most the smallest buffer maximum (nothing
    still on disk sorts before those), sorts the pool, optionally dedupes
    it, and appends it: peak memory O(len(chunk_files) × block), whatever
    the edge count.  ``dedupe`` drops a ``(src, dst)`` key seen before,
    across chunk boundaries too (the last key emitted carries over)."""
    streams = [_SpillStream(str(f), n, block) for f in chunk_files]
    last_key = None
    while True:
        streams = [s for s in streams if s.refill()]
        if not streams:
            return
        bound = min(int(s.keys[-1]) for s in streams)
        parts = [s.take_upto(bound) for s in streams]
        pool = np.concatenate([p for p in parts if p.shape[0]])
        keys = pool["dst"].astype(np.int64) * n + pool["src"]
        order = np.argsort(keys, kind="stable")
        pool, keys = pool[order], keys[order]
        if dedupe and keys.shape[0]:
            keep = np.r_[True, keys[1:] != keys[:-1]]
            if last_key is not None:
                keep &= keys != last_key
            pool, keys = pool[keep], keys[keep]
        if keys.shape[0]:
            last_key = int(keys[-1])
            writer.append(pool["src"], pool["dst"],
                          pool["w"] if "w" in pool.dtype.names else None)


@dataclasses.dataclass
class SpillSet:
    """One stage's spill directory: deterministic chunk file names and the
    per-chunk resume check (the file exists and its CRC is the record's)."""

    dir: str

    def __post_init__(self):
        os.makedirs(self.dir, exist_ok=True)

    def chunk_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"chunk_{idx:06d}.npy")

    def valid(self, idx: int, record: Optional[dict]) -> bool:
        """True when chunk ``idx`` is on disk and matches its resume record,
        so the pipeline need not write it again."""
        path = self.chunk_path(idx)
        if record is None or not os.path.isfile(path):
            return False
        return _file_crc32(path) == record["crc32"]

    def cleanup(self) -> None:
        if os.path.isdir(self.dir):
            for f in os.listdir(self.dir):
                os.unlink(os.path.join(self.dir, f))
            os.rmdir(self.dir)
