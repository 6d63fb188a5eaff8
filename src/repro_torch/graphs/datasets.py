"""Dataset registry mirroring the paper's Table 1 (R-MAT surrogates).

A copy of the reference registry: each real-world dataset is an R-MAT
surrogate with the same vertex/edge counts, scaled by ``scale_down``, and
the same ``(name, scale_down, seed)`` gives the bit-identical graph in both
packages.  With ``cache_dir`` (or the ``REPRO_DATASET_CACHE`` variable) a
built graph is kept as a graph store (:mod:`repro_torch.graphs.store`) in
the directory both packages name alike (:func:`dataset_cache_path`), and a
later call loads it memmap-backed after checking its CRC-32s.
"""
from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Optional

import numpy as np

from repro_torch.graphs.csr import Graph
from repro_torch.graphs.rmat import rmat_edges

CACHE_ENV = "REPRO_DATASET_CACHE"


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_vertices: int
    n_edges: int
    family: str  # web | social | road | synthetic | skewed


DATASETS = {
    # Web graphs
    "webStanford": DatasetSpec("webStanford", 281_903, 2_312_497, "web"),
    "webNotreDame": DatasetSpec("webNotreDame", 325_729, 1_497_134, "web"),
    "webBerkStan": DatasetSpec("webBerkStan", 685_230, 7_600_595, "web"),
    "webGoogle": DatasetSpec("webGoogle", 875_713, 5_105_039, "web"),
    # Social networks
    "socEpinions1": DatasetSpec("socEpinions1", 75_879, 508_837, "social"),
    "Slashdot0811": DatasetSpec("Slashdot0811", 77_360, 905_468, "social"),
    "Slashdot0902": DatasetSpec("Slashdot0902", 82_168, 948_464, "social"),
    "socLiveJournal1": DatasetSpec("socLiveJournal1", 4_847_571, 68_993_773, "social"),
    # Road networks
    "roaditalyosm": DatasetSpec("roaditalyosm", 6_686_493, 7_013_978, "road"),
    "greatbritainosm": DatasetSpec("greatbritainosm", 7_700_000, 8_200_000, "road"),
    "asiaosm": DatasetSpec("asiaosm", 12_000_000, 12_700_000, "road"),
    "germanyosm": DatasetSpec("germanyosm", 11_500_000, 12_400_000, "road"),
    # Heavy-skew R-MAT (a=0.7): the adaptive-schedule regression fixture
    "rmatSkew": DatasetSpec("rmatSkew", 262_144, 2_097_152, "skewed"),
    # Synthetic D10..D70
    "D10": DatasetSpec("D10", 491_550, 999_999, "synthetic"),
    "D20": DatasetSpec("D20", 954_225, 1_999_999, "synthetic"),
    "D30": DatasetSpec("D30", 1_400_539, 2_999_999, "synthetic"),
    "D40": DatasetSpec("D40", 1_871_477, 3_999_999, "synthetic"),
    "D50": DatasetSpec("D50", 2_303_074, 4_999_999, "synthetic"),
    "D60": DatasetSpec("D60", 2_759_417, 5_999_999, "synthetic"),
    "D70": DatasetSpec("D70", 3_222_209, 6_999_999, "synthetic"),
}


def dataset_cache_path(name: str, scale_down: float, seed: int,
                       cache_dir: str) -> str:
    """Store directory for one ``(name, scale_down, seed)`` instantiation."""
    # repr() of the float keeps 1 and 1.5 apart without formatting clashes
    tag = repr(float(scale_down)).replace(".", "p")
    return os.path.join(str(cache_dir), f"{name}_sd{tag}_seed{seed}")


def make_dataset(
    name: str,
    scale_down: float = 1.0,
    seed: int = 0,
    cache_dir: Optional[str] = None,
    mmap: bool = True,
) -> Graph:
    """Instantiate a surrogate graph for a Table-1 dataset.

    ``scale_down`` divides both vertex and edge counts (CI uses e.g. 2048).

    With ``cache_dir`` set (or the ``REPRO_DATASET_CACHE`` variable), the
    built graph is saved as a store and a later call reloads it, with
    ``mmap=True`` memmap-backed, so a hit holds no resident edge memory.
    Every hit is CRC-verified; an entry that fails is deleted and rebuilt.
    A miss returns the graph it built, resident.
    """
    if cache_dir is None:
        cache_dir = os.environ.get(CACHE_ENV) or None
    if cache_dir is None:
        return _build_dataset(name, scale_down, seed)
    from repro_torch.graphs.store import StoreError, is_store, load_graph, save_graph

    path = dataset_cache_path(name, scale_down, seed, cache_dir)
    if is_store(path):
        try:
            return load_graph(path, mmap=mmap, verify=True)
        except StoreError:
            shutil.rmtree(path)  # a damaged entry: rebuilt below
    g = _build_dataset(name, scale_down, seed)
    os.makedirs(cache_dir, exist_ok=True)
    save_graph(path, g, extra={"dataset": name, "scale_down": float(scale_down),
                               "seed": seed})
    return g


def _build_dataset(name: str, scale_down: float, seed: int) -> Graph:
    n, m, (a, b, c) = _dataset_rmat_params(name, scale_down)
    scale = max(6, math.ceil(math.log2(n)))
    src, dst = rmat_edges(scale, m, a=a, b=b, c=c, seed=seed)
    # fold down to exactly n vertices
    src = (src % n).astype(np.int32)
    dst = (dst % n).astype(np.int32)
    return Graph.from_edges(n, src, dst)


def _dataset_rmat_params(
    name: str, scale_down: float,
) -> tuple[int, int, tuple[float, float, float]]:
    """``(n, m, (a, b, c))`` of a surrogate instantiation."""
    spec = DATASETS[name]
    n = max(64, int(spec.n_vertices / scale_down))
    m = max(128, int(spec.n_edges / scale_down))
    if spec.family == "road":
        abc = (0.30, 0.25, 0.25)  # near-uniform, low skew
    elif spec.family == "web":
        abc = (0.60, 0.19, 0.19)
    elif spec.family == "skewed":
        abc = (0.70, 0.10, 0.10)  # heavy hub skew
    else:
        abc = (0.57, 0.19, 0.19)
    return n, m, abc
