"""Personalized PageRank in the port: the batched solvers on the engine
(``batched.py``) and top-k extraction (``push.py``; the push solvers come
with a later slice)."""
from repro_torch.ppr.batched import (
    normalize_seeds,
    ppr_barrier,
    ppr_blocked,
    ppr_nosync,
    ppr_numpy,
    teleport_from_seeds,
)
from repro_torch.ppr.push import topk

__all__ = [
    "normalize_seeds",
    "ppr_barrier",
    "ppr_blocked",
    "ppr_nosync",
    "ppr_numpy",
    "teleport_from_seeds",
    "topk",
]
