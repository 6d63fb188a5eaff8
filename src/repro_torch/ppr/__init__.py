"""Personalized PageRank in the port: the batched solvers on the engine
(``batched.py``), and the host forward-push solvers with top-k extraction
(``push.py``)."""
from repro_torch.ppr.batched import (
    normalize_seeds,
    ppr_barrier,
    ppr_blocked,
    ppr_nosync,
    ppr_numpy,
    teleport_from_seeds,
)
from repro_torch.ppr.push import BucketQueue, PushResult, ppr_push, push_residual, topk

__all__ = [
    "BucketQueue",
    "PushResult",
    "normalize_seeds",
    "ppr_barrier",
    "ppr_blocked",
    "ppr_nosync",
    "ppr_numpy",
    "ppr_push",
    "push_residual",
    "teleport_from_seeds",
    "topk",
]
