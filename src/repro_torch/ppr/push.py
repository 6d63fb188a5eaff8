"""Top-k extraction of a rank vector (from the reference's ``ppr/push.py``).

Only :func:`topk` is ported so far; the forward-push solvers come with a
later slice of the port.
"""
from __future__ import annotations

import numpy as np


def topk(est: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-``k`` (indices, values) of an estimate vector, sorted descending
    (ties broken by vertex id for determinism)."""
    k = min(int(k), est.shape[0])
    if k == 0:
        return np.zeros(0, np.int64), np.zeros(0, est.dtype)
    idx = np.argpartition(-est, k - 1)[:k]
    order = np.lexsort((idx, -est[idx]))
    idx = idx[order]
    return idx, est[idx]
