"""Token data pipeline, a copy of the reference's ``data/tokens.py``
(numpy only): a deterministic synthetic corpus (a Zipfian bigram LM) with
shard-aware batching, each data-parallel shard drawing only its own rows.
The same seeds give the same draws as the reference's.  Its
``make_global_batch`` is left out: nothing calls it."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Zipf-distributed tokens with local bigram structure, so that the loss
    has a learnable signal."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # bigram transition "template": each token prefers a few successors
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, 4))

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, dtype=np.int32)
        # Zipf over the vocab (clipped)
        cur = int(rng.zipf(self.cfg.zipf_a) - 1) % self.cfg.vocab
        for i in range(length):
            out[i] = cur
            if rng.random() < 0.8:
                cur = int(self._succ[cur, rng.integers(0, 4)])
            else:
                cur = int(rng.zipf(self.cfg.zipf_a) - 1) % self.cfg.vocab
        return out

    def batches(self, *, shard: int = 0, num_shards: int = 1,
                steps: Optional[int] = None) -> Iterator[np.ndarray]:
        """``(global_batch // num_shards, seq_len)`` int32 batches of
        ``shard``, step after step (forever where ``steps`` is None), each
        step's rows drawn from the seed ``(seed, step, shard)``."""
        cfg = self.cfg
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide num_shards")
        local = cfg.global_batch // num_shards
        step = 0
        while steps is None or step < steps:
            rng = np.random.default_rng((cfg.seed, step, shard))
            batch = np.stack([self._sample_doc(rng, cfg.seq_len) for _ in range(local)])
            yield batch
            step += 1
