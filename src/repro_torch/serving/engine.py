"""Batched LM serving: decode steps and a simple continuous-batching
engine (request queue, slot allocation, per-slot positions) — the
reference's ``serving/engine.py``.

A request's prompt is prefilled by teacher-forcing it through
:func:`decode_step`, one token per step over every slot, exactly as the
reference does; decode attention and an SSM layer's step are plain torch,
so **no kernel runs on this path**, for any arch (dense, MoE, SSM or
hybrid: the engine only calls ``decode_step``).  The CUDA flash kernel serves ``models.forward`` (prefill of
a whole sequence), which the engine, like the reference's, never calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import DecoderLM, decode_step, init_cache


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, tokens(B,1), cache, enc_out=None) → (logits,
    cache); an encoder config (whisper) attends across to ``enc_out``, as
    the reference's passes it."""

    def serve_step(params, tokens, cache, enc_out=None):
        kw = {"enc_out": enc_out} if cfg.encoder else {}
        return decode_step(cfg, params, tokens, cache, **kw)

    return serve_step


def greedy_sample(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B,1,Vpad) → (B,1) int32 argmax over the real vocab (first index on
    a tie, as ``jnp.argmax``)."""
    return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Minimal continuous-batching engine over fixed decode slots.

    Host-side scheduler (Python) over one eager decode step on the
    params' device; new requests are prefilled into a free slot's cache
    region; finished slots are recycled.  Every step advances every
    slot's cache, idle slots included, as in the reference.  Every decode
    call, in :meth:`submit` and :meth:`step`, goes through ``self._step``;
    ``tests/test_torch_lm_serving.py`` wraps it to record each call's
    logits against the reference engine's."""

    def __init__(self, cfg: ModelConfig, params: DecoderLM, batch_slots: int,
                 max_len: int, eos: int = 0):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.eos = eos
        device = params.embed.device
        self.cache = init_cache(cfg, batch_slots, max_len, device=device)
        self.requests: list[Optional[Request]] = [None] * batch_slots
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32, device=device)
        self._step = make_serve_step(cfg)

    def submit(self, req: Request) -> bool:
        for i, slot in enumerate(self.requests):
            if slot is None:
                self.requests[i] = req
                # prefill: teacher-force the prompt through decode steps
                toks = self.tokens.clone()
                for t in req.prompt:
                    toks[i, 0] = int(t)
                    logits, self.cache = self._step(self.params, toks, self.cache)
                toks[i, 0] = torch.argmax(logits[i, 0, : self.cfg.vocab])
                self.tokens = toks
                return True
        return False

    def step(self) -> list[tuple[int, int]]:
        """One decode step for every active slot; returns (rid, token) pairs."""
        logits, self.cache = self._step(self.params, self.tokens, self.cache)
        nxt = greedy_sample(logits, self.cfg.vocab)
        host = nxt[:, 0].tolist()
        emitted = []
        for i, req in enumerate(self.requests):
            if req is None:
                continue
            tok = host[i]
            req.out.append(tok)
            emitted.append((req.rid, tok))
            if tok == self.eos or len(req.out) >= req.max_new:
                req.done = True
                self.requests[i] = None
        self.tokens = nxt
        return emitted
