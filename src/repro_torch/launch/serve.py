"""Batched LM serving launcher: continuous batching over fixed decode slots,
on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --preset full

``--arch`` is any of the port's archs: dense, MoE, SSM (falcon-mamba-7b)
or hybrid (zamba2-2.7b); qwen2-vl-2b by default.  whisper-medium exits
with ``SystemExit``, as in the reference: the engine serves no
encoder-decoder.  ``--preset tiny`` (the
default) serves the arch's reduced float32 config; ``--preset full``
serves it at its published width and depth in its own dtype (qwen2-vl-2b:
28 layers, d_model 1536, bf16), from random weights drawn from a seeded
generator.  The MoE archs at their published depth do not fit one card
(mixtral-8x22b 281 GB, deepseek-v2-236b 479 GB in bf16; the reference
shards them over a TPU mesh): serve them with ``--preset tiny``.
falcon-mamba-7b (14.5 GB in bf16) and zamba2-2.7b (4.9 GB) serve whole
with ``--preset full``.  Requests are drawn as the reference's launcher
draws them.  Prompts are prefilled by teacher-forced decode steps, and
decode attention and the SSM steps are plain torch, as in the reference:
no CUDA kernel runs here (the flash kernel serves ``models.forward``).
An MoE arch's decode runs the sparse dispatch over every slot's token, as
the reference's, so at more than one slot a request's tokens depend on
the other slots'.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serving.engine import Request, ServingEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_requests(n: int, vocab: int, max_new: int) -> list[Request]:
    """``n`` requests with prompts of 2–7 random tokens, drawn from seed 0
    as the reference's launcher draws them."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=rng.integers(2, 8)),
                    max_new=max_new)
            for i in range(n)]


def run(argv=None) -> dict:
    """Parse ``argv``, serve, print the summary, and return it as a dict
    (``arch``, ``preset``, ``device``, ``requests``, ``finished``,
    ``tokens``, ``wall_s``, ``steps``, ``decode_calls``)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-vl-2b")
    ap.add_argument("--preset", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if cfg.encoder:
        raise SystemExit(f"{cfg.name} is an encoder-decoder: the ServingEngine passes "
                         f"neither frames nor a cross cache, as the reference's does not; "
                         f"decode it with models.model.decode_step and init_cross_cache")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(cfg, params, batch_slots=args.slots, max_len=args.max_len, eos=-1)
    pending = draw_requests(args.requests, cfg.vocab, args.max_new)
    prompt_tokens = sum(len(r.prompt) for r in pending)
    admitted: list[Request] = []
    _sync(dev)
    t0 = time.perf_counter()
    emitted = steps = 0
    done = 0
    while done < args.requests:
        while pending and eng.submit(pending[0]):
            print(f"admitted request {pending[0].rid}")
            admitted.append(pending.pop(0))
        out = eng.step()
        steps += 1
        emitted += len(out)
        done = args.requests - len(pending) - sum(r is not None for r in eng.requests)
    _sync(dev)
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {args.requests} requests, {emitted} tokens in {dt:.1f}s "
          f"({emitted/dt:.1f} tok/s on {where})")
    return {"arch": args.arch, "preset": args.preset, "device": where,
            "requests": args.requests, "finished": sum(r.done for r in admitted),
            "tokens": emitted, "wall_s": dt, "steps": steps,
            "decode_calls": steps + prompt_tokens}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
