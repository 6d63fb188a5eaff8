"""End-to-end training driver, the reference's ``launch/train.py``, on the
GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b --preset tiny \\
        --steps 100 --ckpt-dir build/ckpt [--dp-mode nosync --inner-steps 4]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

Presets: ``tiny`` (the arch's reduced config in float32), ``100m`` (~100 M
parameters of the same family, float32), ``full`` (the published config
in its own dtype: stablelm-3b trains at full width on one H100 in bf16,
2.8 B parameters).  ``--dp-mode sync`` takes one AdamW step a batch
(``training.train_step``), with checkpoints every ``--ckpt-every`` steps
and a resume from the directory's ``LATEST``; ``nosync`` runs local SGD
over ``--replicas`` replicas on the one device with int8-compressed outer
syncs every ``--inner-steps`` steps (``training.local_sgd``).  MoE layers
take the dense dispatch and the loss chunks of 128 positions, as in the
reference; whisper's batches carry frames of ones.  As in the reference,
a resumed run draws its batches from the corpus's first step again.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import latest_step, restore_into, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.training.local_sgd import make_local_sgd_step, replicate_state
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step


def preset_config(arch: str, preset: str):
    """The reference's presets: ``tiny`` the reduced config in float32;
    ``100m`` 12 layers, d_model 768, 12 heads of 64, d_ff 3072, vocab at
    most 32,768, float32 (8 experts top 2 of 1024 for an MoE, a shared
    block every 4 for the hybrid, 6 encoder layers of 256 frames for
    whisper); ``full`` the published config."""
    cfg = get_config(arch)
    if preset == "tiny":
        return dataclasses.replace(cfg.reduced(), dtype="float32")
    if preset == "100m":
        # ~100M params: 12 layers, d=768 (GPT-2-small-ish of the same family)
        changes = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=min(cfg.n_kv_heads, 12) or 12,
                       head_dim=64, d_ff=3072, vocab=min(cfg.vocab, 32768), dtype="float32")
        if cfg.ssm:
            changes["n_layers"] = 12
        if cfg.hybrid_attn_every:
            changes["hybrid_attn_every"] = 4
        if cfg.moe:
            changes["moe"] = dataclasses.replace(cfg.moe, n_experts=8, top_k=2, d_ff_expert=1024)
        if cfg.encoder:
            changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=6, n_frames=256)
        return dataclasses.replace(cfg, **changes)
    return cfg  # full


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batch(cfg, tokens: np.ndarray, dev: torch.device) -> dict:
    """The step's tokens on the device; whisper's frames of ones (float32,
    ``(…, n_frames, d_model)`` beside the tokens' leading dims)."""
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    if cfg.encoder:
        batch["frames"] = torch.ones((*tokens.shape[:-1], cfg.encoder.n_frames, cfg.d_model),
                                     dtype=torch.float32, device=dev)
    return batch


def _param_sums(model) -> list[float]:
    """Each parameter's float64 sum: a cheap fingerprint of the weights."""
    with torch.no_grad():
        return torch.stack([p.double().sum() for p in model.parameters()]).tolist()


def run(argv=None) -> dict:
    """Parse ``argv``, train, print a line every ``--log-every`` steps, and
    return a summary: ``arch``, ``preset``, ``device``, ``dp_mode``,
    ``params``, ``start_step``, ``losses`` and ``grad_norms`` (one a step;
    nosync: the mean loss of each outer step, no norms), ``step_s`` (wall
    seconds of each step or outer step, the device synchronized),
    ``peak_mem`` (bytes the device allocated at most, None on the CPU),
    ``saved`` (the checkpointed steps), ``changed`` (sync: the
    parameters whose sum moved over the run's steps; nosync: whether every
    replica's parameters are equal after the last sync) and ``state``
    (sync: the train state after the last step, for a caller to go on
    with; nosync: None)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-3b")
    ap.add_argument("--preset", choices=("tiny", "100m", "full"), default="tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dp-mode", choices=("sync", "nosync"), default="sync")
    ap.add_argument("--inner-steps", type=int, default=4, help="nosync: local steps per outer sync")
    ap.add_argument("--replicas", type=int, default=2, help="nosync: replicas")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = preset_config(args.arch, args.preset)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M "
          f"device={dev} dp_mode={args.dp_mode}", flush=True)

    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                      global_batch=args.global_batch, seed=0))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5))
    start_step = 0
    losses, norms, step_s, saved = [], [], [], []

    if args.dp_mode == "sync":
        step_fn = make_train_step(cfg, opt_cfg, moe_dispatch="dense", ce_chunk=128)
        if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            state, start_step = restore_into(args.ckpt_dir, state)
            print(f"restored checkpoint at step {start_step}", flush=True)
        sums = _param_sums(state.params)
        for i, tokens in enumerate(data.batches(steps=args.steps)):
            step = start_step + i
            t0 = time.perf_counter()
            state, metrics = step_fn(state, _batch(cfg, tokens, dev))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            if step % args.log_every == 0:
                print(f"step {step}: loss={losses[-1]:.4f} gnorm={norms[-1]:.2f} "
                      f"({step_s[-1]:.2f}s/step)", flush=True)
            if args.ckpt_dir and step and step % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, state, step)
                saved.append(step)
                print(f"checkpointed step {step}", flush=True)
        changed = sum(a != b for a, b in zip(sums, _param_sums(state.params)))
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, state, start_step + args.steps)
            saved.append(start_step + args.steps)
    else:
        R, H = args.replicas, args.inner_steps
        ls = replicate_state(state, R)
        del state
        lstep = make_local_sgd_step(cfg, opt_cfg, inner_steps=H, compress=True,
                                    moe_dispatch="dense")
        buf = []
        for tokens in data.batches(steps=args.steps * R * H):
            buf.append(tokens)
            if len(buf) < R * H:
                continue
            chunk = np.stack(buf).reshape(R, H, *buf[0].shape)
            buf = []
            t0 = time.perf_counter()
            ls, metrics = lstep(ls, _batch(cfg, chunk, dev))
            losses.append(float(metrics["loss"]))
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            outer = len(losses)
            if outer % max(args.log_every // H, 1) == 0:
                print(f"outer {outer} (≈{outer * H} steps/replica): loss={losses[-1]:.4f} "
                      f"({step_s[-1]:.2f}s/outer)", flush=True)
        first = dict(ls.params_r[0].named_parameters())
        changed = all(torch.equal(first[k], p) for rep in ls.params_r[1:]
                      for k, p in rep.named_parameters())
        state = None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    print("done", flush=True)
    return {"arch": cfg.name, "preset": args.preset, "device": str(dev),
            "dp_mode": args.dp_mode, "params": n_params, "start_step": start_step,
            "losses": losses, "grad_norms": norms, "step_s": step_s, "peak_mem": peak,
            "saved": saved, "changed": changed, "state": state}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
