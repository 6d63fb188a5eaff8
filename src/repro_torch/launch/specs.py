"""Abstract cells of the dry run: for every (arch × shape), the step the
port runs, its arguments on the meta device and their sharding specs, the
reference's ``launch/specs.py``.

``build_cell(cfg, shape, mesh)`` returns ``(step, args, specs, meta)``:
``step(*args)`` walks the production computation on ``torch.device("meta")``
(shapes and dtypes, nothing allocated, no generator drawn), and a counting
mode (``repro_torch.utils.cost``) around it gives its FLOPs, bytes and
peak bytes, as XLA's analyses of the compiled cell give the reference's.
The steps are those the port runs:

- prefill: ``forward(..., features_only=True)`` on the kernel route (the
  flash op once an attention layer, whose fake implementation stands in
  for the CUDA kernel on meta);
- train: ``make_train_step(cfg, ce_chunk=512)``, the plain route (the
  kernel has no backward), float32 AdamW moments;
- decode: ``make_serve_step``, one token a row against a cache of
  ``seq_len`` slots; whisper's cross K/V in ``cache["cross"]`` from
  ``init_cross_cache``, made outside the step.

``specs`` mirrors ``args`` with one spec a tensor
(``repro_torch.sharding.rules``) on the mesh's named axis sizes.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import DecoderLM, forward, init_cache, init_cross_cache
from repro_torch.serving.engine import make_serve_step
from repro_torch.sharding.rules import (
    batch_axes,
    batch_spec,
    finalize_spec,
    param_specs,
    shard_bytes,
)
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step

META = torch.device("meta")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def abstract_params(cfg: ModelConfig) -> DecoderLM:
    """The model on meta, never initialised."""
    return DecoderLM(cfg, device=META)


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """:func:`init_train_state` on meta: parameters that require grad and
    float32 AdamW moments."""
    return init_train_state(cfg, params=abstract_params(cfg))


def state_specs(cfg: ModelConfig, state: TrainState, mesh: dict) -> TrainState:
    moe = cfg.moe is not None
    return TrainState(
        params=param_specs(state.params.named_parameters(), mesh, moe),
        opt=OptState(m=param_specs(state.opt.m.items(), mesh, moe),
                     v=param_specs(state.opt.v.items(), mesh, moe), step=()),
    )


# ---------------------------------------------------------------------------
# cache sharding rules
# ---------------------------------------------------------------------------


def _cache_spec_for(path: str, shape: tuple, mesh: dict, batch_shardable: bool) -> tuple:
    """KV and SSM cache sharding, the reference's.  If the batch is too
    small for the data axes (long_500k, B = 1), the cache's time dim goes
    over ``data`` (sequence-sharded decode) and the batch is replicated.
    Every axis is dropped per dim where it does not divide.  The port's
    caches are per layer, without the reference's leading layer dims; a
    Mamba-2 state ``h (B, nh, hd, st)`` has one dim more than Mamba-1's
    ``(B, di, st)``."""
    axes = batch_axes(mesh)
    b = axes if len(axes) > 1 else axes[0]
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("k", "v") or "cross" in path:  # (B, Hk, T, dh) / (B, H, Tenc, dh)
        trailing = (b, "model", None, None) if batch_shardable else (None, "model", "data", None)
        return finalize_spec(trailing, shape, mesh)
    if leaf in ("ckv", "kr"):  # (B, T, R)
        trailing = (b, None, None) if batch_shardable else (None, "data", None)
        return finalize_spec(trailing, shape, mesh)
    if leaf == "conv":  # (B, k, di)
        return finalize_spec((b if batch_shardable else None, None, "model"), shape, mesh)
    if leaf == "h":  # (B, di, st) or Mamba-2's (B, nh, hd, st)
        trailing = (b if batch_shardable else None, "model", None)
        if len(shape) >= 4:
            trailing = (b if batch_shardable else None, "model", None, None)
        return finalize_spec(trailing, shape, mesh)
    return (None,) * len(shape)


def _map(tree, fn, path: str = ""):
    """``fn(path, tensor)`` over the tensors of a tree of dicts, lists and
    tuples, keeping its structure; paths as ``layers/0/k``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_specs(cache, mesh: dict, batch_shardable: bool):
    return _map(cache, lambda path, x: _cache_spec_for(path, tuple(x.shape), mesh,
                                                       batch_shardable))


def spec_pairs(args, specs):
    """``(tensor, spec)`` of every tensor of a cell's arguments: a model's
    parameters by name, dicts by key, lists and tuples (``TrainState``,
    ``OptState``) by position."""
    if isinstance(args, DecoderLM):
        for name, t in args.named_parameters():
            yield t, specs[name]
    elif isinstance(args, torch.Tensor):
        yield args, specs
    elif isinstance(args, dict):
        for k, v in args.items():
            yield from spec_pairs(v, specs[k])
    else:
        for a, s in zip(args, specs, strict=True):
            yield from spec_pairs(a, s)


def named_tensors(args, path: str = ""):
    """``(path, tensor)`` of every tensor of a cell's arguments: a model's
    parameters by name, dicts by key, lists and tuples by position, joined
    with ``/`` (``1/m/layers.3.attn.wq``, ``2/layers/5/k``)."""
    if isinstance(args, DecoderLM):
        for name, t in args.named_parameters():
            yield f"{path}/{name}" if path else name, t
    elif isinstance(args, torch.Tensor):
        yield path, args
    else:
        items = args.items() if isinstance(args, dict) else enumerate(args)
        for k, v in items:
            yield from named_tensors(v, f"{path}/{k}" if path else str(k))


def argument_bytes(args, specs, mesh: dict) -> int:
    """One device's bytes of the cell's arguments: each tensor's bytes over
    the product of its sharded axes' sizes."""
    return sum(shard_bytes(t.numel() * t.element_size(), s, mesh)
               for t, s in spec_pairs(args, specs))


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device=META) -> dict:
    """The model's inputs of this cell, on ``device`` (meta by default):
    int32 tokens and whisper's stubbed frames."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.zeros((b, 1 if shape.kind == "decode" else s), dtype=torch.int32,
                                   device=device)}
    if cfg.encoder:
        specs["frames"] = torch.zeros((b, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=_DTYPES[cfg.dtype], device=device)
    return specs


def _batch_specs(binputs: dict, mesh: dict) -> dict:
    return {k: batch_spec(mesh, v.dim()) for k, v in binputs.items()}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: dict, *, moe_dispatch: str = "sparse"):
    """→ ``(step, args, specs, meta)``; ``meta`` holds the step's ``kind``,
    its ``tokens`` and, for decode, whether the batch shards
    (``batch_shardable``)."""
    binputs = input_specs(cfg, shape)
    moe = cfg.moe is not None

    if shape.kind == "train":
        state = abstract_train_state(cfg)
        step = make_train_step(cfg, moe_dispatch=moe_dispatch, ce_chunk=512)
        specs = (state_specs(cfg, state, mesh), _batch_specs(binputs, mesh))
        meta = {"kind": "train", "tokens": shape.global_batch * shape.seq_len}
        return step, (state, binputs), specs, meta

    params = abstract_params(cfg)
    pspec = param_specs(params.named_parameters(), mesh, moe)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            kw = {"frames": batch["frames"]} if cfg.encoder else {}
            return forward(cfg, params, batch["tokens"], moe_dispatch=moe_dispatch,
                           features_only=True, **kw)

        meta = {"kind": "prefill", "tokens": shape.global_batch * shape.seq_len}
        return prefill_step, (params, binputs), (pspec, _batch_specs(binputs, mesh)), meta

    # decode
    n_data = 1
    for a in batch_axes(mesh):
        n_data *= mesh[a]
    batch_shardable = shape.global_batch >= n_data
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=META)
    if cfg.encoder:
        enc = torch.zeros((shape.global_batch, cfg.encoder.n_frames, cfg.d_model),
                          dtype=_DTYPES[cfg.dtype], device=META)
        with torch.no_grad():
            cache = dict(cache, cross=init_cross_cache(cfg, params, enc))
    serve = make_serve_step(cfg)

    @torch.no_grad()
    def decode(params, tokens, cache):
        return serve(params, tokens, cache)

    tok_spec = batch_spec(mesh, 2) if batch_shardable else (None, None)
    specs = (pspec, tok_spec, cache_specs(cache, mesh, batch_shardable))
    meta = {"kind": "decode", "tokens": shape.global_batch, "batch_shardable": batch_shardable}
    return decode, (params, binputs["tokens"], cache), specs, meta


# ---------------------------------------------------------------------------
# model-FLOPs accounting (6·N·D / 2·N·D with MoE-active N)
# ---------------------------------------------------------------------------

_EXPERTS = ("mlp.wi", "mlp.wg", "mlp.wo")


def count_params(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active) parameter counts from the abstract model; an MoE
    expert tensor counts ``top_k / n_experts`` of itself as active."""
    total = 0.0
    active = 0.0
    for name, p in abstract_params(cfg).named_parameters():
        n = float(p.numel())
        total += n
        if cfg.moe and name.endswith(_EXPERTS) and ".shared." not in name:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return total, active

