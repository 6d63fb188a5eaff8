"""The port's layer rematerialization (``models/remat.py``) on the CPU,
held to the reference's ``remat=True`` under
``dots_with_no_batch_dims_saveable``:

- the loss and every gradient with ``remat=True`` equal ``remat=False``
  bit for bit, for every arch (an MoE under both dispatches), at the
  reduced configs in float32;
- a layer body keeps what the reference's checkpointed body keeps: the
  multiset of (elements, dtype) of the products the port keeps equals that
  of the reference's residuals computed inside the body (``saved_residuals``
  entries that are outputs, not arguments or constants), at the reduced
  configs in their own dtype.  Elements, not shapes: the port keeps a
  projection as its ``(B·S, h·dh)`` matrix product, the reference as its
  ``dot_general``'s ``(h, dh, B, S)``, the same numbers in another layout.
  The reference's hybrid group scans its SSM layers, which stacks their
  residuals: here its layers run in a Python loop, one residual each, as
  in the port.  Its encoder layer's body is local to ``_encode``, so it is
  rebuilt here from the same calls;
- a walk of a reduced train cell on meta counts the recompute: the FLOPs
  with remat less those without equal a hand count of the products run
  again in the backward, and the peak with remat lies below the peak
  without by at least the float32 attention probabilities of all but one
  layer;
- under ``torch.no_grad()`` ``forward`` dispatches the same ops with and
  without remat.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro.models.common import make_norm as jax_make_norm
from repro.models.mlp import mlp_apply as jax_mlp_apply
from repro_torch.configs import ARCH_IDS, ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.models import model, remat
from repro_torch.models.mlp import expert_capacity
from repro_torch.training import init_train_state
from repro_torch.training import train_step as ts
from repro_torch.training.train_step import fused_chunked_ce

CASES = [(a, d) for a in ARCH_IDS for d in (("dense", "sparse") if get_config(a).moe
                                            else ("sparse",))]
B, S = 2, 33


def _batch(cfg, gen):
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    frames = (torch.randn((B, cfg.encoder.n_frames, cfg.d_model), generator=gen)
              if cfg.encoder else None)
    return toks, frames


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_remat_gradients_equal_bit_for_bit(arch, dispatch, monkeypatch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, gen, device="cpu")
    toks, frames = _batch(cfg, gen)
    named = dict(state.params.named_parameters())
    bodies = []
    let_go = remat._let_go_unread
    monkeypatch.setattr(remat, "_let_go_unread", lambda *a: bodies.append(1) or let_go(*a))
    out = []
    for on in (True, False):
        feats = model.forward(cfg, state.params, toks, frames=frames, moe_dispatch=dispatch,
                              use_flash_kernel=False, features_only=True, remat=on)
        loss = fused_chunked_ce(cfg, state.params, feats[:, :-1], toks[:, 1:], 16)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
        out.append((loss.detach(), grads))
        if on:  # every body checkpointed, whisper's encoder layers too
            enc = cfg.encoder.n_layers if cfg.encoder else 0
            assert len(bodies) == dryrun.n_bodies(cfg) + enc
    # whisper's encoder layers are rematerialized whatever remat says
    assert len(bodies) == dryrun.n_bodies(cfg) + 2 * (cfg.encoder.n_layers if cfg.encoder else 0)
    assert torch.equal(out[0][0], out[1][0])
    for name, a, b in zip(named, out[0][1], out[1][1]):
        assert torch.equal(a, b), name


def _reference_bodies(jcfg, dispatch):
    """The reference's checkpointed bodies of a one-body model, each as
    ``(fn, layer params, x)``: its order is the port's (encoder first)."""
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    dtype = jnp.dtype(jcfg.dtype)
    x = jnp.zeros((B, S, jcfg.d_model), dtype)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    if jcfg.mrope:
        pos = jnp.broadcast_to(pos[:, None], (B, 3, S))
    first = jax.tree.map(lambda a: a[0], params["layers"])
    if jcfg.ssm and not jcfg.hybrid_attn_every:
        return [(lambda lp, xx: jax_blocks.ssm_block_apply(lp, jcfg, xx), first, x)]
    if jcfg.hybrid_attn_every:
        def group(gp, xx):
            for i in range(jcfg.hybrid_attn_every):
                xx = jax_blocks.ssm_block_apply(jax.tree.map(lambda a: a[i], gp), jcfg, xx)
            return jax_blocks.decoder_block_apply(params["shared_attn"], jcfg, xx, pos,
                                                  moe_dispatch=dispatch)
        return [(group, first, x)]
    if jcfg.encoder:
        _, norm = jax_make_norm(jcfg.norm)
        frames = jnp.zeros((B, jcfg.encoder.n_frames, jcfg.d_model), dtype)

        def enc_body(lp, xx):  # _encode's body
            xx = xx + jax_attn.gqa_apply(lp["attn"], jcfg, norm(lp["ln_attn"], xx), None,
                                         causal=False)
            return xx + jax_mlp_apply(lp["mlp"], jcfg, norm(lp["ln_mlp"], xx))

        enc_first = jax.tree.map(lambda a: a[0], params["enc_layers"])
        return [(enc_body, enc_first, frames),
                (lambda lp, xx: jax_model._dec_block_apply(lp, jcfg, xx, pos, frames), first, x)]
    loc = jnp.int32(1) if jcfg.attn == "local_global" else jnp.int32(0)
    return [(lambda lp, xx: jax_blocks.decoder_block_apply(lp, jcfg, xx, pos, is_local=loc,
                                                           moe_dispatch=dispatch), first, x)]


def _reference_kept(fn, lp, x):
    policy = jax.checkpoint(fn, policy=jax_model.REMAT_POLICY)
    return sorted((int(np.prod(v.shape)), str(v.dtype)) for v, why in saved_residuals(policy, lp, x)
                  if why.startswith("output of"))


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_kept_products_are_the_references_residuals(arch, dispatch, monkeypatch):
    cfg = dryrun.calib_config(get_config(arch).reduced(), 1)
    jcfg = dryrun.calib_config(jax_get_config(arch).reduced(), 1)
    caches = []
    let_go = remat._let_go_unread

    def spy(cache, *args):
        let_go(cache, *args)
        caches.append(cache)

    monkeypatch.setattr(remat, "_let_go_unread", spy)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, gen, device="cpu")
    toks, frames = _batch(cfg, gen)
    feats = model.forward(cfg, state.params, toks, frames=frames, moe_dispatch=dispatch,
                          use_flash_kernel=False, features_only=True)
    kept = [sorted((t.numel(), str(t.dtype).removeprefix("torch.")) for t, *_ in cache
                   if t is not None) for cache in caches]
    want = [_reference_kept(*body) for body in _reference_bodies(jcfg, dispatch)]
    assert kept == want
    assert all(kept)
    feats.float().sum().backward()  # every kept product is read once, then let go
    assert all(t is None for cache in caches for t, *_ in cache)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inference_dispatches_the_same_ops(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(cfg, gen, device="cpu")  # parameters requiring grad
    toks, frames = _batch(cfg, gen)
    runs = []
    for on in (True, False):
        model._sinusoid.cache_clear()  # whisper's table is made by each run
        with torch.no_grad(), _Ops() as mode:
            out = model.forward(cfg, state.params, toks, frames=frames, remat=on,
                                use_flash_kernel=False)
        runs.append((mode.ops, out))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def _walks(arch, layers, shape, monkeypatch, dispatch="sparse"):
    """The reduced train cell at ``layers`` bodies walked on meta with and
    without remat; the config and both walks."""
    cfg = dryrun.calib_config(get_config(arch).reduced(), layers)
    monkeypatch.setattr(dryrun, "build_cell", functools.partial(dryrun.build_cell,
                                                                moe_dispatch=dispatch))
    on = dryrun.walk(cfg, shape)
    monkeypatch.setattr(ts, "forward", functools.partial(model.forward, remat=False))
    off = dryrun.walk(cfg, shape)
    return cfg, on, off


@pytest.mark.parametrize("arch,dispatch", [("stablelm-3b", "sparse"), ("qwen2-vl-2b", "sparse"),
                                           ("mixtral-8x22b", "dense"),
                                           ("mixtral-8x22b", "sparse")])
def test_walk_counts_the_recomputed_products(arch, dispatch, monkeypatch):
    """Run again in the backward, per layer: the scores and P·V, 2·B·H·S²·dh
    FLOPs each (the full S × S, masked); the sparse dispatch's three
    expert products over ``E · (cap + 1)`` slots (``wo``'s outputs weigh
    the router's gates).  The kept projections are not run again, nor the
    dense dispatch's closing product over the experts: its output is only
    added, so the recompute stops before it."""
    shape = ShapeSpec("remat_train", 64, 2, "train")
    cfg, on, off = _walks(arch, 4, shape, monkeypatch, dispatch)
    b, s, h, dh = 2, 64, cfg.n_heads, cfg.resolved_head_dim
    per_layer = 4 * b * h * s * s * dh
    if cfg.moe and dispatch == "sparse":
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        cap = expert_capacity(b * s, cfg, 1.25)
        per_layer += 3 * 2 * e * (cap + 1) * cfg.d_model * fe
    assert on["flops"] - off["flops"] == cfg.n_layers * per_layer
    probs = b * h * s * s * 4
    assert off["peak_bytes"] - on["peak_bytes"] >= (cfg.n_layers - 1) * probs


def test_walk_counts_the_recomputed_scan(monkeypatch):
    """falcon-mamba-7b: the products run again are each scan chunk's
    ``h·C`` (2·B·S·di·N FLOPs a layer); the in, x and dt projections are
    kept, and out_proj's output is only added."""
    shape = ShapeSpec("remat_train", 64, 2, "train")
    cfg, on, off = _walks("falcon-mamba-7b", 4, shape, monkeypatch)
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state
    assert on["flops"] - off["flops"] == cfg.n_layers * 2 * 2 * 64 * di * n
    assert on["peak_bytes"] < off["peak_bytes"]
