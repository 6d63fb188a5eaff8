"""The port's whisper-medium on the CPU — the encoder (non-causal
self-attention), the decoder with cross attention and its cached K/V, the
sinusoidal positions — held against the JAX reference on the same weights
and inputs.

Config: whisper-medium's reduced config (2 encoder and 2 decoder layers,
d_model 128, 4 heads of 32, 64 frames, vocab 512) in float32.  Weights:
the reference's ``init_params`` carried into the port by
``convert.params_from_jax``.  Inputs: numpy, fixed seeds.  Tolerances:
1e-5 × max|ref| for float32 outputs (sums in another order, exp and the
products from other libraries), 1e-6 × max between the port's own two
decode paths (the same products, K/V projected once or every step), the
reference's 2e-3 for decode against prefill.  ``_sinusoid`` is numpy in
both packages and equal bit for bit; ``_sinusoid_at`` computes its power,
sin and cos in float32 through XLA in the reference and through ATen here,
which round differently in the last bit, so it is held within 2⁻²² ×
(|angle| + 1): one ulp of the angle carried through sin, and one of the
result.

The reference's ``forward`` never passes its ``use_flash_kernel`` to the
whisper layers (they run its jnp attention); the port routes them to the
flash op, whose CPU version is the plain one: both of the port's routes
are held to the reference's one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import model as jax_model
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import launch_counts
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models import model as port_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    encode,
    forward,
    init_cache,
    init_cross_cache,
    init_params,
)
from repro_torch.serving import make_serve_step

CPU = torch.device("cpu")
ARCH = "whisper-medium"
RTOL = 1e-5
PATHS_RTOL = 1e-6
DECODE_TOL = 2e-3
STEPS = 8


def reduced(get):
    return dataclasses.replace(get(ARCH).reduced(), dtype="float32")


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config)


@pytest.fixture(scope="module")
def jcfg():
    return reduced(jax_get_config)


@pytest.fixture(scope="module")
def jax_params(jcfg):
    return jax_model.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, jax_params):
    return params_from_jax(cfg, jax.tree.map(np.asarray, jax_params), device=CPU)


def close(out, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rtol * float(np.abs(ref).max()), rtol=0)


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def frames(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def enc(cfg, jcfg, jax_params, params):
    """The reference's and the port's encoder outputs on the same frames."""
    fr = frames(3, 2, cfg)
    return (jax_model._encode(jcfg, jax_params, jnp.asarray(fr)),
            encode(cfg, params, torch.from_numpy(fr)))


# ---------------------------------------------------------------------------
# config, parameters
# ---------------------------------------------------------------------------


def test_config_and_reduced_config_are_the_references():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    small = get_config(ARCH).reduced()
    assert dataclasses.asdict(small) == dataclasses.asdict(jax_get_config(ARCH).reduced())
    assert (small.encoder.n_layers, small.encoder.n_frames, small.encoder.d_frontend) == \
        (2, 64, 128)
    assert not small.rope_enabled and small.norm == "layernorm" and small.mlp == "gelu"


def test_full_width_parameter_count():
    """811,323,392 parameters with the untied head, the reference's count
    (``jax.eval_shape``); 24 encoder and 24 decoder layers."""
    model = DecoderLM(get_config(ARCH), device="meta")
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax_get_config(ARCH),
                                                          jax.random.PRNGKey(0)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want == 811_323_392
    assert len(model.enc_layers) == len(model.layers) == 24
    assert model.embed.dtype == torch.bfloat16 and hasattr(model, "lm_head")


def test_init_params_gives_the_reference_shape_tree(cfg, jax_params):
    port = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        name = ".".join(k.key for k in path)
        stack = name.split(".")[0]
        if stack in ("layers", "enc_layers"):
            for i in range(leaf.shape[0]):
                want[f"{stack}.{i}.{name[len(stack) + 1:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert {type(b).__name__ for b in port.layers} == {"CrossDecoderBlock"}
    assert {type(b).__name__ for b in port.enc_layers} == {"EncoderBlock"}


@pytest.mark.parametrize("drop", ["ln_cross.scale", "ln_cross.bias", "cross.wk"])
def test_params_from_jax_refuses_a_missing_cross_leaf(drop, cfg, jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    params_from_jax(cfg, tree, device=CPU)  # as it is: loads
    module, leaf = drop.split(".")
    tree["layers"][module] = {k: v for k, v in tree["layers"][module].items() if k != leaf}
    with pytest.raises(RuntimeError, match="Missing key"):
        params_from_jax(cfg, tree, device=CPU)


def test_params_from_jax_refuses_a_misshapen_encoder_leaf(cfg, jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    tree["enc_layers"]["attn"]["wq"] = tree["enc_layers"]["attn"]["wq"][..., :16]
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(cfg, tree, device=CPU)


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,d", [(64, 128), (448, 1024), (1500, 1024)])
def test_sinusoid_is_the_references_bit_for_bit(s, d):
    ref = np.asarray(jax_model._sinusoid(s, d, jnp.float32))
    out = port_model._sinusoid(s, d, torch.float32, CPU).numpy()
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("d", [128, 1024])
def test_sinusoid_at_matches_the_reference(d):
    pos = np.arange(0, 448 * 4, 7, dtype=np.int32)
    ref = np.asarray(jax_model._sinusoid_at(jnp.asarray(pos), d, jnp.float32))
    out = port_model._sinusoid_at(torch.from_numpy(pos), d, torch.float32).numpy()
    ang = pos[:, None] / np.power(10_000.0, np.arange(0, d, 2) / d)[None]
    bound = 2.0**-22 * (np.repeat(ang, 2, axis=1) + 1)
    assert np.all(np.abs(out - ref) <= bound)


def test_sinusoid_rows_of_prefill_and_decode_are_the_references_two_ways():
    """Prefill adds ``_sinusoid``'s float64-angle rows, decode
    ``_sinusoid_at``'s float32 ones: the port keeps both, as the
    reference."""
    pos = torch.arange(448, dtype=torch.int32)
    at = port_model._sinusoid_at(pos, 1024, torch.float32)
    whole = port_model._sinusoid(448, 1024, torch.float32, CPU)
    assert not torch.equal(at, whole)
    assert float((at - whole).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# attention: no RoPE, cross attention
# ---------------------------------------------------------------------------


def test_rope_is_off_without_rope_enabled_or_positions(cfg):
    """``_rope`` returns its input where ``rope_enabled`` is False or the
    positions are None, as the reference's; with RoPE on it rotates."""
    x = torch.randn(2, 4, 8, 32, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    assert attention._rope(cfg, x, pos) is x
    on = dataclasses.replace(cfg, rope_enabled=True)
    assert attention._rope(on, x, None) is x
    assert not torch.equal(attention._rope(on, x, pos), x)


def test_gqa_apply_without_rope_matches(cfg, jcfg, jax_params, params):
    """The encoder's self-attention (non-causal) and the decoder's (causal),
    positions given but RoPE off."""
    x = np.random.default_rng(4).standard_normal((2, 16, 128)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jax_params["enc_layers"]["attn"])
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32)[None], (2, 16))
    for causal in (False, True):
        ref = jax_attention.gqa_apply(lp, jcfg, jnp.asarray(x), pos, causal=causal)
        for use_kernel in (True, False):
            out = attention.gqa_apply(params.enc_layers[0].attn, cfg, torch.from_numpy(x),
                                      torch.tensor(np.asarray(pos)), causal=causal,
                                      use_kernel=use_kernel)
            close(out, ref)


def test_cross_attention_matches(cfg, jcfg, jax_params, params, enc):
    x = np.random.default_rng(5).standard_normal((2, 12, 128)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], jax_params["layers"]["cross"])
    ref_enc, port_enc = enc
    close(port_enc, ref_enc)
    ref = jax_attention.cross_apply(lp, jcfg, jnp.asarray(x), ref_enc)
    close(attention.cross_apply(params.layers[1].cross, cfg, torch.from_numpy(x),
                                port_enc), ref)
    k, v = attention.cross_kv(params.layers[1].cross, port_enc)
    rk, rv = jax_attention.cross_kv(lp, ref_enc)
    close(k, rk)
    close(v, rv)
    ref_cached = jax_attention.cross_apply_cached(lp, jcfg, jnp.asarray(x), rk, rv)
    close(attention.cross_apply_cached(params.layers[1].cross, cfg, torch.from_numpy(x),
                                       k, v), ref_cached)


# ---------------------------------------------------------------------------
# forward, cross cache, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_flash_kernel", [True, False])
def test_forward_matches(use_flash_kernel, cfg, jcfg, jax_params, params):
    toks, fr = tokens(6, 2, 24), frames(7, 2, cfg)
    ref = jax_model.forward(jcfg, jax_params, jnp.asarray(toks), frames=jnp.asarray(fr))
    before = launch_counts()
    out = forward(cfg, params, torch.from_numpy(toks), frames=torch.from_numpy(fr),
                  use_flash_kernel=use_flash_kernel)
    assert launch_counts() == before  # the CPU runs the plain version
    assert out.dtype == torch.float32 and out.shape == (2, 24, 512)
    close(out, ref)


def test_forward_features_only_matches(cfg, jcfg, jax_params, params):
    toks, fr = tokens(8, 2, 16), frames(9, 2, cfg)
    ref = jax_model.forward(jcfg, jax_params, jnp.asarray(toks), frames=jnp.asarray(fr),
                            features_only=True)
    out = forward(cfg, params, torch.from_numpy(toks), frames=torch.from_numpy(fr),
                  features_only=True)
    assert out.shape == (2, 16, 128)
    close(out, ref)


def test_forward_and_decode_need_the_encoder(cfg, params):
    toks = torch.from_numpy(tokens(10, 1, 4))
    with pytest.raises(ValueError, match="needs frames"):
        forward(cfg, params, toks)
    with pytest.raises(ValueError, match="enc_out"):
        decode_step(cfg, params, toks[:, :1], init_cache(cfg, 1, 8, device=CPU))


def test_init_cross_cache_equals_the_reference(cfg, jcfg, jax_params, params, enc):
    ref_k, ref_v = jax_model.init_cross_cache(jcfg, jax_params, enc[0])
    cross = init_cross_cache(cfg, params, enc[1])
    assert len(cross) == cfg.n_layers
    close(torch.stack([k for k, _ in cross]), ref_k)
    close(torch.stack([v for _, v in cross]), ref_v)


def _ref_decode(jcfg, jax_params, toks, enc_out, cached):
    cache = jax_model.init_cache(jcfg, toks.shape[0], STEPS)
    kw = {}
    if cached:
        cache["cross"] = jax_model.init_cross_cache(jcfg, jax_params, enc_out)
    else:
        kw["enc_out"] = enc_out
    outs = []
    for t in range(STEPS):
        logits, cache = jax_model.decode_step(jcfg, jax_params, jnp.asarray(toks[:, t:t + 1]),
                                              cache, **kw)
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1)


def _port_decode(cfg, params, toks, enc_out, cached):
    cache = init_cache(cfg, toks.shape[0], STEPS, device=CPU)
    step = make_serve_step(cfg)
    enc_arg = None
    if cached:
        cache["cross"] = init_cross_cache(cfg, params, enc_out)
    else:
        enc_arg = enc_out
    outs = []
    for t in range(STEPS):
        logits, cache = step(params, torch.from_numpy(toks[:, t:t + 1]), cache, enc_arg)
        outs.append(logits[:, 0])
        assert int(cache["layers"][0]["pos"][0]) == t + 1
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("cached", [True, False], ids=["cross_cache", "enc_out"])
def test_decode_step_matches(cached, cfg, jcfg, jax_params, params, enc):
    toks = tokens(11, 2, STEPS)
    before = launch_counts()
    out = _port_decode(cfg, params, toks, enc[1], cached)
    assert launch_counts() == before
    close(out, _ref_decode(jcfg, jax_params, toks, enc[0], cached))


def test_the_two_decode_paths_agree(cfg, params, enc):
    toks = tokens(12, 2, STEPS)
    cached = _port_decode(cfg, params, toks, enc[1], True)
    close(_port_decode(cfg, params, toks, enc[1], False), cached.numpy(), rtol=PATHS_RTOL)


def test_decode_matches_forward(cfg, params):
    """Teacher-forced decode against prefill, the reference's tolerance."""
    toks, fr = tokens(13, 2, STEPS), frames(14, 2, cfg)
    full = forward(cfg, params, torch.from_numpy(toks), frames=torch.from_numpy(fr))
    enc_out = encode(cfg, params, torch.from_numpy(fr))
    dec = _port_decode(cfg, params, toks, enc_out, True)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=DECODE_TOL, rtol=DECODE_TOL)


def test_serve_refuses_whisper_as_the_reference_does():
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.run(["--arch", ARCH, "--device", "cpu"])
