"""The port's dense LM path on the CPU, module by module, held against the
JAX reference on the same weights and inputs.

Config: qwen2-vl-2b reduced (2 layers, d_model 128, 4 heads, 2 KV heads,
head_dim 32, vocab 512) in float32.  Weights: the reference's
``init_params`` carried into the port by ``convert.params_from_jax``.
Inputs: numpy, fixed seeds.  Tolerances, all float32: 1e-5 × the largest
|value| of the compared output (the sums run in another order and sin/cos
and exp come from other libraries, so results differ by a few ulps of
the largest term), 2e-5 where the reference's Pallas kernel runs in
interpret mode (its own test's tolerance), and the reference's 2e-3 for
decode against prefill.

The reference's ``forward(..., use_flash_kernel=True)`` does not run on
the CPU (it never passes ``interpret`` down to the kernel), so the
model-level reference is its plain route; the attention-level reference
is ``gqa_apply(..., use_kernel=True, interpret=True)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.models import model as jax_model
from repro.models import rope as jax_rope
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import launch_counts
from repro_torch.models import attention, common, mlp, rope
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward,
    check_ported,
    init_cache,
    init_params,
)

CPU = torch.device("cpu")
RTOL = 1e-5


def reduced(get):
    return dataclasses.replace(get("qwen2-vl-2b").reduced(), dtype="float32")


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config)


@pytest.fixture(scope="module")
def jax_params():
    return jax_model.init_params(reduced(jax_get_config), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, jax_params):
    return params_from_jax(cfg, jax.tree.map(np.asarray, jax_params), device=CPU)


def close(out, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rtol * float(np.abs(ref).max()), rtol=0)


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_is_a_copy_of_the_reference():
    """All ten of the reference's archs, in its order, each config and its
    reduced config (the window cut to 64 and the MoE, MLA, SSM and encoder
    sub-configs shrunk included) equal to the reference's; an unknown arch
    raises ``KeyError``."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert ARCH_IDS == ("starcoder2-3b", "phi3-medium-14b", "gemma2-2b", "stablelm-3b",
                        "zamba2-2.7b", "whisper-medium", "falcon-mamba-7b", "qwen2-vl-2b",
                        "mixtral-8x22b", "deepseek-v2-236b")
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(jax_get_config(arch).reduced())
    assert get_config("starcoder2-3b").reduced().window == 64
    assert get_config("gemma2-2b").reduced().window == 64
    assert get_config("deepseek-v2-236b").reduced().moe.n_shared == 1
    assert get_config("deepseek-v2-236b").reduced().head_dim == 0
    assert get_config("whisper-medium").reduced().encoder.n_frames == 64
    assert dataclasses.asdict(reduced(get_config)) == dataclasses.asdict(reduced(jax_get_config))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")


def test_full_width_parameter_count():
    c = get_config("qwen2-vl-2b")
    model = DecoderLM(c, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 1_543_853_568
    assert model.embed.shape == (152_064, 1536) and model.embed.dtype == torch.bfloat16


def test_init_params_gives_the_reference_shape_tree(cfg, jax_params):
    port = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_params)[0]:
        name = ".".join(k.key for k in path)
        if name.startswith("layers."):
            for i in range(leaf.shape[0]):
                want[f"layers.{i}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in port.state_dict().values())


@pytest.mark.parametrize("module", ["attention", "mlp", "block"])
def test_module_inits_give_the_reference_shapes(module, cfg):
    from repro.models import blocks as jax_blocks
    from repro_torch.models.attention import gqa_init
    from repro_torch.models.blocks import decoder_block_init
    from repro_torch.models.mlp import mlp_init

    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    ref, port = {
        "attention": (lambda: jax_attention.gqa_init(key, cfg, jnp.float32),
                      lambda: gqa_init(cfg, torch.float32, generator=gen, device=CPU)),
        "mlp": (lambda: jax_mlp.mlp_init(key, cfg, jnp.float32),
                lambda: mlp_init(cfg, torch.float32, generator=gen, device=CPU)),
        "block": (lambda: jax_blocks.decoder_block_init(key, cfg, jnp.float32),
                  lambda: decoder_block_init(cfg, torch.float32, generator=gen, device=CPU)),
    }[module]
    want = {".".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref())[0]}
    got = port().state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(bool(v.abs().sum() > 0) for v in got.values())  # every weight drawn


@pytest.mark.parametrize("module", ["attention", "mlp", "block"])
def test_module_inits_need_a_device(module, cfg):
    """No default device: a caller that names none would get CPU weights."""
    from repro_torch.models.attention import gqa_init
    from repro_torch.models.blocks import decoder_block_init
    from repro_torch.models.mlp import mlp_init

    init = {"attention": gqa_init, "mlp": mlp_init, "block": decoder_block_init}[module]
    with pytest.raises(TypeError, match="device"):
        init(cfg, torch.float32, generator=torch.Generator().manual_seed(0))


def test_init_draws_truncated_normals_at_fan_in_scale():
    w = torch.empty(256, 512)
    common.dense_init_(w, torch.Generator().manual_seed(1), 256)
    z = w * 256**0.5
    assert float(z.abs().max()) <= 2.0
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 0.8796) < 0.01  # std of N(0,1) truncated at ±2
    again = torch.empty(256, 512)
    common.dense_init_(again, torch.Generator().manual_seed(1), 256)
    assert torch.equal(w, again)


def test_params_from_jax_rejects_a_wrong_tree(cfg, jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    tree["ln_f"]["scale"] = tree["ln_f"]["scale"][:-1]
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(cfg, tree, device=CPU)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 16)).astype(np.int32)
    ref = jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta), ref)


def test_apply_mrope_matches_with_three_different_streams():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 16, 128)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 3, 16)).astype(np.int32)
    assert len({tuple(pos3[0, i]) for i in range(3)}) == 3
    ref = jax_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    close(rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6), ref)
    # equal streams degenerate to RoPE
    same = np.repeat(pos3[:, :1], 3, axis=1)
    close(rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6),
          jax_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos3[:, 0]), 1e6))


def test_mrope_sections_split_head_dim_128_at_16_and_40():
    assert rope.MROPE_SECTIONS == jax_rope.MROPE_SECTIONS
    assert rope.mrope_sections(128) == (16, 40)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    """RMSNorm in float32 statistics, cast back to the input's dtype: 1e-5
    of max|out| in float32, and within one bf16 ulp of it (2⁻⁷ relative)
    in bfloat16, where the two packages round the same float32 value."""
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 8, 64)) + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    norm = common.RMSNorm(64, dtype=getattr(torch, dtype), device=CPU)
    norm.scale.copy_(torch.from_numpy(scale))
    jscale = jnp.asarray(scale).astype(dtype)
    ref = jax_common.rmsnorm({"scale": jscale}, jnp.asarray(x).astype(dtype))
    out = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    close(out, ref, rtol=RTOL if dtype == "float32" else 2.0**-7)


@pytest.mark.parametrize("shape", [(2, 8), (3, 1)])  # prefill and decode rows
def test_mlp_apply_matches(shape, cfg):
    jparams = jax_mlp.mlp_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    m = mlp.MLP(cfg, dtype=torch.float32, device=CPU)
    m.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in jparams.items()})
    x = np.random.default_rng(3).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    close(mlp.mlp_apply(m, torch.from_numpy(x)), jax_mlp.mlp_apply(jparams, cfg, jnp.asarray(x)))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_apply_matches_the_reference_kernel_route(use_kernel, cfg, jax_params, params):
    """JAX through the Pallas flash kernel (interpret mode) at S = 128, the
    port on the CPU through both of its routes, with M-RoPE text positions."""
    s = 128
    x = np.random.default_rng(4).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], jax_params["layers"]["attn"])
    pos = jax_model._positions(cfg, jnp.zeros((2, s), jnp.int32))
    ref = jax_attention.gqa_apply(lp, cfg, jnp.asarray(x), pos, use_kernel=True, interpret=True)
    port_pos = torch.from_numpy(np.array(pos))
    out = attention.gqa_apply(params.layers[0].attn, cfg, torch.from_numpy(x), port_pos,
                              use_kernel=use_kernel)
    close(out, ref, rtol=2e-5)


@pytest.mark.parametrize("s", [48, 64, 96])
def test_plain_route_q_chunks_match_the_reference(s, cfg, monkeypatch):
    """The plain route's q-chunking (seq >= CHUNK_Q_THRESHOLD), cut to
    16-row chunks from 64 rows on in both packages: 48 rows in one piece,
    64 and 96 in chunks, each chunk's causal mask offset by its start."""
    for mod in (attention, jax_attention):
        monkeypatch.setattr(mod, "CHUNK_Q_THRESHOLD", 64)
        monkeypatch.setattr(mod, "CHUNK_Q", 16)
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, h, s, 32)).astype(np.float32) for h in (4, 2, 2))
    ref = jax_attention._softcap_attention(cfg, *map(jnp.asarray, (q, k, v)), 32**-0.5,
                                           True, None)
    out = attention._plain_attention(*map(torch.from_numpy, (q, k, v)), 32**-0.5)
    close(out, ref)


@pytest.mark.parametrize("use_flash_kernel", [True, False])
@pytest.mark.parametrize("b,s", [(2, 32), (1, 128)])
def test_forward_matches(use_flash_kernel, b, s, cfg, jax_params, params):
    toks = tokens(5, b, s, cfg.vocab)
    ref = jax_model.forward(cfg, jax_params, jnp.asarray(toks), use_flash_kernel=False,
                            remat=False)
    out = forward(cfg, params, torch.from_numpy(toks), use_flash_kernel=use_flash_kernel)
    assert out.dtype == torch.float32 and out.shape == (b, s, 512)
    close(out, ref)


def test_forward_in_bfloat16_tracks_the_reference(cfg, jax_params):
    """bf16 weights from the same tree.  The two packages round at other
    places, so they agree only to a few bf16 ulps: within 4 ulps of
    max|logits| (4·2⁻⁷ relative), the same argmax for ≥ 95 % of tokens, and
    the port's mean |Δ| to the float32 forward on the same rounded weights
    at most 1.25× the reference's."""
    c = dataclasses.replace(cfg, dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_params)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    port = params_from_jax(c, tree, device=CPU)
    toks = tokens(6, 2, 32, c.vocab)
    ref = np.asarray(jax_model.forward(c, jp, jnp.asarray(toks), use_flash_kernel=False,
                                       remat=False))
    out = forward(c, port, torch.from_numpy(toks)).numpy()
    f32 = forward(cfg, params_from_jax(cfg, tree, device=CPU), torch.from_numpy(toks)).numpy()
    assert np.abs(out - ref).max() <= 4 * 2.0**-7 * np.abs(ref).max()
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.95
    assert np.abs(out - f32).mean() <= 1.25 * np.abs(ref - f32).mean()


def test_decode_step_matches_over_ring_slots(cfg, jax_params, params):
    """8 teacher-forced steps into a cache of 4 slots: the ring wraps twice,
    so each step overwrites the oldest slot, in both packages."""
    b, steps, max_len = 2, 8, 4
    toks = tokens(7, b, steps, cfg.vocab)
    jcache = jax_model.init_cache(cfg, b, max_len)
    cache = init_cache(cfg, b, max_len, device=CPU)
    for t in range(steps):
        ref, jcache = jax_model.decode_step(cfg, jax_params, jnp.asarray(toks[:, t:t + 1]), jcache)
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, t:t + 1]), cache)
        assert out.shape == (b, 1, 512)
        close(out, ref)
    for i, lc in enumerate(cache["layers"]):
        for key in ("k", "v"):
            close(lc[key], jcache["layers"][key][i])
        assert lc["pos"].tolist() == [steps] * b
        assert lc["pos"].dtype == torch.int32


def test_decode_matches_forward(cfg, params):
    """Teacher-forcing the same tokens through decode_step reproduces the
    forward logits (cache correctness), at the reference test's 2e-3."""
    b, s = 2, 8
    toks = torch.from_numpy(tokens(8, b, s, cfg.vocab))
    full = forward(cfg, params, toks)
    cache = init_cache(cfg, b, s, device=CPU)
    outs = []
    for t in range(s):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


def test_ring_write_is_the_reference_one_hot_blend():
    rng = np.random.default_rng(9)
    cache = rng.standard_normal((3, 2, 5, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 1, 4)).astype(np.float32)
    pos = np.array([0, 7, 14], np.int32)
    ref = jax_attention._ring_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    out = attention._ring_write(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                                torch.from_numpy(pos))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    ref_abs = jax_attention._slot_abs_pos(jnp.asarray(pos), 5)
    assert np.array_equal(attention._slot_abs_pos(torch.from_numpy(pos), 5).numpy(),
                          np.asarray(ref_abs))


def test_cpu_forward_launches_no_kernel(cfg, params):
    before = launch_counts()
    forward(cfg, params, torch.zeros((1, 8), dtype=torch.int32))
    assert launch_counts() == before


@pytest.mark.parametrize("field,value,slice_", [
    ("attn", "mla", "MLA"),
    ("attn", "none", "SSM"),
    ("moe", "set", "MoE"),
    ("mla", "set", "MLA"),
    ("ssm", "set", "SSM"),
    ("hybrid_attn_every", 2, "SSM"),
    ("encoder", "set", "whisper"),
    ("rope_enabled", False, "whisper"),
])
def test_unported_config_fields_raise(field, value, slice_, cfg):
    """Every config field the reference runs is ported: on qwen2-vl-2b's
    reduced config (plain RoPE positions for MLA, which takes no M-RoPE;
    ``attn="mla"`` with the reference's reduced MLA config; ``attn="none"``
    with a Mamba-1 config, the pure-SSM stack; ``hybrid_attn_every`` with a
    Mamba-2 config, one group of 2 SSM layers and the shared block; an
    ``encoder``, the whisper stack: encoder layers and decoder layers with
    cross attention, prefilled with frames and decoded through the cross
    cache; ``rope_enabled=False``, the decoder without rotation) they
    build, prefill and decode, and ``check_ported`` passes them."""
    from repro_torch.configs import EncoderConfig, MLAConfig, MoEConfig, SSMConfig
    from repro_torch.models.model import encode, init_cross_cache

    fill = {"moe": MoEConfig(4, 2, 64), "mla": MLAConfig(64, 32, 32, 16, 32),
            "ssm": SSMConfig("mamba1", 16), "encoder": EncoderConfig(2, 64, 128)}
    c = dataclasses.replace(cfg, **{field: fill[field] if value == "set" else value})
    if c.attn == "mla":
        c = dataclasses.replace(c, mla=fill["mla"], mrope=False, head_dim=0)
    if field == "attn" and value == "none":
        c = dataclasses.replace(c, ssm=fill["ssm"])
    if field == "hybrid_attn_every":
        c = dataclasses.replace(c, ssm=SSMConfig("mamba2", 16, headdim=32))
    check_ported(c)
    model = init_params(c, torch.Generator().manual_seed(0), device=CPU)
    if c.ssm is not None:
        assert [type(layer).__name__ for layer in model.layers] == ["SSMBlock"] * 2
        assert type(model.layers[0].ssm).__name__ == ("Mamba2" if c.hybrid_attn_every
                                                      else "Mamba1")
        assert hasattr(model, "shared_attn") == bool(c.hybrid_attn_every)
    elif c.encoder is not None:
        assert [type(layer).__name__ for layer in model.layers] == ["CrossDecoderBlock"] * 2
        assert [type(layer).__name__ for layer in model.enc_layers] == ["EncoderBlock"] * 2
    else:
        assert type(model.layers[0].attn).__name__ == (
            "MLAttention" if c.attn == "mla" else "GQAttention")
        assert type(model.layers[0].mlp).__name__ == ("MoE" if c.moe else "MLP")
    toks = torch.from_numpy(tokens(12, 2, 8, c.vocab))
    cache = init_cache(c, 2, 8, device=CPU)
    kw = {}
    if c.encoder is not None:
        frames = torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(1))
        kw["frames"] = frames
        cache["cross"] = init_cross_cache(c, model, encode(c, model, frames))
    logits = forward(c, model, toks, **kw)
    step, _ = decode_step(c, model, toks[:, :1], cache)
    assert logits.shape == (2, 8, 512) and step.shape == (2, 1, 512)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all())
    if field == "rope_enabled":  # no rotation: a decoder that sees no positions
        rotated = forward(cfg, model, toks)
        assert not torch.allclose(rotated, logits)
    check_ported(cfg)  # qwen2-vl-2b's own fields pass
    for arch in ARCH_IDS:  # and every arch's
        check_ported(get_config(arch))


@pytest.mark.parametrize("field,value", [
    ("attn", "none"),
    ("hybrid_attn_every", 2),
])
def test_ssm_stack_fields_without_an_ssm_config_raise(field, value, cfg):
    """``attn="none"`` (the pure-SSM stack) and ``hybrid_attn_every`` (the
    hybrid) need ``cfg.ssm``: without one, as the reference cannot run
    them either, every entry point that builds a model or a cache
    refuses."""
    c = dataclasses.replace(cfg, **{field: value})
    for build in (check_ported, lambda c: init_params(c, device=CPU),
                  lambda c: init_cache(c, 1, 8, device=CPU)):
        with pytest.raises(ValueError, match=f"{field}=.*needs an ssm config"):
            build(c)


def test_default_device_is_cuda(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
