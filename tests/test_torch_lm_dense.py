"""The port's dense decoders on the CPU — starcoder2-3b (sliding window,
LayerNorm, GELU, untied head), phi3-medium-14b (untied head),
gemma2-2b (local/global layers, softcaps, post norms, √d embedding
scale), stablelm-3b (LayerNorm, MHA, head_dim 80) — held against the JAX
reference on the same weights and inputs.

Configs: each arch's reduced config (2 layers, d_model 128, 4 heads,
head_dim 32, vocab 512, the window cut to 64) in float32.  Weights: the
reference's ``init_params`` carried into the port by
``convert.params_from_jax``.  Inputs: numpy, fixed seeds.  Tolerances as in
``tests/test_torch_lm.py``: 1e-5 × max|ref| (the sums run in another order
and sin/cos, exp and tanh come from other libraries), 2e-5 where the
reference's Pallas kernel runs in interpret mode, 2e-3 for decode against
prefill.  The sequences are 96 or more tokens long, so the reduced window
of 64 bites.
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
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import attention, common, mlp
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import DecoderLM, decode_step, forward, init_cache, init_params

CPU = torch.device("cpu")
RTOL = 1e-5
DENSE = ["starcoder2-3b", "phi3-medium-14b", "gemma2-2b", "stablelm-3b"]


def reduced(get, arch, **kw):
    return dataclasses.replace(get(arch).reduced(), **{"dtype": "float32", **kw})


_TREES: dict = {}


def jax_tree(arch):
    """The reference's reduced float32 weights of ``arch`` (seed 0), once."""
    if arch not in _TREES:
        _TREES[arch] = jax_model.init_params(reduced(jax_get_config, arch),
                                             jax.random.PRNGKey(0))
    return _TREES[arch]


def port_model(arch):
    return params_from_jax(reduced(get_config, arch),
                           jax.tree.map(np.asarray, jax_tree(arch)), device=CPU)


def close(out, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rtol * float(np.abs(ref).max()), rtol=0)


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch,params", [
    ("starcoder2-3b", 3_180_705_792),
    ("phi3-medium-14b", 14_659_507_200),
    ("gemma2-2b", 2_614_341_888),
    ("stablelm-3b", 2_796_098_560),
])
def test_full_width_parameter_count(arch, params):
    model = DecoderLM(get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == params
    assert hasattr(model, "lm_head") == (not get_config(arch).tie_embeddings)


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_gives_the_reference_shape_tree(arch):
    cfg = reduced(get_config, arch)
    port = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree(arch))[0]:
        name = ".".join(k.key for k in path)
        if name.startswith("layers."):
            for i in range(leaf.shape[0]):
                want[f"layers.{i}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    got = port.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    drawn = [k for k in got if k.split(".")[-1] in ("wq", "wk", "wv", "wo", "wi", "wg")]
    assert all(bool(got[k].abs().sum() > 0) for k in drawn + ["embed"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches(dtype):
    """float32 statistics, eps 1e-5, cast back: 1e-5 of max|out| in
    float32, one bf16 ulp (2⁻⁷ relative) in bfloat16."""
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 8, 64)) + 1).astype(np.float32)
    scale, bias = rng.standard_normal((2, 64)).astype(np.float32)
    norm = common.LayerNorm(64, dtype=getattr(torch, dtype), device=CPU)
    norm.scale.copy_(torch.from_numpy(scale))
    norm.bias.copy_(torch.from_numpy(bias))
    jp = {"scale": jnp.asarray(scale).astype(dtype), "bias": jnp.asarray(bias).astype(dtype)}
    ref = jax_common.layernorm(jp, jnp.asarray(x).astype(dtype))
    out = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    close(out, ref, rtol=RTOL if dtype == "float32" else 2.0**-7)


def test_make_norm_picks_by_kind():
    assert type(common.make_norm("rmsnorm", 8, dtype=torch.float32, device=CPU)) is \
        common.RMSNorm
    ln = common.make_norm("layernorm", 8, dtype=torch.float32, device=CPU)
    assert type(ln) is common.LayerNorm
    assert ln.scale.tolist() == [1.0] * 8 and ln.bias.tolist() == [0.0] * 8
    with pytest.raises(ValueError, match="batchnorm"):
        common.make_norm("batchnorm", 8, dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap_matches(cap):
    x = (40 * np.random.default_rng(3).standard_normal((4, 64))).astype(np.float32)
    ref = jax_common.softcap(jnp.asarray(x), cap)
    t = torch.from_numpy(x.copy())
    close(common.softcap(t, cap), ref)
    assert torch.equal(t, torch.from_numpy(x))  # the input is left as it was


@pytest.mark.parametrize("shape", [(2, 8), (3, 1)])  # prefill and decode rows
def test_gelu_mlp_matches(shape):
    """starcoder2's GELU MLP holds wi and wo only, and applies the tanh
    GELU that jax.nn.gelu takes by default: torch's erf GELU misses the
    bound."""
    cfg = reduced(get_config, "starcoder2-3b")
    jparams = jax_mlp.mlp_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    m = mlp.MLP(cfg, dtype=torch.float32, device=CPU)
    assert set(m.state_dict()) == set(jparams) == {"wi", "wo"}
    m.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in jparams.items()})
    x = np.random.default_rng(3).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    ref = np.asarray(jax_mlp.mlp_apply(jparams, cfg, jnp.asarray(x)))
    close(mlp.mlp_apply(m, torch.from_numpy(x)), ref)
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ m.wi) @ m.wo
    assert np.abs(erf.numpy() - ref).max() > RTOL * np.abs(ref).max()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_apply_window_matches_the_reference_kernel_route(use_kernel):
    """starcoder2's windowed attention (window 64) at S = 128: JAX through
    the Pallas flash kernel in interpret mode, the port through both of
    its routes, with plain RoPE positions (B, S)."""
    cfg = reduced(get_config, "starcoder2-3b")
    assert cfg.window == 64 and not cfg.mrope
    lp = jax.tree.map(lambda a: a[0], jax_tree("starcoder2-3b")["layers"]["attn"])
    port = attention.GQAttention(cfg, dtype=torch.float32, device=CPU)
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in lp.items()})
    s = 128
    x = np.random.default_rng(4).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = jax_model._positions(cfg, jnp.zeros((2, s), jnp.int32))
    assert pos.shape == (2, s)
    ref = jax_attention.gqa_apply(lp, cfg, jnp.asarray(x), pos, window=64, use_kernel=True,
                                  interpret=True)
    out = attention.gqa_apply(port, cfg, torch.from_numpy(x), torch.from_numpy(np.array(pos)),
                              window=64, use_kernel=use_kernel)
    close(out, ref, rtol=2e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_stablelm_attention_at_head_dim_80(use_kernel, causal):
    """stablelm-3b's head_dim 80 (MHA, 4 heads at d_model 128) against the
    reference's kernel route in interpret mode at S = 128."""
    cfg = reduced(get_config, "stablelm-3b", head_dim=80)
    jcfg = reduced(jax_get_config, "stablelm-3b", head_dim=80)
    lp = jax_attention.gqa_init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    port = attention.GQAttention(cfg, dtype=torch.float32, device=CPU)
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in lp.items()})
    assert port.wq.shape == (128, 4, 80) and port.wk.shape == (128, 4, 80)
    s = 128
    x = np.random.default_rng(5).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = jax_model._positions(jcfg, jnp.zeros((2, s), jnp.int32))
    ref = jax_attention.gqa_apply(lp, jcfg, jnp.asarray(x), pos, causal=causal,
                                  use_kernel=True, interpret=True)
    out = attention.gqa_apply(port, cfg, torch.from_numpy(x), torch.from_numpy(np.array(pos)),
                              causal=causal, use_kernel=use_kernel)
    close(out, ref, rtol=2e-5)


@pytest.mark.parametrize("cap,window", [(50.0, 40), (50.0, None), (None, 40)])
@pytest.mark.parametrize("s", [48, 96])
def test_plain_route_softcap_window_chunks_match_the_reference(cap, window, s, monkeypatch):
    """The plain route with gemma2's score softcap and a window, cut to
    16-row q-chunks from 64 rows on in both packages (96 rows chunked, 48
    in one piece), against the reference's ``_softcap_attention``."""
    for mod in (attention, jax_attention):
        monkeypatch.setattr(mod, "CHUNK_Q_THRESHOLD", 64)
        monkeypatch.setattr(mod, "CHUNK_Q", 16)
    jcfg = reduced(jax_get_config, "gemma2-2b", attn_softcap=cap)
    rng = np.random.default_rng(6)
    q, k, v = (4 * rng.standard_normal((2, h, s, 32)).astype(np.float32) for h in (4, 2, 2))
    ref = jax_attention._softcap_attention(jcfg, *map(jnp.asarray, (q, k, v)), 32**-0.5,
                                           True, window)
    out = attention._plain_attention(*map(torch.from_numpy, (q, k, v)), 32**-0.5, True,
                                     window, cap)
    close(out, ref)


@pytest.mark.parametrize("use_flash_kernel", [True, False])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches(arch, use_flash_kernel):
    """Against the reference's plain route, at S = 96: the window of 64
    bites in starcoder2's layers and gemma2's local layer."""
    cfg = reduced(get_config, arch)
    toks = tokens(7, 2, 96)
    ref = jax_model.forward(reduced(jax_get_config, arch), jax_tree(arch), jnp.asarray(toks),
                            use_flash_kernel=False, remat=False)
    out = forward(cfg, port_model(arch), torch.from_numpy(toks),
                  use_flash_kernel=use_flash_kernel)
    assert out.dtype == torch.float32 and out.shape == (2, 96, 512)
    close(out, ref)
    if cfg.logit_softcap is not None:
        assert float(out.abs().max()) < cfg.logit_softcap


def test_window_changes_what_starcoder2_computes():
    """The cases above would pass with no window at all if it never bit:
    at S = 96 the windowed forward differs from a full-attention one."""
    cfg = reduced(get_config, "starcoder2-3b")
    model = port_model("starcoder2-3b")
    toks = torch.from_numpy(tokens(7, 2, 96))
    full = forward(dataclasses.replace(cfg, attn="full", window=None), model, toks)
    out = forward(cfg, model, toks)
    assert torch.equal(out[:, :64], full[:, :64])
    assert float((out[:, 64:] - full[:, 64:]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", DENSE)
def test_forward_in_bfloat16_tracks_the_reference(arch):
    """bf16 weights from the same tree: within 4 bf16 ulps of max|logits|
    (4·2⁻⁷ relative) of the reference's bf16 forward, and the port's mean
    |Δ| to the float32 forward on the same rounded weights at most 1.25×
    the reference's (as for qwen2-vl-2b in tests/test_torch_lm.py)."""
    c = reduced(get_config, arch, dtype="bfloat16")
    jc = reduced(jax_get_config, arch, dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_tree(arch))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    toks = tokens(8, 2, 96)
    ref = np.asarray(jax_model.forward(jc, jp, jnp.asarray(toks), use_flash_kernel=False,
                                       remat=False))
    out = forward(c, params_from_jax(c, tree, device=CPU), torch.from_numpy(toks)).numpy()
    c32 = reduced(get_config, arch)
    f32 = forward(c32, params_from_jax(c32, tree, device=CPU), torch.from_numpy(toks)).numpy()
    assert np.abs(out - ref).max() <= 4 * 2.0**-7 * np.abs(ref).max()
    assert np.abs(out - f32).mean() <= 1.25 * np.abs(ref - f32).mean()


@pytest.mark.parametrize("arch,steps", [
    ("starcoder2-3b", 80),  # more steps than its 64-slot ring: the ring wraps
    ("gemma2-2b", 80),      # the local layer's window of 64 bites, the global one's not
    ("phi3-medium-14b", 12),
    ("stablelm-3b", 12),
])
def test_decode_step_matches(arch, steps):
    cfg = reduced(get_config, arch)
    jcfg = reduced(jax_get_config, arch)
    params, b, max_len = port_model(arch), 2, 100
    toks = tokens(9, b, steps)
    jcache = jax_model.init_cache(jcfg, b, max_len)
    cache = init_cache(cfg, b, max_len, device=CPU)
    slots = 64 if arch == "starcoder2-3b" else max_len
    assert cache["layers"][0]["k"].shape == (b, cfg.n_kv_heads, slots, 32)
    assert jcache["layers"]["k"].shape[3] == slots
    step = jax.jit(lambda p, x, c: jax_model.decode_step(jcfg, p, x, c))
    for t in range(steps):
        ref, jcache = step(jax_tree(arch), jnp.asarray(toks[:, t:t + 1]), jcache)
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, t:t + 1]), cache)
        close(out, ref)
    for i, lc in enumerate(cache["layers"]):
        for key in ("k", "v"):
            close(lc[key], jcache["layers"][key][i])
        assert lc["pos"].tolist() == [steps] * b


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Teacher-forcing 80 tokens through decode_step reproduces forward's
    logits at the reference test's 2e-3: starcoder2's ring of 64 slots
    wraps and keeps exactly the window; gemma2's global layer sees all."""
    cfg = reduced(get_config, arch)
    params = port_model(arch)
    b, s = 2, 80
    toks = torch.from_numpy(tokens(10, b, s))
    full = forward(cfg, params, toks)
    cache = init_cache(cfg, b, s, device=CPU)
    outs = []
    for t in range(s):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch,change,match", [
    ("starcoder2-3b", ("drop", "lm_head"), "Missing key"),          # untied head
    ("starcoder2-3b", ("drop", "ln_f.bias"), "Missing key"),        # LayerNorm
    ("starcoder2-3b", ("add", "layers.mlp.wg"), "Unexpected key"),  # GELU: no wg
    ("stablelm-3b", ("drop", "layers.ln_attn.bias"), "Missing key"),
    ("gemma2-2b", ("drop", "layers.ln_mlp_post.scale"), "Missing key"),  # post norms
    ("gemma2-2b", ("add", "lm_head"), "Unexpected key"),            # tied
    ("phi3-medium-14b", ("add", "layers.ln_attn_post.scale"), "Unexpected key"),
])
def test_params_from_jax_refuses_a_missing_or_extra_leaf(arch, change, match):
    tree = jax.tree.map(np.asarray, jax_tree(arch))
    params_from_jax(reduced(get_config, arch), tree, device=CPU)  # as it is: loads
    what, name = change
    *parents, leaf = name.split(".")
    node = tree
    for key in parents:
        node = node.setdefault(key, {})
    if what == "drop":
        del node[leaf]
    else:
        node[leaf] = np.zeros((2, 4) if parents else (4,), np.float32)
    with pytest.raises(RuntimeError, match=match):
        params_from_jax(reduced(get_config, arch), tree, device=CPU)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_runs_each_dense_arch_on_cpu(arch):
    rep = serve.run(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert rep["arch"] == arch and rep["preset"] == "tiny"
    assert rep["finished"] == rep["requests"] == 3 and rep["tokens"] == 12
