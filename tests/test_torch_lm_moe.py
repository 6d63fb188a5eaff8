"""The port's MoE decoders on the CPU — mixtral-8x22b (8 experts, top 2,
sliding window) and deepseek-v2-236b (MLA, 160 experts top 6 plus 2
shared) — held against the JAX reference on the same weights and inputs.

Configs: each arch's reduced config (2 layers, d_model 128, 4 heads,
vocab 512; MoE 4 experts, top 2, d_ff_expert 64, deepseek 1 shared
expert; deepseek's MLA ranks 64 / 32, nope 32, rope 16, v 32; mixtral's
window cut to 64) in float32.  Weights: the reference's ``init_params``
carried into the port by ``convert.params_from_jax``.  Inputs: numpy,
fixed seeds.  Tolerances as in ``tests/test_torch_lm.py``: 1e-5 ×
max|ref| in float32 (the sums run in another order and exp, sin and cos
come from other libraries), 2e-5 where the reference's Pallas kernel runs
in interpret mode, 2e-3 for decode against prefill (the reference test's);
bfloat16 modules within 4 bf16 ulps (4·2⁻⁷) of max|ref|.

The sparse dispatch drops pairs past an expert's capacity: the tests hold
the port's kept (token, expert) pairs to the reference's pair for pair,
and decode at b = 2 (where the capacity is 1 slot an expert) to the
reference's own decode, drops and all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import mlp as jax_mlp
from repro.models import model as jax_model
from repro.serving import engine as jax_engine
from repro_torch.configs import MoEConfig, get_config
from repro_torch.launch import serve
from repro_torch.models import attention, mlp
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import DecoderLM, decode_step, forward, init_cache, init_params
from repro_torch.serving import Request, ServingEngine

CPU = torch.device("cpu")
RTOL = 1e-5
BF16_ULPS = 4 * 2.0**-7
MOE = ["mixtral-8x22b", "deepseek-v2-236b"]


def reduced(get, arch, **kw):
    return dataclasses.replace(get(arch).reduced(), **{"dtype": "float32", **kw})


_TREES: dict = {}


def jax_tree(arch):
    """The reference's reduced float32 weights of ``arch`` (seed 0), once."""
    if arch not in _TREES:
        _TREES[arch] = jax_model.init_params(reduced(jax_get_config, arch),
                                             jax.random.PRNGKey(0))
    return _TREES[arch]


def port_model(arch, **kw):
    return params_from_jax(reduced(get_config, arch, **kw),
                           jax.tree.map(np.asarray, jax_tree(arch)), device=CPU)


def close(out, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rtol * float(np.abs(ref).max()), rtol=0)


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def layer0(arch, part):
    """Layer 0's ``part`` ("mlp" or "attn") of the reference tree."""
    return jax.tree.map(lambda a: a[0], jax_tree(arch)["layers"][part])


def moe_module(cfg, tree, dtype=torch.float32):
    """The port's MoE holding the reference subtree ``tree`` (experts'
    axis moved to the front)."""
    m = mlp.MoE(cfg, dtype=dtype, device=CPU)
    state = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(k.key for k in path)
        arr = torch.tensor(np.asarray(leaf, np.float32))
        state[name] = arr.transpose(0, 1) if name in ("wi", "wg", "wo") else arr
    m.load_state_dict(state, strict=True)
    return m


def activations(seed, shape, d=128):
    return np.random.default_rng(seed).standard_normal((*shape, d)).astype(np.float32)


def reference_kept_pairs(tree, cfg, x, capacity_factor):
    """The reference's kept (token, expert) pairs of its sparse dispatch on
    ``x``, by the lines of ``repro.models.mlp.moe_apply_sparse``."""
    m = cfg.moe
    xf = jnp.asarray(x).reshape(-1, cfg.d_model)
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), tree["router"])
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    n_tok = xf.shape[0]
    cap = max(1, int(capacity_factor * n_tok * m.top_k / m.n_experts))
    flat_e = topi.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(n_tok), m.top_k)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    pos = jnp.arange(n_tok * m.top_k) - jnp.searchsorted(e_sorted, e_sorted, side="left")
    keep = np.asarray(pos < cap)
    pairs = zip(np.asarray(flat_t[order])[keep], np.asarray(e_sorted)[keep])
    return {(int(t), int(e)) for t, e in pairs}, int((~keep).sum())


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,params,per_layer", [
    ("mixtral-8x22b", 140_630_071_296, 2_504_060_928),
    ("deepseek-v2-236b", 239_375_569_920, 3_972_116_480),
])
def test_full_width_parameter_count(arch, params, per_layer):
    model = DecoderLM(get_config(arch), device="meta")
    assert sum(p.numel() for p in model.parameters()) == params
    assert sum(p.numel() for p in model.layers[0].parameters()) == per_layer
    assert model.layers[0].mlp.router.dtype == torch.float32
    assert model.layers[0].mlp.wi.dtype == model.embed.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", MOE)
def test_init_params_gives_the_reference_tree_with_the_experts_axis_first(arch):
    cfg = reduced(get_config, arch)
    port = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree(arch))[0]:
        name = ".".join(k.key for k in path)
        shape = tuple(leaf.shape)
        if name.startswith("layers."):
            rest = name[7:]
            if rest in ("mlp.wi", "mlp.wg", "mlp.wo"):
                shape = (shape[0], shape[2], shape[1], shape[3])
            for i in range(shape[0]):
                want[f"layers.{i}.{rest}"] = shape[1:]
        else:
            want[name] = shape
    got = port.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(bool(v.abs().sum() > 0) for k, v in got.items() if not k.endswith("scale"))
    assert ("layers.0.mlp.shared.wi" in got) == (arch == "deepseek-v2-236b")
    assert ("layers.0.attn.wuk" in got) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", MOE)
def test_router_stays_float32_in_a_bfloat16_model(arch):
    """Through init_params, params_from_jax (a bf16 tree, whose router the
    reference keeps in float32), a state-dict copy and
    ``chip_smoke.first_layers``: every router float32, every other
    parameter bf16, and the router's values the reference's bit for bit."""
    cfg = reduced(get_config, arch, dtype="bfloat16")
    jcfg = reduced(jax_get_config, arch, dtype="bfloat16")
    jp = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    assert jp["layers"]["mlp"]["router"].dtype == jnp.float32
    built = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    loaded = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    copied = DecoderLM(cfg, device=CPU)
    copied.load_state_dict(loaded.state_dict())
    _, first = chip_smoke.first_layers(cfg, loaded, 1)
    for model in (built, loaded, copied, first):
        for name, t in model.state_dict().items():
            want = torch.float32 if name.endswith("mlp.router") else torch.bfloat16
            assert t.dtype == want, name
    for i in range(cfg.n_layers):
        assert np.array_equal(loaded.layers[i].mlp.router.numpy(),
                              np.asarray(jp["layers"]["mlp"]["router"][i]))
    assert first.layers[0].mlp.router.data_ptr() == loaded.layers[0].mlp.router.data_ptr()


@pytest.mark.parametrize("arch,change,match", [
    ("mixtral-8x22b", ("drop", "layers.mlp.router"), "Missing key"),
    ("mixtral-8x22b", ("add", "layers.mlp.shared"), "Unexpected key"),  # no shared experts
    ("deepseek-v2-236b", ("drop", "layers.mlp.shared.wg"), "Missing key"),
    ("deepseek-v2-236b", ("drop", "layers.attn.kv_norm.scale"), "Missing key"),
    ("deepseek-v2-236b", ("add", "layers.attn.wq"), "Unexpected key"),  # MLA, not GQA
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
        node[leaf] = np.zeros((2, 4), np.float32)
    with pytest.raises(RuntimeError, match=match):
        params_from_jax(reduced(get_config, arch), tree, device=CPU)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches(arch):
    """The dense dispatch (deepseek's with its shared expert) on (2, 16)
    tokens."""
    cfg = reduced(get_config, arch)
    tree = layer0(arch, "mlp")
    x = activations(1, (2, 16))
    ref = jax_mlp.moe_apply(tree, reduced(jax_get_config, arch), jnp.asarray(x))
    close(mlp.moe_apply(moe_module(cfg, tree), cfg, torch.from_numpy(x)), ref)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_sparse_keeps_the_references_pairs(arch, capacity_factor):
    """At the default capacity and at a binding one (0.5: 16 slots an
    expert, where the 64 tokens' 128 pairs come to 32 an expert on
    average), the kept (token, expert) pairs are the reference's pair for
    pair, and the outputs agree."""
    cfg = reduced(get_config, arch)
    jcfg = reduced(jax_get_config, arch)
    tree = layer0(arch, "mlp")
    port = moe_module(cfg, tree)
    x = activations(2, (2, 32))
    want, dropped = reference_kept_pairs(tree, jcfg, x, capacity_factor)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, topi = mlp.moe_route(port, xf, cfg.moe.top_k)
    cap = mlp.expert_capacity(64, cfg, capacity_factor)
    assert cap == max(1, int(capacity_factor * 64 * 2 / 4))
    order, e_sorted, _, keep = mlp.dispatch_slots(topi, cap)
    got = {(int(i) // 2, int(e)) for i, e in zip(order[keep], e_sorted[keep])}
    assert got == want and int((~keep).sum()) == dropped
    if capacity_factor == 0.5:
        assert dropped >= 128 - 4 * cap  # the capacity binds
    ref = jax_mlp.moe_apply_sparse(tree, jcfg, jnp.asarray(x), capacity_factor=capacity_factor)
    close(mlp.moe_apply_sparse(port, cfg, torch.from_numpy(x),
                               capacity_factor=capacity_factor), ref)


def test_dispatch_slots_on_ties_is_the_references_stable_order():
    """Every expert's run in (token, k) order, slots counted from 0, on a
    routing with many pairs an expert (the reference's argsort, stable,
    and searchsorted on the same ``topi``)."""
    topi = np.random.default_rng(3).integers(0, 5, (40, 3))
    for cap in (1, 4, 30):
        order, e_sorted, slot, keep = mlp.dispatch_slots(torch.from_numpy(topi), cap)
        flat = jnp.asarray(topi.reshape(-1))
        r_order = jnp.argsort(flat, stable=True)
        r_e = flat[r_order]
        r_slot = jnp.arange(flat.size) - jnp.searchsorted(r_e, r_e, side="left")
        assert order.tolist() == np.asarray(r_order).tolist()
        assert e_sorted.tolist() == np.asarray(r_e).tolist()
        assert slot.tolist() == np.asarray(r_slot).tolist()
        assert keep.tolist() == (np.asarray(r_slot) < cap).tolist()


@pytest.mark.parametrize("arch", MOE)
def test_sparse_matches_dense_with_ample_capacity(arch):
    """The port's copy of the reference's
    ``tests/test_components.py::test_moe_sparse_matches_dense_with_ample_capacity``:
    at capacity_factor E/K every expert has a slot for every token, so
    nothing drops and the two dispatches agree (and each the reference's
    dense dispatch)."""
    cfg = reduced(get_config, arch)
    tree = layer0(arch, "mlp")
    port = moe_module(cfg, tree)
    x = torch.from_numpy(activations(3, (2, 16)))
    e_over_k = cfg.moe.n_experts / cfg.moe.top_k
    assert mlp.expert_capacity(32, cfg, e_over_k) == 32
    sparse = mlp.moe_apply_sparse(port, cfg, x, capacity_factor=e_over_k)
    dense = mlp.moe_apply(port, cfg, x)
    ref = jax_mlp.moe_apply(tree, reduced(jax_get_config, arch), jnp.asarray(x.numpy()))
    close(sparse, np.asarray(dense))
    close(sparse, ref)


@pytest.mark.parametrize("n_shared", [1, 2])
def test_shared_experts_add_an_mlp_of_their_width(n_shared):
    """deepseek-v2's shared experts: one SwiGLU MLP of d_ff fe·n_shared
    (``shared.{wi,wg,wo}``) on every token, added to the routed experts'
    sum; against the reference at 1 and 2 shared experts."""
    moe = MoEConfig(4, 2, 64, n_shared)
    cfg = reduced(get_config, "deepseek-v2-236b", moe=moe)
    jcfg = reduced(jax_get_config, "deepseek-v2-236b", moe=moe)
    tree = jax_mlp.moe_init(jax.random.PRNGKey(4), jcfg, jnp.float32)
    port = moe_module(cfg, tree)
    assert port.shared.wi.shape == port.shared.wg.shape == (128, 64 * n_shared)
    assert port.shared.wo.shape == (64 * n_shared, 128)
    x = torch.from_numpy(activations(4, (1, 24)))
    for dispatch in ("moe_apply", "moe_apply_sparse"):
        ref = getattr(jax_mlp, dispatch)(tree, jcfg, jnp.asarray(x.numpy()))
        out = getattr(mlp, dispatch)(port, cfg, x)
        close(out, ref)
        routed = getattr(mlp, dispatch)(port, dataclasses.replace(cfg, moe=MoEConfig(4, 2, 64)),
                                        x)
        close(out - routed, np.asarray(mlp.mlp_apply(port.shared, x)))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dispatch", ["moe_apply", "moe_apply_sparse"])
def test_moe_in_bfloat16_tracks_the_reference(arch, dispatch):
    """bf16 experts, float32 router, the same bf16 input: within 4 bf16
    ulps of max|ref| of the reference's bf16 MoE."""
    cfg = reduced(get_config, arch, dtype="bfloat16")
    jcfg = reduced(jax_get_config, arch, dtype="bfloat16")
    tree = {k: v if k == "router" else jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
            for k, v in layer0(arch, "mlp").items()}
    assert tree["router"].dtype == jnp.float32 and tree["wi"].dtype == jnp.bfloat16
    port = moe_module(cfg, tree, dtype=torch.bfloat16)
    assert port.router.dtype == torch.float32
    x = jnp.asarray(activations(5, (2, 16))).astype(jnp.bfloat16)
    ref = getattr(jax_mlp, dispatch)(tree, jcfg, x)
    out = getattr(mlp, dispatch)(port, cfg, torch.from_numpy(np.asarray(x, np.float32))
                                 .to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    close(out, ref, rtol=BF16_ULPS)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def mla_module(cfg, tree):
    m = attention.MLAttention(cfg, dtype=torch.float32, device=CPU)
    state = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        state[".".join(k.key for k in path)] = torch.tensor(np.asarray(leaf))
    m.load_state_dict(state, strict=True)
    return m


@pytest.mark.parametrize("s", [96, 4096])
def test_mla_apply_matches(s):
    """MLA prefill at s 96 and at s 4096, where both packages q-chunk the
    scores in 1,024-row chunks (narrow width: 4 heads, q/k 48, v 32)."""
    cfg = reduced(get_config, "deepseek-v2-236b")
    jcfg = reduced(jax_get_config, "deepseek-v2-236b")
    tree = layer0("deepseek-v2-236b", "attn")
    b = 2 if s == 96 else 1
    x = activations(6, (b, s))
    pos = jax_model._positions(jcfg, jnp.zeros((b, s), jnp.int32))
    assert pos.shape == (b, s)
    assert (s >= attention.CHUNK_Q_THRESHOLD) == (s == 4096)
    ref = jax_attention.mla_apply(tree, jcfg, jnp.asarray(x), pos)
    out = attention.mla_apply(mla_module(cfg, tree), cfg, torch.from_numpy(x),
                              torch.from_numpy(np.array(pos)))
    close(out, ref)


def test_mla_decode_matches():
    """12 decode steps at b 2 against the reference's ``mla_decode``: the
    output and the compressed cache (``ckv``, ``kr``) each step."""
    cfg = reduced(get_config, "deepseek-v2-236b")
    jcfg = reduced(jax_get_config, "deepseek-v2-236b")
    tree = layer0("deepseek-v2-236b", "attn")
    port = mla_module(cfg, tree)
    jcache = jax_attention.mla_init_cache(jcfg, 2, 16, jnp.float32)
    cache = attention.mla_init_cache(cfg, 2, 16, torch.float32, CPU)
    assert cache["ckv"].shape == (2, 16, 32) and cache["kr"].shape == (2, 16, 16)
    xs = activations(7, (2, 12))
    step = jax.jit(lambda x, c: jax_attention.mla_decode(tree, jcfg, x, c))
    for t in range(12):
        ref, jcache = step(jnp.asarray(xs[:, t:t + 1]), jcache)
        out, cache = attention.mla_decode(port, cfg, torch.from_numpy(xs[:, t:t + 1]), cache)
        close(out, ref)
        close(cache["ckv"], jcache["ckv"])
        close(cache["kr"], jcache["kr"])
    assert cache["pos"].tolist() == [12, 12]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mixtral_attention_matches_the_reference_kernel_route(use_kernel):
    """mixtral's windowed GQA (window 64) at S = 128: the reference through
    its Pallas flash kernel in interpret mode, the port through both of its
    routes."""
    cfg = reduced(get_config, "mixtral-8x22b")
    jcfg = reduced(jax_get_config, "mixtral-8x22b")
    assert cfg.attn == "swa" and cfg.window == 64
    tree = layer0("mixtral-8x22b", "attn")
    port = attention.GQAttention(cfg, dtype=torch.float32, device=CPU)
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in tree.items()})
    x = activations(8, (2, 128))
    pos = jax_model._positions(jcfg, jnp.zeros((2, 128), jnp.int32))
    ref = jax_attention.gqa_apply(tree, jcfg, jnp.asarray(x), pos, window=64, use_kernel=True,
                                  interpret=True)
    out = attention.gqa_apply(port, cfg, torch.from_numpy(x), torch.from_numpy(np.array(pos)),
                              window=64, use_kernel=use_kernel)
    close(out, ref, rtol=2e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moe_dispatch", ["sparse", "dense"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches(arch, moe_dispatch):
    """Against the reference's plain route at S = 96 (mixtral's window of
    64 bites; the sparse dispatch's capacity is 120 slots for 192 tokens'
    384 pairs)."""
    cfg = reduced(get_config, arch)
    toks = tokens(9, 2, 96)
    ref = jax_model.forward(reduced(jax_get_config, arch), jax_tree(arch), jnp.asarray(toks),
                            moe_dispatch=moe_dispatch, use_flash_kernel=False, remat=False)
    out = forward(cfg, port_model(arch), torch.from_numpy(toks), moe_dispatch=moe_dispatch)
    assert out.dtype == torch.float32 and out.shape == (2, 96, 512)
    close(out, ref)


def test_forward_refuses_an_unknown_dispatch():
    cfg = reduced(get_config, "mixtral-8x22b")
    with pytest.raises(ValueError, match="moe_dispatch"):
        forward(cfg, port_model("mixtral-8x22b"), torch.zeros((1, 4), dtype=torch.int32),
                moe_dispatch="gathered")


@pytest.mark.parametrize("arch", MOE)
def test_decode_at_b1_matches_dense_prefill(arch):
    """Teacher-forcing 24 tokens at b 1, where the sparse dispatch drops
    nothing (topk gives K distinct experts), reproduces forward's logits
    under the dense dispatch at the reference test's 2e-3 (the reference's
    ``tests/test_models_smoke.py::test_decode_matches_forward``)."""
    cfg = reduced(get_config, arch)
    params = port_model(arch)
    toks = torch.from_numpy(tokens(10, 1, 24))
    full = forward(cfg, params, toks, moe_dispatch="dense")
    cache = init_cache(cfg, 1, 24, device=CPU)
    outs = []
    for t in range(24):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", MOE)
def test_decode_at_b2_matches_the_reference_with_its_drops(arch):
    """At b 2 an expert takes one slot a step, so a pair whose expert the
    other row took first is dropped: 16 steps against the reference's own
    decode (logits and caches), which drops the same pairs; the drops bite
    (the logits leave the dense prefill's)."""
    cfg = reduced(get_config, arch)
    jcfg = reduced(jax_get_config, arch)
    assert mlp.expert_capacity(2, cfg, 1.25) == 1
    params, b, steps = port_model(arch), 2, 16
    toks = tokens(11, b, steps)
    jcache = jax_model.init_cache(jcfg, b, steps)
    cache = init_cache(cfg, b, steps, device=CPU)
    step = jax.jit(lambda p, x, c: jax_model.decode_step(jcfg, p, x, c))
    outs = []
    for t in range(steps):
        ref, jcache = step(jax_tree(arch), jnp.asarray(toks[:, t:t + 1]), jcache)
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, t:t + 1]), cache)
        close(out, ref)
        outs.append(out[:, 0])
    keys = ("ckv", "kr") if cfg.attn == "mla" else ("k", "v")
    for i, lc in enumerate(cache["layers"]):
        for key in keys:
            close(lc[key], jcache["layers"][key][i])
    full = forward(cfg, params, torch.from_numpy(toks), moe_dispatch="dense")
    assert float((torch.stack(outs, dim=1) - full).abs().max()) > 2e-2


class Recorder:
    """Wraps an engine's step function and keeps every call's logits."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, params, tokens, cache):
        logits, cache = self.step(params, tokens, cache)
        self.logits.append(np.array(logits, dtype=np.float32))
        return logits, cache


def drive(eng, pending, n):
    """The serve launcher's loop; returns the number of step() calls."""
    done = steps = 0
    while done < n:
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
        steps += 1
        done = n - len(pending) - sum(r is not None for r in eng.requests)
    return steps


@pytest.mark.parametrize("slots", [4, 1])
@pytest.mark.parametrize("arch", MOE)
def test_engine_emits_the_reference_tokens(arch, slots):
    """The launcher's 6 requests through both engines on the same weights:
    every decode call's logits within 1e-5 × max|logits| and the same
    tokens, at 4 slots (the other slots' tokens take capacity: the
    reference's semantics) and at 1; every emitted token won by more than
    twice that tolerance on the reference's logits."""
    cfg = reduced(get_config, arch)
    jcfg = reduced(jax_get_config, arch)
    n, max_new = 6, 8
    jreqs = serve.draw_requests(n, cfg.vocab, max_new)
    reqs = serve.draw_requests(n, cfg.vocab, max_new)
    jreqs = [jax_engine.Request(rid=r.rid, prompt=r.prompt, max_new=max_new) for r in jreqs]
    jeng = jax_engine.ServingEngine(jcfg, jax_tree(arch), batch_slots=slots, max_len=128,
                                    eos=-1)
    eng = ServingEngine(cfg, port_model(arch), batch_slots=slots, max_len=128, eos=-1)
    jeng._step, eng._step = Recorder(jeng._step), Recorder(eng._step)
    assert drive(eng, list(reqs), n) == drive(jeng, list(jreqs), n)
    assert len(eng._step.logits) == len(jeng._step.logits)
    for out, ref in zip(eng._step.logits, jeng._step.logits):
        np.testing.assert_allclose(out, ref, atol=RTOL * np.abs(ref).max(), rtol=0)
    assert all(isinstance(r, Request) and r.done and len(r.out) == max_new for r in reqs)
    for jr, r in zip(jreqs, reqs):
        assert r.out == jr.out, f"request {r.rid}"
    gaps = [np.diff(np.sort(lg[..., :cfg.vocab], axis=-1)[..., -2:], axis=-1).min()
            / np.abs(lg).max() for lg in jeng._step.logits]
    assert min(gaps) > 2 * RTOL


@pytest.mark.parametrize("arch", MOE)
def test_serve_runs_each_moe_arch_on_cpu(arch):
    rep = serve.run(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert rep["arch"] == arch and rep["preset"] == "tiny"
    assert rep["finished"] == rep["requests"] == 3 and rep["tokens"] == 12
