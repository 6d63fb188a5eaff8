"""The port's SSM and hybrid decoders on the CPU — falcon-mamba-7b (a pure
Mamba-1 stack) and zamba2-2.7b (Mamba-2 layers in groups, one shared
attention block after each group) — held against the JAX reference on the
same weights and inputs.

Configs: each arch's reduced config (d_model 128, vocab 512; SSM state 16,
conv 4, expand 2, Mamba-2 head dim 32, dt rank 8; falcon-mamba-7b 2
layers, zamba2-2.7b 4 layers in 2 groups with 4 heads of 32 in the shared
block) in float32.  Weights: the reference's ``init_params`` carried into
the port by ``convert.params_from_jax``.  Inputs: numpy, fixed seeds.
Tolerances: 1e-5 × max|ref| in float32 (the port's scans sum in another
order than the reference's ``lax.scan``: Mamba-1 in chunks of fused steps,
Mamba-2 in the chunked SSD form; exp and the products come from other
libraries), 2e-5 where the reference's Pallas kernel runs in interpret
mode, 2e-3 for decode against prefill (the reference test's); bfloat16
modules within 4 bf16 ulps (4·2⁻⁷) of max|ref|, which holds the
reference's rounding points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import launch_counts
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import DecoderLM, decode_step, forward, init_cache, init_params
from repro_torch.serving import ServingEngine

CPU = torch.device("cpu")
RTOL = 1e-5
BF16_ULPS = 4 * 2.0**-7
SSM = ["falcon-mamba-7b", "zamba2-2.7b"]
VARIANT = {"falcon-mamba-7b": "mamba1", "zamba2-2.7b": "mamba2"}
# the leaves the reference keeps in float32 in a bf16 model
F32_LEAVES = {"mamba1": {"A_log", "D"}, "mamba2": {"A_log", "D", "dt_bias"}}


def reduced(get, arch, **kw):
    return dataclasses.replace(get(arch).reduced(), **{"dtype": "float32", **kw})


_TREES: dict = {}


def jax_tree(arch, dtype="float32"):
    """The reference's reduced weights of ``arch`` in ``dtype`` (seed 0), once."""
    if (arch, dtype) not in _TREES:
        _TREES[arch, dtype] = jax_model.init_params(reduced(jax_get_config, arch, dtype=dtype),
                                                    jax.random.PRNGKey(0))
    return _TREES[arch, dtype]


def port_model(arch, dtype="float32"):
    return params_from_jax(reduced(get_config, arch, dtype=dtype),
                           jax.tree.map(np.asarray, jax_tree(arch, dtype)), device=CPU)


def close(out, ref, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rtol * float(np.abs(ref).max()), rtol=0)


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def activations(seed, shape, d=128):
    return np.random.default_rng(seed).standard_normal((*shape, d)).astype(np.float32)


def layer0_ssm(arch, dtype="float32"):
    """The first SSM layer's ``ssm`` subtree of the reference tree (a
    hybrid's layers are stacked (n_groups, g, …))."""
    first = (0, 0) if arch == "zamba2-2.7b" else (0,)
    return jax.tree.map(lambda a: a[first], jax_tree(arch, dtype)["layers"]["ssm"])


def ssm_module(arch, dtype="float32"):
    cfg = reduced(get_config, arch, dtype=dtype)
    cls = ssm.Mamba1 if VARIANT[arch] == "mamba1" else ssm.Mamba2
    m = cls(cfg, dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32, device=CPU)
    m.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                       for k, v in layer0_ssm(arch, dtype).items()}, strict=True)
    return cfg, m


def port_input(x):
    """A reference input (float32 or bf16 jax array) as a torch tensor of
    the same dtype and values."""
    t = torch.tensor(np.asarray(x, np.float32))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SSM)
def test_config_and_reduced_config_are_the_references(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    small = get_config(arch).reduced()
    assert dataclasses.asdict(small) == dataclasses.asdict(jax_get_config(arch).reduced())
    assert (small.ssm.state, small.ssm.conv, small.ssm.expand, small.ssm.headdim,
            small.ssm.dt_rank) == (16, 4, 2, 32, 8)
    assert (small.n_layers, small.hybrid_attn_every) == (
        (4, 2) if arch == "zamba2-2.7b" else (2, 0))


@pytest.mark.parametrize("arch,params,per_layer", [
    ("falcon-mamba-7b", 7_272_665_088, 105_312_256),
    ("zamba2-2.7b", 2_422_670_240, 39_888_240),
])
def test_full_width_parameter_count_is_the_references(arch, params, per_layer):
    """On the meta device, against the reference's tree under
    ``jax.eval_shape``: the whole model and one SSM layer."""
    model = DecoderLM(get_config(arch), device="meta")
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax_get_config(arch),
                                                          jax.random.PRNGKey(0)))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want == params
    assert sum(p.numel() for p in model.layers[0].parameters()) == per_layer
    n = 54 if arch == "zamba2-2.7b" else 64
    assert len(model.layers) == n and hasattr(model, "shared_attn") == (arch == "zamba2-2.7b")


def reference_shapes(arch, tree):
    """The reference tree's leaves as the port's state-dict names and
    shapes, a hybrid's (n_groups, g) layer axes flattened."""
    lead = 2 if arch == "zamba2-2.7b" else 1
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(k.key for k in path)
        shape = tuple(leaf.shape)
        if name.startswith("layers."):
            for i in range(int(np.prod(shape[:lead]))):
                want[f"layers.{i}.{name[7:]}"] = (shape[lead:], leaf.dtype)
        else:
            want[name] = (shape, leaf.dtype)
    return want


@pytest.mark.parametrize("arch", SSM)
def test_init_params_gives_the_reference_tree(arch):
    cfg = reduced(get_config, arch)
    port = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    want = {k: shape for k, (shape, _) in reference_shapes(arch, jax_tree(arch)).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert all(bool(v.abs().sum() > 0) for k, v in port.state_dict().items()
               if not k.endswith(("scale", "conv_b", "A_log")))
    # the reference's constants
    m = port.layers[1].ssm
    assert bool((m.conv_w == 0.25).all()) and bool((m.conv_b == 0).all())
    assert bool((m.D == 1).all()) and bool((m.dt_bias == 0.5).all())
    ref_a_log = np.asarray(layer0_ssm(arch)["A_log"])
    np.testing.assert_allclose(m.A_log.numpy(), ref_a_log, rtol=1e-7, atol=0)
    assert ("shared_attn.attn.wq" in got) == (arch == "zamba2-2.7b")


@pytest.mark.parametrize("arch", SSM)
def test_float32_leaves_stay_float32_in_a_bfloat16_model(arch):
    """Through init_params, params_from_jax (a bf16 tree whose A_log, D and
    Mamba-2 dt_bias the reference keeps in float32) and a state-dict copy:
    those leaves float32, every other parameter bf16, each dtype the
    reference tree's, and the float32 values the reference's bit for bit."""
    cfg = reduced(get_config, arch, dtype="bfloat16")
    tree = jax_tree(arch, "bfloat16")
    want = reference_shapes(arch, tree)
    built = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    loaded = params_from_jax(cfg, jax.tree.map(np.asarray, tree), device=CPU)
    copied = DecoderLM(cfg, device=CPU)
    copied.load_state_dict(loaded.state_dict())
    f32 = F32_LEAVES[VARIANT[arch]]
    for model in (built, loaded, copied):
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            expect = torch.float32 if ".ssm." in name and leaf in f32 else torch.bfloat16
            assert t.dtype == expect, name
            assert (want[name][1] == jnp.float32) == (expect == torch.float32), name
    for leaf in f32:
        assert np.array_equal(getattr(loaded.layers[0].ssm, leaf).numpy(),
                              np.asarray(layer0_ssm(arch, "bfloat16")[leaf]))


@pytest.mark.parametrize("arch,change,match", [
    ("falcon-mamba-7b", ("drop", "layers.ssm.dt_proj"), "Missing key"),
    ("falcon-mamba-7b", ("add", "layers.ssm.norm_scale"), "Unexpected key"),  # Mamba-2's
    ("falcon-mamba-7b", ("shape", "layers.ssm.A_log"), "size mismatch"),
    ("zamba2-2.7b", ("drop", "shared_attn.mlp.wg"), "Missing key"),
    ("zamba2-2.7b", ("add", "layers.ssm.x_proj"), "Unexpected key"),  # Mamba-1's
    ("zamba2-2.7b", ("shape", "layers.ssm.D"), "size mismatch"),
    ("zamba2-2.7b", ("flat", "layers.ln.scale"), "n_groups, g"),
])
def test_params_from_jax_refuses_a_missing_extra_or_misshapen_leaf(arch, change, match):
    tree = jax.tree.map(np.asarray, jax_tree(arch))
    params_from_jax(reduced(get_config, arch), tree, device=CPU)  # as it is: loads
    what, name = change
    *parents, leaf = name.split(".")
    node = tree
    for key in parents:
        node = node[key]
    lead = node[next(iter(node))].shape[:2 if arch == "zamba2-2.7b" else 1]
    if what == "drop":
        del node[leaf]
    elif what == "add":
        node[leaf] = np.zeros((*lead, 4), np.float32)
    elif what == "shape":
        node[leaf] = np.zeros((*node[leaf].shape[:-1], node[leaf].shape[-1] + 1), np.float32)
    else:  # the hybrid's (n_groups, g) axes already flattened
        node[leaf] = node[leaf].reshape(-1, *node[leaf].shape[2:])
    with pytest.raises((RuntimeError, ValueError), match=match):
        params_from_jax(reduced(get_config, arch), tree, device=CPU)


# ---------------------------------------------------------------------------
# the SSM modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(dtype):
    """Mamba-2's conv over x, B and C (288 channels), S = 64."""
    w = np.asarray(layer0_ssm("zamba2-2.7b", dtype)["conv_w"], np.float32)
    rng = np.random.default_rng(1)
    w = w + rng.standard_normal(w.shape).astype(np.float32) * 0.1  # unequal taps
    bias = rng.standard_normal(w.shape[1]).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 64, w.shape[1])).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jw, jb = (jnp.asarray(a).astype(jd) for a in (x, w, bias))
    ref = jax_ssm._causal_conv(jx, jw, jb)
    out = ssm.causal_conv(port_input(jx), port_input(jw), port_input(jb))
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    close(out, ref, rtol=BF16_ULPS if dtype == "bfloat16" else RTOL)


APPLY = {"mamba1": (jax_ssm.mamba1_apply, ssm.mamba1_apply),
         "mamba2": (jax_ssm.mamba2_apply, ssm.mamba2_apply)}
DECODE = {"mamba1": (jax_ssm.mamba1_decode, jax_ssm.mamba1_init_cache, ssm.mamba1_decode,
                     ssm.mamba1_init_cache),
          "mamba2": (jax_ssm.mamba2_decode, jax_ssm.mamba2_init_cache, ssm.mamba2_decode,
                     ssm.mamba2_init_cache)}


@pytest.mark.parametrize("chunk", [None, 16, 7])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_apply_matches_in_float32(arch, chunk, monkeypatch):
    """Prefill of one SSM layer at S = 64 in float32, within 1e-5 ×
    max|ref|: at the default chunk (Mamba-1: the whole sequence, which
    ``STATE_CHUNK_BYTES`` holds; Mamba-2: one SSD chunk of 64) and at
    chunks of 16 and 7 steps, where the state crosses chunks (7 pads
    Mamba-2's last one)."""
    cfg, m = ssm_module(arch)
    jcfg = reduced(jax_get_config, arch)
    if chunk is not None:  # b 2, di 256, N 16: one step's float32 state is 32 KiB
        monkeypatch.setattr(ssm, "STATE_CHUNK_BYTES", chunk * 2 * 256 * 16 * 4)
        monkeypatch.setattr(ssm, "SSD_CHUNK", chunk)
    x = activations(2, (2, 64))
    ref = APPLY[VARIANT[arch]][0](layer0_ssm(arch), jcfg, jnp.asarray(x))
    out = APPLY[VARIANT[arch]][1](m, cfg, torch.from_numpy(x))
    close(out, ref)


@pytest.mark.parametrize("arch", SSM)
def test_ssm_apply_matches_in_bfloat16(arch):
    """bf16 weights (A_log, D, Mamba-2 dt_bias float32) and a bf16 input at
    S = 64: within 4 bf16 ulps of max|ref|, the reference's rounding
    points kept."""
    cfg, m = ssm_module(arch, "bfloat16")
    jcfg = reduced(jax_get_config, arch, dtype="bfloat16")
    x = jnp.asarray(activations(3, (2, 64))).astype(jnp.bfloat16)
    ref = APPLY[VARIANT[arch]][0](layer0_ssm(arch, "bfloat16"), jcfg, x)
    out = APPLY[VARIANT[arch]][1](m, cfg, port_input(x))
    assert out.dtype == torch.bfloat16
    close(out, ref, rtol=BF16_ULPS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM)
def test_ssm_decode_matches(arch, dtype):
    """12 decode steps of one SSM layer at b 2 against the reference's: the
    output and the cache's ``conv`` ring and ``h`` state each step
    (float32: 1e-5 × max|ref|; bf16: 4 bf16 ulps of max|ref|)."""
    cfg, m = ssm_module(arch, dtype)
    jcfg = reduced(jax_get_config, arch, dtype=dtype)
    jdec, jinit, dec, init = DECODE[VARIANT[arch]]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = BF16_ULPS if dtype == "bfloat16" else RTOL
    jcache = jinit(jcfg, 2, jd)
    cache = init(cfg, 2, td, CPU)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), torch.float32 if v.dtype == jnp.float32 else td)
        for k, v in jcache.items()}
    tree = layer0_ssm(arch, dtype)
    step = jax.jit(lambda x, c: jdec(tree, jcfg, x, c))
    xs = jnp.asarray(activations(4, (2, 12))).astype(jd)
    for t in range(12):
        ref, jcache = step(xs[:, t:t + 1], jcache)
        out, cache = dec(m, cfg, port_input(xs[:, t:t + 1]), cache)
        close(out, ref, rtol=tol)
        close(cache["conv"], jcache["conv"], rtol=tol)
        close(cache["h"], jcache["h"], rtol=tol)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_shared_block_attention_matches_the_reference_kernel_route(use_kernel):
    """zamba2's shared block's GQA (4 heads of 32, full causal) at S = 128:
    the reference through its Pallas flash kernel in interpret mode, the
    port through both of its routes, within 2e-5 × max|ref|."""
    cfg = reduced(get_config, "zamba2-2.7b")
    jcfg = reduced(jax_get_config, "zamba2-2.7b")
    tree = jax_tree("zamba2-2.7b")["shared_attn"]["attn"]
    port = attention.GQAttention(cfg, dtype=torch.float32, device=CPU)
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in tree.items()})
    x = activations(5, (2, 128))
    pos = jax_model._positions(jcfg, jnp.zeros((2, 128), jnp.int32))
    ref = jax_attention.gqa_apply(tree, jcfg, jnp.asarray(x), pos, use_kernel=True,
                                  interpret=True)
    out = attention.gqa_apply(port, cfg, torch.from_numpy(x), torch.from_numpy(np.array(pos)),
                              use_kernel=use_kernel)
    close(out, ref, rtol=2e-5)


def test_ssm_block_matches():
    """One Mamba-1 block, ``x + ssm(norm(x))``, at S = 32."""
    cfg = reduced(get_config, "falcon-mamba-7b")
    jcfg = reduced(jax_get_config, "falcon-mamba-7b")
    tree = jax.tree.map(lambda a: a[1], jax_tree("falcon-mamba-7b")["layers"])
    blk = blocks.SSMBlock(cfg, dtype=torch.float32, device=CPU)
    blk.load_state_dict({f"{p}.{k}": torch.tensor(np.asarray(v)) for p in ("ln", "ssm")
                         for k, v in tree[p].items()}, strict=True)
    x = activations(6, (2, 32))
    ref = jax_blocks.ssm_block_apply(tree, jcfg, jnp.asarray(x))
    close(blocks.ssm_block_apply(blk, cfg, torch.from_numpy(x)), ref)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [64, 100])
@pytest.mark.parametrize("arch", SSM)
def test_forward_matches(arch, s):
    """Against the reference's plain route at S = 64 and at S = 100 (two
    SSD chunks, the second padded), on the CPU, where the port's flash
    wrapper runs its plain version and launches nothing."""
    cfg = reduced(get_config, arch)
    toks = tokens(7, 2, s)
    ref = jax_model.forward(reduced(jax_get_config, arch), jax_tree(arch), jnp.asarray(toks),
                            use_flash_kernel=False, remat=False)
    before = launch_counts()
    out = forward(cfg, port_model(arch), torch.from_numpy(toks))
    assert launch_counts() == before
    assert out.dtype == torch.float32 and out.shape == (2, s, 512)
    close(out, ref)


@pytest.mark.parametrize("arch", SSM)
def test_bf16_forward_tracks_the_reference(arch):
    """The whole reduced model in bf16 at S = 32, on the same bf16 weights:
    within 4 bf16 ulps of max|ref| of the reference's bf16 logits."""
    toks = tokens(8, 2, 32)
    ref = jax_model.forward(reduced(jax_get_config, arch, dtype="bfloat16"),
                            jax_tree(arch, "bfloat16"), jnp.asarray(toks),
                            use_flash_kernel=False, remat=False)
    out = forward(reduced(get_config, arch, dtype="bfloat16"), port_model(arch, "bfloat16"),
                  torch.from_numpy(toks))
    close(out, ref, rtol=BF16_ULPS)


@pytest.mark.parametrize("arch", SSM)
def test_decode_matches_the_references_with_its_caches(arch):
    """24 decode steps at b 2 against the reference's ``decode_step``: the
    logits each step, then every SSM layer's ``h`` and ``conv`` (a
    hybrid's stacked (n_groups, g) in the reference, flat in the port) and
    each shared-block application's ``k`` and ``v``."""
    cfg = reduced(get_config, arch)
    jcfg = reduced(jax_get_config, arch)
    params, b, steps = port_model(arch), 2, 24
    toks = tokens(9, b, steps)
    jcache = jax_model.init_cache(jcfg, b, steps)
    cache = init_cache(cfg, b, steps, device=CPU)
    step = jax.jit(lambda p, x, c: jax_model.decode_step(jcfg, p, x, c))
    for t in range(steps):
        ref, jcache = step(jax_tree(arch), jnp.asarray(toks[:, t:t + 1]), jcache)
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, t:t + 1]), cache)
        close(out, ref)
    if arch == "falcon-mamba-7b":
        pairs = [(lc, jax.tree.map(lambda a: a[i], jcache["layers"]))
                 for i, lc in enumerate(cache["layers"])]
    else:
        g = cfg.hybrid_attn_every
        pairs = [(lc, jax.tree.map(lambda a: a[i // g, i % g], jcache["ssm"]))
                 for i, lc in enumerate(cache["ssm"])]
        assert len(cache["attn"]) == 2
        for i, ac in enumerate(cache["attn"]):
            for key in ("k", "v"):
                close(ac[key], jcache["attn"][key][i])
            assert ac["pos"].tolist() == [steps] * b
    assert len(pairs) == (2 if arch == "falcon-mamba-7b" else 4)
    for lc, ref in pairs:
        close(lc["h"], ref["h"])
        close(lc["conv"], ref["conv"])


@pytest.mark.parametrize("arch", SSM)
def test_decode_matches_prefill(arch):
    """Teacher-forcing 24 tokens at b 2 reproduces forward's logits at the
    reference test's 2e-3 (``tests/test_models_smoke.py::test_decode_matches_forward``)."""
    cfg = reduced(get_config, arch)
    params = port_model(arch)
    toks = torch.from_numpy(tokens(10, 2, 24))
    full = forward(cfg, params, toks)
    cache = init_cache(cfg, 2, 24, device=CPU)
    outs = []
    for t in range(24):
        logits, cache = decode_step(cfg, params, toks[:, t:t + 1], cache)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-3, atol=2e-3)


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
@pytest.mark.parametrize("arch", SSM)
def test_engine_emits_the_reference_tokens(arch, slots):
    """The launcher's 6 requests through both engines on the same weights:
    every decode call's logits within 1e-5 × max|logits| and the same
    tokens, at 4 slots and at 1; every emitted token won by more than
    twice that tolerance on the reference's logits."""
    cfg = reduced(get_config, arch)
    jcfg = reduced(jax_get_config, arch)
    n, max_new = 6, 8
    reqs = serve.draw_requests(n, cfg.vocab, max_new)
    jreqs = [jax_engine.Request(rid=r.rid, prompt=r.prompt, max_new=max_new)
             for r in serve.draw_requests(n, cfg.vocab, max_new)]
    jeng = jax_engine.ServingEngine(jcfg, jax_tree(arch), batch_slots=slots, max_len=128,
                                    eos=-1)
    eng = ServingEngine(cfg, port_model(arch), batch_slots=slots, max_len=128, eos=-1)
    jeng._step, eng._step = Recorder(jax.jit(jeng._step)), Recorder(eng._step)
    assert drive(eng, list(reqs), n) == drive(jeng, list(jreqs), n)
    assert len(eng._step.logits) == len(jeng._step.logits)
    for out, ref in zip(eng._step.logits, jeng._step.logits):
        np.testing.assert_allclose(out, ref, atol=RTOL * np.abs(ref).max(), rtol=0)
    assert all(r.done and len(r.out) == max_new for r in reqs)
    for jr, r in zip(jreqs, reqs):
        assert r.out == jr.out, f"request {r.rid}"
    gaps = [np.diff(np.sort(lg[..., :cfg.vocab], axis=-1)[..., -2:], axis=-1).min()
            / np.abs(lg).max() for lg in jeng._step.logits]
    assert min(gaps) > 2 * RTOL


@pytest.mark.parametrize("arch", SSM)
def test_serve_runs_each_ssm_arch_on_cpu(arch):
    before = launch_counts()
    rep = serve.run(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert rep["arch"] == arch and rep["preset"] == "tiny"
    assert rep["finished"] == rep["requests"] == 3 and rep["tokens"] == 12
    assert launch_counts() == before  # serving runs no kernel
