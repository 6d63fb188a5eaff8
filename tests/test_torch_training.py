"""The port's training path on the CPU — AdamW, the fused chunked loss, the
train step, the synthetic corpus, local SGD with its int8 outer sync,
checkpoints and the launcher — held against the JAX reference.

Config: stablelm-3b's reduced config (2 layers, d_model 128, 4 heads of
32, vocab 512) in float32 unless said.  Weights: the reference's
``init_params`` carried into the port by ``convert.params_from_jax``; the
reference's gradients and AdamW moments have the parameters' tree, so
``params_from_jax`` carries them too and they are compared parameter by
parameter.  Inputs: numpy, fixed seeds.  Tolerances: AdamW and the outer
sync 1e-6 relative (the same float32 operations in the same order; pow
comes from another library); the loss and the gradient norm 1e-5
relative; the corpus, the int8 quantization and the checkpoint round trip
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jax_tokens
from repro.models import model as jax_model
from repro.training import local_sgd as jax_local_sgd
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_train
from repro_torch.checkpoint import latest_step, restore_arrays, restore_into, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.kernels.flash_attention import launch_counts
from repro_torch.launch import train
from repro_torch.models.convert import params_from_jax
from repro_torch.training import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    dequantize_int8,
    fused_chunked_ce,
    global_norm,
    init_opt_state,
    init_train_state,
    make_local_sgd_step,
    make_train_step,
    quantize_int8,
    replicate_state,
)
from repro_torch.training import local_sgd

CPU = torch.device("cpu")
ARCH = "stablelm-3b"
OPT_RTOL = 1e-6
LOSS_RTOL = 1e-5


def reduced(get, **kw):
    return dataclasses.replace(get(ARCH).reduced(), **{"dtype": "float32", **kw})


_TREES: dict = {}


def jax_tree(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _TREES:
        _TREES[key] = jax_model.init_params(reduced(jax_get_config, **kw), jax.random.PRNGKey(0))
    return _TREES[key]


def port(tree, **kw):
    """The port's model (or a name → tensor dict) from a reference tree."""
    return params_from_jax(reduced(get_config, **kw), jax.tree.map(np.asarray, tree), device=CPU)


def named(tree, **kw):
    return {k: v.detach().clone() for k, v in port(tree, **kw).named_parameters()}


def rel_close(out, ref, rtol):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=rtol * max(float(np.abs(ref).max()), 1e-30),
                               rtol=0)


def close_trees(port_tensors, ref_tree, rtol):
    want = named(ref_tree)
    assert set(port_tensors) == set(want)
    for k, t in port_tensors.items():
        rel_close(t, want[k].numpy(), rtol)


def fake_grads(seed, tree, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        scale * rng.standard_normal(p.shape).astype(np.float32)), tree)


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_over_the_warmup(grad_scale):
    """Three steps with warm-up 2 (the learning rate's ramp ends in the
    second step) from identical parameters, gradients and state: the
    parameters, ``m``, ``v``, the step and the norm."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    ref_p = jax_tree()
    ref_opt = jax_opt.init_opt_state(ref_p)
    params = named(ref_p)
    opt = init_opt_state(params)
    for step in range(3):
        g = fake_grads(10 + step, ref_p, grad_scale)
        ref_p, ref_opt, ref_norm = jax_opt.adamw_update(cfg, ref_p, g, ref_opt)
        opt, norm = adamw_update(cfg, params, named(g), opt)
        rel_close(norm, ref_norm, OPT_RTOL)
        assert opt.step.dtype == torch.int32 and int(opt.step) == int(ref_opt.step) == step + 1
        close_trees(params, ref_p, OPT_RTOL)
        close_trees(opt.m, ref_opt.m, OPT_RTOL)
        close_trees(opt.v, ref_opt.v, OPT_RTOL)
        assert all(t.dtype == torch.float32 for t in (*opt.m.values(), *opt.v.values()))


def test_adamw_keeps_each_parameters_dtype():
    """A bf16 model's parameters stay bf16; its moments are float32."""
    state = init_train_state(reduced(get_config, dtype="bfloat16"),
                             torch.Generator().manual_seed(0), device=CPU)
    params = dict(state.params.named_parameters())
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    opt, _ = adamw_update(AdamWConfig(), params, grads, state.opt)
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    assert all(m.dtype == torch.float32 for m in opt.m.values())
    assert any(not torch.equal(before[k], p) for k, p in params.items())


def test_clip_by_global_norm_and_global_norm_match():
    ref_p = jax_tree()
    g = fake_grads(3, ref_p, 0.5)
    ref_norm = jax_opt.global_norm(g)
    rel_close(global_norm(named(g)), ref_norm, OPT_RTOL)
    for max_norm in (1.0, 1e6):
        ref_clipped, ref_n = jax_opt.clip_by_global_norm(g, max_norm)
        clipped, n = clip_by_global_norm(named(g), max_norm)
        rel_close(n, ref_n, OPT_RTOL)
        close_trees(clipped, ref_clipped, OPT_RTOL)
        assert all(t.dtype == torch.float32 for t in clipped.values())


# ---------------------------------------------------------------------------
# the loss and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [16, None], ids=["chunk16", "whole"])
def test_fused_chunked_ce_matches_with_vocab_padding(chunk):
    """Vocab 500 pads to 512: the 12 padded columns are masked out."""
    jcfg = reduced(jax_get_config, vocab=500)
    ref_p = jax_tree(vocab=500)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 40, 128)).astype(np.float32)
    labels = rng.integers(0, 500, (2, 40)).astype(np.int32)
    ref = jax_train.fused_chunked_ce(jcfg, ref_p, jnp.asarray(feats), jnp.asarray(labels),
                                     chunk or 40)
    params = port(ref_p, vocab=500)
    assert params.lm_head.shape[0] == 512
    out = fused_chunked_ce(reduced(get_config, vocab=500), params, torch.from_numpy(feats),
                           torch.from_numpy(labels), chunk or 40)
    rel_close(out, ref, LOSS_RTOL)


def test_chunked_loss_gradient_equals_the_unchunked_one():
    """The chunks' recomputed backward gives the gradient of the whole."""
    cfg = reduced(get_config)
    state = init_train_state(cfg, params=port(jax_tree()))
    feats = torch.randn(2, 32, 128, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    labels = torch.from_numpy(tokens(5, 2, 32))
    grads = []
    for chunk in (8, 32):
        loss = fused_chunked_ce(cfg, state.params, feats, labels, chunk)
        grads.append(torch.autograd.grad(loss, [feats, state.params.lm_head]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def ref_step():
    """The reference's jitted train step and its result from seed-0 weights."""
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    jcfg = reduced(jax_get_config)
    step = jax.jit(jax_train.make_train_step(jcfg, jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2),
                                             moe_dispatch="dense", ce_chunk=16))
    toks = tokens(6, 2, 33)
    state0 = jax_train.TrainState(jax_tree(), jax_opt.init_opt_state(jax_tree()))
    state1, metrics = step(state0, {"tokens": jnp.asarray(toks)})
    return opt_cfg, toks, state1, metrics


def test_make_train_step_matches(ref_step):
    opt_cfg, toks, _, ref_metrics = ref_step
    cfg = reduced(get_config)
    state = init_train_state(cfg, params=port(jax_tree()))
    step = make_train_step(cfg, opt_cfg, moe_dispatch="dense", ce_chunk=16)
    before = launch_counts()
    state, metrics = step(state, {"tokens": torch.from_numpy(toks)})
    assert launch_counts() == before  # the plain route
    rel_close(metrics["loss"], ref_metrics["loss"], LOSS_RTOL)
    rel_close(metrics["grad_norm"], ref_metrics["grad_norm"], LOSS_RTOL)
    assert int(metrics["step"]) == int(ref_metrics["step"]) == 1


def test_init_train_state_turns_grad_on_and_inference_keeps_it_off():
    from repro_torch.models.model import init_params

    cfg = reduced(get_config)
    assert not any(p.requires_grad for p in init_params(cfg, device=CPU).parameters())
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert all(p.requires_grad for p in state.params.parameters())
    assert set(state.opt.m) == {k for k, _ in state.params.named_parameters()}
    assert int(state.opt.step) == 0


# ---------------------------------------------------------------------------
# the autograd repairs
# ---------------------------------------------------------------------------


def test_softcap_backward_matches_the_reference():
    """tanh's backward reads its output: under autograd ``softcap`` takes
    its out-of-place form, with the inference form's numbers."""
    from repro.models import common as jax_common
    from repro_torch.models import common

    x = np.random.default_rng(7).standard_normal((4, 64)).astype(np.float32) * 60
    ref_y, ref_vjp = jax.vjp(lambda a: jax_common.softcap(a, 30.0), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = common.softcap(xt * 1.0, 30.0)
    (gx,) = torch.autograd.grad(y.sum(), xt)
    rel_close(gx, ref_vjp(jnp.ones_like(ref_y))[0], 1e-6)
    assert torch.equal(y.detach(), common.softcap(torch.from_numpy(x) * 1.0, 30.0))


def test_mamba1_scan_backward_matches_the_reference(monkeypatch):
    """The in-place step overwrites the state the step before needs: under
    autograd the scan takes out-of-place steps, with the same numbers.
    falcon-mamba-7b's reduced first Mamba-1 layer (s 24, two scan chunks),
    its input gradient held to ``jax.vjp`` of the reference's
    ``mamba1_apply`` within 1e-5 × max|ref|."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm

    arch = "falcon-mamba-7b"
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tree = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], tree["layers"]["ssm"])
    layer = params_from_jax(cfg, jax.tree.map(np.asarray, tree), device=CPU).layers[0].ssm
    x = np.random.default_rng(8).standard_normal((2, 24, 128)).astype(np.float32)
    ref_y, vjp = jax.vjp(lambda a: jax_ssm.mamba1_apply(lp, jcfg, a), jnp.asarray(x))
    ct = np.random.default_rng(9).standard_normal(ref_y.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    monkeypatch.setattr(ssm, "STATE_CHUNK_BYTES", 2 * 256 * 16 * 4 * 12)  # 12 steps a chunk
    y = ssm.mamba1_apply(layer, cfg, xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    with torch.no_grad():
        inference = ssm.mamba1_apply(layer, cfg, xt)
    rel_close(y, ref_y, 1e-5)
    rel_close(gx, vjp(jnp.asarray(ct))[0], 1e-5)
    assert torch.equal(inference, y.detach())


def test_flash_attention_raises_under_grad_on_the_cpu_too():
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = (torch.randn(1, 2, 8, 32) for _ in range(3))
    flash_attention(q, k, v)  # no grad wanted: runs
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        flash_attention(q, k, v)  # grad mode off: runs


# ---------------------------------------------------------------------------
# data, local SGD, checkpoints, the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard", [0, 1])
def test_corpus_draws_the_references_batches(shard):
    cfg = dict(vocab=512, seq_len=24, global_batch=4, seed=3)
    ref = jax_tokens.SyntheticCorpus(jax_tokens.DataConfig(**cfg))
    out = SyntheticCorpus(DataConfig(**cfg))
    got = list(out.batches(shard=shard, num_shards=2, steps=3))
    want = list(ref.batches(shard=shard, num_shards=2, steps=3))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        next(out.batches(num_shards=3))


@pytest.mark.parametrize("scale", [1.0, 1e-13, 0.0])
def test_int8_quantization_equals_the_references(scale):
    """Ties at half a step included: both round half to even."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(1000) * scale).astype(np.float32)
    x[:4] = np.array([127.0, -127.0, 0.5, 1.5], np.float32) * scale  # steps of max/127
    rq, rs = jax_local_sgd.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    assert np.array_equal(dequantize_int8(q, s).numpy(),
                          np.asarray(jax_local_sgd.dequantize_int8(rq, rs)))


@pytest.mark.parametrize("compress", [True, False])
def test_outer_sync_matches_the_reference(compress):
    """The reference's local SGD step with no inner step (H = 0) is its
    outer sync alone: from the same two replicas and error buffers, the
    port's sync gives the same parameters and buffers."""
    ref_p = jax_tree()
    rng = np.random.default_rng(11)
    params_r = jax.tree.map(lambda p: jnp.asarray(np.stack(
        [np.asarray(p) + 0.01 * rng.standard_normal(p.shape).astype(np.float32)
         for _ in range(2)])), ref_p)
    err = jax.tree.map(lambda p: jnp.asarray(
        1e-3 * rng.standard_normal(p.shape).astype(np.float32)), params_r)
    opt = jax_opt.init_opt_state(ref_p)
    rep = lambda t: jnp.broadcast_to(t[None], (2, *t.shape))  # noqa: E731
    opt_r = jax_opt.OptState(jax.tree.map(rep, opt.m), jax.tree.map(rep, opt.v), rep(opt.step))
    state = jax_local_sgd.LocalSGDState(params_r, opt_r, err, jnp.zeros((), jnp.int32))
    step = jax_local_sgd.make_local_sgd_step(reduced(jax_get_config), inner_steps=0,
                                             compress=compress)
    ref_state, _ = step(state, {"tokens": jnp.zeros((2, 0, 2, 8), jnp.int32)})
    mine = [named(jax.tree.map(lambda a: a[i], params_r)) for i in range(2)]
    errs = [named(jax.tree.map(lambda a: a[i], err)) for i in range(2)]
    leaves: dict = {}
    for name in mine[0]:
        leaves.setdefault(local_sgd.leaf_name(name), []).append(name)
    assert len(leaves["layers.attn.wq"]) == 2  # one scale over both layers
    new_err = [{}, {}]
    for names in leaves.values():
        got = local_sgd._sync([[m[k] for k in names] for m in mine],
                              [[e[k] for k in names] for e in errs], compress)
        for r in range(2):
            new_err[r].update(zip(names, got[r]))
    for r in range(2):
        close_trees(mine[r], jax.tree.map(lambda a: a[r], ref_state.params_r), OPT_RTOL)
        close_trees(new_err[r], jax.tree.map(lambda a: a[r], ref_state.error_fb), OPT_RTOL)


def test_local_sgd_step_leaves_the_replicas_equal_and_tracks_the_reference():
    cfg = reduced(get_config)
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    toks = np.stack([tokens(20 + i, 2, 17) for i in range(4)]).reshape(2, 2, 2, 17)
    state = replicate_state(init_train_state(cfg, params=port(jax_tree())), 2)
    step = make_local_sgd_step(cfg, opt_cfg, inner_steps=2, moe_dispatch="dense")
    state, metrics = step(state, {"tokens": torch.from_numpy(toks)})
    a, b = (dict(p.named_parameters()) for p in state.params_r)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(metrics["outer_step"]) == 1 and all(int(o.step) == 2 for o in state.opt_r)
    jstate = jax_local_sgd.replicate_state(
        jax_train.TrainState(jax_tree(), jax_opt.init_opt_state(jax_tree())), 2)
    ref_step = jax_local_sgd.make_local_sgd_step(
        reduced(jax_get_config), jax_opt.AdamWConfig(lr=1e-2, warmup_steps=2), inner_steps=2,
        moe_dispatch="dense")
    _, ref_metrics = ref_step(jstate, {"tokens": jnp.asarray(toks)})
    rel_close(metrics["loss"], ref_metrics["loss"], LOSS_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_is_bit_for_bit(dtype, tmp_path):
    cfg = reduced(get_config, dtype=dtype)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(1)).to(p.dtype)
             for k, p in state.params.named_parameters()}
    opt, _ = adamw_update(AdamWConfig(), dict(state.params.named_parameters()), grads, state.opt)
    state = state._replace(opt=opt)
    save_checkpoint(str(tmp_path), state, 7)
    assert latest_step(str(tmp_path)) == 7
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST", "arrays_7.npz",
                                                          "index_7.json"]
    fresh = init_train_state(cfg, torch.Generator().manual_seed(5), device=CPU)
    restored, step = restore_into(str(tmp_path), fresh)
    assert step == 7 and restored.params is fresh.params
    for (k, a), (_, b) in zip(state.params.state_dict().items(),
                              restored.params.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k
    for want, got in ((opt.m, restored.opt.m), (opt.v, restored.opt.v)):
        assert all(torch.equal(want[k], got[k]) for k in want)
    assert restored.opt.step.dtype == torch.int32 and int(restored.opt.step) == 1
    arrays, _ = restore_arrays(str(tmp_path))
    assert arrays["params/embed"].dtype == getattr(torch, dtype)


def test_restore_into_raises_on_a_missing_key(tmp_path):
    cfg = reduced(get_config)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device=CPU)
    save_checkpoint(str(tmp_path), {"opt": state.opt}, 1)
    with pytest.raises(KeyError, match="missing keys"):
        restore_into(str(tmp_path), state)
    with pytest.raises(FileNotFoundError):
        restore_into(str(tmp_path / "none"), state)


def test_launcher_trains_checkpoints_and_resumes(tmp_path):
    args = ["--device", "cpu", "--preset", "tiny", "--seq-len", "32", "--global-batch", "2",
            "--ckpt-dir", str(tmp_path)]
    first = train.run(args + ["--steps", "3", "--ckpt-every", "2"])
    assert first["saved"] == [2, 3] and first["start_step"] == 0
    assert len(first["losses"]) == len(first["grad_norms"]) == len(first["step_s"]) == 3
    assert np.all(np.isfinite(first["losses"])) and first["peak_mem"] is None
    n_tensors = len(list(init_train_state(train.preset_config(ARCH, "tiny"), device=CPU)
                         .params.parameters()))
    assert first["changed"] == n_tensors  # every parameter moved
    saved, _ = restore_arrays(str(tmp_path))
    # the run hands back the state it trained, the one it saved last
    for name, p in first["state"].params.named_parameters():
        assert torch.equal(p.detach(), saved[f"params/{name}"]), name
    again = train.run(args + ["--steps", "1"])
    assert again["start_step"] == 3 and again["saved"] == [4]
    assert int(saved["opt/step"]) == 3 and np.isfinite(again["losses"][0])


def test_launcher_nosync_runs_an_outer_step():
    rep = train.run(["--device", "cpu", "--preset", "tiny", "--seq-len", "16",
                     "--global-batch", "2", "--dp-mode", "nosync", "--replicas", "2",
                     "--inner-steps", "1", "--steps", "1"])
    assert rep["dp_mode"] == "nosync" and len(rep["losses"]) == 1 and rep["changed"] is True
    assert rep["state"] is None
    assert np.isfinite(rep["losses"][0])


def test_launcher_presets_are_the_references():
    from repro.launch import train as jax_train_launch

    for arch in ("stablelm-3b", "whisper-medium", "mixtral-8x22b", "zamba2-2.7b"):
        for preset in ("tiny", "100m", "full"):
            assert dataclasses.asdict(train.preset_config(arch, preset)) == \
                dataclasses.asdict(jax_train_launch.preset_config(arch, preset))


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(["--steps", "1"])
