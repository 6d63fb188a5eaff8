"""The port's loss and gradients for every arch on the CPU, held against
``jax.value_and_grad`` of the reference's ``loss_fn``: the five dense
decoders here, the MoE, SSM, hybrid and encoder-decoder archs in
``test_torch_training_grads_moe_ssm.py`` (two files, each within a
worker's minute).

Configs: each arch's reduced config in float32, the dense MoE
dispatch (as ``launch.train`` trains), chunks of 16 positions in the
loss.  Weights: the reference's ``init_params`` carried into the port by
``convert.params_from_jax``, and its gradient tree the same way, so that
the two are compared parameter by parameter.  Inputs: numpy, fixed
seeds (whisper: random frames).  Tolerances: the loss within 1e-5
relative, every gradient within 1e-4 × the max |entry| of the reference's
gradient of that parameter (the backward sums in another order, through
other libraries' exp, tanh and products).  This covers the repairs made
for autograd: gemma2-2b's softcaps, the MoE dispatch, MLA, the Mamba-1
scan, Mamba-2's segment sums and whisper's encoder and cross attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.training import train_step as jax_train
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import launch_counts
from repro_torch.models.convert import params_from_jax
from repro_torch.training import init_train_state
from repro_torch.training.train_step import loss_and_grads

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def reduced(get, arch):
    return dataclasses.replace(get(arch).reduced(), dtype="float32")


DENSE = ("starcoder2-3b", "phi3-medium-14b", "gemma2-2b", "stablelm-3b", "qwen2-vl-2b")
OTHERS = ("zamba2-2.7b", "whisper-medium", "falcon-mamba-7b", "mixtral-8x22b",
          "deepseek-v2-236b")


def test_every_reference_arch_is_trained():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(DENSE + OTHERS) == sorted(ARCH_IDS)


def check_loss_and_gradients(arch):
    cfg, jcfg = reduced(get_config, arch), reduced(jax_get_config, arch)
    tree = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    ref_batch, batch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.encoder:
        fr = rng.standard_normal((2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
        ref_batch["frames"], batch["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    ref_loss, ref_grads = jax.value_and_grad(jax_train.loss_fn)(
        tree, jcfg, ref_batch, moe_dispatch="dense", ce_chunk=16)
    state = init_train_state(cfg, params=params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                                         device=CPU))
    before = launch_counts()
    loss, grads = loss_and_grads(state.params, cfg, batch, moe_dispatch="dense", ce_chunk=16)
    assert launch_counts() == before
    assert abs(float(loss) - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, ref_grads), device=CPU)
    names = {k for k, _ in want.named_parameters()}
    assert set(grads) == names
    for name, g in want.named_parameters():
        ref = g.detach().numpy()
        np.testing.assert_allclose(grads[name].numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match(arch):
    check_loss_and_gradients(arch)
