"""The port's loss and gradients on the CPU against ``jax.value_and_grad``
of the reference's ``loss_fn`` for the MoE (mixtral-8x22b, deepseek-v2-236b
with MLA), SSM (falcon-mamba-7b), hybrid (zamba2-2.7b) and
encoder-decoder (whisper-medium) archs; the dense ones, the configs,
inputs and tolerances are in ``test_torch_training_grads.py``."""
import pytest

from test_torch_training_grads import OTHERS, check_loss_and_gradients


@pytest.mark.parametrize("arch", OTHERS)
def test_loss_and_gradients_match(arch):
    check_loss_and_gradients(arch)
