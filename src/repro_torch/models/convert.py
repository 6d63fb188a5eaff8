"""Carry the reference's weights into the port.

:func:`params_from_jax` takes the tree the reference's ``init_params``
returns, with numpy leaves, and loads it into a :class:`DecoderLM`; the
leading layer dim of ``tree["layers"]`` (and of whisper's
``tree["enc_layers"]``) is sliced into one block each (a hybrid's leading
``(n_groups, g)`` is one flat index, ``group · g + j``; its
``shared_attn`` has no layer dim).  Tests use it so that both
packages compute from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import DecoderLM


def _flatten(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, f"{name}.")
        else:
            yield name, value


# the MoE experts: (in, E, out) in the reference, (E, in, out) in the port
_EXPERTS = ("mlp.wi", "mlp.wg", "mlp.wo")


def params_from_jax(cfg: ModelConfig, tree: dict, *, device=None) -> DecoderLM:
    """The port's model with the weights of ``tree`` (leaves as numpy
    arrays, any float dtype), each cast to its parameter's own dtype:
    ``cfg.dtype``, but float32 for an MoE router and an SSM's ``A_log``,
    ``D`` and Mamba-2 ``dt_bias``, as in the reference.  The experts' axis
    moves to the front (``mlp.MoE``).  Raises if a leaf is missing, extra
    or of another shape than the port's.

    Any tree of the parameters' structure converts: the training tests
    carry the reference's gradients and AdamW moments this way."""
    state = {}
    groups = None
    if cfg.hybrid_attn_every:
        groups = (cfg.n_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every)
    for name, leaf in _flatten(tree):
        arr = torch.tensor(np.asarray(leaf, dtype=np.float32))
        if name.startswith("enc_layers."):
            for i in range(arr.shape[0]):
                state[f"enc_layers.{i}.{name[len('enc_layers.'):]}"] = arr[i]
        elif name.startswith("layers."):
            rest = name[len("layers."):]
            if groups is not None:
                if tuple(arr.shape[:2]) != groups:
                    raise ValueError(f"{name}: leading dims {tuple(arr.shape[:2])}, expected "
                                     f"(n_groups, g) = {groups}")
                arr = arr.reshape(-1, *arr.shape[2:])
            if cfg.moe is not None and rest in _EXPERTS:
                arr = arr.transpose(1, 2)  # (L, in, E, out) → (L, E, in, out)
            for i in range(arr.shape[0]):
                state[f"layers.{i}.{rest}"] = arr[i]
        else:
            state[name] = arr
    model = DecoderLM(cfg, device=resolve_device(device))
    model.load_state_dict(state, strict=True)
    return model
