"""Carry the reference's weights into the port.

:func:`params_from_jax` takes the tree the reference's ``init_params``
returns, with numpy leaves, and loads it into a :class:`DecoderLM`; the
leading layer dim of ``tree["layers"]`` is sliced into one block each.
Tests use it so that both packages compute from the same weights.
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


def params_from_jax(cfg: ModelConfig, tree: dict, *, device=None) -> DecoderLM:
    """The port's model with the weights of ``tree`` (leaves as numpy
    arrays, any float dtype; cast to ``cfg.dtype``).  Raises if a leaf is
    missing, extra or of another shape than the port's."""
    state = {}
    for name, leaf in _flatten(tree):
        arr = torch.tensor(np.asarray(leaf, dtype=np.float32))
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(arr.shape[0]):
                state[f"layers.{i}.{rest}"] = arr[i]
        else:
            state[name] = arr
    model = DecoderLM(cfg, device=resolve_device(device))
    model.load_state_dict(state, strict=True)
    return model
