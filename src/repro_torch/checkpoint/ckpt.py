"""Checkpoints, the reference's ``checkpoint/ckpt.py`` without a mesh.

Format: one ``arrays_<step>.npz`` of every leaf, an ``index_<step>.json``
with the keys, shapes and dtypes, and an atomic ``LATEST`` pointer (a
temporary file renamed over it).  The reference writes its index with
msgpack; the port writes JSON (no msgpack on the card's machine).  numpy
has no bfloat16: a bfloat16 tensor is stored as its bits (int16) and its
index entry says ``bfloat16``, so that a restore is bit for bit the
save.  The reference's ``shardings=`` (re-placing arrays on another mesh)
is left out: the port has no mesh.

A tree is a dict, a NamedTuple, a list or tuple, an ``nn.Module`` (its
``state_dict``, keys joined with ``.`` as the module names them) or a
tensor leaf; keys join the path with ``/``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

_BITS = {torch.bfloat16: np.int16}  # dtypes numpy lacks, stored as their bits


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, nn.Module):
        for k, v in tree.state_dict(keep_vars=True).items():
            out[f"{prefix}{k}"] = v
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """The host array to store and the dtype name to restore."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy(), str(t.dtype).removeprefix("torch.")
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_checkpoint(path: str, tree: Any, step: int) -> None:
    """Write every leaf of ``tree`` under ``path`` as step ``step``, then
    point ``LATEST`` at it."""
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(path, f"arrays_{step}.npz"), **arrays)
    index = {
        "step": step,
        "keys": list(arrays),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": dtypes,
    }
    with open(os.path.join(path, f"index_{step}.json"), "w") as f:
        json.dump(index, f)
    # atomic "latest" pointer
    tmp = os.path.join(path, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(path, "LATEST"))


def latest_step(path: str) -> Optional[int]:
    p = os.path.join(path, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_arrays(path: str, step: Optional[int] = None) -> tuple[dict, int]:
    """Every leaf of step ``step`` (``LATEST`` by default) as a CPU tensor
    of its saved dtype, by key, and the step."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(path, f"index_{step}.json")) as f:
        dtypes = json.load(f)["dtypes"]
    out = {}
    with np.load(os.path.join(path, f"arrays_{step}.npz")) as z:
        for k in z.files:
            t = torch.from_numpy(z[k])
            dtype = getattr(torch, dtypes[k])
            out[k] = t.view(dtype) if dtype in _BITS else t
    return out, step


def restore_into(path: str, template: Any, *, step: Optional[int] = None):
    """Restore into the structure of ``template``: a module's tensors are
    overwritten in place (the module is returned), every other leaf comes
    back as a new tensor on its template's device in its template's dtype.
    Raises ``KeyError`` when the checkpoint lacks a key of the template."""
    flat, step = restore_arrays(path, step)
    missing = set(_flatten(template)) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} …")

    def rebuild(tree, prefix=""):
        if isinstance(tree, nn.Module):
            with torch.no_grad():
                for k, t in tree.state_dict(keep_vars=True).items():
                    t.copy_(flat[f"{prefix}{k}"])
            return tree
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(rebuild(getattr(tree, k), f"{prefix}{k}/") for k in tree._fields))
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree))
        tmpl = torch.as_tensor(tree)
        return flat[prefix[:-1]].to(device=tmpl.device, dtype=tmpl.dtype)

    return rebuild(template), step
