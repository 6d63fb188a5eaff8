"""Logical sharding rules, the reference's ``sharding/rules.py``: a
parameter's name and shape on a mesh → its spec.

Scheme: FSDP over ``data``, tensor and expert parallelism over ``model``,
pure data parallelism over ``pod`` (parameters replicated across pods).
The rules divide or drop: a dim that does not divide its mesh axis falls
back per tensor, as in the reference:

- an MoE expert dim that does not divide (mixtral: 8 experts on
  ``model`` = 16) → the expert FFN dim goes over ``model`` instead;
- a q/kv head count that does not divide (starcoder2 24, phi3 40, gemma2
  8, qwen2 12 heads on 16) → the heads are replicated.

The port has no mesh for the model: a mesh here is its named axis sizes,
``{"data": 16, "model": 16}`` (``repro_torch.launch.mesh``), and a spec a
tuple of one entry a dim, each an axis name, a tuple of names or None.
The dry run (``repro_torch.launch.specs``) reads the specs to size each
device's share of the parameters, optimizer state and caches, and to
count the collectives (``repro_torch.utils.roofline``).

The port names parameters ``layers.3.attn.wq``; the reference
``layers/attn/wq`` with a leading layer dim (a hybrid's ``(n_groups, g)``).
The rules match on the name without the layer index
(:func:`rule_path`), and a tensor's dims are the reference's trailing
ones, so the reference's trailing spec applies as it is.  An MoE expert
tensor (``mlp.wi``, ``mlp.wg``, ``mlp.wo`` of an MoE config) is stored
``(E, d, fe)`` / ``(E, fe, d)`` where the reference has ``(d, E, fe)`` /
``(fe, E, d)`` (``models/convert.py`` moves the axis); its spec is the
reference's with the expert entry moved to the front, decided on the same
logical dims.  Left out: ``constrain``, ``current_mesh`` and
``param_shardings``, which act on a JAX mesh.
"""
from __future__ import annotations

import re

# (regex on the path, trailing-dims spec), the reference's table
_RULES: list[tuple[str, tuple]] = [
    (r"^(embed|lm_head)$", ("model", "data")),
    (r"attn/w[qkv]$", ("data", "model", None)),
    (r"attn/wo$", ("model", "data")),
    # MLA
    (r"attn/wdq$", ("data", "model")),
    (r"attn/wuq$", ("data", "model", None)),
    (r"attn/wdkv$", ("data", "model")),
    (r"attn/wkr$", ("data", None)),
    (r"attn/wuk$", (None, "model", None)),
    (r"attn/wuv$", (None, "model", None)),
    (r"cross/w[qkv]$", ("data", "model", None)),
    (r"cross/wo$", ("model", "data")),
    # dense MLP
    (r"router$", ("data", None)),
    (r"(mlp|shared)/w[ig]$", ("data", "model")),
    (r"(mlp|shared)/wo$", ("model", "data")),
    # mamba
    (r"ssm/in_proj$", ("data", "model")),
    (r"ssm/conv_[wb]$", ()),
    (r"ssm/x_proj$", ("model", None)),
    (r"ssm/dt_proj$", (None, "model")),
    (r"ssm/dt_bias$", ("model",)),
    (r"ssm/A_log$", ("model", None)),
    (r"ssm/D$", ("model",)),
    (r"ssm/norm_scale$", ("model",)),
    (r"ssm/out_proj$", ("model", "data")),
    (r".*", ()),
]

_LAYER_INDEX = re.compile(r"(^|\.)(layers|enc_layers)\.\d+(?=\.)")


def rule_path(name: str) -> str:
    """The reference's path of a port parameter: ``layers.3.attn.wq`` →
    ``layers/attn/wq``."""
    return _LAYER_INDEX.sub(r"\1\2", name).replace(".", "/")


def _axis_size(mesh: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh[a]
        return n
    return mesh[axis]


def _fits(mesh: dict, axis, dim: int) -> bool:
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    if not all(a in mesh for a in names):
        return False
    return dim % _axis_size(mesh, axis) == 0


def finalize_spec(spec: tuple, shape: tuple, mesh: dict) -> tuple:
    """Pad to rank and drop axes that don't divide (or don't exist); a spec
    longer than the shape replicates the tensor."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        return (None,) * len(shape)
    full = (None,) * (len(shape) - len(spec)) + spec
    return tuple(a if _fits(mesh, a, d) else None for a, d in zip(full, shape))


def _spec_for(path: str, shape: tuple, mesh: dict, moe: bool = False) -> tuple:
    """The spec of the tensor at reference path ``path``; ``moe`` says the
    config has experts, whose ``mlp/w{i,g,o}`` are ``(E, ·, ·)``."""
    if moe and re.search(r"mlp/w[igo]$", path):
        e, a, b = shape  # the reference's (a, E, b)
        logical = (a, e, b)
        ep = _fits(mesh, "model", e)  # experts divide → EP
        if path.endswith("wo"):
            spec = (None, "model", "data") if ep else ("model", None, "data")
        else:
            spec = ("data", "model", None) if ep else ("data", None, "model")
        sa, se, sb = finalize_spec(spec, logical, mesh)
        return (se, sa, sb)
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return finalize_spec(spec, shape, mesh)
    return (None,) * len(shape)


def param_spec(name: str, shape: tuple, mesh: dict, moe: bool = False) -> tuple:
    """The spec of the port parameter ``name`` of ``shape``."""
    return _spec_for(rule_path(name), tuple(shape), mesh, moe)


def param_specs(named, mesh: dict, moe: bool = False) -> dict:
    """``{name: spec}`` over ``(name, tensor)`` pairs (a model's
    ``named_parameters()``, or the optimizer's moments by the same names);
    ``moe``: the config has experts."""
    return {name: param_spec(name, tuple(t.shape), mesh, moe) for name, t in named}


def spec_axes(spec: tuple) -> tuple:
    """The mesh axes a spec shards over, in order."""
    return tuple(a for entry in spec if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,)))


def shard_bytes(nbytes: int, spec: tuple, mesh: dict) -> int:
    """One device's bytes of a tensor of ``nbytes`` under ``spec``: the
    bytes over the product of its sharded axes' sizes (they divide)."""
    n = 1
    for a in spec_axes(spec):
        n *= mesh[a]
    return nbytes // n


def batch_axes(mesh: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh)


def batch_spec(mesh: dict, rank: int = 1) -> tuple:
    """The spec of a batch-major tensor of ``rank`` dims: its batch dim over
    the (pod, data) axes."""
    axes = batch_axes(mesh)
    return ((axes if len(axes) > 1 else axes[0]),) + (None,) * (rank - 1)
