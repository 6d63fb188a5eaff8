"""Layer rematerialization in training, the reference's ``remat=True``:
``jax.checkpoint`` on each layer body under the policy
``dots_with_no_batch_dims_saveable``.

Where autograd records, ``models.model.forward`` runs each layer body (a
checkpoint unit: a decoder layer, an SSM layer, a hybrid's group, a
whisper decoder or encoder layer) through :func:`checkpoint_body`, a
non-reentrant ``torch.utils.checkpoint``:

- in the body's forward, every product that runs inside a :func:`dense`
  call is kept: the port's counterpart of a reference ``einsum`` with no
  batch dimension (a projection, the MLP, the router, the dense MoE
  dispatch's ``wi`` and ``wg``).  The products with a batch dimension
  (attention scores and P·V, the expert products of the sparse dispatch,
  the scans) run outside :func:`dense`: a product counts as saveable by
  what its reference computes, not by its ATen op (``torch.matmul`` may
  lower a product with no batch dimension to ``bmm``, and an ``einsum``
  that contracts two axes to ``mm``).  When the body's forward ends, a
  kept product that no node of the body's autograd graph reads except to
  add it, copy it or view it (the body's last projection, added into the
  residual stream) is let go: the backward never reads it, and the
  reference's partial evaluation keeps no such residual either;
- in the backward, the body runs again: a kept product returns its
  output without running (its autograd node still records, so the
  checkpoint's saved tensors line up), every other op runs again.  The
  checkpoint stops the recompute once it has made every tensor the
  backward reads, so a product let go at the body's end is not reached
  (one that is, runs).

A small dispatch mode runs inside each :func:`dense` call only, to catch
its product op: the body's other ops dispatch as they do without remat.
``torch.utils.checkpoint.create_selective_checkpoint_contexts`` is not
used: its policy runs in Python on every op of the body, and it keeps
every saved output until the backward, the unread ones too.  No op of a
body draws random numbers, so no RNG state is kept.  Under
``torch.no_grad()`` or with parameters that require no grad no body is
checkpointed, and :func:`dense` is a matrix product.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

aten = torch.ops.aten
PRODUCTS = frozenset({aten.mm, aten.bmm, aten.addmm, aten.baddbmm})

# Autograd nodes whose backward reads no value of what they take (only
# shapes, dtypes, indices or masks): a product read only through these
# is not needed by the backward.
_READS_NOTHING = frozenset({
    "AddBackward0", "SubBackward0", "NegBackward0", "ToCopyBackward0", "CloneBackward0",
    "CatBackward0", "StackBackward0", "SumBackward0", "SumBackward1", "ViewBackward0",
    "UnsafeViewBackward0", "ReshapeAliasBackward0", "TransposeBackward0",
    "PermuteBackward0", "ExpandBackward0", "SliceBackward0", "SelectBackward0",
    "SplitBackward0", "SplitWithSizesBackward0", "UnbindBackward0", "UnsqueezeBackward0",
    "SqueezeBackward0", "SqueezeBackward1", "AliasBackward0", "IndexBackward0",
    "IndexPutBackward0", "MaskedFillBackward0", "WhereBackward0",
    "ConstantPadNdBackward0",
})

_state = threading.local()
_ENTRY_HOOKS: list = []


class _Keep(TorchDispatchMode):
    """Inside a :func:`dense` call of a body's forward: keeps the output of
    its product op in ``cache``."""

    def __init__(self, cache: list):
        super().__init__()
        self.cache = cache

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket in PRODUCTS:
            self.cache.append([out.detach(), out._version, None])
        return out


class _Reuse(TorchDispatchMode):
    """Inside a :func:`dense` call of a body's recompute: the product op
    returns its kept output (a product let go runs)."""

    def __init__(self, cache: list):
        super().__init__()
        self.cache = cache
        self.index = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket in PRODUCTS:
            entry = self.cache[self.index]
            self.index += 1
            kept, version = entry[0], entry[1]
            if kept is not None:
                if kept._version != version:
                    raise RuntimeError(f"{func}: a kept product was changed in place")
                entry[0] = None
                return kept
        return func(*args, **(kwargs or {}))


class _Phase:
    """The context the checkpoint enters around a body's forward (a
    :class:`_Keep`) or its recompute (a :class:`_Reuse`): :func:`dense`
    runs its product under ``mode`` while it is entered."""

    def __init__(self, mode: TorchDispatchMode):
        self.mode = mode

    def __enter__(self):
        self.outer = getattr(_state, "mode", None)
        _state.mode = self.mode
        if isinstance(self.mode, _Reuse):
            self.mode.index = 0

    def __exit__(self, *exc):
        _state.mode = self.outer


def dense(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``: a product whose reference ``einsum`` has no batch
    dimension, kept for the backward in a checkpointed body."""
    mode = getattr(_state, "mode", None)
    if mode is None:
        return torch.matmul(a, b)
    with mode:
        out = torch.matmul(a, b)
    if isinstance(mode, _Keep):
        mode.cache[-1][2] = out.grad_fn
    return out


def _let_go_unread(cache: list, out: torch.Tensor, inputs: list) -> None:
    """Drop the kept products of a body whose output ``out`` no node of the
    body's graph reads except through :data:`_READS_NOTHING` nodes.  The
    walk stops at the body's ``inputs``."""
    kept = {entry[2]: entry for entry in cache if entry[2] is not None}
    stop = {t.grad_fn for t in inputs}
    readers: dict = {}  # node → the nodes that read its output
    todo = [out.grad_fn]
    while todo:
        node = todo.pop()
        for child, _ in node.next_functions:
            if child is None:
                continue
            if child in readers:
                readers[child].append(node)
            else:  # first met: walk on below it
                readers[child] = [node]
                if child not in stop:
                    todo.append(child)
    for node, entry in kept.items():
        todo, read = [node], False
        while todo and not read:
            for reader in readers.get(todo.pop(), ()):
                if type(reader).__name__ in _READS_NOTHING:
                    todo.append(reader)
                else:
                    read = True
        if not read:
            entry[0] = None


@contextlib.contextmanager
def on_body_entry(hook):
    """Call ``hook(module, x)`` as each layer body starts, with the body's
    first argument (its layer, or a hybrid's group) and its input ``x``;
    the dry run labels the input with the body's label through it."""
    _ENTRY_HOOKS.append(hook)
    try:
        yield
    finally:
        _ENTRY_HOOKS.remove(hook)


def checkpoint_body(fn, module, x: torch.Tensor, *args, remat: bool):
    """``fn(module, x, *args)``: where ``remat``, checkpointed with the
    reference's policy (module docstring), else called as it is."""
    for hook in _ENTRY_HOOKS:
        hook(module, x)
    if not remat:
        return fn(module, x, *args)
    cache: list = []
    out = checkpoint(fn, module, x, *args, use_reentrant=False,
                     context_fn=lambda: (_Phase(_Keep(cache)), _Phase(_Reuse(cache))),
                     preserve_rng_state=False)
    _let_go_unread(cache, out, [x, *(a for a in args if isinstance(a, torch.Tensor))])
    return out


def records(params: torch.nn.Module) -> bool:
    """Whether autograd records a forward of ``params``: grad mode on and a
    parameter requiring grad."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in params.parameters())
