"""The counts of a step as eager PyTorch runs it: the port's counterpart
of XLA's ``cost_analysis()`` and ``memory_analysis()``.

:class:`CostMode` is a ``TorchDispatchMode``: every ATen op dispatched
inside it (the port's own ``repro_torch::flash_attention`` included) is
run as usual and counted:

- ``flops``: by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention ops, and the flash op, whose formula
  ``kernels/flash_attention/kernel.py`` registers);
- ``bytes``: each op's distinct tensor inputs read once and its outputs
  written once.  View ops and ops that only allocate or alias
  (:data:`NO_TRAFFIC`) count nothing.  Eager PyTorch fuses nothing, so
  this is the traffic an eager step asks of device memory; an op's own
  re-reads (a matrix product's tiles) are not counted;
- ``peak_bytes``: the most bytes live at once among the storages that ops
  inside the mode created.  A storage counts from the op that made it
  until it is freed (a ``weakref.finalize`` on its Python object, which
  PyTorch keeps while any tensor, autograd's saved ones included, holds
  the storage).  Storages that existed before the mode (parameters,
  inputs) and scratch that kernels allocate and free inside one op
  (cuBLAS workspaces) are not counted;
- ``ops``: the ops dispatched, by name.

Given ``labels`` (storages → the layer body each belongs to, :data:`NONLOOP`
for the rest: a step's parameters, moments, caches and gradients), the
mode also labels every op with a body and records ``trace``, one
``(label, live_bytes)`` after each op, which the dry run's depth
extrapolation of the peak reads
(``repro_torch.launch.dryrun.extrapolate_peak``).  An op takes the label
of the first labelled storage it reads, else the label of the op before.
The caller may add to ``labels`` while the mode runs.

The same mode runs on meta tensors (the dry run's abstract cells, which
allocate nothing) and on CUDA or CPU tensors, so a walk on meta and a run
on the card count alike.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
NONLOOP = -1  # the label of what belongs to no layer body

NO_TRAFFIC = frozenset({
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten._unsafe_view, aten.set_, aten.resize_,
})


def _tensors(*trees) -> list[torch.Tensor]:
    """The distinct tensors of an op's arguments or outputs, in order: the
    tensors among ``trees`` and in their lists, tuples and dict values (an
    ATen op nests no deeper)."""
    out: list[torch.Tensor] = []
    seen: set[int] = set()
    for tree in trees:
        items = tree.values() if isinstance(tree, dict) else (
            tree if isinstance(tree, (list, tuple)) else (tree,))
        for x in items:
            for t in (x if isinstance(x, (list, tuple)) else (x,)):
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
    return out


class CostMode(TorchDispatchMode):
    """Counts ``flops``, ``bytes``, ``peak_bytes`` and ``ops`` of the ops run
    inside it (see the module's docstring).  ``live_bytes`` is what the
    mode's storages hold now."""

    def __init__(self, labels: dict | None = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.peak_bytes = 0
        self.live_bytes = 0
        self.ops: collections.Counter = collections.Counter()
        self.labels = labels
        self.trace: list[tuple[int, int]] = []
        self._live: dict[int, int] = {}  # storage id → bytes
        self._label = NONLOOP

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage from now until it is freed, once."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return
        nbytes = storage.nbytes()
        self._live[key] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._freed, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops[str(packet)] += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        ins, outs = _tensors(args, kwargs), _tensors(out)
        if not (func.is_view or packet in NO_TRAFFIC):
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        in_keys = [t.untyped_storage()._cdata for t in ins]
        new = [t for t in outs if t.untyped_storage()._cdata not in in_keys]  # not views
        for t in new:
            self._track(t)
        if self.labels is not None:
            self._label = next((self.labels[k] for k in in_keys if k in self.labels),
                               self._label)
            self.trace.append((self._label, self.live_bytes))
        return out

    def counts(self) -> dict:
        """``flops``, ``bytes`` and ``peak_bytes`` as plain ints."""
        return {"flops": self.flops, "bytes": self.bytes, "peak_bytes": self.peak_bytes}
