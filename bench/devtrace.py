"""The device's timeline from a ``torch.profiler`` trace of a slice of the
measured window, and what the per-layer metrics read from it.

The slice runs under the profiler (host and CUDA activities) inside a
``bench.traced`` range; its Chrome trace is written to the run's temporary
directory, read back and deleted.  Device activity is every kernel, copy
and fill; its union over the slice is the busy time.  An idle gap is
named by the innermost host range open at its middle: an op of the
program, a CUDA call, or one of the benchmark's own ranges around its
calls into the program.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE = "bench.traced"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for cut in ("(", "<"):
        if cut in name:
            name = name[:name.index(cut)]
    return name.rsplit("::", 1)[-1] if "::" in name else name


class Slice:
    """Start with :meth:`start`, end with :meth:`stop`; then read it."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._prof = None
        self._range = None
        self.window_s = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + [ProfilerActivity.CUDA] * self._cuda)
        self._prof.start()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def stop(self) -> "Reading":
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return Reading(events, self.window_s)


class Reading:
    """What one traced slice holds: device intervals by kernel, the busy
    union, and the idle gaps by the host range open in each."""

    def __init__(self, events: list[dict], window_s: float):
        self.window_s = window_s
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no bench.traced range")
        lo = float(spans[0]["ts"])
        hi = lo + float(spans[0]["dur"])
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                dev.append((ts, ts + dur, e["name"], cat))
            elif cat in HOST_CATS:
                host.append((ts, ts + dur, e["name"]))
        dev.sort()
        self.kernels: dict[str, list[float]] = defaultdict(list)
        for s, t, name, cat in dev:
            if lo <= s and t <= hi:
                key = short_name(name) if cat == "kernel" else name
                self.kernels[key].append((t - s) * 1e-6)
        merged = []
        for s, t, _, _ in dev:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) * 1e-6
        edges = [lo] + [x for st in merged for x in st] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.idle = self._name_gaps(gaps, host)

    @staticmethod
    def _name_gaps(gaps, host) -> dict[str, float]:
        if not gaps:
            return {}
        mids = np.array([(s + t) / 2 for s, t in gaps])
        label = np.full(len(gaps), -1)
        host.sort(key=lambda h: h[0] - h[1])  # longest first, innermost last
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
        los = np.searchsorted(mids, starts, side="left")
        his = np.searchsorted(mids, ends, side="right")
        for i in np.nonzero(his > los)[0]:
            label[los[i]:his[i]] = i
        idle: dict[str, float] = defaultdict(float)
        for (s, t), i in zip(gaps, label):
            idle["(no host range)" if i < 0 else host[i][2]] += (t - s) * 1e-6
        return idle

    def device_ops(self) -> list[list]:
        """The device operations that took most time, as ``[name, s]``."""
        tot = sorted(((sum(v), k) for k, v in self.kernels.items()), reverse=True)
        return [[k, s] for s, k in tot[:TOP]]

    def idle_gaps(self) -> list[list]:
        """The idle time by the host range open in it, most first."""
        tot = sorted(((s, k) for k, s in self.idle.items()), reverse=True)
        return [[k, s] for s, k in tot[:TOP]]

    def kernel_seconds(self, names: tuple[str, ...], launches: int) -> float | None:
        """Device seconds of ``launches`` launches, each of which runs the
        kernels ``names``.  Where the trace held fewer events of a kernel
        than launches, that kernel counts as the mean of the events held
        times the launches, and a line on standard error says so.  None
        where the trace holds none of them."""
        total = 0.0
        for name in names:
            held = self.kernels.get(name, [])
            if not held or not launches:
                return None
            if len(held) < launches:
                print(f"trace: {len(held)} events of {name} held for {launches} "
                      f"launches counted: the mean of those held stands for "
                      f"each launch", file=sys.stderr, flush=True)
                total += sum(held) / len(held) * launches
            else:
                total += sum(held)
        return total
