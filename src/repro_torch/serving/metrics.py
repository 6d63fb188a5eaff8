"""Lightweight serving metrics: stage timers, counters, gauges.

A copy of the reference's ``repro.serving.metrics`` (the port imports
nothing of the reference).  One structured bag (:class:`ServingMetrics`)
shared by the serving runtime, the load generator and the launcher —
everything exports through :meth:`ServingMetrics.to_dict`, so the ``serve``
subcommand summary and ``chip_smoke.py`` print the same numbers.

Nothing here touches the device: timers wrap *host*-side stages (admit /
solve / harvest), counters are plain ints, and gauges keep running
mean/max statistics instead of sample lists so a long load run stays O(1)
in memory.
"""
from __future__ import annotations

import dataclasses

__all__ = ["StageTimer", "Gauge", "ServingMetrics"]


@dataclasses.dataclass
class StageTimer:
    """Accumulated wall time of one pipeline stage (host-side)."""

    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        if dt > self.max_s:
            self.max_s = dt

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "total_s": self.total_s,
                "mean_ms": self.mean_ms, "max_ms": 1e3 * self.max_s}


@dataclasses.dataclass
class Gauge:
    """Sampled level (queue depth, slot occupancy): running mean/max."""

    count: int = 0
    total: float = 0.0
    max: float = 0.0

    def sample(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_dict(self) -> dict:
        return {"samples": self.count, "mean": self.mean, "max": self.max}


class ServingMetrics:
    """The runtime's structured metrics bag.

    * ``timers`` — per-stage host wall time: ``admit`` (queue pop → slot
      write), ``solve`` (one engine step of ``iters_per_step`` passes,
      harvest included on the engine side), ``harvest`` (response post-processing + result-cache
      insertion).
    * ``counters`` — monotonically increasing event counts (offered,
      admitted, completed, rejected, expired, cache hits/misses/evictions/
      invalidations, update batches).
    * ``gauges`` — sampled levels: ``queue_depth`` and ``slot_occupancy``
      (fraction of batch rows active), sampled once per pump.
    """

    def __init__(self) -> None:
        self.timers: dict[str, StageTimer] = {
            "admit": StageTimer(), "solve": StageTimer(),
            "harvest": StageTimer(),
        }
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, Gauge] = {
            "queue_depth": Gauge(), "slot_occupancy": Gauge(),
        }

    def incr(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def count(self, name: str) -> int:
        return self.counters.get(name, 0)

    def to_dict(self) -> dict:
        return {
            "timers": {k: t.to_dict() for k, t in self.timers.items()},
            "counters": dict(sorted(self.counters.items())),
            "gauges": {k: g.to_dict() for k, g in self.gauges.items()},
        }

    def summary(self) -> str:
        """One-line human summary for launcher/benchmark stdout."""
        c = self.counters
        q = self.gauges["queue_depth"]
        occ = self.gauges["slot_occupancy"]
        parts = [
            f"offered={c.get('offered', 0)}",
            f"completed={c.get('completed', 0)}",
            f"rejected={c.get('rejected', 0)}",
            f"expired={c.get('expired', 0)}",
            f"cache_hits={c.get('cache_hits', 0)}",
            f"queue_depth mean={q.mean:.1f} max={q.max:.0f}",
            f"occupancy={occ.mean:.0%}",
        ]
        return "  ".join(parts)
