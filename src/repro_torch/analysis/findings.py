"""Finding/suppression vocabulary shared by every static-analysis pass of
the port (a copy of the reference's ``repro.analysis.findings``).

A **finding** is one violated contract, attributed to a ``(pass_name,
target, check)`` triple — ``target`` is the thing analyzed (a kernel name,
a registry variant, a test file) and ``check`` is the machine-readable
contract that failed (``"budget-overflow"``, ``"collective-in-nosync"``,
``"dangling-flow"``, ...).  The triple, not the message, is what the
suppression list matches on, so a suppression survives message rewording.

The **suppression list** is the documented set of findings that are known,
reviewed, and *by design* — e.g. the bounded-staleness distributed modes
legitimately run one exchange of the rank vector per round even though
their registry metadata says ``nosync``.  Every entry carries a reason;
``python -m repro_torch.analysis`` prints suppressed findings with that
reason so they stay visible instead of silently vanishing.  ``--strict``
fails only on *unsuppressed* findings.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass
class Finding:
    """One contract violation reported by a pass."""

    pass_name: str  # "kernels" | "trace" | "contracts" | "markers"
    target: str  # kernel / variant / artifact the finding is about
    check: str  # machine-readable contract key (suppressions match on it)
    message: str  # human-readable explanation
    suppressed: bool = False
    reason: str = ""  # suppression reason, set when suppressed

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A reviewed, by-design finding: matched on (pass_name, target, check)."""

    pass_name: str
    target: str
    check: str
    reason: str


# The one documented suppression list.  Keep entries minimal and justified —
# an unexplained suppression is itself a bug, and --strict treats any
# finding NOT listed here as a failure.  The reference keys these triples on
# its jaxpr pass; the port's counterpart of that pass is the dispatch trace.
SUPPRESSIONS: tuple[Suppression, ...] = (
    Suppression(
        "trace", "distributed_stale", "collective-in-nosync",
        reason="bounded-staleness halo exchange: one all_gather per round is "
               "the design (staleness <= local_sweeps, Lemma 2), plus a pmax "
               "convergence vote — not a per-sweep barrier",
    ),
    Suppression(
        "trace", "distributed_topk", "collective-in-nosync",
        reason="communication-perforated exchange: the per-round top-k "
               "all_gather + pmax residual vote are the published collective, "
               "with the error-feedback ledger bounding staleness",
    ),
) + tuple(
    Suppression(
        "trace", target, "host-reads",
        reason="one read a solve, after the loop: the schedule counts its "
               "sweeps on the device (thread-level No-Sync, whole-block "
               "skips) and solve returns the count as a host int "
               "(core/solver.py::solve, int(state.sweeps)); the reads an "
               "iteration stay at the contract's",
    )
    for target in ("nosync", "nosync_opt", "nosync_sticd", "ppr_nosync",
                   "blocked_adaptive")
)


def apply_suppressions(
    findings: Iterable[Finding],
    suppressions: Iterable[Suppression] = SUPPRESSIONS,
) -> list[Finding]:
    """Mark findings matched by the suppression list; returns the same list.

    Matching is exact on the ``(pass_name, target, check)`` triple — a
    suppression never blankets a whole pass or a whole target.
    """
    index = {(s.pass_name, s.target, s.check): s for s in suppressions}
    out = list(findings)
    for f in out:
        s = index.get((f.pass_name, f.target, f.check))
        if s is not None:
            f.suppressed = True
            f.reason = s.reason
    return out


def unsuppressed(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if not f.suppressed]
