"""Static analysis of the port: checks of the contracts the non-blocking
claim rests on, decidable from the program, its sources and its kernels.
The port's counterpart of the reference's ``repro.analysis``.

Four passes, one CLI (``python -m repro_torch.analysis [--device cuda|cpu]
[--json X] [--strict] [--pass kernels|trace|contracts|markers]``):

- ``kernels`` — shared-memory budgets of the CUDA kernels from a mirror of
  their layouts (largest block of ``gs_pass`` and ``gs_pass_multi``), and
  on the card the built library's registers, spills, shared memory and
  resident CTAs, and the mirror against the library at every block.
- ``trace`` — every registry variant's solve (and the PPR engine's
  ``step_async`` on both backends) under a dispatch mode that records each
  aten op, linted for float64 leaks, foreign device transfers, collectives
  inside ``nosync`` schedules and host reads over the schedule's contract.
- ``contracts`` — registry-metadata vocabulary plus AST verification that
  ``handle_dangling`` flows from each variant's ``run`` into its sweep.
- ``markers`` — pytest tier-marker audit over ``tests/`` + ``pytest.ini``.

Findings are ``(pass, target, check)`` triples; the documented suppression
list in :mod:`repro_torch.analysis.findings` marks reviewed, by-design
findings (printed, never hidden) — ``--strict`` fails only on unsuppressed
ones.  The ``kernels`` and ``trace`` passes run on the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

from repro_torch.analysis.findings import (
    Finding, SUPPRESSIONS, Suppression, apply_suppressions, unsuppressed,
)

__all__ = [
    "Finding", "Suppression", "SUPPRESSIONS", "PASSES", "apply_suppressions",
    "collect", "run_all", "unsuppressed",
]

PASSES = ("kernels", "trace", "contracts", "markers")


def collect(device="cuda", passes=PASSES) -> tuple[list[Finding], dict]:
    """Run ``passes`` (the kernel and trace passes on ``device``) and return
    the suppression-annotated findings and the per-kernel and per-target
    reports (``{"kernels": {name: KernelBudget}, "trace": [TraceReport]}``).
    Imports are deferred: the trace pass builds and solves every variant."""
    findings: list[Finding] = []
    reports: dict = {}
    if "kernels" in passes:
        from repro_torch.analysis.kernels import audit

        found, reports["kernels"] = audit(device)
        findings += found
    if "trace" in passes:
        from repro_torch.analysis.trace_lint import trace_reports

        reports["trace"] = trace_reports(device)
        findings += [f for r in reports["trace"] for f in r.findings]
    if "contracts" in passes:
        from repro_torch.analysis.contracts import contract_findings

        findings += contract_findings()
    if "markers" in passes:
        from repro_torch.analysis.markers import marker_findings

        findings += marker_findings()
    return apply_suppressions(findings), reports


def run_all(device="cuda") -> list[Finding]:
    """Every pass over the real kernels and registry, on ``device``; the
    suppression-annotated findings."""
    return collect(device)[0]
