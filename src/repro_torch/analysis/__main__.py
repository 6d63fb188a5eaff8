"""CLI for the static-analysis passes of the port.

    PYTHONPATH=src python -m repro_torch.analysis [--device cuda|cpu]
        [--json PATH] [--strict] [--pass kernels|trace|contracts|markers]

Prints one line a kernel (its shared memory against the budget, the
largest block it takes, and on the card its registers, spills and resident
CTAs), one line a traced variant (host reads per iteration against its
contract), then every finding (suppressed ones with their documented
reason — they stay visible, never hidden).  ``--strict`` exits 1 iff any
*unsuppressed* finding remains.  ``--json`` writes the findings and the
reports.  The kernel and trace passes run on the card; without one the CLI
exits non-zero unless given ``--device cpu``, where the trace cannot see
``tolist()`` and ``numpy()`` reads (``repro_torch.analysis.trace_lint``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis import PASSES, collect, unsuppressed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static contract, trace and shared-memory analysis of the "
                    "port's variants and CUDA kernels")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernel and trace passes run (default cuda)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any unsuppressed finding remains")
    ap.add_argument("--pass", dest="passes", action="append", choices=PASSES,
                    default=None, help="run only the named pass(es); default: all four")
    args = ap.parse_args(argv)

    passes = tuple(args.passes or PASSES)
    if {"kernels", "trace"} & set(passes):
        from repro_torch.device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"repro_torch.analysis: {e}", file=sys.stderr)
            return 2
    findings, reports = collect(args.device, passes)

    for rep in reports.get("kernels", {}).values():
        print(rep.line())
    for rep in reports.get("trace", []):
        print(rep.line())
    hard = unsuppressed(findings)
    for f in findings:
        if f.suppressed:
            print(f"SUPPRESSED [{f.pass_name}] {f.target}: {f.check} — {f.reason}")
        else:
            print(f"FINDING [{f.pass_name}] {f.target}: {f.check} — {f.message}")
    print(f"{len(findings)} finding(s), {len(hard)} unsuppressed, "
          f"passes: {', '.join(sorted(passes))}, device: {args.device}")

    if args.json_path:
        report = {
            "device": args.device,
            "passes": sorted(passes),
            "findings": [f.to_dict() for f in findings],
            "unsuppressed": len(hard),
            "kernels": {k: r.to_dict() for k, r in reports.get("kernels", {}).items()},
            "trace": [r.to_dict() for r in reports.get("trace", [])],
        }
        pathlib.Path(args.json_path).write_text(json.dumps(report, indent=2) + "\n")
        print(f"wrote {args.json_path}")

    return 1 if (args.strict and hard) else 0


if __name__ == "__main__":
    raise SystemExit(main())
