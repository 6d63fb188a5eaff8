#!/usr/bin/env python
"""Peak RSS and walls of the out-of-core build against the in-RAM
``make_dataset``, each in a fresh child process of this small parent.

    python scripts/build_rss.py [--dataset socLiveJournal1] [--scale-down 1]

Runs ``chip_smoke.py``'s RSS child three times on one Table-1 surrogate:
the launcher's ``build --order bfs --stages generate``, its resume (the
BFS reorder and the layout), and ``make_dataset`` of the same graph in
RAM (generation and the CSR sort).  Each child samples its own RSS every
20 ms and reads ``VmHWM`` where ``/proc`` has it; this parent stays small,
so ``ru_maxrss``, which Linux carries over the exec of a forked child
from its parent, measures the child too where the two agree.  Prints one
JSON object a run (``sampled_peak``, ``hwm``, ``maxrss``, ``status``: the
child's ``/proc/self/status`` memory lines at its end, the stage walls
and ``wall_s``) beside ``16 m`` bytes, the int64 edge list; the build
directory, under the checkout's git-ignored ``build/``, is deleted at the
end.  Host work only: no GPU is needed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its RSS child)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/build_rss.py")
    ap.add_argument("--dataset", default="socLiveJournal1")
    ap.add_argument("--scale-down", default="1")
    args = ap.parse_args(argv)
    out = ROOT / "build" / "rss_build"
    shutil.rmtree(out, ignore_errors=True)
    build = ["build", "--dataset", args.dataset, "--scale-down", args.scale_down,
             "--order", "bfs", "--out", str(out)]
    runs = (("build --stages generate", build + ["--stages", "generate"]),
            ("build resume", build),
            ("make_dataset in RAM", ["make_dataset", args.dataset, args.scale_down]))
    try:
        for tag, child_argv in runs:
            rep = chip_smoke.rss_child(child_argv)
            print(json.dumps(dict(run=tag, edge_list_bytes=16 * rep["m"], **rep)),
                  flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
