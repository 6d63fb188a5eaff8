"""Run one cell of the port's benchmark on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
compared with the plain reference are the last lines of standard error.
Exits 2, printing no result, without the CUDA cards the cell asks for.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = str(pathlib.Path(__file__).resolve().parent)
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [p for p in sys.path if p != HERE]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc libraries land in build/kernels/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / sub))

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
