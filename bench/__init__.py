"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that is one configuration, one traffic mix, one cell or one
per-layer metric is a file of its own, found by its name:

* ``configs/<config>.json``: a graph deployment (sizes, R-MAT parameters,
  block, damping, the guarantees it states);
* ``traffic/<traffic>.json``: a traffic mix, the parameters of one of the
  drivers in ``kinds/``, named by its ``kind``;
* ``workloads/<cell>.json``: the limits of the comparison that decides a
  cell's ``correct``;
* ``metrics/<metric>.py``: a reader of one per-layer metric.

The yardstick (the generators, the float64 reference, the byte formulas,
the trace reading) lives here and never in the program.
"""
