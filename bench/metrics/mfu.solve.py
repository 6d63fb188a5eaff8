"""device: the whole solve's share of the card's peak bandwidth, in %: the
Jacobi sweeps that the float64 reference takes to the same stop rule on
this graph, times the frozen bytes of one float32 sweep
(``bench.yardstick.sweep_bytes``), over 3.35 TB/s, over the mean solve
time of the window.  A fixed count of work, whatever the program does."""
from bench import yardstick


def read(ctx):
    bytes_ = ctx["sweeps_ref"] * yardstick.sweep_bytes(ctx["n_pad"], ctx["m"])
    return 100.0 * bytes_ / yardstick.HBM_BYTES_PER_S / ctx["solve_s"]
