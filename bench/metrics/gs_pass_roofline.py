"""kernels: the traced slice's ``gs_pass`` launches (``launch_counts()``)
times the frozen bytes of one launch (``bench.yardstick.gs_pass_bytes``)
over 3.35 TB/s, as a % of the device time of the ``gs_prep`` and
``gs_pass`` kernels in the trace."""
from bench import yardstick


def read(ctx):
    reading, launches = ctx["reading"], ctx["launches"].get("gs_pass", 0)
    if reading is None or not launches:
        return None
    dev_s = reading.kernel_seconds(("gs_prep_kernel", "gs_pass_kernel"), launches)
    if not dev_s:
        return None
    bytes_ = launches * yardstick.gs_pass_bytes(ctx["n_pad"], ctx["m"])
    return 100.0 * bytes_ / yardstick.HBM_BYTES_PER_S / dev_s
