"""kernels: the traced slice's ``spmv_csr_acc`` launches
(``launch_counts()``) times the frozen bytes of one launch
(``bench.yardstick.spmv_csr_acc_bytes``) over 3.35 TB/s, as a % of the
device time of the ``spmv_csr_acc`` and ``spmv_carry`` kernels in the
trace."""
from bench import yardstick


def read(ctx):
    reading, launches = ctx["reading"], ctx["launches"].get("spmv_csr_acc", 0)
    if reading is None or not launches:
        return None
    dev_s = reading.kernel_seconds(("spmv_csr_acc_kernel", "spmv_carry_kernel"), launches)
    if not dev_s:
        return None
    bytes_ = launches * yardstick.spmv_csr_acc_bytes(ctx["n_pad"], ctx["m"])
    return 100.0 * bytes_ / yardstick.HBM_BYTES_PER_S / dev_s
