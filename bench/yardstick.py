"""The frozen numbers of the yardstick: the card's peak, the byte counts of
one launch of each spmv kernel, and of one sweep of the minimal solve.

Every byte count comes from the shapes of the inputs (``n_pad`` rows of the
padded in-CSR, ``m`` edges), each input byte read once and each output byte
written once, never from what the program reports it touched.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM: 3.35 TB/s of HBM3 at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def csr_bytes(n_pad: int, m: int) -> int:
    """The int32 in-CSR: ``n_pad + 1`` row offsets and ``m`` source ids."""
    return F32 * (n_pad + 1) + F32 * m


def spmv_csr_acc_bytes(n_pad: int, m: int) -> int:
    """One ``spmv_csr_acc`` launch (with its ``spmv_carry``): the
    contributions read, the in-CSR, the sums written."""
    return F32 * n_pad + csr_bytes(n_pad, m) + F32 * n_pad


def gs_pass_bytes(n_pad: int, m: int) -> int:
    """One unweighted, unbiased ``gs_pass`` launch (with its ``gs_prep``)
    and no freeze mask: ranks, 1/outdeg and the vertex mask read, the new
    ranks written, the 3 float32 parameters, the in-CSR."""
    return 4 * F32 * n_pad + 3 * F32 + csr_bytes(n_pad, m)


def sweep_bytes(n_pad: int, m: int) -> int:
    """One Jacobi sweep of a global solve at float32: the ranks and 1/outdeg
    read, the new ranks written, the in-CSR."""
    return 3 * F32 * n_pad + csr_bytes(n_pad, m)


def padded(n: int, block: int) -> int:
    """Rows of the in-CSR padded to whole blocks."""
    return -(-n // block) * block
