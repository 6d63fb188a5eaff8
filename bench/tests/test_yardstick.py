"""The frozen byte formulas, held to the bounds the repo's earlier chip
runs printed from the same formulas (PERF.md's table of kernels)."""
import pytest

from bench import yardstick

LJ = (yardstick.padded(4_847_571, 256), 68_993_773)


def ms(nbytes):
    return 1e3 * nbytes / yardstick.HBM_BYTES_PER_S


def test_padding():
    assert LJ[0] == 18_936 * 256
    assert yardstick.padded(256, 256) == 256 and yardstick.padded(257, 256) == 512


def test_kernel_bounds():
    assert ms(yardstick.gs_pass_bytes(*LJ)) == pytest.approx(0.1113, abs=5e-5)
    assert ms(yardstick.spmv_csr_acc_bytes(*LJ)) == pytest.approx(0.0997, abs=5e-5)
    assert yardstick.csr_bytes(10, 7) == 4 * 11 + 4 * 7


def test_sweep():
    n_pad, m = LJ
    assert yardstick.sweep_bytes(n_pad, m) == 12 * n_pad + 4 * (n_pad + 1) + 4 * m
