"""Build and load the CUDA kernels of ``csrc/spmv.cu``.

``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so the build takes
seconds.  The library lands in ``build/kernels/`` at the repository root,
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is built once.  Nothing is compiled at import:
:func:`load` builds on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "spmv.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else ``nvcc`` on ``PATH``; raises ``RuntimeError`` when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"spmv_{digest.hexdigest()[:16]}.so"


def nvcc_command(out: pathlib.Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def build() -> tuple[pathlib.Path, str]:
    """Compile the library unless it is already built; returns its path and
    the compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel; empty when nothing was compiled)."""
    lib = library_path()
    if lib.is_file():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(pathlib.Path(tmp)),
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first
    call; one load per process)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spmv_csr_acc.argtypes = [p, p, p, p, p, i, i, p]
    lib.spmv_csr_acc.restype = i
    lib.gs_pass.argtypes = [p, p, p, p, p, p, p, p, p, i, i, p]
    lib.gs_pass.restype = i
    return lib
