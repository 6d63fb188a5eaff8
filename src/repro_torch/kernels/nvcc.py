"""Build and load the port's CUDA sources.

``nvcc`` compiles one ``.cu`` file into a shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries land in ``build/kernels/`` at the repository root,
named by the library's name and a hash of its source and the flags, so an
edited source is rebuilt and an unchanged one is built once.  Nothing is
compiled at import: each kernel package's ``load`` builds on first use.
Every CUDA source of the port builds here, with one set of flags.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
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


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library of ``source`` lands: ``<stem>_<hash>.so``."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def nvcc_command(source: pathlib.Path, out: pathlib.Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(source)]


def build(source: pathlib.Path) -> tuple[pathlib.Path, str]:
    """Compile ``source`` unless its library is already built; returns the
    library's path and the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel; empty when nothing was compiled).
    Builds of different sources may run at once, from threads."""
    lib = library_path(source)
    if lib.is_file():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(source, pathlib.Path(tmp)),
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr
