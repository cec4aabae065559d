"""Build the port's CUDA kernels at first use, from the sources in the repo.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes``.  Such a library builds in seconds; an extension
that includes PyTorch's headers takes minutes, and every fresh checkout
builds anew.  Libraries go to ``build/repro_torch_kernels/`` at the repo
root (git-ignored), named by a hash of source and flags, so a changed
source rebuilds and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCE = "chaotic_ann.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (not on PATH, no CUDA_HOME/bin/nvcc); "
                       "the CUDA kernels build only where the toolkit is")


def library_path(source: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + repr(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{pathlib.Path(source).stem}.{digest}.so"


def build(source: str = SOURCE) -> str:
    """Compile ``source`` unless it is built already.  Returns nvcc's log
    (``-Xptxas -v``'s registers and shared memory per kernel), or ``""``
    when the library was reused.
    """
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    res = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {res.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: readers never see half a file
    return log


def load(source: str = SOURCE) -> ctypes.CDLL:
    """The library of one source, built first if need be (not cached:
    the caller keeps it)."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))
