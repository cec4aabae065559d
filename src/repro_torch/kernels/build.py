"""Build the port's CUDA kernels at first use, from the sources in the repo.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes``.  Such a library builds in seconds; an extension
that includes PyTorch's headers takes minutes, and every fresh checkout
builds anew.  The source's entry groups compile in parallel processes
and link into that one library.  Libraries go to
``build/repro_torch_kernels/`` at the repo root (git-ignored), named by a
hash of source and flags, so a changed source rebuilds and an unchanged
one is reused.

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
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
# the source's entry groups (its CHAOTIC_ANN_PART): one nvcc process each,
# all started together, so the build takes its largest group's time
PARTS = 7


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
                            + repr((COMPILE_FLAGS, PARTS)).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{pathlib.Path(source).stem}.{digest}.so"


def build(source: str = SOURCE) -> str:
    """Compile ``source`` unless it is built already: each entry group into
    an object of its own, in parallel, then one shared library.  Returns
    nvcc's log (``-Xptxas -v``'s registers and shared memory per kernel),
    or ``""`` when the library was reused.
    """
    out = library_path(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    objs = [tmp.with_name(f"{tmp.name}.part{g}.o") for g in range(PARTS)]
    procs = [subprocess.Popen(
        [nvcc, *COMPILE_FLAGS, f"-DCHAOTIC_ANN_PART={g}", "-c", "-o",
         str(obj), str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for g, obj in enumerate(objs)]
    try:
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        failed = [g for g, proc in enumerate(procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {source}, part(s) {failed}:"
                               f"\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        if res.returncode:
            raise RuntimeError(f"linking {source} failed (exit "
                               f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)   # atomic: readers never see half a file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in [tmp, *objs]:
            path.unlink(missing_ok=True)
    return log


def load(source: str = SOURCE) -> ctypes.CDLL:
    """The library of one source, built first if need be (not cached:
    the caller keeps it)."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))
