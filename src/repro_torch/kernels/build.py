"""Build the port's CUDA kernels at first use, from the sources in the repo.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes``.  Such a library builds in seconds; an extension
that includes PyTorch's headers takes minutes, and every fresh checkout
builds anew.  The source's entry groups compile in parallel processes
and link into one library.  Libraries go to ``build/repro_torch_kernels/``
at the repo root (git-ignored), named by a hash of source, flags and the
shapes they hold, so a changed source rebuilds and an unchanged one is
reused.

Shapes.  The kernels are templates over the net's shape, and the shapes a
library instantiates are an input of the build: ``nvcc`` compiles a
generated file that defines the source's three shape lists and includes
the source.  ``DEFAULT_SHAPES`` is the one list of the default library's
shapes (the registry's nets and their lattices, built by ``build()``).
Any other shape is compiled from the same source into a shape library of
its own, one shape of one family (``FAMILIES``) and only the entry groups
that launch it, built when first asked for (``build_libraries``, which
builds several at once in parallel) and reused after that.  Every library
is written to a temporary name and renamed, so two processes building the
same one at once both end with a whole file.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCE = "chaotic_ann.cu"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
# the source's entry groups (its CHAOTIC_ANN_PART): one nvcc process each,
# all started together, so the build takes its largest group's time
PARTS = 7
# the source's shape families: the list macro a family's shapes fill, and
# the entry groups that launch them.  scalar: (I, H); lattice (the vpu
# lattice forms): (base I, base H, n_nodes, topology 0 ring / 1 grid);
# mxu: (node I, node H, n_nodes, topology), a scalar core one node.
FAMILIES = {"scalar": ("CHAOTIC_ANN_SHAPES", (0, 1)),
            "lattice": ("LATTICE_SHAPES", (2, 3)),
            "mxu": ("MXU_SHAPES", (4, 5, 6))}
# The default library's shapes: the committed registry weights (3-8 for
# chen, chua, lorenz and rossler, 4-16 for hyperlorenz) and the 3-8 base
# at 8 and 32 nodes, ring and grid, on both units.
DEFAULT_SHAPES = {
    "scalar": ((3, 8), (4, 16)),
    "lattice": ((3, 8, 8, 0), (3, 8, 8, 1), (3, 8, 32, 0), (3, 8, 32, 1)),
    "mxu": ((3, 8, 1, 0), (4, 16, 1, 0), (3, 8, 8, 0), (3, 8, 8, 1),
            (3, 8, 32, 0), (3, 8, 32, 1)),
}

# A shape library's key: (family, dims), dims a tuple of ints as above.
Key = Tuple[str, Tuple[int, ...]]


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


def _spec(key: Optional[Key]):
    """(shapes by family, entry groups, hooks) of the default library
    (``key`` None) or of one shape library."""
    if key is None:
        return DEFAULT_SHAPES, tuple(range(PARTS)), True
    family, dims = key
    return {family: (tuple(dims),)}, FAMILIES[family][1], False


def _shim(source: str, key: Optional[Key]) -> str:
    """The file nvcc compiles for a library: the source's shape lists (and
    whether it holds the check hooks), then the source itself."""
    shapes, _, hooks = _spec(key)
    lines = ["// generated by repro_torch/kernels/build.py: one library's "
             "shapes"]
    for family, (macro, _) in FAMILIES.items():
        xs = " ".join(f"X({', '.join(map(str, dims))})"
                      for dims in shapes.get(family, ()))
        lines.append(f"#define {macro}(X) {xs}".rstrip())
    lines += [f"#define CHAOTIC_ANN_HOOKS {int(hooks)}",
              f'#include "{source}"']
    return "\n".join(lines) + "\n"


def library_path(source: str = SOURCE,
                 key: Optional[Key] = None) -> pathlib.Path:
    """Where the default library (``key`` None) or the shape library of
    ``key`` goes: its name is a hash of source, flags and shapes."""
    _, parts, _ = _spec(key)
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + repr((COMPILE_FLAGS, parts)).encode()
                            + _shim(source, key).encode()).hexdigest()[:12]
    stem = pathlib.Path(source).stem
    if key is not None:
        stem += "." + "-".join([key[0], *map(str, key[1])])
    return BUILD_DIR / f"lib{stem}.{digest}.so"


class _Job:
    """One library's build: its entry groups' nvcc processes, all started
    at once, each logging to a file of its own (a full pipe would stall
    it), then the link."""

    def __init__(self, nvcc: str, source: str, key: Optional[Key]):
        self.key, self.source = key, source
        self.out = library_path(source, key)
        self.tmp = self.out.with_name(f"{self.out.name}.tmp{os.getpid()}")
        self.shim = self.tmp.with_name(f"{self.tmp.name}.cu")
        self.shim.write_text(_shim(source, key))
        _, parts, _ = _spec(key)
        self.parts = parts
        self.objs = [self.tmp.with_name(f"{self.tmp.name}.part{g}.o")
                     for g in parts]
        self.logs = [obj.with_suffix(".log") for obj in self.objs]
        self.procs = []
        for g, obj, log in zip(parts, self.objs, self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [nvcc, *COMPILE_FLAGS, f"-I{CSRC}",
                     f"-DCHAOTIC_ANN_PART={g}", "-c", "-o", str(obj),
                     str(self.shim)], stdout=f, stderr=subprocess.STDOUT))
        self.log = ""

    def compiled(self) -> bool:
        return all(proc.poll() is not None for proc in self.procs)

    def link(self, nvcc: str) -> None:
        self.log = "".join(log.read_text() for log in self.logs)
        failed = [g for g, proc in zip(self.parts, self.procs)
                  if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({self.out.name}), part(s) {failed}:"
                               f"\n{self.log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(self.tmp),
                              *map(str, self.objs)], capture_output=True,
                             text=True)
        if res.returncode:
            raise RuntimeError(f"linking {self.out.name} failed (exit "
                               f"{res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(self.tmp, self.out)   # atomic: readers never see half a file

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in [self.tmp, self.shim, *self.objs, *self.logs]:
            path.unlink(missing_ok=True)


def _build(source: str, keys) -> Dict[Optional[Key], Tuple[float, str]]:
    """Build every library of ``keys`` (None: the default) not built yet,
    all their nvcc processes started together.  Returns, for each library
    built here, its seconds from the start to its rename and nvcc's log
    (``-Xptxas -v``'s registers, shared memory and spills per kernel)."""
    keys = [k for k in dict.fromkeys(keys)
            if not library_path(source, k).exists()]
    if not keys:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs, done = [], {}
    try:
        for key in keys:
            jobs.append(_Job(nvcc, source, key))
        waiting = list(jobs)
        while waiting:
            ready = [job for job in waiting if job.compiled()]
            for job in ready:
                job.link(nvcc)
                done[job.key] = (time.perf_counter() - t0, job.log)
                waiting.remove(job)
            if not ready:
                time.sleep(0.05)
    finally:
        for job in jobs:
            job.close()
    return done


def build(source: str = SOURCE) -> str:
    """Compile the default library of ``source`` unless it is built
    already.  Returns nvcc's log, or ``""`` when the library was reused."""
    done = _build(source, [None])
    return done[None][1] if done else ""


def build_libraries(keys: Iterable[Key], source: str = SOURCE
                    ) -> Dict[Key, Tuple[float, str]]:
    """Compile the shape library of every key not built yet, in parallel:
    {key: (seconds, nvcc's log)} for those built here.  A failed build
    raises with nvcc's log."""
    return _build(source, [(f, tuple(d)) for f, d in keys])


def load(source: str = SOURCE, key: Optional[Key] = None) -> ctypes.CDLL:
    """The default library of one source (or the shape library of
    ``key``), built first if need be (not cached: the caller keeps it)."""
    _build(source, [key])
    return ctypes.CDLL(str(library_path(source, key)))
