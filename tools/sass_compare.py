#!/usr/bin/env python3
"""Compares the SASS of the default kernel library built from two
checkouts, kernel by kernel.  Needs nvcc and cuobjdump (a CUDA card is not
needed).

    python3 tools/sass_compare.py ROOT_A ROOT_B [LINES]

Each ROOT is a checkout of the repo; its default library is built there
(``repro_torch.kernels.build.build``, in a process of its own) and
disassembled with ``cuobjdump -sass``.  A kernel's SASS is compared after
dropping what names the build rather than the code: instruction
addresses, encodings, and the anonymous namespace's hash in mangled
names.  Prints how many kernels each library holds, how many are the
same instruction for instruction, and the names of those that differ or
that one library lacks, and up to LINES lines (default 0) of a unified
diff of the first kernel that differs; exits 0 either way.
"""
import difflib
import pathlib
import re
import shutil
import subprocess
import sys
from typing import Dict

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1] + '/src'); "
          "from repro_torch.kernels import build; build.build(); "
          "print(build.library_path())")


def library(root: pathlib.Path) -> pathlib.Path:
    """The default library of the checkout at ``root``, built if need be."""
    out = subprocess.run([sys.executable, "-c", _BUILD, str(root)],
                         capture_output=True, text=True, check=True)
    return pathlib.Path(out.stdout.strip().splitlines()[-1])


def cuobjdump() -> str:
    tool = shutil.which("cuobjdump")
    if tool is None:
        from repro_torch.kernels import build
        tool = str(pathlib.Path(build.nvcc_path()).parent / "cuobjdump")
    return tool


def strip_anon(text: str) -> str:
    """``text`` with every mangled anonymous namespace (``<len>_GLOBAL__N__``
    and the rest of its ``len`` characters, named after the file and the
    build) replaced by ``ANON``."""
    out, i = [], 0
    for m in re.finditer(r"(\d+)_GLOBAL__N__", text):
        if m.start() < i:
            continue
        out.append(text[i:m.start()] + "ANON")
        i = m.start(1) + len(m.group(1)) + int(m.group(1))
    return "".join(out) + text[i:]


def kernels(lib: pathlib.Path) -> Dict[str, str]:
    """{kernel name with the namespace hash dropped: its normalized SASS}."""
    dump = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, name, body = {}, None, []
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = "\n".join(body)
            name = strip_anon(m.group(1))
            body = []
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)     # addresses
        ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins)      # encodings
        ins = strip_anon(ins)
        ins = " ".join(ins.split())
        if name is not None and ins:
            body.append(ins)
    if name is not None:
        out[name] = "\n".join(body)
    return out


def main() -> int:
    a_root, b_root = (pathlib.Path(p).resolve() for p in sys.argv[1:3])
    a, b = kernels(library(a_root)), kernels(library(b_root))
    same = sorted(k for k in a.keys() & b.keys() if a[k] == b[k])
    differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
    print(f"{a_root.name}: {len(a)} kernels; {b_root.name}: {len(b)} kernels;"
          f" in both {len(a.keys() & b.keys())}: {len(same)} the same SASS, "
          f"{len(differ)} not")
    for k in differ:
        print(f"  differs: {k}")
    lines = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    if differ and lines:
        diff = difflib.unified_diff(a[differ[0]].splitlines(),
                                    b[differ[0]].splitlines(), lineterm="",
                                    n=2)
        for line in list(diff)[:lines]:
            print(f"    {line}")
    for k in sorted(a.keys() - b.keys()):
        print(f"  only in {a_root.name}: {k}")
    for k in sorted(b.keys() - a.keys()):
        print(f"  only in {b_root.name}: {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
