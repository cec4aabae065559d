"""Atomic file publication: the write-tmp-then-``os.replace`` discipline
(port of ``repro/atomicio.py``).

Readers of a committed artifact (generated-core sources, report JSON, a
repaired journal) must never observe a torn file.  POSIX ``os.replace``
within one directory is atomic, so the tmp file is created next to its
destination (same filesystem).  A PID suffix keeps concurrent writers from
clobbering each other's tmp files; last replace wins, and every reader
sees one complete version or the other.
"""
from __future__ import annotations

import os
import pathlib


def atomic_write_text(path: str | os.PathLike, text: str, *,
                      encoding: str = "utf-8") -> pathlib.Path:
    """Write ``text`` to ``path`` atomically (tmp sibling + ``os.replace``).

    Parent directories are created if missing.  Returns the final path.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    with open(tmp, "w", encoding=encoding) as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> pathlib.Path:
    """Binary sibling of :func:`atomic_write_text`."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path
