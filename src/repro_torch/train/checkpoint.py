"""Fault-tolerant checkpointing: atomic, keep-K, resume-latest (port of
``repro/train/checkpoint.py``, the same on-disk layout).

Layout:  <dir>/step_<N>/  with one ``leaf_<i>.npy`` per leaf and a
``manifest.json`` holding each leaf's path, file, dtype and shape and the
saved step; bf16 leaves are stored as their uint16 bits.  Leaf paths are
the JAX package's (``repro_torch.tree``): a train state's
``params.blocks.attn.wq`` here is the same leaf as there, so either side
restores what the other saved.  Writes go to a tmp dir followed by an
atomic rename, so a preemption mid-save never corrupts the latest
checkpoint.
"""
from __future__ import annotations

import json
import pathlib
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, map_leaves

PyTree = Any


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array saved, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, dtype=np.int32)     # a step counter
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir, step: int, state: PyTree, keep: int = 3) -> pathlib.Path:
    """Atomic checkpoint save; prunes to the newest ``keep`` checkpoints."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(flatten_with_paths(state)):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "dtype": dtype_name,
             "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish

    steps = sorted(all_steps(ckpt_dir))
    for old in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{old:010d}", ignore_errors=True)
    return final


def all_steps(ckpt_dir) -> List[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / "manifest.json").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(src: pathlib.Path, entry) -> torch.Tensor:
    arr = np.load(src / entry["file"])
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir, like: PyTree, step: Optional[int] = None) -> PyTree:
    """Restore into the structure of ``like``: each tensor leaf on its
    device and in its dtype, each int leaf an int."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((src / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def one(path, like_leaf):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        t = _load(src, by_path[path])
        if isinstance(like_leaf, torch.Tensor):
            want_shape = tuple(like_leaf.shape)
        else:
            want_shape = np.shape(like_leaf)
        if tuple(t.shape) != want_shape:
            raise ValueError(f"shape mismatch for {path}: ckpt "
                             f"{tuple(t.shape)} vs {want_shape}")
        if isinstance(like_leaf, torch.Tensor):
            return t.to(device=like_leaf.device, dtype=like_leaf.dtype)
        return int(t)

    return map_leaves(one, like)
