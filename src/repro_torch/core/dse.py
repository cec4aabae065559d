"""Kernel configuration record (port of ``repro/core/dse.py::Candidate``).

Only the record and the default the serving path uses are ported.  The
design-space exploration itself (a Hopper cost model in place of the TPU
v5e one) is ROADMAP.md queue 1, item 'DSE on a Hopper model'.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, order=True)
class Candidate:
    """One point in the kernel design space; same fields as the JAX record.

    Only ``compute_unit`` and the dtype change the words.  ``t_block``
    changes how many rows ``prng.stream._round_rows`` launches, never the
    words; ``p`` and ``unroll`` shaped the TPU schedule and have no effect
    on the CUDA kernels.
    """

    i_dim: int = 3
    h_dim: int = 8
    p: int = 1                  # parallelism level; s_block = 128 * 2**p
    compute_unit: str = "vpu"   # 'vpu' | 'mxu'  (paper: LUT | DSP)
    dtype_bytes: int = 4        # 4 = f32, 2 = bf16
    unroll: int = 4
    t_block: int = 128
    n_nodes: int = 1            # lattice nodes (1 = scalar system)


# What JAX ``select_config`` returns for every registered scalar system
# (chen, lorenz, rossler, chua at 3-8-3, hyperlorenz at 4-16-4) at one
# client's 128 lanes, in f32 and bf16: vpu, p=0, unroll 8, t_block 256.
DEFAULT_CONFIG = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu",
                           dtype_bytes=4, unroll=8, t_block=256)


def default_config(i_dim: int, h_dim: int, dtype: torch.dtype) -> Candidate:
    """``DEFAULT_CONFIG`` at a net's dims and the state dtype."""
    return dataclasses.replace(DEFAULT_CONFIG, i_dim=int(i_dim),
                               h_dim=int(h_dim),
                               dtype_bytes=dtype.itemsize)
