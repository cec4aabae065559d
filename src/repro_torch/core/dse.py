"""Kernel configuration record and the gang launch-cost model (port of
``repro/core/dse.py``: ``Candidate`` and ``GangCostModel``).

The design-space exploration itself (``measure_candidate``, the Eq. 8/9
fits, ``select_config``) and ``GangCostModel.fit`` wait for a Hopper model:
ROADMAP.md queue 1, item 6.  ``GangCostModel`` keeps the JAX launch
arithmetic; only its per-step input is a Hopper accounting, and no TPU v5e
constant is carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

LANES = 128
SUBLANES = 8


def _pad(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, order=True)
class Candidate:
    """One point in the kernel design space; same fields as the JAX record.

    Only ``compute_unit`` and the dtype change the words.  ``t_block``
    changes how many rows ``prng.stream._round_rows`` launches and, with
    ``unroll``, the rows a ragged lane-concat gang launch computes
    (``kernels.chaotic_ann.gang_effective_rows``), never the words; ``p``
    (through ``s_block``) lays out the gang's lane blocks and has no other
    effect on the CUDA kernels.
    """

    i_dim: int = 3
    h_dim: int = 8
    p: int = 1                  # parallelism level; s_block = 128 * 2**p
    compute_unit: str = "vpu"   # 'vpu' | 'mxu'  (paper: LUT | DSP)
    dtype_bytes: int = 4        # 4 = f32, 2 = bf16
    unroll: int = 4
    t_block: int = 128
    n_nodes: int = 1            # lattice nodes (1 = scalar system)

    @property
    def s_block(self) -> int:
        return LANES * (2 ** self.p)

    @property
    def i_pad(self) -> int:
        return _pad(self.i_dim, SUBLANES)

    @property
    def h_pad(self) -> int:
        return _pad(self.h_dim, SUBLANES)

    @property
    def dtype_name(self) -> str:
        return {2: "bfloat16", 4: "float32"}[self.dtype_bytes]


# What JAX ``select_config`` returns for every registered scalar system
# (chen, lorenz, rossler, chua at 3-8-3, hyperlorenz at 4-16-4) at one
# client's 128 lanes, in f32 and bf16: vpu, p=0, unroll 8, t_block 256.
DEFAULT_CONFIG = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu",
                           dtype_bytes=4, unroll=8, t_block=256)


def default_config(i_dim: int, h_dim: int, dtype: torch.dtype,
                   n_nodes: int = 1) -> Candidate:
    """``DEFAULT_CONFIG`` at a net's dims and the state dtype; for a
    lattice core (``n_nodes > 1``, ``i_dim``/``h_dim`` its
    lattice-expanded dims) the vpu config with ``n_nodes`` set."""
    return dataclasses.replace(DEFAULT_CONFIG, i_dim=int(i_dim),
                               h_dim=int(h_dim),
                               dtype_bytes=dtype.itemsize,
                               n_nodes=int(n_nodes))


def resolve_config(config, params, dtype: torch.dtype) -> Candidate:
    """The kernel config of a service or engine: ``config`` when given,
    else ``default_config`` at the net's dims.  A lattice core must name
    its config: JAX ``select_config`` searches the vpu and mxu units for
    it, and may pick mxu (at chen@ring32 it does), a word stream of its
    own that the port has no search and no kernel for."""
    if config is not None:
        return config
    if "lattice_meta" in params:
        raise ValueError(
            "a lattice core needs an explicit config=, e.g. "
            "default_config(i_dim, h_dim, dtype, n_nodes=...) for the vpu "
            "stream: the JAX package picks its config by a search that may "
            "choose the mxu unit, whose stream differs")
    return default_config(params["w1"].shape[0], params["w1"].shape[1], dtype)


# ---------------------------------------------------------------------------
# Hopper inputs of the gang cost model (H100 SXM, NVIDIA data sheet).
# ---------------------------------------------------------------------------
CLOCK_HZ = 1.98e9            # SM boost clock: the model's cycle
# Rate of each state dtype outside the tensor cores: every op of a step
# rounds in the state dtype, which tensor cores (f32 accumulators) do not.
PEAK_FLOPS = {4: 67e12, 2: 133.8e12}
# Assumed until ``fit`` measures it (queue 1, item 6): the host side of one
# launch (wrapper checks, the core/row map copy to the card, the ctypes
# call) plus the launch latency, about 20 us.
GANG_LAUNCH_OVERHEAD_CYCLES = 20e-6 * CLOCK_HZ
# Host cost of buffering overdraw: the copy to host memory and the
# per-client numpy buffers of ``absorb``.  Assumed 1 GB/s, the order of
# the served path's measured absorb of 134 MB in 83-434 ms on an H100
# host (PERF.md section 5).
HOST_BUFFER_BYTES_PER_CYCLE = 1e9 / CLOCK_HZ


def step_ops(c: Candidate) -> int:
    """Separate ops of one oscillator step of one lane, each in the state
    dtype: I*H mul+add, H bias, H*I mul+add, I bias."""
    return 4 * c.i_dim * c.h_dim + c.h_dim + c.i_dim


@dataclasses.dataclass
class GangCostModel:
    """Predicts the cost of ONE kernel launch for (membership, per-core
    rows, layout): the estimator the farm's gang planner minimizes over.

        cycles = launch_overhead_cycles
               + sum_over_lane_blocks( 2 * rows_block ) * step_cycles
               + buffered_overdraw_words * 4 / HOST_BUFFER_BYTES_PER_CYCLE

    The launch arithmetic is the JAX model's.  Its per-step input is the
    Hopper one: a step of one ``s_block``-lane block is ``step_ops``
    separate ops per lane at the dtype's published rate outside the tensor
    cores.  A stack of C cores costs C times that, since each core's lanes
    are threads of their own (the TPU swept the C-tall stack in one vreg
    op).  The CUDA kernels have no time grid, so there is no per-cell
    overhead, and K4 masks nothing per row, so a freeze costs nothing.
    The ragged stacked (freeze) layout is still charged the group's max
    rows, as on the TPU, though the CUDA K4 stops a frozen core's threads
    at its demand; ``fit`` (queue 1, item 6) is where measured launches
    will correct these inputs.
    """

    launch_overhead_cycles: float = GANG_LAUNCH_OVERHEAD_CYCLES
    sec_per_cycle: Optional[float] = 1.0 / CLOCK_HZ

    def step_cycles(self, c: Candidate, stack: int = 1) -> float:
        """Cycles for one oscillator step of one s_block-wide lane block
        with ``stack`` cores in one launch."""
        return (step_ops(c) * c.s_block * stack / PEAK_FLOPS[c.dtype_bytes]
                * CLOCK_HZ)

    def launch_cycles(self, c: Candidate, rows_by_block: Sequence[int],
                      *, stack: int = 1) -> float:
        """One launch computing ``rows_by_block[i]`` word rows in lane
        block ``i`` (2 oscillator steps per word row)."""
        steps = 2.0 * float(sum(rows_by_block))
        return (self.launch_overhead_cycles
                + steps * self.step_cycles(c, stack))

    def buffer_cycles(self, overdrawn_words: float) -> float:
        """Host cost of buffering overdraw words nobody asked for yet."""
        return 4.0 * float(overdrawn_words) / HOST_BUFFER_BYTES_PER_CYCLE

    def gang_cost(self, c: Candidate, demands: Sequence[int],
                  blocks: Sequence[int], lanes: Sequence[int], *,
                  layout: str,
                  rows_by_block: Optional[Sequence[int]] = None) -> float:
        """Cost of one gang launch serving members with ``demands`` word
        rows (``blocks``/``lanes`` = per-member lane-block and live-lane
        counts).

        layout 'stacked': the whole group is charged max(demands) rows per
        lane block; a ragged freeze launch (``rows_by_block`` given)
        buffers no overdraw.  layout 'concat': pass ``rows_by_block`` for
        a ragged launch, the per-BLOCK effective rows, ``sum(blocks)``
        long, member ``i`` occupying ``blocks[i]`` consecutive equal
        entries; None means the padded group-max launch.
        """
        dmax = max(demands)
        if layout == "stacked":
            cost = self.launch_cycles(c, [dmax] * blocks[0],
                                      stack=len(demands))
            if rows_by_block is not None:
                over = 0
            else:
                over = sum((dmax - d) * l for d, l in zip(demands, lanes))
        else:
            if rows_by_block is None:
                rows_by_block = [dmax] * sum(blocks)
                per_member = [dmax] * len(demands)
            else:
                # every block of a member computes its demand, so the
                # member's advanced rows are its first block's entry
                starts = np.cumsum([0] + list(blocks[:-1]))
                per_member = [rows_by_block[int(s)] for s in starts]
            over = sum((r - d) * l
                       for r, d, l in zip(per_member, demands, lanes))
            cost = self.launch_cycles(c, rows_by_block)
        return cost + self.buffer_cycles(max(0, over))

    def solo_cost(self, c: Candidate, rows: int, blocks: int) -> float:
        """One per-core launch of ``rows`` word rows over ``blocks`` lane
        blocks."""
        return self.launch_cycles(c, [rows] * blocks)

    def seconds(self, cycles: float) -> Optional[float]:
        return None if self.sec_per_cycle is None else cycles * self.sec_per_cycle
