"""Kernel configuration record, the JAX package's config selection and
design-space exploration, and the gang launch-cost model (port of
``repro/core/dse.py``).

``select_config``, the paper flow's ``select`` and ``pareto_front``, and
what they reach (``measure_candidate``, ``vmem_bytes``, the Eq. 8/9 fits
``LatencyModel`` and ``CostModel``, ``enumerate_candidates``,
``_objective_score``) are copied from the JAX package with the TPU v5e
constants they read, renamed ``V5E_*``.  They are not a model of this
card: they are the JAX package's definition of a core's *default stream*
and of the solution its flow generates, so the port selects exactly the
JAX package's ``Candidate``.  Its ``compute_unit`` (and the dtype) decides
the words, and its ``t_block`` how many rows a draw launches, so a port
that chose otherwise would serve other words, or buffer another overdraw,
than the JAX service.  A Hopper tuner (ROADMAP.md queue 1, 'DSE on a
Hopper model') may reshape launches but must keep the selected
``compute_unit``.

``GangCostModel`` keeps the JAX launch arithmetic (across devices too)
with a Hopper step model (the ``CLOCK_HZ``/``PEAK_FLOPS`` inputs below);
its ``fit`` replaces the inputs by terms timed from real launches, as the
JAX ``fit`` does.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# The JAX package's config selection, copied (it defines the default
# stream).  TPU v5e model constants of ``repro/core/dse.py``, read only by
# the selection below; no number here describes this card.
# ---------------------------------------------------------------------------
V5E_CLOCK_HZ = 940e6
V5E_PEAK_BF16_FLOPS = 197e12
V5E_MXU_MACS_PER_CYCLE_BF16 = V5E_PEAK_BF16_FLOPS / 2 / V5E_CLOCK_HZ
V5E_MXU_MACS_PER_CYCLE_F32 = V5E_MXU_MACS_PER_CYCLE_BF16 / 4
V5E_VPU_FMA_VREGS_PER_CYCLE = 4
V5E_HBM_BYTES_PER_CYCLE = 819e9 / V5E_CLOCK_HZ
V5E_VMEM_BYTES = 128 * 2 ** 20
V5E_VMEM_USABLE = int(V5E_VMEM_BYTES * 0.75)
V5E_GRID_STEP_OVERHEAD_CYCLES = 500.0
V5E_LOOP_ITER_OVERHEAD_CYCLES = 8.0


def _overhead_share(c: Candidate) -> float:
    """Per-step control-overhead share of a candidate's (t_block, unroll):
    part of the cycle oracle below and the tie-break of ``select_config``
    (the Eq. 8 estimator is blind to these two knobs)."""
    return (V5E_GRID_STEP_OVERHEAD_CYCLES / c.t_block
            + V5E_LOOP_ITER_OVERHEAD_CYCLES / c.unroll)


def measure_candidate(c: Candidate) -> Dict[str, float]:
    """Microarchitectural cycle/byte accounting for one oscillator step of a
    full stream block, plus the VMEM working set.  Deterministic; this plays
    the role of the paper's post-synthesis Vivado report."""
    vregs = lambda rows, cols: (_pad(rows, SUBLANES) // SUBLANES) * (_pad(cols, LANES) // LANES)

    if c.compute_unit == "vpu":
        # h accumulate: i_dim FMAs over (h_pad, s_block); activation: 1 pass;
        # y accumulate: h_dim FMAs over (i_pad, s_block); bias adds: 2 passes.
        fma_vregs = (
            c.i_dim * vregs(c.h_pad, c.s_block)
            + vregs(c.h_pad, c.s_block)
            + c.h_dim * vregs(c.i_pad, c.s_block)
            + vregs(c.h_pad, c.s_block) + vregs(c.i_pad, c.s_block)
        )
        if c.n_nodes > 1:
            # Block-sparse diffusive coupling: the kernel applies it as
            # wrapped rolls + boundary selects + the scaled accumulate
            # over the (i_pad, s_block) state — ~10 elementwise passes
            # for a ring (grid pays ~2x; model the ring floor), NOT an
            # n_nodes^2 matmul.
            fma_vregs += 10 * vregs(c.i_pad, c.s_block)
        compute_cycles = fma_vregs / V5E_VPU_FMA_VREGS_PER_CYCLE
    else:
        macs_per_cycle = (V5E_MXU_MACS_PER_CYCLE_BF16 if c.dtype_bytes == 2
                          else V5E_MXU_MACS_PER_CYCLE_F32)
        # Both matmuls pad contraction + one free dim to 128 on the MXU.
        macs = (_pad(c.i_pad, 128) * _pad(c.h_pad, 128) * c.s_block
                + _pad(c.h_pad, 128) * _pad(c.i_pad, 128) * c.s_block)
        extra_vpu = 0.0
        if c.n_nodes > 1:
            # The coupling operator is one more genuinely MXU-shaped
            # contraction: (i_pad x i_pad) @ (i_pad x s_block).  The
            # operator is block-sparse (nearest-neighbour blocks only),
            # but the block-sparse route already did its work upstream —
            # the lattice state is n_nodes x base_dim, not n_nodes^2, so
            # a single 128-padded pass covers it.
            macs += _pad(c.i_pad, 128) * _pad(c.i_pad, 128) * c.s_block
            extra_vpu = vregs(c.i_pad, c.s_block)   # the += into y
        # activation + biases still run on the VPU
        vpu_cycles = (vregs(c.h_pad, c.s_block) * 2 + vregs(c.i_pad, c.s_block)
                      + extra_vpu) / V5E_VPU_FMA_VREGS_PER_CYCLE
        compute_cycles = macs / macs_per_cycle + vpu_cycles

    # HBM traffic per step: the trajectory write-out (state never leaves VMEM).
    hbm_bytes_per_step = c.i_pad * c.s_block * c.dtype_bytes
    memory_cycles = hbm_bytes_per_step / V5E_HBM_BYTES_PER_CYCLE

    # Per-step share of control overheads (shared with the DSE tie-break).
    overhead = _overhead_share(c)

    cycles_per_step = max(compute_cycles, memory_cycles) + overhead
    # Paper-comparable "iteration latency": cycles for one oscillator update
    # of ONE stream (the FPGA implements exactly one oscillator).
    per_stream_cycles = cycles_per_step / c.s_block

    vmem = vmem_bytes(c)
    return {
        "cycles_per_step": cycles_per_step,
        "per_stream_latency_cycles": per_stream_cycles,
        "compute_cycles": compute_cycles,
        "memory_cycles": memory_cycles,
        "overhead_cycles": overhead,
        "vmem_bytes": float(vmem),
        "samples_per_sec": c.s_block / cycles_per_step * V5E_CLOCK_HZ,
        "fits_vmem": float(vmem <= V5E_VMEM_USABLE),
    }


def vmem_bytes(c: Candidate) -> int:
    """Closed-form VMEM working set of the kernel instance (the cost)."""
    d = c.dtype_bytes
    weights = (c.i_pad * c.h_pad + c.h_pad + c.h_pad * c.i_pad + c.i_pad) * d
    if c.n_nodes > 1 and c.compute_unit == "mxu":
        weights += c.i_pad * c.i_pad * d     # resident coupling operator
    state = c.i_pad * c.s_block * d          # scratch carry
    hidden = c.h_pad * c.s_block * d * c.unroll   # live h per unrolled step
    x0_blk = c.i_pad * c.s_block * d
    out_blk = 2 * c.t_block * c.i_pad * c.s_block * d   # double-buffered
    return weights + state + hidden + x0_blk + out_blk


@dataclasses.dataclass
class LatencyModel:
    """Latency = (I·H) · (b3·P³ + b2·P² + b1·P + b0)   (paper Eq. 8).

    Separate coefficient tables per (compute_unit, dtype) — the paper keeps
    separate tables for DSP vs no-DSP."""

    coeffs: Dict[Tuple[str, int], np.ndarray] = dataclasses.field(default_factory=dict)

    @staticmethod
    def fit(p_levels: Sequence[int] = range(0, 6),
            sizes: Sequence[Tuple[int, int]] = ((3, 4), (3, 8), (3, 16), (4, 8), (4, 16)),
            units: Sequence[str] = ("vpu", "mxu"),
            dtypes: Sequence[int] = (4, 2)) -> "LatencyModel":
        """Paper §III-B.2: measure a range of solutions, normalize latency by
        I·H, average per P, then fit a degree-3 polynomial in P."""
        model = LatencyModel()
        for unit, dt in itertools.product(units, dtypes):
            norm_by_p = []
            for p in p_levels:
                vals = []
                for (i, h) in sizes:
                    m = measure_candidate(Candidate(i_dim=i, h_dim=h, p=p,
                                                    compute_unit=unit, dtype_bytes=dt))
                    vals.append(m["per_stream_latency_cycles"] / (i * h))
                norm_by_p.append(np.mean(vals))
            model.coeffs[(unit, dt)] = np.polyfit(np.asarray(list(p_levels), dtype=np.float64),
                                                  np.asarray(norm_by_p), deg=3)
        return model

    def predict(self, i_dim: int, h_dim: int, p: int,
                compute_unit: str = "vpu", dtype_bytes: int = 4) -> float:
        b = self.coeffs[(compute_unit, dtype_bytes)]
        return float((i_dim * h_dim) * np.polyval(b, float(p)))


def enumerate_candidates(i_dim: int, h_dim: int,
                         p_levels: Sequence[int] = range(0, 6),
                         units: Sequence[str] = ("vpu", "mxu"),
                         dtypes: Sequence[int] = (4, 2),
                         unrolls: Sequence[int] = (1, 2, 4, 8),
                         t_blocks: Sequence[int] = (32, 64, 128, 256),
                         n_nodes: int = 1) -> List[Candidate]:
    out = []
    for p, u, d, un, tb in itertools.product(p_levels, units, dtypes, unrolls, t_blocks):
        c = Candidate(i_dim=i_dim, h_dim=h_dim, p=p, compute_unit=u,
                      dtype_bytes=d, unroll=un, t_block=tb, n_nodes=n_nodes)
        if vmem_bytes(c) <= V5E_VMEM_USABLE:
            out.append(c)
    return out


@dataclasses.dataclass
class CostModel:
    """#VMEM-bytes = c1·I·H + c2·I + c3·H + β, per parallelism level
    (paper Eq. 9, with a per-P constant table)."""

    coeffs: Dict[Tuple[int, str, int], np.ndarray] = dataclasses.field(default_factory=dict)

    @staticmethod
    def fit(p_levels: Sequence[int] = range(0, 6),
            i_range: Sequence[int] = (2, 3, 4, 6, 8),
            h_range: Sequence[int] = (4, 8, 12, 16, 24, 32),
            units: Sequence[str] = ("vpu", "mxu"),
            dtypes: Sequence[int] = (4, 2)) -> "CostModel":
        model = CostModel()
        for p, unit, dt in itertools.product(p_levels, units, dtypes):
            rows, ys = [], []
            for i, h in itertools.product(i_range, h_range):
                c = Candidate(i_dim=i, h_dim=h, p=p, compute_unit=unit, dtype_bytes=dt)
                rows.append([i * h, i, h, 1.0])
                ys.append(float(vmem_bytes(c)))
            sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(ys), rcond=None)
            model.coeffs[(p, unit, dt)] = sol
        return model

    def predict(self, i_dim: int, h_dim: int, p: int,
                compute_unit: str = "vpu", dtype_bytes: int = 4) -> float:
        c1, c2, c3, beta = self.coeffs[(p, compute_unit, dtype_bytes)]
        return float(c1 * i_dim * h_dim + c2 * i_dim + c3 * h_dim + beta)


def _objective_score(c: Candidate, i_dim: int, h_dim: int,
                     lm: LatencyModel, cm: Optional[CostModel] = None,
                     objective: str = "min_latency") -> Tuple[float, ...]:
    """The shared selection key: (primary estimate, objective-true ties).

    min_latency: (latency estimate, overhead share).  lowest_cost: (cost
    estimate, the measured VMEM working set, overhead share): the
    estimator is blind to (t_block, unroll), the real footprint is not.

    Lattice candidates (``n_nodes > 1``) score on the extended cycle
    model directly: the Eq. 8/9 estimators were fitted on scalar-core
    sizes (I<=8, H<=32) and normalize per I*H, so extrapolating them to
    lattice dims would erase the block-sparse compute-unit tradeoff the
    lattice arms of ``measure_candidate`` encode.
    """
    if c.n_nodes > 1:
        m = measure_candidate(c)
        if objective == "min_latency":
            return (m["per_stream_latency_cycles"], _overhead_share(c))
        if objective == "lowest_cost":
            return (m["vmem_bytes"], _overhead_share(c))
        raise ValueError(f"unknown objective {objective!r}")
    if objective == "min_latency":
        primary = lm.predict(i_dim, h_dim, c.p, c.compute_unit, c.dtype_bytes)
        return (primary, _overhead_share(c))
    if objective == "lowest_cost":
        primary = cm.predict(i_dim, h_dim, c.p, c.compute_unit, c.dtype_bytes)
        return (primary, float(vmem_bytes(c)), _overhead_share(c))
    raise ValueError(f"unknown objective {objective!r}")


def pareto_front(cands: Sequence[Candidate],
                 latency_model: Optional[LatencyModel] = None,
                 cost_model: Optional[CostModel] = None
                 ) -> List[Tuple[Candidate, float, float]]:
    """Non-dominated (cost, latency) set, using the *estimators* (the
    paper's DSE runs entirely on Eq. 8/9 estimates).  Candidates tied on
    (cost, latency) are represented by the lowest-overhead one."""
    scored = []
    for c in cands:
        if latency_model is not None:
            lat = latency_model.predict(c.i_dim, c.h_dim, c.p, c.compute_unit, c.dtype_bytes)
            cost = cost_model.predict(c.i_dim, c.h_dim, c.p, c.compute_unit, c.dtype_bytes)
        else:
            m = measure_candidate(c)
            lat, cost = m["per_stream_latency_cycles"], m["vmem_bytes"]
        scored.append((c, cost, lat))
    front = []
    for c, cost, lat in sorted(scored,
                               key=lambda t: (t[1], t[2], _overhead_share(t[0]))):
        if all(not (fc <= cost and fl <= lat) for _, fc, fl in front):
            front.append((c, cost, lat))
    return front


def select(i_dim: int, h_dim: int, mode: str = "pareto",
           p: Optional[int] = None,
           latency_model: Optional[LatencyModel] = None,
           cost_model: Optional[CostModel] = None,
           n_nodes: int = 1) -> Candidate:
    """The paper's three user options: 'min_latency', 'lowest_cost', or
    'pareto' with requested parallelism P."""
    lm = latency_model or LatencyModel.fit()
    cm = cost_model or CostModel.fit()
    cands = enumerate_candidates(i_dim, h_dim, n_nodes=n_nodes)
    if mode in ("min_latency", "lowest_cost"):
        return min(cands,
                   key=lambda c: _objective_score(c, i_dim, h_dim, lm, cm, mode))
    if mode == "pareto":
        front = pareto_front(cands, lm, cm)
        if p is not None:
            match = [c for c, _, _ in front if c.p == p]
            if match:
                return match[0]
            return min((c for c, _, _ in front), key=lambda c: abs(c.p - p))
        return front[len(front) // 2][0]
    raise ValueError(f"unknown mode {mode!r}")


_DTYPE_BYTES = {torch.float32: 4, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _fitted_latency_model() -> LatencyModel:
    """The Eq. 8 estimator, fitted once per process (~ms; pure numpy)."""
    return LatencyModel.fit()


@functools.lru_cache(maxsize=None)
def select_config(i_dim: int, h_dim: int, s_total: Optional[int] = None,
                  dtype: torch.dtype = torch.float32,
                  unit: Optional[str] = None, n_nodes: int = 1) -> Candidate:
    """Pick (s_block, t_block, unroll, compute_unit) for a kernel launch,
    as the JAX package's ``select_config`` does with its default
    min_latency objective: score the enumerated design space with the
    fitted Eq. 8 estimator, breaking ties with the analytic per-step
    overhead the estimator normalizes away.

    Args:
      s_total: number of streams the caller will actually launch; candidates
        whose stream block exceeds the padded stream count are dropped (they
        would only compute padding lanes).
      dtype: the state dtype, ``torch.float32`` or ``torch.bfloat16``.
      unit: restrict to 'vpu' or 'mxu'; None searches both.
    """
    dt = _DTYPE_BYTES.get(dtype)
    if dt is None:
        raise ValueError(f"unknown dtype {dtype!r}")
    units = (unit,) if unit else ("vpu", "mxu")
    cands = enumerate_candidates(i_dim, h_dim, units=units, dtypes=(dt,),
                                 n_nodes=n_nodes)
    if s_total is not None:
        # p=0 (s_block=128) always fits the cap, so this never empties cands.
        s_cap = max(LANES, _pad(s_total, LANES))
        cands = [c for c in cands if c.s_block <= s_cap]
    if not cands:
        raise ValueError(f"no feasible candidate for I={i_dim} H={h_dim}")
    lm = _fitted_latency_model()
    return min(cands, key=lambda c: _objective_score(c, i_dim, h_dim, lm))


def default_config(i_dim: int, h_dim: int, dtype: torch.dtype,
                   n_nodes: int = 1) -> Candidate:
    """The vpu config the JAX package selects for one client's 128 lanes
    (vpu, p=0, unroll 8, t_block 256 at every committed system and
    lattice), for callers that name the vpu stream; for a lattice core
    ``i_dim``/``h_dim`` are its lattice-expanded dims."""
    return select_config(int(i_dim), int(h_dim), s_total=LANES, dtype=dtype,
                         unit="vpu", n_nodes=int(n_nodes))


def resolve_config(config, params, dtype: torch.dtype,
                   s_total: Optional[int] = None) -> Candidate:
    """The kernel config of a service or engine: ``config`` when given,
    else what the JAX package picks for the same core: ``select_config``
    at the net's dims, ``dtype``, the lattice's node count and the
    caller's ``s_total`` (the engine passes its ``n_streams``, the service
    its ``lanes_per_client``, as the JAX callers do)."""
    if config is not None:
        return config
    n_nodes = 1
    if "lattice_meta" in params:
        from repro_torch.core.ann import lattice_meta_tuple
        n_nodes = lattice_meta_tuple(params["lattice_meta"])[0]
    i_dim, h_dim = params["w1"].shape[-2:]
    return select_config(int(i_dim), int(h_dim), s_total=s_total,
                         dtype=dtype, n_nodes=n_nodes)


# ---------------------------------------------------------------------------
# Hopper inputs of the gang cost model (H100 SXM, NVIDIA data sheet).
# ---------------------------------------------------------------------------
CLOCK_HZ = 1.98e9            # SM boost clock: the model's cycle
# Rate of each state dtype outside the tensor cores: every op of a step
# rounds in the state dtype, which tensor cores (f32 accumulators) do not.
PEAK_FLOPS = {4: 67e12, 2: 133.8e12}
# Assumed until ``fit`` measures it: the host side of one launch (wrapper
# checks, the core/row map copy to the card, the ctypes call) plus the
# launch latency, about 20 us.
GANG_LAUNCH_OVERHEAD_CYCLES = 20e-6 * CLOCK_HZ
# Assumed until ``fit(mesh=...)`` measures it: each device past the first
# of a sharded launch is one more wrapper call and launch from the host
# (the shards launch one after another), so about one launch's host side.
CROSS_DEV_OVERHEAD_CYCLES = GANG_LAUNCH_OVERHEAD_CYCLES
# ``fit``'s long launches run this many times the short one's steps: a
# synchronised call's host wall jitters by tens of microseconds, and 2x
# the steps of a CTA (the JAX fit's t2) adds about as much, so the long
# launch puts some 15 times that over the jitter.
FIT_STRETCH = 16
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
    rows, layout, device count): the estimator the farm's gang planner
    minimizes over.

        cycles = launch_overhead_cycles
               + cross_dev_overhead_cycles * (n_dev - 1)
               + cell_overhead_cycles * cells
               + 2 * rows(busiest device's shard) * step_cycles
               (+ freeze_row_cycles per row of a ragged stacked launch)
               + buffered_overdraw_words * 4 / HOST_BUFFER_BYTES_PER_CYCLE

    The launch arithmetic is the JAX model's, ``n_dev`` included: a
    sharded launch's lane blocks split into contiguous runs of
    ``ceil(blocks / n_dev)`` a device, the step and cell terms follow the
    busiest device's shard, and each device past the first adds
    ``cross_dev_overhead_cycles``.  Its per-step input is the Hopper one:
    a step of one ``s_block``-lane block is ``step_ops`` separate ops per
    lane at the dtype's published rate outside the tensor cores, and a
    stack of C cores costs C times that (times ``stacked_step_scale``),
    since each core's lanes are threads of their own (the TPU swept the
    C-tall stack in one vreg op).

    The defaults leave every one-device plan as the Hopper step model
    alone makes it: the CUDA kernels have no time grid, so no per-cell
    overhead (0); a stack is C single cores (scale 1); K4 masks nothing
    per row, so a freeze costs nothing (0).  The ragged stacked (freeze)
    layout is still charged the group's max rows, as on the TPU, though
    the CUDA K4 stops a frozen core's threads at its demand.  ``fit``
    replaces these inputs by terms timed from real launches (all but the
    cell overhead, which stays 0 with no grid to time).  Like the
    JAX model, it does not price the activation: a tanh or sigmoid group
    is priced at relu's ``step_ops`` (107 ops a 3-8-3 step, against 307 /
    347).  A plan shapes launches only; it never changes words.
    """

    launch_overhead_cycles: float = GANG_LAUNCH_OVERHEAD_CYCLES
    cell_overhead_cycles: float = 0.0
    stacked_step_scale: float = 1.0
    freeze_row_cycles: float = 0.0
    cross_dev_overhead_cycles: float = CROSS_DEV_OVERHEAD_CYCLES
    sec_per_cycle: Optional[float] = 1.0 / CLOCK_HZ

    def step_cycles(self, c: Candidate, stack: int = 1) -> float:
        """Cycles for one oscillator step of one s_block-wide lane block
        with ``stack`` cores in one launch."""
        scale = self.stacked_step_scale if stack > 1 else 1.0
        return (step_ops(c) * c.s_block * stack / PEAK_FLOPS[c.dtype_bytes]
                * CLOCK_HZ * scale)

    def launch_cycles(self, c: Candidate, rows_by_block: Sequence[int],
                      *, stack: int = 1, n_dev: int = 1) -> float:
        """One launch computing ``rows_by_block[i]`` word rows in lane
        block ``i`` (2 oscillator steps per word row); cell overhead
        counts the max(rows)-deep grid of ``t_block // 2``-row cells for
        every block, as the JAX model does.  ``n_dev > 1`` models the
        sharded launch: the step and cell terms follow the busiest
        device's contiguous run of ``ceil(blocks / n_dev)`` blocks, and
        each extra device adds ``cross_dev_overhead_cycles``."""
        n_dev = max(1, int(n_dev))
        rows_per_cell = max(1, c.t_block // 2)
        t_cells = max(1, -(-int(max(rows_by_block)) // rows_per_cell))
        blocks_local = -(-len(rows_by_block) // n_dev)
        if n_dev > 1:
            rb = list(rows_by_block)
            steps = 2.0 * float(max(
                sum(rb[d * blocks_local:(d + 1) * blocks_local])
                for d in range(n_dev)))
        else:
            steps = 2.0 * float(sum(rows_by_block))
        return (self.launch_overhead_cycles
                + self.cross_dev_overhead_cycles * (n_dev - 1)
                + self.cell_overhead_cycles * blocks_local * t_cells
                + steps * self.step_cycles(c, stack))

    def buffer_cycles(self, overdrawn_words: float) -> float:
        """Host cost of buffering overdraw words nobody asked for yet."""
        return 4.0 * float(overdrawn_words) / HOST_BUFFER_BYTES_PER_CYCLE

    def gang_cost(self, c: Candidate, demands: Sequence[int],
                  blocks: Sequence[int], lanes: Sequence[int], *,
                  layout: str, rows_by_block: Optional[Sequence[int]] = None,
                  n_dev: int = 1) -> float:
        """Cost of one gang launch serving members with ``demands`` word
        rows (``blocks``/``lanes`` = per-member lane-block and live-lane
        counts) on ``n_dev`` devices.

        layout 'stacked': the whole group is charged max(demands) rows per
        lane block; a ragged freeze launch (``rows_by_block`` given)
        buffers no overdraw but pays ``freeze_row_cycles`` a row and lane
        block, split across the devices.  layout 'concat': pass
        ``rows_by_block`` for a ragged launch, the per-BLOCK effective
        rows, ``sum(blocks)`` long, member ``i`` occupying ``blocks[i]``
        consecutive equal entries; None means the padded group-max launch.
        """
        dmax = max(demands)
        if layout == "stacked":
            cost = self.launch_cycles(c, [dmax] * blocks[0],
                                      stack=len(demands), n_dev=n_dev)
            if rows_by_block is not None:
                cost += (self.freeze_row_cycles * dmax * blocks[0]
                         / max(1, n_dev))
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
            cost = self.launch_cycles(c, rows_by_block, n_dev=n_dev)
        return cost + self.buffer_cycles(max(0, over))

    def solo_cost(self, c: Candidate, rows: int, blocks: int, *,
                  n_dev: int = 1) -> float:
        """One per-core launch of ``rows`` word rows over ``blocks`` lane
        blocks (``n_dev``: the pool's own sharded launch on a mesh)."""
        return self.launch_cycles(c, [rows] * blocks, n_dev=n_dev)

    def seconds(self, cycles: float) -> Optional[float]:
        return None if self.sec_per_cycle is None else cycles * self.sec_per_cycle

    @classmethod
    def fit(cls, c: Candidate, *, device="cuda", n_cores: int = 3,
            lanes: int = 16_384, reps: int = 3, clock=None,
            mesh=None) -> "GangCostModel":
        """Calibrate the model's terms from real launches of candidate
        ``c`` on ``device``, after the JAX ``fit``.

        Every launch runs pools of ``lanes`` lanes (rounded up to whole
        ``s_block`` blocks; by default a farm core's pool of 128 clients
        of 128 lanes), since a card runs a launch's blocks side by side:
        the cost of a block's step is only linear in the blocks at a pool
        size near the one served.  With ``rows = max(4, t_block // 2)``
        word rows, ``steps = 2 * rows``, ``B`` blocks and ``k =
        FIT_STRETCH``:
          t1  solo launch (K1) of ``rows`` rows
          t2  the same launch, k x the steps
          t4  stacked gang (K4) of ``n_cores`` such pools, k x the steps
          t5  the same stacked launch with a skewed row map (freeze)
        so  step_sec = (t2 - t1) / ((k - 1) * steps * B),  launch_sec =
        t1 - steps * B * step_sec, t4 gives the stacked step scale and
        t5 - t4 the freeze cost of a row and block, each clipped as in the
        JAX model; ``t2 <= t1`` (timing noise) returns the defaults.  The
        JAX fit's t2 is 2x the steps; k is larger so that the steps, not
        the host's jitter, make the difference.  The JAX ``t3`` (the same
        steps in two cells of a halved ``t_block``) has no counterpart:
        the CUDA kernels have no time grid, so ``cell_overhead_cycles``
        stays 0.

        With a ``mesh`` of more than one entry, t6, a lane-concat gang
        (K3) of one ``lanes`` pool per entry sharded across the mesh,
        calibrates ``cross_dev_overhead_cycles``: each entry does t1's
        work, so the residual over t1 split across the extra entries is
        the per-device fee (on a mesh that repeats one card, the shards'
        serialization on its stream).

        Each measurement is the median of ``reps`` timed calls after one
        untimed call, read on ``clock`` (``repro_torch.clock.SystemClock``
        by default) around launches that end in ``torch.cuda.synchronize``
        of every card they ran on; t1 and t2, and t4 and t5, alternate
        call by call, so a drift of the card's clocks reaches both.
        ``device="cpu"`` times the plain versions.  Weights and states are
        seeded draws (numpy seed 0).
        """
        from repro_torch.clock import SystemClock
        from repro_torch.device import resolve_device
        from repro_torch.kernels import ops  # lazy: keep dse importable alone

        clock = clock or SystemClock()
        dev = resolve_device(device)
        cards = {d for d in ((dev,) + (() if mesh is None else mesh.devices))
                 if d.type == "cuda"}
        base = cls()
        rng = np.random.default_rng(0)
        dtype = torch.bfloat16 if c.dtype_bytes == 2 else torch.float32
        n_blocks = max(1, -(-int(lanes) // c.s_block))
        pool = n_blocks * c.s_block

        def draw(scale, shape):
            return torch.as_tensor(rng.normal(0, scale, shape),
                                   dtype=torch.float32).to(dev, dtype)

        def mk_params():
            return {"w1": draw(.4, (c.i_dim, c.h_dim)),
                    "b1": draw(.1, (c.h_dim,)),
                    "w2": draw(.4, (c.h_dim, c.i_dim)),
                    "b2": draw(.1, (c.i_dim,))}

        def sync():
            for card in cards:
                torch.cuda.synchronize(card)

        def timed(*fns):
            """Median seconds of each of ``fns``, called in turn."""
            for fn in fns:
                fn()                               # builds, caches
            sync()
            ts = [[] for _ in fns]
            for _ in range(reps):
                for t, fn in zip(ts, fns):
                    t0 = clock.now()
                    fn()
                    sync()
                    t.append(clock.now() - t0)
            return [sorted(t)[len(t) // 2] for t in ts]

        params = mk_params()
        x0 = draw(.3, (pool, c.i_dim))
        rows = max(4, c.t_block // 2)
        steps, long_steps = 2 * rows, 2 * rows * FIT_STRETCH
        t1, t2 = timed(
            lambda: ops.chaotic_bits(params, x0, steps, config=c),
            lambda: ops.chaotic_bits(params, x0, long_steps, config=c))
        if t2 <= t1:                              # timing noise: keep defaults
            return base
        step_sec = (t2 - t1) / ((long_steps - steps) * n_blocks)
        launch_sec = max(0.0, t1 - steps * n_blocks * step_sec)
        spc = step_sec / base.step_cycles(c)
        overhead = float(np.clip(launch_sec / spc, 500.0, 5e8))
        scale, freeze = 1.0, cls.freeze_row_cycles
        if c.compute_unit == "vpu":
            plist = [mk_params() for _ in range(n_cores)]
            stacked = {k: torch.stack([p[k] for p in plist])
                       for k in ("w1", "b1", "w2", "b2")}
            xs = draw(.3, (n_cores, pool, c.i_dim))
            long_rows = long_steps // 2
            skew_map = np.asarray(
                [long_rows] + [min(long_rows, 4)] * (n_cores - 1), np.int32)
            t4, t5 = timed(
                lambda: ops.chaotic_bits_gang_stacked(
                    stacked, xs, long_steps, config=c),
                lambda: ops.chaotic_bits_gang_stacked(
                    stacked, xs, long_steps, row_map=skew_map, config=c))
            st_step_sec = (max(1e-12, t4 - launch_sec)
                           / (long_steps * n_blocks))
            sweep = base.step_cycles(c) * n_cores
            scale = float(np.clip(st_step_sec / spc / sweep, 0.1, 4.0))
            freeze = float(np.clip((t5 - t4) / (long_rows * n_blocks) / spc,
                                   cls.freeze_row_cycles, 5e7))
        cross = cls.cross_dev_overhead_cycles
        if mesh is not None and len(mesh.devices) > 1:
            n_dev = len(mesh.devices)
            plist = [mk_params() for _ in range(n_dev)]
            gparams = {k: torch.stack([p[k] for p in plist])
                       for k in ("w1", "b1", "w2", "b2")}
            xg = draw(.3, (n_dev * pool, c.i_dim)).to(mesh.devices[0])
            cmap = np.repeat(np.arange(n_dev, dtype=np.int32), n_blocks)
            t6, = timed(lambda: ops.chaotic_bits_gang(
                gparams, xg, steps, core_map=cmap, config=c, mesh=mesh))
            cross = float(np.clip((t6 - t1) / (n_dev - 1) / spc, 0.0, 5e8))
        return cls(launch_overhead_cycles=overhead,
                   stacked_step_scale=scale, freeze_row_cycles=freeze,
                   cross_dev_overhead_cycles=cross,
                   sec_per_cycle=spc)
