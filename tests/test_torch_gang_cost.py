"""The port's gang cost model across devices and its ``fit``, on the CPU.

* ``n_dev`` arithmetic: with both models' ``step_cycles`` and
  ``buffer_cycles`` stubbed to one value, the port's ``launch_cycles``,
  ``gang_cost`` and ``solo_cost`` equal the JAX ``GangCostModel``'s at
  every device count, layout and term (cell overhead, freeze, the
  cross-device fee);
* the defaults leave a one-device cost exactly what the Hopper step model
  alone gives (overhead + 2 x rows x step, plus buffering), so every plan
  the planner made before stands;
* ``fit`` under a scripted clock gives the terms derived by hand from the
  scripted times (its cell overhead stays 0: the CUDA kernels have no
  grid, so the JAX ``t3`` is not taken), returns the defaults when the
  doubled launch is not slower, as the JAX ``fit`` does, and
  ``fit(device="cpu")`` runs end to end on the plain versions, a 2-entry
  mesh included.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.dse import Candidate as JaxCandidate
from repro.core.dse import GangCostModel as JaxGangCostModel
from repro_torch.core.dse import (CLOCK_HZ, FIT_STRETCH,
                                  GANG_LAUNCH_OVERHEAD_CYCLES, Candidate,
                                  GangCostModel, step_ops)
from repro_torch.distributed.sharding import DeviceMesh

CAND = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu", dtype_bytes=4,
                 unroll=2, t_block=32)
TERMS = dict(launch_overhead_cycles=123.0, cell_overhead_cycles=17.0,
             freeze_row_cycles=5.0, cross_dev_overhead_cycles=911.0)


class _Stubbed(GangCostModel):
    def step_cycles(self, c, stack=1):
        return 7.0 * stack

    def buffer_cycles(self, overdrawn_words):
        return 0.5 * float(overdrawn_words)


class _JaxStubbed(JaxGangCostModel):
    def step_cycles(self, c, stack=1):
        return 7.0 * stack

    def buffer_cycles(self, overdrawn_words):
        return 0.5 * float(overdrawn_words)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_n_dev_arithmetic_equals_jax(n_dev):
    mine, theirs = _Stubbed(**TERMS), _JaxStubbed(**TERMS)
    jc = JaxCandidate(**dataclasses.asdict(CAND))
    rng = np.random.default_rng(n_dev)
    for _ in range(20):
        rows = [int(r) for r in rng.integers(0, 300, rng.integers(1, 13))]
        stack = int(rng.integers(1, 5))
        assert mine.launch_cycles(CAND, rows, stack=stack, n_dev=n_dev) == (
            pytest.approx(theirs.launch_cycles(jc, rows, stack=stack,
                                               n_dev=n_dev), rel=1e-12))
    demands, lanes = [9, 2, 2], [512, 384, 384]
    for layout, blocks, rbb in (
            ("stacked", [4, 4, 4], None), ("stacked", [4, 4, 4], [9, 2, 2]),
            ("concat", [4, 3, 3], None),
            ("concat", [4, 3, 3], [10] * 4 + [2] * 6)):
        kw = dict(layout=layout, rows_by_block=rbb, n_dev=n_dev)
        assert mine.gang_cost(CAND, demands, blocks, lanes, **kw) == (
            pytest.approx(theirs.gang_cost(jc, demands, blocks, lanes, **kw),
                          rel=1e-12))
    assert mine.solo_cost(CAND, 7, 5, n_dev=n_dev) == pytest.approx(
        theirs.solo_cost(jc, 7, 5, n_dev=n_dev), rel=1e-12)


def test_busiest_shard_and_fee():
    """Blocks split into contiguous runs of ceil(blocks / n_dev): the
    busiest run's rows, plus the fee for each extra device."""
    m = _Stubbed(launch_overhead_cycles=0.0, cross_dev_overhead_cycles=100.0)
    rows = [8, 8, 1, 1, 1]                 # runs of 3 at 2 devices: 17, 2
    assert m.launch_cycles(CAND, rows, n_dev=2) == 100.0 + 2 * 17 * 7.0
    assert m.launch_cycles(CAND, rows) == 2 * 19 * 7.0
    assert m.launch_cycles(CAND, rows, n_dev=5) == 400.0 + 2 * 8 * 7.0


def test_defaults_keep_every_one_device_cost():
    """The new terms default to no cost at one device: a launch costs the
    overhead plus its steps at the Hopper step model, a ragged stacked
    launch pays no freeze, so no plan changes."""
    m = GangCostModel()
    assert (m.cell_overhead_cycles, m.stacked_step_scale,
            m.freeze_row_cycles) == (0.0, 1.0, 0.0)
    assert m.cross_dev_overhead_cycles == GANG_LAUNCH_OVERHEAD_CYCLES
    step = step_ops(CAND) * CAND.s_block / 67e12 * CLOCK_HZ
    rng = np.random.default_rng(5)
    for _ in range(20):
        rows = [int(r) for r in rng.integers(0, 300, rng.integers(1, 9))]
        stack = int(rng.integers(1, 5))
        assert m.launch_cycles(CAND, rows, stack=stack) == pytest.approx(
            GANG_LAUNCH_OVERHEAD_CYCLES + 2 * sum(rows) * step * stack,
            rel=1e-12)
    demands, blocks, lanes = [9, 2, 2], [1, 1, 1], [128] * 3
    freeze = m.gang_cost(CAND, demands, blocks, lanes, layout="stacked",
                         rows_by_block=demands)
    assert freeze == pytest.approx(m.launch_cycles(CAND, [9], stack=3),
                                   rel=1e-12)
    assert m.solo_cost(CAND, 9, 2) == m.launch_cycles(CAND, [9, 9])


class _ScriptedClock:
    """``now()`` pairs: each timed call takes the next scripted seconds."""

    def __init__(self, durations):
        self.durations, self.t, self.started = list(durations), 0.0, False

    def now(self):
        if self.started:
            self.t += self.durations.pop(0)
        self.started = not self.started
        return self.t


def test_fit_under_a_scripted_clock_gives_the_hand_derived_terms():
    """Times scripted from chosen terms (in seconds: a 1 ns step of one
    block, a 50 us launch, a stacked step scale of 2, a 40-cycle freeze
    row, a 1,000-cycle device fee) over pools of three blocks come back
    as those terms."""
    rows, steps, blocks = 16, 32, 3        # max(4, t_block // 2)
    k = FIT_STRETCH                        # the long launches' stretch
    step = step_ops(CAND) * CAND.s_block / 67e12 * CLOCK_HZ
    step_sec, launch_sec = 1e-9, 50e-6
    spc = step_sec / step
    # fit reads step_sec = (t2 - t1) / ((k - 1) * steps * blocks) and
    # launch_sec = t1 - steps * blocks * step_sec
    t1 = launch_sec + steps * blocks * step_sec
    t2 = launch_sec + k * steps * blocks * step_sec
    t4 = launch_sec + k * steps * blocks * 2.0 * 3 * step_sec
    t5 = t4 + 40.0 * k * rows * blocks * spc
    t6 = t1 + 1000.0 * spc
    clock = _ScriptedClock([t1, t2, t4, t5, t6])
    mesh = DeviceMesh(["cpu", "cpu"])
    got = GangCostModel.fit(CAND, device="cpu", reps=1, clock=clock,
                            lanes=blocks * CAND.s_block - 5, mesh=mesh)
    assert not clock.durations             # five measurements, one each
    assert got.sec_per_cycle == pytest.approx(spc, rel=1e-9)
    assert got.launch_overhead_cycles == pytest.approx(launch_sec / spc,
                                                       rel=1e-6)
    assert got.cell_overhead_cycles == 0.0
    assert got.stacked_step_scale == pytest.approx(2.0, rel=1e-6)
    assert got.freeze_row_cycles == pytest.approx(40.0, rel=1e-6)
    assert got.cross_dev_overhead_cycles == pytest.approx(1000.0, rel=1e-6)
    assert sum(mesh.shard_launches) == 2 * 2   # the warm call and one rep


def test_fit_clips_as_the_jax_fit():
    """A launch overhead under 500 cycles is raised to 500 (the JAX floor,
    which binds for one 128-lane block's microsecond steps against a
    Hopper step model of 0.4 cycles), the stacked scale lies in [0.1, 4],
    a faster frozen launch gives no freeze cost, and no mesh keeps the
    default device fee."""
    fast = GangCostModel.fit(CAND, device="cpu", reps=1,
                             lanes=CAND.s_block,
                             clock=_ScriptedClock([100e-6, 164e-6, 1.0,
                                                   0.5]))
    assert fast.launch_overhead_cycles == 500.0
    assert fast.stacked_step_scale == 4.0
    assert fast.freeze_row_cycles == 0.0
    assert fast.cross_dev_overhead_cycles == GANG_LAUNCH_OVERHEAD_CYCLES


def test_fit_keeps_the_defaults_when_t2_is_not_above_t3():
    """The doubled launch (t2) no slower than the first (t1, in the place
    of the JAX t3): timing noise, the defaults come back."""
    for t2 in (100e-6, 99e-6):
        clock = _ScriptedClock([100e-6, t2])
        assert GangCostModel.fit(CAND, device="cpu", reps=1,
                                 lanes=CAND.s_block,
                                 clock=clock) == GangCostModel()
        assert not clock.durations


def test_fit_on_the_cpu_runs_end_to_end():
    """Real timings of the plain versions (no claim on their values):
    every term finite, the clips held, an mxu candidate skipping the
    stacked terms as in the JAX fit."""
    m = GangCostModel.fit(CAND, device="cpu", reps=1, lanes=512,
                          mesh=DeviceMesh(["cpu"] * 2))
    for f in dataclasses.fields(m):
        assert np.isfinite(getattr(m, f.name)), f.name
    if m != GangCostModel():
        assert m.launch_overhead_cycles >= 500.0
        assert 0.1 <= m.stacked_step_scale <= 4.0
    mxu = dataclasses.replace(CAND, compute_unit="mxu")
    fitted = GangCostModel.fit(mxu, device="cpu", reps=1, lanes=512)
    assert (fitted.stacked_step_scale, fitted.freeze_row_cycles) == (1.0, 0.0)
