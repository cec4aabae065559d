"""The port's admission control (``repro_torch.serve.admission``).

A mirror of ``tests/test_admission.py``: pure-policy tests drive
``AdmissionController`` directly under a ``FakeClock`` (token refill is
arithmetic on fake time, zero sleeps); the integration tests attach a
controller to the port's ``AsyncOscillatorFarm`` on the CPU: over-limit
submits fail fast with a typed ``Overloaded`` carrying ``retry_after_ms``,
while already-admitted futures all resolve.

Against the JAX package: one seeded script of admits, releases, capacity
changes and fake-time advances gives the same admits, rejections, scopes,
``retry_after_ms`` hints and stats on both controllers, static and
adaptive.
"""
import asyncio

import numpy as np
import pytest

from repro_torch.serve.admission import (AdmissionController, Overloaded,
                                         RETRY_CAP_MS, RETRY_FLOOR_MS)
from repro_torch.serve.async_frontend import AsyncOscillatorFarm
from repro_torch.serve.clock import FakeClock

from test_torch_async_frontend import TEST_TIMEOUT, _farm, _run


# ---------------------------------------------------------------------------
# Token-bucket policy (no farm involved)
# ---------------------------------------------------------------------------

def test_bucket_burst_then_rate():
    fc = FakeClock()
    ac = AdmissionController(rate_words_per_s=100.0, burst_words=500.0,
                             clock=fc)
    # burst drains first...
    ac.admit("c", "t", 500, rows_est=1)
    # ...then an empty bucket rejects with an exact refill-time hint
    with pytest.raises(Overloaded) as ei:
        ac.admit("c", "t", 200, rows_est=1)
    assert ei.value.scope == "tenant"
    assert ei.value.core == "c" and ei.value.client == "t"
    assert ei.value.retry_after_ms == pytest.approx(2000.0)  # 200 w / 100 w/s
    # a rejection must not consume tokens: refill exactly the hint and
    # the same request is admitted
    fc.advance(2.0)
    ac.admit("c", "t", 200, rows_est=1)
    assert ac.stats()["admitted"] == 2.0
    assert ac.stats()["rejected_tenant"] == 1.0


def test_bucket_refill_caps_at_burst():
    fc = FakeClock()
    ac = AdmissionController(rate_words_per_s=10.0, burst_words=100.0,
                             clock=fc)
    ac.admit("c", "t", 100, rows_est=1)
    fc.advance(1e6)                        # eons: still only `burst` tokens
    ac.admit("c", "t", 100, rows_est=1)
    with pytest.raises(Overloaded):
        ac.admit("c", "t", 1, rows_est=1)


def test_oversized_request_never_admissible():
    ac = AdmissionController(rate_words_per_s=10.0, burst_words=50.0,
                             clock=FakeClock())
    with pytest.raises(Overloaded) as ei:
        ac.admit("c", "t", 51, rows_est=1)
    # an oversized request can NEVER be admitted, but the hint must stay
    # finite: an inf would leak straight into client sleep arithmetic
    assert ei.value.retry_after_ms == RETRY_CAP_MS


def test_retry_hint_clamped_to_positive_floor():
    # a near-instant refill used to round to a 0 ms hint — every rejected
    # client retried in the same scheduler tick (a synchronized stampede)
    fc = FakeClock()
    ac = AdmissionController(rate_words_per_s=1e6, burst_words=100.0,
                             clock=fc)
    ac.admit("c", "t", 100, rows_est=1)
    with pytest.raises(Overloaded) as ei:
        ac.admit("c", "t", 50, rows_est=1)     # refills in 0.05 ms
    assert ei.value.retry_after_ms == RETRY_FLOOR_MS
    assert Overloaded("x", scope="farm",
                      retry_after_ms=float("nan")).retry_after_ms == \
        RETRY_CAP_MS
    assert Overloaded("x", scope="farm",
                      retry_after_ms=-5.0).retry_after_ms == RETRY_FLOOR_MS


def test_capacity_factor_scales_row_ceiling():
    ac = AdmissionController(max_queued_rows=100, clock=FakeClock())
    assert ac.current_ceiling == 100
    ac.set_capacity_factor(0.5)                # 1 of 2 cores quarantined
    assert ac.current_ceiling == 50
    ac.admit("c", "t", 1, rows_est=50)
    with pytest.raises(Overloaded) as ei:
        ac.admit("c", "u", 1, rows_est=1)
    assert ei.value.scope == "farm"
    assert ac.stats()["capacity_factor"] == 0.5
    ac.set_capacity_factor(9.9)                # clamped into [0, 1]
    assert ac.current_ceiling == 100
    ac.set_capacity_factor(-1.0)
    assert ac.current_ceiling == 0


def test_per_tenant_override_and_isolation():
    fc = FakeClock()
    ac = AdmissionController(rate_words_per_s=10.0, burst_words=10.0,
                             per_tenant={("c", "vip"): (1000.0, 1000.0)},
                             clock=fc)
    ac.admit("c", "vip", 900, rows_est=1)      # override bucket
    ac.admit("c", "t", 10, rows_est=1)         # default bucket
    with pytest.raises(Overloaded):
        ac.admit("c", "t", 10, rows_est=1)     # t exhausted...
    ac.admit("c", "vip", 100, rows_est=1)      # ...vip unaffected


def test_ceiling_gauge_admit_release_lifecycle():
    ac = AdmissionController(max_queued_rows=10, ceiling_retry_ms=7.5,
                             clock=FakeClock())
    ac.admit("c", "t", 1, rows_est=6)
    ac.admit("c", "u", 1, rows_est=4)
    assert ac.queued_rows == 10
    with pytest.raises(Overloaded) as ei:
        ac.admit("c", "v", 1, rows_est=1)
    assert ei.value.scope == "farm"
    assert ei.value.retry_after_ms == pytest.approx(7.5)
    ac.release(4)                              # one request left the queue
    ac.admit("c", "v", 1, rows_est=1)
    assert ac.queued_rows == 7
    assert ac.stats()["rejected_farm"] == 1.0


def test_rate_and_burst_must_pair():
    with pytest.raises(ValueError, match="together"):
        AdmissionController(rate_words_per_s=10.0)


# ---------------------------------------------------------------------------
# Front-end integration
# ---------------------------------------------------------------------------

def test_frontend_rejects_fail_fast_admitted_futures_resolve():
    """Over-ceiling load is refused at submit() with Overloaded while every
    already-admitted future still resolves with its exact words."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        ac = AdmissionController(max_queued_rows=3, clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc, admission=ac) as af:
            # lanes_per_client=128 => 128 words = 1 row estimate
            admitted = [af.submit("core0", "t", 128, deadline_ms=50)
                        for _ in range(3)]
            assert ac.queued_rows == 3
            with pytest.raises(Overloaded) as ei:
                af.submit("core0", "t", 128, deadline_ms=50)
            assert ei.value.scope == "farm"
            assert ei.value.retry_after_ms > 0.0
            fc.advance(0.05)
            await af.drain()
            assert all(f.result().size == 128 for f in admitted)
            # the flush released the gauge: the same submit now admits
            assert ac.queued_rows == 0
            ok = await af.draw("core0", "t", 128, deadline_ms=0)
            assert ok.size == 128
    _run(go())


def test_frontend_cancel_releases_ceiling_rows():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        ac = AdmissionController(max_queued_rows=2, clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc, admission=ac) as af:
            doomed = af.submit("core0", "t", 256, deadline_ms=10_000)
            with pytest.raises(Overloaded):
                af.submit("core0", "t", 128, deadline_ms=10_000)
            doomed.cancel()
            await af.drain()                  # flusher pass prunes + releases
            assert ac.queued_rows == 0
            ok = await af.draw("core0", "t", 128, deadline_ms=0)
            assert ok.size == 128
    _run(go())


def test_frontend_tenant_rate_limit_and_stream_integrity():
    """A rate-limited tenant's rejected submit never reaches the farm: the
    served stream stays bit-identical to a solo farm that saw only the
    admitted draws."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        ac = AdmissionController(rate_words_per_s=1000.0, burst_words=200.0,
                                 clock=fc)
        served = []
        async with AsyncOscillatorFarm(farm, clock=fc, admission=ac) as af:
            served.append(await af.draw("core0", "t", 200, deadline_ms=0))
            with pytest.raises(Overloaded) as ei:
                af.submit("core0", "t", 200, deadline_ms=0)
            # bucket refills on fake time: the hint is honest
            fc.advance(ei.value.retry_after_ms / 1e3)
            served.append(await af.draw("core0", "t", 200, deadline_ms=0))
        solo = _farm(gang=False)
        for words in served:
            np.testing.assert_array_equal(words, solo.draw("core0", "t", 200))
    _run(go())


def test_draw_sync_rejected_by_admission_raises_in_caller_thread():
    fc = FakeClock()
    farm = _farm(clock=fc)
    ac = AdmissionController(rate_words_per_s=10.0, burst_words=64.0,
                             clock=fc)
    af = AsyncOscillatorFarm(farm, clock=fc, admission=ac).start_thread()
    try:
        out = af.draw_sync("core0", "t", 64, deadline_ms=0,
                           timeout=TEST_TIMEOUT)
        assert out.size == 64
        with pytest.raises(Overloaded):
            af.draw_sync("core0", "t", 64, deadline_ms=0,
                         timeout=TEST_TIMEOUT)
        assert ac.stats()["rejected_tenant"] == 1.0
        assert ac.queued_rows == 0            # rejected submit queued nothing
    finally:
        af.close()


# ---------------------------------------------------------------------------
# Adaptive ceiling: max_queued_rows from throughput, not a constant
# ---------------------------------------------------------------------------

def test_adaptive_ceiling_prior_from_fitted_cost_model():
    """Cold start: with zero observations the ceiling comes from the
    fitted GangCostModel (modeled rows/s x target delay); with neither
    model nor observations it stays wide open (max_rows)."""
    from repro_torch.core.dse import GangCostModel
    from repro_torch.serve.admission import AdaptiveCeiling
    from test_torch_async_frontend import CAND as c

    blind = AdaptiveCeiling(max_rows=12345)
    assert blind.rows_per_s() is None
    assert blind.ceiling() == 12345

    # an unfitted model (sec_per_cycle=None) gives no prior either; the
    # port's default model carries the H100 clock, so say None here
    assert AdaptiveCeiling(cost_model=GangCostModel(sec_per_cycle=None),
                           candidate=c, max_rows=12345).ceiling() == 12345

    fitted = GangCostModel(sec_per_cycle=1e-9)
    ad = AdaptiveCeiling(cost_model=fitted, candidate=c,
                         target_delay_ms=50.0, min_rows=1, max_rows=1 << 30)
    rps = ad.prior_rows_per_s()
    assert rps is not None and rps > 0
    assert ad.ceiling() == int(rps * 0.050)


def test_adaptive_ceiling_tracks_observed_flush_rate():
    """Observations supersede the prior, over a rolling window: the
    ceiling follows measured rows/s * target delay, clamped."""
    from repro_torch.serve.admission import AdaptiveCeiling

    ad = AdaptiveCeiling(target_delay_ms=100.0, window=4,
                         min_rows=8, max_rows=10_000)
    for _ in range(4):
        ad.observe(0.010, 50)           # 5000 rows/s
    assert ad.rows_per_s() == pytest.approx(5000.0)
    assert ad.ceiling() == 500          # 5000 * 0.1 s
    # the farm slows 10x; the window forgets the fast past
    for _ in range(4):
        ad.observe(0.100, 50)
    assert ad.ceiling() == 50
    # clamps hold at the extremes
    for _ in range(4):
        ad.observe(10.0, 1)             # glacial
    assert ad.ceiling() == 8
    for _ in range(4):
        ad.observe(1e-6, 1000)          # implausibly fast
    assert ad.ceiling() == 10_000


def test_adaptive_ceiling_gates_admission_with_drain_hint():
    """AdmissionController(adaptive=...) keeps the typed Overloaded
    contract; the farm-scope retry hint covers the modeled drain time."""
    from repro_torch.serve.admission import AdaptiveCeiling

    ad = AdaptiveCeiling(target_delay_ms=10.0, min_rows=1)
    for _ in range(3):
        ad.observe(1.0, 100)            # 100 rows/s -> ceiling 1 row
    ac = AdmissionController(adaptive=ad, ceiling_retry_ms=2.0,
                             clock=FakeClock())
    assert ac.current_ceiling == 1
    ac.admit("core0", "t", 64, 1)
    with pytest.raises(Overloaded) as ei:
        ac.admit("core0", "t", 640, 10)
    assert ei.value.scope == "farm"
    # 10 excess rows at 100 rows/s = 100 ms, far above the 2 ms floor
    assert ei.value.retry_after_ms == pytest.approx(100.0)
    assert ac.stats()["ceiling"] == 1.0
    ac.release(1)
    ac.admit("core0", "t", 64, 1)       # drained: admitted again


def test_adaptive_ceiling_fed_by_frontend_profile_stats():
    """End to end: a profiled farm + adaptive admission — each flush
    feeds one (stage seconds, rows) observation, and the ceiling leaves
    max_rows once real throughput is measured.  Real clock: the profile
    stage timers read the farm's injected clock, so a FakeClock would
    yield zero-second deltas and no observations."""
    from repro_torch.serve.admission import AdaptiveCeiling

    async def go():
        farm = _farm(n_cores=1, profile=True)
        ad = AdaptiveCeiling(target_delay_ms=50.0, min_rows=16,
                             max_rows=1 << 20)
        ac = AdmissionController(adaptive=ad)
        async with AsyncOscillatorFarm(farm, admission=ac) as af:
            for _ in range(3):
                await af.draw("core0", "t", 200, deadline_ms=0)
        # flush 1 primes the stage-timer baseline; flushes 2+ observe
        assert ad.updates >= 1
        assert ad.rows_per_s() is not None
        assert 16 <= ad.ceiling() < 1 << 20    # left max_rows: measured

    _run(go())


def test_degraded_ceiling_never_quantizes_to_zero():
    """Regression: a small base ceiling times a reduced-but-nonzero
    capacity factor used to truncate to a ZERO ceiling — rejecting all
    traffic while healthy cores remained.  A nonzero factor now floors
    the scaled ceiling at one row (static) / ``min_rows`` (adaptive);
    a factor of exactly 0 (every core quarantined) still closes the
    gate."""
    from repro_torch.serve.admission import AdaptiveCeiling

    ac = AdmissionController(max_queued_rows=3, clock=FakeClock())
    ac.set_capacity_factor(0.2)              # int(3 * 0.2) == 0
    assert ac.current_ceiling == 1
    ac.admit("c", "t", 1, rows_est=1)        # one row still flows
    ac.release(1)
    ac.set_capacity_factor(0.0)
    assert ac.current_ceiling == 0
    with pytest.raises(Overloaded):
        ac.admit("c", "t", 1, rows_est=1)

    ad = AdaptiveCeiling(target_delay_ms=50.0, window=4,
                         min_rows=8, max_rows=10_000)
    for _ in range(4):
        ad.observe(0.010, 50)                # 5000 rows/s -> base 250
    acc = AdmissionController(adaptive=ad, clock=FakeClock())
    assert acc.current_ceiling == 250
    acc.set_capacity_factor(0.001)           # int(250 * 0.001) == 0
    assert acc.current_ceiling == 8          # floored at min_rows
    acc.set_capacity_factor(0.0)
    assert acc.current_ceiling == 0


def test_adaptive_prior_scales_with_launch_shape_and_lattice_dims():
    """Regression: the cold-start prior always modeled one nominal
    t_block/2-row launch, whatever the plan actually launches — so a
    farm flushing bigger coalesced launches under-estimated its own
    throughput, and a lattice core (i_dim = n_nodes x base dim) priced
    its rows like a scalar core and over-admitted on cold start."""
    from repro_torch.core.dse import GangCostModel, select_config
    from repro_torch.serve.admission import AdaptiveCeiling
    from test_torch_async_frontend import CAND as c

    fitted = GangCostModel(sec_per_cycle=1e-9)
    base = AdaptiveCeiling(cost_model=fitted, candidate=c)
    shaped = AdaptiveCeiling(cost_model=fitted, candidate=c,
                             rows_per_launch=4 * c.t_block)
    # bigger launches amortize per-launch overhead: a plan-shaped prior
    # must credit that, not repeat the nominal-block estimate
    assert shaped.prior_rows_per_s() > base.prior_rows_per_s()

    # same launch shape, lattice-vs-scalar rows: pin rows_per_launch so
    # only the per-row cost differs — a 32-node lattice row carries
    # ~n_nodes the compute of the 3-D scalar core's and must price so
    lat = select_config(96, 256, s_total=128, unit="vpu", n_nodes=32)
    assert lat.n_nodes == 32
    scal_prior = AdaptiveCeiling(cost_model=fitted, candidate=c,
                                 rows_per_launch=128).prior_rows_per_s()
    lat_prior = AdaptiveCeiling(cost_model=fitted, candidate=lat,
                                rows_per_launch=128).prior_rows_per_s()
    # The port's Hopper model charges each launch an overhead the JAX
    # TPU model prices lower, so at 128 rows the priors differ by less
    # than the rows do; the n_nodes-fold cost shows in the per-row term.
    assert lat_prior < scal_prior
    assert fitted.step_cycles(lat) > 4 * fitted.step_cycles(c)
    # and the DSE's actual lattice pick (mxu) is costlier than the scalar
    # core.  The JAX model prices it below brute-force vpu rows (a TPU
    # systolic unit); the Hopper step model runs both units' ops on the
    # CUDA cores, so it prices it no cheaper than the vpu lattice
    latm = select_config(96, 256, s_total=128, unit="mxu", n_nodes=32)
    latm_prior = AdaptiveCeiling(cost_model=fitted, candidate=latm,
                                 rows_per_launch=128).prior_rows_per_s()
    assert lat_prior <= latm_prior < scal_prior


# ---------------------------------------------------------------------------
# Against the JAX package: one script, the same decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["static", "adaptive", "tenant"])
def test_admission_script_equals_jax(mode):
    """Admits, releases, capacity factors and fake-time advances from one
    seed: every admit or rejection (scope, ``retry_after_ms``, core,
    client), the ceiling and the stats equal the JAX controller's."""
    from repro.serve.admission import (AdaptiveCeiling as JaxCeiling,
                                       AdmissionController as JaxController)
    from repro.serve.clock import FakeClock as JaxClock
    from repro_torch.serve.admission import AdaptiveCeiling

    def build(ctrl, ceil, clock):
        kw = {"clock": clock, "ceiling_retry_ms": 3.0}
        if mode == "static":
            kw["max_queued_rows"] = 40
        elif mode == "adaptive":
            ad = ceil(target_delay_ms=20.0, window=3, min_rows=4,
                      max_rows=500)
            kw["adaptive"] = ad
        else:
            kw.update(rate_words_per_s=2_000.0, burst_words=3_000.0,
                      max_queued_rows=60,
                      per_tenant={("c1", "vip"): (20_000.0, 9_000.0)})
        return ctrl(**kw)

    def run(ctrl, ceil, clock_cls):
        clock = clock_cls()
        ac = build(ctrl, ceil, clock)
        rng = np.random.default_rng(17)
        out = []
        for _ in range(300):
            r = rng.random()
            if r < 0.55:
                core = f"c{rng.integers(0, 3)}"
                client = ("vip", "t", "u")[rng.integers(0, 3)]
                n = int(rng.integers(1, 2_500))
                rows = -(-n // 128)
                try:
                    ac.admit(core, client, n, rows)
                    out.append(("ok", rows))
                except Exception as e:   # noqa: BLE001 - compared below
                    out.append((type(e).__name__, e.scope,
                                e.retry_after_ms, e.core, e.client))
            elif r < 0.75:
                ac.release(int(rng.integers(1, 20)))
            elif r < 0.85:
                clock.advance(float(rng.integers(1, 400)) / 1e3)
            elif r < 0.92:
                ac.set_capacity_factor(float(rng.integers(0, 5)) / 4)
            elif ac.adaptive is not None:
                ac.adaptive.observe(float(rng.integers(1, 50)) / 1e3,
                                    int(rng.integers(1, 400)))
            out.append((ac.current_ceiling, ac.queued_rows))
        return out, ac.stats()

    t = run(AdmissionController, AdaptiveCeiling, FakeClock)
    j = run(JaxController, JaxCeiling, JaxClock)
    assert t == j
    kinds = {o[0] for o in t[0] if isinstance(o[0], str)}
    assert {"ok", "Overloaded"} <= kinds
