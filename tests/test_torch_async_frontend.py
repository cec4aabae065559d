"""The port's async serving front-end (``repro_torch.serve.async_frontend``)
on the CPU, where every launch takes the plain versions of the kernels.

A mirror of ``tests/test_async_frontend.py``: deadline and coalescing
semantics, bit-identity to the sync ``gang=False`` solo path under
coalescing, cancellation, snapshots, threads, offload and SLO classes, and
the front-end's lifecycle regressions.  Every test runs under a
manual-advance ``FakeClock`` (or no clock dependence at all), with no real
sleep on the serving path, and each async body is wrapped in
``asyncio.wait_for`` so a hung loop fails instead of hanging.

Against the JAX front-end: the same tenants' requests through both
front-ends over bf16 farms of the same three 3-8-3 cores deliver
bitwise-equal words (``test_words_bitwise_vs_jax_frontend``).
"""
import asyncio
import concurrent.futures
import random
import threading
import time

import numpy as np
import pytest
import torch

from _propshim import given, settings, strategies as st
from repro_torch.core.dse import Candidate
from repro_torch.serve.async_frontend import AsyncOscillatorFarm
from repro_torch.serve.clock import FakeClock, SystemClock
from repro_torch.serve.farm import OscillatorFarm

from test_torch_farm import _weights

CAND = Candidate(i_dim=3, h_dim=8, p=1, compute_unit="vpu",
                 dtype_bytes=4, unroll=4, t_block=64)
TEST_TIMEOUT = 120.0      # hard per-test guard: a hung loop fails, not hangs


def _run(coro):
    asyncio.run(asyncio.wait_for(coro, TEST_TIMEOUT))


def _params(key=0, h_dim=8, scale=0.5):
    """Seeded toy i-h-i weights (as ``tests/test_kernels.py::_mk``)."""
    rng = np.random.default_rng(key)
    f32 = np.float32
    return {"w1": (rng.standard_normal((3, h_dim)) * scale).astype(f32),
            "b1": (rng.standard_normal(h_dim) * 0.1).astype(f32),
            "w2": (rng.standard_normal((h_dim, 3)) * scale).astype(f32),
            "b2": (rng.standard_normal(3) * 0.1).astype(f32)}


def _farm(gang=True, n_cores=3, clients=("t",), clock=None, **kw):
    farm = OscillatorFarm(gang=gang, clock=clock, device="cpu", **kw)
    for i in range(n_cores):
        farm.add_core(f"core{i}", _params(key=10 + i), config=CAND,
                      lanes_per_client=128)
        for j, c in enumerate(clients):
            farm.register(f"core{i}", c, seed=40 + j)
    return farm


# ---------------------------------------------------------------------------
# Deadline semantics (FakeClock, zero sleeps)
# ---------------------------------------------------------------------------

def test_deadline_fires_at_deadline_not_before():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            fut = af.submit("core0", "t", 100, deadline_ms=50)
            await af.drain()
            assert not fut.done() and farm.launches == 0
            fc.advance(0.049)                      # 1 ms short
            await af.drain()
            assert not fut.done() and farm.launches == 0
            fc.advance(0.001)                      # exactly at the deadline
            await af.drain()
            assert fut.done() and farm.launches == 1
            assert fut.result().size == 100
    _run(go())


def test_batch_flushes_before_deadline_at_auto_flush_rows():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc,
                                       auto_flush_rows=4) as af:
            f1 = af.submit("core0", "t", 100, deadline_ms=1000)   # 1 row
            await af.drain()
            assert not f1.done()                   # below threshold, waits
            f2 = af.submit("core1", "t", 600, deadline_ms=1000)   # +5 rows
            await af.drain()
            # threshold reached: both served NOW, deadline 1 s away
            assert f1.done() and f2.done()
            assert fc.now() == 0.0
            assert farm.launches == 1
            stats = af.deadline_stats()
            assert stats["max_miss_ms"] == 0.0     # nobody missed
    _run(go())


def test_n_coalescing_tenants_one_gang_launch():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=4, clients=("a", "b"))
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            futs = [af.submit(f"core{i}", c, 64 + 16 * i, deadline_ms=20)
                    for i in range(4) for c in ("a", "b")]
            await af.drain()
            assert farm.launches == 0
            fc.advance(0.02)
            await af.drain()
            assert all(f.done() for f in futs)
            # 8 tenants on 4 gang-compatible cores: ONE stacked launch
            assert farm.launches == 1
            assert farm.gang_launches == 1
    _run(go())


def test_no_deadline_means_next_pass():
    """``deadline_ms=None`` with no default: served at the next flusher
    pass, without any clock advance."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            out = await af.draw("core0", "t", 37)
            assert out.size == 37
            assert fc.now() == 0.0
    _run(go())


def test_rider_requests_flush_with_the_due_one():
    """A flush serves EVERY queued request, not just the due one — riders
    amortize the launch the deadline paid for."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            early = af.submit("core0", "t", 64, deadline_ms=10)
            late = af.submit("core1", "t", 64, deadline_ms=10_000)
            fc.advance(0.01)
            await af.drain()
            assert early.done() and late.done()
            assert farm.launches == 1
    _run(go())


# ---------------------------------------------------------------------------
# Bit-identity to the sync solo path
# ---------------------------------------------------------------------------

def test_async_words_bit_identical_to_solo():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=3, clients=("a", "b"))
        results = {}
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            futs = {(f"core{i}", c): af.submit(f"core{i}", c, 100 + 31 * i,
                                               deadline_ms=5)
                    for i in range(3) for c in ("a", "b")}
            fc.advance(0.005)
            await af.drain()
            results.update({k: f.result() for k, f in futs.items()})
            # second round exercises buffered overdraw from the first
            futs = {(f"core{i}", c): af.submit(f"core{i}", c, 77,
                                               deadline_ms=5)
                    for i in range(3) for c in ("a", "b")}
            fc.advance(0.005)
            await af.drain()
            round2 = {k: f.result() for k, f in futs.items()}
        solo = _farm(gang=False, n_cores=3, clients=("a", "b"))
        for (core, c), words in results.items():
            np.testing.assert_array_equal(
                words, solo.draw(core, c, words.size))
        for (core, c), words in round2.items():
            np.testing.assert_array_equal(words, solo.draw(core, c, 77))
    _run(go())


def test_cancelled_future_rolls_demand_back():
    """A cancelled queued future never reaches the farm: co-tenants' and
    the same tenant's later words match a solo farm that never saw it."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            doomed = af.submit("core0", "t", 500, deadline_ms=100)
            keeper = af.submit("core1", "t", 200, deadline_ms=100)
            assert af.pending_requests == 2
            doomed.cancel()
            assert af.pending_requests == 1
            fc.advance(0.1)
            await af.drain()
            assert keeper.done() and doomed.cancelled()
            later = await af.draw("core0", "t", 90)
        solo = _farm(gang=False)
        np.testing.assert_array_equal(keeper.result(),
                                      solo.draw("core1", "t", 200))
        # solo never requested the cancelled 500 for core0 either
        np.testing.assert_array_equal(later, solo.draw("core0", "t", 90))
    _run(go())


def test_sync_pending_and_outbox_words_survive_async_flush():
    """An async flush that also serves sync-surface demand re-parks those
    words (pre-existing service pending + outbox backlog) instead of
    swallowing them: the next sync flush returns them, bit-identically."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, clients=("t", "s"))
        farm.request("core0", "s", 150)            # sync tenant, un-flushed
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            mine = await af.draw("core0", "t", 220)
            assert af.pending_requests == 0
        sync_out = farm.flush()                    # launch-free delivery
        solo = _farm(gang=False, clients=("t", "s"))
        np.testing.assert_array_equal(mine, solo.draw("core0", "t", 220))
        np.testing.assert_array_equal(sync_out["core0"]["s"],
                                      solo.draw("core0", "s", 150))
    _run(go())


def test_flusher_survives_flush_failure():
    """A failing farm flush fails THAT batch's futures (nobody hangs) and
    the flusher keeps serving; the failed batch's demand — already in the
    farm — surfaces on the sync outbox, keeping streams consistent."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            orig = farm.flush

            def boom(*a, **kw):
                raise RuntimeError("injected launch failure")

            farm.flush = boom
            doomed = af.submit("core0", "t", 10, deadline_ms=0)
            await af.drain()
            assert isinstance(doomed.exception(), RuntimeError)
            assert len(af.flush_errors) == 1
            farm.flush = orig
            after = await af.draw("core0", "t", 20)
        sync_out = farm.flush()                 # the orphaned 10 words
        solo = _farm(gang=False)
        orphan = solo.draw("core0", "t", 10)
        np.testing.assert_array_equal(sync_out["core0"]["t"], orphan)
        np.testing.assert_array_equal(after, solo.draw("core0", "t", 20))
    _run(go())


def test_partial_flush_failure_drops_no_absorbed_words():
    """If a later group's launch fails mid-flush, words already absorbed
    for earlier groups are parked on the sync surface — not lost with the
    in-flight return value — and every stream stays gap-free."""
    cand16 = Candidate(i_dim=3, h_dim=16, p=1, compute_unit="vpu",
                       dtype_bytes=4, unroll=4, t_block=64)

    def two_group_farm(gang=True, clock=None):
        farm = OscillatorFarm(gang=gang, clock=clock, device="cpu")
        farm.add_core("a", _params(key=1), config=CAND,
                      lanes_per_client=128)
        farm.add_core("b", _params(key=3, h_dim=16),
                      config=cand16, lanes_per_client=128)
        farm.register("a", "t", seed=6)
        farm.register("b", "t", seed=6)
        return farm

    async def go():
        fc = FakeClock()
        farm = two_group_farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            svc_b = farm.services["b"]
            orig = svc_b._launch

            def boom(*a, **kw):
                raise RuntimeError("core b launch failed")

            svc_b._launch = boom
            fa = af.submit("a", "t", 100, deadline_ms=0)
            fb = af.submit("b", "t", 100, deadline_ms=0)
            await af.drain()
            # whole batch failed loudly (a's group had already absorbed)
            assert isinstance(fa.exception(), RuntimeError)
            assert isinstance(fb.exception(), RuntimeError)
            svc_b._launch = orig
        out = farm.flush()            # a: parked words; b: retried pending
        solo = two_group_farm(gang=False)
        np.testing.assert_array_equal(out["a"]["t"], solo.draw("a", "t", 100))
        np.testing.assert_array_equal(out["b"]["t"], solo.draw("b", "t", 100))
    _run(go())


def test_draw_sync_refused_on_loop_thread():
    async def go():
        farm = _farm()
        async with AsyncOscillatorFarm(farm) as af:
            with pytest.raises(RuntimeError, match="deadlock"):
                af.draw_sync("core0", "t", 1)
    _run(go())


# ---------------------------------------------------------------------------
# Snapshot / restore with in-flight requests
# ---------------------------------------------------------------------------

def test_snapshot_quiesces_inflight_requests():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=2)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            served = await af.draw("core0", "t", 64)     # advance state
            f1 = af.submit("core0", "t", 333, deadline_ms=500)
            f2 = af.submit("core1", "t", 70, deadline_ms=500)
            await af.drain()
            snap = await af.snapshot()                   # futures in flight
            fc.advance(0.5)
            await af.drain()
            live = {"core0": f1.result(), "core1": f2.result()}
            assert served.size == 64

        # restored onto a plain SYNC farm: the in-flight demand replays
        # through flush(), bit-identical to what the live futures got
        sync = _farm(gang=False, n_cores=2)
        sync.restore(snap)
        out = sync.flush()
        np.testing.assert_array_equal(out["core0"]["t"], live["core0"])
        np.testing.assert_array_equal(out["core1"]["t"], live["core1"])

        # restored onto another front-end: quiesce is enforced, and the
        # replayed demand surfaces on ITS sync surface
        farm2 = _farm(n_cores=2)
        af2 = AsyncOscillatorFarm(farm2)
        af2.restore(snap)
        out2 = farm2.flush()
        np.testing.assert_array_equal(out2["core0"]["t"], live["core0"])
        np.testing.assert_array_equal(out2["core1"]["t"], live["core1"])
    _run(go())


def test_restore_refuses_unquiesced_frontend():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            snap = await af.snapshot()
            fut = af.submit("core0", "t", 10, deadline_ms=10_000)
            with pytest.raises(RuntimeError, match="in-flight"):
                af.restore(snap)
            fut.cancel()
            af.restore(snap)                   # cancelled == quiesced
    _run(go())


# ---------------------------------------------------------------------------
# Thread-safe ingress (no FakeClock advances needed: immediate deadlines)
# ---------------------------------------------------------------------------

def test_threaded_ingress_draw_sync():
    fc = FakeClock()
    farm = _farm(clock=fc, n_cores=3)
    af = AsyncOscillatorFarm(farm, clock=fc).start_thread()
    try:
        results = {}

        def worker(i):
            results[i] = af.draw_sync(f"core{i}", "t", 64 + i,
                                      deadline_ms=0, timeout=TEST_TIMEOUT)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TEST_TIMEOUT)
    finally:
        af.close()
    solo = _farm(gang=False, n_cores=3)
    for i in range(3):
        np.testing.assert_array_equal(results[i],
                                      solo.draw(f"core{i}", "t", 64 + i))


def test_draw_sync_refused_after_close():
    farm = _farm()
    af = AsyncOscillatorFarm(farm).start_thread()
    af.close()
    with pytest.raises(RuntimeError, match="not started"):
        af.draw_sync("core0", "t", 1)


def test_thread_frontend_validates_before_enqueue():
    farm = _farm()
    af = AsyncOscillatorFarm(farm).start_thread()
    try:
        with pytest.raises(KeyError, match="unknown core"):
            af.draw_sync("nope", "t", 1)
        with pytest.raises(KeyError, match="not registered"):
            af.draw_sync("core0", "nobody", 1)
    finally:
        af.close()


# ---------------------------------------------------------------------------
# Wall-clock audit: the sync farm's deferral/coalescing reads no real time
# ---------------------------------------------------------------------------

def test_sync_farm_deferral_is_wallclock_free():
    """`flush(max_wait_rows=...)` deferral and `auto_flush` coalescing are
    flush-cycle- and row-counted: under a FROZEN FakeClock (every now()
    identical) behavior is unchanged and even the profile timers — the
    only time reads left in the sync farm — accumulate exactly zero."""
    fc = FakeClock(start=123.0)
    farm = _farm(clock=fc, profile=True)
    for i in range(3):
        farm.request(f"core{i}", "t", 10)
    assert farm.flush(max_wait_rows=64) == {}      # deferred
    assert farm.launches == 0
    out = farm.flush(max_wait_rows=64)             # overdue: must launch
    assert all(out[f"core{i}"]["t"].size == 10 for i in range(3))
    assert farm.launches == 1
    assert farm.pending_rows == 0
    prof = farm.profile_stats
    assert prof["flushes"] == 2.0
    assert all(v == 0.0 for k, v in prof.items() if k != "flushes"), prof
    assert fc.now() == 123.0


# ---------------------------------------------------------------------------
# Property-based interleaving: async front-end vs sync solo, bit for bit
# ---------------------------------------------------------------------------

def _interleaving_program(rng, n_ops):
    """A random register/submit/draw/flush/snapshot/restore program.

    Tracks quiescence so snapshot/restore land on legal states (the
    front-end itself enforces restore-quiescence; flushes serve every
    queued request, so 'flush' always quiesces).
    """
    ops, outstanding, n_snaps, n_regs = [], 0, 0, 0
    for _ in range(n_ops):
        menu = ["submit", "submit", "submit", "flush", "draw", "register"]
        if outstanding == 0:
            menu.append("snapshot")
            if n_snaps:
                menu.append("restore")
        op = rng.choice(menu)
        if op == "submit":
            ops.append(("submit", rng.randrange(2), rng.randint(1, 300),
                        rng.choice([0, 5, 50])))
            outstanding += 1
        elif op == "register":
            ops.append(("register", rng.randrange(2), f"r{n_regs}"))
            n_regs += 1
        elif op in ("flush", "draw"):
            if op == "draw":
                ops.append(("submit", rng.randrange(2),
                            rng.randint(1, 300), 0))
            ops.append(("flush",))
            outstanding = 0
        elif op == "snapshot":
            ops.append(("snapshot",))
            n_snaps += 1
        else:
            ops.append(("restore", rng.randrange(n_snaps)))
    ops.append(("flush",))
    return ops


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_interleaving_matches_solo_bit_for_bit(seed):
    rng = random.Random(seed)
    program = _interleaving_program(rng, 12)

    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=2, clients=("a", "b"))
        solo = _farm(gang=False, n_cores=2, clients=("a", "b"))
        registered = [(f"core{i}", c) for i in range(2) for c in ("a", "b")]
        log_async = {}
        log_solo = {}
        snaps = []
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            futs = []                        # (key, future), FIFO
            pending_solo = []                # mirrored demand
            for op in program:
                if op[0] == "submit":
                    core, client = registered[op[1] % len(registered)]
                    key = (core, client)
                    futs.append((key, af.submit(core, client, op[2],
                                                deadline_ms=op[3])))
                    pending_solo.append((core, client, op[2]))
                elif op[0] == "register":
                    core = f"core{op[1]}"
                    af.register(core, op[2], seed=900 + int(op[2][1:]))
                    solo.register(core, op[2], seed=900 + int(op[2][1:]))
                    registered.append((core, op[2]))
                elif op[0] == "flush":
                    fc.advance(1.0)
                    await af.drain()
                    for key, fut in futs:
                        log_async.setdefault(key, []).append(
                            np.asarray(fut.result()))
                    futs.clear()
                    for core, client, n in pending_solo:
                        solo.request(core, client, n)
                    if pending_solo:
                        out = solo.flush()
                        for core, per in out.items():
                            for client, w in per.items():
                                log_solo.setdefault((core, client),
                                                    []).append(w)
                    pending_solo.clear()
                elif op[0] == "snapshot":
                    snaps.append((await af.snapshot(), solo.snapshot(),
                                  list(registered)))
                else:
                    a, s, regs = snaps[op[1]]
                    af.restore(a)
                    solo.restore(s)
                    registered = list(regs)
        assert set(log_async) == set(log_solo)
        for key in log_async:
            np.testing.assert_array_equal(
                np.concatenate(log_async[key]),
                np.concatenate(log_solo[key]),
                err_msg=f"stream diverged for {key} (program={program})")

    _run(go())


# ---------------------------------------------------------------------------
# Clock unit behavior
# ---------------------------------------------------------------------------

def test_fake_clock_wait_semantics():
    async def go():
        fc = FakeClock()
        ev = asyncio.Event()

        async def sleeper():
            await fc.wait(ev, 5.0)
            return fc.now()

        task = asyncio.ensure_future(sleeper())
        for _ in range(5):                        # park the waiter
            await asyncio.sleep(0)
        fc.advance(2.0)
        for _ in range(5):
            await asyncio.sleep(0)
        assert not task.done()                    # woke, re-armed
        fc.advance(3.0)
        await asyncio.wait_for(task, 1.0)
        assert task.result() == 5.0

        # event set wakes immediately regardless of fake time
        t2 = asyncio.ensure_future(fc.wait(asyncio.Event(), None))
        await asyncio.sleep(0)
        assert not t2.done()
        t2.cancel()
        await asyncio.gather(t2, return_exceptions=True)
    _run(go())


def test_system_clock_is_a_clock():
    from repro_torch import clock
    from repro_torch.serve.clock import Clock
    assert isinstance(SystemClock(), Clock)
    assert isinstance(FakeClock(), Clock)
    # the serving tier's clocks ARE the package root's (a re-export)
    assert (Clock, FakeClock, SystemClock) == (
        clock.Clock, clock.FakeClock, clock.SystemClock)


# ---------------------------------------------------------------------------
# Executor offload: the loop stays live while a launch is in flight
# ---------------------------------------------------------------------------

class _GatedFlush:
    """Wrap ``farm.flush`` so each launch pass (``deliver=False``) blocks
    on a semaphore permit before running — it executes on the offload
    worker thread, so blocking it is safe and the event loop's liveness
    mid-launch becomes directly observable.  ``release()`` lets exactly
    one launch proceed (auto-re-arms for the next)."""

    def __init__(self, farm):
        self.farm = farm
        self.orig = farm.flush
        self.entered = threading.Event()
        self._sem = threading.Semaphore(0)

    def release(self):
        self._sem.release()

    def __call__(self, *a, **kw):
        if not kw.get("deliver", True):
            self.entered.set()
            assert self._sem.acquire(timeout=TEST_TIMEOUT), \
                "gated launch never released"
        return self.orig(*a, **kw)


def test_offload_keeps_loop_live_during_launch():
    """While a gated launch is in flight on the worker thread, the event
    loop still serves zero-word draws, accepts submits, and prunes
    cancellations — and none of that traffic interleaves into the
    in-flight launch (single-flight)."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=2)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            g = _GatedFlush(farm)
            farm.flush = g
            slow = af.submit("core0", "t", 64, deadline_ms=0)
            while not af.in_flight:             # commit happened, launch live
                await asyncio.sleep(0)
            # the loop is demonstrably live mid-launch:
            z = await af.draw("core0", "t", 0)          # round-trips NOW
            assert z.size == 0 and af.in_flight
            rider = af.submit("core1", "t", 32, deadline_ms=0)
            doomed = af.submit("core0", "t", 500, deadline_ms=10_000)
            doomed.cancel()
            assert not slow.done()              # still gated
            g.release()                         # permit: the gated launch
            g.release()                         # permit: rider's own flush
            await af.drain()
            assert slow.done() and rider.done() and doomed.cancelled()
            farm.flush = g.orig
            later = await af.draw("core0", "t", 90)
            # rider arrived mid-launch => NOT folded into the in-flight
            # launch; it rode its own later flush
            assert farm.launches >= 2
        solo = _farm(gang=False, n_cores=2)
        np.testing.assert_array_equal(slow.result(),
                                      solo.draw("core0", "t", 64))
        np.testing.assert_array_equal(rider.result(),
                                      solo.draw("core1", "t", 32))
        # the cancelled 500 never reached any farm
        np.testing.assert_array_equal(later, solo.draw("core0", "t", 90))
    _run(go())


def test_offload_off_matches_offload_on_bit_for_bit():
    """offload=False pins the on-loop launch path; served words must be
    bit-identical between the two modes (and to solo)."""
    def serve(offload):
        out = []

        async def go():
            fc = FakeClock()
            farm = _farm(clock=fc, n_cores=2)
            async with AsyncOscillatorFarm(farm, clock=fc,
                                           offload=offload) as af:
                out.append(await af.draw("core0", "t", 200, deadline_ms=0))
                out.append(await af.draw("core1", "t", 75, deadline_ms=0))
                out.append(await af.draw("core0", "t", 130, deadline_ms=0))
        _run(go())
        return out

    a, b = serve(True), serve(False)
    solo = _farm(gang=False, n_cores=2)
    ref = [solo.draw("core0", "t", 200), solo.draw("core1", "t", 75),
           solo.draw("core0", "t", 130)]
    for wa, wb, wr in zip(a, b, ref):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(wa, wr)


# ---------------------------------------------------------------------------
# SLO classes shape the launch, never the words
# ---------------------------------------------------------------------------

def test_slo_latency_forbids_padded_launch():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=2)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            fa = af.submit("core0", "t", 128, deadline_ms=0, slo="latency")
            fb = af.submit("core1", "t", 128 * 40, deadline_ms=0)
            await af.drain()
            dec = farm.plan_decisions
            assert sum(dec.values()) >= 1
            # a latency tenant on a skewed group: padded group-max (which
            # would make core0 wait out core1's 40 rows) is off the table
            assert dec.get("padded", 0) == 0, dec
        solo = _farm(gang=False, n_cores=2)
        np.testing.assert_array_equal(fa.result(),
                                      solo.draw("core0", "t", 128))
        np.testing.assert_array_equal(fb.result(),
                                      solo.draw("core1", "t", 128 * 40))
    _run(go())


def test_slo_bulk_forces_padded_launch():
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=2)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            fa = af.submit("core0", "t", 128, deadline_ms=0, slo="bulk")
            fb = af.submit("core1", "t", 128 * 40, deadline_ms=0, slo="bulk")
            await af.drain()
            dec = farm.plan_decisions
            assert dec.get("padded", 0) == sum(dec.values()) >= 1, dec
            # with this much skew the free planner would NOT pick padded:
            # the bulk class forced it, and the farm counts that
            assert farm.slo_forced["bulk"] >= 1
        solo = _farm(gang=False, n_cores=2)
        np.testing.assert_array_equal(fa.result(),
                                      solo.draw("core0", "t", 128))
        np.testing.assert_array_equal(fb.result(),
                                      solo.draw("core1", "t", 128 * 40))
    _run(go())


def test_slo_validated_at_submit():
    async def go():
        farm = _farm()
        async with AsyncOscillatorFarm(farm) as af:
            with pytest.raises(ValueError, match="slo"):
                af.submit("core0", "t", 8, slo="gold-tier")
    _run(go())


# ---------------------------------------------------------------------------
# Satellite regressions: front-end lifecycle bugs
# ---------------------------------------------------------------------------

def test_draw_sync_timeout_prunes_queued_request():
    """S1: a timed-out draw_sync must not leak its request — the queued
    future is cancelled, the demand never reaches the farm, and the
    admission gauge is released (FakeClock: the flush deadline is far in
    fake-future, so without the fix the request would sit forever)."""
    from repro_torch.serve.admission import AdmissionController
    fc = FakeClock()
    farm = _farm(clock=fc)
    ac = AdmissionController(max_queued_rows=2, clock=fc)
    af = AsyncOscillatorFarm(farm, clock=fc, admission=ac).start_thread()
    try:
        with pytest.raises(concurrent.futures.TimeoutError):
            af.draw_sync("core0", "t", 256, deadline_ms=10_000, timeout=0.05)
        # the prune is prompt (the timeout path wakes the flusher): the
        # gauge frees without any fake-time advance
        deadline = time.monotonic() + TEST_TIMEOUT
        while ac.queued_rows and time.monotonic() < deadline:
            time.sleep(0.002)
        assert ac.queued_rows == 0
        assert af.pending_requests == 0
        # and the farm never saw the demand: next words match a solo farm
        # that never had the timed-out request
        out = af.draw_sync("core0", "t", 64, deadline_ms=0,
                           timeout=TEST_TIMEOUT)
    finally:
        af.close()
    solo = _farm(gang=False)
    np.testing.assert_array_equal(out, solo.draw("core0", "t", 64))


def test_draw_sync_timeout_after_commit_reparks_words():
    """S1 (committed half): once the flush committed the request, it can't
    be un-launched — on timeout its words are re-parked on the sync
    surface instead of stranding in a future nobody reads."""
    fc = FakeClock()
    farm = _farm(clock=fc)
    af = AsyncOscillatorFarm(farm, clock=fc).start_thread()
    g = _GatedFlush(farm)
    try:
        farm.flush = g
        with pytest.raises(concurrent.futures.TimeoutError):
            # deadline 0: the flusher commits + launches immediately; the
            # gate holds the launch past our real-time wait
            af.draw_sync("core0", "t", 150, deadline_ms=0, timeout=0.5)
        assert g.entered.is_set()          # the request WAS committed
        g.release()
        deadline = time.monotonic() + TEST_TIMEOUT
        while (farm.services["core0"].outbox_words("t") < 150
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert farm.services["core0"].outbox_words("t") == 150
    finally:
        farm.flush = g.orig
        af.close()
    out = farm.flush()                     # launch-free outbox delivery
    solo = _farm(gang=False)
    np.testing.assert_array_equal(out["core0"]["t"],
                                  solo.draw("core0", "t", 150))


def test_flush_now_before_start_raises_cleanly():
    """S2: flush_now() on a never-started front-end must refuse up front —
    not half-run (ingest + farm.flush) and then crash on the missing
    loop."""
    async def go():
        farm = _farm()
        af = AsyncOscillatorFarm(farm)
        with pytest.raises(RuntimeError, match="not started"):
            await af.flush_now()
        assert farm.launches == 0          # nothing half-ran
        async with af:                     # still perfectly startable
            out = await af.draw("core0", "t", 16)
            assert out.size == 16
    _run(go())


def test_stats_and_error_windows_are_bounded():
    """S3: a long-running front-end must hold constant memory — miss
    samples and flush errors are ring buffers, and deadline_stats()
    reports the window, not all-time."""
    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc, stats_window=4,
                                       error_window=2) as af:
            words = []
            for _ in range(7):
                words.append(await af.draw("core0", "t", 8, deadline_ms=0))
            assert len(af.miss_samples_ms()) == 4          # not 7
            assert af.deadline_stats()["served_requests"] == 4.0
            orig = farm.flush

            def boom(*a, **kw):
                raise RuntimeError("injected")

            farm.flush = boom
            for _ in range(3):
                f = af.submit("core0", "t", 8, deadline_ms=0)
                await af.drain()
                assert isinstance(f.exception(), RuntimeError)
            assert len(af.flush_errors) == 2               # not 3
            farm.flush = orig
    _run(go())


def test_submit_refused_from_foreign_thread():
    """S4: submit() from a non-loop thread used to race the queue
    unsynchronized and silently corrupt state; now it raises the same
    clear redirect draw_sync gives on the loop thread."""
    farm = _farm()
    af = AsyncOscillatorFarm(farm).start_thread()
    try:
        with pytest.raises(RuntimeError, match="draw_sync"):
            af.submit("core0", "t", 8, deadline_ms=0)
        # the supported cross-thread path still works
        out = af.draw_sync("core0", "t", 8, deadline_ms=0,
                           timeout=TEST_TIMEOUT)
        assert out.size == 8
    finally:
        af.close()


# ---------------------------------------------------------------------------
# Property-based: mid-launch submits/cancels under offload, bit for bit
# ---------------------------------------------------------------------------

@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=9_999))
def test_offload_midlaunch_interleaving_matches_solo(seed):
    """Random schedules where submits and cancels land WHILE a gated
    launch is in flight on the executor: per-tenant streams must stay
    bit-identical to the sync gang=False solo path — mid-launch arrivals
    ride the next cycle, cancels prune cleanly, nothing interleaves."""
    rng = random.Random(seed)

    async def go():
        fc = FakeClock()
        farm = _farm(clock=fc, n_cores=2, clients=("a", "b"))
        solo = _farm(gang=False, n_cores=2, clients=("a", "b"))
        tenants = [(f"core{i}", c) for i in range(2) for c in ("a", "b")]
        log_async = {}
        log_solo = {}
        g = _GatedFlush(farm)
        async with AsyncOscillatorFarm(farm, clock=fc) as af:
            farm.flush = g

            def submit_some(cancellable):
                batch = []
                for k, (core, c) in enumerate(
                        rng.sample(tenants, rng.randint(1, 4))):
                    n = rng.randint(1, 300)
                    f = af.submit(core, c, n, deadline_ms=0)
                    if cancellable and k > 0 and rng.random() < 0.35:
                        f.cancel()         # never reaches any farm
                    else:
                        batch.append((core, c, f, n))
                return batch

            batch = submit_some(cancellable=False)
            for _ in range(rng.randint(2, 3)):
                while not af.in_flight:     # the batch's launch is gated
                    await asyncio.sleep(0)
                # mid-launch traffic lands now, against a live loop
                next_batch = submit_some(cancellable=True)
                g.release()
                for core, c, f, n in batch:
                    log_async.setdefault((core, c), []).append(
                        np.asarray(await f))
                # mirror ONLY the committed batch into solo, same order
                for core, c, f, n in batch:
                    solo.request(core, c, n)
                out = solo.flush()
                for core, per in out.items():
                    for c, w in per.items():
                        log_solo.setdefault((core, c), []).append(w)
                batch = next_batch
            g.release()                     # final batch's launch
            for core, c, f, n in batch:
                log_async.setdefault((core, c), []).append(
                    np.asarray(await f))
            for core, c, f, n in batch:
                solo.request(core, c, n)
            out = solo.flush()
            for core, per in out.items():
                for c, w in per.items():
                    log_solo.setdefault((core, c), []).append(w)
            farm.flush = g.orig
        assert set(log_async) == set(log_solo)
        for key in log_async:
            np.testing.assert_array_equal(
                np.concatenate(log_async[key]),
                np.concatenate(log_solo[key]),
                err_msg=f"stream diverged for {key} (seed={seed})")

    _run(go())


# ---------------------------------------------------------------------------
# Against the JAX front-end
# ---------------------------------------------------------------------------

PARITY_CORES = ("chen", "lorenz", "rossler")      # committed 3-8-3 cores
# bf16, and short blocks: the JAX interpret compiles grow with t_block and
# unroll
BF16_CAND = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu",
                      dtype_bytes=2, unroll=1, t_block=4)


def parity_farms(clock_t, clock_j, faults_t=None, faults_j=None,
                 standby=()):
    """The port's and the JAX bf16 farm of the same three 3-8-3 cores on
    one config, the planner pinned to the padded launch (the two planners'
    cost models differ, and the fault schedule counts launches), with
    standbys on the same weights for ``standby``.  The JAX farm runs its
    Pallas kernels in interpret mode (its ``ref`` backend rounds bf16
    differently)."""
    import jax.numpy as jnp
    from repro.serve.farm import OscillatorFarm as JaxFarm
    tfarm = OscillatorFarm(planner=False, clock=clock_t, faults=faults_t,
                           device="cpu")
    jfarm = JaxFarm(planner=False, clock=clock_j, faults=faults_j)
    for f, dtype, kw in ((tfarm, torch.bfloat16, {}),
                         (jfarm, jnp.bfloat16,
                          {"backend": "pallas_interpret"})):
        for name in PARITY_CORES:
            f.add_core(name, _weights(name), config=BF16_CAND,
                       dtype=dtype, lanes_per_client=128, **kw)
        for name in standby:
            f.add_standby(name, _weights(name), config=BF16_CAND,
                          dtype=dtype, lanes_per_client=128, **kw)
    return tfarm, jfarm


def test_words_bitwise_vs_jax_frontend():
    """Two tenants a core through both front-ends, deadlines, riders and
    a cancelled request: every future resolves to the JAX front-end's
    words, bit for bit, in the same number of flushes."""
    from repro.serve.async_frontend import AsyncOscillatorFarm as JaxAsync
    from repro.serve.clock import FakeClock as JaxClock

    async def serve(af, fc):
        for core in PARITY_CORES:
            for j, c in enumerate(("a", "b")):
                af.register(core, c, seed=50 + j)
        got = []
        for round_ in range(3):
            futs = [af.submit(core, c, 100 + 77 * round_ + 13 * k,
                              deadline_ms=5 * (k % 3))
                    for k, (core, c) in enumerate(
                        (core, c) for core in PARITY_CORES
                        for c in ("a", "b"))]
            doomed = af.submit("lorenz", "a", 999, deadline_ms=10_000)
            doomed.cancel()
            fc.advance(0.01)
            await af.drain()
            got += [np.asarray(f.result()) for f in futs]
        return got, af.flushes

    out = {}

    async def go():
        tc, jc = FakeClock(), JaxClock()
        tfarm, jfarm = parity_farms(tc, jc)
        async with AsyncOscillatorFarm(tfarm, clock=tc) as af:
            out["torch"] = await serve(af, tc)
        async with JaxAsync(jfarm, clock=jc) as af:
            out["jax"] = await serve(af, jc)

    _run(go())
    (tw, tn), (jw, jn) = out["torch"], out["jax"]
    assert tn == jn == 3
    assert len(tw) == len(jw) == 18
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
