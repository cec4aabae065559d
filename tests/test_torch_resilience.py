"""The port's self-healing farm (``repro_torch.serve``: faults, health,
admission, journal, the async front-end) on the CPU.

A mirror of ``tests/test_resilience.py``, FakeClock-driven: storms of
transient launch failures, exponential-backoff retries, circuit-breaker
quarantines and standby rotations all run with zero real sleeps.

* a transiently failed launch never reached ``absorb()``, so a retried
  flush serves words bit-identical to a never-failed one;
* a core that keeps failing trips its breaker and is quarantined: its
  tenants get a typed ``CoreQuarantined``, its gang re-plans without it,
  and every other tenant's words stay bit-identical to a fault-free run;
* a core whose sampled words go bad is quarantined within bounded flushes
  and its standby rotated in;
* the journal records quarantines and rotations, so kill-and-replay
  rebuilds the degraded topology.

Against the JAX package, on the same inputs: ``FaultPlan`` schedules and
counters, ``HealthMonitor`` backoffs, breaker trips and window verdicts,
and the whole supervised front-end over bf16 farms of the same three
3-8-3 cores under one fault plan (words, retries, the quarantined core and
its flush, the rotation).

The JAX suite's last case restores a snapshot of a farm sharded over two
devices onto an unsharded one: here on a mesh that lists the CPU twice
(``test_restore_replan_across_device_counts_keeps_quarantine``), beside
the same refuse/replan contract held on a snapshot that records a
hand-written mesh topology
(``test_restore_replan_of_a_sharded_snapshot_keeps_quarantine``).

Launch-fault tests use toy weights with a never-filling sample window;
quality-gate tests use the trained registry weights, whose streams pass,
so only the FaultPlan's poisoned sampling fails them.
"""
import asyncio

import numpy as np
import pytest

from repro_torch.prng.stream import default_params
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.async_frontend import AsyncOscillatorFarm
from repro_torch.serve.clock import FakeClock
from repro_torch.serve.farm import OscillatorFarm as _Farm
from repro_torch.serve.faults import FaultPlan, InjectedFault
from repro_torch.serve.health import CoreQuarantined, HealthMonitor
from repro_torch.serve.journal import replay_journal

from test_torch_async_frontend import (PARITY_CORES, _farm, _run,
                                       parity_farms)


def OscillatorFarm(**kw):
    """The port's farm on the CPU."""
    return _Farm(device="cpu", **kw)

# Launch-fault tests: a window this large never fills from test traffic,
# so the quality gate stays silent and only launch supervision is on
# trial (toy test weights would fail any honest NIST gate).
BIG_WINDOW = 1 << 20


def _health(**kw):
    kw.setdefault("window_words", BIG_WINDOW)
    kw.setdefault("backoff_base_ms", 5.0)
    return HealthMonitor(**kw)


async def _drive(fc, futs, rounds=400, step_s=0.05):
    """Pump the loop + fake time until every future settles."""
    for _ in range(rounds):
        await asyncio.sleep(0)
        fc.advance(step_s)
        if all(f.done() for f in futs):
            return
    raise AssertionError(
        f"futures never settled: "
        f"{sum(1 for f in futs if not f.done())} still pending")


def _trained_farm(n_cores=3, clock=None, faults=None, standby_for=()):
    """Trained-registry cores (words pass the online gate) — the quality
    monitor only condemns what the FaultPlan poisons."""
    params = default_params(system="chen")
    farm = OscillatorFarm(gang=True, clock=clock, faults=faults)
    for i in range(n_cores):
        farm.add_core(f"core{i}", params, lanes_per_client=128)
        farm.register(f"core{i}", "t", seed=40)
    for core in standby_for:
        farm.add_standby(core, params, lanes_per_client=128)
    return farm


def _trained_solo_words(rounds, n_words=300):
    """Reference stream: one trained core served solo from registration."""
    params = default_params(system="chen")
    farm = OscillatorFarm(gang=False)
    farm.add_core("c", params, lanes_per_client=128)
    farm.register("c", "t", seed=40)
    return [farm.draw("c", "t", n_words) for _ in range(rounds)]


# ---------------------------------------------------------------------------
# FaultPlan: deterministic, replayable schedules
# ---------------------------------------------------------------------------

def _schedule(plan, launches=64):
    out = []
    for _ in range(launches):
        try:
            plan.on_launch(["a", "b"])
            out.append(False)
        except InjectedFault:
            out.append(True)
    return out


def test_fault_plan_same_seed_same_schedule():
    a = _schedule(FaultPlan(seed=7, transient_rate=0.3))
    b = _schedule(FaultPlan(seed=7, transient_rate=0.3))
    assert a == b and any(a)
    assert _schedule(FaultPlan(seed=8, transient_rate=0.3)) != a


def test_fault_plan_draw_per_launch_regardless_of_outcome():
    # the schedule depends only on the launch SEQUENCE: capping injected
    # faults must not shift later draws
    full = _schedule(FaultPlan(seed=7, transient_rate=0.3))
    capped_plan = FaultPlan(seed=7, transient_rate=0.3, max_transients=2)
    capped = _schedule(capped_plan)
    k = [i for i, hit in enumerate(full) if hit][1]
    assert capped[:k + 1] == full[:k + 1]
    assert capped_plan.injected["transient"] == 2
    assert not any(capped[k + 1:])


def test_fault_plan_scoping_and_arming():
    plan = FaultPlan(seed=0, transient_rate=1.0, transient_cores={"x"})
    plan.on_launch(["a", "b"])                    # not eligible: no x
    with pytest.raises(InjectedFault):
        plan.on_launch(["a", "x"])
    plan.disarm()
    plan.on_launch(["x"])                         # disarmed: no injection
    plan.arm()
    pers = FaultPlan(persistent_cores={"p"})
    with pytest.raises(InjectedFault) as ei:
        pers.on_launch(["a", "p"])
    assert ei.value.cores == ("p",) and ei.value.persistent
    pers.heal("p")
    pers.on_launch(["a", "p"])                    # healed
    with pytest.raises(ValueError):
        FaultPlan(transient_rate=1.5)


def test_failed_sync_flush_leaves_demand_parked_bit_exact():
    """A failed launch never absorbs: the SAME flush retried serves the
    same words — the bit-identity-by-construction the retry loop rests
    on, shown on the bare sync farm."""
    faults = FaultPlan(persistent_cores={"core0"})
    farm = _farm(n_cores=1, faults=faults)
    clean = _farm(n_cores=1)
    farm.request("core0", "t", 500)
    clean.request("core0", "t", 500)
    with pytest.raises(InjectedFault):
        farm.flush()
    assert farm.services["core0"].rows_needed() > 0   # demand still parked
    faults.heal("core0")
    out = farm.flush()
    ref = clean.flush()
    assert np.array_equal(out["core0"]["t"], ref["core0"]["t"])


# ---------------------------------------------------------------------------
# HealthMonitor policy units
# ---------------------------------------------------------------------------

def test_backoff_capped_exponential_with_bounded_jitter():
    h = HealthMonitor(backoff_base_ms=5.0, backoff_cap_ms=40.0,
                      backoff_jitter=0.25, seed=3)
    for attempt, base in ((1, 5.0), (2, 10.0), (3, 20.0), (4, 40.0),
                          (5, 40.0), (9, 40.0)):
        ms = h.backoff_ms(attempt)
        assert base <= ms <= base * 1.25, (attempt, ms)
    with pytest.raises(ValueError):
        h.backoff_ms(0)
    # seeded: two monitors replay the identical jitter sequence
    a = HealthMonitor(seed=11)
    b = HealthMonitor(seed=11)
    assert [a.backoff_ms(i) for i in (1, 2, 3)] == \
           [b.backoff_ms(i) for i in (1, 2, 3)]


def test_breaker_counts_consecutive_failures_only():
    h = HealthMonitor(breaker_threshold=3)
    assert h.note_launch_failure(["a", "b"]) == []
    assert h.note_launch_failure(["a"]) == []
    h.note_launch_success(["a"])                  # streak broken
    assert h.note_launch_failure(["a"]) == []
    assert h.note_launch_failure(["a"]) == []
    assert h.note_launch_failure(["a", "b"]) == ["a"]   # a: 3rd consecutive
    assert h.consecutive_failures("b") == 2
    assert h.stats["breaker_trips"] == 1


def test_monitor_windows_pop_exactly_and_memory_is_bounded():
    h = HealthMonitor(window_words=256)
    rng = np.random.default_rng(0)
    h.ingest("c", rng.integers(0, 2**32, 200, dtype=np.uint32))
    assert h.evaluate() == {}                     # window not full yet
    h.ingest("c", rng.integers(0, 2**32, 200, dtype=np.uint32))
    assert h.buffered_words("c") == 400
    verdicts = h.evaluate()                       # healthy words: no verdict
    assert verdicts == {}
    assert h.buffered_words("c") == 400 - 256     # rest carried over
    for _ in range(100):
        h.ingest("c", rng.integers(0, 2**32, 10_000, dtype=np.uint32))
    assert h.buffered_words("c") <= 2 * 256       # hard memory bound
    h.reset("c")
    assert h.buffered_words("c") == 0


def test_monitor_hard_failure_condemns_in_one_window():
    h = HealthMonitor(window_words=256)
    rng = np.random.default_rng(0)
    poisoned = rng.integers(0, 2**32, 256, dtype=np.uint32) & np.uint32(
        0xFFFF0000)
    h.ingest("bad", poisoned)
    verdicts = h.evaluate()
    assert "bad" in verdicts
    assert "monobit" in verdicts["bad"]["gate"]["hard_failed_tests"]
    assert h.stats["quality_quarantines"] == 1


# ---------------------------------------------------------------------------
# Supervised front-end: transient retries are invisible in the words
# ---------------------------------------------------------------------------

def test_transient_retries_serve_bit_identical_words():
    results = {}

    async def faulty():
        fc = FakeClock()
        faults = FaultPlan(seed=3, transient_rate=0.5, max_transients=4)
        health = _health(breaker_threshold=10, seed=1)
        farm = _farm(clock=fc, faults=faults)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health) as af:
            futs = [af.submit(f"core{i}", "t", 300) for i in range(3)]
            await _drive(fc, futs)
            results["faulty"] = [f.result() for f in futs]
        assert faults.injected["transient"] > 0
        assert health.stats["retries"] > 0
        assert health.stats["breaker_trips"] == 0

    async def clean():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False) as af:
            futs = [af.submit(f"core{i}", "t", 300) for i in range(3)]
            await _drive(fc, futs)
            results["clean"] = [f.result() for f in futs]

    _run(faulty())
    _run(clean())
    for a, b in zip(results["faulty"], results["clean"]):
        assert np.array_equal(a, b)


def test_retry_budget_exhausted_propagates_to_futures():
    async def go():
        fc = FakeClock()
        faults = FaultPlan(seed=0, transient_rate=1.0, max_transients=None)
        # threshold above the retry budget: the breaker never trips, the
        # budget runs out first and the error reaches the tenants
        health = _health(breaker_threshold=100, max_retries_per_flush=2)
        farm = _farm(n_cores=1, clock=fc, faults=faults)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health) as af:
            fut = af.submit("core0", "t", 100)
            await _drive(fc, [fut])
            assert isinstance(fut.exception(), InjectedFault)
            assert health.stats["retries"] == 2
            assert len(af.flush_errors) >= 1
    _run(go())


# ---------------------------------------------------------------------------
# Circuit breaker: quarantine, re-planned gang, typed errors
# ---------------------------------------------------------------------------

def test_breaker_quarantines_core_and_group_replans_without_it():
    healthy_words = {}

    async def storm():
        fc = FakeClock()
        faults = FaultPlan(persistent_cores={"core1"})
        health = _health(breaker_threshold=3)
        farm = _farm(clock=fc, faults=faults)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health) as af:
            f_bad = af.submit("core1", "t", 100)
            f_ok = [af.submit(f"core{i}", "t", 100) for i in (0, 2)]
            await _drive(fc, f_ok + [f_bad])
            err = f_bad.exception()
            assert isinstance(err, CoreQuarantined)
            assert err.core == "core1" and not err.rotated
            assert farm.quarantined == frozenset({"core1"})
            assert health.stats["breaker_trips"] == 1
            healthy_words["storm"] = [f.result() for f in f_ok]
            # fail-fast at submit for the dead core, typed
            with pytest.raises(CoreQuarantined):
                af.submit("core1", "t", 10)
            # the re-planned group (core0+core2) keeps serving
            f2 = [af.submit(f"core{i}", "t", 50) for i in (0, 2)]
            await _drive(fc, f2)
            assert all(f.exception() is None for f in f2)

    async def clean():
        fc = FakeClock()
        farm = _farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False) as af:
            futs = [af.submit(f"core{i}", "t", 100) for i in (0, 2)]
            await _drive(fc, futs)
            healthy_words["clean"] = [f.result() for f in futs]

    _run(storm())
    _run(clean())
    for a, b in zip(healthy_words["storm"], healthy_words["clean"]):
        assert np.array_equal(a, b)


def test_quarantine_without_standby_shrinks_admission_ceiling():
    async def go():
        fc = FakeClock()
        faults = FaultPlan(persistent_cores={"core1"})
        health = _health(breaker_threshold=2)
        adm = AdmissionController(max_queued_rows=300, clock=fc)
        farm = _farm(clock=fc, faults=faults)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health, admission=adm) as af:
            assert adm.current_ceiling == 300
            fut = af.submit("core1", "t", 100)
            await _drive(fc, [fut])
            assert isinstance(fut.exception(), CoreQuarantined)
            # 2 of 3 cores healthy: the ceiling shrinks with capacity
            assert adm.capacity_factor == pytest.approx(2 / 3)
            assert adm.current_ceiling == 200
            assert adm.stats()["capacity_factor"] == pytest.approx(2 / 3)
    _run(go())


# ---------------------------------------------------------------------------
# Online quality gate: poisoned sampling -> quarantine + rotation
# ---------------------------------------------------------------------------

def test_poisoned_core_rotates_within_three_flushes_bit_exact():
    rotated_words = []

    async def go():
        fc = FakeClock()
        faults = FaultPlan(poison={"core0"})
        health = HealthMonitor(window_words=256)
        adm = AdmissionController(max_queued_rows=10_000, clock=fc)
        farm = _trained_farm(clock=fc, faults=faults,
                             standby_for=("core0",))
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health, admission=adm) as af:
            rotated_at = None
            for round_ in range(4):
                futs = [af.submit(f"core{i}", "t", 300) for i in range(3)]
                await _drive(fc, futs)
                for i, f in enumerate(futs):
                    assert f.exception() is None, (round_, i, f.exception())
                rotated_words.append(futs[0].result())
                if rotated_at is None and farm.rotations.get("core0") == 1:
                    rotated_at = round_ + 1
            # the acceptance bound: quarantined + rotated within 3 flushes
            assert rotated_at is not None and rotated_at <= 3
            assert health.stats["quality_quarantines"] == 1
            assert farm.quarantined == frozenset()       # rotation lifted it
            assert adm.capacity_factor == 1.0            # capacity restored

    _run(go())
    # Bit-identity across the rotation: the rounds before it match the
    # original core served solo; the rounds after match the STANDBY
    # served solo from registration (same seed, row 0) — delivered words
    # were never corrupted (only the monitor's samples were).
    n = len(rotated_words)
    for split in range(n + 1):
        ref = _trained_solo_words(split) + _trained_solo_words(n - split)
        if all(np.array_equal(a, b) for a, b in zip(rotated_words, ref)):
            assert 0 < split <= 3    # rotation actually happened mid-run
            return
    raise AssertionError("rotated-core words match no rotation point")


def test_standby_samples_clean_after_rotation():
    """Poison binds to the PHYSICAL service: after rotation the monitor
    sees the standby's honest words and never re-condemns the slot."""
    async def go():
        fc = FakeClock()
        faults = FaultPlan(poison={"core0"})
        health = HealthMonitor(window_words=256)
        farm = _trained_farm(n_cores=1, clock=fc, faults=faults,
                             standby_for=("core0",))
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health) as af:
            for _ in range(6):
                fut = af.submit("core0", "t", 300)
                await _drive(fc, [fut])
                assert fut.exception() is None
            assert farm.rotations.get("core0") == 1   # exactly one rotation
            assert health.stats["quality_quarantines"] == 1
            assert faults.injected["corrupted_samples"] > 0
    _run(go())


# ---------------------------------------------------------------------------
# The storm acceptance test: transients + a poisoned core, all at once
# ---------------------------------------------------------------------------

def test_storm_every_admitted_request_bit_identical_to_solo():
    served = []     # (round, core_index, words) for every resolved future

    async def go():
        fc = FakeClock()
        # seed chosen so the 10% coin actually lands at least once in
        # this short run (seeded schedule: same seed, same storm)
        faults = FaultPlan(seed=2, transient_rate=0.10, poison={"core0"})
        health = HealthMonitor(window_words=256, breaker_threshold=5,
                               backoff_base_ms=5.0)
        farm = _trained_farm(clock=fc, faults=faults,
                             standby_for=("core0",))
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health) as af:
            for round_ in range(5):
                futs = [af.submit(f"core{i}", "t", 300) for i in range(3)]
                await _drive(fc, futs)
                for i, f in enumerate(futs):
                    # under this storm every request resolves (transients
                    # retry, the poisoned core rotates) — a CoreQuarantined
                    # here would also be acceptable per the contract, but
                    # must then be typed
                    if f.exception() is not None:
                        assert isinstance(f.exception(), CoreQuarantined)
                        continue
                    served.append((round_, i, f.result()))
            assert farm.rotations.get("core0") == 1
        assert faults.injected["transient"] > 0
        assert faults.injected["corrupted_samples"] > 0

    _run(go())
    # every served word bit-identical to a fault-free solo run of the
    # same per-round demand (core0: try all rotation split points)
    rounds = 5
    solo = {i: _trained_solo_words(rounds) for i in (1, 2)}
    for round_, i, words in served:
        if i == 0:
            continue
        assert np.array_equal(words, solo[i][round_]), (round_, i)
    core0 = [(r, w) for r, i, w in served if i == 0]
    n0 = len(core0)
    for split in range(rounds + 1):
        ref = _trained_solo_words(split) + _trained_solo_words(rounds - split)
        got = [np.array_equal(w, ref[r]) for r, w in core0]
        if all(got):
            return
    raise AssertionError("core0 storm words match no rotation split")


# ---------------------------------------------------------------------------
# Kill-and-replay reconstructs the DEGRADED topology from the journal
# ---------------------------------------------------------------------------

def test_kill_and_replay_reconstructs_quarantine_and_rotation(tmp_path):
    jpath = tmp_path / "storm.journal"
    params = default_params(system="chen")
    live_tail = {}

    async def serve_through_storm():
        fc = FakeClock()
        faults = FaultPlan(persistent_cores={"core1"}, poison={"core0"})
        health = HealthMonitor(window_words=256, breaker_threshold=2)
        # bare cores: EVERY registration goes through the front-end so
        # the journal alone can rebuild the client set
        farm = OscillatorFarm(gang=True, clock=fc, faults=faults)
        for i in range(3):
            farm.add_core(f"core{i}", params, lanes_per_client=128)
        farm.add_standby("core0", params, lanes_per_client=128)
        async with AsyncOscillatorFarm(farm, clock=fc, offload=False,
                                       health=health, journal=jpath) as af:
            for i in range(3):
                af.register(f"core{i}", "j", seed=77)
            f_bad = af.submit("core1", "j", 100)
            futs = [af.submit(f"core{i}", "j", 300) for i in (0, 2)]
            await _drive(fc, futs + [f_bad])
            assert isinstance(f_bad.exception(), CoreQuarantined)
            for _ in range(2):       # poisoned core0 rotates along the way
                futs = [af.submit(f"core{i}", "j", 300) for i in (0, 2)]
                await _drive(fc, futs)
                assert all(f.exception() is None for f in futs)
            assert farm.quarantined == frozenset({"core1"})
            assert farm.rotations.get("core0") == 1
            # the continuation a correct replay must reproduce
            live_tail["core0"] = farm.draw("core0", "j", 128)
            live_tail["core2"] = farm.draw("core2", "j", 128)

    _run(serve_through_storm())

    # a NEW process: same cores + the same standby, journal only
    reborn = OscillatorFarm(gang=True)
    for i in range(3):
        reborn.add_core(f"core{i}", params, lanes_per_client=128)
    reborn.add_standby("core0", params, lanes_per_client=128)
    summary = replay_journal(reborn, jpath)
    # two quarantine events (core1 by breaker; core0 by quality gate,
    # then lifted by its rotation) and one rotation
    assert summary["quarantines"] == 2 and summary["rotations"] == 1
    assert reborn.quarantined == frozenset({"core1"})
    assert reborn.rotations == {"core0": 1}
    with pytest.raises(CoreQuarantined):
        reborn.draw("core1", "j", 10)
    for core in ("core0", "core2"):
        assert np.array_equal(reborn.draw(core, "j", 128), live_tail[core])


# ---------------------------------------------------------------------------
# S4: restore(replan) composed with a quarantined/rotated topology
# ---------------------------------------------------------------------------

def _quarantined_snapshot(params):
    """A farm mid-life: core1 quarantined, core0 already rotated once."""
    farm = OscillatorFarm(gang=True)
    for i in range(3):
        farm.add_core(f"core{i}", params, lanes_per_client=128)
        farm.register(f"core{i}", "t", seed=40)
    farm.add_standby("core0", params, lanes_per_client=128)
    for i in range(3):
        farm.draw(f"core{i}", "t", 200)
    farm.quarantine("core0", reason="drill")
    farm.rotate("core0")
    farm.draw("core0", "t", 100)
    farm.quarantine("core1", reason="dead")
    snap = farm.snapshot()
    tail = {c: farm.draw(c, "t", 64) for c in ("core0", "core2")}
    return snap, tail


def test_restore_preserves_quarantine_set_and_rotations():
    params = default_params(system="chen")
    snap, tail = _quarantined_snapshot(params)
    assert snap["quarantined"] == ["core1"]
    assert snap["rotations"] == {"core0": 1}
    target = OscillatorFarm(gang=True)
    for i in range(3):
        target.add_core(f"core{i}", params, lanes_per_client=128)
    target.add_standby("core0", params, lanes_per_client=128)
    target.restore(snap)
    assert target.quarantined == frozenset({"core1"})
    assert target.rotations == {"core0": 1}
    with pytest.raises(CoreQuarantined):
        target.request("core1", "t", 10)
    for c in ("core0", "core2"):
        assert np.array_equal(target.draw(c, "t", 64), tail[c])


def test_restore_refuses_to_unrotate():
    params = default_params(system="chen")
    snap, _ = _quarantined_snapshot(params)
    target = OscillatorFarm(gang=True)
    for i in range(3):
        target.add_core(f"core{i}", params, lanes_per_client=128)
        target.register(f"core{i}", "t", seed=40)
    target.add_standby("core0", params, lanes_per_client=128)
    target.add_standby("core1", params, lanes_per_client=128)
    target.quarantine("core1", reason="x")
    target.rotate("core1")           # rotation the snapshot never saw
    with pytest.raises(ValueError, match="un-rotate"):
        target.restore(snap)


def test_restore_replan_of_a_sharded_snapshot_keeps_quarantine():
    """A snapshot that records a mesh topology (what a sharded JAX farm
    writes) refuses to restore onto the one-device port farm by default;
    ``on_topology_mismatch='replan'`` restores it with the quarantine set
    and the rotation count, and streams continue bit-exactly."""
    params = default_params(system="chen")
    snap, tail = _quarantined_snapshot(params)
    assert snap["topology"] == {f"core{i}": None for i in range(3)}
    snap["topology"] = {c: ["data", 2, [0, 1]] for c in snap["topology"]}
    target = OscillatorFarm(gang=True)
    for i in range(3):
        target.add_core(f"core{i}", params, lanes_per_client=128)
    target.add_standby("core0", params, lanes_per_client=128)
    with pytest.raises(ValueError, match="topology"):
        target.restore(snap)                        # refuse by default
    with pytest.raises(ValueError, match="on_topology_mismatch"):
        target.restore(snap, on_topology_mismatch="ignore")
    target.restore(snap, on_topology_mismatch="replan")
    assert target.quarantined == frozenset({"core1"})
    assert target.rotations == {"core0": 1}
    for c in ("core0", "core2"):
        assert np.array_equal(target.draw(c, "t", 64), tail[c])


def test_restore_replan_across_device_counts_keeps_quarantine():
    """The S4 composition on a real mesh: a snapshot of a DEGRADED farm
    sharded over two mesh entries restores onto an unsharded farm only
    with ``on_topology_mismatch='replan'``; quarantine set and rotation
    count survive, streams continue bit-exactly."""
    from repro_torch.distributed.sharding import DeviceMesh
    mesh = DeviceMesh(["cpu", "cpu"])
    params = default_params(system="chen")
    farm = OscillatorFarm(gang=True)
    for i in range(2):
        farm.add_core(f"core{i}", params, lanes_per_client=128, mesh=mesh)
        farm.register(f"core{i}", "t", seed=40)
    farm.add_standby("core0", params, lanes_per_client=128, mesh=mesh)
    farm.draw("core0", "t", 200)
    farm.quarantine("core0", reason="drill")
    farm.rotate("core0")
    farm.quarantine("core1", reason="dead")
    snap = farm.snapshot()
    assert snap["topology"] == {c: ("data", 2, (0, 0))
                                for c in ("core0", "core1")}
    tail = farm.draw("core0", "t", 64)
    assert sum(mesh.shard_launches) > 0

    unsharded = OscillatorFarm(gang=True)
    for i in range(2):
        unsharded.add_core(f"core{i}", params, lanes_per_client=128)
    unsharded.add_standby("core0", params, lanes_per_client=128)
    with pytest.raises(ValueError, match="topology"):
        unsharded.restore(snap)                     # refuse by default
    unsharded.restore(snap, on_topology_mismatch="replan")
    assert unsharded.quarantined == frozenset({"core1"})
    assert unsharded.rotations == {"core0": 1}
    assert np.array_equal(unsharded.draw("core0", "t", 64), tail)


# ---------------------------------------------------------------------------
# Against the JAX package: the same objects on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=7, transient_rate=0.3),
    dict(seed=2, transient_rate=0.1, max_transients=3),
    dict(seed=5, transient_rate=0.5, transient_cores={"b", "x"}),
    dict(seed=0, transient_rate=0.2, persistent_cores={"p"}),
], ids=["rate", "capped", "scoped", "persistent"])
def test_fault_plan_schedule_equals_jax(kw):
    """Launch after launch over shifting core sets, with a heal and a
    disarmed stretch: the same raises (type, cores, persistence) and the
    same ``injected`` counters as the JAX plan of the same seed."""
    from repro.serve.faults import FaultPlan as JaxPlan

    def run(plan):
        out = []
        for i in range(96):
            cores = [["a", "b"], ["b"], ["a", "p"], ["x"]][i % 4]
            if i == 60:
                plan.heal("p")
            if i == 70:
                plan.disarm()
            if i == 80:
                plan.arm()
            try:
                plan.on_launch(cores)
                out.append(None)
            except Exception as e:      # noqa: BLE001 - compared below
                out.append((type(e).__name__, e.cores, e.persistent,
                            str(e)))
        return out, dict(plan.injected)

    assert run(FaultPlan(**kw)) == run(JaxPlan(**kw))


def test_fault_plan_sampling_and_delays_equal_jax():
    """``bind``/``corrupt_sample`` poison only the first bound service of
    a poisoned core, with the JAX mask, and ``on_flush`` advances the
    bound FakeClock as the JAX plan does."""
    from repro.serve.clock import FakeClock as JaxClock
    from repro.serve.faults import FaultPlan as JaxPlan
    words = np.random.default_rng(3).integers(0, 2**32, 512,
                                              dtype=np.uint32)
    outs = []
    for plan_cls, clock in ((FaultPlan, FakeClock()), (JaxPlan, JaxClock())):
        plan = plan_cls(poison={"c"}, delay_flush_s=0.25, clock=clock)
        bad, good = object(), object()
        plan.bind("c", bad)
        plan.bind("c", good)            # a second bind never re-targets
        plan.bind("d", bad)             # not poisoned
        got = [plan.corrupt_sample("c", bad, words),
               plan.corrupt_sample("c", good, words),
               plan.corrupt_sample("d", bad, words)]
        for _ in range(3):
            plan.on_flush()
        plan.heal("c")
        got.append(plan.corrupt_sample("c", bad, words))
        outs.append((got, dict(plan.injected), clock.now()))
    (tg, ti, tn), (jg, ji, jn) = outs
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a, b)
    assert ti == ji and tn == jn == 0.75
    assert not np.array_equal(tg[0], words)


def test_health_monitor_policy_equals_jax():
    """Backoffs (seeded jitter), breaker trips, streaks and stats of the
    port's monitor equal the JAX monitor's over one seeded sequence."""
    from repro.serve.health import HealthMonitor as JaxMonitor
    rng = np.random.default_rng(11)
    script = []
    for _ in range(200):
        r = rng.random()
        cores = sorted(rng.choice(["a", "b", "c"], rng.integers(1, 4),
                                  replace=False).tolist())
        script.append(("fail" if r < 0.5 else "ok" if r < 0.8 else "backoff",
                       cores, int(rng.integers(1, 9))))

    def run(mon):
        out = []
        for kind, cores, attempt in script:
            if kind == "fail":
                out.append(mon.note_launch_failure(cores))
            elif kind == "ok":
                mon.note_launch_success(cores)
                out.append([mon.consecutive_failures(c) for c in "abc"])
            else:
                out.append(mon.backoff_ms(attempt))
        return out, dict(mon.stats)

    kw = dict(breaker_threshold=3, backoff_base_ms=5.0, backoff_cap_ms=80.0,
              backoff_jitter=0.4, seed=9)
    assert run(HealthMonitor(**kw)) == run(JaxMonitor(**kw))


def test_health_monitor_windows_equal_jax():
    """Healthy, poisoned and soft-failing windows ingested in uneven
    slabs: the same verdicts, reasons, ``last_gate`` and counters."""
    from repro.serve.health import HealthMonitor as JaxMonitor
    rng = np.random.default_rng(5)
    good = rng.integers(0, 2**32, 6000, dtype=np.uint32)
    bad = good & np.uint32(0xFFFF0000)
    soft = good.copy()
    soft[::7] = 0                              # a mild, steady bias
    slabs = []
    for i in range(30):
        n = int(rng.integers(50, 900))
        slabs.append(("g", good[:n]))
        slabs.append(("s", soft[i * 97 % 4000:][:n]))
        if i in (11, 12):
            slabs.append(("b", bad[:n * 2]))

    def run(mon):
        verdicts = []
        for core, w in slabs:
            mon.ingest(core, w)
            verdicts.append(mon.evaluate())
        mon.reset("s")
        return (verdicts, dict(mon.stats), mon.last_gate,
                [mon.buffered_words(c) for c in "gsb"])

    kw = dict(window_words=512, soft_strikes=2)
    t, j = run(HealthMonitor(**kw)), run(JaxMonitor(**kw))
    assert t == j
    assert t[1]["quality_quarantines"] >= 1


def test_supervised_frontend_equals_jax_under_one_fault_plan(tmp_path):
    """Three bf16 3-8-3 cores (rossler poisoned, with a standby), seeded
    transient launch failures, small quality windows, a journal each: the
    port's and the JAX front-end serve every tenant the same words, retry
    the same number of times, quarantine the same core at the same flush
    for the same reason (the journals' events) and rotate the same standby
    in."""
    from repro.serve.async_frontend import AsyncOscillatorFarm as JaxAsync
    from repro.serve.clock import FakeClock as JaxClock
    from repro.serve.faults import FaultPlan as JaxPlan
    from repro.serve.health import HealthMonitor as JaxMonitor
    from repro.serve.journal import read_journal as jax_read_journal
    from repro_torch.serve.journal import read_journal

    plan_kw = dict(seed=4, transient_rate=0.25, max_transients=4,
                   poison={"rossler"})
    mon_kw = dict(window_words=512, breaker_threshold=5, seed=2)

    async def serve(af, fc, farm, health):
        for core in PARITY_CORES:
            for j, c in enumerate(("a", "b")):
                af.register(core, c, seed=60 + j)
        log = []
        for round_ in range(5):
            futs = [(core, c, af.submit(core, c, 200 + 64 * round_))
                    for core in PARITY_CORES for c in ("a", "b")]
            await _drive(fc, [f for _, _, f in futs])
            for core, c, f in futs:
                err = f.exception()
                log.append((round_, core, c,
                            np.asarray(f.result()) if err is None
                            else (type(err).__name__, err.core,
                                  err.rotated)))
            log.append((round_, "state", sorted(farm.quarantined),
                        dict(farm.rotations), dict(health.stats)))
        return log, [str(e) for e in af.flush_errors]

    out = {}

    async def go():
        tc, jc = FakeClock(), JaxClock()
        tplan, jplan = FaultPlan(**plan_kw), JaxPlan(**plan_kw)
        tfarm, jfarm = parity_farms(tc, jc, tplan, jplan,
                                    standby=("rossler",))
        th, jh = HealthMonitor(**mon_kw), JaxMonitor(**mon_kw)
        async with AsyncOscillatorFarm(tfarm, clock=tc, offload=False,
                                       health=th,
                                       journal=tmp_path / "t.jsonl") as af:
            out["torch"] = await serve(af, tc, tfarm, th), tplan.injected
        async with JaxAsync(jfarm, clock=jc, offload=False, health=jh,
                            journal=tmp_path / "j.jsonl") as af:
            out["jax"] = await serve(af, jc, jfarm, jh), jplan.injected

    _run(go())
    (tlog, terr), tinj = out["torch"]
    (jlog, jerr), jinj = out["jax"]
    assert tinj == jinj and terr == jerr == []
    assert tinj["transient"] > 0 and tinj["corrupted_samples"] > 0
    assert len(tlog) == len(jlog)
    for a, b in zip(tlog, jlog):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, (a[:2], x, y)
    last = tlog[-1]
    assert last[3] == {"rossler": 1}                # rotated, as in JAX
    assert last[4]["retries"] > 0 and last[4]["quality_quarantines"] >= 1
    tj = read_journal(tmp_path / "t.jsonl")
    jj = jax_read_journal(tmp_path / "j.jsonl")
    assert tj[:2] == jj[:2] and tj[2] == jj[2]      # events, seq, positions
    assert ("rotation", "rossler") in tj[0]
    assert any(ev[0] == "quarantine" and ev[1] == "rossler"
               and "online quality" in ev[2] for ev in tj[0])
