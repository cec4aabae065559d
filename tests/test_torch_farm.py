"""The port's oscillator farm and gang planner (``repro_torch.serve.farm``)
on the CPU, where the gang wrappers take their plain versions.

Against the JAX farm: the committed farm cores (``results/generated_cores/
farm``, bf16) served by both frameworks deliver bitwise-equal words over a
uniform, a skewed and an unequal-pools flush.  Only words are compared:
the two planners' cost models differ, so their launch shapes may.

Inside the port, mirroring ``tests/test_gang.py``, ``tests/test_planner.py``
and ``tests/test_farm.py``: gang == per-core words across flushes in f32
and bf16, the planner's golden decisions, the caches, deferral and
auto-flush, snapshot/restore mid-gang and across a split, quarantine and
rotation, routing errors, the counters and the profile.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.serve.farm import OscillatorFarm as JaxFarm
from repro_torch.clock import FakeClock
from repro_torch.core.dse import Candidate, GangCostModel
from repro_torch.serve.farm import OscillatorFarm, _compat_key
from repro_torch.serve.health import CoreQuarantined
from repro_torch.serve.prng_service import PRNGService

FARM = (pathlib.Path(__file__).resolve().parents[1] / "results"
        / "generated_cores" / "farm")
SMALL = ("chen", "chua", "lorenz", "rossler")          # the 3-8-3 cores
# as tests/test_gang.py (p=1: 256-lane blocks, so 128-lane pools pad)
CAND = Candidate(i_dim=3, h_dim=8, p=1, compute_unit="vpu", dtype_bytes=4,
                 unroll=4, t_block=64)
# as tests/test_planner.py (p=0: one 128-lane block per client)
PCAND = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu", dtype_bytes=4,
                  unroll=2, t_block=32)


def _weights(name):
    with np.load(FARM / name / "weights.npz") as npz:
        return dict(npz)


def _members(n=4, cand=CAND, dtype=None):
    """(core, params, config, dtype) for n compatible 3-8-3 cores."""
    return [(f"core{i}", _weights(SMALL[i]), cand, dtype) for i in range(n)]


def _farm(members, gang=True, lanes=128, **kw):
    farm = OscillatorFarm(gang=gang, device="cpu", **kw)
    for core, params, config, dtype in members:
        farm.add_core(core, params, config=config, dtype=dtype,
                      lanes_per_client=lanes)
    return farm


def _serve(farm, round_):
    for core, reqs in round_.items():
        for client, n in reqs:
            farm.request(core, client, n)
    return farm.flush()


def _assert_same(a, b):
    assert set(a) == set(b)
    for core in a:
        assert set(a[core]) == set(b[core])
        for client in a[core]:
            np.testing.assert_array_equal(np.asarray(a[core][client]),
                                          np.asarray(b[core][client]))


def _request_rows(farm, rows_by_core):
    for core, rows in rows_by_core.items():
        farm.request(core, "t", rows * 128)


def _register_all(farm, seed=7):
    for core in farm.cores:
        farm.register(core, "t", seed=seed)


# ---------------------------------------------------------------------------
# Against the JAX farm
# ---------------------------------------------------------------------------

def test_committed_bf16_farm_bitwise_vs_jax_farm():
    """Uniform, skewed, then unequal pools (one more client on lorenz):
    every delivered word equal to the JAX farm's, bit for bit."""
    jfarm = JaxFarm.from_generated(FARM, backend="pallas_interpret")
    tfarm = OscillatorFarm.from_generated(FARM, device="cpu")
    assert tfarm.cores == jfarm.cores
    for f in (jfarm, tfarm):
        for core in f.cores:
            f.register(core, "a", seed=1)
            f.register(core, "b", seed=2)
    cores = tfarm.cores
    uniform = {c: [("a", 1024), ("b", 1024)] for c in cores}
    skewed = {"chen": [("a", 64 * 128)], "chua": [("b", 256)],
              "lorenz": [("a", 256)], "rossler": [("a", 256), ("b", 100)],
              "hyperlorenz": [("a", 300)]}
    unequal = {c: [("a", 512)] for c in cores}
    unequal["lorenz"] = [("a", 512), ("c", 512)]
    for i, round_ in enumerate((uniform, skewed, unequal)):
        if i == 2:
            for f in (jfarm, tfarm):
                f.register("lorenz", "c", seed=3)
        _assert_same(_serve(tfarm, round_), _serve(jfarm, round_))
    # the port's planner shaped the skewed flush to demand, and the
    # unequal pools took the lane-concat layout
    assert tfarm.plan_decisions["ragged"] + tfarm.plan_decisions["split"] >= 1
    assert "concat" in {p["mode"] for p in tfarm._sched._plans.values()}


# ---------------------------------------------------------------------------
# Gang level (tests/test_gang.py)
# ---------------------------------------------------------------------------

def test_compat_grouping_splits_mixed_farms():
    """Mixed dtype / h_dim cores must not share a gang; every client still
    gets exactly its per-core words."""
    cand16 = Candidate(i_dim=4, h_dim=16, p=1, dtype_bytes=4, unroll=4,
                       t_block=64)
    members = [("a", _weights("chen"), CAND, None),
               ("b", _weights("chua"), CAND, None),            # gangs with a
               ("c", _weights("lorenz"), CAND, torch.bfloat16),  # dtype
               ("d", _weights("hyperlorenz"), cand16, None)]     # shape
    farm = _farm(members)
    keys = {c: _compat_key(farm.services[c]) for c in farm.cores}
    assert keys["a"] == keys["b"]
    assert len({keys["a"], keys["c"], keys["d"]}) == 3
    solo = _farm(members, gang=False)
    for f in (farm, solo):
        for c in f.cores:
            f.register(c, "t", seed=2)
    round_ = {c: [("t", 200)] for c in farm.cores}
    out, ref = _serve(farm, round_), _serve(solo, round_)
    assert set(out) == {"a", "b", "c", "d"}
    assert (farm.launches, farm.gang_launches, solo.launches) == (3, 1, 4)
    _assert_same(out, ref)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_gang_vs_per_core_bit_identical_across_flushes(dtype):
    farms = [_farm(_members(dtype=dtype), gang=g) for g in (True, False)]
    for f in farms:
        for core in f.cores:
            f.register(core, "u1", seed=21)
            f.register(core, "u2", seed=22)
    traffic = [
        {"core0": [("u1", 300)], "core1": [("u2", 900)],
         "core2": [("u1", 50)], "core3": [("u2", 130)]},
        {"core0": [("u2", 411)], "core2": [("u1", 222), ("u2", 7)]},
        {"core1": [("u1", 1)], "core3": [("u1", 2048)]},
    ]
    for round_ in traffic:
        _assert_same(*(_serve(f, round_) for f in farms))
    assert farms[0].launches < farms[1].launches


def test_ragged_pools_gang_via_lane_concat():
    """Unequal client counts gang through the lane-concat layout (K3, with
    dead-lane padding to whole 256-lane blocks); equal pools keep the
    stacked layout (K4)."""
    farms = [_farm(_members(3), gang=g) for g in (True, False)]
    for f in farms:
        f.register("core0", "only", seed=31)          # 128-lane pool
        for core in ("core1", "core2"):               # 256-lane pools
            f.register(core, "u1", seed=32)
            f.register(core, "u2", seed=33)
    round_ = {"core0": [("only", 517)], "core1": [("u2", 1024)],
              "core2": [("u1", 64)]}
    _assert_same(*(_serve(f, round_) for f in farms))
    assert farms[0].gang_launches == 1
    (plan,) = farms[0]._sched._plans.values()
    assert plan["mode"] == "concat"
    assert list(plan["core_map"]) == [0, 1, 2]
    assert plan["spans"] == [(0, 128, 256), (256, 256, 256), (512, 256, 256)]
    eq = _farm(_members(2))
    _register_all(eq, seed=3)
    _request_rows(eq, {c: 1 for c in eq.cores})
    eq.flush()
    assert next(iter(eq._sched._plans.values()))["mode"] == "stacked"


def test_gang_dispatch_cache_steady_state():
    farm = _farm(_members())
    _register_all(farm, seed=5)
    for _ in range(4):
        _request_rows(farm, {c: 64 for c in farm.cores})   # no overdraw
        farm.flush()
    assert farm.gang_launches == 4
    assert farm.dispatch_misses == 1


def test_gang_snapshot_restore_mid_gang():
    """Snapshot with requests in flight, restore, flush: identical words,
    also when restored onto a farm in the other launch mode."""
    farm = _farm(_members())
    _register_all(farm, seed=9)
    farm.draw("core1", "t", 100)
    for core in farm.cores:
        farm.request(core, "t", 333)
    snap = farm.snapshot()
    a = farm.flush()
    for gang in (True, False):
        other = _farm(_members(), gang=gang)
        other.restore(snap)
        _assert_same(a, other.flush())


def test_deadline_deferral_and_auto_flush():
    farm = _farm(_members())
    _register_all(farm, seed=4)
    farm.request("core0", "t", 10)
    assert farm.flush(max_wait_rows=64) == {}      # 1 row < 64: deferred
    assert farm.launches == 0
    out = farm.flush(max_wait_rows=64)             # overdue: launches now
    assert out["core0"]["t"].size == 10
    assert farm.launches == 1
    farm.request("core0", "t", 20)
    farm.request("core1", "t", 64 * 128)           # lifts the group over
    assert set(farm.flush(max_wait_rows=64)) == {"core0", "core1"}

    auto = _farm(_members(), auto_flush_rows=4)
    solo = _farm(_members(), gang=False)
    for f in (auto, solo):
        _register_all(f, seed=4)
    auto.request("core0", "t", 100, auto_flush=True)   # 1 row < 4: waits
    assert auto.launches == 0
    assert auto.pending_rows == 1
    auto.request("core1", "t", 600, auto_flush=True)   # 5 rows: fires
    assert auto.gang_launches == 1
    assert auto.services["core0"].outbox_words("t") == 100
    out = auto.flush()                                 # delivery only
    assert auto.launches == 1
    _assert_same(out, _serve(solo, {"core0": [("t", 100)],
                                    "core1": [("t", 600)]}))


# ---------------------------------------------------------------------------
# Planner level (tests/test_planner.py)
# ---------------------------------------------------------------------------

def test_golden_decision_uniform_is_single_padded_stacked_launch():
    farm = _farm(_members(cand=PCAND))
    _register_all(farm)
    _request_rows(farm, {c: 16 for c in farm.cores})
    farm.flush()
    assert farm.plan_decisions == {"padded": 1, "ragged": 0, "split": 0}
    assert (farm.gang_launches, farm.launches) == (1, 1)
    (plan,) = farm._sched._plans.values()
    assert plan["mode"] == "stacked"


def test_golden_decision_skewed_is_ragged_or_split():
    farm = _farm(_members(cand=PCAND))
    policy = _farm(_members(cand=PCAND), planner=False)
    skew = {"core0": 64, "core1": 4, "core2": 4, "core3": 4}
    outs = []
    for f in (farm, policy):
        _register_all(f)
        _request_rows(f, skew)
        outs.append(f.flush())
    dec = farm.plan_decisions
    assert dec["padded"] == 0 and dec["ragged"] + dec["split"] == 1
    assert policy.plan_decisions == {"padded": 1, "ragged": 0, "split": 0}
    _assert_same(*outs)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_planner_bit_identical_to_solo_across_flushes(dtype):
    farms = [_farm(_members(cand=PCAND, dtype=dtype), gang=g)
             for g in (True, False)]
    for f in farms:
        for core in f.cores:
            f.register(core, "u1", seed=21)
            f.register(core, "u2", seed=22)
    traffic = [
        {"core0": [("u1", 64 * 128)], "core1": [("u2", 300)],
         "core2": [("u1", 300)], "core3": [("u2", 300)]},
        {"core0": [("u2", 17)], "core2": [("u1", 2048), ("u2", 7)]},
        {"core1": [("u1", 4096)], "core3": [("u1", 1)]},
    ]
    for round_ in traffic:
        _assert_same(*(_serve(f, round_) for f in farms))
    assert farms[0].plan_decisions["ragged"] + farms[0].plan_decisions[
        "split"] >= 1
    assert farms[0].launches < farms[1].launches


def test_planner_ragged_pools_still_bit_identical():
    """Unequal pools and skewed demand compose: K3 with a row map."""
    farms = [_farm(_members(3, cand=PCAND), gang=g) for g in (True, False)]
    for f in farms:
        f.register("core0", "only", seed=31)
        for core in ("core1", "core2"):
            f.register(core, "u1", seed=32)
            f.register(core, "u2", seed=33)
    round_ = {"core0": [("only", 64 * 128)], "core1": [("u2", 512)],
              "core2": [("u1", 512)]}
    _assert_same(*(_serve(f, round_) for f in farms))
    assert farms[0].plan_decisions["ragged"] == 1


class _FreezeStackedModel(GangCostModel):
    """Prices the ragged stacked (freeze, K4 with a row map) layout as
    free, so the planner takes it."""

    def gang_cost(self, c, demands, blocks, lanes, *, layout,
                  rows_by_block=None):
        if layout == "stacked" and rows_by_block is not None:
            return 0.0
        return super().gang_cost(c, demands, blocks, lanes, layout=layout,
                                 rows_by_block=rows_by_block)


def test_ragged_stacked_freeze_bit_identical():
    farms = [_farm(_members(cand=PCAND),
                   gang_cost_model=_FreezeStackedModel()),
             _farm(_members(cand=PCAND), gang=False)]
    for f in farms:
        _register_all(f, seed=12)
    for rows in ({"core0": 64, "core1": 4, "core2": 0, "core3": 9},
                 {"core0": 3, "core1": 20, "core2": 5, "core3": 5}):
        outs = []
        for f in farms:
            _request_rows(f, {c: r for c, r in rows.items() if r})
            outs.append(f.flush())
        _assert_same(*outs)
    dec = farms[0]._sched._decisions
    assert {d["parts"][0]["layout"] for d in dec.values()} == {"stacked"}
    assert farms[0].plan_decisions["ragged"] == 2


class _PaddedCheapModel(GangCostModel):
    """Prices every group-max launch as free, so the unconstrained
    planner picks the padded launch even for skewed demand."""

    def gang_cost(self, c, demands, blocks, lanes, *, layout,
                  rows_by_block=None):
        if rows_by_block is None:
            return 0.0
        return super().gang_cost(c, demands, blocks, lanes, layout=layout,
                                 rows_by_block=rows_by_block)


def test_slo_classes_constrain_the_choice_set():
    """A latency-class core forbids the padded launch on skewed demand;
    bulk on every core pins it; words never change."""
    skew = {"core0": 64, "core1": 4, "core2": 4, "core3": 4}
    solo = _farm(_members(cand=PCAND), gang=False)
    free = _farm(_members(cand=PCAND))
    latency = _farm(_members(cand=PCAND), gang_cost_model=_PaddedCheapModel())
    for f in (solo, free, latency):
        _register_all(f, seed=14)
    outs = []
    for f, slo in ((solo, None), (free, {c: "bulk" for c in free.cores}),
                   (latency, {"core1": "latency", "core2": "bulk"})):
        _request_rows(f, skew)
        outs.append(f.flush(slo_by_core=slo))
    assert free.plan_decisions["padded"] == 1
    assert free.slo_forced == {"latency": 0, "bulk": 1}
    assert latency.plan_decisions["padded"] == 0
    assert latency.slo_forced == {"latency": 1, "bulk": 0}
    _assert_same(outs[0], outs[1])
    _assert_same(outs[0], outs[2])


def test_planner_decision_cache_steady_state():
    farm = _farm(_members(cand=PCAND))
    _register_all(farm)
    skew = {"core0": 64, "core1": 4, "core2": 4, "core3": 4}
    for _ in range(4):
        _request_rows(farm, skew)
        farm.flush()
    assert len(farm._sched._decisions) == 1
    misses = farm.dispatch_misses
    _request_rows(farm, skew)
    farm.flush()
    assert farm.dispatch_misses == misses


def test_snapshot_restore_across_planner_split():
    """With no launch overhead and an unroll of 8 (a ragged launch rounds
    the cold demands of 4 rows up to 8), the split is strictly cheapest; a
    snapshot with the skewed requests in flight restores onto a split, a
    padded and a gang=False farm with identical words."""
    split_model = GangCostModel(launch_overhead_cycles=0.0)
    cand = dataclasses.replace(PCAND, unroll=8)
    farm = _farm(_members(cand=cand), gang_cost_model=split_model)
    _register_all(farm, seed=9)
    farm.draw("core1", "t", 100)
    _request_rows(farm, {"core0": 64, "core1": 4, "core2": 4, "core3": 4})
    snap = farm.snapshot()
    a = farm.flush()
    assert farm.plan_decisions["split"] == 1
    assert farm.launches == 1 + 2         # draw + (solo hot + cold gang)
    for kw in ({"gang_cost_model": split_model}, {"planner": False},
               {"gang": False}):
        other = _farm(_members(cand=cand), **kw)
        other.restore(snap)
        _assert_same(a, other.flush())


def test_profile_stats_accumulate():
    class Ticking(FakeClock):
        def now(self):
            self.advance(1.0)
            return super().now()

    farm = _farm(_members(2, cand=PCAND), profile=True, clock=Ticking())
    _register_all(farm)
    _request_rows(farm, {c: 4 for c in farm.cores})
    farm.flush()
    stats = farm.profile_stats
    assert stats["flushes"] == 1.0
    assert all(stats[k] > 0.0 for k in ("plan", "stack", "launch", "absorb"))
    assert _farm(_members(2, cand=PCAND)).profile_stats is None


# ---------------------------------------------------------------------------
# Farm level (tests/test_farm.py) and self-healing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chen", "hyperlorenz"])
def test_farm_client_matches_standalone_service(name):
    farm = OscillatorFarm.from_generated(FARM, device="cpu")
    for core in farm.cores:
        farm.register(core, "alice", seed=5)
    farm.request(name, "alice", 650)
    out = farm.flush()
    assert set(out) == {name}
    sol = json.loads((FARM / name / "solution.json").read_text())
    cand = dataclasses.replace(Candidate(**sol["candidate"]), p=0)
    assert farm.services[name].config == cand     # p clamped to one client
    solo = PRNGService(_weights(name), lanes_per_client=128, config=cand,
                       dtype=torch.bfloat16, device="cpu")
    solo.register("alice", seed=5)
    np.testing.assert_array_equal(out[name]["alice"], solo.draw("alice", 650))


def test_farm_routing_and_errors():
    farm = OscillatorFarm.from_generated(FARM, cores=("chen", "lorenz"),
                                         device="cpu")
    assert farm.cores == ("chen", "lorenz")
    farm.register("chen", "a", seed=1)
    farm.register("lorenz", "a", seed=1)
    assert not np.array_equal(farm.draw("chen", "a", 300),
                              farm.draw("lorenz", "a", 300))
    with pytest.raises(KeyError):
        farm.draw("ghost_core", "a", 10)
    with pytest.raises(ValueError, match="already attached"):
        farm.add_core("chen", _weights("chen"))
    for kw in ({"activation": "tanh"}, {"config": CAND},
               {"dtype": torch.float32}):
        with pytest.raises(ValueError, match="solution.json"):
            OscillatorFarm.from_generated(FARM, device="cpu", **kw)
    with pytest.raises(ValueError, match="no generated cores"):
        OscillatorFarm.from_generated(FARM / "chen", device="cpu")


def test_farm_snapshot_restore_with_pending():
    def mk(cores=("chen", "hyperlorenz")):
        return OscillatorFarm.from_generated(FARM, cores=cores, device="cpu")

    farm = mk()
    for core in farm.cores:
        farm.register(core, "c", seed=3)
    farm.draw("chen", "c", 130)
    farm.request("chen", "c", 200)
    farm.request("hyperlorenz", "c", 90)
    snap = farm.snapshot()
    a = farm.flush()
    farm2 = mk()
    farm2.restore(snap)
    b = farm2.flush()
    assert set(a) == {"chen", "hyperlorenz"}
    _assert_same(a, b)
    with pytest.raises(ValueError, match="core mismatch"):
        OscillatorFarm(device="cpu").restore(snap)
    with pytest.raises(ValueError, match="core mismatch"):
        mk(("chen", "hyperlorenz", "lorenz")).restore(snap)


def test_quarantine_and_rotate_onto_standby():
    """A quarantined core refuses traffic with CoreQuarantined and is
    skipped by flushes; rotate() re-registers its clients on the standby,
    whose streams restart at row 0 of the standby's own stream."""
    farm = _farm(_members(cand=PCAND))
    _register_all(farm, seed=6)
    farm.register("core0", "u", seed=8)
    farm.request("core0", "t", 500)
    farm.request("core1", "t", 500)
    assert farm.quarantine("core0", reason="test")
    assert not farm.quarantine("core0")               # idempotent
    assert farm.quarantined == frozenset({"core0"})
    for call in (lambda: farm.request("core0", "t", 1),
                 lambda: farm.register("core0", "v"),
                 lambda: farm.draw("core0", "t", 1)):
        with pytest.raises(CoreQuarantined) as err:
            call()
        assert err.value.core == "core0" and not err.value.rotated
    assert set(farm.flush()) == {"core1"}             # core0 skipped
    with pytest.raises(ValueError, match="no standby"):
        farm.rotate("core0")
    with pytest.raises(KeyError):
        farm.add_standby("ghost", _weights("chen"))
    farm.add_standby("core0", _weights("rossler"), config=PCAND)
    assert farm.has_standby("core0")
    with pytest.raises(ValueError, match="already has a standby"):
        farm.add_standby("core0", _weights("rossler"), config=PCAND)
    old = farm.rotate("core0")
    assert farm.rotations == {"core0": 1} and not farm.quarantined
    assert set(old.clients) == {"t", "u"}
    got = farm.draw("core0", "u", 300)
    solo = PRNGService(_weights("rossler"), lanes_per_client=128,
                       config=PCAND, device="cpu")
    solo.register("t", seed=6)
    solo.register("u", seed=8)
    np.testing.assert_array_equal(got, solo.draw("u", 300))
    # a snapshot after the rotation replays it onto a fresh farm
    snap = farm.snapshot()
    fresh = _farm(_members(cand=PCAND))
    fresh.add_standby("core0", _weights("rossler"), config=PCAND)
    fresh.restore(snap)
    assert fresh.rotations == {"core0": 1}
    for f in (farm, fresh):
        f.request("core0", "u", 70)
    _assert_same(farm.flush(), fresh.flush())


def test_farm_without_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OscillatorFarm()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OscillatorFarm.from_generated(FARM)
    assert OscillatorFarm(device="cpu").device.type == "cpu"
