"""The port's flush journal (``repro_torch.serve.journal``) on the CPU.

A mirror of ``tests/test_journal.py``: a process serving tenants through
the async front-end dies *between* flushes, a new process rebuilds the
same farm from weights + journal alone, and every tenant stream continues
bit-identically to an uncrashed reference, including words generated but
still undelivered at the kill point (service buffer + outbox); rotation
and checkpoints, torn tails, the writer lock, per-record CRCs, repair and
the CLI.

Against the JAX package: ``read_journal`` and ``repair_journal`` of either
framework read and cut the same bytes alike (a torn tail, mid-file
damage), a port journal's flush records carry the one-device topology
(``None`` per core) a JAX journal of an unsharded farm carries, and the
JAX ``read_journal`` recovers a port journal's checkpoint.  A journal
written by a farm sharded over a 2-entry mesh records that topology, and
its recovery onto an unsharded farm refuses unless told to re-plan.
"""
import json

import numpy as np
import pytest

from repro_torch.serve.async_frontend import AsyncOscillatorFarm
from repro_torch.serve.clock import FakeClock
from repro_torch.serve.farm import OscillatorFarm as _Farm
from repro_torch.serve.journal import (FlushJournal, read_journal,
                                       replay_journal)

from test_torch_async_frontend import CAND, _farm, _params, _run


def OscillatorFarm(**kw):
    """The port's farm on the CPU."""
    return _Farm(device="cpu", **kw)


def _collect(coro):
    """Run ``coro`` under the suite's hang guard and return its result."""
    box = []

    async def wrap():
        box.append(await coro)

    _run(wrap())
    return box[0]


def _bare_farm(n_cores=2, clock=None, gang=True, mesh=None):
    """Same cores as ``_farm`` but NO clients registered — registration is
    the journal's job on the recovery path."""
    farm = OscillatorFarm(gang=gang, clock=clock)
    for i in range(n_cores):
        farm.add_core(f"core{i}", _params(key=10 + i), config=CAND,
                      lanes_per_client=128, mesh=mesh)
    return farm


# ---------------------------------------------------------------------------
# The headline: kill between flushes, replay, continue bit-exactly
# ---------------------------------------------------------------------------

def test_kill_between_flushes_replays_bit_exact(tmp_path):
    jpath = tmp_path / "farm.journal"
    delivered = {}

    async def serve_until_kill():
        fc = FakeClock()
        farm = _bare_farm(clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc,
                                       journal=jpath) as af:
            for i in range(2):
                af.register(f"core{i}", "t", seed=40)
            af.register("core0", "s", seed=41)
            # flush 1: 200 % 128 != 0 leaves buffered overdraw (buf > 0 at
            # the journaled boundary — the replay must regenerate it)
            delivered["d1"] = await af.draw("core0", "t", 200, deadline_ms=0)
            # flush 2 also serves sync-surface demand for "s": those words
            # re-park into the outbox => outbox > 0 at the boundary too
            farm.request("core0", "s", 150)
            delivered["d2"] = await af.draw("core0", "t", 100, deadline_ms=0)
            delivered["d3"] = await af.draw("core1", "t", 64, deadline_ms=0)
            # the kill window: queued demand that never reached a flush —
            # it dies with the process and must NOT appear after recovery
            af.submit("core0", "t", 999, deadline_ms=10_000)

    _run(serve_until_kill())

    # ---- recovery: fresh process, same weights, zero crashed-state ----
    farm2 = _bare_farm()
    info = replay_journal(farm2, jpath)
    assert info["flushes"] == 3
    assert info["clients"] == 3
    assert info["rows_replayed"] > 0
    assert info["torn_tail"] is False

    # undelivered tail was rebuilt, not dropped:
    svc0 = farm2.services["core0"]
    assert len(svc0.clients["t"].buf) > 0          # buffered overdraw
    assert svc0.outbox_words("s") == 150           # parked sync words

    # reference: an uncrashed solo farm that served exactly the DELIVERED
    # draws (never the killed 999-word request)
    solo = _farm(gang=False, n_cores=2, clients=("t", "s"))
    np.testing.assert_array_equal(delivered["d1"],
                                  solo.draw("core0", "t", 200))
    np.testing.assert_array_equal(delivered["d2"],
                                  solo.draw("core0", "t", 100))
    np.testing.assert_array_equal(delivered["d3"],
                                  solo.draw("core1", "t", 64))

    # the parked outbox words surface on the recovered sync surface,
    # bit-identical to the solo stream
    out = farm2.flush()
    np.testing.assert_array_equal(out["core0"]["s"],
                                  solo.draw("core0", "s", 150))
    # and every stream CONTINUES bit-exactly past the kill point
    np.testing.assert_array_equal(farm2.draw("core0", "t", 120),
                                  solo.draw("core0", "t", 120))
    np.testing.assert_array_equal(farm2.draw("core1", "t", 77),
                                  solo.draw("core1", "t", 77))


def test_recovered_process_keeps_journaling_same_file(tmp_path):
    """Seq numbers continue across recovery: the journal is reusable as
    the recovered process's own journal, and a SECOND crash recovers to
    the post-recovery positions."""
    jpath = tmp_path / "farm.journal"

    async def phase(register: bool, n_words: int):
        fc = FakeClock()
        farm = _bare_farm(n_cores=1, clock=fc)
        if not register:
            replay_journal(farm, jpath)
        async with AsyncOscillatorFarm(farm, clock=fc,
                                       journal=jpath) as af:
            if register:
                af.register("core0", "t", seed=40)
            return await af.draw("core0", "t", n_words, deadline_ms=0)

    first = _collect(phase(True, 90))
    assert read_journal(jpath)[1] == 1             # one flush journaled
    second = _collect(phase(False, 70))
    _, last_seq, positions, torn, _ = read_journal(jpath)
    assert last_seq == 2 and not torn
    # second recovery sees the concatenated stream position
    farm3 = _bare_farm(n_cores=1)
    replay_journal(farm3, jpath)
    solo = _farm(gang=False, n_cores=1)
    np.testing.assert_array_equal(first, solo.draw("core0", "t", 90))
    np.testing.assert_array_equal(second, solo.draw("core0", "t", 70))
    np.testing.assert_array_equal(farm3.draw("core0", "t", 55),
                                  solo.draw("core0", "t", 55))


def test_rotation_bounds_replay_and_survives_kill(tmp_path):
    """Journal rotation: after ``rotate_every`` flushes the live JSONL is
    rotated aside and the new segment opens with a full farm-snapshot
    checkpoint.  A kill AFTER the rotation boundary replays from the
    checkpoint — only the post-checkpoint flush deltas recompute (replay
    cost bounded by the window, not absolute position) — and every
    stream continues bit-identically to an uncrashed reference."""
    jpath = tmp_path / "farm.journal"
    delivered = {}
    boxes = []

    async def serve():
        fc = FakeClock()
        farm = _bare_farm(n_cores=1, clock=fc)
        j = FlushJournal(jpath, clock=fc, rotate_every=2)
        boxes.append(j)
        async with AsyncOscillatorFarm(farm, clock=fc, journal=j) as af:
            af.register("core0", "t", seed=40)
            # flush 1 + flush 2; the 2nd record triggers the rotation
            delivered["d1"] = await af.draw("core0", "t", 200, deadline_ms=0)
            delivered["d2"] = await af.draw("core0", "t", 100, deadline_ms=0)
            # flush 3 lands in the NEW segment, after the checkpoint —
            # 400 words outruns the buffered overdraw, forcing a launch
            delivered["d3"] = await af.draw("core0", "t", 400, deadline_ms=0)

    _run(serve())
    j = boxes[0]
    j.close()
    assert j.rotations == 1
    # the sealed segment is kept as an audit trail
    assert list(tmp_path.glob("farm.journal.0*"))

    farm2 = _bare_farm(n_cores=1)
    info = replay_journal(farm2, jpath)
    assert info["checkpoint_seq"] == 2
    assert info["flushes"] == 3
    row_at_kill = farm2.services["core0"].clients["t"].row
    # bounded replay: only the post-checkpoint delta recomputed
    assert 0 < info["rows_replayed"] < row_at_kill

    solo = _farm(gang=False, n_cores=1)
    for k, n in (("d1", 200), ("d2", 100), ("d3", 400)):
        np.testing.assert_array_equal(delivered[k],
                                      solo.draw("core0", "t", n))
    # undelivered tail across the checkpoint survives, and the stream
    # continues bit-exactly past the kill point
    np.testing.assert_array_equal(farm2.draw("core0", "t", 120),
                                  solo.draw("core0", "t", 120))


def test_journal_recovered_onto_another_device_count(tmp_path):
    """A farm sharded over two mesh entries journals its topology; a
    recovery onto an unsharded farm refuses at the checkpoint, and with
    ``on_topology_mismatch='replan'`` every stream continues bitwise."""
    from repro_torch.distributed.sharding import DeviceMesh
    mesh = DeviceMesh(["cpu", "cpu"])
    jpath = tmp_path / "farm.journal"
    delivered = {}

    async def serve():
        fc = FakeClock()
        farm = _bare_farm(clock=fc, mesh=mesh)
        j = FlushJournal(jpath, clock=fc, rotate_every=2)
        async with AsyncOscillatorFarm(farm, clock=fc, journal=j) as af:
            for i in range(2):
                af.register(f"core{i}", "t", seed=40 + i)
            for k, n in (("a", 300), ("b", 100), ("c", 500)):
                delivered[k] = await af.draw("core0", "t", n, deadline_ms=0)
                await af.draw("core1", "t", n + 7, deadline_ms=0)
        j.close()

    _run(serve())
    assert sum(mesh.shard_launches) > 0
    recs = [json.loads(line) for line in jpath.read_text().splitlines()]
    topo = {c: ["data", 2, [0, 0]] for c in ("core0", "core1")}
    assert recs[0]["type"] == "checkpoint"
    assert recs[0]["snapshot"]["topology"] == topo
    assert all(r["topology"] == topo for r in recs if r["type"] == "flush")
    with pytest.raises(ValueError, match="topology"):
        replay_journal(_bare_farm(), jpath)
    farm2 = _bare_farm()
    replay_journal(farm2, jpath, on_topology_mismatch="replan")
    solo = _farm(gang=False, n_cores=1)
    for k, n in (("a", 300), ("b", 100), ("c", 500)):
        np.testing.assert_array_equal(delivered[k],
                                      solo.draw("core0", "t", n))
    np.testing.assert_array_equal(farm2.draw("core0", "t", 256),
                                  solo.draw("core0", "t", 256))


# ---------------------------------------------------------------------------
# Durability edge cases
# ---------------------------------------------------------------------------

def test_torn_tail_record_is_discarded(tmp_path):
    jpath = tmp_path / "farm.journal"

    async def serve():
        fc = FakeClock()
        farm = _bare_farm(n_cores=1, clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc,
                                       journal=jpath) as af:
            af.register("core0", "t", seed=40)
            return await af.draw("core0", "t", 100, deadline_ms=0)

    got = _collect(serve())
    # the crash lands mid-append: a torn, non-JSON final line
    with open(jpath, "a", encoding="utf-8") as f:
        f.write('{"type":"flush","seq":2,"cor')
    regs, last_seq, positions, torn, _ = read_journal(jpath)
    assert torn is True and last_seq == 1
    farm2 = _bare_farm(n_cores=1)
    info = replay_journal(farm2, jpath)
    assert info["torn_tail"] is True and info["flushes"] == 1
    solo = _farm(gang=False, n_cores=1)
    np.testing.assert_array_equal(got, solo.draw("core0", "t", 100))
    np.testing.assert_array_equal(farm2.draw("core0", "t", 60),
                                  solo.draw("core0", "t", 60))


def test_replay_refuses_mismatched_farm(tmp_path):
    jpath = tmp_path / "farm.journal"
    with FlushJournal(jpath, clock=FakeClock()) as j:
        j.record_register("core9", "t", seed=1)
    with pytest.raises(ValueError, match="core9"):
        replay_journal(_bare_farm(n_cores=1), jpath)


def test_replay_refuses_rewind():
    """replay_client advances forward only (from row 0 or a checkpoint):
    replaying a position BEHIND a client that already served words would
    corrupt stream state, so it refuses."""
    farm = _bare_farm(n_cores=1)
    farm.register("core0", "t", seed=40)
    farm.draw("core0", "t", 10)
    with pytest.raises(ValueError, match="rewind"):
        farm.services["core0"].replay_client("t", row=0)


def test_journal_timestamps_come_from_the_clock(tmp_path):
    fc = FakeClock(start=777.0)
    jpath = tmp_path / "farm.journal"
    with FlushJournal(jpath, clock=fc) as j:
        j.record_register("core0", "t", seed=1)
    recs = [json.loads(line)
            for line in jpath.read_text().splitlines()]
    assert all(r["ts"] == 777.0 for r in recs)


# ---------------------------------------------------------------------------
# Single-writer lock (flock + pid/host sentinel)
# ---------------------------------------------------------------------------

def test_second_writer_fails_fast_with_holder(tmp_path):
    from repro_torch.serve.journal import JournalLocked
    jpath = tmp_path / "farm.journal"
    j1 = FlushJournal(jpath, clock=FakeClock())
    try:
        with pytest.raises(JournalLocked) as ei:
            FlushJournal(jpath, clock=FakeClock())
        # the sentinel names the live holder: pid@host
        assert f"{__import__('os').getpid()}@" in str(ei.value.holder)
    finally:
        j1.close()
    # close releases the flock: a new writer acquires cleanly
    FlushJournal(jpath, clock=FakeClock()).close()


def test_lock_released_even_when_open_fails(tmp_path, monkeypatch):
    """If __init__ dies after taking the flock (e.g. corrupt file scan),
    the lock must not leak — the next writer can still open."""
    from repro_torch.serve.journal import JournalCorrupt, JournalLocked
    jpath = tmp_path / "farm.journal"
    with FlushJournal(jpath, clock=FakeClock()) as j:
        j.record_register("core0", "t", seed=1)
        j.record_register("core0", "u", seed=2)
    lines = jpath.read_text().splitlines()
    lines[0] = lines[0][:-5] + 'XXX"}'          # corrupt record 1 of 2
    jpath.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalCorrupt):
        FlushJournal(jpath, clock=FakeClock())
    # the failed open did not leak its flock
    with pytest.raises(JournalCorrupt):
        FlushJournal(jpath, clock=FakeClock())


# ---------------------------------------------------------------------------
# Per-record CRC: corruption pinpointed, --repair truncates to last good
# ---------------------------------------------------------------------------

def _journal_with_flushes(jpath, n_draws=3):
    async def serve():
        fc = FakeClock()
        farm = _bare_farm(n_cores=1, clock=fc)
        async with AsyncOscillatorFarm(farm, clock=fc, journal=jpath) as af:
            af.register("core0", "t", seed=40)
            out = []
            for _ in range(n_draws):
                out.append(await af.draw("core0", "t", 100, deadline_ms=0))
            return out
    return _collect(serve())


def test_midfile_corruption_raises_at_exact_record(tmp_path):
    from repro_torch.serve.journal import JournalCorrupt
    jpath = tmp_path / "farm.journal"
    _journal_with_flushes(jpath)
    lines = jpath.read_text().splitlines()
    # flip one byte INSIDE a value of the 3rd record: still valid JSON,
    # caught only by the CRC
    bad = lines[2].replace('"core0"', '"core!"', 1)
    assert bad != lines[2]
    lines[2] = bad
    jpath.write_text("\n".join(lines) + "\n")
    with pytest.raises(JournalCorrupt) as ei:
        read_journal(jpath)
    assert ei.value.line_no == 3
    assert "--repair" in str(ei.value)
    with pytest.raises(JournalCorrupt):
        replay_journal(_bare_farm(n_cores=1), jpath)


def test_repair_truncates_to_last_good_record(tmp_path):
    from repro_torch.serve.journal import JournalCorrupt, repair_journal
    jpath = tmp_path / "farm.journal"
    _journal_with_flushes(jpath, n_draws=3)
    lines = jpath.read_text().splitlines()
    n_total = len(lines)
    # corrupt the SECOND flush: open header, register and flush 1 survive
    lines[3] = lines[3].replace('"seq"', '"sXq"', 1)
    jpath.write_text("\n".join(lines) + "\n")
    info = repair_journal(jpath)
    assert info == {"kept": 3, "dropped": n_total - 3}
    # the repaired prefix replays: register + first flush survive
    farm2 = _bare_farm(n_cores=1)
    summary = replay_journal(farm2, jpath)
    assert summary["flushes"] == 1
    solo = _farm(gang=False, n_cores=1)
    solo.draw("core0", "t", 100)                 # skip the surviving flush
    np.testing.assert_array_equal(farm2.draw("core0", "t", 64),
                                  solo.draw("core0", "t", 64))
    # repairing an intact journal is a byte-identical no-op
    before = jpath.read_bytes()
    assert repair_journal(jpath)["dropped"] == 0
    assert jpath.read_bytes() == before


def test_repair_cli_exit_codes(tmp_path):
    from repro_torch.serve.journal import main
    jpath = tmp_path / "farm.journal"
    _journal_with_flushes(jpath)
    assert main([str(jpath)]) == 0               # summary on a clean file
    lines = jpath.read_text().splitlines()
    lines[1] = lines[1].replace('"ts"', '"tz"', 1)
    jpath.write_text("\n".join(lines) + "\n")
    assert main([str(jpath)]) == 2               # corrupt: diagnostic exit
    assert main([str(jpath), "--repair"]) == 0
    assert main([str(jpath)]) == 0               # clean again


def test_torn_tail_still_tolerated_with_crc(tmp_path):
    """CRC must not turn the torn-tail contract into corruption: a valid
    prefix + a damaged FINAL line is a crash mid-append, not a corrupt
    journal."""
    jpath = tmp_path / "farm.journal"
    _journal_with_flushes(jpath, n_draws=1)
    with open(jpath, "a", encoding="utf-8") as f:
        f.write('{"type":"flush","seq":9,"cor')
    _, last_seq, _, torn, _ = read_journal(jpath)
    assert torn is True
    summary = replay_journal(_bare_farm(n_cores=1), jpath)
    assert summary["torn_tail"] is True


# ---------------------------------------------------------------------------
# Against the JAX package: the same bytes, read and cut alike
# ---------------------------------------------------------------------------

def _damaged(jpath, how):
    lines = jpath.read_text().splitlines()
    if how == "torn":
        return "\n".join(lines) + '\n{"type":"flush","seq":9,"cor'
    if how == "torn-crc":
        return "\n".join(lines[:-1] + [lines[-1].replace('"ts"', '"tz"', 1)])
    if how == "midfile":
        lines[2] = lines[2].replace('"ts"', '"tz"', 1)
        return "\n".join(lines) + "\n"
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("how", ["clean", "torn", "torn-crc", "midfile"])
def test_read_and_repair_equal_jax_on_the_same_bytes(tmp_path, how):
    """One port journal, damaged four ways: the JAX ``read_journal``
    returns what the port's returns (or both raise ``JournalCorrupt`` at
    the same line and seq), and the two ``repair_journal`` leave the same
    bytes and counts."""
    from repro.serve import journal as jj
    from repro_torch.serve import journal as tj
    src = tmp_path / "src.journal"
    _journal_with_flushes(src, n_draws=3)
    text = _damaged(src, how)
    paths = {}
    for name in ("torch", "jax"):
        paths[name] = tmp_path / f"{name}.journal"
        paths[name].write_text(text)
    if how == "midfile":
        errs = []
        for mod, name in ((tj, "torch"), (jj, "jax")):
            with pytest.raises(mod.JournalCorrupt) as ei:
                mod.read_journal(paths[name])
            errs.append((ei.value.line_no, ei.value.seq))
        assert errs[0] == errs[1] == (3, 0)
    else:
        assert (tj.read_journal(paths["torch"])
                == jj.read_journal(paths["jax"]))
    got = [tj.repair_journal(paths["torch"]), jj.repair_journal(paths["jax"])]
    assert got[0] == got[1]
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    assert (got[0]["dropped"] > 0) == (how != "clean")


def test_flush_records_carry_one_device_topology_and_jax_reads_them(
        tmp_path):
    """Every flush record and the checkpoint record ``None`` as each
    core's topology (a one-device JAX farm's entry), and the JAX reader
    decodes the port's rotated segment, checkpoint included, to the same
    events, positions and snapshot."""
    from repro.serve.journal import read_journal as jax_read_journal
    jpath = tmp_path / "farm.journal"

    async def serve():
        fc = FakeClock()
        farm = _bare_farm(clock=fc)
        j = FlushJournal(jpath, clock=fc, rotate_every=2)
        async with AsyncOscillatorFarm(farm, clock=fc, journal=j) as af:
            for i in range(2):
                af.register(f"core{i}", "t", seed=40)
            for n in (100, 300, 50):
                await af.draw("core0", "t", n, deadline_ms=0)
                await af.draw("core1", "t", n + 1, deadline_ms=0)
        j.close()
        return j.rotations

    assert _collect(serve()) >= 1
    recs = [json.loads(line) for line in jpath.read_text().splitlines()]
    assert recs[0]["type"] == "checkpoint"
    assert recs[0]["snapshot"]["topology"] == {"core0": None, "core1": None}
    assert all(r["topology"] == {"core0": None, "core1": None}
               for r in recs if r["type"] == "flush")
    t, j = read_journal(jpath), jax_read_journal(jpath)
    assert t[:4] == j[:4]
    assert t[4]["seq"] == j[4]["seq"]
    tsnap, jsnap = t[4]["snapshot"], j[4]["snapshot"]
    assert tsnap.keys() == jsnap.keys()
    for core in tsnap["cores"]:
        np.testing.assert_array_equal(tsnap["cores"][core]["pool_x"],
                                      jsnap["cores"][core]["pool_x"])
