"""Crash recovery for the serving tier: an append-only flush journal
(port of ``repro/serve/journal.py``).

``OscillatorFarm.snapshot()`` is the *explicit* resumability surface —
somebody has to call it, serialize it, and put it somewhere.  A crash
asks for the implicit version: the front-end appends one small record per
**completed flush** (plus one per client registration) to an append-only
JSONL file, and a restarted farm replays the journal to bit-exact stream
positions without any of the crashed process's memory.

What makes tiny records sufficient is the engine's determinism contract:
a client's word stream depends only on (weights, seed, lanes_per_client,
kernel config) plus its absolute word-row counter.  So the journal never
stores words or pool state — only each client's *position*:

    {"type": "flush", "seq": 7, "cores": {core: {client:
        [row, pending, buf_words, outbox_words]}}}

Recovery (:func:`replay_journal`) re-registers every journaled client
(same seed => same burn-in => same lane state), then recomputes each
client's lanes forward to ``row`` with the same fused kernel — the words
regenerated along the way rebuild the undelivered tail (service buffer +
outbox) bit-exactly, because chunk-invariant absolute-row indexing makes
one big replay launch identical to however many launches the crashed
process made (``PRNGService.replay_client``).

Durability contract:

* a record is appended (and by default fsync'd) only *after* its flush
  fully absorbed — a crash mid-flush recovers to the previous flush
  boundary, and the words of the interrupted flush are regenerated, not
  lost and not double-served;
* requests queued in the front-end but not yet flushed are NOT journaled
  — they failed with the crash and the tenant retries (the same contract
  a deadline timeout gives);
* a torn final line (crash mid-append) is detected and ignored on
  replay;
* every record carries a CRC32; damage in the MIDDLE of the file (bit
  rot, an outside writer) raises :class:`JournalCorrupt` at the exact
  record instead of silently replaying a suspect suffix —
  ``python -m repro_torch.serve.journal <path> --repair`` truncates to the
  last good prefix;
* one journal belongs to ONE live process: an exclusive flock on a
  ``<path>.lock`` sidecar (with a ``pid@host`` sentinel) makes a second
  writer fail fast with :class:`JournalLocked` instead of interleaving
  records.

The journal also records **topology events** — ``record_quarantine`` /
``record_rotation`` from the supervision layer (``serve.health``)
— so a kill-and-replay reconstructs the crashed process's *degraded*
topology (quarantined cores, standbys rotated into slots), not just its
stream positions.

**Compaction/rotation** (``rotate_every=N``): replaying positions alone
recomputes every stream from row 0, so replay cost grows with absolute
position forever.  After every N journaled flushes the journal rotates:
the live JSONL is renamed aside (``<path>.<seq>``, an immutable audit
segment) and a fresh segment opens with a **checkpoint** record — the
full ``farm.snapshot()`` (pool states, client counters, buffers,
outboxes, device topology), ndarray-encoded.  Recovery then restores the
checkpoint directly and replays only the <= N flush deltas after it, so
``replay_journal`` cost is bounded by the rotation window no matter how
long the process ran.  The rotation itself is crash-safe: the new
segment (checkpoint included) is written and fsync'd to a temp file
before any rename, and both renames are atomic — a crash at any point
leaves either the old segment or the checkpointed new one discoverable.

Every flush record (and checkpoint) also carries the farm's device
topology, so replaying onto a different device count is an *explicit*
decision (``on_topology_mismatch``), never a silent reuse: each core's
``(axis, device count, device ids)``, or ``None`` for an unmeshed pool,
as the JAX farm records it.
"""
from __future__ import annotations

import base64
import json
import os
import pathlib
import socket
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.clock import Clock, SystemClock

try:                         # POSIX advisory locks (single-writer fence)
    import fcntl
except ImportError:          # non-POSIX: the fence degrades to advisory-only
    fcntl = None

_VERSION = 1


class JournalLocked(RuntimeError):
    """Another live process holds this journal's writer lock.

    Two writers appending to one journal interleave records and corrupt
    the recovery story silently; the lock makes the second ``open`` fail
    fast instead.  ``holder`` is the ``pid@host`` sentinel the owning
    process wrote (stale-looking sentinels still mean a LIVE owner — the
    flock, not the sentinel, is the authority, and flocks die with their
    process)."""

    def __init__(self, message: str, *, holder: str = "unknown"):
        super().__init__(message)
        self.holder = holder


class JournalCorrupt(RuntimeError):
    """A record in the MIDDLE of the journal fails its CRC or does not
    parse — unlike a torn final line (a crash mid-append, expected and
    tolerated), mid-file damage means bit rot or an outside writer, and
    everything after the damage is suspect.  ``line_no`` (1-based) is
    the damaged line; ``seq`` is the last flush seq known good before
    it.  ``python -m repro_torch.serve.journal <path> --repair`` truncates to
    the last good prefix."""

    def __init__(self, message: str, *, line_no: int, seq: int):
        super().__init__(message)
        self.line_no = int(line_no)
        self.seq = int(seq)


def _crc_of(rec: Dict) -> int:
    """CRC32 of a record's canonical form (sorted keys, no whitespace) —
    key order on disk never affects the checksum."""
    payload = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(payload.encode("utf-8"))


def _check_line(line: str):
    """Parse + CRC-verify one journal line; returns the record (crc field
    removed).  Raises ValueError/json.JSONDecodeError on damage.
    Records without a crc field (older journals) are accepted."""
    rec = json.loads(line)
    if not isinstance(rec, dict):
        raise ValueError(f"journal line is not an object: {line[:80]!r}")
    crc = rec.pop("crc", None)
    if crc is not None and _crc_of(rec) != crc:
        raise ValueError("journal record crc mismatch")
    return rec


def _farm_topology(farm) -> Dict[str, object]:
    """Every core's device topology (``farm._topology``)."""
    from repro_torch.serve.farm import _topology
    return {core: _topology(svc) for core, svc in farm.services.items()}


def _encode(obj):
    """JSON-encode a snapshot tree: ndarrays become base64 blobs (exact
    bytes — bf16 pools and uint32 buffers round-trip bit-identically)."""
    if isinstance(obj, np.ndarray):
        return {"__nd__": str(obj.dtype), "shape": list(obj.shape),
                "b64": base64.b64encode(
                    np.ascontiguousarray(obj).tobytes()).decode("ascii")}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_encode(v) for v in sorted(obj)] if isinstance(obj, set) \
            else [_encode(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _decode(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            a = np.frombuffer(base64.b64decode(obj["b64"]),
                              dtype=np.dtype(obj["__nd__"]))
            return a.reshape(obj["shape"]).copy()
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def farm_positions(farm) -> Dict[str, Dict[str, List[int]]]:
    """Per-client stream positions of a farm right now:
    ``{core: {client: [row, pending, buf_words, outbox_words]}}``."""
    out: Dict[str, Dict[str, List[int]]] = {}
    for core, svc in farm.services.items():
        per = {}
        for c in svc.clients.values():
            per[c.name] = [int(c.row), int(c.pending), int(len(c.buf)),
                           int(svc.outbox_words(c.name))]
        out[core] = per
    return out


class FlushJournal:
    """Append-only JSONL journal of client registrations + flush positions.

    One journal belongs to one serving process; attach it to an
    ``AsyncOscillatorFarm(journal=...)`` and it records automatically.
    ``fsync=True`` (default) makes each record durable before the writer
    returns — the crash-recovery guarantee costs one fsync per flush, not
    per request.  An existing file is appended to (seq continues), so a
    recovered process can keep journaling into the same file.

    ``rotate_every=N`` bounds replay cost: after N flush records the
    live file is rotated aside and the new segment opens with a full
    ``farm.snapshot()`` checkpoint (see the module docstring).  The
    rotated segments (``<path>.<seq>``) are never read by recovery —
    they are the audit trail; delete them on whatever retention schedule
    suits.
    """

    def __init__(self, path: str | os.PathLike, *, fsync: bool = True,
                 clock: Optional[Clock] = None,
                 rotate_every: Optional[int] = None):
        self.path = pathlib.Path(path)
        self.fsync = bool(fsync)
        self.clock: Clock = clock or SystemClock()
        if rotate_every is not None and int(rotate_every) < 1:
            raise ValueError(f"rotate_every must be >= 1, got {rotate_every}")
        self.rotate_every = None if rotate_every is None else int(rotate_every)
        self.rotations = 0
        self.seq = 0
        self._segment_flushes = 0
        self._lock_f = None
        self._acquire_writer_lock()
        try:
            tmp = self._tmp_path()
            if not self.path.exists() and tmp.exists():
                # a crash landed between the two rotation renames: the
                # fsync'd checkpointed segment is complete — finish the
                # rotation
                os.replace(tmp, self.path)
            if self.path.exists():
                _, last_seq, _, _, ckpt = read_journal(self.path)
                self.seq = last_seq
                self._segment_flushes = last_seq - (
                    int(ckpt["seq"]) if ckpt is not None else 0)
            self._f = open(self.path, "a", encoding="utf-8")
        except BaseException:   # release the flock, then reraise
            self._release_writer_lock()
            raise
        if self.seq == 0 and self._f.tell() == 0:
            self._append({"type": "open", "v": _VERSION})

    def _acquire_writer_lock(self) -> None:
        """Single-writer fence: an exclusive flock on a persistent
        ``<path>.lock`` sidecar, held for this journal's lifetime.  A
        second process opening the same journal fails fast with
        :class:`JournalLocked` naming the holder.  The flock (not the
        sidecar's existence) is the authority: it evaporates with the
        owning process, so a crashed writer never wedges recovery."""
        if fcntl is None:
            return
        lock_path = self.path.with_name(self.path.name + ".lock")
        f = open(lock_path, "a+", encoding="utf-8")
        try:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            f.seek(0)
            holder = f.read().strip() or "unknown"
            f.close()
            raise JournalLocked(
                f"journal {self.path} is already open for writing by "
                f"{holder}; one journal belongs to one serving process",
                holder=holder)
        f.seek(0)
        f.truncate()
        f.write(f"{os.getpid()}@{socket.gethostname()}\n")
        f.flush()
        self._lock_f = f

    def _release_writer_lock(self) -> None:
        if self._lock_f is not None:
            try:
                if fcntl is not None:
                    fcntl.flock(self._lock_f.fileno(), fcntl.LOCK_UN)
            finally:
                self._lock_f.close()
                self._lock_f = None

    def _tmp_path(self) -> pathlib.Path:
        return self.path.with_name(self.path.name + ".rotate-tmp")

    def _append(self, rec: Dict, f=None) -> None:
        f = f if f is not None else self._f
        rec["ts"] = self.clock.time()
        rec["crc"] = _crc_of(rec)    # over everything else, ts included
        f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())

    def record_register(self, core: str, client: str, seed: int) -> None:
        """Journal one client registration (the seed actually used, so
        replay re-derives the identical burn-in state)."""
        self._append({"type": "register", "core": core, "client": client,
                      "seed": int(seed)})

    def record_flush(self, farm) -> None:
        """Journal the post-flush position of every client (call only
        after the flush fully absorbed + delivered).  Triggers a rotation
        once ``rotate_every`` flushes accumulated in this segment."""
        self.seq += 1
        self._append({"type": "flush", "seq": self.seq,
                      "cores": farm_positions(farm),
                      "topology": _farm_topology(farm)})
        self._segment_flushes += 1
        if (self.rotate_every is not None
                and self._segment_flushes >= self.rotate_every):
            self._rotate(farm)

    def _rotate(self, farm) -> None:
        """Seal the live segment and start a new one from a checkpoint.

        Crash-safe ordering: the checkpoint is durably on disk in the temp
        segment BEFORE the live file is renamed aside, and both renames
        are atomic — at every instant either ``path`` or
        ``path.rotate-tmp`` holds a replayable journal (``__init__`` and
        ``replay_journal`` both pick up the temp file).
        """
        tmp = self._tmp_path()
        with open(tmp, "w", encoding="utf-8") as f:
            self._append({"type": "checkpoint", "seq": self.seq,
                          "v": _VERSION,
                          "snapshot": _encode(farm.snapshot())}, f=f)
        self._f.close()
        os.replace(self.path, self.path.with_name(
            f"{self.path.name}.{self.seq:08d}"))
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        self._segment_flushes = 0
        self.rotations += 1

    def record_quarantine(self, core: str, reason: str = "") -> None:
        """Journal a core quarantine (part of the degraded topology a
        replay must reconstruct)."""
        self._append({"type": "quarantine", "core": core,
                      "reason": str(reason)})

    def record_rotation(self, core: str) -> None:
        """Journal a standby rotation into ``core``'s routing slot (replay
        re-performs it — the recovering farm must attach the same
        standby)."""
        self._append({"type": "rotation", "core": core})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
        self._release_writer_lock()

    def __enter__(self) -> "FlushJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_journal(path: str | os.PathLike) -> Tuple[
        List[Tuple], int,
        Optional[Dict[str, Dict[str, List[int]]]], bool, Optional[Dict]]:
    """Parse one journal segment: (events in order, last flush seq, last
    flush positions or None, torn_tail, checkpoint or None).

    ``events`` is the ordered topology history replay must re-apply:
    ``("register", core, client, seed)``, ``("quarantine", core,
    reason)``, ``("rotation", core)`` — order matters (a client
    registered before a rotation rides the standby; one registered after
    starts there).

    A rotated segment opens with a checkpoint record; its decoded farm
    snapshot and seq come back as ``checkpoint``, and the events list
    then covers only what happened *after* it (earlier topology lives
    inside the snapshot, restored wholesale).

    Every record carries a CRC32 over its canonical JSON form.  A
    truncated or mismatching FINAL line (the crash landed mid-append) is
    ignored and reported via ``torn_tail`` — every complete record
    before it is still recovered.  A damaged MID-FILE record is a
    different animal (bit rot / outside writer — everything after it is
    suspect) and raises :class:`JournalCorrupt` naming the exact line
    and the last good flush seq; ``python -m repro_torch.serve.journal <path>
    --repair`` truncates to the good prefix.
    """
    events: List[Tuple] = []
    last_seq, last_pos, torn, ckpt = 0, None, False, None
    rotated_since_flush: set = set()
    data = pathlib.Path(path).read_bytes().decode("utf-8", errors="replace")
    lines = data.split("\n")
    # a well-formed journal ends with "\n": the final split element is ""
    if lines and lines[-1] == "":
        lines.pop()
    elif lines:
        torn = True
        lines.pop()
    for i, line in enumerate(lines):
        try:
            rec = _check_line(line)
        except (json.JSONDecodeError, ValueError) as e:
            if i == len(lines) - 1:
                # damaged FINAL record: crash mid-append, tolerated
                torn = True
                break
            raise JournalCorrupt(
                f"journal {path} record {i + 1} is damaged mid-file "
                f"({e}); last good flush seq {last_seq} — run "
                f"`python -m repro_torch.serve.journal {path} --repair` to "
                f"truncate to the good prefix",
                line_no=i + 1, seq=last_seq)
        t = rec.get("type")
        if t == "register":
            events.append(("register", rec["core"], rec["client"],
                           int(rec["seed"])))
        elif t == "quarantine":
            events.append(("quarantine", rec["core"],
                           str(rec.get("reason", ""))))
        elif t == "rotation":
            events.append(("rotation", rec["core"]))
            rotated_since_flush.add(rec["core"])
        elif t == "flush":
            last_seq = int(rec["seq"])
            last_pos = rec["cores"]
            rotated_since_flush.clear()
        elif t == "checkpoint":
            ckpt = {"seq": int(rec["seq"]),
                    "snapshot": _decode(rec["snapshot"])}
            last_seq = max(last_seq, ckpt["seq"])
    if last_pos is not None and rotated_since_flush:
        # a core rotated AFTER the last flush record: those positions
        # describe the replaced service, not the standby now in the slot
        # (whose re-registered clients sit at row 0) — drop them so
        # replay never advances the standby to the dead core's rows
        last_pos = {c: p for c, p in last_pos.items()
                    if c not in rotated_since_flush}
    return events, last_seq, last_pos, torn, ckpt


def repair_journal(path: str | os.PathLike) -> Dict[str, int]:
    """Truncate a journal to its last good prefix (the mid-file-damage
    recovery tool behind ``JournalCorrupt``).

    Validates every line's CRC in order and atomically rewrites the file
    to contain exactly the records before the first damaged one (via a
    temp file + ``os.replace`` — a crash mid-repair leaves the original
    untouched).  Returns ``{"kept": N, "dropped": M}`` in records.  A
    journal with no damage is left byte-identical (dropped == 0).
    """
    path = pathlib.Path(path)
    data = path.read_bytes().decode("utf-8", errors="replace")
    lines = data.split("\n")
    trailing_nl = bool(lines) and lines[-1] == ""
    if lines and lines[-1] == "":
        lines.pop()
    good = 0
    for line in lines:
        try:
            _check_line(line)
        except (json.JSONDecodeError, ValueError):
            break
        good += 1
    dropped = len(lines) - good
    if dropped == 0 and trailing_nl:
        return {"kept": good, "dropped": 0}
    tmp = path.with_name(path.name + ".repair-tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        for line in lines[:good]:
            f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return {"kept": good, "dropped": dropped}


def replay_journal(farm, path: str | os.PathLike,
                   chunk_rows: int = 4096, *,
                   on_topology_mismatch: str = "refuse"
                   ) -> Dict[str, object]:
    """Rebuild a crashed serving process's stream positions onto ``farm``.

    ``farm`` must have the same cores attached (same weights/configs —
    e.g. rebuilt via ``OscillatorFarm.from_generated`` or the weight
    registry) and **no clients registered yet**.  Every journaled client
    is re-registered with its journaled seed, then advanced to its last
    flushed position with ``PRNGService.replay_client`` — after which
    every stream continues bit-exactly where the crashed process left
    off, including words that were generated but still undelivered
    (service buffer + outbox).

    A rotated journal opens with a checkpoint: the farm snapshot is
    restored directly (``on_topology_mismatch`` passes through to
    ``OscillatorFarm.restore`` — a checkpoint taken on a different
    device count refuses unless you say ``"replan"``) and only the flush
    deltas after it are recomputed, so replay cost is bounded by the
    rotation window, not absolute stream position.

    Returns a summary: flushes recovered, clients replayed, word rows
    recomputed (post-checkpoint deltas only), the checkpoint seq (0 when
    the segment has none), and whether a torn tail record was discarded.
    """
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".rotate-tmp")
    if not path.exists() and tmp.exists():
        path = tmp       # crash between the rotation renames: use the
        #                  fsync'd checkpointed segment
    events, last_seq, positions, torn, ckpt = read_journal(path)
    unknown = {ev[1] for ev in events} - set(farm.services)
    if unknown:
        raise ValueError(
            f"journal references cores not attached to this farm: "
            f"{sorted(unknown)} (attach the same core set before replay)")
    if ckpt is not None:
        farm.restore(ckpt["snapshot"],
                     on_topology_mismatch=on_topology_mismatch)
    # Re-apply the topology history IN ORDER: a client registered before
    # a rotation is carried onto the standby by the rotation itself; one
    # registered after starts there directly.  The recovering process
    # must attach the same standbys before replay (rotation re-performs
    # against them) — the crashed process's degraded topology
    # (quarantined set, rotated slots) is reconstructed exactly.
    quarantines = rotations = 0
    for ev in events:
        if ev[0] == "register":
            _, core, client, seed = ev
            farm.register(core, client, seed=seed)
        elif ev[0] == "quarantine":
            _, core, reason = ev
            if core not in farm.quarantined:
                farm.quarantine(core, reason=reason)
            quarantines += 1
        elif ev[0] == "rotation":
            farm.rotate(ev[1])
            rotations += 1
    rows_replayed = 0
    if positions:
        for core, per_client in positions.items():
            svc = farm.services[core]
            for client, (row, pending, buf, outbox) in per_client.items():
                if client not in svc.clients:
                    raise ValueError(
                        f"journal flush record names unregistered client "
                        f"{core}/{client} (journal corrupt?)")
                before = int(svc.clients[client].row)
                svc.replay_client(client, row=int(row), pending=int(pending),
                                  buf_words=int(buf),
                                  outbox_words=int(outbox),
                                  chunk_rows=chunk_rows)
                rows_replayed += int(row) - before
    clients = sum(len(svc.clients) for svc in farm.services.values())
    return {"flushes": last_seq, "clients": clients,
            "rows_replayed": rows_replayed, "torn_tail": torn,
            "quarantines": quarantines, "rotations": rotations,
            "checkpoint_seq": 0 if ckpt is None else int(ckpt["seq"])}


def main(argv=None) -> int:
    """CLI: inspect a journal segment, or ``--repair`` mid-file damage.

    ``python -m repro_torch.serve.journal <path>`` prints a summary (and exits
    2 on mid-file corruption, naming the damaged line);
    ``--repair`` truncates to the last good prefix first.
    """
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.journal",
        description="Inspect or repair a serve-tier flush journal.")
    ap.add_argument("path", help="journal file (JSONL segment)")
    ap.add_argument("--repair", action="store_true",
                    help="truncate the journal to its last good prefix "
                         "(atomic; a crash mid-repair leaves the original)")
    args = ap.parse_args(argv)
    if args.repair:
        res = repair_journal(args.path)
        print(f"repair: kept {res['kept']} record(s), "
              f"dropped {res['dropped']}")
    try:
        events, last_seq, last_pos, torn, ckpt = read_journal(args.path)
    except JournalCorrupt as e:
        print(f"CORRUPT: {e}")
        return 2
    n_reg = sum(1 for ev in events if ev[0] == "register")
    n_q = sum(1 for ev in events if ev[0] == "quarantine")
    n_rot = sum(1 for ev in events if ev[0] == "rotation")
    print(f"flushes: {last_seq}  registrations: {n_reg}  "
          f"quarantines: {n_q}  rotations: {n_rot}  "
          f"checkpoint: {'none' if ckpt is None else ckpt['seq']}  "
          f"torn_tail: {torn}")
    if last_pos is not None:
        for core in sorted(last_pos):
            per = last_pos[core]
            rows = sum(int(p[0]) for p in per.values())
            print(f"  {core}: {len(per)} client(s), {rows} total rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
