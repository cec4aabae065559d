"""Asyncio serving front-end: deadline-driven gang flushes, no manual flush()
(port of ``repro/serve/async_frontend.py``, over the port's farm).

The gang kernels and planner (``serve/farm.py``) amortize launch overhead
across cores — but only for tenants that coordinate their ``flush()``
calls by hand.  ``AsyncOscillatorFarm`` closes that gap: every tenant just
``await draw(core, client, n_words, deadline_ms=...)`` and a single
background *flusher* task coalesces pending demand across all tenants and
coroutines, firing one planner-shaped gang flush when either

  * the earliest wall-clock **deadline** among queued requests expires, or
  * **auto_flush_rows** worth of launch work has accumulated (counted in
    launch rows via ``PRNGService.rows_needed_with`` — a request coverable
    from a client's buffer adds no rows), whichever comes first.

Tenants on different threads participate through a thread-safe ingress
(a deque appended from any thread + ``loop.call_soon_threadsafe`` to wake
the flusher); sync callers block on ``draw_sync``.

**The production tier** (everything below is optional and off by default
except offload):

* **Executor offload** (``offload=True``): a flush is split into an
  on-loop *commit* phase (requests enter the services, demand freezes, an
  asyncio future can no longer be cancelled and a concurrent future is
  moved to RUNNING) and an off-loop *launch* phase — ``farm.flush
  (deliver=False)`` runs on a worker thread via ``run_in_executor``, so
  ingress, cancellation, and deadline accounting stay live while a slow
  gang launch is in flight.  Every launch runs with the farm's CUDA
  device current (a ``torch.cuda.device`` guard on the index resolved
  when the front-end was built), whichever thread runs it, and a batch's
  futures resolve
  only after its words reached the host: every launch copies its words
  with a synchronising ``.cpu()``.  Served words park in the service outboxes as
  each group absorbs; the launch-free delivery pass + FIFO split run back
  on the loop.  A single-flight ``asyncio.Lock`` guarantees two flushes
  never interleave ``absorb()`` against one farm — the committed batch is
  the *only* demand the in-flight launch serves, so requests arriving
  mid-launch wait for the next cycle and bit-identity to the solo path is
  preserved (property-tested with mid-launch submits/cancels).

* **Admission control** (``admission=AdmissionController(...)``,
  ``serve.admission``): per-tenant token buckets and a farm-wide
  queued-rows ceiling gate every submit *before* it queues; over-limit
  submits fail fast with a typed ``Overloaded`` carrying a
  ``retry_after_ms`` hint.  Already-admitted futures always resolve.

* **SLO classes** (``slo=`` per request): ``"latency"`` demand forbids
  the padded group-max launch shape when demand is skewed (the planner
  must pick ragged/split, so a latency tenant never waits for co-tenants'
  overdraw rows); ``"bulk"`` demand always rides the padded,
  maximally-amortized launch.  SLO never changes delivered words — only
  the launch shape that serves them.

* **Crash recovery** (``journal=`` a ``FlushJournal`` or path,
  ``serve.journal``): one appended record per completed flush
  (per-client row/pending/buffer/outbox positions) + one per
  registration.  A restarted process rebuilds the same farm and calls
  ``journal.replay_journal(farm, path)`` to resume every tenant stream
  bit-exactly at the last flush boundary.

Determinism contract: delivered words are
bit-identical per tenant to the sync ``gang=False`` solo path, however
requests interleave, coalesce, or get cancelled — a direct consequence of
the farm's chunk-invariant absolute-row indexing plus two front-end rules:

  * a request enters the farm (``svc.request``) only at flush-commit
    time, so cancelling a queued future rolls its demand back by simply
    never submitting it;
  * a flush's returned words are split FIFO per (core, client): words owed
    to the sync surface (pre-existing service pending + outbox backlog)
    are re-parked via ``PRNGService.park`` — never dropped — and the tail
    resolves this front-end's futures in submission order.

Every time read goes through the injectable ``Clock``
(``serve.clock``): under a manual-advance ``FakeClock`` the flusher
wakes exactly when the test advances fake time past a deadline, so every
deadline/coalescing behavior is testable with zero real sleeps.

``snapshot()`` quiesces in-flight futures: it waits out any launch in
flight (single-flight lock), drains the ingress, and folds still-queued
front-end demand into the per-client ``pending`` counts of the farm
snapshot.  Restoring that snapshot anywhere — a plain sync farm or
another front-end — replays the in-flight draws through the sync surface
(next ``flush()``), bit-identically to what the live futures receive.
The live front-end keeps serving its own futures after the snapshot.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import functools
import os
import threading
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.farm import OscillatorFarm
from repro_torch.serve.health import CoreQuarantined, HealthMonitor
from repro_torch.serve.journal import FlushJournal

_Future = Union["asyncio.Future", "concurrent.futures.Future"]

_SLO_CLASSES = (None, "latency", "bulk")


@dataclasses.dataclass
class _Request:
    core: str
    client: str
    n_words: int
    deadline: float            # absolute, in this front-end's clock
    future: _Future
    slo: Optional[str] = None
    rows_est: int = 0          # admission gauge units owed back on dequeue
    released: bool = False


def _on_device(index: Optional[int], fn):
    """Run ``fn`` with CUDA device ``index`` current on this thread (a new
    thread starts on device 0, whatever its creator set); ``None`` runs it
    as it is (a CPU farm)."""
    if index is None:
        return fn()
    with torch.cuda.device(index):
        return fn()


def percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


class AsyncOscillatorFarm:
    """Async front-end over an ``OscillatorFarm``: futures in, gang
    flushes out.

    Two ways to run the flusher:

      * ``async with AsyncOscillatorFarm(farm) as af`` (or ``await
        af.start()`` / ``await af.aclose()``) inside an existing event
        loop — the deterministic-test mode;
      * ``af.start_thread()`` / ``af.close()`` — a daemon thread owns the
        loop, and sync callers on any thread use ``draw_sync``.

    ``deadline_ms`` is *relative* wall-clock budget per request; ``None``
    falls back to ``default_deadline_ms`` (its own ``None`` meaning
    "flush at the next flusher pass", i.e. no intentional batching delay).
    A flush serves EVERY queued request, not just the due ones — riders
    amortize the launch the deadline paid for.

    ``offload=True`` (default) runs the launch phase of every flush on a
    worker thread so the event loop stays live; ``offload=False`` pins
    the on-loop launch (the baseline).  ``executor``
    optionally supplies the worker pool (otherwise a single-thread
    executor is owned and shut down with the front-end).

    ``stats_window`` / ``error_window`` bound ``deadline_stats()`` and
    ``flush_errors`` to the most recent N samples/errors (ring buffers) —
    a long-running front-end holds constant memory.

    ``health=HealthMonitor(...)`` arms the supervision layer
    (``serve.health``): transient launch failures are retried with
    capped exponential backoff under the single-flight lock (the batch's
    demand stays parked at the same absolute stream rows, so retried
    words are bit-identical to a never-failed flush); consecutive
    failures trip a per-core circuit breaker; and an online NIST gate
    over words each core actually served quarantines a degraded core —
    rotating its standby into the routing slot when the farm has one,
    failing its tenants with a typed ``CoreQuarantined`` otherwise.
    Quarantines/rotations are journaled (when a journal is attached) and
    shrink the admission ceiling by the lost capacity fraction.
    """

    def __init__(self, farm: OscillatorFarm, *,
                 auto_flush_rows: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 clock: Optional[Clock] = None,
                 offload: bool = True,
                 executor: Optional[concurrent.futures.Executor] = None,
                 admission: Optional[AdmissionController] = None,
                 journal: Union[FlushJournal, str, os.PathLike, None] = None,
                 health: Optional[HealthMonitor] = None,
                 stats_window: int = 4096,
                 error_window: int = 64):
        self.farm = farm
        self.health = health
        if health is not None:
            farm.attach_monitor(health)
        self.auto_flush_rows = auto_flush_rows
        self.default_deadline_ms = default_deadline_ms
        self.clock: Clock = clock or farm.clock or SystemClock()
        self.admission = admission
        self._own_journal = journal is not None and not isinstance(
            journal, FlushJournal)
        self.journal: Optional[FlushJournal] = (
            FlushJournal(journal, clock=self.clock) if self._own_journal
            else journal)
        self._offload = bool(offload)
        self._executor = executor
        self._own_executor = False
        self._queue: List[_Request] = []
        self._ingress: Deque[_Request] = collections.deque()
        self._wake: Optional[asyncio.Event] = None
        self._drain_waiters: List[asyncio.Future] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[int] = None
        self._task: Optional[asyncio.Task] = None
        # the farm's CUDA device, resolved on the constructing thread:
        # every launch runs with it current, on whichever thread
        dev = getattr(farm, "device", None)
        self._cuda_index: Optional[int] = (
            (dev.index if dev.index is not None
             else torch.cuda.current_device())
            if dev is not None and dev.type == "cuda" else None)
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[asyncio.Event] = None
        self._flush_lock: Optional[asyncio.Lock] = None
        self._inflight = False
        self.flushes = 0
        self.served_words = 0
        # Ring buffers: a long-running front-end must not grow linearly in
        # served requests / failures.  deadline_stats() is windowed to the
        # stats_window most recent samples.
        self._miss_ms: Deque[float] = collections.deque(maxlen=stats_window)
        # flush failures survive here (each batch future also carries its
        # exception); the flusher itself never dies except by aclose()
        self.flush_errors: Deque[BaseException] = collections.deque(
            maxlen=error_window)

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "AsyncOscillatorFarm":
        """Start the flusher task on the currently running loop."""
        if self._task is not None:
            raise RuntimeError("front-end already started")
        self._loop = asyncio.get_running_loop()
        self._loop_thread = threading.get_ident()
        self._wake = asyncio.Event()
        self._flush_lock = asyncio.Lock()
        if self._offload and self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="farm-launch")
            self._own_executor = True
        self._task = self._loop.create_task(self._run())
        return self

    async def aclose(self) -> None:
        """Stop the flusher; still-queued futures are cancelled.

        An in-flight offloaded launch is allowed to FINISH (executor
        shutdown waits): its words are already parked in the service
        outboxes by the ``deliver=False`` pass, so nothing is lost — they
        surface on the sync surface, same as the partial-failure path.
        """
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
            self._task = None
        if self._own_executor and self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
            self._own_executor = False
        self._ingest()
        for r in self._queue:
            self._release(r)
            r.future.cancel()
        self._queue.clear()
        for w in self._drain_waiters:
            if not w.done():
                w.set_result(None)
        self._drain_waiters.clear()
        if self._own_journal and self.journal is not None:
            self.journal.close()

    async def __aenter__(self) -> "AsyncOscillatorFarm":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def start_thread(self) -> "AsyncOscillatorFarm":
        """Run the event loop + flusher on a daemon thread (sync callers
        then use ``draw_sync`` from any thread)."""
        if self._thread is not None or self._task is not None:
            raise RuntimeError("front-end already started")
        started = threading.Event()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._thread_body(started)),
            name="async-farm-flusher", daemon=True)
        self._thread.start()
        started.wait()
        return self

    async def _thread_body(self, started: threading.Event) -> None:
        self._stop = asyncio.Event()
        await self.start()
        started.set()
        await self._stop.wait()
        await self.aclose()

    def close(self) -> None:
        """Stop a ``start_thread`` front-end and join its thread."""
        if self._thread is None:
            return
        self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join()
        self._thread = None
        self._loop = None

    # -- client surface ------------------------------------------------------

    def register(self, core: str, client: str,
                 seed: Optional[int] = None) -> None:
        """Register a tenant stream (do this before serving traffic; it is
        not synchronized against a running flusher on another thread).
        With a journal attached, the registration — including the seed
        actually used — is journaled so crash recovery re-derives the
        identical stream."""
        self.farm.register(core, client, seed=seed)
        if self.journal is not None:
            self.journal.record_register(
                core, client, self.farm.services[core].clients[client].seed)

    def _deadline(self, deadline_ms: Optional[float]) -> float:
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if deadline_ms is None:
            deadline_ms = 0.0
        return self.clock.now() + float(deadline_ms) / 1e3

    def _validate(self, core: str, client: str, n_words: int,
                  slo: Optional[str]) -> None:
        svc = self.farm.services.get(core)
        if svc is None:
            raise KeyError(f"unknown core {core!r}; "
                           f"have {sorted(self.farm.services)}")
        self.farm._check_serving(core)   # fail fast: CoreQuarantined
        if client not in svc.clients:
            raise KeyError(f"client {client!r} not registered on {core!r}")
        if n_words < 0:
            raise ValueError(f"n_words must be >= 0, got {n_words}")
        if slo not in _SLO_CLASSES:
            raise ValueError(f"slo must be one of {_SLO_CLASSES}, "
                             f"got {slo!r}")

    def _admit(self, core: str, client: str, n_words: int) -> int:
        """Admission gate (may raise ``Overloaded``); returns the request's
        launch-row estimate owed back to the ceiling gauge on dequeue."""
        rows_est = -(-int(n_words)
                     // self.farm.services[core].lanes_per_client)
        if self.admission is not None:
            self.admission.admit(core, client, n_words, rows_est)
        return rows_est

    def _release(self, r: _Request) -> None:
        """Return a dequeued request's rows to the admission gauge
        (exactly once per request)."""
        if not r.released:
            r.released = True
            if self.admission is not None:
                self.admission.release(r.rows_est)

    def submit(self, core: str, client: str, n_words: int,
               deadline_ms: Optional[float] = None,
               slo: Optional[str] = None) -> asyncio.Future:
        """Queue a draw from the loop thread; returns the tenant's future.

        The future resolves with exactly ``n_words`` uint32 words once a
        flush (deadline- or threshold-triggered) serves it.  Cancelling it
        while queued rolls the demand back cleanly — the farm never sees
        the request, and no other tenant's stream shifts.

        Loop-thread only (enforced): an asyncio future and the queue are
        not thread-safe, so a foreign-thread caller must use ``draw_sync``
        (the thread-safe ingress) instead.
        """
        if self._task is None:
            raise RuntimeError("front-end not started")
        if threading.get_ident() != self._loop_thread:
            raise RuntimeError(
                "submit() called from a foreign thread would race the "
                "queue unsynchronized; use draw_sync() (the thread-safe "
                "ingress) there")
        self._validate(core, client, n_words, slo)
        fut = self._loop.create_future()
        if n_words == 0:
            fut.set_result(np.empty(0, np.uint32))
            return fut
        rows_est = self._admit(core, client, n_words)
        self._queue.append(_Request(core, client, int(n_words),
                                    self._deadline(deadline_ms), fut,
                                    slo=slo, rows_est=rows_est))
        self._wake.set()
        return fut

    async def draw(self, core: str, client: str, n_words: int,
                   deadline_ms: Optional[float] = None,
                   slo: Optional[str] = None) -> np.ndarray:
        """``await`` one tenant draw (see ``submit``)."""
        return await self.submit(core, client, n_words, deadline_ms, slo)

    def draw_sync(self, core: str, client: str, n_words: int,
                  deadline_ms: Optional[float] = None,
                  timeout: Optional[float] = None,
                  slo: Optional[str] = None) -> np.ndarray:
        """Blocking draw from ANY thread: the thread-safe ingress.

        Appends the request to a cross-thread deque and wakes the flusher
        with ``call_soon_threadsafe``; blocks on a
        ``concurrent.futures.Future`` until the coalesced flush serves it.

        On ``timeout`` the request is PRUNED: a still-queued future is
        cancelled (its demand rolls back — the farm never sees it, and no
        stats are recorded for it); a request already committed to an
        in-flight flush cannot be un-launched, so its words are routed
        back to the service outbox when they arrive — the stream stays
        gap-free either way, and no launch rows are ever spent on a
        future nobody reads twice.
        """
        if self._task is None or self._loop is None:
            # _task (not just _loop) is the liveness flag: after aclose()
            # the loop object may survive with no flusher to serve us
            raise RuntimeError("front-end not started")
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            # blocking the loop thread would starve the flusher forever
            raise RuntimeError(
                "draw_sync called from the event-loop thread would "
                "deadlock; use `await draw(...)` / submit() there")
        self._validate(core, client, n_words, slo)
        cfut: concurrent.futures.Future = concurrent.futures.Future()
        if n_words == 0:
            cfut.set_result(np.empty(0, np.uint32))
            return cfut.result()
        rows_est = self._admit(core, client, n_words)
        self._ingress.append(_Request(core, client, int(n_words),
                                      self._deadline(deadline_ms), cfut,
                                      slo=slo, rows_est=rows_est))
        self._loop.call_soon_threadsafe(self._wake.set)
        try:
            return cfut.result(timeout)
        except concurrent.futures.TimeoutError:
            if not cfut.cancel():
                # Too late to prune: the flush already committed this
                # request (future RUNNING) or resolved it.  Re-park the
                # words on the sync surface so the stream stays gap-free
                # instead of stranding them in a future nobody reads.
                def _repark(f: concurrent.futures.Future) -> None:
                    if not f.cancelled() and f.exception() is None:
                        self.farm.services[core].park(client, f.result())
                cfut.add_done_callback(
                    lambda f: self._loop.call_soon_threadsafe(_repark, f))
            # wake the flusher so a cancelled request is pruned promptly
            # (it may hold the earliest deadline)
            self._loop.call_soon_threadsafe(self._wake.set)
            raise

    async def drain(self) -> None:
        """Wait until the flusher has no currently-actionable work left
        (every due flush performed — including any launch in flight;
        remaining requests are all waiting on future deadlines / more
        coalescing)."""
        if self._task is None:
            raise RuntimeError("front-end not started")
        fut = self._loop.create_future()
        self._drain_waiters.append(fut)
        self._wake.set()
        await fut

    async def flush_now(self) -> None:
        """Force one flush of everything queued, deadlines notwithstanding.

        A flush failure is recorded in ``flush_errors`` (same as the
        background path) and re-raised to this caller; the batch's
        futures carry it either way.  Serialized against the background
        flusher by the single-flight lock.
        """
        if self._task is None:
            raise RuntimeError("front-end not started")
        self._ingest()
        if self._queue:
            try:
                await self._flush_cycle()
            # record, then reraise: a failure lands in flush_errors exactly
            # as on the background path
            except Exception as e:
                self.flush_errors.append(e)
                raise
        await self.drain()

    # -- introspection -------------------------------------------------------

    @property
    def pending_requests(self) -> int:
        """Queued front-end draws not yet served (ingress included)."""
        return (sum(1 for r in self._queue if not r.future.cancelled())
                + len(self._ingress))

    @property
    def in_flight(self) -> bool:
        """True while a committed flush's launch phase is running (the
        window during which ingress must stay live under offload)."""
        return self._inflight

    @property
    def loop(self) -> Optional[asyncio.AbstractEventLoop]:
        """The event loop serving this front-end (``None`` before start) —
        for foreign threads that need ``run_coroutine_threadsafe``."""
        return self._loop

    @property
    def launches(self) -> int:
        return self.farm.launches

    def pending_rows(self) -> int:
        """Launch rows the queued front-end demand would add on top of the
        farm's own pending — the quantity compared against
        ``auto_flush_rows``."""
        extra: Dict[str, Dict[str, int]] = {}
        for r in self._queue:
            if not r.future.cancelled():
                per = extra.setdefault(r.core, {})
                per[r.client] = per.get(r.client, 0) + r.n_words
        return sum(svc.rows_needed_with(extra.get(core))
                   for core, svc in self.farm.services.items())

    def miss_samples_ms(self) -> List[float]:
        """Recorded deadline-miss samples (ms past deadline, 0 = on time),
        oldest first — the raw series behind ``deadline_stats()``; public
        so benchmarks can window it (e.g. timed region only).  Bounded to
        the ``stats_window`` most recent samples."""
        return list(self._miss_ms)

    def deadline_stats(self) -> Dict[str, float]:
        """p50/p99/max deadline-miss latency (ms) over the most recent
        ``stats_window`` served requests (ring buffer — a long-running
        front-end reports a sliding window, not all-time); a request
        served before its deadline counts as 0 miss."""
        return {"served_requests": float(len(self._miss_ms)),
                "p50_miss_ms": percentile(list(self._miss_ms), 0.50),
                "p99_miss_ms": percentile(list(self._miss_ms), 0.99),
                "max_miss_ms": max(self._miss_ms, default=0.0)}

    # -- flusher -------------------------------------------------------------

    def _ingest(self) -> None:
        """Move thread-ingress requests into the queue; prune cancelled
        (returning their rows to the admission gauge)."""
        while self._ingress:
            self._queue.append(self._ingress.popleft())
        keep = []
        for r in self._queue:
            if r.future.cancelled():
                self._release(r)
            else:
                keep.append(r)
        self._queue = keep

    def _earliest_deadline(self) -> Optional[float]:
        return min((r.deadline for r in self._queue), default=None)

    def _due(self) -> bool:
        if not self._queue:
            return False
        if self._earliest_deadline() <= self.clock.now():
            return True
        return (self.auto_flush_rows is not None
                and self.pending_rows() >= self.auto_flush_rows)

    def _commit(self) -> Optional[Tuple[List[_Request],
                                        Dict[Tuple[str, str], int],
                                        Dict[Tuple[str, str],
                                             List[_Request]],
                                        Dict[str, str]]]:
        """On-loop commit phase: freeze the queued demand into the farm.

        Runs synchronously on the loop thread, so nothing interleaves with
        it: an asyncio future can no longer be cancelled once committed,
        and a concurrent future is moved to RUNNING first (late
        ``cancel()`` calls fail instead of racing the launch).  After
        commit, the batch is the ONLY demand the launch phase serves —
        requests arriving mid-launch stay queued for the next cycle.
        """
        batch: List[_Request] = []
        quarantined = self.farm.quarantined
        for r in self._queue:
            self._release(r)
            f = r.future
            if isinstance(f, concurrent.futures.Future):
                if not f.set_running_or_notify_cancel():
                    continue               # cancelled: demand rolled back
            elif f.cancelled():
                continue
            if r.core in quarantined:
                # quarantined with no standby after this request queued:
                # its demand never enters the farm
                f.set_exception(CoreQuarantined(
                    f"core {r.core!r} quarantined while request was "
                    f"queued", core=r.core, reason="quarantined"))
                continue
            batch.append(r)
        self._queue = []
        if not batch:
            return None
        # Words the sync surface is owed come FIRST in each client's flush
        # output (outbox backlog, then earlier-requested service pending);
        # record the counts so the split below can re-park them.
        owed: Dict[Tuple[str, str], int] = {}
        for core, svc in self.farm.services.items():
            for name in svc.clients:
                n = svc.pending_words(name) + svc.outbox_words(name)
                if n:
                    owed[(core, name)] = n
        fifo: Dict[Tuple[str, str], List[_Request]] = {}
        slos: Dict[str, set] = {}
        for r in batch:
            self.farm.services[r.core].request(r.client, r.n_words)
            fifo.setdefault((r.core, r.client), []).append(r)
            slos.setdefault(r.core, set()).add(r.slo)
        slo_by_core = {}
        for core, classes in slos.items():
            if "latency" in classes:
                slo_by_core[core] = "latency"
            elif classes == {"bulk"}:
                slo_by_core[core] = "bulk"
        return batch, owed, fifo, slo_by_core

    def _resolve(self, batch: List[_Request],
                 owed: Dict[Tuple[str, str], int],
                 fifo: Dict[Tuple[str, str], List[_Request]]) -> None:
        """On-loop resolution phase: launch-free delivery + FIFO split.

        Every group already absorbed its words into the service outboxes
        during the launch phase (``deliver=False``), so this second
        ``farm.flush()`` performs no kernel launch — it only drains
        outboxes (cheap, safe on the loop thread) and its content/order
        is identical to a ``deliver=True`` flush.
        """
        out = self.farm.flush()
        now = self.clock.now()
        self.flushes += 1
        for core, per_client in out.items():
            for client, words in per_client.items():
                head = owed.get((core, client), 0)
                if head:
                    self.farm.services[core].park(client, words[:head])
                pos = head
                for r in fifo.pop((core, client), ()):
                    r.future.set_result(words[pos:pos + r.n_words])
                    pos += r.n_words
                    self.served_words += r.n_words
                    self._miss_ms.append(
                        max(0.0, now - r.deadline) * 1e3)
                if pos != len(words):
                    raise AssertionError(
                        f"flush word accounting broken for "
                        f"{core}/{client}: {len(words)} words, "
                        f"consumed {pos}")
        if fifo:
            raise AssertionError(
                f"flush served no words for queued requests: "
                f"{sorted(fifo)}")

    async def _launch(self, slo_by_core: Dict[str, str]) -> None:
        """The launch phase of one flush (executor when ``offload``)."""
        launch = functools.partial(
            _on_device, self._cuda_index,
            functools.partial(self.farm.flush, deliver=False,
                              slo_by_core=slo_by_core))
        if self._offload:
            # The loop stays live here: submits, cancellations,
            # draw_sync ingress, and deadline tracking all proceed
            # while the launch runs on the worker thread.
            await self._loop.run_in_executor(self._executor, launch)
        else:
            launch()

    async def _launch_with_retries(self, batch: List[_Request],
                                   fifo: Dict[Tuple[str, str],
                                              List[_Request]],
                                   slo_by_core: Dict[str, str]) -> None:
        """Launch the committed batch, supervised (``health=``).

        A failed launch never reached ``absorb()`` for the failed group:
        its demand is still parked at the same absolute stream rows, so a
        retry (after capped exponential backoff through the injected
        clock — FakeClock-drivable, zero real sleeps) serves words
        bit-identical to a never-failed flush.  Groups that absorbed
        before the failure have zero remaining demand and are skipped by
        the retry's ``prepare_rows`` — never launched twice.  A core
        whose consecutive failures trip the breaker is quarantined
        mid-cycle: its batch requests fail with ``CoreQuarantined``, the
        gang re-plans without it, and the remaining batch retries with a
        fresh budget.  Without ``health=`` the first failure propagates
        (the pre-supervision behavior).
        """
        health = self.health
        attempt = 0
        while True:
            try:
                await self._launch(slo_by_core)
            # the supervision seam: ANY launch failure is retried and
            # attributed here; without health= it reraises unchanged
            except Exception as e:
                if health is None:
                    raise
                failed = sorted(set(getattr(e, "cores", ()))
                                or {r.core for r in batch})
                tripped = health.note_launch_failure(failed)
                if tripped:
                    for core in tripped:
                        self._quarantine(
                            core,
                            reason=(f"circuit breaker: "
                                    f"{health.breaker_threshold} consecutive "
                                    f"launch failures ({e})"),
                            batch=batch, fifo=fifo)
                    if not batch:
                        return
                    attempt = 0   # topology changed: fresh retry budget
                    continue      # relaunch now — the group re-plans
                attempt += 1
                if attempt > health.max_retries_per_flush:
                    raise
                health.stats["retries"] += 1
                # private event: only the timeout (fake or real time
                # advancing past the backoff) wakes this, never _wake
                await self.clock.wait(asyncio.Event(),
                                      health.backoff_ms(attempt) / 1e3)
            else:
                if health is not None and batch:
                    health.note_launch_success({r.core for r in batch})
                return

    def _quarantine(self, core: str, *, reason: str,
                    batch: Optional[List[_Request]] = None,
                    fifo: Optional[Dict[Tuple[str, str],
                                        List[_Request]]] = None) -> None:
        """Quarantine ``core`` (journaled), rotate its standby in when one
        exists, fail affected tenants with ``CoreQuarantined``, and shrink
        the admission ceiling by the lost capacity.

        Synchronous and loop-thread only (called under the single-flight
        lock): farm mutation never interleaves with a launch.
        """
        changed = self.farm.quarantine(core, reason=reason)
        if changed and self.journal is not None:
            self.journal.record_quarantine(core, reason=reason)
        rotated = False
        if self.farm.has_standby(core):
            self.farm.rotate(core)
            rotated = True
            if self.journal is not None:
                self.journal.record_rotation(core)
        err = CoreQuarantined(
            f"core {core!r} quarantined: {reason}"
            + (" — standby rotated into the slot; resubmit" if rotated
               else " — no standby; resubmit on another core"),
            core=core, reason=reason, rotated=rotated)
        if batch is not None:
            keep = []
            for r in batch:
                if r.core == core:
                    if not r.future.done():
                        r.future.set_exception(err)
                else:
                    keep.append(r)
            batch[:] = keep
        if fifo is not None:
            for k in [k for k in fifo if k[0] == core]:
                del fifo[k]
        if not rotated:
            # no standby: queued-but-uncommitted requests on this core can
            # never be served either — fail them now instead of hanging
            self._ingest()
            keep = []
            for r in self._queue:
                if r.core != core:
                    keep.append(r)
                    continue
                self._release(r)
                f = r.future
                if isinstance(f, concurrent.futures.Future):
                    if f.set_running_or_notify_cancel():
                        f.set_exception(err)
                elif not f.done():
                    f.set_exception(err)
            self._queue = keep
        if self.admission is not None:
            total = len(self.farm.services)
            healthy = total - len(self.farm.quarantined)
            self.admission.set_capacity_factor(
                healthy / total if total else 1.0)

    async def _evaluate_quality(self) -> None:
        """Run the online NIST gate over full sample windows (on the
        executor under ``offload`` — the p-value math never blocks the
        loop) and quarantine any core the monitor condemns."""
        if self.health is None:
            return
        if self._offload:
            verdicts = await self._loop.run_in_executor(
                self._executor, self.health.evaluate)
        else:
            verdicts = self.health.evaluate()
        for core, v in verdicts.items():
            if core not in self.farm.quarantined:
                self._quarantine(core, reason=str(v["reason"]))

    async def _flush_cycle(self) -> None:
        """ONE coalesced flush: commit (on-loop) -> launch (executor when
        ``offload``) -> deliver + resolve (on-loop), under the
        single-flight lock so two flushes never interleave ``absorb()``
        against one farm."""
        assert self._flush_lock is not None
        async with self._flush_lock:
            committed = self._commit()
            if committed is None:
                return
            batch, owed, fifo, slo_by_core = committed
            self._inflight = True
            try:
                await self._launch_with_retries(batch, fifo, slo_by_core)
                if batch:
                    self._resolve(batch, owed, fifo)
                    if self.journal is not None:
                        # durability ordering: the fsync'd flush record
                        # exists before the next commit can run
                        self.journal.record_flush(self.farm)
                if (self.admission is not None
                        and self.admission.adaptive is not None):
                    # feed the adaptive ceiling one (stage seconds, rows)
                    # observation so the queued-rows cap tracks measured
                    # flush throughput (no-op without farm profile=True)
                    self.admission.adaptive.update_from(
                        self.farm, sum(r.rows_est for r in batch))
                await self._evaluate_quality()
            except asyncio.CancelledError:
                # aclose() mid-launch: the executor finishes the launch
                # (aclose waits), and its words are parked in the service
                # outboxes — lossless.  These futures just never resolve
                # here; fail them so nobody blocks forever.
                for r in batch:
                    f = r.future
                    if f.done():
                        continue
                    if isinstance(f, concurrent.futures.Future):
                        f.set_exception(
                            RuntimeError("front-end closed mid-flush; "
                                         "words parked on the sync surface"))
                    else:
                        f.cancel()
                raise
            except Exception as e:
                # Fail loudly, never hang: every batched future still
                # pending carries the error — including when the
                # accounting backstops above fire after some futures
                # already resolved.
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                raise
            finally:
                self._inflight = False
                self._wake.set()     # re-check work queued mid-launch

    async def _run(self) -> None:
        while True:
            self._wake.clear()
            self._ingest()
            if self._due():
                try:
                    await self._flush_cycle()
                except Exception as e:     # noqa: BLE001 - kept, not lost
                    self.flush_errors.append(e)
                continue
            if not self._inflight:         # a flush_now() launch may be live
                for w in self._drain_waiters:
                    if not w.done():
                        w.set_result(None)
                self._drain_waiters.clear()
            nxt = self._earliest_deadline()
            timeout = None if nxt is None else max(0.0, nxt - self.clock.now())
            await self.clock.wait(self._wake, timeout)

    # -- resumability --------------------------------------------------------

    async def snapshot(self) -> Dict[str, object]:
        """Quiesce + snapshot: farm state with still-queued front-end
        demand folded into the per-client ``pending`` counts.

        Waits out any launch in flight (single-flight lock), so the farm
        state is never captured mid-mutation; the ingress is drained
        first so requests already submitted by sync threads are captured
        too.  Restoring the result on ANY farm/front-end replays the
        in-flight draws through the next sync ``flush()``, while this
        front-end still serves its own futures afterwards.
        """
        if self._flush_lock is None:          # not started: nothing in flight
            return self._snapshot_now()
        async with self._flush_lock:
            return self._snapshot_now()

    def _snapshot_now(self) -> Dict[str, object]:
        self._ingest()
        snap = self.farm.snapshot()
        for r in self._queue:
            if r.future.cancelled():
                continue
            cl = snap["cores"][r.core]["clients"][r.client]
            cl["pending"] = int(cl.get("pending", 0)) + r.n_words
        return snap

    def restore(self, snap: Dict[str, object]) -> None:
        """Restore a snapshot; requires a quiesced front-end (no queued
        futures or in-flight launch — they would double-count against the
        snapshot's merged pending demand)."""
        if self._inflight:
            raise RuntimeError(
                "a flush launch is in flight; await drain() before "
                "restore()")
        self._ingest()
        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} in-flight request(s); drain or cancel "
                f"them before restore()")
        self.farm.restore(snap)
