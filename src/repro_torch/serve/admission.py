"""Admission control for the serving tier: rate limits + backpressure
(port of ``repro/serve/admission.py``, pure Python over the injected clock).

Without policy, the async front-end's queue grows without bound the moment
aggregate tenant demand outruns the farm's flush rate — every queued
request makes the *next* flush bigger and slower, which makes the queue
grow faster (the classic congestion-collapse spiral).  This module is the
policy layer the front-end consults **before** a request ever enters its
queue:

* **per-tenant token buckets** — each (core, client) pair refills at
  ``rate_words_per_s`` with a burst allowance of ``burst_words``; a draw
  that would overdraw the bucket is rejected with the time at which the
  bucket will next cover it;
* **a farm-wide queued-rows ceiling** — a thread-safe gauge of launch
  rows currently queued in the front-end (each admitted request adds its
  own row estimate, released when the request leaves the queue: flushed,
  cancelled, or pruned).  When the gauge would exceed
  ``max_queued_rows``, further submits are rejected until flushes drain
  the backlog.

Rejections raise :class:`Overloaded` — a *typed* fail-fast error carrying
a ``retry_after_ms`` hint — instead of silently queueing work that cannot
meet any deadline.  In-flight (already admitted) requests are never
affected: the controller only gates entry.

Every time read comes from an injectable ``Clock`` (the same seam as the
rest of the serving stack), so the whole policy is testable under a
manual-advance ``FakeClock`` with zero real sleeps.  The gauge and buckets take an internal lock:
``admit`` is safe from any thread, matching ``draw_sync``'s cross-thread
ingress.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

from repro_torch.serve.clock import Clock, SystemClock

# Clamp on every Overloaded.retry_after_ms hint.  The floor kills two
# stampede bugs: a sub-millisecond drain time rounds to a 0 ms hint
# (every rejected client retries immediately, in lockstep), and the
# never-admissible path used to leak float("inf") — a client honoring
# the hint literally would back off forever instead of resizing the
# request.  The cap keeps the hint a *retry* hint, not a farewell.
RETRY_FLOOR_MS = 1.0
RETRY_CAP_MS = 60_000.0


class AdaptiveCeiling:
    """Derives the farm-wide queued-rows ceiling from serving throughput
    instead of a hand-set constant.

    The ceiling answers "how many launch rows may queue before new work
    cannot meet any deadline?" — which is throughput times tolerable
    delay:

        ceiling = rows_per_second * target_delay_ms / 1e3

    clamped to [min_rows, max_rows].  ``rows_per_second`` comes from two
    sources, best first:

    * **observed** — a rolling window of the last ``window`` flushes'
      (stage seconds, rows) deltas, fed by ``update_from(farm, rows)``
      reading the farm's ``profile_stats`` stage timers (plan + stack +
      launch + absorb; the farm must be built with ``profile=True``);
    * **modeled** — a cold-start prior from a fitted ``GangCostModel``
      (``cost_model`` + ``candidate``): the modeled seconds of one
      nominal t_block/2-row launch.

    With neither signal the ceiling is ``max_rows`` (no information, so
    do not reject).  Attach via
    ``AdmissionController(adaptive=AdaptiveCeiling(...))`` — rejections
    keep the typed ``Overloaded(retry_after_ms)`` contract, with the
    retry hint upgraded to the modeled time for the backlog to drain.
    """

    _STAGES = ("plan", "stack", "launch", "absorb")

    def __init__(self, *, target_delay_ms: float = 50.0, window: int = 32,
                 min_rows: int = 64, max_rows: int = 1 << 20,
                 cost_model=None, candidate=None,
                 rows_per_launch: Optional[int] = None):
        if target_delay_ms <= 0:
            raise ValueError(
                f"target_delay_ms must be > 0, got {target_delay_ms}")
        self.target_delay_ms = float(target_delay_ms)
        self.window = int(window)
        self.min_rows = int(min_rows)
        self.max_rows = int(max_rows)
        self.cost_model = cost_model
        self.candidate = candidate
        self.rows_per_launch = (None if rows_per_launch is None
                                else max(1, int(rows_per_launch)))
        self._obs: collections.deque = collections.deque(maxlen=self.window)
        self._last_stage_s: Optional[float] = None
        self.updates = 0

    def prior_rows_per_s(self) -> Optional[float]:
        """Cold-start throughput prior from the fitted cost model (None
        without a model fitted to wall time, i.e. ``sec_per_cycle``).

        The modeled launch is shaped like the *plan's* launch: ``q`` is
        the gang plan's actual rows-per-launch when the caller supplied
        it (``rows_per_launch``), else one nominal t_block/2-row block.
        The candidate's dims carry the per-row cost, so a lattice core
        (i_dim = n_nodes x base dim, plus the coupling term) models
        n_nodes-fold slower rows instead of inheriting a scalar core's
        prior and over-admitting on cold start."""
        m, c = self.cost_model, self.candidate
        if m is None or c is None or getattr(m, "sec_per_cycle", None) is None:
            return None
        q = self.rows_per_launch or max(1, c.t_block // 2)
        sec = m.seconds(m.launch_cycles(c, [q]))
        return q / sec if sec and sec > 0 else None

    def observe(self, seconds: float, rows: int) -> None:
        """Record one flush: ``rows`` launch rows served in ``seconds``
        of flush stage time."""
        if seconds > 0 and rows > 0:
            self._obs.append((float(seconds), int(rows)))
            self.updates += 1

    def update_from(self, farm, rows_flushed: int) -> None:
        """Feed one completed flush from the farm's ``profile_stats``
        stage timers (no-op on farms built without ``profile=True``)."""
        stats = farm.profile_stats
        if stats is None:
            return
        total = sum(stats.get(k, 0.0) for k in self._STAGES)
        if self._last_stage_s is not None:
            self.observe(total - self._last_stage_s, rows_flushed)
        self._last_stage_s = total

    def rows_per_s(self) -> Optional[float]:
        """Observed rolling-window throughput, else the model prior."""
        if self._obs:
            sec = sum(s for s, _ in self._obs)
            rows = sum(r for _, r in self._obs)
            if sec > 0:
                return rows / sec
        return self.prior_rows_per_s()

    def ceiling(self) -> int:
        """The current queued-rows ceiling."""
        rps = self.rows_per_s()
        if rps is None:
            return self.max_rows
        return int(min(self.max_rows,
                       max(self.min_rows,
                           rps * self.target_delay_ms / 1e3)))


class Overloaded(RuntimeError):
    """A submit was rejected by admission control (fail fast, retry later).

    ``retry_after_ms`` is the caller's backoff hint: for a tenant-rate
    rejection it is the time until the token bucket covers the request;
    for a farm-ceiling rejection it is the controller's configured hint
    (the queue drains on flushes, whose timing the controller cannot
    know).  ``scope`` is ``"tenant"`` or ``"farm"``.  The hint is always
    a positive finite number in ``[RETRY_FLOOR_MS, RETRY_CAP_MS]``: a
    0 ms hint synchronizes every rejected client into a retry stampede,
    and an infinite one (the never-admissible oversized path) tells a
    literal-minded client to wait forever — both clamp.
    """

    def __init__(self, message: str, *, retry_after_ms: float, scope: str,
                 core: Optional[str] = None, client: Optional[str] = None):
        super().__init__(message)
        retry = float(retry_after_ms)
        if not math.isfinite(retry):
            retry = RETRY_CAP_MS
        self.retry_after_ms = min(RETRY_CAP_MS, max(RETRY_FLOOR_MS, retry))
        self.scope = scope
        self.core = core
        self.client = client


@dataclasses.dataclass
class _Bucket:
    """One tenant's token bucket (tokens are words)."""
    rate: float               # words per second
    burst: float              # bucket capacity, words
    tokens: float             # current fill
    stamp: float              # clock time of the last refill

    def refill(self, now: float) -> None:
        if now > self.stamp:
            self.tokens = min(self.burst, self.tokens
                              + (now - self.stamp) * self.rate)
        self.stamp = now

    def try_take(self, n: float, now: float) -> float:
        """Take ``n`` tokens; returns 0.0 on success, else the seconds
        until the bucket will cover ``n`` (state unchanged on failure)."""
        self.refill(now)
        if n <= self.tokens:
            self.tokens -= n
            return 0.0
        if self.rate <= 0.0 or n > self.burst:
            return float("inf")       # no amount of waiting covers this
        return (n - self.tokens) / self.rate


class AdmissionController:
    """Gates front-end submits: per-tenant rate limits + a farm ceiling.

    Parameters
    ----------
    rate_words_per_s / burst_words
        Default per-tenant token-bucket parameters; ``None`` disables
        tenant rate limiting.  A request larger than ``burst_words`` can
        never be admitted (rejected with an infinite retry hint) — size
        the burst to the largest legitimate draw.
    max_queued_rows
        Farm-wide ceiling on launch rows queued in the front-end;
        ``None`` disables the ceiling.  The gauge counts each admitted
        request's own row estimate (``ceil(n_words / lanes)``) — it is
        deliberately conservative: a request coverable from a client's
        buffer still counts, because admission runs before the farm is
        consulted.
    adaptive
        An :class:`AdaptiveCeiling`; when set it supersedes
        ``max_queued_rows`` — the ceiling tracks measured flush
        throughput (feed it from the front-end via ``update_from``) with
        a fitted-``GangCostModel`` prior before any measurement exists.
    ceiling_retry_ms
        The minimum ``retry_after_ms`` hint attached to farm-ceiling
        rejections (an adaptive ceiling raises it to the modeled
        backlog-drain time).
    per_tenant
        ``{(core, client): (rate_words_per_s, burst_words)}`` overrides
        for specific tenants (e.g. a paid tier).
    """

    def __init__(self, *, rate_words_per_s: Optional[float] = None,
                 burst_words: Optional[float] = None,
                 max_queued_rows: Optional[int] = None,
                 adaptive: Optional[AdaptiveCeiling] = None,
                 ceiling_retry_ms: float = 5.0,
                 per_tenant: Optional[Dict[Tuple[str, str],
                                           Tuple[float, float]]] = None,
                 clock: Optional[Clock] = None):
        if (rate_words_per_s is None) != (burst_words is None):
            raise ValueError("rate_words_per_s and burst_words must be "
                             "set together")
        self.rate_words_per_s = rate_words_per_s
        self.burst_words = burst_words
        self.max_queued_rows = max_queued_rows
        self.adaptive = adaptive
        self.ceiling_retry_ms = float(ceiling_retry_ms)
        self.clock: Clock = clock or SystemClock()
        self._overrides = dict(per_tenant or {})
        self._buckets: Dict[Tuple[str, str], _Bucket] = {}
        self._lock = threading.Lock()
        self._queued_rows = 0
        # Degraded-mode accounting: the supervision layer sets this to
        # (healthy cores / total cores) on quarantine/rotation, shrinking
        # the queued-rows ceiling with the lost capacity.
        self._capacity_factor = 1.0
        self.admitted = 0
        self.rejected_tenant = 0
        self.rejected_farm = 0

    # -- gauge ---------------------------------------------------------------

    @property
    def queued_rows(self) -> int:
        """Launch rows currently admitted into (and not yet released from)
        the front-end queue."""
        return self._queued_rows

    @property
    def capacity_factor(self) -> float:
        """Serving capacity still healthy, in [0, 1] (1.0 = full farm)."""
        return self._capacity_factor

    def set_capacity_factor(self, factor: float) -> None:
        """Scale the queued-rows ceiling by the healthy-capacity fraction
        (the supervision layer calls this on quarantine and rotation —
        a quarantined core's launch throughput is gone, so the backlog
        the farm can drain in bounded delay shrinks with it)."""
        with self._lock:
            self._capacity_factor = min(1.0, max(0.0, float(factor)))

    @property
    def current_ceiling(self) -> Optional[int]:
        """The queued-rows ceiling in force right now: the adaptive
        ceiling when attached, else the static ``max_queued_rows`` —
        either one scaled by the degraded-capacity factor.

        A degraded farm must never quantize to a zero ceiling: a small
        base times a reduced-but-nonzero capacity factor used to round
        to 0 and reject *all* traffic while healthy cores remained.
        Whenever ``capacity_factor > 0`` the scaled ceiling is floored
        at the adaptive ``min_rows`` (one row for a static ceiling),
        never exceeding the undegraded base.  A factor of exactly 0
        (every core quarantined) still means a zero ceiling.

        Lock-free on purpose: ``admit`` reads it while holding the
        controller lock, and ``set_capacity_factor`` publishes a single
        float (atomic under the GIL)."""
        base = (self.adaptive.ceiling() if self.adaptive is not None
                else self.max_queued_rows)
        if base is None:
            return None
        scaled = int(base * self._capacity_factor)
        if self._capacity_factor > 0.0:
            floor = (self.adaptive.min_rows if self.adaptive is not None
                     else 1)
            scaled = max(scaled, min(int(base), floor))
        return scaled

    def release(self, rows: int) -> None:
        """Return ``rows`` to the ceiling gauge (request left the queue:
        committed to a flush, cancelled, or pruned)."""
        with self._lock:
            self._queued_rows = max(0, self._queued_rows - int(rows))

    # -- the gate ------------------------------------------------------------

    def _bucket(self, core: str, client: str,
                now: float) -> Optional[_Bucket]:
        key = (core, client)
        b = self._buckets.get(key)
        if b is None:
            rb = self._overrides.get(key)
            if rb is not None:
                rate, burst = rb
            elif self.rate_words_per_s is not None:
                rate, burst = self.rate_words_per_s, self.burst_words
            else:
                return None
            b = _Bucket(rate=float(rate), burst=float(burst),
                        tokens=float(burst), stamp=now)
            self._buckets[key] = b
        return b

    def admit(self, core: str, client: str, n_words: int,
              rows_est: int) -> None:
        """Admit one request of ``n_words`` (``rows_est`` launch rows) or
        raise :class:`Overloaded`.  On success the ceiling gauge grows by
        ``rows_est``; the caller owes a matching :meth:`release` when the
        request leaves the queue."""
        now = self.clock.now()
        with self._lock:
            ceiling = self.current_ceiling
            if (ceiling is not None
                    and self._queued_rows + rows_est > ceiling):
                self.rejected_farm += 1
                retry_ms = self.ceiling_retry_ms
                if self.adaptive is not None:
                    # upgrade the hint to the modeled time for the excess
                    # backlog to drain at the observed flush rate
                    rps = self.adaptive.rows_per_s()
                    if rps is not None and rps > 0:
                        excess = self._queued_rows + rows_est - ceiling
                        retry_ms = max(retry_ms, excess / rps * 1e3)
                raise Overloaded(
                    f"farm over queued-rows ceiling: "
                    f"{self._queued_rows} + {rows_est} > "
                    f"{ceiling} rows queued",
                    retry_after_ms=retry_ms, scope="farm",
                    core=core, client=client)
            b = self._bucket(core, client, now)
            if b is not None:
                wait_s = b.try_take(float(n_words), now)
                if wait_s > 0.0:
                    self.rejected_tenant += 1
                    raise Overloaded(
                        f"tenant {core}/{client} over rate limit "
                        f"({n_words} words > {b.tokens:.0f} available)",
                        retry_after_ms=wait_s * 1e3, scope="tenant",
                        core=core, client=client)
            self._queued_rows += int(rows_est)
            self.admitted += 1

    def stats(self) -> Dict[str, float]:
        """Admission counters: admitted / rejected by scope + the live
        queued-rows gauge and the ceiling currently in force (-1 when
        uncapped)."""
        ceiling = self.current_ceiling
        return {"admitted": float(self.admitted),
                "rejected_tenant": float(self.rejected_tenant),
                "rejected_farm": float(self.rejected_farm),
                "queued_rows": float(self._queued_rows),
                "ceiling": -1.0 if ceiling is None else float(ceiling),
                "capacity_factor": float(self._capacity_factor)}
