"""Supervision for the serving tier: retry policy, breakers, quality
(port of ``repro/serve/health.py``).

The async front-end's flush cycle is the single choke point every served
word passes through; :class:`HealthMonitor` is the policy object wired
into it (``AsyncOscillatorFarm(health=...)``).  Three concerns, one
object:

* **retry/backoff policy**: a transiently failed launch is retried under
  the front-end's single-flight lock with capped exponential backoff plus
  seeded jitter (``backoff_ms``).  A failed launch never reached
  ``absorb()``, so the committed demand is still parked in the services at
  the same absolute stream rows: a successful retry serves words
  bit-identical to a never-failed flush.  The backoff *delay* routes
  through the injected ``Clock`` (``clock.wait`` on a private event), so
  the whole retry schedule is drivable by a ``FakeClock`` with zero real
  sleeps;

* **per-core circuit breaker**: ``note_launch_failure`` counts
  *consecutive* failures per core (attributed via the ``cores`` field of
  the raised error, e.g. :class:`repro_torch.serve.faults.InjectedFault`);
  at ``breaker_threshold`` the core trips and the front-end quarantines
  it: cached gang plans drop, the group re-plans without it, and its
  tenants get a typed :class:`CoreQuarantined`.  ``note_launch_success``
  resets the counters: only consecutive failures trip;

* **online quality windows**: ``ingest`` accumulates words *sampled off
  the delivery path* (the farm's ``attach_monitor`` hook calls it from
  the launch executor thread; it only appends under a lock), and
  ``evaluate``, run on the executor after delivery, gates one full window
  per core through ``repro_torch.prng.quality.online_gate``.  A hard
  failure (p < ALPHA_HARD) quarantines immediately; soft failures need
  ``soft_strikes`` consecutive failing windows.

The monitor holds no farm references: the front-end asks it for verdicts
and performs quarantine/rotation itself.  :class:`CoreQuarantined` is
also raised by the farm's ``quarantine`` / ``rotate`` routing without a
monitor.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.prng.quality import (GATE_ALPHA, ONLINE_WINDOW_WORDS,
                                      online_gate)


class CoreQuarantined(RuntimeError):
    """A core was quarantined (circuit breaker or quality gate).

    Raised to tenants whose requests can no longer be served by the
    quarantined physical core: requests already committed to the failed
    flush, queued requests when no standby exists, and new submits to an
    unrotated quarantined core.  ``rotated`` tells the tenant whether a
    standby already took over the routing slot (retry immediately) or
    the core is simply gone (back off / resubmit elsewhere).
    """

    def __init__(self, message: str, *, core: str, reason: str = "",
                 rotated: bool = False):
        super().__init__(message)
        self.core = core
        self.reason = reason
        self.rotated = bool(rotated)


class HealthMonitor:
    """Retry policy + per-core circuit breaker + online quality windows.

    Parameters
    ----------
    breaker_threshold
        Consecutive launch failures that trip a core's breaker.
    max_retries_per_flush
        Transient-failure retries one flush cycle may spend before the
        error propagates to the batch futures (bounds lock hold time).
    backoff_base_ms / backoff_cap_ms / backoff_jitter
        Retry ``attempt`` (1-based) backs off
        ``min(cap, base * 2**(attempt-1))`` ms, stretched by up to
        ``backoff_jitter`` fraction of seeded jitter (decorrelates
        retry storms across processes; seeded so tests replay exactly).
    window_words / soft_strikes / alpha
        Online gate: words per rolling window, consecutive failing
        windows before a soft quarantine, and the per-test alpha.
    """

    def __init__(self, *, breaker_threshold: int = 3,
                 max_retries_per_flush: int = 4,
                 backoff_base_ms: float = 5.0,
                 backoff_cap_ms: float = 200.0,
                 backoff_jitter: float = 0.25,
                 seed: int = 0,
                 window_words: int = ONLINE_WINDOW_WORDS,
                 soft_strikes: int = 3,
                 alpha: float = GATE_ALPHA):
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if window_words < 256:
            raise ValueError(
                f"window_words must be >= 256 for a meaningful gate, "
                f"got {window_words}")
        self.breaker_threshold = int(breaker_threshold)
        self.max_retries_per_flush = int(max_retries_per_flush)
        self.backoff_base_ms = float(backoff_base_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)
        self.backoff_jitter = float(backoff_jitter)
        self.window_words = int(window_words)
        self.soft_strikes = int(soft_strikes)
        self.alpha = float(alpha)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._fails: Dict[str, int] = {}          # consecutive, per core
        self._samples: Dict[str, List[np.ndarray]] = {}
        self._sample_words: Dict[str, int] = {}
        self._strikes: Dict[str, int] = {}        # consecutive soft fails
        self.last_gate: Dict[str, Dict[str, object]] = {}
        self.stats = {"launch_failures": 0, "retries": 0, "breaker_trips": 0,
                      "windows_evaluated": 0, "windows_failed": 0,
                      "quality_quarantines": 0}

    # -- retry policy --------------------------------------------------------

    def backoff_ms(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based): capped exponential
        plus seeded jitter."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        base = min(self.backoff_cap_ms,
                   self.backoff_base_ms * (2.0 ** (attempt - 1)))
        return base * (1.0 + self.backoff_jitter * self._rng.random())

    # -- circuit breaker -----------------------------------------------------

    def note_launch_failure(self, cores: Iterable[str]) -> List[str]:
        """Record one failed launch against every core in ``cores``;
        returns the cores whose breaker just tripped (consecutive
        failures reached ``breaker_threshold``)."""
        tripped = []
        with self._lock:
            self.stats["launch_failures"] += 1
            for core in cores:
                n = self._fails.get(core, 0) + 1
                self._fails[core] = n
                if n == self.breaker_threshold:
                    tripped.append(core)
                    self.stats["breaker_trips"] += 1
        return tripped

    def note_launch_success(self, cores: Iterable[str]) -> None:
        """A launch served these cores: their failure streaks reset."""
        with self._lock:
            for core in cores:
                self._fails.pop(core, None)

    def consecutive_failures(self, core: str) -> int:
        return self._fails.get(core, 0)

    # -- online quality ------------------------------------------------------

    def ingest(self, core: str, words: np.ndarray) -> None:
        """Append served-word samples for ``core`` (called from the
        farm's sampling hook, possibly on the launch executor thread —
        this only copies a bounded slice under a lock; the NIST math
        happens later, in ``evaluate``)."""
        words = np.asarray(words, np.uint32).reshape(-1)
        if words.size == 0:
            return
        with self._lock:
            have = self._sample_words.get(core, 0)
            room = 2 * self.window_words - have   # bound memory per core
            if room <= 0:
                return
            chunk = words[:room].copy()
            self._samples.setdefault(core, []).append(chunk)
            self._sample_words[core] = have + chunk.size

    def buffered_words(self, core: str) -> int:
        return self._sample_words.get(core, 0)

    def reset(self, core: str) -> None:
        """Forget a core's samples, strikes, and failure streak (called
        on quarantine/rotation so a standby never inherits the bad
        physical core's history)."""
        with self._lock:
            self._samples.pop(core, None)
            self._sample_words.pop(core, None)
            self._strikes.pop(core, None)
            self._fails.pop(core, None)

    def evaluate(self) -> Dict[str, Dict[str, object]]:
        """Gate every core with a full sample window; returns
        ``{core: verdict}`` for cores that must be quarantined NOW.

        Each verdict carries the failing ``gate`` result and a
        human-readable ``reason``.  Runs the NIST math off-lock (the
        window is popped under the lock, evaluated outside it) — call
        from the serving executor, not the event loop.
        """
        windows: Dict[str, np.ndarray] = {}
        with self._lock:
            for core, n in list(self._sample_words.items()):
                if n < self.window_words:
                    continue
                buf = np.concatenate(self._samples.pop(core))
                windows[core] = buf[:self.window_words]
                rest = buf[self.window_words:]
                if rest.size:
                    self._samples[core] = [rest]
                    self._sample_words[core] = int(rest.size)
                else:
                    self._sample_words.pop(core, None)
        out: Dict[str, Dict[str, object]] = {}
        for core, words in windows.items():
            gate = online_gate(words, alpha=self.alpha)
            with self._lock:
                self.stats["windows_evaluated"] += 1
                self.last_gate[core] = gate
                if gate["hard_failed_tests"]:
                    self.stats["windows_failed"] += 1
                    self.stats["quality_quarantines"] += 1
                    self._strikes.pop(core, None)
                    out[core] = {
                        "gate": gate,
                        "reason": (f"online quality hard failure: "
                                   f"{gate['hard_failed_tests']} "
                                   f"p={min(gate['p_values'].values()):.2e}")}
                elif gate["failed_tests"]:
                    self.stats["windows_failed"] += 1
                    s = self._strikes.get(core, 0) + 1
                    self._strikes[core] = s
                    if s >= self.soft_strikes:
                        self.stats["quality_quarantines"] += 1
                        self._strikes.pop(core, None)
                        out[core] = {
                            "gate": gate,
                            "reason": (f"online quality: {s} consecutive "
                                       f"failing windows "
                                       f"({gate['failed_tests']})")}
                else:
                    self._strikes.pop(core, None)
        return out
