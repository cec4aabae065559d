"""Deterministic fault injection for the serving tier (chaos harness;
port of ``repro/serve/faults.py``, pure Python over numpy).

The paper's framework ships a validation testbench with every generated
core because a chaotic oscillator that drifts off its attractor silently
emits garbage; the serving-tier analogue is that a farm must be *driven*
through launch failures and quality collapses in tests, not just proven
correct on the happy path.  ``FaultPlan`` does the driving: a seeded,
replayable schedule of injected faults that hooks the farm's launch seam
(``OscillatorFarm(faults=...)``) and its quality-monitoring seam
(``attach_monitor``):

* **transient launch failures** — each group launch fails with
  probability ``transient_rate`` (seeded RNG, so a plan replays the
  identical schedule), raising a typed :class:`InjectedFault` carrying
  the affected core names *before* any kernel work or ``absorb()``
  bookkeeping runs.  A retried flush therefore re-launches the failed
  group at the same absolute stream rows — bit-identity is preserved by
  construction;
* **persistent launch failures** — cores in ``persistent_cores`` fail
  every launch until quarantined (the circuit-breaker drill);
* **poisoned quality** — cores in ``poison`` have the words *sampled
  for the health monitor* corrupted (low half of every word zeroed, a
  catastrophic monobit failure), modeling an attractor-drift quality
  collapse at the monitoring seam while delivery stays deterministic.
  Poisoning is bound to the physical service active when monitoring
  attached (``bind``): a standby rotated into the slot samples clean;
* **flush delays** — ``delay_flush_s`` advances an injected
  ``FakeClock`` at every flush, so duration-dependent accounting
  (adaptive ceilings, profile timers) is testable with zero real
  sleeps.  No-op under a real clock.

Everything is pure bookkeeping on the caller's thread; a ``FaultPlan``
never sleeps and never reads wall time, so the whole chaos suite runs
under a ``FakeClock``.  ``active`` arms the
plan: benchmarks measure before/during/after a storm by toggling it.
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

# low 16 bits of every sampled word zeroed: the monitor's monobit gate
# sees ~25% ones — a p-value far below ALPHA_HARD within one window
_POISON_MASK = np.uint32(0xFFFF0000)


class InjectedFault(RuntimeError):
    """A launch failed by plan.  ``cores`` names the affected group
    members (the supervision layer attributes the failure with it);
    ``persistent`` distinguishes the breaker drill from transient noise.
    """

    def __init__(self, message: str, *, cores: Sequence[str] = (),
                 persistent: bool = False):
        super().__init__(message)
        self.cores = tuple(cores)
        self.persistent = bool(persistent)


class FaultPlan:
    """A seeded, replayable fault schedule (see module docstring).

    Parameters
    ----------
    seed
        Seeds the transient-failure schedule; two plans with the same
        seed inject the identical fault sequence for the identical
        launch sequence.
    transient_rate
        Probability each group launch fails transiently (0 disables).
    transient_cores
        Restrict transient failures to launches containing one of these
        cores (``None`` = any launch is eligible).
    max_transients
        Cap on injected transient failures (``None`` = unbounded).
    persistent_cores
        Cores whose every launch fails until the farm quarantines them.
    poison
        Cores whose *monitor samples* are corrupted (delivered words are
        untouched — see module docstring).
    delay_flush_s
        Advance the bound ``FakeClock`` by this much at each flush.
    """

    def __init__(self, *, seed: int = 0, transient_rate: float = 0.0,
                 transient_cores: Optional[Iterable[str]] = None,
                 max_transients: Optional[int] = None,
                 persistent_cores: Iterable[str] = (),
                 poison: Iterable[str] = (),
                 delay_flush_s: float = 0.0,
                 clock=None):
        if not 0.0 <= float(transient_rate) <= 1.0:
            raise ValueError(
                f"transient_rate must be in [0, 1], got {transient_rate}")
        self._rng = random.Random(seed)
        self.transient_rate = float(transient_rate)
        self.transient_cores = (None if transient_cores is None
                                else frozenset(transient_cores))
        self.max_transients = (None if max_transients is None
                               else int(max_transients))
        self.persistent_cores = set(persistent_cores)
        self.poison = frozenset(poison)
        self.delay_flush_s = float(delay_flush_s)
        self.clock = clock
        self.active = True
        self._poisoned_id: Dict[str, int] = {}
        self.injected = {"transient": 0, "persistent": 0,
                         "corrupted_samples": 0, "delays": 0}

    # -- arming --------------------------------------------------------------

    def arm(self) -> None:
        self.active = True

    def disarm(self) -> None:
        self.active = False

    # -- launch seam ---------------------------------------------------------

    def on_launch(self, cores: Sequence[str]) -> None:
        """Called by the farm before each group/solo launch does any
        work; raises :class:`InjectedFault` when the plan says so."""
        if not self.active:
            return
        bad = sorted(self.persistent_cores.intersection(cores))
        if bad:
            self.injected["persistent"] += 1
            raise InjectedFault(
                f"injected persistent launch failure on {bad}",
                cores=bad, persistent=True)
        if self.transient_rate <= 0.0:
            return
        if (self.transient_cores is not None
                and not self.transient_cores.intersection(cores)):
            return
        if (self.max_transients is not None
                and self.injected["transient"] >= self.max_transients):
            return
        # one seeded draw per launch, whether or not it fails: the
        # schedule depends only on the launch sequence, not on outcomes
        if self._rng.random() < self.transient_rate:
            self.injected["transient"] += 1
            raise InjectedFault(
                f"injected transient launch failure on {sorted(cores)}",
                cores=sorted(cores), persistent=False)

    # -- flush seam ----------------------------------------------------------

    def on_flush(self) -> None:
        """Advance the bound FakeClock by ``delay_flush_s`` (no-op under
        a real clock — duration injection there is the caller's job)."""
        if (self.active and self.delay_flush_s > 0.0
                and self.clock is not None
                and hasattr(self.clock, "advance")):
            self.clock.advance(self.delay_flush_s)
            self.injected["delays"] += 1

    # -- quality seam --------------------------------------------------------

    def bind(self, core: str, service) -> None:
        """Pin poisoning to the physical service active when monitoring
        attached: the FIRST service bound to a poisoned core name is the
        bad one, and a standby rotated into the slot samples clean."""
        if core in self.poison and core not in self._poisoned_id:
            self._poisoned_id[core] = id(service)

    def corrupt_sample(self, core: str, service,
                       words: np.ndarray) -> np.ndarray:
        """Corrupt a monitor sample iff ``service`` is the poisoned
        physical core for ``core``.  Delivered words are never touched —
        only what the health monitor sees."""
        if not self.active or self._poisoned_id.get(core) != id(service):
            return words
        self.injected["corrupted_samples"] += 1
        return np.asarray(words, np.uint32) & _POISON_MASK

    def heal(self, core: str) -> None:
        """Drop all faults targeting ``core`` (storm-recovery phases)."""
        self.persistent_cores.discard(core)
        self._poisoned_id.pop(core, None)
