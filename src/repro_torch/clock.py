"""Injectable clocks (port of ``repro/clock.py``, copied: the port imports
nothing of the JAX package).

Every time read of the port's serving code goes through a ``Clock``: the
farm's profile timers read ``now()``, so tests can freeze time with
``FakeClock`` and never sleep.  ``SystemClock`` is the production
implementation, ``FakeClock`` a manually-advanced test double whose
``advance()`` also wakes any asyncio waiter parked on it.

``Clock.wait(event, timeout)`` is the one blocking primitive an async
front-end uses: "sleep until ``event`` is set or ``timeout`` seconds of
*this clock's* time pass".  With ``timeout=None`` it waits on the event
alone.  It never raises on timeout; callers re-derive what to do from
``now()``, so waiting logic is identical under either clock.
"""
from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Protocol, runtime_checkable


@runtime_checkable
class Clock(Protocol):
    """Monotonic seconds + an awaitable event-or-timeout wait.

    ``time()`` is the epoch-seconds sibling of ``now()``: monotonic time
    is meaningless across process restarts, so anything that persists
    timestamps (a flush journal) stamps with
    ``time()`` instead.  ``FakeClock`` advances both together, so
    journaled timestamps stay deterministic in tests.
    """

    def now(self) -> float:
        ...

    def time(self) -> float:
        ...

    async def wait(self, event: "asyncio.Event",
                   timeout: Optional[float]) -> None:
        ...


class SystemClock:
    """Real monotonic time; ``wait`` is ``asyncio.wait_for`` on the event."""

    def now(self) -> float:
        return time.perf_counter()

    def time(self) -> float:
        return time.time()

    async def wait(self, event: asyncio.Event,
                   timeout: Optional[float]) -> None:
        try:
            await asyncio.wait_for(asyncio.ensure_future(event.wait()),
                                   timeout)
        except asyncio.TimeoutError:
            pass


class FakeClock:
    """Manual-advance clock: time moves only when the test says so.

    ``advance(dt)`` moves ``now()`` forward and wakes every ``wait()``
    currently parked on this clock, whether or not its timeout has
    expired — the waiter re-checks its own deadline and goes back to
    sleep if it is still in the future.  That makes deadline semantics
    exact: a waiter with 100 ms left wakes (and its caller re-decides)
    at every advance, and returns for good only once fake time actually
    passes the deadline.

    Not thread-safe: ``advance()`` must run on the event-loop thread
    (marshal with ``loop.call_soon_threadsafe`` from elsewhere).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._ticks: List[asyncio.Event] = []

    def now(self) -> float:
        return self._now

    def time(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        self._now += float(dt)
        for tick in self._ticks:
            tick.set()

    async def wait(self, event: asyncio.Event,
                   timeout: Optional[float]) -> None:
        deadline = None if timeout is None else self._now + timeout
        while not event.is_set():
            if deadline is not None and self._now >= deadline:
                return
            tick = asyncio.Event()
            self._ticks.append(tick)
            ev_w = asyncio.ensure_future(event.wait())
            tk_w = asyncio.ensure_future(tick.wait())
            try:
                await asyncio.wait({ev_w, tk_w},
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                self._ticks.remove(tick)
                for w in (ev_w, tk_w):
                    if not w.done():
                        w.cancel()
                await asyncio.gather(ev_w, tk_w, return_exceptions=True)
