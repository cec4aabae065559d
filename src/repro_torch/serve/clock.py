"""The injectable clocks of the serving tier: a re-export of
``repro_torch.clock`` (as ``repro/serve/clock.py`` re-exports
``repro.clock``), so ``isinstance`` checks and ``is`` comparisons hold
across the two import paths."""
from repro_torch.clock import Clock, FakeClock, SystemClock

__all__ = ["Clock", "FakeClock", "SystemClock"]
