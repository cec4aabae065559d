"""Core health (port of ``repro/serve/health.py``, the exception only).

``HealthMonitor`` (retry policy, circuit breaker, online NIST windows) is
the serving tier, ROADMAP.md queue 1, 'Serving tier'; the farm's ``quarantine`` /
``rotate`` raise and handle ``CoreQuarantined`` without it.
"""
from __future__ import annotations


class CoreQuarantined(RuntimeError):
    """A core was quarantined (circuit breaker or quality gate).

    Raised to tenants whose requests can no longer be served by the
    quarantined physical core: queued requests when no standby exists,
    and new submits to an unrotated quarantined core.  ``rotated`` tells
    the tenant whether a standby already took over the routing slot
    (retry immediately) or the core is simply gone (back off / resubmit
    elsewhere).
    """

    def __init__(self, message: str, *, core: str, reason: str = "",
                 rotated: bool = False):
        super().__init__(message)
        self.core = core
        self.reason = reason
        self.rotated = bool(rotated)
