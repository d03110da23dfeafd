"""The engine's degraded-mode ledger (``kwok_tpu.resilience.policy``'s
``Degradation``, on the port's registry).

Named reasons (``lane2_queue``, ``checkpoint``) raise the
``kwok_degraded{reason=}`` gauge on the engine's registry and flip the
engine's ``degraded`` property, which ``/readyz`` reflects with a 503:
load balancers and rigs stop sending work to an engine that is shedding
instead of keeping up. Reasons clear when the condition heals.
"""

from __future__ import annotations

import threading

_DEGRADED_HELP = (
    "Degraded-mode reasons currently active (1 = degraded): queue "
    "shedding, exhausted worker restart budgets, a downed pump; "
    "/readyz answers 503 while any reason is set"
)


class Degradation:
    """Per-engine degraded-mode ledger over the engine's own registry."""

    def __init__(self, registry) -> None:
        self._fam = registry.gauge(
            "kwok_degraded", _DEGRADED_HELP, ("reason",)
        )
        self._deg_lock = threading.Lock()
        self._reasons: set[str] = set()

    def set(self, reason: str) -> bool:
        """Mark a reason active; returns True when newly set (callers
        log on the edge, not on every recurrence)."""
        with self._deg_lock:
            fresh = reason not in self._reasons
            self._reasons.add(reason)
        self._fam.labels(reason=reason).set(1)
        return fresh

    def clear(self, reason: str) -> bool:
        """Clear a reason; returns True when it was set."""
        with self._deg_lock:
            was = reason in self._reasons
            self._reasons.discard(reason)
        if was:
            self._fam.labels(reason=reason).set(0)
        return was

    @property
    def active(self) -> bool:
        return bool(self._reasons)

    @property
    def reasons(self) -> tuple:
        with self._deg_lock:
            return tuple(sorted(self._reasons))
