"""Retry pacing and the engine's degraded-mode ledger
(``kwok_tpu.resilience.policy``'s ``RetryPolicy`` and ``Degradation``,
on the port's registry).

``RetryPolicy`` is client-go's wait.Backoff with full jitter: attempt
``n`` sleeps ``uniform(0, min(cap, base * factor**n))``, optionally
bounded by a wall-clock deadline. The watchdog paces its restarts with
it, the engine's watch loop its reconnects (``WATCH_RECONNECT``), its
patch executor its retries (``PATCH_RETRY``) and its pump the resend of
frames whose connection died (``PUMP_RESEND``).

Named reasons (``lane2_queue``, ``checkpoint``, ``worker_restart_budget``,
``pump``)
raise the ``kwok_degraded{reason=}`` gauge on the engine's registry and
flip the engine's ``degraded`` property, which ``/readyz`` reflects with
a 503: load balancers and rigs stop sending work to an engine that is
shedding instead of keeping up. Reasons clear when the condition heals.
"""

from __future__ import annotations

import random
import time

from kwok_tpu_torch.locks import reclaimable


class RetryPolicy:
    """Immutable backoff shape; ``session()`` mints independent attempt
    state, so one policy object can serve many concurrent loops."""

    def __init__(
        self,
        base: float = 0.5,
        cap: float = 5.0,
        factor: float = 2.0,
        deadline: "float | None" = None,
        jitter: bool = True,
        rng: "random.Random | None" = None,
    ):
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError("invalid retry policy shape")
        self.base = float(base)
        self.cap = float(cap)
        self.factor = float(factor)
        self.deadline = deadline
        self.jitter = bool(jitter)
        self._rng = rng or random

    def session(self) -> "Backoff":
        return Backoff(self)


class Backoff:
    """Mutable attempt state for one retry loop (one owner, no lock)."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.attempt = 0
        self._started = time.monotonic()

    def reset(self) -> None:
        """A success: the next failure backs off from scratch."""
        self.attempt = 0
        self._started = time.monotonic()

    def next_delay(self) -> "float | None":
        """The next sleep, or None once the policy deadline has passed."""
        p = self.policy
        if p.deadline is not None and (
            time.monotonic() - self._started >= p.deadline
        ):
            return None
        ceiling = min(p.cap, p.base * (p.factor ** self.attempt))
        self.attempt += 1
        if p.jitter:
            return p._rng.uniform(0, ceiling)
        return ceiling

    def sleep(self, delay: float, should_stop=None) -> None:
        """Sleep ``delay`` seconds in short slices so a stopping engine
        is never blocked behind a full backoff window."""
        deadline = time.monotonic() + delay
        while True:
            if should_stop is not None and should_stop():
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.1))


# The watch loop's reconnect: the first retry well under a second (a
# one-off stream hiccup must not idle ingest), converging to a 5 s ceiling
# under a persistent outage.
WATCH_RECONNECT = RetryPolicy(base=0.2, cap=5.0)

# Patch-job transport retries on the executor (connection-shaped errors
# and 429s): enough attempts to ride out an apiserver restart window.
PATCH_RETRY = RetryPolicy(base=0.1, cap=1.0, deadline=8.0)

# Whole-frame resend of a pump batch's requests whose connection died
# (status 0): short steps, and a deadline after which the target counts
# as down (degradation reason "pump": the batch is shed, not retried per
# object).
PUMP_RESEND = RetryPolicy(base=0.05, cap=0.5, deadline=5.0)

_DEGRADED_HELP = (
    "Degraded-mode reasons currently active (1 = degraded): queue "
    "shedding, exhausted worker restart budgets, a downed pump; "
    "/readyz answers 503 while any reason is set"
)


class Degradation:
    """Per-engine degraded-mode ledger over the engine's own registry.
    ``on_set(reason)`` runs on every FRESH set, outside the ledger lock
    (the engine saves the apiserver's flight recorder there); a hook
    that raises is counted and never breaks the transition."""

    def __init__(self, registry, on_set=None) -> None:
        self._fam = registry.gauge(
            "kwok_degraded", _DEGRADED_HELP, ("reason",)
        )
        self._deg_lock = reclaimable()
        self._reasons: set[str] = set()
        self._on_set = on_set

    def set(self, reason: str) -> bool:
        """Mark a reason active; returns True when newly set (callers
        log on the edge, not on every recurrence)."""
        with self._deg_lock:
            fresh = reason not in self._reasons
            self._reasons.add(reason)
        self._fam.labels(reason=reason).set(1)
        if fresh and self._on_set is not None:
            try:
                self._on_set(reason)
            except Exception:
                from kwok_tpu_torch.telemetry.errors import swallowed

                swallowed("policy.degradation_on_set")
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
