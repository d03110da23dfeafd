"""Process-wide error accounting: swallowed exceptions + worker crashes.

A broad handler must not just ``pass``: a swallow must either log or bump
``kwok_swallowed_errors_total{site=...}`` here. The sites live in modules
with no engine handle (HTTP-client teardown, watch-stream cleanup, the
mock server's audit ring), so the counters ride a process-global registry
that the HTTP server appends to every ``/metrics`` render — the same way
it appends the process CPU collector.

Reading the series: most sites only move during shutdown (connection
teardown racing reader threads). A series climbing during steady state is
a bug report with the site name attached.
"""

from __future__ import annotations

import logging

from kwok_tpu_torch.telemetry.registry import MetricsRegistry

logger = logging.getLogger("kwok_tpu_torch.errors")

PROCESS_REGISTRY = MetricsRegistry()

_swallowed = PROCESS_REGISTRY.counter(
    "kwok_swallowed_errors_total",
    "Deliberately swallowed exceptions by site (shutdown races, "
    "best-effort cleanup); climbing outside shutdown means a bug",
    ("site",),
)
_crashes = PROCESS_REGISTRY.counter(
    "kwok_worker_crashes_total",
    "Uncaught exceptions that killed a spawned worker thread",
    ("thread",),
)
_restarts = PROCESS_REGISTRY.counter(
    "kwok_worker_restarts_total",
    "Crashed workers restarted by the resilience watchdog (within its "
    "restart budget); a crash WITHOUT a matching restart means the "
    "budget ran out and the engine went degraded",
    ("thread",),
)
_wire_rejects = PROCESS_REGISTRY.counter(
    "kwok_wire_rejects_total",
    "Corrupt or regressed wire input quarantined instead of applied: "
    "unparseable watch lines (reason=unparseable -> integrity resync), "
    "undecodable HTTP response bodies (http_body), watch-stream lines "
    "the client rejected mid-iteration (watch_line), and MODIFIED "
    "events whose resourceVersion regressed below the row's last "
    "ingested revision (stale_rv — routine after reconnect replays, "
    "hostile under wire.dup/wire.stale)",
    ("reason",),
)


def swallowed(site: str) -> None:
    """Record a deliberately swallowed exception. Call from inside an
    ``except`` block: the active exception lands in the debug log with a
    traceback, and the site's counter moves so /metrics shows it."""
    _swallowed.labels(site=site).inc()
    logger.debug("swallowed error at %s", site, exc_info=True)


def worker_crashed(thread_name: str) -> None:
    """Account an uncaught exception escaping a spawn_worker thread."""
    _crashes.labels(thread=thread_name).inc()


def worker_restarted(thread_name: str) -> None:
    """Account a watchdog restart of a crashed worker (a thread, or a
    lane process respawned by the process-lane supervisor)."""
    _restarts.labels(thread=thread_name).inc()


def worker_restarts_total(thread_name: str) -> float:
    """One worker's restart counter (the chaos phase and tests)."""
    return _restarts.labels(thread=thread_name).value


def worker_crash_ledger() -> dict:
    """Every worker's (crashes, restarts) pair: a crash without a
    matching restart means a worker died for good outside the
    watchdog's care."""
    out: dict = {}
    for (thread,), c in _crashes.children():
        out[thread] = [c.value, 0]
    for (thread,), c in _restarts.children():
        out.setdefault(thread, [0, 0])[1] = c.value
    return {k: tuple(v) for k, v in out.items()}


def wire_reject(reason: str, n: int = 1) -> None:
    """Account one quarantined corrupt/regressed wire record."""
    _wire_rejects.labels(reason=reason).inc(n)


def wire_rejects_total(reason: "str | None" = None) -> float:
    """kwok_wire_rejects_total{reason=} so far in this process; with no
    reason, the sum over every reason."""
    if reason is not None:
        return _wire_rejects.labels(reason=reason).value
    return sum(c.value for _values, c in _wire_rejects.children())


def render_nonempty() -> str:
    """Exposition text of the process registry, or "" when no counter has
    moved yet (labeled families with no children render no series)."""
    text = PROCESS_REGISTRY.render()
    return "" if not text.strip() else text
