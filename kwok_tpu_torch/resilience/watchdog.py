"""Supervised workers: crash -> account -> restart within a budget (the
port of ``kwok_tpu.resilience.watchdog``).

``Watchdog.spawn`` runs a worker target inside a supervision loop on ONE
``spawn_worker`` thread: an ``Exception`` escaping the target, or the
fault plane's ``WorkerKilled`` pill (a ``BaseException``, so a worker
loop's own ``except Exception`` cannot absorb it), is caught, accounted
(``kwok_worker_crashes_total`` and ``kwok_worker_restarts_total{thread=}``),
paced by ``RESTART_PACING``, and the target runs again on the same thread
against the same queues. A second pill that lands during the recovery is
the same crash; ``on_restart`` (the engine's stream resync) is retried up
to 3 times, so a pill there does not skip it. ``restart_log()`` keeps one
record per restart with its crash-to-restart latency.
``Watchdog.charge`` accounts a restart made elsewhere against the same
budget: the process-lane supervisor (``engine/proclanes.py``) charges
every lane-process respawn here.

The restart budget bounds crash loops: more than ``budget`` restarts of
one worker inside ``window`` seconds stops supervision for that worker,
calls ``on_exhausted`` (the engine degrades with reason
``worker_restart_budget``; ``/readyz`` answers 503), and re-raises the
final exception into ``threading.excepthook``. Under it run the threaded
lanes' router, drain and emit workers, every watch thread (a federation
member's included), and the process lanes' router and supervisor.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from kwok_tpu_torch.locks import reclaimable, release_held
from kwok_tpu_torch.resilience.faults import WorkerKilled
from kwok_tpu_torch.resilience.policy import RetryPolicy
from kwok_tpu_torch.telemetry.errors import (
    swallowed,
    worker_crashed,
    worker_restarted,
)
from kwok_tpu_torch.workers import spawn_worker

logger = logging.getLogger("kwok_tpu_torch.resilience")

# Restart pacing: near-immediate first restart (the queue is backing up),
# backing off if the worker keeps dying.
RESTART_PACING = RetryPolicy(base=0.02, cap=1.0)


class Watchdog:
    """Supervision for a set of named worker threads."""

    def __init__(
        self,
        budget: int = 5,
        window: float = 30.0,
        on_exhausted=None,
        on_restart=None,
    ):
        self.budget = int(budget)
        self.window = float(window)
        self.on_exhausted = on_exhausted
        # fired (from the restarted worker's thread) after each restart:
        # the engine resyncs its watch streams here, because a crash can
        # eat an in-flight item (the pill lands mid-apply or mid-get) and
        # only a full list+RESYNC provably reconciles what was lost
        self.on_restart = on_restart
        self._wd_lock = reclaimable()
        # thread name -> monotonic restart stamps inside the window
        self._restarts: dict[str, deque] = {}
        self._log: list[dict] = []  # chaos-artifact surface
        self._closed = False

    # -------------------------------------------------------------- spawn

    def spawn(self, target, *, name: str, args: tuple = ()) -> threading.Thread:
        """Spawn ``target`` under supervision (via workers.spawn_worker,
        so naming/registry/crash accounting are the standard ones)."""
        return spawn_worker(
            self._supervise, name=name, args=(target, name, args)
        )

    def close(self) -> None:
        """Stop restarting: a crash during shutdown ends its worker."""
        self._closed = True

    @property
    def closed(self) -> bool:
        """True after ``close``: an engine started again builds a fresh
        watchdog instead of reusing this one."""
        return self._closed

    def charge(self, name: str) -> bool:
        """Account one external restart of ``name`` against the SAME
        budget window in-thread supervision uses; returns whether the
        restart is allowed. The process-lane supervisor
        (engine/proclanes.py) charges lane-process respawns here — a
        crash-looping process degrades exactly like a crash-looping
        thread, and the respawn joins the restart ledger (marked
        ``proc``) so the chaos artifacts see one unified surface for
        thread restarts, SIGKILL respawns, and stall-kill respawns."""
        if self._closed:
            return False
        allowed = self._allow(name, time.monotonic())
        if allowed:
            with self._wd_lock:
                self._log.append({"thread": name, "proc": True})
        return allowed

    # -------------------------------------------------------- supervision

    def _supervise(self, target, name: str, args: tuple) -> None:
        pacing = RESTART_PACING.session()
        t0 = time.monotonic()
        while True:
            try:
                t0 = time.monotonic()
                target(*args)
                return  # clean exit (sentinel consumed / engine stopping)
            except (Exception, WorkerKilled):
                # WorkerKilled named explicitly: the chaos pill is a
                # BaseException precisely so worker loops' per-item
                # ``except Exception`` guards cannot absorb it — only
                # supervision may
                crashed_at = time.monotonic()
                if crashed_at - t0 > self.window:
                    pacing.reset()  # a long healthy run resets the pacing
                if self._closed or not self._allow(name, crashed_at):
                    logger.error(
                        "worker %s exceeded its restart budget "
                        "(%d/%.0fs); giving up",
                        name, self.budget, self.window,
                    )
                    if self.on_exhausted is not None and not self._closed:
                        self.on_exhausted(name)
                    # the final crash is accounted by spawn_worker's own
                    # wrapper (counter + excepthook) as it re-raises
                    raise
                # recovery absorbs its OWN faults: a second chaos pill
                # async-raised while we sleep/log here must not escape
                # supervision — it is the same crash for budget purposes
                # (already charged by _allow above), so just restart
                try:
                    worker_crashed(name)
                    delay = pacing.next_delay() or 0.0
                    logger.warning(
                        "worker %s crashed; restarting in %.3fs",
                        name, delay, exc_info=True,
                    )
                    worker_restarted(name)
                    if delay:
                        time.sleep(delay)
                except (Exception, WorkerKilled):
                    logger.warning(
                        "worker %s: fault landed mid-recovery; "
                        "restarting anyway", name, exc_info=True,
                    )
                # locks the pill left held (it landed between an acquire
                # and the code that would release it): released here, on
                # the crashed worker's own thread, before anything else
                # waits on them or the worker runs again
                try:
                    release_held()
                except (Exception, WorkerKilled):
                    logger.warning(
                        "worker %s: fault landed in the lock release; "
                        "retrying it", name, exc_info=True,
                    )
                    release_held()
                # on_restart is the DATA-healing half of the restart (the
                # engine resyncs streams here): a pill absorbed above must
                # not skip it — the first crash's eaten item would stay
                # lost forever — so it gets its own bounded retry that
                # absorbs further pills and tries again
                for _ in range(3):
                    try:
                        if self.on_restart is not None:
                            self.on_restart(name)
                        break
                    except (Exception, WorkerKilled):
                        logger.warning(
                            "worker %s: fault landed in on_restart; "
                            "retrying the resync", name, exc_info=True,
                        )
                else:
                    logger.error(
                        "worker %s: on_restart failed 3 times; worker "
                        "restarts without a stream resync", name,
                    )
                try:
                    with self._wd_lock:
                        self._log.append({
                            "thread": name,
                            "restart_latency_s": round(
                                time.monotonic() - crashed_at, 6
                            ),
                        })
                except (Exception, WorkerKilled):
                    # accounting only; the restart must proceed
                    swallowed("watchdog_restart_log")

    def _allow(self, name: str, now: float) -> bool:
        with self._wd_lock:
            stamps = self._restarts.setdefault(name, deque())
            while stamps and now - stamps[0] > self.window:
                stamps.popleft()
            if len(stamps) >= self.budget:
                return False
            stamps.append(now)
            return True

    # ------------------------------------------------------------- reads

    def restart_log(self) -> list[dict]:
        """Per-restart records (thread + crash->restart latency) for the
        chaos artifact."""
        with self._wd_lock:
            return list(self._log)

    def restarts_total(self) -> int:
        with self._wd_lock:
            return len(self._log)
