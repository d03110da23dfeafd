"""Supervised workers: crash -> account -> restart within a budget (the
port of ``kwok_tpu.resilience.watchdog``).

``Watchdog.spawn`` runs a worker target inside a supervision loop on ONE
``spawn_worker`` thread: an ``Exception`` escaping the target is caught,
accounted (``kwok_worker_crashes_total`` and
``kwok_worker_restarts_total{thread=}``), paced by ``RESTART_PACING``,
and the target runs again on the same thread against the same queues.
``Watchdog.charge`` accounts a restart made elsewhere against the same
budget: the process-lane supervisor (``engine/proclanes.py``) charges
every lane-process respawn here.

The restart budget bounds crash loops: more than ``budget`` restarts of
one worker inside ``window`` seconds stops supervision for that worker
and calls ``on_exhausted`` (the engine degrades with reason
``worker_restart_budget``; ``/readyz`` answers 503). In this port the
process-lane router and supervisor run under it; restarts of the
threaded lanes' workers are not supervised yet.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from kwok_tpu_torch.resilience.policy import RetryPolicy
from kwok_tpu_torch.telemetry.errors import worker_crashed, worker_restarted
from kwok_tpu_torch.workers import spawn_worker

logger = logging.getLogger("kwok_tpu_torch.resilience")

# Restart pacing: near-immediate first restart (the queue is backing up),
# backing off if the worker keeps dying.
RESTART_PACING = RetryPolicy(base=0.02, cap=1.0)


class Watchdog:
    """Supervision for a set of named workers."""

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
        # called on the restarted worker's thread after each restart: the
        # engine resyncs its watch streams there, because a crash can eat
        # an in-flight item and only a full list+RESYNC re-delivers it
        self.on_restart = on_restart
        self._wd_lock = threading.Lock()
        # worker name -> monotonic restart stamps inside the window
        self._restarts: dict[str, deque] = {}
        self._total = 0  # restarts made or charged, every worker
        self._closed = False

    def spawn(self, target, *, name: str, args: tuple = ()) -> threading.Thread:
        """Spawn ``target`` under supervision (named and crash-accounted
        by ``workers.spawn_worker``)."""
        return spawn_worker(
            self._supervise, name=name, args=(target, name, args)
        )

    def close(self) -> None:
        """Stop restarting: a crash during shutdown ends its worker."""
        self._closed = True

    def charge(self, name: str) -> bool:
        """Account one external restart of ``name`` against the SAME
        budget window in-thread supervision uses; returns whether the
        restart is allowed (never after ``close``)."""
        if self._closed:
            return False
        return self._allow(name, time.monotonic())

    def _supervise(self, target, name: str, args: tuple) -> None:
        pacing = RESTART_PACING.session()
        while True:
            t0 = time.monotonic()
            try:
                target(*args)
                return  # clean exit (sentinel consumed / engine stopping)
            except Exception:
                crashed_at = time.monotonic()
                if crashed_at - t0 > self.window:
                    pacing.reset()  # a long healthy run resets the pacing
                if self._closed or not self._allow(name, crashed_at):
                    logger.error(
                        "worker %s exceeded its restart budget (%d/%.0fs); "
                        "giving up", name, self.budget, self.window,
                    )
                    if self.on_exhausted is not None and not self._closed:
                        self.on_exhausted(name)
                    # the final crash is accounted by spawn_worker's own
                    # wrapper (counter + excepthook) as it re-raises
                    raise
                worker_crashed(name)
                delay = pacing.next_delay() or 0.0
                logger.warning(
                    "worker %s crashed; restarting in %.3fs", name, delay,
                    exc_info=True,
                )
                worker_restarted(name)
                if delay:
                    time.sleep(delay)
                if self.on_restart is not None:
                    try:
                        self.on_restart(name)
                    except Exception:
                        logger.exception(
                            "worker %s: restart callback failed", name
                        )

    def _allow(self, name: str, now: float) -> bool:
        with self._wd_lock:
            stamps = self._restarts.setdefault(name, deque())
            while stamps and now - stamps[0] > self.window:
                stamps.popleft()
            if len(stamps) >= self.budget:
                return False
            stamps.append(now)
            self._total += 1
            return True

    def restarts_total(self) -> int:
        """Restarts made or charged so far, every worker together."""
        with self._wd_lock:
            return self._total
