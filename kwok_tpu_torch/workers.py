"""Named daemon worker threads with crash accounting.

:func:`spawn_worker` (the HTTP thread of ``kwok/server.py``, and every
worker the watchdog supervises) names the thread, keeps it in a live
registry (:func:`live_workers`, which the fault plane's worker killer
reads) and accounts crashes: an uncaught exception is logged with the
thread's name and bumped into ``kwok_worker_crashes_total{thread=...}``
*before being re-raised into* ``threading.excepthook``. Wrapping the
target (instead of replacing the process hook) composes with test
fixtures that install their own ``threading.excepthook`` to fail tests on
escaped exceptions: they still see every crash, in addition to the log
line and the counter.
"""

from __future__ import annotations

import logging
import threading
import weakref

from kwok_tpu_torch.telemetry.errors import worker_crashed

logger = logging.getLogger("kwok_tpu_torch.workers")

# name -> Thread; an entry vanishes when its thread object is collected
_live: "weakref.WeakValueDictionary[str, threading.Thread]" = (
    weakref.WeakValueDictionary()
)


def spawn_worker(
    target,
    *,
    name: str,
    args: tuple = (),
    kwargs: "dict | None" = None,
    daemon: bool = True,
    start: bool = True,
) -> threading.Thread:
    """Create (and by default start) a named daemon worker thread with
    crash accounting. Returns the Thread."""

    def run() -> None:
        try:
            target(*args, **(kwargs or {}))
        except BaseException:
            worker_crashed(name)
            logger.error("worker thread %s crashed", name, exc_info=True)
            raise  # still reaches threading.excepthook (tests fail on it)

    t = threading.Thread(target=run, name=name, daemon=daemon)
    _live[name] = t
    if start:
        t.start()
    return t


def live_workers() -> dict[str, threading.Thread]:
    """The spawned workers still alive, by name (the fault plane's kill
    targets, and tests)."""
    return {n: t for n, t in _live.items() if t.is_alive()}
