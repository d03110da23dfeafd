"""Locks that a supervised worker's restart can reclaim.

The fault plane kills a worker by raising ``WorkerKilled`` in it at its
next bytecode boundary (``PyThreadState_SetAsyncExc``). CPython does not
hold such an exception back across the edge of a critical section: one
that lands after a lock's acquire has returned but before the code that
releases it is armed (a ``with`` block's enter, an ``acquire(); try:``
pair) leaves the lock held by a thread whose stack no longer knows it,
and every thread that waits on the lock then blocks for good. In a chaos
run of the threaded lanes this froze the engine's allocation lock within
a minute.

So every lock that a supervised worker (a watch thread, a lane's router,
drain or emit worker) can take is made here: a reentrant lock, whose
owner the acquire itself records, registered in a weak set. Before a
crashed worker runs again, the watchdog calls :func:`release_held` on
that worker's own thread, which releases every registered lock the
thread still owns. A worker that crashed holds nothing legitimately: its
stack has unwound.
"""

from __future__ import annotations

import threading
import weakref

_reclaimable: "weakref.WeakSet" = weakref.WeakSet()


def reclaimable() -> "threading.RLock":
    """A reentrant lock that :func:`release_held` can reclaim."""
    lock = threading.RLock()
    _reclaimable.add(lock)
    return lock


def release_held() -> int:
    """Release every reclaimable lock the calling thread owns, at every
    level of recursion; returns how many releases that took."""
    n = 0
    for lock in list(_reclaimable):
        while lock._is_owned():
            lock.release()
            n += 1
    return n
