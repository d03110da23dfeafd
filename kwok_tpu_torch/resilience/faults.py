"""Deterministic fault injection at the engine's real I/O boundaries (the
port of ``kwok_tpu.resilience.faults``; the same grammar, the same
per-site decision streams, the same faults for the same spec).

It wraps the boundaries faults enter through:

- the KubeClient transport (``wrap_client``): watch handshake 410 storms,
  mid-stream connection cuts, list failures, apiserver-restart blackout
  windows, and the hostile wire (garbled, truncated, duplicated and stale
  lines);
- the native pump (``wrap_pump``, applied inside the engine's
  ``_get_pump``): dropped connections, short writes (a batch suffix dies
  mid-frame with status 0, pump.cc's failure contract) and send delays;
- worker threads (``kill_worker`` and the ``worker.kill`` spec): a
  :class:`WorkerKilled` poison pill async-raised into a named
  ``spawn_worker`` thread, which the watchdog must absorb and restart;
  lane processes (``register_proc_target``): a real SIGKILL or SIGSTOP;
- the process-lane surfaces (``shm.*``): torn shared-memory writes,
  dropped and garbled ring descriptors, a child that stalls its ring.

Determinism: every boundary draws from its own ``random.Random`` stream
seeded from ``(seed, site)`` (``(seed, lane, site)`` on a lane child's
plane), so one site's decision sequence never depends on how other
sites' calls interleave across threads. Same spec + same per-site call
sequence -> same faults, in this package and in ``kwok_tpu``.

Zero cost when disabled: with no spec there is no plane, no wrapper
objects exist, and the engine's hot paths carry no fault checks; the
only trace is an ``is None`` test at construction time.

Spec grammar (``EngineConfig.faults``, ``--faults``, ``KWOK_FAULTS`` or,
as the engine's fallback, ``KWOK_TPU_FAULTS``)::

    seed=42;pump.drop=0.02;pump.partial=0.02;pump.delay=0.01:0.05;
    watch.expire=0.2;watch.cut=0.001;list.fail=0.1;
    api.blackout=0.01:0.5;worker.kill=kwok-lane*:2.0

Entries are ``;``-separated ``key=value`` pairs. Probability-valued keys
take ``p`` or ``p:arg`` (``pump.delay``'s arg is seconds of sleep,
``api.blackout``'s the blackout window length). ``worker.kill`` and
``lane.sigstop`` take ``<name-glob>:<period-seconds>``: every period,
one live matching worker or process is killed (or SIGSTOPped), rotating
through the sorted matches. Under process lanes the parent derives each
child's plane with :func:`child_spec_text`: the CHILD_KINDS subset
re-seeded as ``(seed, lane_index, kind)``.

The plane records no spans: ``kwok_tpu``'s plane writes none either, and
its counters (``kwok_faults_injected_total{kind}``, the kill log) are
what a chaos run reads.
"""

from __future__ import annotations

import collections
import ctypes
import fnmatch
import json
import logging
import os
import random
import threading
import time

import numpy as np

from kwok_tpu_torch.edge.kubeclient import WatchEvent, WatchExpired
from kwok_tpu_torch.locks import reclaimable
from kwok_tpu_torch.telemetry.errors import PROCESS_REGISTRY
from kwok_tpu_torch.workers import live_workers, spawn_worker

logger = logging.getLogger("kwok_tpu_torch.resilience")

_injected = PROCESS_REGISTRY.counter(
    "kwok_faults_injected_total",
    "Faults injected by the resilience fault plane, by kind "
    "(pump.drop, watch.expire, worker.kill, ...); only moves when "
    "KWOK_TPU_FAULTS / EngineConfig.faults is set",
    ("kind",),
)

# every fault kind the spec accepts; parse rejects anything else so a
# typo'd key fails fast instead of silently injecting nothing
KINDS = (
    "pump.drop",      # whole pump batch loses its connection (status 0)
    "pump.partial",   # short write: a batch SUFFIX dies mid-frame
    "pump.delay",     # sleep arg seconds before the send
    "watch.expire",   # watch handshake answers 410 (WatchExpired)
    "watch.cut",      # per-event/line: stream cut (connection drop)
    "list.fail",      # LIST raises a connection error
    "api.blackout",   # all transport fails for arg seconds (restart)
    "worker.kill",    # kill matching workers every arg seconds
    # hostile-wire tier: bytes are WRONG, not just absent
    "wire.garble",    # flip/insert bytes in a watch line / LIST body
    "wire.truncate",  # cut a line mid-JSON, then die without a clean close
    "wire.dup",       # replay the immediately-prior event/line
    "wire.stale",     # re-deliver an OLD event (regressed resourceVersion)
    "clock.jump",     # skew the engine's `now` by uniform(-arg, +arg)
    # shm/IPC tier: faults on the --lane-procs surfaces
    "shm.torn",       # writer dies mid-slab (odd seq / half-armed slot)
    "shm.desc_drop",  # a ring descriptor is lost before the pipe send
    "shm.desc_garble",  # descriptor corrupted in flight (bounds-reject)
    "shm.stall",      # child pauses ring consumption for arg seconds
)

# the subset of kinds a lane CHILD's plane may carry: faults on the
# child's own boundaries (its HttpKubeClient, its pumps, its clock, its
# shm consumer/publisher side). Ingest faults (watch.*, list.fail,
# api.blackout on the watch plane), router-side shm faults and real
# signal delivery (worker.kill / lane.sigstop) stay on the parent, which
# owns those surfaces.
CHILD_KINDS = (
    "pump.drop", "pump.partial", "pump.delay",
    "wire.garble", "wire.truncate", "wire.dup", "wire.stale",
    "clock.jump",
    "shm.torn", "shm.stall",
)


class FaultInjected(ConnectionError):
    """An injected transport failure. Subclasses ConnectionError so every
    existing reconnect/retry path treats it exactly like the real thing."""


class WorkerKilled(BaseException):
    """Poison pill async-raised into a worker thread. BaseException so the
    per-item ``except Exception`` guards inside worker loops cannot absorb
    it — the thread's supervision (resilience/watchdog.py) must."""


def _async_raise(thread: threading.Thread, exc=WorkerKilled) -> bool:
    """Raise ``exc`` inside ``thread`` at its next bytecode boundary.
    Returns False when the thread is gone (or the raise could not be
    armed). A thread parked in a C-level wait dies only once it wakes —
    acceptable for chaos workers, which wake constantly under load."""
    tid = thread.ident
    if tid is None or not thread.is_alive():
        return False
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid), ctypes.py_object(exc)
    )
    if res > 1:  # should not happen; undo rather than corrupt the thread
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(tid), None
        )
        return False
    return res == 1


class _Rate:
    __slots__ = ("p", "arg")

    def __init__(self, p: float, arg: float = 0.0):
        self.p = float(p)
        self.arg = float(arg)


class FaultSpec:
    """Parsed fault spec: per-kind rates + the deterministic seed."""

    def __init__(self, seed: int = 0, rates: "dict[str, _Rate] | None" = None):
        self.seed = int(seed)
        self.rates: dict[str, _Rate] = rates or {}
        self.kill_glob = ""
        self.kill_period = 0.0
        self.sigstop_glob = ""
        self.sigstop_period = 0.0
        # lane index of the child plane this spec was derived for; -1 on
        # a parent/threaded plane. Folded into every stream seed so the
        # same parent spec gives each lane a DIFFERENT but reproducible
        # decision sequence.
        self.lane = -1

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        spec = cls()
        for entry in text.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ValueError(f"fault spec entry {entry!r}: missing '='")
            key, _, value = entry.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "seed":
                spec.seed = int(value)
                continue
            if key == "lane":
                spec.lane = int(value)
                continue
            if key in ("worker.kill", "lane.sigstop"):
                glob, _, period = value.rpartition(":")
                if not glob:
                    raise ValueError(
                        f"{key} takes <name-glob>:<period-seconds>"
                    )
                if float(period) <= 0:
                    raise ValueError(f"{key} period must be > 0")
                if key == "worker.kill":
                    spec.kill_glob, spec.kill_period = glob, float(period)
                else:
                    spec.sigstop_glob, spec.sigstop_period = (
                        glob, float(period)
                    )
                continue
            if key not in KINDS:
                raise ValueError(
                    f"unknown fault kind {key!r} (known: {', '.join(KINDS)})"
                )
            p, _, arg = value.partition(":")
            spec.rates[key] = _Rate(p, float(arg) if arg else 0.0)
        return spec

    def rate(self, kind: str) -> "_Rate | None":
        return self.rates.get(kind)

    def render(self) -> str:
        """Serialize back to the spec grammar (parse(render()) is
        equivalent). The propagation surface: the parent renders each
        lane's derived child spec into the spawn payload."""
        parts = [f"seed={self.seed}"]
        if self.lane >= 0:
            parts.append(f"lane={self.lane}")
        for kind in KINDS:  # KINDS order: deterministic text
            rate = self.rates.get(kind)
            if rate is None:
                continue
            if rate.arg:
                parts.append(f"{kind}={rate.p}:{rate.arg}")
            else:
                parts.append(f"{kind}={rate.p}")
        if self.kill_glob:
            parts.append(f"worker.kill={self.kill_glob}:{self.kill_period}")
        if self.sigstop_glob:
            parts.append(
                f"lane.sigstop={self.sigstop_glob}:{self.sigstop_period}"
            )
        return ";".join(parts)


def child_spec_text(spec: "FaultSpec | None", lane_index: int) -> str:
    """Derive the fault spec a lane child should run: the parent's rates
    restricted to CHILD_KINDS (the boundaries the child actually owns),
    re-keyed with ``lane=<i>`` so every stream re-seeds as
    (seed, lane_index, kind). Signal delivery and ingest faults never
    propagate. Returns the literal ``"off"`` when nothing survives the
    filter — the child then builds NO plane (zero-cost contract), even
    when KWOK_TPU_FAULTS is set in the inherited environment."""
    if spec is None:
        return "off"
    child = FaultSpec(seed=spec.seed)
    child.lane = int(lane_index)
    child.rates = {
        k: v for k, v in spec.rates.items() if k in CHILD_KINDS
    }
    if not child.rates:
        return "off"
    return child.render()


class FaultPlane:
    """One seeded instance of the fault plane: decision streams, the
    blackout window, counters, and the optional worker-killer thread."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        # per-site decision streams: one Random per kind, seeded from
        # (seed, kind) — (seed, lane, kind) on a lane child's plane —
        # each behind its own lock so a site's sequence is a pure
        # function of its own call count (thread interleaving across
        # sites cannot perturb it)
        _lane = f"L{spec.lane}:" if spec.lane >= 0 else ""
        self._streams = {
            kind: (
                random.Random(f"{spec.seed}:{_lane}{kind}"),
                reclaimable(),
            )
            for kind in KINDS
        }
        # blackout state: monotonic deadline; reads are lock-free (float
        # store is GIL-atomic), arming happens under the fault lock
        self._blackout_until = 0.0
        # clock.jump skew: the offset added to engine `now`; re-drawn (not
        # accumulated — convergence must stay bounded) on each firing draw
        self._skew = 0.0
        self._fault_lock = reclaimable()
        self._events: dict[str, int] = {}
        self._started = 0
        self._killer: "threading.Thread | None" = None
        self._stop = threading.Event()
        self._kill_results: list[dict] = []
        # process-lane kill targets (engine/proclanes.py): name -> a
        # callable delivering a REAL SIGKILL to the lane process. The
        # worker.kill spec matches these exactly like supervised thread
        # names, so `worker.kill=kwok-lane*` kills processes under
        # --lane-procs and threads otherwise.
        self._proc_targets: dict = {}
        # lane.sigstop targets: name -> callable delivering SIGSTOP (the
        # wedged-but-alive shape; the supervisor's stall-kill recovers)
        self._stop_targets: dict = {}
        self._stopper: "threading.Thread | None" = None

    # ------------------------------------------------------------ decisions

    def decide(self, kind: str) -> "_Rate | None":
        """One draw from ``kind``'s stream: its rate when the fault fires,
        else None. Sites with no configured rate never draw (their stream
        stays untouched, preserving determinism for enabled sites)."""
        rate = self.spec.rate(kind)
        if rate is None or rate.p <= 0.0:
            return None
        rng, lock = self._streams[kind]
        with lock:
            fired = rng.random() < rate.p
        return rate if fired else None

    def record(self, kind: str) -> None:
        """Account one injected fault (counter + the artifact tally)."""
        with self._fault_lock:
            self._events[kind] = self._events.get(kind, 0) + 1
        # registry child locks are leaves; never take them under ours
        _injected.labels(kind=kind).inc()

    def counts(self) -> dict:
        """Injected-fault tally by kind (chaos artifact surface)."""
        with self._fault_lock:
            return dict(self._events)

    def kill_log(self) -> list[dict]:
        with self._fault_lock:
            return list(self._kill_results)

    # ---------------------------------------------------------- hostile wire

    def clock_skew(self) -> float:
        """The current clock.jump skew in seconds, re-drawn from the
        kind's stream with its configured probability per read. The skew
        JUMPS to a fresh uniform(-arg, +arg) value instead of
        accumulating, so hostile clocks stay bounded (arg must be well
        under the heartbeat interval). Only the engine's ``_now`` calls
        this, and only when the spec configures clock.jump."""
        rate = self.decide("clock.jump")
        if rate is not None:
            rng, lock = self._streams["clock.jump"]
            with lock:
                self._skew = rng.uniform(-rate.arg, rate.arg)
            self.record("clock.jump")
        return self._skew

    def garble_bytes(self, data: bytes) -> bytes:
        """One seeded byte-level corruption: flip a byte to a different
        value, or insert a junk byte — the two shapes a hostile wire
        produces without changing framing. Callers already drew the
        wire.garble decision; this only draws the corruption shape."""
        if not data:
            return b"\xff"
        rng, lock = self._streams["wire.garble"]
        with lock:
            i = rng.randrange(len(data))
            delta = rng.randrange(1, 256)
            insert = rng.random() < 0.5
        if insert:
            return data[:i] + bytes((delta,)) + data[i:]
        return data[:i] + bytes(((data[i] ^ delta),)) + data[i + 1:]

    def truncate_bytes(self, data: bytes) -> bytes:
        """A seeded mid-JSON cut: a strict, non-empty prefix."""
        if len(data) < 2:
            return data[:1]
        rng, lock = self._streams["wire.truncate"]
        with lock:
            k = rng.randrange(1, len(data))
        return data[:k]

    # ------------------------------------------------------------- blackout

    def transport_fault(self, op: str) -> None:
        """Shared unary-transport gate: raises FaultInjected while a
        blackout window is open, and may open one (api.restart
        semantics: every caller fails until the window closes)."""
        now = time.monotonic()
        if now < self._blackout_until:
            self.record("api.blackout")
            raise FaultInjected(f"injected apiserver blackout ({op})")
        rate = self.decide("api.blackout")
        if rate is not None:
            with self._fault_lock:
                self._blackout_until = now + max(rate.arg, 0.05)
            self.record("api.blackout")
            raise FaultInjected(f"injected apiserver restart ({op})")

    # ------------------------------------------------------------- wrappers

    def wrap_client(self, client):
        """Fault-injecting view over a KubeClient. Idempotent: an already
        wrapped client is returned unchanged (lane engines share their
        parent's client)."""
        if isinstance(client, FaultyClient):
            return client
        return FaultyClient(self, client)

    def wrap_pump(self, pump):
        return FaultyPump(self, pump)

    # --------------------------------------------------------- worker kills

    def start(self) -> None:
        """Arm the worker-killer / lane-stopper threads (when the spec
        asks for them). Refcounted: engines sharing the plane start/stop
        them together."""
        with self._fault_lock:
            self._started += 1
            if self._started > 1:
                return
            self._stop.clear()
            if self._killer is None and self.spec.kill_glob:
                self._killer = spawn_worker(
                    self._kill_loop, name="kwok-chaos-killer"
                )
            if self._stopper is None and self.spec.sigstop_glob:
                self._stopper = spawn_worker(
                    self._sigstop_loop, name="kwok-chaos-stopper"
                )

    def stop(self) -> None:
        with self._fault_lock:
            self._started = max(0, self._started - 1)
            if self._started:
                return
            killer, self._killer = self._killer, None
            stopper, self._stopper = self._stopper, None
        if killer is not None or stopper is not None:
            self._stop.set()
        if killer is not None:
            killer.join(timeout=5)
        if stopper is not None:
            stopper.join(timeout=5)

    # Threads the spec-driven killer may target: ONLY the watchdog-
    # supervised workers — lane workers (LaneSet.start_workers) and the
    # watch ingest loops (ClusterEngine._spawn_watch spawns them under
    # the watchdog; a restarted watch loop re-lists by construction, so
    # the restart IS the recovery). Killing an
    # unsupervised singleton (kwok-tick, kwok-http, the profiling
    # sampler) would end it for good with /readyz still 200 — a
    # silently-dead engine, not a self-healing exercise. Tests that
    # want to assassinate arbitrary threads call kill_worker directly.
    _SUPERVISED_PREFIXES = (
        "kwok-lane", "kwok-emit", "kwok-route", "kwok-watch",
    )

    def register_proc_target(self, name: str, kill_fn, stop_fn=None) -> None:
        """Expose a supervised lane PROCESS to the worker.kill rotation;
        ``kill_fn()`` must deliver SIGKILL and return whether it did.
        ``stop_fn()`` (optional) delivers SIGSTOP for the lane.sigstop
        rotation — the wedged-but-alive shape whose recovery is the
        supervisor's KWOK_TPU_LANE_STALL_S stall-kill."""
        with self._fault_lock:
            self._proc_targets[name] = kill_fn
            if stop_fn is not None:
                self._stop_targets[name] = stop_fn

    def unregister_proc_target(self, name: str) -> None:
        with self._fault_lock:
            self._proc_targets.pop(name, None)
            self._stop_targets.pop(name, None)

    def _kill_loop(self) -> None:
        nth = 0
        while not self._stop.wait(self.spec.kill_period):
            with self._fault_lock:
                procs = dict(self._proc_targets)
            names = sorted(
                {
                    n for n in live_workers()
                    if fnmatch.fnmatch(n, self.spec.kill_glob)
                    and n.startswith(self._SUPERVISED_PREFIXES)
                }
                | {
                    n for n in procs
                    if fnmatch.fnmatch(n, self.spec.kill_glob)
                }
            )
            if not names:
                continue
            # rotate deterministically through the sorted matches
            name = names[nth % len(names)]
            nth += 1
            if name in procs:
                self.kill_process(name, procs[name])
            else:
                self.kill_worker(name)

    def kill_process(self, name: str, kill_fn) -> bool:
        """SIGKILL a registered lane process (the process-lane twin of
        kill_worker: same counter, same kill log)."""
        try:
            ok = bool(kill_fn())
        except Exception:
            logger.exception("chaos: SIGKILL of %s failed", name)
            return False
        if ok:
            self.record("worker.kill")
            with self._fault_lock:
                self._kill_results.append(
                    {"thread": name, "proc": True, "t": time.monotonic()}
                )
            logger.warning("chaos: SIGKILLed lane process %s", name)
        return ok

    def _sigstop_loop(self) -> None:
        """Rotate SIGSTOP through registered lane processes matching the
        lane.sigstop glob. The stopped child keeps its shm maps and pipe
        but its StatusBank beat freezes — the parent's supervisor must
        stall-kill (SIGKILL works on a stopped process) and respawn."""
        nth = 0
        while not self._stop.wait(self.spec.sigstop_period):
            with self._fault_lock:
                stops = dict(self._stop_targets)
            names = sorted(
                n for n in stops
                if fnmatch.fnmatch(n, self.spec.sigstop_glob)
            )
            if not names:
                continue
            name = names[nth % len(names)]
            nth += 1
            self.stop_process(name, stops[name])

    def stop_process(self, name: str, stop_fn) -> bool:
        """SIGSTOP a registered lane process (wedged-but-alive: counted
        like a kill, recovered by the supervisor's stall-kill)."""
        try:
            ok = bool(stop_fn())
        except Exception:
            logger.exception("chaos: SIGSTOP of %s failed", name)
            return False
        if ok:
            self.record("lane.sigstop")
            with self._fault_lock:
                self._kill_results.append(
                    {"thread": name, "proc": True, "stop": True,
                     "t": time.monotonic()}
                )
            logger.warning("chaos: SIGSTOPped lane process %s", name)
        return ok

    def kill_worker(self, name: str) -> bool:
        """Async-raise WorkerKilled into the named spawn_worker thread.
        Returns whether the pill was armed."""
        t = live_workers().get(name)
        if t is None:
            return False
        ok = _async_raise(t)
        if ok:
            self.record("worker.kill")
            with self._fault_lock:
                self._kill_results.append(
                    {"thread": name, "t": time.monotonic()}
                )
            logger.warning("chaos: killed worker %s", name)
        return ok


class FaultyClient:
    """KubeClient wrapper injecting transport faults. Unknown attributes
    delegate, so FakeKube test hooks and HttpKubeClient extras survive."""

    def __init__(self, plane: FaultPlane, inner):
        self._plane = plane
        self._inner = inner

    def list(self, kind, **kw):
        self._plane.transport_fault("list")
        if self._plane.decide("list.fail") is not None:
            self._plane.record("list.fail")
            raise FaultInjected(f"injected list failure ({kind})")
        out = self._inner.list(kind, **kw)
        if self._plane.decide("wire.truncate") is not None:
            # a LIST body cut mid-JSON: the whole-document parse fails —
            # the same error shape json.loads raises in the real client
            self._plane.record("wire.truncate")
            raise FaultInjected(f"injected truncated LIST body ({kind})")
        if self._plane.decide("wire.garble") is not None:
            self._plane.record("wire.garble")
            return self._garble_list(kind, out)
        return out

    def _garble_list(self, kind, items):
        """Byte-corrupt the LIST body: serialize, garble, re-parse.
        A parse failure is what a real garbled body does to the client
        (raised, caller re-lists); a still-parseable result carries the
        corrupted values into ingest — the anti-entropy auditor's case."""
        blob = json.dumps({"items": items}, separators=(",", ":")).encode()
        try:
            doc = json.loads(self._plane.garble_bytes(blob))
            got = doc.get("items")
            if not isinstance(got, list):
                raise ValueError("garbled items")
        except ValueError:
            raise FaultInjected(
                f"injected garbled LIST body ({kind})"
            ) from None
        return [o for o in got if isinstance(o, dict)]

    def watch(self, kind, **kw):
        self._plane.transport_fault("watch")
        if kw.get("resource_version") and (
            self._plane.decide("watch.expire") is not None
        ):
            # a compaction storm: every rv-resume is below the floor
            self._plane.record("watch.expire")
            raise WatchExpired(f"injected compaction ({kind})")
        return FaultyWatch(self._plane, self._inner.watch(kind, **kw))

    def get(self, kind, namespace, name):
        self._plane.transport_fault("get")
        return self._inner.get(kind, namespace, name)

    def create(self, kind, obj, *a, **kw):
        self._plane.transport_fault("create")
        return self._inner.create(kind, obj, *a, **kw)

    def patch_status(self, kind, namespace, name, patch):
        self._plane.transport_fault("patch_status")
        return self._inner.patch_status(kind, namespace, name, patch)

    def patch_meta(self, kind, namespace, name, patch):
        self._plane.transport_fault("patch_meta")
        return self._inner.patch_meta(kind, namespace, name, patch)

    def delete(self, kind, namespace, name, **kw):
        self._plane.transport_fault("delete")
        return self._inner.delete(kind, namespace, name, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyWatch:
    """Watch-handle wrapper: cuts the stream (connection drop) with
    ``watch.cut`` probability per event/line, and speaks the hostile-wire
    tier — ``wire.dup`` (replay the prior event), ``wire.stale``
    (re-deliver an old event whose resourceVersion has regressed),
    ``wire.garble`` (byte corruption) and ``wire.truncate`` (a mid-JSON
    cut followed by an abrupt stream death). The native reader is
    disabled — it reads the socket from C, where per-line injection
    cannot reach — so a faulted engine always takes a Python-visible
    ingest path (raw_lines when the inner handle has it)."""

    native_reader = None  # force the per-line path under faults

    #: replay window for wire.dup / wire.stale (per stream)
    _RECENT = 64

    def __init__(self, plane: FaultPlane, inner):
        self._plane = plane
        self._inner = inner
        if hasattr(inner, "raw_lines"):
            # instance attribute: engines probe with getattr, and a
            # wrapper around a handle WITHOUT raw_lines must not grow one
            self.raw_lines = self._raw_lines

    def _cut(self) -> bool:
        if self._plane.decide("watch.cut") is not None:
            self._plane.record("watch.cut")
            self._stop_inner()
            return True
        return False

    def _stop_inner(self) -> None:
        try:
            self._inner.stop()
        except Exception:
            logger.debug("inner watch stop failed mid-cut", exc_info=True)

    def __iter__(self):
        """Parsed-event path (clients without raw_lines): the wire tier is
        emulated at the event level. Garble serializes the event document,
        corrupts bytes, and re-parses — a still-parseable result delivers
        the corrupted values (the auditor's case); an unparseable one ends
        the stream the way the hardened client does on a bad line
        (integrity doubt -> reconnect resumes and the server replays)."""
        plane = self._plane
        recent: "collections.deque" = collections.deque(maxlen=self._RECENT)
        for ev in self._inner:
            if self._cut():
                return
            if recent and plane.decide("wire.dup") is not None:
                plane.record("wire.dup")
                yield recent[-1]
            if recent and plane.decide("wire.stale") is not None:
                plane.record("wire.stale")
                yield recent[0]
            if plane.decide("wire.truncate") is not None:
                plane.record("wire.truncate")
                self._stop_inner()
                return  # the half-delivered event dies with the stream
            if plane.decide("wire.garble") is not None:
                plane.record("wire.garble")
                blob = plane.garble_bytes(json.dumps(
                    {"type": ev.type, "object": ev.object},
                    separators=(",", ":"), default=str,
                ).encode())
                try:
                    doc = json.loads(blob)
                    type_ = doc.get("type")
                    obj = doc.get("object")
                    if type_ not in ("ADDED", "MODIFIED", "DELETED",
                                     "BOOKMARK") or not isinstance(obj, dict):
                        raise ValueError("garbled event")
                except ValueError:
                    # unparseable on the wire: the hardened client treats
                    # it as integrity doubt and ends the stream
                    self._stop_inner()
                    return
                recent.append(ev)
                yield WatchEvent(type_, obj)
                continue
            recent.append(ev)
            yield ev

    def _raw_lines(self):
        """Raw byte-line path (the engine's native-parse ingest edge):
        the wire tier operates on the real bytes."""
        plane = self._plane
        recent: "collections.deque" = collections.deque(maxlen=self._RECENT)
        for line in self._inner.raw_lines():
            if self._cut():
                return
            if recent and plane.decide("wire.dup") is not None:
                plane.record("wire.dup")
                yield recent[-1]
            if recent and plane.decide("wire.stale") is not None:
                plane.record("wire.stale")
                yield recent[0]
            if plane.decide("wire.truncate") is not None:
                plane.record("wire.truncate")
                yield plane.truncate_bytes(line)
                self._stop_inner()
                return  # mid-JSON cut, no clean close
            if plane.decide("wire.garble") is not None:
                plane.record("wire.garble")
                recent.append(line)
                yield plane.garble_bytes(line)
                continue
            recent.append(line)
            yield line

    def stop(self) -> None:
        self._inner.stop()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FaultyPump:
    """Native-pump wrapper reproducing pump.cc's failure contract on
    demand: a dropped connection fails the whole batch with status 0; a
    short write delivers a PREFIX and fails the suffix mid-frame (the
    exact shape the partial-write fix in the engine's ``_pump_send``
    retry must recover from); a delay stalls the send."""

    def __init__(self, plane: FaultPlane, inner):
        self._plane = plane
        self._inner = inner

    def send(self, requests):
        plane = self._plane
        rate = plane.decide("pump.delay")
        if rate is not None:
            plane.record("pump.delay")
            time.sleep(rate.arg or 0.01)
        if plane.decide("pump.drop") is not None:
            plane.record("pump.drop")
            return np.zeros(len(requests), np.int32)
        if len(requests) > 1 and plane.decide("pump.partial") is not None:
            plane.record("pump.partial")
            rng, lock = plane._streams[("pump.partial")]
            with lock:
                k = rng.randrange(1, len(requests))
            head = self._inner.send(requests[:k])
            return np.concatenate(
                [head, np.zeros(len(requests) - k, np.int32)]
            )
        return self._inner.send(requests)

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def from_config(spec_text: str = "") -> "FaultPlane | None":
    """The engine's entry point: a FaultPlane when a spec is configured
    (EngineConfig.faults, falling back to KWOK_TPU_FAULTS), else None —
    the disabled case allocates nothing and wraps nothing. The literal
    ``"off"`` disables the plane even when the env var is set (a lane
    child whose parent has no plane — or no child-side kinds — receives
    it via :func:`child_spec_text`, so an inherited KWOK_TPU_FAULTS can
    never resurrect a plane the parent decided against)."""
    text = (spec_text or os.environ.get("KWOK_TPU_FAULTS", "")).strip()
    if not text or text == "off":
        return None
    return FaultPlane(FaultSpec.parse(text))
