"""Process lanes: each lane a spawned process running the single-lane
engine (the port of ``kwok_tpu.engine.proclanes``).

  parent: watch threads ──> router thread (one batched native parse per
          window, which computes each event's lane) ──> per-lane
          shared-memory RawRing (raw watch lines written once) + a
          descriptor pipe; a supervisor; a status coordinator
  child i: the single-lane ClusterEngine over shard i — ingest, its own
          CUDA stream and device rows, the tick kernel (csrc/tick.cu),
          emit — plus a node "topology tap" for the shards it does not own

The threaded lanes (``engine/lanes.py``) share one interpreter lock; here
every lane has an interpreter, a core and a CUDA context of its own. The
parent holds no device rows and no CUDA context: before it spawns the
lanes it builds the kernel library once (nvcc only), so the lane
processes only load it.

Each child is exactly the single-lane engine, so per-key patch order and
patch bytes are the single-lane engine's. Node events broadcast to every
lane: the owning lane does the rows and heartbeats, the others run the
tap (``node_has`` membership and the managed-ness of their own pods on
that node), so no node is managed twice. The pod-IP CIDR is split into
disjoint per-lane ranges (``IPPool.partition_lanes``), so no allocator
lock crosses processes.

Robustness follows the reference:

- a lane process that dies without a STOP is respawned by the supervisor
  under the watchdog's restart budget (``Watchdog.charge``); once the
  budget is spent the engine degrades (``/readyz`` 503);
- each lane checkpoints its shard to ``lane<i>.ckpt.json``; a respawn
  reconciles against it after the re-list the respawn triggers;
- the emit crash-replay slot is a shared-memory ``InflightSlot``: the
  child parks every patch in flight before sending it (one object's
  request from the executor, or a whole pump batch's frames), and the
  parent replays whatever the slot holds before the respawn.

``spawn`` only: the parent is thread-rich (and may hold a CUDA context,
as a test harness does), and a fork would clone held locks into the
child. Off by default (``--lane-procs``, ``KWOK_LANE_PROCS``); with it off
no arena, pipe or process exists.

A lane process parses each routed window (``RAWB``) in one native call
on its own core, and ingests it through the single-lane engine's record
path. Every descriptor passes a bounds gate (``_desc_check``) before the
child touches the ring: a garbled one is rejected, counted in
``kwok_shm_desc_rejects_total{reason}`` and turned into a re-list. Each
lane process writes its own span dump (``<trace dump>.lane<i>``).

The fault plane reaches the lanes as in ``kwok_tpu``: each lane process
is a ``worker.kill`` and ``lane.sigstop`` target of the parent's plane
(``register_proc_target``: a real SIGKILL or SIGSTOP); the parent drops
(``shm.desc_drop``) and garbles (``shm.desc_garble``, ``_garble_desc``)
descriptors; each child runs the plane ``child_spec_text`` derives for
it (its pumps, its clock, ``shm.torn`` on its slot and metrics slab,
``shm.stall`` on its ring), and ``quiesce_child_faults`` clears every
child's rates over the pipe (``FAULTSOFF``). Not here yet: the drift
mirror (item 13b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import logging
import os
import pickle
import queue
import signal
import threading
import time

import numpy as np

from kwok_tpu_torch import native
from kwok_tpu_torch.engine import shm as shm_mod
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.resilience.faults import child_spec_text
from kwok_tpu_torch.telemetry.engine_metrics import _HELP as _ENGINE_HELP
from kwok_tpu_torch.telemetry.errors import (
    PROCESS_REGISTRY,
    swallowed,
    worker_crashed,
    worker_restarted,
)
from kwok_tpu_torch.workers import spawn_worker

logger = logging.getLogger("kwok_tpu_torch.proclanes")

_KINDS = ("nodes", "pods")

#: per-lane raw-handoff ring size (bytes); half of it bounds one blob
_RING_BYTES = 4 << 20
#: per-lane emit crash-replay slot size (bytes)
_SLOT_BYTES = 1 << 20
#: per-lane metrics-snapshot slab size (bytes)
_METRICS_BYTES = 1 << 20
#: status-loop beats (50 ms each) between metrics-snapshot publishes
_METRICS_EVERY_BEATS = 20
#: seconds the router waits on a full ring before it drops the slice for
#: that lane (a dead or stalled child; the re-list re-delivers)
_RING_STALL_S = 5.0
#: supervisor poll cadence (seconds)
_SUPER_POLL_S = 0.2
#: a live lane process whose status beat is older than this is wedged
#: and is killed for a respawn
_STALL_NS = 60 * 10**9

# flat counters (ClusterEngine.metrics) the parent owns: its watches
# count the events and re-lists, and it reads the gauges from the
# StatusBank; a lane's copy is left out of the sum
_PARENT_FLAT = frozenset({
    "watch_events_total", "watch_relists_total", "nodes_managed",
    "pods_managed", "ingest_queue_depth", "restart_recovery_seconds",
})
# flat gauges of the live lanes that add up (every other lane gauge is
# merged as the worst lane's value)
_SUM_FLAT_GAUGES = frozenset({
    "checkpoint_bytes_last", "restore_refined_rows", "restore_stale_rows",
})


def _is_counter(name: str) -> bool:
    return name.endswith(("_total", "_sum"))


# --------------------------------------------------------------- child side


def _desc_check(kind, off, ln, bounds, cap: int, published: int):
    """None when a RAWB descriptor is safe to dereference, else the reject
    reason. Pure integer and bounds arithmetic over the descriptor, the
    ring's capacity and its published write cursor: nothing is read from
    shared memory until every check passes, so a garbled descriptor never
    turns into a wild read."""
    if kind not in _KINDS:
        return "kind"
    if not isinstance(off, int) or not isinstance(ln, int):
        return "type"
    if ln < 0 or ln > cap or off < 0:
        return "range"
    if off + ln > published:
        return "unpublished"
    if not isinstance(bounds, list) or not bounds or bounds[0] != 0:
        return "bounds"
    prev = 0
    for b in bounds[1:]:
        if not isinstance(b, int) or b < prev or b > ln:
            return "bounds"
        prev = b
    if prev != ln:
        return "bounds"
    return None


def _frames_bytes(requests: list) -> int:
    """About what ``requests`` take in the slot's pickle."""
    return sum(len(r[1]) + len(r[2]) + 64 for r in requests)


class _SlotGuardClient:
    """The lane process's apiserver client, guarding its emit: every
    status patch, finalizer strip and delete is parked in the lane's
    InflightSlot before it is sent and leaves the slot once it has an
    answer (the patch executor's retry re-parks it). A SIGKILL mid-emit
    thus loses no owed status: the parent replays what the slot holds
    before the respawn, and the respawn's re-list covers the rest.

    The patch executor sends from several threads and the pump groups
    (``_SlotGuardPump``) park their batches here too, so the slot holds
    every request in flight, rewritten under one lock on each change.
    A status batch is sent in chunks of at most ``budget`` bytes of
    frames (an eighth of the slot), so the chunks of every pump group fit
    in it beside the single requests; should the union still overflow,
    the largest entries leave it first."""

    def __init__(self, slot: shm_mod.InflightSlot, inner, plane=None) -> None:
        self._slot = slot
        self._inner = inner
        # the lane's own fault plane: shm.torn makes the writer "die"
        # mid-arm (a prefix lands, the state never returns to armed), and
        # the parent's post-mortem peek() must read the slot as empty
        self._plane = plane
        self._lock = threading.Lock()
        self._inflight: dict[int, list] = {}
        self._seq = 0
        self.budget = slot.cap // 8
        # per sending thread: the token of the pump batch whose resend
        # scope is open (pump_scope), or None
        self._scope = threading.local()

    def _path(self, kind, namespace, name, subresource=None) -> str:
        c = self._inner
        url = c._url(kind, namespace, name, subresource)
        return (c._base_path + url[len(c.server):]) or "/"

    def _publish(self, torn: bool = False) -> None:
        # caller holds _lock; ``torn``: this re-arm dies mid-copy
        # (shm.torn, decided by the caller before it took the lock)
        try:
            # smallest first: what does not fit leaves largest first, so
            # an oversized union still keeps the single requests
            entries = sorted(self._inflight.values(), key=_frames_bytes)
            while entries:
                payload = pickle.dumps(
                    [r for reqs in entries for r in reqs], protocol=4,
                )
                if torn:
                    self._slot.torn_arm(payload)
                    return
                if self._slot.arm(payload):
                    return
                entries.pop()
            # nothing in flight: an empty slot, never a stale one
            self._slot.clear()
        except Exception:
            # the slot is belt and braces over the re-list: losing it
            # must never block the send
            swallowed("proclanes.slot_arm")

    def _token(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _park(self, token: int, requests: list) -> None:
        """``requests`` under ``token`` in the slot (none: out of it)."""
        plane = self._plane
        torn = bool(requests) and plane is not None and plane.decide("shm.torn") is not None
        if torn:
            plane.record("shm.torn")
        with self._lock:
            if requests:
                self._inflight[token] = requests
            elif self._inflight.pop(token, None) is None:
                return
            self._publish(torn)

    def _guarded(self, requests: list, send):
        """send() with ``requests`` parked in the slot until it returns."""
        token = self._token()
        self._park(token, requests)
        try:
            return send()
        finally:
            self._park(token, [])

    @contextlib.contextmanager
    def pump_scope(self):
        """One status batch's first send and its whole-frame resends on
        this thread: between the sends, through the resend backoff, the
        frames still owed (status 0) stay parked; they leave the slot
        when the scope ends (answered, shed, or handed to the per-object
        path, whose requests park themselves)."""
        token = self._token()
        self._scope.token = token
        try:
            yield
        finally:
            self._scope.token = None
            self._park(token, [])

    def pump_send(self, frames: list, send):
        """send() of a pump batch's ``frames``: parked for the call, or,
        inside ``pump_scope``, until each has an answer."""
        token = getattr(self._scope, "token", None)
        if token is None:
            return self._guarded(frames, send)
        self._park(token, frames)
        status = send()
        self._park(token, [f for f, st in zip(frames, status.tolist()) if st == 0])
        return status

    def chunks(self, reqs: list) -> list:
        """``reqs`` cut into runs whose frames take at most ``budget``
        bytes (each run at least one request)."""
        out, run, size = [], [], 0
        for r in reqs:
            n = _frames_bytes([r])
            if run and size + n > self.budget:
                out.append(run)
                run, size = [], 0
            run.append(r)
            size += n
        if run:
            out.append(run)
        return out

    def patch_status(self, kind, namespace, name, patch):
        body = json.dumps(patch).encode()
        req = ("PATCH", self._path(kind, namespace, name, "status"), body,
               "application/strategic-merge-patch+json")
        return self._guarded(
            [req], lambda: self._inner.patch_status(kind, namespace, name, body)
        )

    def patch_meta(self, kind, namespace, name, patch):
        body = json.dumps(patch).encode()
        req = ("PATCH", self._path(kind, namespace, name), body,
               "application/merge-patch+json")
        return self._guarded(
            [req], lambda: self._inner.patch_meta(kind, namespace, name, body)
        )

    def delete(self, kind, namespace, name, grace_seconds=0):
        body = b"" if grace_seconds is None else json.dumps(
            {"gracePeriodSeconds": grace_seconds}).encode()
        req = ("DELETE", self._path(kind, namespace, name), body,
               "application/json")
        return self._guarded(
            [req], lambda: self._inner.delete(kind, namespace, name, grace_seconds)
        )

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _SlotGuardPump:
    """One pump connection group of the lane process, guarded like its
    client: each batch is parked in the lane's slot (through the client
    guard's ledger, as whole frames the parent's replay sends) before it
    goes on the wire. It leaves the slot once the send returns, or,
    inside the guard's ``pump_scope`` (a status batch and its
    whole-frame resends), once every frame has an answer. Not a plain
    ``native.Pump``, so the fused template emit renders first and sends
    through here: a fused call never tunnels past the slot."""

    def __init__(self, guard: _SlotGuardClient, inner) -> None:
        self._guard = guard
        self._inner = inner

    def send(self, requests):
        frames = [
            (r[0], r[1].decode() if isinstance(r[1], (bytes, bytearray)) else r[1],
             bytes(r[2]), r[3] if len(r) > 3 else "application/json")
            for r in requests
        ]
        return self._guard.pump_send(frames, lambda: self._inner.send(requests))

    def close(self) -> None:
        self._inner.close()


def make_proc_lane_engine_class():
    """The lane process's engine class, built lazily so importing this
    module does not import the engine (the spawn pickle carries only a
    module path)."""
    from kwok_tpu_torch.engine.engine import ClusterEngine

    class _ProcLaneEngine(ClusterEngine):
        """The single-lane engine plus the node topology tap: node events
        of shards this lane does not own update ``node_has`` (and this
        lane's pods on that node) WITHOUT acquiring rows; the owning lane
        does the rows and the heartbeats.

        Stream healing crosses the process boundary inverted: the lane
        has no watch streams, so integrity doubt (unparseable routed
        lines) and re-list rv rewinds (a store restore) are counters in
        its StatusBank row, and the parent's coordinator turns their
        increases into the real re-lists. With ``_proc_integ`` unset (a
        test) the engine behaves as the single-lane one."""

        _lane_index = 0
        _lane_n = 1
        _proc_integ: "dict | None" = None
        #: the lane's _SlotGuardClient (None: no slot, as in a test)
        _slot_guard = None

        def _pump_send_frames(self, reqs):
            """A status batch in chunks that fit the lane's slot, each
            sent with its whole-frame resends inside one ``pump_scope``:
            the frames still owed stay parked through the backoff."""
            guard = self._slot_guard
            if guard is None or not reqs:
                return super()._pump_send_frames(reqs)
            parts = []
            for run in guard.chunks(reqs):
                with guard.pump_scope():
                    parts.append(super()._pump_send_frames(run))
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

        def _integrity_resync(self, kind: str) -> None:
            d = self._proc_integ
            if d is not None:
                d[kind] = d.get(kind, 0) + 1
                return
            super()._integrity_resync(kind)

        def _node_owned(self, name: str) -> bool:
            return shard_of(name, self._lane_n) == self._lane_index

        def _node_upsert(self, node: dict) -> None:
            name = (node.get("metadata") or {}).get("name")
            if name and not self._node_owned(name):
                # membership is sticky until Deleted, like the engine's
                # nodesSets: only a NEW managed node changes the tap
                if name not in self.node_has and self._node_need_heartbeat(node):
                    self.node_has.add(name)
                    self._update_pods_on_node(name)
                return
            super()._node_upsert(node)

        def _node_deleted(self, node: dict) -> None:
            name = (node.get("metadata") or {}).get("name")
            if name and not self._node_owned(name):
                if name in self.node_has:
                    self.node_has.discard(name)
                    self._update_pods_on_node(name)
                return
            super()._node_deleted(node)

        def _tracked_rv(self, kind: str, obj: dict) -> int:
            meta = obj.get("metadata") or {}
            if kind == "nodes":
                k, key = self.nodes, meta.get("name")
            else:
                k = self.pods
                key = (meta.get("namespace") or "default", meta.get("name"))
            idx = k.pool.lookup(key)
            if idx is None:
                return 0
            return int(k.pool.meta[idx].get("rv") or 0)

        def _resync(self, kind: str, objs: list) -> None:
            d = self._proc_integ
            if d is not None:
                # store-restore detection lives here: the parent has no
                # rows, so this lane compares its tracked revisions with
                # the routed snapshot
                for o in objs:
                    meta = o.get("metadata") or {}
                    try:
                        rv = int(meta.get("resourceVersion") or 0)
                    except (TypeError, ValueError):
                        rv = 0
                    if not rv:
                        continue
                    tracked = self._tracked_rv(kind, o)
                    if tracked and rv < tracked:
                        d["rewind"] = d.get("rewind", 0) + 1
                        break
            if kind == "nodes":
                # tap hygiene: unowned nodes that vanished while a stream
                # was down get no DELETED broadcast; prune them here (the
                # owning lane's rows are pruned by the super() walk)
                seen = {(o.get("metadata") or {}).get("name") for o in objs}
                for name in [
                    nm for nm in self.node_has
                    if nm not in seen and not self._node_owned(nm)
                ]:
                    self.node_has.discard(name)
                    self._update_pods_on_node(name)
            super()._resync(kind, objs)

        def _ingest_safe(self, kind, type_, obj) -> None:
            if type_ != "RAWB":
                super()._ingest_safe(kind, type_, obj)
                return
            # one routed window on its own (the tick loop drains windows
            # through _drain_apply): one batched parse on this core;
            # corrupt routed bytes are quarantined and upcalled
            # (_integrity_resync above) by the record path
            raw_buf: dict = {}
            self._drain_apply((kind, type_, obj, time.monotonic()), raw_buf)
            self._drain_flush(raw_buf)

    return _ProcLaneEngine


def _make_lane_engine(spec: dict):
    """Build the lane process's single-lane engine. Its device is the
    pickled config's: a "cuda" lane on a host without a card raises (the
    process exits, the supervisor charges the restart budget); it never
    carries on on the CPU."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    index = spec["index"]
    n = spec["n"]
    cls = make_proc_lane_engine_class()
    # the child's shard-scoped audit interval is the parent's RESOLVED
    # one; anything else (an inherited KWOK_TPU_AUDIT_INTERVAL included)
    # is forced off with -1: the parent's resolution is the one source
    audit = float(spec.get("audit_interval") or 0.0)
    cfg = dataclasses.replace(
        spec["config"],
        lane_procs=False,
        drain_shards=1,  # the child IS one lane
        initial_capacity=spec["capacity"],
        shed_queue_depth=0,  # shedding is the parent router's concern
        # the child owns its tick thread: its own profile window and its
        # own span-ring dump (<parent dump>.lane<i>, written by stop() on
        # STOP or SIGTERM)
        profile_dir=spec["profile_dir"],
        trace_dump=spec["trace_dump"],
        # the plane the parent derived for this lane (child_spec_text);
        # "off" builds none even under an inherited KWOK_TPU_FAULTS
        faults=spec.get("faults") or "off",
        audit_interval=audit if audit > 0 else -1.0,
    )
    e = cls(HttpKubeClient(**spec["client"]), cfg)
    e._lane_index = index
    e._lane_n = n
    e._proc_integ = {"nodes": 0, "pods": 0, "rewind": 0}
    e._ckpt_name = f"lane{index}"
    # disjoint per-lane sub-ranges of the pod CIDR: no cross-process
    # allocator lock, and a respawn re-derives the same range (IPs pinned
    # by re-listed pods still ride IPPool.use)
    e.ippool.partition_lanes(index, n)
    return e


def lane_proc_main(spec: dict, conn) -> None:
    """Lane process entry point (the spawn target; module-level so the
    spawn pickle is a path, not state). Runs the lane's single-lane
    engine; the main thread reads the parent's descriptor pipe."""
    logging.basicConfig(
        level=spec.get("log_level", logging.WARNING),
        format=f"%(asctime)s lane{spec['index']} %(levelname)s %(name)s: %(message)s",
    )
    from kwok_tpu_torch.edge.kubeclient import ADDED
    from kwok_tpu_torch.ops.cuda_tick import tick_steps

    ring = shm_mod.RawRing(spec["ring"])
    slot = shm_mod.InflightSlot(spec["slot"])
    bank = shm_mod.StatusBank(spec["bank"])
    mbank = shm_mod.MetricsBank(spec["metrics"])
    row = bank.row(spec["index"])
    row[shm_mod.BANK_PID] = os.getpid()
    row[shm_mod.BANK_ALIVE_NS] = time.monotonic_ns()
    e = _make_lane_engine(spec)
    # the lane's own fault plane (None unless the parent derived one):
    # shm.torn and shm.stall inject here, on the surfaces this process
    # owns; its client, pumps and clock are already wrapped
    plane = e._faults
    guard = e.client = e._slot_guard = _SlotGuardClient(slot, e.client, plane)
    e._pump_wrap = lambda p: _SlotGuardPump(guard, p)
    received = 0
    stop_status = threading.Event()
    # descriptors the bounds gate rejected, by reason: absent from the
    # exposition until the first reject
    desc_rejects = e.registry.counter(
        "kwok_shm_desc_rejects_total",
        "Ring descriptors rejected by a lane child's bounds validation "
        "before any shared-memory dereference (corrupt offset/length/"
        "bounds vector), by reason; each reject also raises an "
        "integrity-doubt upcall so the parent re-lists.",
        ("reason",),
    )

    def publish_metrics() -> None:
        """The lane's whole metrics state into its seqlock slab: the
        labeled registry, this process's error counters, the flat
        counters, the device, the kernel's launch count and the row
        capacities."""
        try:
            doc = {
                "engine": e.registry.snapshot(),
                "process": PROCESS_REGISTRY.snapshot(),
                "flat": e.metrics,
                "device": e.device.type,
                "launches": tick_steps.launches,
                "capacities": [e.nodes.capacity, e.pods.capacity],
            }
            payload = json.dumps(doc).encode()
            if plane is not None and plane.decide("shm.torn") is not None:
                # the writer "dies" mid-slab: an odd stamp and half a
                # payload; readers back off, the next write restamps
                plane.record("shm.torn")
                mbank.torn_write(payload)
                return
            mbank.write(payload)
        except Exception:
            swallowed("proclanes.metrics_publish")

    def status_loop() -> None:
        beats = 0
        while not stop_status.wait(0.05):
            row[shm_mod.BANK_ALIVE_NS] = time.monotonic_ns()
            row[shm_mod.BANK_READY] = int(e.ready)
            sp = e._startup_pending
            row[shm_mod.BANK_RESYNC] = (
                3 if sp is None
                else (0 if "nodes" in sp else 1) | (0 if "pods" in sp else 2)
            )
            row[shm_mod.BANK_NODES] = len(e.nodes.pool)
            row[shm_mod.BANK_PODS] = len(e.pods.pool)
            row[shm_mod.BANK_QDEPTH] = e._q.qsize()
            row[shm_mod.BANK_EVENTS] = received
            integ = e._proc_integ
            row[shm_mod.BANK_INTEG_NODES] = integ["nodes"]
            row[shm_mod.BANK_INTEG_PODS] = integ["pods"]
            row[shm_mod.BANK_REWIND] = integ["rewind"]
            # drift upcall: the shard-scoped auditor degrades the CHILD on
            # an unrepaired-divergence streak; the parent mirrors the flag
            # into its own /readyz (the operator's surface is the parent's)
            row[shm_mod.BANK_DRIFT] = int("drift" in e._degradation.reasons)
            beats += 1
            if beats % _METRICS_EVERY_BEATS == 0:
                publish_metrics()

    def _on_sigterm(signum, frame):
        # graceful external stop: unwind through finally (engine.stop()
        # drains the patches and writes the final checkpoint)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_sigterm)
    rc = 0
    status_thread = None
    try:
        e.start(spawn_watches=False)
        status_thread = spawn_worker(status_loop, name="kwok-lane-status")
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                # the parent died: stop cleanly (final checkpoint included)
                logger.warning("lane %d: parent pipe closed", spec["index"])
                break
            t = time.monotonic()
            op = msg[0]
            if op == "STOP":
                break
            if op == "RAWB":
                _op, kind, off, ln, bounds = msg
                bad = _desc_check(kind, off, ln, bounds, ring.cap,
                                  int(ring.arena.hdr[shm_mod.RawRing.W]))
                if bad is not None:
                    # never dereferenced: the skipped bytes retire when the
                    # next good read sets the read cursor, and the upcall
                    # makes the parent re-list the kind
                    desc_rejects.labels(reason=bad).inc()
                    logger.warning("lane %d: rejected %s descriptor (%s)",
                                   spec["index"], kind, bad)
                    for k in (kind,) if kind in _KINDS else _KINDS:
                        e._integrity_resync(k)
                    continue
                if plane is not None:
                    stall = plane.decide("shm.stall")
                    if stall is not None:
                        # wedge ring consumption: the parent's router fills
                        # the ring and takes its drop+re-list path
                        plane.record("shm.stall")
                        time.sleep(stall.arg or (_RING_STALL_S + 1.0))
                e._q.put((kind, "RAWB", (ring.read(off, ln), bounds), t))
                received += len(bounds) - 1
            elif op == "FAULTSOFF":
                # the parent cleared its own rates and asks every lane to
                # do the same (a convergence check runs fault-free)
                if plane is not None:
                    plane.spec.rates.clear()
            elif op == "EV":
                _op, kind, type_, obj = msg
                e._q.put((kind, type_, obj, t))
                received += 1
            elif op == "RESYNC":
                # a re-list: its objects, then the prune (the single-lane
                # engine's watch loop order)
                _op, kind, objs = msg
                for o in objs:
                    e._q.put((kind, ADDED, o, t))
                e._q.put((kind, "RESYNC", objs, t))
            else:
                logger.warning("lane %d: unknown message %r", spec["index"], op)
    except SystemExit:
        logger.info("lane %d: SIGTERM, stopping", spec["index"])
    except BaseException:
        logger.exception("lane %d failed", spec["index"])
        rc = 1
    finally:
        stop_status.set()
        try:
            e.stop()
            if e._stream is not None:
                e._stream.synchronize()
        except Exception:
            logger.exception("lane %d: stop failed", spec["index"])
            rc = rc or 1
        if status_thread is not None:
            status_thread.join(timeout=2.0)
        # the final snapshot, after the status thread (the slab has one
        # writer): a stopped lane's last counters survive for the parent
        publish_metrics()
        try:
            conn.close()
        except OSError:
            swallowed("proclanes.child_conn_close")
        for arena in (ring, slot, bank, mbank):
            arena.close()
    os._exit(rc)  # skip atexit handlers: the engine is already stopped


# -------------------------------------------------------------- parent side


def _garble_desc(plane, off: int, ln: int, bounds: list, cap: int):
    """One seeded descriptor corruption (``shm.desc_garble``), in one of
    the three shapes a hostile pipe produces: a length past the ring, an
    offset past the published window, a bounds vector that disagrees with
    the length. The child's bounds gate must catch every shape before it
    touches shared memory. ``bounds`` is not changed in place."""
    rng, lock = plane._streams["shm.desc_garble"]
    with lock:
        shape = rng.randrange(3)
        jitter = rng.randrange(1, 1 << 20)
    if shape == 0:
        return off, cap + jitter, bounds
    if shape == 1:
        return off + cap + jitter, ln, bounds
    garbled = list(bounds)
    garbled[-1] = garbled[-1] + jitter
    return off, ln, garbled


class ProcLane:
    """Parent-side handle of one lane process: its arenas, its descriptor
    pipe and the live Process."""

    def __init__(self, index: int, ring: shm_mod.RawRing,
                 slot: shm_mod.InflightSlot, mbank: shm_mod.MetricsBank):
        self.index = index
        self.ring = ring
        self.slot = slot
        self.mbank = mbank
        # dead incarnations' final metrics, folded: {"engine": snapshot,
        # "process": snapshot, "flat": counters, "launches": n}
        self.retired: dict = {}
        self.proc = None
        self.conn = None
        self.dead = False  # budget exhausted: no more respawns
        self.shedding = False  # router shedding past --shed-queue-depth
        self.restarts = 0

    @property
    def name(self) -> str:
        return f"kwok-lane{self.index}"

    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()

    def sigkill(self) -> bool:
        """SIGKILL the lane process (the supervisor's wedged-lane arm,
        and tests)."""
        p = self.proc
        if p is None or not p.is_alive() or p.pid is None:
            return False
        try:
            os.kill(p.pid, signal.SIGKILL)
            return True
        except OSError:
            return False

    def sigstop(self) -> bool:
        """SIGSTOP the lane process (the fault plane's ``lane.sigstop``:
        wedged but alive; the supervisor's stall kill recovers it)."""
        p = self.proc
        if p is None or not p.is_alive() or p.pid is None:
            return False
        try:
            os.kill(p.pid, signal.SIGSTOP)
            return True
        except OSError:
            return False


class ProcLaneSet:
    """The parent's side of the process lanes: the router, the
    supervisor, the status coordinator and the lifecycle of the lane
    processes and their arenas."""

    def __init__(self, parent, n: int):
        self.parent = parent
        self.n = int(n)
        master = getattr(parent.client, "server", "")
        if not (isinstance(master, str) and master.startswith("http")):
            raise ValueError(
                "process lanes need an HTTP --master (lane processes open "
                "their own client connections); got "
                f"{type(parent.client).__name__}"
            )
        self._master = master
        # per-lane row budget: the threaded lanes' split (even share plus
        # 25% slack for crc32's spread), floored at 1,024 rows
        self.capacity = max(
            1024, -(-int(parent.config.initial_capacity) * 5 // (4 * self.n))
        )
        self._ctx = None  # spawn context, built in prepare()
        self.lanes: list[ProcLane] = []
        self.bank: "shm_mod.StatusBank | None" = None
        # per-(lane, kind) raw lines of the current window (router only)
        self._buf: dict[tuple[int, str], list] = {}
        self._shed_depth = int(parent.config.shed_queue_depth)
        self._closing = False
        self._respawning = False
        # guards lane handle swaps (respawn against close); never held
        # across a spawn, a join or I/O
        self._proc_lock = threading.Lock()
        # serializes slab reads against the respawn fold, so a scrape
        # never counts a lane's final counters both live and retired
        self._mbank_lock = threading.Lock()
        r = parent.registry
        self._m_restarts = r.counter(
            "kwok_lane_proc_restarts_total",
            "Lane process respawns by the supervisor (SIGKILL, crash), by "
            "shard.",
            ("shard",),
        )
        self._m_stall_kills = r.counter(
            "kwok_lane_stall_kills_total",
            "Wedged-but-alive lane processes SIGKILLed by the supervisor "
            "because their 50 ms StatusBank beat went older than 60 s, by "
            "shard.",
            ("shard",),
        )
        self._m_handoff = r.histogram(
            "kwok_lane_handoff_seconds",
            "Router wall seconds per handoff to a lane process: the ring "
            "write plus the descriptor send for one lane's slice of a "
            "window.",
        ).child
        self._m_arena = r.gauge(
            "kwok_shm_arena_bytes",
            "Bytes of shared memory per arena pool (ring = raw event "
            "handoff, slot = emit crash-replay, status = lane status bank, "
            "metrics = per-lane metrics slabs).",
            ("pool",),
        )
        # the router is the native partitioned parse's consumer here, so
        # it owns the per-lane routed-event counter of the threaded lanes
        routed = r.counter(
            "kwok_route_partition_events_total",
            _ENGINE_HELP["kwok_route_partition_events_total"], ("shard",),
        )
        self._m_routed = [routed.labels(shard=str(i)) for i in range(self.n)]

    # ------------------------------------------------------------ lifecycle

    def prepare(self) -> None:
        """Build the tick kernel's library (a CUDA engine), create the
        shared-memory arenas and spawn every lane process. An arena that
        cannot be created raises: there is no fallback to threaded
        lanes."""
        import multiprocessing as mp

        if self.parent.device.type == "cuda":
            # nvcc once here, before any lane exists (no CUDA context is
            # made for it): the lane processes only load the library
            from kwok_tpu_torch.ops.cuda_tick import build_library

            build_library()
        if native.enabled():
            native.load()  # g++ once here too: the lanes only load it
        self._ctx = mp.get_context("spawn")
        tag = str(os.getpid())
        made: list = []
        try:
            self.bank = shm_mod.StatusBank(
                shm_mod.arena_name(f"bank-{tag}"), lanes=self.n, create=True
            )
            made.append(self.bank)
            for i in range(self.n):
                ring = shm_mod.RawRing(
                    shm_mod.arena_name(f"ring{i}-{tag}"), _RING_BYTES, create=True
                )
                made.append(ring)
                slot = shm_mod.InflightSlot(
                    shm_mod.arena_name(f"slot{i}-{tag}"), _SLOT_BYTES, create=True
                )
                made.append(slot)
                mbank = shm_mod.MetricsBank(
                    shm_mod.arena_name(f"metrics{i}-{tag}"), _METRICS_BYTES,
                    create=True,
                )
                made.append(mbank)
                self.lanes.append(ProcLane(i, ring, slot, mbank))
        except OSError as e:
            for arena in made:
                arena.close(unlink=True)
            self.lanes = []
            self.bank = None
            free = _shm_free_bytes()
            raise RuntimeError(
                f"process lanes: cannot create the shared-memory arenas "
                f"({self.arena_bytes()} B for {self.n} lanes; /dev/shm has "
                f"{free} B free): {e}"
            ) from e
        self._m_arena.labels(pool="ring").set(_RING_BYTES * self.n)
        self._m_arena.labels(pool="slot").set(_SLOT_BYTES * self.n)
        self._m_arena.labels(pool="status").set(self.n * shm_mod.BANK_FIELDS * 8)
        self._m_arena.labels(pool="metrics").set(_METRICS_BYTES * self.n)
        for lane in self.lanes:
            self._spawn_lane(lane)
        faults = self.parent._faults
        if faults is not None:
            # each lane process joins the worker.kill and lane.sigstop
            # rotations under its thread-style name (kwok-lane<i>)
            for lane in self.lanes:
                faults.register_proc_target(lane.name, lane.sigkill, lane.sigstop)

    def arena_bytes(self) -> int:
        """Shared memory the arenas take (payloads plus headers)."""
        per_lane = _RING_BYTES + _SLOT_BYTES + _METRICS_BYTES + 3 * 64
        return self.n * (per_lane + shm_mod.BANK_FIELDS * 8) + 64

    def _lane_spec(self, lane: ProcLane) -> dict:
        cfg = self.parent.config
        trace_base = cfg.trace_dump or os.environ.get("KWOK_TPU_TRACE", "")
        return {
            # distinct per-lane files: parent and children each own one
            "trace_dump": f"{trace_base}.lane{lane.index}" if trace_base else "",
            "profile_dir": (
                os.path.join(cfg.profile_dir, f"lane{lane.index}")
                if cfg.profile_dir else ""
            ),
            "index": lane.index,
            "n": self.n,
            "client": self.parent.client.connection_args,
            "config": self.parent.config,
            "capacity": self.capacity,
            "ring": lane.ring.name,
            "slot": lane.slot.name,
            "bank": self.bank.name,
            "metrics": lane.mbank.name,
            "log_level": logging.getLogger().getEffectiveLevel(),
            # the lane's plane: the parent's rates restricted to the kinds
            # a child owns, re-seeded as (seed, lane, kind); "off" when
            # the parent has no plane or nothing survives the filter
            "faults": child_spec_text(
                self.parent._faults.spec if self.parent._faults is not None else None,
                lane.index,
            ),
            # shard-scoped anti-entropy: the parent's RESOLVED interval
            # (0 keeps the child's auditor off through the -1 force)
            "audit_interval": float(self.parent._audit_interval),
        }

    def _spawn_lane(self, lane: ProcLane) -> None:
        # a fresh incarnation starts from a clean status row (its
        # predecessor's resync mask and beat must not count for it)
        self.bank.rows[lane.index, :] = 0
        reader, writer = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(
            target=lane_proc_main,
            args=(self._lane_spec(lane), reader),
            name=lane.name,
            daemon=True,
        )
        proc.start()
        reader.close()  # the child owns the read end now
        with self._proc_lock:
            lane.proc = proc
            lane.conn = writer

    def start_workers(self, threads: list) -> None:
        """The router and the supervisor, both under the watchdog (an
        exception escaping either restarts it in place). The supervisor
        is the recovery mechanism itself, hence its non-lane name."""
        wd = self.parent._watchdog
        threads.append(wd.spawn(self.route_loop, name="kwok-route"))
        threads.append(wd.spawn(self.supervise_loop, name="kwok-proc-super"))

    def close(self) -> None:
        """Graceful stop: STOP every lane (each drains its patches and
        writes its final checkpoint), join, kill what does not stop,
        unlink every arena."""
        with self._proc_lock:
            self._closing = True
        # a respawn racing shutdown must finish its handle swap before the
        # arenas go: a child spawned after the unlink could not attach
        deadline = time.monotonic() + 20.0
        while self._respawning and time.monotonic() < deadline:
            time.sleep(0.05)
        faults = self.parent._faults
        if faults is not None:
            for lane in self.lanes:
                faults.unregister_proc_target(lane.name)
        for lane in self.lanes:
            if lane.conn is not None:
                try:
                    lane.conn.send(("STOP",))
                except (OSError, ValueError):
                    swallowed("proclanes.stop_send")
        deadline = time.monotonic() + 60.0
        for lane in self.lanes:
            p = lane.proc
            if p is None:
                continue
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                logger.warning("lane %d did not stop; killing", lane.index)
                p.kill()
                p.join(timeout=5)
        for lane in self.lanes:
            if lane.conn is not None:
                try:
                    lane.conn.close()
                except OSError:
                    swallowed("proclanes.conn_close")
                lane.conn = None
            lane.ring.close(unlink=True)
            lane.slot.close(unlink=True)
            if lane.mbank is not None:
                # the stopped lane's final snapshot outlives its slab
                self._fold_lane_final(lane)
                with self._mbank_lock:
                    mbank, lane.mbank = lane.mbank, None
                mbank.close(unlink=True)
        if self.bank is not None:
            with self._mbank_lock:
                bank, self.bank = self.bank, None
            bank.close(unlink=True)
        for pool in ("ring", "slot", "status", "metrics"):
            self._m_arena.labels(pool=pool).set(0)

    # --------------------------------------------------------------- router

    def route_loop(self) -> None:
        """Drain the parent's ingest queue in windows of half a tick: the
        window's raw watch lines are parsed in one native call that also
        partitions them (``route_batch``), each lane's lines buffer per
        (lane, kind), and every buffered slice ships at the window's end
        as one ring blob. The revision bookkeeping stays on the parent."""
        parent = self.parent
        q = parent._q
        window = max(0.002, parent.config.tick_interval / 2)
        raw_buf: dict = {}
        try:
            while True:
                try:
                    item = q.get(timeout=0.1)
                except queue.Empty:
                    if not parent._running:
                        return
                    continue
                if item is None:
                    if not parent._running:
                        return
                    continue
                self._route_item(item, raw_buf)
                window_end = time.monotonic() + window
                while True:
                    timeout = window_end - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is None:
                        if not parent._running:
                            break
                        continue
                    self._route_item(item, raw_buf)
                if raw_buf:
                    parent._drain_flush(raw_buf, self.route, self.n)
                self.flush_lanes()
                if not parent._running:
                    return
        finally:
            try:
                if raw_buf:
                    parent._drain_flush(raw_buf, self.route, self.n)
                self.flush_lanes()
            except Exception:
                logger.exception("final router flush failed")

    def _route_item(self, item, raw_buf: dict) -> None:
        """One parent-queue item into the drain: raw lines are counted by
        the flush that parses them, other events (re-lists aside) here."""
        if item[1] not in ("RESYNC", "RAW", "RAWB", "GEN"):
            self.parent.telemetry.inc_kind("watch_events_total", item[0])
        self.parent._drain_apply(item, raw_buf, self.route, self.n)

    def route(self, kind: str, type_: str, obj) -> None:
        """Route one event (the per-record path: KWOK_TPU_NATIVE_ROUTE=0,
        or a window with an ERROR or a nameless record). A record's raw
        line buffers per (lane, kind) until the window flushes; a RESYNC
        snapshot goes over the pipe (nodes to every lane, pods each to its
        own); a decoded event goes pickled over the pipe. Node events
        broadcast."""
        if type_ == "RESYNC":
            for lane in self.lanes:
                objs = obj if kind == "nodes" else [
                    o for o in obj
                    if shard_of(self._pod_key(o), self.n) == lane.index
                ]
                self._flush_buf(lane, kind)
                self._send(lane, ("RESYNC", kind, objs))
            return
        if type_ == "REC":
            if kind == "nodes":
                for lane in self.lanes:
                    self._buf.setdefault((lane.index, kind), []).append(obj.raw)
                return
            key = self._rec_key(obj)
            if key is not None:
                self._buf.setdefault((shard_of(key, self.n), kind), []).append(obj.raw)
            return
        if not isinstance(obj, dict):
            return
        if kind == "nodes":
            targets = self.lanes
        else:
            key = self._pod_key(obj)
            if not key[1]:
                return
            targets = (self.lanes[shard_of(key, self.n)],)
        for lane in targets:
            if self._shed_check(lane, 1):
                continue
            self._flush_buf(lane, kind)
            self._send(lane, ("EV", kind, type_, obj))

    @staticmethod
    def _rec_key(rec):
        """A pod record's routing key; a record without a usable name is
        routed by its raw line's metadata, or dropped (and counted) when
        that cannot be decoded."""
        if rec.name:
            return (rec.namespace or "default", rec.name)
        try:
            meta = (json.loads(rec.raw).get("object") or {}).get("metadata") or {}
        except Exception:
            swallowed("proclanes.unrouteable_event")
            return None
        if not meta.get("name"):
            return None
        return (meta.get("namespace") or "default", meta["name"])

    def route_batch(self, kind: str, batch) -> None:
        """The pre-partitioned handoff: each lane's raw lines, gathered
        from its index run, ship as ONE ring blob. A node batch goes whole
        to every lane (the tap needs the whole node stream)."""
        t0 = time.perf_counter()
        lines = batch.lines
        if kind == "nodes":
            parts = [lines[i] for i in batch.lane_idx[: batch.route_info.routable].tolist()]
            for lane in self.lanes:
                self._flush_buf(lane, kind)
                self._ship(lane, kind, parts)
                self._m_routed[lane.index].inc(len(parts))
        else:
            lane_off = batch.lane_off
            lane_idx = batch.lane_idx
            for li in range(len(lane_off) - 1):
                lo, hi = lane_off[li], lane_off[li + 1]
                if hi <= lo:
                    continue
                lane = self.lanes[li]
                parts = [lines[i] for i in lane_idx[lo:hi].tolist()]
                self._flush_buf(lane, kind)
                self._ship(lane, kind, parts)
                self._m_routed[li].inc(len(parts))
        self.parent.telemetry.observe_route_batch(time.perf_counter() - t0)

    def flush_lanes(self) -> None:
        """Window end: ship every buffered (lane, kind) slice."""
        for (li, kind) in list(self._buf):
            self._flush_buf(self.lanes[li], kind)

    def _flush_buf(self, lane: ProcLane, kind: str) -> None:
        parts = self._buf.pop((lane.index, kind), None)
        if parts:
            self._ship(lane, kind, parts)

    def _ship(self, lane: ProcLane, kind: str, parts: list) -> None:
        """One (lane, kind) slice onto the lane's ring and pipe: the bytes
        are copied into shared memory once, the descriptor carries only
        offsets. A slice bigger than half the ring splits along record
        bounds (a blob wider than half the ring can be unwritable from an
        unlucky cursor position even with the ring drained). A full ring
        paces briefly, then, if the child is dead or wedged past the
        stall bound, drops the slice (counted) and schedules a re-list."""
        if self._shed_check(lane, len(parts)):
            return
        limit = lane.ring.cap // 2
        total = sum(len(p) for p in parts)
        if total > limit:
            chunk: list = []
            size = 0
            for p in parts:
                if len(p) > limit:
                    # undeliverable over this ring: the re-list re-delivers
                    # the object's current state
                    self.parent._inc("dropped_jobs_total")
                    logger.warning(
                        "lane %d: %s record of %d B exceeds the %d B ring "
                        "bound; dropped", lane.index, kind, len(p), limit,
                    )
                    self.parent._integrity_resync(kind)
                    continue
                if size + len(p) > limit:
                    self._ship(lane, kind, chunk)
                    chunk, size = [], 0
                chunk.append(p)
                size += len(p)
            if chunk:
                self._ship(lane, kind, chunk)
            return
        t0 = time.perf_counter()
        bounds = [0]
        for p in parts:
            bounds.append(bounds[-1] + len(p))
        blob = b"".join(parts)
        deadline = time.monotonic() + _RING_STALL_S
        off = lane.ring.try_write(blob)
        while off is None:
            if self._closing or not lane.alive() or time.monotonic() >= deadline:
                self.parent._inc("dropped_jobs_total", len(parts))
                logger.warning(
                    "lane %d ring full (%s): dropped %d events", lane.index,
                    "dead child" if not lane.alive() else "stalled child",
                    len(parts),
                )
                if not self._closing:
                    # an alive-but-slow child never respawns: the drop
                    # itself must schedule the re-list
                    self.parent._integrity_resync(kind)
                return
            time.sleep(0.001)
            off = lane.ring.try_write(blob)
        faults = self.parent._faults
        if faults is not None:
            if faults.decide("shm.desc_drop") is not None:
                # the descriptor dies between the ring write and the pipe
                # send: its bytes retire when the child's next good read
                # sets the read cursor, and the drop schedules the re-list
                # (the ring-stall drop's recovery)
                faults.record("shm.desc_drop")
                self.parent._inc("dropped_jobs_total", len(parts))
                self.parent._integrity_resync(kind)
                return
            if faults.decide("shm.desc_garble") is not None:
                faults.record("shm.desc_garble")
                off, ln, bounds = _garble_desc(
                    faults, off, len(blob), bounds, lane.ring.cap
                )
                self._send(lane, ("RAWB", kind, off, ln, bounds))
                self._m_handoff.observe(time.perf_counter() - t0)
                return
        self._send(lane, ("RAWB", kind, off, len(blob), bounds))
        self._m_handoff.observe(time.perf_counter() - t0)

    def _lane_qdepth(self, lane: ProcLane) -> int:
        bank = self.bank
        rows = bank.rows if bank is not None else None
        if rows is None:
            return 0
        return int(rows[lane.index, shm_mod.BANK_QDEPTH])

    def _shed_check(self, lane: ProcLane, n: int) -> bool:
        """The parent's twin of LaneSet._shed: sheds ``n`` routed events
        while the child's ingest queue (its StatusBank row) is deeper than
        --shed-queue-depth: counted in kwok_dropped_jobs_total, degraded
        as lane<N>_queue. The coordinator clears it and re-lists once the
        backlog halves."""
        if not self._shed_depth or self._lane_qdepth(lane) <= self._shed_depth:
            return False
        self.parent._inc("dropped_jobs_total", n)
        lane.shedding = True
        if self.parent._degradation.set(f"lane{lane.index}_queue"):
            logger.warning(
                "lane %d queue past %d: shedding routed events (engine "
                "degraded)", lane.index, self._shed_depth,
            )
        return True

    def _send(self, lane: ProcLane, msg) -> None:
        conn = lane.conn
        if conn is None:
            return
        try:
            conn.send(msg)
        except (OSError, ValueError):
            # a dead child mid-send: the supervisor owns recovery
            swallowed("proclanes.send_dead_lane")

    def quiesce_child_faults(self) -> None:
        """Clear every lane process's fault rates over its pipe
        (``FAULTSOFF``); the caller clears the parent's own. A convergence
        check then runs fault-free on both sides of the boundary."""
        for lane in self.lanes:
            self._send(lane, ("FAULTSOFF",))

    @staticmethod
    def _pod_key(obj: dict):
        meta = obj.get("metadata") or {}
        return (meta.get("namespace") or "default", meta.get("name") or "")

    # ----------------------------------------------------------- supervisor

    def supervise_loop(self) -> None:
        """A lane process that exits without a STOP crashed: charge the
        watchdog's restart budget, replay its emit slot, respawn it and
        re-list the streams so the re-list re-delivers whatever died with
        it. Budget exhaustion degrades the engine. A live lane whose beat
        is older than the stall bound is wedged: it is killed, and the
        next poll respawns it."""
        parent = self.parent
        while parent._running and not self._closing:
            time.sleep(_SUPER_POLL_S)
            for lane in self.lanes:
                if self._closing or not parent._running:
                    return
                p = lane.proc
                if p is None or lane.dead:
                    continue
                if p.is_alive():
                    bank = self.bank
                    rows = bank.rows if bank is not None else None
                    if rows is None:
                        continue
                    beat = int(rows[lane.index, shm_mod.BANK_ALIVE_NS])
                    if beat and time.monotonic_ns() - beat > _STALL_NS:
                        logger.warning(
                            "lane %d wedged (no status beat for %.0f s); "
                            "killing for respawn", lane.index, _STALL_NS / 1e9,
                        )
                        if lane.sigkill():
                            self._m_stall_kills.labels(shard=str(lane.index)).inc()
                            parent._degradation.set(f"lane{lane.index}_stalled")
                    continue
                logger.warning("lane %d process died (exit %s)",
                               lane.index, p.exitcode)
                worker_crashed(lane.name)
                wd = parent._watchdog
                if wd is not None and not wd.charge(lane.name):
                    lane.dead = True
                    parent._worker_budget_exhausted(lane.name)
                    continue
                self._respawn(lane)

    def _respawn(self, lane: ProcLane) -> None:
        with self._proc_lock:
            if self._closing:
                return  # close() owns the endgame
            self._respawning = True
        try:
            self._do_respawn(lane)
        finally:
            self._respawning = False

    def _do_respawn(self, lane: ProcLane) -> None:
        # 1. replay the emit slot BEFORE the new child can emit anything:
        #    at least once, ahead of post-respawn traffic (the no-op
        #    check absorbs duplicates)
        payload = lane.slot.peek()
        if payload is not None:
            try:
                self._replay_frames(pickle.loads(payload))
                lane.slot.clear()
            except Exception:
                logger.exception(
                    "lane %d: in-flight replay failed (the re-list still "
                    "covers it)", lane.index,
                )
        # 2. unread ring bytes died with the child's descriptors
        lane.ring.reset()
        # 3. fold the dead incarnation's last snapshot so the merged
        #    counters stay monotonic while the fresh child restarts at 0
        self._fold_lane_final(lane)
        if lane.conn is not None:
            try:
                lane.conn.close()
            except OSError:
                swallowed("proclanes.respawn_conn_close")
        # 4. respawn and account
        self._spawn_lane(lane)
        lane.restarts += 1
        self._m_restarts.labels(shard=str(lane.index)).inc()
        self.parent._degradation.clear(f"lane{lane.index}_stalled")
        worker_restarted(lane.name)
        logger.warning("lane %d respawned (pid %s)", lane.index, lane.proc.pid)
        # 5. only a full list+RESYNC re-delivers what the dead process
        #    took with it
        self.parent.resync_streams()

    def _replay_frames(self, requests: list) -> None:
        """Send a dead lane's parked patches from the parent: plain HTTP,
        one connection, in order. Status codes are advisory: a 4xx means
        the object moved on, which the re-list's repair path owns."""
        if not requests:
            return
        from urllib.parse import urlsplit

        u = urlsplit(self._master)
        if u.scheme == "https":
            conn = http.client.HTTPSConnection(
                u.hostname, u.port or 443, timeout=10,
                context=getattr(self.parent.client, "_ctx", None),
            )
        else:
            conn = http.client.HTTPConnection(u.hostname, u.port or 80, timeout=10)
        headers = {}
        token = getattr(self.parent.client, "token", None)
        if token:
            headers["Authorization"] = f"Bearer {token}"
        try:
            for method, path, body, ctype in requests:
                conn.request(method, path, body=bytes(body),
                             headers={**headers, "Content-Type": ctype})
                conn.getresponse().read()
        finally:
            conn.close()

    # ---------------------------------------------------------- coordinator

    def coordinator_loop(self) -> None:
        """The engine's kwok-tick thread under process lanes: no device
        work in the parent. At the tick cadence it reads the StatusBank
        into the gauges and the startup gate, and turns the lanes'
        healing upcalls into re-lists."""
        parent = self.parent
        interval = max(0.02, parent.config.tick_interval)
        seen_integ = {(kind, i): 0 for kind in _KINDS for i in range(self.n)}
        seen_rewind = [0] * self.n
        seen_gen = [0] * self.n
        while parent._running:
            time.sleep(interval)
            bank = self.bank
            rows = bank.rows if bank is not None else None
            if rows is None:
                continue
            tel = parent.telemetry
            tel.set_gauge("nodes_managed", int(rows[:, shm_mod.BANK_NODES].sum()))
            tel.set_gauge("pods_managed", int(rows[:, shm_mod.BANK_PODS].sum()))
            tel.set_gauge("ingest_queue_depth", max(
                parent._q.qsize(), int(rows[:, shm_mod.BANK_QDEPTH].max())))
            if parent._startup_pending is not None:
                # ready once every lane has ingested its first re-list of
                # both kinds (its own startup gate closed)
                for lane in self.lanes:
                    mask = int(rows[lane.index, shm_mod.BANK_RESYNC])
                    if mask & 1:
                        parent._mark_resync("nodes", lane.index)
                    if mask & 2:
                        parent._mark_resync("pods", lane.index)
                parent._ckpt_gate(dispatched=True, staged=False)
            for lane in self.lanes:
                i = lane.index
                if lane.restarts != seen_gen[i]:
                    # a respawned child's counters restart at zero
                    seen_gen[i] = lane.restarts
                    for kind in _KINDS:
                        seen_integ[(kind, i)] = 0
                    seen_rewind[i] = 0
                for kind, field in (("nodes", shm_mod.BANK_INTEG_NODES),
                                    ("pods", shm_mod.BANK_INTEG_PODS)):
                    v = int(rows[i, field])
                    if v > seen_integ[(kind, i)]:
                        seen_integ[(kind, i)] = v
                        parent._integrity_resync(kind)
                v = int(rows[i, shm_mod.BANK_REWIND])
                if v > seen_rewind[i]:
                    seen_rewind[i] = v
                    logger.warning(
                        "lane %d saw a re-list rv rewind (store restore); "
                        "re-listing every stream", i,
                    )
                    parent._inc("rv_rewinds_total")
                    parent.resync_streams()
            # drift mirror: a lane whose auditor holds an unrepaired
            # divergence streak publishes BANK_DRIFT=1, and the parent
            # degrades on "drift" as the single-process auditor would; it
            # clears once every lane's streak has healed
            if any(int(rows[lane.index, shm_mod.BANK_DRIFT]) for lane in self.lanes):
                if parent._degradation.set("drift"):
                    logger.warning(
                        "lane auditor reported an unrepaired-divergence "
                        "streak; engine degraded (drift)"
                    )
            elif parent._degradation.clear("drift"):
                logger.info("lane drift repaired; degraded reason cleared")
            if self._shed_depth:
                self._shed_clear()

    def _shed_clear(self) -> None:
        """Backlog halved: clear the lane's degraded reason and re-list
        (shed events are gone; only the full re-list re-delivers them),
        at most once per _SHED_RESYNC_MIN_S."""
        from kwok_tpu_torch.engine.lanes import _SHED_RESYNC_MIN_S

        parent = self.parent
        for lane in self.lanes:
            if not lane.shedding or self._lane_qdepth(lane) * 2 > self._shed_depth:
                continue
            now = time.monotonic()
            if now - parent._shed_resync_at < _SHED_RESYNC_MIN_S:
                continue
            parent._shed_resync_at = now
            lane.shedding = False
            if parent._degradation.clear(f"lane{lane.index}_queue"):
                logger.info(
                    "lane %d drained below shed threshold; re-listing to "
                    "re-deliver shed events", lane.index,
                )
                parent.resync_streams()

    # ------------------------------------------------------------- readouts

    def _lane_doc(self, lane: ProcLane) -> "dict | None":
        """One consistent metrics snapshot off a lane's slab (None before
        its first publish). Caller holds _mbank_lock."""
        if lane.mbank is None:
            return None
        raw = lane.mbank.read()
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def _fold_lane_final(self, lane: ProcLane) -> None:
        """Fold a dying or stopped incarnation's last snapshot into the
        lane's retired accumulator and empty the slab, under _mbank_lock
        so a concurrent scrape never counts it twice."""
        from kwok_tpu_torch.telemetry.registry import fold_snapshot

        with self._mbank_lock:
            doc = self._lane_doc(lane)
            if doc is None:
                return
            lane.mbank.reset()
            acc = lane.retired
            for part in ("engine", "process"):
                if doc.get(part):
                    acc[part] = fold_snapshot(acc.get(part), doc[part])
            flat = acc.setdefault("flat", {})
            for k, v in (doc.get("flat") or {}).items():
                if _is_counter(k):
                    flat[k] = flat.get(k, 0) + v
            acc["launches"] = acc.get("launches", 0) + int(doc.get("launches") or 0)

    def _docs(self) -> list:
        """(lane, live doc or None) for every lane, under _mbank_lock."""
        with self._mbank_lock:
            return [(lane, self._lane_doc(lane)) for lane in self.lanes]

    def merged_flat(self, own: dict) -> dict:
        """The parent's flat counters with every lane's added in: lane
        counters sum (retired incarnations included), the lane gauges in
        ``_SUM_FLAT_GAUGES`` sum over the live lanes and the others take
        the worst live lane's value; the parent's own watch counters and
        StatusBank gauges stand."""
        out = dict(own)
        for lane, doc in self._docs():
            for k, v in (lane.retired.get("flat") or {}).items():
                if k not in _PARENT_FLAT:  # retired: counters only
                    out[k] = out.get(k, 0) + v
            for k, v in ((doc or {}).get("flat") or {}).items():
                if k in _PARENT_FLAT:
                    continue
                if _is_counter(k) or k in _SUM_FLAT_GAUGES:
                    out[k] = out.get(k, 0) + v
                else:
                    out[k] = max(out.get(k, 0), v)
        return out

    def merged_metrics_text(self) -> str:
        """The labeled families for ``/metrics``: the parent's registry
        plus every lane's snapshot in ONE scratch registry (one TYPE
        line per family), lane stages label-split per shard, retired
        incarnations keeping the sums monotonic."""
        from kwok_tpu_torch.telemetry.lanes import merge_proc_lane_metrics

        live: dict = {}
        retired: dict = {}
        for lane, doc in self._docs():
            if doc and doc.get("engine"):
                live[lane.index] = doc["engine"]
            if lane.retired.get("engine"):
                retired[lane.index] = lane.retired["engine"]
        depths: dict = {}
        bank = self.bank
        rows = bank.rows if bank is not None else None
        if rows is not None:
            for lane in self.lanes:
                depths[lane.index] = int(rows[lane.index, shm_mod.BANK_QDEPTH])
        reg = merge_proc_lane_metrics(
            self.parent.registry.snapshot(), live, retired, self.n,
            queue_depths=depths,
        )
        return reg.render()

    def merged_process_text(self) -> str:
        """The process-wide error counters with every lane's share added
        in, rendered once so each family keeps one TYPE line."""
        from kwok_tpu_torch.telemetry.registry import (
            family_from_doc,
            merge_child,
            registry_from_snapshot,
        )

        reg = registry_from_snapshot(PROCESS_REGISTRY.snapshot())
        snaps = []
        for lane, doc in self._docs():
            if doc and doc.get("process"):
                snaps.append(doc["process"])
            if lane.retired.get("process"):
                snaps.append(lane.retired["process"])
        for snap in snaps:
            for name, fdoc in sorted(snap.items()):
                fam = family_from_doc(reg, name, fdoc)
                for values, v in fdoc.get("children", ()):
                    merge_child(fam, values, v)
        text = reg.render()
        return "" if not text.strip() else text

    def status(self) -> list[dict]:
        """Per-lane status rows: liveness, restarts, readiness and row
        counts from the StatusBank; the device, the row capacities and
        the kernel launches (retired incarnations included) from the
        metrics slab."""
        out = []
        bank = self.bank
        rows = bank.rows if bank is not None else None
        for lane, doc in self._docs():
            r = rows[lane.index] if rows is not None else None
            doc = doc or {}
            out.append({
                "index": lane.index,
                "alive": lane.alive(),
                "pid": lane.proc.pid if lane.proc is not None else None,
                "restarts": lane.restarts,
                "ready": bool(r is not None and r[shm_mod.BANK_READY]),
                "nodes": int(r[shm_mod.BANK_NODES]) if r is not None else 0,
                "pods": int(r[shm_mod.BANK_PODS]) if r is not None else 0,
                "device": doc.get("device"),
                "capacities": doc.get("capacities"),
                "launches": int(doc.get("launches") or 0)
                + lane.retired.get("launches", 0),
            })
        return out


def _shm_free_bytes() -> "int | None":
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return None
    return st.f_bavail * st.f_frsize
