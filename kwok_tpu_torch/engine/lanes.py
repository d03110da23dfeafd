"""Hash-partitioned host lanes: the threaded drain+emit pipeline (the port
of ``kwok_tpu.engine.lanes``).

  watch threads ──> ingest queue ──> router (hash by key)
                                       │
                       ┌───────────────┼──────────────┐
                       ▼               ▼              ▼
                    lane 0          lane 1   ...   lane N-1
                 drain worker    drain worker     drain worker
                 staged buffer   staged buffer    staged buffer
                       └───────────────┼──────────────┘
                                       ▼
                coordinator tick thread: flush every lane's buffers into
                ONE stacked device state per kind, launch the CUDA tick
                kernel on it, slice the wire per lane (ops/tick.lane_views)
                and hand each slice to
                       ┌───────────────┼──────────────┐
                       ▼               ▼              ▼
                  emit worker     emit worker     emit worker

Lane ``i`` owns rows ``[i*r, (i+1)*r)`` of each stacked state. Only the
coordinator allocates, flushes, launches and reads on the device, all on
the engine's stream; drain and emit workers never touch the device.

Ordering: a key always maps to the same lane (``rowpool.shard_of``), lane
queues are FIFO, and the coordinator hands wire slices to lanes in
consume order, so per-object patch order is exactly the single-lane
engine's (the oracle in tests/test_torch_lanes.py holds it against
kwok_tpu). Cross-lane state is shared: the IP pool under the engine's
``_alloc_lock``, ``node_has``/``pods_by_node`` (single-op mutations), the
engine's ``EngineTelemetry`` (one registry and span ring; each lane's
``LaneTelemetry`` adds the ``kwok_lane_*`` families); a node's managed-ness flip reaches OTHER
lanes' pods as routed ``XUPD`` items through their own queues.

Each lane is a ``ClusterEngine`` without threads, device state or stream
(``_LaneEngine``), so the per-event ingest and emit code runs unchanged.
Each lane's emit has a native pump group of its own (two connection
groups, built in ``prepare`` outside every lock) and shares the parent's
compiled emit templates.

Over HTTP the router parses each window's raw watch lines in ONE native
call (``ClusterEngine._drain_apply``), which also computes every event's
lane; each lane then gets its contiguous index run over the shared
parsed batch as one ``RECB`` item (``route_batch``), instead of one
hashed and queued event at a time. ``KWOK_TPU_NATIVE_ROUTE=0`` keeps the
per-record route.

The router and every lane's drain and emit worker run under the engine's
watchdog (``resilience/watchdog.py``), with the reference's thread names
(``kwok-route``, ``kwok-lane<i>``, ``kwok-emit<i>``): a crashed worker
restarts in place on the same thread against the same queues, and the
engine's ``_worker_restarted_resync`` heals what the crash ate. The lane
engines share the parent's fault plane; they never build one of their
own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import queue
import threading
import time
from collections import deque

import numpy as np

from kwok_tpu_torch.edge.render import now_rfc3339
from kwok_tpu_torch.engine.engine import ClusterEngine, _warm_scatter
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.locks import reclaimable
from kwok_tpu_torch.ops.state import new_row_state, regrow_stacked
from kwok_tpu_torch.ops.tick import (
    REBASE_AFTER,
    gather_deadlines,
    lane_views,
    rebase_times,
    unpack_wire,
)
from kwok_tpu_torch.ops.updates import UpdateBuffer, refine_flush
from kwok_tpu_torch import profiling
from kwok_tpu_torch.resilience import checkpoint as ckpt_mod
from kwok_tpu_torch.telemetry.errors import swallowed

logger = logging.getLogger("kwok_tpu_torch.lanes")

_KINDS = ("nodes", "pods")

# Per-lane row-budget floor: tiny lanes would regrow constantly under any
# real load. Tests shrink it to exercise the mid-run regrow path.
_MIN_LANE_ROWS = 1024

# Minimum seconds between shed-clear stream resyncs (drain_loop): bounds
# the full-LIST rate when a resync's own re-list burst re-trips shedding.
_SHED_RESYNC_MIN_S = 5.0


@dataclasses.dataclass
class _LanePending:
    """A dispatched-but-unconsumed stacked tick."""

    wire: object  # ops.tick.Wire; self-contained
    r: int  # rows per lane AT DISPATCH (regrow may change it)
    cap: int  # stacked capacity at dispatch
    seqs: list  # per-lane release seq at dispatch (stale-mask filter)
    now: float  # engine time of the dispatch
    mono: float  # monotonic clock at dispatch (idle-wake anchor)
    host_s: float  # host seconds spent in the dispatch half


class _ReclaimableQueue(queue.Queue):
    """A ``queue.Queue`` whose mutex (and so its three conditions) is a
    reclaimable lock (``kwok_tpu_torch.locks``): a pill that lands in the
    emit worker inside the queue's own lock does not freeze the
    coordinator's puts."""

    def __init__(self) -> None:
        super().__init__()
        self.mutex = reclaimable()
        self.not_empty = threading.Condition(self.mutex)
        self.not_full = threading.Condition(self.mutex)
        self.all_tasks_done = threading.Condition(self.mutex)


class _LaneEngine(ClusterEngine):
    """A ClusterEngine serving as ONE lane: no threads, stream or device
    rows of its own; the parent's cross-lane state and counters; node
    managed-ness flips routed to sibling lanes."""

    _owns_device = False

    def __init__(self, lane_set: "LaneSet", index: int, config) -> None:
        parent = lane_set.parent
        # ONE telemetry (so /metrics counts every lane's patches and the
        # lanes' spans land in the parent's ring)
        super().__init__(parent.client, config, telemetry=parent.telemetry)
        self._lane_set = lane_set
        self._lane_index = index
        # shared cross-lane state: one IP pool and allocation lock, one
        # topology view, one clock, one degraded-mode ledger
        self.ippool = parent.ippool
        self._alloc_lock = parent._alloc_lock
        self.node_has = parent.node_has
        self.pods_by_node = parent.pods_by_node
        self._epoch = parent._epoch
        self.start_time = parent.start_time
        self._degradation = parent._degradation
        self._stop_evt = parent._stop_evt
        # ONE compiled template table per engine (the lanes' rules are
        # the parent's), shared read-only by every emit worker
        self._codec = parent._codec
        self._emit_tpl = parent._emit_tpl
        self._emit_cols = parent._emit_cols
        # each lane's emit has its own, smaller pump connection group:
        # emit workers never share a pump lock
        self._pump_groups = 2

    def _update_pods_on_node(self, node_name: str) -> None:
        # pods on this node live in OTHER lanes' pools: one XUPD batch per
        # owning lane through its own queue (FIFO per key keeps the update
        # ordered against the pod's own events)
        self._lane_set.route_pod_updates(node_name)

    def _mark_resync(self, kind: str, lane: int = 0) -> None:
        # the startup gate lives on the parent: RESYNC markers broadcast
        # to every lane, and the kind counts once all lanes applied theirs
        self._lane_set.parent._mark_resync(kind, self._lane_index)


class ShardLane:
    """One hash partition of the host pipeline: ingest queue + drain
    worker + staged-row buffers + emit worker."""

    def __init__(self, lane_set: "LaneSet", index: int, capacity: int):
        parent = lane_set.parent
        self.lane_set = lane_set
        self.index = index
        cfg = dataclasses.replace(
            parent.config,
            drain_shards=1,  # lanes never recurse
            initial_capacity=capacity,
            checkpoint_dir="off",  # ONE checkpoint, the parent's stacked
            profile_dir="",  # the coordinator's tick thread profiles
            trace_dump="",  # one dump, the parent's
            faults="off",  # ONE fault plane, the parent's (shared below)
            audit_interval=-1.0,  # ONE auditor, the parent's (env-proof)
        )
        self.engine = _LaneEngine(lane_set, index, cfg)
        # the parent's plane is THE engine-wide one: lane pumps draw from
        # the same seeded decision streams
        self.engine._faults = parent._faults
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        # queue.Queue (not SimpleQueue): the emit worker's replay claim
        # (emit_loop) peeks under the queue's own condition before popping
        self.emit_q: "queue.Queue" = _ReclaimableQueue()
        # guards this lane's staged buffers, pool growth and release log:
        # held by the drain worker while applying, by the coordinator while
        # swapping buffers / growing, by the emit worker while it emits
        self.stage_lock = reclaimable()
        # set by the coordinator while it waits for stage_lock: a drain
        # burst ends early and yields it (the lock is not fair: a drain
        # worker that releases and re-takes it while its queue holds a
        # re-list can keep the coordinator out for as long as the flood
        # lasts, and no tick runs meanwhile)
        self.swap_waiting = False
        self.telemetry = parent.telemetry.lane(str(index))
        # the router sheds into kwok_dropped_jobs_total while this queue
        # is deeper than this (0 = never); the drain worker clears the
        # flag once the backlog halves
        self._shed_depth = int(parent.config.shed_queue_depth)
        self.shedding = False
        # emit replay slot (see emit_loop): the item being processed
        self._emit_inflight = None

    # --------------------------------------------------------------- drain

    # max items applied per stage_lock hold: bounds how long a flood can
    # keep the coordinator from swapping this lane's buffers
    _BURST = 4096

    def _apply_item(self, item) -> int:
        """Apply one routed queue item; returns the event count it carried
        (a RECB sub-batch weighs its record count, so the stage_lock hold
        stays bounded as on the per-event path)."""
        e = self.engine
        if item[1] == "RECB":
            # this lane's contiguous index run over a shared parsed batch
            batch, idx, lo, hi = item[2]
            return e._ingest_record_batch(item[0], batch, idx, lo, hi)
        if item[1] == "XUPD":
            # managed-ness re-evaluation for pods this lane owns, routed
            # from a sibling lane's node event
            k = e.pods
            for key in item[2]:
                idx = k.pool.lookup(key)
                if idx is None:
                    continue
                m = k.pool.meta[idx]
                k.buffer.stage_update(idx, e._pod_bits(m), m.get("has_del", False))
            return len(item[2])
        try:
            e._apply(item[0], item[1], item[2])
        except Exception:  # one malformed event must not kill the lane
            logger.exception(
                "lane %d ingest failed for %s %s", self.index, item[0], item[1]
            )
        return 1

    def _apply_locked(self, item) -> int:
        """Apply one routed item under the stage_lock. A RECB run longer
        than _BURST (a reconnect flood can put a whole window in one lane)
        goes in _BURST slices, each under a hold of its own, so the
        coordinator's buffer swap waits no longer than on the per-event
        path; per-key order is the slice order."""
        if item[1] == "RECB":
            batch, idx, lo, hi = item[2]
            e = self.engine
            n = 0
            while lo < hi:
                end = min(lo + self._BURST, hi)
                with self.stage_lock:
                    n += e._ingest_record_batch(item[0], batch, idx, lo, end)
                lo = end
                if self.swap_waiting:
                    self._yield_stage()
            return n
        with self.stage_lock:
            return self._apply_item(item)

    _EMPTY = object()  # drain_loop's sentinel: the queue is momentarily dry

    # longest a drain worker waits for a waiting coordinator to take the
    # stage_lock before it goes on
    _YIELD_S = 0.005

    def _yield_stage(self) -> None:
        """Give a waiting coordinator the stage_lock: drop the interpreter
        lock until it has taken the stage lock (bounded by _YIELD_S)."""
        deadline = time.monotonic() + self._YIELD_S
        while self.swap_waiting and time.monotonic() < deadline:
            time.sleep(0)

    def drain_loop(self) -> None:
        q = self.q
        tel = self.telemetry
        empty = self._EMPTY

        def next_item():
            try:
                return q.get_nowait()
            except queue.Empty:
                return empty

        while True:
            item = q.get()
            if item is None:
                return
            stop = False
            t0 = time.perf_counter()
            n = 0
            while item is not empty and not stop:
                if item[1] == "RECB":
                    # sub-batches take their own (sliced) holds; a RECB
                    # ends a burst hold, so its holds never nest in one
                    n += self._apply_locked(item)
                    if n >= self._BURST:
                        item = empty
                    else:
                        item = next_item()
                        stop = item is None
                    continue
                # consecutive per-event items share ONE stage_lock hold
                # (bounded by _BURST)
                with self.stage_lock:
                    while True:
                        n += self._apply_item(item)
                        if n >= self._BURST or self.swap_waiting:
                            item = empty
                            break
                        item = next_item()
                        if item is None:
                            stop = True
                            break
                        if item is empty or item[1] == "RECB":
                            break
            if self.swap_waiting:
                self._yield_stage()
            tel.observe_stage("drain", time.perf_counter() - t0)
            depth = q.qsize()
            tel.set_queue_depth(depth)
            if self._shed_depth and self.shedding and (
                depth * 2 <= self._shed_depth
            ):
                # backlog halved: stop shedding, clear the degraded reason
                # and resync the watch streams — shed events are GONE from
                # the queue, so only a full list+RESYNC re-delivers them.
                # Rate-limited: a re-list burst bigger than the threshold
                # would otherwise re-trip shedding and LIST-storm the
                # apiserver; until the interval passes the lane keeps
                # shedding (still degraded, still counted)
                parent = self.lane_set.parent
                now = time.monotonic()
                if now - parent._shed_resync_at >= _SHED_RESYNC_MIN_S:
                    parent._shed_resync_at = now
                    self.shedding = False
                    if parent._degradation.clear(f"lane{self.index}_queue"):
                        logger.info(
                            "lane %d drained below shed threshold; degraded "
                            "reason cleared; resyncing streams to re-deliver "
                            "shed events", self.index,
                        )
                        parent.resync_streams()
            if stop:
                return

    # ---------------------------------------------------------------- emit

    def emit_loop(self) -> None:
        eq = self.emit_q
        while True:
            if self._emit_inflight is None:
                # an emit item is an irreplaceable wire slice (its device
                # transitions fired exactly once), so the claim does not
                # destroy it: peek under the queue's own condition, publish
                # it to the slot, THEN pop — a loop restarted after a crash
                # finds it in the queue, in the slot, or both. Replaying a
                # slice is safe: it only repeats patches the no-op check
                # absorbs, and the stale filter and prune are idempotent
                with eq.not_empty:
                    while not eq._qsize():
                        eq.not_empty.wait()
                    self._emit_inflight = eq.queue[0]
                got = eq.get_nowait()
                if got is not self._emit_inflight:
                    self._emit_inflight = got
            item = self._emit_inflight
            if item is None:
                return
            try:
                if item[0] == "__prune__":
                    self._prune_now(item[1])
                else:
                    self._process_emit(item)
            except Exception:
                logger.exception("lane %d emit failed", self.index)
            self._emit_inflight = None

    def _prune_now(self, min_seq: int) -> None:
        """Drop release-log entries no queued-or-future emit item can
        still consult. Runs BEHIND the emit queue (FIFO): every emit item
        queued before this marker has already done its stale filter."""
        with self.stage_lock:
            self.engine._prune_released(min_seq)

    def _process_emit(self, item) -> None:
        """Consume one tick's wire slice for this lane: filter stale mask
        bits, refresh fired rows' phase/cond mirrors, emit patches. The
        body holds the lane's stage_lock, as the single-lane engine ran
        emit and ingest on one thread: ``_emit``'s pool reads can never
        see a row released and re-acquired mid-iteration."""
        # ``_wire`` keeps the wire's pinned host buffer alive while the
        # phase/cond slices (views into it) are read
        kind, dirty, deleted, hb, ph, cb, seq, now_str, _wire = item
        e = self.engine
        k = e.nodes if kind == "nodes" else e.pods
        t0 = time.perf_counter()
        cap = dirty.shape[0]
        with self.stage_lock:
            # rows released since this tick's dispatch: their mask bits
            # describe the OLD occupant (see ClusterEngine._tick_consume)
            stale = [idx for idx, s in k.released_at.items() if s > seq and idx < cap]
            if stale:
                dirty[stale] = False
                deleted[stale] = False
                hb[stale] = False
            idxs = np.nonzero(dirty | deleted)[0]
            if idxs.size and ph is not None:
                # fired rows only: rows acquired after the dispatch keep
                # their ingest-time mirror values
                k.phase_h[idxs] = ph[idxs]
                k.cond_h[idxs] = cb[idxs]
            if idxs.size or hb.any():
                e._emit(kind, k, dirty, deleted, hb, now_str)
        t1 = time.perf_counter()
        self.telemetry.observe_stage("emit", t1 - t0)
        e.telemetry.span(
            "tick.emit", t0, t1, "emit", {"kind": kind, "shard": self.index}
        )


class LaneSet:
    """The coordinator: owns the stacked device state, the router and the
    tick loop (kernel launch plus per-lane wire handoff)."""

    def __init__(self, parent: ClusterEngine, n: int):
        self.parent = parent
        self.n = int(n)
        # per-lane row budget: an even split PLUS 25% slack (crc32 spreads
        # keys only statistically evenly)
        self.r = max(
            _MIN_LANE_ROWS,
            -(-int(parent.config.initial_capacity) * 5 // (4 * self.n)),
        )
        self.lanes = [ShardLane(self, i, self.r) for i in range(self.n)]
        self.stacked: dict = {}
        # bumped by the router per routed event; the tick loop's
        # got-an-event gate (plain int: one writer)
        self.events_routed = 0

    # ------------------------------------------------------------ lifecycle

    def prepare(self, executor) -> None:
        """Wire the shared executor into every lane, allocate the stacked
        state on the device and warm the scatters and the tick at the
        stacked shapes. Runs on the engine's stream."""
        for lane in self.lanes:
            e = lane.engine
            e._executor = executor
            e._running = True
            # the pump now, outside every lock: the emit worker runs
            # _process_emit under the lane's stage_lock, where a lazy
            # build would open its connections while the drain worker
            # waits on the lock
            e._get_pump()
        self._ensure_stacked()
        self._warm_scatters()
        self._warm_tick()

    def _ensure_stacked(self) -> None:
        if not self.stacked:
            cap = self.r * self.n
            self.stacked = {
                kind: new_row_state(cap, self.parent.device) for kind in _KINDS
            }

    def _warm_scatters(self) -> None:
        for kind in _KINDS:
            self.stacked[kind] = _warm_scatter(self.stacked[kind])

    def _warm_tick(self) -> None:
        _outs, wire = self.parent._get_fused()(
            (self.stacked["nodes"], self.stacked["pods"]), 0.0
        )
        np.asarray(wire)  # complete (and warm) the wire's D2H path

    def start_workers(self, threads: list) -> None:
        """Spawn the router and every lane's drain and emit workers under
        the engine's watchdog (the coordinator itself is started by
        ClusterEngine.start as 'kwok-tick'): a crashed worker restarts in
        place, same thread, same queues, within the restart budget."""
        wd = self.parent._watchdog
        threads.append(wd.spawn(self.route_loop, name="kwok-route"))
        for lane in self.lanes:
            threads.append(wd.spawn(lane.drain_loop, name=f"kwok-lane{lane.index}"))
            threads.append(wd.spawn(lane.emit_loop, name=f"kwok-emit{lane.index}"))

    @staticmethod
    @contextlib.contextmanager
    def _claim(lane: ShardLane):
        """A lane's stage_lock for the coordinator, with the lane's drain
        worker asked to yield it (``ShardLane.swap_waiting``)."""
        lane.swap_waiting = True
        try:
            with lane.stage_lock:
                lane.swap_waiting = False
                yield
        finally:
            lane.swap_waiting = False

    def close(self) -> None:
        """Stop the lanes and close their pump groups (the client and
        the executor are the parent's)."""
        for lane in self.lanes:
            e = lane.engine
            e._running = False
            if e._pump is not None:
                e._pump.close()
                e._pump = None

    # --------------------------------------------------------------- router

    def route_loop(self) -> None:
        """Drain the parent's ingest queue in windows of half a tick: raw
        watch lines buffer for one batched native parse per window (which
        partitions them), parsed events go to their key's lane. The
        revision bookkeeping stays on the parent, as on one lane."""
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
                parent.telemetry.set_gauge("ingest_queue_depth", q.qsize())
                if not parent._running:
                    return
        finally:
            # straggler lines, then let every lane drain worker exit (the
            # depth gauge keeps the last window's reading, as in kwok_tpu:
            # what reaches the queue after stop is never ingested)
            try:
                if raw_buf:
                    parent._drain_flush(raw_buf, self.route, self.n)
            finally:
                for lane in self.lanes:
                    lane.q.put(None)

    def _route_item(self, item, raw_buf: dict) -> None:
        """One parent-queue item into the drain: raw lines are counted by
        the flush that parses them, every other event here."""
        if item[1] not in ("RAW", "RAWB", "GEN"):
            self.parent.telemetry.inc_kind("watch_events_total", item[0])
        self.parent._drain_apply(item, raw_buf, self.route, self.n)

    def route(self, kind: str, type_: str, obj) -> None:
        """Partition one parsed event to its key's lane. RESYNC snapshots
        broadcast (each lane prunes only keys it owns)."""
        t = time.monotonic()
        if type_ == "RESYNC":
            for lane in self.lanes:
                lane.q.put((kind, type_, obj, t))
            self.events_routed += 1
            return
        key = self._key_of(kind, type_, obj)
        if key is None:
            return
        lane = self.lanes[shard_of(key, self.n)]
        if lane._shed_depth and lane.q.qsize() > lane._shed_depth:
            self._shed(lane, 1)
            return
        self.events_routed += 1
        lane.q.put((kind, type_, obj, t))

    def route_batch(self, kind: str, batch) -> None:
        """Hand a pre-partitioned parsed batch to the lanes: one zero-copy
        (batch, index run) item per lane with work, so the router's cost
        is n_lanes queue puts per window whatever the event rate. The C
        side computes the lane as ``rowpool.shard_of`` does."""
        t0 = time.perf_counter()
        t = time.monotonic()
        routed = 0
        for li, count, item in iter_recb_items(kind, batch, t):
            lane = self.lanes[li]
            if lane._shed_depth and lane.q.qsize() > lane._shed_depth:
                self._shed(lane, count)
                continue
            lane.q.put(item)
            lane.telemetry.inc_routed(count)
            routed += count
        self.events_routed += routed
        self.parent.telemetry.observe_route_batch(time.perf_counter() - t0)

    def _shed(self, lane: ShardLane, n: int) -> None:
        """Graceful degradation: a lane whose queue is past the configured
        depth sheds routed events — counted in kwok_dropped_jobs_total,
        surfaced by kwok_degraded{reason=} and a 503 /readyz — instead of
        growing the queue without bound. The drain worker requests a
        stream resync once it catches up, so every shed object is
        re-delivered by the full re-list: shedding trades freshness, not
        permanent state."""
        parent = self.parent
        parent._inc("dropped_jobs_total", n)
        lane.shedding = True
        if parent._degradation.set(f"lane{lane.index}_queue"):
            logger.warning(
                "lane %d queue past %d: shedding routed events (engine "
                "degraded)", lane.index, lane._shed_depth,
            )

    @staticmethod
    def _key_of(kind: str, type_: str, obj):
        """The routing key — identical to the lane pool's key, so a key's
        row can only ever live in the lane its events are routed to. A
        record without a usable name is routed by its raw line's
        metadata; one that cannot be decoded is dropped and counted."""
        if type_ == "REC":
            name = obj.name
            ns = obj.namespace or "default"
            if not name:
                try:
                    meta = (json.loads(obj.raw).get("object") or {}).get("metadata") or {}
                except Exception:
                    swallowed("lanes.unrouteable_event")
                    return None
                name = meta.get("name") or ""
                ns = meta.get("namespace") or "default"
        elif isinstance(obj, dict):
            meta = obj.get("metadata") or {}
            name = meta.get("name") or ""
            ns = meta.get("namespace") or "default"
        else:
            return None
        if not name:
            return None
        return (ns, name) if kind == "pods" else name

    def route_pod_updates(self, node_name: str) -> None:
        """Fan a node's managed-ness change out to the lanes owning its
        pods — one XUPD batch per lane, through the lane's own queue."""
        keys = self.parent.pods_by_node.get(node_name)
        if not keys:
            return
        # snapshot: the set is shared and other lanes' drain workers add
        # and discard concurrently; a resize mid-copy raises, and retrying
        # converges at once (losing the fan-out would leave stale managed
        # bits until the pod's next event)
        while True:
            try:
                snapshot = list(keys)
                break
            except RuntimeError:
                time.sleep(0)
        by_lane: dict[int, list] = {}
        for key in snapshot:
            by_lane.setdefault(shard_of(key, self.n), []).append(key)
        t = time.monotonic()
        for li, lane_keys in by_lane.items():
            self.lanes[li].q.put(("pods", "XUPD", lane_keys, t))

    # ------------------------------------------------------------ tick loop

    def tick_loop(self) -> None:
        """The coordinator tick thread: kernel launch plus per-lane wire
        handoff (drain and emit live on the lane workers), pipelined like
        the single-lane loop: up to pipeline_depth wires in flight, FIFO
        consume. Every device operation runs on the engine's stream."""
        with self.parent._device_ctx():
            self._tick_loop_body()

    def _tick_loop_body(self) -> None:
        parent = self.parent
        interval = parent.config.tick_interval
        depth = max(1, int(parent.config.pipeline_depth))
        pending: "deque[_LanePending]" = deque()
        seen_events = 0
        profiling.maybe_start()
        try:
            while parent._running:
                deadline = time.monotonic() + interval
                got_event = self.events_routed != seen_events
                if (
                    not pending
                    and not got_event
                    and not self._staged()
                    # the drain workers mark the startup RESYNCs after the
                    # router counted them: keep checking the gate at the
                    # tick interval until it closes
                    and parent._startup_pending is None
                ):
                    wake = parent._idle_wake
                    if wake is None:
                        deadline = time.monotonic() + parent._IDLE_MAX
                    elif wake > deadline:
                        deadline = min(wake, time.monotonic() + parent._IDLE_MAX)
                    deadline = parent._idle_deadline(deadline)
                while parent._running:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    if pending and pending[0].wire.is_ready():
                        try:
                            self._consume(pending.popleft(), pending)
                        except Exception:
                            logger.exception("lane consume failed")
                        continue
                    if not got_event and (
                        self.events_routed != seen_events or self._staged()
                    ):
                        # an event arriving during an idle sleep must be
                        # ticked within one normal interval
                        got_event = True
                        deadline = min(deadline, time.monotonic() + interval)
                    time.sleep(min(remaining, 0.002 if pending else 0.02))
                got_event = got_event or self.events_routed != seen_events
                seen_events = self.events_routed
                did_dispatch = False
                try:
                    while pending and (
                        len(pending) >= depth or pending[0].wire.is_ready()
                    ):
                        self._consume(pending.popleft(), pending)
                    wake = parent._idle_wake
                    if (
                        got_event
                        or self._staged()
                        or (wake is not None and time.monotonic() >= wake)
                    ):
                        did_dispatch = True
                        p = self.dispatch()
                        if p is not None:
                            pending.append(p)
                except Exception:
                    logger.exception("lane tick failed")
                    parent._idle_wake = time.monotonic() + interval
                if parent._startup_pending is not None or parent._ckpt is not None:
                    # the coordinator owns the stacked state, so the
                    # startup gate, the refine and the checkpoint gathers
                    # run here (one attribute test when disabled)
                    try:
                        self._ckpt_service(did_dispatch)
                    except Exception:
                        logger.exception("checkpoint service failed")
        finally:
            # stopping: flush in-flight wires so computed patches are not
            # dropped, release the emit workers, then gather the final
            # checkpoint
            while pending:
                try:
                    self._consume(pending.popleft(), pending)
                except Exception:
                    logger.exception("final lane consume failed")
            for lane in self.lanes:
                lane.emit_q.put(None)
            parent._close_profiler()
            if parent._ckpt is not None:
                try:
                    parent._ckpt.final(self._ckpt_snapshot(parent._now()))
                except Exception:
                    logger.exception("final checkpoint failed")

    def _staged(self) -> bool:
        return any(
            k.buffer.pending
            for lane in self.lanes
            for k in (lane.engine.nodes, lane.engine.pods)
        )

    # --------------------------------------- crash-durable restarts (ckpt)

    def _ckpt_service(self, dispatched: bool) -> None:
        """The lanes' twin of ClusterEngine._ckpt_service: the stacked
        device state lives here, the row pools on the lanes. Pool walks
        take each lane's stage_lock (pure dict/array reads); device reads
        and scatters run lock-free on this thread, which owns the stacked
        state."""
        parent = self.parent
        now = parent._now()
        r = parent._restore
        if r is not None:
            if r.expired() or (not r.gate_ready and not r.remaining):
                parent._end_restore(r)
            else:
                self._ckpt_refine(r, now)
            # tick until the pipeline flushes every pre-refine wire (see
            # ClusterEngine._ckpt_service)
            parent._ckpt_force_ticks = max(1, int(parent.config.pipeline_depth)) + 2
        if parent._ckpt_force_ticks > 0:
            parent._ckpt_force_ticks -= 1
            parent._idle_wake = time.monotonic()
        parent._ckpt_gate(dispatched, staged=self._staged())
        parent._ckpt_due(now, dispatched, self._ckpt_snapshot)

    @staticmethod
    def _lane_kind(lane: ShardLane, kind: str):
        e = lane.engine
        return e.nodes if kind == "nodes" else e.pods

    def _ckpt_refine(self, r, now: float) -> None:
        """Match checkpoint entries per lane (the key->lane mapping is the
        pool's own), then scatter each lane's refine run into the stacked
        state at the lane's offset. A matched row released by a drain
        worker right after the match is harmless: its re-acquisition's
        staged init flushes AFTER this scatter (the flush runs on this
        same thread) and overwrites the refined fields."""
        for kind in _KINDS:
            if not r.kinds.get(kind):
                continue
            state = self.stacked[kind]
            # an entry with a delay residue is consumed only once its row
            # is ARMED (finite fire_at): see ClusterEngine._ckpt_refine
            cur_fire = state.fire_at.cpu().numpy()
            runs = []
            for li, lane in enumerate(self.lanes):
                k = self._lane_kind(lane, kind)
                with self._claim(lane):
                    staged = k.buffer.staged_rows() if k.buffer.pending else frozenset()
                    idx, fire, hb, gen = r.match_kind(
                        kind, k.pool, staged, now, phase_h=k.phase_h,
                        fire=cur_fire, offset=li * self.r,
                    )
                if idx.size:
                    runs.append((li, idx, fire, hb, gen))
            for li, idx, fire, hb, gen in runs:
                state = refine_flush(
                    state, idx, fire, hb, gen, offset=li * self.r, rows=self.r
                )
            self.stacked[kind] = state

    def _ckpt_snapshot(self, now: float) -> dict:
        """Gather the checkpoint rows across lanes: one host copy of the
        stacked timer fields per kind, then a per-lane pool walk under
        that lane's stage_lock."""
        t0 = time.perf_counter()
        kinds: dict = {}
        for kind in _KINDS:
            fire, hb, gen = gather_deadlines(self.stacked[kind])
            ents: dict = {}
            for li, lane in enumerate(self.lanes):
                k = self._lane_kind(lane, kind)
                with self._claim(lane):
                    staged = k.buffer.staged_rows() if k.buffer.pending else frozenset()
                    ents.update(ckpt_mod.gather_rows(
                        kind, k.pool, k.phase_h, fire, hb, gen, staged, now,
                        offset=li * self.r,
                    ))
            kinds[kind] = ents
        self.parent.telemetry.note(
            "checkpoint_snapshot_seconds_last", time.perf_counter() - t0
        )
        return {"kinds": kinds}

    # ----------------------------------------------------- dispatch/consume

    def dispatch(self) -> "_LanePending | None":
        """Flush every lane's staged writes into the stacked state and
        launch the fused kernel (the single-lane _tick_dispatch, minus
        drain and emit)."""
        parent = self.parent
        if parent._profiler is not None:
            parent._profiler.step(parent.telemetry.ticks_total)
        t0 = time.perf_counter()
        self._ensure_stacked()  # synchronous use without start()
        now = parent._now()
        if now >= REBASE_AFTER:
            parent._epoch += now
            for lane in self.lanes:
                lane.engine._epoch = parent._epoch
            for kind in _KINDS:
                self.stacked[kind] = rebase_times(self.stacked[kind], now)
            parent._inc("epoch_rebases_total")
            logger.info("epoch rebase at engine time %.1fs", now)
            now = 0.0
        # swap full buffers out under each lane's stage lock (cheap), then
        # flush them into the stacked state lock-free: the drain workers
        # keep staging into the fresh buffers meanwhile
        swapped: list[tuple[int, str, UpdateBuffer]] = []
        want = self.r
        any_rows = False
        for li, lane in enumerate(self.lanes):
            e = lane.engine
            with self._claim(lane):
                for kind, k in (("nodes", e.nodes), ("pods", e.pods)):
                    want = max(want, k.capacity)
                    if k.buffer.pending:
                        swapped.append((li, kind, k.buffer))
                        k.buffer = UpdateBuffer()
                        any_rows = True
                    elif len(k.pool):
                        any_rows = True
        if want > self.r:
            self._regrow(want)
        r = self.r
        for li, kind, buf in swapped:
            self.stacked[kind] = buf.flush(self.stacked[kind], offset=li * r, rows=r)
        t_flush = time.perf_counter()
        tel = parent.telemetry
        tel.set_gauge("nodes_managed", sum(len(ln.engine.nodes.pool) for ln in self.lanes))
        tel.set_gauge("pods_managed", sum(len(ln.engine.pods.pool) for ln in self.lanes))
        tel.inc("ticks_total")
        tel.observe_stage("flush", t_flush - t0)
        if not any_rows:
            parent._idle_wake = None  # empty engine: sleep until events
            return None
        fused = parent._get_fused()
        now_base = now - (fused.steps - 1) * fused.dt
        _outs, wire = fused((self.stacked["nodes"], self.stacked["pods"]), now_base)
        t_end = time.perf_counter()
        tel.span("tick.dispatch", t0, t_end, "dispatch")
        return _LanePending(
            wire=wire,
            r=r,
            cap=r * self.n,
            seqs=[lane.engine._release_seq for lane in self.lanes],
            now=now,
            mono=time.monotonic(),
            host_s=t_end - t0,
        )

    def _consume(self, p: _LanePending, pending, inline: bool = False) -> None:
        """Consume the oldest in-flight wire: slice it per lane and hand
        each lane its view (the emit worker refreshes mirrors and emits).
        With inline=True (tick_once) lanes process on the calling thread."""
        parent = self.parent
        t0 = time.perf_counter()
        counters, masks_fn, dues, rows_fn = unpack_wire(
            np.asarray(p.wire), [p.cap, p.cap], rows=True
        )
        t_wire = time.perf_counter()
        nd = float(dues.min())
        parent._idle_wake = (
            None if nd == float("inf") else p.mono + max(0.0, nd - p.now)
        )
        if counters.any():
            n_trans = int(counters[0]) + int(counters[1])
            for ki, kind in enumerate(_KINDS):
                if counters[ki]:
                    parent.telemetry.inc_kind(
                        "transitions_total", kind, int(counters[ki])
                    )
            now_str = now_rfc3339()
            masks = masks_fn()
            rows = rows_fn() if n_trans else None
            views = lane_views(masks, rows, self.n, p.r)
            for li, lane in enumerate(self.lanes):
                for ki, kind in enumerate(_KINDS):
                    dirty, deleted, hb, ph, cb = views[li][ki]
                    if not (dirty.any() or deleted.any() or hb.any()):
                        continue
                    item = (kind, dirty, deleted, hb, ph, cb, p.seqs[li],
                            now_str, p.wire)
                    if inline:
                        lane._process_emit(item)
                    else:
                        lane.emit_q.put(item)
        # release-log pruning rides the emit queue BEHIND this tick's
        # items: pruning here would race the emit workers, whose queued
        # items still need entries newer than their own seq
        for li, lane in enumerate(self.lanes):
            nxt = next((q.seqs[li] for q in pending), lane.engine._release_seq)
            if inline:
                lane._prune_now(nxt)
            else:
                lane.emit_q.put(("__prune__", nxt))
        # host seconds of this tick on the coordinator: dispatch, the wait
        # for the wire, unpack and handoff (emit runs on the lane workers)
        t_end = time.perf_counter()
        tel = parent.telemetry
        tel.observe_tick(t_end - t0 + p.host_s)
        tel.observe_stage("kernel", t_wire - t0)
        tel.span(
            "tick.consume", t0, t_end, "consume",
            {"wire_wait_us": round((t_wire - t0) * 1e6, 1)},
        )

    # ------------------------------------------------------------------ grow

    def _regrow(self, want: int) -> None:
        """A lane's pool grew past the per-lane row budget: grow every
        lane to the new common capacity and regrow the stacked state on
        the device (each lane's rows move to its new offset)."""
        new_r = want
        logger.info("lane regrow (%d lanes): %d -> %d rows/lane", self.n, self.r, new_r)
        for lane in self.lanes:
            with self._claim(lane):
                for k in (lane.engine.nodes, lane.engine.pods):
                    if k.capacity < new_r:
                        k.grow(new_r)
        for kind in _KINDS:
            self.stacked[kind] = regrow_stacked(self.stacked[kind], self.n, new_r)
        self.r = new_r

    # ------------------------------------------------------------ sync mode

    def tick_once(self) -> None:
        """One synchronous step (tests, tools): route and drain every queue
        inline, dispatch, consume with inline emit — the threaded
        pipeline's routing, lane application order and wire slicing."""
        self.drain_inline()
        p = self.dispatch()
        if p is not None:
            self._consume(p, deque(), inline=True)

    def drain_inline(self) -> None:
        """Route the parent queue (its raw lines in one batched parse) and
        apply every lane queue to quiescence (XUPD fan-outs re-enqueue,
        hence the outer loop)."""
        parent = self.parent
        progressed = True
        while progressed:
            progressed = False
            raw_buf: dict = {}
            while True:
                try:
                    item = parent._q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    continue
                self._route_item(item, raw_buf)
                progressed = True
            if raw_buf:
                parent._drain_flush(raw_buf, self.route, self.n)
            for lane in self.lanes:
                while True:
                    try:
                        item = lane.q.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:
                        continue
                    lane._apply_locked(item)
                    progressed = True


def iter_recb_items(kind: str, batch, t: float):
    """Yield ``(lane_index, n_events, item)`` per non-empty lane of a
    pre-partitioned parsed batch: the routed item
    ``(kind, "RECB", (batch, lane_idx, lo, hi), t)`` a ShardLane applies."""
    lane_off = batch.lane_off
    lane_idx = batch.lane_idx
    for li in range(len(lane_off) - 1):
        lo = lane_off[li]
        hi = lane_off[li + 1]
        if hi > lo:
            yield li, hi - lo, (kind, "RECB", (batch, lane_idx, lo, hi), t)
