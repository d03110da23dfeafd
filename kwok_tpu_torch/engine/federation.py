"""FederatedEngine: N simulated clusters from one process over a mesh of
cards (the port of ``kwok_tpu.engine.federation``; BASELINE config 5).

  member 0: watches ─> queue ─┐                 ┌─> member 0 executor
  member 1: watches ─> queue ─┤  federated tick │─> member 1 executor
     ...                      ├─ thread ────────┤       ...
  member N-1: ...    ─> queue ─┘      │    ▲     └─> member N-1 executor
                                      ▼    │
             per rule-set group: ONE stacked device state per kind,
             member c of the group owning rows [c*r, (c+1)*r)

Each member is a ``ClusterEngine`` with its own apiserver client, watch
streams, row pools, IP pool, patch executor, native pump group (to its
own apiserver, through its own client) and checkpoint file, started
with ``run_tick_loop=False`` (no tick thread, no stream, no device rows
of its own). One federated tick thread drains every member's queue
round-robin, flushes each member's staged writes into its slice of its
group's stacked state, runs one fused dispatch per group
(``ops/tick.MultiTickKernel``), and hands each member its slice of
the wire to emit. Members that share a compiled rule set, selector bits,
heartbeat interval, tick interval and substeps share a group; each
distinct set gets its own stacked state and kernel specs.

Each group's stacked state is split over the federation's mesh
(``parallel/``; by default every visible card once, or the CPU once for
a CPU federation), as the JAX package shards it over its device mesh:
each group's row count per cluster is padded so that the stack splits
evenly (``_pad_cluster_capacity``), the dispatch launches the fused
kernel once per shard, and a member's slice may straddle shards.

Member failover: ONE watchdog supervises every member's watch threads
(``kwok-watch-<kind>-m<i>``). A crashed one restarts in place on its own
thread, is counted in ``kwok_fed_member_restarts_total{member}``, re-lists
(the fresh loop's construction) and re-arms its member's checkpoint
refill (``_rearm_restore``); a member past its restart budget degrades
the federation's ``/readyz``. Each member builds its own fault plane from
the configuration, as ``kwok_tpu``'s members do.

Telemetry: every member writes a ``shard="<i>"``-labeled slice of ONE
registry (``EngineTelemetry(registry, shard)``), so ``/metrics`` has
per-shard series of every engine family beside the group dispatch
counters and the ``kwok_fed_*`` aggregates. The federated loop records
its dispatch, emit and consume spans in a tracer of its own; the
members' pump and patch spans land in theirs, and ``trace_chrome()``
merges them all under the labels ``federation`` and ``shard<i>`` (also
the document ``trace_dump`` writes at stop). ``profile_dir`` profiles
the federated loop's ticks [2, 102).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from kwok_tpu_torch import profiling
from kwok_tpu_torch.edge.kubeclient import KubeClient
from kwok_tpu_torch.edge.render import now_rfc3339
from kwok_tpu_torch.engine.engine import ClusterEngine, EngineConfig, _warm_scatter
from kwok_tpu_torch.models.defaults import SEL_HEARTBEAT
from kwok_tpu_torch.ops.state import SplitState, field_numpy, new_split_state, regrow_stacked
from kwok_tpu_torch.ops.tick import (
    REBASE_AFTER,
    MultiTickKernel,
    gather_deadlines,
    rebase_times,
    unpack_wire,
)
from kwok_tpu_torch.ops.updates import refine_flush
from kwok_tpu_torch.parallel import mesh as mesh_mod
from kwok_tpu_torch.resilience import checkpoint as ckpt_mod
from kwok_tpu_torch.resilience.watchdog import Watchdog
from kwok_tpu_torch.telemetry.engine_metrics import EngineTelemetry
from kwok_tpu_torch.telemetry.registry import MetricsRegistry
from kwok_tpu_torch.telemetry.trace import Tracer, merge_chrome_traces
from kwok_tpu_torch.workers import spawn_worker

logger = logging.getLogger("kwok_tpu_torch.federation")

_KINDS = ("nodes", "pods")

# Values every member records once per federated tick: the federation's
# ``metrics`` un-sums them (emit and drain work is per member and stays
# summed).
_SHARED_TICK_VALUES = (
    "ticks_total", "tick_seconds_sum", "tick_seconds_last",
    "epoch_rebases_total", "tick_flush_seconds_sum",
    "tick_kernel_seconds_sum",
)


def _pad_cluster_capacity(r: int, n_clusters: int, n_devices: int) -> int:
    """Smallest R' >= r such that n_clusters * R' shards evenly."""
    step = n_devices // math.gcd(n_clusters, n_devices)
    return ((r + step - 1) // step) * step


def _table_bytes(tab) -> bytes:
    """Canonical bytes of a CompiledRules table (grouping key). The phase
    vocabulary is part of the key: Stage docs can extend the space past the
    canonical prefix (compiler.compile_rules), and two numerically identical
    tables whose extra ids name DIFFERENT phases must not share a kernel —
    the rendered phase strings would be wrong for one member."""
    return b"|".join(
        [
            np.ascontiguousarray(getattr(tab, f)).tobytes()
            for f in (
                "from_mask", "deletion", "selector_bit", "delay_kind",
                "delay_a", "delay_b", "to_phase", "cond_assign",
                "cond_value", "is_delete", "weight",
            )
        ]
        + [
            "\x1f".join(tab.space.phases).encode(),
            "\x1f".join(tab.space.conditions).encode(),
        ]
    )


class _MemberEngine(ClusterEngine):
    """A ClusterEngine serving as federation member ``index``: no stream
    and no device rows of its own (its rows are a slice of its group's
    stacked state), its ``shard="<index>"`` slice of the federation's
    registry (its degraded-mode ledger included), and a member identity
    for its checkpoint file and threads."""

    _owns_device = False

    def __init__(self, client: KubeClient, config: EngineConfig, index: int,
                 registry: MetricsRegistry) -> None:
        super().__init__(client, config, telemetry=EngineTelemetry(
            registry=registry, shard=str(index),
        ))
        self._member_index = index
        self._ckpt_name = f"member{index}"
        self._worker_suffix = f"-m{index}"


class _MemberReasons:
    """The federation's degraded-mode view for ``/readyz``: every
    member's reasons, prefixed with the member's index."""

    def __init__(self, engines) -> None:
        self._engines = engines

    @property
    def active(self) -> bool:
        return any(e.degraded for e in self._engines)

    @property
    def reasons(self) -> tuple:
        return tuple(
            f"member{i}:{r}"
            for i, e in enumerate(self._engines)
            for r in e._degradation.reasons
        )


@dataclasses.dataclass
class _FedPending:
    """A dispatched-but-unconsumed group tick in the pipelined loop."""

    group: "_Group"
    wire: object  # ops.tick.Wire; self-contained
    r: int  # rows per cluster AT DISPATCH (regrow may change it)
    cap: int  # stacked capacity at dispatch
    seqs: list  # per-member release seq at dispatch (stale-mask filter)
    now: float  # engine time of the dispatch
    mono: float  # monotonic clock at dispatch (idle-wake anchor)
    host_s: float  # host seconds of this group's flush and launch
    flush_s: float  # host seconds of this group's staged-write flush


class _Group:
    """Members sharing one compiled rule set: one stacked state per kind
    and one set of kernel specs (one dispatch per group per tick)."""

    def __init__(self, engines, cfg: EngineConfig, mesh):
        self.engines = engines  # member engines, federation order preserved
        self.r = 0  # rows per cluster; set by alloc
        # kernel-launch counter: the registry child set by FederatedEngine
        # right after the group is built
        self.dispatch_counter = None
        # monotonic device-timer deadline from this group's newest consumed
        # tick (None = nothing scheduled); the loop gate takes the min
        self.wake: "float | None" = 0.0
        e0 = engines[0]
        hb_bit = e0.node_bits[SEL_HEARTBEAT]
        steps = max(1, int(cfg.tick_substeps))
        self.fused = MultiTickKernel(
            [
                (e0.nodes.table, cfg.heartbeat_interval, (), hb_bit),
                (e0.pods.table, cfg.heartbeat_interval, (), -1),
            ],
            steps=steps,
            dt=cfg.tick_interval / steps,
            mesh=mesh,
        )
        self.mesh = mesh
        self.stacked: dict[str, SplitState] = {}

    @property
    def dispatches(self) -> int:
        """Kernel dispatches so far (a view of the counter)."""
        return self.dispatch_counter.value if self.dispatch_counter else 0

    def alloc(self, r: int) -> None:
        self.r = r
        cap = r * len(self.engines)
        self.stacked = {kind: new_split_state(cap, self.mesh) for kind in _KINDS}


class FederatedEngine:
    """Drive N member clusters from one stacked tick per rule-set group (a
    single group, and a single dispatch per tick, when all members share
    rules)."""

    # idle backstop of the tick loop (see ClusterEngine)
    _IDLE_MAX = 60.0

    def __init__(
        self,
        clients: list[KubeClient],
        config: EngineConfig,
        mesh=None,
        member_configs: "list[EngineConfig] | None" = None,
    ) -> None:
        if not clients:
            raise ValueError("federation needs at least one cluster")
        if member_configs is not None and len(member_configs) != len(clients):
            raise ValueError(
                f"member_configs has {len(member_configs)} entries "
                f"for {len(clients)} clusters"
            )
        cfgs = member_configs if member_configs is not None else [config] * len(clients)
        # the stacked tick holds every member's rows in one [n_members * r]
        # state per kind, so capacity must be uniform: size it for the
        # largest request (nobody is silently undersized)
        base_capacity = max(
            1,
            int(config.initial_capacity),
            *(int(c.initial_capacity) for c in cfgs),
        )
        self.config = config
        # ONE registry for the whole federation: every member's
        # shard-labeled families, the group dispatch counters, the
        # kwok_fed_* gauges and every member's degraded-mode ledger. The
        # federated loop records its spans in a tracer of its own
        self.registry = MetricsRegistry()
        self.tracer = Tracer()
        self._profiler: "profiling.TickProfiler | None" = None
        # members are single-lane (drain_shards=1): the federated loop
        # drives their ingest queues and emit paths directly. Every member
        # runs on the federation's device.
        self.engines = [
            _MemberEngine(
                client,
                dataclasses.replace(
                    cfg, initial_capacity=base_capacity, drain_shards=1,
                    lane_procs=False, use_mesh=False, device=config.device,
                ),
                i,
                self.registry,
            )
            for i, (client, cfg) in enumerate(zip(clients, cfgs))
        ]
        if mesh is None:
            mesh = mesh_mod.make_mesh(devices=mesh_mod.local_devices(self.engines[0].device))
        if mesh.devices[0].type != self.engines[0].device.type:
            raise ValueError(
                f"a {self.engines[0].device.type} federation cannot split "
                f"its rows over {mesh}"
            )
        self.mesh = mesh
        self.device = mesh.devices[0]
        logger.info("federation rows split over %d shards: %s", mesh.size,
                    ", ".join(str(d) for d in mesh.devices))
        # every device operation of the federation runs on this stream
        # (the federated tick thread's); the stacked states are allocated
        # on it too
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        self._degradation = _MemberReasons(self.engines)

        # Group members by compiled rule set + heartbeat cadence: each
        # distinct set needs its own kernel specs; identical sets share one
        # stacked state (one dispatch per group).
        by_key: dict[tuple, list[int]] = {}
        for i, (e, cfg) in enumerate(zip(self.engines, cfgs)):
            key = (
                _table_bytes(e.nodes.table),
                _table_bytes(e.pods.table),
                # everything _Group bakes into its kernel specs must be in
                # the key, or differing members would silently coalesce —
                # including the heartbeat SELECTOR BIT: rule sets differing
                # only in selector names compile to identical numeric
                # tables but different bit assignments
                int(e.node_bits[SEL_HEARTBEAT]),
                float(cfg.heartbeat_interval),
                float(cfg.tick_interval),
                int(cfg.tick_substeps),
            )
            by_key.setdefault(key, []).append(i)
        self.groups: list[_Group] = []
        with self._device_ctx():
            for members in by_key.values():
                g = _Group(
                    [self.engines[i] for i in members], cfgs[members[0]], mesh
                )
                g.alloc(_pad_cluster_capacity(base_capacity, len(members), mesh.size))
                self.groups.append(g)
        for g in self.groups:
            for e in g.engines:
                for k in (e.nodes, e.pods):
                    if k.capacity < g.r:
                        k.grow(g.r)

        # shared engine epoch so one `now` is correct for every member
        self._epoch = time.time()
        for e in self.engines:
            e._epoch = self._epoch

        # per-group kernel-launch counters (labeled series), plus
        # cross-member aggregate gauges refreshed on every /metrics render
        disp_fam = self.registry.counter(
            "kwok_group_dispatches_total",
            "Fused-kernel launches per rule-set group",
            ("group",),
        )
        for i, g in enumerate(self.groups):
            g.dispatch_counter = disp_fam.labels(group=str(i))
        self._agg_lag = self.registry.gauge(
            "kwok_fed_watch_lag_seconds_max",
            "Worst per-shard watch lag in the last drain window",
        )
        self._agg_depth = self.registry.gauge(
            "kwok_fed_ingest_queue_depth",
            "Watch events waiting to be ingested, summed across shards",
        )
        self._agg_nodes = self.registry.gauge(
            "kwok_fed_nodes_managed", "Nodes managed across all shards"
        )
        self._agg_pods = self.registry.gauge(
            "kwok_fed_pods_managed", "Pods tracked across all shards"
        )
        # member failover: ONE watchdog (built in start) supervises every
        # member's watch threads; a restart is counted per member
        self._member_restarts = self.registry.counter(
            "kwok_fed_member_restarts_total",
            "Supervised federation-member ingest workers restarted in "
            "place after a crash (the member re-lists and refines its "
            "slice of the stacked state from its checkpoint)",
            ("member",),
        )
        self._watchdog: "Watchdog | None" = None

        self._running = False
        self.ready = False  # /readyz gate; flips once members catch up
        # post-refine forced-tick budget (see _ckpt_service)
        self._ckpt_force_ticks = 0
        self._thread: "threading.Thread | None" = None
        # monotonic wake-up for the idle tick loop (see ClusterEngine):
        # 0 = tick immediately, None = nothing scheduled on device
        self._idle_wake: "float | None" = 0.0

    @property
    def cluster_capacity(self) -> int:
        """Rows per member cluster (max across groups; groups pad
        independently)."""
        return max(g.r for g in self.groups)

    def _device_ctx(self):
        """Run device work on the federation's stream (no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Warm every group's scatters and kernel at the stacked shapes
        (on a CUDA device this builds and loads the tick kernel's library),
        start every member without a tick thread, then the federated tick
        thread. ``ready`` flips on that thread once every member's startup
        gate (first full re-list, checkpoint reconcile) has closed."""
        self._running = True
        profiling.maybe_start()
        if self.config.profile_dir:
            self._profiler = profiling.TickProfiler(
                self.config.profile_dir, self.device
            )
        with self._device_ctx():
            self._warm_scatters()
            self._warm_ticks()
        # installed BEFORE the members start, so each adopts it instead of
        # building its own
        self._watchdog = Watchdog(
            budget=self.config.worker_restart_budget,
            window=self.config.worker_restart_window,
            on_exhausted=self._member_budget_exhausted,
            on_restart=self._member_worker_restarted,
        )
        for e in self.engines:
            e._watchdog = self._watchdog
            e.start(run_tick_loop=False)
            # each member's pump group to its own apiserver, built now
            # rather than inside the first tick's emit (its stop closes it)
            e._get_pump()
        self._thread = spawn_worker(self._tick_loop, name="kwok-fed-tick")

    @property
    def degraded(self) -> bool:
        """Any member degraded degrades the federation's /readyz (the
        members share one process; a load balancer cannot route around
        half of it)."""
        return self._degradation.active

    @property
    def startup_resync_pending(self) -> bool:
        return self._running and any(
            e._startup_pending is not None for e in self.engines
        )

    def _member_of_worker(self, name: str) -> "int | None":
        """The member index a worker's ``-m<i>`` suffix names, or None."""
        i = name.rfind("-m")
        if i < 0:
            return None
        try:
            idx = int(name[i + 2:])
        except ValueError:
            return None
        return idx if 0 <= idx < len(self.engines) else None

    def _member_budget_exhausted(self, name: str) -> None:
        """Watchdog callback: a member's worker failed past its restart
        budget; the member (and so the federation's /readyz) degrades."""
        i = self._member_of_worker(name)
        if i is None:
            return
        if self.engines[i]._degradation.set("worker_restart_budget"):
            logger.error(
                "federation member %d degraded: worker %s out of restart "
                "budget", i, name,
            )

    def _member_worker_restarted(self, name: str) -> None:
        """Watchdog callback, on the restarted worker's own thread: count
        the member's restart and re-arm its checkpoint refill, so rows its
        re-list re-initializes resume their timers (the federated loop
        applies the refine in the member's slice of the stacked state).
        The restarted loop re-lists its own kind by construction; cutting
        the member's healthy other stream would be pure cost."""
        i = self._member_of_worker(name)
        if i is None:
            return
        self._member_restarts.labels(member=str(i)).inc()
        e = self.engines[i]
        if not e._running:
            return
        logger.warning(
            "federation member %d: ingest worker %s restarted; re-listing "
            "and re-filling its slice", i, name,
        )
        e._rearm_restore()

    def _warm_scatters(self) -> None:
        """Both ingest scatters once per stacked state, on a row still in
        its initial state, so the first ingest wave does not pay for
        loading their device code."""
        for g in self.groups:
            for kind in _KINDS:
                g.stacked[kind] = _warm_scatter(g.stacked[kind])

    def _warm_ticks(self) -> None:
        """One all-inactive dispatch per group at startup: on a CUDA device
        the first builds and loads the tick kernel's library, and each
        warms its pinned wire's D2H path, so neither lands in the serving
        path."""
        for g in self.groups:
            _outs, wire = g.fused((g.stacked["nodes"], g.stacked["pods"]), 0.0)
            np.asarray(wire)

    def stop(self) -> None:
        self._running = False
        self.ready = False
        if self._watchdog is not None:
            self._watchdog.close()  # shutdown crashes must not restart
        # join the shared tick first so it cannot submit patch jobs to
        # members whose executors are already shut down; its exit path
        # consumes the in-flight wires and queues every final checkpoint
        if self._thread is not None:
            self._thread.join(timeout=60)
        for e in self.engines:
            e.stop()
        trace_path = self.config.trace_dump or os.environ.get(
            "KWOK_TPU_TRACE", ""
        )
        if trace_path:
            # members write no dump of their own: ONE merged document
            try:
                with open(trace_path, "w") as f:
                    json.dump(self.trace_chrome(), f)
                logger.info("federated span trace written to %s", trace_path)
            except Exception:
                logger.exception("federated span trace dump failed")

    # ------------------------------------------------------------- tick loop

    def _tick_loop(self) -> None:
        with self._device_ctx():
            self._tick_loop_body()

    def _tick_loop_body(self) -> None:
        """Pipelined federated loop, mirroring ClusterEngine._tick_loop:
        every iteration drains member queues, consumes in-flight group
        wires that have landed, and dispatches the next tick of every
        group — so the device round trip overlaps drain and emit. Per-group
        consume order is FIFO."""
        interval = self.config.tick_interval
        depth = max(1, int(self.config.pipeline_depth))
        pending: "deque[_FedPending]" = deque()
        profiling.maybe_start()
        try:
            while self._running:
                deadline = time.monotonic() + interval
                if (
                    not pending
                    and all(e._q.empty() for e in self.engines)
                    and not self._staged()
                ):
                    # idle: sleep toward the device-reported deadline
                    # (ops/tick.next_due); events shorten the drain
                    wake = self._idle_wake
                    if wake is None:
                        deadline = time.monotonic() + self._IDLE_MAX
                    elif wake > deadline:
                        deadline = min(wake, time.monotonic() + self._IDLE_MAX)
                    # a dispatch not yet checkpointed caps the sleep
                    for e in self.engines:
                        deadline = e._idle_deadline(deadline)
                got_event = self._drain_ingest(deadline, pending)
                did_dispatch = False
                try:
                    while pending and (
                        len(pending) >= depth * len(self.groups)
                        or pending[0].wire.is_ready()
                    ):
                        self._consume_one(pending)
                    # dispatch only when something calls for a tick (an
                    # always-in-flight pipeline would otherwise never idle)
                    wake = self._idle_wake
                    if (
                        got_event
                        or self._staged()
                        or (wake is not None and time.monotonic() >= wake)
                    ):
                        did_dispatch = True
                        self._tick_dispatch_all(pending)
                except Exception:
                    logger.exception("federated tick failed")
                    self._idle_wake = time.monotonic() + interval
                # per-member reconcile + checkpoint gathers against each
                # member's slice of its group's stacked state; also flips
                # federation readiness once every member caught up
                try:
                    self._ckpt_service(did_dispatch)
                except Exception:
                    logger.exception("federated checkpoint service failed")
        finally:
            # stopping: flush in-flight group wires so computed patches
            # are not dropped (stop() joins this thread before member
            # teardown), then queue every member's final checkpoint
            while pending:
                try:
                    self._consume_one(pending)
                except Exception:
                    logger.exception("final federated consume failed")
            if self._profiler is not None:
                # torch.profiler stops on the thread that started it
                try:
                    self._profiler.close(self.engines[0].telemetry.ticks_total)
                except Exception:
                    logger.exception("profiler trace flush failed")
            for g in self.groups:
                for c, e in enumerate(g.engines):
                    if e._ckpt is not None:
                        try:
                            e._ckpt.final(self._member_snapshot(g, c, e, e._now()))
                        except Exception:
                            logger.exception("final member checkpoint failed")

    def _staged(self) -> bool:
        return any(
            k.buffer.pending for e in self.engines for k in (e.nodes, e.pods)
        )

    def _drain_ingest(self, deadline: float, pending=None) -> bool:
        """Round-robin the members' ingest queues until the tick is due;
        returns whether any event was drained. An arriving event during an
        extended idle sleep pulls the deadline back to one normal
        interval; consecutive empty polls back off exponentially, capped
        at 5 ms while group wires are in flight so a wire landing
        mid-drain is consumed promptly. Each member drains through its own
        ``_drain_apply`` into a raw-line buffer of its own, flushed (one
        batched native parse per member and kind) when the drain ends."""
        lag: dict[int, float] = {}
        drain: dict[int, float] = {}  # seconds each member spent applying
        bufs: dict[int, dict] = {}
        interval = self.config.tick_interval
        idle_sleep = 0.002
        got_event = False
        try:
            while self._running:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return got_event
                drained_any = False
                for i, e in enumerate(self.engines):
                    while True:
                        try:
                            item = e._q.get_nowait()
                        except queue.Empty:
                            break
                        if item is None:
                            continue
                        drained_any = True
                        if len(item) > 3:
                            lag[i] = max(lag.get(i, 0.0), time.monotonic() - item[3])
                        _t = time.perf_counter()
                        e._drain_apply(item, bufs.setdefault(i, {}))
                        drain[i] = drain.get(i, 0.0) + (time.perf_counter() - _t)
                if drained_any:
                    idle_sleep = 0.002
                    if not got_event:
                        got_event = True
                        deadline = min(deadline, time.monotonic() + interval)
                else:
                    if pending and pending[0].wire.is_ready():
                        try:
                            self._consume_one(pending)
                        except Exception:
                            logger.exception("mid-drain consume failed")
                        continue
                    cap = 0.005 if pending else 0.1
                    time.sleep(min(remaining, idle_sleep))
                    idle_sleep = min(idle_sleep * 2, cap)
        finally:
            for i, buf in bufs.items():
                if buf:
                    _t = time.perf_counter()
                    self.engines[i]._drain_flush(buf)
                    drain[i] = drain.get(i, 0.0) + (time.perf_counter() - _t)
            # each member's own slowest enqueue->processing delay this
            # tick (0 on a quiet one), queue depth and drain seconds, on
            # its own shard-labeled children
            for i, e in enumerate(self.engines):
                tel = e.telemetry
                if i in lag:
                    tel.observe_watch_lag(lag[i])
                else:
                    tel.set_gauge("watch_lag_seconds", 0.0)
                tel.set_gauge("ingest_queue_depth", e._q.qsize())
                if drain.get(i):
                    tel.observe_stage("drain", drain[i])
        return got_event

    # --------------------------------------- crash-durable restarts (ckpt)

    def _ckpt_service(self, dispatched: bool) -> None:
        """Per-member reconcile + checkpoint gathers, on the federated
        loop (the only thread that touches member pools and the stacked
        group states). Mirrors ClusterEngine._ckpt_service with each
        member refining and gathering its own [c*r, (c+1)*r) slice."""
        now = time.time() - self._epoch
        for g in self.groups:
            for c, e in enumerate(g.engines):
                r = e._restore
                if r is not None:
                    if r.expired() or (not r.gate_ready and not r.remaining):
                        e._end_restore(r)
                    else:
                        self._member_refine(g, c, e, r, now)
                    # tick until the pipeline flushes every pre-refine
                    # wire: their consumes re-arm the stale fresh-arm wake
                    # (see ClusterEngine._ckpt_service)
                    self._ckpt_force_ticks = (
                        max(1, int(self.config.pipeline_depth)) + 2
                    ) * len(self.groups)
                e._ckpt_gate(
                    dispatched,
                    staged=bool(e.nodes.buffer.pending or e.pods.buffer.pending),
                )
                e._ckpt_due(
                    now, dispatched,
                    lambda t, g=g, c=c, e=e: self._member_snapshot(g, c, e, t),
                )
        if self._ckpt_force_ticks > 0:
            self._ckpt_force_ticks -= 1
            self._idle_wake = time.monotonic()
            for g in self.groups:
                if g.wake is not None:
                    g.wake = min(g.wake, self._idle_wake)
        if not self.ready and self._running and all(
            e._startup_pending is None for e in self.engines
        ):
            self.ready = True

    def _member_refine(self, g: _Group, c: int, e: ClusterEngine, r, now: float) -> None:
        """Scatter member ``c``'s checkpointed timer residues into its
        slice of the group's stacked state (after the arming dispatch;
        rows whose init is still staged are skipped)."""
        for kind in _KINDS:
            if not r.kinds.get(kind):
                continue
            k = e.nodes if kind == "nodes" else e.pods
            staged = k.buffer.staged_rows() if k.buffer.pending else frozenset()
            cur_fire = field_numpy(g.stacked[kind], "fire_at")
            idx, fire, hb, gen = r.match_kind(
                kind, k.pool, staged, now, phase_h=k.phase_h, fire=cur_fire,
                offset=c * g.r,
            )
            if idx.size:
                g.stacked[kind] = refine_flush(
                    g.stacked[kind], idx, fire, hb, gen, offset=c * g.r, rows=g.r,
                )

    def _member_snapshot(self, g: _Group, c: int, e: ClusterEngine, now: float) -> dict:
        """Gather one member's checkpoint rows from its slice of the
        group's stacked state."""
        t0 = time.perf_counter()
        kinds: dict = {}
        for kind in _KINDS:
            fire, hb, gen, phase = gather_deadlines(g.stacked[kind])
            k = e.nodes if kind == "nodes" else e.pods
            staged = k.buffer.staged_rows() if k.buffer.pending else frozenset()
            kinds[kind] = ckpt_mod.gather_rows(
                kind, k.pool, phase, fire, hb, gen, staged, now,
                offset=c * g.r,
            )
        e.telemetry.note(
            "checkpoint_snapshot_seconds_last", time.perf_counter() - t0
        )
        return {"kinds": kinds}

    # ------------------------------------------------------------------ tick

    def tick_once(self) -> None:
        """One synchronous federated step: dispatch every group, then
        consume every wire — the pipelined loop calls the halves with up
        to pipeline_depth * groups wires in flight."""
        pending: "deque[_FedPending]" = deque()
        with self._device_ctx():
            self._tick_dispatch_all(pending)
            while pending:
                self._consume_one(pending)

    def _tick_dispatch_all(self, pending) -> None:
        """Dispatch one tick of every group, appending _FedPending records
        whose wires land on the host asynchronously."""
        if self._profiler is not None:
            self._profiler.step(self.engines[0].telemetry.ticks_total)
        t0 = time.perf_counter()
        self._maybe_regrow()
        now = time.time() - self._epoch
        if now >= REBASE_AFTER:
            # shared-epoch rebase (see ClusterEngine): shift every group's
            # stacked time fields and every member's epoch together
            self._epoch += now
            for e in self.engines:
                e._epoch = self._epoch
                e._inc("epoch_rebases_total")
            for g in self.groups:
                for kind in _KINDS:
                    g.stacked[kind] = rebase_times(g.stacked[kind], now)
            logger.info("federated epoch rebase at engine time %.1fs", now)
            now = 0.0
        any_dispatch = False
        flush_s = 0.0
        for g in self.groups:
            p = self._tick_group_dispatch(g, now)
            if p is not None:
                pending.append(p)
                any_dispatch = True
                flush_s += p.flush_s
            else:
                # empty group: clear its wake so a stale deadline cannot
                # keep the gate firing (its in-flight wires, if any, still
                # refresh the wake at consume)
                g.wake = None
        if not any_dispatch:
            wakes = [g.wake for g in self.groups if g.wake is not None]
            self._idle_wake = min(wakes) if wakes else None
        else:
            self.tracer.span("tick.dispatch", t0, time.perf_counter(), "dispatch")
        for e in self.engines:
            tel = e.telemetry
            tel.inc("ticks_total")
            tel.observe_stage("flush", flush_s)
            tel.set_gauge("nodes_managed", len(e.nodes.pool))
            tel.set_gauge("pods_managed", len(e.pods.pool))

    def _tick_group_dispatch(self, g: _Group, now: float) -> "_FedPending | None":
        """Flush members' staged writes into the group's stacked state and
        launch its kernels. Returns a _FedPending (wire in flight) or None
        when the group holds no rows."""
        r = g.r
        t0 = time.perf_counter()
        any_rows = False
        for kind in _KINDS:
            state = g.stacked[kind]
            for c, e in enumerate(g.engines):
                k = e.nodes if kind == "nodes" else e.pods
                if k.buffer.pending:
                    state = k.buffer.flush(state, offset=c * r, rows=r)
                    any_rows = True
                elif len(k.pool):
                    any_rows = True
            g.stacked[kind] = state
        t_flush = time.perf_counter()
        if not any_rows:
            return None  # empty group: nothing on device
        # with substeps, anchor the LAST substep at wall-now
        now_base = now - (g.fused.steps - 1) * g.fused.dt
        g.dispatch_counter.inc()
        _outs, wire = g.fused((g.stacked["nodes"], g.stacked["pods"]), now_base)
        return _FedPending(
            group=g,
            wire=wire,
            r=r,
            cap=r * len(g.engines),
            seqs=[e._release_seq for e in g.engines],
            now=now,
            mono=time.monotonic(),
            host_s=time.perf_counter() - t0,
            flush_s=t_flush - t0,
        )

    def _consume_one(self, pending) -> None:
        """Consume the oldest in-flight group wire: refresh fired rows'
        mirrors per member (skipping rows released since that dispatch)
        and emit patches. FIFO preserves per-object patch order."""
        p = pending.popleft()
        g = p.group
        t0 = time.perf_counter()
        counters, masks_fn, dues, rows_fn = unpack_wire(
            np.asarray(p.wire), [p.cap, p.cap], rows=True
        )
        t_wire = time.perf_counter()
        nd = float(dues.min())
        # per-group wake, newest consume wins (the single engine's
        # overwrite semantics, per group); the loop's gate reads the min
        # across groups. A min-merge on one shared field could only ever
        # decrease and would keep an idle federation dispatching.
        g.wake = None if nd == float("inf") else p.mono + max(0.0, nd - p.now)
        wakes = [q.wake for q in self.groups if q.wake is not None]
        self._idle_wake = min(wakes) if wakes else None
        if counters.any():
            now_str = now_rfc3339()
            masks = masks_fn()
            rows = None  # decoded lazily: heartbeat-only wires never need it
            r = p.r
            for i, kind in enumerate(_KINDS):
                if not (int(counters[i]) or int(counters[2 + i])):
                    continue
                dirty, deleted, hb = masks[i]
                for c, e in enumerate(g.engines):
                    k = e.nodes if kind == "nodes" else e.pods
                    lo, hi = c * r, (c + 1) * r
                    # numpy views of member c's slice of the stacked wire
                    d_c, del_c, hb_c = dirty[lo:hi], deleted[lo:hi], hb[lo:hi]
                    # rows released since this dispatch: the mask bits
                    # describe the old occupant (see ClusterEngine)
                    seq = p.seqs[c]
                    stale = [
                        li for li, s in k.released_at.items() if s > seq and li < r
                    ]
                    if stale:
                        d_c[stale] = False
                        del_c[stale] = False
                        hb_c[stale] = False
                    trans_c = int(np.count_nonzero(d_c) + np.count_nonzero(del_c))
                    if trans_c:
                        e.telemetry.inc_kind("transitions_total", kind, trans_c)
                        idxs = np.nonzero(d_c | del_c)[0]
                        if rows is None:
                            rows = rows_fn()
                        ph, cb = rows[i]
                        # fired rows only: freshly acquired rows keep
                        # their ingest-time mirror values
                        k.phase_h[idxs] = ph[lo:hi][idxs]
                        k.cond_h[idxs] = cb[lo:hi][idxs]
                    if trans_c or hb_c.any():
                        _t = time.perf_counter()
                        e._emit(kind, k, d_c, del_c, hb_c, now_str)
                        _t1 = time.perf_counter()
                        e.telemetry.observe_stage("emit", _t1 - _t)
                        self.tracer.span(
                            "tick.emit", _t, _t1, "emit",
                            {"kind": kind, "shard": e._member_index},
                        )
        # prune each member's release log against its oldest still-in-
        # flight dispatch (members belong to exactly one group)
        next_p = next((q for q in pending if q.group is g), None)
        for c, e in enumerate(g.engines):
            e._prune_released(next_p.seqs[c] if next_p is not None else e._release_seq)
        # host seconds of this group's tick on the federated thread:
        # flush and launch, the wait for the wire, unpack and emit. Every
        # member records it (a shared-tick value, un-summed in metrics)
        t_end = time.perf_counter()
        elapsed = t_end - t0 + p.host_s
        self.tracer.span(
            "tick.consume", t0, t_end, "consume",
            {"wire_wait_us": round((t_wire - t0) * 1e6, 1)},
        )
        for e in self.engines:
            tel = e.telemetry
            tel.observe_tick(elapsed)
            tel.observe_stage("kernel", t_wire - t0)

    # ------------------------------------------------------------------ grow

    def _maybe_regrow(self) -> None:
        """If any member's pool grew (ClusterEngine._grow during ingest),
        rebuild that member's GROUP at the new common per-cluster capacity
        (``ops/state.regrow_stacked``: member c's rows move to offset
        c * new_r, re-split over the mesh); other groups keep their size."""
        for g in self.groups:
            want = max(k.capacity for e in g.engines for k in (e.nodes, e.pods))
            if want <= g.r:
                continue
            n = len(g.engines)
            new_r = _pad_cluster_capacity(want, n, self.mesh.size)
            logger.info(
                "federation regrow (%d-member group): %d -> %d rows/cluster",
                n, g.r, new_r,
            )
            for e in g.engines:
                for k in (e.nodes, e.pods):
                    if k.capacity < new_r:
                        k.grow(new_r)
            for kind in _KINDS:
                g.stacked[kind] = regrow_stacked(g.stacked[kind], n, new_r)
            g.r = new_r

    # --------------------------------------------------------------- metrics

    @property
    def metrics(self) -> dict:
        """Aggregated flat counters across members (gauges are summed too:
        nodes/pods managed are totals across the federation), plus one
        ``group<i>_dispatches_total`` per rule-set group. The per-shard
        series are the registry's."""
        agg: dict = {}
        for m in (e.metrics for e in self.engines):
            for name, v in m.items():
                if name == "watch_lag_seconds":
                    # worst-case lag, not a sum over members
                    agg[name] = max(agg.get(name, 0.0), v)
                else:
                    agg[name] = agg.get(name, 0) + v
        n = len(self.engines)
        # every member records the same shared-tick values: un-sum them
        for name in _SHARED_TICK_VALUES:
            if name in agg:
                agg[name] = agg[name] // n if isinstance(agg[name], int) else agg[name] / n
        for i, g in enumerate(self.groups):
            agg[f"group{i}_dispatches_total"] = g.dispatch_counter.value
        return agg

    def metrics_text(self) -> str:
        """The shared registry's exposition (group dispatch counters,
        ``kwok_degraded``, the ``kwok_fed_*`` aggregates, refreshed here
        so a scrape sees one consistent view)."""
        flats = [e.telemetry.legacy_dict() for e in self.engines]
        self._agg_lag.set(max(m.get("watch_lag_seconds", 0.0) for m in flats))
        self._agg_depth.set(sum(m.get("ingest_queue_depth", 0) for m in flats))
        self._agg_nodes.set(sum(m.get("nodes_managed", 0) for m in flats))
        self._agg_pods.set(sum(m.get("pods_managed", 0) for m in flats))
        return self.registry.render()

    def trace_chrome(self) -> dict:
        """One Chrome trace-event document: the federated loop's spans
        and every member's (pump, patch and ingest spans land
        member-side), under the labels ``federation`` and ``shard<i>``."""
        return merge_chrome_traces(
            [self.tracer] + [e.tracer for e in self.engines],
            labels=["federation"] + [f"shard{i}" for i in range(len(self.engines))],
        )

    def process_metrics_text(self) -> str:
        """The process-wide error counters (``telemetry/errors.py``)."""
        from kwok_tpu_torch.telemetry.errors import render_nonempty

        return render_nonempty()
