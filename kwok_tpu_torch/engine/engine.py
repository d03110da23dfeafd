"""ClusterEngine: the fake kubelet on a torch device.

The engine of ``kwok_tpu.engine.engine`` on PyTorch. With one lane:

  watch threads ──> ingest queue ──> tick thread ──> patch executor
                                      │    ▲
                                      ▼    │
                               device RowState (resident)

- Watch threads follow client-go's reflector: register a watch, list and
  queue the snapshot plus a RESYNC marker (watch-then-list), then stream;
  a broken stream resumes from the last revision it saw (bookmarks
  included) and re-lists only after a 410 or when asked to
  (``resync_streams``). Replayed MODIFIED/DELETED events older than a
  row's last ingested revision are dropped (``_stale_dict_event``).
- Over HTTP the watch threads queue undecoded lines: packed batches
  from the native socket reader (``RAWB``) or single lines (``RAW``),
  plus one ``GEN`` marker per stream. The tick thread parses a whole
  drain in ONE C call (``kwok_tpu_torch/native``); echoes of rows already
  processed drop by fingerprint, stale revisions drop by rv, and new
  Pending pods stage as one columnar block (``_pod_ingest_cols``). A
  broken stream resumes from the last revision it received (its last
  line's), as client-go does, never from behind the drain's backlog.
- The tick thread is the ONLY mutator of engine state: it drains the
  ingest queue into staged row writes, flushes them to the device, runs
  the fused tick (``ops/tick.MultiTickKernel``: the CUDA tick kernel per
  kind plus the packed wire), and turns the wire's masks into patch jobs.
  All of its device work runs on one CUDA stream of its own; up to
  ``pipeline_depth`` dispatches are in flight, each with its own pinned
  host wire.
- Egress leaves in batches. Over plain ``http://`` a tick's dirty pods
  become ONE executor job: their status patches are spliced into the
  byte templates compiled from the rules and pipelined over keep-alive
  connections in one C call (``_emit_pods_tpl``, the native ``Pump``);
  heartbeats, node patches and deletes go out as pump batches too. Each
  pod patch whose server-side status is scalar-only seeds ``fp_expect``,
  so its watch echo drops at tier 2 without a parse. Requests whose
  connection died are resent as whole frames under ``PUMP_RESEND``;
  past its deadline the engine degrades (reason ``pump``) and sheds;
  other failures fall back to the per-object Python path. Without the
  native library (``KWOK_TPU_NATIVE=0``), over TLS or in process, the
  executor sends one job per object. The executor bounds API fan-out
  (default 16).

With ``drain_shards`` above one (the CLI's auto default) the engine runs
the threaded lanes of ``engine/lanes.py`` instead: a router, a drain and
an emit worker per lane, and a coordinator tick thread that owns one
stacked device state per kind. The engine then holds no rows of its own.

With ``lane_procs`` as well, the lanes are processes
(``engine/proclanes.py``): this engine then holds no device rows, no
stream and no CUDA context; it runs the watches, a router, a supervisor
and a status coordinator, and each lane process runs a single-lane
engine of its own over its hash shard, on its own stream.

With a checkpoint directory the device-owning thread gathers the timer
residues every ``checkpoint_interval`` seconds and at stop, and a start
on a directory holding a checkpoint refines the re-listed rows' timers
from it (``resilience/checkpoint.py``).

A federation (``engine/federation.py``) runs engines of this class as
members, each started with ``run_tick_loop=False``: its rows live in a
slice of a stacked state that the federation's loop ticks.

Workers run under the watchdog (``resilience/watchdog.py``): the watch
threads here, the lanes' router, drain and emit workers, the process
lanes' router and supervisor. A crashed worker restarts in place within
``worker_restart_budget`` restarts per ``worker_restart_window``, and its
restart heals what the crash may have eaten (``_worker_restarted_resync``);
past the budget the engine degrades. With ``faults`` (or
``KWOK_TPU_FAULTS``) the fault plane of ``resilience/faults.py`` wraps the
client and the pumps and kills supervised workers; without it there is no
plane and nothing is wrapped.

With ``audit_interval`` (or ``KWOK_TPU_AUDIT_INTERVAL``) a supervised
``kwok-audit`` worker runs the anti-entropy auditor
(``resilience/antientropy.py``): a paced pass that diffs a budgeted LIST
window against the rows and repairs each divergent row by re-ingest
through ``_q``. Lane engines never audit (the parent's auditor reads
their rows); under process lanes each lane process audits its own shard
and the parent mirrors their ``drift`` flags.

Names and logic of the ingest, tick and emit methods follow the JAX
package's engine so each has its counterpart there. The mesh, HA and CNI
are not part of this engine.

Telemetry is ``telemetry/engine_metrics.EngineTelemetry``: typed handles
on a labeled registry (``registry``, rendered by ``metrics_text()``;
``metrics`` is its flat view) and an always-on span ring (``tracer``,
``trace_chrome()``, dumped at stop to ``trace_dump`` or
``KWOK_TPU_TRACE``). Spans: ``tick.drain``, ``tick.dispatch``,
``tick.consume``, ``tick.emit``, ``pump.send`` and 1 in
``trace_sample_every`` pods' ``pod.ingest_to_patch``. ``profile_dir``
runs ``torch.profiler`` over ticks [2, 102) on the tick thread
(``profiling.TickProfiler``); a fresh degradation saves the apiserver's
``/debug/flight`` to ``flight_dir`` (or ``KWOK_TPU_FLIGHT_DIR``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import quote as _urlquote

import numpy as np
import torch

from kwok_tpu_torch.config.types import resolve_drain_shards
from kwok_tpu_torch.edge.ippool import IPPool
from kwok_tpu_torch.edge.kubeclient import (
    ADDED,
    BOOKMARK,
    DELETED,
    MODIFIED,
    KubeClient,
    TooLargeResourceVersion,
    TooManyRequests,
    WatchExpired,
)
from kwok_tpu_torch.edge.merge import (
    node_status_patch_needed,
    pod_status_patch_needed,
)
from kwok_tpu_torch.edge.render import (
    _NODE_CONDITION_META,
    now_rfc3339,
    render_node_heartbeat,
    render_node_status,
    render_pod_status,
    rfc3339,
)
from kwok_tpu_torch.edge.selectors import parse_selector
from kwok_tpu_torch import native, profiling
from kwok_tpu_torch.locks import reclaimable
from kwok_tpu_torch.engine.rowpool import (
    EF_RENDER,
    EF_RGATES,
    EF_SCALAR,
    RowPool,
    shard_of,
)
from kwok_tpu_torch.models import (
    compile_emit_templates,
    compile_rules,
    default_node_rules,
    default_pod_rules,
)
from kwok_tpu_torch.models.defaults import (
    SEL_HEARTBEAT,
    SEL_MANAGED,
    SEL_ON_MANAGED_NODE,
)
from kwok_tpu_torch.models.lifecycle import (
    NODE_PHASES,
    POD_PHASES,
    LifecycleRule,
    ResourceKind,
)
from kwok_tpu_torch.ops.state import RowState, grow as grow_state, new_row_state
from kwok_tpu_torch.ops.tick import (
    REBASE_AFTER,
    MultiTickKernel,
    gather_deadlines,
    rebase_times,
    unpack_wire,
)
from kwok_tpu_torch.ops.updates import (
    InitBatch,
    UpdateBatch,
    UpdateBuffer,
    init_rows,
    refine_flush,
    update_rows,
)
from kwok_tpu_torch.resilience import checkpoint as ckpt_mod
from kwok_tpu_torch.resilience import faults as resilience_faults
from kwok_tpu_torch.resilience.policy import (
    PATCH_RETRY,
    PUMP_RESEND,
    WATCH_RECONNECT,
    Degradation,
)
from kwok_tpu_torch.resilience.watchdog import Watchdog
from kwok_tpu_torch.telemetry.engine_metrics import EngineTelemetry
from kwok_tpu_torch.telemetry.errors import swallowed, wire_reject

logger = logging.getLogger("kwok_tpu_torch.engine")


def _wire(s: str) -> bytes:
    """A server-provided string as the bytes it came in: a name or value
    the native parser decoded from a garbled line carries its bytes that
    are not UTF-8 as surrogate escapes, and they go back out as they came
    (a strict encode raises, and a raise mid-batch leaves the batch's
    other rows half-staged)."""
    return s.encode("utf-8", "surrogateescape")


def _quote(s: str) -> str:
    """``urllib.parse.quote`` of a server-provided path segment, its
    surrogate escapes percent-encoded as the bytes they stand for."""
    return _urlquote(s, errors="surrogateescape")

_NODE_READY_BITS = 1 << NODE_PHASES.condition_bit("Ready")
# status keys whose strategic merge is plain replacement: when the current
# status has only these, merge(current, rendered) == rendered exactly
_SCALAR_STATUS_KEYS = frozenset({"phase", "hostIP", "podIP", "startTime"})
_PENDING = POD_PHASES.phase_id("Pending")
_NODE_READY = NODE_PHASES.phase_id("Ready")
_NODE_OBSERVED = NODE_PHASES.phase_id("Observed")

def _rv_of(meta: dict) -> int:
    """metadata.resourceVersion as an int, 0 when absent or unparseable
    (the object then carries no identity a checkpoint could match)."""
    try:
        return int(meta.get("resourceVersion") or 0)
    except (TypeError, ValueError):
        return 0


def _ctr_blob(containers) -> bytes:
    """A container list in the native renderers' form: "name\\x1fimage"
    records joined by \\x1e."""
    if not containers:
        return b""
    return b"\x1e".join(
        f"{c.get('name') or ''}\x1f{c.get('image') or ''}".encode()
        for c in containers
    )


@dataclasses.dataclass
class EngineConfig:
    """Mirrors the ported part of ``kwok_tpu.engine.EngineConfig``, plus
    ``device``: the torch device the rows live on. It is "cuda" unless
    the caller asks for the CPU (the tests pass "cpu"); a "cuda" engine
    on a host without a card raises."""

    manage_all_nodes: bool = False
    manage_nodes_with_annotation_selector: str = ""
    manage_nodes_with_label_selector: str = ""
    disregard_status_with_annotation_selector: str = ""
    disregard_status_with_label_selector: str = ""
    cidr: str = "10.0.0.1/24"
    node_ip: str = "196.168.0.1"
    tick_interval: float = 0.05
    # inner simulated ticks per device dispatch (MultiTickKernel steps)
    tick_substeps: int = 1
    heartbeat_interval: float = 30.0
    parallelism: int = 16
    initial_capacity: int = 4096
    # max dispatches in flight before the tick loop blocks on the oldest
    pipeline_depth: int = 8
    node_rules: list[LifecycleRule] | None = None
    pod_rules: list[LifecycleRule] | None = None
    # hash-partitioned host lanes of the drain+emit pipeline
    # (engine/lanes.py): 1 = the single-lane engine (the library/test
    # default); 0 = auto (config.types.auto_drain_shards: cpu_count capped
    # by max_drain_shards), what the CLI defaults to
    drain_shards: int = 1
    # cap on the AUTO lane count (0 = built-in default)
    max_drain_shards: int = 0
    # process lanes (engine/proclanes.py): with more than one lane, each
    # lane is a spawned process running the single-lane engine over its
    # hash shard; needs an HTTP apiserver
    lane_procs: bool = False
    # deterministic fault-injection spec (resilience/faults.py grammar).
    # "" = disabled (falls back to KWOK_TPU_FAULTS); the literal "off"
    # disables even under the env var (lane engines). When set, the
    # client transport, the pumps and the supervised workers are faulted
    faults: str = ""
    # anti-entropy auditor (resilience/antientropy.py): seconds between
    # passes that diff a budgeted LIST window against the rows by (uid,
    # rv, phase) and repair each divergent row by re-ingest. 0 = off (the
    # default; falls back to KWOK_TPU_AUDIT_INTERVAL); negative = off even
    # under the env var (lane engines). Off means no thread and no LISTs
    audit_interval: float = 0.0
    # watchdog budget: more than this many restarts of one worker (a
    # watch thread, a lane worker, a lane process respawn, the router,
    # the supervisor) within the window degrades the engine (/readyz 503)
    worker_restart_budget: int = 5
    worker_restart_window: float = 30.0
    # graceful degradation: shed routed events when a lane queue is deeper
    # than this (kwok_dropped_jobs_total + kwok_degraded{reason=}, /readyz
    # 503) instead of letting it grow without bound; 0 = never shed
    shed_queue_depth: int = 0
    # crash-durable restarts (resilience/checkpoint.py): the device timer
    # residues are checkpointed to <dir>/engine.ckpt.json (a lane process:
    # lane<i>.ckpt.json) every
    # checkpoint_interval seconds (atomic rename), and a start on a
    # directory holding one refines the re-listed rows' timers from it.
    # "" = disabled (falls back to KWOK_TPU_CHECKPOINT_DIR); the literal
    # "off" disables even under the env var (lane engines)
    checkpoint_dir: str = ""
    checkpoint_interval: float = 2.0
    # when set, a torch.profiler trace of ticks [2, 102) is written here
    # (profiling.TickProfiler; a lane process writes <dir>/lane<i>)
    profile_dir: str = ""
    # when set, the span ring is dumped here at stop() as Chrome
    # trace-event JSON (KWOK_TPU_TRACE=<path> works too); the tracer is
    # always on, /debug/trace is the live view
    trace_dump: str = ""
    # when set (or KWOK_TPU_FLIGHT_DIR), a FRESH degradation reason saves
    # the apiserver's /debug/flight dump here (HTTP masters only)
    flight_dir: str = ""
    # 1-in-N sampling of pods for ingest->patch spans; 0 disables
    trace_sample_every: int = 256
    device: str = "cuda"

    def validate(self) -> None:
        if not (
            self.manage_all_nodes
            or self.manage_nodes_with_annotation_selector
            or self.manage_nodes_with_label_selector
        ):
            # controller.go:98 "no nodes are managed"
            raise ValueError("no nodes are managed")


def _selector_bits(table, extra: tuple[str, ...]) -> dict[str, int]:
    names = list(table.selector_names)
    for e in extra:
        if e not in names:
            names.append(e)
    if len(names) > 32:
        raise ValueError("too many selector bits")
    return {n: i for i, n in enumerate(names)}


@dataclasses.dataclass
class _PendingTick:
    """A dispatched-but-unconsumed tick in the pipelined loop."""

    wire: object  # ops.tick.Wire; self-contained (pack_rows wire)
    caps: list  # per-kind capacities AT DISPATCH (grow may change them)
    seq: int  # engine._release_seq at dispatch (stale-mask filtering)
    now: float  # engine time of the dispatch (idle-wake arithmetic)
    mono: float  # monotonic clock at dispatch (idle-wake anchor)
    host_s: float  # host seconds spent in the dispatch half


class _PumpGroup:
    """Several native pump connection groups, each behind its own lock: a
    sender claims the first free group (a non-blocking probe from a
    round-robin start) and blocks only when every group is busy, so two
    executor jobs with ready batches ride two groups instead of queueing
    on one lock."""

    def __init__(self, pumps) -> None:
        self._pumps = [(p, reclaimable()) for p in pumps]
        self._next = 0  # racy round-robin hint; exactness does not matter

    def __len__(self) -> int:
        return len(self._pumps)

    def _on_claimed_group(self, fn):
        """fn(pump) on the first free group, blocking on the start group
        only when every group is busy: the one claim discipline of
        ``send`` and the fused emit."""
        n = len(self._pumps)
        self._next += 1
        start = self._next % n
        for i in range(n):
            p, lock = self._pumps[(start + i) % n]
            if lock.acquire(blocking=False):
                try:
                    # fn blocks on the wire by design: this leaf lock only
                    # serializes sends on one connection group
                    return fn(p)
                finally:
                    lock.release()
        p, lock = self._pumps[start]
        with lock:
            return fn(p)

    def send(self, reqs):
        return self._on_claimed_group(lambda p: p.send(reqs))

    def emit_spliced(self, native_mod, kw: dict):
        """The fused template render and send on one claimed group. None
        when the pumps are not plain native pumps (the process-lane slot
        guard, test stubs): the caller then renders and sends as two
        calls through ``send``, so a wrapper sees every request and a
        fused call never tunnels past it."""
        if not isinstance(self._pumps[0][0], native_mod.Pump):
            return None
        return self._on_claimed_group(
            lambda p: native_mod.emit_pods(pump=p, **kw)
        )

    def send_ordered(self, batches):
        """Several batches back to back on ONE group (a finalizer strip
        must be answered before its delete is sent); their statuses."""
        n = len(self._pumps)
        self._next += 1
        p, lock = self._pumps[self._next % n]
        with lock:
            return [p.send(reqs) for reqs in batches]

    def close(self) -> None:
        for p, lock in self._pumps:
            with lock:
                p.close()


class _Kind:
    """Per-resource-kind engine state: device rows (None when another
    thread owns them: a lane's rows live in the coordinator's stacked
    state) and host bookkeeping."""

    def __init__(self, table, capacity: int, device: "torch.device | None"):
        self.table = table
        self.capacity = capacity
        self.state: "RowState | None" = (
            new_row_state(capacity, device) if device is not None else None
        )
        self.pool = RowPool(capacity)
        self.buffer = UpdateBuffer()
        self.phase_h = np.zeros(capacity, np.int32)
        self.cond_h = np.zeros(capacity, np.uint32)
        # row -> release generation (engine._release_seq at release time):
        # lets a pipelined consume skip mask bits of rows freed (and maybe
        # re-acquired) after that tick was dispatched
        self.released_at: dict[int, int] = {}

    def grow(self, new_capacity: int) -> None:
        """Grow in place (device state, when held, copied into a larger
        one)."""
        if self.state is not None:
            self.state = grow_state(self.state, new_capacity)
        self.capacity = new_capacity
        self.pool.grow(new_capacity)
        extra = new_capacity - self.phase_h.shape[0]
        self.phase_h = np.concatenate([self.phase_h, np.zeros(extra, np.int32)])
        self.cond_h = np.concatenate([self.cond_h, np.zeros(extra, np.uint32)])


def _warm_scatter(state: RowState) -> RowState:
    """Both ingest scatters once on row 0, writing its initial state back
    (the caller knows no row is live), so the first ingest wave does not
    pay for loading their device code."""
    one = np.zeros(1, np.int32)
    state = init_rows(state, InitBatch(
        idx=one, active=np.zeros(1, bool), phase=one,
        cond_bits=np.zeros(1, np.uint32), sel_bits=np.zeros(1, np.uint32),
        has_deletion=np.zeros(1, bool),
    ))
    return update_rows(state, UpdateBatch(
        idx=one, sel_bits=np.zeros(1, np.uint32),
        has_deletion=np.zeros(1, bool),
    ))


class ClusterEngine:
    # False for a lane of engine/lanes.py: its rows live in the
    # coordinator's stacked state, so it holds no stream and no device rows
    _owns_device = True

    def __init__(self, client: KubeClient, config: EngineConfig,
                 telemetry: "EngineTelemetry | None" = None) -> None:
        config.validate()
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineConfig.device={config.device!r} but no CUDA device "
                "is available (pass device='cpu' to run on the CPU)"
            )
        # the fault plane: None unless a spec is configured, and then the
        # disabled case wraps nothing and costs nothing. Wrapping is
        # idempotent, so a lane engine handed its parent's wrapped client
        # does not inject twice
        self._faults = resilience_faults.from_config(config.faults)
        if self._faults is not None:
            client = self._faults.wrap_client(client)
            rate = self._faults.spec.rate("clock.jump")
            if rate is not None and rate.p > 0:
                # a hostile clock: every engine `now` read is skewed. An
                # instance attribute only when the spec asks, so the
                # unfaulted _now stays a two-op method
                self._now = self._skewed_now
        self.client = client
        self.config = config
        self._n_lanes = resolve_drain_shards(
            config.drain_shards, config.max_drain_shards
        )
        # process lanes: the lane processes own every row and stream, so
        # this engine touches no device at all
        proc = self._owns_device and self._n_lanes > 1 and config.lane_procs
        self.ippool = IPPool(config.cidr)

        self._manage_annotation = parse_selector(
            config.manage_nodes_with_annotation_selector
        )
        self._disregard_annotation = parse_selector(
            config.disregard_status_with_annotation_selector
        )
        self._disregard_label = parse_selector(
            config.disregard_status_with_label_selector
        )

        node_rules = (
            config.node_rules if config.node_rules is not None else default_node_rules()
        )
        pod_rules = (
            config.pod_rules if config.pod_rules is not None else default_pod_rules()
        )
        ntab = compile_rules(node_rules, ResourceKind.NODE)
        ptab = compile_rules(pod_rules, ResourceKind.POD)
        self.node_bits = _selector_bits(ntab, (SEL_MANAGED, SEL_HEARTBEAT))
        self.pod_bits = _selector_bits(ptab, (SEL_MANAGED, SEL_ON_MANAGED_NODE))
        self._pod_phases = ptab.space.phases
        self._pod_phase_ids = {
            name: i for i, name in enumerate(ptab.space.phases)
        }
        hb_bit = self.node_bits[SEL_HEARTBEAT]
        # nodes + pods tick in ONE dispatch (ops/tick.MultiTickKernel)
        self._fused_specs = [
            (ntab, config.heartbeat_interval, (), hb_bit),
            (ptab, config.heartbeat_interval, (), -1),
        ]
        self._fused: MultiTickKernel | None = None

        # every device operation of the engine runs on this stream (the
        # tick thread's); rows are allocated on it too, so no tensor the
        # engine owns is ever used across streams
        self._stream = (
            torch.cuda.Stream(self.device)
            if self._owns_device and not proc and self.device.type == "cuda"
            else None
        )
        # under lanes the LaneSet owns all rows: the engine's own kinds
        # stay host-only at a token capacity, and a lane's kinds are
        # host-only (its device rows are a slice of the stacked state)
        cap = config.initial_capacity
        if self._n_lanes > 1:
            cap = min(cap, 1024)
        dev = self.device if self._owns_device and self._n_lanes <= 1 else None
        with self._device_ctx():
            self.nodes = _Kind(ntab, cap, dev)
            self.pods = _Kind(ptab, cap, dev)

        self.node_has: set[str] = set()  # nodesSets (need-heartbeat membership)
        self.pods_by_node: dict[str, set[tuple[str, str]]] = {}

        self._epoch = time.time()
        self.start_time = rfc3339(None)
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._watches: dict[str, object] = {}
        # each kind's watch selectors (_spawn_watch): the auditor lists
        # through the same ones, so its window is what this engine tracks
        self._watch_opts: dict[str, dict] = {}
        self._threads: list[threading.Thread] = []
        self._running = False
        self._stop_evt = threading.Event()
        self._executor: ThreadPoolExecutor | None = None
        # ONE lock for IP/meta allocation bookkeeping: pool get/use/put,
        # podIP commits and row-release reads in _pod_deleted
        self._alloc_lock = reclaimable()
        # monotonic wake-up for the idle tick loop; 0 = tick immediately,
        # None = nothing scheduled on device (sleep until an event arrives)
        self._idle_wake: float | None = 0.0
        # bumped on every row release; _PendingTick.seq snapshots it at
        # dispatch so consume can tell which mask bits went stale
        self._release_seq = 0
        # telemetry: labeled registry + span tracer. A federation passes a
        # shard-labeled slice of its shared registry, a lane its parent's
        self.telemetry = telemetry if telemetry is not None else EngineTelemetry()
        self.tracer = self.telemetry.tracer
        self.registry = self.telemetry.registry
        # 1-in-N ingest->patch span sampling (0 disables); the cadence
        # counter is bumped without a lock: a lost racy increment only
        # shifts which pod is traced
        self._trace_every = max(0, int(config.trace_sample_every))
        self._trace_n = 0
        # False for a federation member (the federation's loop ticks it
        # and writes one merged trace dump) and for a lane
        self._owns_tick = self._owns_device
        # the device profiler of the tick thread (start() builds it when
        # profile_dir is set and this engine runs a tick thread)
        self._profiler: "profiling.TickProfiler | None" = None
        # the degraded-mode ledger behind /readyz's 503; a fresh reason
        # saves the apiserver's flight recorder (_flight_dump_on_degrade)
        self._degradation = Degradation(
            self.registry, on_set=self._flight_dump_on_degrade
        )
        # monotonic stamp of the last shed-clear stream resync (written by
        # lane drain workers; see lanes._SHED_RESYNC_MIN_S)
        self._shed_resync_at = 0.0
        # crash-durable restarts: config < KWOK_TPU_CHECKPOINT_DIR; "off"
        # disables even under the env var. The Checkpointer and the
        # RestoreSession are built in start().
        self._ckpt_dir = (
            config.checkpoint_dir
            or os.environ.get("KWOK_TPU_CHECKPOINT_DIR", "")
        ).strip()
        if self._ckpt_dir == "off":
            self._ckpt_dir = ""
        # the anti-entropy auditor's cadence: config < env, as for the
        # checkpoint directory; a NEGATIVE config value is off even under
        # the env var (lane engines: ONE auditor, the parent's). The
        # auditor itself is built in start()
        if config.audit_interval < 0:
            self._audit_interval = 0.0
        elif config.audit_interval > 0:
            self._audit_interval = float(config.audit_interval)
        else:
            env_aud = os.environ.get("KWOK_TPU_AUDIT_INTERVAL", "").strip()
            try:
                self._audit_interval = (
                    float(env_aud) if env_aud and env_aud != "off" else 0.0
                )
            except ValueError:
                logger.warning(
                    "KWOK_TPU_AUDIT_INTERVAL=%r is not a number; "
                    "auditor stays off", env_aud,
                )
                self._audit_interval = 0.0
        self._auditor = None  # resilience.antientropy.AntiEntropyAuditor
        # <checkpoint_dir>/<name>.ckpt.json: "engine", as the JAX
        # package's engine names it (one file restores in either
        # package); a lane process writes lane<i>, a federation member
        # member<i>
        self._ckpt_name = "engine"
        # appended to the watch threads' names (a federation member's
        # "-m<i>" says whose watch a thread is)
        self._worker_suffix = ""
        self._ckpt: "ckpt_mod.Checkpointer | None" = None
        self._restore: "ckpt_mod.RestoreSession | None" = None
        # guards the startup gate's bookkeeping (drain workers of several
        # lanes mark their RESYNCs concurrently), the restore swap and the
        # integrity-doubt re-list's timer
        self._ckpt_lock = reclaimable()
        # kinds whose first full re-list is not ingested yet; None when
        # the startup gate is not armed (before start()) or finished
        self._startup_pending: set[str] | None = None
        self._startup_lanes: dict[str, set] = {}
        self._startup_flush_wait = False
        self._startup_t0 = 0.0
        # iterations left during which the tick loop is forced awake after
        # a timer refine: in-flight wires dispatched BEFORE the refine
        # still carry fresh-arm deadlines, and each of their consumes
        # overwrites the idle wake (device-owning thread only)
        self._ckpt_force_ticks = 0
        # a dispatch ran since the last checkpoint gather (device thread)
        self._ckpt_dirty = False
        self.ready = False
        # supervision (resilience/watchdog.py), built in start()
        self._watchdog = None
        # integrity-doubt re-lists (_integrity_resync): the kinds in
        # doubt, the last re-list's monotonic stamp, a deferred one's timer
        self._wire_doubt: set[str] = set()
        self._wire_resync_at = 0.0
        self._wire_timer: "threading.Timer | None" = None
        # the watch streams' bookkeeping, under _gen_lock: the kinds whose
        # next reconnect must re-list whatever revision the loop holds
        # (resync_streams), and each kind's stream generation, bumped
        # whenever its resume revision dies (_expire_stream)
        self._gen_lock = reclaimable()
        self._resync_req: set[str] = set()
        self._stream_gen: dict[str, int] = {}
        # monotonic stamp of the last rewind-triggered resync: bounds the
        # re-list rate of a store that keeps rewinding (_note_rv_rewind)
        self._rv_rewind_at = 0.0
        # the native edge (kwok_tpu_torch/native); None under
        # KWOK_TPU_NATIVE=0 or when the library cannot be built (the
        # loader logs that at WARNING). With it, HTTP watch streams queue
        # undecoded lines that the drain parses (_drain_apply), and
        # egress leaves in pump batches (_emit)
        self._codec = native if native.enabled() and native.available() else None
        # the draining thread's batch parser
        self._batch_parser = (
            native.EventParser() if self._codec is not None else None
        )
        # the pod status patches as byte templates, one per target phase:
        # the emit splices each batch's columns in C and ships it in the
        # same call. KWOK_TPU_NATIVE_EMIT=0 keeps the generic native
        # render (per-row meta gather + render_pod_statuses) and stages
        # no columns at ingest
        self._emit_tpl = None
        if self._codec is not None and os.environ.get(
            "KWOK_TPU_NATIVE_EMIT", "1"
        ) != "0":
            try:
                self._emit_tpl = self._codec.EmitTable(
                    compile_emit_templates(ptab)
                )
            except Exception:
                logger.warning(
                    "emit templates unavailable; the generic native "
                    "emit stays active", exc_info=True,
                )
        #: ingest stages the emit byte columns only when the template
        #: path reads them
        self._emit_cols = self._emit_tpl is not None
        self._node_ip_b = (config.node_ip or "").encode()
        self._gone_id = self._pod_phase_ids.get("Gone", -1)
        # the batched pipelined egress (native/pump.cc) to a plain-HTTP
        # apiserver, built at first emit as a _PumpGroup (_get_pump):
        # several connection groups with a lock each, so concurrent emit
        # jobs never serialize on one lock. KWOK_TPU_PUMP_GROUPS groups of
        # _pump_nconn connections (a lane takes 2 groups)
        self._pump = None
        self._pump_tried = False
        self._pump_base = ""
        self._pump_base_b = b""
        # the outermost pump wrapper: a process lane parks its emit frames
        # in its shared-memory replay slot here; None costs nothing
        self._pump_wrap = None
        self._pump_groups = max(1, int(os.environ.get("KWOK_TPU_PUMP_GROUPS", "4")))
        self._pump_nconn = 2
        self._hb_cond_meta = [
            (name, *_NODE_CONDITION_META.get(name, ("KwokRule", name)))
            for name in NODE_PHASES.conditions
        ]
        # pre-partitioned routing: the same C call computes each event's
        # lane and the per-lane index runs; KWOK_TPU_NATIVE_ROUTE=0 keeps
        # the per-record Python route (the ordering oracle's other arm)
        self._native_route = os.environ.get("KWOK_TPU_NATIVE_ROUTE", "1") != "0"
        # the RAW paths' resume revision per kind (written by the draining
        # thread as it parses, read by the watch loop on reconnect) and the
        # stream generation the buffered lines belong to (mirrored from
        # the GEN markers as they drain); both under _gen_lock
        self._watch_rv: dict[str, int] = {}
        self._drain_gen: dict[str, int] = {}
        # the record path cannot evaluate disregard selectors: they match
        # labels and annotations a record does not carry
        self._record_needs_full_path = (
            self._disregard_annotation is not None
            or self._disregard_label is not None
        )
        # the threaded lanes (engine/lanes.py) or the process lanes
        # (engine/proclanes.py); lane engines are built with
        # drain_shards=1, so neither recurses
        self._lanes = None
        self._proc = None
        if proc:
            from kwok_tpu_torch.engine.proclanes import ProcLaneSet

            self._proc = ProcLaneSet(self, self._n_lanes)
        elif self._owns_device and self._n_lanes > 1:
            from kwok_tpu_torch.engine.lanes import LaneSet

            self._lanes = LaneSet(self, self._n_lanes)

    # ---------------------------------------------------------------- metrics

    @property
    def metrics(self) -> dict:
        """The flat view of the registry (``EngineTelemetry.legacy_dict``);
        under process lanes with every lane process's counters added in."""
        own = self.telemetry.legacy_dict()
        if self._proc is not None:
            return self._proc.merged_flat(own)
        return own

    def metrics_text(self) -> str:
        """The labeled families of ``registry`` as exposition text; under
        process lanes merged with every lane process's snapshot."""
        if self._proc is not None:
            return self._proc.merged_metrics_text()
        return self.registry.render()

    def process_metrics_text(self) -> str:
        """The process-wide error counters (``telemetry/errors.py``);
        under process lanes the lane processes' shares are added in.
        Empty until one of them has moved."""
        if self._proc is not None:
            return self._proc.merged_process_text()
        from kwok_tpu_torch.telemetry.errors import render_nonempty

        return render_nonempty()

    def trace_chrome(self) -> dict:
        """The span ring as a Chrome trace-event document."""
        return self.tracer.chrome_trace()

    def _inc(self, name: str, v=1) -> None:
        self.telemetry.inc(name, v)

    def _flight_dump_on_degrade(self, reason: str) -> None:
        """Degradation edge hook (``Degradation.on_set``): save the
        apiserver's flight recorder before its bounded ring overwrites
        the requests that led into the degradation. Best effort, on a
        daemon thread of its own; armed only with a dump directory and
        an HTTP master."""
        dir_ = (
            self.config.flight_dir
            or os.environ.get("KWOK_TPU_FLIGHT_DIR", "")
        ).strip()
        server = getattr(self.client, "server", "")
        if not dir_ or not str(server).startswith("http"):
            return

        def _grab():
            import urllib.request

            try:
                with urllib.request.urlopen(
                    str(server) + "/debug/flight", timeout=3
                ) as r:
                    data = r.read()
                os.makedirs(dir_, exist_ok=True)
                path = os.path.join(
                    dir_, f"flight-{reason}-{int(time.time() * 1000)}.json"
                )
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
                logger.warning(
                    "degraded (%s): apiserver flight dump saved to %s",
                    reason, path,
                )
            except Exception:
                # the apiserver may BE the reason for the degradation: a
                # failed grab is expected there, never an error
                swallowed("engine.flight_dump")

        threading.Thread(
            target=_grab, name="kwok-flight-dump", daemon=True
        ).start()

    # ------------------------------------------------------------------ time

    def _now(self) -> float:
        return time.time() - self._epoch

    def _skewed_now(self) -> float:
        """The clock.jump arm of ``_now`` (installed only when the fault
        spec configures clock.jump): engine time plus the plane's bounded,
        seeded skew. Timers, heartbeats and checkpoint residues all see
        the hostile clock."""
        return time.time() - self._epoch + self._faults.clock_skew()

    def _device_ctx(self):
        """Run device work on the engine's stream (no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # ------------------------------------------------------- selector checks

    def _node_need_heartbeat(self, node: dict) -> bool:
        """needHeartbeat = nodeSelectorFunc (controller.go:81-101). Label
        selector is pushed down into the watch, so anything we receive in
        that mode already matches."""
        if self.config.manage_all_nodes:
            return True
        if self._manage_annotation is not None:
            annotations = (node.get("metadata") or {}).get("annotations") or {}
            return self._manage_annotation.matches(annotations)
        if self.config.manage_nodes_with_label_selector:
            return True
        return False

    def _disregard(self, obj: dict) -> bool:
        meta = obj.get("metadata") or {}
        if self._disregard_annotation is not None and (meta.get("annotations") or {}):
            if self._disregard_annotation.matches(meta["annotations"]):
                return True
        if self._disregard_label is not None and (meta.get("labels") or {}):
            if self._disregard_label.matches(meta["labels"]):
                return True
        return False

    # ------------------------------------------------------------- lifecycle

    @property
    def startup_resync_pending(self) -> bool:
        """True while the startup gate is open: the first full re-list of
        both kinds (and the checkpoint reconcile, when one is armed) has
        not completed, so /readyz answers 503."""
        return self._running and self._startup_pending is not None

    @property
    def degraded(self) -> bool:
        """Degraded mode (a lane shedding load, a checkpoint writer that
        cannot reach its disk): /readyz answers 503 while it is True."""
        return self._degradation.active

    def start(self, spawn_watches: bool = True, run_tick_loop: bool = True) -> None:
        """Arm the startup gate (and the checkpoint service), warm the
        device path, then start watch ingest, the patch executor and the
        tick thread (the lane coordinator under lanes, with the router
        and the lane workers). ``ready`` stays False until the device
        thread has ingested the first full re-list of both kinds.

        Under process lanes this engine warms nothing and checkpoints
        nothing (the lane processes do both); it spawns the lane
        processes, and its tick thread is the status coordinator. A lane
        process passes ``spawn_watches=False``: its events arrive routed
        from the parent, never from watch streams of its own. A
        federation member (``engine/federation.py``) passes
        ``run_tick_loop=False``: it warms nothing and starts no tick
        thread; the federation's loop drains its queue, ticks its rows in
        the group's stacked state, emits through its executor and closes
        its startup gate."""
        self._running = True
        self._stop_evt.clear()
        self._owns_tick = run_tick_loop and self._owns_device
        # the sampling profiler from the CALLER's thread (usually main):
        # its SIGTERM dump hook can only install there
        profiling.maybe_start()
        if (self.config.profile_dir and self._owns_tick
                and self._proc is None):
            self._profiler = profiling.TickProfiler(
                self.config.profile_dir, self.device
            )
        # supervision before any worker exists (a federation installs ONE
        # shared watchdog across its members before starting them)
        if self._watchdog is None or self._watchdog.closed:
            self._watchdog = Watchdog(
                budget=self.config.worker_restart_budget,
                window=self.config.worker_restart_window,
                on_exhausted=self._worker_budget_exhausted,
                on_restart=self._worker_restarted_resync,
            )
        self._executor = ThreadPoolExecutor(
            max_workers=self.config.parallelism, thread_name_prefix="kwok-patch"
        )
        # armed before any worker exists; afterwards only the device
        # thread finishes it (_mark_resync takes _ckpt_lock)
        self._startup_pending = {"nodes", "pods"}
        self._startup_lanes = {}
        self._startup_flush_wait = False
        self._startup_t0 = time.monotonic()
        if self._ckpt_dir and self._proc is None:
            self._ckpt = ckpt_mod.Checkpointer(
                self._ckpt_dir, self._ckpt_name,
                self.config.checkpoint_interval, on_write=self._ckpt_written,
                degradation=self._degradation,
            )
            data = ckpt_mod.load(self._ckpt_dir, self._ckpt_name)
            if data is not None:
                self._restore = ckpt_mod.RestoreSession(
                    data["kinds"], gate_ready=True
                )
                logger.info(
                    "checkpoint %s: %d rows to reconcile after re-list",
                    self._ckpt.path, self._restore.remaining,
                )
            self._ckpt.start()
        if self._faults is not None:
            # the worker killer (when the spec asks for one); refcounted,
            # so engines sharing the plane start and stop it together
            self._faults.start()
        # (a federation member warms nothing: the federation warms its
        # group's stacked state)
        if run_tick_loop and self._proc is not None:
            self._proc.prepare()
        elif run_tick_loop:
            with self._device_ctx():
                if self._lanes is not None:
                    self._lanes.prepare(self._executor)
                else:
                    self._warm_scatters()
                    self._warm_tick()
        if spawn_watches:
            node_label_sel = self.config.manage_nodes_with_label_selector or None
            self._spawn_watch("nodes", label_selector=node_label_sel)
            self._spawn_watch("pods", field_selector="spec.nodeName!=")
        if not run_tick_loop:
            return
        if self._proc is not None:
            self._proc.start_workers(self._threads)
            loop = self._proc.coordinator_loop
        elif self._lanes is not None:
            self._lanes.start_workers(self._threads)
            loop = self._lanes.tick_loop
        else:
            loop = self._tick_loop
        t = threading.Thread(target=loop, name="kwok-tick", daemon=True)
        t.start()
        self._threads.append(t)
        if self._audit_interval > 0 and self._proc is not None:
            # the parent holds no rows to diff: each lane process audits
            # its own hash shard (the interval rides the lane spec) and
            # mirrors its drift flag back through BANK_DRIFT
            logger.info(
                "anti-entropy audit runs shard-scoped in the %d lane "
                "processes (interval %.3fs); the parent spawns no auditor",
                self._proc.n, self._audit_interval,
            )
        elif self._audit_interval > 0:
            # supervised, so a crashed pass restarts in place (with no
            # stream resync: _worker_restarted_resync)
            from kwok_tpu_torch.resilience.antientropy import AntiEntropyAuditor

            self._auditor = AntiEntropyAuditor(self, self._audit_interval)
            self._threads.append(
                self._watchdog.spawn(self._auditor.run, name="kwok-audit"))

    def _warm_scatters(self) -> None:
        """Run both ingest scatters once on a row that is still in its
        initial state, writing that same state back, so the first real
        ingest wave does not pay for loading their device code."""
        for k in (self.nodes, self.pods):
            if len(k.pool):
                continue  # rows already live: nothing safe to rewrite
            k.state = _warm_scatter(k.state)

    def _warm_tick(self) -> None:
        """One all-inactive fused dispatch at startup: on a CUDA device it
        builds and loads the tick kernel's library (an nvcc build on a
        cold cache), and it warms the pinned wire's D2H path, so neither
        lands in the serving path."""
        _outs, wire = self._get_fused()((self.nodes.state, self.pods.state), 0.0)
        np.asarray(wire)

    def _mark_resync(self, kind: str, lane: int = 0) -> None:
        """One full re-list snapshot for ``kind`` has been ingested (its
        RESYNC marker applied). Under lanes the marker broadcasts to every
        lane, so the kind only counts once all lanes applied theirs; drain
        workers call this concurrently, hence the lock."""
        if self._startup_pending is None:
            return
        with self._ckpt_lock:
            sp = self._startup_pending
            if sp is None or kind not in sp:
                return
            done = self._startup_lanes.setdefault(kind, set())
            done.add(lane)
            lanes = self._lanes is not None or self._proc is not None
            if len(done) >= (self._n_lanes if lanes else 1):
                sp.discard(kind)

    def _ckpt_gate(self, dispatched: bool, staged: bool) -> None:
        """Finish the startup gate once every kind's first re-list has
        been ingested AND its staged rows have reached the device through
        one arming dispatch (refine runs after that dispatch, so matched
        rows' timers are already restored when ready flips). Device
        thread."""
        sp = self._startup_pending
        if sp is None:
            return
        with self._ckpt_lock:
            empty = not sp
        if not empty:
            return
        if not self._startup_flush_wait:
            self._startup_flush_wait = True
            if staged:
                return  # listed rows not flushed yet: one more dispatch
        elif not (dispatched or not staged):
            return
        self._finish_startup()

    def _finish_startup(self) -> None:
        self._startup_pending = None
        self._startup_lanes = {}
        dt = time.monotonic() - self._startup_t0
        self.telemetry.set_gauge("restart_recovery_seconds", dt)
        r = self._restore
        if r is not None and r.gate_ready:
            if r.remaining:
                # rows re-listed but not ARMED yet (a pod's managed bit can
                # arrive through a later cross-lane fan-out): readiness
                # flips now, the session keeps refining for a bounded tail
                r.gate_ready = False
                r.deadline = time.monotonic() + 10.0
                logger.info(
                    "checkpoint reconcile: %d rows refined, %d stale, "
                    "%d awaiting arming (tail refine continues)",
                    r.matched, r.stale, r.remaining,
                )
            else:
                self._end_restore(r)
        else:
            logger.info("startup re-list ingested in %.3fs; engine ready", dt)
        self.ready = True

    def _rearm_restore(self) -> None:
        """Reload the on-disk checkpoint and arm a refill RestoreSession (no
        readiness gate, 30 s to live): rows that a re-list after a worker
        or member restart re-initializes resume their checkpointed timers.
        Safe from any thread: the session swap is atomic, and only the
        device-owning loop consumes a session."""
        if self._ckpt is None:
            return
        data = ckpt_mod.load(self._ckpt_dir, self._ckpt_name)
        if data is None:
            return
        session = ckpt_mod.RestoreSession(data["kinds"], gate_ready=False, ttl=30.0)
        with self._ckpt_lock:
            # pairs with _close_restore's identity check: the device loop
            # closing an OLD session never clobbers a refill armed from a
            # restarted worker's thread
            self._restore = session
        logger.info(
            "checkpoint refill armed (%s): %d candidate rows",
            self._ckpt_name, session.remaining,
        )

    def _close_restore(self, r) -> None:
        """Drop a finished or expired restore session, but only if it is
        still THE session: _rearm_restore may have swapped a fresh one in
        from another thread since the caller read it."""
        with self._ckpt_lock:
            if self._restore is r:
                self._restore = None

    def _end_restore(self, r) -> None:
        """Close a finished or expired restore session (its leftovers are
        stale) and publish its summary: ``restore_refined_rows``,
        ``restore_stale_rows``."""
        s = r.finish()
        self._close_restore(r)
        self.telemetry.note("restore_refined_rows", s["refined"])
        self.telemetry.note("restore_stale_rows", s["stale"])
        logger.info(
            "checkpoint restore closed: %d rows refined, %d stale dropped",
            s["refined"], s["stale"],
        )

    def _get_fused(self) -> MultiTickKernel:
        if self._fused is None:
            steps = max(1, int(self.config.tick_substeps))
            self._fused = MultiTickKernel(
                self._fused_specs, steps=steps,
                dt=self.config.tick_interval / steps, device=self.device,
            )
        return self._fused

    # minimum seconds between two integrity-doubt re-lists
    _WIRE_RESYNC_MIN_S = 5.0

    def _integrity_resync(self, kind: str) -> None:
        """Corrupt or lost input for ``kind`` (an unparseable routed line,
        events a lane process could not take): the kind's next reconnect
        re-lists from now on, and its stream is cut so that happens now,
        at most once per ``_WIRE_RESYNC_MIN_S``; a doubt inside the window
        is deferred to one timer, never dropped. The cut runs off the
        caller's thread."""
        self._request_relist(kind)
        now = time.monotonic()
        with self._ckpt_lock:
            self._wire_doubt.add(kind)
            if self._wire_timer is not None:
                return  # a deferred re-list is already scheduled
            wait = self._WIRE_RESYNC_MIN_S - (now - self._wire_resync_at)
            t = threading.Timer(max(0.0, wait), self._integrity_fire)
            t.daemon = True
            self._wire_timer = t
        logger.warning("integrity doubt on %s: scheduling a full re-list", kind)
        t.start()

    def _integrity_fire(self) -> None:
        with self._ckpt_lock:
            self._wire_timer = None
            self._wire_resync_at = time.monotonic()
            kinds, self._wire_doubt = self._wire_doubt, set()
        if not self._running:
            return
        self._inc("watch_integrity_resyncs_total")
        for kind in kinds:
            self._resync_stream(kind)

    def _worker_budget_exhausted(self, name: str) -> None:
        """Watchdog callback: a supervised worker (or a lane process)
        failed past its restart budget; the lane topology is partial."""
        if self._degradation.set("worker_restart_budget"):
            logger.error("engine degraded: worker %s out of restart budget", name)

    def _worker_restarted_resync(self, name: str) -> None:
        """Watchdog callback, on the restarted worker's own thread: a
        crashed lane drain worker or router may have eaten an in-flight
        item (the crash can land mid-get or mid-apply), and the watch
        cache will not replay it, so the restart completes with a full
        list+RESYNC of every stream, and every managed node's pods are
        re-fanned to their lanes (a cross-lane managed-ness update the
        dead worker ate is the one loss a re-list does not reproduce: the
        pods' re-delivery drops as echoes)."""
        if not self._running:
            return
        if name.startswith("kwok-emit"):
            # lossless by construction: the in-flight wire slice survives
            # in the lane's replay slot (ShardLane.emit_loop) and is
            # replayed by the restarted loop
            return
        if name.startswith("kwok-watch"):
            # a restarted watch loop re-lists its own kind by construction
            # (it starts with no resume revision), which re-delivers
            # whatever the pill ate; cutting the other kind's healthy
            # stream would be pure cost. Re-arm the checkpoint refine, so
            # rows the re-list re-initializes resume their timers
            self._rearm_restore()
            return
        if name.startswith("kwok-audit"):
            # the auditor holds no engine data a crash could eat: its
            # next pass re-lists its window anyway, and a full stream
            # resync per audit crash would be pure cost
            return
        self.resync_streams()
        if self._lanes is not None:
            while True:
                try:
                    nodes = list(self.node_has)
                    break
                except RuntimeError:  # the shared set resized mid-copy
                    time.sleep(0)
            for node in nodes:
                self._lanes.route_pod_updates(node)

    def resync_streams(self) -> None:
        """Force every watch stream through a full list+RESYNC (a cut
        stream alone would resume): see ``_resync_stream``. Safe from any
        thread; the watch threads do the re-listing."""
        for kind in list(self._watches):
            self._resync_stream(kind)

    def _resync_stream(self, kind: str) -> None:
        """One kind's share of resync_streams: expire its resume revision,
        request the re-list, cut the live stream. The watch loop reads the
        request at the top of each reconnect AND right after installing a
        new handle, so a handshake racing this call either has its handle
        cut here or sees the request after installing it."""
        self._request_relist(kind)
        w = self._watches.get(kind)
        if w is None:
            return
        try:
            w.stop()
        except Exception:
            # a dying or already replaced handle: the watch loop's
            # reconnect owns recovery either way
            logger.debug("watch stop during resync failed", exc_info=True)

    def _request_relist(self, kind: str) -> None:
        """The kind's next reconnect re-lists, whatever revision its loop
        holds."""
        self._expire_stream(kind)
        with self._gen_lock:
            self._resync_req.add(kind)

    def _expire_stream(self, kind: str) -> None:
        """The kind's resume revision is dead (a 410, or a forced
        re-list): drop the RAW paths' revision and bump the stream
        generation in one step, so a flush committing its batch revision
        concurrently either lands first (and is dropped here) or sees the
        new generation (and does not commit)."""
        with self._gen_lock:
            self._watch_rv.pop(kind, None)
            self._stream_gen[kind] = self._stream_gen.get(kind, 0) + 1

    def _tracked_rv(self, kind: str, obj: dict) -> int:
        """The revision this engine last ingested for ``obj``'s key (the
        owning lane's engine under threaded lanes), or 0 when the row is
        unknown. Read without a lock: a row's rv only moves forward, so a
        stale read only makes the rewind check more conservative."""
        meta = obj.get("metadata") or {}
        name = meta.get("name")
        if not name:
            return 0
        key = (meta.get("namespace") or "default", name) if kind == "pods" else name
        lanes = self._lanes
        e = lanes.lanes[shard_of(key, lanes.n)].engine if lanes is not None else self
        k = e.pods if kind == "pods" else e.nodes
        idx = k.pool.lookup(key)
        if idx is None:
            return 0
        # meta rv is an int, set from _rv_of at ingest
        return (k.pool.meta[idx] or {}).get("rv") or 0

    def _note_rv_rewind(self, kind: str, name, listed: int, tracked: int) -> None:
        """A re-listed object carries a revision below the one this engine
        already ingested for it: an object's own revision never goes back,
        so the store was restored from a snapshot. Every stream re-lists
        (at most once per 5 s), so none keeps resuming against revisions
        of the old world."""
        now = time.monotonic()
        if now - self._rv_rewind_at < 5.0:
            return
        self._rv_rewind_at = now
        self._inc("rv_rewinds_total")
        logger.warning(
            "rv rewind on the %s re-list (%s listed at rv %d < ingested rv "
            "%d): the store was restored; re-listing every stream",
            kind, name, listed, tracked,
        )
        self.resync_streams()

    def stop(self) -> None:
        self._running = False
        self.ready = False
        self._startup_pending = None
        self._stop_evt.set()
        if self._watchdog is not None:
            self._watchdog.close()  # shutdown crashes must not restart
        if self._faults is not None:
            self._faults.stop()  # the worker killer down first
        with self._ckpt_lock:
            timer, self._wire_timer = self._wire_timer, None
        if timer is not None:
            timer.cancel()
        for w in list(self._watches.values()):
            w.stop()
        self._q.put(None)

        # the tick thread first: its shutdown path consumes the in-flight
        # ticks (handing their final items to the lane emit queues) and
        # queues the final checkpoint; then the emit workers get time to
        # drain those items before the executor shuts down under them
        def join_rank(t):
            if t.name == "kwok-tick":
                return 0
            return 1 if t.name.startswith("kwok-emit") else 2

        for t in sorted(self._threads, key=join_rank):
            t.join(timeout=(
                60 if t.name == "kwok-tick"
                else 30 if t.name.startswith("kwok-emit") else 5
            ))
        if self._executor is not None:
            self._executor.shutdown(wait=True)
        if self._pump is not None:
            self._pump.close()
            self._pump = None
        if self._lanes is not None:
            self._lanes.close()  # the lanes' pump groups
        if self._proc is not None:
            # STOP every lane process: each drains its patches and writes
            # its final checkpoint before it exits
            self._proc.close()
        if self._ckpt is not None:
            # the tick thread queued the final snapshot in its finally;
            # this drains the writer and joins it
            self._ckpt.stop()
        self._threads = []
        # nothing still queued is ever ingested (watch events that raced
        # the stop, the sentinel): drop it, so a later start() begins
        # from an empty queue and the depth gauge reads 0
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self.telemetry.set_gauge("ingest_queue_depth", 0)
        dropped = self.metrics["dropped_jobs_total"]
        if dropped:
            logger.warning("%d patch jobs dropped during shutdown", dropped)
        profiling.maybe_dump()
        trace_path = self.config.trace_dump or os.environ.get(
            "KWOK_TPU_TRACE", ""
        )
        if trace_path and self._owns_tick:
            # at-stop dump (the live view is /debug/trace); a federation
            # member's spans go into the federation's merged dump
            try:
                self.tracer.dump(trace_path)
                logger.info("span trace written to %s", trace_path)
            except Exception:
                logger.exception("span trace dump failed")

    # a stream that lived this long before its 410 ends an expiry storm:
    # the next 410 re-lists at once again
    _STORM_STREAM_S = 5.0
    # TooLargeResourceVersion answers to one resume before a re-list
    _TOO_LARGE_TRIES = 3

    def _spawn_watch(self, kind: str, **sel) -> None:
        """client-go's reflector for one kind, forever. Register the watch
        first; when there is no revision to resume from, list and queue
        the snapshot plus a RESYNC marker (events in the register/list gap
        are covered); then stream. Every event's revision, bookmarks
        included, becomes the resume revision, so a broken stream resumes
        and the server replays the gap: no re-list. After a 410 the loop
        re-lists: at once for a lone one, paced by its own backoff when
        short-lived streams keep expiring. A resume ahead of the server
        retries after its hint, ``_TOO_LARGE_TRIES`` times, then re-lists.
        A 429 waits at least its Retry-After (``client_throttle_seconds``);
        other failures back off under WATCH_RECONNECT, reset by a healthy
        handshake. ``resync_streams`` forces the re-list.

        With the native parser, a stream that offers it is handed to the
        native socket reader (``RAWB`` batches) or read as raw lines
        (``RAW``), after one ``GEN`` marker; the draining thread parses
        them and keeps ``_watch_rv``; a broken stream resumes from the last
        revision it received, or ``_watch_rv`` where that is later
        (``_resume_rv``).
        A client without raw lines (the in-process FakeKube) keeps the
        decoded-event loop."""
        opts = {k: v for k, v in sel.items() if v}
        self._watch_opts[kind] = dict(opts)
        # process lanes: a re-list travels as the RESYNC snapshot alone
        # (the lane process applies its objects before the prune); the
        # router parses the raw lines and ships each lane its own
        proc = self._proc is not None
        parser = self._batch_parser
        # this thread's own single-line parser: the resume revision is
        # read off the stream's last line (_resume_rv)
        tail_parser = native.EventParser() if parser is not None else None

        def stopping() -> bool:
            return not self._running

        def loop():
            resume_rv = 0
            too_large = 0
            backoff = WATCH_RECONNECT.session()
            # the storm pacer has its own session: every 410 is followed
            # by a healthy re-list handshake, which resets `backoff`, so
            # a storm is judged by how long each stream lived instead
            storm = WATCH_RECONNECT.session()
            expiries = 0
            stream_t0 = 0.0

            def expired():
                """Forget the compacted revision; re-list, paced when
                short-lived streams keep expiring."""
                nonlocal resume_rv, expiries
                resume_rv = 0
                self._expire_stream(kind)
                if stream_t0 and time.monotonic() - stream_t0 >= self._STORM_STREAM_S:
                    expiries = 0
                    storm.reset()
                expiries += 1
                if expiries > 1:
                    storm.sleep(storm.next_delay() or 0.0, stopping)

            while self._running:
                try:
                    with self._gen_lock:
                        if kind in self._resync_req:
                            self._resync_req.discard(kind)
                            resume_rv = 0
                    old = self._watches.get(kind)
                    if old is not None:
                        # a handle left open by a failure after its
                        # handshake (a failed LIST) must not keep
                        # collecting events server-side
                        try:
                            old.stop()
                        except Exception:
                            logger.debug("stale watch stop failed", exc_info=True)
                    try:
                        w = self.client.watch(
                            kind, **opts, allow_bookmarks=True,
                            **({"resource_version": resume_rv} if resume_rv else {}),
                        )
                    except WatchExpired:
                        logger.warning("watch %s resume rv=%d expired; re-listing",
                                       kind, resume_rv)
                        expired()
                        continue
                    except TooLargeResourceVersion as e:
                        # the server's revision is behind ours (it restarted):
                        # retry the same revision after its hint, bounded
                        too_large += 1
                        if too_large >= self._TOO_LARGE_TRIES:
                            logger.warning(
                                "watch %s resume rv=%d still ahead of the server "
                                "(current %d) after %d tries; re-listing",
                                kind, resume_rv, e.current, too_large)
                            resume_rv = 0
                            too_large = 0
                            continue
                        wait = min(e.retry_after, 5.0)
                        logger.warning(
                            "watch %s resume rv=%d ahead of the server (current "
                            "%d); retrying in %.1fs", kind, resume_rv, e.current, wait)
                        backoff.sleep(wait, stopping)
                        continue
                    too_large = 0
                    self._watches[kind] = w
                    if resume_rv:
                        # a resync_streams that raced this handshake (its
                        # request landed after the check above, its cut
                        # before this install) must still re-list
                        with self._gen_lock:
                            forced = kind in self._resync_req
                            self._resync_req.discard(kind)
                        if forced:
                            w.stop()
                            resume_rv = 0
                            continue
                    backoff.reset()
                    stream_t0 = time.monotonic()
                    # the native reader takes the socket over before the
                    # LIST: the events of the list gap wait in the socket
                    reader = None
                    if parser is not None:
                        make_reader = getattr(w, "native_reader", None)
                        if callable(make_reader):
                            reader = make_reader()
                    if not resume_rv:
                        self._relist(kind, opts, proc)
                    raw_iter = getattr(w, "raw_lines", None)
                    if reader is not None:
                        # the native reader de-chunks the socket and hands
                        # back packed line batches: one queue item per
                        # batch, no per-line Python object. The draining
                        # thread parses them and keeps _watch_rv
                        gone, last = self._stream_raw(
                            kind, reader, getattr(w, "_stopped", None))
                        resume_rv = self._resume_rv(kind, last, tail_parser)
                    elif parser is not None and callable(raw_iter):
                        # undecoded lines, parsed in batches by the
                        # draining thread; an ERROR line is told by its
                        # prefix (the servers serialize "type" first)
                        self._q.put((kind, "GEN", self._stream_gen.get(kind, 0),
                                     time.monotonic()))
                        gone, last = False, b""
                        for line in raw_iter():
                            if line.startswith(b'{"type":"ERROR"'):
                                gone = b'"code":410' in line
                                logger.warning("watch error event: %.200r", line)
                                break
                            self._q.put((kind, "RAW", line, time.monotonic()))
                            last = line
                        resume_rv = self._resume_rv(kind, last, tail_parser)
                    else:
                        # a client without raw lines (the in-process
                        # FakeKube), or the native library off
                        for ev in w:
                            rv = _rv_of(ev.object.get("metadata") or {})
                            if rv:
                                resume_rv = rv
                            if ev.type == BOOKMARK:
                                self._inc("watch_bookmarks_total")
                                continue
                            self._q.put((kind, ev.type, ev.object, time.monotonic()))
                        gone = getattr(w, "expired", False)
                    if gone:
                        logger.warning("watch %s stream expired (410); re-listing", kind)
                        expired()
                        continue
                    if not self._running:
                        return
                except WatchExpired:
                    expired()
                except TooManyRequests as e:
                    # a saturated apiserver: wait at least its hint, riding
                    # the backoff so a persistent 429 reaches the ceiling
                    if not self._running:
                        return
                    delay = max(backoff.next_delay() or 0.0, e.retry_after)
                    self.telemetry.add_throttle(delay)
                    logger.warning("watch %s throttled (429); retrying in %.2fs",
                                   kind, delay)
                    backoff.sleep(delay, stopping)
                except Exception as e:  # re-watch with backoff
                    if not self._running:
                        return
                    delay = backoff.next_delay() or 0.0
                    logger.warning(
                        "watch %s failed: %s; retrying in %.2fs", kind, e, delay
                    )
                    backoff.sleep(delay, stopping)

        # supervised: a crash (or a fault plane's pill) restarts the loop
        # in place, and the fresh loop re-lists, so the restart IS the
        # recovery. The suffix names a federation member's threads
        # (kwok-watch-pods-m1) for the budget and the member counter
        self._threads.append(self._watchdog.spawn(
            loop, name=f"kwok-watch-{kind}{self._worker_suffix}"))

    def _stream_raw(self, kind: str, reader, stopped=None) -> tuple:
        """Queue one stream's packed line batches from the native reader
        (after its GEN marker) until the stream ends or its handle is
        stopped (``stopped``, the handle's event: a stop ends the read
        within one poll even if no end of stream reaches the reader).
        Returns (gone, last): gone is True when it ended with a 410 ERROR
        event; last is its last event line (b"" when none came)."""
        self._q.put((kind, "GEN", self._stream_gen.get(kind, 0), time.monotonic()))
        tail = None  # the last batch with lines
        gone = False
        try:
            while self._running and not (stopped is not None and stopped.is_set()):
                out = reader.read_batch(timeout_s=1.0)
                if out is None:
                    break
                buf, off = out
                if len(off) > 1:
                    self._q.put((kind, "RAWB", (buf, off), time.monotonic()))
                    tail = out
                if reader.error is not None:
                    logger.warning("watch error event: %.200r", reader.error)
                    gone = b'"code":410' in reader.error
                    break
        finally:
            reader.close()
        last = tail[0][tail[1][-2]:tail[1][-1]] if tail is not None else b""
        return gone, last

    def _resume_rv(self, kind: str, last: bytes, parser) -> int:
        """The revision a RAW or RAWB stream resumes from: the last one it
        received (its last line's, a bookmark's included), as client-go's
        reflector resumes, or the drained one (_watch_rv) where that is
        later. Lines still queued drain before the next stream's, so none
        is lost; resuming from the drained revision alone lags the store
        by the drain's backlog, which under a flood can outrun the
        server's watch window (a 410 and a needless re-list). 0 (re-list)
        when the drain dropped the kind's revision: a 410 it saw.

        Both watch threads call this while the drain parses, so the line
        goes through the batch parse, whose buffers are the call's own:
        the single-line ``parse`` reuses the parser's buffers, and two
        threads in it at once corrupt them."""
        drained = self._watch_rv.get(kind, 0)
        if not drained:
            return 0
        return max(drained, parser.parse_batch([bytes(last)])[0].rv if last else 0)

    def _relist(self, kind: str, opts: dict, proc: bool) -> None:
        """One full LIST of ``kind`` onto the ingest queue: its objects as
        ADDED events (under process lanes the RESYNC snapshot carries
        them), then the RESYNC marker that prunes rows the list no longer
        holds. An object listed below the revision already ingested for
        it is a store rewind (_note_rv_rewind)."""
        objs = self.client.list(kind, **opts)
        self._inc("watch_relists_total")
        rewind = None
        for obj in objs:
            if not proc:
                self._q.put((kind, ADDED, obj, time.monotonic()))
            if rewind is None:
                meta = obj.get("metadata") or {}
                rv = _rv_of(meta)
                tracked = self._tracked_rv(kind, obj) if rv else 0
                if tracked and rv < tracked:
                    rewind = (meta.get("name"), rv, tracked)
        self._q.put((kind, "RESYNC", objs, time.monotonic()))
        if rewind is not None:
            self._note_rv_rewind(kind, *rewind)

    # ----------------------------------------------------- raw-line drain

    # cap on buffered raw lines per kind before a mid-drain flush: bounds
    # the batch parse's latency and memory, keeps the amortization
    _RAW_FLUSH_AT = 8192

    def _drain_apply(
        self, item, raw_buf: dict, route=None, route_shards: int = 0
    ) -> None:
        """Apply one queue item on the draining thread. RAW lines and RAWB
        batches buffer per kind for ONE batched parse; any other item for
        a kind flushes that kind's buffer first, so per-kind event order
        holds (a RESYNC snapshot must not overtake lines queued before
        it). A GEN marker sets the generation of the lines after it.

        With ``route`` (a lane router), parsed events go to
        ``route(kind, type_, obj)`` instead of being ingested here; the
        revision bookkeeping stays on this engine either way.
        ``route_shards`` is the lane count when ``route`` is a lane set's
        router (it enables the pre-partitioned batch handoff), else 0."""
        kind, type_, obj = item[:3]
        if type_ == "RAW":
            buf = raw_buf.setdefault(kind, [])
            buf.append(obj)
            if len(buf) >= self._RAW_FLUSH_AT:
                self._drain_flush_kind(kind, raw_buf, route, route_shards)
            return
        if type_ == "RAWB":
            # one packed batch, many lines: the flush bound counts lines
            buf = raw_buf.setdefault(kind, [])
            buf.append(obj)
            if sum(len(o) - 1 for _, o in buf) >= self._RAW_FLUSH_AT:
                self._drain_flush_kind(kind, raw_buf, route, route_shards)
            return
        if kind in raw_buf:
            self._drain_flush_kind(kind, raw_buf, route, route_shards)
        if type_ == "GEN":
            self._drain_gen[kind] = obj
            return
        if route is not None:
            route(kind, type_, obj)
            return
        self._ingest_safe(kind, type_, obj)

    def _drain_flush(self, raw_buf: dict, route=None, route_shards: int = 0) -> None:
        for kind in list(raw_buf):
            self._drain_flush_kind(kind, raw_buf, route, route_shards)

    def _drain_error_line(self, kind: str, raw: bytes, gen: int) -> None:
        """An ERROR event that reached the drain (a re-serializing proxy
        can defeat the watch thread's prefix check) never becomes a
        record; a 410 from the CURRENT stream drops the kind's resume
        revision now. One from an older generation changes nothing."""
        logger.warning("watch error event in drain: %.200r", raw)
        if b'"code":410' in raw:
            with self._gen_lock:
                if gen == self._stream_gen.get(kind, 0):
                    self._watch_rv.pop(kind, None)
                    self._stream_gen[kind] = gen + 1

    def _commit_rv(self, kind: str, gen: int, rv: int) -> None:
        """Advance the kind's resume revision iff its stream is still the
        live one: one locked commit per flushed batch, atomic against a
        410 on the watch thread (_expire_stream)."""
        with self._gen_lock:
            if gen == self._stream_gen.get(kind, 0):
                self._watch_rv[kind] = rv

    def _wire_reject(self, kind: str, reason: str, n: int = 1) -> None:
        """Corrupt wire input: counted (kwok_wire_rejects_total{reason})
        and integrity doubt, so the bounded-rate re-list re-delivers what
        the corruption ate."""
        wire_reject(reason, n)
        self._integrity_resync(kind)

    def _drain_flush_kind(
        self, kind: str, raw_buf: dict, route=None, route_shards: int = 0
    ) -> None:
        entries = raw_buf.pop(kind, None)
        if not entries:
            return
        # one generation per buffer: a GEN marker flushes before it moves
        # _drain_gen, so every buffered line shares the marker-time value
        gen = self._drain_gen.get(kind, 0)
        # partitioned parse: the lane count when this flush hands batches
        # to a lane set, 1 when this engine ingests inline (the columnar
        # path), 0 for any other route callable (per-record walk)
        part_shards = 0
        lanes = self._lanes if self._lanes is not None else self._proc
        if self._native_route:
            if route is None:
                part_shards = 1
            elif route_shards > 1 and lanes is not None and route_shards == lanes.n:
                part_shards = route_shards
        parse = self._batch_parser
        t0 = time.perf_counter()
        batch = None
        if any(isinstance(x, tuple) for x in entries):
            # packed reader batches (stray single lines normalized in
            # place): one blob and one offset list, parsed straight
            parts: list[bytes] = []
            offs: list[int] = [0]
            base = 0
            for x in entries:
                if isinstance(x, tuple):
                    b, o = x
                    parts.append(b)
                    offs.extend(v + base for v in o[1:])
                    base += o[-1]
                else:
                    parts.append(x)
                    base += len(x)
                    offs.append(base)
            blob = b"".join(parts)
            lines = native._BlobLines(blob, offs)
            if parse is not None:
                try:
                    batch = parse.parse_blob(blob, offs, kind=kind, n_shards=part_shards)
                except Exception:
                    logger.exception("batch parse failed; parsing line by line")
        else:
            lines = entries
            if parse is not None:
                try:
                    batch = parse.parse_raw_batch(lines, kind=kind, n_shards=part_shards)
                except Exception:
                    logger.exception("batch parse failed; parsing line by line")
        if batch is None:
            self._drain_lines(kind, lines, gen, route)
            self.telemetry.observe_stage("parse", time.perf_counter() - t0)
            return
        self.telemetry.observe_stage("parse", time.perf_counter() - t0)
        if batch.partitioned:
            info = batch.route_info
            if info.first_error < 0 and not info.unrouteable:
                # the steady state: the revision and bookmark bookkeeping
                # are scalars of the C parse, and the routable records go
                # to the lanes as index runs (or columnar into this engine)
                if info.latest_rv:
                    self._commit_rv(kind, gen, info.latest_rv)
                if info.bookmarks:
                    self._inc("watch_bookmarks_total", info.bookmarks)
                if info.routable:
                    self.telemetry.inc_kind(
                        "watch_events_total", kind, info.routable
                    )
                    if part_shards > 1:
                        lanes.route_batch(kind, batch)
                    else:
                        self._ingest_record_batch(
                            kind, batch, batch.lane_idx, 0, info.routable
                        )
                return
            # an ERROR or a nameless record (rare): the per-record walk
            # keeps the exact order and fallback semantics
            batch.ensure_lists()
        latest_rv = 0
        rv_dead = False
        n_rec = 0
        bookmarks = 0
        rvs = batch.rvs
        type_bytes = batch.type_bytes
        record = batch.record
        if route is not None:
            def ingest_record(kind_, rec_):
                route(kind_, "REC", rec_)
        else:
            ingest_record = self._ingest_record
        for i in range(batch.n):
            tb = type_bytes(i)
            if tb == b"ERROR":
                self._drain_error_line(kind, record(i).raw, gen)
                latest_rv = 0
                rv_dead = True  # nothing after a stream error counts
                continue
            rv = rvs[i]
            if rv and not rv_dead:
                latest_rv = rv
            if tb == b"BOOKMARK":
                bookmarks += 1
                continue
            n_rec += 1
            try:
                ingest_record(kind, record(i))
            except Exception:
                logger.exception("ingest failed for %s REC", kind)
        if latest_rv:
            self._commit_rv(kind, gen, latest_rv)
        if n_rec:
            self.telemetry.inc_kind("watch_events_total", kind, n_rec)
        if bookmarks:
            self._inc("watch_bookmarks_total", bookmarks)

    def _drain_lines(self, kind: str, lines, gen: int, route) -> None:
        """The line-by-line fallback of a flush whose batch parse failed,
        or of an engine without the native library (a lane process whose
        build failed): each line on its own, skipping only those that
        cannot be parsed, quarantined as integrity doubt (their revision
        is unreadable, so nothing after them commits)."""
        parse = self._batch_parser
        latest_rv = 0
        rv_dead = False
        n_rec = 0
        for line in lines:
            line = bytes(line)
            try:
                if parse is not None:
                    rec = parse.parse(line)
                    type_, rv = rec.type, rec.rv
                else:
                    doc = json.loads(line)
                    type_ = doc.get("type")
                    rec = doc.get("object")
                    if not isinstance(rec, dict):
                        raise ValueError("event without an object")
                    rv = _rv_of(rec.get("metadata") or {})
            except (ValueError, AttributeError):
                logger.warning("unparseable watch line: %.120r", line)
                self._wire_reject(kind, "unparseable")
                latest_rv = 0
                rv_dead = True
                continue
            if type_ == "ERROR":
                self._drain_error_line(kind, line, gen)
                latest_rv = 0
                rv_dead = True
                continue
            if rv and not rv_dead:
                latest_rv = rv
            if type_ == BOOKMARK:
                self._inc("watch_bookmarks_total")
                continue
            if parse is not None:
                type_ = "REC"
            elif type_ not in (ADDED, MODIFIED, DELETED):
                continue
            n_rec += 1
            try:
                if route is not None:
                    route(kind, type_, rec)
                else:
                    self._apply(kind, type_, rec)
            except Exception:
                logger.exception("ingest failed for %s %s", kind, type_)
        if latest_rv:
            self._commit_rv(kind, gen, latest_rv)
        if n_rec:
            self.telemetry.inc_kind("watch_events_total", kind, n_rec)

    # ---------------------------------------------------------------- ingest

    def _ingest(self, kind: str, type_: str, obj) -> None:
        if type_ == "REC":
            # counted per batch by the flush
            self._ingest_record(kind, obj)
            return
        self.telemetry.inc_kind("watch_events_total", kind)
        self._apply(kind, type_, obj)

    def _apply(self, kind: str, type_: str, obj) -> None:
        """Apply one watch event (or RESYNC snapshot, or native record) to
        the rows. Every topology applies events here (lanes and
        federation members included), so the stale-revision guard sits
        here."""
        if type_ == "REC":
            self._ingest_record(kind, obj)
            return
        if type_ == "RESYNC":
            self._resync(kind, obj)
            return
        if type_ in (MODIFIED, DELETED) and self._stale_dict_event(kind, obj):
            return
        if kind == "nodes":
            if type_ == DELETED:
                self._node_deleted(obj)
            else:
                self._node_upsert(obj)
        else:
            if type_ == DELETED:
                self._pod_deleted(obj)
            else:
                self._pod_upsert(obj)

    def _stale_dict_event(self, kind: str, obj: dict) -> bool:
        """True when this MODIFIED or DELETED event's revision is below
        the row's last ingested one: a replay (a resumed stream, or an
        event that raced the re-list snapshot), dropped and counted as
        ``kwok_wire_rejects_total{reason="stale_rv"}``, with no resync.
        A replayed DELETED would release a live row of an object deleted
        and re-created since. ADDED is never guarded: the re-list after a
        store restore delivers legitimately lower revisions."""
        rv = _rv_of(obj.get("metadata") or {})
        seen = self._tracked_rv(kind, obj) if rv else 0
        if seen and rv < seen:
            wire_reject("stale_rv")
            return True
        return False

    def _ingest_safe(self, kind, type_, obj) -> None:
        """One malformed event must not kill the tick thread."""
        try:
            self._ingest(kind, type_, obj)
        except Exception:
            logger.exception("ingest failed for %s %s", kind, type_)

    # ---------------------------------------------------------- record path

    def _ingest_record(self, kind: str, rec) -> None:
        """The native record path: drop events whose fingerprints prove
        the render, merge and compare would be a no-op; parse the rest.

        - The stale-rv tier: a MODIFIED whose revision is below the row's
          last ingested one is a replay, dropped (and counted) before the
          echo tiers, so old content never overwrites newer meta. ADDED
          is exempt: a re-list after a store restore delivers lower
          revisions that must apply.
        - Pods: a MODIFIED with unchanged meta and spec fingerprints whose
          status fingerprint equals the last fully processed state (tier
          1), or the expectation recorded when this engine emitted its own
          patch (tier 2, ``fp_expect``: the echo of our write).
        - Nodes: a MODIFIED with an unchanged meta fingerprint and an
          unchanged status-minus-conditions fingerprint (heartbeat echoes:
          the conditions are pinned before any compare), or the echo of
          our own full status patch.
        - New or Pending pods that need no repair render take
          ``_pod_upsert_record`` (no json.loads); everything else is
          parsed once and runs the dict path, with fingerprints seeded."""
        type_ = rec.type
        if rec.ok and type_ == MODIFIED:
            if kind == "pods":
                key = (rec.namespace or "default", rec.name)
                k = self.pods
                idx = k.pool.lookup(key)
                if idx is not None:
                    m = k.pool.meta[idx]
                    if rec.rv and rec.rv < int(m.get("rv") or 0):
                        wire_reject("stale_rv")
                        return
                    if (
                        not (rec.flags & native.REC_DELETION)
                        and m.get("fp_meta_sel") == rec.fp_meta_sel
                        and m.get("fp_spec") == rec.fp_spec
                    ):
                        if rec.fp_status == m.get("fp_status_done"):
                            return  # identical to what was processed
                        if rec.fp_status == m.get("fp_expect") and rec.phase == m.get(
                            "expect_phase"
                        ):
                            # our own patch landed as rendered: keep the
                            # fresh raw line for any later render
                            m["fp_status_done"] = rec.fp_status
                            m["phase_str"] = rec.phase
                            m["host_ip"] = rec.host_ip
                            scalar = bool(rec.flags & native.REC_STATUS_SCALAR_ONLY)
                            m["status_scalar"] = scalar
                            if self._emit_cols:
                                # the emit columns track the same server
                                # facts as the meta mirror
                                pool = k.pool
                                pool.srv_phase[idx] = self._pod_phase_ids.get(rec.phase, -1)
                                pool.host_b[idx] = (
                                    _wire(rec.host_ip) if rec.host_ip else None
                                )
                                if scalar:
                                    pool.eflags[idx] |= EF_SCALAR
                                else:
                                    pool.eflags[idx] &= ~EF_SCALAR
                            m["raw"] = rec.raw
                            if rec.rv:
                                # the checkpoint identity tracks our echo
                                m["rv"] = rec.rv
                            m.pop("obj", None)
                            return
            else:
                k = self.nodes
                idx = k.pool.lookup(rec.name)
                if idx is not None:
                    m = k.pool.meta[idx]
                    if rec.rv and rec.rv < int(m.get("rv") or 0):
                        wire_reject("stale_rv")
                        return
                    if m.get("fp_meta_sel") == rec.fp_meta_sel:
                        if rec.fp_status_nc == m.get("fp_nsc_done"):
                            return  # heartbeat echo: no observable drift
                        if rec.fp_status == m.get("fp_expect"):
                            m["fp_nsc_done"] = rec.fp_status_nc
                            m["raw"] = rec.raw
                            if rec.rv:
                                m["rv"] = rec.rv
                            m.pop("obj", None)
                            return
        if (
            rec.ok
            and kind == "pods"
            and type_ in (ADDED, MODIFIED)
            and self._pod_upsert_record(rec)
        ):
            return
        # the full path: parse the raw line once, run the dict ingest
        try:
            doc = json.loads(rec.raw)
        except ValueError:  # bad JSON or bad UTF-8 past the C scanner
            logger.warning("bad watch line: %.120r", rec.raw)
            self._wire_reject(kind, "unparseable")
            return
        obj = doc.get("object") or {}
        ev_type = doc.get("type") or type_
        if ev_type == "ERROR":
            logger.warning("watch error event: %s", obj)
            return
        if ev_type not in (ADDED, MODIFIED, DELETED):
            return
        if ev_type in (MODIFIED, DELETED) and self._stale_dict_event(kind, obj):
            return
        if kind == "pods":
            if ev_type == DELETED:
                self._pod_deleted(obj)
                return
            self._pod_upsert(obj)
            idx = self.pods.pool.lookup((rec.namespace or "default", rec.name))
            if idx is not None and rec.ok:
                m = self.pods.pool.meta[idx]
                m["fp_meta_sel"] = rec.fp_meta_sel
                m["fp_spec"] = rec.fp_spec
                m["fp_status_done"] = rec.fp_status
        else:
            if ev_type == DELETED:
                self._node_deleted(obj)
                return
            self._node_upsert(obj)
            idx = self.nodes.pool.lookup(rec.name)
            if idx is not None and rec.ok:
                m = self.nodes.pool.meta[idx]
                m["fp_meta_sel"] = rec.fp_meta_sel
                m["fp_nsc_done"] = rec.fp_status_nc

    def _ingest_record_batch(self, kind, batch, idx, lo: int, hi: int) -> int:
        """Apply the contiguous partitioned sub-batch ``idx[lo:hi]`` (the
        unit a lane receives, and the single-lane inline unit): pods take
        the columnar path, everything else the per-record one. A failed
        columnar pass replays per record (its fresh rows were released,
        so the replay stages them from scratch). Returns the events
        applied."""
        n = hi - lo
        if n <= 0:
            return 0
        if kind == "pods" and not self._record_needs_full_path:
            try:
                self._pod_ingest_cols(batch, idx, lo, hi)
                return n
            except Exception:
                logger.exception("columnar ingest failed; replaying per record")
        record = batch.record
        ing = self._ingest_record
        for i in idx[lo:hi].tolist():
            try:
                ing(kind, record(i))
            except Exception:
                logger.exception("ingest failed for %s REC", kind)
        return n

    def _pod_ingest_cols(self, batch, idx, lo: int, hi: int) -> None:
        """Columnar pod ingest over a partitioned sub-batch: one gather
        per fixed-width column, the tier-1 echo drop and the stale tier on
        plain ints, and the new Pending rows as ONE acquire run plus ONE
        staged block (``UpdateBuffer.stage_init_array``). Per-key order
        holds: records are scanned in stream order, and a record that
        cannot join the block flushes it first when its key is already
        in it, then takes the per-record path."""
        sub = idx[lo:hi]
        ids = sub.tolist()
        flags_l = batch.flags_a[sub].tolist()
        fp_a = batch.fp_a
        fp_status = fp_a[0][sub].tolist()
        fp_spec = fp_a[2][sub].tolist()
        fp_meta = fp_a[3][sub].tolist()
        rvs_l = batch.rvs_a[sub].tolist()
        # 11 string spans per record (type, ns, name, node, phase, podIP,
        # hostIP, creation, ctrs, ictrs, trueConditions): 12 boundaries
        base = sub.astype(np.int64) * 11
        offs = batch.off_a
        col = [offs[base + j].tolist() for j in range(12)]
        c1, c2, c3, c4, c5, c6, c7, c8, c9, c10, c11 = col[1:12]
        buf = batch.buf
        lines = batch.lines
        k = self.pods
        pool = k.pool
        lookup = pool.lookup
        meta = pool.meta
        phase_ids = self._pod_phase_ids
        node_has = self.node_has
        bit_managed = (
            1 << self.pod_bits[SEL_ON_MANAGED_NODE] | 1 << self.pod_bits[SEL_MANAGED]
        )
        record = batch.record
        ing = self._ingest_record
        pending: set = set()
        stale_drops = 0
        cols: list = []  # (key, node, meta, cond_bits, has_del)
        t_added = native.REC_TYPE_ADDED
        t_modified = native.REC_TYPE_MODIFIED
        t_mask = native.REC_TYPE_MASK

        def flush_cols() -> None:
            if not cols:
                return
            if self._trace_every:
                # sampled ingest->patch spans at the per-record cadence,
                # without a per-record counter bump
                start = self._trace_n
                ev = self._trace_every
                self._trace_n = start + len(cols)
                j = (ev - (start % ev)) - 1
                t0 = time.perf_counter()
                while j < len(cols):
                    cols[j][2]["_trace_t0"] = t0
                    j += ev
            rows = []
            staged = False
            stage_ecols = self._stage_pod_ecols if self._emit_cols else None
            try:
                for key, _node, m, _cond, _hd in cols:
                    if pool.full:
                        self._grow(k)
                    row = pool.acquire(key)
                    meta[row] = m  # fresh rows: the dict replaced whole
                    if stage_ecols is not None:
                        stage_ecols(pool, row, m)
                    rows.append(row)
                # node->pods index BEFORE the node_has reads below: a
                # concurrent managed-ness fan-out either sees the pod or
                # the bits see the flip
                for key, node, _m, _cond, _hd in cols:
                    by = self.pods_by_node.get(node)
                    if by is None:
                        by = self.pods_by_node[node] = set()
                    by.add(key)
                idx_arr = np.fromiter(rows, np.int32, len(rows))
                cond_arr = np.fromiter((c[3] for c in cols), np.uint32, len(cols))
                sel_arr = np.fromiter(
                    (bit_managed if c[1] in node_has else 0 for c in cols),
                    np.uint32, len(cols),
                )
                del_arr = np.fromiter((c[4] for c in cols), bool, len(cols))
                # mirrors BEFORE the stage call (harmless on a released
                # row); stage_init_array is the point of no return
                k.phase_h[idx_arr] = _PENDING
                k.cond_h[idx_arr] = cond_arr
                k.buffer.stage_init_array(idx_arr, _PENDING, cond_arr, sel_arr, del_arr)
                staged = True
            except BaseException:
                # rows acquired here but never staged would look like
                # existing Pending rows to the per-record replay (and drop
                # its events as echoes): release them, so the replay's
                # new-row path runs
                if not staged:
                    for (key, node, _m, _c, _hd), _row in zip(cols, rows):
                        pool.release(key)
                        by = self.pods_by_node.get(node)
                        if by is not None:
                            by.discard(key)
                raise
            cols.clear()
            pending.clear()

        for j, i in enumerate(ids):
            f = flags_l[j]
            tcode = f & t_mask
            name = buf[c2[j]:c3[j]].decode("utf-8", "surrogateescape")
            s, e = c1[j], c2[j]
            ns = buf[s:e].decode("utf-8", "surrogateescape") if e > s else "default"
            key = (ns or "default", name)
            row = lookup(key)
            if f & 1 and tcode == t_modified and row is not None and key not in pending:
                m = meta[row]
                if rvs_l[j] and rvs_l[j] < (m.get("rv") or 0):
                    stale_drops += 1  # the stale tier (see _ingest_record)
                    continue
                if (
                    not (f & native.REC_DELETION)
                    and m.get("fp_meta_sel") == fp_meta[j]
                    and m.get("fp_spec") == fp_spec[j]
                    and fp_status[j] == m.get("fp_status_done")
                ):
                    continue  # identical to what was processed
            eligible = (
                f & 1
                and tcode in (t_added, t_modified)
                and row is None
                and key not in pending
                and c4[j] > c3[j]  # nodeName present
                and c6[j] == c5[j]  # no podIP (the allocator's path)
            )
            if eligible:
                s, e = c4[j], c5[j]
                phase_s = buf[s:e].decode("utf-8", "surrogateescape") if e > s else ""
                if phase_ids.get(phase_s or "Pending", _PENDING) != _PENDING:
                    eligible = False  # repair render on first sighting
            if not eligible:
                if key in pending:
                    flush_cols()  # an earlier buffered event for this key
                try:
                    ing("pods", record(i))
                except Exception:
                    logger.exception("ingest failed for pods REC")
                continue
            cond = 0
            s, e = c10[j], c11[j]
            if e > s:
                for t_ in buf[s:e].split(b"\x1f"):
                    tn = t_.decode()
                    if tn in POD_PHASES.conditions:
                        cond |= 1 << POD_PHASES.condition_bit(tn)
            has_del = bool(f & native.REC_DELETION)
            s, e = c6[j], c7[j]
            host_ip = buf[s:e].decode("utf-8", "surrogateescape") if e > s else ""
            s, e = c7[j], c8[j]
            creation = buf[s:e].decode("utf-8", "surrogateescape") if e > s else ""
            node = buf[c3[j]:c4[j]].decode("utf-8", "surrogateescape")
            m = {
                "name": name,
                "namespace": key[0],
                "node": node,
                "disregard": False,
                "raw": lines[i],
                "finalizers": bool(f & native.REC_FINALIZERS),
                "has_del": has_del,
                "creation": creation,
                "ctrs": buf[c8[j]:c9[j]],
                "ictrs": buf[c9[j]:c10[j]],
                "rgates": bool(f & native.REC_READINESS_GATES),
                "phase_str": phase_s,
                "host_ip": host_ip,
                "status_scalar": bool(f & native.REC_STATUS_SCALAR_ONLY),
                "rv": rvs_l[j],  # checkpoint identity; uid read from raw
                # fingerprints: the echo of the next server state drops
                # without a parse
                "fp_meta_sel": fp_meta[j],
                "fp_spec": fp_spec[j],
                "fp_status_done": fp_status[j],
            }
            pending.add(key)
            cols.append((key, node, m, cond, has_del))
        flush_cols()
        if stale_drops:
            wire_reject("stale_rv", stale_drops)

    def _resync(self, kind: str, objs: list[dict]) -> None:
        """Free rows for objects that vanished while the watch was down."""
        if kind == "nodes":
            seen = {(o.get("metadata") or {}).get("name") for o in objs}
            stale = [key for key in self.nodes.pool.keys() if key not in seen]
            for name in stale:
                self._node_deleted({"metadata": {"name": name}})
        else:
            seen = {
                (
                    (o.get("metadata") or {}).get("namespace") or "default",
                    (o.get("metadata") or {}).get("name"),
                )
                for o in objs
            }
            stale = [key for key in self.pods.pool.keys() if key not in seen]
            for ns, name in stale:
                self._pod_deleted({"metadata": {"namespace": ns, "name": name}})
        self._mark_resync(kind)

    def _node_upsert(self, node: dict) -> None:
        meta = node.get("metadata") or {}
        name = meta.get("name")
        if not name:
            return
        # Once a node enters the managed set it stays until Deleted
        # (nodesSets has no removal on Modified, node_controller.go:256-268).
        need_hb = self._node_need_heartbeat(node) or name in self.node_has
        k = self.nodes
        idx = k.pool.lookup(name)
        if not need_hb and idx is None:
            return  # never entered the managed set (WatchNodes Added gate)
        need_lock = not self._disregard(node)
        bits = 0
        if need_hb:
            bits |= 1 << self.node_bits[SEL_HEARTBEAT]
            if need_lock:
                bits |= 1 << self.node_bits[SEL_MANAGED]
        if idx is None:
            if k.pool.full:
                self._grow(k)
            idx = k.pool.acquire(name)
            phase = self._node_phase_from_status(node)
            k.phase_h[idx] = phase
            k.cond_h[idx] = _NODE_READY_BITS
            k.buffer.stage_init(
                idx, True, phase=phase, cond_bits=_NODE_READY_BITS,
                sel_bits=bits, has_deletion=False,
            )
        else:
            k.buffer.stage_update(idx, bits, False)
        # checkpoint identity: rv + uid of the last ingested revision (a
        # restore refines timers only for rows whose (uid, rv) still match)
        m = k.pool.meta[idx]
        m.update(name=name, obj=node, rv=_rv_of(meta), uid=meta.get("uid") or "")
        m.pop("raw", None)
        # as in _pod_upsert: this dict content may differ from what the
        # stored fingerprints describe
        for fp_key in ("fp_meta_sel", "fp_nsc_done", "fp_expect"):
            m.pop(fp_key, None)
        if need_hb and name not in self.node_has:
            self.node_has.add(name)
            self._update_pods_on_node(name)
        # repair: reference re-locks on every event with no-op suppression
        # (LockNode from WatchNodes Added|Modified)
        if need_hb and need_lock and k.phase_h[idx] == _NODE_READY:
            current = node.get("status") or {}
            rendered = render_node_status(
                node, int(k.cond_h[idx]), self.config.node_ip,
                now_rfc3339(), self.start_time,
            )
            if node_status_patch_needed(current, rendered):
                self._submit(self._patch_node_status, name, idx)

    def _node_deleted(self, node: dict) -> None:
        name = (node.get("metadata") or {}).get("name")
        k = self.nodes
        with self._alloc_lock:
            # the release and its sequence stamp are one atomic step
            idx = k.pool.release(name)
            if idx is not None:
                self._release_seq += 1
                k.released_at[idx] = self._release_seq
        if idx is not None:
            k.buffer.stage_init(idx, False)
        if name in self.node_has:
            self.node_has.discard(name)
            self._update_pods_on_node(name)

    def _node_phase_from_status(self, node: dict) -> int:
        for cond in (node.get("status") or {}).get("conditions") or []:
            if cond.get("type") == "Ready" and cond.get("status") == "True":
                return _NODE_READY
        return _NODE_OBSERVED

    def _pod_bits(self, pod_meta: dict) -> int:
        nh = pod_meta.get("node") in self.node_has
        bits = 0
        if nh:
            bits |= 1 << self.pod_bits[SEL_ON_MANAGED_NODE]
            if not pod_meta.get("disregard"):
                bits |= 1 << self.pod_bits[SEL_MANAGED]
        return bits

    def _pod_upsert(self, pod: dict) -> None:
        meta = pod.get("metadata") or {}
        name = meta.get("name")
        ns = meta.get("namespace") or "default"
        if not name:
            return
        key = (ns, name)
        node_name = (pod.get("spec") or {}).get("nodeName") or ""
        if not node_name:
            return
        k = self.pods
        idx = k.pool.lookup(key)
        new_row = idx is None
        if new_row:
            if k.pool.full:
                self._grow(k)
            idx = k.pool.acquire(key)
        m = k.pool.meta[idx]
        status = pod.get("status") or {}
        spec = pod.get("spec") or {}
        m.update(
            name=name,
            namespace=ns,
            node=node_name,
            disregard=self._disregard(pod),
            obj=pod,
            finalizers=bool(meta.get("finalizers")),
            has_del="deletionTimestamp" in meta,
            # the fields the batch emit reads (rows from native records
            # carry them without a parsed object)
            creation=meta.get("creationTimestamp") or "",
            ctrs=_ctr_blob(spec.get("containers")),
            ictrs=_ctr_blob(spec.get("initContainers")),
            rgates=bool(spec.get("readinessGates")),
            phase_str=status.get("phase") or "",
            host_ip=status.get("hostIP") or "",
            status_scalar=set(status) <= _SCALAR_STATUS_KEYS,
            rv=_rv_of(meta),
            uid=meta.get("uid") or "",
        )
        m.pop("raw", None)  # the parsed object supersedes any raw line
        # fingerprints describe the record path's state; this dict event
        # may carry other content, so they must never justify dropping a
        # later event (the record path re-seeds them when it has them)
        for fp_key in ("fp_status_done", "fp_spec", "fp_meta_sel",
                       "fp_expect", "expect_phase"):
            m.pop(fp_key, None)
        if self._trace_every:
            self._trace_n += 1
            if self._trace_n % self._trace_every == 0:
                # sampled end-to-end trace: the patch ack closes the span
                m["_trace_t0"] = time.perf_counter()
        pod_ip = status.get("podIP")
        if pod_ip:
            with self._alloc_lock:
                if self.ippool.contains(pod_ip):
                    # pin pool-range IPs on (re)list so a restarted engine
                    # neither reassigns them nor hands them to another pod
                    self.ippool.use(pod_ip)
                m["podIP"] = pod_ip
        if self._emit_cols:
            self._stage_pod_ecols(k.pool, idx, m)
        has_del = m["has_del"]
        self.pods_by_node.setdefault(node_name, set()).add(key)
        bits = self._pod_bits(m)
        if new_row:
            phase = self._pod_phase_ids.get(
                status.get("phase") or "Pending", _PENDING
            )
            cond = 0
            for c in status.get("conditions") or []:
                t = c.get("type")
                if t in POD_PHASES.conditions and c.get("status") == "True":
                    cond |= 1 << POD_PHASES.condition_bit(t)
            k.buffer.stage_init(
                idx, True, phase=phase, cond_bits=cond, sel_bits=bits,
                has_deletion=has_del,
            )
            k.phase_h[idx] = phase
            k.cond_h[idx] = cond
        else:
            k.buffer.stage_update(idx, bits, has_del)
        # repair path (LockPod on every event + computePatchData
        # suppression)
        managed = bool(bits >> self.pod_bits[SEL_MANAGED] & 1)
        if managed and not has_del and k.phase_h[idx] != _PENDING:
            rendered = self._render_pod(idx)
            if rendered is not None and pod_status_patch_needed(status, rendered):
                self._submit(self._patch_pod_status, key, idx)

    def _stage_pod_ecols(self, pool, idx: int, m: dict) -> None:
        """The row's emit inputs as byte columns, encoded ONCE at upsert,
        so a template emit batch never walks the meta dicts. Callers gate
        on ``_emit_cols`` and call once the meta dict (any podIP pin
        included) is final."""
        f = EF_RENDER
        if m.get("rgates"):
            f |= EF_RGATES
        if m.get("status_scalar"):
            f |= EF_SCALAR
        pool.eflags[idx] = f
        pool.srv_phase[idx] = self._pod_phase_ids.get(m.get("phase_str") or "", -1)
        h = m.get("host_ip")
        pool.host_b[idx] = _wire(h) if h else None
        c = m.get("creation")
        pool.start_b[idx] = _wire(c) if c else b""
        pool.ctr_b[idx] = m.get("ctrs") or b""
        pool.ictr_b[idx] = m.get("ictrs") or b""
        ip = m.get("podIP")
        if ip:
            pool.ip_b[idx] = _wire(ip)
        if pool.path_b[idx] is None:
            pool.path_b[idx] = (
                f"/api/v1/namespaces/{_quote(m.get('namespace') or 'default')}"
                f"/pods/{_quote(m['name'])}"
            ).encode()

    @staticmethod
    def _lazy_obj(m) -> "dict | None":
        """The row's parsed object, decoding its raw watch line (and
        caching the result) for rows whose last event took the record
        path."""
        obj = m.get("obj")
        if obj is None and "raw" in m:
            try:
                doc = json.loads(m["raw"])
            except ValueError:  # a garbled raw line, or bad UTF-8
                return None
            obj = doc.get("object") or {}
            m["obj"] = obj
        return obj

    def _pod_obj(self, m) -> "dict | None":
        return self._lazy_obj(m)

    def _pod_upsert_record(self, rec) -> bool:
        """Row init or update straight from a native record, no json.loads.
        Returns False when the event needs the full path: a repair render
        on a row past Pending, a first sighting past Pending, or disregard
        selectors (they match fields the record does not carry)."""
        name = rec.name
        node_name = rec.node_name
        if not name or not node_name:
            return True  # the early-outs of _pod_upsert
        if self._record_needs_full_path:
            return False
        ns = rec.namespace or "default"
        key = (ns, name)
        k = self.pods
        idx = k.pool.lookup(key)
        new_row = idx is None
        if not new_row and int(k.phase_h[idx]) != _PENDING:
            return False  # LockPod repair needs the full object
        if new_row and self._pod_phase_ids.get(rec.phase or "Pending", _PENDING) != _PENDING:
            return False
        flags = rec.flags
        has_del = bool(flags & native.REC_DELETION)
        # a row acquired but never staged would look tracked (and swallow
        # its re-delivery as an update): released on any failure before
        # the stage, never after it (that would orphan the staged init)
        staged = [not new_row]
        try:
            return self._pod_upsert_record_apply(
                rec, k, key, idx, new_row, flags, has_del, name, ns, node_name, staged,
            )
        except BaseException:
            if not staged[0]:
                k.pool.release(key)
                by = self.pods_by_node.get(node_name)
                if by is not None:
                    by.discard(key)
            raise

    def _pod_upsert_record_apply(
        self, rec, k, key, idx, new_row, flags, has_del, name, ns, node_name, staged,
    ) -> bool:
        """The mutation body of _pod_upsert_record. Fingerprints are seeded
        LAST: an event interrupted before them is re-processed on
        re-delivery, never dropped as an echo."""
        fields = {
            "name": name,
            "namespace": ns,
            "node": node_name,
            "disregard": False,
            "raw": rec.raw,
            "finalizers": bool(flags & native.REC_FINALIZERS),
            "has_del": has_del,
            "creation": rec.creation,
            "ctrs": rec.containers,
            "ictrs": rec.init_containers,
            "rgates": bool(flags & native.REC_READINESS_GATES),
            "phase_str": rec.phase,
            "host_ip": rec.host_ip,
            "status_scalar": bool(flags & native.REC_STATUS_SCALAR_ONLY),
            "rv": rec.rv,  # checkpoint identity; uid read from raw on demand
        }
        if new_row:
            if k.pool.full:
                self._grow(k)
            idx = k.pool.acquire(key)
            m = k.pool.meta[idx] = fields
        else:
            m = k.pool.meta[idx]
            m.update(fields)
            m.pop("obj", None)  # the raw line supersedes any stale object
            m.pop("uid", None)
        if self._trace_every:
            self._trace_n += 1
            if self._trace_n % self._trace_every == 0:
                m["_trace_t0"] = time.perf_counter()
        if rec.pod_ip:
            with self._alloc_lock:
                if self.ippool.contains(rec.pod_ip):
                    self.ippool.use(rec.pod_ip)
                m["podIP"] = rec.pod_ip
        if self._emit_cols:
            self._stage_pod_ecols(k.pool, idx, m)
        by_node = self.pods_by_node.get(node_name)
        if by_node is None:
            by_node = self.pods_by_node[node_name] = set()
        by_node.add(key)  # before the node_has read: see _pod_ingest_cols
        bits = self._pod_bits(m)
        if new_row:
            phase = self._pod_phase_ids.get(rec.phase or "Pending", _PENDING)
            cond = 0
            if rec.true_conditions:
                for t in rec.true_conditions.split(b"\x1f"):
                    tn = t.decode()
                    if tn in POD_PHASES.conditions:
                        cond |= 1 << POD_PHASES.condition_bit(tn)
            k.phase_h[idx] = phase
            k.cond_h[idx] = cond
            k.buffer.stage_init(idx, True, phase, cond, bits, has_del)
            staged[0] = True
        else:
            k.buffer.stage_update(idx, bits, has_del)
        # no repair: rows here are Pending, where the reference patches on
        # a transition, never on repair
        m["fp_meta_sel"] = rec.fp_meta_sel
        m["fp_spec"] = rec.fp_spec
        m["fp_status_done"] = rec.fp_status
        return True

    def _pod_deleted(self, pod: dict) -> None:
        meta = pod.get("metadata") or {}
        key = (meta.get("namespace") or "default", meta.get("name"))
        k = self.pods
        idx = k.pool.lookup(key)
        if idx is None:
            return
        m = k.pool.meta[idx]
        node_name = m.get("node")
        with self._alloc_lock:
            k.pool.release(key)
            self._release_seq += 1
            k.released_at[idx] = self._release_seq
            ip = m.get("podIP") or (pod.get("status") or {}).get("podIP")
        if ip and self.ippool.contains(ip):
            # recycle pool-allocated IPs (pod_controller.go:334-337)
            self.ippool.put(ip)
        if node_name and node_name in self.pods_by_node:
            self.pods_by_node[node_name].discard(key)
        k.buffer.stage_init(idx, False)

    def _update_pods_on_node(self, node_name: str) -> None:
        """Re-evaluate pods bound to a node whose managed-ness changed
        (LockPodsOnNode wiring, controller.go:113-115)."""
        k = self.pods
        for key in self.pods_by_node.get(node_name, set()):
            idx = k.pool.lookup(key)
            if idx is None:
                continue
            m = k.pool.meta[idx]
            k.buffer.stage_update(idx, self._pod_bits(m), m.get("has_del", False))

    # ------------------------------------------------------------------ grow

    def _grow(self, k: _Kind) -> None:
        new_cap = max(k.capacity * 2, 1024)
        logger.info("growing row pool %d -> %d", k.capacity, new_cap)
        with self._device_ctx():
            k.grow(new_cap)

    # ------------------------------------------------------------- tick loop

    # Idle backstop: with no staged writes and no device timer pending, the
    # loop still wakes this often (one cheap dispatch) as a safety net.
    _IDLE_MAX = 60.0

    def _tick_loop(self) -> None:
        """Pipelined tick loop. Each iteration drains ingest, consumes any
        in-flight ticks whose wire has landed on the host, then dispatches
        the next tick; consume order is FIFO, so per-object patch order is
        the synchronous loop's."""
        with self._device_ctx():
            self._tick_loop_body()

    def _tick_loop_body(self) -> None:
        interval = self.config.tick_interval
        depth = max(1, int(self.config.pipeline_depth))
        pending: "deque" = deque()
        tel = self.telemetry
        profiling.maybe_start()
        try:
            while self._running:
                deadline = time.monotonic() + interval
                # idle: sleep until the device-reported deadline
                if (
                    not pending
                    and self._q.empty()
                    and not self.nodes.buffer.pending
                    and not self.pods.buffer.pending
                ):
                    wake = self._idle_wake
                    if wake is None:
                        deadline = time.monotonic() + self._IDLE_MAX
                    elif wake > deadline:
                        deadline = min(wake, time.monotonic() + self._IDLE_MAX)
                    deadline = self._idle_deadline(deadline)
                got_event = False
                raw_buf: dict = {}
                drain_s = 0.0  # seconds applying items this window
                drain_t0 = 0.0  # first drained item of the window
                lag_max = 0.0  # slowest enqueue->processing delay
                # drain ingest until the next tick is due; while ticks are
                # in flight, wait in short slices so a wire landing
                # mid-drain is consumed promptly
                while True:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self._q.get(
                            timeout=min(timeout, 0.005) if pending else timeout
                        )
                    except queue.Empty:
                        if pending and self._wire_ready(pending[0]):
                            self._consume_safe(pending.popleft())
                            self._prune_released(
                                pending[0].seq if pending else self._release_seq
                            )
                        continue
                    if item is None:
                        if not self._running:
                            return
                        continue
                    if not got_event:
                        got_event = True
                        # an event arriving during an idle sleep must be
                        # ticked within one normal interval
                        deadline = min(deadline, time.monotonic() + interval)
                    t_item = time.perf_counter()
                    if not drain_t0:
                        drain_t0 = t_item
                    if len(item) > 3:
                        lag_max = max(lag_max, time.monotonic() - item[3])
                    self._drain_apply(item, raw_buf)
                    # keep draining whatever is immediately available
                    while True:
                        try:
                            item = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if item is None:
                            if not self._running:
                                return
                            continue
                        self._drain_apply(item, raw_buf)
                    drain_s += time.perf_counter() - t_item
                # the batched parse of the window's raw lines, before the
                # flush and dispatch below
                if raw_buf:
                    t_item = time.perf_counter()
                    self._drain_flush(raw_buf)
                    drain_s += time.perf_counter() - t_item
                if got_event:
                    tel.observe_watch_lag(lag_max)
                    tel.observe_stage("drain", drain_s)
                    # one span per drain window: anchored at the first
                    # drained item, lasting the active drain time
                    tel.span(
                        "tick.drain", drain_t0, drain_t0 + drain_s, "drain"
                    )
                else:
                    tel.set_gauge("watch_lag_seconds", 0.0)
                tel.set_gauge("tick_inflight", len(pending))
                did_dispatch = False
                try:
                    # consume every tick whose wire has landed; a full
                    # pipeline blocks on the oldest
                    while pending and (
                        len(pending) >= depth or self._wire_ready(pending[0])
                    ):
                        self._tick_consume(pending.popleft())
                        self._prune_released(
                            pending[0].seq if pending else self._release_seq
                        )
                    # dispatch only when something calls for a tick: an
                    # event drained, writes staged, or a device timer due
                    wake = self._idle_wake
                    if (
                        got_event
                        or self.nodes.buffer.pending
                        or self.pods.buffer.pending
                        or (wake is not None and time.monotonic() >= wake)
                    ):
                        did_dispatch = True
                        p = self._tick_dispatch()
                        if p is not None:
                            pending.append(p)
                except Exception:
                    logger.exception("tick failed")
                    # re-arm: staged work may already be on the device
                    # with no event left to trigger the gate
                    self._idle_wake = time.monotonic() + interval
                tel.set_gauge("ingest_queue_depth", self._q.qsize())
                if self._startup_pending is not None or self._ckpt is not None:
                    # the startup gate, the restore refine and the
                    # checkpoint gathers (one attribute test per iteration
                    # when disabled)
                    try:
                        self._ckpt_service(did_dispatch)
                    except Exception:
                        logger.exception("checkpoint service failed")
        finally:
            # stopping: flush in-flight ticks so patches already computed
            # on the device are not dropped, flush a profile the stop cut
            # short (torch.profiler must stop on the thread that started
            # it), then gather the final checkpoint on this thread
            while pending:
                self._consume_safe(pending.popleft())
            self._close_profiler()
            if self._ckpt is not None:
                try:
                    self._ckpt.final(self._ckpt_snapshot(self._now()))
                except Exception:
                    logger.exception("final checkpoint failed")

    def _close_profiler(self) -> None:
        """The tick thread's exit path: write a profile window still open."""
        if self._profiler is not None:
            try:
                self._profiler.close(self.telemetry.ticks_total)
            except Exception:
                logger.exception("profiler trace flush failed")

    def _consume_safe(self, p: "_PendingTick") -> None:
        try:
            self._tick_consume(p)
        except Exception:
            logger.exception("tick consume failed")

    def tick_once(self) -> None:
        """One synchronous engine step: dispatch the fused kernel and
        consume its wire immediately. Under lanes, the coordinator's
        synchronous step (route and drain inline, dispatch, consume with
        inline emit)."""
        with self._device_ctx():
            if self._lanes is not None:
                self._lanes.tick_once()
                return
            p = self._tick_dispatch()
            if p is not None:
                self._tick_consume(p)
        self._prune_released(self._release_seq)

    # -------------------------------------------- crash-durable restarts

    def _ckpt_service(self, dispatched: bool) -> None:
        """Single-lane checkpoint/restore service, once per tick-loop
        iteration on the tick thread (the only mutator of pools, buffers
        and device state here). The lanes run LaneSet._ckpt_service."""
        now = self._now()
        r = self._restore
        if r is not None:
            if r.expired() or (not r.gate_ready and not r.remaining):
                self._end_restore(r)
            else:
                self._ckpt_refine(now)
            # keep the loop TICKING while a session is live and until the
            # pipeline has flushed every pre-refine wire: each consume
            # recomputes the idle wake from its wire's dues, and wires
            # dispatched before a refine carry the fresh-arm deadlines
            self._ckpt_force_ticks = max(1, int(self.config.pipeline_depth)) + 2
        if self._ckpt_force_ticks > 0:
            self._ckpt_force_ticks -= 1
            self._idle_wake = time.monotonic()
        self._ckpt_gate(
            dispatched,
            staged=bool(self.nodes.buffer.pending or self.pods.buffer.pending),
        )
        self._ckpt_due(now, dispatched, self._ckpt_snapshot)

    def _ckpt_due(self, now: float, dispatched: bool, snapshot) -> None:
        """Gather (``snapshot(now)``) and submit a checkpoint when the
        cadence is due and a dispatch ran since the last one: an idle
        engine's residues only shrink together with time."""
        ck = self._ckpt
        if ck is None:
            return
        self._ckpt_dirty = self._ckpt_dirty or dispatched
        if self._ckpt_dirty and ck.due():
            self._ckpt_dirty = False
            ck.submit(snapshot(now))

    def _idle_deadline(self, deadline: float) -> float:
        """Cap an idle sleep at the checkpoint's next due time while a
        dispatch since the last checkpoint is not written yet, so the file
        catches up with the last arming dispatch without waiting for the
        next event."""
        ck = self._ckpt
        if ck is not None and self._ckpt_dirty:
            return min(deadline, time.monotonic() + ck.seconds_to_due())
        return deadline

    def _ckpt_refine(self, now: float) -> None:
        """Scatter checkpointed timer residues into matching rows. Runs
        AFTER the arming dispatch (the kernel re-armed restored rows with
        fresh delays; this overwrites them with ``now + residue``), and
        skips rows whose init is still staged."""
        r = self._restore
        for k, kind in ((self.nodes, "nodes"), (self.pods, "pods")):
            if not r.kinds.get(kind):
                continue
            staged = k.buffer.staged_rows() if k.buffer.pending else frozenset()
            # an entry with a delay residue is consumed only once the
            # kernel ARMED its row (finite fire_at): refining earlier is
            # undone by the arming re-arm itself
            cur_fire = k.state.fire_at.cpu().numpy()
            idx, fire, hb, gen = r.match_kind(
                kind, k.pool, staged, now, phase_h=k.phase_h, fire=cur_fire,
            )
            if idx.size:
                k.state = refine_flush(k.state, idx, fire, hb, gen)

    def _ckpt_snapshot(self, now: float) -> dict:
        """Gather the checkpoint rows: one host copy of the timer fields
        per kind plus a pool/meta walk (tick thread, between dispatches)."""
        t0 = time.perf_counter()
        kinds = {}
        for k, kind in ((self.nodes, "nodes"), (self.pods, "pods")):
            fire, hb, gen = gather_deadlines(k.state)
            staged = k.buffer.staged_rows() if k.buffer.pending else frozenset()
            kinds[kind] = ckpt_mod.gather_rows(
                kind, k.pool, k.phase_h, fire, hb, gen, staged, now
            )
        self.telemetry.note(
            "checkpoint_snapshot_seconds_last", time.perf_counter() - t0
        )
        return {"kinds": kinds}

    def _ckpt_written(self, seconds: float, nbytes: int, armed: int,
                      idle: int) -> None:
        """The checkpoint writer's report after each good write:
        ``kwok_checkpoint_write_seconds`` and ``kwok_checkpoint_rows``,
        plus the flat view's summary."""
        tel = self.telemetry
        tel.ckpt_write_hist.observe(seconds)
        tel.ckpt_rows["armed"].set(armed)
        tel.ckpt_rows["idle"].set(idle)
        tel.note("checkpoint_writes_total", tel.ckpt_write_hist.count)
        tel.note("checkpoint_write_seconds_last", seconds)
        tel.note("checkpoint_bytes_last", nbytes)

    @staticmethod
    def _wire_ready(p) -> bool:
        return p.wire.is_ready()

    def _prune_released(self, min_seq: int) -> None:
        """Drop release-log entries no in-flight tick can still consult
        (everything at or before the oldest pending dispatch's seq)."""
        for k in (self.nodes, self.pods):
            if k.released_at:
                k.released_at = {
                    idx: s for idx, s in k.released_at.items() if s > min_seq
                }

    def _tick_dispatch(self) -> "_PendingTick | None":
        """First half of a tick: flush staged ingest writes and dispatch the
        fused kernel. Returns a _PendingTick whose wire lands on the host
        asynchronously, or None when nothing is on the device."""
        if self._profiler is not None:
            self._profiler.step(self.telemetry.ticks_total)
        t0 = time.perf_counter()
        now = self._now()
        if now >= REBASE_AFTER:
            # f32 engine time: re-zero the epoch before resolution decays
            self._epoch += now
            for k in (self.nodes, self.pods):
                k.state = rebase_times(k.state, now)
            self._inc("epoch_rebases_total")
            logger.info("epoch rebase at engine time %.1fs", now)
            now = 0.0
        work = False
        for k in (self.nodes, self.pods):
            if k.buffer.pending:
                k.state = k.buffer.flush(k.state)
                work = True
            elif len(k.pool):
                work = True
        t_flush = time.perf_counter()
        tel = self.telemetry
        tel.set_gauge("nodes_managed", len(self.nodes.pool))
        tel.set_gauge("pods_managed", len(self.pods.pool))
        tel.inc("ticks_total")
        tel.observe_stage("flush", t_flush - t0)
        if not work:
            self._idle_wake = None  # empty engine: sleep until events
            return None
        fused = self._get_fused()
        # with substeps, the kernel runs at now_base + i*dt; anchor the
        # LAST substep at wall-now so firing never runs ahead of time
        now_base = now - (fused.steps - 1) * fused.dt
        _outs, wire = fused((self.nodes.state, self.pods.state), now_base)
        t_end = time.perf_counter()
        tel.span("tick.dispatch", t0, t_end, "dispatch")
        return _PendingTick(
            wire=wire,
            caps=[self.nodes.capacity, self.pods.capacity],
            seq=self._release_seq,
            now=now,
            mono=time.monotonic(),
            host_s=t_end - t0,
        )

    def _tick_consume(self, p: "_PendingTick") -> None:
        """Second half of a tick: wait until p's wire is on the host (free
        when it landed during the pipeline window), refresh the fired
        rows' phase/cond mirrors, and emit patches."""
        t0 = time.perf_counter()
        counters, masks_fn, dues, rows_fn = unpack_wire(
            np.asarray(p.wire), p.caps, rows=True
        )
        t_wire = time.perf_counter()
        nd = float(dues.min())
        self._idle_wake = (
            None if nd == float("inf")
            else p.mono + max(0.0, nd - p.now)
        )
        emit_s = 0.0
        if counters.any():
            now_str = now_rfc3339()
            masks = masks_fn()
            rows = None
            for i, (k, kind) in enumerate(
                ((self.nodes, "nodes"), (self.pods, "pods"))
            ):
                n_trans = int(counters[i])
                n_hb = int(counters[2 + i])
                if n_trans:
                    self.telemetry.inc_kind("transitions_total", kind, n_trans)
                if not (n_trans or n_hb):
                    continue
                dirty, deleted, hb = masks[i]
                # mask bits of rows released since this tick's dispatch
                # describe the OLD occupant: the release path did their
                # teardown. Rows beyond this dispatch's capacity have no
                # mask bits to clear.
                cap = dirty.shape[0]
                stale = [
                    idx for idx, s in k.released_at.items()
                    if s > p.seq and idx < cap
                ]
                if stale:
                    dirty[stale] = False
                    deleted[stale] = False
                    hb[stale] = False
                if n_trans:
                    idxs = np.nonzero(dirty | deleted)[0]
                    if idxs.size:
                        if rows is None:
                            rows = rows_fn()
                        ph, cb = rows[i]
                        # refresh ONLY the fired rows
                        k.phase_h[idxs] = ph[idxs]
                        k.cond_h[idxs] = cb[idxs]
                _t = time.perf_counter()
                self._emit(kind, k, dirty, deleted, hb, now_str)
                _t1 = time.perf_counter()
                emit_s += _t1 - _t
                self.telemetry.span(
                    "tick.emit", _t, _t1, "emit", {"kind": kind}
                )
        # host seconds of this tick on the tick thread: dispatch, the wait
        # for the wire, unpack and emit (patches run on the executor)
        elapsed = time.perf_counter() - t0 + p.host_s
        tel = self.telemetry
        tel.observe_tick(elapsed)
        tel.observe_stage("kernel", t_wire - t0)
        if emit_s:
            tel.observe_stage("emit", emit_s)
        tel.span(
            "tick.consume", t0, time.perf_counter(), "consume",
            {"wire_wait_us": round((t_wire - t0) * 1e6, 1)},
        )

    # ------------------------------------------------------------------ emit

    def _submit(self, fn, *args) -> bool:
        """Run fn on the patch executor (inline in synchronous mode).
        Returns False when the executor is already shut down (the job is
        dropped and counted)."""
        if self._executor is None:
            fn(*args)  # synchronous mode (tests call tick_once directly)
            return True
        try:
            self._executor.submit(self._safe, fn, *args)
            return True
        except RuntimeError:
            self._inc("dropped_jobs_total")
            return False

    @staticmethod
    def _transient(e: Exception) -> bool:
        """Connection-shaped failures, worth retrying. HTTP status errors
        are definitive answers, never retried."""
        import http.client
        import urllib.error

        if isinstance(e, urllib.error.HTTPError):
            return False
        return isinstance(
            e, (ConnectionError, TimeoutError, OSError, http.client.HTTPException)
        )

    def _safe(self, fn, *args) -> None:
        """Executor job: run fn, retrying transport failures and 429s
        under PATCH_RETRY until its 8 s deadline, so an apiserver restart
        window does not eat a patch: a lost status patch has no
        retrigger (the server never echoes the state the engine expects).
        A 429 waits at least its Retry-After, counted in
        ``client_throttle_seconds_total``."""
        backoff = None
        while True:
            try:
                fn(*args)
                return
            except Exception as e:
                throttled = isinstance(e, TooManyRequests)
                if not (self._running and (throttled or self._transient(e))):
                    self._inc("patch_errors_total")
                    logger.exception("patch job failed")
                    return
                if backoff is None:
                    backoff = PATCH_RETRY.session()
                delay = backoff.next_delay()
                if delay is None:  # past the policy's deadline
                    self._inc("patch_errors_total")
                    logger.error("patch job failed after retries: %s", e)
                    return
                if throttled:
                    delay = max(delay, e.retry_after)
                    self.telemetry.add_throttle(delay)
                backoff.sleep(delay, lambda: not self._running)

    def _get_pump(self):
        """The native pump group bound to the client's plain-HTTP
        endpoint, built once; None under ``KWOK_TPU_NATIVE=0``, for a TLS
        or in-process client, or when the pump cannot be built (logged at
        WARNING): those keep the executor's one job per object. Under a
        fault plane each connection group is a ``FaultyPump``; a process
        lane's ``_pump_wrap`` goes outside it, so its replay slot sees
        exactly the frames that reach the plane. The HA fence's wrap
        (ROADMAP item 12) would go between the two; the CLI refuses HA."""
        if self._pump_tried:
            return self._pump
        self._pump_tried = True
        if self._codec is None:
            return None
        server = getattr(self.client, "server", "")
        if not isinstance(server, str) or not server.startswith("http://"):
            return None
        host = getattr(self.client, "_host", None)
        port = getattr(self.client, "_port", None)
        base = getattr(self.client, "_base_path", "") or ""
        if not host or not port:
            return None
        token = getattr(self.client, "token", None)
        extra = f"Authorization: Bearer {token}\r\n" if token else ""
        try:
            pumps = [
                self._codec.Pump(host, int(port), nconn=self._pump_nconn,
                                 header_extra=extra)
                for _ in range(self._pump_groups)
            ]
            if self._faults is not None:
                # pump.cc's failure contract on demand (drops, short
                # writes, delays)
                pumps = [self._faults.wrap_pump(p) for p in pumps]
            if self._pump_wrap is not None:
                # outermost: a process lane's replay slot must see exactly
                # the frames that go on the wire
                pumps = [self._pump_wrap(p) for p in pumps]
            self._pump = _PumpGroup(pumps)
            self._pump_base = base
            self._pump_base_b = base.encode()
        except Exception:
            logger.warning("native pump unavailable; executor egress", exc_info=True)
            self._pump = None
        return self._pump

    def _node_path_b(self, pool, idx: int, name: str) -> bytes:
        """The node's URL-quoted path, cached in the pool's path column at
        first emit (node upserts are too rare to stage it eagerly)."""
        pb = pool.path_b[idx]
        if pb is None:
            pb = pool.path_b[idx] = f"/api/v1/nodes/{_quote(name)}".encode()
        return pb

    def _emit(self, kind, k, dirty, deleted, hb, now_str) -> None:
        """A tick's masks as patches: pump batches when the native pump
        is up (more than one row), else one executor job per object."""
        if kind == "nodes":
            node_rows = [int(i) for i in np.nonzero(dirty)[0]]
            if len(node_rows) > 1 and self._get_pump() is not None:
                self._emit_nodes_native(k, node_rows)
                node_rows = []
            for idx in node_rows:
                name = k.pool.key_of(idx)
                if name is not None:
                    self._submit(self._patch_node_status, name, idx)
            hb_rows = [
                (name, int(idx))
                for idx in np.nonzero(hb)[0]
                if (name := k.pool.key_of(int(idx))) is not None
            ]
            if self._codec is not None and len(hb_rows) > 1:
                self._emit_heartbeats_native(k, hb_rows, now_str)
            else:
                for name, idx in hb_rows:
                    self._submit(self._heartbeat_node, name, idx, now_str)
        else:
            dirty_rows = [int(i) for i in np.nonzero(dirty)[0]]
            if len(dirty_rows) > 1 and self._get_pump() is not None:
                dirty_rows = self._emit_pods_native(k, dirty_rows)
            for idx in dirty_rows:
                key = k.pool.key_of(idx)
                if key is not None:
                    self._submit(self._patch_pod_status, key, idx)
            del_rows = [
                (key, int(idx))
                for idx in np.nonzero(deleted)[0]
                if (key := k.pool.key_of(int(idx))) is not None
            ]
            if len(del_rows) > 1 and self._get_pump() is not None:
                self._emit_deletes_native(k, del_rows)
            else:
                for key, idx in del_rows:
                    self._submit(self._delete_pod, key, idx)

    _EMIT_CTYPE = "application/strategic-merge-patch+json"

    def _emit_nodes_native(self, k, idxs: list[int]) -> None:
        """Node status patches rendered in Python (node transitions are
        rare next to pods) and shipped as ONE pump batch. A node whose
        current status is scalar-only seeds ``fp_expect``."""
        now = now_rfc3339()
        base = self._pump_base_b
        reqs, sent = [], []
        for idx in idxs:
            name = k.pool.key_of(idx)
            m = k.pool.meta[idx]
            if name is None or not m:
                continue
            node = self._lazy_obj(m) or {}
            current = node.get("status") or {}
            rendered = render_node_status(
                node, int(k.cond_h[idx]), self.config.node_ip, now,
                self.start_time,
            )
            if not node_status_patch_needed(current, rendered):
                continue
            body = json.dumps({"status": rendered}, separators=(",", ":")).encode()
            reqs.append((
                "PATCH", base + self._node_path_b(k.pool, idx, name) + b"/status",
                body, self._EMIT_CTYPE,
            ))
            # a scalar-only current status: the merged echo is exactly
            # this document, so ingest may drop it by fingerprint
            sent.append((idx, m if set(current) <= _SCALAR_STATUS_KEYS else None))
        if reqs:
            fps = self._codec.fingerprint_statuses([r[2] for r in reqs])
            for (_idx, m2), fp in zip(sent, fps.tolist()):
                if m2 is not None:
                    m2["fp_expect"] = fp
            self._submit(self._pump_send, reqs, [i for i, _ in sent], "nodes")

    _POD_KIND = {"Running": 0, "Succeeded": 1, "Failed": 2}

    def _emit_pods_native(self, k, idxs: list[int]) -> list[int]:
        """The batch path for a tick's pod patches: with templates (the
        default) a columnar gather and ONE fused render-and-send job
        (``_emit_pods_tpl``); under ``KWOK_TPU_NATIVE_EMIT=0`` a per-row
        meta gather, the generic native render and a pump send. Returns
        the rows that take the Python path: readiness gates, rows whose
        target phase is already on the server (the no-op merge check)
        and rows without state. Runs on the thread that owns the rows, so
        none vanishes mid-batch."""
        if self._emit_tpl is not None:
            return self._emit_pods_tpl(k, idxs)
        slow: list[int] = []
        sent_idx: list[int] = []
        kinds_l: list[int] = []
        conds_l: list[int] = []
        phases: list[bytes] = []
        hosts: list[bytes] = []
        ips: list[bytes] = []
        starts: list[bytes] = []
        ctrs: list[bytes] = []
        ictrs: list[bytes] = []
        paths: list[str] = []
        phase_names: list[str] = []
        base = self._pump_base
        node_ip = self.config.node_ip
        pod_kind = self._POD_KIND
        meta = k.pool.meta
        for idx in idxs:
            key = k.pool.key_of(idx)
            m = meta[idx]
            if key is None or not m or ("obj" not in m and "raw" not in m):
                continue
            phase_name = self._pod_phases[int(k.phase_h[idx])]
            if phase_name == "Gone":
                continue
            if m.get("rgates") or m.get("phase_str") == phase_name:
                slow.append(idx)
                continue
            ip = m.get("podIP")
            if not ip:
                with self._alloc_lock:
                    ip = m.get("podIP")
                    if not ip:
                        ip = m["podIP"] = self.ippool.get()
            ns, name = key
            sent_idx.append(idx)
            kinds_l.append(pod_kind.get(phase_name, 0))
            conds_l.append(int(k.cond_h[idx]))
            phases.append(phase_name.encode())
            phase_names.append(phase_name)
            hosts.append(_wire(m.get("host_ip") or node_ip))
            ips.append(_wire(ip))
            starts.append(_wire(m.get("creation") or now_rfc3339()))
            ctrs.append(m.get("ctrs") or b"")
            ictrs.append(m.get("ictrs") or b"")
            paths.append(
                f"{base}/api/v1/namespaces/{_quote(ns)}/pods/{_quote(name)}/status"
            )
        if not sent_idx:
            return slow
        bodies = self._codec.render_pod_statuses(
            np.array(kinds_l, np.uint8), np.array(conds_l, np.uint32), phases,
            list(POD_PHASES.conditions[:3]), hosts, ips, starts, ctrs, ictrs,
        )
        # the echo of a patch onto a scalar-only status is exactly the
        # rendered document: ingest drops it by fingerprint
        fps = self._codec.fingerprint_statuses(bodies)
        for idx, pn, fp in zip(sent_idx, phase_names, fps.tolist()):
            m = meta[idx]
            if m.get("status_scalar"):
                m["fp_expect"] = fp
                m["expect_phase"] = pn
        reqs = [("PATCH", path, body, self._EMIT_CTYPE)
                for path, body in zip(paths, bodies)]
        self._submit(self._pump_send, reqs, sent_idx, "pods")
        return slow

    def _emit_pods_tpl(self, k, idxs: list[int]) -> list[int]:
        """The template emit gather: classify rows off the staged byte
        columns (no meta walk, no per-row encode, one ``now`` per batch)
        and hand ONE job to the executor whose body is a single render
        and send C call. The slow-path rows are ``_emit_pods_native``'s.
        (Rows of a live CNI provider would take the slow path too; the
        port has no CNI, ROADMAP item 14.)"""
        pool = k.pool
        ef = pool.eflags
        srv = pool.srv_phase
        ipc = pool.ip_b
        pathc = pool.path_b
        tgt = k.phase_h[idxs].tolist()
        tpl_of = self._emit_tpl.phase_tpl
        n_tpl = len(tpl_of)
        gone = self._gone_id
        slow: list[int] = []
        sel: list[int] = []
        tpls: list[int] = []
        for pos, idx in enumerate(idxs):
            f = ef[idx]
            if not f & EF_RENDER:
                continue  # released row, or no renderable state
            pid = tgt[pos]
            if pid == gone:
                continue
            if f & EF_RGATES or srv[idx] == pid:
                slow.append(idx)
                continue
            t = tpl_of[pid] if 0 <= pid < n_tpl else -1
            if t < 0 or pathc[idx] is None:
                slow.append(idx)
                continue
            sel.append(pos)
            tpls.append(t)
        if not sel:
            return slow
        rows = [idxs[p] for p in sel]
        nipb = self._node_ip_b
        conds = k.cond_h[idxs][sel]
        pids = [tgt[p] for p in sel]
        hosts = [pool.host_b[i] or nipb for i in rows]
        ips = [ipc[i] for i in rows]
        starts = [pool.start_b[i] or b"" for i in rows]
        ctrs = [pool.ctr_b[i] or b"" for i in rows]
        ictrs = [pool.ictr_b[i] or b"" for i in rows]
        paths = [pathc[i] for i in rows]
        scalars = [ef[i] & EF_SCALAR for i in rows]
        # IPs still to allocate: first transitions come in bulk, so the
        # whole batch takes ONE _alloc_lock hold
        need_ip = [(ri, rows[ri]) for ri, ip in enumerate(ips) if ip is None]
        if need_ip:
            meta = pool.meta
            dropped = 0
            with self._alloc_lock:
                missing: list[tuple[int, int, dict]] = []
                for ri, idx in need_ip:
                    m = meta[idx]
                    if m is None:
                        dropped += 1  # the row vanished: pruned below
                        continue
                    ip_s = m.get("podIP")
                    if ip_s:
                        ips[ri] = ipc[idx] = _wire(ip_s)
                    else:
                        missing.append((ri, idx, m))
                if missing:
                    fresh = self.ippool.get_many(len(missing))
                    for (ri, idx, m), ip_s in zip(missing, fresh):
                        m["podIP"] = ip_s
                        ips[ri] = ipc[idx] = ip_s.encode()
            if dropped:
                keep = [i for i, ip in enumerate(ips) if ip]
                conds = conds[keep]
                for col in (rows, tpls, hosts, ips, starts, ctrs, ictrs,
                            paths, pids, scalars):
                    col[:] = [col[i] for i in keep]
        if rows:
            self._submit(
                self._emit_send_pods, rows, np.asarray(tpls, np.int32), conds,
                hosts, ips, starts, ctrs, ictrs, paths, pids, scalars,
                now_rfc3339().encode(),
            )
        return slow

    def _emit_send_pods(
        self, rows, tpls, conds, hosts, ips, starts, ctrs, ictrs, paths,
        pids, scalars, now_b,
    ) -> None:
        """One executor job for a template batch: splice the bodies and
        ship them in one GIL-free C call on a plain pump group, or render
        and then send through a wrapped pump (the process-lane slot
        guard), which so sees every request. Resend, degradation,
        shedding and the per-object fallback are ``_pump_send``'s; each
        sent patch onto a scalar-only status seeds ``fp_expect``."""
        t0 = time.perf_counter()
        codec = self._codec
        kw = dict(
            tpl=self._emit_tpl, tpl_ids=tpls, cond_bits=conds, hosts=hosts,
            ips=ips, starts=starts, ctrs=ctrs, ictrs=ictrs, now=now_b,
            base=self._pump_base_b,
        )
        res = self._pump.emit_spliced(codec, {**kw, "paths": paths})
        fused = res is not None
        if not fused:
            res = codec.emit_pods(**kw)  # render only; the frames carry paths
        bodies, fps, status, slab_bytes = res
        base = self._pump_base_b
        if fused and not (status == 0).any():
            self._pump_note_outcome(len(rows), status)
        else:
            reqs = [("PATCH", base + p + b"/status", body, self._EMIT_CTYPE)
                    for p, body in zip(paths, bodies)]
            if fused:
                # connection deaths: resend those requests' whole frames
                status = self._pump_resend_frames(reqs, status)
            else:
                status = self._pump_send_frames(reqs)
        # seeded after the send returns: the echo waits for the drain's
        # parse window (ms) while this takes µs, and a missed seed only
        # costs the echo one full parse
        meta = self.pods.pool.meta
        phases = self._pod_phases
        fps_l = fps.tolist()
        st_l = status.tolist()
        for i, idx in enumerate(rows):
            if scalars[i] and 200 <= st_l[i] < 300:
                m = meta[idx]
                if m is not None:
                    m["fp_expect"] = fps_l[i]
                    m["expect_phase"] = phases[pids[i]]
        self._inc("emit_native_total", len(rows))
        self._inc("emit_slab_bytes_total", int(slab_bytes))
        self._pump_send_tail(status, rows, "pods", len(rows), t0)

    def _pump_send_frames(self, reqs):
        """Send one batch, resending the whole frames of requests whose
        connection died (status 0): ``pump.cc`` answers a dead
        connection's unsent or unread suffix with 0 and dials again on
        the next call."""
        return self._pump_resend_frames(reqs, self._pump.send(reqs))

    def _pump_resend_frames(self, reqs, status):
        """The resend half, from a status array a first send produced:
        the failed requests go again under ``PUMP_RESEND`` until they have
        answers or its deadline passes."""
        if (status == 0).any():
            backoff = PUMP_RESEND.session()
            while self._running:
                delay = backoff.next_delay()
                if delay is None:
                    break  # the policy's deadline
                backoff.sleep(delay, lambda: not self._running)
                fail = np.nonzero(status == 0)[0]
                status[fail] = self._pump.send([reqs[i] for i in fail.tolist()])
                if not (status == 0).any():
                    break
        self._pump_note_outcome(len(reqs), status)
        return status

    def _pump_note_outcome(self, n, status) -> None:
        """A batch with no answer at all past the resend deadline means
        the target is down: degrade (reason ``pump``); any answer heals."""
        if n and (status == 0).all():
            if self._degradation.set("pump"):
                logger.error("engine degraded: pump egress down past the "
                             "resend deadline (shedding batches)")
        elif (status != 0).any():
            if self._degradation.clear("pump"):
                logger.info("pump egress recovered; shedding stops")

    def _pump_send(self, reqs, idxs, kind) -> None:
        """Executor job: send a whole batch (with the whole-frame resend),
        then ``_pump_send_tail``."""
        t0 = time.perf_counter()
        status = self._pump_send_frames(reqs)
        self._pump_send_tail(status, idxs, kind, len(reqs), t0)

    def _pump_count(self, n: int, t0: float, kind: str) -> None:
        """A pump batch of ``n`` requests sent since ``t0``: the
        ``kwok_pump_send_seconds`` histogram, the request counter and a
        ``pump.send`` span."""
        t1 = time.perf_counter()
        tel = self.telemetry
        tel.pump_hist.observe(t1 - t0)
        tel.inc("pump_requests_total", n)
        tel.span("pump.send", t0, t1, "pump", {"kind": kind, "n": n})

    def _pump_send_tail(self, status, idxs, kind, n, t0) -> None:
        """Counters, spans, shedding and the per-object fallback of every
        pump batch. A batch the down target never answered is shed
        (counted in ``dropped_jobs_total``) instead of turning into
        thousands of doomed per-object jobs; other failed rows take the
        Python path (under ``_safe``: ``PATCH_RETRY`` and Retry-After). A
        404 is a deleted object, a no-op as on that path. An acknowledged
        pod whose ingest was sampled closes its ``pod.ingest_to_patch``
        span here."""
        self._pump_count(n, t0, kind)
        if n and (status == 0).all() and "pump" in self._degradation.reasons:
            self._inc("dropped_jobs_total", n)
            return
        ok = int(((status >= 200) & (status < 300)).sum())
        self._inc("heartbeats_total" if kind == "heartbeat" else "status_patches_total", ok)
        now = time.perf_counter()
        # only pay the per-ack meta lookup when sampling is on (ingest
        # can only have stamped _trace_t0 then)
        want_trace = self._trace_every and kind == "pods"
        for st, idx in zip(status.tolist(), idxs):
            if 200 <= st < 300 or st == 404:
                if want_trace:
                    self._close_ingest_span(idx, now)
                continue
            if kind == "pods":
                key = self.pods.pool.key_of(idx)
                if key is not None:
                    self._submit(self._patch_pod_status, key, idx)
                continue
            name = self.nodes.pool.key_of(idx)
            if name is None:
                continue
            if kind == "nodes":
                self._submit(self._patch_node_status, name, idx)
            else:
                # a freshly rendered heartbeat is always valid
                self._submit(self._heartbeat_node, name, idx, now_rfc3339())

    def _emit_heartbeats_native(self, k, hb_rows, now_str: str) -> None:
        """Every due heartbeat rendered in ONE C call, then one pump batch
        (or, without a pump, one executor job per body)."""
        idxs = np.array([i for _, i in hb_rows], np.int64)
        start = self.start_time.encode()
        bodies = self._codec.render_heartbeats(
            k.cond_h[idxs], self._hb_cond_meta, now_str, [start] * len(hb_rows)
        )
        if self._get_pump() is not None:
            base = self._pump_base_b
            npb = self._node_path_b
            reqs = [
                ("PATCH", base + npb(k.pool, idx, name) + b"/status", body,
                 self._EMIT_CTYPE)
                for (name, idx), body in zip(hb_rows, bodies)
            ]
            self._submit(self._pump_send, reqs, [i for _, i in hb_rows], "heartbeat")
            return
        for (name, _idx), body in zip(hb_rows, bodies):
            self._submit(self._send_heartbeat_bytes, name, body)

    def _send_heartbeat_bytes(self, name: str, body) -> None:
        _t = time.perf_counter()
        self.client.patch_status("nodes", None, name, body)
        self.telemetry.observe_patch_rtt("heartbeat", time.perf_counter() - _t)
        self._inc("heartbeats_total")

    def _emit_deletes_native(self, k, del_rows) -> None:
        """The DeletePod flow as two pump batches: every finalizer strip,
        then every grace-0 delete, on one connection group, so each pod's
        strip is answered before its delete goes out. Deletes share the
        staged path column with the status patches."""
        strips, strip_rows, deletes = [], [], []
        base = self._pump_base_b
        for (ns, name), idx in del_rows:
            m = k.pool.meta[idx]
            pb = k.pool.path_b[idx]
            if pb is None:  # column not staged (KWOK_TPU_NATIVE_EMIT=0)
                pb = k.pool.path_b[idx] = (
                    f"/api/v1/namespaces/{_quote(ns)}/pods/{_quote(name)}"
                ).encode()
            path = base + pb
            if m and m.get("finalizers"):
                strips.append(("PATCH", path, b'{"metadata":{"finalizers":null}}',
                               "application/merge-patch+json"))
                strip_rows.append(((ns, name), idx))
            deletes.append(("DELETE", path, b'{"gracePeriodSeconds":0}',
                            "application/json"))
        self._submit(self._pump_send_deletes, strips, strip_rows, deletes, del_rows)

    def _pump_send_deletes(self, strips, strip_rows, deletes, del_rows) -> None:
        t0 = time.perf_counter()
        retry: set[int] = set()
        if strips:
            strip_status, status = self._pump.send_ordered([strips, deletes])
            # a failed strip leaves the finalizers on: its grace-0 delete
            # became a graceful mark, so the row takes the per-object
            # strip and delete
            for st, (_key, idx) in zip(strip_status.tolist(), strip_rows):
                if not (200 <= st < 300 or st == 404):
                    retry.add(idx)
        else:
            status = self._pump.send(deletes)
        self._pump_count(len(strips) + len(deletes), t0, "delete")
        # 404: gone already; the per-object path counts every issued
        # delete, and so does the batch
        ok = int((((status >= 200) & (status < 300)) | (status == 404)).sum())
        self._inc("deletes_total", ok)
        for st, (key, idx) in zip(status.tolist(), del_rows):
            if idx in retry or not (200 <= st < 300 or st == 404):
                self._submit(self._delete_pod, key, idx)

    def _patch_node_status(self, name: str, idx: int) -> None:
        k = self.nodes
        m = k.pool.meta[idx]
        if not m:
            return
        node = self._lazy_obj(m) or {}
        current = node.get("status") or {}
        rendered = render_node_status(
            node, int(k.cond_h[idx]), self.config.node_ip,
            now_rfc3339(), self.start_time,
        )
        if not node_status_patch_needed(current, rendered):
            return
        _t = time.perf_counter()
        self.client.patch_status("nodes", None, name, {"status": rendered})
        self.telemetry.observe_patch_rtt("node_status", time.perf_counter() - _t)
        self._inc("status_patches_total")

    def _heartbeat_node(self, name: str, idx: int, now_str: str) -> None:
        k = self.nodes
        rendered = render_node_heartbeat(int(k.cond_h[idx]), now_str, self.start_time)
        _t = time.perf_counter()
        self.client.patch_status("nodes", None, name, {"status": rendered})
        self.telemetry.observe_patch_rtt("heartbeat", time.perf_counter() - _t)
        self._inc("heartbeats_total")

    def _render_pod_pre(self, idx: int):
        """Shared render preamble: the row's meta dict + target phase
        name, or None when the row has no object or is Gone."""
        k = self.pods
        m = k.pool.meta[idx]
        if not m or self._pod_obj(m) is None:
            return None
        phase_name = self._pod_phases[int(k.phase_h[idx])]
        if phase_name == "Gone":
            return None
        return m, phase_name

    def _pool_ip(self, m: dict, idx: int) -> "str | None":
        """Pool-backed IP lookup/allocate under _alloc_lock. None when the
        row vanished since the caller looked it up."""
        with self._alloc_lock:  # check+allocate atomic across workers
            ip = m.get("podIP")
            if not ip:
                if self.pods.pool.meta[idx] is not m:
                    return None  # row deleted since this job was queued
                ip = self.ippool.get()
                m["podIP"] = ip
        return ip

    def _render_pod(self, idx: int):
        """The pod's rendered status (IP from the pool), or None."""
        pre = self._render_pod_pre(idx)
        if pre is None:
            return None
        m, phase_name = pre
        ip = self._pool_ip(m, idx)
        if ip is None:
            return None
        return render_pod_status(
            self._pod_obj(m) or {}, phase_name, int(self.pods.cond_h[idx]),
            self.config.node_ip, ip,
        )

    def _close_ingest_span(self, idx: int, now: float) -> None:
        """Close a sampled pod's ``pod.ingest_to_patch`` span at its
        patch acknowledgement; its (key, rv) args tie it to the
        apiserver's flight record of the same object."""
        m = self.pods.pool.meta[idx]
        t0e = m.pop("_trace_t0", None) if m else None
        if t0e is not None:
            key = self.pods.pool.key_of(idx)
            self.telemetry.span(
                "pod.ingest_to_patch", t0e, now, "event",
                {"key": f"{key[0]}/{key[1]}" if key else "",
                 "rv": m.get("rv")},
            )

    def _patch_pod_status(self, key, idx: int) -> None:
        k = self.pods
        m = k.pool.meta[idx]
        if not m:
            return
        # take a sampled ingest stamp up front: a suppressed patch must
        # not leave it for a later, unrelated patch to close
        t0e = m.pop("_trace_t0", None) if self._trace_every else None
        rendered = self._render_pod(idx)
        if rendered is None:
            return
        current = (self._pod_obj(m) or {}).get("status") or {}
        if not pod_status_patch_needed(current, rendered):
            return
        ns, name = key
        _t = time.perf_counter()
        self.client.patch_status("pods", ns, name, {"status": rendered})
        _t1 = time.perf_counter()
        self.telemetry.observe_patch_rtt("pod_status", _t1 - _t)
        if t0e is not None:  # the sampled ingest->patch span
            self.telemetry.span(
                "pod.ingest_to_patch", t0e, _t1, "event",
                {"key": f"{ns}/{name}", "rv": m.get("rv")},
            )
        self._inc("status_patches_total")

    def _delete_pod(self, key, idx: int) -> None:
        """Finalizer strip + grace-0 delete (DeletePod,
        pod_controller.go:155-183)."""
        ns, name = key
        m = self.pods.pool.meta[idx]
        if m and m.get("finalizers"):
            self.client.patch_meta("pods", ns, name, {"metadata": {"finalizers": None}})
        _t = time.perf_counter()
        self.client.delete("pods", ns, name, grace_seconds=0)
        self.telemetry.observe_patch_rtt("pod_delete", time.perf_counter() - _t)
        self._inc("deletes_total")
