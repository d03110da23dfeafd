"""Named metric handles for the engine + the flat-dict view (the port's
copy of ``kwok_tpu.telemetry.engine_metrics``).

``EngineTelemetry`` owns one ``MetricsRegistry`` slice (optionally shared
across federation members, each under its own ``shard`` label) and one
``Tracer``. The engine writes through typed handles (counter children,
histogram children): no name lookup and no engine-wide lock on the hot
path. ``legacy_dict()`` is ``ClusterEngine.metrics``: flat names and plain
numbers, ``*_seconds_sum`` from the histogram sums. The port adds three
kinds of key the reference's flat view lacks, none of them rendered on
``/metrics``: ``client_throttle_seconds_total``, and the checkpoint and
restore summaries set through ``note()`` (``checkpoint_writes_total``,
``checkpoint_write_seconds_last``, ``checkpoint_bytes_last``,
``checkpoint_snapshot_seconds_last``, ``restore_refined_rows``,
``restore_stale_rows``; absent until first set).

The per-lane families (``LaneTelemetry``, ``kwok_lane_*``) and their merge
over lane processes live in ``telemetry/lanes.py``.
"""

from __future__ import annotations

from kwok_tpu_torch.telemetry.registry import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
)
from kwok_tpu_torch.telemetry.trace import Tracer

# Tick stages: every histogram child is pre-created so exposition is stable
# from the first scrape and observe never takes the family lock.
STAGES = ("flush", "kernel", "emit", "drain", "parse")

_HELP = {
    "kwok_transitions_total": "Lifecycle phase transitions applied by the tick kernel",
    "kwok_status_patches_total": "Status patches sent to the apiserver",
    "kwok_heartbeats_total": "Node heartbeat patches sent",
    "kwok_deletes_total": "Pod deletes issued",
    "kwok_epoch_rebases_total": "f32 time-epoch rebases performed",
    "kwok_watch_events_total": "Watch events ingested",
    "kwok_watch_bookmarks_total": "BOOKMARK events consumed (rv advanced, no ingest)",
    "kwok_watch_relists_total": "Full re-lists performed by the watch loops",
    "kwok_patch_errors_total": "Patch/delete jobs that raised",
    "kwok_dropped_jobs_total": "Patch jobs rejected during shutdown",
    "kwok_ticks_total": "Engine ticks executed",
    "kwok_pump_requests_total": "Requests shipped through the native pump",
    "kwok_emit_native_total": "Pod status patches rendered through the "
    "AOT-template native emit path (compiled byte-template splice; the "
    "slow path's per-object renders do not count here)",
    "kwok_emit_slab_bytes_total": "Patch-body bytes spliced into native "
    "emit slabs (divide by kwok_emit_native_total for mean body size)",
    "kwok_tick_seconds": "Wall seconds per engine tick (dispatch + consume halves)",
    "kwok_tick_stage_seconds": "Per-tick wall seconds by stage "
    "(flush=staged-write flush, kernel=device wire wait, emit=patch-job "
    "fan-out, drain=ingest drain, parse=batched C++ line parse)",
    "kwok_pump_send_seconds": "Wall seconds per native pump batch send",
    "kwok_patch_rtt_seconds": "Apiserver round-trip seconds per patch/delete, by path",
    "kwok_watch_lag_seconds": "Enqueue-to-processing delay of drained watch events",
    "kwok_tick_seconds_last": "Duration of the most recent tick",
    "kwok_watch_lag_seconds_last": "Slowest event lag observed in the last drain window",
    "kwok_ingest_queue_depth": "Watch events waiting to be ingested",
    "kwok_tick_inflight": "Device ticks dispatched but not yet consumed",
    "kwok_nodes_managed": "Nodes currently managed",
    "kwok_pods_managed": "Pods currently tracked",
    "kwok_build_info": "Build/version info (value is always 1)",
    "kwok_trace_spans_total": "Spans recorded into the trace ring",
    "kwok_lane_stage_seconds": "Per-lane wall seconds by stage for the "
    "threaded drain+emit lanes (shard=lane index; drain=ingest apply, "
    "emit=patch fan-out; the router's batched parse stays in the "
    "unlabeled kwok_tick_stage_seconds{stage=parse})",
    "kwok_lane_queue_depth": "Routed events waiting in a lane's ingest "
    "queue (shard=lane index)",
    "kwok_route_batch_seconds": "Wall seconds per native pre-partitioned "
    "route handoff (the router's per-batch lane enqueue; the C parse that "
    "computed the partition stays in kwok_tick_stage_seconds{stage=parse})",
    "kwok_route_partition_events_total": "Events routed to each lane via "
    "the native pre-partitioned parse (shard=lane index; per-event Python "
    "routing does not count here — compare with kwok_watch_events_total "
    "to see the fast-path share)",
    "kwok_rv_rewinds_total": "Store-restore signatures detected: an "
    "object re-listed BELOW its last-ingested resourceVersion (POST "
    "/restore or a blackout recovery from an old snapshot — an object's "
    "own rv can never legitimately decrease); each one resyncs every "
    "watch stream",
    "kwok_restart_recovery_seconds": "Seconds from engine start to the "
    "startup catch-up gate closing (first full re-list of both kinds "
    "ingested + checkpoint reconcile applied); /readyz answers 503 with "
    "reason startup_resync until then",
    "kwok_checkpoint_write_seconds": "Wall seconds serializing + "
    "atomically renaming one crash-durability checkpoint "
    "(resilience/checkpoint.py; only moves with --checkpoint-dir set)",
    "kwok_checkpoint_rows": "Rows in the most recent checkpoint by "
    "state (armed = a Stage delay in flight whose residue the next "
    "restart resumes; idle = no pending rule timer)",
    "kwok_client_throttle_seconds_total": "Cumulative seconds this engine "
    "slept honoring apiserver 429 Retry-After hints (watch/list "
    "reconnects and patch-executor retries); a nonzero rate means the "
    "apiserver's max-inflight bands are saturated and the engine is "
    "backing off instead of hammering",
    "kwok_watch_integrity_resyncs_total": "Full list+RESYNC passes "
    "scheduled because corrupt wire input (an unparseable watch line) "
    "cast doubt on stream completeness; bounded to one per 5s so a "
    "garbling storm cannot LIST-storm the apiserver",
}

# legacy counter name -> (family name, has kind label)
_COUNTERS = {
    "transitions_total": ("kwok_transitions_total", True),
    "status_patches_total": ("kwok_status_patches_total", False),
    "heartbeats_total": ("kwok_heartbeats_total", False),
    "deletes_total": ("kwok_deletes_total", False),
    "epoch_rebases_total": ("kwok_epoch_rebases_total", False),
    "watch_events_total": ("kwok_watch_events_total", True),
    "watch_bookmarks_total": ("kwok_watch_bookmarks_total", False),
    "watch_relists_total": ("kwok_watch_relists_total", False),
    "patch_errors_total": ("kwok_patch_errors_total", False),
    "dropped_jobs_total": ("kwok_dropped_jobs_total", False),
    "ticks_total": ("kwok_ticks_total", False),
    "pump_requests_total": ("kwok_pump_requests_total", False),
    "emit_native_total": ("kwok_emit_native_total", False),
    "emit_slab_bytes_total": ("kwok_emit_slab_bytes_total", False),
    "rv_rewinds_total": ("kwok_rv_rewinds_total", False),
    "watch_integrity_resyncs_total": (
        "kwok_watch_integrity_resyncs_total", False,
    ),
}

_GAUGES = {
    "tick_seconds_last": "kwok_tick_seconds_last",
    "watch_lag_seconds": "kwok_watch_lag_seconds_last",
    "ingest_queue_depth": "kwok_ingest_queue_depth",
    "tick_inflight": "kwok_tick_inflight",
    "nodes_managed": "kwok_nodes_managed",
    "pods_managed": "kwok_pods_managed",
    "restart_recovery_seconds": "kwok_restart_recovery_seconds",
}

_KINDS = ("nodes", "pods")


def register_build_info(registry: MetricsRegistry) -> None:
    """kwok_build_info{version=...} 1 — registered once per registry
    (idempotent: federation members share one)."""
    import platform

    from kwok_tpu_torch import __version__

    fam = registry.gauge(
        "kwok_build_info", _HELP["kwok_build_info"], ("version", "python")
    )
    fam.labels(version=__version__, python=platform.python_version()).set(1)


class EngineTelemetry:
    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        shard: str | None = None,
        tracer: Tracer | None = None,
        trace_capacity: int = 65536,
    ):
        self.registry = registry or MetricsRegistry()
        self.shard = shard
        self.tracer = tracer if tracer is not None else Tracer(trace_capacity)
        r = self.registry
        base = ("shard",) if shard is not None else ()
        sl = {"shard": shard} if shard is not None else {}

        def child(fam):
            return fam.labels(**sl) if shard is not None else fam.child

        self._counters = {}
        self._kind_counters = {}
        for legacy, (name, by_kind) in _COUNTERS.items():
            if by_kind:
                fam = r.counter(name, _HELP[name], base + ("kind",))
                self._kind_counters[legacy] = {
                    k: fam.labels(**sl, kind=k) for k in _KINDS
                }
            else:
                self._counters[legacy] = child(
                    r.counter(name, _HELP[name], base)
                )
        self._gauges = {
            legacy: child(r.gauge(name, _HELP[name], base))
            for legacy, name in _GAUGES.items()
        }
        self.tick_hist = child(
            r.histogram("kwok_tick_seconds", _HELP["kwok_tick_seconds"], base)
        )
        stage_fam = r.histogram(
            "kwok_tick_stage_seconds",
            _HELP["kwok_tick_stage_seconds"],
            base + ("stage",),
        )
        self.stage_hists = {
            s: stage_fam.labels(**sl, stage=s) for s in STAGES
        }
        self.pump_hist = child(
            r.histogram(
                "kwok_pump_send_seconds", _HELP["kwok_pump_send_seconds"], base
            )
        )
        self.route_batch_hist = child(
            r.histogram(
                "kwok_route_batch_seconds",
                _HELP["kwok_route_batch_seconds"],
                base,
            )
        )
        # crash-durability checkpoint surface (resilience/checkpoint.py):
        # pre-created so exposition is stable whether or not a
        # --checkpoint-dir is configured
        self.ckpt_write_hist = child(
            r.histogram(
                "kwok_checkpoint_write_seconds",
                _HELP["kwok_checkpoint_write_seconds"],
                base,
            )
        )
        ckpt_rows_fam = r.gauge(
            "kwok_checkpoint_rows", _HELP["kwok_checkpoint_rows"],
            base + ("state",),
        )
        self.ckpt_rows = {
            s: ckpt_rows_fam.labels(**sl, state=s)
            for s in ("armed", "idle")
        }
        self._rtt_fam = r.histogram(
            "kwok_patch_rtt_seconds",
            _HELP["kwok_patch_rtt_seconds"],
            base + ("path",),
        )
        self._rtt_labels = sl
        self._rtt_children: dict[str, object] = {}
        self.lag_hist = child(
            r.histogram(
                "kwok_watch_lag_seconds",
                _HELP["kwok_watch_lag_seconds"],
                base,
                buckets=DEFAULT_LATENCY_BUCKETS,
            )
        )
        self._spans = child(
            r.counter(
                "kwok_trace_spans_total", _HELP["kwok_trace_spans_total"], base
            )
        )
        # client-side overload accounting: seconds slept honoring 429
        # Retry-After hints (a float counter; monotonic)
        self._throttle = child(
            r.counter(
                "kwok_client_throttle_seconds_total",
                _HELP["kwok_client_throttle_seconds_total"],
                base,
            )
        )
        # flat-view-only values (note()); plain dict stores, one writer
        # per key
        self._notes: dict = {}
        register_build_info(r)

    # ------------------------------------------------------------- writes

    def inc(self, name: str, v=1) -> None:
        self._counters[name].inc(v)

    def inc_kind(self, name: str, kind: str, v=1) -> None:
        self._kind_counters[name][kind].inc(v)

    def set_gauge(self, name: str, v) -> None:
        self._gauges[name].set(v)

    def observe_tick(self, seconds: float) -> None:
        self.tick_hist.observe(seconds)
        self._gauges["tick_seconds_last"].set(seconds)

    def observe_stage(self, stage: str, seconds: float) -> None:
        self.stage_hists[stage].observe(seconds)

    def observe_route_batch(self, seconds: float) -> None:
        self.route_batch_hist.observe(seconds)

    def observe_watch_lag(self, seconds: float) -> None:
        self.lag_hist.observe(seconds)
        self._gauges["watch_lag_seconds"].set(seconds)

    def observe_patch_rtt(self, path: str, seconds: float) -> None:
        c = self._rtt_children.get(path)
        if c is None:
            c = self._rtt_fam.labels(**self._rtt_labels, path=path)
            self._rtt_children[path] = c
        c.observe(seconds)

    def note(self, name: str, v) -> None:
        """A flat-view-only value (see the module docstring)."""
        self._notes[name] = v

    def add_throttle(self, seconds: float) -> None:
        self._throttle.inc(seconds)

    @property
    def client_throttle_seconds(self) -> float:
        return self._throttle.value

    def span(self, name, t0, t1, lane="drain", args=None) -> None:
        self.tracer.span(name, t0, t1, lane, args)
        self._spans.inc()

    def lane(self, lane_id: str) -> "LaneTelemetry":
        """A per-lane slice for the sharded drain+emit pipeline: lane
        stage observations land BOTH in the lane-labeled
        ``kwok_lane_stage_seconds{shard=...}`` family and in the engine's
        aggregate ``kwok_tick_stage_seconds`` (so the legacy flat view and
        the cost model keep seeing whole-engine totals)."""
        from kwok_tpu_torch.telemetry.lanes import LaneTelemetry

        return LaneTelemetry(self, lane_id)

    # ------------------------------------------------------------- reads

    @property
    def ticks_total(self) -> int:
        return self._counters["ticks_total"].value

    @property
    def dropped_jobs_total(self) -> int:
        return self._counters["dropped_jobs_total"].value

    def legacy_dict(self) -> dict:
        """The pre-telemetry ``engine.metrics`` surface: flat names, plain
        numbers. ``*_seconds_sum`` keys come from histogram sums, so the
        old cost-model arithmetic keeps working unchanged."""
        d = {name: c.value for name, c in self._counters.items()}
        for name, by_kind in self._kind_counters.items():
            d[name] = sum(c.value for c in by_kind.values())
        for name, g in self._gauges.items():
            d[name] = g.value
        d["tick_seconds_sum"] = self.tick_hist.sum
        d["tick_flush_seconds_sum"] = self.stage_hists["flush"].sum
        d["tick_kernel_seconds_sum"] = self.stage_hists["kernel"].sum
        d["tick_emit_seconds_sum"] = self.stage_hists["emit"].sum
        d["ingest_drain_seconds_sum"] = self.stage_hists["drain"].sum
        d["ingest_parse_seconds_sum"] = self.stage_hists["parse"].sum
        d["pump_send_seconds_sum"] = self.pump_hist.sum
        d["client_throttle_seconds_total"] = self._throttle.value
        d.update(self._notes)
        return d
