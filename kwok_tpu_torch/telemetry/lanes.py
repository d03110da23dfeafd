"""Per-lane metric handles for the threaded drain+emit lanes, and their
merge over lane processes (the lane half of
``kwok_tpu.telemetry.engine_metrics``, on the engine's ``EngineTelemetry``):

- ``kwok_lane_stage_seconds{shard,stage}``: wall seconds a lane's drain
  worker spent applying routed events (``stage="drain"``) and its emit
  worker spent on wire slices (``stage="emit"``), as histograms; each
  observation also lands in the engine's ``kwok_tick_stage_seconds``;
- ``kwok_lane_queue_depth{shard}``: routed events waiting in the lane's
  ingest queue;
- ``kwok_route_partition_events_total{shard}``: events the router handed
  the lane through the native pre-partitioned parse.

Under process lanes (``engine/proclanes.py``) each lane child is a
single-lane engine that times its drain and emit stages into
``kwok_tick_stage_seconds{stage}``; ``merge_proc_lane_metrics`` folds the
children's registry snapshots into one scratch registry per scrape and
label-splits those stages into ``kwok_lane_stage_seconds{shard,stage}``,
so the exposition has the threaded lanes' families.
"""

from __future__ import annotations

from kwok_tpu_torch.telemetry.engine_metrics import _HELP, EngineTelemetry

# Lane stages: the subset of STAGES a ShardLane runs (flush/kernel stay on
# the coordinator tick thread, parse on the router; both remain unlabeled).
LANE_STAGES = ("drain", "emit")


class LaneTelemetry:
    """Per-lane metric handles for the sharded host pipeline.

    One instance per ShardLane, sharing the engine's registry. The lane
    label intentionally reuses the ``shard`` label name the federation
    surface established, under a lane-specific family — a federated member
    never runs lanes (members are forced single-lane), so the two uses of
    the label cannot collide on one registry.
    """

    def __init__(self, parent: EngineTelemetry, lane_id) -> None:
        self.parent = parent
        self.lane_id = str(lane_id)
        r = parent.registry
        fam = r.histogram(
            "kwok_lane_stage_seconds",
            _HELP["kwok_lane_stage_seconds"],
            ("shard", "stage"),
        )
        self.stage_hists = {
            s: fam.labels(shard=self.lane_id, stage=s) for s in LANE_STAGES
        }
        self._depth = r.gauge(
            "kwok_lane_queue_depth",
            _HELP["kwok_lane_queue_depth"],
            ("shard",),
        ).labels(shard=self.lane_id)
        self._routed = r.counter(
            "kwok_route_partition_events_total",
            _HELP["kwok_route_partition_events_total"],
            ("shard",),
        ).labels(shard=self.lane_id)

    def observe_stage(self, stage: str, seconds: float) -> None:
        self.stage_hists[stage].observe(seconds)
        self.parent.observe_stage(stage, seconds)

    def inc_routed(self, n: int) -> None:
        self._routed.inc(n)

    def set_queue_depth(self, depth: int) -> None:
        self._depth.set(depth)

    @property
    def stage_sums(self) -> dict:
        """Per-lane stage second totals (lane-utilization reporting)."""
        return {s: h.sum for s, h in self.stage_hists.items()}


# --------------------------------------------------- proc-lane merge policy
# (each lane process is a whole single-lane engine whose registry snapshot
# crosses the process boundary in a MetricsBank slab. The parent folds
# every snapshot into ONE scratch registry per scrape so the process-lane
# exposition has the threaded lanes' families and labels: child stage
# histograms label-split into kwok_lane_stage_seconds{shard=} AND
# aggregate into the unlabeled stage family, as LaneTelemetry.observe_stage
# does in process, while counters and histograms sum and gauges follow the
# explicit policy below.)

# gauges where the fleet-wide value is the sum of the lanes' values
PROC_MERGE_SUM_GAUGES = frozenset({
    "kwok_tick_inflight",
    "kwok_checkpoint_rows",
})
# gauges where the fleet-wide value is the worst lane's value
PROC_MERGE_MAX_GAUGES = frozenset({
    "kwok_tick_seconds_last",
    "kwok_watch_lag_seconds_last",
    "kwok_restart_recovery_seconds",
})
# gauges the parent computes itself (StatusBank scrape / build identity):
# a lane's copy is dropped, never double-counted
PROC_MERGE_PARENT_GAUGES = frozenset({
    "kwok_build_info",
    "kwok_nodes_managed",
    "kwok_pods_managed",
    "kwok_ingest_queue_depth",
    "kwok_shm_arena_bytes",
})


def _merge_lane_snapshot(reg, shard: int, snap: dict,
                         include_gauges: bool) -> None:
    from kwok_tpu_torch.telemetry.registry import family_from_doc, merge_child

    lane_fam = reg.histogram(
        "kwok_lane_stage_seconds", _HELP["kwok_lane_stage_seconds"],
        ("shard", "stage"),
    )
    for name, doc in sorted(snap.items()):
        t = doc.get("type")
        if name == "kwok_tick_stage_seconds":
            # aggregate into the whole-engine stage family AND label-split
            # drain/emit under the lane's shard — the LaneTelemetry shape
            fam = family_from_doc(reg, name, doc)
            for values, v in doc.get("children", ()):
                merge_child(fam, values, v)
                stage = str(values[-1]) if values else ""
                if stage in LANE_STAGES:
                    merge_child(lane_fam, (str(shard), stage), v)
            continue
        if name in PROC_MERGE_PARENT_GAUGES:
            continue
        if name == "kwok_ingest_queue_depth":
            continue  # label-split from the StatusBank, not the snapshot
        if t == "gauge":
            if not include_gauges:
                continue  # a retired lane's gauges are stale by definition
            if name in PROC_MERGE_SUM_GAUGES:
                mode = "sum"
            elif name in PROC_MERGE_MAX_GAUGES:
                mode = "max"
            else:
                continue  # unlisted gauges stay parent-authoritative
            fam = family_from_doc(reg, name, doc)
            for values, v in doc.get("children", ()):
                merge_child(fam, values, v, gauge=mode)
            continue
        fam = family_from_doc(reg, name, doc)
        for values, v in doc.get("children", ()):
            merge_child(fam, values, v)


def merge_proc_lane_metrics(parent_snap: dict, lane_snaps: dict,
                            retired_snaps: dict, n: int,
                            queue_depths: "dict | None" = None):
    """One scratch registry for a proc-lane scrape: the parent's own
    snapshot, every live lane's engine snapshot (``{shard: snap}``), and
    each lane's retired accumulator (previous incarnations' final
    snapshots — counters/histograms only, so aggregates stay monotonic
    across respawns). ``queue_depths`` feeds kwok_lane_queue_depth from
    the StatusBank (fresher than any 1s-cadence snapshot). Lane families
    are pre-created for every shard so the exposition is stable from the
    first scrape, before any child has published."""
    from kwok_tpu_torch.telemetry.registry import registry_from_snapshot

    reg = registry_from_snapshot(parent_snap)
    lane_fam = reg.histogram(
        "kwok_lane_stage_seconds", _HELP["kwok_lane_stage_seconds"],
        ("shard", "stage"),
    )
    depth_fam = reg.gauge(
        "kwok_lane_queue_depth", _HELP["kwok_lane_queue_depth"], ("shard",)
    )
    for i in range(n):
        for s in LANE_STAGES:
            lane_fam.labels(shard=str(i), stage=s)
        depth_fam.labels(shard=str(i)).set(
            int((queue_depths or {}).get(i, 0))
        )
    for shard, snap in sorted(retired_snaps.items()):
        if snap:
            _merge_lane_snapshot(reg, shard, snap, include_gauges=False)
    for shard, snap in sorted(lane_snaps.items()):
        if snap:
            _merge_lane_snapshot(reg, shard, snap, include_gauges=True)
    return reg
