"""Per-lane metric handles for the threaded drain+emit lanes (the lane
part of ``kwok_tpu.telemetry.engine_metrics``), on the engine's labeled
registry:

- ``kwok_lane_stage_seconds{shard,stage}``: wall seconds a lane's drain
  worker spent applying routed events (``stage="drain"``) and its emit
  worker spent on wire slices (``stage="emit"``), as histograms;
- ``kwok_lane_queue_depth{shard}``: routed events waiting in the lane's
  ingest queue;
- ``kwok_route_partition_events_total{shard}``: events the router handed
  the lane through the native pre-partitioned parse (``RECB`` runs);
  the process lanes' router counts the same family per lane.

The engine-wide ``kwok_tick_stage_seconds{stage}`` (``stage="parse"``:
the batched native parse of raw watch lines, on whichever thread drains
them) and ``kwok_route_batch_seconds`` (the router's per-batch handoff)
take their help texts from here too, as does ``kwok_pump_send_seconds``
(the wall seconds of each native pump batch send).

``kwok_degraded{reason}`` lives with its ledger in
``resilience/policy.py``. Every other engine counter stays on the flat
``kwok_`` surface of ``ClusterEngine.metrics``.

Under process lanes (``engine/proclanes.py``) each lane child is a
single-lane engine that times its drain and emit stages into
``kwok_tick_stage_seconds{stage}``; ``merge_proc_lane_metrics`` folds the
children's registry snapshots into one scratch registry per scrape and
label-splits those stages into ``kwok_lane_stage_seconds{shard,stage}``,
so the exposition has the threaded lanes' families.
"""

from __future__ import annotations

# the stages a lane runs (flush and the kernel stay on the coordinator)
LANE_STAGES = ("drain", "emit")

_HELP = {
    "kwok_lane_stage_seconds": "Per-lane wall seconds by stage for the "
    "threaded drain+emit lanes (shard=lane index; drain=ingest apply, "
    "emit=patch fan-out)",
    "kwok_lane_queue_depth": "Routed events waiting in a lane's ingest "
    "queue (shard=lane index)",
    "kwok_tick_stage_seconds": "Wall seconds by stage: parse=the batched "
    "native parse of raw watch lines (the router's under lanes); in a "
    "process lane's single-lane engine also drain=ingest of routed events "
    "and emit=consume of a tick's wire",
    "kwok_route_batch_seconds": "Wall seconds per native pre-partitioned "
    "route handoff (the router's per-batch lane enqueue; the parse that "
    "computed the partition is kwok_tick_stage_seconds{stage=parse})",
    "kwok_route_partition_events_total": "Events routed to each lane via "
    "the native pre-partitioned parse (shard=lane index)",
    "kwok_pump_send_seconds": "Wall seconds per native pump batch send",
}


class LaneTelemetry:
    """One lane's handles on the engine's ``MetricsRegistry``."""

    def __init__(self, registry, lane_id) -> None:
        shard = str(lane_id)
        fam = registry.histogram(
            "kwok_lane_stage_seconds", _HELP["kwok_lane_stage_seconds"],
            ("shard", "stage"),
        )
        self.stage_hists = {
            s: fam.labels(shard=shard, stage=s) for s in LANE_STAGES
        }
        self._depth = registry.gauge(
            "kwok_lane_queue_depth", _HELP["kwok_lane_queue_depth"],
            ("shard",),
        ).labels(shard=shard)
        self._routed = registry.counter(
            "kwok_route_partition_events_total",
            _HELP["kwok_route_partition_events_total"], ("shard",),
        ).labels(shard=shard)

    def observe_stage(self, stage: str, seconds: float) -> None:
        self.stage_hists[stage].observe(seconds)

    def set_queue_depth(self, depth: int) -> None:
        self._depth.set(depth)

    def inc_routed(self, n: int) -> None:
        self._routed.inc(n)

    @property
    def stage_sums(self) -> dict:
        """Per-lane stage second totals."""
        return {s: h.sum for s, h in self.stage_hists.items()}


def _merge_lane_snapshot(reg, shard: int, snap: dict) -> None:
    from kwok_tpu_torch.telemetry.registry import family_from_doc, merge_child

    lane_fam = reg.histogram(
        "kwok_lane_stage_seconds", _HELP["kwok_lane_stage_seconds"],
        ("shard", "stage"),
    )
    for name, doc in sorted(snap.items()):
        if name == "kwok_tick_stage_seconds":
            # aggregate into the whole-engine stage family AND label-split
            # drain/emit under the lane's shard (the LaneTelemetry shape)
            fam = family_from_doc(reg, name, doc)
            for values, v in doc.get("children", ()):
                merge_child(fam, values, v)
                stage = str(values[-1]) if values else ""
                if stage in LANE_STAGES:
                    merge_child(lane_fam, (str(shard), stage), v)
            continue
        if doc.get("type") == "gauge":
            # gauges are the parent's (kwok_degraded, the queue depths it
            # reads from the StatusBank); a lane's copy would double them
            continue
        fam = family_from_doc(reg, name, doc)
        for values, v in doc.get("children", ()):
            merge_child(fam, values, v)


def merge_proc_lane_metrics(parent_snap: dict, lane_snaps: dict,
                            retired_snaps: dict, n: int,
                            queue_depths: "dict | None" = None):
    """One scratch registry for a process-lane scrape: the parent's own
    snapshot, every live lane's snapshot (``{shard: snap}``) and each
    lane's retired accumulator (earlier incarnations' final snapshots,
    so sums stay monotonic across respawns); counters and histograms
    add up, lane gauges are left out. ``queue_depths`` feeds
    ``kwok_lane_queue_depth`` from the StatusBank. The lane families
    exist for every shard from the first scrape, before any child has
    published."""
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
            _merge_lane_snapshot(reg, shard, snap)
    for shard, snap in sorted(lane_snaps.items()):
        if snap:
            _merge_lane_snapshot(reg, shard, snap)
    return reg
