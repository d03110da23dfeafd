"""Per-lane metric handles for the threaded drain+emit lanes (the lane
part of ``kwok_tpu.telemetry.engine_metrics``), on the engine's labeled
registry:

- ``kwok_lane_stage_seconds{shard,stage}``: wall seconds a lane's drain
  worker spent applying routed events (``stage="drain"``) and its emit
  worker spent on wire slices (``stage="emit"``), as histograms;
- ``kwok_lane_queue_depth{shard}``: routed events waiting in the lane's
  ingest queue.

``kwok_degraded{reason}`` lives with its ledger in
``resilience/policy.py``. Every other engine counter stays on the flat
``kwok_`` surface of ``ClusterEngine.metrics``.
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

    def observe_stage(self, stage: str, seconds: float) -> None:
        self.stage_hists[stage].observe(seconds)

    def set_queue_depth(self, depth: int) -> None:
        self._depth.set(depth)

    @property
    def stage_sums(self) -> dict:
        """Per-lane stage second totals."""
        return {s: h.sum for s, h in self.stage_hists.items()}
