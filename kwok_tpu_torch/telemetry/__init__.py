"""kwok_tpu_torch.telemetry: the error counters and the lane metrics.

- ``registry``: a lock-light Prometheus-style registry (counters, gauges,
  fixed-bucket histograms with labels) rendering the text exposition
  format, with the snapshot and merge surface that carries a lane
  process's metrics to the parent.
- ``errors``: the process registry of swallowed-exception, worker-crash
  and wire-reject counters that ``/metrics`` appends.

- ``lanes``: the per-lane families of the threaded lanes
  (``kwok_lane_stage_seconds``, ``kwok_lane_queue_depth``) on the
  engine's registry, and their merge over lane processes.

The engine's other counters are a plain dict (``ClusterEngine.metrics``);
the rest of the labeled engine registry and the span tracer are later
slices.
"""
