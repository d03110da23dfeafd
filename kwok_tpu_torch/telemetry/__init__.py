"""kwok_tpu_torch.telemetry: the engine's labeled metrics, span tracing,
the apiserver observability surface and the cross-tier timeline (the
port's copies of ``kwok_tpu.telemetry``).

- ``registry``: a lock-light Prometheus-style registry (counters, gauges,
  fixed-bucket histograms with labels) rendering the text exposition
  format, with the snapshot and merge surface that carries a lane
  process's metrics to the parent.
- ``trace``: the bounded span ring (``Tracer``) exported as Chrome
  trace-event JSON (``/debug/trace``, ``--trace-dump``), the merge of
  several rings (a federation's) and the document check.
- ``engine_metrics``: ``EngineTelemetry``, the engine's typed handles
  over both, and the flat view ``ClusterEngine.metrics`` reads.
- ``lanes``: the per-lane families of the threaded lanes
  (``LaneTelemetry``) and their merge over lane processes.
- ``apiserver_metrics``: the mock apiservers' ``/metrics`` families,
  per-phase request timing and the flight recorder.
- ``timeline``: ``check_flight`` and ``merge_timeline`` of an engine
  trace with a ``/debug/flight`` dump and lane dumps, the attribution
  table, and its CLI (``python -m kwok_tpu_torch.telemetry.timeline``).
- ``errors``: the process registry of swallowed-exception, worker-crash
  and wire-reject counters that ``/metrics`` appends.
"""
