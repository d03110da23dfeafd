"""kwok_tpu_torch.telemetry: the process-wide error counters.

- ``registry``: a lock-light Prometheus-style registry (counters, gauges,
  fixed-bucket histograms with labels) rendering the text exposition
  format.
- ``errors``: the process registry of swallowed-exception, worker-crash
  and wire-reject counters that ``/metrics`` appends.

The engine's own counters are a plain dict (``ClusterEngine.metrics``);
the labeled engine registry and the span tracer are later slices.
"""
