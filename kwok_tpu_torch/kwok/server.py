"""HTTP server: /healthz /readyz /livez + Prometheus /metrics + /debug/trace.

Mirrors Serve in pkg/kwok/cmd/root.go:173-202, with real engine telemetry
instead of only Go runtime collectors (the counters that matter are
transitions/sec, patches/sec, tick latency, watch lag).

The port's engine keeps a plain counters dict (``ClusterEngine.metrics``),
so ``/metrics`` renders the reference's flat ``kwok_``-prefixed surface,
then the engine's labeled families (``ClusterEngine.metrics_text``: the
lane stage seconds and queue depths, ``kwok_degraded``, and under process
lanes ``kwok_lane_proc_restarts_total``), with the process-wide error
counters (``telemetry/errors.py``) and the process CPU collector
appended. Under process lanes the counters and families are summed over
the lane processes. A federation (``engine/federation.py``) renders each
member's counters under ``shard="<i>"``, then its shared registry
(``kwok_group_dispatches_total{group}``, the ``kwok_fed_*`` aggregates);
``/readyz`` is 503 until every member's first re-list is in and while
any member is degraded. ``/debug/trace`` answers 404, as the
reference does for an engine without a span tracer.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_METRIC_HELP = {
    "transitions_total": "Lifecycle phase transitions applied by the tick kernel",
    "status_patches_total": "Status patches sent to the apiserver",
    "heartbeats_total": "Node heartbeat patches sent",
    "deletes_total": "Pod deletes issued",
    "watch_events_total": "Watch events ingested",
    "watch_bookmarks_total": "BOOKMARK events consumed (rv advanced, no ingest)",
    "watch_relists_total": "Full re-lists performed by the watch loops",
    "rv_rewinds_total": "Re-lists that found an object below its ingested "
    "resourceVersion (a store restore); each re-lists every stream",
    "client_throttle_seconds_total": "Cumulative seconds this engine slept "
    "honoring apiserver 429 Retry-After hints (watch/list reconnects and "
    "patch-executor retries)",
    "ingest_drain_seconds_sum": "Tick-thread seconds applying ingested events",
    "ingest_parse_seconds_sum": "Seconds in the batched C++ line parser (subset of drain)",
    "pump_send_seconds_sum": "Executor seconds inside native pump batches",
    "pump_requests_total": "Requests shipped through the native pump",
    "patch_errors_total": "Patch/delete jobs that raised",
    "ticks_total": "Engine ticks executed",
    "tick_seconds_sum": "Total seconds spent in tick_once",
    "tick_seconds_last": "Duration of the most recent tick",
    "watch_lag_seconds": "Enqueue-to-processing delay of the slowest event in the last tick",
    "ingest_queue_depth": "Watch events waiting to be ingested",
    "nodes_managed": "Nodes currently managed",
    "pods_managed": "Pods currently tracked",
}


def _errors_block() -> str:
    """Error-accounting families (swallowed-exception and worker-crash
    counters, telemetry/errors.py): process-global state no engine
    owns. Labeled samples; "" until one of them has moved."""
    from kwok_tpu_torch.telemetry import errors as telemetry_errors

    return telemetry_errors.render_nonempty()


def _process_block() -> str:
    """Standard process collector subset (user+sys CPU of this process),
    appended to both exposition paths."""
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu = round(ru.ru_utime + ru.ru_stime, 2)
    except (ImportError, OSError):
        return ""
    return (
        "# HELP process_cpu_seconds_total Total user and system CPU time "
        "spent in seconds\n"
        "# TYPE process_cpu_seconds_total counter\n"
        f"process_cpu_seconds_total {cpu}\n"
    )


def render_metrics(metrics) -> str:
    """Render /metrics text from an engine (its ``metrics`` and labeled
    families) or a flat name->value dict. Flat types go strictly by
    suffix: ``*_total``/``*_sum`` are counters, everything else
    (``*_seconds_last`` included) is a gauge. Under process lanes the
    engine's counters, labeled families and error counters already hold
    every lane process's share."""
    engine = metrics
    registry = getattr(engine, "registry", None)
    # a federation's counters go out once per member, as the reference's
    # shard="<i>" series; any other engine's once, unlabeled
    shards = getattr(engine, "shard_metrics", None)
    if shards is None:
        shards = [dict(getattr(engine, "metrics", engine))]
        label = [""]
    else:
        label = [f'{{shard="{i}"}}' for i in range(len(shards))]
    lines = []
    for name in sorted(set().union(*shards)):
        full = f"kwok_{name}"
        if name in _METRIC_HELP:
            lines.append(f"# HELP {full} {_METRIC_HELP[name]}")
        kind = "counter" if name.endswith(("_total", "_sum")) else "gauge"
        lines.append(f"# TYPE {full} {kind}")
        for suffix, m in zip(label, shards):
            if name in m:
                lines.append(f"{full}{suffix} {m[name]}")
    if hasattr(engine, "metrics_text"):
        labeled = engine.metrics_text()
        errors = engine.process_metrics_text()
    else:
        labeled = registry.render() if registry is not None else ""
        errors = _errors_block()
    return (
        "\n".join(lines) + "\n" + labeled.lstrip("\n")
        + errors + _process_block()
    )


class EngineServer:
    def __init__(self, engine, address: str) -> None:
        host, _, port = address.rpartition(":")
        handler = self._make_handler(engine)
        self.httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def _make_handler(self, engine):
        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/readyz":
                    # readiness is gated on engine warm-up (start() builds
                    # and loads the tick kernel, seconds on a cold build
                    # cache); liveness endpoints stay 200 the whole time
                    # so restart probes don't kill the warm-up
                    if not getattr(engine, "ready", True):
                        # a started engine whose rows are still empty must
                        # not look ready: 503 (reason startup_resync)
                        # until the first full re-list is ingested
                        reason = (
                            "startup_resync"
                            if getattr(
                                engine, "startup_resync_pending", False
                            )
                            else "engine warming up"
                        )
                        self.send_error(503, reason)
                        return
                    if getattr(engine, "degraded", False):
                        # degraded mode (resilience/policy.py): shedding
                        # load or a checkpoint writer off its disk; alive
                        # (/livez stays 200) but not to be sent traffic.
                        # The reasons ride the status line
                        deg = getattr(engine, "_degradation", None)
                        reasons = ",".join(getattr(deg, "reasons", ()))
                        self.send_error(
                            503,
                            "engine degraded" + (f": {reasons}" if reasons else ""),
                        )
                        return
                    body = b"ok"
                    ctype = "text/plain"
                elif self.path in ("/healthz", "/livez"):
                    body = b"ok"
                    ctype = "text/plain"
                elif self.path == "/metrics":
                    body = render_metrics(engine).encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/debug/trace":
                    self.send_error(404, "engine has no tracer")
                    return
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        return Handler

    def start(self) -> None:
        from kwok_tpu_torch.workers import spawn_worker

        self._thread = spawn_worker(
            self.httpd.serve_forever, name="kwok-http"
        )

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
