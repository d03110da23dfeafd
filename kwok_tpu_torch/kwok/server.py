"""HTTP server: /healthz /readyz /livez + Prometheus /metrics + /debug/trace.

Mirrors Serve in pkg/kwok/cmd/root.go:173-202, with real engine telemetry
instead of only Go runtime collectors (the counters that matter are
transitions/sec, patches/sec, tick latency, watch lag).

``/metrics`` is the engine's (``ClusterEngine``, ``FederatedEngine``)
labeled exposition, ``metrics_text()`` (``telemetry/engine_metrics.EngineTelemetry``: real
histograms with ``_bucket``/``_sum``/``_count`` series, kind labels,
per-shard labels under a federation, ``kwok_build_info``), with the
process-wide error counters (``telemetry/errors.py``; under process
lanes summed over the lane processes) and the process CPU collector
appended. ``/readyz`` is 503 until every member's first re-list is in
and while any member is degraded. ``/debug/trace`` returns the engine's
span ring (a federation's merged document) as Chrome trace-event JSON
(open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _process_block() -> str:
    """Standard process collector subset (user+sys CPU of this process)."""
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


def render_metrics(engine) -> str:
    """Render /metrics text: the engine's labeled registry, then the
    process-wide error counters (under process lanes summed over the
    lane processes), then the process CPU collector."""
    return engine.metrics_text() + engine.process_metrics_text() + _process_block()


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
                    body = json.dumps(engine.trace_chrome()).encode()
                    ctype = "application/json"
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
