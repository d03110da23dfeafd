"""Overload-protection metric surface shared by both mock apiservers (the
port's copy of ``kwok_tpu.telemetry.apiserver_metrics``).

The Python mock (``edge/mockserver.py``) and the native C++ twin
(``native/apiserver.cc``) expose the same families on their own
``/metrics`` endpoint, so a scrape reads either server identically. The
port's Python mock has no admission bands and no slow-watcher cap
(ROADMAP item 13): its inflight and rejected series read 0 and its
terminations count only ``deadline`` closes.

- ``kwok_apiserver_inflight{band=}`` — requests currently admitted per
  max-inflight band ("readonly" = LIST/GET, "mutating" =
  POST/PATCH/DELETE; watches are long-running and exempt, bounded by the
  per-watcher send buffer instead).
- ``kwok_apiserver_rejected_total{band=}`` — requests answered 429 +
  ``Retry-After`` because the band was saturated (kube-apiserver
  ``--max-requests-inflight`` / ``--max-mutating-requests-inflight``
  semantics: reject, never queue unboundedly).
- ``kwok_watch_terminations_total{reason=}`` — watch streams the server
  closed: ``slow`` = the consumer stopped reading and its bounded send
  buffer overflowed (the watch cache's slow-consumer termination; the
  client re-lists), ``deadline`` = the request's ``timeoutSeconds``
  expired (clean close at an event boundary; the client resumes from its
  last revision).

The counters themselves are plain ints owned by the store/server objects
(they are bumped under the store lock, where taking a registry child lock
would nest two level-85 leaves); this module renders them into the strict
Prometheus text format the rest of the tree uses.
"""

from __future__ import annotations

import bisect
import collections
import os
import threading
import time

BANDS = ("readonly", "mutating")
TERMINATION_REASONS = ("slow", "deadline")

# ---------------------------------------------------------- phase timing
#
# Both mock apiservers measure where a request's wall time goes and expose
# the same histogram families, so a latency attribution
# (telemetry/timeline.py) reads either server identically.
# All clock reads are gated by KWOK_TPU_APISERVER_TIMING (default on;
# "0" disables every per-request stamp — the families still render, with
# zero counts, so scrapes stay shape-stable).
#
# The reconciliation contract: for every unary request,
#   read_headers + read_body + parse + commit + encode ~= request total
# within a small in-handler glue residue (band check, path match — a few
# hundred ns). `fanout` is the per-watcher encode+push SUBSET of commit
# (Store emit runs under the store lock) and is therefore excluded from
# the phase sum; `kwok_watch_fanout_total` counts watcher pushes so
# fanout_sum / fanout_total is the per-watcher encode+push cost.

#: whether per-request clock stamps are taken (module-level so the
#: Python mock reads it once, like the C++ twin's cached getenv)
TIMING_ENABLED = os.environ.get("KWOK_TPU_APISERVER_TIMING", "1") != "0"

#: phases every unary request is attributed to, in reconciliation order;
#: fanout last (the disclosed commit subset, excluded from the sum)
TIMING_PHASES = (
    "read_headers", "read_body", "parse", "commit", "encode", "fanout",
)

#: audit-verb vocabulary of the request-level total histogram (watch
#: streams are long-running and excluded from timing entirely)
TIMING_VERBS = ("get", "list", "create", "patch", "delete", "other")

#: fixed bucket ladder (seconds) shared by every timing family; the
#: label strings are canonical — apiserver.cc renders these exact bytes
TIMING_BUCKETS = (
    (5e-06, "5e-06"), (1e-05, "1e-05"), (2.5e-05, "2.5e-05"),
    (5e-05, "5e-05"), (0.0001, "0.0001"), (0.00025, "0.00025"),
    (0.0005, "0.0005"), (0.001, "0.001"), (0.0025, "0.0025"),
    (0.005, "0.005"), (0.01, "0.01"), (0.025, "0.025"), (0.05, "0.05"),
    (0.1, "0.1"), (0.25, "0.25"), (0.5, "0.5"), (1, "1"),
)
_BOUNDS = [b for b, _ in TIMING_BUCKETS]

#: flight-recorder ring capacity (recent request records kept for
#: /debug/flight post-mortems); mirrored by apiserver.cc
FLIGHT_CAPACITY = 1024

#: bucket ladder (events, power-of-2) for kwok_watch_cursor_lag_events;
#: canonical label strings — apiserver.cc renders these exact bytes
LAG_EVENT_BUCKETS = (
    (1, "1"), (2, "2"), (4, "4"), (8, "8"), (16, "16"), (32, "32"),
    (64, "64"), (128, "128"), (256, "256"), (512, "512"),
    (1024, "1024"), (2048, "2048"), (4096, "4096"),
)
_LAG_BOUNDS = [b for b, _ in LAG_EVENT_BUCKETS]


class LagHist:
    """Fixed-bucket histogram over EVENT COUNTS (integer sum), observed
    once per watch close with the stream's final ring-cursor lag. Plain
    ints bumped under the store's ring lock."""

    __slots__ = ("counts", "sum_events", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(_LAG_BOUNDS) + 1)
        self.sum_events = 0
        self.count = 0

    def observe(self, events: int) -> None:
        self.counts[bisect.bisect_left(_LAG_BOUNDS, events)] += 1
        self.sum_events += int(events)
        self.count += 1


class PhaseHist:
    """One fixed-bucket histogram: a counts array, a float sum and a
    total count, bumped under the GIL (the C++ twin uses atomics). The
    render is cumulative-bucket Prometheus text."""

    __slots__ = ("counts", "sum_s", "count")

    def __init__(self) -> None:
        self.counts = [0] * (len(_BOUNDS) + 1)
        self.sum_s = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        # bisect_left: `le` is inclusive, so a value equal to a boundary
        # lands in that boundary's bucket (matches the registry histogram
        # and the C++ twin's <= compare)
        self.counts[bisect.bisect_left(_BOUNDS, seconds)] += 1
        self.sum_s += seconds
        self.count += 1


class ApiserverTiming:
    """Per-server phase timing + flight recorder (the Python half of the
    parity-pinned surface; apiserver.cc is the native twin).

    All counters are plain ints/floats written under the GIL from the
    handler thread that served the request; the flight ring is a bounded
    deque (thread-safe appends). ``tls`` carries the per-request fanout
    accumulator from the store's emit loop back to the handler that
    triggered it (same thread)."""

    def __init__(self, enabled: "bool | None" = None) -> None:
        self.enabled = TIMING_ENABLED if enabled is None else bool(enabled)
        self.phases = {p: PhaseHist() for p in TIMING_PHASES}
        self.verbs = {v: PhaseHist() for v in TIMING_VERBS}
        self.flight: "collections.deque" = collections.deque(
            maxlen=FLIGHT_CAPACITY
        )
        self.captured = 0
        #: high-watermark of retained ring-cursor lag; always tracked,
        #: whatever the timing env knob says
        self.backlog_peak = 0
        self.fanout_pushes = 0
        self.tls = threading.local()

    def begin_request(self) -> "float | None":
        """Arm the per-request fanout accumulator; returns the request
        t0 (perf_counter) or None when timing is off."""
        if not self.enabled:
            return None
        self.tls.fanout_s = 0.0
        return time.perf_counter()

    def note_fanout(self, seconds: float) -> None:
        """Called by the store's commit section after the one ring
        encode+append (same thread as the handler that triggered the
        write); the push COUNT is accounted separately at emit
        (events x live watchers of the kind)."""
        if getattr(self.tls, "fanout_s", None) is not None:
            self.tls.fanout_s += seconds

    def observe_request(
        self, verb: str, total_s: float, phase_s: dict
    ) -> None:
        """One unary request completed: observe the verb total and every
        phase that occurred (parse only on body verbs, fanout only when a
        watcher was pushed — mirrored by apiserver.cc)."""
        self.verbs.get(verb, self.verbs["other"]).observe(total_s)
        for p, v in phase_s.items():
            self.phases[p].observe(v)

    def record_flight(
        self, method: str, path: str, status: int, band: str,
        ts_unix: float, total_us: float, phases_us: dict,
    ) -> None:
        self.captured += 1
        self.flight.append({
            "method": method,
            "path": path,
            "status": int(status),
            "band": band,
            "ts_unix": round(ts_unix, 6),
            "total_us": round(total_us, 3),
            "phases_us": {
                p: round(float(phases_us.get(p, 0.0)), 3)
                for p in TIMING_PHASES
            },
        })

    def flight_doc(self, server: str) -> dict:
        """The /debug/flight document (schema shared with apiserver.cc;
        validated by telemetry/timeline.check_flight)."""
        return {
            "server": server,
            "timing_enabled": bool(self.enabled),
            "ring_capacity": FLIGHT_CAPACITY,
            "captured": self.captured,
            "records": list(self.flight),
        }


APISERVER_METRICS_HELP = {
    "kwok_apiserver_inflight": (
        "Requests currently admitted per max-inflight band "
        "(readonly=LIST/GET, mutating=POST/PATCH/DELETE; watches exempt)"
    ),
    "kwok_apiserver_rejected_total": (
        "Requests rejected with 429 + Retry-After because the band's "
        "max-inflight limit was saturated"
    ),
    "kwok_watch_terminations_total": (
        "Watch streams closed by the server (slow=send-buffer overflow "
        "from a consumer that stopped reading, deadline=timeoutSeconds "
        "expiry)"
    ),
    "kwok_apiserver_request_phase_seconds": (
        "Per-request phase seconds inside the mock apiserver "
        "(read_headers+read_body+parse+commit+encode reconcile to the "
        "request total; fanout is the serialize-once ring encode+append "
        "subset of commit and is excluded from the sum)"
    ),
    "kwok_apiserver_request_seconds": (
        "End-to-end seconds per unary request by audit verb (first "
        "request bytes to response queued; watch streams are long-"
        "running and excluded)"
    ),
    "kwok_watch_fanout_total": (
        "Watch events delivered to individual watchers via the "
        "broadcast ring (events x live watchers of the kind at emit; "
        "fanout_sum over this count is the AMORTIZED per-watcher encode "
        "cost — the ring encodes once and shares the bytes)"
    ),
    "kwok_apiserver_watchers": (
        "Live watch streams currently registered"
    ),
    "kwok_watch_backlog_events": (
        "Per-watcher ring-cursor lag across live watches (agg=max/"
        "total) and the high-watermark of retained lag (agg=peak; "
        "never exceeds KWOK_TPU_WATCH_BACKLOG while the slow-consumer "
        "cap enforces — the bounded-buffer proof, now measured as ring "
        "lag)"
    ),
    "kwok_watch_ring_lag": (
        "Ring-cursor lag behind the serialize-once broadcast ring head "
        "per live watch stream (agg=max/total) and its all-time "
        "high-watermark (agg=peak, clamped to the backlog cap on a "
        "slow-close; identical to kwok_watch_backlog_events by "
        "construction — the explicit ring-surface name)"
    ),
    "kwok_watch_encode_total": (
        "Watch events encoded into the broadcast ring — exactly ONE "
        "encode per event no matter the watcher count (the "
        "serialize-once proof; kwok_watch_fanout_total counts the "
        "deliveries the shared bytes fan out to)"
    ),
    "kwok_watch_cursor_lag_events": (
        "Final ring-cursor lag (events behind the broadcast ring head) "
        "observed once per watch close: slow terminations record the "
        "overflow that killed the stream, graceful closes the drained "
        "tail; per-watcher live lag is GET /debug/watchers"
    ),
}


def render_apiserver_metrics(
    inflight: dict, rejected: dict, terminations: dict
) -> bytes:
    """Strict Prometheus exposition of the three families. All three dicts
    are read without locks: values are ints written under the GIL."""
    lines: list[str] = []

    def fam(name: str, type_: str, samples: list) -> None:
        lines.append(f"# HELP {name} {APISERVER_METRICS_HELP[name]}")
        lines.append(f"# TYPE {name} {type_}")
        lines.extend(samples)

    fam(
        "kwok_apiserver_inflight", "gauge",
        [
            f'kwok_apiserver_inflight{{band="{b}"}} {int(inflight.get(b, 0))}'
            for b in BANDS
        ],
    )
    fam(
        "kwok_apiserver_rejected_total", "counter",
        [
            f'kwok_apiserver_rejected_total{{band="{b}"}} '
            f"{int(rejected.get(b, 0))}"
            for b in BANDS
        ],
    )
    fam(
        "kwok_watch_terminations_total", "counter",
        [
            f'kwok_watch_terminations_total{{reason="{r}"}} '
            f"{int(terminations.get(r, 0))}"
            for r in TERMINATION_REASONS
        ],
    )
    return ("\n".join(lines) + "\n").encode()


def _hist_lines(
    name: str, label: str, value: str, h: PhaseHist
) -> "list[str]":
    """Cumulative-bucket text for one labeled child; the exact line shapes
    apiserver.cc mirrors byte-for-byte."""
    out = []
    acc = 0
    for i, (_b, le) in enumerate(TIMING_BUCKETS):
        acc += h.counts[i]
        out.append(
            f'{name}_bucket{{{label}="{value}",le="{le}"}} {acc}'
        )
    # count is read last; clamp so a concurrent observe mid-render can
    # never leave the +Inf bucket below a finite one (C++ twin does the
    # same)
    cnt = max(h.count, acc + h.counts[-1])
    out.append(
        f'{name}_bucket{{{label}="{value}",le="+Inf"}} {cnt}'
    )
    out.append(f'{name}_sum{{{label}="{value}"}} {h.sum_s:.9f}')
    out.append(f'{name}_count{{{label}="{value}"}} {cnt}')
    return out


def _lag_hist_lines(h: "LagHist | None") -> "list[str]":
    """Cumulative-bucket text for the (label-less) watch-close lag
    histogram; the exact line shapes apiserver.cc mirrors."""
    h = h or LagHist()
    name = "kwok_watch_cursor_lag_events"
    out = []
    acc = 0
    for i, (_b, le) in enumerate(LAG_EVENT_BUCKETS):
        acc += h.counts[i]
        out.append(f'{name}_bucket{{le="{le}"}} {acc}')
    cnt = max(h.count, acc + h.counts[-1])
    out.append(f'{name}_bucket{{le="+Inf"}} {cnt}')
    out.append(f"{name}_sum {int(h.sum_events)}")
    out.append(f"{name}_count {cnt}")
    return out


def render_timing_metrics(
    timing: ApiserverTiming, backlogs, encode_total: int = 0,
    lag_hist: "LagHist | None" = None,
) -> bytes:
    """The phase-timing families, appended to the overload surface by both
    servers' /metrics handlers. Always renders the FULL phase/verb matrix
    (zero counts when nothing was observed, or when timing is disabled)
    so scrapes — and the byte-compared parity twins — are shape-stable.
    ``backlogs`` is the live per-watcher ring-cursor lags;
    ``encode_total`` the store's one-encode-per-event ring counter."""
    lines: list[str] = []

    def fam(name: str, type_: str, samples: list) -> None:
        lines.append(f"# HELP {name} {APISERVER_METRICS_HELP[name]}")
        lines.append(f"# TYPE {name} {type_}")
        lines.extend(samples)

    phase_samples: list[str] = []
    for p in TIMING_PHASES:
        phase_samples.extend(
            _hist_lines(
                "kwok_apiserver_request_phase_seconds", "phase", p,
                timing.phases[p],
            )
        )
    fam("kwok_apiserver_request_phase_seconds", "histogram", phase_samples)
    verb_samples: list[str] = []
    for v in TIMING_VERBS:
        verb_samples.extend(
            _hist_lines(
                "kwok_apiserver_request_seconds", "verb", v,
                timing.verbs[v],
            )
        )
    fam("kwok_apiserver_request_seconds", "histogram", verb_samples)
    fam(
        "kwok_watch_fanout_total", "counter",
        [f"kwok_watch_fanout_total {int(timing.fanout_pushes)}"],
    )
    backlogs = list(backlogs)
    fam(
        "kwok_apiserver_watchers", "gauge",
        [f"kwok_apiserver_watchers {len(backlogs)}"],
    )
    lag_samples = [
        str(max(backlogs) if backlogs else 0),
        str(sum(backlogs)),
        str(int(timing.backlog_peak)),
    ]
    fam(
        "kwok_watch_backlog_events", "gauge",
        [
            f'kwok_watch_backlog_events{{agg="{agg}"}} {v}'
            for agg, v in zip(("max", "total", "peak"), lag_samples)
        ],
    )
    fam(
        "kwok_watch_ring_lag", "gauge",
        [
            f'kwok_watch_ring_lag{{agg="{agg}"}} {v}'
            for agg, v in zip(("max", "total", "peak"), lag_samples)
        ],
    )
    fam(
        "kwok_watch_encode_total", "counter",
        [f"kwok_watch_encode_total {int(encode_total)}"],
    )
    fam(
        "kwok_watch_cursor_lag_events", "histogram",
        _lag_hist_lines(lag_hist),
    )
    return ("\n".join(lines) + "\n").encode()
