"""Cross-tier latency timeline: stitch the engine's span ring and the
apiserver's flight recorder into ONE Chrome-trace document (the port's
copy of ``kwok_tpu.telemetry.timeline``), and the schema checks of both
mock apiservers' ``GET /debug/flight`` (``check_flight``) and ``GET
/debug/watchers`` (``check_watchers``).

The engine's tracer (`telemetry/trace.py`) sees its own side of every
request — drain, emit, `pump.send`, sampled `pod.ingest_to_patch` spans
stamped with their (key, rv) correlation context. Both mock apiservers
keep a bounded flight ring of recent request records (method, path,
per-phase µs, band, status, wall stamp), dumped via ``GET /debug/flight``.

This module merges the two:

- ``merge_timeline(engine_trace, flight)`` re-anchors the flight records
  onto the engine trace's wall epoch (``otherData.epoch_unix``) and lands
  them in their own ``pid`` with per-phase ``tid`` lanes, so Perfetto
  shows a pump batch on the engine side overlapping the exact apiserver
  requests it carried.
- ``attribution(flight)`` / ``attribution_from_metrics(text)`` reduce a
  flight dump or a ``/metrics`` scrape to a per-phase µs table with the
  reconciliation of read_headers+read_body+parse+commit+encode against
  the request-level total.

CLI::

    python -m kwok_tpu_torch.telemetry.timeline \
        --trace /tmp/kwok-trace.json --flight /tmp/flight.json \
        --out /tmp/merged.json --table
"""

from __future__ import annotations

import json
import re

from kwok_tpu_torch.telemetry.apiserver_metrics import TIMING_PHASES

#: phases whose per-request durations must reconcile to the request
#: total (fanout is the disclosed commit subset, excluded from the sum)
SUM_PHASES = ("read_headers", "read_body", "parse", "commit", "encode")

#: tid lanes for flight events in the merged document (0 = the request
#: span itself, then one lane per phase in vocabulary order)
_FLIGHT_LANES = {p: i + 1 for i, p in enumerate(TIMING_PHASES)}


def check_flight(doc: dict) -> None:
    """The shared /debug/flight schema both apiservers must satisfy.
    Raises AssertionError on any violation."""
    assert isinstance(doc, dict), "flight dump is not an object"
    assert doc.get("server") in ("native", "mock"), doc.get("server")
    assert isinstance(doc["timing_enabled"], bool)
    assert isinstance(doc["ring_capacity"], int) and doc["ring_capacity"] > 0
    assert isinstance(doc["captured"], int) and doc["captured"] >= 0
    records = doc["records"]
    assert isinstance(records, list)
    assert len(records) <= doc["ring_capacity"]
    for rec in records:
        assert isinstance(rec["method"], str) and rec["method"]
        assert isinstance(rec["path"], str) and rec["path"]
        assert isinstance(rec["status"], int)
        assert rec["band"] in ("readonly", "mutating", "none"), rec["band"]
        assert isinstance(rec["ts_unix"], (int, float))
        assert isinstance(rec["total_us"], (int, float))
        assert rec["total_us"] >= 0
        phases = rec["phases_us"]
        assert set(phases) == set(TIMING_PHASES), sorted(phases)
        for v in phases.values():
            assert isinstance(v, (int, float)) and v >= 0


def check_watchers(doc: dict) -> None:
    """The shared ``GET /debug/watchers`` schema both mock apiservers must
    satisfy: per-watcher backlog (``lag_events``), replay backlog, age,
    band, and the termination-risk class, a pure function of the backlog
    against the cap. Raises AssertionError on any violation."""
    assert isinstance(doc, dict), "watchers dump is not an object"
    assert doc.get("server") in ("native", "mock"), doc.get("server")
    assert isinstance(doc["backlog_cap"], int) and doc["backlog_cap"] > 0
    assert isinstance(doc["thread_per_watcher"], bool)
    assert isinstance(doc["count"], int) and doc["count"] >= 0
    assert isinstance(doc["parked_threads"], int)
    assert 0 <= doc["parked_threads"] <= doc["count"]
    watchers = doc["watchers"]
    assert isinstance(watchers, list)
    assert len(watchers) == doc["count"]
    for w in watchers:
        assert w["kind"] in ("nodes", "pods"), w.get("kind")
        assert isinstance(w["lag_events"], int) and w["lag_events"] >= 0
        assert isinstance(w["replay_pending"], int)
        assert w["replay_pending"] >= 0
        assert isinstance(w["age_s"], (int, float)) and w["age_s"] >= 0
        assert w["band"] in ("readonly", "mutating", "none"), w.get("band")
        assert w["risk"] in ("none", "lagging", "at_risk"), w.get("risk")
        lag = w["lag_events"]
        cap = doc["backlog_cap"]
        expect = (
            "none" if lag == 0
            else ("lagging" if lag <= cap // 2 else "at_risk")
        )
        assert w["risk"] == expect, (w["risk"], expect, lag, cap)


def lane_trace_events(
    lane_trace: dict, engine_epoch: float, index: int, pid: int
) -> list:
    """One lane child's span-ring dump as Chrome events under its own
    ``pid``, wall-aligned onto the parent engine's clock via each dump's
    ``otherData.epoch_unix`` stamp. A dump without the stamp CANNOT be
    aligned — refuse it loudly instead of merging garbage offsets."""
    other = lane_trace.get("otherData") or {}
    lane_epoch = other.get("epoch_unix")
    if not lane_epoch:
        raise ValueError(
            "lane trace dump has no otherData.epoch_unix wall anchor; "
            "cannot wall-align it with the engine trace (was it produced "
            "by an engine --trace-dump / /debug/trace?)"
        )
    shift_us = (float(lane_epoch) - engine_epoch) * 1e6
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"lane{index}"},
        }
    ]
    for ev in lane_trace.get("traceEvents") or ():
        ev = dict(ev)
        ev["pid"] = pid
        if "ts" in ev:
            ev["ts"] = round(float(ev["ts"]) + shift_us, 1)
        events.append(ev)
    return events


def flight_to_trace_events(
    flight: dict, epoch_unix: float, pid: int = 1
) -> list:
    """Chrome complete events for every flight record, with timestamps
    relative to ``epoch_unix`` (the engine tracer's wall anchor). Each
    request contributes one whole-request span on tid 0 plus one span
    per nonzero phase, laid out sequentially in reconciliation order
    (the flight ring keeps durations, not intra-request stamps);
    ``fanout`` overlays the commit window it is a subset of."""
    label = flight.get("server", "apiserver")
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"apiserver ({label})"},
        },
        {
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "request"},
        },
    ]
    seen_lanes = set()
    for rec in flight.get("records", ()):
        ts = (rec["ts_unix"] - epoch_unix) * 1e6
        if ts < 0:
            continue  # predates the engine run: nothing to line up with
        events.append({
            "name": f'{rec["method"]} {rec["path"].split("?", 1)[0]}',
            "ph": "X",
            "ts": round(ts, 1),
            "dur": round(max(0.0, rec["total_us"]), 1),
            "pid": pid,
            "tid": 0,
            "cat": "apiserver",
            "args": {
                "status": rec["status"],
                "band": rec["band"],
                "path": rec["path"],
            },
        })
        cursor = ts
        for phase in SUM_PHASES:
            dur = float(rec["phases_us"].get(phase, 0.0))
            if dur <= 0:
                continue
            seen_lanes.add(phase)
            events.append({
                "name": phase,
                "ph": "X",
                "ts": round(cursor, 1),
                "dur": round(dur, 1),
                "pid": pid,
                "tid": _FLIGHT_LANES[phase],
                "cat": "apiserver",
            })
            if phase == "commit":
                fan = float(rec["phases_us"].get("fanout", 0.0))
                if fan > 0:
                    seen_lanes.add("fanout")
                    events.append({
                        "name": "fanout",
                        "ph": "X",
                        "ts": round(cursor, 1),
                        "dur": round(fan, 1),
                        "pid": pid,
                        "tid": _FLIGHT_LANES["fanout"],
                        "cat": "apiserver",
                    })
            cursor += dur
    for phase in sorted(seen_lanes):
        events.insert(2, {
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": _FLIGHT_LANES[phase],
            "args": {"name": phase},
        })
    return events


def merge_timeline(
    engine_trace: dict, flight: dict, lane_traces=()
) -> dict:
    """One Chrome-trace document: the engine's span ring (pid 0, as
    dumped by ``--trace-dump`` / ``/debug/trace``), the apiserver's
    flight records (pid 1), and — with ``--lane-procs`` — each lane
    child's span-ring dump (pid 2+N), every tier wall-aligned via its
    own ``epoch_unix`` stamp. The sampled ``pod.ingest_to_patch`` spans
    carry ``{key, rv}`` args on both sides of the shm ring, so one
    Perfetto view follows a pod from raw wire bytes through a worker
    process to the apiserver commit."""
    check_flight(flight)
    epoch = float(
        (engine_trace.get("otherData") or {}).get("epoch_unix") or 0.0
    )
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": "engine"},
        }
    ]
    events += list(engine_trace.get("traceEvents") or ())
    events += flight_to_trace_events(flight, epoch, pid=1)
    for i, lane_trace in enumerate(lane_traces):
        events += lane_trace_events(lane_trace, epoch, i, pid=2 + i)
    other = dict(engine_trace.get("otherData") or {})
    other["flight_records_merged"] = len(flight.get("records") or ())
    other["flight_server"] = flight.get("server")
    if lane_traces:
        other["lane_traces_merged"] = len(lane_traces)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def attribution(flight: dict) -> dict:
    """Per-phase totals over a flight dump's records, with the phase-sum
    vs request-total reconciliation."""
    totals = {p: 0.0 for p in TIMING_PHASES}
    request_us = 0.0
    n = 0
    for rec in flight.get("records", ()):
        n += 1
        request_us += float(rec["total_us"])
        for p, v in rec["phases_us"].items():
            totals[p] += float(v)
    return _reconcile(totals, request_us, n)


_SAMPLE_RE = re.compile(
    r'^(kwok_apiserver_request_phase_seconds|kwok_apiserver_request_seconds)'
    r'_(sum|count)\{(?:phase|verb)="([a-z_]+)"\} (\S+)$'
)


def attribution_from_metrics(text: str) -> dict:
    """The same attribution table from a /metrics exposition scrape —
    the aggregate (histogram) view over every request the server ever
    timed, not just the flight ring's tail."""
    phase_sum = {p: 0.0 for p in TIMING_PHASES}
    phase_count = {p: 0 for p in TIMING_PHASES}
    request_us = 0.0
    requests = 0
    for line in text.splitlines():
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        fam, kind, label, value = m.groups()
        if fam.endswith("_phase_seconds"):
            if kind == "sum":
                phase_sum[label] += float(value)
            else:
                phase_count[label] += int(float(value))
        else:
            if kind == "sum":
                request_us += float(value)
            else:
                requests += int(float(value))
    out = _reconcile(
        {p: v * 1e6 for p, v in phase_sum.items()}, request_us * 1e6,
        requests,
    )
    out["phase_counts"] = phase_count
    return out


def _reconcile(totals_us: dict, request_us: float, n: int) -> dict:
    phase_sum = sum(totals_us[p] for p in SUM_PHASES)
    return {
        "requests": n,
        "phase_totals_us": {
            p: round(v, 3) for p, v in totals_us.items()
        },
        "phase_us_per_request": {
            p: round(v / n, 3) if n else 0.0
            for p, v in totals_us.items()
        },
        "phase_sum_us": round(phase_sum, 3),
        "request_total_us": round(request_us, 3),
        # in-handler glue the phases cannot see (band check, path match,
        # audit): the reconciliation residue
        "unattributed_us": round(request_us - phase_sum, 3),
        "unattributed_frac": round(
            (request_us - phase_sum) / request_us, 4
        ) if request_us else 0.0,
    }


def format_table(att: dict) -> str:
    """Human-readable attribution table (the CLI's --table output)."""
    n = att["requests"]
    lines = [
        f"requests: {n}",
        f"{'phase':>14s} {'total ms':>12s} {'us/request':>12s}",
    ]
    for p in TIMING_PHASES:
        total = att["phase_totals_us"].get(p, 0.0)
        per = att["phase_us_per_request"].get(p, 0.0)
        tag = " (subset of commit)" if p == "fanout" else ""
        lines.append(f"{p:>14s} {total / 1e3:12.3f} {per:12.3f}{tag}")
    lines.append(
        f"{'phase sum':>14s} {att['phase_sum_us'] / 1e3:12.3f}"
    )
    lines.append(
        f"{'request total':>14s} {att['request_total_us'] / 1e3:12.3f}"
    )
    lines.append(
        f"{'unattributed':>14s} {att['unattributed_us'] / 1e3:12.3f}"
        f"  ({att['unattributed_frac'] * 100:.1f}%)"
    )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="merge an engine --trace-dump with an apiserver "
        "/debug/flight dump into one Chrome-trace JSON"
    )
    p.add_argument("--trace", required=True,
                   help="engine Chrome-trace JSON (--trace-dump output "
                   "or a saved /debug/trace)")
    p.add_argument("--flight", required=True,
                   help="apiserver /debug/flight dump")
    p.add_argument("--lane-dump", action="append", default=[],
                   metavar="FILE",
                   help="a lane child's span-ring dump (--lane-procs "
                   "writes <trace>.lane<i> per lane); repeatable — "
                   "each merges as pid 2+N, wall-aligned via its "
                   "epoch_unix stamp")
    p.add_argument("--out", default="",
                   help="write the merged Chrome trace here")
    p.add_argument("--table", action="store_true",
                   help="print the per-phase attribution table")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    with open(args.flight) as f:
        flight = json.load(f)
    lane_traces = []
    for path in args.lane_dump:
        with open(path) as f:
            doc = json.load(f)
        if not (doc.get("otherData") or {}).get("epoch_unix"):
            p.error(
                f"--lane-dump {path}: no otherData.epoch_unix wall "
                "anchor; refusing to merge a dump that cannot be "
                "wall-aligned (use an engine --trace-dump / "
                "/debug/trace output)"
            )
        lane_traces.append(doc)
    try:
        merged = merge_timeline(trace, flight, lane_traces)
    except ValueError as e:
        p.error(str(e))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f)
        print(f"merged trace: {args.out} "
              f"({len(merged['traceEvents'])} events)")
    if args.table or not args.out:
        print(format_table(attribution(flight)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
