"""The port's cross-tier timeline (``kwok_tpu_torch.telemetry.timeline``)
and its Python mock's observability routes, against ``kwok_tpu``'s on the
CPU.

- One workload against the port's Python mock (``GET /metrics`` and ``GET
  /debug/flight``): the exposition passes the strict parse of
  ``tests/test_metrics_exposition.py`` with the full phase and verb
  matrix, and the flight dump passes both packages' ``check_flight``.
- ``merge_timeline``, ``attribution``, ``attribution_from_metrics`` and
  ``format_table`` give equal results in both packages on the same
  inputs (a span ring, that flight dump, that scrape, lane dumps); so do
  ``check_flight``'s refusals and ``lane_trace_events``' refusal of a
  dump without its wall anchor.
- The CLI, ``python -m kwok_tpu_torch.telemetry.timeline``, merges an
  engine dump, a flight dump and lane dumps, and refuses a lane dump
  without ``epoch_unix``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from kwok_tpu.telemetry import Tracer as JaxTracer
from kwok_tpu.telemetry import timeline as jt
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver
from kwok_tpu_torch.telemetry import timeline as tt
from kwok_tpu_torch.telemetry.apiserver_metrics import TIMING_PHASES, TIMING_VERBS
from kwok_tpu_torch.telemetry.trace import Tracer, check_chrome_trace
from tests.test_metrics_exposition import parse_exposition
from tests.test_torch_engine import make_node, make_pod

ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module")
def mock_run():
    """(/metrics text, /debug/flight document) after creates, a watch,
    status patches and a list against the port's Python mock."""
    srv = HttpFakeApiserver().start()
    try:
        c = HttpKubeClient(srv.url)
        c.create("nodes", make_node("tm-n"))
        c.create("pods", make_pod("tm-p", node="tm-n"))
        w = c.watch("pods")
        threading.Thread(target=lambda: [None for _ in w], daemon=True).start()
        time.sleep(0.2)
        for _ in range(3):
            c.patch_status("pods", "default", "tm-p", {"status": {"phase": "Running"}})
        c.list("pods")
        text = urllib.request.urlopen(srv.url + "/metrics", timeout=5).read().decode()
        flight = json.loads(urllib.request.urlopen(srv.url + "/debug/flight", timeout=5).read())
        w.stop()
        c.close()
        return text, flight
    finally:
        srv.stop()


def test_mock_metrics_strict_with_the_full_timing_matrix(mock_run):
    text, _flight = mock_run
    fams = parse_exposition(text)
    ph = fams["kwok_apiserver_request_phase_seconds"]
    assert ph["type"] == "histogram"
    assert {s[1]["phase"] for s in ph["samples"]} == set(TIMING_PHASES)
    rq = fams["kwok_apiserver_request_seconds"]
    assert {s[1]["verb"] for s in rq["samples"]} == set(TIMING_VERBS)
    counts = {s.get("verb"): v for n, s, v in rq["samples"] if n.endswith("_count")}
    assert counts["patch"] >= 3 and counts["create"] >= 2
    commit = [v for n, s, v in ph["samples"] if n.endswith("_sum") and s["phase"] == "commit"]
    assert commit and commit[0] > 0
    assert fams["kwok_watch_fanout_total"]["samples"][0][2] >= 3
    assert {s[1]["agg"] for s in fams["kwok_watch_backlog_events"]["samples"]} == {
        "max", "total", "peak"}
    # no admission bands and no slow-watcher cap (ROADMAP item 13): zeros
    for fam in ("kwok_apiserver_inflight", "kwok_apiserver_rejected_total",
                "kwok_watch_terminations_total"):
        assert all(v == 0 for _, _, v in fams[fam]["samples"]), fam


def test_mock_flight_passes_both_schema_checks(mock_run):
    _text, flight = mock_run
    tt.check_flight(flight)
    jt.check_flight(flight)
    assert flight["server"] == "mock" and flight["records"]
    patched = [r for r in flight["records"] if r["method"] == "PATCH"]
    assert patched and patched[-1]["band"] == "mutating"
    assert patched[-1]["phases_us"]["commit"] > 0


GOOD_FLIGHT = {
    "server": "mock", "timing_enabled": True, "ring_capacity": 8, "captured": 1,
    "records": [{
        "method": "GET", "path": "/api/v1/pods", "status": 200, "band": "readonly",
        "ts_unix": 1.0, "total_us": 5.0,
        "phases_us": {p: 0.0 for p in TIMING_PHASES},
    }],
}


def _broken(path, value):
    doc = json.loads(json.dumps(GOOD_FLIGHT))
    node = doc
    for k in path[:-1]:
        node = node[k]
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return doc


BROKEN_FLIGHT = {
    "band": (("records", 0, "band"), "purple"),
    "phase-missing": (("records", 0, "phases_us", "commit"), KeyError),
    "server": (("server",), "etcd"),
    "negative-total": (("records", 0, "total_us"), -1.0),
    "over-capacity": (("ring_capacity",), 0),
}


@pytest.mark.parametrize("name", sorted(BROKEN_FLIGHT))
def test_check_flight_refuses_what_the_reference_refuses(name):
    tt.check_flight(GOOD_FLIGHT)
    bad = _broken(*BROKEN_FLIGHT[name])
    for check in (tt.check_flight, jt.check_flight):
        with pytest.raises(AssertionError):
            check(bad)


def rings():
    """One engine ring and two lane rings per package, the same spans at
    the same offsets; the lanes' epochs 2 s and 3 s after the engine's."""
    out = {}
    for lib, cls in (("jax", JaxTracer), ("torch", Tracer)):
        eng, l0, l1 = cls(), cls(), cls()
        out[lib] = (eng, l0, l1)
    for lib in out:
        for k, tr in enumerate(out[lib]):
            ref = out["jax"][k]
            tr.epoch_perf, tr.epoch_unix = ref.epoch_perf, ref.epoch_unix
            ep = tr.epoch_perf
            tr.span("pump.send", ep, ep + 0.01, "pump", {"kind": "pods", "n": 3})
            tr.span("pod.ingest_to_patch", ep + 0.001, ep + 0.004, "event",
                    {"key": "default/p0", "rv": 7})
    docs = {}
    for lib, (eng, l0, l1) in out.items():
        e, a, b = eng.chrome_trace(), l0.chrome_trace(), l1.chrome_trace()
        a["otherData"]["epoch_unix"] = e["otherData"]["epoch_unix"] + 2.0
        b["otherData"]["epoch_unix"] = e["otherData"]["epoch_unix"] + 3.0
        docs[lib] = (e, [a, b])
    return docs


def test_merge_timeline_matches_reference(mock_run):
    _text, flight = mock_run
    # the flight records must lie after the engine's wall epoch to merge
    docs = rings()
    for lib in docs:
        docs[lib][0]["otherData"]["epoch_unix"] = min(
            r["ts_unix"] for r in flight["records"]) - 1.0
    merged = tt.merge_timeline(docs["torch"][0], flight, docs["torch"][1])
    assert merged == jt.merge_timeline(docs["jax"][0], flight, docs["jax"][1])
    check_chrome_trace(json.loads(json.dumps(merged)))
    pids = {e["pid"] for e in merged["traceEvents"]}
    assert pids == {0, 1, 2, 3}
    assert merged["otherData"]["flight_records_merged"] == len(flight["records"])
    assert merged["otherData"]["lane_traces_merged"] == 2
    lane_spans = [e for e in merged["traceEvents"] if e["ph"] == "X" and e["pid"] == 2]
    assert lane_spans and min(e["ts"] for e in lane_spans) >= 2e6 - 1


def test_lane_dump_without_wall_anchor_is_refused():
    e, lanes = rings()["torch"]
    del lanes[0]["otherData"]["epoch_unix"]
    for mod in (tt, jt):
        with pytest.raises(ValueError, match="epoch_unix"):
            mod.lane_trace_events(lanes[0], e["otherData"]["epoch_unix"], 0, pid=2)
        with pytest.raises(ValueError, match="epoch_unix"):
            mod.merge_timeline(e, GOOD_FLIGHT, lanes)


def test_attribution_and_table_match_reference(mock_run):
    text, flight = mock_run
    att = tt.attribution(flight)
    assert att == jt.attribution(flight)
    assert att["requests"] == len(flight["records"]) and att["request_total_us"] > 0
    assert 0 < att["phase_sum_us"] <= att["request_total_us"] * 1.5
    table = tt.format_table(att)
    assert table == jt.format_table(att)
    assert "request total" in table and "fanout" in table
    att2 = tt.attribution_from_metrics(text)
    assert att2 == jt.attribution_from_metrics(text)
    assert att2["requests"] >= att["requests"]
    assert att2["phase_totals_us"]["commit"] > 0


def test_timeline_cli_merges_lane_dumps_and_refuses_unanchored(tmp_path):
    e, lanes = rings()["torch"]
    flight = {"server": "mock", "timing_enabled": True, "ring_capacity": 8,
              "captured": 0, "records": []}
    paths = {}
    for name, doc in (("trace.json", e), ("flight.json", flight),
                      ("trace.json.lane0", lanes[0]), ("trace.json.lane1", lanes[1])):
        paths[name] = tmp_path / name
        paths[name].write_text(json.dumps(doc))
    out = tmp_path / "merged.json"
    cmd = [sys.executable, "-m", "kwok_tpu_torch.telemetry.timeline",
           "--trace", str(paths["trace.json"]), "--flight", str(paths["flight.json"]),
           "--lane-dump", str(paths["trace.json.lane0"]),
           "--lane-dump", str(paths["trace.json.lane1"]), "--out", str(out), "--table"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "merged trace" in r.stdout and "request total" in r.stdout
    merged = json.loads(out.read_text())
    check_chrome_trace(merged)
    assert merged["otherData"]["lane_traces_merged"] == 2
    bad = dict(lanes[0], otherData={})
    bad_p = tmp_path / "bad.lane"
    bad_p.write_text(json.dumps(bad))
    with pytest.raises(SystemExit) as exc:
        tt.main(["--trace", str(paths["trace.json"]), "--flight", str(paths["flight.json"]),
                 "--lane-dump", str(bad_p), "--out", str(out)])
    assert exc.value.code == 2
