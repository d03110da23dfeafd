"""The port's telemetry (ROADMAP item 15) against ``kwok_tpu``'s, on the CPU.

- The span tracer: the same spans fed into both packages' ``Tracer``
  give equal ``chrome_trace()`` documents once ``otherData``'s wall
  epoch is masked (the ring's wraparound included), and so does
  ``merge_chrome_traces``; the port's ``check_chrome_trace`` agrees with
  the suite's schema check on good and broken documents.
- ``EngineTelemetry``: shard-labeled slices of one registry do not
  clobber each other, and the flat view keeps every key of the
  reference's.
- ``/metrics``: the same scenario (``FakeKube``, a node and a pod, 3
  synchronous ticks) on both engines gives expositions with equal sets of
  (family, type, label names), each under the strict parse of
  ``tests/test_metrics_exposition.py``: one lane, 2 threaded lanes, and a
  2-member federation (``kwok_tpu``'s on ``make_mesh(1)``); the
  process-wide error block after the engine's families is parsed, not
  compared (it renders only what the test process moved). No family is
  missing from the port (``MISSING`` names the item of any that would
  be). ``/debug/trace`` answers every topology with a valid document,
  the federation's under the labels ``federation`` and ``shard<i>``.
- The merge of lane-process snapshots follows the reference's policy.
- The device profiler hook on the CPU: a run that stops before tick 102
  leaves a trace with events from the tick thread; the same check fails
  when the stopping thread flushes the profile (in a subprocess: the
  profiler may crash the process that exports such a profile).
- The sampling profiler's ``overruns`` and dump hooks, the flight
  auto-dump on a fresh degradation edge (only on a fresh one), the
  at-stop trace dump, and the per-lane dumps of a spawned 2-lane
  process engine.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.engine import FederatedEngine as JaxFederation
from kwok_tpu.kwok.server import render_metrics as jax_render
from kwok_tpu.parallel import make_mesh
from kwok_tpu.telemetry import Tracer as JaxTracer
from kwok_tpu.telemetry import merge_chrome_traces as jax_merge
from kwok_tpu.telemetry.engine_metrics import EngineTelemetry as JaxTelemetry
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.engine import FederatedEngine as TorchFederation
from kwok_tpu_torch.kwok.server import EngineServer
from kwok_tpu_torch.kwok.server import render_metrics as port_render
from kwok_tpu_torch.telemetry.engine_metrics import EngineTelemetry
from kwok_tpu_torch.telemetry.registry import MetricsRegistry
from kwok_tpu_torch.telemetry.trace import Tracer, check_chrome_trace, merge_chrome_traces
from tests.fake_apiserver import FakeKube
from tests.test_lanes import _pump
from tests.test_metrics_exposition import check_chrome_trace as suite_check
from tests.test_metrics_exposition import parse_exposition
from tests.test_torch_engine import make_node, make_pod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# families of kwok_tpu's exposition the port lacks for this scenario,
# each with the ROADMAP item that brings it (none today)
MISSING: dict = {}


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ------------------------------------------------------------------ tracer


def masked_epoch(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    doc.get("otherData", {}).pop("epoch_unix", None)
    return doc


def feed(tracer, spans) -> None:
    ep = tracer.epoch_perf
    for name, a, b, lane, args in spans:
        tracer.span(name, ep + a, ep + b, lane, args)


SPANS = [
    ("tick.drain", 0.001, 0.002, "drain", None),
    ("tick.dispatch", 0.002, 0.0031, "dispatch", None),
    ("tick.consume", 0.004, 0.0052, "consume", {"wire_wait_us": 12.5}),
    ("tick.emit", 0.0045, 0.005, "emit", {"kind": "pods"}),
    ("pump.send", 0.005, 0.009, "pump", {"kind": "pods", "n": 40}),
    ("pod.ingest_to_patch", 0.0005, 0.0099, "event", {"key": "default/p0", "rv": 7}),
    ("lane.custom", 0.006, 0.0061, "not-a-lane", None),
    ("backwards", 0.007, 0.0065, "drain", None),
]


@pytest.mark.parametrize("capacity", [64, 5])
def test_tracer_chrome_trace_matches_reference(capacity):
    """The same spans in both tracers (epochs aligned) give the same
    document; at capacity 5 the ring wraps and both keep the newest."""
    ref, port = JaxTracer(capacity), Tracer(capacity)
    port.epoch_perf = ref.epoch_perf
    feed(ref, SPANS)
    feed(port, SPANS)
    doc = port.chrome_trace()
    check_chrome_trace(doc)
    suite_check(doc)
    assert masked_epoch(doc) == masked_epoch(ref.chrome_trace())
    assert doc["otherData"]["spans_recorded"] == len(SPANS)


def test_merge_chrome_traces_matches_reference():
    refs = [JaxTracer(), JaxTracer(), JaxTracer()]
    ports = [Tracer(), Tracer(), Tracer()]
    for i, (r, p) in enumerate(zip(refs, ports)):
        p.epoch_perf = r.epoch_perf
        p.epoch_unix = r.epoch_unix
        feed(r, SPANS[i:])
        feed(p, SPANS[i:])
    labels = ["federation", "shard0", "shard1"]
    doc = merge_chrome_traces(ports, labels=labels)
    check_chrome_trace(doc)
    assert doc == jax_merge(refs, labels=labels)
    assert merge_chrome_traces([]) == jax_merge([])


BROKEN = {
    "no-events": {},
    "bad-phase": {"traceEvents": [{"name": "a", "ph": "B", "pid": 0, "tid": 0}]},
    "negative-ts": {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0,
                                     "ts": -1.0, "dur": 1.0}]},
    "str-pid": {"traceEvents": [{"name": "a", "ph": "M", "pid": "0", "tid": 0}]},
    "list-args": {"traceEvents": [{"name": "a", "ph": "M", "pid": 0, "tid": 0,
                                   "args": [1]}]},
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_check_chrome_trace_rejects_what_the_suite_rejects(name):
    doc = BROKEN[name]
    for check in (check_chrome_trace, suite_check):
        with pytest.raises((AssertionError, KeyError)):
            check(doc)


# ------------------------------------------------------------- telemetry


def test_shard_labels_do_not_clobber():
    reg = MetricsRegistry()
    t0 = EngineTelemetry(registry=reg, shard="0")
    t1 = EngineTelemetry(registry=reg, shard="1")
    t0.observe_watch_lag(0.25)
    t1.observe_watch_lag(0.75)
    fams = parse_exposition(reg.render())
    last = {s[1]["shard"]: s[2] for s in fams["kwok_watch_lag_seconds_last"]["samples"]}
    assert last == {"0": 0.25, "1": 0.75}
    counts = {s[1]["shard"]: s[2] for s in fams["kwok_watch_lag_seconds"]["samples"]
              if s[0].endswith("_count")}
    assert counts == {"0": 1.0, "1": 1.0}


def test_flat_view_keeps_the_reference_keys():
    ref, port = JaxTelemetry(), EngineTelemetry()
    for t in (ref, port):
        t.inc("ticks_total", 3)
        t.inc_kind("transitions_total", "pods", 2)
        t.observe_tick(0.5)
        t.observe_stage("parse", 0.25)
        t.pump_hist.observe(0.125)
    d, r = port.legacy_dict(), ref.legacy_dict()
    assert set(r) <= set(d)
    assert {k: d[k] for k in r} == r
    # the port's additions: the throttle counter, and noted values only
    # once set
    assert set(d) - set(r) == {"client_throttle_seconds_total"}
    port.note("checkpoint_writes_total", 2)
    assert port.legacy_dict()["checkpoint_writes_total"] == 2


# ------------------------------------------------------------- /metrics


def families(text: str) -> set:
    out = set()
    for name, fam in parse_exposition(text).items():
        labels = {k for _, ls, _ in fam["samples"] for k in ls if k != "le"}
        out.add((name, fam["type"], tuple(sorted(labels))))
    return out


def scenario(lib: str, topology: str):
    """A node and a pod on FakeKube (each member: its own), 3 ticks."""
    kw = {} if lib == "jax" else {"device": "cpu"}
    cfg = (JaxConfig if lib == "jax" else TorchConfig)(
        manage_all_nodes=True, drain_shards=2 if topology == "lanes" else 1, **kw)
    if topology == "federation":
        servers = [FakeKube(), FakeKube()]
        if lib == "jax":
            eng = JaxFederation(servers, cfg, mesh=make_mesh(1))
        else:
            eng = TorchFederation(servers, cfg)
        for c, s in enumerate(servers):
            s.create("nodes", make_node(f"n{c}"))
            s.create("pods", make_pod(f"p{c}", node=f"n{c}"))
            e = eng.engines[c]
            e._q.put(("nodes", "ADDED", s.get("nodes", None, f"n{c}")))
            e._q.put(("pods", "ADDED", s.get("pods", "default", f"p{c}")))
        for _ in range(3):
            for e in eng.engines:
                while not e._q.empty():
                    item = e._q.get_nowait()
                    if item:
                        e._ingest(*item[:3])
            eng.tick_once()
        return eng
    s = FakeKube()
    eng = (JaxEngine if lib == "jax" else TorchEngine)(s, cfg)
    s.create("nodes", make_node("n0"))
    s.create("pods", make_pod("p0", node="n0"))
    eng._q.put(("nodes", "ADDED", s.get("nodes", None, "n0")))
    eng._q.put(("pods", "ADDED", s.get("pods", "default", "p0")))
    _pump(eng, 3)
    return eng


@pytest.mark.parametrize("topology", ["one-lane", "lanes", "federation"])
def test_exposition_families_match_reference(topology):
    ref = scenario("jax", topology)
    port = scenario("torch", topology)
    # the engines' own families; the process-wide error block appended
    # after them depends on what else the test process ran (only moved
    # counters render), so it is parsed but not compared
    want = families(ref.metrics_text())
    got = families(port.metrics_text())
    assert {f for f in want - got if f[0] not in MISSING} == set()
    assert got - want == set()
    parse_exposition(jax_render(ref))
    parse_exposition(port_render(port))
    # real work was recorded, kind-labeled (and shard-labeled under a
    # federation)
    fams = parse_exposition(port.metrics_text())
    trans = fams["kwok_transitions_total"]["samples"]
    assert sum(v for _, _, v in trans) > 0
    assert {ls["kind"] for _, ls, _ in trans} == {"nodes", "pods"}
    if topology == "federation":
        assert {ls["shard"] for _, ls, _ in trans} == {"0", "1"}


@pytest.mark.parametrize("topology", ["one-lane", "lanes", "federation"])
def test_debug_trace_on_every_topology(topology):
    eng = scenario("torch", topology)
    srv = EngineServer(eng, "127.0.0.1:0")
    srv.start()
    try:
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        c.request("GET", "/debug/trace")
        r = c.getresponse()
        status, ctype, body = r.status, r.getheader("Content-Type"), r.read()
        c.close()
    finally:
        srv.stop()
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    check_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"tick.dispatch", "tick.consume"} <= names, names
    if topology == "federation":
        labels = [e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "process_name"]
        assert labels == ["federation", "shard0", "shard1"]


def _lane_snapshot(tel_cls, reg_cls, ticks: int) -> dict:
    t = tel_cls(registry=reg_cls())
    for _ in range(ticks):
        t.inc("ticks_total")
        t.observe_stage("drain", 0.01)
        t.observe_stage("emit", 0.002)
        t.inc_kind("transitions_total", "pods", 3)
    t.set_gauge("tick_inflight", 1)
    t.set_gauge("tick_seconds_last", 0.05 * ticks)
    t.set_gauge("pods_managed", 7)
    return t.registry.snapshot()


def test_proc_lane_merge_matches_reference():
    """Parent, two live lanes and one retired incarnation merged by both
    packages give the same exposition (the reference's sum, max and
    parent gauge policy)."""
    from kwok_tpu.telemetry import MetricsRegistry as JaxRegistry
    from kwok_tpu.telemetry.engine_metrics import merge_proc_lane_metrics as jax_merge_lanes
    from kwok_tpu_torch.telemetry.lanes import merge_proc_lane_metrics

    out = []
    for tel, reg, merge in ((JaxTelemetry, JaxRegistry, jax_merge_lanes),
                            (EngineTelemetry, MetricsRegistry, merge_proc_lane_metrics)):
        parent = tel(registry=reg())
        parent.inc("ticks_total", 5)
        parent.set_gauge("pods_managed", 20)
        lanes = {0: _lane_snapshot(tel, reg, 2), 1: _lane_snapshot(tel, reg, 3)}
        merged = merge(parent.registry.snapshot(), lanes, {0: _lane_snapshot(tel, reg, 4)},
                       n=2, queue_depths={0: 5, 1: 0})
        fams = parse_exposition(merged.render())
        fams.pop("kwok_build_info")  # the package's version and name
        out.append(fams)
    assert out[0] == out[1]
    assert out[1]["kwok_ticks_total"]["samples"][0][2] == 14.0


# ------------------------------------------------------------ profiler


PROFILE_RUN = r"""
import json, os, sys, time
from kwok_tpu_torch.edge.mockserver import FakeKube
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
from kwok_tpu_torch.profiling import profile_summary

flush_from, out = sys.argv[1], sys.argv[2]
server = FakeKube()
eng = ClusterEngine(server, EngineConfig(
    manage_all_nodes=True, tick_interval=0.02, device="cpu", profile_dir=out))
eng.start()
server.create("nodes", {"metadata": {"name": "n0"}})
for i in range(6):
    server.create("pods", {"metadata": {"name": f"p{i}", "namespace": "default"},
                           "spec": {"nodeName": "n0"}, "status": {"phase": "Pending"}})
    time.sleep(0.1)
deadline = time.time() + 30
while eng.metrics["ticks_total"] < 4 and time.time() < deadline:
    time.sleep(0.02)
if flush_from == "stop":
    # what a literal port of the reference's stop() would do: flush the
    # profile from the thread that stops the engine
    print("FLUSH-FROM-STOPPING-THREAD", flush=True)
    eng._profiler.close(eng.metrics["ticks_total"])
print("STOPPING", flush=True)
eng.stop()
s = profile_summary(out)
assert s["meta"]["ticks"][0] == 2 and s["meta"]["ticks"][1] < 102, s["meta"]
assert s["meta"]["thread"] == "kwok-tick", s["meta"]
assert s["cpu_ops"] > 0, ("NO-CPU-OPS", s)
print(json.dumps({"cpu_ops": s["cpu_ops"], "ticks": s["meta"]["ticks"]}))
"""


def run_profile(flush_from: str, out: str):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-c", PROFILE_RUN, flush_from, out],
                          capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)


def test_profile_stopped_before_tick_102_holds_the_tick_threads_ops(tmp_path):
    """profile_dir on the CPU: the window opens at tick 2 on the tick
    thread and the engine stops long before tick 102; the tick thread's
    exit path writes a trace of its own ops."""
    r = run_profile("tick", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "FLUSH-FROM-STOPPING-THREAD" not in r.stdout
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["cpu_ops"] > 0


def test_profile_flushed_by_the_stopping_thread_fails_the_same_check(tmp_path):
    """The trap the hook avoids: torch.profiler stopped from another
    thread than the one that started it records nothing (the same check
    fails on no CPU ops) or crashes in the export (a signal). The run
    must have reached the flush from the stopping thread: a failure
    before it (an import, a missing attribute) proves nothing."""
    r = run_profile("stop", str(tmp_path))
    assert "FLUSH-FROM-STOPPING-THREAD" in r.stdout, r.stderr[-2000:]
    crashed = r.returncode < 0
    recorded_nothing = r.returncode == 1 and "NO-CPU-OPS" in r.stderr
    assert crashed or recorded_nothing, (r.returncode, r.stderr[-2000:])


# ----------------------------------------------------- sampler, flight


def test_profiling_overruns_and_hooks(tmp_path, monkeypatch):
    from kwok_tpu_torch import profiling

    out = tmp_path / "prof.json"
    s = profiling.Sampler(str(out), interval_s=0.001)
    s.start()
    time.sleep(0.05)
    s.stop_and_dump()
    doc = json.loads(out.read_text())
    assert doc["samples"] > 0
    assert "overruns" in doc and doc["overruns"] >= 0
    assert set(doc) == {"samples", "interval_s", "overruns", "threads"}

    monkeypatch.setattr(profiling, "_hooks_installed", False)
    profiling._install_dump_hooks()
    profiling._install_dump_hooks()  # a second call is a no-op
    assert profiling._hooks_installed


def test_sampler_env_starts_and_engine_stop_dumps(tmp_path, monkeypatch):
    from kwok_tpu_torch import profiling

    out = tmp_path / "sample.json"
    monkeypatch.setenv("KWOK_TPU_SAMPLE_PROF", str(out))
    monkeypatch.setattr(profiling, "_hooks_installed", True)  # no real hooks
    eng = TorchEngine(PortFakeKube(), TorchConfig(
        manage_all_nodes=True, tick_interval=0.02, device="cpu"))
    eng.start()
    try:
        assert profiling._sampler is not None
        time.sleep(0.1)
    finally:
        eng.stop()
    assert profiling._sampler is None
    assert "kwok-tick" in json.loads(out.read_text())["threads"]


@pytest.mark.parametrize("via", ["config", "env"])
def test_flight_autodump_on_a_fresh_degradation(via, tmp_path, monkeypatch):
    """A FRESH degradation reason saves the apiserver's /debug/flight
    (flight_dir or KWOK_TPU_FLIGHT_DIR); setting the same reason again
    is not an edge and saves nothing."""
    from kwok_tpu.telemetry.timeline import check_flight as jax_check_flight
    from kwok_tpu_torch.telemetry.timeline import check_flight

    monkeypatch.delenv("KWOK_TPU_FLIGHT_DIR", raising=False)
    if via == "env":
        monkeypatch.setenv("KWOK_TPU_FLIGHT_DIR", str(tmp_path))
    srv = HttpFakeApiserver().start()
    client = HttpKubeClient(srv.url)
    try:
        client.create("nodes", make_node("fd-n"))  # something in the ring
        eng = TorchEngine(client, TorchConfig(
            manage_all_nodes=True, device="cpu",
            flight_dir=str(tmp_path) if via == "config" else ""))
        assert eng._degradation.set("pump")
        assert wait_for(lambda: list(tmp_path.glob("flight-pump-*.json")), 10)
        dump, = tmp_path.glob("flight-pump-*.json")
        doc = json.loads(dump.read_text())
        check_flight(doc)
        jax_check_flight(doc)
        assert doc["server"] == "mock" and doc["records"]
        assert not eng._degradation.set("pump")
        time.sleep(0.3)
        assert len(list(tmp_path.glob("flight-*.json"))) == 1
    finally:
        client.close()
        srv.stop()


def test_degradation_hook_only_on_fresh_edges_and_never_raises():
    from kwok_tpu_torch.resilience.policy import Degradation

    seen = []

    def hook(reason):
        seen.append(reason)
        raise RuntimeError("post-mortem failed")

    d = Degradation(MetricsRegistry(), on_set=hook)
    assert d.set("pump") and not d.set("pump")
    assert d.clear("pump") and d.set("pump")
    assert seen == ["pump", "pump"] and d.active


# ----------------------------------------------------------- trace dumps


def test_engine_stop_dumps_trace(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("KWOK_TPU_TRACE", str(path))
    server = PortFakeKube()
    eng = TorchEngine(server, TorchConfig(manage_all_nodes=True, device="cpu",
                                          tick_interval=0.02))
    eng.start()
    try:
        server.create("nodes", make_node("dump-n"))
        assert wait_for(lambda: eng.metrics["ticks_total"] > 0)
    finally:
        eng.stop()
    doc = json.loads(path.read_text())
    check_chrome_trace(doc)
    assert doc["otherData"]["spans_recorded"] > 0


def test_process_lanes_write_one_trace_dump_per_lane(tmp_path):
    """A spawned 2-lane process engine with trace_dump: the parent writes
    its dump and each lane process <dump>.lane<i>, each a Chrome trace
    with the lane's own tick spans."""
    path = str(tmp_path / "trace.json")
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    store = srv.store
    eng = TorchEngine(HttpKubeClient(srv.url), TorchConfig(
        manage_all_nodes=True, tick_interval=0.05, drain_shards=2,
        lane_procs=True, device="cpu", trace_dump=path))
    names = [f"tr-p{i}" for i in range(8)]
    try:
        eng.start()
        assert wait_for(lambda: eng.ready, 60), "startup gate never closed"
        store.create("nodes", make_node("tr-n0"))
        for n in names:
            store.create("pods", make_pod(n, node="tr-n0"))
        assert wait_for(lambda: all(
            (store.get("pods", "default", n) or {}).get("status", {}).get("phase") == "Running"
            for n in names), 30)
    finally:
        eng.stop()
        srv.stop()
    for p in (path, f"{path}.lane0", f"{path}.lane1"):
        with open(p) as f:
            doc = json.load(f)
        check_chrome_trace(doc)
        assert doc["otherData"]["epoch_unix"] > 0
    for i in (0, 1):
        with open(f"{path}.lane{i}") as f:
            doc = json.load(f)
        assert "tick.dispatch" in {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}


def test_tracer_is_lock_free_under_concurrent_spans():
    """Spans from several threads at once: no exception, the ring fills
    to its capacity and holds no more, and the count lies between the
    capacity and the spans made (the unlocked counter may lose an
    increment where the interpreter switches threads inside it)."""
    tr = Tracer(capacity=1000)
    ep = tr.epoch_perf

    def spam():
        for i in range(2000):
            tr.span("s", ep, ep + 1e-6, "drain")

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    doc = tr.chrome_trace()
    check_chrome_trace(doc)
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == 1000
    assert 1000 <= doc["otherData"]["spans_recorded"] <= 8000
