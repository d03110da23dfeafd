"""The port's native emit (kwok_tpu_torch.native, models/compiler.py,
ClusterEngine._emit*) against kwok_tpu's, in one process on the CPU.

Tolerance everywhere: bytes equal.

- Renderers: the template splice (``emit_pods``) over every compiled
  phase, condition set and container shape equals ``kwok_tpu``'s
  ``emit_pods``, ``render_pod_statuses`` (for the three canonical
  phases) and the ``render_pod_status_body`` oracles of both packages;
  custom Stage phases get templates too; a row without a creation stamp
  splices the batch's ``now``; heartbeats and the generic pod renderer
  equal the reference's, including the buffer regrow path. The compiled
  template tables are equal array for array.
- Ingest: the emit columns are staged only with templates on; deletes
  share the pod's path column.
- Engine: the port engine on one lane and on 2 threaded lanes, against
  the port's HTTP mock under constant rules with the clock pinned, sends
  the same set of (method, path, body) requests as ``kwok_tpu``'s engine
  (bytes equal) and, parsed, as itself under ``KWOK_TPU_NATIVE=0``;
  every pod reaches Running and goes when deleted.
- ``fp_expect``: a patch onto a scalar-only status seeds it and its echo
  drops at tier 2 without a parse; a non-scalar status never seeds; an
  echo whose phase differs from ``expect_phase`` takes the full path.
"""

from __future__ import annotations

import itertools
import json
import time
from urllib.parse import quote

import numpy as np
import pytest

from kwok_tpu import native as jnative
from kwok_tpu.edge import render as jrender
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.engine import engine as jengine_mod
from kwok_tpu.engine import lanes as jlanes_mod
from kwok_tpu.models import compile_emit_templates as jcompile_emit
from kwok_tpu.models import compile_rules as jcompile_rules
from kwok_tpu.models import default_pod_rules as jdefault_pod_rules
from kwok_tpu.models.lifecycle import Delay as JDelay
from kwok_tpu.models.lifecycle import LifecycleRule as JRule
from kwok_tpu.models.lifecycle import ResourceKind as JKind
from kwok_tpu.models.lifecycle import StatusEffect as JEffect
from kwok_tpu_torch import native
from kwok_tpu_torch.edge import render as trender
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver as PortServer
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
from kwok_tpu_torch.engine import engine as engine_mod
from kwok_tpu_torch.engine import lanes as lanes_mod
from kwok_tpu_torch.engine.engine import _PumpGroup
from kwok_tpu_torch.engine.rowpool import EF_RENDER, EF_SCALAR
from kwok_tpu_torch.models import compile_emit_templates, compile_rules, default_pod_rules
from kwok_tpu_torch.models.lifecycle import (
    NODE_PHASES,
    POD_PHASES,
    Delay,
    LifecycleRule,
    ResourceKind,
    StatusEffect,
)
from tests.fake_apiserver import FakeKube
from tests.test_torch_engine import make_node, make_pod, sync_engine

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="no C++ toolchain for the native library",
)

NOW = "2026-08-04T00:00:00Z"
CREATED = "2026-03-01T00:00:00Z"


def _tables(rules=None, jrules=None):
    ptab = compile_rules(rules or default_pod_rules(), ResourceKind.POD)
    jtab = jcompile_rules(jrules or jdefault_pod_rules(), JKind.POD)
    tpl, jtpl = compile_emit_templates(ptab), jcompile_emit(jtab)
    return ptab, tpl, native.EmitTable(tpl), jnative.EmitTable(jtpl)


def _ctr_blob(containers):
    return b"\x1e".join(f"{c['name']}\x1f{c['image']}".encode() for c in containers)


CONTAINER_SHAPES = [
    [],
    [{"name": "c0", "image": "busybox"}],
    [{"name": "c0", "image": 'img"quote'}, {"name": "c\\1", "image": "x:y"}],
    [{"name": f"c{i}", "image": f"img{i}"} for i in range(5)],
]
INIT_SHAPES = [[], [{"name": "init-0", "image": "setup\timg"}]]


def test_compiled_templates_equal_the_reference():
    rules = default_pod_rules() + [LifecycleRule(
        name="pod-evict", resource=ResourceKind.POD, from_phases=("Running",),
        delay=Delay.constant(0.0), effect=StatusEffect(to_phase="Evictedé"))]
    jrules = jdefault_pod_rules() + [JRule(
        name="pod-evict", resource=JKind.POD, from_phases=("Running",),
        delay=JDelay.constant(0.0), effect=JEffect(to_phase="Evictedé"))]
    got = compile_emit_templates(compile_rules(rules, ResourceKind.POD))
    want = jcompile_emit(jcompile_rules(jrules, JKind.POD))
    assert got.lit_blob == want.lit_blob
    assert got.phase_names == want.phase_names
    for f in ("seg_code", "seg_a", "seg_b", "tpl_off", "tpl_kind", "tpl_ready", "phase_tpl"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_template_splice_byte_parity_exhaustive():
    """Every template x condition set x container shape: the port's splice
    equals the reference's, both packages' render_pod_status_body oracles
    and, for the three canonical phases, the generic native renderer."""
    ptab, tpl, et, jet = _tables()
    kind_of = {"Succeeded": 1, "Failed": 2}
    cases = list(itertools.product(tpl.phase_names, range(8), CONTAINER_SHAPES, INIT_SHAPES))
    ids = np.asarray([tpl.phase_tpl[ptab.space.phase_id(c[0])] for c in cases], np.int32)
    conds = np.asarray([c[1] for c in cases], np.uint32)
    hosts = [f"10.0.0.{i % 250}".encode() for i in range(len(cases))]
    ips = [f"10.244.1.{i % 250}".encode() for i in range(len(cases))]
    starts = [f"2026-01-{1 + i % 27:02d}T12:00:00Z".encode() for i in range(len(cases))]
    cblobs = [_ctr_blob(c[2]) for c in cases]
    iblobs = [_ctr_blob(c[3]) for c in cases]
    cols = (hosts, ips, starts, cblobs, iblobs, NOW.encode())
    bodies, fps, status, need = native.emit_pods(et, ids, conds, *cols)
    jbodies, jfps, _st, jneed = jnative.emit_pods(jet, ids, conds, *cols)
    assert need == jneed == sum(len(b) for b in bodies)
    assert not status.any()  # no pump: nothing sent
    legacy = jnative.render_pod_statuses(
        np.asarray([kind_of.get(c[0], 0) for c in cases], np.uint8), conds,
        [c[0].encode() for c in cases], list(POD_PHASES.conditions[:3]),
        hosts, ips, starts, cblobs, iblobs,
    )
    for i, (phase, bits, ctrs, ictrs) in enumerate(cases):
        pod = {"metadata": {"creationTimestamp": starts[i].decode()},
               "spec": {"containers": ctrs, "initContainers": ictrs}, "status": {}}
        got = bytes(bodies[i])
        assert got == bytes(jbodies[i]), (phase, bits, i)
        assert got == trender.render_pod_status_body(
            pod, phase, bits, hosts[i].decode(), ips[i].decode()), (phase, bits, i)
        assert got == jrender.render_pod_status_body(
            pod, phase, bits, hosts[i].decode(), ips[i].decode()), (phase, bits, i)
        if phase in ("Running", "Succeeded", "Failed"):
            assert got == bytes(legacy[i]), (phase, bits, i)
    # the fused call's fingerprints are the canonical echo-drop seeds
    np.testing.assert_array_equal(fps, jfps)
    np.testing.assert_array_equal(fps, native.fingerprint_statuses([bytes(b) for b in bodies]))


def test_template_splice_extended_phase_vocab():
    """A Stage-extended phase space gets templates too."""
    rules = default_pod_rules() + [LifecycleRule(
        name="pod-evict", resource=ResourceKind.POD, from_phases=("Running",),
        delay=Delay.constant(0.0), effect=StatusEffect(to_phase="Evictedé"))]
    ptab = compile_rules(rules, ResourceKind.POD)
    tpl = compile_emit_templates(ptab)
    assert "Evictedé" in tpl.phase_names
    t = tpl.phase_tpl[ptab.space.phase_id("Evictedé")]
    bodies, _fps, _st, _need = native.emit_pods(
        native.EmitTable(tpl), np.asarray([t], np.int32), np.asarray([5], np.uint32),
        [b"10.0.0.1"], [b"10.244.0.9"], [b"2026-02-02T00:00:00Z"],
        [_ctr_blob(CONTAINER_SHAPES[1])], [b""], NOW.encode(),
    )
    pod = {"metadata": {"creationTimestamp": "2026-02-02T00:00:00Z"},
           "spec": {"containers": CONTAINER_SHAPES[1]}, "status": {}}
    assert bytes(bodies[0]) == jrender.render_pod_status_body(
        pod, "Evictedé", 5, "10.0.0.1", "10.244.0.9")


def test_empty_creation_uses_batch_hoisted_now(monkeypatch):
    """A row without creationTimestamp splices the batch's ``now`` where
    the renderer would call now_rfc3339(): the same bytes with the clock
    pinned."""
    monkeypatch.setattr(trender, "now_rfc3339", lambda: NOW)
    ptab, tpl, et, _jet = _tables()
    t = tpl.phase_tpl[ptab.space.phase_id("Running")]
    bodies, _fps, _st, _need = native.emit_pods(
        et, np.asarray([t], np.int32), np.asarray([7], np.uint32),
        [b"10.0.0.1"], [b"10.244.0.1"], [b""], [_ctr_blob(CONTAINER_SHAPES[1])],
        [b""], NOW.encode(),
    )
    pod = {"metadata": {}, "spec": {"containers": CONTAINER_SHAPES[1]}, "status": {}}
    assert bytes(bodies[0]) == trender.render_pod_status_body(
        pod, "Running", 7, "10.0.0.1", "10.244.0.1")


def _hb_meta():
    return [(name, *trender._NODE_CONDITION_META.get(name, ("KwokRule", name)))
            for name in NODE_PHASES.conditions]


def test_heartbeat_byte_parity():
    rng = np.random.default_rng(7)
    n = 257
    bits = rng.integers(0, 1 << len(NODE_PHASES.conditions), n, dtype=np.uint32)
    starts = [f"2026-07-{d:02d}T08:00:00Z".encode() for d in rng.integers(1, 28, n)]
    out = native.render_heartbeats(bits, _hb_meta(), NOW, starts)
    ref = jnative.render_heartbeats(bits, _hb_meta(), NOW, starts)
    assert len(out) == n
    for i in range(n):
        assert bytes(out[i]) == bytes(ref[i]), i
        assert bytes(out[i]) == jrender.render_heartbeat_body(
            int(bits[i]), NOW, starts[i].decode()), i


def test_generic_pod_renderer_byte_parity():
    """The KWOK_TPU_NATIVE_EMIT=0 renderer against the reference's."""
    rng = np.random.default_rng(1)
    n = 128
    phases = ["Running", "Succeeded", "Failed"]
    pick = rng.integers(0, 3, n)
    args = (
        np.asarray(pick, np.uint8), rng.integers(0, 8, n).astype(np.uint32),
        [phases[i].encode() for i in pick], list(POD_PHASES.conditions[:3]),
        [b"196.168.0.1"] * n, [f"10.0.0.{i % 250 + 1}".encode() for i in range(n)],
        [CREATED.encode()] * n,
        [_ctr_blob([{"name": f"c{j}", "image": f'img"{j}\\x'}
                    for j in range(int(rng.integers(1, 4)))]) for _ in range(n)],
        [_ctr_blob([{"name": "i0", "image": "init:0"}] * int(rng.integers(0, 2)))
         for _ in range(n)],
    )
    out, ref = native.render_pod_statuses(*args), jnative.render_pod_statuses(*args)
    assert [bytes(b) for b in out] == [bytes(b) for b in ref]


def test_buffer_regrow_path():
    """A first guess far too small (one 1 MB string) re-renders at the
    exact size, in both renderers."""
    big = b"x" * 1_000_000
    out = native.render_heartbeats(np.zeros(1, np.uint32), _hb_meta(), "t", [big])
    assert bytes(out[0]) == bytes(jnative.render_heartbeats(
        np.zeros(1, np.uint32), _hb_meta(), "t", [big])[0])
    assert json.loads(bytes(out[0]))["status"]["conditions"][0]["lastTransitionTime"] == big.decode()
    ptab, tpl, et, jet = _tables()
    t = np.asarray([tpl.phase_tpl[ptab.space.phase_id("Running")]], np.int32)
    cols = ([b"10.0.0.1"], [b"10.244.0.1"], [big], [b"c\x1fx"], [b""], NOW.encode())
    bodies, _f, _s, need = native.emit_pods(et, t, np.asarray([7], np.uint32), *cols)
    assert need > 4 * len(big)
    assert bytes(bodies[0]) == bytes(jnative.emit_pods(jet, t, np.asarray([7], np.uint32), *cols)[0][0])


# ------------------------------------------------------------ ingest columns


def _sync(server):
    eng = sync_engine("torch", server, manage_all_nodes=True)
    eng.watch(server)
    return eng


def test_disabled_engine_stages_no_columns(monkeypatch):
    monkeypatch.setenv("KWOK_TPU_NATIVE_EMIT", "0")
    server = FakeKube()
    eng = _sync(server)
    assert eng._emit_tpl is None and not eng._emit_cols
    assert eng._codec is not None  # the generic native emit stays
    server.create("nodes", make_node("zn0"))
    server.create("pods", make_pod("zp0", node="zn0"))
    eng.pump(2)
    pool = eng.pods.pool
    idx = pool.lookup(("default", "zp0"))
    assert pool.eflags[idx] == 0 and pool.start_b[idx] is None and pool.path_b[idx] is None


def test_enabled_engine_stages_columns():
    server = FakeKube()
    eng = _sync(server)
    assert eng._emit_tpl is not None and eng._emit_cols
    server.create("nodes", make_node("cn0"))
    pod = make_pod("cp0", node="cn0")
    pod["metadata"]["creationTimestamp"] = CREATED
    server.create("pods", pod)
    eng.pump(1)
    pool = eng.pods.pool
    idx = pool.lookup(("default", "cp0"))
    assert pool.eflags[idx] & EF_RENDER and pool.eflags[idx] & EF_SCALAR
    assert pool.path_b[idx] == b"/api/v1/namespaces/default/pods/cp0"
    assert pool.start_b[idx] == CREATED.encode()
    assert pool.ctr_b[idx] == b"c\x1fbusybox"
    assert pool.srv_phase[idx] == POD_PHASES.phase_id("Pending")
    # a released row clears every column: a recycled index never
    # splices the previous occupant's bytes
    pool.release(("default", "cp0"))
    assert pool.eflags[idx] == 0 and pool.path_b[idx] is None and pool.start_b[idx] is None


class RecordingPump:
    """A stub pump that records every request and answers 200."""

    def __init__(self):
        self.reqs = []

    def send(self, reqs):
        self.reqs.extend(reqs)
        return np.full(len(reqs), 200, np.int32)

    def close(self):
        pass


def test_delete_path_column_shared_with_status_path():
    """Deletes ride the staged path column (without "/status"), URL-quoted
    as the reference quotes it."""
    server = FakeKube()
    eng = _sync(server)
    server.create("nodes", make_node("dn0"))
    names = ["dp a", "dp/b"]  # URL quoting must survive the column
    for name in names:
        server.create("pods", make_pod(name, node="dn0", finalizers=["x/y"]))
    eng.pump(1)
    pump = RecordingPump()
    eng._pump, eng._pump_tried = _PumpGroup([pump]), True
    rows = [(("default", n), eng.pods.pool.lookup(("default", n))) for n in names]
    eng._emit_deletes_native(eng.pods, rows)
    got = sorted((m, bytes(p).decode(), bytes(b)) for m, p, b, *_ in pump.reqs)
    want = sorted(
        [("DELETE", f"/api/v1/namespaces/default/pods/{quote(n)}",
          b'{"gracePeriodSeconds":0}') for n in names]
        + [("PATCH", f"/api/v1/namespaces/default/pods/{quote(n)}",
            b'{"metadata":{"finalizers":null}}') for n in names]
    )
    assert got == want
    assert eng.metrics["deletes_total"] == 2 and eng.metrics["pump_requests_total"] == 4


# ------------------------------------------------------- engines over HTTP


class RecordingServer(PortServer):
    """The port's HTTP mock, recording the raw (method, path, body) of
    every PATCH and DELETE it answers."""

    def __init__(self, *a, **kw):
        self.requests: list = []
        super().__init__(*a, **kw)

    def _make_handler(self):
        base = super()._make_handler()
        reqs = self.requests

        class Handler(base):
            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                if self.command in ("PATCH", "DELETE"):
                    reqs.append((self.command, self.path, raw))
                return json.loads(raw or b"null") if n else None

        return Handler


N_NODES, N_PODS, N_TERMINATING = 2, 12, 4
RUNNING_STAGE_S = 0.3


def _pin_clock(monkeypatch):
    for mod in (trender, engine_mod, lanes_mod, jrender, jengine_mod, jlanes_mod):
        monkeypatch.setattr(mod, "now_rfc3339", lambda: NOW, raising=False)
    monkeypatch.setattr(engine_mod, "rfc3339", lambda t: NOW)
    monkeypatch.setattr(jengine_mod, "rfc3339", lambda t: NOW)


def _pod_rules(lib):
    if lib == "jax":
        R, E, D, K = JRule, JEffect, JDelay, JKind
        base = jdefault_pod_rules()
    else:
        R, E, D, K = LifecycleRule, StatusEffect, Delay, ResourceKind
        base = default_pod_rules()
    # constant delays: the default pod-ready rule, then a constant Stage
    # that fails Running pods (a second template and a terminal phase)
    return base + [R(
        name="pod-fail", resource=K.POD, from_phases=("Running",),
        delay=D.constant(RUNNING_STAGE_S), effect=E(to_phase="Failed"))]


def _http_run(lib, shards, monkeypatch, native_env="1", pinned_ips=False):
    """Nodes and pods through one engine over HTTP: every pod goes
    Running then Failed (constant Stages), the terminating ones go, and
    the nodes heartbeat. Returns the recorded PATCH/DELETE requests and
    the engine's counters. Every object is in the first re-list, so each
    transition fires for all its rows in one tick in either engine."""
    monkeypatch.setenv("KWOK_TPU_NATIVE", native_env)
    srv = RecordingServer().start()
    store = srv.store
    for i in range(N_NODES):
        store.create("nodes", make_node(f"n{i}"))
    for i in range(N_PODS + N_TERMINATING):
        name = f"p{i}" if i < N_PODS else f"t{i - N_PODS}"
        pod = make_pod(name, node=f"n{i % N_NODES}",
                       finalizers=["kwok.dev/guard"] if i % 2 else None)
        pod["metadata"]["creationTimestamp"] = CREATED
        if i >= N_PODS:
            pod["metadata"]["deletionTimestamp"] = CREATED
        if pinned_ips:  # lanes allocate IPs concurrently: pin them
            pod["status"]["podIP"] = f"10.244.7.{i}"
        store.create("pods", pod)
    cfg = dict(manage_all_nodes=True, tick_interval=0.05, drain_shards=shards,
               parallelism=1, heartbeat_interval=0.5, pod_rules=_pod_rules(lib))
    if lib == "jax":
        from kwok_tpu.edge.httpclient import HttpKubeClient as JClient

        eng = JaxEngine(JClient(srv.url), JaxConfig(**cfg))
    else:
        eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(device="cpu", **cfg))
    eng.start()

    def done():
        pods = store.list("pods")
        return len(pods) == N_PODS and all(
            (p.get("status") or {}).get("phase") == "Failed" for p in pods)

    try:
        deadline = time.time() + 20
        while time.time() < deadline and not done():
            time.sleep(0.02)
        assert done(), [(p["metadata"]["name"], p.get("status")) for p in store.list("pods")]
        time.sleep(1.2)  # two heartbeat rounds
    finally:
        eng.stop()
        srv.stop()
    return set(srv.requests), (eng.metrics if lib == "torch" else {})


def _parsed(reqs):
    return {(m, p, json.dumps(json.loads(b), sort_keys=True)) for m, p, b in reqs}


@pytest.mark.parametrize("shards", [1, 2])
def test_engine_requests_match_reference_and_native_off(shards, monkeypatch):
    _pin_clock(monkeypatch)
    pinned = shards > 1
    got, m = _http_run("torch", shards, monkeypatch, pinned_ips=pinned)
    ref, _ = _http_run("jax", shards, monkeypatch, pinned_ips=pinned)
    off, m_off = _http_run("torch", shards, monkeypatch, native_env="0", pinned_ips=pinned)
    # every pod's Running patch, every terminating pod's delete, and node
    # patches are in the set
    running = {p.split("/")[6] for m_, p, b in got if "/pods/" in p
               and (b'"phase":"Running"' in b or b'"phase": "Running"' in b)}
    assert running == {f"p{i}" for i in range(N_PODS)}
    assert {p.split("/")[6] for m_, p, _b in got if m_ == "DELETE"} == {
        f"t{i}" for i in range(N_TERMINATING)}
    assert any(p.startswith("/api/v1/nodes/") for _m, p, _b in got)
    assert got == ref  # bytes equal
    assert _parsed(got) == _parsed(off)
    assert m["pump_requests_total"] > 0 and m_off["pump_requests_total"] == 0
    assert m["status_patches_total"] >= N_NODES + 2 * N_PODS


# ------------------------------------------------------------- fp_expect


class CountingJson:
    """Stands in for the engine module's ``json``: counts the full parses
    of pod watch lines."""

    def __init__(self):
        self.pod_loads = 0

    def loads(self, s, *a, **kw):
        if b'"kind":"Pod"' in bytes(s).replace(b" ", b""):
            self.pod_loads += 1
        return json.loads(s, *a, **kw)

    def __getattr__(self, name):
        return getattr(json, name)


def _pods_over_http(monkeypatch, status):
    """Two pods created once the engine is ready: they arrive as watch
    lines (the record path, which seeds their fingerprints), go Running
    in one pump batch, and their echoes come back as watch lines.
    Returns the server, the engine, the pod-line parse counter and the
    names the dict upsert saw."""
    counting = CountingJson()
    monkeypatch.setattr(engine_mod, "json", counting)
    srv = PortServer().start()
    srv.store.create("nodes", make_node("n0"))
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, device="cpu", tick_interval=0.05, drain_shards=1))
    upserts = []
    orig = eng._pod_upsert
    eng._pod_upsert = lambda pod: (upserts.append(pod["metadata"]["name"]), orig(pod))
    eng.start()
    deadline = time.time() + 15
    while time.time() < deadline and not eng.ready:
        time.sleep(0.02)
    assert eng.ready
    for i in range(2):
        p = make_pod(f"p{i}", node="n0")
        p["status"] = dict(status)
        srv.store.create("pods", p)
    return srv, eng, counting, upserts


def _running_and_echoed(srv, eng, key):
    deadline = time.time() + 15
    while time.time() < deadline:
        obj = srv.store.get("pods", *key) or {}
        idx = eng.pods.pool.lookup(key)
        m = eng.pods.pool.meta[idx] if idx is not None else None
        if (obj.get("status") or {}).get("phase") == "Running" and m and m.get("rv") == int(
                obj["metadata"]["resourceVersion"]):
            return m
        time.sleep(0.02)
    raise AssertionError("no Running echo ingested")


def test_scalar_status_seeds_fp_expect_and_echo_drops_without_parse(monkeypatch):
    srv, eng, counting, upserts = _pods_over_http(monkeypatch, {"phase": "Pending"})
    try:
        for key in (("default", "p0"), ("default", "p1")):
            m = _running_and_echoed(srv, eng, key)
            assert m["expect_phase"] == "Running"
            # tier 2 took the echo: its fingerprint is the processed one
            assert m["fp_status_done"] == m["fp_expect"]
            assert "obj" not in m  # never parsed
        assert counting.pod_loads == 0 and upserts == []
        assert eng.metrics["pump_requests_total"] >= 2
    finally:
        eng.stop()
        srv.stop()


def test_non_scalar_status_never_seeds():
    """The template emit seeds ``fp_expect`` for the row whose status is
    scalar-only and never for the other, whatever the answer."""
    server = FakeKube()
    eng = _sync(server)
    pump = RecordingPump()
    eng._pump, eng._pump_tried = _PumpGroup([pump]), True
    server.create("nodes", make_node("n0"))
    for name, status in (("s0", {"phase": "Pending"}),
                         ("q0", {"phase": "Pending", "qosClass": "BestEffort"})):
        pod = make_pod(name, node="n0")
        pod["status"] = status
        server.create("pods", pod)
    eng.pump(1)
    sent = {bytes(p).decode().split("/")[6] for m, p, *_ in pump.reqs if m == "PATCH"}
    assert sent == {"s0", "q0"}  # both went out in one pump batch
    meta = eng.pods.pool.meta
    s0 = meta[eng.pods.pool.lookup(("default", "s0"))]
    q0 = meta[eng.pods.pool.lookup(("default", "q0"))]
    assert s0["expect_phase"] == "Running" and s0["fp_expect"]
    assert "fp_expect" not in q0 and "expect_phase" not in q0


def test_non_scalar_echo_takes_the_full_path(monkeypatch):
    srv, eng, counting, upserts = _pods_over_http(
        monkeypatch, {"phase": "Pending", "qosClass": "BestEffort"})
    try:
        m = _running_and_echoed(srv, eng, ("default", "p0"))
        assert "fp_expect" not in m and "expect_phase" not in m
        assert not eng.pods.pool.eflags[eng.pods.pool.lookup(("default", "p0"))] & EF_SCALAR
        # the echo took the full path
        assert counting.pod_loads >= 1 and "p0" in upserts
        assert eng.metrics["pump_requests_total"] >= 2
    finally:
        eng.stop()
        srv.stop()


def test_echo_with_another_phase_takes_the_full_path(monkeypatch):
    """An echo whose status fingerprint matches ``fp_expect`` but whose
    phase is not ``expect_phase`` is parsed and applied."""
    server = FakeKube()
    eng = _sync(server)
    server.create("nodes", make_node("n0"))
    server.create("pods", make_pod("p0", node="n0"))
    eng.pump(1)
    obj = server.get("pods", "default", "p0")
    obj["status"] = {"phase": "Succeeded"}
    obj["metadata"]["resourceVersion"] = str(int(obj["metadata"]["resourceVersion"]) + 1)
    line = json.dumps({"type": "MODIFIED", "object": obj}).encode()
    rec = native.EventParser().parse(line)
    idx = eng.pods.pool.lookup(("default", "p0"))
    m = eng.pods.pool.meta[idx]
    m["fp_meta_sel"], m["fp_spec"] = rec.fp_meta_sel, rec.fp_spec
    m["fp_expect"], m["expect_phase"] = rec.fp_status, "Running"
    upserts = []
    orig = eng._pod_upsert
    eng._pod_upsert = lambda pod: (upserts.append(pod["metadata"]["name"]), orig(pod))
    eng._ingest_record("pods", rec)
    assert upserts == ["p0"]
    assert m["phase_str"] == "Succeeded" and "fp_expect" not in m
    assert eng.pods.pool.srv_phase[idx] == POD_PHASES.phase_id("Succeeded")
