"""The port's native pump (kwok_tpu_torch.native.Pump, ClusterEngine's
pump send path) against the port's HTTP mock and against small servers
that misbehave, on the CPU.

- The fused template render and send lands each patch on the mock.
- The mock answers pipelined PATCH and DELETE requests in order, each
  with a Content-Length, errors included, and its connections stay
  usable after an error.
- A server that drops a connection mid-batch: the requests it left
  unanswered are resent as whole frames and every one is answered.
- A target that is down past ``PUMP_RESEND``'s deadline: the engine
  degrades with reason ``pump`` (``/readyz`` 503 says so), sheds the
  batch into ``dropped_jobs_total`` and queues no per-object job; the
  next answered batch heals it.
- Process lanes: a pump batch sits in the lane's replay slot while it is
  in flight; the parent's replay of a slot left by a lane killed mid-batch
  lands it. The frames a first send left unanswered stay in the slot
  through the resend backoff, so a kill there loses none of them; a batch
  larger than the slot's share goes out in chunks that each fit, and a
  union of parked requests too large for the slot drops its largest
  entries first, keeping the single requests. Two spawned lanes over HTTP
  converge and ship through their pumps, their counts summed in the
  parent.
- Threaded lanes build their pump groups before any worker runs; a
  federation gives each member a pump of its own to its own apiserver,
  and its stop closes them all.

Every server here is local and every wait has a short deadline.
"""

from __future__ import annotations

import json
import pickle
import socket
import socketserver
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from kwok_tpu_torch import native
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig, FederatedEngine
from kwok_tpu_torch.engine import proclanes as tproc
from kwok_tpu_torch.engine import engine as tengine
from kwok_tpu_torch.engine import shm as tshm
from kwok_tpu_torch.engine.engine import _PumpGroup
from kwok_tpu_torch.kwok.server import EngineServer
from kwok_tpu_torch.models import compile_emit_templates, compile_rules, default_pod_rules
from kwok_tpu_torch.models.lifecycle import ResourceKind
from tests.test_torch_engine import make_node, make_pod

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ toolchain")

NOW = b"2026-08-04T00:00:00Z"
SMP = "application/strategic-merge-patch+json"


def _wait(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _phase(store, name):
    return ((store.get("pods", "default", name) or {}).get("status") or {}).get("phase")


def _pod_path(name):
    return f"/api/v1/namespaces/default/pods/{name}".encode()


def test_fused_send_roundtrip_against_port_mock():
    """One C call renders, fingerprints and ships the batch; the objects
    on the mock carry the spliced status."""
    srv = HttpFakeApiserver().start()
    pump = native.Pump("127.0.0.1", srv.port, nconn=2)
    try:
        n = 6
        for i in range(n):
            srv.store.create("pods", make_pod(f"fu-{i}", node="n0"))
        ptab = compile_rules(default_pod_rules(), ResourceKind.POD)
        tpl = compile_emit_templates(ptab)
        t = tpl.phase_tpl[ptab.space.phase_id("Running")]
        bodies, fps, status, _need = native.emit_pods(
            native.EmitTable(tpl), np.full(n, t, np.int32), np.full(n, 7, np.uint32),
            [b"10.0.0.1"] * n, [f"10.244.9.{i}".encode() for i in range(n)],
            [b"2026-03-01T00:00:00Z"] * n, [b"c\x1fbusybox"] * n, [b""] * n, NOW,
            pump=pump, paths=[_pod_path(f"fu-{i}") for i in range(n)],
        )
        assert status.tolist() == [200] * n
        np.testing.assert_array_equal(fps, native.fingerprint_statuses([bytes(b) for b in bodies]))
        obj = srv.store.get("pods", "default", "fu-3")
        assert obj["status"]["phase"] == "Running" and obj["status"]["podIP"] == "10.244.9.3"
        stats = pump.stats()
        assert stats["requests"] == n and stats["batches"] == 1
    finally:
        pump.close()
        srv.stop()


def test_mock_answers_pipelined_requests_in_order():
    srv = HttpFakeApiserver().start()
    pump = native.Pump("127.0.0.1", srv.port, nconn=1)
    try:
        for name in ("a", "b"):
            srv.store.create("pods", make_pod(name, node="n0"))
        running = json.dumps({"status": {"phase": "Running"}}).encode()
        reqs = [
            ("PATCH", _pod_path("a") + b"/status", running, SMP),
            ("PATCH", _pod_path("missing") + b"/status", running, SMP),  # 404
            ("PATCH", b"/no/such/route", b'{"x":1}', SMP),  # 404, body drained
            ("PATCH", _pod_path("b") + b"/status", b"[1]", SMP),  # 400
            ("PATCH", _pod_path("b") + b"/status", running, SMP),
            ("PATCH", _pod_path("a"), b'{"metadata":{"finalizers":null}}',
             "application/merge-patch+json"),
            ("DELETE", _pod_path("a"), b'{"gracePeriodSeconds":0}'),
            ("DELETE", _pod_path("missing"), b'{"gracePeriodSeconds":0}'),
        ]
        assert pump.send(reqs).tolist() == [200, 404, 404, 400, 200, 200, 200, 200]
        assert srv.store.get("pods", "default", "a") is None
        assert _phase(srv.store, "b") == "Running"
        # the same keep-alive connection still parses the next batch
        assert pump.send(reqs[4:5] * 3).tolist() == [200] * 3
        assert pump.stats()["batches"] == 2
    finally:
        pump.close()
        srv.stop()


class _DroppingServer(socketserver.ThreadingTCPServer):
    """Answers every HTTP request with 200, except that once, after
    ``drop_after`` answers on one connection, it closes that connection
    with requests still unanswered. Records every request path."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, drop_after: int):
        self.drop_after = drop_after
        self.dropped = False
        self.paths: list[bytes] = []
        self.lock = threading.Lock()
        super().__init__(("127.0.0.1", 0), _DroppingHandler)


class _DroppingHandler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server
        answered = 0
        while True:
            line = self.rfile.readline()
            if not line:
                return
            n = 0
            while True:
                h = self.rfile.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.partition(b":")
                if k.strip().lower() == b"content-length":
                    n = int(v)
            if n:
                self.rfile.read(n)
            with srv.lock:
                srv.paths.append(line.split()[1])
                drop = not srv.dropped and answered == srv.drop_after
                if drop:
                    srv.dropped = True
            if drop:
                self.connection.shutdown(socket.SHUT_RDWR)
                return
            self.wfile.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\n{}")
            self.wfile.flush()
            answered += 1


def _engine():
    eng = ClusterEngine(PortFakeKube(), EngineConfig(manage_all_nodes=True, device="cpu"))
    eng._running = True
    return eng


def test_dropped_connection_mid_batch_is_resent_as_whole_frames():
    srv = _DroppingServer(drop_after=3)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    pump = native.Pump("127.0.0.1", srv.server_address[1], nconn=2)
    eng = _engine()
    first = []

    class Watch:
        def send(self, reqs):
            st = pump.send(reqs)
            first.append(st.copy())
            return st

        def close(self):
            pump.close()

    eng._pump = _PumpGroup([Watch()])
    try:
        n = 20
        reqs = [("PATCH", _pod_path(f"r{i}") + b"/status", b'{"status":{}}', SMP)
                for i in range(n)]
        status = eng._pump_send_frames(reqs)
        assert status.tolist() == [200] * n
        assert srv.dropped and (first[0] == 0).any()  # the drop left some unanswered
        assert len(first) >= 2  # ...and they went again
        want = {_pod_path(f"r{i}") + b"/status" for i in range(n)}
        assert set(srv.paths) == want
        assert not eng.degraded
    finally:
        eng._pump.close()
        srv.shutdown()
        srv.server_close()


def test_down_target_past_the_resend_deadline_degrades_and_sheds():
    """No listener (a port held bound and never listened on refuses every
    connection): every frame answers 0 until PUMP_RESEND's deadline; the
    engine then degrades (reason pump, /readyz 503), sheds the batch and
    queues no per-object job; an answered batch heals it."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    eng = _engine()
    eng._pump = _PumpGroup([native.Pump("127.0.0.1", dead.getsockname()[1], nconn=1)])
    submitted = []
    eng._submit = lambda fn, *a: submitted.append(fn.__name__)
    eng.ready = True  # past warm-up: /readyz reads the degradation
    server = EngineServer(eng, "127.0.0.1:0")
    server.start()
    try:
        reqs = [("PATCH", _pod_path(f"d{i}") + b"/status", b'{"status":{}}', SMP)
                for i in range(4)]
        t0 = time.monotonic()
        eng._pump_send(reqs, [0, 1, 2, 3], "pods")
        assert time.monotonic() - t0 >= 4.0  # the resend ran to its deadline
        assert eng.degraded and eng._degradation.reasons == ("pump",)
        m = eng.metrics
        assert m["dropped_jobs_total"] == 4 and m["pump_requests_total"] == 4
        assert m["status_patches_total"] == 0 and submitted == []
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/readyz", timeout=10)
        assert e.value.code == 503 and "pump" in e.value.reason
        assert 'kwok_degraded{reason="pump"} 1' in eng.registry.render()

        class Ok:
            def send(self, reqs):
                return np.full(len(reqs), 200, np.int32)

            def close(self):
                pass

        eng._pump = _PumpGroup([Ok()])
        eng._pump_send(reqs, [0, 1, 2, 3], "pods")
        assert not eng.degraded and eng.metrics["status_patches_total"] == 4
        text = eng.registry.render()
        assert "kwok_pump_send_seconds_count 2" in text
    finally:
        server.stop()
        eng._pump.close()
        dead.close()


class _DyingPump:
    """A pump whose lane process is killed mid-batch: it records what the
    slot holds at that moment, and the batch never returns."""

    def __init__(self, slot):
        self.slot = slot
        self.parked = None

    def send(self, reqs):
        self.parked = self.slot.peek()
        raise SystemExit("SIGKILL")

    def close(self):
        pass


def test_pump_batch_parked_in_slot_is_replayed_after_a_kill_mid_batch():
    """The emit replay through the template path: a lane's fused emit
    renders, then sends through the slot guard (never tunnelling past
    it); killed mid-batch, the slot holds the whole frames, and the
    parent's replay lands every status."""
    srv = HttpFakeApiserver().start()
    slot = tshm.InflightSlot(tshm.arena_name("t-pump-slot"), 1 << 16, create=True)
    try:
        names = [f"k{i}" for i in range(5)]
        for n in names:
            srv.store.create("pods", make_pod(n, node="n0"))
        client = HttpKubeClient(srv.url)
        guard = tproc._SlotGuardClient(slot, client)
        dying = _DyingPump(slot)
        group = _PumpGroup([tproc._SlotGuardPump(guard, dying)])
        assert group.emit_spliced(native, {}) is None  # no tunnel past the slot
        ptab = compile_rules(default_pod_rules(), ResourceKind.POD)
        tpl = compile_emit_templates(ptab)
        t = tpl.phase_tpl[ptab.space.phase_id("Running")]
        bodies, _fps, _st, _need = native.emit_pods(
            native.EmitTable(tpl), np.full(5, t, np.int32), np.full(5, 7, np.uint32),
            [b"10.0.0.1"] * 5, [f"10.244.3.{i}".encode() for i in range(5)],
            [b"2026-03-01T00:00:00Z"] * 5, [b"c\x1fbusybox"] * 5, [b""] * 5, NOW,
        )
        reqs = [("PATCH", _pod_path(n) + b"/status", b, SMP) for n, b in zip(names, bodies)]
        with pytest.raises(SystemExit):
            group.send(reqs)
        parked = pickle.loads(dying.parked)
        assert [(m, p) for m, p, _b, _c in parked] == [
            ("PATCH", f"/api/v1/namespaces/default/pods/{n}/status") for n in names]
        assert [b for _m, _p, b, _c in parked] == [bytes(b) for b in bodies]
        assert all(_phase(srv.store, n) == "Pending" for n in names)
        # the lane died in the send (a SIGKILL runs no cleanup, so its
        # slot still holds what it held then): the parent replays it
        parent = types.SimpleNamespace(_master=srv.url, parent=types.SimpleNamespace(client=client))
        tproc.ProcLaneSet._replay_frames(parent, parked)
        assert all(_phase(srv.store, n) == "Running" for n in names)
    finally:
        slot.close(unlink=True)
        srv.stop()


class _HalfAnsweredThenDying:
    """A pump whose first send answers every other frame and leaves the
    rest unanswered (status 0), and whose lane process is killed in the
    resend: it records what the slot holds when the kill lands."""

    def __init__(self, slot):
        self.slot = slot
        self.sent: list = []
        self.parked = None

    def send(self, reqs):
        self.sent.append([p for _m, p, _b, _c in reqs])
        if len(self.sent) == 1:
            return np.array([200 if i % 2 == 0 else 0 for i in range(len(reqs))], np.int32)
        self.parked = self.slot.peek()
        raise SystemExit("SIGKILL")

    def close(self):
        pass


def _lane_engine(slot, pump):
    """A process lane's engine with its slot guard and ``pump`` behind
    the guard, as ``lane_proc_main`` builds it (no child process)."""
    eng = tproc.make_proc_lane_engine_class()(
        PortFakeKube(), EngineConfig(manage_all_nodes=True, device="cpu"))
    eng._running = True
    guard = eng._slot_guard = tproc._SlotGuardClient(slot, eng.client)
    eng._pump = _PumpGroup([tproc._SlotGuardPump(guard, pump)])
    return eng, guard


def _parked_paths(payload):
    return [p for _m, p, _b, _c in pickle.loads(payload)] if payload else []


def test_unanswered_frames_stay_parked_through_the_resend_backoff(monkeypatch):
    """A first send leaves half the frames unanswered: through the
    resend backoff the slot holds exactly those, and a kill in the
    resend leaves them there for the parent's replay."""
    slot = tshm.InflightSlot(tshm.arena_name("t-pump-owed"), 1 << 16, create=True)
    try:
        pump = _HalfAnsweredThenDying(slot)
        eng, _guard = _lane_engine(slot, pump)
        in_backoff: list = []

        class Peeking:
            """PUMP_RESEND with no wait: its sleep reads the slot."""

            def session(self):
                return types.SimpleNamespace(
                    next_delay=lambda: 0.0,
                    sleep=lambda _d, _stop: in_backoff.append(slot.peek()))

        monkeypatch.setattr(tengine, "PUMP_RESEND", Peeking())
        reqs = [("PATCH", _pod_path(f"o{i}") + b"/status", b'{"status":{}}', SMP)
                for i in range(6)]
        owed = [f"/api/v1/namespaces/default/pods/o{i}/status" for i in (1, 3, 5)]
        with pytest.raises(SystemExit):
            eng._pump_send_frames(reqs)
        assert _parked_paths(in_backoff[0]) == owed
        assert pump.sent[1] == [r[1] for r in reqs[1::2]]  # the resend: the owed frames
        assert _parked_paths(pump.parked) == owed
    finally:
        slot.close(unlink=True)


def test_status_batch_goes_in_chunks_that_fit_the_slot_and_leaves_it_answered():
    """A batch larger than the slot's share per pump group: each chunk is
    parked whole while it is sent, every status comes back in order, and
    the slot is empty once all are answered."""
    slot = tshm.InflightSlot(tshm.arena_name("t-pump-chunks"), 1 << 13, create=True)
    try:
        seen: list = []

        class Recording:
            def send(self, reqs):
                seen.append(([r[1] for r in reqs], _parked_paths(slot.peek())))
                return np.full(len(reqs), 201, np.int32)

            def close(self):
                pass

        eng, guard = _lane_engine(slot, Recording())
        body = b'{"status":{"phase":"Running"}}' + b" " * 150
        reqs = [("PATCH", _pod_path(f"c{i}") + b"/status", body, SMP) for i in range(40)]
        assert tproc._frames_bytes(reqs) > guard.budget
        status = eng._pump_send_frames(reqs)
        assert status.tolist() == [201] * 40
        assert len(seen) > 1
        assert [p for sent, _ in seen for p in sent] == [r[1] for r in reqs]
        for sent, parked in seen:
            assert tproc._frames_bytes([r for r in reqs if r[1] in sent]) <= guard.budget
            assert parked == [p.decode() for p in sent]
        assert slot.peek() is None
    finally:
        slot.close(unlink=True)


def test_slot_overflow_keeps_the_single_requests_parked():
    """A pump batch too large for the slot, parked beside a single
    object's request: the union cannot fit, so the batch leaves the slot
    and the single request stays in it."""
    slot = tshm.InflightSlot(tshm.arena_name("t-pump-over"), 1 << 12, create=True)
    srv = HttpFakeApiserver().start()
    try:
        guard = tproc._SlotGuardClient(slot, HttpKubeClient(srv.url))
        big = [("PATCH", f"/api/v1/namespaces/default/pods/b{i}/status",
                b"%03d" % i + b"x" * 400, SMP) for i in range(20)]
        single = ("PATCH", "/api/v1/nodes/n0/status", b'{"status":{}}', SMP)
        during: list = []
        guard._guarded([single], lambda: guard.pump_send(
            big, lambda: during.append(slot.peek())))
        assert _parked_paths(during[0]) == ["/api/v1/nodes/n0/status"]
        assert slot.peek() is None
    finally:
        slot.close(unlink=True)
        srv.stop()


def test_two_process_lanes_ship_through_their_pumps():
    srv = HttpFakeApiserver().start()
    store = srv.store
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, tick_interval=0.05, drain_shards=2, lane_procs=True,
        device="cpu"))
    try:
        eng.start()
        assert _wait(lambda: eng.ready, 60), "startup gate never closed"
        store.create("nodes", make_node("pp-n0"))
        names = [f"pp-{i}" for i in range(16)]
        for n in names:
            store.create("pods", make_pod(n, node="pp-n0"))
        assert _wait(lambda: all(_phase(store, n) == "Running" for n in names), 30)
        # the lanes publish their counters on a beat
        assert _wait(lambda: eng.metrics["pump_requests_total"] > 0
                     and eng.metrics["status_patches_total"] >= 17, 10)
        assert "kwok_pump_send_seconds_count" in eng.metrics_text()
    finally:
        eng.stop()
        srv.stop()


def test_lane_pumps_primed_before_workers():
    srv = HttpFakeApiserver().start()
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, drain_shards=2, tick_interval=0.02, device="cpu"))
    assert all(not lane.engine._pump_tried for lane in eng._lanes.lanes)
    eng.start()
    try:
        lanes = [lane.engine for lane in eng._lanes.lanes]
        assert all(e._pump_tried and e._pump is not None and len(e._pump) == 2 for e in lanes)
        assert all(e._emit_tpl is eng._emit_tpl for e in lanes)
    finally:
        eng.stop()
        srv.stop()
    assert all(e._pump is None for e in lanes)


def test_federation_members_each_pump_to_their_own_apiserver():
    srvs = [HttpFakeApiserver().start() for _ in range(2)]
    for c, srv in enumerate(srvs):
        srv.store.create("nodes", make_node(f"fn{c}"))
        for i in range(3):
            srv.store.create("pods", make_pod(f"fp{c}-{i}", node=f"fn{c}"))
    fed = FederatedEngine(
        [HttpKubeClient(s.url) for s in srvs],
        EngineConfig(manage_all_nodes=True, tick_interval=0.05, device="cpu"))
    try:
        fed.start()
        assert all(e._pump is not None for e in fed.engines)
        assert fed.engines[0]._pump is not fed.engines[1]._pump
        assert _wait(lambda: all(_phase(s.store, f"fp{c}-{i}") == "Running"
                                 for c, s in enumerate(srvs) for i in range(3)))
        # the pump counts a batch once its answers are back, which can
        # come after the server shows the patched phase: wait for it
        # (each member must count its own 3 pods)
        assert _wait(lambda: all(e.metrics["pump_requests_total"] >= 3
                                 for e in fed.engines)), [
            e.metrics["pump_requests_total"] for e in fed.engines]
    finally:
        fed.stop()
        for s in srvs:
            s.stop()
    assert all(e._pump is None for e in fed.engines)
