"""The port's native ingest (kwok_tpu_torch.native and the engine's record
path) against kwok_tpu's, on the CPU.

- Parser parity: one seeded set of a few thousand watch lines (pods and
  nodes with shuffled key orders, escapes, deletionTimestamps, BOOKMARK,
  an ERROR 410, a garbled and an over-long line) through both packages'
  ``EventParser``, by ``parse_raw_batch`` and ``parse_blob``, with 0, 1, 3
  and 8 lanes: every output array, string offset, lane run and
  ``RouteInfo`` field equal (tolerance 0).
- Twins of tests/test_native_ingest.py on the port's parser, reader and
  engine: field extraction, fingerprint rules, the drain's order, and the
  ``WatchReader`` over a socket pair and over the port's HTTP mock.
- Engine parity: one raw-line script (Pending pods and nodes, echoes, an
  external status drift, a stale MODIFIED, a DELETED, a BOOKMARK, an
  ERROR 410 mid-batch, a pod before its node) through ``_drain_apply`` of
  the JAX engine and the port's, on one lane and on 2 threaded lanes: the
  pools, mirrors, flushed device state, resume revision, counters and the
  patches after ticks are equal. Under ``KWOK_TPU_NATIVE=0`` the port
  gives the same rows.
- The two places a raw-only row used to break: it must reach Running
  through ``_render_pod_pre``, and its checkpoint uid must be read from
  the raw line as kwok_tpu reads it.
"""

from __future__ import annotations

import copy
import json
import socket
import threading
import time

import numpy as np
import pytest

from kwok_tpu import native as jnative
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.ops import state as jstate
from kwok_tpu.resilience import checkpoint as jckpt
from kwok_tpu.telemetry.errors import wire_rejects_total as jax_rejects
from kwok_tpu_torch import native
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.resilience import checkpoint as tckpt
from kwok_tpu_torch.telemetry.errors import wire_rejects_total as port_rejects
from tests.fake_apiserver import FakeKube
from tests.test_torch_engine import make_node, make_pod, masked


@pytest.fixture(autouse=True)
def toolchain():
    """Both packages' native libraries, built at first use (decided here,
    not at import: every test worker must collect the same tests)."""
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


def ev_line(type_, obj) -> bytes:
    return json.dumps({"type": type_, "object": obj}).encode()


# ----------------------------------------------------------- parser parity


def _shuffled(v, rng):
    if isinstance(v, dict):
        keys = list(v)
        rng.shuffle(keys)
        return {k: _shuffled(v[k], rng) for k in keys}
    if isinstance(v, list):
        return [_shuffled(x, rng) for x in v]
    return v


def _pod(i, rng):
    pod = make_pod(f"p{i}", node=f"n{int(rng.integers(0, 40))}",
                   ns=str(rng.choice(["default", "kube-system", "team-a"])))
    meta = pod["metadata"]
    meta["resourceVersion"] = str(int(rng.integers(1, 10**6)))
    meta["uid"] = f"uid-{i}"
    if rng.random() < 0.1:
        del meta["namespace"]
    if rng.random() < 0.1:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    if rng.random() < 0.1:
        meta["finalizers"] = ["keep"]
    if rng.random() < 0.05:
        meta["name"] = f'we"ird-{i}'  # an escape: the record is not ok
    if rng.random() < 0.05:
        meta["labels"] = {"app": "café\\x"}
    if rng.random() < 0.05:
        del pod["spec"]["nodeName"]
    if rng.random() < 0.1:
        pod["spec"]["initContainers"] = [{"name": "i", "image": "init"}]
    if rng.random() < 0.05:
        pod["spec"]["readinessGates"] = [{"conditionType": "G"}]
    st = pod["status"]
    st["phase"] = str(rng.choice(["Pending", "Running", "Succeeded", "Failed"]))
    if rng.random() < 0.5:
        st["podIP"] = f"10.0.{i // 250}.{i % 250}"
        st["hostIP"] = "196.168.0.1"
    if rng.random() < 0.5:
        st["conditions"] = [
            {"type": t, "status": str(rng.choice(["True", "False"]))}
            for t in ("Initialized", "Ready", "ContainersReady", "PodScheduled")
            if rng.random() < 0.7
        ]
    return pod


def _node(i, rng):
    node = make_node(f"n{i}", labels={"zone": str(int(rng.integers(0, 3)))})
    node["metadata"]["resourceVersion"] = str(int(rng.integers(1, 10**6)))
    node["status"] = {
        "capacity": {"cpu": "32", "pods": "110"},
        "conditions": [{"type": "Ready", "status": "True",
                        "lastHeartbeatTime": f"2026-01-01T00:00:{i % 60:02d}Z"}],
    }
    return node


def line_set(seed: int = 7, n: int = 2400) -> list[bytes]:
    """A few thousand seeded watch lines of both kinds plus the odd ones."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        obj = _pod(i, rng) if rng.random() < 0.65 else _node(i, rng)
        type_ = str(rng.choice(["ADDED", "MODIFIED", "MODIFIED", "DELETED"]))
        doc = _shuffled({"type": type_, "object": obj}, rng)
        sep = (",", ":") if rng.random() < 0.5 else (", ", ": ")
        lines.append(json.dumps(doc, separators=sep,
                                ensure_ascii=bool(rng.random() < 0.5)).encode())
    bookmark = b'{"type":"BOOKMARK","object":{"kind":"Pod","metadata":{"resourceVersion":"777"}}}'
    error = (b'{"type":"ERROR","object":{"kind":"Status","apiVersion":"v1",'
             b'"status":"Failure","message":"too old","reason":"Expired","code":410}}')
    garbled = lines[3][: len(lines[3]) // 2]
    big = make_pod("huge", node="n1")
    big["metadata"]["annotations"] = {"blob": "x" * (300 << 10)}
    for pos, extra in ((100, bookmark), (900, garbled), (1500, ev_line("ADDED", big)),
                       (1800, error), (2000, bookmark)):
        lines.insert(pos, extra)
    return lines


@pytest.fixture(scope="module")
def lines():
    return line_set()


def _batch_fields(b) -> dict:
    out = {
        "n": b.n, "buf": bytes(b.buf), "off": np.asarray(b.off_a),
        "fp": np.asarray(b.fp_a), "flags": np.asarray(b.flags_a),
        "rvs": np.asarray(b.rvs_a), "partitioned": b.partitioned,
    }
    if b.partitioned:
        ri = b.route_info
        out.update(
            shard=np.asarray(b.shard), lane_idx=np.asarray(b.lane_idx),
            lane_off=list(b.lane_off),
            route_info=(ri.latest_rv, ri.first_error, ri.bookmarks, ri.routable,
                        ri.unrouteable),
        )
    return out


@pytest.mark.parametrize("kind", ["pods", "nodes"])
@pytest.mark.parametrize("n_shards", [0, 1, 3, 8])
@pytest.mark.parametrize("api", ["parse_raw_batch", "parse_blob"])
def test_parser_parity_with_jax(lines, kind, n_shards, api):
    got, want = [], []
    for mod, out in ((native, got), (jnative, want)):
        p = mod.EventParser()
        if api == "parse_raw_batch":
            b = p.parse_raw_batch(lines, kind=kind, n_shards=n_shards)
        else:
            blob, off = mod._blob(lines)
            b = p.parse_blob(blob, off.tolist(), kind=kind, n_shards=n_shards)
        out.append(_batch_fields(b))
        out.append([(r.type, r.namespace, r.name, r.node_name, r.raw)
                    for r in (b.record(i) for i in range(0, b.n, 97))])
    g, w = got[0], want[0]
    assert g.keys() == w.keys()
    for key in g:
        if isinstance(g[key], np.ndarray):
            assert g[key].dtype == w[key].dtype, key
            assert np.array_equal(g[key], w[key]), key
        else:
            assert g[key] == w[key], key
    assert got[1] == want[1]
    assert g["partitioned"] == bool(n_shards)
    if n_shards:
        # the odd lines are all there: one ERROR, two bookmarks, and the
        # escaped or nameless records routed by Python
        assert g["route_info"][1] >= 0 and g["route_info"][2] == 2
        assert g["route_info"][0] == 0  # an ERROR in the batch: no resume rv


def test_parser_single_line_parity_with_jax(lines):
    pt, pj = native.EventParser(), jnative.EventParser()
    fields = ("type", "namespace", "name", "node_name", "phase", "pod_ip",
              "host_ip", "creation", "containers", "init_containers",
              "true_conditions", "flags", "fp_status", "fp_status_nc",
              "fp_spec", "fp_meta_sel", "rv")
    for line in lines[::37]:
        a, b = pt.parse(line), pj.parse(line)
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]


def test_fingerprint_statuses_parity_with_jax(lines):
    bodies = [json.dumps({"status": {"phase": p, "podIP": f"10.0.0.{i}"}}).encode()
              for i, p in enumerate(["Running", "Failed", "Pending"] * 20)]
    assert np.array_equal(native.fingerprint_statuses(bodies),
                          jnative.fingerprint_statuses(bodies))


# ------------------------------------- twins of tests/test_native_ingest.py


@pytest.fixture
def parser():
    return native.EventParser()


def test_field_extraction(parser):
    pod = {
        "metadata": {
            "name": "p1", "namespace": "ns1",
            "creationTimestamp": "2026-07-01T00:00:00Z",
            "labels": {"app": "x"}, "finalizers": ["keep"],
            "deletionTimestamp": "2026-07-02T00:00:00Z",
        },
        "spec": {
            "nodeName": "n1",
            "containers": [{"name": "c1", "image": "img1"}, {"name": "c2", "image": "img2"}],
            "initContainers": [{"name": "i1", "image": "init1"}],
            "readinessGates": [{"conditionType": "G"}],
        },
        "status": {
            "phase": "Running", "podIP": "10.0.0.9", "hostIP": "1.2.3.4",
            "conditions": [{"type": "Ready", "status": "True"},
                           {"type": "Initialized", "status": "False"}],
        },
    }
    r = parser.parse(ev_line("MODIFIED", pod))
    assert r.ok
    assert (r.type, r.namespace, r.name, r.node_name) == ("MODIFIED", "ns1", "p1", "n1")
    assert (r.phase, r.pod_ip, r.host_ip) == ("Running", "10.0.0.9", "1.2.3.4")
    assert r.creation == "2026-07-01T00:00:00Z"
    assert r.flags & native.REC_DELETION
    assert r.flags & native.REC_FINALIZERS
    assert r.flags & native.REC_READINESS_GATES
    assert not r.flags & native.REC_STATUS_SCALAR_ONLY
    assert r.containers == b"c1\x1fimg1\x1ec2\x1fimg2"
    assert r.init_containers == b"i1\x1finit1"
    assert r.true_conditions == b"Ready"


def test_rv_parsed_at_metadata_depth(parser):
    obj = {"metadata": {"name": "p", "annotations": {"resourceVersion": "999999"},
                        "resourceVersion": "42"},
           "status": {"phase": "Running"}}
    assert parser.parse(ev_line("MODIFIED", obj)).rv == 42
    assert parser.parse(ev_line("ADDED", {"metadata": {"name": "x"}, "status": {}})).rv == 0
    for rv, want in (("abc", 0), ("9223372036854775807", 9223372036854775807),
                     ("9223372036854775808", 0), ("99999999999999999999", 0)):
        obj = {"metadata": {"name": "x", "resourceVersion": rv}, "status": {}}
        assert parser.parse(ev_line("ADDED", obj)).rv == want


def test_scalar_only_flag(parser):
    obj = {"metadata": {"name": "p"}, "status": {"phase": "Pending"}}
    assert parser.parse(ev_line("ADDED", obj)).flags & native.REC_STATUS_SCALAR_ONLY
    obj["status"]["qosClass"] = "BestEffort"
    assert not parser.parse(ev_line("ADDED", obj)).flags & native.REC_STATUS_SCALAR_ONLY


def test_fingerprint_key_order_and_sensitivity(parser):
    a = {"metadata": {"name": "p", "labels": {"a": "1", "b": "2"}},
         "spec": {"nodeName": "n", "containers": [{"name": "c", "image": "i"}]},
         "status": {"phase": "Running", "hostIP": "h", "podIP": "q"}}
    b = {"status": {"podIP": "q", "phase": "Running", "hostIP": "h"},
         "spec": {"containers": [{"image": "i", "name": "c"}], "nodeName": "n"},
         "metadata": {"labels": {"b": "2", "a": "1"}, "name": "p"}}
    ra, rb = parser.parse(ev_line("M", a)), parser.parse(ev_line("M", b))
    assert (ra.fp_status, ra.fp_spec, ra.fp_meta_sel) == (rb.fp_status, rb.fp_spec, rb.fp_meta_sel)
    for path, value, fp in ((("status", "phase"), "Failed", "fp_status"),
                            (("spec", "nodeName"), "other", "fp_spec"),
                            (("metadata", "deletionTimestamp"), "t", "fp_meta_sel")):
        v = copy.deepcopy(a)
        v[path[0]][path[1]] = value
        assert getattr(parser.parse(ev_line("M", v)), fp) != getattr(ra, fp)


def test_status_nc_ignores_conditions_only_changes(parser):
    s1 = {"metadata": {"name": "n"},
          "status": {"capacity": {"cpu": "1k"},
                     "conditions": [{"type": "Ready", "status": "True",
                                     "lastHeartbeatTime": "t1"}]}}
    s2 = copy.deepcopy(s1)
    s2["status"]["conditions"][0]["lastHeartbeatTime"] = "t2"
    r1, r2 = parser.parse(ev_line("M", s1)), parser.parse(ev_line("M", s2))
    assert r1.fp_status != r2.fp_status
    assert r1.fp_status_nc == r2.fp_status_nc
    s3 = copy.deepcopy(s2)
    s3["status"]["capacity"] = {"cpu": "2k"}
    assert parser.parse(ev_line("M", s3)).fp_status_nc != r2.fp_status_nc


def test_escapes_force_slow_path(parser):
    assert not parser.parse(ev_line("ADDED", {"metadata": {"name": 'we"ird'}, "status": {}})).ok


def test_expectation_matches_event_fingerprint(parser):
    status = {"conditions": [{"type": "Ready", "status": "True", "lastTransitionTime": "t"}],
              "containerStatuses": [{"name": "c", "ready": True, "restartCount": 0}],
              "hostIP": "1.2.3.4", "podIP": "10.0.0.7", "phase": "Running", "startTime": "t"}
    body = json.dumps({"status": status}, separators=(",", ":")).encode()
    fp = native.fingerprint_statuses([body])[0]
    reordered = {k: status[k] for k in reversed(list(status))}
    rec = parser.parse(ev_line("MODIFIED", {"metadata": {"name": "p"}, "status": reordered}))
    assert int(fp) == rec.fp_status


def test_drain_raw_batch_flushes_before_non_raw_items():
    """RAW lines buffered for the batch parse apply BEFORE a later
    non-RAW item of the same kind (a RESYNC must not overtake them)."""
    eng = TorchEngine(FakeKube(), TorchConfig(manage_all_nodes=True, device="cpu"))
    applied = []
    orig_safe, orig_rec = eng._ingest_safe, eng._ingest_record_batch

    def spy_safe(kind, type_, obj):
        applied.append((type_, ""))
        return orig_safe(kind, type_, obj)

    def spy_rec(kind, batch, idx, lo, hi):
        applied.extend(("REC", batch.record(i).name) for i in idx[lo:hi].tolist())
        return orig_rec(kind, batch, idx, lo, hi)

    eng._ingest_safe, eng._ingest_record_batch = spy_safe, spy_rec

    def line(name):
        return json.dumps({"type": "ADDED", "object": {
            "metadata": {"name": name, "resourceVersion": "5"}, "status": {}}},
            separators=(",", ":")).encode()

    raw_buf: dict = {}
    eng._drain_apply(("nodes", "RAW", line("early-a"), 0.0), raw_buf)
    eng._drain_apply(("nodes", "RAW", line("early-b"), 0.0), raw_buf)
    eng._drain_apply(("nodes", "RESYNC", [], 0.0), raw_buf)
    eng._drain_flush(raw_buf)
    i_a, i_b = applied.index(("REC", "early-a")), applied.index(("REC", "early-b"))
    assert i_a < i_b < applied.index(("RESYNC", ""))
    assert len(eng.nodes.pool) == 0  # the events applied, then the snapshot ruled
    assert eng._watch_rv["nodes"] == 5


# -------------------------------------------------------------- WatchReader


def _chunked(lines) -> bytes:
    return b"".join(b"%x\r\n%s\r\n" % (len(ln) + 1, ln + b"\n") for ln in lines)


def _read_all(reader, want: int, timeout: float = 10.0):
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        out = reader.read_batch(timeout_s=0.2)
        assert out is not None, "stream ended early"
        buf, off = out
        got += [buf[off[i]: off[i + 1]] for i in range(len(off) - 1)]
        if reader.error is not None:
            break
    return got


def test_watch_reader_batches_over_socketpair():
    """Chunked lines written in pieces come back de-chunked in batches
    (the initial read-ahead bytes first); parse_blob reads the packed
    form; a shutdown is the end of the stream."""
    a, b = socket.socketpair()
    lines = [ev_line("ADDED", make_pod(f"sp-{i}", node="n0")) for i in range(60)]
    wire = _chunked(lines)
    reader = native.WatchReader(a.fileno(), wire[:37], chunked=True)
    rest = wire[37:]
    for k in range(0, len(rest), 1000):
        b.sendall(rest[k:k + 1000])
    got = _read_all(reader, len(lines))
    assert got == lines
    blob, off = native._blob(got)
    batch = native.EventParser().parse_blob(blob, off.tolist())
    assert [batch.record(i).name for i in range(batch.n)] == [f"sp-{i}" for i in range(60)]
    b.shutdown(socket.SHUT_RDWR)
    deadline = time.monotonic() + 10
    while reader.read_batch(timeout_s=0.2) is not None:
        assert time.monotonic() < deadline, "reader did not see the end"
    reader.close()
    a.close()
    b.close()


def test_watch_reader_error_event_cuts_batch():
    a, b = socket.socketpair()
    lines = [ev_line("ADDED", make_pod(f"er-{i}", node="n0")) for i in range(3)]
    error = b'{"type":"ERROR","object":{"kind":"Status","code":410,"reason":"Expired"}}'
    b.sendall(_chunked(lines + [error] + lines))
    reader = native.WatchReader(a.fileno(), b"", chunked=True)
    got = _read_all(reader, 10)
    assert reader.error is not None and b'"code":410' in reader.error
    assert got == lines  # nothing past the ERROR
    reader.close()
    a.close()
    b.close()


def test_watch_reader_giant_line_grows_buffer():
    a, b = socket.socketpair()
    big = make_pod("giant", node="n0")
    big["metadata"]["annotations"] = {"blob": "x" * (2 << 20)}
    line = ev_line("ADDED", big)
    reader = native.WatchReader(a.fileno(), b"", chunked=True)
    sender = threading.Thread(target=b.sendall, args=(_chunked([line]),), daemon=True)
    sender.start()
    got = _read_all(reader, 1, timeout=15)
    sender.join(10)
    assert got == [line] and len(got[0]) > (2 << 20)
    reader.close()
    a.close()
    b.close()


def test_watch_reader_identity_encoding():
    a, b = socket.socketpair()
    lines = [b'{"type":"ADDED","object":{"metadata":{"name":"id-%d"}}}' % i for i in range(3)]
    reader = native.WatchReader(a.fileno(), lines[0] + b"\n", chunked=False)
    b.sendall(b"".join(ln + b"\n" for ln in lines[1:]))
    b.close()
    got = []
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        out = reader.read_batch(timeout_s=0.2)
        if out is None:
            break
        buf, off = out
        got += [buf[off[i]: off[i + 1]] for i in range(len(off) - 1)]
    assert got == lines
    reader.close()
    a.close()


def test_native_reader_over_the_port_http_mock():
    """The handle's native_reader after a real handshake: the reader gets
    the lines of later creates, and stop() ends it promptly."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
    from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver

    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    try:
        client = HttpKubeClient(srv.url)
        w = client.watch("pods", field_selector="spec.nodeName!=")
        reader = w.native_reader()
        assert reader is not None, "a plain-HTTP watch gets the native reader"
        for i in range(40):
            srv.store.create("pods", make_pod(f"wr-{i}", node="n0"))
        got = _read_all(reader, 40)
        batch = native.EventParser().parse_raw_batch(got)
        assert sorted(batch.record(i).name for i in range(batch.n)) == sorted(
            f"wr-{i}" for i in range(40))
        t0 = time.monotonic()
        w.stop()
        while reader.read_batch(timeout_s=0.2) is not None:
            assert time.monotonic() - t0 < 5, "stop() did not end the native read"
        reader.close()
        client.close()
    finally:
        srv.stop()


def test_native_reader_owns_its_descriptor():
    """The reader reads a descriptor of its own: when the response's
    socket is closed under it (stop() falls back to that when its
    shutdown fails) and a new connection takes the freed number, the
    reader neither reads that connection nor loses its stream, and
    stop() still ends it."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
    from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver

    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    a = b = None
    try:
        client = HttpKubeClient(srv.url)
        w = client.watch("pods", field_selector="spec.nodeName!=")
        reader = w.native_reader()
        assert reader is not None
        freed = w._resp.fp.raw._sock.fileno()
        w._resp.close()
        a, b = socket.socketpair()  # the lowest free numbers: the freed one first
        assert freed in (a.fileno(), b.fileno())
        peer = b if a.fileno() == freed else a
        peer.sendall(ev_line("ADDED", {"kind": "Pod", "metadata": {"name": "stray"}}) + b"\n")
        srv.store.create("pods", make_pod("own-0", node="n0"))
        got = _read_all(reader, 1)
        batch = native.EventParser().parse_raw_batch(got)
        assert [batch.record(i).name for i in range(batch.n)] == ["own-0"]
        t0 = time.monotonic()
        w.stop()
        while reader.read_batch(timeout_s=0.2) is not None:
            assert time.monotonic() - t0 < 5, "stop() did not end the native read"
        reader.close()
        client.close()
    finally:
        for sk in (a, b):
            if sk is not None:
                sk.close()
        srv.stop()


def test_native_reader_opt_out(monkeypatch):
    from kwok_tpu_torch.edge.httpclient import _HttpWatch

    monkeypatch.setenv("KWOK_TPU_NATIVE_WATCH", "0")
    w = _HttpWatch.__new__(_HttpWatch)
    assert w.native_reader() is None


# ------------------------------------------------------------ engine parity


class PatchLog:
    """FakeKube wrapper logging each request the engine sends, bodies
    decoded and timestamps masked, in order."""

    def __init__(self):
        self.inner = FakeKube()
        self.log: list = []

    @staticmethod
    def _body(body):
        if isinstance(body, (bytes, bytearray, memoryview)):
            body = json.loads(bytes(body))
        return masked(body)

    def patch_status(self, kind, ns, name, body):
        self.log.append(("status", kind, ns, name, self._body(body)))
        return self.inner.patch_status(kind, ns, name, body)

    def patch_meta(self, kind, ns, name, body):
        self.log.append(("meta", kind, ns, name, self._body(body)))
        return self.inner.patch_meta(kind, ns, name, body)

    def delete(self, kind, ns, name, **kw):
        self.log.append(("delete", kind, ns, name, None))
        return self.inner.delete(kind, ns, name, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _obj(o, rv):
    o = copy.deepcopy(o)
    o["metadata"]["resourceVersion"] = str(rv)
    o["metadata"]["uid"] = "uid-" + o["metadata"]["name"]
    return o


def engine_script():
    """[(kind, [lines])] per window, and the objects to create in the
    store (so the engine's patches land)."""
    nodes = {f"n{i}": make_node(f"n{i}") for i in (0, 1, 2, 3, 9)}
    pods = {f"p{i}": make_pod(f"p{i}", node=f"n{i % 4}") for i in range(10)}
    pods.update({f"p{i}": make_pod(f"p{i}", node="n9") for i in (10, 11)})
    bookmark = b'{"type":"BOOKMARK","object":{"kind":"Pod","metadata":{"resourceVersion":"25"}}}'
    error = b'{"type":"ERROR","object":{"kind":"Status","code":410,"reason":"Expired"}}'
    drift = copy.deepcopy(pods["p1"])
    drift["status"] = {"phase": "Failed"}
    deleting = copy.deepcopy(pods["p5"])
    deleting["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    window1 = [
        ("nodes", [ev_line("ADDED", _obj(nodes[f"n{i}"], 1 + i)) for i in range(4)]),
        ("pods", [ev_line("ADDED", _obj(pods[f"p{i}"], 10 + i)) for i in range(10)]
         + [ev_line("MODIFIED", _obj(pods["p0"], 20)),  # a re-delivered echo
            bookmark]),
    ]
    window2 = [
        ("pods", [
            ev_line("MODIFIED", _obj(drift, 30)),  # an external drift
            ev_line("MODIFIED", _obj(pods["p2"], 5)),  # stale (12 ingested)
            ev_line("DELETED", _obj(pods["p3"], 31)),
            ev_line("ADDED", _obj(pods["p10"], 32)),  # before its node
            ev_line("ADDED", _obj(pods["p11"], 33)),
            error,  # mid-batch: nothing after it commits a revision
            ev_line("MODIFIED", _obj(deleting, 34)),
        ]),
        ("nodes", [ev_line("ADDED", _obj(nodes["n9"], 35)),
                   ev_line("MODIFIED", _obj(nodes["n0"], 36))]),  # an echo
    ]
    return [window1, window2], list(nodes.values()), list(pods.values())


def _build(lib, shards):
    log = PatchLog()
    if lib == "jax":
        eng = JaxEngine(log, JaxConfig(manage_all_nodes=True, drain_shards=shards))
    else:
        eng = TorchEngine(log, TorchConfig(manage_all_nodes=True, drain_shards=shards,
                                           device="cpu"))
    return log, eng


def _kinds(eng):
    """(name, kind) of every row-owning engine: the engine, or its lanes."""
    if eng._lanes is None:
        return [("", eng)]
    return [(f"lane{ln.index}", ln.engine) for ln in eng._lanes.lanes]


def _host_state(lib, state) -> dict:
    if lib == "jax":
        return {f: np.asarray(getattr(state, f)) for f in jstate.RowState._fields}
    st = ts.to_numpy(state)
    return {f: getattr(st, f) for f in ts.RowState._fields}


def _flushed(lib, kind) -> dict:
    """The kind's staged writes flushed into a fresh state of its
    capacity (a copy of the buffer: the engine's own stays staged)."""
    buf = copy.deepcopy(kind.buffer)
    if lib == "jax":
        return _host_state(lib, buf.flush(jstate.new_row_state(kind.capacity)))
    return _host_state(lib, buf.flush(ts.new_row_state(kind.capacity, "cpu")))


def _rows(lib, eng) -> dict:
    out = {}
    for name, e in _kinds(eng):
        for kname in ("nodes", "pods"):
            k = getattr(e, kname)
            n = len(k.pool)
            out[(name, kname)] = {
                "pool": sorted(k.pool.items()),
                "phase_h": k.phase_h.tolist(), "cond_h": k.cond_h.tolist(),
                "flushed": _flushed(lib, k), "n": n,
            }
    return out


def _state_after_ticks(lib, eng) -> dict:
    if eng._lanes is not None:
        states = {k: eng._lanes.stacked[k] for k in ("nodes", "pods")}
    else:
        states = {"nodes": eng.nodes.state, "pods": eng.pods.state}
    # the timers hold wall-clock deadlines of each engine's own epoch
    keep = ("active", "phase", "cond_bits", "sel_bits", "has_deletion", "pending_rule", "gen")
    return {k: {f: v for f, v in _host_state(lib, s).items() if f in keep}
            for k, s in states.items()}


def run_script(lib, shards):
    windows, nodes, pods = engine_script()
    log, eng = _build(lib, shards)
    for o in nodes:
        log.inner.create("nodes", copy.deepcopy(o))
    for o in pods:
        log.inner.create("pods", copy.deepcopy(o))
    rejects = jax_rejects if lib == "jax" else port_rejects
    stale0 = rejects("stale_rv")
    snaps = []
    for window in windows:
        for kind, lines in window:
            for ln in lines:
                eng._q.put((kind, "RAW", ln, time.monotonic()))
        if eng._lanes is not None:
            eng._lanes.drain_inline()
        else:
            raw_buf: dict = {}
            while not eng._q.empty():
                eng._drain_apply(eng._q.get_nowait(), raw_buf)
            eng._drain_flush(raw_buf)
        snaps.append({
            "rows": _rows(lib, eng),
            "watch_rv": dict(eng._watch_rv),
            "bookmarks": eng.metrics["watch_bookmarks_total"],
            "stale_rv": rejects("stale_rv") - stale0,
        })
        for _ in range(3):
            eng.tick_once()
        snaps[-1]["after_ticks"] = _state_after_ticks(lib, eng)
        snaps[-1]["patches"] = list(log.log)
    return snaps, eng


def _assert_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("shards", [1, 2])
def test_engine_parity_with_jax_on_raw_lines(shards):
    want, _ = run_script("jax", shards)
    got, eng = run_script("torch", shards)
    _assert_equal(got, want)
    w1, w2 = got
    # the script did what it says: rows, a bookmark, a stale drop, the
    # ERROR's dead revision, a repair and an engine-driven delete
    assert w1["watch_rv"] == {"nodes": 4, "pods": 25} and w1["bookmarks"] == 1
    assert w2["stale_rv"] == 1 and "pods" not in w2["watch_rv"]
    ops = [(op, name) for op, _k, _ns, name, _b in w2["patches"]]
    assert ("delete", "p5") in ops and ops.count(("status", "p1")) == 2
    assert any(name == "p10" for op, name in ops if op == "status")


@pytest.mark.parametrize("shards", [1, 2])
def test_engine_rows_equal_with_native_off(shards, monkeypatch):
    got, _ = run_script("torch", shards)
    monkeypatch.setenv("KWOK_TPU_NATIVE", "0")
    off, eng = run_script("torch", shards)
    assert eng._batch_parser is None
    for a, b in zip(got, off):
        # the staged buffers differ (the native path drops the echoes the
        # dict path stages as no-op updates); the rows and the device
        # state they give do not
        for snap in (a, b):
            for rows in snap["rows"].values():
                rows.pop("flushed")
        _assert_equal(a["rows"], b["rows"])
        _assert_equal(a["after_ticks"], b["after_ticks"])
        assert a["watch_rv"] == b["watch_rv"]
        assert a["stale_rv"] == b["stale_rv"] and a["bookmarks"] == b["bookmarks"]


# ---------------------------------------------------- raw-only row renders


def test_record_ingested_pod_reaches_running():
    """A pod ingested on the record path holds its raw line and no parsed
    object; its transition must still render (``_render_pod_pre`` reads
    the lazily decoded object) and reach Running in the store."""
    log, eng = _build("torch", 1)
    log.inner.create("nodes", make_node("n0"))
    pod = _obj(make_pod("rp", node="n0"), 7)
    log.inner.create("pods", copy.deepcopy(pod))
    raw_buf: dict = {}
    eng._drain_apply(("nodes", "RAW", ev_line("ADDED", _obj(make_node("n0"), 1)), 0.0), raw_buf)
    eng._drain_apply(("pods", "RAW", ev_line("ADDED", pod), 0.0), raw_buf)
    eng._drain_flush(raw_buf)
    idx = eng.pods.pool.lookup(("default", "rp"))
    m = eng.pods.pool.meta[idx]
    assert "raw" in m and "obj" not in m
    for _ in range(3):
        eng.tick_once()
    assert log.inner.get("pods", "default", "rp")["status"]["phase"] == "Running"


def test_row_uid_of_raw_only_row_matches_jax():
    line = ev_line("ADDED", _obj(make_pod("u0", node="n0"), 3))
    metas = [{"raw": line}, {"raw": line.replace(b'"uid": "uid-u0"', b'"uid":"abc"')},
             {"raw": b'{"type":"ADDED","object":{"metadata":{"name":"x"}}}'},
             {"raw": b'{"uid":"unterminated'}, {"obj": {"metadata": {"uid": "o1"}}}]
    for m in metas:
        assert tckpt.row_uid(dict(m)) == jckpt.row_uid(dict(m))
    assert tckpt.row_uid({"raw": line.replace(b": ", b":")}) == "uid-u0"


@pytest.mark.parametrize("kind", ["pods", "nodes"])
def test_echo_tier_two_with_a_hand_seeded_expectation(kind):
    """Tier 2 of ``_ingest_record``: a MODIFIED whose status fingerprint
    equals the expectation recorded for this engine's own patch (seeded
    here by hand; the native emit seeds it) is dropped as our echo: the
    row keeps the fresh raw line and revision, drops its stale object and
    sends nothing, in both packages alike."""
    status = ({"phase": "Running", "podIP": "10.0.0.3", "hostIP": "196.168.0.1"}
              if kind == "pods" else
              {"conditions": [{"type": "Ready", "status": "True"}], "capacity": {"cpu": "8"}})
    out = {}
    for lib, mod in (("jax", jnative), ("torch", native)):
        log, eng = _build(lib, 1)
        obj = _obj(make_pod("e2", node="n0") if kind == "pods" else make_node("n0"), 5)
        store_kind = "nodes" if kind == "nodes" else "pods"
        log.inner.create("nodes", make_node("n0"))
        if kind == "pods":
            log.inner.create(store_kind, copy.deepcopy(obj))
        raw_buf: dict = {}
        eng._drain_apply(("nodes", "RAW", ev_line("ADDED", _obj(make_node("n0"), 1)), 0.0),
                         raw_buf)
        if kind == "pods":
            eng._drain_apply(("pods", "RAW", ev_line("ADDED", obj), 0.0), raw_buf)
        eng._drain_flush(raw_buf)
        k = getattr(eng, kind)
        key = ("default", "e2") if kind == "pods" else "n0"
        m = k.pool.meta[k.pool.lookup(key)]
        if kind == "nodes":
            # a dict-path node: the record path seeds its fingerprints
            # only after a full parse, as the first MODIFIED does here
            eng._drain_apply(("nodes", "RAW", ev_line("MODIFIED", _obj(make_node("n0"), 2)), 0.0),
                             raw_buf)
            eng._drain_flush(raw_buf)
        body = json.dumps({"status": status}, separators=(",", ":")).encode()
        m["fp_expect"] = int(mod.fingerprint_statuses([body])[0])
        m["expect_phase"] = status.get("phase")
        m.setdefault("obj", {"stale": True})
        echo = _obj(make_pod("e2", node="n0") if kind == "pods" else make_node("n0"), 9)
        echo["status"] = {k2: status[k2] for k2 in reversed(list(status))}
        line = ev_line("MODIFIED", echo)
        sent = len(log.log)
        eng._drain_apply((kind, "RAW", line, 0.0), raw_buf)
        eng._drain_flush(raw_buf)
        assert len(log.log) == sent
        assert m["raw"] == line and "obj" not in m and m["rv"] == 9
        out[lib] = {f: m.get(f) for f in ("fp_status_done", "fp_nsc_done", "phase_str",
                                          "host_ip", "status_scalar")}
    assert out["torch"] == out["jax"]


def test_lines_cut_mid_string_are_rejected_not_read_past():
    """The port's repair of its parser copy (ROADMAP §3): a watch line cut
    inside a string (``wire.truncate``, or a garbled quote) left the
    string's length unset and the status fingerprint hashed bytes far past
    the line; under the drift phase's storm that was a segfault.
    kwok_tpu's parser still reads past such a line. Run in a process of
    its own (a regression would kill the test process): every cut and
    seeded garble of a pod line parses to an error flag or a record, and
    the intact line still parses whole."""
    import subprocess
    import sys

    code = r'''
import json, random, sys
from kwok_tpu_torch import native
from kwok_tpu_torch.resilience.faults import FaultPlane, FaultSpec
p = native.EventParser()
pod = {"metadata": {"name": "p0", "namespace": "default", "resourceVersion": "12345",
                    "uid": "u0"}, "spec": {"nodeName": "n0"},
       "status": {"phase": "Running", "conditions": [
           {"type": "Ready", "status": "True", "lastTransitionTime": "2026-10-17T18:00:00Z"}]}}
line = b'{"type":"MODIFIED","object":' + json.dumps(pod, separators=(",", ":")).encode() + b'}'
rng = random.Random(5)
plane = FaultPlane(FaultSpec.parse("seed=5;wire.garble=1"))
for cut in range(len(line)):
    p.parse(line[:cut])
    p.parse(line[:cut] + b"\\")
for _ in range(500):
    batch = []
    for _ in range(rng.randint(1, 20)):
        b = line
        for _ in range(rng.randint(0, 3)):
            b = plane.garble_bytes(b)
        batch.append(b[: rng.randint(0, len(b))] if rng.random() < 0.3 else b)
    p.parse_raw_batch(batch, "pods", 4)
    p.parse_raw_batch(batch)
whole = p.parse(line)
assert (whole.type, whole.rv, whole.name) == ("MODIFIED", 12345, "p0"), whole
print("ok")
'''
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", (r.returncode, r.stderr[-2000:])


def test_garbled_bytes_in_one_record_leave_the_batch_whole():
    """A garbled watch line that still parses can carry bytes that are not
    UTF-8 (a creation stamp, a host IP): the parser hands them over as
    surrogate escapes. The columnar ingest stages them back as the bytes
    they came in; a strict encode raised mid-batch, left the batch's other
    rows half-staged (in the pool, never ticked), and their re-list was
    dropped as stale: pods that stayed Pending for good (the drift
    phase's storm). Every intact pod of the batch must reach Running (the
    garbled one's patch carries its garbled stamp back: the anti-entropy
    auditor's stale row to repair)."""
    log, eng = _build("torch", 1)
    log.inner.create("nodes", make_node("n0"))
    raw_buf: dict = {}
    eng._drain_apply(("nodes", "RAW", ev_line("ADDED", _obj(make_node("n0"), 1)), 0.0), raw_buf)
    names = [f"gp{i}" for i in range(6)]
    for i, n in enumerate(names):
        pod = _obj(make_pod(n, node="n0"), 10 + i)
        pod["metadata"]["creationTimestamp"] = "2026-01-02T03:04:05Z"
        log.inner.create("pods", copy.deepcopy(pod))
        line = ev_line("ADDED", pod)
        if i == 2:
            line = line.replace(b"2026-01-02T03:04:05Z", b"2026-01-02T03:04:\xff\xfeZ")
        eng._drain_apply(("pods", "RAW", line, 0.0), raw_buf)
    eng._drain_flush(raw_buf)
    assert all(eng.pods.pool.lookup(("default", n)) is not None for n in names)
    for _ in range(3):
        eng.tick_once()
    phases = [log.inner.get("pods", "default", n)["status"]["phase"] for n in names]
    assert phases[:2] + phases[3:] == ["Running"] * 5
