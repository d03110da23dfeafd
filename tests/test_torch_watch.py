"""Watch reflector semantics of the port (kwok_tpu_torch) against kwok_tpu.

- Mock parity: the same seeded writes go into ``kwok_tpu.edge.mockserver
  .FakeKube`` and the port's ``FakeKube``; resumed watches must replay the
  same ``(type, key, resourceVersion)`` sequences (with selectors), and
  both must agree on 410 after ``compact()`` and after window overflow,
  on ``TooLargeResourceVersion``, on ``ValueError`` for a negative
  revision, on bookmarks only to opted-in watches and on continue tokens
  that expire after ``compact()``.
- HTTP wire: the 504 that the port's client turns into
  ``TooLargeResourceVersion``, the 410 ERROR event that sets
  ``w.expired``, 400 for a bad revision, bookmarks over
  ``allow_bookmarks=True``, ``POST /compact`` and the 410 of an expired
  continue token, each on the reference's HTTP mock and on the port's.
- Engine scenarios: the JAX engine and the port's engine (``device="cpu"``)
  each on a ``kwok_tpu`` FakeKube behind a gated pass-through client
  (``tests/test_rv_expiry.py``'s): a resume skips the re-list, a
  compaction in the dark is recovered gap-free, ``TooLargeResourceVersion``
  is retried a bounded number of times, a quiet watch survives a
  compaction on bookmarks, ``resync_streams()`` re-lists, and an rv rewind
  re-lists every stream. Both must reach the same end state with the same
  re-list counts per kind.
- Other topologies: the resume and 410 cases through 2 threaded lanes
  (both packages), 2 process lanes (the port over its HTTP mock, its
  re-list counts held against the JAX single-lane engine's on the same
  scenario; a lane respawn still re-lists) and a 2-member federation
  (both packages; each member resumes on its own).
- The port's native stream resumes from the last revision it received
  while its drain lags (a window smaller than the backlog would 410 a
  resume from the drained revision, as ``kwok_tpu``'s native path does).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from kwok_tpu.edge import mockserver as jmock
from kwok_tpu.edge.httpclient import HttpKubeClient as JaxClient
from kwok_tpu.edge.kubeclient import TooLargeResourceVersion as JaxTooLarge
from kwok_tpu.edge.kubeclient import WatchExpired as JaxExpired
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu_torch.edge import mockserver as tmock
from kwok_tpu_torch.edge.httpclient import HttpKubeClient as PortClient
from kwok_tpu_torch.edge.kubeclient import BOOKMARK, TooLargeResourceVersion, WatchExpired
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from tests.test_rv_expiry import GatedClient
from tests.test_torch_engine import make_node, make_pod
from tests.test_torch_federation import federation

LIBS = ("jax", "torch")
MOCK = {"jax": jmock, "torch": tmock}
EXPIRED = {"jax": JaxExpired, "torch": WatchExpired}
TOO_LARGE = {"jax": JaxTooLarge, "torch": TooLargeResourceVersion}


def wait_for(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ------------------------------------------------------------ mock parity


def seeded_writes(store, seed=7, n=60):
    """A seeded mix of creates, status and label patches and deletes on
    nodes and pods (bound and unbound): one commit each, so both stores
    number them alike."""
    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    for i in range(n):
        op = rng.integers(0, 5) if nodes and pods else i % 2
        if op == 0:
            name = f"n{i}"
            store.create("nodes", make_node(name, labels={"zone": f"z{i % 2}"}))
            nodes.append(name)
        elif op == 1:
            pod = make_pod(f"p{i}", node=f"n{i % 3}")
            if rng.random() < 0.3:
                pod["spec"]["nodeName"] = ""
            store.create("pods", pod)
            pods.append(f"p{i}")
        elif op == 2:
            name = pods[rng.integers(0, len(pods))]
            store.patch_status("pods", "default", name, {"status": {"phase": f"x{i}"}})
        elif op == 3:
            name = nodes[rng.integers(0, len(nodes))]
            store.patch_meta("nodes", None, name, {"metadata": {"labels": {"zone": f"z{i % 3}"}}})
        else:
            store.delete("pods", "default", pods.pop(rng.integers(0, len(pods))), grace_seconds=0)
    return store._rv


def drained(lib, w):
    """Every event queued on an in-process watch, as (type, key, rv)."""
    out = []
    while not w.q.empty():
        ev = w.q.get_nowait()
        if ev is None:
            break
        if lib == "torch":
            ev = (ev[0], json.loads(ev[1]))
        else:
            ev = (ev.type, ev.object)
        meta = ev[1].get("metadata") or {}
        out.append((ev[0], meta.get("namespace", ""), meta.get("name"),
                    meta.get("resourceVersion")))
    return out


def stores():
    return {lib: MOCK[lib].FakeKube() for lib in LIBS}


SELECTORS = [("pods", {}), ("pods", {"field_selector": "spec.nodeName!="}),
             ("nodes", {}), ("nodes", {"label_selector": "zone=z1"})]


@pytest.mark.parametrize("kind,sel", SELECTORS)
def test_resume_replay_matches_reference(kind, sel):
    s = stores()
    rvs = {lib: seeded_writes(st) for lib, st in s.items()}
    assert rvs["jax"] == rvs["torch"]
    for since in (1, 17, 40, rvs["jax"] - 1, rvs["jax"]):
        got = {}
        for lib, st in s.items():
            w = st.watch(kind, resource_version=since, **sel)
            got[lib] = drained(lib, w)
            w.stop()
        assert got["torch"] == got["jax"], since
    assert got["jax"] == []  # resuming at the head replays nothing
    # a resumed watch goes live after its replay
    for lib, st in s.items():
        w = st.watch("nodes", resource_version=rvs[lib])
        st.create("nodes", make_node("late", labels={"zone": "z1"}))
        assert [e[2] for e in drained(lib, w)] == ["late"]
        w.stop()


@pytest.mark.parametrize("how", ["compact", "window"])
def test_expired_after_compact_or_window_overflow(how, monkeypatch):
    if how == "window":
        for m in MOCK.values():
            monkeypatch.setattr(m, "RV_WINDOW", 8)
    s = stores()
    for lib, st in s.items():
        st.create("nodes", make_node("first"))
        old = st._rv
        for i in range(12):
            st.create("nodes", make_node(f"n{i}"))
        if how == "compact":
            assert st.compact() == st._rv
        with pytest.raises(EXPIRED[lib]):
            st.watch("nodes", resource_version=old)
        if how == "window":
            # a revision still inside the window resumes
            w = st.watch("nodes", resource_version=st._rv - 3)
            assert len(drained(lib, w)) == 3
            w.stop()
        else:
            # resuming at the compacted revision itself is gap-free
            st.watch("nodes", resource_version=st._rv).stop()
        # rv-less watches never expire
        st.watch("nodes").stop()


def test_cache_disabled_expires_every_resume(monkeypatch):
    for lib, m in MOCK.items():
        monkeypatch.setattr(m, "RV_WINDOW", 0)
        st = m.FakeKube()
        st.create("nodes", make_node("a"))
        with pytest.raises(EXPIRED[lib]):
            st.watch("nodes", resource_version=st._rv)


def test_too_large_and_negative_revisions():
    for lib, st in stores().items():
        st.create("nodes", make_node("a"))
        with pytest.raises(TOO_LARGE[lib]) as e:
            st.watch("nodes", resource_version=st._rv + 100)
        assert (e.value.rv, e.value.current) == (st._rv + 100, st._rv)
        assert f"Too large resource version: {st._rv + 100}" in str(e.value)
        for bad in (-1, "abc"):
            with pytest.raises(ValueError):
                st.watch("nodes", resource_version=bad)


def test_bookmarks_only_to_opted_in_watches():
    got = {}
    for lib, st in stores().items():
        st.create("nodes", make_node("a"))
        plain = st.watch("nodes")
        opted = [st.watch("nodes", allow_bookmarks=True), st.watch("pods", allow_bookmarks=True)]
        st.create("pods", make_pod("p", node="a"))
        drained(lib, opted[1])
        assert st.emit_bookmarks() == 2
        assert drained(lib, plain) == []
        evs = []
        for w in opted:
            ev = w.q.get_nowait()
            evs.append((ev[0], json.loads(ev[1])) if lib == "torch" else (ev.type, ev.object))
            w.stop()
        plain.stop()
        got[lib] = evs
    assert got["torch"] == got["jax"]
    assert [(t, o["kind"], set(o)) for t, o in got["torch"]] == [
        (BOOKMARK, "Node", {"kind", "apiVersion", "metadata"}),
        (BOOKMARK, "Pod", {"kind", "apiVersion", "metadata"})]
    assert got["torch"][0][1]["metadata"] == {"resourceVersion": "2"}


def test_continue_token_expires_after_compact():
    for lib, st in stores().items():
        for i in range(6):
            st.create("pods", make_pod(f"p{i}"))
        if lib == "jax":
            token = json.loads(st.list_bytes("pods", limit=2))["metadata"]["continue"]
            page = lambda: json.loads(st.list_bytes("pods", limit=2, continue_=token))["items"]  # noqa: E731
        else:
            _items, token, _rv, _n = st.list_bytes("pods", limit=2)
            page = lambda: st.list_bytes("pods", limit=2, continue_=token)[0]  # noqa: E731
        assert len(page()) == 2
        st.create("pods", make_pod("extra"))  # moves the floor past the token
        st.compact()
        with pytest.raises(EXPIRED[lib]):
            page()


# -------------------------------------------------------------- HTTP wire


SERVERS = {"jax-server": jmock.HttpFakeApiserver, "port-server": tmock.HttpFakeApiserver}


@pytest.fixture(params=sorted(SERVERS))
def http_srv(request):
    s = SERVERS[request.param]().start()
    yield s
    s.stop()


def raw_get(url):
    """(status, JSON body) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_too_large_is_504_and_typed(http_srv):
    c = PortClient(http_srv.url)
    try:
        c.create("nodes", make_node("a"))
        future = http_srv.store._rv + 100
        q = urllib.parse.urlencode({"watch": "true", "resourceVersion": str(future)})
        code, body = raw_get(f"{http_srv.url}/api/v1/nodes?{q}")
        doc = json.loads(body)
        assert code == 504 and doc["reason"] == "Timeout" and doc["code"] == 504
        assert doc["details"] == {
            "causes": [{"reason": "ResourceVersionTooLarge",
                        "message": "Too large resource version"}],
            "retryAfterSeconds": 1}
        with pytest.raises(TooLargeResourceVersion) as e:
            c.watch("nodes", resource_version=future)
        assert (e.value.rv, e.value.current, e.value.retry_after) == (
            future, http_srv.store._rv, 1.0)
    finally:
        c.close()


def test_http_resume_replays_then_410_after_compact(http_srv):
    c = PortClient(http_srv.url)
    try:
        c.create("nodes", make_node("a"))
        rv = http_srv.store._rv
        c.create("nodes", make_node("b"))
        w = c.watch("nodes", resource_version=rv)
        assert next(iter(w)).object["metadata"]["name"] == "b"
        w.stop()
        req = urllib.request.Request(http_srv.url + "/compact", method="POST")
        assert json.loads(urllib.request.urlopen(req).read()) == {
            "compactedRevision": http_srv.store._rv}
        w2 = c.watch("nodes", resource_version=rv)
        assert list(w2) == [] and w2.expired
    finally:
        c.close()


@pytest.mark.parametrize("rv", ["abc", "-1"])
def test_http_bad_revision_is_400(http_srv, rv):
    q = urllib.parse.urlencode({"watch": "true", "resourceVersion": rv})
    assert raw_get(f"{http_srv.url}/api/v1/pods?{q}")[0] == 400


def test_http_bookmarks_through_client(http_srv):
    c = PortClient(http_srv.url)
    try:
        c.create("nodes", make_node("a"))
        w = c.watch("nodes", allow_bookmarks=True)
        it = iter(w)
        assert wait_for(lambda: http_srv.store.emit_bookmarks() >= 1, 5)
        ev = next(it)
        assert ev.type == BOOKMARK and set(ev.object) == {"kind", "apiVersion", "metadata"}
        assert ev.object["metadata"]["resourceVersion"] == str(http_srv.store._rv)
        w.stop()
    finally:
        c.close()


def test_http_expired_continue_is_410(http_srv):
    c = PortClient(http_srv.url)
    try:
        for i in range(6):
            c.create("pods", make_pod(f"p{i}"))
        code, body = raw_get(http_srv.url + "/api/v1/pods?limit=2")
        token = json.loads(body)["metadata"]["continue"]
        c.create("pods", make_pod("extra"))
        http_srv.store.compact()
        q = urllib.parse.urlencode({"limit": 2, "continue": token})
        code, body = raw_get(f"{http_srv.url}/api/v1/pods?{q}")
        assert code == 410 and json.loads(body)["reason"] == "Expired"
        assert len(c.list("pods")) == 7  # the client's list restarts cleanly
    finally:
        c.close()


def test_port_server_bookmark_timer(monkeypatch):
    """The HTTP mock's timer sends bookmarks every BOOKMARK_INTERVAL s and
    stops with the server."""
    monkeypatch.setattr(tmock, "BOOKMARK_INTERVAL", 0.1)
    srv = tmock.HttpFakeApiserver().start()
    c = PortClient(srv.url)
    try:
        w = c.watch("pods", allow_bookmarks=True)
        assert next(iter(w)).type == BOOKMARK
        w.stop()
    finally:
        c.close()
        srv.stop()
    assert not srv._bookmark_thread.is_alive()


# --------------------------------------------------------- engine scenarios


class Client(GatedClient):
    """The gated pass-through client, recording every LIST's kind and
    monotonic start. For the port's engine (``lib="torch"``) it raises the
    store's WatchExpired and TooLargeResourceVersion as the port's own
    types, as its HTTP client would."""

    def __init__(self, store, lib="jax"):
        super().__init__(store)
        self.lib = lib
        self.lists: list = []

    def list(self, kind, **kw):
        self.lists.append((kind, time.monotonic()))
        return super().list(kind, **kw)

    def watch(self, *a, **kw):
        try:
            return super().watch(*a, **kw)
        except JaxExpired as e:
            if self.lib == "jax":
                raise
            raise WatchExpired(str(e)) from e
        except JaxTooLarge as e:
            if self.lib == "jax":
                raise
            raise TooLargeResourceVersion(e.rv, e.current, e.retry_after) from e

    def count(self, kind, since=0.0):
        return sum(1 for k, t in self.lists if k == kind and t >= since)


def start_engine(lib, client, **cfg):
    if lib == "jax":
        eng = JaxEngine(client, JaxConfig(manage_all_nodes=True, tick_interval=0.02, **cfg))
    else:
        eng = TorchEngine(client, TorchConfig(
            manage_all_nodes=True, tick_interval=0.02, device="cpu", **cfg))
    eng.start()
    return eng


def running(store):
    return sorted(p["metadata"]["name"] for p in store.list("pods")
                  if (p.get("status") or {}).get("phase") == "Running")


def node_ready(store, name):
    n = store.get("nodes", None, name) or {}
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in (n.get("status") or {}).get("conditions") or [])


def break_streams(store):
    for w in list(store._watches):
        w.stop()


def relists(client, since):
    return {k: client.count(k, since) for k in ("nodes", "pods")}


def settle(client, eng, store, pods, node="n0"):
    """n0 and ``pods`` pods created and Running, the resume revisions
    past them."""
    store.create("nodes", make_node(node))
    for i in range(pods):
        store.create("pods", make_pod(f"p{i}", node=node))
    assert wait_for(lambda: len(running(store)) == pods)
    time.sleep(0.2)


def resume_skips_relist(lib, **cfg):
    store = jmock.FakeKube()
    client = Client(store, lib)
    eng = start_engine(lib, client, **cfg)
    try:
        settle(client, eng, store, 5)
        client.gate.clear()
        break_streams(store)
        for i in range(5, 15):
            store.create("pods", make_pod(f"p{i}", node="n0"))
        store.delete("pods", "default", "p0", grace_seconds=0)
        t0 = time.monotonic()
        client.gate.set()
        assert wait_for(lambda: len(running(store)) == 14)
        return running(store), relists(client, t0)
    finally:
        client.gate.set()
        eng.stop()


def compaction_in_the_dark(lib, **cfg):
    store = jmock.FakeKube()
    client = Client(store, lib)
    eng = start_engine(lib, client, **cfg)
    try:
        for n in range(3):
            store.create("nodes", make_node(f"n{n}"))
        for i in range(12):
            store.create("pods", make_pod(f"p{i}", node=f"n{i % 3}"))
        assert wait_for(lambda: len(running(store)) == 12)
        time.sleep(0.2)
        client.gate.clear()
        break_streams(store)
        for i in range(12, 30):
            store.create("pods", make_pod(f"p{i}", node=f"n{i % 3}"))
        for i in range(4):
            store.delete("pods", "default", f"p{i}", grace_seconds=0)
        store.create("nodes", make_node("n3"))
        store.compact()
        t0 = time.monotonic()
        client.gate.set()
        assert wait_for(lambda: len(running(store)) == 26 and node_ready(store, "n3"))
        time.sleep(0.2)
        return running(store), relists(client, t0)
    finally:
        client.gate.set()
        eng.stop()


def too_large_retries(lib):
    store = jmock.FakeKube()
    client = Client(store, lib)
    raises = []
    orig = store.watch

    def watch(kind, **kw):
        rv = kw.get("resource_version") or 0
        if kind == "nodes" and rv:
            raises.append(rv)
            raise TOO_LARGE[lib](int(rv), 1, retry_after=0.1)
        return orig(kind, **kw)

    client.watch = watch
    eng = start_engine(lib, client)
    try:
        store.create("nodes", make_node("n0"))
        assert wait_for(lambda: node_ready(store, "n0"))
        time.sleep(0.2)
        t0 = time.monotonic()
        eng._watches["nodes"].stop()
        assert wait_for(lambda: client.count("nodes", t0) >= 1)
        time.sleep(0.2)
        store.create("nodes", make_node("n1"))
        assert wait_for(lambda: node_ready(store, "n1"))
        return len(raises), relists(client, t0)
    finally:
        eng.stop()


def quiet_watch_bookmarks(lib):
    store = jmock.FakeKube()
    client = Client(store, lib)
    eng = start_engine(lib, client)
    try:
        store.create("nodes", make_node("n1"))
        assert wait_for(lambda: node_ready(store, "n1"))
        time.sleep(0.2)
        t0 = time.monotonic()
        b0 = eng.metrics["watch_bookmarks_total"]
        for i in range(10):  # pods churn; nodes stay quiet
            store.create("pods", make_pod(f"bm{i}", node="elsewhere"))
        store.emit_bookmarks()
        assert wait_for(lambda: eng.metrics["watch_bookmarks_total"] >= b0 + 2)
        store.compact()
        eng._watches["nodes"].stop()
        eng._watches["pods"].stop()
        store.create("nodes", make_node("n2"))
        assert wait_for(lambda: node_ready(store, "n2"))
        return eng.metrics["watch_bookmarks_total"] - b0, relists(client, t0)
    finally:
        eng.stop()


def resync_streams_relists(lib):
    store = jmock.FakeKube()
    client = Client(store, lib)
    eng = start_engine(lib, client)
    try:
        settle(client, eng, store, 3)
        t0 = time.monotonic()
        eng.resync_streams()
        assert wait_for(lambda: client.count("pods", t0) and client.count("nodes", t0))
        store.create("pods", make_pod("after", node="n0"))
        assert wait_for(lambda: len(running(store)) == 4)
        time.sleep(0.2)
        return running(store), relists(client, t0)
    finally:
        eng.stop()


def rv_rewind(lib):
    """A store restore (``FakeKube.load`` of an earlier dump): every
    re-listed object is below its ingested revision."""
    store = jmock.FakeKube()
    client = Client(store, lib)
    eng = start_engine(lib, client)
    try:
        store.create("nodes", make_node("n0"))
        for i in range(6):
            store.create("pods", make_pod(f"p{i}", node="n0"))
        snap = store.dump()
        assert wait_for(lambda: len(running(store)) == 6)
        time.sleep(0.2)
        store.load(snap)
        assert wait_for(lambda: eng.metrics["rv_rewinds_total"] >= 1)
        at = eng._rv_rewind_at
        # a second rewind inside 5 s is not acted on
        eng._note_rv_rewind("pods", "p0", 1, 2)
        rewinds = eng.metrics["rv_rewinds_total"]
        # every stream re-lists after the rewind was noted
        assert wait_for(lambda: client.count("nodes", at) and client.count("pods", at))
        assert wait_for(lambda: len(running(store)) == 6)
        return running(store), rewinds
    finally:
        eng.stop()


SCENARIOS = {
    "resume_skips_relist": (resume_skips_relist, (
        sorted(f"p{i}" for i in range(1, 15)), {"nodes": 0, "pods": 0})),
    "compaction_in_the_dark": (compaction_in_the_dark, (
        sorted(f"p{i}" for i in range(4, 30)), {"nodes": 1, "pods": 1})),
    "too_large_retries": (too_large_retries, (3, {"nodes": 1, "pods": 0})),
    "quiet_watch_bookmarks": (quiet_watch_bookmarks, (2, {"nodes": 0, "pods": 0})),
    "resync_streams_relists": (resync_streams_relists, (
        sorted(["after", "p0", "p1", "p2"]), {"nodes": 1, "pods": 1})),
    "rv_rewind": (rv_rewind, ([f"p{i}" for i in range(6)], 1)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_scenario_matches_jax(name):
    fn, want = SCENARIOS[name]
    got = {lib: fn(lib) for lib in LIBS}
    assert got["jax"] == want
    assert got["torch"] == got["jax"]


# -------------------------------------------------------- other topologies


@pytest.mark.parametrize("name", ["resume_skips_relist", "compaction_in_the_dark"])
def test_threaded_lanes_scenario_matches_jax(name):
    fn, want = SCENARIOS[name]
    got = {lib: fn(lib, drain_shards=2) for lib in LIBS}
    assert got["jax"] == want
    assert got["torch"] == got["jax"]


def test_process_lanes_resume_410_and_respawn_relist():
    """The parent of 2 process lanes over the port's HTTP mock: a cut
    stream resumes (no re-list, as the JAX single-lane engine in
    ``resume_skips_relist``), a cut after a compaction re-lists that kind
    once (as in ``compaction_in_the_dark``), and a lane respawn re-lists
    every stream."""
    store = tmock.FakeKube()
    srv = tmock.HttpFakeApiserver(store=store).start()
    eng = TorchEngine(PortClient(srv.url), TorchConfig(
        manage_all_nodes=True, tick_interval=0.05, drain_shards=2,
        lane_procs=True, device="cpu"))

    def n_running():
        return store.count("pods", lambda p: p["status"].get("phase") == "Running")

    try:
        eng.start()
        assert wait_for(lambda: eng.ready, 60)
        store.create("nodes", make_node("n0"))
        for i in range(6):
            store.create("pods", make_pod(f"p{i}", node="n0"))
        assert wait_for(lambda: n_running() == 6, 30)
        relists0 = eng.metrics["watch_relists_total"]
        eng._watches["pods"].stop()
        for i in range(6, 10):
            store.create("pods", make_pod(f"p{i}", node="n0"))
        assert wait_for(lambda: n_running() == 10)
        assert eng.metrics["watch_relists_total"] == relists0
        # a write the pods stream never sees puts its revision below the floor
        store.patch_meta("nodes", None, "n0", {"metadata": {"labels": {"a": "b"}}})
        store.compact()
        eng._watches["pods"].stop()
        store.create("pods", make_pod("p10", node="n0"))
        assert wait_for(lambda: n_running() == 11)
        assert wait_for(lambda: eng.metrics["watch_relists_total"] == relists0 + 1)
        assert eng._proc.lanes[0].sigkill()
        assert wait_for(lambda: eng._proc.status()[0]["restarts"] == 1, 30)
        assert wait_for(lambda: eng.metrics["watch_relists_total"] >= relists0 + 3, 30)
        store.create("pods", make_pod("p11", node="n0"))
        assert wait_for(lambda: n_running() == 12, 30)
    finally:
        eng.stop()
        srv.stop()


def fed_scenario(lib):
    """2 members: a cut of member 0's pods stream resumes; a compaction
    of member 1's store and a cut of both its streams re-list member 1
    alone, once per kind."""
    stores_ = [jmock.FakeKube() for _ in range(2)]
    clients = [Client(s, lib) for s in stores_]
    fed = federation(lib, clients, tick_interval=0.02)
    fed.start()
    try:
        for c, s in enumerate(stores_):
            s.create("nodes", make_node(f"c{c}-n0"))
            for i in range(4):
                s.create("pods", make_pod(f"c{c}-p{i}", node=f"c{c}-n0"))
        assert wait_for(lambda: all(len(running(s)) == 4 for s in stores_))
        time.sleep(0.2)
        t0 = time.monotonic()
        fed.engines[0]._watches["pods"].stop()
        stores_[0].create("pods", make_pod("c0-p4", node="c0-n0"))
        assert wait_for(lambda: len(running(stores_[0])) == 5)
        clients[1].gate.clear()
        break_streams(stores_[1])
        stores_[1].create("pods", make_pod("c1-p4", node="c1-n0"))
        stores_[1].compact()
        clients[1].gate.set()
        assert wait_for(lambda: len(running(stores_[1])) == 5)
        time.sleep(0.2)
        return [relists(c, t0) for c in clients]
    finally:
        clients[1].gate.set()
        fed.stop()


def test_federation_members_resume_on_their_own():
    got = {lib: fed_scenario(lib) for lib in LIBS}
    assert got["jax"] == [{"nodes": 0, "pods": 0}, {"nodes": 1, "pods": 1}]
    assert got["torch"] == got["jax"]


def test_native_resume_rides_the_received_revision_past_a_stalled_drain(monkeypatch):
    """A pods stream cut while the drain holds 40 unread events resumes at
    the last revision it received: a 16-event window would 410 a resume
    from the drained revision (a re-list); this one replays nothing and
    re-lists nothing, and every pod still goes Running."""
    monkeypatch.setattr(tmock, "RV_WINDOW", 16)
    srv = tmock.HttpFakeApiserver().start()
    store = srv.store
    resumes = []
    watch = store.watch

    def recording_watch(kind, **kw):
        if kind == "pods" and kw.get("resource_version"):
            resumes.append(int(kw["resource_version"]))
        return watch(kind, **kw)

    store.watch = recording_watch
    store.create("nodes", make_node("n0"))
    eng = TorchEngine(PortClient(srv.url), TorchConfig(
        manage_all_nodes=True, device="cpu", tick_interval=0.02, drain_shards=1))

    def running(name):
        return ((store.get("pods", "default", name) or {}).get("status") or {}).get(
            "phase") == "Running"

    def wait(pred, timeout=15.0):
        deadline = time.time() + timeout
        while time.time() < deadline and not pred():
            time.sleep(0.02)
        return pred()

    eng.start()
    gate = threading.Event()
    try:
        assert wait(lambda: eng.ready)
        store.create("pods", make_pod("p-first", node="n0"))  # a drained revision
        assert wait(lambda: running("p-first") and eng._watch_rv.get("pods"))
        relists0 = eng.metrics["watch_relists_total"]
        drain = eng._drain_apply

        def stalled(*a, **kw):
            gate.wait(15)
            return drain(*a, **kw)

        eng._drain_apply = stalled
        for i in range(40):
            store.create("pods", make_pod(f"p{i}", node="n0"))
        last = max(int(p["metadata"]["resourceVersion"]) for p in store.list("pods"))
        # the server has written every event; the reader takes it off the
        # socket while the drain waits
        assert wait(lambda: all(w.q.empty() for w in store._watches))
        time.sleep(0.3)
        drained = eng._watch_rv["pods"]
        assert drained < last - 16  # a resume from it would be past the window
        old = eng._watches["pods"]
        old.stop()
        assert wait(lambda: eng._watches["pods"] is not old)
        assert resumes == [last]
        gate.set()
        eng._drain_apply = drain
        assert wait(lambda: all(running(f"p{i}") for i in range(40)))
        assert eng.metrics["watch_relists_total"] == relists0
    finally:
        gate.set()
        eng.stop()
        srv.stop()


def test_resume_revision_parse_is_safe_beside_the_drain_parser():
    """Both watch threads read their resume revision while the drain
    parses single lines with the same parser: the resume parse must use
    buffers of its own (the single-line parse reuses, and regrows, the
    parser's). Every revision read on every thread must be its line's;
    before the repair two threads in the single-line parse at once wrote
    into each other's buffers (a segfault under the drift phase's storm)."""
    from kwok_tpu_torch import native

    if not native.available():
        pytest.skip("no native library")
    eng = TorchEngine(tmock.FakeKube(), TorchConfig(manage_all_nodes=True, device="cpu"))
    parser = eng._batch_parser
    assert parser is not None
    eng._watch_rv["pods"] = 1

    def line(rv: int, pad: int) -> bytes:
        return json.dumps({"type": "MODIFIED", "object": {"metadata": {
            "name": f"p{rv}", "namespace": "default", "resourceVersion": str(rv),
            "labels": {"pad": "x" * pad}}}}).encode()

    wrong: list = []
    stop = threading.Event()

    def resumes(seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            rv = int(rng.integers(2, 10**9))
            got = eng._resume_rv("pods", line(rv, int(rng.integers(0, 20_000))), parser)
            if got != rv:
                wrong.append((rv, got))

    threads = [threading.Thread(target=resumes, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    rng = np.random.default_rng(3)
    try:
        for _ in range(3_000):  # the drain's single-line parses, regrowing the buffer
            rv = int(rng.integers(2, 10**9))
            assert parser.parse(line(rv, int(rng.integers(0, 20_000)))).rv == rv
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert wrong == []
