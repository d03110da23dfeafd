"""The port's single-lane engine (kwok_tpu_torch.engine) against the JAX
engine (kwok_tpu.engine) on the CPU.

Each scenario of tests/test_engine.py runs twice on kwok_tpu's FakeKube:
once through the JAX engine and once through the port's engine on
device="cpu", both pumped synchronously (drain the queue, tick once). The
final apiserver objects must match exactly with timestamps masked, and so
must the engines' patch counters. One more test runs the port's threaded
engine end to end against the port's own FakeKube.
"""

from __future__ import annotations

import threading
import time

import pytest

from kwok_tpu.edge.kubeclient import TooManyRequests as JaxTooManyRequests
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.telemetry.errors import wire_rejects_total as jax_rejects
from kwok_tpu_torch.edge.kubeclient import TooManyRequests
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.telemetry.errors import wire_rejects_total as port_rejects
from tests.fake_apiserver import FakeKube
from tests.test_lanes import _pump


def make_node(name, annotations=None, labels=None, status=None):
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "annotations": annotations or {},
            "labels": labels or {},
        },
        **({"status": status} if status else {}),
    }


def make_pod(name, node="node0", ns="default", annotations=None, finalizers=None):
    meta = {"name": name, "namespace": ns, "annotations": annotations or {}}
    if finalizers:
        meta["finalizers"] = finalizers
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": {
            "nodeName": node,
            "containers": [{"name": "c", "image": "busybox"}],
        },
        "status": {"phase": "Pending"},
    }


def sync_engine(lib: str, server, **cfg):
    """An engine of either package with test_engine.SyncEngine's pump()
    and feed_all(), plus the rig's watch drains (watch=True)."""
    base, config = (
        (JaxEngine, JaxConfig(**cfg)) if lib == "jax"
        else (TorchEngine, TorchConfig(device="cpu", **cfg))
    )

    class Sync(base):
        drains: list = []

        def pump(self, n=1):
            for _ in range(n):
                for d in self.drains:
                    d()
                while not self._q.empty():
                    item = self._q.get_nowait()
                    if item:
                        self._ingest(*item)
                self.tick_once()

        def feed_all(self, server):
            for obj in server.list("nodes"):
                self._q.put(("nodes", "ADDED", obj))
            for obj in server.list("pods", field_selector="spec.nodeName!="):
                self._q.put(("pods", "ADDED", obj))

        def watch(self, server):
            """Route the server's watch events into the ingest queue."""
            self.drains = []
            for kind, sel in (("nodes", {}), ("pods", {"field_selector": "spec.nodeName!="})):
                w = server.watch(kind, **sel)

                def drain(w=w, kind=kind):
                    while not w.q.empty():
                        ev = w.q.get_nowait()
                        if ev:
                            self._q.put((kind, ev.type, ev.object))

                self.drains.append(drain)

    return Sync(server, config)


# --------------------------------------------------------------- scenarios
# each takes the engine library name, runs one test_engine.py scenario and
# returns (server, engine)


def rig(lib, **cfg):
    server = FakeKube()
    eng = sync_engine(lib, server, manage_all_nodes=True, **cfg)
    eng.watch(server)
    return server, eng


def node_becomes_ready(lib):
    server, eng = rig(lib)
    server.create("nodes", make_node("node0"))
    eng.pump(2)
    conds = {c["type"]: c["status"] for c in server.get("nodes", None, "node0")["status"]["conditions"]}
    assert conds["Ready"] == "True"
    return server, eng


def unmanaged_node_untouched(lib):
    server = FakeKube()
    eng = sync_engine(lib, server, manage_nodes_with_annotation_selector="kwok=manage")
    server.create("nodes", make_node("managed", annotations={"kwok": "manage"}))
    server.create("nodes", make_node("xxxx"))
    eng.feed_all(server)
    eng.pump(2)
    assert "status" in server.get("nodes", None, "managed")
    assert "status" not in server.get("nodes", None, "xxxx")
    return server, eng


def pod_becomes_running_with_ip(lib):
    server, eng = rig(lib)
    server.create("nodes", make_node("node0"))
    eng.pump(2)
    server.create("pods", make_pod("pod0"))
    eng.pump(2)
    st = server.get("pods", "default", "pod0")["status"]
    assert st["phase"] == "Running" and st["podIP"].startswith("10.0.0.")
    return server, eng


def pod_on_unmanaged_node_untouched(lib):
    server, eng = rig(lib)
    server.create("pods", make_pod("orphan", node="no-such-node"))
    eng.pump(2)
    assert server.get("pods", "default", "orphan")["status"]["phase"] == "Pending"
    return server, eng


def pod_deletion_grace_and_finalizers(lib):
    server, eng = rig(lib)
    server.create("nodes", make_node("node0"))
    server.create("pods", make_pod("pod0", finalizers=["kwok.dev/guard"]))
    eng.pump(2)
    assert server.get("pods", "default", "pod0")["status"]["phase"] == "Running"
    server.delete("pods", "default", "pod0", grace_seconds=30)
    eng.pump(3)
    assert server.get("pods", "default", "pod0") is None
    assert server.delete_count == 1
    return server, eng


def disregard_annotation_status_sticks(lib):
    server = FakeKube()
    eng = sync_engine(
        lib, server, manage_all_nodes=True,
        disregard_status_with_annotation_selector="kwok.x-k8s.io/status=custom",
    )
    server.create("nodes", make_node("weird", annotations={"kwok.x-k8s.io/status": "custom"}))
    server.create("nodes", make_node("normal"))
    server.create("pods", make_pod("weirdpod", node="normal",
                                   annotations={"kwok.x-k8s.io/status": "custom"}))
    eng.feed_all(server)
    eng.pump(2)
    assert "status" not in server.get("nodes", None, "weird")
    server.patch_status("pods", "default", "weirdpod", {"status": {"phase": "Failed"}})
    eng.pump(3)
    assert server.get("pods", "default", "weirdpod")["status"]["phase"] == "Failed"
    return server, eng


def heartbeat_refreshes_conditions(lib):
    server = FakeKube()
    eng = sync_engine(lib, server, manage_all_nodes=True, heartbeat_interval=0.0)
    for i in range(3):
        server.create("nodes", make_node(f"node{i}"))
    eng.feed_all(server)
    eng.pump(2)
    hb1 = eng.metrics["heartbeats_total"]
    eng.pump(2)
    assert eng.metrics["heartbeats_total"] > hb1
    return server, eng


def tick_substeps_full_lifecycle(lib):
    server = FakeKube()
    eng = sync_engine(lib, server, manage_all_nodes=True, tick_substeps=4)
    server.create("nodes", make_node("sub-node"))
    server.create("pods", make_pod("sub-pod", node="sub-node"))
    eng.feed_all(server)
    eng.pump(3)
    assert server.get("pods", "default", "sub-pod")["status"]["phase"] == "Running"
    assert eng._get_fused().steps == 4
    return server, eng


SCENARIOS = {
    f.__name__: f
    for f in (
        node_becomes_ready,
        unmanaged_node_untouched,
        pod_becomes_running_with_ip,
        pod_on_unmanaged_node_untouched,
        pod_deletion_grace_and_finalizers,
        disregard_annotation_status_sticks,
        heartbeat_refreshes_conditions,
        tick_substeps_full_lifecycle,
    )
}

_TIME_KEYS = ("Time", "Timestamp", "startedAt", "finishedAt")


def masked(v):
    """Replace every timestamp value with a marker, recursively."""
    if isinstance(v, dict):
        return {
            k: ("<time>" if k.endswith(_TIME_KEYS) else masked(x))
            for k, x in v.items()
        }
    if isinstance(v, list):
        return [masked(x) for x in v]
    return v


def snapshot(server, eng):
    objs = {kind: masked(server.list(kind)) for kind in ("nodes", "pods")}
    m = eng.metrics
    counters = {
        k: m[k] for k in ("status_patches_total", "heartbeats_total",
                          "deletes_total", "transitions_total")
    }
    return objs, counters, server.delete_count


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_engine_matches_jax_engine(name):
    ref = snapshot(*SCENARIOS[name]("jax"))
    got = snapshot(*SCENARIOS[name]("torch"))
    assert got == ref


# ----------------------------------------------- faults found against the JAX engine


def pod_row(eng, key):
    """(rv, labels) of a pod's row (the owning lane's under lanes), or
    None when the pod has no row."""
    e = eng
    if eng._lanes is not None:
        e = eng._lanes.lanes[shard_of(key, eng._lanes.n)].engine
    idx = e.pods.pool.lookup(key)
    if idx is None:
        return None
    m = e.pods.pool.meta[idx]
    return m["rv"], ((m.get("obj") or {}).get("metadata") or {}).get("labels")


def stale_replay(lib, shards):
    """ADDED p0 at rv 10, then a MODIFIED at rv 5 and a DELETED at rv 6
    (a replay older than the row): p0's row and the stale_rv count."""
    rejects = jax_rejects if lib == "jax" else port_rejects
    eng = sync_engine(lib, FakeKube(), manage_all_nodes=True, drain_shards=shards)
    before = rejects("stale_rv")
    for type_, rv, labels in (("ADDED", 10, {}), ("MODIFIED", 5, {"old": "world"}),
                              ("DELETED", 6, {})):
        pod = make_pod("p0")
        pod["metadata"].update(resourceVersion=str(rv), labels=labels)
        eng._q.put(("pods", type_, pod))
    _pump(eng, 1)
    return pod_row(eng, ("default", "p0")), rejects("stale_rv") - before


@pytest.mark.parametrize("shards", [1, 2])
def test_stale_events_are_dropped_as_in_jax(shards):
    """A MODIFIED or DELETED below the row's last ingested revision is
    dropped and counted (kwok_wire_rejects_total{reason="stale_rv"}),
    directly and through 2 threaded lanes."""
    ref = stale_replay("jax", shards)
    assert ref == ((10, {}), 2)
    assert stale_replay("torch", shards) == ref


def test_patch_retries_ride_out_a_5s_outage():
    """A patch whose apiserver is down for 5 s is retried until it lands
    (PATCH_RETRY's 8 s deadline), in both packages at once."""
    got = {}

    def run(lib):
        eng = sync_engine(lib, FakeKube(), manage_all_nodes=True)
        eng._running = True
        t0 = time.monotonic()
        calls = []

        def patch():
            calls.append(time.monotonic() - t0)
            if calls[-1] < 5.0:
                raise ConnectionRefusedError("apiserver down")

        eng._safe(patch)
        got[lib] = (eng.metrics["patch_errors_total"], calls[-1] >= 5.0)

    threads = [threading.Thread(target=run, args=(lib,)) for lib in ("jax", "torch")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15)
    assert got["jax"] == (0, True)
    assert got["torch"] == got["jax"]


class ThrottledLists:
    """A FakeKube pass-through whose LISTs answer 429 (Retry-After 1 s)
    for ``seconds`` from the first; records each LIST's kind and time."""

    def __init__(self, store, too_many, seconds=3.0):
        self._store = store
        self._too_many = too_many
        self._t0 = None
        self._seconds = seconds
        self.lists = []

    def list(self, kind, **kw):
        t = time.monotonic()
        self.lists.append((kind, t))
        if self._t0 is None:
            self._t0 = t
        if t - self._t0 < self._seconds:
            raise self._too_many("Too many requests", retry_after=1.0)
        return self._store.list(kind, **kw)

    def __getattr__(self, name):
        return getattr(self._store, name)


def throttled_relists(lib):
    """The watch loops against 429-answering LISTs: the seconds between
    each kind's LISTs and the throttle seconds the engine counted."""
    too_many = JaxTooManyRequests if lib == "jax" else TooManyRequests
    client = ThrottledLists(FakeKube(), too_many)
    eng = (JaxEngine(client, JaxConfig(manage_all_nodes=True)) if lib == "jax"
           else TorchEngine(client, TorchConfig(manage_all_nodes=True, device="cpu")))
    eng.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not eng.ready:
            time.sleep(0.02)
        assert eng.ready
    finally:
        eng.stop()
    gaps = []
    for kind in ("nodes", "pods"):
        ts_ = [t for k, t in client.lists if k == kind]
        gaps += [b - a for a, b in zip(ts_, ts_[1:])]
    throttle = (eng.telemetry.client_throttle_seconds if lib == "jax"
                else eng.metrics["client_throttle_seconds_total"])
    return gaps, throttle


def test_watch_loop_honours_retry_after_as_jax():
    """A 429 on the LIST sleeps at least its Retry-After (1 s) and counts
    the sleep in kwok_client_throttle_seconds_total."""
    for lib in ("jax", "torch"):
        gaps, throttle = throttled_relists(lib)
        assert len(gaps) >= 4 and min(gaps) >= 1.0, (lib, gaps)
        assert throttle >= 2.0, (lib, throttle)


def test_threaded_engine_end_to_end_on_port_fakekube():
    """Real threads, watches and executor against the port's own FakeKube:
    nodes Ready, pods Running with pool IPs, finalizer-guarded deletes."""
    server = PortFakeKube()
    eng = TorchEngine(server, TorchConfig(manage_all_nodes=True, tick_interval=0.02, device="cpu"))
    eng.start()
    threads = list(eng._threads)
    try:
        for i in range(4):
            server.create("nodes", make_node(f"n{i}"))
        for i in range(40):
            server.create("pods", make_pod(f"p{i}", node=f"n{i % 4}", finalizers=["x/y"]))
        deadline = time.time() + 20
        while time.time() < deadline:
            pods = server.list("pods")
            if all(p["status"]["phase"] == "Running" for p in pods):
                break
            time.sleep(0.05)
        pods = server.list("pods")
        assert all(p["status"]["phase"] == "Running" for p in pods)
        assert len({p["status"]["podIP"] for p in pods}) == 40
        for n in server.list("nodes"):
            conds = {c["type"]: c["status"] for c in n["status"]["conditions"]}
            assert conds["Ready"] == "True"
        for i in range(10):
            server.delete("pods", "default", f"p{i}", grace_seconds=30)
        deadline = time.time() + 20
        while time.time() < deadline and server.count("pods") > 30:
            time.sleep(0.05)
        assert server.count("pods") == 30
        assert eng.metrics["deletes_total"] == 10
    finally:
        eng.stop()
    assert threads and not any(t.is_alive() for t in threads)
