"""The port's CNI hook (``kwok_tpu_torch/cni``) and the engine's CNI paths
held against ``kwok_tpu``'s on the CPU.

- The cases of ``tests/test_log_cni.py:58-151``, each run through both
  packages: the stub is unavailable and raises; a registered provider's
  round trip; a pod deleted while ``cni.setup`` is in flight has its
  allocation undone; the engine takes the provider's IP and releases it
  on the Deleted event (the final objects equal, timestamps masked).
- ``load_from_env`` on ``KWOK_TPU_CNI_PROVIDER`` ("module" and
  "module:attr"; an unloadable name raises RuntimeError).
- The same end to end on 2 threaded lanes and in a 2-member federation:
  every pod Running with the provider's IP (all distinct), one remove per
  deleted pod.
- Process lanes: the lane processes are spawned and never load a provider,
  so with ``enable_cni`` and a provider in the parent (and named by the
  variable) their pods take IPs from the pool, in ``kwok_tpu`` and in the
  port alike.
"""

from __future__ import annotations

import importlib
import ipaddress
import threading
import time

import pytest

from kwok_tpu import cni as jax_cni
from kwok_tpu.edge.httpclient import HttpKubeClient as JaxClient
from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
from kwok_tpu.edge.mockserver import HttpFakeApiserver as JaxHttpApiserver
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu_torch import cni as port_cni
from kwok_tpu_torch.edge.httpclient import HttpKubeClient as PortClient
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver as PortHttpApiserver
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from tests.test_torch_engine import make_node, make_pod, masked, sync_engine
from tests.test_torch_federation import federation

LIBS = ("jax", "torch")
CNI = {"jax": jax_cni, "torch": port_cni}
POOL = ipaddress.ip_network("10.0.0.0/24")  # EngineConfig's default cidr


@pytest.fixture(autouse=True)
def _reset():
    yield
    jax_cni._provider = None
    port_cni._provider = None


class Provider:
    """A CNI provider handing out distinct IPs from 10.77.0.0/16 and
    recording every setup and remove."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.setups: list = []
        self.removes: list = []

    def setup(self, ns, name, uid):
        with self._lock:
            self.setups.append(name)
            n = len(self.setups)
        return [f"10.77.{n // 250}.{n % 250 + 1}"]

    def remove(self, ns, name, uid):
        with self._lock:
            self.removes.append(name)


# named by KWOK_TPU_CNI_PROVIDER in the loader and process-lane cases
ENV_PROVIDER = Provider()
# this module as a provider ("module" without an attribute)
setup = ENV_PROVIDER.setup
remove = ENV_PROVIDER.remove


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _status(store, name, ns="default"):
    return (store.get("pods", ns, name) or {}).get("status") or {}


# ------------------------------------------------------ test_log_cni twins


@pytest.mark.parametrize("lib", LIBS)
def test_cni_stub_unavailable(lib):
    c = CNI[lib]
    assert not c.available()
    with pytest.raises(RuntimeError):
        c.setup("ns", "p", "uid")
    with pytest.raises(RuntimeError):
        c.remove("ns", "p", "uid")


@pytest.mark.parametrize("lib", LIBS)
def test_cni_provider_roundtrip(lib):
    c = CNI[lib]
    calls = []
    c.register(
        lambda ns, n, u: (calls.append(("setup", ns, n, u)) or ["10.9.0.7"]),
        lambda ns, n, u: calls.append(("remove", ns, n, u)),
    )
    assert c.available()
    assert c.setup("ns", "p", "u1") == ["10.9.0.7"]
    c.remove("ns", "p", "u1")
    assert calls == [("setup", "ns", "p", "u1"), ("remove", "ns", "p", "u1")]


@pytest.mark.parametrize("lib", LIBS)
def test_load_from_env(lib, monkeypatch):
    c = CNI[lib]
    monkeypatch.delenv("KWOK_TPU_CNI_PROVIDER", raising=False)
    assert c.load_from_env() is False and not c.available()
    monkeypatch.setenv("KWOK_TPU_CNI_PROVIDER", "tests.test_torch_cni:ENV_PROVIDER")
    assert c.load_from_env() is True
    assert c.available() and c.setup("ns", "envp", "u")[0].startswith("10.77.")
    # the module as the loader imports it (pytest may import this file
    # under another name)
    assert importlib.import_module("tests.test_torch_cni").ENV_PROVIDER.setups[-1] == "envp"
    monkeypatch.setenv("KWOK_TPU_CNI_PROVIDER", "tests.test_torch_cni")
    assert c.load_from_env() is True  # a module exposing setup/remove
    monkeypatch.setenv("KWOK_TPU_CNI_PROVIDER", "tests.test_torch_cni:NOPE")
    with pytest.raises(RuntimeError, match="could not be loaded"):
        c.load_from_env()


def delete_during_setup(lib):
    """A pod deleted while cni.setup is in flight: the commit's liveness
    check undoes the allocation (test_log_cni.py:78)."""
    armed = threading.Event()
    setup_entered = threading.Event()
    release_setup = threading.Event()
    removed = []

    def slow_setup(ns, n, u):
        if not armed.is_set():
            raise RuntimeError("not armed")  # pool fallback while pumping
        setup_entered.set()
        assert release_setup.wait(5)
        return ["10.77.0.9"]

    CNI[lib].register(slow_setup, lambda ns, n, u: removed.append(n))
    server = JaxFakeKube()
    eng = sync_engine(lib, server, manage_all_nodes=True, enable_cni=True)
    server.create("nodes", make_node("node0"))
    eng.feed_all(server)
    eng.pump(2)
    server.create("pods", make_pod("pod0"))
    eng.feed_all(server)
    eng.pump(2)
    idx = eng.pods.pool.lookup(("default", "pod0"))
    t = threading.Thread(target=eng._render_pod, args=(idx,), daemon=True)
    eng.pods.pool.meta[idx].pop("podIP", None)
    armed.set()
    t.start()
    assert setup_entered.wait(5)
    eng._pod_deleted({"metadata": {"namespace": "default", "name": "pod0"}})
    release_setup.set()
    t.join(5)
    assert not t.is_alive()
    return removed


def test_cni_delete_during_setup_undoes_allocation():
    got = {lib: delete_during_setup(lib) for lib in LIBS}
    assert got["jax"] == ["pod0"]
    assert got["torch"] == got["jax"]


def engine_uses_provider(lib):
    """enable_cni and a provider: the pod's IP is the provider's and is
    released on the Deleted event (test_log_cni.py:126)."""
    released = []
    CNI[lib].register(lambda ns, n, u: ["10.77.0.5"], lambda ns, n, u: released.append(n))
    server = JaxFakeKube()
    eng = sync_engine(lib, server, manage_all_nodes=True, enable_cni=True)
    server.create("nodes", make_node("node0"))
    eng.feed_all(server)
    eng.pump(2)
    server.create("pods", make_pod("pod0"))
    eng.feed_all(server)
    eng.pump(2)
    pod = server.get("pods", "default", "pod0")
    assert pod["status"]["phase"] == "Running"
    assert pod["status"]["podIP"] == "10.77.0.5"
    eng._q.put(("pods", "DELETED", pod))
    eng.pump(2)
    return masked(pod["status"]), released


def test_engine_uses_cni_provider():
    got = {lib: engine_uses_provider(lib) for lib in LIBS}
    assert got["jax"][1] == ["pod0"]
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------- topologies


def _facts(statuses: dict, prov, deleted: list) -> dict:
    """Every pod (its status when all were Running) Running with a
    provider IP, all distinct and none from the pool; one remove per
    deleted pod and no more."""
    ips = [st.get("podIP") for st in statuses.values()]
    return {
        "running": all(st.get("phase") == "Running" for st in statuses.values()),
        "provider_ips": all(ip and ip.startswith("10.77.") for ip in ips),
        "distinct": len(set(ips)) == len(ips),
        "none_from_pool": not any(ip and ipaddress.ip_address(ip) in POOL for ip in ips),
        "removed": sorted(prov.removes) == sorted(deleted),
    }


def _run_and_delete(stores, names, prov, n_delete):
    """Every store's pods Running with an IP, their statuses kept; then
    the first ``n_delete`` of each store's pods deleted until the
    provider saw that many removes."""
    assert _wait(lambda: all(_status(s, n).get("phase") == "Running"
                             and _status(s, n).get("podIP")
                             for s, ns_ in zip(stores, names) for n in ns_))
    statuses = {n: dict(_status(s, n)) for s, ns_ in zip(stores, names) for n in ns_}
    gone = [n for ns_ in names for n in ns_[:n_delete]]
    for s, ns_ in zip(stores, names):
        for n in ns_[:n_delete]:
            s.delete("pods", "default", n)
    assert _wait(lambda: len(prov.removes) >= len(gone))
    time.sleep(0.3)  # a second remove of one pod would land by now
    return _facts(statuses, prov, gone)


def threaded_lanes(lib):
    prov = Provider()
    CNI[lib].register(prov.setup, prov.remove)
    store = JaxFakeKube() if lib == "jax" else PortFakeKube()
    cfg = dict(manage_all_nodes=True, enable_cni=True, drain_shards=2, tick_interval=0.02)
    eng = (JaxEngine(store, JaxConfig(**cfg)) if lib == "jax"
           else TorchEngine(store, TorchConfig(device="cpu", **cfg)))
    eng.start()
    try:
        store.create("nodes", make_node("cn-n0"))
        names = [f"cn-p{i}" for i in range(12)]
        for n in names:
            store.create("pods", make_pod(n, node="cn-n0"))
        return _run_and_delete([store], [names], prov, 5)
    finally:
        eng.stop()


def test_threaded_lanes_take_provider_ips_and_remove_each_deleted_pod():
    got = {lib: threaded_lanes(lib) for lib in LIBS}
    assert all(got["jax"].values()), got["jax"]
    assert got["torch"] == got["jax"]


def federated(lib):
    prov = Provider()
    CNI[lib].register(prov.setup, prov.remove)
    stores = [JaxFakeKube() if lib == "jax" else PortFakeKube() for _ in range(2)]
    fed = federation(lib, stores, tick_interval=0.02, enable_cni=True)
    fed.start()
    try:
        names = [[f"c{c}-p{i}" for i in range(5)] for c in range(2)]
        for c, s in enumerate(stores):
            s.create("nodes", make_node(f"c{c}-n0"))
            for n in names[c]:
                s.create("pods", make_pod(n, node=f"c{c}-n0"))
        return _run_and_delete(stores, names, prov, 2)
    finally:
        fed.stop()


def test_federation_members_take_provider_ips_and_remove_each_deleted_pod():
    got = {lib: federated(lib) for lib in LIBS}
    assert all(got["jax"].values()), got["jax"]
    assert got["torch"] == got["jax"]


def process_lanes(lib, monkeypatch):
    """2 process lanes over the package's HTTP mock with enable_cni, a
    provider registered in this (the parent) process and named by
    KWOK_TPU_CNI_PROVIDER: where each pod's IP comes from."""
    monkeypatch.setenv("KWOK_TPU_CNI_PROVIDER", "tests.test_torch_cni:ENV_PROVIDER")
    prov = Provider()
    CNI[lib].register(prov.setup, prov.remove)
    store = JaxFakeKube() if lib == "jax" else PortFakeKube()
    srv = (JaxHttpApiserver if lib == "jax" else PortHttpApiserver)(store=store).start()
    cfg = dict(manage_all_nodes=True, enable_cni=True, drain_shards=2,
               lane_procs=True, tick_interval=0.05)
    eng = (JaxEngine(JaxClient(srv.url), JaxConfig(**cfg)) if lib == "jax"
           else TorchEngine(PortClient(srv.url), TorchConfig(device="cpu", **cfg)))
    names = [f"pl-p{i}" for i in range(8)]
    try:
        eng.start()
        assert _wait(lambda: eng.ready, 90), "startup gate never closed"
        store.create("nodes", make_node("pl-n0"))
        for n in names:
            store.create("pods", make_pod(n, node="pl-n0"))
        assert _wait(lambda: all(_status(store, n).get("phase") == "Running"
                                 and _status(store, n).get("podIP") for n in names), 60)
        ips = [_status(store, n)["podIP"] for n in names]
    finally:
        eng.stop()
        srv.stop()
    return {
        "from_pool": all(ipaddress.ip_address(ip) in POOL for ip in ips),
        "distinct": len(set(ips)) == len(ips),
        "parent_setups": len(prov.setups),
    }


def test_process_lanes_take_pool_ips_as_the_reference_does(monkeypatch):
    """The lane processes never load a provider (``kwok_tpu`` spawns them
    and never calls ``load_from_env`` there), so their pods' IPs come from
    each lane's pool in both packages: the reference's behaviour, kept."""
    got = {lib: process_lanes(lib, monkeypatch) for lib in LIBS}
    assert got["jax"] == {"from_pool": True, "distinct": True, "parent_setups": 0}
    assert got["torch"] == got["jax"]
