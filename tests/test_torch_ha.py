"""The port's warm-standby HA (``kwok_tpu_torch.resilience.ha`` and its
hooks in the engines, the CLI and both mock apiservers) against
``kwok_tpu``'s, on the CPU.

Each case runs one scenario through ``kwok_tpu`` (its engine on
``JAX_PLATFORMS=cpu``, its in-process store) and through the port (its
engine on the CPU, its store) and compares what each saw exactly: there
is no floating point in a role, a count or a patch. The scenarios are the
five ``test_ha_*`` cases of ``tests/test_resilience.py``:

- HA off costs nothing: no plane, no wrapper, no hold, no families;
- the fence and the client and pump wrappers, as a unit;
- a standby that ingests everything and writes nothing while another
  identity holds the lease, then takes over when it expires;
- a leader whose lease channel is cut (the in-process twin of a stopped
  process) writes nothing that lands once its fence lapses: every pod is
  patched Running exactly once, by the standby (an oplog kept on the
  server side, a test-local subclass of each package's store); healed,
  its renew meets 409 and it ends ``lost``, fenced and degraded;
- the ``KWOK_HA_*``/``KWOK_LEASE_*`` variables reach the flags;

and beyond them: a standby on two threaded lanes (the coordinator's hold)
that stays silent and then takes over; ``lane_procs`` with ``ha_role``
refused by both; and an HTTP pair against the port's native mock, where a
deposed holder's writes that pass its own fence (a zombie revived before
its fence check saw the lapse) die on the server with 409, unary and
pumped alike.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error

import numpy as np
import pytest

from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.resilience import ha as jha
from kwok_tpu_torch import native
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.resilience import ha as tha
from tests.test_torch_engine import make_node, make_pod

LIBS = {
    "jax": (JaxFakeKube, JaxEngine, JaxConfig, jha, {}),
    "torch": (PortFakeKube, TorchEngine, TorchConfig, tha, {"device": "cpu"}),
}
LEASE = ("kube-system", "kwok-tpu-engine")


def _wait(pred, timeout=30.0, every=0.05) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def oplog_store(base):
    """A store of class ``base`` (either package's FakeKube) that keeps,
    on the server side, every pod status patch in arrival order as (key,
    phase) and counts every write: the reference's oplog rig, built here
    over either store."""

    class OplogStore(base):
        def __init__(self):
            super().__init__()
            self.oplog: list = []
            self.writes = 0
            self._inner = threading.local()

        def _note(self, kind, namespace, name, patch):
            self.writes += 1
            if isinstance(patch, (bytes, bytearray, memoryview)):
                patch = json.loads(bytes(patch))
            if kind == "pods" and isinstance(patch, dict):
                phase = (patch.get("status") or {}).get("phase")
                self.oplog.append(((namespace or "default", name), phase))

        def patch_status(self, kind, namespace, name, patch):
            # one note per write: the port's patch_status goes through
            # patch_status_bytes, kwok_tpu's does not
            self._note(kind, namespace, name, patch)
            self._inner.depth = getattr(self._inner, "depth", 0) + 1
            try:
                return super().patch_status(kind, namespace, name, patch)
            finally:
                self._inner.depth -= 1

        def patch_status_bytes(self, kind, namespace, name, patch):
            if not getattr(self._inner, "depth", 0):
                self._note(kind, namespace, name, patch)
            return super().patch_status_bytes(kind, namespace, name, patch)

        def patch_meta(self, kind, namespace, name, patch):
            self.writes += 1
            return super().patch_meta(kind, namespace, name, patch)

        def delete(self, kind, namespace, name, **kw):
            self.writes += 1
            return super().delete(kind, namespace, name, **kw)

        def running_patches(self, names) -> dict:
            out = {n: 0 for n in names}
            for (_ns, n), phase in self.oplog:
                if n in out and phase == "Running":
                    out[n] += 1
            return out

    return OplogStore()


def _engine(lib, kube, role, ident, *, duration=1.0, **over):
    _kube, engine, config, _ha, extra = LIBS[lib]
    cfg = config(manage_all_nodes=True, tick_interval=0.02, ha_role=role,
                 ha_identity=ident, lease_duration=duration, checkpoint_dir="off",
                 **extra, **over)
    return engine(kube, cfg)


def _running(kube, names) -> bool:
    return all(((kube.get("pods", "default", n) or {}).get("status") or {})
               .get("phase") == "Running" for n in names)


# ------------------------------------------------------- the five twins


def _disabled(lib):
    fake, engine, config, ha, extra = LIBS[lib]
    kube = fake()
    eng = engine(kube, config(manage_all_nodes=True, **extra))
    return (eng._ha is None, eng._ha_hold, eng.client is kube, eng._ckpt_name,
            "kwok_ha_role" in eng.metrics_text(),
            ha.from_config(config(manage_all_nodes=True, ha_role="off", **extra)) is None)


def test_ha_disabled_is_zero_cost():
    got = _disabled("torch")
    assert got == _disabled("jax") == (True, False, True, "engine", False, True)


class _Pump:
    def __init__(self):
        self.sent = 0

    def send(self, reqs):
        self.sent += len(reqs)
        return np.full(len(reqs), 200, np.int32)

    def close(self):
        pass


def _fence_unit(lib):
    fake, _e, _c, ha, _x = LIBS[lib]
    plane = ha.HAPlane("primary", identity="u1", duration=1.0)
    out = [plane.fence.holding()]
    kube = fake()
    kube.create("nodes", make_node("fz"))
    fc = plane.wrap_client(kube)
    out.append(fc.patch_status("nodes", None, "fz", {"status": {"phase": "X"}}))
    out.append(fc.patch_meta("nodes", None, "fz", {"metadata": {"labels": {"a": "b"}}}))
    out.append(fc.delete("nodes", None, "fz"))
    got = kube.get("nodes", None, "fz")
    out += [plane.fenced_writes, got is not None, (got.get("status") or {}).get("phase"),
            got["metadata"].get("labels", {}), fc.get("nodes", None, "fz") is not None]
    plane.fence.open_until(time.monotonic() + 5)
    out.append(fc.patch_status("nodes", None, "fz", {"status": {"phase": "Y"}}) is not None)
    out.append(kube.get("nodes", None, "fz")["status"]["phase"])
    plane.fence.close()
    p = _Pump()
    fp = plane.wrap_pump(p)
    out += [p.sent, fp.send([b"a", b"b"]).tolist(), p.sent, plane.fenced_writes]
    plane.fence.open_until(time.monotonic() + 5)
    out += [fp.send([b"a"]).tolist(), p.sent]
    out += [plane.duration, plane.renew_interval, plane.acquire_interval,
            plane.fence_header_line()]
    return out


def test_ha_fence_and_wrappers_unit():
    got = _fence_unit("torch")
    assert got == _fence_unit("jax")
    assert got[:5] == [False, None, None, None, 3] and got[-9:-6] == [[404, 404], 0, 5]


def _standby_then_takeover(lib, **over):
    """The standby, with a ghost primary renewing the lease every 0.2 s,
    tracks every row and writes nothing for a 1 s window; then the ghost
    stops renewing, and the standby takes over and runs every pod."""
    kube = oplog_store(LIBS[lib][0])
    ghost = {"holderIdentity": "ghost", "leaseDurationSeconds": 2}
    assert kube.lease_create(*LEASE, ghost)[0] == 201
    alive = threading.Event()
    alive.set()
    renews = []

    def renew_loop():
        while alive.is_set():
            renews.append(kube.lease_renew(*LEASE, ghost)[0])
            time.sleep(0.2)

    renewer = threading.Thread(target=renew_loop, daemon=True)
    renewer.start()
    eng = _engine(lib, kube, "standby", "obs1", duration=2.0, **over)
    names = [f"sb-p{i}" for i in range(4)]
    try:
        eng.start()
        kube.create("nodes", make_node("sb-n"))
        for n in names:
            kube.create("pods", make_pod(n, node="sb-n"))
        warm = _wait(lambda: eng.metrics.get("pods_managed", 0) == 4
                     and eng.metrics.get("nodes_managed", 0) == 1)
        silent, t0 = True, time.time()
        while time.time() - t0 < 1.0:
            silent = silent and kube.writes == 0 and not eng._ha.leading and eng._ha_hold
            time.sleep(0.05)
        held_degraded = eng.degraded
        standby_role = 'kwok_ha_role{role="standby"} 1' in eng.metrics_text()
        alive.clear()
        renewer.join()
        took = _wait(lambda: eng._ha.leading and not eng._ha_hold, timeout=5.0)
        ran = _wait(lambda: _running(kube, names), timeout=30.0)
        text = eng.metrics_text()
        return {"warm": warm, "silent": silent, "held_degraded": held_degraded,
                "standby_role": standby_role, "ghost_renewed": set(renews) == {200},
                "took_over": took, "all_running": ran, "degraded_after": eng.degraded,
                "leader_role": 'kwok_ha_role{role="leader"} 1' in text,
                "one_transition": "kwok_lease_transitions_total 1" in text,
                "running_patches": kube.running_patches(names)}
    finally:
        alive.clear()
        eng.stop()


STANDBY_WANT = {"warm": True, "silent": True, "held_degraded": True, "standby_role": True,
                "ghost_renewed": True, "took_over": True, "all_running": True, "degraded_after": False,
                "leader_role": True, "one_transition": True,
                "running_patches": {f"sb-p{i}": 1 for i in range(4)}}


def test_ha_standby_observe_only_then_takeover():
    got = _standby_then_takeover("torch")
    assert got == _standby_then_takeover("jax") == STANDBY_WANT


def test_ha_standby_on_threaded_lanes_holds_then_takes_over():
    """The lane coordinator's hold: on two threaded lanes the standby's
    rows reach the stacked state while nothing launches or is written,
    and the takeover's wake ends the coordinator's idle sleep."""
    got = _standby_then_takeover("torch", drain_shards=2)
    assert got == _standby_then_takeover("jax", drain_shards=2) == STANDBY_WANT


def _zombie(lib):
    kube = oplog_store(LIBS[lib][0])
    primary = _engine(lib, kube, "primary", "za")
    primary.start()
    names = [f"zp{i}" for i in range(4)]
    try:
        out = {"primary_leads": _wait(lambda: primary._ha.leading, timeout=5.0)}
        standby = _engine(lib, kube, "standby", "zb")
        standby.start()
        try:
            kube.create("nodes", make_node("zn"))
            orig = primary._ha._lease

            def partitioned(verb):
                raise ConnectionError("lease channel partitioned")

            primary._ha._lease = partitioned
            for n in names:
                kube.create("pods", make_pod(n, node="zn"))
            out["standby_leads"] = _wait(
                lambda: standby._ha.leading and not standby._ha_hold, timeout=6.0)
            out["all_running"] = _wait(lambda: _running(kube, names), timeout=30.0)
            time.sleep(0.5)
            out["running_patches"] = kube.running_patches(names)
            primary._ha._lease = orig
            out["deposed"] = _wait(lambda: primary._ha.lost, timeout=5.0)
            out["held_and_fenced"] = primary._ha_hold and not primary._ha.fence.holding()
            out["lost_lease"] = "ha_lost_lease" in primary._degradation.reasons
            out["lost_role"] = 'kwok_ha_role{role="lost"} 1' in primary.metrics_text()
            return out
        finally:
            standby.stop()
    finally:
        primary.stop()


def test_ha_partitioned_zombie_is_write_dead_then_deposed():
    got = _zombie("torch")
    assert got == _zombie("jax")
    assert got == {"primary_leads": True, "standby_leads": True, "all_running": True,
                   "running_patches": {f"zp{i}": 1 for i in range(4)}, "deposed": True,
                   "held_and_fenced": True, "lost_lease": True, "lost_role": True}


def _env_plumbing(lib, monkeypatch):
    if lib == "jax":
        from kwok_tpu.config.types import KwokConfigurationOptions, apply_env_overrides
        from kwok_tpu.kwok.cli import build_parser
    else:
        from kwok_tpu_torch.config.types import KwokConfigurationOptions, apply_env_overrides
        from kwok_tpu_torch.kwok.cli import build_parser
    env = {"KWOK_HA_ROLE": "standby", "KWOK_HA_IDENTITY": "env-id",
           "KWOK_LEASE_NAME": "env-lease", "KWOK_LEASE_NAMESPACE": "env-ns",
           "KWOK_LEASE_DURATION": "7.5", "KWOK_LEASE_RENEW_INTERVAL": "2.5"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opts = KwokConfigurationOptions()
    apply_env_overrides(opts)
    args = build_parser(opts).parse_args([])
    _f, _e, config, ha, extra = LIBS[lib]
    plane = ha.from_config(config(manage_all_nodes=True, ha_role="primary", **extra))
    return ((opts.haRole, opts.haIdentity, opts.leaseName, opts.leaseNamespace,
             opts.leaseDuration, opts.leaseRenewInterval),
            (args.ha_role, args.ha_identity, args.lease_duration),
            bool(plane.identity), plane.renew_interval)


def test_ha_cli_and_env_plumbing(monkeypatch):
    got = _env_plumbing("torch", monkeypatch)
    assert got == _env_plumbing("jax", monkeypatch)
    assert got[:2] == (("standby", "env-id", "env-lease", "env-ns", 7.5, 2.5),
                       ("standby", "env-id", 7.5))
    assert got[3] == pytest.approx(2.0 / 3.0)


# ----------------------------------------------------------- beyond them


@pytest.mark.parametrize("lib", sorted(LIBS))
def test_lane_procs_with_ha_role_is_refused(lib):
    fake, engine, config, _ha, extra = LIBS[lib]
    with pytest.raises(ValueError, match="ha_role"):
        engine(fake(), config(manage_all_nodes=True, drain_shards=2, lane_procs=True,
                              ha_role="primary", **extra))


def _http_pair(lib, url):
    """Two engines of ``lib`` over HTTP on the port's native mock; the
    primary's lease channel is cut until the standby leads, then the
    primary's own fence is forced open (a zombie that passed its check
    before a pause) and it writes, unary and through its pump."""
    engine, config, extra = LIBS[lib][1], LIBS[lib][2], LIBS[lib][4]

    def make(role, ident):
        return engine(HttpKubeClient(url) if lib == "torch" else _jax_client(url),
                      config(manage_all_nodes=True, tick_interval=0.02, ha_role=role,
                             ha_identity=ident, lease_duration=1.0,
                             lease_name=f"lease-{lib}", checkpoint_dir="off", **extra))

    node = f"hn-{lib}"
    seed = HttpKubeClient(url)
    seed.create("nodes", make_node(node))
    primary = make("primary", f"{lib}-a")
    primary.start()
    try:
        out = {"primary_leads": _wait(lambda: primary._ha.leading, timeout=10.0)}
        standby = make("standby", f"{lib}-b")
        standby.start()
        try:
            primary._ha._lease = lambda verb: (_ for _ in ()).throw(
                ConnectionError("lease channel partitioned"))
            out["standby_leads"] = _wait(lambda: standby._ha.leading, timeout=10.0)
            primary._ha.fence.open_until(time.monotonic() + 30)
            try:
                primary.client.patch_status("nodes", None, node, {"status": {"phase": "Z"}})
                out["unary"] = "committed"
            except urllib.error.HTTPError as e:
                out["unary"] = (e.code, json.loads(e.reason)["reason"])
            pump = primary._get_pump()
            req = ("PATCH", f"/api/v1/nodes/{node}/status", b'{"status":{"phase":"Z"}}',
                   "application/strategic-merge-patch+json")
            out["pumped"] = None if pump is None else pump.send([req]).tolist()
            obj = seed.get("nodes", None, node)
            out["phase_on_server"] = (obj.get("status") or {}).get("phase")
            primary._ha.fence.close()
            return out
        finally:
            standby.stop()
    finally:
        primary.stop()
        seed.close()


def _jax_client(url):
    from kwok_tpu.edge.httpclient import HttpKubeClient as JaxClient

    return JaxClient(url)


@pytest.fixture(scope="module")
def native_mock():
    from tests.test_torch_apiserver import Server

    if native.apiserver_binary() is None:
        pytest.skip("no C++ compiler")
    srv = Server("native", env={"KWOK_TPU_BOOKMARK_INTERVAL": "0"})
    yield srv
    srv.stop()


@pytest.mark.parametrize("lib", sorted(LIBS))
def test_http_pair_deposed_holders_writes_get_409_from_the_server(lib, native_mock):
    got = _http_pair(lib, native_mock.url)
    assert got["primary_leads"] and got["standby_leads"]
    assert got["unary"] == (409, "Conflict")
    assert got["pumped"] == [409]
    assert got["phase_on_server"] != "Z"
