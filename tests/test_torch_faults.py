"""The port's fault plane and supervised restarts (kwok_tpu_torch.resilience
faults and watchdog, and their hooks in the engines) against kwok_tpu's, on
the CPU.

Twins, each bit-exact (tolerance 0): the same inputs through
``kwok_tpu.resilience.faults`` and ``kwok_tpu_torch.resilience.faults`` in
one process must give

- the same ``FaultSpec.parse``/``render`` over the full grammar, and the
  same rejections;
- the same first 10,000 ``decide`` results of every site, for seeds 0, 7
  and 42, on a parent plane and on a lane child's plane;
- the same ``child_spec_text`` for lanes 0-3;
- byte-identical ``garble_bytes``, ``truncate_bytes`` and ``_garble_desc``
  output, the same ``clock_skew`` draws and the same short-write split.

Then the CPU counterparts of the reference's fault-plane checks
(``tests/test_resilience.py``, ``tests/test_rv_expiry.py``,
``tests/test_native_emit.py``, ``tests/test_proclanes.py``), on the port's
in-process store or its HTTP mock at small sizes: the watchdog's budget,
pill absorption and restart log; killed drain, emit, watch and
federation-member workers that restart in place and converge; the
``worker.kill`` glob rotation; a compaction storm; a hostile wire and a
hostile clock; the process-lane hooks (kill and stop targets, torn
shared-memory writes, garbled and dropped descriptors rejected before any
dereference); and, with no spec, no plane and nothing wrapped.
"""

from __future__ import annotations

import json
import pickle
import threading
import time

import numpy as np
import pytest

from kwok_tpu.engine import proclanes as jproc
from kwok_tpu.resilience import faults as jf
from kwok_tpu_torch import native
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig, FederatedEngine
from kwok_tpu_torch.engine import proclanes as tproc
from kwok_tpu_torch.engine import shm as tshm
from kwok_tpu_torch.engine.engine import _PumpGroup
from kwok_tpu_torch.resilience import checkpoint as ckpt_mod
from kwok_tpu_torch.resilience import faults as tf
from kwok_tpu_torch.resilience.watchdog import Watchdog
from kwok_tpu_torch.telemetry.errors import (
    wire_rejects_total,
    worker_restarts_total,
)
from kwok_tpu_torch.workers import live_workers
from tests.test_native_emit import ApplyPump
from tests.test_torch_engine import make_node, make_pod

# ---------------------------------------------------------------- helpers


@pytest.fixture(autouse=True)
def no_escaped_worker_exceptions():
    """A kill the watchdog does not absorb reaches threading.excepthook:
    that fails the test even when its own assertions pass."""
    errors: list = []
    old = threading.excepthook

    def hook(args):
        errors.append((args.thread.name, args.exc_type, args.exc_value))
        old(args)

    threading.excepthook = hook
    try:
        yield errors
    finally:
        threading.excepthook = old
    assert not errors, f"worker thread raised: {errors}"


def _wait(pred, timeout=30.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _phase(store, name, ns="default"):
    return ((store.get("pods", ns, name) or {}).get("status") or {}).get("phase")


def _all_running(store, names):
    return all(_phase(store, n) == "Running" for n in names)


def _cfg(**kw):
    kw.setdefault("tick_interval", 0.02)
    return EngineConfig(manage_all_nodes=True, device="cpu", **kw)


# ------------------------------------------------------- twins: the grammar

GRAMMAR = [
    "seed=42; pump.drop=0.02; pump.delay=0.5:0.01; watch.expire=0.2; "
    "api.blackout=0.01:0.5; worker.kill=kwok-lane*:2.0",
    "seed=13;worker.kill=kwok-[elw]*[0s]:3.0;pump.drop=0.01;pump.partial=0.01;"
    "watch.cut=0.0002",
    "seed=5;lane=2;pump.delay=0.1:0.05;wire.dup=0.2;shm.stall=0.3:2.5;"
    "worker.kill=kwok-lane*:4.0;lane.sigstop=kwok-lane*:6.0",
    "seed=5;wire.garble=0.1;wire.truncate=0.05;wire.dup=0.2;wire.stale=0.2;"
    "clock.jump=0.3:0.5",
    "seed=5;shm.desc_garble=0.02;shm.desc_drop=0.02;shm.torn=1;list.fail=0.1",
    ";;seed=0;",
    "",
]

REJECTED = [
    "pump.dorp=0.1",  # a typo'd kind fails fast
    "seed",  # missing '='
    "worker.kill=kwok-*:0",  # period must be > 0
    "worker.kill=:2.0",  # empty glob
    "lane.sigstop=kwok-lane*:-1",
    "pump.drop=often",
    "seed=x",
]


def _spec_view(spec):
    return (
        spec.seed, spec.lane,
        {k: (v.p, v.arg) for k, v in spec.rates.items()},
        spec.kill_glob, spec.kill_period, spec.sigstop_glob, spec.sigstop_period,
    )


@pytest.mark.parametrize("text", GRAMMAR)
def test_fault_spec_parse_render_twin(text):
    j, t = jf.FaultSpec.parse(text), tf.FaultSpec.parse(text)
    assert _spec_view(t) == _spec_view(j)
    assert t.render() == j.render()
    # render is the spawn payload: parse(render()) is the same spec
    assert _spec_view(tf.FaultSpec.parse(t.render())) == _spec_view(t)
    for kind in jf.KINDS:
        assert (t.rate(kind) is None) == (j.rate(kind) is None), kind


@pytest.mark.parametrize("bad", REJECTED)
def test_fault_spec_rejections_twin(bad):
    with pytest.raises(ValueError):
        jf.FaultSpec.parse(bad)
    with pytest.raises(ValueError):
        tf.FaultSpec.parse(bad)


def test_kinds_and_child_kinds_twin():
    assert tf.KINDS == jf.KINDS
    assert tf.CHILD_KINDS == jf.CHILD_KINDS
    assert tf.FaultPlane._SUPERVISED_PREFIXES == jf.FaultPlane._SUPERVISED_PREFIXES
    assert issubclass(tf.WorkerKilled, BaseException)
    assert not issubclass(tf.WorkerKilled, Exception)
    assert issubclass(tf.FaultInjected, ConnectionError)


# ------------------------------------------------------ twins: determinism

# every probability-valued kind (worker.kill takes a glob and a period)
RATED = tuple(k for k in jf.KINDS if k != "worker.kill")
ALL_KINDS = "".join(
    f";{k}=0.3:0.25" if k in ("pump.delay", "api.blackout", "clock.jump", "shm.stall")
    else f";{k}=0.3"
    for k in RATED
)


@pytest.mark.parametrize("lane", [-1, 2])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_decide_streams_twin(seed, lane):
    """The first 10,000 decide results of every site, on a parent plane
    and on lane 2's child plane (re-seeded as (seed, lane, kind))."""
    text = f"seed={seed}" + (f";lane={lane}" if lane >= 0 else "") + ALL_KINDS
    jp = jf.FaultPlane(jf.FaultSpec.parse(text))
    tp = tf.FaultPlane(tf.FaultSpec.parse(text))
    for kind in RATED:
        got = [tp.decide(kind) is not None for _ in range(10_000)]
        want = [jp.decide(kind) is not None for _ in range(10_000)]
        assert got == want, kind
        assert 0 < sum(got) < 10_000, kind


def test_decide_streams_are_per_site_twin():
    """Another site's draws never perturb a site's sequence, in either
    package."""
    spec = "seed=5;pump.drop=0.3;watch.expire=0.4"
    for m in (jf, tf):
        a = m.FaultPlane(m.FaultSpec.parse(spec))
        b = m.FaultPlane(m.FaultSpec.parse(spec))
        seq_a = [a.decide("pump.drop") is not None for _ in range(64)]
        seq_b = []
        for _ in range(64):
            b.decide("watch.expire")
            seq_b.append(b.decide("pump.drop") is not None)
        assert seq_a == seq_b
    # an unset site never draws
    assert tf.FaultPlane(tf.FaultSpec.parse(spec)).decide("list.fail") is None


@pytest.mark.parametrize("lane", [0, 1, 2, 3])
def test_child_spec_text_twin(lane):
    for text in GRAMMAR + ["seed=11;pump.drop=0.5;shm.torn=0.5",
                           "seed=7;watch.expire=0.5;worker.kill=kwok-lane*:2.0"]:
        j, t = jf.FaultSpec.parse(text), tf.FaultSpec.parse(text)
        assert tf.child_spec_text(t, lane) == jf.child_spec_text(j, lane), text
    assert tf.child_spec_text(None, lane) == jf.child_spec_text(None, lane) == "off"


LINES = [
    b'{"type":"MODIFIED","object":{"metadata":{"name":"x","resourceVersion":"12"}}}',
    b"",
    b"a",
    b'{"type":"ADDED"}',
    bytes(range(256)),
]


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_garble_and_truncate_bytes_twin(seed):
    text = f"seed={seed};wire.garble=1;wire.truncate=1"
    jp = jf.FaultPlane(jf.FaultSpec.parse(text))
    tp = tf.FaultPlane(tf.FaultSpec.parse(text))
    for i in range(2_000):
        line = LINES[i % len(LINES)] * (1 + i % 3)
        assert tp.garble_bytes(line) == jp.garble_bytes(line)
        assert tp.truncate_bytes(line) == jp.truncate_bytes(line)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_garble_desc_twin(seed):
    text = f"seed={seed};shm.desc_garble=1"
    jp = jf.FaultPlane(jf.FaultSpec.parse(text))
    tp = tf.FaultPlane(tf.FaultSpec.parse(text))
    for i in range(2_000):
        bounds = [0, 40 + i % 7, 100 + i]
        args = (128 + i, 100 + i, bounds, 4 << 20)
        assert tproc._garble_desc(tp, *args) == jproc._garble_desc(jp, *args)
        assert bounds == [0, 40 + i % 7, 100 + i]  # never changed in place


def test_clock_skew_and_short_write_twin():
    text = "seed=9;clock.jump=0.5:0.25;pump.partial=0.5;pump.drop=0.1"
    jp = jf.FaultPlane(jf.FaultSpec.parse(text))
    tp = tf.FaultPlane(tf.FaultSpec.parse(text))
    assert [tp.clock_skew() for _ in range(500)] == [jp.clock_skew() for _ in range(500)]

    class Ok:
        def __init__(self):
            self.calls = []

        def send(self, reqs):
            self.calls.append(len(reqs))
            return np.full(len(reqs), 200, np.int32)

    ji, ti = Ok(), Ok()
    jpump, tpump = jf.FaultyPump(jp, ji), tf.FaultyPump(tp, ti)
    reqs = [("PATCH", f"/p{i}", b"x") for i in range(9)]
    for _ in range(300):
        assert tpump.send(reqs).tolist() == jpump.send(reqs).tolist()
    assert ti.calls == ji.calls and len(set(ti.calls)) > 1
    assert tp.counts() == jp.counts()


# ------------------------------------------------- the plane's own surface


def test_from_config_disabled_paths(monkeypatch):
    monkeypatch.delenv("KWOK_TPU_FAULTS", raising=False)
    assert tf.from_config("") is None
    assert tf.from_config("off") is None
    monkeypatch.setenv("KWOK_TPU_FAULTS", "seed=7;pump.drop=0.5")
    plane = tf.from_config("")  # the env fallback
    assert plane is not None and plane.spec.seed == 7
    # "off" beats the env var (lane engines rely on it)
    assert tf.from_config("off") is None


def test_engine_without_faults_is_unwrapped(monkeypatch):
    """No spec: no plane, no wrapper, a plain _now and plain native pumps
    (the zero-cost contract); a spec wraps the client and every pump, and
    the lanes share the parent's one plane."""
    monkeypatch.delenv("KWOK_TPU_FAULTS", raising=False)
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg())
    assert eng._faults is None
    assert eng.client is kube
    assert "_now" not in eng.__dict__
    lanes = ClusterEngine(kube, _cfg(drain_shards=2))
    assert lanes._faults is None and lanes.client is kube
    assert all(ln.engine._faults is None for ln in lanes._lanes.lanes)

    faulted = ClusterEngine(kube, _cfg(drain_shards=2, faults="seed=1"))
    assert isinstance(faulted.client, tf.FaultyClient)
    assert all(ln.engine._faults is faulted._faults for ln in faulted._lanes.lanes)
    # the lanes' client is the parent's wrapped one, never wrapped twice
    assert all(ln.engine.client is faulted.client for ln in faulted._lanes.lanes)

    if not (native.enabled() and native.available()):
        pytest.skip("native pump not built here")
    srv = HttpFakeApiserver().start()
    try:
        plain = ClusterEngine(HttpKubeClient(srv.url), _cfg())
        group = plain._get_pump()
        assert group is not None
        assert all(type(p) is native.Pump for p, _lock in group._pumps)
        group.close()
        wrapped = ClusterEngine(HttpKubeClient(srv.url), _cfg(faults="seed=2"))
        group = wrapped._get_pump()
        assert all(isinstance(p, tf.FaultyPump) for p, _lock in group._pumps)
        group.close()
    finally:
        srv.stop()


def test_clock_jump_installs_skewed_now():
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg(faults="seed=5;clock.jump=1.0:0.25"))
    assert eng._now.__func__ is ClusterEngine._skewed_now
    for _ in range(4):
        eng._now()
    assert eng._faults.counts().get("clock.jump", 0) >= 4
    honest = time.time() - eng._epoch
    assert abs(eng._now() - honest) <= 0.25 + 0.05
    # no spec: a plain _now, no instance attribute
    assert "_now" not in ClusterEngine(kube, _cfg()).__dict__


def test_faulty_client_watch_expire_list_fail_and_blackout():
    kube = PortFakeKube()
    kube.create("nodes", make_node("f0"))
    plane = tf.FaultPlane(tf.FaultSpec.parse("seed=2;watch.expire=1.0"))
    client = plane.wrap_client(kube)
    assert plane.wrap_client(client) is client  # idempotent
    from kwok_tpu_torch.edge.kubeclient import WatchExpired

    with pytest.raises(WatchExpired):
        client.watch("nodes", resource_version=3)
    client.watch("nodes").stop()  # a fresh watch (the re-list path) passes
    with pytest.raises(tf.FaultInjected):
        tf.FaultPlane(tf.FaultSpec.parse("seed=2;list.fail=1.0")).wrap_client(kube).list("nodes")
    dark = tf.FaultPlane(tf.FaultSpec.parse("seed=3;api.blackout=1.0:0.2"))
    c = dark.wrap_client(kube)
    with pytest.raises(tf.FaultInjected):
        c.get("nodes", None, "f0")
    with pytest.raises(tf.FaultInjected):
        c.list("nodes")  # inside the window every transport op fails
    time.sleep(0.25)
    dark.spec.rates.clear()
    assert c.get("nodes", None, "f0")["metadata"]["name"] == "f0"


def test_faulty_watch_cut_ends_stream():
    kube = PortFakeKube()
    plane = tf.FaultPlane(tf.FaultSpec.parse("seed=4;watch.cut=1.0"))
    w = plane.wrap_client(kube).watch("nodes")
    kube.create("nodes", make_node("c0"))
    kube.create("nodes", make_node("c1"))
    assert list(w) == []  # p=1.0 cuts before yielding anything
    assert plane.counts()["watch.cut"] >= 1
    # the native socket reader is disabled under faults: per-line path
    assert tf.FaultyWatch.native_reader is None


# ------------------------------------------------------------- watchdog


def test_watchdog_restarts_within_budget():
    ran = []
    done = threading.Event()

    def target():
        ran.append(1)
        if len(ran) <= 3:
            raise RuntimeError("boom")
        done.set()

    before = worker_restarts_total("wd-t-worker")
    wd = Watchdog(budget=5, window=30.0)
    t = wd.spawn(target, name="wd-t-worker")
    assert done.wait(10), "worker was not restarted to completion"
    t.join(timeout=10)
    assert len(ran) == 4
    assert worker_restarts_total("wd-t-worker") - before == 3
    assert wd.restarts_total() == 3
    log = wd.restart_log()
    assert [r["thread"] for r in log] == ["wd-t-worker"] * 3
    assert all(r["restart_latency_s"] >= 0 for r in log)


def test_watchdog_absorbs_pill_mid_recovery_and_retries_on_restart():
    """A pill that lands in on_restart is absorbed and the resync is
    retried (up to 3 times); the worker still restarts once."""
    calls = []

    def on_restart(name):
        calls.append(name)
        if len(calls) == 1:
            raise tf.WorkerKilled("pill in the resync")

    ran = []
    done = threading.Event()

    def target():
        ran.append(1)
        if len(ran) == 1:
            raise tf.WorkerKilled("pill")
        done.set()

    wd = Watchdog(budget=5, window=30.0, on_restart=on_restart)
    t = wd.spawn(target, name="wd-t-pill")
    assert done.wait(10)
    t.join(timeout=10)
    assert calls == ["wd-t-pill", "wd-t-pill"]
    assert wd.restarts_total() == 1


def test_watchdog_budget_exhaustion_degrades(no_escaped_worker_exceptions):
    exhausted = []

    def target():
        raise tf.WorkerKilled("pill")  # loops cannot absorb a BaseException

    wd = Watchdog(budget=2, window=30.0, on_exhausted=exhausted.append)
    t = wd.spawn(target, name="wd-t-crashloop")
    t.join(timeout=10)
    assert exhausted == ["wd-t-crashloop"]
    assert wd.restarts_total() == 2
    # the final crash escaped into threading.excepthook, as it must
    escaped = list(no_escaped_worker_exceptions)
    no_escaped_worker_exceptions.clear()
    assert [e[1] for e in escaped] == [tf.WorkerKilled]


def test_watchdog_closed_does_not_restart(no_escaped_worker_exceptions):
    ran = []
    wd = Watchdog(budget=5, window=30.0)
    wd.close()
    assert wd.closed

    def target():
        ran.append(1)
        raise RuntimeError("shutdown crash")

    wd.spawn(target, name="wd-t-closed").join(timeout=10)
    assert ran == [1] and wd.restarts_total() == 0
    no_escaped_worker_exceptions.clear()


def test_pill_between_acquire_and_release_leaves_no_lock_held():
    """A pill that lands after a lock's acquire returned and before its
    release was armed leaves the lock held by a thread whose stack no
    longer knows it; before the worker runs again the watchdog releases
    every reclaimable lock that thread still owns, so other threads are
    not blocked for good (a divergence from kwok_tpu, whose watchdog
    restarts the worker with the lock still held)."""
    from kwok_tpu_torch.locks import reclaimable

    lock = reclaimable()
    runs = []

    def target():
        runs.append(1)
        if len(runs) == 1:
            lock.acquire()
            lock.acquire()  # reentrant: every level is released
            raise tf.WorkerKilled("pill before the release")

    Watchdog(budget=5, window=30.0).spawn(target, name="wd-t-leak").join(timeout=10)
    assert runs == [1, 1]
    got = []
    t = threading.Thread(target=lambda: got.append(lock.acquire(timeout=5)))
    t.start()
    t.join(timeout=10)
    assert got == [True]


def test_kill_worker_arms_a_pill_in_a_live_worker():
    stop = threading.Event()
    wd = Watchdog(budget=5, window=30.0)
    runs = []

    def target():
        runs.append(1)
        while not stop.is_set():
            time.sleep(0.005)

    wd.spawn(target, name="kwok-lane-t9")
    plane = tf.FaultPlane(tf.FaultSpec.parse("seed=1"))
    assert "kwok-lane-t9" in live_workers()
    assert plane.kill_worker("kwok-lane-t9")
    assert not plane.kill_worker("kwok-no-such-worker")
    assert _wait(lambda: len(runs) == 2, 10)
    stop.set()
    assert [k["thread"] for k in plane.kill_log()] == ["kwok-lane-t9"]
    assert [r["thread"] for r in wd.restart_log()] == ["kwok-lane-t9"]
    assert plane.counts() == {"worker.kill": 1}


# ------------------------------------------------ engines under the plane


def test_killed_drain_and_emit_workers_restart_and_converge():
    """A 4-lane engine loses a drain worker and an emit worker to pills
    mid-churn; the watchdog restarts both in place, the queues drain, and
    every pod still converges to Running."""
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg(drain_shards=4, faults="seed=11"))
    r_drain0 = worker_restarts_total("kwok-lane1")
    r_emit0 = worker_restarts_total("kwok-emit2")
    eng.start()
    try:
        kube.create("nodes", make_node("kn"))
        first = [f"kp{i}" for i in range(16)]
        for n in first:
            kube.create("pods", make_pod(n, node="kn"))
        assert _wait(lambda: _all_running(kube, first)), "first wave did not converge"
        assert eng._faults.kill_worker("kwok-lane1")
        assert eng._faults.kill_worker("kwok-emit2")
        names = first + [f"kp{i}" for i in range(16, 40)]
        for n in names[16:]:
            kube.create("pods", make_pod(n, node="kn"))
        assert _wait(lambda: worker_restarts_total("kwok-lane1") > r_drain0
                     and worker_restarts_total("kwok-emit2") > r_emit0), \
            "killed workers were not restarted"
        assert _wait(lambda: _all_running(kube, names)), "post-kill wave did not converge"
        assert _wait(lambda: all(ln.q.qsize() == 0 for ln in eng._lanes.lanes))
        assert not eng.degraded
        assert eng._faults.counts().get("worker.kill") == 2
        killed = sorted(k["thread"] for k in eng._faults.kill_log())
        assert killed == ["kwok-emit2", "kwok-lane1"]
        assert sorted(r["thread"] for r in eng._watchdog.restart_log()) == killed
    finally:
        eng.stop()


def test_worker_kill_spec_glob_rotates():
    """worker.kill=<glob>:<period> kills matching supervised workers on a
    period, rotating through the sorted matches."""
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg(
        drain_shards=2, faults="seed=12;worker.kill=kwok-lane*:0.2",
        worker_restart_budget=1000,
    ))
    eng.start()
    try:
        kube.create("nodes", make_node("gn"))
        names = [f"gp{i}" for i in range(30)]
        for n in names:  # a steady trickle wakes parked workers into pills
            kube.create("pods", make_pod(n, node="gn"))
            time.sleep(0.03)
        assert _wait(lambda: eng._faults.counts().get("worker.kill", 0) >= 2), \
            "the worker killer never fired"
        kills = [k["thread"] for k in eng._faults.kill_log()]
        assert kills[:2] == ["kwok-lane0", "kwok-lane1"]
        assert set(kills) <= {"kwok-lane0", "kwok-lane1"}
        # close the fault window (storm, then heal); the engine converges
        eng._faults.spec.kill_glob = "chaos-window-closed"
        assert _wait(lambda: _all_running(kube, names)), \
            "engine did not converge under periodic worker kills"
        assert not eng.degraded
    finally:
        eng.stop()


def test_watch_worker_killed_restarts_and_relists():
    """A pill in a watch thread restarts it in place; the fresh loop
    re-lists, and events the pill ate are re-delivered."""
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg())
    r0 = worker_restarts_total("kwok-watch-pods")
    eng.start()
    try:
        kube.create("nodes", make_node("wk-n0"))
        kube.create("pods", make_pod("wkp0", node="wk-n0"))
        assert _wait(lambda: _phase(kube, "wkp0") == "Running", 20)
        relists0 = eng.metrics["watch_relists_total"]
        t = live_workers().get("kwok-watch-pods")
        assert t is not None and tf._async_raise(t)
        kube.create("pods", make_pod("wkp1", node="wk-n0"))
        assert _wait(lambda: worker_restarts_total("kwok-watch-pods") > r0, 20), \
            "watch worker never restarted"
        assert _wait(lambda: _phase(kube, "wkp1") == "Running", 20)
        assert _wait(lambda: eng.metrics["watch_relists_total"] > relists0, 10), \
            "restarted watch loop never re-listed"
        assert not eng.degraded
    finally:
        eng.stop()


def test_worker_restart_resync_branches(tmp_path, monkeypatch):
    """The reference's branches: an emit restart does nothing (its replay
    slot holds the slice), a watch restart re-arms the checkpoint refill
    only, any other restart re-lists every stream and re-fans every
    managed node's pods to their lanes."""
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg(drain_shards=2, checkpoint_dir=str(tmp_path),
                                   checkpoint_interval=0.2))
    eng.start()
    try:
        kube.create("nodes", make_node("rb-n0"))
        kube.create("pods", make_pod("rbp0", node="rb-n0"))
        assert _wait(lambda: _phase(kube, "rbp0") == "Running")
        assert _wait(lambda: ckpt_mod.load(str(tmp_path), "engine") is not None, 10)
        calls = {"resync": 0, "fan": []}
        monkeypatch.setattr(eng, "resync_streams",
                            lambda: calls.__setitem__("resync", calls["resync"] + 1))
        monkeypatch.setattr(eng._lanes, "route_pod_updates", calls["fan"].append)
        eng._worker_restarted_resync("kwok-emit1")
        assert calls == {"resync": 0, "fan": []} and eng._restore is None
        eng._worker_restarted_resync("kwok-watch-pods")
        assert calls == {"resync": 0, "fan": []}
        r = eng._restore
        assert r is not None and not r.gate_ready and r.deadline > time.monotonic()
        # the identity check: closing an old session leaves a newer one
        eng._close_restore(object())
        assert eng._restore is r
        eng._worker_restarted_resync("kwok-lane0")
        assert calls == {"resync": 1, "fan": ["rb-n0"]}
    finally:
        eng.stop()


def test_fed_member_watch_worker_failover(tmp_path):
    """A killed federation-member watch thread restarts in place, is
    counted in kwok_fed_member_restarts_total{member}, re-lists, and the
    other member keeps converging untouched; one watchdog supervises
    both members."""
    kubes = [PortFakeKube(), PortFakeKube()]
    fed = FederatedEngine(kubes, _cfg(checkpoint_dir=str(tmp_path)))
    fed.start()
    try:
        assert all(e._watchdog is fed._watchdog for e in fed.engines)
        for k in kubes:
            k.create("nodes", make_node("fm-n0"))
        a = [f"fma{i}" for i in range(4)]
        b = [f"fmb{i}" for i in range(4)]
        for n in a:
            kubes[0].create("pods", make_pod(n, node="fm-n0"))
        for n in b:
            kubes[1].create("pods", make_pod(n, node="fm-n0"))
        assert _wait(lambda: fed.ready, 30)
        assert _wait(lambda: _all_running(kubes[0], a) and _all_running(kubes[1], b), 30)
        t = live_workers().get("kwok-watch-pods-m1")
        assert t is not None and tf._async_raise(t)
        kubes[1].create("pods", make_pod("fmb4", node="fm-n0"))
        assert _wait(lambda: 'kwok_fed_member_restarts_total{member="1"} 1'
                     in fed.registry.render(), 30), "member restart never counted"
        assert _wait(lambda: _all_running(kubes[1], b + ["fmb4"]), 30), \
            "restarted member never re-filled"
        assert _all_running(kubes[0], a)
        assert not any('member="0"' in ln for ln in fed.registry.render().splitlines()
                       if ln.startswith("kwok_fed_member_restarts_total"))
        assert not fed.degraded
    finally:
        fed.stop()


def test_fault_plane_compaction_storm_multilane_converges():
    """watch.cut keeps killing live streams and watch.expire answers half
    the resumes with an injected 410 (a compaction storm); the paced
    re-list path converges anyway."""
    store = PortFakeKube()
    eng = ClusterEngine(store, _cfg(
        drain_shards=2, faults="seed=21;watch.cut=0.05;watch.expire=0.5"))
    eng.start()
    try:
        store.create("nodes", make_node("fst"))
        names = []

        def stormed():
            counts = eng._faults.counts()
            return counts.get("watch.cut", 0) >= 1 and counts.get("watch.expire", 0) >= 1

        # waves of 8 creates until the storm has both cut a stream and
        # expired a resume (at most 20 waves)
        for wave in range(20):
            for i in range(8):
                names.append(f"fst{wave}-{i}")
                store.create("pods", make_pod(names[-1], node="fst"))
            if _wait(stormed, 1.0):
                break
        assert stormed(), eng._faults.counts()
        assert _wait(lambda: _all_running(store, names), 60)
    finally:
        eng.stop()


def test_wire_garble_truncate_quarantined_over_http():
    """The raw-lines ingest edge under garble and truncate: corrupt lines
    are quarantined (kwok_wire_rejects_total moves), no worker crashes,
    and every pod still converges. Pods are created in waves until a line
    has been quarantined (at most 30 waves of 8): most garbles leave the
    JSON valid (a flipped byte inside a string), and a garbled echo whose
    status bytes survive drops at the fingerprint tier without a parse,
    in both packages, so a fixed handful of pods quarantines a line only
    now and then."""
    srv = HttpFakeApiserver().start()
    rejects0 = wire_rejects_total()
    eng = ClusterEngine(HttpKubeClient(srv.url), _cfg(
        faults="seed=3;wire.garble=0.25;wire.truncate=0.05"))
    assert eng._batch_parser is not None, "the raw-lines edge needs the native parser"
    eng.start()
    try:
        client = HttpKubeClient(srv.url)
        client.create("nodes", make_node("gq-n"))
        names = []
        for wave in range(30):
            for i in range(8):
                names.append(f"gqp{wave}-{i}")
                client.create("pods", make_pod(names[-1], node="gq-n"))
            if _wait(lambda: wire_rejects_total() > rejects0, 1.0):
                break
        assert wire_rejects_total() > rejects0
        assert _wait(lambda: _all_running(client, names), 45)
        assert eng._faults.counts().get("wire.garble", 0) >= 1
        client.close()
    finally:
        eng.stop()
        srv.stop()


class OplogStore(PortFakeKube):
    """The port's store keeping a server-side log of pod phase patches:
    the double-fire oracle."""

    def __init__(self):
        super().__init__()
        self.oplog: list = []

    def _note(self, kind, name, patch):
        if kind != "pods":
            return
        if isinstance(patch, (bytes, bytearray, memoryview)):
            patch = json.loads(bytes(patch))
        if isinstance(patch, dict):
            self.oplog.append((name, (patch.get("status") or {}).get("phase")))

    # patch_status goes through patch_status_bytes in the port's store:
    # noting there alone logs each patch once
    def patch_status_bytes(self, kind, namespace, name, patch):
        self._note(kind, name, patch)
        return super().patch_status_bytes(kind, namespace, name, patch)

    def phase_counts(self, phase, names):
        counts = {n: 0 for n in names}
        for name, ph in list(self.oplog):
            if ph == phase and name in counts:
                counts[name] += 1
        return counts


def test_clock_jump_never_double_fires_checkpointed_delay(tmp_path):
    """Under a hostile clock an engine checkpoints mid-delay, restarts on
    the same directory, and every pod fires its Running transition
    exactly once (the server-side patch log)."""
    from kwok_tpu_torch.models.defaults import default_pod_rules
    from kwok_tpu_torch.models.lifecycle import Delay

    store = OplogStore()

    def cfg():
        return _cfg(tick_interval=0.05, checkpoint_dir=str(tmp_path),
                    checkpoint_interval=0.25,
                    pod_rules=default_pod_rules(running_delay=Delay.constant(3.0)),
                    faults="seed=21;clock.jump=0.4:0.2")

    names = [f"cjp{i}" for i in range(4)]
    e1 = ClusterEngine(store, cfg())
    e1.start()
    try:
        store.create("nodes", make_node("cj-n"))
        for n in names:
            store.create("pods", make_pod(n, node="cj-n"))

        def armed():
            doc = ckpt_mod.load(str(tmp_path), "engine")
            pods = (doc or {}).get("kinds", {}).get("pods", {})
            return len(pods) == len(names) and all(v[2] is not None for v in pods.values())

        assert _wait(armed, 20), "checkpoint never covered the armed pods"
        time.sleep(0.6)  # a measurable slice of the delay elapses
    finally:
        e1.stop()
    e2 = ClusterEngine(store, cfg())
    e2.start()
    try:
        assert _wait(lambda: _all_running(store, names), 30), "pods never fired after restart"
        time.sleep(0.5)  # late duplicates would land here
    finally:
        e2.stop()
    counts = store.phase_counts("Running", names)
    assert all(c == 1 for c in counts.values()), counts
    assert e2._faults.counts().get("clock.jump", 0) >= 1


def test_emit_replay_survives_worker_kill_mid_slab():
    """Emit workers killed mid-slab while batched emits flow through their
    pumps restart and replay the same wire slice: every pod converges, no
    patch is lost."""
    kube = PortFakeKube()
    eng = ClusterEngine(kube, _cfg(drain_shards=2, faults="seed=11"))
    if eng._emit_tpl is None:
        pytest.skip("native emit templates not built here")
    pumps = []
    for lane in eng._lanes.lanes:
        p = ApplyPump(kube)
        pumps.append(p)
        lane.engine._pump = _PumpGroup([p])
        lane.engine._pump_tried = True
        lane.engine._pump_base = ""
    restarts0 = [worker_restarts_total(f"kwok-emit{i}") for i in range(2)]
    eng.start()
    try:
        kube.create("nodes", make_node("rn0"))
        names = [f"rp-{i}" for i in range(48)]
        for n in names[:16]:
            kube.create("pods", make_pod(n, node="rn0"))
        assert _wait(lambda: _all_running(kube, names[:16])), \
            "first wave did not converge through the template emit path"
        assert eng._faults.kill_worker("kwok-emit0")
        assert eng._faults.kill_worker("kwok-emit1")
        for n in names[16:]:
            kube.create("pods", make_pod(n, node="rn0"))
        assert _wait(lambda: all(worker_restarts_total(f"kwok-emit{i}") > restarts0[i]
                                 for i in range(2))), "killed emit workers were not restarted"
        assert _wait(lambda: _all_running(kube, names)), "replayed slices did not converge"
        assert sum(p.native_batches for p in pumps) > 0, "the batched emit path never ran"
    finally:
        eng.stop()


# ------------------------------------------------------ process-lane hooks


def test_fault_plane_proc_kill_and_stop_targets():
    plane = tf.FaultPlane(tf.FaultSpec.parse(
        "worker.kill=kwok-lane*:5.0;lane.sigstop=kwok-lane*:5.0"))
    killed, stopped = [], []
    plane.register_proc_target(
        "kwok-lane0", lambda: killed.append(0) or True, lambda: stopped.append(0) or True)
    assert plane.kill_process("kwok-lane0", plane._proc_targets["kwok-lane0"])
    assert plane.stop_process("kwok-lane0", plane._stop_targets["kwok-lane0"])
    assert killed == [0] and stopped == [0]
    assert plane.counts() == {"worker.kill": 1, "lane.sigstop": 1}
    log = plane.kill_log()
    assert all(r.get("proc") for r in log) and [r.get("stop") for r in log] == [None, True]
    plane.unregister_proc_target("kwok-lane0")
    assert "kwok-lane0" not in plane._proc_targets
    assert "kwok-lane0" not in plane._stop_targets


class _StubPump:
    def __init__(self, slot):
        self.slot = slot
        self.seen = []

    def send(self, requests):
        # what a post-mortem reader would find while the batch is on the wire
        self.seen.append(self.slot.peek())
        return np.full(len(requests), 200, np.int32)

    def close(self):
        pass


def test_slot_guard_injected_torn_arm_parks_empty():
    """shm.torn through the lane's slot guard: a batch whose arm is torn
    reads as EMPTY while it is on the wire (never an older batch, never
    half of the new one); without the fault the batch is parked."""
    reqs = [("PATCH", b"/api/v1/namespaces/default/pods/a/status", b"{}",
             "application/merge-patch+json")]
    for spec, parked in (("seed=1;shm.torn=1.0", False), (None, True)):
        slot = tshm.InflightSlot(tshm.arena_name("t-torn"), 4096, create=True)
        try:
            assert slot.arm(pickle.dumps([("PATCH", "/old", b"{}", "ct")]))
            plane = tf.FaultPlane(tf.FaultSpec.parse(spec)) if spec else None
            guard = tproc._SlotGuardClient(slot, object(), plane)
            stub = _StubPump(slot)
            tproc._SlotGuardPump(guard, stub).send(reqs)
            seen = stub.seen[0]
            if parked:
                assert pickle.loads(seen) == [("PATCH", reqs[0][1].decode(), b"{}", reqs[0][3])]
            else:
                assert seen is None
                assert plane.counts() == {"shm.torn": 1}
            assert slot.peek() is None  # answered: out of the slot
        finally:
            slot.close(unlink=True)


def test_metrics_bank_injected_torn_write_backoff_and_restamp():
    """shm.torn on the seqlock slab: a torn slab is never parsed, by this
    package's reader or kwok_tpu's, and the next live write restamps."""
    from kwok_tpu.engine import shm as jshm

    bank = tshm.MetricsBank(tshm.arena_name("t-torn-mb"), 4096, create=True)
    try:
        reader = tshm.MetricsBank(bank.name)
        jreader = jshm.MetricsBank(bank.name)
        try:
            assert bank.write(b'{"gen": 1}')
            assert reader.read() == b'{"gen": 1}'
            bank.torn_write(b'{"gen": 2, "pad": "x"}')
            assert int(bank.arena.hdr[tshm.MetricsBank.SEQ]) % 2 == 1
            assert reader.read(retries=3) is None
            assert jreader.read(retries=3) is None
            assert bank.write(b'{"gen": 3}')
            assert int(bank.arena.hdr[tshm.MetricsBank.SEQ]) % 2 == 0
            assert reader.read() == jreader.read() == b'{"gen": 3}'
        finally:
            reader.close()
            jreader.close()
    finally:
        bank.close(unlink=True)


def test_garble_desc_every_shape_is_rejected():
    """Every corruption _garble_desc emits is caught by the child's bounds
    gate before any dereference, with kwok_tpu's verdict."""
    plane = tf.FaultPlane(tf.FaultSpec.parse("seed=9;shm.desc_garble=1.0"))
    cap, published = 4096, 2048
    off, ln, bounds = 128, 256, [0, 100, 256]
    assert tproc._desc_check("pods", off, ln, bounds, cap, published) is None
    reasons = set()
    for _ in range(64):
        g = tproc._garble_desc(plane, off, ln, bounds, cap)
        reason = tproc._desc_check("pods", *g, cap, published)
        assert reason is not None and reason == jproc._desc_check("pods", *g, cap, published)
        reasons.add(reason)
    assert reasons == {"range", "unpublished", "bounds"}
    assert (off, ln, bounds) == (128, 256, [0, 100, 256])


def test_quiesce_child_faults_sends_faultsoff_to_every_lane():
    sent = []
    fake = type("PL", (), {"lanes": [0, 1, 2], "_send": lambda self, ln, m: sent.append((ln, m))})()
    tproc.ProcLaneSet.quiesce_child_faults(fake)
    assert sent == [(0, ("FAULTSOFF",)), (1, ("FAULTSOFF",)), (2, ("FAULTSOFF",))]


def _series(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_process_lanes_garbled_and_dropped_descriptors_converge(monkeypatch):
    """Two spawned lane processes while the parent's plane drops and
    garbles ring descriptors: each garbled one is rejected by the child
    before any dereference (kwok_shm_desc_rejects_total), each drop and
    reject turns into a re-list, every pod still reaches Running, and
    each lane is a kill target of the plane under its thread-style name.
    The children get no plane: neither kind is theirs to inject."""
    monkeypatch.delenv("KWOK_TPU_FAULTS", raising=False)
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    store = srv.store
    eng = ClusterEngine(HttpKubeClient(srv.url), _cfg(
        tick_interval=0.05, drain_shards=2, lane_procs=True,
        faults="seed=5;shm.desc_garble=0.3;shm.desc_drop=0.3"))
    try:
        eng.start()
        assert _wait(lambda: eng.ready, 60), "startup gate never closed"
        assert sorted(eng._faults._proc_targets) == ["kwok-lane0", "kwok-lane1"]
        assert all(eng._proc._lane_spec(ln)["faults"] == "off" for ln in eng._proc.lanes)
        store.create("nodes", make_node("dg-n0"))
        names = []

        def faulted():
            counts = eng._faults.counts()
            return counts.get("shm.desc_drop", 0) > 0 and counts.get("shm.desc_garble", 0) > 0

        # waves of creates until both faults have fired on the ring (a
        # loaded host can deliver a small wave through a re-list alone)
        for wave in range(20):
            for i in range(8):
                names.append(f"dg-p{wave}-{i}")
                store.create("pods", make_pod(names[-1], node="dg-n0"))
            if _wait(faulted, 1.0):
                break
        assert faulted(), eng._faults.counts()
        assert _wait(lambda: _all_running(store, names), 60)
        assert _wait(lambda: sum(
            v for k, v in _series(eng.metrics_text()).items()
            if k.startswith("kwok_shm_desc_rejects_total{")) > 0, 10)
        assert not eng.degraded
    finally:
        eng.stop()
        srv.stop()
    assert eng._faults._proc_targets == {}


def test_process_lane_child_gets_its_derived_plane():
    """A spec with child kinds: each lane's spawn payload carries the
    plane child_spec_text derives for it, as kwok_tpu's does."""
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    try:
        text = "seed=11;pump.drop=0.5;shm.torn=0.5;watch.cut=0.1"
        eng = ClusterEngine(HttpKubeClient(srv.url), _cfg(
            drain_shards=2, lane_procs=True, faults=text))
        pl = eng._proc
        pl.bank = type("B", (), {"name": "bank"})()
        for i in range(2):
            lane = type("L", (), {"index": i, "ring": type("R", (), {"name": "r"})(),
                                  "slot": type("S", (), {"name": "s"})(),
                                  "mbank": type("M", (), {"name": "m"})()})()
            got = pl._lane_spec(lane)["faults"]
            assert got == jf.child_spec_text(jf.FaultSpec.parse(text), i)
            assert tf.FaultSpec.parse(got).lane == i and "watch.cut" not in got
    finally:
        srv.stop()
