"""The CUDA tick kernel on the card. Marked ``cuda``: without an NVIDIA GPU
every test here skips. On a machine with one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX's CPU devices; these
tests import neither JAX nor the JAX package, only ``kwok_tpu_torch``.)

Each launch is held against the kernel's plain torch version on the same
card tensors: every state field, mask and counter bit-exact for constant,
uniform and weighted delays; exponential delays go through ``logf``, so
their ``fire_at`` is held to rtol 1e-6 and the rows that differ in any
field to 1e-3 of the capacity. Capacities include ragged ones (not a
multiple of the 256-thread block) to exercise the masked tail. The graft
twin (``kwok_tpu_torch.graft``) launches the kernel at its full 65,536
rows, and a dispatch's wire (``pack_wire``) is enqueued without waiting
for the stream, where a host constant copied to the card would wait.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from kwok_tpu_torch import models as tm
from kwok_tpu_torch.edge.mockserver import FakeKube
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
from kwok_tpu_torch.models.defaults import chaos_pod_rules
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops.tick import MultiTickKernel

pytestmark = pytest.mark.cuda

FIELDS = ("phase", "cond_bits", "pending_rule", "fire_at", "hb_due", "gen")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py on a machine with one")
    return torch.device("cuda")


def uniform_weighted_rules():
    to = ["Running", "Succeeded", "Failed"]
    return [
        tm.LifecycleRule(
            name=f"w{i}", resource=tm.ResourceKind.POD, from_phases=("Pending",),
            effect=tm.StatusEffect(to_phase=to[i]),
            delay=tm.Delay.uniform(0.1, 0.9), weight=w,
        )
        for i, w in enumerate([1, 0, 3])
    ]


SPECS = {
    "default": lambda: cuda_tick.TickSpec(
        tm.compile_rules(tm.default_pod_rules(), tm.ResourceKind.POD), 30.0, (), -1),
    "nodes-hb": lambda: cuda_tick.TickSpec(
        tm.compile_rules(tm.default_node_rules(), tm.ResourceKind.NODE), 0.3,
        ("Ready",), 1),
    "weighted-uniform": lambda: cuda_tick.TickSpec(
        tm.compile_rules(uniform_weighted_rules(), tm.ResourceKind.POD), 30.0, (), -1),
    "chaos": lambda: cuda_tick.TickSpec(
        tm.compile_rules(chaos_pod_rules(1.0), tm.ResourceKind.POD), 30.0, (), -1),
}


def population(cap: int, seed: int):
    """A numpy (host-layout) population made from a seed."""
    rng = np.random.default_rng(seed)
    s = ts.to_numpy(ts.new_row_state(cap, "cpu"))
    s.active[:] = rng.random(cap) < 0.9
    s.phase[:] = rng.integers(0, 2, cap)
    s.sel_bits[:] = rng.integers(0, 4, cap).astype(np.uint32)
    s.has_deletion[:] = rng.random(cap) < 0.1
    return s


@pytest.mark.parametrize("cap", [1001, 70_000])
@pytest.mark.parametrize("steps", [1, 16])
@pytest.mark.parametrize("rules", sorted(SPECS))
def test_kernel_matches_plain_on_card(card, rules, steps, cap):
    spec = SPECS[rules]()
    host = population(cap, seed=cap + steps)
    k_state = ts.from_numpy(host, card)
    p_state = ts.from_numpy(host, card)
    exact = rules != "chaos"
    fired = 0
    for n, now in enumerate((0.0, 0.7, 3.0), start=1):
        seed = cuda_tick.SEED_BASE + n
        before = cuda_tick.tick_steps.launches
        kd, kx, kh, kc = cuda_tick.tick_steps(k_state, spec, now, seed, steps, 0.05)
        assert cuda_tick.tick_steps.launches == before + 1
        pd, px, ph, pc = cuda_tick.tick_steps_plain(p_state, spec, now, seed, steps, 0.05)
        torch.cuda.synchronize()
        kf, pf = k_state.fire_at, p_state.fire_at
        assert torch.equal(torch.isinf(kf), torch.isinf(pf))
        fin = ~torch.isinf(kf)
        if exact:
            for f in FIELDS:
                assert torch.equal(getattr(k_state, f), getattr(p_state, f)), f
            assert torch.equal(kd, pd) and torch.equal(kx, px) and torch.equal(kh, ph)
            assert torch.equal(kc, pc)
        else:
            torch.testing.assert_close(kf[fin], pf[fin], rtol=1e-6, atol=0.0)
            differ = (kd != pd) | (kx != px) | (kh != ph)
            for f in ("phase", "cond_bits", "pending_rule", "gen"):
                differ |= getattr(k_state, f) != getattr(p_state, f)
            assert int(differ.sum()) <= 1e-3 * cap
            # carry the plain side forward from the kernel's state
            for f in FIELDS:
                getattr(p_state, f).copy_(getattr(k_state, f))
        fired += int(kc[0]) + int(kc[1])
    assert fired > 0


def test_fused_wire_on_card_matches_cpu(card):
    """The port's MultiTickKernel on the card and on the CPU (the plain
    version) give the same wire bytes, ragged capacities included."""
    specs = [
        (tm.compile_rules(tm.default_node_rules(), tm.ResourceKind.NODE), 2.0, (), 1),
        (tm.compile_rules(tm.default_pod_rules(), tm.ResourceKind.POD), 2.0, (), -1),
    ]
    caps = (1001, 4099)
    hosts = [population(c, seed=c) for c in caps]
    on_card = MultiTickKernel(specs, steps=6, dt=0.05, device=card)
    on_cpu = MultiTickKernel(specs, steps=6, dt=0.05, device="cpu")
    gs = tuple(ts.from_numpy(h, card) for h in hosts)
    cs = tuple(ts.from_numpy(h, "cpu") for h in hosts)
    for now in (0.0, 1.7, 3.4):
        _, gw = on_card(gs, now)
        _, cw = on_cpu(cs, now)
        np.testing.assert_array_equal(np.asarray(gw), np.asarray(cw))
        assert gw.is_ready()


def test_graft_twin_launches_the_kernel_at_full_width(card):
    """kwok_tpu_torch.graft.entry() on the card: 65,536 pod rows on the
    chaos rules, three dispatches of its step, each a launch of tick.cu,
    held against the plain version on a copy of its starting state."""
    from kwok_tpu_torch import graft

    step, (state, now0, seed) = graft.entry()
    assert state.capacity == 65_536 and state.device.type == "cuda"
    for n, now in enumerate((now0, 1.0, 6.0)):
        start = ts.RowState(*(t.clone() for t in state))
        before = cuda_tick.tick_steps.launches
        kd, kx, kh, kc = step(state, now, seed + n)
        assert cuda_tick.tick_steps.launches == before + 1
        pd, px, ph, pc = cuda_tick.tick_steps_plain(start, step.spec, now, seed + n, 1, 0.0)
        torch.cuda.synchronize()
        k, p = ts.to_numpy(state), ts.to_numpy(start)
        np.testing.assert_allclose(k.fire_at, p.fire_at, rtol=1e-6)
        differ = np.zeros(state.capacity, bool)
        for f in ("phase", "cond_bits", "pending_rule", "hb_due", "gen"):
            differ |= getattr(k, f) != getattr(p, f)
        for a, b in ((kd, pd), (kx, px), (kh, ph)):
            differ |= (a != b).cpu().numpy()
        assert differ.sum() <= 1e-5 * state.capacity


def _busy_for(seconds_hint: float) -> None:
    """Queue a device-side sleep long enough that the stream is still
    running when a non-blocking host call returns."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * seconds_hint))


def test_host_constant_copied_to_the_card_waits_for_the_stream(card):
    """The premise of the dispatch path's purity rule: torch.tensor of a
    host value onto the card is a pageable copy that PyTorch follows with a
    stream sync, so the host waits for the queued work."""
    _busy_for(0.2)
    torch.tensor(float("inf"), dtype=torch.float32, device=card)
    assert torch.cuda.current_stream().query()


def test_pack_wire_does_not_wait_for_the_stream(card):
    """next_due and packbits build their constants on the card: a
    dispatch's wire is enqueued while the stream is still running."""
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.tick import next_due, pack_wire

    spec = SPECS["chaos"]()
    st = ts.from_numpy(population(70_000, 3), card)
    d, x, h, c = cuda_tick.tick_steps(st, spec, 0.0, cuda_tick.SEED_BASE + 1, 1, 0.05)
    outs = [TickOutputs(st, d, x, h, c[0], c[1])]
    pack_wire(outs)  # kernels loaded before the check
    _busy_for(0.2)
    next_due(st)
    pack_wire(outs)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()


def test_wrapper_rejects_mixed_devices(card):
    spec = SPECS["default"]()
    st = ts.new_row_state(64, card)
    with pytest.raises(ValueError, match="cpu"):
        cuda_tick.tick_steps(st._replace(gen=st.gen.cpu()), spec, 0.0, 1, 1, 0.05)


def test_threaded_engine_on_card(card):
    server = FakeKube()
    eng = ClusterEngine(server, EngineConfig(manage_all_nodes=True, tick_interval=0.02))
    assert eng.nodes.state.device.type == "cuda"
    before = cuda_tick.tick_steps.launches
    eng.start()
    threads = list(eng._threads)
    try:
        for i in range(20):
            server.create("nodes", {"metadata": {"name": f"n{i}"}})
        for i in range(300):
            server.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": "default",
                             "finalizers": ["x/y"]},
                "spec": {"nodeName": f"n{i % 20}"},
                "status": {"phase": "Pending"},
            })
        deadline = time.time() + 60
        while time.time() < deadline and server.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running"
        ) < 300:
            time.sleep(0.05)
        assert server.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running"
        ) == 300
        for i in range(30):
            server.delete("pods", "default", f"p{i}", grace_seconds=30)
        while time.time() < deadline and server.count("pods") > 270:
            time.sleep(0.05)
        assert server.count("pods") == 270
    finally:
        eng.stop()
    assert not any(t.is_alive() for t in threads)
    assert cuda_tick.tick_steps.launches > before


def test_cni_provider_on_threaded_lanes_on_card(card):
    """--enable-cni's engine path on 2 threaded lanes on the card: every
    pod Running with its provider IP (all distinct, none from the pool),
    one remove per deleted pod, the kernel launched."""
    from kwok_tpu_torch import cni

    setups, removes = {}, []

    def setup(ns, name, uid):
        ip = f"100.64.{len(setups) // 250}.{len(setups) % 250 + 1}"
        setups[name] = ip
        return [ip]

    cni.register(setup, lambda ns, name, uid: removes.append(name))
    server = FakeKube()
    eng = ClusterEngine(server, EngineConfig(manage_all_nodes=True, tick_interval=0.02,
                                             drain_shards=2, enable_cni=True))
    before = cuda_tick.tick_steps.launches
    eng.start()
    try:
        for i in range(10):
            server.create("nodes", {"metadata": {"name": f"n{i}"}})
        for i in range(200):
            server.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": "default"},
                "spec": {"nodeName": f"n{i % 10}"},
                "status": {"phase": "Pending"},
            })
        deadline = time.time() + 60

        def running():
            return [p for p in server.list("pods")
                    if (p.get("status") or {}).get("phase") == "Running"
                    and (p.get("status") or {}).get("podIP")]

        while time.time() < deadline and len(running()) < 200:
            time.sleep(0.05)
        pods = running()
        assert len(pods) == 200
        assert all(p["status"]["podIP"] == setups[p["metadata"]["name"]] for p in pods)
        assert len({p["status"]["podIP"] for p in pods}) == 200
        for i in range(20):
            server.delete("pods", "default", f"p{i}")
        while time.time() < deadline and len(removes) < 20:
            time.sleep(0.05)
        time.sleep(0.5)
        assert sorted(removes) == sorted(f"p{i}" for i in range(20))
    finally:
        eng.stop()
        cni._provider = None
    assert cuda_tick.tick_steps.launches > before


def test_ha_standby_holds_then_takes_over_on_card(card):
    """A warm standby on 2 threaded lanes on the card: while a ghost
    primary renews the lease, its rows reach the stacked state and
    tick.cu never launches, nothing is written; when the ghost stops, it
    takes over, launches and runs every pod, and the kernel is held
    bit-exact against its plain version at the stacked state it leaves."""
    import threading

    server = FakeKube()
    lease = ("kube-system", "kwok-tpu-engine")
    ghost = {"holderIdentity": "ghost", "leaseDurationSeconds": 2}
    assert server.lease_create(*lease, ghost)[0] == 201
    alive = threading.Event()
    alive.set()

    def renew():
        while alive.is_set():
            server.lease_renew(*lease, ghost)
            time.sleep(0.2)

    threading.Thread(target=renew, daemon=True).start()
    eng = ClusterEngine(server, EngineConfig(manage_all_nodes=True, tick_interval=0.02,
                                             drain_shards=2, ha_role="standby",
                                             ha_identity="b", lease_duration=2.0,
                                             checkpoint_dir="off"))
    eng.start()
    try:
        before = cuda_tick.tick_steps.launches
        for i in range(10):
            server.create("nodes", {"metadata": {"name": f"n{i}"}})
        for i in range(200):
            server.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": "default"},
                "spec": {"nodeName": f"n{i % 10}"},
                "status": {"phase": "Pending"},
            })
        deadline = time.time() + 60
        while time.time() < deadline and eng.metrics.get("pods_managed", 0) < 200:
            time.sleep(0.05)
        time.sleep(1.0)
        assert eng.metrics.get("pods_managed", 0) == 200 and eng._ha_hold
        assert cuda_tick.tick_steps.launches == before
        stacked = eng._lanes.stacked["pods"]
        assert int(stacked.active.sum()) == 200 and stacked.active.device.type == "cuda"
        assert not any((p.get("status") or {}).get("phase") == "Running"
                       for p in server.list("pods"))
        alive.clear()
        while time.time() < deadline and sum(
                (p.get("status") or {}).get("phase") == "Running"
                for p in server.list("pods")) < 200:
            time.sleep(0.05)
        assert eng._ha.leading and not eng._ha_hold and not eng.degraded
        assert sum((p.get("status") or {}).get("phase") == "Running"
                   for p in server.list("pods")) == 200
        assert cuda_tick.tick_steps.launches > before
        fused = eng._get_fused()
        for spec, st in zip(fused.specs, (eng._lanes.stacked["nodes"], stacked)):
            outs = {}
            for name, fn in (("kernel", cuda_tick.tick_steps), ("plain", cuda_tick.tick_steps_plain)):
                s = ts.RowState(*(t.clone() for t in st))
                outs[name] = (s, fn(s, spec, eng._now() + 1.0, cuda_tick.SEED_BASE, 1, 0.05))
            for f in FIELDS:
                assert torch.equal(getattr(outs["kernel"][0], f), getattr(outs["plain"][0], f)), f
    finally:
        alive.clear()
        eng.stop()


def test_killed_drain_worker_restarts_on_card(card):
    """Threaded lanes on the card under the fault plane: a pill in lane
    0's drain worker mid-churn is absorbed by the watchdog, the worker
    restarts in place (one restart_log entry for the one kill), every pod
    reaches Running, the engine is not degraded and the kernel launched
    on the card."""
    from kwok_tpu_torch.telemetry.errors import worker_restarts_total

    server = FakeKube()
    eng = ClusterEngine(server, EngineConfig(
        manage_all_nodes=True, tick_interval=0.02, drain_shards=2, faults="seed=11"))
    assert eng._lanes.stacked == {} and eng.device.type == "cuda"
    before = cuda_tick.tick_steps.launches
    r0 = worker_restarts_total("kwok-lane0")

    def running():
        return server.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running")

    def wait(pred, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline and not pred():
            time.sleep(0.05)
        return pred()

    eng.start()
    try:
        assert eng._lanes.stacked["pods"].phase.device.type == "cuda"
        for i in range(10):
            server.create("nodes", {"metadata": {"name": f"n{i}"}})
        pod = lambda i: {  # noqa: E731
            "metadata": {"name": f"p{i}", "namespace": "default"},
            "spec": {"nodeName": f"n{i % 10}"}, "status": {"phase": "Pending"},
        }
        for i in range(100):
            server.create("pods", pod(i))
        assert wait(lambda: running() == 100)
        assert eng._faults.kill_worker("kwok-lane0")
        for i in range(100, 200):
            server.create("pods", pod(i))
        assert wait(lambda: worker_restarts_total("kwok-lane0") > r0)
        assert wait(lambda: running() == 200)
        assert [r["thread"] for r in eng._watchdog.restart_log()] == ["kwok-lane0"]
        assert not eng.degraded
    finally:
        eng.stop()
    assert cuda_tick.tick_steps.launches > before


def test_auditor_repairs_silent_divergence_on_card(card):
    """The anti-entropy auditor's threaded end-to-end case on the card,
    over 2 threaded lanes: once every pod is Running, a phase silently
    rewound and a pod silently deleted on the store are detected
    (stale-row, ghost-row) and repaired within 15 s, the engine ends not
    degraded, and the kernel launched on the card."""
    import drift_rig

    server = FakeKube()
    eng = ClusterEngine(server, EngineConfig(
        manage_all_nodes=True, tick_interval=0.02, drain_shards=2, audit_interval=0.4))
    before = cuda_tick.tick_steps.launches

    def phase(name):
        return ((server.get("pods", "default", name) or {}).get("status") or {}).get("phase")

    def wait(pred, timeout=30.0):
        deadline = time.time() + timeout
        while time.time() < deadline and not pred():
            time.sleep(0.05)
        return pred()

    eng.start()
    try:
        server.create("nodes", {"metadata": {"name": "te-n"}})
        names = [f"tep{i}" for i in range(6)]
        for n in names:
            server.create("pods", {"metadata": {"name": n, "namespace": "default"},
                                   "spec": {"nodeName": "te-n"},
                                   "status": {"phase": "Pending"}})
        assert wait(lambda: all(phase(n) == "Running" for n in names))
        time.sleep(0.5)
        assert drift_rig.silent_patch(server, "pods", "default", names[0],
                                      lambda o: o["status"].update(phase="Pending"))
        assert drift_rig.silent_delete(server, "pods", "default", names[1])
        gone = ("default", names[1])
        assert wait(lambda: phase(names[0]) == "Running"
                    and drift_rig.row_rv(eng, "pods", gone) is None, 15.0)
        aud = eng._auditor
        assert aud.detected_total(reason="stale-row") >= 1
        assert aud.detected_total(reason="ghost-row") >= 1
        assert aud.repaired_total >= 2
        assert wait(lambda: not eng.degraded, 5.0)
    finally:
        eng.stop()
    assert cuda_tick.tick_steps.launches > before


def test_profiler_records_every_tick_launch_on_card(card, tmp_path):
    """profile_dir on the card: the tick thread's torch.profiler window
    (ticks [2, 102), cut short by stop) holds one tick_kernel event per
    launch the window recorded."""
    from kwok_tpu_torch.profiling import profile_summary

    server = FakeKube()
    prof = str(tmp_path / "prof")
    eng = ClusterEngine(server, EngineConfig(
        manage_all_nodes=True, tick_interval=0.02, profile_dir=prof))
    eng.start()
    try:
        server.create("nodes", {"metadata": {"name": "n0"}})
        for wave in range(8):
            for i in range(20):
                server.create("pods", {
                    "metadata": {"name": f"p{wave}-{i}", "namespace": "default"},
                    "spec": {"nodeName": "n0"}, "status": {"phase": "Pending"},
                })
            time.sleep(0.1)
        deadline = time.time() + 60
        while time.time() < deadline and server.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running"
        ) < 160:
            time.sleep(0.05)
    finally:
        eng.stop()
    s = profile_summary(prof)
    meta = s["meta"]
    assert meta["thread"] == "kwok-tick" and meta["ticks"][0] == 2, meta
    assert meta["launches"] > 0, meta
    assert s["kernel_events"] == meta["launches"], s
    assert 0.0 < s["busy_share"] <= 1.0, s


def test_engine_resumes_on_card_through_cut_and_compaction(card):
    """The engine on the card against the port's FakeKube: a cut pods
    stream resumes (no re-list); after a compaction the next cut re-lists
    pods once. Every pod reaches Running and the kernel launches."""
    server = FakeKube()
    eng = ClusterEngine(server, EngineConfig(manage_all_nodes=True, tick_interval=0.02))
    before = cuda_tick.tick_steps.launches

    def create_and_wait(first, n):
        for i in range(first, first + n):
            server.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": "default"},
                "spec": {"nodeName": f"n{i % 10}"}, "status": {"phase": "Pending"},
            })
        deadline = time.time() + 60
        while time.time() < deadline and server.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running"
        ) < first + n:
            time.sleep(0.05)
        assert server.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running") == first + n

    eng.start()
    try:
        for i in range(10):
            server.create("nodes", {"metadata": {"name": f"n{i}"}})
        create_and_wait(0, 100)
        relists = eng.metrics["watch_relists_total"]
        eng._watches["pods"].stop()
        create_and_wait(100, 100)
        assert eng.metrics["watch_relists_total"] == relists
        # a write the pods stream never sees, then a compaction: the
        # pods resume is below the floor
        server.patch_meta("nodes", None, "n0", {"metadata": {"labels": {"a": "b"}}})
        server.compact()
        eng._watches["pods"].stop()
        create_and_wait(200, 100)
        assert eng.metrics["watch_relists_total"] == relists + 1
    finally:
        eng.stop()
    assert cuda_tick.tick_steps.launches > before


def test_stacked_lanes_with_regrow_on_card(card):
    """A stacked state of 4 lanes with ragged occupancy (full, half, one
    row, empty), regrown on the card: the regrow equals the CPU one, the
    kernel is bit-exact against its plain version at the stacked shape,
    and lane_views of the fused wire are each lane's rows."""
    from kwok_tpu_torch.ops.tick import lane_views, unpack_wire

    n, r, new_r = 4, 1000, 1536
    specs = {
        "nodes": SPECS["nodes-hb"](),
        "pods": SPECS["weighted-uniform"](),
    }
    grown = {}
    for kind in specs:
        host = population(n * r, seed=len(kind))
        occupancy = (r, r // 2, 1, 0)
        for li, occ in enumerate(occupancy):
            host.active[li * r:li * r + occ] = True
            host.active[li * r + occ:(li + 1) * r] = False
        on_card = ts.regrow_stacked(ts.from_numpy(host, card), n, new_r)
        on_cpu = ts.regrow_stacked(ts.from_numpy(host, "cpu"), n, new_r)
        got, want = ts.to_numpy(on_card), ts.to_numpy(on_cpu)
        for f in ts.RowState._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert int(got.active.sum()) == r + r // 2 + 1
        grown[kind] = got
    for kind, spec in specs.items():
        k_state = ts.from_numpy(grown[kind], card)
        p_state = ts.from_numpy(grown[kind], card)
        for step, now in enumerate((0.0, 0.6, 1.2), start=1):
            seed = cuda_tick.SEED_BASE + step
            kd, kx, kh, kc = cuda_tick.tick_steps(k_state, spec, now, seed, 1, 0.05)
            pd, px, ph, pc = cuda_tick.tick_steps_plain(p_state, spec, now, seed, 1, 0.05)
            torch.cuda.synchronize()
            for f in ts.RowState._fields:
                assert torch.equal(getattr(k_state, f), getattr(p_state, f)), (kind, f)
            assert torch.equal(kd, pd) and torch.equal(kx, px) and torch.equal(kh, ph)
            assert torch.equal(kc, pc)
    fused = MultiTickKernel([
        (tm.compile_rules(tm.default_node_rules(), tm.ResourceKind.NODE), 0.3, ("Ready",), 1),
        (tm.compile_rules(uniform_weighted_rules(), tm.ResourceKind.POD), 30.0, (), -1),
    ], device=card)
    states = tuple(ts.from_numpy(grown[k], card) for k in ("nodes", "pods"))
    outs, wire = fused(states, 1.0)
    cap = n * new_r
    counters, masks_fn, _dues, rows_fn = unpack_wire(np.asarray(wire), [cap, cap], rows=True)
    assert int(counters[0]) + int(counters[1]) > 0
    views = lane_views(masks_fn(), rows_fn(), n, new_r)
    for ki, o in enumerate(outs):
        host = ts.to_numpy(o.state)
        dirty = o.dirty.cpu().numpy()
        for li in range(n):
            lo, hi = li * new_r, (li + 1) * new_r
            vd, _vx, _vh, vph, vcb = views[li][ki]
            np.testing.assert_array_equal(vd, dirty[lo:hi])
            np.testing.assert_array_equal(vph, host.phase[lo:hi].astype(np.uint8))
            np.testing.assert_array_equal(vcb, host.cond_bits[lo:hi])


def test_process_lanes_on_card(card, tmp_path):
    """Two process lanes against the port's HTTP mock: each lane process
    runs its single-lane engine on cuda and launches the tick kernel; the
    parent makes no CUDA context of its own for them."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver

    srv = HttpFakeApiserver(store=FakeKube()).start()
    store = srv.store
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, tick_interval=0.02, drain_shards=2, lane_procs=True,
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.5, device="cuda",
    ))
    assert eng._stream is None and eng.nodes.state is None
    try:
        eng.start()
        deadline = time.time() + 120
        while not eng.ready and time.time() < deadline:
            time.sleep(0.05)
        assert eng.ready
        store.create("nodes", {"metadata": {"name": "n0"}})
        for i in range(40):
            store.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": "default"},
                "spec": {"nodeName": "n0", "containers": [{"name": "c", "image": "b"}]},
                "status": {"phase": "Pending"},
            })

        def done():
            st = eng._proc.status()
            return (all((p.get("status") or {}).get("phase") == "Running"
                        for p in store.list("pods"))
                    and all(s["device"] == "cuda" and s["launches"] > 0 for s in st))

        while not done() and time.time() < deadline:
            time.sleep(0.1)
        assert done(), eng._proc.status()
        assert all(s["pods"] > 0 for s in eng._proc.status())
    finally:
        eng.stop()
        srv.stop()
    assert {"lane0.ckpt.json", "lane1.ckpt.json"} <= set(os.listdir(tmp_path))


def test_federation_on_card(card, tmp_path):
    """A 2-member federation with two rule-set groups on cuda: both
    groups' stacked states live on the card, every group launches the
    kernel, every member's pods reach Running with its checkpoint
    written, and the kernel is bit-exact against its plain version at
    each group's stacked shape."""
    import dataclasses

    from kwok_tpu_torch.engine import FederatedEngine

    servers = [FakeKube(), FakeKube()]
    base = EngineConfig(manage_all_nodes=True, tick_interval=0.02, initial_capacity=300,
                        checkpoint_dir=str(tmp_path), checkpoint_interval=0.5, device="cuda")
    fed = FederatedEngine(servers, base, member_configs=[
        base, dataclasses.replace(base, pod_rules=tm.default_pod_rules(
            running_delay=tm.Delay.constant(0.2)))])
    assert len(fed.groups) == 2
    before = cuda_tick.tick_steps.launches
    fed.start()
    try:
        for c, s in enumerate(servers):
            s.create("nodes", {"metadata": {"name": f"n{c}"}})
            for i in range(40):
                s.create("pods", {
                    "metadata": {"name": f"p{i}", "namespace": "default"},
                    "spec": {"nodeName": f"n{c}", "containers": [{"name": "c", "image": "b"}]},
                    "status": {"phase": "Pending"},
                })
        deadline = time.time() + 120

        def done():
            return fed.ready and all(
                s.count("pods", lambda p: p["status"].get("phase") == "Running") == 40
                for s in servers)

        while not done() and time.time() < deadline:
            time.sleep(0.05)
        assert done()
    finally:
        fed.stop()
    assert cuda_tick.tick_steps.launches > before
    assert all(g.dispatches > 0 for g in fed.groups)
    assert {"member0.ckpt.json", "member1.ckpt.json"} <= set(os.listdir(tmp_path))
    for g in fed.groups:
        assert all(st.device.type == "cuda" for st in g.stacked.values())
        k_states = [type(st)(*(t.clone() for t in st)) for st in (g.stacked["nodes"], g.stacked["pods"])]
        p_states = [type(st)(*(t.clone() for t in st)) for st in (g.stacked["nodes"], g.stacked["pods"])]
        for spec, ks, ps in zip(g.fused.specs, k_states, p_states):
            k = cuda_tick.tick_steps(ks, spec, 5.0, cuda_tick.SEED_BASE, 1, 0.02)
            p = cuda_tick.tick_steps_plain(ps, spec, 5.0, cuda_tick.SEED_BASE, 1, 0.02)
            torch.cuda.synchronize()
            for f in ts.RowState._fields:
                assert torch.equal(getattr(ks, f), getattr(ps, f)), f
            for a, b in zip(k, p):
                assert torch.equal(a, b)


def _cli_on_card(tmp_path, monkeypatch, n_pods=200):
    """The kwok entry point on the card over the port's HTTP mock with 2
    threaded lanes and 4 nodes: returns its /metrics text once all
    ``n_pods`` pods are Running, the Running count and the kernel's
    launches during the run. The server binds port 0; the port is read
    off the server the CLI built."""
    import threading
    import urllib.request

    from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver
    from kwok_tpu_torch.kwok import cli
    from kwok_tpu_torch.kwok import server as server_mod

    servers = []

    class Recorded(server_mod.EngineServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(server_mod, "EngineServer", Recorded)
    srv = HttpFakeApiserver(store=FakeKube()).start()
    stop, rc = threading.Event(), []
    argv = ["--master", srv.url, "--kubeconfig", str(tmp_path / "none"),
            "--manage-all-nodes", "true", "--tick-interval", "0.02",
            "--drain-shards", "2", "--server-address", "127.0.0.1:0",
            "--config", str(tmp_path / "absent.yaml")]
    before = cuda_tick.tick_steps.launches
    t = threading.Thread(target=lambda: rc.append(cli.main(argv, stop_event=stop)))
    t.start()

    def running():
        return srv.store.count(
            "pods", lambda p: (p.get("status") or {}).get("phase") == "Running")

    try:
        for i in range(4):
            srv.store.create("nodes", {"metadata": {"name": f"hn{i}"}})
        for i in range(n_pods):
            srv.store.create("pods", {
                "metadata": {"name": f"hp{i}", "namespace": "default"},
                "spec": {"nodeName": f"hn{i % 4}"}, "status": {"phase": "Pending"},
            })
        deadline = time.time() + 60
        while time.time() < deadline and (not servers or running() < n_pods):
            time.sleep(0.05)
        assert servers, "the CLI built no EngineServer"
        url = f"http://127.0.0.1:{servers[0].port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            text = r.read().decode()
    finally:
        stop.set()
        t.join(60)
        srv.stop()
    assert rc == [0]
    return text, running(), cuda_tick.tick_steps.launches - before


def _sum_series(text: str, prefix: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(prefix))


def test_cli_over_http_on_card_routes_natively(card, tmp_path, monkeypatch):
    """The watches queue raw lines, the router partitions them natively
    (kwok_route_partition_events_total > 0), every pod reaches Running
    and the kernel launches."""
    text, running, launches = _cli_on_card(tmp_path, monkeypatch)
    assert running == 200
    assert _sum_series(text, "kwok_route_partition_events_total{") > 0
    assert launches > 0


def test_cli_over_http_on_card_ships_through_the_pump(card, tmp_path, monkeypatch):
    """Egress leaves in native pump batches (kwok_pump_requests_total > 0,
    at least one per pod) and every pod reaches Running."""
    text, running, launches = _cli_on_card(tmp_path, monkeypatch)
    assert running == 200
    assert _sum_series(text, "kwok_pump_requests_total ") >= 200
    assert _sum_series(text, "kwok_pump_send_seconds_count ") > 0
    assert launches > 0


def test_engine_on_card_against_native_server(card):
    """The single-lane engine on the card against the port's native mock
    apiserver: every node Ready and every pod Running with a pod IP, the
    kernel launched, then held bit-exact against its plain version at the
    engine's capacities, on the rows the run left."""
    import signal
    import subprocess

    from kwok_tpu_torch import native
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    binary = native.apiserver_binary()
    assert binary is not None, native.apiserver_build_log
    proc = subprocess.Popen([binary, "--port", "0"], stdout=subprocess.PIPE, text=True)
    eng = None
    try:
        line = proc.stdout.readline()
        assert line.startswith("mock apiserver listening on "), line
        url = line.split()[-1]
        client = HttpKubeClient(url)
        for i in range(20):
            client.create("nodes", {"metadata": {"name": f"n{i}"}})
        for i in range(300):
            client.create("pods", {
                "metadata": {"name": f"p{i}", "namespace": "default"},
                "spec": {"nodeName": f"n{i % 20}", "containers": [{"name": "c", "image": "b"}]},
                "status": {"phase": "Pending"},
            })
        eng = ClusterEngine(HttpKubeClient(url), EngineConfig(
            manage_all_nodes=True, tick_interval=0.02, drain_shards=1))
        assert eng.nodes.state.device.type == "cuda"
        before = cuda_tick.tick_steps.launches
        eng.start()

        def running():
            return sum((p.get("status") or {}).get("phase") == "Running"
                       and bool(p["status"].get("podIP")) for p in client.list("pods"))

        deadline = time.time() + 60
        while time.time() < deadline and running() < 300:
            time.sleep(0.1)
        assert running() == 300
        assert all(any(c["type"] == "Ready" and c["status"] == "True"
                       for c in n["status"]["conditions"]) for n in client.list("nodes"))
        eng.stop()
        eng, stopped = None, eng
        assert cuda_tick.tick_steps.launches > before
        fused = stopped._get_fused()
        now = stopped._now()
        for spec, state in zip(fused.specs, (stopped.nodes.state, stopped.pods.state)):
            k_state = ts.RowState(*(x.clone() for x in state))
            p_state = ts.RowState(*(x.clone() for x in state))
            k = cuda_tick.tick_steps(k_state, spec, now, cuda_tick.SEED_BASE, fused.steps, fused.dt)
            p = cuda_tick.tick_steps_plain(p_state, spec, now, cuda_tick.SEED_BASE,
                                           fused.steps, fused.dt)
            torch.cuda.synchronize()
            for f in ts.RowState._fields:
                assert torch.equal(getattr(k_state, f), getattr(p_state, f)), f
            for a, b in zip(k[:3], p[:3]):
                assert torch.equal(a, b)
            assert torch.equal(k[3], p[3])
        client.close()
    finally:
        if eng is not None:
            eng.stop()
        proc.send_signal(signal.SIGTERM)
        proc.wait(10)
