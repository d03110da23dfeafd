"""The port's threaded lanes (kwok_tpu_torch.engine.lanes) against
kwok_tpu.engine.lanes on the CPU.

- The ordering oracle of tests/test_lanes.py: the same interleaved
  create/revert/delete script runs through the JAX engine with 4 lanes,
  the port with 4 lanes and the port with 1 lane, each pumped by
  ``tick_once``; the per-key request sequences and the final objects
  (timestamps masked) must be equal.
- Cross-lane managed-ness fan-out, one lane per key, shedding and its
  recovery, the lane series on /metrics, and a threaded run with a
  mid-run regrow of the stacked state.
- The stacked-state pieces bit for bit against the JAX package:
  ``UpdateBuffer.flush(offset)`` (a lane's edge row included),
  ``lane_views`` and the regrow layout of ``LaneSet._regrow``. Integer,
  bool and float32 fields are compared exactly (tolerance 0).
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.ops import state as jstate
from kwok_tpu.ops import tick as jtick
from kwok_tpu.ops import updates as jupdates
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.engine import lanes as tlanes
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.kwok.server import EngineServer, render_metrics
from kwok_tpu_torch.models import compile_rules, default_node_rules, default_pod_rules
from kwok_tpu_torch.models.lifecycle import ResourceKind
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops import tick as ttick
from kwok_tpu_torch.ops import updates as tupdates
from tests.fake_apiserver import FakeKube
from tests.test_lanes import RecordingKube, _pump, _run_script
from tests.test_torch_engine import make_node, make_pod, masked


@pytest.fixture(autouse=True)
def no_swallowed_thread_exceptions():
    """A worker thread dying is a bug even when the test's own assertions
    pass (anything reaching threading.excepthook escaped a loop)."""
    errors: list = []
    old = threading.excepthook

    def hook(args):
        errors.append((args.thread.name, args.exc_type, args.exc_value))
        old(args)

    threading.excepthook = hook
    try:
        yield
    finally:
        threading.excepthook = old
    assert not errors, f"worker thread raised: {errors}"


def engine(lib: str, server, **cfg):
    if lib == "jax":
        return JaxEngine(server, JaxConfig(manage_all_nodes=True, **cfg))
    return TorchEngine(server, TorchConfig(manage_all_nodes=True, device="cpu", **cfg))


def final_objects(server):
    objs = {k: masked(server.list(k)) for k in ("nodes", "pods")}
    for o in objs["nodes"] + objs["pods"]:
        o["metadata"]["resourceVersion"] = "<rv>"
    return objs


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ------------------------------------------------------------------ oracle


def test_ordering_oracle_matches_jax_lanes_and_one_lane():
    keys = [("default", f"op{i}") for i in range(12)]
    runs = {}
    for name, lib, shards in (("jax4", "jax", 4), ("port4", "torch", 4),
                              ("port1", "torch", 1)):
        rec = RecordingKube()
        eng = engine(lib, rec, drain_shards=shards)
        assert (eng._lanes is not None) == (shards > 1)
        _run_script(eng, rec, keys)
        runs[name] = rec
    ref = runs["jax4"]
    for name in ("port4", "port1"):
        for key in keys:
            assert runs[name].per_key(key) == ref.per_key(key), (name, key)
        assert final_objects(runs[name].inner) == final_objects(ref.inner), name
    some = ref.per_key(keys[0])
    assert ("patch", "Running") in some and ("delete", None) in some
    assert len({shard_of(k, 4) for k in keys}) > 1


@pytest.mark.parametrize("lib", ["jax", "torch"])
def test_cross_lane_node_managedness_fanout(lib):
    """Pods ingested BEFORE their node is managed flip to managed through
    the routed XUPD path; both packages end in the same objects."""
    server = FakeKube()
    eng = engine(lib, server, drain_shards=4)
    for i in range(8):
        server.create("pods", make_pod(f"xp{i}", node="nx"))
        eng._q.put(("pods", "ADDED", server.get("pods", "default", f"xp{i}")))
    _pump(eng, 2)
    assert all(server.get("pods", "default", f"xp{i}")["status"]["phase"] == "Pending"
               for i in range(8))
    server.create("nodes", make_node("nx"))
    eng._q.put(("nodes", "ADDED", server.get("nodes", None, "nx")))
    _pump(eng, 3)
    assert all(server.get("pods", "default", f"xp{i}")["status"]["phase"] == "Running"
               for i in range(8))
    if lib == "torch":
        ref = FakeKube()
        jeng = engine("jax", ref, drain_shards=4)
        for i in range(8):
            ref.create("pods", make_pod(f"xp{i}", node="nx"))
            jeng._q.put(("pods", "ADDED", ref.get("pods", "default", f"xp{i}")))
        _pump(jeng, 2)
        ref.create("nodes", make_node("nx"))
        jeng._q.put(("nodes", "ADDED", ref.get("nodes", None, "nx")))
        _pump(jeng, 3)
        assert final_objects(server) == final_objects(ref)


def test_each_key_lives_in_exactly_one_lane():
    server = FakeKube()
    eng = engine("torch", server, drain_shards=4)
    server.create("nodes", make_node("n0"))
    eng._q.put(("nodes", "ADDED", server.get("nodes", None, "n0")))
    for i in range(32):
        server.create("pods", make_pod(f"lp{i}", node="n0"))
        eng._q.put(("pods", "ADDED", server.get("pods", "default", f"lp{i}")))
    _pump(eng, 2)
    for i in range(32):
        key = ("default", f"lp{i}")
        owners = [lane.index for lane in eng._lanes.lanes
                  if lane.engine.pods.pool.lookup(key) is not None]
        assert owners == [shard_of(key, 4)]
    assert sum(len(lane.engine.pods.pool) for lane in eng._lanes.lanes) == 32
    # lane engines hold no device rows; the coordinator holds the stack
    assert all(lane.engine.pods.state is None for lane in eng._lanes.lanes)
    assert eng._lanes.stacked["pods"].capacity == 4 * eng._lanes.r


def test_threaded_lanes_end_to_end_with_regrow(monkeypatch):
    """Real threads: watch ingest -> router -> lane drains -> stacked tick
    -> lane emits, with a per-lane budget small enough that the stacked
    state regrows mid-run; all pods converge with distinct IPs and more
    than one lane drained and emitted."""
    monkeypatch.setattr(tlanes, "_MIN_LANE_ROWS", 8)
    server = PortFakeKube()
    eng = TorchEngine(server, TorchConfig(
        manage_all_nodes=True, tick_interval=0.02, drain_shards=4,
        initial_capacity=16, device="cpu"))
    r0 = eng._lanes.r
    eng.start()
    threads = list(eng._threads)
    try:
        for i in range(3):
            server.create("nodes", make_node(f"tn{i}"))
        for i in range(60):
            server.create("pods", make_pod(f"thp{i}", node=f"tn{i % 3}",
                                           finalizers=["x/y"] if i < 6 else None))
        assert wait_for(lambda: server.count(
            "pods", lambda p: p["status"].get("phase") == "Running") == 60)
        for i in range(6):
            server.delete("pods", "default", f"thp{i}", grace_seconds=30)
        assert wait_for(lambda: server.count("pods") == 54)
    finally:
        eng.stop()
    assert not any(t.is_alive() for t in threads)
    assert eng._lanes.r > r0  # the stacked state regrew on the device
    pods = server.list("pods")
    assert len({p["status"]["podIP"] for p in pods}) == 54
    m = eng.metrics
    assert m["deletes_total"] == 6 and m["patch_errors_total"] == 0
    assert m["status_patches_total"] >= 63  # 60 pods + 3 nodes
    for stage in ("drain", "emit"):
        busy = [ln for ln in eng._lanes.lanes if ln.telemetry.stage_sums[stage] > 0]
        assert len(busy) > 1, stage


# ---------------------------------------------------------- re-lists


def relist_rig(pods=1000, lanes=4):
    """An unstarted engine on ``lanes`` threaded lanes over the port's
    FakeKube holding one node and ``pods`` pods bound to it."""
    kube = PortFakeKube()
    eng = engine("torch", kube, drain_shards=lanes, initial_capacity=2 * pods)
    kube.create("nodes", make_node("rn"))
    for i in range(pods):
        kube.create("pods", make_pod(f"rl{i}", node="rn"))
    return kube, eng


def route_parent_queue(eng):
    """The router's share of a drain: the parent queue onto the lane
    queues, nothing applied."""
    lanes = eng._lanes
    raw: dict = {}
    while not eng._q.empty():
        item = eng._q.get_nowait()
        if item is not None:
            lanes._route_item(item, raw)
    eng._drain_flush(raw, lanes.route, lanes.n)


def test_unchanged_relist_stages_no_row():
    """A re-list whose objects all carry the uid and revision their rows
    hold stages nothing (they stay in the prune's snapshot: no row goes)."""
    kube, eng = relist_rig()
    lanes = eng._lanes
    eng._relist("nodes", {}, False)
    for _ in range(2):  # ingest, then the rows at the server's revisions
        eng._relist("pods", {}, False)
        lanes.tick_once()
    eng._relist("pods", {}, False)
    lanes.drain_inline()
    staged = sum(ln.engine.pods.buffer.pending for ln in lanes.lanes)
    rows = sum(len(list(ln.engine.pods.pool.keys())) for ln in lanes.lanes)
    assert (staged, rows) == (0, 1000)


def test_unchanged_relist_still_repairs_a_lost_status_patch():
    """A pod whose server status went back to Pending at the revision its
    row holds (a status patch that never landed) is the one row a re-list
    stages, and it is patched back to Running, as the re-list's ADDED
    repair does in kwok_tpu."""
    import drift_rig

    kube, eng = relist_rig(pods=50)
    lanes = eng._lanes
    eng._relist("nodes", {}, False)
    for _ in range(2):
        eng._relist("pods", {}, False)
        lanes.tick_once()
    rv = kube.get("pods", "default", "rl7")["metadata"]["resourceVersion"]
    assert drift_rig.silent_patch(kube, "pods", "default", "rl7",
                                  lambda o: o["status"].update(phase="Pending"))
    assert kube.get("pods", "default", "rl7")["metadata"]["resourceVersion"] == rv
    eng._relist("pods", {}, False)
    lanes.drain_inline()
    assert sum(ln.engine.pods.buffer.pending for ln in lanes.lanes) == 1
    assert kube.get("pods", "default", "rl7")["status"]["phase"] == "Running"


def test_unchanged_relist_rebinds_a_garbled_node_binding():
    """A row that a garbled watch line left bound to a node that does not
    exist, at the server's uid and revision, is rebound by a re-list (the
    full ADDED path), as in kwok_tpu, where every re-listed object takes
    it."""
    from kwok_tpu_torch.engine.rowpool import shard_of as port_shard_of

    kube, eng = relist_rig(pods=50)
    lanes = eng._lanes
    eng._relist("nodes", {}, False)
    for _ in range(2):
        eng._relist("pods", {}, False)
        lanes.tick_once()
    key = ("default", "rl9")
    k = lanes.lanes[port_shard_of(key, lanes.n)].engine.pods
    k.pool.meta[k.pool.lookup(key)]["node"] = "r\udce0n"
    eng._relist("pods", {}, False)
    lanes.drain_inline()
    assert k.pool.meta[k.pool.lookup(key)]["node"] == "rn"


def test_back_to_back_relists_leave_one_list_queued():
    """Two re-lists of 1,000 pods routed while no lane drains: at most one
    list's items are queued, and draining applies only the newer list."""
    kube, eng = relist_rig()
    lanes = eng._lanes
    upserts = []
    for ln in lanes.lanes:
        orig = ln.engine._pod_upsert
        ln.engine._pod_upsert = lambda pod, orig=orig: (upserts.append(1), orig(pod))
    eng._relist("nodes", {}, False)
    eng._relist("pods", {}, False)
    eng._relist("pods", {}, False)
    route_parent_queue(eng)
    queued = sum(ln.q.qsize() for ln in lanes.lanes)
    assert queued <= 1000 + lanes.n
    lanes.drain_inline()
    assert len(upserts) == 1000
    assert sum(len(list(ln.engine.pods.pool.keys())) for ln in lanes.lanes) == 1000


# ---------------------------------------------------------- shedding


def shed_rig(shed_depth=4):
    kube = FakeKube()
    eng = engine("torch", kube, drain_shards=2, shed_queue_depth=shed_depth)
    lanes = eng._lanes
    kube.create("nodes", make_node("sn"))
    lanes.route("nodes", "ADDED", kube.get("nodes", None, "sn"))
    li = shard_of(("default", "sp0"), 2)
    kube.create("pods", make_pod("sp0", node="sn"))
    return kube, eng, lanes.lanes[li], li


def test_lane_queue_shedding_and_recovery():
    kube, eng, lane, li = shed_rig()
    resyncs = []
    eng.resync_streams = lambda: resyncs.append(1)
    dropped0 = eng.metrics["dropped_jobs_total"]
    obj = kube.get("pods", "default", "sp0")
    for _ in range(12):
        eng._lanes.route("pods", "MODIFIED", obj)
    assert lane.q.qsize() <= 4 + 1
    assert lane.shedding and eng.degraded
    assert f"lane{li}_queue" in eng._degradation.reasons
    assert eng.metrics["dropped_jobs_total"] > dropped0
    # drain the backlog on this thread: the clear path runs once the depth
    # halves, lifting degraded mode and resyncing the streams
    lane.q.put(None)
    lane.drain_loop()
    assert not lane.shedding
    assert not eng.degraded
    assert resyncs == [1]


def test_lane_series_on_metrics_and_readyz_while_degraded():
    kube, eng, lane, li = shed_rig()
    eng.resync_streams = lambda: None
    obj = kube.get("pods", "default", "sp0")
    for _ in range(12):
        eng._lanes.route("pods", "MODIFIED", obj)
    eng.ready = True
    srv = EngineServer(eng, "127.0.0.1:0")
    srv.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/readyz", timeout=5)
        assert e.value.code == 503 and f"lane{li}_queue" in e.value.reason
        lane.q.put(None)
        lane.drain_loop()
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/readyz", timeout=5) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    assert "kwok_ticks_total" in render_metrics(eng) and "kwok_ticks_total" in text
    assert f'kwok_lane_stage_seconds_count{{shard="{li}",stage="drain"}} 1' in text
    assert 'kwok_lane_stage_seconds_bucket{shard="0",stage="emit",le="+Inf"} 0' in text
    assert f'kwok_lane_queue_depth{{shard="{li}"}} 0' in text
    assert f'kwok_degraded{{reason="lane{li}_queue"}} 0' in text
    assert "# TYPE kwok_lane_stage_seconds histogram" in text
    assert "kwok_dropped_jobs_total" in text


# ------------------------------------------- stacked state vs kwok_tpu


def jax_host(state):
    """A JAX RowState as numpy arrays in the JAX package's dtypes."""
    return {f: np.asarray(getattr(state, f)) for f in jstate.RowState._fields}


def port_host(state):
    host = ts.to_numpy(state)
    return {f: getattr(host, f) for f in ts.RowState._fields}


def assert_same(a: dict, b: dict):
    for f in ts.RowState._fields:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert a[f].dtype == b[f].dtype, f


def staged_lanes(n, r, seed):
    """Per-lane (init, update) write scripts from a seed: in-range rows,
    the lane's last row (its edge), repeats of a row and a release."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = list(rng.integers(0, r, 6)) + [r - 1, 0]
        inits = [(int(i), bool(rng.random() < 0.9), int(rng.integers(0, 3)),
                  int(rng.integers(0, 2**32, dtype=np.uint64)),
                  int(rng.integers(0, 2**32, dtype=np.uint64)),
                  bool(rng.random() < 0.2)) for i in rows]
        inits.append((int(rows[0]), False, 0, 0, 0, False))  # released again
        upds = [(int(i), int(rng.integers(0, 2**32, dtype=np.uint64)),
                 bool(rng.random() < 0.5)) for i in rng.integers(0, r, 4)]
        out.append((inits, upds))
    return out


def test_flush_offset_matches_jax_bit_for_bit():
    n, r = 4, 37
    jst = jstate.new_row_state(n * r)
    pst = ts.new_row_state(n * r, "cpu")
    for li, (inits, upds) in enumerate(staged_lanes(n, r, seed=3)):
        jb, pb = jupdates.UpdateBuffer(), tupdates.UpdateBuffer()
        for buf in (jb, pb):
            for c in inits:
                buf.stage_init(*c)
            for u in upds:
                buf.stage_update(*u)
        assert pb.staged_rows() == frozenset(jb.staged_rows())
        jst = jb.flush(jst, offset=li * r)
        pst = pb.flush(pst, offset=li * r, rows=r)
        assert not pb.pending
    assert_same(port_host(pst), jax_host(jst))


def test_flush_drops_out_of_lane_rows_before_the_offset():
    """A lane index at or past the lane's row count must not land in the
    next lane's first rows (the JAX flush would write it there)."""
    r = 8
    pst = ts.new_row_state(2 * r, "cpu")
    buf = tupdates.UpdateBuffer()
    buf.stage_init(r, True, phase=2, sel_bits=5)  # one past lane 0's end
    buf.stage_init(r - 1, True, phase=1)  # lane 0's edge row
    buf.stage_update(r + 3, 7, True)
    buf.stage_update(-1, 7, True)
    pst = buf.flush(pst, offset=0, rows=r)
    host = port_host(pst)
    assert host["active"].tolist() == [False] * (r - 1) + [True] + [False] * r
    assert host["phase"][r - 1] == 1 and not host["sel_bits"].any()


def test_lane_views_match_jax():
    n, r = 3, 29
    specs = [
        (compile_rules(default_node_rules(), ResourceKind.NODE), 0.0, (), 1),
        (compile_rules(default_pod_rules(), ResourceKind.POD), 30.0, (), -1),
    ]
    rng = np.random.default_rng(5)
    states = []
    for _ in range(2):
        h = ts.to_numpy(ts.new_row_state(n * r, "cpu"))
        h.active[:] = rng.random(n * r) < 0.7
        h.sel_bits[:] = 0b11
        h.has_deletion[:] = rng.random(n * r) < 0.2
        states.append(ts.from_numpy(h, "cpu"))
    fused = ttick.MultiTickKernel(specs, device="cpu")
    _outs, wire = fused(states, 0.0)  # arms and fires the zero-delay rules
    counters, masks_fn, _dues, rows_fn = ttick.unpack_wire(
        np.asarray(wire), [n * r, n * r], rows=True)
    assert int(counters[0]) + int(counters[1]) > 0
    masks, rows = masks_fn(), rows_fn()
    for rows_arg in (rows, None):
        got = ttick.lane_views(masks, rows_arg, n, r)
        ref = jtick.lane_views(masks, rows_arg, n, r)
        for li in range(n):
            for ki in range(2):
                for g, w in zip(got[li][ki], ref[li][ki]):
                    if w is None:
                        assert g is None
                    else:
                        np.testing.assert_array_equal(g, w)
        # each lane's slice is that lane's rows of the stacked wire
        for li in range(n):
            np.testing.assert_array_equal(got[li][1][0], masks[1][0][li * r:(li + 1) * r])


def test_device_regrow_matches_jax_regrow_layout():
    """ops/state.regrow_stacked (on the device, no host round trip) gives
    the layout of kwok_tpu's LaneSet._regrow (host copy + place)."""
    n, old_r, new_r = 4, 1024, 2048
    rng = np.random.default_rng(11)
    hosts = {}
    for kind in ("nodes", "pods"):
        h = ts.to_numpy(ts.new_row_state(n * old_r, "cpu"))
        h.active[:] = rng.random(n * old_r) < 0.5
        h.phase[:] = rng.integers(0, 3, n * old_r)
        h.fire_at[:] = np.where(rng.random(n * old_r) < 0.5, np.inf,
                                rng.random(n * old_r) * 30).astype(np.float32)
        h.gen[:] = rng.integers(0, 9, n * old_r)
        hosts[kind] = h
    jeng = JaxEngine(FakeKube(), JaxConfig(
        manage_all_nodes=True, drain_shards=n, initial_capacity=1024))
    assert jeng._lanes.r == old_r
    jeng._lanes.stacked = {
        k: jstate.RowState(*(jnp.asarray(getattr(h, f)) for f in jstate.RowState._fields))
        for k, h in hosts.items()
    }
    jeng._lanes._regrow(new_r)
    for kind, h in hosts.items():
        got = ts.regrow_stacked(ts.from_numpy(h, "cpu"), n, new_r)
        assert got.capacity == n * new_r
        assert_same(port_host(got), jax_host(jeng._lanes.stacked[kind]))


def test_lane_regrow_keeps_rows_and_offsets():
    """The port's LaneSet regrow through a tick: a lane past its budget
    grows every lane, rows keep their lane-local index at the new
    offsets, and the engine keeps serving."""
    server = FakeKube()
    eng = engine("torch", server, drain_shards=2, initial_capacity=8)
    ls = eng._lanes
    r0 = ls.r
    server.create("nodes", make_node("g0"))
    eng._q.put(("nodes", "ADDED", server.get("nodes", None, "g0")))
    n_pods = 3 * r0
    for i in range(n_pods):
        server.create("pods", make_pod(f"gp{i}", node="g0"))
        eng._q.put(("pods", "ADDED", server.get("pods", "default", f"gp{i}")))
    _pump(eng, 3)
    assert ls.r > r0
    assert sum(p["status"].get("phase") == "Running" for p in server.list("pods")) == n_pods
    active = ts.to_numpy(ls.stacked["pods"]).active
    for li, lane in enumerate(ls.lanes):
        for key, idx in lane.engine.pods.pool.items():
            assert active[li * ls.r + idx], key
    assert int(active.sum()) == n_pods


def test_drain_burst_yields_the_stage_lock_to_a_waiting_coordinator(monkeypatch):
    """While the coordinator waits for a lane's stage_lock
    (``swap_waiting``), the lane's drain worker ends its burst after each
    item and yields, instead of keeping the lock for up to _BURST items:
    counted in drain bursts (one per stage_lock hold), not in seconds."""
    eng = TorchEngine(PortFakeKube(), TorchConfig(
        manage_all_nodes=True, device="cpu", drain_shards=2))
    lane = eng._lanes.lanes[0]
    bursts = []
    monkeypatch.setattr(lane.telemetry, "observe_stage",
                        lambda stage, s: bursts.append(stage))

    def drain(waiting: bool) -> int:
        bursts.clear()
        lane.swap_waiting = waiting
        for i in range(5):
            lane.q.put(("pods", "XUPD", [("default", f"absent-{i}")], 0.0))
        lane.q.put(None)
        lane.drain_loop()
        return bursts.count("drain")

    monkeypatch.setattr(lane, "_YIELD_S", 0.0)
    assert drain(False) == 1
    assert drain(True) == 5
    lane.swap_waiting = False
    # the coordinator's claim raises the flag while it waits and always
    # lowers it
    with tlanes.LaneSet._claim(lane):
        assert not lane.swap_waiting
    assert not lane.swap_waiting
