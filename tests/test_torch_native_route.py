"""The port's native pre-partitioned routing and the columnar staging
against kwok_tpu's, on the CPU (the twins of the native-route cases of
tests/test_lanes.py):

- the C parser's lane of every event IS ``rowpool.shard_of``, for both
  key shapes and several lane counts, with complete and ordered lane runs;
- the ordering oracle: the same raw event stream through 4 lanes under the
  native router, under the per-record Python router
  (``KWOK_TPU_NATIVE_ROUTE=0``) and through kwok_tpu's native router gives
  the same per-key patch bodies, the same lane residency and the same
  mid-run lane regrow;
- a failure inside the columnar flush rolls its fresh rows back and the
  per-record replay still converges every pod;
- ``RouteInfo.latest_rv`` is 0 when the batch holds an ERROR;
- ``UpdateBuffer`` keeps staging order between per-row inits and
  columnar blocks (the flushed state equals kwok_tpu's bit for bit), and a
  flush that raises keeps its unapplied tail.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from kwok_tpu import native as jnative
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.ops import state as jstate
from kwok_tpu.ops import updates as jupdates
from kwok_tpu_torch import native
from kwok_tpu_torch.engine import ClusterEngine
from kwok_tpu_torch.engine import EngineConfig
from kwok_tpu_torch.engine import lanes as lanes_mod
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops import updates as upd_mod
from kwok_tpu_torch.ops.updates import UpdateBuffer
from tests.fake_apiserver import FakeKube
from tests.test_lanes import ByteRecordingKube, _pump, _raw_line, _run_raw_script
from tests.test_torch_engine import make_node, make_pod


@pytest.fixture(autouse=True)
def toolchain():
    """Both packages' native libraries, built at first use (decided here,
    not at import: every test worker must collect the same tests)."""
    if not (native.available() and jnative.available()):
        pytest.skip("no C++ toolchain")


@pytest.fixture(autouse=True)
def no_swallowed_thread_exceptions():
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


@pytest.mark.parametrize("n", [2, 4, 8])
def test_native_partition_shard_parity(n):
    parser = native.EventParser()
    pods = [make_pod(f"pp-{i}", node="n0", ns=("default" if i % 3 else "kube-sys"))
            for i in range(64)]
    bare = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "no-ns"},
            "spec": {"nodeName": "n0", "containers": []}, "status": {"phase": "Pending"}}
    lines = [_raw_line(p) for p in pods] + [_raw_line(bare)]
    b = parser.parse_raw_batch(lines, kind="pods", n_shards=n)
    for i in range(b.n):
        rec = b.record(i)
        assert b.shard[i] == shard_of((rec.namespace or "default", rec.name), n)
    seen = []
    for li in range(n):
        run = b.lane_idx[b.lane_off[li]: b.lane_off[li + 1]].tolist()
        assert run == sorted(run)
        assert all(b.shard[i] == li for i in run)
        seen += run
    assert sorted(seen) == list(range(b.n))
    nb = parser.parse_raw_batch([_raw_line(make_node(f"nn-{i}")) for i in range(64)],
                                kind="nodes", n_shards=n)
    for i in range(nb.n):
        assert nb.shard[i] == shard_of(nb.record(i).name, n)
    # and the lane runs themselves are kwok_tpu's
    jb = jnative.EventParser().parse_raw_batch(lines, kind="pods", n_shards=n)
    assert np.array_equal(b.lane_idx, jb.lane_idx) and b.lane_off == jb.lane_off


def test_ordering_oracle_native_vs_python_router(monkeypatch):
    """The same raw event stream (pods before their node, then a status
    revert, then deletionTimestamps) through 4 lanes: the port's native
    router, its per-record router and kwok_tpu's native router emit the
    same per-key patch bodies, keep each key in the same lane, and regrow
    the lanes mid-run alike."""
    import kwok_tpu.engine.lanes as jlanes

    monkeypatch.setattr(lanes_mod, "_MIN_LANE_ROWS", 64)
    monkeypatch.setattr(jlanes, "_MIN_LANE_ROWS", 64)
    keys = [("default", f"orc{i}") for i in range(600)]

    def build(lib, native_route):
        kube = ByteRecordingKube()
        if lib == "jax":
            eng = JaxEngine(kube, JaxConfig(manage_all_nodes=True, drain_shards=4,
                                            initial_capacity=256))
        else:
            eng = ClusterEngine(kube, EngineConfig(manage_all_nodes=True, drain_shards=4,
                                                   initial_capacity=256, device="cpu"))
        eng._native_route = native_route
        r0 = eng._lanes.r
        _run_raw_script(eng, kube, keys)
        return kube, eng, r0

    ref_kube, ref_eng, _ = build("torch", False)
    got_kube, got_eng, got_r0 = build("torch", True)
    jax_kube, jax_eng, _ = build("jax", True)
    assert got_eng._lanes.r > got_r0
    assert got_eng._lanes.r == ref_eng._lanes.r == jax_eng._lanes.r
    routed = sum(lane.telemetry._routed.value for lane in got_eng._lanes.lanes)
    assert routed >= len(keys)
    assert sum(lane.telemetry._routed.value for lane in ref_eng._lanes.lanes) == 0
    for key in keys:
        want = ref_kube.per_key(key)
        assert got_kube.per_key(key) == want, key
        assert jax_kube.per_key(key) == want, key
        owners = [[lane.index for lane in e._lanes.lanes
                   if lane.engine.pods.pool.lookup(key) is not None]
                  for e in (ref_eng, got_eng, jax_eng)]
        assert owners[0] == owners[1] == owners[2]
    assert any(op == "patch_body" for _k, op, _b in ref_kube.log)
    assert ("delete", None) in [(o, b) for _k, o, b in ref_kube.log]
    assert len({shard_of(k, 4) for k in keys}) == 4


def test_columnar_flush_failure_rolls_back_and_replays(monkeypatch):
    server = FakeKube()
    eng = ClusterEngine(server, EngineConfig(manage_all_nodes=True, drain_shards=2,
                                             device="cpu"))
    assert eng._native_route
    server.create("nodes", make_node("cb0"))
    eng._q.put(("nodes", "RAW", _raw_line(server.get("nodes", None, "cb0")),
                time.monotonic()))
    _pump(eng, 2)
    calls = {"n": 0}
    for lane in eng._lanes.lanes:
        buf = lane.engine.pods.buffer
        real = buf.stage_init_array

        def flaky(*a, __real=real, **kw):
            calls["n"] += 1
            if calls["n"] <= 1:
                raise RuntimeError("injected columnar failure")
            return __real(*a, **kw)

        monkeypatch.setattr(buf, "stage_init_array", flaky)
    keys = [("default", f"cbp{i}") for i in range(24)]
    for _ns, name in keys:
        server.create("pods", make_pod(name, node="cb0"))
        eng._q.put(("pods", "RAW", _raw_line(server.get("pods", "default", name)),
                    time.monotonic()))
    _pump(eng, 3)
    assert calls["n"] >= 1, "the injected failure never reached the columnar flush"
    for _ns, name in keys:
        assert server.get("pods", "default", name)["status"]["phase"] == "Running", name
    for key in keys:
        owners = [ln for ln in eng._lanes.lanes if ln.engine.pods.pool.lookup(key) is not None]
        assert len(owners) == 1, key


def test_route_info_rv_dead_on_error_batch():
    parser = native.EventParser()
    pod = make_pod("rvp0", node="n0")
    pod["metadata"]["resourceVersion"] = "123"
    lines = [_raw_line(pod), b'{"type":"ERROR","object":{"code":410,"message":"expired"}}']
    b = parser.parse_raw_batch(lines, kind="pods", n_shards=2)
    assert b.route_info.first_error == 1 and b.route_info.latest_rv == 0
    b2 = parser.parse_raw_batch(lines[:1], kind="pods", n_shards=2)
    assert b2.route_info.first_error == -1 and b2.route_info.latest_rv == 123


def _stage_both(fn):
    """The same staging calls on a port and a kwok_tpu UpdateBuffer."""
    tb, jb = UpdateBuffer(), jupdates.UpdateBuffer()
    fn(tb)
    fn(jb)
    return tb, jb


def _assert_state_eq(port_state, jax_state):
    got = ts.to_numpy(port_state)
    for f in jstate.RowState._fields:
        want = np.asarray(getattr(jax_state, f))
        assert np.array_equal(getattr(got, f), want), f


def test_update_buffer_block_order_preserved():
    def released_after_block(buf):
        buf.stage_init_array(np.array([3, 4], np.int32), 1, np.array([0, 0], np.uint32),
                             np.array([3, 3], np.uint32), np.array([False, False], bool))
        buf.stage_init(3, False)

    def block_after_release(buf):
        buf.stage_init(5, False)
        buf.stage_init_array(np.array([5], np.int32), 2, np.array([7], np.uint32),
                             np.array([1], np.uint32), np.array([False], bool))

    tb, jb = _stage_both(released_after_block)
    assert tb.staged_rows() == frozenset(jb.staged_rows()) == {3, 4}
    state = tb.flush(ts.new_row_state(8, "cpu"))
    active = ts.to_numpy(state).active
    assert not active[3] and active[4]
    _assert_state_eq(state, jb.flush(jstate.new_row_state(8)))
    tb, jb = _stage_both(block_after_release)
    assert tb.pending == jb.pending == 2
    state = tb.flush(ts.new_row_state(8, "cpu"))
    host = ts.to_numpy(state)
    assert host.active[5] and host.phase[5] == 2 and host.cond_bits[5] == 7
    _assert_state_eq(state, jb.flush(jstate.new_row_state(8)))


def test_update_buffer_flush_failure_keeps_unapplied_tail(monkeypatch):
    """Every staged init, tuple or block, goes out in one ``init_rows``
    batch: when it raises, the whole init window stays staged (and the
    updates behind it); when the update batch raises after the inits went
    out, only the updates stay. The retry applies what is left."""
    buf = UpdateBuffer()
    buf.stage_init(1, True, 1, 0, 3)
    buf.stage_init_array(np.array([2], np.int32), 1, np.array([0], np.uint32),
                         np.array([3], np.uint32), np.array([False], bool))
    buf.stage_init(3, True, 1, 0, 3)
    buf.stage_update(1, 1, False)
    real_init, real_upd = upd_mod.init_rows, upd_mod.update_rows

    def failing(*a, **kw):
        raise RuntimeError("transient device error")

    state = ts.new_row_state(8, "cpu")
    monkeypatch.setattr(upd_mod, "init_rows", failing)
    with pytest.raises(RuntimeError):
        buf.flush(state)
    assert buf.pending == 4 and buf.staged_rows() == {1, 2, 3}
    monkeypatch.setattr(upd_mod, "init_rows", real_init)
    monkeypatch.setattr(upd_mod, "update_rows", failing)
    with pytest.raises(RuntimeError):
        state = buf.flush(state)
    assert buf.pending == 1 and not buf.staged_rows()
    host = ts.to_numpy(state)
    assert host.active[1] and host.active[2] and host.active[3]
    monkeypatch.setattr(upd_mod, "update_rows", real_upd)
    state = buf.flush(state)
    assert buf.pending == 0
    assert ts.to_numpy(state).sel_bits[1] == 1
