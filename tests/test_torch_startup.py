"""The port engine's startup (kwok_tpu_torch.engine.ClusterEngine.start):
the warm-up dispatch runs before the watches start, and ``ready`` flips
only once the first full re-list of both kinds is ingested and on the
device, as in kwok_tpu's engine (``_warm_tick``, the startup catch-up
gate). A ``drain_shards`` above one runs the threaded lanes."""

from __future__ import annotations

import threading
import time

from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from tests.test_torch_engine import make_node, make_pod


class GatedListFakeKube(PortFakeKube):
    """The port's FakeKube whose LISTs wait until ``gate`` is set: the
    engine's watches register at once, its first re-list is held back."""

    def __init__(self) -> None:
        super().__init__()
        self.gate = threading.Event()

    def list(self, kind, **kw):
        self.gate.wait(20)
        return super().list(kind, **kw)


def test_ready_only_after_warm_up_and_first_relist():
    """start() warms the tick (one all-inactive dispatch) before the
    watches start, and ``ready`` flips only once the first re-list of
    both kinds is ingested and its rows are on the device."""
    server = GatedListFakeKube()
    server.create("nodes", make_node("n0"))
    server.create("pods", make_pod("p0", node="n0"))
    eng = TorchEngine(server, TorchConfig(manage_all_nodes=True, tick_interval=0.02, device="cpu"))
    assert not eng.ready
    eng.start()
    try:
        time.sleep(0.2)
        assert not eng.ready  # watches up, no re-list ingested yet
        assert eng.startup_resync_pending
        assert eng._get_fused()._step_n == 1  # the warm dispatch
        server.gate.set()
        deadline = time.time() + 20
        while time.time() < deadline and not eng.ready:
            time.sleep(0.01)
        assert eng.ready and not eng.startup_resync_pending
        m = eng.metrics
        assert m["nodes_managed"] == 1 and m["pods_managed"] == 1
        assert m["watch_relists_total"] == 2
    finally:
        eng.stop()
    assert not eng.ready


def test_drain_shards_above_one_runs_lanes(caplog):
    """``drain_shards`` above one runs the threaded lanes (engine/lanes.py)
    on a stacked state, with no warning, and serves pods end to end."""
    server = PortFakeKube()
    with caplog.at_level("WARNING", logger="kwok_tpu_torch.engine"):
        eng = TorchEngine(server, TorchConfig(
            manage_all_nodes=True, drain_shards=4, tick_interval=0.02, device="cpu"))
    assert not [r for r in caplog.records if "ROADMAP item 7" in r.getMessage()]
    assert eng._lanes is not None and eng._lanes.n == 4
    assert eng.nodes.state is None and eng.pods.state is None  # rows live in the stack
    eng.start()
    try:
        server.create("nodes", make_node("n0"))
        for i in range(8):
            server.create("pods", make_pod(f"p{i}", node="n0"))
        deadline = time.time() + 30
        while time.time() < deadline and server.count(
            "pods", lambda p: p["status"].get("phase") == "Running"
        ) < 8:
            time.sleep(0.02)
        assert eng.ready
        assert server.count("pods", lambda p: p["status"].get("phase") == "Running") == 8
        assert eng.metrics["pods_managed"] == 8
    finally:
        eng.stop()
    assert eng.metrics["ingest_queue_depth"] == 0


def test_run_tick_loop_hook_leaves_single_lane_start_unchanged():
    """start() with its defaults warms the scatters and the tick and runs
    the 'kwok-tick' thread, as before the federation's hook; only
    start(run_tick_loop=False) (a federation member) skips all three and
    leaves the startup gate for the federation's loop to close."""
    for default in (True, False):
        server = PortFakeKube()
        eng = TorchEngine(server, TorchConfig(manage_all_nodes=True, tick_interval=0.02, device="cpu"))
        calls = []
        eng._warm_scatters = lambda: calls.append("scatters")
        warm_tick = eng._warm_tick
        eng._warm_tick = lambda: (calls.append("tick"), warm_tick())
        if default:
            eng.start()
        else:
            eng.start(run_tick_loop=False)
        threads = list(eng._threads)
        try:
            names = [t.name for t in threads]
            assert sorted(names) == sorted(
                ["kwok-watch-nodes", "kwok-watch-pods"] + (["kwok-tick"] if default else []))
            assert calls == (["scatters", "tick"] if default else [])
            assert eng._executor is not None and eng.startup_resync_pending
            if default:
                server.create("nodes", make_node("n0"))
                deadline = time.time() + 20
                while time.time() < deadline and not eng.ready:
                    time.sleep(0.01)
                assert eng.ready
            else:
                time.sleep(0.2)
                assert not eng.ready and eng._q.qsize() >= 2  # the two RESYNCs wait
        finally:
            eng.stop()
        assert not any(t.is_alive() for t in threads)
