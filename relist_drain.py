"""How long threaded lanes take to drain one re-list of every stream, on
the CPU.

    python3 relist_drain.py [--lib torch|jax] [--store port|ref]
                            [--nodes 200] [--pods 10000] [--lanes 8]
                            [--relists 1] [--profile FILE]

An engine on ``--lanes`` threaded lanes (``device="cpu"``; ``--lib jax``
runs ``kwok_tpu``'s engine on JAX's CPU backend) over an in-process
store (``--store port``: ``kwok_tpu_torch``'s FakeKube; ``ref``:
``kwok_tpu``'s) takes ``--nodes`` nodes and ``--pods`` pods to Running.
Then ``resync_streams()`` runs ``--relists`` times back to back (each
once the LISTs of the one before are in), and the script waits until every stream has re-listed and every queue (the
ingest queue and each lane's) is empty. It prints one JSON line: the
drain seconds from the first resync until then, the peak summed lane
queue depth in items (polled every 5 ms) and the row writes staged for
the device (``stage_init`` and ``stage_update`` calls) since the first
resync. ``--profile FILE`` writes a cProfile of the
drain instead, on one thread: an engine that is not started ingests the
objects by hand (``LaneSet.tick_once``), then one re-list of pods is
routed and applied inline (``LaneSet.drain_inline``) under the profiler
(``pstats`` reads FILE).

A CPU measurement of host code: no device time is in it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _make_pod(name: str, node: str) -> dict:
    return {
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"nodeName": node, "containers": [{"name": "c", "image": "i"}]},
        "status": {"phase": "Pending"},
    }


def _make_node(name: str) -> dict:
    return {"metadata": {"name": name}, "status": {}}


def _wait(pred, timeout: float, every: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _running(store) -> int:
    return sum(1 for p in store.list("pods")
               if (p.get("status") or {}).get("phase") == "Running")


class _ListCounter:
    """The store as the engine's client, counting LIST calls."""

    def __init__(self, store) -> None:
        self._store = store
        self.lists = 0

    def list(self, kind, **kw):
        out = self._store.list(kind, **kw)
        self.lists += 1
        return out

    def __getattr__(self, name):
        return getattr(self._store, name)


def _engine(a, client):
    cap = 2 * a.pods
    if a.lib == "torch":
        from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

        return ClusterEngine(client, EngineConfig(
            manage_all_nodes=True, device="cpu", drain_shards=a.lanes,
            initial_capacity=cap, tick_interval=0.05))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from kwok_tpu.engine import ClusterEngine, EngineConfig

    return ClusterEngine(client, EngineConfig(
        manage_all_nodes=True, drain_shards=a.lanes,
        initial_capacity=cap, tick_interval=0.05))


def _queue_relist(eng, client, kind: str) -> None:
    """One re-list of ``kind`` onto the ingest queue, as the engine's watch
    thread queues it (``kwok_tpu``'s watch loop does it inline: its
    objects as ADDED events, then the RESYNC marker)."""
    relist = getattr(eng, "_relist", None)
    if relist is not None:
        relist(kind, {}, False)
        return
    objs = client.list(kind)
    for o in objs:
        eng._q.put((kind, "ADDED", o, time.monotonic()))
    eng._q.put((kind, "RESYNC", objs, time.monotonic()))


def _profile(a, store, client) -> int:
    import cProfile

    eng = _engine(a, client)
    lanes = eng._lanes
    for i in range(a.nodes):
        store.create("nodes", _make_node(f"n{i}"))
    for i in range(a.pods):
        store.create("pods", _make_pod(f"p{i}", f"n{i % a.nodes}"))
    _queue_relist(eng, client, "nodes")
    for _ in range(2):  # ingest, then the rows at the server's revisions
        _queue_relist(eng, client, "pods")
        lanes.tick_once()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    _queue_relist(eng, client, "pods")
    lanes.drain_inline()
    prof.disable()
    s = time.perf_counter() - t0
    prof.dump_stats(a.profile)
    print(json.dumps({"lib": a.lib, "store": a.store, "pods": a.pods,
                      "lanes": a.lanes, "profiled_s": round(s, 3)}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="relist_drain.py")
    p.add_argument("--lib", choices=("torch", "jax"), default="torch")
    p.add_argument("--store", choices=("port", "ref"), default="port")
    p.add_argument("--nodes", type=int, default=200)
    p.add_argument("--pods", type=int, default=10_000)
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--relists", type=int, default=1)
    p.add_argument("--profile", default="")
    a = p.parse_args(argv)

    if a.store == "port":
        from kwok_tpu_torch.edge.mockserver import FakeKube
    else:
        from kwok_tpu.edge.mockserver import FakeKube
    store = FakeKube()
    client = _ListCounter(store)
    if a.profile:
        return _profile(a, store, client)
    eng = _engine(a, client)
    eng.start()
    try:
        if not _wait(lambda: eng.ready, 120):
            print("engine never ready", file=sys.stderr)
            return 1
        for i in range(a.nodes):
            store.create("nodes", _make_node(f"n{i}"))
        for i in range(a.pods):
            store.create("pods", _make_pod(f"p{i}", f"n{i % a.nodes}"))
        if not _wait(lambda: _running(store) == a.pods, 600, 0.5):
            print("pods never Running", file=sys.stderr)
            return 1
        lanes = eng._lanes.lanes

        def depth() -> int:
            return sum(ln.q.qsize() for ln in lanes)

        _wait(lambda: depth() == 0 and eng._q.qsize() == 0, 120)
        time.sleep(1.0)
        staged = [0]
        buffer_cls = type(lanes[0].engine.pods.buffer)  # the coordinator swaps instances
        for meth in ("stage_init", "stage_update"):
            real = getattr(buffer_cls, meth)

            def counted(self, *args, _real=real, **kw):
                staged[0] += 1
                return _real(self, *args, **kw)

            setattr(buffer_cls, meth, counted)
        lists0 = client.lists
        peak = 0
        t0 = time.perf_counter()
        for r in range(a.relists):
            # the next resync once this one's LISTs are in: each re-list
            # lands while the one before is still queued
            eng.resync_streams()
            while client.lists < lists0 + 2 * (r + 1):
                peak = max(peak, depth())
                time.sleep(0.001)
        want = lists0 + 2 * a.relists
        while True:
            d = depth()
            peak = max(peak, d)
            if client.lists >= want and d == 0 and eng._q.qsize() == 0:
                break
            if time.perf_counter() - t0 > 600:
                print("queues never drained", file=sys.stderr)
                return 1
            time.sleep(0.005)
        drain_s = time.perf_counter() - t0
        print(json.dumps({
            "lib": a.lib, "store": a.store, "nodes": a.nodes, "pods": a.pods,
            "lanes": a.lanes, "relists": a.relists, "drain_s": drain_s,
            "peak_lane_queue": peak, "rows_staged": staged[0],
            "lists": client.lists - lists0,
        }))
        return 0
    finally:
        eng.stop()


if __name__ == "__main__":
    sys.exit(main())
