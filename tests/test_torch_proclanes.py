"""The port's process lanes (kwok_tpu_torch.engine.proclanes) against
kwok_tpu.engine.proclanes, on the CPU.

- Every shared-memory arena written by one package's ``shm`` reads the
  same in the other's, both ways (ring wrap and pad, slot arm/clear,
  status rows, metrics seqlock with a torn write).
- ``_desc_check`` gives the reference's verdict on every reason branch.
- The node topology tap (lane 0 of 4) keeps the same node_has,
  pods_by_node and pools as the reference's, and writes the same
  patches.
- ``Watchdog.charge`` spends its budget as the reference's does.
- A spawned 2-lane engine against the port's HTTP mock converges,
  checkpoints per lane, respawns a SIGKILLed lane, stops clean, and its
  pods end with the statuses kwok_tpu's single-lane engine writes for the
  same creates (timestamps and IPs masked). A "cuda" lane on a host
  without a card fails, spends the restart budget and degrades the
  engine; it never runs on the CPU.

Every wait has a deadline.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import threading
import time
import types

import pytest
import torch

from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.engine import proclanes as jproc
from kwok_tpu.engine import shm as jshm
from kwok_tpu.resilience.watchdog import Watchdog as JaxWatchdog
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
from kwok_tpu_torch.engine import proclanes as tproc
from kwok_tpu_torch.engine import shm as tshm
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.resilience.watchdog import Watchdog as PortWatchdog
from kwok_tpu_torch.telemetry.errors import worker_crash_ledger
from tests.test_torch_engine import make_node, make_pod, masked, sync_engine

SHM = {"jax": jshm, "torch": tshm}


def _wait(pred, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# ------------------------------------------------------------ shm interop


def _ring(w, r, name):
    ring = w.RawRing(name, 100, create=True)
    reader = r.RawRing(name)
    try:
        a, b = b"a" * 60, b"b" * 50
        off = ring.try_write(a)
        assert off == 0 and reader.read(off, len(a)) == a
        # 60 + 50 > 100: the writer pads to the wrap point
        off = ring.try_write(b)
        assert off == 100 and reader.read(off, len(b)) == b
        assert int(ring.arena.hdr[w.RawRing.R]) == 150
        assert int(reader.arena.hdr[r.RawRing.W]) == 150
        assert ring.free_bytes() == 100
        # from position 50 a 100-byte blob needs a 50-byte pad: no room
        assert ring.try_write(b"c" * 100) is None
        assert ring.try_write(b"c" * 50) == 150
        assert ring.try_write(b"d" * 51) is None  # full until the reader consumes
        assert reader.read(150, 50) == b"c" * 50
    finally:
        reader.close()
        ring.close(unlink=True)


def _slot(w, r, name):
    slot = w.InflightSlot(name, 64, create=True)
    reader = r.InflightSlot(name)
    try:
        assert reader.peek() is None
        assert slot.arm(b"frames-1")
        assert reader.peek() == b"frames-1"
        assert slot.arm(b"f2")  # a re-arm replaces the payload
        assert reader.peek() == b"f2"
        assert not slot.arm(b"x" * 65)  # oversized: refused, not truncated
        slot.clear()
        assert reader.peek() is None
    finally:
        reader.close()
        slot.close(unlink=True)


def _bank(w, r, name):
    bank = w.StatusBank(name, lanes=3, create=True)
    reader = r.StatusBank(name)
    try:
        assert reader.rows.shape == (3, r.BANK_FIELDS) == (3, w.BANK_FIELDS)
        bank.rows[1, w.BANK_RESYNC] = 3
        bank.rows[1, w.BANK_PODS] = 12345
        bank.rows[1, w.BANK_INTEG_PODS] = 7
        assert int(reader.rows[1, r.BANK_RESYNC]) == 3
        assert int(reader.rows[1, r.BANK_PODS]) == 12345
        assert int(reader.rows[1, r.BANK_INTEG_PODS]) == 7
        assert int(reader.rows[0].sum()) == 0 and int(reader.rows[2].sum()) == 0
    finally:
        reader.close()
        bank.close(unlink=True)


def _metrics(w, r, name):
    slab = w.MetricsBank(name, 256, create=True)
    reader = r.MetricsBank(name)
    try:
        assert reader.read() is None  # nothing published yet
        assert slab.write(b'{"a": 1}')
        assert reader.read() == b'{"a": 1}'
        # a writer dying mid-write leaves an odd seq: readers back off
        slab.arena.hdr[w.MetricsBank.SEQ] += 1
        assert reader.read() is None
        assert slab.write(b'{"a": 2}')  # the next write restamps
        assert reader.read() == b'{"a": 2}'
        assert int(slab.arena.hdr[w.MetricsBank.SEQ]) % 2 == 0
        slab.reset()
        assert reader.read() is None
    finally:
        reader.close()
        slab.close(unlink=True)


ARENAS = {"ring": _ring, "slot": _slot, "bank": _bank, "metrics": _metrics}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("arena", sorted(ARENAS))
def test_shm_arenas_read_across_packages(arena, writer, reader):
    name = tshm.arena_name(f"t-interop-{arena}")
    ARENAS[arena](SHM[writer], SHM[reader], name)
    assert not os.path.exists(f"/dev/shm/{name}")


# -------------------------------------------------------------- descriptors

CAP, PUBLISHED = 4096, 1000
DESCRIPTORS = {
    "ok": ("pods", 0, 100, [0, 40, 100]),
    "ok-empty": ("nodes", 900, 0, [0]),
    "kind": ("bogus", 0, 100, [0, 100]),
    "type-off": ("pods", "0", 100, [0, 100]),
    "type-len": ("pods", 0, 1.5, [0, 100]),
    "range-len": ("pods", 0, CAP + 1, [0]),
    "range-neg-off": ("pods", -1, 100, [0, 100]),
    "range-neg-len": ("pods", 0, -5, [0]),
    "unpublished": ("pods", 950, 100, [0, 100]),
    "bounds-empty": ("pods", 0, 100, []),
    "bounds-start": ("pods", 0, 100, [5, 100]),
    "bounds-tuple": ("pods", 0, 100, (0, 100)),
    "bounds-order": ("pods", 0, 100, [0, 60, 40, 100]),
    "bounds-past": ("pods", 0, 100, [0, 120]),
    "bounds-short": ("pods", 0, 100, [0, 90]),
    "bounds-type": ("pods", 0, 100, [0, "100"]),
}


@pytest.mark.parametrize("name", sorted(DESCRIPTORS))
def test_desc_check_matches_reference(name):
    d = DESCRIPTORS[name]
    want = jproc._desc_check(*d, CAP, PUBLISHED)
    assert tproc._desc_check(*d, CAP, PUBLISHED) == want
    assert (want is None) == name.startswith("ok")


# ------------------------------------------------------------ node tap


def _tap(lib):
    if lib == "jax":
        cls, store = jproc.make_proc_lane_engine_class(), JaxFakeKube()
        e = cls(store, JaxConfig(manage_all_nodes=True))
    else:
        cls, store = tproc.make_proc_lane_engine_class(), PortFakeKube()
        e = cls(store, EngineConfig(manage_all_nodes=True, device="cpu"))
    e._lane_index, e._lane_n = 0, 4
    e._proc_integ = {"nodes": 0, "pods": 0, "rewind": 0}
    return store, e


def _names(prefix, n_want, pred):
    out, i = [], 0
    while len(out) < n_want:
        if pred(f"{prefix}{i}"):
            out.append(f"{prefix}{i}")
        i += 1
    return out


def tap_script(lib):
    """Lane 0 of 4: owned and unowned nodes, lane-0 pods on both, an
    unowned node appearing after its pods, an unowned node deleted, and a
    nodes re-list without one unowned node."""
    store, e = _tap(lib)
    owned = _names("tn", 1, lambda s: shard_of(s, 4) == 0)
    unowned = _names("tn", 3, lambda s: shard_of(s, 4) != 0)
    pods = _names("tp", 6, lambda s: shard_of(("default", s), 4) == 0)
    nodes = owned + unowned

    def ingest(kind, type_, obj):
        e._ingest(kind, type_, obj)

    for name in nodes[:3]:
        store.create("nodes", make_node(name))
        ingest("nodes", "ADDED", store.get("nodes", None, name))
    for i, p in enumerate(pods):
        store.create("pods", make_pod(p, node=nodes[i % 4]))
        ingest("pods", "ADDED", store.get("pods", "default", p))
    for _ in range(2):
        e.tick_once()
    # the unowned node the last pods sit on appears only now
    store.create("nodes", make_node(nodes[3]))
    ingest("nodes", "ADDED", store.get("nodes", None, nodes[3]))
    for _ in range(2):
        e.tick_once()
    ingest("nodes", "DELETED", {"metadata": {"name": nodes[1]}})
    e._resync("nodes", [store.get("nodes", None, n) for n in (nodes[0], nodes[3])])
    for _ in range(2):
        e.tick_once()
    state = {
        "node_has": sorted(e.node_has),
        "pods_by_node": {k: sorted(v) for k, v in e.pods_by_node.items() if v},
        "node_rows": sorted(e.nodes.pool.keys()),
        "pod_rows": sorted(e.pods.pool.keys()),
        "integ": dict(e._proc_integ),
    }
    objs = {k: masked(store.list(k)) for k in ("nodes", "pods")}
    for o in objs["nodes"] + objs["pods"]:
        o["metadata"].pop("resourceVersion", None)
        o["metadata"].pop("uid", None)
        o["metadata"].pop("creationTimestamp", None)
    return state, objs


def test_node_tap_matches_reference():
    ref = tap_script("jax")
    got = tap_script("torch")
    assert got == ref
    state, objs = got
    # the tap tracks unowned nodes without rows; only the owned node has one
    assert len(state["node_rows"]) == 1 and len(state["node_has"]) == 2
    assert sum(p["status"]["phase"] == "Running" for p in objs["pods"]) >= 3


# ------------------------------------------------------------- watchdog


def _charges(cls):
    wd = cls(budget=2, window=0.3)
    out = [wd.charge("kwok-lane0"), wd.charge("kwok-lane0"),
           wd.charge("kwok-lane0"),  # over budget inside the window
           wd.charge("kwok-lane1")]  # budgets are per worker
    time.sleep(0.35)
    out.append(wd.charge("kwok-lane0"))  # the window slid past both
    wd.close()
    out.append(wd.charge("kwok-lane1"))  # never after close
    return out, wd.restarts_total()


def test_watchdog_charge_matches_reference():
    got = _charges(PortWatchdog)
    assert got == _charges(JaxWatchdog)
    assert got == ([True, True, False, True, True, False], 4)


# ---------------------------------------------------- spawned process lanes


def _pod_phase(store, name):
    return ((store.get("pods", "default", name) or {}).get("status") or {}).get("phase")


def _statuses(store, names):
    out = {}
    for n in names:
        st = masked(dict(store.get("pods", "default", n)["status"]))
        st.pop("podIP", None)
        st.pop("podIPs", None)
        out[n] = st
    return out


def _reference_statuses(names, late):
    """kwok_tpu's single-lane engine on the same creates."""
    server = JaxFakeKube()
    eng = sync_engine("jax", server, manage_all_nodes=True)
    eng.watch(server)
    server.create("nodes", make_node("pe-n0"))
    for n in names:
        server.create("pods", make_pod(n, node="pe-n0"))
    eng.pump(3)
    server.create("pods", make_pod(late, node="pe-n0"))
    eng.pump(3)
    node = masked(server.get("nodes", None, "pe-n0")["status"])
    return node, _statuses(server, names + [late])


def _arena_names(eng):
    p = eng._proc
    return [p.bank.name] + [a.name for ln in p.lanes for a in (ln.ring, ln.slot, ln.mbank)]


def test_two_process_lanes_converge_respawn_and_match_reference(tmp_path):
    names = [f"pe-p{i}" for i in range(12)]
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    store = srv.store
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, tick_interval=0.05, drain_shards=2,
        lane_procs=True, checkpoint_dir=str(tmp_path), checkpoint_interval=0.5,
        device="cpu",
    ))
    # the parent holds no device rows (and, on a card, no stream)
    assert eng.nodes.state is None and eng.pods.state is None
    arenas = []
    try:
        eng.start()
        arenas = _arena_names(eng)
        assert _wait(lambda: eng.ready, 60), "startup gate never closed"
        store.create("nodes", make_node("pe-n0"))
        for n in names:
            store.create("pods", make_pod(n, node="pe-n0"))
        assert _wait(lambda: all(_pod_phase(store, n) == "Running" for n in names), 30)
        assert _wait(lambda: {"lane0.ckpt.json", "lane1.ckpt.json"} <= set(os.listdir(tmp_path)), 10)
        status = eng._proc.status()
        assert [s["pods"] for s in status] == [
            sum(shard_of(("default", n), 2) == i for n in names) for i in (0, 1)]
        # node + 12 pods, once both lanes have published their counters
        assert _wait(lambda: eng.metrics["status_patches_total"] >= 13, 10)
        relists0 = eng.metrics["watch_relists_total"]
        crashes0, restarts0 = worker_crash_ledger().get("kwok-lane0", (0, 0))
        lane = eng._proc.lanes[0]
        old_pid = lane.proc.pid
        assert lane.sigkill()
        assert _wait(lambda: eng._proc.status()[0]["restarts"] == 1
                     and eng._proc.status()[0]["alive"], 30), "lane 0 never respawned"
        assert eng._proc.lanes[0].proc.pid != old_pid
        late = next(f"pe-px{i}" for i in range(100) if shard_of(("default", f"pe-px{i}"), 2) == 0)
        store.create("pods", make_pod(late, node="pe-n0"))
        assert _wait(lambda: _pod_phase(store, late) == "Running", 30)
        assert _wait(lambda: eng._proc.status()[0]["device"] == "cpu", 10)
        assert not eng.degraded
        # the crash and the respawn, both in the worker ledger
        assert worker_crash_ledger()["kwok-lane0"] == (crashes0 + 1, restarts0 + 1)
        # the respawn still re-lists both kinds
        assert eng.metrics["watch_relists_total"] >= relists0 + 2
        text = eng.metrics_text()
        assert 'kwok_lane_proc_restarts_total{shard="0"} 1' in text
        # the router handed the lanes pre-partitioned windows, and the lanes
        # parsed them natively
        series = _series(text)
        assert sum(v for k, v in series.items()
                   if k.startswith("kwok_route_partition_events_total{")) > 0
        assert series['kwok_tick_stage_seconds_count{stage="parse"}'] > 0
        for shard in ("0", "1"):
            assert f'kwok_lane_stage_seconds_count{{shard="{shard}",stage="drain"}}' in text
        # the killed incarnation's published counters stay in the sum
        assert _wait(lambda: eng.metrics["status_patches_total"] >= 14, 10)
    finally:
        eng.stop()
        srv.stop()
    assert not any(ln.alive() for ln in eng._proc.lanes)
    assert arenas and not any(os.path.exists(f"/dev/shm/{a}") for a in arenas)
    node, ref = _reference_statuses(names, late)
    assert masked(store.get("nodes", None, "pe-n0")["status"]) == node
    assert _statuses(store, names + [late]) == ref


def _series(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_two_process_lanes_converge_with_native_ingest_off(monkeypatch):
    """Under KWOK_TPU_NATIVE=0 the parent routes decoded events (pickled
    over the pipe) and nothing is partitioned natively; the lanes still
    converge."""
    monkeypatch.setenv("KWOK_TPU_NATIVE", "0")
    names = [f"po-p{i}" for i in range(8)]
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    store = srv.store
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, tick_interval=0.05, drain_shards=2,
        lane_procs=True, device="cpu",
    ))
    assert eng._batch_parser is None
    try:
        eng.start()
        assert _wait(lambda: eng.ready, 60), "startup gate never closed"
        store.create("nodes", make_node("po-n0"))
        for n in names:
            store.create("pods", make_pod(n, node="po-n0"))
        assert _wait(lambda: all(_pod_phase(store, n) == "Running" for n in names), 30)
        series = _series(eng.metrics_text())
    finally:
        eng.stop()
        srv.stop()
    assert sum(v for k, v in series.items()
               if k.startswith("kwok_route_partition_events_total{")) == 0


def test_cuda_lane_without_card_degrades_and_never_runs_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda lanes would start")
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, drain_shards=2, lane_procs=True, device="cpu",
        worker_restart_budget=1, worker_restart_window=60.0,
    ))
    # the lanes' device comes from the config they are spawned with
    eng.config = dataclasses.replace(eng.config, device="cuda")
    try:
        eng.start()
        assert _wait(lambda: all(ln.dead for ln in eng._proc.lanes), 60)
        assert eng.degraded and "worker_restart_budget" in eng._degradation.reasons
        assert not eng.ready
        assert [ln.restarts for ln in eng._proc.lanes] == [1, 1]
        assert all(s["device"] is None and s["launches"] == 0 for s in eng._proc.status())
    finally:
        eng.stop()
        srv.stop()


# ------------------------------------------------- spawn arguments, emit slot


def test_engine_config_with_stage_rules_pickles(tmp_path):
    """The spawn pickle carries EngineConfig with its compiled Stage
    rules (frozen dataclasses), and they arrive equal."""
    from kwok_tpu_torch.config.types import KwokConfigurationOptions
    from kwok_tpu_torch.kwok import cli as tcli
    from tests.test_torch_cli import stage_file

    docs = tcli.load_documents(stage_file(tmp_path))
    stages = [d for d in docs if isinstance(d, tcli.Stage)]
    args = tcli.build_parser(KwokConfigurationOptions()).parse_args(
        ["--manage-all-nodes", "true", "--lane-procs", "true"])
    cfg = tcli._engine_config(args, stages, "cuda")
    assert cfg.pod_rules
    back = pickle.loads(pickle.dumps(cfg))
    assert back == cfg and back.device == "cuda" and back.lane_procs


class _BlockingClient:
    """An inner client whose status patch waits for a gate."""

    def __init__(self, real):
        self.real = real
        self.gate = threading.Event()

    def __getattr__(self, name):
        return getattr(self.real, name)

    def patch_status(self, kind, namespace, name, body):
        self.gate.wait(10)
        return self.real.patch_status(kind, namespace, name, body)


def test_emit_slot_parks_in_flight_patches_and_parent_replays_them():
    """A patch in flight sits in the lane's InflightSlot until it has an
    answer; the parent's replay of a parked slot lands the status in the
    store (what a SIGKILL mid-emit would otherwise lose)."""
    srv = HttpFakeApiserver(store=PortFakeKube()).start()
    slot = tshm.InflightSlot(tshm.arena_name("t-emit-slot"), 1 << 16, create=True)
    try:
        srv.store.create("pods", make_pod("slot-p", node="n0"))
        inner = _BlockingClient(HttpKubeClient(srv.url))
        guard = tproc._SlotGuardClient(slot, inner)
        patch = {"status": {"phase": "Running", "podIP": "10.0.0.9"}}
        t = threading.Thread(target=guard.patch_status,
                             args=("pods", "default", "slot-p", patch))
        t.start()
        assert _wait(lambda: slot.peek() is not None, 10)
        parked = pickle.loads(slot.peek())
        assert [r[:2] for r in parked] == [
            ("PATCH", "/api/v1/namespaces/default/pods/slot-p/status")]
        # the lane dies here: the parent replays the parked patch
        parent = types.SimpleNamespace(
            _master=srv.url, parent=types.SimpleNamespace(client=inner.real))
        tproc.ProcLaneSet._replay_frames(parent, parked)
        assert _pod_phase(srv.store, "slot-p") == "Running"
        inner.gate.set()
        t.join(10)
        assert slot.peek() is None  # answered: the slot is empty again
    finally:
        slot.close(unlink=True)
        srv.stop()


def test_unparseable_routed_line_is_quarantined_and_upcalled():
    """A garbled line in a routed window is skipped and counted as
    integrity doubt for the parent; the window's good lines ingest."""
    store, e = _tap("torch")
    pod = make_pod(_names("tq", 1, lambda s: shard_of(("default", s), 4) == 0)[0], node="x")
    store.create("pods", pod)
    good = ('{"type":"ADDED","object":%s}' % json.dumps(
        store.get("pods", "default", pod["metadata"]["name"]))).encode()
    blob = b'{"type":"ADDED","obj' + good
    e._ingest_safe("pods", "RAWB", (blob, [0, 20, len(blob)]))
    assert e._proc_integ["pods"] == 1
    assert e.pods.pool.lookup(("default", pod["metadata"]["name"])) is not None


def test_integrity_resync_cuts_doubted_streams_once_per_window():
    """The parent's re-list on integrity doubt: immediate when the window
    is open, otherwise one deferred re-list of every kind doubted since;
    only the doubted kinds' streams are cut."""
    cut = []

    class Stream:
        def __init__(self, kind):
            self.kind = kind

        def stop(self):
            cut.append(self.kind)

    eng = ClusterEngine(PortFakeKube(), EngineConfig(manage_all_nodes=True, device="cpu"))
    eng._watches = {k: Stream(k) for k in ("nodes", "pods")}
    eng._running = True
    eng._WIRE_RESYNC_MIN_S = 0.3
    eng._integrity_resync("pods")
    assert _wait(lambda: cut == ["pods"], 5)
    eng._integrity_resync("pods")
    eng._integrity_resync("nodes")
    assert cut == ["pods"]  # inside the window: deferred, not dropped
    assert _wait(lambda: len(cut) == 3, 5)
    assert sorted(cut[1:]) == ["nodes", "pods"]
    assert eng.metrics["watch_integrity_resyncs_total"] == 2
    eng._running = False
