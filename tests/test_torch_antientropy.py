"""The port's anti-entropy auditor (``kwok_tpu_torch/resilience/antientropy.py``)
held against ``kwok_tpu``'s on the CPU.

Each case of ``tests/test_antientropy.py`` has a twin here: the same
scenario runs once through ``kwok_tpu`` (its FakeKube, engine and auditor,
with its rig's silent mutations) and once through the port (its FakeKube,
engine on device="cpu" and auditor, with ``drift_rig``'s silent
mutations), each with the reference's own asserts, and what the two
auditors report must be equal (tolerance 0): detections by kind and
reason, repairs, ``snapshot()``'s passes, cursors and streaks, and the
engine's degraded reasons. The two threaded cases compare the facts their
asserts establish (counts there depend on thread timing).

Besides: ``HttpKubeClient.list_page`` against both packages' HTTP mocks
and the port's native server (the same pages, the same end of a cycle,
``ContinueExpired`` after a compaction); the interval's precedence
(config, ``KWOK_TPU_AUDIT_INTERVAL``, negative values); a federation
that spawns no ``kwok-audit``; a ``kwok-audit`` killed by the fault plane
that restarts with no resync and leaves no lock held; the process-lane
drift mirror; and ``/readyz`` answering 503 while ``drift`` is set.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import drift_rig
from benchmarks import rig as jax_rig
from kwok_tpu.edge.httpclient import HttpKubeClient as JaxHttpClient
from kwok_tpu.edge.kubeclient import ContinueExpired as JaxContinueExpired
from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
from kwok_tpu.edge.mockserver import HttpFakeApiserver as JaxHttpApiserver
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.resilience.antientropy import AntiEntropyAuditor as JaxAuditor
from kwok_tpu.resilience.checkpoint import row_uid as jax_row_uid
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.kubeclient import ContinueExpired
from kwok_tpu_torch.edge.mockserver import FakeKube, HttpFakeApiserver
from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.resilience.antientropy import REASONS, AntiEntropyAuditor
from kwok_tpu_torch.resilience.checkpoint import row_uid
from kwok_tpu_torch.workers import live_workers
from tests.test_torch_engine import make_node, make_pod


def _wait(pred, timeout=30.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def _jax_missed(kube, pod):
    """kwok_tpu's missed event: a real server revision, no event."""
    sh = kube._shard("pods", "default")
    with sh._shard_lock:
        with kube._ring_lock:
            kube._rv += 1
            pod.setdefault("metadata", {})["resourceVersion"] = str(kube._rv)
            kube._counts["pods"] += 1
        sh.objs[pod["metadata"]["name"]] = pod


LIBS = {
    "jax": types.SimpleNamespace(
        name="jax", FakeKube=JaxFakeKube, Auditor=JaxAuditor, row_uid=jax_row_uid,
        ContinueExpired=JaxContinueExpired,
        engine=lambda kube, **cfg: JaxEngine(kube, JaxConfig(manage_all_nodes=True, **cfg)),
        silent_patch=jax_rig.silent_patch, silent_delete=jax_rig.silent_delete,
        missed=_jax_missed,
    ),
    "torch": types.SimpleNamespace(
        name="torch", FakeKube=FakeKube, Auditor=AntiEntropyAuditor, row_uid=row_uid,
        ContinueExpired=ContinueExpired,
        engine=lambda kube, **cfg: ClusterEngine(
            kube, EngineConfig(manage_all_nodes=True, device="cpu", **cfg)),
        silent_patch=drift_rig.silent_patch, silent_delete=drift_rig.silent_delete,
        missed=lambda kube, pod: drift_rig.silent_create(kube, "pods", pod),
    ),
}


def _sync_engine(L, kube, **cfg):
    """An unstarted single-lane engine driven synchronously: ingest by
    hand and queue drains, the auditor through pass_once."""
    eng = L.engine(kube, **cfg)
    eng._running = True
    eng.ready = True
    eng._startup_pending = None
    return eng


def _drain(eng):
    """Apply everything queued (watchless synchronous mode)."""
    raw: dict = {}
    while True:
        try:
            item = eng._q.get_nowait()
        except queue.Empty:
            break
        if item is not None:
            eng._drain_apply(item, raw)
    eng._drain_flush(raw)


def _seed(L, eng, kube, pods=4):
    kube.create("nodes", make_node("ae-n"))
    eng._ingest("nodes", "ADDED", kube.get("nodes", None, "ae-n"))
    names = [f"aep{i}" for i in range(pods)]
    for n in names:
        kube.create("pods", make_pod(n, node="ae-n"))
        eng._ingest("pods", "ADDED", kube.get("pods", "default", n))
    return names


def _auditor(L, eng, **kw):
    kw.setdefault("settle_s", 0.05)
    return L.Auditor(eng, 0.5, **kw)


def observe(aud, eng, **extra) -> dict:
    """What the twin compares: detections by kind and reason, repairs,
    the snapshot's passes, cursors and streaks, the degraded reasons."""
    snap = aud.snapshot()
    return {
        "detected": {f"{k}/{r}": aud.detected_total(kind=k, reason=r)
                     for k in ("nodes", "pods") for r in REASONS},
        "repaired": aud.repaired_total,
        "passes": snap["passes"], "cursor": snap["cursor"], "streaks": snap["streaks"],
        "degraded": sorted(eng._degradation.reasons),
        **extra,
    }


def _phase(kube, name):
    return ((kube.get("pods", "default", name) or {}).get("status") or {}).get("phase")


# ------------------------------------------------------------- scenarios
# each runs one case of tests/test_antientropy.py through one package


def converged_state_detects_nothing(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    _seed(L, eng, kube)
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total() == 0 and aud.repaired_total == 0
    assert not eng.degraded
    return observe(aud, eng)


def stale_row_detected_and_repaired(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    names = _seed(L, eng, kube)
    victim = names[0]
    idx = eng.pods.pool.lookup(("default", victim))
    eng.pods.phase_h[idx] = eng._pod_phase_ids["Running"]
    kube.patch_status("pods", "default", victim, {"status": {"phase": "Running"}})
    eng.pods.pool.meta[idx]["rv"] = int(
        kube.get("pods", "default", victim)["metadata"]["resourceVersion"])
    assert L.silent_patch(kube, "pods", "default", victim,
                          lambda o: o.setdefault("status", {}).update(phase="Pending"))
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total(reason="stale-row") == 1 and aud.repaired_total == 1
    first = observe(aud, eng)
    _drain(eng)  # the re-ingest's repair render patches the status back
    healed = _wait(lambda: _phase(kube, victim) == "Running", 5.0)
    assert healed
    aud.pass_once()
    assert aud.detected_total() == 1
    return observe(aud, eng, first=first, healed=healed)


def ghost_row_detected_and_released(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    ghost = _seed(L, eng, kube)[1]
    assert L.silent_delete(kube, "pods", "default", ghost)
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total(reason="ghost-row") == 1
    _drain(eng)
    released = eng.pods.pool.lookup(("default", ghost)) is None
    assert released
    return observe(aud, eng, released=released)


def ghost_uid_mismatch_reingested(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    victim = _seed(L, eng, kube)[2]
    assert L.silent_patch(kube, "pods", "default", victim,
                          lambda o: o["metadata"].update(uid="uid-recreated"))
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total(reason="ghost-row") == 1
    _drain(eng)
    idx = eng.pods.pool.lookup(("default", victim))
    uid = L.row_uid(eng.pods.pool.meta[idx]) if idx is not None else None
    assert uid == "uid-recreated"
    return observe(aud, eng, uid=uid)


def missed_event_reingested(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    _seed(L, eng, kube)
    L.missed(kube, make_pod("ae-missed", node="ae-n"))
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total(reason="missed-event") == 1
    _drain(eng)
    present = eng.pods.pool.lookup(("default", "ae-missed")) is not None
    assert present
    return observe(aud, eng, present=present)


def double_apply_detected(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    victim = _seed(L, eng, kube)[3]
    idx = eng.pods.pool.lookup(("default", victim))
    eng.pods.pool.meta[idx]["rv"] = 10_000_000  # the engine ahead of the server
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total(reason="double-apply") == 1
    _drain(eng)
    srv_rv = int(kube.get("pods", "default", victim)["metadata"]["resourceVersion"])
    row = eng.pods.pool.meta[eng.pods.pool.lookup(("default", victim))]["rv"]
    assert row == srv_rv
    return observe(aud, eng, row_rv_is_server_rv=row == srv_rv)


def settle_recheck_throws_out_transients(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    victim = _seed(L, eng, kube)[0]
    assert L.silent_patch(kube, "pods", "default", victim,
                          lambda o: o.setdefault("status", {}).update(phase="CrashLoopBackOff"))
    aud = _auditor(L, eng, settle_s=0.2)
    # the "in-flight patch": the server heals mid-settle
    t = threading.Timer(0.05, lambda: L.silent_patch(
        kube, "pods", "default", victim,
        lambda o: o.setdefault("status", {}).update(phase="Pending")))
    t.start()
    try:
        aud.pass_once()
    finally:
        t.cancel()
    assert aud.detected_total() == 0
    return observe(aud, eng)


class _PagingClient:
    """A KubeClient stub with server-side pagination, recording every
    page request (kind, limit, cont)."""

    expire = None  # the ContinueExpired class to raise on a resumed cursor

    def __init__(self, pods):
        self.pods = pods
        self.calls: list = []

    def list_page(self, kind, *, limit, cont="", **sel):
        if self.expire is not None and cont:
            raise self.expire(kind)
        self.calls.append((kind, limit, cont))
        if kind != "pods":
            return [], ""
        start = int(cont or 0)
        nxt = start + limit
        return self.pods[start:nxt], (str(nxt) if nxt < len(self.pods) else "")

    def list(self, kind, **sel):
        return self.pods if kind == "pods" else []

    def get(self, kind, ns, name):
        for o in self.pods if kind == "pods" else []:
            if o["metadata"]["name"] == name:
                return o
        return None


def budgeted_paging_resumes_cursor_across_passes(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    pods = []
    for i in range(10):
        o = make_pod(f"pg{i}", node="ae-n")
        o["metadata"].update(uid=f"u{i}", resourceVersion=str(i + 1))
        pods.append(o)
    eng.client = client = _PagingClient(pods)
    aud = L.Auditor(eng, 0.5, page_size=2, max_pages=2, settle_s=0.01)
    windows = []
    for _ in range(3):
        items, done = aud._list_window("pods")
        windows.append((len(items), done, dict(aud._cursor)))
    assert [(n, d) for n, d, _ in windows] == [(4, False), (4, False), (2, True)]
    assert [c[2] for c in client.calls[:2]] == ["", "2"]
    assert all(limit == 2 for _k, limit, _c in client.calls)
    return observe(aud, eng, windows=windows, calls=client.calls)


def ghost_scan_waits_for_full_cycle(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    names = _seed(L, eng, kube, pods=6)
    pods = [kube.get("pods", "default", n) for n in names]
    eng.client = _PagingClient(pods)
    aud = L.Auditor(eng, 0.5, page_size=2, max_pages=1, settle_s=0.01)
    # the first two windows miss 4 of 6 rows each: no ghost suspects yet
    assert aud._scan_kind("pods") == [] and aud._scan_kind("pods") == []
    assert aud._scan_kind("pods") == []  # the cursor wraps: all seen
    gone = pods.pop()
    suspects = []
    for _ in range(3):  # one full cycle of one-page windows
        suspects.extend(aud._scan_kind("pods"))
    keys = [list(map(str, s[:3])) for s in suspects]
    assert ["pods", str(("default", gone["metadata"]["name"])), "ghost-row"] in keys
    return observe(aud, eng, suspects=keys)


def unrepaired_divergence_degrades_then_clears(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    victim = _seed(L, eng, kube)[0]
    idx = eng.pods.pool.lookup(("default", victim))
    eng.pods.pool.meta[idx]["rv"] = 10_000_000
    aud = _auditor(L, eng)
    for i in range(3):
        aud.pass_once()  # repair queued, never drained
        assert aud.detected_total() == i + 1
    assert eng.degraded and "drift" in eng._degradation.reasons
    degraded = observe(aud, eng)
    _drain(eng)
    aud.pass_once()
    aud.pass_once()
    assert not eng.degraded and "drift" not in eng._degradation.reasons
    return observe(aud, eng, degraded=degraded)


def streaks_survive_multi_window_cycles(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    names = _seed(L, eng, kube, pods=6)
    idx = eng.pods.pool.lookup(("default", names[0]))
    eng.pods.pool.meta[idx]["rv"] = 10_000_000
    eng.client = _PagingClient([kube.get("pods", "default", n) for n in names])
    aud = L.Auditor(eng, 0.5, page_size=2, max_pages=1, settle_s=0.01)
    for _ in range(9):  # 3 cycles of 3 windows
        aud.pass_once()
    assert aud.detected_total(reason="double-apply") == 3
    assert eng.degraded and "drift" in eng._degradation.reasons
    return observe(aud, eng)


def zero_cost_when_disabled(L):
    eng = L.engine(L.FakeKube())
    eng.start()
    try:
        facts = {"auditor": eng._auditor,
                 "audit_workers": [n for n in live_workers() if n.startswith("kwok-audit")]}
        if L.name == "jax":
            from kwok_tpu.workers import live_workers as jax_live

            facts["audit_workers"] += [n for n in jax_live() if n.startswith("kwok-audit")]
    finally:
        eng.stop()
    assert facts == {"auditor": None, "audit_workers": []}
    return facts


def lane_children_never_audit(L, monkeypatch):
    monkeypatch.setenv("KWOK_TPU_AUDIT_INTERVAL", "1.0")
    eng = L.engine(L.FakeKube(), drain_shards=2)
    facts = {"parent": eng._audit_interval,
             "lanes": [ln.engine._audit_interval for ln in eng._lanes.lanes]}
    assert facts == {"parent": 1.0, "lanes": [0.0, 0.0]}
    return facts


def threaded_e2e_paced_loop(L):
    kube = L.FakeKube()
    eng = L.engine(kube, tick_interval=0.02, audit_interval=0.4)
    eng.start()
    try:
        kube.create("nodes", make_node("te-n"))
        names = [f"tep{i}" for i in range(6)]
        for n in names:
            kube.create("pods", make_pod(n, node="te-n"))
        assert _wait(lambda: all(_phase(kube, n) == "Running" for n in names))
        time.sleep(0.5)  # let the stream go quiet
        assert L.silent_patch(kube, "pods", "default", names[0],
                              lambda o: o["status"].update(phase="Pending"))
        assert L.silent_delete(kube, "pods", "default", names[1])
        repaired = _wait(lambda: _phase(kube, names[0]) == "Running"
                         and eng.pods.pool.lookup(("default", names[1])) is None, 15.0)
        aud = eng._auditor
        facts = {"repaired": repaired,
                 "stale_row": aud.detected_total(reason="stale-row") >= 1,
                 "ghost_row": aud.detected_total(reason="ghost-row") >= 1,
                 "repairs": aud.repaired_total >= 2,
                 "healthy": _wait(lambda: not eng.degraded, 5.0),
                 "worker": type(eng._auditor).__name__}
    finally:
        eng.stop()
    assert all(v for k, v in facts.items() if k != "worker"), facts
    return facts


def expired_continue_token_is_not_a_completed_cycle(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    names = _seed(L, eng, kube, pods=6)
    client = _PagingClient([kube.get("pods", "default", n) for n in names])
    client.expire = L.ContinueExpired
    eng.client = client
    aud = L.Auditor(eng, 0.5, page_size=2, max_pages=4, settle_s=0.01)
    items, done = aud._list_window("pods")
    assert len(items) == 2 and not done  # restarted, not complete
    assert aud._cursor["pods"] == ""
    assert aud._scan_kind("pods") == []  # and no ghost sweep
    return observe(aud, eng, window=(len(items), done))


def proc_lane_auditor_scopes_to_its_shard(L):
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    eng._lane_index, eng._lane_n = 0, 2  # lane 0 of 2, as a lane process
    kube.create("nodes", make_node("ae-n"))
    if shard_of("ae-n", 2) == 0:
        eng._ingest("nodes", "ADDED", kube.get("nodes", None, "ae-n"))
    mine, theirs = [], []
    i = 0
    while len(mine) < 3 or len(theirs) < 3:
        name = f"shp{i}"
        i += 1
        kube.create("pods", make_pod(name, node="ae-n"))
        if shard_of(("default", name), 2) == 0:
            eng._ingest("pods", "ADDED", kube.get("pods", "default", name))
            mine.append(name)
        else:
            theirs.append(name)
    _drain(eng)
    aud = _auditor(L, eng)
    assert (aud.shard_i, aud.shard_n) == (0, 2)
    aud.pass_once()
    aud.pass_once()
    assert aud.detected_total() == 0  # the other shard's pods are not missed here
    assert L.silent_delete(kube, "pods", "default", theirs[0])
    aud.pass_once()
    assert aud.detected_total() == 0  # the other lane's ghost
    assert L.silent_delete(kube, "pods", "default", mine[0])
    aud.pass_once()
    assert aud.detected_total(reason="ghost-row") == 1
    _drain(eng)
    released = eng.pods.pool.lookup(("default", mine[0])) is None
    assert released
    return observe(aud, eng, mine=mine, theirs=theirs)


TWINS = {f.__name__: f for f in (
    converged_state_detects_nothing, stale_row_detected_and_repaired,
    ghost_row_detected_and_released, ghost_uid_mismatch_reingested,
    missed_event_reingested, double_apply_detected, settle_recheck_throws_out_transients,
    budgeted_paging_resumes_cursor_across_passes, ghost_scan_waits_for_full_cycle,
    unrepaired_divergence_degrades_then_clears, streaks_survive_multi_window_cycles,
    zero_cost_when_disabled, lane_children_never_audit, threaded_e2e_paced_loop,
    expired_continue_token_is_not_a_completed_cycle, proc_lane_auditor_scopes_to_its_shard,
)}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin(name, monkeypatch):
    fn = TWINS[name]
    args = (monkeypatch,) if name == "lane_children_never_audit" else ()
    ref = fn(LIBS["jax"], *args)
    got = fn(LIBS["torch"], *args)
    if name == "threaded_e2e_paced_loop":
        ref["worker"] = got["worker"]  # each package's own class
    assert got == ref


# ------------------------------------------------ repairs behind the drain


def missed_pod_behind_held_lanes(L):
    """A missed pod (on the server, no row) on 2 threaded lanes whose
    drains are held for five audit cycles, then released."""
    kube = L.FakeKube()
    eng = L.engine(kube, drain_shards=2, tick_interval=0.02)
    eng.start()
    try:
        kube.create("nodes", make_node("hl-n"))
        for i in range(4):
            kube.create("pods", make_pod(f"hl{i}", node="hl-n"))
        assert _wait(lambda: all(_phase(kube, f"hl{i}") == "Running" for i in range(4)))
        L.missed(kube, make_pod("hl-missed", node="hl-n"))
        aud = _auditor(L, eng)
        locks = [lane.stage_lock for lane in eng._lanes.lanes]
        for lock in locks:
            lock.acquire()
        try:
            worst = 0
            for _ in range(5):  # five passes, five full cycles (no paging)
                aud.pass_once()
                worst = max([worst] + [v[0] for v in aud.snapshot()["streaks"].values()])
            held = {"repaired": aud.repaired_total, "detected": aud.detected_total(),
                    "worst_streak": worst, "degraded": eng.degraded}
        finally:
            for lock in locks:
                lock.release()
        running = _wait(lambda: _phase(kube, "hl-missed") == "Running")
        for _ in range(3):
            aud.pass_once()
        return {"held": held, "running": running,
                "streaks": aud.snapshot()["streaks"], "degraded": eng.degraded}
    finally:
        eng.stop()


def test_repair_queued_behind_held_lanes_is_in_flight_not_reconfirmed():
    """``kwok_tpu`` re-confirms the missed pod on every cycle while its
    repair waits behind the held drains, queues a repair each time and
    degrades after three; the port queues one repair and stays healthy,
    and both heal once the drains resume."""
    ref = missed_pod_behind_held_lanes(LIBS["jax"])
    assert ref["held"]["repaired"] == 5 and ref["held"]["degraded"]
    got = missed_pod_behind_held_lanes(LIBS["torch"])
    assert got["held"] == {"repaired": 1, "detected": 1, "worst_streak": 1,
                           "degraded": False}
    assert got["running"] and got["streaks"] == {} and not got["degraded"]
    assert ref["running"]


def crowded_window(L):
    """One window of 71 pods: the first 70 in key order have rows a few
    revisions ahead of the listed snapshot (written since the cycle's
    first page; a fresh GET shows the row's revision), the last is
    Running on the engine and Pending on the server. The suspects (70
    double-apply, 1 stale-row) exceed one pass's re-check budget."""
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    kube.create("nodes", make_node("ae-n"))
    eng._ingest("nodes", "ADDED", kube.get("nodes", None, "ae-n"))
    pods, fresh = [], {}
    for i in range(71):
        o = make_pod(f"cw{i:02d}", node="ae-n")
        o["metadata"].update(uid=f"u{i}", resourceVersion=str(100 + i))
        eng._ingest("pods", "ADDED", o)
        pods.append(o)
    for o in pods[:70]:
        name = o["metadata"]["name"]
        idx = eng.pods.pool.lookup(("default", name))
        eng.pods.pool.meta[idx]["rv"] = int(o["metadata"]["resourceVersion"]) + 5
        f = json.loads(json.dumps(o))
        f["metadata"]["resourceVersion"] = str(eng.pods.pool.meta[idx]["rv"])
        fresh[name] = f
    idx = eng.pods.pool.lookup(("default", "cw70"))
    eng.pods.phase_h[idx] = eng._pod_phase_ids["Running"]

    class Client(_PagingClient):
        def get(self, kind, ns, name):
            return fresh.get(name) or super().get(kind, ns, name)

    eng.client = Client(pods)
    aud = L.Auditor(eng, 0.5, page_size=256, max_pages=1, settle_s=0.01)
    aud.pass_once()
    return {r: aud.detected_total(kind="pods", reason=r) for r in REASONS}


def stale_snapshot_window(L):
    """One window of a paged LIST whose snapshot is at revision 170 while
    the engine's watch has received up to 300: 70 rows hold writes past
    the snapshot (100 revisions past their listed ones), one row sits a
    million revisions past its listed one (ahead of anything the server
    sent). The double-apply suspects of one scan."""
    from kwok_tpu_torch.edge.httpclient import ListPage

    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    kube.create("nodes", make_node("ae-n"))
    eng._ingest("nodes", "ADDED", kube.get("nodes", None, "ae-n"))
    pods = []
    for i in range(71):
        o = make_pod(f"ss{i:02d}", node="ae-n")
        o["metadata"].update(uid=f"u{i}", resourceVersion=str(100 + i))
        eng._ingest("pods", "ADDED", o)
        pods.append(o)
        idx = eng.pods.pool.lookup(("default", o["metadata"]["name"]))
        eng.pods.pool.meta[idx]["rv"] = 100 + i + (100 if i < 70 else 1_000_000)
    eng._watch_rv = {"pods": 300, "nodes": 300}

    class Client(_PagingClient):
        def list_page(self, kind, *, limit, cont="", **sel):
            items, token = super().list_page(kind, limit=limit, cont=cont, **sel)
            page = ListPage(items)
            page.rv = 170
            return page, token

    eng.client = Client(pods)
    aud = L.Auditor(eng, 0.5, page_size=256, max_pages=1, settle_s=0.01)
    return sorted(str(s[1]) for s in aud._scan_kind("pods") if s[2] == "double-apply")


def test_rows_past_a_stale_snapshot_are_no_double_apply_suspects():
    """``kwok_tpu`` flags every row written since its cycle's first page
    up to the budget, in key order, and the one row ahead of anything the
    server sent is past it; the port keeps only that row."""
    ref = stale_snapshot_window(LIBS["jax"])
    assert len(ref) == 64 and str(("default", "ss70")) not in ref  # the budget, in key order
    assert stale_snapshot_window(LIBS["torch"]) == [str(("default", "ss70"))]


def test_crowded_window_re_checks_the_strongest_suspects_first():
    """``kwok_tpu`` re-checks the first 64 suspects in key order: the 64
    stale-snapshot ones, all thrown out, and the real stale row waits a
    whole cycle. The port re-checks the real divergences first and the
    double-applies by how far the row is ahead."""
    ref = crowded_window(LIBS["jax"])
    got = crowded_window(LIBS["torch"])
    assert ref == {r: 0 for r in REASONS}
    assert got == {**{r: 0 for r in REASONS}, "stale-row": 1}


# -------------------------------------------------------------- list_page


def _pages(client, limit: int) -> list:
    """One full scan cycle of list_page, as the auditor's windows read it."""
    out, cont = [], ""
    while True:
        items, cont = client.list_page("pods", limit=limit, cont=cont,
                                       field_selector="spec.nodeName!=")
        out.append([o["metadata"]["name"] for o in items])
        if not cont:
            return out


def list_page_run(client, compact, expired_cls) -> dict:
    for i in range(7):
        client.create("pods", make_pod(f"lp{i}", node="lp-n"))
    client.create("pods", {**make_pod("lp-unbound"), "spec": {"containers": []}})
    cycle = _pages(client, 3)
    _items, token = client.list_page("pods", limit=3)
    client.create("pods", make_pod("lp-late", node="lp-n"))
    compact()
    expired = False
    try:
        client.list_page("pods", limit=3, cont=token)
    except expired_cls:
        expired = True
    # a first page after the compaction is a fresh, complete read
    fresh = _pages(client, 100)
    client.close()
    return {"cycle": cycle, "token": bool(token), "expired": expired, "fresh": fresh}


def test_list_page_twin_over_both_mocks_and_the_native_server():
    from kwok_tpu_torch import native
    from tests.test_torch_apiserver import Server

    def post_compact(url):
        urllib.request.urlopen(urllib.request.Request(url + "/compact", data=b"",
                                                      method="POST"), timeout=10).read()

    out = {}
    for name, srv_cls, client_cls, exp in (
            ("jax", JaxHttpApiserver, JaxHttpClient, JaxContinueExpired),
            ("torch", HttpFakeApiserver, HttpKubeClient, ContinueExpired)):
        srv = srv_cls().start()
        try:
            out[name] = list_page_run(client_cls(srv.url), srv.store.compact, exp)
        finally:
            srv.stop()
    if native.apiserver_binary() is not None:
        srv = Server("native")
        try:
            out["native"] = list_page_run(HttpKubeClient(srv.url),
                                          lambda: post_compact(srv.url), ContinueExpired)
        finally:
            srv.stop()
    assert out["torch"] == out["jax"]
    assert out.get("native", out["jax"]) == out["jax"]
    assert out["jax"]["cycle"] == [["lp0", "lp1", "lp2"], ["lp3", "lp4", "lp5"], ["lp6"]]
    assert out["jax"]["expired"] and out["jax"]["token"]
    assert out["jax"]["fresh"] == [["lp-late"] + [f"lp{i}" for i in range(7)]]


def test_list_page_first_page_410_stays_an_http_error():
    """A 410 without a continue token is not a cursor's expiry: it stays
    the client's HTTP error, as in kwok_tpu."""

    class Gone(HttpKubeClient):
        def _json(self, method, url, body=None, content_type="application/json"):
            raise urllib.error.HTTPError(url, 410, "Gone", None, None)

    c = Gone("http://127.0.0.1:1")
    with pytest.raises(urllib.error.HTTPError):
        c.list_page("pods", limit=3)
    with pytest.raises(ContinueExpired):
        c.list_page("pods", limit=3, cont="abc")


# ------------------------------------------------------------ precedence

PRECEDENCE = {
    # (config value, KWOK_TPU_AUDIT_INTERVAL or None)
    "config-wins": (2.5, "7"),
    "env-fallback": (0.0, "1.5"),
    "env-off": (0.0, "off"),
    "env-not-a-number": (0.0, "soon"),
    "negative-beats-env": (-1.0, "3"),
    "unset": (0.0, None),
}


@pytest.mark.parametrize("name", sorted(PRECEDENCE))
def test_interval_precedence_matches_jax(name, monkeypatch):
    cfg, env = PRECEDENCE[name]
    if env is None:
        monkeypatch.delenv("KWOK_TPU_AUDIT_INTERVAL", raising=False)
    else:
        monkeypatch.setenv("KWOK_TPU_AUDIT_INTERVAL", env)
    got = LIBS["torch"].engine(FakeKube(), audit_interval=cfg)._audit_interval
    ref = LIBS["jax"].engine(JaxFakeKube(), audit_interval=cfg)._audit_interval
    assert got == ref
    assert got == {"config-wins": 2.5, "env-fallback": 1.5}.get(name, 0.0)


# ------------------------------------------------- topologies and workers


def test_federation_spawns_no_auditor(monkeypatch):
    """Members start with run_tick_loop=False, so a federation under an
    audit interval spawns no kwok-audit, as in kwok_tpu."""
    from kwok_tpu_torch.engine import FederatedEngine

    monkeypatch.setenv("KWOK_TPU_AUDIT_INTERVAL", "0.3")
    kubes = [FakeKube(), FakeKube()]
    cfg = EngineConfig(manage_all_nodes=True, device="cpu", audit_interval=0.3,
                       tick_interval=0.02)
    fed = FederatedEngine(kubes, cfg)
    fed.start()
    try:
        for i, k in enumerate(kubes):
            k.create("nodes", make_node(f"fa-n{i}"))
        assert _wait(lambda: all(k.count("nodes", lambda n: bool(n.get("status")))
                                 for k in kubes), 20)
        time.sleep(0.7)  # two audit intervals
        assert [e._audit_interval for e in fed.engines] == [0.3, 0.3]
        assert [e._auditor for e in fed.engines] == [None, None]
        assert not [n for n in live_workers() if n.startswith("kwok-audit")]
    finally:
        fed.stop()


def test_killed_audit_worker_restarts_without_resync_or_lock():
    """A WorkerKilled pill in kwok-audit: the watchdog restarts it with no
    stream resync, its reclaimable lock is free, and the next passes still
    detect and repair."""
    from kwok_tpu_torch.resilience import faults as tf

    kube = FakeKube()
    eng = ClusterEngine(kube, EngineConfig(manage_all_nodes=True, device="cpu",
                                           tick_interval=0.02, audit_interval=0.2))
    eng.start()
    try:
        kube.create("nodes", make_node("ka-n"))
        kube.create("pods", make_pod("kap0", node="ka-n"))
        kube.create("pods", make_pod("kap1", node="ka-n"))
        assert _wait(lambda: _phase(kube, "kap0") == _phase(kube, "kap1") == "Running")
        aud = eng._auditor
        resyncs = []
        eng.resync_streams = lambda: resyncs.append(1)
        # a pill that lands while the pass holds _ae_lock: held twice,
        # then killed before the release
        real = aud._account

        def account_then_die(confirmed):
            aud._ae_lock.acquire()
            real(confirmed)
            raise tf.WorkerKilled("pill inside the pass")

        aud._account = account_then_die
        assert _wait(lambda: any(r["thread"] == "kwok-audit"
                                 for r in eng._watchdog.restart_log()), 10)
        aud._account = real
        plane = tf.FaultPlane(tf.FaultSpec.parse("seed=1"))
        assert plane.kill_worker("kwok-audit")
        assert _wait(lambda: sum(r["thread"] == "kwok-audit"
                                 for r in eng._watchdog.restart_log()) >= 2, 10)
        got = []

        def probe():
            ok = aud._ae_lock.acquire(timeout=5)
            got.append(ok)
            if ok:
                aud._ae_lock.release()

        t = threading.Thread(target=probe)
        t.start()
        t.join(10)
        assert got == [True]
        assert drift_rig.silent_delete(kube, "pods", "default", "kap1")
        assert _wait(lambda: eng.pods.pool.lookup(("default", "kap1")) is None, 10)
        assert eng._auditor.detected_total(reason="ghost-row") >= 1
        assert resyncs == []
        assert not eng.degraded
    finally:
        eng.stop()


def test_drift_mirror_from_the_status_bank():
    """The parent's coordinator mirrors BANK_DRIFT: a lane row with 1
    degrades the parent (drift), all rows 0 clear it."""
    from kwok_tpu_torch.engine import shm as shm_mod

    eng = ClusterEngine(HttpKubeClient("http://127.0.0.1:1"), EngineConfig(
        manage_all_nodes=True, device="cpu", lane_procs=True, drain_shards=2,
        tick_interval=0.02, audit_interval=1.0))
    pl = eng._proc
    assert pl is not None and eng._audit_interval == 1.0
    bank = shm_mod.StatusBank(shm_mod.arena_name("bank-t"), lanes=2, create=True)
    pl.bank = bank
    pl.lanes = [types.SimpleNamespace(index=i, restarts=0, shedding=False) for i in range(2)]
    eng._startup_pending = None
    eng._running = True
    t = threading.Thread(target=pl.coordinator_loop, daemon=True)
    t.start()
    try:
        assert not eng.degraded
        bank.rows[1, shm_mod.BANK_DRIFT] = 1
        assert _wait(lambda: "drift" in eng._degradation.reasons, 5)
        bank.rows[1, shm_mod.BANK_DRIFT] = 0
        assert _wait(lambda: not eng.degraded, 5)
    finally:
        eng._running = False
        t.join(5)
        pl.bank = None
        bank.close(unlink=True)


def test_lane_spec_carries_the_resolved_interval(monkeypatch):
    """The parent's resolved interval rides every lane spec (0 when off),
    and the lane process's engine audits its own shard under it; an
    inherited KWOK_TPU_AUDIT_INTERVAL alone never turns a child's on."""
    from kwok_tpu_torch.engine import proclanes

    eng = ClusterEngine(HttpKubeClient("http://127.0.0.1:1"), EngineConfig(
        manage_all_nodes=True, device="cpu", lane_procs=True, drain_shards=2,
        audit_interval=0.7))
    lane = types.SimpleNamespace(index=1, ring=types.SimpleNamespace(name="r"),
                                 slot=types.SimpleNamespace(name="s"),
                                 mbank=types.SimpleNamespace(name="m"))
    eng._proc.bank = types.SimpleNamespace(name="b")
    spec = eng._proc._lane_spec(lane)
    eng._proc.bank = None
    assert spec["audit_interval"] == 0.7
    child = proclanes._make_lane_engine(spec)
    assert (child._audit_interval, child._lane_index, child._lane_n) == (0.7, 1, 2)
    monkeypatch.setenv("KWOK_TPU_AUDIT_INTERVAL", "5")
    off = proclanes._make_lane_engine({**spec, "audit_interval": 0.0})
    assert off._audit_interval == 0.0


def test_readyz_503_while_drift_is_set():
    from kwok_tpu_torch.kwok.server import EngineServer

    eng = ClusterEngine(FakeKube(), EngineConfig(manage_all_nodes=True, device="cpu"))
    eng.ready = True
    srv = EngineServer(eng, "127.0.0.1:0")
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"

    def readyz():
        try:
            return urllib.request.urlopen(url + "/readyz", timeout=5).status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        assert readyz() == 200
        eng._degradation.set("drift")
        assert readyz() == 503
        metrics = urllib.request.urlopen(url + "/metrics", timeout=5).read().decode()
        assert 'kwok_degraded{reason="drift"} 1' in metrics
        eng._degradation.clear("drift")
        assert readyz() == 200
    finally:
        srv.stop()


def test_drift_families_render_with_jax_help():
    """The three families on the engine's registry, with kwok_tpu's help
    strings (docs/observability.md's catalogue)."""
    from kwok_tpu.resilience import antientropy as jax_ae
    from kwok_tpu_torch.resilience import antientropy as ae

    kube = FakeKube()
    eng = _sync_engine(LIBS["torch"], kube)
    assert drift_rig.silent_delete(kube, "pods", "default", _seed(LIBS["torch"], eng, kube)[0])
    aud = _auditor(LIBS["torch"], eng)
    aud.pass_once()
    text = eng.metrics_text()
    assert 'kwok_drift_detected_total{kind="pods",reason="ghost-row"} 1' in text
    assert "kwok_drift_repaired_total 1" in text
    for fam in ("kwok_drift_detected_total", "kwok_drift_repaired_total",
                "kwok_audit_pass_seconds"):
        assert f"# TYPE {fam} " in text
    assert (ae._HELP_DETECTED, ae._HELP_REPAIRED, ae._HELP_PASS) == (
        jax_ae._HELP_DETECTED, jax_ae._HELP_REPAIRED, jax_ae._HELP_PASS)
    assert (ae._PAGE_SIZE, ae._MAX_PAGES, ae._MAX_SUSPECTS, ae._DEGRADE_STREAK) == (
        jax_ae._PAGE_SIZE, jax_ae._MAX_PAGES, jax_ae._MAX_SUSPECTS, jax_ae._DEGRADE_STREAK)
    assert json.dumps(ae.REASONS) == json.dumps(jax_ae.REASONS)


@pytest.mark.parametrize("name", ["aep-\udcc3x", "aep-\x18x", "aep/x", "aep x", "aep?x"])
def test_ghost_row_under_a_name_no_request_can_carry_is_released(name):
    """A garbled watch line can leave a row whose name no request path can
    carry: bytes that are not UTF-8 (surrogate escapes), a control byte,
    a delimiter. No object on the server has such a name, so the port's
    auditor confirms the ghost without a GET and releases the row
    (kwok_tpu's GET raises there on every pass, and its pass repairs
    nothing after it in the window)."""
    L = LIBS["torch"]
    kube = FakeKube()
    eng = _sync_engine(L, kube)
    _seed(L, eng, kube)
    bad = make_pod(name, node="ae-n")
    bad["metadata"].update(uid="u-bad", resourceVersion="3")
    try:
        eng._ingest("pods", "ADDED", bad)
    except UnicodeEncodeError:
        pass  # a surrogate name: its ingest fails after the row was taken
    key = ("default", name)
    assert eng.pods.pool.lookup(key) is not None
    assert kube.get("pods", "default", "aep0") is not None
    drift_rig.silent_delete(kube, "pods", "default", "aep0")  # after it in the window
    aud = _auditor(L, eng)
    aud.pass_once()
    assert aud.detected_total(reason="ghost-row") == 2
    _drain(eng)
    assert eng.pods.pool.lookup(key) is None
    assert eng.pods.pool.lookup(("default", "aep0")) is None


def test_shard_of_hashes_a_surrogate_escaped_name_as_its_bytes():
    """rowpool.shard_of encodes surrogate escapes back to the raw bytes the
    native partition hashed, so the router and the auditor find such a
    row's lane (kwok_tpu's shard_of raises on them)."""
    import zlib

    raw = b"default\x1faep-\xc3x"
    key = ("default", raw.split(b"\x1f")[1].decode("utf-8", "surrogateescape"))
    assert shard_of(key, 8) == zlib.crc32(raw) % 8
    assert shard_of(("default", "aep1"), 8) == zlib.crc32(b"default\x1faep1") % 8


def _garbled_binding(L):
    """A pod whose row came from a garbled line that still parsed: same
    uid and revision as the server's object, bound to a node that does
    not exist, so it never runs."""
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    _seed(L, eng, kube)
    kube.create("pods", make_pod("gb", node="ae-n"))
    bad = kube.get("pods", "default", "gb")
    bad["spec"]["nodeName"] = "ae-\x18"
    eng._ingest("pods", "ADDED", bad)
    aud = _auditor(L, eng)
    aud.pass_once()
    _drain(eng)
    idx = eng.pods.pool.lookup(("default", "gb"))
    return aud.detected_total(reason="stale-row"), eng.pods.pool.meta[idx]["node"]


def test_row_bound_to_a_garbled_node_is_a_stale_row():
    """The port's auditor compares a pod row's node binding with the
    server's spec.nodeName too: a row bound elsewhere (same uid, revision
    and phase) is a stale row, and its re-ingest rebinds it. kwok_tpu's
    compares (uid, rv, phase) only and detects nothing; under the drift
    phase's storm such pods stayed Pending for good."""
    assert _garbled_binding(LIBS["torch"]) == (1, "ae-n")
    assert _garbled_binding(LIBS["jax"]) == (0, "ae-\x18")


def _double_applied_node(L):
    """A node row whose revision runs ahead of the server's: a suspect
    from the listed window, re-checked with a GET."""
    kube = L.FakeKube()
    eng = _sync_engine(L, kube)
    _seed(L, eng, kube)
    idx = eng.nodes.pool.lookup("ae-n")
    eng.nodes.pool.meta[idx]["rv"] = 10_000_000
    aud = _auditor(L, eng)
    aud.pass_once()
    _drain(eng)
    idx = eng.nodes.pool.lookup("ae-n")
    return (aud.detected_total(kind="nodes", reason="double-apply"),
            aud.detected_total(kind="nodes", reason="ghost-row"),
            idx is not None and eng.nodes.pool.meta[idx]["rv"] < 10_000_000)


def test_node_suspect_is_rechecked_without_a_namespace():
    """A node found divergent in a listed window is re-checked by a GET
    with no namespace (nodes are cluster-scoped), and repaired by
    re-ingest. kwok_tpu's auditor GETs it under the namespace "default",
    gets 404, confirms a ghost and releases the live node's row (its pods
    then stay Pending: the drift phase's storm)."""
    assert _double_applied_node(LIBS["torch"]) == (1, 0, True)
    assert _double_applied_node(LIBS["jax"]) == (0, 1, False)


def test_rig_routes_change_the_store_with_no_event():
    """``drift_rig``'s server routes (the drift phase's store in a process
    of its own) make the same silent changes as its in-process helpers: a
    phase set back and a delete with no event and no revision bump, a
    create under a real revision and no event; the window route widens
    that store's watch cache only; ``/rig/state`` counts the Running pods."""
    srv = drift_rig._rig_server_class()().start()
    other = FakeKube()
    try:
        rig = drift_rig.RigClient(srv.url)
        store = srv.store
        for i in range(3):
            store.create("nodes", make_node(f"node-{i}"))
        for i in range(2):
            pod = make_pod(f"rp{i}", "node-0")
            pod["status"] = {"phase": "Running", "podIP": f"10.0.0.{i + 1}"}
            store.create("pods", pod)
        assert rig.state()["running"] == 2
        w = store.watch("pods")
        rv0 = store._rv
        assert rig.silent(op="phase", kind="pods", namespace="default", name="rp0",
                          phase="Pending") == {"ok": True}
        assert rig.get("pods", "default", "rp0")["status"]["phase"] == "Pending"
        assert rig.silent(op="delete", kind="pods", namespace="default", name="rp1") == {
            "ok": True}
        assert rig.get("pods", "default", "rp1") is None
        assert store._rv == rv0
        made = rig.silent(op="create", kind="pods", object=make_pod("rp2", "node-1"))
        assert made["ok"] and int(made["object"]["metadata"]["resourceVersion"]) == rv0 + 1
        assert w.q.qsize() == 0
        w.stop()
        st = rig.state()
        assert (st["running"], st["pods"], st["not_running"]) == (0, 2, ["rp0", "rp2"])
        rig.window(32_768)
        assert (store.rv_window, other.rv_window) == (32_768, FakeKube().rv_window)
        assert rig.compact() == store._rv
        with pytest.raises(urllib.error.HTTPError) as e:
            rig.silent(op="nope")
        assert e.value.code == 400
    finally:
        srv.stop()
