"""The port's crash-durable checkpoints (kwok_tpu_torch.resilience.checkpoint
and the engine's checkpoint service) against kwok_tpu.resilience.checkpoint
on the CPU.

- The file round trip, and a torn or foreign file as a cold start.
- ``RestoreSession.match_kind`` gives the JAX package's indices, timers,
  counts and leftovers on the same seeded inputs (exact).
- ``refine_flush`` is bit-exact against the JAX ``refine_flush``, with an
  offset into a stacked state.
- A file written by either package's ``Checkpointer`` restores in the
  other.
- The restart end to end (tests/test_resilience.py's
  test_checkpoint_restart_resumes_residues) with 1 and with 4 lanes: the
  refined residues track the checkpoint within 3 s, the stale row re-arms
  fresh; the full-disk degradation of the writer; zero cost when
  disabled.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest

from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
from kwok_tpu.engine import ClusterEngine as JaxEngine
from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.engine.rowpool import RowPool as JaxRowPool
from kwok_tpu.models.defaults import default_pod_rules as jax_pod_rules
from kwok_tpu.models.lifecycle import Delay as JaxDelay
from kwok_tpu.ops import state as jstate
from kwok_tpu.ops import updates as jupdates
from kwok_tpu.resilience import checkpoint as jckpt
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.engine import ClusterEngine as TorchEngine
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.engine.rowpool import RowPool
from kwok_tpu_torch.models.defaults import default_pod_rules
from kwok_tpu_torch.models.lifecycle import Delay
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops import updates as tupdates
from kwok_tpu_torch.resilience import checkpoint as tckpt
from kwok_tpu_torch.resilience.policy import Degradation
from kwok_tpu_torch.telemetry.registry import MetricsRegistry
from tests.test_torch_engine import make_node, make_pod


def wait_for(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def seeded_kinds(seed: int) -> dict:
    rng = random.Random(seed)
    kinds = {"nodes": {}, "pods": {}}
    for i in range(50):
        fire = round(rng.uniform(0, 30), 6) if rng.random() < 0.7 else None
        hb = round(rng.uniform(0, 30), 6) if rng.random() < 0.5 else None
        kinds["pods"][f"ns{i % 3}/p{i}"] = [
            f"uid-{i}", rng.randrange(1, 10_000), fire, hb,
            rng.randrange(0, 5), rng.randrange(0, 4),
        ]
        kinds["nodes"][f"n{i}"] = [f"nuid-{i}", rng.randrange(1, 10_000), None, hb, 0, 1]
    return kinds


def test_checkpoint_write_load_roundtrip(tmp_path):
    kinds = seeded_kinds(7)
    w = tckpt.Checkpointer(str(tmp_path), "engine", 1.0)
    w._write({"kinds": kinds})
    doc = tckpt.load(str(tmp_path), "engine")
    assert doc is not None and doc["v"] == tckpt.VERSION == jckpt.VERSION
    assert doc["kinds"] == kinds and doc["name"] == "engine"
    assert not os.path.exists(w.path + ".tmp")
    assert tckpt.load(str(tmp_path), "other") is None  # absent: cold start
    with open(tckpt.checkpoint_path(str(tmp_path), "engine"), "w") as f:
        f.write("{not json")  # torn or hand-edited: cold start, no crash
    assert tckpt.load(str(tmp_path), "engine") is None
    with open(tckpt.checkpoint_path(str(tmp_path), "engine"), "w") as f:
        f.write('{"v": 99, "kinds": {}}')
    assert tckpt.load(str(tmp_path), "engine") is None


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_checkpoint_file_restores_in_the_other_package(tmp_path, writer, reader):
    kinds = seeded_kinds(11)
    wmod, rmod = (jckpt, tckpt) if writer == "jax" else (tckpt, jckpt)
    wmod.Checkpointer(str(tmp_path), "engine", 1.0)._write({"kinds": kinds})
    doc = rmod.load(str(tmp_path), "engine")
    assert doc["kinds"] == kinds
    # the reader's session matches the written rows as the writer's would
    pools = {}
    for mod, pool_cls in ((jckpt, JaxRowPool), (tckpt, RowPool)):
        pool = pool_cls(64)
        for ks, ent in kinds["pods"].items():
            idx = pool.acquire(mod.str_key("pods", ks))
            pool.meta[idx].update(rv=ent[1], uid=ent[0])
        pools[mod] = pool
    got = rmod.RestoreSession(doc["kinds"], gate_ready=True).match_kind(
        "pods", pools[rmod], frozenset(), 10.0)
    ref = wmod.RestoreSession(kinds, gate_ready=True).match_kind(
        "pods", pools[wmod], frozenset(), 10.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0].size == len(kinds["pods"])


def session_inputs(mod, pool_cls, seed: int):
    """A pool, mirrors and device fire_at from a seed, with entries that
    match, moved (rv, uid, phase), are unarmed, staged or unlisted."""
    rng = np.random.default_rng(seed)
    cap = 64
    pool = pool_cls(cap)
    phase_h = np.zeros(cap, np.int32)
    fire = np.full(cap, np.inf, np.float32)
    ents = {}
    staged = set()
    for i in range(48):
        key = ("default", f"p{i}")
        ks = mod.key_str("pods", key)
        uid, rv, ph = f"u{i}", int(rng.integers(1, 999)), int(rng.integers(0, 3))
        fire_res = float(np.round(rng.random() * 30, 6)) if rng.random() < 0.8 else None
        hb_res = float(np.round(rng.random() * 30, 6)) if rng.random() < 0.3 else None
        ents[ks] = [uid, rv, fire_res, hb_res, int(rng.integers(0, 5)), ph]
        case = i % 8
        if case == 7:
            continue  # not listed
        idx = pool.acquire(key)
        pool.meta[idx].update(
            rv=rv + (case == 1), uid=uid if case != 2 else "other",
        )
        phase_h[idx] = ph + (case == 3)
        fire[idx] = np.inf if case == 4 else 50.0
        if case == 5:
            staged.add(idx)
    return pool, phase_h, fire, ents, frozenset(staged)


def test_restore_session_match_kind_equals_jax():
    out = {}
    for mod, pool_cls in ((jckpt, JaxRowPool), (tckpt, RowPool)):
        pool, phase_h, fire, ents, staged = session_inputs(mod, pool_cls, seed=21)
        s = mod.RestoreSession({"pods": ents}, gate_ready=True)
        first = s.match_kind("pods", pool, staged, 100.0, phase_h=phase_h, fire=fire)
        fire[:] = 7.0  # everything listed is armed now
        second = s.match_kind("pods", pool, frozenset(), 100.0, phase_h=phase_h, fire=fire)
        out[mod] = (first, second, s.matched, s.stale, sorted(s.kinds["pods"]), s.finish())
    ref, got = out[jckpt], out[tckpt]
    for a, b in zip(got[:2], ref[:2]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert got[2:] == ref[2:]
    assert got[2] > 0 and got[3] > 0 and got[5]["unlisted"] > 0


def test_refine_flush_matches_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    n, r = 3, 50
    host = ts.to_numpy(ts.new_row_state(n * r, "cpu"))
    host.active[:] = rng.random(n * r) < 0.8
    host.fire_at[:] = (rng.random(n * r) * 9).astype(np.float32)
    host.gen[:] = rng.integers(0, 4, n * r)
    jst = jstate.RowState(*(jnp.asarray(getattr(host, f)) for f in jstate.RowState._fields))
    pst = ts.from_numpy(host, "cpu")
    for li in range(n):
        idx = rng.choice(r, 20, replace=False).astype(np.int32)
        idx[0] = r - 1  # the lane's edge row
        fire = (rng.random(20) * 30).astype(np.float32)
        fire[1] = np.inf
        hb = np.where(rng.random(20) < 0.5, np.inf, rng.random(20) * 30).astype(np.float32)
        gen = rng.integers(0, 9, 20).astype(np.int32)
        jst = jupdates.refine_flush(jst, idx, fire, hb, gen, offset=li * r)
        pst = tupdates.refine_flush(pst, idx, fire, hb, gen, offset=li * r, rows=r)
    got = ts.to_numpy(pst)
    for f in jstate.RowState._fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(jst, f)), err_msg=f)
    # an index past the lane's rows is dropped, not written into the next lane
    before = ts.to_numpy(pst)
    pst = tupdates.refine_flush(pst, np.array([r], np.int32), np.zeros(1, np.float32),
                                np.zeros(1, np.float32), np.zeros(1, np.int32), offset=0, rows=r)
    after = ts.to_numpy(pst)
    for f in ("fire_at", "hb_due", "gen"):
        np.testing.assert_array_equal(getattr(after, f), getattr(before, f))


# ------------------------------------------------------------ restart E2E


def restart_config(tmp_path, shards):
    return TorchConfig(
        manage_all_nodes=True, tick_interval=0.05, drain_shards=shards,
        checkpoint_dir=str(tmp_path), checkpoint_interval=0.25,
        pod_rules=default_pod_rules(running_delay=Delay.constant(30.0)),
        device="cpu",
    )


def fire_residues(eng, keys):
    """Each key's device fire_at minus engine-now, from the engine's own
    rows (the stacked state under lanes)."""
    now = eng._now()
    out = {}
    if eng._lanes is None:
        fire = eng.pods.state.fire_at.numpy()
        for key in keys:
            out[key] = float(fire[eng.pods.pool.lookup(key)]) - now
        return out
    ls = eng._lanes
    fire = ls.stacked["pods"].fire_at.numpy()
    for key in keys:
        for li, lane in enumerate(ls.lanes):
            idx = lane.engine.pods.pool.lookup(key)
            if idx is not None:
                out[key] = float(fire[li * ls.r + idx]) - now
    return out


@pytest.mark.parametrize("shards", [1, 4])
def test_checkpoint_restart_resumes_residues(tmp_path, monkeypatch, shards):
    """Stop and restart resume every matching pod's in-flight delay from
    the final checkpoint; a row whose rv moved while the engine was down
    re-arms fresh."""
    monkeypatch.delenv("KWOK_TPU_CHECKPOINT_DIR", raising=False)
    kube = PortFakeKube()
    e1 = TorchEngine(kube, restart_config(tmp_path, shards))
    e1.start()
    try:
        kube.create("nodes", make_node("ck-n0"))
        for i in range(5):
            kube.create("pods", make_pod(f"ckp{i}", node="ck-n0"))

        def armed():
            doc = tckpt.load(str(tmp_path), "engine")
            pods = (doc or {}).get("kinds", {}).get("pods", {})
            return len(pods) == 5 and all(v[2] is not None for v in pods.values())

        assert wait_for(armed, 20.0), "checkpoint never covered armed pods"
        # let a measurable slice of the delay elapse, so a resumed residue
        # (~27 s) is distinguishable from a fresh re-arm (30 s)
        time.sleep(2.5)
    finally:
        e1.stop()  # writes the FINAL checkpoint on the device thread
    doc = tckpt.load(str(tmp_path), "engine")
    residues = {k: v[2] for k, v in doc["kinds"]["pods"].items()}
    assert all(24.0 < r < 29.0 for r in residues.values()), residues
    assert e1.metrics["checkpoint_writes_total"] >= 2
    # one pod's object moves on while the engine is down -> stale
    kube.patch_meta("pods", "default", "ckp0", {"metadata": {"labels": {"moved": "yes"}}})

    e2 = TorchEngine(kube, restart_config(tmp_path, shards))
    e2.start()
    try:
        assert wait_for(lambda: e2.ready, 20.0), "restart never became ready"
        assert wait_for(lambda: e2._restore is None, 15.0), "restore never closed"
        keys = [("default", f"ckp{i}") for i in range(5)]
        res = fire_residues(e2, keys)
        refined = [res[k] for k in keys[1:]]
        assert max(refined) - min(refined) < 0.5, res
        assert all(abs(res[k] - residues[f"default/ckp{i}"]) < 3.0
                   for i, k in enumerate(keys) if i), (res, residues)
        # the stale pod re-armed with the full fresh delay
        assert res[keys[0]] - max(refined) > 1.2, (res, residues)
        assert e2.metrics["restart_recovery_seconds"] > 0
        assert all((p.get("status") or {}).get("phase") == "Pending"
                   for p in kube.list("pods"))
    finally:
        e2.stop()


def test_checkpoint_zero_cost_when_disabled(monkeypatch):
    monkeypatch.delenv("KWOK_TPU_CHECKPOINT_DIR", raising=False)
    eng = TorchEngine(PortFakeKube(), TorchConfig(
        manage_all_nodes=True, tick_interval=0.02, device="cpu"))
    eng.start()
    try:
        assert wait_for(lambda: eng.ready, 20.0)
        assert eng._ckpt is None and eng._restore is None
        assert not any(t.name.startswith("kwok-ckpt") for t in threading.enumerate())
        assert "checkpoint_writes_total" not in eng.metrics
    finally:
        eng.stop()


def test_checkpoint_dir_env_and_off(tmp_path, monkeypatch):
    monkeypatch.setenv("KWOK_TPU_CHECKPOINT_DIR", str(tmp_path))
    assert TorchEngine(PortFakeKube(), TorchConfig(
        manage_all_nodes=True, device="cpu"))._ckpt_dir == str(tmp_path)
    assert TorchEngine(PortFakeKube(), TorchConfig(
        manage_all_nodes=True, checkpoint_dir="off", device="cpu"))._ckpt_dir == ""


def test_checkpoint_writer_full_disk_degrades_and_recovers(tmp_path, monkeypatch):
    """ENOSPC on the writer thread: it degrades (kwok_degraded{reason=
    "checkpoint"}), keeps the last good file, retries, and clears the
    reason with the newest snapshot once the disk heals."""
    deg = Degradation(MetricsRegistry())
    w = tckpt.Checkpointer(str(tmp_path), "engine", 0.1, degradation=deg)
    monkeypatch.setattr(tckpt, "_RETRY_BASE_S", 0.01)
    monkeypatch.setattr(tckpt, "_RETRY_CAP_S", 0.05)
    w.start()
    try:
        good = {"kinds": {"pods": {"default/p0": ["u", 1, 1.5, None, 0, 0]}}}
        w.submit(good)
        assert wait_for(lambda: w.writes == 1, 5.0)
        disk_full = threading.Event()
        disk_full.set()
        real_replace = os.replace

        def replace(src, dst):
            if disk_full.is_set() and dst == w.path:
                raise OSError(28, "No space left on device")
            return real_replace(src, dst)

        monkeypatch.setattr(tckpt.os, "replace", replace)
        w.submit({"kinds": {"pods": {"default/p0": ["u", 2, 0.5, None, 1, 1]}}})
        assert wait_for(lambda: "checkpoint" in deg.reasons, 5.0)
        assert tckpt.load(str(tmp_path), "engine")["kinds"] == good["kinds"]
        newest = {"kinds": {"pods": {"default/p0": ["u", 3, 0.1, None, 2, 1]}}}
        w.submit(newest)
        disk_full.clear()
        assert wait_for(lambda: "checkpoint" not in deg.reasons, 5.0)
        assert wait_for(lambda: (tckpt.load(str(tmp_path), "engine") or {})
                        .get("kinds") == newest["kinds"], 5.0)
    finally:
        w.stop()


class _Steps:
    """Drain, dispatch, consume, snapshot and refine of an unstarted
    engine, by hand: the threaded lanes' coordinator steps, or the single
    lane's tick-thread steps."""

    def __init__(self, eng):
        self.eng = eng
        self.lanes = eng._lanes

    def drain(self):
        if self.lanes is not None:
            self.lanes.drain_inline()
            return
        raw: dict = {}
        while not self.eng._q.empty():
            item = self.eng._q.get_nowait()
            if item is not None:
                self.eng._drain_apply(item, raw)
        self.eng._drain_flush(raw)

    def dispatch(self):
        return (self.lanes.dispatch() if self.lanes is not None
                else self.eng._tick_dispatch())

    def consume(self, p):
        if self.lanes is not None:
            self.lanes._consume(p, deque(), inline=True)
        else:
            self.eng._tick_consume(p)

    def snapshot(self):
        snap = self.lanes._ckpt_snapshot if self.lanes is not None else self.eng._ckpt_snapshot
        return snap(self.eng._now())

    def refine(self, r):
        self.eng._restore = r
        if self.lanes is not None:
            self.lanes._ckpt_refine(r, self.eng._now())
        else:
            self.eng._ckpt_refine(self.eng._now())


def _feed(eng, kube):
    """Every node and pod of ``kube`` onto the engine's ingest queue."""
    for kind in ("nodes", "pods"):
        for obj in kube.list(kind):
            eng._q.put((kind, "ADDED", obj))


@pytest.mark.parametrize("lib,shards", [("torch", 1), ("torch", 2), ("jax", 2)])
def test_checkpoint_between_a_firing_dispatch_and_its_consume_restores_to_running(lib, shards):
    """A checkpoint gathered after the dispatch that fired a pod and
    before that dispatch's consume (the engine then dies, so the Running
    patch never leaves) describes the row as the device holds it: the
    restored engine finds the pod Pending at the same revision, drops the
    entry as stale and patches the pod Running. With the host mirror's
    phase the entry read "Pending, no timer", the restore wrote that over
    the fresh arm and the pod stayed Pending; kwok_tpu keeps that fault,
    and the case holds it to it."""
    if lib == "jax":
        mod = jckpt

        def make():
            return JaxEngine(kube, JaxConfig(
                manage_all_nodes=True, drain_shards=shards,
                pod_rules=jax_pod_rules(running_delay=JaxDelay.constant(0.3))))
    else:
        mod = tckpt

        def make():
            return TorchEngine(kube, TorchConfig(
                manage_all_nodes=True, drain_shards=shards, device="cpu",
                pod_rules=default_pod_rules(running_delay=Delay.constant(0.3))))
    kube = PortFakeKube() if lib == "torch" else JaxFakeKube()
    kube.create("nodes", make_node("fd-n0"))
    for i in range(4):
        kube.create("pods", make_pod(f"fd{i}", node="fd-n0"))
    e1 = make()
    s1 = _Steps(e1)
    _feed(e1, kube)
    snap = None
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        s1.drain()
        p = s1.dispatch()
        got = s1.snapshot()
        pods = got["kinds"]["pods"]
        if len(pods) == 4 and all(v[4] >= 1 for v in pods.values()):
            snap = got  # every pod fired in p, which is never consumed
            break
        if p is not None:
            s1.consume(p)
        time.sleep(0.05)
    assert snap is not None, "the pods never fired"
    assert all((o.get("status") or {}).get("phase") == "Pending" for o in kube.list("pods"))

    e2 = make()
    s2 = _Steps(e2)
    _feed(e2, kube)
    r = mod.RestoreSession(snap["kinds"], gate_ready=False, ttl=30.0)
    deadline = time.monotonic() + (10.0 if lib == "torch" else 3.0)
    phases: list = []
    while time.monotonic() < deadline:
        s2.drain()
        p = s2.dispatch()
        if p is not None:
            s2.consume(p)
        s2.refine(r)
        phases = [(o.get("status") or {}).get("phase") for o in kube.list("pods")]
        if phases == ["Running"] * 4:
            break
        time.sleep(0.05)
    if lib == "jax":
        assert phases == ["Pending"] * 4 and r.matched == 4, (phases, r.matched)
        return
    assert phases == ["Running"] * 4, (phases, r.matched, r.stale)
    # the entries carry the device's phase (Running), so none matched
    assert {v[5] for v in snap["kinds"]["pods"].values()} == {1}, snap["kinds"]["pods"]
