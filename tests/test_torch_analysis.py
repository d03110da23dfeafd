"""The port's kwoklint (kwok_tpu_torch.analysis) against kwok_tpu.analysis.

- For each rule both packs share, over the reference's fixtures in
  tests/analysis_fixtures/ (read only): the port's findings equal
  kwok_tpu.analysis's in path, line, rule and severity, and fire on every
  `# F:` marker.
- The torch kernel-purity rule fires exactly on the `# F:` lines of a
  torch fixture written under tmp_path, one line per construct, and stays
  silent on its negatives; on the real tree its scope is the dispatch
  path (the kernel's wrapper, `MultiTickKernel.__call__`, `pack_wire`).
- The port's cc rules fire exactly on bad_native.cc and parse every
  kwok_tpu_torch/native/*.cc to real acquisition timelines whose mutexes
  the port's tables declare.
- The real tree analyzes clean, and every suppression and `lockfree=`
  annotation in kwok_tpu_torch carries a justification.
- Witness twins of the reference's cases (an ABBA cycle with both stacks,
  same-site nesting, a declared-order violation, RLock re-entry), the
  port's `reclaimable()` locks seen under their callers' names, the
  threaded-lanes engine clean under the witness, and the shm witness's
  clean run, torn write and torn read.
- The race the shared-state review found: a startup gate that the device
  loop finishes while stop() runs must not leave a stopped engine ready.
"""

from __future__ import annotations

import os
import re
import threading
import time

import pytest

from kwok_tpu.analysis import cclint as jcc
from kwok_tpu.analysis import core as jcore
from kwok_tpu.analysis import hygiene as jhygiene
from kwok_tpu.analysis import locks as jlocks
from kwok_tpu.analysis import metrics_doc as jmetrics
from kwok_tpu.analysis import races as jraces
from kwok_tpu.analysis import shmproto as jshm
from kwok_tpu.analysis import spawnonly as jspawn
from kwok_tpu_torch.analysis import cclint as tcc
from kwok_tpu_torch.analysis import core as tcore
from kwok_tpu_torch.analysis import hygiene as thygiene
from kwok_tpu_torch.analysis import locks as tlocks
from kwok_tpu_torch.analysis import metrics_doc as tmetrics
from kwok_tpu_torch.analysis import races as traces
from kwok_tpu_torch.analysis import shmproto as tshm
from kwok_tpu_torch.analysis import spawnonly as tspawn
from kwok_tpu_torch.analysis.purity import KernelPurityRule

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "analysis_fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kwok_tpu_torch")

_MARK = re.compile(r"(?:#|//)\s*F:\s*([a-z\-]+)")


def markers(path: str) -> set:
    out = set()
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            m = _MARK.search(line)
            if m:
                out.add((i, m.group(1)))
    return out


def key(findings) -> set:
    return {(f.path, f.line, f.rule, f.severity) for f in findings}


# ------------------------------------------------ parity over the fixtures

# (fixture, rule factory per package); each factory returns one pack's rules
PY_CASES = {
    "lock-rules": ("bad_lock_order.py", lambda m: [
        m.LockOrderRule(), m.BlockingUnderLockRule(), m.UnusedLockRule()]),
    "shared-state": ("shared_state.py", lambda m: [m.SharedStateRule()]),
    "shm-protocol": ("shm_protocol.py", lambda m: [m.ShmProtocolRule()]),
    "silent-except": ("silent_except.py", lambda m: [m.SilentExceptRule()]),
    "spawn-only": ("forkish_multiprocessing.py", lambda m: [m.SpawnOnlyRule()]),
}
PACKS = {
    "jax": {"lock-rules": jlocks, "shared-state": jraces, "shm-protocol": jshm,
            "silent-except": jhygiene, "spawn-only": jspawn},
    "torch": {"lock-rules": tlocks, "shared-state": traces, "shm-protocol": tshm,
              "silent-except": thygiene, "spawn-only": tspawn},
}


@pytest.mark.parametrize("case", sorted(PY_CASES))
def test_shared_rule_findings_equal_the_reference_on_its_fixture(case):
    name, rules = PY_CASES[case]
    path = os.path.join(FIX, name)
    got = {}
    for lib, core in (("jax", jcore), ("torch", tcore)):
        analyzer = core.Analyzer(FIX, rules(PACKS[lib][case]))
        got[lib] = analyzer.run([path])
    (jf, js), (tf, ts_) = got["jax"], got["torch"]
    assert key(tf) == key(jf)
    assert ts_ == js
    fired = {(f.line, f.rule) for f in tf if f.rule != "bare-suppression"}
    assert fired == markers(path) and fired


def test_metrics_doc_findings_equal_the_reference_on_its_fixture():
    got = {}
    for lib, core, mod in (("jax", jcore, jmetrics), ("torch", tcore, tmetrics)):
        rule = mod.MetricsContractRule(doc_path=os.path.join(FIX, "metrics_doc.md"))
        got[lib], _ = core.Analyzer(FIX, [rule]).run([os.path.join(FIX, "metrics_src")])
    assert key(got["torch"]) == key(got["jax"]) and len(got["torch"]) == 3


def test_cc_rules_fire_exactly_on_fixture_as_the_reference_does():
    path = os.path.join(FIX, "bad_native.cc")
    got = {}
    for lib, mod in (("jax", jcc), ("torch", tcc)):
        got[lib] = set()
        for cls in (mod.CcLockOrderRule, mod.CcFenceFirstRule, mod.CcSocketUnderLockRule):
            got[lib] |= key(cls(cc_paths=[path]).check_project([], FIX))
    assert got["torch"] == got["jax"]
    assert {(line, rule) for _p, line, rule, _s in got["torch"]} == markers(path)


def test_metrics_doc_reads_the_ports_native_apiserver(tmp_path):
    """The port's rule scans kwok_tpu_torch/native/apiserver.cc (not the
    reference's) and skips the package names in prose."""
    native = tmp_path / "kwok_tpu_torch" / "native"
    native.mkdir(parents=True)
    (native / "apiserver.cc").write_text(
        '  out += "# TYPE kwok_port_only_total counter\\n";\n'
        '  out += "kwok_cc_documented_seconds_sum 0\\n";\n'
    )
    doc = tmp_path / "obs.md"
    doc.write_text("| `kwok_cc_documented_seconds` | kwok_tpu_torch, kwok_tpu |\n")
    msgs = "\n".join(f.message for f in tmetrics.MetricsContractRule(
        doc_path=str(doc)).check_project([], str(tmp_path)))
    assert "kwok_port_only_total" in msgs
    assert "kwok_cc_documented_seconds" not in msgs and "kwok_tpu" not in msgs


# ----------------------------------------------------------- torch purity

PURITY_FIXTURE = '''\
import logging
import os
import random
import time

import numpy as np
import torch

logger = logging.getLogger("fixture")
INF = float("inf")


def pack_wire(outs):
    n = int(outs[0].dirty.shape[0])
    total = outs[0].transitions.item()  # F: kernel-purity
    host = outs[0].dirty.cpu()  # F: kernel-purity
    rows = outs[0].phase.tolist()  # F: kernel-purity
    arr = outs[0].fire_at.numpy()  # F: kernel-purity
    mask = np.asarray(outs[0].hb_fired)  # F: kernel-purity
    due = torch.tensor(INF, device=outs[0].dirty.device)  # F: kernel-purity
    steps = np.asarray([1, 2, 3])
    return helper(outs, n, total, host, rows, arr, mask, due, steps)


def helper(outs, *rest):
    counts = torch.stack([o.transitions for o in outs])
    busy = int(counts.sum())  # F: kernel-purity
    fired = bool(outs[0].hb_fired.any())  # F: kernel-purity
    due = float(torch.minimum(counts[0], counts[1]))  # F: kernel-purity
    now = float(np.float32(1.5))
    torch.cuda.synchronize()  # F: kernel-purity
    print("tick", busy)  # F: kernel-purity
    with open("/dev/null") as fh:  # F: kernel-purity
        fh.read()
    logger.info("tick")  # F: kernel-purity
    t0 = time.perf_counter()  # F: kernel-purity
    jitter = random.random()  # F: kernel-purity
    noise = np.random.rand()  # F: kernel-purity
    flag = os.environ.get("X")  # F: kernel-purity
    return busy, fired, due, now, t0, jitter, noise, flag


class Launcher:
    def __init__(self):
        self.spec = None

    def __call__(self, state, now):
        dirty, deleted, hb, counts = cuda_tick.tick_steps(state, self.spec, now)
        self.sync(counts)
        # kwoklint: disable=kernel-purity -- first use only: the fixture's once-per-process load
        self.load()
        wire = Wire(counts)
        return dirty, deleted, hb, wire, int(now), float(np.float32(now))

    def sync(self, counts):
        counts.record_event().synchronize()  # F: kernel-purity

    def load(self):
        return time.time()


class Wire:
    def __init__(self, counts):
        self.n = counts.view(torch.uint8).item()  # F: kernel-purity


def fused(states, specs, now):
    outs, wire = cuda_tick.tick_dispatch(states, specs, now)
    return outs[0].transitions.item(), wire  # F: kernel-purity


def fused_part(lib, desc, wire, records):
    lib.kwok_tick_dispatch(desc, wire, records)
    lib.kwok_tick_epilogue(wire, records)
    return records.cpu()  # F: kernel-purity


def split_part(shards, specs, wire, records):
    cuda_tick.tick_dispatch_part(shards, specs, wire, records)
    cuda_tick.tick_wire_epilogue(wire, records)
    print("split")  # F: kernel-purity
    return wire


def off_the_path(state):
    return state.dirty.item(), time.time(), np.asarray(state.fire_at)
'''


def test_torch_purity_fires_exactly_on_its_fixture(tmp_path):
    path = tmp_path / "dispatch.py"
    path.write_text(PURITY_FIXTURE)
    findings, suppressed = tcore.Analyzer(str(tmp_path), [KernelPurityRule()]).run(
        [str(path)])
    assert {(f.line, f.rule) for f in findings} == markers(str(path))
    assert suppressed == 1  # the load() edge: not followed, so time.time() is not flagged
    assert all("dispatch path" in f.message for f in findings)


def test_torch_purity_scope_is_the_real_dispatch_path():
    rule = KernelPurityRule()

    def scope(rel):
        mod = tcore.load_module(os.path.join(REPO, rel), REPO)
        return {f.qual for f in rule.dispatch_scope(mod)}

    tick = scope("kwok_tpu_torch/ops/tick.py")
    assert {"MultiTickKernel.__call__", "Wire.__init__"} <= tick
    assert "unpack_wire" not in tick and "Wire.__array__" not in tick
    wrapper = scope("kwok_tpu_torch/ops/cuda_tick.py")
    # the per-kind entry, the fused dispatch's wrappers and the plain wire
    # they hand CPU tensors to (pack_wire and what it calls)
    assert {"TickSteps.__call__", "TickSteps.check", "TickSpec.packed",
            "tick_dispatch", "tick_dispatch_part", "tick_wire_epilogue",
            "wire_layout", "blocks_of", "pack_wire", "next_due", "packbits"} <= wrapper
    # the two annotated edges: the once-per-process build, the CPU version
    assert not {"TickSteps.library", "build_library", "tick_steps_plain"} & wrapper
    assert "GraftStep.__call__" in scope("kwok_tpu_torch/graft.py")
    assert {"_split_on_card", "_owned_ranges",
            "ShardedTickKernel.__call__"} <= scope("kwok_tpu_torch/parallel/sharded_tick.py")


def test_torch_purity_sees_no_dispatch_path_in_a_jax_kernel():
    path = os.path.join(FIX, "impure_kernel.py")
    findings, _ = tcore.Analyzer(FIX, [KernelPurityRule()]).run([path])
    assert findings == []


# --------------------------------------------------------------- cc lint


def test_cc_rules_parse_every_port_translation_unit():
    paths = tcc.cc_files(REPO)
    assert {os.path.basename(p) for p in paths} == {
        "apiserver.cc", "codec.cc", "ingest.cc", "pump.cc"}
    assert all(os.path.dirname(p) == os.path.join(PORT, "native") for p in paths)
    scans = {os.path.basename(p): tcc.scan_cc(p, REPO) for p in paths}
    api = scans["apiserver.cc"]
    assert len(api.acquisitions) >= 40
    assert api.commits and api.deferred_decls and api.sends
    assert len(scans["pump.cc"].acquisitions) >= 2
    known = set(tcc.CC_LOCK_ORDER) | set(tcc.CC_STANDALONE)
    seen = {a.mutex for s in scans.values() for a in s.acquisitions}
    assert seen <= known, seen - known
    # the rig's mutexes are declared where their code puts them
    assert {"g_census_mu", "g_rig_writes_mu", "slot_mu"} <= seen
    nested = {(h, a.mutex) for a in api.acquisitions for h, _l in a.held}
    assert ("g_census_mu", "slot_mu") in nested
    for cls in (tcc.CcLockOrderRule, tcc.CcFenceFirstRule, tcc.CcSocketUnderLockRule):
        assert list(cls().check_project([], REPO)) == []


# -------------------------------------------------- the real tree is clean


def test_real_tree_analyzes_clean_within_budget(capsys):
    from kwok_tpu_torch.analysis.__main__ import BUDGET_S, main

    t0 = time.perf_counter()
    assert main([]) == 0, capsys.readouterr().out
    assert time.perf_counter() - t0 < BUDGET_S
    assert main(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    names = [r.name for r in jcore.all_rules(REPO)]
    assert listed[-len(names):] == names
    assert main(["--rule", "no-such-rule"]) == 2


def test_every_suppression_in_the_port_is_justified():
    mods = tcore.Analyzer(REPO, []).load([PORT])
    n = 0
    for mod in mods:
        for s in mod.suppressions.values():
            n += 1
            assert s.justification, f"{mod.rel}:{s.line}: suppression without justification"
        for a in traces.scan_lockfree(mod):
            n += 1
            assert a.justification, f"{mod.rel}:{a.line}: lockfree without justification"
    assert n >= 10


# ---------------------------------------------------------------- witness


def _wrapped(witness, name, rlock=False):
    import _thread

    from kwok_tpu_torch.analysis.witness import _WitnessLock, _WitnessRLock

    inner = _thread.RLock() if rlock else _thread.allocate_lock()
    cls = _WitnessRLock if rlock else _WitnessLock
    return cls(inner, witness, ("fixture", name, f"fixture.py:{name}"))


def _no_global_witness():
    from kwok_tpu_torch.analysis.witness import LockWitness

    if LockWitness._installed is not None:
        pytest.skip("a witness is already installed (the test plugin's)")


def test_witness_detects_abba_cycle_with_both_stacks():
    from kwok_tpu_torch.analysis.witness import LockWitness

    w = LockWitness()
    a, b = _wrapped(w, "lock_a"), _wrapped(w, "lock_b")
    with a, b:
        pass
    with b, a:
        pass
    cycles = [v for v in w.violations if v.kind == "order-cycle"]
    assert cycles, [v.message for v in w.violations]
    text = cycles[0].format()
    assert "lock_a" in text and "lock_b" in text and text.count("stack") >= 2
    with pytest.raises(AssertionError):
        w.assert_clean()


def test_witness_same_site_instances_report_nesting_not_cycle():
    from kwok_tpu_torch.analysis.witness import LockWitness

    w = LockWitness()
    a = _wrapped(w, "stage_lock", rlock=True)
    b = _wrapped(w, "stage_lock", rlock=True)
    with a, b:
        pass
    assert [v.kind for v in w.violations] == ["same-site-nesting"]
    with a, _wrapped(w, "_alloc_lock"):
        pass
    assert [v.kind for v in w.violations] == ["same-site-nesting"]


@pytest.mark.parametrize("outer,inner,ok", [
    ("_alloc_lock", "stage_lock", False),   # level 20, then 10
    ("_gen_lock", "_alloc_lock", False),    # level 30, then 20
    ("_ckpt_lock", "_ha_lock", False),      # two level-84 leaves
    ("stage_lock", "_ckpt_lock", True),     # 10 -> 84
    ("_alloc_lock", "_gen_lock", True),     # 20 -> 30
])
def test_witness_checks_the_ports_declared_order(outer, inner, ok):
    from kwok_tpu_torch.analysis.witness import LockWitness

    w = LockWitness()
    with _wrapped(w, outer, rlock=True), _wrapped(w, inner, rlock=True):
        pass
    decl = [v for v in w.violations if v.kind == "declared-order"]
    assert (not decl) == ok, [v.message for v in w.violations]
    if decl:
        assert outer in decl[0].message and inner in decl[0].message


def test_witness_allows_declared_order_and_rlock_reentry():
    from kwok_tpu_torch.analysis.witness import LockWitness

    w = LockWitness()
    stage = _wrapped(w, "stage_lock", rlock=True)
    with stage, stage, _wrapped(w, "_alloc_lock"), _wrapped(w, "_gen_lock"):
        pass
    assert not w.violations, [v.message for v in w.violations]


def test_witness_names_reclaimable_locks_by_their_callers():
    """``locks.reclaimable()`` builds every supervised lock: installed,
    the witness wraps those RLocks under the caller's attribute name, so
    the declared order applies to them, and ``release_held`` still
    reclaims them."""
    from kwok_tpu_torch import locks
    from kwok_tpu_torch.analysis.witness import _WitnessRLock, witness

    _no_global_witness()

    class Holder:
        def __init__(self):
            self.stage_lock = locks.reclaimable()
            self._alloc_lock = locks.reclaimable()

    with witness() as w:
        h = Holder()
        with h._alloc_lock, h.stage_lock:
            pass
        assert isinstance(h.stage_lock, _WitnessRLock)
        h.stage_lock.acquire()
        h.stage_lock.acquire()
        assert locks.release_held() == 2
        assert not h.stage_lock._is_owned()
    assert h.stage_lock.key[1] == "stage_lock" and h._alloc_lock.key[1] == "_alloc_lock"
    decl = [v for v in w.violations if v.kind == "declared-order"]
    assert len(decl) == 1 and "stage_lock" in decl[0].message
    assert type(threading.RLock()).__name__ != "_WitnessRLock"


def test_witness_threaded_lanes_engine_is_clean_end_to_end():
    """The port's threaded lanes (router, drain and emit workers, the
    stacked tick), built and driven under an installed witness: the
    declared order holds on every path taken."""
    from kwok_tpu_torch.analysis.witness import LockWitness
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
    from tests.test_torch_engine import make_node, make_pod

    _no_global_witness()
    w = LockWitness.install()
    try:
        server = FakeKube()
        eng = ClusterEngine(server, EngineConfig(
            manage_all_nodes=True, tick_interval=0.02, drain_shards=2, device="cpu"))
        eng.start()
        try:
            server.create("nodes", make_node("wn0"))
            for i in range(8):
                server.create("pods", make_pod(f"wp{i}", node="wn0"))
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and server.count(
                    "pods", lambda p: p["status"].get("phase") == "Running") < 8:
                time.sleep(0.05)
        finally:
            eng.stop()
    finally:
        LockWitness.uninstall()
    assert server.count("pods", lambda p: p["status"].get("phase") == "Running") == 8
    assert any(n == "stage_lock" for _m, n, _s in {a for a, _b in w.edges}), w.edges
    w.assert_clean()


def test_shm_witness_clean_protocol_records_no_violations():
    from kwok_tpu_torch.analysis.witness_shm import ShmWitness
    from kwok_tpu_torch.engine import shm

    if ShmWitness._installed is not None:
        pytest.skip("a witness is already installed (the test plugin's)")
    w = ShmWitness.install()
    bank = shm.MetricsBank(shm.arena_name("t-wit-b"), 4096, create=True)
    slot = shm.InflightSlot(shm.arena_name("t-wit-s"), 256, create=True)
    ring = shm.RawRing(shm.arena_name("t-wit-r"), 256, create=True)
    try:
        assert bank.write(b'{"gen": 1}')
        assert bank.read() == b'{"gen": 1}'
        bank.torn_write(b'{"gen": 2}')
        assert bank.read() is None
        bank.reset()
        assert slot.arm(b"frame-1") and slot.peek() == b"frame-1"
        slot.torn_arm(b"frame-2")
        assert slot.peek() is None
        off = ring.try_write(b"payload")
        assert off is not None and ring.read(off, 7) == b"payload"
    finally:
        ShmWitness.uninstall()
        for arena in (bank, slot, ring):
            arena.close(unlink=True)
    assert not w.violations, [v.message for v in w.violations]
    assert bank.arena.name.startswith("kwoktorch-")


def _evil_torn_write(real):
    def torn(self, payload):
        real(self, payload)
        hdr = self.arena.hdr
        hdr[self.SEQ] = int(hdr[self.SEQ]) + 1  # restamped even: hides the tear
    return torn


@pytest.mark.parametrize("fault,kind", [
    ("torn_write", "torn-even-stamp"),
    ("read", "torn-read"),
])
def test_shm_witness_flags_a_torn_write_and_a_torn_read(monkeypatch, fault, kind):
    from kwok_tpu_torch.analysis.witness_shm import ShmWitness
    from kwok_tpu_torch.engine import shm

    if ShmWitness._installed is not None:
        pytest.skip("a witness is already installed (the test plugin's)")
    if fault == "torn_write":
        monkeypatch.setattr(shm.MetricsBank, "torn_write",
                            _evil_torn_write(shm.MetricsBank.torn_write))
    else:
        monkeypatch.setattr(shm.MetricsBank, "read",
                            lambda self, retries=8: b"torn-prefix-garbage")
    w = ShmWitness.install()
    bank = shm.MetricsBank(shm.arena_name("t-wit-f"), 4096, create=True)
    try:
        if fault == "torn_write":
            bank.torn_write(b'{"gen": 1}')
        else:
            assert bank.write(b'{"gen": 1}')
            assert bank.read() == b"torn-prefix-garbage"
    finally:
        ShmWitness.uninstall()
        bank.close(unlink=True)
    assert [v.kind for v in w.violations] == [kind]
    with pytest.raises(AssertionError):
        w.assert_clean()


# ------------------------------------------------------- shared-state pins


def test_stop_leaves_the_engine_unready_when_the_gate_finishes_late():
    """The startup-gate fields are lock-free on the promise that only the
    device loop finishes the gate. stop() stores ready=False before it
    joins that loop, so a gate the loop finishes in between would leave a
    stopped engine ready; stop() stores it again once the loop is joined.
    The interleaving is forced: the loop's finish waits for stop()."""
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

    eng = ClusterEngine(FakeKube(), EngineConfig(
        manage_all_nodes=True, tick_interval=0.02, drain_shards=1, device="cpu"))
    finish = eng._finish_startup
    entered = threading.Event()

    def late_finish():
        entered.set()
        eng._stop_evt.wait(10)  # set by stop() after its first stores
        finish()

    eng._finish_startup = late_finish
    eng.start()
    try:
        assert entered.wait(30)
    finally:
        eng.stop()
    assert eng.ready is False and eng._startup_pending is None
