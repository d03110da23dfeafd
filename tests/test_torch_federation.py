"""The port's federation (kwok_tpu_torch.engine.federation) against
kwok_tpu.engine.federation on the CPU.

Each package runs on its own apiserver stores; the port with
``device="cpu"`` (the plain tick), the JAX package as
tests/test_federation.py runs it, on a one-device mesh where the stacked
layouts are compared (the port pads for one card, ``n_devices = 1``).

- ``_pad_cluster_capacity`` over a grid of (r, n, d), compared exactly.
- The oracle: the same per-member script (nodes, pods, a status revert,
  a deletionTimestamp) pumped through both federations by draining every
  member's queue and calling ``tick_once``; per member, the per-key
  request sequences and the final objects (timestamps and
  resourceVersions masked) must be equal, and members must fall into the
  same rule-set groups. Cases: 2 and 8 members, ``tick_substeps=4``, a
  mid-run regrow, finalizer-guarded deletion, heterogeneous member rule
  sets and phase vocabularies. Every rule is constant, so there is no
  stochastic divergence to pin.
- Grouping on selector bits, member ``initial_capacity``, and the regrow
  of a group's stacked state bit for bit against the JAX regrow (integer,
  bool and float32 fields compared exactly, tolerance 0).
- Threaded runs: an idle federation stops dispatching; ``ready`` waits
  for every member; a ``member<i>.ckpt.json`` written by either package
  restores in the other with refined ``fire_at`` residues within 0.5 s.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from kwok_tpu.engine import EngineConfig as JaxConfig
from kwok_tpu.engine import FederatedEngine as JaxFederation
from kwok_tpu.engine import federation as jfed
from kwok_tpu.ops import state as jstate
from kwok_tpu.parallel import make_mesh
from kwok_tpu.resilience import checkpoint as jckpt
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.engine import EngineConfig as TorchConfig
from kwok_tpu_torch.engine import FederatedEngine as TorchFederation
from kwok_tpu_torch.engine import federation as tfed
from kwok_tpu_torch.kwok.server import render_metrics
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops.tick import REBASE_AFTER
from tests.fake_apiserver import FakeKube
from tests.test_lanes import RecordingKube
from tests.test_torch_engine import make_node, make_pod, masked


@pytest.fixture(autouse=True)
def no_swallowed_thread_exceptions():
    """A worker thread dying is a bug even when the test's own assertions
    pass."""
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


def config(lib: str, **kw):
    if lib == "jax":
        return JaxConfig(manage_all_nodes=True, **kw)
    return TorchConfig(manage_all_nodes=True, device="cpu", **kw)


def federation(lib: str, servers, member_configs=None, **kw):
    """One package's federation; the JAX one on a one-device mesh."""
    if lib == "jax":
        return JaxFederation(servers, config("jax", **kw), mesh=make_mesh(1),
                             member_configs=member_configs)
    return TorchFederation(servers, config("torch", **kw), member_configs=member_configs)


def models(lib: str) -> dict:
    """The rule vocabulary of one package."""
    if lib == "jax":
        from kwok_tpu import models as m
        from kwok_tpu.models import lifecycle as lc
        from kwok_tpu.models.defaults import SEL_MANAGED
    else:
        from kwok_tpu_torch import models as m
        from kwok_tpu_torch.models import lifecycle as lc
        from kwok_tpu_torch.models.defaults import SEL_MANAGED
    return {"default_pod_rules": m.default_pod_rules, "SEL_MANAGED": SEL_MANAGED,
            "Delay": lc.Delay, "LifecycleRule": lc.LifecycleRule,
            "ResourceKind": lc.ResourceKind, "StatusEffect": lc.StatusEffect}


def pod_rules_to(lib: str, phase: str, delay: float = 0.0):
    """The default pod rules plus a constant Running -> ``phase`` rule."""
    m = models(lib)
    return m["default_pod_rules"]() + [m["LifecycleRule"](
        name="pod-after-running", resource=m["ResourceKind"].POD,
        from_phases=("Running",), selector=m["SEL_MANAGED"],
        delay=m["Delay"].constant(delay),
        effect=m["StatusEffect"](to_phase=phase, conditions={"Ready": False}),
    )]


def renamed_node_rules(lib: str):
    """One node rule under a custom selector name: the same table bytes
    as the default, a different heartbeat bit."""
    m = models(lib)
    return [m["LifecycleRule"](
        name="node-ready", resource=m["ResourceKind"].NODE,
        from_phases=("Observed", "NotReady"), selector="custom-managed",
        delay=m["Delay"].constant(0.0),
        effect=m["StatusEffect"](to_phase="Ready", conditions={
            "Ready": True, "OutOfDisk": False, "MemoryPressure": False,
            "DiskPressure": False, "NetworkUnavailable": False,
            "PIDPressure": False,
        }),
    )]


def groups_of(fed) -> list[list[int]]:
    """The member partition into rule-set groups, in group order."""
    return [[fed.engines.index(e) for e in g.engines] for g in fed.groups]


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ------------------------------------------------------------ padding


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_pad_cluster_capacity_matches_jax(d):
    for r in (1, 5, 7, 8, 1000, 4096):
        for n in (1, 2, 3, 4, 5, 8, 12):
            got = tfed._pad_cluster_capacity(r, n, d)
            assert got == jfed._pad_cluster_capacity(r, n, d), (r, n, d)
            assert got >= r and (n * got) % d == 0


# -------------------------------------------------------------- oracle


def pump(fed, n: int = 1) -> None:
    """Drain every member's queue in member order, then one synchronous
    federated tick; ``n`` times."""
    for _ in range(n):
        for e in fed.engines:
            while not e._q.empty():
                item = e._q.get_nowait()
                if item:
                    e._ingest(*item[:3])
        fed.tick_once()


def run_script(fed, servers, pods: int, finalizers: bool = False) -> None:
    """Per member: a node, ``pods`` pods (Pending -> Running), a status
    revert MODIFIED (the repair path re-patches), then a
    deletionTimestamp MODIFIED (the engine deletes)."""
    def put(c, kind, type_, obj):
        fed.engines[c]._q.put((kind, type_, obj))

    for c, s in enumerate(servers):
        s.create("nodes", make_node(f"c{c}-n0"))
        put(c, "nodes", "ADDED", s.get("nodes", None, f"c{c}-n0"))
    pump(fed, 2)
    for c, s in enumerate(servers):
        for i in range(pods):
            s.create("pods", make_pod(f"c{c}-p{i}", node=f"c{c}-n0",
                                      finalizers=["kwok.dev/guard"] if finalizers else None))
            put(c, "pods", "ADDED", s.get("pods", "default", f"c{c}-p{i}"))
    pump(fed, 2)
    for c, s in enumerate(servers):
        for i in range(pods):
            obj = s.get("pods", "default", f"c{c}-p{i}")
            put(c, "pods", "MODIFIED", {**obj, "status": {"phase": "Pending"}})
    pump(fed, 2)
    for c, s in enumerate(servers):
        for i in range(pods):
            obj = s.get("pods", "default", f"c{c}-p{i}")
            put(c, "pods", "MODIFIED", {**obj, "metadata": {
                **obj["metadata"], "deletionTimestamp": "2026-01-01T00:00:00Z"}})
    pump(fed, 3)


def final_objects(server):
    objs = {k: masked(server.list(k)) for k in ("nodes", "pods")}
    for o in objs["nodes"] + objs["pods"]:
        o["metadata"]["resourceVersion"] = "<rv>"
    return objs


# name -> (members, pods per member, federation kwargs, member rule sets)
ORACLE = {
    "2-members": (2, 4, {"initial_capacity": 16}, None),
    "8-members": (8, 3, {"initial_capacity": 16}, None),
    "substeps4": (2, 4, {"initial_capacity": 16, "tick_substeps": 4}, None),
    # pools of 4 rows grow past the group's r mid-run
    "regrow": (2, 12, {"initial_capacity": 4}, None),
    "finalizers": (2, 4, {"initial_capacity": 16}, None),
    # member 1 completes its pods, members 0 and 2 share a group
    "heterogeneous": (3, 3, {"initial_capacity": 16}, [None, "Succeeded", None]),
    # numerically identical tables naming different phases
    "vocabularies": (2, 3, {"initial_capacity": 16}, ["Baking", "Frying"]),
}


def oracle_run(lib: str, name: str):
    members, pods, kw, phases = ORACLE[name]
    servers = [RecordingKube() for _ in range(members)]
    cfgs = None
    if phases is not None:
        base = config(lib, **kw)
        cfgs = [base if ph is None else dataclasses.replace(base, pod_rules=pod_rules_to(lib, ph))
                for ph in phases]
    fed = federation(lib, servers, member_configs=cfgs, **kw)
    r0 = fed.cluster_capacity
    run_script(fed, servers, pods, finalizers=name == "finalizers")
    return fed, servers, r0


@pytest.mark.parametrize("name", sorted(ORACLE))
def test_oracle_matches_jax(name):
    jax_fed, jax_servers, jr0 = oracle_run("jax", name)
    fed, servers, r0 = oracle_run("torch", name)
    assert groups_of(fed) == groups_of(jax_fed)
    assert (r0, fed.cluster_capacity) == (jr0, jax_fed.cluster_capacity)
    for c, (got, ref) in enumerate(zip(servers, jax_servers)):
        keys = {k for k, _op, _ph in ref.log}
        assert {k for k, _op, _ph in got.log} == keys, c
        for key in keys:
            assert got.per_key(key) == ref.per_key(key), (c, key)
        assert final_objects(got.inner) == final_objects(ref.inner), c
    _members, pods, kw, phases = ORACLE[name]
    if phases is None:  # the delete rule matches the canonical phases
        assert all(s.inner.list("pods") == [] for s in servers)
    ref_m, m = jax_fed.metrics, fed.metrics
    for k in ("transitions_total", "status_patches_total", "deletes_total",
              "ticks_total", "nodes_managed", "pods_managed"):
        assert m[k] == ref_m[k], k
    for i in range(len(fed.groups)):
        assert m[f"group{i}_dispatches_total"] == ref_m[f"group{i}_dispatches_total"]
    if name == "regrow":
        assert fed.cluster_capacity > r0
    if name == "substeps4":
        assert fed.groups[0].fused.steps == 4
    if phases is not None:
        assert len(fed.groups) == len(set(phases))
        # the completing member's pods went Running, then Succeeded
        for c, ph in enumerate(phases):
            seq = servers[c].per_key(("default", f"c{c}-p0"))
            want = ["Running"] + ([ph] if ph else [])
            assert [p for op, p in seq if op == "patch"][:len(want)] == want, c


def test_grouping_keys_on_selector_bits_not_just_tables():
    """Rule sets differing only in selector names compile to identical
    numeric tables but different heartbeat bits: such members must not
    share a group, in either package."""
    parts = {}
    for lib in ("jax", "torch"):
        base = config(lib, tick_interval=0.05)
        fed = federation(lib, [FakeKube(), FakeKube()], member_configs=[
            base, dataclasses.replace(base, node_rules=renamed_node_rules(lib))])
        assert len({e.node_bits["heartbeat"] for e in fed.engines}) == 2
        parts[lib] = groups_of(fed)
    assert parts["torch"] == parts["jax"] == [[0], [1]]


def test_heterogeneous_vocabularies_do_not_share_kernels():
    cfgs = [dataclasses.replace(config("torch"), pod_rules=pod_rules_to("torch", ph, 1.0))
            for ph in ("Baking", "Frying")]
    fed = federation("torch", [FakeKube(), FakeKube()], member_configs=cfgs)
    assert len(fed.groups) == 2
    assert {"group0_dispatches_total", "group1_dispatches_total"} <= set(fed.metrics)


def test_member_initial_capacity_honored():
    caps = {}
    for lib in ("jax", "torch"):
        base = config(lib, initial_capacity=8)
        fed = federation(lib, [FakeKube(), FakeKube()], initial_capacity=8, member_configs=[
            base, dataclasses.replace(base, initial_capacity=512)])
        assert all(e.config.initial_capacity == 512 for e in fed.engines)
        caps[lib] = fed.cluster_capacity
    assert caps["torch"] == caps["jax"] == 512
    assert fed.groups[0].stacked["pods"].capacity == 2 * 512


# --------------------------------------------------- stacked state vs JAX


def test_regrow_layout_matches_jax_bit_for_bit():
    """FederatedEngine._maybe_regrow on the device (ops/state.regrow_stacked)
    against the JAX regrow (to_host, copy, place): member c's rows move to
    offset c * new_r, the new rows start empty."""
    n, old_r = 3, 16
    rng = np.random.default_rng(17)
    hosts = {}
    for kind in ("nodes", "pods"):
        h = ts.to_numpy(ts.new_row_state(n * old_r, "cpu"))
        h.active[:] = rng.random(n * old_r) < 0.6
        h.phase[:] = rng.integers(0, 3, n * old_r)
        h.cond_bits[:] = rng.integers(0, 2**32, n * old_r, dtype=np.uint64)
        h.sel_bits[:] = rng.integers(0, 2**32, n * old_r, dtype=np.uint64)
        h.has_deletion[:] = rng.random(n * old_r) < 0.2
        h.pending_rule[:] = rng.integers(-1, 4, n * old_r)
        h.fire_at[:] = np.where(rng.random(n * old_r) < 0.5, np.inf,
                                rng.random(n * old_r) * 30).astype(np.float32)
        h.hb_due[:] = (rng.random(n * old_r) * 30).astype(np.float32)
        h.gen[:] = rng.integers(0, 9, n * old_r)
        hosts[kind] = h
    feds = {lib: federation(lib, [FakeKube() for _ in range(n)], initial_capacity=old_r)
            for lib in ("jax", "torch")}
    jg, tg = feds["jax"].groups[0], feds["torch"].groups[0]
    assert jg.r == tg.r == old_r
    for kind, h in hosts.items():
        jg.stacked[kind] = jstate.RowState(
            *(jnp.asarray(getattr(h, f)) for f in jstate.RowState._fields))
        tg.stacked[kind] = ts.from_numpy(h, "cpu")
    for fed in feds.values():
        fed.engines[1]._grow(fed.engines[1].pods)  # one member's pool grows
        fed._maybe_regrow()
    assert jg.r == tg.r > old_r
    for kind in hosts:
        got = ts.to_numpy(tg.stacked[kind])
        for f in ts.RowState._fields:
            ref = np.asarray(getattr(jg.stacked[kind], f))
            np.testing.assert_array_equal(getattr(got, f), ref, err_msg=f"{kind}.{f}")
            assert getattr(got, f).dtype == ref.dtype
    for e in feds["torch"].engines:
        assert e.nodes.capacity == e.pods.capacity == tg.r


def test_shared_epoch_rebase_shifts_every_group():
    fed = federation("torch", [FakeKube(), FakeKube()], member_configs=[
        config("torch"), dataclasses.replace(config("torch"), pod_rules=pod_rules_to("torch", "Baking"))])
    fed._epoch -= REBASE_AFTER + 10.0
    for e in fed.engines:
        e._epoch = fed._epoch
    for g in fed.groups:
        g.stacked["nodes"].hb_due[0] = REBASE_AFTER + 40.0
    fed.tick_once()
    assert all(e._epoch == fed._epoch for e in fed.engines)
    assert fed.metrics["epoch_rebases_total"] == 1
    for g in fed.groups:
        assert abs(float(g.stacked["nodes"].hb_due[0]) - 30.0) < 0.5
        assert g.dispatches == 0  # no rows: empty groups dispatch nothing


# --------------------------------------------------------------- threaded


def test_threaded_federation_end_to_end():
    """Real threads: member watches -> federated drain -> stacked tick ->
    member emits. ``ready`` waits for every member's first re-list; pods
    converge with IPs distinct within a member; members hold no device
    rows; /metrics carries per-shard series and the group counter."""
    servers = [PortFakeKube() for _ in range(2)]
    fed = federation("torch", servers, tick_interval=0.02, initial_capacity=8)
    assert all(e.nodes.state is None and e._stream is None for e in fed.engines)
    assert [e._ckpt_name for e in fed.engines] == ["member0", "member1"]
    fed.start()
    try:
        assert wait_for(lambda: fed.ready)
        assert not fed.startup_resync_pending
        names = {t.name for e in fed.engines for t in e._threads}
        assert {"kwok-watch-nodes-m0", "kwok-watch-pods-m1"} <= names
        for c, s in enumerate(servers):
            s.create("nodes", make_node(f"c{c}-n0"))
            for i in range(20):
                s.create("pods", make_pod(f"c{c}-p{i}", node=f"c{c}-n0",
                                          finalizers=["x/y"] if i < 2 else None))
        assert wait_for(lambda: all(
            s.count("pods", lambda p: p["status"].get("phase") == "Running") == 20
            for s in servers))
        for c, s in enumerate(servers):
            for i in range(2):
                s.delete("pods", "default", f"c{c}-p{i}", grace_seconds=30)
        assert wait_for(lambda: all(s.count("pods") == 18 for s in servers))
        assert wait_for(lambda: fed.metrics["pods_managed"] == 36)
        text = render_metrics(fed)
    finally:
        fed.stop()
    assert not fed._thread.is_alive()
    for s in servers:
        ips = {p["status"]["podIP"] for p in s.list("pods")}
        assert len(ips) == 18
    m = fed.metrics
    assert m["deletes_total"] == 4 and m["patch_errors_total"] == 0
    assert m["pods_managed"] == 36 and fed.cluster_capacity > 8
    for shard in ("0", "1"):
        assert f'kwok_status_patches_total{{shard="{shard}"}}' in text
    assert 'kwok_group_dispatches_total{group="0"}' in text
    assert "kwok_fed_pods_managed 36" in text
    assert text.count("# TYPE kwok_status_patches_total counter") == 1


def test_federation_over_http_converges_on_the_native_drain():
    """Two members over the port's HTTP mocks: the watches queue raw
    lines, each member's drain parses them natively (the parse stage
    moves), and every pod converges."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver

    srvs = [HttpFakeApiserver(store=PortFakeKube()).start() for _ in range(2)]
    fed = federation("torch", [HttpKubeClient(s.url) for s in srvs], tick_interval=0.02)
    assert all(e._batch_parser is not None for e in fed.engines)
    fed.start()
    try:
        assert wait_for(lambda: fed.ready)
        for c, s in enumerate(srvs):
            s.store.create("nodes", make_node(f"h{c}-n0"))
            for i in range(15):
                s.store.create("pods", make_pod(f"h{c}-p{i}", node=f"h{c}-n0"))
        assert wait_for(lambda: all(
            s.store.count("pods", lambda p: p["status"].get("phase") == "Running") == 15
            for s in srvs))
        text = render_metrics(fed)
    finally:
        fed.stop()
        for s in srvs:
            s.stop()
    # one shard="<i>" series per member, as in kwok_tpu's federation
    parse = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
             if ln.startswith("kwok_tick_stage_seconds_count{")
             and 'stage="parse"' in ln]
    assert len(parse) == 2 and all(v > 0 for v in parse), parse
    assert fed.metrics["patch_errors_total"] == 0


def test_idle_federation_stops_dispatching():
    """Once every object has settled and the next device timer is an hour
    away, the loop's gate stops dispatching."""
    servers = [FakeKube(), FakeKube()]
    fed = federation("torch", servers, tick_interval=0.02, heartbeat_interval=3600.0)
    fed.start()
    try:
        for c, s in enumerate(servers):
            s.create("nodes", make_node(f"c{c}-node0"))
            s.create("pods", make_pod(f"c{c}-pod0", node=f"c{c}-node0"))
        assert wait_for(lambda: all(
            (o.get("status") or {}).get("phase") == "Running"
            for s in servers for o in s.list("pods")))
        time.sleep(0.5)
        d0 = sum(g.dispatches for g in fed.groups)
        time.sleep(1.0)
        d1 = sum(g.dispatches for g in fed.groups)
        assert d1 - d0 <= 2, f"idle federation dispatched {d1 - d0} ticks in 1 s"
    finally:
        fed.stop()


# ------------------------------------------------- checkpoints across packages


def stacked_pod_deadlines(lib: str, fed) -> dict:
    """{pod name: fire_at - now} over every member's slice."""
    out = {}
    for g in fed.groups:
        if lib == "jax":
            fire = np.asarray(g.stacked["pods"].fire_at)
        else:
            fire = ts.to_numpy(g.stacked["pods"]).fire_at
        for c, e in enumerate(g.engines):
            now = e._now()
            for (_ns, name), idx in list(e.pods.pool.items()):
                out[name] = float(fire[c * g.r + idx]) - now
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_member_checkpoint_restores_across_packages(writer, reader, tmp_path):
    """Members' pods under a constant 30 s Pending -> Running rule:
    ``writer``'s federation checkpoints them into member<i>.ckpt.json and
    stops; ``reader``'s federation on the same stores and directory
    refines every pod's fire_at to within 0.5 s of its residue."""
    servers = [FakeKube(), FakeKube()]

    def start(lib):
        delay = models(lib)["Delay"].constant(30.0)
        rules = models(lib)["default_pod_rules"](running_delay=delay)
        fed = federation(lib, servers, tick_interval=0.02, pod_rules=rules,
                         checkpoint_dir=str(tmp_path), checkpoint_interval=0.2)
        fed.start()
        return fed

    def covered():
        for c in range(2):
            doc = jckpt.load(str(tmp_path), f"member{c}")
            pods = (doc or {}).get("kinds", {}).get("pods", {})
            if len(pods) != 4 or any(v[2] is None for v in pods.values()):
                return False
        return True

    fed = start(writer)
    try:
        for c, s in enumerate(servers):
            s.create("nodes", make_node(f"c{c}-n0"))
            for i in range(4):
                s.create("pods", make_pod(f"c{c}-p{i}", node=f"c{c}-n0"))
        assert wait_for(covered)
    finally:
        fed.stop()
    residues = {}
    for c in range(2):
        for key, v in jckpt.load(str(tmp_path), f"member{c}")["kinds"]["pods"].items():
            residues[key.split("/", 1)[1]] = v[2]
    assert len(residues) == 8 and all(20.0 < v <= 30.0 for v in residues.values())
    t_stop = time.time()
    fed = start(reader)
    try:
        assert wait_for(lambda: fed.ready and all(e._restore is None for e in fed.engines))
        got = stacked_pod_deadlines(reader, fed)
        elapsed = time.time() - t_stop
    finally:
        fed.stop()
    assert set(got) == set(residues)
    for name, res in residues.items():
        # the reader refined at most ``elapsed`` after the files were read
        assert res - elapsed - 0.5 <= got[name] <= res + 0.5, (name, got[name], res)
    assert all((p.get("status") or {}).get("phase") == "Pending"
               for s in servers for p in s.list("pods"))
