"""The port's row split (kwok_tpu_torch.parallel) against kwok_tpu's mesh
paths on the CPU.

``kwok_tpu`` runs on the 8 virtual CPU devices that tests/conftest.py
forces; the port splits rows into 8 shards of the CPU (a mesh may repeat
a device). Where the port builds its mesh itself (``ClusterEngine`` with
``use_mesh``), ``local_devices`` is patched to name the CPU 8 times, the
counterpart of conftest's ``XLA_FLAGS``. Inputs come from numpy seeds.

- Under the default rules (constant delays, so no draw decides anything)
  the split tick equals ``kwok_tpu``'s single-device ``TickKernel`` and
  its ``ShardedTickKernel`` exactly: phase, cond, pending rule, gen, the
  masks and the counters; the split fused wire equals ``kwok_tpu``'s
  ``MultiTickKernel(mesh=make_mesh(8), pack=True, pack_rows=True)`` byte
  for byte.
- The port's split equals its own unsplit dispatch bit for bit under
  every rule set, the exponential chaos rules included, for 1, 2, 3 and 8
  shards at K=1 and K=16: the kernel hashes the global row id
  (``row_base``). ``kwok_tpu``'s shards fold the shard index into their
  key instead, so there the split changes the draws (ROADMAP §3).
- The state ops across shard boundaries (flush with lane offsets,
  refine, gather, rebase, grow and regrow, which move rows between
  shards) equal the unsplit ones exactly.
- The engine churn of tests/test_sharded.py at 8 shards and >= 128k
  rows; lanes over a split stacked state; a heterogeneous federation
  over 8 shards against ``kwok_tpu``'s over ``make_mesh(8)`` (the same
  requests per key and the same final objects); ``dryrun_multichip``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kwok_tpu.engine import FederatedEngine as JaxFederation
from kwok_tpu.engine.federation import _pad_cluster_capacity as jax_pad_cluster
from kwok_tpu.models import compile_rules as jax_compile_rules
from kwok_tpu.models import default_rules as jax_default_rules
from kwok_tpu.models.lifecycle import ResourceKind as JKind
from kwok_tpu.ops import TickKernel
from kwok_tpu.ops.state import new_row_state as jax_new_row_state
from kwok_tpu.ops.tick import MultiTickKernel as JaxMultiTickKernel
from kwok_tpu.ops.tick import to_host
from kwok_tpu.parallel import ShardedTickKernel as JaxShardedTickKernel
from kwok_tpu.parallel import make_mesh as jax_make_mesh
from kwok_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from kwok_tpu_torch import graft
from kwok_tpu_torch import models as tm
from kwok_tpu_torch.engine import FederatedEngine as TorchFederation
from kwok_tpu_torch.engine import lanes as tlanes
from kwok_tpu_torch.engine.federation import _pad_cluster_capacity
from kwok_tpu_torch.models.defaults import chaos_pod_rules
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops import tick as ttick
from kwok_tpu_torch.ops import updates as tupdates
from kwok_tpu_torch.parallel import ShardedTickKernel, make_mesh
from kwok_tpu_torch.parallel import mesh as tmesh
from kwok_tpu_torch.parallel.mesh import pad_to_multiple
from tests.fake_apiserver import FakeKube
from tests.test_lanes import RecordingKube, _run_script
from tests.test_torch_engine import make_node, make_pod, sync_engine
from tests.test_torch_federation import config, final_objects, groups_of, pod_rules_to
from tests.test_torch_federation import run_script as fed_script
from tests.test_torch_lanes import engine as lanes_engine
from tests.test_torch_tick import engine_specs, engine_states

FIELDS = ("phase", "cond_bits", "pending_rule", "gen")


def cpu_mesh(d: int):
    return make_mesh(devices=["cpu"] * d)


@pytest.fixture
def cpu_shards(monkeypatch):
    """``local_devices`` names the CPU ``n`` times, so an engine's
    ``make_mesh`` splits into ``n`` CPU shards (returns the setter)."""

    def use(n: int) -> None:
        monkeypatch.setattr(tmesh, "local_devices",
                            lambda device="cuda": [torch.device("cpu")] * n)

    return use


# --------------------------------------------------------------------- mesh


def test_mesh_takes_repeated_devices_and_cuts_to_n():
    m = make_mesh(3, devices=["cpu"] * 8)
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3
    assert m.streams == (None,) * 3
    assert tmesh.local_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    if not torch.cuda.is_available():
        # a cuda mesh never falls back to the CPU
        with pytest.raises(RuntimeError):
            make_mesh()


@pytest.mark.parametrize("d", [1, 3, 8])
def test_pad_to_multiple_and_cluster_capacity_match_jax(d):
    jm, tmsh = jax_make_mesh(d), cpu_mesh(d)
    for n in (0, 1, 7, 8, 100, 4095, 131_071):
        assert pad_to_multiple(n, tmsh) == jax_pad_to_multiple(n, jm), n
    for r in (1, 5, 64, 1000):
        for clusters in (1, 2, 3, 8):
            assert _pad_cluster_capacity(r, clusters, d) == jax_pad_cluster(r, clusters, d)


# --------------------------------------------------------- the split tick


def test_sharded_tick_matches_single_device():
    """tests/test_sharded.py's check, the port's 8-shard tick against
    kwok_tpu's single-device TickKernel and its 8-device ShardedTickKernel
    (default rules: exact)."""
    jtable = jax_compile_rules(jax_default_rules(), JKind.POD)
    ttable = tm.compile_rules(tm.default_rules(), tm.ResourceKind.POD)
    tm8 = cpu_mesh(8)
    n = pad_to_multiple(100, tm8)
    state = jax_new_row_state(n)
    rng = np.random.default_rng(0)
    state.active[:100] = True
    state.phase[:100] = rng.integers(0, 2, 100)
    state.sel_bits[:100] = rng.integers(0, 4, 100)
    state.has_deletion[:100] = rng.random(100) < 0.2

    single = to_host(TickKernel(jtable)(state, 0.0))
    jsh = JaxShardedTickKernel(jtable, mesh=jax_make_mesh(8))
    sharded = to_host(jsh(jsh.place(state), 0.0))
    kern = ShardedTickKernel(ttable, mesh=tm8)
    split = kern.place(state)
    out = kern(split, 0.0)
    got = ts.to_numpy(split)
    for ref in (single, sharded):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref.state, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(out.dirty.numpy(), ref.dirty)
        np.testing.assert_array_equal(out.deleted.numpy(), ref.deleted)
        assert int(out.transitions) == int(ref.transitions)
    assert int(out.transitions) > 0


def test_sharded_tick_counts_global_transitions():
    jtable = jax_compile_rules(jax_default_rules(), JKind.NODE)
    ttable = tm.compile_rules(tm.default_rules(), tm.ResourceKind.NODE)
    n = pad_to_multiple(4096, cpu_mesh(8))
    state = jax_new_row_state(n)
    state.active[:4000] = True
    state.sel_bits[:4000] = 1
    jk = JaxShardedTickKernel(jtable, hb_phases=("Ready",))
    tk = ShardedTickKernel(ttable, mesh=cpu_mesh(8), hb_phases=("Ready",))
    assert int(to_host(jk(jk.place(state), 0.0)).transitions) == 4000
    assert int(tk(tk.place(state), 0.0).transitions) == 4000


@pytest.mark.parametrize("caps", [(1000, 1000), (104, 4096)])
def test_split_wire_matches_jax_mesh_wire(caps):
    """The fused pack_rows wire over 8 shards, byte for byte against
    kwok_tpu's shard_map'd MultiTickKernel over make_mesh(8), three
    dispatches (the default node and pod rules are constant)."""
    jk = JaxMultiTickKernel(engine_specs("jax"), mesh=jax_make_mesh(8), pack=True,
                            pack_rows=True, steps=4, dt=0.05)
    tk = ttick.MultiTickKernel(engine_specs("torch"), steps=4, dt=0.05, mesh=cpu_mesh(8))
    jstates = tuple(jk.place(s) for s in engine_states(*caps))
    tstates = tuple(tk.place(s) for s in engine_states(*caps))
    assert all(isinstance(s, ts.SplitState) and s.rows * 8 == c
               for s, c in zip(tstates, caps))
    now = 0.0
    for _ in range(3):
        jouts, jwire = jk(jstates, now)
        jstates = tuple(o.state for o in jouts)
        _touts, twire = tk(tstates, now)
        np.testing.assert_array_equal(np.asarray(twire), np.asarray(jwire))
        now += 1.7
    counters = ttick.unpack_wire(np.asarray(twire), list(caps))[0]
    assert int(counters.sum()) > 0


def chaos_specs():
    nt = tm.compile_rules(tm.default_node_rules(), tm.ResourceKind.NODE)
    pt = tm.compile_rules(chaos_pod_rules(mean_run_seconds=1.0), tm.ResourceKind.POD)
    return [(nt, 2.0, (), 1), (pt, 2.0, (), -1)]


def chaos_states(cap: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        s = jax_new_row_state(cap)
        live = cap - cap // 9
        s.active[:live] = True
        s.sel_bits[:] = rng.integers(0, 4, cap).astype(np.uint32)
        s.has_deletion[:] = rng.random(cap) < 0.1
        out.append(s)
    return out


@pytest.mark.parametrize("steps", [1, 16])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_split_equals_unsplit_bit_for_bit(shards, steps):
    """The split draws by global row id: under the exponential chaos
    rules its wires and states equal the unsplit dispatch's exactly
    (tolerance 0), dispatch after dispatch."""
    mesh = cpu_mesh(shards)
    cap = pad_to_multiple(1001, mesh)
    one = ttick.MultiTickKernel(chaos_specs(), steps=steps, dt=0.05, device="cpu")
    split = ttick.MultiTickKernel(chaos_specs(), steps=steps, dt=0.05, mesh=mesh)
    a = [ts.from_numpy(s, "cpu") for s in chaos_states(cap)]
    b = [split.place(s) for s in chaos_states(cap)]
    fired = 0
    for n in range(5):
        _oa, wa = one(a, 0.4 * n)
        ob, wb = split(b, 0.4 * n)
        assert np.asarray(wb).tobytes() == np.asarray(wa).tobytes(), n
        fired += int(ob[1].transitions)
    for x, y in zip(a, b):
        hx, hy = ts.to_numpy(x), ts.to_numpy(y)
        for f in ts.RowState._fields:
            np.testing.assert_array_equal(getattr(hy, f), getattr(hx, f), err_msg=f)
    assert fired > 0


@pytest.mark.parametrize("shards,rows", [(1, 7), (2, 9), (3, 257), (8, 1), (8, 13)])
def test_owned_ranges_cover_the_rows_and_whole_mask_bytes(shards, rows):
    """A shard on another card copies these ranges of its own wire-shaped
    buffer to the first card: its phase and cond rows and the mask bytes
    wholly inside one of its three runs. Across the shards they are
    disjoint, cover every row byte of the kind, and leave out exactly the
    mask bytes that hold bits of two runs or padding (those the epilogue
    rebuilds from the shards' records)."""
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.parallel.sharded_tick import _owned_ranges

    total = shards * rows
    layout = cuda_tick.wire_layout([5, total])  # a kind before: no offset is 0
    k = 1
    owner = {}
    for i in range(shards):
        for lo, hi in _owned_ranges(layout, k, i * rows, rows):
            for b in range(lo, hi):
                assert b not in owner, b
                owner[b] = i
    phase, cond = layout.phase_offs[k], layout.cond_offs[k]
    for b in range(phase, cond + 4 * total):
        row = b - phase if b < cond else (b - cond) // 4
        assert owner.pop(b) == row // rows, b
    for j in range((3 * total + 7) // 8):
        runs = {(bit // total, bit % total // rows) if bit < 3 * total else None
                for bit in range(8 * j, 8 * j + 8)}
        whole = len(runs) == 1 and None not in runs
        got = owner.pop(layout.mask_offs[k] + j, None)
        assert (got is not None) == whole, j
        if whole:
            assert got == next(iter(runs))[1], j
    assert not owner  # nothing outside the kind's masks and rows


# ------------------------------------------------ state ops across shards


def both(host, mesh):
    """(unsplit CPU state, split state) of one numpy state."""
    return ts.from_numpy(host, "cpu"), ts.split_rows(host, mesh)


def assert_same(a, b):
    ha, hb = ts.to_numpy(a), ts.to_numpy(b)
    for f in ts.RowState._fields:
        np.testing.assert_array_equal(getattr(hb, f), getattr(ha, f), err_msg=f)


def test_state_ops_across_shard_boundaries():
    """Flush with lane offsets that straddle shards, refine, gather,
    rebase, grow and the stacked regrow (rows move between shards):
    split == unsplit exactly."""
    n_lanes, r, d = 4, 21, 3  # 84 rows: lanes of 21 over shards of 28
    mesh = cpu_mesh(d)
    host = chaos_states(n_lanes * r, seed=5)[0]
    host.fire_at[:] = np.random.default_rng(1).random(n_lanes * r).astype(np.float32) * 9
    one, split = both(host, mesh)
    rng = np.random.default_rng(2)
    for li in range(n_lanes):
        for state_is_split in (False, True):
            buf = tupdates.UpdateBuffer()
            local = np.random.default_rng(100 + li)
            for i in local.integers(-1, r + 2, 8):  # out-of-lane rows dropped
                buf.stage_init(int(i), True, phase=int(local.integers(0, 3)),
                               sel_bits=int(local.integers(0, 4)))
            for i in local.integers(0, r, 3):
                buf.stage_update(int(i), 3, True)
            if state_is_split:
                split = buf.flush(split, offset=li * r, rows=r)
            else:
                one = buf.flush(one, offset=li * r, rows=r)
    assert_same(one, split)
    idx = rng.integers(0, r, 10)
    fire = rng.random(10).astype(np.float32)
    for li in range(n_lanes):
        one = tupdates.refine_flush(one, idx, fire, fire + 1, idx.astype(np.int32),
                                    offset=li * r, rows=r)
        split = tupdates.refine_flush(split, idx, fire, fire + 1, idx.astype(np.int32),
                                      offset=li * r, rows=r)
    assert_same(one, split)
    for a, b in zip(ttick.gather_deadlines(one), ttick.gather_deadlines(split)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(ts.field_numpy(split, "fire_at"),
                                  ts.field_numpy(one, "fire_at"))
    one, split = ttick.rebase_times(one, 3.5), ttick.rebase_times(split, 3.5)
    assert_same(one, split)
    # a grow moves rows between shards: 84 -> 120 rows, shards of 40
    g1, g2 = ts.grow(one, 120), ts.grow(split, pad_to_multiple(120, mesh))
    assert isinstance(g2, ts.SplitState) and g2.rows == 40
    assert_same(g1, g2)
    # the lanes' regrow: lane i's rows move from i*21 to i*30
    s1, s2 = ts.regrow_stacked(one, n_lanes, 30), ts.regrow_stacked(split, n_lanes, 30)
    assert isinstance(s2, ts.SplitState) and s2.capacity == 120
    assert_same(s1, s2)
    assert ts.to_numpy(s2).active[30:51].tolist() == ts.to_numpy(split).active[21:42].tolist()


def test_split_capacity_must_divide():
    with pytest.raises(ValueError):
        ts.new_split_state(10, cpu_mesh(3))
    with pytest.raises(TypeError):
        ttick.MultiTickKernel(chaos_specs(), mesh=cpu_mesh(2))(
            [ts.new_row_state(8, "cpu")] * 2, 0.0)


# ------------------------------------------------------------------ engines


def churn(eng, server) -> list:
    """tests/test_sharded.py's churn script; the Running count after each
    stage and the pool's size after the deletes."""
    out = []
    n_nodes, n_pods = 256, 4096

    def running():
        return sum(1 for p in server.list("pods")
                   if (p.get("status") or {}).get("phase") == "Running")

    for i in range(n_nodes):
        server.create("nodes", make_node(f"sn-{i}"))
    for i in range(n_pods):
        server.create("pods", make_pod(f"sp-{i}", node=f"sn-{i % n_nodes}"))
    eng.feed_all(server)
    eng.pump(3)
    out.append(running())
    w = server.watch("pods", field_selector="spec.nodeName!=")
    for i in range(1024):
        server.delete("pods", "default", f"sp-{i}", grace_seconds=0)
    while not w.q.empty():
        ev = w.q.get_nowait()
        if ev:
            eng._q.put(("pods", ev.type, ev.object))
    w.stop()
    eng.pump(3)
    out.append((len(server.list("pods")), len(eng.pods.pool)))
    for i in range(n_pods, n_pods + 2048):
        server.create("pods", make_pod(f"sp-{i}", node=f"sn-{i % n_nodes}"))
    eng.feed_all(server)
    eng.pump(3)
    out.append(running())
    return out


def test_sharded_engine_churn_at_scale(cpu_shards):
    """The engine with use_mesh at 8 shards and >= 128k rows: creates,
    1,024 grace-0 deletes, 2,048 creates reusing freed rows, as
    kwok_tpu's 8-device engine counts them."""
    cpu_shards(8)
    runs = {}
    for lib in ("jax", "torch"):
        server = FakeKube()
        eng = sync_engine(lib, server, manage_all_nodes=True, tick_interval=0.01,
                          heartbeat_interval=3600.0, use_mesh=True,
                          initial_capacity=120_000)
        assert eng.pods.capacity % 8 == 0 and eng.pods.capacity >= 120_000
        if lib == "torch":
            assert isinstance(eng.pods.state, ts.SplitState)
            assert eng.pods.state.mesh.size == 8
        runs[lib] = churn(eng, server)
    assert runs["torch"] == runs["jax"] == [4096, (3072, 3072), 3072 + 2048]


def test_lanes_over_a_split_stacked_state(cpu_shards, monkeypatch):
    """Threaded lanes (synchronous ticks) over a stacked state split into
    3 CPU shards, lanes straddling shards and a regrow on the way: every
    request and final object as the unsplit lanes give them."""
    keys = [("default", f"op{i}") for i in range(40)]
    cpu_shards(3)
    monkeypatch.setattr(tlanes, "_MIN_LANE_ROWS", 8)  # 4 lanes of 8 rows
    runs = {}
    for mesh_on in (False, True):
        rec = RecordingKube()
        eng = lanes_engine("torch", rec, drain_shards=4, use_mesh=mesh_on,
                           initial_capacity=16)
        r0 = eng._lanes.r
        _run_script(eng, rec, keys)
        assert eng._lanes.r > r0  # the lanes regrew
        if mesh_on:
            st = eng._lanes.stacked["pods"]
            assert isinstance(st, ts.SplitState) and st.mesh.size == 3
            assert r0 % 3 == 0 and eng._lanes.r % 3 == 0
        runs[mesh_on] = rec
    for key in keys:
        assert runs[True].per_key(key) == runs[False].per_key(key), key
        assert ("patch", "Running") in runs[True].per_key(key)
    assert final_objects(runs[True].inner) == final_objects(runs[False].inner)


@pytest.mark.parametrize("name", ["heterogeneous", "regrow"])
def test_federation_over_8_shards_matches_jax_mesh(name):
    """A federation whose groups' stacked states split over 8 CPU shards
    sends, member by member, the requests kwok_tpu's federation over
    make_mesh(8) sends, and leaves the same objects."""
    members, pods, kw, phases = {
        "heterogeneous": (3, 3, {"initial_capacity": 16}, [None, "Succeeded", None]),
        "regrow": (2, 12, {"initial_capacity": 4}, None),
    }[name]
    runs = {}
    for lib in ("jax", "torch"):
        servers = [RecordingKube() for _ in range(members)]
        cfgs = None
        if phases is not None:
            base = config(lib, **kw)
            cfgs = [base if ph is None else dataclasses.replace(base, pod_rules=pod_rules_to(lib, ph))
                    for ph in phases]
        if lib == "jax":
            fed = JaxFederation(servers, config("jax", **kw), mesh=jax_make_mesh(8),
                                member_configs=cfgs)
        else:
            fed = TorchFederation(servers, config("torch", **kw), mesh=cpu_mesh(8),
                                  member_configs=cfgs)
            assert all(st.mesh.size == 8 for g in fed.groups for st in g.stacked.values())
        r0 = fed.cluster_capacity
        fed_script(fed, servers, pods)
        runs[lib] = (fed, servers, r0)
    (jfed, jservers, jr0), (tfed, tservers, tr0) = runs["jax"], runs["torch"]
    assert groups_of(tfed) == groups_of(jfed)
    assert (tr0, tfed.cluster_capacity) == (jr0, jfed.cluster_capacity)
    for c, (got, ref) in enumerate(zip(tservers, jservers)):
        keys = {k for k, _op, _ph in ref.log}
        assert {k for k, _op, _ph in got.log} == keys, c
        for key in keys:
            assert got.per_key(key) == ref.per_key(key), (c, key)
        assert final_objects(got.inner) == final_objects(ref.inner), c
    if name == "regrow":
        assert tfed.cluster_capacity > tr0


def test_dryrun_multichip_on_8_cpu_shards():
    got = graft.dryrun_multichip(8, device="cpu")
    assert got["shards"] == ["cpu"] * 8 and got["rows"] == 131_072
    assert got["node_transitions"] == 65_536
    assert got["pod_transitions"] == 65_536 + 2048
    assert got["post_growth_pod_transitions"] >= 512
    # every pod of both members reached Running (member 1's chaos rules
    # may already have moved some on to Succeeded)
    assert got["federation_groups"] == 2 and got["federation_running"] == [4, 4]
