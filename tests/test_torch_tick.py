"""The port's tick (kwok_tpu_torch.ops.cuda_tick / ops.tick) against the JAX
package on the CPU.

On a CPU tensor the wrapper runs the kernel's plain torch version, so these
tests pin the arithmetic the CUDA kernel repeats (chip_smoke.py holds the
kernel to the plain version on the card):

- ``tick_steps`` vs ``PallasTickKernel(interpret=True)`` under the same seed
  schedule (dispatch n draws from 0x5EEDC0DE + n): bit-exact for constant,
  uniform-free and weighted rule sets; exponential delays (``chaos_pod_rules``)
  go through ``log``, which may differ by an ulp between XLA and torch, so
  fire_at is held to rtol 1e-6 and phase mismatches to 1e-3 of the rows;
- the port's ``MultiTickKernel`` vs ``kwok_tpu``'s XLA ``MultiTickKernel``
  under constant rules at the engine's non-dyadic dt=0.05 (exact), and its
  wire bytes vs ``MultiTickKernel(pack=True, pack_rows=True)`` (exact).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kwok_tpu.models import compile_rules as jax_compile_rules
from kwok_tpu.models import default_rules as jax_default_rules
from kwok_tpu.models.defaults import chaos_pod_rules as jax_chaos_pod_rules
from kwok_tpu.models.lifecycle import Delay as JDelay
from kwok_tpu.models.lifecycle import LifecycleRule as JRule
from kwok_tpu.models.lifecycle import ResourceKind as JKind
from kwok_tpu.models.lifecycle import StatusEffect as JEffect
from kwok_tpu.ops.pallas_tick import PallasTickKernel
from kwok_tpu.ops.state import new_row_state as jax_new_row_state
from kwok_tpu.ops.tick import MultiTickKernel as JaxMultiTickKernel
from kwok_tpu.ops.tick import to_host, unpack_wire as jax_unpack_wire
from kwok_tpu_torch import models as tm
from kwok_tpu_torch.models.defaults import chaos_pod_rules
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops.tick import MultiTickKernel, unpack_wire

FIELDS = ("phase", "cond_bits", "pending_rule", "fire_at", "hb_due", "gen")


def cyclic_rules(lib: str, delay=1.0):
    """The test_pallas_tick cyclic set, built from the JAX package's model
    classes ("jax") or the port's copies (so each side compiles its own)."""
    if lib == "jax":
        R, D, E, K = JRule, JDelay, JEffect, JKind
    else:
        R, D, E, K = tm.LifecycleRule, tm.Delay, tm.StatusEffect, tm.ResourceKind
    return [
        R(name="up", resource=K.POD, from_phases=("Pending",), selector="managed",
          delay=D.constant(delay),
          effect=E(to_phase="Running", conditions={"Ready": True})),
        R(name="done", resource=K.POD, from_phases=("Running",), selector="managed",
          delay=D.constant(2 * delay),
          effect=E(to_phase="Succeeded", conditions={"Ready": False})),
    ]


def weighted_rules(lib: str, weights, delay=0.0):
    if lib == "jax":
        R, D, E, K = JRule, JDelay, JEffect, JKind
    else:
        R, D, E, K = tm.LifecycleRule, tm.Delay, tm.StatusEffect, tm.ResourceKind
    to = ["Running", "Succeeded", "Failed", "Terminating"]
    return [
        R(name=f"w{i}", resource=K.POD, from_phases=("Pending",),
          effect=E(to_phase=to[i]), delay=D.constant(delay), weight=w)
        for i, w in enumerate(weights)
    ]


def rule_pair(kind: str):
    """(jax table, port table) for a named pod rule set."""
    if kind == "cyclic":
        return (jax_compile_rules(cyclic_rules("jax", 0.4), JKind.POD),
                tm.compile_rules(cyclic_rules("torch", 0.4), tm.ResourceKind.POD))
    if kind == "default":
        return (jax_compile_rules(jax_default_rules(), JKind.POD),
                tm.compile_rules(tm.default_rules(), tm.ResourceKind.POD))
    if kind == "chaos":
        return (jax_compile_rules(jax_chaos_pod_rules(1.0), JKind.POD),
                tm.compile_rules(chaos_pod_rules(1.0), tm.ResourceKind.POD))
    raise KeyError(kind)


def seeded(cap, frac=1.0, seed=42, deletion=0.1):
    """A numpy (JAX-layout) pod population made from a seed."""
    rng = np.random.default_rng(seed)
    s = jax_new_row_state(cap)
    n = int(cap * frac)
    s.active[:n] = True
    s.sel_bits[:n] = 0b11
    s.has_deletion[:] = rng.random(cap) < deletion
    return s


def run_pallas(table, state, nows, steps, dt, hb_interval, hb_sel_bit):
    pk = PallasTickKernel(
        table, hb_interval=hb_interval, hb_sel_bit=hb_sel_bit, steps=steps,
        dt=dt, interpret=True,
    )
    outs = []
    for now in nows:
        out = to_host(pk(state, now))
        state = out.state
        outs.append(out)
    return outs


def run_port(table, state_np, nows, steps, dt, hb_interval, hb_sel_bit):
    spec = cuda_tick.TickSpec(table, hb_interval, (), hb_sel_bit)
    st = ts.from_numpy(state_np, "cpu")
    outs = []
    for n, now in enumerate(nows, start=1):
        dirty, deleted, hb, counts = cuda_tick.tick_steps(
            st, spec, now, cuda_tick.SEED_BASE + n, steps, dt
        )
        outs.append((ts.to_numpy(st), dirty.numpy(), deleted.numpy(),
                     hb.numpy(), counts.numpy()))
    return outs


def assert_exact(pallas_outs, port_outs):
    for p, (st, dirty, deleted, hb, counts) in zip(pallas_outs, port_outs):
        for f in FIELDS:
            a = np.asarray(getattr(p.state, f))
            b = getattr(st, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        np.testing.assert_array_equal(dirty, p.dirty)
        np.testing.assert_array_equal(deleted, p.deleted)
        np.testing.assert_array_equal(hb, p.hb_fired)
        assert int(counts[0]) == int(p.transitions)
        assert int(counts[1]) == int(p.heartbeats)


@pytest.mark.parametrize("steps,dt", [(1, 0.05), (6, 0.5), (12, 0.25), (16, 0.05)])
def test_plain_matches_pallas_cyclic(steps, dt):
    jt, tt = rule_pair("cyclic")
    nows = [0.0, 0.45 + steps * dt, 1.3 + 2 * steps * dt]
    p = run_pallas(jt, seeded(2048), nows, steps, dt, 5.0, 1)
    q = run_port(tt, seeded(2048), nows, steps, dt, 5.0, 1)
    assert sum(int(o.transitions) for o in p) > 0
    assert_exact(p, q)


@pytest.mark.parametrize("steps,dt", [(4, 0.5), (16, 0.05)])
def test_plain_matches_pallas_default_with_deletion(steps, dt):
    jt, tt = rule_pair("default")
    nows = [0.3, 0.3 + steps * dt]
    p = run_pallas(jt, seeded(2048, deletion=0.3), nows, steps, dt, 30.0, -1)
    q = run_port(tt, seeded(2048, deletion=0.3), nows, steps, dt, 30.0, -1)
    assert int(p[0].deleted.sum()) > 0
    assert_exact(p, q)


def test_plain_matches_pallas_partial_activity_two_dispatches():
    jt, tt = rule_pair("cyclic")
    nows = [0.0, 2.5]
    p = run_pallas(jt, seeded(2048, frac=0.5), nows, 5, 0.5, 2.0, 1)
    q = run_port(tt, seeded(2048, frac=0.5), nows, 5, 0.5, 2.0, 1)
    assert_exact(p, q)
    st = q[-1][0]
    assert (st.phase[1024:] == 0).all() and not q[-1][1][1024:].any()


@pytest.mark.parametrize(
    "weights,delay,nows",
    [
        ([1, 3], 0.0, [0.0]),
        ([2, 0, 6], 0.0, [0.0]),
        ([0, 5], 0.0, [0.0]),
        # sticky armed choice across quiet dispatches
        ([1, 1], 100.0, [0.0, 1.0, 2.0, 3.0]),
        ([1, 2, 3, 4], 0.25, [0.0, 0.6]),
    ],
)
def test_plain_matches_pallas_weighted(weights, delay, nows):
    jt = jax_compile_rules(weighted_rules("jax", weights, delay), JKind.POD)
    tt = tm.compile_rules(weighted_rules("torch", weights, delay), tm.ResourceKind.POD)
    steps, dt = 3, 0.05
    p = run_pallas(jt, seeded(4096, deletion=0.0), nows, steps, dt, 30.0, -1)
    q = run_port(tt, seeded(4096, deletion=0.0), nows, steps, dt, 30.0, -1)
    assert_exact(p, q)


@pytest.mark.parametrize("steps", [1, 16])
def test_plain_matches_pallas_exponential(steps):
    """chaos_pod_rules: Exp(1 s) completions after Running. log() may
    differ by an ulp between XLA and torch: fire_at to rtol 1e-6, phase
    (and the masks) may differ in at most 1e-3 of the rows."""
    jt, tt = rule_pair("chaos")
    dt = 0.05
    nows = [0.0, steps * dt, 2 * steps * dt, 1.0]
    cap = 8192
    p = run_pallas(jt, seeded(cap), nows, steps, dt, 30.0, -1)
    q = run_port(tt, seeded(cap), nows, steps, dt, 30.0, -1)
    fired = 0
    for o, (st, dirty, deleted, hb, counts) in zip(p, q):
        np.testing.assert_allclose(st.fire_at, np.asarray(o.state.fire_at), rtol=1e-6)
        assert (st.phase != np.asarray(o.state.phase)).sum() <= 1e-3 * cap
        assert (dirty != o.dirty).sum() <= 1e-3 * cap
        assert (deleted != o.deleted).sum() <= 1e-3 * cap
        assert abs(int(counts[0]) - int(o.transitions)) <= 1e-3 * cap
        fired += int(o.transitions)
    assert fired > cap  # Running, then some completions


def test_uniform01_matches_pallas_hash():
    """The plain version's int64 hash equals the Pallas uint32 hash."""
    import jax.numpy as jnp

    from kwok_tpu.ops.pallas_tick import _uniform01 as jax_u

    gid = np.arange(0, 1 << 20, 997, dtype=np.uint32)
    for step, seed in [(0, 0x5EEDC0DE + 1), (7, 0xFFFFFFFF), (123, 0x55AA55AA)]:
        want = np.asarray(jax_u(jnp.asarray(gid), jnp.uint32(step), jnp.uint32(seed)))
        got = cuda_tick._uniform01(torch.from_numpy(gid.astype(np.int64)), step, seed)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- fused dispatch


def engine_specs(lib: str):
    if lib == "jax":
        from kwok_tpu.models import default_node_rules, default_pod_rules

        nt = jax_compile_rules(default_node_rules(), JKind.NODE)
        pt = jax_compile_rules(default_pod_rules(), JKind.POD)
    else:
        nt = tm.compile_rules(tm.default_node_rules(), tm.ResourceKind.NODE)
        pt = tm.compile_rules(tm.default_pod_rules(), tm.ResourceKind.POD)
    # heartbeat on node selector bit 1, 2 s interval
    return [(nt, 2.0, (), 1), (pt, 2.0, (), -1)]


def engine_states(cap_nodes, cap_pods):
    rng = np.random.default_rng(7)
    n = jax_new_row_state(cap_nodes)
    n.active[: cap_nodes - 3] = True
    n.sel_bits[:] = rng.integers(0, 4, cap_nodes).astype(np.uint32)
    p = jax_new_row_state(cap_pods)
    p.active[: cap_pods - 5] = True
    p.sel_bits[:] = rng.integers(0, 4, cap_pods).astype(np.uint32)
    p.has_deletion[:] = rng.random(cap_pods) < 0.2
    return n, p


@pytest.mark.parametrize("steps", [1, 6, 20])
def test_multitick_matches_xla(steps):
    dt = 0.05
    caps = (512, 2048)
    jk = JaxMultiTickKernel(engine_specs("jax"), pack=True, pack_rows=True,
                            steps=steps, dt=dt)
    tk = MultiTickKernel(engine_specs("torch"), steps=steps, dt=dt, device="cpu")
    jstates = engine_states(*caps)
    tstates = tuple(ts.from_numpy(s, "cpu") for s in engine_states(*caps))
    now = 0.0
    for _ in range(3):
        jouts, jwire = jk(jstates, now)
        touts, twire = tk(tstates, now)
        jstates = tuple(o.state for o in jouts)
        for jo, to in zip(jouts, touts):
            jh = to_host(jo)
            th = ts.to_numpy(to.state)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(th, f), np.asarray(getattr(jh.state, f)), err_msg=f)
            np.testing.assert_array_equal(to.dirty.numpy(), jh.dirty)
            np.testing.assert_array_equal(to.deleted.numpy(), jh.deleted)
            np.testing.assert_array_equal(to.hb_fired.numpy(), jh.hb_fired)
            assert int(to.transitions) == int(jh.transitions)
            assert int(to.heartbeats) == int(jh.heartbeats)
        np.testing.assert_array_equal(np.asarray(twire), np.asarray(jwire))
        now += 1.7


@pytest.mark.parametrize("caps", [(1001, 1001), (13, 4099)])
def test_wire_bytes_match_pack_rows(caps):
    """Non-byte-aligned capacities: `deleted` starts at bit cap."""
    jk = JaxMultiTickKernel(engine_specs("jax"), pack=True, pack_rows=True,
                            steps=4, dt=0.05)
    tk = MultiTickKernel(engine_specs("torch"), steps=4, dt=0.05, device="cpu")
    jouts, jwire = jk(engine_states(*caps), 0.0)
    touts, twire = tk(tuple(ts.from_numpy(s, "cpu") for s in engine_states(*caps)), 0.0)
    jb = np.asarray(jwire)
    tb = np.asarray(twire)
    assert tb.dtype == np.uint8 and tb.shape == jb.shape
    np.testing.assert_array_equal(tb, jb)
    # and the port's copy of unpack_wire reads it like the JAX one
    tc, tmasks, tdues, trows = unpack_wire(tb, list(caps), rows=True)
    jc, jmasks, jdues, jrows = jax_unpack_wire(jb, list(caps), rows=True)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tdues, jdues)
    for a, b in zip(tmasks(), jmasks()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert int(tc.sum()) > 0


def test_wire_handle_is_ready_on_cpu():
    tk = MultiTickKernel(engine_specs("torch"), device="cpu")
    states = tuple(tk.place(ts.from_numpy(s, "cpu")) for s in engine_states(64, 64))
    assert all(st.device == torch.device("cpu") for st in states)
    _, wire = tk(states, 0.0)
    assert wire.is_ready()
    assert np.asarray(wire).dtype == np.uint8


# ------------------------------------------------------------- the wrapper


def test_wrapper_checks_layout():
    tt = tm.compile_rules(tm.default_pod_rules(), tm.ResourceKind.POD)
    spec = cuda_tick.TickSpec(tt)
    st = ts.new_row_state(64, "cpu")
    with pytest.raises(TypeError):
        cuda_tick.tick_steps(st._replace(phase=st.phase.to(torch.int64)), spec, 0.0, 1, 1, 0.0)
    with pytest.raises(ValueError):
        cuda_tick.tick_steps(st._replace(gen=torch.zeros(65, dtype=torch.int32)), spec, 0.0, 1, 1, 0.0)
    with pytest.raises(ValueError):
        strided = torch.zeros(128, dtype=torch.float32)[::2]
        cuda_tick.tick_steps(st._replace(fire_at=strided), spec, 0.0, 1, 1, 0.0)
    before = cuda_tick.tick_steps.launches
    cuda_tick.tick_steps(st, spec, 0.0, 1, 1, 0.0)
    assert cuda_tick.tick_steps.launches == before  # CPU: plain version


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: where the CUDA toolkit is missing the build raises."""
    monkeypatch.setattr(cuda_tick, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(cuda_tick.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_tick.TickSteps().library()
