"""The graft twin (kwok_tpu_torch.graft) against the JAX package on the CPU.

- ``entry(device="cpu")`` builds ``__graft_entry__.entry()``'s workload:
  65,536 active managed pod rows, the chaos rules at a 5 s mean run, the
  30 s heartbeat wheel with no phases and selector bit -1, K=1.
- At 4,096 rows (a reduced count, so the interpreted Pallas kernel stays
  quick here), three dispatches of the twin's step are held against
  ``PallasTickKernel(interpret=True)`` under the same seeds: every field
  and mask bit for bit, except ``fire_at`` under the exponential delays,
  which goes through ``log``: a delay one ulp off, which the addition to
  ``now`` makes at most two float32 steps in ``fire_at``, on at most 10%
  of the re-armed rows (the divergence ROADMAP §3 pins for the tick).
- Against ``__graft_entry__.entry()``'s own step (``tick_body`` on its
  example state) over two dispatches: every field the draw does not
  reach is equal. ``fire_at`` of the rows armed with the exponential
  delay differs, because ``tick_body`` draws from a threefry key and the
  port's kernel from its counter hash; the test pins that the same rows
  are armed and that both delays are finite and positive.
- On a CUDA device without a card, ``entry()`` raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import __graft_entry__ as graft_ref
from kwok_tpu.models import compile_rules as jax_compile_rules
from kwok_tpu.models.defaults import chaos_pod_rules as jax_chaos_pod_rules
from kwok_tpu.models.lifecycle import ResourceKind as JKind
from kwok_tpu.ops.pallas_tick import PallasTickKernel
from kwok_tpu.ops.tick import to_host
from kwok_tpu_torch import graft
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops import state as ts

FIELDS = ("phase", "cond_bits", "pending_rule", "hb_due", "gen", "active",
          "sel_bits", "has_deletion")
REDUCED_ROWS = 4096
NOWS = (0.0, 1.0, 6.0)


def port_run(rows, nows):
    step, state, seed = graft.GraftStep(), graft.seeded_pod_state(rows, "cpu"), graft.SEED
    outs = []
    for n, now in enumerate(nows):
        dirty, deleted, hb, counts = step(state, now, seed + n)
        outs.append((ts.to_numpy(state), dirty.numpy().copy(), deleted.numpy().copy(),
                     hb.numpy().copy(), counts.numpy().copy()))
    return outs


def test_entry_builds_the_reference_workload():
    step, (state, now, seed) = graft.entry(device="cpu")
    ref_step, (ref_state, ref_now, _key) = graft_ref.entry()
    assert state.capacity == graft.ROWS == ref_state.active.shape[0] == 65536
    host = ts.to_numpy(state)
    for f in ("active", "sel_bits", "has_deletion", "phase", "cond_bits",
              "pending_rule", "fire_at", "hb_due", "gen"):
        np.testing.assert_array_equal(getattr(host, f), np.asarray(getattr(ref_state, f)),
                                      err_msg=f)
    assert now == float(ref_now) and seed == cuda_tick.SEED_BASE + 1
    spec = step.spec
    assert (spec.hb_interval, spec.hb_phase_mask, spec.hb_sel_bit) == (30.0, 0, -1)
    jt = jax_compile_rules(jax_chaos_pod_rules(mean_run_seconds=5.0), JKind.POD)
    assert spec.num_rules == int(jt.num_rules)
    for name in ("from_mask", "delay_kind", "delay_a", "delay_b", "to_phase",
                 "weight", "is_delete"):
        np.testing.assert_array_equal(np.asarray(getattr(spec.table, name)),
                                      np.asarray(getattr(jt, name)), err_msg=name)


def test_step_matches_pallas_interpret_bit_for_bit():
    jt = jax_compile_rules(jax_chaos_pod_rules(mean_run_seconds=5.0), JKind.POD)
    pk = PallasTickKernel(jt, hb_interval=30.0, hb_sel_bit=-1, steps=1, dt=0.0,
                          interpret=True)
    ref_state = graft_ref._seeded_pod_state(REDUCED_ROWS, np)
    port = port_run(REDUCED_ROWS, NOWS)
    rearmed = 0
    for now, (st, dirty, deleted, hb, counts) in zip(NOWS, port):
        out = to_host(pk(ref_state, now))
        ref_state = out.state
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(st, f), np.asarray(getattr(out.state, f)),
                                          err_msg=f"{f} at now={now}")
        np.testing.assert_array_equal(dirty, out.dirty)
        np.testing.assert_array_equal(deleted, out.deleted)
        np.testing.assert_array_equal(hb, out.hb_fired)
        assert int(counts[0]) == int(out.transitions)
        assert int(counts[1]) == int(out.heartbeats)
        want = np.asarray(out.state.fire_at)
        armed = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(st.fire_at), armed)
        # float32 steps apart (positive values: adjacent floats have
        # adjacent int32 bit patterns). log() is one ulp off in the delay,
        # and adding it to now rounds that to at most two steps
        steps_apart = np.abs(st.fire_at[armed].view(np.int32).astype(np.int64)
                             - want[armed].view(np.int32).astype(np.int64))
        assert steps_apart.max(initial=0) <= 2
        assert (steps_apart > 0).sum() <= 0.10 * max(1, armed.sum())
        rearmed += int(armed.sum())
    assert rearmed > REDUCED_ROWS  # the exponential delays were drawn


def test_step_equals_graft_entry_where_the_draw_does_not_reach():
    import jax

    ref_step, (ref_state, _now, key) = graft_ref.entry()
    step, (state, _now0, seed) = graft.entry(device="cpu")
    fire_ok = 0
    for n, now in enumerate((0.0, 1.0)):
        out = ref_step(ref_state, np.float32(now), jax.random.fold_in(key, n))
        ref_state = out.state
        dirty, deleted, hb, counts = step(state, now, seed + n)
        host = ts.to_numpy(state)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(host, f), np.asarray(getattr(out.state, f)),
                                          err_msg=f"{f} at now={now}")
        np.testing.assert_array_equal(dirty.numpy(), np.asarray(out.dirty))
        np.testing.assert_array_equal(deleted.numpy(), np.asarray(out.deleted))
        np.testing.assert_array_equal(hb.numpy(), np.asarray(out.hb_fired))
        assert int(counts[0]) == int(out.transitions)
        assert int(counts[1]) == int(out.heartbeats)
        # the counter hash against threefry: the same rows armed, each
        # with a finite delay after now; the values are the draw's own
        want = np.asarray(out.state.fire_at)
        armed = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(host.fire_at), armed)
        assert np.all(host.fire_at[armed] > now) and np.all(want[armed] > now)
        fire_ok += int(armed.sum())
    assert fire_ok > 0.99 * graft.ROWS  # the Running rows armed their completion


def test_entry_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft.entry()
