"""The port's RowState (kwok_tpu_torch.ops.state) against kwok_tpu.ops.state:
new_row_state, grow and the from_numpy/to_numpy round trip, field for field
and dtype for dtype (exact)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kwok_tpu.ops import state as js
from kwok_tpu_torch.ops import state as ts


def random_state(cap: int, seed: int = 0):
    """A numpy (JAX-layout) state with every field randomized, uint32 bits
    above 2**31 included."""
    rng = np.random.default_rng(seed)
    s = js.new_row_state(cap)
    s.active[:] = rng.random(cap) < 0.7
    s.phase[:] = rng.integers(0, 7, cap)
    s.cond_bits[:] = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32)
    s.sel_bits[:] = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32)
    s.has_deletion[:] = rng.random(cap) < 0.2
    s.pending_rule[:] = rng.integers(-1, 5, cap)
    s.fire_at[:] = np.where(rng.random(cap) < 0.3, np.inf, rng.random(cap) * 100).astype(np.float32)
    s.hb_due[:] = np.where(rng.random(cap) < 0.3, np.inf, rng.random(cap) * 30).astype(np.float32)
    s.gen[:] = rng.integers(0, 1000, cap)
    return s


def assert_same(port_np, ref):
    for name in js.RowState._fields:
        a = getattr(port_np, name)
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("cap", [1, 1001, 4096])
def test_new_row_state_matches(cap):
    t = ts.new_row_state(cap, "cpu")
    for name in ts.RowState._fields:
        assert getattr(t, name).dtype == ts.TORCH_DTYPES[name]
    assert_same(ts.to_numpy(t), js.new_row_state(cap))
    assert t.capacity == cap


@pytest.mark.parametrize("cap,new_cap", [(1024, 2048), (1001, 4096), (8, 8)])
def test_grow_matches(cap, new_cap):
    ref = random_state(cap, seed=cap)
    got = ts.grow(ts.from_numpy(ref, "cpu"), new_cap)
    assert got.capacity == max(cap, new_cap)
    assert_same(ts.to_numpy(got), js.grow(ref, new_cap))


@pytest.mark.parametrize("cap", [1024, 8192])
def test_from_numpy_to_numpy_round_trip(cap):
    ref = random_state(cap, seed=1)
    t = ts.from_numpy(ref, "cpu")
    assert t.cond_bits.dtype == torch.int32 and t.sel_bits.dtype == torch.int32
    # the int32 fields carry the uint32 bits unchanged
    np.testing.assert_array_equal(t.cond_bits.numpy().view(np.uint32), ref.cond_bits)
    assert_same(ts.to_numpy(t), ref)


def test_to_numpy_is_a_snapshot():
    t = ts.new_row_state(16, "cpu")
    snap = ts.to_numpy(t)
    t.phase.fill_(3)
    assert (snap.phase == 0).all()
