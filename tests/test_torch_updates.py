"""The port's ingest scatters (kwok_tpu_torch.ops.updates) against the JAX
package's: init_rows/update_rows on duplicate-free padded batches (exact vs
the jitted scatters), on batches with duplicate indices (exact vs a numpy
replay in staging order, last writer wins), and UpdateBuffer staging
(against the JAX buffer, and release-then-reacquire in one window)."""

from __future__ import annotations

import numpy as np
import pytest

from kwok_tpu.ops import state as js
from kwok_tpu.ops import updates as ju
from kwok_tpu.ops.tick import to_device, to_host
from kwok_tpu_torch.ops import state as ts
from kwok_tpu_torch.ops import updates as tu

CAP = 4096


def base_state(seed=0):
    rng = np.random.default_rng(seed)
    s = js.new_row_state(CAP)
    s.active[:] = rng.random(CAP) < 0.5
    s.phase[:] = rng.integers(0, 5, CAP)
    s.cond_bits[:] = rng.integers(0, 2**32, CAP, dtype=np.uint64).astype(np.uint32)
    s.sel_bits[:] = rng.integers(0, 16, CAP).astype(np.uint32)
    s.pending_rule[:] = rng.integers(-1, 3, CAP)
    s.fire_at[:] = (rng.random(CAP) * 9).astype(np.float32)
    s.hb_due[:] = (rng.random(CAP) * 9).astype(np.float32)
    s.gen[:] = rng.integers(0, 50, CAP)
    return s


def init_batch(rng, n, pad, unique=True):
    idx = (rng.choice(CAP, n, replace=False) if unique
           else rng.integers(0, CAP // 16, n)).astype(np.int32)
    return ju.InitBatch(
        idx=np.concatenate([idx, np.full(pad, CAP, np.int32)]),
        active=np.concatenate([rng.random(n) < 0.8, np.zeros(pad, bool)]),
        phase=np.concatenate([rng.integers(0, 5, n).astype(np.int32), np.zeros(pad, np.int32)]),
        cond_bits=np.concatenate([rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
                                  np.zeros(pad, np.uint32)]),
        sel_bits=np.concatenate([rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
                                 np.zeros(pad, np.uint32)]),
        has_deletion=np.concatenate([rng.random(n) < 0.3, np.zeros(pad, bool)]),
    )


def upd_batch(rng, n, pad, unique=True):
    idx = (rng.choice(CAP, n, replace=False) if unique
           else rng.integers(0, CAP // 16, n)).astype(np.int32)
    return ju.UpdateBatch(
        idx=np.concatenate([idx, np.full(pad, CAP, np.int32)]),
        sel_bits=np.concatenate([rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
                                 np.zeros(pad, np.uint32)]),
        has_deletion=np.concatenate([rng.random(n) < 0.3, np.zeros(pad, bool)]),
    )


def replay_init(s, b):
    """numpy oracle: apply an InitBatch entry by entry, in order."""
    for i, idx in enumerate(b.idx):
        if not 0 <= idx < CAP:
            continue
        s.active[idx] = b.active[i]
        s.phase[idx] = b.phase[i]
        s.cond_bits[idx] = b.cond_bits[i]
        s.sel_bits[idx] = b.sel_bits[i]
        s.has_deletion[idx] = b.has_deletion[i]
        s.pending_rule[idx] = -1
        s.fire_at[idx] = np.inf
        s.hb_due[idx] = np.inf
        s.gen[idx] = 0
    return s


def replay_update(s, b):
    for i, idx in enumerate(b.idx):
        if 0 <= idx < CAP:
            s.sel_bits[idx] = b.sel_bits[i]
            s.has_deletion[idx] = b.has_deletion[i]
    return s


def assert_same(port, ref):
    got = ts.to_numpy(port)
    for name in js.RowState._fields:
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("n,pad", [(1, 4095), (3000, 1096), (4096, 0)])
def test_scatters_match_jax_duplicate_free(n, pad):
    rng = np.random.default_rng(n)
    ib = init_batch(rng, n, pad)
    ub = upd_batch(rng, min(n, 2000), 4096 - min(n, 2000))
    ref = to_host(ju.update_rows(ju.init_rows(to_device(base_state()), ib), ub))
    got = tu.update_rows(tu.init_rows(ts.from_numpy(base_state(), "cpu"), ib), ub)
    assert_same(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatters_last_writer_wins_with_duplicates(seed):
    rng = np.random.default_rng(100 + seed)
    ib = init_batch(rng, 3000, 100, unique=False)
    ub = upd_batch(rng, 3000, 100, unique=False)
    assert len(np.unique(ib.idx)) < 3000  # duplicates present
    ref = replay_update(replay_init(base_state(), ib), ub)
    got = tu.update_rows(tu.init_rows(ts.from_numpy(base_state(), "cpu"), ib), ub)
    assert_same(got, ref)


def test_update_buffer_matches_jax_buffer():
    """Duplicate-free staging through both UpdateBuffers."""
    rng = np.random.default_rng(5)
    jb, tb = ju.UpdateBuffer(), tu.UpdateBuffer()
    rows = rng.choice(CAP, 600, replace=False)
    for b in (jb, tb):
        for i in rows[:200]:
            b.stage_init(int(i), True, phase=2, cond_bits=0xFFFF0000, sel_bits=3, has_deletion=False)
        for i in rows[200:500]:
            b.stage_init(int(i), True, phase=0, cond_bits=7, sel_bits=1, has_deletion=bool(i % 2))
        for i in rows[500:]:
            b.stage_init(int(i), False)
        for i in rows[:50]:
            b.stage_update(int(i), 0x80000001, True)
    assert tb.pending == jb.pending
    ref = to_host(jb.flush(to_device(base_state())))
    got = tb.flush(ts.from_numpy(base_state(), "cpu"))
    assert tb.pending == 0
    assert_same(got, ref)


def test_update_buffer_staging_order_release_then_reacquire():
    """A row released then re-acquired in one window — and the reverse —
    ends in its LATER write; staged updates land after every init."""
    b = tu.UpdateBuffer()
    b.stage_init(10, False)
    b.stage_init(10, True, phase=4, cond_bits=1, sel_bits=3)
    b.stage_init(11, True, phase=4, cond_bits=2, sel_bits=3, has_deletion=True)
    b.stage_init(11, False)
    b.stage_init(12, True, phase=1)
    b.stage_update(12, 5, True)
    b.stage_init(12, True, phase=3)
    b.stage_update(12, 6, False)
    got = ts.to_numpy(b.flush(ts.from_numpy(base_state(), "cpu")))
    assert got.active[10] and got.phase[10] == 4 and got.cond_bits[10] == 1
    assert not got.active[11] and got.phase[11] == 0
    assert got.active[12] and got.phase[12] == 3
    assert got.sel_bits[12] == 6 and not got.has_deletion[12]
    assert got.fire_at[12] == np.inf and got.pending_rule[12] == -1
