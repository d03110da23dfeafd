"""Scatter ops: host ingest writes -> device-resident state, in place.

The port of ``kwok_tpu.ops.updates``'s ingest scatters:

- init_rows: (re)initialize whole rows — object created, row freed/recycled
- update_rows: modify the host-owned matching inputs of existing rows
  (sel_bits / has_deletion) without touching device-owned phase/cond/timers;
  the next tick's re-match notices any change (``best != pending_rule``).

Each is torch index writes into the state tensors (JAX returned new,
donated buffers; these write in place). Two rules the JAX scatters got
from XLA are made explicit on the host, where the indices are numpy:

- a padding or out-of-range index (``idx == capacity`` pads the JAX
  batches) is dropped — XLA's ``mode="drop"``; torch would raise;
- duplicate indices in one batch resolve last-writer-wins in staging
  order; ``index_put_`` on CUDA picks no defined winner among duplicates,
  so only each index's last occurrence is written.

``refine_rows``/``refine_flush`` are the checkpoint-restore scatter
(``resilience/checkpoint.py``) under the same two rules. A flush into a
stacked state (one slice of ``rows`` rows per lane, ``engine/lanes.py``)
drops out-of-range lane indices BEFORE shifting them by the lane's
offset, so a stray index can never land in the next lane's rows.

Each scatter also takes a ``SplitState`` (``parallel/``): the batch's
written positions are found over the global rows as above, then each
shard takes the ones that fall in its rows, moved down by its base, on
its own stream. The lane offset of a stacked flush is applied first, so
a lane's rows may straddle shards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kwok_tpu_torch.ops.state import RowState, SplitState

INF = float("inf")


class InitBatch(NamedTuple):
    idx: np.ndarray  # int32, out-of-range (e.g. capacity) = padding
    active: np.ndarray  # bool
    phase: np.ndarray  # int32
    cond_bits: np.ndarray  # uint32
    sel_bits: np.ndarray  # uint32
    has_deletion: np.ndarray  # bool


class UpdateBatch(NamedTuple):
    idx: np.ndarray  # int32, out-of-range (e.g. capacity) = padding
    sel_bits: np.ndarray  # uint32
    has_deletion: np.ndarray  # bool


def _last_writers(idx: np.ndarray, cap: int) -> np.ndarray:
    """Positions into ``idx`` that are written: in range, and each index's
    LAST occurrence only."""
    pos = np.nonzero((idx >= 0) & (idx < cap))[0]
    kept = idx[pos]
    if kept.size < 2:
        return pos
    # first occurrence in the reversed run == last occurrence in order
    _, first_rev = np.unique(kept[::-1], return_index=True)
    return pos[kept.size - 1 - first_rev]


def _shift(idx, offset: int, rows: "int | None") -> np.ndarray:
    """Slice-local row indices -> indices into the target state: padding
    and indices outside ``[0, rows)`` become -1 (dropped by the scatter),
    the rest move by ``offset``."""
    idx = np.asarray(idx, np.int64)
    if rows is None:
        return idx + offset if offset else idx
    keep = (idx >= 0) & (idx < rows)
    return np.where(keep, idx + offset, -1)


def _scatter(state, idx: np.ndarray, write):
    """Call ``write(rows, row_idx, pos)`` with the positions ``pos`` into
    the batch that are written (``_last_writers``) and their row indices
    ``row_idx`` into ``rows``: the state itself, or each shard of a split
    state in turn (indices moved down by its base, on its stream).
    Returns ``state``."""
    pos = _last_writers(idx, state.capacity)
    if not pos.size:
        return state
    if not isinstance(state, SplitState):
        write(state, idx[pos], pos)
        return state
    g = idx[pos]
    shard_of = g // state.rows
    for i, shard in enumerate(state.shards):
        sel = np.nonzero(shard_of == i)[0]
        if sel.size:
            with state.mesh.on(i):
                write(shard, g[sel] - state.base(i), pos[sel])
    return state


def init_rows(state, b: InitBatch):
    """(Re)initialize rows ``b.idx`` in place; timers and pending rule
    reset (-1 / +inf / +inf / gen 0). Returns ``state``."""
    return _scatter(state, np.asarray(b.idx, np.int64),
                    lambda rows, i, pos: _init_rows(rows, b, i, pos))


def _init_rows(state: RowState, b: InitBatch, row_idx, pos) -> None:
    cols = np.empty((6, pos.size), np.int64)
    cols[0] = row_idx
    cols[1] = np.asarray(b.active, bool)[pos]
    cols[2] = np.asarray(b.phase, np.int32)[pos]
    # uint32 bits -> int32 bit pattern (the state's layout)
    cols[3] = np.asarray(b.cond_bits, np.uint32)[pos].view(np.int32)
    cols[4] = np.asarray(b.sel_bits, np.uint32)[pos].view(np.int32)
    cols[5] = np.asarray(b.has_deletion, bool)[pos]
    dev = torch.from_numpy(cols).to(state.device)
    i = dev[0]
    state.active[i] = dev[1].to(torch.bool)
    state.phase[i] = dev[2].to(torch.int32)
    state.cond_bits[i] = dev[3].to(torch.int32)
    state.sel_bits[i] = dev[4].to(torch.int32)
    state.has_deletion[i] = dev[5].to(torch.bool)
    state.pending_rule.index_fill_(0, i, -1)
    state.fire_at.index_fill_(0, i, INF)
    state.hb_due.index_fill_(0, i, INF)
    state.gen.index_fill_(0, i, 0)


def update_rows(state, b: UpdateBatch):
    """Overwrite the matching inputs (sel_bits, has_deletion) of rows
    ``b.idx`` in place. Returns ``state``."""
    return _scatter(state, np.asarray(b.idx, np.int64),
                    lambda rows, i, pos: _update_rows(rows, b, i, pos))


def _update_rows(state: RowState, b: UpdateBatch, row_idx, pos) -> None:
    cols = np.empty((3, pos.size), np.int64)
    cols[0] = row_idx
    cols[1] = np.asarray(b.sel_bits, np.uint32)[pos].view(np.int32)
    cols[2] = np.asarray(b.has_deletion, bool)[pos]
    dev = torch.from_numpy(cols).to(state.device)
    i = dev[0]
    state.sel_bits[i] = dev[1].to(torch.int32)
    state.has_deletion[i] = dev[2].to(torch.bool)


class RefineBatch(NamedTuple):
    """Checkpoint-restore refinement: overwrite the device-owned timer
    fields of already-armed rows. The tick kernel re-arms a restarted row
    with a FRESH delay; this scatter runs after that arming dispatch and
    restores the checkpointed residue, so an in-flight Stage delay
    resumes instead of resetting."""

    idx: np.ndarray  # int32, out-of-range (e.g. capacity) = padding
    fire_at: np.ndarray  # float32
    hb_due: np.ndarray  # float32
    gen: np.ndarray  # int32


def refine_rows(state, b: RefineBatch):
    """Overwrite (fire_at, hb_due, gen) of rows ``b.idx`` in place.
    Returns ``state``."""
    return _scatter(state, np.asarray(b.idx, np.int64),
                    lambda rows, i, pos: _refine_rows(rows, b, i, pos))


def _refine_rows(state: RowState, b: RefineBatch, row_idx, pos) -> None:
    dev = state.device
    i = torch.from_numpy(np.ascontiguousarray(row_idx)).to(dev)
    state.fire_at[i] = torch.from_numpy(
        np.asarray(b.fire_at, np.float32)[pos]).to(dev)
    state.hb_due[i] = torch.from_numpy(
        np.asarray(b.hb_due, np.float32)[pos]).to(dev)
    state.gen[i] = torch.from_numpy(np.asarray(b.gen, np.int32)[pos]).to(dev)


def refine_flush(
    state: RowState,
    idx: np.ndarray,
    fire_at: np.ndarray,
    hb_due: np.ndarray,
    gen: np.ndarray,
    offset: int = 0,
    rows: "int | None" = None,
) -> RowState:
    """Apply one refine run of slice-local indices to ``state``: indices
    outside ``[0, rows)`` are dropped, the rest shifted by ``offset``
    (a lane's slice of a stacked state). Returns ``state``."""
    return refine_rows(state, RefineBatch(
        idx=_shift(idx, offset, rows), fire_at=fire_at, hb_due=hb_due,
        gen=gen,
    ))


class _InitBlock(NamedTuple):
    """A columnar run of ACTIVE row inits (``stage_init_array``)."""

    idx: np.ndarray  # int32
    phase: np.ndarray  # int32
    cond_bits: np.ndarray  # uint32
    sel_bits: np.ndarray  # uint32
    has_deletion: np.ndarray  # bool


class UpdateBuffer:
    """Host-side accumulator that flushes staged row writes to the device.

    The staging API of ``kwok_tpu.ops.updates.UpdateBuffer``: per-row
    ``stage_init``/``stage_update`` and the columnar
    ``stage_init_array`` (the native ingest's block of new Pending rows).
    Tuples and blocks are kept in one list in STAGING ORDER. The flush
    differs in shape only: torch needs no static batch widths, so every
    staged init, tuple or block, goes out as ONE ``init_rows`` batch in
    staging order, then every staged update as one ``update_rows`` batch.
    Last-writer-wins inside a batch makes that equal to applying the
    entries one by one: a row released then re-acquired in one window
    ends in its later write, whichever of the two was a block."""

    def __init__(self) -> None:
        # per-row tuples and _InitBlock runs, in staging order
        self._init: list = []
        self._n_init = 0  # staged init ROWS (a block counts its length)
        self._upd: list[tuple[int, int, bool]] = []

    def stage_init(
        self,
        idx: int,
        active: bool,
        phase: int = 0,
        cond_bits: int = 0,
        sel_bits: int = 0,
        has_deletion: bool = False,
    ) -> None:
        self._init.append((idx, active, phase, cond_bits, sel_bits, has_deletion))
        self._n_init += 1

    def stage_init_array(
        self,
        idx: np.ndarray,
        phase,
        cond_bits: np.ndarray,
        sel_bits: np.ndarray,
        has_deletion: np.ndarray,
    ) -> None:
        """Stage a columnar run of ACTIVE row inits. ``phase`` may be a
        scalar (every new row of the native ingest starts Pending)."""
        n = int(idx.shape[0])
        if not n:
            return
        ph = np.asarray(phase, np.int32)
        if ph.ndim == 0:
            ph = np.full(n, ph, np.int32)
        self._init.append(_InitBlock(
            idx=np.ascontiguousarray(idx, np.int32),
            phase=ph,
            cond_bits=np.ascontiguousarray(cond_bits, np.uint32),
            sel_bits=np.ascontiguousarray(sel_bits, np.uint32),
            has_deletion=np.ascontiguousarray(has_deletion, bool),
        ))
        self._n_init += n

    def stage_update(self, idx: int, sel_bits: int, has_deletion: bool) -> None:
        self._upd.append((idx, sel_bits, has_deletion))

    def staged_rows(self) -> frozenset:
        """Row indices with a staged-but-unflushed INIT, block rows
        included. The checkpoint gather and restore refine skip these:
        their device slots still describe a previous occupant (or
        nothing) until the init flushes. Updates are excluded on purpose:
        they only touch matching inputs, and the kernel's re-arm
        supersedes any refine on such rows at the next tick."""
        out: set = set()
        for entry in self._init:
            if isinstance(entry, _InitBlock):
                out.update(entry.idx.tolist())
            else:
                out.add(entry[0])
        return frozenset(out)

    @property
    def pending(self) -> int:
        return self._n_init + len(self._upd)

    def _init_batch(self) -> InitBatch:
        """Every staged init, tuples and blocks, as one batch in staging
        order."""
        parts = []
        run: list = []

        def close_run() -> None:
            if run:
                n = len(run)
                parts.append((
                    np.fromiter((c[0] for c in run), np.int64, n),
                    np.fromiter((c[1] for c in run), bool, n),
                    np.fromiter((c[2] for c in run), np.int32, n),
                    np.fromiter((c[3] for c in run), np.uint32, n),
                    np.fromiter((c[4] for c in run), np.uint32, n),
                    np.fromiter((c[5] for c in run), bool, n),
                ))
                run.clear()

        for entry in self._init:
            if isinstance(entry, _InitBlock):
                close_run()
                parts.append((
                    entry.idx.astype(np.int64), np.ones(entry.idx.shape[0], bool),
                    entry.phase, entry.cond_bits, entry.sel_bits,
                    entry.has_deletion,
                ))
            else:
                run.append(entry)
        close_run()
        cols = [np.concatenate([p[j] for p in parts]) for j in range(6)]
        return InitBatch(*cols)

    def flush(
        self, state: RowState, offset: int = 0, rows: "int | None" = None,
    ) -> RowState:
        """Apply staged writes to ``state`` in place and return it. With
        ``offset``/``rows`` the staged indices are slice-local (a lane of
        a stacked state): those outside ``[0, rows)`` are dropped, the
        rest shifted by ``offset``. Staged entries are cleared only once
        their writes went out: a flush that raises keeps its unapplied
        tail (the inits when ``init_rows`` raised, else the updates), and
        the next flush re-applies it; a row init is an idempotent
        overwrite."""
        if self._init:
            b = self._init_batch()
            state = init_rows(state, b._replace(idx=_shift(b.idx, offset, rows)))
            self._init = []
            self._n_init = 0
        if self._upd:
            upd = self._upd
            n = len(upd)
            state = update_rows(state, UpdateBatch(
                idx=_shift(np.fromiter((c[0] for c in upd), np.int64, n),
                           offset, rows),
                sel_bits=np.fromiter((c[1] for c in upd), np.uint32, n),
                has_deletion=np.fromiter((c[2] for c in upd), bool, n),
            ))
            self._upd = []
        return state
