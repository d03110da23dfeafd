"""Struct-of-arrays cluster state for one resource kind, on a torch device.

The layout is ``kwok_tpu.ops.state``'s, field for field:

  active        bool[C]    row in use
  phase         int32[C]   phase id (kwok_tpu_torch.models.lifecycle)
  cond_bits     int32[C]   condition status bits (uint32 bit pattern)
  sel_bits      int32[C]   host-computed selector-match bits (uint32 bits)
  has_deletion  bool[C]    deletionTimestamp present
  pending_rule  int32[C]   matched-but-not-fired rule id, -1 if unmatched
  fire_at       f32[C]     engine-time the pending rule fires (+inf if none)
  hb_due        f32[C]     next heartbeat time (+inf = no heartbeat)
  gen           int32[C]   bumped on every transition (host patch dedup)

``cond_bits`` and ``sel_bits`` are uint32 in the JAX package. Torch on
the CPU has no ``>>``, ``~``, comparison or ``index_put`` for uint32, so
the port holds them as int32 tensors carrying the same 32 bits;
``from_numpy``/``to_numpy`` view the bits across, so nothing is converted
by value and the little-endian bytes on the wire are identical.

JAX replaced the state functionally (donated buffers); the port updates
these tensors in place — the tick kernel and the ingest scatters write
into the same storage.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INF = float("inf")

# numpy dtype of each field on the host side (the JAX package's layout)
NUMPY_DTYPES = {
    "active": np.dtype(bool),
    "phase": np.dtype(np.int32),
    "cond_bits": np.dtype(np.uint32),
    "sel_bits": np.dtype(np.uint32),
    "has_deletion": np.dtype(bool),
    "pending_rule": np.dtype(np.int32),
    "fire_at": np.dtype(np.float32),
    "hb_due": np.dtype(np.float32),
    "gen": np.dtype(np.int32),
}

# torch dtype of each field on the device side
TORCH_DTYPES = {
    "active": torch.bool,
    "phase": torch.int32,
    "cond_bits": torch.int32,
    "sel_bits": torch.int32,
    "has_deletion": torch.bool,
    "pending_rule": torch.int32,
    "fire_at": torch.float32,
    "hb_due": torch.float32,
    "gen": torch.int32,
}

# the two uint32 fields carried as int32 bit patterns
_U32_FIELDS = ("cond_bits", "sel_bits")


class RowState(NamedTuple):
    """One resource kind's rows: torch tensors on one device."""

    active: torch.Tensor  # bool[C]
    phase: torch.Tensor  # int32[C]
    cond_bits: torch.Tensor  # int32[C] (uint32 bits)
    sel_bits: torch.Tensor  # int32[C] (uint32 bits)
    has_deletion: torch.Tensor  # bool[C]
    pending_rule: torch.Tensor  # int32[C]
    fire_at: torch.Tensor  # float32[C]
    hb_due: torch.Tensor  # float32[C]
    gen: torch.Tensor  # int32[C]

    @property
    def capacity(self) -> int:
        return int(self.active.shape[0])

    @property
    def device(self) -> torch.device:
        return self.active.device


class TickOutputs(NamedTuple):
    """What one dispatch hands back for one kind. ``state`` is the same
    (in-place updated) RowState the dispatch was given."""

    state: RowState
    dirty: torch.Tensor  # bool[C] — transitioned: needs status patch
    deleted: torch.Tensor  # bool[C] — fired a delete-effect rule
    hb_fired: torch.Tensor  # bool[C] — heartbeat due
    transitions: torch.Tensor  # int32 scalar
    heartbeats: torch.Tensor  # int32 scalar


def new_row_state(capacity: int, device) -> RowState:
    """Fresh empty state of ``capacity`` rows on ``device``."""
    dev = torch.device(device)
    return RowState(
        active=torch.zeros(capacity, dtype=torch.bool, device=dev),
        phase=torch.zeros(capacity, dtype=torch.int32, device=dev),
        cond_bits=torch.zeros(capacity, dtype=torch.int32, device=dev),
        sel_bits=torch.zeros(capacity, dtype=torch.int32, device=dev),
        has_deletion=torch.zeros(capacity, dtype=torch.bool, device=dev),
        pending_rule=torch.full(
            (capacity,), -1, dtype=torch.int32, device=dev
        ),
        fire_at=torch.full((capacity,), INF, dtype=torch.float32, device=dev),
        hb_due=torch.full((capacity,), INF, dtype=torch.float32, device=dev),
        gen=torch.zeros(capacity, dtype=torch.int32, device=dev),
    )


def grow(state: RowState, new_capacity: int) -> RowState:
    """Capacity growth on the state's own device: a fresh state of
    ``new_capacity`` rows with the old rows copied into its prefix. The
    old tensors are left as they were (callers drop them)."""
    old = state.capacity
    if new_capacity <= old:
        return state
    out = new_row_state(new_capacity, state.device)
    for name in RowState._fields:
        getattr(out, name)[:old].copy_(getattr(state, name))
    return out


def regrow_stacked(state: RowState, n: int, new_rows: int) -> RowState:
    """A stacked state of ``n`` equal slices (lane ``i`` owns rows
    ``[i*r, (i+1)*r)``) regrown to ``new_rows`` rows per slice, on the
    state's own device and the current stream: each field is viewed as
    ``[n, r]`` and copied into the first ``r`` columns of a fresh state
    viewed as ``[n, new_rows]``; the new rows start empty."""
    old_rows = state.capacity // n
    if new_rows <= old_rows:
        return state
    out = new_row_state(n * new_rows, state.device)
    for name in RowState._fields:
        getattr(out, name).view(n, new_rows)[:, :old_rows].copy_(
            getattr(state, name).view(n, old_rows)
        )
    return out


def from_numpy(state, device) -> RowState:
    """A numpy RowState (``kwok_tpu.ops.state`` layout: uint32 cond/sel
    bits) as the port's torch RowState on ``device``. The uint32 fields
    are reinterpreted as int32 bit for bit."""
    fields = {}
    for name in RowState._fields:
        a = np.ascontiguousarray(
            np.asarray(getattr(state, name)), NUMPY_DTYPES[name]
        )
        if name in _U32_FIELDS:
            a = a.view(np.int32)
        fields[name] = torch.from_numpy(a.copy()).to(device)
    return RowState(**fields)


def to_numpy(state: RowState) -> RowState:
    """Host numpy copies of every field in the JAX package's dtypes
    (cond/sel bits viewed back as uint32), as a RowState of numpy arrays
    — the layout ``kwok_tpu.ops.state`` uses on the host."""
    fields = {}
    for name in RowState._fields:
        # .numpy() of a CPU tensor shares its memory: copy, so later
        # in-place updates of the state never reach this snapshot
        a = getattr(state, name).detach().cpu().numpy().copy()
        if name in _U32_FIELDS:
            a = a.view(np.uint32)
        fields[name] = a
    return RowState(**fields)
