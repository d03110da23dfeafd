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

Under the row split (``parallel/``) a kind's rows are a ``SplitState``:
one ``RowState`` per shard of a mesh, shard ``i`` holding global rows
``[i*rows, (i+1)*rows)`` on the mesh's device ``i``. The state ops here,
in ``ops/updates.py`` and ``ops/tick.py`` take either; on a split state
each works shard by shard on the shard's stream (``mesh.on(i)``). A
capacity change moves rows between shards, so ``grow`` and
``regrow_stacked`` re-lay a split state out through the host, as the JAX
package does (``to_host``, then ``place``).
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


class SplitState:
    """One kind's rows split over a mesh (``parallel/mesh.py``): shard
    ``i`` is a ``RowState`` of ``rows`` rows on ``mesh.devices[i]``
    holding global rows ``[base(i), base(i) + rows)``."""

    def __init__(self, mesh, shards) -> None:
        shards = list(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        rows = {s.capacity for s in shards}
        if len(rows) != 1:
            raise ValueError(f"shards of unequal rows: {sorted(rows)}")
        for s, dev in zip(shards, mesh.devices):
            if s.device != dev:
                raise ValueError(f"a shard on {s.device}, its mesh device is {dev}")
        self.mesh = mesh
        self.shards = shards
        self.rows = rows.pop()

    @property
    def capacity(self) -> int:
        return self.rows * len(self.shards)

    @property
    def device(self) -> torch.device:
        """The first shard's device: where a dispatch gathers its wire."""
        return self.mesh.devices[0]

    def base(self, i: int) -> int:
        """Global row id of shard ``i``'s first row."""
        return i * self.rows

    def each(self, fn) -> list:
        """``fn(shard)`` for every shard in row order, each on its own
        stream; the results."""
        out = []
        for i, shard in enumerate(self.shards):
            with self.mesh.on(i):
                out.append(fn(shard))
        return out


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


def new_split_state(capacity: int, mesh) -> SplitState:
    """Fresh empty state of ``capacity`` rows split over ``mesh``;
    ``capacity`` must be a multiple of the mesh's size
    (``parallel.mesh.pad_to_multiple``)."""
    rows = _shard_rows(capacity, mesh)
    shards = []
    for i, dev in enumerate(mesh.devices):
        with mesh.on(i):
            shards.append(new_row_state(rows, dev))
    return SplitState(mesh, shards)


def _shard_rows(capacity: int, mesh) -> int:
    if capacity % mesh.size:
        raise ValueError(
            f"{capacity} rows do not split evenly over {mesh.size} shards "
            "(pad with parallel.mesh.pad_to_multiple)"
        )
    return capacity // mesh.size


def split_rows(state, mesh) -> SplitState:
    """``state`` (a torch ``RowState``, a ``SplitState`` or a numpy state
    in ``kwok_tpu.ops.state``'s layout) placed on ``mesh``: shard ``i``
    gets global rows ``[i*c/d, (i+1)*c/d)`` on ``mesh.devices[i]``."""
    if isinstance(state, SplitState) or torch.is_tensor(state.active):
        host = to_numpy(state)
    else:
        host = state
    rows = _shard_rows(int(np.asarray(host.active).shape[0]), mesh)
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = i * rows
        part = RowState(*(np.asarray(a)[lo : lo + rows] for a in host))
        with mesh.on(i):
            shards.append(from_numpy(part, dev))
    return SplitState(mesh, shards)


def _through_host(state: SplitState, fn) -> SplitState:
    """``fn`` applied to a host copy of ``state`` as one CPU RowState,
    placed back on the mesh."""
    return split_rows(fn(from_numpy(to_numpy(state), "cpu")), state.mesh)


def grow(state, new_capacity: int):
    """Capacity growth on the state's own device: a fresh state of
    ``new_capacity`` rows with the old rows copied into its prefix. The
    old tensors are left as they were (callers drop them). A split state
    is re-laid out over its mesh."""
    old = state.capacity
    if new_capacity <= old:
        return state
    if isinstance(state, SplitState):
        return _through_host(state, lambda s: grow(s, new_capacity))
    out = new_row_state(new_capacity, state.device)
    for name in RowState._fields:
        getattr(out, name)[:old].copy_(getattr(state, name))
    return out


def regrow_stacked(state, n: int, new_rows: int):
    """A stacked state of ``n`` equal slices (lane ``i`` owns rows
    ``[i*r, (i+1)*r)``) regrown to ``new_rows`` rows per slice, on the
    state's own device and the current stream: each field is viewed as
    ``[n, r]`` and copied into the first ``r`` columns of a fresh state
    viewed as ``[n, new_rows]``; the new rows start empty. A split state
    is re-laid out over its mesh (the slices and the shards need not
    line up)."""
    old_rows = state.capacity // n
    if new_rows <= old_rows:
        return state
    if isinstance(state, SplitState):
        return _through_host(state, lambda s: regrow_stacked(s, n, new_rows))
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


def to_numpy(state) -> RowState:
    """Host numpy copies of every field in the JAX package's dtypes
    (cond/sel bits viewed back as uint32), as a RowState of numpy arrays
    — the layout ``kwok_tpu.ops.state`` uses on the host. A split state
    comes back whole, its shards in row order."""
    if isinstance(state, SplitState):
        return RowState(*(np.concatenate(f) for f in zip(*state.each(to_numpy))))
    fields = {}
    for name in RowState._fields:
        # .numpy() of a CPU tensor shares its memory: copy, so later
        # in-place updates of the state never reach this snapshot
        a = getattr(state, name).detach().cpu().numpy().copy()
        if name in _U32_FIELDS:
            a = a.view(np.uint32)
        fields[name] = a
    return RowState(**fields)


def field_numpy(state, name: str) -> np.ndarray:
    """Host copy of one field (the state's own dtype; a split state's
    shards in row order)."""
    if isinstance(state, SplitState):
        return np.concatenate(state.each(lambda s: field_numpy(s, name)))
    return getattr(state, name).cpu().numpy()
