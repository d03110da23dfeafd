"""The split dispatch: the tick kernel once per shard, one wire out.

The port of ``kwok_tpu.parallel.sharded_tick`` and of the ``shard_map``
branch of ``kwok_tpu.ops.tick.MultiTickKernel``. Rows are independent;
the only collective of the reference is the ``psum`` of the two counters
(``sharded_tick.py:73-74``). So for each kind:

- shard ``i``'s stream waits for what the caller queued on the first
  device's stream (``Mesh.after_first``), then launches ``csrc/tick.cu``
  (``ops/cuda_tick.tick_steps``) on its own rows, on its device and its
  own stream, with ``row_base`` at its first global row: the counter
  hash draws from the global row id, so the split draws exactly what the
  unsplit dispatch draws;
- on that stream it takes its ``next_due`` and copies its phase and cond
  rows (the next dispatch rewrites the state in place);
- its masks, counters, due and rows go to the first shard's device
  (``Mesh.to_first``: a stream wait there, a copy from another card),
  where the counters are summed in the psum's place, the dues take
  their minimum and the masks and rows are concatenated in row order;
- ``ops/tick.pack_wire`` packs them as for one state. Packing per shard
  would break the layout: the mask bits are MSB-first over ``3*cap``
  bits with ``deleted`` starting at bit ``cap``.

Nothing waits on the host. The reference's shards fold the shard index
into their threefry key (``sharded_tick.py:66-67``); the port's draws do
not depend on the split at all (a divergence, pinned in ROADMAP §3).
"""

from __future__ import annotations

import torch

from kwok_tpu_torch.models.compiler import CompiledRules
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops.state import SplitState, TickOutputs
from kwok_tpu_torch.ops.tick import next_due, pack_wire
from kwok_tpu_torch.parallel.mesh import make_mesh, row_sharding


def _tick_kind(state: SplitState, spec, now: float, seed: int, steps: int, dt: float):
    """One kind over its shards: ``(TickOutputs, due, (phase, cond))``
    gathered on the first shard's device."""
    mesh = state.mesh
    pieces = []
    for i, shard in enumerate(state.shards):
        mesh.after_first(i)
        with mesh.on(i):
            dirty, deleted, hb, counts = cuda_tick.tick_steps(
                shard, spec, now, seed, steps, dt, row_base=state.base(i)
            )
            if shard.device.type == "cuda":
                mesh.launches[i] += 1
            got = (
                dirty, deleted, hb, counts, next_due(shard).reshape(1),
                shard.phase.clone(), shard.cond_bits.clone(),
            )
        pieces.append(mesh.to_first(i, got))
    dirty, deleted, hb, counts, dues, phase, cond = (
        torch.cat(col) for col in zip(*pieces)
    )
    counts = counts.view(-1, 2).sum(dim=0, dtype=torch.int32)
    out = TickOutputs(
        state=state, dirty=dirty, deleted=deleted, hb_fired=hb,
        transitions=counts[0], heartbeats=counts[1],
    )
    return out, dues.min(), (phase, cond)


def tick_split(states, specs, now: float, seed: int, steps: int, dt: float):
    """One dispatch of every kind over split states: ``(outs, wire
    bytes)``, the outputs and the wire on the first shard's device."""
    outs, dues, rows = [], [], []
    for st, spec in zip(states, specs):
        if not isinstance(st, SplitState):
            raise TypeError(f"a split dispatch takes SplitStates, got {type(st).__name__}")
        o, due, r = _tick_kind(st, spec, now, seed, steps, dt)
        outs.append(o)
        dues.append(due)
        rows.append(r)
    return tuple(outs), pack_wire(outs, dues=dues, rows=rows)


class ShardedTickKernel:
    """Tick for one resource kind, rows split over a mesh (the port of
    ``kwok_tpu.parallel.ShardedTickKernel``). Capacity must be a multiple
    of the mesh's size (``parallel.mesh.pad_to_multiple``; inactive
    padding rows match no rule). Dispatch n draws from seed
    ``0x5EEDC0DE + n``. ``__call__`` returns the kind's TickOutputs with
    the masks and counters on the mesh's first device."""

    def __init__(
        self,
        table: CompiledRules,
        mesh=None,
        hb_interval: float = 30.0,
        hb_phases: tuple[str, ...] = (),
        hb_sel_bit: int = -1,
    ) -> None:
        self.mesh = mesh if mesh is not None else make_mesh()
        self.spec = cuda_tick.TickSpec(table, hb_interval, hb_phases, hb_sel_bit)
        self._step = 0

    def place(self, state) -> SplitState:
        """``state`` split over this kernel's mesh."""
        return row_sharding(self.mesh)(state)

    def __call__(self, state: SplitState, now: float) -> TickOutputs:
        self._step += 1
        seed = (cuda_tick.SEED_BASE + self._step) & 0xFFFFFFFF
        out, _due, _rows = _tick_kind(state, self.spec, now, seed, 1, 0.0)
        return out
