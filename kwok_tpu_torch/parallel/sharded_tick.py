"""The split dispatch: one fused tick launch per shard, one wire out.

The port of ``kwok_tpu.parallel.sharded_tick`` and of the ``shard_map``
branch of ``kwok_tpu.ops.tick.MultiTickKernel``. Rows are independent;
the only collective of the reference is the ``psum`` of the two counters
(``sharded_tick.py:73-74``). On a card (``tick_split``):

- the wire (``ops/cuda_tick.wire_layout`` over the kinds' whole
  capacities) and every shard's records are allocated on the first
  shard's device;
- shard ``i``'s stream waits for what the caller queued on the first
  device's stream (``Mesh.after_first``), then launches the fused kernel
  (``ops/cuda_tick.tick_dispatch_part``) once for every kind's rows of
  the shard, on its device and its own stream, with ``row_base`` at its
  first global row: the counter hash draws from the global row id, so
  the split draws exactly what the unsplit dispatch draws, and the shard
  writes its phase and cond rows and the mask bytes it owns whole at
  their places in the wire. A shard on another card writes into a
  wire-shaped buffer of its own, and its rows, whole mask bytes and
  records are copied to the first device as the gather was;
- the first device's stream waits for every shard (``Mesh.to_first``)
  and runs one epilogue over all the records: the counters summed in
  the psum's place, the dues' minimum, and the mask bytes that shards
  (or blocks) share OR'd together. The mask bits are MSB-first over
  ``3*cap`` bits with ``deleted`` at bit ``cap``, so a shard boundary
  need not fall on a byte.

No row is cloned or concatenated: the wire is byte for byte the unsplit
dispatch's. On the CPU the plain version ticks each shard
(``tick_steps_plain``) and packs the gathered masks and rows with
``pack_wire``.

Nothing waits on the host. The reference's shards fold the shard index
into their threefry key (``sharded_tick.py:66-67``); the port's draws do
not depend on the split at all (a divergence, pinned in ROADMAP §3).
"""

from __future__ import annotations

import torch

from kwok_tpu_torch.models.compiler import CompiledRules
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops.state import SplitState, TickOutputs
from kwok_tpu_torch.parallel.mesh import make_mesh, row_sharding


def _owned_ranges(layout, k: int, base: int, rows: int):
    """The wire byte ranges ``[lo, hi)`` that rows ``[base, base + rows)``
    of kind ``k`` write alone: their phase and cond rows and the mask
    bytes wholly inside each of their three runs."""
    total = layout.capacities[k]
    out = [(layout.phase_offs[k] + base, layout.phase_offs[k] + base + rows),
           (layout.cond_offs[k] + 4 * base, layout.cond_offs[k] + 4 * (base + rows))]
    for m in range(3):
        p0 = m * total + base
        lo, hi = (p0 + 7) // 8, (p0 + rows) // 8
        if hi > lo:
            out.append((layout.mask_offs[k] + lo, layout.mask_offs[k] + hi))
    return out


def _split_on_card(states, specs, now: float, seed: int, steps: int, dt: float):
    mesh = states[0].mesh
    dev0 = mesh.devices[0]
    layout = cuda_tick.wire_layout([st.capacity for st in states])
    per_shard = cuda_tick.blocks_of(st.rows for st in states)
    words = per_shard * cuda_tick.RECORD_WORDS
    n = len(states)
    with torch.cuda.device(dev0):
        wire = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev0)
        records = torch.empty(max(mesh.size * words, 1), dtype=torch.int32, device=dev0)
    for i in range(mesh.size):
        shards = [st.shards[i] for st in states]
        bases = [st.base(i) for st in states]
        dev = mesh.devices[i]
        here = records[i * words:(i + 1) * words]
        mesh.after_first(i)
        if dev == dev0:
            with mesh.on(i):
                cuda_tick.tick_dispatch_part(
                    shards, specs, now, seed, steps, dt, bases, bases, layout, wire, here,
                )
            mesh.to_first(i, [])
        else:
            with mesh.on(i):
                local = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
                local_rec = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
                cuda_tick.tick_dispatch_part(
                    shards, specs, now, seed, steps, dt, bases, bases, layout, local, local_rec,
                )
                # a copy between cards runs on the source's current stream
                # and is ordered with the first card's current stream
                for k, st in enumerate(states):
                    for lo, hi in _owned_ranges(layout, k, bases[k], st.rows):
                        wire[lo:hi].copy_(local[lo:hi])
                if words:
                    here.copy_(local_rec[:words])
        mesh.launches[i] += 1
    with torch.cuda.device(dev0):
        # shards of rows a multiple of 8 start and end on a byte of every run
        edges = any(st.rows % 8 for st in states)
        cuda_tick.tick_wire_epilogue(wire, records, mesh.size * per_shard, n, edges)
    header = wire[: 8 * n].view(torch.int32)
    outs = tuple(
        TickOutputs(st, None, None, None, header[k], header[n + k])
        for k, st in enumerate(states)
    )
    return outs, wire


def _tick_kind_plain(state: SplitState, spec, now: float, seed: int, steps: int, dt: float):
    """One kind over its CPU shards, plain: ``(TickOutputs, due, (phase,
    cond))``, the masks and rows gathered in row order."""
    pieces = []
    for i, shard in enumerate(state.shards):
        cuda_tick.tick_steps.check(shard, state.base(i))
        d, x, h, c = cuda_tick.tick_steps_plain(
            shard, spec, now, seed, steps, dt, row_base=state.base(i)
        )
        pieces.append((d, x, h, c, cuda_tick.next_due(shard).reshape(1),
                       shard.phase, shard.cond_bits))
    dirty, deleted, hb, counts, dues, phase, cond = (torch.cat(col) for col in zip(*pieces))
    counts = counts.view(-1, 2).sum(dim=0, dtype=torch.int32)
    out = TickOutputs(
        state=state, dirty=dirty, deleted=deleted, hb_fired=hb,
        transitions=counts[0], heartbeats=counts[1],
    )
    return out, dues.min(), (phase, cond)


def tick_split(states, specs, now: float, seed: int, steps: int, dt: float):
    """One dispatch of every kind over split states: ``(outs, wire
    bytes)``, the wire and the outputs' counters on the first shard's
    device (on a card the outputs carry no masks, as ``tick_dispatch``'s)."""
    states = tuple(states)
    for st in states:
        if not isinstance(st, SplitState):
            raise TypeError(f"a split dispatch takes SplitStates, got {type(st).__name__}")
        if st.mesh is not states[0].mesh:
            raise ValueError("a split dispatch takes states split over one mesh")
    if states[0].mesh.devices[0].type == "cuda":
        return _split_on_card(states, specs, now, seed, steps, dt)
    outs, dues, rows = [], [], []
    for st, spec in zip(states, specs):
        o, due, r = _tick_kind_plain(st, spec, now, seed, steps, dt)
        outs.append(o)
        dues.append(due)
        rows.append(r)
    return tuple(outs), cuda_tick.pack_wire(outs, dues=dues, rows=rows)


class ShardedTickKernel:
    """Tick for one resource kind, rows split over a mesh (the port of
    ``kwok_tpu.parallel.ShardedTickKernel``). Capacity must be a multiple
    of the mesh's size (``parallel.mesh.pad_to_multiple``; inactive
    padding rows match no rule). Dispatch n draws from seed
    ``0x5EEDC0DE + n``. ``__call__`` returns the kind's TickOutputs with
    the masks and counters on the mesh's first device: each shard runs
    the per-kind entry (``tick_steps``), whose masks are gathered."""

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
        mesh = state.mesh
        pieces = []
        for i, shard in enumerate(state.shards):
            mesh.after_first(i)
            with mesh.on(i):
                got = cuda_tick.tick_steps(shard, self.spec, now, seed, 1, 0.0,
                                           row_base=state.base(i))
                if shard.device.type == "cuda":
                    mesh.launches[i] += 1
            pieces.append(mesh.to_first(i, got))
        dirty, deleted, hb, counts = (torch.cat(col) for col in zip(*pieces))
        counts = counts.view(-1, 2).sum(dim=0, dtype=torch.int32)
        return TickOutputs(
            state=state, dirty=dirty, deleted=deleted, hb_fired=hb,
            transitions=counts[0], heartbeats=counts[1],
        )
