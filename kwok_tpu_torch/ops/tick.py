"""The fused dispatch: every resource kind ticked K substeps, one wire out.

``MultiTickKernel`` is the port of ``kwok_tpu.ops.tick.MultiTickKernel``
as the engine builds it (``pack=True, pack_rows=True, steps=K``): one call
is one fused dispatch (``ops/cuda_tick.tick_dispatch``): on a card one
launch of ``csrc/tick.cu`` ticks every kind and writes the whole
host-visible summary as one uint8 wire, a one-block epilogue completes
its header, and the wire's copy to the host starts; nothing else runs on
the device. The wire's layout is the JAX package's, byte for byte, so
``unpack_wire`` (a verbatim copy) reads it:

  - int32 counters: transitions per kind, then heartbeats per kind;
  - float32 ``next_due`` per kind;
  - per kind, MSB-first ``packbits`` of ``stack([dirty, deleted, hb])``
    (3*cap bits; ``deleted`` starts at bit ``cap``, not byte-aligned in
    general);
  - per kind, phase as uint8 rows, then cond as little-endian uint32 rows.

On CPU tensors the same call runs the plain version (``tick_steps_plain``
per kind, then ``pack_wire``; both live in ``ops/cuda_tick.py``). With
``mesh`` (``parallel/mesh.py``) the states are
split over the mesh's shards and the dispatch is
``parallel/sharded_tick.tick_split``: one fused launch per shard, each
writing its rows of the same wire, and one epilogue; the wire is byte for
byte the unsplit one's.

The state tensors are updated in place (JAX donated them). The wire is a
fresh tensor, so it stays self-contained while later dispatches keep
changing the state: the pipelined engine keeps several wires in flight.

For the threaded lanes (``engine/lanes.py``) ``lane_views`` carves an
unpacked stacked wire into per-lane slices, and ``gather_deadlines``
copies the timer fields and the phase to the host for a checkpoint. The
JAX package's ``prefetch`` and ``to_host`` have no counterpart: a
``Wire`` starts its copy at dispatch, and the lanes regrow their stacked
state on the device (``ops/state.regrow_stacked``).
"""

from __future__ import annotations

import numpy as np
import torch

from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops.state import RowState, SplitState

# Engine time is float32. Past 2**17 s (~36h) the ulp grows beyond
# 2**-6 s; the engine rebases its epoch (rebase_times + an epoch shift on
# the host clock) before `now` crosses this.
REBASE_AFTER = 131072.0


def rebase_times(state, shift: float):
    """Shift the engine-time fields down by ``shift`` seconds, in place
    (epoch rebase). +inf sentinels stay +inf."""
    if isinstance(state, SplitState):
        state.each(lambda shard: rebase_times(shard, shift))
        return state
    s = float(np.float32(shift))
    state.fire_at.sub_(s)
    state.hb_due.sub_(s)
    return state


class Wire:
    """Host side of one dispatch's wire (replaces the JAX package's
    ``prefetch`` + ``np.asarray(wire)``).

    On a CUDA device the bytes land in a pinned host buffer through a
    non-blocking copy on the current stream, and a CUDA event marks their
    arrival: ``is_ready()`` polls it, ``np.asarray(wire)`` waits on it.
    On the CPU the bytes are already on the host."""

    def __init__(self, dev_bytes: torch.Tensor) -> None:
        if dev_bytes.device.type == "cuda":
            self._host = torch.empty(
                dev_bytes.shape[0], dtype=torch.uint8, pin_memory=True
            )
            self._host.copy_(dev_bytes, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev_bytes.device))
        else:
            self._host = dev_bytes
            self._event = None

    def is_ready(self) -> bool:
        return self._event is None or bool(self._event.query())

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def __array__(self, dtype=None, copy=None):
        self.wait()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


class MultiTickKernel:
    """One dispatch ticks several resource kinds (nodes + pods).

    specs: list of (table, hb_interval, hb_phases, hb_sel_bit) per kind.
    ``__call__(states, now)`` advances every kind ``steps`` substeps of
    ``dt`` starting at ``now`` (state updated in place) and returns
    ``(outs, wire)``: per-kind TickOutputs and the dispatch's ``Wire``.
    Dispatch n draws every kind's delays from seed ``0x5EEDC0DE + n``.
    On a card the outputs carry the counters as views of the wire's
    header and no masks (``tick_dispatch``); on the CPU, the masks too.

    With ``mesh`` the states are ``SplitState``s over it (``place``
    splits one) and each shard launches once for every kind; the wire
    and the outputs' counters lie on the mesh's first device,
    ``self.device``.
    """

    def __init__(
        self, specs, steps: int = 1, dt: float = 0.0, device="cuda",
        mesh=None,
    ) -> None:
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)
        self._split = None
        if mesh is not None:
            from kwok_tpu_torch.parallel.sharded_tick import tick_split

            self._split = tick_split
        self.specs = [
            cuda_tick.TickSpec(table, hb_interval, hb_phases, hb_sel_bit)
            for table, hb_interval, hb_phases, hb_sel_bit in specs
        ]
        self.steps = int(steps)
        self.dt = float(dt)
        self._step_n = 0

    def place(self, state):
        """``state`` on this kernel's device (a copy unless already
        there), or split over its mesh."""
        if self.mesh is not None:
            from kwok_tpu_torch.parallel.mesh import row_sharding

            return row_sharding(self.mesh)(state)
        return RowState(*(t.to(self.device) for t in state))

    def __call__(self, states, now: float):
        self._step_n += 1
        seed = (cuda_tick.SEED_BASE + self._step_n) & 0xFFFFFFFF
        if self._split is not None:
            outs, wire = self._split(states, self.specs, now, seed, self.steps, self.dt)
            return outs, Wire(wire)
        outs, wire = cuda_tick.tick_dispatch(
            states, self.specs, now, seed, self.steps, self.dt
        )
        return outs, Wire(wire)


def unpack_wire(
    blob: np.ndarray, capacities: list[int], lazy: bool = True,
    rows: bool = False,
):
    """Invert the pack=True wire blob.

    Returns (counters, masks_fn, next_dues): counters is int32[2K]
    (transitions per kind then heartbeats per kind); next_dues is f32[K]
    (earliest pending timer per kind, +inf = nothing scheduled — the tick
    loop sleeps until then); masks_fn() materializes, per kind, (dirty,
    deleted, hb_fired) boolean arrays — deferred so quiet ticks never pay
    the unpack.

    With rows=True (a pack_rows=True blob), returns a 4th element rows_fn:
    rows_fn() materializes, per kind, (phase uint8[cap], cond uint32[cap])
    — the post-tick mirror values, so the caller never needs the (already
    donated) output state."""
    n = len(capacities)
    counters = blob[: 8 * n].view(np.int32)
    next_dues = blob[8 * n : 12 * n].view(np.float32)
    mask_end = 12 * n + sum((3 * cap + 7) // 8 for cap in capacities)

    def masks_fn():
        out = []
        off = 12 * n
        for cap in capacities:
            seg_bytes = (3 * cap + 7) // 8
            seg = np.unpackbits(blob[off : off + seg_bytes], count=3 * cap)
            m = seg.reshape(3, cap).astype(bool)
            out.append((m[0], m[1], m[2]))
            off += seg_bytes
        return out

    if not rows:
        return counters, (masks_fn if lazy else masks_fn()), next_dues

    def rows_fn():
        out = []
        off = mask_end
        for cap in capacities:
            phase = blob[off : off + cap]
            off += cap
            # copy before the u32 view: the slice's byte offset is not
            # 4-aligned in general and numpy rejects misaligned views
            cond = blob[off : off + 4 * cap].copy().view(np.uint32)
            off += 4 * cap
            out.append((phase, cond))
        return out

    return counters, (masks_fn if lazy else masks_fn()), next_dues, rows_fn


def lane_views(masks, rows, n_lanes: int, r: int):
    """Per-shard index slices of an unpacked STACKED wire.

    The threaded lanes (engine/lanes.py) keep every lane's rows in one
    stacked device state: lane ``i`` owns rows ``[i*r, (i+1)*r)``. This
    carves the unpacked wire into exactly those slices so the coordinator
    can hand each lane its own view without copying: for each lane, a list
    of per-kind ``(dirty, deleted, hb, phase, cond)`` tuples. ``masks`` is
    ``masks_fn()``'s output, ``rows`` is ``rows_fn()``'s (or None — the
    phase/cond entries come back None then, e.g. a heartbeat-only wire).

    The slices are numpy VIEWS over the materialized wire arrays — lanes
    own disjoint ranges, so one lane clearing stale mask bits in its
    slice can never touch another lane's rows.
    """
    out = []
    for lane in range(n_lanes):
        lo, hi = lane * r, (lane + 1) * r
        kinds = []
        for ki, (dirty, deleted, hb) in enumerate(masks):
            if rows is not None:
                ph, cb = rows[ki]
                ph, cb = ph[lo:hi], cb[lo:hi]
            else:
                ph = cb = None
            kinds.append((dirty[lo:hi], deleted[lo:hi], hb[lo:hi], ph, cb))
        out.append(kinds)
    return out


def gather_deadlines(state):
    """Host numpy copies of the device-owned fields a checkpoint records,
    ``(fire_at, hb_due, gen, phase)`` (resilience/checkpoint.py). The
    phase is the device's too: a row the last dispatch fired holds its
    new phase here before the host mirror (``phase_h``) catches up at
    the consume, and the entry must describe one moment of the row.

    On a CUDA device the four copies go out together on the current
    stream (the tick thread's: they read the state its queued dispatches
    produce; a split state's shards on their own streams) into pinned
    buffers, an event marks each stream's end, and the host waits once
    for all of them. Call it on the thread that owns the state."""
    events = []

    def start(s: RowState) -> list:
        fields = (s.fire_at, s.hb_due, s.gen, s.phase)
        if s.device.type != "cuda":
            return [t.numpy().copy() for t in fields]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in fields]
        for h, t in zip(host, fields):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(s.device))
        events.append(done)
        return [h.numpy() for h in host]

    parts = state.each(start) if isinstance(state, SplitState) else [start(state)]
    for done in events:
        done.synchronize()
    return tuple(np.concatenate(f) for f in zip(*parts))
