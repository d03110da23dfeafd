"""The fused dispatch: every resource kind ticked K substeps, one wire out.

``MultiTickKernel`` is the port of ``kwok_tpu.ops.tick.MultiTickKernel``
as the engine builds it (``pack=True, pack_rows=True, steps=K``): one call
runs the tick kernel (``ops/cuda_tick.py``) once per kind, then packs the
whole host-visible summary into one uint8 wire on the device and starts
its copy to the host. The wire's layout is the JAX package's, byte for
byte, so ``unpack_wire`` (a verbatim copy) reads it:

  - int32 counters: transitions per kind, then heartbeats per kind;
  - float32 ``next_due`` per kind;
  - per kind, MSB-first ``packbits`` of ``stack([dirty, deleted, hb])``
    (3*cap bits; ``deleted`` starts at bit ``cap``, not byte-aligned in
    general);
  - per kind, phase as uint8 rows, then cond as little-endian uint32 rows.

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
from kwok_tpu_torch.ops.state import RowState, TickOutputs

INF = float("inf")

# Engine time is float32. Past 2**17 s (~36h) the ulp grows beyond
# 2**-6 s; the engine rebases its epoch (rebase_times + an epoch shift on
# the host clock) before `now` crosses this.
REBASE_AFTER = 131072.0


def rebase_times(state: RowState, shift: float) -> RowState:
    """Shift the engine-time fields down by ``shift`` seconds, in place
    (epoch rebase). +inf sentinels stay +inf."""
    s = float(np.float32(shift))
    state.fire_at.sub_(s)
    state.hb_due.sub_(s)
    return state


def next_due(state: RowState) -> torch.Tensor:
    """Engine-time of the earliest pending timer (rule fire or heartbeat)
    across active rows, as a 0-d float32 tensor; +inf when nothing is
    scheduled. The host tick loop sleeps until then."""
    dev = state.device
    # a fill, not torch.tensor(INF, device=...): a host value copied onto
    # the card is followed by a stream sync, which would make every
    # dispatch wait for its own kernels here
    inf = torch.full((), INF, dtype=torch.float32, device=dev)
    if state.capacity == 0:
        return inf
    armed = state.active & (state.pending_rule >= 0)
    fire = torch.where(armed, state.fire_at, inf).min()
    hb = torch.where(state.active, state.hb_due, inf).min()
    return torch.minimum(fire, hb)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """numpy ``packbits`` (MSB first, zero-padded last byte) of a 1-D
    bool or 0/1 uint8 tensor, on the tensor's device."""
    n = int(bits.shape[0])
    nbytes = (n + 7) // 8
    b = torch.zeros(nbytes * 8, dtype=torch.uint8, device=bits.device)
    b[:n] = bits.to(torch.uint8)
    # bit j of a byte is worth 2**(7-j); the weights come from arange on
    # the device, as a host table would be copied and synced each call
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    w = torch.bitwise_left_shift(torch.ones_like(shifts), shifts)
    return (b.view(nbytes, 8) * w).sum(dim=1, dtype=torch.int32).to(torch.uint8)


def pack_wire(outs) -> torch.Tensor:
    """The pack_rows wire of a dispatch's per-kind TickOutputs, as one
    uint8 tensor on their device."""
    counters = torch.stack(
        [o.transitions for o in outs] + [o.heartbeats for o in outs]
    ).to(torch.int32)
    dues = torch.stack([next_due(o.state) for o in outs]).to(torch.float32)
    parts = [counters.view(torch.uint8), dues.view(torch.uint8)]
    for o in outs:
        parts.append(packbits(torch.cat([o.dirty, o.deleted, o.hb_fired])))
    for o in outs:
        parts.append(o.state.phase.to(torch.uint8))
        parts.append(o.state.cond_bits.view(torch.uint8))
    return torch.cat(parts)


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
    Dispatch n draws every kind's delays from seed ``0x5EEDC0DE + n``."""

    def __init__(
        self, specs, steps: int = 1, dt: float = 0.0, device="cuda",
    ) -> None:
        self.device = torch.device(device)
        self.specs = [
            cuda_tick.TickSpec(table, hb_interval, hb_phases, hb_sel_bit)
            for table, hb_interval, hb_phases, hb_sel_bit in specs
        ]
        self.steps = int(steps)
        self.dt = float(dt)
        self._step_n = 0

    def place(self, state: RowState) -> RowState:
        """``state`` on this kernel's device (a copy unless already there)."""
        return RowState(*(t.to(self.device) for t in state))

    def __call__(self, states, now: float):
        self._step_n += 1
        seed = (cuda_tick.SEED_BASE + self._step_n) & 0xFFFFFFFF
        outs = []
        for st, spec in zip(states, self.specs):
            dirty, deleted, hb, counts = cuda_tick.tick_steps(
                st, spec, now, seed, self.steps, self.dt
            )
            outs.append(TickOutputs(
                state=st, dirty=dirty, deleted=deleted, hb_fired=hb,
                transitions=counts[0], heartbeats=counts[1],
            ))
        return tuple(outs), Wire(pack_wire(outs))


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


def gather_deadlines(state: RowState):
    """Host numpy copies of the device-owned fields a checkpoint records,
    ``(fire_at, hb_due, gen, phase)`` (resilience/checkpoint.py). The
    phase is the device's too: a row the last dispatch fired holds its
    new phase here before the host mirror (``phase_h``) catches up at
    the consume, and the entry must describe one moment of the row.

    On a CUDA device the four copies go out together on the current
    stream (the tick thread's: they read the state its queued dispatches
    produce) into pinned buffers, one event marks their end, and the host
    waits once. Call it on the thread that owns the state."""
    fields = (state.fire_at, state.hb_due, state.gen, state.phase)
    if state.device.type != "cuda":
        return tuple(t.numpy().copy() for t in fields)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in fields]
    for h, t in zip(host, fields):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(state.device))
    done.synchronize()
    return tuple(h.numpy() for h in host)
