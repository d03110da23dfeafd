"""The tick kernel: K fused lifecycle substeps, and the dispatch's wire.

Three pieces, side by side:

- ``csrc/tick.cu``: the hand-written CUDA kernel for Hopper (``sm_90a``),
  one thread per row, all K substeps in registers. It replaces the Pallas
  TPU kernel ``kwok_tpu/ops/pallas_tick.py::_kernel`` and the XLA program
  that packs the wire around it. Built with nvcc into a shared library
  with a plain C interface at first use (``kwok_tpu_torch/_build/``) and
  bound with ctypes. Two entries share its per-row substeps: the fused
  dispatch (one launch for every kind that writes the packed wire, then
  a one-block epilogue for the wire's header and shared mask bytes) and
  the per-kind launch (masks as bytes).
- the plain versions: ``tick_steps_plain`` (the substeps in plain torch
  operations, with the same counter-hash RNG and the same float32
  rounding) and ``pack_wire`` (the wire from the plain masks and rows),
  for CPU tensors and as the kernel's yardstick on the card.
- the wrappers on ``tick_steps``: ``tick_steps(state, spec, ...)`` for
  one kind and ``tick_dispatch(states, specs, ...)`` for a whole
  dispatch (``tick_dispatch_part`` and ``tick_wire_epilogue`` for the row
  split). Each checks device, dtype, contiguity and capacity, then
  launches the kernel for CUDA tensors and runs the plain version for
  CPU tensors only. Nothing falls back: a CUDA tensor either launches
  the kernel or raises. ``tick_steps.launches`` counts launches of
  either entry (the epilogue is part of its dispatch and adds none).

The state is updated in place (the JAX package returned new, donated
buffers). Seeds follow ``PallasTickKernel``: dispatch n draws from seed
``0x5EEDC0DE + n``; the weighted draw uses ``seed ^ 0x55AA55AA``; the
stream index is the flat row id, so a port dispatch and a
``PallasTickKernel(interpret=True)`` call under the same seed agree bit
for bit wherever the arithmetic allows (exponential delays go through
``log`` and agree to an ulp-level tolerance). ``row_base`` makes that id
global under the row split (``parallel/sharded_tick.py``): a shard
launched on its own rows with ``row_base`` at its first global row draws
what the unsplit launch draws for those rows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

from kwok_tpu_torch.models.compiler import CompiledRules
from kwok_tpu_torch.ops.state import TORCH_DTYPES, RowState, TickOutputs

MAX_RULES = 32
# rule-table rows, in the order csrc/tick.cu's RuleRow enum reads them
_TABLE_ROWS = (
    "from_mask", "deletion", "selector_bit", "delay_kind", "delay_a",
    "delay_b", "to_phase", "cond_assign", "cond_value", "is_delete", "weight",
)
SEED_BASE = 0x5EEDC0DE
WEIGHT_SEED_XOR = 0x55AA55AA
_M32 = 0xFFFFFFFF
INF = float("inf")
# csrc/tick.cu's layout constants (checked against the library at load)
THREADS = 256  # rows a block of the kernel ticks
RECORD_WORDS = 16  # int32 words a fused block leaves for the epilogue
DESC_WORDS = 23  # int64 words of one kind's descriptor
MAX_KINDS = 8  # kinds one fused launch takes

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tick.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: now0 + s*dt and a + (b-a)*u must round like the
    # reference, or now >= fire_at can flip at a substep boundary
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class TickSpec:
    """One kind's compiled rule table plus its heartbeat wheel settings —
    the arguments ``PallasTickKernel.__init__`` takes, minus steps/dt.

    Holds the table as the kernel's packed int32 words (floats as their
    bits) and as per-rule tensors for the plain version, cached per
    device."""

    def __init__(
        self,
        table: CompiledRules,
        hb_interval: float = 30.0,
        hb_phases: tuple[str, ...] = (),
        hb_sel_bit: int = -1,
    ) -> None:
        n = int(table.num_rules)
        if n > MAX_RULES:
            raise ValueError(f"{n} rules; the tick kernel takes at most {MAX_RULES}")
        self.table = table
        self.num_rules = n
        self.has_weights = bool((np.asarray(table.weight) > 0).any())
        mask = 0
        for p in hb_phases:
            mask |= 1 << table.space.phase_id(p)
        self.hb_phase_mask = mask
        self.hb_sel_bit = int(hb_sel_bit)
        self.hb_interval = float(hb_interval)
        words = np.zeros((len(_TABLE_ROWS), MAX_RULES), np.int32)
        for i, name in enumerate(_TABLE_ROWS):
            col = np.asarray(getattr(table, name))
            if col.dtype == np.float32:
                words[i, :n] = col.view(np.int32)
            else:
                words[i, :n] = col.astype(np.int64).astype(np.uint32).view(np.int32)
        self.words = words.reshape(-1)
        # the last words of the kind's fused-dispatch descriptor
        self.desc_tail = [
            n, int(self.has_weights), self.hb_sel_bit, mask & _M32,
            int(np.float32(self.hb_interval).view(np.uint32)),
        ]
        self._cache: dict = {}

    def packed(self, device: torch.device) -> torch.Tensor:
        """The kernel's rule table on ``device`` (int32 words)."""
        key = ("packed", str(device))
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = torch.from_numpy(self.words.copy()).to(device)
        return t

    def tensors(self, device: torch.device) -> dict:
        """Per-rule tables for the plain version on ``device``."""
        key = ("plain", str(device))
        t = self._cache.get(key)
        if t is None:
            tb = self.table
            t = self._cache[key] = {
                "delay_kind": torch.as_tensor(
                    np.asarray(tb.delay_kind, np.int32), device=device),
                "delay_a": torch.as_tensor(
                    np.asarray(tb.delay_a, np.float32), device=device),
                "delay_b": torch.as_tensor(
                    np.asarray(tb.delay_b, np.float32), device=device),
                "to_phase": torch.as_tensor(
                    np.asarray(tb.to_phase, np.int32), device=device),
                "cond_assign": torch.as_tensor(
                    np.asarray(tb.cond_assign, np.uint32).view(np.int32),
                    device=device),
                "cond_value": torch.as_tensor(
                    np.asarray(tb.cond_value, np.uint32).view(np.int32),
                    device=device),
                "is_delete": torch.as_tensor(
                    np.asarray(tb.is_delete, bool), device=device),
            }
        return t


# ------------------------------------------------------------ plain version


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64
    overflow: the constant is split in 16-bit halves."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit xorshift-multiply finalizer, in int64 masked to
    32 bits (torch has no uint32 shifts on the CPU)."""
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def _uniform01(gid: torch.Tensor, step: int, seed: int) -> torch.Tensor:
    """u in [1e-7, 1) float32 from (row id, substep, seed)."""
    salt = ((step * 0x9E3779B9) & _M32) ^ (seed & _M32)
    h = _mix(gid ^ salt)
    f = ((h >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=1e-7)


def _f32(x: float) -> float:
    """Round a Python float to the nearest float32 value."""
    return float(np.float32(x))


def tick_steps_plain(
    state: RowState, spec: TickSpec, now0: float, seed: int, steps: int,
    dt: float, row_base: int = 0,
):
    """K substeps of one kind in plain torch, updating ``state`` in place;
    row ``j`` draws as global row ``row_base + j``.

    Returns ``(dirty, deleted, hb_fired, counts)``: three bool masks OR'd
    over the substeps and int32 ``[transitions, heartbeats]``. The
    arithmetic is the kernel's: float32 throughout, one rounding per
    operation, the same hash RNG."""
    dev = state.device
    cap = state.capacity
    f32 = torch.float32
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    active = state.active
    has_del = state.has_deletion
    sel = state.sel_bits
    phase = state.phase.clone()
    cond = state.cond_bits.clone()
    pend = state.pending_rule.clone()
    fire = state.fire_at.clone()
    hb_due = state.hb_due.clone()
    gen = state.gen.clone()
    gid = torch.arange(cap, dtype=torch.int64, device=dev) + int(row_base)
    seed = int(seed) & _M32
    tb = spec.table
    nr = spec.num_rules
    tabs = spec.tensors(dev) if nr else None
    zero_b = torch.zeros(cap, dtype=torch.bool, device=dev)
    dirty_acc = zero_b.clone()
    del_acc = zero_b.clone()
    hb_acc = zero_b.clone()
    trans = 0
    hbs = 0
    now0_32 = np.float32(now0)
    dt_32 = np.float32(dt)
    ivl = np.float32(spec.hb_interval)
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    for s in range(steps):
        now = np.float32(now0_32 + np.float32(np.float32(s) * dt_32))
        now_t = torch.tensor(float(now), dtype=f32, device=dev)
        if nr:
            phase64 = phase.to(torch.int64)
            best = torch.full((cap,), -1, dtype=torch.int32, device=dev)
            matches = []
            for r in range(nr):
                fm = int(tb.from_mask[r])
                phase_ok = ((fm >> phase64) & 1) == 1
                dm = int(tb.deletion[r])
                m = active & phase_ok
                if dm != -1:
                    m = m & (has_del == (dm == 1))
                sb = int(tb.selector_bit[r])
                if sb >= 0:
                    m = m & (((sel >> sb) & 1) == 1) if sb < 32 else zero_b
                matches.append(m)
                best = torch.where((best < 0) & m, r, best)
            if spec.has_weights:
                zf = torch.zeros(cap, dtype=f32, device=dev)
                w = [torch.tensor(float(x), dtype=f32, device=dev)
                     for x in np.asarray(tb.weight, np.float32)[:nr]]
                total = zf
                for r in range(nr):
                    total = total + torch.where(matches[r], w[r], zf)
                u2 = _uniform01(gid, s, seed ^ WEIGHT_SEED_XOR)
                target = u2 * total
                cum = zf
                chosen = torch.full((cap,), -1, dtype=torch.int32, device=dev)
                wbest = zf
                wpend = zf
                pend_m = zero_b
                for r in range(nr):
                    cum = cum + torch.where(matches[r], w[r], zf)
                    chosen = torch.where((chosen < 0) & (cum > target), r, chosen)
                    wbest = torch.where(best == r, w[r], wbest)
                    psel = pend == r
                    pend_m = pend_m | (psel & matches[r])
                    wpend = torch.where(psel, w[r], wpend)
                use_weighted = (best >= 0) & (wbest > 0)
                pend_valid = (pend >= 0) & pend_m & (wpend > 0)
                best = torch.where(
                    use_weighted, torch.where(pend_valid, pend, chosen), best
                )

            rearm = active & (best != pend) & (best >= 0)
            rid = torch.clamp(best, min=0).to(torch.int64)
            dk = tabs["delay_kind"][rid]
            a = tabs["delay_a"][rid]
            b = tabs["delay_b"][rid]
            u = _uniform01(gid, s, seed)
            d_uniform = a + (b - a) * u
            d_exp = (-a) * torch.log(u)
            d_exp = torch.where(b > 0, torch.minimum(d_exp, b), d_exp)
            delay = torch.where(dk == 0, a, torch.where(dk == 1, d_uniform, d_exp))
            pend = torch.where(active, best, neg1)
            fire = torch.where(
                rearm, now_t + delay, torch.where(pend >= 0, fire, inf)
            )

            can_fire = active & (pend >= 0) & (now_t >= fire)
            frid = torch.clamp(pend, min=0).to(torch.int64)
            fired_delete = can_fire & tabs["is_delete"][frid]
            phase = torch.where(can_fire, tabs["to_phase"][frid], phase)
            cond = torch.where(
                can_fire,
                (cond & ~tabs["cond_assign"][frid]) | tabs["cond_value"][frid],
                cond,
            )
            pend = torch.where(can_fire, neg1, pend)
            fire = torch.where(can_fire, inf, fire)
            gen = gen + can_fire.to(torch.int32)
            dirty = can_fire & ~fired_delete
        else:
            can_fire = zero_b
            dirty = zero_b
            fired_delete = zero_b

        # heartbeat wheel (schedule-anchored, Go time.Ticker semantics)
        if spec.hb_phase_mask == 0 and spec.hb_sel_bit < 0:
            hb_on = zero_b
        else:
            hb_on = active
            if spec.hb_phase_mask != 0:
                hb_on = hb_on & (
                    ((spec.hb_phase_mask >> phase.to(torch.int64)) & 1) == 1
                )
            if spec.hb_sel_bit >= 0:
                hb_on = hb_on & (
                    (((sel >> spec.hb_sel_bit) & 1) == 1)
                    if spec.hb_sel_bit < 32 else zero_b
                )
        entered = hb_on & torch.isinf(hb_due)
        hb_fired = hb_on & (now_t >= hb_due)
        on_schedule = (now_t - hb_due) < float(ivl)
        now_ivl = torch.tensor(float(np.float32(now + ivl)), dtype=f32, device=dev)
        hb_due = torch.where(
            ~hb_on,
            inf,
            torch.where(
                entered,
                now_ivl,
                torch.where(
                    hb_fired,
                    torch.where(on_schedule, hb_due + float(ivl), now_ivl),
                    hb_due,
                ),
            ),
        )

        dirty_acc |= dirty
        del_acc |= fired_delete
        hb_acc |= hb_fired
        trans = trans + can_fire.sum()
        hbs = hbs + hb_fired.sum()

    state.phase.copy_(phase)
    state.cond_bits.copy_(cond)
    state.pending_rule.copy_(pend)
    state.fire_at.copy_(fire)
    state.hb_due.copy_(hb_due)
    state.gen.copy_(gen)
    counts = torch.stack([
        torch.as_tensor(trans, device=dev), torch.as_tensor(hbs, device=dev)
    ]).to(torch.int32)
    return dirty_acc, del_acc, hb_acc, counts


# -------------------------------------------------------- the plain wire


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


def pack_wire(outs, dues=None, rows=None) -> torch.Tensor:
    """The pack_rows wire of a dispatch's per-kind TickOutputs, as one
    uint8 tensor on their device: the fused kernel's plain version.
    ``dues`` (0-d ``next_due`` per kind) and ``rows`` (``(phase,
    cond_bits)`` per kind) default to those of the outputs' states; a
    split dispatch passes them gathered."""
    counters = torch.stack(
        [o.transitions for o in outs] + [o.heartbeats for o in outs]
    ).to(torch.int32)
    if dues is None:
        dues = [next_due(o.state) for o in outs]
    if rows is None:
        rows = [(o.state.phase, o.state.cond_bits) for o in outs]
    dues = torch.stack(dues).to(torch.float32)
    parts = [counters.view(torch.uint8), dues.view(torch.uint8)]
    for o in outs:
        parts.append(packbits(torch.cat([o.dirty, o.deleted, o.hb_fired])))
    for phase, cond in rows:
        parts.append(phase.to(torch.uint8))
        # an empty tensor may carry a stride that refuses the byte view
        parts.append(cond.view(torch.uint8) if cond.numel() else phase.new_empty(0, dtype=torch.uint8))
    return torch.cat(parts)


class WireLayout(NamedTuple):
    """Byte offsets of a wire over kinds of ``capacities`` rows (the
    offsets ``ops/tick.unpack_wire`` reads)."""

    capacities: tuple
    nbytes: int
    mask_offs: tuple  # per kind: its (3*cap+7)//8 mask bytes
    phase_offs: tuple  # per kind: cap phase bytes
    cond_offs: tuple  # per kind: cap little-endian uint32 words


def wire_layout(capacities) -> WireLayout:
    """The wire's layout: the int32 counters (2 per kind) and float32 dues
    (1 per kind), the mask segments, then each kind's phase and cond rows."""
    caps = tuple(int(c) for c in capacities)
    off = 12 * len(caps)
    mask_offs = []
    for cap in caps:
        mask_offs.append(off)
        off += (3 * cap + 7) // 8
    phase_offs, cond_offs = [], []
    for cap in caps:
        phase_offs.append(off)
        cond_offs.append(off + cap)
        off += 5 * cap
    return WireLayout(caps, off, tuple(mask_offs), tuple(phase_offs), tuple(cond_offs))


def blocks_of(capacities) -> int:
    """Blocks of a fused launch over kinds of ``capacities`` rows: the
    records it leaves for the epilogue."""
    return sum((int(c) + THREADS - 1) // THREADS for c in capacities)


# ------------------------------------------------------------------ kernel


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the tick kernel builds only where the CUDA toolkit is installed")


def build_library() -> tuple[str, str]:
    """Compile csrc/tick.cu (if its build is missing) into
    ``_build/libkwok_tick-<source hash>.so``. Returns (path, compiler
    log); the log is empty when the library was already built."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libkwok_tick-{digest}.so")
    if os.path.exists(path):
        return path, ""
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, (proc.stdout + proc.stderr).strip()


class TickSteps:
    """The per-kind tick wrapper: ``tick_steps(state, spec, now0, seed,
    steps, dt, row_base=0)``; the fused dispatch's wrappers
    (``tick_dispatch``, ``tick_dispatch_part``, ``tick_wire_epilogue``)
    share its library and its count.

    ``launches`` counts kernel launches of either entry (CUDA tensors
    only; the plain version on CPU tensors adds nothing; the fused
    dispatch's epilogue belongs to its launch and adds nothing).
    ``build_log`` keeps nvcc's output (``-Xptxas -v``: registers, shared
    memory, spills) of the build this process made, ``build_seconds`` its
    time and ``library_path`` the library loaded."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self.library_path = ""
        self._lib = None
        self._lock = threading.Lock()

    def library(self):
        """Build (at first use) and load the kernel's shared library."""
        with self._lock:
            if self._lib is None:
                import time

                t0 = time.perf_counter()
                path, log = build_library()
                self.build_seconds = time.perf_counter() - t0
                self.build_log = log
                self.library_path = path
                lib = ctypes.CDLL(path)
                vp, ci, cu, cf = (
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                )
                lib.kwok_tick_launch.argtypes = [
                    ci, ci, ci, cf, cf, cu, ci, ci, cf, cu, ci,
                ] + [vp] * 15
                lib.kwok_tick_launch.restype = ci
                lib.kwok_tick_dispatch.argtypes = [vp, ci, ci, cf, cf, cu, vp, vp, vp]
                lib.kwok_tick_dispatch.restype = ci
                lib.kwok_tick_epilogue.argtypes = [vp, vp, ci, ci, ci, vp]
                lib.kwok_tick_epilogue.restype = ci
                lib.kwok_tick_table_words.argtypes = []
                lib.kwok_tick_table_words.restype = ci
                lib.kwok_tick_constant.argtypes = [ci]
                lib.kwok_tick_constant.restype = ci
                agreed = (
                    ("table words", lib.kwok_tick_table_words(), len(_TABLE_ROWS) * MAX_RULES),
                    ("threads", lib.kwok_tick_constant(0), THREADS),
                    ("record words", lib.kwok_tick_constant(1), RECORD_WORDS),
                    ("descriptor words", lib.kwok_tick_constant(2), DESC_WORDS),
                    ("kinds", lib.kwok_tick_constant(3), MAX_KINDS),
                )
                for what, got, want in agreed:
                    if got != want:
                        raise RuntimeError(
                            f"tick kernel's {what}: {got}, the wrapper's {want}"
                        )
                self._lib = lib
            return self._lib

    @staticmethod
    def check(state: RowState, row_base: int = 0) -> None:
        """Raise unless every field lies on one device, has the layout's
        dtype, is contiguous and 1-D, and all share one capacity, and the
        global row ids ``[row_base, row_base + capacity)`` fit an int32."""
        dev = state.device
        cap = state.capacity
        if row_base < 0 or row_base + cap >= 2**31:
            raise ValueError(
                f"rows [{row_base}, {row_base + cap}) exceed the kernel's int32 row index"
            )
        for name in RowState._fields:
            t = getattr(state, name)
            if t.device != dev:
                raise ValueError(f"{name} on {t.device}, state on {dev}")
            if t.dtype != TORCH_DTYPES[name]:
                raise TypeError(f"{name} is {t.dtype}, expected {TORCH_DTYPES[name]}")
            if t.dim() != 1 or t.shape[0] != cap:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({cap},)")
            if not t.is_contiguous():
                raise ValueError(f"{name} is not contiguous")

    def __call__(
        self, state: RowState, spec: TickSpec, now0: float, seed: int,
        steps: int, dt: float, row_base: int = 0,
    ):
        row_base = int(row_base)
        self.check(state, row_base)
        dev = state.device
        if dev.type == "cpu":
            # kwoklint: disable=kernel-purity -- CPU tensors only: the plain version's host scalars and small tables are copies within host memory, and a CUDA tensor never reaches this call
            return tick_steps_plain(state, spec, now0, seed, steps, dt, row_base)
        if dev.type != "cuda":
            raise ValueError(f"tick kernel runs on cuda tensors, got {dev}")
        # kwoklint: disable=kernel-purity -- the build and load run once per process, under _lock: ClusterEngine._warm_tick, LaneSet._warm_tick and FederatedEngine._warm_ticks load the library before any worker starts, and ProcLaneSet.prepare builds it, so at most a process-lane coordinator's first dispatch loads it (a dlopen); later dispatches read the loaded library back
        lib = self.library()
        cap = state.capacity
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            rules = spec.packed(dev)
            dirty = torch.empty(cap, dtype=torch.uint8, device=dev)
            deleted = torch.empty(cap, dtype=torch.uint8, device=dev)
            hb = torch.empty(cap, dtype=torch.uint8, device=dev)
            counts = torch.zeros(2, dtype=torch.int32, device=dev)
            err = lib.kwok_tick_launch(
                cap, row_base, int(steps), float(np.float32(now0)), float(np.float32(dt)),
                int(seed) & _M32, spec.num_rules, int(spec.has_weights),
                float(np.float32(spec.hb_interval)), spec.hb_phase_mask & _M32,
                spec.hb_sel_bit,
                rules.data_ptr(), state.active.data_ptr(),
                state.has_deletion.data_ptr(), state.sel_bits.data_ptr(),
                state.phase.data_ptr(), state.cond_bits.data_ptr(),
                state.pending_rule.data_ptr(), state.fire_at.data_ptr(),
                state.hb_due.data_ptr(), state.gen.data_ptr(),
                dirty.data_ptr(), deleted.data_ptr(), hb.data_ptr(),
                counts.data_ptr(), stream.cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"tick kernel launch failed: cudaError {err}")
        self.launches += 1
        return (
            dirty.view(torch.bool), deleted.view(torch.bool),
            hb.view(torch.bool), counts,
        )


#: the process's tick wrapper; ``tick_steps.launches`` counts launches
tick_steps = TickSteps()


def tick_dispatch(
    states, specs, now0: float, seed: int, steps: int, dt: float,
    row_bases=None,
):
    """One dispatch of every kind: ``(outs, wire)``, ``wire`` the
    dispatch's packed wire (uint8, on the states' device; the layout
    of ``wire_layout``) and ``outs`` a TickOutputs per kind. Kind
    ``k``'s row ``j`` draws as global row ``row_bases[k] + j``.

    CUDA tensors: one fused launch and its epilogue write the wire and
    nothing else runs on the device; each TickOutputs carries the
    counters as 0-d int32 views of the wire's header and no masks
    (``None``: ``unpack_wire`` reads them off the wire). CPU tensors:
    the plain version, ``tick_steps_plain`` per kind then
    ``pack_wire``, with the masks."""
    states = tuple(states)
    n = len(states)
    if n != len(specs):
        raise ValueError(f"{n} states for {len(specs)} specs")
    if row_bases is None:
        row_bases = (0,) * n
    row_bases = tuple(int(b) for b in row_bases)
    dev = states[0].device
    for st, rb in zip(states, row_bases):
        tick_steps.check(st, rb)
        if st.device != dev:
            raise ValueError(f"kinds on {st.device} and {dev}")
    if dev.type == "cpu":
        outs = []
        for st, spec, rb in zip(states, specs, row_bases):
            # kwoklint: disable=kernel-purity -- CPU tensors only: the plain version's host scalars and small tables are copies within host memory, and a CUDA tensor never reaches this call
            d, x, h, c = tick_steps_plain(st, spec, now0, seed, steps, dt, rb)
            outs.append(TickOutputs(st, d, x, h, c[0], c[1]))
        return tuple(outs), pack_wire(outs)
    if dev.type != "cuda":
        raise ValueError(f"tick kernel runs on cuda tensors, got {dev}")
    layout = wire_layout([st.capacity for st in states])
    blocks = blocks_of(layout.capacities)
    with torch.cuda.device(dev):
        wire = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
        records = torch.empty(
            max(blocks, 1) * RECORD_WORDS, dtype=torch.int32, device=dev
        )
        tick_dispatch_part(
            states, specs, now0, seed, steps, dt, row_bases, (0,) * n,
            layout, wire, records,
        )
        tick_wire_epilogue(wire, records, blocks, n, any(c % 8 for c in layout.capacities))
    header = wire[: 8 * n].view(torch.int32)
    outs = tuple(
        TickOutputs(st, None, None, None, header[k], header[n + k])
        for k, st in enumerate(states)
    )
    return outs, wire


def tick_dispatch_part(
    states, specs, now0: float, seed: int, steps: int, dt: float,
    row_bases, wire_rows, layout: WireLayout, wire: torch.Tensor,
    records: torch.Tensor,
) -> None:
    """The fused launch alone (no epilogue), on the current stream of
    the states' card: kind ``k``'s rows, drawing as global rows from
    ``row_bases[k]``, written as rows ``[wire_rows[k], wire_rows[k] +
    capacity)`` of a wire laid out as ``layout`` into ``wire``, and
    ``blocks_of`` of the capacities records into ``records``. The row
    split launches one per shard, then one ``tick_wire_epilogue`` over
    every shard's records. CUDA tensors only."""
    states = tuple(states)
    n = len(states)
    if not 0 < n <= MAX_KINDS or n != len(specs) or n != len(layout.capacities):
        raise ValueError(f"{n} kinds, {len(specs)} specs, a wire of "
                         f"{len(layout.capacities)} (at most {MAX_KINDS})")
    dev = wire.device
    if dev.type != "cuda":
        raise ValueError(f"the fused tick runs on cuda tensors, got {dev}")
    if wire.dtype != torch.uint8 or wire.dim() != 1 or not wire.is_contiguous() \
            or int(wire.shape[0]) != layout.nbytes or layout.nbytes >= 2**31:
        raise ValueError(f"wire of {tuple(wire.shape)} {wire.dtype}, want "
                         f"({layout.nbytes},) uint8 below 2**31 bytes")
    blocks = blocks_of(st.capacity for st in states)
    if records.dtype != torch.int32 or records.device != dev \
            or not records.is_contiguous() or int(records.numel()) < blocks * RECORD_WORDS:
        raise ValueError(f"records hold {records.numel()} {records.dtype}, want "
                         f"{blocks * RECORD_WORDS} int32 on {dev}")
    words = []
    for k, (st, spec, rb, wr) in enumerate(zip(states, specs, row_bases, wire_rows)):
        rb, wr = int(rb), int(wr)
        tick_steps.check(st, rb)
        if st.device != dev:
            raise ValueError(f"kind {k} on {st.device}, the wire on {dev}")
        if wr < 0 or wr + st.capacity > layout.capacities[k]:
            raise ValueError(f"kind {k}: rows [{wr}, {wr + st.capacity}) outside "
                             f"its {layout.capacities[k]} wire rows")
        words += [t.data_ptr() for t in (
            st.active, st.has_deletion, st.sel_bits, st.phase, st.cond_bits,
            st.pending_rule, st.fire_at, st.hb_due, st.gen,
        )]
        words += [
            spec.packed(dev).data_ptr(), layout.mask_offs[k],
            layout.phase_offs[k], layout.cond_offs[k], st.capacity, rb, wr,
            layout.capacities[k], k,
        ]
        words += spec.desc_tail
    desc = np.array(words, dtype=np.int64)
    # kwoklint: disable=kernel-purity -- the library is loaded once per process under _lock before any dispatch (the engines' _warm_tick, ProcLaneSet.prepare); later dispatches read it back
    lib = tick_steps.library()
    with torch.cuda.device(dev):
        err = lib.kwok_tick_dispatch(
            desc.ctypes.data, n, int(steps), float(np.float32(now0)),
            float(np.float32(dt)), int(seed) & _M32, wire.data_ptr(),
            records.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused tick kernel launch failed: cudaError {err}")
    if blocks:
        tick_steps.launches += 1


def tick_wire_epilogue(wire: torch.Tensor, records: torch.Tensor, n_blocks: int,
                       n_kinds: int, edges: bool = True) -> None:
    """The fused dispatch's one-block epilogue on the current stream of
    the wire's card: the header of ``n_kinds`` kinds from ``n_blocks``
    records (of one or several ``tick_dispatch_part`` launches, ordered
    before it on this stream) and, with ``edges``, the mask bytes they
    share. ``edges`` may be False only when every launch's rows of every
    kind start and end on a byte of the mask runs (their wire row, count
    and the kind's wire rows all multiples of 8): then no byte is shared."""
    dev = wire.device
    if dev.type != "cuda" or records.device != dev or wire.data_ptr() % 4 \
            or records.data_ptr() % 16:
        raise ValueError(f"the epilogue wants a 4-aligned wire and 16-aligned records "
                         f"on one card, got {dev} and {records.device}")
    if int(records.numel()) < n_blocks * RECORD_WORDS:
        raise ValueError(f"{records.numel()} record words for {n_blocks} blocks")
    # kwoklint: disable=kernel-purity -- the library is loaded once per process under _lock before any dispatch (the engines' _warm_tick, ProcLaneSet.prepare); later dispatches read it back
    lib = tick_steps.library()
    with torch.cuda.device(dev):
        err = lib.kwok_tick_epilogue(
            wire.data_ptr(), records.data_ptr(), int(n_blocks), int(n_kinds),
            int(bool(edges)), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"tick wire epilogue launch failed: cudaError {err}")
