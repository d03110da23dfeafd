"""The tick kernel: K fused lifecycle substeps for one resource kind.

Three pieces, side by side:

- ``csrc/tick.cu``: the hand-written CUDA kernel for Hopper (``sm_90a``),
  one thread per row, all K substeps in registers. It replaces the Pallas
  TPU kernel ``kwok_tpu/ops/pallas_tick.py::_kernel``. Built with nvcc into
  a shared library with a plain C interface at first use
  (``kwok_tpu_torch/_build/``) and bound with ctypes.
- ``tick_steps_plain``: the same function in plain torch operations, with
  the same counter-hash RNG and the same float32 rounding, for CPU tensors
  and as the kernel's yardstick on the card.
- ``tick_steps``: the wrapper. It checks device, dtype, contiguity and
  capacity, then launches the kernel for CUDA tensors and runs the plain
  version for CPU tensors only. Nothing falls back: a CUDA tensor either
  launches the kernel or raises.

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

import numpy as np
import torch

from kwok_tpu_torch.models.compiler import CompiledRules
from kwok_tpu_torch.ops.state import TORCH_DTYPES, RowState

MAX_RULES = 32
# rule-table rows, in the order csrc/tick.cu's RuleRow enum reads them
_TABLE_ROWS = (
    "from_mask", "deletion", "selector_bit", "delay_kind", "delay_a",
    "delay_b", "to_phase", "cond_assign", "cond_value", "is_delete", "weight",
)
SEED_BASE = 0x5EEDC0DE
WEIGHT_SEED_XOR = 0x55AA55AA
_M32 = 0xFFFFFFFF

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
    """The tick wrapper: ``tick_steps(state, spec, now0, seed, steps, dt,
    row_base=0)``.

    ``launches`` counts kernel launches (CUDA tensors only; the plain
    version on CPU tensors adds nothing). ``build_log`` keeps nvcc's
    output (``-Xptxas -v``: registers, shared memory, spills) of the
    build this process made, and ``build_seconds`` its time."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
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
                lib = ctypes.CDLL(path)
                vp, ci, cu, cf = (
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                )
                lib.kwok_tick_launch.argtypes = [
                    ci, ci, ci, cf, cf, cu, ci, ci, cf, cu, ci,
                ] + [vp] * 15
                lib.kwok_tick_launch.restype = ci
                lib.kwok_tick_table_words.argtypes = []
                lib.kwok_tick_table_words.restype = ci
                words = lib.kwok_tick_table_words()
                if words != len(_TABLE_ROWS) * MAX_RULES:
                    raise RuntimeError(
                        f"tick kernel table is {words} words, the wrapper "
                        f"packs {len(_TABLE_ROWS) * MAX_RULES}"
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
