"""Runtime shm-protocol witness: instrumented banks/rings/slots.

The static rule (``analysis/shmproto.py``) proves the store ORDER the
source prescribes; this proves what the objects of the port's
``kwok_tpu_torch.engine.shm`` DO under load and under the torn-write
fault twins. While installed, every ``MetricsBank``, ``InflightSlot``,
and ``RawRing`` method call is wrapped and checked against the
protocol's observable contract:

* **seq discipline** — a completed ``write`` must leave the slab with an
  EVEN seq strictly greater than before (monotone: a regressing stamp
  would re-expose a retired snapshot); a ``torn_write`` must leave it
  ODD (a torn twin that restamps even hides the very crash it injects;
  this is the "no even-stamped torn read" half of the contract).
* **no torn reads** — ``read`` may only return ``None`` or a payload
  some completed ``write`` actually published on that instance; a slab
  assembled from a torn prefix is the bug the seqlock exists to prevent.
* **slot outcome** — after ``arm``, ``peek`` returns exactly the armed
  bytes; after ``torn_arm``, the slot must park EMPTY (state 0, peek
  ``None``): the disarm-first ordering made observable.
* **ring publication** — a successful ``try_write`` must have advanced
  the W cursor past the blob before returning (publish-after-copy), and
  ``read(offset, length)`` must return byte-identical data to what was
  written at that offset.

Witnessing is per-process: a bank attached from another process has no
recorded publications, so its reads are only checked for protocol
invariants that need no history (parity, monotonicity). Usable directly
as::

    with witness_shm() as w:
        ...exercise banks/rings/slots...
    w.assert_clean()  # AssertionError with call stacks

or over a pytest run with ``KWOK_TPU_TORCH_SHM_WITNESS=1 python -m
pytest -p tests.torch_witness tests/test_torch_proclanes.py``.
"""

from __future__ import annotations

import threading

from kwok_tpu_torch.analysis.witness import Violation, _stack

_STATE_ATTR = "_kwok_shm_witness"
_MAX_PUBLISHED = 64  # per instance; tests publish far fewer


class _InstanceState:
    """Per-object witness memory (publications + last stamps)."""

    __slots__ = ("published", "order", "armed", "ring", "last_even_seq")

    def __init__(self) -> None:
        self.published: set = set()   # bank payloads completed writes put out
        self.order: list = []         # publication order, for bounding
        self.armed: "bytes | None" = None
        self.ring: dict = {}          # offset -> bytes
        self.last_even_seq = 0

    def publish(self, payload: bytes) -> None:
        self.published.add(payload)
        self.order.append(payload)
        while len(self.order) > _MAX_PUBLISHED:
            old = self.order.pop(0)
            if old not in self.order:
                self.published.discard(old)


def _state(obj) -> _InstanceState:
    st = getattr(obj, _STATE_ATTR, None)
    if st is None:
        st = _InstanceState()
        setattr(obj, _STATE_ATTR, st)
    return st


class ShmWitness:
    """Protocol-outcome recorder for the shm substrate."""

    _installed: "ShmWitness | None" = None
    _originals: dict = {}

    def __init__(self) -> None:
        self._vio_lock = threading.Lock()
        self.violations: list = []

    def _violate(self, kind: str, message: str) -> None:
        with self._vio_lock:
            self.violations.append(
                Violation(kind, message, [("call site", _stack(3))])
            )

    # ------------------------------------------------------------ seqlock

    def on_write(self, orig, bank, payload: bytes) -> bool:
        hdr = bank.arena.hdr
        seq0 = int(hdr[bank.SEQ])
        ok = orig(bank, payload)
        if not ok:
            return ok
        seq1 = int(hdr[bank.SEQ])
        if seq1 % 2:
            self._violate(
                "seqlock-open",
                f"MetricsBank.write left seq odd ({seq1}): the slab "
                "reads as mid-write forever",
            )
        if seq1 <= seq0:
            self._violate(
                "seqlock-monotonic",
                f"MetricsBank.write moved seq {seq0} -> {seq1}: a "
                "non-advancing stamp re-exposes a retired snapshot",
            )
        st = _state(bank)
        st.publish(bytes(payload))
        st.last_even_seq = seq1
        return ok

    def on_torn_write(self, orig, bank, payload: bytes) -> None:
        orig(bank, payload)
        seq = int(bank.arena.hdr[bank.SEQ])
        if len(payload) <= bank.cap and seq % 2 == 0:
            self._violate(
                "torn-even-stamp",
                f"MetricsBank.torn_write left seq EVEN ({seq}): readers "
                "will consume the torn prefix as a consistent snapshot",
            )
        return None

    def on_read(self, orig, bank, *args, **kwargs):
        out = orig(bank, *args, **kwargs)
        st = getattr(bank, _STATE_ATTR, None)
        if out is not None and st is not None and st.published:
            if bytes(out) not in st.published:
                self._violate(
                    "torn-read",
                    "MetricsBank.read returned a payload no completed "
                    "write published (torn or interleaved slab of "
                    f"{len(out)}B)",
                )
        return out

    def on_reset(self, orig, bank) -> None:
        orig(bank)
        st = getattr(bank, _STATE_ATTR, None)
        if st is not None:
            st.published.clear()
            st.order.clear()
            st.last_even_seq = 0

    # --------------------------------------------------------------- slot

    def on_arm(self, orig, slot, payload: bytes) -> bool:
        ok = orig(slot, payload)
        st = _state(slot)
        if ok:
            st.armed = bytes(payload)
            hdr = slot.arena.hdr
            if int(hdr[slot.STATE]) != 1 or int(hdr[slot.LEN]) != len(
                payload
            ):
                self._violate(
                    "slot-arm",
                    "InflightSlot.arm returned True but the slot is not "
                    f"armed over {len(payload)}B (state="
                    f"{int(hdr[slot.STATE])}, len={int(hdr[slot.LEN])})",
                )
        return ok

    def on_torn_arm(self, orig, slot, payload: bytes) -> None:
        orig(slot, payload)
        if int(slot.arena.hdr[slot.STATE]) != 0:
            self._violate(
                "torn-armed",
                "InflightSlot.torn_arm left state != 0: a torn re-arm "
                "must park as empty (disarm-first ordering broken)",
            )
        return None

    def on_clear(self, orig, slot) -> None:
        orig(slot)
        st = getattr(slot, _STATE_ATTR, None)
        if st is not None:
            st.armed = None

    def on_peek(self, orig, slot):
        out = orig(slot)
        st = getattr(slot, _STATE_ATTR, None)
        if out is not None and st is not None and st.armed is not None:
            if bytes(out) != st.armed:
                self._violate(
                    "slot-peek",
                    "InflightSlot.peek returned bytes that differ from "
                    "the armed payload (replay would emit a torn batch)",
                )
        return out

    # --------------------------------------------------------------- ring

    def on_try_write(self, orig, ring, blob):
        off = orig(ring, blob)
        if off is None:
            return off
        st = _state(ring)
        st.ring[off] = bytes(blob)
        while len(st.ring) > _MAX_PUBLISHED:
            st.ring.pop(next(iter(st.ring)))
        w = int(ring.arena.hdr[ring.W])
        if w < off + len(blob):
            self._violate(
                "ring-publish",
                f"RawRing.try_write returned offset {off} but W={w} "
                f"< {off + len(blob)}: the descriptor outruns the "
                "published cursor",
            )
        return off

    def on_ring_read(self, orig, ring, offset: int, length: int):
        out = orig(ring, offset, length)
        st = getattr(ring, _STATE_ATTR, None)
        if st is not None and offset in st.ring:
            want = st.ring.pop(offset)
            if bytes(out) != want:
                self._violate(
                    "ring-torn-read",
                    f"RawRing.read({offset}, {length}) returned bytes "
                    "differing from the blob written at that offset",
                )
        return out

    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                "shm-protocol witness recorded "
                f"{len(self.violations)} violation(s):\n\n"
                + "\n\n".join(v.format() for v in self.violations)
            )

    # ---------------------------------------------------------- installation

    @classmethod
    def install(cls) -> "ShmWitness":
        if cls._installed is not None:
            return cls._installed
        from kwok_tpu_torch.engine import shm

        w = cls()
        cls._installed = w

        def wrap(klass, name, hook):
            orig = getattr(klass, name)
            cls._originals[(klass, name)] = orig

            def method(self, *args, **kwargs):
                return hook(orig, self, *args, **kwargs)

            method.__name__ = name
            setattr(klass, name, method)

        wrap(shm.MetricsBank, "write", w.on_write)
        wrap(shm.MetricsBank, "torn_write", w.on_torn_write)
        wrap(shm.MetricsBank, "read", w.on_read)
        wrap(shm.MetricsBank, "reset", w.on_reset)
        wrap(shm.InflightSlot, "arm", w.on_arm)
        wrap(shm.InflightSlot, "torn_arm", w.on_torn_arm)
        wrap(shm.InflightSlot, "clear", w.on_clear)
        wrap(shm.InflightSlot, "peek", w.on_peek)
        wrap(shm.RawRing, "try_write", w.on_try_write)
        wrap(shm.RawRing, "read", w.on_ring_read)
        return w

    @classmethod
    def uninstall(cls) -> None:
        if cls._installed is None:
            return
        for (klass, name), orig in cls._originals.items():
            setattr(klass, name, orig)
        cls._originals.clear()
        cls._installed = None


def witness_shm():
    """Context manager installing a witness (test helper). Joining an
    already-installed witness (the test plugin's) is allowed; only
    the installer uninstalls on exit."""

    class _Ctx:
        def __enter__(self):
            self._owner = ShmWitness._installed is None
            self.w = ShmWitness.install()
            return self.w

        def __exit__(self, *exc):
            if self._owner:
                ShmWitness.uninstall()

    return _Ctx()
