"""Shared-memory arenas for the process lanes (``engine/proclanes.py``);
the port's copy of ``kwok_tpu.engine.shm`` with the same byte layout, so
an arena written by either package reads in the other.

- ``RawRing``: a single-producer/single-consumer byte ring on one
  ``multiprocessing.shared_memory`` segment per lane. The parent's router
  writes each window's raw watch lines ONCE and ships a small
  ``(offset, length, bounds)`` descriptor over the lane's pipe; the child
  maps the same pages and slices the blob out.
- ``InflightSlot``: the emit crash-replay slot. The child parks the
  patches it has in flight BEFORE sending them and clears the slot once
  every one has an HTTP answer, so a SIGKILL mid-send loses no owed
  status: the parent replays the slot before it respawns the lane.
- ``StatusBank``: one int64 row per lane (numpy views over one shared
  buffer): liveness beat, readiness, first re-list progress, managed
  counts, queue depth. The parent's coordinator reads it for the startup
  gate, its gauges and the supervisor's wedged-child check.
- ``MetricsBank``: a seqlock slab per lane holding the child's metrics
  snapshot; the parent merges them into one ``/metrics``.

Lifecycle: the PARENT creates and unlinks every segment; children only
attach and close. Spawned children share the parent's resource-tracker
process, so a SIGKILLed child never takes an arena down with it.
"""

from __future__ import annotations

import logging
import time
import uuid
from multiprocessing import shared_memory

import numpy as np

logger = logging.getLogger("kwok_tpu_torch.shm")

# header slots (int64 each) shared by the ring/slot layouts
_HDR_I64 = 8
_HDR_BYTES = _HDR_I64 * 8


def arena_name(tag: str) -> str:
    """A fresh segment name. The prefix differs from kwok_tpu's
    ("kwoktpu-"), so each package's leftover checks see only its own."""
    return f"kwoktorch-{tag}-{uuid.uuid4().hex[:10]}"


class Arena:
    """One shared_memory segment + a header/payload numpy view split."""

    def __init__(self, name: str, size: int = 0, create: bool = False):
        if create:
            self.shm = shared_memory.SharedMemory(
                name=name, create=True, size=size
            )
        else:
            # attach: the child shares the parent's resource-tracker
            # process (spawn passes the tracker fd), so the segment's
            # tracker entry lives exactly until the parent unlinks
            self.shm = shared_memory.SharedMemory(name=name)
        self.name = name
        self.size = self.shm.size
        self.created = create
        self.hdr = np.frombuffer(
            self.shm.buf, dtype=np.int64, count=_HDR_I64
        )
        self.payload = self.shm.buf[_HDR_BYTES:]

    def close(self, unlink: bool = False) -> None:
        # release the views first: SharedMemory.close() refuses while
        # exported buffers are alive
        self.hdr = None
        self.payload = None
        try:
            self.shm.close()
        except BufferError:
            logger.debug("arena %s still referenced at close", self.name)
            return
        if unlink and self.created:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


class RawRing:
    """SPSC byte ring: the parent writes raw-line blobs, the child reads
    them by (absolute offset, length) descriptors received over its pipe.

    Header: [0]=w total bytes produced (pads included), [1]=r total bytes
    consumed (child-written), [3]=payload capacity (layout check; slot
    [2] is reserved). Blobs never straddle the wrap point: the writer
    pads to the boundary and the descriptor's offset accounts for it, so
    the reader's consume (``r = offset + length``) retires the pad.
    """

    W, R, CAP = 0, 1, 3

    def __init__(self, name: str, size: int = 0, create: bool = False):
        self.arena = Arena(name, size + _HDR_BYTES if create else 0, create)
        self.cap = self.arena.size - _HDR_BYTES
        if create:
            self.arena.hdr[self.CAP] = self.cap
        elif int(self.arena.hdr[self.CAP]) != self.cap:
            raise ValueError(
                f"ring {name}: capacity mismatch "
                f"({self.arena.hdr[self.CAP]} != {self.cap})"
            )
        self.name = name

    # ------------------------------------------------------------ producer

    def free_bytes(self) -> int:
        hdr = self.arena.hdr
        return self.cap - int(hdr[self.W] - hdr[self.R])

    def try_write(self, blob) -> int | None:
        """Append ``blob`` contiguously; returns its absolute offset or
        None when the ring lacks space (the caller paces or drops)."""
        n = len(blob)
        if n > self.cap:
            raise ValueError(f"blob {n}B exceeds ring capacity {self.cap}B")
        hdr = self.arena.hdr
        w = int(hdr[self.W])
        pos = w % self.cap
        pad = self.cap - pos if pos + n > self.cap else 0
        if self.cap - int(w - hdr[self.R]) < pad + n:
            return None
        start = w + pad
        spos = start % self.cap
        self.arena.payload[spos:spos + n] = blob
        # publish AFTER the payload copy; the descriptor (the reader's only
        # pointer into the ring) goes over the pipe after this returns
        hdr[self.W] = start + n
        return start

    def reset(self) -> None:
        """Respawn path: drop unconsumed bytes (their descriptors died
        with the child's pipe; the respawn's re-list re-delivers)."""
        hdr = self.arena.hdr
        hdr[self.R] = int(hdr[self.W])

    # ------------------------------------------------------------ consumer

    def read(self, offset: int, length: int) -> bytes:
        pos = offset % self.cap
        out = bytes(self.arena.payload[pos:pos + length])
        self.arena.hdr[self.R] = offset + length
        return out

    def close(self, unlink: bool = False) -> None:
        self.arena.close(unlink=unlink)


class InflightSlot:
    """One pending emit batch, durable across a lane-process SIGKILL.

    Header: [0]=state (0 empty / 1 armed), [1]=payload length. The writer
    orders state=0 -> payload -> length -> state=1 (disarm first, so a
    re-arm torn mid-copy never leaves state=1 over mixed bytes); the
    post-mortem reader checks state first, and a torn write reads as
    empty, which only widens the at-least-once replay.
    """

    STATE, LEN = 0, 1

    def __init__(self, name: str, size: int = 0, create: bool = False):
        self.arena = Arena(name, size + _HDR_BYTES if create else 0, create)
        self.cap = self.arena.size - _HDR_BYTES
        self.name = name

    def arm(self, payload: bytes) -> bool:
        if len(payload) > self.cap:
            # oversized batch: refused, never truncated (the caller clears
            # the slot and relies on the re-list alone)
            return False
        hdr = self.arena.hdr
        hdr[self.STATE] = 0  # disarm first: a torn re-arm reads "empty"
        self.arena.payload[: len(payload)] = payload
        hdr[self.LEN] = len(payload)
        hdr[self.STATE] = 1
        return True

    def clear(self) -> None:
        self.arena.hdr[self.STATE] = 0

    def torn_arm(self, payload: bytes) -> None:
        """The fault plane's twin of :meth:`arm` (``shm.torn``): the writer
        dies mid-copy. The disarm fires, a PREFIX of the payload lands, and
        neither the length nor the state is written, so the torn re-arm
        reads as empty (:meth:`peek` -> None)."""
        hdr = self.arena.hdr
        hdr[self.STATE] = 0  # disarm first, as arm() does
        k = max(1, min(len(payload), self.cap) // 2)
        self.arena.payload[:k] = payload[:k]
        # ...writer SIGKILLed here: no LEN store, no state=1

    def peek(self) -> bytes | None:
        hdr = self.arena.hdr
        if int(hdr[self.STATE]) != 1:
            return None
        n = int(hdr[self.LEN])
        if not 0 <= n <= self.cap:
            return None
        return bytes(self.arena.payload[:n])

    def close(self, unlink: bool = False) -> None:
        self.arena.close(unlink=unlink)


# StatusBank fields (one int64 row per lane)
BANK_ALIVE_NS = 0      # child heartbeat, CLOCK_MONOTONIC ns
BANK_READY = 1         # child engine.ready
BANK_RESYNC = 2        # bitmask: 1 = nodes re-list ingested, 2 = pods
BANK_NODES = 3         # len(nodes.pool)
BANK_PODS = 4          # len(pods.pool)
BANK_QDEPTH = 5        # child ingest-queue depth
BANK_EVENTS = 6        # events the child received
BANK_PID = 7           # the child's own pid
# child -> parent upcall counters (the child has no watch streams of its
# own; the parent's coordinator turns increases into stream re-lists)
BANK_INTEG_NODES = 8   # integrity-doubt resync requests (nodes)
BANK_INTEG_PODS = 9    # integrity-doubt resync requests (pods)
BANK_REWIND = 10       # re-listed-rv-rewind detections (store restore)
BANK_DRIFT = 11        # 1 while the lane's auditor holds it degraded (drift)
BANK_FIELDS = 12


class StatusBank:
    """Per-lane int64 status rows; children own their row, the parent
    reads all of them (single writer per row, no locks)."""

    def __init__(self, name: str, lanes: int = 0, create: bool = False):
        size = lanes * BANK_FIELDS * 8 if create else 0
        self.arena = Arena(name, size + _HDR_BYTES if create else 0, create)
        n = (self.arena.size - _HDR_BYTES) // (BANK_FIELDS * 8)
        self.rows = np.frombuffer(
            self.arena.shm.buf, dtype=np.int64, offset=_HDR_BYTES,
            count=n * BANK_FIELDS,
        ).reshape(n, BANK_FIELDS)
        self.name = name

    def row(self, i: int) -> np.ndarray:
        return self.rows[i]

    def close(self, unlink: bool = False) -> None:
        self.rows = None
        self.arena.close(unlink=unlink)


class MetricsBank:
    """Per-lane metrics-snapshot slab: the child serializes its metrics
    into shared memory; the parent merges the snapshots into one
    ``/metrics``.

    Header: [0]=seq (a seqlock stamp: odd while the child is mid-write,
    even once the slab is consistent), [1]=payload length. One writer
    (the lane child), any number of readers (the parent's scrape): a
    reader that sees an odd or changed seq retries instead of parsing
    half a slab.
    """

    SEQ, LEN = 0, 1

    def __init__(self, name: str, size: int = 0, create: bool = False):
        self.arena = Arena(name, size + _HDR_BYTES if create else 0, create)
        self.cap = self.arena.size - _HDR_BYTES
        self.name = name

    def write(self, payload: bytes) -> bool:
        """Publish one snapshot; False when it exceeds the slab (the
        reader keeps the previous consistent snapshot)."""
        if len(payload) > self.cap:
            return False
        hdr = self.arena.hdr
        seq = int(hdr[self.SEQ])
        if seq % 2:  # a crashed writer left the slab mid-write: restamp
            seq += 1
        hdr[self.SEQ] = seq + 1  # odd: readers back off
        self.arena.payload[: len(payload)] = payload
        hdr[self.LEN] = len(payload)
        hdr[self.SEQ] = seq + 2  # even: consistent again
        return True

    def torn_write(self, payload: bytes) -> None:
        """The fault plane's twin of :meth:`write` (``shm.torn``): the
        writer dies mid-slab. The stamp goes odd, a PREFIX of the payload
        lands, and neither the length nor the closing even stamp is
        written: readers back off (odd stamp) and the next live write
        restamps."""
        if len(payload) > self.cap:
            return
        hdr = self.arena.hdr
        seq = int(hdr[self.SEQ])
        if seq % 2:
            seq += 1
        hdr[self.SEQ] = seq + 1  # odd: mid-write
        k = max(1, len(payload) // 2)
        self.arena.payload[:k] = payload[:k]
        # ...writer SIGKILLed here: no LEN store, no even restamp

    def reset(self) -> None:
        """Respawn path: empty the slab so a dead incarnation's snapshot
        is not read again once it has been folded into the retired
        accumulator."""
        hdr = self.arena.hdr
        hdr[self.LEN] = 0
        hdr[self.SEQ] = 0

    def read(self, retries: int = 8) -> bytes | None:
        """One consistent snapshot, or None if the slab is empty or the
        writer kept it torn for the whole (bounded) retry window."""
        hdr = self.arena.hdr
        for attempt in range(retries):
            seq0 = int(hdr[self.SEQ])
            if seq0 == 0:  # nothing published yet
                return None
            if seq0 % 2:  # writer mid-update: back off briefly, retry
                if attempt:
                    time.sleep(0.0002)
                continue
            n = int(hdr[self.LEN])
            if not 0 <= n <= self.cap:
                continue
            out = bytes(self.arena.payload[:n])
            if int(hdr[self.SEQ]) == seq0:
                return out
        return None

    def close(self, unlink: bool = False) -> None:
        self.arena.close(unlink=unlink)
