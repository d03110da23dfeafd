"""Host-side row bookkeeping: name <-> row index, metadata, free list.

Dynamic strings never reach the device (SURVEY.md "Hard parts"): objects are
interned to row indices at ingest; freed rows are recycled like the
reference's ipPool (pkg/kwok/controllers/utils.go:52-117).
"""

from __future__ import annotations

import zlib
from typing import Any


def shard_of(key: Any, n: int) -> int:
    """Stable key -> shard index for the hash-partitioned host lanes.

    Deliberately NOT Python's ``hash()``: str hashing is salted per process
    (PYTHONHASHSEED), and the lane layout should be reproducible across
    runs so soak artifacts and trace dumps from different rounds line up.
    Keys are the row-pool keys: node name (str) or (namespace, name) for
    pods — crc32 over the joined utf-8 bytes."""
    if n <= 1:
        return 0
    if isinstance(key, tuple):
        data = "\x1f".join(str(p) for p in key).encode()
    else:
        data = str(key).encode()
    return zlib.crc32(data) % n


# RowPool.eflags bits — the native emit path's per-row classification,
# staged at upsert so emit never walks the meta dicts.
EF_RENDER = 1  # row has a renderable object (raw line or parsed dict)
EF_RGATES = 2  # spec carries readinessGates -> slow path
EF_SCALAR = 4  # server-side status is scalar-replace only (fp seeding)


class RowPool:
    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._by_key: dict[Any, int] = {}
        self._key_by_idx: list[Any] = [None] * capacity
        self.meta: list[dict | None] = [None] * capacity
        self._free: list[int] = []
        self._high = 0  # rows [0, high) have been used at least once
        # Columnar emit inputs: pre-encoded per-row byte slabs
        # the native emit splice gathers WITHOUT touching `meta` — staged
        # by the engine at upsert time (gated on its native-emit flag) and
        # cleared with the row. `path_b` holds the URL-quoted object path
        # minus any server base prefix and minus the "/status" suffix, so
        # status patches and deletes share it.
        self.path_b: list[bytes | None] = [None] * capacity
        self.host_b: list[bytes | None] = [None] * capacity
        self.ip_b: list[bytes | None] = [None] * capacity
        self.start_b: list[bytes | None] = [None] * capacity
        self.ctr_b: list[bytes | None] = [None] * capacity
        self.ictr_b: list[bytes | None] = [None] * capacity
        self.eflags: list[int] = [0] * capacity
        # server-side .status.phase as a compiled phase id (-1 unknown):
        # the emit path's no-op-merge pre-check (phase already reached)
        self.srv_phase: list[int] = [-1] * capacity

    def __len__(self) -> int:
        return len(self._by_key)

    def lookup(self, key: Any) -> int | None:
        return self._by_key.get(key)

    @property
    def full(self) -> bool:
        return not self._free and self._high >= self.capacity

    def acquire(self, key: Any) -> int:
        existing = self._by_key.get(key)
        if existing is not None:
            return existing
        if self._free:
            idx = self._free.pop()
        else:
            if self._high >= self.capacity:
                raise IndexError("row pool full; grow first")
            idx = self._high
            self._high += 1
        self._by_key[key] = idx
        self._key_by_idx[idx] = key
        self.meta[idx] = {}
        return idx

    def release(self, key: Any) -> int | None:
        idx = self._by_key.pop(key, None)
        if idx is None:
            return None
        self._key_by_idx[idx] = None
        self.meta[idx] = None
        # emit columns die with the row: a recycled index must never
        # splice the previous occupant's bytes (EF_RENDER=0 alone gates
        # the fast path; the rest is hygiene)
        self.eflags[idx] = 0
        self.srv_phase[idx] = -1
        self.path_b[idx] = None
        self.host_b[idx] = None
        self.ip_b[idx] = None
        self.start_b[idx] = None
        self.ctr_b[idx] = None
        self.ictr_b[idx] = None
        self._free.append(idx)
        return idx

    def key_of(self, idx: int) -> Any:
        return self._key_by_idx[idx]

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            return
        extra = new_capacity - self.capacity
        self._key_by_idx.extend([None] * extra)
        self.meta.extend([None] * extra)
        for col in (self.path_b, self.host_b, self.ip_b, self.start_b,
                    self.ctr_b, self.ictr_b):
            col.extend([None] * extra)
        self.eflags.extend([0] * extra)
        self.srv_phase.extend([-1] * extra)
        self.capacity = new_capacity

    def keys(self):
        return self._by_key.keys()

    def items(self):
        return self._by_key.items()
