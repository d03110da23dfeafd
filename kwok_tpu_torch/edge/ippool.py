"""Pod-IP allocation from a CIDR: base + index arithmetic.

The reference's ipPool (pkg/kwok/controllers/utils.go:37-117) hands out
sequential IPs with a recycled free-list and a `Use` method to pin IPs that
existed before startup. Same contract here, with integer arithmetic on the
network base address.
"""

from __future__ import annotations

import ipaddress

from kwok_tpu_torch.locks import reclaimable


_DIGITS = frozenset("0123456789")


def _ip4_int(ip: str) -> int | None:
    """CANONICAL dotted-quad -> int without an ipaddress object (the
    allocator runs once per pod; IPv4Address construction dominated it in
    profiles). Only canonical quads qualify — no leading zeros, ASCII
    decimal digits only (str.isdigit accepts non-decimal digit chars that
    int() rejects) — everything else falls back to the ipaddress parser so
    behavior matches it exactly."""
    parts = ip.split(".")
    if len(parts) != 4:
        return None
    v = 0
    for p in parts:
        if not 0 < len(p) <= 3 or (len(p) > 1 and p[0] == "0"):
            return None
        for c in p:
            if c not in _DIGITS:
                return None
        o = int(p)
        if o > 255:
            return None
        v = (v << 8) | o
    return v


def _ip4_str(v: int) -> str:
    return f"{v >> 24 & 255}.{v >> 16 & 255}.{v >> 8 & 255}.{v & 255}"


class IPPool:
    """Thread-safe: get/put/use are called from patch-executor workers."""

    def __init__(self, cidr: str) -> None:
        self.net = ipaddress.ip_network(cidr, strict=False)
        self._base = int(self.net.network_address)
        self._v4 = self.net.version == 4
        self._mask = int(self.net.netmask) if self._v4 else 0
        self._next = 1  # skip the network address, like addIP starting at offset
        self._lane: tuple[int, int, int] | None = None  # (index, n, span)
        self._lane_j = 0
        self._free: list[str] = []
        self._used: set[str] = set()
        self._lock = reclaimable()

    def _next_off(self) -> int:
        """Next allocation offset (callers hold ``_lock``). Unpartitioned:
        the classic unbounded sequential walk. Partitioned (process lanes):
        lane ``index`` owns the ``index``-th span-sized slice of every
        ``n*span`` super-block — disjoint across lanes for ANY allocation
        count (a lane that outgrows its in-CIDR slice jumps to its slice
        of the next super-block instead of walking into a neighbor's),
        while staying unbounded exactly like the base walk."""
        lane = self._lane
        if lane is None:
            off = self._next
            self._next += 1
            return off
        index, n, span = lane
        j = self._lane_j
        self._lane_j = j + 1
        return 1 + index * span + (j // span) * (n * span) + (j % span)

    def contains(self, ip: str) -> bool:
        if self._v4:
            v = _ip4_int(ip)
            if v is not None:
                return (v & self._mask) == self._base
        try:
            return ipaddress.ip_address(ip) in self.net
        except ValueError:
            return False

    def get(self) -> str:
        with self._lock:
            while self._free:
                ip = self._free.pop()
                if ip not in self._used:
                    self._used.add(ip)
                    return ip
            while True:
                v = self._base + self._next_off()
                ip = _ip4_str(v) if self._v4 else str(ipaddress.ip_address(v))
                if ip not in self._used:
                    self._used.add(ip)
                    return ip

    def get_many(self, n: int) -> list[str]:
        """Batch get(): one lock hold for n allocations — the native emit
        gather's bulk first-transition shape, where a per-row
        get() was 40k lock operations per 20k-pod batch."""
        out: list[str] = []
        with self._lock:
            free = self._free
            used = self._used
            while free and len(out) < n:
                ip = free.pop()
                if ip not in used:
                    used.add(ip)
                    out.append(ip)
            while len(out) < n:
                v = self._base + self._next_off()
                ip = _ip4_str(v) if self._v4 else str(ipaddress.ip_address(v))
                if ip not in used:
                    used.add(ip)
                    out.append(ip)
        return out

    def partition_lanes(self, index: int, n: int) -> None:
        """Restrict this pool to the ``index``-th of ``n`` disjoint
        allocation sequences (process lanes, engine/proclanes.py): each
        lane process allocates from its own slice of every span-sized
        super-block (see ``_next_off``), so pods never collide on a
        podIP across lanes — for ANY per-lane allocation count — with
        no cross-process allocator lock, and a respawned lane re-derives
        the same sequence deterministically. ``use``/``put`` still
        accept any in-CIDR IP (re-listed pods may pin IPs allocated
        before a repartition or by another owner). No-op for n <= 1."""
        if n <= 1:
            return
        span = max(1, (self.net.num_addresses - 1) // n)
        with self._lock:
            self._lane = (index, n, span)
            self._lane_j = 0

    def put(self, ip: str) -> None:
        """Recycle an IP (pod Deleted event, pod_controller.go:334-337).
        Out-of-CIDR IPs are rejected like the reference's Put."""
        if not self.contains(ip):
            return
        with self._lock:
            if ip in self._used:
                self._used.discard(ip)
                self._free.append(ip)

    def use(self, ip: str) -> None:
        """Pin an IP observed in a pre-existing pod status
        (pod_controller.go:381-385). Out-of-CIDR IPs are ignored."""
        if self.contains(ip):
            with self._lock:
                self._used.add(ip)
