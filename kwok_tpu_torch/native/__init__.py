"""The native edge: C++ watch-line reader, batch event parser, canonical
fingerprints, the emit renderers and the HTTP pump, bound through ctypes
(the port of ``kwok_tpu.native``).

``codec.cc``, ``pump.cc`` and ``ingest.cc`` are copies of the JAX
package's sources. They are built together, at first use, with
``g++ -O2 -std=c++17 -pthread -shared -fPIC`` into
``kwok_tpu_torch/_build/libkwok_native-<hash>.so``, named by a hash of
the three sources and the flags; nothing is written next to them.

Ingest: ``kwok_parse_events`` (one C call parses a whole drain of watch
lines into fingerprints, flags, revisions and string offsets, and with
``n_shards`` computes each event's lane as ``rowpool.shard_of`` does),
``kwok_fingerprint_statuses`` and the watch IO
(``kwok_watch_open``/``read``/``close``: the batched, de-chunking socket
reader).

Emit: ``kwok_emit_pods`` splices a batch of pod status patches into the
byte templates compiled from the rules (``EmitTable``) and, given a
``Pump``, ships the batch in the same call; ``kwok_render_heartbeats``
and ``kwok_render_pod_statuses`` render node heartbeats and generic pod
patches; ``Pump`` pipelines whole request batches over keep-alive
connections (``kwok_pump_open``/``send``/``send2``/``stats``/``close``).

A build or load failure is logged at WARNING with the compiler's
output; callers then keep the Python path.

``apiserver.cc`` is the fourth source, a copy of the JAX package's native
mock kube-apiserver: a program of its own (it has ``main``), so it is not
in ``SOURCES`` and not in the library. ``apiserver_binary()`` builds it at
first use with ``g++ -O2 -std=c++17 -pthread`` into
``kwok_tpu_torch/_build/kwok-mock-apiserver-<hash>`` (the hash covers the
source and the flags) and returns its path, or None when it cannot be
built (logged at WARNING) or under ``KWOK_TPU_NATIVE=0``. Run it as
``<path> --port 0``: it prints ``mock apiserver listening on URL`` and
speaks the wire protocol of ``edge/mockserver.py``, at native speed.

The engine's opt-outs are environment variables: ``KWOK_TPU_NATIVE=0``
(no native edge at all: the ``json.loads`` ingest and one executor job
per patch), ``KWOK_TPU_NATIVE_EMIT=0`` (no templates: the generic
renderer plus the pump), ``KWOK_TPU_NATIVE_WATCH=0`` (no socket reader:
raw lines from Python's HTTP client, still parsed natively) and
``KWOK_TPU_NATIVE_ROUTE=0`` (no pre-partitioned routing: per-record
Python route loop).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger("kwok_tpu_torch.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_DIR, f) for f in ("codec.cc", "pump.cc", "ingest.cc"))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread", "-shared", "-fPIC")
ABI_VERSION = 9
APISERVER_SOURCE = os.path.join(_DIR, "apiserver.cc")
APISERVER_FLAGS = ("-O2", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: the compiler's output of the build this process made ("" when the
#: library was already built)
build_log = ""

_apiserver_lock = threading.Lock()
_apiserver_path: str | None = None
_apiserver_tried = False
#: the compiler's output of the apiserver build this process made, failed
#: or not ("" when the binary was already built)
apiserver_build_log = ""


def enabled() -> bool:
    """False under ``KWOK_TPU_NATIVE=0``."""
    return os.environ.get("KWOK_TPU_NATIVE", "1") != "0"


def _hashed_path(name: str, flags, sources, suffix: str = "") -> str:
    """``BUILD_DIR/<name>-<hash><suffix>``, the hash over the flags and the
    sources' bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}{suffix}")


def library_path() -> str:
    return _hashed_path("libkwok_native", CXX_FLAGS, SOURCES, ".so")


def apiserver_path() -> str:
    return _hashed_path("kwok-mock-apiserver", APISERVER_FLAGS, (APISERVER_SOURCE,))


def _compile(what: str, flags, sources, path: str) -> tuple[bool, str]:
    """Compile ``sources`` into ``path`` through a per-process temporary
    file and an atomic rename, so concurrent builders never tear it;
    (built, the compiler's output), a failure logged at WARNING."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *flags, "-o", tmp, *sources]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("%s build failed to run %s: %s", what, cmd[0], e)
        return False, str(e)
    out = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        logger.warning(
            "%s build failed (%d): %s\n%s", what, proc.returncode, " ".join(cmd), out
        )
        return False, out
    os.replace(tmp, path)
    return True, out


def _build(path: str) -> bool:
    """Compile the three sources into ``path``."""
    global build_log
    ok, out = _compile("native library", CXX_FLAGS, SOURCES, path)
    if ok:
        build_log = out
    return ok


def apiserver_binary() -> str | None:
    """Path to the native mock kube-apiserver, building it at first use;
    None under ``KWOK_TPU_NATIVE=0`` or when it cannot be built (logged at
    WARNING once, the output kept in ``apiserver_build_log``)."""
    global _apiserver_path, _apiserver_tried, apiserver_build_log
    if not enabled():
        return None
    with _apiserver_lock:
        if _apiserver_path is not None or _apiserver_tried:
            return _apiserver_path
        _apiserver_tried = True
        try:
            path = apiserver_path()
        except OSError as e:
            logger.warning("native apiserver source unreadable: %s", e)
            return None
        if not os.path.exists(path):
            ok, apiserver_build_log = _compile(
                "native apiserver", APISERVER_FLAGS, (APISERVER_SOURCE,), path
            )
            if not ok:
                return None
        _apiserver_path = path
        return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kwok_codec_abi_version.restype = ctypes.c_int32
    lib.kwok_codec_abi_version.argtypes = []
    lib.kwok_parse_events.restype = ctypes.c_int64
    lib.kwok_parse_events.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int32,
        u64p, u64p, u64p, u64p, u8p, i64p,
        ctypes.c_char_p, ctypes.c_int64, i64p,
        # pre-partitioned routing: kind_is_pods, n_shards, shard_out,
        # lane_idx, lane_off, route_info (null when n_shards=0)
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i64p, i64p,
    ]
    lib.kwok_fingerprint_statuses.restype = None
    lib.kwok_fingerprint_statuses.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int32, u64p,
    ]
    lib.kwok_watch_open.restype = ctypes.c_void_p
    lib.kwok_watch_open.argtypes = [
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.kwok_watch_read.restype = ctypes.c_int64
    lib.kwok_watch_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
        i64p, ctypes.c_int64, i32p, i64p,
    ]
    lib.kwok_watch_close.restype = None
    lib.kwok_watch_close.argtypes = [ctypes.c_void_p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.kwok_render_heartbeats.restype = ctypes.c_int64
    lib.kwok_render_heartbeats.argtypes = [
        ctypes.c_int32, u32p, ctypes.c_int32,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int64, i64p,
    ]
    lib.kwok_render_pod_statuses.restype = ctypes.c_int64
    lib.kwok_render_pod_statuses.argtypes = [
        ctypes.c_int32, u8p, u32p,
        ctypes.c_char_p, i64p,
        ctypes.c_int32, ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int64, i64p,
    ]
    lib.kwok_pump_open.restype = ctypes.c_int64
    lib.kwok_pump_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
    ]
    lib.kwok_pump_send.restype = ctypes.c_int64
    lib.kwok_pump_send.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        i32p,
    ]
    lib.kwok_pump_send2.restype = ctypes.c_int64
    lib.kwok_pump_send2.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, i64p,
        i32p,
    ]
    lib.kwok_pump_close.restype = None
    lib.kwok_pump_close.argtypes = [ctypes.c_int64]
    lib.kwok_pump_stats.restype = None
    lib.kwok_pump_stats.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    lib.kwok_emit_pods.restype = ctypes.c_int64
    lib.kwok_emit_pods.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        i32p, u32p,
        # template table: lit_blob, seg_code, seg_a, seg_b, tpl_off,
        # tpl_kind, tpl_ready
        ctypes.c_char_p, i32p, i64p, i64p, i64p, u8p, u8p,
        # columns: host, pod, start, ctrs, ictrs
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int32,  # now
        ctypes.c_char_p, ctypes.c_int64, i64p,  # out slab
        u64p,  # fingerprints
        # send half: base, paths, suffix, ctype, status
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, i64p,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        i32p,
    ]
    return lib


def load() -> ctypes.CDLL | None:
    """The native library, building it at first use; None when it cannot
    be built or loaded (logged at WARNING once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
        except OSError as e:
            logger.warning("native library sources unreadable: %s", e)
            return None
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = _bind(ctypes.CDLL(path))
        except (OSError, AttributeError) as e:
            logger.warning("native library %s failed to load: %s", path, e)
            return None
        abi = lib.kwok_codec_abi_version()
        if abi != ABI_VERSION:
            logger.warning(
                "native library %s has ABI %d, the loader binds %d",
                path, abi, ABI_VERSION,
            )
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


#: string fields per EventRecord (ingest.cc kwok_parse_events)
_REC_STRINGS = 11  # type, ns, name, nodeName, phase, podIP, hostIP,
#                    creation, containers, initContainers, trueConditions

# flags bits (ingest.cc)
REC_OK = 1
REC_DELETION = 2
REC_FINALIZERS = 4
REC_READINESS_GATES = 8
REC_STATUS_SCALAR_ONLY = 16
# bits 5-6: event type code, so batch consumers classify without the
# type string
REC_TYPE_MASK = 0x60
REC_TYPE_ADDED = 0x20
REC_TYPE_MODIFIED = 0x40
REC_TYPE_DELETED = 0x60

# shard sentinel codes of a partitioned parse
SHARD_UNROUTABLE = -1  # nameless, or escapes in ns/name (Python routes it)
SHARD_ERROR = -2
SHARD_BOOKMARK = -3


class EventRecord:
    """Compact parse of one watch line: routing strings, flags, canonical
    fingerprints and pre-formatted container/condition blobs. ``raw``
    keeps the original line for the full-parse fallback."""

    __slots__ = (
        "type", "namespace", "name", "node_name", "phase", "pod_ip",
        "host_ip", "creation", "containers", "init_containers",
        "true_conditions", "flags", "fp_status", "fp_status_nc",
        "fp_spec", "fp_meta_sel", "rv", "raw",
    )

    def __init__(self, type_, ns, name, node, phase, pod_ip, host_ip,
                 creation, ctrs, ictrs, conds, flags, fp_s, fp_nc, fp_spec,
                 fp_meta, rv, raw):
        self.type = type_
        self.namespace = ns
        self.name = name
        self.node_name = node
        self.phase = phase
        self.pod_ip = pod_ip
        self.host_ip = host_ip
        self.creation = creation
        self.containers = ctrs
        self.init_containers = ictrs
        self.true_conditions = conds
        self.flags = flags
        self.fp_status = fp_s
        self.fp_status_nc = fp_nc
        self.fp_spec = fp_spec
        self.fp_meta_sel = fp_meta
        #: metadata.resourceVersion, parsed at metadata's own depth; 0
        #: when absent or not a number
        self.rv = rv
        self.raw = raw

    @property
    def ok(self) -> bool:
        return bool(self.flags & REC_OK)


class RouteInfo:
    """Scalar summary of one partitioned parse. ``latest_rv`` is the
    resume revision a full Python walk would commit: 0 whenever the batch
    carries an ERROR event."""

    __slots__ = ("latest_rv", "first_error", "bookmarks", "routable",
                 "unrouteable")

    def __init__(self, latest_rv, first_error, bookmarks, routable,
                 unrouteable):
        self.latest_rv = latest_rv
        self.first_error = first_error
        self.bookmarks = bookmarks
        self.routable = routable
        self.unrouteable = unrouteable


class ParsedBatch:
    """One batched parse; ``record(i)`` is a lazy view over the arrays
    (the attribute surface of EventRecord).

    The numpy outputs (``off_a``/``fp_a``/``flags_a``/``rvs_a``) feed the
    columnar ingest directly; the per-record list mirrors
    (``off``/``fp``/``flags_arr``/``rvs``) are built eagerly, except on a
    partitioned parse, where the first lane that needs them converts
    once under ``_lists_lock``. A partitioned parse also carries
    ``shard`` (each event's lane code), ``lane_idx``/``lane_off`` (each
    lane's contiguous index run over the routable records) and
    ``route_info``."""

    __slots__ = (
        "lines", "buf", "n", "off_a", "fp_a", "flags_a", "rvs_a",
        "off", "fp", "flags_arr", "rvs",
        "shard", "lane_idx", "lane_off", "route_info", "_lists_lock",
    )

    def __init__(self, lines, buf, off_a, fp_a, flags_a, rvs_a,
                 lazy=False, partition=None):
        self.lines = lines
        self.buf = buf
        self.n = len(lines)
        self.off_a = off_a
        self.fp_a = fp_a
        self.flags_a = flags_a
        self.rvs_a = rvs_a
        if partition is not None:
            self.shard, self.lane_idx, self.lane_off, self.route_info = partition
        else:
            self.shard = self.lane_idx = self.lane_off = None
            self.route_info = None
        self._lists_lock = threading.Lock()
        if lazy:
            self.off = self.fp = self.flags_arr = self.rvs = None
        else:
            self._build_lists()

    @property
    def partitioned(self) -> bool:
        return self.lane_off is not None

    def _build_lists(self) -> None:
        # list indexing is ~10x a numpy scalar read, and lazy records read
        # per field: one tolist per batch
        self.fp = [row.tolist() for row in self.fp_a]
        self.flags_arr = self.flags_a.tolist()
        self.rvs = self.rvs_a.tolist()
        self.off = self.off_a.tolist()  # set LAST: the presence gate

    def ensure_lists(self) -> None:
        """Idempotent lazy list conversion, safe from concurrent lane
        drain workers."""
        if self.off is not None:
            return
        with self._lists_lock:
            if self.off is None:
                self._build_lists()

    def rv(self, i: int) -> int:
        if self.off is None:
            self.ensure_lists()
        return self.rvs[i]

    def type_bytes(self, i: int) -> bytes:
        if self.off is None:
            self.ensure_lists()
        base = i * _REC_STRINGS
        return self.buf[self.off[base]: self.off[base + 1]]

    def record(self, i: int) -> "_LazyRecord":
        if self.off is None:
            self.ensure_lists()
        return _LazyRecord(self, i)


class _LazyRecord:
    """EventRecord-compatible lazy view into a ParsedBatch; fields cache as
    instance attributes on first access. flags, the fingerprints, rv and
    the identity strings (type, namespace, name, nodeName) resolve one by
    one, so a dropped echo touches only those; any other field
    materializes them all in one pass."""

    def __init__(self, batch: ParsedBatch, i: int):
        self._b = batch
        self._i = i

    _STR_FIELDS = (
        "type", "namespace", "name", "node_name", "phase", "pod_ip",
        "host_ip", "creation",
    )
    # decoded one by one: the echo drop and the record upsert's first
    # checks read only these, so an echo that takes the full path never
    # pays the whole pass
    _CHEAP_STR = {"type": 0, "namespace": 1, "name": 2, "node_name": 3}
    _FP_FIELDS = ("fp_status", "fp_status_nc", "fp_spec", "fp_meta_sel")

    def _materialize(self) -> None:
        b = self._b
        i = self._i
        base = i * _REC_STRINGS
        off = b.off
        buf = b.buf
        d = self.__dict__
        for j, fname in enumerate(self._STR_FIELDS):
            d[fname] = buf[off[base + j]: off[base + j + 1]].decode(
                "utf-8", "surrogateescape"
            )
        d["containers"] = buf[off[base + 8]: off[base + 9]]
        d["init_containers"] = buf[off[base + 9]: off[base + 10]]
        d["true_conditions"] = buf[off[base + 10]: off[base + 11]]
        flag = b.flags_arr[i]
        d["flags"] = flag
        d["ok"] = bool(flag & REC_OK)
        fp = b.fp
        d["fp_status"] = fp[0][i]
        d["fp_status_nc"] = fp[1][i]
        d["fp_spec"] = fp[2][i]
        d["fp_meta_sel"] = fp[3][i]
        d["rv"] = b.rvs[i]

    def __getattr__(self, name: str):
        b = self._b
        i = self._i
        d = self.__dict__
        if name == "flags":
            d["flags"] = v = b.flags_arr[i]
            return v
        if name == "ok":
            d["ok"] = v = bool(b.flags_arr[i] & REC_OK)
            return v
        j = self._CHEAP_STR.get(name)
        if j is not None:
            base = i * _REC_STRINGS
            d[name] = v = b.buf[b.off[base + j]: b.off[base + j + 1]].decode(
                "utf-8", "surrogateescape"
            )
            return v
        if name in self._FP_FIELDS:
            fp = b.fp
            d["fp_status"] = fp[0][i]
            d["fp_status_nc"] = fp[1][i]
            d["fp_spec"] = fp[2][i]
            d["fp_meta_sel"] = fp[3][i]
            return d[name]
        if name == "rv":
            d["rv"] = v = b.rvs[i]
            return v
        if name == "raw":
            d["raw"] = v = bytes(b.lines[i])
            return v
        if name.startswith("_"):
            raise AttributeError(name)
        self._materialize()
        try:
            return d[name]
        except KeyError:
            raise AttributeError(name) from None


class _BlobLines:
    """Sequence view over lines packed as (buf, off): the raw backing a
    ParsedBatch needs for ``.raw`` without per-line bytes objects."""

    __slots__ = ("bbuf", "boff")

    def __init__(self, buf: bytes, off) -> None:
        self.bbuf = buf
        self.boff = off

    def __len__(self) -> int:
        return len(self.boff) - 1

    def __getitem__(self, i: int) -> bytes:
        return self.bbuf[self.boff[i]: self.boff[i + 1]]


class WatchReader:
    """Batched native watch-line reader over a socket fd handed off after
    the Python HTTP handshake. ``read_batch()`` returns the packed
    (buf, off) lines ``EventParser.parse_blob`` consumes, or None at the
    end of the stream. A batch cut short by an ERROR event line carries
    that line in ``error`` (it is not in the batch).

    ``owner``, when given, is the socket object that owns ``fd`` (a dup
    made for this reader): it is closed with the reader, never before, so
    the fd number the C side reads can never be closed under it and
    handed to another connection."""

    def __init__(self, fd: int, initial: bytes = b"",
                 chunked: bool = True, owner=None) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._owner = owner
        self._h = lib.kwok_watch_open(
            int(fd), bytes(initial), len(initial), 0 if chunked else 1
        )
        self._cap = 1 << 20
        self._buf = ctypes.create_string_buffer(self._cap)
        self._max_lines = 16384
        self._off = np.zeros(self._max_lines + 1, np.int64)
        self._err = np.zeros(1, np.int32)
        self._need = np.zeros(1, np.int64)
        self.error: bytes | None = None

    def read_batch(self, timeout_s: float = 1.0):
        """(buf, off) with len(off)-1 >= 0 lines (0: the poll timed out,
        call again), or None when the stream is over."""
        self.error = None
        errp = self._err.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            n = self._lib.kwok_watch_read(
                self._h, 1000 if timeout_s is None
                else max(0, int(timeout_s * 1000)),
                self._buf, self._cap,
                _i64p(self._off), self._max_lines, errp, _i64p(self._need),
            )
            if n == -2:  # one line larger than the buffer: grow, retry
                self._cap = max(self._cap * 2, int(self._need[0]) + 4096)
                self._buf = ctypes.create_string_buffer(self._cap)
                continue
            break
        if n < 0:
            return None
        n = int(n)
        off = self._off[: n + 1].tolist()
        # slice the ctypes array: ._buf.raw would copy the whole capacity
        buf = self._buf[: off[-1]] if n else b""
        if self._err[0] and n:
            # the last line is the stream-ending ERROR event
            self.error = buf[off[n - 1]: off[n]]
            off = off[:n]
            buf = buf[: off[-1]] if n > 1 else b""
        return buf, off

    def close(self) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.kwok_watch_close(h)
        owner, self._owner = self._owner, None
        if owner is not None:
            owner.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the fd dies with us
            pass


class EventParser:
    """The batch parser (one C call per drain) and a single-line parse
    with preallocated buffers."""

    def __init__(self) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._fp = np.zeros(4, np.uint64)  # status, status_nc, spec, meta
        self._flags = np.zeros(1, np.uint8)
        self._rv = np.zeros(1, np.int64)
        self._str_off = np.zeros(_REC_STRINGS + 1, np.int64)
        self._off = np.zeros(2, np.int64)
        self._cap = 4096
        self._buf = bytearray(self._cap)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._fp_ptrs = tuple(
            self._fp[i:].ctypes.data_as(u64p) for i in range(4)
        )
        self._flags_p = self._flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._rv_p = _i64p(self._rv)
        self._off_p = _i64p(self._off)
        self._str_off_p = _i64p(self._str_off)

    def parse_raw_batch(
        self, lines: list, kind: "str | None" = None, n_shards: int = 0
    ) -> "ParsedBatch | None":
        """Parse N watch lines in ONE C call; records come back as lazy
        views. With ``kind`` and ``n_shards`` >= 1 the same call computes
        each event's lane (crc32, as ``rowpool.shard_of``) and the
        per-lane index runs."""
        n = len(lines)
        if n == 0:
            return None
        blob, off = _blob([bytes(x) for x in lines])
        return self._parse_packed(lines, blob, off, n, kind, n_shards)

    def parse_blob(
        self, blob: bytes, off, kind: "str | None" = None, n_shards: int = 0,
    ) -> "ParsedBatch | None":
        """``parse_raw_batch`` over lines already packed as (blob, offsets),
        the WatchReader's form; ``.raw`` slices the blob lazily."""
        n = len(off) - 1
        if n <= 0:
            return None
        off_arr = np.ascontiguousarray(off, np.int64)
        return self._parse_packed(
            _BlobLines(blob, off), blob, off_arr, n, kind, n_shards
        )

    def _parse_packed(self, lines, blob: bytes, off: np.ndarray, n: int,
                      kind: "str | None" = None, n_shards: int = 0):
        fp = np.zeros((4, n), np.uint64)
        flags = np.zeros(n, np.uint8)
        rvs = np.zeros(n, np.int64)
        str_off = np.zeros(_REC_STRINGS * n + 1, np.int64)
        cap = max(4096, len(blob))
        buf = bytearray(cap)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        ns_arg = int(n_shards) if (n_shards and kind is not None) else 0
        if ns_arg:
            shard = np.zeros(n, np.int32)
            lane_idx = np.zeros(n, np.int32)
            lane_off = np.zeros(ns_arg + 1, np.int64)
            route_info = np.zeros(6, np.int64)
            part_args = (
                1 if kind == "pods" else 0, ns_arg,
                shard.ctypes.data_as(i32p), lane_idx.ctypes.data_as(i32p),
                _i64p(lane_off), _i64p(route_info),
            )
        else:
            part_args = (0, 0, None, None, None, None)
        for _ in range(2):
            need = self._lib.kwok_parse_events(
                blob, _i64p(off), n,
                fp[0].ctypes.data_as(u64p), fp[1].ctypes.data_as(u64p),
                fp[2].ctypes.data_as(u64p), fp[3].ctypes.data_as(u64p),
                flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                _i64p(rvs),
                (ctypes.c_char * cap).from_buffer(buf), cap, _i64p(str_off),
                *part_args,
            )
            if need <= cap:
                break
            cap = int(need) + 1024
            buf = bytearray(cap)
        partition = None
        if ns_arg:
            partition = (
                shard, lane_idx, lane_off.tolist(),
                RouteInfo(*route_info.tolist()[:5]),
            )
        return ParsedBatch(
            lines, bytes(buf[:min(cap, int(need))]), str_off,
            fp, flags, rvs, lazy=bool(ns_arg), partition=partition,
        )

    def parse_batch(self, lines: list) -> "list[EventRecord]":
        """Eager variant of parse_raw_batch (small batches, tests)."""
        b = self.parse_raw_batch(lines)
        return [] if b is None else [b.record(i) for i in range(b.n)]

    def parse(self, line: bytes) -> EventRecord:
        self._off[1] = len(line)
        fp = self._fp
        p0, p1, p2, p3 = self._fp_ptrs
        for _ in range(2):
            need = self._lib.kwok_parse_events(
                line, self._off_p, 1,
                p0, p1, p2, p3,
                self._flags_p, self._rv_p,
                (ctypes.c_char * self._cap).from_buffer(self._buf),
                self._cap, self._str_off_p,
                0, 0, None, None, None, None,
            )
            if need <= self._cap:
                break
            self._cap = int(need) + 1024
            self._buf = bytearray(self._cap)
        off = self._str_off
        buf = self._buf
        flags = int(self._flags[0])

        def s(i: int) -> str:
            return bytes(buf[off[i]: off[i + 1]]).decode("utf-8", "surrogateescape")

        def blob(i: int) -> bytes:
            return bytes(buf[off[i]: off[i + 1]])

        return EventRecord(
            s(0), s(1), s(2), s(3), s(4), s(5), s(6), s(7),
            blob(8), blob(9), blob(10),
            flags, int(fp[0]), int(fp[1]), int(fp[2]), int(fp[3]),
            int(self._rv[0]), line,
        )


def fingerprint_statuses(bodies: list) -> "np.ndarray | None":
    """Canonical fingerprint of the ``status`` subtree of each rendered
    patch body, by the algorithm the event parser applies to incoming
    objects: equal fingerprints mean the merged status will echo back
    exactly this document."""
    lib = load()
    if lib is None:
        return None
    blob, off = _blob([bytes(b) for b in bodies])
    out = np.zeros(len(bodies), np.uint64)
    lib.kwok_fingerprint_statuses(
        blob, _i64p(off), len(bodies),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def _blob(items: list[bytes]) -> tuple[bytes, np.ndarray]:
    n = len(items)
    off = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum(np.fromiter(map(len, items), np.int64, count=n), out=off[1:])
    return b"".join(items), off


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _split(buf: bytearray, off: np.ndarray) -> list[memoryview]:
    """Zero-copy per-row views into one output buffer."""
    mv = memoryview(buf)
    off_l = off.tolist()
    return [mv[off_l[i]: off_l[i + 1]] for i in range(len(off_l) - 1)]


class Pump:
    """Batched pipelined HTTP client over a fixed pool of keep-alive
    connections (``pump.cc``). ``send()`` blocks outside the GIL while the
    whole batch is written and read, so thousands of requests cost one
    Python call. Response bodies are discarded: the engine learns state
    from the watch echo, callers only get status codes back."""

    def __init__(
        self, host: str, port: int, nconn: int = 4, header_extra: str = ""
    ) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.kwok_pump_open(
            host.encode(), port, nconn, header_extra.encode()
        )

    @property
    def handle(self) -> int:
        """The raw pump id for the fused ``emit_pods`` call. Wrappers are
        told apart by ``isinstance``, never by this attribute, so a fused
        call never tunnels past one."""
        return self._handle

    def send(self, requests: list[tuple]) -> "np.ndarray":
        """``requests``: (method, path, body[, content_type]) tuples; the
        content type defaults to application/json. Returns each request's
        HTTP status (0 = the connection died before its answer; the
        caller may resend)."""
        n = len(requests)
        status = np.zeros(n, np.int32)
        if n == 0:
            return status
        m_blob, m_off = _blob([r[0].encode() for r in requests])
        p_blob, p_off = _blob([
            r[1].encode() if isinstance(r[1], str) else bytes(r[1])
            for r in requests
        ])
        b_blob, b_off = _blob([bytes(r[2]) for r in requests])
        c_blob, c_off = _blob(
            [(r[3].encode() if len(r) > 3 else b"") for r in requests]
        )
        self._lib.kwok_pump_send(
            self._handle, n,
            m_blob, _i64p(m_off),
            p_blob, _i64p(p_off),
            c_blob, _i64p(c_off),
            b_blob, _i64p(b_off),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return status

    def stats(self) -> dict:
        """Send-path totals since open (``pump.cc``): batches, requests,
        batch wall seconds, and the write/read seconds summed over the
        pool's connection threads."""
        out = (ctypes.c_double * 5)()
        if self._handle:
            self._lib.kwok_pump_stats(self._handle, out)
        return {
            "batches": int(out[0]),
            "requests": int(out[1]),
            "batch_s": out[2],
            "write_s": out[3],
            "read_s": out[4],
        }

    def close(self) -> None:
        if self._handle:
            self._lib.kwok_pump_close(self._handle)
            self._handle = 0

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the fds die with us
            pass


def render_heartbeats(
    cond_bits: np.ndarray,
    cond_meta: list[tuple[str, str, str]],
    now: str,
    start_times: list[bytes],
) -> "list[memoryview] | None":
    """Render a batch of node heartbeat status patches, one body per row.
    ``cond_meta``: (type, reason, message) per condition bit, in bit
    order. None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(start_times)
    bits = np.ascontiguousarray(cond_bits, np.uint32)
    meta_blob, meta_off = _blob([s.encode() for t in cond_meta for s in t])
    start_blob, start_off = _blob(start_times)
    now_b = now.encode()
    out_off = np.zeros(n + 1, np.int64)
    # a first guess: ~128 literal bytes per condition plus its strings
    per_cond = 128 + len(now_b) + len(meta_blob) // max(1, len(cond_meta))
    cap = max(1024, n * (len(cond_meta) * per_cond + 32)
              + len(start_blob) * len(cond_meta))
    for _ in range(2):
        out = bytearray(cap)
        need = lib.kwok_render_heartbeats(
            n,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(cond_meta),
            meta_blob, _i64p(meta_off),
            now_b, len(now_b),
            start_blob, _i64p(start_off),
            (ctypes.c_char * len(out)).from_buffer(out), cap, _i64p(out_off),
        )
        if need <= cap:
            return _split(out, out_off)
        cap = need  # the exact size: the second pass fits
    raise AssertionError("heartbeat buffer sizing did not converge")


class EmitTable:
    """A compiled ``EmitTemplates`` table (``models/compiler.py``) pinned
    in the contiguous form ``kwok_emit_pods`` reads: built once per
    engine, shared read-only by every lane's emit."""

    __slots__ = (
        "lit_blob", "seg_code", "seg_a", "seg_b", "tpl_off", "tpl_kind",
        "tpl_ready", "phase_tpl", "phase_names",
    )

    def __init__(self, tpl) -> None:
        if load() is None:
            raise RuntimeError("native library unavailable")
        self.lit_blob = bytes(tpl.lit_blob)
        self.seg_code = np.ascontiguousarray(tpl.seg_code, np.int32)
        self.seg_a = np.ascontiguousarray(tpl.seg_a, np.int64)
        self.seg_b = np.ascontiguousarray(tpl.seg_b, np.int64)
        self.tpl_off = np.ascontiguousarray(tpl.tpl_off, np.int64)
        self.tpl_kind = np.ascontiguousarray(tpl.tpl_kind, np.uint8)
        self.tpl_ready = np.ascontiguousarray(tpl.tpl_ready, np.uint8)
        #: phase id -> template id, a list: the emit gather indexes it
        #: per row, where a numpy scalar read costs ~10x
        self.phase_tpl = np.asarray(tpl.phase_tpl, np.int32).tolist()
        self.phase_names = tpl.phase_names


def emit_pods(
    tpl: EmitTable,
    tpl_ids: np.ndarray,
    cond_bits: np.ndarray,
    hosts: list[bytes],
    ips: list[bytes],
    starts: list[bytes],
    ctrs: list[bytes],
    ictrs: list[bytes],
    now: bytes,
    *,
    pump: "Pump | None" = None,
    base: bytes = b"",
    paths: "list[bytes] | None" = None,
    suffix: bytes = b"/status",
    ctype: bytes = b"application/strategic-merge-patch+json",
):
    """Splice each row's values into its template and, given a ``pump``,
    ship the batch in the same C call (render, fingerprint and send under
    one GIL release).

    Returns ``(bodies, fps, status, need)``: per-row body views into one
    slab, each body's status fingerprint (the echo-drop seeds), each
    request's HTTP status (zeros without a pump) and the slab's size in
    bytes; None when the library is unavailable. A first guess that is
    too small re-renders into the exact size: the C side fingerprints
    and sends only a batch that fit, so the send happens once."""
    lib = load()
    if lib is None:
        return None
    n = len(hosts)
    ids = np.ascontiguousarray(tpl_ids, np.int32)
    bits = np.ascontiguousarray(cond_bits, np.uint32)
    host_blob, host_off = _blob(hosts)
    pod_blob, pod_off = _blob(ips)
    start_blob, start_off = _blob(starts)
    ctr_blob, ctr_off = _blob(ctrs)
    ictr_blob, ictr_off = _blob(ictrs)
    if paths is not None:
        path_blob, path_off = _blob(paths)
    else:
        path_blob, path_off = b"", np.zeros(n + 1, np.int64)
    out_off = np.zeros(n + 1, np.int64)
    fps = np.zeros(n, np.uint64)
    status = np.zeros(n, np.int32)
    handle = pump.handle if pump is not None else 0
    i32p = ctypes.POINTER(ctypes.c_int32)
    cap = max(2048, n * 512 + len(ctr_blob) * 4 + len(ictr_blob) * 4
              + len(start_blob) * 8)
    for _ in range(2):
        out = bytearray(cap)
        need = lib.kwok_emit_pods(
            handle, n,
            ids.ctypes.data_as(i32p),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            tpl.lit_blob,
            tpl.seg_code.ctypes.data_as(i32p),
            _i64p(tpl.seg_a), _i64p(tpl.seg_b), _i64p(tpl.tpl_off),
            tpl.tpl_kind.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            tpl.tpl_ready.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            host_blob, _i64p(host_off),
            pod_blob, _i64p(pod_off),
            start_blob, _i64p(start_off),
            ctr_blob, _i64p(ctr_off),
            ictr_blob, _i64p(ictr_off),
            now, len(now),
            (ctypes.c_char * len(out)).from_buffer(out), cap,
            _i64p(out_off),
            fps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            base, len(base),
            path_blob, _i64p(path_off),
            suffix, len(suffix),
            ctype, len(ctype),
            status.ctypes.data_as(i32p),
        )
        if need <= cap:
            return _split(out, out_off), fps, status, int(need)
        cap = need
    raise AssertionError("emit buffer sizing did not converge")


def render_pod_statuses(
    phase_kind: np.ndarray,
    cond_bits: np.ndarray,
    phase_names: list[bytes],
    cond_names: list[str],
    host_ips: list[bytes],
    pod_ips: list[bytes],
    start_times: list[bytes],
    containers: list[bytes],
    init_containers: list[bytes],
) -> "list[memoryview] | None":
    """Render a batch of pod status patches without templates (the
    ``KWOK_TPU_NATIVE_EMIT=0`` path). ``phase_kind`` per row: 0
    running-like, 1 terminated-ok, 2 terminated-error; containers are
    records ``"name\\x1fimage"`` joined by ``\\x1e``."""
    lib = load()
    if lib is None:
        return None
    n = len(phase_names)
    pk = np.ascontiguousarray(phase_kind, np.uint8)
    bits = np.ascontiguousarray(cond_bits, np.uint32)
    phase_blob, phase_off = _blob(phase_names)
    cname_blob, cname_off = _blob([c.encode() for c in cond_names])
    host_blob, host_off = _blob(host_ips)
    pod_blob, pod_off = _blob(pod_ips)
    start_blob, start_off = _blob(start_times)
    ctr_blob, ctr_off = _blob(containers)
    ictr_blob, ictr_off = _blob(init_containers)
    out_off = np.zeros(n + 1, np.int64)
    cap = max(2048, n * 512 + len(ctr_blob) * 4 + len(ictr_blob) * 4
              + len(start_blob) * 8)
    for _ in range(2):
        out = bytearray(cap)
        need = lib.kwok_render_pod_statuses(
            n,
            pk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            phase_blob, _i64p(phase_off),
            len(cond_names), cname_blob, _i64p(cname_off),
            host_blob, _i64p(host_off),
            pod_blob, _i64p(pod_off),
            start_blob, _i64p(start_off),
            ctr_blob, _i64p(ctr_off),
            ictr_blob, _i64p(ictr_off),
            (ctypes.c_char * len(out)).from_buffer(out), cap, _i64p(out_off),
        )
        if need <= cap:
            return _split(out, out_off)
        cap = need
    raise AssertionError("pod status buffer sizing did not converge")
