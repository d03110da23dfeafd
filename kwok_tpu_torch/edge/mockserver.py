"""A small apiserver speaking the engine's KubeClient protocol, in memory
and over HTTP.

``FakeKube`` keeps nodes and pods in dicts behind one lock and fans each
write out to the open watches of its kind. The engine can be driven
against it in process; it covers the verbs of ``edge/kubeclient.py`` —
create, get, list, watch, patch_status, patch_meta and delete — with the
semantics the engine relies on:

- every write bumps one global resourceVersion and is delivered to each
  matching watch as the object's JSON, serialized once;
- status patches are strategic-merged (``edge/merge.py``);
- deleting a pod with a grace period or finalizers only marks it
  (``deletionTimestamp``); the kubelet (the engine) strips finalizers and
  deletes with grace 0. With no grace given a pod gets its
  ``spec.terminationGracePeriodSeconds``, or 30.

The watch cache is ``kwok_tpu.edge.mockserver``'s: the last
``RV_WINDOW`` events are kept, and a watch that resumes from a revision
gets the events after it replayed, then goes live with no gap between the
two. A revision below the window (or below a ``compact()``) raises
``WatchExpired`` (410 Gone: the client re-lists), one ahead of the store
``TooLargeResourceVersion``. Watches that opt in get BOOKMARK events
(``emit_bookmarks``): objects that carry only the store's revision, so a
quiet watch's resume revision keeps up with compaction.

A paginated LIST is a consistent snapshot, as etcd's MVCC read is: every
page carries the first page's revision and shows the store as it was
then, rolled back through an undo log kept over the same window (a key
created later is hidden and earns no continue token). The first page of
a ``limit`` list reports ``remainingItemCount``.

``HttpFakeApiserver`` puts an HTTP front on a ``FakeKube``: the routes
``edge/httpclient.HttpKubeClient`` uses (``/api/v1/{nodes,pods}`` list
with ``limit``/``continue``, ``?watch=1`` as a chunked stream of JSON
lines with ``resourceVersion`` and ``allowWatchBookmarks``, get, POST
create, PATCH ``/status`` and metadata, DELETE with
``gracePeriodSeconds``, ``/version``, ``/healthz`` and ``POST
/compact``), a timer that sends bookmarks every ``BOOKMARK_INTERVAL``
seconds, and the observability routes of the native server: ``GET
/metrics`` (``telemetry/apiserver_metrics``: inflight and rejected per
band, both 0, and watch terminations, then the per-phase request timing
families) and ``GET /debug/flight`` (the ring of recent request records,
``"server": "mock"``); ``KWOK_TPU_APISERVER_TIMING=0`` turns the clock
stamps off. It is the front of ``kwok_tpu.edge.mockserver`` cut to
those routes: no TLS, audit, admission bands, slow-watcher termination,
snapshots or RBAC (ROADMAP item 13 and later). A watch's backlog is
the events queued for it and not yet written (the reference measures
its broadcast ring's cursor lag). On those routes it answers as the native mock apiserver
(``kwok_tpu_torch/native/apiserver.cc``) does, status bodies included
(``tests/test_torch_apiserver.py`` holds the two to each other). Run it
alone with

    python3 -m kwok_tpu_torch.edge.mockserver --port 0

which prints ``mock apiserver listening on URL``.
"""

from __future__ import annotations

import base64
import bisect
import collections
import copy
import json
import os
import queue
import re
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kwok_tpu_torch.edge.kubeclient import (
    ADDED,
    BOOKMARK,
    DELETED,
    MODIFIED,
    TooLargeResourceVersion,
    WatchEvent,
    WatchExpired,
    match_field_selector,
)
from kwok_tpu_torch.edge.merge import strategic_merge
from kwok_tpu_torch.edge.render import now_rfc3339
from kwok_tpu_torch.edge.selectors import parse_selector
from kwok_tpu_torch.telemetry.apiserver_metrics import (
    ApiserverTiming,
    LagHist,
    render_apiserver_metrics,
    render_timing_metrics,
)

KINDS = ("nodes", "pods")
KIND_SINGULAR = {"nodes": "Node", "pods": "Pod"}

# watch-cache window: how many recent events are kept for watches that
# resume from a revision. A resume below the window gets 410 Gone (etcd
# compaction); <= 0 disables the cache, so every resume expires.
RV_WINDOW = int(os.environ.get("KWOK_TPU_RV_WINDOW", "4096"))

# seconds between BOOKMARK events to the watches that opted in
# (allowWatchBookmarks=true); <= 0 disables the timer (tests call
# FakeKube.emit_bookmarks directly)
BOOKMARK_INTERVAL = float(os.environ.get("KWOK_TPU_BOOKMARK_INTERVAL", "60"))


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


class AlreadyExists(Exception):
    """Create of a name that exists (the apiserver's HTTP 409)."""


class _Watch:
    """One open watch: a queue of (type, object JSON) fed by the store's
    writes (after the replay of a resume). Iterating blocks for the next
    event and ends when the watch stops."""

    def __init__(self, server: "FakeKube", kind: str, field_selector,
                 label_selector, bookmarks: bool = False) -> None:
        self.server = server
        self.kind = kind
        self.field_selector = field_selector
        self.label_selector = parse_selector(label_selector)
        self.bookmarks = bool(bookmarks)
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.stopped = False

    def matches(self, obj: dict) -> bool:
        if not match_field_selector(obj, self.field_selector):
            return False
        if self.label_selector is not None:
            labels = (obj.get("metadata") or {}).get("labels") or {}
            if not self.label_selector.matches(labels):
                return False
        return True

    def __iter__(self):
        while True:
            ev = self.q.get()
            if ev is None:
                return
            yield WatchEvent(ev[0], json.loads(ev[1]))

    def lines(self):
        """The stream as watch-event JSON lines, in batches: each item is
        the list of lines queued by then (at least one). Ends when the
        watch stops."""
        while True:
            batch = [self.q.get()]
            while True:
                try:
                    batch.append(self.q.get_nowait())
                except queue.Empty:
                    break
            out = [
                b'{"type":"%s","object":%s}\n' % (ev[0].encode(), ev[1])
                for ev in batch if ev is not None
            ]
            if out:
                yield out
            if len(out) < len(batch):
                return

    def stop(self) -> None:
        self.server._unwatch(self)


class FakeKube:
    """In-memory nodes (cluster-scoped) and pods (namespaced)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objs: dict[str, dict] = {k: {} for k in KINDS}
        self._rv = 0
        self._watches: list[_Watch] = []
        # the watch cache: (rv, kind, type, object JSON) of recent events;
        # every revision at or below _compacted_rv is gone (a resume from
        # below it gets 410 Gone)
        self._history: collections.deque = collections.deque()
        self._compacted_rv = 0
        # each object's JSON as last committed, and the undo log over the
        # watch cache's window: (rv, kind, key, the key's JSON before that
        # event or None), which rolls a paginated LIST back to its revision
        self._bytes: dict[str, dict] = {k: {} for k in KINDS}
        self._undo: collections.deque = collections.deque()
        # objects removed for good (the smoke run checks its deletes)
        self.delete_count = 0
        # the observability surface of GET /metrics and /debug/flight:
        # per-phase timing and the flight ring, events encoded for at
        # least one watch, each watch's backlog at close, and the watch
        # closes by reason (none here: no slow-watcher cap, no deadline)
        self.timing = ApiserverTiming()
        self.encode_total = 0
        self.lag_hist = LagHist()
        self.watch_terminations = {"slow": 0, "deadline": 0}

    @staticmethod
    def _key(namespace, name) -> tuple[str, str]:
        return (namespace or "", name)

    def _commit_locked(self, kind: str, key, obj: dict, type_: str) -> bytes:
        """Bump the revision, stamp it, keep the event in the watch cache
        (and the key's previous JSON in the undo log) and deliver it
        (caller holds the lock, so every watch sees writes in revision
        order)."""
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        data = _dumps(obj)
        current = self._bytes[kind]
        prev = current.get(key)
        if type_ == DELETED:
            current.pop(key, None)
        else:
            current[key] = data
        if RV_WINDOW > 0:
            self._history.append((self._rv, kind, type_, data))
            self._undo.append((self._rv, kind, key, prev))
            while len(self._history) > RV_WINDOW:
                self._compacted_rv = max(
                    self._compacted_rv, self._history.popleft()[0]
                )
            while self._undo and self._undo[0][0] <= self._compacted_rv:
                self._undo.popleft()
        timing = self.timing
        t0 = time.perf_counter() if timing.enabled else None
        pushed = 0
        for w in self._watches:
            if w.kind == kind and w.matches(obj):
                w.q.put((type_, data))
                pushed += 1
        if pushed:
            # serialized once, delivered to every matching watch
            self.encode_total += 1
            timing.fanout_pushes += pushed
            if t0 is not None:
                timing.note_fanout(time.perf_counter() - t0)
        return data

    def _unwatch(self, w: _Watch) -> None:
        with self._lock:
            if not w.stopped:
                w.stopped = True
                self._watches.remove(w)
                self.lag_hist.observe(w.q.qsize())
                w.q.put(None)

    def watch_backlogs(self) -> list:
        """Each open watch's backlog: events queued and not yet written
        (``kwok_watch_backlog_events``; the peak is kept as scraped)."""
        with self._lock:
            lags = [w.q.qsize() for w in self._watches]
        peak = max(lags, default=0)
        if peak > self.timing.backlog_peak:
            self.timing.backlog_peak = peak
        return lags

    def stop_watches(self) -> None:
        """End every open watch (the server is going away)."""
        with self._lock:
            watches = list(self._watches)
        for w in watches:
            w.stop()

    # -- serialized forms (the HTTP front's) ---------------------------------

    def create_bytes(self, kind: str, obj: dict) -> bytes:
        obj = copy.deepcopy(obj)
        meta = obj.setdefault("metadata", {})
        key = self._key(meta.get("namespace"), meta["name"])
        with self._lock:
            store = self._objs[kind]
            if key in store:
                raise AlreadyExists(f'{kind} "{key[1]}" already exists')
            meta.setdefault("creationTimestamp", now_rfc3339())
            meta.setdefault("uid", f"uid-{self._rv + 1}")
            store[key] = obj
            return self._commit_locked(kind, key, obj, ADDED)

    def get_bytes(self, kind: str, namespace, name: str) -> bytes | None:
        with self._lock:
            return self._bytes[kind].get(self._key(namespace, name))

    def list_bytes(self, kind: str, *, field_selector=None,
                   label_selector=None, limit: int = 0,
                   continue_: "str | None" = None):
        """One page of a LIST in key order, as the native server answers
        it: the JSON of at most ``limit`` (0 = all; a negative limit
        emits nothing) matching objects whose key sorts after the key of
        the ``continue_`` token, the token for the next page (None on the
        last), the list's revision, and on a first page with a limit the
        count of matches past the page (``remainingItemCount``), else 0.
        A first page carries a token only if that count is > 0, a later
        one whenever a key is left. Every page shows the store as of the
        first page's revision; a token whose revision is below the
        compaction floor raises WatchExpired (the apiserver's 410 for a
        continue token too old), a malformed one ValueError."""
        sel = parse_selector(label_selector)
        tok_rv, after = decode_continue(continue_) if continue_ else (0, None)
        first_page = not continue_

        def matches(obj) -> bool:
            return match_field_selector(obj, field_selector) and (
                sel is None
                or sel.matches((obj.get("metadata") or {}).get("labels") or {})
            )

        with self._lock:
            if not first_page and tok_rv < self._compacted_rv:
                raise WatchExpired("the provided continue parameter is too old")
            list_rv = self._rv if first_page else tok_rv
            live = self._objs[kind]
            # the keys' JSON at list_rv where a later event changed them
            # (None: absent then); newest first, so a key keeps the state
            # before its earliest event after list_rv
            rolled: dict = {}
            for rv, k, key, prev in reversed(self._undo):
                if rv <= list_rv:
                    break
                if k == kind:
                    rolled[key] = prev
            # gathered in insertion order, whose sorted runs the sort
            # reuses (a set's order would make each page's sort a full one)
            keys = [k for k in live if rolled.get(k, b"") is not None]
            keys += [k for k, v in rolled.items() if v is not None and k not in live]
            keys.sort()
            pos = bisect.bisect_right(keys, after) if after is not None else 0
            items: list[bytes] = []
            token = None
            rest = 0
            for i in range(pos, len(keys)):
                key = keys[i]
                if key in rolled:
                    data = rolled[key]
                    obj = json.loads(data)
                else:
                    obj, data = live[key], None
                if limit and len(items) >= limit:
                    if not first_page:
                        break  # later pages stop at the cut
                    rest += matches(obj)
                    continue
                if not matches(obj):
                    continue
                items.append(data if data is not None else self._bytes[kind][key])
                if limit and len(items) >= limit and i + 1 < len(keys):
                    token = encode_continue(list_rv, key)
            if first_page and not rest:
                token = None
            return items, token, list_rv, rest

    def patch_status_bytes(self, kind: str, namespace, name: str, patch):
        if isinstance(patch, (bytes, bytearray, memoryview)):
            patch = json.loads(bytes(patch))
        with self._lock:
            obj = self._objs[kind].get(self._key(namespace, name))
            if obj is None:
                return None
            obj["status"] = strategic_merge(
                obj.get("status") or {}, patch.get("status", patch)
            )
            return self._commit_locked(kind, self._key(namespace, name), obj, MODIFIED)

    def patch_meta_bytes(self, kind: str, namespace, name: str, patch: dict):
        """Merge-patch metadata (and spec); a None value removes a key."""
        with self._lock:
            obj = self._objs[kind].get(self._key(namespace, name))
            if obj is None:
                return None
            for section in ("metadata", "spec"):
                sec_patch = (patch or {}).get(section)
                if not sec_patch:
                    continue
                sec = obj.setdefault(section, {})
                for k, v in sec_patch.items():
                    if v is None:
                        sec.pop(k, None)
                    else:
                        sec[k] = copy.deepcopy(v)
            return self._commit_locked(kind, self._key(namespace, name), obj, MODIFIED)

    # -- KubeClient protocol ------------------------------------------------

    def create(self, kind: str, obj: dict) -> dict:
        return json.loads(self.create_bytes(kind, obj))

    def get(self, kind: str, namespace, name: str) -> dict | None:
        with self._lock:
            obj = self._objs[kind].get(self._key(namespace, name))
            return copy.deepcopy(obj) if obj is not None else None

    def list(self, kind: str, *, field_selector=None, label_selector=None):
        sel = parse_selector(label_selector)
        with self._lock:
            out = []
            for key in sorted(self._objs[kind]):
                obj = self._objs[kind][key]
                if not match_field_selector(obj, field_selector):
                    continue
                if sel is not None and not sel.matches(
                    (obj.get("metadata") or {}).get("labels") or {}
                ):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def watch(self, kind: str, *, field_selector=None, label_selector=None,
              resource_version=None, allow_bookmarks: bool = False) -> _Watch:
        """A watch from now on, or, with ``resource_version`` > 0, one that
        resumes strictly after that revision: the cached events after it
        that match the selectors are queued first, under the same lock as
        the registration, so nothing falls between the replay and the
        live events. A revision below the compaction floor (or any, with
        the cache disabled) raises WatchExpired, one ahead of the store
        TooLargeResourceVersion, a negative or non-numeric one
        ValueError (the HTTP front's 400)."""
        w = _Watch(self, kind, field_selector, label_selector, allow_bookmarks)
        rv = int(resource_version or 0)
        if rv < 0:
            raise ValueError(f"invalid resourceVersion: {rv}")
        with self._lock:
            if rv:
                if rv > self._rv:
                    raise TooLargeResourceVersion(rv, self._rv)
                if rv < self._compacted_rv or RV_WINDOW <= 0:
                    raise WatchExpired(f"too old resource version: {rv}")
                for hrv, hkind, htype, hdata in self._history:
                    if hrv > rv and hkind == kind and w.matches(json.loads(hdata)):
                        w.q.put((htype, hdata))
            self._watches.append(w)
        return w

    def compact(self) -> int:
        """Compact the watch cache now: a watch resuming from below the
        current revision gets 410 Gone (resuming at exactly it is still
        gap-free, as after an etcd compaction at that revision), and
        continue tokens below it expire. Returns the compacted revision."""
        with self._lock:
            self._history.clear()
            self._undo.clear()
            self._compacted_rv = self._rv
            return self._compacted_rv

    def emit_bookmarks(self) -> int:
        """Queue one BOOKMARK at the store's current revision to every
        live watch that opted in; the object carries only kind,
        apiVersion and metadata.resourceVersion. Returns how many watches
        got one."""
        sent = 0
        with self._lock:
            data = {}
            for w in self._watches:
                if not w.bookmarks:
                    continue
                if w.kind not in data:
                    data[w.kind] = _dumps({
                        "kind": KIND_SINGULAR[w.kind], "apiVersion": "v1",
                        "metadata": {"resourceVersion": str(self._rv)},
                    })
                w.q.put((BOOKMARK, data[w.kind]))
                sent += 1
        return sent

    def patch_status(self, kind: str, namespace, name: str, patch):
        data = self.patch_status_bytes(kind, namespace, name, patch)
        return json.loads(data) if data is not None else None

    def patch_meta(self, kind: str, namespace, name: str, patch: dict):
        data = self.patch_meta_bytes(kind, namespace, name, patch)
        return json.loads(data) if data is not None else None

    def delete(self, kind: str, namespace, name: str,
               grace_seconds: int | None = 0) -> None:
        """grace_seconds=None applies the pod default: its
        ``spec.terminationGracePeriodSeconds``, or 30 s."""
        key = self._key(namespace, name)
        with self._lock:
            obj = self._objs[kind].get(key)
            if obj is None:
                return
            if grace_seconds is None:
                grace_seconds = 0
                if kind == "pods":
                    tgps = (obj.get("spec") or {}).get("terminationGracePeriodSeconds")
                    grace_seconds = 30 if tgps is None else int(tgps)
            meta = obj.setdefault("metadata", {})
            if kind == "pods" and (grace_seconds > 0 or meta.get("finalizers")):
                # graceful: mark, and wait for the kubelet to force-delete
                meta.setdefault("deletionTimestamp", now_rfc3339())
                meta["deletionGracePeriodSeconds"] = grace_seconds
                self._commit_locked(kind, key, obj, MODIFIED)
                return
            del self._objs[kind][key]
            self.delete_count += 1
            self._commit_locked(kind, key, obj, DELETED)

    def count(self, kind: str, where=None) -> int:
        """Objects of ``kind`` (those for which ``where(obj)`` is true,
        when given), counted in place without copying the store."""
        with self._lock:
            objs = self._objs[kind].values()
            if where is None:
                return len(objs)
            return sum(1 for o in objs if where(o))


# ------------------------------------------------------------------ HTTP

_PATHS = re.compile(
    r"^/api/v1(?:/namespaces/(?P<ns>[^/]+))?/(?P<kind>nodes|pods)"
    r"(?:/(?P<name>[^/]+))?(?:/(?P<sub>status))?$"
)

VERSION = {
    "major": "1", "minor": "26", "gitVersion": "v1.26.0-kwok-tpu",
    "platform": "linux/amd64",
}

# the native server's bare Status answers
NOT_FOUND = b'{"kind":"Status","code":404}'
BAD_REQUEST = b'{"kind":"Status","code":400}'


def _status(code: int, reason: str = "", message: str = "") -> dict:
    return {
        "kind": "Status", "apiVersion": "v1",
        "status": "Success" if code < 400 else "Failure",
        "message": message, "reason": reason, "code": code,
    }


def _too_large_rv_status(e: TooLargeResourceVersion) -> dict:
    """The apiserver's answer to a watch resume ahead of its store: 504
    reason Timeout with a ResourceVersionTooLarge cause and a
    retryAfterSeconds hint (retry semantics, not Expired)."""
    doc = _status(504, "Timeout", str(e))
    code = doc.pop("code")
    doc["details"] = {
        "causes": [{"reason": "ResourceVersionTooLarge",
                    "message": "Too large resource version"}],
        "retryAfterSeconds": int(e.retry_after),
    }
    doc["code"] = code  # last, as the native server writes it
    return doc


def leading_int(text: str) -> int:
    """C's ``atol``: optional blanks and sign, then the leading digits (0
    when there are none), as the native server reads ``limit``."""
    m = re.match(r"\s*([-+]?\d+)", text)
    return int(m.group(1)) if m else 0


def encode_continue(rv: int, key: tuple[str, str]) -> str:
    """The opaque continue token: url-safe base64 of ``rv \\0 ns \\0 name``
    (the layout of ``kwok_tpu.edge.mockserver``'s)."""
    return base64.urlsafe_b64encode(
        f"{rv}\x00{key[0]}\x00{key[1]}".encode()
    ).decode()


def decode_continue(token: str) -> tuple[int, tuple[str, str]]:
    """The revision of a continue token and the key it resumes after, read
    as the native server reads it (padding optional, a missing name
    empty); ValueError if malformed."""
    data = token.split("=", 1)[0]
    if not re.fullmatch(r"[A-Za-z0-9_-]*", data):
        raise ValueError("continue key is not valid")
    if len(data) % 4 == 1:
        data = data[:-1]  # six bits that make no byte
    raw = base64.urlsafe_b64decode(data + "=" * (-len(data) % 4)).decode(
        "utf-8", "surrogateescape"
    )
    rv, sep, rest = raw.partition("\x00")
    if not (sep and rv.isdigit() and rv.isascii()):
        raise ValueError("continue key is not valid")
    ns, _, name = rest.partition("\x00")
    return int(rv), (ns, name)


class _Server(ThreadingHTTPServer):
    # the default backlog of 5 drops connections under bursty load
    request_queue_size = 256
    daemon_threads = True

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError)):
            return  # the client closed its connection before the answer
        super().handle_error(request, client_address)


class HttpFakeApiserver:
    """An HTTP front on a ``FakeKube`` (its ``store``)."""

    def __init__(self, store: FakeKube | None = None, port: int = 0,
                 address: str = "127.0.0.1") -> None:
        self.store = store or FakeKube()
        self.httpd = _Server((address, port), self._make_handler())
        self.port = self.httpd.server_address[1]
        host = "127.0.0.1" if address in ("", "0.0.0.0") else address
        self.url = f"http://{host}:{self.port}"
        self._thread: threading.Thread | None = None
        self._bookmark_stop = threading.Event()
        self._bookmark_thread: threading.Thread | None = None

    def start(self) -> "HttpFakeApiserver":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="fake-apiserver"
        )
        self._thread.start()
        self.start_bookmarks()
        return self

    def start_bookmarks(self) -> None:
        """Send bookmarks to the opted-in watches every
        ``BOOKMARK_INTERVAL`` seconds (none when it is <= 0)."""
        if BOOKMARK_INTERVAL <= 0:
            return

        def loop():
            while not self._bookmark_stop.wait(BOOKMARK_INTERVAL):
                self.store.emit_bookmarks()

        self._bookmark_thread = threading.Thread(
            target=loop, daemon=True, name="bookmark-timer"
        )
        self._bookmark_thread.start()

    def stop(self) -> None:
        self._bookmark_stop.set()
        if self._bookmark_thread is not None:
            self._bookmark_thread.join(timeout=5)
        self.httpd.shutdown()
        self.httpd.server_close()
        # a stopping apiserver ends its watch streams, so the handler
        # threads blocked on a quiet watch let their sockets go
        self.store.stop_watches()
        if self._thread:
            self._thread.join(timeout=5)

    def _make_handler(self):
        store = self.store

        timing = store.timing

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # one TCP segment per response: with Nagle the body segment
            # waits for the client's delayed ACK of the headers
            disable_nagle_algorithm = True
            wbufsize = -1  # fully buffered: headers and body in one write

            def log_message(self, *a):
                pass

            # ---- per-phase timing, stamped as kwok_tpu's mock and the
            # native server stamp it. parse_request runs after the
            # request line was read, so read_headers excludes keep-alive
            # idle time
            def parse_request(self):
                self._t_start = timing.begin_request()
                self._t_hdr = self._t_body = self._t_parse = None
                self._commit_s = 0.0
                self._parse_ran = False
                ok = super().parse_request()
                if ok and self._t_start is not None:
                    self._t_hdr = time.perf_counter()
                return ok

            def _commit(self, fn, *args, **kw):
                """One store call, its wall time attributed to the commit
                phase (the fanout subset comes through timing.tls)."""
                if self._t_start is None:
                    return fn(*args, **kw)
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self._commit_s += time.perf_counter() - t0

            def _finish_timing(self, code: int, enc_s: float) -> None:
                t0 = self._t_start
                self._t_start = None  # one observation per request
                t_end = time.perf_counter()
                parsed = urllib.parse.urlparse(self.path)
                m = _PATHS.match(parsed.path)
                if not m:
                    return  # ops and debug paths stay untimed
                t_hdr = self._t_hdr or t0
                t_body = self._t_body or t_hdr
                phases = {
                    "read_headers": t_hdr - t0,
                    "read_body": t_body - t_hdr,
                    "commit": self._commit_s,
                    "encode": enc_s,
                }
                if self._parse_ran:
                    phases["parse"] = self._t_parse - t_body
                fan = getattr(timing.tls, "fanout_s", 0.0) or 0.0
                if fan:
                    phases["fanout"] = fan
                total = t_end - t0
                method = (self.command or "").upper()
                if method == "GET":
                    q = urllib.parse.parse_qs(parsed.query)
                    if (q.get("watch") or ["false"])[0] in ("true", "1"):
                        verb, band = "watch", "none"
                    else:
                        verb = "get" if m.group("name") else "list"
                        band = "readonly"
                else:
                    verb = {"POST": "create", "PUT": "update",
                            "PATCH": "patch", "DELETE": "delete"}.get(
                        method, method.lower()
                    )
                    band = (
                        "mutating"
                        if method in ("POST", "PATCH", "DELETE")
                        else "none"
                    )
                timing.observe_request(verb, total, phases)
                timing.record_flight(
                    self.command or "", self.path, code, band,
                    time.time() - total, total * 1e6,
                    {p: v * 1e6 for p, v in phases.items()},
                )

            def _send_body(self, body: bytes, code: int = 200,
                           ctype: str = "application/json") -> None:
                t_enc = (
                    time.perf_counter()
                    if getattr(self, "_t_start", None) is not None
                    else None
                )
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                if t_enc is not None:
                    self._finish_timing(code, time.perf_counter() - t_enc)

            def _send_json(self, obj, code: int = 200) -> None:
                self._send_body(_dumps(obj), code)

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                timed = getattr(self, "_t_start", None) is not None
                data = self.rfile.read(n) if n else b""
                if timed:
                    self._t_body = time.perf_counter()
                if not n:
                    return None
                doc = json.loads(data or b"null")
                if timed:
                    self._t_parse = time.perf_counter()
                    self._parse_ran = True
                return doc

            def _drain_body(self) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)

            def _route(self, named: bool = True):
                """(match, query) for a resource path of the verb's
                shape, else None after answering 404 as the native server
                does (the request body is drained first, so the
                keep-alive connection stays parseable). ``named``: True
                for a verb on one object (PATCH, DELETE), False for one on
                a collection (POST: no name, no subresource), None for
                either (GET)."""
                parsed = urllib.parse.urlparse(self.path)
                m = _PATHS.match(parsed.path)
                if m is not None and named is not None and (
                    bool(m.group("name")) != named or (not named and m.group("sub"))
                ):
                    m = None
                if m is None:
                    self._drain_body()
                    self._send_body(NOT_FOUND, 404)
                    return None
                return m, urllib.parse.parse_qs(parsed.query)

            def do_GET(self):  # noqa: N802
                path = urllib.parse.urlparse(self.path).path
                if path == "/healthz":
                    self._send_body(b"ok", ctype="text/plain")
                    return
                if path == "/version":
                    self._send_json(VERSION)
                    return
                if path == "/metrics":
                    body = render_apiserver_metrics(
                        {}, {}, store.watch_terminations,
                    ) + render_timing_metrics(
                        timing, store.watch_backlogs(), store.encode_total,
                        lag_hist=store.lag_hist,
                    )
                    self._send_body(body, ctype="text/plain; version=0.0.4")
                    return
                if path == "/debug/flight":
                    self._send_json(timing.flight_doc("mock"))
                    return
                route = self._route(named=None)
                if route is None:
                    return
                m, q = route
                kind, ns, name = m.group("kind"), m.group("ns"), m.group("name")
                if name:
                    body = self._commit(store.get_bytes, kind, ns, name)
                    if body is None:
                        self._send_body(NOT_FOUND, 404)
                    else:
                        self._send_body(body)
                    return
                fs = (q.get("fieldSelector") or [None])[0]
                ls = (q.get("labelSelector") or [None])[0]
                if (q.get("watch") or ["false"])[0] in ("true", "1"):
                    self._stream_watch(
                        kind, fs, ls, (q.get("resourceVersion") or [None])[0],
                        (q.get("allowWatchBookmarks") or ["false"])[0]
                        in ("true", "1"),
                    )
                    return
                try:
                    items, token, rv, remaining = self._commit(
                        store.list_bytes,
                        kind, field_selector=fs, label_selector=ls,
                        limit=leading_int((q.get("limit") or ["0"])[0]),
                        continue_=(q.get("continue") or [None])[0],
                    )
                except WatchExpired as e:
                    # a continue token older than the compaction floor:
                    # 410 Gone, and the client restarts its list
                    self._send_json(_status(410, "Expired", str(e)), 410)
                    return
                except ValueError as e:
                    self._send_json(_status(400, "BadRequest", str(e)), 400)
                    return
                meta = b'{"resourceVersion":"%d"' % rv
                if token is not None:
                    meta += b',"continue":' + _dumps(token)
                if remaining:
                    meta += b',"remainingItemCount":%d' % remaining
                self._send_body(
                    b'{"kind":"List","apiVersion":"v1","metadata":' + meta
                    + b'},"items":[' + b",".join(items) + b"]}"
                )

            def _stream_watch(self, kind, fs, ls, rv, bookmarks) -> None:
                try:
                    w = store.watch(
                        kind, field_selector=fs, label_selector=ls,
                        resource_version=rv, allow_bookmarks=bookmarks,
                    )
                except ValueError:
                    self._send_json(
                        _status(400, "BadRequest", "invalid resourceVersion"), 400
                    )
                    return
                except TooLargeResourceVersion as e:
                    # a resume ahead of the store fails the handshake
                    # (retry semantics), not with a stream ERROR event
                    self._send_json(_too_large_rv_status(e), 504)
                    return
                except WatchExpired as e:
                    # the real apiserver answers an expired resume with
                    # 200 + one ERROR event carrying a 410 Status
                    self.close_connection = True
                    payload = _dumps({
                        "type": "ERROR",
                        "object": _status(410, "Expired", str(e)),
                    }) + b"\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                # wfile is fully buffered: push the headers out now or
                # the client blocks until the first event
                self.wfile.flush()
                try:
                    for lines in w.lines():
                        for line in lines:
                            self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client went away
                finally:
                    w.stop()
                self.close_connection = True

            def do_POST(self):  # noqa: N802
                if urllib.parse.urlparse(self.path).path == "/compact":
                    # the mock's `etcdctl compact`: expire resumes and
                    # continue tokens below the current revision now
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        self.rfile.read(n)
                    self._send_json({"compactedRevision": store.compact()})
                    return
                route = self._route(named=False)
                if route is None:
                    return
                m, _q = route
                obj = self._body()
                if not isinstance(obj, dict):
                    self._send_body(BAD_REQUEST, 400)
                    return
                if m.group("ns"):
                    obj.setdefault("metadata", {})["namespace"] = m.group("ns")
                if not (obj.get("metadata") or {}).get("name"):
                    self._send_body(BAD_REQUEST, 400)
                    return
                try:
                    body = self._commit(store.create_bytes, m.group("kind"), obj)
                except AlreadyExists as e:
                    self._send_json(_status(409, "AlreadyExists", str(e)), 409)
                    return
                self._send_body(body, 201)

            def do_PATCH(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return
                m, _q = route
                patch = self._body()
                kind, ns, name = m.group("kind"), m.group("ns"), m.group("name")
                if not isinstance(patch, dict):
                    self._send_body(BAD_REQUEST, 400)
                    return
                if m.group("sub") == "status":
                    body = self._commit(store.patch_status_bytes, kind, ns, name, patch)
                else:
                    body = self._commit(store.patch_meta_bytes, kind, ns, name, patch)
                if body is None:
                    self._send_body(NOT_FOUND, 404)
                else:
                    self._send_body(body)

            def do_DELETE(self):  # noqa: N802
                route = self._route()
                if route is None:
                    return
                m, _q = route
                opts = self._body()
                grace = opts.get("gracePeriodSeconds") if isinstance(opts, dict) else None
                self._commit(
                    store.delete,
                    m.group("kind"), m.group("ns"), m.group("name"),
                    grace_seconds=None if grace is None else int(grace),
                )
                self._send_json({"kind": "Status", "status": "Success"})

            def do_PUT(self):  # noqa: N802
                # no update verb: the native server's 404
                self._drain_body()
                self._send_body(NOT_FOUND, 404)

        return Handler


def main(argv=None) -> int:
    """Standalone mock apiserver: ``--port N`` then serve until SIGTERM or
    interrupt."""
    import argparse
    import signal

    p = argparse.ArgumentParser(prog="kwok_tpu_torch.edge.mockserver")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--address", default="127.0.0.1",
                   help="bind address (0.0.0.0 to serve other hosts)")
    args = p.parse_args(argv)
    srv = HttpFakeApiserver(port=args.port, address=args.address)
    print(f"mock apiserver listening on {srv.url}", flush=True)

    # SIGTERM arrives on the thread running serve_forever, so calling
    # shutdown() from the handler would deadlock: raise instead and let
    # the exception unwind out of serve_forever
    def _term(*_a):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    srv.start_bookmarks()
    try:
        srv.httpd.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        srv._bookmark_stop.set()
        srv.httpd.server_close()
        srv.store.stop_watches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
