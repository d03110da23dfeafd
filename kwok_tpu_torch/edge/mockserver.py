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
``RV_WINDOW`` events are kept (``FakeKube.rv_window``, per store), and a watch that resumes from a revision
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

The chaos tier: a watch whose live backlog (the events queued for it and
not yet written; a resume's replay is kept apart and exempt) grows past
``WATCH_BACKLOG`` is closed as a slow watcher, its backlog dropped
(``kwok_watch_terminations_total{reason="slow"}``; the HTTP stream ends
with no terminal chunk and the client resumes or re-lists). ``dump()`` and
``load()`` are the mock's etcd snapshot and restore: a load replaces the
store, compacts the watch cache (every older resume and continue token
gets 410) and closes every watch. ``watchers_doc()`` is the census of
live watches.

``HttpFakeApiserver`` puts an HTTP front on a ``FakeKube``: the routes
``edge/httpclient.HttpKubeClient`` uses (``/api/v1/{nodes,pods}`` list
with ``limit``/``continue``, ``?watch=1`` as a chunked stream of JSON
lines with ``resourceVersion`` and ``allowWatchBookmarks``, get, POST
create, PATCH ``/status`` and metadata, DELETE with
``gracePeriodSeconds``, ``/version``, ``/healthz``, ``POST /compact``,
``GET /snapshot`` and ``POST /restore``), a timer that sends bookmarks
every ``BOOKMARK_INTERVAL`` seconds, two-band max-inflight admission
(``KWOK_TPU_MAX_INFLIGHT``/``KWOK_TPU_MAX_MUTATING_INFLIGHT`` or the
constructor's limits, 0 = off: a saturated band answers 429 with
Retry-After; watches are exempt), a 400 Status for a request body that
does not decode, and the observability routes of the native server: ``GET
/metrics`` (``telemetry/apiserver_metrics``: inflight and rejected per
band and watch terminations by reason, then the per-phase request timing
families), ``GET /debug/flight`` (the ring of recent request records,
``"server": "mock"``) and ``GET /debug/watchers`` (``watchers_doc``);
``KWOK_TPU_APISERVER_TIMING=0`` turns the clock stamps off.

The leases of ``coordination.k8s.io/v1`` are ``kwok_tpu``'s minimal
dialect (create, GET, PATCH to renew or acquire; no list, watch or
delete), arbitrated by the server's clock, with the discovery documents
of ``/apis`` (the native server's, which also names the groups only
that server stores) and ``/apis/coordination.k8s.io/v1``. A mutating
request that carries ``FENCING_HEADER`` commits only while the lease it
names is held by the identity it names; otherwise it answers 409, and
the claim is checked and the write committed under one hold of the
store lock, which a takeover PATCH takes too, so a takeover cannot fall
between the two. It is the front
of ``kwok_tpu.edge.mockserver`` cut to those routes: no TLS, audit or
RBAC (ROADMAP item 16). On those routes it answers as
the native mock apiserver (``kwok_tpu_torch/native/apiserver.cc``) does,
status bodies included (``tests/test_torch_apiserver.py`` holds the two
to each other). Run it alone with

    python3 -m kwok_tpu_torch.edge.mockserver --port 0 [--data-file F]

which prints ``mock apiserver listening on URL`` (with ``--data-file``,
after ``restored store from F`` when the file exists; the store is
written back there at SIGTERM).
"""

from __future__ import annotations

import base64
import bisect
import collections
import copy
import heapq
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

# a watch whose live backlog (queued, not yet written) grows past this is
# closed as a slow watcher and its backlog dropped, instead of growing
# without bound; the client resumes or re-lists. A resume's replay is
# exempt (RV_WINDOW bounds it already: capping it would terminate every
# resume whose gap exceeds the cap, a loop). <= 0 disables the cap. The
# native server reads the same variable
WATCH_BACKLOG = int(os.environ.get("KWOK_TPU_WATCH_BACKLOG", "16384"))

# two-band max-inflight admission (kube-apiserver --max-requests-inflight
# and --max-mutating-requests-inflight): a saturated band answers 429 with
# Retry-After instead of queueing. 0 = the band is off (the default);
# watches are exempt, bounded by WATCH_BACKLOG instead
MAX_INFLIGHT = int(os.environ.get("KWOK_TPU_MAX_INFLIGHT", "0"))
MAX_MUTATING_INFLIGHT = int(os.environ.get("KWOK_TPU_MAX_MUTATING_INFLIGHT", "0"))
RETRY_AFTER_SECONDS = "1"
TOO_MANY_REQUESTS_BODY = (
    b'{"kind":"Status","apiVersion":"v1","status":"Failure",'
    b'"message":"Too many requests, please try again later.",'
    b'"reason":"TooManyRequests","code":429}'
)

# the kinds of a snapshot, in the native server's order: the kinds this
# mock does not serve are always empty there
SNAPSHOT_KINDS = ("nodes", "pods", "roles", "rolebindings", "clusterroles",
                  "clusterrolebindings", "events")


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


class NoMergeKey(Exception):
    """A status patch whose element of a merge list lacks the merge key
    (HTTP 500, the real apiserver's strategicpatch ErrNoMergeKey); the
    argument is the element as JSON."""


_MERGE_LISTS = ("conditions", "addresses")


def _no_merge_key(orig, patch, field: str = "") -> "str | None":
    """The first element of ``patch`` that a strategic merge into
    ``orig`` would append to an existing merge list without its ``type``
    key, as JSON, or None: the native server's ``no_merge_key``. Such an
    element is never merged, so an echo of the list doubles it."""
    if isinstance(patch, dict) and isinstance(orig, dict):
        if isinstance(patch.get("$patch"), str):
            return None  # replace / delete: no merge
        for k, v in patch.items():
            if k == "$patch" or v is None or k not in orig:
                continue
            bad = _no_merge_key(orig[k], v, k)
            if bad is not None:
                return bad
        return None
    if isinstance(patch, list) and isinstance(orig, list) and field in _MERGE_LISTS:
        if any(isinstance(i, dict) and i.get("$patch") == "replace" for i in patch):
            return None
        for item in patch:
            if not isinstance(item, dict) or "$patch" in item:
                continue
            if "type" not in item:
                return _dumps(item).decode()
            if not isinstance(item["type"], str):
                continue
            for existing in orig:
                if isinstance(existing, dict) and existing.get("type") == item["type"]:
                    bad = _no_merge_key(existing, item, "")
                    if bad is not None:
                        return bad
                    break
    return None


class AlreadyExists(Exception):
    """Create of a name that exists (the apiserver's HTTP 409)."""


class _WatchQueue:
    """A watch's events as one queue of (type, object JSON): the replay of
    a resume first (``replay``, exempt from the backlog cap), then the
    live events the store's writes put (``live``, the backlog)."""

    def __init__(self) -> None:
        self.replay: collections.deque = collections.deque()
        self.live: "queue.SimpleQueue" = queue.SimpleQueue()

    def put(self, item) -> None:
        self.live.put(item)

    def get(self, block: bool = True, timeout: "float | None" = None):
        try:
            return self.replay.popleft()
        except IndexError:
            return self.live.get(block, timeout)

    def get_nowait(self):
        return self.get(False)

    def qsize(self) -> int:
        return len(self.replay) + self.live.qsize()

    def empty(self) -> bool:
        return self.qsize() == 0


class _Watch:
    """One open watch: its events in ``q`` (a resume's replay, then the
    live events). Iterating blocks for the next event and ends when the
    watch stops; a slow-watcher close (``terminated``) drops what is
    queued."""

    def __init__(self, server: "FakeKube", kind: str, field_selector,
                 label_selector, bookmarks: bool = False) -> None:
        self.server = server
        self.kind = kind
        self.field_selector = field_selector
        self.label_selector = parse_selector(label_selector)
        self.bookmarks = bool(bookmarks)
        self.q = _WatchQueue()
        self.stopped = False
        #: "slow" once the server closed it for its backlog
        self.terminated: "str | None" = None
        #: wall stamp of registration (GET /debug/watchers age_s)
        self.created_unix = time.time()

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
            if ev is None or self.terminated:
                return
            yield WatchEvent(ev[0], json.loads(ev[1]))

    def lines(self):
        """The stream as watch-event JSON lines, in batches: each item is
        the list of lines queued by then (at least one). Ends when the
        watch stops, at once when it was terminated (``terminated`` is
        set: the caller ends the stream abruptly)."""
        while True:
            batch = [self.q.get()]
            while True:
                try:
                    batch.append(self.q.get_nowait())
                except queue.Empty:
                    break
            if self.terminated:
                return
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
        # each kind's keys in order, kept until a key comes or goes (a LIST
        # page then bisects instead of sorting the store)
        self._sorted: dict[str, list] = {}
        # objects removed for good (the smoke run checks its deletes)
        self.delete_count = 0
        # the observability surface of GET /metrics and /debug/flight:
        # per-phase timing and the flight ring, events encoded for at
        # least one watch, each watch's backlog at close, and the watch
        # closes by reason ("slow": the backlog cap; no deadline here)
        self.timing = ApiserverTiming()
        self.encode_total = 0
        self.lag_hist = LagHist()
        self.watch_terminations = {"slow": 0, "deadline": 0}
        # the slow-watcher cap and the watch-cache window, per store
        # (tests tighten them, a rig widens the window)
        self.watch_backlog = WATCH_BACKLOG
        self.rv_window = RV_WINDOW
        # coordination.k8s.io/v1 leases, keyed (namespace, name), under
        # the store lock; each keeps the wall epochs its expiry reads
        # beside the rendered stamps. Outside the watch and snapshot
        # machinery: leadership is polled, and a restored store must not
        # bring back an old holder
        self._leases: dict[tuple[str, str], dict] = {}

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
        window = self.rv_window
        if window > 0:
            self._history.append((self._rv, kind, type_, data))
            self._undo.append((self._rv, kind, key, prev))
            while len(self._history) > window:
                self._compacted_rv = max(
                    self._compacted_rv, self._history.popleft()[0]
                )
            while self._undo and self._undo[0][0] <= self._compacted_rv:
                self._undo.popleft()
        timing = self.timing
        t0 = time.perf_counter() if timing.enabled else None
        pushed = 0
        cap = self.watch_backlog
        slow = []
        for w in self._watches:
            if w.kind == kind and w.matches(obj):
                w.q.put((type_, data))
                pushed += 1
                if cap > 0 and w.q.live.qsize() > cap:
                    slow.append(w)
        for w in slow:
            self._close_watch_locked(w, terminated="slow")
        if pushed:
            # serialized once, delivered to every matching watch
            self.encode_total += 1
            timing.fanout_pushes += pushed
            if t0 is not None:
                timing.note_fanout(time.perf_counter() - t0)
        return data

    def _unwatch(self, w: _Watch) -> None:
        with self._lock:
            self._close_watch_locked(w)

    def _close_watch_locked(self, w: _Watch, terminated: "str | None" = None) -> None:
        """Close one watch (caller holds the lock). A graceful close still
        delivers what is queued; a termination (``terminated="slow"``)
        drops the backlog, is counted by reason, and ends the stream with
        no terminal chunk."""
        if w.stopped:
            return
        w.stopped = True
        self._watches.remove(w)
        # the stream's final backlog (a slow close: the overflow that
        # ended it)
        self.lag_hist.observe(w.q.live.qsize())
        if terminated:
            w.terminated = terminated
            self.watch_terminations[terminated] = (
                self.watch_terminations.get(terminated, 0) + 1
            )
            if self.watch_backlog > self.timing.backlog_peak:
                self.timing.backlog_peak = self.watch_backlog
            w.q.live = queue.SimpleQueue()  # the dropped backlog
        w.q.put(None)

    def watch_backlogs(self) -> list:
        """Each open watch's backlog: live events queued and not yet
        written, a resume's replay not counted (``kwok_watch_backlog_events``;
        the peak is kept as scraped)."""
        with self._lock:
            lags = [w.q.live.qsize() for w in self._watches]
        peak = max(lags, default=0)
        if peak > self.timing.backlog_peak:
            self.timing.backlog_peak = peak
        return lags

    def stop_watches(self) -> None:
        """End every open watch (the server is going away)."""
        with self._lock:
            for w in list(self._watches):
                self._close_watch_locked(w)

    def watchers_doc(self, server: str = "mock") -> dict:
        """The ``GET /debug/watchers`` census: every live watch's backlog
        (``lag_events``), its pending replay, age, band and the
        termination-risk class against the backlog cap, in the schema of
        ``kwok_tpu.edge.mockserver.watchers_doc`` and the native server
        (``telemetry/timeline.check_watchers``)."""
        now = time.time()
        cap = self.watch_backlog
        with self._lock:
            watchers = []
            parked = 0
            for w in self._watches:
                lag = w.q.live.qsize()
                replay = len(w.q.replay)
                if lag == 0 and replay == 0:
                    parked += 1  # its writer thread waits for an event
                watchers.append({
                    "kind": w.kind,
                    "lag_events": lag,
                    "replay_pending": replay,
                    "age_s": round(max(0.0, now - w.created_unix), 3),
                    "band": "none",  # watches are admission-exempt
                    "risk": ("none" if lag == 0
                             else ("lagging" if lag <= cap // 2 else "at_risk")),
                })
        return {
            "server": server,
            "backlog_cap": cap,
            "thread_per_watcher": True,
            "count": len(watchers),
            "parked_threads": parked,
            "watchers": watchers,
        }

    def dump(self) -> dict:
        """The whole store as one consistent snapshot (the mock's etcd
        snapshot): its revision and every object's committed JSON, ordered
        by (namespace, name), under the native server's kinds."""
        with self._lock:
            rv = self._rv
            objects = {
                kind: [json.loads(v) for _k, v in sorted(self._bytes[kind].items())]
                if kind in self._bytes else []
                for kind in SNAPSHOT_KINDS
            }
        return {"resourceVersion": rv, "objects": objects}

    def load(self, data: dict) -> None:
        """Replace the store from a ``dump()``: the restored objects keep
        their revisions, the store's clock moves past both worlds, the
        watch cache and the undo log are compacted (a resume or continue
        token from before gets 410) and every open watch is closed, so
        clients re-list, as after an etcd restore. One lock covers it
        all, so no write lands half in the old world and no ghost event
        reaches a resumed watcher."""
        objs: dict = {k: {} for k in KINDS}
        raw: dict = {k: {} for k in KINDS}
        for kind, items in (data.get("objects") or {}).items():
            if kind not in objs:
                continue
            for obj in items:
                meta = obj.get("metadata") or {}
                if not meta.get("name"):
                    continue
                key = self._key(meta.get("namespace"), meta["name"])
                objs[kind][key] = copy.deepcopy(obj)
                raw[kind][key] = _dumps(obj)
        with self._lock:
            self._objs, self._bytes = objs, raw
            self._sorted.clear()
            self._rv = max(self._rv, int(data.get("resourceVersion") or 0)) + 1
            self._history.clear()
            self._undo.clear()
            self._compacted_rv = self._rv
            for w in list(self._watches):
                self._close_watch_locked(w)

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
            self.keys_changed(kind)
            return self._commit_locked(kind, key, obj, ADDED)

    def keys_changed(self, kind: str) -> None:
        """A key of ``kind`` came or went (caller holds the lock)."""
        self._sorted.pop(kind, None)

    def _sorted_keys(self, kind: str) -> list:
        """The live keys of ``kind`` in order (caller holds the lock)."""
        keys = self._sorted.get(kind)
        if keys is None:
            keys = self._sorted[kind] = sorted(self._objs[kind])
        return keys

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
            # the snapshot's keys after the cursor, in order: the live keys
            # (bisected in the cached order) merged with the keys removed
            # since, skipping the keys created since
            ordered = self._sorted_keys(kind)
            lo = bisect.bisect_right(ordered, after) if after is not None else 0
            removed = sorted(
                k for k, v in rolled.items()
                if v is not None and k not in live and (after is None or k > after)
            )
            keys = heapq.merge((ordered[i] for i in range(lo, len(ordered))), removed)
            items: list[bytes] = []
            token = None
            pending = None  # the token, once a key after the page's last shows
            rest = 0
            for key in keys:
                if key in rolled:
                    data = rolled[key]
                    if data is None:
                        continue  # created after list_rv
                    obj = json.loads(data)
                else:
                    obj, data = live[key], None
                if pending is not None:
                    token, pending = pending, None
                if limit and len(items) >= limit:
                    if not first_page:
                        break  # later pages stop at the cut
                    rest += matches(obj)
                    continue
                if not matches(obj):
                    continue
                items.append(data if data is not None else self._bytes[kind][key])
                if limit and len(items) >= limit:
                    pending = encode_continue(list_rv, key)
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
            current = obj.get("status") or {}
            bad = _no_merge_key(current, patch.get("status", patch))
            if bad is not None:
                raise NoMergeKey(bad)
            obj["status"] = strategic_merge(current, patch.get("status", patch))
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
            for key in self._sorted_keys(kind):
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
                if rv < self._compacted_rv or self.rv_window <= 0:
                    raise WatchExpired(f"too old resource version: {rv}")
                for hrv, hkind, htype, hdata in self._history:
                    if hrv > rv and hkind == kind and w.matches(json.loads(hdata)):
                        w.q.replay.append((htype, hdata))
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
            self.keys_changed(kind)
            self.delete_count += 1
            self._commit_locked(kind, key, obj, DELETED)

    # -- coordination.k8s.io/v1 leases ---------------------------------------
    #
    # The server's clock is the one authority: it stamps acquireTime and
    # renewTime when it takes the write and judges expiry by its own wall
    # clock, so a standby keeps PATCHing with its own identity and is
    # answered 409 until the lease has expired (client-go's leader
    # election with the Update replaced by a PATCH the server arbitrates).

    def _lease_render(self, ns: str, name: str, lease: dict) -> bytes:
        return _dumps({
            "kind": "Lease",
            "apiVersion": "coordination.k8s.io/v1",
            "metadata": {
                "name": name,
                "namespace": ns,
                "creationTimestamp": lease["created"],
                "uid": lease["uid"],
                "resourceVersion": str(lease["rv"]),
            },
            "spec": {
                "holderIdentity": lease["holder"],
                "leaseDurationSeconds": lease["duration"],
                "acquireTime": lease["acquire_str"],
                "renewTime": lease["renew_str"],
                "leaseTransitions": lease["transitions"],
            },
        })

    @staticmethod
    def _lease_spec(spec) -> tuple[str, int]:
        """(holderIdentity, leaseDurationSeconds) of a request's spec,
        read as the native server reads it: a spec that is not an object
        reads empty, numbers truncate, a string parses its leading
        integer ("2.5" -> 2), booleans and infinities read 0."""
        if not isinstance(spec, dict):
            return "", 0
        holder = spec.get("holderIdentity")
        holder = holder if isinstance(holder, str) else ""
        raw = spec.get("leaseDurationSeconds")
        duration = 0
        if isinstance(raw, bool):
            duration = 0
        elif isinstance(raw, (int, float)):
            try:
                duration = int(raw)
            except (OverflowError, ValueError):  # inf, nan
                duration = 0
        elif isinstance(raw, str):
            m = re.match(r"\s*[-+]?\d+", raw)
            duration = int(m.group()) if m else 0
        return holder, duration

    @staticmethod
    def _lease_expired(lease: dict, now: float) -> bool:
        """Expiry on the server's clock: a lease with no holder is
        vacant; otherwise it expires once renewTime + duration has passed
        (a duration <= 0 can be taken at once)."""
        if not lease["holder"]:
            return True
        return now >= lease["renew"] + max(0, lease["duration"])

    def lease_create(self, ns: str, name: str, spec) -> tuple[int, bytes]:
        """POST .../leases: acquire by creating (leaseTransitions 0); an
        existing lease answers 409 AlreadyExists."""
        holder, duration = self._lease_spec(spec)
        with self._lock:
            key = (ns or "", name)
            if key in self._leases:
                return 409, _dumps(_status(
                    409, "AlreadyExists", f'leases "{name}" already exists'))
            now = time.time()
            stamp = now_rfc3339()
            self._rv += 1  # lease writes share the store's clock
            rv = self._rv
            lease = {
                "holder": holder, "duration": duration,
                "acquire": now, "renew": now, "transitions": 0,
                "created": stamp, "uid": f"uid-{rv}", "rv": rv,
                "acquire_str": stamp, "renew_str": stamp,
            }
            self._leases[key] = lease
            return 201, self._lease_render(ns, name, lease)

    def lease_get(self, ns: str, name: str) -> tuple[int, bytes]:
        with self._lock:
            lease = self._leases.get((ns or "", name))
            if lease is None:
                return 404, NOT_FOUND
            return 200, self._lease_render(ns, name, lease)

    def lease_renew(self, ns: str, name: str, spec) -> tuple[int, bytes]:
        """PATCH .../leases/NAME, renew or acquire: the same holder
        renews; another holder gets 409 Conflict while the lease has not
        expired (a standby's early grab, a revived zombie's renew), and
        takes it once it has (leaseTransitions + 1)."""
        holder, duration = self._lease_spec(spec)
        with self._lock:
            lease = self._leases.get((ns or "", name))
            if lease is None:
                return 404, NOT_FOUND
            now = time.time()
            if holder != lease["holder"] and not self._lease_expired(lease, now):
                return 409, _dumps(_status(
                    409, "Conflict",
                    f'lease "{ns}/{name}" is held by "{lease["holder"]}" '
                    "and has not expired"))
            stamp = now_rfc3339()
            if holder != lease["holder"]:
                lease["holder"] = holder
                lease["acquire"] = now
                lease["acquire_str"] = stamp
                lease["transitions"] += 1
            lease["renew"] = now
            lease["renew_str"] = stamp
            if duration > 0:
                lease["duration"] = duration
            self._rv += 1
            lease["rv"] = self._rv
            return 200, self._lease_render(ns, name, lease)

    def lease_held(self, ns: str, name: str, holder: str) -> bool:
        """The fencing check: is the lease held by ``holder`` and
        unexpired on the server's clock? The HTTP front holds the store
        lock across the check and the write it guards."""
        with self._lock:
            lease = self._leases.get((ns or "", name))
            if lease is None or lease["holder"] != holder:
                return False
            return not self._lease_expired(lease, time.time())

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

# coordination.k8s.io/v1 leases: outside _PATHS, so exempt from admission
# and phase timing as every path that is not a resource's
_LEASE_PATHS = re.compile(
    r"^/apis/coordination\.k8s\.io/v1"
    r"/namespaces/(?P<ns>[^/]+)/leases(?:/(?P<name>[^/]+))?$"
)

#: a mutating request may carry this header naming the lease its writer
#: believes it holds, as ``<namespace>/<name>/<holderIdentity>``; the
#: write answers 409 unless that lease is held by that identity now
#: (server-side fencing: a revived zombie's in-flight writes die here)
FENCING_HEADER = "X-Kwok-Lease-Holder"

# discovery documents beyond /version, the native server's bytes
DISCOVERY = {
    "/apis": {
        "kind": "APIGroupList", "apiVersion": "v1",
        "groups": [
            {"name": g, "versions": [{"groupVersion": f"{g}/v1", "version": "v1"}],
             "preferredVersion": {"groupVersion": f"{g}/v1", "version": "v1"}}
            for g in ("rbac.authorization.k8s.io", "events.k8s.io", "coordination.k8s.io")
        ],
    },
    "/apis/coordination.k8s.io/v1": {
        "kind": "APIResourceList",
        "groupVersion": "coordination.k8s.io/v1",
        # create, get and patch only: leadership is polled, never watched
        "resources": [{"name": "leases", "singularName": "", "namespaced": True,
                       "kind": "Lease", "verbs": ["create", "get", "patch"]}],
    },
}


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


class _BadBody(Exception):
    """A request body that does not decode as JSON (garbled or truncated
    on the wire): answered 400 with the native server's Status."""


class _Admission:
    """Two-band max-inflight admission. A slot is held for the request's
    whole life, its body read and its answer included, so a band
    saturates exactly when that many requests are in flight. The lock
    guards only the counters."""

    def __init__(self, readonly_max: int, mutating_max: int) -> None:
        self.limits = {"readonly": readonly_max, "mutating": mutating_max}
        self.inflight = {"readonly": 0, "mutating": 0}
        self.rejected = {"readonly": 0, "mutating": 0}
        self._adm_lock = threading.Lock()

    def try_acquire(self, band: str) -> bool:
        with self._adm_lock:
            limit = self.limits[band]
            if limit > 0 and self.inflight[band] >= limit:
                self.rejected[band] += 1
                return False
            self.inflight[band] += 1
            return True

    def release(self, band: str) -> None:
        with self._adm_lock:
            self.inflight[band] -= 1


def _admission_band(method: str, path: str, query: str) -> "str | None":
    """The band a request is admitted through, or None when exempt: only
    resource requests are admitted (health, metrics, debug and the ops
    routes stay outside), and watches are long-running and exempt."""
    if not _PATHS.match(path):
        return None
    if method == "GET":
        q = urllib.parse.parse_qs(query)
        if (q.get("watch") or ["false"])[0] in ("true", "1"):
            return None
        return "readonly"
    if method in ("POST", "PATCH", "DELETE"):
        return "mutating"
    return None


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
                 address: str = "127.0.0.1", max_inflight: "int | None" = None,
                 max_mutating_inflight: "int | None" = None) -> None:
        self.store = store or FakeKube()
        # admission: None falls back to the environment; both bands off
        # means no admission object and no per-request cost
        ro = MAX_INFLIGHT if max_inflight is None else int(max_inflight)
        mu = (MAX_MUTATING_INFLIGHT if max_mutating_inflight is None
              else int(max_mutating_inflight))
        self._admission = _Admission(ro, mu) if (ro > 0 or mu > 0) else None
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
        server_obj = self

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
                try:
                    doc = json.loads(data or b"null")
                except ValueError as e:
                    # garbled or truncated request bytes: 400 (the
                    # _guarded chokepoint), before any store call
                    raise _BadBody() from e
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

            def _reject_429(self) -> None:
                """A saturated band: 429 with Retry-After (never queued),
                after draining the body so the keep-alive connection
                stays parseable."""
                self._drain_body()
                t_enc = time.perf_counter() if self._t_start is not None else None
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", RETRY_AFTER_SECONDS)
                self.send_header("Content-Length", str(len(TOO_MANY_REQUESTS_BODY)))
                self.end_headers()
                self.wfile.write(TOO_MANY_REQUESTS_BODY)
                if t_enc is not None:
                    self._finish_timing(429, time.perf_counter() - t_enc)

            def _admitted(self, impl) -> None:
                """One request through admission (when a band is on) and
                the garbled-body guard."""
                adm = server_obj._admission
                band = None
                if adm is not None:
                    parsed = urllib.parse.urlparse(self.path)
                    band = _admission_band(self.command or "", parsed.path, parsed.query)
                if band is not None and not adm.try_acquire(band):
                    self._reject_429()
                    return
                try:
                    try:
                        impl()
                    except _BadBody:
                        try:
                            self._send_body(BAD_REQUEST, 400)
                        except OSError:
                            self.close_connection = True
                finally:
                    if band is not None:
                        adm.release(band)

            def _lease_route(self, path: str):
                """(namespace, name or "") of a lease path, else None."""
                m = _LEASE_PATHS.match(path)
                if m is None:
                    return None
                return (urllib.parse.unquote(m.group("ns")),
                        urllib.parse.unquote(m.group("name") or ""))

            def _fenced_commit(self, fn):
                """Server-side write fencing: a request carrying
                FENCING_HEADER (``ns/name/holder``) runs ``fn`` only
                while that lease is held by that identity, checked and
                committed under one hold of the store lock (reentrant:
                the store call takes it again). Returns
                (fenced, result); the caller sends the 409 after the
                lock is released. The claim splits as the native
                server's does: no slash leaves every field empty, no
                second slash leaves name and holder empty."""
                hdr = self.headers.get(FENCING_HEADER)
                if not hdr:
                    return False, fn()
                ns, sep, rest = hdr.partition("/")
                if not sep:
                    ns = ""
                name, sep2, holder = rest.partition("/")
                if not sep2:
                    name = holder = ""
                with store._lock:
                    if not (name and holder and store.lease_held(ns, name, holder)):
                        self._fence_claim = (ns, name, holder)
                        return True, None
                    return False, fn()

            def _send_fencing_409(self) -> None:
                ns, name, holder = self._fence_claim
                self._send_json(_status(
                    409, "Conflict", f"fencing lease {ns}/{name} is not held by {holder}"), 409)

            def do_GET(self):  # noqa: N802
                self._admitted(self._do_get)

            def _do_get(self):
                path = urllib.parse.urlparse(self.path).path
                if path == "/healthz":
                    self._send_body(b"ok", ctype="text/plain")
                    return
                if path == "/version":
                    self._send_json(VERSION)
                    return
                if path == "/metrics":
                    adm = server_obj._admission
                    body = render_apiserver_metrics(
                        adm.inflight if adm else {}, adm.rejected if adm else {},
                        store.watch_terminations,
                    ) + render_timing_metrics(
                        timing, store.watch_backlogs(), store.encode_total,
                        lag_hist=store.lag_hist,
                    )
                    self._send_body(body, ctype="text/plain; version=0.0.4")
                    return
                if path == "/debug/flight":
                    self._send_json(timing.flight_doc("mock"))
                    return
                if path == "/debug/watchers":
                    self._send_json(store.watchers_doc("mock"))
                    return
                if path == "/snapshot":
                    # the mock's `etcdctl snapshot save`
                    self._send_json(store.dump())
                    return
                if path in DISCOVERY:
                    self._send_json(DISCOVERY[path])
                    return
                lease = self._lease_route(path)
                if lease is not None:
                    ns, name = lease
                    if not name:
                        self._send_body(NOT_FOUND, 404)  # no lease LIST
                        return
                    code, body = store.lease_get(ns, name)
                    self._send_body(body, code)
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
                    if not w.terminated:
                        # a slow-watcher close ends abruptly: no terminal
                        # chunk, the backlog is gone and the client
                        # resumes or re-lists
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client went away
                finally:
                    w.stop()
                self.close_connection = True

            def do_POST(self):  # noqa: N802
                self._admitted(self._do_post)

            def _do_post(self):
                if urllib.parse.urlparse(self.path).path == "/restore":
                    # the mock's `etcdctl snapshot restore` + etcd restart
                    store.load(self._body() or {})
                    self._send_json({"kind": "Status", "status": "Success"})
                    return
                if urllib.parse.urlparse(self.path).path == "/compact":
                    # the mock's `etcdctl compact`: expire resumes and
                    # continue tokens below the current revision now
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        self.rfile.read(n)
                    self._send_json({"compactedRevision": store.compact()})
                    return
                lease = self._lease_route(urllib.parse.urlparse(self.path).path)
                if lease is not None:
                    obj = self._body()
                    if lease[1]:
                        self._send_body(NOT_FOUND, 404)  # create is a collection POST
                        return
                    name = (obj.get("metadata") or {}).get("name") if isinstance(obj, dict) else None
                    if not name or not isinstance(name, str):
                        self._send_body(BAD_REQUEST, 400)
                        return
                    code, body = store.lease_create(lease[0], name, obj.get("spec"))
                    self._send_body(body, code)
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
                named = bool((obj.get("metadata") or {}).get("name"))
                try:
                    fenced, body = self._fenced_commit(
                        lambda: self._commit(store.create_bytes, m.group("kind"), obj)
                        if named else None)
                except AlreadyExists as e:
                    self._send_json(_status(409, "AlreadyExists", str(e)), 409)
                    return
                if fenced:
                    self._send_fencing_409()
                elif body is None:
                    self._send_body(BAD_REQUEST, 400)
                else:
                    self._send_body(body, 201)

            def do_PATCH(self):  # noqa: N802
                self._admitted(self._do_patch)

            def _do_patch(self):
                lease = self._lease_route(urllib.parse.urlparse(self.path).path)
                if lease is not None and lease[1]:
                    # renew or acquire; a body that is JSON but not an
                    # object reads as an empty spec, none at all is a 400
                    patch = self._body()
                    if patch is None:
                        self._send_body(BAD_REQUEST, 400)
                        return
                    code, body = store.lease_renew(
                        lease[0], lease[1], patch.get("spec") if isinstance(patch, dict) else None)
                    self._send_body(body, code)
                    return
                route = self._route()
                if route is None:
                    return
                m, _q = route
                patch = self._body()
                kind, ns, name = m.group("kind"), m.group("ns"), m.group("name")
                if not isinstance(patch, dict):
                    self._send_body(BAD_REQUEST, 400)
                    return
                write = store.patch_status_bytes if m.group("sub") == "status" else store.patch_meta_bytes
                try:
                    fenced, body = self._fenced_commit(
                        lambda: self._commit(write, kind, ns, name, patch))
                except NoMergeKey as e:
                    self._send_json(_status(
                        500, "InternalError",
                        f"map: {e.args[0]} does not contain declared merge key: type"), 500)
                    return
                if fenced:
                    self._send_fencing_409()
                elif body is None:
                    self._send_body(NOT_FOUND, 404)
                else:
                    self._send_body(body)

            def do_DELETE(self):  # noqa: N802
                self._admitted(self._do_delete)

            def _do_delete(self):
                route = self._route()
                if route is None:
                    return
                m, _q = route
                opts = self._body()
                grace = opts.get("gracePeriodSeconds") if isinstance(opts, dict) else None
                fenced, _r = self._fenced_commit(lambda: self._commit(
                    store.delete,
                    m.group("kind"), m.group("ns"), m.group("name"),
                    grace_seconds=None if grace is None else int(grace),
                ))
                if fenced:
                    self._send_fencing_409()
                    return
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
    p.add_argument("--data-file", default="",
                   help="persist the store here across restarts (the mock's "
                   "etcd data dir): loaded at startup, written on shutdown")
    p.add_argument("--max-inflight", type=int, default=None,
                   help="max concurrent LIST/GET requests before answering 429 "
                   "+ Retry-After (0 = off, default from KWOK_TPU_MAX_INFLIGHT)")
    p.add_argument("--max-mutating-inflight", type=int, default=None,
                   help="max concurrent POST/PATCH/DELETE requests before 429 "
                   "(0 = off, default from KWOK_TPU_MAX_MUTATING_INFLIGHT)")
    args = p.parse_args(argv)
    srv = HttpFakeApiserver(port=args.port, address=args.address,
                            max_inflight=args.max_inflight,
                            max_mutating_inflight=args.max_mutating_inflight)
    if args.data_file:
        try:
            with open(args.data_file) as f:
                srv.store.load(json.load(f))
            print(f"restored store from {args.data_file}", flush=True)
        except FileNotFoundError:
            pass

    # SIGTERM arrives on the thread running serve_forever, so calling
    # shutdown() from the handler would deadlock: raise instead and let
    # the exception unwind out of serve_forever. Installed before the
    # line below, so a caller may terminate as soon as it reads it
    def _term(*_a):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    print(f"mock apiserver listening on {srv.url}", flush=True)
    try:
        srv.start_bookmarks()
        srv.httpd.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        srv._bookmark_stop.set()
        srv.httpd.server_close()
        srv.store.stop_watches()
        if args.data_file:
            tmp = args.data_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(srv.store.dump(), f)
            os.replace(tmp, args.data_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
