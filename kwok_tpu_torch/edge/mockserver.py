"""A small in-memory apiserver speaking the engine's KubeClient protocol.

``FakeKube`` keeps nodes and pods in dicts behind one lock and fans each
write out to the open watches of its kind. It is what ``chip_smoke.py``
and the port's own tests drive the engine against; it covers the verbs of
``edge/kubeclient.py`` — create, get, list, watch, patch_status,
patch_meta and delete — with the semantics the engine relies on:

- every write bumps one global resourceVersion and is delivered to each
  matching watch as a fresh copy of the object;
- status patches are strategic-merged (``edge/merge.py``);
- deleting a pod with a grace period or finalizers only marks it
  (``deletionTimestamp``); the kubelet (the engine) strips finalizers and
  deletes with grace 0.

There is no watch cache: a watch that asks to resume from a revision gets
``WatchExpired`` and its client re-lists.
"""

from __future__ import annotations

import copy
import json
import queue
import threading

from kwok_tpu_torch.edge.kubeclient import (
    ADDED,
    DELETED,
    MODIFIED,
    WatchEvent,
    WatchExpired,
    match_field_selector,
)
from kwok_tpu_torch.edge.merge import strategic_merge
from kwok_tpu_torch.edge.render import now_rfc3339
from kwok_tpu_torch.edge.selectors import parse_selector

KINDS = ("nodes", "pods")


class AlreadyExists(Exception):
    """Create of a name that exists (the apiserver's HTTP 409)."""


class _Watch:
    """One open watch: a queue of WatchEvents fed by the store's writes.
    Iterating blocks for the next event and ends when the watch stops."""

    def __init__(self, server: "FakeKube", kind: str, field_selector,
                 label_selector) -> None:
        self.server = server
        self.kind = kind
        self.field_selector = field_selector
        self.label_selector = parse_selector(label_selector)
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
            yield ev

    def stop(self) -> None:
        self.server._unwatch(self)


class FakeKube:
    """In-memory nodes (cluster-scoped) and pods (namespaced)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objs: dict[str, dict] = {k: {} for k in KINDS}
        self._rv = 0
        self._watches: list[_Watch] = []
        # objects removed for good (the smoke run checks its deletes)
        self.delete_count = 0

    @staticmethod
    def _key(namespace, name) -> tuple[str, str]:
        return (namespace or "", name)

    def _commit_locked(self, kind: str, obj: dict, type_: str) -> bytes:
        """Bump the revision, stamp it, and deliver the event (caller
        holds the lock, so every watch sees writes in revision order)."""
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        data = json.dumps(obj, separators=(",", ":")).encode()
        for w in self._watches:
            if w.kind == kind and w.matches(obj):
                w.q.put(WatchEvent(type_, json.loads(data)))
        return data

    def _unwatch(self, w: _Watch) -> None:
        with self._lock:
            if not w.stopped:
                w.stopped = True
                self._watches.remove(w)
                w.q.put(None)

    # -- KubeClient protocol ------------------------------------------------

    def create(self, kind: str, obj: dict) -> dict:
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
            return json.loads(self._commit_locked(kind, obj, ADDED))

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
        """A live watch from now on. No watch cache: resuming from a
        revision raises WatchExpired (the client re-lists)."""
        if resource_version:
            raise WatchExpired(
                f"no watch cache: cannot resume from {resource_version}"
            )
        w = _Watch(self, kind, field_selector, label_selector)
        with self._lock:
            self._watches.append(w)
        return w

    def patch_status(self, kind: str, namespace, name: str, patch):
        if isinstance(patch, (bytes, bytearray, memoryview)):
            patch = json.loads(bytes(patch))
        with self._lock:
            obj = self._objs[kind].get(self._key(namespace, name))
            if obj is None:
                return None
            obj["status"] = strategic_merge(
                obj.get("status") or {}, patch.get("status", patch)
            )
            return json.loads(self._commit_locked(kind, obj, MODIFIED))

    def patch_meta(self, kind: str, namespace, name: str, patch: dict):
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
            return json.loads(self._commit_locked(kind, obj, MODIFIED))

    def delete(self, kind: str, namespace, name: str,
               grace_seconds: int | None = 0) -> None:
        """grace_seconds=None applies the pod default (30 s)."""
        key = self._key(namespace, name)
        with self._lock:
            obj = self._objs[kind].get(key)
            if obj is None:
                return
            if grace_seconds is None:
                grace_seconds = 30 if kind == "pods" else 0
            meta = obj.setdefault("metadata", {})
            if kind == "pods" and (grace_seconds > 0 or meta.get("finalizers")):
                # graceful: mark, and wait for the kubelet to force-delete
                meta.setdefault("deletionTimestamp", now_rfc3339())
                meta["deletionGracePeriodSeconds"] = grace_seconds
                self._commit_locked(kind, obj, MODIFIED)
                return
            del self._objs[kind][key]
            self.delete_count += 1
            self._commit_locked(kind, obj, DELETED)

    def count(self, kind: str, where=None) -> int:
        """Objects of ``kind`` (those for which ``where(obj)`` is true,
        when given), counted in place without copying the store."""
        with self._lock:
            objs = self._objs[kind].values()
            if where is None:
                return len(objs)
            return sum(1 for o in objs if where(o))
