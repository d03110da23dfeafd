"""Behind-the-engine mutations of the port's in-process apiserver store.

The anti-entropy auditor (``kwok_tpu_torch/resilience/antientropy.py``)
exists for divergence that no watch event reports: a store restored behind
the engine's back, a stray ``kubectl edit``, a corrupted LIST body. These
helpers seed such divergence into ``kwok_tpu_torch.edge.mockserver.FakeKube``
under its lock, with no revision bump (except where a missed event needs a
real server revision), no watch event and no undo entry, so that only the
auditor's re-read of ground truth can see them. They are the port's
counterparts of ``silent_patch``/``silent_delete`` in ``kwok_tpu``'s
benchmark rig, shared by ``chip_smoke.py`` (its drift phase) and
``tests/test_torch_antientropy.py``.

Run as a script, it serves that mock in a process of its own, with the
same mutations as routes (``RigApiserver``), so an engine under test can
have its store changed behind its back without sharing an interpreter
with it::

    python3 drift_rig.py --port 0   # prints "mock apiserver listening on URL"

The port's native mock serves the same routes under ``--rig-routes``
(``kwok_tpu_torch/native/apiserver.cc``); ``RigClient`` drives either:

- ``POST /rig/silent`` ``{"op": "phase", "kind", "namespace", "name",
  "phase"}``, ``{"op": "delete", ...}`` or ``{"op": "create", "kind",
  "object"}``: ``silent_patch`` (the status phase), ``silent_delete`` or
  ``silent_create``; answers ``{"ok": bool, "object": ...}``;
- ``POST /rig/window`` ``{"events": N}``: the watch-cache window;
- ``POST /rig/stop-watches``: close every watch (each client re-lists);
- ``GET /rig/state``: the pods Running (phase Running with a pod IP), the
  pods in all, the first names not Running, the watch terminations by
  reason and the store's revision.
"""

from __future__ import annotations

import copy
import json
import sys
import urllib.parse


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def silent_patch(store, kind: str, namespace, name: str, mutate) -> bool:
    """``mutate(obj)`` edits the stored object in place; its stored JSON
    is re-encoded with the same resourceVersion. Returns whether the
    object existed."""
    key = store._key(namespace, name)
    with store._lock:
        obj = store._objs[kind].get(key)
        if obj is None:
            return False
        mutate(obj)
        store._bytes[kind][key] = _dumps(obj)
        return True


def silent_delete(store, kind: str, namespace, name: str) -> bool:
    """Remove a stored object without a DELETED event: the engine's row
    becomes a ghost. Returns whether the object existed."""
    key = store._key(namespace, name)
    with store._lock:
        gone = store._objs[kind].pop(key, None)
        store._bytes[kind].pop(key, None)
        store.keys_changed(kind)
        return gone is not None


def silent_create(store, kind: str, obj: dict) -> dict:
    """Store ``obj`` under a real server revision (the store's clock
    moves on) but deliver no ADDED event: the missed event. Returns the
    stored object."""
    obj = copy.deepcopy(obj)
    meta = obj.setdefault("metadata", {})
    key = store._key(meta.get("namespace"), meta["name"])
    with store._lock:
        if key in store._objs[kind]:
            raise ValueError(f"{kind} {key} exists")
        store._rv += 1
        meta["resourceVersion"] = str(store._rv)
        meta.setdefault("uid", f"uid-silent-{store._rv}")
        store._objs[kind][key] = obj
        store._bytes[kind][key] = _dumps(obj)
        store.keys_changed(kind)
        return copy.deepcopy(obj)


def owning_engine(eng, key):
    """The engine whose rows hold ``key``: a threaded lane's engine under
    lanes (``shard_of``), else ``eng``; and the lock that serializes that
    engine's pool writes (the lane's ``stage_lock``; None without lanes)."""
    from kwok_tpu_torch.engine.rowpool import shard_of

    lanes = eng._lanes
    if lanes is None:
        return eng, None
    lane = lanes.lanes[shard_of(key, lanes.n)]
    return lane.engine, lane.stage_lock


def row_rv(eng, kind: str, key) -> "int | None":
    """The resourceVersion of ``key``'s row in the engine (None: no row).
    Read without the lane's stage_lock, as the auditor reads rows (dict
    reads are atomic): a drain burst under a backlog holds that lock for
    thousands of items at a time, and a poll must not wait on it."""
    e, _lock = owning_engine(eng, key)
    k = e.pods if kind == "pods" else e.nodes
    idx = k.pool.lookup(key)
    if idx is None:
        return None
    return int((k.pool.meta[idx] or {}).get("rv") or 0)


def set_row_rv(eng, kind: str, key, rv: int) -> bool:
    """The double-apply: set ``key``'s row revision to ``rv`` (ahead of the
    server's) in the engine that owns the row, under that lane's
    ``stage_lock``. Returns whether the row existed."""
    e, lock = owning_engine(eng, key)
    k = e.pods if kind == "pods" else e.nodes
    if lock is not None:
        lock.acquire()
    try:
        idx = k.pool.lookup(key)
        if idx is None or not k.pool.meta[idx]:
            return False
        k.pool.meta[idx]["rv"] = int(rv)
        return True
    finally:
        if lock is not None:
            lock.release()


def pod_running(pod: dict) -> bool:
    st = pod.get("status") or {}
    return st.get("phase") == "Running" and bool(st.get("podIP"))


def state(store, limit: int = 8) -> dict:
    """``GET /rig/state``'s document (see the module docstring)."""
    with store._lock:
        pods = list(store._objs["pods"].values())
        rv = store._rv
        terms = dict(store.watch_terminations)
    stuck = [p["metadata"]["name"] for p in pods if not pod_running(p)]
    return {"running": len(pods) - len(stuck), "pods": len(pods),
            "not_running": sorted(stuck)[:limit], "terminations": terms, "rv": rv}


def _silent(store, doc: dict) -> dict:
    op, kind = doc.get("op"), doc.get("kind", "pods")
    if op == "phase":
        phase = doc["phase"]
        ok = silent_patch(store, kind, doc.get("namespace"), doc["name"],
                          lambda o: o.setdefault("status", {}).update(phase=phase))
        return {"ok": ok}
    if op == "delete":
        return {"ok": silent_delete(store, kind, doc.get("namespace"), doc["name"])}
    if op == "create":
        return {"ok": True, "object": silent_create(store, kind, doc["object"])}
    raise ValueError(f"unknown silent op {op!r}")


def _rig_server_class():
    from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver

    class RigApiserver(HttpFakeApiserver):
        """The port's Python mock with the rig's routes (the module
        docstring lists them)."""

        def _make_handler(self):
            base = super()._make_handler()
            store = self.store

            class Handler(base):
                def _rig(self, path: str, doc) -> None:
                    doc = doc or {}
                    if path == "/rig/silent":
                        out = _silent(store, doc)
                    elif path == "/rig/window":
                        store.rv_window = int(doc["events"])
                        out = {"ok": True}
                    elif path == "/rig/stop-watches":
                        store.stop_watches()
                        out = {"ok": True}
                    else:
                        self._send_json({"error": f"no rig route {path}"}, 404)
                        return
                    self._send_json(out)

                def do_POST(self):  # noqa: N802
                    path = urllib.parse.urlparse(self.path).path
                    if not path.startswith("/rig/"):
                        return super().do_POST()
                    try:
                        self._rig(path, self._body())
                    except Exception as e:  # a malformed rig request: 400
                        self._send_json({"error": repr(e)}, 400)

                def do_GET(self):  # noqa: N802
                    if urllib.parse.urlparse(self.path).path == "/rig/state":
                        self._send_json(state(store))
                        return
                    super().do_GET()

            return Handler

    return RigApiserver


class LocalRig:
    """``RigClient``'s calls on a store in this process."""

    def __init__(self, store) -> None:
        self.store = store

    def silent(self, **doc) -> dict:
        return _silent(self.store, doc)

    def window(self, events: int) -> None:
        self.store.rv_window = int(events)

    def stop_watches(self) -> None:
        self.store.stop_watches()

    def compact(self) -> int:
        return self.store.compact()

    def state(self) -> dict:
        return state(self.store)

    def get(self, kind: str, namespace, name: str) -> "dict | None":
        return self.store.get(kind, namespace, name)


class RigClient:
    """The rig's routes over HTTP, for a caller in another process."""

    def __init__(self, url: str) -> None:
        self.url = url

    def _call(self, method: str, path: str, doc=None, timeout: float = 60.0) -> dict:
        import urllib.request

        data = None if doc is None else json.dumps(doc).encode()
        req = urllib.request.Request(self.url + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def silent(self, **doc) -> dict:
        return self._call("POST", "/rig/silent", doc)

    def window(self, events: int) -> None:
        self._call("POST", "/rig/window", {"events": events})

    def stop_watches(self) -> None:
        self._call("POST", "/rig/stop-watches", {})

    def compact(self) -> int:
        return int(self._call("POST", "/compact", {})["compactedRevision"])

    def state(self) -> dict:
        return self._call("GET", "/rig/state")

    def get(self, kind: str, namespace, name: str) -> "dict | None":
        import urllib.error

        path = (f"/api/v1/namespaces/{namespace}/{kind}/{name}" if namespace
                else f"/api/v1/{kind}/{name}")
        try:
            return self._call("GET", path)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise


def main(argv=None) -> int:
    """Serve ``RigApiserver`` on ``--port`` until SIGTERM, as
    ``python -m kwok_tpu_torch.edge.mockserver`` serves its mock."""
    import argparse
    import signal

    p = argparse.ArgumentParser(prog="drift_rig.py")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(argv)
    srv = _rig_server_class()(port=args.port)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
