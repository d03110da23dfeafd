"""The port's native mock apiserver (``kwok_tpu_torch/native/apiserver.cc``)
and its loader, held against the port's Python mock and ``kwok_tpu``'s.

- The loader: ``apiserver_binary()`` builds into ``kwok_tpu_torch/_build/``
  under a name carrying the hash of the source and the flags, returns None
  under ``KWOK_TPU_NATIVE=0``, and with a compiler that fails returns None
  and logs a WARNING.
- Twins: each scenario runs over HTTP against both of the port's
  servers, each fresh in a process of its own: the binary first (the
  scenario's own asserts run there too), then ``python -m
  kwok_tpu_torch.edge.mockserver``, and every status code and body the
  Python mock's run sees, with timestamps, uids and revisions masked,
  must equal the native run's (the native source is ``kwok_tpu``'s, whose
  own twins hold it to ``kwok_tpu``'s Python mock). The scenarios
  mirror ``tests/test_native_apiserver.py``, ``tests/test_rv_expiry.py``
  and ``tests/test_bookmarks.py``: CRUD and revision bumps, strategic
  merge against ``kwok_tpu_torch/edge/merge.py``, field and label
  selectors (``status.phase`` in both dialects), a filtered watch,
  graceful pod deletion, ``limit``/``continue`` pagination (a consistent
  snapshot, no trailing empty page, ``remainingItemCount``), watch resume,
  410 after ``POST /compact`` and under ``KWOK_TPU_RV_WINDOW=64``,
  bookmarks under ``KWOK_TPU_BOOKMARK_INTERVAL=0.3``, the error
  answers, and the observability routes with timing values masked: the
  ``GET /debug/flight`` schema (each server passes ``check_flight`` of
  both packages, and the records name the same requests) and the ``GET
  /metrics`` family set (families, types and label names, under the
  strict exposition parse).
- End to end: the port's CLI on the CPU against the port's native server
  ends in the same objects and delete count as ``kwok_tpu``'s CLI against
  ``kwok_tpu``'s native server.
- The port's pump reports status 0 for a dead server and dials again once
  the server is back on its port with the store it persisted
  (``--data-file``).

Every test skips only when the binary cannot be built (no compiler).
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from kwok_tpu_torch import native
from kwok_tpu_torch.edge.httpclient import HttpKubeClient
from kwok_tpu_torch.edge.kubeclient import BOOKMARK, TooLargeResourceVersion
from kwok_tpu_torch.edge.merge import strategic_merge
from tests.test_torch_engine import make_node, make_pod

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def binary() -> str:
    path = native.apiserver_binary()
    if path is None:
        pytest.skip("no C++ compiler")
    return path


class Server:
    """One of the port's mock apiservers in a process of its own:
    ``python`` (``kwok_tpu_torch.edge.mockserver``), ``python-rig``
    (``drift_rig.py``: that mock with the drift rig's routes) or
    ``native`` (the port's binary, or ``binary``), ``env`` added to its
    environment. Its
    URL is read off the "listening on" line (the native server prints
    "restored store from ..." first when given ``--data-file``)."""

    def __init__(self, which: str, args=(), env=None, binary: "str | None" = None):
        if which == "native":
            cmd = [binary or native.apiserver_binary(), "--port", "0", *args]
        elif which == "python-rig":
            cmd = [sys.executable, str(ROOT / "drift_rig.py"), "--port", "0", *args]
        else:
            cmd = [sys.executable, "-m", "kwok_tpu_torch.edge.mockserver", "--port", "0", *args]
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True,
            env={**os.environ, **(env or {})},
        )
        self.url = None
        deadline = time.time() + 30
        while time.time() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            if "listening on" in line:
                self.url = line.rsplit(" ", 1)[-1].strip()
                break
        if self.url is None:
            self.stop()
            raise AssertionError(f"{which} mock apiserver did not start")

    def stop(self, sig=signal.SIGTERM) -> None:
        self.proc.send_signal(sig)
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.proc.stdout.close()


def call(url: str, method: str, path: str, body=None):
    """(status code, parsed JSON body or text) of one request, errors
    included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


_MASKED_KEYS = ("Time", "Timestamp", "startedAt", "finishedAt", "uid", "resourceVersion")


def masked(v):
    """Every timestamp, uid and resourceVersion value replaced by a
    marker, recursively."""
    if isinstance(v, dict):
        return {k: ("<masked>" if k.endswith(_MASKED_KEYS) else masked(x)) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [masked(x) for x in v]
    return v


def rv_of(doc) -> int:
    return int(doc["metadata"]["resourceVersion"])


def names(doc) -> list:
    return [o["metadata"]["name"] for o in doc["items"]]


def collect(watch, n: int, timeout: float = 10.0) -> list:
    """The first ``n`` events of ``watch`` as (type, object), read on a
    thread; the watch is stopped after."""
    events: list = []
    done = threading.Event()

    def consume():
        for ev in watch:
            events.append((ev.type, ev.object))
            if len(events) >= n:
                break
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    done.wait(timeout)
    watch.stop()
    t.join(5)
    return events


# ------------------------------------------------------------- scenarios
# each takes a server URL and returns what a client saw, in order


def crud(url):
    c = HttpKubeClient(url)
    out = [call(url, "POST", "/api/v1/nodes", make_node("n1")),
           call(url, "POST", "/api/v1/namespaces/default/pods", make_pod("p1", node="n1")),
           call(url, "GET", "/api/v1/nodes"),
           call(url, "GET", "/api/v1/namespaces/default/pods/p1"),
           call(url, "GET", "/api/v1/namespaces/default/pods/absent"),
           call(url, "PATCH", "/api/v1/nodes/n1/status", {"status": {"phase": "Running"}}),
           call(url, "PATCH", "/api/v1/namespaces/default/pods/p1",
                {"metadata": {"labels": {"a": "b"}}}),
           call(url, "PATCH", "/api/v1/namespaces/default/pods/p1", {"metadata": {"labels": None}}),
           call(url, "DELETE", "/api/v1/namespaces/default/pods/p1", {"gracePeriodSeconds": 0}),
           call(url, "GET", "/api/v1/namespaces/default/pods/p1"),
           call(url, "GET", "/healthz"), call(url, "GET", "/version")]
    # every write one revision up, from a fresh store's 0
    rvs = [rv_of(out[i][1]) for i in (0, 1, 5, 6, 7)]
    assert rvs == [1, 2, 3, 4, 5] and rv_of(out[2][1]) == 2
    assert [code for code, _ in out] == [201, 201, 200, 200, 404, 200, 200, 200, 200, 404, 200, 200]
    assert out[7][1]["metadata"].get("labels") is None
    assert c.get("pods", "default", "absent") is None and c.healthz()
    c.close()
    return {"calls": out, "rvs": rvs}


def merge(url):
    """The strategic merge on the shapes the engine emits: lists keyed by
    ``type``, atomic lists, nested objects, null deletion."""
    c = HttpKubeClient(url)
    base = {
        "phase": "Pending",
        "conditions": [{"type": "Ready", "status": "False", "reason": "old"},
                       {"type": "PodScheduled", "status": "True"}],
        "addresses": [{"type": "InternalIP", "address": "1.2.3.4"}],
        "containerStatuses": [{"name": "old", "ready": False}],
        "nested": {"keep": 1, "drop": 2},
    }
    pod = make_pod("merge-p", node="n")
    pod["status"] = base
    c.create("pods", pod)
    got, want = [], base
    for p in ({"phase": "Running"},
              {"conditions": [{"type": "Ready", "status": "True"}]},
              {"conditions": [{"type": "New", "status": "True"}]},
              {"addresses": [{"type": "InternalIP", "address": "5.6.7.8"}]},
              {"containerStatuses": [{"name": "new", "ready": True}]},
              {"nested": {"drop": None, "add": 3}}):
        want = strategic_merge(want, p)
        got.append(c.patch_status("pods", "default", "merge-p", {"status": p})["status"])
        assert got[-1] == want
    # a bare status document, with no {"status": ...} around it
    want = strategic_merge(want, {"phase": "Succeeded"})
    code, doc = call(url, "PATCH", "/api/v1/namespaces/default/pods/merge-p/status",
                     {"phase": "Succeeded"})
    assert code == 200 and doc["status"] == want
    got.append(doc)
    c.close()
    return got


def count_query(url, selector: str, limit: int = 1):
    q = urllib.parse.urlencode({"fieldSelector": selector, "limit": limit})
    code, doc = call(url, "GET", f"/api/v1/pods?{q}")
    return code, doc, len(doc["items"]) + int(doc["metadata"].get("remainingItemCount") or 0)


def selectors(url):
    c = HttpKubeClient(url)
    bound = make_pod("bound", node="n1")
    bound["metadata"]["labels"] = {"app": "web", "tier": "front"}
    c.create("pods", bound)
    unbound = make_pod("unbound")
    unbound["spec"]["nodeName"] = ""
    c.create("pods", unbound)
    out = {}
    for sel, want in (("spec.nodeName!=", ["bound"]), ("spec.nodeName=n1", ["bound"]),
                      ("spec.nodeName==n1", ["bound"]), ("metadata.name=unbound", ["unbound"])):
        out[sel] = [p["metadata"]["name"] for p in c.list("pods", field_selector=sel)]
        assert out[sel] == want, sel
    for sel, want in (("app=web", ["bound"]), ("app in (web, db)", ["bound"]),
                      ("app notin (web)", ["unbound"]), ("tier", ["bound"]), ("!tier", ["unbound"])):
        out[sel] = [p["metadata"]["name"] for p in c.list("pods", label_selector=sel)]
        assert out[sel] == want, sel
    # status.phase, as count pollers ask it (limit=1 + remainingItemCount)
    for i in range(7):
        c.create("pods", make_pod(f"pi-{i}", node="n0"))
    for i in range(4):
        c.patch_status("pods", "default", f"pi-{i}", {"status": {"phase": "Running"}})
    counts = []
    for sel in ("status.phase=Running", "status.phase==Running", "status.phase=Pending"):
        for limit in (1, 50):
            code, doc, n = count_query(url, sel, limit)
            counts.append((sel, limit, code, doc))
            assert n == (4 if "Running" in sel else 5), (sel, limit, doc)
    c.delete("pods", "default", "pi-0", grace_seconds=0)
    c.delete("pods", "default", "pi-1", grace_seconds=1)  # marked: still Running
    counts.append(count_query(url, "status.phase==Running"))
    assert counts[-1][2] == 3
    c.close()
    return {"lists": out, "counts": counts}


def watch_filtering(url):
    c = HttpKubeClient(url)
    w = c.watch("pods", field_selector="spec.nodeName!=")
    labelled = c.watch("pods", label_selector="app=web")  # registered: it answered
    unbound = make_pod("w-unbound")
    unbound["spec"]["nodeName"] = ""
    c.create("pods", unbound)  # filtered out of the first
    c.create("pods", make_pod("w1", node="n1"))
    c.patch_status("pods", "default", "w1", {"status": {"phase": "Running"}})
    c.patch_meta("pods", "default", "w-unbound", {"metadata": {"labels": {"app": "web"}}})
    c.delete("pods", "default", "w1", grace_seconds=0)
    events = collect(w, 3)
    assert [(t, o["metadata"]["name"]) for t, o in events] == [
        ("ADDED", "w1"), ("MODIFIED", "w1"), ("DELETED", "w1")]
    by_label = collect(labelled, 1)
    assert [(t, o["metadata"]["name"]) for t, o in by_label] == [("MODIFIED", "w-unbound")]
    c.close()
    return {"events": events, "by_label": by_label}


def graceful_deletion(url):
    c = HttpKubeClient(url)
    pod = make_pod("grace", node="n1", finalizers=["kwok.x-k8s.io/fake"])
    c.create("pods", pod)
    c.delete("pods", "default", "grace", grace_seconds=1)
    marked = c.get("pods", "default", "grace")
    assert "deletionTimestamp" in marked["metadata"]
    # the kubelet (the engine) strips the finalizers, then force-deletes
    stripped = c.patch_meta("pods", "default", "grace", {"metadata": {"finalizers": None}})
    c.delete("pods", "default", "grace", grace_seconds=0)
    assert c.get("pods", "default", "grace") is None
    # no grace given: the pod's terminationGracePeriodSeconds, or 30
    short = make_pod("short", node="n1")
    short["spec"]["terminationGracePeriodSeconds"] = 5
    c.create("pods", short)
    c.create("pods", make_pod("default-grace", node="n1"))
    c.delete("pods", "default", "short", grace_seconds=None)
    c.delete("pods", "default", "default-grace", grace_seconds=None)
    defaults = [c.get("pods", "default", n)["metadata"]["deletionGracePeriodSeconds"]
                for n in ("short", "default-grace")]
    assert defaults == [5, 30]
    c.delete("nodes", None, "absent")  # a delete of nothing answers Success
    c.close()
    return {"marked": marked, "stripped": stripped, "defaults": defaults}


def pages(url, path: str, limit: int, token: "str | None" = None) -> list:
    """Every page of a paginated LIST from ``token`` on."""
    out = []
    while True:
        q = {"limit": limit, **({"continue": token} if token else {})}
        code, doc = call(url, "GET", f"{path}?{urllib.parse.urlencode(q)}")
        out.append((code, doc))
        token = doc["metadata"].get("continue")
        if not token:
            return out


def pagination(url):
    c = HttpKubeClient(url)
    for n in "aceg":
        c.create("nodes", make_node(f"snap-{n}"))
    code, first = call(url, "GET", "/api/v1/nodes?limit=2")
    assert names(first) == ["snap-a", "snap-c"]
    assert first["metadata"]["remainingItemCount"] == 2
    # writes between the pages: the later pages still show the store as
    # of the first page's revision
    c.create("nodes", make_node("snap-b"))
    c.create("nodes", make_node("snap-d"))
    c.delete("nodes", None, "snap-e")
    c.patch_meta("nodes", None, "snap-g", {"metadata": {"labels": {"mid": "yes"}}})
    rest = pages(url, "/api/v1/nodes", 2, first["metadata"]["continue"])
    assert [n for _, doc in rest for n in names(doc)] == ["snap-e", "snap-g"]
    assert all(doc["metadata"]["resourceVersion"] == first["metadata"]["resourceVersion"]
               for _, doc in rest)
    assert rest[-1][1]["items"][-1]["metadata"]["labels"] == {}
    # keys created after the first page earn no trailing empty page
    _, tp = call(url, "GET", "/api/v1/nodes?limit=4")
    c.create("nodes", make_node("snap-y"))
    c.create("nodes", make_node("snap-z"))
    tail = pages(url, "/api/v1/nodes", 4, tp["metadata"]["continue"])
    assert [names(doc) for _, doc in tail] == [["snap-g"]]
    # remainingItemCount on a first page; a full pagination yields all
    count = call(url, "GET", "/api/v1/nodes?limit=1")
    assert count[1]["metadata"]["remainingItemCount"] == 6
    full = pages(url, "/api/v1/nodes", 4)
    assert [n for _, doc in full for n in names(doc)] == sorted(
        f"snap-{n}" for n in "abcdgyz")
    c.close()
    return {"first": (code, first), "rest": rest, "tp": tp, "tail": tail,
            "count": count, "full": full}


def resume_and_410(url):
    c = HttpKubeClient(url)
    a = c.create("nodes", make_node("a"))
    c.create("nodes", make_node("b"))
    replay = collect(c.watch("nodes", resource_version=rv_of(a)), 1)
    assert [o["metadata"]["name"] for _, o in replay] == ["b"]
    for i in range(6):
        c.create("pods", make_pod(f"p{i}"))
    code, page1 = call(url, "GET", "/api/v1/pods?limit=2")
    token = page1["metadata"]["continue"]
    q = urllib.parse.urlencode({"limit": 2, "continue": token})
    page2 = call(url, "GET", f"/api/v1/pods?{q}")
    c.create("pods", make_pod("extra"))
    compacted = call(url, "POST", "/compact")
    assert compacted[1]["compactedRevision"] == rv_of(c.get("pods", "default", "extra"))
    expired = c.watch("nodes", resource_version=rv_of(a))
    assert list(expired) == [] and expired.expired
    stale_page = call(url, "GET", f"/api/v1/pods?{q}")
    assert stale_page[0] == 410 and stale_page[1]["reason"] == "Expired"
    future = compacted[1]["compactedRevision"] + 100
    too_large = call(url, "GET", "/api/v1/nodes?" + urllib.parse.urlencode(
        {"watch": "true", "resourceVersion": str(future)}))
    assert too_large[0] == 504
    with pytest.raises(TooLargeResourceVersion):
        c.watch("nodes", resource_version=future)
    bad = [call(url, "GET", "/api/v1/pods?" + urllib.parse.urlencode(
        {"watch": "true", "resourceVersion": rv})) for rv in ("abc", "-1")]
    assert [b[0] for b in bad] == [400, 400]
    c.close()
    return {"replay": replay, "page2": page2, "compacted": compacted,
            "stale_page": stale_page, "too_large": too_large, "bad": bad}


def window_expiry(url):
    """Under KWOK_TPU_RV_WINDOW=64: a resume from below the last 64
    events gets the 410, one inside them the rest replayed."""
    c = HttpKubeClient(url)
    first = c.create("nodes", make_node("w-0"))
    for i in range(1, 100):
        last = c.create("nodes", make_node(f"w-{i}"))
    old = c.watch("nodes", resource_version=rv_of(first))
    assert list(old) == [] and old.expired
    recent = collect(c.watch("nodes", resource_version=rv_of(last) - 10), 10)
    assert [o["metadata"]["name"] for _, o in recent] == [f"w-{i}" for i in range(90, 100)]
    c.close()
    return {"recent": recent}


def bookmarks(url):
    """Under KWOK_TPU_BOOKMARK_INTERVAL=0.3: only the watch that opted in
    gets BOOKMARKs, each carrying only the store's revision."""
    c = HttpKubeClient(url)
    node = c.create("nodes", make_node("a"))
    plain = c.watch("nodes")
    events = collect(c.watch("nodes", allow_bookmarks=True), 2, timeout=5)
    assert [t for t, _ in events] == [BOOKMARK, BOOKMARK]
    for _, o in events:
        assert set(o) == {"kind", "apiVersion", "metadata"} and o["kind"] == "Node"
        assert o["metadata"] == {"resourceVersion": node["metadata"]["resourceVersion"]}
    assert collect(plain, 1, timeout=0.5) == []
    c.close()
    return events


def errors(url):
    c = HttpKubeClient(url)
    c.create("nodes", make_node("dup"))
    out = [call(url, "POST", "/api/v1/nodes", make_node("dup")),
           call(url, "POST", "/api/v1/nodes", {"metadata": {}}),
           call(url, "POST", "/api/v1/nodes", [1]),
           call(url, "POST", "/api/v1/nodes/dup", make_node("dup")),
           call(url, "PATCH", "/api/v1/nodes/absent/status", {"status": {}}),
           call(url, "PATCH", "/api/v1/nodes", {"metadata": {}}),
           call(url, "DELETE", "/api/v1/nodes"),
           call(url, "PUT", "/api/v1/nodes/dup", make_node("dup")),
           call(url, "GET", "/api/v1/services"),
           call(url, "GET", "/api/v1/nodes?limit=1&continue=not-base64!!"),
           call(url, "GET", "/api/v1/nodes?limit=1&continue=" + urllib.parse.quote(
               "LTMAAHg=")),  # revision -3
           call(url, "GET", "/api/v1/nodes?limit=abc")]
    assert [code for code, _ in out] == [409, 400, 400, 404, 404, 404, 404, 404, 404, 400, 400, 200]
    c.close()
    return out


def some_requests(url) -> None:
    """A create, a list, a status patch, a delete and a 404 of each kind
    of verb the engine sends."""
    c = HttpKubeClient(url)
    c.create("nodes", make_node("n0"))
    c.create("pods", make_pod("p0", node="n0"))
    c.list("pods")
    c.patch_status("pods", "default", "p0", {"status": {"phase": "Running"}})
    c.delete("pods", "default", "p0", grace_seconds=0)
    call(url, "GET", "/api/v1/namespaces/default/pods/absent")
    c.close()


def flight(url):
    from kwok_tpu.telemetry.timeline import check_flight as jax_check_flight
    from kwok_tpu_torch.telemetry.timeline import check_flight

    some_requests(url)
    code, doc = call(url, "GET", "/debug/flight")
    assert code == 200
    check_flight(doc)
    jax_check_flight(doc)
    assert doc["server"] in ("native", "mock") and doc["timing_enabled"]
    return {
        "keys": sorted(doc), "ring_capacity": doc["ring_capacity"],
        "captured": doc["captured"],
        "records": [(r["method"], r["path"], r["status"], r["band"], sorted(r["phases_us"]))
                    for r in doc["records"]],
    }


def metrics(url):
    from tests.test_metrics_exposition import parse_exposition

    some_requests(url)
    code, text = call(url, "GET", "/metrics")
    assert code == 200
    return sorted(
        (name, fam["type"], sorted({k for _, labels, _ in fam["samples"] for k in labels}))
        for name, fam in parse_exposition(text).items())


# ------------------------------------------ the chaos tier (ROADMAP 13c)
# the scenarios of tests/test_mock_snapshot.py and the chaos-tier cases of
# tests/test_native_apiserver.py that the port's Python mock can run


def _obj(kind, name, uid, ns=None, node=None):
    """An object with its uid and creationTimestamp fixed, so the two
    servers' stores compare byte for byte."""
    meta = {"name": name, "uid": uid, "creationTimestamp": "2026-01-02T03:04:05Z"}
    if ns:
        meta["namespace"] = ns
    doc = {"apiVersion": "v1", "kind": "Node" if kind == "nodes" else "Pod", "metadata": meta}
    if kind == "pods":
        doc["spec"] = {"nodeName": node or "n0", "containers": [{"name": "c", "image": "busybox"}]}
        doc["status"] = {"phase": "Pending"}
    return doc


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def snapshot_restore(url):
    """tests/test_mock_snapshot.py's restore sequence: a snapshot, writes
    the restore must erase, a live watch the restore must close, restored
    objects keeping their revisions, a resume from before answering the
    expired-watch dialect, and the store's clock moving on."""
    c = HttpKubeClient(url)
    out: dict = {}
    c.create("nodes", _obj("nodes", "n0", "uid-n0"))
    c.create("pods", _obj("pods", "p0", "uid-p0", ns="default"))
    c.create("pods", _obj("pods", "p1", "uid-p1", ns="default"))
    code, snap = call(url, "GET", "/snapshot")
    out["snapshot"] = (code, _canon(snap))
    c.create("pods", _obj("pods", "p2", "uid-p2", ns="default"))
    c.patch_status("pods", "default", "p0", {"status": {"phase": "Running"}})
    pre_rv = max(rv_of(p) for p in c.list("pods"))
    out["pre_restore_rv"] = pre_rv
    w = c.watch("pods")
    ended = threading.Event()
    threading.Thread(target=lambda: (list(w), ended.set()), daemon=True).start()
    time.sleep(0.2)  # the stream registers on the server
    out["restore"] = call(url, "POST", "/restore", snap)
    out["watch_closed"] = ended.wait(5.0)
    pods = c.list("pods")
    out["pods"] = _canon(sorted(pods, key=lambda p: p["metadata"]["name"]))
    out["rv_rewound"] = all(rv_of(p) < pre_rv for p in pods)
    gone = call(url, "GET", "/api/v1/pods?" + urllib.parse.urlencode(
        {"watch": "true", "resourceVersion": str(pre_rv)}))
    out["resume"] = (gone[0], gone[1]["type"], gone[1]["object"]["code"],
                     gone[1]["object"]["reason"])
    created = c.create("nodes", _obj("nodes", "n1", "uid-n1"))
    out["rv_monotonic"] = rv_of(created) > pre_rv
    _, after = call(url, "GET", "/snapshot")
    out["after"] = sorted(o["metadata"]["name"] for objs in after["objects"].values()
                          for o in objs)
    c.close()
    assert out["watch_closed"] and out["rv_rewound"] and out["rv_monotonic"]
    assert out["resume"][:3] == (200, "ERROR", 410) and '"p2"' not in out["pods"]
    return out


def _raw_response(url: str, method: str, path: str, body: bytes,
                  content_length: "int | None" = None, timeout: float = 5.0):
    """One request on a socket of its own: (status, body bytes), or (None,
    b"") when the server closed without an answer. ``content_length``
    above the body's promises bytes that never come."""
    import socket

    s = socket.socket()
    s.settimeout(timeout)
    s.connect(("127.0.0.1", int(url.rsplit(":", 1)[1])))
    cl = len(body) if content_length is None else content_length
    s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
              f"Content-Length: {cl}\r\nConnection: close\r\n\r\n".encode() + body)
    if content_length is not None and content_length > len(body):
        s.shutdown(socket.SHUT_WR)
    buf = b""
    try:
        while True:
            b = s.recv(65536)
            if not b:
                break
            buf += b
    except socket.timeout:
        pass
    s.close()
    if not buf:
        return None, b""
    head, _, rest = buf.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), rest


GARBLED = b'{"apiVersion":"v1","kind":"Pod","met\xff\x00adata":{{{{'


def bad_bodies(url):
    """Garbled JSON in a create, a status patch and a metadata patch: 400
    with the native server's Status; a truncated body; and the server
    keeps serving, its store intact."""
    c = HttpKubeClient(url)
    c.create("nodes", make_node("gb-n"))
    c.create("pods", make_pod("gb-p", node="gb-n"))
    out = {
        verb: _raw_response(url, method, path, GARBLED)
        for verb, method, path in (
            ("post", "POST", "/api/v1/namespaces/default/pods"),
            ("patch_status", "PATCH", "/api/v1/namespaces/default/pods/gb-p/status"),
            ("patch_meta", "PATCH", "/api/v1/namespaces/default/pods/gb-p"))
    }
    _raw_response(url, "POST", "/api/v1/namespaces/default/pods", GARBLED[:20],
                  content_length=512, timeout=3.0)
    out["after"] = [call(url, "GET", "/api/v1/namespaces/default/pods/gb-p")[0],
                    call(url, "POST", "/api/v1/nodes", make_node("gb-n2"))[0],
                    len(c.list("pods"))]
    c.close()
    assert [out[v][0] for v in ("post", "patch_status", "patch_meta")] == [400] * 3
    assert out["after"] == [200, 201, 1]
    return out


def malformed_utf8(url):
    """A status patch and a create whose strings hold malformed UTF-8 (a
    stray continuation byte, a truncated sequence, an overlong form, a
    code point past U+10FFFF) answer 400 and store nothing; well-formed
    multi-byte text goes through, and every LIST still decodes."""
    c = HttpKubeClient(url)
    c.create("nodes", make_node("u8-n"))
    c.create("pods", make_pod("u8-p", node="u8-n"))
    bad = [b"\xc3(", b"\xe2\x82", b"\xc0\xaf", b"\xf4\x90\x80\x80", b"\x80"]
    out = {"patch": [], "create": []}
    for i, raw in enumerate(bad):
        body = b'{"status":{"phase":"Running","hostIP":"' + raw + b'"}}'
        out["patch"].append(_raw_response(
            url, "PATCH", "/api/v1/namespaces/default/pods/u8-p/status", body)[0])
        pod = json.dumps(make_pod(f"u8-{i}", node="u8-n")).encode().replace(
            b'"name": "c"', b'"name": "c' + raw + b'"')
        out["create"].append(_raw_response(
            url, "POST", "/api/v1/namespaces/default/pods", pod)[0])
    good = {"status": {"phase": "Running", "hostIP": "h\u00e9\u20ac\U0001f600"}}
    out["good"] = c.patch_status("pods", "default", "u8-p", good)["status"]["hostIP"]
    out["list"] = [p["metadata"]["name"] for p in c.list("pods")]
    c.close()
    assert out["patch"] == [400] * len(bad) and out["create"] == [400] * len(bad)
    assert out["list"] == ["u8-p"] and out["good"] == good["status"]["hostIP"]
    return out


def _scrape(url: str) -> dict:
    from tests.test_metrics_exposition import parse_exposition

    _code, text = call(url, "GET", "/metrics")
    return {f"{name}{sorted(labels.items())}": v
            for name, fam in parse_exposition(text).items()
            if name in ("kwok_apiserver_inflight", "kwok_apiserver_rejected_total",
                        "kwok_watch_terminations_total")
            for _n, labels, v in fam["samples"]}


def admission(url):
    """Under KWOK_TPU_MAX_INFLIGHT=1 and KWOK_TPU_MAX_MUTATING_INFLIGHT=1:
    a POST held mid-body fills the mutating band, the next write gets
    429 with Retry-After 1 and the TooManyRequests Status, reads and
    watches pass (band separation, watches exempt), and once the held
    request completes writes are admitted again."""
    import http.client

    w = HttpKubeClient(url).watch("nodes")  # exempt: holds no readonly slot
    body = json.dumps(make_node("held")).encode()
    held = http.client.HTTPConnection("127.0.0.1", int(url.rsplit(":", 1)[1]))
    held.putrequest("POST", "/api/v1/nodes")
    held.putheader("Content-Type", "application/json")
    held.putheader("Content-Length", str(len(body)))
    held.endheaders()
    time.sleep(0.3)
    req = urllib.request.Request(url + "/api/v1/nodes", method="POST",
                                 data=json.dumps(make_node("n2")).encode())
    try:
        urllib.request.urlopen(req, timeout=5)
        rejected = None
    except urllib.error.HTTPError as e:
        rejected = (e.code, e.headers.get("Retry-After"), json.loads(e.read()))
    out = {"rejected": rejected, "list": call(url, "GET", "/api/v1/nodes")[0],
           "metrics_saturated": _scrape(url)}
    held.send(body)
    out["held"] = held.getresponse().status
    held.close()
    out["after"] = call(url, "POST", "/api/v1/nodes", make_node("n3"))[0]
    out["metrics_after"] = _scrape(url)
    w.stop()
    assert rejected is not None and rejected[:2] == (429, "1")
    assert rejected[2]["reason"] == "TooManyRequests"
    assert (out["list"], out["held"], out["after"]) == (200, 201, 201)
    return out


def backlog(url):
    """Under KWOK_TPU_WATCH_BACKLOG=8: a watcher that stops reading is
    closed once its backlog passes the cap, abruptly (no terminal chunk),
    counted as a slow termination, the backlog peak held at the cap; a
    resume whose replay is far longer than the cap is exempt and gets
    every event."""
    import socket

    stalled = socket.socket()
    stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    stalled.connect(("127.0.0.1", int(url.rsplit(":", 1)[1])))
    stalled.sendall(b"GET /api/v1/nodes?watch=true HTTP/1.1\r\nHost: x\r\n\r\n")
    time.sleep(0.2)
    c = HttpKubeClient(url)
    pad = "x" * 32768
    for i in range(200):
        c.create("nodes", {"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": f"bn{i}", "labels": {"pad": pad}}})
    time.sleep(0.3)
    m = _scrape(url)
    stalled.settimeout(10)
    tail = b""
    while True:
        b = stalled.recv(65536)
        if not b:
            break
        tail = (tail + b)[-64:]
    stalled.close()
    first = c.create("pods", make_pod("rp-0"))
    for i in range(1, 40):
        c.create("pods", make_pod(f"rp-{i}"))
    replay = collect(c.watch("pods", resource_version=rv_of(first)), 39)
    m_after = _scrape(url)
    _code, text = call(url, "GET", "/metrics")
    peak = [line for line in text.splitlines()
            if line.startswith('kwok_watch_backlog_events{agg="peak"}')]
    c.close()
    slow = "kwok_watch_terminations_total[('reason', 'slow')]"
    out = {"slow": m[slow], "clean_end": tail.endswith(b"0\r\n\r\n"),
           "replay": [o["metadata"]["name"] for _t, o in replay],
           "slow_after_resume": m_after[slow], "peak": float(peak[0].rsplit(" ", 1)[1])}
    assert out["slow"] == 1 and not out["clean_end"]
    assert out["replay"] == [f"rp-{i}" for i in range(1, 40)]
    assert out["slow_after_resume"] == 1 and 1 <= out["peak"] <= 8
    return out


def data_file(which):
    """--data-file: the store written at SIGTERM is back after a restart
    (the server prints "restored store from F" first), and the store's
    clock moves on past it."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "store.json")
        srv = Server(which, ["--data-file", path])
        try:
            c = HttpKubeClient(srv.url)
            c.create("nodes", _obj("nodes", "df-n", "uid-df-n"))
            c.create("pods", _obj("pods", "df-p", "uid-df-p", ns="default", node="df-n"))
            last = rv_of(c.patch_status("pods", "default", "df-p",
                                        {"status": {"phase": "Running"}}))
            c.close()
        finally:
            srv.stop()
        with open(path) as f:
            saved = json.load(f)
        srv = Server(which, ["--data-file", path])
        try:
            c = HttpKubeClient(srv.url)
            out = {"saved": _canon(saved), "nodes": call(srv.url, "GET", "/api/v1/nodes"),
                   "pod": call(srv.url, "GET", "/api/v1/namespaces/default/pods/df-p")}
            out["moved_on"] = rv_of(c.create("nodes", _obj("nodes", "df-n2", "u2"))) > last
            c.close()
        finally:
            srv.stop()
    assert out["pod"][1]["status"]["phase"] == "Running" and out["moved_on"]
    return out


data_file.own_server = True


def watchers(url):
    """GET /debug/watchers: the census of live watches passes
    check_watchers of both packages; an idle watch is parked, band none,
    risk none."""
    from kwok_tpu.telemetry.timeline import check_watchers as jax_check_watchers
    from kwok_tpu_torch.telemetry.timeline import check_watchers

    c = HttpKubeClient(url)
    c.create("nodes", make_node("w-n"))
    ws = [c.watch("nodes"), c.watch("pods", field_selector="spec.nodeName!=")]
    time.sleep(0.3)
    code, doc = call(url, "GET", "/debug/watchers")
    check_watchers(doc)
    jax_check_watchers(doc)
    for w in ws:
        w.stop()
    time.sleep(0.3)
    _, empty = call(url, "GET", "/debug/watchers")
    check_watchers(empty)
    c.close()
    return {"code": code, "keys": list(doc), "cap": doc["backlog_cap"],
            "threads": doc["thread_per_watcher"], "count": doc["count"],
            "parked": doc["parked_threads"],
            "watchers": sorted((w["kind"], w["lag_events"], w["replay_pending"], w["band"],
                                w["risk"], sorted(w)) for w in doc["watchers"]),
            "after_stop": empty["count"]}


def rig_routes(which):
    """The drift rig's routes (the native server under --rig-routes, the
    Python mock as drift_rig.py serves it): a phase set back and a
    delete with no event and no revision, a create under a real revision
    and no event; GET /rig/state; the window route narrows the watch
    cache; stop-watches ends every watch; bad requests answer 400."""
    import drift_rig

    srv = Server("native", ["--rig-routes"]) if which == "native" else Server("python-rig")
    try:
        url = srv.url
        c = HttpKubeClient(url)
        rig = drift_rig.RigClient(url)
        c.create("nodes", make_node("rn"))
        for i in range(2):
            pod = make_pod(f"rp{i}", "rn")
            pod["status"] = {"phase": "Running", "podIP": f"10.0.0.{i + 1}"}
            c.create("pods", pod)
        rv0 = rig.state()["rv"]
        w = c.watch("pods")
        out = {"state0": {k: v for k, v in rig.state().items() if k != "rv"},
               "phase": rig.silent(op="phase", kind="pods", namespace="default", name="rp0",
                                   phase="Pending"),
               "delete": rig.silent(op="delete", kind="pods", namespace="default", name="rp1"),
               "missing": rig.silent(op="phase", kind="pods", namespace="default", name="nope",
                                     phase="Pending"),
               "created": rig.silent(op="create", kind="pods", object=make_pod("rp2", "rn"))}
        out["rp0"] = rig.get("pods", "default", "rp0")
        out["rp1"] = rig.get("pods", "default", "rp1")
        out["created_rv"] = rv_of(out["created"]["object"]) - rv0
        out["created_uid"] = out["created"]["object"]["metadata"]["uid"] == (
            f"uid-silent-{rv0 + 1}")
        out["again"] = call(url, "POST", "/rig/silent", {"op": "create", "kind": "pods",
                                                         "object": make_pod("rp2", "rn")})[0]
        out["bad_op"] = call(url, "POST", "/rig/silent", {"op": "nope"})[0]
        out["bad_body"] = call(url, "POST", "/rig/window", [1])[0]
        st = rig.state()
        out["state"] = {**{k: v for k, v in st.items() if k != "rv"}, "rv": st["rv"] - rv0}
        c.create("pods", make_pod("rp3", "rn"))
        # the first event the open watch sees is the real create
        out["events"] = [(t, o["metadata"]["name"]) for t, o in collect(w, 1)]
        rig.window(2)
        first = c.create("nodes", make_node("wn0"))
        for i in range(1, 4):
            c.create("nodes", make_node(f"wn{i}"))
        old = c.watch("nodes", resource_version=rv_of(first))
        out["expired"] = list(old) == [] and old.expired
        live = c.watch("nodes")
        ended = threading.Event()
        threading.Thread(target=lambda: (list(live), ended.set()), daemon=True).start()
        rig.stop_watches()
        out["stopped"] = ended.wait(10)
        c.close()
    finally:
        srv.stop()
    assert out["phase"] == out["delete"] == {"ok": True} and out["missing"] == {"ok": False}
    assert out["rp0"]["status"]["phase"] == "Pending" and out["rp1"] is None
    assert out["created_rv"] == 1 and out["created_uid"]
    assert (out["again"], out["bad_op"], out["bad_body"]) == (400, 400, 400)
    assert out["state"] == {"running": 0, "pods": 2, "not_running": ["rp0", "rp2"],
                            "terminations": {"slow": 0, "deadline": 0}, "rv": 1}
    assert out["events"] == [("ADDED", "rp3")] and out["expired"] and out["stopped"]
    return out


rig_routes.own_server = True


_LEASES = "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases"
_STAMP = re.compile(rb"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")


def lease_call(url: str, method: str, path: str, body=None, headers=None) -> list:
    """[status code, the body's bytes with every RFC 3339 stamp masked]
    of one request: the lease twins compare bytes, not parsed JSON."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    return [code, _STAMP.sub(b"<stamp>", raw).decode()]


def lease_dialect(url):
    """``kwok_tpu``'s ``_drive_lease_dialect``: a miss, a create and a
    duplicate, a GET, a renew, another holder's grab of the unexpired
    lease, fenced writes (the holder's commits, another's gets 409),
    the takeover once the lease expired on the server's clock (1 s), the
    deposed holder's renew and the zombie's fenced write. Bytes with the
    stamps masked, uids and revisions included."""
    lease = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
             "metadata": {"name": "eng", "namespace": "kube-system"},
             "spec": {"holderIdentity": "alpha", "leaseDurationSeconds": 1}}
    renew = {"spec": {"holderIdentity": "alpha", "leaseDurationSeconds": 1}}
    steal = {"spec": {"holderIdentity": "beta", "leaseDurationSeconds": 1}}
    node = {"apiVersion": "v1", "kind": "Node", "metadata": {"name": "ln"}}
    patch = {"status": {"phase": "X"}}
    alpha = {"X-Kwok-Lease-Holder": "kube-system/eng/alpha"}
    out = {
        "get_missing": lease_call(url, "GET", _LEASES + "/eng"),
        "create": lease_call(url, "POST", _LEASES, lease),
        "create_duplicate": lease_call(url, "POST", _LEASES, lease),
        "get": lease_call(url, "GET", _LEASES + "/eng"),
        "renew": lease_call(url, "PATCH", _LEASES + "/eng", renew),
        "steal_unexpired_conflict": lease_call(url, "PATCH", _LEASES + "/eng", steal),
        "fenced_create_held": lease_call(url, "POST", "/api/v1/nodes", node, alpha),
        "fenced_patch_wrong_holder": lease_call(
            url, "PATCH", "/api/v1/nodes/ln/status", patch,
            {"X-Kwok-Lease-Holder": "kube-system/eng/beta"}),
        "fenced_delete_missing_claim": lease_call(
            url, "DELETE", "/api/v1/nodes/ln", None, {"X-Kwok-Lease-Holder": "kube-system/nope/alpha"}),
    }
    time.sleep(1.15)
    out["expiry_acquire"] = lease_call(url, "PATCH", _LEASES + "/eng", steal)
    out["deposed_holder_conflict"] = lease_call(url, "PATCH", _LEASES + "/eng", renew)
    out["zombie_fenced_patch"] = lease_call(url, "PATCH", "/api/v1/nodes/ln/status", patch, alpha)
    out["node_untouched"] = call(url, "GET", "/api/v1/nodes/ln")[1].get("status")
    codes = {k: v[0] for k, v in out.items() if k != "node_untouched"}
    assert codes == {"get_missing": 404, "create": 201, "create_duplicate": 409, "get": 200,
                     "renew": 200, "steal_unexpired_conflict": 409, "fenced_create_held": 201,
                     "fenced_patch_wrong_holder": 409, "fenced_delete_missing_claim": 409,
                     "expiry_acquire": 200, "deposed_holder_conflict": 409,
                     "zombie_fenced_patch": 409}, codes
    acquired = json.loads(out["expiry_acquire"][1])["spec"]
    assert (acquired["holderIdentity"], acquired["leaseTransitions"]) == ("beta", 1)
    assert "fencing lease kube-system/eng is not held by beta" in out["fenced_patch_wrong_holder"][1]
    assert out["node_untouched"] is None
    return out


def lease_discovery(url):
    """/apis names coordination.k8s.io, and the group's resource list
    serves create, get and patch on leases; the lease collection has no
    GET, a named lease no POST."""
    out = {path: lease_call(url, "GET", path)
           for path in ("/apis", "/apis/coordination.k8s.io/v1")}
    out["list"] = lease_call(url, "GET", _LEASES)
    out["post_named"] = lease_call(url, "POST", _LEASES + "/x", {"metadata": {"name": "x"}})
    doc = json.loads(out["/apis/coordination.k8s.io/v1"][1])
    assert doc["resources"][0]["verbs"] == ["create", "get", "patch"]
    assert (out["list"][0], out["post_named"][0]) == (404, 404)
    return out


def lease_hostile(url):
    """Bodies of the wrong shape (an array, string and boolean
    durations, no body) and malformed fencing claims answer alike and
    leave the handler serving."""
    out = [
        lease_call(url, "POST", _LEASES, [1]),
        lease_call(url, "POST", _LEASES, {"metadata": {"name": "hb"},
                                          "spec": {"holderIdentity": "a",
                                                   "leaseDurationSeconds": "2.5"}}),
        lease_call(url, "PATCH", _LEASES + "/hb", [1]),
        lease_call(url, "PATCH", _LEASES + "/hb", {"spec": {"holderIdentity": "a",
                                                            "leaseDurationSeconds": True}}),
        lease_call(url, "PATCH", _LEASES + "/hb"),
        lease_call(url, "PATCH", "/api/v1/nodes/hn/status", {"status": {"phase": "X"}},
                   {"X-Kwok-Lease-Holder": "a/b"}),
        lease_call(url, "PATCH", "/api/v1/nodes/hn/status", {"status": {"phase": "X"}},
                   {"X-Kwok-Lease-Holder": "garbage"}),
        lease_call(url, "GET", _LEASES + "/hb"),
    ]
    assert [c for c, _ in out] == [400, 201, 409, 200, 400, 409, 409, 200]
    assert json.loads(out[1][1])["spec"]["leaseDurationSeconds"] == 2
    return out


TYPELESS = {"address": "10.0.0.1", "tyqe": "InternalIP"}  # "type" renamed by a garble


def merge_key_missing(url):
    """A status patch whose element of an existing merge list lacks the
    merge key fails with the real apiserver's 500 and changes nothing;
    into a list the object does not hold yet it is taken as it comes; a
    replace directive and keyed elements merge as before."""
    node = make_node("mk")
    node["status"] = {"addresses": [dict(TYPELESS)]}
    out = {"create": lease_call(url, "POST", "/api/v1/nodes", node)[0]}
    path = "/api/v1/nodes/mk/status"
    out["echo"] = lease_call(url, "PATCH", path, {"status": {"addresses": [dict(TYPELESS)]}})
    out["fresh_list"] = lease_call(url, "PATCH", path, {"status": {"conditions": [{"reason": "x"}]}})[0]
    out["into_it"] = lease_call(url, "PATCH", path, {"status": {"conditions": [{"reason": "y"}]}})[0]
    out["keyed"] = lease_call(url, "PATCH", path, {"status": {"addresses": [
        {"type": "Hostname", "address": "mk"}]}})[0]
    out["replace"] = lease_call(url, "PATCH", path, {"status": {"addresses": [
        {"$patch": "replace"}, {"type": "InternalIP", "address": "10.0.0.2"}]}})[0]
    out["after_replace"] = lease_call(url, "PATCH", path, {"status": {"addresses": [dict(TYPELESS)]}})[0]
    out["stored"] = call(url, "GET", "/api/v1/nodes/mk")[1]["status"]
    assert out["echo"][0] == 500 and "does not contain declared merge key: type" in out["echo"][1]
    assert (out["fresh_list"], out["into_it"], out["keyed"], out["replace"],
            out["after_replace"]) == (200, 500, 200, 200, 500)
    assert out["stored"]["addresses"] == [{"type": "InternalIP", "address": "10.0.0.2"}]
    return out


def _echo_rounds(url, rounds: int = 12) -> list:
    """The engine's node-status loop by hand, with the port's own render
    and check (edge/render.py, edge/merge.py): GET the node, render its
    status (which echoes the addresses it holds), PATCH it when the check
    says it changed; the addresses' length after each round."""
    from kwok_tpu_torch.edge.merge import node_status_patch_needed
    from kwok_tpu_torch.edge.render import now_rfc3339, render_node_status
    from kwok_tpu_torch.engine.engine import _NODE_READY_BITS

    node = make_node("echo")
    node["status"] = {"addresses": [dict(TYPELESS)]}
    c = HttpKubeClient(url, timeout=20)
    c.create("nodes", node)
    lens = []
    for _ in range(rounds):
        node = c.get("nodes", None, "echo")
        rendered = render_node_status(node, _NODE_READY_BITS, "10.0.0.1",
                                      now_rfc3339(), now_rfc3339())
        if node_status_patch_needed(node.get("status") or {}, rendered):
            try:
                c.patch_status("nodes", None, "echo", {"status": rendered})
            except urllib.error.HTTPError as e:
                assert e.code == 500
        lens.append(len(c.get("nodes", None, "echo")["status"]["addresses"]))
    c.close()
    return lens


def test_echoed_address_without_merge_key_does_not_double(binary):
    """The drift phase's stall (ROADMAP §3): a garbled watch line that
    renamed a node address's "type" key left an element the native
    server appended on every status patch instead of merging; the engine
    echoes the addresses it holds and its own check merges the same way,
    so each round trip doubled the list (kwok_tpu's server keeps the
    fault: 12 rounds leave 4,096 elements) until one patch held the nodes
    shard for minutes. The port's server answers such a patch 500, as the
    real apiserver does, and the node keeps its one address."""
    from kwok_tpu import native as jnative

    port = Server("native")
    try:
        assert _echo_rounds(port.url) == [1] * 12
    finally:
        port.stop()
    ref_bin = jnative.apiserver_binary()
    if ref_bin is None:
        pytest.skip("kwok_tpu's native server did not build")
    ref = Server("native", binary=ref_bin)
    try:
        assert _echo_rounds(ref.url) == [2 ** (i + 1) for i in range(12)]
    finally:
        ref.stop()


def test_engine_holding_an_address_without_merge_key_keeps_the_server_live(binary):
    """The port's engine on two threaded lanes against the port's native
    server, a node stored with an address whose "type" key is renamed:
    the node still turns Ready, its heartbeats land, its addresses stay
    one, and the server answers a LIST at once."""
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

    srv = Server("native", env={"KWOK_TPU_BOOKMARK_INTERVAL": "0"})
    eng = None
    try:
        c = HttpKubeClient(srv.url, timeout=10)
        node = make_node("echo")
        node["status"] = {"addresses": [dict(TYPELESS)]}
        c.create("nodes", node)
        eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
            manage_all_nodes=True, drain_shards=2, tick_interval=0.02,
            heartbeat_interval=0.2, device="cpu"))
        eng.start()
        deadline = time.time() + 30
        while time.time() < deadline and eng.metrics.get("heartbeats_total", 0) < 5:
            time.sleep(0.05)
        got = c.get("nodes", None, "echo")["status"]
        t0 = time.time()
        c.list("nodes")
        listed_s = time.time() - t0
        c.close()
    finally:
        if eng is not None:
            eng.stop()
        srv.stop()
    assert eng.metrics.get("heartbeats_total", 0) >= 5
    assert got["addresses"] == [TYPELESS]
    assert any(x.get("type") == "Ready" and x.get("status") == "True"
               for x in got["conditions"])
    assert listed_s < 2.0


TWINS = {
    "merge_key_missing": (merge_key_missing, None),
    "lease_dialect": (lease_dialect, None), "lease_discovery": (lease_discovery, None),
    "lease_hostile": (lease_hostile, None),
    "crud": (crud, None), "merge": (merge, None), "selectors": (selectors, None),
    "watch_filtering": (watch_filtering, None), "graceful_deletion": (graceful_deletion, None),
    "pagination": (pagination, None), "resume_and_410": (resume_and_410, None),
    "window_expiry": (window_expiry, {"KWOK_TPU_RV_WINDOW": "64"}),
    "bookmarks": (bookmarks, {"KWOK_TPU_BOOKMARK_INTERVAL": "0.3"}),
    "errors": (errors, None), "flight": (flight, None), "metrics": (metrics, None),
    "snapshot_restore": (snapshot_restore, None), "bad_bodies": (bad_bodies, None),
    "admission": (admission, {"KWOK_TPU_MAX_INFLIGHT": "1",
                              "KWOK_TPU_MAX_MUTATING_INFLIGHT": "1"}),
    "backlog": (backlog, {"KWOK_TPU_WATCH_BACKLOG": "8"}),
    "data_file": (data_file, None), "watchers": (watchers, None),
    "rig_routes": (rig_routes, None), "malformed_utf8": (malformed_utf8, None),
}


def run_twin(which: str, name: str):
    scenario, env = TWINS[name]
    if getattr(scenario, "own_server", False):
        return masked(scenario(which))
    srv = Server(which, env={"KWOK_TPU_BOOKMARK_INTERVAL": "0", **(env or {})})
    try:
        return masked(scenario(srv.url))
    finally:
        srv.stop()


@pytest.mark.parametrize("name", sorted(TWINS), ids=[f"{n}-python" for n in sorted(TWINS)])
def test_twin(binary, name):
    ref = run_twin("native", name)
    assert run_twin("python", name) == ref


def test_rig_census_and_writes_on_the_native_server(binary):
    """The native server's port-only rig routes (--rig-routes): GET
    /rig/threads lists each connection thread's request and age and the
    store locks held at that moment; GET /rig/writes counts the status
    patches that set a pod Running (a second one for a pod shows in
    "twice") and the writes the lease fence answered 409. Without the
    flag neither route is served."""
    srv = Server("native", ["--rig-routes"])
    try:
        url = srv.url
        c = HttpKubeClient(url)
        c.create("nodes", make_node("wn"))
        for name in ("wp0", "wp1"):
            c.create("pods", make_pod(name, "wn"))
        running = {"status": {"phase": "Running", "podIP": "10.0.0.9"}}
        c.patch_status("pods", "default", "wp0", running)
        c.patch_status("pods", "default", "wp0", running)
        c.patch_status("pods", "default", "wp1", running)
        c.patch_status("pods", "default", "wp1", {"status": {"podIP": "10.0.0.8"}})
        lease_call(url, "POST", _LEASES, {"metadata": {"name": "eng"},
                                          "spec": {"holderIdentity": "a",
                                                   "leaseDurationSeconds": 30}})
        assert lease_call(url, "PATCH", "/api/v1/namespaces/default/pods/wp1/status",
                          running, {"X-Kwok-Lease-Holder": "kube-system/eng/b"})[0] == 409
        writes = call(url, "GET", "/rig/writes")[1]
        w = c.watch("pods")
        time.sleep(0.2)
        census = call(url, "GET", "/rig/threads")[1]
        w.stop()
        c.close()
    finally:
        srv.stop()
    assert writes == {"running_patched_pods": 2, "twice": ["default/wp0"], "most": 2,
                      "fenced_409": 1}
    assert census["held"] == []
    busy = [t for t in census["threads"] if t["busy"]]
    assert any(t["path"] == "/rig/threads" and t["method"] == "GET" for t in busy)
    assert any("watch=" in t["path"] and t["age_s"] > 0 for t in busy)
    assert all(t["tid"] > 0 and t["cpu_s"] >= 0 for t in census["threads"])
    plain = Server("native")
    try:
        assert call(plain.url, "GET", "/rig/threads")[0] == 404
        assert call(plain.url, "GET", "/rig/writes")[0] == 404
    finally:
        plain.stop()


# ---------------------------------------------------------------- loader


def test_binary_is_built_under_the_build_dir_by_hash(binary):
    path = pathlib.Path(binary)
    assert path.parent == ROOT / "kwok_tpu_torch" / "_build"
    assert path.name == pathlib.Path(native.apiserver_path()).name
    assert path.name.startswith("kwok-mock-apiserver-") and len(path.name) == 20 + 16
    assert os.access(path, os.X_OK)
    assert not (ROOT / "kwok_tpu_torch" / "native" / "kwok-mock-apiserver").exists()
    assert native.APISERVER_SOURCE not in native.SOURCES


def test_binary_is_none_under_native_off(binary, monkeypatch):
    monkeypatch.setenv("KWOK_TPU_NATIVE", "0")
    assert native.apiserver_binary() is None


def test_failed_build_is_none_and_a_warning(binary, monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_apiserver_path", None)
    monkeypatch.setattr(native, "_apiserver_tried", False)
    monkeypatch.setattr(native, "apiserver_build_log", "")
    monkeypatch.setenv("CXX", "false")
    with caplog.at_level(logging.WARNING, logger="kwok_tpu_torch.native"):
        assert native.apiserver_binary() is None
        assert native.apiserver_binary() is None  # tried once, not again
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "native apiserver build failed" in warnings[0].getMessage()
    assert os.listdir(tmp_path / "build") == []


# ------------------------------------------------------------ end to end


def cli_run(lib: str, tmp_path, monkeypatch):
    """Three nodes and six pods through one package's CLI against that
    package's native server: every pod Running, then two graceful deletes
    until both are gone. Returns the final objects (timestamps and
    revisions masked) and the DELETED events a pods watch saw."""
    from tests.test_torch_cli import base_args, run_cli, running, stage_file, wait_for

    if lib == "jax":
        from kwok_tpu import native as jnative
        from kwok_tpu.kwok.cli import main

        path = jnative.apiserver_binary()
        if path is None:
            pytest.skip("no C++ compiler")
    else:
        from kwok_tpu_torch.kwok.cli import main

        monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
        path = native.apiserver_binary()
    srv = Server("native", binary=path)
    c = HttpKubeClient(srv.url)
    try:
        for i in range(3):
            c.create("nodes", make_node(f"n{i}"))
        for i in range(6):
            c.create("pods", make_pod(f"p{i}", node=f"n{i % 3}",
                                      finalizers=["kwok.dev/guard"] if i == 0 else None))
        deleted: list = []
        w = c.watch("pods")

        def count_deletes():
            for ev in w:
                if ev.type == "DELETED":
                    deleted.append(ev.object["metadata"]["name"])

        threading.Thread(target=count_deletes, daemon=True).start()
        # one patch worker: IPs go out in row order in both engines
        argv = base_args(tmp_path, srv.url, stage_file(tmp_path)) + [
            "--drain-shards", "1", "--parallelism", "1"]
        stop, t, rc = run_cli(main, argv)
        try:
            assert wait_for(lambda: all(running(p) for p in c.list("pods")))
            c.delete("pods", "default", "p0", grace_seconds=30)
            c.delete("pods", "default", "p1", grace_seconds=30)
            assert wait_for(lambda: len(c.list("pods")) == 4 and len(deleted) == 2)
        finally:
            stop.set()
            t.join(30)
        assert rc == [0] and not t.is_alive()
        w.stop()
        objs = {k: masked(c.list(k)) for k in ("nodes", "pods")}
        return objs, sorted(deleted)
    finally:
        c.close()
        srv.stop()


def test_port_cli_on_native_server_matches_jax(binary, tmp_path, monkeypatch):
    ref = cli_run("jax", tmp_path, monkeypatch)
    got = cli_run("torch", tmp_path, monkeypatch)
    assert got == ref
    objs, deleted = got
    assert deleted == ["p0", "p1"] and len(objs["pods"]) == 4
    assert all(c["status"] == "True" for n in objs["nodes"]
               for c in n["status"]["conditions"] if c["type"] == "Ready")


def test_pump_survives_server_restart(binary, tmp_path):
    """The port's pump reports status 0 for requests lost to a dead
    server and dials again on its next call, once the server is back on
    the same port with the store it persisted."""
    data = str(tmp_path / "state.json")
    srv = Server("native", ["--data-file", data])
    port = int(srv.url.rsplit(":", 1)[1])
    pump = native.Pump("127.0.0.1", port, nconn=2)
    try:
        st = pump.send([
            ("POST", "/api/v1/nodes", json.dumps(
                {"apiVersion": "v1", "kind": "Node", "metadata": {"name": f"pr-{i}"}}).encode())
            for i in range(10)])
        assert (st == 201).all()
        srv.stop()  # SIGTERM: the store is persisted
        assert int(pump.send([("GET", "/healthz", b"")])[0]) == 0
        srv = Server("native", ["--data-file", data, "--port", str(port)])
        assert int(pump.send([("GET", "/api/v1/nodes/pr-3", b"")])[0]) == 200
        assert len(HttpKubeClient(srv.url).list("nodes")) == 10
    finally:
        pump.close()
        srv.stop()


# -------------------------------------- the store's snapshot, in process


def _dump_load(FakeKube) -> dict:
    a = FakeKube()
    a.create("nodes", {"metadata": {"name": "n0", "uid": "u0"}})
    a.create("pods", {"metadata": {"name": "p0", "namespace": "ns", "uid": "u1"}})
    snap = a.dump()
    b = FakeKube()
    w = b.watch("nodes")
    b.load(json.loads(json.dumps(snap)))  # through the wire's encoding
    closed = list(w) == []  # the restore closed the watch
    created = b.create("nodes", {"metadata": {"name": "n1", "uid": "u2"}})
    return {"rv": snap["resourceVersion"],
            "objects": {k: v for k, v in snap["objects"].items() if k in ("nodes", "pods")},
            "restored": [b.get("nodes", None, "n0"), b.get("pods", "ns", "p0")],
            "watch_closed": closed,
            "moved_on": int(created["metadata"]["resourceVersion"]) > snap["resourceVersion"]}


def test_dump_load_matches_jax_in_process():
    """tests/test_mock_snapshot.py's dump/load round trip and watch close
    on both packages' in-memory stores (timestamps masked)."""
    from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
    from kwok_tpu_torch.edge.mockserver import FakeKube

    got, ref = masked(_dump_load(FakeKube)), masked(_dump_load(JaxFakeKube))
    assert got == ref
    assert got["watch_closed"] and got["moved_on"] and all(got["restored"])
