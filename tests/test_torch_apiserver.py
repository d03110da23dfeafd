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
    ``python`` (``kwok_tpu_torch.edge.mockserver``) or ``native`` (the
    port's binary, or ``binary``), ``env`` added to its environment. Its
    URL is read off the "listening on" line (the native server prints
    "restored store from ..." first when given ``--data-file``)."""

    def __init__(self, which: str, args=(), env=None, binary: "str | None" = None):
        if which == "native":
            cmd = [binary or native.apiserver_binary(), "--port", "0", *args]
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


TWINS = {
    "crud": (crud, None), "merge": (merge, None), "selectors": (selectors, None),
    "watch_filtering": (watch_filtering, None), "graceful_deletion": (graceful_deletion, None),
    "pagination": (pagination, None), "resume_and_410": (resume_and_410, None),
    "window_expiry": (window_expiry, {"KWOK_TPU_RV_WINDOW": "64"}),
    "bookmarks": (bookmarks, {"KWOK_TPU_BOOKMARK_INTERVAL": "0.3"}),
    "errors": (errors, None), "flight": (flight, None), "metrics": (metrics, None),
}


def run_twin(which: str, name: str):
    scenario, env = TWINS[name]
    srv = Server(which, env={"KWOK_TPU_BOOKMARK_INTERVAL": "0", **(env or {})})
    try:
        return masked(scenario(srv.url))
    finally:
        srv.stop()


@pytest.mark.parametrize("name", sorted(TWINS), ids=[f"{n}-python" for n in sorted(TWINS)])
def test_twin(binary, name):
    ref = run_twin("native", name)
    assert run_twin("python", name) == ref


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
