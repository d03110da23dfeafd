"""The port's HttpKubeClient and HTTP mock apiserver against kwok_tpu's.

One script of client calls (creates, a plain list, a paginated list page
by page, a field-selected list, a watch across status and metadata
patches and graceful and immediate deletes, gets) runs three times: the
JAX client against the JAX ``HttpFakeApiserver`` (the reference), the
port's client against the same JAX server, and the port's client against
the port's ``HttpFakeApiserver``. Every result must be equal with
timestamps masked.
"""

from __future__ import annotations

import threading
import time
import urllib.parse

import pytest

from kwok_tpu.edge.httpclient import HttpKubeClient as JaxClient
from kwok_tpu.edge.mockserver import HttpFakeApiserver as JaxServer
from kwok_tpu_torch.edge.httpclient import HttpKubeClient as PortClient
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver as PortServer
from tests.test_torch_engine import make_node, make_pod, masked


def pages(client, url, kind, limit):
    """Items of a paginated LIST, page by page, with whether each page
    carried a continue token."""
    out, token = [], None
    while True:
        q = {"limit": limit}
        if token:
            q["continue"] = token
        doc = client._json("GET", f"{url}/api/v1/{kind}?" + urllib.parse.urlencode(q))
        token = (doc.get("metadata") or {}).get("continue")
        out.append(([i["metadata"]["name"] for i in doc["items"]], bool(token)))
        if not token:
            return out


def script(client, url):
    """Run the call script; returns every observable result."""
    res = {}
    for i in range(7):
        res[f"create-n{i}"] = client.create("nodes", make_node(f"n{i}", labels={"zone": f"z{i % 2}"}))
    for i in range(10):
        pod = make_pod(f"p{i}", node=f"n{i % 3}", finalizers=["kwok.dev/guard"] if i == 3 else None)
        if i == 9:
            pod["spec"]["nodeName"] = ""
        res[f"create-p{i}"] = client.create("pods", pod)
    res["list-nodes"] = client.list("nodes")
    res["list-zone"] = client.list("nodes", label_selector="zone=z1")
    res["pages-nodes"] = pages(client, url, "nodes", 3)
    res["pages-pods"] = pages(client, url, "pods", 5)
    res["list-bound"] = client.list("pods", field_selector="spec.nodeName!=")

    w = client.watch("pods", field_selector="spec.nodeName!=")
    events: list = []
    done = threading.Event()

    def consume():
        for ev in w:
            events.append([ev.type, ev.object])
            if len(events) >= 6:
                done.set()
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.2)  # the watch is registered server-side
    res["patch-status"] = client.patch_status(
        "pods", "default", "p0",
        {"status": {"phase": "Running", "podIP": "10.0.0.2",
                    "conditions": [{"type": "Ready", "status": "True"}]}})
    res["patch-meta"] = client.patch_meta("pods", "default", "p1", {"metadata": {"labels": {"a": "b"}}})
    client.delete("pods", "default", "p2", grace_seconds=0)
    client.delete("pods", "default", "p3", grace_seconds=30)  # finalizer: marked only
    res["p3-marked"] = client.get("pods", "default", "p3")
    client.patch_meta("pods", "default", "p3", {"metadata": {"finalizers": None}})
    client.delete("pods", "default", "p3", grace_seconds=0)
    client.delete("pods", "default", "p9", grace_seconds=0)  # not on a node: unwatched
    assert done.wait(10), events
    w.stop()
    t.join(5)
    res["watch"] = events
    res["get-p0"] = client.get("pods", "default", "p0")
    res["get-gone"] = client.get("pods", "default", "p2")
    res["patch-gone"] = client.patch_status("pods", "default", "p2", {"status": {"phase": "Failed"}})
    res["list-final"] = client.list("pods")
    res["healthz"] = client.healthz()
    return masked(res)


@pytest.fixture(scope="module")
def reference():
    srv = JaxServer().start()
    try:
        return script(JaxClient(srv.url), srv.url)
    finally:
        srv.stop()


@pytest.mark.parametrize("server", ["jax-server", "port-server"])
def test_port_client_matches_reference(reference, server):
    srv = (JaxServer() if server == "jax-server" else PortServer()).start()
    client = PortClient(srv.url)
    try:
        got = script(client, srv.url)
    finally:
        client.close()
        srv.stop()
    assert set(got) == set(reference)
    for key in reference:
        assert got[key] == reference[key], key


def test_port_server_version_and_unknown_paths():
    srv = PortServer().start()
    client = PortClient(srv.url)
    try:
        assert client._json("GET", srv.url + "/version")["major"] == "1"
        assert client._json("GET", srv.url + "/api/v1/services") is None  # 404
        with pytest.raises(Exception, match="continue"):
            client._json("GET", srv.url + "/api/v1/nodes?limit=1&continue=%21%21")
        client.create("nodes", make_node("dup"))
        with pytest.raises(Exception, match="already exists"):
            client.create("nodes", make_node("dup"))
    finally:
        client.close()
        srv.stop()


def test_port_mockserver_main_prints_url():
    """``python3 -m kwok_tpu_torch.edge.mockserver --port 0`` prints the
    reference's line, serves, and exits on SIGTERM."""
    import os
    import subprocess
    import sys

    p = subprocess.Popen(
        [sys.executable, "-m", "kwok_tpu_torch.edge.mockserver", "--port", "0"],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    try:
        line = p.stdout.readline()
        assert line.startswith("mock apiserver listening on http://127.0.0.1:")
        assert PortClient(line.split()[-1]).healthz()
    finally:
        p.terminate()
        assert p.wait(10) == 0
