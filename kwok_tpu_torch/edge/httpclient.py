"""HttpKubeClient: the KubeClient protocol over a real kube-apiserver.

Replaces the reference's client-go usage: paged LIST (pager.New,
node_controller.go:282), streaming WATCH with resourceVersion resume,
strategic-merge PATCH of /status (PatchStatus, node_controller.go:345),
JSON merge-patch of metadata (removeFinalizers, pod_controller.go:45), and
grace-0 DELETE. Auth comes from a kubeconfig file or in-cluster
serviceaccount files (pkg/kwok/cmd/root.go:222-236 newClientset). A
kubeconfig that is JSON is read without PyYAML; a YAML one needs it.
"""

from __future__ import annotations

import atexit
import base64
import http.client
import io
import json
import logging
import os
import re
import socket
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator

from kwok_tpu_torch.config.types import parse_documents
from kwok_tpu_torch.edge.kubeclient import (
    ContinueExpired,
    TooLargeResourceVersion,
    TooManyRequests,
    WatchEvent,
)
from kwok_tpu_torch.telemetry.errors import swallowed, wire_reject
from kwok_tpu_torch.locks import reclaimable

logger = logging.getLogger("kwok_tpu_torch.edge.http")

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
LIST_PAGE_SIZE = 500


def _b64_to_tmp(data: str, suffix: str) -> str:
    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    f.write(base64.b64decode(data))
    f.close()
    # key material must not outlive the process
    atexit.register(_unlink_quiet, f.name)
    return f.name


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class ListPage(list):
    """One page of a paged LIST; ``rv`` is its metadata.resourceVersion:
    the revision of the snapshot it shows (every page of one paged LIST
    shows its first page's), 0 when the server sent none."""

    rv = 0


class HttpKubeClient:
    def __init__(
        self,
        server: str,
        *,
        token: str | None = None,
        ca_file: str | None = None,
        cert_file: str | None = None,
        key_file: str | None = None,
        insecure_skip_tls_verify: bool = False,
        timeout: float = 30.0,
    ) -> None:
        self.server = server.rstrip("/")
        self.token = token
        self.timeout = timeout
        # extra headers on every unary request: the HA plane plants its
        # fencing claim here (resilience/ha.py FENCE_HEADER), so the
        # servers reject a deposed holder's writes at processing time
        self.extra_headers: dict[str, str] = {}
        # what a lane process (engine/proclanes.py) needs to open the same
        # client: plain values, carried in its spawn arguments
        self.connection_args = {
            "server": server, "token": token, "ca_file": ca_file,
            "cert_file": cert_file, "key_file": key_file,
            "insecure_skip_tls_verify": insecure_skip_tls_verify,
            "timeout": timeout,
        }
        # per-thread persistent connections for unary requests (keep-alive):
        # a new TCP (+TLS) handshake per status patch would dominate the
        # egress at high transition rates (SURVEY.md "Hard parts":
        # connection pooling on the watch/patch edge)
        self._local = threading.local()
        split = urllib.parse.urlsplit(self.server)
        self._host = split.hostname or "127.0.0.1"
        self._port = split.port
        # server URLs may carry a base path (proxy-style clusters); unary
        # requests must keep it when extracting the path from a full URL
        self._base_path = split.path.rstrip("/")
        self._conns: set = set()
        self._conns_lock = reclaimable()
        ctx: ssl.SSLContext | None = None
        if self.server.startswith("https"):
            ctx = ssl.create_default_context(cafile=ca_file)
            if insecure_skip_tls_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if cert_file and key_file:
                ctx.load_cert_chain(cert_file, key_file)
        self._ctx = ctx

    # ---------------------------------------------------------- construction

    @classmethod
    def from_kubeconfig(
        cls, path: str | None = None, master: str | None = None
    ) -> "HttpKubeClient":
        """Load the current-context cluster+user from a kubeconfig; fall back
        to in-cluster serviceaccount; `master` overrides the server URL."""
        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser(
            "~/.kube/config"
        )
        if os.path.exists(path):
            with open(path) as f:
                docs = parse_documents(f.read(), path)
            cfg = (docs[0] if docs else None) or {}
            ctx_name = cfg.get("current-context")
            contexts = {c["name"]: c["context"] for c in cfg.get("contexts") or []}
            clusters = {c["name"]: c["cluster"] for c in cfg.get("clusters") or []}
            users = {u["name"]: u["user"] for u in cfg.get("users") or []}
            ctx = contexts.get(ctx_name) or (next(iter(contexts.values()), {}))
            cluster = clusters.get(ctx.get("cluster"), {}) if ctx else {}
            user = users.get(ctx.get("user"), {}) if ctx else {}
            ca = cluster.get("certificate-authority")
            if not ca and cluster.get("certificate-authority-data"):
                ca = _b64_to_tmp(cluster["certificate-authority-data"], ".crt")
            cert = user.get("client-certificate")
            if not cert and user.get("client-certificate-data"):
                cert = _b64_to_tmp(user["client-certificate-data"], ".crt")
            key = user.get("client-key")
            if not key and user.get("client-key-data"):
                key = _b64_to_tmp(user["client-key-data"], ".key")
            return cls(
                master or cluster.get("server") or "http://127.0.0.1:8080",
                token=user.get("token"),
                ca_file=ca,
                cert_file=cert,
                key_file=key,
                insecure_skip_tls_verify=bool(
                    cluster.get("insecure-skip-tls-verify")
                ),
            )
        if master:
            return cls(master)
        # in-cluster (root.go: rest.InClusterConfig path)
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if host:
            token = ""
            token_file = os.path.join(_SA_DIR, "token")
            if os.path.exists(token_file):
                token = open(token_file).read().strip()
            return cls(
                f"https://{host}:{port}",
                token=token or None,
                ca_file=os.path.join(_SA_DIR, "ca.crt"),
            )
        raise RuntimeError("no kubeconfig, --master, or in-cluster environment")

    # -------------------------------------------------------------- plumbing

    _RBAC_KINDS = frozenset(
        {"roles", "rolebindings", "clusterroles", "clusterrolebindings"}
    )

    def _url(self, kind: str, namespace: str | None = None, name: str | None = None,
             subresource: str | None = None, query: dict | None = None) -> str:
        parts = [
            "/apis/rbac.authorization.k8s.io/v1"
            if kind in self._RBAC_KINDS
            else "/api/v1"
        ]
        if namespace:
            parts.append(f"/namespaces/{namespace}")
        parts.append(f"/{kind}")
        if name:
            parts.append(f"/{name}")
        if subresource:
            parts.append(f"/{subresource}")
        url = self.server + "".join(parts)
        if query:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in query.items() if v not in (None, "")}
            )
        return url

    def _request(self, method: str, url: str, body: bytes | None = None,
                 content_type: str | None = None, timeout: float | None = None):
        req = urllib.request.Request(url, data=body, method=method)
        if content_type:
            req.add_header("Content-Type", content_type)
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(
            req, context=self._ctx, timeout=timeout or self.timeout
        )

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            if self.server.startswith("https"):
                c = http.client.HTTPSConnection(
                    self._host, self._port, context=self._ctx,
                    timeout=self.timeout,
                )
            else:
                c = http.client.HTTPConnection(
                    self._host, self._port, timeout=self.timeout
                )
            c.connect()
            try:
                # Without this, request bodies Nagle-stall behind the
                # server's delayed ACK on every keep-alive round trip.
                c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except (OSError, AttributeError):
                pass
            self._local.conn = c
            with self._conns_lock:
                self._conns.add(c)
        return c

    def close(self) -> None:
        """Close every pooled keep-alive connection (all threads)."""
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for c in conns:
            try:
                c.close()
            except Exception:
                # best-effort teardown of a possibly-dead keep-alive
                swallowed("httpclient.pool_close")
        self._local = threading.local()

    def _json(self, method: str, url: str, body: dict | bytes | None = None,
              content_type: str = "application/json") -> dict | None:
        # bytes-like bodies are JSON the caller encoded already
        if isinstance(body, (bytes, bytearray, memoryview)):
            data = bytes(body)
        else:
            data = json.dumps(body).encode() if body is not None else None
        path = (self._base_path + url[len(self.server):]) or "/"
        headers = {"Accept": "application/json"}
        if data is not None and content_type:
            headers["Content-Type"] = content_type
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if self.extra_headers:
            headers.update(self.extra_headers)
        for attempt in (0, 1):
            conn = None
            try:
                conn = self._conn()
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
                break
            except (http.client.HTTPException, OSError):
                # stale keep-alive connection; rebuild once, then give up
                try:
                    conn.close()
                except Exception:
                    swallowed("httpclient.stale_conn_close")
                self._local.conn = None
                if attempt:
                    raise
        if status == 404:
            return None
        if status == 429:
            # a max-inflight band is saturated: typed so callers throttle
            # by the server's Retry-After hint (never a blind hot retry)
            try:
                ra = float(resp.getheader("Retry-After") or 1)
            except ValueError:
                ra = 1.0
            raise TooManyRequests(
                payload.decode(errors="replace"), retry_after=ra
            )
        if status >= 400:
            raise urllib.error.HTTPError(
                url, status, payload.decode(errors="replace"), None, None
            )
        try:
            return json.loads(payload or b"null")
        except ValueError:
            # a 2xx response whose body does not decode: garbled or
            # truncated on the wire. Counted, then raised — every caller
            # (watch loop, patch executor) already treats this as a
            # transient failure and re-fetches, which is the repair.
            wire_reject("http_body")
            raise

    # ------------------------------------------------------------- KubeClient

    def list(self, kind, *, field_selector=None, label_selector=None) -> list[dict]:
        items: list[dict] = []
        cont = None
        while True:
            try:
                doc = self._json(
                    "GET",
                    self._url(kind, query={
                        "fieldSelector": field_selector,
                        "labelSelector": label_selector,
                        "limit": LIST_PAGE_SIZE,
                        "continue": cont,
                    }),
                ) or {}
            except urllib.error.HTTPError as e:
                if e.code == 410 and cont:
                    # continue token compacted away mid-pagination:
                    # restart the list from scratch (client-go pager's
                    # fallback on Expired)
                    logger.warning(
                        "list %s continue token expired; restarting", kind
                    )
                    items.clear()
                    cont = None
                    continue
                raise
            for item in doc.get("items") or []:
                item.setdefault("apiVersion", "v1")
                items.append(item)
            cont = (doc.get("metadata") or {}).get("continue")
            if not cont:
                return items

    def list_page(self, kind, *, limit: int, cont: str = "",
                  field_selector=None, label_selector=None):
        """ONE page of a paged LIST: the anti-entropy auditor's budgeted
        read (``resilience/antientropy.py``), which bounds its pages per
        pass and resumes the continue cursor on its next pass. Returns
        ``(items, continue_token)``, the items a :class:`ListPage`
        carrying the page's revision; a 410 on a resumed cursor raises
        :class:`ContinueExpired`, so a caller restarts its scan and never
        mistakes the expiry for a completed one (a legitimately empty
        final page returns no token either). A 410 on a first page stays
        an HTTP error."""
        try:
            doc = self._json(
                "GET",
                self._url(kind, query={
                    "fieldSelector": field_selector,
                    "labelSelector": label_selector,
                    "limit": limit,
                    "continue": cont or None,
                }),
            ) or {}
        except urllib.error.HTTPError as e:
            if e.code == 410 and cont:
                logger.warning(
                    "audit list %s continue token expired; restarting scan",
                    kind,
                )
                raise ContinueExpired(kind) from e
            raise
        meta = doc.get("metadata") or {}
        items = ListPage()
        try:
            items.rv = int(meta.get("resourceVersion") or 0)
        except (TypeError, ValueError):
            pass
        for item in doc.get("items") or []:
            item.setdefault("apiVersion", "v1")
            items.append(item)
        return items, meta.get("continue") or ""

    def watch(self, kind, *, field_selector=None, label_selector=None,
              resource_version=None, allow_bookmarks=False):
        return _HttpWatch(
            self, kind, field_selector, label_selector, resource_version,
            allow_bookmarks,
        )

    def get(self, kind, namespace, name):
        return self._json("GET", self._url(kind, namespace, name))

    def create(self, kind, obj, namespace=None):
        """POST a new object (used by load rigs and tests; the engine itself
        never creates API objects)."""
        ns = namespace or (obj.get("metadata") or {}).get("namespace")
        return self._json("POST", self._url(kind, ns), obj)

    def patch_status(self, kind, namespace, name, patch):
        return self._json(
            "PATCH",
            self._url(kind, namespace, name, "status"),
            patch,
            "application/strategic-merge-patch+json",
        )

    def patch_meta(self, kind, namespace, name, patch):
        return self._json(
            "PATCH",
            self._url(kind, namespace, name),
            patch,
            "application/merge-patch+json",
        )

    def delete(self, kind, namespace, name, grace_seconds: int | None = 0):
        """grace_seconds=None omits DeleteOptions.gracePeriodSeconds so the
        server applies its default (pods: spec.terminationGracePeriodSeconds
        or 30, like the real apiserver)."""
        self._json(
            "DELETE",
            self._url(kind, namespace, name),
            None if grace_seconds is None else {"gracePeriodSeconds": grace_seconds},
        )

    # ------------------------------------------- coordination.k8s.io leases

    def _lease_url(self, namespace: str, name: str | None = None) -> str:
        url = (
            f"{self.server}/apis/coordination.k8s.io/v1/namespaces/"
            f"{namespace}/leases"
        )
        return url + (f"/{name}" if name else "")

    def _lease_call(self, method, url, body=None,
                    content_type="application/json"):
        """One lease call -> ``(status_code, parsed_doc | None)``. A
        denial (409 Conflict or AlreadyExists) is an answer the elector
        switches on every poll, not an exception; transport failures
        still raise."""
        try:
            doc = self._json(method, url, body, content_type)
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(str(e.reason) or "null")
            except ValueError:
                doc = None
            return e.code, doc
        if doc is None:
            return 404, None
        return (201 if method == "POST" else 200), doc

    def lease_get(self, namespace, name):
        """GET the Lease -> (code, doc); 404 means it does not exist."""
        return self._lease_call("GET", self._lease_url(namespace, name))

    def lease_create(self, namespace, name, spec):
        """POST a fresh Lease (the first acquisition; leaseTransitions
        starts at 0) -> (201, doc), or (409, Status) when it exists."""
        return self._lease_call(
            "POST", self._lease_url(namespace),
            {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": name, "namespace": namespace},
                "spec": dict(spec or {}),
            },
        )

    def lease_renew(self, namespace, name, spec):
        """PATCH to renew or acquire -> (200, doc), (409, Status) while
        another holder's lease has not expired, or (404, None)."""
        return self._lease_call(
            "PATCH", self._lease_url(namespace, name),
            {"spec": dict(spec or {})},
            "application/merge-patch+json",
        )

    def healthz(self) -> bool:
        try:
            with self._request("GET", self.server + "/healthz") as resp:
                return resp.status == 200
        except Exception:
            # probe contract: unreachable == unhealthy, but leave a trace
            logger.debug("healthz probe failed", exc_info=True)
            return False


class _HttpWatch:
    """One streaming watch connection; iterating yields WatchEvents until the
    server closes the stream or stop() is called. The engine's watch loop
    handles reconnect+resync."""

    def __init__(self, client: HttpKubeClient, kind: str, field_selector,
                 label_selector, resource_version=None,
                 allow_bookmarks=False):
        self.client = client
        self._stopped = threading.Event()
        #: the native reader's dup of the socket (native_reader), or None
        self._reader_sock = None
        #: set when the stream ended with an ERROR event carrying a 410
        #: Status — the resume revision was compacted; caller must re-list
        self.expired = False
        url = client._url(kind, query={
            "watch": "true",
            "fieldSelector": field_selector,
            "labelSelector": label_selector,
            "resourceVersion": (
                str(resource_version) if resource_version else None
            ),
            "allowWatchBookmarks": (
                "true" if allow_bookmarks else "false"
            ),
        })
        # no read timeout: watch connections idle legitimately
        try:
            self._resp = client._request("GET", url, timeout=3600.0)
        except urllib.error.HTTPError as e:
            if e.code == 429:
                # watch handshake rejected by a saturated max-inflight
                # band: typed, so the reconnect loop throttles by the
                # server's hint instead of hammering the handshake
                try:
                    ra = float(
                        (e.headers.get("Retry-After") if e.headers else None)
                        or 1
                    )
                except ValueError:
                    ra = 1.0
                body = e.read() if hasattr(e, "read") else b""
                raise TooManyRequests(
                    body.decode(errors="replace"), retry_after=ra
                ) from e
            # a resume AHEAD of the server's store fails the watch
            # handshake with 504 + a ResourceVersionTooLarge cause
            # (storage.NewTooLargeResourceVersionError); surface it typed
            # so the engine can retry-with-hint instead of re-listing
            if e.code == 504:
                body = e.read() if hasattr(e, "read") else b""
                try:
                    doc = json.loads(body or (e.reason or "{}"))
                except (json.JSONDecodeError, TypeError):
                    doc = {}
                details = doc.get("details") or {}
                causes = details.get("causes") or []
                if any(
                    c.get("reason") == "ResourceVersionTooLarge"
                    for c in causes
                ):
                    # the server's current revision rides in the message
                    # ("Too large resource version: X, current: Y")
                    m = re.search(
                        r"current: (\d+)", doc.get("message") or ""
                    )
                    raise TooLargeResourceVersion(
                        int(resource_version or 0),
                        int(m.group(1)) if m else 0,
                        float(details.get("retryAfterSeconds") or 1),
                    ) from e
                # sniffing consumed the body; re-raise a generic 504 with
                # the Status JSON re-attached so callers can still read
                # the API's documented error shape (HTTPError.read binds
                # the ORIGINAL fp — a fresh error is the only way back)
                raise urllib.error.HTTPError(
                    e.url, e.code, e.reason, e.headers, io.BytesIO(body)
                ) from e
            raise

    def __iter__(self) -> Iterator[WatchEvent]:
        try:
            for raw in self._resp:
                if self._stopped.is_set():
                    return
                line = raw.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:  # JSONDecodeError or bad UTF-8
                    # corrupt bytes on the watch stream: integrity doubt.
                    # Skipping would silently lose whatever event the line
                    # carried (its rv is unreadable, so nothing would ever
                    # re-deliver it); ending the stream makes the engine's
                    # reconnect resume from the last good revision — the
                    # server replays the gap, the echo-drop absorbs the
                    # duplicates, and the corrupt event comes back whole.
                    wire_reject("watch_line")
                    logger.warning(
                        "bad watch line (ending stream for resume): "
                        "%.120r", line,
                    )
                    return
                type_ = doc.get("type")
                if type_ in ("ADDED", "MODIFIED", "DELETED", "BOOKMARK"):
                    # BOOKMARK objects carry only metadata.resourceVersion;
                    # callers advance their resume revision and move on
                    yield WatchEvent(type_, doc.get("object") or {})
                elif type_ == "ERROR":
                    obj = doc.get("object") or {}
                    if obj.get("code") == 410:
                        self.expired = True
                    logger.warning("watch error event: %s", obj)
                    return
        finally:
            try:
                self._resp.close()
            except Exception:
                # a stopped stream may already be torn down (shutdown race)
                swallowed("httpclient.watch_close")

    def raw_lines(self) -> Iterator[bytes]:
        """Undecoded event lines: the engine parses them in batches with
        the native parser instead of json.loads per event."""
        try:
            for raw in self._resp:
                if self._stopped.is_set():
                    return
                line = raw.strip()
                if line:
                    yield line
        finally:
            try:
                self._resp.close()
            except Exception:
                swallowed("httpclient.watch_close")

    def native_reader(self):
        """Hand the stream to the native batched line reader
        (``kwok_tpu_torch.native.WatchReader``) after the Python HTTP
        handshake: plain-HTTP responses on a real socket only. Returns the
        reader, or None (TLS, ``KWOK_TPU_NATIVE_WATCH=0``, no native
        library): the caller then reads ``raw_lines()``. Bytes
        ``http.client`` already read ahead are drained from its buffer
        without blocking and handed over, so the reader starts exactly
        where the handshake left off. The reader reads a dup of the
        socket that it owns and closes itself, so no close of the
        response's socket (``stop()`` falls back to one when the
        shutdown fails) can free the fd number it reads while it reads.
        ``stop()`` still ends a native read: it shuts the connection down
        through both descriptors, and that is the reader's end of
        stream."""
        if os.environ.get("KWOK_TPU_NATIVE_WATCH", "1") == "0":
            return None
        from kwok_tpu_torch import native

        if not native.available():
            return None
        resp = self._resp
        try:
            fp = resp.fp
            sock = fp.raw._sock  # http.client internals (as in stop())
            if not isinstance(sock, socket.socket) or isinstance(sock, ssl.SSLSocket):
                return None  # TLS bytes are not readable off the raw fd
            chunked = bool(getattr(resp, "chunked", False))
            sock.setblocking(False)
            buffered = b""
            try:
                while True:
                    try:
                        part = fp.read1(1 << 20)
                    except (BlockingIOError, ssl.SSLWantReadError):
                        break
                    if not part:
                        break
                    buffered += part
            finally:
                sock.setblocking(True)
            own = sock.dup()
            self._reader_sock = own
            if self._stopped.is_set():
                # a stop() that ran before the dup existed reached only
                # the response's socket
                own.shutdown(socket.SHUT_RDWR)
            return native.WatchReader(own.fileno(), buffered, chunked, owner=own)
        except Exception:
            logger.debug("native watch reader unavailable", exc_info=True)
            return None

    def stop(self) -> None:
        self._stopped.set()
        # the native reader's own descriptor: its shutdown ends the read
        # even when the response's socket is already closed
        own = self._reader_sock
        if own is not None:
            try:
                own.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # the reader is done and closed it, or the peer went
        # Closing the response would block on the buffer lock held by a
        # reader mid-readline; shutting the socket down unblocks the reader
        # with EOF instead.
        try:
            sock = self._resp.fp.raw._sock  # http.client internals
            sock.shutdown(socket.SHUT_RDWR)
        except Exception:
            try:
                self._resp.close()
            except Exception:
                swallowed("httpclient.watch_stop")
