"""KubeClient protocol: the exact API surface the engine needs.

The reference consumes client-go's typed clientset; the contract it actually
exercises is list / watch / get / patch-status / merge-patch-metadata /
delete (SURVEY.md section 3). Implementations:

- kwok_tpu_torch.edge.mockserver.FakeKube — in-memory (the analogue of
  fake.NewSimpleClientset in node_controller_test.go:38)
- kwok_tpu_torch.edge.httpclient.HttpKubeClient — real apiserver over
  HTTP(S)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Protocol

# Watch event types (k8s wire values).
ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"
ERROR = "ERROR"


@dataclasses.dataclass(frozen=True)
class WatchEvent:
    type: str
    object: dict


class WatchExpired(Exception):
    """The requested resourceVersion has been compacted away (HTTP 410
    Gone / watch ERROR event with code 410, reason "Expired"). The caller
    must fall back to a full re-list + fresh watch — the client-go
    reflector's ListAndWatch recovery (node_controller.go:241-254 re-watch
    semantics ride on it)."""


class TooLargeResourceVersion(Exception):
    """The requested resourceVersion is AHEAD of the server's store (e.g.
    the server restarted and its revision clock reset). The real apiserver
    answers this with HTTP 504 reason "Timeout", message "Too large
    resource version: X, current: Y", a ResourceVersionTooLarge cause and
    retryAfterSeconds — NOT 410 Expired; client-go retries the same
    revision after the hint instead of re-listing. The engine bounds those
    retries and falls back to a re-list so a permanently-reset server
    can't wedge it."""

    def __init__(self, rv: int, current: int, retry_after: float = 1.0):
        super().__init__(
            f"Too large resource version: {rv}, current: {current}"
        )
        self.rv = int(rv)
        self.current = int(current)
        self.retry_after = float(retry_after)


class ContinueExpired(Exception):
    """A paged LIST's continue token was compacted away mid-scan (HTTP
    410 on the continuation page). Typed so callers can restart their
    scan cleanly — distinguishable from a legitimately-empty final page,
    which also carries no further token but IS a completed scan."""


class TooManyRequests(Exception):
    """HTTP 429: one of the apiserver's max-inflight bands is saturated
    (kube-apiserver --max-requests-inflight /
    --max-mutating-requests-inflight rejection; KEP-1040 semantics).
    Carries the server's Retry-After hint — callers THROTTLE through the
    shared RetryPolicy (sleep at least ``retry_after``) and retry; they
    never hammer, and other HTTP statuses stay non-retryable."""

    def __init__(self, message: str = "Too many requests",
                 retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = float(retry_after)


class WatchHandle(Protocol):
    def __iter__(self) -> Iterator[WatchEvent]: ...
    def stop(self) -> None: ...


class KubeClient(Protocol):
    """kind is the lowercase plural resource name: "nodes" | "pods"."""

    def list(
        self,
        kind: str,
        *,
        field_selector: str | None = None,
        label_selector: str | None = None,
    ) -> list[dict]: ...

    def watch(
        self,
        kind: str,
        *,
        field_selector: str | None = None,
        label_selector: str | None = None,
        resource_version: int | str | None = None,
        allow_bookmarks: bool = False,
    ) -> WatchHandle:
        """resource_version > 0 resumes the stream strictly after that
        revision (the server replays its watch cache); raises WatchExpired
        — or the stream yields an ERROR event with code 410 — when the
        revision has been compacted away. allow_bookmarks opts into
        periodic BOOKMARK events (objects carrying only
        metadata.resourceVersion) so a quiet stream's resume revision
        keeps advancing past compactions — client-go's reflector always
        opts in; so does the engine."""
        ...

    def get(self, kind: str, namespace: str | None, name: str) -> dict | None: ...

    def patch_status(
        self, kind: str, namespace: str | None, name: str, patch: dict
    ) -> dict | None:
        """Strategic-merge patch of the status subresource
        (PatchStatus / Patch ..., "status" in the reference)."""
        ...

    def patch_meta(
        self, kind: str, namespace: str | None, name: str, patch: dict
    ) -> dict | None:
        """JSON merge patch of the main resource (finalizer strip,
        pod_controller.go:45)."""
        ...

    def delete(
        self, kind: str, namespace: str | None, name: str, grace_seconds: int = 0
    ) -> None: ...


def obj_key(obj: dict) -> tuple[str, str]:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace") or "", meta.get("name") or "")


def match_field_selector(obj: dict, field_selector: str | None) -> bool:
    """Minimal fieldSelector support: the forms the engine uses
    (spec.nodeName!=VALUE / spec.nodeName=VALUE, comma-joined;
    pod_controller.go:47, :373)."""
    if not field_selector:
        return True
    for term in field_selector.split(","):
        term = term.strip()
        if not term:
            continue
        if "!=" in term:
            path, val = term.split("!=", 1)
            if _field(obj, path) == val:
                return False
        elif "=" in term:
            path, val = term.split("==" if "==" in term else "=", 1)
            if _field(obj, path.rstrip("=")) != val:
                return False
    return True


def _field(obj: dict, path: str) -> str:
    cur: Any = obj
    for part in path.strip().split("."):
        if not isinstance(cur, dict):
            return ""
        cur = cur.get(part)
    return "" if cur is None else str(cur)
