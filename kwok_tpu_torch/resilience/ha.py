"""Warm-standby high availability: lease-fenced failover (the port of
``kwok_tpu.resilience.ha``; the same lease dialect, fence and elector).

A checkpoint makes one engine durable across a SIGKILL; this module makes
a pair of engines available. They coordinate through a minimal
``coordination.k8s.io/v1`` Lease that both of the port's mock apiservers
serve (create, GET, PATCH to renew or acquire; the server's clock judges
expiry): client-go's leader election with the optimistic Update replaced
by a PATCH the server arbitrates.

- The **primary** renews the lease every ``renew_interval`` and holds a
  local *fence*: a monotonic deadline stamped before each renew was sent,
  plus the lease duration. The server stamps ``renewTime`` when it takes
  the PATCH, at or after the send stamp, so the fence lapses at or before
  the earliest moment the server could hand the lease to another. Every
  outward write waits on the fence: the patch executor's through
  :class:`FencedClient`, the native pump's through :class:`FencedPump`,
  and on the server too: both writers carry the :data:`FENCE_HEADER`
  claim, which the apiservers check under the lock a takeover PATCH
  takes, so a paused and revived zombie's in-flight bytes die there even
  when they passed the local check before the pause.
- The **standby** runs its engine observe-only: it watches both kinds and
  ingests, its tick loop flushes staged rows into the device state, but
  ``tick.cu`` never runs: nothing arms, nothing fires, nothing is written
  (``engine._ha_hold``). It tails the primary's ``<identity>.ckpt.json``
  (written by atomic rename, so safe to read at any time) and keeps
  PATCHing the lease with its own identity: 409 while the primary lives,
  the lease the moment it expires. Takeover: a
  :class:`~kwok_tpu_torch.resilience.checkpoint.RestoreSession` from the
  dead primary's freshest checkpoint, the gate opened, ``/readyz`` 200.
  The re-list is already done, so a failover beats a cold restart.
- A **deposed leader** (its renew answered 409: the lease was taken while
  it was paused or cut off) closes its fence for good, holds again and
  stays degraded (``kwok_degraded{reason="ha_lost_lease"}``); rejoining
  the pair takes a restart of the process, never a split brain.

Off by default: ``from_config`` returns None for an empty role, and then
no elector thread runs, nothing is wrapped and no fence is checked (one
``_ha_hold`` attribute test per dispatch remains). The plane records no
spans, as ``kwok_tpu``'s records none.

Lock: ``_ha_lock`` guards the role state machine and the tailed peer
checkpoint. It is a leaf: nothing is acquired under it. It is reclaimable
(``kwok_tpu_torch/locks.py``): the elector is a supervised worker, and a
fault-plane pill that lands inside it must not leave the lock held for
the executor threads that count fenced writes.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time

import numpy as np

from kwok_tpu_torch.locks import reclaimable
from kwok_tpu_torch.resilience import checkpoint as ckpt_mod
from kwok_tpu_torch.telemetry.errors import swallowed

logger = logging.getLogger("kwok_tpu_torch.resilience")

#: mutating requests carry this header naming the lease the writer
#: believes it holds ("<namespace>/<name>/<holderIdentity>"); both mock
#: apiservers answer the write 409 when that lease is not held by that
#: identity now (edge/mockserver.FENCING_HEADER, native/apiserver.cc)
FENCE_HEADER = "X-Kwok-Lease-Holder"

_ROLES = ("leader", "standby", "lost")

_HELP_ROLE = (
    "Current HA role of this engine (1 on exactly one of "
    "role=leader|standby|lost; absent families mean HA is disabled)"
)
_HELP_TRANSITIONS = (
    "Lease acquisitions performed by THIS engine (its standby->leader "
    "edges; the lease object's own leaseTransitions counts cluster-wide "
    "handovers)"
)
_HELP_TAKEOVER = (
    "Seconds from the last moment the previous holder was observed "
    "alive (the final 409-denied acquire attempt) to this engine "
    "serving after takeover (gate open, /readyz 200); 0 for an "
    "uncontested first acquisition"
)
_HELP_FENCED = (
    "Outward writes dropped by the lease fence (patch-executor jobs and "
    "native pump requests attempted while not holding the lease: the "
    "observe-only standby's repair renders, a deposed or expired "
    "leader's in-flight emits)"
)


def default_identity() -> str:
    """client-go's identity: the hostname and the process id."""
    return f"{socket.gethostname()}-{os.getpid()}"


class _Fence:
    """The local fencing token: a monotonic deadline before which this
    process may take itself for the lease holder. A read or a write is
    one float attribute operation, so the check on the emit path is one
    clock read and one compare."""

    def __init__(self) -> None:
        self._deadline = 0.0

    def open_until(self, deadline: float) -> None:
        self._deadline = deadline

    def close(self) -> None:
        self._deadline = 0.0

    def holding(self) -> bool:
        return time.monotonic() < self._deadline


class FencedClient:
    """A KubeClient whose outward write verbs wait on the fence.

    A fenced write is dropped (counted, logged once) and answers as a
    write to a deleted object does: None from the patch verbs, nothing
    from delete, which the executor takes as settled, so a fenced engine
    spends no retries on writes that must not land. Reads, watches and
    the lease calls pass through."""

    def __init__(self, plane: "HAPlane", inner):
        self.plane = plane
        self.inner = inner

    def patch_status(self, kind, namespace, name, patch):
        if self.plane.fence.holding():
            return self.inner.patch_status(kind, namespace, name, patch)
        self.plane.note_fenced()
        return None

    def patch_meta(self, kind, namespace, name, patch):
        if self.plane.fence.holding():
            return self.inner.patch_meta(kind, namespace, name, patch)
        self.plane.note_fenced()
        return None

    def delete(self, kind, namespace, name, **kw):
        if self.plane.fence.holding():
            return self.inner.delete(kind, namespace, name, **kw)
        self.plane.note_fenced()
        return None

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FencedPump:
    """A native pump whose batches wait on the fence: a batch sent while
    the lease is not held answers 404 for every request, which the
    engine's ack loop takes as "deleted on the server, nothing to do" (no
    per-object fallback, no resend, no pump degradation): a dropped
    write."""

    def __init__(self, plane: "HAPlane", inner):
        self.plane = plane
        self.inner = inner

    def send(self, requests):
        if self.plane.fence.holding():
            return self.inner.send(requests)
        n = len(requests)
        self.plane.note_fenced(n)
        return np.full(n, 404, dtype=np.int32)

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)


class HAPlane:
    """One engine's leadership plane: the elector, the fence and the
    peer checkpoint's tail. ``ClusterEngine.__init__`` builds it
    (:func:`from_config`), ``start()`` binds it and runs :meth:`run` as
    the watchdog-supervised ``kwok-ha`` worker."""

    def __init__(
        self,
        role: str,
        identity: str = "",
        lease_name: str = "kwok-tpu-engine",
        lease_namespace: str = "kube-system",
        duration: float = 2.0,
        renew_interval: float = 0.0,
    ) -> None:
        if role not in ("primary", "standby"):
            raise ValueError(f"ha_role must be primary|standby, got {role!r}")
        self.role = role
        self.identity = identity or default_identity()
        self.lease_name = lease_name
        self.lease_namespace = lease_namespace
        # the wire carries whole seconds (leaseDurationSeconds), and the
        # local fence must never outlive the server's grant: the working
        # duration is the integer the wire carries
        self.duration = float(max(1, round(float(duration))))
        self.renew_interval = (
            float(renew_interval) if renew_interval and renew_interval > 0
            else self.duration / 3.0
        )
        # the standby's acquire poll bounds how late it sees an expiry
        self.acquire_interval = max(
            0.05, min(self.renew_interval, self.duration / 20.0)
        )
        self.fence = _Fence()
        self._ha_lock = reclaimable()
        self.leading = False
        self.lost = False
        self.engine = None
        self._stop = False
        self._next_renew = 0.0
        self._last_denied = 0.0   # monotonic of the last 409-denied grab
        self._lease_seen = False  # a GET has seen the lease exist
        self._lease_get_at = 0.0  # monotonic of the last GET
        self._peer_holder = ""
        self._peer_doc = None     # the freshest parse of the peer's checkpoint
        self._peer_read_at = 0.0
        self.fenced_writes = 0
        self._fenced_logged = False
        self._role_fam = None
        self._transitions_c = None
        self._takeover_g = None
        self._fenced_c = None

    # ------------------------------------------------------------- wrapping

    def wrap_client(self, client):
        return FencedClient(self, client)

    def wrap_pump(self, pump):
        return FencedPump(self, pump)

    def fence_header_line(self) -> str:
        """The fencing claim as a raw HTTP header line (the native
        pump's ``header_extra``)."""
        return f"{FENCE_HEADER}: {self.fence_header_value()}\r\n"

    def fence_header_value(self) -> str:
        return f"{self.lease_namespace}/{self.lease_name}/{self.identity}"

    def note_fenced(self, n: int = 1) -> None:
        # executor threads and the lanes' pump workers meet the fence at
        # once: the tally moves under _ha_lock, the counter after it
        with self._ha_lock:
            self.fenced_writes += n
            first = not self._fenced_logged
            self._fenced_logged = True
        c = self._fenced_c
        if c is not None:
            c.inc(n)
        if first:
            logger.warning(
                "HA fence dropped an outward write (not holding lease "
                "%s/%s as %s); further drops are counted silently "
                "(kwok_ha_fenced_writes_total)",
                self.lease_namespace, self.lease_name, self.identity,
            )

    # ---------------------------------------------------------------- wiring

    def bind(self, engine) -> None:
        """Attach to the engine: register the kwok_ha_* families, hold
        the serve gate (reason ``ha_standby`` keeps /readyz 503 until
        this engine leads) and put the fencing claim in the HTTP client's
        extra headers, so every unary write is fenced on the server
        too."""
        self.engine = engine
        reg = engine.telemetry.registry
        self._role_fam = reg.gauge("kwok_ha_role", _HELP_ROLE, ("role",))
        self._transitions_c = reg.counter(
            "kwok_lease_transitions_total", _HELP_TRANSITIONS
        ).labels()
        self._takeover_g = reg.gauge(
            "kwok_ha_takeover_seconds", _HELP_TAKEOVER
        ).labels()
        self._fenced_c = reg.counter(
            "kwok_ha_fenced_writes_total", _HELP_FENCED
        ).labels()
        self._set_role_gauge("standby")
        engine._degradation.set("ha_standby")
        inner = engine.client
        for _ in range(8):
            if inner is None or hasattr(inner, "extra_headers"):
                break
            inner = getattr(inner, "inner", None)
        if inner is not None and hasattr(inner, "extra_headers"):
            inner.extra_headers[FENCE_HEADER] = self.fence_header_value()

    def _set_role_gauge(self, role: str) -> None:
        fam = self._role_fam
        if fam is None:
            return
        for r in _ROLES:
            fam.labels(role=r).set(1 if r == role else 0)

    def stop(self) -> None:
        self._stop = True

    # ------------------------------------------------------------ lease wire

    def _spec(self) -> dict:
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.duration),
        }

    def _lease(self, verb: str):
        """One lease call -> (status code, parsed doc or None); transport
        failures raise. Takes the HTTP client's dict answers and the
        in-process FakeKube's bytes alike."""
        c = self.engine.client
        ns, name = self.lease_namespace, self.lease_name
        if verb == "GET":
            code, doc = c.lease_get(ns, name)
        elif verb == "POST":
            code, doc = c.lease_create(ns, name, self._spec())
        else:
            code, doc = c.lease_renew(ns, name, self._spec())
        if isinstance(doc, (bytes, bytearray, memoryview)):
            try:
                doc = json.loads(bytes(doc) or b"null")
            except ValueError:
                doc = None
        return code, doc

    # --------------------------------------------------------------- elector

    def run(self) -> None:
        """The elector loop (worker ``kwok-ha``, supervised: a crash
        restarts it in place, and the fence deadline lives on this
        object, so a crash can only make it more careful).

        It ends on ``self._stop`` alone, not on the engine's
        ``_running``: a leader that stops gracefully keeps renewing while
        its engine drains the writes in flight, or the fence would lapse
        mid-drain (the lease is far shorter than the drain's deadline)
        and those writes would be dropped for good. ``ClusterEngine.stop``
        stops the plane after the drain; the lease then expires and a
        standby takes over."""
        while not self._stop:
            if self.lost:
                # deposed: fenced for good; rejoining takes a restart
                time.sleep(0.2)
                continue
            try:
                if self.leading:
                    self._renew_cycle()
                else:
                    self._attempt_cycle()
            except Exception:
                # the lease cannot be reached: the fence lapses at its
                # deadline by itself (writes stop, the safe direction); a
                # renew that lands before anyone took the lease opens it
                logger.warning(
                    "lease %s transport failure; retrying",
                    "renew" if self.leading else "acquire", exc_info=True,
                )
                self._sleep(0.1)

    def _sleep(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while not self._stop:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    def _renew_cycle(self) -> None:
        while not self._stop and time.monotonic() < self._next_renew:
            time.sleep(
                min(0.05, max(0.0, self._next_renew - time.monotonic()))
            )
        if self._stop:
            return
        t0 = time.monotonic()
        code, _doc = self._lease("PATCH")
        if code == 200:
            # anchored at the send stamp: the server's renewTime is at or
            # after it, so the fence lapses before the server's grant
            self.fence.open_until(t0 + self.duration)
            self._next_renew = t0 + self.renew_interval
            return
        if code == 409:
            self._lose("lease stolen while renewing")
            return
        if code == 404:
            # the dialect has no delete: a fresh store (an apiserver that
            # restarted empty); create it again
            code2, _doc2 = self._lease("POST")
            if code2 == 201:
                self.fence.open_until(t0 + self.duration)
                self._next_renew = t0 + self.renew_interval
                return
            self._lose(f"lease vanished and re-create answered {code2}")
            return
        logger.warning("lease renew answered %s; retrying", code)
        self._sleep(0.1)

    def _attempt_cycle(self) -> None:
        # the GET names the holder and feeds the checkpoint tail, which
        # want only the renew cadence; while the lease has never been
        # seen it stays on the fast poll, since it decides whether a
        # primary may create the lease
        if (
            not self._lease_seen
            or time.monotonic() - self._lease_get_at >= self.renew_interval
        ):
            code, doc = self._lease("GET")
            self._lease_get_at = time.monotonic()
            if code == 404:
                self._lease_seen = False
                if self.role == "primary":
                    # the first acquisition: the create is the claim
                    t0 = time.monotonic()
                    code2, _doc2 = self._lease("POST")
                    if code2 == 201:
                        self._become_leader(t0, prev_holder="")
                        return
                # a standby never elects itself onto a lease that never
                # existed: it only takes over from a primary once alive
                self._sleep(self.acquire_interval)
                return
            self._lease_seen = True
            holder = ""
            if isinstance(doc, dict):
                holder = (doc.get("spec") or {}).get("holderIdentity") or ""
            if holder and holder != self.identity:
                self._tail_peer(holder)
        t0 = time.monotonic()
        code2, _doc2 = self._lease("PATCH")
        if code2 == 200:
            # the previous holder is the last the GET saw; one that
            # changed hands within a renew window leaves an older
            # checkpoint, whose (uid, rv, phase) match falls back to
            # fresh arms: careful, never wrong
            ph = self._peer_holder
            self._become_leader(
                t0, prev_holder=ph if ph != self.identity else ""
            )
            return
        if code2 == 409:
            self._last_denied = time.monotonic()
        elif code2 == 404:
            self._lease_seen = False  # the store was reset between polls
        self._sleep(self.acquire_interval)

    # ------------------------------------------------------------- takeover

    def _tail_peer(self, holder: str) -> None:
        """Keep the freshest parse of the holder's checkpoint, read at
        the renew cadence so a fast acquire poll does not read the disk
        at its own."""
        e = self.engine
        if not e._ckpt_dir:
            return
        now = time.monotonic()
        if (
            holder == self._peer_holder
            and now - self._peer_read_at < self.renew_interval
        ):
            return
        doc = ckpt_mod.load(e._ckpt_dir, holder)
        with self._ha_lock:
            self._peer_holder = holder
            self._peer_read_at = now
            if doc is not None:
                self._peer_doc = doc

    def _become_leader(self, t0: float, prev_holder: str) -> None:
        with self._ha_lock:
            self.leading = True
        self.fence.open_until(t0 + self.duration)
        self._next_renew = t0 + self.renew_interval
        if self._transitions_c is not None:
            self._transitions_c.inc()
        takeover = (
            time.monotonic() - self._last_denied if self._last_denied
            else 0.0
        )
        self._open_gate(prev_holder)
        if self._takeover_g is not None:
            self._takeover_g.set(takeover)
        self._set_role_gauge("leader")
        logger.warning(
            "HA: %s acquired lease %s/%s%s; serving (takeover %.3fs)",
            self.identity, self.lease_namespace, self.lease_name,
            f" from {prev_holder}" if prev_holder else "", takeover,
        )

    def _open_gate(self, prev_holder: str) -> None:
        """Standby to leader: arm the checkpoint reconcile from the dead
        primary's freshest checkpoint (rows whose (uid, rv, phase) still
        match resume their delays; the rest arm fresh from the warm
        re-list) and open the tick gate."""
        e = self.engine
        if prev_holder and e._ckpt is not None:
            doc = ckpt_mod.load(e._ckpt_dir, prev_holder)
            if doc is None:
                with self._ha_lock:
                    doc = (
                        self._peer_doc
                        if self._peer_holder == prev_holder else None
                    )
            if doc is not None:
                session = ckpt_mod.RestoreSession(
                    doc.get("kinds") or {}, gate_ready=False, ttl=30.0
                )
                with e._ckpt_lock:
                    e._restore = session
                logger.info(
                    "HA takeover: %d checkpointed rows from %s to "
                    "reconcile against warm state",
                    session.remaining, prev_holder,
                )
        e._ha_hold = False
        e._idle_wake = 0.0  # wake the tick loop now
        # a quiet cluster's tick loop may sleep on the old wake: the
        # sentinel ends its wait (the lane coordinator re-reads
        # _idle_wake every poll slice)
        e._q.put(None)
        e._degradation.clear("ha_standby")
        # the flight recorder on the role edge: Degradation.set saves it
        # only on a degradation, and a takeover is the other edge worth
        # the requests that led into it
        try:
            e._flight_dump_on_degrade("ha_takeover")
        except Exception:
            swallowed("ha.takeover_flight_dump")

    def _lose(self, reason: str) -> None:
        with self._ha_lock:
            self.leading = False
            self.lost = True
        self.fence.close()
        e = self.engine
        e._ha_hold = True  # observe-only again: nothing arms or fires
        self._set_role_gauge("lost")
        if e._degradation.set("ha_lost_lease"):
            logger.error(
                "HA: %s lost lease %s/%s (%s); engine fenced and parked "
                "— restart the process to rejoin the pair",
                self.identity, self.lease_namespace, self.lease_name,
                reason,
            )


def from_config(config) -> "HAPlane | None":
    """The HA plane of an EngineConfig, or None when HA is off
    (``ha_role`` empty or "off"). ``KWOK_HA_ROLE`` and the lease variables
    reach the CLI's flags, not this function."""
    role = (getattr(config, "ha_role", "") or "").strip()
    if not role or role == "off":
        return None
    return HAPlane(
        role,
        identity=(getattr(config, "ha_identity", "") or "").strip(),
        lease_name=getattr(config, "lease_name", "") or "kwok-tpu-engine",
        lease_namespace=(
            getattr(config, "lease_namespace", "") or "kube-system"
        ),
        duration=getattr(config, "lease_duration", 2.0) or 2.0,
        renew_interval=getattr(config, "lease_renew_interval", 0.0) or 0.0,
    )
