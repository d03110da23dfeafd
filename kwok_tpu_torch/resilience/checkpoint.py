"""Crash-durable checkpoints: the per-row scalars a restart cannot relist
(the port of ``kwok_tpu.resilience.checkpoint``; same file format).

The engine holds volatile state the apiserver does NOT carry: the
device-resident ``fire_at`` stage deadline of every armed row (how much of
a Stage delay has already elapsed), the heartbeat wheel's per-row phase
(``hb_due``), and the per-row transition generation (``gen``). A restart
without this module resets every in-flight delay to zero.

Three pieces:

- :class:`Checkpointer`: a periodic, atomic-rename JSON checkpoint of the
  irreplaceable scalars. The GATHER (device tensors -> host, pool/meta
  walk) always happens on the thread that owns device state — the tick
  thread or the lane coordinator — at the configured cadence;
  serialization and file I/O happen on this module's writer thread so the
  tick thread never blocks on disk. Writes go to ``<name>.ckpt.json.tmp``
  then ``os.replace`` — a crash mid-write can never leave a torn file.
- :func:`gather_rows` / :func:`load`: the snapshot row format. Each
  active, device-flushed row records ``(uid, rv, fire-residue,
  hb-residue, gen, phase)``; residues are *remaining* seconds (deadline
  minus engine-now), so the restore semantics are freeze-during-downtime.
- :class:`RestoreSession`: the cold-start reconcile. The engine re-lists
  as it always did and lets Stage selectors place each row; the session
  then refines ``fire_at``/``hb_due``/``gen`` for rows whose ``(uid, rv)``
  still match their checkpoint entry, and drops stale rows PER ROW (an
  object that changed while the engine was down simply re-arms fresh).

Zero cost when disabled: no ``--checkpoint-dir`` means no Checkpointer
object, no writer thread, no gathers, and a single ``is None`` test on
the tick loop's service gate.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import random
import threading
import time

import numpy as np

logger = logging.getLogger("kwok_tpu_torch.resilience")

# disk retries of the writer (ENOSPC, read-only remounts): exponential
# backoff with full jitter, no deadline — a degraded-but-retrying writer
# beats silently losing crash durability
_RETRY_BASE_S = 0.2
_RETRY_CAP_S = 5.0

VERSION = 1

# Per-kind key <-> JSON string key. Pods join (namespace, name) with "/":
# a k8s namespace can never contain a slash (RFC 1123 label), so the join
# is unambiguous.
_POD_SEP = "/"


def key_str(kind: str, key) -> str:
    if kind == "pods":
        return f"{key[0]}{_POD_SEP}{key[1]}"
    return str(key)


def str_key(kind: str, ks: str):
    if kind == "pods":
        ns, _, name = ks.partition(_POD_SEP)
        return (ns, name)
    return ks


def checkpoint_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}.ckpt.json")


def row_uid(m: dict) -> str:
    """The row's object uid, extracted lazily and cached in the meta dict
    ("" when it has none: the restore then matches on rv alone).

    Dict-path rows carry a parsed object; native-record rows carry only
    the raw watch line, where a byte search finds the first ``"uid":"``
    without a JSON parse. An ownerReferences uid serialized before
    metadata.uid could shadow it; a wrong uid only makes the restore MORE
    conservative (the (uid, rv) match fails and the row re-arms fresh)."""
    uid = m.get("uid")
    if uid is None:
        obj = m.get("obj")
        if obj is not None:
            uid = (obj.get("metadata") or {}).get("uid") or ""
        else:
            raw = m.get("raw") or b""
            i = raw.find(b'"uid":"')
            if i >= 0:
                j = raw.find(b'"', i + 7)
                uid = raw[i + 7: j].decode("utf-8", "replace") if j > 0 else ""
            else:
                uid = ""
        m["uid"] = uid
    return uid


def _residue(deadline: float, now: float):
    """Remaining seconds until an engine-time deadline; None for the
    +inf sentinel (no timer armed — JSON has no Infinity)."""
    if not math.isfinite(deadline):
        return None
    return round(max(0.0, deadline - now), 6)


def gather_rows(
    kind: str,
    pool,
    phase: np.ndarray,
    fire: np.ndarray,
    hb: np.ndarray,
    gen: np.ndarray,
    staged,
    now: float,
    offset: int = 0,
) -> dict:
    """One kind's checkpoint rows: ``{key: [uid, rv, fire_res, hb_res,
    gen, phase]}`` over every pooled row whose device state is current.

    ``phase`` is the device's phase array, read with ``fire``, ``hb`` and
    ``gen`` (``ops/tick.gather_deadlines``), not the host mirror: the
    gather runs between a dispatch and its consume, when a row the
    dispatch fired has its new phase, no timer and a bumped ``gen`` on
    the device but still its old phase on the host. With the mirror's
    phase such a row would read "Pending, nothing armed"; if its patch
    never left (the engine died first), a restore would match it and
    overwrite its fresh arm with "no timer", leaving the pod Pending for
    good. With the device's phase the entry is stale and the row re-arms
    fresh.

    ``staged`` is the set of row indices with a staged-but-unflushed init
    (UpdateBuffer.staged_rows): their device slots still describe a
    previous occupant, so they are skipped — they'll be in the next
    checkpoint, one cadence later. Rows without a recorded ``rv`` carry
    no identity the restore could match and are skipped too. ``offset``
    shifts pool-local indices into a stacked state (a lane's slice).
    """
    ents: dict[str, list] = {}
    for key, idx in list(pool.items()):
        if idx in staged:
            continue
        m = pool.meta[idx]
        if not m:
            continue
        rv = int(m.get("rv") or 0)
        if not rv:
            continue
        di = idx + offset
        ents[key_str(kind, key)] = [
            row_uid(m),
            rv,
            _residue(float(fire[di]), now),
            _residue(float(hb[di]), now),
            int(gen[di]),
            int(phase[di]),
        ]
    return ents


def load(directory: str, name: str) -> "dict | None":
    """Read a checkpoint written by :class:`Checkpointer`. Returns the
    parsed document or None (absent file = cold start; a malformed file —
    impossible from the atomic writer, possible from a hand edit — is a
    logged warning, never a startup crash)."""
    path = checkpoint_path(directory, name)
    try:
        with open(path, "rb") as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        logger.warning("unreadable checkpoint %s; cold start", path,
                       exc_info=True)
        return None
    if not isinstance(doc, dict) or doc.get("v") != VERSION:
        logger.warning(
            "checkpoint %s has unknown version %r; cold start",
            path, doc.get("v") if isinstance(doc, dict) else None,
        )
        return None
    kinds = doc.get("kinds")
    if not isinstance(kinds, dict):
        logger.warning("checkpoint %s missing kinds; cold start", path)
        return None
    return doc


class Checkpointer:
    """Cadenced checkpoint writer for one engine.

    The device-owning loop polls :meth:`due` once per iteration (one
    monotonic compare), gathers a snapshot when due, and :meth:`submit`\\ s
    it; this class serializes + atomically renames on its own writer
    thread. The FINAL checkpoint at shutdown (:meth:`final`) rides the
    same queue so it can never be overwritten by an older periodic
    snapshot still in flight."""

    def __init__(
        self,
        directory: str,
        name: str,
        interval: float,
        on_write=None,
        degradation=None,
    ) -> None:
        self.directory = directory
        self.name = name
        self.interval = max(0.05, float(interval))
        self.path = checkpoint_path(directory, name)
        self._tmp = self.path + ".tmp"
        # called after each good write with (seconds, bytes, armed rows,
        # idle rows): the engine's checkpoint gauges
        self._on_write = on_write
        # the engine's Degradation ledger: a writer that cannot reach
        # disk (ENOSPC, read-only remount) flips kwok_degraded{reason=
        # "checkpoint"} while it retries, cleared on the next good write
        self._degradation = degradation
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: "threading.Thread | None" = None
        self._next = time.monotonic() + self.interval
        self.writes = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        from kwok_tpu_torch.workers import spawn_worker

        os.makedirs(self.directory, exist_ok=True)
        self._thread = spawn_worker(
            self._write_loop, name=f"kwok-ckpt-{self.name}"
        )

    def stop(self) -> None:
        """Drain the queue (any final snapshot included) and join."""
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -------------------------------------------------------------- cadence

    def due(self) -> bool:
        return time.monotonic() >= self._next

    def seconds_to_due(self) -> float:
        return max(0.0, self._next - time.monotonic())

    def submit(self, snapshot: dict) -> None:
        """Queue one gathered snapshot for writing; resets the cadence."""
        self._next = time.monotonic() + self.interval
        self._q.put(snapshot)

    def final(self, snapshot: dict) -> None:
        """Queue the shutdown checkpoint (ordered behind any periodic
        snapshot already queued, so the last write is always the newest
        gather). Falls back to a synchronous write when the writer thread
        is gone (a crash-during-shutdown path)."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(snapshot)
        else:
            self._write(snapshot)

    # --------------------------------------------------------------- writer

    def _write_loop(self) -> None:
        attempt = None  # failed writes in a row; None = healthy
        snap = None
        while True:
            if snap is None:
                snap = self._q.get()
            if snap is None:
                return
            try:
                self._write(snap)
            except OSError:
                # disk trouble (ENOSPC, EIO, read-only remount): the tmp
                # write failed BEFORE os.replace, so the last good
                # checkpoint on disk is intact by construction. Degrade
                # (kwok_degraded{reason="checkpoint"}; /readyz 503 —
                # this engine's crash durability is gone until the disk
                # heals) and retry under the shared policy — always with
                # the NEWEST snapshot available, because writing a stale
                # one after a fresher gather queued would move the
                # restore target BACKWARD.
                logger.exception("checkpoint write failed (%s)", self.path)
                if self._degradation is not None and self._degradation.set(
                    "checkpoint"
                ):
                    logger.error(
                        "engine degraded: checkpoint writer cannot reach "
                        "disk (%s); retrying under policy", self.path,
                    )
                attempt = 0 if attempt is None else attempt + 1
                ceiling = min(_RETRY_CAP_S, _RETRY_BASE_S * 2.0 ** attempt)
                snap = self._retry_wait(snap, random.uniform(0, ceiling) or 1.0)
                if snap is None:
                    return  # stop sentinel drained mid-retry
                continue
            except Exception:
                # a serialization bug is not a disk outage: one failed
                # write must not end checkpointing; the next cadence
                # retries with fresher data
                logger.exception("checkpoint write failed (%s)", self.path)
                snap = None
                continue
            if attempt is not None:
                attempt = None
                if self._degradation is not None and self._degradation.clear(
                    "checkpoint"
                ):
                    logger.info(
                        "checkpoint writer recovered (%s)", self.path
                    )
            snap = None

    def _retry_wait(self, snap: dict, delay: float) -> "dict | None":
        """Sleep out one write-retry backoff window on the writer thread,
        absorbing anything newer that queues meanwhile: the freshest
        snapshot supersedes the failed one. Returns the snapshot to retry
        (never older than ``snap``) or None when the stop sentinel
        arrived — after one last best-effort write of the freshest
        gather, so a shutdown during a disk outage still tries to leave
        the newest state behind."""
        deadline = time.monotonic() + delay
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return snap
            try:
                nxt = self._q.get(timeout=min(remaining, 0.2))
            except queue.Empty:
                continue
            if nxt is None:
                try:
                    self._write(snap)
                except OSError:
                    logger.error(
                        "final checkpoint write failed during disk "
                        "outage; last good checkpoint (%s) left intact",
                        self.path,
                    )
                return None
            snap = nxt

    def _write(self, snapshot: dict) -> None:
        t0 = time.perf_counter()
        doc = {
            "v": VERSION,
            "name": self.name,
            "wall": time.time(),
            "kinds": snapshot.get("kinds") or {},
        }
        blob = json.dumps(doc, separators=(",", ":")).encode()
        with open(self._tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(self._tmp, self.path)
        self.writes += 1
        dt = time.perf_counter() - t0
        if self._on_write is not None:
            armed = idle = 0
            for ents in doc["kinds"].values():
                for e in ents.values():
                    if e[2] is not None:
                        armed += 1
                    else:
                        idle += 1
            self._on_write(dt, len(blob), armed, idle)


class RestoreSession:
    """Match checkpoint entries against freshly re-listed rows and hand
    back refine batches; consumed per row, dropped per row.

    Single consumer by contract: only the device-owning loop calls
    :meth:`match_kind`. ``gate_ready`` sessions belong to the startup
    reconcile (the engine's /readyz gate finishes them); once the gate
    lets go of one, the engine sets ``deadline`` and the session ends
    when that passes. A refill armed after a worker restart has no gate
    and ends ``ttl`` seconds after it was made."""

    def __init__(self, kinds: dict, gate_ready: bool, ttl: float = 0.0):
        # parse into {kind: {key_str: entry-list}} defensively: a stale
        # or hand-edited file must degrade to "nothing matches"
        self.kinds: dict[str, dict] = {}
        for kind in ("nodes", "pods"):
            ents = kinds.get(kind)
            self.kinds[kind] = dict(ents) if isinstance(ents, dict) else {}
        self.gate_ready = gate_ready
        # monotonic; 0 = no deadline
        self.deadline = (time.monotonic() + ttl) if ttl > 0 else 0.0
        self.matched = 0
        self.stale = 0

    @property
    def remaining(self) -> int:
        return sum(len(v) for v in self.kinds.values())

    def expired(self) -> bool:
        return bool(self.deadline) and time.monotonic() > self.deadline

    def match_kind(
        self, kind: str, pool, staged, now: float, phase_h=None,
        fire=None, offset: int = 0,
    ):
        """Pop every entry whose row is present, device-flushed, ARMED,
        and still the same object ``(uid, rv, phase)``; return its
        refine arrays (idx, fire_at, hb_due, gen) in ENGINE time.
        Entries whose row exists but whose identity moved on are dropped
        as stale; entries whose key is absent — or whose row the kernel
        has not armed yet — stay (the re-list / a managed-ness XUPD may
        not have reached them; :meth:`finish` drops the leftovers).

        ``fire`` is the CURRENT device fire_at array (host copy): an
        entry carrying a delay residue is only consumed once the row's
        own deadline is finite, i.e. the kernel has matched and armed
        its rule. Refining before that point would be undone by the very
        re-arm that follows (pods whose managed bit arrives through a
        later cross-lane XUPD are armed one dispatch late)."""
        ents = self.kinds.get(kind)
        if not ents:
            return (np.empty(0, np.int32),) * 4
        idx_l: list[int] = []
        fire_l: list[float] = []
        hb_l: list[float] = []
        gen_l: list[int] = []
        inf = float("inf")
        for ks, ent in list(ents.items()):
            try:
                uid, rv, fire_res, hb_res, gen, phase = ent
            except (TypeError, ValueError):
                ents.pop(ks)
                self.stale += 1
                continue
            idx = pool.lookup(str_key(kind, ks))
            if idx is None:
                continue  # not re-listed yet; the final pass drops it
            if idx in staged:
                continue  # staged init not flushed/armed yet; next pass
            m = pool.meta[idx] or {}
            if int(m.get("rv") or 0) != int(rv):
                ents.pop(ks)
                self.stale += 1
                continue
            cur_uid = row_uid(m)
            if uid and cur_uid and uid != cur_uid:
                ents.pop(ks)
                self.stale += 1
                continue
            if phase_h is not None and int(phase_h[idx]) != int(phase):
                # same rv but a different lifecycle phase can only mean
                # the row transitioned since the checkpoint (the echo
                # has not landed yet): resuming the OLD delay would
                # re-fire it — drop, let the fresh arm win
                ents.pop(ks)
                self.stale += 1
                continue
            if fire_res is not None and fire is not None and not (
                math.isfinite(float(fire[idx + offset]))
            ):
                continue  # not armed yet (e.g. XUPD pending); next pass
            ents.pop(ks)
            self.matched += 1
            idx_l.append(idx)
            fire_l.append(now + fire_res if fire_res is not None else inf)
            hb_l.append(now + hb_res if hb_res is not None else inf)
            gen_l.append(int(gen))
        if not idx_l:
            return (np.empty(0, np.int32),) * 4
        return (
            np.fromiter(idx_l, np.int32, len(idx_l)),
            np.fromiter(fire_l, np.float32, len(fire_l)),
            np.fromiter(hb_l, np.float32, len(hb_l)),
            np.fromiter(gen_l, np.int32, len(gen_l)),
        )

    def finish(self) -> dict:
        """Close the session: leftovers are objects the re-list did not
        return (deleted while down) — stale by definition, dropped per
        row. Returns the summary for the recovery log line."""
        leftover = self.remaining
        self.stale += leftover
        for ents in self.kinds.values():
            ents.clear()
        return {
            "refined": self.matched,
            "stale": self.stale,
            "unlisted": leftover,
        }
