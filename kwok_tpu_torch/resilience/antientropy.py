"""Anti-entropy auditor: a continuous convergence oracle for engine rows.

The port's copy of ``kwok_tpu.resilience.antientropy``, changed only in
its imports and in one lock (below). The transport tiers harden against
*clean* faults: connections die, servers say 429, bytes are never wrong.
The hostile-wire tier (``faults.py`` ``wire.*``) and plain operational
entropy (a store restored behind the engine's back, an operator's stray
``kubectl edit``, a corrupted-but-parseable LIST body) can make engine
device state and apiserver truth *silently* diverge, and nothing on the
event path can notice: no event fires for a mutation the watch never
delivered.

A paced background pass re-reads a budgeted window of ground truth and
diffs it against local state:

- **window**: one page-budgeted LIST per kind per pass, through the SAME
  selectors the engine's watch streams use (``HttpKubeClient.list_page``
  when the client has it; the scan cursor survives across passes, so big
  clusters are audited in slices and the auditor can never self-inflict
  the apiserver's 429 admission storm);
- **diff**: each listed object vs its engine row by ``(uid, rv, phase)``,
  plus, once a scan cycle has covered the whole keyspace, engine rows
  the server no longer has;
- **classify**: ``missed-event`` (object with no row), ``ghost-row``
  (row whose object is gone or was deleted+recreated under a new uid),
  ``double-apply`` (the engine ingested revisions the server does not
  have: the old-world signature after a store rewind), ``stale-row``
  (same object, same uid, but the server's status/phase disagrees with
  the engine-owned truth);
- **suspicion**: a divergence only counts once it survives a settle
  re-check inside the same pass (fresh per-object GET + fresh row read),
  so in-flight transitions and not-yet-landed patches never count;
- **repair**: per row, by re-ingest through the engine's own queue: a
  fresh ``ADDED`` re-runs the upsert + repair-render tier (which
  re-patches the engine-owned status back onto the server), a synthetic
  ``DELETED`` releases a ghost row. Never wholesale. A divergence
  re-confirmed while its repair is still queued behind the drain (same
  server revision, nothing ingested for the row since) is in flight: it
  neither counts nor queues again (``kwok_tpu`` counts it, and a backlog
  of three cycles degrades the engine).

Exports ``kwok_drift_detected_total{kind=,reason=}``,
``kwok_drift_repaired_total`` and ``kwok_audit_pass_seconds`` on the
engine's registry, and degrades ``/readyz`` (``kwok_degraded{reason=
"drift"}``) only when the SAME divergence survives repair for several
consecutive passes: detection alone is the auditor doing its job.

Off by default (``--audit-interval`` / ``auditInterval`` /
``KWOK_TPU_AUDIT_INTERVAL``); disabled means disabled: no thread, no
LISTs, no per-tick cost anywhere in the engine.

``kwok-audit`` is a supervised worker, so its ``_ae_lock`` is
reclaimable (``kwok_tpu_torch/locks.py``): a pill that lands between its
acquire and its release leaves nothing held once the watchdog restarts
the pass. ``kwok_tpu`` takes a plain lock there.
"""

from __future__ import annotations

import logging
import os
import re
import time

from kwok_tpu_torch.edge.kubeclient import (
    ADDED,
    DELETED,
    ContinueExpired,
    TooManyRequests,
)
from kwok_tpu_torch.engine.rowpool import shard_of
from kwok_tpu_torch.locks import reclaimable
from kwok_tpu_torch.models.lifecycle import NODE_PHASES
from kwok_tpu_torch.resilience.checkpoint import row_uid

logger = logging.getLogger("kwok_tpu_torch.resilience")

#: divergence classes (the kwok_drift_detected_total reason label)
REASONS = ("missed-event", "double-apply", "stale-row", "ghost-row")

# Per-pass budgets. Pages/pass bounds the read load (the 429-storm
# guard); suspects/pass bounds the settle re-check GET fan-out. Both are
# deliberately small — anti-entropy converges over passes, not within
# one — and env-tunable for rigs.
_PAGE_SIZE = int(os.environ.get("KWOK_TPU_AUDIT_PAGE_SIZE", "256"))
_MAX_PAGES = int(os.environ.get("KWOK_TPU_AUDIT_MAX_PAGES", "4"))
_MAX_SUSPECTS = 64

#: consecutive passes one divergence must survive REPAIR before the
#: engine degrades (reason "drift"): 1-2 passes are normal repair
#: latency, 3+ means re-ingest is not converging
_DEGRADE_STREAK = 3

_HELP_DETECTED = (
    "Silent state divergences the anti-entropy auditor confirmed "
    "(survived the settle re-check) between apiserver truth and engine "
    "rows, by kind and class: missed-event (object with no row), "
    "double-apply (engine rv ahead of the server's — old-world state), "
    "stale-row (same uid, server status disagrees with engine-owned "
    "truth), ghost-row (row whose object is gone or was recreated under "
    "a new uid)"
)
_HELP_REPAIRED = (
    "Divergent rows the auditor repaired via re-ingest (a fresh ADDED "
    "re-runs upsert + the repair-render re-patch; a synthetic DELETED "
    "releases a ghost row)"
)
_HELP_PASS = (
    "Wall seconds per anti-entropy audit pass (budgeted LIST window + "
    "settle re-check + repair enqueue; only moves with --audit-interval "
    "set)"
)


_PATH_SEGMENT = re.compile(r"[!-~]+")


def _addressable(*parts) -> bool:
    """Whether every non-None part can stand verbatim as one segment of a
    request path: printable ASCII with no space, '/', '?', '#' or '%'."""
    return all(
        p is None or (_PATH_SEGMENT.fullmatch(p) is not None
                      and not any(c in p for c in "/?#%"))
        for p in parts
    )


def _srv_rv(obj) -> int:
    """The server object's resourceVersion (0: gone or unparseable)."""
    try:
        return int(((obj or {}).get("metadata") or {}).get("resourceVersion") or 0)
    except (TypeError, ValueError):
        return 0


class AntiEntropyAuditor:
    """One engine's background drift detector/repairer.

    Single audit thread by contract (``run`` is the worker target); the
    ``_ae_lock`` (a reclaimable leaf: nothing is taken under it) guards
    the scan cursor / cycle / streak state against snapshot reads from
    other threads (gates and tests read ``snapshot()`` while a pass
    runs).
    """

    def __init__(self, engine, interval: float,
                 page_size: int = 0, max_pages: int = 0,
                 settle_s: float = 0.0):
        self.engine = engine
        self.interval = max(0.05, float(interval))
        self.page_size = int(page_size) or _PAGE_SIZE
        self.max_pages = int(max_pages) or _MAX_PAGES
        # settle window: long enough for an in-flight patch to land
        # (executor RTT), short enough to stay inside one pass
        self.settle_s = float(settle_s) or max(
            0.2, 3.0 * float(engine.config.tick_interval)
        )
        # hash-shard scope: a --lane-procs CHILD audits only
        # the keys its lane owns — LIST windows are filtered by
        # rowpool.shard_of, so two lanes never double-repair one object
        # and repairs re-ingest through the OWNING lane's queue (per-key
        # order preserved by construction). (1, 0) everywhere else:
        # parent/threaded engines audit the whole keyspace.
        self.shard_i = int(getattr(engine, "_lane_index", 0))
        self.shard_n = int(getattr(engine, "_lane_n", 1))
        self._ae_lock = reclaimable()
        self._cursor: dict[str, str] = {"nodes": "", "pods": ""}
        # the revision of the snapshot the last window showed (a paged
        # LIST's pages show their first page's; 0: unknown)
        self._window_rv: dict[str, int] = {"nodes": 0, "pods": 0}
        self._cycle_seen: dict[str, set] = {"nodes": set(), "pods": set()}
        # completed scan cycles per kind: the streak bookkeeping's clock.
        # Streaks must be judged per CYCLE, not per pass — on a cluster
        # larger than one window a divergent object is only re-scanned
        # once per cycle, and pass-keyed streaks would reset (and the
        # degraded flag clear) on every intervening healthy window
        self._cycles: dict[str, int] = {"nodes": 0, "pods": 0}
        # (kind, key, reason) -> [confirm_count, cycle_no at last confirm]
        self._streaks: dict[tuple, list] = {}
        # (kind, key, reason) -> [server rv, row view, the row's (obj,
        # raw) when the repair was queued, cycle_no at last confirm] of
        # the repair last queued for it (_in_flight); pruned as the
        # streaks are
        self._repairs: dict[tuple, list] = {}
        self._passes = 0
        r = engine.telemetry.registry
        self._detected = r.counter(
            "kwok_drift_detected_total", _HELP_DETECTED, ("kind", "reason")
        )
        self._repaired = r.counter(
            "kwok_drift_repaired_total", _HELP_REPAIRED
        )
        self._pass_hist = r.histogram(
            "kwok_audit_pass_seconds", _HELP_PASS
        )

    # ------------------------------------------------------------- reads

    def detected_total(self, kind: str | None = None,
                       reason: str | None = None) -> int:
        total = 0
        for values, c in self._detected.children():
            if kind is not None and values[0] != kind:
                continue
            if reason is not None and values[1] != reason:
                continue
            total += c.value
        return total

    @property
    def repaired_total(self) -> int:
        return self._repaired.child.value

    def snapshot(self) -> dict:
        """Gate/diagnostic view of the auditor's state."""
        with self._ae_lock:
            return {
                "passes": self._passes,
                "cursor": dict(self._cursor),
                "streaks": {
                    "/".join(map(str, k)): v
                    for k, v in self._streaks.items()
                },
                "detected_total": self.detected_total(),
                "repaired_total": self.repaired_total,
            }

    # ----------------------------------------------------------- the loop

    def run(self) -> None:
        """Worker target (thread ``kwok-audit``, watchdog-supervised)."""
        eng = self.engine
        next_at = time.monotonic() + self.interval
        while eng._running:
            now = time.monotonic()
            if now < next_at:
                time.sleep(min(0.2, next_at - now))
                continue
            next_at = now + self.interval
            if not eng.ready:
                # the startup catch-up gate owns convergence until the
                # first full re-list lands; auditing half-built rows
                # would flood the suspect list with false positives
                continue
            try:
                self.pass_once()
            except TooManyRequests as e:
                # the admission tier said stop: honor the hint on top of
                # the normal cadence — the auditor must never contribute
                # to a 429 storm
                next_at = time.monotonic() + max(
                    self.interval, e.retry_after
                )
                eng.telemetry.add_throttle(e.retry_after)
                logger.warning(
                    "audit pass throttled by apiserver (429); next pass "
                    "in %.1fs", next_at - time.monotonic(),
                )
            except Exception:
                # transport faults (incl. injected ones) and transient
                # store errors: skip the pass, keep the cadence — the
                # next window re-reads everything this one missed
                logger.warning("audit pass failed", exc_info=True)

    def pass_once(self) -> None:
        """One audit pass over both kinds: window -> diff -> settle
        re-check -> repair -> degradation bookkeeping."""
        t0 = time.perf_counter()
        confirmed: list[tuple] = []  # (kind, key, reason)
        suspects: list[tuple] = []   # (kind, key, reason, ns, name)
        for kind in ("pods", "nodes"):
            # per-KIND cap (inside _scan_kind): a pod-drift storm must
            # not starve node suspects out of the shared re-check budget
            suspects.extend(self._scan_kind(kind))
        if suspects:
            self._settle_sleep()
            for kind, key, reason, ns, name in suspects:
                if self._recheck_and_repair(kind, key, reason, ns, name):
                    confirmed.append((kind, key, reason))
        self._account(confirmed)
        self._pass_hist.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------ windows

    def _scan_kind(self, kind: str) -> list[tuple]:
        """List one budgeted window of ``kind`` and return divergence
        suspects ``(kind, key, reason, ns, name)``."""
        items, cycle_done = self._list_window(kind)
        out: list[tuple] = []
        capped = False
        seen = self._cycle_seen[kind]
        gaps: dict = {}  # key -> row rv minus listed rv, for double-apply
        # a row may hold writes the window's snapshot predates: a revision
        # past the snapshot's but within what the engine's watch has
        # received is no evidence of a double apply (a continuation page
        # shows its cycle's first page, so on a busy store most rows are
        # past it). kwok_tpu flags them all and re-checks each with a GET
        with self._ae_lock:
            snap_rv = self._window_rv[kind]
        received = self.engine._watch_rv.get(kind, 0) if snap_rv else 0
        for obj in items:
            meta = obj.get("metadata") or {}
            name = meta.get("name")
            if not name:
                continue
            # a node is cluster-scoped: its re-check GET must not name a
            # namespace (kwok_tpu's does, gets 404, and releases the live
            # node's row as a ghost)
            ns = (meta.get("namespace") or "default") if kind == "pods" else None
            key = (ns, name) if kind == "pods" else name
            if self.shard_n > 1 and (
                shard_of(key, self.shard_n) != self.shard_i
            ):
                # another lane's shard: its own auditor covers it (a
                # node outside the shard is the topology TAP's — no row
                # here, and classifying it would flag a false
                # missed-event every cycle)
                continue
            with self._ae_lock:
                seen.add(key)
            reason = self._classify(kind, key, obj)
            if reason == "double-apply":
                view = self._row_view(kind, key)
                row_rv = view[1] if view else 0
                if snap_rv < row_rv <= received:
                    continue
                gaps[key] = row_rv - _srv_rv(obj)
            if reason is not None:
                out.append((kind, key, reason, ns, name))
        if len(out) > _MAX_SUSPECTS:
            # more suspects than one pass re-checks: the strongest
            # evidence first. A continuation page serves the snapshot of
            # its cycle's first page, so on a busy store every row written
            # since looks a little ahead of it (double-apply by a small
            # margin) and is thrown out by the re-check; in key order
            # those crowd out real divergences for a whole cycle.
            # kwok_tpu keeps the first ones in key order and stops
            # classifying there (the rest of the window also misses the
            # cycle's seen set and turns into ghost suspects)
            capped = True
            out.sort(key=lambda s: (s[2] == "double-apply", -gaps.get(s[1], 0)))
            del out[_MAX_SUSPECTS:]
        if cycle_done:
            # the scan covered the whole keyspace: rows the server never
            # returned are ghost suspects (verified per row by the
            # settle re-check's GET — a row acquired mid-cycle may
            # simply postdate its window)
            with self._ae_lock:
                cycle = set(seen)
                seen.clear()
                self._cycles[kind] += 1  # the streak bookkeeping's clock
            for key in self._engine_keys(kind):
                if key in cycle:
                    continue
                if len(out) >= _MAX_SUSPECTS:
                    capped = True
                    break
                if kind == "pods":
                    ns, name = key
                else:
                    ns, name = None, key
                out.append((kind, key, "ghost-row", ns, name))
        if capped:
            # never a silent cap: the remainder waits for later passes
            logger.warning(
                "audit pass capped %s suspects at %d; the rest re-check "
                "on later passes", kind, _MAX_SUSPECTS,
            )
        return out

    def _list_window(self, kind: str):
        """One page-budgeted LIST slice through the engine's own watch
        selectors. Returns ``(items, cycle_done)`` where ``cycle_done``
        means the scan cursor wrapped — the union of windows since the
        last wrap covered the whole keyspace."""
        eng = self.engine
        opts = eng._watch_opts.get(kind, {})
        page = getattr(eng.client, "list_page", None)
        if page is None:
            # clients without paging (the in-memory FakeKube): one full
            # list IS the whole cycle
            return eng.client.list(kind, **opts), True
        with self._ae_lock:
            cont = self._cursor[kind]
        items: list[dict] = []
        restarted = False
        window_rv = 0
        for _ in range(self.max_pages):
            try:
                objs, cont = page(
                    kind, limit=self.page_size, cont=cont, **opts
                )
            except ContinueExpired:
                # the cursor was compacted away mid-scan: the scan
                # RESTARTS — typed, so a legitimately-empty final page
                # (no items, no token) still counts as a completed
                # cycle, while an expiry never does (every unscanned
                # engine row would otherwise become a false ghost
                # suspect swept against a just-compacted apiserver)
                restarted = True
                cont = ""
                break
            items.extend(objs)
            window_rv = getattr(objs, "rv", 0)
            if not cont:
                break
        with self._ae_lock:
            self._cursor[kind] = cont
            self._window_rv[kind] = window_rv
            if restarted:
                self._cycle_seen[kind].clear()
        return items, (not cont and not restarted)

    def _engine_keys(self, kind: str) -> list:
        eng = self.engine
        lanes = eng._lanes
        if lanes is None:
            # lock-free read racing the tick thread: a mid-copy resize
            # raises; yield and retry the C-level copy
            k = eng.pods if kind == "pods" else eng.nodes
            while True:
                try:
                    return list(k.pool.keys())
                except RuntimeError:
                    time.sleep(0)
        keys: list = []
        for lane in lanes.lanes:
            e = lane.engine
            k = e.pods if kind == "pods" else e.nodes
            with lane.stage_lock:
                # the lane's stage_lock serializes every pool mutation,
                # so one plain copy suffices (no retry, no sleep held)
                keys.extend(k.pool.keys())
        return keys

    # ----------------------------------------------------------- classify

    def _owner(self, key):
        """The engine whose rows hold ``key`` (its lane's under threaded
        lanes)."""
        lanes = self.engine._lanes
        if lanes is not None:
            return lanes.lanes[shard_of(key, lanes.n)].engine
        return self.engine

    def _row_view(self, kind: str, key):
        """(uid, rv, phase_name, node) of the engine's row (node: a pod's
        binding, "" for a node row), or None. Reads are
        GIL-atomic dict/array ops; a torn read only creates a suspect the
        settle re-check throws out."""
        e = self._owner(key)
        k = e.pods if kind == "pods" else e.nodes
        idx = k.pool.lookup(key)
        if idx is None:
            return None
        m = k.pool.meta[idx]
        if not m:
            return None
        try:
            rv = int(m.get("rv") or 0)
        except (TypeError, ValueError):
            rv = 0
        if kind == "pods":
            phase = e._pod_phases[int(k.phase_h[idx])]
        else:
            phase = NODE_PHASES.phases[int(k.phase_h[idx])]
        return row_uid(m), rv, phase, (m.get("node") or "") if kind == "pods" else ""

    def _classify(self, kind: str, key, obj: dict) -> "str | None":
        """One listed object vs its row; None = converged."""
        eng = self.engine
        view = self._row_view(kind, key)
        meta = obj.get("metadata") or {}
        if view is None:
            if kind == "pods":
                if not (obj.get("spec") or {}).get("nodeName"):
                    return None  # unscheduled: outside the watch filter
            elif not (
                eng._node_need_heartbeat(obj) or key in eng.node_has
            ):
                return None  # a node this engine does not manage
            return "missed-event"
        uid, rv, phase, node = view
        srv_uid = meta.get("uid") or ""
        try:
            srv_rv = int(meta.get("resourceVersion") or 0)
        except (TypeError, ValueError):
            srv_rv = 0
        if uid and srv_uid and uid != srv_uid:
            # deleted + recreated while the engine looked away: the row
            # describes an object that no longer exists
            return "ghost-row"
        if rv and srv_rv and srv_rv < rv:
            # the engine ingested revisions the server does not have —
            # a double-applied old-world state (store rewind signature)
            return "double-apply"
        if kind == "pods":
            srv_node = (obj.get("spec") or {}).get("nodeName") or ""
            if node and srv_node and node != srv_node:
                # same object, same uid and revision, bound to another
                # node than the server's (a garbled line that parsed):
                # the pod never runs and only a re-ingest rebinds it.
                # kwok_tpu compares (uid, rv, phase) and cannot see it
                return "stale-row"
        if kind == "pods" and phase not in ("", "Gone"):
            srv_phase = (obj.get("status") or {}).get("phase") or ""
            if srv_phase and srv_phase != phase:
                # same object, same uid, but the server's status
                # disagrees with the engine-owned truth
                return "stale-row"
        return None

    # ---------------------------------------------------- confirm + repair

    def _settle_sleep(self) -> None:
        deadline = time.monotonic() + self.settle_s
        while self.engine._running and time.monotonic() < deadline:
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))

    def _recheck_and_repair(self, kind, key, reason, ns, name) -> bool:
        """The suspicion gate: re-GET the object and re-read the row
        after the settle window; only a divergence that is STILL there —
        same class — counts and repairs. Returns confirmed?"""
        eng = self.engine
        # a row keyed by a name from a garbled line that no request path
        # can carry (not printable ASCII, or a path delimiter) names no
        # object on the server: it is a ghost. kwok_tpu GETs it anyway,
        # and its pass dies there, every pass
        fresh = eng.client.get(kind, ns, name) if _addressable(ns, name) else None
        if fresh is None:
            # object truly gone: divergence iff the row still exists
            if self._row_view(kind, key) is None:
                return False
            confirmed_reason = "ghost-row"
        else:
            confirmed_reason = self._classify(kind, key, fresh)
            if confirmed_reason is None:
                return False
            if confirmed_reason != reason:
                # the divergence changed shape mid-settle: still moving,
                # let the next pass judge it. (A cycle-scan ghost suspect
                # whose object reappeared under a NEW uid re-classifies
                # as ghost-row — equal reasons — and is confirmed here;
                # any other re-classification is an in-flight transient.)
                return False
        srv_rv = _srv_rv(fresh)
        view = self._row_view(kind, key)
        refs = self._row_refs(kind, key)
        ent = (kind, key, confirmed_reason)
        with self._ae_lock:
            prev = self._repairs.get(ent)
        if prev is not None and self._in_flight(kind, key, prev, srv_rv, view, refs):
            with self._ae_lock:
                prev[3] = self._cycles[kind]
            return False
        self._detected.labels(kind=kind, reason=confirmed_reason).inc()
        logger.warning(
            "drift detected (%s %s): %s; repairing via re-ingest",
            kind, key, confirmed_reason,
        )
        t = time.monotonic()
        if fresh is None:
            md = {"name": name}
            if ns is not None:
                md["namespace"] = ns
            eng._q.put((kind, DELETED, {"metadata": md}, t))
        else:
            # ADDED (not MODIFIED): the stale-rv ingest tier must never
            # drop a repair that legitimately carries a regressed
            # revision (the double-apply/rewind case)
            eng._q.put((kind, ADDED, fresh, t))
        self._repaired.inc()
        with self._ae_lock:
            self._repairs[ent] = [srv_rv, view, refs, self._cycles[kind]]
        return True

    def _row_refs(self, kind: str, key):
        """The row's parsed object and raw line, the objects themselves
        (every ingest of the row replaces one of them), or None without a
        row."""
        e = self._owner(key)
        k = e.pods if kind == "pods" else e.nodes
        idx = k.pool.lookup(key)
        if idx is None:
            return None
        m = k.pool.meta[idx] or {}
        return m.get("obj"), m.get("raw")

    def _in_flight(self, kind, key, prev, srv_rv, view, refs) -> bool:
        """The repair queued for this divergence has not landed: the
        server shows the same revision, and nothing has been ingested for
        the row since (no row still, or the very same object and raw
        line), while a worker drains the engine's queue (an engine driven
        by hand has none: its repair lands only when its caller drains,
        so each re-confirmation counts)."""
        if prev[0] != srv_rv or prev[1] != view:
            return False
        if not any(t.is_alive() for t in self.engine._threads):
            return False
        then = prev[2]
        if then is None or refs is None:
            return then is None and refs is None
        return refs[0] is then[0] and refs[1] is then[1]

    def _account(self, confirmed: list) -> None:
        """Streak bookkeeping, keyed per scan CYCLE (not per pass): on a
        cluster larger than one window a divergent object is re-scanned
        only once per cycle, so pass-keyed streaks would reset — and the
        degraded flag clear — on every intervening healthy window. A
        streak entry survives until its kind completes a full cycle
        after the last confirmation without re-confirming it (its window
        was re-scanned and found clean, or the object is gone)."""
        eng = self.engine
        with self._ae_lock:
            self._passes += 1
            for ent in confirmed:
                kind = ent[0]
                rec = self._streaks.get(ent)
                if rec is None:
                    self._streaks[ent] = [1, self._cycles[kind]]
                else:
                    rec[0] += 1
                    rec[1] = self._cycles[kind]
            # prune entries whose kind's scan wrapped a full cycle past
            # their last confirmation: that cycle re-covered the
            # object's window and did not re-confirm
            self._streaks = {
                ent: rec for ent, rec in self._streaks.items()
                if self._cycles[ent[0]] < rec[1] + 2
            }
            self._repairs = {
                ent: rec for ent, rec in self._repairs.items()
                if self._cycles[ent[0]] < rec[3] + 2
            }
            worst = max((r[0] for r in self._streaks.values()), default=0)
            stuck = sum(
                1 for r in self._streaks.values()
                if r[0] >= _DEGRADE_STREAK
            )
            empty = not self._streaks
        if worst >= _DEGRADE_STREAK:
            if eng._degradation.set("drift"):
                logger.error(
                    "engine degraded: %d divergence(s) surviving repair "
                    "for %d+ audit cycles (reason drift)",
                    stuck, _DEGRADE_STREAK,
                )
        elif empty:
            if eng._degradation.clear("drift"):
                logger.info("drift cleared: audit found no divergence")
