"""Native-twin lint bridge: lock discipline for the port's ``native/*.cc``.

The port carries its own C++ (``kwok_tpu_torch/native/``: the apiserver,
the pump, ingest and the codec) with none of the Python tree's lint
coverage. This module closes the gap with
a line-level parser (the approach ``metrics_doc.py`` already uses for
apiserver.cc metric strings): comments and string/raw-string literals
are stripped, brace depth is tracked, and every
``std::lock_guard``/``std::unique_lock`` declaration opens a lexical
critical section that ends with its enclosing brace. Three rules read
the resulting acquisition timeline:

- ``cc-lock-order`` — nested guard acquisitions must descend the
  declared table below; same-name nesting is a self-deadlock
  (``std::mutex`` is non-recursive) or an ABBA hazard across instances
  (shard locks never nest with each other by contract); the standalone
  mutexes must never share a lexical scope with any other guard.
- ``cc-fence-first`` — the server-side write fence: a
  deferred ``std::unique_lock<std::mutex> fence_lk;`` must be armed by
  ``fence_check(fence_lk)`` as the IMMEDIATELY following statement
  (check and commit are one critical section), and every
  ``commit_locked(`` reached under a shard lock must have the fence
  gate lexically in scope — a mutation handler that drops the fence
  loses zombie-primary write-deadness.
- ``cc-socket-under-lock`` — no socket write (``send``/``send_all``)
  while a store or shard mutex is lexically held: one slow client would
  convoy the whole store. The watch streamer's shape (drain under
  ``ring_mu``, send after the scope closes) is the compliant pattern.

The analysis is lexical (per-function scopes), deliberately: the
documented cross-function nestings (``commit_locked``'s registry
identity check under the caller's ``mu``) are invisible here and stay
the runtime witness's job. The declared table is the reference's
(lease 86 -> shard 87 -> store clock 88 -> broadcast ring 89 -> audit
95) plus the port's own leaves: the drift rig's ``/rig/writes`` and
``/rig/threads`` mutexes.
"""

from __future__ import annotations

import glob
import os
import re

from kwok_tpu_torch.analysis.core import Finding, Rule

# Declared C++ mutex order (outermost first): lease 86 -> shard 87 ->
# store clock 88 -> broadcast ring 89 -> audit 95, then the port's rig
# leaves. Names are the terminal identifier of the guard's mutex
# expression (`store.lease_mu` -> lease_mu, `sh->smu` -> smu).
CC_LOCK_ORDER: dict[str, int] = {
    "lease_mu": 86,
    "smu": 87,
    "mu": 88,
    "ring_mu": 89,
    "audit_mu": 95,
    # --rig-routes (apiserver.cc): g_rig_writes_mu guards the Running
    # patch tally; rig_note_status takes it inside a status commit (under
    # a shard's smu, one call away) and nothing is taken under it.
    # g_census_mu guards the set of connection-thread census slots;
    # census_json holds it while it reads each slot under the slot's own
    # slot_mu, and it probes the store locks with try_lock before it.
    "g_rig_writes_mu": 96,
    "g_census_mu": 96,
    "slot_mu": 97,
}

# Mutexes that must never share a lexical critical section with ANY
# other guard: shards_mu guards shard-registry creation/swap only;
# g_flight_mu and g_pumps_mu are microsecond registry lookups.
CC_STANDALONE: frozenset = frozenset({
    "shards_mu", "g_flight_mu", "g_pumps_mu",
})

# The store/shard set for the socket-write check (a send while one of
# these is held convoys every other request on the partition).
CC_STORE_LOCKS: frozenset = frozenset({
    "lease_mu", "smu", "mu", "ring_mu", "shards_mu",
})

# Socket-write calls (apiserver.cc send_all wraps send(2); pump.cc
# calls send(2) directly).
_SEND_RE = re.compile(r"(?<![\w.>])(?:send_all|send)\s*\(")

_GUARD_RE = re.compile(
    r"\b(?:std::)?(?:lock_guard|unique_lock|scoped_lock)\s*<[^>]*>\s+"
    r"(\w+)\s*\(\s*([^)]*)\)"
)
_DEFERRED_RE = re.compile(
    r"\b(?:std::)?unique_lock\s*<[^>]*>\s+(\w+)\s*;"
)
_LATE_BIND_RE = re.compile(
    r"\b(\w+)\s*=\s*(?:std::)?unique_lock\s*<[^>]*>\s*\(\s*([^)]*)\)"
)
_FENCE_CALL_RE = re.compile(r"\bfence_check\s*\(\s*(\w+)\s*\)")
_FENCE_DEF_RE = re.compile(r"\bfence_check\s*=\s*\[")
_UNLOCK_RE = re.compile(r"\b(\w+)\s*\.\s*unlock\s*\(\s*\)")
_COMMIT_RE = re.compile(r"\bcommit_locked\s*\(")


def cc_files(root: str) -> list:
    """Every native C++ translation unit the bridge lints."""
    return sorted(
        glob.glob(os.path.join(root, "kwok_tpu_torch", "native", "*.cc"))
    )


def _mutex_name(expr: str) -> "str | None":
    """Terminal identifier of a guard's mutex expression."""
    expr = expr.strip()
    if not expr:
        return None
    last = re.split(r"\.|->", expr)[-1].strip()
    return last if re.fullmatch(r"\w+", last) else None


def _strip_code(source: str) -> list:
    """Source -> per-line code with comments and string/char literals
    blanked (braces and parens inside them must not count). Handles
    ``//``, ``/* */``, ``"..."`` with escapes, ``'...'``, and raw
    strings ``R"delim( ... )delim"`` (the bootstrap-RBAC JSON blob spans
    dozens of brace-laden lines)."""
    out_lines = []
    buf = []
    state = "code"  # code | line_comment | block_comment | str | char | raw
    raw_end = ""
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        if c == "\n":
            if state == "line_comment":
                state = "code"
            out_lines.append("".join(buf))
            buf = []
            i += 1
            continue
        if state == "code":
            if c == "/" and i + 1 < n and source[i + 1] == "/":
                state = "line_comment"
                i += 2
                continue
            if c == "/" and i + 1 < n and source[i + 1] == "*":
                state = "block_comment"
                i += 2
                continue
            m = re.match(r'R"([^\s()\\]{0,16})\(', source[i:i + 20]) \
                if c == "R" else None
            if m:
                state = "raw"
                raw_end = ")" + m.group(1) + '"'
                i += m.end()
                continue
            if c == '"':
                state = "str"
                i += 1
                continue
            if c == "'":
                state = "char"
                i += 1
                continue
            buf.append(c)
            i += 1
            continue
        if state in ("str", "char"):
            if c == "\\":
                i += 2
                continue
            if (state == "str" and c == '"') or (
                state == "char" and c == "'"
            ):
                state = "code"
            i += 1
            continue
        if state == "raw":
            if source.startswith(raw_end, i):
                state = "code"
                i += len(raw_end)
            else:
                i += 1
            continue
        if state == "block_comment":
            if c == "*" and i + 1 < n and source[i + 1] == "/":
                state = "code"
                i += 2
            else:
                i += 1
            continue
        i += 1  # line_comment
    if buf or state != "code":
        out_lines.append("".join(buf))
    return out_lines


class _Acq:
    """One lexical acquisition: mutex name + what was already held."""

    __slots__ = ("line", "mutex", "held", "var")

    def __init__(self, line, mutex, held, var):
        self.line = line
        self.mutex = mutex
        self.held = held  # [(mutex, line), ...] at acquisition time
        self.var = var


class _CcScan:
    """One parsed .cc file: acquisition timeline + rule-ready events."""

    def __init__(self, path: str, rel: str, source: str) -> None:
        self.path = path
        self.rel = rel
        self.acquisitions: list = []   # _Acq
        self.sends: list = []          # (line, held-list)
        self.deferred_decls: list = [] # (line, var, next_code_line_text, next_line_no)
        self.commits: list = []        # (line, held-list, fence_in_scope)
        self._parse(_strip_code(source))

    def _parse(self, lines: list) -> None:
        depth = 0
        held: list = []      # [decl_depth, mutex, line, var]
        deferred: dict = {}  # var -> (decl_depth, line)
        pending_decl: "tuple | None" = None  # (line, var) awaiting next stmt
        # depth at which a `fence_check = [...]` lambda was defined:
        # commits are held to the fence requirement only while it is in
        # scope (the client request handler) — server-internal commits
        # (bootstrap seeding, event eviction) have no claim to check
        fence_def_depth: "int | None" = None

        def held_snapshot():
            return [(h[1], h[2]) for h in held]

        for lineno, line in enumerate(lines, 1):
            code = line.strip()
            if not code or code.startswith("#"):
                continue
            if pending_decl is not None:
                self.deferred_decls.append(
                    (pending_decl[0], pending_decl[1], code, lineno)
                )
                pending_decl = None

            # interleave guard/send/brace events by column so a guard
            # inside a one-line block scopes to that block's braces
            events: list = []  # (pos, kind, payload)
            for m in _GUARD_RE.finditer(line):
                name = _mutex_name(m.group(2))
                if name is not None:
                    events.append((m.start(), "acq", (name, m.group(1))))
            for m in _DEFERRED_RE.finditer(line):
                events.append((m.start(), "defer", m.group(1)))
            for m in _LATE_BIND_RE.finditer(line):
                name = _mutex_name(m.group(2))
                if name is not None:
                    events.append((m.start(), "bind", (name, m.group(1))))
            for m in _FENCE_CALL_RE.finditer(line):
                events.append((m.start(), "fence", m.group(1)))
            for m in _FENCE_DEF_RE.finditer(line):
                events.append((m.start(), "fence_def", None))
            for m in _UNLOCK_RE.finditer(line):
                events.append((m.start(), "unlock", m.group(1)))
            for m in _SEND_RE.finditer(line):
                events.append((m.start(), "send", None))
            for m in _COMMIT_RE.finditer(line):
                events.append((m.start(), "commit", None))
            for i, ch in enumerate(line):
                if ch in "{}":
                    events.append((i, ch, None))
            events.sort(key=lambda ev: ev[0])

            for _pos, kind, payload in events:
                if kind == "{":
                    depth += 1
                elif kind == "}":
                    depth = max(0, depth - 1)
                    held[:] = [h for h in held if h[0] <= depth]
                    deferred = {
                        v: dv for v, dv in deferred.items()
                        if dv[0] <= depth
                    }
                    if fence_def_depth is not None \
                            and depth < fence_def_depth:
                        fence_def_depth = None
                elif kind == "acq":
                    name, var = payload
                    self.acquisitions.append(
                        _Acq(lineno, name, held_snapshot(), var)
                    )
                    held.append([depth, name, lineno, var])
                elif kind == "defer":
                    deferred[payload] = (depth, lineno)
                    pending_decl = (lineno, payload)
                elif kind == "bind":
                    name, var = payload
                    self.acquisitions.append(
                        _Acq(lineno, name, held_snapshot(), var)
                    )
                    d = deferred.get(var, (depth, lineno))[0]
                    held.append([d, name, lineno, var])
                elif kind == "fence":
                    # fence_check(fence_lk) binds lease_mu to the
                    # deferred lock when the request carries a fence
                    # claim: model it as acquiring lease_mu at the
                    # declaration's scope
                    var = payload
                    if var in deferred:
                        self.acquisitions.append(
                            _Acq(lineno, "lease_mu", held_snapshot(), var)
                        )
                        held.append(
                            [deferred[var][0], "lease_mu", lineno, var]
                        )
                elif kind == "unlock":
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][3] == payload:
                            del held[i]
                            break
                elif kind == "fence_def":
                    fence_def_depth = depth
                elif kind == "send":
                    self.sends.append((lineno, held_snapshot()))
                elif kind == "commit":
                    self.commits.append(
                        (lineno, held_snapshot(),
                         fence_def_depth is not None)
                    )


# parse cache: (path, mtime) -> _CcScan; three rules share one parse
_scan_cache: dict = {}


def scan_cc(path: str, root: str) -> _CcScan:
    key = (path, os.path.getmtime(path))
    hit = _scan_cache.get(path)
    if hit is not None and hit[0] == key[1]:
        return hit[1]
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    scan = _CcScan(path, os.path.relpath(path, root), source)
    _scan_cache[path] = (key[1], scan)
    return scan


class _CcRuleBase(Rule):
    """Shared .cc discovery: lints kwok_tpu_torch/native/*.cc under the repo
    root, or an explicit directory/file list (fixture tests)."""

    def __init__(self, cc_paths: "list | None" = None) -> None:
        self.cc_paths = cc_paths

    def _scans(self, root: str):
        paths = self.cc_paths if self.cc_paths is not None \
            else cc_files(root)
        for p in paths:
            yield scan_cc(p, root)


class CcLockOrderRule(_CcRuleBase):
    name = "cc-lock-order"
    description = (
        "native guards follow the declared mutex order lease_mu(86) -> "
        "smu(87) -> mu(88) -> ring_mu(89); standalone mutexes never "
        "share a scope"
    )

    def check_project(self, mods, root):
        for scan in self._scans(root):
            for acq in scan.acquisitions:
                for held_name, held_line in acq.held:
                    msg = self._violation(held_name, acq.mutex)
                    if msg:
                        yield Finding(
                            scan.rel, acq.line, self.name,
                            f"{msg} (outer acquired at line {held_line})",
                        )

    @staticmethod
    def _violation(held: str, inner: str) -> "str | None":
        if inner == held:
            return (
                f"re-acquires {inner} while already holding it: "
                "std::mutex is non-recursive (self-deadlock), and two "
                "instances of one lock class have no defined order "
                "(ABBA hazard)"
            )
        if held in CC_STANDALONE or inner in CC_STANDALONE:
            alone = held if held in CC_STANDALONE else inner
            return (
                f"acquires {inner} while holding {held}: {alone} is "
                "declared standalone and must never share a critical "
                "section with another guard"
            )
        lh = CC_LOCK_ORDER.get(held)
        li = CC_LOCK_ORDER.get(inner)
        if lh is None or li is None:
            return None
        if li < lh:
            return (
                f"acquires {inner} (level {li}) while holding {held} "
                f"(level {lh}): out of declared native lock order"
            )
        return None


class CcFenceFirstRule(_CcRuleBase):
    name = "cc-fence-first"
    description = (
        "a deferred fence lock is armed by fence_check() as the first "
        "statement of its critical section, and commit_locked under a "
        "shard lock requires the fence gate in scope"
    )

    def check_project(self, mods, root):
        for scan in self._scans(root):
            for line, var, next_code, next_line in scan.deferred_decls:
                want = re.compile(
                    r"if\s*\(\s*!\s*fence_check\s*\(\s*" + re.escape(var)
                    + r"\s*\)\s*\)"
                )
                if not want.search(next_code):
                    yield Finding(
                        scan.rel, line, self.name,
                        f"deferred lock {var} is not armed by "
                        f"`if (!fence_check({var}))` as the immediately "
                        "following statement: the fence claim check must "
                        "be the FIRST statement of the mutation critical "
                        "section (check+commit atomic)",
                    )
            for line, held, fenced_scope in scan.commits:
                names = {h for h, _l in held}
                if fenced_scope and "smu" in names \
                        and "lease_mu" not in names:
                    yield Finding(
                        scan.rel, line, self.name,
                        "commit_locked under a shard lock without the "
                        "fence gate in scope: a mutation handler that "
                        "drops fence_check loses zombie-primary "
                        "write-deadness (declare a deferred fence lock "
                        "and arm it first)",
                    )


class CcSocketUnderLockRule(_CcRuleBase):
    name = "cc-socket-under-lock"
    description = (
        "no socket write (send/send_all) while a store or shard mutex "
        "is held"
    )

    def check_project(self, mods, root):
        for scan in self._scans(root):
            for line, held in scan.sends:
                bad = [
                    (h, l) for h, l in held if h in CC_STORE_LOCKS
                ]
                if bad:
                    locks = ", ".join(
                        f"{h} (line {l})" for h, l in bad
                    )
                    yield Finding(
                        scan.rel, line, self.name,
                        f"socket write while holding {locks}: one slow "
                        "client convoys every request on the partition "
                        "— drain under the lock, send after the scope "
                        "closes",
                    )
