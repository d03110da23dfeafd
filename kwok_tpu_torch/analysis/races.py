"""Shared-state ownership rule: who mutates what, from which thread.

The bug class it checks: an instance attribute of one of the engine's
concurrent classes mutated from two worker threads with no lock (an
unlocked ``+=`` on a counter two workers bump). This rule machine-checks
it:

1. **Thread roots** come from the real spawn topology: every
   ``workers.spawn_worker``/``Watchdog.spawn`` call with a resolvable
   target and a literal (or locally-resolvable f-string) ``name``
   becomes a root — the tick loop, router, per-lane drain/emit workers,
   supervisor, checkpointer, chaos arms, watch threads. Local
   ``def spawn(target, name)`` forwarder closures (lanes/proclanes
   ``start_workers``) are followed, including the
   ``(lane.drain_loop, f"kwok-lane{i}")`` tuple-literal pairs they
   iterate. A ``threading.Thread(target=..., name=...)`` with a
   resolvable target and name is a root too (the port starts the
   engine's ``kwok-tick`` loop that way). ``multiprocessing`` targets are deliberately NOT roots: a
   child process shares no objects, so cross-process "races" on
   instance attrs are impossible by construction (the shm protocol rule
   owns that plane).
2. **Reachability** is solved over the same interprocedural call graph
   the lock rules use (``locks.build_index``): a method reachable from
   two roots runs on two threads. Methods reachable from no spawn root
   are charged to the pseudo-root ``main`` (the caller's thread —
   start/stop/dispatch surface).
3. Every ``self.<attr>`` assign/augmented-assign in the engine's
   concurrent classes (``TARGET_CLASSES``) is classified by the roots
   reaching its enclosing method and whether it sits inside a declared
   lock region (``with <lock>:`` — the table in ``locks.py``).
   ``__init__`` is construction-before-threads and exempt.
4. An attr mutated from >= 2 distinct roots with at least one mutation
   site outside any lock region is a finding at each unlocked site —
   unless the module annotates it::

       # kwoklint: lockfree=<attr>[,<attr>...] -- <why this is safe>

   One annotation covers every mutation site of those attrs in its
   module. The justification is mandatory (a bare annotation is itself
   a finding) and annotations must stay live: one naming an attr this
   rule no longer flags is stale and reported, exactly like a stale
   suppression.

The per-instance sharding idiom falls out naturally: all per-lane
drain workers share one root identity (``kwok-lane*``), so a ShardLane
attr touched only by its own drain worker counts one root and stays
clean, while an attr the router also writes counts two.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize

from kwok_tpu_torch.analysis.core import Finding, Module, Rule
from kwok_tpu_torch.analysis.locks import (
    RECEIVER_CLASS_HINTS,
    _COMMON_NAMES,
    _classify_call,
    _terminal,
    build_index,
    is_lock_name,
)

# The engine's concurrent classes (with the pump groups):
# instance attrs of these are reachable from multiple worker threads.
TARGET_CLASSES = frozenset({
    "ClusterEngine",
    "ShardLane",
    "LaneSet",
    "ProcLaneSet",
    "Degradation",
    "Watchdog",
    "_PumpGroup",
    "_SlotGuardPump",
})

MAIN_ROOT = "main"

_LOCKFREE_RE = re.compile(
    r"#\s*kwoklint:\s*lockfree=([A-Za-z0-9_,]+)\s*(.*)$"
)

_SPAWN_NAMES = frozenset({"spawn_worker", "spawn"})

# locks.RECEIVER_CLASS_HINTS extended with the engine's plane handles:
# spawn targets like `self._ha.run` / `self._auditor.run` resolve through
# the receiver attr, and the `loop` local in ClusterEngine.start is
# assigned from `self._proc.coordinator_loop` / `self._lanes.tick_loop`.
_RECEIVER_HINTS = {
    **RECEIVER_CLASS_HINTS,
    "_ha": "HAPlane",
    "_auditor": "AntiEntropyAuditor",
    "_proc": "ProcLaneSet",
    "_lanes": "LaneSet",
}


class _Annotation:
    __slots__ = ("line", "attrs", "justification", "used")

    def __init__(self, line, attrs, justification):
        self.line = line
        self.attrs = attrs
        self.justification = justification
        self.used: set = set()  # attrs that silenced a finding


def scan_lockfree(mod: Module) -> list:
    """All `# kwoklint: lockfree=` annotations in a module (tokenize,
    not line-regex: markers inside string literals must not count)."""
    out = []
    try:
        for tok in tokenize.generate_tokens(
            io.StringIO(mod.source).readline
        ):
            if tok.type != tokenize.COMMENT:
                continue
            m = _LOCKFREE_RE.search(tok.string)
            if not m:
                continue
            attrs = tuple(
                a.strip() for a in m.group(1).split(",") if a.strip()
            )
            just = m.group(2).strip().lstrip("-—:· ").strip()
            out.append(_Annotation(tok.start[0], attrs, just))
    except tokenize.TokenError:
        pass
    return out


class _Mutation:
    __slots__ = ("cls", "attr", "line", "locked", "mod", "fi", "root")

    def __init__(self, cls, attr, line, locked, mod, fi, root=None):
        self.cls = cls
        self.attr = attr
        self.line = line
        self.locked = locked
        self.mod = mod
        self.fi = fi       # owning _FuncInfo (None for closure roots)
        self.root = root   # fixed root name for closure-body mutations


def _walk_mutations(body, on_mutation, lock_depth: int = 0) -> None:
    """Statement walk recording `self.<attr>` stores, tracking whether a
    declared lock (`with <lock>:`) is held. Nested defs are separate
    scopes (closures are handled as spawn roots, not here)."""

    def walk(node, locks: int) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.With):
            inner = locks
            for item in node.items:
                if is_lock_name(_terminal(item.context_expr)):
                    inner += 1
            for stmt in node.body:
                walk(stmt, inner)
            return
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                _record(tgt, node.lineno, locks)
        elif isinstance(node, ast.AugAssign):
            _record(node.target, node.lineno, locks)
        for child in ast.iter_child_nodes(node):
            walk(child, locks)

    def _record(tgt, line, locks) -> None:
        if isinstance(tgt, ast.Tuple):
            for el in tgt.elts:
                _record(el, line, locks)
            return
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
        ):
            on_mutation(tgt.attr, line, locks > 0)

    for stmt in body:
        walk(stmt, lock_depth)


def _name_from_expr(expr, local_names: dict) -> "str | None":
    """A spawn's `name=` value as a root identity: literal string,
    f-string (formatted parts become `*`), or a local variable with
    exactly one such assignment in the function."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts)
    if isinstance(expr, ast.Name):
        return local_names.get(expr.id)
    return None


class _Root:
    """One thread identity: a spawn name pattern + its entry points."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.entries: list = []    # _FuncInfo entry points
        self.closures: list = []   # (owner_fi, FunctionDef) closure bodies

    def __repr__(self) -> str:
        return f"<root {self.name}>"


def _resolve_spawn_target(index, fi, expr, closures: dict):
    """A spawn target expression -> ('fi', _FuncInfo) | ('closure',
    FunctionDef) | None."""
    if isinstance(expr, ast.Attribute):
        recv = expr.value
        if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
            hit = index._resolve_in_class(fi.cls, expr.attr)
            return ("fi", hit) if hit is not None else None
        rname = _terminal(recv)
        if rname in _RECEIVER_HINTS:
            hit = index._resolve_in_class(_RECEIVER_HINTS[rname], expr.attr)
            if hit is not None:
                return ("fi", hit)
        if expr.attr in _COMMON_NAMES:
            return None
        cands = index.by_name.get(expr.attr, [])
        return ("fi", cands[0]) if len(cands) == 1 else None
    if isinstance(expr, ast.Name):
        if expr.id in closures:
            return ("closure", closures[expr.id])
        hit = index.by_module.get(fi.mod.modname, {}).get(expr.id)
        if hit is not None:
            return ("fi", hit)
        if expr.id in _COMMON_NAMES:
            return None
        cands = index.by_name.get(expr.id, [])
        return ("fi", cands[0]) if len(cands) == 1 else None
    return None


def _is_spawn_call(call: ast.Call, wrappers: set) -> "str | None":
    """'direct' for spawn_worker(...)/wd.spawn(...), 'thread' for
    threading.Thread(target=..., name=...), 'wrapper' for a call to a
    local forwarder closure, else None."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id == "spawn_worker":
            return "direct"
        if fn.id in wrappers:
            return "wrapper"
        if fn.id == "Thread":
            return "thread"
        return None
    if isinstance(fn, ast.Attribute) and fn.attr == "spawn":
        # Watchdog.spawn delegates to spawn_worker with the same name
        return "direct"
    if isinstance(fn, ast.Attribute) and fn.attr == "Thread" \
            and _terminal(fn.value) == "threading":
        return "thread"
    return None


def discover_roots(index) -> dict:
    """Spawn-site scan -> {root_name: _Root}. See module docstring for
    the shapes handled."""
    roots: dict = {}

    def root_for(name: "str | None") -> "_Root | None":
        if not name:
            return None
        return roots.setdefault(name, _Root(name))

    for fi in index.funcs:
        # nested defs (closure targets + spawn forwarders)
        closures = {}
        for node in ast.walk(fi.node):
            if isinstance(node, ast.FunctionDef) and node is not fi.node:
                closures[node.name] = node
        wrappers = set()
        for cname, cnode in closures.items():
            for sub in ast.walk(cnode):
                if isinstance(sub, ast.Call) and _is_spawn_call(
                    sub, set()
                ) == "direct":
                    wrappers.add(cname)
                    break
        # local `name = "..."` / f-string constants (watch-thread names)
        # and `loop = self._lanes.tick_loop`-style callable locals (the
        # kwok-tick target is whichever branch assigned `loop`; all
        # assignments count — a conservative union of entry points)
        local_names: dict = {}
        local_callables: dict = {}
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    v = _name_from_expr(node.value, {})
                    if v is not None and tgt.id not in local_names:
                        local_names[tgt.id] = v
                    if isinstance(node.value, ast.Attribute):
                        local_callables.setdefault(tgt.id, []).append(
                            node.value
                        )

        saw_variable_wrapper_call = False
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            kind = _is_spawn_call(node, wrappers)
            if kind is None:
                continue
            if kind == "direct":
                target = node.args[0] if node.args else None
                name_expr = next(
                    (kw.value for kw in node.keywords if kw.arg == "name"),
                    None,
                )
            elif kind == "thread":
                target = next(
                    (kw.value for kw in node.keywords if kw.arg == "target"),
                    None,
                )
                name_expr = next(
                    (kw.value for kw in node.keywords if kw.arg == "name"),
                    None,
                )
            else:  # wrapper: spawn(target, name) positional
                target = node.args[0] if len(node.args) >= 1 else None
                name_expr = node.args[1] if len(node.args) >= 2 else None
            if target is None:
                continue
            name = _name_from_expr(name_expr, local_names) \
                if name_expr is not None else None
            if name is None:
                if kind == "wrapper":
                    saw_variable_wrapper_call = True
                continue
            resolutions = []
            resolved = _resolve_spawn_target(index, fi, target, closures)
            if resolved is not None:
                resolutions.append(resolved)
            elif isinstance(target, ast.Name):
                for expr in local_callables.get(target.id, ()):
                    hit = _resolve_spawn_target(index, fi, expr, closures)
                    if hit is not None:
                        resolutions.append(hit)
            if not resolutions:
                continue
            r = root_for(name)
            for res in resolutions:
                if res[0] == "fi":
                    r.entries.append(res[1])
                else:
                    r.closures.append((fi, res[1]))
        if saw_variable_wrapper_call:
            # `for target, name in ((lane.drain_loop, f"kwok-lane{i}"),
            # ...): spawn(target, name)` — pair up the tuple literals
            for node in ast.walk(fi.node):
                if (
                    isinstance(node, ast.Tuple)
                    and len(node.elts) == 2
                    and isinstance(node.elts[0], ast.Attribute)
                ):
                    name = _name_from_expr(node.elts[1], local_names)
                    if name is None:
                        continue
                    resolved = _resolve_spawn_target(
                        index, fi, node.elts[0], closures
                    )
                    if resolved is not None and resolved[0] == "fi":
                        root_for(name).entries.append(resolved[1])
    return roots


def solve_reachability(index, roots: dict) -> dict:
    """{_FuncInfo: set(root names)} over the resolved call graph."""
    reach: dict = {}
    for root in roots.values():
        frontier: list = list(root.entries)
        for owner_fi, cnode in root.closures:
            for sub in ast.walk(cnode):
                if isinstance(sub, ast.Call):
                    site = _classify_call(sub)
                    if site is None:
                        continue
                    for callee in index.resolve(owner_fi, site):
                        frontier.append(callee)
        seen = set()
        while frontier:
            fi = frontier.pop()
            if id(fi) in seen:
                continue
            seen.add(id(fi))
            reach.setdefault(fi, set()).add(root.name)
            for site in fi.calls:
                for callee in index.resolve(fi, site):
                    if id(callee) not in seen:
                        frontier.append(callee)
    return reach


class SharedStateRule(Rule):
    name = "shared-state"
    description = (
        "an instance attr of a concurrent engine class mutated from "
        ">=2 thread roots outside a lock region needs a lock or a "
        "justified `# kwoklint: lockfree=` annotation"
    )

    def check_project(self, mods, root):
        index = build_index(mods)
        roots = discover_roots(index)
        reach = solve_reachability(index, roots)

        # collect mutation sites in target classes
        mutations: list = []
        for fi in index.funcs:
            if fi.cls not in TARGET_CLASSES or fi.name == "__init__":
                continue

            def on_mut(attr, line, locked, fi=fi):
                mutations.append(_Mutation(
                    fi.cls, attr, line, locked, fi.mod, fi
                ))

            _walk_mutations(fi.node.body, on_mut)
        # closure-root bodies owned by a target class (the tick loop)
        for rname, r in roots.items():
            for owner_fi, cnode in r.closures:
                if owner_fi.cls not in TARGET_CLASSES:
                    continue

                def on_mut(attr, line, locked, owner_fi=owner_fi,
                           rname=rname):
                    mutations.append(_Mutation(
                        owner_fi.cls, attr, line, locked,
                        owner_fi.mod, None, root=rname,
                    ))

                _walk_mutations(cnode.body, on_mut)

        # aggregate per (class, attr)
        by_attr: dict = {}
        for m in mutations:
            by_attr.setdefault((m.cls, m.attr), []).append(m)

        annotations = {m.rel: scan_lockfree(m) for m in mods}
        by_rel = {m.rel: m for m in mods}
        findings: list = []
        for (cls, attr), sites in sorted(by_attr.items()):
            site_roots = set()
            for m in sites:
                if m.root is not None:
                    site_roots.add(m.root)
                else:
                    site_roots |= reach.get(m.fi, set()) or {MAIN_ROOT}
            unlocked = [m for m in sites if not m.locked]
            if len(site_roots) < 2 or not unlocked:
                continue
            names = ", ".join(sorted(site_roots))
            for m in unlocked:
                ann = next(
                    (a for a in annotations.get(m.mod.rel, ())
                     if attr in a.attrs),
                    None,
                )
                if ann is not None:
                    ann.used.add(attr)
                    continue
                where = m.fi.qual if m.fi is not None \
                    else f"{m.mod.modname}.{cls} (worker closure)"
                findings.append(Finding(
                    m.mod.rel, m.line, self.name,
                    f"{cls}.{attr} is mutated from threads [{names}] "
                    f"and this store in {where} holds no lock: take a "
                    "declared lock or annotate the module with "
                    f"`# kwoklint: lockfree={attr} -- <why>`",
                ))

        # annotation hygiene: justification mandatory, liveness required
        for rel, anns in annotations.items():
            mod = by_rel[rel]
            for a in anns:
                if not a.justification:
                    findings.append(Finding(
                        mod.rel, a.line, self.name,
                        "lockfree annotation without a justification "
                        "(write `# kwoklint: lockfree=<attr> -- <why>`)",
                    ))
                stale = [x for x in a.attrs if x not in a.used]
                if stale and not any(x in a.used for x in a.attrs):
                    findings.append(Finding(
                        mod.rel, a.line, self.name,
                        "lockfree annotation matched no multi-thread "
                        f"unlocked mutation ({', '.join(stale)}): "
                        "stale — remove it or fix the attr list",
                    ))
        return findings
