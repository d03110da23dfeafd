"""Lock-discipline rules: the port's declared order table, out-of-order
nested acquisitions, blocking calls held under a lock, and dead locks.

The port's declared lock order (outermost first):

    stage_lock (lanes)  ->  _alloc_lock (engine)  ->  _gen_lock (engine)
        ->  leaves (pump group locks, _conns_lock, the resilience and
            checkpoint bookkeeping locks, "_lock" leaves)

A thread may only acquire DOWNWARD (strictly increasing level); two locks
at the same level have no declared order and must never nest; re-acquiring
the same lock is only legal for RLocks. Every lock that a supervised
worker can take is made by ``kwok_tpu_torch.locks.reclaimable()``, which
returns an RLock, so a ``reclaimable()`` construction counts as one here.
Analysis is interprocedural within the analyzed tree: a ``with lock:``
body's calls are resolved (self/bases, same-module functions, and
package-unique method names) and their transitive acquisitions and
blocking calls are charged to the holding block, with the call chain in
the finding message.

"Blocking" is a curated list of the calls that actually stall this
codebase — thread joins, queue/event waits, socket and native-pump I/O,
apiserver round-trips, CNI provider calls, pump construction — not a
general effect system. A blocking call that is *by design* guarded by its
own leaf lock (e.g. the pump group lock exists to serialize sends on one
connection group) carries a justified suppression at the call site, which
also stops the call from propagating through transitive analysis.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from kwok_tpu_torch.analysis.core import Finding, Module, Rule

# Declared order levels: smaller acquires first (outermost). Names not in
# the table are generic leaves at DEFAULT_LEVEL. Every name is one the
# port constructs (kwok_tpu_torch/...); the levels are the reference's.
LOCK_ORDER: dict[str, int] = {
    # engine/lanes.py ShardLane.stage_lock: a lane's drain and emit
    # workers serialize on it; taken outermost
    "stage_lock": 10,
    # engine/engine.py ClusterEngine: row allocation (shared by a lane
    # set's engines), then the generation/bookkeeping lock
    "_alloc_lock": 20,
    "_gen_lock": 30,
    # engine/engine.py _PumpGroup: one per connection group, serializing
    # sends on it (the `for p, lock in self._pumps` loop variable)
    "lock": 80,
    # edge/httpclient.py: the keep-alive connection pool
    "_conns_lock": 80,
    # Level-84 leaves: each guards one object's bookkeeping and nothing
    # is ever acquired under it; registry and degradation calls happen
    # after release. Above the generic leaves, so taking a "_lock" leaf
    # while holding one is an order violation, not an unordered pair.
    "_fault_lock": 84,  # resilience/faults.py FaultPlane tally + killer
    "_deg_lock": 84,    # resilience/policy.py Degradation reasons
    "_wd_lock": 84,     # resilience/watchdog.py restart stamps
    # engine/engine.py: startup-gate RESYNC marks and restore-session
    # swaps; taken by drain workers under their lane's stage_lock (a
    # legal 10 -> 84 descent) and by the device thread
    "_ckpt_lock": 84,
    "_adm_lock": 84,    # edge/mockserver.py admission band counters
    "_ae_lock": 84,     # resilience/antientropy.py scan cursor
    "_ha_lock": 84,     # resilience/ha.py elector role + tailed doc
    # engine/proclanes.py: the lane-handle swap, and the metrics bank's
    # retired-counter fold; spawning, joins and shm I/O run outside
    "_proc_lock": 84,
    "_mbank_lock": 84,
    # single-resource leaves: ippool, the telemetry registry, the Python
    # mock's store, a process lane's handle state
    "_lock": 85,
    "_apiserver_lock": 85,  # native/__init__.py: the mock binary build
    "_lists_lock": 85,      # native/__init__.py: a parse's lazy lists
}
DEFAULT_LEVEL = 85

_LOCK_NAME_RE = re.compile(r"(^|_)lock$")

# constructors that make a re-entrant lock: threading's, and the port's
# kwok_tpu_torch.locks.reclaimable() factory (an RLock it can reclaim)
_RLOCK_CTORS = ("RLock", "reclaimable")

# Receivers whose zero-arg .get() means a blocking queue pop (dict.get
# always takes an argument, so zero-arg get is queue-shaped anyway; the
# name filter keeps obviously non-queue receivers out).
_QUEUEISH = re.compile(r"(^|_)(q|eq|queue)$")

# Receiver-name type hints: kwoklint is repo-native, so it may know the
# engine's naming conventions — `e`/`engine`/`parent` hold ClusterEngines
# in lanes/federation, `lane` holds a ShardLane. Lets `e._emit(...)` under
# a lock resolve even though `_emit` is not package-unique.
RECEIVER_CLASS_HINTS: dict[str, str] = {
    "e": "ClusterEngine",
    "engine": "ClusterEngine",
    "parent": "ClusterEngine",
    "lane": "ShardLane",
}

# Method names too common to resolve by package-wide uniqueness (stdlib
# collisions would mis-bind them to unrelated classes).
_COMMON_NAMES = frozenset({
    "get", "put", "close", "stop", "start", "run", "send", "read", "write",
    "join", "wait", "render", "grow", "flush", "items", "keys", "values",
    "pop", "add", "discard", "observe", "inc", "set", "labels", "acquire",
    "release", "update", "append", "clear", "copy", "submit", "shutdown",
    "next", "count", "index", "sum", "min", "max", "list", "dict", "sort",
})

_BLOCKING_ATTRS = frozenset({
    "sendall", "send_ordered", "recv", "connect", "accept", "getresponse",
    "request", "patch_status", "patch_meta", "read_batch", "result",
})


def lock_level(name: str) -> int:
    return LOCK_ORDER.get(name, DEFAULT_LEVEL)


def _terminal(expr: ast.expr) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def is_lock_name(name: "str | None") -> bool:
    return bool(name) and bool(_LOCK_NAME_RE.search(name))


def blocking_reason(call: ast.Call) -> str | None:
    """Why this call may block, or None. Curated for this codebase."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id == "sleep":
            return "sleep()"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    recv = fn.value
    recv_name = _terminal(recv)
    if attr == "sleep" and recv_name == "time":
        return "time.sleep()"
    if attr == "join":
        # str.join / os.path.join are pure; thread/process joins block
        if isinstance(recv, ast.Constant):
            return None
        if recv_name in ("os", "posixpath", "ntpath", "path"):
            return None
        return f"{recv_name or '?'}.join()"
    if attr == "get":
        if any(kw.arg == "timeout" for kw in call.keywords):
            return f"{recv_name or '?'}.get(timeout=...)"
        if not call.args and not call.keywords and recv_name \
                and _QUEUEISH.search(recv_name):
            return f"{recv_name}.get()"
        return None
    if attr == "wait":
        return f"{recv_name or '?'}.wait()"
    if attr == "send":
        return f"{recv_name or '?'}.send() (socket/pump I/O)"
    if attr in _BLOCKING_ATTRS:
        return f"{recv_name or '?'}.{attr}()"
    if attr == "Pump":
        return "native pump construction (TCP connects)"
    if attr in ("setup", "remove") and recv_name == "cni":
        return f"cni.{attr}() (netns/network I/O)"
    return None


@dataclasses.dataclass
class _CallSite:
    form: str  # "self" | "bare" | "attr"
    target: str
    line: int
    recv: "str | None" = None  # terminal receiver name (attr form)


@dataclasses.dataclass
class _LockBlock:
    name: str
    line: int
    module: str
    inner_locks: list  # (name, line, module)
    calls: list  # _CallSite
    blocking: list  # (reason, line)


class _FuncInfo:
    def __init__(self, mod: Module, cls: "str | None", node) -> None:
        self.mod = mod
        self.cls = cls
        self.name = node.name
        self.node = node
        self.qual = f"{mod.modname}.{cls + '.' if cls else ''}{node.name}"
        self.blocks: list[_LockBlock] = []   # with-lock blocks in this fn
        self.locks: list[tuple] = []         # (name, line) acquired anywhere
        self.calls: list[_CallSite] = []     # calls anywhere in fn
        self.blocking: list[tuple] = []      # (reason, line) anywhere
        # transitive closures (filled by _Index.solve)
        self.t_locks: dict = {}              # name -> chain str
        self.t_blocking: dict = {}           # reason -> chain str


def _classify_call(call: ast.Call) -> "_CallSite | None":
    fn = call.func
    if isinstance(fn, ast.Name):
        return _CallSite("bare", fn.id, call.lineno)
    if isinstance(fn, ast.Attribute):
        recv = fn.value
        if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
            return _CallSite("self", fn.attr, call.lineno)
        return _CallSite("attr", fn.attr, call.lineno, _terminal(recv))
    return None


def _scan_function(fi: _FuncInfo) -> None:
    """Populate a _FuncInfo by walking its body with a with-lock stack.
    Nested function/class definitions are separate scopes and skipped."""
    mod = fi.mod

    def suppressed(line: int, rule: str) -> bool:
        s = mod.consume_suppression(line, rule)
        if s is not None:
            mod.scan_suppressed += 1
            return True
        return False

    def on_lock(name: str, line: int, stack: list) -> None:
        fi.locks.append((name, line))
        for blk in stack:
            blk.inner_locks.append((name, line, mod.modname))

    def on_call(call: ast.Call, stack: list) -> None:
        reason = blocking_reason(call)
        if reason is not None and not suppressed(
            call.lineno, "blocking-under-lock"
        ):
            fi.blocking.append((reason, call.lineno))
            for blk in stack:
                blk.blocking.append((reason, call.lineno))
        site = _classify_call(call)
        if site is not None:
            fi.calls.append(site)
            for blk in stack:
                blk.calls.append(site)

    def walk(node: ast.AST, stack: list) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.With):
            new_stack = list(stack)
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Call):
                        on_call(sub, new_stack)
                name = _terminal(item.context_expr)
                if is_lock_name(name):
                    on_lock(name, node.lineno, new_stack)
                    blk = _LockBlock(
                        name, node.lineno, mod.modname, [], [], []
                    )
                    fi.blocks.append(blk)
                    new_stack = new_stack + [blk]
            for stmt in node.body:
                walk(stmt, new_stack)
            return
        if isinstance(node, ast.If):
            # the `if lock.acquire(blocking=False): ... finally release`
            # probe pattern (engine._PumpGroup): the if-body runs under
            # the lock
            test = node.test
            if (
                isinstance(test, ast.Call)
                and isinstance(test.func, ast.Attribute)
                and test.func.attr == "acquire"
                and is_lock_name(_terminal(test.func.value))
            ):
                name = _terminal(test.func.value)
                on_lock(name, node.lineno, stack)
                blk = _LockBlock(name, node.lineno, mod.modname, [], [], [])
                fi.blocks.append(blk)
                for stmt in node.body:
                    walk(stmt, stack + [blk])
                for stmt in node.orelse:
                    walk(stmt, stack)
                return
        if isinstance(node, ast.Call):
            on_call(node, stack)
            for child in ast.iter_child_nodes(node):
                walk(child, stack)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, stack)

    for stmt in fi.node.body:
        walk(stmt, [])


class _Index:
    """Package-wide function index + call resolution + transitive solve."""

    def __init__(self, mods: list[Module]) -> None:
        self.funcs: list[_FuncInfo] = []
        self.by_module: dict[str, dict[str, _FuncInfo]] = {}
        self.by_class: dict[str, dict[str, _FuncInfo]] = {}
        self.bases: dict[str, list[str]] = {}
        self.by_name: dict[str, list[_FuncInfo]] = {}
        self.rlocks: set[tuple] = set()  # (module, name)
        for mod in mods:
            self._index_module(mod)
        for fi in self.funcs:
            _scan_function(fi)
        self._solve()

    def _index_module(self, mod: Module) -> None:
        mod_funcs = self.by_module.setdefault(mod.modname, {})

        def add(fi: _FuncInfo) -> None:
            self.funcs.append(fi)
            self.by_name.setdefault(fi.name, []).append(fi)

        for node in mod.tree.body:
            if isinstance(node, ast.FunctionDef):
                fi = _FuncInfo(mod, None, node)
                mod_funcs[node.name] = fi
                add(fi)
            elif isinstance(node, ast.ClassDef):
                self.bases[node.name] = [
                    b.id for b in node.bases if isinstance(b, ast.Name)
                ] + [
                    b.attr for b in node.bases if isinstance(b, ast.Attribute)
                ]
                methods = self.by_class.setdefault(node.name, {})
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        fi = _FuncInfo(mod, node.name, sub)
                        methods[sub.name] = fi
                        add(fi)
        # RLock creations: with-reentry of these is legal
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _terminal(node.value.func) in _RLOCK_CTORS
            ):
                for tgt in node.targets:
                    name = _terminal(tgt)
                    if name:
                        self.rlocks.add((mod.modname, name))

    def is_rlock(self, name: str) -> bool:
        return any(n == name for _m, n in self.rlocks)

    def _resolve_in_class(self, cls: "str | None", target: str):
        seen = set()
        while cls is not None and cls not in seen:
            seen.add(cls)
            hit = self.by_class.get(cls, {}).get(target)
            if hit is not None:
                return hit
            parents = self.bases.get(cls, [])
            cls = parents[0] if parents else None
        return None

    def resolve(self, fi: _FuncInfo, site: _CallSite) -> list[_FuncInfo]:
        if site.form == "self":
            hit = self._resolve_in_class(fi.cls, site.target)
            if hit is not None:
                return [hit]
            # fall through to unique-global
        elif site.form == "attr" and site.recv in RECEIVER_CLASS_HINTS:
            hit = self._resolve_in_class(
                RECEIVER_CLASS_HINTS[site.recv], site.target
            )
            if hit is not None:
                return [hit]
        elif site.form == "bare":
            hit = self.by_module.get(fi.mod.modname, {}).get(site.target)
            return [hit] if hit is not None else []
        if site.target in _COMMON_NAMES:
            return []
        cands = self.by_name.get(site.target, [])
        return cands if len(cands) == 1 else []

    def _solve(self) -> None:
        """Fixpoint over the call graph: fold callees' locks and blocking
        calls into each caller, keeping one representative chain."""
        changed = True
        rounds = 0
        while changed and rounds < 20:
            changed = False
            rounds += 1
            for fi in self.funcs:
                want_locks = {name: "" for name, _ in fi.locks}
                want_blk = {r: "" for r, _ in fi.blocking}
                for site in fi.calls:
                    for callee in self.resolve(fi, site):
                        if callee is fi:
                            continue
                        step = callee.qual
                        for name, chain in list(callee.t_locks.items()):
                            want_locks.setdefault(
                                name, f"{step} -> {chain}" if chain else step
                            )
                        for r, chain in list(callee.t_blocking.items()):
                            want_blk.setdefault(
                                r, f"{step} -> {chain}" if chain else step
                            )
                if want_locks.keys() != fi.t_locks.keys():
                    fi.t_locks = want_locks
                    changed = True
                if want_blk.keys() != fi.t_blocking.keys():
                    fi.t_blocking = want_blk
                    changed = True


# One index serves both lock rules in a run: building it (scan + call-
# graph fixpoint) is the expensive half of the analysis.
_index_cache: "tuple[tuple, _Index] | None" = None


def build_index(mods: list[Module]) -> _Index:
    global _index_cache
    key = tuple(id(m) for m in mods)
    if _index_cache is not None and _index_cache[0] == key:
        return _index_cache[1]
    idx = _Index(mods)
    _index_cache = (key, idx)
    return idx


def _order_violation(index: _Index, held: str, held_mod: str,
                     inner: str, inner_mod: str) -> "str | None":
    lh, li = lock_level(held), lock_level(inner)
    if inner == held:
        if inner_mod == held_mod and index.is_rlock(inner):
            return None  # re-entrant acquisition of the same RLock
        return (
            f"re-acquires {inner} while already holding it "
            "(self-deadlock unless RLock)"
        )
    if li < lh:
        return (
            f"acquires {inner} (level {li}) while holding {held} "
            f"(level {lh}): out of declared lock order"
        )
    if li == lh:
        return (
            f"acquires {inner} (level {li}) while holding {held} "
            f"(level {lh}): same-level locks have no declared order"
        )
    return None


class LockOrderRule(Rule):
    name = "lock-order"
    description = (
        "nested lock acquisitions must follow the declared order "
        "stage_lock -> _alloc_lock -> _gen_lock -> leaves"
    )

    def check_project(self, mods, root):
        index = build_index(mods)
        seen = set()
        for fi in index.funcs:
            for blk in fi.blocks:
                # direct syntactic nesting: report at the INNER
                # acquisition, where the out-of-order take happens
                for name, line, imod in blk.inner_locks:
                    msg = _order_violation(
                        index, blk.name, blk.module, name, imod
                    )
                    if msg:
                        key = (fi.mod.rel, line, msg)
                        if key not in seen:
                            seen.add(key)
                            yield Finding(
                                fi.mod.rel, line, self.name,
                                f"in {fi.qual}: {msg}",
                            )
                # transitive via resolved calls
                for site in blk.calls:
                    for callee in index.resolve(fi, site):
                        for name, chain in callee.t_locks.items():
                            msg = _order_violation(
                                index, blk.name, blk.module,
                                name, callee.mod.modname,
                            )
                            if msg:
                                path = (
                                    f"{callee.qual} -> {chain}" if chain
                                    else callee.qual
                                )
                                msg2 = (
                                    f"in {fi.qual}: {msg} (via {path})"
                                )
                                key = (fi.mod.rel, blk.line, msg2)
                                if key not in seen:
                                    seen.add(key)
                                    yield Finding(
                                        fi.mod.rel, blk.line, self.name, msg2
                                    )


def _paired_cond_wait(reason: str, held: str) -> bool:
    """A ``<stem>_cond.wait()`` under ``<stem>_lock`` is the
    threading.Condition contract working as designed: wait() atomically
    RELEASES the lock that backs the condition while sleeping, so it is
    the one blocking shape that cannot convoy the lock it is charged
    against. The pairing is by naming convention and exact: the same
    wait under any OTHER lock (a shard lock, say) still convoys that
    lock and stays a finding."""
    suffix = "_cond.wait()"
    if not reason.endswith(suffix):
        return False
    return held == reason[: -len(suffix)] + "_lock"


class BlockingUnderLockRule(Rule):
    name = "blocking-under-lock"
    description = (
        "no thread joins, queue/event waits, socket/pump I/O, apiserver "
        "round-trips, or CNI provider calls while holding a lock"
    )

    def check_project(self, mods, root):
        index = build_index(mods)
        seen = set()
        for fi in index.funcs:
            for blk in fi.blocks:
                for reason, line in blk.blocking:
                    if _paired_cond_wait(reason, blk.name):
                        continue
                    msg = (
                        f"in {fi.qual}: {reason} while holding {blk.name}"
                    )
                    key = (fi.mod.rel, line, msg)
                    if key not in seen:
                        seen.add(key)
                        yield Finding(fi.mod.rel, line, self.name, msg)
                for site in blk.calls:
                    for callee in index.resolve(fi, site):
                        for reason, chain in callee.t_blocking.items():
                            if _paired_cond_wait(reason, blk.name):
                                continue
                            path = (
                                f"{callee.qual} -> {chain}" if chain
                                else callee.qual
                            )
                            msg = (
                                f"in {fi.qual}: {reason} while holding "
                                f"{blk.name} (via {path})"
                            )
                            key = (fi.mod.rel, blk.line, msg)
                            if key not in seen:
                                seen.add(key)
                                yield Finding(
                                    fi.mod.rel, blk.line, self.name, msg
                                )


class UnusedLockRule(Rule):
    name = "unused-lock"
    description = "a threading.Lock/RLock created but acquired on no path"

    def check_project(self, mods, root):
        created: list[tuple] = []  # (mod, name, line)
        used: set[str] = set()
        for mod in mods:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    ctor = _terminal(node.value.func)
                    if ctor in ("Lock", "allocate_lock") + _RLOCK_CTORS:
                        for tgt in node.targets:
                            name = _terminal(tgt)
                            if name:
                                created.append((mod, name, node.lineno))
                elif isinstance(node, ast.With):
                    for item in node.items:
                        name = _terminal(item.context_expr)
                        if is_lock_name(name):
                            used.add(name)
                elif isinstance(node, ast.Call) and _terminal(
                    node.func
                ) == "Condition":
                    # a lock backing a Condition is acquired through it
                    # (the port's reclaimable queue mutex)
                    for arg in node.args:
                        name = _terminal(arg)
                        if name:
                            used.add(name)
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    if node.func.attr in ("acquire", "release"):
                        name = _terminal(node.func.value)
                        if is_lock_name(name):
                            used.add(name)
                elif isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load
                ):
                    # aliased/shared elsewhere (`e._alloc_lock =
                    # parent._alloc_lock`, passing a lock to Condition):
                    # the alias site counts as a use of the name
                    if is_lock_name(node.attr):
                        used.add(node.attr)
        for mod, name, line in created:
            if name not in used:
                yield Finding(
                    mod.rel, line, self.name,
                    f"lock {name} is created but never acquired on any "
                    "path in the analyzed tree",
                )
