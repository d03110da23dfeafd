"""Runtime lock-order witness: instrumented Lock/RLock for tests.

The static rules prove what the source *says*; this proves what the
threads *do*. While installed, every lock created through
``threading.Lock``/``threading.RLock`` — and so every RLock that
``kwok_tpu_torch.locks.reclaimable()`` makes — is wrapped: each
acquisition records which witnessed locks the thread already holds,
building a directed acquisition-order graph whose nodes are lock
*creation sites* (``module:varname``, inferred from the source line of
the constructor call, or of the ``reclaimable()`` call for the port's
factory). Two failure modes are detected the moment their edge appears,
each reported with BOTH acquisition stacks:

- **order-graph cycle** — lock A taken while holding B on one thread and
  B taken while holding A on another is a deadlock waiting for the right
  interleaving, even if the run never hit it;
- **declared-order violation** — an edge that contradicts the port's
  table in ``analysis/locks.py`` (stage_lock -> _alloc_lock -> _gen_lock
  -> leaves), checked only for locks the table names, so stdlib
  internals (queue mutexes, futures) never false-positive.

Usable directly as::

    with witness() as w:
        ...exercise engine...
    w.assert_clean()  # AssertionError with both stacks

or over a pytest run with ``KWOK_TPU_TORCH_LOCK_WITNESS=1 python -m
pytest -p tests.torch_witness tests/test_torch_lanes.py``. Only locks
created *while installed* are witnessed, so module-import locks stay out
of the graph.
"""

from __future__ import annotations

import linecache
import re
import sys
import threading
import traceback

from kwok_tpu_torch.analysis.locks import LOCK_ORDER
from kwok_tpu_torch.locks import reclaimable

_NAME_RE = re.compile(
    r"([A-Za-z_]\w*)\s*=\s*(?:\w+\s*\.\s*)*(?:R?Lock|reclaimable)\("
)

# the port's lock factory: a lock it makes is named by its caller's line
_FACTORY_CODE = reclaimable.__code__


def _creation_site() -> tuple:
    """(module_basename, varname|None, file:line) of the frame that called
    the patched constructor."""
    f = sys._getframe(2)
    while f is not None and (
        f.f_code.co_filename == __file__ or f.f_code is _FACTORY_CODE
    ):
        f = f.f_back
    if f is None:
        return ("?", None, "?")
    fname = f.f_code.co_filename
    lineno = f.f_lineno
    mod = fname.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    line = linecache.getline(fname, lineno)
    m = _NAME_RE.search(line)
    return (mod, m.group(1) if m else None, f"{fname}:{lineno}")


def _stack(skip: int = 2):
    return traceback.StackSummary.extract(
        traceback.walk_stack(sys._getframe(skip)), limit=14,
        lookup_lines=False,
    )


class Violation:
    def __init__(self, kind: str, message: str, stacks: list) -> None:
        self.kind = kind
        self.message = message
        self.stacks = stacks  # [(title, StackSummary), ...]

    def format(self) -> str:
        out = [f"[{self.kind}] {self.message}"]
        for title, stack in self.stacks:
            out.append(f"--- {title} ---")
            out.extend(s.rstrip() for s in stack.format())
        return "\n".join(out)


class _Held(threading.local):
    def __init__(self):
        self.stack = []  # [(wrapper, node_key, StackSummary), ...]


class LockWitness:
    """Acquisition-edge recorder + cycle/declared-order checker."""

    _installed: "LockWitness | None" = None

    def __init__(self) -> None:
        self._graph_lock = threading.Lock()  # guards edges/violations
        self._held = _Held()
        # (a_key, b_key) -> (thread, stack_of_a, stack_of_b)
        self.edges: dict = {}
        self.succ: dict = {}  # a_key -> set of b_keys
        self.violations: list[Violation] = []

    # ------------------------------------------------------------ recording

    def note_acquired(self, wrapper: "_WitnessLockBase") -> None:
        held = self._held.stack
        if any(w is wrapper for w, _k, _s in held):
            # re-entrant acquisition of the same instance (RLock, or a
            # Condition re-acquire): not an ordering edge
            held.append((wrapper, wrapper.key, None))
            return
        stack = _stack(3)
        for _w, held_key, held_stack in list(held):
            if held_stack is None:
                continue  # re-entrant duplicate entry
            self._add_edge(held_key, wrapper.key, held_stack, stack)
        held.append((wrapper, wrapper.key, stack))

    def note_released(self, wrapper: "_WitnessLockBase") -> None:
        held = self._held.stack
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is wrapper:
                del held[i]
                return

    def drop_all(self, wrapper: "_WitnessLockBase") -> int:
        """Condition._release_save: drop every recursion level; returns
        how many were held so _acquire_restore can re-book them."""
        held = self._held.stack
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is wrapper:
                del held[i]
                n += 1
        return n

    # ------------------------------------------------------------- checking

    def _add_edge(self, a: tuple, b: tuple, stack_a, stack_b) -> None:
        with self._graph_lock:
            if (a, b) in self.edges:
                return
            self.edges[(a, b)] = (
                threading.current_thread().name, stack_a, stack_b
            )
            if a == b:
                # two DISTINCT instances sharing one creation site (per-
                # lane stage_locks, pump group locks) nested: instances
                # of one lock class have no defined order, so the
                # opposite interleaving on another thread is an ABBA
                # deadlock. Report it as its own diagnostic — a self-edge
                # must never enter the cycle graph, where every later
                # path through the node would read as a spurious cycle.
                self.violations.append(Violation(
                    "same-site-nesting",
                    f"two distinct locks created at {self._node_str(a)} "
                    "nested on thread "
                    f"{threading.current_thread().name}: instances of one "
                    "lock class have no defined order (ABBA hazard)",
                    [
                        (f"holding first {self._node_str(a)}, acquired at",
                         stack_a),
                        (f"acquiring second {self._node_str(b)} at",
                         stack_b),
                    ],
                ))
                return
            self.succ.setdefault(a, set()).add(b)
            self._check_declared(a, b, stack_a, stack_b)
            self._check_cycle(a, b, stack_a, stack_b)

    @staticmethod
    def _node_str(key: tuple) -> str:
        mod, name, site = key
        return f"{mod}.{name or '<anon>'} ({site})"

    def _check_declared(self, a: tuple, b: tuple, stack_a, stack_b) -> None:
        name_a, name_b = a[1], b[1]
        if name_a not in LOCK_ORDER or name_b not in LOCK_ORDER:
            return
        la, lb = LOCK_ORDER[name_a], LOCK_ORDER[name_b]
        if lb < la or (lb == la and a != b):
            self.violations.append(Violation(
                "declared-order",
                f"{self._node_str(b)} (level {lb}) acquired while holding "
                f"{self._node_str(a)} (level {la}) on thread "
                f"{threading.current_thread().name}",
                [
                    (f"holding {self._node_str(a)}, acquired at", stack_a),
                    (f"acquiring {self._node_str(b)} at", stack_b),
                ],
            ))

    def _check_cycle(self, a: tuple, b: tuple, stack_a, stack_b) -> None:
        """The new edge a->b closes a cycle iff a is reachable from b."""
        seen = set()
        frontier = [b]
        path = {b: None}
        while frontier:
            n = frontier.pop()
            if n == a:
                # rebuild the b..a path for the message
                hops = []
                cur = a
                while cur is not None:
                    hops.append(cur)
                    cur = path.get(cur)
                cycle = " -> ".join(
                    self._node_str(k) for k in reversed(hops)
                ) + f" -> {self._node_str(b)}"
                stacks = [
                    (f"edge {self._node_str(a)} -> {self._node_str(b)}: "
                     "holder stack", stack_a),
                    ("acquirer stack", stack_b),
                ]
                rev = self.edges.get((b, a))
                if rev is not None:
                    thread, sa, sb = rev
                    stacks.append((
                        f"opposite edge {self._node_str(b)} -> "
                        f"{self._node_str(a)} (thread {thread}): "
                        "holder stack", sa,
                    ))
                    stacks.append(("opposite acquirer stack", sb))
                self.violations.append(Violation(
                    "order-cycle",
                    "lock acquisition graph has a cycle: " + cycle,
                    stacks,
                ))
                return
            if n in seen:
                continue
            seen.add(n)
            for m in self.succ.get(n, ()):
                if m not in path:
                    path[m] = n
                frontier.append(m)

    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                "lock-order witness recorded "
                f"{len(self.violations)} violation(s):\n\n"
                + "\n\n".join(v.format() for v in self.violations)
            )

    # ---------------------------------------------------------- installation

    @classmethod
    def install(cls) -> "LockWitness":
        if cls._installed is not None:
            return cls._installed
        w = cls()
        cls._installed = w
        cls._orig_lock = threading.Lock
        cls._orig_rlock = threading.RLock

        def make_lock():
            return _WitnessLock(cls._orig_lock(), w, _creation_site())

        def make_rlock():
            return _WitnessRLock(cls._orig_rlock(), w, _creation_site())

        threading.Lock = make_lock
        threading.RLock = make_rlock
        return w

    @classmethod
    def uninstall(cls) -> None:
        if cls._installed is None:
            return
        threading.Lock = cls._orig_lock
        threading.RLock = cls._orig_rlock
        cls._installed = None


class _WitnessLockBase:
    def __init__(self, inner, witness: LockWitness, site: tuple) -> None:
        self._inner = inner
        self._witness = witness
        self.key = site  # (module, varname, file:line)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.note_acquired(self)
        return ok

    def release(self) -> None:
        self._witness.note_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name):
        # anything we don't instrument delegates to the real lock
        # (_at_fork_reinit, acquire_lock aliases, ...): stdlib modules
        # touch these at import time (concurrent.futures registers
        # _at_fork_reinit with os.register_at_fork)
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} as {self.key}>"


class _WitnessLock(_WitnessLockBase):
    pass


class _WitnessRLock(_WitnessLockBase):
    # threading.Condition protocol for RLocks
    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        n = self._witness.drop_all(self)
        return (self._inner._release_save(), n)

    def _acquire_restore(self, state):
        inner_state, n = state
        self._inner._acquire_restore(inner_state)
        for _ in range(max(1, n)):
            self._witness._held.stack.append((self, self.key, None))


def witness():
    """Context manager installing a witness (test helper). Joining an
    already-installed witness (the test plugin's) is allowed; only
    the installer uninstalls on exit."""

    class _Ctx:
        def __enter__(self):
            self._owner = LockWitness._installed is None
            self.w = LockWitness.install()
            return self.w

        def __exit__(self, *exc):
            if self._owner:
                LockWitness.uninstall()

    return _Ctx()
