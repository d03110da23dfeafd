"""Spawn-only rule: multiprocessing without an explicit spawn context.

The engine is thread-rich long before any lane process exists (watch
threads, the patch executor, lane workers, the profiling sampler, pump
connection threads). ``fork`` duplicates the parent at a random
instant: every mutex another thread happens to hold — allocator locks
inside glibc, the GIL's own machinery, `logging`'s module lock, our
stage locks — is cloned LOCKED into a child that has no thread to ever
release it. That is the classic fork-after-threads deadlock, and on
Linux ``multiprocessing``'s default start method is ``fork``, so any
bare ``multiprocessing.Process(...)`` / ``mp.Queue()`` is a latent
deadlock that only fires under load.

The rule therefore flags every process-creating or IPC-creating call
made on the ``multiprocessing`` module itself (however imported), plus
``get_context()`` calls that do not pin the literal ``"spawn"`` —
the compliant shape is::

    ctx = multiprocessing.get_context("spawn")
    ctx.Process(...); ctx.Pipe(); ...

Calls on a context OBJECT are not flagged (the context was vetted where
it was created). ``shared_memory`` / ``resource_tracker`` /
``connection`` attribute access is fine — those create no process and
inherit no fork semantics.
"""

from __future__ import annotations

import ast

from kwok_tpu_torch.analysis.core import Finding, Module, Rule

# multiprocessing-module attributes whose call creates a process or an
# IPC primitive bound to the ambient (platform-default: fork) context
_CTX_FACTORIES = frozenset({
    "Process", "Pool", "Queue", "SimpleQueue", "JoinableQueue", "Pipe",
    "Manager", "Event", "Lock", "RLock", "Semaphore", "BoundedSemaphore",
    "Condition", "Barrier", "Value", "Array",
})


class SpawnOnlyRule(Rule):
    name = "spawn-only"
    description = (
        "multiprocessing must go through get_context(\"spawn\"): the "
        "engine is thread-rich, and fork-after-threads clones held "
        "locks into the child (deadlock)"
    )

    def check_module(self, mod: Module):
        # names bound to the multiprocessing module in this file
        mp_names: set[str] = set()
        # names bound directly to context factories via from-imports
        direct: dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "multiprocessing":
                        mp_names.add(a.asname or "multiprocessing")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "multiprocessing":
                    for a in node.names:
                        if a.name in _CTX_FACTORIES or a.name == "get_context":
                            direct[a.asname or a.name] = a.name
        if not mp_names and not direct:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and isinstance(
                fn.value, ast.Name
            ) and fn.value.id in mp_names:
                if fn.attr in _CTX_FACTORIES:
                    yield Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=(
                            f"{fn.value.id}.{fn.attr}(...) uses the "
                            "platform-default start method (fork on "
                            "Linux): fork-after-threads clones held "
                            "locks into the child — build it from "
                            'get_context("spawn") instead'
                        ),
                    )
                    continue
                if fn.attr == "get_context":
                    yield from self._check_get_context(mod, node)
            elif isinstance(fn, ast.Name) and fn.id in direct:
                target = direct[fn.id]
                if target == "get_context":
                    yield from self._check_get_context(mod, node)
                else:
                    yield Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        message=(
                            f"bare {target}(...) imported from "
                            "multiprocessing uses the platform-default "
                            "start method (fork on Linux) — build it "
                            'from get_context("spawn") instead'
                        ),
                    )

    def _check_get_context(self, mod: Module, node: ast.Call):
        ok = (
            len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "spawn"
        )
        if not ok:
            yield Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                message=(
                    "get_context() without the literal \"spawn\": the "
                    "ambient/fork start method clones held locks into "
                    "the child (fork-after-threads deadlock under the "
                    "engine's thread population)"
                ),
            )
