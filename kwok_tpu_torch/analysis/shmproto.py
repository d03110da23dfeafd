"""Shm/IPC protocol rule: the seqlock, slot, and ring state machines.

The cross-process substrate (``engine/shm.py``) is lock-free by design —
its correctness is pure store ORDER. Each protocol class declares its
header slots as class-level int constants, and this rule recognizes the
protocol from those names (so fixtures and future twins are checked by
shape, not by file path):

* ``SEQ`` + ``LEN``  -> a **seqlock slab** (MetricsBank). Any method
  that stores into the payload must stamp ``hdr[SEQ]`` BEFORE the first
  payload/length store (readers back off on odd) and stamp it again
  AFTER the last one (even: consistent). ``torn_*`` fault twins are the
  deliberate exception: they must still open-stamp, and must NOT close —
  a torn writer that restamps even would hide exactly the crash the
  fault injects.
* ``STATE`` + ``LEN`` -> a **crash-replay slot** (InflightSlot). A
  payload-writing method must order ``state=0`` (disarm-first) ->
  payload -> ``len`` -> ``state=1``; a re-arm torn mid-copy then parks
  as "empty" instead of presenting state=1 over mixed bytes. ``torn_*``
  twins need only the disarm prefix.
* ``W`` + ``R``       -> an **SPSC byte ring** (RawRing). The producer
  must copy the payload BEFORE publishing the ``hdr[W]`` cursor, and —
  cross-file — any function that both writes the ring and ships the
  descriptor must call ``try_write`` before the send (the pipe is the
  second fence; a descriptor sent first could be consumed against
  unpublished bytes).

Local aliases are tracked (``hdr = self.arena.hdr`` / ``payload =
self.arena.payload`` is the idiom throughout shm.py), so stores through
the alias and through the full attribute chain both count.

**Single-writer-per-bank** rides the same rule: every store through a
``BANK_*`` field index anywhere in the tree must come from a declared
writer (``BANK_WRITERS``). The bank rows are the one shm plane with no
stamp protocol at all — their entire safety argument IS the writer set
(children own their row; the parent only zeroes the heartbeat on
respawn), so an undeclared writer is a protocol break even if the code
"works" today.
"""

from __future__ import annotations

import ast

from kwok_tpu_torch.analysis.core import Finding, Module, Rule

# Declared StatusBank writers: outermost function name (optionally
# Class.method) -> allowed BANK_* fields; empty set = any field. Nested
# closures inherit their outermost def's entry (lane_proc_main's
# status_loop). Reads are always free.
BANK_WRITERS = {
    # the lane child owns its whole row (pid/heartbeat at entry, the
    # status_loop closure for everything else)
    "lane_proc_main": frozenset(),
    # the parent's respawn zeroes the dead incarnation's heartbeat so
    # the stall detector re-arms against the NEW child's first beat
    "ProcLaneSet._do_respawn": frozenset({"BANK_ALIVE_NS"}),
}

_PAYLOAD_NAMES = frozenset({"payload"})
_HDR_NAMES = frozenset({"hdr"})


def _attr_chain(expr) -> "list[str] | None":
    """Attribute/Name chain as names, outermost first: self.arena.hdr ->
    ['self', 'arena', 'hdr']."""
    parts: list = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        parts.reverse()
        return parts
    return None


class _ProtoClass:
    """A protocol class: which slots it declares and its kind."""

    def __init__(self, node: ast.ClassDef) -> None:
        self.node = node
        self.slots: dict = {}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign):
                names = [
                    t.id for t in stmt.targets if isinstance(t, ast.Name)
                ]
                if (
                    isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, int)
                ):
                    for nm in names:
                        self.slots[nm] = stmt.value.value
                elif isinstance(stmt.value, ast.Tuple) and all(
                    isinstance(e, ast.Constant) for e in stmt.value.elts
                ):
                    # the `STATE, LEN = 0, 1` form
                    if len(names) == 0 and all(
                        isinstance(t, ast.Tuple) for t in stmt.targets
                    ):
                        for tup in stmt.targets:
                            for el, val in zip(tup.elts, stmt.value.elts):
                                if isinstance(el, ast.Name):
                                    self.slots[el.id] = val.value

    @property
    def kind(self) -> "str | None":
        s = self.slots
        if "SEQ" in s and "LEN" in s:
            return "seqlock"
        if "STATE" in s and "LEN" in s:
            return "slot"
        if "W" in s and "R" in s:
            return "ring"
        return None


class _Store:
    __slots__ = ("line", "slot", "value")

    def __init__(self, line, slot, value=None):
        self.line = line
        self.slot = slot    # 'payload' | a header slot name (SEQ/LEN/...)
        self.value = value  # constant stored, when it is one


def _method_stores(fn: ast.FunctionDef, slot_names) -> list:
    """Ordered header/payload stores in one method, through aliases or
    full chains. Nested defs are skipped (separate protocol actors)."""
    aliases: dict = {}   # local name -> 'hdr' | 'payload'
    stores: list = []

    def classify_base(expr) -> "str | None":
        chain = _attr_chain(expr)
        if chain is None:
            return None
        if len(chain) == 1:
            return aliases.get(chain[0])
        if chain[-1] in _HDR_NAMES:
            return "hdr"
        if chain[-1] in _PAYLOAD_NAMES:
            return "payload"
        return None

    def slot_of(index_expr) -> "str | None":
        chain = _attr_chain(index_expr)
        if chain is None:
            return None
        name = chain[-1]
        return name if name in slot_names else None

    def walk(node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Assign):
            if len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name
            ):
                base = classify_base(node.value)
                if base is not None:
                    aliases[node.targets[0].id] = base
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    base = classify_base(tgt.value)
                    if base == "payload":
                        stores.append(_Store(node.lineno, "payload"))
                    elif base == "hdr":
                        slot = slot_of(tgt.slice)
                        if slot is not None:
                            val = (
                                node.value.value
                                if isinstance(node.value, ast.Constant)
                                else None
                            )
                            stores.append(
                                _Store(node.lineno, slot, val)
                            )
        for child in ast.iter_child_nodes(node):
            walk(child)

    for stmt in fn.body:
        walk(stmt)
    return stores


class ShmProtocolRule(Rule):
    name = "shm-protocol"
    description = (
        "seqlock/slot/ring store-order state machines in the shm "
        "substrate, plus the single-writer-per-bank ownership table"
    )

    def check_module(self, mod: Module):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                pc = _ProtoClass(node)
                kind = pc.kind
                if kind is None:
                    continue
                for stmt in node.body:
                    if isinstance(stmt, ast.FunctionDef):
                        yield from self._check_method(mod, pc, kind, stmt)
        yield from self._check_bank_writers(mod)
        yield from self._check_descriptor_order(mod)

    # ------------------------------------------------- per-method protocol

    def _check_method(self, mod, pc, kind, fn):
        stores = _method_stores(fn, pc.slots)
        payload = [s for s in stores if s.slot == "payload"]
        if not payload:
            return  # reads, resets, closes: no payload, no protocol step
        torn = fn.name.startswith("torn_")
        first_p = payload[0].line
        last_pl = max(
            s.line for s in stores if s.slot in ("payload", "LEN")
        )
        where = f"{pc.node.name}.{fn.name}"

        if kind == "seqlock":
            opens = [
                s for s in stores if s.slot == "SEQ" and s.line < first_p
            ]
            closes = [
                s for s in stores if s.slot == "SEQ" and s.line > last_pl
            ]
            if not opens:
                yield Finding(
                    mod.rel, first_p, self.name,
                    f"{where}: payload store without an odd seq stamp "
                    "before it — readers can consume a half-written "
                    "slab (stamp hdr[SEQ] first)",
                )
            if torn:
                if closes:
                    yield Finding(
                        mod.rel, closes[0].line, self.name,
                        f"{where}: a torn_* fault twin must NOT restamp "
                        "seq after the partial copy — the even stamp "
                        "would hide exactly the crash it injects",
                    )
            elif not closes:
                yield Finding(
                    mod.rel, last_pl, self.name,
                    f"{where}: payload/len stores are never closed with "
                    "an even seq stamp — the slab stays 'mid-write' "
                    "forever and every reader backs off",
                )
        elif kind == "slot":
            disarms = [
                s for s in stores
                if s.slot == "STATE" and s.line < first_p and s.value == 0
            ]
            if not disarms:
                yield Finding(
                    mod.rel, first_p, self.name,
                    f"{where}: payload store without state=0 disarm "
                    "before it — a re-arm torn mid-copy presents "
                    "state=1 over a mix of old and new bytes",
                )
            early_arm = [
                s for s in stores
                if s.slot == "STATE" and s.line < first_p and s.value == 1
            ]
            if early_arm:
                yield Finding(
                    mod.rel, early_arm[0].line, self.name,
                    f"{where}: state=1 before the payload copy — the "
                    "reader is told the slot is armed while the bytes "
                    "are still landing",
                )
            if not torn:
                lens = [
                    s for s in stores
                    if s.slot == "LEN" and s.line > first_p
                ]
                arms = [
                    s for s in stores
                    if s.slot == "STATE" and s.value == 1
                    and s.line > (lens[-1].line if lens else first_p)
                ]
                if not lens:
                    yield Finding(
                        mod.rel, first_p, self.name,
                        f"{where}: payload store with no length store "
                        "after it — the reader cannot bound the slice",
                    )
                if not arms:
                    yield Finding(
                        mod.rel, last_pl, self.name,
                        f"{where}: slot is never armed (state=1 after "
                        "payload+len) — the write can never be replayed",
                    )
        elif kind == "ring":
            early_w = [
                s for s in stores if s.slot == "W" and s.line < first_p
            ]
            if early_w:
                yield Finding(
                    mod.rel, early_w[0].line, self.name,
                    f"{where}: hdr[W] published before the payload copy "
                    "— the consumer's descriptor can reference bytes "
                    "that have not landed (copy-before-publish)",
                )
            if not torn and not any(
                s.slot == "W" and s.line > first_p for s in stores
            ):
                yield Finding(
                    mod.rel, first_p, self.name,
                    f"{where}: payload copied but hdr[W] never "
                    "published — the bytes are unreachable and the "
                    "ring leaks capacity",
                )

    # --------------------------------------------- single-writer-per-bank

    def _check_bank_writers(self, mod):
        # every `X[... BANK_FOO ...] = value` store, attributed to its
        # outermost enclosing def (closures inherit the owner)
        def owner_allows(owner: "str | None", field: str) -> bool:
            if owner is None:
                return False
            allowed = BANK_WRITERS.get(owner)
            if allowed is None:
                return False
            return not allowed or field in allowed

        def bank_field(index_expr) -> "str | None":
            for sub in ast.walk(index_expr):
                chain = _attr_chain(sub) if isinstance(
                    sub, (ast.Attribute, ast.Name)
                ) else None
                if chain and chain[-1].startswith("BANK_") and \
                        chain[-1] != "BANK_FIELDS":
                    return chain[-1]
            return None

        def walk_stmts(node, owner):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in node.body:
                    yield from walk_stmts(child, owner)
                return
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        field = bank_field(tgt.slice)
                        if field is not None and not owner_allows(
                            owner, field
                        ):
                            yield Finding(
                                mod.rel, node.lineno, self.name,
                                f"{owner or mod.modname} stores "
                                f"{field} but is not a declared bank "
                                "writer — the StatusBank is single-"
                                "writer-per-row (add it to "
                                "BANK_WRITERS only with an ownership "
                                "argument)",
                            )
            for child in ast.iter_child_nodes(node):
                yield from walk_stmts(child, owner)

        for stmt in mod.tree.body:
            if isinstance(stmt, ast.ClassDef):
                for meth in stmt.body:
                    if isinstance(
                        meth, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        qual = f"{stmt.name}.{meth.name}"
                        for child in meth.body:
                            yield from walk_stmts(child, qual)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in stmt.body:
                    yield from walk_stmts(child, stmt.name)

    # ---------------------------------------- copy-before-descriptor-send

    def _check_descriptor_order(self, mod):
        # any function calling both ring.try_write and a .send/._send:
        # the first ring write must precede the first descriptor send
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            writes, sends = [], []
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                fnname = None
                if isinstance(sub.func, ast.Attribute):
                    fnname = sub.func.attr
                elif isinstance(sub.func, ast.Name):
                    fnname = sub.func.id
                if fnname == "try_write":
                    writes.append(sub.lineno)
                elif fnname in ("send", "_send"):
                    sends.append(sub.lineno)
            if writes and sends and min(sends) < min(writes):
                yield Finding(
                    mod.rel, min(sends), self.name,
                    f"{node.name}: descriptor sent before the ring "
                    "write — the pipe is the second fence; a consumer "
                    "can slice bytes the producer has not published "
                    "(call try_write first)",
                )
