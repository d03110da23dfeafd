"""Kernel-purity rule for the port: no host syncs on the tick dispatch path.

A dispatch enqueues the tick kernel once per kind, packs the wire on the
device and starts its copy to the host; the host must not wait for the
card anywhere in between, or every dispatch serializes on the stream and
the pipelined engine loses its overlap. The JAX package's rule found its
scope from ``jax.jit``/``shard_map``/``pl.pallas_call``; the port has
none of these, so the scope is found from the code instead:

- **roots**: every function that calls the kernel's wrapper or its launch
  (a call whose callee is named ``tick_steps`` or ``kwok_tick_launch``,
  whatever the receiver: ``cuda_tick.tick_steps(...)``,
  ``lib.kwok_tick_launch(...)``), and every function named ``pack_wire``;
- **callees**, within the root's module: ``self.m(...)`` resolved in the
  class and its bases, a bare ``f(...)`` to a module-level function, a
  ``Cls(...)`` to that class's ``__init__``, and ``x.m(...)`` to a method
  ``m`` that exactly one class of the module defines. A call whose line
  carries ``# kwoklint: disable=kernel-purity -- <why>`` is not followed
  (the once-per-process library build, the CPU tensors' plain version).

Flagged inside that scope:

- device-to-host reads: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``; ``np.asarray``/``np.array`` of a tensor; ``int()``,
  ``float()`` or ``bool()`` of a tensor expression;
- explicit waits: ``torch.cuda.synchronize()`` and any
  ``<event or stream>.synchronize()``;
- host-to-device copies of host data: ``torch.tensor(...)`` or
  ``torch.as_tensor(...)`` of a non-tensor with a ``device=``, which
  PyTorch makes from pageable memory and follows with a stream sync;
- host effects: ``print``, ``open``, ``input``, ``logging``/``logger``
  calls, ``time.*``, ``datetime.*``, ``random.*``, ``np.random.*``,
  ``subprocess.*``, ``os.environ`` and ``os.getenv``.

Host scalars stay allowed: ``float(np.float32(now0))``, ``int(steps)``,
``int(bits.shape[0])``. A tensor expression is found by a local, flow-
insensitive inference: ``torch.*`` calls (but not ``torch.device`` and
the like, nor ``torch.cuda.*``), the wrapper's own functions
(``tick_steps``, ``pack_wire``, ``next_due``, ``packbits``), the row
fields of ``RowState``/``TickOutputs`` read off any object, parameters
annotated ``torch.Tensor``, and names, subscripts, arithmetic and method
results built from those; ``.shape``, ``.dtype``, ``.device`` and
``.dim()``-like reads of a tensor are host values.
"""

from __future__ import annotations

import ast

from kwok_tpu_torch.analysis.core import Finding, Module, Rule

_ROOT_CALLEES = frozenset({"tick_steps", "kwok_tick_launch"})
_ROOT_FUNCS = frozenset({"pack_wire"})

# calls whose result is a tensor on the dispatch path
_TENSOR_FUNCS = frozenset({
    "tick_steps", "tick_steps_plain", "pack_wire", "next_due", "packbits",
})
# row fields of RowState and the tensors of TickOutputs
_TENSOR_FIELDS = frozenset({
    "active", "has_deletion", "phase", "cond_bits", "sel_bits",
    "pending_rule", "gen", "fire_at", "hb_due",
    "dirty", "deleted", "hb_fired", "transitions", "heartbeats",
})
# torch.<name>(...) calls that return no tensor
_TORCH_HOST = frozenset({
    "device", "Size", "is_tensor", "finfo", "iinfo", "Generator",
    "get_default_dtype", "is_floating_point",
})
# attribute reads and methods of a tensor that give host values
_HOST_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "layout",
    "requires_grad",
})
_HOST_METHODS = frozenset({
    "dim", "numel", "nelement", "size", "element_size", "data_ptr",
    "is_contiguous", "stride", "storage_offset", "get_device", "is_pinned",
})
_D2H_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})
_HOST_MODULES = frozenset({
    "time", "datetime", "random", "logging", "logger", "subprocess",
})
_HOST_CALLS = frozenset({"print", "open", "input"})
_SCALAR_CASTS = frozenset({"int", "float", "bool"})


def _terminal(expr: ast.expr) -> "str | None":
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _chain(expr: ast.expr) -> "list[str] | None":
    """Dotted chain outermost first: torch.cuda.synchronize -> [torch,
    cuda, synchronize]; None when it does not start at a name."""
    parts: list = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    parts.reverse()
    return parts


class _Func:
    """One function or method of the module."""

    def __init__(self, node, cls: "str | None") -> None:
        self.node = node
        self.cls = cls
        self.name = node.name
        self.qual = f"{cls}.{node.name}" if cls else node.name


def _annotated_tensor(arg: ast.arg) -> bool:
    ann = arg.annotation
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.endswith("Tensor")
    return _terminal(ann) == "Tensor" if ann is not None else False


class _Types:
    """Flow-insensitive tensor inference over one function body."""

    def __init__(self, fn) -> None:
        self.names: set = set()
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if _annotated_tensor(a):
                self.names.add(a.arg)
        assigns = []
        for node in _walk_scope(fn):
            if isinstance(node, ast.Assign):
                assigns.extend((t, node.value) for t in node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                assigns.append((node.target, node.value))
            elif isinstance(node, ast.For):
                assigns.append((node.target, node.iter))
        changed = True
        while changed:
            changed = False
            for tgt, value in assigns:
                if self.is_tensor(value):
                    for name in _target_names(tgt):
                        if name not in self.names:
                            self.names.add(name)
                            changed = True

    def is_tensor(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in _TENSOR_FIELDS:
                return True
            if e.attr in _HOST_ATTRS:
                return False
            return self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            return self.is_tensor(e.left) or any(
                self.is_tensor(c) for c in e.comparators
            )
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(self.is_tensor(x) for x in e.elts)
        if isinstance(e, (ast.ListComp, ast.GeneratorExp)):
            return self.is_tensor(e.elt)
        if isinstance(e, ast.Call):
            fn = e.func
            chain = _chain(fn)
            if chain and chain[0] == "torch":
                return "cuda" not in chain and chain[-1] not in _TORCH_HOST
            t = _terminal(fn)
            if t in _TENSOR_FUNCS:
                return True
            if isinstance(fn, ast.Attribute) and self.is_tensor(fn.value):
                return t not in _HOST_METHODS and t not in _D2H_METHODS
        return False


def _target_names(tgt) -> list:
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [n for el in tgt.elts for n in _target_names(el)]
    return []


def _walk_scope(fn):
    """Every node of a function body, nested defs and classes excluded."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class KernelPurityRule(Rule):
    name = "kernel-purity"
    description = (
        "no host syncs (.item(), .cpu(), np.asarray of a tensor, "
        "synchronize, int() of a tensor, pageable H2D copies) or host "
        "effects on the tick dispatch path"
    )

    def check_module(self, mod: Module):
        for f in self.dispatch_scope(mod):
            yield from self._scan(mod, f)

    def dispatch_scope(self, mod: Module) -> list:
        """The module's functions on the dispatch path (``_Func``s with
        ``qual`` names), in source order; see the module docstring."""
        funcs: list = []
        by_name: dict = {}       # module-level functions
        by_class: dict = {}      # class -> {method: _Func}
        bases: dict = {}
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = _Func(node, None)
                funcs.append(f)
                by_name[node.name] = f
            elif isinstance(node, ast.ClassDef):
                bases[node.name] = [_terminal(b) for b in node.bases]
                methods = by_class.setdefault(node.name, {})
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        f = _Func(sub, node.name)
                        funcs.append(f)
                        methods[sub.name] = f

        def in_class(cls, name):
            seen = set()
            while cls is not None and cls not in seen:
                seen.add(cls)
                hit = by_class.get(cls, {}).get(name)
                if hit is not None:
                    return hit
                parents = bases.get(cls) or [None]
                cls = parents[0]
            return None

        def resolve(f: _Func, call: ast.Call) -> "_Func | None":
            fn = call.func
            if isinstance(fn, ast.Name):
                if fn.id in by_name:
                    return by_name[fn.id]
                if fn.id in by_class:
                    return in_class(fn.id, "__init__")
                return None
            if isinstance(fn, ast.Attribute):
                recv = fn.value
                if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                    return in_class(f.cls, fn.attr)
                owners = [m[fn.attr] for m in by_class.values() if fn.attr in m]
                if len(owners) == 1 and not fn.attr.startswith("__"):
                    return owners[0]
            return None

        roots = []
        for f in funcs:
            if f.name in _ROOT_FUNCS or any(
                isinstance(n, ast.Call) and _terminal(n.func) in _ROOT_CALLEES
                for n in _walk_scope(f.node)
            ):
                roots.append(f)
        scope: dict = {}
        frontier = list(roots)
        while frontier:
            f = frontier.pop()
            if id(f) in scope:
                continue
            scope[id(f)] = f
            for n in _walk_scope(f.node):
                if not isinstance(n, ast.Call):
                    continue
                callee = resolve(f, n)
                if callee is None or id(callee) in scope:
                    continue
                if mod.consume_suppression(n.lineno, self.name) is not None:
                    mod.scan_suppressed += 1
                    continue
                frontier.append(callee)
        return sorted(scope.values(), key=lambda f: f.node.lineno)

    def _scan(self, mod: Module, f: _Func):
        types = _Types(f.node)
        where = f"{mod.modname}.{f.qual}"
        seen: set = set()

        def hit(node, msg):
            key = (node.lineno, msg)
            if key not in seen:
                seen.add(key)
                return Finding(mod.rel, node.lineno, self.name,
                               f"{msg} on the dispatch path ({where})")
            return None

        for node in _walk_scope(f.node):
            msg = None
            if isinstance(node, ast.Call):
                msg = self._check_call(node, types)
            elif isinstance(node, ast.Attribute) and node.attr == "environ" \
                    and _terminal(node.value) == "os":
                msg = "os.environ read"
            if msg:
                finding = hit(node, msg)
                if finding is not None:
                    yield finding

    @staticmethod
    def _check_call(call: ast.Call, types: _Types) -> "str | None":
        fn = call.func
        t = _terminal(fn)
        chain = _chain(fn) or []
        if isinstance(fn, ast.Name):
            if fn.id in _HOST_CALLS:
                return f"host call {fn.id}()"
            if fn.id in _SCALAR_CASTS and call.args \
                    and types.is_tensor(call.args[0]):
                return (f"{fn.id}() of a tensor: a device-to-host read "
                        "that waits for the stream")
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        if t in _D2H_METHODS:
            return (f".{t}(): a device-to-host read that waits for the "
                    "stream")
        if t == "synchronize":
            return f"{'.'.join(chain) or '.synchronize'}(): waits for the card"
        root = chain[0] if chain else None
        if root in ("np", "numpy"):
            if len(chain) > 2 and chain[1] == "random":
                return f"{'.'.join(chain)}(): host RNG"
            if t in ("asarray", "array") and call.args \
                    and types.is_tensor(call.args[0]):
                return (f"{root}.{t}() of a tensor: a device-to-host copy "
                        "that waits for the stream")
            return None
        if root == "torch" and t in ("tensor", "as_tensor") and any(
            kw.arg == "device" for kw in call.keywords
        ) and not (call.args and types.is_tensor(call.args[0])):
            return (f"torch.{t}() of host data onto a device: a pageable "
                    "host-to-device copy, which PyTorch follows with a "
                    "stream sync")
        if root in _HOST_MODULES:
            return f"{'.'.join(chain)}(): a host effect"
        if root == "os" and t in ("getenv", "environ"):
            return f"os.{t} read"
        return None
