"""Ahead-of-time rule compiler: LifecycleRule list -> dense device tables.

Replaces the reference's runtime template rendering
(pkg/kwok/controllers/renderer.go:30-89, parse-and-cache per template): here
ALL decision logic is compiled once, before the engine starts, into flat
arrays the tick kernel broadcasts against. Rendering of the full status
document happens only at the API boundary for dirty rows.

The compiled form is deliberately framework-agnostic numpy;
kwok_tpu_torch.ops.cuda_tick packs it into the tick kernel's rule table,
and ``compile_emit_templates`` lowers each reachable pod status patch to
the byte template the native emit splices (native/codec.cc).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kwok_tpu_torch.models.lifecycle import (
    DELETION_ANY,
    LifecycleRule,
    PhaseSpace,
    PHASE_SPACES,
    ResourceKind,
)

NO_RULE = np.int32(-1)

# --- patch-body templates ------------------------------------------------
#
# Segment codes for EmitTemplates: a compiled Stage rule's status-patch body
# lowered to literal byte runs plus typed holes the native codec splices
# per-row values into (codec.cc kwok_emit_pods). The JSON *shape* — key
# order, punctuation, the rule's target phase, condition types — is fixed
# here at compile time; only genuinely per-row values stay holes.
EMIT_LIT = 0     # literal bytes: seg_a = offset into lit_blob, seg_b = len
EMIT_START = 1   # row start/creation timestamp (batch "now" when empty)
EMIT_HOST = 2    # row hostIP
EMIT_POD = 3     # row podIP
EMIT_CTRS = 4    # containerStatuses records ("name\x1fimage\x1e...")
EMIT_ICTRS = 5   # initContainerStatuses records
EMIT_COND = 6    # '"True"'/'"False"' from row condition bit seg_a

# The three pod conditions the reference template asserts
# (pod.status.tpl; edge/render.py render_pod_status).
_POD_EMIT_CONDITIONS = ("Initialized", "Ready", "ContainersReady")


def _esc_json(s: str) -> bytes:
    """JSON string-content escaping, byte-identical to codec.cc Buf::esc
    (raw UTF-8 for printable text, \\u00xx for control chars) — baked
    literals must match what the runtime splicer would have written."""
    out = bytearray()
    for ch in s.encode():
        if ch == 0x22:
            out += b'\\"'
        elif ch == 0x5C:
            out += b"\\\\"
        elif ch == 0x0A:
            out += b"\\n"
        elif ch == 0x0D:
            out += b"\\r"
        elif ch == 0x09:
            out += b"\\t"
        elif ch < 0x20:
            out += b"\\u%04x" % ch
        else:
            out.append(ch)
    return bytes(out)


@dataclasses.dataclass(frozen=True)
class EmitTemplates:
    """Pod status-patch bodies as byte templates, one per target phase.

    The tick wire hands emit a row's post-transition phase id and
    condition bits; everything else in the patch body is either fixed by
    the phase (the template) or a per-row column (the holes). Every
    rule's compile-time ``to_phase`` is a phase id, so "each rule's
    patch body" dedups to one template per distinct target phase and
    ``phase_tpl`` is the whole mapping the splicer needs.

    The arrays are the form codec.cc reads directly:
    ``seg_code``/``seg_a``/``seg_b`` are the concatenated segment tables
    of all templates, template t spanning ``tpl_off[t]:tpl_off[t+1]``.
    """

    lit_blob: bytes
    seg_code: np.ndarray  # int32, EMIT_* per segment
    seg_a: np.ndarray  # int64: literal offset / condition bit
    seg_b: np.ndarray  # int64: literal length
    tpl_off: np.ndarray  # int64 [T+1]
    tpl_kind: np.ndarray  # uint8: 0 running-like / 1 terminated-ok / 2 -err
    # uint8: containers render ready:true only in phase Running, as
    # edge/render.py does (the generic renderer's tpl_kind==0 would mark
    # Pending, Terminating and custom phases ready too)
    tpl_ready: np.ndarray
    phase_tpl: np.ndarray  # int32: phase id -> template id (-1 = slow path)
    phase_names: tuple[str, ...]  # template id -> phase name


class _TplBuilder:
    def __init__(self) -> None:
        self.lit = bytearray()
        self.code: list[int] = []
        self.a: list[int] = []
        self.b: list[int] = []
        self.off: list[int] = [0]

    def text(self, data: bytes) -> None:
        # merge adjacent literals so each template is a handful of segs
        if self.code and len(self.code) > self.off[-1] and (
            self.code[-1] == EMIT_LIT
            and self.a[-1] + self.b[-1] == len(self.lit)
        ):
            self.b[-1] += len(data)
        else:
            self.code.append(EMIT_LIT)
            self.a.append(len(self.lit))
            self.b.append(len(data))
        self.lit += data

    def hole(self, code: int, param: int = 0) -> None:
        self.code.append(code)
        self.a.append(param)
        self.b.append(0)

    def end_template(self) -> None:
        self.off.append(len(self.code))


def compile_emit_templates(table: CompiledRules) -> EmitTemplates:
    """Lower every reachable pod status-patch body to a byte template.

    One template per phase in the table's (possibly Stage-extended)
    phase space, except the terminal "Gone" (those rows never emit).
    Raises KeyError when the space lacks the canonical pod conditions:
    callers then keep the generic renderer.
    """
    space = table.space
    cond_bits = [space.condition_bit(c) for c in _POD_EMIT_CONDITIONS]
    b = _TplBuilder()
    kinds: list[int] = []
    readys: list[int] = []
    names: list[str] = []
    phase_tpl = np.full(len(space.phases), -1, np.int32)
    for pid, phase in enumerate(space.phases):
        if phase == "Gone":
            continue
        phase_tpl[pid] = len(names)
        names.append(phase)
        kinds.append(1 if phase == "Succeeded" else 2 if phase == "Failed" else 0)
        readys.append(1 if phase == "Running" else 0)
        b.text(b'{"status":{"conditions":[')
        for j, (cname, bit) in enumerate(zip(_POD_EMIT_CONDITIONS, cond_bits)):
            if j:
                b.text(b",")
            b.text(b'{"lastTransitionTime":"')
            b.hole(EMIT_START)
            b.text(b'","status":')
            b.hole(EMIT_COND, bit)
            b.text(b',"type":"' + _esc_json(cname) + b'"}')
        b.text(b'],"containerStatuses":[')
        b.hole(EMIT_CTRS)
        b.text(b'],"initContainerStatuses":[')
        b.hole(EMIT_ICTRS)
        b.text(b'],"hostIP":"')
        b.hole(EMIT_HOST)
        b.text(b'","podIP":"')
        b.hole(EMIT_POD)
        b.text(b'","phase":"' + _esc_json(phase) + b'","startTime":"')
        b.hole(EMIT_START)
        b.text(b'"}}')
        b.end_template()
    return EmitTemplates(
        lit_blob=bytes(b.lit),
        seg_code=np.asarray(b.code, np.int32),
        seg_a=np.asarray(b.a, np.int64),
        seg_b=np.asarray(b.b, np.int64),
        tpl_off=np.asarray(b.off, np.int64),
        tpl_kind=np.asarray(kinds, np.uint8),
        tpl_ready=np.asarray(readys, np.uint8),
        phase_tpl=phase_tpl,
        phase_names=tuple(names),
    )



@dataclasses.dataclass(frozen=True)
class CompiledRules:
    """Dense rule table for ONE resource kind.

    All arrays have length R (number of rules); rule order encodes priority
    (first match wins, like the reference's fixed controller ordering).
    """

    resource: ResourceKind
    space: PhaseSpace
    # uint32 bitmask over phase ids the rule matches from.
    from_mask: np.ndarray
    # int8: DELETION_ANY(-1) / DELETION_ABSENT(0) / DELETION_PRESENT(1).
    deletion: np.ndarray
    # int32 selector bit index into the row's sel_bits, or -1 for "all".
    selector_bit: np.ndarray
    # Delay distribution per rule.
    delay_kind: np.ndarray  # int8 DelayKind
    delay_a: np.ndarray  # float32
    delay_b: np.ndarray  # float32
    # Effect.
    to_phase: np.ndarray  # int32 phase id
    cond_assign: np.ndarray  # uint32: which condition bits the rule writes
    cond_value: np.ndarray  # uint32: the values written for assigned bits
    is_delete: np.ndarray  # bool
    # float32 Stage spec.weight; 0 = deterministic first-match rule, > 0 =
    # member of the stochastic pool (see LifecycleRule.weight).
    weight: np.ndarray
    # Host-side metadata (not shipped to device).
    names: tuple[str, ...]
    selector_names: tuple[str, ...]  # bit index -> selector name

    @property
    def num_rules(self) -> int:
        return int(self.from_mask.shape[0])


def compile_rules(
    rules: list[LifecycleRule],
    resource: ResourceKind,
    space: PhaseSpace | None = None,
) -> CompiledRules:
    space = space or PHASE_SPACES[resource]
    mine = [r for r in rules if r.resource == resource]

    # Upstream Stage documents may name phases outside the canonical
    # vocabulary (any string is a legal .status.phase). Extend the space by
    # APPENDING the unknown names: the canonical prefix keeps its ids, so
    # ingest/render constants (Pending, Gone, ...) stay valid, and two rule
    # sets differ only where their rules do (federation grouping keys
    # include the phase names).
    extra: list[str] = []
    for r in mine:
        for p in (*r.from_phases, r.effect.to_phase):
            if p and p not in space.phases and p not in extra:
                extra.append(p)
    if extra:
        space = PhaseSpace(
            phases=space.phases + tuple(extra), conditions=space.conditions
        )

    selector_names: list[str] = []

    def selector_id(name: str | None) -> int:
        if name is None:
            return -1
        if name not in selector_names:
            if len(selector_names) >= 32:
                raise ValueError("at most 32 distinct selectors per resource")
            selector_names.append(name)
        return selector_names.index(name)

    n = len(mine)
    from_mask = np.zeros(n, np.uint32)
    deletion = np.zeros(n, np.int8)
    selector_bit = np.zeros(n, np.int32)
    delay_kind = np.zeros(n, np.int8)
    delay_a = np.zeros(n, np.float32)
    delay_b = np.zeros(n, np.float32)
    to_phase = np.zeros(n, np.int32)
    cond_assign = np.zeros(n, np.uint32)
    cond_value = np.zeros(n, np.uint32)
    is_delete = np.zeros(n, bool)
    weight = np.zeros(n, np.float32)

    for i, r in enumerate(mine):
        if r.weight < 0:
            raise ValueError(f"rule {r.name!r}: weight must be >= 0")
        weight[i] = float(r.weight)
        to_id = space.phase_id(r.effect.to_phase)
        if r.from_phases:
            mask = 0
            for p in r.from_phases:
                mask |= 1 << space.phase_id(p)
        else:
            # empty from_phases = match any phase (upstream Stage semantics
            # for an absent selector.matchPhases), EXCEPT the rule's own
            # target phase for non-delete rules — otherwise the rule re-fires
            # from the phase it just wrote, patching the apiserver forever.
            mask = 0xFFFFFFFF
            if not r.effect.delete:
                mask &= ~(1 << to_id) & 0xFFFFFFFF
        from_mask[i] = mask
        deletion[i] = np.int8(r.deletion)
        selector_bit[i] = selector_id(r.selector)
        delay_kind[i] = int(r.delay.kind)
        delay_a[i] = r.delay.a
        delay_b[i] = r.delay.b
        to_phase[i] = to_id
        ca = 0
        cv = 0
        for cond, val in r.effect.conditions.items():
            bit = 1 << space.condition_bit(cond)
            ca |= bit
            if val:
                cv |= bit
        cond_assign[i] = ca
        cond_value[i] = cv
        is_delete[i] = r.effect.delete

    return CompiledRules(
        resource=resource,
        space=space,
        from_mask=from_mask,
        deletion=deletion,
        selector_bit=selector_bit,
        delay_kind=delay_kind,
        delay_a=delay_a,
        delay_b=delay_b,
        to_phase=to_phase,
        cond_assign=cond_assign,
        cond_value=cond_value,
        is_delete=is_delete,
        weight=weight,
        names=tuple(r.name for r in mine),
        selector_names=tuple(selector_names),
    )


def match_rules_host(
    table: CompiledRules,
    phase: int,
    sel_bits: int,
    has_deletion: bool,
) -> list[int]:
    """All rule indices whose guards (phase mask, deletion requirement,
    selector bit) match, in priority order. Pure-python oracle mirror of
    the device-side [C, R] match in kwok_tpu_torch.ops.cuda_tick."""
    out = []
    for i in range(table.num_rules):
        if not (int(table.from_mask[i]) >> phase) & 1:
            continue
        d = int(table.deletion[i])
        if d != DELETION_ANY and bool(d) != has_deletion:
            continue
        sb = int(table.selector_bit[i])
        if sb >= 0 and not (sel_bits >> sb) & 1:
            continue
        out.append(i)
    return out


def choose_rule_host(table: CompiledRules, matches: list[int], u2: float) -> int:
    """Select among matched rules exactly like the tick kernel:

    - no matches -> -1;
    - first match unweighted (weight 0) -> first match (deterministic);
    - first match weighted -> weighted-random among ALL matching weighted
      rules, P(i) proportional to weight[i], via the caller's uniform u2 in
      [0, 1) (the device uses its per-row PRNG draw).
    """
    if not matches:
        return -1
    first = matches[0]
    if float(table.weight[first]) <= 0:
        return first
    pool = [i for i in matches if float(table.weight[i]) > 0]
    total = sum(float(table.weight[i]) for i in pool)
    target = u2 * total
    acc = 0.0
    for i in pool:
        acc += float(table.weight[i])
        if acc > target:
            return i
    return pool[-1]
