"""Stage: the YAML lifecycle-rule API (selector + delay + next).

This snapshot of the reference predates the Stage CRD (SURVEY.md "Snapshot
vintage"); its lifecycle is three hard-coded templates. Per the survey's
guidance, the framework's native rule API is designed as the generalization
those templates are a degenerate case of, with a Stage-shaped YAML surface:

    apiVersion: kwok.x-k8s.io/v1alpha1
    kind: Stage
    metadata: {name: pod-complete}
    spec:
      resourceRef: {apiGroup: v1, kind: Pod}
      selector:
        matchPhases: [Running]          # phase names (our state machine)
        matchDeletion: absent           # absent | present | any
        matchSelector: managed          # host-computed selector bit name
      delay:
        duration: 5s                    # constant; or
        exponential: {mean: 30s, cap: 5m}
        uniform: {min: 1s, max: 10s}
      next:
        phase: Succeeded
        conditions: {Ready: false, ContainersReady: false}
        delete: false
      weight: 3   # optional; absent/0 = deterministic first-match, > 0 =
                  # weighted-random among matching weighted stages
                  # (LifecycleRule.weight has the full semantics)

Stages for a resource REPLACE the default rule set for that resource.
"""

from __future__ import annotations

import dataclasses
import re

from kwok_tpu_torch.models.defaults import (
    SEL_HEARTBEAT,
    SEL_MANAGED,
    SEL_ON_MANAGED_NODE,
)
from kwok_tpu_torch.models.lifecycle import (
    DELETION_ABSENT,
    DELETION_ANY,
    DELETION_PRESENT,
    Delay,
    LifecycleRule,
    ResourceKind,
    StatusEffect,
)

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h)")
_UNIT = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
_DELETION = {
    "absent": DELETION_ABSENT,
    "present": DELETION_PRESENT,
    "any": DELETION_ANY,
}
_KIND_TO_RESOURCE = {"Pod": ResourceKind.POD, "Node": ResourceKind.NODE}
# Selector bits the engine actually sets at ingest, per resource kind
# (ClusterEngine.node_bits / pod_bits); anything else would compile to a
# bit that never fires, so reject it at load time.
_KNOWN_SELECTORS = {
    ResourceKind.NODE: frozenset({SEL_MANAGED, SEL_HEARTBEAT}),
    ResourceKind.POD: frozenset({SEL_MANAGED, SEL_ON_MANAGED_NODE}),
}


def parse_duration(s) -> float:
    """'5s', '300ms', '1m30s', '0.5s', bare numbers = seconds."""
    if isinstance(s, (int, float)):
        return float(s)
    s = str(s).strip()
    if not s:
        return 0.0
    total, pos = 0.0, 0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"bad duration {s!r}")
        total += float(m.group(1)) * _UNIT[m.group(2)]
        pos = m.end()
    if pos != len(s):
        # bare number => seconds
        return float(s)
    return total


def _parse_delay(spec: dict | None) -> Delay:
    if not spec:
        return Delay.constant(0.0)
    if "exponential" in spec:
        e = spec["exponential"] or {}
        return Delay.exponential(
            parse_duration(e.get("mean", 0)), parse_duration(e.get("cap", 0))
        )
    if "uniform" in spec:
        u = spec["uniform"] or {}
        return Delay.uniform(
            parse_duration(u.get("min", 0)), parse_duration(u.get("max", 0))
        )
    return Delay.constant(parse_duration(spec.get("duration", 0)))


@dataclasses.dataclass
class Stage:
    name: str
    resource: ResourceKind
    from_phases: tuple[str, ...]
    deletion: int
    selector: str | None
    delay: Delay
    to_phase: str
    conditions: dict[str, bool]
    delete: bool
    # spec.weight: absent/0 = deterministic first-match ordering; > 0 opts
    # the stage into weighted-random selection among matching weighted
    # stages (see LifecycleRule.weight for the full semantics).
    weight: int = 0

    KIND = "Stage"

    @classmethod
    def from_doc(cls, doc: dict) -> "Stage":
        meta = doc.get("metadata") or {}
        spec = doc.get("spec") or {}
        ref = spec.get("resourceRef") or {}
        kind = ref.get("kind") or "Pod"
        if kind not in _KIND_TO_RESOURCE:
            raise ValueError(f"Stage resourceRef.kind {kind!r} not supported")
        sel = spec.get("selector") or {}
        nxt = spec.get("next") or {}
        delete = bool(nxt.get("delete", False))
        to_phase = nxt.get("phase") or ""
        if not to_phase:
            if delete:
                to_phase = "Gone"  # terminal phase for pure-delete stages
            else:
                raise ValueError(
                    f"Stage {meta.get('name')!r}: spec.next.phase is required "
                    "unless next.delete is true"
                )
        name = meta.get("name") or "stage"
        resource = _KIND_TO_RESOURCE[kind]
        # matchSelector: absent -> managed-only (safe default); explicit
        # null -> match every row
        selector = sel["matchSelector"] if "matchSelector" in sel else SEL_MANAGED
        known = _KNOWN_SELECTORS[resource]
        if selector is not None and selector not in known:
            raise ValueError(
                f"Stage {name!r}: unknown matchSelector {selector!r} for "
                f"{kind}; valid values: {sorted(known)} or null"
            )
        deletion_name = sel.get("matchDeletion", "absent")
        if deletion_name not in _DELETION:
            raise ValueError(
                f"Stage {name!r}: bad matchDeletion {deletion_name!r}; "
                f"valid values: {sorted(_DELETION)}"
            )
        weight = int(spec.get("weight", 0))
        if weight < 0:
            raise ValueError(f"Stage {name!r}: spec.weight must be >= 0")
        return cls(
            name=name,
            resource=resource,
            from_phases=tuple(sel.get("matchPhases") or ()),
            deletion=_DELETION[deletion_name],
            selector=selector,
            delay=_parse_delay(spec.get("delay")),
            to_phase=to_phase,
            conditions=dict(nxt.get("conditions") or {}),
            delete=delete,
            weight=weight,
        )

    def to_rule(self) -> LifecycleRule:
        return LifecycleRule(
            name=self.name,
            resource=self.resource,
            from_phases=self.from_phases,
            deletion=self.deletion,
            selector=self.selector or None,
            delay=self.delay,
            effect=StatusEffect(
                to_phase=self.to_phase,
                conditions=self.conditions,
                delete=self.delete,
            ),
            weight=self.weight,
        )

    def to_doc(self) -> dict:
        from kwok_tpu_torch.config.types import GROUP_VERSION

        deletion_name = {v: k for k, v in _DELETION.items()}[self.deletion]
        # bare numbers = seconds; avoids float-repr strings parse_duration
        # can't re-read
        delay: dict = {}
        if self.delay.kind == 0:
            delay = {"duration": float(self.delay.a)}
        elif self.delay.kind == 1:
            delay = {"uniform": {"min": float(self.delay.a), "max": float(self.delay.b)}}
        else:
            delay = {
                "exponential": {"mean": float(self.delay.a), "cap": float(self.delay.b)}
            }
        return {
            "apiVersion": GROUP_VERSION,
            "kind": self.KIND,
            "metadata": {"name": self.name},
            "spec": {
                "resourceRef": {
                    "apiGroup": "v1",
                    "kind": "Pod" if self.resource == ResourceKind.POD else "Node",
                },
                "selector": {
                    "matchPhases": list(self.from_phases),
                    "matchDeletion": deletion_name,
                    "matchSelector": self.selector,  # null = match every row
                },
                "delay": delay,
                "next": {
                    "phase": self.to_phase,
                    "conditions": dict(self.conditions),
                    "delete": self.delete,
                },
                "weight": self.weight,
            },
        }


def stages_to_rules(
    stages: list[Stage], resource: ResourceKind
) -> list[LifecycleRule] | None:
    """Stages for `resource` -> rule list; None if no stages target it
    (caller falls back to the built-in default rule set)."""
    mine = [s for s in stages if s.resource == resource]
    if not mine:
        return None
    return [s.to_rule() for s in mine]
