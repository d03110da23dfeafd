"""Lifecycle rule IR: (match, delay, next-state) triples.

This is the framework's native lifecycle API. The reference's equivalent is
implicit: NodeController patches node status Ready immediately on observe
(pkg/kwok/controllers/node_controller.go:301-354), PodController patches pod
status Running (pod_controller.go:205-231), and deletion strips finalizers and
deletes (pod_controller.go:155-183). Each of those behaviors is one
`LifecycleRule` in the default rule set (kwok_tpu.models.defaults); users can
load their own rule sets from YAML (apiVersion kwok.x-k8s.io/v1alpha1, kind
Stage-compatible surface) to get delays, chaos, and custom state machines.

Design constraints for the TPU path:
- phases are small enums (<= 31 per resource kind) so a phase set fits a
  uint32 bitmask;
- selector matches are resolved on the HOST at ingest time into per-row
  selector bits (dynamic strings never reach the device);
- delays are distributions sampled on-device (constant / uniform /
  exponential) so Poisson-process chaos runs at full rate.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence


class ResourceKind(str, enum.Enum):
    NODE = "nodes"
    POD = "pods"


class DelayKind(enum.IntEnum):
    CONSTANT = 0
    UNIFORM = 1
    EXPONENTIAL = 2


@dataclasses.dataclass(frozen=True)
class Delay:
    """Delay before a matched rule fires.

    constant(v): fires exactly v seconds after match.
    uniform(a, b): U[a, b).
    exponential(mean, cap): Exp(mean), truncated at cap (cap<=0 -> uncapped).
    """

    kind: DelayKind = DelayKind.CONSTANT
    a: float = 0.0
    b: float = 0.0

    @staticmethod
    def constant(seconds: float = 0.0) -> "Delay":
        return Delay(DelayKind.CONSTANT, float(seconds), 0.0)

    @staticmethod
    def uniform(low: float, high: float) -> "Delay":
        return Delay(DelayKind.UNIFORM, float(low), float(high))

    @staticmethod
    def exponential(mean: float, cap: float = 0.0) -> "Delay":
        return Delay(DelayKind.EXPONENTIAL, float(mean), float(cap))


# Sentinel for "don't care" on the deletion-timestamp match.
DELETION_ANY = -1
DELETION_ABSENT = 0
DELETION_PRESENT = 1


@dataclasses.dataclass(frozen=True)
class StatusEffect:
    """What firing a rule does to a row.

    conditions maps condition-name -> True/False; names are resolved to bit
    positions by the compiler. The full status document (addresses, capacity,
    containerStatuses, ...) is rendered host-side at the API boundary from the
    row's (phase, condition bits) by kwok_tpu.edge.render — the device only
    tracks the decision-relevant state.
    """

    to_phase: str
    conditions: Mapping[str, bool] = dataclasses.field(default_factory=dict)
    # Emit a delete (not a status patch) when this rule fires — the analogue
    # of the reference's finalizer-strip + grace-0 delete
    # (pod_controller.go:155-183).
    delete: bool = False


@dataclasses.dataclass(frozen=True)
class LifecycleRule:
    """selector + delay + next-state: one edge of the lifecycle state machine.

    First matching rule wins (rules are ordered), unless the first match is
    weighted — see `weight` below for the stochastic-selection semantics. A
    row re-enters matching after every transition, so chains of rules
    express multi-step lifecycles (Pending -> Running -> Succeeded).
    """

    name: str
    resource: ResourceKind
    from_phases: Sequence[str]
    effect: StatusEffect
    delay: Delay = dataclasses.field(default_factory=Delay.constant)
    # DELETION_ANY / DELETION_ABSENT / DELETION_PRESENT
    deletion: int = DELETION_ABSENT
    # Name of a host-computed selector; resolved to a bit index by the
    # compiler. None => matches every row of the resource.
    selector: str | None = None
    # The Stage CRD's spec.weight. 0 (the default, = absent in YAML) keeps
    # the deterministic first-match-wins ordering. weight > 0 opts the rule
    # into stochastic selection: when the FIRST matching rule is weighted,
    # the row draws among ALL matching weighted rules with probability
    # proportional to weight (upstream Stage semantics for weighted stage
    # sets); a weight-0 rule at lower index still wins deterministically.
    # An armed choice is sticky — re-drawn only when ingest invalidates it
    # or the rule fires, never on a quiet tick.
    weight: int = 0


@dataclasses.dataclass(frozen=True)
class PhaseSpace:
    """Phase and condition vocabularies for one resource kind.

    Index 0 is the ingest phase (what a row starts as when first observed).
    """

    phases: tuple[str, ...]
    conditions: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(self.phases) > 31:
            raise ValueError("at most 31 phases per resource kind")
        if len(self.conditions) > 32:
            raise ValueError("at most 32 condition bits per resource kind")

    def phase_id(self, name: str) -> int:
        return self.phases.index(name)

    def condition_bit(self, name: str) -> int:
        return self.conditions.index(name)


# --- canonical phase spaces -------------------------------------------------

# Node lifecycle. The reference only knows "unlocked" vs "locked (Ready)"
# (node_controller.go:301-354); we model that plus an explicit NotReady for
# chaos rules.
NODE_PHASES = PhaseSpace(
    phases=("Observed", "Ready", "NotReady", "Gone"),
    # Order matches pkg/kwok/controllers/templates/node.status.tpl condition
    # list (Ready, OutOfDisk, MemoryPressure, DiskPressure, NetworkUnavailable)
    # plus PIDPressure used by newer kubelets.
    conditions=(
        "Ready",
        "OutOfDisk",
        "MemoryPressure",
        "DiskPressure",
        "NetworkUnavailable",
        "PIDPressure",
    ),
)

# Pod lifecycle. Reference: Pending -> Running on lock
# (pod_controller.go:205-231, templates/pod.status.tpl), deletion ->
# finalizer-strip + delete (pod_controller.go:155-183).
POD_PHASES = PhaseSpace(
    phases=("Pending", "Running", "Succeeded", "Failed", "Terminating", "Gone"),
    # templates/pod.status.tpl conditions.
    conditions=("Initialized", "Ready", "ContainersReady", "PodScheduled"),
)

PHASE_SPACES: dict[ResourceKind, PhaseSpace] = {
    ResourceKind.NODE: NODE_PHASES,
    ResourceKind.POD: POD_PHASES,
}
