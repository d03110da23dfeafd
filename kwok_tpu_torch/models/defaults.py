"""Default lifecycle rule sets: the behavior of the reference's templates.

Reference behavior being reproduced (pkg/kwok/controllers/...):
- Nodes: on observe, immediately patch status Ready with capacity defaults
  (node_controller.go:301-391 + templates/node.status.tpl), then refresh
  heartbeat conditions every 30s (node_controller.go:175-204; interval set at
  controller.go:118).
- Pods: on observe (already bound to a managed node — the scheduler did
  that), immediately patch status Running (pod_controller.go:205-231 +
  templates/pod.status.tpl).
- Pods with a deletionTimestamp: strip finalizers and delete with grace 0
  (pod_controller.go:155-183).

Heartbeats are NOT rules — they are a vectorized timer wheel in the tick
kernel (hb_due array), because they repeat rather than transition.
"""

from __future__ import annotations

from kwok_tpu_torch.models.lifecycle import (
    DELETION_PRESENT,
    Delay,
    LifecycleRule,
    ResourceKind,
    StatusEffect,
)

# Selector names resolved by the host at ingest (kwok_tpu.engine):
# - "managed": passes the manage-selectors AND is not excluded by the
#   disregard-selectors (controller.go:81-111 + needLockNode/needLockPod).
#   For pods this additionally requires the bound node to be managed
#   (NodeHasFunc wiring, controller.go:137).
# - "on-managed-node" (pods): the bound node is managed, regardless of the
#   pod's own disregard annotations — the deletion path uses this
#   (pod_controller.go:306-316 gates deleteChan on nodeHasFunc only).
# - "heartbeat" (nodes): passes the manage-selectors (needHeartbeat,
#   node_controller.go:205-207); heartbeats ignore disregard.
SEL_MANAGED = "managed"
SEL_ON_MANAGED_NODE = "on-managed-node"
SEL_HEARTBEAT = "heartbeat"


def default_node_rules(ready_delay: Delay | None = None) -> list[LifecycleRule]:
    return [
        LifecycleRule(
            name="node-ready",
            resource=ResourceKind.NODE,
            from_phases=("Observed", "NotReady"),
            selector=SEL_MANAGED,
            delay=ready_delay or Delay.constant(0.0),
            effect=StatusEffect(
                to_phase="Ready",
                conditions={
                    "Ready": True,
                    "OutOfDisk": False,
                    "MemoryPressure": False,
                    "DiskPressure": False,
                    "NetworkUnavailable": False,
                    "PIDPressure": False,
                },
            ),
        ),
    ]


def default_pod_rules(running_delay: Delay | None = None) -> list[LifecycleRule]:
    return [
        # Deletion wins over everything (checked first, like the reference's
        # deleteChan taking DeletionTimestamp'd pods out of the lock path,
        # pod_controller.go:306-316).
        LifecycleRule(
            name="pod-delete",
            resource=ResourceKind.POD,
            from_phases=("Pending", "Running", "Succeeded", "Failed", "Terminating"),
            deletion=DELETION_PRESENT,
            selector=SEL_ON_MANAGED_NODE,
            delay=Delay.constant(0.0),
            effect=StatusEffect(to_phase="Gone", delete=True),
        ),
        LifecycleRule(
            name="pod-running",
            resource=ResourceKind.POD,
            from_phases=("Pending",),
            selector=SEL_MANAGED,
            delay=running_delay or Delay.constant(0.0),
            effect=StatusEffect(
                to_phase="Running",
                conditions={
                    "Initialized": True,
                    "Ready": True,
                    "ContainersReady": True,
                },
            ),
        ),
    ]


def default_rules() -> list[LifecycleRule]:
    return default_node_rules() + default_pod_rules()


def chaos_pod_rules(mean_run_seconds: float = 60.0) -> list[LifecycleRule]:
    """An example chaos rule set: pods run, then complete after Exp(mean).

    The BASELINE.json soak configs ("pod-chaos", Poisson delays) need
    stochastic transitions; constant-delay templates are the degenerate case.
    """
    rules = default_pod_rules()
    rules.append(
        LifecycleRule(
            name="pod-complete",
            resource=ResourceKind.POD,
            from_phases=("Running",),
            selector=SEL_MANAGED,
            delay=Delay.exponential(mean_run_seconds),
            effect=StatusEffect(
                to_phase="Succeeded",
                conditions={"Ready": False, "ContainersReady": False},
            ),
        )
    )
    return rules
