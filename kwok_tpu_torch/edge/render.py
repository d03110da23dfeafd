"""Status-document renderers: dirty rows -> Kubernetes status dicts.

The behavior of the reference's three templates, as plain dict builders
(pkg/kwok/controllers/templates/node.status.tpl, node.heartbeat.tpl,
pod.status.tpl). Rendering happens host-side ONLY for rows the tick kernel
marked dirty — the replacement for per-object template execution
(renderer.go:49-89).

Generalization beyond the reference: phase names and condition bits come
from the row (kwok_tpu_torch.models.lifecycle), so custom rule sets render
faithfully; container states follow the pod phase (running / terminated).
"""

from __future__ import annotations

import datetime
import json
from typing import Any, Mapping

from kwok_tpu_torch.models.lifecycle import NODE_PHASES, POD_PHASES, PhaseSpace

# Default simulated capacity (node.status.tpl:38-50).
DEFAULT_CAPACITY = {"cpu": "1k", "memory": "1Ti", "pods": "1M"}

_NODE_CONDITION_META = {
    "Ready": ("KubeletReady", "kubelet is posting ready status"),
    "OutOfDisk": ("KubeletHasSufficientDisk", "kubelet has sufficient disk space available"),
    "MemoryPressure": ("KubeletHasSufficientMemory", "kubelet has sufficient memory available"),
    "DiskPressure": ("KubeletHasNoDiskPressure", "kubelet has no disk pressure"),
    "NetworkUnavailable": ("RouteCreated", "RouteController created a route"),
    "PIDPressure": ("KubeletHasSufficientPID", "kubelet has sufficient PID available"),
}

_NODE_INFO_DEFAULTS = {
    "architecture": "amd64",
    "bootID": "",
    "containerRuntimeVersion": "",
    "kernelVersion": "",
    "kubeProxyVersion": "fake",
    "kubeletVersion": "fake",
    "machineID": "",
    "operatingSystem": "linux",
    "osImage": "",
    "systemUUID": "",
}


def rfc3339(t: datetime.datetime | str | None) -> str:
    if isinstance(t, str):
        return t
    if t is None:
        t = datetime.datetime.now(datetime.timezone.utc)
    return t.astimezone(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def now_rfc3339() -> str:
    return rfc3339(None)


def parse_rfc3339(ts: str) -> float:
    """RFC3339 timestamp -> unix seconds (inverse of rfc3339; tolerates
    fractional seconds and explicit offsets from real apiservers)."""
    return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()


def _cond_status(cond_bits: int, space: PhaseSpace, name: str) -> str:
    return "True" if (cond_bits >> space.condition_bit(name)) & 1 else "False"


def node_conditions(
    cond_bits: int,
    now: str,
    start_time: str,
    conditions: tuple[str, ...] = NODE_PHASES.conditions,
) -> list[dict]:
    out = []
    for name in conditions:
        reason, message = _NODE_CONDITION_META.get(name, ("KwokRule", name))
        out.append(
            {
                "lastHeartbeatTime": now,
                "lastTransitionTime": start_time,
                "message": message,
                "reason": reason,
                "status": _cond_status(cond_bits, NODE_PHASES, name),
                "type": name,
            }
        )
    return out


def render_node_status(
    node: Mapping[str, Any],
    cond_bits: int,
    node_ip: str,
    now: str,
    start_time: str,
) -> dict:
    """node.status.tpl behavior: defaults fill only absent fields; the
    condition set is always (re)asserted."""
    status = node.get("status") or {}
    rendered: dict[str, Any] = {
        "addresses": status.get("addresses")
        or [{"address": node_ip, "type": "InternalIP"}],
        "allocatable": status.get("allocatable") or dict(DEFAULT_CAPACITY),
        "capacity": status.get("capacity") or dict(DEFAULT_CAPACITY),
        "phase": "Running",
    }
    if status.get("nodeInfo") is not None:
        info = dict(status["nodeInfo"])
        rendered["nodeInfo"] = {
            k: info.get(k) or d for k, d in _NODE_INFO_DEFAULTS.items()
        }
    rendered["conditions"] = node_conditions(cond_bits, now, start_time)
    return rendered


def render_node_heartbeat(cond_bits: int, now: str, start_time: str) -> dict:
    """node.heartbeat.tpl behavior: refresh lastHeartbeatTime on the
    condition set (always patched, no diff check —
    configureHeartbeatNode node_controller.go:393-401)."""
    return {"conditions": node_conditions(cond_bits, now, start_time)}


def _container_state(phase_name: str, start_time: str) -> dict:
    if phase_name in ("Succeeded",):
        return {
            "terminated": {
                "exitCode": 0,
                "finishedAt": start_time,
                "reason": "Completed",
                "startedAt": start_time,
            }
        }
    if phase_name in ("Failed",):
        return {
            "terminated": {
                "exitCode": 1,
                "finishedAt": start_time,
                "reason": "Error",
                "startedAt": start_time,
            }
        }
    return {"running": {"startedAt": start_time}}


def render_pod_status(
    pod: Mapping[str, Any],
    phase_name: str,
    cond_bits: int,
    node_ip: str,
    pod_ip: str,
) -> dict:
    """pod.status.tpl behavior, generalized over the row's phase.

    lastTransitionTime / startTime anchor to metadata.creationTimestamp as
    the template does (pod.status.tpl:1 `$startTime := .metadata.creationTimestamp`).
    """
    meta = pod.get("metadata") or {}
    spec = pod.get("spec") or {}
    status = pod.get("status") or {}
    start_time = meta.get("creationTimestamp") or now_rfc3339()
    ready = phase_name == "Running"

    conditions = []
    for name in ("Initialized", "Ready", "ContainersReady"):
        conditions.append(
            {
                "lastTransitionTime": start_time,
                "status": _cond_status(cond_bits, POD_PHASES, name),
                "type": name,
            }
        )
    for gate in spec.get("readinessGates") or []:
        conditions.append(
            {
                "lastTransitionTime": start_time,
                "status": "True",
                "type": gate.get("conditionType"),
            }
        )

    container_statuses = [
        {
            "image": c.get("image"),
            "name": c.get("name"),
            "ready": ready,
            "restartCount": 0,
            "state": _container_state(phase_name, start_time),
        }
        for c in spec.get("containers") or []
    ]
    init_statuses = [
        {
            "image": c.get("image"),
            "name": c.get("name"),
            "ready": True,
            "restartCount": 0,
            "state": {
                "terminated": {
                    "exitCode": 0,
                    "finishedAt": start_time,
                    "reason": "Completed",
                    "startedAt": start_time,
                }
            },
        }
        for c in spec.get("initContainers") or []
    ]

    return {
        "conditions": conditions,
        "containerStatuses": container_statuses,
        "initContainerStatuses": init_statuses,
        "hostIP": status.get("hostIP") or node_ip,
        "podIP": status.get("podIP") or pod_ip,
        "phase": phase_name,
        "startTime": start_time,
    }


# --- byte oracles ------------------------------------------------
# Canonical patch-body BYTES for the native emit paths' byte-identity
# oracles (tests/test_native_emit.py). Key order above is the wire order
# the codec emits; ensure_ascii=False matches its raw-UTF-8 escaping, so
# for bodies without the exotic control chars json encodes as \b / \f the
# comparison is byte-exact, not merely semantic.


def render_pod_status_body(
    pod: Mapping[str, Any],
    phase_name: str,
    cond_bits: int,
    node_ip: str,
    pod_ip: str,
) -> bytes:
    return json.dumps(
        {"status": render_pod_status(pod, phase_name, cond_bits, node_ip, pod_ip)},
        separators=(",", ":"), ensure_ascii=False,
    ).encode()


def render_heartbeat_body(cond_bits: int, now: str, start_time: str) -> bytes:
    return json.dumps(
        {"status": render_node_heartbeat(cond_bits, now, start_time)},
        separators=(",", ":"), ensure_ascii=False,
    ).encode()
