"""Versioned config types + multi-doc config load/save + env overrides.

Mirrors pkg/apis/v1alpha1/kwok_configuration_types.go:30-81 and the loader in
pkg/config/config.go (Load: multi-doc YAML -> TypeMeta dispatch :67-84; Save
writes ---separated docs :138-192). Field names keep the reference's JSON
wire names so existing kwok.yaml files load unchanged.

PyYAML is imported only for a document that is not JSON: a file of JSON
documents separated by ``---`` lines is read with ``json`` alone (YAML is a
superset of JSON, so it means the same to a YAML reader). A YAML document
without PyYAML installed raises; it is never read as nothing. The files
this package writes (``save_documents``) are JSON documents separated by
``---`` lines, so any YAML reader loads them and this package reads them
back without PyYAML.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Iterable

GROUP_VERSION = "kwok.x-k8s.io/v1alpha1"
ENV_PREFIX = "KWOK_"


@dataclasses.dataclass
class KwokConfigurationOptions:
    """The kwok engine's options (kwok_configuration_types.go:30-81).
    Wire names in comments; defaults from the +default markers."""

    cidr: str = "10.0.0.1/24"
    nodeIP: str = "196.168.0.1"
    manageAllNodes: bool = False
    manageNodesWithAnnotationSelector: str = ""
    manageNodesWithLabelSelector: str = ""
    disregardStatusWithAnnotationSelector: str = ""
    disregardStatusWithLabelSelector: str = ""
    serverAddress: str = ""
    enableCNI: bool = False
    # engine extensions (not in the reference):
    tickInterval: float = 0.05
    tickSubsteps: int = 1
    heartbeatInterval: float = 30.0
    parallelism: int = 16
    initialCapacity: int = 4096
    # split every kind's rows over the visible cards (KWOK_USE_MESH)
    useMesh: bool = False
    # Host-lane sharding of the drain+emit pipeline: number of
    # hash-partitioned ShardLanes. 0 = auto (auto_drain_shards: cpu_count
    # capped by maxDrainShards); 1 = the classic single-lane engine.
    drainShards: int = 0
    # Cap on the AUTO lane count (0 = DEFAULT_MAX_DRAIN_SHARDS). With the
    # router's per-event Python term gone (native pre-partitioned
    # routing) lanes keep paying past 8 cores; this bounds fan-out on
    # very wide hosts without touching explicit drainShards values.
    maxDrainShards: int = 0
    # Process lanes (engine/proclanes.py): run each ShardLane as a
    # spawned worker PROCESS over shared-memory arenas instead of a
    # thread — the GIL escape. Default off: the threaded path is
    # byte-unchanged and no shm/process exists. Env: KWOK_LANE_PROCS
    # (the generic apply_env_overrides pass). Requires an HTTP master;
    # refused with useMesh, haRole, and federation.
    laneProcs: bool = False
    # Resilience (kwok_tpu/resilience/, docs/resilience.md):
    # deterministic fault-injection spec ("" = off; KWOK_TPU_FAULTS is
    # the engine-level fallback), lane-queue shed threshold (0 = never
    # shed), and the lane-worker restart budget per window.
    faults: str = ""
    shedQueueDepth: int = 0
    workerRestartBudget: int = 5
    workerRestartWindow: float = 30.0
    # Crash-durable restarts (resilience/checkpoint.py): directory for
    # the periodic atomic-rename checkpoint of device-resident timer
    # state ("" = disabled — no thread, no gathers; KWOK_TPU_CHECKPOINT_DIR
    # is the engine-level fallback), its cadence in seconds, and the
    # SIGTERM graceful-drain bound (flush in-flight emits + write a final
    # checkpoint within this many seconds, else force-exit nonzero; a
    # second SIGTERM force-exits immediately).
    checkpointDir: str = ""
    checkpointInterval: float = 2.0
    drainDeadline: float = 30.0
    # Anti-entropy auditor (resilience/antientropy.py): cadence in
    # seconds of the background apiserver-vs-rows drift pass (budgeted
    # LIST pages; detects + repairs silent divergence). 0 = off (the
    # default; KWOK_TPU_AUDIT_INTERVAL is the engine-level fallback).
    auditInterval: float = 0.0
    # Warm-standby HA (resilience/ha.py, docs/resilience.md): "" = off
    # (no elector, no fence — the zero-cost default). "primary" serves
    # while renewing the coordination.k8s.io Lease; "standby" observes
    # warm and takes over on lease expiry. Identity defaults to
    # hostname-pid; it doubles as the checkpoint file name so the
    # standby can tail the holder's stream. Env: KWOK_HA_ROLE,
    # KWOK_HA_IDENTITY, KWOK_LEASE_NAME, KWOK_LEASE_NAMESPACE,
    # KWOK_LEASE_DURATION, KWOK_LEASE_RENEW_INTERVAL (the generic
    # apply_env_overrides pass).
    haRole: str = ""
    haIdentity: str = ""
    leaseName: str = "kwok-tpu-engine"
    leaseNamespace: str = "kube-system"
    leaseDuration: float = 2.0
    leaseRenewInterval: float = 0.0


@dataclasses.dataclass
class KwokConfiguration:
    options: KwokConfigurationOptions = dataclasses.field(
        default_factory=KwokConfigurationOptions
    )

    KIND = "KwokConfiguration"

    def to_doc(self) -> dict:
        return {
            "apiVersion": GROUP_VERSION,
            "kind": self.KIND,
            "options": _prune(dataclasses.asdict(self.options)),
        }


def _prune(d: dict) -> dict:
    return {k: v for k, v in d.items() if v not in ("", None)}


# The auto lane-count ceiling. Historically 8: with the router hashing and
# dispatching every event in Python, lanes beyond ~8 bought nothing (the
# serial router was the wall — COSTMODEL_r06). Native pre-partitioned
# routing removed that term, so auto now follows the core count up to this
# cap (benchmarks/cost_model.py re-fit; override per deployment with
# --max-drain-shards / maxDrainShards / KWOK_MAX_DRAIN_SHARDS — the env
# form reaches the CLI through the generic apply_env_overrides pass over
# KwokConfigurationOptions, not through this module).
DEFAULT_MAX_DRAIN_SHARDS = 32


def auto_drain_shards(cores: int, max_shards: int = 0) -> int:
    """THE auto drain-shard policy — the single source the engine, the
    CLI, and the cost model all share (a drifted copy here once meant the
    model predicted a lane count the engine would never run)."""
    cap = max_shards if max_shards > 0 else DEFAULT_MAX_DRAIN_SHARDS
    return max(1, min(cap, int(cores)))


def resolve_drain_shards(value: int, max_shards: int = 0) -> int:
    """0/negative = auto: auto_drain_shards over this host's cpu_count."""
    v = int(value)
    if v > 0:
        return v
    return auto_drain_shards(os.cpu_count() or 1, max_shards)


def parse_bool(value: Any) -> bool:
    """The one truthy-string parser shared by every flag/env surface."""
    if value is None or isinstance(value, bool):
        return bool(value)
    return str(value).lower() in ("1", "true", "yes", "on")


def _coerce(value: str, target: Any) -> Any:
    if isinstance(target, bool):
        return parse_bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    return value


def apply_env_overrides(options: Any, environ=os.environ, prefix: str = ENV_PREFIX):
    """KWOK_<UPPER_SNAKE(field)> env vars override file values
    (vars.go GetEnvWithPrefix pattern)."""
    for f in dataclasses.fields(options):
        env_name = prefix + _upper_snake(f.name)
        if env_name in environ:
            setattr(
                options, f.name, _coerce(environ[env_name], getattr(options, f.name))
            )
    return options


def _upper_snake(camel: str) -> str:
    out = []
    for i, ch in enumerate(camel):
        if ch.isupper() and i > 0 and not camel[i - 1].isupper():
            out.append("_")
        out.append(ch.upper())
    return "".join(out)


def _options_from_doc(doc: dict) -> KwokConfigurationOptions:
    opts = KwokConfigurationOptions()
    for k, v in (doc.get("options") or {}).items():
        if hasattr(opts, k):
            setattr(opts, k, v)
    return opts


_DOC_SEPARATOR = re.compile(r"^---[ \t]*$", re.MULTILINE)


def parse_documents(text: str, source: str) -> list[Any]:
    """The documents of a multi-document config text: with ``json`` when
    every ``---``-separated document is JSON, else with PyYAML, which must
    then be installed (``source`` names the text in the error)."""
    chunks = [c for c in _DOC_SEPARATOR.split(text) if c.strip()]
    try:
        return [json.loads(c) for c in chunks]
    except ValueError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"{source} is YAML and reading it needs the 'yaml' module "
            "(PyYAML), which is not installed; install PyYAML or write "
            "the file as JSON documents separated by '---' lines"
        ) from e
    return list(yaml.safe_load_all(text))


def load_documents(path: str) -> list[Any]:
    """Load a multi-doc config file (YAML, or JSON documents separated by
    ``---`` lines) into typed objects.

    Unknown kinds are returned as raw dicts; docs without a GVK are treated
    as legacy KwokConfiguration options (compatibility.go:85)."""
    from kwok_tpu_torch.config.ctl import KwokctlConfiguration
    from kwok_tpu_torch.config.stages import Stage

    out: list[Any] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        text = f.read()
    for doc in parse_documents(text, path):
        if not doc:
            continue
        kind = doc.get("kind")
        if kind == KwokConfiguration.KIND:
            out.append(KwokConfiguration(options=_options_from_doc(doc)))
        elif kind == KwokctlConfiguration.KIND:
            out.append(KwokctlConfiguration.from_doc(doc))
        elif kind == Stage.KIND:
            out.append(Stage.from_doc(doc))
        elif kind is None and "apiVersion" not in doc:
            # legacy untyped options blob
            out.append(
                KwokConfiguration(options=_options_from_doc({"options": doc}))
            )
        else:
            out.append(doc)
    return out


def save_documents(path: str, docs: Iterable[Any]) -> None:
    """Write ``docs`` (typed objects or dicts) as JSON documents separated
    by ``---`` lines."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rendered = []
    for d in docs:
        doc = d.to_doc() if hasattr(d, "to_doc") else d
        rendered.append(json.dumps(doc, indent=2) + "\n")
    with open(path, "w") as f:
        f.write("---\n".join(rendered))


def first_of(docs: list[Any], cls) -> Any | None:
    for d in docs:
        if isinstance(d, cls):
            return d
    return None
