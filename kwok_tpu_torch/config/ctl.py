"""KwokctlConfiguration: the orchestrator's config type.

Mirrors pkg/apis/v1alpha1/kwokctl_configuration_types.go:34-363 (options,
Component/Port/Env/Volume) with the same JSON wire names, so saved cluster
kwok.yaml files stay compatible with the reference's format. Defaulting logic
lives in kwok_tpu.kwokctl.vars (the analogue of pkg/config/vars.go); kwokctl
is not part of the port yet, and the kwok CLI only needs the type to
dispatch a config file's documents on their kind.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from kwok_tpu_torch.config.types import GROUP_VERSION, _prune


@dataclasses.dataclass
class Port:
    port: int = 0
    hostPort: int = 0
    name: str = ""
    protocol: str = "TCP"


@dataclasses.dataclass
class Env:
    name: str = ""
    value: str = ""


@dataclasses.dataclass
class Volume:
    name: str = ""
    readOnly: bool = False
    hostPath: str = ""
    mountPath: str = ""


@dataclasses.dataclass
class Component:
    """Declarative process/container spec (kwokctl_configuration_types.go:263).

    Links encode the start-order dependency graph consumed by
    kwokctl's group_by_links.
    """

    name: str = ""
    links: list[str] = dataclasses.field(default_factory=list)
    binary: str = ""
    image: str = ""
    command: list[str] = dataclasses.field(default_factory=list)
    args: list[str] = dataclasses.field(default_factory=list)
    workDir: str = ""
    ports: list[Port] = dataclasses.field(default_factory=list)
    envs: list[Env] = dataclasses.field(default_factory=list)
    volumes: list[Volume] = dataclasses.field(default_factory=list)
    version: str = ""

    def to_doc(self) -> dict:
        d = dataclasses.asdict(self)
        d["ports"] = [_prune(p) for p in d["ports"]]
        d["envs"] = [_prune(e) for e in d["envs"]]
        d["volumes"] = [_prune(v) for v in d["volumes"]]
        return {k: v for k, v in d.items() if v not in ("", None, [], {})}

    @classmethod
    def from_doc(cls, doc: dict) -> "Component":
        c = cls()
        for k, v in doc.items():
            if k == "ports":
                c.ports = [_sub(Port, p) for p in v or []]
            elif k == "envs":
                c.envs = [_sub(Env, e) for e in v or []]
            elif k == "volumes":
                c.volumes = [_sub(Volume, x) for x in v or []]
            elif hasattr(c, k):
                setattr(c, k, v)
        return c


def _sub(cls, doc: dict):
    obj = cls()
    for k, v in (doc or {}).items():
        if hasattr(obj, k):
            setattr(obj, k, v)
    return obj


@dataclasses.dataclass
class KwokctlConfigurationOptions:
    """kwokctl_configuration_types.go:35-261 — wire names preserved."""

    runtime: str = ""
    mode: str = ""
    kubeApiserverPort: int = 0
    prometheusPort: int = 0
    kwokVersion: str = ""
    kubeVersion: str = ""
    etcdVersion: str = ""
    prometheusVersion: str = ""
    securePort: bool | None = None
    quietPull: bool = False
    disableKubeScheduler: bool = False
    disableKubeControllerManager: bool = False
    kubeFeatureGates: str = ""
    kubeRuntimeConfig: str = ""
    kubeAuditPolicy: str = ""
    kubeAuthorization: bool = False
    binSuffix: str = ""
    kubeBinaryPrefix: str = ""
    kubeApiserverBinary: str = ""
    kubeControllerManagerBinary: str = ""
    kubeSchedulerBinary: str = ""
    kubectlBinary: str = ""
    etcdBinaryPrefix: str = ""
    etcdBinary: str = ""
    etcdBinaryTar: str = ""
    kwokBinaryPrefix: str = ""
    kwokControllerBinary: str = ""
    prometheusBinaryPrefix: str = ""
    prometheusBinary: str = ""
    prometheusBinaryTar: str = ""
    etcdPeerPort: int = 0
    etcdPort: int = 0
    kubeControllerManagerPort: int = 0
    kubeSchedulerPort: int = 0
    kwokControllerPort: int = 0
    cacheDir: str = ""
    # image-mode options (compose/kind runtimes; types.go image fields)
    kubeImagePrefix: str = ""
    etcdImagePrefix: str = ""
    kwokImagePrefix: str = ""
    prometheusImagePrefix: str = ""
    kindNodeImagePrefix: str = ""
    etcdImage: str = ""
    kubeApiserverImage: str = ""
    kubeControllerManagerImage: str = ""
    kubeSchedulerImage: str = ""
    kwokControllerImage: str = ""
    prometheusImage: str = ""
    kindNodeImage: str = ""
    dockerComposeVersion: str = ""
    dockerComposeBinaryPrefix: str = ""
    dockerComposeBinary: str = ""
    kindVersion: str = ""
    kindBinaryPrefix: str = ""
    kindBinary: str = ""
    # engine knobs passed through to the kwok component
    # (not in the reference):
    tickInterval: float = 0.05
    useMesh: bool = False
    # apiserver bind address; 0.0.0.0 makes a containerized cluster
    # reachable through published ports (images/cluster)
    bindAddress: str = "127.0.0.1"


@dataclasses.dataclass
class KwokctlConfiguration:
    options: KwokctlConfigurationOptions = dataclasses.field(
        default_factory=KwokctlConfigurationOptions
    )
    components: list[Component] = dataclasses.field(default_factory=list)
    name: str = ""

    KIND = "KwokctlConfiguration"

    def to_doc(self) -> dict:
        doc: dict[str, Any] = {
            "apiVersion": GROUP_VERSION,
            "kind": self.KIND,
        }
        if self.name:
            doc["metadata"] = {"name": self.name}
        doc["options"] = _prune(dataclasses.asdict(self.options))
        if self.components:
            doc["components"] = [c.to_doc() for c in self.components]
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "KwokctlConfiguration":
        opts = KwokctlConfigurationOptions()
        for k, v in (doc.get("options") or {}).items():
            if hasattr(opts, k):
                setattr(opts, k, v)
        comps = [Component.from_doc(c) for c in doc.get("components") or []]
        name = ((doc.get("metadata") or {}).get("name")) or ""
        return cls(options=opts, components=comps, name=name)
