"""Config system: config file + KWOK_* env + CLI flags, three-layer
precedence (file < env < flags), mirroring pkg/config
(config.go:67-84, vars.go:100-445, flags.go:34-63).

Wire format: multi-doc YAML (or JSON documents separated by ``---`` lines,
which needs no PyYAML) with apiVersion kwok.x-k8s.io/v1alpha1 and kinds
KwokConfiguration / KwokctlConfiguration / Stage; documents without a GVK
are treated as a legacy KwokConfiguration options blob
(compatibility.go:85).
"""

from kwok_tpu_torch.config.types import (
    GROUP_VERSION,
    KwokConfiguration,
    KwokConfigurationOptions,
    first_of,
    load_documents,
)
from kwok_tpu_torch.config.ctl import (
    Component,
    Env,
    KwokctlConfiguration,
    KwokctlConfigurationOptions,
    Port,
    Volume,
)
from kwok_tpu_torch.config.stages import Stage, stages_to_rules

__all__ = [
    "GROUP_VERSION",
    "Component",
    "Env",
    "KwokConfiguration",
    "KwokConfigurationOptions",
    "KwokctlConfiguration",
    "KwokctlConfigurationOptions",
    "Port",
    "Stage",
    "Volume",
    "first_of",
    "stages_to_rules",
    "load_documents",
]
