"""Lifecycle rule models (the port's own copy of ``kwok_tpu.models``).

Rules are data: a list of ``LifecycleRule``s (selector + delay + next
state) compiled by ``compile_rules`` into dense arrays that the tick kernel
in ``kwok_tpu_torch.ops`` executes.
"""

from kwok_tpu_torch.models.lifecycle import (
    Delay,
    LifecycleRule,
    PhaseSpace,
    ResourceKind,
    StatusEffect,
)
from kwok_tpu_torch.models.compiler import (
    CompiledRules,
    EmitTemplates,
    compile_emit_templates,
    compile_rules,
)
from kwok_tpu_torch.models.defaults import (
    default_node_rules,
    default_pod_rules,
    default_rules,
)

__all__ = [
    "Delay",
    "LifecycleRule",
    "PhaseSpace",
    "ResourceKind",
    "StatusEffect",
    "CompiledRules",
    "EmitTemplates",
    "compile_emit_templates",
    "compile_rules",
    "default_node_rules",
    "default_pod_rules",
    "default_rules",
]
