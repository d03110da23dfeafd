"""The port's rule compiler (kwok_tpu_torch.models) equals kwok_tpu.models
for the default, chaos and weighted rule sets (exact), and its host-side
matchers agree with the JAX package's."""

from __future__ import annotations

import numpy as np
import pytest

from kwok_tpu import models as jm
from kwok_tpu.models import compiler as jc
from kwok_tpu.models import defaults as jd
from kwok_tpu.models import lifecycle as jl
from kwok_tpu_torch import models as tm
from kwok_tpu_torch.models import compiler as tc
from kwok_tpu_torch.models import defaults as td
from kwok_tpu_torch.models import lifecycle as tl

ARRAYS = ("from_mask", "deletion", "selector_bit", "delay_kind", "delay_a",
          "delay_b", "to_phase", "cond_assign", "cond_value", "is_delete",
          "weight")


def weighted(lib, weights):
    L = jl if lib == "jax" else tl
    to = ["Running", "Succeeded", "Failed", "Terminating"]
    return [
        L.LifecycleRule(
            name=f"w{i}", resource=L.ResourceKind.POD, from_phases=("Pending",),
            effect=L.StatusEffect(to_phase=to[i]),
            delay=L.Delay.uniform(0.5, 2.0), weight=w,
        )
        for i, w in enumerate(weights)
    ]


RULE_SETS = {
    "default-nodes": (lambda: jd.default_node_rules(), lambda: td.default_node_rules(), "NODE"),
    "default-pods": (lambda: jd.default_pod_rules(), lambda: td.default_pod_rules(), "POD"),
    "chaos": (lambda: jd.chaos_pod_rules(5.0), lambda: td.chaos_pod_rules(5.0), "POD"),
    "weighted": (lambda: weighted("jax", [1, 0, 3, 2]), lambda: weighted("torch", [1, 0, 3, 2]), "POD"),
}


def tables(name):
    jr, tr, kind = RULE_SETS[name]
    return (jm.compile_rules(jr(), getattr(jl.ResourceKind, kind)),
            tm.compile_rules(tr(), getattr(tl.ResourceKind, kind)))


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_compile_rules_equal(name):
    j, t = tables(name)
    for a in ARRAYS:
        x, y = getattr(j, a), getattr(t, a)
        assert x.dtype == y.dtype, a
        np.testing.assert_array_equal(y, x, err_msg=a)
    assert t.names == j.names
    assert t.selector_names == j.selector_names
    assert t.space.phases == j.space.phases
    assert t.space.conditions == j.space.conditions
    assert t.resource.value == j.resource.value


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_host_matchers_equal(name):
    j, t = tables(name)
    rng = np.random.default_rng(3)
    for _ in range(200):
        phase = int(rng.integers(0, len(j.space.phases)))
        sel = int(rng.integers(0, 16))
        has_del = bool(rng.random() < 0.5)
        u2 = float(rng.random())
        mj = jc.match_rules_host(j, phase, sel, has_del)
        mt = tc.match_rules_host(t, phase, sel, has_del)
        assert mt == mj
        assert tc.choose_rule_host(t, mt, u2) == jc.choose_rule_host(j, mj, u2)
