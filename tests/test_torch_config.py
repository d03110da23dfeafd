"""The port's config layer (kwok_tpu_torch.config) against kwok_tpu.config.

The same Stage documents go through both packages' ``Stage.from_doc`` and
``stages_to_rules``: the rule lists must be equal field for field, and so
must the ``compile_rules`` tables built from them (exact). The same files,
written once as YAML and once as JSON documents separated by ``---``
lines, load to equal documents in both packages, and ``apply_env_overrides``
gives equal options for the same environment. Without PyYAML the port
still reads the JSON form and refuses the YAML one loudly.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import sys

import numpy as np
import pytest
import yaml

from kwok_tpu import config as jcfg
from kwok_tpu import models as jm
from kwok_tpu.config import stages as jstages
from kwok_tpu.config import types as jtypes
from kwok_tpu.models import lifecycle as jl
from kwok_tpu_torch import config as tcfg
from kwok_tpu_torch import models as tm
from kwok_tpu_torch.config import stages as tstages
from kwok_tpu_torch.config import types as ttypes
from kwok_tpu_torch.models import lifecycle as tl

ARRAYS = ("from_mask", "deletion", "selector_bit", "delay_kind", "delay_a",
          "delay_b", "to_phase", "cond_assign", "cond_value", "is_delete",
          "weight")


def stage(name, kind="Pod", selector=None, delay=None, nxt=None, weight=None):
    spec = {
        "resourceRef": {"apiGroup": "v1", "kind": kind},
        "selector": selector if selector is not None else {"matchPhases": ["Pending"]},
        "next": nxt if nxt is not None else {"phase": "Running"},
    }
    if delay is not None:
        spec["delay"] = delay
    if weight is not None:
        spec["weight"] = weight
    return {"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "Stage",
            "metadata": {"name": name}, "spec": spec}


RUNNING = {"phase": "Running",
           "conditions": {"Initialized": True, "Ready": True, "ContainersReady": True}}

STAGE_SETS = {
    "constant": [
        stage("node-ready", kind="Node", selector={"matchPhases": ["Observed"]},
              delay={"duration": "1s"}, nxt={"phase": "Ready", "conditions": {"Ready": True}}),
        stage("pod-ready", delay={"duration": "300ms"}, nxt=RUNNING),
    ],
    "uniform": [stage("pod-ready", delay={"uniform": {"min": "100ms", "max": "1m30s"}}, nxt=RUNNING)],
    "exponential": [stage("pod-ready", delay={"exponential": {"mean": "30s", "cap": "5m"}}, nxt=RUNNING)],
    "weighted": [
        stage("pod-delete", selector={"matchPhases": [], "matchDeletion": "present"},
              nxt={"delete": True}),
        stage("fast", delay={"uniform": {"min": "0.1s", "max": "0.5s"}}, nxt=RUNNING, weight=3),
        stage("slow", delay={"uniform": {"min": "0.5s", "max": "1s"}}, nxt=RUNNING, weight=1),
    ],
    "deletion-modes": [
        stage("absent", selector={"matchPhases": ["Pending"], "matchDeletion": "absent"}),
        stage("present", selector={"matchPhases": ["Running"], "matchDeletion": "present"},
              nxt={"phase": "Succeeded", "conditions": {"Ready": False}}),
        stage("any", selector={"matchPhases": ["Succeeded"], "matchDeletion": "any",
                               "matchSelector": None}, nxt={"delete": True}),
        stage("on-node", selector={"matchPhases": ["Failed"],
                                   "matchSelector": "on-managed-node"}, delay={"duration": 2}),
    ],
}

BAD_STAGES = {
    "unknown-selector": stage("x", selector={"matchPhases": ["Pending"], "matchSelector": "heartbeat"}),
    "bad-deletion": stage("x", selector={"matchPhases": ["Pending"], "matchDeletion": "sometimes"}),
    "negative-weight": stage("x", weight=-1),
    "no-next-phase": stage("x", nxt={"conditions": {"Ready": True}}),
    "bad-kind": stage("x", kind="Service"),
}


def norm(x):
    """Dataclasses and enums of either package as plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    return x


def rules_of(lib, docs):
    S, kinds = (jstages, jl.ResourceKind) if lib == "jax" else (tstages, tl.ResourceKind)
    stages = [S.Stage.from_doc(d) for d in docs]
    return {k: S.stages_to_rules(stages, getattr(kinds, k)) for k in ("NODE", "POD")}


@pytest.mark.parametrize("name", sorted(STAGE_SETS))
def test_stages_to_rules_equal(name):
    ref = rules_of("jax", STAGE_SETS[name])
    got = rules_of("torch", STAGE_SETS[name])
    assert norm(got) == norm(ref)
    for kind in ("NODE", "POD"):
        if ref[kind] is None:
            assert got[kind] is None
            continue
        j = jm.compile_rules(ref[kind], getattr(jl.ResourceKind, kind))
        t = tm.compile_rules(got[kind], getattr(tl.ResourceKind, kind))
        for a in ARRAYS:
            x, y = getattr(j, a), getattr(t, a)
            assert x.dtype == y.dtype, a
            np.testing.assert_array_equal(y, x, err_msg=a)
        assert t.names == j.names
        assert t.selector_names == j.selector_names
        assert t.space.phases == j.space.phases


@pytest.mark.parametrize("name", sorted(STAGE_SETS))
def test_stage_to_doc_equal(name):
    j = [jstages.Stage.from_doc(d).to_doc() for d in STAGE_SETS[name]]
    t = [tstages.Stage.from_doc(d).to_doc() for d in STAGE_SETS[name]]
    assert t == j


@pytest.mark.parametrize("name", sorted(BAD_STAGES))
def test_bad_stage_rejected_alike(name):
    with pytest.raises(ValueError) as ej:
        jstages.Stage.from_doc(BAD_STAGES[name])
    with pytest.raises(ValueError) as et:
        tstages.Stage.from_doc(BAD_STAGES[name])
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("s", ["5s", "300ms", "1m30s", "2h", "0.5s", "2.5", 7, "", "1.5m"])
def test_parse_duration_equal(s):
    assert tstages.parse_duration(s) == jstages.parse_duration(s)


FILE_DOCS = [
    {"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "KwokConfiguration",
     "options": {"manageAllNodes": True, "cidr": "10.1.0.0/16", "tickInterval": 0.02,
                 "drainShards": 1, "unknownOption": 3}},
    *STAGE_SETS["weighted"],
    {"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "KwokctlConfiguration",
     "metadata": {"name": "c1"}, "options": {"runtime": "binary", "kubeApiserverPort": 6443},
     "components": [{"name": "etcd", "ports": [{"port": 2379}], "envs": [{"name": "A", "value": "b"}]}]},
    {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "other"}},
]


def write_files(tmp_path, docs):
    y = tmp_path / "kwok.yaml"
    y.write_text(yaml.safe_dump_all(docs, sort_keys=False))
    j = tmp_path / "kwok.json"
    j.write_text("---\n".join(json.dumps(d, indent=1) + "\n" for d in docs))
    return y, j


def loaded(lib, path):
    mod = jtypes if lib == "jax" else ttypes
    return [(type(d).__name__, norm(d)) for d in mod.load_documents(str(path))]


@pytest.mark.parametrize("form", ["yaml", "json"])
def test_load_documents_equal(tmp_path, form):
    y, j = write_files(tmp_path, FILE_DOCS)
    path = y if form == "yaml" else j
    ref = loaded("jax", y)  # the reference reads YAML; JSON is YAML too
    assert loaded("jax", path) == ref
    assert loaded("torch", path) == ref
    assert [k for k, _ in ref] == [
        "KwokConfiguration", "Stage", "Stage", "Stage", "KwokctlConfiguration", "dict"]


def test_load_documents_legacy_and_missing(tmp_path):
    legacy = tmp_path / "legacy.yaml"
    legacy.write_text("manageAllNodes: true\ncidr: 10.9.0.0/24\n")
    assert loaded("torch", legacy) == loaded("jax", legacy)
    legacy_json = tmp_path / "legacy.json"
    legacy_json.write_text('{"manageAllNodes": true, "cidr": "10.9.0.0/24"}\n')
    assert loaded("torch", legacy_json) == loaded("jax", legacy)
    assert loaded("torch", tmp_path / "absent.yaml") == loaded("jax", tmp_path / "absent.yaml") == []


ENVS = [
    {},
    {"KWOK_MANAGE_ALL_NODES": "true", "KWOK_CIDR": "10.8.0.0/24", "KWOK_PARALLELISM": "32"},
    {"KWOK_TICK_INTERVAL": "0.2", "KWOK_DRAIN_SHARDS": "3", "KWOK_LANE_PROCS": "yes",
     "KWOK_HA_ROLE": "standby", "KWOK_NODE_IP": "1.2.3.4", "KWOK_ENABLE_CNI": "0"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(sorted(e)) or "empty")
def test_apply_env_overrides_equal(tmp_path, env):
    y, _j = write_files(tmp_path, FILE_DOCS)
    jconf = jtypes.first_of(jtypes.load_documents(str(y)), jcfg.KwokConfiguration)
    tconf = ttypes.first_of(ttypes.load_documents(str(y)), tcfg.KwokConfiguration)
    jtypes.apply_env_overrides(jconf.options, environ=env)
    ttypes.apply_env_overrides(tconf.options, environ=env)
    assert dataclasses.asdict(tconf.options) == dataclasses.asdict(jconf.options)


@pytest.mark.parametrize("value,cap", [(0, 0), (0, 2), (1, 0), (5, 2), (-1, 0)])
def test_resolve_drain_shards_equal(value, cap):
    assert ttypes.resolve_drain_shards(value, cap) == jtypes.resolve_drain_shards(value, cap)


def test_without_pyyaml_json_loads_and_yaml_raises(tmp_path, monkeypatch):
    y, j = write_files(tmp_path, FILE_DOCS)
    ref = loaded("jax", y)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    assert loaded("torch", j) == ref
    with pytest.raises(RuntimeError, match="'yaml' module"):
        ttypes.load_documents(str(y))


def test_kubeconfig_json_without_pyyaml(tmp_path, monkeypatch):
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    kc = {
        "current-context": "c", "contexts": [{"name": "c", "context": {"cluster": "k", "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": "http://127.0.0.1:1234"}}],
        "users": [{"name": "u", "user": {"token": "tok"}}],
    }
    pj = tmp_path / "kubeconfig.json"
    pj.write_text(json.dumps(kc))
    py = tmp_path / "kubeconfig.yaml"
    py.write_text(yaml.safe_dump(kc))
    monkeypatch.setitem(sys.modules, "yaml", None)
    c = HttpKubeClient.from_kubeconfig(str(pj))
    assert (c.server, c.token) == ("http://127.0.0.1:1234", "tok")
    with pytest.raises(RuntimeError, match="'yaml' module"):
        HttpKubeClient.from_kubeconfig(str(py))
