"""The port's kwok CLI (kwok_tpu_torch.kwok) against kwok_tpu.kwok.

- The JAX CLI (``--drain-shards 1``) and the port's (``KWOK_TPU_PLATFORM=cpu``),
  each against its own package's HTTP mock apiserver, given the same
  nodes, pods, deletes and constant-delay Stage file, end in the same
  apiserver objects with timestamps and resourceVersions masked (the
  order in which patches of different objects commit is a thread race).
- Both parsers have the same option strings and defaults.
- Every flag (and environment twin) that would switch on a subsystem the
  port lacks exits non-zero naming its ROADMAP item; so does the default
  cuda device on a host without a card. ``--faults`` and its two
  environment twins, refused until item 13a, now reach the engine's
  fault plane (``--faults off`` builds none). ``--lane-procs`` and its
  environment twin reach the engine's config (process lanes need an
  HTTP apiserver; with them off no arena is made). ``--checkpoint-dir``
  and its two environment twins start an engine with a checkpoint writer
  on that directory; the default ``--drain-shards`` runs the auto lane
  count.
- ``/readyz`` answers 503 until the first re-list is ingested, and
  ``/metrics`` carries the ``kwok_`` counters.

The HTTP tests own their ports: the CLI binds ``--server-address
127.0.0.1:0`` and the test reads the bound port off the server it built.
Their gates release only when the test says so, and a GET that times out
under load is retried, never read as an answer.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from kwok_tpu.edge.mockserver import HttpFakeApiserver as JaxServer
from kwok_tpu.kwok import cli as jcli
from kwok_tpu_torch.config.types import KwokConfigurationOptions
from kwok_tpu_torch.edge.mockserver import FakeKube as PortFakeKube
from kwok_tpu_torch.edge.mockserver import HttpFakeApiserver as PortServer
from kwok_tpu_torch.kwok import cli as tcli
from tests.test_metrics_exposition import check_chrome_trace
from tests.test_torch_engine import make_node, make_pod, masked

STAGES = [
    {"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "Stage",
     "metadata": {"name": "pod-delete"},
     "spec": {"resourceRef": {"apiGroup": "v1", "kind": "Pod"},
              "selector": {"matchPhases": ["Pending", "Running", "Succeeded", "Failed", "Terminating"],
                           "matchDeletion": "present", "matchSelector": "on-managed-node"},
              "next": {"delete": True}}},
    {"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "Stage",
     "metadata": {"name": "pod-running"},
     "spec": {"resourceRef": {"apiGroup": "v1", "kind": "Pod"},
              "selector": {"matchPhases": ["Pending"]},
              "delay": {"duration": "200ms"},
              "next": {"phase": "Running",
                       "conditions": {"Initialized": True, "Ready": True, "ContainersReady": True}}}},
]


def stage_file(tmp_path):
    p = tmp_path / "stages.json"
    p.write_text("---\n".join(json.dumps(d) + "\n" for d in STAGES))
    return str(p)


def base_args(tmp_path, master, config=None):
    return [
        "--master", master,
        "--kubeconfig", str(tmp_path / "no-kubeconfig"),  # force the master path
        "--manage-all-nodes", "true",
        "--tick-interval", "0.02",
        "--config", config or str(tmp_path / "absent.yaml"),
    ]


def run_cli(main, argv):
    """main(argv) on a thread; returns (stop event, thread, return codes)."""
    stop, rc = threading.Event(), []
    t = threading.Thread(target=lambda: rc.append(main(argv, stop_event=stop)), daemon=True)
    t.start()
    return stop, t, rc


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def running(p):
    st = p.get("status") or {}
    return st.get("phase") == "Running" and bool(st.get("podIP"))


def cli_scenario(lib, tmp_path, monkeypatch):
    """The same cluster through one package's CLI and HTTP mock; returns
    the final objects (masked) and the delete count."""
    srv = (JaxServer() if lib == "jax" else PortServer()).start()
    store = srv.store
    if lib == "torch":
        monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    try:
        for i in range(3):
            store.create("nodes", make_node(f"n{i}"))
        for i in range(6):
            store.create("pods", make_pod(f"p{i}", node=f"n{i % 3}",
                                          finalizers=["kwok.dev/guard"] if i == 0 else None))
        main = jcli.main if lib == "jax" else tcli.main
        # one patch worker: IPs go out in row order in both engines
        argv = base_args(tmp_path, srv.url, stage_file(tmp_path)) + [
            "--drain-shards", "1", "--parallelism", "1"]
        stop, t, rc = run_cli(main, argv)
        try:
            assert wait_for(lambda: all(running(p) for p in store.list("pods")))
            store.delete("pods", "default", "p0", grace_seconds=30)
            store.delete("pods", "default", "p1", grace_seconds=30)
            assert wait_for(lambda: len(store.list("pods")) == 4)
        finally:
            stop.set()
            t.join(30)
        assert rc == [0] and not t.is_alive()
        objs = {k: masked(store.list(k)) for k in ("nodes", "pods")}
        for o in objs["nodes"] + objs["pods"]:
            o["metadata"]["resourceVersion"] = "<rv>"
        return objs, store.delete_count
    finally:
        srv.stop()


def test_port_cli_matches_jax_cli(tmp_path, monkeypatch):
    ref = cli_scenario("jax", tmp_path, monkeypatch)
    got = cli_scenario("torch", tmp_path, monkeypatch)
    assert got == ref
    objs, deletes = got
    assert deletes == 2 and len(objs["pods"]) == 4
    assert all(c["status"] == "True" for n in objs["nodes"]
               for c in n["status"]["conditions"] if c["type"] == "Ready")


def parser_surface(build):
    p = build(KwokConfigurationOptions())
    return {
        tuple(a.option_strings): (a.dest, a.default, a.choices, a.nargs, type(a).__name__)
        for a in p._actions
    }


def test_parsers_have_the_same_flags_and_defaults():
    assert parser_surface(tcli.build_parser) == parser_surface(jcli.build_parser)


TWO = ["--master", "http://127.0.0.1:1,http://127.0.0.1:2"]

REFUSED = {
    # accepted since item 9b (None): rows split over the mesh
    "use-mesh": (["--use-mesh", "true"], {}, None),
    # refused as kwok_tpu refuses it (EngineConfig.validate)
    "lane-procs-use-mesh": (["--lane-procs", "true", "--use-mesh", "true"], {}, "kwok_tpu"),
    # accepted since item 12 (None): the role reaches the HA plane
    "ha-primary": (["--ha-role", "primary"], {}, None),
    "ha-standby": (["--ha-role", "standby"], {}, None),
    # accepted since item 13b (None): the interval reaches the auditor
    "audit-interval": (["--audit-interval", "5"], {}, None),
    # accepted since item 13a (None): the spec reaches the fault plane
    "faults": (["--faults", "seed=1;pump.drop=0.1"], {}, None),
    # accepted since item 14 (None): pod IPs from the CNI provider
    "enable-cni": (["--enable-cni", "true"], {}, None),
    # a federation splits its groups' stacked states over its mesh
    "two-masters": (TWO + ["--use-mesh", "true"], {}, None),
    "env-use-mesh": ([], {"KWOK_USE_MESH": "true"}, None),
    "env-ha-role": ([], {"KWOK_HA_ROLE": "standby"}, None),
    "env-audit-interval": ([], {"KWOK_AUDIT_INTERVAL": "2"}, None),
    "env-tpu-audit-interval": ([], {"KWOK_TPU_AUDIT_INTERVAL": "2"}, None),
    "env-faults": ([], {"KWOK_FAULTS": "seed=1"}, None),
    "env-tpu-faults": ([], {"KWOK_TPU_FAULTS": "seed=1"}, None),
    "env-enable-cni": ([], {"KWOK_ENABLE_CNI": "true"}, None),
}


def accepted_fault_spec(extra, env, monkeypatch):
    """The fault plane an accepted ``--faults`` form builds: the CLI's
    precedence (config < KWOK_* env < flag, then KWOK_TPU_FAULTS as the
    engine's fallback) up to a constructed engine."""
    from kwok_tpu.resilience.faults import FaultSpec as JaxSpec
    from kwok_tpu_torch.config.types import apply_env_overrides
    from kwok_tpu_torch.engine import ClusterEngine
    from kwok_tpu_torch.resilience.faults import FaultyClient

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opts = KwokConfigurationOptions()
    apply_env_overrides(opts)
    args = tcli.build_parser(opts).parse_args(extra + ["--manage-all-nodes", "true"])
    assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []
    cfg = tcli._engine_config(args, [], "cpu")
    eng = ClusterEngine(PortFakeKube(), cfg)
    assert eng._faults is not None and isinstance(eng.client, FaultyClient)
    text = (extra[1:2] or list(env.values()))[0]
    # the spec the plane runs is the one given, as kwok_tpu parses it
    assert eng._faults.spec.render() == JaxSpec.parse(text).render()
    return cfg


def accepted_cni(extra, env, monkeypatch) -> list:
    """EngineConfig.enable_cni that an accepted ``--enable-cni`` form
    gives, through the port's CLI and through kwok_tpu's."""
    from kwok_tpu.config.types import KwokConfigurationOptions as JaxOptions
    from kwok_tpu.config.types import apply_env_overrides as jax_env
    from kwok_tpu_torch.config.types import apply_env_overrides

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for lib in ("torch", "jax"):
        opts = KwokConfigurationOptions() if lib == "torch" else JaxOptions()
        (apply_env_overrides if lib == "torch" else jax_env)(opts)
        mod = tcli if lib == "torch" else jcli
        args = mod.build_parser(opts).parse_args(extra + ["--manage-all-nodes", "true"])
        if lib == "torch":
            assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []
            out.append(tcli._engine_config(args, [], "cpu").enable_cni)
        else:
            out.append(jcli._engine_config(args, []).enable_cni)
    return out


def accepted_ha(extra, env, monkeypatch) -> list:
    """The HA fields of EngineConfig that an accepted ``--ha-role`` form
    gives with the identity and lease flags (and KWOK_LEASE_DURATION),
    through the port's CLI and through kwok_tpu's; the port's engine
    builds its plane from them."""
    from kwok_tpu.config.types import KwokConfigurationOptions as JaxOptions
    from kwok_tpu.config.types import apply_env_overrides as jax_env
    from kwok_tpu_torch.config.types import apply_env_overrides
    from kwok_tpu_torch.engine import ClusterEngine
    from kwok_tpu_torch.resilience.ha import FencedClient

    monkeypatch.setenv("KWOK_LEASE_DURATION", "3")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    flags = extra + ["--manage-all-nodes", "true", "--ha-identity", "ident-a",
                     "--lease-name", "lz", "--lease-namespace", "ns-z",
                     "--lease-renew-interval", "0.5"]
    out = []
    for lib in ("torch", "jax"):
        opts = KwokConfigurationOptions() if lib == "torch" else JaxOptions()
        (apply_env_overrides if lib == "torch" else jax_env)(opts)
        mod = tcli if lib == "torch" else jcli
        args = mod.build_parser(opts).parse_args(flags)
        if lib == "torch":
            assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []
            cfg = tcli._engine_config(args, [], "cpu")
            eng = ClusterEngine(PortFakeKube(), cfg)
            assert isinstance(eng.client, FencedClient) and eng._ha_hold
            assert (eng._ha.role, eng._ha.identity, eng._ckpt_name) == (
                cfg.ha_role, "ident-a", "ident-a")
        else:
            cfg = jcli._engine_config(args, [])
        out.append((cfg.ha_role, cfg.ha_identity, cfg.lease_name, cfg.lease_namespace,
                    cfg.lease_duration, cfg.lease_renew_interval))
    return out


def accepted_mesh(extra, env, monkeypatch) -> list:
    """EngineConfig.use_mesh that an accepted ``--use-mesh`` form gives,
    through the port's CLI and through kwok_tpu's; the port's engine (or,
    with several masters, its federation) splits its rows over the CPU
    mesh that ``KWOK_TPU_PLATFORM=cpu`` asks for."""
    from kwok_tpu.config.types import KwokConfigurationOptions as JaxOptions
    from kwok_tpu.config.types import apply_env_overrides as jax_env
    from kwok_tpu_torch.config.types import apply_env_overrides
    from kwok_tpu_torch.engine import ClusterEngine, FederatedEngine
    from kwok_tpu_torch.ops.state import SplitState

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    masters = ["http://127.0.0.1:1", "http://127.0.0.1:2"] if extra[:1] == ["--master"] \
        else ["http://127.0.0.1:1"]
    out = []
    for lib in ("torch", "jax"):
        opts = KwokConfigurationOptions() if lib == "torch" else JaxOptions()
        (apply_env_overrides if lib == "torch" else jax_env)(opts)
        mod = tcli if lib == "torch" else jcli
        args = mod.build_parser(opts).parse_args(extra + ["--manage-all-nodes", "true"])
        if lib == "jax":
            out.append(jcli._engine_config(args, []).use_mesh)
            continue
        assert tcli.refusals(args, masters) == []
        cfg = tcli._engine_config(args, [], "cpu")
        out.append(cfg.use_mesh)
        if len(masters) > 1:
            fed = FederatedEngine([PortFakeKube(), PortFakeKube()], cfg)
            assert fed.mesh.devices == (torch.device("cpu"),)
            assert all(isinstance(st, SplitState) for g in fed.groups
                       for st in g.stacked.values())
            assert not any(e.config.use_mesh for e in fed.engines)
        else:
            eng = ClusterEngine(PortFakeKube(), cfg)
            assert eng._mesh.devices == (torch.device("cpu"),)
            assert eng._get_fused().mesh is eng._mesh
    return out


def audit_intervals(extra, env, monkeypatch, options=None) -> list:
    """(EngineConfig.audit_interval, the engine's resolved
    _audit_interval) that an accepted ``--audit-interval`` form gives,
    through the port's CLI and through kwok_tpu's: the config's
    ``auditInterval`` (``options``), then KWOK_AUDIT_INTERVAL, then the
    flag; KWOK_TPU_AUDIT_INTERVAL is the engine's fallback."""
    from kwok_tpu.config.types import KwokConfigurationOptions as JaxOptions
    from kwok_tpu.config.types import apply_env_overrides as jax_env
    from kwok_tpu.edge.mockserver import FakeKube as JaxFakeKube
    from kwok_tpu.engine import ClusterEngine as JaxEngine
    from kwok_tpu_torch.config.types import apply_env_overrides
    from kwok_tpu_torch.engine import ClusterEngine

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for lib in ("torch", "jax"):
        opts = KwokConfigurationOptions() if lib == "torch" else JaxOptions()
        for k, v in (options or {}).items():
            setattr(opts, k, v)
        (apply_env_overrides if lib == "torch" else jax_env)(opts)
        mod = tcli if lib == "torch" else jcli
        args = mod.build_parser(opts).parse_args(extra + ["--manage-all-nodes", "true"])
        if lib == "torch":
            assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []
            cfg = tcli._engine_config(args, [], "cpu")
            eng = ClusterEngine(PortFakeKube(), cfg)
        else:
            cfg = jcli._engine_config(args, [])
            eng = JaxEngine(JaxFakeKube(), cfg)
        out.append((cfg.audit_interval, eng._audit_interval))
    assert out[0] == out[1]
    return out[0]


AUDIT_PRECEDENCE = {
    # config file, then KWOK_AUDIT_INTERVAL, then the flag
    "config": ({"auditInterval": 3.0}, {}, [], 3.0),
    "env-over-config": ({"auditInterval": 3.0}, {"KWOK_AUDIT_INTERVAL": "4"}, [], 4.0),
    "flag-over-env": ({"auditInterval": 3.0}, {"KWOK_AUDIT_INTERVAL": "4"},
                      ["--audit-interval", "6"], 6.0),
    "flag-zero-falls-back-to-tpu-env": ({}, {"KWOK_TPU_AUDIT_INTERVAL": "1.5"},
                                        ["--audit-interval", "0"], 1.5),
}


@pytest.mark.parametrize("name", sorted(AUDIT_PRECEDENCE))
def test_audit_interval_precedence_matches_jax(name, monkeypatch):
    options, env, extra, want = AUDIT_PRECEDENCE[name]
    monkeypatch.delenv("KWOK_AUDIT_INTERVAL", raising=False)
    monkeypatch.delenv("KWOK_TPU_AUDIT_INTERVAL", raising=False)
    _cfg, resolved = audit_intervals(extra, env, monkeypatch, options)
    assert resolved == want


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_flag_exits_naming_roadmap_item(name, tmp_path, monkeypatch):
    extra, env, item = REFUSED[name]
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    if item is None and "audit" in name:
        cfg_value, resolved = audit_intervals(extra, env, monkeypatch)
        given = float((extra[1:2] or list(env.values()))[0])
        # the flag and KWOK_AUDIT_INTERVAL fill EngineConfig.audit_interval;
        # KWOK_TPU_AUDIT_INTERVAL stays the engine's own fallback
        assert cfg_value == (0.0 if "KWOK_TPU_AUDIT_INTERVAL" in env else given)
        assert resolved == given
        return
    if item is None and "cni" in name:
        assert accepted_cni(extra, env, monkeypatch) == [True, True]
        return
    if item is None and ("--use-mesh" in extra or "KWOK_USE_MESH" in env):
        assert accepted_mesh(extra, env, monkeypatch) == [True, True]
        return
    if item is None and "ha" in name:
        role = (extra[1:2] or list(env.values()))[0]
        assert accepted_ha(extra, env, monkeypatch) == [(role, "ident-a", "lz", "ns-z", 3.0, 0.5)] * 2
        return
    if item is None:
        cfg = accepted_fault_spec(extra, env, monkeypatch)
        # the flag and KWOK_FAULTS fill EngineConfig.faults;
        # KWOK_TPU_FAULTS stays the engine's own fallback, as in kwok_tpu
        assert cfg.faults == ("" if "KWOK_TPU_FAULTS" in env else
                              (extra[1:2] or list(env.values()))[0])
        return
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # port 1 has no apiserver: a refusal must come before any network wait
    with pytest.raises(SystemExit) as e:
        tcli.main(base_args(tmp_path, "http://127.0.0.1:1") + extra)
    assert isinstance(e.value.code, str), e.value.code  # exit status 1
    if item == "kwok_tpu":
        # the reference's own refusal, word for word
        from kwok_tpu.engine import EngineConfig as JaxConfig

        with pytest.raises(ValueError) as ref:
            JaxConfig(manage_all_nodes=True, lane_procs=True, use_mesh=True).validate()
        assert e.value.code == f"kwok: {ref.value}"
        return
    assert f"ROADMAP item {item}" in e.value.code


FEDERATION_MISUSE = {
    "member-config-one-master": (["--member-config", ""], {}, "multi-master"),
    "member-config-too-many": (TWO + ["--member-config", ""] * 3, {}, "given 3 times"),
    "member-config-missing": (TWO + ["--member-config", "absent.json"], {}, "no such file"),
    "lane-procs": (TWO + ["--lane-procs", "true"], {}, "single-cluster flag"),
    "env-lane-procs": (TWO, {"KWOK_LANE_PROCS": "true"}, "single-cluster flag"),
    "ha-role": (TWO + ["--ha-role", "primary"], {}, "single-cluster flag"),
    "env-ha-role": (TWO, {"KWOK_HA_ROLE": "standby"}, "single-cluster flag"),
}


@pytest.mark.parametrize("name", sorted(FEDERATION_MISUSE))
def test_federation_misuse_exits(name, tmp_path, monkeypatch):
    """The reference's own refusals around federation, before any network
    wait (ports 1 and 2 have no apiserver)."""
    extra, env, words = FEDERATION_MISUSE[name]
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        tcli.main(base_args(tmp_path, "http://127.0.0.1:1") + extra)
    assert words in str(e.value.code)


def test_member_config_without_stages_exits(tmp_path, monkeypatch):
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    empty = tmp_path / "member.json"
    empty.write_text(json.dumps({"apiVersion": "kwok.x-k8s.io/v1alpha1",
                                 "kind": "KwokConfiguration", "options": {}}) + "\n")
    with pytest.raises(SystemExit, match="no Stage documents"):
        tcli.main(base_args(tmp_path, "http://127.0.0.1:1") + TWO
                  + ["--member-config", "", "--member-config", str(empty)])


def test_member_config_is_positional(tmp_path):
    """The i-th --member-config applies to the i-th master; an empty value
    and a missing tail inherit --config."""
    from kwok_tpu_torch.config.stages import Stage
    from kwok_tpu_torch.config.types import load_documents

    base = [d for d in load_documents(stage_file(tmp_path)) if isinstance(d, Stage)]
    member = tmp_path / "member.json"
    member.write_text(json.dumps(STAGES[1]) + "\n")
    args = tcli.build_parser(KwokConfigurationOptions()).parse_args(
        ["--manage-all-nodes", "true", "--member-config", "", "--member-config", str(member)])
    cfgs = tcli.member_configs(args, base, 3, "cpu")
    names = [[r.name for r in c.pod_rules] for c in cfgs]
    assert names[0] == names[2] == ["pod-delete", "pod-running"]
    assert names[1] == ["pod-running"]
    assert tcli.member_configs(
        tcli.build_parser(KwokConfigurationOptions()).parse_args([]), base, 2, "cpu") is None


def test_federation_without_card_exits(tmp_path, monkeypatch):
    monkeypatch.delenv("KWOK_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(base_args(tmp_path, "http://127.0.0.1:1") + TWO)
    assert "CUDA" in str(e.value.code)


CHECKPOINT_DIR_FORMS = {
    "checkpoint-dir": (True, {}),
    "env-checkpoint-dir": (False, {"KWOK_CHECKPOINT_DIR": "DIR"}),
    "env-tpu-checkpoint-dir": (False, {"KWOK_TPU_CHECKPOINT_DIR": "DIR"}),
}


@pytest.mark.parametrize("name", sorted(CHECKPOINT_DIR_FORMS))
def test_checkpoint_dir_arms_a_checkpointer(name, tmp_path, monkeypatch):
    """The flag and both environment forms start the engine with a
    Checkpointer on that directory, which writes the final checkpoint
    there at stop."""
    import kwok_tpu_torch.engine as engine_mod

    flag, env = CHECKPOINT_DIR_FORMS[name]
    ckpt_dir = str(tmp_path / "ckpt")
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("KWOK_TPU_CHECKPOINT_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v.replace("DIR", ckpt_dir))
    engines = []

    class Recorded(engine_mod.ClusterEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(engine_mod, "ClusterEngine", Recorded)
    srv = PortServer().start()
    srv.store.create("nodes", make_node("n0"))
    argv = base_args(tmp_path, srv.url) + ["--checkpoint-interval", "0.2",
                                           "--drain-shards", "2"]
    if flag:
        argv += ["--checkpoint-dir", ckpt_dir]
    stop, t, rc = run_cli(tcli.main, argv)
    try:
        assert wait_for(lambda: engines and engines[0].ready)
        eng = engines[0]
        assert eng._ckpt is not None and eng._ckpt.directory == ckpt_dir
    finally:
        stop.set()
        t.join(30)
        srv.stop()
    assert rc == [0]
    doc = json.load(open(os.path.join(ckpt_dir, "engine.ckpt.json")))
    assert list(doc["kinds"]["nodes"]) == ["n0"]


# the tracing flags and env of ROADMAP item 15: (extra argv, env, masters,
# what must hold after stop); DIR is the test's directory
TRACING_FORMS = {
    "profile-dir": (["--profile-dir", "DIR/prof"], {}, 1, "profile"),
    "trace-dump": (["--trace-dump", "DIR/trace.json"], {}, 1, "trace"),
    "env-tpu-trace": ([], {"KWOK_TPU_TRACE": "DIR/trace.json"}, 1, "trace"),
    "trace-sample-every": (["--trace-dump", "DIR/trace.json",
                            "--trace-sample-every", "1"], {}, 1, "sampled"),
    # a federation writes ONE merged document of its loop and members
    "member-config": (["--member-config", "", "--trace-dump", "DIR/trace.json"],
                      {}, 2, "merged"),
}


@pytest.mark.parametrize("name", sorted(TRACING_FORMS))
def test_tracing_flags_reach_the_engine(name, tmp_path, monkeypatch):
    """--profile-dir, --trace-dump, KWOK_TPU_TRACE and
    --trace-sample-every reach EngineConfig and run: the engine starts,
    patches its pods, and after stop the profile or the span trace is on
    disk (a federation's with every member's spans under shard<i>)."""
    import kwok_tpu_torch.engine as engine_mod

    extra, env, n_masters, want = TRACING_FORMS[name]
    d = str(tmp_path)
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("KWOK_TPU_TRACE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v.replace("DIR", d))
    built = []
    cls = "FederatedEngine" if n_masters > 1 else "ClusterEngine"

    class Recorded(getattr(engine_mod, cls)):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(engine_mod, cls, Recorded)
    srvs = [PortServer().start() for _ in range(n_masters)]
    for c, srv in enumerate(srvs):
        srv.store.create("nodes", make_node(f"n{c}"))
    argv = base_args(tmp_path, ",".join(s.url for s in srvs)) + [
        "--drain-shards", "2", *(a.replace("DIR", d) for a in extra)]
    stop, t, rc = run_cli(tcli.main, argv)
    try:
        # pods in waves, each after the last is Running: an idle engine
        # does not tick, and the profile window opens at tick 2
        for i in range(4):
            for c, srv in enumerate(srvs):
                srv.store.create("pods", make_pod(f"p{c}-{i}", node=f"n{c}"))
            assert wait_for(lambda: all(
                running(p) for s in srvs for p in s.store.list("pods")))
        eng = built[0]
        assert eng.metrics["ticks_total"] >= 4
    finally:
        stop.set()
        t.join(60)
        for s in srvs:
            s.stop()
    assert rc == [0] and not t.is_alive()
    cfg = eng.config
    if want == "profile":
        assert cfg.profile_dir == f"{d}/prof"
        meta = eng._profiler.meta
        assert meta is not None and meta["ticks"][0] == 2, meta
        trace = json.load(open(os.path.join(cfg.profile_dir, meta["trace"])))
        assert any(ev.get("ph") == "X" for ev in trace["traceEvents"])
        return
    path = os.path.join(d, "trace.json")
    assert (cfg.trace_dump or os.environ["KWOK_TPU_TRACE"]) == path
    doc = json.load(open(path))
    check_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"tick.dispatch", "tick.consume"} <= names, names
    if want == "sampled":
        assert cfg.trace_sample_every == 1
        assert "pod.ingest_to_patch" in names, names
    if want == "merged":
        labels = {e["args"]["name"] for e in doc["traceEvents"]
                  if e["name"] == "process_name"}
        assert labels == {"federation", "shard0", "shard1"}, labels


def test_cli_flags_reach_engine_config():
    p = tcli.build_parser(KwokConfigurationOptions())
    args = p.parse_args([
        "--shed-queue-depth", "128", "--checkpoint-dir", "/var/ckpt-here",
        "--checkpoint-interval", "0.75", "--manage-all-nodes", "true",
    ])
    cfg = tcli._engine_config(args, [], "cpu")
    assert cfg.shed_queue_depth == 128
    assert cfg.checkpoint_dir == "/var/ckpt-here"
    assert cfg.checkpoint_interval == 0.75


LANE_PROCS_FORMS = {
    "lane-procs": (["--lane-procs", "true"], {}),
    "env-lane-procs": ([], {"KWOK_LANE_PROCS": "true"}),
}


@pytest.mark.parametrize("name", sorted(LANE_PROCS_FORMS))
def test_lane_procs_reaches_engine_config(name, monkeypatch):
    """The flag and its environment twin turn on process lanes (the
    refusal of earlier slices is gone), along with the watchdog budget
    flags."""
    from kwok_tpu_torch.config.types import apply_env_overrides

    extra, env = LANE_PROCS_FORMS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    opts = KwokConfigurationOptions()
    apply_env_overrides(opts)
    args = tcli.build_parser(opts).parse_args(extra + [
        "--worker-restart-budget", "3", "--worker-restart-window", "12.5"])
    assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []
    cfg = tcli._engine_config(args, [], "cpu")
    assert cfg.lane_procs is True
    assert (cfg.worker_restart_budget, cfg.worker_restart_window) == (3, 12.5)


def test_lane_procs_without_http_master_raises():
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

    with pytest.raises(ValueError, match="HTTP"):
        ClusterEngine(PortFakeKube(), EngineConfig(
            manage_all_nodes=True, drain_shards=2, lane_procs=True, device="cpu"))


def test_lane_procs_off_creates_no_process_lanes_or_arena(monkeypatch):
    """Threaded lanes over HTTP: no ProcLaneSet, and no shared-memory
    arena is ever made."""
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
    from kwok_tpu_torch.engine import shm as tshm
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    def no_arena(*a, **kw):
        raise AssertionError("a shared-memory arena was created")

    monkeypatch.setattr(tshm, "Arena", no_arena)
    srv = PortServer().start()
    srv.store.create("nodes", make_node("n0"))
    eng = ClusterEngine(HttpKubeClient(srv.url), EngineConfig(
        manage_all_nodes=True, drain_shards=2, device="cpu"))
    try:
        assert eng._proc is None and eng._lanes is not None
        eng.start()
        assert wait_for(lambda: eng.ready)
    finally:
        eng.stop()
        srv.stop()


def test_default_flags_run_the_auto_lane_count():
    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.engine import ClusterEngine

    args = tcli.build_parser(KwokConfigurationOptions()).parse_args(
        ["--manage-all-nodes", "true"])
    assert args.drain_shards == 0
    eng = ClusterEngine(PortFakeKube(), tcli._engine_config(args, [], "cpu"))
    n = resolve_drain_shards(0, args.max_drain_shards)
    assert (eng._lanes.n if eng._lanes is not None else 1) == n


def test_faults_off_builds_no_plane(monkeypatch):
    """``--faults off`` wins over an inherited KWOK_TPU_FAULTS: no plane,
    the client unwrapped (the zero-cost contract)."""
    from kwok_tpu_torch.engine import ClusterEngine

    monkeypatch.setenv("KWOK_TPU_FAULTS", "seed=1;pump.drop=1.0")
    args = tcli.build_parser(KwokConfigurationOptions()).parse_args(
        ["--faults", "off", "--manage-all-nodes", "true"])
    assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []
    kube = PortFakeKube()
    eng = ClusterEngine(kube, tcli._engine_config(args, [], "cpu"))
    assert eng._faults is None and eng.client is kube


def test_ha_role_off_and_defaults_are_not_refused(tmp_path):
    args = tcli.build_parser(KwokConfigurationOptions()).parse_args(["--ha-role", "off"])
    assert tcli.refusals(args, ["http://127.0.0.1:1"]) == []


def test_cuda_default_without_card_exits(tmp_path, monkeypatch):
    monkeypatch.delenv("KWOK_TPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(base_args(tmp_path, "http://127.0.0.1:1"))
    assert "CUDA" in str(e.value.code)
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="cuda or cpu"):
        tcli.main(base_args(tmp_path, "http://127.0.0.1:1"))


def test_module_entry_point_exits_nonzero_without_card(tmp_path):
    """``python -m kwok_tpu_torch.kwok`` with no card and no
    KWOK_TPU_PLATFORM=cpu ends with a non-zero status; it does not run on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda engine would start")
    env = {k: v for k, v in os.environ.items() if k != "KWOK_TPU_PLATFORM"}
    r = subprocess.run(
        [sys.executable, "-m", "kwok_tpu_torch.kwok", *base_args(tmp_path, "http://127.0.0.1:1")],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode != 0
    assert "CUDA" in r.stderr


class GatedStore(PortFakeKube):
    """A store whose LISTs after the first (the CLI's apiserver probe)
    wait for ``gate``: the engine's first re-list is held back until the
    test sets it (its ``finally`` always does)."""

    def __init__(self) -> None:
        super().__init__()
        self.gate = threading.Event()
        self.lists = 0

    def list_bytes(self, kind, **kw):
        self.lists += 1
        if self.lists > 1:
            self.gate.wait()
        return super().list_bytes(kind, **kw)


def record_servers(monkeypatch) -> list:
    """The EngineServers the CLI builds, so a test that passes
    ``--server-address 127.0.0.1:0`` reads the port the server bound."""
    from kwok_tpu_torch.kwok import server as server_mod

    servers = []

    class Recorded(server_mod.EngineServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(server_mod, "EngineServer", Recorded)
    return servers


def serving_base(servers) -> str:
    assert wait_for(lambda: servers), "the CLI built no EngineServer"
    return f"http://127.0.0.1:{servers[0].port}"


def get(url, deadline_s: float = 60.0):
    """(status, reason or body) of a GET. A timeout or a refused
    connection is retried until ``deadline_s``, then fails the test:
    under load a slow answer is never read as a wrong one."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            with urllib.request.urlopen(url, timeout=10) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.reason
        except OSError as e:
            if time.monotonic() >= deadline:
                raise AssertionError(f"GET {url}: no answer in {deadline_s} s ({e})") from e
            time.sleep(0.05)


def test_readyz_503_until_first_relist_and_metrics(tmp_path, monkeypatch):
    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    store = GatedStore()
    store.create("nodes", make_node("n0"))
    store.create("pods", make_pod("p0", node="n0"))
    srv = PortServer(store=store).start()
    servers = record_servers(monkeypatch)
    stop, t, rc = run_cli(tcli.main, base_args(tmp_path, srv.url) + [
        "--server-address", "127.0.0.1:0"])
    try:
        base = serving_base(servers)
        assert wait_for(lambda: get(base + "/healthz")[0] == 200)
        assert wait_for(lambda: store.lists > 1)  # the engine's re-list waits
        assert get(base + "/readyz") == (503, "startup_resync")
        assert get(base + "/livez")[0] == 200
        store.gate.set()
        assert wait_for(lambda: get(base + "/readyz")[0] == 200)
        assert wait_for(lambda: running(store.get("pods", "default", "p0")))
        code, body = get(base + "/debug/trace")
        assert code == 200
        doc = json.loads(body)
        check_chrome_trace(doc)
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert {"tick.dispatch", "tick.consume"} <= names, names
        code, text = get(base + "/metrics")
        assert code == 200
        samples = dict(
            line.rsplit(" ", 1) for line in text.splitlines()
            if line and not line.startswith("#")
        )
        for name in ("kwok_ticks_total", "kwok_status_patches_total",
                     "kwok_watch_relists_total", "kwok_ingest_queue_depth",
                     "kwok_nodes_managed", "kwok_pods_managed",
                     "process_cpu_seconds_total"):
            assert name in samples, name
        assert float(samples["kwok_ticks_total"]) > 0
        assert float(samples["kwok_status_patches_total"]) >= 2
        assert "# TYPE kwok_ticks_total counter" in text
        assert "# TYPE kwok_pods_managed gauge" in text
    finally:
        store.gate.set()
        stop.set()
        t.join(30)
        srv.stop()
    assert rc == [0]


def test_signal_handler_and_stop_deadline():
    stop = threading.Event()
    forced = []
    h = tcli.make_signal_handler(stop, force_exit=forced.append)
    h(tcli.signal.SIGTERM)
    assert stop.is_set() and forced == []
    h(tcli.signal.SIGTERM)
    assert forced == [130]
    ran = []
    tcli.stop_with_deadline([lambda: ran.append(1)], 5.0, force_exit=forced.append)
    assert ran == [1] and forced == [130]


def test_two_master_federation_over_http(tmp_path, monkeypatch):
    """``--master A,B`` runs one member per apiserver from one process:
    /readyz is 503 until BOTH members' first re-list is in (member B's is
    held back) and while a member is degraded; /metrics carries per-shard
    series and one dispatch counter per rule-set group (member B's
    --member-config makes a second group)."""
    import kwok_tpu_torch.engine as engine_mod

    monkeypatch.setenv("KWOK_TPU_PLATFORM", "cpu")
    feds = []

    class Recorded(engine_mod.FederatedEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            feds.append(self)

    monkeypatch.setattr(engine_mod, "FederatedEngine", Recorded)
    gated = GatedStore()
    srvs = [PortServer().start(), PortServer(store=gated).start()]
    member = tmp_path / "member.json"
    member.write_text(json.dumps(STAGES[1]) + "\n")
    for c, srv in enumerate(srvs):
        srv.store.create("nodes", make_node(f"n{c}"))
        for i in range(3):
            srv.store.create("pods", make_pod(f"p{c}-{i}", node=f"n{c}"))
    servers = record_servers(monkeypatch)
    argv = base_args(tmp_path, f"{srvs[0].url},{srvs[1].url}", stage_file(tmp_path)) + [
        "--server-address", "127.0.0.1:0",
        "--member-config", "", "--member-config", str(member)]
    stop, t, rc = run_cli(tcli.main, argv)
    try:
        base = serving_base(servers)
        assert wait_for(lambda: get(base + "/healthz")[0] == 200)
        assert wait_for(lambda: gated.lists > 1)  # member 1's re-list waits
        assert wait_for(lambda: all(running(p) for p in srvs[0].store.list("pods")))
        assert get(base + "/readyz") == (503, "startup_resync")
        gated.gate.set()
        assert wait_for(lambda: get(base + "/readyz")[0] == 200)
        assert wait_for(lambda: all(running(p) for srv in srvs for p in srv.store.list("pods")))
        fed = feds[0]
        assert [len(g.engines) for g in fed.groups] == [1, 1]
        fed.engines[1]._degradation.set("checkpoint")
        code, reason = get(base + "/readyz")
        assert code == 503 and "member1:checkpoint" in reason
        fed.engines[1]._degradation.clear("checkpoint")
        assert get(base + "/readyz")[0] == 200
        code, text = get(base + "/metrics")
        assert code == 200
    finally:
        gated.gate.set()
        stop.set()
        t.join(30)
        for srv in srvs:
            srv.stop()
    assert rc == [0] and not t.is_alive()
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line and not line.startswith("#"))
    for c in (0, 1):
        assert float(samples[f'kwok_status_patches_total{{shard="{c}"}}']) >= 4  # node + 3 pods
        assert float(samples[f'kwok_group_dispatches_total{{group="{c}"}}']) > 0
    assert float(samples["kwok_fed_pods_managed"]) == 6
    assert "kwok_status_patches_total" not in samples  # per shard only
    assert text.count("# TYPE kwok_ticks_total counter") == 1
    assert "process_cpu_seconds_total" in samples
