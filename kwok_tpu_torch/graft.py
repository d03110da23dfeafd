"""The port's twin of ``__graft_entry__.entry()``: the flagship step.

``entry(device="cuda")`` returns ``(step, example_args)``. ``step(state,
now, seed)`` advances a pod population one dispatch through the tick
kernel (``csrc/tick.cu``, launched by ``ops/cuda_tick.tick_steps``) and
returns ``(dirty, deleted, hb_fired, counts)``; the state is updated in
place. The workload is ``__graft_entry__.entry()``'s:

- 65,536 pod rows, every row active with ``sel_bits`` 0b11 (on a managed
  node, managed), as ``__graft_entry__._seeded_pod_state`` seeds them;
- the chaos rules, ``chaos_pod_rules(mean_run_seconds=5.0)``: the default
  pod lifecycle, then completion after an exponential delay;
- the heartbeat wheel of ``tick_body(..., 30.0, 0, -1)``: a 30 s interval,
  no heartbeat phases and no heartbeat selector bit;
- one substep (K=1) per dispatch.

The draws differ from the reference's: ``tick_body`` takes a threefry key,
the port's kernel hashes (row, substep, seed) as ``PallasTickKernel``
does, and ``example_args`` carries the seed of a port engine's first
dispatch (``SEED_BASE + 1``).

On a CUDA device the step launches the kernel or raises. The plain torch
version runs only when the caller asks for the CPU (``device="cpu"``).

``dryrun_multichip(n_devices, device="cuda")`` is the twin of
``__graft_entry__.dryrun_multichip``: the engine's fused two-kind
dispatch with its packed wire over a mesh of ``n_devices`` shards, placed
round-robin on the visible devices of ``device``'s type (several shards
share a card on a host with fewer cards; 8 shards of the CPU in the
tests), with the ingest scatter, a second step, growth, and a
heterogeneous two-group federation, each checked.
"""

from __future__ import annotations

import torch

import dataclasses

import numpy as np

from kwok_tpu_torch.models import compile_rules, default_rules
from kwok_tpu_torch.models.defaults import chaos_pod_rules
from kwok_tpu_torch.models.lifecycle import ResourceKind
from kwok_tpu_torch.ops import cuda_tick
from kwok_tpu_torch.ops.state import RowState, new_row_state

ROWS = 65536
MEAN_RUN_SECONDS = 5.0
HB_INTERVAL = 30.0
SEED = cuda_tick.SEED_BASE + 1


def seeded_pod_state(capacity: int, device) -> RowState:
    """``capacity`` active managed pod rows on ``device``."""
    state = new_row_state(capacity, device)
    state.active.fill_(True)
    state.sel_bits.fill_(0b11)  # on-managed-node | managed
    return state


class GraftStep:
    """One dispatch of the chaos pod rules, K=1."""

    def __init__(self) -> None:
        table = compile_rules(
            chaos_pod_rules(mean_run_seconds=MEAN_RUN_SECONDS), ResourceKind.POD
        )
        self.spec = cuda_tick.TickSpec(table, HB_INTERVAL, (), -1)

    def __call__(self, state: RowState, now: float, seed: int):
        return cuda_tick.tick_steps(state, self.spec, now, seed, 1, 0.0)


def entry(device="cuda"):
    """``(step, (state, now, seed))`` on ``device``; a CUDA device must be
    present when one is asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the graft step wants a CUDA device; pass device='cpu' for the plain version")
    return GraftStep(), (seeded_pod_state(ROWS, dev), 0.0, SEED)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _reached(kube, phases) -> int:
    """Pods of ``kube`` whose status phase is one of ``phases``."""
    return sum(1 for p in kube.list("pods")
               if (p.get("status") or {}).get("phase") in phases)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The production multi-card step, checked: both kinds in one fused
    dispatch over an ``n_devices``-shard mesh with the packed wire, as
    ``ClusterEngine(use_mesh=True)`` and ``FederatedEngine`` run it, plus
    the ingest scatter, a second step, growth and a federation. The
    shards go round-robin over ``local_devices(device)``. Returns the
    figures it checked; raises ``AssertionError`` on a failed check.
    ``federation_running`` holds, per federation member, the pods that
    reached Running within three ticks: Running under member 0's default
    rules, Running or Succeeded under member 1's chaos rules (Succeeded
    follows only Running there)."""
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import EngineConfig, FederatedEngine
    from kwok_tpu_torch.ops.state import grow, new_row_state, to_numpy
    from kwok_tpu_torch.ops.tick import MultiTickKernel, unpack_wire
    from kwok_tpu_torch.ops.updates import InitBatch, UpdateBuffer, init_rows
    from kwok_tpu_torch.parallel.mesh import local_devices, make_mesh, pad_to_multiple

    visible = local_devices(device)
    mesh = make_mesh(devices=[visible[i % len(visible)] for i in range(n_devices)])
    ntab = compile_rules(default_rules(), ResourceKind.NODE)
    ptab = compile_rules(chaos_pod_rules(mean_run_seconds=1.0), ResourceKind.POD)
    specs = [(ntab, HB_INTERVAL, (), 1), (ptab, HB_INTERVAL, (), -1)]
    kern = MultiTickKernel(specs, mesh=mesh)

    # the reference's realistic shape: 131,072 rows per kind, half live
    cap = pad_to_multiple(max(131_072, 4 * n_devices), mesh)
    host = []
    for _ in range(2):
        st = to_numpy(new_row_state(cap, "cpu"))
        st.active[: cap // 2] = True
        st.sel_bits[: cap // 2] = 0b11  # managed | heartbeat (on-managed-node for pods)
        host.append(st)
    nodes_d, pods_d = (kern.place(h) for h in host)

    # an ingest burst scattered across the shard boundaries
    buf = UpdateBuffer()
    scatter_n = min(2048, cap - cap // 2)
    for i in range(cap // 2, cap // 2 + scatter_n):
        buf.stage_init(i, True, phase=0, sel_bits=0b11)
    pods_d = buf.flush(pods_d)

    _outs, wire = kern((nodes_d, pods_d), 0.0)
    counters, masks_fn, _dues = unpack_wire(np.asarray(wire), [cap, cap])
    n_trans, p_trans = int(counters[0]), int(counters[1])
    _check(n_trans == cap // 2, f"node transitions {n_trans}, want {cap // 2}")
    _check(p_trans == cap // 2 + scatter_n,
           f"pod transitions {p_trans}, want {cap // 2 + scatter_n}")
    dirty = int(masks_fn()[1][0].sum())
    _check(dirty == p_trans, f"pod dirty mask {dirty} against {p_trans} transitions")

    # a second step on the updated state
    kern((nodes_d, pods_d), 1.0)
    _check(to_numpy(pods_d).phase.shape[0] == cap, "pod rows after the second step")

    # growth re-lays the rows out over the mesh; 512 fresh rows fire
    grown_cap = pad_to_multiple(cap + cap // 2, mesh)
    grown_pods = grow(pods_d, grown_cap)
    grown_nodes = grow(nodes_d, grown_cap)
    fresh = np.arange(cap, cap + 512, dtype=np.int32)
    init_rows(grown_pods, InitBatch(
        idx=fresh, active=np.ones(512, bool), phase=np.zeros(512, np.int32),
        cond_bits=np.zeros(512, np.uint32), sel_bits=np.full(512, 0b11, np.uint32),
        has_deletion=np.zeros(512, bool),
    ))
    kern2 = MultiTickKernel(specs, mesh=mesh)
    _outs, gwire = kern2((grown_nodes, grown_pods), 2.0)
    gcounters = unpack_wire(np.asarray(gwire), [grown_cap, grown_cap])[0]
    _check(int(gcounters[1]) >= 512, f"post-growth pod transitions {int(gcounters[1])}")

    # a heterogeneous two-member federation over the same mesh: two rule
    # sets, two groups, each group's stacked state split
    base = EngineConfig(
        manage_all_nodes=True, tick_interval=0.05,
        initial_capacity=max(4 * n_devices, 16), device=str(mesh.devices[0]),
    )
    kubes = [FakeKube(), FakeKube()]
    fed = FederatedEngine(kubes, base, mesh=mesh, member_configs=[
        base, dataclasses.replace(base, pod_rules=chaos_pod_rules(mean_run_seconds=1.0)),
    ])
    _check(len(fed.groups) == 2, "heterogeneous members must form 2 groups")
    fed_pods = 4
    for c, kube in enumerate(kubes):
        e = fed.engines[c]
        e._ingest("nodes", "ADDED", kube.create("nodes", {
            "apiVersion": "v1", "kind": "Node", "metadata": {"name": f"m{c}-n0"}}))
        for i in range(fed_pods):
            e._ingest("pods", "ADDED", kube.create("pods", {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"m{c}-p{i}", "namespace": "default"},
                "spec": {"nodeName": f"m{c}-n0", "containers": [{"name": "c", "image": "i"}]},
            }))
    for _ in range(3):
        fed.tick_once()
    # pods that reached Running, per member: member 0's default rules stop
    # at Running; member 1's chaos rules move a Running pod on to
    # Succeeded after an Exp(1 s) delay, which a slow host's three ticks
    # can span, so there Succeeded counts as having reached Running
    running = [_reached(kubes[0], ("Running",)),
               _reached(kubes[1], ("Running", "Succeeded"))]
    for e in fed.engines:
        e.stop()
    _check(all(g.dispatches > 0 for g in fed.groups), "a federation group never dispatched")
    _check(running == [fed_pods, fed_pods], f"federation pods that reached Running {running}")
    return {
        "shards": [str(d) for d in mesh.devices], "rows": cap, "grown_rows": grown_cap,
        "node_transitions": n_trans, "pod_transitions": p_trans,
        "post_growth_pod_transitions": int(gcounters[1]), "scatter_rows": scatter_n,
        "federation_groups": len(fed.groups), "federation_running": running,
    }
