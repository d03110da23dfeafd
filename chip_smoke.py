"""Smoke run of the PyTorch/CUDA port (kwok_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line then):

1. Card and build: the card's name and power limit as nvidia-smi reports
   them, then nvcc builds kwok_tpu_torch/csrc/tick.cu from the checkout
   (build time and the ptxas report are printed).
2. Kernel: the tick kernel against its plain torch version on the card at
   1,048,576 pod rows + 10,240 node rows, for the constant default rule
   set and the exponential chaos set, at K=1 and K=16 substeps (dt=0.05).
   Constant rules: every state field, mask, counter and the packed wire
   bit-exact. Chaos rules: fire_at to rtol 1e-6, rows that differ in any
   field at most 1e-5 of the rows. Kernel, plain and wire D2H times are
   taken with CUDA events.
3. Engine: the port's threaded ClusterEngine (the normal start() path,
   device="cuda") against the port's in-memory FakeKube holding 10,000
   nodes and 50,000 pods bound round-robin: every node Ready, every pod
   Running with a pod IP; then 500 finalizer-guarded pods are deleted
   gracefully and must be gone. The kernel's launch count is zeroed just
   before and read just after; it must be > 0.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

POD_ROWS = 1_048_576
NODE_ROWS = 10_240
DT = 0.05
SUBSTEPS = (1, 16)
ENGINE_NODES = 10_000
ENGINE_PODS = 50_000
ENGINE_DELETES = 500
ENGINE_DEADLINE_S = 600.0
# the poll counts 60,000 objects under the FakeKube lock; polling often
# would take the interpreter lock from the engine it measures
POLL_S = 0.25
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# bytes a row moves per dispatch: reads 2x1 B bools + 7x4 B fields,
# writes 6x4 B fields + 3x1 B masks (csrc/tick.cu)
ROW_BYTES = 30 + 27


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def tick_ops(spec, rows: int, steps: int) -> int:
    """Arithmetic/logic operations the tick does on these inputs: per row
    and substep, 8 per rule for the match and first-match select, 15 per
    hash draw (one, two when weighted), 8 per rule for the weighted pass,
    10 for the delay, 10 for the fire, 12 for the heartbeat wheel."""
    r = spec.num_rules
    per = 8 * r + 15 + 10 + 10 + 12
    if spec.has_weights:
        per += 15 + 8 * r
    return per * rows * steps


def make_states(np, seed: int):
    """Node and pod populations (numpy, then on the card) from a seed:
    pods Pending or Running, a few with a deletionTimestamp; nodes
    Observed or Ready with the heartbeat bit set."""
    from kwok_tpu_torch.ops import state as ts

    rng = np.random.default_rng(seed)
    pods = ts.to_numpy(ts.new_row_state(POD_ROWS, "cpu"))
    pods.active[: POD_ROWS - 1000] = True
    pods.phase[:] = rng.choice([0, 1], POD_ROWS)  # Pending / Running ids
    pods.sel_bits[:] = 0b11
    pods.has_deletion[:] = rng.random(POD_ROWS) < 0.05
    nodes = ts.to_numpy(ts.new_row_state(NODE_ROWS, "cpu"))
    nodes.active[:] = True
    nodes.phase[:] = rng.choice([0, 1], NODE_ROWS)
    nodes.sel_bits[:] = 0b11
    nodes.hb_due[:] = (rng.random(NODE_ROWS) * 0.5).astype(np.float32)
    return ts.from_numpy(nodes, DEVICE), ts.from_numpy(pods, DEVICE)


def clone(state):
    return type(state)(*(t.clone() for t in state))


def kernel_phase(torch, np):
    from kwok_tpu_torch.models import compile_rules, default_node_rules, default_pod_rules
    from kwok_tpu_torch.models.defaults import chaos_pod_rules
    from kwok_tpu_torch.models.lifecycle import ResourceKind
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.tick import pack_wire

    ntab = compile_rules(default_node_rules(), ResourceKind.NODE)
    node_spec = cuda_tick.TickSpec(ntab, 30.0, (), 1)
    rule_sets = {
        "default": cuda_tick.TickSpec(
            compile_rules(default_pod_rules(), ResourceKind.POD), 30.0, (), -1),
        "chaos": cuda_tick.TickSpec(
            compile_rules(chaos_pod_rules(5.0), ResourceKind.POD), 30.0, (), -1),
    }
    fields = ("phase", "cond_bits", "pending_rule", "hb_due", "gen")
    rows_total = POD_ROWS + NODE_ROWS
    configs = []
    max_abs_err = 0.0
    for rname, pod_spec in rule_sets.items():
        for steps in SUBSTEPS:
            nodes0, pods0 = make_states(np, seed=steps)
            # three dispatches: fresh arming, firing, later completions
            for n, now in enumerate((0.0, 0.8, 6.0), start=1):
                seed = cuda_tick.SEED_BASE + n
                outs = {}
                for path in ("kernel", "plain"):
                    res = []
                    for spec, st0 in ((node_spec, nodes0), (pod_spec, pods0)):
                        st = clone(st0)
                        fn = cuda_tick.tick_steps if path == "kernel" else cuda_tick.tick_steps_plain
                        d, x, h, c = fn(st, spec, now, seed, steps, DT)
                        res.append(TickOutputs(st, d, x, h, c[0], c[1]))
                    outs[path] = (res, pack_wire(res))
                (kres, kwire), (pres, pwire) = outs["kernel"], outs["plain"]
                exact = rname == "default"
                for kind, ko, po in zip(("nodes", "pods"), kres, pres):
                    kf, pf = ko.state.fire_at, po.state.fire_at
                    if not torch.equal(torch.isinf(kf), torch.isinf(pf)):
                        raise AssertionError(f"{rname} K={steps} {kind}: +inf fire_at positions differ")
                    fin = ~torch.isinf(kf)
                    err = float((kf[fin] - pf[fin]).abs().max()) if bool(fin.any()) else 0.0
                    max_abs_err = max(max_abs_err, err)
                    rel = (kf[fin] - pf[fin]).abs() / pf[fin].abs().clamp(min=1e-30)
                    if bool(fin.any()) and float(rel.max()) > (0.0 if exact else 1e-6):
                        raise AssertionError(f"{rname} K={steps} {kind}: fire_at rel err {float(rel.max())}")
                    differ = torch.zeros_like(ko.dirty)
                    for f in fields:
                        differ |= getattr(ko.state, f) != getattr(po.state, f)
                    for m in ("dirty", "deleted", "hb_fired"):
                        differ |= getattr(ko, m) != getattr(po, m)
                    nd = int(differ.sum())
                    cap = ko.dirty.shape[0]
                    limit = 0 if exact else int(1e-5 * cap)
                    if nd > limit:
                        raise AssertionError(f"{rname} K={steps} {kind}: {nd} rows differ (limit {limit})")
                    dt_ = abs(int(ko.transitions) - int(po.transitions))
                    dh = abs(int(ko.heartbeats) - int(po.heartbeats))
                    if dt_ > limit or dh > limit:
                        raise AssertionError(f"{rname} K={steps} {kind}: counters differ")
                if exact and not torch.equal(kwire, pwire):
                    raise AssertionError(f"{rname} K={steps}: wire bytes differ")
                nodes0, pods0 = kres[0].state, kres[1].state
            ms, plain_ms, wire_ms = time_dispatch(
                torch, node_spec, pod_spec, steps, make_states(np, seed=99), 0.8)
            ops = tick_ops(node_spec, NODE_ROWS, steps) + tick_ops(pod_spec, POD_ROWS, steps)
            t_bytes = rows_total * ROW_BYTES / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_OPS_PER_S * 1e3
            configs.append({
                "rules": rname, "substeps": steps, "rows": rows_total,
                "ms": ms, "plain_ms": plain_ms, "wire_d2h_ms": wire_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": rows_total * ROW_BYTES, "ops": ops,
            })
            log(f"kernel {rname} K={steps}: checked; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, wire D2H {wire_ms:.4f} ms, "
                f"bound {max(t_bytes, t_ops):.4f} ms")
    return configs, max_abs_err


def time_dispatch(torch, node_spec, pod_spec, steps, states, now, reps: int = 20):
    """Median ms of one dispatch's kernel launches (nodes + pods) on
    ``states`` at engine time ``now``, of the plain version on the same
    inputs, and of the wire's D2H copy (CUDA events). Each rep starts from
    the same state, copied outside the timed window; at full size the
    ~60 MB state does not fit the 50 MB L2. A device-side sleep queued
    first keeps the card busy while the host enqueues, so the events time
    the device work, not the enqueue."""
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.tick import Wire, pack_wire

    nodes0, pods0 = states
    times = {"kernel": [], "plain": [], "wire": []}
    for path in ("kernel", "plain", "kernel", "plain"):
        fn = cuda_tick.tick_steps if path == "kernel" else cuda_tick.tick_steps_plain
        for rep in range(reps if path == "kernel" else 3):
            n, p = clone(nodes0), clone(pods0)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            dn = fn(n, node_spec, now, cuda_tick.SEED_BASE + rep, steps, DT)
            dp = fn(p, pod_spec, now, cuda_tick.SEED_BASE + rep, steps, DT)
            e1.record()
            if path == "kernel":
                outs = [TickOutputs(n, *dn[:3], dn[3][0], dn[3][1]),
                        TickOutputs(p, *dp[:3], dp[3][0], dp[3][1])]
                dev_wire = pack_wire(outs)
                w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                w0.record()
                Wire(dev_wire)
                w1.record()
            torch.cuda.synchronize()
            times[path].append(e0.elapsed_time(e1))
            if path == "kernel":
                times["wire"].append(w0.elapsed_time(w1))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return med(times["kernel"]), med(times["plain"]), med(times["wire"])


def engine_shape_check(torch, eng):
    """The tick kernel against its plain version at the shapes the engine
    phase gave it: the engine's grown capacities, its rule tables and the
    rows it left on the card, one K=1 dispatch at its clock, bit-exact
    (constant rules). Returns the capacities and the kernel, plain and
    wire D2H ms there. Runs after the engine's launch count was read."""
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.tick import pack_wire

    torch.cuda.synchronize()
    fused = eng._get_fused()
    states = (eng.nodes.state, eng.pods.state)
    now = eng._now()
    wires = {}
    for path, fn in (("kernel", cuda_tick.tick_steps), ("plain", cuda_tick.tick_steps_plain)):
        outs = []
        for spec, st0 in zip(fused.specs, states):
            st = clone(st0)
            d, x, h, c = fn(st, spec, now, cuda_tick.SEED_BASE + 1, fused.steps, fused.dt)
            outs.append(TickOutputs(st, d, x, h, c[0], c[1]))
        wires[path] = outs, pack_wire(outs)
    torch.cuda.synchronize()
    (kres, kwire), (pres, pwire) = wires["kernel"], wires["plain"]
    for kind, ko, po in zip(("nodes", "pods"), kres, pres):
        for f in ko.state._fields:
            if not torch.equal(getattr(ko.state, f), getattr(po.state, f)):
                raise AssertionError(f"engine shapes {kind}: {f} differs")
        for m in ("dirty", "deleted", "hb_fired", "transitions", "heartbeats"):
            if not torch.equal(getattr(ko, m), getattr(po, m)):
                raise AssertionError(f"engine shapes {kind}: {m} differs")
    if not torch.equal(kwire, pwire):
        raise AssertionError("engine shapes: wire bytes differ")
    caps = [st.capacity for st in states]
    ms, plain_ms, wire_ms = time_dispatch(
        torch, fused.specs[0], fused.specs[1], fused.steps, states, now)
    return caps, ms, plain_ms, wire_ms


def engine_phase():
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
    from kwok_tpu_torch.ops import cuda_tick

    server = FakeKube()
    cfg = EngineConfig(manage_all_nodes=True, cidr="10.0.0.1/16", device=DEVICE)
    eng = ClusterEngine(server, cfg)
    cuda_tick.tick_steps.launches = 0
    t0 = time.monotonic()
    eng.start()
    try:
        for i in range(ENGINE_NODES):
            server.create("nodes", {"metadata": {"name": f"node-{i}"}})
        t_pods = time.monotonic()
        for i in range(ENGINE_PODS):
            server.create("pods", {
                "metadata": {"name": f"pod-{i}", "namespace": "default",
                             "finalizers": ["kwok.x-k8s.io/smoke"]},
                "spec": {"nodeName": f"node-{i % ENGINE_NODES}",
                         "containers": [{"name": "c", "image": "busybox"}]},
                "status": {"phase": "Pending"},
            })
        t_created = time.monotonic()

        def ready(n):
            return any(c.get("type") == "Ready" and c.get("status") == "True"
                       for c in (n.get("status") or {}).get("conditions") or [])

        def running(p):
            st = p.get("status") or {}
            return st.get("phase") == "Running" and bool(st.get("podIP"))

        deadline = t0 + ENGINE_DEADLINE_S
        while True:
            n_ready = server.count("nodes", ready)
            n_run = server.count("pods", running)
            if n_ready == ENGINE_NODES and n_run == ENGINE_PODS:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"timeout: {n_ready} nodes Ready, {n_run} pods Running")
            time.sleep(POLL_S)
        t_running = time.monotonic()
        for i in range(ENGINE_DELETES):
            server.delete("pods", "default", f"pod-{i}", grace_seconds=30)
        while server.count("pods") > ENGINE_PODS - ENGINE_DELETES:
            if time.monotonic() > deadline:
                raise AssertionError(f"timeout: {server.count('pods')} pods left")
            time.sleep(POLL_S)
        t_deleted = time.monotonic()
    finally:
        eng.stop()
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the engine ran without launching the tick kernel")
    # every survivor Running on its node with a distinct pod IP in the CIDR
    pods = server.list("pods")
    ips = {p["status"]["podIP"] for p in pods}
    if len(pods) != ENGINE_PODS - ENGINE_DELETES or len(ips) != len(pods):
        raise AssertionError(f"{len(pods)} pods, {len(ips)} distinct IPs")
    if not all(ip.startswith("10.0.") for ip in ips):
        raise AssertionError("pod IP outside the configured CIDR")
    if not all(p["status"]["hostIP"] == cfg.node_ip for p in pods):
        raise AssertionError("hostIP mismatch")
    if server.delete_count != ENGINE_DELETES:
        raise AssertionError(f"delete_count {server.delete_count}")
    m = eng.metrics
    if m["patch_errors_total"]:
        raise AssertionError(f"{m['patch_errors_total']} patch errors")
    import torch

    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(torch, eng)
    log(f"kernel at the engine's capacities {caps}: checked; kernel "
        f"{shape_ms:.4f} ms, plain {shape_plain_ms:.3f} ms, wire D2H {shape_wire_ms:.4f} ms")
    return {
        "nodes": ENGINE_NODES, "pods": ENGINE_PODS, "deleted": ENGINE_DELETES,
        "create_to_running_pods_per_s": ENGINE_PODS / (t_running - t_pods),
        "pod_create_s": t_created - t_pods,
        "create_to_running_s": t_running - t_pods,
        "delete_s": t_deleted - t_running,
        "elapsed_s": t_deleted - t0,
        "ticks": m["ticks_total"], "kernel_launches": launches,
        "transitions": m["transitions_total"],
        "status_patches": m["status_patches_total"],
        "heartbeats": m["heartbeats_total"],
        "watch_events": m["watch_events_total"],
        "tick_thread_s": m["tick_seconds_total"],
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
        "wire_d2h_ms_at_capacities": shape_wire_ms,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; nothing to run")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "kwok_tpu_torch")):
        log("chip_smoke: kwok_tpu_torch/ is not beside this script")
        return 2
    import numpy as np

    from kwok_tpu_torch.ops import cuda_tick

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    cuda_tick.tick_steps.library()
    build_s = time.perf_counter() - t0
    print(f"build: nvcc {cuda_tick.NVCC_FLAGS[1]} tick.cu in {build_s:.2f} s", flush=True)
    log(cuda_tick.tick_steps.build_log)

    configs, max_abs_err = kernel_phase(torch, np)
    for c in configs:
        print(json.dumps({"kernel_config": c}), flush=True)
    engine = engine_phase()
    print(json.dumps({"engine": engine}), flush=True)

    main_cfg = next(c for c in configs if c["rules"] == "default" and c["substeps"] == 1)
    kernels = {"kernels": [{
        "name": "tick",
        "route": "cuda",
        "source": "kwok_tpu_torch/csrc/tick.cu",
        "replaces": "kwok_tpu/ops/pallas_tick.py:407",
        "launches": engine["kernel_launches"],
        "max_abs_err": max_abs_err,
        "ms": main_cfg["ms"],
        "plain_ms": main_cfg["plain_ms"],
        "bound_ms": main_cfg["bound_ms"],
        "bound_by": main_cfg["bound_by"],
        "library_ms": None,
        "wire_d2h_ms": main_cfg["wire_d2h_ms"],
        "shape": f"{POD_ROWS} pod + {NODE_ROWS} node rows, default rules, K=1",
        "configs": configs,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
