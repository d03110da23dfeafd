"""A whole tick dispatch of two trees on one card, in turns, and where its
device time goes.

    python3 dispatch_ab.py OTHER_TREE [--reps N] [--out FILE]

Runs OTHER_TREE, this tree, this tree, OTHER_TREE: each turn is a
subprocess that imports ``kwok_tpu_torch`` from that tree (and builds
its tick kernel there). Unpack the other commit with ``git archive``
into a directory ``.gitignore`` lists (``_archive/``). Each turn, on one
NVIDIA card, on the seeded populations of ``chip_smoke.py``'s kernel
phase (default node and pod rules):

- the whole dispatch, ``MultiTickKernel.__call__`` with its wire's D2H
  copy: CUDA events around each of ``--reps`` dispatches, a device-side
  sleep queued first so the events time the device work, median; at
  10,240 + 1,048,576 rows with K=1 and K=16, at the stacked engine's
  16,384 + 16,384 rows with K=1, and at 10,240 + 1,048,576 rows split
  over 4 shards of the card with K=1;
- a ``torch.profiler`` window over 20 dispatches of each shape, its
  device time split by the code that launched it (each device event
  under the innermost labelled range around its launch: the tick kernel, the
  fused kernel's epilogue, the counts' fills, ``next_due``, ``packbits``,
  the rows, counters and final ``cat`` of ``pack_wire``, the split's
  gathers, the wire's D2H copy, other), per dispatch, with the device
  operations per dispatch;
- a digest of the wires of three dispatches and of the final state under
  the default and the exponential chaos rules at K=1 and K=16: two trees
  whose tick computes the same function print the same digests.

Prints the card's name and power limit, one ``dispatch_ab {json}`` line
per turn, and a summary; ``--out`` keeps all of it as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

NODE_ROWS = 10_240
POD_ROWS = 1_048_576
ENGINE_ROWS = 16_384
SHARDS = 4
DT = 0.05
PROFILED = 20
# profiler range -> category; a kernel launched inside "launch" is the
# tick kernel when its name says so, else the wrapper's counts fill
CATEGORIES = {
    "launch": "tick kernel", "epilogue": "epilogue", "next_due": "next_due",
    "packbits": "packbits", "pack_wire": "rows, counters and cat",
    "split": "split gathers", "d2h": "D2H copy", None: "other",
}


def populations(np, nodes: int, pods: int, seed: int):
    """chip_smoke.host_states' populations at these widths."""
    from kwok_tpu_torch.ops import state as ts

    rng = np.random.default_rng(seed)
    p = ts.to_numpy(ts.new_row_state(pods, "cpu"))
    p.active[: max(pods - 1000, 0)] = True
    p.phase[:] = rng.choice([0, 1], pods)
    p.sel_bits[:] = 0b11
    p.has_deletion[:] = rng.random(pods) < 0.05
    n = ts.to_numpy(ts.new_row_state(nodes, "cpu"))
    n.active[:] = True
    n.phase[:] = rng.choice([0, 1], nodes)
    n.sel_bits[:] = 0b11
    n.hb_due[:] = (rng.random(nodes) * 0.5).astype(np.float32)
    return n, p


def label(owner, name: str, tag: str) -> None:
    """Run ``owner.name`` inside a profiler range named ``tag``."""
    from torch.profiler import record_function

    fn = getattr(owner, name, None)
    if fn is None:
        return

    def wrapped(*args, **kwargs):
        with record_function(tag):
            return fn(*args, **kwargs)

    setattr(owner, name, wrapped)


def split_by_range(trace_path: str, dispatches: int) -> dict:
    """Device µs per dispatch by category, and device operations per
    dispatch, from a Chrome trace: each kernel, memcpy or memset is put
    in the innermost labelled range (``label``) around the host call
    that launched it (its runtime event, matched by correlation id)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    runtime = {}
    ranges = []
    device = []
    for e in events:
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            runtime[corr] = e
        elif cat == "user_annotation" and e.get("name") in CATEGORIES:
            ranges.append(e)
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e, corr))
    out: dict = {}
    for e, corr in device:
        rt = runtime.get(corr)
        tag = None
        if rt is not None:
            inside = [r for r in ranges if r.get("tid") == rt.get("tid")
                      and r["ts"] <= rt["ts"] <= r["ts"] + r.get("dur", 0)]
            if inside:
                tag = min(inside, key=lambda r: r.get("dur", 0))["name"]
        cat = CATEGORIES[tag]
        if tag == "launch" and "tick_kernel" not in e["name"]:
            cat = "counts fill"
        out[cat] = out.get(cat, 0.0) + float(e.get("dur", 0)) / dispatches
    return {"us_per_dispatch": out, "device_ops_per_dispatch": len(device) / dispatches}


def worker(tree: str, reps: int) -> dict:
    sys.path.insert(0, tree)
    import hashlib

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kwok_tpu_torch.models import compile_rules, default_node_rules, default_pod_rules
    from kwok_tpu_torch.models.defaults import chaos_pod_rules
    from kwok_tpu_torch.models.lifecycle import ResourceKind
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops import state as ts
    from kwok_tpu_torch.ops import tick as tick_mod
    from kwok_tpu_torch.parallel import sharded_tick
    from kwok_tpu_torch.parallel.mesh import make_mesh

    assert os.path.abspath(cuda_tick.__file__).startswith(os.path.abspath(tree))
    t0 = time.perf_counter()
    cuda_tick.tick_steps.library()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    ntab = compile_rules(default_node_rules(), ResourceKind.NODE)
    ptab = compile_rules(default_pod_rules(), ResourceKind.POD)
    specs = [(ntab, 30.0, (), 1), (ptab, 30.0, (), -1)]

    # digests first, before any range is patched in
    digests = {}
    for rname, pt in (("default", ptab),
                      ("chaos", compile_rules(chaos_pod_rules(5.0), ResourceKind.POD))):
        for steps in (1, 16):
            kern = tick_mod.MultiTickKernel([specs[0], (pt, 30.0, (), -1)], steps=steps,
                                            dt=DT, device=dev)
            states = tuple(ts.from_numpy(h, dev)
                           for h in populations(np, NODE_ROWS, POD_ROWS, steps))
            h = hashlib.sha256()
            for now in (0.0, 0.8, 6.0):
                h.update(np.asarray(kern(states, now)[1]).tobytes())
            for st in states:
                for f in ts.RowState._fields:
                    h.update(getattr(st, f).cpu().numpy().tobytes())
            digests[f"{rname} K={steps}"] = h.hexdigest()

    label(cuda_tick.TickSteps, "__call__", "launch")
    for name, tag in (("tick_dispatch_part", "launch"), ("tick_wire_epilogue", "epilogue"),
                      ("next_due", "next_due"), ("packbits", "packbits"),
                      ("pack_wire", "pack_wire")):
        for mod in (cuda_tick, tick_mod, sharded_tick):
            if hasattr(mod, name):
                label(mod, name, tag)
    label(sharded_tick, "tick_split", "split")
    label(tick_mod.Wire, "__init__", "d2h")

    shapes = []
    for name, rows, steps, shards in (
        ("1M K=1", (NODE_ROWS, POD_ROWS), 1, 0),
        ("1M K=16", (NODE_ROWS, POD_ROWS), 16, 0),
        ("engine 16k K=1", (ENGINE_ROWS, ENGINE_ROWS), 1, 0),
        (f"1M K=1 split {SHARDS}", (NODE_ROWS, POD_ROWS), 1, SHARDS),
    ):
        mesh = make_mesh(devices=[dev] * shards) if shards else None
        kern = tick_mod.MultiTickKernel(specs, steps=steps, dt=DT, device=dev, mesh=mesh)
        hosts = populations(np, *rows, seed=99)
        states = tuple(kern.place(h) for h in hosts) if mesh else tuple(
            ts.from_numpy(h, dev) for h in hosts)
        for _ in range(3):
            np.asarray(kern(states, 0.8)[1])
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            e0.record()
            kern(states, 0.8)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                np.asarray(kern(states, 0.8)[1])
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(tmp, "dispatch.json")
            prof.export_chrome_trace(trace)
            split = split_by_range(trace, PROFILED)
        shapes.append({
            "shape": name, "rows": list(rows), "substeps": steps, "shards": shards,
            "dispatch_ms_median": sorted(times)[len(times) // 2],
            "dispatch_ms_min": min(times), "dispatch_ms_max": max(times),
            "reps": reps, **split,
        })
    return {"tree": tree, "build_s": build_s, "device": torch.cuda.get_device_name(0),
            "digests": digests, "shapes": shapes}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("dispatch_ab " + json.dumps(worker(args.worker, args.reps)), flush=True)
        return 0
    if not args.other:
        ap.error("name the other tree")
    import torch

    if not torch.cuda.is_available():
        print("dispatch_ab: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    card = card_line()
    print(card, flush=True)
    turns = []
    for tree in (other, here, here, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900, cwd=tree,
        )
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("dispatch_ab ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(line[0][len("dispatch_ab "):])
        turn["name"] = "other" if tree == other else "this"
        print(line[0], flush=True)
        turns.append(turn)
    summary = {}
    for turn in turns:
        for s in turn["shapes"]:
            summary.setdefault(s["shape"], {}).setdefault(turn["name"], []).append(
                s["dispatch_ms_median"])
    same = all(t["digests"] == turns[0]["digests"] for t in turns)
    print(f"dispatch ms (median per turn, other / this): {json.dumps(summary)}; "
          f"digests equal across the trees: {same} ({card})", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "turns": turns, "summary": summary,
                       "digests_equal": same}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
