"""One phase of chip_smoke.py from two trees on one card, in turns.

    python3 phase_ab.py OTHER_TREE [--phase cli] [--phase mesh_cli] [--out FILE]

For each phase, runs OTHER_TREE, this tree, this tree, OTHER_TREE: each
turn is a subprocess in that tree that imports its ``chip_smoke`` and
``kwok_tpu_torch``, builds what the phase needs (the native library, the
native mock apiserver, ``tick.cu``) and runs the phase once. Unpack the
other commit with ``git archive`` into a directory ``.gitignore`` lists
(``_archive/``). Phases: ``cli`` (``chip_smoke.cli_phase``: the entry
point on auto lanes against the native mock), ``mesh_cli``
(``chip_smoke.mesh_cli_leg``: the same with ``--use-mesh true`` at its
smaller width) and ``engine`` (``chip_smoke.engine_phase``: one lane in
process). Prints one line per turn (create→Running pods/s, the creator's
seconds, kwok's CPU per 1,000 pods, launches) and the card's name and
power limit; ``--out`` keeps them as JSON. It needs the card, as
chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KEYS = ("create_to_running_pods_per_s", "pod_create_s", "create_to_running_s",
        "kwok_cpu_s_per_1000_pods", "kernel_launches")


def worker(tree: str, phase: str) -> dict:
    os.chdir(tree)
    sys.path.insert(0, tree)
    import threading

    import chip_smoke as cs
    from kwok_tpu_torch import native
    from kwok_tpu_torch.ops import cuda_tick

    out: dict = {}
    th = threading.Thread(target=lambda: out.update(api=native.apiserver_binary()))
    th.start()
    if native.load() is None:
        raise SystemExit("phase_ab: the native library did not build")
    cuda_tick.tick_steps.library()
    th.join()
    if out.get("api") is None:
        raise SystemExit("phase_ab: the native mock apiserver did not build")
    cs.APISERVER = out["api"]
    run = {"cli": cs.cli_phase, "mesh_cli": cs.mesh_cli_leg, "engine": cs.engine_phase}[phase]
    res = run()
    return {k: res.get(k) for k in KEYS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other tree")
    ap.add_argument("--phase", action="append", choices=("cli", "mesh_cli", "engine"))
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("phase_ab " + json.dumps(worker(args.worker, args.phase[0])), flush=True)
        return 0
    if not args.other:
        ap.error("name the other tree")
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    turns = []
    for phase in args.phase or ["cli"]:
        for tree in (other, here, here, other):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree, "--phase", phase],
                capture_output=True, text=True, timeout=900,
            )
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("phase_ab ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            turn = {"phase": phase, "tree": "other" if tree == other else "this",
                    **json.loads(line[0][len("phase_ab "):])}
            print(json.dumps(turn) + f" ({card})", flush=True)
            turns.append(turn)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
