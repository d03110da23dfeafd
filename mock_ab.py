"""This tree's Python mock apiserver against another tree's, under the CLI
phase's load, on one NVIDIA GPU; or, with ``--tree``, this tree's whole
CLI phase against another tree's.

    python3 mock_ab.py OTHER_TREE
    python3 mock_ab.py --tree OTHER_TREE

OTHER_TREE is another checkout of this repo (for example an earlier
commit, unpacked from ``git archive``). chip_smoke.py's CLI phase (the
kwok entry point on auto threaded lanes, 10,000 nodes, 25,000 pods from a
spawned creator over 8 keep-alive connections, 500 graceful deletes,
every check of that phase) runs four times against ``python -m
kwok_tpu_torch.edge.mockserver``: the other tree's mock, this tree's,
this tree's, the other tree's, so a drift of the host over the call
falls on both arms alike. Only the mock process comes from the other
tree; kwok, the creator and the checks are this tree's. Each run prints
one JSON line: its create->Running pods/s, the creator's span and the
mock's and kwok's CPU seconds per 1,000 pods. Then the card's name and
power limit, and last one JSON object with every run.

With ``--tree`` each of the four runs is the other tree's or this tree's
own ``chip_smoke.cli_phase()`` (its kwok, its native mock, its checks), in
a process of its own started in that tree, in the same order; each
prints its numbers, watch terminations, re-lists and lanes' drain and
emit seconds besides.
"""

from __future__ import annotations

import json
import os
import sys

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
MOCK = os.path.join("kwok_tpu_torch", "edge", "mockserver.py")
# the numbers of a CLI phase each run keeps
KEYS = ("pods", "create_to_running_pods_per_s", "create_to_running_s", "pod_create_s",
        "window_mock_cpu_s", "mock_cpu_s_per_1000_pods", "window_kwok_process_cpu_s",
        "kwok_cpu_s_per_1000_pods", "status_patches_per_s")
# runs the Python mock of the tree named by the first argument, and fails
# unless the package came from there
LAUNCH = ("import os, runpy, sys; tree = sys.argv.pop(1); sys.path.insert(0, tree); "
          "import kwok_tpu_torch; "
          "assert os.path.realpath(kwok_tpu_torch.__file__).startswith(tree + os.sep), "
          "kwok_tpu_torch.__file__; "
          "runpy.run_module('kwok_tpu_torch.edge.mockserver', run_name='__main__')")


def mock_command_of(tree: str):
    """chip_smoke.mock_command for the Python mock of ``tree``."""

    def command(mock: str) -> list:
        if mock != "python":
            raise AssertionError(f"mock_ab runs Python mocks only, not {mock}")
        return [sys.executable, "-c", LAUNCH, tree, "--port", "0"]

    return command


# one tree's CLI phase on its own native mock, in a process started there
TREE_RUN = ("import json, chip_smoke as cs; from kwok_tpu_torch import native; "
            "from kwok_tpu_torch.ops import cuda_tick; cuda_tick.tick_steps.library(); "
            "native.load(); cs.APISERVER = native.apiserver_binary(); r = cs.cli_phase(); "
            "print('RESULT', json.dumps({k: r.get(k) for k in KEYS}))")
TREE_KEYS = KEYS + ("watch_terminations", "watch_relists", "lane_drain_s", "lane_emit_s",
                    "tick_thread_s")


def tree_ab(other: str, here: str) -> int:
    """The --tree mode (see the module docstring)."""
    import subprocess

    print(cs.card_line(), flush=True)
    code = f"KEYS = {TREE_KEYS!r}; " + TREE_RUN
    runs = []
    for arm, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        p = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                           text=True, timeout=900)
        res = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not res:
            raise AssertionError(f"{arm} ({tree}) exited {p.returncode}: {p.stderr[-2000:]}")
        row = {"arm": arm, "tree": tree, **json.loads(res[-1][len("RESULT "):])}
        print(json.dumps(row), flush=True)
        runs.append(row)
    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"tree_ab": runs, "card": card}), flush=True)
    return 0


def main() -> int:
    import torch

    whole = sys.argv[1:2] == ["--tree"]
    if whole:
        sys.argv.pop(1)
    if len(sys.argv) != 2:
        cs.log(__doc__)
        return 2
    if not torch.cuda.is_available():
        cs.log("mock_ab: torch.cuda.is_available() is false; nothing to run")
        return 2
    other = os.path.realpath(sys.argv[1])
    here = os.path.realpath(HERE)
    for tree in (other, here):
        if not os.path.isfile(os.path.join(tree, MOCK)):
            cs.log(f"mock_ab: no {MOCK} in {tree}")
            return 2
    if whole:
        return tree_ab(other, here)
    from kwok_tpu_torch import native
    from kwok_tpu_torch.ops import cuda_tick

    card = cs.card_line()
    print(card, flush=True)
    if native.load() is None:
        raise AssertionError("the native library did not build (see the WARNING above)")
    cuda_tick.tick_steps.library()
    runs = []
    for arm, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        cs.mock_command = mock_command_of(tree)
        r = cs.cli_phase(mock="python")
        row = {"arm": arm, "tree": tree, **{k: r[k] for k in KEYS}}
        print(json.dumps(row), flush=True)
        runs.append(row)
    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"mock_ab": runs, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
