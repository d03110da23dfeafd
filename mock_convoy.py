"""Does a Python mock apiserver keep up with the port's engine under the
drift storm? A CPU rehearsal of chip_smoke.py's drift phase, part (a),
against one of the two Python mocks, each in a process of its own.

    python3 mock_convoy.py --mock port|ref [--nodes 6000] [--pods 15000]
                           [--lanes 8] [--deadline 600]

``--mock port`` serves ``kwok_tpu_torch``'s Python mock (``python3
drift_rig.py --port 0``); ``--mock ref`` serves ``kwok_tpu``'s (``python3
-m kwok_tpu.edge.mockserver --port 0``). The run is the same for both:
``--nodes`` nodes, then a ``kwok_tpu_torch`` ClusterEngine in this
process on the CPU with ``--lanes`` threaded lanes, the auditor every
1 s and chip_smoke.py's DRIFT_SPEC storm (garbled, truncated, duplicated
and stale watch lines, stream cuts); ``--pods`` pods from chip_smoke.py's
creator (a spawned process, 8 keep-alive connections) in two halves 1 s
apart; 2.5 s later the storm closes (rates cleared, ``POST /compact``,
every stream re-listed). The run ends when every pod is Running with a
pod IP (a full LIST every 2 s) or at ``--deadline`` seconds after the
first create.

It prints one JSON line: the seconds until every pod was Running (None
at the deadline) and the pods Running then, the pods/s, the mock's CPU
seconds and its largest thread count (``/proc/<pid>/status``, sampled
every 0.5 s: one thread per open request or watch), the engine's patch
errors, re-lists and audit passes. A CPU run: its seconds are this
host's, not a device's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))


def mock_threads(pid: int) -> int:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mock_convoy.py")
    p.add_argument("--mock", choices=("port", "ref"), required=True)
    p.add_argument("--nodes", type=int, default=6_000)
    p.add_argument("--pods", type=int, default=15_000)
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--deadline", type=float, default=600.0)
    a = p.parse_args(argv)

    os.environ["KWOK_TPU_PLATFORM"] = "cpu"
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

    cmd = ([sys.executable, os.path.join(HERE, "drift_rig.py"), "--port", "0"]
           if a.mock == "port" else
           [sys.executable, "-m", "kwok_tpu.edge.mockserver", "--port", "0"])
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    mock = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, text=True, env=env)
    eng = None
    stop = threading.Event()
    peak = [0]
    try:
        url = cs.mock_url(mock)
        client = HttpKubeClient(url)
        proc, _span = cs.spawn_creator(url, "nodes", a.nodes, nodes=a.nodes)
        cs.join_creator(proc, time.monotonic() + a.deadline)
        eng = ClusterEngine(HttpKubeClient(url), EngineConfig(
            manage_all_nodes=True, cidr="10.0.0.1/16", drain_shards=a.lanes,
            faults=cs.DRIFT_SPEC, audit_interval=cs.DRIFT_AUDIT_S, device="cpu"))
        eng.start()
        t_ready = time.monotonic() + a.deadline
        while not eng.ready:
            if time.monotonic() > t_ready:
                raise AssertionError("the engine never became ready")
            time.sleep(0.05)

        def sample_threads() -> None:
            while not stop.wait(0.5):
                try:
                    peak[0] = max(peak[0], mock_threads(mock.pid))
                except OSError:
                    return

        threading.Thread(target=sample_threads, daemon=True).start()
        cpu0 = cs.cpu_seconds(mock.pid)
        t_first = time.monotonic()
        deadline = t_first + a.deadline
        half = a.pods // 2
        for lo, hi, gap in ((0, half, 1.0), (half, a.pods, 0.0)):
            proc, _span = cs.spawn_creator(url, "pods", hi - lo, first=lo, nodes=a.nodes,
                                           pod_name="dpod-{:05d}")
            cs.join_creator(proc, deadline)
            time.sleep(gap)
        t_created = time.monotonic()
        time.sleep(cs.DRIFT_STORM_TAIL_S)
        eng._faults.spec.rates.clear()
        cs.post_compact(url)
        eng.resync_streams()
        t_heal = time.monotonic()
        n_running = 0
        t_running = None
        while time.monotonic() < deadline:
            try:
                n_running = sum(map(cs.running, client.list("pods")))
            except Exception:  # a LIST that timed out: poll again
                pass
            if n_running == a.pods:
                t_running = time.monotonic()
                break
            time.sleep(2.0)
        cpu = cs.cpu_seconds(mock.pid) - cpu0
        m = eng.metrics
        out = {
            "mock": a.mock, "nodes": a.nodes, "pods": a.pods, "lanes": a.lanes,
            "pod_create_s": t_created - t_first,
            "all_running_s": None if t_running is None else t_running - t_first,
            "heal_to_running_s": None if t_running is None else t_running - t_heal,
            "running_at_end": n_running,
            "pods_per_s": n_running / ((t_running or time.monotonic()) - t_first),
            "mock_cpu_s": cpu, "mock_threads_peak": peak[0],
            "patch_errors": m.get("patch_errors_total", 0),
            "relists": m.get("watch_relists_total", 0),
            "audit_passes": eng._auditor.snapshot()["passes"],
        }
        print(json.dumps(out), flush=True)
        return 0
    finally:
        stop.set()
        if eng is not None:
            eng.stop()
        mock.terminate()
        try:
            mock.wait(30)
        except subprocess.TimeoutExpired:
            mock.kill()
            mock.wait(30)


if __name__ == "__main__":
    sys.exit(main())
