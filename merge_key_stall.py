"""The drift phase's native-mock stall, rehearsed on the CPU.

A node is stored with an address whose ``type`` key a garbled watch line
renamed; the port's engine (threaded lanes, on the CPU) manages it and 50
others against a native mock apiserver. The engine echoes the addresses
a node holds and finds the echo changed, so a server that appends an
element without its merge key instead of failing the patch (the native
server before its repair, ``kwok_tpu``'s still) doubles the list on every
round trip. Every 2 s this prints the mock's CPU seconds since the start,
the seconds one LIST of nodes takes and the engine's heartbeats::

    python3 merge_key_stall.py                    # the port's native server
    python3 merge_key_stall.py --binary PATH      # another build of it
    python3 merge_key_stall.py --binary jax       # kwok_tpu's native server
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

NODES = 50
SAMPLES = 8
EVERY_S = 2.0


def cpu_seconds(pid: int) -> float:
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="merge_key_stall.py")
    p.add_argument("--binary", default="", help="a native server binary; 'jax' for "
                   "kwok_tpu's; empty for the port's")
    args = p.parse_args(argv)
    os.environ.setdefault("KWOK_TPU_BOOKMARK_INTERVAL", "0")
    from kwok_tpu_torch import native
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig

    binary = args.binary
    if binary == "jax":
        from kwok_tpu import native as jax_native

        binary = jax_native.apiserver_binary()
    binary = binary or native.apiserver_binary()
    mock = subprocess.Popen([binary, "--port", "0"], stdout=subprocess.PIPE, text=True)
    eng = None
    try:
        url = mock.stdout.readline().rsplit(" ", 1)[-1].strip()
        client = HttpKubeClient(url, timeout=30)
        for i in range(NODES):
            client.create("nodes", {"metadata": {"name": f"n{i}"}})
        client.create("nodes", {"metadata": {"name": "echo"}, "status": {
            "addresses": [{"address": "10.0.0.1", "tyqe": "InternalIP"}]}})
        eng = ClusterEngine(HttpKubeClient(url, timeout=10), EngineConfig(
            manage_all_nodes=True, drain_shards=2, tick_interval=0.02,
            heartbeat_interval=0.5, device="cpu"))
        eng.start()
        t0, cpu0 = time.time(), cpu_seconds(mock.pid)
        for _ in range(SAMPLES):
            time.sleep(EVERY_S)
            t = time.time()
            n = len(client.list("nodes"))
            print(f"+{time.time() - t0:.0f} s: mock CPU {cpu_seconds(mock.pid) - cpu0:.1f} s, "
                  f"LIST of {n} nodes {time.time() - t:.4f} s, heartbeats "
                  f"{eng.metrics.get('heartbeats_total', 0):.0f}", flush=True)
    finally:
        mock.kill()
        mock.wait(10)
        if eng is not None:
            eng.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
