"""Run chosen phases of chip_smoke.py again and again on one card.

A phase that fails one run in several (a stall, a race at a kill) needs
more runs than the smoke test makes. This script builds what
``chip_smoke.main`` builds (the native library, the native mock
apiserver, ``tick.cu``), runs the restart phase once when the ha phase is
asked for (the ha phase holds its failover against that cold restart),
then runs each named phase ``--runs`` times and prints one line per run:

    python3 phase_repeat.py --runs 5 ha
    python3 phase_repeat.py --runs 10 drift

``ha`` is ``chip_smoke.ha_phase`` (both arms), ``drift`` is
``chip_smoke.drift_lanes`` (the drift phase's part (a)). A failed run is
printed with its error and the next run starts; the exit code is the
number of failed runs (0 when every run passed). It needs the card, as
chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import chip_smoke as cs


def build() -> None:
    import torch

    from kwok_tpu_torch import native
    from kwok_tpu_torch.ops import cuda_tick

    if not torch.cuda.is_available():
        raise SystemExit("phase_repeat: torch.cuda.is_available() is false")
    out: dict = {}
    t0 = time.monotonic()
    th = threading.Thread(target=lambda: out.update(api=native.apiserver_binary()))
    th.start()
    if native.load() is None:
        raise SystemExit("phase_repeat: the native library did not build")
    cuda_tick.tick_steps.library()
    th.join()
    if out.get("api") is None:
        raise SystemExit("phase_repeat: the native mock apiserver did not build")
    cs.APISERVER = out["api"]
    print(f"built in {time.monotonic() - t0:.1f} s", flush=True)


def ha_line(r: dict) -> str:
    parts = []
    for arm in ("sigkill", "sigstop"):
        a = r[arm]
        se = a["standby_end"]
        parts.append(
            f"{arm}: RTO {a['rto_s']:.3f} s, takeover->Running {a['takeover_to_running_s']:.2f} s, "
            f"refined {se['refined']}, standby fenced writes {se['fenced_writes']}, "
            f"primary checkpoint {json.dumps(a['primary_checkpoint'], sort_keys=True)}, "
            f"Running patches most {a['running_patches']['most']}")
    return "; ".join(parts)


def drift_line(r: dict) -> str:
    return (f"heal {r['heal_to_running_s']:.1f} s, relists {r['watch_relists']}, "
            f"pods/s {r['create_to_running_pods_per_s']:.1f}, "
            f"stall dumps {len(r['stall_dumps'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="+", choices=("ha", "drift"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    print(cs.card_line(), flush=True)
    build()
    cli_run = {"create_to_running_pods_per_s": float("nan")}
    restart = None
    if "ha" in args.phases:
        restart = cs.restart_phase()
        print(f"restart: recovery {restart['restart_recovery_seconds']:.3f} s", flush=True)
    failed = 0
    for phase in args.phases:
        for i in range(args.runs):
            t = time.monotonic()
            try:
                if phase == "ha":
                    line = ha_line(cs.ha_phase(cli_run, restart))
                else:
                    line = drift_line(cs.drift_lanes(cli_run))
                print(f"{phase} run {i}: passed in {time.monotonic() - t:.1f} s; {line}",
                      flush=True)
            except Exception as e:  # counted in the exit code, and the next run starts
                failed += 1
                print(f"{phase} run {i}: FAILED in {time.monotonic() - t:.1f} s: {str(e)[:3000]}",
                      flush=True)
    print(f"{failed} of {args.runs * len(args.phases)} runs failed ({cs.card_line()})", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
