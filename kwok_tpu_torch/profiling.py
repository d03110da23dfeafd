"""In-process sampling profiler for multi-threaded attribution (the port's
copy of ``kwok_tpu.profiling``), and the device profiler hook of the tick
threads (``TickProfiler``).

Set ``KWOK_TPU_SAMPLE_PROF=<path.json>`` and the engine starts a daemon
thread that snapshots every Python thread's stack (``sys._current_frames``)
on a fixed cadence and dumps per-thread flat/cumulative hot-function counts
as JSON at engine stop.

Why not cProfile: on CPython 3.12 ``cProfile`` registers a process-wide
``sys.monitoring`` tool, so only ONE thread can be deterministically
profiled per process — useless for an engine whose CPU is spread across a
tick thread, watch threads, and a patch executor.  Sampling sees them all
at once, costs ~nothing at the default 2 ms cadence, and the counts are
directly proportional to wall time spent per frame.

Crash-proofing: ``maybe_start`` registers an ``atexit`` hook and (from the
main thread) chains onto SIGTERM, so a killed or crashed engine that never
reaches ``stop()`` still leaves its sample data on disk. The dump also
carries an ``overruns`` count — sampling intervals missed because one
snapshot took longer than the cadence — so a report whose wall-clock
coverage is thinner than ``samples * interval_s`` says so itself.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import sys
import threading
import time

ENV = "KWOK_TPU_SAMPLE_PROF"


class Sampler:
    def __init__(self, out_path: str, interval_s: float = 0.002) -> None:
        self.out_path = out_path
        self.interval_s = interval_s
        # per thread-name: leaf frame counts (self time) and
        # anywhere-on-stack counts (cumulative time)
        self.leaf: dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter
        )
        self.cum: dict[str, collections.Counter] = collections.defaultdict(
            collections.Counter
        )
        self.samples = 0
        # intervals missed because a snapshot ran longer than the cadence
        # (GIL stalls, huge stacks): coverage = samples / (samples+overruns)
        self.overruns = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Sampler":
        from kwok_tpu_torch.workers import spawn_worker

        self._thread = spawn_worker(self._run, name="kwok-sampler")
        return self

    def _run(self) -> None:
        names = {}  # thread ident -> name (refreshed per sample)
        while not self._stop.is_set():
            t0 = time.perf_counter()
            for th in threading.enumerate():
                names[th.ident] = th.name
            me = threading.get_ident()
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                name = names.get(ident, str(ident))
                leaf = True
                seen = set()
                while frame is not None:
                    code = frame.f_code
                    key = (
                        f"{os.path.basename(code.co_filename)}:"
                        f"{frame.f_lineno}:{code.co_name}"
                        if leaf
                        else f"{os.path.basename(code.co_filename)}:"
                        f"{code.co_firstlineno}:{code.co_name}"
                    )
                    if leaf:
                        self.leaf[name][key] += 1
                        leaf = False
                    if key not in seen:  # recursion: count once per sample
                        seen.add(key)
                        self.cum[name][key] += 1
                    frame = frame.f_back
            self.samples += 1
            took = time.perf_counter() - t0
            if took > self.interval_s:
                self.overruns += int(took / self.interval_s)
            self._stop.wait(self.interval_s)

    def stop_and_dump(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        out = {
            "samples": self.samples,
            "interval_s": self.interval_s,
            "overruns": self.overruns,
            "threads": {},
        }
        for name in sorted(self.leaf):
            out["threads"][name] = {
                "self": dict(self.leaf[name].most_common(40)),
                "cumulative": dict(self.cum[name].most_common(60)),
            }
        tmp = self.out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f, indent=1)
        os.replace(tmp, self.out_path)


_sampler: Sampler | None = None
_lock = threading.Lock()
_hooks_installed = False


def _install_dump_hooks() -> None:
    """atexit always; SIGTERM only when callable from the main thread and
    only by CHAINING the existing handler (the CLI installs its own
    graceful-stop handler — both must run). Idempotent."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    atexit.register(maybe_dump)
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            maybe_dump()
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread: atexit alone still covers clean exits


def maybe_start() -> None:
    """Idempotent: starts the process-wide sampler if ENV is set."""
    global _sampler
    path = os.environ.get(ENV, "")
    if not path:
        return
    with _lock:
        if _sampler is None:
            _sampler = Sampler(path).start()
            _install_dump_hooks()


def maybe_dump() -> None:
    global _sampler
    with _lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop_and_dump()


# ------------------------------------------------------ device profiler hook


class TickProfiler:
    """``torch.profiler`` over ticks [START, STOP) of ONE tick thread (the
    engine's ``profile_dir``; ``kwok_tpu.engine``'s ``_maybe_profile`` runs
    ``jax.profiler`` over the same window).

    torch.profiler records the CPU ops of the thread that started it only,
    and a profile stopped from another thread returns no events (it logs
    a warning and nothing else). So every call comes from the tick
    thread: ``step()`` before each dispatch starts the profile at tick
    START and flushes it at STOP, and ``close()`` on the tick thread's
    exit path flushes a window that a stop cut short. The thread that
    stops the engine never touches it.

    Activities: CPU, plus CUDA on a CUDA device. Output in ``out_dir``:
    ``kwok-tick-<pid>.pt.trace.json``, the Chrome trace the profiler
    exports, and ``kwok-tick-<pid>.json``, the window's ticks, wall
    seconds, wall-clock ends, the seconds its start and its stop and
    export held the tick thread, and tick-kernel launch counts at start
    and stop
    (``ops/cuda_tick.tick_steps.launches``): on a card the trace holds
    one event whose name contains ``tick_kernel`` per launch of the
    window (the fused dispatch's ``fused_tick_kernel``; its epilogue,
    ``tick_wire_epilogue``, is part of that launch).
    """

    START = 2
    STOP = 102

    def __init__(self, out_dir: str, device) -> None:
        import torch

        self.out_dir = out_dir
        self.device = torch.device(device)
        self._prof = None
        self._done = False
        self._t0 = 0.0
        self._start_unix = 0.0
        self._start_call_s = 0.0
        self._tick0 = 0
        self._launches0 = 0
        #: the sidecar document once the window is written, else None
        self.meta: "dict | None" = None

    @staticmethod
    def _launches() -> int:
        from kwok_tpu_torch.ops.cuda_tick import tick_steps

        return tick_steps.launches

    def step(self, ticks: int) -> None:
        """Before a dispatch, with the engine's tick count so far."""
        if self._prof is None:
            if not self._done and self.START <= ticks < self.STOP:
                self._start(ticks)
        elif ticks >= self.STOP:
            self.close(ticks)

    def _start(self, ticks: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        t_call = time.perf_counter()
        prof.start()
        self._prof = prof
        self._tick0 = ticks
        self._launches0 = self._launches()
        self._t0 = time.perf_counter()
        self._start_unix = time.time()
        self._start_call_s = self._t0 - t_call

    def close(self, ticks: int) -> None:
        """End the window (no-op when none is open) and write both files.
        On a card the device is synchronized first, so every kernel the
        window launched has finished and been recorded."""
        import torch

        prof, self._prof = self._prof, None
        if prof is None:
            return
        self._done = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self._t0
        stop_unix = time.time()
        launches1 = self._launches()
        t_call = time.perf_counter()
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        base = os.path.join(self.out_dir, f"kwok-tick-{os.getpid()}")
        prof.export_chrome_trace(base + ".pt.trace.json")
        meta = {
            "trace": os.path.basename(base) + ".pt.trace.json",
            "device": str(self.device),
            "thread": threading.current_thread().name,
            "ticks": [self._tick0, int(ticks)],
            "wall_s": wall,
            # the window on the wall clock, and the tick thread's seconds
            # inside the profiler's own start and stop-and-export calls
            # (outside the window, but stalls of the tick loop all the same)
            "start_unix": self._start_unix,
            "stop_unix": stop_unix,
            "start_call_s": self._start_call_s,
            "stop_export_s": time.perf_counter() - t_call,
            "launches_start": self._launches0,
            "launches_stop": launches1,
            "launches": launches1 - self._launches0,
        }
        tmp = base + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, base + ".json")
        self.meta = meta


#: the Chrome-trace categories of device work in a torch.profiler export
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_summary(out_dir: str, kernel: str = "tick_kernel") -> dict:
    """Read the window a ``TickProfiler`` wrote into ``out_dir`` (the one
    sidecar there): its sidecar, the trace file's bytes, the events of
    device kernels whose name contains ``kernel`` (their count, summed
    and median µs), CPU events, and the device's busy share of the
    window: the union of every kernel, memcpy and memset interval over
    the window's wall time (``idle_share`` is its complement). Raises
    when the directory holds no window."""
    sides = sorted(
        f for f in os.listdir(out_dir)
        if f.startswith("kwok-tick-") and f.endswith(".json")
        and not f.endswith(".pt.trace.json")
    )
    if len(sides) != 1:
        raise ValueError(f"{out_dir}: {len(sides)} profile windows, want 1")
    with open(os.path.join(out_dir, sides[0])) as f:
        meta = json.load(f)
    path = os.path.join(out_dir, meta["trace"])
    with open(path) as f:
        doc = json.load(f)
    spans = []
    durs = []
    cpu = 0
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            t0 = float(ev["ts"])
            spans.append((t0, t0 + float(ev.get("dur", 0.0))))
            if cat == "kernel" and kernel in ev.get("name", ""):
                durs.append(float(ev.get("dur", 0.0)))
        elif cat == "cpu_op":
            cpu += 1
    busy = 0.0
    end = float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    durs.sort()
    window_us = float(meta["wall_s"]) * 1e6
    share = busy / window_us if window_us > 0 else 0.0
    return {
        "meta": meta,
        "trace_bytes": os.path.getsize(path),
        "cpu_ops": cpu,
        "kernel_events": len(durs),
        "kernel_us_sum": sum(durs),
        "kernel_us_median": durs[len(durs) // 2] if durs else 0.0,
        "device_events": len(spans),
        "device_busy_us": busy,
        "window_us": window_us,
        "busy_share": share,
        "idle_share": 1.0 - share,
    }
