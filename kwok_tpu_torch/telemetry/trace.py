"""Always-on, low-overhead span tracer: a bounded ring of stage spans
(the port's copy of ``kwok_tpu.telemetry.trace``).

Aggregate counters (tick sum, drain sum, pump sum) cannot see the gaps
*between* stages: a wire that landed but waited a drain window to be
consumed, a patch batch that sat in the executor queue. Spans make those
gaps visible: each is (name, start, duration, lane, args) recorded into a
preallocated ring — one index increment + one slot store, no allocation
beyond the record tuple, no lock (a concurrent append may overwrite one
slot; losing one span under contention is the accepted price of staying
off the hot path).

Export is Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto
format): complete events (``"ph": "X"``) with microsecond timestamps
relative to the tracer's epoch, one ``tid`` lane per engine stage family
so dispatch / consume / emit / pump stack visually per tick.
"""

from __future__ import annotations

import json
import time

# Stable lane ids: spans from different engine threads land in named lanes
# instead of raw thread idents, so two runs diff cleanly.
LANES = {
    "drain": 1,
    "dispatch": 2,
    "consume": 3,
    "emit": 4,
    "pump": 5,
    "patch": 6,
    "event": 7,
}


class Tracer:
    """Bounded span ring. ``capacity`` spans are kept; older spans are
    overwritten (the tail of a run is what post-mortems need)."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = enabled
        self._buf: list = [None] * self.capacity
        self._i = 0
        self.recorded = 0  # total spans ever recorded (ring may have fewer)
        # epoch: perf_counter anchor for span timestamps + the wall clock
        # it corresponds to (exported so dumps from one run line up)
        self.epoch_perf = time.perf_counter()
        self.epoch_unix = time.time()

    def span(self, name: str, t0: float, t1: float, lane: str = "drain",
             args=None) -> None:
        """Record a completed span; t0/t1 are time.perf_counter() values."""
        if not self.enabled:
            return
        i = self._i
        self._i = (i + 1) % self.capacity
        self._buf[i] = (name, t0, t1, lane, args)
        self.recorded += 1

    # ------------------------------------------------------------- export

    def events(self) -> list:
        """Spans in ring order as Chrome trace-event dicts."""
        i = self._i
        ordered = self._buf[i:] + self._buf[:i]
        ep = self.epoch_perf
        out = []
        seen_lanes = set()
        for rec in ordered:
            if rec is None:
                continue
            name, t0, t1, lane, args = rec
            tid = LANES.get(lane, 0)
            seen_lanes.add((lane, tid))
            ev = {
                "name": name,
                "ph": "X",
                "ts": round((t0 - ep) * 1e6, 1),
                "dur": round(max(0.0, t1 - t0) * 1e6, 1),
                "pid": 0,
                "tid": tid,
                "cat": "kwok",
            }
            if args:
                ev["args"] = args
            out.append(ev)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": lane},
            }
            for lane, tid in sorted(seen_lanes)
        ]
        return meta + out

    def chrome_trace(self, extra_events=None) -> dict:
        events = self.events()
        if extra_events:
            events = events + list(extra_events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix": self.epoch_unix,
                "spans_recorded": self.recorded,
                "ring_capacity": self.capacity,
            },
        }

    def dump(self, path: str, extra_events=None) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(extra_events), f)


def merge_chrome_traces(tracers, labels=None) -> dict:
    """One Chrome trace document from several tracers (federation: the fed
    loop's tracer + each member's). Per-tracer events land under their own
    ``pid`` with a process_name metadata record, and timestamps are
    re-anchored to the EARLIEST tracer epoch so lanes line up."""
    tracers = list(tracers)
    if not tracers:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(t.epoch_perf for t in tracers)
    events = []
    for pid, t in enumerate(tracers):
        shift = round((t.epoch_perf - base) * 1e6, 1)
        label = (
            labels[pid] if labels and pid < len(labels) else f"tracer{pid}"
        )
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": label},
        })
        for ev in t.events():
            ev = dict(ev)
            ev["pid"] = pid
            if ev["ph"] != "M":
                ev["ts"] = round(ev["ts"] + shift, 1)
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"epoch_unix": min(t.epoch_unix for t in tracers)},
    }


def check_chrome_trace(doc: dict) -> None:
    """The Chrome trace-event schema a trace document must satisfy (the
    subset chrome://tracing and Perfetto require of the JSON object
    format). Raises AssertionError on any violation."""
    assert isinstance(doc, dict), "trace is not an object"
    events = doc["traceEvents"]
    assert isinstance(events, list)
    for ev in events:
        assert isinstance(ev["name"], str) and ev["name"], ev
        assert ev["ph"] in ("X", "M"), ev
        assert isinstance(ev["pid"], int), ev
        assert isinstance(ev["tid"], int), ev
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, ev
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0, ev
        if "args" in ev:
            assert isinstance(ev["args"], dict), ev
