"""Lock-light metrics registry: counters, gauges, fixed-bucket histograms.

Replaces the engine's ad-hoc ``metrics`` dict + one global ``_metrics_lock``
(every increment from every thread used to serialize on it). Here each
*child* (one label combination of one family) owns its own tiny lock held
for a single read-modify-write — uncontended in the common case because hot
metrics are written by exactly one thread (the tick thread) — and a
histogram observe is one bisect + one array increment. Rendering walks the
families and emits the Prometheus text exposition format 0.0.4: ``# HELP``
/ ``# TYPE`` once per family, label escaping per the spec, and real
histogram series (``_bucket`` with cumulative ``le`` counts incl. ``+Inf``,
``_sum``, ``_count``) instead of the bare ``*_seconds_sum`` counters the
old surface exported with no matching ``_count``.
"""

from __future__ import annotations

from bisect import bisect_left

from kwok_tpu_torch.locks import reclaimable

# Latency buckets (seconds): 100us .. 10s, the range a tick/drain/patch can
# plausibly land in; fixed at registration so observe stays index+increment.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    return (
        text.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def format_value(v) -> str:
    """Prometheus float formatting: integral values print without the
    trailing .0 (matches what real client libraries emit)."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _labels_suffix(label_names, label_values, extra: str = "") -> str:
    parts = [
        f'{n}="{escape_label_value(str(v))}"'
        for n, v in zip(label_names, label_values)
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = reclaimable()
        self.value = 0

    def inc(self, v=1) -> None:
        with self._lock:
            self.value += v


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = reclaimable()
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v  # single STORE: atomic under the GIL

    def inc(self, v=1) -> None:
        with self._lock:
            self.value += v


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum")

    def __init__(self, bounds):
        self._lock = reclaimable()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf
        self.sum = 0.0

    def observe(self, v: float) -> None:
        i = bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v

    @property
    def count(self) -> int:
        return sum(self.counts)


class _Family:
    """One metric family: a name, a type, and children per label combo."""

    _child_cls: type

    def __init__(self, name: str, help: str, label_names=()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = reclaimable()
        self._children: dict[tuple, object] = {}
        if not self.label_names:
            # label-less family: the bare child exists from birth so the
            # family always renders (a declared TYPE with no sample is a
            # strict-parser error in our own oracle)
            self._children[()] = self._make_child()

    def _make_child(self):
        return self._child_cls()

    def labels(self, **kw):
        values = tuple(str(kw[n]) for n in self.label_names)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._make_child())
        return child

    @property
    def child(self):
        """The label-less child (only valid when label_names is empty)."""
        return self._children[()]

    def children(self):
        # snapshot under the family lock: labels() may be inserting a
        # first-seen child (e.g. a new patch path) from another thread
        # while a scrape renders this family
        with self._lock:
            return sorted(self._children.items())


class CounterFamily(_Family):
    type = "counter"
    _child_cls = _CounterChild

    def inc(self, v=1) -> None:
        self.child.inc(v)

    def render(self, out: list) -> None:
        for values, c in self.children():
            out.append(
                f"{self.name}{_labels_suffix(self.label_names, values)}"
                f" {format_value(c.value)}"
            )


class GaugeFamily(_Family):
    type = "gauge"
    _child_cls = _GaugeChild

    def set(self, v) -> None:
        self.child.set(v)

    @property
    def value(self):
        return self.child.value

    def render(self, out: list) -> None:
        for values, c in self.children():
            out.append(
                f"{self.name}{_labels_suffix(self.label_names, values)}"
                f" {format_value(c.value)}"
            )


class HistogramFamily(_Family):
    type = "histogram"

    def __init__(self, name, help, label_names=(), buckets=None):
        self.buckets = tuple(buckets or DEFAULT_LATENCY_BUCKETS)
        super().__init__(name, help, label_names)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.child.observe(v)

    def render(self, out: list) -> None:
        for values, c in self.children():
            # snapshot once: concurrent observes between bucket lines would
            # otherwise break cumulative monotonicity in the scrape
            with c._lock:
                counts = list(c.counts)
                total = sum(counts)
                s = c.sum
            acc = 0
            for bound, n in zip(c.bounds, counts):
                acc += n
                extra = 'le="%s"' % format_value(float(bound))
                out.append(
                    f"{self.name}_bucket"
                    f"{_labels_suffix(self.label_names, values, extra)}"
                    f" {acc}"
                )
            inf = _labels_suffix(self.label_names, values, 'le="+Inf"')
            out.append(f"{self.name}_bucket{inf} {total}")
            suffix = _labels_suffix(self.label_names, values)
            out.append(f"{self.name}_sum{suffix} {format_value(s)}")
            out.append(f"{self.name}_count{suffix} {total}")


class MetricsRegistry:
    """Family registrar + text-exposition renderer. ``counter`` / ``gauge``
    / ``histogram`` are get-or-create: federation members registering the
    same family share it (their per-shard children coexist as labels)."""

    def __init__(self):
        self._lock = reclaimable()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, label_names, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, label_names, **kw)
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise ValueError(
                    f"metric {name} already registered as {fam.type}"
                )
            elif tuple(label_names) != fam.label_names:
                raise ValueError(
                    f"metric {name} label mismatch: "
                    f"{fam.label_names} vs {tuple(label_names)}"
                )
            return fam

    def counter(self, name, help="", label_names=()) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help, label_names)

    def gauge(self, name, help="", label_names=()) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help, label_names)

    def histogram(
        self, name, help="", label_names=(), buckets=None
    ) -> HistogramFamily:
        return self._get_or_create(
            HistogramFamily, name, help, label_names, buckets=buckets
        )

    def render(self) -> str:
        out: list[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for fam in families:
            if not fam._children:
                continue  # labeled family with no children yet: no series
            if fam.help:
                out.append(f"# HELP {fam.name} {escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.type}")
            fam.render(out)
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump of every family and child, the payload a lane
        process publishes in its MetricsBank slab. Per family: type,
        help, label names, buckets (histograms), and ``children`` as
        ``[label_values, value]`` pairs where a histogram's value is
        ``[counts, sum]``. ``registry_from_snapshot`` round-trips it."""
        fams: dict = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            doc: dict = {
                "type": fam.type,
                "help": fam.help,
                "labels": list(fam.label_names),
                "children": [],
            }
            if fam.type == "histogram":
                doc["buckets"] = list(fam.buckets)
            for values, c in fam.children():
                if fam.type == "histogram":
                    with c._lock:
                        v = [list(c.counts), c.sum]
                else:
                    v = c.value
                doc["children"].append([list(values), v])
            fams[fam.name] = doc
        return fams


# ------------------------------------------------- snapshot merge plumbing
# (the process-lane parent folds every lane's snapshot into ONE scratch
# registry per scrape, so each family keeps a single TYPE declaration)


def family_from_doc(registry: MetricsRegistry, name: str, doc: dict):
    """Get-or-create the family a snapshot doc describes."""
    t = doc.get("type")
    labels = tuple(doc.get("labels") or ())
    help_ = doc.get("help", "")
    if t == "counter":
        return registry.counter(name, help_, labels)
    if t == "gauge":
        return registry.gauge(name, help_, labels)
    if t == "histogram":
        return registry.histogram(
            name, help_, labels, buckets=doc.get("buckets")
        )
    raise ValueError(f"snapshot family {name}: unknown type {t!r}")


def merge_child(fam, label_values, value, gauge: str = "sum") -> None:
    """Fold one snapshot child's value into ``fam``'s child at
    ``label_values``: counters and histograms accumulate; gauges follow
    ``gauge`` ("sum" | "max" | "set")."""
    values = tuple(str(v) for v in label_values)
    child = fam.labels(**dict(zip(fam.label_names, values)))
    if fam.type == "histogram":
        counts, s = value
        if len(counts) != len(child.counts):
            return  # bucket-shape drift across versions: drop, never lie
        with child._lock:
            child.counts = [a + b for a, b in zip(child.counts, counts)]
            child.sum += s
    elif fam.type == "gauge":
        if gauge == "set":
            child.set(value)
        elif gauge == "max":
            child.set(max(child.value, value))
        else:
            child.inc(value)
    else:
        child.inc(value)


def registry_from_snapshot(snap: dict) -> MetricsRegistry:
    """A scratch registry (values included) rebuilt from a
    ``MetricsRegistry.snapshot()`` document."""
    reg = MetricsRegistry()
    for name, doc in snap.items():
        fam = family_from_doc(reg, name, doc)
        for values, v in doc.get("children", ()):
            merge_child(fam, values, v, gauge="set")
    return reg


def fold_snapshot(acc: "dict | None", snap: dict) -> dict:
    """Accumulate one snapshot doc into ``acc`` at the dict level:
    counters and histogram counts/sums add, gauges take the newer value.
    This is the retired-lane accumulator: a respawned lane's counters
    restart at zero, so its predecessor's final snapshot must keep
    contributing or the merged counters would decrease."""
    import json as _json

    snap = _json.loads(_json.dumps(snap))  # defensive deep copy
    if acc is None:
        return snap
    for name, doc in snap.items():
        adoc = acc.get(name)
        if adoc is None or adoc.get("type") != doc.get("type"):
            acc[name] = doc
            continue
        amap = {tuple(map(str, v)): val for v, val in adoc["children"]}
        for values, v in doc["children"]:
            key = tuple(map(str, values))
            old = amap.get(key)
            if old is None:
                adoc["children"].append([list(values), v])
                continue
            for pair in adoc["children"]:
                if tuple(map(str, pair[0])) != key:
                    continue
                if doc["type"] == "histogram":
                    counts = [a + b for a, b in zip(old[0], v[0])]
                    pair[1] = [counts, old[1] + v[1]]
                elif doc["type"] == "counter":
                    pair[1] = old + v
                else:
                    pair[1] = v
                break
    return acc
