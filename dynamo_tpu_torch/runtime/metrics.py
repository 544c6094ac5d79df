"""Hierarchical metrics registry on the standard library (copy of
``dynamo_tpu.runtime.metrics`` without ``prometheus_client``).

A tree of registries (runtime -> namespace -> component -> endpoint)
whose nodes auto-label every metric with their position in the hierarchy
(``HIER_LABELS``); every name carries the ``dynamo_tpu`` prefix, so a
dashboard built for the reference reads a port process unchanged.
``expose`` renders the Prometheus text format 0.0.4 that
``prometheus_client.generate_latest`` renders: the same ``# HELP`` and
``# TYPE`` lines, sample names, labels (sorted by name), value
formatting and histogram buckets, byte for byte. The one difference: the port emits no ``*_created``
samples (``prometheus_client`` does unless
``PROMETHEUS_DISABLE_CREATED_SERIES`` is set); they carry the wall time a
series was first touched, and no board under ``deploy/metrics/`` reads
them.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple, Sequence

PREFIX = "dynamo_tpu"

HIER_LABELS = ("dynamo_namespace", "dynamo_component", "dynamo_endpoint")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# The series docs/OBSERVABILITY.md names that the port does not register
# yet, each with the ROADMAP item that ports it (a test keeps this table
# and the doc in step). Every documented series is registered now.
NOT_PORTED_SERIES: dict[str, str] = {}

# prometheus_client's default histogram buckets.
DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75, 1.0, 2.5,
                   5.0, 7.5, 10.0, math.inf)


class HistogramValue(NamedTuple):
    """Snapshot of a histogram child: observation count and sum."""

    count: int
    total: float


def format_float(d: float) -> str:
    """A sample value as ``prometheus_client`` writes it (Go's float
    formatting)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python.
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


class _Value:
    """One counter or gauge child."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, amount: float) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class _HistogramChild:
    __slots__ = ("_lock", "_upper", "_counts", "_sum")

    def __init__(self, upper: tuple[float, ...]):
        self._lock = threading.Lock()
        self._upper = upper
        self._counts = [0.0] * len(upper)  # per bucket, not cumulative
        self._sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            for i, bound in enumerate(self._upper):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> tuple[list[float], float]:
        with self._lock:
            return list(self._counts), self._sum


class _Metric:
    """A metric family: its children by label values, in creation
    order."""

    def __init__(self, name: str, doc: str, labelnames: tuple[str, ...]):
        self.name = name
        self.doc = doc
        self.labelnames = labelnames
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: incorrect label names "
                             f"{sorted(labels)}, expected "
                             f"{list(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._new_child()
        return child

    def _new_child(self):
        return _Value()

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    def _labelstr(self, values: tuple[str, ...],
                  extra: tuple[tuple[str, str], ...] = ()) -> str:
        # Sorted by name, as prometheus_client writes them.
        pairs = sorted(list(zip(self.labelnames, values)) + list(extra))
        if not pairs:
            return ""
        return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                              for k, v in pairs) + "}"

    def expose(self) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    def __init__(self, name: str, doc: str, labelnames: tuple[str, ...]):
        # prometheus_client names the family without "_total" and adds it
        # to the sample.
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, doc, labelnames)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name}_total {_escape_help(self.doc)}",
                 f"# TYPE {self.name}_total counter"]
        for values, child in self.children():
            lines.append(f"{self.name}_total{self._labelstr(values)} "
                         f"{format_float(child.get())}")
        return lines


class Gauge(_Metric):
    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.doc)}",
                 f"# TYPE {self.name} gauge"]
        for values, child in self.children():
            lines.append(f"{self.name}{self._labelstr(values)} "
                         f"{format_float(child.get())}")
        return lines


class Histogram(_Metric):
    def __init__(self, name: str, doc: str, labelnames: tuple[str, ...],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, doc, labelnames)
        upper = sorted(float(b) for b in buckets)
        if not upper or upper[-1] != math.inf:
            upper.append(math.inf)
        self.upper = tuple(upper)

    def _new_child(self):
        return _HistogramChild(self.upper)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.doc)}",
                 f"# TYPE {self.name} histogram"]
        for values, child in self.children():
            counts, total = child.snapshot()
            acc = 0.0
            for bound, n in zip(self.upper, counts):
                acc += n
                le = (("le", format_float(bound)),)
                lines.append(f"{self.name}_bucket"
                             f"{self._labelstr(values, le)} "
                             f"{format_float(acc)}")
            lines.append(f"{self.name}_count{self._labelstr(values)} "
                         f"{format_float(acc)}")
            lines.append(f"{self.name}_sum{self._labelstr(values)} "
                         f"{format_float(total)}")
        return lines


class MetricsRegistry:
    """A node in the metrics hierarchy. Children share the root's table
    of metrics; each level fills in one more hierarchy label."""

    def __init__(self, hierarchy: tuple[str, str, str] = ("", "", ""),
                 _root: "MetricsRegistry | None" = None) -> None:
        self._hierarchy = hierarchy
        self._root = _root or self
        if _root is None:
            self._metrics: dict[str, _Metric] = {}
            self._lock = threading.Lock()

    def child(self, level: int, name: str) -> "MetricsRegistry":
        hier = list(self._hierarchy)
        hier[level] = name
        return MetricsRegistry(tuple(hier), self._root)

    def namespace(self, name: str) -> "MetricsRegistry":
        return self.child(0, name)

    def component(self, name: str) -> "MetricsRegistry":
        return self.child(1, name)

    def endpoint(self, name: str) -> "MetricsRegistry":
        return self.child(2, name)

    # -- metric constructors -------------------------------------------------
    def _get_or_create(self, kind, name: str, desc: str,
                       extra_labels: Sequence[str], **kwargs) -> _Metric:
        full = f"{PREFIX}_{name}"
        labelnames = tuple(HIER_LABELS) + tuple(extra_labels)
        root = self._root
        with root._lock:
            metric = root._metrics.get(full)
            if metric is None:
                metric = kind(full, desc, labelnames, **kwargs)
                root._metrics[full] = metric
                return metric
            # Same name, another shape: fail here, at the second
            # registration, not at the first call that uses it.
            if type(metric) is not kind:
                raise ValueError(
                    f"metric {full!r} already registered as "
                    f"{type(metric).__name__}, cannot re-register as "
                    f"{kind.__name__}")
            if metric.labelnames != labelnames:
                raise ValueError(
                    f"metric {full!r} already registered with labels "
                    f"{list(metric.labelnames)}, cannot re-register with "
                    f"{list(labelnames)}")
        return metric

    def counter(self, name: str, desc: str, labels: Sequence[str] = ()):
        metric = self._get_or_create(Counter, name, desc, labels)
        return _Bound(metric, self._hierarchy, labels)

    def gauge(self, name: str, desc: str, labels: Sequence[str] = ()):
        metric = self._get_or_create(Gauge, name, desc, labels)
        return _Bound(metric, self._hierarchy, labels)

    def histogram(self, name: str, desc: str, labels: Sequence[str] = (),
                  buckets: Sequence[float] | None = None):
        kwargs = {"buckets": tuple(buckets)} if buckets else {}
        metric = self._get_or_create(Histogram, name, desc, labels, **kwargs)
        return _Bound(metric, self._hierarchy, labels)

    def expose(self) -> bytes:
        """Prometheus text exposition (format 0.0.4) for /metrics."""
        root = self._root
        with root._lock:
            metrics = list(root._metrics.values())
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.expose())
        return ("\n".join(lines) + "\n").encode() if lines else b""


class _Bound:
    """A metric pre-bound to its hierarchy labels; extra labels at call
    time."""

    def __init__(self, metric: _Metric, hierarchy: tuple[str, str, str],
                 extra_labels: Sequence[str]):
        self._metric = metric
        self._hier = hierarchy
        self._extra = tuple(extra_labels)

    def _resolve(self, **labels):
        vals = dict(zip(HIER_LABELS, self._hier))
        for k in self._extra:
            vals[k] = labels.get(k, "")
        return self._metric.labels(**vals)

    def inc(self, amount: float = 1.0, **labels):
        if isinstance(self._metric, Counter) and amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        self._resolve(**labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels):
        if not isinstance(self._metric, Gauge):
            raise TypeError(f"dec() unsupported for "
                            f"{type(self._metric).__name__}")
        self._resolve(**labels).inc(-amount)

    def set(self, value: float, **labels):
        if not isinstance(self._metric, Gauge):
            raise TypeError(f"set() unsupported for "
                            f"{type(self._metric).__name__}")
        self._resolve(**labels).set(value)

    def observe(self, value: float, **labels):
        if not isinstance(self._metric, Histogram):
            raise TypeError(f"observe() unsupported for "
                            f"{type(self._metric).__name__}")
        self._resolve(**labels).observe(value)

    def ensure(self, **labels) -> None:
        """Create the labelled child so the series shows in the
        exposition before its first update (dashboards see zeros, not
        absent series)."""
        self._resolve(**labels)

    def collect(self) -> dict[tuple[str, ...], float]:
        """Every child of this metric at THIS hierarchy position: extra
        label values -> current value. Counters and gauges only."""
        if isinstance(self._metric, Histogram):
            raise TypeError("collect() unsupported for Histogram")
        n_hier = len(self._hier)
        return {tuple(values[n_hier:]): child.get()
                for values, child in self._metric.children()
                if tuple(values[:n_hier]) == self._hier}

    def get(self, **labels):
        """Current value: a float for counters and gauges, a
        ``HistogramValue`` (count, total) for histograms."""
        child = self._resolve(**labels)
        if isinstance(child, _HistogramChild):
            counts, total = child.snapshot()
            return HistogramValue(count=int(sum(counts)), total=total)
        return child.get()
