"""Metrics layer of the observability subsystem (a copy of
``repro.obs.metrics``, stdlib only): a dependency-free,
thread-safe registry of counters, gauges and exponential-bucket histograms.

Design (the Prometheus data model, stdlib-only):

  * a **metric family** is declared once per registry by name (type, help
    text, unit, bucket layout); each distinct label set materializes one
    **child** — ``registry.counter("serve_flushes_total",
    labels={"model": "CNV-w1a1"})`` returns the child for that series and
    is idempotent, so instrumented code never checks "already created?";
  * children are cheap and lock-guarded: ``Counter.inc`` / ``Gauge.set`` /
    ``Histogram.observe`` take one uncontended lock each, safe for the
    serving tier's submit threads;
  * **histograms** record cumulative exponential buckets (``le`` upper
    bounds) plus sum/count, and optionally a bounded **window** of raw
    recent observations — the windowed view is what the serving tier's
    rolling p50/p99 read (exact nearest-rank, identical semantics to the
    old per-engine deques), while the buckets are the exported,
    mergeable representation;
  * two exporters: ``snapshot()``/``to_json()`` (machine-readable) and
    ``to_prometheus()`` (Prometheus text exposition).

A process-wide default registry (``default_registry()``) collects the
compile-tier metrics; serving engines default to a private registry per
engine (so a fresh engine's counters start at zero) and accept a shared
one for fleet export (see ``CompiledGraphEngine(metrics_registry=...)``).
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "HistogramSnapshot",
    "MetricsRegistry", "default_registry", "exponential_buckets",
    "nearest_rank",
]


def exponential_buckets(start: float = 0.001, factor: float = 2.0,
                        count: int = 28) -> tuple[float, ...]:
    """``count`` upper bounds ``start * factor**i`` (an implicit +Inf
    bucket always follows).  The default spans 1µs-ish to ~2 minutes when
    observations are milliseconds."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


def nearest_rank(values, pct: float) -> float:
    """Nearest-rank percentile over a raw sample; nan when empty.  This is
    the exact formula the serving tier's rolling p50/p99 always used."""
    if not values:
        return float("nan")
    vs = sorted(values)
    k = min(len(vs) - 1, max(0, int(round(pct / 100.0 * (len(vs) - 1)))))
    return float(vs[k])


class Counter:
    """Monotonic counter.  ``inc`` by a non-negative amount only."""

    __slots__ = ("labels", "_value", "_lock")

    def __init__(self, labels: dict):
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value; can go up and down."""

    __slots__ = ("labels", "_value", "_lock")

    def __init__(self, labels: dict):
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class HistogramSnapshot:
    """Immutable view of a histogram child: cumulative bucket counts, sum,
    count, and (when the histogram keeps one) the raw rolling window.

    ``percentile`` prefers the exact windowed nearest-rank estimate and
    falls back to the bucket interpolation — so one shared implementation
    serves both the engine's rolling p50/p99 and bucket-only exports.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "window")

    def __init__(self, bounds, counts, total, count, window):
        self.bounds = bounds          # ascending le upper bounds (no +Inf)
        self.counts = counts          # per-bucket (non-cumulative) counts,
        self.sum = total              # len(bounds) + 1 (last is +Inf)
        self.count = count
        self.window = window          # tuple of recent raw values (or ())

    def percentile(self, pct: float) -> float:
        if self.window:
            return nearest_rank(self.window, pct)
        return self.estimate_percentile(pct)

    def estimate_percentile(self, pct: float) -> float:
        """Bucket-interpolated percentile (what a scraped exporter can
        compute): linear within the target bucket, like Prometheus'
        ``histogram_quantile``.  Accuracy is bounded by the bucket width —
        tests/test_obs.py checks it against ``numpy.percentile``."""
        if self.count == 0:
            return float("nan")
        rank = pct / 100.0 * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev_cum, cum = cum, cum + c
            if cum >= rank:
                if i >= len(self.bounds):        # +Inf bucket: clamp to
                    return self.bounds[-1]       # the last finite bound
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


class Histogram:
    """Exponential-bucket histogram with an optional rolling raw window."""

    __slots__ = ("labels", "bounds", "_counts", "_sum", "_count",
                 "_window", "_lock")

    def __init__(self, labels: dict, buckets: tuple[float, ...],
                 window: int = 0):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != \
                len(buckets):
            raise ValueError("bucket bounds must be strictly ascending")
        self.labels = labels
        self.bounds = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._window = deque(maxlen=window) if window else None
        self._lock = threading.Lock()

    def _bucket_index(self, value: float) -> int:
        # first bound >= value (le semantics); bisect over a small tuple
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            return
        i = self._bucket_index(value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._window is not None:
                self._window.append(value)

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(
                self.bounds, tuple(self._counts), self._sum, self._count,
                tuple(self._window) if self._window is not None else ())

    def percentile(self, pct: float) -> float:
        return self.snapshot().percentile(pct)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum


class _Family:
    __slots__ = ("name", "kind", "help", "unit", "buckets", "window",
                 "children")

    def __init__(self, name, kind, help, unit, buckets, window):
        self.name = name
        self.kind = kind
        self.help = help
        self.unit = unit
        self.buckets = buckets
        self.window = window
        self.children: dict[tuple, object] = {}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


class MetricsRegistry:
    """Thread-safe name -> metric-family table with label support."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # ----------------------------------------------------------- creation

    def _metric(self, kind: str, name: str, help: str, unit: str,
                labels: Optional[dict], buckets=None, window: int = 0):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, unit, buckets, window)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"cannot re-register as {kind}")
            child = fam.children.get(key)
            if child is None:
                if kind == "histogram":
                    child = Histogram(dict(key), fam.buckets, fam.window)
                else:
                    child = _KINDS[kind](dict(key))
                fam.children[key] = child
            return child

    def counter(self, name: str, *, help: str = "", unit: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._metric("counter", name, help, unit, labels)

    def gauge(self, name: str, *, help: str = "", unit: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._metric("gauge", name, help, unit, labels)

    def histogram(self, name: str, *, help: str = "", unit: str = "",
                  labels: Optional[dict] = None,
                  buckets: Optional[tuple] = None,
                  window: int = 0) -> Histogram:
        """``buckets`` defaults to ``exponential_buckets()``; ``window``
        (observations) enables the exact rolling-percentile view.  Bucket
        layout and window are family-wide: the first declaration wins."""
        if buckets is None:
            buckets = exponential_buckets()
        return self._metric("histogram", name, help, unit, labels,
                            tuple(buckets), int(window))

    def get(self, name: str, labels: Optional[dict] = None):
        """Existing child or None (never creates)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.children.get(_label_key(labels))

    # ------------------------------------------------------------ exports

    def snapshot(self) -> dict:
        """{name: {type, help, unit, series: [...]}} — the JSON schema the
        report CLI, the /metrics.json endpoint and the CI artifact share.
        Histogram series carry buckets + count/sum plus pre-computed
        p50/p90/p99 (windowed when available, bucket estimate otherwise)."""
        with self._lock:
            fams = [(f, list(f.children.values()))
                    for f in self._families.values()]
        out = {}
        for fam, children in fams:
            series = []
            for child in children:
                if fam.kind == "histogram":
                    s = child.snapshot()
                    series.append({
                        "labels": child.labels,
                        "count": s.count,
                        "sum": s.sum,
                        "buckets": [[b, c] for b, c in
                                    zip(list(s.bounds) + ["+Inf"], s.counts)],
                        "p50": s.percentile(50),
                        "p90": s.percentile(90),
                        "p99": s.percentile(99),
                    })
                else:
                    series.append({"labels": child.labels,
                                   "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "unit": fam.unit, "series": series}
        return out

    def to_json(self, **dump_kw) -> str:
        dump_kw.setdefault("indent", 2)
        dump_kw.setdefault("sort_keys", True)

        def _default(o):
            f = float(o)
            return f

        return json.dumps(self.snapshot(), default=_default, **dump_kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        def esc(v):
            return str(v).replace("\\", r"\\").replace('"', r'\"') \
                .replace("\n", r"\n")

        def fmt_labels(labels, extra=None):
            items = list(sorted(labels.items())) + (extra or [])
            if not items:
                return ""
            return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"

        def num(v):
            if isinstance(v, float) and math.isinf(v):
                return "+Inf" if v > 0 else "-Inf"
            return repr(float(v)) if isinstance(v, float) else str(v)

        lines = []
        for name, fam in sorted(self.snapshot().items()):
            if fam["help"]:
                lines.append(f"# HELP {name} {esc(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["series"]:
                if fam["type"] == "histogram":
                    cum = 0
                    for le, c in s["buckets"]:
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{fmt_labels(s['labels'], [('le', le)])} {cum}")
                    lines.append(
                        f"{name}_sum{fmt_labels(s['labels'])} "
                        f"{num(s['sum'])}")
                    lines.append(
                        f"{name}_count{fmt_labels(s['labels'])} "
                        f"{s['count']}")
                else:
                    lines.append(
                        f"{name}{fmt_labels(s['labels'])} {num(s['value'])}")
        return "\n".join(lines) + "\n"

    # --------------------------------------------------------------- misc

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def clear(self) -> None:
        """Drop every family (tests / long-lived default registry only)."""
        with self._lock:
            self._families.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (compile-tier metrics, the
    ``--metrics-port`` endpoint, the CI snapshot artifact)."""
    return _DEFAULT
