"""The port's own copy of ``repro.obs.metrics`` (the port imports nothing of
the JAX package); keep the two in step.

Process-global metrics registry (DESIGN.md §10).

Every layer of the stack used to keep its own ad-hoc bookkeeping: the
compile cache in ``pipeline._STATS``, serving phase counters in
``ServingEngine.stats``, store hit/miss/put counts in
``ArtifactStore.stats``, LRU evictions wherever the cache lived.  Each
surface reset independently and none exported anywhere.  This module is the
one sink they all write to:

  * ``counter`` / ``gauge`` / ``histogram`` register (or return, idempotent)
    a named metric on the process-global ``REGISTRY``;
  * metrics carry LABELS — one logical metric, one timeseries per label
    set (``counter("serve_requests").inc(1, engine="e0")``);
  * ``REGISTRY.snapshot()`` is the JSON view, ``REGISTRY.prometheus_text()``
    the standard text exposition format, and ``REGISTRY.reset()`` zeroes
    every value while keeping registrations — ONE reset for every surface;
  * ``MetricsView`` is the read-through dict adapter that lets the existing
    ``engine.stats["rows"] += n`` / ``_STATS["hits"]`` call sites keep
    working verbatim while the values live on the registry.

Histograms keep exact samples (bounded reservoir, default 65536 — serving
runs observe thousands, not millions) so ``percentile()`` is deterministic:
the same observations always produce the same p50/p95/p99, a property the
drift tests pin.
"""

from __future__ import annotations

import bisect
import threading
from collections.abc import MutableMapping

# Prometheus-style default latency buckets (seconds)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Metric:
    """Base: one named metric holding one value per label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}

    # -- value access ------------------------------------------------------

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def set(self, v: float, **labels) -> None:
        self._values[_label_key(labels)] = float(v)

    def reset(self) -> None:
        """Zero every label set's value; registrations stay."""
        for k in self._values:
            self._values[k] = 0.0

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        return {_label_str(k) or "": v for k, v in sorted(self._values.items())}

    def prometheus_lines(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for k, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_label_str(k)} {_fmt(v)}")
        if len(lines) == 1 + bool(self.help):      # no samples yet
            lines.append(f"{self.name} 0")
        return lines


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self._values[k] = self._values.get(k, 0.0) + float(amount)


class Gauge(Metric):
    kind = "gauge"

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self._values[k] = self._values.get(k, 0.0) + float(amount)

    def max(self, v: float, **labels) -> None:
        k = _label_key(labels)
        self._values[k] = max(self._values.get(k, 0.0), float(v))


class Histogram(Metric):
    """Bucketed histogram with an exact-sample reservoir.

    Buckets drive the Prometheus exposition; the sorted reservoir drives
    ``percentile`` — exact (nearest-rank with linear interpolation) and
    deterministic as long as fewer than ``reservoir`` samples were observed
    per label set (beyond that, later samples are dropped from the
    percentile view but still counted in sum/count/buckets)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS, reservoir: int = 65536):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        self.reservoir = int(reservoir)
        # label key -> [bucket counts (+inf last), sum, count, samples]
        self._h: dict[tuple, list] = {}

    def _cell(self, labels: dict) -> list:
        k = _label_key(labels)
        cell = self._h.get(k)
        if cell is None:
            cell = self._h[k] = [[0] * (len(self.buckets) + 1), 0.0, 0, []]
        return cell

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        cell = self._cell(labels)
        cell[0][bisect.bisect_left(self.buckets, v)] += 1
        cell[1] += v
        cell[2] += 1
        if len(cell[3]) < self.reservoir:
            bisect.insort(cell[3], v)

    def count(self, **labels) -> int:
        k = _label_key(labels)
        return self._h[k][2] if k in self._h else 0

    def sum(self, **labels) -> float:
        k = _label_key(labels)
        return self._h[k][1] if k in self._h else 0.0

    def value(self, **labels) -> float:          # dict-view reads the sum
        return self.sum(**labels)

    def percentile(self, q: float, **labels) -> float:
        """Exact q-th percentile (0 <= q <= 100) of the observed samples
        (linear interpolation between closest ranks); 0.0 when empty."""
        k = _label_key(labels)
        cell = self._h.get(k)
        if cell is None or not cell[3]:
            return 0.0
        s = cell[3]
        if len(s) == 1:
            return s[0]
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    def summary(self, **labels) -> dict:
        """The serving-latency view: count / sum / p50 / p95 / p99."""
        return {"count": self.count(**labels), "sum": self.sum(**labels),
                "p50": self.percentile(50, **labels),
                "p95": self.percentile(95, **labels),
                "p99": self.percentile(99, **labels)}

    def reset(self) -> None:
        self._h.clear()
        self._values.clear()

    def snapshot(self) -> dict:
        return {_label_str(k) or "": {
                    "count": c[2], "sum": c[1],
                    "p50": self.percentile(50, **dict(k)),
                    "p95": self.percentile(95, **dict(k)),
                    "p99": self.percentile(99, **dict(k))}
                for k, c in sorted(self._h.items())}

    def prometheus_lines(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        for k, cell in sorted(self._h.items()):
            cum = 0
            for b, n in zip(self.buckets, cell[0]):
                cum += n
                lk = k + (("le", _fmt(b)),)
                lines.append(f"{self.name}_bucket{_label_str(lk)} {cum}")
            lk = k + (("le", "+Inf"),)
            lines.append(f"{self.name}_bucket{_label_str(lk)} {cell[2]}")
            lines.append(f"{self.name}_sum{_label_str(k)} {_fmt(cell[1])}")
            lines.append(f"{self.name}_count{_label_str(k)} {cell[2]}")
        return lines


class MetricsRegistry:
    """Named metrics, registered once, exported together."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def reset(self, prefix: str | None = None) -> None:
        """Zero every metric (or every metric under ``prefix``); the one
        reset that is consistent across compile, store, and serve surfaces
        — registrations and label sets survive, values return to 0."""
        for name, m in self._metrics.items():
            if prefix is None or name.startswith(prefix):
                m.reset()

    def snapshot(self) -> dict:
        """JSON-serializable {name: {labelstr: value}} view of everything."""
        return {name: {"kind": m.kind, "help": m.help,
                       "values": m.snapshot()}
                for name, m in sorted(self._metrics.items())}

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition of every registered metric."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].prometheus_lines())
        return "\n".join(lines) + "\n"


# the process-global registry every layer writes to
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


# ---------------------------------------------------------------------------
# the read-through dict adapter
# ---------------------------------------------------------------------------

class MetricsView(MutableMapping):
    """A dict-shaped view over registry metrics.

    Existing call sites — ``engine.stats["rows"] += n``,
    ``_STATS["hits"]``, ``stats.setdefault(k, 0)`` — keep working
    unchanged: reads pull the metric's current value for this view's label
    set, writes land on the metric (``+=`` decomposes into read + set).
    ``reset()`` zeroes exactly this view's values; ``REGISTRY.reset()``
    zeroes them too (plus everyone else's) — the two reset paths agree by
    construction because there is only one underlying value."""

    def __init__(self, mapping: dict[str, Metric], **labels):
        self._map = dict(mapping)
        self._labels = dict(labels)

    @property
    def labels(self) -> dict:
        return dict(self._labels)

    def with_key(self, key: str, metric: Metric) -> "MetricsView":
        self._map[key] = metric
        return self

    def metric(self, key: str) -> Metric:
        return self._map[key]

    def __getitem__(self, key: str) -> float:
        v = self._map[key].value(**self._labels)
        return int(v) if float(v).is_integer() else v

    def __setitem__(self, key: str, value) -> None:
        m = self._map.get(key)
        if m is None:
            raise KeyError(f"metrics view has no key {key!r}; register the "
                           f"metric when constructing the view")
        m.set(value, **self._labels)

    def __delitem__(self, key: str) -> None:
        raise TypeError("metrics views have a fixed key set")

    def __iter__(self):
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key) -> bool:
        return key in self._map

    def setdefault(self, key, default=None):
        # every key is pre-registered with value 0; setdefault is a no-op
        # read so ``stats.setdefault("submitted", 0)`` keeps working
        if key not in self._map:
            raise KeyError(f"metrics view has no key {key!r}")
        return self[key]

    def reset(self) -> None:
        for key in self._map:
            self._map[key].set(0.0, **self._labels)

    def __repr__(self) -> str:
        return repr({k: self[k] for k in self._map})
