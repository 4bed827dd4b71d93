"""Thread-safe metrics registry (a stdlib copy of ``repro.obs.metrics``).

Counters, gauges, and bounded-reservoir histograms (p50/p95/p99),
registered by the admission service, the trace store, the daemon, the
fleet scheduler, and the fault harness, and exported in Prometheus
text-exposition format and JSON through the daemon's ``metrics`` kind.

Two design constraints shape this module:

* **Single source of truth.** The service's ``stats()``/``health()``
  dicts and the daemon's ``metrics`` kind all read the same registry
  objects, so the three wire shapes can never drift apart. Legacy
  dict-shaped counters (``FleetScheduler.counters``,
  ``rung_counts``) are served by :class:`CounterDict`, a mapping
  facade over per-key labeled counters — ``counters[k] += 1`` and
  ``summary.update(**sched.counters)`` keep working bit-for-bit.
* **Determinism.** The repo pins bit-identical replays everywhere, so
  the histogram reservoir is a deterministic bounded ring (newest N
  observations), never a random sample; count/sum/min/max stay exact
  over the full stream.

Zero dependencies beyond the standard library.
"""
from __future__ import annotations

import threading
from collections import deque


def _fmt_labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. ``set`` exists only for the
    :class:`CounterDict` facade (read-modify-write under its lock)."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, v: int) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A value that can go up and down (e.g. requests in flight)."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Bounded-reservoir histogram. The reservoir is a deterministic
    ring of the newest ``reservoir`` observations (no random sampling —
    the repo pins bit-identical results); count/sum/min/max are exact
    over everything ever observed, and p50/p95/p99 come from the
    sorted reservoir snapshot."""

    kind = "histogram"
    QUANTILES = (0.5, 0.95, 0.99)
    __slots__ = ("name", "help", "labels", "reservoir", "_lock",
                 "_ring", "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, help: str = "",
                 labels: dict | None = None, reservoir: int = 1024):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.reservoir = reservoir
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=reservoir)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v: float) -> None:
        with self._lock:
            self._ring.append(v)
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    @property
    def max(self):
        with self._lock:
            return self._max

    def percentile(self, q: float):
        with self._lock:
            data = sorted(self._ring)
        if not data:
            return None
        idx = min(len(data) - 1, int(q * len(data)))
        return data[idx]

    def snapshot(self) -> dict:
        with self._lock:
            data = sorted(self._ring)
            out = {"count": self._count, "sum": self._sum,
                   "min": self._min, "max": self._max,
                   "mean": self._sum / self._count if self._count
                   else 0.0}
        for q in self.QUANTILES:
            out[f"p{int(q * 100)}"] = (
                data[min(len(data) - 1, int(q * len(data)))]
                if data else None)
        return out


class MetricsRegistry:
    """Get-or-create registry of named (and optionally labeled)
    metrics, plus pull-time *collectors* for subsystems that keep
    their own counters (trace cache, store, decision log, faults)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._collectors: dict = {}

    def _get(self, cls, name: str, help: str, labels: dict | None,
             **kwargs):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None,
                  reservoir: int = 1024) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         reservoir=reservoir)

    def register_collector(self, name: str, fn) -> None:
        """``fn()`` returns a flat ``{series_name: number}`` dict
        gathered at export time. Re-registering a name replaces it."""
        with self._lock:
            self._collectors[name] = fn

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def _collect(self) -> dict:
        with self._lock:
            collectors = list(self._collectors.items())
        def _emit(out, series, v):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[series] = v
            elif isinstance(v, dict):
                # flatten one nesting level (cache stats carry a
                # nested store/quarantine dict)
                for k2, v2 in v.items():
                    if isinstance(v2, (int, float)) and not \
                            isinstance(v2, bool):
                        out[f"{series}_{k2}"] = v2

        out = {}
        for name, fn in collectors:
            try:
                for k, v in (fn() or {}).items():
                    _emit(out, f"{name}_{k}", v)
            except Exception:
                # a broken collector must never take down an export
                out[f"{name}_collect_errors"] = 1
        return out

    def to_json(self) -> dict:
        counters, gauges, histograms = {}, {}, {}
        for m in self.metrics():
            series = m.name + _fmt_labels(m.labels)
            if m.kind == "counter":
                counters[series] = m.value
            elif m.kind == "gauge":
                gauges[series] = m.value
            else:
                histograms[series] = m.snapshot()
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms, "collected": self._collect()}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4).
        Histograms are exported summary-style (quantile series plus
        ``_count``/``_sum``)."""
        lines = []
        seen_type = set()
        for m in self.metrics():
            if m.name not in seen_type:
                seen_type.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                ptype = ("summary" if m.kind == "histogram"
                         else m.kind)
                lines.append(f"# TYPE {m.name} {ptype}")
            if m.kind == "histogram":
                snap = m.snapshot()
                for q in m.QUANTILES:
                    v = snap[f"p{int(q * 100)}"]
                    if v is None:
                        continue
                    labels = dict(m.labels)
                    labels["quantile"] = repr(q)
                    lines.append(
                        f"{m.name}{_fmt_labels(labels)} {v}")
                lines.append(
                    f"{m.name}_count{_fmt_labels(m.labels)} "
                    f"{snap['count']}")
                lines.append(
                    f"{m.name}_sum{_fmt_labels(m.labels)} "
                    f"{snap['sum']}")
            else:
                lines.append(
                    f"{m.name}{_fmt_labels(m.labels)} {m.value}")
        for series, v in sorted(self._collect().items()):
            lines.append(f"{series} {v}")
        return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse Prometheus text exposition back into
    ``{series_with_labels: float}`` — the round-trip check used by
    ``benchmarks/report.py --check`` and the obs tests."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        out[series] = float(value)
    return out


class CounterDict:
    """Mapping facade over per-key labeled registry counters.

    Replaces hand-rolled ``{key: int}`` counter dicts
    (``FleetScheduler.counters``, the service rung counts) so the same
    numbers flow to legacy summaries *and* the metrics export:
    ``d[k] += 1``, ``dict(d)``, ``summary.update(**d)``, and equality
    against a plain dict all behave exactly as before.
    """

    def __init__(self, keys=(), registry: MetricsRegistry | None = None,
                 name: str = "xmem_events_total", label: str = "event",
                 help: str = ""):
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        self._name = name
        self._label = label
        self._help = help
        self._lock = threading.Lock()
        self._counters = {}
        for k in keys:
            self._counter_for(k)

    def _counter_for(self, key) -> Counter:
        c = self._counters.get(key)
        if c is None:
            c = self._registry.counter(
                self._name, self._help, labels={self._label: str(key)})
            self._counters[key] = c
        return c

    def __getitem__(self, key) -> int:
        return self._counters[key].value

    def __setitem__(self, key, value) -> None:
        with self._lock:
            self._counter_for(key).set(int(value))

    def __contains__(self, key) -> bool:
        return key in self._counters

    def __iter__(self):
        return iter(list(self._counters))

    def __len__(self) -> int:
        return len(self._counters)

    def keys(self):
        return list(self._counters)

    def values(self):
        return [c.value for c in self._counters.values()]

    def items(self):
        return [(k, c.value) for k, c in self._counters.items()]

    def get(self, key, default=None):
        c = self._counters.get(key)
        return c.value if c is not None else default

    def inc(self, key, n: int = 1) -> None:
        with self._lock:
            self._counter_for(key).inc(n)

    def __eq__(self, other) -> bool:
        if isinstance(other, CounterDict):
            return dict(self.items()) == dict(other.items())
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"CounterDict({dict(self.items())!r})"
