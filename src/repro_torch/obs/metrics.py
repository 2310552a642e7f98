"""Metrics registry: counters and fixed-bucket histograms.

Counterpart of ``repro/obs/metrics.py`` (stdlib only), with the kinds the
trainer and the serving engine record: counters, gauges and histograms.
``NULL_REGISTRY`` (permanently disabled) is the default sink of a component
built without one, so instrumented code never branches on ``None``. Every mutator checks its registry's ``enabled`` flag
first, so a disabled registry costs one attribute read; each metric takes
its own lock, so counts do not rest on the interpreter lock. ``counter(name)``
and ``histogram(name)`` get or create, and a name registered as the other
kind raises.
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterable, Optional, Tuple

# seconds-scale latency buckets: 50us .. 30s, roughly x4 per step
DEFAULT_BUCKETS: Tuple[float, ...] = (
    5e-5, 2e-4, 1e-3, 4e-3, 1.6e-2, 6.4e-2, 0.25, 1.0, 4.0, 30.0)


class _Metric:
    kind = "metric"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str = ""):
        self._reg = registry
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) would decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help="", buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram {name}: bucket bounds must be non-empty, sorted "
                             f"and unique, got {bounds}")
        self.bounds = bounds
        # counts[i] = observations <= bounds[i]; counts[-1] = overflow (+inf)
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self):
        return {"count": self._count, "sum": self._sum,
                "buckets": dict(zip([*map(str, self.bounds), "+inf"], self._counts))}


class MetricsRegistry:
    """A namespace of metrics; each trainer keeps its own."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(f"metric {name!r} already registered as {m.kind}, "
                                     f"requested {cls.kind}")
                return m
            m = cls(self, name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """``{name: value}`` for counters, ``{name: {count, sum, buckets}}``
        for histograms, sorted by name."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def dump_json(self, path: Optional[str] = None) -> str:
        """Snapshot as a JSON string; also written to ``path`` if given."""
        text = json.dumps({"metrics": self.snapshot()}, indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text + "\n")
        return text


# a permanently disabled sink: the default for uninstrumented construction,
# so producers never branch on whether observability is on
NULL_REGISTRY = MetricsRegistry(enabled=False)

# the process-wide default registry (module-level producers)
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return REGISTRY
