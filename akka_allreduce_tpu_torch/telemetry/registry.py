"""Metrics registry of the port: the part ``ServingMetrics`` uses.

Counterpart of ``akka_allreduce_tpu/telemetry/registry.py``: the
nearest-rank :class:`Histogram` and a :class:`MetricsRegistry` of pull
collectors under unique (name, labels) keys — the registration style
``ServingMetrics`` uses, so export and summary read the same cells. Owned
counters and gauges, the Prometheus/JSON renderers, the snapshot
writer and the HTTP exposer are a later slice of the port.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Optional


class Histogram:
    """Append-only value log with nearest-rank percentiles; the sort is
    cached between records."""

    def __init__(self):
        self._vals: list[float] = []
        self._sorted: Optional[list[float]] = None
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        with self._lock:
            self._vals.append(float(v))
            self._sorted = None

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._vals)

    def _ranked(self) -> list[float]:
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self._vals)
            return self._sorted

    @staticmethod
    def _rank(s: list, p: float) -> float:
        return s[min(max(1, math.ceil(p / 100.0 * len(s))), len(s)) - 1]

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile, p in [0, 100]."""
        s = self._ranked()
        return self._rank(s, p) if s else None

    def summary(self, scale: float = 1.0, digits: int = 3) -> dict:
        s = self._ranked()
        if not s:
            return {"count": 0}
        r = lambda v: round(v * scale, digits)  # noqa: E731
        return {"count": len(s), "mean": r(sum(s) / len(s)),
                "p50": r(self._rank(s, 50)),
                "p90": r(self._rank(s, 90)),
                "p99": r(self._rank(s, 99)),
                "max": r(s[-1])}


class MetricsRegistry:
    """Named pull collectors. A (name, labels) pair registers once — two
    sources under one name is the aliasing bug a registry exists to catch
    — and one name keeps one kind."""

    def __init__(self):
        self._series: dict = {}  # (name, label items) -> (kind, pull)
        self._lock = threading.Lock()

    def _add(self, name: str, kind: str, labels: Optional[dict],
             pull: Callable) -> None:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            if key in self._series:
                raise ValueError(f"series {name} {labels or {}} already "
                                 f"registered")
            for (other, _), (have, _pull) in self._series.items():
                if other == name and have != kind:
                    raise ValueError(f"series {name} already registered "
                                     f"as {have}, not {kind}")
            self._series[key] = (kind, pull)

    def register_callback(self, name: str, pull: Callable[[], float],
                          kind: str = "counter", help: str = "",
                          labels: Optional[dict] = None) -> None:
        if kind not in ("counter", "gauge"):
            raise ValueError(f"unknown series kind {kind!r}")
        self._add(name, kind, labels, pull)

    def register_histogram(self, name: str,
                           pull: Callable[[], Histogram], help: str = "",
                           labels: Optional[dict] = None) -> None:
        self._add(name, "histogram", labels, pull)

    def value(self, name: str, labels: Optional[dict] = None) -> Any:
        """Read one series (a number, or the Histogram object)."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            entry = self._series.get(key)
        if entry is None:
            raise KeyError(f"no series {name} with labels {labels}")
        return entry[1]()

    def names(self) -> list:
        with self._lock:
            return sorted({name for name, _ in self._series})
