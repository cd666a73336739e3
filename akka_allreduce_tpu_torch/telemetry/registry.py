"""Metrics registry of the port: the one export surface for counters,
gauges and histograms.

Counterpart of ``akka_allreduce_tpu/telemetry/registry.py``: named
counters / gauges / histograms with label support, a Prometheus-text
renderer (counters and gauges as themselves, histograms as summary-typed
quantile series, so the text agrees exactly with the summary dicts the
CLIs print), a JSON renderer, an atomic snapshot file and a periodic
snapshot writer (``train --metrics-file``), and a parser of the text for
the repo's own checks. The stdlib HTTP exposer (``serve_http``,
``--metrics-port``) is left out with the rest of the HTTP plane
(ROADMAP.md A8).

Two registration styles, as in the JAX package:

* **owned series** (:meth:`MetricsRegistry.counter` / ``gauge`` /
  ``histogram``) — the registry allocates the cell and callers mutate it
  (device-time spans, the train loop's counters);
* **collector callbacks** (:meth:`MetricsRegistry.register_callback`
  and :meth:`register_histogram`) — a plane keeps its state
  (``ServingMetrics``' ints, a live ``Histogram``) and the registry pulls
  at export time, so export and summary read the same cells.

Mutation comes from the owning loop only; exports (the snapshot thread)
read point-in-time copies.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Callable, Optional


def atomic_write_text(path: str, text: str, fsync: bool = True) -> str:
    """Write-then-rename: a reader (scrape, restore) never sees a torn
    file, and with ``fsync`` (default) the content is durable before
    the rename makes it visible. The ONE atomic-write idiom shared by
    the metrics snapshot and any JSON sidecar."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class Histogram:
    """Append-only value log with nearest-rank percentiles.

    Serving tiers care about tails; at serving-bench sample counts
    (10^2-10^5) an exact sorted copy is cheaper than maintaining
    approximate sketch state per record. The sort is CACHED: it runs
    once per flush of new records, so a ``summary()`` (four
    percentiles + max) and repeated ``percentile()`` calls between
    records share one sort instead of re-sorting the full log each
    call."""

    def __init__(self):
        self._vals: list[float] = []
        self._sorted: Optional[list[float]] = None
        # the cache is read (and filled) by export threads while the
        # owning loop records — a lock keeps a reader's freshly-built
        # sort from overwriting a record()'s invalidation (which would
        # pin a stale distribution for the rest of the run). Uncontended
        # acquire is tens of ns; the sort it saves is the expensive part
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        with self._lock:
            self._vals.append(float(v))
            self._sorted = None

    @property
    def count(self) -> int:
        # read under the lock: count is read by the snapshot thread
        # while the owning loop records; the lock keeps it consistent
        # with the percentile snapshot read next to it
        with self._lock:
            return len(self._vals)

    @property
    def total(self) -> float:
        return sum(self._ranked())

    def _ranked(self) -> list[float]:
        """The sorted sample snapshot (cached; never mutated in place,
        so a returned list stays consistent even if a later record
        replaces the cache)."""
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self._vals)
            return self._sorted

    @staticmethod
    def _rank(s: list, p: float) -> float:
        return s[min(max(1, math.ceil(p / 100.0 * len(s))),
                     len(s)) - 1]

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile, p in [0, 100]."""
        s = self._ranked()
        return self._rank(s, p) if s else None

    def summary(self, scale: float = 1.0, digits: int = 3) -> dict:
        s = self._ranked()  # ONE snapshot serves every stat below
        if not s:
            return {"count": 0}
        r = lambda v: round(v * scale, digits)  # noqa: E731
        return {"count": len(s), "mean": r(sum(s) / len(s)),
                "p50": r(self._rank(s, 50)),
                "p90": r(self._rank(s, 90)),
                "p99": r(self._rank(s, 99)),
                "max": r(s[-1])}


class Counter:
    """Monotonic owned counter. ``inc()`` from the owning loop only."""

    def __init__(self):
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Owned point-in-time value."""

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


_KINDS = ("counter", "gauge", "histogram")
# nearest-rank quantiles the text format exports — chosen to be exactly
# the p50/p90/p99 the repo's summary dicts print, so the two surfaces
# can be asserted equal
_QUANTILES = (50, 90, 99)


class _Series:
    """One exported series: an owned cell or a pull callback."""

    def __init__(self, name: str, kind: str, help: str,
                 cell: Any = None, pull: Optional[Callable] = None,
                 labels: Optional[dict] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.cell = cell
        self.pull = pull
        self.labels = dict(labels or {})

    def read(self) -> Any:
        if self.pull is not None:
            return self.pull()
        if isinstance(self.cell, (Counter, Gauge)):
            return self.cell.value
        return self.cell  # Histogram

    def label_suffix(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in sorted(self.labels.items()))
        return "{" + inner + "}"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Integral values print as integers — diffable golden output."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Named series -> one Prometheus-text / JSON export surface.

    Names follow prometheus convention (``snake_case``, counters end
    ``_total``, base units in the name e.g. ``_seconds``). A (name,
    labels) pair registers once; duplicates raise — two planes
    silently writing one series is exactly the aliasing bug a registry
    exists to prevent.
    """

    def __init__(self):
        self._series: dict = {}  # (name, labelitems) -> _Series
        self._lock = threading.Lock()

    # -- registration ---------------------------------------------------

    def _add(self, s: _Series) -> _Series:
        if s.kind not in _KINDS:
            raise ValueError(f"unknown series kind {s.kind!r}")
        key = (s.name, tuple(sorted(s.labels.items())))
        with self._lock:
            have = self._series.get(key)
            if have is not None:
                # owned cells are get-or-create: a restarted component
                # (the drain/recovery choreography builds a FRESH
                # engine onto the same metrics sink) continues the
                # run's series instead of fighting over the name.
                # Callbacks stay strict — two pull sources under one
                # name is the aliasing bug a registry exists to catch.
                if (have.kind == s.kind and have.pull is None
                        and s.pull is None):
                    return have
                raise ValueError(
                    f"series {s.name}{s.label_suffix()} already "
                    f"registered")
            # one name, one kind/help — mixed-kind children under a
            # name would render invalid exposition text
            for other in self._series.values():
                if other.name == s.name and other.kind != s.kind:
                    raise ValueError(
                        f"series {s.name} already registered as "
                        f"{other.kind}, not {s.kind}")
            self._series[key] = s
        return s

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._add(_Series(name, "counter", help, cell=Counter(),
                                 labels=labels)).cell

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._add(_Series(name, "gauge", help, cell=Gauge(),
                                 labels=labels)).cell

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None) -> Histogram:
        return self._add(_Series(name, "histogram", help,
                                 cell=Histogram(), labels=labels)).cell

    def register_callback(self, name: str, pull: Callable[[], float],
                          kind: str = "counter", help: str = "",
                          labels: Optional[dict] = None) -> None:
        """A pull collector: ``pull()`` is read at export time. The hook
        existing planes use to re-register their series here without
        duplicating state (the callback reads the same cell the plane's
        own summary dict reads, so the two can never disagree)."""
        self._add(_Series(name, kind, help, pull=pull, labels=labels))

    def register_histogram(self, name: str,
                           pull: Callable[[], Histogram],
                           help: str = "",
                           labels: Optional[dict] = None) -> None:
        """A pull collector over a LIVE :class:`Histogram` (e.g. a
        ``ServingMetrics`` latency log)."""
        self._add(_Series(name, "histogram", help, pull=pull,
                          labels=labels))

    # -- introspection --------------------------------------------------

    def value(self, name: str, labels: Optional[dict] = None) -> Any:
        """Read one series (a number, or the Histogram object)."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            s = self._series.get(key)
        if s is None:
            raise KeyError(f"no series {name} with labels {labels}")
        return s.read()

    def names(self) -> list:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    # -- export ---------------------------------------------------------

    def _snapshot(self) -> list:
        with self._lock:
            return list(self._series.values())

    def to_prometheus_text(self) -> str:
        """Prometheus exposition text (format 0.0.4). Histograms render
        as summary-typed series: ``{quantile="0.5"}`` etc. lines whose
        values are the same nearest-rank percentiles the repo's summary
        dicts print, plus ``_sum`` / ``_count``."""
        by_name: dict = {}
        for s in self._snapshot():
            by_name.setdefault(s.name, []).append(s)
        lines = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = group[0].kind
            help_text = next((g.help for g in group if g.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for s in group:
                v = s.read()
                if kind != "histogram":
                    lines.append(f"{name}{s.label_suffix()} {_fmt(v)}")
                    continue
                h: Histogram = v
                base = dict(s.labels)
                for q in _QUANTILES:
                    p = h.percentile(q)
                    ql = _Series(name, kind, "", labels={
                        **base, "quantile": f"{q / 100:g}"})
                    lines.append(
                        f"{name}{ql.label_suffix()} "
                        f"{_fmt(p) if p is not None else 'NaN'}")
                lx = s.label_suffix()
                lines.append(f"{name}_sum{lx} {_fmt(h.total)}")
                lines.append(f"{name}_count{lx} {h.count}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """JSON snapshot: scalar series as numbers, histograms as their
        summary dicts (seconds, unrounded-at-source scale)."""
        out: dict = {}
        for s in self._snapshot():
            v = s.read()
            entry = out.setdefault(s.name, {"type": s.kind, "values": []})
            if s.kind == "histogram":
                entry["values"].append(
                    {"labels": s.labels, **v.summary(digits=6)})
            else:
                entry["values"].append({"labels": s.labels,
                                        "value": v})
        return out

    # -- snapshot file ---------------------------------------------------

    def write_snapshot(self, path: str, format: str = "prom") -> None:
        """Atomic snapshot write (:func:`atomic_write_text`): a scrape
        mid-write never sees a torn file. ``format``: ``prom`` |
        ``json``."""
        data = (self.to_prometheus_text() if format == "prom"
                else json.dumps(self.to_json(), indent=1) + "\n")
        atomic_write_text(path, data)

    def start_snapshotter(self, path: str, interval_s: float = 5.0,
                          format: str = "prom") -> "SnapshotWriter":
        return SnapshotWriter(self, path, interval_s, format).start()


class SnapshotWriter:
    """Background thread writing the registry snapshot every
    ``interval_s`` plus once at :meth:`stop` — the final write is the
    one a post-run reader sees."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float, format: str = "prom"):
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self.format = format
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SnapshotWriter":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.registry.write_snapshot(self.path, self.format)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.registry.write_snapshot(self.path, self.format)

    def __enter__(self) -> "SnapshotWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def parse_prometheus_text(text: str) -> dict:
    """Exposition text -> ``{(name, ((label, value), ...)): float}``.
    Just enough parser for the repo's own output — the tests and
    ``chip_smoke.py`` read the snapshots through it (a hand-rolled
    reader keeps the assert independent of the renderer's string
    building)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        metric, _, val = line.rpartition(" ")
        name, labels = metric, ()
        if "{" in metric:
            name, _, rest = metric.partition("{")
            inner = rest.rstrip("}")
            parsed = []
            for item in inner.split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                parsed.append((k, v.strip('"')))
            labels = tuple(sorted(parsed))
        out[(name, labels)] = float(val)
    return out
