"""Structured tracing + metrics for the protocol plane.

Counterpart of ``akka_allreduce_tpu/runtime/tracing.py``, copied as it is
(pure Python) but for the Chrome-trace export, which needs
``telemetry/chrome_trace.py`` (ROADMAP A8). The reference has no tracing
subsystem — its observability is ActorLogging debug lines on protocol
events (reference: AllreduceWorker.scala:119, :131, :178) and a
wall-clock goodput print in the benchmark sink (reference:
AllreduceWorker.scala:329-343). This is a cheap, structured, host-side
event trace that can be aggregated per round, exported as JSONL (one
object per event), and summarised into counters. Events are recorded on
the host around the protocol's messages; nothing here touches the
device or waits for it.

Usage::

    tracer = Tracer()
    tracer.record("round_start", round=0)
    with tracer.span("bucket_sync", round=0):
        ...
    tracer.counters["round_start"]        # -> 1
    tracer.round_latencies()              # round -> seconds
    tracer.write_jsonl(path)

Every protocol engine (worker/master) takes an optional ``tracer``; the
default ``None`` keeps the hot path free of any tracing cost.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured event: monotonic timestamp, kind, free-form fields.
    ``duration_s`` is present only for span-produced events.
    ``span_id`` / ``parent_id`` carry the nested-span parentage: every
    span gets a tracer-unique id, and any event recorded while a span
    is open (child spans AND point events) names the enclosing span as
    its parent — the structure the Perfetto export renders as nested
    slices and tests assert on directly."""

    ts: float
    kind: str
    fields: dict[str, Any]
    duration_s: Optional[float] = None
    span_id: Optional[int] = None
    parent_id: Optional[int] = None

    def as_dict(self) -> dict[str, Any]:
        d = {"ts": self.ts, "kind": self.kind, **self.fields}
        if self.duration_s is not None:
            d["duration_s"] = self.duration_s
        if self.span_id is not None:
            d["span_id"] = self.span_id
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        return d


class Tracer:
    """Append-only event log + per-kind counters.

    Not thread-safe by design: each host process traces its own protocol
    engine (one mailbox, one thread — the same safety argument as the
    reference's actor model, SURVEY.md §5.2). The open-span stack rides
    that same rule: spans nest lexically in the tracing thread.
    """

    def __init__(self, clock=time.perf_counter, max_events: int = 1_000_000):
        self._clock = clock
        self._max_events = max_events
        self.events: list[TraceEvent] = []
        self.counters: dict[str, int] = defaultdict(int)
        self._next_span_id = 1
        # the open-span stack is PER THREAD: background recorders (the
        # host sampler, a watchdog worker) must not have their events
        # parented to whatever span the main thread happens to have
        # open — cross-thread "nesting" would be a lie about structure
        self._tls = threading.local()

    @property
    def _span_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @property
    def current_span_id(self) -> Optional[int]:
        """The innermost span open ON THIS THREAD (None outside any)."""
        stack = self._span_stack
        return stack[-1] if stack else None

    def record(self, kind: str, **fields: Any) -> TraceEvent:
        ev = TraceEvent(ts=self._clock(), kind=kind, fields=fields,
                        parent_id=self.current_span_id)
        self._append(ev)
        return ev

    def record_transition(self, t: str, **fields: Any) -> TraceEvent:
        """A fleet control-plane transition: one ``fleet_transition``
        event whose ``t`` field names a transition of the JAX package's
        fleet model (ROADMAP A8 and A11 bring the fleet and its
        checker)."""
        return self.record("fleet_transition", t=t, **fields)

    @contextmanager
    def span(self, kind: str, **fields: Any):
        """Time a block; records one event with ``duration_s`` on exit.
        Spans opened (and point events recorded) inside the block carry
        this span's id as their ``parent_id`` — nesting is structural,
        not inferred from timestamps. Yields the span id (useful as a
        correlation handle)."""
        sid = self._next_span_id
        self._next_span_id += 1
        parent = self.current_span_id
        self._span_stack.append(sid)
        t0 = self._clock()
        try:
            yield sid
        finally:
            t1 = self._clock()
            self._span_stack.pop()
            self._append(TraceEvent(ts=t0, kind=kind, fields=fields,
                                    duration_s=t1 - t0, span_id=sid,
                                    parent_id=parent))

    def record_span(self, kind: str, ts: float, duration_s: float,
                    **fields: Any) -> TraceEvent:
        """Append an already-timed span (the device-span helper measures
        host/device splits itself and reports afterwards). Parented to
        the currently open span like any other event."""
        sid = self._next_span_id
        self._next_span_id += 1
        ev = TraceEvent(ts=ts, kind=kind, fields=fields,
                        duration_s=duration_s, span_id=sid,
                        parent_id=self.current_span_id)
        self._append(ev)
        return ev

    def _append(self, ev: TraceEvent) -> None:
        self.counters[ev.kind] += 1
        if len(self.events) < self._max_events:
            self.events.append(ev)

    # -- aggregation --------------------------------------------------------

    def round_latencies(self, start_kind: str = "round_start",
                        end_kind: str = "round_complete") -> dict[int, float]:
        """Per-round wall latency: first ``start_kind`` to last ``end_kind``
        carrying the same ``round`` field."""
        starts: dict[int, float] = {}
        ends: dict[int, float] = {}
        for ev in self.events:
            r = ev.fields.get("round")
            if r is None:
                continue
            if ev.kind == start_kind:
                starts.setdefault(r, ev.ts)
            elif ev.kind == end_kind:
                ends[r] = ev.ts
        return {r: ends[r] - starts[r] for r in starts if r in ends
                and ends[r] >= starts[r]}

    def span_stats(self, kind: str) -> dict[str, float]:
        """count / total / mean / max seconds across spans of ``kind``."""
        ds = [ev.duration_s for ev in self.events
              if ev.kind == kind and ev.duration_s is not None]
        if not ds:
            return {"count": 0, "total_s": 0.0, "mean_s": 0.0, "max_s": 0.0}
        return {"count": len(ds), "total_s": sum(ds),
                "mean_s": sum(ds) / len(ds), "max_s": max(ds)}

    def summary(self) -> dict[str, Any]:
        lat = self.round_latencies()
        out: dict[str, Any] = {"counters": dict(self.counters),
                               "events": len(self.events)}
        if lat:
            vals = list(lat.values())
            out["rounds_traced"] = len(vals)
            out["round_latency_mean_s"] = sum(vals) / len(vals)
            out["round_latency_max_s"] = max(vals)
        return out

    # -- export -------------------------------------------------------------

    def write_jsonl(self, path: str) -> int:
        """One JSON object per line; returns events written."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev.as_dict()) + "\n")
        return len(self.events)

    @staticmethod
    def read_jsonl(path: str) -> list[dict[str, Any]]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


@contextmanager
def tracer_to_file(path: Optional[str]):
    """Yield a :class:`Tracer` (or ``None`` when ``path`` is falsy) and
    write its JSONL on exit — INCLUDING exceptional exits (Ctrl-C, engine
    errors), which is exactly when an operator needs the trace. The one
    setup for every --trace-file surface (``cli.py emulate``)."""
    if not path:
        yield None
        return
    tracer = Tracer()
    try:
        yield tracer
    finally:
        tracer.write_jsonl(path)
