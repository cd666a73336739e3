"""Device-time attribution for dispatch sites (the train step).

Counterpart of ``akka_allreduce_tpu/telemetry/device.py``, with the same
series and definitions. A dispatch loop's operator asks how much of a
step was the DEVICE and how much the host sitting between dispatches;
this module brackets each dispatch three ways at once, all on the host
(nothing here runs inside the step):

* a ``torch.profiler.record_function`` range named ``<name>#<step>``
  (the JAX package's ``StepTraceAnnotation``): a live ``--xprof-dir``
  trace then carries named step regions;
* wall deltas around the blocking readback: the caller marks the
  instant its dispatch call returned (``mark_dispatched``); host time is
  start -> mark (launching the step's work), device time is mark -> exit
  (the blocking loss readback);
* ``dispatch_gap_ms``: the previous span's exit -> this span's start on
  the same timer, the host-side bubble between dispatches.

Series land on a :class:`~akka_allreduce_tpu_torch.telemetry.registry.
MetricsRegistry` as ``<name>_dispatch_host_ms`` / ``_device_ms`` /
``_gap_ms`` histograms (standalone histograms when no registry is given),
and each span optionally records a ``<name>_dispatch`` Tracer span.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from akka_allreduce_tpu_torch.telemetry.registry import (Histogram,
                                                         MetricsRegistry)


def _step_annotation(name: str, step: int):
    """The profiler range of one dispatch (a no-op when no profiler is
    recording)."""
    from torch.profiler import record_function
    return record_function(f"{name}#{step}")


class DeviceSpan:
    """One bracketed dispatch (context manager; use via
    :meth:`DeviceTimer.span`). Call :meth:`mark_dispatched` the moment
    the dispatch call returns, before the blocking readback: everything
    after the mark is the device-time attribution. An unmarked span
    charges its whole duration to host time."""

    def __init__(self, timer: "DeviceTimer", fields: dict):
        self._timer = timer
        self._fields = fields
        self._ann = None
        self._t0 = 0.0
        self._t_mark: Optional[float] = None

    def mark_dispatched(self) -> None:
        self._t_mark = self._timer._clock()

    def annotation(self):
        """The profiler range for a timer configured with
        ``annotate_site="dispatch"``: the caller opens it around the
        dispatched callable, on whatever thread runs it. Returns a
        context manager (null when annotation is off or owned by the
        span)."""
        t = self._timer
        if t.annotate and t.annotate_site == "dispatch":
            return _step_annotation(t.name, t._step)
        return contextlib.nullcontext()

    def __enter__(self) -> "DeviceSpan":
        t = self._timer
        self._t0 = t._clock()
        if t._last_end is not None:
            t.gap_ms.record((self._t0 - t._last_end) * 1e3)
        if t.annotate and t.annotate_site == "span":
            self._ann = _step_annotation(t.name, t._step)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        t = self._timer
        if self._ann is not None:
            self._ann.__exit__(*exc)
        if exc and exc[0] is not None:
            # a failed dispatch is no device-time sample, and the next
            # span starts gap-free
            t._last_end = None
            return
        end = t._clock()
        t._last_end = end
        t._step += 1
        mark = self._t_mark
        host_s = (mark - self._t0) if mark is not None else end - self._t0
        device_s = (end - mark) if mark is not None else 0.0
        t.host_ms.record(host_s * 1e3)
        t.device_ms.record(device_s * 1e3)
        if t.tracer is not None:
            t.tracer.record_span(
                f"{t.name}_dispatch", ts=self._t0,
                duration_s=end - self._t0,
                host_ms=round(host_s * 1e3, 3),
                device_ms=round(device_s * 1e3, 3),
                **self._fields)


class DeviceTimer:
    """Per-site device-time series: one per dispatch site (the
    ``train_step`` loop); wrap each dispatch in :meth:`span`. Cost: a
    handful of clock reads and histogram appends a dispatch."""

    def __init__(self, name: str,
                 registry: Optional[MetricsRegistry] = None,
                 tracer=None, annotate: bool = True,
                 annotate_site: str = "span",
                 clock=time.perf_counter):
        if annotate_site not in ("span", "dispatch"):
            raise ValueError(f"annotate_site must be 'span' or "
                             f"'dispatch', got {annotate_site!r}")
        self.name = name
        self.tracer = tracer
        self.annotate = annotate
        # "span": the range opens with the span on the calling thread
        # (the train loop dispatches right there); "dispatch": the caller
        # opens DeviceSpan.annotation() inside its dispatch callable
        self.annotate_site = annotate_site
        self._clock = clock
        self._last_end: Optional[float] = None
        self._step = 0
        if registry is not None:
            self.host_ms = registry.histogram(
                f"{name}_dispatch_host_ms",
                help=f"{name}: dispatch-call host time per dispatch")
            self.device_ms = registry.histogram(
                f"{name}_dispatch_device_ms",
                help=f"{name}: block-until-ready wall delta per "
                     f"dispatch (device + transfer)")
            self.gap_ms = registry.histogram(
                f"{name}_dispatch_gap_ms",
                help=f"{name}: host-side bubble between consecutive "
                     f"dispatches")
        else:
            self.host_ms = Histogram()
            self.device_ms = Histogram()
            self.gap_ms = Histogram()

    def span(self, **fields) -> DeviceSpan:
        return DeviceSpan(self, fields)

    def reset_gap(self) -> None:
        """Forget the previous span's end: the next span records no gap."""
        self._last_end = None

    def summary(self) -> dict:
        return {
            "host_ms": self.host_ms.summary(digits=3),
            "device_ms": self.device_ms.summary(digits=3),
            "dispatch_gap_ms": self.gap_ms.summary(digits=3),
        }
