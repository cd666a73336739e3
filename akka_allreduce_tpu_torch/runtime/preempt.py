"""Cloud preemption notice -> serving drain.

The port's own copy of ``akka_allreduce_tpu/runtime/preempt.py``
(stdlib only). The notice is the host's, not the accelerator's: a
preemptible GCE VM carrying a GPU flips the same metadata key. The
text below follows the original's.

The serving plane has a complete preemption story —
``ServingEngine.request_drain()`` stops admission, in-flight requests
snapshot as :class:`~akka_allreduce_tpu_torch.serving.engine.ResumableRequest`
and persist across the process boundary (``serve --drain-dir``), and a
fresh engine restores them. What was
missing is the REAL trigger: on a preemptible TPU VM the platform's
advance warning is not (only) a SIGTERM — GCE flips the instance
metadata key ``instance/preempted`` to ``TRUE`` (and ACPI-G2 soft-off
follows within ~30 s). A process that only listens for SIGTERM hears
about the preemption from whoever forwards it, if anyone does; polling
the metadata server hears it from the source.

:class:`PreemptionWatcher` is that poller: a daemon thread GETs the
metadata URL (stdlib ``urllib`` — no deps) every ``interval_s`` with
the required ``Metadata-Flavor: Google`` header, and the first ``TRUE``
fires ``on_preempt`` exactly once — wired by the serve CLI to the same
``engine.request_drain()`` the SIGTERM handler calls, so both signals
converge on one drain path. Unreachable metadata (every non-GCE box,
including CI) is quietly tolerated: the watcher keeps polling and never
fires, costing one refused connection per interval.

The URL is injectable for tests (tests/test_torch_preempt.py runs a local
stdlib HTTP server that flips from FALSE to TRUE) — the same
fake-the-boundary discipline as runtime/faults.py: the handler path
from notice to drain is exercised for real, only the GCE endpoint is
simulated.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request

GCE_PREEMPTED_URL = ("http://metadata.google.internal/computeMetadata"
                     "/v1/instance/preempted")


class PreemptionWatcher:
    """Poll a GCE-style metadata endpoint; fire ``on_preempt`` once.

    ``on_preempt`` runs on the watcher thread — keep it tiny and
    thread-safe (``engine.request_drain`` only flips a bool; the serve
    loop notices between dispatches, exactly like the SIGTERM path).
    ``timeout_s`` bounds each request so a hung metadata server can
    never hold the thread past a poll cycle. Use as a context manager
    around the serve loop, or ``start()``/``stop()`` explicitly."""

    def __init__(self, on_preempt, url: str = GCE_PREEMPTED_URL,
                 interval_s: float = 1.0, timeout_s: float = 2.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.on_preempt = on_preempt
        self.url = url
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.fired = False
        self.polls = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def poll_once(self) -> bool:
        """One metadata read: True iff the instance is marked preempted.
        Errors (no metadata server, refused, timeout) count and read as
        False — absence of the signal, not presence."""
        self.polls += 1
        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.read().decode("utf-8",
                                          "replace").strip() == "TRUE"
        except (urllib.error.URLError, OSError, ValueError):
            self.errors += 1
            return False

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.poll_once():
                self.fired = True
                self.on_preempt()
                return  # one notice is the whole message
            self._stop.wait(self.interval_s)

    def start(self) -> "PreemptionWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._thread = threading.Thread(
            target=self._run, name="preempt-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.interval_s)
            self._thread = None

    def __enter__(self) -> "PreemptionWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
