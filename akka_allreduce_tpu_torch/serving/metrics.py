"""Serving observability of the port: request-lifecycle histograms.

Counterpart of ``akka_allreduce_tpu/serving/metrics.py``
:class:`ServingMetrics`: TTFT (submit -> first token delivery), TPOT
(decode cadence after the first delivery), queue depth, slot occupancy
and wasted tokens, the speculative engines' draft-token ledger,
mid-flight evictions and the fault counters (watchdog trips, retries,
dead letters, injected and survived faults, drains persisted),
re-registered on a :class:`MetricsRegistry` as pull collectors, and
``summary()`` with the JAX key names so the two serve commands print the
same report shape. With a :class:`~akka_allreduce_tpu_torch.runtime.
tracing.Tracer` every lifecycle hook also records the JAX package's
``serve_*`` event (``serve_submit`` ... ``serve_complete``), which
``serve --trace-file`` writes as JSONL beside the engine's
``serve_prefill`` / ``serve_step`` spans. Admission blocks, host sampling
and ``FleetMetrics`` are later slices (ROADMAP A8).
"""

from __future__ import annotations

import time
from typing import Optional

from akka_allreduce_tpu_torch.telemetry.registry import (  # noqa: F401
    Histogram,
    MetricsRegistry,
)


class ServingMetrics:
    """The engine and serve loop call the ``on_*`` hooks; ``summary()``
    renders one JSON-able dict (the serve CLI's stdout line)."""

    def __init__(self, clock=time.monotonic, tracer=None, registry=None):
        self.clock = clock
        self.tracer = tracer
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.ttft_s = Histogram()
        self.tpot_s = Histogram()
        self.queue_depth = Histogram()
        self.slot_occupancy = Histogram()
        # per completion: block steps computed after the lane's done-mask
        # latched (0 at decode_steps=1)
        self.wasted_per_completion = Histogram()
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.wasted_tokens = 0
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_rejected = 0
        # the speculative engines' draft-token ledger: proposed ==
        # accepted + rejected per block; rejected tokens are verify work
        # computed and thrown away, so they feed wasted_tokens. The
        # per-completion acceptance histogram is the choosing-k signal.
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.draft_rejected = 0
        self.draft_acceptance = Histogram()
        self.retries_total = 0
        self.evictions_total = 0
        self.deadline_misses_total = 0
        self.watchdog_trips_total = 0
        self.dead_letter_total = 0
        self.requests_failed = 0
        self.fault_injected = 0
        self.fault_survived = 0
        self._first: dict[int, float] = {}
        self._first_count: dict[int, int] = {}
        self._t0: Optional[float] = None
        self._t_end: Optional[float] = None
        self._paging = None
        # drained requests persisted across a process boundary: a
        # registry-owned counter (the drain runbook watches it)
        self._drain_persisted = self.registry.counter(
            "serve_drain_persisted_total",
            help="drained ResumableRequests persisted across a process "
                 "boundary (serving/engine.py persist_drained)")
        self._register(self.registry)

    def _register(self, r) -> None:
        counters = (
            ("serve_submitted_total", lambda: self.requests_submitted),
            ("serve_completed_total", lambda: self.requests_completed),
            ("serve_rejected_total", lambda: self.requests_rejected),
            ("serve_failed_attempts_total", lambda: self.requests_failed),
            ("serve_retries_total", lambda: self.retries_total),
            ("serve_evictions_total", lambda: self.evictions_total),
            ("serve_deadline_misses_total",
             lambda: self.deadline_misses_total),
            ("serve_watchdog_trips_total",
             lambda: self.watchdog_trips_total),
            ("serve_dead_letter_total", lambda: self.dead_letter_total),
            ("serve_fault_injected_total", lambda: self.fault_injected),
            ("serve_fault_survived_total", lambda: self.fault_survived),
            ("serve_prefill_tokens_total", lambda: self.prefill_tokens),
            ("serve_decode_tokens_total", lambda: self.decode_tokens),
            ("serve_wasted_tokens_total", lambda: self.wasted_tokens),
            ("serve_draft_proposed_total", lambda: self.draft_proposed),
            ("serve_draft_accepted_total", lambda: self.draft_accepted),
            ("serve_draft_rejected_total", lambda: self.draft_rejected),
        )
        for name, pull in counters:
            r.register_callback(name, pull, kind="counter")
        histograms = (
            ("serve_ttft_seconds", lambda: self.ttft_s),
            ("serve_tpot_seconds", lambda: self.tpot_s),
            ("serve_queue_depth", lambda: self.queue_depth),
            ("serve_slot_occupancy", lambda: self.slot_occupancy),
            ("serve_wasted_per_completion",
             lambda: self.wasted_per_completion),
            ("serve_draft_acceptance", lambda: self.draft_acceptance),
        )
        for name, pull in histograms:
            r.register_histogram(name, pull)

    def attach_paging(self, paging_summary) -> None:
        """Fold the paged engine's page-pool summary (a zero-arg
        callable) into ``summary()`` and the registry."""
        if self._paging is not None:
            raise RuntimeError("paging already attached")
        self._paging = paging_summary
        for name, key in (("serve_page_pool_pages", "pages_total"),
                          ("serve_page_pool_free", "pages_free"),
                          ("serve_page_pool_utilization", "utilization"),
                          ("serve_page_fragmentation", "fragmentation"),
                          ("serve_prefix_hit_rate", "prefix_hit_rate")):
            self.registry.register_callback(
                name, (lambda k=key: self._paging()[k]), kind="gauge")
        for name, key in (("serve_prefix_pages_shared_total",
                           "pages_shared_total"),
                          ("serve_cow_splits_total", "cow_splits_total")):
            self.registry.register_callback(
                name, (lambda k=key: self._paging()[k]), kind="counter")

    # -- lifecycle hooks ----------------------------------------------

    def _record(self, kind: str, **fields) -> None:
        if self.tracer is not None:
            self.tracer.record(kind, **fields)

    def on_submit(self, rid: int) -> None:
        self.requests_submitted += 1
        if self._t0 is None:
            self._t0 = self.clock()
        self._record("serve_submit", rid=rid)

    def on_reject(self, rid: int) -> None:
        self.requests_rejected += 1
        self._record("serve_reject", rid=rid)

    def on_admit(self, rid: int, slot: int, prompt_len: int) -> None:
        self.prefill_tokens += prompt_len
        self._record("serve_admit", rid=rid, slot=slot,
                     prompt_len=prompt_len)

    def on_token(self, rid: int, submitted_at: float) -> None:
        self.on_block_tokens(rid, submitted_at, 1)

    def on_block_tokens(self, rid: int, submitted_at: float,
                        n: int) -> None:
        """``n`` tokens delivered to ``rid`` at this instant; the first
        delivery banks TTFT and remembers its size, so TPOT counts only
        tokens that arrived after it."""
        if n < 1:
            return
        self.decode_tokens += n
        if rid not in self._first:
            now = self.clock()
            self._first[rid] = now
            self._first_count[rid] = n
            self.ttft_s.record(now - submitted_at)
            self._record("serve_first_token", rid=rid,
                         ttft_s=now - submitted_at, tokens=n)

    def on_failure(self, rid: int, reason: str) -> None:
        """One failed attempt (the retry budget decides what is
        terminal); a retried attempt banks its own TTFT."""
        self.requests_failed += 1
        self._first.pop(rid, None)
        self._first_count.pop(rid, None)
        self._record("serve_failure", rid=rid, reason=reason)

    def on_discard(self, rid: int, n: int) -> None:
        """``n`` partial-decode tokens thrown away: moved from the decode
        count to the wasted count."""
        self.decode_tokens -= n
        self.wasted_tokens += n
        self._record("serve_discard", rid=rid, tokens=n)

    def on_retry(self, rid: int) -> None:
        self.retries_total += 1
        self._record("serve_retry", rid=rid)

    def on_watchdog_trip(self) -> None:
        self.watchdog_trips_total += 1
        self._record("serve_watchdog_trip")

    def on_drop(self, rid: int, reason: str) -> None:
        if reason == "dead_letter":
            self.dead_letter_total += 1
        elif reason == "rejected_infeasible":
            self.deadline_misses_total += 1
        self._record("serve_drop", rid=rid, reason=reason)

    def on_fault_injected(self, n: int = 1) -> None:
        """Stamped by the chaos harness from ``FaultPlan.fired``: the
        engine cannot tell an injected hang from a real one."""
        self.fault_injected += n

    def on_fault_survived(self, kind: str) -> None:
        self.fault_survived += 1
        self._record("serve_fault_survived", fault=kind)

    def on_drain_persisted(self, n: int) -> None:
        """``n`` drained ResumableRequests written through
        runtime/checkpoint.py: the preemption survived a process
        boundary, not just a loop exit."""
        self._drain_persisted.inc(n)
        self._record("serve_drain_persisted", count=n)

    def on_evict(self, rid: int, n_tokens: int) -> None:
        """Mid-flight deadline eviction: terminal, and a deadline miss.
        Clears the first-token bookkeeping an evicted request never
        reaches ``on_complete`` to clear."""
        self.evictions_total += 1
        self.deadline_misses_total += 1
        self._first.pop(rid, None)
        self._first_count.pop(rid, None)
        self._record("serve_evict", rid=rid, tokens=n_tokens)

    def on_draft_block(self, rid: int, proposed: int,
                       accepted: int) -> None:
        """One speculative block settled for ``rid``: ``proposed`` draft
        tokens scored by the verify, ``accepted`` of them in the emitted
        stream (a proposal cut by EOS or the budget counts rejected).
        Rejected tokens move into the wasted account."""
        self.draft_proposed += proposed
        self.draft_accepted += accepted
        rejected = proposed - accepted
        self.draft_rejected += rejected
        self.wasted_tokens += rejected
        self._record("serve_draft_block", rid=rid, proposed=proposed,
                     accepted=accepted)

    def on_draft_complete(self, rid: int, rate: float) -> None:
        """A speculative request finished: bank its lifetime acceptance
        rate (accepted / proposed)."""
        self.draft_acceptance.record(rate)
        self._record("serve_draft_complete", rid=rid,
                     acceptance=round(rate, 4))

    def on_wasted(self, rid: int, n: int) -> None:
        self.wasted_tokens += n
        self.wasted_per_completion.record(n)
        self._record("serve_wasted", rid=rid, tokens=n)

    def on_complete(self, rid: int, n_tokens: int, reason: str) -> None:
        self.requests_completed += 1
        now = self.clock()
        self._t_end = now
        first = self._first.pop(rid, None)
        later = n_tokens - self._first_count.pop(rid, 1)
        if first is not None and later > 0:
            self.tpot_s.record((now - first) / later)
        self._record("serve_complete", rid=rid, tokens=n_tokens,
                     reason=reason)

    def observe(self, queue_depth: int, occupancy: float) -> None:
        """Sampled once per serve-loop iteration."""
        self.queue_depth.record(queue_depth)
        self.slot_occupancy.record(occupancy)

    # -- reporting -----------------------------------------------------

    @property
    def wall_s(self) -> Optional[float]:
        if self._t0 is None or self._t_end is None:
            return None
        return self._t_end - self._t0

    @property
    def decode_tokens_per_s(self) -> Optional[float]:
        w = self.wall_s
        return self.decode_tokens / w if w and w > 0 else None

    def summary(self) -> dict:
        computed = self.decode_tokens + self.wasted_tokens
        out = {
            "requests": {"submitted": self.requests_submitted,
                         "completed": self.requests_completed,
                         "rejected": self.requests_rejected,
                         "failed_attempts": self.requests_failed},
            "tokens": {"prefill": self.prefill_tokens,
                       "decode": self.decode_tokens,
                       "wasted": self.wasted_tokens},
            "wasted_token_rate": round(
                self.wasted_tokens / computed, 4) if computed else 0.0,
            "faults": {
                "retries_total": self.retries_total,
                "evictions_total": self.evictions_total,
                "deadline_misses_total": self.deadline_misses_total,
                "watchdog_trips_total": self.watchdog_trips_total,
                "dead_letter_total": self.dead_letter_total,
                "fault_injected": self.fault_injected,
                "fault_survived": self.fault_survived,
            },
            "wasted_per_completion": self.wasted_per_completion.summary(
                digits=2),
            "ttft_ms": self.ttft_s.summary(scale=1e3),
            "tpot_ms": self.tpot_s.summary(scale=1e3),
            "queue_depth": self.queue_depth.summary(digits=2),
            "slot_occupancy": self.slot_occupancy.summary(digits=3),
        }
        if self.draft_proposed:
            out["speculative"] = {
                "draft_proposed": self.draft_proposed,
                "draft_accepted": self.draft_accepted,
                "draft_rejected": self.draft_rejected,
                "acceptance_rate": round(
                    self.draft_accepted / self.draft_proposed, 4),
                "acceptance_per_completion":
                    self.draft_acceptance.summary(digits=3),
            }
        if self._paging is not None:
            out["paging"] = self._paging()
        if self.wall_s is not None:
            out["wall_s"] = round(self.wall_s, 3)
            out["decode_tokens_per_s"] = round(
                self.decode_tokens_per_s or 0.0, 1)
        return out
