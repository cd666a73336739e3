"""Admission and scheduling for the serving engine (host plane).

The port's own copy of ``akka_allreduce_tpu/serving/scheduler.py``, whole
and unchanged in behaviour: pure Python, so the same seeded sequence of
submits and pops gives the same order in both packages
(tests/test_torch_scheduler.py). The text below is the original's.

The scheduler is the serving twin of the protocol plane's master: it
owns membership (which request sits in which slot), admission (what
enters the batch next), and the threshold that decides when a round of
work may proceed. The vocabulary maps one-to-one:

* ``th_step`` is ``ThresholdConfig`` for decode: the fraction of slots
  that must be occupied before a decode step fires. 0.0 (the default,
  and the paper's point) means NEVER wait — step whatever is ready;
  1.0 reconstructs the full-batch barrier as an A/B baseline.
* ``max_queue_depth`` is backpressure, the bounded mailbox: a request
  that ARRIVES to a full live queue is shed (:class:`QueueFull` for an
  immediate submit, the ``on_reject`` callback for a future-dated one
  draining in) so overload surfaces at the edge instead of as unbounded
  latency inside. Depth is judged at arrival time, never against the
  load generator's not-yet-due script.
* slot bind/release is the master's member add/remove — strict
  accounting (double-bind and double-release raise), pinned by
  tests/test_serving_scheduler.py.

Policies: ``fifo`` (arrival order) or ``deadline`` (earliest absolute
deadline first, FIFO among equals — deadline-less requests sort last).
Everything here is pure host Python: unit-testable with a fake clock,
no device, no jax import.

The scheduler also owns the serving plane's RETRY budget
(:class:`RetryPolicy` — the serving twin of the protocol plane's
bounded rejoin/backoff): an engine-failed request (watchdog trip,
dispatch fault, NaN-poisoned decode) requeues with exponential backoff
and attempt accounting, and lands in the ``dead_letter`` list with a
terminal status once the budget is spent. Under the ``deadline``
policy, admission sheds requests whose deadline is already infeasible
(``tpot_estimate``) — the same "don't dispatch work that cannot land
in time" judgment the training plane's straggler deadlines make.

One granularity note: a "round" is whatever the engine's dispatch is.
With multi-step block decode (``EngineConfig.decode_steps = S``) the
serve loop admits only BETWEEN blocks, so a slot freed mid-block stays
empty for the block's remainder (counted as the engine's wasted
tokens, not as queue time) and an arrival waits at most one block for
admission — the latency/occupancy trade S buys its dispatch
amortization with. The scheduler itself is unchanged: ``th_step``
gates dispatches, whatever their token width.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
import random
import time
from typing import Optional

from .admission import price as _price


class QueueFull(RuntimeError):
    """Backpressure: the admission queue is at ``max_queue_depth``."""


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is the token-id sequence; ``max_new_tokens`` the decode
    budget; ``eos_token``/``stop_tokens`` end the request early (the
    EOS mirrors models/generate.py's ``eos_token``; ``stop_tokens`` is
    the host-side generalization to a set). ``arrival`` is the earliest
    time the scheduler may see the request (open-loop load generation);
    ``deadline`` is an absolute completion target the deadline policy
    sorts by. ``submitted_at`` is stamped by :meth:`RequestScheduler
    .submit`.

    ``seed`` drives a SAMPLED engine's per-request PRNG stream
    (models/generate.py ``sample_step_key``): the request's tokens are
    a pure function of (seed, sampling config, model), invariant to
    slot placement, admission order, churn and drain/restore. None
    (the default) derives the stream from ``rid`` — still
    deterministic per request, without the caller having to thread a
    seed. Greedy engines ignore it.

    ``tenant`` names the paying party for admission economics
    (serving/admission.py): budgets, shed ordering, and the
    serve_tenant_* metrics key on it. None (the default) bills the
    ``default`` tenant. An ADMISSION-plane identity: it never crosses
    the replica wire — budgets are charged router-side, before any
    engine sees the request.
    """

    rid: int
    prompt: tuple
    max_new_tokens: int
    eos_token: Optional[int] = None
    stop_tokens: tuple = ()
    arrival: float = 0.0
    deadline: Optional[float] = None
    submitted_at: Optional[float] = None
    seed: Optional[int] = None
    tenant: Optional[str] = None
    # failed-attempt count, stamped by requeue_failed — the retry
    # budget's ledger (a request enters the system with 0)
    attempts: int = 0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Budgeted retry with exponential backoff for engine-failed
    requests (watchdog trips, dispatch faults, NaN-poisoned decodes).

    ``max_attempts`` is the TOTAL attempt budget: a request whose
    ``max_attempts``-th attempt fails is dead-lettered with a terminal
    status instead of requeued. The k-th failure backs off
    ``base_delay * 2**(k-1)`` plus a uniform draw in ``[0, jitter)``
    from the scheduler's seeded RNG (deterministic per seed — the
    fault-plan tests pin exact requeue times)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    jitter: float = 0.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay < 0 or self.jitter < 0:
            raise ValueError(
                f"base_delay/jitter must be >= 0, got "
                f"{self.base_delay}/{self.jitter}")

    def delay(self, failures: int, rng: random.Random) -> float:
        d = self.base_delay * (2.0 ** (failures - 1))
        if self.jitter:
            d += rng.uniform(0.0, self.jitter)
        return d


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """``retry`` budgets engine-failed requests (see
    :class:`RetryPolicy`); ``seed`` drives its jitter.

    ``tpot_estimate`` (seconds per token, 0 = disabled) arms admission-
    time feasibility shedding under the ``deadline`` policy: a popped
    request whose deadline cannot fit even ``min_feasible_tokens`` more
    tokens (``deadline < now + min_feasible_tokens * tpot_estimate``)
    is shed with the ``rejected_infeasible`` status instead of admitted
    into work that is guaranteed to be evicted mid-flight."""

    max_queue_depth: int = 256
    policy: str = "fifo"  # "fifo" | "deadline"
    th_step: float = 0.0  # occupancy fraction gating a decode step
    retry: RetryPolicy = RetryPolicy()
    tpot_estimate: float = 0.0
    min_feasible_tokens: int = 1
    seed: int = 0
    # bound on the dead-letter TRIAGE list (a ring: the newest
    # ``dead_letter_cap`` terminal records are kept, older ones dropped
    # and counted in ``dead_letter_dropped``). A raise-storm — which
    # replica failover makes one wedged replica able to produce — must
    # not grow an unbounded list inside the scheduler; the terminal
    # RESULT records (drain_dropped) are unaffected, only the operator's
    # triage window is bounded.
    dead_letter_cap: int = 256

    def __post_init__(self):
        if self.policy not in ("fifo", "deadline"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.dead_letter_cap < 1:
            raise ValueError(
                f"dead_letter_cap must be >= 1, got {self.dead_letter_cap}")
        if not 0.0 <= self.th_step <= 1.0:
            raise ValueError(
                f"th_step must be in [0, 1], got {self.th_step}")
        if self.tpot_estimate < 0:
            raise ValueError(f"tpot_estimate must be >= 0, "
                             f"got {self.tpot_estimate}")
        if self.min_feasible_tokens < 1:
            raise ValueError(f"min_feasible_tokens must be >= 1, "
                             f"got {self.min_feasible_tokens}")


class RequestScheduler:
    """Queue + slot table. The engine is the physical slot owner; the
    scheduler mirrors occupancy so admission decisions (and tests) never
    need a device.

    Two pools: the LIVE queue (arrived, waiting — what backpressure and
    the ``queue_depth`` metric are about) and the FUTURE pool (submitted
    with a later ``arrival``, i.e. the load generator's script). Depth
    is enforced when a request ARRIVES, not when the generator hands it
    over: a future-dated submit never rejects, and an arrival that finds
    the live queue full is dropped through ``on_reject`` — exactly when
    a real open-loop server would shed it."""

    def __init__(self, cfg: SchedulerConfig, num_slots: int,
                 clock=time.monotonic, sleep=time.sleep, on_reject=None,
                 admission=None, admit_gate=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.cfg = cfg
        self.num_slots = num_slots
        self.clock = clock
        self._sleep = sleep
        self.on_reject = on_reject
        # admission economics (serving/admission.py
        # AdmissionController): when armed, pop_ready prices each
        # FRESH request against its tenant's token budget
        # (shed_budget) and the overload controller sweeps the live
        # queue for policy victims (shed_overload) — both are terminal
        # records through the same drain_dropped path dead letters
        # use, so the one-terminal-per-request ledger identity holds
        # with economics on. Retries (attempts > 0) are exempt: they
        # paid at first admission.
        self.admission = admission
        # edge backpressure beyond the engine's memory gate: a
        # callable consulted before any admission (the stress plane's
        # slow-client PickupBuffer.admit_ok — a client that stops
        # reading its completions must stall ADMISSION, not grow an
        # unbounded result buffer). Same push-back semantics as
        # pop_ready's can_admit; polls blocked here count in
        # blocked_on_client.
        self.admit_gate = admit_gate
        self._seq = itertools.count()
        self._arrived: list[tuple] = []  # heap of (sort_key, seq, req)
        # running token price of the live queue (admission economics'
        # backlog quantity), maintained at every _arrived mutation so
        # the per-poll overload check is O(1), not O(queue)
        self._arrived_price = 0
        self._future: list[tuple] = []   # heap of (arrival, seq, req)
        self._slots: dict[int, Request] = {}
        # decode quorum: ceil(th * slots), floored at 1 so th > 0 never
        # demands zero occupancy (same ceil convention as the protocol
        # thresholds: required count = ceil(fraction * total))
        self.step_quorum = max(1, math.ceil(cfg.th_step * num_slots))
        self.rejected = 0
        # admission polls where the head request waited on engine
        # MEMORY (the paged engine's free-page gate) with its slot
        # otherwise available — sustained growth means the page pool,
        # not the lane count, is the bottleneck (OPERATIONS.md)
        self.blocked_on_memory = 0
        # admission polls where the head request waited on the CLIENT
        # side (admit_gate False — e.g. a full slow-client pickup
        # buffer): the reader-side backpressure signal next to
        # blocked_on_memory's engine-side one
        self.blocked_on_client = 0
        # -- failure plumbing (serving fault tolerance) -----------------
        self._rng = random.Random(cfg.seed)  # retry jitter
        self.retries = 0            # successful requeues
        self.shed_infeasible = 0    # deadline-infeasible admission sheds
        # terminal record of budget-exhausted requests: (req, the
        # failure reason of the LAST attempt) — the operator's triage
        # list (OPERATIONS.md "Dead-letter triage"). A bounded RING:
        # the newest ``cfg.dead_letter_cap`` records are kept; a
        # raise-storm rolls older ones off into ``dead_letter_dropped``
        # instead of growing without bound
        self.dead_letter: collections.deque = collections.deque(
            maxlen=cfg.dead_letter_cap)
        self.dead_letter_dropped = 0
        # terminal drops not yet reported to the serve loop; drained
        # (and turned into results/metrics) once per loop iteration
        self._dropped: list[tuple] = []

    # -- admission -----------------------------------------------------

    def _sort_key(self, req: Request) -> float:
        if self.cfg.policy == "deadline":
            return req.deadline if req.deadline is not None \
                else float("inf")
        return req.arrival

    def _reject(self, req: Request) -> None:
        self.rejected += 1
        if self.on_reject is not None:
            self.on_reject(req.rid)

    def _push_arrived(self, req: Request) -> None:
        heapq.heappush(self._arrived,
                       (self._sort_key(req), next(self._seq), req))
        self._arrived_price += _price(req)

    def submit(self, req: Request) -> None:
        """Enqueue. An already-arrived request that finds the live queue
        at ``max_queue_depth`` raises :class:`QueueFull` (backpressure —
        the caller sheds load at the edge); a future-dated request parks
        in the arrival pool and faces the depth check when it arrives."""
        if req.submitted_at is None:
            req.submitted_at = self.clock()
        if req.arrival > self.clock():
            heapq.heappush(self._future,
                           (req.arrival, next(self._seq), req))
            return
        if len(self._arrived) >= self.cfg.max_queue_depth:
            self._reject(req)
            raise QueueFull(
                f"queue at max_queue_depth={self.cfg.max_queue_depth}")
        self._push_arrived(req)

    def _drain_arrivals(self, now: float) -> None:
        """Move every request whose arrival has passed into the live
        queue, shedding (via ``on_reject``) any FRESH request that
        finds it full. A retried request (``attempts > 0``) is exempt:
        it already paid for (and held) its admission, and shedding it
        here would lose it with no terminal status — backpressure is
        an edge policy, and a retry is not at the edge."""
        while self._future and self._future[0][0] <= now:
            _, _, req = heapq.heappop(self._future)
            if req.attempts == 0 \
                    and len(self._arrived) >= self.cfg.max_queue_depth:
                self._reject(req)
            else:
                self._push_arrived(req)

    def _infeasible(self, req: Request, now: float) -> bool:
        """Deadline already unmeetable at admission time: even the
        minimum useful decode would outlive it. Admitting such a
        request only manufactures a guaranteed mid-flight eviction —
        shed it at the edge instead (the same judgment the protocol
        plane's deadline pacer makes about a straggler's chunks: work
        that cannot land in time is work not worth dispatching)."""
        return (self.cfg.policy == "deadline"
                and self.cfg.tpot_estimate > 0
                and req.deadline is not None
                and req.deadline < now + (self.cfg.min_feasible_tokens
                                          * self.cfg.tpot_estimate))

    def pop_ready(self, now: Optional[float] = None,
                  can_admit=None) -> Optional[Request]:
        """Best live request as of ``now`` (None = nothing has arrived).
        Under the deadline policy an urgent late arrival outranks a
        patient early one; among equals, submit order decides —
        and already-infeasible requests are shed (``rejected_
        infeasible``), never admitted.

        ``can_admit`` is the engine's MEMORY gate (paged serving: free
        pages instead of free slots): when the best request fails it,
        the request goes back at its position and None returns —
        admission waits for memory in policy order rather than
        reordering around it (counted in ``blocked_on_memory``, the
        page-pressure signal next to ``queue_depth``)."""
        if now is None:
            now = self.clock()
        self._drain_arrivals(now)
        self._overload_sweep(now)
        if self.admit_gate is not None and self._arrived \
                and not self.admit_gate():
            # the edge itself is blocked (slow-client pickup buffer
            # full): nothing admits until a reader catches up — the
            # queue holds position, the caller keeps stepping
            self.blocked_on_client += 1
            return None
        while self._arrived:
            entry = heapq.heappop(self._arrived)
            req = entry[2]
            self._arrived_price -= _price(req)
            if self._infeasible(req, now):
                self.shed_infeasible += 1
                self._dropped.append((req, "rejected_infeasible"))
                continue
            if can_admit is not None and not can_admit(req):
                heapq.heappush(self._arrived, entry)
                self._arrived_price += _price(req)
                self.blocked_on_memory += 1
                return None
            if self.admission is not None and req.attempts == 0:
                # the queue snapshot feeds only the EDF feasibility
                # ranking — skip the O(queue) copy when EDF is off
                queued = ([e[2] for e in self._arrived]
                          if self.admission.cfg.edf_admission else ())
                reason = self.admission.charge(req, now, queued=queued)
                if reason is not None:
                    # a priced shed: terminal, never a retry — the
                    # request's budget/feasibility verdict, not a
                    # transient engine condition
                    self._dropped.append((req, reason))
                    continue
            return req
        return None

    def _overload_sweep(self, now: float) -> None:
        """Let the armed overload controller shed live-queue victims
        by POLICY (serving/admission.py: cheapest-feasible-first
        within a tenant, over-budget tenants first across tenants)
        until the estimated backlog fits its bound. Victims become
        ``shed_overload`` terminal records; retried requests are never
        victims (they paid their admission)."""
        if self.admission is None or not self.admission.check_overloaded(
                self._arrived_price, self.num_slots):
            return
        victims = self.admission.overload_victims(
            [e[2] for e in self._arrived], now, self.num_slots,
            backlog=self._arrived_price)
        if not victims:
            return
        vset = {req.rid for req in victims}
        self._arrived = [e for e in self._arrived
                         if e[2].rid not in vset]
        heapq.heapify(self._arrived)
        for req in victims:
            self._arrived_price -= _price(req)
            self._dropped.append((req, "shed_overload"))

    # -- failure handling ----------------------------------------------

    def requeue_failed(self, req: Request, reason: str = "fault") -> bool:
        """Route an engine-failed request through the retry budget:
        within ``retry.max_attempts``, requeue it with exponential
        backoff (it re-enters through the future pool, so the deadline/
        FIFO policy re-sorts it on arrival); past the budget, dead-
        letter it with a terminal status. Returns True iff requeued.
        Retries bypass the queue-depth check — the request already held
        (and paid for) its admission."""
        req.attempts += 1
        pol = self.cfg.retry
        if req.attempts >= pol.max_attempts:
            if len(self.dead_letter) == self.cfg.dead_letter_cap:
                # ring full: the OLDEST triage record rolls off (the
                # deque's maxlen drops it on append) — counted, so the
                # operator knows the window is a window
                self.dead_letter_dropped += 1
            self.dead_letter.append((req, reason))
            self._dropped.append((req, "dead_letter"))
            return False
        self.retries += 1
        req.arrival = self.clock() + pol.delay(req.attempts, self._rng)
        heapq.heappush(self._future, (req.arrival, next(self._seq), req))
        return True

    def drain_dropped(self) -> "list[tuple]":
        """Hand back (and clear) the terminal drops accumulated since
        the last call: ``(request, status)`` with status
        ``dead_letter`` or ``rejected_infeasible``. The serve loop
        folds these into its results so every request ends with
        exactly one terminal record."""
        out, self._dropped = self._dropped, []
        return out

    def next_arrival_time(self) -> Optional[float]:
        """Earliest pending arrival (open-loop idle wait target); the
        current time when live work is already queued, None when nothing
        is pending anywhere."""
        if self._arrived:
            return self.clock()
        if not self._future:
            return None
        return self._future[0][0]

    def wait_until(self, t: float) -> None:
        """Sleep the (injectable) clock forward to ``t``."""
        dt = t - self.clock()
        if dt > 0:
            self._sleep(dt)

    # -- slot accounting ----------------------------------------------

    def bind(self, req: Request, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        if slot in self._slots:
            raise RuntimeError(
                f"slot {slot} already bound to request "
                f"{self._slots[slot].rid}")
        if any(r.rid == req.rid for r in self._slots.values()):
            raise RuntimeError(f"request {req.rid} already bound")
        self._slots[slot] = req

    def release(self, slot: int) -> Request:
        if slot not in self._slots:
            raise RuntimeError(f"slot {slot} is not bound")
        return self._slots.pop(slot)

    # -- progress gate -------------------------------------------------

    def should_step(self, occupied: int) -> bool:
        """Threshold-gated progress: step once ``occupied`` meets the
        quorum. The serve loop still steps a sub-quorum batch when no
        more work can arrive — the liveness rule; the threshold only
        ever waits for work that is actually coming."""
        return occupied >= self.step_quorum

    # -- introspection -------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """LIVE queue only (arrived, waiting) — the backpressure and
        metrics quantity; future-dated load-generator submissions are
        not queue occupancy."""
        return len(self._arrived)

    @property
    def backlog_tokens(self) -> int:
        """The live queue's running token price (prompt + budgeted
        decode) — the quantity the admission controller's knee bound
        is stated in, maintained incrementally so overload checks and
        the autoscaler read it in O(1)."""
        return self._arrived_price

    @property
    def unfinished(self) -> int:
        return len(self._arrived) + len(self._future) + len(self._slots)

    @property
    def occupied(self) -> int:
        return len(self._slots)

    def bound_request(self, slot: int) -> Optional[Request]:
        return self._slots.get(slot)
