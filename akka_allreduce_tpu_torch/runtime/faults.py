"""Deterministic fault injection for the serving plane of the port.

The port's own copy of ``akka_allreduce_tpu/runtime/faults.py`` (pure
stdlib), less ``ProcessFaultPoint`` / ``ProcessChaosPlan``, which drive
the replica supervisor and come with it (ROADMAP A8). The same seeded
plan fires the same faults at the same site hits in both packages
(tests/test_torch_serving_faults.py). The text below follows the
original's.

The reference's signature capability is *proceeding without the failed
part*: thresholds let a round complete when a straggler's chunks never
arrive, deathwatch shrinks the group instead of stalling it. The
training plane reproduces that story (runtime/straggler.py, elastic.py);
this module is how the SERVING plane proves its version of it — not by
hoping a production incident exercises the recovery paths, but by
scheduling the incident.

A :class:`FaultPlan` is a seeded, schedulable registry of
:class:`FaultPoint` entries. Production call sites name themselves with
``maybe_fail("engine.dispatch")``; when no plan is armed that call is a
single global read returning ``None`` (zero overhead, nothing imported
beyond stdlib, and no fault code ever runs inside a device dispatch's
kernels). When a
plan IS armed, the Nth arrival at a named site fires its scheduled
fault:

======== ==============================================================
kind     behavior at the call site
======== ==============================================================
hang     ``maybe_fail`` sleeps ``duration_s`` (a bounded stall — the
         injected version of a wedged device readback; the engine's
         watchdog is what turns it into progress)
raise    ``maybe_fail`` raises :class:`InjectedFault` (a dispatch that
         dies instead of stalling)
nan      returned to the caller, who poisons its own state (the engine
         NaN-fills the ``slot`` lane's logits — a poisoned decode the
         finite-output guard must catch)
skew     the plan's clock offset jumps by ``duration_s`` (consumed via
         :meth:`FaultPlan.wrap_clock` — scheduler-clock skew, the
         deadline plane's nightmare input)
preempt  returned to the caller (the serve loop treats it as the
         synthetic preemption signal and drains the engine)
======== ==============================================================

Sites are hit-counted per plan, so a plan is a deterministic script:
"hang the 3rd decode dispatch, poison slot 1's logits at the 5th block,
preempt at the 9th loop tick". Every firing lands in ``plan.fired`` —
the ledger tests and the ``fault_injected``/``fault_survived`` metric
pair reconcile against.

Arming is process-global and explicitly scoped (``with plan.armed():``)
because the sites are module-level functions deep in the engine; plans
do not nest, and a plan left armed is a bug the context manager makes
impossible.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Optional

_KINDS = ("hang", "raise", "nan", "skew", "preempt")


class InjectedFault(RuntimeError):
    """A scheduled ``raise``-kind fault fired at a named call site."""

    def __init__(self, site: str, point: "FaultPoint"):
        super().__init__(f"injected fault at {site!r} "
                         f"(hit {point.hit}, kind={point.kind})")
        self.site = site
        self.point = point


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One scheduled fault: fire ``kind`` at a named ``site`` on its
    ``hit``-th arrival (1-based), for ``times`` consecutive arrivals
    (``times > 1`` is the retry-exhaustion script: the same dispatch
    failing again and again until the budget dead-letters it).

    ``duration_s`` is the hang sleep / skew jump; ``slot`` targets one
    engine lane for ``nan`` (None = every lane)."""

    site: str
    kind: str
    hit: int = 1
    times: int = 1
    duration_s: float = 0.05
    slot: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(have {_KINDS})")
        if self.hit < 1 or self.times < 1:
            raise ValueError(f"hit/times must be >= 1, got "
                             f"hit={self.hit} times={self.times}")
        if self.duration_s < 0:
            raise ValueError(f"duration_s must be >= 0, "
                             f"got {self.duration_s}")


class FaultPlan:
    """A seeded script of faults plus the ledger of what actually fired.

    ``fired`` records ``(site, kind, hit)`` tuples in firing order —
    the ground truth the chaos selfcheck reconciles ``fault_injected``
    against. ``seed`` drives nothing inside the plan itself (points are
    explicit); it exists so :meth:`chaos` and test factories derive
    deterministic scripts from one integer."""

    def __init__(self, points=(), seed: int = 0, sleep=time.sleep):
        self.points = tuple(points)
        self.seed = seed
        self.fired: list[tuple] = []
        self._hits: dict = {}
        self._skew = 0.0
        self._sleep = sleep

    # -- construction ---------------------------------------------------

    @classmethod
    def chaos(cls, seed: int, slots: int = 3) -> "FaultPlan":
        """The standard four-fault script (`serve --selfcheck --chaos`):
        one hang, one dispatch exception, one NaN-poisoned lane, one
        preemption. Hit counts are seed-derived but strictly staggered
        (each fault lands a few dispatches after the previous one's
        recovery) so every fault fires while work is in flight, no two
        faults collide on one dispatch, and the
        ``fault_injected == fault_survived`` reconciliation is exact."""
        rng = random.Random(seed)
        h = rng.randint(1, 2)        # hang this decode dispatch
        r = h + rng.randint(2, 3)    # raise a later one
        n = r + rng.randint(2, 3)    # poison a lane later still
        p = n + rng.randint(4, 6)    # then preempt at a loop tick
        return cls([
            FaultPoint("engine.dispatch", "hang", hit=h,
                       duration_s=0.6),
            FaultPoint("engine.dispatch", "raise", hit=r),
            FaultPoint("engine.logits", "nan", hit=n,
                       slot=rng.randrange(slots)),
            FaultPoint("serve.loop", "preempt", hit=p),
        ], seed=seed)

    # -- firing ---------------------------------------------------------

    def on_site(self, site: str) -> Optional[FaultPoint]:
        """Count an arrival at ``site``; fire (at most) the first point
        whose hit window covers it. hang/raise/skew act here; nan and
        preempt are returned for the call site to interpret."""
        n = self._hits.get(site, 0) + 1
        self._hits[site] = n
        for pt in self.points:
            if pt.site == site and pt.hit <= n < pt.hit + pt.times:
                self.fired.append((site, pt.kind, n))
                if pt.kind == "hang":
                    self._sleep(pt.duration_s)
                elif pt.kind == "raise":
                    raise InjectedFault(site, pt)
                elif pt.kind == "skew":
                    self._skew += pt.duration_s
                return pt
        return None

    def wrap_clock(self, clock=time.monotonic):
        """A clock whose reads are fault sites: a scheduled ``skew``
        point jumps every later reading by ``duration_s`` (hand this to
        the scheduler as its injected clock)."""

        def skewed():
            self.on_site("scheduler.clock")
            return clock() + self._skew

        return skewed

    @contextlib.contextmanager
    def armed(self):
        """Arm this plan process-wide for the block. Plans do not nest."""
        global _ARMED
        if _ARMED is not None:
            raise RuntimeError("a FaultPlan is already armed")
        _ARMED = self
        try:
            yield self
        finally:
            _ARMED = None


_ARMED: Optional[FaultPlan] = None


def maybe_fail(site: str) -> Optional[FaultPoint]:
    """The production hook: a named call site offers itself to the armed
    plan. One global read and an immediate return when nothing is armed
    — the cost a permanently-instrumented hot path is allowed to pay."""
    plan = _ARMED
    if plan is None:
        return None
    return plan.on_site(site)
