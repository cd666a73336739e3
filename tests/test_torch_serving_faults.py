"""The port's serving fault tolerance, every failure path driven by a
scheduled fault: the JAX package's ``tests/test_serving_faults.py`` case
list on the port's engines, the paged engine's fault cases of
``tests/test_paged_engine.py`` (gather and kernel paths; the kernel path
takes its plain version on CPU tensors), the speculative engines under
the watchdog, the drain and the restore, and the same fault scripts
through the JAX engine and the port's.

A hung dispatch trips the watchdog and fails only the in-flight requests
(the state rebuilt); a raising dispatch takes the same path; a
NaN-poisoned lane fails its own request; a preemption drains to
snapshots a fresh engine restores. Each submitted request ends once, and
every request that completes does so with the fault-free run's tokens:
bitwise here (f32 on the CPU, where the restore's prefill reproduces the
decode's bits at these shapes; on the card ``chip_smoke.py`` phase 24
holds restored streams under ``parity.greedy_agree``). Against JAX,
tokens are held by ``greedy_agree`` (top-2 gap > 1e-3), the fault ledger
exactly.

Timing under a busy test run: every injected hang holds its dispatch
until the test releases it (``cli.held_hang_plan``), far past the
watchdog, and the watchdog (``WATCHDOG_S``) is two orders of magnitude
over a healthy dispatch of this tiny model, so trips are counted
exactly. The module runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import contextlib
import dataclasses
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import akka_allreduce_tpu.serving as jserve
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.runtime import faults as jfaults
from akka_allreduce_tpu_torch import cli, convert
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.parity import greedy_agree
from akka_allreduce_tpu_torch.runtime.faults import (
    FaultPlan,
    FaultPoint,
    InjectedFault,
    maybe_fail,
)
from akka_allreduce_tpu_torch.runtime.tracing import Tracer
from akka_allreduce_tpu_torch.serving import (
    EngineConfig,
    PagedEngineConfig,
    PagedServingEngine,
    PagedSpeculativeEngine,
    Request,
    RequestScheduler,
    ResumableRequest,
    RetryPolicy,
    SchedulerConfig,
    ServingEngine,
    ServingMetrics,
    SpeculativeEngine,
    serve_loop,
)

MODEL = dict(vocab_size=67, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=48)
CFG = ttf.TransformerConfig(**MODEL)
SLOTS = 3
WATCHDOG_S = 0.5
JAX_WATCHDOG_S = 2.0  # a JAX dispatch that met a new shape compiles


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def params(weights):
    return weights[2]


@pytest.fixture
def held():
    """Make fault plans whose hangs hold until the test ends."""
    plans = []

    def make(points, seed=0, mod=None):
        if mod is None:
            plan = cli.held_hang_plan(points, seed=seed)
        else:  # the JAX package's plan, held the same way
            release = threading.Event()
            plan = mod.FaultPlan(points, seed=seed,
                                 sleep=lambda _s: release.wait(60))
            plan.release = release
        plans.append(plan)
        return plan

    yield make
    for plan in plans:
        plan.release.set()


def make_requests(n=6, budget=6, seed=3, eos_every=2, deadline=None,
                  mod=None):
    """Fresh Request objects every call (requests are mutated in
    flight)."""
    rng = np.random.default_rng(seed)
    req = mod.Request if mod is not None else Request
    return [req(
        rid=rid,
        prompt=tuple(int(x) for x in rng.integers(
            0, MODEL["vocab_size"], size=(3, 5)[rid % 2])),
        max_new_tokens=budget,
        eos_token=3 if eos_every and rid % eos_every == 0 else None,
        deadline=deadline,
        submitted_at=0.0) for rid in range(n)]


def build(params, s=1, watchdog=WATCHDOG_S, max_attempts=3,
          base_delay=0.0, policy="fifo", clock=None, sleep=None,
          metrics=None, **scfg_kw):
    ecfg = EngineConfig(num_slots=SLOTS, decode_steps=s,
                        watchdog_timeout_s=watchdog)
    engine = ServingEngine(
        params, CFG, ecfg, metrics=metrics,
        **({"clock": clock} if clock is not None else {}))
    kw = {}
    if clock is not None:
        kw["clock"] = clock
    if sleep is not None:
        kw["sleep"] = sleep
    sched = RequestScheduler(
        SchedulerConfig(policy=policy,
                        retry=RetryPolicy(max_attempts=max_attempts,
                                          base_delay=base_delay),
                        **scfg_kw),
        num_slots=SLOTS, **kw)
    return engine, sched


def run_to_completion(params, engine, sched, reqs, metrics=None,
                      plan=None):
    """serve_loop plus the preemption handoff: a drain's snapshots are
    restored into a fresh engine (same config) until the queue is
    done."""
    for r in reqs:
        sched.submit(r)
    first = [engine]

    def make():
        if first:
            return first.pop()
        return ServingEngine(params, CFG, engine.ecfg, metrics=metrics)
    results, engines, _ = cli.serve_until_done(
        make, sched, metrics=metrics, plan=plan, max_dispatches=2000)
    return results, engines[-1]


@pytest.fixture(scope="module")
def baselines(params):
    """Fault-free truth per decode_steps."""
    out = {}
    for s in (1, 4):
        engine, sched = build(params, s=s, watchdog=None)
        out[s], _ = run_to_completion(params, engine, sched,
                                      make_requests())
    return out


def point_for(kind, s):
    if kind == "hang":
        return FaultPoint("engine.dispatch", "hang", hit=2)
    if kind == "raise":
        return FaultPoint("engine.dispatch", "raise", hit=2)
    if kind == "nan":
        return FaultPoint("engine.logits", "nan", hit=2, slot=1)
    # preempt while work is in flight: at S=1 the fourth loop tick has
    # every first-wave lane mid-decode; at S=4 the second lands between
    # blocks with 4 of 6 budgeted tokens emitted
    return FaultPoint("serve.loop", "preempt", hit=4 if s == 1 else 2)


def assert_baseline(results, want):
    assert set(results) == set(want)
    for rid, (toks, reason) in want.items():
        assert list(results[rid][0]) == list(toks), f"rid={rid}"
        assert results[rid][1] == reason, f"rid={rid}"


class TestFaultPlanUnit:
    """The harness itself: deterministic, scoped, ledgered."""

    def test_unarmed_is_noop(self):
        assert maybe_fail("engine.dispatch") is None

    def test_hit_window_and_times(self):
        naps = []
        plan = FaultPlan([FaultPoint("site", "hang", hit=2, times=2,
                                     duration_s=0.5)],
                         sleep=naps.append)
        with plan.armed():
            assert maybe_fail("site") is None          # hit 1
            assert maybe_fail("site").kind == "hang"   # hit 2 fires
            assert maybe_fail("site").kind == "hang"   # hit 3 fires
            assert maybe_fail("site") is None          # window closed
        assert naps == [0.5, 0.5]
        assert plan.fired == [("site", "hang", 2), ("site", "hang", 3)]

    def test_raise_kind_raises(self):
        plan = FaultPlan([FaultPoint("s", "raise")])
        with plan.armed():
            with pytest.raises(InjectedFault, match="'s'"):
                maybe_fail("s")
        assert plan.fired == [("s", "raise", 1)]

    def test_plans_do_not_nest_and_disarm(self):
        plan = FaultPlan([FaultPoint("s", "preempt")])
        with plan.armed():
            with pytest.raises(RuntimeError, match="already armed"):
                with FaultPlan([]).armed():
                    pass
        assert maybe_fail("s") is None  # disarmed on exit

    def test_wrap_clock_skew(self):
        plan = FaultPlan([FaultPoint("scheduler.clock", "skew", hit=3,
                                     duration_s=100.0)])
        t = [0.0]
        clock = plan.wrap_clock(lambda: t[0])
        with plan.armed():
            assert clock() == 0.0
            assert clock() == 0.0
            assert clock() == 100.0  # third read fires the jump
            assert clock() == 100.0  # and it sticks
        assert ("scheduler.clock", "skew", 3) in plan.fired

    def test_validation(self):
        with pytest.raises(ValueError, match="kind"):
            FaultPoint("s", "explode")
        with pytest.raises(ValueError, match="hit"):
            FaultPoint("s", "hang", hit=0)

    @pytest.mark.parametrize("seed", range(8))
    def test_chaos_script_is_jax_s(self, seed):
        """``FaultPlan.chaos`` draws the JAX package's points."""
        got = FaultPlan.chaos(seed, slots=5).points
        want = jfaults.FaultPlan.chaos(seed, slots=5).points
        assert [dataclasses.astuple(p) for p in got] \
            == [dataclasses.astuple(p) for p in want]


class TestFaultMatrix:
    """(hang, raise, nan, preempt) x (fifo, deadline) x decode_steps
    {1, 4}: every request's tokens and reason the fault-free run's, the
    failure ledger exact."""

    @pytest.mark.parametrize("kind", ["hang", "raise", "nan", "preempt"])
    @pytest.mark.parametrize("policy", ["fifo", "deadline"])
    @pytest.mark.parametrize("s", [1, 4])
    def test_matrix(self, params, baselines, held, kind, policy, s):
        plan = held([point_for(kind, s)])
        metrics = ServingMetrics()
        engine, sched = build(params, s=s, policy=policy,
                              metrics=metrics)
        results, engine = run_to_completion(params, engine, sched,
                                            make_requests(),
                                            metrics=metrics, plan=plan)
        assert len(plan.fired) == 1, plan.fired
        assert_baseline(results, baselines[s])
        assert metrics.fault_survived == 1
        assert metrics.dead_letter_total == 0
        if kind == "hang":
            assert metrics.watchdog_trips_total == 1
            assert metrics.retries_total == SLOTS  # all in-flight
            assert metrics.requests_failed == SLOTS
        elif kind == "raise":
            assert metrics.watchdog_trips_total == 0
            assert metrics.retries_total == SLOTS
        elif kind == "nan":
            assert metrics.retries_total == 1  # the poisoned lane only
            assert metrics.requests_failed == 1
        else:  # preempt
            assert metrics.retries_total == 0
            assert metrics.requests_failed == 0


class TestWatchdogRecovery:
    def test_recovery_meets_no_new_prefill_shape(self, params, baselines,
                                                 held):
        """The port's counterpart of the JAX package's zero-recompile
        pin: the faulted run (trip, rebuild, retries, churn) prefills
        only lengths the fault-free run did, and the rebuilt state has
        the shapes and dtypes of the state as built."""
        plan = held([point_for("hang", 1)])
        warm, sched = build(params, s=1, watchdog=None)
        run_to_completion(params, warm, sched, make_requests())
        engine, sched = build(params, s=1)
        built = {n: (t.shape, t.dtype) for n, t in engine._state.items()}
        results, engine = run_to_completion(params, engine, sched,
                                            make_requests(), plan=plan)
        assert engine.watchdog_trips == 1
        assert engine.prefill_shapes <= warm.prefill_shapes
        assert {n: (t.shape, t.dtype)
                for n, t in engine._state.items()} == built
        assert_baseline(results, baselines[1])

    def test_discarded_partials_charged_to_waste(self, params, baselines,
                                                 held):
        plan = held([point_for("hang", 1)])  # trip at dispatch 2
        metrics = ServingMetrics()
        engine, sched = build(params, s=1, metrics=metrics)
        results, engine = run_to_completion(params, engine, sched,
                                            make_requests(),
                                            metrics=metrics, plan=plan)
        # 3 lanes had emitted exactly 1 token each when dispatch 2 hung
        assert engine.discarded_tokens == SLOTS
        assert metrics.wasted_tokens == SLOTS
        assert metrics.decode_tokens == sum(
            len(t) for t, _ in results.values())

    def test_dead_letter_after_budget(self, params):
        """A dispatch that fails every time pushes each request through
        max_attempts failures into the dead-letter list, and the run
        still ends."""
        plan = FaultPlan([FaultPoint("engine.dispatch", "raise",
                                     hit=2, times=10_000)])
        metrics = ServingMetrics()
        engine, sched = build(params, s=1, max_attempts=2,
                              metrics=metrics)
        results, engine = run_to_completion(params, engine, sched,
                                            make_requests(),
                                            metrics=metrics, plan=plan)
        assert all(r == ([], "dead_letter") for r in results.values())
        assert metrics.dead_letter_total == 6
        assert len(sched.dead_letter) == 6
        assert all(req.attempts == 2 for req, _ in sched.dead_letter)
        assert metrics.retries_total + metrics.dead_letter_total \
            == metrics.requests_failed == 12

    @pytest.mark.parametrize("paged", [False, True])
    def test_late_dispatch_writes_only_what_it_was_given(
            self, params, baselines, held, paged):
        """The hung dispatch wakes while the rebuilt engine serves (its
        hold is released at the first retry) and runs to its readback on
        the tensors it was handed: the live engine's tokens stay
        bitwise."""
        plan = held([point_for("hang", 1)])

        class Release(ServingMetrics):
            def on_retry(self, rid):
                plan.release.set()
                super().on_retry(rid)

        metrics = Release()
        if paged:
            engine = PagedServingEngine(params, CFG, PagedEngineConfig(
                num_slots=SLOTS, page_size=4,
                watchdog_timeout_s=WATCHDOG_S))
        else:
            engine, _ = build(params, s=1)
        sched = RequestScheduler(SchedulerConfig(
            retry=RetryPolicy(max_attempts=3, base_delay=0.0)),
            num_slots=SLOTS)
        for r in make_requests():
            sched.submit(r)
        with plan.armed():
            results = serve_loop(engine, sched, metrics=metrics,
                                 max_dispatches=2000)
        assert engine.watchdog_trips == 1 and len(engine.abandoned) == 1
        state, packed = engine.abandoned[0].result(timeout=30)
        assert state is not engine._state
        assert all(state[n].data_ptr() != engine._state[n].data_ptr()
                   for n in ("k", "v"))
        assert_baseline(results, baselines[1])
        if paged:
            engine.pool.check_invariants()
            assert engine.pool.pages_in_use == 0
        engine.close()

    def test_guard_thread_runs_without_grad(self, held):
        """Grad mode is per thread: the guard thread enters no_grad, so
        parameters that require grad still dispatch and read back."""
        p = ttf.init_transformer(torch.Generator().manual_seed(0), CFG)
        for t in (p["embed"], p["layers"][0]["wq"]):
            t.requires_grad_(True)
        engine = ServingEngine(p, CFG, EngineConfig(
            num_slots=SLOTS, watchdog_timeout_s=WATCHDOG_S))
        sched = RequestScheduler(SchedulerConfig(), num_slots=SLOTS)
        for r in make_requests(n=3):
            sched.submit(r)
        results = serve_loop(engine, sched, max_dispatches=100)
        assert len(results) == 3 and engine.watchdog_trips == 0
        with engine:
            pass
        assert engine._executor is None
        engine.close()  # idempotent

    def test_watchdog_config_is_checked(self):
        with pytest.raises(ValueError, match="watchdog_timeout_s"):
            EngineConfig(watchdog_timeout_s=0)
        with pytest.raises(ValueError, match="watchdog_timeout_s"):
            PagedEngineConfig(watchdog_timeout_s=-1.0)


class TestNaNGuard:
    def test_poison_all_lanes_fails_all_retries_all(self, params,
                                                    baselines):
        plan = FaultPlan([FaultPoint("engine.logits", "nan", hit=2,
                                     slot=None)])
        metrics = ServingMetrics()
        engine, sched = build(params, s=1, metrics=metrics)
        results, _ = run_to_completion(params, engine, sched,
                                       make_requests(),
                                       metrics=metrics, plan=plan)
        assert metrics.requests_failed == SLOTS
        assert metrics.fault_survived == SLOTS  # one per poisoned lane
        assert_baseline(results, baselines[1])


class _TickClock:
    """A clock that advances a fixed dt per read."""

    def __init__(self, dt=0.05):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def sleep(self, dt):
        self.t += dt


class TestDeadlineEnforcement:
    def test_expired_request_evicted_mid_flight(self, params):
        clock = _TickClock(dt=0.05)
        metrics = ServingMetrics(clock=clock)
        engine, sched = build(params, s=1, watchdog=None,
                              policy="deadline", clock=clock,
                              sleep=clock.sleep, metrics=metrics)
        reqs = make_requests(n=4, budget=30, eos_every=0)
        reqs[0] = dataclasses.replace(reqs[0], deadline=1.0)
        for r in reqs[1:]:
            r.deadline = 1e9
        results, engine = run_to_completion(params, engine, sched, reqs,
                                            metrics=metrics)
        assert results[0] == ([], "evicted")
        assert engine.evictions == 1
        assert metrics.evictions_total == 1
        assert metrics.deadline_misses_total == 1
        assert metrics.wasted_tokens > 0
        for rid in (1, 2, 3):
            toks, reason = results[rid]
            assert reason == "max_tokens" and len(toks) == 30

    def test_infeasible_deadline_shed_at_admission(self, params):
        clock = _TickClock(dt=0.05)
        metrics = ServingMetrics(clock=clock)
        engine, sched = build(params, s=1, watchdog=None,
                              policy="deadline", clock=clock,
                              sleep=clock.sleep, metrics=metrics,
                              tpot_estimate=0.1, min_feasible_tokens=5)
        reqs = make_requests(n=3, budget=6, eos_every=0)
        reqs[0].deadline = 0.2   # < now + 5 * 0.1: unmeetable
        reqs[1].deadline = 1e9
        reqs[2].deadline = 1e9
        results, _ = run_to_completion(params, engine, sched, reqs,
                                       metrics=metrics)
        assert results[0] == ([], "rejected_infeasible")
        assert sched.shed_infeasible == 1
        assert metrics.deadline_misses_total == 1
        assert metrics.evictions_total == 0
        assert len(results[1][0]) == 6 and len(results[2][0]) == 6

    def test_scheduler_infeasible_unit(self):
        t = [100.0]
        sched = RequestScheduler(
            SchedulerConfig(policy="deadline", tpot_estimate=0.1,
                            min_feasible_tokens=5),
            num_slots=2, clock=lambda: t[0])
        bad = Request(rid=0, prompt=(1,), max_new_tokens=8,
                      deadline=100.3)
        ok = Request(rid=1, prompt=(1,), max_new_tokens=8,
                     deadline=101.0)
        sched.submit(bad)
        sched.submit(ok)
        got = sched.pop_ready(100.0)
        assert got is not None and got.rid == 1
        assert sched.drain_dropped() == [(bad, "rejected_infeasible")]
        assert sched.drain_dropped() == []


class TestRetryBackoffExact:
    def test_exponential_backoff_and_dead_letter(self):
        t = [1000.0]
        sched = RequestScheduler(
            SchedulerConfig(retry=RetryPolicy(max_attempts=3,
                                              base_delay=0.2)),
            num_slots=1, clock=lambda: t[0])
        req = Request(rid=7, prompt=(1,), max_new_tokens=4)
        assert sched.requeue_failed(req, "watchdog") is True
        assert req.attempts == 1
        assert req.arrival == pytest.approx(1000.0 + 0.2)
        assert sched.requeue_failed(req, "fault") is True
        assert req.attempts == 2
        assert req.arrival == pytest.approx(1000.0 + 0.4)
        assert sched.requeue_failed(req, "nan") is False
        assert req.attempts == 3
        assert sched.retries == 2
        assert list(sched.dead_letter) == [(req, "nan")]
        assert sched.drain_dropped() == [(req, "dead_letter")]

    def test_retry_survives_full_queue(self):
        t = [0.0]
        rejected = []
        sched = RequestScheduler(
            SchedulerConfig(max_queue_depth=2,
                            retry=RetryPolicy(max_attempts=3,
                                              base_delay=0.0)),
            num_slots=1, clock=lambda: t[0],
            on_reject=rejected.append)
        for rid in range(2):
            sched.submit(Request(rid=rid, prompt=(1,),
                                 max_new_tokens=2))
        failed = Request(rid=9, prompt=(1,), max_new_tokens=2)
        assert sched.requeue_failed(failed, "watchdog") is True
        got = sched.pop_ready(0.0)
        assert rejected == []
        popped = {got.rid, sched.pop_ready(0.0).rid,
                  sched.pop_ready(0.0).rid}
        assert popped == {0, 1, 9}
        assert sched.drain_dropped() == []

    def test_jitter_is_seeded_and_bounded(self):
        def mk():
            return RequestScheduler(
                SchedulerConfig(retry=RetryPolicy(max_attempts=9,
                                                  base_delay=0.1,
                                                  jitter=0.05),
                                seed=5),
                num_slots=1, clock=lambda: 0.0)

        def delays(s):
            out = []
            for k in range(4):
                r = Request(rid=k, prompt=(1,), max_new_tokens=2)
                s.requeue_failed(r)
                out.append(r.arrival)
            return out

        a, b = delays(mk()), delays(mk())
        assert a == b
        for k, d in enumerate(a):
            assert 0.1 <= d < 0.1 + 0.05, (k, d)


class TestDrainRestore:
    def test_restore_validation(self, params):
        engine = ServingEngine(params, CFG, EngineConfig(num_slots=1))
        req = Request(rid=0, prompt=(1, 2), max_new_tokens=3,
                      submitted_at=0.0)
        rr = ResumableRequest(req=req, generated=(4, 5, 6), slot=0)
        with pytest.raises(ValueError, match="restore"):
            engine.restore(rr)

    def test_drain_snapshots_and_restore_parity(self, params, baselines):
        plan = FaultPlan([point_for("preempt", 1)])
        engine, sched = build(params, s=1)
        for r in make_requests():
            sched.submit(r)
        with plan.armed():
            early = serve_loop(engine, sched, max_dispatches=2000)
        assert engine.draining
        assert len(engine.drained) == SLOTS  # first wave mid-decode
        assert all(len(rr.generated) >= 1 for rr in engine.drained)
        fresh = ServingEngine(params, CFG, engine.ecfg)
        for rr in engine.drained:
            sched.bind(rr.req, fresh.restore(rr))
        results = dict(early)
        results.update(serve_loop(fresh, sched, max_dispatches=2000))
        assert_baseline(results, baselines[1])

    @pytest.mark.parametrize("s", [1, 4])
    def test_sampled_restore_resumes_the_key_schedule(self, params, s):
        """A restored sampled lane resumes at its emitted-token index with
        its request's own key: its stream is the uninterrupted one."""
        ecfg = EngineConfig(num_slots=SLOTS, decode_steps=s,
                            temperature=0.9, top_k=20)

        def sched_of():
            sched = RequestScheduler(SchedulerConfig(), num_slots=SLOTS)
            for r in make_requests(eos_every=0):
                sched.submit(r)
            return sched

        want, _, _ = cli.serve_until_done(
            lambda: ServingEngine(params, CFG, ecfg), sched_of())
        plan = FaultPlan([point_for("preempt", s)])
        got, engines, restored = cli.serve_until_done(
            lambda: ServingEngine(params, CFG, ecfg), sched_of(),
            plan=plan)
        assert restored and len(engines) == 2
        assert_baseline(got, want)


class TestPagedRecoveryAndDrain:
    """The JAX package's paged fault cases (``test_paged_engine.py``),
    on the gather path and on the kernel path (plain version here)."""

    DENSE = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2,
                 d_ff=64, max_seq=32, n_kv_heads=2, rope=True)

    @pytest.fixture(scope="class")
    def dense(self):
        cfg = ttf.TransformerConfig(**self.DENSE)
        return cfg, ttf.init_transformer(
            torch.Generator().manual_seed(0), cfg)

    def reqs(self, n, steps, seed):
        rng = np.random.default_rng(seed)
        return [Request(rid=rid, prompt=tuple(int(x) for x in rng.integers(
            0, 97, size=int(rng.integers(2, 9)))), max_new_tokens=steps,
            submitted_at=0.0) for rid in range(n)]

    def truth(self, dense, reqs):
        cfg, params = dense
        engine = ServingEngine(params, cfg, EngineConfig(num_slots=2))
        sched = RequestScheduler(SchedulerConfig(), num_slots=2)
        for r in reqs:
            sched.submit(r)
        return serve_loop(engine, sched, max_dispatches=2000)

    @pytest.mark.parametrize("impl", ["gather", "kernel"])
    def test_drain_restore_parity(self, dense, impl):
        cfg, params = dense
        pcfg = PagedEngineConfig(num_slots=2, page_size=4,
                                 attention_impl=impl)
        engine = PagedServingEngine(params, cfg, pcfg)
        sched = RequestScheduler(SchedulerConfig(), num_slots=2)
        for r in self.reqs(4, 8, 41):
            sched.submit(r)
        plan = FaultPlan([FaultPoint("serve.loop", "preempt", hit=4)])
        with plan.armed():
            results = serve_loop(engine, sched, max_dispatches=2000)
        assert plan.fired and engine.drained
        assert engine.pool.pages_in_use == 0  # drain freed the pages
        fresh = PagedServingEngine(params, cfg, pcfg)
        for rr in engine.drained:
            sched.bind(rr.req, fresh.restore(rr))
        results.update(serve_loop(fresh, sched, max_dispatches=2000))
        assert_baseline(results, self.truth(dense, self.reqs(4, 8, 41)))

    def test_memory_blocked_resume_holds_priority(self, dense):
        """A drained request waiting for pages keeps its place: queued
        small requests do not take the pages decode frees."""
        cfg, params = dense
        rng = np.random.default_rng(47)
        bigs = [Request(rid=900 + i,
                        prompt=tuple(int(x) for x in rng.integers(
                            0, 97, size=8)),
                        max_new_tokens=16, submitted_at=0.0)
                for i in range(2)]
        pcfg = PagedEngineConfig(num_slots=2, page_size=4, num_pages=8)
        drained = []
        for r in bigs:
            eng = PagedServingEngine(params, cfg, pcfg)
            sch = RequestScheduler(SchedulerConfig(), num_slots=2)
            sch.submit(r)
            plan = FaultPlan([FaultPoint("serve.loop", "preempt",
                                         hit=4)])
            with plan.armed():
                serve_loop(eng, sch, max_dispatches=2000)
            drained.extend(eng.drained)
        assert len(drained) == 2
        assert all(rr.generated for rr in drained)
        smalls = [Request(rid=i,
                          prompt=tuple(int(x) for x in rng.integers(
                              0, 97, size=4)),
                          max_new_tokens=4, submitted_at=0.0)
                  for i in range(6)]
        admitted = []

        class Logged(PagedServingEngine):
            def admit(self, req, emitted=()):
                admitted.append(req.rid)
                return super().admit(req, emitted)

        fresh = Logged(params, cfg, pcfg)
        sched2 = RequestScheduler(SchedulerConfig(), num_slots=2)
        for r in smalls:
            sched2.submit(r)
        results = serve_loop(fresh, sched2, resume=drained,
                             max_dispatches=2000)
        assert set(results) == {r.rid for r in bigs + smalls}
        assert admitted[:2] == [900, 901], admitted
        want = self.truth(dense, [dataclasses.replace(r) for r in bigs]
                          + [dataclasses.replace(r) for r in smalls])
        assert_baseline(results, want)

    @pytest.mark.parametrize("impl", ["gather", "kernel"])
    def test_dispatch_fault_recovery_frees_pages(self, dense, impl):
        cfg, params = dense
        plan = FaultPlan([FaultPoint("engine.dispatch", "raise", hit=3)])
        engine = PagedServingEngine(params, cfg, PagedEngineConfig(
            num_slots=2, page_size=4, attention_impl=impl))
        sched = RequestScheduler(SchedulerConfig(), num_slots=2)
        for r in self.reqs(4, 6, 43):
            sched.submit(r)
        with plan.armed():
            results = serve_loop(engine, sched, max_dispatches=2000)
        assert plan.fired
        engine.pool.check_invariants()
        assert engine.pool.pages_in_use == 0
        assert_baseline(results, self.truth(dense, self.reqs(4, 6, 43)))

    def test_hang_recovery_restores_pool_capacity(self, dense, held):
        cfg, params = dense
        plan = held([FaultPoint("engine.dispatch", "hang", hit=3)])
        engine = PagedServingEngine(params, cfg, PagedEngineConfig(
            num_slots=2, page_size=4, decode_steps=4,
            watchdog_timeout_s=WATCHDOG_S))
        seen = []
        recover = engine._recover
        engine._recover = lambda reason: (
            recover(reason), seen.append(engine.pool.free_pages))[0]
        sched = RequestScheduler(SchedulerConfig(), num_slots=2)
        for r in self.reqs(4, 12, 45):
            sched.submit(r)
        with plan.armed():
            results = serve_loop(engine, sched, max_dispatches=2000)
        assert engine.watchdog_trips == 1
        assert seen == [engine.pool.capacity]
        want = {}
        for r in self.reqs(4, 12, 45):
            e = PagedServingEngine(params, cfg, PagedEngineConfig(
                num_slots=2, page_size=4, decode_steps=4))
            s = RequestScheduler(SchedulerConfig(), num_slots=2)
            s.submit(r)
            want.update(serve_loop(e, s))
        assert_baseline(results, want)


class TestSpeculativeFaults:
    """The speculative engines under the watchdog, a raise, a NaN lane,
    and a drain restored into a fresh engine: greedy tokens stay the
    fault-free speculative run's (the plain greedy engine's)."""

    @pytest.fixture(scope="class")
    def spec(self, params):
        draft = cli.make_draft_model(params, CFG, 1)
        return params, draft

    def make(self, spec, paged, watchdog):
        params, (dparams, dcfg) = spec
        if paged:
            return PagedSpeculativeEngine(
                params, CFG, dparams, dcfg, PagedEngineConfig(
                    num_slots=SLOTS, page_size=4, draft_steps=3,
                    watchdog_timeout_s=watchdog))
        return SpeculativeEngine(params, CFG, dparams, dcfg, EngineConfig(
            num_slots=SLOTS, draft_steps=3, watchdog_timeout_s=watchdog))

    @pytest.mark.parametrize("kind", ["hang", "raise", "nan", "preempt"])
    @pytest.mark.parametrize("paged", [False, True])
    def test_faults_keep_the_greedy_tokens(self, spec, baselines, held,
                                           kind, paged):
        plan = held([point_for(kind, 1)])
        metrics = ServingMetrics()
        sched = RequestScheduler(SchedulerConfig(
            retry=RetryPolicy(max_attempts=3, base_delay=0.0)),
            num_slots=SLOTS)
        for r in make_requests():
            sched.submit(r)
        results, engines, restored = cli.serve_until_done(
            lambda: self.make(spec, paged, WATCHDOG_S), sched,
            metrics=metrics, plan=plan, max_dispatches=2000)
        assert len(plan.fired) == 1
        assert_baseline(results, baselines[1])
        assert metrics.watchdog_trips_total == (kind == "hang")
        assert metrics.fault_survived == 1
        if kind == "preempt":
            assert restored and len(engines) == 2
        for e in engines:
            if paged:
                assert e.pool.pages_in_use == 0
                assert e.draft_pool.free_pages == e.draft_pool.capacity
            e.close()


class TestClockSkew:
    def test_skewed_clock_sheds_instead_of_wedging(self, params):
        plan = FaultPlan([FaultPoint("scheduler.clock", "skew",
                                     hit=40, duration_s=1e6)])
        clock = plan.wrap_clock(_TickClock(dt=0.01))
        metrics = ServingMetrics(clock=clock)
        engine, sched = build(params, s=1, watchdog=None,
                              policy="deadline", clock=clock,
                              sleep=lambda dt: None, metrics=metrics,
                              tpot_estimate=0.05)
        reqs = make_requests(n=6, budget=12, eos_every=0)
        for r in reqs:
            r.deadline = 50.0
        with plan.armed():
            results, _ = run_to_completion(params, engine, sched, reqs,
                                           metrics=metrics)
        assert ("scheduler.clock", "skew", 40) in plan.fired
        assert set(results) == {r.rid for r in reqs}
        statuses = {reason for _, reason in results.values()}
        assert statuses <= {"evicted", "rejected_infeasible",
                            "max_tokens", "eos"}
        assert metrics.deadline_misses_total >= 1


class TestFaultMetricsSurface:
    def test_summary_carries_the_fault_counters(self):
        m = ServingMetrics()
        m.on_retry(1)
        m.on_evict(2, 3)
        m.on_watchdog_trip()
        m.on_drop(3, "dead_letter")
        m.on_drop(4, "rejected_infeasible")
        m.on_fault_injected(2)
        m.on_fault_survived("watchdog")
        f = m.summary()["faults"]
        assert f == {"retries_total": 1, "evictions_total": 1,
                     "deadline_misses_total": 2,
                     "watchdog_trips_total": 1, "dead_letter_total": 1,
                     "fault_injected": 2, "fault_survived": 1}
        reg = m.registry
        assert reg.value("serve_watchdog_trips_total") == 1
        assert reg.value("serve_fault_injected_total") == 2

    def test_discard_moves_decode_to_wasted(self):
        m = ServingMetrics()
        m.on_block_tokens(1, 0.0, 4)
        assert m.decode_tokens == 4
        m.on_discard(1, 4)
        assert m.decode_tokens == 0 and m.wasted_tokens == 4
        assert m.summary()["wasted_token_rate"] == 1.0


class TestFaultPlanFuzz:
    """Seeded chaos scripts x open-loop load: the reconciliation holds
    for every seed (injected == survived; retries + dead letters ==
    failed attempts; one terminal record a request; every completion
    the fault-free run's)."""

    @pytest.mark.parametrize("seed", range(6))
    def test_reconciliation_holds_for_every_seed(self, params, held,
                                                 seed):
        s = 4 if seed % 2 else 1
        policy = "deadline" if seed >= 3 else "fifo"
        n = 8 + seed % 3

        def fuzz_requests(open_loop):
            r = np.random.default_rng(1000 + seed)
            t0 = time.monotonic()
            return [Request(
                rid=rid,
                prompt=tuple(int(x) for x in r.integers(
                    0, MODEL["vocab_size"], size=(3, 5)[rid % 2])),
                max_new_tokens=int(r.integers(6, 9)),
                eos_token=3 if rid % 3 == 0 else None,
                arrival=(t0 + 0.005 * rid) if open_loop else 0.0,
                submitted_at=0.0) for rid in range(n)]

        engine, sched = build(params, s=s, watchdog=None, policy=policy)
        truth, _ = run_to_completion(params, engine, sched,
                                     fuzz_requests(open_loop=False))
        prng = random.Random(seed)
        h = prng.randint(1, 2)
        if seed >= 4:
            nn = h + 6 + prng.randint(0, 1)
            points = [
                FaultPoint("engine.dispatch", "hang", hit=h),
                FaultPoint("engine.dispatch", "raise", hit=h + 2,
                           times=4),
                FaultPoint("engine.logits", "nan", hit=nn,
                           slot=prng.randrange(SLOTS)),
                FaultPoint("serve.loop", "preempt", hit=nn + 1),
            ]
        else:
            r_hit = h + prng.randint(2, 3)
            nn = r_hit + prng.randint(2, 3)
            points = [
                FaultPoint("engine.dispatch", "hang", hit=h),
                FaultPoint("engine.dispatch", "raise", hit=r_hit),
                FaultPoint("engine.logits", "nan", hit=nn,
                           slot=prng.randrange(SLOTS)),
                FaultPoint("serve.loop", "preempt", hit=nn + 1),
            ]
        plan = held(points, seed=seed)
        metrics = ServingMetrics()
        engine, sched = build(params, s=s, policy=policy,
                              max_attempts=2 if seed >= 4 else 3,
                              metrics=metrics)
        results, _ = run_to_completion(
            params, engine, sched, fuzz_requests(open_loop=True),
            metrics=metrics, plan=plan)
        metrics.on_fault_injected(len(plan.fired))
        assert {"hang", "raise", "nan", "preempt"} <= {
            k for _site, k, _hit in plan.fired}, plan.fired
        assert metrics.fault_injected == metrics.fault_survived
        assert metrics.retries_total + metrics.dead_letter_total \
            == metrics.requests_failed
        assert set(results) == set(range(n))
        for rid, (toks, reason) in results.items():
            if reason == "dead_letter":
                assert toks == [] and seed >= 4
                continue
            assert list(toks) == list(truth[rid][0]), f"rid {rid}"
            assert reason == truth[rid][1]
        if seed >= 4:
            assert metrics.dead_letter_total >= 1


class TestTraceCorrelation:
    """The rid rides every lifecycle event and span through a retry and
    an eviction; the engine's spans count its dispatches."""

    def test_rid_survives_retry(self, params):
        tracer = Tracer()
        metrics = ServingMetrics(tracer=tracer)
        plan = FaultPlan([point_for("raise", 1)])
        engine = ServingEngine(
            params, CFG, EngineConfig(num_slots=SLOTS,
                                      watchdog_timeout_s=WATCHDOG_S),
            metrics=metrics, tracer=tracer)
        sched = RequestScheduler(
            SchedulerConfig(retry=RetryPolicy(max_attempts=3,
                                              base_delay=0.0)),
            num_slots=SLOTS)
        for r in make_requests():
            metrics.on_submit(r.rid)
            sched.submit(r)
        with plan.armed():
            results = serve_loop(engine, sched, metrics=metrics,
                                 max_dispatches=2000)
        failed = [e.fields["rid"] for e in tracer.events
                  if e.kind == "serve_failure"]
        assert failed
        rid = failed[0]
        kinds = [e.kind for e in tracer.events
                 if e.fields.get("rid") == rid]
        assert kinds[0] == "serve_submit"
        assert kinds.count("serve_admit") >= 2
        assert kinds.count("serve_prefill") >= 2
        assert "serve_retry" in kinds and kinds[-1] == "serve_complete"
        assert results[rid][1] in ("eos", "max_tokens", "stop")
        counts = tracer.counters
        # a raising dispatch opened its span too, and recovered once
        assert counts["serve_step"] == engine.decode_dispatches + 1
        assert counts["engine_dispatch"] == engine.decode_dispatches
        assert counts["serve_recover"] == 1
        assert counts["serve_prefill"] == engine.prefill_dispatches
        dt = engine.device_time_summary()
        assert dt["host_ms"]["count"] == engine.decode_dispatches
        engine.close()

    def test_rid_survives_eviction(self, params):
        tracer = Tracer()
        clock = _TickClock(dt=0.05)
        metrics = ServingMetrics(tracer=tracer, clock=clock)
        engine, sched = build(params, s=1, watchdog=None,
                              policy="deadline", clock=clock,
                              sleep=clock.sleep, metrics=metrics)
        engine.tracer = tracer
        for r in make_requests(n=3, budget=20, eos_every=0, deadline=0.4):
            metrics.on_submit(r.rid)
            sched.submit(r)
        serve_loop(engine, sched, metrics=metrics, max_dispatches=2000)
        evicted = [e.fields["rid"] for e in tracer.events
                   if e.kind == "serve_evict"]
        assert evicted
        kinds = [e.kind for e in tracer.events
                 if e.fields.get("rid") == evicted[0]]
        assert kinds[-1] == "serve_evict" and "serve_admit" in kinds


def path_logits(jparams, jcfg, prompt, toks) -> np.ndarray:
    """JAX's logits along its own token path (one causal forward)."""
    seq = np.asarray([list(prompt) + list(toks[:-1])], np.int32)
    logits = jtf.transformer_apply(jparams, seq, jcfg)[0]
    return np.asarray(logits)[len(prompt) - 1:]


def _jax_run(jparams, jcfg, s, plan=None):
    """The JAX package's engine under ``plan`` (unarmed and without a
    watchdog when None), restoring each drain into a fresh engine:
    (results, metrics, restored rids)."""
    wd = JAX_WATCHDOG_S if plan is not None else None

    def mk():
        return jserve.ServingEngine(jparams, jcfg, jserve.EngineConfig(
            num_slots=SLOTS, decode_steps=s, watchdog_timeout_s=wd))
    sched = jserve.RequestScheduler(jserve.SchedulerConfig(
        retry=jserve.RetryPolicy(max_attempts=3, base_delay=0.0)),
        num_slots=SLOTS)
    for r in make_requests(mod=jserve):
        sched.submit(r)
    metrics = jserve.ServingMetrics()
    engine, restored = mk(), set()
    with (plan.armed() if plan is not None
          else contextlib.nullcontext()):
        results = jserve.serve_loop(engine, sched, metrics=metrics,
                                    max_dispatches=2000)
        while engine.drained or sched.unfinished:
            fresh = mk()
            for rr in engine.drained:
                restored.add(rr.req.rid)
                sched.bind(rr.req, fresh.restore(rr))
            results.update(jserve.serve_loop(fresh, sched, metrics=metrics,
                                             max_dispatches=2000))
            engine = fresh
    engine.close()
    return results, metrics, restored


class TestAgainstJax:
    """The same fault script at the same tiny shape through the JAX
    package's engine and the port's, on the same weights
    (``convert.params_from_jax``): the plan's firing ledger, every
    request's reason, the retries, dead letters, trips and restored rids
    equal; tokens under ``greedy_agree`` against JAX's path logits."""

    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("s", [1, 4])
    def test_chaos_script_matches_jax(self, weights, held, seed, s):
        jcfg, jparams, tparams = weights
        # warm JAX's programs for these shapes before arming
        _jax_run(jparams, jcfg, s)
        points = FaultPlan.chaos(seed, slots=SLOTS).points
        jplan = held([jfaults.FaultPoint(*dataclasses.astuple(p))
                      for p in points], seed=seed, mod=jfaults)
        want, jm, jrestored = _jax_run(jparams, jcfg, s, jplan)
        jplan.release.set()
        plan = held(points, seed=seed)
        metrics = ServingMetrics()
        sched = RequestScheduler(SchedulerConfig(
            retry=RetryPolicy(max_attempts=3, base_delay=0.0)),
            num_slots=SLOTS)
        for r in make_requests():
            sched.submit(r)
        ecfg = EngineConfig(num_slots=SLOTS, decode_steps=s,
                            watchdog_timeout_s=WATCHDOG_S)
        got, _, restored = cli.serve_until_done(
            lambda: ServingEngine(tparams, CFG, ecfg), sched,
            metrics=metrics, plan=plan, max_dispatches=2000)
        assert plan.fired == jplan.fired
        assert restored == jrestored
        for name in ("watchdog_trips_total", "retries_total",
                     "dead_letter_total", "requests_failed",
                     "fault_survived"):
            assert getattr(metrics, name) == getattr(jm, name), name
        assert got.keys() == want.keys()
        reqs = {r.rid: r for r in make_requests()}
        for rid, (toks, reason) in want.items():
            ok, why = greedy_agree(toks, got[rid][0], path_logits(
                jparams, jcfg, reqs[rid].prompt, toks))
            assert ok, f"rid {rid}: {why}"
            assert got[rid][1] == reason
