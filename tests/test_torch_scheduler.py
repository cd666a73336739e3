"""The port's request scheduler against the JAX package's, step for step.

``serving/scheduler.py`` is pure Python in both packages, so one seeded
script of submits (future-dated and immediate, FIFO and deadline
policies), memory-gated pops, binds, releases and failure requeues on a
fake clock must give the same admission order, rejections, dead letters
and counters, bitwise.
"""

import numpy as np
import pytest

from akka_allreduce_tpu.serving import scheduler as jsched
from akka_allreduce_tpu_torch.serving import scheduler as tsched


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt


def drive(mod, seed: int, policy: str, steps: int = 200) -> list:
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    rejected = []
    sched = mod.RequestScheduler(
        mod.SchedulerConfig(max_queue_depth=6, policy=policy,
                            th_step=0.5, tpot_estimate=0.01,
                            retry=mod.RetryPolicy(max_attempts=2,
                                                  base_delay=0.1,
                                                  jitter=0.05),
                            seed=seed),
        num_slots=3, clock=clock, sleep=clock.sleep,
        on_reject=rejected.append)
    log = []
    rid = 0
    for _ in range(steps):
        op = int(rng.integers(0, 5))
        if op <= 1:
            arrival = clock.t + float(rng.choice([0.0, rng.random()]))
            deadline = (None if rng.random() < 0.3
                        else arrival + float(rng.random()))
            req = mod.Request(rid=rid, prompt=(1,) * int(rng.integers(1, 6)),
                              max_new_tokens=int(rng.integers(1, 9)),
                              arrival=arrival, deadline=deadline)
            rid += 1
            try:
                sched.submit(req)
                log.append(("submit", req.rid))
            except mod.QueueFull:
                log.append(("queue_full", req.rid))
        elif op == 2 and sched.occupied < sched.num_slots:
            budget = int(rng.integers(0, 12))
            req = sched.pop_ready(
                clock.t, can_admit=lambda r: r.max_new_tokens <= budget)
            if req is not None:
                free = min(set(range(3)) - {
                    s for s in range(3) if sched.bound_request(s)})
                sched.bind(req, free)
            log.append(("pop", None if req is None else req.rid))
        elif op == 3 and sched.occupied:
            slot = min(s for s in range(3) if sched.bound_request(s))
            req = sched.release(slot)
            if rng.random() < 0.4:
                log.append(("requeue", req.rid,
                            sched.requeue_failed(req, "nan")))
            else:
                log.append(("release", req.rid))
        else:
            clock.sleep(float(rng.random()) * 0.3)
        log.append((sched.queue_depth, sched.backlog_tokens,
                    sched.occupied, sched.unfinished, sched.rejected,
                    sched.blocked_on_memory, sched.retries,
                    sched.shed_infeasible, sched.should_step(sched.occupied),
                    sched.next_arrival_time(),
                    [(r.rid, s) for r, s in sched.drain_dropped()]))
    log.append(("dead", [(r.rid, why) for r, why in sched.dead_letter],
                rejected))
    return log


@pytest.mark.parametrize("policy", ["fifo", "deadline"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_script_same_order(seed, policy):
    want = drive(jsched, seed, policy)
    got = drive(tsched, seed, policy)
    assert got == want
    assert any(e[0] == "pop" and e[1] is not None for e in got
               if isinstance(e[0], str))


def test_config_validation_matches():
    for kw in (dict(policy="lifo"), dict(max_queue_depth=0),
               dict(th_step=1.5), dict(tpot_estimate=-1.0)):
        with pytest.raises(ValueError):
            jsched.SchedulerConfig(**kw)
        with pytest.raises(ValueError):
            tsched.SchedulerConfig(**kw)
