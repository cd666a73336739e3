"""Bucketed slot prefill and mid-flight deadline eviction in the port's
engines, against the JAX package's.

* Buckets: prompts padded up to a bucket, their logits read at the true
  last position, emit exact-length prefill's greedy tokens under the
  decode-parity rule (padding changes reduction lengths, an ulp-level
  drift) and JAX's bucketed engine's; the prefill lengths are the
  buckets; a prompt over the largest bucket, a bucket over max_seq and
  buckets on the paged engine are refused.
* Eviction: with a clock that ticks per reading (no sleeping), a
  request whose deadline passes mid-flight is evicted between
  dispatches — result ``([], "evicted")``, its partial decode counted
  as wasted, one eviction and one deadline miss — and its slot is
  refilled: every other request runs to its budget. The port's counts
  and statuses are JAX's on the same scenario, on the slot engine and
  on the paged engine (whose pages all come back), at decode_steps 1
  and 4.

f32 on the CPU; weights from a JAX seed carried across by ``convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import akka_allreduce_tpu.serving as jserve
import akka_allreduce_tpu_torch.serving as tserve
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.parity import greedy_agree

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=40, rope=True)


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ttf.TransformerConfig(**MODEL), tparams


class TickClock:
    """Each reading advances ``dt``: wall time without sleeping."""

    def __init__(self, dt=0.05):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def sleep(self, dt):
        self.t += dt


def make_requests(mod, n=6, steps=6, seed=11, budget=None):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=rid, prompt=tuple(int(x) for x in rng.integers(
        0, MODEL["vocab_size"], size=int(rng.integers(2, 8)))),
        max_new_tokens=budget or steps, submitted_at=0.0)
        for rid in range(n)]


def run(mod, engine, reqs, clock=None, metrics=None, policy="fifo"):
    kw = {} if clock is None else dict(clock=clock, sleep=clock.sleep)
    sched = mod.RequestScheduler(mod.SchedulerConfig(policy=policy),
                                 num_slots=engine.num_slots, **kw)
    for r in reqs:
        if metrics is not None:
            metrics.on_submit(r.rid)
        sched.submit(r)
    return mod.serve_loop(engine, sched, metrics=metrics,
                          max_dispatches=400)


def path_logits(jparams, jcfg, prompt, toks) -> np.ndarray:
    seq = np.zeros((1, jcfg.max_seq), np.int32)
    full = list(prompt) + list(toks[:-1])
    seq[0, :len(full)] = full
    logits = jtf.transformer_apply(jparams, jnp.asarray(seq), jcfg)[0]
    return np.asarray(logits)[len(prompt) - 1:len(full)]


@pytest.mark.parametrize("steps", [1, 4])
def test_bucketed_tokens_match_exact_and_jax(weights, steps):
    jcfg, jparams, tcfg, tparams = weights
    exact = run(tserve, tserve.ServingEngine(tparams, tcfg,
                                             tserve.EngineConfig(
                                                 num_slots=2,
                                                 decode_steps=steps)),
                make_requests(tserve))
    engine = tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
        num_slots=2, decode_steps=steps, prefill_buckets=(4, 8)))
    bucketed = run(tserve, engine, make_requests(tserve))
    want = run(jserve, jserve.ServingEngine(jparams, jcfg,
                                            jserve.EngineConfig(
                                                num_slots=2,
                                                decode_steps=steps,
                                                prefill_buckets=(4, 8))),
               make_requests(jserve))
    for r in make_requests(tserve):
        for ref in (exact[r.rid][0], want[r.rid][0]):
            ok, why = greedy_agree(ref, bucketed[r.rid][0], path_logits(
                jparams, jcfg, r.prompt, ref))
            assert ok, f"rid {r.rid}: {why}"
    assert engine.prefill_shapes <= {4, 8}
    assert engine.prefill_dispatches == 6


def test_bucket_refusals(weights):
    _, _, tcfg, tparams = weights
    engine = tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
        num_slots=1, prefill_buckets=(4,)))
    with pytest.raises(ValueError, match="bucket"):
        engine.admit(tserve.Request(rid=0, prompt=tuple(range(6)),
                                    max_new_tokens=2))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
            prefill_buckets=(8, 64)))
    with pytest.raises(ValueError, match="strictly increasing"):
        tserve.EngineConfig(prefill_buckets=(8, 4))
    with pytest.raises(ValueError, match="slot-engine knob"):
        tserve.PagedEngineConfig(prefill_buckets=(8,))


def evict_scenario(mod, engine_for, steps):
    clock = TickClock()
    metrics = mod.ServingMetrics(clock=clock)
    engine = engine_for(clock, steps)
    reqs = make_requests(mod, n=4, budget=30)
    reqs[0] = dataclasses.replace(reqs[0], deadline=1.0)
    for r in reqs[1:]:
        r.deadline = 1e9
    results = run(mod, engine, reqs, clock=clock, metrics=metrics,
                  policy="deadline")
    return results, engine, metrics


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("steps", [1, 4])
def test_expired_request_evicted_mid_flight_as_jax(weights, paged, steps):
    jcfg, jparams, tcfg, tparams = weights

    def engine_for(mod, params, cfg):
        def make(clock, s):
            if paged:
                return mod.PagedServingEngine(params, cfg,
                                              mod.PagedEngineConfig(
                                                  num_slots=1, page_size=4,
                                                  decode_steps=s),
                                              clock=clock)
            return mod.ServingEngine(params, cfg, mod.EngineConfig(
                num_slots=1, decode_steps=s), clock=clock)
        return make

    out = {}
    for name, mod, params, cfg in (("jax", jserve, jparams, jcfg),
                                   ("port", tserve, tparams, tcfg)):
        out[name] = evict_scenario(mod, engine_for(mod, params, cfg),
                                   steps)
    (jres, jeng, jmet), (res, eng, met) = out["jax"], out["port"]
    assert res[0] == jres[0] == ([], "evicted")
    assert eng.evictions == jeng.evictions == 1
    assert met.evictions_total == jmet.evictions_total == 1
    assert met.deadline_misses_total == jmet.deadline_misses_total == 1
    assert met.wasted_tokens > 0 and jmet.wasted_tokens > 0
    assert met.summary()["faults"]["evictions_total"] == 1
    for rid in (1, 2, 3):
        assert res[rid][1] == jres[rid][1] == "max_tokens"
        assert len(res[rid][0]) == 30
        ok, why = greedy_agree(jres[rid][0], res[rid][0], path_logits(
            jparams, jcfg, make_requests(tserve, n=4)[rid].prompt,
            jres[rid][0]))
        assert ok, f"rid {rid}: {why}"
    if paged:
        assert eng.pool.pages_in_use == 0
        eng.pool.check_invariants()
