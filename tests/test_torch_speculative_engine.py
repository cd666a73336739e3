"""The port's speculative serving engines against its plain engines and
the JAX package's speculative engines.

* Greedy: ``SpeculativeEngine`` and ``PagedSpeculativeEngine`` (gather
  path) emit exactly the port's plain greedy engine's tokens and finish
  reasons under churn — EOS on odd rids, a stop token on rid 2, ragged
  budgets — at draft_steps 1, 3 and 5, on float and int8 target KV;
  and agree with JAX's speculative engines under the decode-parity rule
  (``parity.greedy_agree``, JAX's logits along its own stream).
* The paged engine returns every page of both pools
  (``paging_summary``: free pages equal to the pool) and keeps the pools'
  invariants.
* The draft ledger: proposed == accepted + rejected, rejected drafts are
  the wasted tokens, the metrics' series agree with the engine's
  counters, a block emits at least one token.
* Sampled speculation draws on JAX's key schedule: tokens equal JAX's
  sampled speculative engine's, runs are seed-deterministic, a
  self-draft accepts far above the truncated draft.
* Refusals: admission without draft_steps of headroom, a vocabulary
  mismatch, draft_steps 0, and the config exclusions (with
  decode_steps > 1, with buckets, on the kernel path).

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

MODEL = dict(vocab_size=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=48, rope=True)
# rid 2's stop token: the third token of its greedy stream (a token that
# does not occur earlier in it, so the stop lands mid-block)
EOS, STOP, K = 5, 46, 3
SAMPLE = dict(temperature=1.3, top_k=16)


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    tcfg = ttf.TransformerConfig(**MODEL)
    return {"jax": (jparams, jcfg, {**jparams,
                                    "layers": jparams["layers"][:1]},
                    dataclasses.replace(jcfg, n_layers=1)),
            "port": (tparams, tcfg, {**tparams,
                                     "layers": tparams["layers"][:1]},
                     dataclasses.replace(tcfg, n_layers=1))}


def make_requests(mod, n=8, seed=7):
    """EOS on odd rids, a stop token on rid 2, ragged budgets."""
    r = np.random.default_rng(seed)
    return [mod.Request(
        rid=rid, prompt=tuple(int(x) for x in r.integers(
            0, MODEL["vocab_size"], size=int(r.integers(2, 7)))),
        max_new_tokens=int(r.integers(4, 10)),
        eos_token=EOS if rid % 2 else None,
        stop_tokens=(STOP,) if rid == 2 else (),
        seed=200 + rid, submitted_at=0.0) for rid in range(n)]


def run(mod, engine, reqs, metrics=None) -> dict:
    sched = mod.RequestScheduler(mod.SchedulerConfig(),
                                 num_slots=engine.num_slots)
    for r in reqs:
        if metrics is not None:
            metrics.on_submit(r.rid)
        sched.submit(r)
    return mod.serve_loop(engine, sched, metrics=metrics,
                          max_dispatches=400)


def spec(mod, w, paged=False, draft=None, metrics=None, **kw):
    params, cfg, dparams, dcfg = w
    if draft is not None:
        dparams, dcfg = draft
    kw.setdefault("draft_steps", K)
    if paged:
        return mod.PagedSpeculativeEngine(
            params, cfg, dparams, dcfg,
            mod.PagedEngineConfig(num_slots=3, page_size=4, **kw),
            metrics=metrics)
    return mod.SpeculativeEngine(params, cfg, dparams, dcfg,
                                 mod.EngineConfig(num_slots=3, **kw),
                                 metrics=metrics)


def plain(mod, w, **kw) -> dict:
    params, cfg = w[:2]
    return run(mod, mod.ServingEngine(params, cfg, mod.EngineConfig(
        num_slots=3, **kw)), make_requests(mod))


def check_pools(engine) -> None:
    summary = engine.paging_summary()
    assert summary["pages_free"] == summary["pages_total"]
    assert summary["draft_pages_free"] == summary["draft_pages_total"]
    engine.pool.check_invariants()
    engine.draft_pool.check_invariants()


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_greedy_is_the_plain_engines_exactly(weights, paged, k):
    w = weights["port"]
    want = plain(tserve, w)
    assert {r for _, r in want.values()} >= {"eos", "stop", "max_tokens"}
    engine = spec(tserve, w, paged=paged, draft_steps=k)
    assert run(tserve, engine, make_requests(tserve)) == want
    if paged:
        check_pools(engine)


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_int8_target_kv_parity(weights, paged):
    w = weights["port"]
    want = plain(tserve, w, kv_dtype="int8")
    engine = spec(tserve, w, paged=paged, kv_dtype="int8")
    assert run(tserve, engine, make_requests(tserve)) == want


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_greedy_matches_the_jax_speculative_engines(weights, paged):
    jparams, jcfg = weights["jax"][:2]
    want = run(jserve, spec(jserve, weights["jax"], paged=paged),
               make_requests(jserve))
    got = run(tserve, spec(tserve, weights["port"], paged=paged),
              make_requests(tserve))
    for r in make_requests(tserve):
        ref = want[r.rid][0]
        seq = np.zeros((1, jcfg.max_seq), np.int32)
        full = list(r.prompt) + list(ref[:-1])
        seq[0, :len(full)] = full
        logits = np.asarray(jtf.transformer_apply(
            jparams, jnp.asarray(seq), jcfg)[0])[len(r.prompt) - 1:len(full)]
        ok, why = greedy_agree(ref, got[r.rid][0], logits)
        assert ok, f"rid {r.rid}: {why}"
        if list(got[r.rid][0]) == list(ref):
            assert got[r.rid][1] == want[r.rid][1]


def test_draft_ledger_and_metrics(weights):
    metrics = tserve.ServingMetrics()
    engine = spec(tserve, weights["port"], metrics=metrics)
    reqs = make_requests(tserve)
    results = run(tserve, engine, reqs, metrics=metrics)
    assert engine.draft_proposed > 0
    assert engine.draft_proposed == (engine.draft_accepted
                                     + engine.draft_rejected)
    assert (metrics.draft_proposed, metrics.draft_accepted,
            metrics.draft_rejected) == (engine.draft_proposed,
                                        engine.draft_accepted,
                                        engine.draft_rejected)
    assert metrics.wasted_tokens == engine.wasted_tokens \
        == engine.draft_rejected
    assert metrics.draft_acceptance.summary()["count"] == len(reqs)
    summary = metrics.summary()
    assert summary["speculative"]["acceptance_rate"] == round(
        engine.acceptance_rate, 4)
    assert metrics.registry.value("serve_draft_proposed_total") == \
        engine.draft_proposed
    emitted = sum(len(t) for t, _ in results.values())
    assert engine.decode_dispatches <= emitted
    assert engine.speculative_summary()["draft_steps"] == K
    assert engine.kv_cache_bytes() > tserve.ServingEngine(
        *weights["port"][:2], tserve.EngineConfig(num_slots=3)
    ).kv_cache_bytes()


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_sampled_speculation_matches_jax_and_is_deterministic(weights,
                                                              paged):
    want = run(jserve, spec(jserve, weights["jax"], paged=paged, **SAMPLE),
               make_requests(jserve))
    a_engine = spec(tserve, weights["port"], paged=paged, **SAMPLE)
    a = run(tserve, a_engine, make_requests(tserve))
    b = run(tserve, spec(tserve, weights["port"], paged=paged, **SAMPLE),
            make_requests(tserve))
    assert a == b
    assert a == {rid: (list(t), r) for rid, (t, r) in want.items()}
    if paged:
        check_pools(a_engine)


def test_self_draft_accepts_when_sampling(weights):
    params, cfg = weights["port"][:2]
    engine = spec(tserve, weights["port"], draft=(params, cfg), **SAMPLE)
    run(tserve, engine, make_requests(tserve))
    assert engine.acceptance_rate > 0.5


def test_refusals(weights):
    params, cfg, dparams, dcfg = weights["port"]
    engine = tserve.SpeculativeEngine(params, cfg, dparams, dcfg,
                                      tserve.EngineConfig(num_slots=1,
                                                          draft_steps=K))
    with pytest.raises(ValueError, match="draft_steps"):
        engine.admit(tserve.Request(rid=1, prompt=(1, 2, 3),
                                    max_new_tokens=44))
    with pytest.raises(ValueError, match="vocabulary"):
        tserve.SpeculativeEngine(params, cfg, dparams,
                                 dataclasses.replace(dcfg, vocab_size=32),
                                 tserve.EngineConfig(draft_steps=K))
    with pytest.raises(ValueError, match="draft_steps >= 1"):
        tserve.SpeculativeEngine(params, cfg, dparams, dcfg,
                                 tserve.EngineConfig())
    with pytest.raises(ValueError, match="block modes"):
        tserve.EngineConfig(draft_steps=2, decode_steps=4)
    with pytest.raises(ValueError, match="exact-length"):
        tserve.EngineConfig(draft_steps=2, prefill_buckets=(8, 16))
    with pytest.raises(ValueError, match="block extend"):
        tserve.PagedEngineConfig(draft_steps=2, attention_impl="kernel")
