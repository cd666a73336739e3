"""Seeded sampling in the port against the JAX package.

* ``apply_sample_filters`` (temperature, top-k, top-p) on the same
  logits as JAX's, ``allclose`` at rtol 1e-6 (the softmax and cumsum of
  the nucleus filter may part by an ulp; a kept set is compared exactly).
* ``generate(key=, temperature=, top_k=, top_p=)`` against JAX's
  ``generate(key=jax.random.key(seed))`` under the perturbed-score rule:
  ``parity.greedy_agree`` with the reference's filtered logits plus its
  Gumbel noise as ``ref_logits`` (the greedy rule applied to the scores
  the sampled pick takes the argmax of).
* The port's sampled engines (slot, paged gather, paged kernel — its
  plain version on CPU tensors) emit each request's
  ``generate(key=prng.key(seed))`` stream bitwise, whatever the slot
  placement, admission order, churn and ``decode_steps`` (1 or 4); and
  agree with the JAX sampled engine under the perturbed-score rule.

f32 on the CPU; weights from a JAX seed carried across by ``convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_allreduce_tpu.serving as jserve
import akka_allreduce_tpu_torch.serving as tserve
from akka_allreduce_tpu.models import generate as jgen
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import generate as tgen
from akka_allreduce_tpu_torch.models import prng
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.parity import greedy_agree

MODEL = dict(vocab_size=61, d_model=32, n_heads=2, n_kv_heads=1,
             n_layers=2, d_ff=64, max_seq=32, rope=True)
EOS = 5
SAMPLE = dict(temperature=1.3, top_k=20)
FILTERS = [(0.8, 50, 0.95), (1.0, None, None), (0.7, 5, None),
           (1.3, None, 0.5)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ttf.TransformerConfig(**MODEL), tparams


def make_requests(mod, n=6, seed=7, eos_every=2):
    r = np.random.default_rng(seed)
    return [mod.Request(
        rid=rid,
        prompt=tuple(int(x) for x in r.integers(
            0, MODEL["vocab_size"], size=int(r.integers(2, 7)))),
        max_new_tokens=int(r.integers(4, 9)),
        eos_token=EOS if rid % eos_every else None,
        seed=100 + rid, submitted_at=0.0) for rid in range(n)]


def run(mod, engine, reqs) -> dict:
    sched = mod.RequestScheduler(mod.SchedulerConfig(),
                                 num_slots=engine.num_slots)
    for r in reqs:
        sched.submit(r)
    return mod.serve_loop(engine, sched, max_dispatches=400)


def port_stream(tparams, tcfg, req, **kw) -> list:
    prompt = torch.tensor([req.prompt])
    key = prng.key(req.seed)
    if req.eos_token is None:
        return tgen.generate(tparams, prompt, tcfg,
                             steps=req.max_new_tokens, key=key,
                             **kw)[0].tolist()
    toks, lengths = tgen.generate(tparams, prompt, tcfg,
                                  steps=req.max_new_tokens, key=key,
                                  eos_token=req.eos_token, **kw)
    return toks[0, :int(lengths[0])].tolist()


def perturbed_scores(jparams, jcfg, prompt, toks, seed, temperature,
                     top_k, top_p) -> np.ndarray:
    """The reference's sampled scores along its own stream: JAX's logits
    (one full forward), JAX's filters, plus JAX's Gumbel noise for token
    j's key ``fold_in(key(seed), j)`` at the (1, vocab) shape."""
    seq = np.zeros((1, jcfg.max_seq), np.int32)
    full = list(prompt) + list(toks[:-1])
    seq[0, :len(full)] = full
    logits = jtf.transformer_apply(jparams, jnp.asarray(seq), jcfg)[0]
    logits = logits[len(prompt) - 1:len(full)]
    filtered = jgen.apply_sample_filters(logits, temperature, top_k, top_p)
    key = jax.random.key(seed)
    noise = jnp.stack([jax.random.gumbel(jax.random.fold_in(key, j),
                                         (1, jcfg.vocab_size))[0]
                       for j in range(len(toks))])
    return np.asarray(filtered + noise)


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS)
def test_filters_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(3).normal(
        scale=3.0, size=(4, 97)).astype(np.float32)
    want = np.asarray(jgen.apply_sample_filters(
        jnp.asarray(logits), temperature, top_k, top_p))
    got = tgen.apply_sample_filters(torch.from_numpy(logits), temperature,
                                    top_k, top_p).numpy()
    assert ((got <= -1e29) == (want <= -1e29)).all()  # the kept sets
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_top_p_keeps_the_token_that_crosses_the_mass():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    out = tgen._filter_top_p(logits, 0.7)
    assert (out[0, :2] > -1e29).all() and (out[0, 2:] <= -1e29).all()
    assert (tgen._filter_top_p(logits, 1e-6)[0, 1:] <= -1e29).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS[:3])
def test_generate_sampled_matches_jax(weights, seed, temperature, top_k,
                                      top_p):
    jcfg, jparams, tcfg, tparams = weights
    prompt = np.array([[5, 17, 2, 40, 33]], np.int32)
    want = np.asarray(jgen.generate(
        jparams, jnp.asarray(prompt), jcfg, steps=12,
        key=jax.random.key(seed), temperature=temperature, top_k=top_k,
        top_p=top_p))[0]
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, steps=12,
                        key=prng.key(seed), temperature=temperature,
                        top_k=top_k, top_p=top_p)[0].tolist()
    scores = perturbed_scores(jparams, jcfg, prompt[0], want, seed,
                              temperature, top_k, top_p)
    ok, why = greedy_agree(want, got, scores)
    assert ok, why


def test_generate_batch_draws_one_key_over_the_batch(weights):
    """b rows draw with one key at the (b, vocab) shape, as JAX's."""
    jcfg, jparams, tcfg, tparams = weights
    prompt = np.array([[5, 17, 2], [9, 9, 40]], np.int32)
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                                    steps=6, key=jax.random.key(4),
                                    temperature=0.9))
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg, steps=6,
                        key=prng.key(4), temperature=0.9)
    assert (got.numpy() == want).all()


def test_sample_token_rows_is_generate_batch_one():
    """Each lane's (1, vocab) draw at its own index equals a batch-1
    categorical with that lane's key — JAX's ``sample_token_rows``."""
    logits = np.random.default_rng(0).normal(size=(3, 61)).astype(
        np.float32)
    kd = np.stack([np.asarray(jax.random.key_data(jax.random.key(s)))
                   for s in (11, 12, 13)])
    idx = np.array([0, 3, 9], np.int32)
    want = np.asarray(jgen.sample_token_rows(
        jnp.asarray(kd), jnp.asarray(logits), jnp.asarray(idx),
        (0.8, 20, 0.9)))
    got = tgen.sample_token_rows(torch.from_numpy(kd.astype(np.int64)),
                                 torch.from_numpy(logits),
                                 torch.from_numpy(idx), (0.8, 20, 0.9))
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("engine", ["slot", "paged_gather", "paged_kernel"])
@pytest.mark.parametrize("steps", [1, 4])
def test_sampled_engines_are_generate_bitwise(weights, engine, steps):
    _, _, tcfg, tparams = weights
    if engine == "slot":
        eng = tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
            num_slots=3, decode_steps=steps, **SAMPLE))
    else:
        eng = tserve.PagedServingEngine(tparams, tcfg,
                                        tserve.PagedEngineConfig(
                                            num_slots=3, page_size=4,
                                            decode_steps=steps,
                                            attention_impl=engine[6:],
                                            **SAMPLE))
    reqs = make_requests(tserve)
    got = run(tserve, eng, reqs)
    for r in reqs:
        assert got[r.rid][0] == port_stream(tparams, tcfg, r, **SAMPLE), \
            r.rid
    if engine != "slot":
        assert eng.pool.pages_in_use == 0


def test_sampled_streams_ignore_placement_and_churn(weights):
    """Reversed admission order, one lane against three: every request's
    stream is the same (keys come from the request, never the slot)."""
    _, _, tcfg, tparams = weights
    base = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=3, **SAMPLE)),
        make_requests(tserve))
    rev = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=3, **SAMPLE)),
        list(reversed(make_requests(tserve))))
    one = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=1, decode_steps=4,
                                           **SAMPLE)),
        make_requests(tserve))
    assert base == rev == one


def test_seed_defaults_to_rid_and_temperature_zero_is_greedy(weights):
    _, _, tcfg, tparams = weights
    unseeded = [dataclasses.replace(r, seed=None)
                for r in make_requests(tserve, eos_every=10)]
    seeded = [dataclasses.replace(r, seed=r.rid)
              for r in make_requests(tserve, eos_every=10)]
    ecfg = tserve.EngineConfig(num_slots=2, **SAMPLE)
    assert run(tserve, tserve.ServingEngine(tparams, tcfg, ecfg),
               unseeded) == run(tserve, tserve.ServingEngine(
                   tparams, tcfg, ecfg), seeded)
    assert tserve.EngineConfig(temperature=0.0, top_k=5).sample is None
    greedy = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=2)),
        make_requests(tserve))
    zero = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=2, temperature=0.0)),
        make_requests(tserve))
    assert zero == greedy


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_sampled_engines_match_jax_engine(weights, paged):
    jcfg, jparams, tcfg, tparams = weights
    if paged:
        want = run(jserve, jserve.PagedServingEngine(
            jparams, jcfg, jserve.PagedEngineConfig(
                num_slots=3, page_size=4, decode_steps=4, **SAMPLE)),
            make_requests(jserve))
        got = run(tserve, tserve.PagedServingEngine(
            tparams, tcfg, tserve.PagedEngineConfig(
                num_slots=3, page_size=4, decode_steps=4, **SAMPLE)),
            make_requests(tserve))
    else:
        want = run(jserve, jserve.ServingEngine(
            jparams, jcfg, jserve.EngineConfig(num_slots=3, **SAMPLE)),
            make_requests(jserve))
        got = run(tserve, tserve.ServingEngine(
            tparams, tcfg, tserve.EngineConfig(num_slots=3, **SAMPLE)),
            make_requests(tserve))
    for r in make_requests(tserve):
        ref = want[r.rid][0]
        scores = perturbed_scores(jparams, jcfg, r.prompt, ref, r.seed,
                                  SAMPLE["temperature"], SAMPLE["top_k"],
                                  None)
        ok, why = greedy_agree(ref, got[r.rid][0], scores)
        assert ok, f"rid {r.rid}: {why}"


def test_sampled_multi_step_decode_carries_the_index():
    """The sampled block advances a lane's index only while it is
    active, and draws what single sampled steps draw."""
    cfg = ttf.TransformerConfig(vocab_size=31, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, max_seq=16)
    params = ttf.init_transformer(torch.Generator().manual_seed(1), cfg)
    from akka_allreduce_tpu_torch.serving.engine import _slot_decode_step
    kd = torch.stack([prng.key(7), prng.key(8)])

    def block(steps, remaining):
        cache = tgen.init_kv_cache(cfg, 2)
        del cache["pos"]
        logits = torch.randn(2, 31, generator=torch.Generator().manual_seed(0))
        return tgen.multi_step_decode(
            params, cache, logits, torch.tensor([2, 4]),
            torch.tensor([False, False]), torch.tensor(remaining),
            torch.tensor([-1, -1]), torch.full((2, 4), -1), steps,
            lambda p, kv, tok, pos, mask: _slot_decode_step(p, kv, tok, pos,
                                                            cfg, mask),
            sample=(0.9, None, None), key_data=kd,
            step_idx=torch.tensor([0, 3]))
    carry, toks = block(4, [2, 9])
    assert carry[-1].tolist() == [2, 7]
    _, toks1 = block(1, [2, 9])
    assert torch.equal(toks[0], toks1[0])
