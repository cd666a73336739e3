"""The port's offline speculative decoding (``models/speculate.py``)
against the JAX package's.

* ``extend`` over a block equals token-by-token ``decode_step`` (logits
  and written cache at rtol 2e-5, atol 2e-6, the JAX test's tolerance),
  with and without a sliding window, and equals JAX's ``extend``.
* Greedy ``speculative_generate`` emits exactly the port's plain greedy
  ``generate`` for an unrelated draft at k in {1, 2, 4}, for a windowed
  model and for a self-draft (every proposal accepted); with an EOS the
  tokens, padding and length are ``generate(eos_token=)``'s and the loop
  stops early. Its tokens and stats equal JAX's ``speculative_generate``.
* ``speculative_sample`` draws JAX's bits (``models/prng.py``): its
  tokens and stats equal JAX's for the same key over three seeds (the
  perturbed-score rule would allow a part at a near tie; none occurs
  here); top-k 1 is the plain greedy stream; a self-draft accepts every
  proposal; runs are seed-deterministic.
* The JAX function's refusals: batch > 1, k < 1, a vocabulary mismatch,
  max_seq without k of headroom, temperature 0 for sampling.

f32 on the CPU; weights from JAX seeds carried across by ``convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import speculate as jspec
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import generate as tgen
from akka_allreduce_tpu_torch.models import prng
from akka_allreduce_tpu_torch.models import speculate as tspec
from akka_allreduce_tpu_torch.models import transformer as ttf

TMODEL = dict(vocab_size=37, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=64)
DMODEL = dict(vocab_size=37, d_model=16, n_heads=2, n_layers=1, d_ff=32,
              max_seq=64)


def pair(model: dict, seed: int, **extra):
    jcfg = jtf.TransformerConfig(**model, **extra)
    jparams = jtf.init_transformer(jax.random.key(seed), jcfg)
    return (jcfg, jparams, ttf.TransformerConfig(**model, **extra),
            convert.params_from_jax(jax.tree.map(np.asarray, jparams)))


@pytest.fixture(scope="module")
def models():
    return pair(TMODEL, 0), pair(DMODEL, 7)


def prompt(t=5, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 37, size=(1, t),
                                                dtype=np.int32)


@pytest.mark.parametrize("window", [None, 4])
def test_extend_matches_sequential_decode_steps(window):
    jcfg, jparams, cfg, params = pair(TMODEL, 1, attn_window=window)
    pr = torch.from_numpy(prompt(7, 2))
    block = torch.tensor([[3, 17, 8, 25]], dtype=torch.int32)
    cache_a, _ = tgen.prefill(params, tgen.init_kv_cache(cfg, 1), pr, cfg)
    cache_b = {n: (t.clone() if torch.is_tensor(t) else t)
               for n, t in cache_a.items()}
    seq = []
    for j in range(block.shape[1]):
        cache_a, lg = tgen.decode_step(params, cache_a, block[:, j], cfg)
        seq.append(lg)
    cache_b, blk = tspec.extend(params, cache_b, block, cfg)
    assert cache_b["pos"] == cache_a["pos"] == 11
    for j, lg in enumerate(seq):
        torch.testing.assert_close(blk[:, j], lg, rtol=2e-5, atol=2e-6)
    for name in ("k", "v"):
        torch.testing.assert_close(cache_b[name], cache_a[name],
                                   rtol=2e-5, atol=2e-6)
    # and against JAX's extend from the same prefill
    from akka_allreduce_tpu.models.generate import init_kv_cache, prefill
    jc, _ = prefill(jparams, init_kv_cache(jcfg, 1), jnp.asarray(pr.numpy()),
                    jcfg)
    _, jblk = jspec.extend(jparams, jc, jnp.asarray(block.numpy()), jcfg)
    np.testing.assert_allclose(blk.numpy(), np.asarray(jblk), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_independent_draft_emits_plain_greedy_exactly(models, k):
    (jcfg, jt, cfg, target), (jdcfg, jd, dcfg, draft) = models
    pr = prompt()
    ref = tgen.generate(target, torch.from_numpy(pr), cfg, 12)
    got, stats = tspec.speculative_generate(target, draft,
                                            torch.from_numpy(pr), cfg,
                                            dcfg, 12, k=k)
    assert torch.equal(got, ref)
    assert stats["rounds"] >= 1 and stats["drafted"] == stats["rounds"] * k
    assert 0 <= stats["accepted"] <= stats["drafted"]
    jgot, jstats = jspec.speculative_generate(jt, jd, jnp.asarray(pr), jcfg,
                                              jdcfg, 12, k=k)
    assert (np.asarray(jgot) == got.numpy()).all()
    assert {n: int(v) for n, v in jstats.items()} == stats


def test_self_draft_accepts_everything(models):
    (_, _, cfg, target), _ = models
    pr = torch.from_numpy(prompt())
    ref = tgen.generate(target, pr, cfg, 12)
    got, stats = tspec.speculative_generate(target, target, pr, cfg, cfg,
                                            12, k=4)
    assert torch.equal(got, ref)
    assert stats["accepted"] == stats["drafted"]
    assert stats["rounds"] == -(-(12 - 1) // 4)


def test_windowed_model_equivalence():
    _, _, cfg_t, target = pair(TMODEL, 3, attn_window=4)
    _, _, cfg_d, draft = pair(DMODEL, 4, attn_window=4)
    pr = torch.from_numpy(prompt(6, 1))
    ref = tgen.generate(target, pr, cfg_t, 10)
    got, _ = tspec.speculative_generate(target, draft, pr, cfg_t, cfg_d,
                                        10, k=3)
    assert torch.equal(got, ref)


def test_eos_early_termination_matches_generate(models):
    (_, _, cfg, target), _ = models
    pr = torch.from_numpy(prompt())
    base = tgen.generate(target, pr, cfg, 12)[0]
    eos = int(base[2])
    ref, ref_len = tgen.generate(target, pr, cfg, 12, eos_token=eos)
    got, stats = tspec.speculative_generate(target, target, pr, cfg, cfg,
                                            12, k=4, eos_token=eos)
    assert torch.equal(got, ref)
    assert stats["length"] == int(ref_len[0]) == 3
    _, no_eos = tspec.speculative_generate(target, target, pr, cfg, cfg,
                                           12, k=4)
    assert stats["rounds"] < no_eos["rounds"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_sample_matches_jax(models, seed):
    (jcfg, jt, cfg, target), (jdcfg, jd, dcfg, draft) = models
    pr = prompt()
    kw = dict(k=3, temperature=0.8, top_k=20)
    want, wstats = jspec.speculative_sample(jt, jd, jnp.asarray(pr), jcfg,
                                            jdcfg, 16,
                                            key=jax.random.key(seed), **kw)
    got, stats = tspec.speculative_sample(target, draft,
                                          torch.from_numpy(pr), cfg, dcfg,
                                          16, key=prng.key(seed), **kw)
    assert (got.numpy() == np.asarray(want)).all()
    assert stats == {n: int(v) for n, v in wstats.items()}
    again, _ = tspec.speculative_sample(target, draft, torch.from_numpy(pr),
                                        cfg, dcfg, 16, key=prng.key(seed),
                                        **kw)
    assert torch.equal(again, got)


def test_topk1_sampling_equals_greedy(models):
    (_, _, cfg, target), (_, _, dcfg, draft) = models
    pr = torch.from_numpy(prompt())
    ref = tgen.generate(target, pr, cfg, 10)
    got, stats = tspec.speculative_sample(target, draft, pr, cfg, dcfg, 10,
                                          key=prng.key(11), k=3,
                                          temperature=0.7, top_k=1)
    assert torch.equal(got, ref) and stats["rounds"] >= 1


def test_self_draft_accepts_everything_when_sampling(models):
    (_, _, cfg, target), _ = models
    _, stats = tspec.speculative_sample(target, target,
                                        torch.from_numpy(prompt()), cfg,
                                        cfg, 12, key=prng.key(3), k=4,
                                        temperature=1.0)
    assert stats["accepted"] == stats["drafted"]


def test_residual_resample_falls_back_to_p():
    p = torch.tensor([0.2, 0.5, 0.3])
    key = prng.key(0)
    assert int(tspec._residual_resample(p, p, key)) == int(
        prng.categorical(key, torch.log(p)))
    q = torch.tensor([0.2, 0.0, 0.8])  # residual all on token 1
    assert int(tspec._residual_resample(p, q, key)) == 1


def test_refusals(models):
    (_, _, cfg, target), (_, _, dcfg, draft) = models
    pr = torch.from_numpy(prompt())
    with pytest.raises(ValueError, match="batch-1"):
        tspec.speculative_generate(target, draft, pr.repeat(2, 1), cfg,
                                   dcfg, 4)
    with pytest.raises(ValueError, match="k must be"):
        tspec.speculative_generate(target, draft, pr, cfg, dcfg, 4, k=0)
    with pytest.raises(ValueError, match="vocabulary"):
        tspec.speculative_generate(
            target, draft, pr, cfg,
            dataclasses.replace(dcfg, vocab_size=32), 4)
    short = dataclasses.replace(cfg, max_seq=5 + 12 + 3)
    with pytest.raises(ValueError, match="max_seq"):
        tspec.speculative_generate(target, draft, pr, short, dcfg, 12, k=4)
    with pytest.raises(ValueError, match="temperature > 0"):
        tspec.speculative_sample(target, draft, pr, cfg, dcfg, 4,
                                 key=prng.key(0), temperature=0.0)
