"""The port's transformer against the JAX package's, on the same weights.

JAX initialises the weights; ``convert.params_from_jax`` carries them
into the port unchanged. The same numpy tokens then go through both
packages' full forward, prefill and one cached decode step. f32 on the
CPU; atol = rtol = 1e-4 (summation order differs between XLA and
PyTorch). TF32 is off for CUDA matmuls (``allow_tf32 = False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import generate as jgen
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import generate as tgen
from akka_allreduce_tpu_torch.models import transformer as ttf

torch.backends.cuda.matmul.allow_tf32 = False

# the DENSE family of tests/test_paged_engine.py: GQA + rope (gelu), the
# MHA gelu variant without rope, and the Llama-style swiglu variant
CONFIGS = {
    "gqa_rope": dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=32, rope=True),
    "mha_gelu": dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2,
                     d_ff=128, max_seq=32),
    "gqa_swiglu": dict(vocab_size=61, d_model=64, n_heads=4, n_kv_heads=2,
                       n_layers=2, d_ff=128, max_seq=32, rope=True,
                       ffn="swiglu"),
}
TOL = dict(atol=1e-4, rtol=1e-4)


def models(name: str, seed: int = 0):
    jcfg = jtf.TransformerConfig(**CONFIGS[name])
    tcfg = ttf.TransformerConfig(**CONFIGS[name])
    jparams = jtf.init_transformer(jax.random.key(seed), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def tokens(cfg, b: int, t: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_full_forward_logits_match(name):
    jcfg, jparams, tcfg, tparams = models(name)
    toks = tokens(jcfg, 2, 12, seed=1)
    want = np.asarray(jtf.transformer_apply(jparams, jnp.asarray(toks),
                                            jcfg))
    got = ttf.transformer_apply(tparams, torch.from_numpy(toks).long(),
                                tcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_step_logits_match(name):
    jcfg, jparams, tcfg, tparams = models(name, seed=3)
    prompt = tokens(jcfg, 2, 9, seed=2)
    jcache = jgen.init_kv_cache(jcfg, 2)
    jcache, jlogits = jgen.prefill(jparams, jcache, jnp.asarray(prompt),
                                   jcfg)
    tcache = tgen.init_kv_cache(tcfg, 2)
    tcache, tlogits = tgen.prefill(tparams, tcache,
                                   torch.from_numpy(prompt).long(), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    assert tcache["pos"] == int(jcache["pos"])

    nxt = np.array(jnp.argmax(jlogits, axis=-1), np.int32)
    jcache, jstep = jgen.decode_step(jparams, jcache, jnp.asarray(nxt), jcfg)
    tcache, tstep = tgen.decode_step(tparams, tcache, torch.from_numpy(nxt),
                                     tcfg)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    positions = np.array([0, 3, 7, 11, 30], np.int32)
    np.testing.assert_allclose(
        ttf.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jtf.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    np.testing.assert_allclose(
        ttf.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                       500.0).numpy(),
        np.asarray(jtf.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                  500.0)), **TOL)


def test_convert_round_trip_keeps_every_leaf():
    _, jparams, _, tparams = models("gqa_rope", seed=5)
    back = convert.params_to_jax(tparams)
    flat_j, tree_j = jax.tree.flatten(jparams)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tparams["layers"][0]["wq"].shape == (64, 64)  # used as h @ wq


def test_convert_keeps_bfloat16_bits():
    x = jnp.asarray(np.random.default_rng(6).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = convert.params_from_jax({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))
    back = convert.params_to_jax({"w": t})["w"]
    np.testing.assert_array_equal(np.asarray(back, np.float32),
                                  np.asarray(x, np.float32))


def test_config_validation_and_moe_refusal():
    """MoE configs are ported: accepted, every moe_every-th layer routed;
    what stays refused is an ep that does not divide the experts and a tp
    that does not divide the heads."""
    from akka_allreduce_tpu_torch.parallel.ep import MoEConfig, \
        init_moe_layer
    cfg = ttf.TransformerConfig(n_layers=4, moe=MoEConfig(n_experts=4),
                                moe_every=2)
    assert [cfg.is_moe_layer(i) for i in range(4)] == [False, True,
                                                       False, True]
    with pytest.raises(ValueError, match="must divide n_experts"):
        init_moe_layer(torch.Generator().manual_seed(0), 8,
                       MoEConfig(n_experts=4), ep=3)
    with pytest.raises(ValueError, match="tp=3 must divide"):
        ttf.init_transformer(torch.Generator().manual_seed(0), cfg, tp=3)
    with pytest.raises(ValueError):
        ttf.TransformerConfig(n_heads=4, n_kv_heads=3)
    with pytest.raises(ValueError):
        ttf.TransformerConfig(ffn="relu")
