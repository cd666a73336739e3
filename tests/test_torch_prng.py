"""The port's threefry (``models/prng.py``) against ``jax.random``.

The sampled decode paths can only be held to JAX token for token if the
port draws the same bits from the same keys. So every integer the port
draws is held bitwise: ``key``, ``fold_in``, ``split`` and ``bits``
(threefry2x32 with ``jax_threefry_partitionable=True``, jax 0.9.0's
default), and the floats built from those bits by bit manipulation,
``uniform`` in f32, bf16 and f16. ``gumbel``'s two logs are XLA's and
torch's, which may part by an ulp: held with ``allclose`` at rtol 1e-6
and atol 1e-6 (an ulp of the inner log near the outer log's zero is
~1e-7 absolute). ``categorical`` is held bitwise on these draws. A batch
of keys draws in one pass what a loop over the keys draws one by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.models import prng

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]
SHAPES = [(3,), (2, 5), (1, 97), (4, 3, 2), (1, 256)]


def jwords(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_threefry_partitionable_is_jax_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [-1, -5, 2**32 + 3])
def test_key_words(seed):
    assert (prng.key(seed).numpy() == jwords(jax.random.key(seed))).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 1000, 2**31 + 5])
def test_fold_in_bitwise(seed, data):
    want = jwords(jax.random.fold_in(jax.random.key(seed), data))
    assert (prng.fold_in(prng.key(seed), data).numpy() == want).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 4, 5])
def test_split_bitwise(seed, num):
    want = jwords(jax.random.split(jax.random.key(seed), num))
    assert (prng.split(prng.key(seed), num).numpy() == want).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_bitwise(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape))
    got = prng.bits(prng.key(seed), shape).numpy()
    assert got.shape == want.shape
    assert (got == want.astype(np.int64)).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_uniform_bitwise(seed, shape, dtype):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         getattr(jnp, dtype)))
    got = prng.uniform(prng.key(seed), shape, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert (got.float().numpy() == want.astype(np.float32)).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_allclose(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
    got = prng.gumbel(prng.key(seed), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(50,), (3, 50), (1, 97)])
def test_categorical_bitwise(seed, shape):
    logits = np.random.default_rng(seed % 997).normal(
        size=shape).astype(np.float32)
    want = np.asarray(jax.random.categorical(jax.random.key(seed), logits))
    got = prng.categorical(prng.key(seed), torch.from_numpy(logits))
    assert (got.numpy() == want).all()


def test_a_batch_of_keys_is_one_pass_over_the_same_draws():
    """fold_in over a (lanes,) index vector, then a (1, vocab) draw per
    lane, equals the per-key draws: the engines' one-pass sampling."""
    base = prng.wrap_key_data(np.stack([prng.key(s).numpy()
                                        for s in (3, 9, 27)]))
    idx = torch.tensor([0, 5, 11])
    keys = prng.fold_in(base, idx)
    logits = torch.randn(3, 1, 61, generator=torch.Generator().manual_seed(0))
    batched = prng.categorical(keys, logits)
    for i in range(3):
        one = prng.fold_in(base[i], int(idx[i]))
        assert torch.equal(keys[i], one)
        assert torch.equal(batched[i], prng.categorical(one, logits[i]))
        jkey = jax.random.fold_in(jax.random.key((3, 9, 27)[i]),
                                  int(idx[i]))
        assert int(batched[i, 0]) == int(jax.random.categorical(
            jkey, logits[i].numpy())[0])
    assert torch.equal(prng.bits(keys, (2, 4))[1], prng.bits(keys[1], (2, 4)))


def test_words_stay_uint32_and_wrap_key_data_masks():
    k = prng.wrap_key_data(np.array([-1, 2**32 + 7]))
    assert k.tolist() == [2**32 - 1, 7]
    draws = prng.bits(prng.split(prng.key(5), 8), (64,))
    assert int(draws.min()) >= 0 and int(draws.max()) < 2**32
