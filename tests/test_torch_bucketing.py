"""Gradient bucketing: the port's bucket matrix equals the JAX package's.

The same transformer parameters (JAX-initialised, carried across by
``convert.params_from_jax``) flatten in the JAX pytree's leaf order into
a bitwise-equal ``(num_buckets, bucket_elems)`` matrix; the geometry,
the round trip, the count expansion and the divide-by-count rescale
match too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu import config as jconfig
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.ops import bucketing as jb
from akka_allreduce_tpu.ops import masked as jm
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.ops import bucketing as tb
from akka_allreduce_tpu_torch.ops import masked as tm

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=16, rope=True)


@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_transformer(jax.random.key(7),
                                   jtf.TransformerConfig(**MODEL))
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray,
                                                         jparams))


@pytest.mark.parametrize("bucket_elems", [256, 1000, 1 << 16])
def test_bucket_matrix_is_bitwise_jax(params, bucket_elems):
    jparams, tparams = params
    jmat, jspec = jb.bucketize(jparams, bucket_elems)
    tmat, tspec = tb.bucketize(tparams, bucket_elems)
    assert tmat.shape == jmat.shape and tmat.dtype == torch.float32
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    assert (tspec.num_buckets, tspec.total_size, tspec.pad) == (
        jspec.num_buckets, jspec.total_size, jspec.pad)
    assert tspec.shapes == jspec.shapes and tspec.sizes == jspec.sizes
    assert tb.tree_bucket_spec(tparams, bucket_elems).num_buckets == \
        jb.tree_bucket_spec(jparams, bucket_elems).num_buckets


def test_round_trip_restores_shapes_and_dtypes(params):
    _, tparams = params
    tree = {"w": tparams["embed"], "n": [torch.arange(5, dtype=torch.int32),
                                         torch.ones(2, 3)]}
    mat, spec = tb.bucketize(tree, 7)
    assert mat.shape == (spec.num_buckets, 7) and spec.pad >= 0
    back = tb.debucketize(mat, spec)
    assert back["n"][0].dtype == torch.int32
    for got, want in zip(tb.tree_leaves(back), tb.tree_leaves(tree)):
        assert torch.equal(got, want)
    assert torch.equal(tb.tree_to_vector(tree),
                       mat.reshape(-1)[:spec.total_size])
    assert not mat.reshape(-1)[spec.total_size:].any()  # the zero pad


@pytest.mark.parametrize("size,chunk", [(0, 4), (10, 4), (12, 4), (1, 5)])
def test_num_chunks_matches_jax(size, chunk):
    assert tb.num_chunks(size, chunk) == jconfig.num_chunks(size, chunk)


def test_count_expansion_and_rescale_match_jax(params):
    jparams, tparams = params
    _, jspec = jb.bucketize(jparams, 1000)
    _, tspec = tb.bucketize(tparams, 1000)
    counts = np.arange(jspec.num_buckets, dtype=np.int32) % 3
    want = jm.expand_bucket_counts(jnp.asarray(counts), jspec)
    got = tm.expand_bucket_counts(torch.from_numpy(counts), tspec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    summed = np.random.default_rng(0).normal(
        size=got.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tm.rescale_by_count(torch.from_numpy(summed), got, 3.0).numpy(),
        np.asarray(jm.rescale_by_count(jnp.asarray(summed), want, 3.0)))


@pytest.mark.parametrize("rebuild", ["tree_unflatten", "vector_to_tree"])
def test_rebuilt_tree_frees_its_leaves_without_the_gc(rebuild):
    """The synced gradient tree's leaves are views of one bucket matrix;
    once the tree is dropped the matrix must go at once (reference
    counting), not wait for a cyclic collection while the next step's
    activations grow on top of it."""
    import gc
    import weakref
    tree = {"b": [torch.zeros(3), torch.zeros(2, 2)], "a": torch.zeros(5)}
    vec = torch.arange(12, dtype=torch.float32)
    spec = tb.tree_bucket_spec(tree, 4)
    gc.disable()
    try:
        if rebuild == "tree_unflatten":
            out = tb.tree_unflatten(tree, [vec[:5], vec[5:9].view(2, 2),
                                           vec[9:12]])
        else:
            out = tb.vector_to_tree(vec, spec)
        assert torch.equal(out["a"], vec[:5])
        alive = weakref.ref(out["a"])
        del out
        assert alive() is None
    finally:
        gc.enable()
