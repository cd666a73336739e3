"""Tensor parallelism (``parallel/tp.py``): the Megatron operators.

A two-layer MLP ``gelu(x @ w1) @ w2`` on two gloo ranks, ``w1`` split by
columns and ``w2`` by rows, with ``tp_grad_boundary`` before the
column-parallel product and ``tp_psum`` after the row-parallel one,
gives the unsharded MLP's output and the gradients of ``sum(y * y)``
for x, w1 and w2 (within 1e-5). The control the JAX docstring names (a
plain sum in both directions) doubles every weight gradient upstream of
the sum (dw1 and dw2 at 2x) and leaves dx a shard's: all three land
outside the bound. On a group of one
(or None) both operators are the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from akka_allreduce_tpu.parallel import tp as jtp
from akka_allreduce_tpu_torch.parallel import tp as ttp
from akka_allreduce_tpu_torch.parallel.group import RankGroup, spawn_ranks

from torch_moe_ranks import tp_mlp_pair

TOL = dict(rtol=1e-5, atol=1e-5)


def test_operators_are_the_identity_on_one_rank():
    x = torch.randn(3, 4, requires_grad=True)
    for group in (None, RankGroup.single()):
        assert ttp.tp_grad_boundary(x, group) is x
        assert ttp.tp_psum(x, group) is x
    w = torch.randn(4, 2)
    assert torch.equal(ttp.row_parallel_dense(x, w, None, bias=w[0]),
                       x @ w + w[0])
    assert torch.equal(ttp.column_parallel_dense(x, w, w[1]), x @ w + w[1])


def test_tp2_mlp_grads_match_unsharded_and_the_doubled_control_does_not():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    w1 = (rng.normal(size=(8, 16)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(16, 8)) * 0.3).astype(np.float32)

    def f(xx, a, b):  # the JAX package's helpers, one rank
        h = jax.nn.gelu(jtp.column_parallel_dense(xx, a))
        y = h @ b
        return jnp.sum(y * y), y

    (_, y_ref), (dx, dw1, dw2) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), jnp.asarray(w1),
                                            jnp.asarray(w2))
    ranks = spawn_ranks(tp_mlp_pair, 2, "gloo", "cpu", w1, w2, x, tp=2)
    for good, _ in ranks:
        np.testing.assert_allclose(good["y"].numpy(), np.asarray(y_ref),
                                   **TOL)
        for name, want in (("dx", dx), ("dw1", dw1), ("dw2", dw2)):
            np.testing.assert_allclose(good[name].numpy(), np.asarray(want),
                                       **TOL, err_msg=name)
    # the control: the same forward, every weight gradient upstream of
    # the sum doubled, and dx wrong (no boundary sums its shards)
    bad = ranks[0][1]
    np.testing.assert_allclose(bad["y"].numpy(), np.asarray(y_ref), **TOL)
    for name, want in (("dx", dx), ("dw1", dw1), ("dw2", dw2)):
        assert not np.allclose(bad[name].numpy(), np.asarray(want), **TOL)
    for name, want in (("dw1", dw1), ("dw2", dw2)):
        np.testing.assert_allclose(bad[name].numpy(), 2 * np.asarray(want),
                                   **TOL)
