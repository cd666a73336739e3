"""The port's ``models/mlp.py`` against the JAX package's.

JAX initialises the weights (``init_mlp(key(0), sizes)``);
``convert.params_from_jax`` carries them across, and the same seeded
numpy inputs go through both ``mlp_apply`` and ``mlp_loss`` (rtol 1e-5:
XLA and PyTorch sum the products in other orders), and the loss's
gradients through ``jax.grad`` and autograd. The port's own ``init_mlp``
draws He-scaled weights and zero biases from a ``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import mlp as jmlp
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch import models
from akka_allreduce_tpu_torch.models import mlp as tmlp

SIZES = [12, 32, 24, 5]


@pytest.fixture(scope="module")
def weights():
    jparams = jmlp.init_mlp(jax.random.key(0), SIZES)
    return jparams, convert.params_from_jax(jax.tree.map(np.asarray,
                                                         jparams))


def test_apply_and_loss_match_jax(weights):
    jparams, tparams = weights
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, SIZES[0])).astype(np.float32)
    y = rng.normal(size=(7, SIZES[-1])).astype(np.float32)
    want = np.asarray(jmlp.mlp_apply(jparams, jnp.asarray(x)))
    got = tmlp.mlp_apply(tparams, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jloss, jgrads = jax.value_and_grad(jmlp.mlp_loss)(
        jparams, jnp.asarray(x), jnp.asarray(y))
    leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    loss = tmlp.mlp_loss(leaves, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in leaves:
        np.testing.assert_allclose(leaves[k].grad.numpy(),
                                   np.asarray(jgrads[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_init_mlp_is_he_scaled():
    params = models.init_mlp(torch.Generator().manual_seed(0), [256, 512, 3])
    assert sorted(params) == ["b0", "b1", "w0", "w1"]
    assert params["w0"].shape == (256, 512) and params["b1"].shape == (3,)
    assert not params["b0"].any()
    std = float(params["w0"].std())
    assert abs(std / (2.0 / 256) ** 0.5 - 1) < 0.05
    again = models.init_mlp(torch.Generator().manual_seed(0), [256, 512, 3])
    assert torch.equal(again["w1"], params["w1"])
    assert models.mlp_apply is tmlp.mlp_apply
