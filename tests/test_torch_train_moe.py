"""The MoE and tensor-parallel train step against the JAX package.

The gold test of the JAX ``tests/test_train_moe.py``: the port's sharded
step, on gloo ranks at the meshes ``(tp=2)``, ``(ep=2)``, ``(dp=2,
ep=2)`` and ``(tp=2, ep=2)``, gives the gradients of the JAX package's
unsharded global mean loss (``next_token_loss_and_aux`` on one device,
JAX weights carried over by ``convert.params_from_jax``) within its
bounds, ``rtol 2e-4, atol 2e-5``, gathered to the full layout
(``convert.gather_params``), with ``dispatch_fraction`` 1 and the loss
JAX's; at ep=2 also with two microbatches a rank on the overlapped
schedule (a sync a microbatch, each folded in one tick later). As
there, ``aux_loss_coef`` is 0 (the load-balance statistics are
legitimately shard-local) and capacity generous (nothing dropped). The
model has grouped-query attention (4 heads, 2 KV heads) so the tp split
keeps the GQA groups whole.

The ef8 wire of an MoE model keeps two residual planes, each its own
sync's: at dp=2 the step's dense and expert planes, and its synced
dense and expert gradients, equal those of the dense and the expert
trees synced alone from zero with the keys ``(17, 0, 0)`` and ``(17, 0,
1)``, bitwise; with the keys swapped the sums differ (phase 2 rounds
stochastically; phase 1 rounds to nearest, so the residuals do not see
the key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
from akka_allreduce_tpu_torch.convert import params_to_jax
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

from torch_moe_ranks import ef8_planes_rank, grads_rank

MODEL = dict(vocab_size=61, d_model=32, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=64, max_seq=64, rope=True, moe_every=2)
MOE = dict(n_experts=4, d_ff=64, capacity_factor=8.0, router_k=2,
           aux_loss_coef=0.0)
KW = dict(bucket_elems=256, attn_impl="local")


@pytest.fixture(scope="module")
def jax_reference():
    mcfg = jtf.TransformerConfig(**{**MODEL, "moe": JMoE(**MOE)})
    params = jtf.init_transformer(jax.random.key(0), mcfg)
    tokens = np.random.default_rng(0).integers(0, 61, size=(8, 16),
                                               dtype=np.int32)

    def mean_loss(p):
        ls, w, _ = jtf.next_token_loss_and_aux(p, jnp.asarray(tokens), mcfg)
        return ls / w

    loss, grads = jax.jit(jax.value_and_grad(mean_loss))(params)
    return (jax.tree.map(np.asarray, params), tokens, float(loss),
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, grads))[0])


@pytest.mark.parametrize("world,mesh,accum", [
    (2, dict(tp=2), {}), (2, dict(ep=2), {}), (4, dict(ep=2), {}),
    (4, dict(tp=2, ep=2), {}),
    (2, dict(ep=2), dict(grad_accum=2, accum_schedule="overlap"))],
    ids=["tp2", "ep2", "dp2-ep2", "tp2-ep2", "ep2-overlap2"])
def test_sharded_grads_match_jax_unsharded(jax_reference, world, mesh,
                                           accum):
    params, tokens, loss, ref = jax_reference
    out = spawn_ranks(grads_rank, world, "gloo", "cpu", MODEL, MOE,
                      {**KW, **accum}, params, tokens, **mesh)
    got = jax.tree_util.tree_flatten_with_path(
        params_to_jax(out[0]["grads"]))[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, want), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))
    for r in out:
        assert r["metrics"]["dispatch_fraction"] == 1.0
        np.testing.assert_allclose(r["metrics"]["loss"], loss, rtol=1e-5)
        # every rank gathered the same full gradients
        for a, b in zip(jax.tree.leaves(params_to_jax(r["grads"])),
                        [g for _, g in got]):
            assert np.array_equal(a, b)


def test_ef8_planes_are_each_their_own_syncs(jax_reference):
    params, tokens, _, _ = jax_reference
    out = spawn_ranks(ef8_planes_rank, 2, "gloo", "cpu", MODEL, MOE,
                      dict(KW, grad_transport="ef8"), params, tokens)
    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
    for r in out:
        for plane in ("dense", "expert"):
            grads, residual = r["step"][plane]
            assert same(grads, r["own"][plane][0]), plane
            assert torch.equal(residual, r["own"][plane][1]), plane
            # phase 2 rounds stochastically: the other plane's key moves
            # the sum
            assert not same(grads, r["swapped"][plane][0]), plane
            assert residual.abs().max() > 0
        assert r["step"]["dense"][1].shape != r["step"]["expert"][1].shape


@pytest.mark.parametrize("dp,ep,sp,tp", [(2, 1, 2, 1), (2, 2, 1, 2),
                                         (1, 2, 2, 2), (3, 1, 1, 2)])
def test_rank_layout_is_the_jax_mesh(dp, ep, sp, tp):
    """Global rank r sits where ``np.arange(world).reshape(pp, dp, ep,
    sp, tp)`` puts it (the JAX ``make_device_mesh`` array, tp
    innermost); with ep = tp = 1 that is r = dp_i * sp + sp_j. A
    sub-mesh's ranks run row-major in the axes given."""
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    world = dp * ep * sp * tp
    grid = np.arange(world).reshape(1, dp, ep, sp, tp)
    for r in range(world):
        g = RankGroup(r, world, "gloo", torch.device("cpu"), sp, ep=ep,
                      tp=tp)
        coords = [g.axis_index(a) for a in ("pp", "dp", "ep", "sp", "tp")]
        assert grid[tuple(coords)] == r
        data = g.over(("dp", "sp", "ep"))
        want = grid[0, :, :, :, coords[4]].transpose(0, 2, 1).reshape(-1)
        assert list(data._ranks()) == list(want)
        assert data._global(data.rank) == r
        if tp > 1:  # (a line of one rank is a group of one)
            assert g.along("tp")._ranks() == tuple(
                grid[0, coords[1], coords[2], coords[3]])


def test_three_live_data_axes_refuse_the_hierarchical_schedule():
    """With ep the dense sync spans dp x sp x ep: the hierarchical
    schedule refuses three live data axes in the JAX package's words
    (before any collective runs)."""
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    data = RankGroup(0, 8, "gloo", torch.device("cpu"), 2, ep=2).over(
        ("dp", "sp", "ep"))
    with pytest.raises(ValueError, match=r"hierarchical schedule needs "
                       r"exactly two \(>1\) data axes \(outer = DCN group, "
                       r"inner = ICI axis\); got \['dp', 'sp', 'ep'\] — "
                       r"fold the extra parallelism away"):
        allreduce_gradients({"g": torch.zeros(8)}, GradSyncConfig(
            bucket_elems=4, transport="ef8",
            transport_schedule="hierarchical"), data, quant_key=(17, 0, 0))
