"""The overlapped accumulation schedule (``accum_schedule="overlap"``)
against the deferred one and against the JAX package's.

Each microbatch's gradients are synced as produced and folded in one
tick later; the sum of the K syncs equals the deferred path's one sync of
the summed gradients up to f32 summation order. Two gloo ranks on the
CPU (one spawn for every case) hold, at JAX tests/test_accum_overlap.py's
bounds: the synced gradients against the deferred schedule's and against
JAX's overlap on a dp=2 virtual mesh (rtol 1e-5, atol 1e-7), the same
with the windowed schedule, a 5-step loss trajectory against deferred
(rtol 1e-5, atol 1e-6; step 0's loss bitwise, computed before any
update), and the masked counts of a dynamic ``valid`` round. One rank:
the schedules are bitwise equal (no sync to reorder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

MODEL = dict(vocab_size=41, d_model=32, n_heads=4, n_layers=1, d_ff=64,
             max_seq=16)
BASE = dict(bucket_elems=256, grad_accum=4)


def tokens(seed=3, b=8, t=16):
    return np.random.default_rng(seed).integers(0, 41, size=(b, t),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's weights (dp=2 mesh) and its overlapped synced grads."""
    mesh = make_device_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    cfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                             grad_axes=("dp",), accum_schedule="overlap",
                             **BASE)
    params, _, _ = jtrain.make_train_state(jax.random.key(0), cfg, mesh)
    grads, metrics = jax.jit(jtrain.make_grad_step(cfg, mesh))(
        params, jnp.asarray(tokens()), 7)
    leaves = ttrain.tree_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, grads)))
    return (convert.params_from_jax(jax.tree.map(np.asarray, params)),
            [g.numpy() for g in leaves], float(metrics["loss"]))


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Rank 0's results of every case, from one spawn of two ranks."""
    params = jax_side[0]
    nb = ttrain.dense_bucket_count(
        ttrain.TrainConfig(model=ttrain.TransformerConfig(**MODEL), **BASE),
        params)
    valid = np.ones((2, nb), np.float32)
    valid[1, 0] = 0.0  # rank 1 misses bucket 0 this round
    cases = [(dict(BASE), None),
             (dict(BASE, accum_schedule="overlap"), None),
             (dict(BASE, accum_schedule="overlap",
                   transport_schedule="windowed", num_windows=2), None),
             (dict(BASE), valid),
             (dict(BASE, accum_schedule="overlap"), valid)]
    batches = [tokens(i) for i in range(5)]
    runs = [dict(BASE, learning_rate=1e-2),
            dict(BASE, learning_rate=1e-2, accum_schedule="overlap")]
    import torch_accum_ranks
    out = spawn_ranks(torch_accum_ranks.overlap_cases, 2, "gloo", "cpu",
                      params, MODEL, tokens(), cases, batches, runs)
    return out[0]


def close(got: list, want: list) -> None:
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_synced_grads_match_deferred(ranks):
    (deferred, md), (overlap, mo) = ranks[0][0], ranks[0][1]
    assert mo["loss"] == pytest.approx(md["loss"], rel=1e-6)
    assert mo["min_bucket_count"] == md["min_bucket_count"] == 2
    close(overlap, deferred)


def test_overlap_matches_jax_overlap(jax_side, ranks):
    _, want, loss = jax_side
    got, metrics = ranks[0][1]
    assert metrics["loss"] == pytest.approx(loss, rel=1e-5)
    close(got, want)


def test_composes_with_windowed_transport(ranks):
    close(ranks[0][2][0], ranks[0][0][0])


def test_losses_match_deferred_step_for_step(ranks):
    deferred, overlap = ranks[1]
    assert overlap[0] == deferred[0]  # before any update: bitwise
    np.testing.assert_allclose(overlap, deferred, rtol=1e-5, atol=1e-6)


def test_masked_overlap_counts_honest(ranks):
    (_, md), (grads, mo) = ranks[0][3], ranks[0][4]
    assert md["min_bucket_count"] == mo["min_bucket_count"] == 1
    assert all(np.isfinite(g).all() for g in grads)
    close(grads, ranks[0][3][0])


def test_one_rank_overlap_is_deferred_bitwise(jax_side):
    params = jax_side[0]
    got = []
    for sched in ("deferred", "overlap"):
        cfg = ttrain.TrainConfig(model=ttrain.TransformerConfig(**MODEL),
                                 accum_schedule=sched, **BASE)
        state = ttrain.make_train_state(cfg, params=ttrain.tree_map(
            lambda p: p.detach().clone(), params))
        grads, _ = ttrain.make_grad_step(cfg)(state.params,
                                              torch.from_numpy(tokens()))
        got.append(ttrain.tree_leaves(grads))
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_unknown_schedule_rejected():
    cfg = ttrain.TrainConfig(model=ttrain.TransformerConfig(**MODEL),
                             accum_schedule="eager", **BASE)
    with pytest.raises(ValueError, match="accum_schedule"):
        ttrain.make_grad_step(cfg)
