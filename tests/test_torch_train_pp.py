"""The pipelined train step against the JAX package.

The gold test of the JAX ``tests/test_train_pp.py`` and
``test_pp_1f1b.py``: the port's pipelined step, on gloo ranks at each
mesh, gives the gradients of the JAX package's unsharded global mean
loss (``next_token_loss_and_aux`` on one device, JAX weights carried
over by ``convert.params_from_jax``), gathered to the full list layout,
within ``rtol 2e-4, atol 2e-5``: gpipe at (pp=2, m=2), (pp=4, m=2),
(dp=2, pp=2, m=2), (pp=2, tp=2, m=4), (pp=2, sp=2, m=2) and MoE at
(pp=2, ep=2, every layer MoE, no load-balance term, capacity that cannot
bind); 1f1b at (dp=2, pp=2), (pp=4), (pp=2, tp=2) and (pp=2, sp=2), m=2.
1f1b's loss and gradients equal gpipe's on the same mesh within 1e-6 of
each leaf's largest; 1f1b in bf16 with remat gives finite gradients
near f32's. The schedules' residency is counted: 1f1b's ring holds at
most ``min(m, 2s - 1)`` stage inputs and one stage graph at a time,
gpipe one graph a valid tick (m; the JAX scan's ``m + s - 1`` counts
the fill and drain ticks, which the port skips). On the ef8 wire at
(dp=2, pp=2) each rank's dense plane has JAX's ``dense_bucket_count``
rows for that mesh, and it and the synced gradients are bitwise those
of the rank's stacked tree synced alone. The refusals carry JAX's
messages; a valid mask and a chunk runner build on a pp group. All the
cases of one world size share one spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch.convert import params_to_jax
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.parallel.group import RankGroup, spawn_ranks

from torch_moe_ranks import make_cfg
from torch_pp_ranks import mesh_cases

MODEL = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq=64)
MOE_MODEL = dict(MODEL, moe_every=1)
MOE = dict(n_experts=4, d_ff=64, capacity_factor=8.0, router_k=2,
           aux_loss_coef=0.0)
KW = dict(bucket_elems=256, attn_impl="local")
# (name, mesh, kw): the gradient cases, each against JAX's unsharded step
GRAD_CASES = [
    ("gpipe-pp4", dict(pp=4), dict(microbatches=2)),
    ("gpipe-dp2-pp2", dict(pp=2), dict(microbatches=2)),
    ("gpipe-pp2-tp2", dict(pp=2, tp=2), dict(microbatches=4)),
    ("gpipe-pp2-sp2", dict(pp=2, sp=2), dict(microbatches=2)),
    ("1f1b-dp2-pp2", dict(pp=2), dict(microbatches=2, pp_schedule="1f1b")),
    ("1f1b-pp4", dict(pp=4), dict(microbatches=2, pp_schedule="1f1b")),
    ("1f1b-pp2-tp2", dict(pp=2, tp=2),
     dict(microbatches=2, pp_schedule="1f1b")),
    ("1f1b-pp2-sp2", dict(pp=2, sp=2),
     dict(microbatches=2, pp_schedule="1f1b")),
]
# 1f1b against gpipe on the same mesh and microbatches
SAME_MESH = [("1f1b-dp2-pp2", "gpipe-dp2-pp2"), ("1f1b-pp4", "gpipe-pp4"),
             ("1f1b-pp2-sp2", "gpipe-pp2-sp2")]
STATS_M = 8  # the residency cases' microbatches: above the ring's 2s - 1


def tokens_of(seed=0):
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], size=(8, 32), dtype=np.int32)


def jax_reference(model, moe, tokens):
    mcfg = jtf.TransformerConfig(
        **{**model, "moe": None if moe is None else JMoE(**moe)})
    params = jtf.init_transformer(jax.random.key(0), mcfg)

    def mean_loss(p):
        ls, w, _ = jtf.next_token_loss_and_aux(p, jnp.asarray(tokens), mcfg)
        return ls / w

    loss, grads = jax.jit(jax.value_and_grad(mean_loss))(params)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, grads))[0])


@pytest.fixture(scope="module")
def dense():
    return jax_reference(MODEL, None, tokens_of())


@pytest.fixture(scope="module")
def ranks4(dense):
    params, _, _ = dense
    tokens = tokens_of()
    moe_params = jax_reference(MOE_MODEL, MOE, tokens)[0]
    cases = [("grads_case", mesh, (MODEL, None, {**KW, **kw}, params,
                                   tokens))
             for _, mesh, kw in GRAD_CASES]
    cases.append(("grads_case", dict(pp=2, ep=2),
                  (MOE_MODEL, MOE, dict(KW, microbatches=2), moe_params,
                   tokens)))
    # bf16 compute with remat under 1f1b, and f32 gpipe beside it
    cases.append(("grads_case", dict(pp=4),
                  (MODEL, None, dict(KW, microbatches=4, pp_schedule="1f1b",
                                     remat=True, compute_dtype="bf16"),
                   params, tokens)))
    cases.append(("ef8_case", dict(pp=2),
                  (MODEL, dict(KW, microbatches=2, grad_transport="ef8"),
                   params, tokens)))
    for sched in ("gpipe", "1f1b"):
        cases.append(("pipeline_stats_case", dict(pp=4),
                      (MODEL, dict(KW, microbatches=STATS_M,
                                   pp_schedule=sched), params,
                       np.tile(tokens, (2, 1)))))
    out = spawn_ranks(mesh_cases, 4, "gloo", "cpu", cases)
    n = len(GRAD_CASES)
    return {"grads": {name: [r[i] for r in out]
                      for i, (name, _, _) in enumerate(GRAD_CASES)},
            "moe": [r[n] for r in out], "bf16": [r[n + 1] for r in out],
            "ef8": [r[n + 2] for r in out],
            "stats": {"gpipe": [r[n + 3] for r in out],
                      "1f1b": [r[n + 4] for r in out]}}


@pytest.fixture(scope="module")
def ranks2(dense):
    params = dense[0]
    return spawn_ranks(mesh_cases, 2, "gloo", "cpu", [
        ("grads_case", dict(pp=2),
         (MODEL, None, dict(KW, microbatches=2), params, tokens_of()))])


def assert_matches_jax(result, ref, loss):
    got = jax.tree_util.tree_flatten_with_path(
        params_to_jax(result["grads"]))[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, want), (_, g) in zip(ref, got):
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(result["metrics"]["loss"], loss, rtol=1e-5)
    assert result["metrics"]["dispatch_fraction"] == 1.0


def test_gpipe_pp2_grads_match_jax_unsharded(dense, ranks2):
    _, loss, ref = dense
    for r in ranks2:  # every rank gathered the full gradients
        assert_matches_jax(r[0], ref, loss)


@pytest.mark.parametrize("name", [c[0] for c in GRAD_CASES])
def test_pipelined_grads_match_jax_unsharded(dense, ranks4, name):
    _, loss, ref = dense
    for r in ranks4["grads"][name]:
        assert_matches_jax(r, ref, loss)


def test_moe_pp2_ep2_grads_match_jax_unsharded(ranks4):
    _, loss, ref = jax_reference(MOE_MODEL, MOE, tokens_of())
    for r in ranks4["moe"]:
        assert_matches_jax(r, ref, loss)


@pytest.mark.parametrize("one_f,gpipe", SAME_MESH)
def test_1f1b_equals_gpipe(ranks4, one_f, gpipe):
    a, b = ranks4["grads"][one_f][0], ranks4["grads"][gpipe][0]
    assert a["metrics"]["loss"] == pytest.approx(b["metrics"]["loss"],
                                                 rel=1e-6)
    for x, y in zip(tree_leaves(a["grads"]), tree_leaves(b["grads"])):
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max())


def test_1f1b_bf16_remat_composes(dense, ranks4):
    _, loss, ref = dense
    for r in ranks4["bf16"]:
        assert np.isfinite(r["metrics"]["loss"])
        assert r["metrics"]["loss"] == pytest.approx(loss, rel=2e-2)
        for (_, want), g in zip(ref, tree_leaves(r["grads"])):
            assert torch.isfinite(g).all()
            assert float((g.numpy() - want).__abs__().max()) <= 0.1 * max(
                float(np.abs(want).max()), 1e-3)


def test_schedule_residency(ranks4):
    s, m = 4, STATS_M
    for r in ranks4["stats"]["1f1b"]:
        assert r["ring_depth"] == min(m, 2 * s - 1)
        assert r["peak_inputs"] <= min(m, 2 * s - 1)
        assert r["peak_graphs"] == 1
    assert ranks4["stats"]["1f1b"][0]["peak_inputs"] == 2 * s - 1
    for r in ranks4["stats"]["gpipe"]:
        assert r["gpipe_peak_graphs"] == m <= m + s - 1


def test_ef8_planes_at_dp2_pp2_are_jax_geometry(ranks4):
    mesh = make_device_mesh(MeshSpec(dp=2, pp=2),
                            devices=jax.devices()[:4])
    jcfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                              bucket_elems=256, microbatches=2)
    jparams, _, _ = jtrain.make_train_state(jax.random.key(0), jcfg, mesh)
    rows = jtrain.dense_bucket_count(jcfg, mesh, jparams)
    for r in ranks4["ef8"]:
        assert r["rows"] == rows
        assert r["same_grads"] and r["same_residual"]
        assert r["residual_max"] > 0


REFUSALS = [
    # (port kw, port mesh, JAX kw, JAX mesh, the message both give)
    (dict(pp_schedule="1f1b"), dict(pp=2, ep=2, dp=2), "moe",
     "dense layers only"),
    (dict(pp_schedule="zigzag"), dict(pp=2, dp=4), "dense",
     "pp_schedule"),
    (dict(grad_accum=2), dict(pp=2, dp=4), "dense",
     "grad_accum > 1 does not compose with pp > 1"),
    (dict(), dict(pp=2, dp=4), "moe2", "homogeneous layers"),
]


@pytest.mark.parametrize("kw,mesh,model,match", REFUSALS,
                         ids=["moe-1f1b", "schedule", "grad-accum",
                              "moe-every"])
def test_refusals_carry_jax_messages(kw, mesh, model, match):
    moe = None if model == "dense" else MOE
    mdl = dict(MODEL, moe_every=2 if model == "moe2" else 1)
    cfg = make_cfg(mdl, moe, **{**KW, "microbatches": 2, **kw})
    world = int(np.prod(list(mesh.values())))
    group = RankGroup(0, world, "gloo", torch.device("cpu"),
                      ep=mesh.get("ep", 1), pp=mesh["pp"])
    with pytest.raises(ValueError, match=match):
        train.make_grad_step(cfg, group)
    jmcfg = jtf.TransformerConfig(
        **{**mdl, "moe": None if moe is None else JMoE(**moe)})
    jcfg = jtrain.TrainConfig(model=jmcfg, bucket_elems=256,
                              microbatches=2, **kw)
    jmesh = make_device_mesh(MeshSpec(**mesh), devices=jax.devices()[:world])
    with pytest.raises(ValueError, match=match):
        jtrain.make_grad_step(jcfg, jmesh)


def test_deadline_mask_and_graph_chunks_build_on_pp():
    """A per-round valid mask and a multi-step chunk runner build on a pp
    group (the JAX ``make_grad_step(dynamic_valid=True)`` and
    ``make_multi_step`` take any mesh): the mask's rows are the data
    ranks, its columns the stage's stacked tree's buckets."""
    cfg = make_cfg(MODEL, None, **KW, microbatches=2)
    group = RankGroup(0, 4, "gloo", torch.device("cpu"), pp=2)
    step = train.make_grad_step(cfg, group, dynamic_valid=True)
    assert callable(step)
    multi = train.make_multi_step(cfg, 2, group)
    assert multi.n == 2 and multi.replays == 0
    assert train.data_rank_count(cfg, group) == 2
    from akka_allreduce_tpu_torch.convert import shard_params
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    stage = shard_params(init_transformer(torch.Generator().manual_seed(0),
                                          cfg.model), cfg.model, group)
    assert isinstance(stage["layers"], dict)
    mesh = make_device_mesh(MeshSpec(dp=2, pp=2),
                            devices=jax.devices()[:4])
    jcfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                              bucket_elems=256, microbatches=2)
    jparams, _, _ = jtrain.make_train_state(jax.random.key(0), jcfg, mesh)
    assert train.dense_bucket_count(cfg, stage) == \
        jtrain.dense_bucket_count(jcfg, mesh, jparams)
