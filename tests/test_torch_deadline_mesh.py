"""Deadline masks on tp / ep / pp meshes against the JAX package.

JAX ``make_grad_step(cfg, mesh, dynamic_valid=True)`` takes a per-round
``(n_data_ranks, num_buckets)`` mask on any mesh, sharded ``P(dense_axes,
None)``: every tp shard and pp stage of a data rank reads that rank's
row, the dense sync consumes it (after the pp sum of the non-layer
gradients), and the expert sync stays exact. The port's step, on gloo
ranks at each mesh from the JAX weights and batch, gives the gradients
of JAX's step on the same mesh and mask, gathered to the full list
layout, within ``rtol 2e-4, atol 2e-5``, and JAX's ``min_bucket_count``
and loss: at (dp=2, tp=2), (ep=2) MoE, (dp=2, ep=2) MoE, (dp=2, pp=2)
under gpipe and 1f1b and (pp=2, ep=2) MoE at ``moe_every=1`` under
gpipe, each unmasked and with data rank 1 masked (a whole data rank).
The bucket and data-rank counts are JAX's ``dense_bucket_count`` /
``data_rank_count`` at that mesh (the rank's shard or stage).

On the ef8 wire at (dp=2, ep=2) MoE both syncs are real: the masked
round's expert gradients and expert plane are bitwise the unmasked
round's, and the masked rank's dense plane comes back unchanged. The
hierarchical schedule's ICI line is the dense group's last live axis
(``mask_line``; ROADMAP C11): at (dp=2, ep=2) a late data rank masks its
whole ep line, and the round's count is JAX's for that mask. The JAX
package's ef8 rounding bits are its own, so the ef8 cases are held to
the masked-row contract and JAX's counts, not to JAX's values.
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
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.parallel.group import RankGroup, spawn_ranks

from torch_mesh_ranks import mesh_cases
from torch_moe_ranks import make_cfg

MODEL = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq=64)
MOE = dict(n_experts=4, d_ff=64, capacity_factor=8.0, router_k=2,
           aux_loss_coef=0.0)
KW = dict(bucket_elems=256, attn_impl="local")
# (name, mesh, model, moe, kw): the masked grad-step cases
CASES = [
    ("dp2-tp2", dict(dp=2, tp=2), MODEL, None, {}),
    ("ep2-moe", dict(ep=2), dict(MODEL, moe_every=2), MOE, {}),
    ("dp2-ep2-moe", dict(dp=2, ep=2), dict(MODEL, moe_every=2), MOE, {}),
    ("dp2-pp2-gpipe", dict(dp=2, pp=2), MODEL, None,
     dict(microbatches=2)),
    ("dp2-pp2-1f1b", dict(dp=2, pp=2), MODEL, None,
     dict(microbatches=2, pp_schedule="1f1b")),
    ("pp2-ep2-moe-gpipe", dict(pp=2, ep=2), dict(MODEL, moe_every=1), MOE,
     dict(microbatches=2)),
]


def tokens_of(seed=0):
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], size=(8, 32), dtype=np.int32)


def jax_setup(mesh, model, moe, kw, **extra):
    spec = MeshSpec(**mesh)
    jmesh = make_device_mesh(spec, devices=jax.devices()[:spec.size])
    jcfg = jtrain.TrainConfig(
        model=jtf.TransformerConfig(
            **{**model, "moe": None if moe is None else JMoE(**moe)}),
        **{**KW, **kw, **extra})
    params, _, _ = jtrain.make_train_state(jax.random.key(0), jcfg, jmesh)
    return jcfg, jmesh, params


def masks_for(n_data, nb):
    """Every data rank valid, and data rank 1 masked."""
    ones = np.ones((n_data, nb), np.float32)
    masked = ones.copy()
    masked[1] = 0.0
    return [ones, masked]


def port_leaves(grads_np):
    """A JAX gradient tree (numpy; a pp run's layers stacked) as the
    port's full list-layout leaves."""
    if isinstance(grads_np["layers"], dict):
        grads_np = convert.unstack_jax_items({"params": grads_np})["params"]
    return tree_leaves(convert.params_from_jax(grads_np))


def mesh_of(mesh):
    """The port's ``mesh_cases`` mesh (dp the rest of the world)."""
    return {k: v for k, v in mesh.items() if k != "dp"}


@pytest.fixture(scope="module")
def jax_cases():
    """Per case: JAX's weights (numpy), counts, and for each mask its
    gradients (port layout), ``min_bucket_count`` and loss."""
    tokens = tokens_of()
    out = {}
    for name, mesh, model, moe, kw in CASES:
        jcfg, jmesh, params = jax_setup(mesh, model, moe, kw)
        nb = jtrain.dense_bucket_count(jcfg, jmesh, params)
        n_data = jtrain.data_rank_count(jcfg, jmesh)
        step = jax.jit(jtrain.make_grad_step(jcfg, jmesh,
                                             dynamic_valid=True))
        runs = []
        for m in masks_for(n_data, nb):
            grads, metrics = step(params, jnp.asarray(tokens), valid=m)
            runs.append((port_leaves(jax.tree.map(np.asarray, grads)),
                         int(metrics["min_bucket_count"]),
                         float(metrics["loss"])))
        out[name] = {"params": jax.tree.map(np.asarray, params), "nb": nb,
                     "n_data": n_data, "masks": masks_for(n_data, nb),
                     "runs": runs}
    return out


def ef8_planes(rng, n_ranks, nb_dense, nb_expert):
    return [{"dense": rng.normal(size=(nb_dense, 256)).astype(np.float32)
             * 1e-2,
             "expert": rng.normal(size=(nb_expert, 256)).astype(np.float32)
             * 1e-2} for _ in range(n_ranks)]


@pytest.fixture(scope="module")
def port_cases(jax_cases):
    """Every case on the port's gloo ranks: one spawn at two ranks and
    one at four (the ef8 and hierarchical cases at (dp=2, ep=2) in it)."""
    tokens = tokens_of()
    by_world: dict = {}
    for name, mesh, model, moe, kw in CASES:
        world = int(np.prod(list(mesh.values())))
        j = jax_cases[name]
        by_world.setdefault(world, []).append(
            (name, ("masked_case", mesh_of(mesh),
                    (model, moe, {**KW, **kw}, j["params"], tokens,
                     j["masks"]))))
    ep = jax_cases["dp2-ep2-moe"]
    moe_model = dict(MODEL, moe_every=2)
    n_expert = ef8_expert_buckets()
    resid = ef8_planes(np.random.default_rng(1), 4, ep["nb"], n_expert)
    by_world[4].append(("ef8", ("masked_case", dict(ep=2), (
        moe_model, MOE, {**KW, "grad_transport": "ef8"}, ep["params"],
        tokens, ep["masks"], resid))))
    by_world[4].append(("hierarchical", ("deadline_case", dict(ep=2), (
        moe_model, MOE, {**KW, "grad_transport": "ef8",
                         "transport_schedule": "hierarchical"},
        ep["params"], tokens, [1]))))
    out = {}
    for world, named in by_world.items():
        got = spawn_ranks(mesh_cases, world, "gloo", "cpu",
                          [case for _, case in named])
        for k, (name, _) in enumerate(named):
            out[name] = [r[k] for r in got]
    out["resid"] = resid
    return out


def ef8_expert_buckets():
    cfg = make_cfg(dict(MODEL, moe_every=2), MOE, **KW)
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    full = init_transformer(torch.Generator().manual_seed(0), cfg.model)
    group = RankGroup(0, 4, "gloo", torch.device("cpu"), ep=2)
    return train.expert_bucket_count(cfg, convert.shard_params(
        full, cfg.model, group))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_masked_steps_match_jax_on_the_mesh(jax_cases, port_cases, name):
    j = jax_cases[name]
    for rank in port_cases[name]:
        assert rank["n_data"] == j["n_data"]
        assert rank["dense_buckets"] == j["nb"]
        for (want, count, loss), got in zip(j["runs"], rank["steps"]):
            assert got["min_bucket_count"] == count
            np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
            leaves = tree_leaves(got["grads"])
            assert len(leaves) == len(want)
            for g, w in zip(leaves, want):
                np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                           atol=2e-5)
    # a masked data rank moved the gradients (the masked round is not
    # the unmasked one)
    a, b = (tree_leaves(s["grads"]) for s in port_cases[name][0]["steps"])
    assert any(not torch.equal(x, y) for x, y in zip(a, b))


def test_every_model_rank_of_a_data_rank_sends_its_row(port_cases):
    """tp shards and pp stages share their data rank's row: the data
    rank is the rank's place in the (dp, sp, ep) sub-mesh."""
    for name, want in (("dp2-tp2", [0, 0, 1, 1]),
                       ("dp2-pp2-gpipe", [0, 1, 0, 1]),
                       ("pp2-ep2-moe-gpipe", [0, 1, 0, 1]),
                       ("dp2-ep2-moe", [0, 1, 2, 3])):
        assert [r["data_rank"] for r in port_cases[name]] == want


def test_ef8_expert_plane_is_exact_and_a_masked_rows_plane_carries(
        jax_cases, port_cases):
    """(dp=2, ep=2) MoE on ef8: the masked round's expert gradients and
    expert plane are bitwise the unmasked round's (the expert sync takes
    no mask); data rank 1's dense plane comes back as it went in, the
    other ranks' change."""
    for rank, start in zip(port_cases["ef8"], port_cases["resid"]):
        unmasked, masked = rank["steps"]
        assert all(torch.equal(a, b) for a, b in zip(
            unmasked["local_expert"], masked["local_expert"]))
        assert torch.equal(unmasked["residual"]["expert"],
                           masked["residual"]["expert"])
        assert not torch.equal(masked["residual"]["expert"],
                               torch.from_numpy(start["expert"]))
        dense = masked["residual"]["dense"]
        if rank["data_rank"] == 1:
            assert torch.equal(dense, torch.from_numpy(start["dense"]))
        else:
            assert not torch.equal(dense, torch.from_numpy(start["dense"]))
        # the counts do not depend on the wire: JAX's f32 runs'
        assert [unmasked["min_bucket_count"], masked["min_bucket_count"]] \
            == [c for _, c, _ in jax_cases["dp2-ep2-moe"]["runs"]]


def test_hierarchical_late_rank_masks_its_whole_ep_line(jax_cases,
                                                        port_cases):
    """(dp=2, ep=2) ef8 hierarchical: the ICI leg runs on ep, the dense
    group's last live axis, so ``mask_line`` is 2 and data rank 1 late
    masks data ranks 0 and 1 (its ep line); the round's count is JAX's
    for that mask and its loss JAX's."""
    ep = jax_cases["dp2-ep2-moe"]
    jcfg, jmesh, params = jax_setup(
        dict(dp=2, ep=2), dict(MODEL, moe_every=2), MOE,
        {"grad_transport": "ef8", "transport_schedule": "hierarchical"})
    mask = np.ones((4, ep["nb"]), np.float32)
    mask[:2] = 0.0
    ef = jtrain.init_ef_state(jcfg, jmesh, params)
    step = jax.jit(jtrain.make_grad_step(jcfg, jmesh, dynamic_valid=True))
    _, metrics, _ = step(params, jnp.asarray(tokens_of()), quant_seed=0,
                         valid=mask, ef_state=ef)
    for rank in port_cases["hierarchical"]:
        assert rank["line"] == 2
        assert (rank["n_masked"], rank["n_dropped"], rank["fell_back"]) \
            == (1, 2, False)
        np.testing.assert_array_equal(rank["mask"], mask)
        assert rank["min_bucket_count"] == int(
            metrics["min_bucket_count"]) == 2
        np.testing.assert_allclose(rank["loss"], float(metrics["loss"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("mesh,line", [
    (dict(dp=2, ep=2), 2), (dict(sp=2, ep=2), 2), (dict(dp=2, sp=2), 2),
    (dict(dp=4, ep=2), 2), (dict(dp=2, tp=2), 1), (dict(pp=2, ep=2), 1)],
    ids=["dp2-ep2", "sp2-ep2", "dp2-sp2", "dp4-ep2", "dp2-tp2", "pp2-ep2"])
def test_mask_line_is_the_dense_groups_last_live_axis(mesh, line):
    """``mask_line`` on ef8 hierarchical: the size of the last live axis
    of the (dp, sp, ep) group, the axis ``parallel/dp.py`` runs the
    exact ICI leg on, when two are live; 1 with one live axis. At (sp=2,
    ep=2) the old rule (the sp size when dp > 1, else 1) gave 1: half an
    ICI line masked."""
    world = int(np.prod(list(mesh.values())))
    group = RankGroup(0, world, "gloo", torch.device("cpu"),
                      mesh.get("sp", 1), ep=mesh.get("ep", 1),
                      tp=mesh.get("tp", 1), pp=mesh.get("pp", 1))
    moe = MOE if "ep" in mesh else None
    cfg = make_cfg(MODEL, moe, grad_transport="ef8",
                   transport_schedule="hierarchical", **KW)
    dense, _ = train.sync_groups(cfg, group)
    live = [a for a, n in dense.mesh_dims if n > 1]
    assert train.mask_line(cfg, group) == line
    if len(live) == 2:
        assert line == dense.axis_size(live[-1])
    fused = make_cfg(MODEL, moe, grad_transport="ef8", **KW)
    assert train.mask_line(fused, group) == 1
