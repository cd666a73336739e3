"""Adafactor over sharded leaves against optax through the JAX package.

optax's adafactor runs on the global arrays: the factored dims come from
the whole leaf's shape, the row and column means span whole dims, and
the update clip and the parameter scale take the RMS of the whole leaf.
The port's ``models/optim.py Adafactor`` on a rank's block of a leaf
sums over the lines that split it (``Shard``). One step on each mesh,
each rank's shard of the same params and gradients (numpy, from a
seed), gathered, equals optax through JAX ``make_optimizer`` on the
global tree within 1e-6 of each leaf's largest update: at pp (and pp x
tp, pp x ep) ``make_optimizer(cfg, stacked_layers=True)`` on the
stacked tree, whose block RMS spans every layer of a stacked leaf (so
JAX's adafactor at pp > 1 is not its adafactor at pp = 1, and the port
follows the stacked one); at tp and ep ``stacked_layers=False`` on the
list tree. A stacked norm gain sits in the no-decay group, as JAX's
stacked decay mask has it. The widths are 128 and more, so the matrices
are factored. All the cases of one world size share one spawn.
"""

import jax
import numpy as np
import optax
import pytest

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
from akka_allreduce_tpu.parallel.pp import (stack_layer_params,
                                            unstack_layer_params)
from akka_allreduce_tpu_torch.convert import params_to_jax
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

from torch_pp_ranks import mesh_cases

MODEL = dict(vocab_size=256, d_model=128, n_heads=4, n_layers=4, d_ff=256,
             max_seq=64)
MOE_MODEL = dict(MODEL, moe_every=1)
MOE = dict(n_experts=4, d_ff=256, capacity_factor=8.0, router_k=2)
KW = dict(bucket_elems=256, optimizer="adafactor", weight_decay=1e-2,
          learning_rate=1e-2)
# (name, world, mesh, MoE)
CASES = [("pp2", 2, dict(pp=2), False), ("tp2", 2, dict(tp=2), False),
         ("ep2", 2, dict(ep=2), True), ("pp4", 4, dict(pp=4), False),
         ("pp2-tp2", 4, dict(pp=2, tp=2), False),
         ("pp2-ep2", 4, dict(pp=2, ep=2), True)]


def inputs(moe: bool):
    mcfg = jtf.TransformerConfig(
        **(MOE_MODEL if moe else MODEL), moe=JMoE(**MOE) if moe else None)
    params = jax.tree.map(np.asarray,
                          jtf.init_transformer(jax.random.key(0), mcfg))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * 1e-2).astype(np.float32),
        params)
    return mcfg, params, grads


def optax_step(mcfg, params, grads, stacked: bool):
    """One step of JAX's chain on the global tree (stacked when asked),
    back in the list layout."""
    cfg = jtrain.TrainConfig(model=mcfg, optimizer="adafactor",
                             weight_decay=KW["weight_decay"],
                             learning_rate=KW["learning_rate"])
    opt = jtrain.make_optimizer(cfg, stacked_layers=stacked)
    if stacked:
        params = dict(params, layers=stack_layer_params(params["layers"]))
        grads = dict(grads, layers=stack_layer_params(grads["layers"]))
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    if stacked:
        new = dict(new, layers=unstack_layer_params(new["layers"],
                                                    mcfg.n_layers))
    return jax.tree.map(np.asarray, new)


def spawn(world):
    cases, names = [], []
    for name, w, mesh, moe in CASES:
        if w != world:
            continue
        _, params, grads = inputs(moe)
        model = MOE_MODEL if moe else MODEL
        cases.append(("adafactor_case", mesh,
                      (model, MOE if moe else None, KW, params, grads)))
        names.append(name)
    out = spawn_ranks(mesh_cases, world, "gloo", "cpu", cases)
    return {n: [r[i] for r in out] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def ranks():
    return {**spawn(2), **spawn(4)}


@pytest.mark.parametrize("name,world,mesh,moe", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_adafactor_step_equals_optax(ranks, name, world, mesh, moe):
    mcfg, params, grads = inputs(moe)
    stacked = mesh.get("pp", 1) > 1
    want = optax_step(mcfg, params, grads, stacked)
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for r in ranks[name]:
        got = jax.tree_util.tree_flatten_with_path(
            params_to_jax(r["params"]))[0]
        assert [p for p, _ in got] == [p for p, _ in flat_w]
        for (path, p0), (_, w), (_, g) in zip(flat_p, flat_w, got):
            key = jax.tree_util.keystr(path)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=key)
            # the update itself, to a few ulps of the params it moves
            upd = w - p0
            err = np.abs((g - p0) - upd).max()
            assert err <= 1e-5 * np.abs(upd).max(), key
        assert r["gain_undecayed"]


def test_stacked_semantics_differ_from_unstacked():
    """JAX's own adafactor at pp > 1 is not its adafactor at pp = 1: a
    stacked leaf's clip and parameter scale span all its layers (the
    reason the port holds its pp step to the stacked chain)."""
    mcfg, params, grads = inputs(False)
    a = optax_step(mcfg, params, grads, True)
    b = optax_step(mcfg, params, grads, False)
    diffs = [np.abs(x - y).max() for x, y in zip(jax.tree.leaves(a),
                                                 jax.tree.leaves(b))]
    assert max(diffs) > 1e-6
