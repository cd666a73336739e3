"""Rank-side helpers of the pipeline-parallel tests
(``tests/test_torch_pp.py``, ``test_torch_train_pp.py``,
``test_torch_optim_sharded.py``, ``test_torch_cli.py``): spawned ranks
import this module, which imports no JAX.

A spawn fixes one world size; :func:`mesh_cases` runs cases of several
meshes of that world in it, each on a ``RankGroup`` of its own mesh with
its axis subgroups made before the case and destroyed after it (a
collective: every rank runs the same cases in the same order)."""

import numpy as np
import torch

from akka_allreduce_tpu_torch.convert import gather_params, params_from_jax
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves, tree_map
from akka_allreduce_tpu_torch.parallel import group as G
from akka_allreduce_tpu_torch.parallel import pp

from torch_moe_ranks import local_tokens, make_cfg


def mesh_group(group, mesh: dict):
    """This rank on the mesh ``mesh`` (``pp``, ``ep``, ``sp``, ``tp``
    sizes; dp the rest of the world)."""
    return G.RankGroup(group.rank, group.world, group.backend, group.device,
                       mesh.get("sp", 1), ep=mesh.get("ep", 1),
                       tp=mesh.get("tp", 1), pp=mesh.get("pp", 1))


def mesh_cases(group, cases: list) -> list:
    """``fn(mesh_group, *args)`` for each ``(fn name, mesh, args)`` of
    ``cases`` (``fn`` a function of this module), in order."""
    out = []
    for name, mesh, args in cases:
        g = mesh_group(group, mesh)
        G.make_axis_subgroups(g)
        try:
            out.append(globals()[name](g, *args))
        finally:
            G.free_axis_subgroups()
    return out


# -- parallel/pp.py units ----------------------------------------------------

def _scale_stage(p, h):
    return h * p["w"][0], {"seen": h.sum()}


def gpipe_unit(group, w, x, d_scale):
    """``gpipe_apply`` of the stage ``h * w[stage]`` on ``x`` (m, ...):
    this rank's outputs (the last stage's), aux, graphs held, and the
    backward for the loss ``d_scale * sum(out ** 2)``: the stage weight's
    gradient and rank 0's input gradient."""
    idx = group.axis_index("pp")
    w_local = torch.tensor([float(w[idx])], requires_grad=True)
    xs = torch.from_numpy(np.array(x))
    run = pp.gpipe_apply({"w": w_local}, xs, _scale_stage, group)
    out = None if run.outputs is None else run.outputs.detach().clone()
    d_out = None if out is None else 2.0 * d_scale * out
    d_stage, d_x = run.backward(d_out)
    return {"out": out, "aux": {k: float(v) for k, v in run.aux.items()},
            "peak_graphs": run.peak_graphs, "dw": d_stage["w"],
            "dx": d_x, "live_after": run.live_graphs}


def one_f_one_b_unit(group, w, table, head, tokens, targets):
    """``one_f_one_b`` of a toy pipeline: embedding rows of ``table``,
    stage ``tanh(h * w[stage])``, head ``sum((h * head - target) ** 2) /
    m``: (loss_sum, d_stage, d_other) and the ring's stats."""
    idx = group.axis_index("pp")
    w_local = torch.tensor([float(w[idx])], requires_grad=True)
    other = {"head": torch.from_numpy(np.array(head)).requires_grad_(True),
             "table": torch.from_numpy(np.array(table)).requires_grad_(True)}
    toks = torch.from_numpy(np.array(tokens))
    tgt = torch.from_numpy(np.array(targets))
    m = toks.shape[0]

    def head_fn(o, h, mb):
        return ((h * o["head"] - tgt[mb]) ** 2).sum() / m

    stats: dict = {}
    loss, d_stage, d_other = pp.one_f_one_b(
        {"w": w_local}, other, toks,
        lambda st, h: torch.tanh(h * st["w"][0]),
        lambda o, tok: o["table"][tok], head_fn, group, stats=stats)
    return {"loss": float(loss), "dw": d_stage["w"],
            "d_head": d_other["head"], "d_table": d_other["table"],
            "stats": stats}


# -- the pipelined train step -------------------------------------------------

def grads_case(group, model, moe, kw, params_np, tokens):
    """One grad step at this mesh from the JAX weights: the gathered
    full-layout gradients and the metrics."""
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    out = train.make_grad_step(cfg, group)(state.params,
                                           local_tokens(group, tokens))
    return {"grads": gather_params(out[0], cfg.model, group),
            "metrics": {k: float(v) for k, v in out[1].items()}}


def ef8_case(group, model, kw, params_np, tokens):
    """One ef8 grad step at dp x pp: the residual plane and synced
    gradients, and those of this rank's own stacked tree synced alone
    from zero with the key ``(17, 0, 0)``. The rank's unsynced
    gradients are its pp line's step alone (no data ranks) times 1 /
    dp: that step's count is the line's tokens, 1 / dp of the whole
    batch's (a power of two: exact)."""
    from akka_allreduce_tpu_torch.parallel.dp import allreduce_gradients
    cfg = make_cfg(model, None, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    mine = local_tokens(group, tokens)
    grads, _, residual = train.make_grad_step(cfg, group)(
        state.params, mine, quant_seed=0, residual=state.residual)
    line = group.along("pp")
    f32 = train.TrainConfig(**{**cfg.__dict__, "grad_transport": "f32"})
    local, _ = train.make_grad_step(f32, line)(state.params, mine)
    dp = group.axis_size("dp")
    local = tree_map(lambda g: g / dp, local)
    dense, _ = train.sync_groups(cfg, group)
    alone = allreduce_gradients(local, train.sync_config(cfg, dense.world),
                                dense, quant_key=train.quant_key(0),
                                residual=torch.zeros_like(residual))
    return {"rows": int(residual.shape[0]),
            "same_grads": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(grads), tree_leaves(alone.grads))),
            "same_residual": torch.equal(residual, alone.residual),
            "residual_max": float(residual.abs().max())}


def pipeline_stats_case(group, model, kw, params_np, tokens):
    """The schedule's residency on this rank at one grad step: gpipe's
    graphs held at once, 1f1b's ring depth, inputs and graphs."""
    cfg = make_cfg(model, None, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    seen: dict = {}
    real_gpipe, real_1f1b = train.gpipe_apply, train.one_f_one_b

    def gpipe(*a, **k):
        run = real_gpipe(*a, **k)
        seen["gpipe_peak_graphs"] = run.peak_graphs
        return run

    def one_f_one_b(*a, **k):
        stats = k.setdefault("stats", {})
        out = real_1f1b(*a, **k)
        seen.update(stats)
        return out

    train.gpipe_apply, train.one_f_one_b = gpipe, one_f_one_b
    try:
        train.make_grad_step(cfg, group)(state.params,
                                         local_tokens(group, tokens))
    finally:
        train.gpipe_apply, train.one_f_one_b = real_gpipe, real_1f1b
    return seen


def train_state_case(group, model, kw, params_np, tokens, steps=1):
    """``steps`` train steps at this mesh from the JAX weights: the full
    layout of the params and of the optimizer state (``full_layout``),
    and the losses."""
    cfg = make_cfg(model, None, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    step = train.make_train_step(cfg, group)
    losses = [float(step(state, local_tokens(group, tokens))["loss"])
              for _ in range(steps)]
    full, opt, ema = train.full_layout(state, group)
    return {"params": full, "opt": opt, "losses": losses}


# -- adafactor over shards ----------------------------------------------------

def adafactor_case(group, model, moe, kw, params_np, grads_np):
    """One adafactor update of this rank's shard of the full tree
    ``params_np`` with its shard of ``grads_np``, gathered: the full
    updated params, and whether a stacked norm gain sits in the
    no-decay group."""
    from akka_allreduce_tpu_torch.convert import shard_params
    cfg = make_cfg(model, moe, **kw)
    params = shard_params(params_from_jax(params_np), cfg.model, group)
    grads = shard_params(params_from_jax(grads_np), cfg.model, group)
    params = tree_map(lambda p: p.clone().requires_grad_(True), params)
    opt = train.make_optimizer(cfg, params, group=group)
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        p.grad = g.clone()
    opt.step()
    gain = (params["layers"]["ln1"] if isinstance(params["layers"], dict)
            else params["layers"][0]["ln1"])
    undecayed = any(gain is p for g in opt.param_groups
                    if g["weight_decay"] == 0.0 for p in g["params"])
    return {"params": gather_params(tree_map(lambda p: p.detach(), params),
                                    cfg.model, group),
            "gain_undecayed": undecayed}
