"""Rank-side helpers of the tests of the parallel axes' compositions
(``tests/test_torch_deadline_mesh.py``, ``test_torch_multi_step_mesh.py``):
masked grad steps, deadline rounds and chunked training on tp / ep / pp
meshes. Spawned ranks import this module, which imports no JAX; run the
cases through ``torch_pp_ranks.mesh_cases`` (one spawn a world size)."""

import numpy as np
import torch

from akka_allreduce_tpu_torch.convert import gather_params, params_from_jax
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.runtime.pacer import RoundClock
from akka_allreduce_tpu_torch.runtime.straggler import DeadlineTrainer

from torch_moe_ranks import local_tokens, make_cfg


def _planes(residual) -> dict:
    if residual is None:
        return {}
    if isinstance(residual, dict):
        return {k: v.detach().clone() for k, v in residual.items()}
    return {"dense": residual.detach().clone()}


def masked_case(group, model, moe, kw, params_np, tokens, masks,
                resid_np=None):
    """The dynamic-valid grad step at this mesh from the JAX weights, once
    a mask of ``masks`` (each ``(data_rank_count, num_buckets)``): the
    gathered full-layout gradients, ``min_bucket_count``, and on ef8
    this rank's residual planes before (``resid_np``, this rank's start,
    or zeros) and after each step; plus the mask geometry."""
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    step = train.make_grad_step(cfg, group, dynamic_valid=True)
    mine = local_tokens(group, tokens)
    start = state.residual
    if resid_np is not None:
        start = {k: torch.from_numpy(np.array(v))
                 for k, v in resid_np[group.rank].items()}
        if not isinstance(state.residual, dict):
            start = start["dense"]
    out = []
    for mask in masks:
        res = step(state.params, mine, quant_seed=0, valid=mask,
                   residual=start)
        out.append({
            "grads": gather_params(res[0], cfg.model, group),
            "local_expert": (tree_leaves(train.split_expert_leaves(res[0])[1])
                             if moe is not None else None),
            "min_bucket_count": int(res[1]["min_bucket_count"]),
            "loss": float(res[1]["loss"]),
            "residual": _planes(res[2]) if len(res) > 2 else {}})
    dense, _ = train.sync_groups(cfg, group)
    return {"steps": out, "start": _planes(start),
            "n_data": train.data_rank_count(cfg, group),
            "data_rank": dense.rank,
            "dense_buckets": train.dense_bucket_count(cfg, state.params),
            "expert_buckets": (train.expert_bucket_count(cfg, state.params)
                               if moe is not None else None),
            "mask_line": train.mask_line(cfg, group)}


def deadline_case(group, model, moe, kw, params_np, tokens, late):
    """One round through a ``DeadlineTrainer`` (``line`` from
    ``mask_line``) whose clock sees the data ranks ``late`` miss the
    deadline: its report, the mask it built (from the step) and the
    round's ``min_bucket_count``."""
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    grad_step = train.make_grad_step(cfg, group, dynamic_valid=True)
    seen = {}

    def step(state_, tokens_, valid):
        seen["mask"] = np.array(valid)
        out = grad_step(state_.params, tokens_, quant_seed=0, valid=valid,
                        residual=state_.residual)
        return out[1]
    n = train.data_rank_count(cfg, group)
    clock = RoundClock(n, deadline_s=1.0)
    trainer = DeadlineTrainer(step, clock,
                              train.dense_bucket_count(cfg, state.params),
                              max_lag=0, line=train.mask_line(cfg, group))
    r = trainer.open_round()
    for peer in range(n):
        clock.report_offset(r, peer, 2.0 if peer in late else 0.0)
    metrics = trainer.run_round(state, local_tokens(group, tokens))
    trainer.drain()
    rep = trainer.reports[0]
    return {"n_masked": rep.n_masked, "n_dropped": rep.n_dropped,
            "fell_back": rep.fell_back, "mask": seen["mask"],
            "line": trainer.line,
            "min_bucket_count": int(metrics["min_bucket_count"]),
            "loss": float(metrics["loss"])}


def chunk_case(group, model, moe, kw, params_np, batches, spd):
    """``make_multi_step(cfg, spd)`` at this mesh from the JAX weights on
    a device-step state, over ``batches`` (a multiple of ``spd`` global
    batches) chunk by chunk: the losses and the gathered final params."""
    cfg = make_cfg(model, moe, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, device_step=True,
                                   group=group)
    multi = train.make_multi_step(cfg, spd, group)
    losses = []
    for i in range(0, len(batches), spd):
        chunk = torch.stack([local_tokens(group, b)
                             for b in batches[i:i + spd]])
        losses += multi(state, chunk)["loss"].tolist()
    return {"losses": losses, "step": state.step,
            "params": gather_params(state.params, cfg.model, group)}


def mesh_cases(group, cases: list) -> list:
    """``fn(mesh_group, *args)`` for each ``(fn name, mesh, args)`` of
    ``cases`` (``fn`` a function of this module), each on a group of its
    own mesh with its axis subgroups (``torch_pp_ranks.mesh_cases``)."""
    from akka_allreduce_tpu_torch.parallel import group as G
    from torch_pp_ranks import mesh_group
    out = []
    for name, mesh, args in cases:
        g = mesh_group(group, mesh)
        G.make_axis_subgroups(g)
        try:
            out.append(globals()[name](g, *args))
        finally:
            G.free_axis_subgroups()
    return out
