"""Rank-side code of ``tests/test_torch_elastic.py`` (imports no JAX):
train on a dp x tp mesh, lose ranks, re-form the survivors' process group
and reshard the live state onto it (``runtime/elastic.py``)."""

import torch.distributed as dist

from akka_allreduce_tpu_torch.convert import params_from_jax
from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.runtime import elastic

from torch_moe_ranks import local_tokens, make_cfg


def _snapshot(state) -> list:
    return [t.detach().clone() for t in elastic._state_tensors(state)]


def lose_and_reform(group, model, kw, params_np, batches, address,
                    survivors):
    """One step on this rank's mesh (dp x tp), then the ranks outside
    ``survivors`` leave (return at once), and the survivors re-form
    through an ``ElasticController`` whose ``on_reform`` joins the new
    group (two hosts of two ranks when the survivors are a host's, else
    four hosts of one rank, all but the last lost rank marked lost
    before the one re-formation), reshard and take a step on each
    further batch. Returns the losses, the state tensors before and
    after the reshard, and the new rank (None when gone or idle)."""
    cfg = make_cfg(model, None, **kw)
    state = train.make_train_state(cfg, params=params_from_jax(params_np),
                                   device=group.device, group=group)
    step = train.make_train_step(cfg, group)
    losses = [float(step(state, local_tokens(group, batches[0]))["loss"])]
    old_rank, old_spec = group.rank, elastic.MeshSpec.of(group)
    before = _snapshot(state)
    if old_rank not in survivors:
        return {"losses": losses, "rank": None, "before": before}
    store = dist.TCPStore(address[0], address[1], is_master=False,
                          wait_for_workers=False)
    seen, joined = [], []

    def on_reform(plan, generation):
        joined.append(elastic.reform_group(plan, old_rank, store,
                                           group.backend, group.device,
                                           group))
        seen.append(generation)
    hosts = sorted({r // 2 for r in survivors})
    rph = 2 if sorted(survivors) == [
        r for h in hosts for r in (2 * h, 2 * h + 1)] else 1
    ctl = elastic.ElasticController(
        old_spec, total_hosts=4 // rph, ranks_per_host=rph,
        min_fraction=0.5, on_reform=on_reform)
    for host in range(4 // rph):
        ctl.tracker.member_up(host)
    *first, last = sorted(set(range(4 // rph)) -
                          {r // rph for r in survivors})
    for host in first:
        ctl.tracker.member_lost(host)
    ctl.handle_member_lost(last)
    new, = joined
    if new is None:  # an idle survivor
        return {"losses": losses, "rank": None, "before": before,
                "generations": seen}
    elastic.reshard(state, ctl.group, new)
    after = _snapshot(state)
    step = train.make_train_step(cfg, new)
    for tokens in batches[1:]:
        losses.append(float(step(state, local_tokens(new, tokens))["loss"]))
    return {"losses": losses, "rank": new.rank, "before": before,
            "after": after, "generations": seen,
            "spec": elastic.MeshSpec.of(new),
            "residual_zero": state.residual is None or all(
                bool((r == 0).all()) for r in
                train.tree_leaves(state.residual))}
