"""Rank-side helpers of the port's multi-rank ``--steps-per-dispatch``
tests. Spawned ranks import this module by name, so it imports no JAX.
"""

import numpy as np
import torch

from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig
from akka_allreduce_tpu_torch.ops import collectives


def chunked_train(group, model: dict, cfg_kw: dict, params, tokens, spd):
    """This rank's rows of the global ``(k, B, T)`` tokens through
    ``make_multi_step(cfg, spd, group)`` chunks (a tail shorter than
    ``spd`` step by step) from the JAX ``params`` (numpy): the losses,
    the final params (numpy, leaf order) and the rounding keys of one
    eager step of the same code (kinds, in order)."""
    cfg = ttrain.TrainConfig(model=TransformerConfig(**model), **cfg_kw)
    state = ttrain.make_train_state(cfg, params=convert.params_from_jax(
        params), device_step=True)
    rows = tokens.shape[1] // group.world
    mine = torch.from_numpy(np.ascontiguousarray(
        tokens[:, group.rank * rows:(group.rank + 1) * rows]))
    multi = ttrain.make_multi_step(cfg, spd, group)
    losses = []
    for i in range(0, mine.shape[0], spd):
        losses += multi(state, mine[i:i + spd])["loss"].tolist()
    probe = ttrain.make_train_state(cfg, params=convert.params_from_jax(
        params), device_step=True)
    with collectives.record_keys() as keys:
        ttrain.make_train_step(cfg, group)(probe, mine[0])
    return {"losses": losses,
            "params": [p.detach().numpy().copy()
                       for p in ttrain.tree_leaves(state.params)],
            "keys": [kind for kind, _ in keys]}


def step_calls(group, model: dict, cfg_kw: dict, tokens) -> list:
    """The ``(kind, bytes)`` of every collective one train step of this
    rank makes, in order: its rows of the global ``(B, T)`` tokens
    through ``make_train_step(cfg, group)`` with the group's
    ``all_to_all`` and ``all_gather`` recorded (the calls a chunk's graph
    captures on the ipc transport)."""
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    cfg = ttrain.TrainConfig(model=TransformerConfig(**model), **cfg_kw)
    state = ttrain.make_train_state(
        cfg, generator=torch.Generator().manual_seed(0), device_step=True)
    rows = tokens.shape[0] // group.world
    mine = torch.from_numpy(np.ascontiguousarray(
        tokens[group.rank * rows:(group.rank + 1) * rows]))
    calls, real = [], {k: getattr(RankGroup, k)
                       for k in ("all_to_all", "all_gather")}

    def recorded(kind):
        def call(self, x):
            calls.append((kind, x.numel() * x.element_size()))
            return real[kind](self, x)
        return call
    for kind in real:
        setattr(RankGroup, kind, recorded(kind))
    try:
        ttrain.make_train_step(cfg, group)(state, mine)
    finally:
        for kind, fn in real.items():
            setattr(RankGroup, kind, fn)
    return calls
