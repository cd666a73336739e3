"""Rank-side helpers of the port's overlapped-accumulation tests.

Spawned ranks import this module by name, so it imports no JAX. Every
rank receives the GLOBAL batch as a numpy array and takes its own rows,
``[r B / dp, (r + 1) B / dp)``.
"""

import numpy as np
import torch

from akka_allreduce_tpu_torch.models import train
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig


def _config(model: dict, kw: dict) -> train.TrainConfig:
    return train.TrainConfig(model=TransformerConfig(**model), **kw)


def _rows(group, tokens: np.ndarray) -> torch.Tensor:
    n, r = group.axis_size("dp"), group.axis_index("dp")
    b = tokens.shape[0] // n
    return torch.from_numpy(np.ascontiguousarray(tokens[r * b:(r + 1) * b]))


def grad_steps(group, params, model: dict, tokens: np.ndarray,
               cases: list) -> list:
    """Per case ``(config kwargs, valid or None)``: this rank's synced
    gradients (numpy, in ``tree_leaves`` order) and metrics at quant seed
    7, from ``params`` (each rank its own copy)."""
    out = []
    for kw, valid in cases:
        cfg = _config(model, kw)
        state = train.make_train_state(cfg, params=train.tree_map(
            lambda p: p.detach().clone(), params))
        step = train.make_grad_step(cfg, group,
                                    dynamic_valid=valid is not None)
        res = step(state.params, _rows(group, tokens), quant_seed=7,
                   residual=state.residual, valid=valid)
        out.append(([g.numpy() for g in train.tree_leaves(res[0])],
                     {k: float(v) for k, v in res[1].items()}))
    return out


def train_losses(group, params, model: dict, batches: list,
                 cases: list) -> list:
    """Per case (config kwargs): the losses of one step per global batch
    from ``params``."""
    out = []
    for kw in cases:
        cfg = _config(model, kw)
        state = train.make_train_state(cfg, params=train.tree_map(
            lambda p: p.detach().clone(), params))
        step = train.make_train_step(cfg, group)
        out.append([float(step(state, _rows(group, b))["loss"])
                    for b in batches])
    return out


def overlap_cases(group, params, model: dict, tokens: np.ndarray,
                  cases: list, batches: list, runs: list) -> tuple:
    """:func:`grad_steps` over ``cases``, then :func:`train_losses` over
    ``runs``, in one spawn."""
    return (grad_steps(group, params, model, tokens, cases),
            train_losses(group, params, model, batches, runs))
