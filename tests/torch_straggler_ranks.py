"""Rank-side helpers of the port's straggler-deadline tests.

Spawned ranks import this module by name, so it imports no JAX. Every
rank receives the JAX initial parameters and the GLOBAL token batch as
numpy arrays and takes its own rows (``dp``) and columns (``sp``).
"""

import numpy as np
import torch

from akka_allreduce_tpu_torch.convert import params_from_jax
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.runtime.pacer import RoundClock
from akka_allreduce_tpu_torch.runtime.straggler import DeadlineTrainer


def _config(model: dict, wire: str = "f32", **kw) -> ttrain.TrainConfig:
    return ttrain.TrainConfig(model=TransformerConfig(**model),
                              grad_transport=wire, **kw)


def _local(group, tokens: np.ndarray) -> torch.Tensor:
    dp, sp = group.axis_size("dp"), group.axis_size("sp")
    i, j = group.axis_index("dp"), group.axis_index("sp")
    b, t = tokens.shape[0] // dp, tokens.shape[1] // sp
    return torch.from_numpy(np.ascontiguousarray(
        tokens[i * b:(i + 1) * b, j * t:(j + 1) * t]))


def masked_grad_steps(group, model: dict, bucket_elems: int, params: dict,
                      tokens: np.ndarray, cases: list) -> list:
    """Per case ``(wire, valid, residual, garble)``: one dynamic-valid
    grad step (quant seed 3) on this rank's part of ``tokens``, with
    ``valid`` the whole ``(world, num_buckets)`` mask and ``residual``
    the ef8 state to start from (None elsewhere). ``garble`` replaces
    this rank's tokens when its whole row is masked (their data must not
    reach the result). Returns per case the synced gradients (numpy,
    params-shaped), ``min_bucket_count`` and the ef8 residual."""
    out = []
    for wire, valid, residual, garble in cases:
        cfg = _config(model, wire, bucket_elems=bucket_elems)
        p = params_from_jax(params)
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        tok = _local(group, tokens)
        if garble and not valid[group.rank].any():
            tok = (tok + 7) % model["vocab_size"]
        grad_step = ttrain.make_grad_step(cfg, group, dynamic_valid=True)
        res = None if residual is None else torch.from_numpy(residual.copy())
        got = grad_step(p, tok, quant_seed=3, residual=res, valid=valid)
        out.append((_numpy_tree(got[0]), int(got[1]["min_bucket_count"]),
                    got[2].numpy() if len(got) > 2 else None))
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.detach().numpy()


def deadline_rounds(group, model: dict, train_kw: dict, params: dict,
                    tokens: np.ndarray, offsets: list, deadline_s: float,
                    max_lag: int) -> dict:
    """``DeadlineTrainer`` over the dynamic-valid train step, one round
    per entry of ``offsets`` (per peer: the arrival offset in seconds,
    None for a peer that never reports), every round on ``tokens``, the
    clock's own time fixed at 0. Returns per round the loss,
    ``min_bucket_count``, the report and the pacer's rounds in flight
    after the round, and the completed rounds after the drain."""
    cfg = _config(model, **train_kw)
    state = ttrain.make_train_state(cfg, params=params_from_jax(params))
    step = ttrain.make_train_step(cfg, group, dynamic_valid=True)
    clock = RoundClock(ttrain.data_rank_count(cfg, group), deadline_s,
                       clock=lambda: 0.0)
    trainer = DeadlineTrainer(
        step, clock, ttrain.dense_bucket_count(cfg, state.params), max_lag)
    tok = _local(group, tokens)
    losses, counts, inflight = [], [], []
    for per_peer in offsets:
        r = trainer.open_round()
        for peer, off in enumerate(per_peer):
            if off is not None:
                clock.report_offset(r, peer, off)
        metrics = trainer.run_round(state, tok)
        losses.append(float(metrics["loss"]))
        counts.append(int(metrics["min_bucket_count"]))
        inflight.append(len(trainer.pacer._inflight))
    trainer.drain()
    return {"losses": losses, "min_counts": counts, "inflight": inflight,
            "reports": [(rep.round, rep.valid_peers, rep.n_masked,
                         rep.fell_back) for rep in trainer.reports],
            "completed": list(trainer.pacer.completed_rounds),
            "masked_round_count": trainer.masked_round_count}
