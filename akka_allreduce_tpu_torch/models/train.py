"""The one-card training step of the dense flagship transformer.

Counterpart of ``akka_allreduce_tpu/models/train.py`` for one rank: loss,
backprop and the optimizer update. On one card the JAX step's gradient
sync reduces over size-1 mesh axes and is the identity, so there is no
sync here; ``min_bucket_count`` is reported as the one-device JAX step
reports it (1). More than one rank is ROADMAP.md item A3.

PyTorch idiom in place of the JAX package's pure functions:

* parameters are a nested dict of f32 master tensors with the JAX
  pytree's names and layout (``convert.params_from_jax`` carries them
  across); their leaves require grad;
* the optimizer is ``torch.optim.AdamW`` over two parameter groups, the
  rank >= 2 leaves with ``weight_decay`` and the rest (norm gains) with
  none: optax's decay mask. Its update equals ``optax.adamw``'s;
* the step updates the parameters and the optimizer state IN PLACE
  (``TrainState`` holds them) and returns the metrics; the JAX step
  returns new arrays instead;
* ``compute_dtype="bf16"`` runs the model on bf16 copies of the masters;
  autograd casts the gradients back to f32, so the update stays f32.

Left out of this slice and refused with ``NotImplementedError`` (ROADMAP
A2): optimizers other than adamw, ``ema_decay``, and
``accum_schedule="overlap"``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional, Union

import torch

from akka_allreduce_tpu_torch.models.transformer import (
    TransformerConfig, init_transformer, next_token_loss_and_aux)
from akka_allreduce_tpu_torch.ops.kernels.flash_attention import \
    flash_causal_attention
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    blockwise_causal_attention, local_causal_attention)

LEFT_OUT = "left out of the port's one-card training slice (ROADMAP.md A2)"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig`` fields this slice uses, with their names
    and defaults. ``bucket_elems`` sizes the gradient buckets of the
    multi-rank sync (A3) and is carried for it; ``attn_block_size``
    serves ``attn_impl="blockwise"`` (the flash kernels' tile is their
    own constant)."""

    model: TransformerConfig
    learning_rate: float = 1e-3
    bucket_elems: int = 1 << 16
    compute_dtype: str = "f32"
    remat: bool = False
    attn_block_size: Optional[int] = None
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    clip_norm: float = 0.0
    optimizer: str = "adamw"
    weight_decay: float = 1e-4
    grad_accum: int = 1
    accum_schedule: str = "deferred"
    ema_decay: float = 0.0
    attn_impl: str = "auto"


@dataclasses.dataclass
class TrainState:
    """Parameters, their optimizer and its step count (optax's
    ``count``: the steps taken, which the LR schedule reads before it
    increments). The train step mutates all three."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0


def tree_leaves(tree) -> list:
    """The tensors of a params-shaped tree, in a fixed order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The inverse of :func:`tree_leaves` against a template tree."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)
    return build(like)


def tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.optimizer != "adamw":
        if cfg.optimizer not in ("adafactor", "sgd", "lion"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}: adamw "
                             f"| adafactor | sgd | lion")
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is "
                                  f"{LEFT_OUT}; use adamw")
    if cfg.ema_decay != 0.0:
        raise NotImplementedError(f"ema_decay is {LEFT_OUT}")
    if cfg.accum_schedule not in ("deferred", "overlap"):
        raise ValueError(f"unknown accum_schedule {cfg.accum_schedule!r}")
    if cfg.accum_schedule == "overlap":
        raise NotImplementedError(f"accum_schedule='overlap' is {LEFT_OUT}"
                                  f"; use 'deferred'")
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    if cfg.compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "training on more than one rank (the bucketed gradient sync) "
            "is not ported yet: ROADMAP.md A3")


def make_lr_schedule(cfg: TrainConfig) -> Union[float,
                                                Callable[[int], float]]:
    """The learning rate per step count, as optax evaluates it: the
    constant as a float, or optax's ``warmup_cosine_decay_schedule(0,
    lr, warmup_steps, decay_steps=total_steps)`` as a function of the
    count before it increments (step 0 reads count 0)."""
    if cfg.lr_schedule == "constant":
        return cfg.learning_rate
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.total_steps <= cfg.warmup_steps:
        raise ValueError(
            "lr_schedule='cosine' needs total_steps > warmup_steps "
            f"(got total_steps={cfg.total_steps}, "
            f"warmup_steps={cfg.warmup_steps})")
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    decay = cfg.total_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:  # linear_schedule(0 -> peak over warmup)
            return peak * count / warmup
        c = min(count - warmup, decay)
        return peak * 0.5 * (1 + math.cos(math.pi * c / decay))
    return schedule


def lr_at(cfg: TrainConfig, count: int) -> float:
    sched = make_lr_schedule(cfg)
    return sched(count) if callable(sched) else sched


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.AdamW:
    """AdamW over ``params`` (b1 0.9, b2 0.999, eps 1e-8, as optax's
    adamw) with optax's decay mask: rank >= 2 leaves decay, the rest
    (norm gains, vectors) do not. The learning rate is set per step by
    the train step from :func:`make_lr_schedule`."""
    _check_supported(cfg)
    leaves = tree_leaves(params)
    decay = [p for p in leaves if p.dim() >= 2]
    no_decay = [p for p in leaves if p.dim() < 2]
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": cfg.weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=lr_at(cfg, 0), betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: when the global norm is
    not below ``max_norm`` every gradient becomes ``g / norm * max_norm``;
    below it they stay as they are (``clip_grad_norm_`` would instead
    scale by ``max_norm / (norm + 1e-6)`` whenever the ratio is < 1).
    Returns the norm. No host synchronisation."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def select_local_attention(cfg: TrainConfig):
    """Rank-local attention per ``cfg.attn_impl``. "auto" and "flash" are
    the flash path on every device: its wrappers launch the CUDA kernels
    for CUDA tensors and run their plain versions for CPU tensors (where
    the JAX package's CPU "auto" picks its pure-JAX paths). "blockwise"
    and "local" force the plain PyTorch paths."""
    impl = cfg.attn_impl
    if impl not in ("auto", "flash", "blockwise", "local"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    window = cfg.model.attn_window
    if impl in ("auto", "flash"):
        return partial(flash_causal_attention, window=window)
    if impl == "blockwise":
        if window is not None:
            raise ValueError(
                "attn_window is served by the flash and local paths; "
                "attn_impl='blockwise' does not support it")
        return partial(blockwise_causal_attention,
                       block_size=cfg.attn_block_size or 512)
    return partial(local_causal_attention, window=window)


def make_train_state(cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[dict] = None,
                     device: "torch.device | str | None" = None
                     ) -> TrainState:
    """Parameters (``params``, or random from ``generator``) as leaves
    that require grad, and their optimizer."""
    if params is None:
        if generator is None:
            raise ValueError("make_train_state needs params or a generator")
        params = init_transformer(generator, cfg.model, device)
    elif device is not None:
        params = tree_map(lambda p: p.to(device), params)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, optimizer=make_optimizer(cfg, params))


def make_grad_step(cfg: TrainConfig):
    """``grad_step(params, tokens) -> (grads, metrics)``: the next-token
    loss over tokens (B, T) (the last column has weight 0, as in the
    JAX step without sequence parallelism), its gradients as a params-
    shaped dict of f32 tensors, and the JAX step's metrics. With
    ``grad_accum`` K > 1 the batch splits into K microbatches whose
    gradients and losses sum (each scaled by the whole batch's token
    count, so the sum is the full-batch mean), aux terms averaged: the
    JAX "deferred" schedule."""
    _check_supported(cfg)
    mcfg = cfg.model
    attn = select_local_attention(cfg)
    accum = cfg.grad_accum

    def cast_compute(params):
        if cfg.compute_dtype == "f32":
            return params
        return tree_map(lambda p: p.to(torch.bfloat16)
                        if p.dtype == torch.float32 else p, params)

    def grad_step(params, tokens):
        b, t = tokens.shape
        targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        weights = torch.ones((b, t), device=tokens.device)
        weights[:, -1] = 0.0
        positions = torch.arange(t, device=tokens.device)
        total_count = weights.sum()
        leaves = tree_leaves(params)
        if b % accum:
            raise ValueError(f"local batch {b} must divide into "
                             f"grad_accum={accum} microbatches")
        loss, aux, grads = 0.0, None, None
        for tok, tgt, w in zip(tokens.chunk(accum), targets.chunk(accum),
                               weights.chunk(accum)):
            loss_sum, _, mb_aux = next_token_loss_and_aux(
                cast_compute(params), tok, mcfg, positions, attn,
                targets=tgt, weights=w, remat=cfg.remat)
            mb_loss = loss_sum / total_count
            mb_grads = torch.autograd.grad(mb_loss, leaves)
            loss = loss + mb_loss.detach()
            aux = mb_aux if aux is None else {
                k: aux[k] + mb_aux[k] for k in aux}
            grads = mb_grads if grads is None else [
                g + m for g, m in zip(grads, mb_grads)]
        metrics = {
            "loss": loss, "tokens": total_count,
            "min_bucket_count": torch.ones((), dtype=torch.int32,
                                           device=tokens.device),
            "aux_loss": aux["aux_loss"] / accum,
            "dispatch_fraction": aux["dispatch_fraction"] / accum}
        return tree_unflatten(params, grads), metrics

    return grad_step


def make_train_step(cfg: TrainConfig):
    """``step(state, tokens) -> metrics``: gradients, then the optax
    chain's order — global-norm clip (``clip_norm > 0``), then AdamW at
    the schedule's rate for ``state.step`` — applied to ``state`` in
    place."""
    grad_step = make_grad_step(cfg)

    def step(state: TrainState, tokens: torch.Tensor) -> dict:
        grads, metrics = grad_step(state.params, tokens)
        grads = tree_leaves(grads)
        if cfg.clip_norm > 0:
            clip_by_global_norm_(grads, cfg.clip_norm)
        lr = lr_at(cfg, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        for p, g in zip(tree_leaves(state.params), grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    return step
