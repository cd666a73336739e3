"""The training step of the flagship transformer, on one rank or many.

Counterpart of ``akka_allreduce_tpu/models/train.py``: loss, backprop,
the bucketed gradient sync across the data ranks, and the optimizer
update. With a group of more than one rank (``parallel/group.py``, a
``(pp, dp, ep, sp, tp)`` mesh) the step works as the JAX ``grad_local``
(``grad_local_pp``, ``grad_local_1f1b``) / ``sync_and_metrics`` pair
does:

* under sequence parallelism (``sp`` > 1) rank ``(i, j)`` holds columns
  ``[j T, (j + 1) T)`` of its rows: positions (learned embeddings, rope)
  are global, the last target comes from the right ``sp`` neighbour's
  first token, only the last ``sp`` rank's final column has weight 0,
  and attention goes around the ring (:func:`select_ring_attention`);
* each rank's loss divides by the GLOBAL token count, the weights summed
  over every rank (the JAX psum over the data axes), so the sum of the
  ranks' gradients is the gradient of the global mean;
* under tensor parallelism (``tp`` > 1) each rank holds its Megatron
  shard of the weights (``convert.shard_params``: every rank draws the
  full tree from the seed and keeps its slice), the attention runs on
  its ``H / tp`` heads and the block's sums over ``tp`` are
  ``parallel/tp.py``'s; the ``tp`` ranks of a line take the same batch
  rows and need no gradient sync;
* with MoE layers and ``ep`` > 1 each rank owns ``n_experts / ep``
  experts and routes its tokens over the ``ep`` line
  (``parallel/ep.py``); ``ep`` is also a data axis: the batch's rows are
  sharded over ``(dp, ep)``, dp-major (the JAX ``batch_axes``);
* with ``pp`` > 1 each rank holds its stage's ``L / pp`` layers stacked
  (the JAX ``param_specs(pp > 1)``), the ``pp`` ranks of a line take the
  same batch rows, ``cfg.microbatches`` microbatches go through the
  stages on the gpipe or 1f1b schedule (``parallel/pp.py``), and the
  non-layer gradients are summed over the ``pp`` line before the sync;
* the DENSE gradients (every leaf but ``we1``/``we2``) go through
  ``parallel/dp.py allreduce_gradients`` over the sub-mesh of the data
  axes ``GRAD_AXES + ("ep",)`` = ``("dp", "sp", "ep")`` in that order
  (the JAX ``_data_axes``: the order sets the sum order and the int8/ef8
  rounding; ``rescale_target`` its rank count, ``average=True``, no
  per-element counts) on the configured wire and schedule, the EXPERT
  gradients (ep-rank-owned) over ``GRAD_AXES`` alone with their own
  rescale target; int8/ef8 rounding keys derive from ``(17, step count,
  0)`` for the dense sync and ``(17, step count, 1)`` for the expert
  sync, as the JAX ``derive_quant_key`` and the two syncs' tags do;
* global-norm clipping comes after the sync (it is in the optax chain
  after ``sync_and_metrics``), over the norm of the whole model: the
  squares of the ``tp``, ``ep`` and ``pp`` shards summed over their
  lines;
* the loss metric is the data ranks' losses summed, ``aux_loss`` and
  ``dispatch_fraction`` their mean, ``min_bucket_count`` the smallest
  per-bucket count of either sync;
* the ef8 residual is ``TrainState.residual`` (buckets-shaped f32; for
  an MoE model the two planes ``{"dense", "expert"}``, each riding its
  own sync), threaded through every step;
* with ``dynamic_valid=True`` the step takes the round's contribution
  mask, the JAX ``(n_data_ranks, num_buckets)`` f32 array with rows in
  the dense sync's order (dp-major, then sp, then ep: a rank's row is
  its rank in that sub-mesh; every tp shard and pp stage of a data rank
  sends the same row, the JAX ``P(dense_axes, None)``), and each rank
  hands its own row to the dense sync, after the pp sum of the
  non-layer gradients; masked buckets contribute exact zeros and the
  counts report the gap; the expert sync stays exact
  (``runtime/straggler.py`` builds the masks from deadlines; on the
  hierarchical schedule the rows of one line of its ICI axis must
  agree, which its ``DeadlineTrainer`` holds when given
  :func:`mask_line`).

A sync over one rank is the identity and is skipped, as the JAX step's
reduces over size-1 mesh axes; ``min_bucket_count`` is then 1.

PyTorch idiom in place of the JAX package's pure functions:

* parameters are a nested dict of f32 master tensors with the JAX
  pytree's names and layout (``convert.params_from_jax`` carries them
  across); their leaves require grad;
* the optimizer (:func:`make_optimizer`) is one of the JAX chain's four
  families over two parameter groups, the rank >= 2 leaves with
  ``weight_decay`` and the rest (norm gains) with none: optax's decay
  mask. adamw is ``torch.optim.AdamW``, whose update equals
  ``optax.adamw``'s; lion, adafactor and sgd are ``models/optim.py``'s,
  written from optax's definitions. The step count is
  ``TrainState.step`` for every family (the JAX ``StepCounterState``):
  it keys the LR schedule and the int8/ef8 rounding;
* ``ema_decay`` > 0 keeps ``TrainState.ema``, f32 copies of the masters
  updated after each optimizer step as ``d * ema + (1 - d) * p`` from
  the post-update masters (the JAX ``param_ema``, the chain's last
  slot), the checkpoint's ``ema`` item;
* the step updates the parameters, the optimizer state, the EMA and the
  residual IN PLACE (``TrainState`` holds them) and returns the metrics;
  the JAX step returns new arrays instead;
* ``compute_dtype="bf16"`` runs the model on bf16 copies of the masters;
  autograd casts the gradients back to f32, so the sync and the update
  stay f32;
* ``accum_schedule="overlap"`` syncs each microbatch's gradients as they
  are produced and folds tick k's synced result into the accumulator at
  tick k + 1 (the JAX scan's in-flight carry); the syncs run on the
  current stream, so on the card nothing hides behind the next
  microbatch yet;
* :func:`make_multi_step` runs ``N`` steps a dispatch (the JAX
  ``lax.scan`` chunk) on one rank or many, on any mesh: on the card one
  CUDA graph replay a chunk (across ranks on the ``ipc`` transport; the
  tp sums, the ep exchanges, the pp transfers and the pipeline's
  hand-run backward inside it), on the CPU the same steps in a loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from functools import partial
from typing import Any, Callable, Optional, Union

import torch

from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.convert import shard_params
from akka_allreduce_tpu_torch.models.optim import (SGD, Adafactor, Lion,
                                                   Shard, factored_dims)
from akka_allreduce_tpu_torch.models.transformer import (
    TransformerConfig, init_transformer, lm_logits, next_token_loss_and_aux,
    rmsnorm, transformer_block, weighted_ce)
from akka_allreduce_tpu_torch.ops.bucketing import (
    tree_bucket_spec, tree_leaves, tree_map, tree_unflatten)
from akka_allreduce_tpu_torch.ops.kernels.flash_attention import \
    flash_causal_attention
from akka_allreduce_tpu_torch.ops.kernels.ring_flash import \
    ring_flash_attention
from akka_allreduce_tpu_torch.ops.collectives import psum_allreduce
from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                  allreduce_gradients,
                                                  check_sync_config)
from akka_allreduce_tpu_torch.parallel.group import RankGroup
from akka_allreduce_tpu_torch.parallel.pp import (gpipe_apply, one_f_one_b,
                                                  scan_blocks)
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    blockwise_causal_attention, flash_windowed_sp_attention,
    local_causal_attention, ring_attention, windowed_sp_attention)

OPTIMIZERS = ("adamw", "adafactor", "sgd", "lion")
# the JAX TrainConfig.grad_axes: the axes the expert gradients sync over
# (the dense ones add ep)
GRAD_AXES = ("dp", "sp")
ACCUM_SCHEDULES = ("deferred", "overlap")
# the JAX derive_quant_key's root key, key(17)
QUANT_ROOT = 17


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig`` fields the port uses, with their names and
    defaults. ``bucket_elems`` sizes the gradient buckets of the
    multi-rank sync; ``grad_transport`` (f32 | bf16 | int8 | ef8),
    ``transport_schedule`` (fused | windowed | swing | hierarchical |
    auto) and ``num_windows`` select its wire and schedule;
    ``collective_plan`` is the measured ``CollectivePlan`` that "auto"
    dispatches against (``ops/autotune.py``).
    ``attn_block_size`` serves ``attn_impl="blockwise"`` (the flash
    kernels' tile is their own constant)."""

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
    sgd_momentum: float = 0.9
    grad_accum: int = 1
    accum_schedule: str = "deferred"
    ema_decay: float = 0.0
    attn_impl: str = "auto"
    grad_transport: str = "f32"
    transport_schedule: str = "fused"
    num_windows: int = 4
    collective_plan: Any = None
    # pipeline parallelism (read when the mesh has pp > 1): microbatches a
    # step and the schedule, "gpipe" or "1f1b" (parallel/pp.py)
    microbatches: int = 1
    pp_schedule: str = "gpipe"


@dataclasses.dataclass
class TrainState:
    """Parameters (this rank's shard under tp / ep / pp), their optimizer,
    the ef8 error-feedback residual (None on the other wires; the
    ``{"dense", "expert"}`` planes for an MoE model), the EMA weights
    (None without ``ema_decay``) and the step count (optax's ``count``: the steps taken, which the LR
    schedule and the rounding keys read before it increments). The train
    step mutates them all.

    The step count is kept once: a host int, or with ``count`` (the state
    of a step that a CUDA graph captures, :func:`make_multi_step`) a 0-dim
    int64 tensor on the parameters' device, which the step advances there
    and which indexes ``lr_table`` (the schedule's rates) for the rate.
    ``step`` reads and writes whichever the state keeps; on a device
    count, reading it waits for the device."""

    params: dict
    optimizer: torch.optim.Optimizer
    residual: "torch.Tensor | dict | None" = None
    ema: Optional[dict] = None
    count: Optional[torch.Tensor] = None
    lr_table: Optional[torch.Tensor] = None
    host_count: int = 0

    @property
    def step(self) -> int:
        return self.host_count if self.count is None else int(self.count)

    @step.setter
    def step(self, value: int) -> None:
        if self.count is None:
            self.host_count = int(value)
        else:
            self.count.fill_(int(value))


def sync_config(cfg: TrainConfig, world: int) -> GradSyncConfig:
    """The gradient sync of the step, as the JAX ``make_grad_step``
    builds it."""
    return GradSyncConfig(bucket_elems=cfg.bucket_elems, average=True,
                          rescale_target=float(world),
                          return_elem_counts=False,
                          transport=cfg.grad_transport,
                          transport_schedule=cfg.transport_schedule,
                          num_windows=cfg.num_windows,
                          plan=cfg.collective_plan)


def quant_key(step: int, microbatch: Optional[int] = None,
              tag: int = 0) -> tuple:
    """A sync's rounding key of step ``step``: the JAX
    ``fold_in(fold_in(key(17), step), tag)`` as a key tuple, ``tag`` 0
    for the dense sync and 1 for the expert sync. On the overlapped
    schedule microbatch ``i``'s syncs fold ``i`` in before the tag, as
    the JAX scan does: ``fold_in(fold_in(fold_in(key(17), step), i),
    tag)``."""
    if microbatch is None:
        return (QUANT_ROOT, int(step), int(tag))
    return (QUANT_ROOT, int(step), int(microbatch), int(tag))


def split_expert_leaves(grads: dict) -> tuple:
    """A params-shaped tree -> (dense, expert): the expert leaves
    (``we1``/``we2``, ep-rank-owned, synced over the data axes without
    ``ep``) in a list of per-layer dicts (``{}`` for a dense layer; for
    pp-stacked layers one dict of the stacked leaves), the rest (the
    router included, replicated over ``ep``) in the dense tree."""
    dense = dict(grads)
    if isinstance(grads["layers"], dict):  # pp-stacked
        layers = dict(grads["layers"])
        expert = {k: layers.pop(k) for k in ("we1", "we2") if k in layers}
        dense["layers"] = layers
        return dense, expert
    dense_layers, expert_layers = [], []
    for lyr in grads["layers"]:
        lyr = dict(lyr)
        expert_layers.append({k: lyr.pop(k) for k in ("we1", "we2")
                              if k in lyr})
        dense_layers.append(lyr)
    dense["layers"] = dense_layers
    return dense, expert_layers


def merge_expert_leaves(dense: dict, expert_layers: list) -> dict:
    """The inverse of :func:`split_expert_leaves`."""
    out = dict(dense)
    if isinstance(dense["layers"], dict):
        out["layers"] = {**dense["layers"], **expert_layers}
        return out
    out["layers"] = [{**lyr, **ex}
                     for lyr, ex in zip(dense["layers"], expert_layers)]
    return out


def data_axes(cfg: TrainConfig, group: Optional[RankGroup]) -> tuple:
    """The axes the DENSE gradient sync reduces over: ``GRAD_AXES``,
    plus ``ep`` when the mesh has it (the JAX ``_data_axes``)."""
    has_ep = group is not None and group.axis_size("ep") > 1
    return GRAD_AXES + (("ep",) if has_ep else ())


def sync_groups(cfg: TrainConfig, group: Optional[RankGroup]) -> tuple:
    """(dense, expert) sync groups: the sub-meshes of ``group`` over
    :func:`data_axes` and over ``GRAD_AXES``, in those axis orders (a
    group of one when a sub-mesh has one rank)."""
    if group is None:
        return RankGroup.single(), RankGroup.single()
    return group.over(data_axes(cfg, group)), group.over(GRAD_AXES)


def check_mesh(cfg: TrainConfig, group: Optional[RankGroup]) -> None:
    """Refuse a mesh the model cannot take, as the JAX package does:
    ``ep`` must divide ``n_experts``, ``tp`` the heads, the KV heads
    and ``d_ff``, and ``pp`` the layers, which must be homogeneous
    (MoE only at ``moe_every`` 1); ``pp > 1`` takes no ``grad_accum``
    (its microbatches are ``cfg.microbatches``) and MoE only on the
    gpipe schedule."""
    if group is not None:
        check_mesh_sizes(cfg, group.axis_size("tp"), group.axis_size("ep"),
                         group.axis_size("pp"))


def check_mesh_sizes(cfg: TrainConfig, tp: int, ep: int,
                     pp: int = 1) -> None:
    """:func:`check_mesh` from the ``tp``, ``ep`` and ``pp`` sizes
    alone."""
    mcfg = cfg.model
    if pp > 1:
        if mcfg.n_layers % pp:
            raise ValueError(f"pp={pp} must divide n_layers={mcfg.n_layers}")
        if mcfg.moe is not None and mcfg.moe_every != 1:
            raise ValueError(
                "pipeline stages need homogeneous layers: use moe_every=1 "
                "(all-MoE) or moe=None (all-dense) when pp > 1")
        if cfg.grad_accum > 1:
            raise ValueError(
                "grad_accum > 1 does not compose with pp > 1 — the "
                "pipeline path has its own microbatching "
                "(cfg.microbatches)")
        if cfg.pp_schedule == "1f1b" and mcfg.moe is not None:
            raise ValueError(
                "pp_schedule='1f1b' supports dense layers only (the "
                "fused backward has no aux-loss channel) — use gpipe "
                "for MoE pipelines")
    if mcfg.moe is not None and mcfg.moe.n_experts % ep:
        raise ValueError(f"ep={ep} must divide "
                         f"n_experts={mcfg.moe.n_experts}")
    if mcfg.n_heads % tp or mcfg.d_ff % tp or mcfg.kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={mcfg.n_heads}, "
            f"n_kv_heads={mcfg.kv_heads}, and d_ff={mcfg.d_ff}")


def check_supported(cfg: TrainConfig) -> None:
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}: adamw "
                         f"| adafactor | sgd | lion")
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {cfg.ema_decay}")
    if cfg.accum_schedule not in ACCUM_SCHEDULES:
        raise ValueError(
            f"unknown accum_schedule {cfg.accum_schedule!r}: 'deferred' "
            f"(one sync after the microbatches) or 'overlap' "
            f"(per-microbatch syncs, each folded in one tick later)")
    if cfg.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
    if cfg.compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if cfg.pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {cfg.pp_schedule!r}")
    if cfg.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got "
                         f"{cfg.microbatches}")
    check_sync_config(sync_config(cfg, 1))


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


def lr_table(cfg: TrainConfig, device) -> torch.Tensor:
    """:func:`lr_at` at the counts ``0 .. total_steps`` (one entry for the
    constant schedule) as an f32 tensor on ``device``: the rates of a
    device step count, which reads entry ``min(count, len - 1)`` (every
    count past ``total_steps`` has the last rate)."""
    n = cfg.total_steps + 1 if cfg.lr_schedule != "constant" else 1
    return torch.tensor([lr_at(cfg, c) for c in range(n)],
                        dtype=torch.float32, device=device)


def _stacked(params: dict) -> bool:
    """Whether ``params`` holds pp-stacked layers (a dict of ``(L/pp,
    ...)`` leaves)."""
    return isinstance(params.get("layers"), dict)


def leaf_paths(params: dict) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order) its path: ``(key,)``
    outside the layers, ``("layers", i, name)`` in the list layout and
    ``("layers", name)`` for a stacked leaf."""
    out = []
    for k in sorted(params):
        if k != "layers":
            out += [(k,)] * len(tree_leaves(params[k]))
        elif _stacked(params):
            out += [("layers", n) for n in sorted(params["layers"])]
        else:
            out += [("layers", i, n)
                    for i, layer in enumerate(params["layers"])
                    for n in sorted(layer)]
    return out


def _decays(params: dict) -> list:
    """optax's decay mask per leaf: rank >= 2, a stacked layer leaf
    ranked by its unstacked shape (the JAX ``make_optimizer(...,
    stacked_layers=True)``: a stacked (L, d) norm gain does not
    decay)."""
    return [p.dim() - (len(path) == 2) >= 2
            for p, path in zip(tree_leaves(params), leaf_paths(params))]


def optimizer_order(params: dict, n_groups: int) -> list:
    """The indices (``tree_leaves`` order) of ``params``'s leaves in the
    order of :func:`make_optimizer`'s ``state_dict``: every leaf (sgd,
    one group), or the decayed leaves then the rest."""
    if n_groups == 1:
        return list(range(len(tree_leaves(params))))
    decays = _decays(params)
    return ([i for i, d in enumerate(decays) if d]
            + [i for i, d in enumerate(decays) if not d])


def leaf_splits(params: dict, group: Optional[RankGroup]) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order) the ``(dim, mesh
    axis)`` pairs it is split along on ``group``'s mesh (none outside
    the layers, which every rank holds whole)."""
    return [() if group is None or len(path) == 1 else
            convert.leaf_splits(path[-1], group, stacked=len(path) == 2)
            for path in leaf_paths(params)]


def _global_shape(p: torch.Tensor, splits: tuple,
                  group: RankGroup) -> tuple:
    shape = list(p.shape)
    for dim, axis in splits:
        shape[dim] *= group.axis_size(axis)
    return tuple(shape)


def make_optimizer(cfg: TrainConfig, params: dict,
                   lr: "float | torch.Tensor | None" = None,
                   group: Optional[RankGroup] = None
                   ) -> torch.optim.Optimizer:
    """The family of ``cfg.optimizer`` over ``params`` with optax's decay
    mask (rank >= 2 leaves decay, the rest — norm gains, vectors — do
    not; a pp-stacked layer leaf by its unstacked rank; sgd has no
    decay, as ``optax.sgd``): adamw (b1 0.9, b2 0.999,
    eps 1e-8, ``torch.optim.AdamW``), lion (b1 0.9, b2 0.99), adafactor
    (optax's defaults; ``weight_decay`` 0 is none) or sgd
    (``sgd_momentum``, nesterov when > 0). The learning rate is set per
    step by the train step from :func:`make_lr_schedule`; ``lr`` as a
    0-dim tensor makes it that tensor in every group (shared, and
    written in place): the optimizer of a device step count, on the card
    a step that a CUDA graph captures (adamw is then capturable, which
    PyTorch allows on the card only). ``group``, the rank's mesh, gives
    adafactor the :class:`~akka_allreduce_tpu_torch.models.optim.Shard`
    of each split leaf: its statistics are the whole leaf's."""
    check_supported(cfg)
    if lr is None:
        lr = lr_at(cfg, 0)
    leaves = tree_leaves(params)
    if cfg.optimizer == "sgd":
        return SGD(leaves, lr=lr, momentum=cfg.sgd_momentum)
    decays = _decays(params)
    groups = [{"params": [p for p, d in zip(leaves, decays) if d],
               "weight_decay": cfg.weight_decay},
              {"params": [p for p, d in zip(leaves, decays) if not d],
               "weight_decay": 0.0}]
    if cfg.optimizer == "lion":
        return Lion(groups, lr=lr, betas=(0.9, 0.99))
    if cfg.optimizer == "adafactor":
        shards = {id(p): Shard(_global_shape(p, sp, group), sp, group)
                  for p, sp in zip(leaves, leaf_splits(params, group))
                  if sp}
        return Adafactor(groups, lr=lr, shards=shards)
    extra = {"capturable": True} if (isinstance(lr, torch.Tensor)
                                     and lr.device.type == "cuda") else {}
    return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             **extra)


def load_optimizer_state(state: TrainState, saved: dict) -> None:
    """``state.optimizer.load_state_dict(saved)``; on a device step count
    (``state.count``) the groups keep their shared learning-rate tensor
    and adamw its ``capturable`` setting, with its step counts on the
    parameters' device, whatever the saved groups held."""
    opt = state.optimizer
    lr = opt.param_groups[0]["lr"]
    capturable = opt.param_groups[0].get("capturable")
    opt.load_state_dict(saved)
    if state.count is None:
        return
    for group in opt.param_groups:
        group["lr"] = lr
        if capturable is not None:
            group["capturable"] = capturable
    for per_param in opt.state.values():
        if isinstance(per_param.get("step"), torch.Tensor):
            per_param["step"] = per_param["step"].to(
                state.count.device, torch.float32)


def _leaf_axes(params: dict, group: RankGroup) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order): the mesh axes the
    leaf is split along (a stacked layer leaf's ``pp`` first), ``()``
    for a leaf every rank holds whole."""
    return [tuple(a for _, a in sp) for sp in leaf_splits(params, group)]


def _sum_over(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """The sum of a 0-dim tensor over ``group`` (a host-side gather of
    one float a rank; no kernel)."""
    if group.world == 1:
        return x
    return group.all_gather(x.reshape(1)).sum()


def clip_by_global_norm_(grads: list, max_norm: float,
                         group: Optional[RankGroup] = None,
                         leaf_axes: Optional[list] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: when the global norm is
    not below ``max_norm`` every gradient becomes ``g / norm * max_norm``;
    below it they stay as they are (``clip_grad_norm_`` would instead
    scale by ``max_norm / (norm + 1e-6)`` whenever the ratio is < 1).
    Under tp / ep / pp the norm is the whole model's, as the JAX chain
    takes it on the global arrays: each sharded leaf's squares
    (``leaf_axes``: its axes per leaf, ``()`` for a whole leaf) summed
    over the sub-mesh of its axes (a stacked layer leaf's over ``pp``
    and its tp or ep line). Returns the norm. No host synchronisation on
    one rank."""
    if group is None or leaf_axes is None:
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    else:
        parts: dict = {}
        for g, axes in zip(grads, leaf_axes):
            sq = (g.float() ** 2).sum()
            parts[axes] = sq if axes not in parts else parts[axes] + sq
        norm = torch.sqrt(sum(
            v if not axes else _sum_over(v, group.over(axes))
            for axes, v in parts.items()))
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


def select_ring_attention(cfg: TrainConfig, group: RankGroup):
    """Sequence-parallel attention per ``cfg.attn_impl`` over ``group``'s
    ``sp`` axis. "auto" and "flash" are the ring of flash kernels
    (:func:`ring_flash_attention`: the CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors; the kernels mask a ragged tile,
    so "auto" needs no fallback); "blockwise" and "local" the plain ring
    (:func:`ring_attention`). A sliding window swaps the ring for one
    neighbour exchange: the flash kernels for "auto"/"flash", the plain
    windowed path for "local"; "blockwise" refuses it."""
    impl = cfg.attn_impl
    if impl not in ("auto", "flash", "blockwise", "local"):
        raise ValueError(f"unknown attn_impl {impl!r}")
    window = cfg.model.attn_window
    if window is not None:
        if impl == "blockwise":
            raise ValueError(
                "attn_impl='blockwise' does not support attn_window "
                "(same contract as sp=1); use 'auto', 'flash', or "
                "'local'")
        if impl in ("auto", "flash"):
            return partial(flash_windowed_sp_attention, window=window,
                           group=group)
        return partial(windowed_sp_attention, window=window, group=group)
    if impl in ("auto", "flash"):
        return partial(ring_flash_attention, group=group, causal=True)
    return partial(ring_attention, group=group, causal=True)


def _zero_plane(tree, bucket_elems: int, device) -> torch.Tensor:
    spec = tree_bucket_spec(tree, bucket_elems)
    return torch.zeros((spec.num_buckets, spec.bucket_elems),
                       dtype=torch.float32, device=device)


def make_train_state(cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[dict] = None,
                     device: "torch.device | str | None" = None,
                     device_step: bool = False,
                     group: Optional[RankGroup] = None) -> TrainState:
    """Parameters (``params``, or random from ``generator``: the full
    tree either way; on a pp mesh the rank's stage's layers stacked, the
    JAX ``param_specs(pp > 1)`` layout) as leaves that require grad,
    their optimizer, on
    the ef8 wire a zero residual of the bucket matrix's shape (the JAX
    ``init_ef_state``; an MoE model's is the ``{"dense", "expert"}``
    planes, one per sync), and with ``ema_decay`` the EMA as a copy of
    the initial masters (the JAX ``param_ema`` init). On a mesh
    ``group`` with tp, ep or pp > 1 the rank keeps its shard of the full
    tree (``convert.shard_params``). ``device_step`` keeps the step
    count on the parameters' device (``TrainState.count``) with the
    schedule's rates beside it, and the optimizer's learning rate as a
    tensor there: the state of :func:`make_multi_step`'s chunks."""
    check_mesh(cfg, group)
    if params is None:
        if generator is None:
            raise ValueError("make_train_state needs params or a generator")
        tp = 1 if group is None else group.axis_size("tp")
        params = init_transformer(generator, cfg.model, device, tp=tp)
    elif device is not None:
        params = tree_map(lambda p: p.to(device), params)
    if is_sharded(group):
        params = shard_params(params, cfg.model, group)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    where = tree_leaves(params)[0].device
    residual = None
    if cfg.grad_transport == "ef8":
        if cfg.model.moe is None:
            residual = _zero_plane(params, cfg.bucket_elems, where)
        else:
            dense, expert = split_expert_leaves(params)
            residual = {"dense": _zero_plane(dense, cfg.bucket_elems, where),
                        "expert": _zero_plane(expert, cfg.bucket_elems,
                                              where)}
    ema = None
    if cfg.ema_decay > 0:
        ema = tree_map(lambda p: p.detach().clone().float(), params)
    count, table, lr = None, None, None
    if device_step:
        count = torch.zeros((), dtype=torch.int64, device=where)
        table = lr_table(cfg, where)
        lr = table[0].clone()
    return TrainState(params=params,
                      optimizer=make_optimizer(cfg, params, lr, group),
                      residual=residual, ema=ema, count=count,
                      lr_table=table)


def is_sharded(group: Optional[RankGroup]) -> bool:
    """Whether ``group``'s ranks hold shards of the model (tp, ep or pp >
    1)."""
    return group is not None and any(group.axis_size(a) > 1
                                     for a in ("tp", "ep", "pp"))


def _state_splits(key: str, splits: tuple, shape: tuple) -> tuple:
    """The splits of the optimizer state tensor ``key`` of a leaf of whole
    shape ``shape`` split along ``splits``: the leaf's, except
    adafactor's ``v_row`` / ``v_col``, which lose their reduced dim (a
    split along it is summed away: every rank of that line holds the
    whole statistic)."""
    if key not in ("v_row", "v_col"):
        return splits
    d1, d0 = factored_dims(shape)
    gone = d0 if key == "v_row" else d1
    return tuple((d - (d > gone), a) for d, a in splits if d != gone)


def _opt_groups(saved: dict, like: dict) -> list:
    """``saved``'s param groups with their parameter indices those of
    :func:`make_optimizer` over ``like``."""
    n = len(tree_leaves(like))
    sizes = [n]
    if len(saved["param_groups"]) == 2:
        sizes = [sum(_decays(like)), n - sum(_decays(like))]
    out, j = [], 0
    for g, size in zip(saved["param_groups"], sizes):
        out.append({**g, "params": list(range(j, j + size))})
        j += size
    return out


def _list_layout_like(params: dict, n_layers: int) -> dict:
    """A stand-in of the full list-layout tree of a rank's ``params``,
    for the optimizer's order (which reads the leaves' ranks): a stacked
    leaf's first layer, once a layer."""
    if not _stacked(params):
        return params
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v[0] for k, v in params["layers"].items()}
                     for _ in range(n_layers)]
    return out


def full_layout(state: TrainState, group: RankGroup) -> tuple:
    """(params, optimizer state dict, EMA) of a tp / ep / pp rank in the
    full, unsharded list layout (``convert.gather_splits``; pp-stacked
    layers gathered over ``pp`` and unstacked, their moments too), as
    the JAX package's checkpoint of its global arrays holds them at pp =
    1; the state dict is the one :func:`make_optimizer` makes over the
    full tree. A collective over the mesh: every rank calls it; every
    rank gets the full trees."""
    params = state.params
    leaves, paths = tree_leaves(params), leaf_paths(params)
    splits = leaf_splits(params, group)
    saved = state.optimizer.state_dict()
    order = optimizer_order(params, len(saved["param_groups"]))
    per_leaf = [{}] * len(leaves)
    for j, i in enumerate(order):
        per_leaf[i] = saved["state"].get(j, {})
    by_path: dict = {}
    for i, per in enumerate(per_leaf):
        shape = _global_shape(leaves[i], splits[i], group)
        full = {k: convert.gather_splits(
                    v, _state_splits(k, splits[i], shape), group)
                if isinstance(v, torch.Tensor) and v.dim() else v
                for k, v in per.items()}
        if len(paths[i]) != 2:
            by_path[paths[i]] = full
            continue
        for layer in range(shape[0]):  # a stacked leaf: its layers
            by_path[("layers", layer, paths[i][1])] = {
                k: v[layer].clone() if isinstance(v, torch.Tensor)
                and v.dim() else v for k, v in full.items()}
    full_params = convert.gather_tree(params, group)
    full_order = optimizer_order(full_params, len(saved["param_groups"]))
    full_paths = leaf_paths(full_params)
    opt = {"state": {j: by_path[full_paths[i]]
                     for j, i in enumerate(full_order)
                     if by_path[full_paths[i]]},
           "param_groups": _opt_groups(saved, full_params)}
    ema = None if state.ema is None else convert.gather_tree(state.ema, group)
    return full_params, opt, ema


def shard_optimizer_state(state: TrainState, saved: dict,
                          group: RankGroup) -> dict:
    """A full-layout optimizer ``state_dict`` (:func:`full_layout`) ->
    this rank's, for ``load_optimizer_state``: each leaf's moments cut
    to its block, a pp stage's layers' moments stacked."""
    params = state.params
    leaves, paths = tree_leaves(params), leaf_paths(params)
    splits = leaf_splits(params, group)
    n_groups = len(saved["param_groups"])
    n_layers = None
    if _stacked(params):
        n_layers = (next(iter(params["layers"].values())).shape[0]
                    * group.axis_size("pp"))
    like = _list_layout_like(params, n_layers)
    full_paths = leaf_paths(like)
    by_path = {full_paths[i]: saved["state"].get(j, {})
               for j, i in enumerate(optimizer_order(like, n_groups))}
    mine: list = []
    for i, path in enumerate(paths):
        shape = _global_shape(leaves[i], splits[i], group)
        if len(path) == 2:  # stacked: this stage's layers
            layer_states = [by_path[("layers", layer, path[1])]
                            for layer in convert.stage_layers(n_layers,
                                                              group)]
            per = {k: torch.stack([s_[k] for s_ in layer_states])
                   if isinstance(v, torch.Tensor) and v.dim() else v
                   for k, v in layer_states[0].items()}
        else:
            per = by_path[path]
        mine.append({k: convert.narrow_splits(
            v, tuple(sp for sp in _state_splits(k, splits[i], shape)
                     if sp[1] != "pp" or len(path) != 2), group)
            if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in per.items()})
    order = optimizer_order(params, n_groups)
    return {"state": {j: mine[i] for j, i in enumerate(order) if mine[i]},
            "param_groups": _opt_groups(saved, params)}


@torch.no_grad()
def update_ema(ema: dict, params: dict, decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * p`` leaf by leaf, in place,
    rounded as the JAX ``param_ema`` rounds it (each product, then the
    sum; ``lerp_`` would round ``ema + (1 - d) (p - ema)`` instead)."""
    for e, p in zip(tree_leaves(ema), tree_leaves(params)):
        e.mul_(decay).add_(p * (1.0 - decay))


def _timer_mark(device: torch.device):
    """A point in time on ``device``'s clock: a recorded CUDA event, or
    the host clock on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_ms(start, end) -> float:
    """Milliseconds between two :func:`_timer_mark` marks (waits for a
    CUDA end event)."""
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def data_rank_count(cfg: TrainConfig, group: Optional[RankGroup] = None
                    ) -> int:
    """How many data ranks contribute to the dense gradient sync: the row
    count of a dynamic ``valid`` mask (dp x sp, x ep when the mesh has
    it; rows in that order, dp-major)."""
    return sync_groups(cfg, group)[0].world


def dense_bucket_count(cfg: TrainConfig, params: dict) -> int:
    """Bucket count of the rank-local dense gradient tree (this rank's
    shard; an MoE model's without the expert leaves): the column count
    of a dynamic ``valid`` mask and the dense ef8 plane's row count."""
    if _has_experts(params):
        params = split_expert_leaves(params)[0]
    return tree_bucket_spec(params, cfg.bucket_elems).num_buckets


def _has_experts(params: dict) -> bool:
    """Whether ``params`` (the list layout or a pp stage's stacked
    layers) holds expert leaves."""
    if _stacked(params):
        return "we1" in params["layers"]
    return any("we1" in layer for layer in params["layers"])


def expert_bucket_count(cfg: TrainConfig, params: dict) -> int:
    """Bucket count of the rank-local expert gradient tree (the ep-owned
    ``we1``/``we2``): the expert ef8 plane's row count."""
    if not _has_experts(params):
        raise ValueError("expert_bucket_count needs an MoE model")
    return tree_bucket_spec(split_expert_leaves(params)[1],
                            cfg.bucket_elems).num_buckets


def _mask_row(valid, rank: int, world: int, device: torch.device
              ) -> torch.Tensor:
    """This rank's row of the round's ``(world, num_buckets)`` mask, as
    f32 on ``device`` (one copy a round)."""
    valid = torch.as_tensor(valid, dtype=torch.float32)
    if valid.dim() != 2 or valid.shape[0] != world:
        raise ValueError(f"valid must be (n_data_ranks={world}, "
                         f"num_buckets), got {tuple(valid.shape)}")
    return valid[rank].to(device)


def mask_line(cfg: TrainConfig, group: Optional[RankGroup]) -> int:
    """How many consecutive data ranks must share a round's mask row: on
    the hierarchical schedule (ef8 over two live data axes, flagged, or
    "auto", whose only arm and fallback there is hierarchical) the size
    of the dense group's last live axis, the line its exact ICI leg runs
    on (``parallel/dp.py``: ``sp`` at dp x sp, ``ep`` at dp x ep or sp x
    ep), whose masks must agree; else 1."""
    if (group is None or cfg.grad_transport != "ef8"
            or cfg.transport_schedule not in ("hierarchical", "auto")):
        return 1
    live = [a for a in data_axes(cfg, group) if group.axis_size(a) > 1]
    return group.axis_size(live[-1]) if len(live) == 2 else 1


def fold_in_flight(acc: Optional[list], fly: list) -> list:
    """The overlapped schedule's last fold: the accumulated synced
    gradients plus the last tick's in-flight result."""
    return fly if acc is None else [a + f for a, f in zip(acc, fly)]


def make_grad_step(cfg: TrainConfig, group: Optional[RankGroup] = None,
                   sync_times: Optional[list] = None,
                   dynamic_valid: bool = False):
    """``grad_step(params, tokens, quant_seed=None, residual=None,
    valid=None) -> (grads, metrics)`` (``(grads, metrics, residual)`` on
    the ef8 wire):
    the next-token loss over this rank's tokens (B, T) (the last column
    has weight 0, as in the JAX step without sequence parallelism), its
    gradients synced across ``group`` as a params-shaped dict of f32
    tensors, and the JAX step's metrics. With ``grad_accum`` K > 1 the
    batch splits into K microbatches whose gradients and losses sum (each
    scaled by the whole batch's token count), aux terms averaged: on the
    JAX "deferred" schedule one sync after the last microbatch, on
    "overlap" one sync a microbatch (keys :func:`quant_key` with the
    microbatch, the ef8 residual threaded from tick to tick, the mask row
    the same on every tick, ``min_bucket_count`` the smallest over the
    ticks), each result folded in one tick after its sync.
    ``quant_seed`` (the step count) keys the int8/ef8 rounding;
    ``residual`` is the ef8 state. ``sync_times``, when given, receives
    a ``(start, end)`` pair of time marks around each sync
    (:func:`elapsed_ms`). With ``sp`` > 1 in ``group`` the tokens are
    this rank's sequence columns (see the module docstring).

    ``dynamic_valid=True`` makes ``valid`` required: the round's
    ``(data_rank_count, num_buckets)`` f32 mask, of which this rank
    sends its own row (its rank in the dense sync's order; every tp
    shard and pp stage of a data rank the same row) to the dense sync;
    a new mask every round changes nothing else, and an MoE model's
    expert sync stays exact. ``min_bucket_count`` is then the smallest
    count over the buckets of both syncs, exact on every rank.

    On a mesh with tp / ep (see the module docstring) ``params`` are this
    rank's shard, the tokens its rows of the batch (sharded over ``(dp,
    ep)``), and the returned gradients its shard's.

    With ``pp > 1`` (the JAX ``grad_local_pp`` / ``grad_local_1f1b``)
    ``params`` hold the rank's stage, its layers stacked, and the batch
    splits into ``cfg.microbatches`` microbatches that flow through the
    stages (``parallel/pp.py``: ``gpipe_apply`` and its written-out
    backward, or ``one_f_one_b``); each rank of a ``pp`` line takes the
    same tokens. The loss is the last stage's cross-entropy plus each
    stage's MoE aux term, the embedding's gradient comes from stage 0
    and the head's from the last, and the non-layer gradients are summed
    over the ``pp`` line (one flat buffer, ``psum_allreduce``) before the
    dense sync. The metrics sum over the data axes and ``pp``;
    ``dispatch_fraction`` is the mean over the MoE layers and ranks.
    gpipe takes its gradients in the compute dtype's cast once a step
    (every tick's added in f32); 1f1b casts inside its stage, embedding
    and head, so the gradients reach the f32 masters through the cast,
    as JAX's do."""
    check_supported(cfg)
    mcfg = cfg.model
    check_mesh(cfg, group)
    has_sp = group is not None and group.axis_size("sp") > 1
    attn = (select_ring_attention(cfg, group) if has_sp
            else select_local_attention(cfg))
    accum = cfg.grad_accum
    # the dense sync over ("dp", "sp", "ep"), the expert sync over
    # GRAD_AXES; tp ranks hold different shards and sync nothing
    dense_group, expert_group = sync_groups(cfg, group)
    n_dense = dense_group.world
    has_moe = mcfg.moe is not None
    tp_group = None if group is None else group.along("tp")
    ep_group = None if group is None else group.along("ep")
    gcfg = sync_config(cfg, n_dense)
    gcfg_expert = sync_config(cfg, expert_group.world)
    quantized = cfg.grad_transport in ("int8", "ef8")
    use_ef = cfg.grad_transport == "ef8"
    # a sync over one rank is the identity, skipped as the JAX step's
    # reduce over size-1 axes is
    wide = n_dense > 1 or (has_moe and expert_group.world > 1)
    n_pp = 1 if group is None else group.axis_size("pp")
    # the metrics' sum: the data axes, and pp, whose stages hold the loss
    # and the aux terms of their own layers
    metric_group = (group.over(data_axes(cfg, group) + ("pp",)) if n_pp > 1
                    else dense_group)

    def cast_compute(params):
        if cfg.compute_dtype == "f32":
            return params
        return tree_map(lambda p: p.to(torch.bfloat16)
                        if p.dtype == torch.float32 else p, params)

    def targets_and_weights(tokens):
        """Next-token targets, loss weights and positions of this rank's
        (B, T) tokens; under sp the boundary target comes from the right
        neighbour and only the global final position has weight 0."""
        b, t = tokens.shape
        weights = torch.ones((b, t), device=tokens.device)
        if not has_sp:
            targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
            weights[:, -1] = 0.0
            return targets, weights, torch.arange(t, device=tokens.device)
        n_sp, sp_idx = group.axis_size("sp"), group.axis_index("sp")
        positions = sp_idx * t + torch.arange(t, device=tokens.device)
        next_first = group.ppermute(tokens[:, :1].contiguous(), "sp", -1)
        targets = torch.cat([tokens[:, 1:], next_first], dim=1)
        if sp_idx == n_sp - 1:
            weights[:, -1] = 0.0
        return targets, weights, positions

    def microbatch_grads(params, tokens):
        """Yield each microbatch's (loss, aux, grads list) in order; the
        first item is the global token count."""
        b, _ = tokens.shape
        targets, weights, positions = targets_and_weights(tokens)
        # the global count: the weights summed over the data ranks
        total_count = weights.sum()
        if n_dense > 1:
            total_count = dense_group.all_gather(total_count[None]).sum()
        yield total_count
        leaves = tree_leaves(params)
        if b % accum:
            raise ValueError(f"local batch {b} must divide into "
                             f"grad_accum={accum} microbatches")
        for tok, tgt, w in zip(tokens.chunk(accum), targets.chunk(accum),
                               weights.chunk(accum)):
            loss_sum, _, mb_aux = next_token_loss_and_aux(
                cast_compute(params), tok, mcfg, positions, attn,
                targets=tgt, weights=w, remat=cfg.remat,
                tp_group=tp_group, ep_group=ep_group)
            mb_loss = loss_sum / total_count
            grads = list(torch.autograd.grad(mb_loss, leaves))
            yield (mb_loss.detach(),
                   {k: torch.as_tensor(v).detach() for k, v in mb_aux.items()},
                   grads)

    def block(layer, h, positions):
        if cfg.remat:
            return torch.utils.checkpoint.checkpoint(
                transformer_block, layer, h, mcfg, attn, positions,
                tp_group, ep_group, use_reentrant=False)
        return transformer_block(layer, h, mcfg, attn, positions, tp_group,
                                 ep_group)

    def embed(top, tokens, positions):
        x = top["embed"][tokens]
        if not mcfg.rope:
            x = x + top["pos"][positions]
        return x

    def pipelined_grads(params, tokens):
        """The pp step's (total count, loss, aux, grads list): the stages
        on ``cfg.microbatches`` microbatches, the non-layer gradients
        summed over the pp line."""
        targets, weights, positions = targets_and_weights(tokens)
        total_count = weights.sum()
        if n_dense > 1:
            total_count = dense_group.all_gather(total_count[None]).sum()
        m = cfg.microbatches
        b, t = tokens.shape
        if b % m:
            raise ValueError(f"local batch {b} must divide into "
                             f"microbatches={m}")
        first = group.axis_index("pp") == 0
        last = group.axis_index("pp") == n_pp - 1
        top = {k: params[k] for k in params if k != "layers"}
        top_leaves = tree_leaves(top)
        stage_block = partial(block, positions=positions)
        zero = torch.zeros((), device=tokens.device)
        if cfg.pp_schedule == "1f1b":
            tgt_m = targets.reshape(m, b // m, t)
            w_m = weights.reshape(m, b // m, t)

            def head_fn(top_p, h, mb):
                pc = cast_compute(top_p)
                logits = lm_logits(pc, rmsnorm(h, pc["out_norm"]), mcfg)
                return weighted_ce(logits, tgt_m[mb], w_m[mb])[0] \
                    / total_count

            loss, d_stage, d_top = one_f_one_b(
                params["layers"], top, tokens.reshape(m, b // m, t),
                lambda st, h: scan_blocks(cast_compute(st), h,
                                          stage_block)[0],
                lambda top_p, tok: embed(cast_compute(top_p), tok,
                                         positions),
                head_fn, group, "pp")
            d_top = tree_leaves(d_top)
            aux = {"aux_loss": zero, "dispatch_fraction": zero + 1.0}
        else:
            pc = cast_compute(params)
            top_c = {k: pc[k] for k in top}
            if first:
                x = embed(top_c, tokens, positions)
            else:  # only stage 0's microbatches are read
                x = torch.zeros((b, t, mcfg.d_model),
                                dtype=pc["layers"]["ln1"].dtype,
                                device=tokens.device)
            xm = x.reshape(m, b // m, t, x.shape[-1])
            run = gpipe_apply(pc["layers"], xm,
                              lambda st, h: scan_blocks(st, h, stage_block),
                              group, "pp")
            local = zero
            if "aux_loss" in run.aux:
                # each stage owns its layers' load-balance term
                local = local + run.aux["aux_loss"] * weights.sum()
            if last:
                h = run.outputs.reshape(b, t, -1)
                logits = lm_logits(top_c, rmsnorm(h, top_c["out_norm"]),
                                   mcfg)
                local = local + weighted_ce(logits, targets, weights)[0]
            loss = local / total_count
            aux_keys = [k for k, v in run.aux.items() if v.requires_grad]
            wrt = (top_leaves + ([run.outputs] if last else [])
                   + [run.aux[k] for k in aux_keys])
            grads = (torch.autograd.grad(loss, wrt, allow_unused=True)
                     if loss.requires_grad else [None] * len(wrt))
            n_top = len(top_leaves)
            d_top = list(grads[:n_top])
            d_aux = dict(zip(aux_keys, grads[n_top + int(last):]))
            d_stage, d_x = run.backward(grads[n_top] if last else None,
                                        d_aux)
            if first:
                emb = torch.autograd.grad(xm, top_leaves, d_x.to(xm.dtype),
                                          allow_unused=True)
                d_top = [e if d is None else d if e is None else d + e
                         for d, e in zip(d_top, emb)]
            d_top = [torch.zeros_like(p) if d is None else d
                     for d, p in zip(d_top, top_leaves)]
            aux = {"aux_loss": run.aux.get("aux_loss", zero).detach(),
                   # the mean over this stage's MoE layers
                   "dispatch_fraction": run.aux["dispatch_fraction"].detach()
                   / (mcfg.n_layers // n_pp)
                   if "dispatch_fraction" in run.aux else zero + 1.0}
        # the embedding's gradient is stage 0's, the head's the last
        # stage's: every stage's summed over the pp line, one flat
        # buffer (the JAX psum over pp of the non-layer leaves)
        flat = torch.cat([g.reshape(-1).float() for g in d_top])
        flat = psum_allreduce(flat, group.along("pp"))
        d_top = list(torch.split(flat, [g.numel() for g in d_top]))
        d_top = [g.reshape(p.shape) for g, p in zip(d_top, top_leaves)]
        grads = {**tree_unflatten(top, d_top), "layers": d_stage}
        return total_count, loss.detach(), aux, tree_leaves(grads)

    def sync_plane(tree, config, plane_group, key, residual, row):
        """One sync of a gradient tree: (synced tree, its smallest bucket
        count, the residual); over one rank without a mask, the tree
        itself, count 1."""
        if plane_group.world == 1 and row is None:
            return tree, torch.ones((), dtype=torch.int32,
                                    device=tree_leaves(tree)[0].device), \
                residual
        res = allreduce_gradients(tree, config, plane_group, valid=row,
                                  quant_key=key, residual=residual)
        return res.grads, res.bucket_counts.min(), res.residual

    def sync(params, grads, step_seed, microbatch, residual, row):
        """The step's syncs of a grads list: (synced list, the smallest
        bucket count, the residual). An MoE model's dense and expert
        leaves go through their own syncs, keys and residual planes;
        the mask rides the dense sync alone (an ep-owned expert has no
        replica to stand in for it)."""
        device = grads[0].device
        # a sync that a CUDA graph captures is not timed
        timed = sync_times is not None and not (
            device.type == "cuda" and torch.cuda.is_current_stream_capturing())
        start = _timer_mark(device) if timed else None
        keys = [quant_key(step_seed, microbatch, tag) if quantized else None
                for tag in (0, 1)]
        tree = tree_unflatten(params, grads)
        if not has_moe:
            out, count, residual = sync_plane(tree, gcfg, dense_group,
                                              keys[0], residual, row)
        else:
            dense, expert = split_expert_leaves(tree)
            d_out, d_count, d_res = sync_plane(
                dense, gcfg, dense_group, keys[0],
                residual["dense"] if use_ef else None, row)
            e_out, e_count, e_res = sync_plane(
                expert, gcfg_expert, expert_group, keys[1],
                residual["expert"] if use_ef else None, None)
            out = merge_expert_leaves(d_out, e_out)
            count = torch.minimum(d_count, e_count)
            residual = ({"dense": d_res, "expert": e_res} if use_ef
                        else None)
        if timed:
            sync_times.append((start, _timer_mark(device)))
        return tree_leaves(out), count, residual

    def grad_step(params, tokens, quant_seed=None, residual=None,
                  valid=None):
        if dynamic_valid and valid is None:
            raise ValueError("dynamic_valid step needs a per-round "
                             "valid mask (n_data_ranks, num_buckets)")
        if valid is not None and not dynamic_valid:
            raise ValueError("valid needs make_grad_step(..., "
                             "dynamic_valid=True)")
        if wide and quantized and quant_seed is None:
            raise ValueError(f"{cfg.grad_transport} grad transport needs a "
                             f"per-round quant_seed")
        if wide and use_ef and residual is None:
            raise ValueError(
                "ef8 grad transport needs the error-feedback state "
                "(TrainState.residual, from make_train_state): dropping it "
                "silently degrades ef8 to plain block-int8")
        # one rank with a mask still masks (the JAX sync over size-1
        # axes); without one its sync is the identity and is skipped
        synced = wide or valid is not None
        # the round's mask row (this rank's in the dense sync's order):
        # the same on every tick of the overlap
        row = None if valid is None else _mask_row(
            valid, dense_group.rank, n_dense, tokens.device)
        overlap = (synced and cfg.accum_schedule == "overlap"
                   and n_pp == 1)
        loss, aux, grads, fly, min_count = 0.0, None, None, None, None
        if n_pp > 1:
            total_count, loss, aux, grads = pipelined_grads(params, tokens)
            parts = ()
        else:
            parts = microbatch_grads(params, tokens)
            total_count = next(parts)
        for i, (mb_loss, mb_aux, mb_grads) in enumerate(parts):
            loss = loss + mb_loss
            aux = mb_aux if aux is None else {
                k: aux[k] + mb_aux[k] for k in aux}
            if not overlap:
                grads = mb_grads if grads is None else [
                    g + m for g, m in zip(grads, mb_grads)]
                continue
            # each microbatch synced as produced, with its own rounding
            # key and the residual threaded through; the previous tick's
            # in-flight result is folded in only now
            out, count, residual = sync(params, mb_grads, quant_seed, i,
                                        residual, row)
            if fly is not None:
                grads = fly if grads is None else [
                    g + f for g, f in zip(grads, fly)]
            fly = out
            min_count = count if min_count is None else torch.minimum(
                min_count, count)
        if overlap:
            grads = fold_in_flight(grads, fly)
        elif synced:
            grads, min_count, residual = sync(params, grads, quant_seed,
                                              None, residual, row)
        else:
            min_count = torch.ones((), dtype=torch.int32,
                                   device=tokens.device)
        # aux terms are per-microbatch diagnostics: the mean
        aux_loss = aux["aux_loss"] / accum
        dispatch = aux["dispatch_fraction"] / accum
        if metric_group.world > 1:
            # the metrics' psum over the data axes (and pp): the ranks'
            # (loss, aux, dispatch) summed, the aux terms over the data
            # rank count, dispatch also over the stages
            mine = torch.stack([torch.as_tensor(loss), aux_loss, dispatch])
            loss, aux_loss, dispatch = metric_group.all_gather(
                mine.float()[None]).sum(dim=0)
            aux_loss = aux_loss / n_dense
            dispatch = dispatch / (n_dense * n_pp)
        metrics = {"loss": loss, "tokens": total_count,
                   "min_bucket_count": min_count, "aux_loss": aux_loss,
                   "dispatch_fraction": dispatch}
        grads = tree_unflatten(params, grads)
        if use_ef:
            return grads, metrics, residual
        return grads, metrics

    return grad_step


def apply_update(cfg: TrainConfig, state: TrainState, grads: list,
                 group: Optional[RankGroup] = None) -> None:
    """The optax chain after the sync, in place: global-norm clip
    (``clip_norm > 0``; over the whole model's norm on a tp / ep / pp mesh
    ``group``), the family's update at the schedule's rate for the step
    count, then the EMA of the post-update masters; then the count
    advances. On a device count (``state.count``) the rate is the
    count's entry of ``state.lr_table``, copied into the groups' shared
    rate tensor, and the count advances on the device: no host code reads
    or writes a value, so a CUDA graph can capture the update."""
    if cfg.clip_norm > 0:
        sharded = is_sharded(group)
        clip_by_global_norm_(grads, cfg.clip_norm,
                             group if sharded else None,
                             _leaf_axes(state.params, group) if sharded
                             else None)
    opt = state.optimizer
    if state.count is None:
        lr = lr_at(cfg, state.host_count)
        for pgroup in opt.param_groups:
            pgroup["lr"] = lr
    else:
        # take, not table[count]: a tensor index would be read back to
        # the host
        table = state.lr_table
        opt.param_groups[0]["lr"].copy_(torch.take(
            table, state.count.clamp(max=table.numel() - 1)))
    for p, g in zip(tree_leaves(state.params), grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)
    if state.ema is not None:
        update_ema(state.ema, state.params, cfg.ema_decay)
    if state.count is None:
        state.host_count += 1
    else:
        state.count.add_(1)


def make_train_step(cfg: TrainConfig, group: Optional[RankGroup] = None,
                    sync_times: Optional[list] = None,
                    dynamic_valid: bool = False):
    """``step(state, tokens) -> metrics``: synced gradients (keyed by
    ``state.step``), then :func:`apply_update` (clip, the optimizer at
    the schedule's rate for ``state.step``, the EMA) applied to ``state``
    in place. With ``dynamic_valid=True`` it is ``step(state, tokens,
    valid) -> metrics``, ``valid`` the round's ``(data_rank_count,
    num_buckets)`` mask (:func:`make_grad_step`); a masked round still
    advances ``state.step``, which keys the next round's rounding as the
    JAX optimizer's count does. The step count is read on the host only
    where a sync rounds by it (an int8 or ef8 wire that syncs), so a step
    of one rank reads nothing back; ``host_step`` gives that count
    instead (a step that a CUDA graph captures reads nothing back)."""
    grad_step = make_grad_step(cfg, group, sync_times, dynamic_valid)
    use_ef = cfg.grad_transport == "ef8"
    dense_group, expert_group = sync_groups(cfg, group)
    keyed = cfg.grad_transport in ("int8", "ef8") and (
        dense_group.world > 1 or dynamic_valid
        or (cfg.model.moe is not None and expert_group.world > 1))

    def step(state: TrainState, tokens: torch.Tensor, valid=None,
             host_step: Optional[int] = None) -> dict:
        if keyed:
            seed = state.step if host_step is None else host_step
        out = grad_step(state.params, tokens,
                        quant_seed=seed if keyed else None,
                        residual=state.residual, valid=valid)
        grads, metrics = out[0], out[1]
        if use_ef:
            # in place: a CUDA graph that captured the step reads and
            # writes the state's own residual on every replay
            with torch.no_grad():
                for live, new in zip(tree_leaves(state.residual),
                                     tree_leaves(out[2])):
                    live.copy_(new)
        apply_update(cfg, state, tree_leaves(grads), group)
        return metrics

    return step


# the kernel wrappers' launch counters that a captured chunk's replays
# add to: module (under ops/kernels) -> its counters
_COUNTERS = {
    "flash_attention": ("FLASH_FWD_LAUNCHES", "FLASH_DQ_LAUNCHES",
                        "FLASH_DKV_LAUNCHES"),
    "ring_flash": ("RING_FWD_LAUNCHES", "RING_DQ_LAUNCHES",
                   "RING_DKV_LAUNCHES"),
    "masked_reduce": ("MASKED_REDUCE_LAUNCHES",),
    "quantized": ("QUANTIZE_INT8_LAUNCHES", "DEQUANTIZE_INT8_LAUNCHES",
                  "QUANTIZE_INT8_PRNG_LAUNCHES",
                  "QUANTIZE_INT8_BLOCK_LAUNCHES",
                  "QUANTIZE_INT8_BLOCK_RTN_LAUNCHES",
                  "DEQUANTIZE_INT8_BLOCK_LAUNCHES")}


def _launch_counters() -> dict:
    """Each kernel wrapper's launch counter by the name the reports give
    it (``flash_fwd`` is ``flash_attention.FLASH_FWD_LAUNCHES``):
    ``(module, attribute)``."""
    from akka_allreduce_tpu_torch.ops.kernels import (flash_attention,
                                                      masked_reduce,
                                                      quantized, ring_flash)
    modules = {"flash_attention": flash_attention, "ring_flash": ring_flash,
               "masked_reduce": masked_reduce, "quantized": quantized}
    return {attr.removesuffix("_LAUNCHES").lower(): (modules[m], attr)
            for m, attrs in _COUNTERS.items() for attr in attrs}


def _launch_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _launch_counters().items()}


def _add_launch_counts(counts: dict, sign: int = 1) -> None:
    counters = _launch_counters()
    for name, n in counts.items():
        mod, attr = counters[name]
        setattr(mod, attr, getattr(mod, attr) + sign * n)


def _state_tensors(state: TrainState) -> list:
    """The tensors a train step writes outside the optimizer: masters,
    EMA, residual and device count."""
    out = list(tree_leaves(state.params))
    if state.ema is not None:
        out += tree_leaves(state.ema)
    if state.residual is not None:
        out += tree_leaves(state.residual)
    return out + ([] if state.count is None else [state.count])


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> list:
    return [v for per_param in optimizer.state.values()
            for v in per_param.values() if isinstance(v, torch.Tensor)]


class _MultiStep:
    """:func:`make_multi_step`'s chunk runner."""

    def __init__(self, cfg: TrainConfig, n: int,
                 group: Optional[RankGroup] = None):
        if n < 1:
            raise ValueError(f"steps per dispatch must be >= 1, got {n}")
        self.cfg, self.n, self.group = cfg, n, group
        self.ranks = group is not None and group.world > 1
        self._step = make_train_step(cfg, group)
        # (graph, token buffer, stacked metrics, the transport's capture
        # record, the chunk's rounding keys)
        self._captured = None
        self._state: Optional[TrainState] = None  # the one it captured
        # the kernel launches one replay makes (by kernel), the replays
        # so far, the capture's seconds and each replay's boundary ms
        self.captured_launches: Optional[dict] = None
        self.replays = 0
        self.capture_seconds: Optional[float] = None
        self.boundary_ms: list = []

    @property
    def transport(self):
        """The transport's capture record (``transport.Captured``: calls,
        stream waits and copies a replay), or None."""
        return None if self._captured is None else self._captured[3]

    def close(self) -> None:
        """Release the captured graph and its memory pool (the chunk's
        key generators hold the graph, so dropping the runner alone may
        not free it); the next full chunk captures anew."""
        if self._captured is not None:
            self._captured[0].reset()
        self._captured, self._state = None, None

    def __call__(self, state: TrainState, tokens: torch.Tensor) -> dict:
        if state.count is None:
            raise ValueError("a chunk runs on a device step count: "
                             "make_train_state(..., device_step=True)")
        n = tokens.shape[0]
        if n == self.n and tokens.device.type == "cuda":
            return self._replay(state, tokens)
        ms = [self._step(state, tokens[i]) for i in range(n)]
        return {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
                for k in ms[0]}

    def _capture(self, state: TrainState, tokens: torch.Tensor) -> None:
        from akka_allreduce_tpu_torch.ops import collectives
        from akka_allreduce_tpu_torch.ops.kernels import transport
        if self.ranks and self.group.backend != "ipc":
            raise ValueError(
                f"a chunk of steps across ranks is one CUDA graph, which "
                f"captures the ipc transport only (the {self.group.backend} "
                f"wire stages payloads through the host): use "
                f"--dist-backend ipc")
        t0 = time.perf_counter()
        device = tokens.device
        base = state.step  # the host reads the count once, before capture
        # one eager warm-up step on a side stream (the libraries load, the
        # optimizer's state and the transport's buffers exist before
        # capture, and the rounding keys a step derives are listed), then
        # undone: the state tensors take back their values in place, and
        # an optimizer state the step created its initial zeros
        kept = [t.detach().clone() for t in _state_tensors(state)]
        kept_opt = [t.clone() for t in _optimizer_tensors(state.optimizer)]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), collectives.record_keys() as keys:
            self._step(state, tokens[0])
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, k in zip(_state_tensors(state), kept):
                t.copy_(k)
            opt = _optimizer_tensors(state.optimizer)
            if kept_opt:
                for t, k in zip(opt, kept_opt):
                    t.copy_(k)
            else:
                for t in opt:
                    t.zero_()
        # the copies' memory goes back before the graph's pool fills
        del kept, kept_opt
        buf = torch.empty_like(tokens)
        graph = torch.cuda.CUDAGraph()
        seeds = sum(1 for kind, _ in keys if kind == "seed")
        chunk = None
        if keys:
            chunk = collectives.ChunkKeys(self.n, base, device, seeds,
                                          len(keys) - seeds)
            chunk.register(graph)
        before = _launch_counts()
        try:
            with contextlib.ExitStack() as stack:
                tcap = (stack.enter_context(transport.capture())
                        if self.ranks else None)
                if chunk is not None:
                    stack.enter_context(collectives.chunk_keys(chunk))
                with torch.cuda.graph(graph):
                    ms = [self._step(state, buf[i], host_step=base + i)
                          for i in range(self.n)]
                    out = {k: torch.stack([m[k] for m in ms])
                           for k in ms[0]}
            if chunk is not None:
                chunk.check_complete()
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of a {self.n}-step "
                               f"chunk failed: {exc}") from exc
        # capture enqueues nothing: the wrappers counted launches that
        # each replay makes
        after = _launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        _add_launch_counts(self.captured_launches, -1)
        torch.cuda.synchronize(device)
        self.capture_seconds = time.perf_counter() - t0
        self._captured = (graph, buf, out, tcap, chunk)

    def _replay(self, state: TrainState, tokens: torch.Tensor) -> dict:
        from akka_allreduce_tpu_torch.ops.kernels import transport
        if self._captured is None:
            self._capture(state, tokens)
            self._state = state
        elif state is not self._state:
            raise ValueError("a captured chunk replays on the tensors of "
                             "the state it was captured with; make a "
                             "chunk runner for each state")
        graph, buf, out, tcap, chunk = self._captured
        if tcap is not None:
            # every rank drained and met, its counters back at the
            # capture's values
            self.boundary_ms.append(self.group.replay_boundary(tcap))
        if chunk is not None:
            chunk.fill(state.step)
        buf.copy_(tokens)
        if tcap is not None:
            transport.replay(tcap, graph.replay)
        else:
            graph.replay()
        _add_launch_counts(self.captured_launches)
        self.replays += 1
        return {k: v.clone() for k, v in out.items()}


def make_multi_step(cfg: TrainConfig, n: int,
                    group: Optional[RankGroup] = None) -> _MultiStep:
    """``n`` production train steps a dispatch: the JAX ``make_multi_step``
    (one ``lax.scan`` a chunk). Called as ``multi(state, tokens)`` with
    ``tokens`` stacked ``(k, B, T)`` on the state's device, it runs ``k``
    steps on ``state`` in place and returns each metric stacked along
    axis 0. The state comes from ``make_train_state(...,
    device_step=True)`` on every device: the step count, and the learning
    rate read from it, live beside the parameters, and each step advances
    the count there. ``group`` is the rank's mesh: every rank runs the
    same chunks, and the sync and the ring exchanges run inside them.

    On the card a chunk of exactly ``n`` is one replay of a CUDA graph
    that holds the ``n`` steps, captured at the first such chunk after
    one eager warm-up step that is then undone (the residual and the
    device count too); it replays only on the state it captured. Across
    ranks the graph holds the ``ipc`` transport's calls on every buffer
    the step uses (the syncs' sub-meshes, the tp, ep and pp lines; gloo
    and nccl refuse); at pp > 1 it holds the pipeline's forward ticks
    and its written-out backward (gpipe) or its fused ring (1f1b). Each
    replay starts with ``RankGroup.replay_boundary``
    (drain, barrier, the counters rewound, barrier) and the chunk's
    rounding seeds written for its steps (``ops/collectives.py
    ChunkKeys``), so every replay is bitwise the eager steps. A graph
    that cannot be captured raises; nothing falls back to the per-step
    loop. A shorter chunk (the tail), and on the CPU (an explicit
    request) every chunk, runs the same step code step by step. The
    runner's ``captured_launches`` are the kernel launches of one replay
    by kernel name (``flash_fwd``, ``ring_dq``, ``masked_reduce``, ...),
    ``replays`` the replays so far, ``capture_seconds`` the capture's,
    ``boundary_ms`` each replay's boundary and ``transport`` the
    transport's record of the capture (calls, waits and copies a
    replay)."""
    return _MultiStep(cfg, n, group)
