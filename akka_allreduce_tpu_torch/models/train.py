"""The training step of the dense flagship transformer, on one rank or many.

Counterpart of ``akka_allreduce_tpu/models/train.py``: loss, backprop,
the bucketed gradient sync across the data- and sequence-parallel ranks,
and the optimizer update. With a group of more than one rank
(``parallel/group.py``, a ``(dp, sp)`` mesh) the step works as the JAX
``grad_local`` / ``sync_and_metrics`` pair does:

* under sequence parallelism (``sp`` > 1) rank ``(i, j)`` holds columns
  ``[j T, (j + 1) T)`` of its rows: positions (learned embeddings, rope)
  are global, the last target comes from the right ``sp`` neighbour's
  first token, only the last ``sp`` rank's final column has weight 0,
  and attention goes around the ring (:func:`select_ring_attention`);
* each rank's loss divides by the GLOBAL token count, the weights summed
  over every rank (the JAX psum over the data axes), so the sum of the
  ranks' gradients is the gradient of the global mean;
* the gradients go through ``parallel/dp.py allreduce_gradients`` over
  the whole ``(dp, sp)`` world (the JAX ``grad_axes=("dp", "sp")``;
  ``rescale_target`` = world, ``average=True``, no per-element counts)
  on the configured wire and schedule; int8/ef8 rounding keys derive
  from ``(17, step count, 0)`` as the JAX ``derive_quant_key`` and the
  dense sync's tag do;
* global-norm clipping comes after the sync (it is in the optax chain
  after ``sync_and_metrics``);
* the loss metric is the ranks' losses summed, ``min_bucket_count`` the
  smallest per-bucket count;
* the ef8 residual is ``TrainState.residual`` (buckets-shaped f32),
  threaded through every step;
* with ``dynamic_valid=True`` the step takes the round's contribution
  mask, the JAX ``(n_data_ranks, num_buckets)`` f32 array with rows in
  the data-axis order (dp-major, then sp: a rank's row is its global
  rank), and each rank hands its own row to the sync; masked buckets
  contribute exact zeros and the counts report the gap
  (``runtime/straggler.py`` builds the masks from deadlines; on the
  hierarchical schedule the rows of one ``sp`` line must agree, which
  its ``DeadlineTrainer`` holds when given :func:`mask_line`).

On one rank the sync is the identity and is skipped, as the JAX step's
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
  ``lax.scan`` chunk) on one rank or many: on the card one CUDA graph
  replay a chunk (across ranks on the ``ipc`` transport), on the CPU the
  same steps in a loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from functools import partial
from typing import Any, Callable, Optional, Union

import torch

from akka_allreduce_tpu_torch.models.optim import SGD, Adafactor, Lion
from akka_allreduce_tpu_torch.models.transformer import (
    TransformerConfig, init_transformer, next_token_loss_and_aux)
from akka_allreduce_tpu_torch.ops.bucketing import (
    tree_bucket_spec, tree_leaves, tree_map, tree_unflatten)
from akka_allreduce_tpu_torch.ops.kernels.flash_attention import \
    flash_causal_attention
from akka_allreduce_tpu_torch.ops.kernels.ring_flash import \
    ring_flash_attention
from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                  allreduce_gradients,
                                                  check_sync_config)
from akka_allreduce_tpu_torch.parallel.group import RankGroup
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    blockwise_causal_attention, flash_windowed_sp_attention,
    local_causal_attention, ring_attention, windowed_sp_attention)

OPTIMIZERS = ("adamw", "adafactor", "sgd", "lion")
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


@dataclasses.dataclass
class TrainState:
    """Parameters, their optimizer, the ef8 error-feedback residual (None
    on the other wires), the EMA weights (None without ``ema_decay``) and
    the step count (optax's ``count``: the steps taken, which the LR
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
    residual: Optional[torch.Tensor] = None
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


def quant_key(step: int, microbatch: Optional[int] = None) -> tuple:
    """The dense sync's rounding key of step ``step``: the JAX
    ``fold_in(fold_in(key(17), step), 0)`` as a key tuple. On the
    overlapped schedule microbatch ``i``'s sync folds ``i`` in before the
    dense tag, as the JAX scan does: ``fold_in(fold_in(fold_in(key(17),
    step), i), 0)``."""
    if microbatch is None:
        return (QUANT_ROOT, int(step), 0)
    return (QUANT_ROOT, int(step), int(microbatch), 0)


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


def make_optimizer(cfg: TrainConfig, params: dict,
                   lr: "float | torch.Tensor | None" = None
                   ) -> torch.optim.Optimizer:
    """The family of ``cfg.optimizer`` over ``params`` with optax's decay
    mask (rank >= 2 leaves decay, the rest — norm gains, vectors — do
    not; sgd has no decay, as ``optax.sgd``): adamw (b1 0.9, b2 0.999,
    eps 1e-8, ``torch.optim.AdamW``), lion (b1 0.9, b2 0.99), adafactor
    (optax's defaults; ``weight_decay`` 0 is none) or sgd
    (``sgd_momentum``, nesterov when > 0). The learning rate is set per
    step by the train step from :func:`make_lr_schedule`; ``lr`` as a
    0-dim tensor makes it that tensor in every group (shared, and
    written in place): the optimizer of a device step count, on the card
    a step that a CUDA graph captures (adamw is then capturable, which
    PyTorch allows on the card only)."""
    check_supported(cfg)
    if lr is None:
        lr = lr_at(cfg, 0)
    leaves = tree_leaves(params)
    if cfg.optimizer == "sgd":
        return SGD(leaves, lr=lr, momentum=cfg.sgd_momentum)
    groups = [{"params": [p for p in leaves if p.dim() >= 2],
               "weight_decay": cfg.weight_decay},
              {"params": [p for p in leaves if p.dim() < 2],
               "weight_decay": 0.0}]
    if cfg.optimizer == "lion":
        return Lion(groups, lr=lr, betas=(0.9, 0.99))
    if cfg.optimizer == "adafactor":
        return Adafactor(groups, lr=lr)
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


def make_train_state(cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     params: Optional[dict] = None,
                     device: "torch.device | str | None" = None,
                     device_step: bool = False) -> TrainState:
    """Parameters (``params``, or random from ``generator``) as leaves
    that require grad, their optimizer, on the ef8 wire a zero residual
    of the bucket matrix's shape (the JAX ``init_ef_state``), and with
    ``ema_decay`` the EMA as a copy of the initial masters (the JAX
    ``param_ema`` init). ``device_step`` keeps the step count on the
    parameters' device (``TrainState.count``) with the schedule's rates
    beside it, and the optimizer's learning rate as a tensor there: the
    state of :func:`make_multi_step`'s chunks."""
    if params is None:
        if generator is None:
            raise ValueError("make_train_state needs params or a generator")
        params = init_transformer(generator, cfg.model, device)
    elif device is not None:
        params = tree_map(lambda p: p.to(device), params)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    where = tree_leaves(params)[0].device
    residual = None
    if cfg.grad_transport == "ef8":
        spec = tree_bucket_spec(params, cfg.bucket_elems)
        residual = torch.zeros((spec.num_buckets, spec.bucket_elems),
                               dtype=torch.float32, device=where)
    ema = None
    if cfg.ema_decay > 0:
        ema = tree_map(lambda p: p.detach().clone().float(), params)
    count, table, lr = None, None, None
    if device_step:
        count = torch.zeros((), dtype=torch.int64, device=where)
        table = lr_table(cfg, where)
        lr = table[0].clone()
    return TrainState(params=params,
                      optimizer=make_optimizer(cfg, params, lr),
                      residual=residual, ema=ema, count=count,
                      lr_table=table)


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
    """How many data ranks contribute to the gradient sync: the row count
    of a dynamic ``valid`` mask (dp x sp, rows dp-major)."""
    return 1 if group is None else group.world


def dense_bucket_count(cfg: TrainConfig, params: dict) -> int:
    """Bucket count of the rank-local gradient tree (every rank holds
    whole parameters): the column count of a dynamic ``valid`` mask and
    the ef8 residual's row count."""
    return tree_bucket_spec(params, cfg.bucket_elems).num_buckets


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
    """How many consecutive data ranks must share a round's mask row:
    the ``sp`` line on the hierarchical schedule (ef8 over two live axes,
    flagged, or "auto", whose only arm and fallback there is
    hierarchical), whose ICI leg needs the line's masks to agree; else
    1."""
    if (group is None or cfg.grad_transport != "ef8"
            or cfg.transport_schedule not in ("hierarchical", "auto")
            or group.axis_size("dp") == 1):
        return 1
    return group.axis_size("sp")


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
    sends its own row (the global rank's) to the sync; a new mask every
    round changes nothing else. ``min_bucket_count`` is then the
    smallest count over the buckets, exact on every rank."""
    check_supported(cfg)
    mcfg = cfg.model
    world = 1 if group is None else group.world
    has_sp = group is not None and group.axis_size("sp") > 1
    attn = (select_ring_attention(cfg, group) if has_sp
            else select_local_attention(cfg))
    accum = cfg.grad_accum
    gcfg = sync_config(cfg, world)
    quantized = cfg.grad_transport in ("int8", "ef8")
    use_ef = cfg.grad_transport == "ef8"

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
        # the global count: the weights summed over every rank
        total_count = weights.sum()
        if world > 1:
            total_count = group.all_gather(total_count[None]).sum()
        yield total_count
        leaves = tree_leaves(params)
        if b % accum:
            raise ValueError(f"local batch {b} must divide into "
                             f"grad_accum={accum} microbatches")
        for tok, tgt, w in zip(tokens.chunk(accum), targets.chunk(accum),
                               weights.chunk(accum)):
            loss_sum, _, mb_aux = next_token_loss_and_aux(
                cast_compute(params), tok, mcfg, positions, attn,
                targets=tgt, weights=w, remat=cfg.remat)
            mb_loss = loss_sum / total_count
            yield (mb_loss.detach(), mb_aux,
                   list(torch.autograd.grad(mb_loss, leaves)))

    rank = 0 if group is None else group.rank

    def sync(params, grads, key, residual, row):
        """One gradient sync of a grads list: (synced list, the smallest
        bucket count, the residual)."""
        device = grads[0].device
        # a sync that a CUDA graph captures is not timed
        timed = sync_times is not None and not (
            device.type == "cuda" and torch.cuda.is_current_stream_capturing())
        start = _timer_mark(device) if timed else None
        res = allreduce_gradients(tree_unflatten(params, grads), gcfg, group,
                                  valid=row, quant_key=key,
                                  residual=residual)
        if timed:
            sync_times.append((start, _timer_mark(device)))
        return tree_leaves(res.grads), res.bucket_counts.min(), res.residual

    def grad_step(params, tokens, quant_seed=None, residual=None,
                  valid=None):
        if dynamic_valid and valid is None:
            raise ValueError("dynamic_valid step needs a per-round "
                             "valid mask (n_data_ranks, num_buckets)")
        if valid is not None and not dynamic_valid:
            raise ValueError("valid needs make_grad_step(..., "
                             "dynamic_valid=True)")
        if world > 1 and quantized and quant_seed is None:
            raise ValueError(f"{cfg.grad_transport} grad transport needs a "
                             f"per-round quant_seed")
        if world > 1 and use_ef and residual is None:
            raise ValueError(
                "ef8 grad transport needs the error-feedback state "
                "(TrainState.residual, from make_train_state): dropping it "
                "silently degrades ef8 to plain block-int8")
        # one rank with a mask still masks (the JAX sync over size-1
        # axes); without one its sync is the identity and is skipped
        synced = world > 1 or valid is not None
        # the round's mask row: the same on every tick of the overlap
        row = None if valid is None else _mask_row(valid, rank, world,
                                                   tokens.device)
        overlap = synced and cfg.accum_schedule == "overlap"
        parts = microbatch_grads(params, tokens)
        total_count = next(parts)
        loss, aux, grads, fly, min_count = 0.0, None, None, None, None
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
            out, count, residual = sync(
                params, mb_grads,
                quant_key(quant_seed, i) if quantized else None,
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
            grads, min_count, residual = sync(
                params, grads, quant_key(quant_seed) if quantized else None,
                residual, row)
        else:
            min_count = torch.ones((), dtype=torch.int32,
                                   device=tokens.device)
        # aux terms are per-microbatch diagnostics: the mean
        aux_loss = aux["aux_loss"] / accum
        dispatch = aux["dispatch_fraction"] / accum
        if world > 1:
            # the metrics' psum: the ranks' (loss, aux, dispatch) summed
            mine = torch.stack([torch.as_tensor(loss), aux_loss, dispatch])
            loss, aux_loss, dispatch = group.all_gather(
                mine.float()[None]).sum(dim=0)
            aux_loss = aux_loss / world
            dispatch = dispatch / world
        metrics = {"loss": loss, "tokens": total_count,
                   "min_bucket_count": min_count, "aux_loss": aux_loss,
                   "dispatch_fraction": dispatch}
        grads = tree_unflatten(params, grads)
        if use_ef:
            return grads, metrics, residual
        return grads, metrics

    return grad_step


def apply_update(cfg: TrainConfig, state: TrainState, grads: list) -> None:
    """The optax chain after the sync, in place: global-norm clip
    (``clip_norm > 0``), the family's update at the schedule's rate for
    the step count, then the EMA of the post-update masters; then the
    count advances. On a device count (``state.count``) the rate is the
    count's entry of ``state.lr_table``, copied into the groups' shared
    rate tensor, and the count advances on the device: no host code reads
    or writes a value, so a CUDA graph can capture the update."""
    if cfg.clip_norm > 0:
        clip_by_global_norm_(grads, cfg.clip_norm)
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
    keyed = cfg.grad_transport in ("int8", "ef8") and (
        (group is not None and group.world > 1) or dynamic_valid)

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
                state.residual.copy_(out[2])
        apply_update(cfg, state, tree_leaves(grads))
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
    return out + [t for t in (state.residual, state.count) if t is not None]


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
    ranks the graph holds the ``ipc`` transport's calls (gloo and nccl
    refuse), and each replay starts with ``RankGroup.replay_boundary``
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
