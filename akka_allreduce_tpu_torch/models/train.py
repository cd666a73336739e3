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
* the optimizer is ``torch.optim.AdamW`` over two parameter groups, the
  rank >= 2 leaves with ``weight_decay`` and the rest (norm gains) with
  none: optax's decay mask. Its update equals ``optax.adamw``'s;
* the step updates the parameters, the optimizer state and the residual
  IN PLACE (``TrainState`` holds them) and returns the metrics; the JAX
  step returns new arrays instead;
* ``compute_dtype="bf16"`` runs the model on bf16 copies of the masters;
  autograd casts the gradients back to f32, so the sync and the update
  stay f32.

Left out and refused with ``NotImplementedError``: optimizers other than
adamw, ``ema_decay`` and ``accum_schedule="overlap"`` (ROADMAP.md A5).
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Any, Callable, Optional, Union

import torch

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

LEFT_OUT = "left out of the port's one-card training slice (ROADMAP.md A5)"
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
    """Parameters, their optimizer, its step count (optax's ``count``:
    the steps taken, which the LR schedule and the rounding keys read
    before it increments) and the ef8 error-feedback residual (None on
    the other wires). The train step mutates all four."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int = 0
    residual: Optional[torch.Tensor] = None


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


def quant_key(step: int) -> tuple:
    """The dense sync's rounding key of step ``step``: the JAX
    ``fold_in(fold_in(key(17), step), 0)`` as a key tuple."""
    return (QUANT_ROOT, int(step), 0)


def check_supported(cfg: TrainConfig) -> None:
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


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.AdamW:
    """AdamW over ``params`` (b1 0.9, b2 0.999, eps 1e-8, as optax's
    adamw) with optax's decay mask: rank >= 2 leaves decay, the rest
    (norm gains, vectors) do not. The learning rate is set per step by
    the train step from :func:`make_lr_schedule`."""
    check_supported(cfg)
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
                     device: "torch.device | str | None" = None
                     ) -> TrainState:
    """Parameters (``params``, or random from ``generator``) as leaves
    that require grad, their optimizer and, on the ef8 wire, a zero
    residual of the bucket matrix's shape (the JAX ``init_ef_state``)."""
    if params is None:
        if generator is None:
            raise ValueError("make_train_state needs params or a generator")
        params = init_transformer(generator, cfg.model, device)
    elif device is not None:
        params = tree_map(lambda p: p.to(device), params)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    residual = None
    if cfg.grad_transport == "ef8":
        spec = tree_bucket_spec(params, cfg.bucket_elems)
        residual = torch.zeros((spec.num_buckets, spec.bucket_elems),
                               dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
    return TrainState(params=params, optimizer=make_optimizer(cfg, params),
                      residual=residual)


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
    scaled by the whole batch's token count), aux terms averaged: the JAX
    "deferred" schedule, one sync after the last microbatch.
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

    def local_grads(params, tokens):
        b, _ = tokens.shape
        targets, weights, positions = targets_and_weights(tokens)
        # the global count: the weights summed over every rank
        total_count = weights.sum()
        if world > 1:
            total_count = group.all_gather(total_count[None]).sum()
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
        return loss, total_count, aux, tree_unflatten(params, grads)

    rank = 0 if group is None else group.rank

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
        loss, total_count, aux, grads = local_grads(params, tokens)
        aux_loss = aux["aux_loss"] / accum
        dispatch = aux["dispatch_fraction"] / accum
        min_count = torch.ones((), dtype=torch.int32, device=tokens.device)
        if world > 1 or valid is not None:
            # one rank with a mask still masks (the JAX sync over size-1
            # axes); without one its sync is the identity and is skipped
            row = None if valid is None else _mask_row(
                valid, rank, world, tokens.device)
            start = _timer_mark(tokens.device)
            res = allreduce_gradients(
                grads, gcfg, group, valid=row,
                quant_key=quant_key(quant_seed) if quantized else None,
                residual=residual)
            if sync_times is not None:
                sync_times.append((start, _timer_mark(tokens.device)))
            grads, residual = res.grads, res.residual
            min_count = res.bucket_counts.min()
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
        if use_ef:
            return grads, metrics, residual
        return grads, metrics

    return grad_step


def make_train_step(cfg: TrainConfig, group: Optional[RankGroup] = None,
                    sync_times: Optional[list] = None,
                    dynamic_valid: bool = False):
    """``step(state, tokens) -> metrics``: synced gradients (keyed by
    ``state.step``), then the optax chain's order — global-norm clip
    (``clip_norm > 0``), then AdamW at the schedule's rate for
    ``state.step`` — applied to ``state`` in place. With
    ``dynamic_valid=True`` it is ``step(state, tokens, valid) ->
    metrics``, ``valid`` the round's ``(data_rank_count, num_buckets)``
    mask (:func:`make_grad_step`); a masked round still advances
    ``state.step``, which keys the next round's rounding as the JAX
    optimizer's count does."""
    grad_step = make_grad_step(cfg, group, sync_times, dynamic_valid)
    use_ef = cfg.grad_transport == "ef8"

    def step(state: TrainState, tokens: torch.Tensor, valid=None) -> dict:
        out = grad_step(state.params, tokens, quant_seed=state.step,
                        residual=state.residual, valid=valid)
        grads, metrics = out[0], out[1]
        if use_ef:
            state.residual = out[2]
        grads = tree_leaves(grads)
        if cfg.clip_norm > 0:
            clip_by_global_norm_(grads, cfg.clip_norm)
        lr = lr_at(cfg, state.step)
        for pgroup in state.optimizer.param_groups:
            pgroup["lr"] = lr
        for p, g in zip(tree_leaves(state.params), grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    return step
