"""Data-parallel gradient synchronisation, the framework's user-facing API.

Counterpart of ``akka_allreduce_tpu/parallel/dp.py``: the training step
calls :func:`allreduce_gradients` on its gradient tree and gets back the
reduced tree plus the per-bucket contribution counts, the payload of the
reference's ``AllReduceOutput(data, count, iteration)`` (reference:
DataWrapper.scala:3-7). Rank-local: every rank of the group calls it
with its own gradients, where the JAX function runs inside ``shard_map``.
Per round:

    tree --bucketize--> (B, E) buckets --wire x schedule--> (sums, counts)
         --average--> mean grads --debucketize--> tree

Wires (``transport``): ``f32``; ``bf16`` (the payload cast, sums in f32
on the device, the result rounded to bf16 once); ``int8`` (per-row
scales, stochastic rounding); ``ef8`` (block scales and a carried
error-feedback residual). Schedules: ``fused``, ``windowed``, ``swing``;
``hierarchical`` (the ef8 ICI x DCN hybrid over the group's two live
axes, outer first in its order, ``ops/collectives.py
hierarchical_allreduce``); ``auto``
(each bucket matrix's ``(rows, cols)`` class resolved against
``GradSyncConfig.plan``, a ``CollectivePlan`` of ``ops/autotune.py``,
before dispatch: a frozen plan gives every class one fixed schedule on
every call).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from akka_allreduce_tpu_torch.ops.autotune import live_axes, resolve_schedule
from akka_allreduce_tpu_torch.ops.bucketing import BucketSpec, bucketize, \
    vector_to_tree
from akka_allreduce_tpu_torch.ops.collectives import (
    DEFAULT_EF_BLOCK, ef8_two_phase_allreduce, hierarchical_allreduce,
    pipelined_two_phase_allreduce, psum_allreduce, quantized_swing_allreduce,
    quantized_two_phase_allreduce, swing_allreduce)
from akka_allreduce_tpu_torch.ops.masked import (bucket_counts,
                                                 expand_bucket_counts,
                                                 masked_allreduce)
from akka_allreduce_tpu_torch.parallel.group import RankGroup

TRANSPORTS = ("f32", "bf16", "int8", "ef8")
SCHEDULES = ("fused", "windowed", "swing", "hierarchical", "auto")


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """``bucket_elems`` is the fusion granularity (the reference's
    ``maxChunkSize``). ``average=True`` divides each bucket by its
    contribution count and scales to ``rescale_target`` (the rank count
    makes an exact round equal the sum); ``False`` returns the raw sum.
    ``return_elem_counts`` materialises per-element counts (an extra
    full-size int32 tensor). ``plan`` is the measured ``CollectivePlan``
    that ``transport_schedule="auto"`` dispatches against (None: auto
    takes the hand-flag default); every other schedule ignores it."""

    bucket_elems: int = 1 << 18
    average: bool = True
    rescale_target: float = 1.0
    return_elem_counts: bool = True
    transport: str = "f32"
    transport_schedule: str = "fused"
    num_windows: int = 4
    plan: Any = None


@dataclasses.dataclass
class GradSyncResult:
    """Reduced gradients, per-element counts (a tree like the gradients,
    or None), the per-bucket counts, and for ef8 the updated residual
    (buckets-shaped f32; thread it into the next round) and, when opted
    in, the phase-2 residual. ``schedule`` is the schedule that ran: what
    "auto" resolved to, "fused" for a hierarchical sync on fewer than two
    live axes, else the configured one."""

    grads: Any
    counts: Any
    bucket_counts: torch.Tensor
    spec: BucketSpec
    transport: str = "f32"
    residual: Any = None
    residual2: Any = None
    schedule: str = "fused"


def check_sync_config(config: GradSyncConfig) -> None:
    """Refuse an unknown wire or schedule, and a hierarchical schedule
    on another wire than ef8."""
    if config.transport_schedule not in SCHEDULES:
        raise ValueError(
            f"unknown transport_schedule {config.transport_schedule!r}: "
            f"'fused' (one monolithic collective), 'windowed' (the "
            f"software-pipelined schedule), 'swing' (the ±2^t "
            f"short-cut exchange schedule), 'hierarchical' (the ef8 "
            f"ICI x DCN hybrid), or 'auto' (the measured per-bucket-"
            f"class plan, ops/autotune.py)")
    if config.transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {config.transport!r}: "
                         f"{TRANSPORTS}")
    if config.transport_schedule == "hierarchical" \
            and config.transport != "ef8":
        raise ValueError(
            f"transport_schedule='hierarchical' IS the ef8 ICI x "
            f"DCN hybrid (the compressed DCN leg is its point) — "
            f"got transport={config.transport!r}; use "
            f"transport='ef8', or a different schedule")


def window_count(rows: int, num_windows: int) -> int:
    """The windowed f32/bf16 schedule's window count for ``rows`` bucket
    rows: degraded until the zero-row pad is less than one window, so an
    awkward bucket count never multiplies the wire bytes."""
    w = min(num_windows, rows)
    while w > 1 and (-rows) % w >= -(-rows // w):
        w -= 1
    return max(w, 1)


def allreduce_gradients(grads: Any, config: GradSyncConfig = GradSyncConfig(),
                        group: Optional[RankGroup] = None,
                        valid: Optional[torch.Tensor] = None,
                        quant_key: Optional[tuple] = None,
                        residual: Optional[torch.Tensor] = None,
                        residual2: Optional[torch.Tensor] = None
                        ) -> GradSyncResult:
    """Synchronise a gradient tree across the group (rank-local).

    ``valid``: optional (num_buckets,) mask of the buckets THIS rank
    contributes this round; the counts then say how many ranks
    contributed each bucket. ``quant_key`` (a key tuple,
    ``ops/collectives.py``) drives the int8/ef8 rounding: vary it per
    round. ``residual`` is the ef8 error-feedback state (None starts from
    zeros); the updated state comes back as ``GradSyncResult.residual``
    and must be threaded into the next round. ``group`` None is a group
    of one."""
    check_sync_config(config)
    buckets, spec = bucketize(grads, config.bucket_elems)
    if group is None:
        group = RankGroup.single(buckets.device)
    n = group.world
    live = n > 1
    # the mesh axes that move bytes, outer (DCN) first, in the group's
    # order (the dense sync's sub-mesh is ("dp", "sp", "ep"))
    live = live_axes(group)
    live_sizes = [size for _, size in live]
    schedule, n_windows = config.transport_schedule, config.num_windows
    if schedule == "auto":
        # one resolution per bucket class against the frozen plan: the
        # same class dispatches the same schedule on every call and rank
        schedule, n_windows = resolve_schedule(
            config.plan, buckets.shape[0], buckets.shape[1], live_sizes,
            config.transport, default_windows=config.num_windows)
    windowed = schedule == "windowed" and live
    swing = schedule == "swing" and live
    hier = schedule == "hierarchical"
    if hier:
        # the wire was checked above; auto resolves to hierarchical on
        # ef8 alone
        if len(live_sizes) > 2:
            raise ValueError(
                f"hierarchical schedule needs exactly two (>1) data "
                f"axes (outer = DCN group, inner = ICI axis); got "
                f"{[a for a, _ in live]} — fold the extra parallelism "
                f"away")
        if len(live_sizes) < 2:
            # the mesh shrank under the flag: the fused ef8 two-phase
            # over whatever is left
            hier = False
    if windowed and n_windows < 1:
        raise ValueError(f"num_windows must be >= 1, got {n_windows}")
    quantized = config.transport in ("int8", "ef8")
    if quantized:
        if quant_key is None:
            raise ValueError(
                f"{config.transport} transport needs quant_key, varied per "
                f"round — a fixed key makes the stochastic-rounding error "
                f"systematic instead of zero-mean across rounds")
        if config.transport == "ef8" and residual is None:
            residual = torch.zeros_like(buckets)
    if residual2 is not None and (config.transport != "ef8" or windowed
                                  or swing or hier):
        raise ValueError(
            "residual2 (phase-2 error feedback) needs the ef8 transport on "
            "the fused two-phase schedule — the broadcast-leg residual is "
            "owner-rows-shaped, which only the fused carve keeps stable")
    new_residual = residual if config.transport == "ef8" else None
    new_residual2 = residual2

    def windowed_sum(mat: torch.Tensor) -> torch.Tensor:
        rows = mat.shape[0]
        w = window_count(rows, n_windows)
        pad = (-rows) % w
        if pad:
            mat = torch.cat([mat, mat.new_zeros((pad, mat.shape[1]))])
        return pipelined_two_phase_allreduce(mat, group, w)[:rows]

    def exact_sum(mat: torch.Tensor) -> torch.Tensor:
        if windowed:
            return windowed_sum(mat)
        if swing:
            return swing_allreduce(mat, group)
        return psum_allreduce(mat, group)

    def quantized_sum(mat, vmask):
        nonlocal new_residual, new_residual2
        if not live:
            # size-1 identity: nothing moves, nothing rounds, but a masked
            # bucket still contributes nothing
            return mat if vmask is None else \
                mat * vmask.to(mat.dtype)[:, None]
        if config.transport == "ef8":
            if hier:
                # outer (first in the group's order) = the DCN group,
                # inner (last) = the ICI axis
                out, new_residual = hierarchical_allreduce(
                    mat, quant_key, group, residual=residual, valid=vmask,
                    block_elems=DEFAULT_EF_BLOCK, dcn_axis=live[0][0],
                    ici_axis=live[-1][0])
            elif swing:
                out, new_residual = quantized_swing_allreduce(
                    mat, quant_key, group, residual=residual, valid=vmask,
                    block_elems=DEFAULT_EF_BLOCK)
            elif residual2 is not None:
                out, new_residual, new_residual2 = ef8_two_phase_allreduce(
                    mat, quant_key, group, residual=residual, valid=vmask,
                    block_elems=DEFAULT_EF_BLOCK, residual2=residual2)
            else:
                out, new_residual = ef8_two_phase_allreduce(
                    mat, quant_key, group, residual=residual, valid=vmask,
                    num_windows=n_windows if windowed else 1,
                    block_elems=DEFAULT_EF_BLOCK)
            return out
        if swing:
            out, _ = quantized_swing_allreduce(mat, quant_key, group,
                                               valid=vmask)
            return out
        contrib = mat if vmask is None else \
            mat * vmask.to(mat.dtype)[:, None]
        return quantized_two_phase_allreduce(
            contrib, quant_key, group,
            num_windows=n_windows if windowed else 1)

    if valid is not None:
        valid = valid.to(buckets.device)
        if tuple(valid.shape) != (spec.num_buckets,):
            raise ValueError(f"valid must be ({spec.num_buckets},), got "
                             f"{tuple(valid.shape)}")
    use_bf16 = config.transport == "bf16" and live
    if valid is None:
        # exact path: every rank contributes every bucket; counts are the
        # group size
        if quantized:
            summed = quantized_sum(buckets, None)
        elif use_bf16:
            summed = exact_sum(buckets.to(torch.bfloat16)).float()
        else:
            summed = exact_sum(buckets)
        counts = torch.full((spec.num_buckets,), n, dtype=torch.int32,
                            device=buckets.device)
        if config.average:
            summed = summed * (config.rescale_target / n)
    else:
        # lossy rounds keep the wire; masked rows are exact zeros on every
        # wire, and the counts ride a separate exact int32 sum
        if quantized or use_bf16 or windowed or swing:
            if quantized:
                summed = quantized_sum(buckets, valid)
            else:
                contrib = buckets * valid.to(buckets.dtype)[:, None]
                summed = (exact_sum(contrib.to(torch.bfloat16)).float()
                          if use_bf16 else exact_sum(contrib))
            counts = bucket_counts(valid, group)
        else:
            summed, counts = masked_allreduce(buckets, valid, group)
        if config.average:
            c = counts.to(summed.dtype)
            target = torch.full((), config.rescale_target,
                                dtype=summed.dtype, device=summed.device)
            factor = torch.where(c > 0, torch.div(target, c.clamp_min(1.0)),
                                 torch.zeros((), dtype=summed.dtype,
                                             device=summed.device))
            summed = summed * factor[:, None]

    out_tree = vector_to_tree(summed.reshape(-1)[:spec.total_size], spec)
    counts_tree = None
    if config.return_elem_counts:
        per_elem = expand_bucket_counts(counts, spec)
        counts_spec = dataclasses.replace(
            spec, dtypes=tuple(torch.int32 for _ in spec.dtypes))
        counts_tree = vector_to_tree(per_elem, counts_spec)
    return GradSyncResult(grads=out_tree, counts=counts_tree,
                          bucket_counts=counts, spec=spec,
                          transport=config.transport, residual=new_residual,
                          residual2=new_residual2,
                          schedule="fused" if schedule == "hierarchical"
                          and not hier else schedule)
