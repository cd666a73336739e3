"""Tensor parallelism: Megatron-style sharded dense layers.

Counterpart of ``akka_allreduce_tpu/parallel/tp.py``. A column-parallel
projection shards its output features over the ``tp`` ranks (no
communication forward; the backward sum of the activation's gradient is
:func:`tp_grad_boundary`'s), and the row-parallel projection after it
shards its input features and sums its partial outputs over ``tp``
(:func:`tp_psum`). One sum per projection pair per direction.

Rank-local, as the JAX helpers run inside ``shard_map``: every ``tp``
rank of a line calls them in the same order with its own shard. The
group is the rank's line along ``tp`` (``RankGroup.along("tp")``); a
group of one makes both operators the identity. The sum is
``ops/collectives.py psum_allreduce``: on CUDA tensors its rank sum is
the masked-reduce kernel, in f32, cast back to the payload's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from akka_allreduce_tpu_torch.ops.collectives import psum_allreduce
from akka_allreduce_tpu_torch.parallel.group import RankGroup


def _psum(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    return psum_allreduce(x.contiguous(), group)


class _GradBoundary(torch.autograd.Function):
    """Identity forward, sum over ``tp`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _psum(ct, ctx.group), None


class _TpPsum(torch.autograd.Function):
    """Sum over ``tp`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def tp_grad_boundary(x: torch.Tensor, group: Optional[RankGroup]
                     ) -> torch.Tensor:
    """Megatron's "g" operator: identity forward, the sum over the ``tp``
    ranks backward. Placed on the activation entering a column-parallel
    region: each rank's backward gives only its shard's part of dL/dx,
    and the sum completes it, so everything upstream (embeddings, norms)
    gets its whole gradient on every ``tp`` rank."""
    if group is None or group.world == 1:
        return x
    return _GradBoundary.apply(x, group)


def tp_psum(x: torch.Tensor, group: Optional[RankGroup]) -> torch.Tensor:
    """Megatron's "f" operator: the sum over the ``tp`` ranks forward,
    identity backward. The summed activation is the same on every rank,
    so its cotangent is already whole and passes through unchanged (a
    sum in both directions would multiply every gradient upstream by the
    ``tp`` size)."""
    if group is None or group.world == 1:
        return x
    return _TpPsum.apply(x, group)


def column_parallel_dense(x: torch.Tensor, w_shard: torch.Tensor,
                          b_shard: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``y_local = x @ W[:, shard]``: output features sharded, no forward
    collective."""
    y = x @ w_shard
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel_dense(x_shard: torch.Tensor, w_shard: torch.Tensor,
                       group: Optional[RankGroup],
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = sum_tp(x_local @ W[shard, :])``: input features sharded, the
    partial products summed over the ``tp`` ranks; a (full-width) bias is
    added once, after the sum."""
    y = tp_psum(x_shard @ w_shard, group)
    if bias is not None:
        y = y + bias
    return y
