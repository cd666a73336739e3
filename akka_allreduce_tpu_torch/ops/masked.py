"""Lossy (threshold) allreduce semantics as mask and count arithmetic.

Counterpart of ``akka_allreduce_tpu/ops/masked.py``. A rank whose bucket
missed its round contributes zeros with ``valid`` 0, and the summed masks
are the reference's per-bucket contribution counts (reference:
ScatteredDataBuffer.scala:9-13; ReducedDataBuffer.scala:40-48).

:func:`masked_reduce_staged` is the single-process form over a
``(peers, elems)`` staging matrix — the N-workers-on-one-card emulation
of one round's scatter + reduce, with the count and the sink's
divide-by-count fused in. It has no ``impl`` switch: CPU tensors take the
plain version and CUDA tensors the kernel
(``ops/kernels/csrc/masked_reduce.cu``).
"""

from __future__ import annotations

import torch

from akka_allreduce_tpu_torch.ops.bucketing import BucketSpec
from akka_allreduce_tpu_torch.ops.collectives import psum_allreduce
from akka_allreduce_tpu_torch.ops.kernels.masked_reduce import masked_reduce
from akka_allreduce_tpu_torch.parallel.group import RankGroup


def bucket_counts(valid: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Per-bucket contribution counts: the ranks' masks gathered and
    summed as int32 (exact)."""
    v = valid.to(torch.int32)
    return group.all_gather(v[None]).sum(dim=0, dtype=torch.int32)


def masked_allreduce(buckets: torch.Tensor, valid: torch.Tensor,
                     group: RankGroup
                     ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Rank-local lossy allreduce. ``buckets`` (num_buckets,
    bucket_elems) is this rank's contribution and ``valid``
    (num_buckets,) which buckets it contributes this round. Returns
    ``(summed_buckets, counts)``, ``counts[b]`` the number of ranks whose
    bucket b arrived (the ReduceBlock.count piggyback, reference:
    AllreduceMessage.scala:20)."""
    contrib = buckets * valid.to(buckets.dtype)[:, None]
    return psum_allreduce(contrib, group), bucket_counts(valid, group)


def masked_reduce_staged(staged: torch.Tensor, valid: torch.Tensor,
                         target: float = 1.0
                         ) -> "tuple[torch.Tensor, torch.Tensor]":
    """``out = (sum_p valid[p] * staged[p]) * target / count``, ``count =
    sum valid`` (0 where no peer contributed). Returns ``(reduced
    (elems,), count int32 scalar)``."""
    return masked_reduce(staged, valid, target)


def expand_bucket_counts(counts: torch.Tensor,
                         spec: BucketSpec) -> torch.Tensor:
    """Per-bucket counts -> per-element counts over the unpadded vector
    (reference: ReducedDataBuffer.scala:46)."""
    return counts.repeat_interleave(spec.bucket_elems)[:spec.total_size]


def rescale_by_count(summed: torch.Tensor, counts: torch.Tensor,
                     target: float = 1.0) -> torch.Tensor:
    """``summed * target / max(counts, 1)``, 0 where nobody contributed:
    the divide-by-count compensation of the reference's sink contract."""
    counts = counts.to(summed.dtype)
    return torch.where(counts > 0,
                       torch.div(summed * target, counts.clamp_min(1)),
                       torch.zeros((), dtype=summed.dtype,
                                   device=summed.device))
