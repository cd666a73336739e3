"""Scatter-phase buffer: stage peers' chunks of *my* block; reduce at threshold.

Counterpart of ``akka_allreduce_tpu/buffers/scattered.py``, the port of
the reference's ``ScatteredDataBuffer`` (reference:
buffer/ScatteredDataBuffer.scala:3-41). The summation in :meth:`reduce`
is the reference's only FLOP kernel (reference:
ScatteredDataBuffer.scala:20-32). Here it runs through the port's
masked-reduce wrapper (``ops/kernels/masked_reduce.py``; on the card the
``csrc/masked_reduce.cu`` kernel) on the ``(peers, chunk)`` slab of the
staging row, in place: the slab's rows are ``data_size`` apart, which the
kernel takes as its leading dimension. Every peer is valid and the
target is the peer count, so the scale is exactly 1.0 and the sum is the
peers added in index order, as numpy's ``sum(axis=0)`` of the JAX buffer
adds them.
"""

from __future__ import annotations

import torch

from akka_allreduce_tpu_torch.buffers.base import AllReduceBuffer
from akka_allreduce_tpu_torch.ops.kernels.masked_reduce import masked_reduce


class ScatteredDataBuffer(AllReduceBuffer):
    def __init__(self, data_size: int, peer_size: int, max_lag: int,
                 reducing_threshold: float, max_chunk_size: int,
                 device="cuda"):
        super().__init__(data_size, peer_size, max_lag, max_chunk_size,
                         device)
        self.reducing_threshold = reducing_threshold
        # Number of peers' chunks needed to trigger a reduce
        # (reference: ScatteredDataBuffer.scala:9). int() truncation could
        # yield 0 for small thresholds, which would deadlock (the == check
        # only runs after a store bumps the count to >= 1), so clamp to 1.
        self.min_chunk_required = max(1, int(reducing_threshold * peer_size)) \
            if peer_size > 0 else 0
        # the reduce's mask: every peer slot (unfilled slots are zeros)
        self._all_valid = torch.ones(peer_size, dtype=torch.float32,
                                     device=self.device)

    def reach_reducing_threshold(self, row: int, chunk_id: int) -> bool:
        """True exactly when the fill count *equals* the threshold — ``==``
        not ``>=``, so the reduce fires exactly once; later arrivals are
        absorbed but never re-broadcast
        (reference: ScatteredDataBuffer.scala:11-13; pinned by
        AllreduceSpec.scala:444-458)."""
        return bool(self.count_filled[self._time_idx(row), chunk_id] ==
                    self.min_chunk_required)

    def count(self, row: int, chunk_id: int) -> int:
        return int(self.count_filled[self._time_idx(row), chunk_id])

    def reduce(self, row: int, chunk_id: int) -> "tuple[torch.Tensor, int]":
        """Sum one chunk across all peer slots (unfilled slots are zeros);
        return the reduced chunk (a new tensor on the device) and how many
        peers contributed, the host count (reference:
        ScatteredDataBuffer.scala:20-32)."""
        start = chunk_id * self.max_chunk_size
        end = min(self.data_size, (chunk_id + 1) * self.max_chunk_size)
        t = self._time_idx(row)
        reduced, _ = masked_reduce(self.temporal_buffer[t, :, start:end],
                                   self._all_valid, float(self.peer_size))
        return reduced, self.count(row, chunk_id)

    def empty(self) -> bool:
        return self.data_size == 0
