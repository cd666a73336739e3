"""Reduce-phase buffer: stage reduced chunks from every block owner, track
piggybacked contribution counts, reassemble the full output vector.

Counterpart of ``akka_allreduce_tpu/buffers/reduced.py``, the port of the
reference's ``ReducedDataBuffer`` (reference:
buffer/ReducedDataBuffer.scala:5-73), including uneven block handling
(the last rank's block may be smaller), zero-filling of missing chunks,
and chunk→element count expansion. The output is rebuilt on the device:
the staged blocks in one copy, the element counts expanded from the host
counts by one ``repeat_interleave``.
"""

from __future__ import annotations

import numpy as np
import torch

from akka_allreduce_tpu_torch.buffers.base import AllReduceBuffer


class ReducedDataBuffer(AllReduceBuffer):
    def __init__(self, max_block_size: int, min_block_size: int,
                 total_data_size: int, peer_size: int, max_lag: int,
                 completion_threshold: float, max_chunk_size: int,
                 device="cuda"):
        super().__init__(max_block_size, peer_size, max_lag, max_chunk_size,
                         device)
        self.max_block_size = max_block_size
        # min_block_size is accepted for constructor parity with the
        # reference (ReducedDataBuffer.scala:5-11); the completion gate is
        # derived from the actual block layout below, which subsumes it.
        del min_block_size
        self.total_data_size = total_data_size
        self.completion_threshold = completion_threshold

        # Completion gate: fraction of the TOTAL attainable chunk count
        # across peers (reference: ReducedDataBuffer.scala:13-17), from
        # the actual block layout, so that geometries with several empty
        # trailing blocks (data_size < peer_num) still complete.
        total_chunks = 0
        for i in range(peer_size):
            block = min(max_block_size,
                        max(0, total_data_size - i * max_block_size))
            total_chunks += self.get_num_chunk(block) if block > 0 else 0
        self.total_chunks = total_chunks
        # int() truncation can yield a gate of 0 for small thresholds; a 0
        # gate would deadlock (the == check only runs after a store), so
        # clamp to at least one chunk when any chunk is attainable.
        gate = int(completion_threshold * total_chunks)
        self.min_chunk_required = min(max(1, gate), total_chunks) \
            if total_chunks > 0 else 0

        # Per (peer, chunk) piggybacked contribution count, on the host
        # (reference: ReducedDataBuffer.scala:19).
        self.count_reduce_filled = np.zeros(
            (max_lag, peer_size * self.num_chunks), dtype=np.int64)
        # how many output elements each (peer, chunk) count covers, in
        # the reference's expansion order (ReducedDataBuffer.scala:40-48),
        # plus one trailing zero-count run for any element left uncovered
        lengths = []
        covered = 0
        for _ in range(peer_size):
            for j in range(self.num_chunks):
                size = min(max_chunk_size,
                           max_block_size - max_chunk_size * j)
                size = min(total_data_size - covered, size)
                lengths.append(size)
                covered += size
        lengths.append(total_data_size - covered)
        self._count_lengths = torch.tensor(lengths, dtype=torch.int64,
                                           device=self.device)

    def store(self, data, row: int, src_id: int, chunk_id: int,
              count: int) -> None:  # type: ignore[override]
        """Stage one reduced chunk plus its contributor count
        (reference: ReducedDataBuffer.scala:21-24)."""
        super().store(data, row, src_id, chunk_id)
        self.count_reduce_filled[
            self._time_idx(row), src_id * self.num_chunks + chunk_id] = count

    def get_with_counts(self, row: int
                        ) -> "tuple[torch.Tensor, torch.Tensor]":
        """Reassemble the full ``total_data_size`` output vector (f32) and
        the per-element contribution counts (int32), both new tensors on
        the device; missing chunks read as zeros with count 0 (reference:
        ReducedDataBuffer.scala:26-53).

        Peer ``i``'s block lands at ``i * max_block_size`` (every block
        before the last non-empty one is full), so the output is the
        staged row flattened and cut to ``total_data_size``: one copy."""
        t = self._time_idx(row)
        flat = self.temporal_buffer[t].reshape(-1)
        if flat.shape[0] >= self.total_data_size:
            data_output = flat[:self.total_data_size].clone()
        else:  # a hand-built geometry whose blocks do not cover the data
            data_output = torch.zeros(self.total_data_size,
                                      dtype=torch.float32, device=self.device)
            data_output[:flat.shape[0]] = flat
        counts = np.append(self.count_reduce_filled[t], 0).astype(np.int32)
        count_output = torch.repeat_interleave(
            torch.from_numpy(counts).to(self.device), self._count_lengths,
            output_size=self.total_data_size)
        return data_output, count_output

    def up(self) -> None:
        super().up()
        self.count_reduce_filled[self._time_idx(self.max_lag - 1)] = 0

    def reach_completion_threshold(self, row: int) -> bool:
        """Round completes when the total number of stored reduced chunks
        *equals* the gate — ``==``, exactly-once
        (reference: ReducedDataBuffer.scala:60-66). O(1): reads the
        running total the base buffer maintains per store."""
        return int(self.total_filled[self._time_idx(row)]) \
            == self.min_chunk_required
