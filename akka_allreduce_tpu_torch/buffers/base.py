"""Round-ring staging buffer base.

Counterpart of ``akka_allreduce_tpu/buffers/base.py``, the port of the
reference's ``AllReduceBuffer`` (reference:
buffer/AllReduceBuffer.scala:3-47): a ``max_lag``-deep ring of
``[peer][element]`` float32 staging rows with chunk-granular fill
counting and ring rotation. ``max_lag`` here is the ring depth (the
worker passes ``config.max_lag + 1``, reference: AllreduceWorker.scala:64,
:74).

Data on the device, control on the host: ``temporal_buffer`` is a torch
tensor on the buffer's device (the JAX shape, ``(max_lag, peers,
data_size)`` f32), while ``temporal_offset``, ``count_filled`` and
``total_filled`` are Python ints and host numpy arrays. The protocol
engine reads a gate on every message; a count on the device would cost a
host sync each time. :func:`store` checks its bounds from shapes on the
host and then makes one device copy (counted in :data:`STORE_COPIES`).
"""

from __future__ import annotations

import numpy as np
import torch

from akka_allreduce_tpu_torch.config import num_chunks as _num_chunks

# device copies made by store() in every buffer, since import (or since a
# caller reset it to 0)
STORE_COPIES = 0


def as_payload(data) -> torch.Tensor:
    """A payload as a tensor: tensors pass as they are (``copy_`` casts
    and moves them into the row); anything else goes through
    ``np.asarray(..., float32)`` as the JAX buffers take it."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.asarray(data, dtype=np.float32))


class AllReduceBuffer:
    """A ring of ``max_lag`` rows; each row stages ``peer_size`` vectors of
    ``data_size`` float32 elements, filled chunk-by-chunk."""

    def __init__(self, data_size: int, peer_size: int, max_lag: int,
                 max_chunk_size: int, device="cuda"):
        self.data_size = data_size
        self.peer_size = peer_size
        self.max_lag = max_lag
        self.max_chunk_size = max_chunk_size
        self.device = torch.device(device)

        self.temporal_offset = 0
        self.num_chunks = self.get_num_chunk(data_size)
        # (ring row, peer, element) staging storage on the device
        # (reference: AllReduceBuffer.scala:11-15)
        self.temporal_buffer = torch.zeros(
            (max_lag, peer_size, data_size), dtype=torch.float32,
            device=self.device)
        # chunk-granular fill counts per ring row, on the host
        # (reference: AllReduceBuffer.scala:23)
        self.count_filled = np.zeros((max_lag, self.num_chunks), dtype=np.int64)
        # running per-row total of count_filled: the completion gate reads
        # it O(1) per message
        self.total_filled = np.zeros(max_lag, dtype=np.int64)

    def store(self, data, row: int, src_id: int, chunk_id: int) -> None:
        """Copy one chunk into the staging slot and bump its fill count.

        Raises IndexError when the chunk overruns the staging vector,
        before any copy and with the count NOT bumped (reference:
        AllReduceBuffer.scala:25-32; pinned by
        ScatteredDataBufferSpec.scala:32-42).
        """
        global STORE_COPIES
        data = as_payload(data)
        start = chunk_id * self.max_chunk_size
        end = start + data.shape[0]
        if (start < 0 or end > self.data_size
                or src_id < 0 or src_id >= self.peer_size):
            raise IndexError(
                f"chunk [{start}, {end}) from src {src_id} out of bounds for "
                f"buffer of {self.peer_size} peers x {self.data_size} elements")
        t = self._time_idx(row)
        self.temporal_buffer[t, src_id, start:end].copy_(data)
        STORE_COPIES += 1
        self.count_filled[t, chunk_id] += 1
        self.total_filled[t] += 1

    def _time_idx(self, row: int) -> int:
        """Ring indexing (reference: AllReduceBuffer.scala:34-36)."""
        return (row + self.temporal_offset) % self.max_lag

    def up(self) -> None:
        """Rotate the ring: retire the oldest row and zero it on the device
        for reuse as the newest (reference: AllReduceBuffer.scala:38-42)."""
        self.temporal_offset = (self.temporal_offset + 1) % self.max_lag
        t = self._time_idx(self.max_lag - 1)
        self.temporal_buffer[t].zero_()
        self.count_filled[t] = 0
        self.total_filled[t] = 0

    def get_num_chunk(self, size: int) -> int:
        """Chunks covering ``size`` (reference: AllReduceBuffer.scala:44-46)."""
        return _num_chunks(size, self.max_chunk_size)
