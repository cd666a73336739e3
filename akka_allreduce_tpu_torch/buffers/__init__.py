"""Protocol-plane staging buffers: a ``max_lag``-deep ring of per-peer rows.

Counterpart of ``akka_allreduce_tpu/buffers/``, the port of the
reference's buffer layer (reference: buffer/AllReduceBuffer.scala,
buffer/ScatteredDataBuffer.scala, buffer/ReducedDataBuffer.scala). The
staged float32 rows live on the buffers' device; the fill counts and the
threshold gates stay on the host.
"""

from akka_allreduce_tpu_torch.buffers.base import AllReduceBuffer
from akka_allreduce_tpu_torch.buffers.scattered import ScatteredDataBuffer
from akka_allreduce_tpu_torch.buffers.reduced import ReducedDataBuffer

__all__ = ["AllReduceBuffer", "ScatteredDataBuffer", "ReducedDataBuffer"]
