"""Typed configuration of the protocol plane.

Counterpart of ``akka_allreduce_tpu/config.py``, copied as it is (pure
Python). It mirrors the reference's three config case classes
(reference: AllreduceMaster.scala:148-150)::

    case class ThresholdConfig(thAllreduce: Float, thReduce: Float, thComplete: Float)
    case class DataConfig(dataSize: Int, maxChunkSize: Int, maxRound: Int)
    case class WorkerConfig(totalSize: Int, maxLag: Int)

plus a combined :class:`AllreduceConfig`. ``max_chunk_size`` is the
reference's wire chunk (reference: AllreduceWorker.scala:220-233); on
the card it is also the width of one masked-reduce launch.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ThresholdConfig:
    """Partial-completion thresholds.

    * ``th_allreduce`` — fraction of workers that must report completion
      before the master advances the round (reference: AllreduceMaster.scala:58).
    * ``th_reduce`` — fraction of peers whose scattered chunk must arrive
      before a chunk is reduced (reference: ScatteredDataBuffer.scala:9).
    * ``th_complete`` — fraction of total reduced chunks that must arrive
      before a round flushes (reference: ReducedDataBuffer.scala:13-17).

    Thresholds < 1 make the allreduce *lossy*: the flushed output may be
    partial, compensated by per-element contribution counts so callers can
    rescale (reference: ReducedDataBuffer.scala:40-48).
    """

    th_allreduce: float = 1.0
    th_reduce: float = 1.0
    th_complete: float = 1.0

    def __post_init__(self) -> None:
        for name in ("th_allreduce", "th_reduce", "th_complete"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0):
                raise ValueError(f"{name} must be in (0, 1], got {v}")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Shape of the data exchanged each round.

    ``max_chunk_size`` is the maximum number of float32 elements per wire
    message (reference: AllreduceWorker.scala:31).
    """

    data_size: int
    max_chunk_size: int = 1024
    max_round: int = 100

    def __post_init__(self) -> None:
        if self.data_size < 0:
            raise ValueError(f"data_size must be >= 0, got {self.data_size}")
        if self.max_chunk_size <= 0:
            raise ValueError(
                f"max_chunk_size must be > 0, got {self.max_chunk_size}"
            )


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """Cluster size and staleness window.

    ``max_lag`` bounds how many rounds a worker may fall behind before it
    force-completes stale rounds (reference: AllreduceWorker.scala:16,
    :100-106); buffers hold ``max_lag + 1`` in-flight rounds
    (reference: AllreduceWorker.scala:64, :74).
    """

    total_size: int
    max_lag: int = 1

    def __post_init__(self) -> None:
        if self.total_size <= 0:
            raise ValueError(f"total_size must be > 0, got {self.total_size}")
        if self.max_lag < 0:
            raise ValueError(f"max_lag must be >= 0, got {self.max_lag}")


@dataclasses.dataclass(frozen=True)
class AllreduceConfig:
    """Combined configuration for one allreduce group."""

    thresholds: ThresholdConfig
    data: DataConfig
    workers: WorkerConfig

    @classmethod
    def default(cls, num_workers: int, data_size: int,
                max_chunk_size: int = 1024) -> "AllreduceConfig":
        """Reference master defaults (reference: AllreduceMaster.scala:98-107):
        maxLag=1, maxRound=100, thAllreduce=1, thReduce=1, thComplete=0.8."""
        return cls(
            thresholds=ThresholdConfig(1.0, 1.0, 0.8),
            data=DataConfig(data_size=data_size, max_chunk_size=max_chunk_size,
                            max_round=100),
            workers=WorkerConfig(total_size=num_workers, max_lag=1),
        )


def num_chunks(size: int, max_chunk_size: int) -> int:
    """Chunks needed to cover ``size`` elements
    (reference: AllReduceBuffer.scala:44-46)."""
    return math.ceil(size / max_chunk_size)


def block_ranges(data_size: int, peer_num: int) -> list[tuple[int, int]]:
    """Block ownership: worker ``i`` owns ``[start_i, end_i)``.

    ``step = ceil(data_size / peer_num)``; the final block absorbs the
    remainder and may be smaller — blocks are uneven in general
    (reference: AllreduceWorker.scala:240-250).
    """
    if peer_num <= 0:
        raise ValueError("peer_num must be > 0")
    step = math.ceil(data_size / peer_num) if data_size > 0 else 0
    if step == 0:
        return [(0, 0)] * peer_num
    starts = list(range(0, data_size, step))
    # range(0, data_size, step) yields <= peer_num starts; pad with empty
    # trailing blocks so every rank has a (possibly empty) range, matching
    # the reference where dataRange has one entry per occupied rank and
    # range(idx) for idx >= peerNum-1 clamps to dataSize.
    ranges = []
    for i in range(peer_num):
        if i < len(starts):
            start = starts[i]
            end = starts[i + 1] if i + 1 < len(starts) else data_size
            ranges.append((start, end))
        else:
            ranges.append((data_size, data_size))
    return ranges
