"""The 5-message allreduce wire protocol + the user-plane data API.

Counterpart of ``akka_allreduce_tpu/messages.py``: the same messages,
one-for-one with the reference's case classes (reference:
AllreduceMessage.scala:7-21; the data API DataWrapper.scala:3-7). The
payloads are ``torch.Tensor``s on the protocol engine's device
(``ScatterBlock.value``, ``ReduceBlock.value``, ``AllReduceInput.data``,
``AllReduceOutput.data`` and ``.count``); every other field is a Python
value the engine reads on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

# A WorkerRef is whatever handle the transport routes on (an ActorRef in
# the reference); the in-process router uses small ref objects.
WorkerRef = Any


@dataclasses.dataclass
class InitWorkers:
    """Master -> worker: set rank, peer map, thresholds, data geometry
    (reference: AllreduceMessage.scala:7-17)."""

    workers: Mapping[int, WorkerRef]
    worker_num: int
    master: Optional[WorkerRef]
    dest_id: int
    th_reduce: float
    th_complete: float
    max_lag: int
    data_size: int
    max_chunk_size: int
    # First round this worker participates in: 0 at cluster formation
    # (the reference's only case); the CURRENT round for a mid-run
    # rejoiner, so it does not replay the entire history through the
    # catch-up path (protocol/master.py).
    start_round: int = 0


@dataclasses.dataclass
class StartAllreduce:
    """Master -> workers: begin round ``round``
    (reference: AllreduceMessage.scala:18)."""

    round: int


@dataclasses.dataclass
class ScatterBlock:
    """Worker -> peer owning the block: one chunk of my input for your block
    (reference: AllreduceMessage.scala:19)."""

    value: torch.Tensor  # float32, length <= max_chunk_size
    src_id: int
    dest_id: int
    chunk_id: int
    round: int


@dataclasses.dataclass
class ReduceBlock:
    """Block owner -> all peers: one reduced chunk, with the number of peers
    that contributed (count piggybacking, reference:
    AllreduceMessage.scala:20; ReducedDataBuffer.scala:21-24)."""

    value: torch.Tensor  # float32, length <= max_chunk_size
    src_id: int
    dest_id: int
    chunk_id: int
    round: int
    count: int


@dataclasses.dataclass
class CompleteAllreduce:
    """Worker -> master: I flushed round ``round``
    (reference: AllreduceMessage.scala:21)."""

    src_id: int
    round: int


# ---------------------------------------------------------------------------
# User-plane data API (reference: DataWrapper.scala:3-7,
# AllreduceWorker.scala:305-306)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AllReduceInputRequest:
    """Pull request handed to the user's data source each round."""

    iteration: int


@dataclasses.dataclass
class AllReduceInput:
    """User-supplied input vector for one round."""

    data: torch.Tensor  # float32, length == data_size


@dataclasses.dataclass
class AllReduceOutput:
    """Reduced output pushed to the user's data sink: the (possibly partial)
    sum plus per-element contribution counts so the caller can rescale
    (reference: ReducedDataBuffer.scala:26-53)."""

    data: torch.Tensor  # float32, length == data_size
    count: torch.Tensor  # int32, length == data_size
    iteration: int
