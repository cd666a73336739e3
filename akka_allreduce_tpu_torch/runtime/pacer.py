"""Round pacing: the ``max_lag`` bounded-staleness window on the card.

Counterpart of ``akka_allreduce_tpu/runtime/pacer.py``. The reference
keeps up to ``maxLag`` rounds in flight through its ring buffers
(reference: AllReduceBuffer.scala:9-42; AllreduceWorker.scala:16,
:100-111). The JAX package leans on asynchronous dispatch and blocks on
the oldest round's result; PyTorch enqueues a step's kernels on the CUDA
stream and returns as well, so :class:`RoundPacer` records a
``torch.cuda.Event`` on the current stream right after ``step(r)``
returns and synchronises that event when the round is harvested. It
bounds how far the host runs ahead of the stream to ``max_lag + 1``
rounds. In a process that has not initialised CUDA (a CPU run) there is
no event: a step's work is done when it returns, and harvesting just
retires the round. ``on_harvest(r)``, when set, is called as round ``r``
is harvested, the point where its results may be read without waiting
for the rounds behind it.

:class:`RoundClock` turns "peer X's contribution for round r missed its
deadline" into per-peer validity, from which the deadline trainer
(``runtime/straggler.py``) builds the contribution masks of the lossy
sync (``ops/masked.py``). It is pure bookkeeping, the JAX class as it is.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Optional

import torch


class RoundPacer:
    """Bound in-flight rounds to ``max_lag + 1``, like the reference's ring
    of ``maxLag + 1`` buffer rows (reference: AllreduceWorker.scala:64)."""

    def __init__(self, max_lag: int = 1,
                 on_harvest: Optional[Callable[[int], None]] = None):
        if max_lag < 0:
            raise ValueError("max_lag must be >= 0")
        self.max_lag = max_lag
        self.on_harvest = on_harvest
        self._inflight: collections.deque = collections.deque()
        self._next_round = 0
        self.completed_rounds: list[int] = []

    @property
    def round(self) -> int:
        return self._next_round

    def submit(self, step: Callable[[int], Any]) -> Any:
        """Run ``step(round)`` (a train step: its kernels are enqueued on
        the stream when it returns) and record an event behind them. If
        the window is full, first wait for the oldest round: that is the
        pacing stall."""
        while len(self._inflight) > self.max_lag:
            self._harvest_oldest()
        r = self._next_round
        out = step(r)
        event = None
        if torch.cuda.is_initialized():
            event = torch.cuda.Event()
            event.record()  # on the current stream, behind the step
        self._inflight.append((r, event))
        self._next_round += 1
        return out

    def _harvest_oldest(self) -> None:
        r, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        self.completed_rounds.append(r)
        if self.on_harvest is not None:
            self.on_harvest(r)

    def drain(self) -> None:
        """Wait until every in-flight round has completed."""
        while self._inflight:
            self._harvest_oldest()


class RoundClock:
    """Deadline bookkeeping → contribution masks.

    Peers report arrival times per round (over the network in a
    deployment; tests and the CLI script them). ``valid_peers(round)``
    returns, for each peer, whether its contribution landed inside the
    round's deadline. A peer with no report at all is a cold straggler:
    masked until it reports again, mirroring deathwatch + threshold
    tolerance (reference: AllreduceMaster.scala:46-52).
    """

    def __init__(self, num_peers: int, deadline_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.num_peers = num_peers
        self.deadline_s = deadline_s
        self.clock = clock
        self._round_open: dict[int, float] = {}
        self._arrivals: dict[int, dict[int, float]] = {}

    def open_round(self, round_: int) -> None:
        self._round_open[round_] = self.clock()
        self._arrivals.setdefault(round_, {})

    def is_open(self, round_: int) -> bool:
        return round_ in self._round_open

    def opened_at(self, round_: int) -> float:
        """Monotonic time the round's deadline clock started."""
        return self._round_open[round_]

    def arrival_count(self, round_: int) -> int:
        """How many peers have reported for the round (on time or not)."""
        return len(self._arrivals.get(round_, ()))

    def has_arrived(self, round_: int, peer: int) -> bool:
        """Whether ``peer`` has reported for the round (on time or
        not)."""
        return peer in self._arrivals.get(round_, ())

    def report_arrival(self, round_: int, peer: int,
                       at: Optional[float] = None) -> None:
        self._arrivals.setdefault(round_, {})[peer] = \
            self.clock() if at is None else at

    def report_offset(self, round_: int, peer: int, offset_s: float) -> None:
        """Report an arrival ``offset_s`` after the round opened: the
        scripted-schedule form (tests, the CLI's straggler simulation)
        that stays deterministic under a real wall clock."""
        opened = self._round_open.get(round_)
        if opened is None:
            raise ValueError(f"round {round_} was never opened")
        self._arrivals.setdefault(round_, {})[peer] = opened + offset_s

    def valid_peers(self, round_: int) -> list[bool]:
        """True per peer iff its round contribution arrived in time."""
        opened = self._round_open.get(round_)
        arrivals = self._arrivals.get(round_, {})
        out = []
        for p in range(self.num_peers):
            t = arrivals.get(p)
            out.append(t is not None and opened is not None
                       and (t - opened) <= self.deadline_s)
        return out

    def expire(self, up_to_round: int) -> None:
        """Forget state for rounds below ``up_to_round`` (the ring
        rotation). Sweeps arrivals independently of open state: a late
        report for an already-expired round re-creates an arrivals entry
        with no matching open record, and an open-keyed sweep alone would
        leak those under a chronically straggling peer."""
        for r in [r for r in self._round_open if r < up_to_round]:
            del self._round_open[r]
        for r in [r for r in self._arrivals if r < up_to_round]:
            del self._arrivals[r]
