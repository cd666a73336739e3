"""End-to-end straggler tolerance: deadlines -> masks -> lossy training.

Counterpart of ``akka_allreduce_tpu/runtime/straggler.py``. The
reference's signature capability is dynamic per-round straggler
tolerance: a slow worker's contribution misses the thresholds and the
round completes without it, its counts reporting the gap (reference:
AllreduceWorker.scala:100-106, ScatteredDataBuffer.scala:9-13). The
collective itself is bulk-synchronous, so the timeout lives on the host:
:class:`~akka_allreduce_tpu_torch.runtime.pacer.RoundClock` turns arrival
deadlines into per-peer validity, :class:`DeadlineTrainer` turns validity
into the ``(data_rank_count, num_buckets)`` mask that the dynamic train
step consumes (``models/train.py make_train_step(...,
dynamic_valid=True)``), and
:class:`~akka_allreduce_tpu_torch.runtime.pacer.RoundPacer` bounds how far
the host runs ahead of the CUDA stream: the ``maxLag`` window.

A "peer" is a data rank: a rank of the dense gradient sync's group,
the sub-mesh over ``(dp, sp, ep)`` in that order (``models/train.py
data_rank_count``), the JAX package's dp-major data-axis order. On a
mesh with tp or pp every model rank of a data rank (its ``tp`` shards,
its ``pp`` stages) sends that data rank's row, as the JAX mask's
``P(dense_axes, None)`` replicates a row over tp and pp; an ep run's
expert gradients sync exactly, unmasked.

Every rank process runs its own trainer and clock, and they must agree
on every round's mask and fallback: the wires' collectives desynchronise
if one rank falls back alone. Here they agree because every clock is fed
the same scripted offsets (``cli.py train`` draws them from the step's
seeded generator on every rank). Real wall-clock arrivals, which differ
from process to process, reach one clock, the master's, through the
coordinator's store: ``runtime/dcn_train.py`` (``train --coordinator
--deadline-ms``), whose master publishes the mask every process reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from akka_allreduce_tpu_torch.runtime.pacer import RoundClock, RoundPacer


@dataclasses.dataclass
class RoundReport:
    """What one paced round looked like from the host.

    ``valid_peers``/``n_masked`` describe what the clock SAW (before the
    fallback), so a fully-straggled round reports ``n_masked ==
    num_peers`` even though the step ran exact for liveness;
    ``fell_back`` marks those rounds. ``n_dropped`` counts the peers
    whose contribution the round left out: with ``line`` > 1 a late peer
    drops its whole line, and a fallback round drops none."""

    round: int
    valid_peers: tuple[bool, ...]
    n_masked: int
    fell_back: bool = False
    n_dropped: int = 0


class DeadlineTrainer:
    """Stream rounds through a dynamic-valid train step under a deadline.

    ``step(state, tokens, valid) -> metrics`` is the step of
    ``make_train_step(..., dynamic_valid=True)``: it updates ``state``
    (parameters, optimizer, step count and, on the ef8 wire, the
    error-feedback residual) in place, so the trainer carries no state of
    its own besides the clock and the pacer; ``state.residual`` after any
    round is what a checkpoint stores. Masks are whole-peer: a peer that
    misses its deadline is masked for every bucket that round (the
    reference's analogue: a worker whose scatter never arrived
    contributes to no chunk). Per-bucket granularity stays available one
    level down (``allreduce_gradients(valid=...)``).

    ``line`` > 1 masks peers in consecutive groups of that many (the
    lines of the hierarchical schedule's ICI axis, the dense group's
    last live axis, whose exact leg needs the masks of a line to agree:
    ``models/train.py mask_line``): a late peer masks its whole line,
    and a round whose every line has a late peer falls back to exact."""

    def __init__(self, step: Callable, clock: RoundClock, num_buckets: int,
                 max_lag: int = 1, line: int = 1):
        if line < 1 or clock.num_peers % line:
            raise ValueError(f"line={line} must divide the "
                             f"{clock.num_peers} peers")
        self.step = step
        self.clock = clock
        self.num_buckets = num_buckets
        self.line = line
        self.pacer = RoundPacer(max_lag)
        self.reports: list[RoundReport] = []

    @property
    def round(self) -> int:
        return self.pacer.round

    def open_round(self) -> int:
        """Start the deadline clock for the next round and return its
        number. Arrival reports for the round land on the clock between
        this call and :meth:`run_round`."""
        r = self.pacer.round
        self.clock.open_round(r)
        return r

    def run_round(self, state, tokens) -> dict:
        """Build this round's mask from the clock, run the step through
        the pacer and return the round's metrics (device tensors, ready
        once the pacer has harvested the round). The pacer waits only
        when more than ``max_lag + 1`` rounds are in flight (reference:
        AllReduceBuffer.scala:34-42)."""
        r = self.pacer.round
        if not self.clock.is_open(r):
            self.clock.open_round(r)
        observed = self.clock.valid_peers(r)
        valid = [all(observed[p - p % self.line:p - p % self.line
                              + self.line])
                 for p in range(self.clock.num_peers)]
        fell_back = not any(valid)
        if fell_back:
            # an all-masked round would sum to count 0 everywhere and
            # zero the gradient; keep liveness by running it exact, as
            # the reference's master cannot advance below quorum
            # (reference: AllreduceMaster.scala:54-63)
            valid = [True] * self.clock.num_peers
        mask = np.repeat(
            np.asarray(valid, np.float32)[:, None], self.num_buckets, axis=1)
        metrics = self.pacer.submit(lambda _r: self.step(state, tokens, mask))
        # report what the clock observed, not the liveness substitution
        self.reports.append(RoundReport(
            round=r, valid_peers=tuple(bool(v) for v in observed),
            n_masked=sum(1 for v in observed if not v),
            fell_back=fell_back, n_dropped=sum(1 for v in valid if not v)))
        self.clock.expire(r - self.pacer.max_lag)
        return metrics

    def drain(self) -> None:
        self.pacer.drain()

    @property
    def masked_round_count(self) -> int:
        return sum(1 for rep in self.reports if rep.n_masked)
