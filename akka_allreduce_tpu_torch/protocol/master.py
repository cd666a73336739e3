"""The allreduce master: membership, rank assignment, round pacing.

Counterpart of ``akka_allreduce_tpu/protocol/master.py``, copied as it is
(pure control, no payload) with the port's imports. Behavioral port of
the reference's master actor (reference: AllreduceMaster.scala:12-90):
workers register as they come up (arrival order IS the rank), and once
the quorum of ``total_workers`` is reached the master initializes every
worker and paces rounds — advancing when ``th_allreduce`` of workers
report completion, dropping stale completion reports. Dead workers are
removed by deathwatch; thresholds then tolerate their missing
contributions.
"""

from __future__ import annotations

import logging
from typing import Optional

from akka_allreduce_tpu_torch.config import AllreduceConfig
from akka_allreduce_tpu_torch.messages import (
    CompleteAllreduce,
    InitWorkers,
    StartAllreduce,
)
from akka_allreduce_tpu_torch.protocol.transport import ActorRef, Router
from akka_allreduce_tpu_torch.runtime.tracing import Tracer

log = logging.getLogger(__name__)


class AllreduceMaster:
    def __init__(self, router: Router, config: AllreduceConfig,
                 name: Optional[str] = None,
                 on_round_complete=None, tracer: Optional[Tracer] = None):
        """``on_round_complete(round)`` is an optional callback fired when a
        round's completion gate passes — the hook the round pacer and
        benchmark harness attach to."""
        self.router = router
        self.config = config
        self.total_workers = config.workers.total_size
        self.th_allreduce = config.thresholds.th_allreduce
        self.on_round_complete = on_round_complete
        self.tracer = tracer
        self.ref = router.register(name or "master", handler=self.receive)

        self.workers: dict[int, ActorRef] = {}
        self.round = -1
        self.num_complete = 0

    # -- membership (reference: AllreduceMaster.scala:36-44, :66-74) --------

    def member_up(self, worker_ref: ActorRef, role: str = "worker") -> None:
        """A cluster member came up.

        While FORMING (round == -1): rank = arrival order; on quorum, init
        all workers and start round 0 (reference:
        AllreduceMaster.scala:36-44). While RUNNING: the joiner takes over
        the lowest FREE seat — block ownership is positional (rank i owns
        block i, reference: AllreduceWorker.scala:240-250), so a dead
        rank's seat must be REUSED, not grown past ``total_workers``; the
        reference's ``workers.size`` counter collides with live ranks
        after a lower-ranked death (documented quirk,
        AllreduceMaster.scala:71) — this is the fixed rejoin it gestured
        at. Every worker is re-inited (peer-map refresh, reference:
        AllreduceWorker.scala:87-89) and the joiner is started at the
        current round; its cold-start catch-up force-completes the stale
        window (reference: AllreduceSpec.scala:632-656).

        (The reference resolves the remote actor and deathwatches it; here
        the ref is handed in directly and the owner calls
        :meth:`terminated` on failure.)"""
        if role != "worker":
            return
        free = [r for r in range(self.total_workers)
                if r not in self.workers]
        if self.round == -1:
            # forming: arrival order = rank; with a pre-quorum death the
            # lowest free seat IS arrival order continued (max+1 would
            # push a later arrival past total_workers-1 and break the
            # positional block layout at quorum init)
            if not free:
                log.warning("master: joiner %s ignored — all %d seats "
                            "live", worker_ref, self.total_workers)
                return
            new_id = free[0]
            self.workers[new_id] = worker_ref
            log.info("master: worker %d up (%s), %d/%d", new_id, worker_ref,
                     len(self.workers), self.total_workers)
            if self.tracer is not None:
                self.tracer.record("member_up", rank=new_id,
                                   members=len(self.workers))
            if len(self.workers) >= self.total_workers:
                if self.tracer is not None:
                    self.tracer.record("quorum_init",
                                       members=len(self.workers))
                self._init_workers()
                self.round = 0
                self._start_allreduce()
            return
        if not free:
            log.warning("master: joiner %s ignored — all %d seats live",
                        worker_ref, self.total_workers)
            return
        new_id = free[0]
        self.workers[new_id] = worker_ref
        log.info("master: worker rejoined as rank %d at round %d", new_id,
                 self.round)
        if self.tracer is not None:
            self.tracer.record("member_rejoin", rank=new_id,
                               round=self.round,
                               members=len(self.workers))
        # full init for the joiner STARTING AT THE CURRENT ROUND (a fresh
        # worker would otherwise replay the whole history through
        # catch-up — O(rounds x peers x chunks) messages); peer-map
        # refresh for everyone else
        self._init_workers(start_round=self.round)
        self.router.send(worker_ref, StartAllreduce(self.round))

    def terminated(self, ref: ActorRef) -> None:
        """Deathwatch removal (reference: AllreduceMaster.scala:46-52).
        The freed seat is handed to the next joiner by :meth:`member_up`
        — block ownership is positional, so seats are REUSED (unlike the
        reference, whose rank counter collides after a mid-rank death)."""
        for idx, worker in list(self.workers.items()):
            if worker is ref:
                del self.workers[idx]
                if self.tracer is not None:
                    self.tracer.record("worker_dead", rank=idx,
                                       members=len(self.workers))

    # -- round pacing (reference: AllreduceMaster.scala:54-63) --------------

    def receive(self, msg) -> None:
        if isinstance(msg, CompleteAllreduce):
            self._handle_complete(msg)
        else:
            log.warning("master: unknown message %r", msg)

    def _handle_complete(self, c: CompleteAllreduce) -> None:
        """Tally completions; advance when th_allreduce of workers report.
        Stale rounds' completions are dropped."""
        if c.round != self.round:
            return
        self.num_complete += 1
        if (self.num_complete >= self.total_workers * self.th_allreduce
                and self.round < self.config.data.max_round):
            log.info("master: %d/%d complete round %d", self.num_complete,
                     self.total_workers, self.round)
            if self.on_round_complete is not None:
                self.on_round_complete(self.round)
            self.round += 1
            self._start_allreduce()

    # -- worker init + kick-off (reference: AllreduceMaster.scala:76-89) ----

    def _init_workers(self, start_round: int = 0) -> None:
        for idx, worker in self.workers.items():
            self.router.send(worker, InitWorkers(
                workers=dict(self.workers),
                worker_num=self.total_workers,
                master=self.ref,
                dest_id=idx,
                th_reduce=self.config.thresholds.th_reduce,
                th_complete=self.config.thresholds.th_complete,
                max_lag=self.config.workers.max_lag,
                data_size=self.config.data.data_size,
                max_chunk_size=self.config.data.max_chunk_size,
                start_round=start_round,
            ))

    def _start_allreduce(self) -> None:
        self.num_complete = 0
        if self.tracer is not None:
            self.tracer.record("round_start", round=self.round)
        for worker in self.workers.values():
            self.router.send(worker, StartAllreduce(self.round))
