"""The allreduce worker: the full data-plane protocol state machine.

Counterpart of ``akka_allreduce_tpu/protocol/worker.py``, a behavioral
port of the reference's worker actor (reference:
AllreduceWorker.scala:7-301). Per round: fetch input from the data
source, scatter chunked blocks to their owners, reduce each chunk when
the ``th_reduce`` gate fires (exactly once), broadcast reduced chunks
with contributor counts piggybacked, and complete the round when the
``th_complete`` gate fires — flushing output + per-element counts to the
data sink and reporting to the master. A worker lagging more than
``max_lag`` rounds force-completes stale rounds with whatever arrived
(possibly zeros with count 0) — the bounded-staleness catch-up path
(reference: AllreduceWorker.scala:100-106).

The payloads are tensors on the worker's ``device``: the round's input,
the staging rows of both buffers, every chunk a message carries and the
flushed output. The state machine, its counts and its gates run on the
host. Two differences from the JAX worker:

* a chunk is sent as a view of the worker's private copy of the round's
  input (:meth:`_fetch` makes that copy; :meth:`_scatter` says why a
  view is safe), not copied out one chunk at a time;
* a ``StartAllreduce`` that arrives before ``InitWorkers`` while
  ``discard_blocks`` is set (the rejoin window) is dropped and traced,
  as the C++ engine drops it (``native/src/remote_worker.cpp:315-319``:
  ``if (!discarding) defer_start(r)``), where the JAX Python worker
  re-queues it (ROADMAP C4).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from akka_allreduce_tpu_torch.buffers import (ReducedDataBuffer,
                                              ScatteredDataBuffer)
from akka_allreduce_tpu_torch.buffers.base import as_payload
from akka_allreduce_tpu_torch.config import block_ranges
from akka_allreduce_tpu_torch.messages import (
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
    CompleteAllreduce,
    InitWorkers,
    ReduceBlock,
    ScatterBlock,
    StartAllreduce,
)
from akka_allreduce_tpu_torch.protocol.transport import ActorRef, Router
from akka_allreduce_tpu_torch.runtime.tracing import Tracer

log = logging.getLogger(__name__)

DataSource = Callable[[AllReduceInputRequest], AllReduceInput]
DataSink = Callable[[AllReduceOutput], None]


class AllreduceWorker:
    """One rank's protocol engine.

    ``strict=False`` (default) reproduces the reference's supervision
    behavior: exceptions while handling a message are logged and swallowed so
    one bad message cannot kill the worker
    (reference: AllreduceWorker.scala:287-299 ``tryCatch``). ``strict=True``
    re-raises, for tests that pin the guard conditions. ``device`` holds
    the payloads (``cuda`` or ``cpu``).
    """

    def __init__(self, router: Router, data_source: DataSource,
                 data_sink: DataSink, name: Optional[str] = None,
                 strict: bool = False, tracer: Optional[Tracer] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self._no_data = torch.zeros(0, dtype=torch.float32,
                                    device=self.device)
        self.router = router
        self.data_source = data_source
        self.data_sink = data_sink
        self.strict = strict
        self.tracer = tracer
        self.ref = router.register(name or "worker", handler=self.receive)
        self.generation = -1  # reset() below brings the cold start to 0
        self.reset()
        # Cold start: re-queue pre-init block races (a peer inited first
        # may scatter before our InitWorkers lands). Only the multi-seed
        # REJOIN path flips this to drop — see reset().
        self.discard_blocks = False

    def reset(self) -> None:
        """Return to the cold pre-init state (rank unassigned, buffers
        empty). The multi-seed rejoin path uses this to enter a NEW
        master epoch: a restarted master paces from round 0 with fresh
        seat assignment, so retained round/rank state would deadlock the
        worker against it (the reference's seed-list join admits a
        worker to whatever cluster incarnation is alive,
        application.conf:14-16).

        Until the rejoin dial succeeds, inbound Scatter/Reduce blocks
        are DROPPED, not re-queued: they are old-epoch leftovers (a
        peer cannot send new-epoch traffic before THIS worker joins —
        the new master only inits workers at full quorum, which needs
        our Hello), and re-queueing them would poison the new epoch's
        buffers with old-round chunks. The caller must clear
        ``discard_blocks`` once its redial succeeds; blocks that slip
        through between the redial and the new InitWorkers are fenced
        by round plausibility instead (:meth:`_stale_epoch_round`). A
        ``StartAllreduce`` in that window is dropped too (C4; see
        :meth:`_handle_start`)."""
        self.discard_blocks = True
        self.generation += 1
        # Protocol state (reference: AllreduceWorker.scala:10-31)
        self.id = -1
        self.master: Optional[ActorRef] = None
        self.peers: dict[int, ActorRef] = {}
        self.peer_num = 0
        self.th_reduce = 1.0
        self.th_complete = 1.0
        self.max_lag = 0
        self.round = -1          # current (unfinished) round
        self.max_round = -1      # newest StartAllreduce seen
        self.max_scattered = -1  # newest round scatter() has run for
        self.completed: set[int] = set()

        # Data geometry
        self.data_size = 0
        self.data = self._no_data
        self.ranges: list[tuple[int, int]] = []
        self.my_block_size = 0
        self.max_block_size = 0
        self.min_block_size = 0
        self.max_chunk_size = 1024
        self.scatter_block_buf = ScatteredDataBuffer(0, 0, 1, 1.0, 1024,
                                                     device=self.device)
        self.reduce_block_buf = ReducedDataBuffer(0, 0, 0, 0, 1, 1.0, 1024,
                                                  device=self.device)

    # -- message dispatch ---------------------------------------------------

    def receive(self, msg) -> None:
        """Actor receive block (reference: AllreduceWorker.scala:33-147)."""
        try:
            if isinstance(msg, InitWorkers):
                self._handle_init(msg)
            elif isinstance(msg, StartAllreduce):
                self._handle_start(msg)
            elif isinstance(msg, ScatterBlock):
                if self.id == -1:
                    if self.discard_blocks:
                        log.info("dropping stale pre-rejoin scatter")
                    else:
                        log.warning(
                            "worker not initialized; re-queueing scatter")
                        self.router.send(self.ref, msg)
                else:
                    self.handle_scatter_block(msg)
            elif isinstance(msg, ReduceBlock):
                if self.id == -1:
                    if self.discard_blocks:
                        log.info("dropping stale pre-rejoin reduce")
                    else:
                        log.warning(
                            "worker not initialized; re-queueing reduce")
                        self.router.send(self.ref, msg)
                else:
                    self.handle_reduce_block(msg)
            else:
                log.warning("worker %s: unknown message %r", self.id, msg)
        except Exception:
            if self.strict:
                raise
            log.exception("worker %s: error handling %r", self.id, msg)

    def terminated(self, ref: ActorRef) -> None:
        """Deathwatch: drop a dead peer from the map; thresholds then
        tolerate its missing contributions
        (reference: AllreduceWorker.scala:141-146)."""
        for idx, peer in list(self.peers.items()):
            if peer is ref:
                del self.peers[idx]

    def _stale_epoch_round(self, block_round: int) -> bool:
        """Epoch fence for the block-implied round jump. A block whose
        round exceeds the newest Start by more than the in-flight window
        cannot belong to the current master epoch — within one epoch a
        peer runs at most ``max_lag`` rounds ahead of the pacing we will
        also receive. After a multi-seed rejoin (``generation > 0``)
        such a block is an old-epoch leftover that slipped past the
        discard window: self-starting its round (the cold-start
        catch-up path below) would jump this worker decades ahead of
        the restarted master and stall the cluster. Never fences the
        cold-start generation — its catch-up jumps are the reference's
        own semantics (AllreduceWorker.scala:183-184)."""
        if self.generation > 0 \
                and block_round > self.max_round + self.max_lag + 1:
            log.info("worker %d: dropping old-epoch block round %d "
                     "(newest start %d, lag %d)", self.id, block_round,
                     self.max_round, self.max_lag)
            return True
        return False

    # -- init ---------------------------------------------------------------

    def _handle_init(self, init: InitWorkers) -> None:
        """First init sets everything; a re-init only refreshes the peer map
        (late joiners) (reference: AllreduceWorker.scala:35-90)."""
        if self.id != -1:
            self.peers = dict(init.workers)
            return

        self.id = init.dest_id
        self.master = init.master
        self.peer_num = init.worker_num
        self.peers = dict(init.workers)
        self.th_reduce = init.th_reduce
        self.th_complete = init.th_complete
        self.max_lag = init.max_lag
        self.round = init.start_round
        self.max_round = init.start_round - 1
        self.max_scattered = init.start_round - 1
        self.completed = set()

        self.data_size = init.data_size
        self.data = torch.zeros(self.data_size, dtype=torch.float32,
                                device=self.device)
        self.ranges = block_ranges(self.data_size, self.peer_num)
        self.my_block_size = self._block_size(self.id)
        self.max_block_size = self._block_size(0)
        self.min_block_size = self._block_size(self.peer_num - 1)
        self.max_chunk_size = init.max_chunk_size

        self.scatter_block_buf = ScatteredDataBuffer(
            data_size=self.my_block_size,
            peer_size=self.peer_num,
            max_lag=self.max_lag + 1,
            reducing_threshold=self.th_reduce,
            max_chunk_size=self.max_chunk_size,
            device=self.device,
        )
        self.reduce_block_buf = ReducedDataBuffer(
            max_block_size=self.max_block_size,
            min_block_size=self.min_block_size,
            total_data_size=self.data_size,
            peer_size=self.peer_num,
            max_lag=self.max_lag + 1,
            completion_threshold=self.th_complete,
            max_chunk_size=self.max_chunk_size,
            device=self.device,
        )
        log.info(
            "worker %d: peers %d/%d, thReduce=%s thComplete=%s maxLag=%d",
            self.id, len(self.peers), self.peer_num, self.th_reduce,
            self.th_complete, self.max_lag)

    # -- round start + catch-up --------------------------------------------

    def _handle_start(self, s: StartAllreduce) -> None:
        """Round kick-off, catch-up, and scatter pipelining
        (reference: AllreduceWorker.scala:92-114).

        Before init a Start is re-queued (cold start), except while
        ``discard_blocks`` is set: then it is an old-epoch leftover of
        the rejoin window and is dropped and traced, as the C++ engine
        drops it (``native/src/remote_worker.cpp:315-319``). The JAX
        Python worker re-queues it there too (ROADMAP C4)."""
        if self.id == -1:
            if self.discard_blocks:
                log.info("dropping stale pre-rejoin start %d", s.round)
                if self.tracer is not None:
                    self.tracer.record("pre_rejoin_start_dropped",
                                       worker=self.id, round=s.round)
                return
            log.warning("worker not initialized; re-queueing start")
            self.router.send(self.ref, s)
            return
        self.max_round = max(self.max_round, s.round)
        # Fallen more than max_lag behind: force-complete stale rounds with
        # whatever arrived — zero data, honest count 0 if nothing did
        # (reference: AllreduceWorker.scala:100-106; pinned by the cold
        # catch-up scenario AllreduceSpec.scala:632-656).
        while self.round < self.max_round - self.max_lag:
            if self.tracer is not None:
                self.tracer.record("catchup_force_complete", worker=self.id,
                                   round=self.round, behind=self.max_round)
            for k in range(self.scatter_block_buf.num_chunks):
                reduced, count = self.scatter_block_buf.reduce(0, k)
                self._broadcast(reduced, k, self.round, count)
            self._complete(self.round, 0)
        # Pipeline scatters up to the newest round (max_lag-deep window).
        while self.max_scattered < self.max_round:
            self._fetch(self.max_scattered + 1)
            self._scatter()
            self.max_scattered += 1
        self.completed = {e for e in self.completed if e >= self.round}

    # -- scatter phase ------------------------------------------------------

    def handle_scatter_block(self, s: ScatterBlock) -> None:
        """Stage a peer's chunk of my block; reduce + broadcast when the
        th_reduce gate fires (reference: AllreduceWorker.scala:170-186)."""
        if s.dest_id != self.id:
            raise ValueError(
                f"scatter for {s.dest_id} incorrectly routed to {self.id}")
        if s.round < self.round or s.round in self.completed:
            log.debug("worker %d: outdated scatter round %d", self.id, s.round)
            if self.tracer is not None:
                self.tracer.record("stale_scatter_dropped", worker=self.id,
                                   round=s.round)
        elif s.round <= self.max_round:
            row = s.round - self.round
            self.scatter_block_buf.store(s.value, row, s.src_id, s.chunk_id)
            if self.scatter_block_buf.reach_reducing_threshold(row, s.chunk_id):
                reduced, count = self.scatter_block_buf.reduce(row, s.chunk_id)
                if self.tracer is not None:
                    self.tracer.record("reduce_fired", worker=self.id,
                                       round=s.round, chunk=s.chunk_id,
                                       contributors=count)
                self._broadcast(reduced, s.chunk_id, s.round, count)
        else:
            # A round we haven't been started for: requeue behind a
            # self-sent start (reference: AllreduceWorker.scala:183-184).
            if self._stale_epoch_round(s.round):
                return
            self.router.send(self.ref, StartAllreduce(s.round))
            self.router.send(self.ref, s)

    def _scatter(self) -> None:
        """Send every peer its (chunked) block of my input
        (reference: AllreduceWorker.scala:212-238).

        Each chunk is a VIEW of ``self.data``, not a copy (the JAX worker
        copies each one out). That is safe because nothing can overwrite
        the viewed tensor before a receiver's ``store`` runs:
        ``self.data`` is this worker's private copy of the round's input
        (:meth:`_fetch`), which the engine only ever reads and later
        replaces (never writes in place), and a view keeps it alive
        while the message waits in a mailbox. A data source may so hand
        out one tensor every round, or refill it in place."""
        def send_block(idx, deliver):
            block_start, block_end = self._range(idx)
            peer_block_size = block_end - block_start
            peer_num_chunks = -(-peer_block_size // self.max_chunk_size) \
                if peer_block_size > 0 else 0
            for c in range(peer_num_chunks):
                chunk_start = c * self.max_chunk_size
                chunk_end = min((c + 1) * self.max_chunk_size,
                                peer_block_size)
                chunk = self.data[block_start + chunk_start:
                                  block_start + chunk_end]
                deliver(ScatterBlock(chunk, self.id, idx, c,
                                     self.max_scattered + 1))

        self._fan_out(send_block, self.handle_scatter_block)

    # -- reduce / broadcast phase -------------------------------------------

    def handle_reduce_block(self, r: ReduceBlock) -> None:
        """Stage a reduced chunk; complete the round when the th_complete
        gate fires (reference: AllreduceWorker.scala:149-168)."""
        if len(r.value) > self.max_chunk_size:
            raise ValueError(
                f"reduced block of size {len(r.value)} exceeds max chunk "
                f"size {self.max_chunk_size}")
        if r.dest_id != self.id:
            raise ValueError(
                f"message for {r.dest_id} incorrectly routed to {self.id}")
        if r.round < self.round or r.round in self.completed:
            log.debug("worker %d: outdated reduce round %d", self.id, r.round)
            if self.tracer is not None:
                self.tracer.record("stale_reduce_dropped", worker=self.id,
                                   round=r.round)
        elif r.round <= self.max_round:
            row = r.round - self.round
            self.reduce_block_buf.store(r.value, row, r.src_id, r.chunk_id,
                                        r.count)
            if self.reduce_block_buf.reach_completion_threshold(row):
                self._complete(r.round, row)
        else:
            if self._stale_epoch_round(r.round):
                return
            self.router.send(self.ref, StartAllreduce(r.round))
            self.router.send(self.ref, r)

    def _broadcast(self, data: torch.Tensor, chunk_id: int, bcast_round: int,
                   reduce_count: int) -> None:
        """Fan the reduced chunk out to every peer, count piggybacked
        (reference: AllreduceWorker.scala:252-268)."""
        def send_block(idx, deliver):
            deliver(ReduceBlock(data, self.id, idx, chunk_id, bcast_round,
                                reduce_count))

        self._fan_out(send_block, self.handle_reduce_block)

    def _fan_out(self, send_block, self_handler) -> None:
        """Rank-staggered peer iteration shared by scatter and broadcast:
        start at own rank so all workers don't hammer rank 0 first
        (reference: AllreduceWorker.scala:214, :255), visit ALL peer_num
        rank slots skipping gaps (the reference's ``range(peers.size)`` +
        modular indexing silently starves live trailing ranks once a
        mid-rank peer dies), and deliver to self by direct call, no mailbox
        hop (reference: AllreduceWorker.scala:228-231, :260-263)."""
        for i in range(self.peer_num):
            idx = (i + self.id) % self.peer_num
            peer = self.peers.get(idx)
            if peer is None:
                continue
            if peer is self.ref:
                send_block(idx, self_handler)
            else:
                send_block(idx, lambda msg, p=peer: self.router.send(p, msg))

    # -- completion ---------------------------------------------------------

    def _complete(self, completed_round: int, row: int) -> None:
        """Flush to the sink, report to the master, advance the window past
        any already-completed rounds (reference:
        AllreduceWorker.scala:270-285). Out-of-order completion across rounds
        is legal (pinned by AllreduceSpec.scala:722-732)."""
        self._flush(completed_round, row)
        if self.tracer is not None:
            self.tracer.record("round_complete", worker=self.id,
                               round=completed_round)
        self.data = self._no_data
        if self.master is not None:
            self.router.send(self.master,
                             CompleteAllreduce(self.id, completed_round))
        self.completed.add(completed_round)
        if self.round == completed_round:
            while True:
                self.round += 1
                self.scatter_block_buf.up()
                self.reduce_block_buf.up()
                if self.round not in self.completed:
                    break

    def _flush(self, completed_round: int, row: int) -> None:
        """Deliver (output, per-element counts) to the data sink
        (reference: AllreduceWorker.scala:206-210)."""
        output, counts = self.reduce_block_buf.get_with_counts(row)
        self.data_sink(AllReduceOutput(output, counts, completed_round))

    # -- input --------------------------------------------------------------

    def _fetch(self, round_: int) -> None:
        """Pull the round's input from the data source
        (reference: AllreduceWorker.scala:197-204) into a private f32
        copy on the worker's device: one copy a round, which the
        scattered chunks then view (:meth:`_scatter`). A size mismatch
        raises before the copy."""
        inp = self.data_source(AllReduceInputRequest(round_))
        data = as_payload(inp.data)
        if data.shape[0] != self.data_size:
            raise ValueError(
                f"input size {data.shape[0]} != configured {self.data_size}")
        self.data = data.to(device=self.device, dtype=torch.float32,
                            copy=True)

    # -- geometry helpers ---------------------------------------------------

    def _block_size(self, idx: int) -> int:
        lo, hi = self._range(idx)
        return hi - lo

    def _range(self, idx: int) -> tuple[int, int]:
        """Block ownership (reference: AllreduceWorker.scala:245-250)."""
        return self.ranges[idx]
