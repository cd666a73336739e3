"""In-process cluster harness: master + N workers on one router.

Counterpart of ``akka_allreduce_tpu/protocol/cluster.py``. The
deterministic equivalent of the reference's localhost multi-process
cluster (reference: scripts/testAllreduceMaster.sc +
testAllreduceWorker.sc): real master, real workers, real message traffic
— one process, fully reproducible. The workers' payloads live on the
cluster's ``device`` (``cuda`` by default, as the port's entry points
run); the protocol itself runs on the host.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from akka_allreduce_tpu_torch.config import AllreduceConfig, num_chunks
from akka_allreduce_tpu_torch.device import resolve_device
from akka_allreduce_tpu_torch.messages import (
    AllReduceInput,
    AllReduceInputRequest,
    AllReduceOutput,
)
from akka_allreduce_tpu_torch.protocol.master import AllreduceMaster
from akka_allreduce_tpu_torch.protocol.transport import Router
from akka_allreduce_tpu_torch.protocol.worker import AllreduceWorker, \
    DataSink, DataSource


def constant_range_source(data_size: int, device="cuda") -> DataSource:
    """The reference's synthetic source: floats [0, 1, ..., n-1] every round
    (reference: AllreduceWorker.scala:325-326), made once on ``device``.
    The tensor it hands out is :attr:`source.floats`."""
    floats = torch.arange(data_size, dtype=torch.float32, device=device)

    def source(_req: AllReduceInputRequest) -> AllReduceInput:
        return AllReduceInput(floats)

    source.floats = floats
    return source


class ThroughputSink:
    """The reference's benchmark sink: wall-clock goodput every ``checkpoint``
    rounds, with an optional correctness assertion ``output == N x input``,
    ``counts == N`` valid when all thresholds are 1.0
    (reference: AllreduceWorker.scala:329-343).

    On CUDA the device is synchronized at each checkpoint before the
    clock is read (and when the sink is made), so a rate covers the
    rounds' device work, not only their dispatch. The assertion compares
    on the device with ``torch.equal``."""

    def __init__(self, data_size: int, checkpoint: int = 50,
                 assert_multiple: int = 0, verbose: bool = False,
                 device="cuda"):
        self.data_size = data_size
        self.checkpoint = checkpoint
        self.assert_multiple = assert_multiple
        self.verbose = verbose
        self.device = torch.device(device)
        self._expected = None
        self.tic = self._clock()
        self.rates_mbps: list[float] = []
        self.outputs_seen = 0

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, r: AllReduceOutput) -> None:
        self.outputs_seen += 1
        if r.iteration % self.checkpoint == 0 and r.iteration != 0:
            elapsed = self._clock() - self.tic
            nbytes = len(r.data) * 4.0 * self.checkpoint
            rate = nbytes / 1e6 / elapsed if elapsed > 0 else float("inf")
            self.rates_mbps.append(rate)
            if self.verbose:
                print(f"{nbytes / 1e6:.1f} MB in {elapsed:.2f}s "
                      f"at {rate:.3f} MB/s")
            if self.assert_multiple > 0:
                if self._expected is None:
                    base = torch.arange(self.data_size, dtype=torch.float32,
                                        device=self.device)
                    self._expected = (
                        base * self.assert_multiple,
                        torch.full((self.data_size,), self.assert_multiple,
                                   dtype=torch.int32, device=self.device))
                want_data, want_count = self._expected
                if not torch.equal(r.data, want_data):
                    raise AssertionError(
                        f"round {r.iteration}: output != "
                        f"{self.assert_multiple} x input")
                if not torch.equal(r.count, want_count):
                    raise AssertionError(
                        f"round {r.iteration}: counts != "
                        f"{self.assert_multiple}")
            self.tic = self._clock()


class LocalCluster:
    """Spin up a master and ``total_size`` workers on one deterministic
    router, register membership, and pump rounds to completion. The
    workers' payloads live on ``device`` (``cuda`` raises without CUDA,
    as every entry point of the port does)."""

    def __init__(self, config: AllreduceConfig,
                 source_factory: Optional[Callable[[int], DataSource]] = None,
                 sink_factory: Optional[Callable[[int], DataSink]] = None,
                 strict: bool = True, tracer=None, device="cuda"):
        self.config = config
        self.device = resolve_device(str(device))
        self.router = Router()
        self.tracer = tracer
        self.strict = strict
        self.completed_rounds: list[int] = []
        self.master = AllreduceMaster(
            self.router, config,
            on_round_complete=self.completed_rounds.append, tracer=tracer)

        n = config.workers.total_size
        size = config.data.data_size
        src = source_factory or (
            lambda _rank: constant_range_source(size, self.device))
        snk = sink_factory or (lambda _rank: (lambda out: None))
        self.workers = [
            AllreduceWorker(self.router, src(rank), snk(rank),
                            name=f"worker-{rank}", strict=strict,
                            tracer=tracer, device=self.device)
            for rank in range(n)
        ]

    def start(self) -> None:
        """Register every worker with the master (arrival order = rank) —
        the Akka MemberUp flow (reference: AllreduceMaster.scala:36-44)."""
        for w in self.workers:
            self.master.member_up(w.ref)

    def run(self, kill_rank: Optional[int] = None) -> int:
        """Register members and pump until traffic drains. The master paces
        ``config.data.max_round`` rounds (its free-running behavior,
        reference: AllreduceMaster.scala:58-62); if gates can never pass
        (e.g. thresholds=1.0 with a dead worker) the pump drains early and
        fewer rounds complete. ``kill_rank`` kills that worker right after
        registration — the fault-tolerance demo. Returns the number of
        paced rounds."""
        self.start()
        if kill_rank is not None:
            self.kill_worker(kill_rank)
        self.router.pump(max_messages=self._message_budget())
        return len(self.completed_rounds)

    def _message_budget(self) -> int:
        """Scale the pump's runaway-loop cap to the configured workload so
        long healthy runs never trip it: per round each worker sends ~2
        messages per chunk (scatter + reduce) to every peer plus a
        completion; x16 slack on top."""
        n = self.config.workers.total_size
        chunks = max(1, num_chunks(self.config.data.data_size,
                                   self.config.data.max_chunk_size))
        per_round = n * n * 2 * chunks + 4 * n
        rounds = self.config.data.max_round + self.config.workers.max_lag + 2
        return max(1_000_000, 16 * per_round * rounds)

    def kill_worker(self, rank: int) -> None:
        """Simulate a worker death: deathwatch fires on master and peers
        (reference: AllreduceMaster.scala:46-52;
        AllreduceWorker.scala:141-146). ``rank`` is the SEAT (the master's
        view) — after rejoins, list position no longer equals seat."""
        ref = self.master.workers.get(rank)
        if ref is None:
            raise KeyError(f"no live worker in seat {rank}")
        self.router.unregister(ref)
        self.master.terminated(ref)
        for w in self.workers:
            w.terminated(ref)

    def run_until(self, rounds: int, bite: int = 200) -> int:
        """Incremental driver: pump in small bites until ``rounds`` rounds
        have completed or traffic drains. For tests that interleave
        kill/rejoin with progress (run() pumps everything at once)."""
        while len(self.completed_rounds) < rounds:
            if self.router.pump(max_messages=bite, strict=False) == 0:
                break
        return len(self.completed_rounds)

    def add_worker(self, source: Optional[DataSource] = None,
                   sink: Optional[DataSink] = None) -> AllreduceWorker:
        """A fresh worker process joins the running cluster (the rejoin
        flow: the master hands it the lowest free seat and re-inits the
        membership — see AllreduceMaster.member_up)."""
        size = self.config.data.data_size
        w = AllreduceWorker(
            self.router, source or constant_range_source(size, self.device),
            sink or (lambda out: None),
            name=f"worker-joiner-{len(self.workers)}",
            strict=self.strict, tracer=self.tracer, device=self.device)
        self.master.member_up(w.ref)
        if w.ref not in self.master.workers.values():
            # all seats live: the master ignored the joiner — don't keep
            # an uninitialized zombie engine on the router
            self.router.unregister(w.ref)
            return w
        self.workers.append(w)
        return w
