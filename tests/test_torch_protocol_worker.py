"""The port's protocol worker against the JAX host plane's, message by message.

Every scenario of ``tests/test_protocol_worker.py`` (the port of the
reference's AllreduceSpec: ONE real worker, a probe posing as every peer
and the master, scripted message schedules) runs on the JAX worker and
on the port's worker on the CPU (``device="cpu"``), through one harness.
Each run keeps the scenario's own assertions on the outbound messages;
then the two transcripts — every message the probe received, in order,
with its payload's bytes, and every output the sink was handed — must
be identical.

Then the places where the port differs on purpose:

* the C4 guard: after ``reset()`` with ``discard_blocks`` set, the
  port's worker drops and traces a ``StartAllreduce`` that arrives
  before init, where the JAX Python worker re-queues it (the C++
  engine drops it: ``native/src/remote_worker.cpp:315-319``);
* a chunk is sent as a view of the worker's private copy of the round's
  input, so a source that refills one tensor in place every round still
  gives the JAX transcript;
* ``buffer_state_from_numpy`` starts a port worker from a JAX worker's
  mid-round state, and both then flush bitwise the same catch-up
  outputs.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import messages as jax_messages
from akka_allreduce_tpu.protocol import transport as jax_transport
from akka_allreduce_tpu.protocol.worker import AllreduceWorker as JaxWorker
from akka_allreduce_tpu_torch import messages as port_messages
from akka_allreduce_tpu_torch.convert import buffer_state_from_numpy
from akka_allreduce_tpu_torch.protocol import transport as port_transport
from akka_allreduce_tpu_torch.protocol.worker import \
    AllreduceWorker as PortWorker
from akka_allreduce_tpu_torch.runtime.tracing import Tracer


def to_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def describe(msg) -> tuple:
    """A message as plain values: its kind, fields and payload bytes."""
    kind = type(msg).__name__
    if kind in ("ScatterBlock", "ReduceBlock"):
        v = to_numpy(msg.value)
        return (kind, str(v.dtype), v.tobytes(), msg.src_id, msg.dest_id,
                msg.chunk_id, msg.round, getattr(msg, "count", None))
    if kind == "CompleteAllreduce":
        return (kind, msg.src_id, msg.round)
    if kind == "StartAllreduce":
        return (kind, msg.round)
    raise AssertionError(f"unexpected message {msg!r}")


class Harness:
    """One worker (JAX or port) with a probe as every peer and master;
    records the probe's inbound messages and the sink's outputs."""

    def __init__(self, side, source_fn, size, sink_check=None,
                 strict=True):
        self.side = side
        self.M = jax_messages if side == "jax" else port_messages
        tr = jax_transport if side == "jax" else port_transport
        self.router = tr.Router()
        self.probe = tr.Probe(self.router)
        self.transcript: list = []
        self.outputs: list = []
        self.sink_check = sink_check

        def source(req):
            data = np.array([source_fn(i, req.iteration)
                             for i in range(size)], dtype=np.float32)
            return self.M.AllReduceInput(self.payload(data))

        def sink(r):
            data, count = to_numpy(r.data).copy(), to_numpy(r.count).copy()
            self.outputs.append((r.iteration, str(data.dtype),
                                 data.tobytes(), str(count.dtype),
                                 count.tobytes()))
            if self.sink_check is not None:
                self.sink_check(r.iteration, data, count)

        if side == "jax":
            self.worker = JaxWorker(self.router, source, sink, strict=strict)
        else:
            self.worker = PortWorker(self.router, source, sink,
                                     strict=strict, device="cpu")

    def payload(self, a):
        a = np.asarray(a, dtype=np.float32)
        return a if self.side == "jax" else torch.from_numpy(a.copy())

    def peers_as_probe(self, n):
        return {i: self.probe.ref for i in range(n)}

    def tell(self, msg):
        self.router.send(self.worker.ref, msg)

    def S(self, value, src, dest, chunk, round_):
        return self.M.ScatterBlock(self.payload(value), src, dest, chunk,
                                   round_)

    def R(self, value, src, dest, chunk, round_, count):
        return self.M.ReduceBlock(self.payload(value), src, dest, chunk,
                                  round_, count)

    def start(self, round_):
        return self.M.StartAllreduce(round_)

    def init(self, workers, worker_num, idx, th_reduce, th_complete, max_lag,
             data_size, max_chunk_size):
        self.tell(self.M.InitWorkers(workers, worker_num, self.probe.ref, idx,
                                     th_reduce, th_complete, max_lag,
                                     data_size, max_chunk_size))

    def receive_one(self):
        got = self.probe.receive_one()
        self.transcript.append(describe(got))
        return got

    def expect_scatter(self, value, src, dest, chunk, round_):
        got = self.receive_one()
        assert type(got).__name__ == "ScatterBlock", f"got {got!r}"
        assert (got.src_id, got.dest_id, got.chunk_id, got.round) == (
            src, dest, chunk, round_)
        np.testing.assert_allclose(to_numpy(got.value),
                                   np.asarray(value, np.float32))

    def expect_reduce(self, value, src, dest, chunk, round_, count):
        got = self.receive_one()
        assert type(got).__name__ == "ReduceBlock", f"got {got!r}"
        assert (got.src_id, got.dest_id, got.chunk_id, got.round,
                got.count) == (src, dest, chunk, round_, count)
        np.testing.assert_allclose(to_numpy(got.value),
                                   np.asarray(value, np.float32))

    def expect_complete(self, src_id, round_):
        got = self.receive_one()
        assert describe(got) == ("CompleteAllreduce", src_id, round_)

    def fish_for_complete(self, src_id, round_):
        while True:
            got = self.receive_one()
            if type(got).__name__ == "CompleteAllreduce":
                assert (got.src_id, got.round) == (src_id, round_)
                return

    def drain(self):
        msgs = self.probe.drain()
        self.transcript.extend(describe(m) for m in msgs)
        return msgs

    def expect_no_msg(self):
        self.transcript.append(("silence",))
        self.probe.expect_no_msg()


def basic(idx, it):
    return idx + float(it)


# -- the scenarios of tests/test_protocol_worker.py ------------------------

def sum_up_all_correct_data(side):
    data_size, worker_num, idx = 3, 2, 1
    outs = [[basic(i, it) * worker_num for i in range(data_size)]
            for it in (0, 1)]

    def check(it, data, count):
        np.testing.assert_allclose(data, outs[it])
        np.testing.assert_array_equal(count, [2, 2, 2])

    h = Harness(side, basic, data_size, check)
    workers = h.peers_as_probe(worker_num)
    workers[idx] = h.worker.ref
    h.init(workers, worker_num, idx, 1.0, 1.0, 5, data_size, 2)
    h.tell(h.start(0))
    h.tell(h.S([2], 0, 1, 0, 0))
    h.tell(h.R([0, 2], 0, 1, 0, 0, 2))
    h.tell(h.start(1))
    h.tell(h.S([3], 0, 1, 0, 1))
    h.tell(h.R([2, 4], 0, 1, 0, 1, 2))
    h.fish_for_complete(1, 0)
    h.fish_for_complete(1, 1)
    return h


def future_reduce_completes_then_scatters_ignored(side):
    h = Harness(side, basic, 8)
    h.init(h.peers_as_probe(4), 4, 0, 1.0, 0.8, 5, 8, 2)
    h.tell(h.start(0))
    future = 3
    for src, v in enumerate(([12, 15], [11, 10], [10, 20], [9, 10])):
        h.tell(h.R(v, src, 0, 0, future, 4))
    h.fish_for_complete(0, future)
    for i in range(4):
        h.tell(h.S([2 * i, 2 * i], i, 0, 0, future))
    for m in h.drain():
        assert type(m).__name__ == "ScatterBlock"
    return h


def partial_then_full_peer_map(side):
    h = Harness(side, basic, 8)
    full = h.peers_as_probe(4)
    h.init({0: full[0]}, 4, 0, 1.0, 1.0, 5, 8, 2)
    h.tell(h.start(0))
    h.expect_scatter([0, 1], 0, 0, 0, 0)
    h.expect_no_msg()
    h.init(full, 4, 0, 1.0, 1.0, 5, 8, 2)
    h.tell(h.start(1))
    for i in range(4):
        h.expect_scatter([2 * i + 1, 2 * i + 2], 0, i, 0, 1)
    return h


def single_round_allreduce(side):
    h = Harness(side, basic, 8)
    h.init(h.peers_as_probe(4), 4, 0, 1.0, 0.75, 5, 8, 2)
    h.tell(h.start(0))
    for i in range(4):
        h.expect_scatter([2 * i, 2 * i + 1], 0, i, 0, 0)
    for i in range(4):
        h.tell(h.S([2 * i, 2 * i], i, 0, 0, 0))
    for i in range(4):
        h.expect_reduce([12, 12], 0, i, 0, 0, 4)
    for src, v in enumerate(([12, 15], [11, 10], [10, 20], [9, 10])):
        h.tell(h.R(v, src, 0, 0, 0, 4))
    h.expect_complete(0, 0)
    return h


def uneven_size_sending_to_self_first(side):
    h = Harness(side, basic, 3)
    h.init(h.peers_as_probe(2), 2, 1, 1.0, 1.0, 1, 3, 1)
    h.tell(h.start(0))
    h.expect_scatter([2], 1, 1, 0, 0)
    h.expect_scatter([0], 1, 0, 0, 0)
    h.expect_scatter([1], 1, 0, 1, 0)
    return h


def nasty_chunk_size(side):
    h = Harness(side, basic, 6)
    h.init(h.peers_as_probe(2), 2, 0, 0.9, 0.8, 5, 6, 2)
    h.tell(h.start(0))
    h.expect_scatter([0, 1], 0, 0, 0, 0)
    h.expect_scatter([2], 0, 0, 1, 0)
    h.expect_scatter([3, 4], 0, 1, 0, 0)
    h.expect_scatter([5], 0, 1, 1, 0)
    h.tell(h.S([0, 1], 0, 0, 0, 0))
    h.tell(h.S([2], 0, 0, 1, 0))
    h.tell(h.S([0, 1], 1, 0, 0, 0))
    h.tell(h.S([2], 1, 0, 1, 0))
    h.expect_reduce([0, 1], 0, 0, 0, 0, 1)
    h.expect_reduce([0, 1], 0, 1, 0, 0, 1)
    h.expect_reduce([2], 0, 0, 1, 0, 1)
    h.expect_reduce([2], 0, 1, 1, 0, 1)
    h.tell(h.R([0, 2], 0, 0, 0, 0, 1))
    h.tell(h.R([4], 0, 0, 1, 0, 1))
    h.tell(h.R([6, 8], 1, 0, 0, 0, 1))
    h.expect_complete(0, 0)
    h.tell(h.R([10], 1, 0, 1, 0, 1))
    h.expect_no_msg()
    return h


def nasty_chunk_size_contd(side):
    h = Harness(side, basic, 9)
    h.init(h.peers_as_probe(3), 3, 0, 0.7, 0.7, 5, 9, 1)
    h.tell(h.start(0))
    for dest in range(3):
        for c in range(3):
            h.expect_scatter([dest * 3 + c], 0, dest, c, 0)
    for src in range(3):
        for c in range(3):
            h.tell(h.S([c], src, 0, c, 0))
    for c in range(3):
        for dest in range(3):
            h.expect_reduce([2 * c], 0, dest, c, 0, 2)
    for k, (src, c) in enumerate(((0, 0), (0, 1), (0, 2), (1, 0), (1, 1),
                                  (1, 2))):
        h.tell(h.R([3 * k], src, 0, c, 0, 2))
    h.expect_complete(0, 0)
    for c in range(3):
        h.tell(h.R([18 + 3 * c], 2, 0, c, 0, 2))
    h.expect_no_msg()
    return h


def multi_round(side):
    h = Harness(side, basic, 8)
    h.init(h.peers_as_probe(4), 4, 0, 0.8, 0.5, 5, 8, 2)
    for i in range(10):
        h.tell(h.start(i))
        for d in range(4):
            h.expect_scatter([2 * d + i, 2 * d + 1 + i], 0, d, 0, i)
        for s in range(4):
            h.tell(h.S([0 + i, 1 + i], s, 0, 0, i))
        for d in range(4):
            h.expect_reduce([3 * i, 3 + 3 * i], 0, d, 0, i, 3)
        h.tell(h.R([1, 2], 0, 0, 0, i, 3))
        h.tell(h.R([1, 2], 1, 0, 0, i, 3))
        h.expect_complete(0, i)
        h.tell(h.R([1, 2], 2, 0, 0, i, 3))
        h.tell(h.R([1, 2], 3, 0, 0, i, 3))
        h.expect_no_msg()
    return h


def multi_round_v2(side):
    h = Harness(side, basic, 8)
    h.init(h.peers_as_probe(2), 2, 0, 0.6, 0.8, 5, 8, 2)
    for i in range(10):
        h.tell(h.start(i))
        h.expect_scatter([0 + i, 1 + i], 0, 0, 0, i)
        h.expect_scatter([2 + i, 3 + i], 0, 0, 1, i)
        h.expect_scatter([4 + i, 5 + i], 0, 1, 0, i)
        h.expect_scatter([6 + i, 7 + i], 0, 1, 1, i)
        h.tell(h.S([0 + i, 1 + i], 0, 0, 0, i))
        h.tell(h.S([2 + i, 3 + i], 0, 0, 1, i))
        h.tell(h.S([10 + i, 11 + i], 1, 0, 0, i))
        h.tell(h.S([12 + i, 13 + i], 1, 0, 1, i))
        h.expect_reduce([0 + i, 1 + i], 0, 0, 0, i, 1)
        h.expect_reduce([0 + i, 1 + i], 0, 1, 0, i, 1)
        h.expect_reduce([2 + i, 3 + i], 0, 0, 1, i, 1)
        h.expect_reduce([2 + i, 3 + i], 0, 1, 1, i, 1)
        h.tell(h.R([1, 2], 0, 0, 0, i, 1))
        h.tell(h.R([1, 2], 0, 0, 1, i, 1))
        h.tell(h.R([1, 2], 1, 0, 0, i, 1))
        h.expect_complete(0, i)
        h.tell(h.R([1, 2], 1, 0, 1, i, 1))
        h.expect_no_msg()
    return h


def missed_scatter(side):
    h = Harness(side, basic, 4)
    h.init(h.peers_as_probe(4), 4, 0, 0.75, 0.75, 5, 4, 2)
    h.tell(h.start(0))
    for d in range(4):
        h.expect_scatter([d], 0, d, 0, 0)
    h.tell(h.S([0], 0, 0, 0, 0))
    h.expect_no_msg()
    h.tell(h.S([2], 1, 0, 0, 0))
    h.expect_no_msg()
    h.tell(h.S([4], 2, 0, 0, 0))
    h.tell(h.S([6], 3, 0, 0, 0))
    for d in range(4):
        h.expect_reduce([6], 0, d, 0, 0, 3)
    h.tell(h.R([12], 0, 0, 0, 0, 3))
    h.tell(h.R([11], 1, 0, 0, 0, 3))
    h.tell(h.R([10], 2, 0, 0, 0, 3))
    h.expect_complete(0, 0)
    h.tell(h.R([9], 3, 0, 0, 0, 3))
    h.expect_no_msg()
    return h


def future_scatter(side):
    h = Harness(side, basic, 4)
    h.init(h.peers_as_probe(4), 4, 0, 0.75, 0.75, 5, 4, 2)
    h.tell(h.start(0))
    for d in range(4):
        h.expect_scatter([d], 0, d, 0, 0)
    h.tell(h.S([2], 1, 0, 0, 0))
    h.tell(h.S([4], 2, 0, 0, 0))
    h.tell(h.R([11], 1, 0, 0, 0, 3))
    h.tell(h.R([10], 2, 0, 0, 0, 3))
    h.tell(h.start(1))
    h.tell(h.S([2], 1, 0, 0, 1))
    h.tell(h.S([4], 2, 0, 0, 1))
    h.tell(h.S([6], 3, 0, 0, 1))
    for d in range(4):
        h.expect_scatter([d + 1], 0, d, 0, 1)
    for d in range(4):
        h.expect_reduce([12], 0, d, 0, 1, 3)
    h.tell(h.S([0], 3, 0, 0, 0))
    h.tell(h.S([6], 3, 0, 0, 0))
    for d in range(4):
        h.expect_reduce([6], 0, d, 0, 0, 3)
    h.tell(h.R([9], 3, 0, 0, 0, 3))
    h.expect_complete(0, 0)
    h.tell(h.R([11], 1, 0, 0, 1, 3))
    h.tell(h.R([10], 2, 0, 0, 1, 3))
    h.tell(h.R([9], 3, 0, 0, 1, 3))
    h.expect_complete(0, 1)
    return h


def missed_reduce(side):
    h = Harness(side, basic, 4)
    h.init(h.peers_as_probe(4), 4, 0, 1.0, 0.75, 5, 4, 100)
    h.tell(h.start(0))
    for d in range(4):
        h.expect_scatter([d], 0, d, 0, 0)
    for src in range(4):
        h.tell(h.S([2 * src], src, 0, 0, 0))
    for d in range(4):
        h.expect_reduce([12], 0, d, 0, 0, 4)
    h.tell(h.R([12], 0, 0, 0, 0, 4))
    h.expect_no_msg()
    h.tell(h.R([11], 1, 0, 0, 0, 4))
    h.expect_no_msg()
    h.tell(h.R([10], 2, 0, 0, 0, 4))
    h.expect_complete(0, 0)
    return h


def delayed_future_reduce(side):
    h = Harness(side, basic, 4)
    h.init(h.peers_as_probe(4), 4, 0, 0.75, 0.75, 5, 4, 100)
    h.tell(h.start(0))
    for d in range(4):
        h.expect_scatter([d], 0, d, 0, 0)
    h.tell(h.S([2], 1, 0, 0, 0))
    h.tell(h.S([4], 2, 0, 0, 0))
    h.tell(h.S([6], 3, 0, 0, 0))
    for d in range(4):
        h.expect_reduce([12], 0, d, 0, 0, 3)
    h.tell(h.start(1))
    h.tell(h.S([3], 1, 0, 0, 1))
    h.tell(h.S([5], 2, 0, 0, 1))
    h.tell(h.S([7], 3, 0, 0, 1))
    for d in range(4):
        h.expect_scatter([d + 1], 0, d, 0, 1)
    for d in range(4):
        h.expect_reduce([15], 0, d, 0, 1, 3)
    for src, v in ((1, 11), (2, 10), (3, 9)):
        h.tell(h.R([v], src, 0, 0, 0, 3))
        h.tell(h.R([v], src, 0, 0, 1, 3))
    h.expect_complete(0, 0)
    h.expect_complete(0, 1)
    return h


def expect_basic_scatters(h, i):
    for d in range(4):
        h.expect_scatter([2 * d + i, 2 * d + 1 + i], 0, d, 0, i)


def simple_catchup(side):
    h = Harness(side, basic, 8)
    h.init(h.peers_as_probe(4), 4, 0, 1.0, 1.0, 5, 8, 2)
    for i in range(6):
        h.tell(h.start(i))
        expect_basic_scatters(h, i)
        for src, k in ((1, 1), (2, 2), (3, 4)):
            h.tell(h.S([k * (i + 1)] * 2, src, 0, 0, i))
        for src in (1, 2, 3):
            h.tell(h.R([12, 12], src, 0, 0, i, 4))
    for catchup_round in (6, 7, 8):
        h.tell(h.start(catchup_round))
        completion = catchup_round - 6
        v = 7.0 * (completion + 1)
        for d in range(4):
            h.expect_reduce([v, v], 0, d, 0, completion, 3)
        h.expect_complete(0, completion)
        expect_basic_scatters(h, catchup_round)
    return h


def cold_catchup(side):
    h = Harness(side, basic, 8)
    h.init(h.peers_as_probe(4), 4, 0, 1.0, 1.0, 5, 8, 2)
    h.tell(h.start(10))
    for i in range(5):
        for d in range(4):
            h.expect_reduce([0, 0], 0, d, 0, i, 0)
        h.expect_complete(0, i)
    for i in range(11):
        expect_basic_scatters(h, i)
    return h


def round1_completes_before_round0(side):
    h = Harness(side, basic, 9)
    h.init(h.peers_as_probe(3), 3, 0, 0.75, 0.75, 5, 9, 2)
    h.tell(h.start(0))
    for d, (a, b) in enumerate(((0, 2), (3, 5), (6, 8))):
        h.expect_scatter([a, a + 1], 0, d, 0, 0)
        h.expect_scatter([b], 0, d, 1, 0)
    for src in range(3):
        h.tell(h.S([0, 1], src, 0, 0, 0))
    for src in range(3):
        h.tell(h.S([2], src, 0, 1, 0))
    for d in range(3):
        h.expect_reduce([0, 2], 0, d, 0, 0, 2)
    for d in range(3):
        h.expect_reduce([4], 0, d, 1, 0, 2)
    h.tell(h.start(1))
    h.tell(h.S([10, 11], 1, 0, 0, 1))
    h.tell(h.S([12], 1, 0, 1, 1))
    h.tell(h.S([10, 11], 2, 0, 0, 1))
    h.tell(h.S([12], 2, 0, 1, 1))
    for d, (a, b) in enumerate(((1, 3), (4, 6), (7, 9))):
        h.expect_scatter([a, a + 1], 0, d, 0, 1)
        h.expect_scatter([b], 0, d, 1, 1)
    for d in range(3):
        h.expect_reduce([20, 22], 0, d, 0, 1, 2)
    for d in range(3):
        h.expect_reduce([24], 0, d, 1, 1, 2)
    h.tell(h.R([11, 11], 1, 0, 0, 0, 2))
    h.tell(h.R([11], 1, 0, 1, 1, 2))
    h.tell(h.R([11, 11], 1, 0, 0, 1, 2))
    h.tell(h.R([11], 1, 0, 1, 0, 2))
    h.tell(h.R([11, 11], 2, 0, 0, 0, 2))
    h.tell(h.R([11], 2, 0, 1, 1, 2))
    h.expect_no_msg()
    h.tell(h.R([11, 11], 2, 0, 0, 1, 2))
    h.expect_complete(0, 1)
    h.tell(h.R([11], 2, 0, 1, 0, 2))
    h.expect_complete(0, 0)
    return h


def oversized_reduce_block_raises(side):
    h = Harness(side, basic, 4)
    h.init(h.peers_as_probe(2), 2, 0, 1.0, 1.0, 1, 4, 2)
    h.router.pump()
    with pytest.raises(ValueError, match="exceeds max chunk") as exc:
        h.worker.handle_reduce_block(h.R([1, 2, 3], 1, 0, 0, 0, 1))
    h.transcript.append(("raised", str(exc.value)))
    return h


def misrouted_reduce_block_raises(side):
    h = Harness(side, basic, 4)
    h.init(h.peers_as_probe(2), 2, 0, 1.0, 1.0, 1, 4, 2)
    h.router.pump()
    with pytest.raises(ValueError, match="incorrectly routed") as exc:
        h.worker.handle_reduce_block(h.R([1], 1, 1, 0, 0, 1))
    h.transcript.append(("raised", str(exc.value)))
    return h


def uninitialized_worker_requeues(side):
    h = Harness(side, basic, 8)
    h.tell(h.start(0))
    with pytest.raises(RuntimeError, match="re-queue loop") as exc:
        h.router.pump(max_messages=50)
    h.transcript.append(("raised", str(exc.value)))
    h.init(h.peers_as_probe(4), 4, 0, 1.0, 1.0, 5, 8, 2)
    for d in range(4):
        h.expect_scatter([2 * d, 2 * d + 1], 0, d, 0, 0)
    return h


SCENARIOS = [
    sum_up_all_correct_data, future_reduce_completes_then_scatters_ignored,
    partial_then_full_peer_map, single_round_allreduce,
    uneven_size_sending_to_self_first, nasty_chunk_size,
    nasty_chunk_size_contd, multi_round, multi_round_v2, missed_scatter,
    future_scatter, missed_reduce, delayed_future_reduce, simple_catchup,
    cold_catchup, round1_completes_before_round0,
    oversized_reduce_block_raises, misrouted_reduce_block_raises,
    uninitialized_worker_requeues]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_worker_transcript_matches_jax(scenario):
    runs = [scenario(side) for side in ("jax", "port")]
    for h in runs:
        h.drain()
    jax_run, port_run = runs
    assert jax_run.transcript, "the scenario received nothing"
    assert port_run.transcript == jax_run.transcript
    assert port_run.outputs == jax_run.outputs


def test_flushed_output_lives_on_the_worker_device():
    h = sum_up_all_correct_data("port")
    w = h.worker
    assert w.scatter_block_buf.temporal_buffer.device.type == "cpu"
    assert w.reduce_block_buf.temporal_buffer.device.type == "cpu"
    assert len(h.outputs) == 2 and h.outputs[0][3] == "int32"


# -- C4: a Start before init inside the rejoin discard window ---------------

def c4_run(side):
    """A worker that re-entered the cold pre-init state for a rejoin
    (``reset()`` sets ``discard_blocks``) receives a leftover
    ``StartAllreduce(7)``, then its new epoch's InitWorkers and Start(0).
    """
    h = Harness(side, basic, 4)
    tracer = Tracer() if side == "port" else None
    h.worker.tracer = tracer
    h.init(h.peers_as_probe(2), 2, 0, 1.0, 1.0, 1, 4, 2)
    h.router.pump()
    h.worker.reset()
    assert h.worker.discard_blocks and h.worker.id == -1
    h.tell(h.start(7))
    h.router.pump(max_messages=20, strict=False)
    mailbox = list(h.router.mailbox(h.worker.ref))
    h.worker.discard_blocks = False  # the redial succeeded
    h.init(h.peers_as_probe(2), 2, 0, 1.0, 1.0, 1, 4, 2)
    h.tell(h.start(0))
    msgs = h.drain()
    return h, tracer, mailbox, msgs


def test_c4_port_drops_a_start_in_the_discard_window_jax_requeues():
    """ROADMAP C4. The JAX Python worker re-queues a ``StartAllreduce``
    that arrives before init even while ``discard_blocks`` is set
    (``akka_allreduce_tpu/protocol/worker.py:237-241``), so the stale
    Start(7) survives into the new epoch and the worker jumps to round
    7. The C++ engine drops it while discarding
    (``native/src/remote_worker.cpp:315-319``: ``if (!discarding)
    defer_start(r)``); the port's worker follows the C++ guard: the
    Start is dropped, traced, and the new epoch starts at round 0."""
    _, _, jax_box, jax_msgs = c4_run("jax")
    h, tracer, port_box, port_msgs = c4_run("port")
    # JAX: the Start is still cycling through the mailbox
    assert [type(m).__name__ for m in jax_box] == ["StartAllreduce"]
    assert {m.round for m in jax_msgs} == set(range(8))
    # port: dropped at once, traced, and only round 0 is scattered
    assert port_box == []
    assert tracer.counters["pre_rejoin_start_dropped"] == 1
    (ev,) = [e for e in tracer.events
             if e.kind == "pre_rejoin_start_dropped"]
    assert ev.fields == {"worker": -1, "round": 7}
    assert {m.round for m in port_msgs} == {0}
    assert h.worker.round == 0


def test_cold_start_still_requeues_a_start_before_init():
    """Outside the rejoin window (``discard_blocks`` False, the cold
    start) the port re-queues as JAX does: covered bitwise by
    ``uninitialized_worker_requeues`` above; here the flag itself."""
    h = Harness("port", basic, 8)
    assert h.worker.discard_blocks is False
    h.tell(h.start(0))
    h.router.pump(max_messages=5, strict=False)
    assert len(h.router.mailbox(h.worker.ref)) == 1


# -- views, not copies ------------------------------------------------------

def test_source_refilled_in_place_gives_the_jax_transcript():
    """The port's chunks view the worker's private copy of the round's
    input, so a source that hands out ONE tensor and refills it in place
    each round (while round r's scatters still wait in the probe's
    mailbox) gives the same transcript as a fresh array a round."""
    def run(side, refill):
        h = Harness(side, basic, 8)
        if refill:
            buf = torch.zeros(8)

            def source(req):
                buf.copy_(torch.tensor([basic(i, req.iteration)
                                        for i in range(8)]))
                return port_messages.AllReduceInput(buf)
            h.worker.data_source = source
        h.init(h.peers_as_probe(4), 4, 0, 1.0, 1.0, 5, 8, 2)
        for i in range(3):
            h.tell(h.start(i))
        h.router.pump()
        return h.drain()

    want = [describe(m) for m in run("jax", False)]
    got = [describe(m) for m in run("port", True)]
    assert got == want and len(want) == 12


def test_fetch_refuses_a_wrong_size():
    h = Harness("port", basic, 8)
    h.worker.data_source = lambda req: port_messages.AllReduceInput(
        torch.zeros(7))
    h.init(h.peers_as_probe(2), 2, 0, 1.0, 1.0, 1, 8, 2)
    h.tell(h.start(0))
    with pytest.raises(ValueError, match="input size 7 != configured 8"):
        h.router.pump()


# -- continuing from a JAX mid-round state ----------------------------------

def test_port_worker_continues_from_a_jax_mid_round_state():
    """A JAX worker is driven partway through rounds 0-2 (partial
    scatters and reduces staged in both buffers, the ring rotated once);
    its buffers (``buffer_state_from_numpy``) and round state are carried
    into a port worker initialised the same way. A Start far ahead then
    force-completes the staged rounds on both (the catch-up path): the
    catch-up reduces, completions and flushed outputs are bitwise equal."""
    def drive(h):
        h.init(h.peers_as_probe(3), 3, 0, 1.0, 1.0, 2, 9, 2)
        for i in range(3):
            h.tell(h.start(i))
            h.tell(h.S([1 + i, 2 + i], 1, 0, 0, i))
            h.tell(h.S([5 + i], 2, 0, 1, i))
        h.tell(h.S([3, 4], 2, 0, 0, 0))
        h.tell(h.S([7], 0, 0, 1, 0))
        h.tell(h.S([0.5, 0.25], 0, 0, 0, 0))
        h.tell(h.R([9, 9], 1, 0, 0, 0, 3))
        h.tell(h.R([8, 7], 2, 0, 0, 1, 3))
        h.tell(h.R([6], 0, 0, 1, 1, 2))
        h.router.pump()
        h.drain()

    jax_h = Harness("jax", basic, 9, strict=True)
    drive(jax_h)
    port_h = Harness("port", basic, 9, strict=True)
    port_h.init(port_h.peers_as_probe(3), 3, 0, 1.0, 1.0, 2, 9, 2)
    port_h.router.pump()
    jw, pw = jax_h.worker, port_h.worker
    for name in ("scatter_block_buf", "reduce_block_buf"):
        buffer_state_from_numpy(getattr(jw, name), device="cpu",
                                into=getattr(pw, name))
    for name in ("round", "max_round", "max_scattered"):
        setattr(pw, name, getattr(jw, name))
    pw.completed = set(jw.completed)
    jax_h.transcript.clear()
    jax_h.outputs.clear()
    for h in (jax_h, port_h):
        h.tell(h.start(6))
        h.tell(h.R([1, 2], 1, 0, 0, 4, 3))
        h.drain()
    assert jax_h.outputs and port_h.outputs == jax_h.outputs
    assert port_h.transcript == jax_h.transcript
    # Start(6) at max_lag 2 force-completes rounds 0-3 (0-2 staged)
    assert [t[2] for t in jax_h.transcript
            if t[0] == "CompleteAllreduce"] == [0, 1, 2, 3]
