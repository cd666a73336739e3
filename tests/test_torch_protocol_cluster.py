"""The port's in-process cluster against the JAX host plane's.

Every scenario of ``tests/test_cluster.py`` (the reference's
4-worker / 778-float / chunk-3 script config with ``output == 4 x
input``, the README demo, a lossy cluster with a dead worker, the
master's control plane, a live trailing rank after a mid-rank death),
and the seat-reuse rejoin of ``tests/test_rejoin.py`` (``run_until``
with ``add_worker``), runs on the JAX ``LocalCluster`` and on the port's
on the CPU (``device="cpu"``). Each run keeps the scenario's own
assertions; then every output each worker flushed (round, data bytes,
count bytes), the completed rounds and every message a probe received
must be identical on both.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import config as jax_config
from akka_allreduce_tpu import messages as jax_messages
from akka_allreduce_tpu.protocol import cluster as jax_cluster
from akka_allreduce_tpu.protocol import master as jax_master
from akka_allreduce_tpu.protocol import transport as jax_transport
from akka_allreduce_tpu_torch import config as port_config
from akka_allreduce_tpu_torch import messages as port_messages
from akka_allreduce_tpu_torch.protocol import cluster as port_cluster
from akka_allreduce_tpu_torch.protocol import master as port_master
from akka_allreduce_tpu_torch.protocol import transport as port_transport


def as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Side:
    """One engine's modules and a record of what its run produced."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.cfg = port_config if port else jax_config
        self.cluster_mod = port_cluster if port else jax_cluster
        self.M = port_messages if port else jax_messages
        self.Master = (port_master if port else jax_master).AllreduceMaster
        tr = port_transport if port else jax_transport
        self.Router, self.Probe = tr.Router, tr.Probe
        self.kw = {"device": "cpu"} if port else {}
        self.record: list = []

    def config(self, n, data_size, chunk, max_lag=1, max_round=10,
               th=(1.0, 1.0, 1.0)):
        c = self.cfg
        return c.AllreduceConfig(
            thresholds=c.ThresholdConfig(*th),
            data=c.DataConfig(data_size=data_size, max_chunk_size=chunk,
                              max_round=max_round),
            workers=c.WorkerConfig(total_size=n, max_lag=max_lag))

    def source(self, size):
        return self.cluster_mod.constant_range_source(size, **self.kw)

    def cluster(self, config, **kw):
        return self.cluster_mod.LocalCluster(config, **kw, **self.kw)

    def sink(self, rank, outputs=None):
        """A sink that records ``rank``'s flushes (and keeps them in
        ``outputs`` as numpy)."""
        def sink(out):
            data, count = as_numpy(out.data).copy(), as_numpy(out.count).copy()
            self.record.append((rank, out.iteration, str(data.dtype),
                                data.tobytes(), str(count.dtype),
                                count.tobytes()))
            if outputs is not None:
                outputs.append((out.iteration, data, count))
        return sink

    def note(self, *values):
        self.record.append(values)


def four_workers_output_is_four_times_input(s):
    n, data_size = 4, 778
    config = s.config(n, data_size, chunk=3, max_lag=3, max_round=20)
    sinks = [s.cluster_mod.ThroughputSink(data_size, checkpoint=10,
                                          assert_multiple=n, **s.kw)
             for _ in range(n)]

    def sink(r):
        rec = s.sink(r)

        def both(out):
            rec(out)
            sinks[r](out)
        return both

    cluster = s.cluster(config, source_factory=lambda r: s.source(data_size),
                        sink_factory=sink)
    assert cluster.run() == 20
    for snk in sinks:
        assert snk.outputs_seen == 21 and len(snk.rates_mbps) == 2
    s.note("rounds", cluster.completed_rounds)


def readme_cpu_demo_config(s):
    config = s.config(2, 10, chunk=2, max_lag=1, max_round=5)
    outputs = {0: [], 1: []}
    cluster = s.cluster(config,
                        sink_factory=lambda r: s.sink(r, outputs[r]))
    assert cluster.run() == 5
    expected = np.arange(10, dtype=np.float32) * 2
    for r in range(2):
        for _, data, count in outputs[r]:
            np.testing.assert_array_equal(data, expected)
            assert (count == 2).all()
    s.note("rounds", cluster.completed_rounds)


def dead_worker_with_lossy_thresholds_still_completes(s):
    n, data_size = 4, 64
    config = s.config(n, data_size, chunk=16, max_lag=1, max_round=6,
                      th=(0.75, 0.75, 0.75))
    outputs = []
    cluster = s.cluster(config, sink_factory=lambda r: (
        s.sink(r, outputs) if r == 0 else (lambda out: None)))
    cluster.start()
    cluster.kill_worker(3)
    cluster.router.pump()
    assert len(cluster.completed_rounds) == 6
    assert outputs
    for _, data, count in outputs:
        alive = count > 0
        assert alive.any()
        np.testing.assert_allclose(
            data[alive], np.arange(data_size, dtype=np.float32)[alive]
            * count[alive])
    s.note("rounds", cluster.completed_rounds)


def describe(msg):
    kind = type(msg).__name__
    if kind == "InitWorkers":
        return (kind, msg.dest_id, sorted(msg.workers), msg.worker_num,
                msg.th_reduce, msg.th_complete, msg.max_lag, msg.data_size,
                msg.max_chunk_size, msg.start_round)
    return (kind, *(getattr(msg, f) for f in ("round", "src_id")
                    if hasattr(msg, f)))


def quorum_init_and_round_pacing(s):
    router = s.Router()
    probe = s.Probe(router)
    master = s.Master(router, s.config(2, 10, chunk=5, max_round=3))
    master.member_up(probe.ref)
    router.pump()
    probe.expect_no_msg()
    master.member_up(probe.ref)
    msgs = probe.drain()
    kinds = [type(m).__name__ for m in msgs]
    assert kinds.count("InitWorkers") == 2
    assert kinds.count("StartAllreduce") == 2
    assert sorted(m.dest_id for m in msgs
                  if type(m).__name__ == "InitWorkers") == [0, 1]
    s.note(*map(describe, msgs))
    router.send(master.ref, s.M.CompleteAllreduce(0, 99))
    router.pump()
    probe.expect_no_msg()
    router.send(master.ref, s.M.CompleteAllreduce(0, 0))
    router.send(master.ref, s.M.CompleteAllreduce(1, 0))
    msgs = probe.drain()
    assert [m.round for m in msgs
            if type(m).__name__ == "StartAllreduce"] == [1, 1]
    s.note(*map(describe, msgs))


def th_allreduce_below_one_advances_early(s):
    router = s.Router()
    probe = s.Probe(router)
    master = s.Master(router, s.config(4, 10, chunk=5, th=(0.5, 1.0, 1.0)))
    for _ in range(4):
        master.member_up(probe.ref)
    s.note(*map(describe, probe.drain()))
    router.send(master.ref, s.M.CompleteAllreduce(0, 0))
    probe.expect_no_msg()
    router.send(master.ref, s.M.CompleteAllreduce(1, 0))
    msgs = probe.drain()
    assert [m.round for m in msgs
            if type(m).__name__ == "StartAllreduce"] == [1, 1, 1, 1]
    s.note(*map(describe, msgs))


def non_worker_roles_ignored(s):
    router = s.Router()
    probe = s.Probe(router)
    master = s.Master(router, s.config(1, 10, chunk=5))
    master.member_up(probe.ref, role="master")
    assert master.workers == {}
    probe.expect_no_msg()
    s.note("workers", sorted(master.workers))


def deathwatch_removes_worker(s):
    router = s.Router()
    probe = s.Probe(router)
    master = s.Master(router, s.config(3, 10, chunk=5))
    master.member_up(probe.ref)
    other = router.register("other")
    master.member_up(other)
    master.terminated(other)
    assert list(master.workers.keys()) == [0]
    s.note("workers", sorted(master.workers))


def live_trailing_rank_after_mid_rank_death(s):
    n, data_size = 4, 16
    config = s.config(n, data_size, chunk=4, max_lag=1, max_round=4,
                      th=(0.75, 0.75, 0.75))
    outputs = {r: [] for r in range(n)}
    cluster = s.cluster(config, sink_factory=lambda r: s.sink(r, outputs[r]))
    cluster.start()
    cluster.kill_worker(1)
    cluster.router.pump()
    assert len(cluster.completed_rounds) == 4
    assert outputs[3], "rank 3 starved after mid-rank death"
    _, _, count = outputs[3][-1]
    assert (count[0:4] == 3).all() and (count[4:8] == 0).all()
    assert (count[8:16] == 3).all()
    s.note("rounds", cluster.completed_rounds)


def dead_seat_is_refilled_and_counts_recover(s):
    """tests/test_rejoin.py's seat reuse: run_until, kill, add_worker."""
    config = s.config(4, 64, chunk=8, max_lag=2, max_round=60,
                      th=(0.75, 0.75, 0.75))
    outputs: dict = {}
    cluster = s.cluster(
        config, source_factory=lambda r: s.source(64),
        sink_factory=lambda r: s.sink(r, outputs.setdefault(r, [])))
    cluster.start()
    assert cluster.run_until(5) >= 5
    cluster.kill_worker(1)
    assert sorted(cluster.master.workers) == [0, 2, 3]
    assert cluster.run_until(20) >= 20
    _, _, count = outputs[0][-1]
    assert (count[16:32] == 0).all() and (count[:16] > 0).all()
    joined: list = []
    cluster.add_worker(sink=s.sink("joiner", joined))
    assert sorted(cluster.master.workers) == [0, 1, 2, 3]
    assert cluster.run_until(60) >= 60
    assert joined
    _, data, count = joined[-1]
    assert (count[16:32] > 0).all() and np.abs(data).sum() > 0
    assert joined[0][0] >= 15
    s.note("rounds", cluster.completed_rounds)


SCENARIOS = [
    four_workers_output_is_four_times_input, readme_cpu_demo_config,
    dead_worker_with_lossy_thresholds_still_completes,
    quorum_init_and_round_pacing, th_allreduce_below_one_advances_early,
    non_worker_roles_ignored, deathwatch_removes_worker,
    live_trailing_rank_after_mid_rank_death,
    dead_seat_is_refilled_and_counts_recover]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_cluster_matches_jax(scenario):
    sides = [Side("jax"), Side("port")]
    for side in sides:
        scenario(side)
    assert sides[0].record, "the scenario recorded nothing"
    assert sides[1].record == sides[0].record


def test_cuda_cluster_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    config = Side("port").config(2, 10, chunk=2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_cluster.LocalCluster(config)


def test_throughput_sink_assertion_fails_on_a_wrong_output():
    snk = port_cluster.ThroughputSink(4, checkpoint=1, assert_multiple=2,
                                      device="cpu")
    good = port_messages.AllReduceOutput(
        torch.arange(4, dtype=torch.float32) * 2,
        torch.full((4,), 2, dtype=torch.int32), 1)
    snk(good)
    bad = port_messages.AllReduceOutput(
        good.data.clone(), torch.full((4,), 1, dtype=torch.int32), 2)
    with pytest.raises(AssertionError, match="counts != 2"):
        snk(bad)
    assert snk.outputs_seen == 2 and len(snk.rates_mbps) == 2
