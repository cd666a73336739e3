"""The port's schedule explorer against the JAX package's.

The scenarios of ``tests/test_schedule_explorer.py`` that run clusters
under families of delivery orders (``Router.pump_scheduled``): the
standard battery and every 7-step startup prefix at thresholds 1.0, a
dead worker under lossy thresholds, the schedule machinery itself, and
the exhaustive-prefix exploration with canonical state dedup. Each runs
on the JAX explorer over JAX clusters and on the port's explorer over
the port's clusters on the CPU (``device="cpu"``), with the scenario's
own invariants checked on each; both must give the same verdict under
the same schedules (the same failing labels), and the exhaustive mode
the same report: as many prefixes run and pruned, and as many distinct
canonical states. The config-space fuzz, the 4-worker script config and
``emulate --fuzz`` are in ``test_torch_protocol_fuzz.py``.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import config as jax_config
from akka_allreduce_tpu.protocol import cluster as jax_cluster
from akka_allreduce_tpu.protocol import explorer as jax_explorer
from akka_allreduce_tpu_torch import config as port_config
from akka_allreduce_tpu_torch.protocol import cluster as port_cluster
from akka_allreduce_tpu_torch.protocol import explorer as port_explorer


def as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Side:
    def __init__(self, name):
        port = name == "port"
        self.name = name
        self.cfg = port_config if port else jax_config
        self.cl = port_cluster if port else jax_cluster
        self.ex = port_explorer if port else jax_explorer
        self.kw = {"device": "cpu"} if port else {}

    def config(self, n, data_size, chunk, max_lag=1, max_round=5,
               th=(1.0, 1.0, 1.0)):
        c = self.cfg
        return c.AllreduceConfig(
            thresholds=c.ThresholdConfig(*th),
            data=c.DataConfig(data_size=data_size, max_chunk_size=chunk,
                              max_round=max_round),
            workers=c.WorkerConfig(total_size=n, max_lag=max_lag))

    def cluster(self, config, outputs, n, data_size):
        for r in range(n):
            outputs[r] = []
        return self.cl.LocalCluster(
            config,
            source_factory=lambda r: self.cl.constant_range_source(
                data_size, **self.kw),
            sink_factory=lambda r: outputs[r].append, **self.kw)

    def make_exact(self, outputs, n=2, data_size=10, max_round=5):
        config = self.config(n, data_size, chunk=2, max_lag=1,
                             max_round=max_round)
        return lambda: self.cluster(config, outputs, n, data_size)


def exact_validator(outputs, n, data_size, max_round):
    """thresholds=1.0: every flush exactly N x input with counts N, and
    every round completes under every legal ordering."""
    expected = np.arange(data_size, dtype=np.float32) * n

    def validate(cluster):
        if len(cluster.completed_rounds) != max_round:
            raise AssertionError(
                f"completed {len(cluster.completed_rounds)} rounds, "
                f"wanted {max_round}")
        for r in range(n):
            if len(outputs[r]) != max_round + 1:
                raise AssertionError(
                    f"worker {r} flushed {len(outputs[r])} outputs")
            for out in outputs[r]:
                np.testing.assert_array_equal(as_numpy(out.data), expected)
                assert (as_numpy(out.count) == n).all()

    return validate


def labels(failures):
    return [f.label for f in failures]


def on_both(scenario):
    """``scenario(side)`` on JAX and on the port; their results agree."""
    got = {name: scenario(Side(name)) for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    return got["port"]


def test_standard_battery_2workers():
    def scenario(s):
        n, ds, rounds = 2, 10, 5
        outputs = {}
        names = ["master"] + [f"worker-{r}" for r in range(n)]
        failures = s.ex.explore(s.make_exact(outputs, n, ds, rounds),
                                s.ex.standard_schedules(names, seeds=60),
                                exact_validator(outputs, n, ds, rounds))
        assert not failures, "\n".join(map(str, failures))
        return labels(failures)
    on_both(scenario)


@pytest.fixture(scope="module")
def naive_prefix_sweep():
    """Every delivery order over the first 7 steps (3^7 = 2187 schedules)
    of a 2-worker / 4-float / 2-round cluster, on both engines, once for
    the two tests that read it."""
    def scenario(s):
        outputs = {}
        return labels(s.ex.explore(
            s.make_exact(outputs, 2, 4, 2),
            s.ex.exhaustive_prefixes(depth=7, width=3),
            exact_validator(outputs, 2, 4, 2)))
    return {name: scenario(Side(name)) for name in ("jax", "port")}


def test_exhaustive_startup_prefixes_2workers(naive_prefix_sweep):
    """Registration, quorum, InitWorkers and the round-0 scatter all race
    inside the first 7 steps: no ordering fails, on either engine."""
    assert naive_prefix_sweep["port"] == naive_prefix_sweep["jax"] == []


def test_dead_worker_honest_counts_all_orderings():
    def scenario(s):
        n, ds, rounds = 4, 16, 4
        outputs = {}
        config = s.config(n, ds, chunk=4, max_lag=2, max_round=rounds,
                          th=(0.7, 0.7, 0.7))

        def validate(cluster):
            if len(cluster.completed_rounds) != rounds:
                raise AssertionError(
                    f"{len(cluster.completed_rounds)} rounds != {rounds}")
            base = np.arange(ds, dtype=np.float32)
            flushed = 0
            for r in (0, 2, 3):
                for out in outputs[r]:
                    flushed += 1
                    count = as_numpy(out.count)
                    assert (count <= n).all() and (count >= 1).any()
                    np.testing.assert_allclose(as_numpy(out.data),
                                               base * count, rtol=1e-6)
            if not flushed:
                raise AssertionError("no survivor flushed anything")

        names = ["master"] + [f"worker-{r}" for r in range(n)]
        failures = s.ex.explore(
            lambda: s.cluster(config, outputs, n, ds),
            s.ex.standard_schedules(names, seeds=40), validate,
            prepare=lambda c: c.kill_worker(1))
        assert not failures, "\n".join(map(str, failures[:5]))
        return labels(failures)
    on_both(scenario)


# -- the schedule machinery -------------------------------------------------

def test_random_schedule_is_deterministic_in_seed():
    def scenario(s):
        a, b, c = (s.ex.random_schedule(7), s.ex.random_schedule(7),
                   s.ex.random_schedule(8))
        ready = list(range(5))
        pa = [a(ready, i) for i in range(50)]
        assert pa == [b(ready, i) for i in range(50)]
        assert pa != [c(ready, i) for i in range(50)]
        return pa
    on_both(scenario)


def test_starvation_schedule_prefers_others():
    class R:
        def __init__(self, name):
            self.name = name

    def scenario(s):
        v, o = R("victim"), R("other")
        sched = s.ex.starvation_schedule("victim")
        assert sched([v, o], 0) is o and sched([v], 1) is v
        return True
    on_both(scenario)


def test_prefix_schedule_wraps_indices():
    def scenario(s):
        sched = s.ex.prefix_schedule((5,))
        ready = ["a", "b", "c"]
        assert sched(ready, 0) == ready[5 % 3]
        assert sched(ready, 1) == ready[1]
        return [sched(ready, i) for i in range(6)]
    on_both(scenario)


def test_exhaustive_prefix_count():
    def scenario(s):
        got = [label for label, _ in s.ex.exhaustive_prefixes(3, 2)]
        assert len(got) == 8
        return got
    on_both(scenario)


def test_failure_label_reproduces():
    def scenario(s):
        outputs = {}
        failures = s.ex.explore(
            s.make_exact(outputs, 2, 4, 1),
            [("random:seed0", s.ex.random_schedule(0))],
            lambda cluster: (_ for _ in ()).throw(AssertionError("boom")))
        assert failures == [s.ex.ScheduleFailure("random:seed0",
                                                 "AssertionError: boom")]
        return [(f.label, f.error) for f in failures]
    on_both(scenario)


# -- exhaustive prefixes with canonical state dedup -------------------------

def test_dedup_matches_naive_enumeration(naive_prefix_sweep):
    def scenario(s):
        n, ds, rounds, depth, width = 2, 4, 2, 7, 3
        outputs = {}
        failures, report = s.ex.explore_exhaustive(
            s.make_exact(outputs, n, ds, rounds),
            exact_validator(outputs, n, ds, rounds),
            depth=depth, width=width)
        assert bool(failures) == bool(naive_prefix_sweep[s.name])
        assert not failures, "\n".join(map(str, failures[:5]))
        assert report.prefixes_total == width ** depth
        assert report.prefixes_run < report.prefixes_total // 10, report
        assert report.prefixes_deduped > 0 and report.visited_states > 0
        return labels(failures), tuple(report)
    on_both(scenario)


def test_dedup_still_surfaces_failures():
    def scenario(s):
        outputs = {}
        failures, report = s.ex.explore_exhaustive(
            s.make_exact(outputs, 2, 4, 1),
            lambda cluster: (_ for _ in ()).throw(AssertionError("boom")),
            depth=2, width=2)
        assert failures, report
        assert all("AssertionError: boom" in f.error for f in failures)
        return labels(failures), tuple(report)
    on_both(scenario)


def test_digest_distinguishes_protocol_state():
    """Digests split once two interleavings diverge and agree for fresh
    clusters, on both engines; the port's digest hashes the payload
    tensors' bytes, so it splits and merges exactly where JAX's does
    over the same prefixes."""
    def scenario(s):
        outputs = {}
        make = s.make_exact(outputs, 2, 4, 1)
        c1 = make()
        c1.start()
        d_start = s.ex.state_digest(c1)
        c1.router.pump_scheduled(s.ex.prefix_schedule((0,)), max_messages=3,
                                 strict=False)
        assert s.ex.state_digest(c1) != d_start
        c2 = make()
        c2.start()
        assert s.ex.state_digest(c2) == d_start
        # which of the 3^5 five-step prefixes reach one state: the
        # partition of the prefix space by digest, the same on both
        groups: dict = {}
        for label, chooser in s.ex.exhaustive_prefixes(5, 3):
            c = make()
            c.start()
            c.router.pump_scheduled(chooser, max_messages=5, strict=False)
            groups.setdefault(s.ex.state_digest(c), []).append(label)
        return sorted(sorted(g) for g in groups.values())
    partition = on_both(scenario)
    assert len(partition) > 1
