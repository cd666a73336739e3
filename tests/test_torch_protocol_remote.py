"""The protocol plane across processes: the port's master and workers over
TCP, against the JAX package's, and beside the C++ engines.

* An in-process TCP cluster: a master and workers on their own
  ``TcpRouter``s, pumped in one thread, the port's workers on the CPU.
  Every flush of the port's cluster must be bitwise the flush of the
  same JAX cluster; so must every flush of the mixed-package clusters —
  a JAX master on JAX's router serving port workers, and JAX and port
  workers together under a port master — which proves the two packages'
  wire formats agree.
* A mixed-engine cluster: port Python workers and the C++ worker
  (``run_worker_native``, in threads) under a port master, exact at
  thresholds 1.0 on every flush of every engine.
* One real cross-process run: ``python -m akka_allreduce_tpu_torch.cli
  master`` and two ``worker --device cpu``.

The multi-process cases of ``tests/test_native_remote.py``,
``tests/test_multiseed.py`` and ``tests/test_wire_scale.py`` follow,
marked ``slow`` as the JAX suite marks them, with the port's Python
workers on the CPU; the rejoin cases also hold the port's Python worker
to the C++ engine on ROADMAP C4's schedule.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.config import (
    AllreduceConfig,
    DataConfig,
    ThresholdConfig,
    WorkerConfig,
)
from akka_allreduce_tpu_torch.protocol.remote import (
    free_port,
    run_master,
    run_worker,
    run_worker_native,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pkg(side: str):
    """The side's (config, protocol.tcp, master, worker, cluster)
    modules."""
    import importlib
    root = "akka_allreduce_tpu" if side == "jax" else \
        "akka_allreduce_tpu_torch"
    return tuple(importlib.import_module(f"{root}.{m}") for m in (
        "config", "protocol.tcp", "protocol.master", "protocol.worker",
        "protocol.cluster"))


def make_config(side, n=4, data_size=100, chunk=7, max_lag=2, rounds=8,
                th=(1.0, 1.0, 1.0)):
    c = pkg(side)[0]
    return c.AllreduceConfig(
        thresholds=c.ThresholdConfig(*th),
        data=c.DataConfig(data_size=data_size, max_chunk_size=chunk,
                          max_round=rounds),
        workers=c.WorkerConfig(total_size=n, max_lag=max_lag))


def as_bytes(x) -> bytes:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.tobytes()


def tcp_cluster(master_side: str, worker_sides: list, threads=(),
                timeout_s: float = 60.0, **cfg) -> dict:
    """A master and one worker per entry of ``worker_sides`` ("jax" or
    "port", the port's on the CPU), each on its own router, pumped here
    until the master completes its rounds; ``threads`` start once the
    master listens (they get its port). Returns each rank's flushes,
    ``{rank: [(round, data bytes, count bytes), ...]}``, sorted by
    round, and the master's completed rounds under ``"rounds"``."""
    _, tcp, master_mod, _, _ = pkg(master_side)
    config = make_config(master_side, n=len(worker_sides) + len(threads),
                         **cfg)
    completed = []
    mrouter = tcp.TcpRouter(role="master")
    master = master_mod.AllreduceMaster(mrouter, config,
                                        on_round_complete=completed.append)
    mrouter.on_member = lambda ref, role: (
        master.member_up(ref, role) if role == "worker" else None)
    mrouter.on_terminated = master.terminated
    routers, workers, flushes = [mrouter], [], []
    for side in worker_sides:
        _, wtcp, _, worker_mod, cluster_mod = pkg(side)
        router = wtcp.TcpRouter(role="worker")
        kept = []
        size = config.data.data_size
        if side == "port":
            worker = worker_mod.AllreduceWorker(
                router, cluster_mod.constant_range_source(size, "cpu"),
                kept.append, strict=True, device="cpu")
        else:
            worker = worker_mod.AllreduceWorker(
                router, cluster_mod.constant_range_source(size),
                kept.append, strict=True)
        router.on_terminated = worker.terminated
        router.dial(mrouter.addr)
        routers.append(router)
        workers.append(worker)
        flushes.append(kept)
    started = [threading.Thread(target=fn, args=(mrouter.addr[1],),
                                daemon=True) for fn in threads]
    for t in started:
        t.start()
    deadline = time.monotonic() + timeout_s
    try:
        while len(completed) < config.data.max_round:
            for r in routers:
                r.poll(0.0)
            assert time.monotonic() < deadline, \
                f"{len(completed)}/{config.data.max_round} rounds"
        mrouter.flush()
    finally:
        for r in routers:
            r.close()
    for t in started:
        t.join(timeout=60)
    out = {"rounds": len(completed)}
    for w, kept in zip(workers, flushes):
        out[w.id] = sorted((o.iteration, as_bytes(o.data), as_bytes(o.count))
                           for o in kept)
    return out


def same_rounds(got: dict, want: dict, rounds: int) -> None:
    """Every rank's first ``rounds`` flushes, bitwise (a worker may also
    flush round ``rounds`` before it sees the master go)."""
    assert got["rounds"] == want["rounds"] == rounds
    assert sorted(k for k in got if k != "rounds") == \
        sorted(k for k in want if k != "rounds")
    for rank in want:
        if rank == "rounds":
            continue
        assert got[rank][:rounds] == want[rank][:rounds], rank
        assert [r for r, _, _ in got[rank][:rounds]] == list(range(rounds))


JAX_CLUSTER = {}


def jax_cluster():
    if "flushes" not in JAX_CLUSTER:
        JAX_CLUSTER["flushes"] = tcp_cluster("jax", ["jax"] * 4)
    return JAX_CLUSTER["flushes"]


@pytest.mark.parametrize("master_side,worker_sides", [
    ("port", ["port"] * 4),
    ("jax", ["port"] * 4),
    ("port", ["jax", "port", "jax", "port"])],
    ids=["port", "jax-master-port-workers", "mixed-workers"])
def test_tcp_cluster_flushes_bitwise_jax(master_side, worker_sides):
    got = tcp_cluster(master_side, worker_sides)
    same_rounds(got, jax_cluster(), 8)
    # 4 x input, counts 4: the reference's invariant at thresholds 1.0
    base = np.arange(100, dtype=np.float32)
    for rank in range(4):
        for _, data, count in got[rank]:
            assert data == (base * 4).tobytes()
            assert count == np.full(100, 4, np.int32).tobytes()


def test_mixed_engine_cluster_is_exact():
    """Two port Python workers and two C++ workers (threads) under a port
    master: the C++ sinks assert output == 4 x input at every checkpoint
    (a failure raises in the thread); the Python workers' flushes are
    all exactly 4 x input with counts 4, so both engines sum peers in
    the same order."""
    results, errors = [], []

    def native(port):
        try:
            results.append(run_worker_native(
                master_port=port, checkpoint=2, assert_multiple=4,
                timeout_s=30))
        except Exception as exc:  # reported below
            errors.append(exc)

    got = tcp_cluster("port", ["port"] * 2, threads=[native, native],
                      data_size=778, chunk=3, max_lag=3, rounds=10)
    assert errors == [] and len(results) == 2
    assert all(n >= 10 for n in results)
    base = np.arange(778, dtype=np.float32)
    ranks = [k for k in got if k != "rounds"]
    assert len(ranks) == 2
    for rank in ranks:
        assert len(got[rank]) >= 10
        for _, data, count in got[rank]:
            assert data == (base * 4).tobytes()
            assert count == np.full(778, 4, np.int32).tobytes()


def _cli(*argv):
    return [sys.executable, "-u", "-m", "akka_allreduce_tpu_torch.cli",
            *argv]


def test_cli_master_and_cpu_workers_across_processes():
    """``cli master`` and two ``cli worker --device cpu`` as OS processes:
    every round completes, each worker's sink asserts output == 2 x input
    at its checkpoints and ``--assert-honest`` checks every flush."""
    port = free_port()
    rounds = 5
    master = subprocess.Popen(
        _cli("master", "--port", str(port), "--workers", "2",
             "--data-size", "60", "--max-chunk-size", "4", "--max-lag", "1",
             "--th-complete", "1.0", "--max-round", str(rounds),
             "--timeout", "60"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    workers = [subprocess.Popen(
        _cli("worker", "--master-port", str(port), "--data-size", "60",
             "--checkpoint", "2", "--assert-multiple", "2",
             "--assert-honest", "--timeout", "60", "--verbose", "--device",
             "cpu"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for _ in range(2)]
    try:
        m_out, _ = master.communicate(timeout=90)
        w_outs = [w.communicate(timeout=60)[0] for w in workers]
    finally:
        for p in [master] + workers:
            if p.poll() is None:
                p.kill()
    assert master.returncode == 0, m_out
    assert f"master: {rounds}/{rounds} rounds" in m_out
    ranks = []
    for w, out in zip(workers, w_outs):
        assert w.returncode == 0, out
        m = re.search(r"worker (\d): (\d+) outputs", out)
        assert m and int(m.group(2)) in (rounds, rounds + 1), out
        ranks.append(int(m.group(1)))
        assert f"worker: joined as rank {m.group(1)}" in out
        report = re.search(r"worker \d: report (\{.*\})", out)
        assert report and '"device": "cpu"' in report.group(1)
        assert len(re.findall(r" MB in .* MB/s", out)) == 2
    assert sorted(ranks) == [0, 1]


def test_a_failed_sink_check_fails_the_worker():
    """The engine logs and swallows a sink's exception, as the
    reference's supervision does (the round that raised never completes,
    so the master stalls there); the worker then fails its run at exit,
    as the C++ worker does, so a wrong flush cannot pass unnoticed."""
    port = free_port()
    errors = []

    def worker():
        try:
            run_worker(master_port=port, source_data_size=24, checkpoint=2,
                       assert_multiple=3, timeout_s=30, device="cpu")
        except AssertionError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    # the first checked flush is round 2's
    assert run_master(_config(4), port=port, timeout_s=3,
                      verbose=False) == 2
    for t in threads:
        t.join(timeout=30)
    assert len(errors) == 2
    assert all("failed the sink's check" in e and "!= 3 x input" in e
               for e in errors)


def test_worker_without_cpu_flag_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_worker(master_port=free_port(), timeout_s=1.0)


# -- slow: the multi-process cases of the JAX suite, on the port -----------

def _spawn_master(port, rounds, workers=4, native=False):
    cmd = _cli("master", "--port", str(port), "--workers", str(workers),
               "--data-size", "778", "--max-chunk-size", "3",
               "--max-lag", "3", "--th-allreduce", "1.0", "--th-reduce",
               "1.0", "--th-complete", "1.0", "--max-round", str(rounds))
    if native:
        cmd.append("--native")
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _spawn_worker(port, native, n_workers=4):
    cmd = _cli("worker", "--master-port", str(port), "--data-size", "778",
               "--checkpoint", "10", "--assert-multiple", str(n_workers),
               "--verbose")
    cmd += ["--native"] if native else ["--device", "cpu", "--assert-honest"]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _run_cluster(natives, rounds=12, master_native=False):
    from akka_allreduce_tpu_torch.native import build_library
    build_library()  # before the processes race to load it
    port = free_port()
    master = _spawn_master(port, rounds, workers=len(natives),
                           native=master_native)
    time.sleep(1.0)
    workers = [_spawn_worker(port, nat, n_workers=len(natives))
               for nat in natives]
    procs = [master] + workers
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        who = "master" if i == 0 else f"worker{i - 1}"
        assert p.returncode == 0, f"{who} rc={p.returncode}:\n{out[-1500:]}"
    assert f"{rounds}/{rounds} rounds" in outs[0], outs[0]
    return outs


@pytest.mark.slow
@pytest.mark.xdist_group("cluster-procs")
class TestNativeRemoteWorker:
    def test_all_native_cluster(self):
        outs = _run_cluster([True, True, True, True])
        assert any("native worker" in o for o in outs[1:])
        assert all("native engine, host" in o for o in outs[1:])

    def test_mixed_engine_cluster_bit_identical(self):
        _run_cluster([True, False, True, False])

    def test_all_native_cluster_including_master(self):
        outs = _run_cluster([True, True, True, True], master_native=True)
        assert "native engine, host" in outs[0]

    def test_native_master_serves_python_workers(self):
        _run_cluster([False, False], master_native=True)

    def test_native_master_survives_kill_and_rejoin(self):
        """SIGKILL a C++ worker mid-run in a lossy cluster under the C++
        master; a replacement takes the freed seat."""
        from akka_allreduce_tpu_torch.native import build_library
        build_library()
        port = free_port()
        master = subprocess.Popen(
            _cli("master", "--port", str(port), "--workers", "4",
                 "--data-size", "1024", "--max-chunk-size", "128",
                 "--max-lag", "2", "--th-allreduce", "0.75",
                 "--th-reduce", "0.75", "--th-complete", "0.75",
                 "--max-round", "400000", "--timeout", "25", "--native"),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        time.sleep(0.8)

        def native_worker():
            return subprocess.Popen(
                _cli("worker", "--master-port", str(port), "--timeout",
                     "30", "--native"),
                cwd=REPO, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)

        workers = [native_worker() for _ in range(4)]
        lines: list = []
        state = {"killed": False, "rejoiner": None}

        def pump():
            for line in master.stdout:
                lines.append(line.rstrip())
                if "up, 4/4" in line and not state["killed"]:
                    state["killed"] = True
                    workers[1].kill()
                if "worker down at round" in line \
                        and state["rejoiner"] is None:
                    state["rejoiner"] = native_worker()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            master.wait(timeout=60)
            t.join(timeout=10)
        finally:
            if state["rejoiner"] is not None:
                workers.append(state["rejoiner"])
            for w in workers:
                if w.poll() is None:
                    w.kill()
            if master.poll() is None:
                master.kill()
        m_out = "\n".join(lines)
        assert "worker down at round" in m_out, m_out
        assert "worker rejoined as rank" in m_out, m_out
        down_at = int(re.search(r"worker down at round (\d+)",
                                m_out).group(1))
        final = int(re.search(r"(\d+)/\d+ rounds", m_out).group(1))
        assert final > down_at, (down_at, final, m_out)


def _config(max_round):
    return AllreduceConfig(
        thresholds=ThresholdConfig(1.0, 1.0, 1.0),
        data=DataConfig(data_size=24, max_chunk_size=4,
                        max_round=max_round),
        workers=WorkerConfig(total_size=2, max_lag=1))


@pytest.mark.slow
class TestMultiSeedJoin:
    """``tests/test_multiseed.py`` on the port: workers seeded with two
    master addresses survive a master restart on the second one. Each
    port worker traces; a ``StartAllreduce`` that reached it inside the
    rejoin window shows as ``pre_rejoin_start_dropped`` (ROADMAP C4: the
    C++ engine's drop), and whatever the schedule, every flush in both
    epochs is exact."""

    def _workers(self, seeds, tmp_path, rejoin, hb, n=2):
        results, errors = {}, []

        def worker(idx):
            try:
                results[idx] = run_worker(
                    source_data_size=24, checkpoint=2, assert_multiple=2,
                    timeout_s=90, seeds=seeds, rejoin_timeout_s=rejoin,
                    heartbeat_interval_s=hb, device="cpu",
                    assert_honest=True,
                    trace_file=str(tmp_path / f"w{idx}.jsonl"))
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        return threads, results, errors

    @staticmethod
    def _c4_drops(tmp_path, n=2) -> int:
        from akka_allreduce_tpu_torch.runtime.tracing import Tracer
        drops = 0
        for i in range(n):
            rows = Tracer.read_jsonl(str(tmp_path / f"w{i}.jsonl"))
            drops += sum(r["kind"] == "pre_rejoin_start_dropped"
                         for r in rows)
        return drops

    def test_workers_survive_master_restart_on_second_seed(self, tmp_path):
        port_a, port_b = free_port(), free_port()
        seeds = [("127.0.0.1", port_a), ("127.0.0.1", port_b)]
        threads, results, errors = self._workers(seeds, tmp_path, 12, 0.5)
        assert run_master(_config(4), port=port_a, timeout_s=60,
                          verbose=False, heartbeat_interval_s=0.5) == 4
        time.sleep(0.5)
        assert run_master(_config(4), port=port_b, timeout_s=60,
                          verbose=False, heartbeat_interval_s=0.5) == 4
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "worker thread hung"
        assert errors == []
        for idx, outputs in results.items():
            assert outputs > 5, (idx, outputs)
        assert self._c4_drops(tmp_path) >= 0  # traced when it happens

    def test_restart_timing_fuzz(self, tmp_path):
        rng = np.random.default_rng(7)
        gaps = [0.0, 0.05, 0.3, float(rng.uniform(0.5, 1.2))]
        drops = 0
        for trial, gap in enumerate(gaps):
            port_a, port_b = free_port(), free_port()
            seeds = [("127.0.0.1", port_a), ("127.0.0.1", port_b)]
            d = tmp_path / f"t{trial}"
            d.mkdir()
            threads, results, errors = self._workers(seeds, d, 10, 0.3)
            assert run_master(_config(3), port=port_a, timeout_s=40,
                              verbose=False, heartbeat_interval_s=0.3) == 3
            time.sleep(gap)
            assert run_master(_config(3), port=port_b, timeout_s=40,
                              verbose=False, heartbeat_interval_s=0.3) == 3
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), f"trial {trial}: worker hung"
            assert errors == [], (trial, gap, errors)
            for idx, outputs in results.items():
                assert outputs > 4, (trial, gap, idx, outputs)
            drops += self._c4_drops(d)
        print(f"C4 drops over the sweep: {drops}")

    def test_c4_schedule_port_worker_held_to_the_cpp_engine(self, tmp_path):
        """ROADMAP C4's schedule, forced: after epoch 1's master exits, a
        stale ``StartAllreduce(50)`` reaches the worker inside its rejoin
        window; then epoch 2's master forms. The C++ worker drops it
        (``remote_worker.cpp:315-319``) and flushes epoch 2 exactly; the
        port's Python worker must too, tracing the drop. (The JAX Python
        worker re-queues it, ROADMAP C4.)"""
        from akka_allreduce_tpu_torch.messages import StartAllreduce
        from akka_allreduce_tpu_torch.protocol.tcp import TcpRouter
        from akka_allreduce_tpu_torch.protocol.master import AllreduceMaster

        def epoch(port, rounds, addrs):
            completed = []
            with TcpRouter(port=port, role="master",
                           heartbeat_interval_s=0.3) as r:
                master = AllreduceMaster(r, _config(rounds),
                                         on_round_complete=completed.append)

                def up(ref, role):
                    addrs.append(ref.addr)
                    master.member_up(ref, role)
                r.on_member = up
                r.on_terminated = master.terminated
                deadline = time.monotonic() + 40
                while len(completed) < rounds \
                        and time.monotonic() < deadline:
                    r.poll(0.02)
                r.flush()
            return len(completed)

        def schedule(start_workers):
            port_a, port_b = free_port(), free_port()
            seeds = [("127.0.0.1", port_a), ("127.0.0.1", port_b)]
            threads, results, errors = start_workers(seeds)
            addrs = []
            assert epoch(port_a, 3, addrs) == 3
            # the workers see the master go, reset, and cycle the seeds
            time.sleep(0.6)
            # the stale Start, straight at each worker's listen address
            with TcpRouter(role="master") as stale:
                stale.register("old-master")
                for addr in addrs:
                    stale.send(stale.dial(addr), StartAllreduce(50))
                end = time.monotonic() + 0.5
                while time.monotonic() < end:
                    stale.poll(0.02)
                stale.flush()
            assert epoch(port_b, 3, []) == 3
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            return results, errors

        def python_workers(seeds):
            return self._workers(seeds, tmp_path, 10, 0.3)

        def native_workers(seeds):
            results, errors = {}, []

            def worker(idx):
                try:
                    results[idx] = run_worker_native(
                        checkpoint=1, assert_multiple=2, timeout_s=60,
                        seeds=seeds, rejoin_timeout_s=10,
                        heartbeat_interval_s=0.3)
                except Exception as exc:
                    errors.append(exc)
            threads = [threading.Thread(target=worker, args=(i,),
                                        daemon=True) for i in range(2)]
            for t in threads:
                t.start()
            return threads, results, errors

        native_results, native_errors = schedule(native_workers)
        assert native_errors == [] and all(
            n > 4 for n in native_results.values()), native_results
        py_results, py_errors = schedule(python_workers)
        assert py_errors == [] and all(
            n > 4 for n in py_results.values()), py_results
        assert self._c4_drops(tmp_path) == 2


@pytest.mark.slow
def test_megascale_payload_crosses_real_wire():
    """``tests/test_wire_scale.py`` on the port: 4 C++ worker processes
    under the port's C++ master, and then 2 port Python workers (CPU) on
    the same 1,048,576-float payload under the port's Python master."""
    from akka_allreduce_tpu_torch.native import build_library
    from akka_allreduce_tpu_torch.protocol.remote import run_master_native
    build_library()
    port = free_port()
    workers, elems, rounds = 4, 1_048_576, 6
    config = AllreduceConfig(
        thresholds=ThresholdConfig(1.0, 1.0, 1.0),
        data=DataConfig(data_size=elems, max_chunk_size=16_384,
                        max_round=rounds),
        workers=WorkerConfig(total_size=workers, max_lag=1))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import sys\n"
        "from akka_allreduce_tpu_torch.protocol.remote import "
        "run_worker_native\n"
        f"n = run_worker_native(master_port={port}, checkpoint=2, "
        f"assert_multiple={workers}, timeout_s=240)\n"
        "sys.exit(0 if n > 0 else 4)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=REPO) for _ in range(workers)]
    try:
        got, stamps = run_master_native(config, port=port, timeout_s=240,
                                        unreachable_after_s=120.0,
                                        with_round_times=True)
        rcs = [p.wait(timeout=90) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert got == rounds and len(stamps) == rounds
    assert rcs == [0] * workers, f"worker exit codes {rcs}"

    port = free_port()
    procs = [subprocess.Popen(
        _cli("worker", "--master-port", str(port), "--data-size",
             str(elems), "--checkpoint", "1", "--assert-multiple", "2",
             "--assert-honest", "--timeout", "240", "--device", "cpu",
             "--unreachable-after", "120"),
        cwd=REPO, stdout=subprocess.DEVNULL) for _ in range(2)]
    try:
        got = run_master(AllreduceConfig(
            thresholds=ThresholdConfig(1.0, 1.0, 1.0),
            data=DataConfig(data_size=elems, max_chunk_size=16_384,
                            max_round=3),
            workers=WorkerConfig(total_size=2, max_lag=1)),
            port=port, timeout_s=240, verbose=False,
            unreachable_after_s=120.0)
        rcs = [p.wait(timeout=90) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert got == 3 and rcs == [0, 0]
