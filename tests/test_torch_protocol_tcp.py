"""The port's TCP router over its own copy of the C++ transport.

The ``TcpRouter`` cases of ``tests/test_native_transport.py`` and the
heartbeat-detector cases of ``tests/test_liveness.py`` on the port's
router (``akka_allreduce_tpu_torch/protocol/tcp.py``): framing, a large
frame, FIFO order, deathwatch on disconnect, interned refs, and the
liveness detector (silent peers downed, polling ones kept, the detector
disabled yet detectable, the widened window for a slow pinger, the 2 x
heartbeat guard). Then what the port adds: payloads arrive as CPU
tensors a card worker's store moves to its device, a chunk view sent
through the router travels as it was at send time, the router counts
the engines' frames and bytes, and — ROADMAP C4 over TCP — a
``StartAllreduce`` that reaches a worker in its rejoin window is dropped
and traced, as the C++ engine drops it. The multi-process cases, marked
``slow`` as the JAX suite marks them, run the real ``cli`` processes.
"""

import os
import re
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.messages import (
    CompleteAllreduce,
    ScatterBlock,
    StartAllreduce,
)
from akka_allreduce_tpu_torch.protocol.remote import free_port
from akka_allreduce_tpu_torch.protocol.tcp import RemoteRef, TcpRouter
from akka_allreduce_tpu_torch.protocol.worker import AllreduceWorker
from akka_allreduce_tpu_torch.runtime.tracing import Tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pump(routers, until, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not until():
        for r in routers:
            r.poll(0.01)
        assert time.monotonic() < deadline, "pump timed out"


def _drain(stream):
    for _ in stream:
        pass


class TestTcpRouter:
    def test_bidirectional_over_one_dial(self):
        got_a, got_b = [], []
        with TcpRouter(role="master") as a, TcpRouter(role="worker") as b:
            a.register("ma", handler=got_a.append)
            b.register("wb", handler=got_b.append)
            a.on_member = lambda ref, role: a.send(ref, StartAllreduce(7))
            aref = b.dial(a.addr)
            b.send(aref, CompleteAllreduce(1, 3))
            _pump([a, b], lambda: got_a and got_b)
        assert got_a[0].src_id == 1 and got_b[0].round == 7

    def test_large_frame(self):
        # bigger than the router's initial 1 MiB recv buffer: the buffer
        # growth path and the C++ partial-frame reassembly
        big = torch.arange(600_000, dtype=torch.float32)  # 2.4 MB payload
        got = []
        with TcpRouter() as a, TcpRouter() as b:
            a.register("a", handler=got.append)
            b.register("b")
            b.send(b.dial(a.addr), ScatterBlock(big, 0, 1, 0, 0))
            _pump([a, b], lambda: got)
        assert torch.equal(got[0].value, big)
        assert got[0].value.device.type == "cpu"

    def test_fifo_per_pair(self):
        got = []
        with TcpRouter() as a, TcpRouter() as b:
            a.register("a", handler=got.append)
            b.register("b")
            ref = b.dial(a.addr)
            for r in range(50):
                b.send(ref, StartAllreduce(r))
            _pump([a, b], lambda: len(got) == 50)
        assert [m.round for m in got] == list(range(50))

    def test_disconnect_fires_deathwatch(self):
        dead = []
        a = TcpRouter(on_terminated=dead.append)
        a.register("a", handler=lambda m: None)
        b = TcpRouter()
        b.register("b")
        b.send(b.dial(a.addr), StartAllreduce(0))
        _pump([a, b], lambda: a._conn_of)  # a saw the hello
        b.close()
        _pump([a], lambda: dead)
        assert dead[0].addr == b.addr
        a.close()

    def test_interned_refs_preserve_identity(self):
        with TcpRouter() as a:
            a.register("a", handler=lambda m: None)
            r1 = a.ref_of(("10.0.0.1", 2551))
            r2 = a.ref_of(("10.0.0.1", 2551))
            assert r1 is r2
            # own address resolves to the local primary ref (self-bypass)
            assert a.ref_of(a.addr) is not None
            assert not isinstance(a.ref_of(a.addr), RemoteRef)

    def test_chunk_view_travels_as_it_was_sent(self):
        """A worker's chunk is a view of its copy of the round's input:
        the frame takes the bytes when it is sent, so overwriting the
        source before the receiver polls changes nothing."""
        data = torch.arange(12, dtype=torch.float32)
        got = []
        with TcpRouter() as a, TcpRouter() as b:
            a.register("a", handler=got.append)
            b.register("b")
            b.send(b.dial(a.addr), ScatterBlock(data[4:8], 0, 1, 1, 0))
            data.fill_(-1.0)
            _pump([a, b], lambda: got)
        assert got[0].value.tolist() == [4.0, 5.0, 6.0, 7.0]

    def test_counts_the_engines_frames_and_bytes(self):
        got = []
        with TcpRouter() as a, TcpRouter() as b:
            a.register("a", handler=got.append)
            b.register("b")
            ref = b.dial(a.addr)
            b.send(ref, ScatterBlock(torch.ones(5), 0, 1, 0, 0))
            b.send(ref, StartAllreduce(3))
            _pump([a, b], lambda: len(got) == 2)
            sent, recv = b.stats, a.stats
        assert sent["frames_sent"] == recv["frames_received"] == 2
        assert sent["bytes_sent"] == recv["bytes_received"] \
            == struct.calcsize("<BiiiqQ") + 5 * 4 + struct.calcsize("<Bq")
        assert sent["encode_s"] > 0 and recv["decode_s"] > 0


class TestC4OverTcp:
    def test_start_in_the_rejoin_window_is_dropped_and_traced(self):
        """ROADMAP C4 on the wire: after ``reset()`` (a master epoch
        ended) a ``StartAllreduce`` that arrives before the new
        ``InitWorkers`` is dropped and traced, as
        ``native/src/remote_worker.cpp:315-319`` drops it; the JAX
        Python worker would re-queue it into the new epoch."""
        tracer = Tracer()
        with TcpRouter() as w, TcpRouter() as old_master:
            worker = AllreduceWorker(w, lambda req: None, lambda out: None,
                                     tracer=tracer, device="cpu")
            worker.reset()  # the rejoin path: discard_blocks set
            old_master.register("m")
            old_master.send(old_master.dial(w.addr), StartAllreduce(41))
            _pump([w, old_master],
                  lambda: tracer.counters["pre_rejoin_start_dropped"])
            for _ in range(5):
                w.poll(0.01)
            assert w.purge_local() == 0  # nothing re-queued
        assert [e.fields["round"] for e in tracer.events
                if e.kind == "pre_rejoin_start_dropped"] == [41]
        assert worker.id == -1 and worker.max_round == -1


class TestHeartbeatDetector:
    def test_silent_peer_is_downed(self):
        downed = []
        tracer = Tracer()
        with TcpRouter(role="master", heartbeat_interval_s=0.05,
                       unreachable_after_s=0.4,
                       on_terminated=downed.append, tracer=tracer) as a:
            with TcpRouter(role="worker", heartbeat_interval_s=0.05,
                           unreachable_after_s=0.4) as b:
                b.register("w", handler=lambda m: None)
                b.dial(a.addr)  # Hello goes out; then b never polls again
                deadline = time.monotonic() + 3.0
                while not downed and time.monotonic() < deadline:
                    a.poll(0.05)
        assert len(downed) == 1
        assert downed[0].addr == b.addr
        # the down joins the structured trace stream
        downs = [e for e in tracer.events
                 if e.kind == "peer_unreachable_down"]
        assert len(downs) == 1
        assert downs[0].fields["silent_s"] >= 0.4

    def test_polling_peer_stays_up(self):
        downed = []
        with TcpRouter(role="master", heartbeat_interval_s=0.05,
                       unreachable_after_s=0.4,
                       on_terminated=downed.append) as a:
            with TcpRouter(role="worker", heartbeat_interval_s=0.05,
                           unreachable_after_s=0.4) as b:
                b.register("w", handler=lambda m: None)
                b.dial(a.addr)
                end = time.monotonic() + 1.5
                while time.monotonic() < end:
                    a.poll(0.01)
                    b.poll(0.01)
        assert downed == []

    def test_detector_disabled_node_stays_detectable(self):
        """A node that disables ITS detector must still send Pings — else
        detector-enabled peers down it during protocol-quiet stretches."""
        downed = []
        with TcpRouter(role="master", heartbeat_interval_s=0.05,
                       unreachable_after_s=0.4,
                       on_terminated=downed.append) as a:
            with TcpRouter(role="worker", heartbeat_interval_s=0.05,
                           unreachable_after_s=None) as b:  # detector off
                b.register("w", handler=lambda m: None)
                b.dial(a.addr)
                end = time.monotonic() + 1.2
                while time.monotonic() < end:
                    a.poll(0.01)
                    b.poll(0.01)  # b polls (pings) but never detects
        assert downed == []

    def test_slow_pinging_healthy_peer_not_downed(self):
        """Asymmetric cadences: the peer pings every 1s, the local window
        is 0.4s — the detector must widen to 2x the peer's ADVERTISED
        cadence (carried in Ping frames)."""
        downed = []
        with TcpRouter(role="master", heartbeat_interval_s=0.05,
                       unreachable_after_s=0.4,
                       on_terminated=downed.append) as a:
            with TcpRouter(role="worker", heartbeat_interval_s=1.0,
                           unreachable_after_s=None) as b:
                b.register("w", handler=lambda m: None)
                b.dial(a.addr)
                end = time.monotonic() + 1.8
                while time.monotonic() < end:
                    a.poll(0.01)
                    b.poll(0.01)  # pings only every ~1s
        assert downed == []

    def test_window_shorter_than_ping_cadence_rejected(self):
        with pytest.raises(ValueError, match="heartbeat_interval"):
            TcpRouter(role="master", heartbeat_interval_s=2.0,
                      unreachable_after_s=1.0)

    def test_detector_disabled_never_downs(self):
        downed = []
        with TcpRouter(role="master", heartbeat_interval_s=0.05,
                       unreachable_after_s=None,
                       on_terminated=downed.append) as a:
            with TcpRouter(role="worker") as b:
                b.register("w", handler=lambda m: None)
                b.dial(a.addr)
                end = time.monotonic() + 0.8
                while time.monotonic() < end:
                    a.poll(0.01)
        assert downed == []


def _cli(*argv):
    return [sys.executable, "-u", "-m", "akka_allreduce_tpu_torch.cli",
            *argv]


@pytest.mark.slow
@pytest.mark.xdist_group("cluster-procs")
class TestMultiProcessCluster:
    def test_master_and_workers_as_processes(self):
        """``tests/test_native_transport.py``'s canonical smoke on the
        port: real processes, real TCP, output == N x input asserted in
        each CPU worker."""
        port = free_port()
        n, rounds = 3, 12
        master = subprocess.Popen(
            _cli("master", "--port", str(port), "--workers", str(n),
                 "--data-size", "778", "--max-chunk-size", "3",
                 "--max-lag", "3", "--th-complete", "1.0",
                 "--max-round", str(rounds), "--timeout", "60"),
            cwd=REPO, stdout=subprocess.PIPE, text=True)
        time.sleep(0.5)
        workers = [subprocess.Popen(
            _cli("worker", "--master-port", str(port), "--data-size", "778",
                 "--checkpoint", "5", "--assert-multiple", str(n),
                 "--timeout", "60", "--verbose", "--device", "cpu"),
            cwd=REPO, stdout=subprocess.PIPE, text=True) for _ in range(n)]
        m_out, _ = master.communicate(timeout=90)
        assert master.returncode == 0, m_out
        assert f"{rounds}/{rounds} rounds" in m_out
        for w in workers:
            w_out, _ = w.communicate(timeout=30)
            assert w.returncode == 0, w_out
            assert (f"{rounds} outputs" in w_out
                    or f"{rounds + 1} outputs" in w_out), w_out


@pytest.mark.slow
@pytest.mark.xdist_group("cluster-procs")
class TestMutualDialLiveness:
    """A mutually-dialed pair carries TWO TCP connections; liveness must
    be per PEER, not per connection (``tests/test_liveness.py``)."""

    def test_mutually_dialed_pair_survives_a_quiet_stretch(self):
        downs = []
        a = TcpRouter(role="a", heartbeat_interval_s=0.2,
                      unreachable_after_s=0.6,
                      on_terminated=lambda ref: downs.append(("a", ref)))
        b = TcpRouter(role="b", heartbeat_interval_s=0.2,
                      unreachable_after_s=0.6,
                      on_terminated=lambda ref: downs.append(("b", ref)))
        try:
            a.dial(b.addr)
            b.dial(a.addr)  # duplicate pair: 2 conns, asymmetric writes
            deadline = time.monotonic() + 2.0  # >3 unreachable windows
            while time.monotonic() < deadline:
                a.poll(0.01)
                b.poll(0.01)
            assert downs == [], downs  # pings alone must keep the pair up
        finally:
            a.close()
            b.close()

    def test_dead_peer_with_duplicate_conns_is_downed_once(self):
        downs = []
        a = TcpRouter(role="a", heartbeat_interval_s=0.2,
                      unreachable_after_s=0.6, on_terminated=downs.append)
        b = TcpRouter(role="b", heartbeat_interval_s=0.2,
                      unreachable_after_s=0.6)
        a.dial(b.addr)
        b.dial(a.addr)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.5:
            a.poll(0.01)
            b.poll(0.01)
        b.close()  # real death: BOTH of the pair's conns drop
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not downs:
            a.poll(0.01)
        a.close()
        assert [d.addr for d in downs] == [tuple(b.addr)], downs


@pytest.mark.slow
@pytest.mark.xdist_group("cluster-procs")
class TestSigstopCluster:
    def test_lossy_cluster_survives_sigstopped_worker(self):
        """4 CPU workers, thresholds 0.75, one SIGSTOPped mid-run: rounds
        keep completing and the master auto-downs the hung worker
        (``tests/test_liveness.py``'s cluster on the port)."""
        port = free_port()
        n, rounds = 4, 1_000_000
        master = subprocess.Popen(
            _cli("master", "--port", str(port), "--workers", str(n),
                 "--data-size", "1024", "--max-chunk-size", "128",
                 "--max-lag", "2", "--th-allreduce", "0.75",
                 "--th-reduce", "0.75", "--th-complete", "0.75",
                 "--max-round", str(rounds), "--timeout", "45",
                 "--heartbeat-interval", "0.4", "--unreachable-after",
                 "6.0"),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        time.sleep(0.5)
        workers = [subprocess.Popen(
            _cli("worker", "--master-port", str(port), "--data-size",
                 "1024", "--timeout", "50", "--verbose", "--checkpoint",
                 "10", "--heartbeat-interval", "0.4", "--unreachable-after",
                 "6.0", "--device", "cpu"),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True) for _ in range(n)]
        victim = workers[-1]
        for w in workers:
            if w is not victim:
                threading.Thread(target=_drain, args=(w.stdout,),
                                 daemon=True).start()
        try:
            # stop the victim once it has completed rounds: its first
            # throughput checkpoint line
            while True:
                line = victim.stdout.readline()
                assert line, "victim produced no output before exiting"
                if " MB in " in line:
                    break
            os.kill(victim.pid, signal.SIGSTOP)
            threading.Thread(target=_drain, args=(victim.stdout,),
                             daemon=True).start()
            m_out, m_err = master.communicate(timeout=60)
            assert "downing unreachable peer" in m_err, (m_out, m_err)
            downs = re.findall(r"worker down at round (\d+)", m_out)
            assert len(downs) == 1, (downs, m_err)
            final = int(re.search(r"(\d+)/\d+ rounds", m_out).group(1))
            assert final > int(downs[0]), (downs, final, m_out)
        finally:
            try:
                os.kill(victim.pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
            for w in workers:
                w.kill()
            master.kill()


def test_received_payload_stores_into_the_workers_rows():
    """A frame's CPU tensor goes into a worker's staging row by the
    store's one copy (on a card worker, host to device)."""
    from akka_allreduce_tpu_torch.buffers import ScatteredDataBuffer
    buf = ScatteredDataBuffer(6, 2, 1, 1.0, 3, device="cpu")
    got = []
    with TcpRouter() as a, TcpRouter() as b:
        a.register("a", handler=got.append)
        b.register("b")
        b.send(b.dial(a.addr), ScatterBlock(
            torch.from_numpy(np.array([1.5, 2.5, 3.5], np.float32)),
            1, 0, 1, 0))
        _pump([a, b], lambda: got)
    buf.store(got[0].value, 0, got[0].src_id, got[0].chunk_id)
    assert buf.temporal_buffer[0, 1].tolist() == [0, 0, 0, 1.5, 2.5, 3.5]
