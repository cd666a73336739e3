"""Multi-process cluster runners over the native TCP transport.

Counterpart of ``akka_allreduce_tpu/protocol/remote.py``. The true
equivalent of the reference's L6 deployment — separate master and worker
processes joined over localhost TCP (reference:
AllreduceMaster.scala:95-112, AllreduceWorker.scala:309-315,
scripts/testAllreduceMaster.sc / testAllreduceWorker.sc) — with the C++
transport (``native/src/transport.cpp``) in netty's role. The master
process paces a fixed number of rounds then closes; workers treat the
master's disconnect as shutdown (the reference's clusters are stopped by
killing the master, so deathwatch-as-shutdown matches observed behavior).

A Python worker (:func:`run_worker`) keeps its payloads on ``device``
(``cuda`` by default, through ``device.resolve_device``): the frames it
receives are copied into its staging rows on the card and each chunk
reduce is one masked-reduce launch there. The master holds no tensor.
The C++ engines (:func:`run_worker_native`, :func:`run_master_native`)
are host engines; they speak the same frames.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

import torch

from akka_allreduce_tpu_torch.buffers import base as buffers_base
from akka_allreduce_tpu_torch.config import AllreduceConfig
from akka_allreduce_tpu_torch.device import resolve_device
from akka_allreduce_tpu_torch.ops.kernels import masked_reduce
from akka_allreduce_tpu_torch.protocol.cluster import ThroughputSink, \
    constant_range_source
from akka_allreduce_tpu_torch.protocol.master import AllreduceMaster
from akka_allreduce_tpu_torch.protocol.tcp import TcpRouter
from akka_allreduce_tpu_torch.protocol.worker import AllreduceWorker
from akka_allreduce_tpu_torch.runtime.tracing import tracer_to_file

log = logging.getLogger(__name__)


def run_master(config: AllreduceConfig, bind_host: str = "127.0.0.1",
               port: int = 2551, timeout_s: float = 120.0,
               verbose: bool = True, heartbeat_interval_s: float = 2.0,
               unreachable_after_s: Optional[float] = 10.0,
               trace_file: Optional[str] = None) -> int:
    """Serve membership + round pacing until ``config.data.max_round`` rounds
    complete (or timeout). Returns rounds completed.

    ``unreachable_after_s`` is the liveness auto-down window (reference:
    application.conf:20): a hung-but-connected worker silent that long is
    removed from membership, and threshold semantics let the survivors'
    rounds keep completing."""
    completed: list[int] = []
    with tracer_to_file(trace_file) as tracer, \
         TcpRouter(bind_host=bind_host, port=port, role="master",
                    heartbeat_interval_s=heartbeat_interval_s,
                    unreachable_after_s=unreachable_after_s,
                    tracer=tracer) as router:
        master = AllreduceMaster(router, config,
                                 on_round_complete=completed.append,
                                 tracer=tracer)
        router.on_member = lambda ref, role: (
            master.member_up(ref, role) if role == "worker" else None)

        def on_terminated(ref):
            # the round marker lets operators (and the liveness test) see
            # that progress continued past the down
            if verbose:
                print(f"master: worker down at round {len(completed)}",
                      flush=True)
            master.terminated(ref)

        router.on_terminated = on_terminated
        if verbose:
            print(f"master: listening on {router.addr[0]}:{router.addr[1]}, "
                  f"waiting for {config.workers.total_size} workers")
        deadline = time.monotonic() + timeout_s
        while len(completed) < config.data.max_round \
                and time.monotonic() < deadline:
            router.poll(0.05)
        router.flush()
    if trace_file and verbose:
        print(f"master: trace -> {trace_file}")
    if verbose:
        print(f"master: {len(completed)}/{config.data.max_round} rounds")
    return len(completed)


def run_worker(master_host: str = "127.0.0.1", master_port: int = 2551,
               source_data_size: int = 10, checkpoint: int = 10,
               assert_multiple: int = 0, bind_host: str = "127.0.0.1",
               port: int = 0, timeout_s: float = 120.0,
               verbose: bool = False, heartbeat_interval_s: float = 2.0,
               unreachable_after_s: Optional[float] = 10.0,
               trace_file: Optional[str] = None,
               seeds: Optional[list] = None,
               rejoin_timeout_s: float = 0.0, device="cuda",
               assert_honest: bool = False) -> int:
    """Join a master, run the worker engine until the master disconnects
    (shutdown) or timeout. Returns outputs flushed to the sink.

    ``seeds`` — list of ``(host, port)`` master addresses, tried in
    order (the reference's seed-node list: ANY seed admits a joiner,
    application.conf:14-16). Defaults to the single
    ``(master_host, master_port)``.

    ``rejoin_timeout_s > 0`` changes master-disconnect semantics from
    "cluster shutdown" to "master may have restarted": the worker
    resets its engine to the cold state and redials through the seed
    list for up to that long before giving up — so a master restarted
    on a DIFFERENT seed address picks its workers back up. The restart
    is a new master epoch (fresh seats, rounds from 0), exactly like an
    Akka cluster reformed through its remaining seeds.

    ``device`` holds the worker's payloads (``cuda`` raises without
    CUDA; ``cpu`` only when asked for). ``assert_honest`` checks every
    flush (not only the sink's checkpoints) against the synthetic
    source: ``data == arange * count``, valid at any threshold, and with
    ``assert_multiple`` also ``count == assert_multiple``; a violation
    raises. A flush that fails the sink's check (``assert_multiple`` at
    a checkpoint, or ``assert_honest``) is logged and the engine goes on,
    as the reference's supervision has it; the run then raises
    ``AssertionError`` at exit, as the C++ worker fails its run.

    With ``verbose`` the worker also prints ``worker: joined as rank N``
    when the master's init lands and, after the JAX command's ``worker N:
    K outputs``, ``worker N: report {json}``: the run's masked-reduce
    launches and store copies, its peak device GB, the router's frames,
    bytes and codec seconds each way, and the seconds from the dial to
    the exit."""
    dev = resolve_device(str(device))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = masked_reduce.MASKED_REDUCE_LAUNCHES
    copies0 = buffers_base.STORE_COPIES
    sink = ThroughputSink(source_data_size, checkpoint=checkpoint,
                          assert_multiple=assert_multiple, verbose=verbose,
                          device=dev)
    seeds = [tuple(s) for s in (seeds or [(master_host, master_port)])]
    state = {"up": True, "master": None}
    with tracer_to_file(trace_file) as tracer, \
         TcpRouter(bind_host=bind_host, port=port, role="worker",
                    heartbeat_interval_s=heartbeat_interval_s,
                    unreachable_after_s=unreachable_after_s,
                    tracer=tracer) as router:
        source = constant_range_source(source_data_size, dev)
        checked = honest_sink(sink, source.floats, assert_multiple) \
            if assert_honest else sink
        failures: list = []

        def kept_sink(out):
            # the engine logs and swallows a handler's exception (the
            # reference's supervision); a failed check is also kept, so
            # that the process fails at exit as the C++ worker does
            try:
                checked(out)
            except AssertionError as exc:
                failures.append(str(exc))
                raise

        worker = AllreduceWorker(router, source, kept_sink, tracer=tracer,
                                 device=dev)

        def dial_any(window_s):
            # Join-retry: the master may not be listening yet (workers
            # and master start concurrently, like Akka seed-node join
            # retries) — cycle the seed list until one admits us.
            # Polling between attempts keeps the router draining: on the
            # REJOIN path (worker.discard_blocks set) that is what
            # actually discards stale old-epoch blocks — frames left to
            # queue up here would only be delivered after the flag is
            # cleared, re-queued, and replayed into the new epoch.
            give_up = time.monotonic() + window_s
            while True:
                for addr in seeds:
                    try:
                        return router.dial(addr)
                    except ConnectionError:
                        continue
                if time.monotonic() >= give_up:
                    raise ConnectionError(
                        f"no master reachable among seeds {seeds}")
                router.poll(0.2)

        state["master"] = dial_any(timeout_s)
        t_join = time.perf_counter()

        def on_terminated(ref):
            worker.terminated(ref)
            if ref is state["master"]:
                state["master"] = None
                if rejoin_timeout_s <= 0:
                    state["up"] = False

        router.on_terminated = on_terminated
        deadline = time.monotonic() + timeout_s
        announced = -1
        while state["up"] and time.monotonic() < deadline:
            if state["master"] is None:
                # master epoch ended: cold-reset and rejoin through the
                # seeds (a restarted master reforms the cluster); old-
                # epoch self-sends must not replay into the new one
                worker.reset()
                router.purge_local()
                try:
                    state["master"] = dial_any(
                        min(rejoin_timeout_s,
                            max(0.1, deadline - time.monotonic())))
                    # joined the new epoch: block traffic from here on
                    # is legitimately new (or a pre-init race to
                    # re-queue); see AllreduceWorker.reset()
                    worker.discard_blocks = False
                    if verbose:
                        print(f"worker: rejoined master at "
                              f"{state['master'].addr}", flush=True)
                except ConnectionError:
                    state["up"] = False
                    continue
            router.poll(0.05)
            if verbose and worker.id != announced and worker.id != -1:
                announced = worker.id
                print(f"worker: joined as rank {worker.id}", flush=True)
        if cuda:
            torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t_join
    if verbose:
        report = {
            "rank": worker.id, "outputs": sink.outputs_seen,
            "device": str(dev),
            "masked_reduce_launches":
                masked_reduce.MASKED_REDUCE_LAUNCHES - launches0,
            "store_copies": buffers_base.STORE_COPIES - copies0,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None),
            "run_s": run_s, **router.stats}
        print(f"worker {worker.id}: {sink.outputs_seen} outputs")
        print(f"worker {worker.id}: report {json.dumps(report)}",
              flush=True)
    if failures:
        raise AssertionError(f"worker {worker.id}: {len(failures)} "
                             f"flush(es) failed the sink's check, the "
                             f"first: {failures[0]}")
    return sink.outputs_seen


def honest_sink(sink, floats: torch.Tensor, assert_multiple: int = 0):
    """``sink`` behind a check of every flush against the source's
    ``floats``: ``data == floats * count`` and, with ``assert_multiple``,
    ``count == assert_multiple`` (compared on the flush's device)."""
    def check(out) -> None:
        if not torch.equal(out.data, floats * out.count):
            raise AssertionError(f"round {out.iteration}: output != "
                                 f"input x count")
        if assert_multiple > 0 and not bool(
                (out.count == assert_multiple).all()):
            raise AssertionError(f"round {out.iteration}: counts != "
                                 f"{assert_multiple}")
        sink(out)
    return check


def run_worker_native(master_host: str = "127.0.0.1",
                      master_port: int = 2551, checkpoint: int = 10,
                      assert_multiple: int = 0, timeout_s: float = 120.0,
                      verbose: bool = False,
                      heartbeat_interval_s: float = 2.0,
                      seeds: Optional[list] = None,
                      rejoin_timeout_s: float = 0.0) -> int:
    """The C++ worker engine across process boundaries: protocol engine,
    buffers, wire codec AND transport all native (native/src/
    remote_worker.cpp) — the deployment shape of the reference's JVM
    worker under netty remoting, a host engine (no device). Joins the
    same masters, speaks the same frames, and produces bit-identical
    outputs to :func:`run_worker` (ascending-rank f32 reduction order on
    both engines), so Python and native workers can serve one cluster
    interchangeably. Returns outputs flushed; raises on assertion failure
    or unreachable master.

    ``seeds`` / ``rejoin_timeout_s`` mirror :func:`run_worker`'s
    multi-seed failover IN THE C++ ENGINE: any seed admits the joiner,
    and with a rejoin window a master disconnect cold-resets the engine
    (epoch fence included) and redials through the list.

    The source geometry comes entirely from the master's ``InitWorkers``
    (the synthetic arange source is a pure function of ``data_size``),
    so there is no ``source_data_size`` parameter to keep in sync."""
    from akka_allreduce_tpu_torch.native import load_library

    lib = load_library()
    seed_list = [tuple(s) for s in (seeds or
                                    [(master_host, master_port)])]
    csv = ",".join(f"{h}:{p}" for h, p in seed_list)
    rc = lib.aat_remote_worker_run_seeds(
        csv.encode(), checkpoint, assert_multiple, timeout_s,
        rejoin_timeout_s, heartbeat_interval_s, 1 if verbose else 0)
    if rc == -1:
        raise AssertionError(
            "native worker: output != N x input (sink assertion)")
    if rc == -2:
        raise ValueError(f"native worker: bad seed list {csv!r}")
    if rc == -3:
        raise ConnectionError(
            f"native worker: no master reachable among {seed_list} "
            f"within {timeout_s}s")
    return int(rc)


def run_master_native(config: AllreduceConfig,
                      bind_host: str = "127.0.0.1", port: int = 2551,
                      timeout_s: float = 120.0,
                      heartbeat_interval_s: float = 2.0,
                      unreachable_after_s: Optional[float] = 10.0,
                      with_round_times: bool = False):
    """The C++ master engine (native/src/remote_master.cpp): membership,
    rank seats (with reuse on rejoin), InitWorkers, thAllreduce round
    pacing, and a fixed-window silent-peer detector — same wire as
    :func:`run_master`, so Python and native workers join it
    interchangeably. Returns rounds completed, or ``(rounds, stamps)``
    with per-round monotonic completion stamps when
    ``with_round_times`` (the canonical-wire benchmark's spread
    methodology, same contract as run_native_cluster's)."""
    import ctypes

    from akka_allreduce_tpu_torch.native import load_library

    lib = load_library()
    cap = int(config.data.max_round)
    stamps = (ctypes.c_double * max(cap, 1))()
    rounds = lib.aat_remote_master_run_timed(
        bind_host.encode(), port, config.workers.total_size,
        config.data.data_size, config.data.max_chunk_size,
        config.workers.max_lag, config.thresholds.th_reduce,
        config.thresholds.th_complete, config.thresholds.th_allreduce,
        config.data.max_round, timeout_s, heartbeat_interval_s,
        0.0 if unreachable_after_s is None else unreachable_after_s, 0,
        stamps if with_round_times else None,
        cap if with_round_times else 0)
    if rounds == -3:
        raise OSError(f"native master: cannot bind {bind_host}:{port}")
    if rounds < 0:
        raise ValueError(f"native master: bad configuration ({rounds})")
    if with_round_times:
        return int(rounds), list(stamps[:max(int(rounds), 0)])
    return int(rounds)


def free_port(bind_host: str = "127.0.0.1") -> int:
    """Pick an ephemeral port (test convenience; races are acceptable on
    localhost)."""
    import socket

    with socket.socket() as s:
        s.bind((bind_host, 0))
        return s.getsockname()[1]
