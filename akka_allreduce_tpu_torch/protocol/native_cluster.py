"""Native (C++) in-process cluster: the protocol hot loop without Python.

Counterpart of ``akka_allreduce_tpu/protocol/native_cluster.py`` over the
port's own copy of the C++ engines (``akka_allreduce_tpu_torch/native``).
A host engine: its payloads are host floats, no tensor and no device.

``run_native_cluster`` executes the complete scatter/reduce/broadcast/
complete protocol — same thresholds, chunking, maxLag ring, catch-up, and
deathwatch semantics as the Python engines (protocol/worker.py,
protocol/master.py are the SPEC; native/src/cluster.cpp is the mirror) —
inside libaatpu_torch.so. The reference's runtime is JVM-native Akka
(reference: build.sbt:16-22); in the protocol-bound benchmark regime
(tiny payloads, the README config) the runtime IS the measurement, so the
framework ships a native one. Agreement between the two engines is pinned
by tests/test_torch_native.py.
"""

from __future__ import annotations

import ctypes

from akka_allreduce_tpu_torch.config import AllreduceConfig
from akka_allreduce_tpu_torch.native import load_library


def run_native_cluster(config: AllreduceConfig,
                       kill_rank: int | None = None,
                       assert_multiple: int = 0,
                       with_round_times: bool = False):
    """Run the whole cluster natively; returns (rounds_completed,
    outputs_flushed), plus a list of per-round monotonic completion
    stamps when ``with_round_times`` — the per-round spread the
    canonical-scale benchmarks quote alongside the mean rate.

    ``assert_multiple > 0`` enables the reference sink's correctness
    invariant on EVERY flush (output == N x input, counts == N — valid
    when all thresholds are 1.0, reference: AllreduceWorker.scala:337-339);
    a violation raises.
    """
    lib = load_library()
    flushed = ctypes.c_long(0)
    cap = config.data.max_round + 1
    times = (ctypes.c_double * cap)()
    rounds = lib.aat_cluster_run_timed(
        config.workers.total_size,
        config.data.data_size,
        config.data.max_chunk_size,
        config.workers.max_lag,
        config.thresholds.th_reduce,
        config.thresholds.th_complete,
        config.thresholds.th_allreduce,
        config.data.max_round,
        -1 if kill_rank is None else kill_rank,
        assert_multiple,
        ctypes.byref(flushed),
        times,
        cap,
    )
    if rounds == -1:
        raise AssertionError(
            "native cluster: sink correctness invariant violated "
            "(output != N x input or counts != N)")
    if rounds < 0:
        raise ValueError(f"native cluster: bad configuration ({rounds})")
    if with_round_times:
        return (int(rounds), int(flushed.value),
                [times[i] for i in range(min(int(rounds), cap))])
    return int(rounds), int(flushed.value)
