"""Host control-plane protocol engine, with its payloads on the device.

Counterpart of ``akka_allreduce_tpu/protocol/``: a transport-agnostic,
deterministic re-implementation of the reference's actor protocol
(reference: AllreduceWorker.scala:7-301, AllreduceMaster.scala:12-90):
the scatter → reduce → broadcast → complete state machine with threshold
gates, the ``max_lag`` staleness window and catch-up path, and the
master's membership / rank-assignment / round-pacing duties. The state
machine runs on the host; the chunks, staging rows and outputs are
tensors on the engine's device, and each chunk reduce is a masked-reduce
launch on the card (``buffers/scattered.py``).

Across processes: ``wire.py`` (the frames), ``tcp.py`` (the
router over the C++ transport), ``remote.py`` (master and worker
processes; the C++ engines) and ``native_cluster.py`` (the C++
in-process cluster).
"""

from akka_allreduce_tpu_torch.protocol.transport import ActorRef, Router, Probe
from akka_allreduce_tpu_torch.protocol.worker import AllreduceWorker
from akka_allreduce_tpu_torch.protocol.master import AllreduceMaster
from akka_allreduce_tpu_torch.protocol.cluster import LocalCluster
from akka_allreduce_tpu_torch.protocol.tcp import RemoteRef, TcpRouter
from akka_allreduce_tpu_torch.protocol.remote import (
    free_port, run_master, run_master_native, run_worker, run_worker_native)
from akka_allreduce_tpu_torch.protocol.native_cluster import \
    run_native_cluster

__all__ = [
    "ActorRef",
    "Router",
    "Probe",
    "AllreduceWorker",
    "AllreduceMaster",
    "LocalCluster",
    "RemoteRef",
    "TcpRouter",
    "free_port",
    "run_master",
    "run_master_native",
    "run_worker",
    "run_worker_native",
    "run_native_cluster",
]
