"""Topology bootstrap: the processes of a run and their store.

Counterpart of ``akka_allreduce_tpu/runtime/coordinator.py``. The JAX
package joins its processes through ``jax.distributed.initialize``,
whose coordination service (hosted by process 0) also carries the
cross-process key-value store. The port's coordinator is a
``torch.distributed.TCPStore``: process 0 hosts its server at
``host:port`` and every process (process 0 too) holds a client. The
store carries the DCN trainer's payloads and masks
(``runtime/dcn_train.py``, through ``protocol/kv.py StoreKv``) and, on
the exact ``--coordinator`` path, the rendezvous of the one process
group that spans the processes (under a ``PrefixStore``).

Nothing here fails the whole gang when a process dies: a TCPStore has
no heartbeat. The DCN trainer's deadline masks, auto-down and the
master's heartbeat key are the failure detector (as they are in JAX,
where the hybrid turns the service's own detector off).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger(__name__)

# the joined store (None until initialize_distributed joins one) and this
# process's place: (process_id, num_processes, "host:port")
STORE = None
PROCESS: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class TopologySummary:
    """The identity facts the reference's InitWorkers message carried
    (rank, peer count) plus device geometry."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    platform: str

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1


def parse_address(address: str) -> tuple:
    """``host:port`` -> (host, port)."""
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got "
                         f"{address!r}")
    return host, int(port)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           heartbeat_timeout_s: Optional[int] = None,
                           timeout_s: float = 300.0) -> None:
    """Join the run's store (the master's quorum step): process 0 hosts
    the TCPStore server at ``coordinator_address`` (``host:port``, or
    the ``COORDINATOR_ADDRESS`` variable) and the others connect to it,
    waiting up to ``timeout_s`` for it to listen. Does nothing when no
    coordinator and no process count are given (one process).

    ``heartbeat_timeout_s`` is accepted for the JAX signature and has no
    effect: a TCPStore runs no failure detector, so there is none to
    widen."""
    global STORE, PROCESS
    del heartbeat_timeout_s
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None and num_processes is None:
        log.debug("single-process run; no coordinator store")
        return
    if address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the process count and this process's "
                         "id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0.."
                         f"{num_processes - 1}")
    import torch.distributed as dist
    host, port = parse_address(address)
    # the legacy server: on the card's host (scripts/store_probe.py) it
    # took 4 MiB values at ~5x the libuv server's rate, and it has no
    # payload cap (StoreKv splits values all the same)
    STORE = dist.TCPStore(host, port, is_master=process_id == 0,
                          wait_for_workers=False, use_libuv=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    PROCESS = (int(process_id), int(num_processes), f"{host}:{port}")


def shutdown() -> None:
    """Forget the joined store (process 0's server stops with it)."""
    global STORE, PROCESS
    STORE, PROCESS = None, None


def topology_summary(device: str = "cuda") -> TopologySummary:
    """This process's place and its devices: the CUDA devices, or one CPU
    when ``device`` is ``"cpu"``."""
    pid, nprocs = (0, 1) if PROCESS is None else PROCESS[:2]
    if device == "cpu":
        local, platform = 1, "cpu"
    else:
        local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        platform = "gpu" if local else "none"
    return TopologySummary(process_index=pid, process_count=nprocs,
                           local_device_count=local,
                           global_device_count=local * nprocs,
                           platform=platform)


def finish(timeout_s: float = 60.0) -> bool:
    """Mark this process finished; process 0 then waits, up to
    ``timeout_s``, for every process to do so (its store serves their
    last reads). Returns whether all finished in time."""
    if STORE is None:
        return True
    pid, nprocs = PROCESS[:2]
    done = STORE.add("finished", 1)
    if pid != 0:
        return True
    deadline = time.monotonic() + timeout_s
    while done < nprocs:
        if time.monotonic() >= deadline:
            log.warning("%d of %d processes finished within %.0f s",
                        done, nprocs, timeout_s)
            return False
        time.sleep(0.05)
        done = STORE.add("finished", 0)
    return True
