"""Probe the coordinator store's limits and rates on this host.

``train --coordinator --deadline-ms`` moves every process's gradient
through a ``torch.distributed.TCPStore`` that process 0 hosts
(``akka_allreduce_tpu_torch/protocol/kv.py``). This prints one JSON line
per finding, over loopback, for the libuv and the legacy server:

* ``torch``: the version, and whether ``TCPStore.list_keys`` exists;
* ``cap``: whether one raw ``set`` of 16 MiB is refused (the libuv
  server's payload cap) on a connection of its own;
* ``raw``: ``set`` and try-get (``compare_set``) MB/s of 4 MiB values,
  one client, over ``--mib`` MiB;
* ``store_kv``: ``StoreKv`` set and get MB/s of one ``--value-mib``
  value (its parts on one connection, and on 4 at once), and with two
  writer processes' worth of values from two threads on their own
  connections at once;
* ``bf16``: the host cost of the bf16 wire's encode and decode
  (``runtime/dcn_train.py``) of ``--elems`` f32 values.

Run: ``python scripts/store_probe.py [--mib 256] [--value-mib 1024]
[--elems 541130752]``.
"""

import argparse
import datetime
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def emit(kind: str, **fields) -> None:
    print(json.dumps({"probe": kind, **fields}), flush=True)


def server(use_libuv: bool):
    import torch.distributed as dist
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False, use_libuv=use_libuv,
                         timeout=datetime.timedelta(seconds=60))


def client(srv):
    import torch.distributed as dist
    return dist.TCPStore("127.0.0.1", srv.port, is_master=False,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=60))


def probe_cap(srv) -> dict:
    c = client(srv)
    try:
        c.set("cap", b"\0" * (16 << 20))
        return {"refused": False}
    except Exception as exc:  # noqa: BLE001 - the finding itself
        return {"refused": True, "error": str(exc)[:200]}


def probe_raw(srv, mib: int) -> dict:
    c = client(srv)
    value = os.urandom(4 << 20)
    n = max(1, mib // 4)
    t0 = time.perf_counter()
    for i in range(n):
        c.set(f"raw/{i}", value)
    t1 = time.perf_counter()
    for i in range(n):
        got = c.compare_set(f"raw/{i}", b"\0missing", b"\0missing")
        assert len(got) == len(value)
    t2 = time.perf_counter()
    for i in range(n):
        c.delete_key(f"raw/{i}")
    mb = n * len(value) / 1e6
    return {"values": n, "set_mb_per_s": mb / (t1 - t0),
            "get_mb_per_s": mb / (t2 - t1)}


def probe_store_kv(srv, value_mib: int, lanes: int) -> dict:
    from akka_allreduce_tpu_torch.protocol.kv import StoreKv
    kv = StoreKv(client(srv), lanes=lanes)
    value = os.urandom(value_mib << 20)
    t0 = time.perf_counter()
    kv.key_value_set_bytes("one/v", value)
    t1 = time.perf_counter()
    assert kv.key_value_try_get_bytes("one/v") == value
    t2 = time.perf_counter()
    kv.key_value_delete("one/v")
    mb = len(value) / 1e6
    out = {"value_mb": mb, "set_mb_per_s": mb / (t1 - t0),
           "get_mb_per_s": mb / (t2 - t1)}
    # two processes' publishes at once, each on its own connection
    kvs = [StoreKv(client(srv), lanes=lanes) for _ in range(2)]
    spans = [None, None]

    def put(i):
        t = time.perf_counter()
        kvs[i].key_value_set_bytes(f"two/{i}", value)
        spans[i] = time.perf_counter() - t

    threads = [threading.Thread(target=put, args=(i,)) for i in range(2)]
    t3 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    both = time.perf_counter() - t3
    for i in range(2):
        kvs[i].key_value_delete(f"two/{i}")
    out.update(two_writers_s=both, two_writers_mb_per_s=2 * mb / both,
               two_writer_spans_s=spans)
    return out


def probe_bf16(elems: int) -> dict:
    import numpy as np

    from akka_allreduce_tpu_torch.runtime.dcn_train import (decode_payload,
                                                            encode_payload)
    vec = np.random.default_rng(0).standard_normal(elems, np.float32)
    t0 = time.perf_counter()
    data = encode_payload(vec, 1.0, 1, "bf16")
    t1 = time.perf_counter()
    decode_payload(data)
    t2 = time.perf_counter()
    return {"elems": elems, "encode_s": t1 - t0, "decode_s": t2 - t1,
            "payload_gb": len(data) / 1e9}


def main() -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mib", type=int, default=256)
    p.add_argument("--value-mib", type=int, default=1024)
    p.add_argument("--elems", type=int, default=541_130_752)
    args = p.parse_args()
    import torch.distributed as dist
    emit("torch", version=torch.__version__, cuda=torch.version.cuda,
         list_keys=hasattr(dist.TCPStore, "list_keys"),
         cpus=os.cpu_count())
    for libuv in (True, False):
        srv = server(libuv)
        emit("cap", libuv=libuv, **probe_cap(srv))
        emit("raw", libuv=libuv, **probe_raw(srv, args.mib))
        for lanes in (1, 4):
            emit("store_kv", libuv=libuv, lanes=lanes,
                 **probe_store_kv(srv, args.value_mib, lanes))
        del srv
    emit("bf16", **probe_bf16(args.elems))
    return 0


if __name__ == "__main__":
    sys.exit(main())
