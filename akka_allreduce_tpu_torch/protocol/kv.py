"""The key-value store between processes, and a router over it.

Counterpart of ``akka_allreduce_tpu/protocol/kv.py``. The JAX package
runs its cross-process control plane through the coordination service
that ``jax.distributed.initialize`` starts; the port's coordinator is a
``torch.distributed.TCPStore`` hosted by process 0
(``runtime/coordinator.py``). :class:`StoreKv` gives that store exactly
the client surface the JAX coordination service gives ``KvRouter`` and
``DcnDeadlineTrainer`` (the surface of ``tests/kv_fake.py``), with its
error conventions: a missing key raises with ``NOT_FOUND`` in the
message, a set that may not overwrite an existing key raises with
``ALREADY_EXISTS``.

How the store holds a value. The TCPStore's libuv server refuses a
request over its payload cap (8 MiB in torch 2.13), and a gradient
bucket may be gigabytes. A value lives as a *head* key plus, when it is
larger than :data:`INLINE_BYTES`, its parts of up to :data:`PART_BYTES`
(a head is written by a ``compare_set``, whose answer echoes the value
back, so a large value rides plain ``set``s): the parts are written first,
under a generation tag unique to that write, and the head (the tag and
the part count) last, so a reader that sees the head finds every part,
and a reader sees either the whole value or ``NOT_FOUND``. A delete
removes the head first. An overwrite writes a new generation, then the
head, then deletes the old generation's parts; a reader that loses a
part to that race rereads the head once.

Reads never block. ``TCPStore.get`` waits for a missing key, and its
``check`` followed by ``get`` races with a concurrent delete (the
trainer's own garbage collection). A try-get here is one
``compare_set(key, S, S)`` with a sentinel ``S``: on a missing key the
server answers ``S`` (and sets nothing), on a present one its value, in
one round trip that never waits.

Directories without ``list_keys`` (which older torch lacks): each
directory ``D/`` keeps an index, a newline-separated list of its
children's names appended when a child is created (a subdirectory is
listed as ``name/`` when its own index is created). A directory read
walks the index, reads each child, and rewrites the index without the
children it found deleted (one ``compare_set``, skipped when a writer
appended meanwhile). Directory prefixes must end with ``/``: every
directory the trainer and the router read does. Index entries of
subdirectories are never removed (the trainer's per-round directories
leave one short entry each in the server's memory).

:class:`KvRouter` is the third transport behind the engines'
``register`` / ``send`` / ``poll`` / ``ref_of`` surface (after
``protocol/transport.py``'s in-process Router and ``protocol/tcp.py``):
a message from ``src`` to ``dst`` is one entry ``<ns>/m/<dst>/<src>/<seq>``
holding a ``protocol/wire.py`` frame; ``poll`` delivers a receiver's
entries in per-sender sequence order (the FIFO the protocol relies on,
reference: AllreduceSpec.scala:590) and deletes them. Each process
announces ``<ns>/member/<rank>`` = role, and ``poll`` surfaces new
announcements through ``on_member`` (the MemberUp flow). It is a
control-plane transport: a message costs a few store round trips.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import os
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from akka_allreduce_tpu_torch.protocol import wire
from akka_allreduce_tpu_torch.protocol.transport import ActorRef

log = logging.getLogger(__name__)

# the largest value one store request carries, under the libuv server's
# 8 MiB payload cap (a 1Mi-element f32 wire bucket and its header fit)
PART_BYTES = 6 << 20
# the largest value kept in its head: the head is written by a
# compare_set, whose answer echoes the value back
INLINE_BYTES = 64 << 10
# what a try-get's compare_set sends as both expected and desired value:
# the server answers it back only for a missing key (no value the store
# holds begins with these bytes: every head begins with I or P)
_MISSING = b"\x00kv-missing\x00"
_INLINE, _PARTED = b"I", b"P"
_GEN = 8  # bytes of a write's generation tag
_PARTS = struct.Struct("<IQ")  # part count, total bytes

_PREFIX = "aat"
# rank refs travel inside wire frames as (host="kv", port=rank) addresses
_KV_HOST = "kv"


def _not_found(key: str) -> RuntimeError:
    return RuntimeError(f"NOT_FOUND: key {key}")


def _connect(host: str, port: int, timeout_s: float = 300.0):
    import torch.distributed as dist
    return dist.TCPStore(host, int(port), is_master=False,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


class StoreKv:
    """The coordination-service client surface over a TCPStore.

    ``store`` is a connected ``torch.distributed.TCPStore`` (the
    coordinator's, from ``runtime/coordinator.py``); every key lives
    under ``root``. One lock serializes this client's requests; a thread
    that needs its own connection (the master's heartbeat) takes
    :meth:`clone`. With ``lanes`` > 1 a value's parts move on that many
    connections at once, one thread each (the connections beside
    ``store`` are opened at the first value in parts)."""

    def __init__(self, store, root: str = "kv/",
                 part_bytes: int = PART_BYTES, lanes: int = 1):
        if not root.endswith("/"):
            raise ValueError(f"root must end with '/', got {root!r}")
        self.store = store
        self.root = root
        self.part_bytes = int(part_bytes)
        self.lanes = max(1, int(lanes))
        self._lock = threading.Lock()
        self._lanes: Optional[list] = None  # [(connection, its lock)]
        self._pool: Optional[ThreadPoolExecutor] = None
        self._turn = itertools.count()

    @classmethod
    def connect(cls, host: str, port: int, timeout_s: float = 300.0,
                **kw) -> "StoreKv":
        """A client of the store server at ``host:port``."""
        return cls(_connect(host, port, timeout_s), **kw)

    def clone(self) -> "StoreKv":
        """Another client of the same server, on its own connection."""
        return StoreKv.connect(self.store.host, self.store.port,
                               root=self.root, part_bytes=self.part_bytes,
                               lanes=self.lanes)

    def _each_part(self, fn, n: int) -> None:
        """``fn(connection, i)`` for items ``i < n`` (a value's parts, a
        directory's children): item i on lane ``i % lanes``, the lanes in
        parallel threads; a single item on the lanes in turn (callers that
        set values from several threads spread over the lanes)."""
        if self._lanes is None:
            self._lanes = [(self.store, self._lock)] + [
                (_connect(self.store.host, self.store.port),
                 threading.Lock()) for _ in range(self.lanes - 1)]
            if self.lanes > 1:
                self._pool = ThreadPoolExecutor(self.lanes)
        if n == 1:
            conn, lock = self._lanes[next(self._turn) % len(self._lanes)]
            with lock:
                fn(conn, 0)
            return
        lanes = self._lanes[:max(1, min(len(self._lanes), n))]

        def run(k: int) -> None:
            conn, lock = lanes[k]
            for i in range(k, n, len(lanes)):
                with lock:
                    fn(conn, i)
        if len(lanes) == 1:
            run(0)
            return
        list(self._pool.map(run, range(len(lanes))))

    # -- the store's keys -----------------------------------------------------

    def _head(self, key: str) -> str:
        return f"{self.root}v/{key}"

    def _part(self, key: str, gen: bytes, i: int) -> str:
        return f"{self.root}p/{key}/{gen.hex()}/{i}"

    def _index(self, directory: str) -> str:
        return f"{self.root}d/{directory}"

    def _peek(self, skey: str, conn=None) -> Optional[bytes]:
        """The value of store key ``skey``, None when it is missing: one
        compare_set that never waits (on ``conn``, a lane whose lock the
        caller holds, or on this client's own connection)."""
        if conn is None:
            with self._lock:
                value = self.store.compare_set(skey, _MISSING, _MISSING)
        else:
            value = conn.compare_set(skey, _MISSING, _MISSING)
        return None if value == _MISSING else value

    # -- writes ---------------------------------------------------------------

    def _set(self, key: str, value: bytes, allow_overwrite: bool) -> None:
        if key.endswith("/") or not key:
            raise ValueError(f"not a key: {key!r}")
        gen = os.urandom(_GEN)
        if len(value) <= min(INLINE_BYTES, self.part_bytes):
            head = _INLINE + gen + value
        else:
            n, pb = -(-len(value) // self.part_bytes), self.part_bytes
            self._each_part(lambda conn, i: conn.set(
                self._part(key, gen, i), value[i * pb:(i + 1) * pb]), n)
            head = _PARTED + gen + _PARTS.pack(n, len(value))
        hkey = self._head(key)
        with self._lock:
            # the tag makes ``head`` unique: the answer is ``head`` iff
            # the key was missing and is now set
            old = self.store.compare_set(hkey, b"", head)
        if old == head:
            self._register(key)
            return
        if not allow_overwrite:
            self._drop_parts(key, head)
            raise RuntimeError(f"ALREADY_EXISTS: key {key} is already set")
        with self._lock:
            self.store.set(hkey, head)
        self._drop_parts(key, old)

    def _register(self, key: str) -> None:
        """List a new key in its directory's index, and a directory whose
        index this creates in its parent's, up the path."""
        child, suffix = key, ""
        while "/" in child:
            parent, name = child.rsplit("/", 1)
            ikey = self._index(parent + "/")
            entry = (name + suffix + "\n").encode()
            with self._lock:
                created = self.store.compare_set(
                    ikey, b"", b"\n" + entry) == b"\n" + entry
                if not created:
                    self.store.append(ikey, entry)
            if not created:
                return
            child, suffix = parent, "/"

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        self._set(key, str(value).encode(), allow_overwrite)

    def key_value_set_bytes(self, key: str, value: bytes,
                            allow_overwrite: bool = True) -> None:
        self._set(key, bytes(value), allow_overwrite)

    # -- reads ----------------------------------------------------------------

    def _get(self, key: str, conn=None) -> Optional[bytes]:
        """The value, None when missing; with ``conn`` (a lane whose lock
        the caller holds) every read on that connection, else the parts
        on the lanes."""
        for _attempt in range(2):
            head = self._peek(self._head(key), conn)
            if head is None:
                return None
            gen = head[1:1 + _GEN]
            if head[:1] == _INLINE:
                return head[1 + _GEN:]
            n, total = _PARTS.unpack_from(head, 1 + _GEN)
            # the parts copied once, into the value's own buffer
            out, got = bytearray(total), [0] * n
            pb = self.part_bytes

            def fetch(lane, i: int) -> None:
                part = self._peek(self._part(key, gen, i), lane)
                if part is not None:
                    out[i * pb:i * pb + len(part)] = part
                    got[i] = len(part)
            if conn is None:
                self._each_part(fetch, n)
            else:
                for i in range(n):
                    fetch(conn, i)
            if all(got):  # else deleted or overwritten meanwhile: reread
                if sum(got) != total:
                    raise RuntimeError(f"key {key}: {sum(got)} of {total} "
                                       f"bytes in its parts")
                return out
        return None

    def key_value_try_get(self, key: str) -> str:
        return self.key_value_try_get_bytes(key).decode()

    def key_value_try_get_bytes(self, key: str) -> bytes:
        """The value's bytes (a ``bytearray`` for a value in parts: its
        one copy)."""
        value = self._get(key)
        if value is None:
            raise _not_found(key)
        return value

    def _dir(self, prefix: str) -> list:
        if not prefix.endswith("/"):
            raise ValueError(f"a directory prefix ends with '/', got "
                             f"{prefix!r}")
        out: list = []
        self._walk(prefix, out)
        if not out:
            raise RuntimeError(f"NOT_FOUND: no keys under {prefix}")
        return sorted(out)

    def _walk(self, directory: str, out: list) -> None:
        ikey = self._index(directory)
        raw = self._peek(ikey)
        if raw is None:
            return
        names = list(dict.fromkeys(n for n in raw.decode().split("\n") if n))
        leaves = [n for n in names if not n.endswith("/")]
        values: list = [None] * len(leaves)

        def read(conn, i: int) -> None:
            values[i] = self._get(directory + leaves[i], conn)
        self._each_part(read, len(leaves))
        live = [n for n in names if n.endswith("/")]
        for name in live:
            self._walk(directory + name, out)
        for name, value in zip(leaves, values):
            if value is not None:
                live.append(name)
                out.append((directory + name, value))
        if len(live) < len(names):
            # forget the deleted children, unless a writer appended since
            compact = ("\n" + "".join(n + "\n" for n in live)).encode()
            with self._lock:
                self.store.compare_set(ikey, raw, compact)

    def key_value_dir_get(self, prefix: str) -> list:
        return [(k, v.decode()) for k, v in self._dir(prefix)]

    def key_value_dir_get_bytes(self, prefix: str) -> list:
        return self._dir(prefix)

    # -- delete ---------------------------------------------------------------

    def _drop_parts(self, key: str, head: Optional[bytes]) -> None:
        if head is None or head[:1] != _PARTED:
            return
        gen = head[1:1 + _GEN]
        n, _ = _PARTS.unpack_from(head, 1 + _GEN)
        with self._lock:
            for i in range(n):
                self.store.delete_key(self._part(key, gen, i))

    def key_value_delete(self, key: str) -> None:
        hkey = self._head(key)
        head = self._peek(hkey)
        if head is None:
            return
        with self._lock:
            self.store.delete_key(hkey)
        self._drop_parts(key, head)


class KvRef:
    """Addressable handle for a peer process's engine (by process rank)."""

    def __init__(self, rank: int):
        self.rank = rank

    def __repr__(self) -> str:
        return f"<kv rank={self.rank}>"


def _default_client():
    from akka_allreduce_tpu_torch.runtime import coordinator

    if coordinator.STORE is None:
        raise RuntimeError(
            "KvRouter needs the coordinator's store: call "
            "runtime/coordinator.initialize_distributed first")
    return StoreKv(coordinator.STORE)


class KvRouter:
    """Router surface over the store. ``rank`` defaults to the process id
    given to ``initialize_distributed``; ``on_member(ref, role)`` fires
    when another process's announcement is first seen."""

    def __init__(self, rank: Optional[int] = None, role: str = "worker",
                 namespace: str = _PREFIX, client=None,
                 on_member: Optional[Callable[[KvRef, str], None]] = None,
                 on_terminated: Optional[Callable[[KvRef], None]] = None):
        if client is None:
            client = _default_client()
        if rank is None:
            from akka_allreduce_tpu_torch.runtime import coordinator
            rank = coordinator.topology_summary("cpu").process_index
        self._c = client
        self.rank = int(rank)
        self.role = role
        self.ns = namespace
        self.on_member = on_member
        self.on_terminated = on_terminated  # fired by the owner

        self._local: dict = {}
        self._primary: Optional[ActorRef] = None
        self._local_mail: deque = deque()
        self._refs: dict = {}
        self._send_seq: dict = {}
        self._known_members: set = set()
        self._inbox = f"{self.ns}/m/{self.rank}/"
        self._c.key_value_set(f"{self.ns}/member/{self.rank}", role,
                              allow_overwrite=True)

    # -- Router surface -------------------------------------------------------

    def register(self, name: Optional[str] = None,
                 handler: Optional[Callable] = None) -> ActorRef:
        ref = ActorRef(name)
        if handler is not None:
            self._local[ref] = handler
            if self._primary is None:
                self._primary = ref
        return ref

    def send(self, ref, msg) -> None:
        if isinstance(ref, ActorRef):
            self._local_mail.append((ref, msg))  # actor self-send
            return
        if not isinstance(ref, KvRef):
            raise TypeError(f"cannot route to {ref!r}")
        if ref.rank == self.rank:
            # self-delivery bypass (reference: AllreduceWorker.scala:228-231)
            if self._primary is not None:
                self._local_mail.append((self._primary, msg))
            return
        seq = self._send_seq.get(ref.rank, 0)
        self._send_seq[ref.rank] = seq + 1
        data = wire.encode(msg, self._addr_for)
        self._c.key_value_set_bytes(
            f"{self.ns}/m/{ref.rank}/{self.rank:06d}/{seq:012d}", data)

    def ref_of(self, addr) -> "KvRef | ActorRef":
        """Accepts a rank int or a ('kv', rank) wire address."""
        rank = addr[1] if isinstance(addr, tuple) else int(addr)
        if rank == self.rank and self._primary is not None:
            return self._primary
        ref = self._refs.get(rank)
        if ref is None:
            ref = self._refs[rank] = KvRef(rank)
        return ref

    def _addr_for(self, ref) -> wire.Addr:
        if isinstance(ref, KvRef):
            return (_KV_HOST, ref.rank)
        return (_KV_HOST, self.rank)  # a local ref: our own rank

    # -- event pump -----------------------------------------------------------

    def poll(self, timeout_s: float = 0.0) -> int:
        """Deliver local self-sends, new member announcements and inbound
        frames (per-sender FIFO). Waits up to ``timeout_s`` for the first
        activity; returns the messages delivered."""
        deadline = time.monotonic() + timeout_s
        delivered = 0
        while True:
            delivered += self._drain_local()
            self._scan_members()
            delivered += self._drain_inbound()
            if delivered or timeout_s == 0.0 \
                    or time.monotonic() >= deadline:
                return delivered
            time.sleep(0.002)

    def _drain_local(self) -> int:
        n = 0
        for _ in range(len(self._local_mail)):
            ref, msg = self._local_mail.popleft()
            handler = self._local.get(ref)
            if handler is not None:
                handler(msg)
                n += 1
        return n

    def _scan_members(self) -> None:
        if self.on_member is None:
            return
        try:
            entries = self._c.key_value_dir_get(f"{self.ns}/member/")
        except Exception:  # no entries yet surfaces as NOT_FOUND
            return
        for key, role in entries:
            rank = int(key.rsplit("/", 1)[-1])
            if rank == self.rank or rank in self._known_members:
                continue
            self._known_members.add(rank)
            self.on_member(self.ref_of(rank), role)

    def _drain_inbound(self) -> int:
        try:
            entries = self._c.key_value_dir_get_bytes(self._inbox)
        except Exception:
            return 0
        n = 0
        # keys sort as <src>/<seq> with fixed-width numbers: per-sender FIFO
        for key, data in sorted(entries):
            if self._primary is None:
                # no engine registered yet: leave the message for a later
                # poll (deleting it would punch a hole in the sender's FIFO)
                return n
            try:
                msg = wire.decode(data, self.ref_of)
            except Exception:
                log.exception("dropping undecodable frame %s", key)
                self._c.key_value_delete(key)
                continue
            self._c.key_value_delete(key)
            self._local[self._primary](msg)
            n += 1
        return n

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        try:
            self._c.key_value_delete(f"{self.ns}/member/{self.rank}")
        except Exception:
            pass

    def __enter__(self) -> "KvRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
