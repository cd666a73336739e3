"""TCP router: the protocol engines over the native C++ transport.

Counterpart of ``akka_allreduce_tpu/protocol/tcp.py``, behaviour for
behaviour, over the port's own copy of the C++ transport
(``akka_allreduce_tpu_torch/native``) and its own codec (``wire.py``).
The multi-process deployment surface, equivalent to the reference's Akka
remoting configuration (reference: application.conf:1-21): each process runs
one protocol engine (master or worker) behind a :class:`TcpRouter` exposing
the same ``register``/``send`` surface as the in-process Router
(protocol/transport.py), so the engines run unchanged. Remote peers are
addressed by interned :class:`RemoteRef` (host, port) handles — interning
preserves the identity semantics the engines rely on (self-delivery bypass,
deathwatch ``is`` checks). Framing, connection management, and disconnect
detection live in C++ (native/src/transport.cpp); this layer adds the codec
(protocol/wire.py) and membership greetings.
"""

from __future__ import annotations

import ctypes
import logging
import time
from collections import deque
from typing import Callable, Optional

from akka_allreduce_tpu_torch.native import load_library
from akka_allreduce_tpu_torch.protocol import wire
from akka_allreduce_tpu_torch.protocol.transport import ActorRef

log = logging.getLogger(__name__)


class RemoteRef:
    """Addressable handle for a peer process's engine. One interned instance
    per address per router (see :meth:`TcpRouter.ref_of`)."""

    def __init__(self, addr: wire.Addr):
        self.addr = addr

    def __repr__(self) -> str:
        return f"<remote {self.addr[0]}:{self.addr[1]}>"


class TcpRouter:
    """Router surface over the native TCP transport.

    ``on_member(ref, role)`` fires when a peer's Hello arrives (the MemberUp
    flow); ``on_terminated(ref)`` fires when a peer's connection drops (the
    deathwatch flow, reference: AllreduceMaster.scala:46-52).
    """

    def __init__(self, bind_host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None, role: str = "worker",
                 on_member: Optional[Callable[[RemoteRef, str], None]] = None,
                 on_terminated: Optional[Callable[[RemoteRef], None]] = None,
                 connect_timeout_s: float = 10.0,
                 heartbeat_interval_s: float = 2.0,
                 unreachable_after_s: Optional[float] = 10.0,
                 max_frame_bytes: int = 1 << 26,
                 tracer=None):
        self._lib = load_library()
        self._connect_timeout_ms = int(connect_timeout_s * 1000)
        self._t = self._lib.aat_create(bind_host.encode(), port)
        if not self._t:
            raise OSError(f"cannot bind TCP transport on {bind_host}:{port}")
        self.addr: wire.Addr = (advertise_host or bind_host,
                                self._lib.aat_port(self._t))
        self.role = role
        self.on_member = on_member
        self.on_terminated = on_terminated
        # Liveness failure detection (reference: application.conf:20
        # ``auto-down-unreachable-after = 10s``): every poll(), Pings go out
        # at ``heartbeat_interval_s`` REGARDLESS of the local detector (a
        # node that opted out of detecting must stay detectable, or its
        # detector-enabled peers down it during quiet stretches), and any
        # peer silent for ``unreachable_after_s`` is downed — connection
        # closed, deathwatch fired — exactly as if it had disconnected.
        # This catches hung-but-connected peers (SIGSTOP, GC pause,
        # deadlock) that the closed-socket path never sees. ``None``
        # disables the local detector only.
        if unreachable_after_s is not None \
                and unreachable_after_s < 2 * heartbeat_interval_s:
            # a window shorter than the peers' ping cadence downs healthy
            # peers: at a detection tick their last ping can legitimately
            # be a full interval old
            raise ValueError(
                f"unreachable_after_s={unreachable_after_s} must be at "
                f"least 2 x heartbeat_interval_s={heartbeat_interval_s} "
                f"(or None to disable the detector)")
        self._hb_interval = heartbeat_interval_s
        self._unreachable_after = unreachable_after_s
        self._last_ping_sent = 0.0
        # Liveness is tracked PER ADDRESS, not per connection: when two
        # peers dial each other simultaneously (certain at round 0 —
        # every worker scatters at once) the pair carries TWO TCP
        # connections, each side sending on the one it dialed and
        # receiving on the inbound one. A per-connection tracker then
        # watches the dialed conn — which never receives a frame — and
        # falsely downs every such peer exactly one unreachable window
        # after the first exchange, dismembering a healthy cluster (the
        # SIGSTOP cluster test caught this as a stall: all three
        # survivors downed each other in one sweep). Any frame from any
        # conn mapped to the addr proves the PEER alive.
        self._last_heard: dict[wire.Addr, float] = {}
        # optional runtime/tracing.Tracer: liveness events (peer downs,
        # disconnects) join the same structured stream the engines write
        self.tracer = tracer
        # each peer's advertised ping cadence (learned from its Pings): the
        # down check widens its window to 2x this for slow-pinging peers,
        # so asymmetric intervals can't produce false downs — the local
        # 2x-interval ctor guard only covers symmetric deployments
        self._peer_interval: dict[wire.Addr, float] = {}

        self._local: dict[ActorRef, Callable] = {}
        self._primary: Optional[ActorRef] = None
        self._local_mail: deque = deque()
        self._refs: dict[wire.Addr, RemoteRef] = {}
        self._conn_of: dict[wire.Addr, int] = {}
        self._addr_of_conn: dict[int, wire.Addr] = {}
        # addrs whose Hello already fired on_member: Akka fires MemberUp
        # once per member, and native workers RE-Hello until initialized
        # (cold-start self-healing) — repeats must not re-announce a
        # live member. Cleared on termination so a REJOINER announces
        # again (and so a genuinely-lost first Hello still fires on the
        # retry: a lost frame never entered this set).
        self._greeted: set[wire.Addr] = set()
        # deathwatch latch: a peer we have sighted (greeted us, or we
        # dialed it) whose death has not fired yet. A mutually-dialed
        # pair's TWO connections produce TWO disconnect events on real
        # death — on_terminated must fire exactly once per incarnation,
        # whichever event order the kernel delivers.
        self._alive_addrs: set[wire.Addr] = set()
        # Hostile-peer bound on the length prefix (above the C++
        # transport's own 1 GiB corrupt-stream cap): a peer whose frame
        # claims more than this is downed — legitimate serving frames
        # are KiB-scale, gradient chunks MB-scale. The oversized frame
        # is dequeued into a transient buffer (a one-shot copy of
        # bytes the C++ inbound queue already holds, freed
        # immediately; the PERSISTENT recv buffer never grows to a
        # hostile size) and dropped undecoded.
        if max_frame_bytes < (1 << 16):
            raise ValueError(
                f"max_frame_bytes={max_frame_bytes} below the 64 KiB "
                f"floor a single protocol frame can legitimately need")
        self._max_frame = max_frame_bytes
        self._recv_buf = (ctypes.c_uint8 * (1 << 20))()
        # the engines' traffic on this router (Hellos and Pings not
        # counted): frames and bytes each way, and the host seconds spent
        # in the codec — on a card worker, encoding includes the
        # payload's device-to-host copy
        self.stats = {"frames_sent": 0, "bytes_sent": 0, "encode_s": 0.0,
                      "frames_received": 0, "bytes_received": 0,
                      "decode_s": 0.0}

    # -- Router surface (what the engines call) -----------------------------

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
            # Local re-queue (uninitialized-worker path): back of the line,
            # like an actor self-send.
            self._local_mail.append((ref, msg))
            return
        if not isinstance(ref, RemoteRef):
            raise TypeError(f"cannot route to {ref!r}")
        conn = self._ensure_conn(ref.addr)
        if conn is None:
            return  # dead peer: dead-letter drop, like Akka
        t0 = time.perf_counter()
        data = wire.encode(msg, self._addr_for)
        stats = self.stats
        stats["encode_s"] += time.perf_counter() - t0
        stats["frames_sent"] += 1
        stats["bytes_sent"] += len(data)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._lib.aat_send(self._t, conn, buf, len(data))

    # -- address/ref resolution ---------------------------------------------

    def ref_of(self, addr: wire.Addr):
        """Interned ref for an address; our own address resolves to the
        primary local engine so the self-delivery bypass still short-circuits
        (reference: AllreduceWorker.scala:228-231)."""
        if tuple(addr) == tuple(self.addr) and self._primary is not None:
            return self._primary
        ref = self._refs.get(addr)
        if ref is None:
            ref = self._refs[addr] = RemoteRef(addr)
        return ref

    def _addr_for(self, ref) -> wire.Addr:
        if isinstance(ref, RemoteRef):
            return ref.addr
        return self.addr  # a local ref: advertise our own address

    def _ensure_conn(self, addr: wire.Addr) -> Optional[int]:
        conn = self._conn_of.get(addr)
        if conn is not None:
            return conn
        conn = self._lib.aat_connect(self._t, addr[0].encode(), addr[1],
                                     self._connect_timeout_ms)
        if conn < 0:
            return None
        self._conn_of[addr] = conn
        self._addr_of_conn[conn] = addr
        self._alive_addrs.add(addr)
        # Greet so the remote can map this connection back to our address.
        data = wire.encode(wire.Hello(self.addr, self.role), self._addr_for)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._lib.aat_send(self._t, conn, buf, len(data))
        return conn

    def dial(self, addr: wire.Addr) -> RemoteRef:
        """Explicitly connect (worker -> master seed-node join)."""
        if self._ensure_conn(tuple(addr)) is None:
            raise ConnectionError(f"cannot reach {addr}")
        return self.ref_of(tuple(addr))

    def heartbeat_age(self, addr: wire.Addr) -> Optional[float]:
        """Seconds since ANY frame arrived from ``addr`` (Pings count),
        or None for a peer never heard from / already downed. The
        supervisor's per-replica heartbeat-age gauge reads this — the
        operator's first triage signal for a SIGSTOPped or wedged
        replica (OPERATIONS.md "Dead-replica triage")."""
        heard = self._last_heard.get(tuple(addr))
        if heard is None:
            return None
        return max(0.0, time.monotonic() - heard)

    def purge_local(self) -> int:
        """Drop every queued local self-send. The multi-seed rejoin path
        calls this at engine reset: re-queued blocks from the old master
        epoch must not replay into the new one."""
        n = len(self._local_mail)
        self._local_mail.clear()
        return n

    # -- event pump ----------------------------------------------------------

    def poll(self, timeout_s: float = 0.0) -> int:
        """Process available traffic: local self-sends, inbound frames, and
        disconnects. Blocks up to ``timeout_s`` waiting for the first
        activity; returns messages delivered."""
        deadline = time.monotonic() + timeout_s
        delivered = 0
        while True:
            delivered += self._drain_local()
            delivered += self._drain_inbound()
            self._drain_disconnects()
            self._heartbeat()
            if delivered or timeout_s == 0.0 \
                    or time.monotonic() >= deadline:
                return delivered
            time.sleep(0.0002)

    def _heartbeat(self) -> None:
        """Send Pings at the heartbeat interval and (when the local
        detector is enabled) down peers silent past the unreachable window
        (the reference's auto-down, application.conf:20). Runs from
        poll(), so a process that stops polling also stops heartbeating
        and is downed by its peers. Pings are sent even when the local
        detector is disabled — opting out of detecting must not make this
        node undetectable."""
        now = time.monotonic()
        if now - self._last_ping_sent < self._hb_interval:
            return
        self._last_ping_sent = now
        ping = wire.encode(wire.Ping(self._hb_interval), self._addr_for)
        buf = (ctypes.c_uint8 * len(ping)).from_buffer_copy(ping)
        for addr, conn in list(self._conn_of.items()):
            heard = self._last_heard.get(addr)
            if heard is None:
                self._last_heard[addr] = now
            elif self._unreachable_after is not None:
                # a slow-pinging (but alive) peer legitimately goes quiet
                # for its whole interval: never down inside 2x its cadence
                # — but cap the widening at 5x the local window, so one
                # misconfigured peer advertising a huge interval cannot
                # opt itself out of failure detection entirely
                widened = min(2 * self._peer_interval.get(addr, 0.0),
                              5 * self._unreachable_after)
                window = max(self._unreachable_after, widened)
                if now - heard > window:
                    log.warning(
                        "downing unreachable peer %s:%s (silent %.1fs)",
                        addr[0], addr[1], now - heard)
                    if self.tracer is not None:
                        self.tracer.record("peer_unreachable_down",
                                           host=addr[0], port=addr[1],
                                           silent_s=round(now - heard, 3),
                                           window_s=round(window, 3))
                    self._down_addr(addr)
                    continue
            self._lib.aat_send(self._t, conn, buf, len(ping))

    def _down_addr(self, addr: wire.Addr) -> None:
        """Down a PEER: close every connection mapped to its address (a
        mutually-dialed pair carries two) and fire deathwatch once."""
        for conn, a in list(self._addr_of_conn.items()):
            if a == addr:
                self._lib.aat_close_peer(self._t, conn)
                self._addr_of_conn.pop(conn, None)
        self._last_heard.pop(addr, None)
        self._peer_interval.pop(addr, None)
        self._conn_of.pop(addr, None)
        self._greeted.discard(addr)
        if addr not in self._alive_addrs:
            return  # this incarnation's death already fired
        self._alive_addrs.discard(addr)
        if self.on_terminated is not None and addr in self._refs:
            self.on_terminated(self._refs[addr])

    def _drain_local(self) -> int:
        # Process only what was queued at entry: a handler that re-queues to
        # itself (uninitialized worker waiting for InitWorkers) must not
        # starve the inbound drain where that InitWorkers is waiting.
        n = 0
        for _ in range(len(self._local_mail)):
            ref, msg = self._local_mail.popleft()
            handler = self._local.get(ref)
            if handler is not None:
                handler(msg)
                n += 1
        return n

    def _drain_inbound(self) -> int:
        n = 0
        while True:
            need = self._lib.aat_recv_len(self._t)
            if need < 0:
                return n
            if need > self._max_frame:
                # hostile length prefix: dequeue into a TRANSIENT
                # buffer (exactly the bytes the C++ queue already
                # holds — freed when this scope exits; the persistent
                # recv buffer must never grow to a hostile size), drop
                # the frame undecoded, and DOWN the peer — one bad
                # actor cannot keep feeding the codec
                tmp = (ctypes.c_uint8 * int(need))()
                src = ctypes.c_int(-1)
                got = self._lib.aat_recv_take(self._t, tmp, len(tmp),
                                              ctypes.byref(src))
                del tmp
                if got < 0:
                    return n
                addr = self._addr_of_conn.get(src.value)
                log.warning(
                    "downing peer %s: frame of %d bytes exceeds "
                    "max_frame_bytes=%d", addr or f"conn {src.value}",
                    got, self._max_frame)
                if self.tracer is not None:
                    self.tracer.record("peer_oversized_frame",
                                       conn=src.value, bytes=int(got),
                                       cap=self._max_frame)
                if addr is not None:
                    self._down_addr(addr)
                else:
                    # never said Hello, already hostile: close the
                    # CONNECTION — an anonymous client must not get
                    # to trigger giant allocations repeatedly
                    self._lib.aat_close_peer(self._t, src.value)
                continue
            if need > len(self._recv_buf):
                self._recv_buf = (ctypes.c_uint8 * int(need * 2))()
            src = ctypes.c_int(-1)
            got = self._lib.aat_recv_take(self._t, self._recv_buf,
                                          len(self._recv_buf),
                                          ctypes.byref(src))
            if got < 0:
                return n
            try:
                # string_at is one C memcpy; slicing the ctypes array would
                # materialize a per-byte Python int list on the hot path.
                t0 = time.perf_counter()
                msg = wire.decode(ctypes.string_at(self._recv_buf, got),
                                  self.ref_of)
                t_decode = time.perf_counter() - t0
            except Exception as exc:
                # An undecodable frame from a MAPPED peer means the peer
                # is corrupt, hostile, or a different build (the wire
                # version check lands here too): surface it as a PEER
                # FAILURE — deathwatch fires, the supervisor/engine sees
                # a dead member — never as a codec exception swallowed
                # in the router's loop. A conn that never said Hello
                # has no deathwatch identity to fire — close the
                # CONNECTION itself so an anonymous sender cannot keep
                # feeding the codec.
                addr = self._addr_of_conn.get(src.value)
                if addr is not None:
                    log.error("downing peer %s:%s on undecodable "
                              "frame: %s", addr[0], addr[1], exc)
                    if self.tracer is not None:
                        self.tracer.record(
                            "peer_undecodable_frame", host=addr[0],
                            port=addr[1], error=str(exc)[:200])
                    self._down_addr(addr)
                else:
                    log.error(
                        "closing unmapped conn %d on undecodable "
                        "frame: %s", src.value, exc)
                    self._lib.aat_close_peer(self._t, src.value)
                continue
            if isinstance(msg, wire.Hello):
                self._handle_hello(msg, src.value)
            # any frame proves the PEER alive for the failure detector —
            # keyed by address so it counts whichever of a duplicated
            # pair's connections the peer actually writes on (the Hello
            # above maps the conn before the lookup)
            addr = self._addr_of_conn.get(src.value)
            if addr is not None:
                self._last_heard[addr] = time.monotonic()
            if isinstance(msg, wire.Ping):
                # heartbeat only — never delivered to engines; remember
                # the sender's cadence for the adaptive down window
                if msg.interval > 0 and addr is not None:
                    self._peer_interval[addr] = msg.interval
            elif not isinstance(msg, wire.Hello):
                stats = self.stats
                stats["decode_s"] += t_decode
                stats["frames_received"] += 1
                stats["bytes_received"] += got
                if self._primary is not None:
                    self._local[self._primary](msg)
            n += 1

    def _handle_hello(self, hello: wire.Hello, conn: int) -> None:
        addr = tuple(hello.addr)
        self._addr_of_conn[conn] = addr
        # Prefer an existing (dialed) connection for sending; otherwise the
        # inbound one is bidirectional TCP — reply on it.
        self._conn_of.setdefault(addr, conn)
        self._alive_addrs.add(addr)
        ref = self.ref_of(addr)  # intern now so deathwatch can resolve it
        if addr in self._greeted:
            return  # repeat greeting from a live member (see ctor note)
        self._greeted.add(addr)
        if self.on_member is not None and isinstance(ref, RemoteRef):
            self.on_member(ref, hello.role)

    def _drain_disconnects(self) -> None:
        while True:
            conn = self._lib.aat_poll_disconnect(self._t)
            if conn < 0:
                return
            addr = self._addr_of_conn.pop(conn, None)
            if addr is None:
                continue
            if self._conn_of.get(addr) == conn:
                del self._conn_of[addr]
            # a mutually-dialed pair carries two connections: losing ONE
            # is not peer death. Suppress deathwatch only when an OLDER
            # conn survives (conn ids are monotonic): the pair's conns
            # predate each other's drops, while a same-addr RESTART's
            # fresh conn is NEWER than the dying one — suppressing on it
            # would leave the engine trusting a state-less new process
            # as the old live member
            survivors = [c for c, a in self._addr_of_conn.items()
                         if a == addr and c < conn]
            if survivors:
                self._conn_of.setdefault(addr, survivors[0])
                continue
            self._last_heard.pop(addr, None)
            self._peer_interval.pop(addr, None)
            self._greeted.discard(addr)
            if addr not in self._alive_addrs:
                continue  # this incarnation's death already fired
            self._alive_addrs.discard(addr)
            if self.tracer is not None:
                self.tracer.record("peer_disconnect",
                                   host=addr[0], port=addr[1])
            if self.on_terminated is not None and addr in self._refs:
                self.on_terminated(self._refs[addr])

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait until queued outbound bytes reach the kernel."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(self._lib.aat_send_drained(self._t, c)
                   for c in self._conn_of.values()):
                return True
            time.sleep(0.001)
        return False

    def close(self) -> None:
        if self._t:
            self._lib.aat_destroy(self._t)
            self._t = None

    def __enter__(self) -> "TcpRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
