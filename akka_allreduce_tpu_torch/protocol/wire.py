"""Binary wire codec for the 5-message allreduce protocol and the serving
frames.

Counterpart of ``akka_allreduce_tpu/protocol/wire.py``, frame for frame
and byte for byte. Plays the role of Akka's message serializer above
the netty transport (reference: AllreduceMessage.scala:7-21 are the
serialized case classes; application.conf:5-11 is the transport below).
Frames are produced/consumed by the native C++ TCP transport
(``native/src/transport.cpp``); this module maps messages <-> bytes.
Little-endian throughout; float payloads are raw f32.

The allreduce payloads are torch tensors, on the card in a card worker.
Encoding a ``ScatterBlock`` or ``ReduceBlock`` copies its payload to
host bytes once, at send time (``value.detach().to("cpu",
torch.float32).numpy().tobytes()``: a device-to-host copy that
synchronizes on a CUDA tensor), so a chunk that views a buffer the
sender later refills still travels as it was when sent. Decoding
returns a CPU float32 tensor that owns its bytes; the receiving
worker's store moves it into its staging row on the worker's device.

Actor references travel as (host, port) listen addresses. Encoding asks
the caller to resolve a ref to its address; decoding asks the caller to
resolve an address back to a ref object — the TCP router interns refs
so identity checks in the engines (self-bypass, deathwatch) keep
working.

``resumable_to_frame`` / ``frame_to_resumable`` map the serving
engine's drained ``ResumableRequest`` to and from its ``ResumeFrame``.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from akka_allreduce_tpu_torch.buffers.base import as_payload
from akka_allreduce_tpu_torch.messages import (
    CompleteAllreduce,
    InitWorkers,
    ReduceBlock,
    ScatterBlock,
    StartAllreduce,
)

Addr = Tuple[str, int]

MSG_HELLO = 0
MSG_INIT = 1
MSG_START = 2
MSG_SCATTER = 3
MSG_REDUCE = 4
MSG_COMPLETE = 5
MSG_PING = 6
MSG_SUBMIT = 7
MSG_COMPLETION = 8
MSG_HEALTH = 9
MSG_DRAIN = 10
MSG_RESUME = 11
MSG_DRAIN_DONE = 12
MSG_CANCEL = 13

# The serving-frame wire format version. Bumped whenever any serving
# frame's layout changes (v2 added the version byte itself, the
# ``replica`` field on CompletionFrame, and the supervisor frames
# 9-13; v3 added CompletionFrame.waste — the cancelled-hedge-loser
# discard count the router's accounting was previously blind to — and
# HealthFrame.cancelled_tokens, its cumulative worker-side mirror;
# v4 added HealthFrame.checkpoint_version — the worker's self-reported
# weight provenance, the signal a rolling rollout's readmission gate
# requires before it re-ranks a restarted replica).
# Every serving frame carries this byte right after its message
# type, and decode refuses a mismatch with a readable error instead of
# mis-parsing a peer running different code — the failure mode of a
# rolling fleet upgrade where router and replica briefly disagree.
# The allreduce frames (0-6) predate versioning and stay unversioned:
# the training plane's processes are always launched as one build.
SERVING_WIRE_VERSION = 4

_SERVING_MSG_TYPES = frozenset({
    MSG_SUBMIT, MSG_COMPLETION, MSG_HEALTH, MSG_DRAIN, MSG_RESUME,
    MSG_DRAIN_DONE, MSG_CANCEL})


class WireError(ValueError):
    """A frame that cannot be decoded as what it claims to be. The TCP
    router treats this as a PEER failure (the sender is hostile,
    corrupt, or a different build), not a router bug — see
    protocol/tcp.py ``_drain_inbound``."""


class WireVersionError(WireError):
    """A serving frame carrying a different SERVING_WIRE_VERSION."""


class TruncatedFrame(WireError):
    """A frame shorter than its own header claims — a peer that died
    mid-write (the transport only delivers length-complete frames, so
    in practice this means the LENGTH was right but the payload counts
    inside it are hostile/corrupt)."""


def _need(buf: bytes, off: int, n: int, what: str) -> None:
    if off + n > len(buf):
        raise TruncatedFrame(
            f"frame truncated: need {n} byte(s) for {what} at offset "
            f"{off}, frame has {len(buf) - off} left (of {len(buf)})")


def _check_version(buf: bytes, off: int, mtype: int) -> int:
    _need(buf, off, 1, "serving wire version byte")
    (ver,) = struct.unpack_from("<B", buf, off)
    if ver != SERVING_WIRE_VERSION:
        raise WireVersionError(
            f"serving frame type {mtype} carries wire version {ver}, "
            f"this build speaks {SERVING_WIRE_VERSION} — router and "
            f"replica are different builds; redeploy them together")
    return off + 1


class Ping:
    """Transport-level heartbeat. Any inbound frame proves a peer alive;
    Ping exists so liveness holds even when the protocol is quiet. It is the
    failure-detector traffic behind the unreachable-after timeout
    (reference: application.conf:20 ``auto-down-unreachable-after = 10s`` —
    Akka's φ-detector pings members the same way). Carries the sender's
    heartbeat interval so the receiver's detector can widen its window for
    slow-pinging peers instead of falsely downing them (asymmetric
    deployments). Consumed by the router, never delivered to engines."""

    __slots__ = ("interval",)

    def __init__(self, interval: float = 0.0):
        self.interval = interval

    def __repr__(self) -> str:
        return f"Ping({self.interval})"


class Hello:
    """Transport-level greeting: the dialing process advertises its listen
    address and role, letting the receiver map the inbound connection to an
    addressable peer (the Akka-cluster MemberUp analogue,
    reference: AllreduceMaster.scala:36-44)."""

    def __init__(self, addr: Addr, role: str = "worker"):
        self.addr = addr
        self.role = role

    def __repr__(self) -> str:
        return f"Hello({self.addr}, {self.role!r})"


class SubmitFrame:
    """One serving request on the wire (the replicated serving plane,
    serving/router.py): a router dispatching to a SUBPROCESS replica
    sends this over the same tcp.py transport the allreduce protocol
    rides. Token ids travel as int32; optional fields (eos, deadline)
    use sentinel encoding (-1 / NaN-free: ``has_*`` flag bytes) so the
    frame stays fixed-layout and struct-parsable. ``attempts`` carries
    the retry ledger across the boundary — a failover re-dispatch must
    keep its budget, not reset it; ``seed`` carries the sampled
    stream's identity — a replica must reproduce the same
    per-request key schedule the router promised, so an explicit seed
    survives the wire (None stays None: the rid-derived default is
    already carried by rid)."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token",
                 "stop_tokens", "deadline", "attempts", "seed")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 eos_token: Optional[int] = None, stop_tokens=(),
                 deadline: Optional[float] = None, attempts: int = 0,
                 seed: Optional[int] = None):
        self.rid = rid
        self.prompt = tuple(int(t) for t in prompt)
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.stop_tokens = tuple(int(t) for t in stop_tokens)
        if len(self.stop_tokens) > 255:
            # the frame carries the stop count in one byte — far above
            # any engine's max_stop_tokens, but fail at construction
            # with a real message instead of struct.error at dispatch
            raise ValueError(
                f"SubmitFrame carries at most 255 stop tokens, got "
                f"{len(self.stop_tokens)}")
        self.deadline = deadline
        self.attempts = attempts
        self.seed = seed

    def __repr__(self) -> str:
        return (f"SubmitFrame(rid={self.rid}, "
                f"prompt_len={len(self.prompt)}, "
                f"max_new_tokens={self.max_new_tokens})")

    def __eq__(self, other) -> bool:
        return isinstance(other, SubmitFrame) and all(
            getattr(self, f) == getattr(other, f)
            for f in self.__slots__)


class CompletionFrame:
    """A replica's terminal answer for one dispatched request:
    generated tokens plus the finish reason (``eos``/``stop``/
    ``max_tokens``, or a failure status the router routes through its
    retry budget). The inverse direction of :class:`SubmitFrame`.

    ``replica`` identifies the SENDING replica (wire v2): all worker
    frames land on the supervisor's one inbound handler, and with
    hedged dispatch the same rid is legitimately in flight on two
    replicas — the router must unbind the copy that actually finished.
    -1 (the in-process default) means "caller knows the source".

    ``waste`` (wire v3) rides the ``reason="cancelled"`` acknowledgment
    a worker sends back for every CancelFrame: the decode tokens the
    worker's engine discarded for that rid. Before v3 a remote hedge
    loser's waste was charged 0 on the router side (it lived only in
    the worker's own counters) and the fleet's hedge-waste totals
    silently disagreed between ``--replica-mode inprocess`` and
    ``subprocess``; the ack makes the router-side ledger exact. 0 on
    every other reason."""

    __slots__ = ("rid", "tokens", "reason", "replica", "waste")

    def __init__(self, rid: int, tokens, reason: str,
                 replica: int = -1, waste: int = 0):
        self.rid = rid
        self.tokens = tuple(int(t) for t in tokens)
        if len(reason.encode()) > 255:
            # one length byte on the wire; reasons are short enum-like
            # strings — a longer one is a caller bug surfaced here,
            # not a struct.error at dispatch
            raise ValueError(
                f"CompletionFrame reason exceeds 255 bytes: {reason[:40]!r}...")
        if waste < 0:
            raise ValueError(f"waste must be >= 0, got {waste}")
        self.reason = reason
        self.replica = replica
        self.waste = waste

    def __repr__(self) -> str:
        return (f"CompletionFrame(rid={self.rid}, "
                f"tokens={len(self.tokens)}, reason={self.reason!r}, "
                f"replica={self.replica})")

    def __eq__(self, other) -> bool:
        return isinstance(other, CompletionFrame) and all(
            getattr(self, f) == getattr(other, f)
            for f in self.__slots__)


class HealthFrame:
    """A replica worker's periodic self-report: occupancy, cumulative
    decode dispatches (the LagLedger's progress signal over the wire),
    cumulative compiled-program count (the zero-recompile contract made
    observable across the process boundary), the engine triage
    counters the serve report renders per replica (watchdog trips,
    deadline evictions, distinct prefill programs — without them a
    subprocess fleet's report would show parent-side zeros exactly
    where OPERATIONS.md sends the operator), and the drain flag. Sent
    every worker loop tick; a SIGSTOPped worker stops sending, which IS
    the straggler signal — the router's lag ledger degrades it exactly
    as an in-process hung replica."""

    __slots__ = ("replica", "occupied", "free_slots", "dispatches",
                 "compiles", "draining", "watchdog_trips",
                 "evictions", "prefill_programs", "cancelled_tokens",
                 "checkpoint_version")

    def __init__(self, replica: int, occupied: int, free_slots: int,
                 dispatches: int, compiles: int = 0,
                 draining: bool = False, watchdog_trips: int = 0,
                 evictions: int = 0, prefill_programs: int = 0,
                 cancelled_tokens: int = 0,
                 checkpoint_version: int = 0):
        self.replica = replica
        self.occupied = occupied
        self.free_slots = free_slots
        self.dispatches = dispatches
        self.compiles = compiles
        self.draining = bool(draining)
        self.watchdog_trips = watchdog_trips
        self.evictions = evictions
        self.prefill_programs = prefill_programs
        # wire v3: cumulative decode tokens this worker's engine
        # discarded for CancelFrames — the supervisor-side triage
        # mirror of the per-cancel ``waste`` acks (OPERATIONS.md
        # "Hedging economics"; the two must reconcile)
        self.cancelled_tokens = cancelled_tokens
        # wire v4: which weights this worker is actually serving — the
        # checkpoint step it restored (0 = param-seed build). The
        # rollout readmission gate compares this against the target
        # version; trusting the parent-side spec alone would readmit a
        # worker that silently fell back to the wrong weights.
        self.checkpoint_version = checkpoint_version

    def __repr__(self) -> str:
        return (f"HealthFrame(replica={self.replica}, "
                f"occupied={self.occupied}, free={self.free_slots}, "
                f"dispatches={self.dispatches}, "
                f"compiles={self.compiles}, draining={self.draining})")

    def __eq__(self, other) -> bool:
        return isinstance(other, HealthFrame) and all(
            getattr(self, f) == getattr(other, f)
            for f in self.__slots__)


class DrainFrame:
    """Router -> replica: stop admitting, snapshot every in-flight
    request, ship the snapshots back (:class:`ResumeFrame`), finish
    with :class:`DrainDoneFrame`, exit. The wire form of the SIGTERM
    the supervisor also sends — either signal path converges on the
    worker's one drain routine."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "DrainFrame()"

    def __eq__(self, other) -> bool:
        return isinstance(other, DrainFrame)


class CancelFrame:
    """Router -> replica: free ``rid``'s slot (hedge loser after the
    winner landed). A completion the worker already sent for this rid
    may cross this frame on the wire — the router-side proxy filters
    completions for unbound rids, so the race is benign."""

    __slots__ = ("rid",)

    def __init__(self, rid: int):
        self.rid = rid

    def __repr__(self) -> str:
        return f"CancelFrame(rid={self.rid})"

    def __eq__(self, other) -> bool:
        return isinstance(other, CancelFrame) and self.rid == other.rid


class ResumeFrame:
    """A drained in-flight request crossing the process boundary —
    the JAX package's ``serving/engine.py`` ``ResumableRequest`` on the
    wire. Bidirectional: a draining worker ships its snapshots to the
    router (``replica`` = source), and the router restores a snapshot
    into a sibling/replacement worker (``replica`` = -1, target implied
    by the connection). ``generated`` is the decoded-so-far suffix the
    restore replays through prefill for bitwise continuation."""

    __slots__ = ("replica", "rid", "prompt", "max_new_tokens",
                 "eos_token", "stop_tokens", "deadline", "attempts",
                 "seed", "generated")

    def __init__(self, rid: int, prompt, max_new_tokens: int,
                 generated=(), eos_token: Optional[int] = None,
                 stop_tokens=(), deadline: Optional[float] = None,
                 attempts: int = 0, seed: Optional[int] = None,
                 replica: int = -1):
        self.rid = rid
        self.prompt = tuple(int(t) for t in prompt)
        self.max_new_tokens = max_new_tokens
        self.generated = tuple(int(t) for t in generated)
        self.eos_token = eos_token
        self.stop_tokens = tuple(int(t) for t in stop_tokens)
        if len(self.stop_tokens) > 255:
            raise ValueError(
                f"ResumeFrame carries at most 255 stop tokens, got "
                f"{len(self.stop_tokens)}")
        self.deadline = deadline
        self.attempts = attempts
        self.seed = seed
        self.replica = replica

    def __repr__(self) -> str:
        return (f"ResumeFrame(rid={self.rid}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.generated)}, "
                f"replica={self.replica})")

    def __eq__(self, other) -> bool:
        return isinstance(other, ResumeFrame) and all(
            getattr(self, f) == getattr(other, f)
            for f in self.__slots__)


class DrainDoneFrame:
    """Replica -> router: the drain finished; ``migrated`` snapshots
    were shipped (the router-side proxy reconciles the count against
    the ResumeFrames it actually received — a mismatch means frames
    were lost and the drain degrades to a failover)."""

    __slots__ = ("replica", "migrated")

    def __init__(self, replica: int, migrated: int):
        self.replica = replica
        self.migrated = migrated

    def __repr__(self) -> str:
        return (f"DrainDoneFrame(replica={self.replica}, "
                f"migrated={self.migrated})")

    def __eq__(self, other) -> bool:
        return isinstance(other, DrainDoneFrame) \
            and self.replica == other.replica \
            and self.migrated == other.migrated


def request_to_frame(req) -> SubmitFrame:
    """Map a serving :class:`~akka_allreduce_tpu_torch.serving.scheduler
    .Request` to its wire frame. Clock-domain fields (``arrival``,
    ``submitted_at``) deliberately do not travel: they are monotonic
    instants of the ROUTER's clock, meaningless to a replica process
    (same rule as the drain sidecar, serving/engine.py
    ``_req_from_json``). ``deadline`` does travel — the replica
    enforces mid-flight eviction locally — converted by the caller to
    a shared epoch if the hosts' clocks are not the same."""
    return SubmitFrame(rid=req.rid, prompt=req.prompt,
                       max_new_tokens=req.max_new_tokens,
                       eos_token=req.eos_token,
                       stop_tokens=req.stop_tokens or (),
                       deadline=req.deadline, attempts=req.attempts,
                       seed=req.seed)


def frame_to_request(frame: SubmitFrame):
    """The receiving replica's half of :func:`request_to_frame` —
    imported lazily so the protocol plane stays importable without the
    serving package."""
    from akka_allreduce_tpu_torch.serving.scheduler import Request
    return Request(rid=frame.rid, prompt=frame.prompt,
                   max_new_tokens=frame.max_new_tokens,
                   eos_token=frame.eos_token,
                   stop_tokens=frame.stop_tokens,
                   deadline=frame.deadline, attempts=frame.attempts,
                   seed=frame.seed)


def resumable_to_frame(rr, replica: int = -1) -> ResumeFrame:
    """Map a drained :class:`~akka_allreduce_tpu_torch.serving.engine
    .ResumableRequest` to its wire frame. Same clock-domain rule as
    :func:`request_to_frame`: the deadline field crosses the wire as
    whatever the caller put there."""
    req = rr.req
    return ResumeFrame(rid=req.rid, prompt=req.prompt,
                       max_new_tokens=req.max_new_tokens,
                       generated=rr.generated,
                       eos_token=req.eos_token,
                       stop_tokens=req.stop_tokens or (),
                       deadline=req.deadline, attempts=req.attempts,
                       seed=req.seed, replica=replica)


def frame_to_resumable(frame: ResumeFrame):
    """The restore-side half of :func:`resumable_to_frame`. ``slot`` is
    -1: a snapshot that crossed a process boundary has no slot until
    the receiving engine's admit assigns one."""
    from akka_allreduce_tpu_torch.serving.engine import ResumableRequest
    return ResumableRequest(req=frame_to_request(frame),
                            generated=frame.generated, slot=-1)


def _pack_addr(addr: Addr) -> bytes:
    host = addr[0].encode()
    return struct.pack("<H", len(host)) + host + struct.pack("<I", addr[1])


def _unpack_addr(buf: bytes, off: int) -> tuple[Addr, int]:
    (hlen,) = struct.unpack_from("<H", buf, off)
    off += 2
    host = buf[off:off + hlen].decode()
    off += hlen
    (port,) = struct.unpack_from("<I", buf, off)
    return (host, port), off + 4


def _payload_bytes(value) -> bytes:
    """A payload's little-endian f32 bytes: one device-to-host copy for
    a CUDA tensor (which waits for the tensor's producers), one host
    copy into the returned bytes."""
    return as_payload(value).detach().to(
        "cpu", torch.float32).numpy().tobytes()


def _payload_tensor(buf: bytes, off: int, nbytes: int) -> torch.Tensor:
    """The frame's f32 payload as a CPU tensor that owns its bytes."""
    return torch.from_numpy(np.frombuffer(
        buf, dtype=np.float32, count=nbytes // 4, offset=off).copy())


def encode(msg, addr_of: Callable[[object], Addr]) -> bytes:
    """Serialize a protocol message; ``addr_of(ref)`` resolves a ref to its
    listen address."""
    if isinstance(msg, Hello):
        role = msg.role.encode()
        return (struct.pack("<B", MSG_HELLO) + _pack_addr(msg.addr)
                + struct.pack("<B", len(role)) + role)
    if isinstance(msg, InitWorkers):
        out = [struct.pack("<BiIddIQQq", MSG_INIT, msg.dest_id,
                           msg.worker_num, msg.th_reduce, msg.th_complete,
                           msg.max_lag, msg.data_size, msg.max_chunk_size,
                           msg.start_round)]
        if msg.master is None:
            out.append(struct.pack("<B", 0))
        else:
            out.append(struct.pack("<B", 1))
            out.append(_pack_addr(addr_of(msg.master)))
        out.append(struct.pack("<I", len(msg.workers)))
        for rank, ref in sorted(msg.workers.items()):
            out.append(struct.pack("<i", rank))
            out.append(_pack_addr(addr_of(ref)))
        return b"".join(out)
    if isinstance(msg, StartAllreduce):
        return struct.pack("<Bq", MSG_START, msg.round)
    if isinstance(msg, ScatterBlock):
        payload = _payload_bytes(msg.value)
        return struct.pack("<BiiiqQ", MSG_SCATTER, msg.src_id, msg.dest_id,
                           msg.chunk_id, msg.round, len(payload)) + payload
    if isinstance(msg, ReduceBlock):
        payload = _payload_bytes(msg.value)
        return struct.pack("<BiiiqqQ", MSG_REDUCE, msg.src_id, msg.dest_id,
                           msg.chunk_id, msg.round, msg.count,
                           len(payload)) + payload
    if isinstance(msg, CompleteAllreduce):
        return struct.pack("<Biq", MSG_COMPLETE, msg.src_id, msg.round)
    if isinstance(msg, Ping):
        return struct.pack("<Bd", MSG_PING, msg.interval)
    if isinstance(msg, SubmitFrame):
        prompt = np.asarray(msg.prompt, dtype=np.int32).tobytes()
        stops = np.asarray(msg.stop_tokens, dtype=np.int32).tobytes()
        return (struct.pack(
            "<BBqIiBiBdIBq", MSG_SUBMIT, SERVING_WIRE_VERSION,
            msg.rid, msg.max_new_tokens,
            msg.eos_token if msg.eos_token is not None else -1,
            1 if msg.deadline is not None else 0,
            msg.attempts,
            len(msg.stop_tokens),
            msg.deadline if msg.deadline is not None else 0.0,
            len(msg.prompt),
            1 if msg.seed is not None else 0,
            msg.seed if msg.seed is not None else 0) + stops + prompt)
    if isinstance(msg, CompletionFrame):
        tokens = np.asarray(msg.tokens, dtype=np.int32).tobytes()
        reason = msg.reason.encode()
        return (struct.pack("<BBqiIBI", MSG_COMPLETION,
                            SERVING_WIRE_VERSION, msg.rid, msg.replica,
                            msg.waste,
                            len(reason), len(msg.tokens))
                + reason + tokens)
    if isinstance(msg, HealthFrame):
        return struct.pack("<BBiIIQQIIIQqB", MSG_HEALTH,
                           SERVING_WIRE_VERSION, msg.replica,
                           msg.occupied, msg.free_slots,
                           msg.dispatches, msg.compiles,
                           msg.watchdog_trips, msg.evictions,
                           msg.prefill_programs,
                           msg.cancelled_tokens,
                           msg.checkpoint_version,
                           1 if msg.draining else 0)
    if isinstance(msg, DrainFrame):
        return struct.pack("<BB", MSG_DRAIN, SERVING_WIRE_VERSION)
    if isinstance(msg, CancelFrame):
        return struct.pack("<BBq", MSG_CANCEL, SERVING_WIRE_VERSION,
                           msg.rid)
    if isinstance(msg, ResumeFrame):
        prompt = np.asarray(msg.prompt, dtype=np.int32).tobytes()
        stops = np.asarray(msg.stop_tokens, dtype=np.int32).tobytes()
        generated = np.asarray(msg.generated, dtype=np.int32).tobytes()
        return (struct.pack(
            "<BBiqIiBiBdIIBq", MSG_RESUME, SERVING_WIRE_VERSION,
            msg.replica, msg.rid, msg.max_new_tokens,
            msg.eos_token if msg.eos_token is not None else -1,
            1 if msg.deadline is not None else 0,
            msg.attempts,
            len(msg.stop_tokens),
            msg.deadline if msg.deadline is not None else 0.0,
            len(msg.prompt),
            len(msg.generated),
            1 if msg.seed is not None else 0,
            msg.seed if msg.seed is not None else 0)
            + stops + prompt + generated)
    if isinstance(msg, DrainDoneFrame):
        return struct.pack("<BBiI", MSG_DRAIN_DONE,
                           SERVING_WIRE_VERSION, msg.replica,
                           msg.migrated)
    raise TypeError(f"cannot encode {type(msg).__name__}")


def decode(buf: bytes, ref_of: Callable[[Addr], object]):
    """Deserialize one frame; ``ref_of(addr)`` resolves an address to a
    (possibly interned/local) ref object.

    EVERY malformed buffer surfaces as a :class:`WireError` subclass
    (which the TCP router converts to a peer failure), never as a
    struct/numpy/unicode exception from an arbitrary offset.  Serving
    frames (types 7-13) are version-checked and bounds-checked with
    readable messages; the containment wrapper below is the backstop
    for what explicit checks miss — a bit-flipped type byte landing in
    a training-plane branch, a corrupted length field, a reason string
    that stopped being UTF-8 (the codec-fuzz suite in
    tests/test_torch_protocol_wire.py drives all three)."""
    try:
        return _decode_impl(buf, ref_of)
    except WireError:
        raise
    except struct.error as exc:
        raise TruncatedFrame(f"frame too short for its layout "
                             f"({exc})") from exc
    except (ValueError, IndexError, OverflowError,
            UnicodeDecodeError) as exc:
        raise WireError(f"malformed frame "
                        f"({type(exc).__name__}: {exc})") from exc


def _decode_impl(buf: bytes, ref_of: Callable[[Addr], object]):
    _need(buf, 0, 1, "message type byte")
    (mtype,) = struct.unpack_from("<B", buf, 0)
    off = 1
    if mtype in _SERVING_MSG_TYPES:
        off = _check_version(buf, off, mtype)
    if mtype == MSG_HELLO:
        addr, off = _unpack_addr(buf, off)
        (rlen,) = struct.unpack_from("<B", buf, off)
        off += 1
        role = buf[off:off + rlen].decode()
        return Hello(addr, role)
    if mtype == MSG_INIT:
        (dest_id, worker_num, th_reduce, th_complete, max_lag, data_size,
         max_chunk_size, start_round) = struct.unpack_from("<iIddIQQq",
                                                           buf, off)
        off += struct.calcsize("<iIddIQQq")
        (has_master,) = struct.unpack_from("<B", buf, off)
        off += 1
        master: Optional[object] = None
        if has_master:
            maddr, off = _unpack_addr(buf, off)
            master = ref_of(maddr)
        (count,) = struct.unpack_from("<I", buf, off)
        off += 4
        workers = {}
        for _ in range(count):
            (rank,) = struct.unpack_from("<i", buf, off)
            off += 4
            addr, off = _unpack_addr(buf, off)
            workers[rank] = ref_of(addr)
        return InitWorkers(workers=workers, worker_num=worker_num,
                           master=master, dest_id=dest_id,
                           th_reduce=th_reduce, th_complete=th_complete,
                           max_lag=max_lag, data_size=data_size,
                           max_chunk_size=max_chunk_size,
                           start_round=start_round)
    if mtype == MSG_START:
        (round_,) = struct.unpack_from("<q", buf, off)
        return StartAllreduce(round_)
    if mtype == MSG_SCATTER:
        src, dest, chunk, round_, nbytes = struct.unpack_from("<iiiqQ", buf,
                                                              off)
        off += struct.calcsize("<iiiqQ")
        return ScatterBlock(_payload_tensor(buf, off, nbytes), src, dest,
                            chunk, round_)
    if mtype == MSG_REDUCE:
        src, dest, chunk, round_, count, nbytes = struct.unpack_from(
            "<iiiqqQ", buf, off)
        off += struct.calcsize("<iiiqqQ")
        return ReduceBlock(_payload_tensor(buf, off, nbytes), src, dest,
                           chunk, round_, count)
    if mtype == MSG_COMPLETE:
        src, round_ = struct.unpack_from("<iq", buf, off)
        return CompleteAllreduce(src, round_)
    if mtype == MSG_PING:
        (interval,) = struct.unpack_from("<d", buf, off)
        return Ping(interval)
    if mtype == MSG_SUBMIT:
        _need(buf, off, struct.calcsize("<qIiBiBdIBq"),
              "SubmitFrame header")
        (rid, max_new, eos, has_deadline, attempts, n_stops, deadline,
         n_prompt, has_seed, seed) = struct.unpack_from("<qIiBiBdIBq",
                                                        buf, off)
        off += struct.calcsize("<qIiBiBdIBq")
        _need(buf, off, 4 * n_stops + 4 * n_prompt,
              f"{n_stops} stop + {n_prompt} prompt tokens")
        stops = np.frombuffer(buf, dtype=np.int32, count=n_stops,
                              offset=off)
        off += 4 * n_stops
        prompt = np.frombuffer(buf, dtype=np.int32, count=n_prompt,
                               offset=off)
        return SubmitFrame(rid=rid, prompt=prompt,
                           max_new_tokens=max_new,
                           eos_token=None if eos < 0 else eos,
                           stop_tokens=stops,
                           deadline=deadline if has_deadline else None,
                           attempts=attempts,
                           seed=seed if has_seed else None)
    if mtype == MSG_COMPLETION:
        _need(buf, off, struct.calcsize("<qiIBI"),
              "CompletionFrame header")
        (rid, replica, waste, rlen,
         n_tokens) = struct.unpack_from("<qiIBI", buf, off)
        off += struct.calcsize("<qiIBI")
        _need(buf, off, rlen + 4 * n_tokens,
              f"{rlen}-byte reason + {n_tokens} tokens")
        reason = buf[off:off + rlen].decode()
        off += rlen
        tokens = np.frombuffer(buf, dtype=np.int32, count=n_tokens,
                               offset=off)
        return CompletionFrame(rid=rid, tokens=tokens, reason=reason,
                               replica=replica, waste=waste)
    if mtype == MSG_HEALTH:
        _need(buf, off, struct.calcsize("<iIIQQIIIQqB"),
              "HealthFrame body")
        (replica, occupied, free_slots, dispatches, compiles, trips,
         evictions, prefill_programs, cancelled_tokens,
         checkpoint_version,
         draining) = struct.unpack_from("<iIIQQIIIQqB", buf, off)
        return HealthFrame(replica=replica, occupied=occupied,
                           free_slots=free_slots,
                           dispatches=dispatches, compiles=compiles,
                           draining=bool(draining),
                           watchdog_trips=trips, evictions=evictions,
                           prefill_programs=prefill_programs,
                           cancelled_tokens=cancelled_tokens,
                           checkpoint_version=checkpoint_version)
    if mtype == MSG_DRAIN:
        return DrainFrame()
    if mtype == MSG_CANCEL:
        _need(buf, off, 8, "CancelFrame rid")
        (rid,) = struct.unpack_from("<q", buf, off)
        return CancelFrame(rid)
    if mtype == MSG_RESUME:
        _need(buf, off, struct.calcsize("<iqIiBiBdIIBq"),
              "ResumeFrame header")
        (replica, rid, max_new, eos, has_deadline, attempts, n_stops,
         deadline, n_prompt, n_generated, has_seed,
         seed) = struct.unpack_from("<iqIiBiBdIIBq", buf, off)
        off += struct.calcsize("<iqIiBiBdIIBq")
        _need(buf, off, 4 * (n_stops + n_prompt + n_generated),
              f"{n_stops} stop + {n_prompt} prompt + "
              f"{n_generated} generated tokens")
        stops = np.frombuffer(buf, dtype=np.int32, count=n_stops,
                              offset=off)
        off += 4 * n_stops
        prompt = np.frombuffer(buf, dtype=np.int32, count=n_prompt,
                               offset=off)
        off += 4 * n_prompt
        generated = np.frombuffer(buf, dtype=np.int32,
                                  count=n_generated, offset=off)
        return ResumeFrame(rid=rid, prompt=prompt,
                           max_new_tokens=max_new,
                           generated=generated,
                           eos_token=None if eos < 0 else eos,
                           stop_tokens=stops,
                           deadline=deadline if has_deadline else None,
                           attempts=attempts,
                           seed=seed if has_seed else None,
                           replica=replica)
    if mtype == MSG_DRAIN_DONE:
        _need(buf, off, struct.calcsize("<iI"), "DrainDoneFrame body")
        replica, migrated = struct.unpack_from("<iI", buf, off)
        return DrainDoneFrame(replica=replica, migrated=migrated)
    raise WireError(f"unknown message type {mtype}")
