"""The rank transport (``--dist-backend ipc``): RankGroup's payload
collectives device to device through CUDA IPC peer memory.

The JAX package's sync and ring attention run ``lax.all_to_all``,
``lax.all_gather`` and ``lax.ppermute`` on the device, over ICI. On the
gloo backend the port's counterparts stage every CUDA payload through the
host. Under ``ipc`` they move it from device memory to device memory
instead: :func:`all_to_all`, :func:`all_gather`, :func:`exchange` and
:func:`ppermute` take the place of ``RankGroup``'s staged wire for a CUDA
tensor. gloo keeps the control plane (process-group init, the axis
subgroups, barriers and the one-time handle exchange). The transport moves
bytes and never adds them, so every result is bitwise the gloo path's.

Layout. Every rank of a group (the world, or one axis line of the mesh)
owns one symmetric buffer of :func:`buffer_bytes`: a slot of two halves of
:data:`CHUNK_BYTES` for each of its n - 1 senders (:func:`slot_offset`),
then the counters (:func:`ready_offset`, :func:`consumed_offset`). A
payload streams through its pair's slot chunk by chunk
(:func:`chunk_ranges`); chunk g of a pair, counted over every call on the
buffer, lands in half g mod 2. :func:`rank_plan` is one rank's schedule
of a call: per chunk a push stretch (into each receiver's slot, raising
its ``ready``) and a pull stretch (out of this rank's slots, raising each
sender's ``consumed``), each preceded by stream waits on this rank's own
counters (:func:`ready_target`, :func:`consumed_target`). The push of
chunk c + 1 is enqueued before the pull of chunk c. :func:`emulate` runs
the plans of n simulated ranks on numpy bytes, in an interleaving drawn
from a seed, and checks that no half is overwritten before its receiver
copied it out; the CPU tests hold it bitwise against gloo ranks.

One chunk size for every buffer of a rank, :func:`chunk_bytes`: the
largest that lets two halves a sender of every buffer the rank may hold
(the world's and its two lines') fit in :data:`BUFFER_CAP_BYTES` (1 GiB),
at most :data:`CHUNK_BYTES` (64 MiB). Up to four ranks, a (2, 2) mesh
included (the world's 3 senders and each line's 1: 10 chunks, 640 MiB a
rank), every chunk is 64 MiB; a chunk moves in tens of microseconds at
the card's memory rate, so the two stream waits and two launches a chunk
cost a few percent. Larger meshes take smaller chunks (dp 4 x sp 2: 11
senders, 46.5 MiB; 32 ranks: 16.5 MiB); :data:`MAX_RANKS` is the limit.

``csrc/transport.cu`` is the device side (one copy kernel, the stretch;
the waits are stream memory operations), built on first use. Each call
is enqueued on the caller's current stream with no host sync inside it.
Stream waits cannot time out: each call records a start and an end
event; a watchdog thread (and :func:`wait`) abandons a buffer whose call
started and did not end within :data:`TIMEOUT_S` (queued stretches become
no-ops, every wait is freed, the stream drains). The next transport call
of the process, :func:`wait`, or :func:`close` (which ``spawn_ranks``'
ranks run before their buffers are freed, so a rank whose last call was
given up fails too) raises naming the counters.
:data:`TRANSPORT_LAUNCHES` counts the stretches launched, :func:`counts`
the calls, copies and bytes, :func:`stream_waits` the waits enqueued.

CUDA graphs. A chunk of train steps may be captured with its calls
(:func:`capture`): the waits and stretches then carry the targets of the
capture, counted from the host mirrors there. Before each replay every
rank drains its stream, meets the others, writes its own buffers'
``ready`` / ``consumed`` back to those values (:func:`rewind`) and meets
them again (``RankGroup.replay_boundary``), so every replay's targets
hold; :func:`replay` watches the replay as one call and counts its
calls, stretches, copies and waits. :func:`emulate_replays` runs that
sequence on numpy bytes.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from akka_allreduce_tpu_torch.ops.kernels import build
from akka_allreduce_tpu_torch.ops.kernels.ring import TIMEOUT_S, slot

CHUNK_BYTES = 64 << 20       # the largest chunk
CHUNK_ALIGN = 4096           # every chunk a multiple of it
BUFFER_CAP_BYTES = 1 << 30   # a rank's transport buffers together
COUNTER_BYTES = 1024         # the counters after a buffer's slots
MAX_RANKS = 32               # the kernel's row and signal tables
# the counters' u64 words: ready[MAX_RANKS - 1], consumed[MAX_RANKS - 1],
# then abandoned and ran
READY_WORD = 0
CONSUMED_WORD = MAX_RANKS - 1
ABANDONED_WORD = 2 * (MAX_RANKS - 1)
RAN_WORD = ABANDONED_WORD + 1
ABANDONED = 1 << 62          # what an abandon raises every counter to
COLLECTIVES = ("all_to_all", "all_gather", "exchange", "ppermute")
WATCH_INTERVAL_S = 0.05

# stretches (launches of transport_copy_kernel) since import, or since a
# caller reset them to 0
TRANSPORT_LAUNCHES = 0
_COUNTS = dict.fromkeys(("calls", "copies", "bytes"), 0)

_LIB: dict = {}


# -- layout: pure functions ------------------------------------------------

def chunk_bytes(sizes: list, cap: int = BUFFER_CAP_BYTES) -> int:
    """The chunk of every transport buffer of a rank that may hold a
    buffer for groups of each of ``sizes`` ranks (the world, and each
    axis line it is on): the largest multiple of :data:`CHUNK_ALIGN`, at
    most :data:`CHUNK_BYTES`, with which two halves a sender of every
    buffer, and their counters, fit in ``cap`` bytes."""
    senders = sum(n - 1 for n in sizes if n > 1)
    if not senders:
        return CHUNK_BYTES
    room = (cap - len(sizes) * COUNTER_BYTES) // (2 * senders)
    chunk = min(CHUNK_BYTES, room - room % CHUNK_ALIGN)
    if chunk < CHUNK_ALIGN:
        raise ValueError(f"groups of {list(sizes)} ranks leave no chunk in "
                         f"{cap} bytes of transport buffers a rank")
    return chunk


def chunk_count(nbytes: int, chunk: int = CHUNK_BYTES) -> int:
    """Chunks a payload of ``nbytes`` takes through a slot."""
    return -(-int(nbytes) // chunk)


def chunk_ranges(nbytes: int, chunk: int = CHUNK_BYTES) -> list:
    """The ``[lo, hi)`` byte range of every chunk; the last may be
    ragged."""
    return [(c * chunk, min((c + 1) * chunk, nbytes))
            for c in range(chunk_count(nbytes, chunk))]


def slot_offset(src: int, dst: int, n: int, g: int,
                chunk: int = CHUNK_BYTES) -> int:
    """Byte offset in ``dst``'s buffer of the half that ``src``'s chunk g
    (counted over every call on the buffer) lands in."""
    return (2 * slot(src, dst, n) + g % 2) * chunk


def counters_offset(n: int, chunk: int = CHUNK_BYTES) -> int:
    return 2 * (n - 1) * chunk


def buffer_bytes(n: int, chunk: int = CHUNK_BYTES) -> int:
    """One rank's buffer of a group of n: two halves a sender, then the
    counters."""
    return counters_offset(n, chunk) + COUNTER_BYTES


def ready_offset(src: int, dst: int, n: int, chunk: int = CHUNK_BYTES
                 ) -> int:
    """Byte offset in ``dst``'s buffer of ``ready`` for sender ``src``:
    the chunks ``src`` has pushed into ``dst``'s slots."""
    return counters_offset(n, chunk) + 8 * (READY_WORD + slot(src, dst, n))


def consumed_offset(dst: int, src: int, n: int, chunk: int = CHUNK_BYTES
                    ) -> int:
    """Byte offset in ``src``'s buffer of ``consumed`` for receiver
    ``dst``: the chunks of ``src``'s that ``dst`` has copied out."""
    return counters_offset(n, chunk) + 8 * (CONSUMED_WORD
                                            + slot(dst, src, n))


def ready_target(g: int) -> int:
    """``ready`` once chunk g of a pair has landed."""
    return g + 1


def consumed_target(g: int) -> int:
    """What ``consumed`` must reach before chunk g is pushed: chunk g - 2,
    the last one in the same half, copied out (0: no wait)."""
    return g - 1 if g >= 2 else 0


def routes(kind: str, me: int, n: int, nbytes: int, peer: int = 0,
           shift: int = 0) -> dict:
    """What a collective moves for rank ``me`` of n, over an input of
    ``nbytes``: ``sends`` [(peer, input offset)], ``recvs`` [(peer, output
    offset)], ``pair_bytes`` (the same for every pair), ``out_bytes``
    and ``local`` [(input offset, output offset, bytes)], copied on the
    rank itself."""
    if kind == "all_to_all":
        if nbytes % n:
            raise ValueError(f"all_to_all of {nbytes} bytes over {n} ranks")
        blk = nbytes // n
        others = [p for p in range(n) if p != me]
        return {"sends": [(p, p * blk) for p in others],
                "recvs": [(p, p * blk) for p in others],
                "pair_bytes": blk, "out_bytes": nbytes,
                "local": [(me * blk, me * blk, blk)]}
    if kind == "all_gather":
        others = [p for p in range(n) if p != me]
        return {"sends": [(p, 0) for p in others],
                "recvs": [(p, p * nbytes) for p in others],
                "pair_bytes": nbytes, "out_bytes": n * nbytes,
                "local": [(0, me * nbytes, nbytes)]}
    if kind == "exchange":
        if peer == me:
            raise ValueError("an exchange with itself moves nothing")
        return {"sends": [(peer, 0)], "recvs": [(peer, 0)],
                "pair_bytes": nbytes, "out_bytes": nbytes, "local": []}
    if kind == "ppermute":
        to, frm = (me + shift) % n, (me - shift) % n
        if to == me:
            raise ValueError("a ppermute by a multiple of n moves nothing")
        return {"sends": [(to, 0)], "recvs": [(frm, 0)],
                "pair_bytes": nbytes, "out_bytes": nbytes, "local": []}
    raise ValueError(f"unknown collective {kind!r}: {COLLECTIVES}")


def rank_plan(sends: list, recvs: list, pair_bytes: int, sent: dict,
              received: dict, chunk: int = CHUNK_BYTES) -> list:
    """One rank's ops for one call, in stream order. ``sends`` /
    ``recvs``: the peers it pushes to / pulls from; ``sent[p]`` /
    ``received[p]``: the chunks of each pair moved by earlier calls on
    the buffer. Ops:

    * ``("wait", "consumed", p, v)`` — until this rank's ``consumed`` for
      receiver p is >= v;
    * ``("wait", "ready", p, v)`` — until this rank's ``ready`` for
      sender p is >= v;
    * ``("push", c, ((p, g), ...))`` — one stretch: chunk c of the input
      into each receiver p's slot as pair chunk g, then p's ``ready``
      raised to g + 1;
    * ``("pull", c, ((p, g), ...))`` — one stretch: each sender p's pair
      chunk g out of this rank's slot into chunk c of the output, then
      p's ``consumed`` raised to g + 1.

    Push c + 1 comes before pull c."""
    count = chunk_count(pair_bytes, chunk)
    ops: list = []

    def push(c):
        for p in sends:
            if consumed_target(sent[p] + c):
                ops.append(("wait", "consumed", p,
                            consumed_target(sent[p] + c)))
        ops.append(("push", c, tuple((p, sent[p] + c) for p in sends)))

    def pull(c):
        for p in recvs:
            ops.append(("wait", "ready", p, ready_target(received[p] + c)))
        ops.append(("pull", c, tuple((p, received[p] + c) for p in recvs)))

    if count:
        push(0)
    for c in range(count):
        if c + 1 < count:
            push(c + 1)
        pull(c)
    return ops


class _Emulation:
    """One buffer of the transport's schedule for the n simulated ranks
    of a line, on numpy bytes: every rank's slots, the halves'
    occupants, the counters and the host mirrors (``sent``,
    ``received``) that :func:`rank_plan` reads."""

    def __init__(self, n: int, chunk: int):
        peers = max(n - 1, 1)
        self.n, self.chunk = n, chunk
        self.slots = [np.zeros((peers, 2, chunk), np.uint8) for _ in range(n)]
        self.held = [[[None, None] for _ in range(peers)] for _ in range(n)]
        self.ready = np.zeros((n, peers), np.int64)
        self.consumed = np.zeros((n, peers), np.int64)
        self.sent = [dict.fromkeys(range(n), 0) for _ in range(n)]
        self.received = [dict.fromkeys(range(n), 0) for _ in range(n)]

    def enqueue(self, kind: str, xs: list, kwargs: dict
                ) -> "tuple[list, list]":
        """Every rank's ops of one call in its stream order, as ``(self,
        rank, op, src, out, routes)`` (the host mirrors advance as the
        call is planned), and the n outputs it fills."""
        n, chunk = self.n, self.chunk
        streams: list = [[] for _ in range(n)]
        outs = []
        for r in range(n):
            x = np.ascontiguousarray(xs[r])
            src = x.reshape(-1).view(np.uint8)
            if (kind == "exchange" and kwargs["peers"][r] == r) or (
                    kind == "ppermute" and kwargs["shift"] % n == 0):
                outs.append((src.copy(), x.dtype, x.shape))  # no call
                continue
            rt = routes(kind, r, n, src.size,
                        peer=kwargs.get("peers", [0] * n)[r],
                        shift=kwargs.get("shift", 0))
            out = np.zeros(rt["out_bytes"], np.uint8)
            for a, b, nb in rt["local"]:
                out[b:b + nb] = src[a:a + nb]
            ops = rank_plan([p for p, _ in rt["sends"]],
                            [p for p, _ in rt["recvs"]],
                            rt["pair_bytes"], self.sent[r],
                            self.received[r], chunk)
            streams[r] += [(self, r, op, src, out, rt) for op in ops]
            for p, _ in rt["sends"]:
                self.sent[r][p] += chunk_count(rt["pair_bytes"], chunk)
            for p, _ in rt["recvs"]:
                self.received[r][p] += chunk_count(rt["pair_bytes"], chunk)
            shape = ((n * x.shape[0],) + x.shape[1:]
                     if kind == "all_gather" else x.shape)
            outs.append((out, x.dtype, shape))
        return streams, outs

    def runnable(self, r: int, op) -> bool:
        if op[0] != "wait":
            return True
        _, which, p, v = op
        table = self.ready if which == "ready" else self.consumed
        return table[r, slot(p, r, self.n)] >= v

    def run(self, r: int, op, src, out, rt) -> None:
        n, chunk = self.n, self.chunk
        kind, c = op[0], op[1]
        lo, hi = chunk_ranges(rt["pair_bytes"], chunk)[c]
        if kind == "push":
            offs = dict(rt["sends"])
            for p, g in op[2]:
                s, h = slot(r, p, n), g % 2
                assert self.held[p][s][h] is None, (
                    f"rank {r}'s chunk {g} overwrites rank {p}'s half {h}, "
                    f"still holding chunk {self.held[p][s][h]}")
                self.slots[p][s, h, :hi - lo] = src[offs[p] + lo:
                                                    offs[p] + hi]
                self.held[p][s][h] = g
                self.ready[p, s] = max(self.ready[p, s], ready_target(g))
        else:
            offs = dict(rt["recvs"])
            for p, g in op[2]:
                s, h = slot(p, r, n), g % 2
                assert self.held[r][s][h] == g, (
                    f"rank {r} pulls chunk {g} of rank {p} from half {h}, "
                    f"which holds {self.held[r][s][h]}")
                out[offs[p] + lo:offs[p] + hi] = self.slots[r][s, h,
                                                               :hi - lo]
                self.held[r][s][h] = None
                q = slot(r, p, n)
                self.consumed[p, q] = max(self.consumed[p, q], g + 1)

    def mirrors(self) -> tuple:
        """The host mirrors and counters, copied (a capture's base)."""
        return ([dict(d) for d in self.sent],
                [dict(d) for d in self.received], self.ready.copy(),
                self.consumed.copy())


class _Mesh:
    """The transport's buffers of ``n`` simulated ranks: one
    :class:`_Emulation` a line (the tuple of the global ranks of a group
    or of an axis line), made on first use."""

    def __init__(self, n: int, chunk: int):
        self.n, self.chunk = n, chunk
        self.wires: dict = {}

    def enqueue(self, calls: list) -> "tuple[list, list]":
        """Every rank's ops of ``calls`` in its stream order, and per call
        the n outputs they fill (global rank order). A call's
        ``kwargs["lines"]`` (default: the world) are the lines it runs
        on, each on its own buffer; ``peers`` of an exchange index a
        rank's own line."""
        streams: list = [[] for _ in range(self.n)]
        results = []
        for kind, xs, kwargs in calls:
            lines = kwargs.get("lines") or [tuple(range(self.n))]
            outs: list = [None] * self.n
            for line in map(tuple, lines):
                wire = self.wires.get(line)
                if wire is None:
                    wire = self.wires[line] = _Emulation(len(line),
                                                         self.chunk)
                kw = {k: v for k, v in kwargs.items() if k != "lines"}
                if "peers" in kw:
                    kw["peers"] = [kw["peers"][g] for g in line]
                sub, got = wire.enqueue(kind, [xs[g] for g in line], kw)
                for i, g in enumerate(line):
                    streams[g] += sub[i]
                    outs[g] = got[i]
            results.append(outs)
        return streams, results

    def drain(self, streams: list, rng) -> None:
        """Run every rank's ops: at each step one rank whose next op can
        run, drawn from ``rng``, runs it (a rank may run calls ahead of
        its peers). AssertionError on an overwritten half or a
        deadlock."""
        n = self.n
        pc = [0] * n
        while any(pc[r] < len(streams[r]) for r in range(n)):
            able = [r for r in range(n) if pc[r] < len(streams[r])
                    and streams[r][pc[r]][0].runnable(
                        streams[r][pc[r]][1], streams[r][pc[r]][2])]
            assert able, f"deadlock: every rank waits, at ops {pc}"
            r = able[rng.integers(len(able))]
            wire, local, op, src, out, rt = streams[r][pc[r]]
            if op[0] != "wait":
                wire.run(local, op, src, out, rt)
            pc[r] += 1


def _outputs(results: list) -> list:
    return [[out.view(dtype).reshape(shape) for out, dtype, shape in outs]
            for outs in results]


def emulate(calls: list, n: int, chunk: int, seed: int = 0) -> list:
    """Every rank's outputs of a sequence of collectives through the
    transport's schedule, on numpy bytes. ``calls``: ``(kind, xs,
    kwargs)`` with ``xs`` each rank's input (a contiguous numpy array;
    for ``exchange`` ``kwargs["peers"][r]`` is rank r's peer, for
    ``ppermute`` ``kwargs["shift"]``; ``kwargs["lines"]``, optional, the
    lines of global ranks the call runs on, each its own buffer, as an
    axis line's call does). Each rank's ops of every call run in its
    stream order; at each step one rank whose next op can run, drawn
    from ``seed``, runs it (a rank may run calls ahead of its peers).
    Raises AssertionError when a push would overwrite a half its
    receiver has not copied out, or when no rank can move (deadlock).
    Returns per call the n outputs (numpy arrays shaped as the
    group's)."""
    wire = _Mesh(n, chunk)
    streams, results = wire.enqueue(calls)
    wire.drain(streams, np.random.default_rng(seed))
    return _outputs(results)


def emulate_replays(replays: list, n: int, chunk: int, seed: int = 0,
                    warmup: tuple = (), rewind: bool = True
                    ) -> "tuple[list, list]":
    """A captured chunk of calls replayed ``len(replays)`` times, as
    :func:`capture` and ``RankGroup.replay_boundary`` run it, on numpy
    bytes. ``warmup`` (calls as :func:`emulate` takes them, lines
    included) runs first, eagerly; then the chunk's plan is made once
    from every buffer's host mirrors there (the capture: every replay
    runs those ops with those targets) and ``replays[k]`` gives replay
    k's inputs, the same calls and sizes each time (a graph's buffers
    are fixed; only their contents change). Each replay runs until every
    rank has drained (the stream sync and the barrier), then, with
    ``rewind``, every rank's ``ready`` and ``consumed`` of every buffer
    go back to their values at the capture. Without the rewind the
    second replay's waits are already met and it fails: AssertionError
    (a half overwritten or pulled before its push) or a wrong output.
    Returns ``(warmup outputs, per replay the outputs)``."""
    mesh = _Mesh(n, chunk)
    rng = np.random.default_rng(seed)
    streams, results = mesh.enqueue(list(warmup))
    mesh.drain(streams, rng)
    warm = _outputs(results)
    base = {line: w.mirrors() for line, w in mesh.wires.items()}
    shapes = None
    out = []
    for k, calls in enumerate(replays):
        got = [(kind, [np.asarray(x).nbytes for x in xs],
                sorted(kwargs.items(), key=str))
               for kind, xs, kwargs in calls]
        if shapes is None:
            shapes = got
        elif got != shapes:
            raise ValueError(f"replay {k} makes other calls than the "
                             f"captured chunk: {got} != {shapes}")
        # every replay runs the captured plan: the mirrors at the capture
        # (a buffer the warm-up did not reach starts from zero)
        for line, w in mesh.wires.items():
            sent, received, ready, consumed = base.setdefault(
                line, w.mirrors())
            w.sent = [dict(d) for d in sent]
            w.received = [dict(d) for d in received]
            if k and rewind:
                w.ready[:], w.consumed[:] = ready, consumed
        streams, results = mesh.enqueue(calls)
        if not k:
            for line, w in mesh.wires.items():
                if line not in base:  # made by the capture's calls
                    zero = _Emulation(w.n, chunk)
                    base[line] = zero.mirrors()
        mesh.drain(streams, rng)
        out.append(_outputs(results))
    return warm, out


# -- the library -------------------------------------------------------------

def _lib() -> dict:
    if not _LIB:
        lib = build.load("transport")
        err = lib.transport_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.transport_init.restype = ctypes.c_int
        rc = lib.transport_init()
        if rc != 0:
            raise RuntimeError(f"the ipc transport cannot run here: "
                               f"{err(rc).decode()} ({rc})")
        table, u64 = ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64
        ptr = ctypes.c_void_p
        lib.transport_counter_bytes.restype = ctypes.c_int64
        lib.transport_max_ranks.restype = ctypes.c_int
        assert lib.transport_counter_bytes() == COUNTER_BYTES
        assert lib.transport_max_ranks() == MAX_RANKS
        for name, args in (("transport_copy", [table, ctypes.c_int, table,
                                               ctypes.c_int, ptr, ptr]),
                           ("transport_wait", [ptr, ptr, u64]),
                           ("transport_read", [ptr, table]),
                           ("transport_abandon", [ptr, u64]),
                           ("transport_rewind", [ptr, table, table,
                                                 ctypes.c_int])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _LIB[name.removeprefix("transport_")] = fn
        lib.transport_stream_waits.restype = u64
        lib.transport_add_waits.argtypes = [ctypes.c_int64]
        lib.transport_add_waits.restype = None
        _LIB.update(error=err, waits=lib.transport_stream_waits,
                    add_waits=lib.transport_add_waits)
    return _LIB


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{_lib()['error'](rc).decode()} ({rc})")


def _table(values: list):
    return (ctypes.c_uint64 * max(1, len(values)))(*values)


def counts() -> dict:
    """Transport calls, the stretches they launched, the peer copies (one
    per peer and chunk) and local copies they enqueued, and the payload
    bytes received over peer memory."""
    return {"transport_calls": _COUNTS["calls"],
            "transport_launches": TRANSPORT_LAUNCHES,
            "transport_copies": _COUNTS["copies"],
            "transport_bytes": _COUNTS["bytes"]}


def stream_waits() -> int:
    """Stream waits the transport's calls enqueued in this process; 0
    before the first call."""
    return int(_LIB["waits"]()) if _LIB else 0


def reset_counts() -> None:
    global TRANSPORT_LAUNCHES
    TRANSPORT_LAUNCHES = 0
    for k in _COUNTS:
        _COUNTS[k] = 0


# -- calls -------------------------------------------------------------------

@dataclasses.dataclass
class _Pending:
    """One call in flight on a buffer: its start and end events, what it
    waits for (``(which, peer, target)``: the last of each), and when the
    host first saw it started."""

    start: torch.cuda.Event
    end: torch.cuda.Event
    call: int
    what: str
    waits: list
    started_at: Optional[float] = None


@dataclasses.dataclass
class _Line:
    """The transport's state of one buffer (``bufs``, a group's or a
    line's peer buffers): its ``chunk``, the chunks each pair has moved
    by line index (``sent``, ``received``), its calls in flight
    (``pending``), and once a call was given up, why (``error``) and
    whether that was raised to the caller (``reported``)."""

    bufs: object
    chunk: int
    sent: dict
    received: dict
    pending: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    error: Optional[str] = None
    reported: bool = False


# the global ranks of a buffer's group -> its _Line, for this process;
# read and changed under _WATCH["lock"] (the watchdog thread reads it)
_LINES: dict = {}


def _counter_values(rec: _Line) -> list:
    """This rank's counter words (ready, consumed, abandoned, ran), read
    on a side stream into pinned memory."""
    values = (ctypes.c_uint64 * (RAN_WORD + 1))()
    _check_rc(_lib()["read"](rec.bufs.local + counters_offset(
        len(rec.bufs.line), rec.chunk), values),
        "reading the transport's counters")
    return list(values)


def _stalled(rec: _Line, timeout: float) -> Optional[str]:
    """Drop the buffer's calls that ended; when the oldest one left
    started more than ``timeout`` seconds ago (as first seen here),
    abandon the buffer and return the error (kept in ``rec.error``)."""
    while rec.pending and rec.pending[0].end.query():
        rec.pending.popleft()
    if rec.error or not rec.pending:
        return rec.error
    head = rec.pending[0]
    now = time.monotonic()
    if head.started_at is None:
        if head.start.query():
            head.started_at = now
        return None
    if now - head.started_at <= timeout:
        return None
    bufs = rec.bufs
    n, me = len(bufs.line), bufs.line.index(bufs.rank)
    words = _counter_values(rec)
    base = {"ready": READY_WORD, "consumed": CONSUMED_WORD}
    seen = ", ".join(
        f"{which} {'from' if which == 'ready' else 'by'} rank "
        f"{bufs.line[p]} = {words[base[which] + slot(p, me, n)]} "
        f"(needs >= {target})" for which, p, target in head.waits)
    _check_rc(_lib()["abandon"](bufs.local + counters_offset(n, rec.chunk),
                                ABANDONED),
              "abandoning the transport's calls")
    bufs.abandoned = True
    rec.error = (
        f"ipc transport: rank {bufs.rank}'s {head.what} (call {head.call} "
        f"on the buffer of ranks {bufs.line}) did not end within "
        f"{timeout:g} s of its start: {seen or 'no wait'}; the ranks made "
        f"different calls, or a peer stopped. The buffer's calls were "
        f"abandoned; it takes no more calls")
    return rec.error


def _raise(rec: _Line) -> None:
    rec.reported = True
    raise RuntimeError(rec.error)


# "paused" while a CUDA graph captures calls: the thread touches no CUDA
# then (another thread's event query would break the capture)
_WATCH: dict = {"lock": threading.Lock(), "thread": None, "stop": None,
                "paused": False}


def _watch(stop: threading.Event, device: torch.device) -> None:
    torch.cuda.set_device(device)
    while not stop.wait(WATCH_INTERVAL_S):
        with _WATCH["lock"]:
            if _WATCH["paused"]:
                continue
            for rec in _LINES.values():
                _stalled(rec, TIMEOUT_S)


def _start_watchdog(device: torch.device) -> None:
    if _WATCH["thread"] is None:
        stop = threading.Event()
        thread = threading.Thread(target=_watch, args=(stop, device),
                                  name="ipc-transport-watchdog", daemon=True)
        _WATCH.update(thread=thread, stop=stop)
        thread.start()


def stop_watchdog() -> None:
    """End this process's watchdog thread."""
    if _WATCH["thread"] is not None:
        _WATCH["stop"].set()
        _WATCH["thread"].join()
        _WATCH.update(thread=None, stop=None)


def wait(group=None, timeout: Optional[float] = None) -> None:
    """Block until every transport call of this process has ended on the
    card. A call that started and did not end within ``timeout`` seconds
    (default :data:`TIMEOUT_S`) abandons its buffer (its stream drains)
    and raises ``RuntimeError`` naming the counters it waits on; so does
    a call the watchdog gave up that was not raised yet. ``group`` is
    accepted for symmetry with ``ring.wait``."""
    timeout = TIMEOUT_S if timeout is None else timeout
    while True:
        with _WATCH["lock"]:
            for rec in _LINES.values():
                if _stalled(rec, timeout) and not rec.reported:
                    _raise(rec)
            if not any(rec.pending for rec in _LINES.values()
                       if not rec.error):
                return
        time.sleep(1e-4)


def close() -> None:
    """Before this process's buffers are freed (``free_peer_buffers``):
    :func:`wait` for every call, raising for one that was given up and
    not raised yet, then end the watchdog and drop the buffers' state."""
    try:
        wait()
    finally:
        stop_watchdog()
        with _WATCH["lock"]:
            _LINES.clear()


def _check_tensor(x: torch.Tensor, group) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(
            f"the ipc transport moves CUDA tensors device to device; got "
            f"a tensor on {x.device}. Ranks on the CPU use --dist-backend "
            f"gloo")
    if x.device != group.device:
        raise ValueError(f"the tensor is on {x.device}, the rank's device "
                         f"is {group.device}")
    return x.contiguous()


def _line(group, axis: Optional[str]) -> _Line:
    """The state of the buffer of ``group`` (``axis`` None) or of this
    rank's line along ``axis``, its buffers made on first use (under
    the lock; a gloo collective over the line)."""
    from akka_allreduce_tpu_torch.parallel.group import transport_sizes
    chunk = chunk_bytes(transport_sizes())
    if _CAPTURE["active"] is not None and group._ranks(axis) not in _LINES:
        raise RuntimeError(
            f"a CUDA graph capture reached the ipc transport buffer of "
            f"ranks {group._ranks(axis)}, which no eager call made: run "
            f"the captured work once eagerly first")
    bufs = group.transport_buffers(axis, chunk)
    rec = _LINES.get(bufs.line)
    if rec is None:
        zeros = dict.fromkeys(range(len(bufs.line)), 0)
        rec = _LINES[bufs.line] = _Line(bufs, chunk, dict(zeros),
                                        dict(zeros))
    return rec


def _run(group, axis: Optional[str], kind: str, x: torch.Tensor,
         out_shape: tuple, **kw) -> torch.Tensor:
    """One collective through the line's buffers, enqueued on the current
    stream."""
    x = _check_tensor(x, group)
    _lib()
    _start_watchdog(x.device)
    with _WATCH["lock"]:  # the watchdog cannot abandon the buffer midway
        rec = _line(group, axis)
        if rec.error:
            _raise(rec)
        for other in _LINES.values():
            if other.error and not other.reported:
                _raise(other)
        return _enqueue(rec, kind, x, out_shape, kw)


def _enqueue(rec: _Line, kind: str, x: torch.Tensor, out_shape: tuple,
             kw: dict) -> torch.Tensor:
    global TRANSPORT_LAUNCHES
    fns, bufs, chunk = _lib(), rec.bufs, rec.chunk
    n, me = len(bufs.line), bufs.line.index(bufs.rank)
    src = x.reshape(-1).view(torch.uint8)
    rt = routes(kind, me, n, src.numel(), **kw)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    dst = out.reshape(-1).view(torch.uint8)
    base = [bufs.local if q == me else bufs.peers[bufs.line[q]]
            for q in range(n)]
    counters = bufs.local + counters_offset(n, chunk)
    stream = torch.cuda.current_stream(x.device)
    ops = rank_plan([p for p, _ in rt["sends"]], [p for p, _ in rt["recvs"]],
                    rt["pair_bytes"], rec.sent, rec.received, chunk)
    send_off, recv_off = dict(rt["sends"]), dict(rt["recvs"])
    chunks = chunk_ranges(rt["pair_bytes"], chunk)
    captured = _CAPTURE["active"]
    if torch.cuda.is_current_stream_capturing() and captured is None:
        raise RuntimeError("a CUDA graph captures ipc transport calls only "
                           "inside transport.capture()")
    if captured is None:
        if bufs.done is not None:  # the buffer's calls stay in order
            stream.wait_event(bufs.done)
        start = torch.cuda.Event()
        start.record(stream)
    for a, b, nb in rt["local"]:
        dst[b:b + nb].copy_(src[a:a + nb])
        _COUNTS["copies"] += 1
    sp, dp = src.data_ptr(), dst.data_ptr()
    last_waits: dict = {}
    with torch.cuda.device(x.device):
        for op in ops:
            if op[0] == "wait":
                _, which, p, v = op
                word = READY_WORD if which == "ready" else CONSUMED_WORD
                _check_rc(fns["wait"](stream.cuda_stream,
                                      counters + 8 * (word + slot(p, me, n)),
                                      v), f"ipc transport {kind} wait")
                last_waits[which, p] = v
                continue
            lo, hi = chunks[op[1]]
            rows, sigs = [], []
            for p, g in op[2]:
                if op[0] == "push":
                    rows += [sp + send_off[p] + lo,
                             base[p] + slot_offset(me, p, n, g, chunk),
                             hi - lo]
                    sigs += [base[p] + ready_offset(me, p, n, chunk),
                             ready_target(g)]
                else:
                    rows += [base[me] + slot_offset(p, me, n, g, chunk),
                             dp + recv_off[p] + lo, hi - lo]
                    sigs += [base[p] + consumed_offset(me, p, n, chunk),
                             g + 1]
            _check_rc(fns["copy"](_table(rows), len(op[2]), _table(sigs),
                                  len(op[2]), counters, stream.cuda_stream),
                      f"ipc transport {kind} copy")
            TRANSPORT_LAUNCHES += 1
            _COUNTS["copies"] += len(op[2])
    for p, _ in rt["sends"]:
        rec.sent[p] += len(chunks)
    for p, _ in rt["recvs"]:
        rec.received[p] += len(chunks)
    waits = [(which, p, v) for (which, p), v in sorted(last_waits.items())]
    if captured is not None:
        # the graph's calls are watched as one, around each replay
        captured.calls[bufs.line] = captured.calls.get(bufs.line, 0) + 1
        captured.line_waits[bufs.line] = captured.line_waits.get(
            bufs.line, 0) + sum(1 for op in ops if op[0] == "wait")
        if waits:
            captured.waits[bufs.line] = waits
    else:
        end = torch.cuda.Event()
        end.record(stream)
        bufs.done = end
        bufs.calls += 1
        rec.pending.append(_Pending(start, end, bufs.calls, kind, waits))
    _COUNTS["calls"] += 1
    _COUNTS["bytes"] += rt["pair_bytes"] * len(rt["recvs"])
    return out


# -- CUDA graph capture ------------------------------------------------------

@dataclasses.dataclass
class Captured:
    """The transport calls that one CUDA graph captured, on this rank:
    per buffer (keyed by its line's global ranks) the host mirrors at the
    capture's start (``base``, what a replay's targets count from) and
    end (``end``), its calls, the stream waits it enqueued
    (``line_waits``) and the last wait of each counter it waits on, and
    what one replay adds to :func:`counts` and :func:`stream_waits`
    (``per_replay``)."""

    base: dict
    end: dict = dataclasses.field(default_factory=dict)
    calls: dict = dataclasses.field(default_factory=dict)
    line_waits: dict = dataclasses.field(default_factory=dict)
    waits: dict = dataclasses.field(default_factory=dict)
    per_replay: dict = dataclasses.field(default_factory=dict)

    @property
    def stream_waits(self) -> int:
        return self.per_replay.get("stream_waits", 0)

    def by_line(self) -> dict:
        """A replay's calls and stream waits on each buffer, keyed by its
        line's global ranks joined with commas."""
        return {",".join(map(str, line)): {
            "calls": k, "stream_waits": self.line_waits.get(line, 0)}
            for line, k in sorted(self.calls.items())}


_CAPTURE: dict = {"active": None}


def _totals() -> dict:
    return {**counts(), "stream_waits": stream_waits()}


def _add_counts(delta: dict, sign: int) -> None:
    global TRANSPORT_LAUNCHES
    TRANSPORT_LAUNCHES += sign * delta["transport_launches"]
    for k in _COUNTS:
        _COUNTS[k] += sign * delta[f"transport_{k}"]
    if delta["stream_waits"]:
        _lib()["add_waits"](sign * delta["stream_waits"])


@contextlib.contextmanager
def capture():
    """Around the capture of a CUDA graph whose work makes transport calls
    (``torch.cuda.graph``): yields the :class:`Captured` record. The
    buffers must exist already (an eager call made them). Inside, a call
    records no watch event and waits on no event recorded outside the
    capture, and the watchdog thread touches no CUDA. A capture enqueues
    nothing, so at its end the host mirrors go back to their values at
    its start and the counts lose what the capture added; each
    :func:`replay` adds them back. Between replays every rank runs
    ``RankGroup.replay_boundary`` (the stream drained, a barrier,
    :func:`rewind`, a barrier): the captured targets then hold on every
    replay."""
    if _CAPTURE["active"] is not None:
        raise RuntimeError("one transport capture at a time")
    with _WATCH["lock"]:
        _WATCH["paused"] = True
        for rec in _LINES.values():
            if rec.error:
                _raise(rec)
        rec0 = Captured(base={line: (dict(rec.sent), dict(rec.received))
                              for line, rec in _LINES.items()})
    before = _totals()
    _CAPTURE["active"] = rec0
    try:
        yield rec0
    finally:
        _CAPTURE["active"] = None
        after = _totals()
        rec0.per_replay = {k: after[k] - before[k] for k in after}
        _add_counts(rec0.per_replay, -1)
        with _WATCH["lock"]:
            for line, (sent, received) in rec0.base.items():
                rec = _LINES[line]
                rec0.end[line] = (dict(rec.sent), dict(rec.received))
                rec.sent, rec.received = dict(sent), dict(received)
            _WATCH["paused"] = False


def rewind(captured: Captured) -> None:
    """Write this rank's ``ready`` and ``consumed`` words of every buffer
    the chunk used back to their values at its capture (the chunks each
    peer had pushed here and copied out of here). Only between replays:
    every rank's previous replay has ended (``RankGroup.replay_boundary``
    holds the ranks around it)."""
    fns = _lib()
    with _WATCH["lock"]:
        for line in captured.calls:
            rec = _LINES[line]
            if rec.error:
                _raise(rec)
            sent, received = captured.base[line]
            n, me = len(line), line.index(rec.bufs.rank)
            ready, consumed = [0] * (n - 1), [0] * (n - 1)
            for p in range(n):
                if p != me:
                    ready[slot(p, me, n)] = received[p]
                    consumed[slot(p, me, n)] = sent[p]
            _check_rc(fns["rewind"](rec.bufs.local + counters_offset(
                n, rec.chunk), _table(ready), _table(consumed), n - 1),
                "rewinding the transport's counters")


def replay(captured: Captured, launch) -> None:
    """``launch()`` (a captured graph's replay) on the current stream,
    watched as one call on each buffer the chunk used: events recorded
    around it outside the capture; a replay that started and did not end
    within :data:`TIMEOUT_S` abandons the buffer, and the next call
    raises. The host mirrors become the capture's end values and the
    counts gain one replay's worth."""
    device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(device)
    _start_watchdog(device)
    with _WATCH["lock"]:
        for line in captured.calls:
            if _LINES[line].error:
                _raise(_LINES[line])
    start = torch.cuda.Event()
    start.record(stream)
    launch()
    end = torch.cuda.Event()
    end.record(stream)
    with _WATCH["lock"]:
        for line, k in captured.calls.items():
            rec = _LINES[line]
            sent, received = captured.end[line]
            rec.sent, rec.received = dict(sent), dict(received)
            rec.bufs.done = end
            rec.bufs.calls += k
            rec.pending.append(_Pending(
                start, end, rec.bufs.calls,
                f"replay of a captured chunk ({k} calls)",
                captured.waits.get(line, [])))
    _add_counts(captured.per_replay, 1)


def all_to_all(group, x: torch.Tensor) -> torch.Tensor:
    """``RankGroup.all_to_all`` on the transport: block p of ``x`` (world,
    ...) goes to rank p."""
    return _run(group, None, "all_to_all", x, tuple(x.shape))


def all_gather(group, x: torch.Tensor) -> torch.Tensor:
    """``RankGroup.all_gather`` on the transport: every rank's ``x``
    concatenated along axis 0, in rank order."""
    return _run(group, None, "all_gather", x,
                (group.world * x.shape[0],) + tuple(x.shape[1:]))


def exchange(group, x: torch.Tensor, peer: int) -> torch.Tensor:
    """``RankGroup.exchange`` on the transport: send ``x`` to ``peer`` (a
    rank of ``group``) and return what it sent here."""
    return _run(group, None, "exchange", x, tuple(x.shape), peer=peer)


def ppermute(group, x: torch.Tensor, axis: str, shift: int
             ) -> torch.Tensor:
    """``RankGroup.ppermute`` on the transport, through the buffers of
    this rank's line along ``axis``."""
    return _run(group, axis, "ppermute", x, tuple(x.shape), shift=shift)
