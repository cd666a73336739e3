"""Peer-memory ring and swing allreduce: the plain versions and the kernels.

The counterpart of ``akka_allreduce_tpu/ops/pallas_kernels/ring.py``.
Both functions are rank-local: every rank of a
:class:`~akka_allreduce_tpu_torch.parallel.group.RankGroup` calls them, in
the same order, with its own flat f32 vector, and gets the sum over the
ranks along ``axis``, as the JAX functions do inside ``shard_map``:

* :func:`peer_ring_allreduce` — the sum in the add order of the ring's
  reduce-scatter (``_ring_kernel``): ring block b is
  ``((x_b + x_{b+1}) + ...) + x_{b-1}``, rank indices mod n.
* :func:`peer_swing_allreduce` — the sum in the add order of log2(n)
  exchanges with the XOR partner (``_swing_kernel``): the balanced tree
  ``((x0 + x1) + (x2 + x3)) + ...``.

A CPU tensor goes to the plain versions, :func:`ring_allreduce_reference`
and :func:`swing_allreduce_reference`: the TPU schedules, in the same add
order, over the group's ``ppermute`` and ``exchange``, so they are bitwise
the JAX kernels run in interpret mode. A CUDA tensor launches
``csrc/ring_allreduce.cu`` or raises. The kernels keep each add order but
not the TPU's data movement (f32 addition commutes bitwise): the owner of
each block gathers the n contributions through peer memory (CUDA IPC,
``RankGroup.peer_buffers``), sums them in the schedule's order and sends
the sum back, so one schedule of three kernels and two cross-rank waits
serves both add orders at every n. :func:`schedule_emulation` is that
schedule in plain torch over explicit per-rank buffers, laid out by the
same functions the wrapper resolves its addresses from.

The waits are stream waits, which cannot time out. :func:`wait` is the
host's guard: it polls the last call's end event and, past its deadline,
abandons the call (its stream drains) and raises, naming the counters.
:data:`RING_ALLREDUCE_LAUNCHES` and :data:`SWING_ALLREDUCE_LAUNCHES`
count calls that launched; :func:`kernels_run` counts the kernels that
ran on the card and :func:`stream_waits` the waits enqueued.
"""

from __future__ import annotations

import ctypes
import time

import torch

from akka_allreduce_tpu_torch.ops.collectives import (_check_power_of_two,
                                                      swing_allreduce)
from akka_allreduce_tpu_torch.ops.kernels import build

LANE = 128
TIMEOUT_S = 30.0         # wait()'s default deadline for one call
MAX_RANKS = 32           # the kernels' pointer tables
# a call's kernels (push, reduce, gather) and cross-rank stream waits
# (after the push, after the reduce); chip_smoke.py's phase 14 holds
# kernels_run() and stream_waits() against them
KERNELS_PER_CALL = 3
WAITS_PER_CALL = 2
COUNTER_BYTES = 128      # the counters at the end of a buffer
SCHEDULES = ("ring", "swing")

# calls that launched the kernels since import (or since a caller reset
# them to 0); the plain versions never count
RING_ALLREDUCE_LAUNCHES = 0
SWING_ALLREDUCE_LAUNCHES = 0

_LAUNCH: dict = {}  # the bound C entry points, set at first launch


def _launchers() -> dict:
    if not _LAUNCH:
        lib = build.load("ring_allreduce")
        err = lib.peer_allreduce_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.peer_allreduce_init.restype = ctypes.c_int
        rc = lib.peer_allreduce_init()
        if rc != 0:
            raise RuntimeError(f"the peer allreduce cannot run here: "
                               f"{err(rc).decode()} ({rc})")
        table, u64 = ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64
        launch = lib.peer_allreduce_launch
        # push, gather, sources, dests, n, n4, swing_log, counters, call,
        # stream
        launch.argtypes = ([table] * 4 + [ctypes.c_int, ctypes.c_int64,
                                          ctypes.c_int, table, u64,
                                          ctypes.c_void_p])
        launch.restype = ctypes.c_int
        lib.peer_allreduce_counter_bytes.restype = ctypes.c_int64
        lib.peer_allreduce_max_ranks.restype = ctypes.c_int
        assert lib.peer_allreduce_counter_bytes() == COUNTER_BYTES
        assert lib.peer_allreduce_max_ranks() == MAX_RANKS
        read = lib.peer_allreduce_read_counters
        read.argtypes = [ctypes.c_void_p, table]
        read.restype = ctypes.c_int
        abandon = lib.peer_allreduce_abandon
        abandon.argtypes = [ctypes.c_void_p, u64]
        abandon.restype = ctypes.c_int
        lib.peer_allreduce_stream_waits.restype = u64
        _LAUNCH.update(launch=launch, error=err, read=read, abandon=abandon,
                       waits=lib.peer_allreduce_stream_waits)
    return _LAUNCH


def counts() -> dict:
    return {"ring_allreduce": RING_ALLREDUCE_LAUNCHES,
            "swing_allreduce": SWING_ALLREDUCE_LAUNCHES}


def stream_waits() -> int:
    """Cross-rank stream waits the kernels' calls enqueued in this
    process (:data:`WAITS_PER_CALL` a call); 0 before the first launch."""
    return int(_LAUNCH["waits"]()) if _LAUNCH else 0


def reset_counts() -> None:
    global RING_ALLREDUCE_LAUNCHES, SWING_ALLREDUCE_LAUNCHES
    RING_ALLREDUCE_LAUNCHES = SWING_ALLREDUCE_LAUNCHES = 0


# -- the plain versions --------------------------------------------------------

def ring_allreduce_reference(x: torch.Tensor, group, axis: str = "dp"
                             ) -> torch.Tensor:
    """The ring schedule of ``_ring_kernel`` over ``group.ppermute``:
    the carry starts as block ``my``; reduce-scatter step t receives the
    left neighbour's carry and adds block ``(my - 1 - t) mod n``; the
    carry is then the sum of block ``(my + 1) mod n``; all-gather step s
    receives the complete block ``(my - s) mod n``."""
    n, my = group.axis_size(axis), group.axis_index(axis)
    if n == 1:
        return x
    blocks = x.reshape(n, -1)
    out = torch.empty_like(blocks)
    carry = blocks[my]
    for t in range(n - 1):
        carry = group.ppermute(carry, axis, 1) + blocks[(my - 1 - t) % n]
    out[(my + 1) % n] = carry
    for s in range(n - 1):
        carry = group.ppermute(carry, axis, 1)
        out[(my - s) % n] = carry
    return out.reshape(x.shape)


def swing_allreduce_reference(x: torch.Tensor, group, axis: str = "dp"
                              ) -> torch.Tensor:
    """The swing schedule of ``_swing_kernel``: ``ops/collectives.py
    swing_allreduce`` along ``axis`` (the same ``out + partner's out``)."""
    return swing_allreduce(x, group, axis)


# -- the kernels' schedule: layout and add order -------------------------------

def block_elems(numel: int, n: int) -> int:
    """Elements of each of the n blocks: whole 128-lanes, the lanes
    split as evenly as the ceiling allows (the ring's numel / n)."""
    return -(-(numel // LANE) // n) * LANE


def block_range(b: int, numel: int, n: int) -> "tuple[int, int]":
    """Block b's ``[lo, hi)``; the last blocks may be ragged or empty."""
    s = block_elems(numel, n)
    lo = min(b * s, numel)
    return lo, min(lo + s, numel)


def owned_block(rank: int, n: int) -> int:
    """The block rank ``rank`` (an axis index) sums: ``(rank + 1) mod n``,
    where the TPU ring's reduce-scatter leaves its complete carry."""
    return (rank + 1) % n


def slot(src: int, dst: int, n: int) -> int:
    """Which of ``dst``'s n - 1 inbound (and gather) slots ``src``
    writes: its distance past ``dst`` less one."""
    if src == dst:
        raise ValueError(f"rank {src} has no slot in its own buffer")
    return (src - dst - 1) % n


def inbound_offset(src: int, dst: int, n: int, numel: int) -> int:
    """Element offset in ``dst``'s buffer where ``src`` pushes its share
    of ``dst``'s block."""
    return slot(src, dst, n) * block_elems(numel, n)


def gather_offset(src: int, dst: int, n: int, numel: int) -> int:
    """Element offset in ``dst``'s buffer where owner ``src`` stores the
    sum of its block."""
    return (n - 1 + slot(src, dst, n)) * block_elems(numel, n)


def buffer_bytes(n: int, numel: int) -> int:
    """One rank's buffer: 2(n - 1) slots of a block, then the counters
    (``push``, ``reduce``, ``abandoned``, ``ran``: u64 at bytes 0, 8, 16
    and 24 of the last :data:`COUNTER_BYTES`)."""
    return 4 * 2 * (n - 1) * block_elems(numel, n) + COUNTER_BYTES


def add_order(b: int, n: int, schedule: str) -> list:
    """The ranks whose contributions to block b the owner folds, in
    order: the ring's chain from rank b round to the owner, or the
    swing's tree leaves 0..n-1 (:func:`owner_sum`)."""
    if schedule == "ring":
        return [(b + i) % n for i in range(n)]
    if schedule == "swing":
        return list(range(n))
    raise ValueError(f"unknown schedule {schedule!r}: {SCHEDULES}")


def owner_sum(parts: list, schedule: str) -> torch.Tensor:
    """The owner's fold of ``parts`` (in :func:`add_order`): the ring's
    chain ``((p0 + p1) + p2) + ...``, or the swing's balanced tree
    ``(p0 + p1) + (p2 + p3)``, one f32 add an element each."""
    if schedule == "ring":
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc
    if len(parts) == 1:
        return parts[0]
    half = len(parts) // 2
    return owner_sum(parts[:half], "swing") + owner_sum(parts[half:], "swing")


def rank_bytes(n: int, numel: int, rank: int) -> int:
    """Device bytes one call moves for axis rank ``rank``: push reads and
    stores the n - 1 blocks its peers own, reduce reads its block's n
    contributions and stores n copies of the sum, gather reads and
    stores the n - 1 blocks its peers own (2N + 4(n - 1)/n N on even
    blocks)."""
    def elems(b):
        lo, hi = block_range(b, numel, n)
        return hi - lo
    others = sum(elems(owned_block(p, n)) for p in range(n) if p != rank)
    return 4 * (2 * others + 2 * n * elems(owned_block(rank, n))
                + 2 * others)


def schedule_emulation(xs: list, schedule: str) -> list:
    """Every rank's result of the kernels' schedule, in plain torch:
    ``xs`` holds each axis rank's flat f32 vector. Each rank gets zeroed
    slots laid out as its buffer's (:func:`inbound_offset`,
    :func:`gather_offset`); push stores each block into its owner's
    inbound slots, each owner folds its block's contributions in
    :func:`add_order` through :func:`owner_sum` and stores the sum into
    its out and every peer's gather slot, and gather copies the slots
    into out. Returns the n outs."""
    n, numel = len(xs), xs[0].numel()
    bufs = [torch.zeros(2 * (n - 1) * block_elems(numel, n)) for _ in xs]
    outs = [torch.empty_like(x) for x in xs]

    def at(r, offset, b):  # rank r's slot at `offset`, block b's length
        lo, hi = block_range(b, numel, n)
        return bufs[r][offset:offset + hi - lo]

    for r in range(n):  # push
        for p in range(n):
            if p != r:
                lo, hi = block_range(owned_block(p, n), numel, n)
                at(p, inbound_offset(r, p, n, numel),
                   owned_block(p, n))[:] = xs[r][lo:hi]
    for r in range(n):  # reduce
        b = owned_block(r, n)
        lo, hi = block_range(b, numel, n)
        total = owner_sum(
            [xs[r][lo:hi] if q == r else at(r, inbound_offset(q, r, n, numel), b)
             for q in add_order(b, n, schedule)], schedule)
        outs[r][lo:hi] = total
        for p in range(n):
            if p != r:
                at(p, gather_offset(r, p, n, numel), b)[:] = total
    for r in range(n):  # gather
        for q in range(n):
            if q != r:
                lo, hi = block_range(owned_block(q, n), numel, n)
                outs[r][lo:hi] = at(r, gather_offset(q, r, n, numel),
                                    owned_block(q, n))
    return outs


# -- the wrappers ----------------------------------------------------------------

def _check(x: torch.Tensor) -> None:
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"the allreduce takes a flat float32 vector, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _check_lanes(x: torch.Tensor, multiple: int, what: str) -> None:
    if x.numel() % multiple:
        raise ValueError(
            f"vector of {x.numel()} elements must {what} of whole {LANE}-"
            f"lanes; pad to a multiple of {multiple}")


def _check_device(x: torch.Tensor, group, n: int) -> None:
    if x.device.type != "cuda" or x.device != group.device:
        raise ValueError(f"the kernel runs on the group's CUDA device "
                         f"{group.device}, got a tensor on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel needs a contiguous, 16-byte aligned "
                         "vector")
    if n > MAX_RANKS:
        raise ValueError(f"the kernel takes at most {MAX_RANKS} ranks on "
                         f"an axis, got {n}")


def _table(values: list):
    return (ctypes.c_uint64 * len(values))(*values)


def _peer_allreduce(x: torch.Tensor, group, axis: str, schedule: str
                    ) -> torch.Tensor:
    """One call of the kernels' schedule (``csrc/ring_allreduce.cu``):
    the layout functions above resolved into device addresses, launched
    on the current stream after the buffer's previous call."""
    n, my, numel = group.axis_size(axis), group.axis_index(axis), x.numel()
    ranks = [group.axis_rank(axis, q) for q in range(n)]
    launch = _launchers()["launch"]
    nbytes = buffer_bytes(n, numel)
    bufs = group.peer_buffers(axis, nbytes)
    if bufs.abandoned:
        raise RuntimeError(
            f"{schedule}_allreduce: an earlier call on rank {group.rank}'s "
            f"peer buffer of {nbytes} bytes did not end and was abandoned "
            f"(ring.wait); the buffer takes no more calls")
    base = [bufs.local if q == my else bufs.peers[ranks[q]]
            for q in range(n)]
    out = torch.empty_like(x)
    xp, op = x.data_ptr(), out.data_ptr()
    peers = [p for p in range(n) if p != my]
    push, gather = [], []
    for p in peers:
        lo, hi = block_range(owned_block(p, n), numel, n)
        push += [xp + 4 * lo,
                 base[p] + 4 * inbound_offset(my, p, n, numel), (hi - lo) // 4]
        gather += [base[my] + 4 * gather_offset(p, my, n, numel),
                   op + 4 * lo, (hi - lo) // 4]
    b = owned_block(my, n)
    lo, hi = block_range(b, numel, n)
    sources = [xp + 4 * lo if q == my
               else base[my] + 4 * inbound_offset(q, my, n, numel)
               for q in add_order(b, n, schedule)]
    dests = [op + 4 * lo] + [base[p] + 4 * gather_offset(my, p, n, numel)
                             for p in peers]
    counters = [base[q] + nbytes - COUNTER_BYTES for q in [my] + peers]
    swing_log = n.bit_length() - 1 if schedule == "swing" else 0
    stream = torch.cuda.current_stream(x.device)
    if bufs.done is not None:  # the buffer's calls stay in order
        stream.wait_event(bufs.done)
    call = bufs.calls + 1
    with torch.cuda.device(x.device):
        rc = launch(_table(push), _table(gather), _table(sources),
                    _table(dests), n, (hi - lo) // 4, swing_log,
                    _table(counters), call, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{schedule}_allreduce kernel launch failed: "
                           f"{_launchers()['error'](rc).decode()} ({rc})")
    bufs.calls = call
    bufs.done = torch.cuda.Event()
    bufs.done.record(stream)
    return out


def peer_ring_allreduce(x: torch.Tensor, group, axis: str = "dp"
                        ) -> torch.Tensor:
    """Rank-local allreduce of a flat f32 vector in the ring's add order
    (``pallas_ring_allreduce``). Needs ``x.numel() % (n * 128) == 0``; a
    one-rank axis is the identity. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernels on the current stream or raises.
    The result is ready on that stream; :func:`wait` bounds the wait."""
    global RING_ALLREDUCE_LAUNCHES
    n = group.axis_size(axis)
    if n == 1:  # lax.psum over one rank: any dtype and shape, no launch
        return x
    _check(x)
    _check_lanes(x, n * LANE, f"divide into {n} ring blocks")
    if x.device.type == "cpu":
        return ring_allreduce_reference(x, group, axis)
    _check_device(x, group, n)
    out = _peer_allreduce(x, group, axis, "ring")
    RING_ALLREDUCE_LAUNCHES += 1
    return out


def peer_swing_allreduce(x: torch.Tensor, group, axis: str = "dp"
                         ) -> torch.Tensor:
    """Rank-local allreduce of a flat f32 vector in the swing's add order
    (``pallas_swing_allreduce``). Needs a power-of-two axis and
    ``x.numel() % 128 == 0``; a one-rank axis is the identity. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernels on
    the current stream or raises. :func:`wait` bounds the wait."""
    global SWING_ALLREDUCE_LAUNCHES
    n = group.axis_size(axis)
    if n == 1:  # lax.psum over one rank: any dtype and shape, no launch
        return x
    _check(x)
    _check_power_of_two(n)
    _check_lanes(x, LANE, "consist")
    if x.device.type == "cpu":
        return swing_allreduce_reference(x, group, axis)
    _check_device(x, group, n)
    out = _peer_allreduce(x, group, axis, "swing")
    SWING_ALLREDUCE_LAUNCHES += 1
    return out


def _counter_values(bufs) -> "tuple[int, int, int, int]":
    """``push``, ``reduce``, ``abandoned`` and ``ran`` of this rank's
    buffer, read on a side stream into pinned memory: the call's own
    stream may be blocked in its wait."""
    fns = _launchers()
    values = (ctypes.c_uint64 * 4)()
    rc = fns["read"](bufs.local + bufs.nbytes - COUNTER_BYTES, values)
    if rc != 0:
        raise RuntimeError(f"reading the peer allreduce counters failed: "
                           f"{fns['error'](rc).decode()} ({rc})")
    return tuple(values)


def kernels_run(group) -> int:
    """Kernels of the peer allreduce that ran on the card on this rank's
    buffers (:data:`KERNELS_PER_CALL` a call; each kernel's first block
    counts it in the buffer's ``ran`` word); 0 before the first launch.
    Read after :func:`wait`."""
    from akka_allreduce_tpu_torch.parallel.group import peer_buffer_list
    return sum(_counter_values(b)[3] for b in peer_buffer_list())


def _abandon(bufs, want: int) -> None:
    """Give up the buffer's calls so that its stream drains: the stretches
    still queued do nothing and both waits are freed (on a side stream;
    ``peer_allreduce_abandon``). The buffer takes no more calls."""
    fns = _launchers()
    rc = fns["abandon"](bufs.local + bufs.nbytes - COUNTER_BYTES, want)
    if rc != 0:
        raise RuntimeError(f"abandoning the peer allreduce call failed: "
                           f"{fns['error'](rc).decode()} ({rc})")
    bufs.abandoned = True


def wait(group, timeout: float = TIMEOUT_S) -> None:
    """Block until the last peer-allreduce call on each of this rank's
    buffers has ended on the card. Past ``timeout`` seconds raise
    ``RuntimeError`` naming the rank, the call and the counters it waits
    on: the ranks made different calls, or a peer stopped. Before raising
    it abandons that buffer's calls: the rest of the call reads and
    stores nothing, the stream drains (the process can synchronise and
    exit), and a later call on the buffer raises. The peers' calls that
    wait on this one then stall and raise in their own ``wait``."""
    from akka_allreduce_tpu_torch.parallel.group import peer_buffer_list
    deadline = time.monotonic() + timeout
    for bufs in peer_buffer_list():
        while bufs.done is not None and not bufs.done.query():
            if time.monotonic() > deadline:
                want = len(bufs.peers) * bufs.calls
                push, reduce, _, _ = _counter_values(bufs)
                _abandon(bufs, want)
                raise RuntimeError(
                    f"peer allreduce: rank {group.rank}'s call {bufs.calls} "
                    f"did not end within {timeout:g} s: counters push "
                    f"{push} and reduce {reduce}, the call waits for both "
                    f">= {want} ({len(bufs.peers)} peers x call "
                    f"{bufs.calls}); the ranks made different calls, or a "
                    f"peer stopped. The call was abandoned; this buffer "
                    f"takes no more calls")
            time.sleep(1e-4)
