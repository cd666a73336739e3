"""Peer-memory ring and swing allreduce: the plain versions and the kernels.

The counterpart of ``akka_allreduce_tpu/ops/pallas_kernels/ring.py``.
Both functions are rank-local: every rank of a
:class:`~akka_allreduce_tpu_torch.parallel.group.RankGroup` calls them, in
the same order, with its own flat f32 vector, and gets the sum over the
ranks along ``axis``, as the JAX functions do inside ``shard_map``:

* :func:`peer_ring_allreduce` — reduce-scatter + all-gather around the
  ring of the axis (``_ring_kernel``): the vector as n ring blocks of
  whole 128-lanes, 2(n-1) neighbour steps.
* :func:`peer_swing_allreduce` — log2(n) exchanges with the XOR partner
  ``my ^ 2^t`` (``_swing_kernel``), each ``out = out + partner's out``.

A CPU tensor goes to the plain versions, :func:`ring_allreduce_reference`
and :func:`swing_allreduce_reference`: the same schedules, in the same
add order, over the group's ``ppermute`` and ``exchange``, so they are
bitwise the JAX kernels run in interpret mode. A CUDA tensor launches
``csrc/ring_allreduce.cu`` or raises: the kernel stores its payloads
into the peers' memory through CUDA IPC (``RankGroup.peer_buffers``),
never over the group's wire, and computes the same adds, so it is
bitwise its plain version. A stalled handshake traps in the kernel after
:data:`TIMEOUT_S` seconds, and the next synchronise raises.
:data:`RING_ALLREDUCE_LAUNCHES` and :data:`SWING_ALLREDUCE_LAUNCHES`
count launches.
"""

from __future__ import annotations

import ctypes

import torch

from akka_allreduce_tpu_torch.ops.collectives import (_check_power_of_two,
                                                      swing_allreduce)
from akka_allreduce_tpu_torch.ops.kernels import build

LANE = 128
TIMEOUT_S = 30.0  # a kernel's wait for one flag before it traps

# kernel launches since import (or since a caller reset them to 0); the
# plain versions never count
RING_ALLREDUCE_LAUNCHES = 0
SWING_ALLREDUCE_LAUNCHES = 0

_LAUNCH: dict = {}  # the bound C entry points, set at first launch


def _launchers() -> dict:
    if not _LAUNCH:
        lib = build.load("ring_allreduce")
        ptr, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                              ctypes.c_uint64)
        ring = lib.ring_allreduce_launch
        # x, out, mine, right, n, my, block_elems, base, rank, timeout, stream
        ring.argtypes = [ptr] * 4 + [i32, i32, i64, u64, i32, u64, ptr]
        swing = lib.swing_allreduce_launch
        # x, out, mine, peers[], steps, elems, base, rank, timeout, stream
        swing.argtypes = ([ptr] * 3 + [ctypes.POINTER(ptr), i32, i64, u64,
                                       i32, u64, ptr])
        flag_bytes = lib.ring_allreduce_flag_bytes
        flag_bytes.restype = i64
        err = lib.ring_allreduce_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        for fn in (ring, swing):
            fn.restype = i32
        _LAUNCH.update(ring=ring, swing=swing, flag_bytes=flag_bytes(),
                       error=err)
    return _LAUNCH


def counts() -> dict:
    return {"ring_allreduce": RING_ALLREDUCE_LAUNCHES,
            "swing_allreduce": SWING_ALLREDUCE_LAUNCHES}


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


def _check_device(x: torch.Tensor, group) -> None:
    if x.device.type != "cuda" or x.device != group.device:
        raise ValueError(f"the kernel runs on the group's CUDA device "
                         f"{group.device}, got a tensor on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel needs a contiguous, 16-byte aligned "
                         "vector")


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_launchers()['error'](rc).decode()} ({rc})")


def peer_ring_allreduce(x: torch.Tensor, group, axis: str = "dp"
                        ) -> torch.Tensor:
    """Rank-local allreduce of a flat f32 vector on the ring of ``axis``
    (``pallas_ring_allreduce``). Needs ``x.numel() % (n * 128) == 0``; a
    one-rank axis is the identity. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel on the current stream or raises."""
    global RING_ALLREDUCE_LAUNCHES
    n = group.axis_size(axis)
    if n == 1:  # lax.psum over one rank: any dtype and shape, no launch
        return x
    _check(x)
    _check_lanes(x, n * LANE, f"divide into {n} ring blocks")
    if x.device.type == "cpu":
        return ring_allreduce_reference(x, group, axis)
    _check_device(x, group)
    fns = _launchers()
    my, block = group.axis_index(axis), x.numel() // n
    right = group.axis_rank(axis, (my + 1) % n)
    bufs = group.peer_buffers(axis, (right,), 2 * 4 * block
                              + fns["flag_bytes"])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fns["ring"](x.data_ptr(), out.data_ptr(), bufs.local,
                         bufs.peers[right], n, my, block, bufs.steps_done,
                         group.rank, int(TIMEOUT_S * 1e9), stream)
    _launch("ring_allreduce", rc)
    bufs.steps_done += 2 * (n - 1)
    RING_ALLREDUCE_LAUNCHES += 1
    return out


def peer_swing_allreduce(x: torch.Tensor, group, axis: str = "dp"
                         ) -> torch.Tensor:
    """Rank-local allreduce of a flat f32 vector on the swing schedule of
    ``axis`` (``pallas_swing_allreduce``). Needs a power-of-two axis and
    ``x.numel() % 128 == 0``; a one-rank axis is the identity. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel on
    the current stream or raises."""
    global SWING_ALLREDUCE_LAUNCHES
    n = group.axis_size(axis)
    if n == 1:  # lax.psum over one rank: any dtype and shape, no launch
        return x
    _check(x)
    _check_power_of_two(n)
    _check_lanes(x, LANE, "consist")
    if x.device.type == "cpu":
        return swing_allreduce_reference(x, group, axis)
    _check_device(x, group)
    fns = _launchers()
    my, steps = group.axis_index(axis), n.bit_length() - 1
    partners = tuple(group.axis_rank(axis, my ^ (1 << t))
                     for t in range(steps))
    bufs = group.peer_buffers(axis, partners, 2 * 4 * x.numel()
                              + fns["flag_bytes"])
    peers = (ctypes.c_void_p * steps)(*[bufs.peers[p] for p in partners])
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fns["swing"](x.data_ptr(), out.data_ptr(), bufs.local, peers,
                          steps, x.numel(), bufs.steps_done, group.rank,
                          int(TIMEOUT_S * 1e9), stream)
    _launch("swing_allreduce", rc)
    bufs.steps_done += steps
    SWING_ALLREDUCE_LAUNCHES += 1
    return out
