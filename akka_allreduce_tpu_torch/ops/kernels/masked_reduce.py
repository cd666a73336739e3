"""Masked peer reduction: the plain PyTorch version and the CUDA kernel.

The counterpart of ``akka_allreduce_tpu/ops/pallas_kernels/reduce.py``
(``fused_masked_reduce``): for a ``(peers, elems)`` f32 staging matrix
and a ``(peers,)`` mask,

    count = sum valid,  out = (sum_p valid[p] * staged[p]) * target / count

(0 where count is 0), with the count returned as an int32 scalar.

* :func:`masked_reduce_reference` — the plain version: the peers summed
  in order, each product and sum rounded once, as the kernel does; the
  CPU path and the kernel's oracle.
* :func:`masked_reduce` — the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/masked_reduce.cu`` or raises.
  :data:`MASKED_REDUCE_LAUNCHES` counts kernel launches.

The port's sum over ranks runs through this wrapper
(``ops/collectives.py``): the ranks' blocks arrive as the staging matrix
and are reduced on the device in rank order, which is what keeps the
windowed schedule bitwise equal to the fused one.
"""

from __future__ import annotations

import ctypes

import torch

from akka_allreduce_tpu_torch.ops.kernels import build

# kernel launches since import (or since a caller reset it to 0); the
# plain version never counts
MASKED_REDUCE_LAUNCHES = 0

_LAUNCH: dict = {}


def _launcher():
    if not _LAUNCH:
        lib = build.load("masked_reduce")
        fn = lib.masked_reduce_launch
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.masked_reduce_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LAUNCH.update(launch=fn, error=err)
    return _LAUNCH["launch"], _LAUNCH["error"]


def _scale(count: torch.Tensor, target: float) -> torch.Tensor:
    """``target / max(count, 1)`` as an IEEE f32 division (0 where the
    count is 0). A Python number on the left of ``/`` would make torch
    multiply by a reciprocal instead."""
    t = torch.full((), target, dtype=torch.float32, device=count.device)
    return torch.where(count > 0, torch.div(t, count.clamp_min(1.0)),
                       torch.zeros((), device=count.device))


def masked_reduce_reference(staged: torch.Tensor, valid: torch.Tensor,
                            target: float = 1.0
                            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The plain version: (reduced (elems,) f32, count int32 scalar)."""
    v = valid.to(device=staged.device, dtype=torch.float32)
    count = torch.zeros((), dtype=torch.float32, device=staged.device)
    total = torch.zeros(staged.shape[1:], dtype=torch.float32,
                        device=staged.device)
    for p in range(staged.shape[0]):
        count = count + v[p]
        total = total + staged[p] * v[p]
    return total * _scale(count, target), count.to(torch.int32)


def _check(staged: torch.Tensor, valid: torch.Tensor) -> None:
    if staged.dim() != 2 or staged.dtype != torch.float32:
        raise ValueError(f"staged must be (peers, elems) float32, got "
                         f"{tuple(staged.shape)} {staged.dtype}")
    if tuple(valid.shape) != (staged.shape[0],):
        raise ValueError(f"valid must be ({staged.shape[0]},), got "
                         f"{tuple(valid.shape)}")


def masked_reduce(staged: torch.Tensor, valid: torch.Tensor,
                  target: float = 1.0) -> "tuple[torch.Tensor, torch.Tensor]":
    """Masked reduce of a ``(peers, elems)`` f32 staging matrix over its
    peers. ``valid`` is any numeric or bool ``(peers,)`` mask, read as
    f32. Returns ``(reduced (elems,) f32, count int32 scalar)``. On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel on the current stream and raises if the launch fails."""
    global MASKED_REDUCE_LAUNCHES
    _check(staged, valid)
    if staged.device.type == "cpu":
        return masked_reduce_reference(staged, valid, target)
    if staged.device.type != "cuda":
        raise ValueError(f"masked_reduce runs on cpu or cuda, got "
                         f"{staged.device}")
    if not staged.is_contiguous():
        raise ValueError("masked_reduce needs a contiguous staging matrix")
    peers, elems = staged.shape
    v = valid.to(device=staged.device, dtype=torch.float32).contiguous()
    out = torch.empty((elems,), dtype=torch.float32, device=staged.device)
    count = torch.empty((), dtype=torch.int32, device=staged.device)
    fn, err = _launcher()
    with torch.cuda.device(staged.device):
        stream = torch.cuda.current_stream(staged.device).cuda_stream
        rc = fn(staged.data_ptr(), v.data_ptr(), out.data_ptr(),
                count.data_ptr(), peers, elems, float(target), stream)
    if rc != 0:
        raise RuntimeError(f"masked_reduce kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    MASKED_REDUCE_LAUNCHES += 1
    return out, count
