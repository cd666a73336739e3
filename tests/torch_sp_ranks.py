"""Rank-side helpers of the port's sequence-parallel tests.

Spawned ranks import this module by name, so it imports no JAX (the
ranks of ``parallel/group.py spawn_ranks`` never load it). Every rank
receives the GLOBAL inputs as numpy arrays and takes its own sequence
columns, ``[j T, (j + 1) T)`` for ``sp`` rank ``j``.
"""

import numpy as np
import torch

from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
from akka_allreduce_tpu_torch.parallel import ring_attention as ra


def _local(group, x: np.ndarray) -> torch.Tensor:
    n, j = group.axis_size("sp"), group.axis_index("sp")
    t = x.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(x[:, j * t:(j + 1) * t]))


def attention_vjp(group, cases: list) -> list:
    """Per case ``(impl, q, k, v, do, causal, window)`` with global (B, T,
    ...) arrays: this rank's ``(o, dq, dk, dv)`` and its ring-kernel
    launch counts (the CPU wrappers run the plain versions and count
    nothing). ``impl``: "ring_flash" (:class:`RingFlashAttention`),
    "ring" (the plain ring), "windowed" / "flash_windowed"."""
    out = []
    for impl, q, k, v, do, causal, window in cases:
        leaves = [_local(group, x).requires_grad_() for x in (q, k, v)]
        if impl == "ring_flash":
            o = rf.ring_flash_attention(*leaves, group, causal)
        elif impl == "ring":
            o = ra.ring_attention(*leaves, group, causal)
        elif impl == "windowed":
            o = ra.windowed_sp_attention(*leaves, window, group)
        else:
            o = ra.flash_windowed_sp_attention(*leaves, window, group)
        grads = torch.autograd.grad(o, leaves, _local(group, do))
        out.append([o.detach().numpy()] + [g.numpy() for g in grads])
    return out


def ppermute_probe(group) -> dict:
    """What this rank receives from ``ppermute`` along each axis and
    shift (payload: its global rank in f32, bf16 and int32), and its
    coordinates."""
    got = {"dp": (group.axis_index("dp"), group.axis_size("dp")),
           "sp": (group.axis_index("sp"), group.axis_size("sp"))}
    for axis in ("sp", "dp"):
        for shift in (1, -1, 2):
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                x = torch.full((2, 3), group.rank, dtype=dtype)
                y = group.ppermute(x, axis, shift)
                got[(axis, shift, str(dtype))] = (y.dtype == dtype,
                                                  y.float().unique().tolist())
    return got
