"""Split TF32 emulated in plain torch: the arithmetic of the f32 flash and
ring backward kernels (``csrc/flash_tf32.cuh``).

Each product there runs on the tensor cores as three TF32 products: every
operand x split into hi = x rounded to TF32 and lo = x - hi, each read by
the tensor core with its 13 low mantissa bits ignored, and hi.lo + lo.hi +
hi.hi summed (lo.lo dropped). The flash and the ring tests hold this
emulation against the JAX package's kernels at the f32 gradient tolerance,
and one TF32 product against the same limit, which it must miss. No JAX
here: the tests import both.
"""

from typing import Optional

import torch

from akka_allreduce_tpu_torch.ops.kernels.flash_attention import score_mask
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    NEG_INF, expand_kv_heads)


def _tf32_bits(x: torch.Tensor, add: int) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + add) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the 13 low
    mantissa bits dropped, to nearest, ties away from zero (half an ulp
    added to the magnitude's bit pattern, then truncated)."""
    return _tf32_bits(x, 0x1000)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a tf32 operand: the 13 low mantissa
    bits ignored (truncated toward zero)."""
    return _tf32_bits(x, 0)


def split_tf32_backward(q, k, v, do, lse, delta, q_off, k_off, causal,
                        products: int, window: Optional[int] = None):
    """The f32 backward's (dq, dk, dv) with every product as the
    tensor-core kernels compute it (``flash_tf32.cuh split_tf32``): each
    operand split into hi = tf32(x) and lo = x - hi as the tensor core
    reads it (truncated), and ``products`` = 3 (hi.lo + lo.hi + hi.hi,
    lo.lo dropped) or 1 (hi.hi alone, one TF32 product). The rest is
    ``_bwd_tile``'s arithmetic in f32 under the causal / window mask at
    the given offsets, dk/dv summed over the group."""
    def mm(spec, a, b):
        ah, bh = tf32(a), tf32(b)
        out = torch.einsum(spec, ah, bh)
        if products == 3:
            out = (torch.einsum(spec, tf32_trunc(a - ah), bh)
                   + torch.einsum(spec, ah, tf32_trunc(b - bh)) + out)
        return out

    scale = q.shape[-1] ** -0.5
    k_e, v_e = expand_kv_heads(q, k, v)
    s = mm("bqhd,bkhd->bhqk", q, k_e) * scale
    mask = score_mask(q.shape[1], k.shape[1], causal, window, q_off, k_off,
                      q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])  # masked lanes exactly 0
    dp = mm("bqhd,bkhd->bhqk", do, v_e)
    ds = p * (dp - delta[..., None]) * scale
    dq = mm("bhqk,bkhd->bqhd", ds, k_e)
    dv = mm("bhqk,bqhd->bkhd", p, do)
    dk = mm("bhqk,bqhd->bkhd", ds, q)
    b, tk, h_kv, d = k.shape
    g = q.shape[2] // h_kv
    return (dq, dk.reshape(b, tk, h_kv, g, d).sum(dim=3),
            dv.reshape(b, tk, h_kv, g, d).sum(dim=3))
