"""Split TF32 emulated in plain torch: the arithmetic of the f32 flash and
ring kernels, forward and backward (``csrc/flash_tf32.cuh``).

Each product there runs on the tensor cores as three TF32 products: every
operand x split into hi = x rounded to TF32 and lo = x - hi, each read by
the tensor core with its 13 low mantissa bits ignored, and hi.lo + lo.hi +
hi.hi summed (lo.lo dropped). The flash and the ring tests hold this
emulation against the JAX package's kernels at the f32 tolerances (2e-5
forward, 5e-5 gradients), and one TF32 product against the same limits,
which it must miss. No JAX here: the tests import both.
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


LOG2E = 1.4426950408889634


def split_mm(spec: str, a: torch.Tensor, b: torch.Tensor,
             products: int) -> torch.Tensor:
    """``einsum(spec, a, b)`` as the tensor cores compute it in split TF32:
    ``products`` = 3 (hi.lo + lo.hi + hi.hi, lo.lo dropped) or 1 (hi.hi
    alone, one TF32 product)."""
    ah, bh = tf32(a), tf32(b)
    out = torch.einsum(spec, ah, bh)
    if products == 3:
        out = (torch.einsum(spec, tf32_trunc(a - ah), bh)
               + torch.einsum(spec, ah, tf32_trunc(b - bh)) + out)
    return out


def split_tf32_forward(q, k, v, m, l_sum, acc, q_off, k_off, causal,
                       products: int, window: Optional[int] = None):
    """The block (k, v) folded into the carry ``(m, l, acc)`` ((B, H, Tq)
    and (B, Tq, H, D) f32) as ``fwd_tf32_fold`` computes it: S = Q K^T
    and acc += P V through :func:`split_mm`, and ``_softmax_tile``'s
    online softmax with the kernel's exponential, ``exp2`` of the
    scale-folded score (``fwd_scores``): m' = max(m, rowmax s), corr =
    2^((min(m, m') - m') log2 e), p = 2^(S scale log2 e - m' log2 e),
    exactly 0 on a masked lane. Returns the new ``(m, l, acc)``,
    unnormalised, in natural-log units."""
    scale = q.shape[-1] ** -0.5
    k_e, v_e = expand_kv_heads(q, k, v)
    s = split_mm("bqhd,bkhd->bhqk", q, k_e, products)
    mask = score_mask(q.shape[1], k.shape[1], causal, window, q_off, k_off,
                      q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    row = s.amax(dim=-1)
    m_new = torch.maximum(m, torch.where(row > NEG_INF / 2, row * scale,
                                         NEG_INF))
    corr = torch.exp2((torch.minimum(m, m_new) - m_new) * LOG2E)
    p = torch.exp2(s * (scale * LOG2E) - (m_new * LOG2E)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l_sum * corr + p.sum(dim=-1)
    pv = split_mm("bhqk,bkhd->bqhd", p, v_e, products)
    return m_new, l_new, acc * corr.transpose(1, 2)[..., None] + pv


def split_tf32_flash_forward(q, k, v, q_off, k_off, causal, products: int,
                             window: Optional[int] = None):
    """``(o, lse)`` of the f32 flash forward: :func:`split_tf32_forward`
    from the empty state, then o = acc / l (0 where no key is live) and
    lse = m + log l."""
    b, tq, h, d = q.shape
    m0 = torch.full((b, h, tq), NEG_INF)
    m, l_sum, acc = split_tf32_forward(
        q, k, v, m0, torch.zeros_like(m0), torch.zeros((b, tq, h, d)),
        q_off, k_off, causal, products, window)
    den = torch.where(l_sum > 0, l_sum, 1.0).transpose(1, 2)[..., None]
    return acc / den, m + torch.log(l_sum)


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
        return split_mm(spec, a, b, products)

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
