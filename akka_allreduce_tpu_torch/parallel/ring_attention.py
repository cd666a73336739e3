"""Single-rank attention of the port: the counterpart of the oracle half of
``akka_allreduce_tpu/parallel/ring_attention.py``.

Ported so far: ``NEG_INF``, :func:`expand_kv_heads`,
:func:`local_causal_attention` (the oracle) and
:func:`blockwise_causal_attention` (``attn_impl="blockwise"``); the ring
paths (sequence parallelism) come with a later slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def expand_kv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Grouped-query attention for the plain paths: repeat each K/V head
    across its query group (``jnp.repeat`` along the head axis), so query
    head h reads KV head h // g."""
    g = q.shape[2] // k.shape[2]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def local_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           window: "int | None" = None) -> torch.Tensor:
    """Causal attention over (B, T, H, D) q and (B, T, H_kv, D) k/v: f32
    scores and softmax, ``NEG_INF`` mask, probabilities cast to v's dtype
    before the value product, result in q's dtype. ``window``: each query
    sees itself and window-1 predecessors."""
    k, v = expand_kv_heads(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    if window is not None:
        pos = torch.arange(t, device=q.device)
        mask &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _block_attention(q, k, v, m, l_sum, acc, q_offset: int, k_offset: int):
    """One online-softmax accumulation step over a causal K/V block.

    q: (B, Tq, H, D); k, v: (B, Tk, H or H_kv, D); m, l_sum: (B, H, Tq)
    f32; acc: (B, Tq, H, D) f32. Offsets are the blocks' sequence
    positions, used for the causal mask."""
    k, v = expand_kv_heads(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # correction of the running stats (the min guards exp(-inf - -inf))
    correction = torch.exp(torch.minimum(m, m_new) - m_new)
    p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
    l_new = l_sum * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * correction.transpose(1, 2)[..., None] + pv


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, block_size: int = 512
                               ) -> torch.Tensor:
    """Single-rank causal attention with K/V blocking and online softmax
    (the plain ``attn_impl="blockwise"`` path): a loop over K/V blocks of
    ``block_size`` folds each into the running (m, l, acc), so peak score
    memory is O(T x block) per head. T must be a multiple of
    ``block_size``; T <= block_size is the oracle itself."""
    b, t, h, _ = q.shape
    if t <= block_size:
        return local_causal_attention(q, k, v)
    if t % block_size:
        raise ValueError(
            f"sequence {t} not divisible by block_size {block_size}")
    m = torch.full((b, h, t), NEG_INF, device=q.device)
    l_sum = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start in range(0, t, block_size):
        m, l_sum, acc = _block_attention(
            q, k[:, start:start + block_size], v[:, start:start + block_size],
            m, l_sum, acc, 0, start)
    return (acc / l_sum.transpose(1, 2)[..., None]).to(q.dtype)
