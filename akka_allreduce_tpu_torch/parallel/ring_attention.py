"""Single-rank attention of the port: the counterpart of the oracle half of
``akka_allreduce_tpu/parallel/ring_attention.py``.

Only ``NEG_INF``, :func:`expand_kv_heads` and
:func:`local_causal_attention` are ported so far; the ring paths
(sequence parallelism) come with a later slice.
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
