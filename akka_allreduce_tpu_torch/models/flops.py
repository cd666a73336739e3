"""Analytic FLOPs model and the card's peak, for MFU reporting.

Counterpart of ``akka_allreduce_tpu/models/flops.py``, with the same
arithmetic:

* :func:`transformer_step_flops` — useful FLOPs of one training step of
  the dense flagship transformer (matmul terms only): QKVO projections,
  causal attention scores + AV counted at the causal half (the flash
  kernels skip future tiles, so that is the executed work), the FF (an
  MoE layer's: the router and ``router_k`` expert FFs a token) and the
  LM head; backward = 2x forward. Rematerialisation recompute is not
  counted: MFU measures useful FLOPs.
* :func:`chip_peak_flops` — the card's dense bf16 peak. MFU is reported
  against it for both dtypes (the JAX package's convention, which
  penalises f32 honestly).
"""

from __future__ import annotations

from typing import Optional

import torch

from akka_allreduce_tpu_torch.models.transformer import TransformerConfig

# dense bf16 tensor-core peak FLOP/s, substring-matched against
# torch.cuda.get_device_name (NVIDIA H100 data sheet, SXM part)
_PEAK_FLOPS_BF16 = (("H100", 989e12),)


def chip_peak_flops(device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one CUDA device, or None when unknown
    (the CPU, or a card the table does not list)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for tag, flops in _PEAK_FLOPS_BF16:
        if tag in name:
            return flops
    return None


def transformer_fwd_flops(cfg: TransformerConfig, batch: int,
                          seq: int) -> float:
    """Useful forward matmul FLOPs for one pass over (batch, seq) tokens."""
    b, t, d = batch, seq, cfg.d_model
    tokens = b * t
    d_kv = cfg.kv_heads * cfg.head_dim  # < d under grouped-query attention
    # wq + wo at full width, wk + wv at the (possibly grouped) KV width
    per_layer_attn = 4 * tokens * d * d + 4 * tokens * d * d_kv
    # scores (QK^T) + AV: 2 matmuls x 2 FLOPs/MAC per attended (q, k)
    # pair x d. Plain causal attends t(t+1)/2 pairs; a sliding window
    # caps each query at w pairs except the first w-1 queries.
    if cfg.attn_window is None or cfg.attn_window >= t:
        pairs = t * (t + 1) / 2
    else:
        w = cfg.attn_window
        pairs = (t - w) * w + w * (w + 1) / 2
    attn_core = 2 * 2 * b * pairs * d
    # dense FF matmul count: gelu = w1+w2, swiglu adds the w3 gate
    n_ff_mats = 3 if cfg.ffn == "swiglu" else 2
    dense_ff = n_ff_mats * 2 * tokens * d * cfg.d_ff
    if cfg.moe is not None:
        # routed FF: router (d x E) + top-k expert FFs per token
        k = cfg.moe.router_k
        moe_ff = (2 * tokens * d * cfg.moe.n_experts
                  + k * 4 * tokens * d * cfg.moe.d_ff)
        moe_layers = sum(1 for i in range(cfg.n_layers)
                         if cfg.is_moe_layer(i))
        layer_ff = (moe_layers * moe_ff
                    + (cfg.n_layers - moe_layers) * dense_ff)
    else:
        layer_ff = cfg.n_layers * dense_ff
    head = 2 * tokens * d * cfg.vocab_size
    return (cfg.n_layers * (per_layer_attn + attn_core) + layer_ff + head)


def transformer_step_flops(cfg: TransformerConfig, batch: int,
                           seq: int) -> float:
    """Useful FLOPs for one training step: forward + backward (2x)."""
    return 3.0 * transformer_fwd_flops(cfg, batch, seq)
