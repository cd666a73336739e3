"""The flagship causal transformer LM, dense or mixture-of-experts.

Counterpart of ``akka_allreduce_tpu/models/transformer.py``. Parameters
are a plain nested dict with the JAX pytree's names, shapes and layout
(``wq`` is ``(d_model, d_model)`` and used as ``h @ wq``), so
``convert.params_from_jax`` carries weights across unchanged and both
packages compute the same function. Parallelism is passed in, as in the
JAX package:

* ``attn_fn`` — the local causal attention, the flash kernels, or a
  ring over the ``sp`` ranks;
* ``tp_group`` — the rank's ``tp`` line: the layer's ``wq``/``wk``/
  ``wv``/``w1``/``w3`` are its column shards and ``wo``/``w2`` its row
  shards (``convert.shard_params``), the attention sees this rank's
  ``H / tp`` query heads and ``H_kv / tp`` KV heads, and the output
  projections sum over ``tp`` (``parallel/tp.py``);
* ``ep_group`` — the rank's ``ep`` line: the MoE layers (every
  ``moe_every``-th, holding ``router``/``we1``/``we2``) route their
  tokens to the experts' ranks (``parallel/ep.py``). The expert FF is
  replicated across ``tp``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from akka_allreduce_tpu_torch.parallel.ep import (MoEConfig, init_moe_layer,
                                                  moe_ffn)
from akka_allreduce_tpu_torch.parallel.group import RankGroup
from akka_allreduce_tpu_torch.parallel.ring_attention import \
    local_causal_attention
from akka_allreduce_tpu_torch.parallel.tp import (column_parallel_dense,
                                                  row_parallel_dense,
                                                  tp_grad_boundary)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and validation as the JAX config; ``dtype`` is a
    torch dtype. With ``moe`` (a ``parallel/ep.py MoEConfig``) every
    ``moe_every``-th layer (``(i + 1) % moe_every == 0``) has a routed
    expert FF instead of the dense one."""

    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: torch.dtype = torch.float32
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    n_kv_heads: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    ffn: str = "gelu"
    attn_window: Optional[int] = None
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None \
            else self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i + 1) % self.moe_every == 0

    def __post_init__(self):
        if self.n_kv_heads is not None and not (
                0 < self.n_kv_heads <= self.n_heads):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be in "
                f"[1, n_heads={self.n_heads}] (None = multi-head; the "
                f"CLI's 0 sentinel maps to None before reaching here)")
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_kv_heads={self.kv_heads} must divide "
                f"n_heads={self.n_heads}")
        if self.ffn not in ("gelu", "swiglu"):
            raise ValueError(f"unknown ffn {self.ffn!r}")
        if self.rope and self.head_dim % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {self.head_dim} "
                f"(d_model={self.d_model} / n_heads={self.n_heads})")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(
                f"attn_window must be >= 1, got {self.attn_window}")


def rope_angles(positions: torch.Tensor, d: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of ``pos * theta^(-2i/d)`` in f32, shape (len, d/2)."""
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def rotate_half_split(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate x's (x[i], x[i + D/2]) pairs by the broadcast angles, in
    f32, result in x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over (B, T, H, D), half-split pairing,
    phases in f32 (the JAX package's convention)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    return rotate_half_split(x, cos[None, :, None, :], sin[None, :, None, :])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS statistics in f32 whatever the compute dtype, cast back to x's
    dtype before the scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def lm_logits(params: dict, x: torch.Tensor,
              cfg: TransformerConfig) -> torch.Tensor:
    """Output head: the lm_head product, or the transposed embedding
    under weight tying."""
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def init_transformer(generator: torch.Generator, cfg: TransformerConfig,
                     device: "torch.device | str | None" = None,
                     tp: int = 1) -> dict:
    """Random parameters from ``generator`` (normal * d_model^-0.5, norms
    at 1), on ``device`` (default: the generator's device): the full,
    unsharded tree whatever ``tp``, which is only checked to divide the
    heads, the KV heads and d_ff (``convert.shard_params`` slices a
    rank's shard). The draws differ from ``jax.random``'s; tests carry
    JAX weights across with ``convert.params_from_jax`` instead."""
    if cfg.n_heads % tp or cfg.d_ff % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.kv_heads}, and d_ff={cfg.d_ff}")
    device = torch.device(device if device is not None
                          else generator.device)
    dt = cfg.dtype
    scale = cfg.d_model ** -0.5
    d_kv = cfg.kv_heads * cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dt) * scale

    def ones(n):
        return torch.ones((n,), device=device, dtype=dt)

    params = {"embed": normal(cfg.vocab_size, cfg.d_model),
              "out_norm": ones(cfg.d_model), "layers": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(cfg.d_model, cfg.vocab_size)
    if not cfg.rope:
        params["pos"] = normal(cfg.max_seq, cfg.d_model)
    for i in range(cfg.n_layers):
        layer = {"ln1": ones(cfg.d_model),
                 "wq": normal(cfg.d_model, cfg.d_model),
                 "wk": normal(cfg.d_model, d_kv),
                 "wv": normal(cfg.d_model, d_kv),
                 "wo": normal(cfg.d_model, cfg.d_model),
                 "ln2": ones(cfg.d_model)}
        if cfg.is_moe_layer(i):
            layer.update(init_moe_layer(generator, cfg.d_model, cfg.moe,
                                        dtype=dt, device=device))
        else:
            layer["w1"] = normal(cfg.d_model, cfg.d_ff)
            layer["w2"] = normal(cfg.d_ff, cfg.d_model)
            if cfg.ffn == "swiglu":
                layer["w3"] = normal(cfg.d_model, cfg.d_ff)
        params["layers"].append(layer)
    return params


def attention_projections(layer: dict, h: torch.Tensor,
                          cfg: TransformerConfig
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(B, T, d_model) normed input -> q (B, T, H, D), k and v
    (B, T, H_kv, D); H and H_kv are the layer's own (a ``tp`` rank's
    column shards hold H / tp and H_kv / tp heads)."""
    b, t, _ = h.shape
    q = column_parallel_dense(h, layer["wq"])
    k = column_parallel_dense(h, layer["wk"])
    v = column_parallel_dense(h, layer["wv"])
    d = cfg.head_dim
    return (q.reshape(b, t, q.shape[-1] // d, d),
            k.reshape(b, t, k.shape[-1] // d, d),
            v.reshape(b, t, v.shape[-1] // d, d))


def _dense_ff_hidden(layer: dict, h: torch.Tensor) -> torch.Tensor:
    """The dense FF's hidden activation: gelu (tanh approximation,
    ``jax.nn.gelu``'s default), or swiglu when the layer carries
    ``w3``."""
    if "w3" in layer:
        return F.silu(column_parallel_dense(h, layer["w1"])) \
            * column_parallel_dense(h, layer["w3"])
    return F.gelu(column_parallel_dense(h, layer["w1"]), approximate="tanh")


def feed_forward(layer: dict, h: torch.Tensor,
                 cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """The FF of one layer on one rank, as the decode paths call it: the
    dense FF, or for an MoE layer (``router`` in it) ``moe_ffn`` with
    every expert local (the JAX ``axis_name=None``), its capacity from
    this call's own token count, ``cfg.moe`` its config."""
    if "router" in layer:
        if cfg is None or cfg.moe is None:
            raise ValueError("an MoE layer needs the model config's moe")
        return moe_ffn(h, layer, cfg.moe)[0]
    return _dense_ff_hidden(layer, h) @ layer["w2"]


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def transformer_block(layer: dict, x: torch.Tensor, cfg: TransformerConfig,
                      attn_fn: Optional[AttnFn] = None,
                      positions: Optional[torch.Tensor] = None,
                      tp_group: Optional[RankGroup] = None,
                      ep_group: Optional[RankGroup] = None
                      ) -> tuple[torch.Tensor, dict]:
    """One residual block (attention + FF). Returns (x, aux): aux is
    empty for a dense layer and holds ``aux_loss`` and
    ``dispatch_fraction`` for an MoE layer. ``positions`` feed rope
    (default 0..T-1); ``attn_fn`` defaults to the window-aware causal
    oracle and receives the narrow GQA K/V. ``tp_group`` and
    ``ep_group`` as in the module docstring."""
    b, t, _ = x.shape
    if attn_fn is None:
        def attn_fn(q, k, v):
            return local_causal_attention(q, k, v, window=cfg.attn_window)
    # identity forward, the sum over tp backward: completes dL/dh across
    # the column-parallel shards
    h = tp_grad_boundary(rmsnorm(x, layer["ln1"]), tp_group)
    q, k, v = attention_projections(layer, h, cfg)
    if cfg.rope:
        if positions is None:
            positions = torch.arange(t, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    x = x + row_parallel_dense(attn_fn(q, k, v).reshape(b, t, -1),
                               layer["wo"], tp_group)
    h = rmsnorm(x, layer["ln2"])
    if "router" in layer:
        # the routed expert FF, replicated across tp (no boundary)
        y, aux = moe_ffn(h, layer, cfg.moe, ep_group)
        return x + y, aux
    hh = _dense_ff_hidden(layer, tp_grad_boundary(h, tp_group))
    return x + row_parallel_dense(hh, layer["w2"], tp_group), {}


def _merge_aux(total: dict, aux: dict) -> dict:
    if not aux:
        return total
    if not total:
        return {**aux, "_n_moe": 1.0}
    return {"aux_loss": total["aux_loss"] + aux["aux_loss"],
            "dispatch_fraction": total["dispatch_fraction"]
            + aux["dispatch_fraction"],
            "_n_moe": total["_n_moe"] + 1.0}


def _finalize_aux(total: dict, device) -> dict:
    """aux_loss stays a sum over the MoE layers, dispatch_fraction
    becomes their mean; with no MoE layer no load-balance loss and every
    token dispatched (the JAX ``_finalize_aux``)."""
    if not total:
        return {"aux_loss": torch.zeros((), device=device),
                "dispatch_fraction": torch.ones((), device=device)}
    return {"aux_loss": total["aux_loss"],
            "dispatch_fraction": total["dispatch_fraction"]
            / total["_n_moe"]}


def transformer_apply_with_aux(params: dict, tokens: torch.Tensor,
                               cfg: TransformerConfig,
                               positions: Optional[torch.Tensor] = None,
                               attn_fn: Optional[AttnFn] = None,
                               remat: bool = False,
                               tp_group: Optional[RankGroup] = None,
                               ep_group: Optional[RankGroup] = None
                               ) -> tuple[torch.Tensor, dict]:
    """tokens (B, T) int -> (logits (B, T, vocab), aux): ``aux_loss``
    (the MoE layers' load-balance losses summed) and
    ``dispatch_fraction`` (their mean; 1 with none). ``remat``
    checkpoints each block (``torch.utils.checkpoint``, non-reentrant):
    its activations are recomputed in the backward pass instead of
    stored; the gradients are the same."""
    t = tokens.shape[1]
    if positions is None:
        positions = torch.arange(t, device=tokens.device)
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos"][positions]
    aux_total: dict = {}
    for layer in params["layers"]:
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                transformer_block, layer, x, cfg, attn_fn, positions,
                tp_group, ep_group, use_reentrant=False)
        else:
            x, aux = transformer_block(layer, x, cfg, attn_fn, positions,
                                       tp_group, ep_group)
        aux_total = _merge_aux(aux_total, aux)
    logits = lm_logits(params, rmsnorm(x, params["out_norm"]), cfg)
    return logits, _finalize_aux(aux_total, tokens.device)


def transformer_apply(params: dict, tokens: torch.Tensor,
                      cfg: TransformerConfig,
                      positions: Optional[torch.Tensor] = None,
                      attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """tokens (B, T) int -> logits (B, T, vocab)."""
    return transformer_apply_with_aux(params, tokens, cfg, positions,
                                      attn_fn)[0]


def weighted_ce(logits: torch.Tensor, targets: torch.Tensor,
                weights: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed weighted cross-entropy (f32 log-softmax) and total weight."""
    if weights is None:
        weights = torch.ones(targets.shape, device=logits.device)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -(ll * weights).sum(), weights.sum()


def next_token_loss_and_aux(params: dict, tokens: torch.Tensor,
                            cfg: TransformerConfig,
                            positions: Optional[torch.Tensor] = None,
                            attn_fn: Optional[AttnFn] = None,
                            targets: Optional[torch.Tensor] = None,
                            weights: Optional[torch.Tensor] = None,
                            remat: bool = False,
                            tp_group: Optional[RankGroup] = None,
                            ep_group: Optional[RankGroup] = None
                            ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Weighted summed next-token cross-entropy, total weight and aux
    (sums, not means, so losses over several pieces combine exactly).
    Without ``targets`` the shift happens here (the last token has no
    target and is dropped); with them, ``weights`` masks the positions
    that do not count. The aux loss (0 for a dense model) is folded in
    scaled by the token weight, as the JAX function does, so the global
    mean stays exact when the ranks' sums are added."""
    logits, aux = transformer_apply_with_aux(params, tokens, cfg, positions,
                                             attn_fn, remat=remat,
                                             tp_group=tp_group,
                                             ep_group=ep_group)
    if targets is None:
        logits = logits[:, :-1]
        targets = tokens[:, 1:]
    ce_sum, w_sum = weighted_ce(logits, targets, weights)
    return ce_sum + aux["aux_loss"] * w_sum, w_sum, aux


def next_token_loss(params: dict, tokens: torch.Tensor,
                    cfg: TransformerConfig,
                    positions: Optional[torch.Tensor] = None,
                    attn_fn: Optional[AttnFn] = None,
                    targets: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum, weight_sum) wrapper over
    :func:`next_token_loss_and_aux`."""
    loss_sum, w_sum, _ = next_token_loss_and_aux(
        params, tokens, cfg, positions, attn_fn, targets=targets,
        weights=weights)
    return loss_sum, w_sum
