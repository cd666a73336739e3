"""Autoregressive decoding for the port's transformer: KV cache, greedy.

Counterpart of ``akka_allreduce_tpu/models/generate.py`` for float
caches: the slot cache ``(layers, batch, max_seq, kv_heads, head_dim)``,
the serving engine's page pool ``(layers, num_pages, page_size,
kv_heads, head_dim)``, one-token :func:`decode_step`, batched
:func:`prefill`, the masked block decode :func:`multi_step_decode`, and
greedy :func:`generate`. Same block math and cast points as the JAX
functions; PyTorch runs eagerly, so the decode loops are Python loops
and caches update in place. The int8 cache and sampling are later
slices of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from akka_allreduce_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_rope,
    attention_projections,
    feed_forward,
    lm_logits,
    rmsnorm,
)
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    NEG_INF,
    local_causal_attention,
)


def init_kv_cache(cfg: TransformerConfig, batch: int,
                  device: "torch.device | str" = "cpu") -> dict:
    """Zeroed (layers, batch, max_seq, kv_heads, head_dim) K and V in the
    model dtype, plus the write position ``pos`` (a Python int)."""
    shape = (cfg.n_layers, batch, cfg.max_seq, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def init_kv_pool(cfg: TransformerConfig, num_pages: int, page_size: int,
                 device: "torch.device | str" = "cpu") -> dict:
    """The paged twin of :func:`init_kv_cache`: one flat
    (layers, num_pages, page_size, kv_heads, head_dim) K and V pool shared
    by every request through per-request page tables. No ``pos``:
    positions are per-request host state in the paged engine."""
    if num_pages < 1 or page_size < 1:
        raise ValueError(f"num_pages/page_size must be >= 1, got "
                         f"{num_pages}/{page_size}")
    shape = (cfg.n_layers, num_pages, page_size, cfg.kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _cached_attention(q: torch.Tensor, k_all: torch.Tensor,
                      v_all: torch.Tensor, pos: int,
                      window: "int | None" = None) -> torch.Tensor:
    """q (b, 1, h, d) against the static cache k_all/v_all
    (b, max_seq, h_kv, d), positions <= pos valid (and > pos - window).
    A grouped einsum against the narrow cache: no repeated K/V."""
    b, one, h, d = q.shape
    h_kv = k_all.shape[2]
    g = h // h_kv
    qg = q.reshape(b, one, h_kv, g, d)
    scale = d ** -0.5
    k_idx = torch.arange(k_all.shape[1], device=q.device)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k_all.float()) * scale
    valid = k_idx <= pos
    if window is not None:
        valid &= k_idx > pos - window
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.reshape(b, one, h, d).to(q.dtype)


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cfg: TransformerConfig) -> tuple[dict, torch.Tensor]:
    """Consume ``token`` (b,) at ``cache["pos"]``; write its K/V in place
    and return (cache with pos + 1, logits (b, vocab))."""
    b = token.shape[0]
    pos = cache["pos"]
    positions = torch.tensor([pos], device=token.device)
    x = params["embed"][token][:, None, :]
    if not cfg.rope:
        x = x + params["pos"][pos][None, None, :]
    for i, layer in enumerate(params["layers"]):
        q, k, v = attention_projections(layer, rmsnorm(x, layer["ln1"]),
                                        cfg)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        cache["k"][i, :, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][i, :, pos] = v[:, 0].to(cache["v"].dtype)
        attn = _cached_attention(q, cache["k"][i], cache["v"][i], pos,
                                 window=cfg.attn_window)
        x = x + attn.reshape(b, 1, -1) @ layer["wo"]
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]))
    logits = lm_logits(params, rmsnorm(x, params["out_norm"]), cfg)
    cache["pos"] = pos + 1
    return cache, logits[:, 0, :]


def prefill_kv(params: dict, prompt: torch.Tensor, cfg: TransformerConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched forward over ``prompt`` (b, t). Returns the prompt's
    K and V, each (layers, b, t, kv_heads, head_dim), and the last
    position's logits (b, vocab). Prompt positions attend the fresh block
    K/V, so the logits equal the full forward's."""
    b, t = prompt.shape
    positions = torch.arange(t, device=prompt.device)
    x = params["embed"][prompt]
    if not cfg.rope:
        x = x + params["pos"][:t][None]
    ks, vs = [], []
    for layer in params["layers"]:
        q, k, v = attention_projections(layer, rmsnorm(x, layer["ln1"]),
                                        cfg)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        ks.append(k)
        vs.append(v)
        attn = local_causal_attention(q, k, v, window=cfg.attn_window)
        x = x + attn.reshape(b, t, -1) @ layer["wo"]
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]))
    logits = lm_logits(params, rmsnorm(x[:, -1:], params["out_norm"]), cfg)
    return torch.stack(ks), torch.stack(vs), logits[:, 0, :]


def prefill(params: dict, cache: dict, prompt: torch.Tensor,
            cfg: TransformerConfig) -> tuple[dict, torch.Tensor]:
    """Fill the cache from ``prompt`` (b, t) in one batched forward; return
    (cache with pos = t, the last position's logits). The cache is written
    in place."""
    t = prompt.shape[1]
    k, v, logits = prefill_kv(params, prompt, cfg)
    cache["k"][:, :, :t] = k.to(cache["k"].dtype)
    cache["v"][:, :, :t] = v.to(cache["v"].dtype)
    cache["pos"] = t
    return cache, logits


def multi_step_decode(params: dict, kv: dict, logits: torch.Tensor,
                      pos: torch.Tensor, done: torch.Tensor,
                      remaining: torch.Tensor, eos_ids: torch.Tensor,
                      stop_ids: torch.Tensor, steps: int, decode_fn):
    """``steps`` greedy decode steps with per-lane finish handling on the
    device — the JAX function's ``lax.scan`` as a loop of device ops with
    no host readback inside it.

    Per step and lane: latch ``bad``/``done`` if the carried logits are
    not finite; emit ``argmax``; latch ``done`` on the lane's EOS, a stop
    id, or its last budgeted token; run ``decode_fn(params, kv, tok, pos,
    live)`` for every lane, where a frozen lane neither writes KV nor
    advances ``pos``. ``eos_ids`` (lanes,) and ``stop_ids`` (lanes, K) use
    -1 for none. Returns ``((kv, logits, pos, done, remaining, bad),
    tokens (steps, lanes))``; entries after a lane's latch are garbage."""
    bad = torch.zeros_like(done)
    toks = []
    for _ in range(steps):
        poisoned = ~done & ~torch.isfinite(logits).all(dim=-1)
        bad = bad | poisoned
        done = done | poisoned
        tok = logits.argmax(dim=-1).to(torch.int32)
        active = ~done
        finished = active & ((tok == eos_ids)
                             | (stop_ids == tok[:, None]).any(dim=1)
                             | (remaining <= 1))
        live = active & ~finished
        remaining = torch.where(active, remaining - 1, remaining)
        done = done | finished
        kv, logits = decode_fn(params, kv, tok, pos, live)
        pos = torch.where(live, pos + 1, pos)
        toks.append(tok)
    return (kv, logits, pos, done, remaining, bad), torch.stack(toks)


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
             steps: int, eos_token: Optional[int] = None):
    """Greedily generate ``steps`` tokens after ``prompt`` (b, t) int.
    Returns (b, steps) int32; with ``eos_token`` a finished row keeps
    emitting it and the return is ``(tokens, lengths)``, ``lengths[i]``
    counting tokens through the first EOS."""
    if prompt.shape[1] + steps > cfg.max_seq:
        raise ValueError(
            f"prompt {prompt.shape[1]} + steps {steps} exceeds "
            f"max_seq {cfg.max_seq}")
    if eos_token is not None and not 0 <= eos_token < cfg.vocab_size:
        raise ValueError(f"eos_token {eos_token} out of vocab "
                         f"[0, {cfg.vocab_size})")
    b = prompt.shape[0]
    cache = init_kv_cache(cfg, b, device=prompt.device)
    cache, logits = prefill(params, cache, prompt, cfg)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    out = []
    for _ in range(steps):
        tok = logits.argmax(dim=-1).to(torch.int32)
        if eos_token is not None:
            tok = torch.where(done, torch.full_like(tok, eos_token), tok)
            done = done | (tok == eos_token)
        cache, logits = decode_step(params, cache, tok, cfg)
        out.append(tok)
    tokens = torch.stack(out, dim=1)
    if eos_token is None:
        return tokens
    hit = tokens == eos_token
    lengths = torch.where(hit.any(dim=1),
                          hit.int().argmax(dim=1) + 1,
                          torch.full((b,), steps, device=prompt.device))
    return tokens, lengths.to(torch.int32)
