"""Autoregressive decoding for the port's transformer: KV cache, greedy
and seeded sampling.

Counterpart of ``akka_allreduce_tpu/models/generate.py``: the slot cache
``(layers, batch, max_seq, kv_heads, head_dim)``, the serving engine's
page pool ``(layers, num_pages, page_size, kv_heads, head_dim)``, each in
the model dtype or as int8 with one f32 scale per written (position,
head) vector (``quantize_kv``; the ``k_scale``/``v_scale`` entries are
the format switch), one-token :func:`decode_step`, batched
:func:`prefill`, the masked block decode :func:`multi_step_decode`, the
sampling filters and :func:`generate`. Same block math and cast points
as the JAX functions; PyTorch runs eagerly, so the decode loops are
Python loops and caches update in place. Sampling draws its noise from
``models/prng.py``, a copy of JAX's threefry, with JAX's key schedule
(:func:`sample_step_key`), so a sampled stream is JAX's token for token
wherever the perturbed scores are not a tie.

An MoE layer's FF is ``moe_ffn`` with every expert local, on exactly the
tensor the JAX function routes: its capacity comes from that call's own
token count, so a full forward over t tokens may drop a popular expert's
overflow where one-token decode does not (the JAX module's documented
exception; parity is exact wherever capacity does not bind).
"""

from __future__ import annotations

from typing import Optional

import torch

from akka_allreduce_tpu_torch.models import prng
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


def _zeroed_kv(shape: tuple, cfg: TransformerConfig,
               kv_dtype: "str | None", device) -> dict:
    """Zeroed K and V of ``shape`` in the model dtype, or int8 with their
    f32 scales (``shape[:-1]``) when ``kv_dtype="int8"``."""
    if kv_dtype is not None and str(kv_dtype) != "int8":
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} "
                         f"(None = model dtype, or 'int8')")
    if kv_dtype is None:
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)}


def init_kv_cache(cfg: TransformerConfig, batch: int,
                  device: "torch.device | str" = "cpu",
                  kv_dtype: "str | None" = None) -> dict:
    """Zeroed (layers, batch, max_seq, kv_heads, head_dim) K and V in the
    model dtype, plus the write position ``pos`` (a Python int).
    ``kv_dtype="int8"`` stores symmetric int8 values with one f32 scale
    per written (position, head) vector in ``k_scale``/``v_scale``
    (layers, batch, max_seq, kv_heads): a quarter of the f32 cache bytes
    at a bounded logit error."""
    shape = (cfg.n_layers, batch, cfg.max_seq, cfg.kv_heads, cfg.head_dim)
    return {**_zeroed_kv(shape, cfg, kv_dtype, device), "pos": 0}


def init_kv_pool(cfg: TransformerConfig, num_pages: int, page_size: int,
                 device: "torch.device | str" = "cpu",
                 kv_dtype: "str | None" = None) -> dict:
    """The paged twin of :func:`init_kv_cache`: one flat
    (layers, num_pages, page_size, kv_heads, head_dim) K and V pool shared
    by every request through per-request page tables, int8 with
    (layers, num_pages, page_size, kv_heads) scales under
    ``kv_dtype="int8"``. No ``pos``: positions are per-request host state
    in the paged engine."""
    if num_pages < 1 or page_size < 1:
        raise ValueError(f"num_pages/page_size must be >= 1, got "
                         f"{num_pages}/{page_size}")
    shape = (cfg.n_layers, num_pages, page_size, cfg.kv_heads,
             cfg.head_dim)
    return _zeroed_kv(shape, cfg, kv_dtype, device)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., head_dim) -> (int8 values, f32 scales (...,)): the scale is
    abs-max / 127 floored at 1e-30, the rounding to nearest (ties to
    even) and clipped to [-127, 127], as the JAX function."""
    xf = x.float()
    scales = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scales[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, cast to the compute ``dtype``."""
    return (values.float() * scales[..., None]).to(dtype)


def write_kv(cache: dict, layer: int, k: torch.Tensor, v: torch.Tensor,
             index: tuple) -> None:
    """Write ``k``/``v`` at ``cache[name][layer][index]`` in place, cast
    to a float cache's dtype or quantized (values and scales) for an
    int8 cache."""
    if "k_scale" in cache:
        for name, x in (("k", k), ("v", v)):
            q, s = quantize_kv(x)
            cache[name][layer][index] = q
            cache[name + "_scale"][layer][index] = s
    else:
        cache["k"][layer][index] = k.to(cache["k"].dtype)
        cache["v"][layer][index] = v.to(cache["v"].dtype)


def read_kv(cache: dict, layer: int, dtype: torch.dtype
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's K and V as the attention reads them: dequantized to
    ``dtype`` from an int8 cache, as they are from a float one."""
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"][layer], cache["k_scale"][layer],
                              dtype),
                dequantize_kv(cache["v"][layer], cache["v_scale"][layer],
                              dtype))
    return cache["k"][layer], cache["v"][layer]


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
    (quantized for an int8 cache) and return (cache with pos + 1, logits
    (b, vocab))."""
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
        write_kv(cache, i, k[:, 0], v[:, 0], (slice(None), pos))
        k_all, v_all = read_kv(cache, i, cfg.dtype)
        attn = _cached_attention(q, k_all, v_all, pos,
                                 window=cfg.attn_window)
        x = x + attn.reshape(b, 1, -1) @ layer["wo"]
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]), cfg)
    logits = lm_logits(params, rmsnorm(x, params["out_norm"]), cfg)
    cache["pos"] = pos + 1
    return cache, logits[:, 0, :]


def prefill_kv(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
               logit_pos: "int | None" = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched forward over ``prompt`` (b, t). Returns the prompt's
    K and V, each (layers, b, t, kv_heads, head_dim), and the logits
    (b, vocab) at ``logit_pos`` (default the last position: the bucketed
    prefill of the engine reads a padded prompt's logits at its true
    last position). Prompt positions attend the fresh block K/V, so the
    logits equal the full forward's under either cache format."""
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
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]), cfg)
    at = t - 1 if logit_pos is None else logit_pos
    logits = lm_logits(params, rmsnorm(x[:, at:at + 1], params["out_norm"]),
                       cfg)
    return torch.stack(ks), torch.stack(vs), logits[:, 0, :]


def prefill(params: dict, cache: dict, prompt: torch.Tensor,
            cfg: TransformerConfig) -> tuple[dict, torch.Tensor]:
    """Fill the cache from ``prompt`` (b, t) in one batched forward; return
    (cache with pos = t, the last position's logits). The cache is written
    in place (quantized for an int8 cache)."""
    t = prompt.shape[1]
    k, v, logits = prefill_kv(params, prompt, cfg)
    for i in range(cfg.n_layers):
        write_kv(cache, i, k[i], v[i], (slice(None), slice(0, t)))
    cache["pos"] = t
    return cache, logits


def multi_step_decode(params: dict, kv: dict, logits: torch.Tensor,
                      pos: torch.Tensor, done: torch.Tensor,
                      remaining: torch.Tensor, eos_ids: torch.Tensor,
                      stop_ids: torch.Tensor, steps: int, decode_fn,
                      sample: Optional[tuple] = None,
                      key_data: Optional[torch.Tensor] = None,
                      step_idx: Optional[torch.Tensor] = None):
    """``steps`` decode steps with per-lane finish handling on the device
    — the JAX function's ``lax.scan`` as a loop of device ops with no
    host readback inside it.

    Per step and lane: latch ``bad``/``done`` if the carried logits are
    not finite; emit ``argmax`` or, with ``sample`` (the ``(temperature,
    top_k, top_p)`` triple), :func:`sample_token_rows` over the lanes'
    keys ``key_data`` (lanes, 2) and emitted-token indices ``step_idx``
    (lanes,), which advance where a lane was active; latch ``done`` on
    the lane's EOS, a stop id, or its last budgeted token; run
    ``decode_fn(params, kv, tok, pos, live)`` for every lane, where a
    frozen lane neither writes KV nor advances ``pos``. ``eos_ids``
    (lanes,) and ``stop_ids`` (lanes, K) use -1 for none. Returns ``((kv,
    logits, pos, done, remaining, bad), tokens (steps, lanes))``, the
    carry growing a trailing ``step_idx`` when sampled; entries after a
    lane's latch are garbage."""
    bad = torch.zeros_like(done)
    toks = []
    for _ in range(steps):
        poisoned = ~done & ~torch.isfinite(logits).all(dim=-1)
        bad = bad | poisoned
        done = done | poisoned
        if sample is None:
            tok = logits.argmax(dim=-1).to(torch.int32)
        else:
            tok = sample_token_rows(key_data, logits, step_idx, sample)
        active = ~done
        finished = active & ((tok == eos_ids)
                             | (stop_ids == tok[:, None]).any(dim=1)
                             | (remaining <= 1))
        live = active & ~finished
        remaining = torch.where(active, remaining - 1, remaining)
        if sample is not None:
            step_idx = torch.where(active, step_idx + 1, step_idx)
        done = done | finished
        kv, logits = decode_fn(params, kv, tok, pos, live)
        pos = torch.where(live, pos + 1, pos)
        toks.append(tok)
    carry = (kv, logits, pos, done, remaining, bad)
    if sample is not None:
        carry += (step_idx,)
    return carry, torch.stack(toks)


def _filter_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the ``top_k`` largest logits per row, NEG_INF the rest (ties
    at the threshold are kept)."""
    vals = torch.topk(logits, top_k, dim=-1).values
    return torch.where(logits < vals[..., -1:], NEG_INF, logits)


def apply_sample_filters(logits: torch.Tensor, temperature: float,
                         top_k: Optional[int],
                         top_p: Optional[float]) -> torch.Tensor:
    """Temperature scaling, then the optional top-k and top-p (nucleus)
    filters, row-wise over ``(..., vocab)``: the pipeline every sampled
    path shares (``generate``, the engines' lanes, speculation). Each
    filter reduces only over the vocab axis, so a row's result does not
    depend on the rows beside it."""
    x = logits / temperature
    if top_k is not None and top_k < x.shape[-1]:
        x = _filter_top_k(x, top_k)
    if top_p is not None and top_p < 1.0:
        x = _filter_top_p(x, top_p)
    return x


def sample_step_key(key: torch.Tensor, idx) -> torch.Tensor:
    """Token ``idx``'s sampling key: ``fold_in(base, idx)``, counting
    generated tokens from 0. It depends on nothing but (base key, idx),
    so the engine's block partition of a decode cannot change a stream.
    ``key`` may be a batch of keys with ``idx`` one per key."""
    return prng.fold_in(key, idx)


def sample_token_rows(key_data: torch.Tensor, logits: torch.Tensor,
                      idx: torch.Tensor, sample: tuple) -> torch.Tensor:
    """Per-lane sampled pick: row ``s`` of ``logits`` (lanes, vocab)
    samples with ``sample_step_key(key_data[s], idx[s])`` over a
    ``(1, vocab)`` row, the shape ``generate``'s batch-1 pick draws at,
    so a lane's tokens are ``generate(key=key_s)``'s. One threefry pass
    draws every lane's noise."""
    temperature, top_k, top_p = sample
    filtered = apply_sample_filters(logits, temperature, top_k, top_p)
    keys = sample_step_key(prng.wrap_key_data(key_data), idx)
    return prng.categorical(keys, filtered[:, None, :])[:, 0].to(
        torch.int32)


def _filter_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens whose probability
    mass reaches ``top_p`` — found on the descending sort through an
    exclusive cumulative sum (the token that crosses the boundary stays
    in) and applied to the unsorted logits through the threshold logit."""
    sorted_desc = -torch.sort(-logits, dim=-1).values
    probs = torch.softmax(sorted_desc, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    drop = mass_before >= top_p  # never drops the first token
    thresh = torch.where(drop, torch.inf, sorted_desc).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


@torch.no_grad()
def generate(params: dict, prompt: torch.Tensor, cfg: TransformerConfig,
             steps: int, key: Optional[torch.Tensor] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             eos_token: Optional[int] = None,
             kv_dtype: Optional[str] = None):
    """Generate ``steps`` tokens after ``prompt`` (b, t) int. Greedy when
    ``temperature == 0``, else sampling with the filters of
    :func:`apply_sample_filters`: token j draws
    ``categorical(sample_step_key(key, j), filtered (b, vocab))`` with
    one key for the batch (``key`` a ``models/prng.py`` key, default
    ``prng.key(0)``). Returns (b, steps) int32; with ``eos_token`` a
    finished row keeps emitting it and the return is ``(tokens,
    lengths)``, ``lengths[i]`` counting tokens through the first EOS.
    ``kv_dtype="int8"`` decodes against the quantized cache."""
    if prompt.shape[1] + steps > cfg.max_seq:
        raise ValueError(
            f"prompt {prompt.shape[1]} + steps {steps} exceeds "
            f"max_seq {cfg.max_seq}")
    if top_k is not None and not 1 <= top_k:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_token is not None and not 0 <= eos_token < cfg.vocab_size:
        raise ValueError(f"eos_token {eos_token} out of vocab "
                         f"[0, {cfg.vocab_size})")
    b = prompt.shape[0]
    cache = init_kv_cache(cfg, b, device=prompt.device, kv_dtype=kv_dtype)
    cache, logits = prefill(params, cache, prompt, cfg)
    if key is None:
        key = prng.key(0)
    key = prng.wrap_key_data(key, device=prompt.device)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    out = []
    for j in range(steps):
        if temperature == 0.0:
            tok = logits.argmax(dim=-1).to(torch.int32)
        else:
            filtered = apply_sample_filters(logits, temperature, top_k,
                                            top_p)
            tok = prng.categorical(sample_step_key(key, j), filtered).to(
                torch.int32)
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
