"""Speculative decoding: a draft proposes, the target verifies in one pass.

Counterpart of ``akka_allreduce_tpu/models/speculate.py``. A small draft
model proposes ``k`` tokens autoregressively and the target scores all
``k`` in one batched :func:`extend` forward. Greedy speculation emits the
target's greedy tokens for any draft (the draft changes how fast tokens
come, never which); :func:`speculative_sample` keeps the target's
sampling distribution by modified rejection.

The cache "rewind" is the position: a round writes up to ``k`` positions
past the emitted frontier, and the rejected ones are left in place,
masked by the position check and overwritten by the next round's writes
(the cache is updated in place, so nothing is ever cleared). Batch is 1:
speculation is the latency path. PyTorch runs eagerly, so the JAX
function's ``while_loop`` is a Python loop with one host readback a
round (the accepted count). An MoE target routes each call's tokens
through ``moe_ffn`` with every expert local, its capacity from the
call's own token count (as the JAX ``extend`` does): greedy speculation
emits the target's greedy tokens where that capacity does not bind.
"""

from __future__ import annotations

from typing import Optional

import torch

from akka_allreduce_tpu_torch.models import prng
from akka_allreduce_tpu_torch.models.generate import (
    apply_sample_filters,
    decode_step,
    init_kv_cache,
    prefill,
    read_kv,
    write_kv,
)
from akka_allreduce_tpu_torch.models.transformer import (
    TransformerConfig,
    apply_rope,
    attention_projections,
    feed_forward,
    lm_logits,
    rmsnorm,
)
from akka_allreduce_tpu_torch.parallel.ring_attention import NEG_INF


def _block_cached_attention(q: torch.Tensor, k_all: torch.Tensor,
                            v_all: torch.Tensor, pos: int,
                            window: "int | None" = None) -> torch.Tensor:
    """q (b, t, h, d) for positions pos..pos+t-1 against k_all/v_all
    (b, max_seq, h_kv, d) with the block's K/V written: query j sees
    cache positions <= pos + j (and > pos + j - window). Same scale
    form, f32 scores and softmax, and cast points as the one-token
    ``_cached_attention``."""
    b, t, h, d = q.shape
    h_kv = k_all.shape[2]
    g = h // h_kv
    qg = q.reshape(b, t, h_kv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k_all.float()) * scale
    k_idx = torch.arange(k_all.shape[1], device=q.device)
    q_pos = pos + torch.arange(t, device=q.device)
    valid = k_idx[None, :] <= q_pos[:, None]
    if window is not None:
        valid &= k_idx[None, :] > q_pos[:, None] - window
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def extend(params: dict, cache: dict, tokens: torch.Tensor,
           cfg: TransformerConfig) -> tuple[dict, torch.Tensor]:
    """Consume a (b, t) token block from ``cache["pos"]``; write its K/V
    in place and return (cache with pos + t, logits (b, t, vocab)) —
    ``logits[:, j]`` the next-token scores after ``tokens[:, :j+1]``.
    ``prefill`` is the pos = 0 case, ``decode_step`` the t = 1 one."""
    b, t = tokens.shape
    pos = cache["pos"]
    positions = pos + torch.arange(t, device=tokens.device)
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos"][pos:pos + t][None]
    for i, layer in enumerate(params["layers"]):
        q, k, v = attention_projections(layer, rmsnorm(x, layer["ln1"]),
                                        cfg)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        write_kv(cache, i, k, v, (slice(None), slice(pos, pos + t)))
        k_all, v_all = read_kv(cache, i, cfg.dtype)
        attn = _block_cached_attention(q, k_all, v_all, pos,
                                       window=cfg.attn_window)
        x = x + attn.reshape(b, t, -1) @ layer["wo"]
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]), cfg)
    logits = lm_logits(params, rmsnorm(x, params["out_norm"]), cfg)
    cache["pos"] = pos + t
    return cache, logits


def _check_spec(prompt: torch.Tensor, target_cfg: TransformerConfig,
                draft_cfg: TransformerConfig, steps: int, k: int) -> None:
    if prompt.shape[0] != 1:
        raise ValueError(
            "speculative decode is the batch-1 latency path; run the "
            f"plain decode for batch {prompt.shape[0]}")
    if not 1 <= k:
        raise ValueError(f"k must be >= 1, got {k}")
    if draft_cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft and target must share a vocabulary: "
            f"{draft_cfg.vocab_size} != {target_cfg.vocab_size}")
    need = prompt.shape[1] + steps + k
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if need > cfg.max_seq:
            # k of headroom past the emitted length: a final round
            # writes up to k positions past the frontier
            raise ValueError(
                f"{name} max_seq {cfg.max_seq} must cover prompt + "
                f"steps + k = {need} (speculation rounds write up to k "
                f"positions past the emitted frontier)")


def _prefill_both(target_params, draft_params, prompt, target_cfg,
                  draft_cfg):
    device = prompt.device
    t_cache, t_logits = prefill(
        target_params, init_kv_cache(target_cfg, 1, device=device),
        prompt, target_cfg)
    d_cache, _ = prefill(draft_params,
                         init_kv_cache(draft_cfg, 1, device=device),
                         prompt, draft_cfg)
    return t_cache, d_cache, t_logits


@torch.no_grad()
def speculative_generate(target_params: dict, draft_params: dict,
                         prompt: torch.Tensor,
                         target_cfg: TransformerConfig,
                         draft_cfg: TransformerConfig,
                         steps: int, k: int = 4,
                         eos_token: Optional[int] = None
                         ) -> tuple[torch.Tensor, dict]:
    """Greedy speculative decode: ``steps`` tokens after ``prompt``
    (1, t), the target's own greedy tokens. Returns ``(tokens (1,
    steps), stats)`` with ``rounds`` (target extends), ``drafted`` and
    ``accepted``; with ``eos_token`` the loop stops at the first EOS,
    later positions read ``eos_token`` and stats gains ``length``.

    Per round: the draft proposes g_1..g_k from the last emitted token
    ``cur``; the target consumes [cur, g_1..g_{k-1}] in one extend; the
    longest prefix where the draft guessed the target's argmax is
    accepted, plus the target's own token as a correction when it is
    shorter than k. Both caches rewind their position to the emitted
    frontier."""
    _check_spec(prompt, target_cfg, draft_cfg, steps, k)
    if eos_token is not None \
            and not 0 <= eos_token < target_cfg.vocab_size:
        raise ValueError(f"eos_token {eos_token} out of vocab "
                         f"[0, {target_cfg.vocab_size})")
    t_cache, d_cache, t_logits = _prefill_both(
        target_params, draft_params, prompt, target_cfg, draft_cfg)
    cur = t_logits.argmax(dim=-1).to(torch.int32)             # (1,)
    out = [int(cur[0])]
    done = eos_token is not None and out[0] == eos_token
    rounds = drafted = accepted = 0
    while len(out) < steps and not done:
        props = []
        tok = cur
        for _ in range(k):
            d_cache, dl = decode_step(draft_params, d_cache, tok,
                                      draft_cfg)
            tok = dl.argmax(dim=-1).to(torch.int32)
            props.append(tok)
        props = torch.cat(props)                              # (k,)
        block = torch.cat([cur, props[:-1]])[None]            # (1, k)
        t_cache, t_block = extend(target_params, t_cache, block,
                                  target_cfg)
        t_arg = t_block[0].argmax(dim=-1).to(torch.int32)
        match = (t_arg == props).tolist()
        n_acc = match.index(False) if False in match else k
        emit = props.tolist()[:n_acc] + (
            [int(t_arg[n_acc])] if n_acc < k else [])
        out += emit
        cur = torch.tensor([emit[-1]], dtype=torch.int32,
                           device=prompt.device)
        if eos_token is not None:
            done = eos_token in emit
        # rewind both caches to the emitted frontier: consumed tokens
        # are emitted - 1 (cur is emitted but not yet consumed)
        frontier = t_cache["pos"] - k + len(emit)
        t_cache["pos"] = d_cache["pos"] = frontier
        rounds += 1
        drafted += k
        accepted += n_acc
    stats = {"rounds": rounds, "drafted": drafted, "accepted": accepted}
    n_out = len(out)
    out = out[:steps]
    if eos_token is not None:
        # a final round can overshoot the first EOS: pad after it with
        # EOS, generate()'s done-row padding
        length = (out.index(eos_token) + 1 if eos_token in out
                  else min(n_out, steps))
        out = out[:length] + [eos_token] * (steps - length)
        stats["length"] = length
    return torch.tensor([out], dtype=torch.int32,
                        device=prompt.device), stats


def _residual_resample(p: torch.Tensor, q: torch.Tensor,
                       key: torch.Tensor) -> torch.Tensor:
    """Sample from the rejection residual ``norm(max(p - q, 0))`` — the
    distribution that makes draft-accept/resample exactly sampling from
    ``p``; ``p`` itself where the residual is zero (q == p)."""
    res = torch.clamp(p - q, min=0.0)
    total = res.sum()
    safe = torch.where(total > 0, res / torch.clamp(total, min=1e-30), p)
    return prng.categorical(key, torch.log(torch.clamp(safe, min=1e-30)))


def _filtered_probs(logits: torch.Tensor, temperature: float,
                    top_k: Optional[int],
                    top_p: Optional[float]) -> torch.Tensor:
    """logits (vocab,) -> the filtered sampling distribution, the
    pipeline ``generate`` samples from."""
    return torch.softmax(
        apply_sample_filters(logits[None], temperature, top_k, top_p),
        dim=-1)[0]


def _draw(key: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    return prng.categorical(key, torch.log(torch.clamp(probs, min=1e-30)))


@torch.no_grad()
def speculative_sample(target_params: dict, draft_params: dict,
                       prompt: torch.Tensor,
                       target_cfg: TransformerConfig,
                       draft_cfg: TransformerConfig,
                       steps: int, key: torch.Tensor, k: int = 4,
                       temperature: float = 1.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None
                       ) -> tuple[torch.Tensor, dict]:
    """Speculative sampling (temperature > 0) on JAX's key schedule: the
    draft proposes k tokens from its filtered distribution q, the target
    verifies in one extend, proposal j is accepted with probability
    ``min(1, p_j(x_j) / q_j(x_j))`` and the first rejection resamples
    from ``norm(max(p - q, 0))``. ``key`` is a ``models/prng.py`` key.
    Same loop, rewind, batch-1 restriction and stats as the greedy
    path."""
    _check_spec(prompt, target_cfg, draft_cfg, steps, k)
    if temperature <= 0.0:
        raise ValueError(
            "speculative_sample needs temperature > 0; use "
            "speculative_generate for greedy")
    device = prompt.device
    t_cache, d_cache, t_logits = _prefill_both(
        target_params, draft_params, prompt, target_cfg, draft_cfg)
    key = prng.wrap_key_data(key, device=device)
    ks = prng.split(key)
    key, k0 = ks[0], ks[1]
    p0 = _filtered_probs(t_logits[0], temperature, top_k, top_p)
    cur = _draw(k0, p0).to(torch.int32)[None]
    out = [int(cur[0])]
    rounds = drafted = accepted = 0
    while len(out) < steps:
        key, kd, ka, kr = prng.split(key, 4)
        props, qs = [], []
        tok = cur
        for kj in prng.split(kd, k):
            d_cache, dl = decode_step(draft_params, d_cache, tok,
                                      draft_cfg)
            qj = _filtered_probs(dl[0], temperature, top_k, top_p)
            tok = _draw(kj, qj).to(torch.int32)[None]
            props.append(tok)
            qs.append(qj)
        props = torch.cat(props)                              # (k,)
        qs = torch.stack(qs)                                  # (k, vocab)
        block = torch.cat([cur, props[:-1]])[None]
        t_cache, t_block = extend(target_params, t_cache, block,
                                  target_cfg)
        ps = torch.stack([_filtered_probs(lg, temperature, top_k, top_p)
                          for lg in t_block[0]])              # (k, vocab)
        idx = torch.arange(k, device=device)
        p_at = ps[idx, props.long()]
        q_at = qs[idx, props.long()]
        u = prng.uniform(ka, (k,))
        ok = (u * q_at < p_at).tolist()
        n_acc = ok.index(False) if False in ok else k
        n_res = min(n_acc, k - 1)
        resample = int(_residual_resample(ps[n_res], qs[n_res], kr))
        emit = props.tolist()[:n_acc] + ([resample] if n_acc < k else [])
        out += emit
        cur = torch.tensor([emit[-1]], dtype=torch.int32, device=device)
        frontier = t_cache["pos"] - k + len(emit)
        t_cache["pos"] = d_cache["pos"] = frontier
        rounds += 1
        drafted += k
        accepted += n_acc
    stats = {"rounds": rounds, "drafted": drafted, "accepted": accepted}
    return torch.tensor([out[:steps]], dtype=torch.int32,
                        device=device), stats
