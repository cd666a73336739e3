"""Continuous-batching decode engine of the port: slots, pages, drafts.

Counterpart of ``akka_allreduce_tpu/serving/engine.py``. The host loop
is the JAX engine's: a fixed array of decode lanes, one batched step
advancing every occupied lane at its own position, a lane freed the
moment its request finishes (EOS, stop token, budget, or a deadline
that passed mid-flight) and refilled by prefilling the next queued
prompt.

* :class:`ServingEngine` keeps per-slot ``max_seq`` cache rows, in the
  model dtype or int8 with per-(position, head) scales
  (``kv_dtype="int8"``), and prefills exact-length or padded up to a
  bucket (``prefill_buckets``).
* :class:`PagedServingEngine` keeps K/V in one flat page pool
  ``(layers, num_pages, page_size, kv_heads, head_dim)`` addressed
  through per-lane int32 page tables (serving/paging.py owns the
  allocation); admission is gated on free pages, shared prompt prefixes
  are stored once and split copy-on-write before the first divergent
  write. ``attention_impl="gather"`` reads the pool through
  ``paged_gather_kv`` and the slot engine's masked-softmax formula;
  ``"kernel"`` runs ``ops/kernels/attention.py paged_attention`` — the
  CUDA kernel on a CUDA pool, its plain version on a CPU pool (float
  pools only, one query a lane, as JAX's ``"pallas"``).
* :class:`SpeculativeEngine` and :class:`PagedSpeculativeEngine`
  replace every decode dispatch by a draft-verify block: a draft model
  proposes ``draft_steps`` tokens a lane, one target extend scores the
  anchor and every proposal, and each lane emits its accepted prefix.
  Rejected positions are left in the cache behind the lane's position,
  masked, and overwritten by the next block: the rewind is the position
  vector. Greedy output is the plain greedy engine's wherever an MoE
  target's expert capacity does not bind: the verify extend routes its
  block's tokens with a capacity from their own count (reference fault
  C5; MoE parity on speculation uses a generous ``capacity_factor``).

With ``temperature > 0`` every pick samples: lane s's token j draws with
``fold_in(key(seed), j)``, the seed being the request's ``seed`` (its
``rid`` when unset), never the slot, through ``models/prng.py``'s copy
of JAX's threefry — so a request's stream is ``generate``'s with that
key whatever lane, neighbours or block size it meets.

What differs from the JAX engine:

* PyTorch runs eagerly, so a dispatch is a sequence of device ops with
  one host readback at its end: ``decode_steps=S`` loops S steps on the
  device (``multi_step_decode``) and reads one ``(S+2, lanes)`` block.
* The KV arrays are updated in place (where JAX donates its state); the
  pool keeps the JAX layout, which the kernel reads as it is.
* The per-lane vectors are uploaded before every block instead of
  carried as device outputs between blocks.

Faults (the JAX engine's story, ``runtime/faults.py`` sites
``<site_prefix>.dispatch`` and ``<site_prefix>.logits``): a lane whose
logits turn non-finite fails its request (``nan``), not the engine; with
``watchdog_timeout_s`` every decode dispatch runs, readback included, on
a guard thread, and a dispatch that is not back in time
(:class:`WatchdogTimeout`) or raises an injected fault fails every
in-flight request into the scheduler's retry budget and rebuilds the
device state (``_recover``): fresh caches from ``_fresh_state()``, pages
released through ``_free_slot``. The live pool is never zeroed in place,
and every operand of a dispatch (state dict, position and lane vectors,
page tables) is taken before it is submitted, so a dispatch that wakes
after it was abandoned writes only into the tensors it was given. The
guard thread enters the engine's CUDA stream (recorded when the engine
is built) and ``no_grad``, both thread-local. What the watchdog can do on
a GPU: turn a host-side stall (an injected hang, a host late to read
back) into recovery. A kernel that never returns still holds the
stream, and the rebuilt engine's next dispatch queues behind it; the
watchdog then trips again and again until the retry budget
dead-letters the requests. A CUDA error, a failed kernel build or a
failed launch is no injected fault: it propagates and fails the run.
Recovery never moves the engine to the CPU or the kernel path to the
gather path.

Preemption: :meth:`ServingEngine.request_drain` (a SIGTERM handler, the
preemption watcher, or an injected ``preempt`` at ``serve.loop``) makes
``serve_loop`` snapshot every in-flight request as a
:class:`ResumableRequest` (prompt + tokens so far) and return;
``persist_drained`` / ``load_drained`` carry them across a process
boundary in the JAX package's JSON layout, and ``restore`` replays
prompt + generated through prefill and decodes the rest of the budget
(a sampled lane resumes at its emitted-token index, with its request's
own key).

Tracing: with a ``tracer`` every decode dispatch is a ``serve_step``
span and every prefill a ``serve_prefill`` span; recoveries and drains
are ``serve_recover`` / ``serve_drain`` records and COW splits
``serve_cow_split``. ``device_time_summary`` splits each decode
dispatch into host (launch) and device (blocking readback) wall time
(telemetry/device.py).
"""

from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from akka_allreduce_tpu_torch.models import prng
from akka_allreduce_tpu_torch.models.generate import (
    apply_sample_filters,
    dequantize_kv,
    init_kv_cache,
    init_kv_pool,
    multi_step_decode,
    prefill_kv,
    quantize_kv,
    read_kv,
    sample_step_key,
    sample_token_rows,
)
from akka_allreduce_tpu_torch.models.transformer import (
    TransformerConfig,
    attention_projections,
    feed_forward,
    lm_logits,
    rmsnorm,
    rope_angles,
    rotate_half_split,
)
from akka_allreduce_tpu_torch.ops.kernels import attention as kernels
from akka_allreduce_tpu_torch.parallel.ring_attention import NEG_INF
from akka_allreduce_tpu_torch.runtime.faults import InjectedFault, maybe_fail
from akka_allreduce_tpu_torch.serving.paging import PagePool, pages_for
from akka_allreduce_tpu_torch.serving.scheduler import (
    Request,
    RequestScheduler,
)

# static width of the per-lane stop-id matrix the block programs carry
# (the JAX EngineConfig.max_stop_tokens default)
MAX_STOP_TOKENS = 4


class WatchdogTimeout(RuntimeError):
    """The decode dispatch and its readback exceeded
    ``watchdog_timeout_s``."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape knobs (the JAX config's).

    ``prefill_buckets``: strictly increasing prompt-length buckets; a
    prompt pads up to the smallest covering one and its logits are read
    at its true last position (ulp-level drift against exact-length
    prefill). Empty: exact-length prefill.

    ``kv_dtype="int8"``: the quantized cache (models/generate.py
    ``init_kv_cache``), a quarter of the f32 cache bytes at a bounded
    logit error.

    ``decode_steps=S``: S decode steps per dispatch with the finish latch
    on the device and one readback per block. ``max_stop_tokens`` is the
    block's static stop-id width.

    ``temperature`` / ``top_k`` / ``top_p``: temperature > 0 samples
    every pick with the request's key (``sample``); 0 is greedy.

    ``draft_steps`` > 0 arms speculation (the speculative engines); it
    excludes ``decode_steps > 1`` and ``prefill_buckets``.

    ``watchdog_timeout_s``: bound on a decode dispatch and its blocking
    readback. None dispatches inline; set, every decode dispatch runs on
    a guard thread and one not back in time raises
    :class:`WatchdogTimeout`, which the engine turns into per-request
    failures and a rebuilt state. Size it at several times the worst
    healthy dispatch, and arm it after a warm-up."""

    num_slots: int = 4
    prefill_buckets: tuple = ()
    kv_dtype: Optional[str] = None
    decode_steps: int = 1
    max_stop_tokens: int = MAX_STOP_TOKENS
    watchdog_timeout_s: Optional[float] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    draft_steps: int = 0

    @property
    def sample(self) -> Optional[tuple]:
        """The ``(temperature, top_k, top_p)`` triple the sampled picks
        take; None (greedy) at temperature 0."""
        if self.temperature == 0.0:
            return None
        return (self.temperature, self.top_k, self.top_p)

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, "
                             f"got {self.num_slots}")
        if self.watchdog_timeout_s is not None \
                and self.watchdog_timeout_s <= 0:
            raise ValueError(f"watchdog_timeout_s must be > 0, "
                             f"got {self.watchdog_timeout_s}")
        if self.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, "
                             f"got {self.decode_steps}")
        if self.max_stop_tokens < 1:
            raise ValueError(f"max_stop_tokens must be >= 1, "
                             f"got {self.max_stop_tokens}")
        if list(self.prefill_buckets) != sorted(set(
                self.prefill_buckets)) or any(
                b < 1 for b in self.prefill_buckets):
            raise ValueError(
                f"prefill_buckets must be strictly increasing positive "
                f"lengths, got {self.prefill_buckets}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), "
                             f"got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], "
                             f"got {self.top_p}")
        if self.draft_steps < 0:
            raise ValueError(f"draft_steps must be >= 0 (0 = not "
                             f"speculative), got {self.draft_steps}")
        if self.draft_steps > 0 and self.decode_steps > 1:
            raise ValueError(
                "draft_steps and decode_steps > 1 are both block "
                "modes — a speculative block already verifies "
                "draft_steps + 1 tokens per dispatch; pick one")
        if self.draft_steps > 0 and self.prefill_buckets:
            raise ValueError(
                "prefill_buckets is a plain-engine knob; speculative "
                "prefill is exact-length (the parity mode)")


@dataclasses.dataclass(frozen=True)
class PagedEngineConfig(EngineConfig):
    """Knobs of :class:`PagedServingEngine`. ``num_slots`` is the decode
    lane count; ``page_size`` positions per page; ``num_pages`` the pool
    capacity (0 = ``num_slots * ceil(max_seq / page_size)``, the slot
    engine's equal budget; one scratch page is added for parked lanes);
    ``attention_impl`` the pool read path, ``"gather"`` or ``"kernel"``
    (the counterpart of the JAX engine's ``"pallas"``, refused with an
    int8 pool or speculation as JAX refuses ``"pallas"``). Paged prefill
    is exact-length: ``prefill_buckets`` is refused."""

    page_size: int = 16
    num_pages: int = 0
    attention_impl: str = "gather"

    def __post_init__(self):
        super().__post_init__()
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 0:
            raise ValueError(
                f"num_pages must be >= 0 (0 = auto), got "
                f"{self.num_pages}")
        if self.attention_impl not in ("gather", "kernel"):
            raise ValueError(
                f"attention_impl must be 'gather' or 'kernel', got "
                f"{self.attention_impl!r}")
        if self.prefill_buckets:
            raise ValueError(
                "prefill_buckets is a slot-engine knob; paged prefill "
                "is exact-length")
        if self.kv_dtype is not None and self.attention_impl == "kernel":
            raise ValueError(
                "attention_impl='kernel' reads float pools only; the "
                "int8 pool decodes through the gather path "
                "(dequantize-on-read)")
        if self.draft_steps > 0 and self.attention_impl == "kernel":
            raise ValueError(
                "attention_impl='kernel' is a single-query decode "
                "kernel; the speculative verify is a block extend — "
                "run speculation on the gather path")


_KV_KEYS = ("k", "v", "k_scale", "v_scale")
_DRAFT_PREFIX = "draft_"

# the slot engine's read path: the masked-softmax decode formula over a
# (slots, max_seq, h_kv, D) cache, row b masked by its own pos[b] — the
# same function the paged gather path runs over its gathered pages
_slot_cached_attention = kernels.decode_attention


def _slot_block_attention(q: torch.Tensor, k_all: torch.Tensor,
                          v_all: torch.Tensor, pos: torch.Tensor,
                          window: "int | None" = None) -> torch.Tensor:
    """``_slot_cached_attention`` for a block of queries: q (lanes, t, h,
    d) at positions ``pos[s] + j`` against k_all/v_all (lanes, L, h_kv,
    d) with the block's K/V written; query j of lane s sees positions
    ``<= pos[s] + j``. Same einsums, f32 scores and softmax, and cast
    points as the one-query form."""
    b, t, h, d = q.shape
    h_kv = k_all.shape[2]
    g = h // h_kv
    qg = q.reshape(b, t, h_kv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k_all.float()) * scale
    k_idx = torch.arange(k_all.shape[1], device=q.device)
    q_pos = pos[:, None] + torch.arange(t, device=q.device)[None, :]
    valid = k_idx[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        valid &= k_idx[None, None, :] > q_pos[:, :, None] - window
    scores = torch.where(valid[:, None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def _lane_forward(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
                  cfg: TransformerConfig, attend) -> torch.Tensor:
    """The block math shared by the decode steps (t = 1) and the verify
    extends: tokens (lanes, t) at positions ``pos[s] + j`` -> logits
    (lanes, t, vocab). ``attend(layer, q, k, v)`` writes the lanes' K/V
    and returns their attention output. Rope phases are computed once
    per call, per row position, in f32 (the JAX engine's
    ``_rope_slots``)."""
    s, t = tokens.shape
    positions = pos.long()[:, None] + torch.arange(t, device=pos.device)
    x = params["embed"][tokens]
    if not cfg.rope:
        x = x + params["pos"][positions]
    else:
        cos, sin = rope_angles(positions.reshape(-1), cfg.head_dim,
                               cfg.rope_theta)
        cos = cos.reshape(s, t, 1, -1)
        sin = sin.reshape(s, t, 1, -1)
    for i, layer in enumerate(params["layers"]):
        q, k, v = attention_projections(layer, rmsnorm(x, layer["ln1"]),
                                        cfg)
        if cfg.rope:
            q = rotate_half_split(q, cos, sin)
            k = rotate_half_split(k, cos, sin)
        attn = attend(i, q, k, v)
        x = x + attn.reshape(s, t, -1) @ layer["wo"]
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]), cfg)
    return lm_logits(params, rmsnorm(x, params["out_norm"]), cfg)


def _write_lane_kv(kv: dict, k: torch.Tensor, v: torch.Tensor,
                   write) -> None:
    """Hand ``write(tensor, vals)`` each lane's new K and V (lanes, h_kv,
    D): cast to a float cache's dtype, or quantized with its scales for
    an int8 cache (the pytree's keys are the format switch)."""
    if "k_scale" in kv:
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv(x)
            write(kv[name], xq)
            write(kv[name + "_scale"], xs)
    else:
        write(kv["k"], k.to(kv["k"].dtype))
        write(kv["v"], v.to(kv["v"].dtype))


def _lane_mask(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (vals.dim() - 1))


def _write_slot_rows(cache: torch.Tensor, layer: int, vals: torch.Tensor,
                     pos: torch.Tensor,
                     mask: "torch.Tensor | None" = None) -> None:
    """``cache[layer, s, pos[s]] = vals[s]`` for every slot, in place; a
    lane with ``mask`` False keeps its old value."""
    rows = torch.arange(vals.shape[0], device=vals.device)
    p = pos.long()
    if mask is not None:
        vals = torch.where(_lane_mask(mask, vals), vals,
                           cache[layer, rows, p])
    cache[layer, rows, p] = vals


def _slot_attend(kv: dict, pos: torch.Tensor, cfg: TransformerConfig,
                 write_mask: "torch.Tensor | None"):
    """The slot engines' ``attend``: write block position j of lane s at
    ``pos[s] + j`` of its cache row, then read the (dequantized) rows."""

    def attend(i, q, k, v):
        for j in range(q.shape[1]):
            _write_lane_kv(kv, k[:, j], v[:, j], lambda t, x: (
                _write_slot_rows(t, i, x, pos + j, write_mask)))
        k_all, v_all = read_kv(kv, i, cfg.dtype)
        if q.shape[1] == 1:
            return _slot_cached_attention(q, k_all, v_all, pos,
                                          window=cfg.attn_window)
        return _slot_block_attention(q, k_all, v_all, pos,
                                     window=cfg.attn_window)
    return attend


def _slot_decode_step(params: dict, kv: dict, token: torch.Tensor,
                      pos: torch.Tensor, cfg: TransformerConfig,
                      write_mask: "torch.Tensor | None" = None):
    """``decode_step`` with a per-slot position vector over the slot
    cache (layers, slots, max_seq, kv_heads, head_dim) [+ scales].
    Returns (kv, logits (slots, vocab))."""
    logits = _lane_forward(params, token[:, None], pos, cfg,
                           _slot_attend(kv, pos, cfg, write_mask))
    return kv, logits[:, 0]


def _slot_extend(params: dict, kv: dict, tokens: torch.Tensor,
                 pos: torch.Tensor, cfg: TransformerConfig,
                 write_mask: "torch.Tensor | None" = None):
    """models/speculate.py ``extend`` with a per-slot position vector:
    consume ``tokens`` (slots, t) from each slot's ``pos``; return (kv,
    logits (slots, t, vocab)), ``logits[s, j]`` the next-token scores
    after ``tokens[s, :j+1]``. ``write_mask`` freezes a lane's writes."""
    return kv, _lane_forward(params, tokens, pos, cfg,
                             _slot_attend(kv, pos, cfg, write_mask))


def _sampled_pick(logits: torch.Tensor, sample: Optional[tuple],
                  key_data, step_idx) -> torch.Tensor:
    if sample is None:
        return logits.argmax(dim=-1).to(torch.int32)
    return sample_token_rows(key_data, logits, step_idx, sample)


def _kv_view(state: dict) -> dict:
    return {n: state[n] for n in _KV_KEYS if n in state}


def _engine_step(params: dict, state: dict, pos: torch.Tensor, decode_fn,
                 sample: Optional[tuple] = None,
                 key_data: Optional[torch.Tensor] = None,
                 step_idx: Optional[torch.Tensor] = None):
    """One step for every lane: pick each lane's token from the carried
    logits (argmax, or with ``sample`` the lane's keyed draw at its
    emitted-token index), advance every lane at its own position through
    ``decode_fn(params, kv, tok, pos, write_mask)`` (the slot or paged
    lane step). Returns (state, packed (2, lanes) int32): the tokens, and
    the finite-output guard (1 iff the logits the token came from were
    all finite)."""
    logits_in = state["logits"]
    tok = _sampled_pick(logits_in, sample, key_data, step_idx)
    finite = torch.isfinite(logits_in).all(dim=-1)
    _, logits = decode_fn(params, _kv_view(state), tok, pos, None)
    state["logits"] = logits.to(logits_in.dtype)
    return state, torch.stack([tok, finite.to(torch.int32)])


def _engine_multi_step(params: dict, state: dict, pos: torch.Tensor,
                       done: torch.Tensor, remaining: torch.Tensor,
                       eos_ids: torch.Tensor, stop_ids: torch.Tensor,
                       steps: int, decode_fn,
                       sample: Optional[tuple] = None,
                       key_data: Optional[torch.Tensor] = None,
                       step_idx: Optional[torch.Tensor] = None):
    """``steps`` steps for every lane (``multi_step_decode`` over
    ``decode_fn``), free lanes marked ``done`` up front. Returns (state,
    packed (steps+2, lanes) int32): the token block, the post-block
    positions, and the per-lane ``bad`` (non-finite logits) flag."""
    carry, toks = multi_step_decode(
        params, _kv_view(state), state["logits"], pos, done, remaining,
        eos_ids, stop_ids, steps, decode_fn, sample=sample,
        key_data=key_data, step_idx=step_idx)
    logits, pos, bad = carry[1], carry[2], carry[5]
    state["logits"] = logits.to(state["logits"].dtype)
    return state, torch.cat([toks, pos[None], bad.to(torch.int32)[None]])


def _store_prompt_kv(dst: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's K and V (layers, n, h_kv, D) at positions [0, n)
    of ``dst``'s (layers, T, ...) rows, quantized for an int8 cache."""
    n = k.shape[1]
    if "k_scale" in dst:
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv(x)
            dst[name][:, :n] = xq
            dst[name + "_scale"][:, :n] = xs
    else:
        dst["k"][:, :n] = k.to(dst["k"].dtype)
        dst["v"][:, :n] = v.to(dst["v"].dtype)


def _prefill_slot_row(state: dict, slot: int, k: torch.Tensor,
                      v: torch.Tensor, prefix: str = "") -> None:
    """Clear ``slot``'s cache row (not merely mask it) and write the
    prompt's K/V (layers, 1, n, h_kv, D) into it."""
    row = {n: state[prefix + n][:, slot] for n in _KV_KEYS
           if prefix + n in state}
    for t in row.values():
        t.zero_()
    _store_prompt_kv(row, k[:, 0], v[:, 0])


def _engine_prefill(params: dict, state: dict, prompt: torch.Tensor,
                    slot: int, cfg: TransformerConfig,
                    true_len: "int | None" = None) -> dict:
    """Prefill ``prompt`` (1, L) into ``slot``'s cache row. With
    ``true_len`` (a prompt padded to a bucket) the next-token logits are
    read at ``true_len - 1``; the padding's K/V lies past the lane's
    position, masked, and is overwritten as decode advances."""
    k, v, logits = prefill_kv(
        params, prompt, cfg,
        logit_pos=None if true_len is None else true_len - 1)
    _prefill_slot_row(state, slot, k, v)
    state["logits"][slot] = logits[0].to(state["logits"].dtype)
    return state


# -- the paged device plane ---------------------------------------------


def _write_pool_rows(pool: torch.Tensor, layer: int, vals: torch.Tensor,
                     pos: torch.Tensor, page_table: torch.Tensor,
                     page_size: int,
                     mask: "torch.Tensor | None" = None) -> None:
    """The paged ``_write_slot_rows``: write ``vals[s]`` at
    ``pool[layer, page_table[s, pos[s] // P], pos[s] % P]`` in place. A
    parked lane (table row all zeros, pos 0) writes the reserved scratch
    page 0."""
    rows = torch.arange(vals.shape[0], device=vals.device)
    p = pos.long()
    page = page_table[rows, p // page_size].long()
    off = p % page_size
    if mask is not None:
        vals = torch.where(_lane_mask(mask, vals), vals,
                           pool[layer, page, off])
    pool[layer, page, off] = vals


def _gather_lane_kv(kv: dict, layer: int, page_table: torch.Tensor,
                    dtype: torch.dtype) -> tuple:
    """Each lane's pages in logical order, (lanes, n_pt * P, h_kv, D),
    dequantized after the gather for an int8 pool (elementwise, so the
    values are the slot engine's at every valid position)."""
    def one(name):
        x = kernels.paged_gather_kv(kv[name][layer], page_table)
        if "k_scale" not in kv:
            return x
        return dequantize_kv(
            x, kernels.paged_gather_kv(kv[name + "_scale"][layer],
                                       page_table), dtype)
    return one("k"), one("v")


def _paged_attend(kv: dict, pos: torch.Tensor, page_table: torch.Tensor,
                  cfg: TransformerConfig, impl: str,
                  write_mask: "torch.Tensor | None"):
    """The paged engines' ``attend``: table-routed writes, then the read
    through ``impl`` — ``"gather"`` (gathered pages and the slot
    formula) or ``"kernel"`` (``paged_attention``, one query a lane)."""
    page_size = kv["k"].shape[2]

    def attend(i, q, k, v):
        for j in range(q.shape[1]):
            _write_lane_kv(kv, k[:, j], v[:, j], lambda t, x: (
                _write_pool_rows(t, i, x, pos + j, page_table, page_size,
                                 write_mask)))
        if impl == "kernel":
            return kernels.paged_attention(q, kv["k"][i], kv["v"][i],
                                           page_table, pos)
        k_all, v_all = _gather_lane_kv(kv, i, page_table, cfg.dtype)
        if q.shape[1] == 1:
            return _slot_cached_attention(q, k_all, v_all, pos,
                                          window=cfg.attn_window)
        return _slot_block_attention(q, k_all, v_all, pos,
                                     window=cfg.attn_window)
    return attend


def _paged_decode_step(params: dict, kv: dict, token: torch.Tensor,
                       pos: torch.Tensor, page_table: torch.Tensor,
                       cfg: TransformerConfig, impl: str,
                       write_mask: "torch.Tensor | None" = None):
    """The slot step with K/V in the page pool. ``page_table`` (lanes,
    n_pt) and ``pos`` (lanes,) are int32 on the pool's device. Returns
    (kv, logits (lanes, vocab))."""
    logits = _lane_forward(
        params, token[:, None], pos, cfg,
        _paged_attend(kv, pos, page_table, cfg, impl, write_mask))
    return kv, logits[:, 0]


def _paged_extend(params: dict, kv: dict, tokens: torch.Tensor,
                  pos: torch.Tensor, page_table: torch.Tensor,
                  cfg: TransformerConfig,
                  write_mask: "torch.Tensor | None" = None):
    """``_slot_extend`` over the page pool, read through the gather path
    (the host's pre-write pass resolved every page the block writes)."""
    return kv, _lane_forward(
        params, tokens, pos, cfg,
        _paged_attend(kv, pos, page_table, cfg, "gather", write_mask))


def _store_prompt_pages(state: dict, k: torch.Tensor, v: torch.Tensor,
                        page_ids: torch.Tensor, prefix: str = "") -> None:
    """Write a prompt's K/V (layers, 1, n, h_kv, D) into the pool pages
    ``page_ids`` (ceil(n/P) ids), positions past n in the last page
    zeroed. A shared page is rewritten with identical bytes."""
    n_pages = page_ids.shape[0]
    pools = {n: state[prefix + n] for n in _KV_KEYS if prefix + n in state}
    page_size = pools["k"].shape[2]
    bufs = {n: t.new_zeros((t.shape[0], n_pages * page_size) + t.shape[3:])
            for n, t in pools.items()}
    _store_prompt_kv(bufs, k[:, 0], v[:, 0])
    for n, pool in pools.items():
        pool[:, page_ids] = bufs[n].view(
            (pool.shape[0], n_pages, page_size) + pool.shape[3:])


def _engine_paged_prefill(params: dict, state: dict, prompt: torch.Tensor,
                          page_ids: torch.Tensor, slot: int,
                          cfg: TransformerConfig) -> dict:
    """Prefill ``prompt`` (1, L) and write its K/V into the pool pages
    ``page_ids``."""
    k, v, logits = prefill_kv(params, prompt, cfg)
    _store_prompt_pages(state, k, v, page_ids)
    state["logits"][slot] = logits[0].to(state["logits"].dtype)
    return state


def _copy_page(state: dict, src: int, dst: int) -> dict:
    """The COW split's device half: copy page ``src`` to ``dst`` of the
    target pool (values and scales) across every layer, in place."""
    for name in _KV_KEYS:
        if name in state:
            state[name][:, dst] = state[name][:, src]
    return state


# -- the speculative device plane ---------------------------------------
#
# A draft model proposes k tokens a lane (k + 1 draft decode steps), the
# target scores the anchor and the k proposals in ONE block extend, and
# each lane accepts its longest agreeing prefix. Rejected positions lie
# past the lane's position: masked, and overwritten by the next block.


def _split_spec_state(state: dict) -> "tuple[dict, dict]":
    """One state dict -> (target kv, draft kv) views; the draft's cache
    rides the same dict under ``draft_*`` keys."""
    d_kv = {n[len(_DRAFT_PREFIX):]: state[n] for n in state
            if n.startswith(_DRAFT_PREFIX)}
    return _kv_view(state), d_kv


def _spec_probs_rows(logits: torch.Tensor, sample: tuple) -> torch.Tensor:
    """Rows (..., vocab) of logits -> the filtered sampling distribution
    (the pipeline plain sampling picks from)."""
    temperature, top_k, top_p = sample
    return torch.softmax(
        apply_sample_filters(logits, temperature, top_k, top_p), dim=-1)


def _spec_keys(key_data: torch.Tensor, idx: torch.Tensor,
               tag: int) -> torch.Tensor:
    """Lane s's key for one draw of a speculative block:
    ``fold_in(fold_in(base_s, idx[s]), tag)`` — the block's key (request
    seed + emitted index) fanned out by a static tag so the anchor, each
    proposal and the accept draws use disjoint streams."""
    return prng.fold_in(
        sample_step_key(prng.wrap_key_data(key_data), idx), tag)


def _spec_categorical_rows(key_data: torch.Tensor, probs: torch.Tensor,
                           idx: torch.Tensor, tag: int) -> torch.Tensor:
    """Per-lane categorical over probability rows (lanes, vocab), each a
    ``(1, vocab)`` draw of ``log(max(p, 1e-30))`` on the speculative key
    schedule."""
    logp = torch.log(torch.clamp(probs, min=1e-30))
    return prng.categorical(_spec_keys(key_data, idx, tag),
                            logp[:, None, :])[:, 0].to(torch.int32)


def _spec_uniform_rows(key_data: torch.Tensor, idx: torch.Tensor,
                       tag: int, n: int) -> torch.Tensor:
    """(lanes, n) uniform draws on the speculative key schedule — the
    per-proposal accept tests."""
    return prng.uniform(_spec_keys(key_data, idx, tag), (n,))


def _spec_core(params: dict, draft_params: dict, state: dict,
               pos: torch.Tensor, done: torch.Tensor,
               remaining: torch.Tensor, eos_ids: torch.Tensor,
               stop_ids: torch.Tensor, step_idx: torch.Tensor,
               key_data: Optional[torch.Tensor], k: int,
               sample: Optional[tuple], t_extend, d_step):
    """One speculative block for every lane (the JAX ``_spec_core``):

    1. the anchor token from the carried logits (argmax; sampled, from
       ``norm(max(p - q_res, 0))`` after a rejection — the modified-
       rejection resample — else from p);
    2. k + 1 draft steps: k proposals and one cache fill of the last, so
       the draft holds no hole after a full acceptance;
    3. one (k + 1)-position target extend over [anchor, d_1..d_k]; the
       longest accepted prefix ``n_acc`` (greedy: d_j == argmax V_{j-1};
       sampled: u * q_j(d_j) < p_j(d_j));
    4. the emit latch over [anchor, d_1..d_n_acc] on the device (EOS,
       stop, budget as ``multi_step_decode``), the carried logits
       ``V[n_acc]``.

    Returns (state, packed (k+4, lanes) int32: the candidates (row 0 the
    anchor), the accepted counts, the post-block positions and the bad
    flag)."""
    logits_in = state["logits"]
    poisoned = ~done & ~torch.isfinite(logits_in).all(dim=-1)
    bad = poisoned
    done = done | poisoned
    active = ~done

    if sample is None:
        tok0 = logits_in.argmax(dim=-1).to(torch.int32)
    else:
        p0 = _spec_probs_rows(logits_in, sample)
        res = torch.clamp(p0 - state["q_res"], min=0.0)
        tot = res.sum(dim=-1, keepdim=True)
        anchor = torch.where(tot > 0.0, res / torch.clamp(tot, min=1e-30),
                             p0)
        tok0 = _spec_categorical_rows(key_data, anchor, step_idx, tag=0)

    t_kv, d_kv = _split_spec_state(state)
    props, qs = [], []
    cur, dpos = tok0, pos
    for j in range(k + 1):
        d_kv, dl = d_step(draft_params, d_kv, cur, dpos, active)
        if j < k:
            if sample is None:
                nxt = dl.argmax(dim=-1).to(torch.int32)
            else:
                qj = _spec_probs_rows(dl, sample)
                qs.append(qj)
                nxt = _spec_categorical_rows(key_data, qj, step_idx,
                                             tag=1 + j)
            props.append(nxt)
            cur = nxt
        dpos = torch.where(active, dpos + 1, dpos)
    props_m = torch.stack(props, dim=1)                   # (s, k)

    block = torch.cat([tok0[:, None], props_m], dim=1)    # (s, k+1)
    _, v_logits = t_extend(params, t_kv, block, pos, active)
    bad_v = active & ~torch.isfinite(v_logits).all(dim=-1).all(dim=-1)
    bad = bad | bad_v
    done = done | bad_v

    if sample is None:
        t_arg = v_logits.argmax(dim=-1).to(torch.int32)
        ok = props_m == t_arg[:, :k]
    else:
        ps = _spec_probs_rows(v_logits, sample)           # (s, k+1, v)
        qs_m = torch.stack(qs, dim=1)                     # (s, k, v)
        at = props_m.long()[:, :, None]
        p_at = torch.gather(ps[:, :k], 2, at)[..., 0]
        q_at = torch.gather(qs_m, 2, at)[..., 0]
        u = _spec_uniform_rows(key_data, step_idx, tag=k + 1, n=k)
        ok = u * q_at < p_at
    zero = torch.zeros((ok.shape[0], 1), dtype=torch.bool, device=ok.device)
    # the first False: the accepted-prefix length, k if all accepted
    n_acc = torch.cat([ok, zero], dim=1).to(torch.int32).argmin(dim=1)
    lanes = torch.arange(v_logits.shape[0], device=v_logits.device)
    logits_next = v_logits[lanes, n_acc.long()]
    if sample is not None:
        # a rejection at proposal n_acc leaves the next anchor to draw
        # from norm(max(p - q_{n_acc}, 0)); full acceptance carries zeros
        q_rej = qs_m[lanes, torch.clamp(n_acc, max=k - 1).long()]
        state["q_res"] = torch.where((n_acc < k)[:, None], q_rej,
                                     torch.zeros_like(q_rej))

    for j in range(k + 1):
        tok = block[:, j]
        a = ~done & (j <= n_acc)
        finished = a & ((tok == eos_ids)
                        | (stop_ids == tok[:, None]).any(dim=1)
                        | (remaining <= 1))
        remaining = torch.where(a, remaining - 1, remaining)
        step_idx = torch.where(a, step_idx + 1, step_idx)
        live = a & ~finished
        done = done | finished
        pos = torch.where(live, pos + 1, pos)

    state["logits"] = logits_next.to(logits_in.dtype)
    packed = torch.cat([block.T.to(torch.int32), n_acc[None].to(torch.int32),
                        pos[None].to(torch.int32),
                        bad.to(torch.int32)[None]])
    return state, packed


def _engine_speculative_step(params: dict, draft_params: dict,
                             state: dict, pos: torch.Tensor,
                             done: torch.Tensor, remaining: torch.Tensor,
                             eos_ids: torch.Tensor, stop_ids: torch.Tensor,
                             step_idx: torch.Tensor,
                             key_data: Optional[torch.Tensor],
                             cfg: TransformerConfig,
                             draft_cfg: TransformerConfig, k: int,
                             sample: Optional[tuple]):
    """The slot engine's speculative block: ``_spec_core`` with the draft
    stepping its slot rows and the target extending its own."""

    def d_step(dp, dkv, tok, dpos, mask):
        return _slot_decode_step(dp, dkv, tok, dpos, draft_cfg, mask)

    def t_extend(p, tkv, block, bpos, mask):
        return _slot_extend(p, tkv, block, bpos, cfg, mask)

    return _spec_core(params, draft_params, state, pos, done, remaining,
                      eos_ids, stop_ids, step_idx, key_data, k, sample,
                      t_extend, d_step)


def _engine_paged_speculative_step(params: dict, draft_params: dict,
                                   state: dict, pos: torch.Tensor,
                                   done: torch.Tensor,
                                   remaining: torch.Tensor,
                                   eos_ids: torch.Tensor,
                                   stop_ids: torch.Tensor,
                                   step_idx: torch.Tensor,
                                   key_data: Optional[torch.Tensor],
                                   page_table: torch.Tensor,
                                   draft_page_table: torch.Tensor,
                                   cfg: TransformerConfig,
                                   draft_cfg: TransformerConfig, k: int,
                                   sample: Optional[tuple]):
    """The paged speculative block: the target's KV in the main pool and
    the draft's in its own, each through its own page table (the draft
    steps and the verify read through the gather path)."""

    def d_step(dp, dkv, tok, dpos, mask):
        return _paged_decode_step(dp, dkv, tok, dpos, draft_page_table,
                                  draft_cfg, "gather", mask)

    def t_extend(p, tkv, block, bpos, mask):
        return _paged_extend(p, tkv, block, bpos, page_table, cfg, mask)

    return _spec_core(params, draft_params, state, pos, done, remaining,
                      eos_ids, stop_ids, step_idx, key_data, k, sample,
                      t_extend, d_step)


def _engine_spec_prefill(params: dict, draft_params: dict, state: dict,
                         prompt: torch.Tensor, slot: int,
                         cfg: TransformerConfig,
                         draft_cfg: TransformerConfig) -> dict:
    """Prefill ``prompt`` (1, L) into ``slot``'s target and draft rows.
    The carried logits are the target's; a sampled engine's residual row
    resets to zero (no pending rejection)."""
    k, v, logits = prefill_kv(params, prompt, cfg)
    dk, dv, _ = prefill_kv(draft_params, prompt, draft_cfg)
    _prefill_slot_row(state, slot, k, v)
    _prefill_slot_row(state, slot, dk, dv, prefix=_DRAFT_PREFIX)
    state["logits"][slot] = logits[0].to(state["logits"].dtype)
    if "q_res" in state:
        state["q_res"][slot] = 0.0
    return state


def _engine_paged_spec_prefill(params: dict, draft_params: dict,
                               state: dict, prompt: torch.Tensor,
                               page_ids: torch.Tensor,
                               draft_page_ids: torch.Tensor, slot: int,
                               cfg: TransformerConfig,
                               draft_cfg: TransformerConfig) -> dict:
    """The paged ``_engine_spec_prefill``: each model's cache page-wise
    into its own pool."""
    k, v, logits = prefill_kv(params, prompt, cfg)
    dk, dv, _ = prefill_kv(draft_params, prompt, draft_cfg)
    _store_prompt_pages(state, k, v, page_ids)
    _store_prompt_pages(state, dk, dv, draft_page_ids,
                        prefix=_DRAFT_PREFIX)
    state["logits"][slot] = logits[0].to(state["logits"].dtype)
    if "q_res" in state:
        state["q_res"][slot] = 0.0
    return state


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one occupied slot."""

    req: Request
    emitted: list


@dataclasses.dataclass(frozen=True)
class ResumableRequest:
    """A drained in-flight request: what a fresh engine needs to continue
    it. ``generated`` is the tokens emitted so far; :meth:`ServingEngine
    .restore` replays ``req.prompt + generated`` through prefill and
    decodes the remaining budget. ``slot`` is the slot the request held
    at drain time (the serve loop releases the scheduler's binding of
    it); -1 for a snapshot that crossed a process boundary."""

    req: Request
    generated: tuple
    slot: int


class ServingEngine:
    """Slot owner + device-state holder. The scheduler decides WHAT runs
    (serving/scheduler.py); the engine runs it. The device is the
    parameters' device.

    ``tracer`` (runtime/tracing.py) receives the engine's spans and
    records; ``site_prefix`` names its fault sites (``<prefix>.dispatch``,
    ``<prefix>.logits``) so a plan can script a fault into one engine of
    several. :meth:`close` (or the context manager) stops the watchdog's
    guard thread."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 ecfg: EngineConfig = EngineConfig(), metrics=None,
                 tracer=None, clock=time.monotonic,
                 site_prefix: str = "engine"):
        if ecfg.prefill_buckets and ecfg.prefill_buckets[-1] > cfg.max_seq:
            raise ValueError(
                f"largest prefill bucket {ecfg.prefill_buckets[-1]} "
                f"exceeds max_seq {cfg.max_seq}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.metrics = metrics
        self.tracer = tracer
        self.clock = clock
        self.site_prefix = site_prefix
        self.device = params["embed"].device
        # the stream every dispatch runs on, whichever thread runs it (a
        # thread's current stream is its own)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._state = self._fresh_state()
        n = ecfg.num_slots
        self._pos = np.zeros((n,), np.int32)
        self._slots: list[Optional[_SlotState]] = [None] * n
        # per-lane finish vectors of the block dispatches (-1 = none)
        self._eos = np.full((n,), -1, np.int32)
        self._stops = np.full((n, ecfg.max_stop_tokens), -1, np.int32)
        self._remaining = np.zeros((n,), np.int32)
        # the sampled stream's coordinates: each lane's emitted-token
        # index and its request's key words (from the request's seed,
        # never the slot)
        self._step_idx = np.zeros((n,), np.int32)
        self._key_data = np.zeros((n, 2), np.int64)
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.peak_occupied = 0
        # block steps computed for a lane after its done-mask latched
        self.wasted_tokens = 0
        # distinct prefill lengths (prompt or bucket: the JAX engine's
        # compiled prefill programs; reported for the same summary shape)
        self.prefill_shapes: set = set()
        # tokens decoded for requests later failed or evicted
        self.discarded_tokens = 0
        self.evictions = 0
        self.watchdog_trips = 0
        self._draining = False
        self.drained: list[ResumableRequest] = []
        # the watchdog's guard thread, made at the first guarded dispatch;
        # a tripped (still stalled) one is abandoned and replaced
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = \
            None
        # the futures of the dispatches the watchdog gave up: each may
        # still wake and run, and a caller may wait for them
        self.abandoned: list = []
        # device-time attribution (telemetry/device.py), made at the first
        # dispatch so that it lands on the registry the serve loop attaches
        self._dtimer = None

    def _needs_keys(self) -> bool:
        """Does any dispatch of this engine draw from PRNG keys?"""
        return self.ecfg.sample is not None

    def _fresh_state(self) -> dict:
        """The device state as built: at construction, and after a hung
        or raising dispatch (new tensors; the abandoned ones stay with
        the dispatch that holds them)."""
        base = init_kv_cache(self.cfg, self.ecfg.num_slots,
                             device=self.device,
                             kv_dtype=self.ecfg.kv_dtype)
        del base["pos"]  # per-slot positions live host-side
        return {**base, "logits": self._zero_logits()}

    def _zero_logits(self) -> torch.Tensor:
        return torch.zeros((self.ecfg.num_slots, self.cfg.vocab_size),
                           dtype=self.cfg.dtype, device=self.device)

    def _on_stream(self):
        """The engine's stream as the calling thread's current stream."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _device_timer(self):
        if self._dtimer is None:
            from akka_allreduce_tpu_torch.telemetry.device import DeviceTimer
            # annotate_site="dispatch": profiler ranges are thread-local,
            # and with the watchdog armed the dispatch runs on the guard
            # thread, so the range opens inside the dispatched callable
            self._dtimer = DeviceTimer(
                "engine",
                registry=(self.metrics.registry
                          if self.metrics is not None else None),
                tracer=self.tracer, annotate_site="dispatch")
        return self._dtimer

    def close(self) -> None:
        """Stop the watchdog's guard thread (idempotent). The engine stays
        readable (summaries, drained snapshots) but must not dispatch
        again."""
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def device_time_summary(self) -> dict:
        """Host / device / dispatch-gap histograms over this engine's
        decode dispatches (telemetry/device.py): host ms launches the
        dispatch's work, device ms waits for its readback, and
        ``dispatch_gap_ms`` is the host's bubble between dispatches."""
        return self._device_timer().summary()

    # -- slot introspection -------------------------------------------

    @property
    def num_slots(self) -> int:
        return self.ecfg.num_slots

    @property
    def occupied(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def free_slot_count(self) -> int:
        return self.num_slots - self.occupied

    def kv_cache_bytes(self) -> int:
        return sum(self._state[n].numel() * self._state[n].element_size()
                   for n in _KV_KEYS if n in self._state)

    # -- admission (prefill) ------------------------------------------

    def _bucket_len(self, n: int) -> int:
        buckets = self.ecfg.prefill_buckets
        if not buckets:
            return n
        i = bisect.bisect_left(buckets, n)
        if i == len(buckets):
            raise ValueError(
                f"prompt length {n} exceeds largest prefill bucket "
                f"{buckets[-1]}")
        return buckets[i]

    def _validate_admit(self, req: Request, emitted: tuple) -> tuple:
        """The admission contract checks; returns the stop-token tuple."""
        n = len(req.prompt)
        if n < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1")
        if n + req.max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {n} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_seq {self.cfg.max_seq}")
        for t in (req.stop_tokens or ()) + (
                (req.eos_token,) if req.eos_token is not None else ()):
            if not 0 <= t < self.cfg.vocab_size:
                raise ValueError(f"request {req.rid}: stop/eos token {t} "
                                 f"out of vocab [0, {self.cfg.vocab_size})")
        stops = tuple(req.stop_tokens or ())
        if self.ecfg.decode_steps > 1 \
                and len(stops) > self.ecfg.max_stop_tokens:
            raise ValueError(
                f"request {req.rid}: {len(stops)} stop tokens exceed the "
                f"block's static width max_stop_tokens="
                f"{self.ecfg.max_stop_tokens}")
        if len(emitted) >= req.max_new_tokens:
            raise ValueError(
                f"request {req.rid}: restore carries {len(emitted)} "
                f"generated tokens, >= its budget {req.max_new_tokens}")
        return stops

    def can_admit(self, req: Request, emitted: tuple = ()) -> bool:
        """Memory gate beyond a free slot: always true for the slot
        engine (a slot IS its reservation)."""
        return True

    def _prefill_span(self, req: Request, slot: int, n_full: int,
                      **fields):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span("serve_prefill", rid=req.rid, slot=slot,
                                prompt_len=n_full, **fields)

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: Request, full: tuple) -> None:
        """The slot engine's lane write of ``full`` (the prompt, and on a
        restore the tokens generated before the drain), exact-length or
        padded up to its bucket."""
        n = len(full)
        length = self._bucket_len(n)
        padded = torch.zeros((1, length), dtype=torch.long,
                             device=self.device)
        padded[0, :n] = torch.as_tensor(full, dtype=torch.long)
        with self._prefill_span(req, slot, n, bucket=length):
            self._state = _engine_prefill(
                self.params, self._state, padded, slot, self.cfg,
                true_len=n if length != n else None)
        self.prefill_dispatches += 1
        self.prefill_shapes.add(length)

    def admit(self, req: Request, emitted: tuple = ()) -> int:
        """Prefill ``req`` into a free slot; returns the slot index.

        ``emitted`` is the restore hook: tokens the request generated in
        an earlier engine, replayed through prefill after the prompt. The
        decode budget shrinks by ``len(emitted)``, and a sampled lane's
        emitted-token index starts there."""
        stops = self._validate_admit(req, emitted)
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError("no free slot (admit gated on "
                               "free_slot_count)") from None
        full = tuple(req.prompt) + tuple(emitted)
        self._prefill_into(slot, req, full)
        self._pos[slot] = len(full)
        self._eos[slot] = -1 if req.eos_token is None else req.eos_token
        self._stops[slot, :] = -1
        for j, t in enumerate(stops[:self.ecfg.max_stop_tokens]):
            self._stops[slot, j] = t
        self._remaining[slot] = req.max_new_tokens - len(emitted)
        self._step_idx[slot] = len(emitted)
        if self._needs_keys():
            seed = req.seed if req.seed is not None else req.rid
            self._key_data[slot] = prng.key(seed).numpy()
        self._slots[slot] = _SlotState(req=req, emitted=list(emitted))
        self.peak_occupied = max(self.peak_occupied, self.occupied)
        if self.metrics is not None:
            self.metrics.on_admit(req.rid, slot, len(full))
        return slot

    # -- decode ---------------------------------------------------------

    def _finish_reason(self, req: Request, t: int,
                       emitted: int) -> Optional[str]:
        """Host finish predicate — the S=1 check, and the replay that
        mirrors the device latch token for token."""
        if req.eos_token is not None and t == req.eos_token:
            return "eos"
        if t in (req.stop_tokens or ()):
            return "stop"
        if emitted >= req.max_new_tokens:
            return "max_tokens"
        return None

    def _free_slot(self, i: int) -> None:
        self._slots[i] = None
        self._pos[i] = 0  # park the free lane at position 0
        self._eos[i] = -1
        self._stops[i, :] = -1
        self._remaining[i] = 0
        self._step_idx[i] = 0
        self._key_data[i, :] = 0

    # -- failure handling ----------------------------------------------

    def _fail_lane(self, i: int, reason: str) -> tuple:
        """Fail slot ``i``'s request (its partial decode discarded) and
        free the slot; returns the completion tuple the serve loop
        routes to retry or dead-letter."""
        slot = self._slots[i]
        n = len(slot.emitted)
        self.discarded_tokens += n
        if self.metrics is not None:
            self.metrics.on_discard(slot.req.rid, n)
            self.metrics.on_failure(slot.req.rid, reason)
        self._free_slot(i)
        return (i, slot.req, [], reason)

    def _fail_poisoned(self, i: int) -> tuple:
        """A lane whose logits went non-finite: its request fails, the
        engine serves on."""
        out = self._fail_lane(i, "nan")
        if self.metrics is not None:
            self.metrics.on_fault_survived("nan")
        return out

    def _recover(self, reason: str) -> list[tuple]:
        """A dispatch hung past the watchdog or raised: fail every
        occupied slot's request (the serve loop retries or dead-letters
        them) and rebuild the device state as built. The tensors the
        failed dispatch holds are dropped with it, never reused or zeroed
        in place."""
        failures = [self._fail_lane(i, reason)
                    for i, s in enumerate(self._slots) if s is not None]
        self._state = self._fresh_state()
        if self._dtimer is not None:
            # the stall and rebuild are recovery, not a scheduling bubble
            self._dtimer.reset_gap()
        if self.metrics is not None:
            self.metrics.on_fault_survived(reason)
        if self.tracer is not None:
            self.tracer.record("serve_recover", reason=reason,
                               failed=len(failures))
        return failures

    def _guarded_dispatch(self, fn):
        """Run one dispatch and its readback, under the watchdog when
        armed. The fault site ``<prefix>.dispatch`` lives inside the
        guarded callable, so an injected hang stalls what a late readback
        would stall. The callable enters the engine's stream and
        ``no_grad`` (both thread-local). A tripped thread is abandoned
        with its executor, which is replaced for the next dispatch."""
        wd = self.ecfg.watchdog_timeout_s
        site = f"{self.site_prefix}.dispatch"

        def guarded():
            maybe_fail(site)
            with torch.no_grad(), self._on_stream():
                return fn()

        if wd is None:
            return guarded()
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="engine-dispatch")
        fut = self._executor.submit(guarded)
        try:
            return fut.result(timeout=wd)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            self.abandoned.append(fut)
            self._executor.shutdown(wait=False)
            self._executor = None
            raise WatchdogTimeout(
                f"decode dispatch exceeded watchdog_timeout_s={wd}"
            ) from None

    def _dispatch(self, run, **fields):
        """One decode dispatch: ``run(dspan)`` (the device work and its
        readback, on operands the caller took beforehand) under the
        ``serve_step`` span, the device timer and the watchdog. Returns
        ``(result, None)``, or ``(None, failures)`` after a hung or
        raising dispatch was recovered."""
        span = (self.tracer.span("serve_step", **fields)
                if self.tracer is not None else contextlib.nullcontext())
        try:
            with span, self._device_timer().span(**fields) as dspan:
                return self._guarded_dispatch(lambda: run(dspan)), None
        except WatchdogTimeout:
            self.watchdog_trips += 1
            if self.metrics is not None:
                self.metrics.on_watchdog_trip()
            return None, self._recover("watchdog")
        except InjectedFault:
            return None, self._recover("fault")

    def _maybe_poison(self) -> None:
        """The ``nan`` fault hook: overwrite the scheduled lane's carried
        logits (every lane's when the point names none) with NaN before
        the dispatch, which the finite guard must catch."""
        pt = maybe_fail(f"{self.site_prefix}.logits")
        if pt is None or pt.kind != "nan":
            return
        logits = self._state["logits"]
        if pt.slot is None:
            logits.fill_(float("nan"))
        else:
            logits[pt.slot] = float("nan")

    def _evict_expired(self, finished: list) -> None:
        """Mid-flight deadline enforcement: between dispatches, a running
        request whose absolute ``deadline`` has passed is evicted — its
        partial decode charged to wasted work, its slot freed for the
        same loop iteration's refill — instead of burning the rest of its
        budget on an answer nobody waits for."""
        now = self.clock()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            req = slot.req
            if req.deadline is not None and now > req.deadline:
                self.evictions += 1
                n = len(slot.emitted)
                self.discarded_tokens += n
                if self.metrics is not None:
                    self.metrics.on_discard(req.rid, n)
                    self.metrics.on_evict(req.rid, n)
                finished.append((i, req, [], "evicted"))
                self._free_slot(i)

    # -- drain / restore (preemption) ----------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def request_drain(self) -> None:
        """Preemption signal (a SIGTERM handler, the preemption watcher,
        an injected fault): the serve loop stops admitting and calls
        :meth:`drain`. Only sets a flag, so any thread may call it."""
        self._draining = True

    def drain(self) -> list[ResumableRequest]:
        """Snapshot every in-flight request as a :class:`ResumableRequest`
        and free its slot; host bookkeeping only. The snapshots are also
        kept on ``self.drained``."""
        out = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            out.append(ResumableRequest(
                req=slot.req, generated=tuple(slot.emitted), slot=i))
            self._free_slot(i)
        self.drained = out
        if self.tracer is not None:
            self.tracer.record("serve_drain", in_flight=len(out))
        return out

    def restore(self, rr: ResumableRequest) -> int:
        """Continue a drained request in this engine: replay prompt +
        generated through prefill and decode the remaining budget.
        Returns the slot; the caller binds it in its scheduler."""
        return self.admit(rr.req, emitted=rr.generated)

    # -- the dispatch paths --------------------------------------------

    def _lane_step(self):
        """The lane decode the dispatches run: (params, kv, tok, pos,
        write_mask) -> (kv, logits)."""
        def decode(params, kv, tok, pos, mask):
            return _slot_decode_step(params, kv, tok, pos, self.cfg, mask)
        return decode

    def _vector(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of host vector ``arr`` on the engine's device (never a
        view of it: the host changes it while a dispatch may still hold
        it)."""
        return torch.tensor(arr, device=self.device)

    def _sample_operands(self) -> dict:
        """The sampled dispatch's extra operands; empty when greedy."""
        if self.ecfg.sample is None:
            return {}
        return {"sample": self.ecfg.sample,
                "key_data": self._vector(self._key_data),
                "step_idx": self._vector(self._step_idx)}

    def _consume(self, i: int, t: int) -> Optional[str]:
        """Append token ``t`` to lane ``i``'s stream; its finish reason."""
        slot = self._slots[i]
        slot.emitted.append(t)
        self._pos[i] += 1
        self._remaining[i] -= 1
        self._step_idx[i] += 1
        return self._finish_reason(slot.req, t, len(slot.emitted))

    def _complete(self, i: int, reason: str, finished: list) -> None:
        slot = self._slots[i]
        if self.metrics is not None:
            self.metrics.on_complete(slot.req.rid, len(slot.emitted),
                                     reason)
        finished.append((i, slot.req, slot.emitted, reason))
        self._free_slot(i)

    @torch.no_grad()
    def step(self) -> list[tuple[int, Request, list, str]]:
        """Advance every occupied slot by ``decode_steps`` tokens.
        Returns completions ``(slot, request, tokens, reason)`` — reason
        ``eos`` / ``stop`` / ``max_tokens`` for successes, ``nan`` for a
        poisoned lane, ``watchdog`` / ``fault`` for every in-flight
        request of a hung or raising dispatch (the state is rebuilt),
        ``evicted`` (terminal, no tokens) for a request whose deadline
        passed. Finished slots are freed before returning."""
        if self.ecfg.decode_steps > 1:
            return self._step_block()
        self._maybe_poison()
        # every operand is taken now, on the engine's stream: a dispatch
        # the watchdog abandons may wake after recovery and must find
        # only what it was given
        with self._on_stream():
            state_in = self._state
            pos_in = self._vector(self._pos)
            decode = self._lane_step()
            ops = self._sample_operands()

        def run(dspan):
            with dspan.annotation():
                state, packed = _engine_step(self.params, state_in, pos_in,
                                             decode, **ops)
                dspan.mark_dispatched()
                return state, packed.cpu().numpy()  # the one readback

        out, failures = self._dispatch(run, occupied=self.occupied)
        if failures is not None:
            return failures
        self._state, packed = out
        self.decode_dispatches += 1
        toks, finite = packed[0], packed[1]
        finished = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if not finite[i]:
                finished.append(self._fail_poisoned(i))
                continue
            reason = self._consume(i, int(toks[i]))
            if self.metrics is not None:
                self.metrics.on_token(slot.req.rid, slot.req.submitted_at)
            if reason is not None:
                self._complete(i, reason, finished)
        self._evict_expired(finished)
        return finished

    def _block_vectors(self) -> dict:
        """The per-lane vectors of a block dispatch, uploaded from host
        truth."""
        return {"done": self._vector(np.array([s is None
                                               for s in self._slots])),
                "remaining": self._vector(self._remaining),
                "eos_ids": self._vector(self._eos),
                "stop_ids": self._vector(self._stops)}

    def _step_block(self) -> list[tuple[int, Request, list, str]]:
        """The S>1 dispatch: one device block, one ``(S+2, lanes)``
        readback, then the host replays each lane's finish condition over
        its tokens (mirroring the device latch) and counts the block steps
        after it as wasted."""
        s_steps = self.ecfg.decode_steps
        self._maybe_poison()
        with self._on_stream():
            state_in = self._state
            pos_in = self._vector(self._pos)
            decode = self._lane_step()
            ops = {**self._block_vectors(), **self._sample_operands()}

        def run(dspan):
            with dspan.annotation():
                state, packed = _engine_multi_step(
                    self.params, state_in, pos_in, steps=s_steps,
                    decode_fn=decode, **ops)
                dspan.mark_dispatched()
                return state, packed.cpu().numpy()  # ONE readback per S

        out, failures = self._dispatch(run, occupied=self.occupied,
                                       decode_steps=s_steps)
        if failures is not None:
            return failures
        self._state, block = out
        self.decode_dispatches += 1
        toks, dev_pos, bad = \
            block[:s_steps], block[s_steps], block[s_steps + 1]
        finished = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if bad[i]:
                finished.append(self._fail_poisoned(i))
                continue
            req = slot.req
            reason = None
            consumed = 0
            for s in range(s_steps):
                consumed += 1
                reason = self._consume(i, int(toks[s, i]))
                if reason is not None:
                    break
            if self.metrics is not None:
                self.metrics.on_block_tokens(req.rid, req.submitted_at,
                                             consumed)
            if reason is not None:
                wasted = s_steps - consumed
                self.wasted_tokens += wasted
                if self.metrics is not None:
                    self.metrics.on_wasted(req.rid, wasted)
                self._complete(i, reason, finished)
            elif int(dev_pos[i]) != int(self._pos[i]):
                raise RuntimeError(
                    f"slot {i} (rid {req.rid}): device pos "
                    f"{int(dev_pos[i])} != host replay {self._pos[i]} "
                    f"after a {s_steps}-step block — on-device finish "
                    f"latch and host completion logic diverged")
        self._evict_expired(finished)
        return finished


class PagedServingEngine(ServingEngine):
    """The paged-KV engine: :class:`ServingEngine`'s host loop with the
    per-slot cache rows replaced by a page pool and per-lane page tables.
    Admission is gated on free pages; before each dispatch the host
    COW-splits (device page copy) or unregisters any shared or
    registered page the dispatch may write, so the device step never
    sees sharing. With ``attention_impl="kernel"`` on a CUDA pool the
    kernel is built when the engine is constructed."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 ecfg: PagedEngineConfig = PagedEngineConfig(),
                 metrics=None, tracer=None, clock=time.monotonic,
                 site_prefix: str = "engine"):
        if not isinstance(ecfg, PagedEngineConfig):
            raise TypeError(
                f"PagedServingEngine needs a PagedEngineConfig, got "
                f"{type(ecfg).__name__}")
        if ecfg.attention_impl == "kernel" and cfg.attn_window:
            # the JAX engine's pallas path silently ignores the window;
            # the port refuses the combination instead
            raise ValueError(
                "attention_impl='kernel' does not implement sliding-"
                "window decode; use the gather path with attn_window")
        self._pages_per_seq = pages_for(cfg.max_seq, ecfg.page_size)
        num_pages = ecfg.num_pages or (
            ecfg.num_slots * self._pages_per_seq)
        if num_pages < self._pages_per_seq:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one maximal request "
                f"({self._pages_per_seq} pages of {ecfg.page_size} for "
                f"max_seq {cfg.max_seq})")
        # +1: page 0 is the scratch sink for parked lanes' writes
        self.pool = PagePool(num_pages + 1, ecfg.page_size,
                             scratch_pages=1)
        self._lane_pages: "list[Optional[list]]" = [None] * ecfg.num_slots
        self._lane_end: "list[int]" = [0] * ecfg.num_slots
        self._pt = np.zeros((ecfg.num_slots, self._pages_per_seq),
                            np.int32)
        self._pt_dirty = True
        self._dev_pt = None
        self.cow_page_copies = 0
        self._unshared_pages_now = 0
        self.peak_pages_in_use = 0
        self.peak_pages_unshared = 0
        super().__init__(params, cfg, ecfg, metrics=metrics, tracer=tracer,
                         clock=clock, site_prefix=site_prefix)
        if ecfg.attention_impl == "kernel" and self.device.type == "cuda":
            kernels.build.load("paged_attention")  # set-up, not TTFT

    def _fresh_state(self) -> dict:
        return {**init_kv_pool(self.cfg, self.pool.num_pages,
                               self.ecfg.page_size, device=self.device,
                               kv_dtype=self.ecfg.kv_dtype),
                "logits": self._zero_logits()}

    # -- admission ------------------------------------------------------

    def can_admit(self, req: Request, emitted: tuple = ()) -> bool:
        return self.pool.can_admit(tuple(req.prompt) + tuple(emitted),
                                   req.max_new_tokens - len(emitted))

    def _allocate(self, slot: int, full: tuple, budget: int) -> tuple:
        """Allocate (or share) ``slot``'s target pages for ``full`` (the
        prompt and any replayed tokens) + ``budget`` positions and write
        its table row; returns (pages, pages shared)."""
        n = len(full)
        pages, writes = self.pool.admit(full, budget)
        self._lane_pages[slot] = pages
        self._lane_end[slot] = n + budget
        self._pt[slot, :] = 0
        self._pt[slot, :len(pages)] = pages
        self._pt_dirty = True
        self._unshared_pages_now += pages_for(n + budget,
                                              self.ecfg.page_size)
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pool.pages_in_use)
        self.peak_pages_unshared = max(self.peak_pages_unshared,
                                       self._unshared_pages_now)
        return pages, sum(1 for w in writes if not w)

    def _prompt_pages(self, pages: list, n: int) -> torch.Tensor:
        return torch.as_tensor(pages[:pages_for(n, self.ecfg.page_size)],
                               dtype=torch.long, device=self.device)

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: Request, full: tuple) -> None:
        n = len(full)
        budget = req.max_new_tokens - (n - len(req.prompt))
        pages, shared = self._allocate(slot, full, budget)
        prompt = torch.as_tensor(full, dtype=torch.long,
                                 device=self.device)[None]
        with self._prefill_span(req, slot, n, pages=len(pages),
                                shared=shared):
            self._state = _engine_paged_prefill(
                self.params, self._state, prompt,
                self._prompt_pages(pages, n), slot, self.cfg)
        self.prefill_dispatches += 1
        self.prefill_shapes.add(n)

    def _free_slot(self, i: int) -> None:
        if self._lane_pages[i] is not None:
            self.pool.release_all(self._lane_pages[i])
            self._lane_pages[i] = None
            self._unshared_pages_now -= pages_for(
                self._lane_end[i], self.ecfg.page_size)
            self._lane_end[i] = 0
        self._pt[i, :] = 0
        self._pt_dirty = True
        super()._free_slot(i)

    # -- the pre-write (COW) pass ---------------------------------------

    def _prepare_writes(self) -> None:
        """Resolve sharing for every page the next dispatch may write
        (conservative over the block)."""
        s_steps = self.ecfg.decode_steps
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            n_write = max(1, min(s_steps, int(self._remaining[i])))
            self._resolve_lane_writes(i, n_write)

    def _resolve_lane_writes(self, i: int, n_write: int) -> None:
        """COW-resolve the pool pages lane ``i``'s next dispatch can
        write (``n_write`` positions from its current one)."""
        P = self.ecfg.page_size
        pages = self._lane_pages[i]
        p0 = int(self._pos[i])
        last = min(p0 + n_write - 1, self._lane_end[i] - 1)
        for c in range(p0 // P, min(last // P + 1, len(pages))):
            page = pages[c]
            if not (self.pool.is_shared(page)
                    or self.pool.is_registered(page)):
                continue
            new = self.pool.split_for_write(page)
            if new is not None:
                with torch.no_grad():
                    self._state = _copy_page(self._state, page, new)
                self.cow_page_copies += 1
                pages[c] = new
                self._pt[i, c] = new
                self._pt_dirty = True
                if self.tracer is not None:
                    self.tracer.record("serve_cow_split", slot=i,
                                       rid=self._slots[i].req.rid,
                                       src=page, dst=new)

    def step(self) -> list:
        self._prepare_writes()
        return super().step()

    # -- the dispatch paths (page-table operand) ------------------------

    def _page_table_device(self) -> torch.Tensor:
        if self._pt_dirty or self._dev_pt is None:
            self._dev_pt = self._vector(self._pt)
            self._pt_dirty = False
        return self._dev_pt

    def _lane_step(self):
        pt = self._page_table_device()
        impl = self.ecfg.attention_impl

        def decode(params, kv, tok, pos, mask):
            return _paged_decode_step(params, kv, tok, pos, pt, self.cfg,
                                      impl, mask)
        return decode

    # -- introspection / metrics ----------------------------------------

    def paging_summary(self) -> dict:
        """Page-pool health: utilization, fragmentation (reserved but
        unwritten share of allocated capacity), prefix sharing and COW
        counters, and the sharing saving at peak."""
        pool = self.pool
        live_tokens = sum(int(self._pos[i])
                          for i, s in enumerate(self._slots)
                          if s is not None)
        in_use = pool.pages_in_use
        cap = pool.capacity
        return {
            "page_size": self.ecfg.page_size,
            "pages_total": cap,
            "pages_free": pool.free_pages,
            "pages_in_use": in_use,
            "utilization": round(in_use / cap, 4) if cap else 0.0,
            "fragmentation": round(
                max(0.0, 1.0 - live_tokens
                    / (in_use * self.ecfg.page_size)), 4)
                if in_use else 0.0,
            "prefix_hit_rate": round(pool.prefix_hit_rate, 4),
            "prefix_hits": pool.prefix_hits,
            "prefix_lookups": pool.prefix_lookups,
            "pages_shared_total": pool.pages_shared_total,
            "cow_splits_total": pool.cow_splits,
            "peak_pages_in_use": self.peak_pages_in_use,
            "peak_pages_unshared": self.peak_pages_unshared,
            "hbm_saving_x": round(
                self.peak_pages_unshared / self.peak_pages_in_use, 3)
                if self.peak_pages_in_use else 1.0,
        }


class _SpeculativeMixin:
    """The host half of speculative serving, shared by the slot and paged
    speculative engines: the block unpack with the acceptance replay,
    the draft-token ledger (``draft_proposed == draft_accepted +
    draft_rejected``, rejected charged to wasted tokens) and the
    admission headroom (a verify writes ``draft_steps`` positions past
    the emitted frontier)."""

    def _init_spec(self, draft_params: dict,
                   draft_cfg: TransformerConfig, cfg: TransformerConfig,
                   ecfg: EngineConfig) -> None:
        if ecfg.draft_steps < 1:
            raise ValueError(
                "a speculative engine needs draft_steps >= 1 "
                "(EngineConfig.draft_steps; plain engines use 0)")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft and target must share a vocabulary: "
                f"{draft_cfg.vocab_size} != {cfg.vocab_size}")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.draft_rejected = 0
        self._lane_draft: dict = {}  # slot -> [proposed, accepted]

    def _spec_extra_state(self) -> dict:
        """The draft cache ``draft`` rides the state under ``draft_*``;
        a sampled engine carries the pending-rejection residual row
        ``q_res`` (zero: plain sampling)."""
        if self.ecfg.sample is None:
            return {}
        return {"q_res": torch.zeros(
            (self.ecfg.num_slots, self.cfg.vocab_size),
            dtype=torch.float32, device=self.device)}

    @property
    def acceptance_rate(self) -> float:
        return (self.draft_accepted / self.draft_proposed
                if self.draft_proposed else 0.0)

    def speculative_summary(self) -> dict:
        return {"draft_steps": self.ecfg.draft_steps,
                "draft_proposed": self.draft_proposed,
                "draft_accepted": self.draft_accepted,
                "draft_rejected": self.draft_rejected,
                "acceptance_rate": round(self.acceptance_rate, 4)}

    def kv_cache_bytes(self) -> int:
        # target + draft caches; the carried logits/q_res are not cache
        return sum(t.numel() * t.element_size()
                   for n, t in self._state.items()
                   if n not in ("logits", "q_res"))

    def _validate_admit(self, req: Request, emitted: tuple) -> tuple:
        stops = super()._validate_admit(req, emitted)
        k = self.ecfg.draft_steps
        n = len(req.prompt)
        if n + req.max_new_tokens + k > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {n} + max_new_tokens "
                f"{req.max_new_tokens} + draft_steps {k} exceeds "
                f"max_seq {self.cfg.max_seq} (speculative blocks write "
                f"up to draft_steps positions past the emitted "
                f"frontier)")
        if n + req.max_new_tokens + k > self.draft_cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: draft max_seq "
                f"{self.draft_cfg.max_seq} must cover prompt + "
                f"max_new_tokens + draft_steps = "
                f"{n + req.max_new_tokens + k}")
        if len(stops) > self.ecfg.max_stop_tokens:
            raise ValueError(
                f"request {req.rid}: {len(stops)} stop tokens "
                f"exceed the block's static width "
                f"max_stop_tokens={self.ecfg.max_stop_tokens}")
        return stops

    def _free_slot(self, i: int) -> None:
        self._lane_draft.pop(i, None)
        super()._free_slot(i)

    def step(self) -> list:
        return self._step_spec()

    def _spec_tables(self) -> dict:
        """The block's page-table operands (none for the slot engine)."""
        return {}

    @torch.no_grad()
    def _step_spec(self) -> list:
        """One speculative block dispatch + unpack: the token rows are
        [anchor, proposals], each lane consumes up to its accepted count
        (the host replays the device latch token for token), then the
        draft ledger settles from what entered the stream."""
        k = self.ecfg.draft_steps
        self._maybe_poison()
        with self._on_stream():
            state_in = self._state
            pos_in = self._vector(self._pos)
            ops = {**self._block_vectors(), **self._spec_tables(),
                   "step_idx": self._vector(self._step_idx),
                   "key_data": self._vector(self._key_data)}

        def run(dspan):
            with dspan.annotation():
                state, packed = self._dispatch_spec(state_in, pos_in, **ops)
                dspan.mark_dispatched()
                return state, packed.cpu().numpy()

        out, failures = self._dispatch(run, occupied=self.occupied,
                                       draft_steps=k)
        if failures is not None:
            return failures
        self._state, block = out
        self.decode_dispatches += 1
        toks, n_accs, dev_pos, bad = \
            block[:k + 1], block[k + 1], block[k + 2], block[k + 3]
        finished = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if bad[i]:
                finished.append(self._fail_poisoned(i))
                continue
            req = slot.req
            reason = None
            consumed = 0
            for j in range(int(n_accs[i]) + 1):
                consumed += 1
                reason = self._consume(i, int(toks[j, i]))
                if reason is not None:
                    break
            # the proposals that entered the stream are accepted, the
            # rest rejected: verify work computed and thrown away
            accepted = consumed - 1
            rejected = k - accepted
            self.draft_proposed += k
            self.draft_accepted += accepted
            self.draft_rejected += rejected
            self.wasted_tokens += rejected
            ld = self._lane_draft.setdefault(i, [0, 0])
            ld[0] += k
            ld[1] += accepted
            if self.metrics is not None:
                self.metrics.on_block_tokens(req.rid, req.submitted_at,
                                             consumed)
                self.metrics.on_draft_block(req.rid, k, accepted)
            if reason is not None:
                if self.metrics is not None:
                    prop, acc = self._lane_draft.get(i, (0, 0))
                    self.metrics.on_draft_complete(
                        req.rid, acc / prop if prop else 0.0)
                self._complete(i, reason, finished)
            elif int(dev_pos[i]) != int(self._pos[i]):
                raise RuntimeError(
                    f"slot {i} (rid {req.rid}): device pos "
                    f"{int(dev_pos[i])} != host replay {self._pos[i]} "
                    f"after a draft_steps={k} speculative block — "
                    f"on-device accept latch and host replay diverged")
        self._evict_expired(finished)
        return finished


class SpeculativeEngine(_SpeculativeMixin, ServingEngine):
    """The speculative slot engine: the continuous-batching host loop
    with every decode dispatch a draft-verify block — the draft model
    proposes ``draft_steps`` tokens a slot, ONE target extend scores the
    anchor and every proposal, and each slot emits 1 to draft_steps + 1
    tokens a dispatch. Greedy output is the plain greedy engine's;
    sampled mode is per-slot modified-rejection sampling (the carried
    ``q_res`` residual row), which keeps the target's sampling
    distribution. The draft's cache (float, the draft's dtype) rides
    the state under ``draft_*`` keys."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 draft_params: dict, draft_cfg: TransformerConfig,
                 ecfg: EngineConfig = EngineConfig(draft_steps=4),
                 metrics=None, tracer=None, clock=time.monotonic,
                 site_prefix: str = "engine"):
        self._init_spec(draft_params, draft_cfg, cfg, ecfg)
        super().__init__(params, cfg, ecfg, metrics=metrics, tracer=tracer,
                         clock=clock, site_prefix=site_prefix)

    def _fresh_state(self) -> dict:
        state = super()._fresh_state()
        draft = init_kv_cache(self.draft_cfg, self.ecfg.num_slots,
                              device=self.device)
        del draft["pos"]
        state.update({_DRAFT_PREFIX + n: t for n, t in draft.items()})
        state.update(self._spec_extra_state())
        return state

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: Request, full: tuple) -> None:
        prompt = torch.as_tensor(full, dtype=torch.long,
                                 device=self.device)[None]
        with self._prefill_span(req, slot, len(full), speculative=True):
            self._state = _engine_spec_prefill(
                self.params, self.draft_params, self._state, prompt, slot,
                self.cfg, self.draft_cfg)
        self.prefill_dispatches += 1
        self.prefill_shapes.add(len(full))

    def _dispatch_spec(self, state, pos, **operands):
        return _engine_speculative_step(
            self.params, self.draft_params, state, pos, **operands,
            cfg=self.cfg, draft_cfg=self.draft_cfg,
            k=self.ecfg.draft_steps, sample=self.ecfg.sample)


class PagedSpeculativeEngine(_SpeculativeMixin, PagedServingEngine):
    """Speculative decode over the paged engine: the target KV in the
    main page pool behind its table, the draft's in its own small pool
    (same page geometry, the draft's bytes) behind a second table. The
    draft pool never shares pages (``PagePool.admit(share=False)``): the
    COW copy covers the target pool only. The pre-write pass widens to
    the ``draft_steps + 1`` positions a verify writes. Reads go through
    the gather path."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 draft_params: dict, draft_cfg: TransformerConfig,
                 ecfg: "PagedEngineConfig | None" = None,
                 metrics=None, tracer=None, clock=time.monotonic,
                 site_prefix: str = "engine"):
        if ecfg is None:
            ecfg = PagedEngineConfig(draft_steps=4)
        self._init_spec(draft_params, draft_cfg, cfg, ecfg)
        if not isinstance(ecfg, PagedEngineConfig):
            raise TypeError(
                f"PagedSpeculativeEngine needs a PagedEngineConfig, "
                f"got {type(ecfg).__name__}")
        self._draft_pages_per_seq = pages_for(cfg.max_seq, ecfg.page_size)
        self.draft_pool = PagePool(
            ecfg.num_slots * self._draft_pages_per_seq + 1,
            ecfg.page_size, scratch_pages=1)
        self._draft_lane_pages: "list[Optional[list]]" = \
            [None] * ecfg.num_slots
        self._draft_pt = np.zeros(
            (ecfg.num_slots, self._draft_pages_per_seq), np.int32)
        super().__init__(params, cfg, ecfg, metrics=metrics, tracer=tracer,
                         clock=clock, site_prefix=site_prefix)

    def _fresh_state(self) -> dict:
        state = super()._fresh_state()
        draft = init_kv_pool(self.draft_cfg, self.draft_pool.num_pages,
                             self.ecfg.page_size, device=self.device)
        state.update({_DRAFT_PREFIX + n: t for n, t in draft.items()})
        state.update(self._spec_extra_state())
        return state

    def _spec_budget(self, req: Request, emitted: tuple) -> int:
        """Pages a lane reserves: its remaining decode budget plus the
        draft_steps positions a final verify writes past the frontier."""
        return req.max_new_tokens - len(emitted) + self.ecfg.draft_steps

    def can_admit(self, req: Request, emitted: tuple = ()) -> bool:
        full = tuple(req.prompt) + tuple(emitted)
        budget = self._spec_budget(req, emitted)
        return (self.pool.can_admit(full, budget)
                and self.draft_pool.can_admit(full, budget, share=False))

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: Request, full: tuple) -> None:
        n = len(full)
        budget = self._spec_budget(req, full[len(req.prompt):])
        pages, shared = self._allocate(slot, full, budget)
        d_pages, _ = self.draft_pool.admit(full, budget, share=False)
        self._draft_lane_pages[slot] = d_pages
        self._draft_pt[slot, :] = 0
        self._draft_pt[slot, :len(d_pages)] = d_pages
        prompt = torch.as_tensor(full, dtype=torch.long,
                                 device=self.device)[None]
        with self._prefill_span(req, slot, n, pages=len(pages),
                                shared=shared, speculative=True):
            self._state = _engine_paged_spec_prefill(
                self.params, self.draft_params, self._state, prompt,
                self._prompt_pages(pages, n),
                self._prompt_pages(d_pages, n), slot, self.cfg,
                self.draft_cfg)
        self.prefill_dispatches += 1
        self.prefill_shapes.add(n)

    def _free_slot(self, i: int) -> None:
        if self._draft_lane_pages[i] is not None:
            self.draft_pool.release_all(self._draft_lane_pages[i])
            self._draft_lane_pages[i] = None
        self._draft_pt[i, :] = 0
        super()._free_slot(i)

    def step(self) -> list:
        # the verify writes draft_steps + 1 target positions per active
        # lane whatever its remaining budget; the draft pool never shares
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._resolve_lane_writes(i, self.ecfg.draft_steps + 1)
        return self._step_spec()

    def _spec_tables(self) -> dict:
        return {"page_table": self._page_table_device(),
                "draft_page_table": self._vector(self._draft_pt)}

    def _dispatch_spec(self, state, pos, **operands):
        return _engine_paged_speculative_step(
            self.params, self.draft_params, state, pos, **operands,
            cfg=self.cfg, draft_cfg=self.draft_cfg,
            k=self.ecfg.draft_steps, sample=self.ecfg.sample)

    def paging_summary(self) -> dict:
        out = super().paging_summary()
        out["draft_pages_total"] = self.draft_pool.capacity
        out["draft_pages_free"] = self.draft_pool.free_pages
        return out


# -- drain persistence ----------------------------------------------------
#
# A drain snapshots in-flight requests as ResumableRequests; these helpers
# carry them through runtime/checkpoint.py's atomic JSON sidecar, so the
# NEXT process restores them (``serve --drain-dir``). The layout is the
# JAX package's: either package restores the other's drain.

DRAIN_STATE_NAME = "drained_requests"


def _req_to_json(req: Request) -> dict:
    return {"rid": req.rid, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "eos_token": req.eos_token,
            "stop_tokens": list(req.stop_tokens or ()),
            "attempts": req.attempts,
            # the sampled stream's identity (None stays rid-derived)
            "seed": req.seed,
            "tenant": req.tenant}


def _req_from_json(d: dict) -> Request:
    # arrival / deadline / submitted_at are instants of the dead
    # process's monotonic clock and are not persisted: a restored request
    # is due at once and keeps its remaining token budget
    return Request(rid=d["rid"], prompt=tuple(d["prompt"]),
                   max_new_tokens=d["max_new_tokens"],
                   eos_token=d["eos_token"],
                   stop_tokens=tuple(d["stop_tokens"]),
                   arrival=0.0, submitted_at=None,
                   attempts=d["attempts"],
                   seed=d.get("seed"), tenant=d.get("tenant"))


def persist_drained(directory: str, drained, metrics=None) -> str:
    """Write ``drained`` (:class:`ResumableRequest` list) under
    ``directory`` atomically; returns the path. Ticks
    ``serve_drain_persisted_total`` when ``metrics`` is given."""
    from akka_allreduce_tpu_torch.runtime.checkpoint import save_state_json
    payload = {"version": 1, "requests": [
        {"req": _req_to_json(rr.req), "generated": list(rr.generated),
         "slot": rr.slot} for rr in drained]}
    path = save_state_json(directory, DRAIN_STATE_NAME, payload)
    if metrics is not None:
        metrics.on_drain_persisted(len(drained))
    return path


def load_drained(directory: str) -> "list[ResumableRequest]":
    """Read a :func:`persist_drained` file back into restorable snapshots
    (empty when none exists). The caller deletes it
    (:func:`clear_drained`) once the restored requests finished, so a
    second preemption mid-restore still finds it."""
    from akka_allreduce_tpu_torch.runtime.checkpoint import load_state_json
    payload = load_state_json(directory, DRAIN_STATE_NAME)
    if payload is None:
        return []
    if payload.get("version") != 1:
        raise ValueError(
            f"drained-requests state version "
            f"{payload.get('version')!r} not supported (have 1)")
    return [ResumableRequest(req=_req_from_json(e["req"]),
                             generated=tuple(e["generated"]),
                             slot=e["slot"])
            for e in payload["requests"]]


def clear_drained(directory: str) -> bool:
    from akka_allreduce_tpu_torch.runtime.checkpoint import \
        delete_state_json
    return delete_state_json(directory, DRAIN_STATE_NAME)


# failure reasons the serve loop hands back to the scheduler's retry
# budget (everything else in a completion tuple is terminal). The JAX
# package's "replica_dead" comes with the replica fleet (ROADMAP A8).
RETRYABLE_REASONS = frozenset({"watchdog", "fault", "nan"})


def serve_loop(engine: ServingEngine, scheduler: RequestScheduler,
               metrics=None, max_dispatches: Optional[int] = None,
               resume=()) -> dict:
    """Drive engine + scheduler until both drain. Returns ``{rid:
    (tokens, reason)}``; a terminal failure carries ``[]`` and its status
    (``evicted``, ``dead_letter``, ``rejected_infeasible``).

    Per iteration: admit every arrived request into free slots (the paged
    engine's free-page gate rides ``pop_ready``), then step — unless
    occupancy is below the scheduler's quorum and more work is due, in
    which case wait for it. A retryable failure (``watchdog`` / ``fault``
    / ``nan``) goes back through ``requeue_failed``. A preemption (an
    injected ``preempt`` at ``serve.loop``, or ``engine.request_drain()``
    from a signal handler or the preemption watcher) stops admission and
    returns after ``engine.drain()``: the snapshots wait on
    ``engine.drained``. ``max_dispatches`` bounds decode dispatches
    (raises instead of hanging).

    ``resume`` is the drain handoff: :class:`ResumableRequest` snapshots
    (a previous engine's drain, or ``load_drained`` across a process
    boundary) restored into free slots ahead of queue admission, holding
    their head-of-line place while they wait for pages."""
    results: dict = {}
    pending_resume = list(resume)
    if metrics is not None and engine.metrics is None:
        engine.metrics = metrics
    clock = scheduler.clock

    def drain_drops() -> None:
        for req, reason in scheduler.drain_dropped():
            results[req.rid] = ([], reason)
            if metrics is not None:
                metrics.on_drop(req.rid, reason)

    while True:
        pt = maybe_fail("serve.loop")
        if pt is not None and pt.kind == "preempt":
            engine.request_drain()
            if metrics is not None:
                metrics.on_fault_survived("preempt")
        if engine.draining:
            for rr in engine.drain():
                scheduler.release(rr.slot)
            # resumables not yet re-admitted stay resumable: a second
            # preemption mid-restore must not drop them
            engine.drained.extend(pending_resume)
            drain_drops()
            return results
        now = clock()
        resume_blocked = False
        while engine.free_slot_count > 0 and pending_resume:
            rr = pending_resume[0]
            if not engine.can_admit(rr.req, rr.generated):
                # the replay waits for pages and keeps its place: fresh
                # admissions must not take the pages decode frees (an
                # empty engine has an empty pool, where any valid
                # request fits, so this cannot deadlock)
                resume_blocked = True
                break
            pending_resume.pop(0)
            if rr.req.submitted_at is None:
                # restored across a process boundary: TTFT counts from
                # the restore
                rr.req.submitted_at = now
            scheduler.bind(rr.req, engine.restore(rr))
        while not resume_blocked and engine.free_slot_count > 0:
            req = scheduler.pop_ready(now, can_admit=engine.can_admit)
            if req is None:
                break
            scheduler.bind(req, engine.admit(req))
        drain_drops()
        if engine.occupied == 0:
            nxt = scheduler.next_arrival_time()
            if nxt is None:
                return results
            scheduler.wait_until(nxt)
            continue
        if not scheduler.should_step(engine.occupied) \
                and engine.free_slot_count > 0:
            nxt = scheduler.next_arrival_time()
            if nxt is not None and nxt > now:
                scheduler.wait_until(nxt)
                continue
        if metrics is not None:
            metrics.observe(scheduler.queue_depth,
                            engine.occupied / engine.num_slots)
        if max_dispatches is not None \
                and engine.decode_dispatches >= max_dispatches:
            raise RuntimeError(
                f"serve_loop exceeded max_dispatches={max_dispatches} "
                f"({len(results)} requests done, "
                f"{scheduler.unfinished} unfinished)")
        for slot, req, tokens, reason in engine.step():
            scheduler.release(slot)
            if reason in RETRYABLE_REASONS:
                if scheduler.requeue_failed(req, reason) \
                        and metrics is not None:
                    metrics.on_retry(req.rid)
            else:
                results[req.rid] = (tokens, reason)
