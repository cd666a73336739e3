"""Continuous-batching decode engine of the port: slots and pages.

Counterpart of ``akka_allreduce_tpu/serving/engine.py`` for greedy decode
on float KV. The host loop is the JAX engine's: a fixed array of decode
lanes, one batched step advancing every occupied lane at its own
position, a lane freed the moment its request finishes (EOS, stop token,
budget) and refilled by prefilling the next queued prompt.

* :class:`ServingEngine` keeps per-slot ``max_seq`` cache rows.
* :class:`PagedServingEngine` keeps K/V in one flat page pool
  ``(layers, num_pages, page_size, kv_heads, head_dim)`` addressed
  through per-lane int32 page tables (serving/paging.py owns the
  allocation); admission is gated on free pages, shared prompt prefixes
  are stored once and split copy-on-write before the first divergent
  write. ``attention_impl="gather"`` reads the pool through
  ``paged_gather_kv`` and the slot engine's masked-softmax formula;
  ``"kernel"`` runs ``ops/kernels/attention.py paged_attention`` — the
  CUDA kernel on a CUDA pool, its plain version on a CPU pool.

What differs from the JAX engine:

* PyTorch runs eagerly, so a dispatch is a sequence of device ops with
  one host readback at its end: ``decode_steps=S`` loops S steps on the
  device (``multi_step_decode``) and reads one ``(S+2, lanes)`` block.
* The KV arrays are updated in place (where JAX donates its state); the
  pool keeps the JAX layout, which the kernel reads as it is.
* The per-lane finish vectors are uploaded before every block instead of
  carried as device outputs between blocks.
* Left for later slices: int8 KV, sampling, speculative engines,
  bucketed prefill, the watchdog and fault injection, mid-flight
  deadline eviction, drain/restore, tracer spans and device timers. The
  finite-logits guard (a NaN-poisoned lane fails its request, not the
  engine) is kept.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from akka_allreduce_tpu_torch.models.generate import (
    init_kv_cache,
    init_kv_pool,
    multi_step_decode,
    prefill_kv,
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
from akka_allreduce_tpu_torch.serving.paging import PagePool, pages_for
from akka_allreduce_tpu_torch.serving.scheduler import (
    Request,
    RequestScheduler,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape knobs (the JAX config's greedy, float-KV subset).

    ``decode_steps=S``: S decode steps per dispatch with the finish latch
    on the device and one readback per block. Prefill is exact-length
    (the JAX engine's bucketed prefill is not ported)."""

    num_slots: int = 4
    decode_steps: int = 1

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, "
                             f"got {self.num_slots}")
        if self.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, "
                             f"got {self.decode_steps}")


@dataclasses.dataclass(frozen=True)
class PagedEngineConfig(EngineConfig):
    """Knobs of :class:`PagedServingEngine`. ``num_slots`` is the decode
    lane count; ``page_size`` positions per page; ``num_pages`` the pool
    capacity (0 = ``num_slots * ceil(max_seq / page_size)``, the slot
    engine's equal budget; one scratch page is added for parked lanes);
    ``attention_impl`` the pool read path, ``"gather"`` or ``"kernel"``
    (the counterpart of the JAX engine's ``"pallas"``)."""

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


# static width of the per-lane stop-id matrix the S>1 block carries (the
# JAX EngineConfig.max_stop_tokens default)
MAX_STOP_TOKENS = 4

# the slot engine's read path: the masked-softmax decode formula over a
# (slots, max_seq, h_kv, D) cache, row b masked by its own pos[b] — the
# same function the paged gather path runs over its gathered pages
_slot_cached_attention = kernels.decode_attention


def _lane_decode(params: dict, token: torch.Tensor, pos: torch.Tensor,
                 cfg: TransformerConfig, attend) -> torch.Tensor:
    """The decode block math shared by the slot and paged steps: token
    (lanes,) at per-lane positions ``pos`` (lanes,) -> logits (lanes,
    vocab). ``attend(layer, q, k, v)`` writes the lane's K/V and returns
    its attention output. Rope phases are computed once per step (the
    JAX engine's ``_rope_slots``: per-row positions, f32 phases)."""
    s = token.shape[0]
    x = params["embed"][token][:, None, :]
    if not cfg.rope:
        x = x + params["pos"][pos][:, None, :]
    else:
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:, None, None, :], sin[:, None, None, :]
    for i, layer in enumerate(params["layers"]):
        q, k, v = attention_projections(layer, rmsnorm(x, layer["ln1"]),
                                        cfg)
        if cfg.rope:
            q = rotate_half_split(q, cos, sin)
            k = rotate_half_split(k, cos, sin)
        attn = attend(i, q, k, v)
        x = x + attn.reshape(s, 1, -1) @ layer["wo"]
        x = x + feed_forward(layer, rmsnorm(x, layer["ln2"]))
    return lm_logits(params, rmsnorm(x, params["out_norm"]), cfg)[:, 0, :]


def _write_slot_rows(cache: torch.Tensor, layer: int, vals: torch.Tensor,
                     pos: torch.Tensor,
                     mask: "torch.Tensor | None" = None) -> None:
    """``cache[layer, s, pos[s]] = vals[s]`` for every slot, in place; a
    lane with ``mask`` False keeps its old value."""
    rows = torch.arange(vals.shape[0], device=vals.device)
    p = pos.long()
    if mask is not None:
        vals = torch.where(mask[:, None, None], vals, cache[layer, rows, p])
    cache[layer, rows, p] = vals


def _slot_decode_step(params: dict, kv: dict, token: torch.Tensor,
                      pos: torch.Tensor, cfg: TransformerConfig,
                      write_mask: "torch.Tensor | None" = None):
    """``decode_step`` with a per-slot position vector over the slot
    cache (layers, slots, max_seq, kv_heads, head_dim). Returns (kv,
    logits (slots, vocab))."""

    def attend(i, q, k, v):
        _write_slot_rows(kv["k"], i, k[:, 0].to(kv["k"].dtype), pos,
                         write_mask)
        _write_slot_rows(kv["v"], i, v[:, 0].to(kv["v"].dtype), pos,
                         write_mask)
        return _slot_cached_attention(q, kv["k"][i], kv["v"][i], pos,
                                      window=cfg.attn_window)

    return kv, _lane_decode(params, token, pos, cfg, attend)


def _engine_step(params: dict, state: dict, pos: torch.Tensor,
                 decode_fn):
    """One greedy step for every lane: pick each lane's token from the
    carried logits, advance every lane at its own position through
    ``decode_fn(params, kv, tok, pos, write_mask)`` (the slot or paged
    lane step). Returns (state, packed (2, lanes) int32): the tokens, and
    the finite-output guard (1 iff the logits the token came from were
    all finite)."""
    logits_in = state["logits"]
    tok = logits_in.argmax(dim=-1).to(torch.int32)
    finite = torch.isfinite(logits_in).all(dim=-1)
    _, state["logits"] = decode_fn(params, state, tok, pos, None)
    return state, torch.stack([tok, finite.to(torch.int32)])


def _engine_multi_step(params: dict, state: dict, pos: torch.Tensor,
                       done: torch.Tensor, remaining: torch.Tensor,
                       eos_ids: torch.Tensor, stop_ids: torch.Tensor,
                       steps: int, decode_fn):
    """``steps`` greedy steps for every lane (``multi_step_decode`` over
    ``decode_fn``), free lanes marked ``done`` up front. Returns (state,
    packed (steps+2, lanes) int32): the token block, the post-block
    positions, and the per-lane ``bad`` (non-finite logits) flag."""
    (_, logits, pos, _, _, bad), toks = multi_step_decode(
        params, state, state["logits"], pos, done, remaining, eos_ids,
        stop_ids, steps, decode_fn)
    state["logits"] = logits
    return state, torch.cat([toks, pos[None], bad.to(torch.int32)[None]])


def _engine_prefill(params: dict, state: dict, prompt: torch.Tensor,
                    slot: int, cfg: TransformerConfig) -> dict:
    """Prefill ``prompt`` (1, L) into ``slot``'s cache row. The row beyond
    L is cleared, not merely masked."""
    k, v, logits = prefill_kv(params, prompt, cfg)
    n = prompt.shape[1]
    for name, new in (("k", k), ("v", v)):
        row = state[name][:, slot]
        row.zero_()
        row[:, :n] = new[:, 0].to(row.dtype)
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
        vals = torch.where(mask[:, None, None], vals, pool[layer, page, off])
    pool[layer, page, off] = vals


def _paged_decode_step(params: dict, kv: dict, token: torch.Tensor,
                       pos: torch.Tensor, page_table: torch.Tensor,
                       cfg: TransformerConfig, impl: str,
                       write_mask: "torch.Tensor | None" = None):
    """The slot step with K/V in the page pool: table-routed writes, and
    the read through ``impl`` — ``"gather"`` (gathered pages + the slot
    formula) or ``"kernel"`` (``paged_attention``). ``page_table``
    (lanes, n_pt) and ``pos`` (lanes,) are int32 on the pool's device.
    Returns (kv, logits (lanes, vocab))."""
    page_size = kv["k"].shape[2]

    def attend(i, q, k, v):
        _write_pool_rows(kv["k"], i, k[:, 0].to(kv["k"].dtype), pos,
                         page_table, page_size, write_mask)
        _write_pool_rows(kv["v"], i, v[:, 0].to(kv["v"].dtype), pos,
                         page_table, page_size, write_mask)
        if impl == "kernel":
            return kernels.paged_attention(q, kv["k"][i], kv["v"][i],
                                           page_table, pos)
        return _slot_cached_attention(
            q, kernels.paged_gather_kv(kv["k"][i], page_table),
            kernels.paged_gather_kv(kv["v"][i], page_table), pos,
            window=cfg.attn_window)

    return kv, _lane_decode(params, token, pos, cfg, attend)


def _engine_paged_prefill(params: dict, state: dict, prompt: torch.Tensor,
                          page_ids: torch.Tensor, slot: int,
                          cfg: TransformerConfig) -> dict:
    """Prefill ``prompt`` (1, L) and write its K/V into the pool pages
    ``page_ids`` (ceil(L/P) ids), positions past L in the last page
    zeroed. A shared page is rewritten with identical bytes."""
    k, v, logits = prefill_kv(params, prompt, cfg)
    n, n_pages = prompt.shape[1], page_ids.shape[0]
    page_size = state["k"].shape[2]
    for name, new in (("k", k), ("v", v)):
        pool = state[name]
        buf = pool.new_zeros((pool.shape[0], n_pages * page_size)
                             + pool.shape[3:])
        buf[:, :n] = new[:, 0].to(pool.dtype)
        pool[:, page_ids] = buf.view((pool.shape[0], n_pages, page_size)
                                     + pool.shape[3:])
    state["logits"][slot] = logits[0].to(state["logits"].dtype)
    return state


def _copy_page(state: dict, src: int, dst: int) -> dict:
    """The COW split's device half: copy page ``src`` to ``dst`` across
    every layer, in place."""
    for name in ("k", "v"):
        state[name][:, dst] = state[name][:, src]
    return state


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one occupied slot."""

    req: Request
    emitted: list


class ServingEngine:
    """Slot owner + device-state holder. The scheduler decides WHAT runs
    (serving/scheduler.py); the engine runs it. The device is the
    parameters' device."""

    def __init__(self, params: dict, cfg: TransformerConfig,
                 ecfg: EngineConfig = EngineConfig(), metrics=None,
                 clock=time.monotonic):
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.metrics = metrics
        self.clock = clock
        self.device = params["embed"].device
        self._state = self._fresh_state()
        n = ecfg.num_slots
        self._pos = np.zeros((n,), np.int32)
        self._slots: list[Optional[_SlotState]] = [None] * n
        # per-lane finish vectors of the S>1 block (-1 = none)
        self._eos = np.full((n,), -1, np.int32)
        self._stops = np.full((n, MAX_STOP_TOKENS), -1, np.int32)
        self._remaining = np.zeros((n,), np.int32)
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.peak_occupied = 0
        # block steps computed for a lane after its done-mask latched
        self.wasted_tokens = 0
        # distinct prompt lengths prefilled (the JAX engine's compiled
        # prefill programs; reported for the same summary shape)
        self.prefill_shapes: set = set()
        # tokens decoded for requests later failed
        self.discarded_tokens = 0

    def _fresh_state(self) -> dict:
        base = init_kv_cache(self.cfg, self.ecfg.num_slots,
                             device=self.device)
        return {"k": base["k"], "v": base["v"],
                "logits": torch.zeros(
                    (self.ecfg.num_slots, self.cfg.vocab_size),
                    dtype=self.cfg.dtype, device=self.device)}

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
                   for n in ("k", "v"))

    # -- admission (prefill) ------------------------------------------

    def _validate_admit(self, req: Request) -> tuple:
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
        if self.ecfg.decode_steps > 1 and len(stops) > MAX_STOP_TOKENS:
            raise ValueError(
                f"request {req.rid}: {len(stops)} stop tokens exceed the "
                f"block's static width MAX_STOP_TOKENS={MAX_STOP_TOKENS}")
        return stops

    def can_admit(self, req: Request) -> bool:
        """Memory gate beyond a free slot: always true for the slot
        engine (a slot IS its reservation)."""
        return True

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: Request) -> None:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                 device=self.device)[None]
        self._state = _engine_prefill(self.params, self._state, prompt,
                                      slot, self.cfg)
        self.prefill_dispatches += 1
        self.prefill_shapes.add(len(req.prompt))

    def admit(self, req: Request) -> int:
        """Prefill ``req`` into a free slot; returns the slot index."""
        stops = self._validate_admit(req)
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError("no free slot (admit gated on "
                               "free_slot_count)") from None
        self._prefill_into(slot, req)
        self._pos[slot] = len(req.prompt)
        self._eos[slot] = -1 if req.eos_token is None else req.eos_token
        self._stops[slot, :] = -1
        for j, t in enumerate(stops[:MAX_STOP_TOKENS]):
            self._stops[slot, j] = t
        self._remaining[slot] = req.max_new_tokens
        self._slots[slot] = _SlotState(req=req, emitted=[])
        self.peak_occupied = max(self.peak_occupied, self.occupied)
        if self.metrics is not None:
            self.metrics.on_admit(req.rid, slot, len(req.prompt))
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
            self.metrics.on_fault_survived(reason)
        self._free_slot(i)
        return (i, slot.req, [], reason)

    def _lane_step(self):
        """The lane decode the dispatches run: (params, kv, tok, pos,
        write_mask) -> (kv, logits)."""
        def decode(params, kv, tok, pos, mask):
            return _slot_decode_step(params, kv, tok, pos, self.cfg, mask)
        return decode

    def _vector(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    @torch.no_grad()
    def step(self) -> list[tuple[int, Request, list, str]]:
        """Advance every occupied slot by ``decode_steps`` tokens.
        Returns completions ``(slot, request, tokens, reason)`` — reason
        ``eos`` / ``stop`` / ``max_tokens`` for successes, ``nan`` for a
        poisoned lane. Finished slots are freed before returning."""
        if self.ecfg.decode_steps > 1:
            return self._step_block()
        self._state, packed = _engine_step(
            self.params, self._state, self._vector(self._pos),
            self._lane_step())
        packed = packed.cpu().numpy()  # the one host readback
        self.decode_dispatches += 1
        toks, finite = packed[0], packed[1]
        finished = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if not finite[i]:
                finished.append(self._fail_lane(i, "nan"))
                continue
            t = int(toks[i])
            slot.emitted.append(t)
            self._pos[i] += 1
            self._remaining[i] -= 1
            req = slot.req
            if self.metrics is not None:
                self.metrics.on_token(req.rid, req.submitted_at)
            reason = self._finish_reason(req, t, len(slot.emitted))
            if reason is not None:
                finished.append((i, req, slot.emitted, reason))
                self._free_slot(i)
                if self.metrics is not None:
                    self.metrics.on_complete(req.rid, len(slot.emitted),
                                             reason)
        return finished

    def _step_block(self) -> list[tuple[int, Request, list, str]]:
        """The S>1 dispatch: one device block, one ``(S+2, lanes)``
        readback, then the host replays each lane's finish condition over
        its tokens (mirroring the device latch) and counts the block steps
        after it as wasted."""
        s_steps = self.ecfg.decode_steps
        done = np.array([s is None for s in self._slots])
        self._state, packed = _engine_multi_step(
            self.params, self._state, self._vector(self._pos),
            self._vector(done), self._vector(self._remaining),
            self._vector(self._eos), self._vector(self._stops), s_steps,
            self._lane_step())
        block = packed.cpu().numpy()  # ONE readback per S steps
        self.decode_dispatches += 1
        toks, dev_pos, bad = \
            block[:s_steps], block[s_steps], block[s_steps + 1]
        finished = []
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            if bad[i]:
                finished.append(self._fail_lane(i, "nan"))
                continue
            req = slot.req
            reason = None
            consumed = 0
            for s in range(s_steps):
                t = int(toks[s, i])
                slot.emitted.append(t)
                consumed += 1
                self._pos[i] += 1
                self._remaining[i] -= 1
                reason = self._finish_reason(req, t, len(slot.emitted))
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
                    self.metrics.on_complete(req.rid, len(slot.emitted),
                                             reason)
                finished.append((i, req, slot.emitted, reason))
                self._free_slot(i)
            elif int(dev_pos[i]) != int(self._pos[i]):
                raise RuntimeError(
                    f"slot {i} (rid {req.rid}): device pos "
                    f"{int(dev_pos[i])} != host replay {self._pos[i]} "
                    f"after a {s_steps}-step block — on-device finish "
                    f"latch and host completion logic diverged")
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
                 metrics=None, clock=time.monotonic):
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
        super().__init__(params, cfg, ecfg, metrics=metrics, clock=clock)
        if ecfg.attention_impl == "kernel" and self.device.type == "cuda":
            kernels.build.load("paged_attention")  # set-up, not TTFT

    def _fresh_state(self) -> dict:
        return {**init_kv_pool(self.cfg, self.pool.num_pages,
                               self.ecfg.page_size, device=self.device),
                "logits": torch.zeros(
                    (self.ecfg.num_slots, self.cfg.vocab_size),
                    dtype=self.cfg.dtype, device=self.device)}

    # -- admission ------------------------------------------------------

    def can_admit(self, req: Request) -> bool:
        return self.pool.can_admit(tuple(req.prompt), req.max_new_tokens)

    @torch.no_grad()
    def _prefill_into(self, slot: int, req: Request) -> None:
        full = tuple(req.prompt)
        n = len(full)
        budget = req.max_new_tokens
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
        n_cov = pages_for(n, self.ecfg.page_size)
        prompt = torch.as_tensor(full, dtype=torch.long,
                                 device=self.device)[None]
        page_ids = torch.as_tensor(pages[:n_cov], dtype=torch.long,
                                   device=self.device)
        self._state = _engine_paged_prefill(self.params, self._state,
                                            prompt, page_ids, slot,
                                            self.cfg)
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

    def step(self) -> list:
        self._prepare_writes()
        return super().step()

    # -- the dispatch paths (page-table operand) ------------------------

    def _page_table_device(self) -> torch.Tensor:
        if self._pt_dirty or self._dev_pt is None:
            self._dev_pt = torch.as_tensor(self._pt, device=self.device)
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


# failure reasons the serve loop hands back to the scheduler's retry
# budget (everything else in a completion tuple is terminal); the port's
# engines fail a request only on a non-finite decode
RETRYABLE_REASONS = frozenset({"nan"})


def serve_loop(engine: ServingEngine, scheduler: RequestScheduler,
               metrics=None, max_dispatches: Optional[int] = None) -> dict:
    """Drive engine + scheduler until both drain. Returns ``{rid:
    (tokens, reason)}``; a terminal failure carries ``[]`` and its status.

    Per iteration: admit every arrived request into free slots (the paged
    engine's free-page gate rides ``pop_ready``), then step — unless
    occupancy is below the scheduler's quorum and more work is due, in
    which case wait for it. A retryable failure goes back through
    ``requeue_failed``. ``max_dispatches`` bounds decode dispatches
    (raises instead of hanging)."""
    results: dict = {}
    if metrics is not None and engine.metrics is None:
        engine.metrics = metrics
    clock = scheduler.clock

    def drain_drops() -> None:
        for req, reason in scheduler.drain_dropped():
            results[req.rid] = ([], reason)
            if metrics is not None:
                metrics.on_drop(req.rid, reason)

    while True:
        now = clock()
        while engine.free_slot_count > 0:
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
