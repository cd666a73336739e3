"""Attention of the port on one rank and across the ``sp`` ranks: the
counterpart of ``akka_allreduce_tpu/parallel/ring_attention.py``.

Single rank: ``NEG_INF``, :func:`expand_kv_heads`,
:func:`local_causal_attention` (the oracle) and
:func:`blockwise_causal_attention` (``attn_impl="blockwise"``).

Sequence parallelism (rank ``j`` of the ``sp`` axis owns positions
``[j T, (j + 1) T)`` of the global sequence; the ``group`` argument is the
rank's ``parallel/group.py RankGroup``):

* :func:`ring_attention` — the plain ring and the oracle of the kernel
  ring (``ops/kernels/ring_flash.py``): K/V rotate around the ``sp`` ring
  while each rank folds every block into its queries' online softmax.
* :func:`windowed_sp_attention` / :func:`flash_windowed_sp_attention` —
  sliding windows under sp: one exchange of the previous rank's last
  ``window - 1`` K/V columns instead of the ring; the flash variant
  scores them with the flash kernels.

Every exchange goes through :func:`rotate`, which adds its host time to
:data:`EXCHANGE_SECONDS` (eager exchanges only: one that a CUDA graph
captures is neither synchronized nor timed). The exchanges are
differentiable the JAX way (:class:`PPermute`: the backward sends the
gradient back the way the block came), and every rank's graph holds the
same exchanges in the same order: a rank that dropped one would leave
its peers waiting on the ring.
"""

from __future__ import annotations

import time

import torch

NEG_INF = -1e30

# host seconds spent in the attention's eager exchanges since import (or
# since a caller reset it to 0); on the card each span starts and ends
# with the stream drained, so it is the exchange's own time (on the ipc
# transport that includes the stream's wait for the peer's push); an
# exchange captured into a CUDA graph adds nothing
EXCHANGE_SECONDS = 0.0


def rotate(x: torch.Tensor, group, shift: int = 1,
           axis: str = "sp") -> torch.Tensor:
    """``group.ppermute(x, axis, shift)``, timed into
    :data:`EXCHANGE_SECONDS`; while a CUDA graph captures it, neither
    synchronized nor timed."""
    global EXCHANGE_SECONDS
    cuda = x.device.type == "cuda"
    if cuda and torch.cuda.is_current_stream_capturing():
        return group.ppermute(x, axis, shift)
    if cuda:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    out = group.ppermute(x, axis, shift)
    if cuda:
        torch.cuda.current_stream(x.device).synchronize()
    EXCHANGE_SECONDS += time.perf_counter() - t0
    return out


class PPermute(torch.autograd.Function):
    """Differentiable :func:`rotate`: ``lax.ppermute``, whose transpose
    sends the cotangent ``-shift`` steps back along the axis."""

    @staticmethod
    def forward(ctx, x, group, shift, axis):
        ctx.route = (group, shift, axis)
        return rotate(x, group, shift, axis)

    @staticmethod
    def backward(ctx, grad):
        group, shift, axis = ctx.route
        return rotate(grad.contiguous(), group, -shift, axis), None, None, \
            None


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


def _block_attention(q, k, v, m, l_sum, acc, q_offset: int, k_offset: int,
                     causal: bool = True):
    """One online-softmax accumulation step over a K/V block.

    q: (B, Tq, H, D); k, v: (B, Tk, H or H_kv, D); m, l_sum: (B, H, Tq)
    f32; acc: (B, Tq, H, D) f32. Offsets are the blocks' global sequence
    positions, used for the causal mask."""
    k, v = expand_kv_heads(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # correction of the running stats (the min guards exp(-inf - -inf))
    correction = torch.exp(torch.minimum(m, m_new) - m_new)
    p = torch.exp(scores - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
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


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention over sequence-sharded q (B, T, H, D) and
    k, v (B, T, H_kv, D) on this ``sp`` rank: at hop s the rank holds the
    block of rank ``(j - s) mod n``, folds it into (m, l, acc) in f32 and
    passes it on; the stacked narrow K/V travel as one tensor. The JAX
    ring skips the causal hops that lie wholly in the queries' future;
    here they are folded too: every score masked leaves (m, l, acc)
    bitwise unchanged and the block's gradient zero, and the rotation
    after each hop keeps a backward on every rank (with the skip, rank j
    would use only j + 1 of the blocks that pass through it, and its
    autograd would drop the others' return trips). The block after the
    last hop is not needed, so n - 1 rotations."""
    n, idx = group.axis_size("sp"), group.axis_index("sp")
    b, t, h, _ = q.shape
    m = torch.full((b, h, t), NEG_INF, device=q.device)
    l_sum = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n):
        src = (idx - s) % n
        m, l_sum, acc = _block_attention(q, kv[0], kv[1], m, l_sum, acc,
                                         idx * t, src * t, causal)
        if s < n - 1:
            kv = PPermute.apply(kv, group, 1, "sp")
    # causal rows always include the query's own position, so l > 0
    return (acc / l_sum.transpose(1, 2)[..., None]).to(q.dtype)


def _neighbor_tail_exchange(k: torch.Tensor, v: torch.Tensor, tail: int,
                            group) -> torch.Tensor:
    """The previous ``sp`` rank's last ``tail`` K/V columns, stacked (2,
    B, tail, H_kv, D): the one exchange both windowed-SP paths share.
    Rank 0 receives the last rank's wrap-around tail; callers mask or
    bypass it."""
    t = k.shape[1]
    return PPermute.apply(torch.stack([k[:, t - tail:], v[:, t - tail:]]),
                          group, 1, "sp")


def _check_window_fits(window: int, t: int) -> int:
    tail = window - 1
    if tail > t:
        raise ValueError(
            f"attn_window={window} under sequence parallelism needs "
            f"window - 1 <= local sequence ({t}); raise --seq, lower "
            f"--sp, or shrink the window")
    return tail


def windowed_sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int, group) -> torch.Tensor:
    """Sliding-window causal attention under sequence parallelism (the
    plain path and oracle): with ``window - 1 <= T`` a query's keys live
    in its own block plus the previous rank's last ``window - 1``
    columns, so one neighbour exchange replaces the ring. Rank 0's
    wrapped tail gets negative key positions and the mask drops it. f32
    scores and softmax, probabilities cast to v's dtype."""
    b, t, h, d = q.shape
    tail = _check_window_fits(window, t)
    idx = group.axis_index("sp")
    if tail > 0:
        prev = _neighbor_tail_exchange(k, v, tail, group)
        k_cat = torch.cat([prev[0], k], dim=1)
        v_cat = torch.cat([prev[1], v], dim=1)
    else:
        k_cat, v_cat = k, v
    k_exp, v_exp = expand_kv_heads(q, k_cat, v_cat)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_exp.float()) * d ** -0.5
    q_pos = idx * t + torch.arange(t, device=q.device)
    k_pos = idx * t - tail + torch.arange(k_cat.shape[1], device=q.device)
    mask = ((q_pos[:, None] >= k_pos[None, :])
            & (q_pos[:, None] - k_pos[None, :] < window)
            & (k_pos[None, :] >= 0))
    p = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v_exp.dtype).float(),
                       v_exp.float())
    return out.to(q.dtype)


class _FlashWindowedSP(torch.autograd.Function):
    """The flash kernels on [previous rank's tail ++ this block]: the
    forward exchanges the tail and runs the flash forward with the
    queries at ``q_off = tail`` in the key frame; the backward runs the
    flash dq and dk/dv and sends the tail's (dk, dv) back to the rank it
    came from (zeros from rank 0, which scored its own block alone), so
    every rank makes the same exchanges."""

    @staticmethod
    def forward(ctx, q, k, v, window, group):
        from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
        tail = window - 1
        prev = _neighbor_tail_exchange(k, v, tail, group)
        first = group.axis_index("sp") == 0
        if first:  # no previous block: the wrapped tail is not attended
            k_cat, v_cat, q_off = k, v, 0
        else:
            k_cat = torch.cat([prev[0], k], dim=1)
            v_cat = torch.cat([prev[1], v], dim=1)
            q_off = tail
        o, lse = fa.flash_forward(q, k_cat, v_cat, True, window, q_off, 0)
        ctx.save_for_backward(q, k_cat, v_cat, o, lse)
        ctx.meta = (window, q_off, tail, group, first)
        return o

    @staticmethod
    def backward(ctx, do):
        from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
        q, k_cat, v_cat, o, lse = ctx.saved_tensors
        window, q_off, tail, group, first = ctx.meta
        do = do.contiguous()
        delta = fa.attention_delta(o, do)
        opts = (True, window, q_off, 0)
        dq = fa.flash_dq(q, k_cat, v_cat, do, lse, delta, *opts)
        dk, dv = fa.flash_dkv(q, k_cat, v_cat, do, lse, delta, *opts)
        if first:
            back = torch.zeros((2, dk.shape[0], tail) + dk.shape[2:],
                               dtype=dk.dtype, device=dk.device)
        else:
            back = torch.stack([dk[:, :tail], dv[:, :tail]])
            dk, dv = dk[:, tail:].clone(), dv[:, tail:].clone()
        back = rotate(back, group, -1)  # home: the rank that sent the tail
        t = dk.shape[1]
        dk[:, t - tail:] += back[0]
        dv[:, t - tail:] += back[1]
        return dq, dk, dv, None, None


def flash_windowed_sp_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, window: int,
                                group) -> torch.Tensor:
    """Kernel-served :func:`windowed_sp_attention`: the same neighbour
    exchange, with the flash kernels (``ops/kernels/flash_attention.py``)
    scoring the concatenated block. The JAX path front-pads the concat to
    a block multiple (``q_off = pad + tail``); the port's kernels mask a
    ragged key edge, so the pad is 0 and ``q_off = tail``. Rank 0 scores
    its own block alone (a Python ``if`` on the rank); the exchange and
    its return trip stay outside that branch."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    tail = _check_window_fits(window, q.shape[1])
    if tail == 0:
        return fa.flash_attention(q, k, v, True, window)
    return _FlashWindowedSP.apply(q, k, v, window, group)
