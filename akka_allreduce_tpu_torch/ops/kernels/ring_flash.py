"""Ring flash attention: sequence-parallel attention on the ring kernels.

The counterpart of ``akka_allreduce_tpu/ops/pallas_kernels/ring_flash.py``.
Rank ``j`` of the ``sp`` axis owns positions ``[j T, (j + 1) T)``; the
narrow K/V blocks (H_kv heads) travel around the ring
(``parallel/group.py RankGroup.ppermute``) and each hop runs one kernel
on the block the rank holds:

* :func:`ring_fwd` — fold the block into the running ``(m, l)`` (B, H, T)
  and ``acc`` (B, T, H, D), all f32 and UNNORMALISED; the ring divides
  ``acc / l`` and takes ``lse = m + log l`` once, after the last hop.
* :func:`ring_dq` — add the hop's f32 partial dq into the rank's f32 dq.
* :func:`ring_dkv` — add the hop's f32 partial (dk, dv) of the VISITING
  block, summed over the GQA group, into the f32 (dk, dv) that travel
  with that block and reach home after the n-th rotation.

The wrappers update their f32 state in place and return it. A CPU tensor
goes to the plain versions (:func:`ring_fwd_reference`,
:func:`ring_bwd_reference`: ``_softmax_tile`` / ``_bwd_tile`` over the
whole block, the JAX cast points); a CUDA tensor launches
``csrc/ring_flash.cu`` or raises: the forward, dq and dk/dv on tensor
cores, on the flash kernels' folds (bf16: ``csrc/flash_mma.cuh``; f32 in
split TF32, three TF32 products a product: ``csrc/flash_tf32.cuh``).
:data:`RING_FWD_LAUNCHES`,
:data:`RING_DQ_LAUNCHES` and :data:`RING_DKV_LAUNCHES` count launches.

:class:`RingFlashAttention` is the ring (``_ring_fwd`` /
``_ring_bwd_rule``) as a ``torch.autograd.Function``, and
:func:`ring_flash_attention` its entry point in the JAX layout. The
gradients stay f32 across hops and are cast to the inputs' dtypes once at
the end (the port's ``flash_dq`` / ``flash_dkv`` return q's dtype, so the
ring is not built from them). The first hop is the rank's own diagonal
block, so every query row has a live key before a masked tile can
reach its running max. A causal hop whose block lies wholly in the
queries' future (``src > j``) launches nothing, but the rotation after it
happens on every rank at every hop, so the ring never desynchronises.
"""

from __future__ import annotations

import ctypes

import torch

from akka_allreduce_tpu_torch.ops.kernels import build
from akka_allreduce_tpu_torch.ops.kernels.flash_attention import (
    attention_delta, backward_f32, check_bwd, check_qkv, geometry,
    kernel_view, launch, scores)
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    NEG_INF, expand_kv_heads, rotate)

# kernel launches since import (or since a caller reset them to 0); the
# plain versions never count
RING_FWD_LAUNCHES = 0
RING_DQ_LAUNCHES = 0
RING_DKV_LAUNCHES = 0

_LAUNCH: dict = {}  # the bound C entry points, set at first launch


def _launchers() -> dict:
    if not _LAUNCH:
        lib = build.load("ring_flash")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptrs in (("ring_fwd_launch", 6), ("ring_dq_launch", 7),
                             ("ring_dkv_launch", 8)):
            fn = getattr(lib, name)
            # dtype, head_dim, tensors..., geometry (int64[]), scale, stream
            fn.argtypes = ([i32, i32] + [ptr] * n_ptrs
                           + [ptr, ctypes.c_float, ptr])
            fn.restype = i32
            _LAUNCH[name] = fn
        err = lib.ring_flash_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _LAUNCH["error"] = err
    return _LAUNCH


def counts() -> dict:
    return {"ring_fwd": RING_FWD_LAUNCHES, "ring_dq": RING_DQ_LAUNCHES,
            "ring_dkv": RING_DKV_LAUNCHES}


def reset_counts() -> None:
    global RING_FWD_LAUNCHES, RING_DQ_LAUNCHES, RING_DKV_LAUNCHES
    RING_FWD_LAUNCHES = RING_DQ_LAUNCHES = RING_DKV_LAUNCHES = 0


# -- the plain versions ----------------------------------------------------

def ring_fwd_reference(q, k, v, m, l_sum, acc, q_off: int, k_off: int,
                       causal: bool = True):
    """One hop's new ``(m, l, acc)``, ``_softmax_tile`` over the whole
    block: masked f32 scores, the running max, ``p = exp(s - m')``
    exactly 0 on masked lanes (the where-guard), ``p`` cast to v's dtype
    before the f32 PV product."""
    s = scores(q, k, causal, None, q_off, k_off)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(torch.minimum(m, m_new) - m_new)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l_sum * corr + p.sum(dim=-1)
    _, v_e = expand_kv_heads(q, v, v)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v_e.float())
    return m_new, l_new, acc * corr.transpose(1, 2)[..., None] + pv


def ring_bwd_reference(q, k, v, do, lse, delta, q_off: int, k_off: int,
                       causal: bool = True):
    """One hop's f32 partials ``(dq, dk, dv)`` recomputed from ``lse``
    and ``delta``: ``_bwd_tile`` over the whole block, dk/dv at H_kv heads
    summed over the group."""
    return backward_f32(q, k, v, do, lse, delta, causal, None, q_off, k_off)


# -- the CUDA wrappers -----------------------------------------------------

def _check_f32(name: str, t: torch.Tensor, shape: tuple, like) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 \
            or not t.is_contiguous() or t.device != like.device \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"{tuple(shape)} float32 tensor on {like.device}; "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def ring_fwd(q, k, v, m, l_sum, acc, q_off: int, k_off: int,
             causal: bool = True):
    """Fold the block (k, v) at key offset ``k_off`` into this rank's
    carry (queries at ``q_off``) in place; returns ``(m, l, acc)``. On
    CUDA tensors: one launch of the ring forward kernel (tensor cores:
    bf16, or f32 in split TF32)."""
    global RING_FWD_LAUNCHES
    check_qkv(q, k, v)
    b, tq, h, d = q.shape
    _check_f32("m", m, (b, h, tq), q)
    _check_f32("l", l_sum, (b, h, tq), q)
    _check_f32("acc", acc, (b, tq, h, d), q)
    if q.device.type == "cpu":
        new = ring_fwd_reference(q, k, v, m, l_sum, acc, q_off, k_off,
                                 causal)
        for old, x in zip((m, l_sum, acc), new):
            old.copy_(x)
        return m, l_sum, acc
    q, k, v = kernel_view(q), kernel_view(k), kernel_view(v)
    launch(_launchers(), "ring_fwd_launch", q, [q, k, v, m, l_sum, acc],
           geometry(q, k, v, None, causal, None, q_off, k_off))
    RING_FWD_LAUNCHES += 1
    return m, l_sum, acc


def ring_dq(q, k, v, do, lse, delta, dq, q_off: int, k_off: int,
            causal: bool = True):
    """``dq += `` the hop's f32 partial dq, in place; returns dq. On CUDA
    tensors: one launch of the ring dq kernel (bf16 on tensor cores, f32
    on tensor cores in split TF32)."""
    global RING_DQ_LAUNCHES
    check_qkv(q, k, v)
    check_bwd(q, do, lse, delta)
    _check_f32("dq", dq, q.shape, q)
    if q.device.type == "cpu":
        return dq.add_(ring_bwd_reference(q, k, v, do, lse, delta, q_off,
                                          k_off, causal)[0])
    q, k, v, do = (kernel_view(t) for t in (q, k, v, do))
    launch(_launchers(), "ring_dq_launch", q,
           [q, k, v, do, lse, delta, dq],
           geometry(q, k, v, do, causal, None, q_off, k_off))
    RING_DQ_LAUNCHES += 1
    return dq


def ring_dkv(q, k, v, do, lse, delta, dk, dv, q_off: int, k_off: int,
             causal: bool = True):
    """``dk, dv += `` the visiting block's f32 partials (H_kv heads, the
    group's query heads summed), in place; returns (dk, dv). On CUDA
    tensors: one launch of the ring dk/dv kernel (bf16 on tensor cores,
    f32 on tensor cores in split TF32; one block per key tile and KV head
    walks the whole group: no atomics)."""
    global RING_DKV_LAUNCHES
    check_qkv(q, k, v)
    check_bwd(q, do, lse, delta)
    _check_f32("dk", dk, k.shape, q)
    _check_f32("dv", dv, v.shape, q)
    if q.device.type == "cpu":
        _, dk_p, dv_p = ring_bwd_reference(q, k, v, do, lse, delta, q_off,
                                           k_off, causal)
        return dk.add_(dk_p), dv.add_(dv_p)
    q, k, v, do = (kernel_view(t) for t in (q, k, v, do))
    launch(_launchers(), "ring_dkv_launch", q,
           [q, k, v, do, lse, delta, dk, dv],
           geometry(q, k, v, do, causal, None, q_off, k_off))
    RING_DKV_LAUNCHES += 1
    return dk, dv


# -- the ring ----------------------------------------------------------------

class RingFlashAttention(torch.autograd.Function):
    """The ring of hops with its hand-built backward. Forward: hop s
    scores the block of rank ``src = (j - s) mod n`` (skipped when causal
    and ``src > j``), then the stacked K/V move one rank on (n - 1
    rotations: the block after the last hop is not needed). Backward:
    ``delta`` once, then a second rotation in which each hop adds the
    local dq partial and the visiting block's (dk, dv) partials, which
    rotate WITH the block: n rotations bring every block's (dk, dv) home
    with every rank's contribution on board."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        b, t, h, d = q.shape
        n, idx = group.axis_size("sp"), group.axis_index("sp")
        m = torch.full((b, h, t), NEG_INF, device=q.device)
        l_sum = torch.zeros((b, h, t), device=q.device)
        acc = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
        kv = kv_home = torch.stack([k, v])
        for s in range(n):
            src = (idx - s) % n
            if not causal or src <= idx:
                ring_fwd(q, kv[0], kv[1], m, l_sum, acc, idx * t, src * t,
                         causal)
            if s < n - 1:
                kv = rotate(kv, group)
        # causal rows see their own position, so l > 0
        o = (acc / l_sum.transpose(1, 2)[..., None]).to(q.dtype)
        lse = m + torch.log(l_sum)
        ctx.save_for_backward(q, kv_home, o, lse)
        ctx.ring = (group, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, o, lse = ctx.saved_tensors
        group, causal = ctx.ring
        b, t, h, d = q.shape
        n, idx = group.axis_size("sp"), group.axis_index("sp")
        do = do.contiguous()
        delta = attention_delta(o, do)
        dq = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            src = (idx - s) % n
            if not causal or src <= idx:
                offs = (idx * t, src * t, causal)
                ring_dq(q, kv[0], kv[1], do, lse, delta, dq, *offs)
                ring_dkv(q, kv[0], kv[1], do, lse, delta, dkv[0], dkv[1],
                         *offs)
            if s < n - 1:
                kv = rotate(kv, group)
            dkv = rotate(dkv, group)
        dk, dv = dkv.to(kv.dtype)
        return dq.to(q.dtype), dk, dv, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention on this ``sp`` rank of ``group``: q
    (B, T, H, D), k and v (B, T, H_kv, D), H_kv dividing H; returns
    (B, T, H, D) in q's dtype, differentiable in q, k and v. Matches
    ``parallel/ring_attention.py ring_attention`` (the oracle). Any T
    works: the kernels mask a ragged tile edge."""
    return RingFlashAttention.apply(q, k, v, group, causal)
