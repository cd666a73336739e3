"""Flash attention for training: plain PyTorch versions and CUDA kernels.

The counterpart of the flash half of
``akka_allreduce_tpu/ops/pallas_kernels/attention.py`` (``flash_attention``
and its custom VJP). Public functions take the JAX layout: q (B, Tq, H, D),
k and v (B, Tk, H_kv, D) with H_kv dividing H (grouped-query attention:
query head h reads KV head h // (H / H_kv)).

* :func:`flash_forward_reference` / :func:`flash_backward_reference` — the
  plain versions: masked f32 scores, online-softmax numerics written out
  as one pass, log-sum-exp saved as (B, H, Tq) f32, and the backward
  recomputing ``p = exp(s - lse)`` as ``_bwd_tile`` does. The cast points
  are the JAX kernels': ``p`` is cast to v's dtype before the PV product,
  ``ds`` to k's dtype for dq and to q's for dk, ``p`` to dO's for dv;
  every product accumulates in f32; the ``D**-0.5`` scale multiplies the
  f32 scores. The CPU path and the kernels' oracle.
* :func:`flash_forward`, :func:`flash_dq`, :func:`flash_dkv` — the
  wrappers: a CPU tensor goes to the plain version; a CUDA tensor launches
  ``csrc/flash_attention.cu`` or raises: bf16 forward, dq and dk/dv on
  tensor cores (``csrc/flash_mma.cuh``), f32 forward, dq and dk/dv on
  tensor cores in split TF32, three TF32 products a product
  (``csrc/flash_tf32.cuh``), at head dims :data:`HEAD_DIMS`.
  :data:`FLASH_FWD_LAUNCHES`, :data:`FLASH_DQ_LAUNCHES` and
  :data:`FLASH_DKV_LAUNCHES` count launches.
* :class:`FlashAttention` (``torch.autograd.Function``),
  :func:`flash_attention` and :func:`flash_causal_attention` — the model's
  entry points. They take no block sizes: the kernels' tile is their own
  constant (64 x 64), and a sequence that is not a multiple of it is
  masked at the edge instead of refused.

``causal`` masks key position ``k_off + j`` above query position
``q_off + i``; ``window`` (causal only, >= 1) also masks keys ``window`` or
more positions back. ``q_off``/``k_off`` only move the mask, so Tq != Tk
with offsets scores a query block against a longer key block. A query
row that no key reaches gets ``o = 0`` (the JAX kernel's ``acc / l`` is
0 / 0 there) and ``lse = -inf``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from akka_allreduce_tpu_torch.ops.kernels import build
from akka_allreduce_tpu_torch.parallel.ring_attention import (
    NEG_INF, expand_kv_heads)

# kernel launches since import (or since a caller reset them to 0); the
# plain versions never count
FLASH_FWD_LAUNCHES = 0
FLASH_DQ_LAUNCHES = 0
FLASH_DKV_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH: dict = {}  # the bound C entry points, set at first launch


def _launchers() -> dict:
    """The built library's entry points, signatures bound once (ctypes
    would otherwise pass each pointer as a 32-bit int)."""
    if not _LAUNCH:
        lib = build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptrs in (("flash_fwd_launch", 5), ("flash_dq_launch", 7),
                             ("flash_dkv_launch", 8)):
            fn = getattr(lib, name)
            # dtype, head_dim, tensors..., geometry (int64[]), scale, stream
            fn.argtypes = ([i32, i32] + [ptr] * n_ptrs
                           + [ptr, ctypes.c_float, ptr])
            fn.restype = i32
            _LAUNCH[name] = fn
        err = lib.flash_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _LAUNCH["error"] = err
    return _LAUNCH


def _check_options(causal: bool, window: Optional[int]) -> None:
    if window is not None and (not causal or window < 1):
        raise ValueError("window needs causal=True and window >= 1")


def score_mask(tq: int, tk: int, causal: bool, window: Optional[int],
               q_off: int, k_off: int, device) -> Optional[torch.Tensor]:
    """(Tq, Tk) bool, True where query i may attend key j (None: all)."""
    if not causal:
        return None
    q_pos = q_off + torch.arange(tq, device=device)
    k_pos = k_off + torch.arange(tk, device=device)
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def scores(q, k, causal, window, q_off, k_off) -> torch.Tensor:
    """(B, H, Tq, Tk) f32 scaled scores, masked lanes at ``NEG_INF``."""
    k, _ = expand_kv_heads(q, k, k)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float()) * q.shape[-1] ** -0.5
    mask = score_mask(q.shape[1], k.shape[1], causal, window, q_off, k_off,
                      q.device)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    return s


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None, q_off: int = 0,
                            k_off: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``(o (B, Tq, H, D) in q's dtype, lse (B, H, Tq)
    f32)``. The flash kernel's arithmetic in one pass: unnormalised
    ``p = exp(s - m)`` (exactly 0 on masked lanes) cast to v's dtype,
    the PV product in f32, then the division by the row sum (by 1 where
    the row has no live key, so its o is 0)."""
    _check_options(causal, window)
    s = scores(q, k, causal, window, q_off, k_off)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(s > NEG_INF / 2, p, 0.0)
    l_sum = p.sum(dim=-1, keepdim=True)
    _, v_e = expand_kv_heads(q, v, v)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                       v_e.float())
    o = (acc / torch.where(l_sum > 0, l_sum, 1.0)).transpose(1, 2).to(
        q.dtype)
    lse = (m + torch.log(l_sum))[..., 0]
    return o, lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO . O)`` in f32, (B, H, Tq): the rowwise term of
    the softmax gradient (an XLA op outside the Pallas kernels in JAX,
    one PyTorch op here)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(),
                        o.float()).contiguous()


def backward_f32(q, k, v, do, lse, delta, causal, window, q_off, k_off
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward's (dq, dk, dv) in f32, before the final cast:
    ``_bwd_tile``'s arithmetic with its cast points, dk/dv summed over
    each KV head's query group in f32 (the ring kernels' partials)."""
    s = scores(q, k, causal, window, q_off, k_off)
    p = torch.exp(s - lse[..., None])  # masked lanes exactly 0
    k_e, v_e = expand_kv_heads(q, k, v)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v_e.float())
    ds = p * (dp - delta[..., None]) * q.shape[-1] ** -0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k_e.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    b, tk, h_kv, d = k.shape
    g = q.shape[2] // h_kv
    # the group's query heads sum into their KV head in f32, cast once
    dk = dk.reshape(b, tk, h_kv, g, d).sum(dim=3)
    dv = dv.reshape(b, tk, h_kv, g, d).sum(dim=3)
    return dq, dk, dv


def _backward_reference(q, k, v, do, lse, delta, causal, window, q_off,
                        k_off):
    dq, dk, dv = backward_f32(q, k, v, do, lse, delta, causal, window, q_off,
                              k_off)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True,
                             window: Optional[int] = None, q_off: int = 0,
                             k_off: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain backward from the saved ``o`` and ``lse``: ``(dq, dk, dv)``
    in q's, k's and v's dtypes, dk/dv summed over each KV head's query
    group."""
    _check_options(causal, window)
    return _backward_reference(q, k, v, do, lse, attention_delta(o, do),
                               causal, window, q_off, k_off)


# -- the CUDA wrappers ---------------------------------------------------

def check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be (B, Tq, H, D) and k, v one (B, Tk, H_kv, D) shape; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not serve q {tuple(q.shape)} (batch "
            f"and head_dim must match, H_kv must divide H)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, "
                         f"v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, got "
                         f"{q.device}")


def kernel_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: unit stride along D, every other
    stride and the base 16-byte aligned (the tile loads are 16-byte
    vectors); anything else is copied to a contiguous tensor."""
    per16 = 16 // x.element_size()
    if x.stride(-1) == 1 and all(s % per16 == 0 for s in x.stride()[:3]) \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def geometry(q, k, v, do, causal, window, q_off, k_off):
    """The int64 geometry block the C entry points read."""
    b, tq, h, _ = q.shape
    _, tk, h_kv, _ = k.shape
    dims = [b, h, h_kv, tq, tk, int(causal), window or 0, q_off, k_off]
    for t in (q, k, v, do):
        dims += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    return (ctypes.c_int64 * len(dims))(*dims)


def launch(fns: dict, name: str, q, tensors: list, geom) -> None:
    """Launch entry point ``name`` of a bound library (``fns``, with its
    ``"error"`` string function) on q's device and current stream;
    raises if the launch fails."""
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fns[name](_DTYPE_CODES[q.dtype], d,
                       *[t.data_ptr() for t in tensors],
                       ctypes.addressof(geom), d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {fns['error'](rc).decode()} "
                           f"({rc})")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  q_off: int = 0, k_off: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` as :func:`flash_forward_reference`. On CUDA tensors:
    one launch of the forward kernel (tensor cores: bf16, or f32 in split
    TF32) into ``torch.empty`` outputs on the current stream; raises if
    the launch fails."""
    global FLASH_FWD_LAUNCHES
    _check_options(causal, window)
    check_qkv(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, window, q_off,
                                       k_off)
    q, k, v = kernel_view(q), kernel_view(k), kernel_view(v)
    b, tq, h, _ = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    launch(_launchers(), "flash_fwd_launch", q, [q, k, v, o, lse],
           geometry(q, k, v, None, causal, window, q_off, k_off))
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def check_bwd(q, do, lse, delta) -> None:
    b, tq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype} "
                         f"vs {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({b}, {h}, {tq}) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")


def flash_dq(q, k, v, do, lse, delta, causal: bool = True,
             window: Optional[int] = None, q_off: int = 0,
             k_off: int = 0) -> torch.Tensor:
    """dq from the saved ``lse`` and ``delta = rowsum(dO . O)``. On CUDA
    tensors: one launch of the dq kernel (tensor cores: bf16, or f32 in
    split TF32) into a ``torch.empty`` output; raises if it fails."""
    global FLASH_DQ_LAUNCHES
    _check_options(causal, window)
    check_qkv(q, k, v)
    check_bwd(q, do, lse, delta)
    if q.device.type == "cpu":
        return _backward_reference(q, k, v, do, lse, delta, causal, window,
                                   q_off, k_off)[0]
    q, k, v, do = (kernel_view(t) for t in (q, k, v, do))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch(_launchers(), "flash_dq_launch", q,
           [q, k, v, do, lse, delta, dq],
           geometry(q, k, v, do, causal, window, q_off, k_off))
    FLASH_DQ_LAUNCHES += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True,
              window: Optional[int] = None, q_off: int = 0,
              k_off: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each KV head's gradient summed over its query group. On
    CUDA tensors: one launch of the dk/dv kernel (tensor cores: bf16, or
    f32 in split TF32; one block per KV head and key tile walks the whole
    group, so nothing is lost and nothing needs atomics) into
    ``torch.empty`` outputs; raises if it fails."""
    global FLASH_DKV_LAUNCHES
    _check_options(causal, window)
    check_qkv(q, k, v)
    check_bwd(q, do, lse, delta)
    if q.device.type == "cpu":
        return _backward_reference(q, k, v, do, lse, delta, causal, window,
                                   q_off, k_off)[1:]
    q, k, v, do = (kernel_view(t) for t in (q, k, v, do))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    launch(_launchers(), "flash_dkv_launch", q,
           [q, k, v, do, lse, delta, dk, dv],
           geometry(q, k, v, do, causal, window, q_off, k_off))
    FLASH_DKV_LAUNCHES += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward saves ``o`` and the
    f32 ``lse``; the backward computes ``delta`` once and runs the dq and
    dk/dv wrappers (kernels on CUDA tensors, plain versions on CPU
    ones)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_off, k_off):
        o, lse = flash_forward(q, k, v, causal, window, q_off, k_off)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.options = (causal, window, q_off, k_off)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(o, do)
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.options)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.options)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_off: int = 0, k_off: int = 0) -> torch.Tensor:
    """Fused attention. q: (B, Tq, H, D); k/v: (B, Tk, H_kv, D) ->
    (B, Tq, H, D) in q's dtype, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, window, q_off, k_off)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Drop-in ``attn_fn`` (models/transformer.py): causal flash attention
    in the model's (B, T, H, D) convention."""
    return flash_attention(q, k, v, True, window)
