"""Paged decode attention: the plain PyTorch version and the CUDA kernel.

The counterpart of ``akka_allreduce_tpu/ops/pallas_kernels/attention.py``
for the serving engine's KV-pool read path. The pool keeps the JAX
package's layout, ``(num_pages, P, h_kv, D)`` per layer, and the kernel
reads it as it is (no relayout per step).

* :func:`paged_gather_attention` — the plain version: gather each lane's
  pages into logical order, then the slot engine's masked-softmax decode
  formula, op for op the JAX function (f32 scores and softmax, ``NEG_INF``
  mask, GQA grouping ``q.reshape(b, 1, h_kv, g, d)``). The CPU path and
  the kernel's oracle.
* :func:`paged_attention` — the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/paged_attention.cu`` (a split-KV
  kernel: :func:`paged_splits` blocks a (KV head, lane) pair, one thread
  block cluster, merging their partial softmaxes) or raises.
  :data:`PAGED_ATTENTION_LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from akka_allreduce_tpu_torch.ops.kernels import build
from akka_allreduce_tpu_torch.parallel.ring_attention import NEG_INF

# kernel launches since import (or since a caller reset it to 0); the
# plain version never counts
PAGED_ATTENTION_LAUNCHES = 0

# blocks a (KV head, lane) pair's pages are split over: at most a
# portable cluster
MAX_SPLITS = 8
# a shared-memory stage, the kernel's online-softmax step: whole pages, at
# most this many keys and bytes of K and V
STAGE_KEYS = 64
STAGE_BYTES = 32 * 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH: dict = {}  # the bound C entry points, set at first launch
_SM_COUNT: dict = {}  # device index -> streaming multiprocessors


def _launcher():
    """``(launch, error_string)`` of the built library, signatures bound
    once (ctypes would otherwise pass each pointer as a 32-bit int)."""
    if not _LAUNCH:
        lib = build.load("paged_attention")
        fn = lib.paged_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err = lib.paged_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LAUNCH.update(launch=fn, error=err)
    return _LAUNCH["launch"], _LAUNCH["error"]


def paged_splits(batch: int, h_kv: int, n_pt: int, sm_count: int) -> int:
    """Blocks the kernel splits each (KV head, lane) pair's live pages
    over: enough that ``h_kv * batch * S`` blocks fill the card's SMs
    twice, at most :data:`MAX_SPLITS` (one portable cluster) and at most
    the table's ``n_pt`` pages. Chosen from shapes alone: the kernel
    reads ``pos`` on the device and shares each lane's live pages out
    among the S blocks itself."""
    want = -(-2 * sm_count // (batch * h_kv))
    return max(1, min(MAX_SPLITS, n_pt, want))


def paged_stage_pages(page_size: int, head_dim: int, itemsize: int) -> int:
    """Whole pages the kernel holds in one shared-memory stage and takes
    in one online-softmax step: at most :data:`STAGE_KEYS` keys and
    :data:`STAGE_BYTES` of K and V, at least one page."""
    by_bytes = STAGE_BYTES // (2 * page_size * head_dim * itemsize)
    return max(1, min(by_bytes, STAGE_KEYS // page_size))


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def paged_gather_kv(pages: torch.Tensor,
                    page_table: torch.Tensor) -> torch.Tensor:
    """(num_pages, P, h_kv, D) pool + (B, n_pt) int table ->
    (B, n_pt * P, h_kv, D) per-lane logical-order KV:
    ``out[b, p] == pages[page_table[b, p // P], p % P]``."""
    n_pt = page_table.shape[1]
    g = pages[page_table.long()]  # (B, n_pt, P, h_kv, D)
    return g.reshape((g.shape[0], n_pt * pages.shape[1]) + g.shape[3:])


def paged_gather_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor,
                           window: "int | None" = None) -> torch.Tensor:
    """Decode attention through a page table, gather-and-mask form.

    q: (B, 1, H, D); k_pages/v_pages: (num_pages, P, h_kv, D);
    page_table: (B, n_pt) int; pos: (B,) int — row b attends its logical
    positions <= pos[b] (and > pos[b] - window with a window). Returns
    (B, 1, H, D) in q's dtype."""
    return decode_attention(q, paged_gather_kv(k_pages, page_table),
                            paged_gather_kv(v_pages, page_table), pos,
                            window)


def decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, pos: torch.Tensor,
                     window: "int | None" = None) -> torch.Tensor:
    """The masked-softmax decode formula over per-lane logical-order KV
    k_all/v_all (B, T, h_kv, D), row b masked by its own pos[b]: f32
    scores and softmax, ``NEG_INF`` mask, query head h reading KV head
    h // g. The slot engine's read path (``_slot_cached_attention``) and
    the paged gather path both run it."""
    b, one, h, d = q.shape
    h_kv = k_all.shape[2]
    g = h // h_kv
    qg = q.reshape(b, one, h_kv, g, d)
    scale = d ** -0.5
    k_idx = torch.arange(k_all.shape[1], device=q.device)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k_all.float()) * scale
    valid = k_idx[None, :] <= pos[:, None]
    if window is not None:
        valid &= k_idx[None, :] > pos[:, None] - window
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.reshape(b, one, h, d).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, pos) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must be one (num_pages, P, h_kv, D) shape, "
            f"got {tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    h_kv, d_kv = k_pages.shape[2], k_pages.shape[3]
    if d_kv != d or h % h_kv:
        raise ValueError(
            f"pool (.., h_kv={h_kv}, D={d_kv}) does not serve q with "
            f"H={h}, D={d} (h_kv must divide H, D must match)")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged_attention reads float32 or bfloat16 pools of q's "
            f"dtype; got q {q.dtype}, k {k_pages.dtype}, v {v_pages.dtype} "
            f"(an int8 pool decodes through the gather path)")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.dtype != torch.int32:
        raise ValueError(f"page_table must be ({b}, n_pt) int32, got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    if tuple(pos.shape) != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({b},) int32, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, page_table, pos)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Fused paged decode attention (one token per lane).

    Same contract as :func:`paged_gather_attention` (no window).
    ``page_table`` and ``pos`` are int32; every table entry a lane reads
    (its first ``ceil((pos+1)/P)``) must be a page id in
    ``[0, num_pages)``. On CPU tensors this is the plain version; on CUDA
    tensors it launches the kernel into a ``torch.empty`` output on the
    current stream and raises if the launch fails: one launch, clusters
    of :func:`paged_splits` blocks, with no read of ``pos`` on the host."""
    _check(q, k_pages, v_pages, page_table, pos)
    if q.device.type == "cpu":
        return paged_gather_attention(q, k_pages, v_pages, page_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got "
                         f"{q.device}")
    tensors = (q, k_pages, v_pages, page_table, pos)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous inputs")
    b, _, h, d = q.shape
    _num_pages, page_size, h_kv, _ = k_pages.shape
    if d % 32 or d > 256:
        raise ValueError(f"kernel needs head_dim a multiple of 32 and "
                         f"<= 256, got {d}")
    if h // h_kv > 32:
        raise ValueError(f"kernel holds a group's query heads in at most "
                         f"8 tiles of 4: H / h_kv <= 32, got {h // h_kv}")
    return _launch_kernel(q, k_pages, v_pages, page_table, pos,
                          paged_splits(b, h_kv, page_table.shape[1],
                                       _sm_count(q.device)))


def _launch_kernel(q, k_pages, v_pages, page_table, pos,
                   splits: int) -> torch.Tensor:
    """One launch of the kernel on inputs :func:`paged_attention` has
    checked, each (KV head, lane) pair's pages split over ``splits``
    blocks (1 to :data:`MAX_SPLITS`)."""
    global PAGED_ATTENTION_LAUNCHES
    b, _, h, d = q.shape
    _num_pages, page_size, h_kv, _ = k_pages.shape
    fn, err = _launcher()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                v_pages.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
                out.data_ptr(), b, h, h_kv, d, page_size,
                page_table.shape[1], splits,
                paged_stage_pages(page_size, d, q.element_size()),
                d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    PAGED_ATTENTION_LAUNCHES += 1
    return out
