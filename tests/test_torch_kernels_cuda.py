"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): it
carries the ``cuda`` marker and skips, inside a fixture, where
``torch.cuda.is_available()`` is false. The file imports no JAX, so it
runs on the GPU machine, from the repository root::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

paged attention: f32 at atol = rtol = 1e-5 (another summation order),
bf16 each head's row within min(2e-2, 1/32 of its largest value)
(``chip_smoke.paged_agrees``); flash attention: the JAX package's
tolerances, f32 at 2e-5 (forward) and 5e-5 (gradients), bf16 at 3e-2 (every flash and ring
kernel on tensor cores: bf16 directly, f32 in split TF32), at head dims
32, 64 and 128, the kernels also bitwise repeatable, rows that no live
pair reaches exactly zero (o, dq, dk/dv) and a ring carry that no live
key reaches bitwise unchanged;
the gradient sync's masked reduce and int8 quantizers: bitwise (both sum
the peers in order, and the quantizers' arithmetic is IEEE's, Philox
drawn alike); the
peer-memory ring and swing allreduce: bitwise, on two, three and four
rank processes that share the card through CUDA IPC (the same adds in the
same order), ragged swing blocks too, and a stalled call raises in
``ring.wait`` within its timeout and drains its stream; the rank
transport (``--dist-backend ipc``): every collective on ipc ranks bitwise
its gloo twin at n = 2, 3, 4 and on the lines of a (2, 2) mesh, a
payload of several 64 MiB chunks with unaligned blocks, and a rank that
skips a call makes its peer raise within the timeout;
TF32 is off for CUDA matmuls (``allow_tf32 = False``), so the plain
version's f32 products are full f32.
"""

import math
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.ops.kernels import attention
from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as mr
from akka_allreduce_tpu_torch.ops.kernels import quantized as qz

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def paged_inputs(h_kv: int, page_size: int, seed: int, heads: int = 8,
                 head_dim: int = 64, splits: int = 1):
    """Eight lanes with their own pages: positions 0, P-1, P, the last,
    a split boundary of the kernel's ``splits`` and one page past it,
    a random one, and a lane parked on scratch page 0 at pos 0."""
    rng = np.random.default_rng(seed)
    b, n_pt = 8, 128 // page_size
    num_pages = b * n_pt + 1
    last = n_pt * page_size - 1
    # live pages: a multiple of splits (or the table less one page)
    boundary = min(max(1, n_pt // (2 * splits)) * splits, n_pt - 1)
    q = rng.normal(size=(b, 1, heads, head_dim)).astype(np.float32)
    k = rng.normal(size=(num_pages, page_size, h_kv, head_dim))
    v = rng.normal(size=(num_pages, page_size, h_kv, head_dim))
    table = (rng.permutation(num_pages - 1) + 1).reshape(b, n_pt)
    table[-1] = 0
    pos = np.array([0, page_size - 1, page_size, last,
                    boundary * page_size - 1, boundary * page_size,
                    int(rng.integers(0, last + 1)), 0])
    return (torch.from_numpy(q), torch.from_numpy(k.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)),
            torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(pos.astype(np.int32)))


# (h_kv, page_size) at H 8, D 64 and 128 positions, then chip_smoke.py's
# serving slice shape (B 8, H 16, h_kv 4, D 128, P 16, n_pt 32) and its
# long cache (n_pt 512, lanes at 4,096-8,191), each with the edge and
# split-boundary positions and with its timed positions
PAGED_CASES = ([(h_kv, p, None) for h_kv in (1, 2, 8) for p in (8, 32)]
               + [(4, 16, "edges"), (4, 16, "serve"), (4, 16, "long-edges"),
                  (4, 16, "long")])


def _chip_smoke():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def assert_paged_agrees(got, want):
    """``chip_smoke.paged_agrees``: f32 at atol = rtol = 1e-5, bf16 each
    head's row within min(2e-2, 1/32 of its largest value)."""
    assert got.dtype == want.dtype
    ok, share = _chip_smoke().paged_agrees(torch, got, want)
    diff = float((got.float() - want.float()).abs().max())
    assert ok, f"worst error {share:.3g} x its limit (max |diff| {diff:.3g})"


def paged_case(case, seed, device, dtype):
    from akka_allreduce_tpu_torch.ops.kernels.attention import paged_splits
    h_kv, page_size, positions = case
    if positions is None:
        n_pt = 128 // page_size
        splits = paged_splits(8, h_kv, n_pt, torch.cuda.get_device_properties(
            device).multi_processor_count)
        tensors = [t.to(device) for t in paged_inputs(
            h_kv, page_size, seed, splits=splits)]
        return [t.to(dtype) if t.is_floating_point() else t
                for t in tensors]
    chip_smoke = _chip_smoke()
    shape = (chip_smoke.LONG_SHAPE if positions.startswith("long")
             else chip_smoke.KERNEL_SHAPES[0])
    return list(chip_smoke.make_case(torch, shape, dtype, seed,
                                     positions.replace("long-", ""),
                                     device=str(device)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_attention_matches_plain(cuda_device, case, dtype):
    q, k, v, table, pos = paged_case(case, case[0] * 100 + case[1],
                                     cuda_device, dtype)
    before = attention.PAGED_ATTENTION_LAUNCHES
    got = attention.paged_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert attention.PAGED_ATTENTION_LAUNCHES == before + 1
    want = attention.paged_gather_attention(q, k, v, table, pos)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert_paged_agrees(got, want)


# (H, h_kv, D): every head dim the kernel is built for (32 to 256) and
# groups of 1 to 32 query heads, odd tile counts (3, 5, 7 tiles of 4) too
PAGED_WIDTHS = [(8, 2, 32), (12, 1, 96), (20, 1, 160), (24, 2, 192),
                (28, 1, 224), (32, 1, 256), (16, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,h_kv,head_dim", PAGED_WIDTHS)
def test_paged_attention_head_dims_and_groups(cuda_device, heads, h_kv,
                                              head_dim, dtype):
    from akka_allreduce_tpu_torch.ops.kernels.attention import paged_splits
    splits = paged_splits(8, h_kv, 128 // 16, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    q, k, v, table, pos = [t.to(cuda_device) for t in paged_inputs(
        h_kv, 16, seed=heads + head_dim, heads=heads, head_dim=head_dim,
        splits=splits)]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = attention.paged_attention(q, k, v, table, pos)
    want = attention.paged_gather_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert_paged_agrees(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,head_dim", [(8, 48), (8, 288), (33, 64)])
def test_paged_attention_rejects_widths_it_is_not_built_for(
        cuda_device, heads, head_dim):
    """Head dims that are not a multiple of 32 or exceed 256, and groups
    of more than 32 query heads (8 tiles of 4), raise before a launch."""
    q, k, v, table, pos = [t.to(cuda_device) for t in paged_inputs(
        1, 16, seed=0, heads=heads, head_dim=head_dim)]
    before = attention.PAGED_ATTENTION_LAUNCHES
    with pytest.raises(ValueError, match="kernel"):
        attention.paged_attention(q, k, v, table, pos)
    assert attention.PAGED_ATTENTION_LAUNCHES == before


@pytest.mark.cuda
def test_paged_attention_rejects_non_contiguous(cuda_device):
    q, k, v, table, pos = [t.to(cuda_device) for t in paged_inputs(2, 8, 0)]
    with pytest.raises(ValueError, match="contiguous"):
        attention.paged_attention(q, k.transpose(0, 1).contiguous()
                                  .transpose(0, 1), v, table, pos)


# -- flash attention (forward, dq, dk/dv) ---------------------------------

# (h_kv, head_dim, causal, window, tq, tk, q_off, k_off) over H = 8 heads:
# MHA, GQA and MQA, D 32, 64 and 128, non-causal, a window, a ragged
# length (not a multiple of the 64-row tile) and Tq != Tk with offsets
FLASH_CASES = [(8, 64, True, None, 256, 256, 0, 0),
               (2, 128, True, None, 256, 256, 0, 0),
               (1, 64, True, None, 192, 192, 0, 0),
               (2, 64, False, None, 128, 128, 0, 0),
               (2, 64, True, 48, 256, 256, 0, 0),
               (2, 128, True, None, 100, 100, 0, 0),
               (2, 64, True, 80, 128, 256, 128, 0),
               (4, 32, True, None, 256, 256, 0, 0),
               (1, 32, True, 48, 200, 200, 0, 0),
               (2, 32, True, 80, 128, 256, 128, 0),
               (4, 32, True, None, 32, 32, 0, 0)]
FLASH_TOL = {torch.float32: (2e-5, 5e-5), torch.bfloat16: (3e-2, 3e-2)}


def flash_inputs(h_kv, d, tq, tk, seed, device, dtype):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((2, tq, 8, d), generator=gen)
    k = torch.randn((2, tk, h_kv, d), generator=gen)
    v = torch.randn((2, tk, h_kv, d), generator=gen)
    do = torch.randn((2, tq, 8, d), generator=gen)
    return [t.to(device, dtype) for t in (q, k, v, do)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, case, dtype):
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    h_kv, d, causal, window, tq, tk, q_off, k_off = case
    q, k, v, do = flash_inputs(h_kv, d, tq, tk, seed=tq + h_kv + d,
                               device=cuda_device, dtype=dtype)
    opts = (causal, window, q_off, k_off)
    counts = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
              fa.FLASH_DKV_LAUNCHES)
    o, lse = fa.flash_forward(q, k, v, *opts)
    want_o, want_lse = fa.flash_forward_reference(q, k, v, *opts)
    delta = fa.attention_delta(want_o, do)
    dq = fa.flash_dq(q, k, v, do, want_lse, delta, *opts)
    dk, dv = fa.flash_dkv(q, k, v, do, want_lse, delta, *opts)
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
            fa.FLASH_DKV_LAUNCHES) == tuple(c + 1 for c in counts)
    want = fa.flash_backward_reference(q, k, v, want_o, want_lse, do, *opts)
    tol_fwd, tol_bwd = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol_fwd,
                               rtol=tol_fwd)
    torch.testing.assert_close(lse, want_lse, atol=tol_fwd, rtol=tol_fwd)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), w.float(), atol=tol_bwd,
                                   rtol=tol_bwd)


# the dq and dk/dv kernels (tensor-core tiles, flash_mma.cuh and
# flash_tf32.cuh): (h_kv, head_dim, causal, window, tq, tk, q_off, k_off,
# q_layout) over H = 16 heads: GQA (4 KV heads) at D 128, 64 and 32, MQA,
# a window, a ragged T of 1000, Tq != Tk with offsets, non-causal, and a q
# read through the strides of a (B, H, T, D) tensor's transpose (not
# contiguous)
BF16_BWD_CASES = [(4, 128, True, None, 256, 256, 0, 0, "contiguous"),
                  (4, 64, True, None, 256, 256, 0, 0, "contiguous"),
                  (1, 128, True, None, 192, 192, 0, 0, "contiguous"),
                  (4, 64, True, 100, 512, 512, 0, 0, "contiguous"),
                  (4, 128, True, None, 1000, 1000, 0, 0, "contiguous"),
                  (4, 64, True, 384, 512, 1024, 512, 0, "contiguous"),
                  (4, 128, False, None, 192, 160, 0, 0, "contiguous"),
                  (4, 128, True, None, 256, 256, 0, 0, "bhtd"),
                  (1, 64, True, 100, 1000, 1000, 0, 0, "bhtd"),
                  (4, 32, True, None, 256, 256, 0, 0, "contiguous"),
                  (4, 32, True, 100, 1000, 1000, 0, 0, "bhtd")]


def bf16_bwd_inputs(case, device, dtype=torch.bfloat16):
    """q, k, v, do in ``dtype`` on ``device`` and the plain forward's lse
    and delta (the saved state the backward kernels read)."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    h_kv, d, causal, window, tq, tk, q_off, k_off, layout = case
    rng = np.random.default_rng(tq * 7 + tk + d + h_kv)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(device, dtype)
                   for s in ((2, tq, 16, d), (2, tk, h_kv, d),
                             (2, tk, h_kv, d), (2, tq, 16, d)))
    if layout == "bhtd":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        assert not q.is_contiguous()
    opts = (causal, window, q_off, k_off)
    o, lse = fa.flash_forward_reference(q, k, v, *opts)
    return (q, k, v, do, lse, fa.attention_delta(o, do)), o, opts


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_BWD_CASES)
def test_bf16_backward_kernels_match_plain(cuda_device, case):
    """At the bf16 tolerance (3e-2): the tiles keep the JAX kernels' cast
    points, so only the order of the f32 sums differs."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    args, o, opts = bf16_bwd_inputs(case, cuda_device)
    counts = (fa.FLASH_DQ_LAUNCHES, fa.FLASH_DKV_LAUNCHES)
    dq = fa.flash_dq(*args, *opts)
    dk, dv = fa.flash_dkv(*args, *opts)
    torch.cuda.synchronize()
    assert (fa.FLASH_DQ_LAUNCHES, fa.FLASH_DKV_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    q, k, v, do, lse, _ = args
    want = fa.flash_backward_reference(q, k, v, o, lse, do, *opts)
    tol = FLASH_TOL[torch.bfloat16][1]
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), w.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_BWD_CASES)
def test_f32_backward_kernels_match_plain(cuda_device, case):
    """The f32 dq and dk/dv on tensor cores in split TF32
    (flash_dq_tf32_mma_kernel, flash_dkv_tf32_mma_kernel) over the bf16
    kernels' cases, at the f32 gradient tolerance (5e-5): three TF32
    products keep ~20 bits of each product, one would miss it."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    args, o, opts = bf16_bwd_inputs(case, cuda_device, torch.float32)
    counts = (fa.FLASH_DQ_LAUNCHES, fa.FLASH_DKV_LAUNCHES)
    dq = fa.flash_dq(*args, *opts)
    dk, dv = fa.flash_dkv(*args, *opts)
    torch.cuda.synchronize()
    assert (fa.FLASH_DQ_LAUNCHES, fa.FLASH_DKV_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    q, k, v, do, lse, _ = args
    want = fa.flash_backward_reference(q, k, v, o, lse, do, *opts)
    tol = FLASH_TOL[torch.float32][1]
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, w, atol=tol, rtol=tol)


# (h_kv, head_dim, tq, tk, window, q_off, k_off): rows that no live pair
# reaches, inside live tiles (k_off 32: queries 0-31, keys 96-127) and as
# whole tiles whose live band is empty (k_off 64: query tile 0, key tile
# 1; a window: key tile 0 of the offsets case)
DEAD_ROW_CASES = [(4, 128, 128, 128, None, 0, 32),
                  (4, 64, 128, 128, None, 0, 64),
                  (4, 128, 128, 256, 48, 128, 0),
                  (1, 64, 192, 192, 40, 0, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEAD_ROW_CASES)
def test_flash_backward_rows_without_live_pairs_are_zero(cuda_device, case,
                                                         dtype):
    """dq rows with no live key and dk, dv rows with no live query come
    back exactly 0 (p = 0 exactly on a masked lane; a block whose live
    band is empty still stores its zeros into the ``torch.empty``
    outputs); the other rows match the plain version. lse and delta are
    finite everywhere: they come from the unmasked forward."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    h_kv, d, tq, tk, window, q_off, k_off = case
    gen = torch.Generator().manual_seed(tq + tk + k_off)
    q, k, v, do = (torch.randn(s, generator=gen).to(cuda_device, dtype)
                   for s in ((2, tq, 16, d), (2, tk, h_kv, d),
                             (2, tk, h_kv, d), (2, tq, 16, d)))
    o, lse = fa.flash_forward_reference(q, k, v, causal=False)
    saved = (do, lse, fa.attention_delta(o, do))
    opts = (True, window, q_off, k_off)
    dq = fa.flash_dq(q, k, v, *saved, *opts)
    dk, dv = fa.flash_dkv(q, k, v, *saved, *opts)
    torch.cuda.synchronize()
    want = fa._backward_reference(q, k, v, *saved, *opts)
    mask = fa.score_mask(tq, tk, True, window, q_off, k_off, cuda_device)
    live_q, live_k = mask.any(dim=1), mask.any(dim=0)
    assert not live_q.all() or not live_k.all()
    tol = FLASH_TOL[dtype][1]
    for got, w, live in ((dq, want[0], live_q), (dk, want[1], live_k),
                         (dv, want[2], live_k)):
        assert torch.equal(got[:, ~live], torch.zeros_like(got[:, ~live]))
        torch.testing.assert_close(got[:, live].float(),
                                   w[:, live].float(), atol=tol, rtol=tol)


# the forwards (flash_fwd_mma_kernel, flash_fwd_tf32_mma_kernel): the
# backward's cases and a 256 window over 1024 positions
BF16_FWD_CASES = BF16_BWD_CASES + [
    (4, 128, True, 256, 1024, 1024, 0, 0, "contiguous")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BF16_FWD_CASES)
def test_bf16_forward_kernel_matches_plain(cuda_device, case, dtype):
    """o and lse at the forward tolerance, bf16 3e-2 (p rounds to bf16
    against the running max where the plain version rounds it against the
    row's final max, and the f32 sums run in another order) and f32 2e-5
    (split TF32: three TF32 products keep ~20 bits of each product, one
    would miss it)."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    (q, k, v, *_), want_o, opts = bf16_bwd_inputs(case, cuda_device, dtype)
    count = fa.FLASH_FWD_LAUNCHES
    o, lse = fa.flash_forward(q, k, v, *opts)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD_LAUNCHES == count + 1
    _, want_lse = fa.flash_forward_reference(q, k, v, *opts)
    tol = FLASH_TOL[dtype][0]
    assert o.dtype == dtype and o.shape == q.shape
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEAD_ROW_CASES)
def test_flash_forward_rows_without_live_keys_are_zero(cuda_device, case,
                                                       dtype):
    """Query rows with no live key (inside live tiles, and whole tiles
    whose live band is empty) come back with o exactly 0 (l = 0, so o =
    acc / 1) and lse -inf, as the plain version gives them; the other
    rows match it."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    h_kv, d, tq, tk, window, q_off, k_off = case
    gen = torch.Generator().manual_seed(tq + tk + k_off + 1)
    q, k, v = (torch.randn(s, generator=gen).to(cuda_device, dtype)
               for s in ((2, tq, 16, d), (2, tk, h_kv, d), (2, tk, h_kv, d)))
    opts = (True, window, q_off, k_off)
    o, lse = fa.flash_forward(q, k, v, *opts)
    want_o, want_lse = fa.flash_forward_reference(q, k, v, *opts)
    torch.cuda.synchronize()
    live = fa.score_mask(tq, tk, True, window, q_off, k_off,
                         cuda_device).any(dim=1)
    assert torch.equal(o[:, ~live], torch.zeros_like(o[:, ~live]))
    assert torch.equal(want_o[:, ~live], o[:, ~live])
    assert bool((lse[:, :, ~live] == float("-inf")).all())
    tol = FLASH_TOL[dtype][0]
    torch.testing.assert_close(o[:, live].float(), want_o[:, live].float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse[:, :, live], want_lse[:, :, live],
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_bf16_backward_kernels_are_deterministic(cuda_device):
    """No atomics: dk and dv sum the GQA group in one block's registers,
    so two launches give the same bits; the ring's dq and dk/dv too, on
    a past hop into the same accumulators."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    args, _, opts = bf16_bwd_inputs(BF16_BWD_CASES[0], cuda_device)
    first = (fa.flash_dq(*args, *opts), *fa.flash_dkv(*args, *opts))
    second = (fa.flash_dq(*args, *opts), *fa.flash_dkv(*args, *opts))
    q, k, v, hop = bf16_ring_inputs(BF16_RING_CASES[1], cuda_device)
    saved = ring_saved_state(q, k, v, hop, seed=1)
    _, (dq0, dk0, dv0) = ring_state(q, k, seed=1)
    ring = [(rf.ring_dq(q, k, v, *saved, dq0.clone(), *hop),
             *rf.ring_dkv(q, k, v, *saved, dk0.clone(), dv0.clone(), *hop))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first + ring[0], second + ring[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_f32_backward_kernels_are_deterministic(cuda_device):
    """The split-TF32 dq and dk/dv, flash and ring: the GQA group and the
    warp pairs' halves are summed in a fixed order (no atomics), so two
    launches give the same bits."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    args, _, opts = bf16_bwd_inputs(BF16_BWD_CASES[0], cuda_device,
                                    torch.float32)
    first = (fa.flash_dq(*args, *opts), *fa.flash_dkv(*args, *opts))
    second = (fa.flash_dq(*args, *opts), *fa.flash_dkv(*args, *opts))
    q, k, v, hop = bf16_ring_inputs(BF16_RING_CASES[1], cuda_device,
                                    torch.float32)
    saved = ring_saved_state(q, k, v, hop, seed=1)
    _, (dq0, dk0, dv0) = ring_state(q, k, seed=1)
    ring = [(rf.ring_dq(q, k, v, *saved, dq0.clone(), *hop),
             *rf.ring_dkv(q, k, v, *saved, dk0.clone(), dv0.clone(), *hop))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first + ring[0], second + ring[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_autograd_function_launches_each_kernel_once(cuda_device):
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, do = flash_inputs(2, 64, 128, 128, 0, cuda_device,
                               torch.float32)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    counts = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
              fa.FLASH_DKV_LAUNCHES)
    out = fa.flash_causal_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
            fa.FLASH_DKV_LAUNCHES) == tuple(c + 1 for c in counts)
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_forward_reference(*ref)[0], ref, do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)


# -- ring flash attention (one hop: forward, dq, dk/dv) --------------------

# (h_kv, head_dim, causal, t, q_off, k_off) over H = 8 heads: the diagonal
# hop, a past hop, MQA, non-causal, and a ragged block (not a multiple of
# the 64-row tile) at D 128; a past and a ragged diagonal hop at D 32
RING_CASES = [(2, 64, True, 128, 128, 128),
              (2, 64, True, 128, 256, 0),
              (1, 128, True, 192, 192, 192),
              (8, 64, False, 128, 128, 256),
              (2, 128, True, 100, 200, 100),
              (2, 32, True, 128, 256, 0),
              (4, 32, True, 100, 100, 100),
              (4, 32, True, 32, 32, 32),
              (4, 32, True, 32, 32, 0)]


def ring_state(q, k, seed):
    """A carry that already holds one hop (the block scored against
    itself) and nonzero f32 gradient accumulators."""
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    b, t, h, d = q.shape
    m = torch.full((b, h, t), -1e30, device=q.device)
    carry = rf.ring_fwd_reference(q, k, k, m, torch.zeros_like(m),
                                  torch.zeros((b, t, h, d),
                                              device=q.device), 0, 0)
    gen = torch.Generator().manual_seed(seed)
    grads = [torch.randn(s, generator=gen).to(q.device)
             for s in (q.shape, k.shape, k.shape)]
    return [x.contiguous() for x in carry], grads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_kernels_match_plain(cuda_device, case, dtype):
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    h_kv, d, causal, t, q_off, k_off = case
    q, k, v, do = flash_inputs(h_kv, d, t, t, seed=t + h_kv + d,
                               device=cuda_device, dtype=dtype)
    carry, (dq0, dk0, dv0) = ring_state(q, k, seed=t)
    counts = rf.counts()
    got = rf.ring_fwd(q, k, v, *[x.clone() for x in carry], q_off, k_off,
                      causal)
    want = rf.ring_fwd_reference(q, k, v, *carry, q_off, k_off, causal)
    o, lse = fa.flash_forward_reference(q, k, v, causal, None, q_off, k_off)
    delta = fa.attention_delta(o, do)
    dq = rf.ring_dq(q, k, v, do, lse, delta, dq0.clone(), q_off, k_off,
                    causal)
    dk, dv = rf.ring_dkv(q, k, v, do, lse, delta, dk0.clone(), dv0.clone(),
                         q_off, k_off, causal)
    torch.cuda.synchronize()
    assert rf.counts() == {n: c + 1 for n, c in counts.items()}
    parts = rf.ring_bwd_reference(q, k, v, do, lse, delta, q_off, k_off,
                                  causal)
    tol_fwd, tol_bwd = FLASH_TOL[dtype]
    # m, l, and the unnormalised acc as the output it stands for, acc / l
    for g, w in ((got[0], want[0]), (got[1], want[1]),
                 (got[2] / got[1].transpose(1, 2)[..., None],
                  want[2] / want[1].transpose(1, 2)[..., None])):
        torch.testing.assert_close(g, w, atol=tol_fwd, rtol=tol_fwd)
    for g, acc0, part in zip((dq, dk, dv), (dq0, dk0, dv0), parts):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        torch.testing.assert_close(g, acc0 + part, atol=tol_bwd,
                                   rtol=tol_bwd)


# the ring kernels (ring_{fwd,dq,dkv}_mma_kernel in bf16,
# ring_{fwd,dq,dkv}_tf32_mma_kernel in f32) over H = 16 heads, on a carry
# and accumulators that already hold a hop: (h_kv, head_dim, causal, t,
# q_off, k_off, q_layout): the sequence-parallel slice's diagonal and past
# hops at a smaller T, D 64 and 32, a ragged diagonal block (MQA),
# non-causal and a strided q
BF16_RING_CASES = [(4, 128, True, 256, 256, 256, "contiguous"),
                   (4, 128, True, 256, 256, 0, "contiguous"),
                   (4, 64, True, 192, 384, 192, "contiguous"),
                   (1, 128, True, 100, 100, 100, "contiguous"),
                   (4, 128, False, 128, 0, 128, "contiguous"),
                   (4, 128, True, 256, 512, 256, "bhtd"),
                   (4, 32, True, 192, 384, 192, "contiguous")]


def bf16_ring_inputs(case, device, dtype=torch.bfloat16):
    h_kv, d, causal, t, q_off, k_off, layout = case
    rng = np.random.default_rng(t * 3 + q_off + k_off + d + h_kv)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(device, dtype)
               for s in ((2, t, 16, d), (2, t, h_kv, d), (2, t, h_kv, d)))
    if layout == "bhtd":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        assert not q.is_contiguous()
    return q, k, v, (q_off, k_off, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BF16_RING_CASES)
def test_bf16_ring_forward_matches_plain(cuda_device, case, dtype):
    """The carry (m, l, and acc as the output it stands for, acc / l) at
    the forward tolerance of the dtype (bf16 3e-2, f32 2e-5)."""
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    q, k, v, hop = bf16_ring_inputs(case, cuda_device, dtype)
    carry, _ = ring_state(q, k, seed=case[3])
    count = rf.RING_FWD_LAUNCHES
    got = rf.ring_fwd(q, k, v, *[x.clone() for x in carry], *hop)
    torch.cuda.synchronize()
    assert rf.RING_FWD_LAUNCHES == count + 1
    want = rf.ring_fwd_reference(q, k, v, *carry, *hop)
    tol = FLASH_TOL[dtype][0]
    for g, w in ((got[0], want[0]), (got[1], want[1]),
                 (got[2] / got[1].transpose(1, 2)[..., None],
                  want[2] / want[1].transpose(1, 2)[..., None])):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_forward_keeps_rows_without_live_keys_empty(cuda_device, dtype):
    """A block that starts 32 positions after the queries (k_off = 32):
    rows 0-31 have no live key in it, all their keys lie elsewhere, so
    from the empty carry (m = NEG_INF, l = 0, acc = 0) they come back
    exactly empty: the where-guard keeps p = 0 and corr = 1. The other
    rows match the plain version."""
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    q, k, v, _ = flash_inputs(2, 128, 128, 128, 7, cuda_device, dtype)
    b, t, h, d = q.shape
    empty = (torch.full((b, h, t), -1e30, device=cuda_device),
             torch.zeros((b, h, t), device=cuda_device),
             torch.zeros((b, t, h, d), device=cuda_device))
    got = rf.ring_fwd(q, k, v, *[x.clone() for x in empty], 0, 32)
    want = rf.ring_fwd_reference(q, k, v, *empty, 0, 32)
    torch.cuda.synchronize()
    assert bool((got[0][:, :, :32] == -1e30).all())
    assert not got[1][:, :, :32].any() and not got[2][:, :32].any()
    tol = FLASH_TOL[dtype][0]
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g[:, :, 32:], w[:, :, 32:], atol=tol,
                                   rtol=tol)
    torch.testing.assert_close(
        got[2][:, 32:] / got[1][:, :, 32:].transpose(1, 2)[..., None],
        want[2][:, 32:] / want[1][:, :, 32:].transpose(1, 2)[..., None],
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 128])
def test_ring_forward_leaves_rows_without_live_keys_unchanged(cuda_device,
                                                              d, dtype):
    """On a carry that already holds a hop, a block that starts 32
    positions after the queries (k_off = 32): rows 0-31 have no live key
    in it, so their m, l and acc come back bitwise as they came (corr =
    1, p = 0). The other rows match the plain version."""
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    q, k, v, _ = flash_inputs(2, d, 128, 128, 8, cuda_device, dtype)
    carry, _ = ring_state(q, k, seed=8)
    got = rf.ring_fwd(q, k, v, *[x.clone() for x in carry], 0, 32)
    want = rf.ring_fwd_reference(q, k, v, *carry, 0, 32)
    torch.cuda.synchronize()
    for g, c in zip(got[:2], carry[:2]):
        assert torch.equal(g[:, :, :32], c[:, :, :32])
    assert torch.equal(got[2][:, :32], carry[2][:, :32])
    tol = FLASH_TOL[dtype][0]
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g[:, :, 32:], w[:, :, 32:], atol=tol,
                                   rtol=tol)
    torch.testing.assert_close(
        got[2][:, 32:] / got[1][:, :, 32:].transpose(1, 2)[..., None],
        want[2][:, 32:] / want[1][:, :, 32:].transpose(1, 2)[..., None],
        atol=tol, rtol=tol)


def ring_saved_state(q, k, v, hop, seed):
    """dO, and the lse and delta of the hop's block alone (each row of
    the bf16 ring cases has a live key in it, so both are finite)."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    q_off, k_off, causal = hop
    rng = np.random.default_rng(seed)
    do = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(
        q.device, q.dtype)
    o, lse = fa.flash_forward_reference(q, k, v, causal, None, q_off, k_off)
    return do, lse, fa.attention_delta(o, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BF16_RING_CASES)
def test_bf16_ring_backward_matches_plain(cuda_device, case, dtype):
    """The tensor-core dq and dk/dv (bf16: ring_dq_mma_kernel,
    ring_dkv_mma_kernel; f32: ring_dq_tf32_mma_kernel,
    ring_dkv_tf32_mma_kernel, in split TF32) add the hop's f32 partials
    into nonzero f32 accumulators: held against acc0 + the plain partials
    at the dtype's gradient tolerance (bf16 3e-2, f32 5e-5), with one
    launch each."""
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    q, k, v, hop = bf16_ring_inputs(case, cuda_device, dtype)
    saved = ring_saved_state(q, k, v, hop, seed=case[3])
    _, acc0 = ring_state(q, k, seed=case[3])
    counts = (rf.RING_DQ_LAUNCHES, rf.RING_DKV_LAUNCHES)
    dq = rf.ring_dq(q, k, v, *saved, acc0[0].clone(), *hop)
    dk, dv = rf.ring_dkv(q, k, v, *saved, acc0[1].clone(), acc0[2].clone(),
                         *hop)
    torch.cuda.synchronize()
    assert (rf.RING_DQ_LAUNCHES, rf.RING_DKV_LAUNCHES) == (counts[0] + 1,
                                                           counts[1] + 1)
    parts = rf.ring_bwd_reference(q, k, v, *saved, *hop)
    tol = FLASH_TOL[dtype][1]
    for got, a0, part in zip((dq, dk, dv), acc0, parts):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, a0 + part, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_backward_leaves_rows_without_live_keys_unchanged(cuda_device,
                                                               dtype):
    """The backward twin of the forward test above: with k_off = 32, query
    rows 0-31 have no live key in the block and keys 96-127 (positions
    128-159) no live query, so their dq and dk/dv rows come back bitwise
    equal to the accumulators they came in (p = 0 exactly on a masked
    lane). lse and delta are finite, as in the ring, where every row has
    a live key on its own diagonal hop: they come from that hop here. The
    other rows match acc0 + the plain partials."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    q, k, v, do = flash_inputs(2, 128, 128, 128, 7, cuda_device, dtype)
    o, lse = fa.flash_forward_reference(q, k, v)
    saved = (do, lse, fa.attention_delta(o, do))
    _, acc0 = ring_state(q, k, seed=7)
    dq = rf.ring_dq(q, k, v, *saved, acc0[0].clone(), 0, 32)
    dk, dv = rf.ring_dkv(q, k, v, *saved, acc0[1].clone(), acc0[2].clone(),
                         0, 32)
    torch.cuda.synchronize()
    parts = rf.ring_bwd_reference(q, k, v, *saved, 0, 32)
    tol = FLASH_TOL[dtype][1]
    queries = (slice(0, 32), slice(32, None))  # (dead, live) rows
    keys = (slice(96, None), slice(0, 96))
    for got, a0, part, (dead, live) in ((dq, acc0[0], parts[0], queries),
                                        (dk, acc0[1], parts[1], keys),
                                        (dv, acc0[2], parts[2], keys)):
        assert torch.equal(got[:, dead], a0[:, dead])
        torch.testing.assert_close(got[:, live], (a0 + part)[:, live],
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bf16_forward_kernels_are_deterministic(cuda_device, dtype):
    """No atomics: two launches of each tensor-core forward give the same
    bits (f32: the warp pairs' states are merged in a fixed order)."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    (q, k, v, *_), _, opts = bf16_bwd_inputs(BF16_BWD_CASES[0], cuda_device,
                                             dtype)
    first, second = fa.flash_forward(q, k, v, *opts), \
        fa.flash_forward(q, k, v, *opts)
    q, k, v, hop = bf16_ring_inputs(BF16_RING_CASES[0], cuda_device, dtype)
    carry, _ = ring_state(q, k, seed=0)
    ring = [rf.ring_fwd(q, k, v, *[x.clone() for x in carry], *hop)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first + ring[0], second + ring[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ring_autograd_function_launches_each_kernel_once(cuda_device):
    """A ring of one rank: one hop, so each kernel launches once, and the
    result is the flash attention's."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    q, k, v, do = flash_inputs(2, 64, 128, 128, 0, cuda_device,
                               torch.float32)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    counts = rf.counts()
    out = rf.ring_flash_attention(*leaves, RankGroup.single(cuda_device))
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert rf.counts() == {n: c + 1 for n, c in counts.items()}
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want_o = fa.flash_forward_reference(*ref)[0]
    torch.testing.assert_close(out, want_o, atol=2e-5, rtol=2e-5)
    want = torch.autograd.grad(want_o, ref, do)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
def test_flash_rejects_unsupported_head_dim(cuda_device):
    """A head dim outside HEAD_DIMS (32, 64, 128) raises on a CUDA tensor:
    no plain fallback."""
    from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
    q, k, v, _ = flash_inputs(2, 48, 64, 64, 0, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_forward(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("peers,elems,valid,target", [
    (8, 65536, (1, 1, 1, 0, 1, 1, 1, 1), 8.0), (3, 1001, (1, 0, 1), 2.0),
    (2, 128, (0, 0), 1.0)])
def test_masked_reduce_matches_plain(cuda_device, peers, elems, valid,
                                     target):
    gen = torch.Generator().manual_seed(elems)
    staged = torch.randn((peers, elems), generator=gen).to(cuda_device)
    v = torch.tensor(valid, device=cuda_device)
    before = mr.MASKED_REDUCE_LAUNCHES
    out, count = mr.masked_reduce(staged, v, target)
    ref, ref_count = mr.masked_reduce_reference(staged, v, target)
    torch.cuda.synchronize()
    assert mr.MASKED_REDUCE_LAUNCHES == before + 1
    assert int(count) == int(ref_count) == sum(valid)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("peers,width,start,chunk", [
    (4, 195, 0, 3), (4, 195, 3, 3), (4, 196, 4, 4), (4, 196, 5, 3),
    (2, 270565376, 270565376 - 65536, 65536), (3, 1000, 996, 4)])
def test_masked_reduce_strided_slabs(cuda_device, peers, width, start,
                                     chunk):
    """The protocol plane's chunk reduce: a ``(peers, chunk)`` slab of a
    staging row ``width`` wide, read in place with ``ld = width``: the
    float4 path where ld, the chunk and both pointers allow it, the
    scalar path otherwise (a row of 195, a chunk at offset 3 or 5);
    bitwise its plain version, one launch each."""
    gen = torch.Generator(cuda_device).manual_seed(width + start)
    row = torch.randn((peers, width), generator=gen, device=cuda_device)
    slab = row[:, start:start + chunk]
    ones = torch.ones(peers, device=cuda_device)
    before = mr.MASKED_REDUCE_LAUNCHES
    out, count = mr.masked_reduce(slab, ones, float(peers))
    ref, _ = mr.masked_reduce_reference(slab, ones, float(peers))
    torch.cuda.synchronize()
    assert mr.MASKED_REDUCE_LAUNCHES == before + 1
    assert int(count) == peers
    assert torch.equal(out, ref)
    assert torch.equal(out, mr.masked_reduce(slab.contiguous(), ones,
                                             float(peers))[0])
    with pytest.raises(ValueError, match="row contiguous"):
        mr.masked_reduce(row.t()[:chunk].t().contiguous().t(),
                         torch.ones(chunk, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,block,offset", [
    (16, 4096, 512, 0), (5, 1000, 128, 0), (3, 1001, 128, 0),
    (4, 1024, 256, 1)])  # offset 1: a base that is not 16-byte aligned
def test_quantize_kernels_bitwise_plain(cuda_device, rows, cols, block,
                                        offset):
    gen = torch.Generator().manual_seed(rows * cols + offset)
    base = torch.randn(rows * cols + offset, generator=gen)
    x = base[offset:].view(rows, cols).to(cuda_device) if not offset else \
        base.to(cuda_device)[offset:].view(rows, cols)
    bits = torch.randint(-2 ** 31, 2 ** 31, (rows, cols), dtype=torch.int32,
                         generator=gen).to(cuda_device)
    rs, bs = qz.row_scales(x), qz.block_scales(x, block)
    runs = [
        (qz.quantize_int8(x, bits), qz.quantize_reference(x, rs, cols,
                                                          "bits", bits), rs),
        (qz.quantize_int8_prng(x, 99), qz.quantize_reference(
            x, rs, cols, "philox", seed=99), rs),
        (qz.quantize_int8_block(x, bits, block), qz.quantize_reference(
            x, bs, block, "bits", bits), bs),
        (qz.quantize_int8_block_rtn(x, block), qz.quantize_reference(
            x, bs, block, "rtn"), bs)]
    for (v, s), ref, want_s in runs:
        assert torch.equal(v, ref) and torch.equal(s, want_s)
    v, s = runs[0][0]
    assert torch.equal(qz.dequantize_int8(v, s),
                       qz.dequantize_reference(v, s, cols))
    v, s = runs[2][0]
    assert torch.equal(qz.dequantize_int8_block(v, s, block),
                       qz.dequantize_reference(v, s, block))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [99, 2 ** 63 + 5, 2 ** 64 - 1])
def test_quantize_prng_reads_its_seed_from_device_memory(cuda_device, seed):
    """Row 4 given its seed as a one-element int64 tensor on the card (a
    captured chunk's seed table) draws the by-value seed's words; in a
    CUDA graph, each replay draws the words of the seed written there
    before it."""
    x = torch.randn(5, 1000, device=cuda_device)
    want = qz.quantize_int8_prng(x, seed)
    got = qz.quantize_int8_prng(x, qz.seed_tensor(seed, cuda_device))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    table = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = qz.quantize_int8_prng(x, table)[0]
    for s in (seed, seed ^ 1):
        table.copy_(qz.seed_tensor(s, "cpu"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, qz.quantize_int8_prng(x, s)[0])


@pytest.mark.cuda
def test_quantize_counters_count_launches_only(cuda_device):
    before = qz.launch_counts()
    x = torch.randn(4, 256, device=cuda_device)
    v, s = qz.quantize_int8_block_rtn(x, 128)
    qz.dequantize_int8_block(v.view(2, 2, 256), s.view(2, 2, 2), 128)
    qz.quantize_int8_block_rtn(x.cpu(), 128)  # the plain version
    after = qz.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "quantize_int8": 0, "dequantize_int8": 0, "quantize_int8_prng": 0,
        "quantize_int8_block": 0, "quantize_int8_block_rtn": 1,
        "dequantize_int8_block": 1}


# -- the peer-memory ring and swing allreduce (two gloo ranks on the card) --

@pytest.mark.cuda
@pytest.mark.parametrize("elems", [768, 2 ** 20 + 256])
@pytest.mark.parametrize("schedule", ["ring", "swing"])
def test_peer_allreduce_matches_plain_bitwise(cuda_device, schedule, elems):
    """Two rank processes, a loop of 8 calls whose next input is
    ``carry + sum / 2``: every call's sum bitwise its plain version's
    (the same lone f32 adds), the same bits on both ranks, and one launch
    per call."""
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_ring_ranks import kernel_vs_plain
    ranks = spawn_ranks(kernel_vs_plain, 2, "gloo", "cuda", schedule, elems,
                        8)
    for r in ranks:
        assert r["bitwise"] == [True] * 8
        assert r["launches"][f"{schedule}_allreduce"] == 8
    assert ranks[0]["checksum"] == ranks[1]["checksum"]


# (schedule, ranks, elems): three and four ranks, then swing vectors
# whose last blocks are ragged or empty (3 lanes at two ranks; 5 and 2
# lanes at four)
MORE_RANKS = [("ring", 3, 3 * 384), ("ring", 3, 3 * 128 * 2731),
              ("ring", 4, 4 * 256), ("ring", 4, 2 ** 20),
              ("swing", 4, 768), ("swing", 4, 2 ** 20 + 256),
              ("swing", 2, 3 * 128), ("swing", 4, 5 * 128),
              ("swing", 4, 2 * 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,ranks,elems", MORE_RANKS,
                         ids=[f"{s}-n{n}-{e}" for s, n, e in MORE_RANKS])
def test_peer_allreduce_matches_plain_bitwise_at_more_ranks(
        cuda_device, schedule, ranks, elems):
    """As above at three and four rank processes and on ragged swing
    blocks: a loop of 4 calls, each bitwise its plain version's and the
    same on every rank, one launch a call."""
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_ring_ranks import kernel_vs_plain
    got = spawn_ranks(kernel_vs_plain, ranks, "gloo", "cuda", schedule,
                      elems, 4, timeout=300)
    for r in got:
        assert r["bitwise"] == [True] * 4
        assert r["launches"][f"{schedule}_allreduce"] == 4
    assert len({r["checksum"] for r in got}) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("peer", ["stops", "late"])
def test_peer_allreduce_stall_raises_within_timeout(cuda_device, peer):
    """Rank 1 skips call 2: rank 0's ``ring.wait(timeout=2)`` raises
    ``RuntimeError`` naming the push counter it waits on, within about
    its timeout, and abandons the call, so its stream drains (a device
    synchronise returns at once) and a further call on the buffer
    raises. Then rank 1 either stops (returns and its process ends
    without the call) or makes the call late, and its own wait raises on
    the reduce counter rank 0 never raised. No rank hangs: spawn_ranks
    returns both results within its timeout."""
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_ring_ranks import stalled_call
    got = spawn_ranks(stalled_call, 2, "gloo", "cuda", 2 ** 16, 2.0, peer,
                      timeout=120)
    err = got[0]["error"]
    assert err is not None and "rank 0's call 2" in err
    assert "push 1" in err and ">= 2" in err and "abandoned" in err
    raised = [got[0]] + ([got[1]] if peer == "late" else [])
    for r in raised:
        assert 2.0 <= r["seconds"] < 10.0
        assert r["sync_seconds"] < 5.0
        assert "abandoned" in r["next_call_error"]
    if peer == "late":
        err = got[1]["error"]
        assert err is not None and "rank 1's call 2" in err
        assert "push 2" in err and "reduce 1" in err
    else:
        assert got[1]["error"] is None


@pytest.mark.cuda
def test_peer_allreduce_refuses_other_dtypes(cuda_device):
    """Checked before any exchange, so no process group is needed."""
    from akka_allreduce_tpu_torch.ops.kernels import ring
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    group = RankGroup(0, 2, "gloo", cuda_device)
    x = torch.zeros(512, dtype=torch.bfloat16, device=cuda_device)
    for fn in (ring.peer_ring_allreduce, ring.peer_swing_allreduce):
        with pytest.raises(ValueError, match="float32"):
            fn(x, group)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["n2", "n3", "n4", "mesh"])
def test_ipc_transport_is_bitwise_its_gloo_twin(cuda_device, name):
    """Every case of ``tests/test_torch_transport.py``'s scenario on
    ``ipc`` ranks, each against the gloo path on the same process group."""
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_transport_ranks import SCENARIOS, run_twins, scenario_cases
    world, sp = SCENARIOS[name]
    got = spawn_ranks(run_twins, world, "ipc", "cuda", scenario_cases(name),
                      sp=sp, timeout=300)
    assert all(c["bitwise"] for r in got for c in r), got


@pytest.mark.cuda
def test_ipc_transport_streams_a_payload_of_several_chunks(cuda_device):
    """An int8 all_to_all whose block is 2 chunks and 3 bytes (the second
    block starts unaligned) and an f32 all_gather of 2.5 chunks."""
    from akka_allreduce_tpu_torch.ops.kernels import transport
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_transport_ranks import run_twins
    rng = np.random.default_rng(5)
    blk = 2 * transport.CHUNK_BYTES + 3
    cases = [("world", "all_to_all", "int8",
              [rng.integers(-128, 128, (2, blk), dtype=np.int8)
               for _ in range(2)], {}),
             ("world", "all_gather", "float32",
              [rng.standard_normal(5 * transport.CHUNK_BYTES // 8
                                   ).astype(np.float32) for _ in range(2)],
              {})]
    got = spawn_ranks(run_twins, 2, "ipc", "cuda", cases, timeout=300)
    assert [[c["bitwise"] for c in r] for r in got] == [[True, True]] * 2


@pytest.mark.cuda
def test_ipc_transport_raises_when_a_peer_skips_a_call(cuda_device):
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_transport_ranks import skip_one_call
    got = spawn_ranks(skip_one_call, 2, "ipc", "cuda", 5.0, timeout=120)
    assert got[1] == {"skipped": True}
    assert got[0]["raised"] and got[0]["seconds"] < 5.0 + 1.0, got[0]
    assert "ready from rank 1" in got[0]["message"]
    assert "abandoned" in got[0]["message"]


@pytest.mark.cuda
def test_ipc_train_fails_when_a_peer_skips_its_last_call(cuda_device):
    """``cli train --dp 2`` on ipc, once sound (its ranks' transport calls
    counted), then with rank 1 leaving out its last call (the final
    step's metrics all_gather): no rank waits on that call explicitly,
    yet the watchdog gives it up and rank 0 fails at its exit, so the run
    raises instead of returning rank 0's unfilled losses."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.ops.kernels import build
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_transport_ranks import train_skipping_a_call
    args = cli.build_parser().parse_args(
        ["train", "--device", "cuda", "--dp", "2", "--dist-backend", "ipc",
         "--steps", "2", "--log-every", "1"])
    build.build_all()
    sound = spawn_ranks(train_skipping_a_call, 2, "ipc", "cuda", args, None,
                        3.0, timeout=300)
    calls = [r["rank_info"]["transport"]["transport_calls"] for r in sound]
    assert calls[0] == calls[1] > 0
    assert all(math.isfinite(x) for x in sound[0]["losses"])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed(.|\n)*"
                       "did not end within 3 s"):
        spawn_ranks(train_skipping_a_call, 2, "ipc", "cuda", args, calls[1],
                    3.0, timeout=300)
    assert time.monotonic() - t0 < 120
