"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): it
carries the ``cuda`` marker and skips, inside a fixture, where
``torch.cuda.is_available()`` is false. The file imports no JAX, so it
runs on the GPU machine, from the repository root::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

f32 at atol = rtol = 1e-5 (another summation order), bf16 at atol 2e-2;
TF32 is off for CUDA matmuls (``allow_tf32 = False``), so the plain
version's f32 products are full f32.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.ops.kernels import attention

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def paged_inputs(h_kv: int, page_size: int, seed: int, heads: int = 8,
                 head_dim: int = 64):
    """Six lanes with their own pages: positions 0, P-1, P, the last, a
    random one, and a lane parked on scratch page 0 at pos 0."""
    rng = np.random.default_rng(seed)
    b, n_pt = 6, 128 // page_size
    num_pages = b * n_pt + 1
    last = n_pt * page_size - 1
    q = rng.normal(size=(b, 1, heads, head_dim)).astype(np.float32)
    k = rng.normal(size=(num_pages, page_size, h_kv, head_dim))
    v = rng.normal(size=(num_pages, page_size, h_kv, head_dim))
    table = (rng.permutation(num_pages - 1) + 1).reshape(b, n_pt)
    table[-1] = 0
    pos = np.array([0, page_size - 1, page_size, last,
                    int(rng.integers(0, last + 1)), 0])
    return (torch.from_numpy(q), torch.from_numpy(k.astype(np.float32)),
            torch.from_numpy(v.astype(np.float32)),
            torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(pos.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 2e-2, 0.0)])
@pytest.mark.parametrize("page_size", [8, 32])
@pytest.mark.parametrize("h_kv", [1, 2, 8])
def test_paged_attention_matches_plain(cuda_device, h_kv, page_size, dtype,
                                       atol, rtol):
    q, k, v, table, pos = [t.to(cuda_device) for t in paged_inputs(
        h_kv, page_size, seed=h_kv * 100 + page_size)]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = attention.PAGED_ATTENTION_LAUNCHES
    got = attention.paged_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert attention.PAGED_ATTENTION_LAUNCHES == before + 1
    want = attention.paged_gather_attention(q, k, v, table, pos)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_paged_attention_rejects_non_contiguous(cuda_device):
    q, k, v, table, pos = [t.to(cuda_device) for t in paged_inputs(2, 8, 0)]
    with pytest.raises(ValueError, match="contiguous"):
        attention.paged_attention(q, k.transpose(0, 1).contiguous()
                                  .transpose(0, 1), v, table, pos)
