"""Paged decode attention: the port's plain version against the JAX package.

The same numpy inputs (``numpy.random.default_rng``) go through the JAX
package's ``paged_gather_attention`` and its Pallas ``paged_attention``
in interpret mode (as tests/test_paged_engine.py runs it on the CPU), and
through the port's ``paged_gather_attention`` and ``paged_attention``
wrapper (which takes the plain path for CPU tensors). f32 throughout;
atol = rtol = 1e-5 because the summation order differs (online softmax
in the Pallas kernel, another einsum order in PyTorch).

The kernel itself runs only on the card: tests/test_torch_kernels_cuda.py
holds it against the plain version there. TF32 is off for CUDA matmuls
(``allow_tf32 = False``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.ops.pallas_kernels import attention as jax_attn
from akka_allreduce_tpu_torch.ops.kernels import attention as port_attn

torch.backends.cuda.matmul.allow_tf32 = False

H, D = 4, 16


def make_inputs(h_kv: int, page_size: int, seed: int = 0):
    """Six lanes, each with its own pages: positions 0, P-1, P, the last
    position, a random one, and a lane parked on scratch page 0 (table row
    all zeros, pos 0) as the engine parks a free lane."""
    rng = np.random.default_rng(seed)
    b, n_pt = 6, 64 // page_size
    num_pages = b * n_pt + 1
    last = n_pt * page_size - 1
    q = rng.normal(size=(b, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(num_pages, page_size, h_kv, D)).astype(np.float32)
    v = rng.normal(size=(num_pages, page_size, h_kv, D)).astype(np.float32)
    table = (rng.permutation(num_pages - 1) + 1).reshape(b, n_pt)
    table = table.astype(np.int32)
    table[-1] = 0
    pos = np.array([0, page_size - 1, page_size, last,
                    int(rng.integers(0, last + 1)), 0], np.int32)
    return q, k, v, table, pos


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("h_kv", [1, 2, 4])
def test_plain_matches_jax_gather_and_pallas(h_kv, page_size):
    inputs = make_inputs(h_kv, page_size, seed=h_kv * 10 + page_size)
    want_gather = np.asarray(jax_attn.paged_gather_attention(
        *[jnp.asarray(a) for a in inputs]))
    want_pallas = np.asarray(jax_attn.paged_attention(
        *[jnp.asarray(a) for a in inputs], interpret=True))
    got = port_attn.paged_gather_attention(*_torch(*inputs)).numpy()
    np.testing.assert_allclose(got, want_gather, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    inputs = _torch(*make_inputs(2, 4, seed=7))
    before = port_attn.PAGED_ATTENTION_LAUNCHES
    got = port_attn.paged_attention(*inputs)
    want = port_attn.paged_gather_attention(*inputs)
    assert torch.equal(got, want)
    assert port_attn.PAGED_ATTENTION_LAUNCHES == before == 0


@pytest.mark.parametrize("case", ["int8", "dtype", "heads", "table", "pos"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v, table, pos = _torch(*make_inputs(2, 4, seed=3))
    if case == "int8":
        k = v = k.to(torch.int8)
    elif case == "dtype":
        q = q.to(torch.bfloat16)
    elif case == "heads":
        k = v = k[:, :, :1].repeat(1, 1, 3, 1)  # 3 KV heads for 4 q heads
    elif case == "table":
        table = table.long()
    else:
        pos = pos[:-1]
    with pytest.raises(ValueError):
        port_attn.paged_attention(q, k, v, table, pos)
