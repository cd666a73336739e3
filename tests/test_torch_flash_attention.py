"""Flash attention: the port's plain versions against the JAX package.

The same numpy inputs (``numpy.random.default_rng``) go through the JAX
package's Pallas ``flash_attention`` in interpret mode (forward, and its
custom VJP through ``jax.vjp``; the log-sum-exp from its ``_fwd``) and
through the port's plain forward and backward. T <= 128 over 32-row
blocks, so every case spans several tiles on the JAX side. Tolerances are
the JAX package's own (tests/test_flash_attention.py): f32 at 2e-5 for the
forward and 5e-5 for the gradients (another summation order), bf16 at
3e-2 (one bf16 rounding of the output and of p / ds).

The f32 forward, dq and dk/dv kernels run their products on the tensor
cores in split TF32 (three TF32 products a product); an emulation of that
arithmetic in plain torch (``tests/torch_split_tf32.py``) is held against
the JAX package's forward (o and lse, at 2e-5) and VJP (at 5e-5) in every
f32 case, and a single TF32 product must miss each limit.

The CUDA kernels run only on the card: tests/test_torch_kernels_cuda.py
holds them against these plain versions there. TF32 is off for CUDA
matmuls (``allow_tf32 = False``).
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.ops.pallas_kernels import attention as jax_attn
from akka_allreduce_tpu_torch.ops.kernels import flash_attention as fa
from torch_split_tf32 import split_tf32_backward, split_tf32_flash_forward

torch.backends.cuda.matmul.allow_tf32 = False

H, D, BLK = 4, 32, 32

# (name, h_kv, causal, window, tq, tk, q_off, k_off, dtype)
CASES = [
    ("mha_causal", 4, True, None, 128, 128, 0, 0, "float32"),
    ("gqa_causal", 2, True, None, 128, 128, 0, 0, "float32"),
    ("mqa_causal", 1, True, None, 96, 96, 0, 0, "float32"),
    ("gqa_noncausal", 2, False, None, 64, 64, 0, 0, "float32"),
    ("gqa_window", 2, True, 40, 128, 128, 0, 0, "float32"),
    ("gqa_offsets", 2, True, 48, 64, 128, 64, 0, "float32"),
    ("gqa_causal_bf16", 2, True, None, 128, 128, 0, 0, "bfloat16"),
]
F32_CASES = [c for c in CASES if c[-1] == "float32"]
TOL = {"float32": (2e-5, 5e-5), "bfloat16": (3e-2, 3e-2)}


def make_inputs(h_kv, tq, tk, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, tq, H, D))
    k = rng.normal(size=(2, tk, h_kv, D))
    v = rng.normal(size=(2, tk, h_kv, D))
    do = rng.normal(size=(2, tq, H, D))
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [a.astype(np_dtype) for a in (q, k, v, do)]


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def jax_reference(q, k, v, do, causal, window, q_off, k_off):
    """(o, lse (B, H, Tq), dq, dk, dv) from the Pallas kernels."""
    q, k, v, do = (jnp.asarray(a) for a in (q, k, v, do))

    def attn(q, k, v):
        return jax_attn.flash_attention(q, k, v, causal, BLK, BLK, True,
                                        window, q_off, k_off)
    o, vjp = jax.vjp(attn, q, k, v)
    dq, dk, dv = vjp(do)
    kl = jax_attn._to_kernel_layout
    _, lse = jax_attn._fwd(kl(q), kl(k), kl(v), causal, BLK, BLK, True,
                           window, q_off, k_off)
    return [np.asarray(x, np.float32) for x in
            (o, lse[..., 0], dq, dk, dv)]


@functools.lru_cache(maxsize=None)
def case_data(case):
    """A case's numpy inputs and the JAX kernels' outputs on them, computed
    once for the tests that share them."""
    _, h_kv, causal, window, tq, tk, q_off, k_off, dtype = case
    arrays = make_inputs(h_kv, tq, tk, dtype, seed=tq + h_kv)
    return arrays, jax_reference(*arrays, causal, window, q_off, k_off)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_forward_and_backward_match_jax(case):
    _, h_kv, causal, window, tq, tk, q_off, k_off, dtype = case
    arrays, (want_o, want_lse, want_dq, want_dk, want_dv) = case_data(case)
    q, k, v, do = (to_torch(a) for a in arrays)
    o, lse = fa.flash_forward_reference(q, k, v, causal, window, q_off,
                                        k_off)
    dq, dk, dv = fa.flash_backward_reference(q, k, v, o, lse, do, causal,
                                             window, q_off, k_off)
    tol_fwd, tol_bwd = TOL[dtype]
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, H, tq)
    np.testing.assert_allclose(to_numpy(o), want_o, atol=tol_fwd,
                               rtol=tol_fwd)
    np.testing.assert_allclose(to_numpy(lse), want_lse, atol=tol_fwd,
                               rtol=tol_fwd)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.dtype == q.dtype
        np.testing.assert_allclose(to_numpy(got), want, atol=tol_bwd,
                                   rtol=tol_bwd, err_msg=name)


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_split_tf32_backward_matches_jax_vjp(case):
    """The split-TF32 arithmetic of ``flash_dq_tf32_mma_kernel`` and
    ``flash_dkv_tf32_mma_kernel`` (emulated) from JAX's own o and lse,
    against JAX's ``flash_attention`` VJP, within the f32 gradient
    tolerance; one TF32 product a product misses it in each of dq, dk
    and dv, which is why the kernels take three."""
    _, h_kv, causal, window, tq, tk, q_off, k_off, dtype = case
    arrays, (want_o, want_lse, *want) = case_data(case)
    q, k, v, do = (to_torch(a) for a in arrays)
    delta = fa.attention_delta(torch.tensor(want_o), do)
    args = (q, k, v, do, torch.tensor(want_lse), delta, q_off, k_off,
            causal)
    tol = TOL[dtype][1]
    for got, w in zip(split_tf32_backward(*args, 3, window), want):
        np.testing.assert_allclose(got.numpy(), w, atol=tol, rtol=tol)
    for got, w in zip(split_tf32_backward(*args, 1, window), want):
        assert not np.allclose(got.numpy(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", F32_CASES, ids=[c[0] for c in F32_CASES])
def test_split_tf32_forward_matches_jax(case):
    """The split-TF32 arithmetic of ``flash_fwd_tf32_mma_kernel``
    (emulated, with the kernel's exp2 of the scale-folded score) against
    JAX's ``flash_attention`` o and its ``_fwd`` lse, within the f32
    forward tolerance (2e-5); one TF32 product a product misses it in
    both o and lse, which is why the kernel takes three."""
    _, h_kv, causal, window, tq, tk, q_off, k_off, dtype = case
    arrays, (want_o, want_lse, *_) = case_data(case)
    q, k, v, _ = (to_torch(a) for a in arrays)
    tol = TOL[dtype][0]
    o, lse = split_tf32_flash_forward(q, k, v, q_off, k_off, causal, 3,
                                      window)
    np.testing.assert_allclose(o.numpy(), want_o, atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=tol, rtol=tol)
    o, lse = split_tf32_flash_forward(q, k, v, q_off, k_off, causal, 1,
                                      window)
    assert not np.allclose(o.numpy(), want_o, atol=tol, rtol=tol)
    assert not np.allclose(lse.numpy(), want_lse, atol=tol, rtol=tol)


@pytest.mark.parametrize("h_kv,window", [(1, None), (2, 24), (4, None)])
def test_autograd_function_matches_autograd_through_plain_forward(h_kv,
                                                                  window):
    q, k, v, do = (to_torch(a) for a in make_inputs(h_kv, 80, 80,
                                                    "float32", seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad(out, leaves, do)
    leaves_ref = [t.clone().requires_grad_() for t in (q, k, v)]
    out_ref, _ = fa.flash_forward_reference(*leaves_ref, True, window)
    want = torch.autograd.grad(out_ref, leaves_ref, do)
    torch.testing.assert_close(out, out_ref, atol=2e-5, rtol=2e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)


def test_flash_causal_attention_matches_local_oracle():
    from akka_allreduce_tpu_torch.parallel.ring_attention import \
        local_causal_attention
    q, k, v, _ = (to_torch(a) for a in make_inputs(2, 64, 64, "float32",
                                                   seed=9))
    torch.testing.assert_close(fa.flash_causal_attention(q, k, v, window=7),
                               local_causal_attention(q, k, v, window=7),
                               atol=2e-5, rtol=2e-5)


def test_wrappers_on_cpu_take_plain_path_and_count_nothing():
    q, k, v, do = (to_torch(a) for a in make_inputs(2, 64, 64, "float32",
                                                    seed=1))
    o, lse = fa.flash_forward(q, k, v)
    want_o, want_lse = fa.flash_forward_reference(q, k, v)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta)
    want = fa.flash_backward_reference(q, k, v, o, lse, do)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for got, w in zip((dq, dk, dv), want):
        assert torch.equal(got, w)
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_DQ_LAUNCHES,
            fa.FLASH_DKV_LAUNCHES) == (0, 0, 0)


@pytest.mark.parametrize("kwargs", [dict(causal=False, window=8),
                                    dict(causal=True, window=0)])
def test_window_needs_causal_and_a_positive_width(kwargs):
    q, k, v, _ = (to_torch(a) for a in make_inputs(2, 32, 32, "float32",
                                                   seed=2))
    with pytest.raises(ValueError, match="window needs causal"):
        fa.flash_attention(q, k, v, **kwargs)


@pytest.mark.parametrize("case", ["dtype", "heads", "head_dim_mismatch"])
def test_wrapper_rejects_what_the_kernels_do_not_take(case):
    q, k, v, _ = (to_torch(a) for a in make_inputs(2, 32, 32, "float32",
                                                   seed=3))
    if case == "dtype":
        k = k.double()
    elif case == "heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    else:
        k, v = k[..., :16], v[..., :16]
    with pytest.raises(ValueError):
        fa.flash_forward(q, k, v)
