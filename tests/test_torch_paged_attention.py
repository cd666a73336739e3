"""Paged decode attention: the port's plain version against the JAX package.

The same numpy inputs (``numpy.random.default_rng``) go through the JAX
package's ``paged_gather_attention`` and its Pallas ``paged_attention``
in interpret mode (as tests/test_paged_engine.py runs it on the CPU), and
through the port's ``paged_gather_attention`` and ``paged_attention``
wrapper (which takes the plain path for CPU tensors). f32 throughout;
atol = rtol = 1e-5 because the summation order differs (online softmax
in the Pallas kernel, another einsum order in PyTorch).

The kernel itself runs only on the card: tests/test_torch_kernels_cuda.py
holds it against the plain version there. Its split-KV schedule (each
lane's live pages shared out over S blocks, JAX's online-softmax tile per
page with p rounded to the pool dtype, the S partial states merged) is
held here through :func:`split_kv_emulation`, a plain-torch replay of
that schedule kept in this file so that nothing on the port's path uses
it: f32 at atol = rtol = 1e-5, bf16 at 2e-2 (the kernel's tolerances on
the card). TF32 is off for CUDA matmuls (``allow_tf32 = False``).
"""

import functools

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


# -- the kernel's split-KV schedule, emulated ------------------------------

NEG_INF = -1e30  # JAX's finite mask value, the kernel's empty-split m


def split_kv_emulation(q, k_pages, v_pages, table, pos, splits: int,
                       step_pages: int = 1):
    """The CUDA kernel's schedule in plain torch: block s of lane b and
    KV head hk takes the contiguous share ``[s * c, (s + 1) * c)`` (c =
    ceil(n_live / S)) of the lane's n_live = ceil((pos+1)/P) live pages
    and runs JAX's ``_softmax_tile`` over the live keys of
    ``step_pages`` pages at a time (f32 scores and state, p rounded to
    the pool dtype before the value product, l from the unrounded p); a
    split with no page keeps m = NEG_INF, l = 0, acc = 0. The S states
    merge as the cluster does: M = max m_s, w_s = exp(min(m_s, M) - M),
    out = sum w_s acc_s / sum w_s l_s."""
    b, _, h, d = q.shape
    _, p, h_kv, _ = k_pages.shape
    g = h // h_kv
    n_pt = table.shape[1]
    scale = d ** -0.5
    out = torch.empty_like(q)
    for lane in range(b):
        lane_pos = int(pos[lane])
        n_live = min(lane_pos // p + 1, n_pt)
        share = -(-n_live // splits)
        for hk in range(h_kv):
            qg = q[lane, 0, hk * g:(hk + 1) * g].float()
            states = []
            for s in range(splits):
                m = torch.full((g, 1), NEG_INF)
                l = torch.zeros((g, 1))
                acc = torch.zeros((g, d))
                end = min((s + 1) * share, n_live)
                for j0 in range(s * share, end, step_pages):
                    pages = [int(x) for x in
                             table[lane, j0:min(j0 + step_pages, end)]]
                    valid = min(len(pages) * p, lane_pos - j0 * p + 1)
                    k = k_pages[pages, :, hk].reshape(-1, d)[:valid].float()
                    v = v_pages[pages, :, hk].reshape(-1, d)[:valid]
                    scores = (qg @ k.T) * scale
                    m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
                    corr = torch.exp(torch.minimum(m, m_new) - m_new)
                    pr = torch.exp(scores - m_new)
                    l = l * corr + pr.sum(-1, keepdim=True)
                    acc = acc * corr + pr.to(v.dtype).float() @ v.float()
                    m = m_new
                states.append((m, l, acc))
            m_all = torch.stack([st[0] for st in states])
            m_max = m_all.amax(0)
            w = torch.exp(torch.minimum(m_all, m_max) - m_max)
            l_tot = sum(w[i] * states[i][1] for i in range(splits))
            o = sum(w[i] * states[i][2] for i in range(splits))
            out[lane, 0, hk * g:(hk + 1) * g] = (o / l_tot).to(q.dtype)
    return out


SPLIT_PAGES = 32  # n_pt of the emulation's inputs: 24 + 1 pages fit


def split_inputs(h_kv: int, page_size: int, seed: int):
    """Eight lanes over 32-page tables: positions 0, P-1, P, the last,
    24P-1 (24 live pages, a split boundary for S = 1, 2, 3 and 8), 24P
    (one page past it: at S = 8 the last split is empty), 8P+3 (9 pages:
    at S = 8 splits 5-7 are empty) and a lane parked on scratch page 0
    (table row all zeros, pos 0)."""
    rng = np.random.default_rng(seed)
    b, n_pt = 8, SPLIT_PAGES
    num_pages = b * n_pt + 1
    q = rng.normal(size=(b, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(num_pages, page_size, h_kv, D)).astype(np.float32)
    v = rng.normal(size=(num_pages, page_size, h_kv, D)).astype(np.float32)
    table = (rng.permutation(num_pages - 1) + 1).reshape(b, n_pt)
    table = table.astype(np.int32)
    table[-1] = 0
    p = page_size
    pos = np.array([0, p - 1, p, n_pt * p - 1, 24 * p - 1, 24 * p,
                    8 * p + 3, 0], np.int32)
    return q, k, v, table, pos


@functools.lru_cache(maxsize=None)
def split_case(h_kv: int, page_size: int, dtype_name: str):
    """Inputs in ``dtype_name`` and the JAX package's outputs on them:
    ``paged_gather_attention`` and ``paged_attention(interpret=True)``."""
    inputs = split_inputs(h_kv, page_size, seed=h_kv * 10 + page_size)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = getattr(torch, dtype_name)
    jax_in = [jnp.asarray(a, jdt) if a.dtype == np.float32
              else jnp.asarray(a) for a in inputs]
    torch_in = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
                else torch.from_numpy(a) for a in inputs]
    gather = np.asarray(jax_attn.paged_gather_attention(*jax_in)
                        .astype(jnp.float32))
    pallas = np.asarray(jax_attn.paged_attention(*jax_in, interpret=True)
                        .astype(jnp.float32))
    return torch_in, gather, pallas


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("h_kv", [1, 2, 4])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_kv_schedule_matches_jax(splits, h_kv, page_size, dtype_name,
                                       tol):
    """The kernel's steps (64 keys here: 16 pages of 4, 4 of 16), and one
    page a step, as JAX's kernel takes them."""
    torch_in, want_gather, want_pallas = split_case(h_kv, page_size,
                                                    dtype_name)
    step = port_attn.paged_stage_pages(page_size, D,
                                       torch_in[0].element_size())
    assert step * page_size == 64
    for step_pages in (step, 1):
        got = split_kv_emulation(*torch_in, splits,
                                 step_pages).float().numpy()
        assert np.isfinite(got).all()
        rtol = tol if dtype_name == "float32" else 0.0
        np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=rtol)
        np.testing.assert_allclose(got, want_gather, atol=tol, rtol=rtol)


def test_kernel_steps_at_the_served_shape():
    """D 128, P 16: two pages a step in f32 (32 KB), four in bf16."""
    assert port_attn.paged_stage_pages(16, 128, 4) == 2
    assert port_attn.paged_stage_pages(16, 128, 2) == 4
    # one page, even past 32 KB
    assert port_attn.paged_stage_pages(128, 256, 4) == 1


def test_emulation_positions_hit_empty_and_boundary_splits():
    """The inputs reach what the merge must survive: at S = 8 the lanes
    at 0, 24P and 8P+3 leave splits with no live key, and 24P-1 ends
    exactly on a share boundary at every S of the test."""
    p = 16
    _, _, _, _, pos = split_inputs(2, p, seed=0)
    n_live = pos // p + 1
    assert n_live.tolist() == [1, 1, 2, SPLIT_PAGES, 24, 25, 9, 1]
    for s in (1, 2, 3, 8):
        assert 24 % s == 0
    share = -(-n_live // 8)
    assert ((n_live - 7 * share) <= 0).sum() >= 4  # split 7 empty


@pytest.mark.parametrize("batch,h_kv,n_pt,sms,want", [
    (8, 4, 32, 132, 8),     # the serve shape: 32 pairs, 256 blocks
    (8, 16, 32, 132, 3),    # MHA: 128 pairs, 384 blocks
    (8, 1, 32, 132, 8),     # MQA: capped at a portable cluster
    (8, 4, 2, 132, 2),      # never more splits than table pages
    (64, 8, 32, 132, 1)])   # 512 pairs fill the card alone
def test_paged_splits_fill_the_card_twice(batch, h_kv, n_pt, sms, want):
    got = port_attn.paged_splits(batch, h_kv, n_pt, sms)
    assert got == want
    assert 1 <= got <= port_attn.MAX_SPLITS
    assert batch * h_kv * got >= 2 * sms or got in (port_attn.MAX_SPLITS,
                                                    n_pt)
