"""Ring flash attention of the port against the JAX package's, on the CPU.

The same global q, k, v and dO (numpy, from a seed) go through JAX's
``ring_flash_attention(interpret=True)`` (16-wide blocks) under
``shard_map`` on a 2- and a 4-device ``sp`` mesh, and through the port's
``RingFlashAttention`` (the kernels' plain versions on CPU tensors) on 2
and 4 gloo ranks, spawned once per ring size. Pins, f32 at 1e-5 (the
flash parity tests' tolerance): the output and dq, dk, dv for MHA, GQA,
MQA and non-causal; a ragged T_local (40, no 16-wide block) against
JAX's pure ``ring_attention``; the port's plain ring and its windowed-SP
paths against JAX's; and each hop's plain kernel functions against the
JAX kernels through the carry at fixed offset pairs (head dims 16 and
32). The f32 ring forward, dq and dk/dv run their products on the tensor
cores in split TF32 (three TF32 products a product); an emulation of
that arithmetic in plain torch (``tests/torch_split_tf32.py``) is held
against the JAX kernels at the f32 tolerances (2e-5 on the carry, 5e-5
on the gradients), and a single TF32 product must miss them.
The group's ``ppermute`` runs on a (dp 2, sp 3) mesh, where a shift and
a pairwise exchange differ.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.ops.pallas_kernels import ring_flash as jrf
from akka_allreduce_tpu.parallel import ring_attention as jra
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch.ops.kernels import ring_flash as rf
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
from torch_sp_ranks import attention_vjp, ppermute_probe
from torch_split_tf32 import (split_tf32_backward, split_tf32_forward, tf32,
                              tf32_trunc)

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, D = 2, 4, 16

# name -> (h_kv, t_local, causal, jax path); the port runs RingFlashAttention
RING_CASES = {
    "mha": (4, 32, True, "flash"),
    "gqa": (2, 32, True, "flash"),
    "mqa": (1, 32, True, "flash"),
    "noncausal": (2, 32, False, "flash"),
    "ragged": (2, 40, True, "ring")}
# name -> (port impl, h_kv, t_local, window, jax function)
OTHER_CASES = {
    "plain_ring": ("ring", 2, 32, None, "ring"),
    "windowed": ("windowed", 2, 32, 12, "windowed"),
    "flash_windowed": ("flash_windowed", 2, 32, 12, "flash_windowed")}
SIZES = {2: list(RING_CASES) + list(OTHER_CASES), 4: ["gqa", "ragged",
                                                      "flash_windowed"]}
PAIRS = [(n, name) for n, names in SIZES.items() for name in names]


def inputs(h_kv: int, t: int, seed: int, d: int = D):
    rng = np.random.default_rng(seed)
    shapes = ((B, t, H, d), (B, t, h_kv, d), (B, t, h_kv, d), (B, t, H, d))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def case_args(name: str, n: int):
    """(port impl, q, k, v, do, causal, window, jax kind) of a case."""
    if name in RING_CASES:
        h_kv, t, causal, kind = RING_CASES[name]
        impl, window = "ring_flash", None
    else:
        impl, h_kv, t, window, kind = OTHER_CASES[name]
        causal = True
    q, k, v, do = inputs(h_kv, t * n, seed=len(name) + n)
    return impl, q, k, v, do, causal, window, kind


def jax_vjp(n: int, kind: str, q, k, v, do, causal, window):
    """(o, dq, dk, dv) of the JAX path on an n-device sp mesh."""
    mesh = make_device_mesh(MeshSpec(sp=n), devices=jax.devices()[:n])
    fn = {"flash": partial(jrf.ring_flash_attention, axis_name="sp",
                           causal=causal, block_q=16, block_k=16,
                           interpret=True),
          "ring": partial(jra.ring_attention, axis_name="sp", causal=causal),
          "windowed": partial(jra.windowed_sp_attention, window=window,
                              axis_name="sp"),
          "flash_windowed": partial(jra.flash_windowed_sp_attention,
                                    window=window, axis_name="sp",
                                    block_q=16, block_k=16,
                                    interpret=True)}[kind]
    # check_vma=False as tests/test_ring_flash.py: interpret-mode pallas
    # inside a vma-checked shard_map trips an upstream JAX bug
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                            out_specs=P(None, "sp"), check_vma=False)

    @jax.jit
    def run(q, k, v, do):
        o, pull = jax.vjp(sharded, q, k, v)
        return (o,) + pull(do)
    return [np.asarray(x) for x in run(q, k, v, do)]


@pytest.fixture(scope="module")
def ring():
    """Both sides of every case at each ring size: {(n, name): (port,
    jax)}, the port's per-rank results concatenated along the sequence
    (one spawn per ring size)."""
    out = {}
    for n, names in SIZES.items():
        cases = {name: case_args(name, n) for name in names}
        ranks = spawn_ranks(attention_vjp, n, "gloo", "cpu",
                            [c[:7] for c in cases.values()], sp=n)
        for i, name in enumerate(names):
            port = [np.concatenate([r[i][j] for r in ranks], axis=1)
                    for j in range(4)]
            _, q, k, v, do, causal, window, kind = cases[name]
            out[n, name] = (port, jax_vjp(n, kind, q, k, v, do, causal,
                                          window))
    return out


@pytest.mark.parametrize("n,name", PAIRS,
                         ids=[f"sp{n}-{name}" for n, name in PAIRS])
def test_port_matches_jax(ring, n, name):
    port, want = ring[n, name]
    for got, w, what in zip(port, want, ("o", "dq", "dk", "dv")):
        assert got.shape == w.shape, what
        np.testing.assert_allclose(got, w, err_msg=f"{name} sp={n} {what}",
                                   **TOL)


# -- one hop: the plain kernel functions against the JAX kernels ------------

def _jax_hop(q, k, v, do, carry, offs, causal):
    """JAX's one-hop kernels (interpret mode) in its (B, H, T, D) layout:
    the updated carry and the f32 partials."""
    kl = [jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v, do)]
    m, l_sum, acc = (jnp.asarray(carry[0])[..., None],
                     jnp.asarray(carry[1])[..., None],
                     jnp.swapaxes(jnp.asarray(carry[2]), 1, 2))
    offs = jnp.asarray(offs, jnp.int32)
    m2, l2, acc2 = jrf._ring_fwd_step(offs, kl[0], kl[1], kl[2], m, l_sum,
                                      acc, causal, 16, 16, True, frozenset())
    lse = m2 + jnp.log(l2)  # the hop's own statistics, for the backward
    o = acc2 / l2
    delta = jnp.einsum("bhtd,bhtd->bht", kl[3], o)[..., None]
    parts = jrf._ring_bwd_step(offs, kl[0], kl[1], kl[2], kl[3], lse, delta,
                               causal, 16, 16, True, frozenset())
    return ([np.asarray(m2[..., 0]), np.asarray(l2[..., 0]),
             np.asarray(jnp.swapaxes(acc2, 1, 2))],
            np.array(lse[..., 0]), np.array(delta[..., 0]),
            [np.asarray(jnp.swapaxes(p, 1, 2)) for p in parts])


def held_carry(q, k, v):
    """A carry that already holds a hop: the block scored against itself
    by the plain forward (torch tensors)."""
    t = torch.from_numpy
    m0 = torch.full((B, H, q.shape[1]), -1e30)
    return [x.contiguous() for x in rf.ring_fwd_reference(
        t(q), t(k), t(v), m0, torch.zeros_like(m0),
        torch.zeros(q.shape), 0, 0)]


@pytest.mark.parametrize("d", [D, 32])
@pytest.mark.parametrize("offs,causal,h_kv", [
    ((32, 32), True, 2),    # the diagonal hop: a masked triangle
    ((64, 0), True, 2),     # a past hop: every pair live
    ((32, 32), True, 1),    # MQA
    ((32, 96), False, 4)])  # non-causal ignores the offsets
def test_one_hop_matches_jax_kernels(offs, causal, h_kv, d):
    q, k, v, do = inputs(h_kv, 32, seed=7 + h_kv, d=d)
    t = torch.from_numpy
    carry = held_carry(q, k, v)
    want_carry, lse, delta, want_parts = _jax_hop(
        q, k, v, do, [x.numpy() for x in carry], offs, causal)
    got = rf.ring_fwd(t(q), t(k), t(v), *[x.clone() for x in carry], *offs,
                      causal)
    for g, w in zip(got, want_carry):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    acc = [torch.zeros(s) for s in (q.shape, k.shape, k.shape)]
    rf.ring_dq(t(q), t(k), t(v), t(do), t(lse), t(delta), acc[0], *offs,
               causal)
    rf.ring_dkv(t(q), t(k), t(v), t(do), t(lse), t(delta), acc[1], acc[2],
                *offs, causal)
    for g, w in zip(acc, want_parts):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert rf.counts() == {"ring_fwd": 0, "ring_dq": 0, "ring_dkv": 0}


# -- split TF32: the f32 ring backward's products, emulated ----------------

GRAD_TOL = dict(atol=5e-5, rtol=5e-5)  # chip_smoke phase 11's f32 bound
FWD_TOL = dict(atol=2e-5, rtol=2e-5)   # and its f32 forward bound
SPLIT_HOPS = [
    ((32, 32), True, 4),    # the diagonal hop, MHA
    ((64, 0), True, 4),     # a past hop: every pair live
    ((32, 32), True, 1),    # the diagonal hop, MQA
    ((64, 0), True, 1),     # a past hop, MQA
    ((32, 96), False, 4)]   # non-causal


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # a TF32 value: 10 mantissa bits
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 0.0])
    want = torch.tensor([1.0, one, one, -one, 1.0, one, 0.0])
    assert torch.equal(tf32(x), want)
    assert torch.equal(tf32_trunc(x), torch.tensor(
        [1.0, one, 1.0, -1.0, 1.0, 1.0, 0.0]))
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=1000).astype(np.float32))
    hi = tf32(y)
    assert float(((y - hi) / y).abs().max()) <= 2.0 ** -11
    # the split's remainder, as the tensor core reads lo
    assert float(((y - hi - tf32_trunc(y - hi)) / y).abs().max()) \
        <= 2.0 ** -21


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("offs,causal,h_kv", SPLIT_HOPS)
def test_split_tf32_forward_matches_jax_kernels(offs, causal, h_kv, seed):
    """The split-TF32 arithmetic of ``ring_fwd_tf32_mma_kernel``
    (emulated, with the kernel's exp2), one hop at D 32 folded into a
    carry that already holds a hop, against JAX's ``_ring_fwd_kernel`` in
    interpret mode: m, l and acc as the output it stands for (acc / l)
    within the f32 forward tolerance (2e-5); one TF32 product a product
    misses it in acc / l, which is why the kernel takes three."""
    q, k, v, do = inputs(h_kv, 32, seed=200 + seed, d=32)
    carry = held_carry(q, k, v)
    (want_m, want_l, want_acc), *_ = _jax_hop(
        q, k, v, do, [x.numpy() for x in carry], offs, causal)
    want_o = want_acc / np.swapaxes(want_l, 1, 2)[..., None]
    t = torch.from_numpy
    for products in (3, 1):
        m, l_sum, acc = split_tf32_forward(t(q), t(k), t(v), *carry, *offs,
                                           causal, products)
        o = (acc / l_sum.transpose(1, 2)[..., None]).numpy()
        if products == 3:
            np.testing.assert_allclose(m.numpy(), want_m, **FWD_TOL)
            np.testing.assert_allclose(l_sum.numpy(), want_l, **FWD_TOL)
            np.testing.assert_allclose(o, want_o, **FWD_TOL)
        else:
            assert not np.allclose(o, want_o, **FWD_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("offs,causal,h_kv", SPLIT_HOPS)
def test_split_tf32_backward_matches_jax_kernels(offs, causal, h_kv, seed):
    """The split-TF32 arithmetic of ``ring_dq_tf32_mma_kernel`` and
    ``ring_dkv_tf32_mma_kernel`` (emulated) against JAX's
    ``_ring_dq_kernel`` / ``_ring_dkv_kernel`` in interpret mode, within
    the f32 tolerance; one TF32 product a product misses it in each of
    dq, dk and dv, which is why the kernels take three."""
    q, k, v, do = inputs(h_kv, 32, seed=100 + seed)
    t = torch.from_numpy
    carry = held_carry(q, k, v)
    _, lse, delta, want = _jax_hop(q, k, v, do, [x.numpy() for x in carry],
                                   offs, causal)
    args = (t(q), t(k), t(v), t(do), t(lse), t(delta), *offs, causal)
    for got, w in zip(split_tf32_backward(*args, products=3), want):
        np.testing.assert_allclose(got.numpy(), w, **GRAD_TOL)
    for got, w in zip(split_tf32_backward(*args, products=1), want):
        assert not np.allclose(got.numpy(), w, **GRAD_TOL)


def test_wrappers_refuse_a_bad_carry():
    q, k, v, _ = [torch.from_numpy(x) for x in inputs(2, 32, seed=0)]
    m = torch.zeros(B, H, 32)
    with pytest.raises(ValueError, match="acc must be"):
        rf.ring_fwd(q, k, v, m, m.clone(), torch.zeros(B, H, 32, D), 0, 0)
    with pytest.raises(ValueError, match="dq must be"):
        rf.ring_dq(q, k, v, q, m, m, torch.zeros(B, 32, H, D,
                                                 dtype=torch.float64), 0, 0)


# -- the group's ppermute on a (dp 2, sp 3) mesh -----------------------------

def test_ppermute_on_a_dp2_sp3_mesh():
    ranks = spawn_ranks(ppermute_probe, 6, "gloo", "cpu", sp=3)
    for r, got in enumerate(ranks):
        dp_i, sp_j = divmod(r, 3)
        assert got["dp"] == (dp_i, 2) and got["sp"] == (sp_j, 3)
        for dtype in ("torch.float32", "torch.bfloat16", "torch.int32"):
            for shift in (1, -1, 2):
                # receive from -shift along the axis, the other coordinate kept
                src_sp = dp_i * 3 + (sp_j - shift) % 3
                src_dp = ((dp_i - shift) % 2) * 3 + sp_j
                assert got[("sp", shift, dtype)] == (True, [float(src_sp)])
                assert got[("dp", shift, dtype)] == (True, [float(src_dp)])
