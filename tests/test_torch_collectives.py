"""The port's rank-local collectives against the JAX package's.

The port's ranks are gloo processes on the CPU (``spawn_ranks``, one
spawn per group size running every case of this file through
``run_calls``); JAX runs the same inputs on the conftest's 8-device CPU
mesh under ``shard_map``. Pins, at N = 2 and 4 (3 for the padding):

* f32: two-phase and psum allclose to JAX at rtol 1e-6; windowed bitwise
  the fused two-phase; swing bitwise identical across ranks and equal to
  the host-computed balanced pairwise tree; a non-power-of-two group
  refused.
* int8: rows identical on every rank, inside the JAX tests' envelope
  (3 * 2/127 * N * max|x|), unbiased over keys, padded rows, outlier
  damage confined to its bucket; fused and windowed carves.
* ef8: the phase-1 residual bitwise JAX's (round-to-nearest is a pure
  function); with ``residual2`` the output within one block quantum of
  JAX's; error feedback telescoping over rounds; masked rows keeping
  their residual bitwise.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.ops import collectives as jc
from akka_allreduce_tpu.parallel.mesh import single_axis_mesh
from akka_allreduce_tpu_torch.ops import collectives as tc
from akka_allreduce_tpu_torch.parallel.group import (PerRank, RankGroup, Ref,
                                                     run_calls, spawn_ranks)

C = "akka_allreduce_tpu_torch.ops.collectives:"
ROWS, COLS = 5, 301  # no group size divides either: both pad
ROUNDS = 6       # ef8 telescoping rounds
DRAWS = 16       # int8 unbiasedness draws


def stacked(n, seed, rows=ROWS, cols=COLS, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, rows, cols)) * scale).astype(np.float32)


def outlier_input(n):
    rng = np.random.default_rng(8)
    big = rng.normal(size=(n, 1, 256)) * 1e4
    small = rng.normal(size=(n, 1, 256)) * 1e-2
    return np.concatenate([big, small], axis=1).astype(np.float32)


def residual_input(n):
    return stacked(n, 50, scale=1e-3)


def masks(n):
    return np.array([[(r + b) % 3 != 0 for b in range(ROWS)]
                     for r in range(n)], np.int32)


def calls_for(n):
    """Every case of this file at group size n, in one list."""
    x, xo = stacked(n, n), outlier_input(n)
    res = residual_input(n)
    calls = [
        (C + "two_phase_allreduce", [PerRank(list(x))], {}),          # 0
        (C + "psum_allreduce", [PerRank(list(x))], {}),               # 1
        (C + "pipelined_two_phase_allreduce", [PerRank(list(x))],
         {"num_windows": 5}),                                         # 2
        (C + "quantized_two_phase_allreduce", [PerRank(list(x)), (1,)],
         {}),                                                         # 3
        (C + "quantized_two_phase_allreduce", [PerRank(list(x)), (1,)],
         {"num_windows": 2}),                                         # 4
        (C + "quantized_two_phase_allreduce", [PerRank(list(xo)), (2,)],
         {}),                                                         # 5
        (C + "ef8_two_phase_allreduce", [PerRank(list(x)), (3,)],
         {"residual": PerRank(list(res)), "block_elems": 128}),       # 6
        (C + "ef8_two_phase_allreduce", [PerRank(list(x)), (3,)],
         {"residual": PerRank(list(res)), "block_elems": 128,
          "valid": PerRank(list(masks(n)))}),                         # 7
        (C + "ef8_two_phase_allreduce", [PerRank(list(x)), (3,)],
         {"residual": PerRank(list(res)), "block_elems": 128,
          "num_windows": 2}),                                         # 8
    ]
    if n & (n - 1) == 0:
        calls += [
            (C + "swing_allreduce", [PerRank(list(x))], {}),          # 9
            (C + "quantized_swing_allreduce", [PerRank(list(x)), (4,)],
             {}),                                                     # 10
            (C + "quantized_swing_allreduce", [PerRank(list(x)), (4,)],
             {"residual": PerRank(list(res)), "block_elems": 128}),   # 11
        ]
        rows2 = jc.ef8_phase2_rows(ROWS, n)
        calls.append((C + "ef8_two_phase_allreduce",
                      [PerRank(list(x)), (5,)],
                      {"residual": PerRank(list(res)), "block_elems": 128,
                       "residual2": PerRank(list(stacked(
                           n, 51, rows=rows2, scale=1e-3)))}))        # 12
    start = len(calls)
    for k in range(DRAWS):                                  # unbiasedness
        calls.append((C + "quantized_two_phase_allreduce",
                      [PerRank(list(x)), (100 + k,)], {}))
    tele = len(calls)
    for t in range(ROUNDS):                                 # telescoping
        resid = ({"residual": PerRank(list(np.zeros_like(x)))} if t == 0
                 else {"residual": Ref(tele + t - 1, 1)})
        calls.append((C + "ef8_two_phase_allreduce",
                      [PerRank(list(x)), (200 + t,)],
                      {"block_elems": 128, **resid}))
    return calls, start, tele


@pytest.fixture(scope="module", params=[2, 4, 3], ids=["n2", "n4", "n3"])
def ranks(request):
    n = request.param
    calls, start, tele = calls_for(n)
    outs = spawn_ranks(run_calls, n, "gloo", "cpu", calls)
    return n, outs, start, tele


def per_rank(outs, i, item=None):
    return [o[i] if item is None else o[i][item] for o in outs]


def jax_run(fn, n, *args):
    """``fn`` on each rank of an n-device mesh; ``args`` stacked over
    ranks on axis 0; returns the stacked outputs as numpy."""
    mesh = single_axis_mesh("dp", devices=jax.devices()[:n])

    @partial(jax.shard_map, mesh=mesh, in_specs=tuple(P("dp") for _ in args),
             out_specs=P("dp"), check_vma=False)
    def run(*xs):
        return jax.tree.map(lambda o: o[None], fn(*[a[0] for a in xs]))

    return jax.tree.map(np.asarray, run(*[jnp.asarray(a) for a in args]))


def int8_atol(x, n):
    return 3 * 2 / 127 * n * np.abs(x).max()


def host_swing_tree(stack):
    vals = [v.astype(np.float32) for v in stack]
    d = 1
    while d < len(vals):
        vals = [vals[j] + vals[j ^ d] for j in range(len(vals))]
        d *= 2
    return vals[0]


def test_f32_two_phase_psum_and_windowed(ranks):
    n, outs, _, _ = ranks
    x = stacked(n, n)
    want = jax_run(partial(jc.two_phase_allreduce, axis_name="dp"), n, x)
    for r in range(n):
        np.testing.assert_allclose(outs[r][0].numpy(), want[r], rtol=1e-6,
                                   atol=1e-6)
        # windowed and psum are bitwise the fused two-phase
        assert torch.equal(outs[r][2], outs[r][0])
        assert torch.equal(outs[r][1], outs[r][0])
        assert torch.equal(outs[r][0], outs[0][0])
    np.testing.assert_allclose(outs[0][0].numpy(), x.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_swing_bitwise_tree_and_power_of_two(ranks):
    n, outs, _, _ = ranks
    if n & (n - 1):
        with pytest.raises(ValueError, match="power-of-two"):
            tc.swing_allreduce(torch.zeros(2, 3),
                               RankGroup(0, n, "gloo", torch.device("cpu")))
        return
    want = host_swing_tree(stacked(n, n))
    for r in range(n):
        np.testing.assert_array_equal(outs[r][9].numpy(), want)


def test_int8_identical_rows_and_envelope(ranks):
    n, outs, _, _ = ranks
    x = stacked(n, n)
    cases = [3, 4] + ([10] if n & (n - 1) == 0 else [])
    for i in cases:
        got = per_rank(outs, i, 0 if i == 10 else None)
        for g in got[1:]:
            assert torch.equal(g, got[0])
        assert got[0].shape == (ROWS, COLS)
        np.testing.assert_allclose(got[0].numpy(), x.sum(0),
                                   atol=int8_atol(x, n))
        assert not torch.equal(got[0], torch.from_numpy(x.sum(0)))
    if n != 2:
        return
    # the JAX wire on the same inputs sits in the same envelope
    jwant = jax_run(lambda b: jc.quantized_two_phase_allreduce(
        b, jax.random.key(1), "dp"), n, x)
    np.testing.assert_allclose(outs[0][3].numpy(), jwant[0],
                               atol=2 * int8_atol(x, n))


def test_int8_unbiased_over_keys(ranks):
    n, outs, start, _ = ranks
    exact = stacked(n, n).sum(0)
    draws = np.stack([outs[0][start + k].numpy() for k in range(DRAWS)])
    single = np.abs(draws[0] - exact).mean()
    assert np.abs(draws.mean(0) - exact).mean() < single / 2


def test_int8_outlier_damage_is_confined(ranks):
    n, outs, _, _ = ranks
    xo = outlier_input(n)
    small = xo[:, 1]
    got = outs[0][5].numpy()[1]
    assert np.abs(got - small.sum(0)).max() < 3 * 2 / 127 * n * np.abs(
        small).max()


def test_ef8_phase1_residual_is_bitwise_jax(ranks):
    n, outs, _, _ = ranks
    if n == 3:
        return  # n = 2 and 4 pin it; n = 3 pins the padding
    x, res = stacked(n, n), residual_input(n)
    jout, jres = jax_run(lambda b, r: jc.ef8_two_phase_allreduce(
        b, jax.random.key(3), "dp", residual=r, block_elems=128), n, x, res)
    for r in range(n):
        np.testing.assert_array_equal(outs[r][6][1].numpy(), jres[r])
        assert torch.equal(outs[r][6][0], outs[0][6][0])
        np.testing.assert_allclose(outs[r][6][0].numpy(), jout[r],
                                   atol=2 * int8_atol(x, n))
        # the windowed carve feeds back the same phase-1 error
        np.testing.assert_array_equal(outs[r][8][1].numpy(), jres[r])


def test_ef8_masked_rows_keep_their_residual(ranks):
    """A masked row sends zeros and keeps its residual bitwise; a valid
    row feeds back what the unmasked round does (scales are per row, so
    rows do not interact)."""
    n, outs, _, _ = ranks
    x, res, m = stacked(n, n), residual_input(n), masks(n)
    want_sum = (x * m[:, :, None]).sum(0)
    for r in range(n):
        got_res = outs[r][7][1].numpy()
        np.testing.assert_array_equal(got_res[m[r] == 0], res[r][m[r] == 0])
        np.testing.assert_array_equal(got_res[m[r] == 1],
                                      outs[r][6][1].numpy()[m[r] == 1])
        assert torch.equal(outs[r][7][0], outs[0][7][0])
        np.testing.assert_allclose(outs[r][7][0].numpy(), want_sum,
                                   atol=int8_atol(x, n))


def test_ef8_residual2_within_one_block_quantum_of_jax(ranks):
    n, outs, _, _ = ranks
    if n & (n - 1):
        return
    x, res = stacked(n, n), residual_input(n)
    rows2 = jc.ef8_phase2_rows(ROWS, n)
    res2 = stacked(n, 51, rows=rows2, scale=1e-3)
    jout, jres, jres2 = jax_run(lambda b, r, r2: jc.ef8_two_phase_allreduce(
        b, jax.random.key(5), "dp", residual=r, block_elems=128,
        residual2=r2), n, x, res, res2)
    quantum = n * np.abs(x).max() / 127 * 1.01
    for r in range(n):
        out, new_res, new_res2 = outs[r][12]
        np.testing.assert_array_equal(new_res.numpy(), jres[r])
        assert np.abs(out.numpy() - jout[r]).max() <= quantum
        assert np.abs(new_res2.numpy() - jres2[r]).max() <= quantum
        assert torch.equal(out, outs[0][12][0])


def test_ef8_swing_identical_across_ranks(ranks):
    n, outs, _, _ = ranks
    if n & (n - 1):
        return
    x = stacked(n, n)
    for r in range(n):
        assert torch.equal(outs[r][11][0], outs[0][11][0])
        assert outs[r][11][1].shape == (ROWS, COLS)
    np.testing.assert_allclose(outs[0][11][0].numpy(), x.sum(0),
                               atol=int8_atol(x, n))


def test_ef8_error_feedback_telescopes(ranks):
    """The mean of T rounds' outputs converges on the exact sum: what the
    wire delivered telescopes to T sums plus one terminal residual."""
    n, outs, _, tele = ranks
    exact = stacked(n, n).sum(0)
    rounds = np.stack([outs[0][tele + t][0].numpy() for t in range(ROUNDS)])
    single = np.abs(rounds[0] - exact).mean()
    assert np.abs(rounds.mean(0) - exact).mean() < single / 2
    assert any(outs[r][tele + ROUNDS - 1][1].abs().max() > 0
               for r in range(n))


def test_exact_allreduce_driver():
    x = torch.from_numpy(stacked(2, 9, rows=2, cols=5))
    out = tc.exact_allreduce(x, two_phase=True, device="cpu")
    assert out.shape == x.shape
    for r in range(2):
        assert torch.equal(out[r], out[0])
    torch.testing.assert_close(out[0], x.sum(0), rtol=1e-6, atol=1e-6)


def test_exact_allreduce_runs_on_cuda_unless_asked(monkeypatch):
    """The driver is an entry point: without CUDA its default raises and
    names the CPU option; it never carries on there silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.exact_allreduce(torch.zeros(2, 3))


def test_keys_fold_split_and_seed():
    key = (17, 3)
    assert tc.fold_in(key, 2) == (17, 3, 2)
    k1, k2 = tc.split(key)
    assert len({k1, k2, tc.fold_in(key, 0)}) == 3
    assert tc.key_seed(key) == tc.key_seed((17, 3))
    assert tc.key_seed(k1) != tc.key_seed(k2)
    assert 0 <= tc.key_seed(key) < 2 ** 64
    a = tc.wire_bits((3, 4), key, "cpu")
    assert a.dtype == torch.int32 and torch.equal(a, tc.wire_bits(
        (3, 4), key, "cpu"))


def test_hierarchical_refuses_what_jax_refuses():
    """A non-2-D input and a residual of another shape are refused, as
    the JAX function refuses them (the working path: the hierarchical
    tests, ``tests/test_torch_hierarchical.py``)."""
    group = RankGroup.single()
    with pytest.raises(ValueError, match="num_buckets, bucket_elems"):
        tc.hierarchical_allreduce(torch.zeros(3, 2, 8), (0,), group)
    with pytest.raises(ValueError, match="full bucket shape"):
        tc.hierarchical_allreduce(torch.zeros(2, 8), (0,), group,
                                  residual=torch.zeros(2, 9))
    # a group of one: the ef8 two-phase over a DCN of one, the mask kept
    out, res = tc.hierarchical_allreduce(
        torch.ones(2, 8), (0,), group, residual=torch.full((2, 8), 0.5),
        valid=torch.tensor([1, 0]))
    assert out[0].eq(1).all() and not out[1].any()
    assert res.eq(0.5).all()
