"""The port's hierarchical (ICI x DCN) allreduce against the JAX package's.

The cases of ``tests/test_hierarchical_allreduce.py``, with the port's
ranks as gloo processes on the CPU (one spawn per mesh, every case of
the mesh in one ``run_calls`` list) and JAX on the conftest's 8-device
CPU mesh, the same numpy inputs on both, rank ``dp_i * ici + j`` on
each. DCN is the ``dp`` axis, ICI the ``sp`` axis (JAX: ``ep``). Pins:

* the new residual bitwise JAX's at (dcn, ici) = (2, 2): the RTN leg is
  a pure function and a two-way sum does not depend on its order; at
  (2, 4) within one block quantum (the ICI sums add in another order);
* the output within 2 x the ef8 parity tests' envelope of JAX's, and
  within one envelope (3 * 2/127 * N * max|x|) of the exact sum;
* every rank's output bitwise the same; reproducible; only the owned
  columns' residual updated; the telescoping of error feedback;
* the degenerate groups: |ici| = 1 is the flat ef8 (bitwise), |dcn| = 1
  the exact two-phase over ICI with the residual unchanged;
* DCN dropout (masked rows zero, residual kept) and mid-run recovery;
* ``RankGroup.along``: the two-phase and the swing sum over a rank's dp
  or sp line equal to the sum of that line's inputs;
* ``allreduce_gradients``: the hierarchical schedule within the
  envelope, a shrunk mesh running fused, the wrong wire refused.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.ops import collectives as jc
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch.ops import collectives as tc
from akka_allreduce_tpu_torch.parallel import dp as tdp
from akka_allreduce_tpu_torch.parallel.group import (PerRank, RankGroup, Ref,
                                                     run_calls, spawn_ranks)

C = "akka_allreduce_tpu_torch.ops.collectives:"
AG = "akka_allreduce_tpu_torch.parallel.dp:allreduce_gradients"
ROWS, COLS, BLOCK = 5, 301, 128  # no ici size divides COLS: the shard pads
TELE = 8   # telescoping rounds
DROP = 6   # dropout chain rounds, round 2 all masked
BUCKET = 256


def stacked(n, seed, rows=ROWS, cols=COLS, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, rows, cols)) * scale).astype(np.float32)


def line_masks(dcn, ici):
    """Masks that agree within each ICI line (the schedule's rule); row
    0 is masked on every rank."""
    return np.array([[int(b != 0 and (b + r // ici) % 3 != 0)
                      for b in range(ROWS)] for r in range(dcn * ici)],
                    np.float32)


def trees(n, seed=11):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(24, 40)).astype(np.float32),
             "b": rng.normal(size=(40,)).astype(np.float32)}
            for _ in range(n)]


def hier(x, key, **kw):
    return (C + "hierarchical_allreduce", [PerRank(list(x)), key],
            {"block_elems": BLOCK, **kw})


def calls_for(dcn, ici):
    n = dcn * ici
    x, res = stacked(n, n), stacked(n, 50, scale=1e-3)
    sentinel = np.full((n, ROWS, COLS), 7.25, np.float32)
    valid = line_masks(dcn, ici)
    calls = [
        hier(x, (3,), residual=PerRank(list(res))),                   # 0
        hier(x, (3,), residual=PerRank(list(res))),                   # 1
        hier(x, (3,), residual=PerRank(list(sentinel))),              # 2
        hier(x, (3,), residual=PerRank(list(res)),
             valid=PerRank(list(valid))),                             # 3
    ]
    zeros = PerRank(list(np.zeros_like(x)))
    tele = len(calls)
    for t in range(TELE):
        calls.append(hier(x, (200 + t,), residual=zeros if t == 0
                          else Ref(tele + 2 * (t - 1), 1)))
        calls.append(hier(x, (200 + t,), residual=zeros))
    drop = len(calls)
    ones, none = np.ones(ROWS, np.float32), np.zeros(ROWS, np.float32)
    for t in range(DROP):
        calls.append(hier(x, (300 + t,), residual=zeros if t == 0
                          else Ref(drop + t - 1, 1),
                          valid=none if t == 2 else ones))
    cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, transport="ef8",
                             transport_schedule="hierarchical",
                             return_elem_counts=False, rescale_target=n)
    calls.append(("torch_hierarchical_ranks:line_sums",
                  [PerRank(list(x))], {}))
    calls.append((AG, [PerRank(trees(n))], {"config": cfg,
                                             "quant_key": (0,)}))
    return calls, tele, drop


@pytest.fixture(scope="module", params=[(2, 2), (2, 4)],
               ids=["dcn2-ici2", "dcn2-ici4"])
def mesh(request):
    dcn, ici = request.param
    calls, tele, drop = calls_for(dcn, ici)
    outs = spawn_ranks(run_calls, dcn * ici, "gloo", "cpu", calls, sp=ici)
    return dcn, ici, outs, tele, drop


def jax_hier(dcn, ici, x, res, valid=None):
    """JAX's hierarchical_allreduce on a (dp=dcn, ep=ici) mesh, rank r
    taking ``x[r]``, ``res[r]`` (and ``valid[r]``); stacked outputs."""
    mesh = make_device_mesh(MeshSpec(dp=dcn, ep=ici),
                            devices=jax.devices()[:dcn * ici])
    spec = P(("dp", "ep"))
    args = [x, res] + ([] if valid is None else [valid])

    @partial(jax.shard_map, mesh=mesh, in_specs=tuple(spec for _ in args),
             out_specs=(spec, spec), check_vma=False)
    def run(*a):
        out, r = jc.hierarchical_allreduce(
            a[0][0], jax.random.key(3), "dp", "ep", residual=a[1][0],
            valid=None if valid is None else a[2][0], block_elems=BLOCK)
        return out[None], r[None]

    out, r = run(*[jnp.asarray(v) for v in args])
    return np.asarray(out), np.asarray(r)


def envelope(x, n):
    return 3 * 2 / 127 * n * np.abs(x).max()


def owned(r, ici):
    cols = -(-COLS // ici)
    j = r % ici
    mask = np.zeros(COLS, bool)
    mask[j * cols:(j + 1) * cols] = True
    return mask


def test_residual_and_output_match_jax(mesh):
    dcn, ici, outs, _, _ = mesh
    n = dcn * ici
    x, res = stacked(n, n), stacked(n, 50, scale=1e-3)
    jout, jres = jax_hier(dcn, ici, x, res)
    quantum = (ici * np.abs(x).max() + np.abs(res).max()) / 127 * 1.01
    for r in range(n):
        out, new_res = outs[r][0]
        if ici == 2:
            np.testing.assert_array_equal(new_res.numpy(), jres[r])
        else:
            assert np.abs(new_res.numpy() - jres[r]).max() <= quantum
        np.testing.assert_allclose(out.numpy(), jout[r],
                                   atol=2 * envelope(x, n))
        assert torch.equal(out, outs[0][0][0])


def test_masked_residual_and_output_match_jax(mesh):
    dcn, ici, outs, _, _ = mesh
    n = dcn * ici
    x, res = stacked(n, n), stacked(n, 50, scale=1e-3)
    valid = line_masks(dcn, ici)
    jout, jres = jax_hier(dcn, ici, x, res, valid)
    quantum = (ici * np.abs(x).max() + np.abs(res).max()) / 127 * 1.01
    for r in range(n):
        out, new_res = outs[r][3]
        if ici == 2:
            np.testing.assert_array_equal(new_res.numpy(), jres[r])
        else:
            assert np.abs(new_res.numpy() - jres[r]).max() <= quantum
        np.testing.assert_allclose(out.numpy(), jout[r],
                                   atol=2 * envelope(x, n))


def test_close_to_exact_sum(mesh):
    dcn, ici, outs, _, _ = mesh
    n = dcn * ici
    x, res = stacked(n, n), stacked(n, 50, scale=1e-3)
    exact = x.sum(0)
    got = outs[0][0][0].numpy()
    assert np.abs(got - exact).max() <= envelope(x, n) + np.abs(res).sum(0
                                                                   ).max()
    assert not np.array_equal(got, exact)  # it did quantize


def test_bitwise_reproducible(mesh):
    _, _, outs, _, _ = mesh
    for o in outs:
        assert torch.equal(o[0][0], o[1][0]) and torch.equal(o[0][1],
                                                             o[1][1])


def test_residual_updates_only_owned_shard_columns(mesh):
    _, ici, outs, _, _ = mesh
    for r, o in enumerate(outs):
        new_res = o[2][1].numpy()
        cols = owned(r, ici)
        assert (new_res[:, ~cols] == 7.25).all()
        assert (new_res[:, cols] != 7.25).any()


def test_residual_telescopes(mesh):
    """The mean of T rounds' outputs converges on the exact sum faster
    than one round, and faster than the same rounds without feedback."""
    dcn, ici, outs, tele, _ = mesh
    exact = stacked(dcn * ici, dcn * ici).sum(0)
    with_ef = [outs[0][tele + 2 * t][0].numpy() for t in range(TELE)]
    without = [outs[0][tele + 2 * t + 1][0].numpy() for t in range(TELE)]
    one = np.abs(with_ef[0] - exact).mean()
    ef_err = np.abs(np.mean(with_ef, 0) - exact).mean()
    assert ef_err < one / 2, (ef_err, one)
    assert ef_err < np.abs(np.mean(without, 0) - exact).mean()


def test_masked_rows_contribute_zero_and_keep_residual(mesh):
    dcn, ici, outs, _, _ = mesh
    n = dcn * ici
    x, res = stacked(n, n), stacked(n, 50, scale=1e-3)
    valid = line_masks(dcn, ici)
    want = (x * valid[:, :, None]).sum(0)
    for r, o in enumerate(outs):
        out, new_res = o[3][0].numpy(), o[3][1].numpy()
        np.testing.assert_array_equal(out[0], np.zeros(COLS))  # all masked
        keep = valid[r] == 0
        np.testing.assert_array_equal(new_res[keep], res[r][keep])
        assert (new_res[~keep] != res[r][~keep]).any()
        np.testing.assert_allclose(out, want, atol=envelope(x, n))


def test_mid_run_dropout_recovers(mesh):
    dcn, ici, outs, _, drop = mesh
    exact = stacked(dcn * ici, dcn * ici).sum(0)
    kept = []
    for t in range(DROP):
        out = outs[0][drop + t][0].numpy()
        if t == 2:
            np.testing.assert_array_equal(out, np.zeros((ROWS, COLS)))
            # the dropped round carries every residual over unchanged
            for o in outs:
                assert torch.equal(o[drop + t][1], o[drop + t - 1][1])
        else:
            kept.append(out)
    one = np.abs(kept[0] - exact).mean()
    assert np.abs(np.mean(kept, 0) - exact).mean() < one


def test_collectives_run_unchanged_on_a_line_of_the_mesh(mesh):
    """``RankGroup.along``: the two-phase and the swing sum over a rank's
    dp line (ranks j, ici + j, ...) and its sp line (dp_i * ici + ...)
    are the sums of those ranks' inputs."""
    dcn, ici, outs, _, _ = mesh
    x = stacked(dcn * ici, dcn * ici)
    for r, o in enumerate(outs):
        i, j = divmod(r, ici)
        lines = {"dp": [k * ici + j for k in range(dcn)],
                 "sp": [i * ici + k for k in range(ici)]}
        for axis, members in lines.items():
            fused, swing, size, index = o[-2][axis]
            assert (size, index) == (len(members), members.index(r))
            want = x[members].sum(0)
            np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(swing.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
            # every rank of the line holds the same sum
            assert torch.equal(fused, outs[members[0]][-2][axis][0])


def test_allreduce_gradients_hierarchical_matches_the_exact_mean(mesh):
    dcn, ici, outs, _, _ = mesh
    n = dcn * ici
    ts = trees(n)
    for o in outs:
        res = o[-1]
        assert res.schedule == "hierarchical"
        assert res.residual.shape == (4, BUCKET) and res.residual.any()
        for k in ("w", "b"):
            exact = sum(t[k] for t in ts)  # rescale_target n: the sum
            got = res.grads[k].numpy()
            assert np.abs(got - exact).max() < envelope(
                np.stack([t[k] for t in ts]), n)
            assert torch.equal(res.grads[k], outs[0][-1].grads[k])


@pytest.fixture(scope="module")
def flat4():
    """Four ranks as one dp axis (sp 1): the degenerate groups and the
    shrunk mesh."""
    n = 4
    x, res = stacked(n, 7), stacked(n, 51, scale=1e-3)
    ef8 = (C + "ef8_two_phase_allreduce", [PerRank(list(x)), (5,)],
           {"residual": PerRank(list(res)), "block_elems": BLOCK})
    cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, transport="ef8",
                             transport_schedule="hierarchical",
                             return_elem_counts=False)
    calls = [
        hier(x, (5,), residual=PerRank(list(res))),                   # 0
        ef8,                                                          # 1
        # |dcn| = 1: the sp axis (size 1) as DCN, the dp axis as ICI
        hier(x, (5,), residual=PerRank(list(res)), dcn_axis="sp",
             ici_axis="dp"),                                          # 2
        (AG, [PerRank(trees(n))], {"config": cfg, "quant_key": (0,)}),  # 3
    ]
    return x, res, spawn_ranks(run_calls, n, "gloo", "cpu", calls)


def test_degenerate_ici_is_the_flat_ef8(flat4):
    _, _, outs = flat4
    for o in outs:
        assert torch.equal(o[0][0], o[1][0])
        assert torch.equal(o[0][1], o[1][1])


def test_degenerate_dcn_is_exact(flat4):
    x, res, outs = flat4
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[2][0].numpy(), x.sum(0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(o[2][1].numpy(), res[r])


def test_degraded_mesh_runs_fused(flat4):
    _, _, outs = flat4
    for o in outs:
        assert o[3].schedule == "fused"
        assert all(np.isfinite(v.numpy()).all() for v in o[3].grads.values())


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_wrong_wire_rejected(wire):
    cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, transport=wire,
                             transport_schedule="hierarchical")
    with pytest.raises(ValueError, match="hierarchical"):
        tdp.allreduce_gradients({"a": torch.ones(4)}, cfg, quant_key=(0,))


def test_refuses_what_jax_refuses():
    group = RankGroup.single()
    with pytest.raises(ValueError, match="num_buckets, bucket_elems"):
        tc.hierarchical_allreduce(torch.zeros(8), (0,), group)
    with pytest.raises(ValueError, match="residual shape"):
        tc.hierarchical_allreduce(torch.zeros(2, 8), (0,), group,
                                  residual=torch.zeros(2, 4))
