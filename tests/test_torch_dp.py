"""``allreduce_gradients`` against the JAX package's, at N = 2 and 4.

One gradient tree (ragged leaves, so the last bucket pads) per rank goes
through every wire x schedule of the port (gloo ranks on the CPU, one
spawn per group size) and the same inputs through the JAX function on an
N-device CPU mesh (one traced program per group size). Pins: f32 allclose
to JAX at rtol 1e-6 on every schedule, windowed bitwise fused; bf16
inside its envelope; int8 and ef8 identical on every rank and inside the
JAX tests' envelope; masked rounds with per-bucket counts bitwise JAX's
and values allclose; the averaging and the per-element counts; the
refusals JAX keeps (the hierarchical schedule on another wire than ef8).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.parallel import dp as jdp
from akka_allreduce_tpu.parallel.mesh import single_axis_mesh
from akka_allreduce_tpu_torch.parallel import dp as tdp
from akka_allreduce_tpu_torch.parallel.group import (PerRank, RankGroup,
                                                     run_calls, spawn_ranks)

AG = "akka_allreduce_tpu_torch.parallel.dp:allreduce_gradients"
BUCKET = 64  # 3*50 + 70 = 220 elements -> 4 buckets, the last padded
SCHEDULES = ("fused", "windowed", "swing")
WIRES = ("f32", "bf16", "int8", "ef8")


def trees(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(3, 50)).astype(np.float32),
             "b": {"c": rng.normal(size=(70,)).astype(np.float32)}}
            for _ in range(n)]


def valid_masks(n):
    # bucket 0 arrives from no rank, the rest from some
    return np.array([[0] + [(r + b) % 2 for b in range(1, 4)]
                     for r in range(n)], np.int32)


def flat(tree):
    return np.concatenate([np.asarray(tree["a"]).reshape(-1),
                           np.asarray(tree["b"]["c"]).reshape(-1)])


def cases(n):
    """(name, config, masked) of every port case at group size n."""
    out = []
    for wire in WIRES:
        for sched in SCHEDULES:
            if sched == "swing" and n & (n - 1):
                continue
            cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, rescale_target=n,
                                     return_elem_counts=False,
                                     transport=wire,
                                     transport_schedule=sched)
            out.append((f"{wire}-{sched}", cfg, False))
    for wire, sched in (("f32", "fused"), ("f32", "windowed"),
                        ("bf16", "fused"), ("int8", "fused"),
                        ("ef8", "fused"), ("ef8", "swing")):
        cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, rescale_target=n,
                                 transport=wire, transport_schedule=sched)
        out.append((f"masked-{wire}-{sched}", cfg, True))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ranks(request):
    n = request.param
    ts, vm = trees(n), valid_masks(n)
    calls = [(AG, [PerRank(ts), cfg],
              {"valid": PerRank(list(vm)) if masked else None,
               "quant_key": (17, 1, 0)})
             for _, cfg, masked in cases(n)]
    outs = spawn_ranks(run_calls, n, "gloo", "cpu", calls)
    names = [name for name, _, _ in cases(n)]
    return n, {name: [o[i] for o in outs] for i, name in enumerate(names)}


@pytest.fixture(scope="module")
def jax_results(ranks):
    """The JAX function's f32 (every schedule) and masked f32 results on
    the same inputs, from one traced program."""
    n, _ = ranks
    ts, vm = trees(n), valid_masks(n)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *ts)
    scheds = [s for s in SCHEDULES if not (s == "swing" and n & (n - 1))]
    mesh = single_axis_mesh("dp", devices=jax.devices()[:n])

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("dp"), P("dp")),
             out_specs=P("dp"), check_vma=False)
    def run(tree, valid):
        tree = jax.tree.map(lambda x: x[0], tree)
        out = {}
        for s in scheds:
            cfg = jdp.GradSyncConfig(bucket_elems=BUCKET, rescale_target=n,
                                     return_elem_counts=False,
                                     transport_schedule=s)
            out[s] = jdp.allreduce_gradients(tree, cfg).grads
        res = jdp.allreduce_gradients(tree, jdp.GradSyncConfig(
            bucket_elems=BUCKET, rescale_target=n), valid=valid[0])
        out["masked"] = res.grads
        out["masked_counts"] = res.bucket_counts
        out["masked_elem_counts"] = res.counts
        return jax.tree.map(lambda x: x[None], out)

    return jax.tree.map(np.asarray, run(stacked, vm))


def exact_sum(n, masked=False):
    ts, vm = trees(n), valid_masks(n)
    total = np.zeros(220)
    abs_sum = np.zeros(220)
    for t, v in zip(ts, vm):
        f = flat(t).astype(np.float64)
        if masked:
            f = f * np.repeat(v, BUCKET)[:220]
        total += f
        abs_sum += np.abs(f)
    return total, abs_sum


def test_f32_every_schedule_matches_jax(ranks, jax_results):
    n, res = ranks
    for s in SCHEDULES:
        if f"f32-{s}" not in res:
            continue
        want = jax.tree.map(lambda x: x[0], jax_results[s])
        for r in range(n):
            got = res[f"f32-{s}"][r]
            assert got.transport == "f32" and got.schedule == s
            np.testing.assert_allclose(flat(got.grads), flat(want),
                                       rtol=1e-6, atol=1e-6)
            assert got.bucket_counts.tolist() == [n] * 4
    for r in range(n):
        assert np.array_equal(flat(res["f32-windowed"][r].grads),
                              flat(res["f32-fused"][r].grads))


def test_bf16_inside_its_envelope(ranks):
    n, res = ranks
    total, abs_sum = exact_sum(n)
    for s in SCHEDULES:
        if f"bf16-{s}" not in res:
            continue
        hops = (n.bit_length() - 1) if s == "swing" else 1
        for r in range(n):
            got = flat(res[f"bf16-{s}"][r].grads)
            assert got.dtype == np.float32
            assert np.all(np.abs(got - total) <= (1 + hops) * 2.0 ** -8
                          * abs_sum + 1e-7)
            assert np.array_equal(got, flat(res[f"bf16-{s}"][0].grads))


@pytest.mark.parametrize("wire", ["int8", "ef8"])
def test_quantized_wires_identical_and_inside_envelope(ranks, wire):
    n, res = ranks
    total, _ = exact_sum(n)
    atol = 3 * 2 / 127 * n * max(np.abs(flat(t)).max() for t in trees(n))
    for s in SCHEDULES:
        if f"{wire}-{s}" not in res:
            continue
        outs = [flat(res[f"{wire}-{s}"][r].grads) for r in range(n)]
        for o in outs:
            assert np.array_equal(o, outs[0])
        np.testing.assert_allclose(outs[0], total, atol=atol)
        assert not np.allclose(outs[0], total, rtol=0, atol=1e-7)
        resid = res[f"{wire}-{s}"][0].residual
        assert (resid is None) == (wire == "int8")
        if resid is not None:
            assert tuple(resid.shape) == (4, BUCKET)


def test_masked_counts_are_bitwise_jax(ranks, jax_results):
    n, res = ranks
    want_counts = jax_results["masked_counts"][0]
    want = jax.tree.map(lambda x: x[0], jax_results["masked"])
    for name, got in res.items():
        if not name.startswith("masked-"):
            continue
        for r in range(n):
            np.testing.assert_array_equal(got[r].bucket_counts.numpy(),
                                          want_counts)
            assert got[r].bucket_counts.dtype == torch.int32
    assert want_counts[0] == 0
    for r in range(n):
        got = res["masked-f32-fused"][r]
        np.testing.assert_allclose(flat(got.grads), flat(want), rtol=1e-6,
                                   atol=1e-6)
        elem = got.counts
        np.testing.assert_array_equal(
            flat(elem), flat(jax.tree.map(lambda x: x[0],
                                          jax_results["masked_elem_counts"])))
        assert np.array_equal(flat(res["masked-f32-windowed"][r].grads),
                              flat(got.grads))
    # a bucket nobody contributed averages to zeros on every wire
    for name in ("masked-bf16-fused", "masked-int8-fused",
                 "masked-ef8-fused"):
        assert not flat(res[name][0].grads)[:BUCKET].any()


def test_group_of_one_bypasses_the_wire_but_masks():
    tree = {"a": torch.ones(3, 50), "b": {"c": torch.full((70,), 2.0)}}
    valid = torch.tensor([1, 0, 1, 1])
    for wire in WIRES:
        cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, transport=wire)
        out = tdp.allreduce_gradients(tree, cfg, RankGroup.single(),
                                      quant_key=(1,))
        assert torch.equal(out.grads["a"], tree["a"])
        masked = tdp.allreduce_gradients(tree, cfg, valid=valid,
                                         quant_key=(1,))
        f = flat(masked.grads)
        assert not f[BUCKET:2 * BUCKET].any() and f[0] == 1.0
        assert masked.bucket_counts.tolist() == [1, 0, 1, 1]
        if wire == "ef8":
            assert not out.residual.any()


@pytest.mark.parametrize("kw,err,match", [
    (dict(transport_schedule="hierarchical"), ValueError, "IS the ef8"),
    (dict(transport_schedule="hierarchical", transport="int8"), ValueError,
     "transport='ef8'"),
    (dict(transport_schedule="ring"), ValueError, "transport_schedule"),
    (dict(transport="fp8"), ValueError, "transport"),
    (dict(transport="int8"), ValueError, "quant_key"),
])
def test_refusals(kw, err, match):
    cfg = tdp.GradSyncConfig(bucket_elems=BUCKET, **kw)
    with pytest.raises(err, match=match):
        tdp.allreduce_gradients({"a": torch.ones(4)}, cfg)


def test_auto_and_hierarchical_on_a_group_of_one():
    """``auto`` with no plan takes the hand-flag default and reports it;
    ``hierarchical`` on fewer than two live axes runs the fused ef8 (as
    the JAX sync degrades a shrunk mesh) and reports ``fused``."""
    tree = {"a": torch.arange(200, dtype=torch.float32)}
    auto = tdp.allreduce_gradients(
        tree, tdp.GradSyncConfig(bucket_elems=BUCKET,
                                 transport_schedule="auto"))
    assert auto.schedule == "fused" and torch.equal(auto.grads["a"],
                                                    tree["a"])
    hier = tdp.allreduce_gradients(
        tree, tdp.GradSyncConfig(bucket_elems=BUCKET, transport="ef8",
                                 transport_schedule="hierarchical"),
        quant_key=(1,))
    assert hier.schedule == "fused" and not hier.residual.any()


@pytest.mark.parametrize("rows,windows,want", [
    (4, 4, 4), (5, 4, 3), (7, 4, 4), (1, 4, 1), (9, 2, 2)])
def test_window_count_matches_jax_rule(rows, windows, want):
    """parallel/dp.py's degrade rule: never pad a window's worth of zero
    rows (the JAX windowed_sum's loop, restated)."""
    assert tdp.window_count(rows, windows) == want
    jnp.zeros(1)  # the JAX module is imported beside the port
