"""``parallel/pp.py`` against the JAX package's ``parallel/pp.py``.

The same numpy inputs, made from a seed, go through JAX's functions
under ``shard_map`` on ``jax.devices()[:s]`` (the cases of
``tests/test_pp.py`` and ``test_pp_1f1b.py`` with s <= 4) and through
the port's on s gloo ranks of a ``pp`` mesh: stacking, ``scan_blocks``,
``pp_schedule_stats`` (equal dicts), ``gpipe_apply``'s outputs, aux
(the fill and drain ticks masked) and gradients through its written-out
backward, and ``one_f_one_b``'s ``(loss_sum, d_stage, d_other)`` with
its ring's residency. All the cases of one world size share one spawn.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.parallel import pp as jpp
from akka_allreduce_tpu.parallel.mesh import make_device_mesh
from akka_allreduce_tpu_torch.parallel import pp
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

from torch_pp_ranks import mesh_cases

# (s, m) of the gpipe cases: test_pp.py's product cases with s <= 4, its
# gradient case (4, 3) and its aux case (4, 2)
GPIPE = [(4, 4), (2, 6), (4, 1), (4, 3), (4, 2)]
# (s, m) of the 1f1b cases: m below, at and above the ring's 2s - 1
ONE_F = [(2, 2), (2, 5), (4, 3), (4, 9)]
# test_pp.py's aux case: stage weights 2, microbatches of ones and tens
AUX_CASE = (np.full(4, 2.0, np.float32),
            np.stack([np.full((3,), 1.0, np.float32),
                      np.full((3,), 10.0, np.float32)]), 1.0)


def pp_mesh(s):
    return make_device_mesh(axis_names=("pp",), axis_sizes=(s,),
                            devices=jax.devices()[:s])


def gpipe_inputs(s, m):
    rng = np.random.default_rng(10 * s + m)
    return (rng.uniform(0.5, 1.5, size=s).astype(np.float32),
            rng.normal(size=(m, 3, 5)).astype(np.float32))


def jax_gpipe(s, w, x):
    """JAX's outputs (the last stage's), aux per rank, and the gradients
    of ``sum(out ** 2)`` for the weights and the input."""
    mesh = pp_mesh(s)

    def stage(p, h):
        return h * p[0], {"seen": h.sum()}

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("pp"), P()),
             out_specs=(P(), P("pp")), check_vma=False)
    def run(w_local, xm):
        out, aux = jpp.gpipe_apply(w_local, xm, stage, "pp")
        return (lax.psum(jpp.last_stage_only(out, "pp"), "pp"),
                aux["seen"][None])

    out, seen = run(jnp.asarray(w), jnp.asarray(x))

    def loss(ww, xx):
        return jnp.sum(run(ww, xx)[0] ** 2)

    dw, dx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    return (np.asarray(out), np.asarray(seen), np.asarray(dw),
            np.asarray(dx))


def one_f_inputs(s, m):
    rng = np.random.default_rng(100 + 10 * s + m)
    return (rng.uniform(0.5, 1.5, size=s).astype(np.float32),
            rng.normal(size=(7, 4)).astype(np.float32),
            rng.normal(size=(4,)).astype(np.float32),
            rng.integers(0, 7, size=(m, 3)).astype(np.int32),
            rng.normal(size=(m, 3, 4)).astype(np.float32))


def jax_one_f(s, w, table, head, tokens, targets):
    """JAX's ``one_f_one_b`` on the toy pipeline: each rank's loss_sum,
    d_stage and d_other."""
    mesh = pp_mesh(s)
    m = tokens.shape[0]
    tgt = jnp.asarray(targets)

    def head_fn(o, h, mb):
        t = lax.dynamic_index_in_dim(tgt, mb, 0, keepdims=False)
        return jnp.sum((h * o["head"] - t) ** 2) / m

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("pp"), P(), P()),
             out_specs=(P("pp"), P("pp"), P("pp")), check_vma=False)
    def run(w_local, other, toks):
        loss, d_st, d_oth = jpp.one_f_one_b(
            w_local, other, toks, lambda p, h: jnp.tanh(h * p[0]),
            lambda o, tok: o["table"][tok], head_fn, "pp")
        return (loss[None], d_st,
                jax.tree.map(lambda a: a[None], d_oth))

    loss, dw, d_other = run(jnp.asarray(w), {"head": jnp.asarray(head),
                                             "table": jnp.asarray(table)},
                            jnp.asarray(tokens))
    return (np.asarray(loss), np.asarray(dw),
            {k: np.asarray(v) for k, v in d_other.items()})


def test_stack_roundtrip_and_scan_blocks_match_jax():
    rng = np.random.default_rng(0)
    layers_np = [{"w": rng.normal(size=3).astype(np.float32),
                  "b": np.float32(rng.normal())} for _ in range(4)]
    ours = pp.stack_layer_params([{k: torch.tensor(v) for k, v in lyr.items()}
                                  for lyr in layers_np])
    theirs = jpp.stack_layer_params([{k: jnp.asarray(v)
                                      for k, v in lyr.items()}
                                     for lyr in layers_np])
    assert ours["w"].shape == (4, 3)
    for k in ("w", "b"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    for a, b in zip(pp.unstack_layer_params(ours, 4), layers_np):
        np.testing.assert_array_equal(a["w"].numpy(), b["w"])

    def block(lyr, h):
        return h * lyr["b"] + lyr["w"], {"s": h.sum()}

    x = rng.normal(size=3).astype(np.float32)
    out, aux = pp.scan_blocks(ours, torch.tensor(x), block)
    j_out, j_aux = jpp.scan_blocks(theirs, jnp.asarray(x), block)
    h = torch.tensor(x)
    want_s = 0.0
    for lyr in pp.unstack_layer_params(ours, 4):  # the plain loop
        want_s += float(h.sum())
        h = h * lyr["b"] + lyr["w"]
    np.testing.assert_allclose(out.numpy(), h.numpy(), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-6)
    assert float(aux["s"]) == pytest.approx(want_s, rel=1e-6)
    assert float(aux["s"]) == pytest.approx(float(j_aux["s"]), rel=1e-6)


def test_heterogeneous_layers_rejected_with_jax_message():
    layers = [{"w": torch.ones(3)}, {"w": torch.ones(3), "r": torch.ones(2)}]
    with pytest.raises(ValueError, match="homogeneous"):
        pp.stack_layer_params(layers)
    with pytest.raises(ValueError, match="homogeneous"):
        jpp.stack_layer_params([{"w": jnp.ones(3)},
                                {"w": jnp.ones(3), "r": jnp.ones(2)}])


@pytest.mark.parametrize("s,m", [(4, 8), (4, 64), (2, 2), (2, 1), (3, 5),
                                 (1, 4)])
def test_schedule_stats_equal_jax(s, m):
    assert pp.pp_schedule_stats(s, m) == jpp.pp_schedule_stats(s, m)


@pytest.fixture(scope="module")
def ranks4():
    """Every case at 4 ranks, one spawn: the gpipe cases with s = 4, then
    the 1f1b cases with s = 4."""
    cases = [("gpipe_unit", {"pp": 4}, (*gpipe_inputs(s, m), 1.0))
             for s, m in GPIPE if s == 4]
    cases += [("one_f_one_b_unit", {"pp": 4}, one_f_inputs(s, m))
              for s, m in ONE_F if s == 4]
    cases.append(("gpipe_unit", {"pp": 4}, AUX_CASE))
    return spawn_ranks(mesh_cases, 4, "gloo", "cpu", cases)


@pytest.fixture(scope="module")
def ranks2():
    cases = [("gpipe_unit", {"pp": 2}, (*gpipe_inputs(s, m), 1.0))
             for s, m in GPIPE if s == 2]
    cases += [("one_f_one_b_unit", {"pp": 2}, one_f_inputs(s, m))
              for s, m in ONE_F if s == 2]
    return spawn_ranks(mesh_cases, 2, "gloo", "cpu", cases)


def _case(ranks2, ranks4, s, kind, m):
    runs = ranks4 if s == 4 else ranks2
    cases = ([(k, mm) for k, mm in GPIPE if k == s]
             if kind == "gpipe" else [(k, mm) for k, mm in ONE_F if k == s])
    i = cases.index((s, m)) + (0 if kind == "gpipe" else
                               sum(1 for k, _ in GPIPE if k == s))
    return [r[i] for r in runs]


@pytest.mark.parametrize("s,m", GPIPE)
def test_gpipe_outputs_aux_and_grads_match_jax(ranks2, ranks4, s, m):
    got = _case(ranks2, ranks4, s, "gpipe", m)
    w, x = gpipe_inputs(s, m)
    out, seen, dw, dx = jax_gpipe(s, w, x)
    np.testing.assert_allclose(got[-1]["out"].numpy(), out, rtol=1e-6)
    assert all(r["out"] is None for r in got[:-1])
    # aux: each rank's mean over its m valid ticks, fill and drain masked
    # (a sum of ~15 values of either sign: f32 order, hence the atol)
    np.testing.assert_allclose([r["aux"]["seen"] for r in got], seen,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose([float(r["dw"][0]) for r in got], dw,
                               rtol=1e-5)
    np.testing.assert_allclose(got[0]["dx"].numpy(), dx, rtol=1e-5,
                               atol=1e-6)
    assert all(r["dx"] is None for r in got[1:])
    # one graph a valid tick (the JAX scan's m + s - 1 residuals include
    # the fill and drain ticks the port skips), all dropped by backward
    assert [r["peak_graphs"] for r in got] == [m] * s
    assert all(r["live_after"] == 0 for r in got)


def test_aux_masks_fill_and_drain_ticks(ranks4):
    """test_pp.py's aux case: rank i sees the microbatch sums scaled by
    2^i, averaged over its m = 2 valid ticks."""
    np.testing.assert_allclose([r[-1]["aux"]["seen"] for r in ranks4],
                               [16.5 * 2 ** i for i in range(4)], rtol=1e-6)


@pytest.mark.parametrize("s,m", ONE_F)
def test_one_f_one_b_matches_jax_and_holds_its_ring(ranks2, ranks4, s, m):
    got = _case(ranks2, ranks4, s, "1f1b", m)
    loss, dw, d_other = jax_one_f(s, *one_f_inputs(s, m))
    np.testing.assert_allclose([r["loss"] for r in got], loss, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose([float(r["dw"][0]) for r in got], dw,
                               rtol=1e-5)
    for k in ("head", "table"):
        np.testing.assert_allclose(
            np.stack([r[f"d_{k}"].numpy() for r in got]), d_other[k],
            rtol=1e-5, atol=1e-6, err_msg=k)
    ring = min(m, 2 * s - 1)
    for r in got:
        assert r["stats"]["ring_depth"] == ring
        assert r["stats"]["peak_inputs"] <= ring
        assert r["stats"]["peak_graphs"] == 1
    # rank 0 fills the ring: 2s - 1 inputs pending at once when m allows
    assert got[0]["stats"]["peak_inputs"] == ring
