"""The port's MoE layer (``parallel/ep.py``) against the JAX package's.

The routing math is held bitwise: ``_top_k_assign``'s expert indices,
slots, keep mask, gates, kept fraction and route fractions equal JAX's
on the same f32 probabilities (from f32 and from bf16 logits), and the
capacity formula gives JAX's integers. ``moe_ffn`` on the einsum and the
scatter dispatch, with capacity that binds and that does not, gives
JAX's outputs, aux loss and dispatch fraction and the gradients of
``sum(y * y)`` within 2e-5 (f32; the float sums differ in order only).
The JAX tests' routing cases (``tests/test_ep.py``) hold on the port:
generous capacity keeps everything, no (expert, slot) collides, in bf16
too, capacity one keeps one token, k = 1 gates with the router
probability. Over two gloo ranks on the ep axis the layer equals the
all-local one (outputs and gradients within 2e-5, dispatch fraction 1),
and a control that permutes one rank's all_to_all blocks lands outside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.parallel import ep as jep
from akka_allreduce_tpu_torch.parallel import ep as tep
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

from torch_moe_ranks import moe_ep_cases

D = 16
TOL = dict(rtol=2e-5, atol=2e-5)


def make_x(b, t, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, D)).astype(
        np.float32)


def jax_params(cfg_kw, seed=0):
    p = jep.init_moe_layer(jax.random.key(seed), D, jep.MoEConfig(**cfg_kw))
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("cf,k,n,e", [(1.25, 2, 64, 8), (1.0, 1, 8, 64),
                                      (0.3, 2, 7, 3), (4.0, 1, 1, 8)])
def test_capacity_is_jaxs(cf, k, n, e):
    kw = dict(n_experts=e, capacity_factor=cf, router_k=k)
    assert tep.expert_capacity(tep.MoEConfig(**kw), n) == \
        jep.expert_capacity(jep.MoEConfig(**kw), n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,capacity", [(1, 5), (2, 9), (2, 64), (3, 4)])
def test_top_k_assign_is_bitwise_jaxs(dtype, k, capacity):
    logits = np.random.default_rng(k + capacity).normal(
        size=(48, 8)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits).astype(dtype).astype(
        jnp.float32), axis=-1)
    want = jep._top_k_assign(probs, k, capacity)
    got = tep._top_k_assign(torch.from_numpy(np.asarray(probs)), k,
                            capacity)
    for name, w, g in zip(("expert_idx", "slot", "keep", "gate_k", "kept",
                           "route_frac"), want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name
        assert g.dtype == (torch.int32 if name in ("expert_idx", "slot")
                           else torch.float32), name


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("cf,k", [(4.0, 2), (0.5, 2), (1.0, 1)])
def test_moe_ffn_matches_jax(dispatch, cf, k):
    kw = dict(n_experts=8, d_ff=32, capacity_factor=cf, router_k=k,
              dispatch=dispatch)
    params = jax_params(kw)
    x = make_x(2, 16, seed=3)
    jcfg = jep.MoEConfig(**kw)

    def f(p, xx):
        y, aux = jep.moe_ffn(xx, p, jcfg, axis_name=None)
        return jnp.sum(y ** 2) + aux["aux_loss"], (y, aux)

    (_, (yj, auxj)), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    p = {n: torch.from_numpy(v.copy()).requires_grad_(True)
         for n, v in params.items()}
    y, aux = tep.moe_ffn(torch.from_numpy(x), p, tep.MoEConfig(**kw))
    ((y ** 2).sum() + aux["aux_loss"]).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **TOL)
    assert float(aux["dispatch_fraction"]) == \
        float(auxj["dispatch_fraction"])
    if cf < 1.0:
        assert float(aux["dispatch_fraction"]) < 1.0  # drops happened
    np.testing.assert_allclose(float(aux["aux_loss"].detach()),
                               float(auxj["aux_loss"]), rtol=1e-6)
    for name in params:
        np.testing.assert_allclose(p[name].grad.numpy(),
                                   np.asarray(gj[name]), **TOL,
                                   err_msg=name)


def test_everything_kept_under_generous_capacity():
    probs = torch.softmax(torch.from_numpy(
        np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32)),
        dim=-1)
    dispatch, combine, kept, _ = tep._top_k_dispatch(probs, 2, 16)
    assert float(kept) == 1.0
    np.testing.assert_allclose(dispatch.sum((1, 2)).numpy(), 2.0)
    np.testing.assert_allclose(combine.sum((1, 2)).numpy(), 1.0, rtol=1e-5)


def test_no_slot_collisions_in_bf16():
    n = 1024
    probs = torch.tensor([[0.9, 0.1]], dtype=torch.bfloat16).repeat(n, 1)
    dispatch, _, kept, _ = tep._top_k_dispatch(probs, 1, n)
    assert dispatch.dtype == torch.bfloat16
    assert float(dispatch.float().sum(0).max()) == 1.0
    assert float(kept) == 1.0


def test_capacity_one_drops_all_but_first_and_dropped_rows_are_zero():
    probs = torch.tensor([[0.97, 0.01, 0.01, 0.01]]).repeat(8, 1)
    dispatch, _, kept, route_frac = tep._top_k_dispatch(probs, 1, 1)
    assert float(dispatch.sum()) == 1.0 and float(dispatch[0].sum()) == 1.0
    assert float(dispatch[1:].abs().sum()) == 0.0  # out-of-range slots
    assert float(kept) == pytest.approx(1 / 8)
    np.testing.assert_allclose(route_frac.numpy(), [1, 0, 0, 0])


def test_k1_gate_is_router_prob_and_argmax_takes_the_first_max():
    probs = torch.tensor([[0.4, 0.4, 0.2], [0.1, 0.45, 0.45]])
    idx, _, _, gate, _, _ = tep._top_k_assign(probs, 1, 2)
    assert idx[0].tolist() == [0, 1]
    np.testing.assert_allclose(gate[0].numpy(), [0.4, 0.45])


def test_unknown_dispatch_raises():
    cfg = tep.MoEConfig(dispatch="nope")
    p = tep.init_moe_layer(torch.Generator().manual_seed(0), D, cfg)
    with pytest.raises(ValueError, match="dispatch"):
        tep.moe_ffn(torch.zeros(1, 4, D), p, cfg)


def test_auto_threshold_selects_scatter(monkeypatch):
    kw = dict(n_experts=8, d_ff=32, capacity_factor=1.0, router_k=2)
    p = {n: torch.from_numpy(v) for n, v in jax_params(kw, 2).items()}
    x = torch.from_numpy(make_x(2, 16, seed=11))
    calls = []
    real = tep._top_k_dispatch
    monkeypatch.setattr(tep, "_top_k_dispatch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    small, _ = tep.moe_ffn(x, p, tep.MoEConfig(**kw))
    assert calls == [1]  # below the line: the einsum formulation
    monkeypatch.setattr(tep, "_EINSUM_DISPATCH_MAX", 1)
    big, _ = tep.moe_ffn(x, p, tep.MoEConfig(**kw))
    assert calls == [1]  # past it: scatter
    np.testing.assert_allclose(big.numpy(), small.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_ep2_equals_local_and_a_permuted_exchange_does_not():
    """Two gloo ranks on the ep axis, each with half the rows and half the
    experts, against JAX's all-local layer, on both dispatches; the fault
    control (rank 0's outgoing blocks swapped) must fall outside the same
    bound."""
    cases, refs = [], []
    for dispatch in ("einsum", "scatter"):
        kw = dict(n_experts=4, d_ff=32, capacity_factor=8.0, router_k=2,
                  dispatch=dispatch)
        params = jax_params(kw, 3)
        x = make_x(4, 4, seed=7)
        jcfg = jep.MoEConfig(**kw)

        def loss(p, xx=x, c=jcfg):
            y, _ = jep.moe_ffn(jnp.asarray(xx), p, c, axis_name=None)
            return jnp.sum(y * y), y

        refs.append(jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, params)))
        cases += [(kw, params, x, False), (kw, params, x, True)]
    ranks = spawn_ranks(moe_ep_cases, 2, "gloo", "cpu", cases, ep=2)
    for i, ((_, y_ref), g_ref) in enumerate(refs):
        good = [r[2 * i] for r in ranks]
        faulty = [r[2 * i + 1] for r in ranks]
        y = np.concatenate([r["y"].numpy() for r in good])
        np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)
        assert [r["kept"] for r in good] == [1.0, 1.0]
        np.testing.assert_allclose(good[0]["router"].numpy(),
                                   np.asarray(g_ref["router"]), rtol=1e-4,
                                   atol=1e-5)
        for name in ("we1", "we2"):
            got = np.concatenate([r[name].numpy() for r in good])
            np.testing.assert_allclose(got, np.asarray(g_ref[name]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        bad = np.concatenate([r["y"].numpy() for r in faulty])
        assert not np.allclose(bad, np.asarray(y_ref), **TOL)
