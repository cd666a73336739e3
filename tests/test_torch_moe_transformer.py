"""The MoE transformer and its decode paths against the JAX package's.

A model whose every second layer is MoE (4 experts, top-2, the JAX
weights carried over by ``convert.params_from_jax``): the port's
``next_token_loss_and_aux`` gives JAX's loss, aux loss and dispatch
fraction and the gradients of the mean loss within 1e-5 (f32), with
capacity that binds (tokens dropped) and that does not; in bf16 the
logits agree within 3e-2 (bf16 products, as the flash tolerances).

Decoding routes exactly the tensors the JAX functions route, each call's
capacity from its own token count: greedy ``generate`` and the port's
slot, paged-gather and paged-kernel engines (the kernel engine takes its
plain version on CPU tensors) emit JAX's greedy tokens (the JAX
``generate`` and ``ServingEngine`` on the same weights) under the
decode-parity rule (``parity.greedy_agree``, top-2 gap > 1e-3), and the
speculative engine on the MoE target emits the plain engine's tokens at
a capacity that cannot bind (reference fault C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_allreduce_tpu.serving as jserve
from akka_allreduce_tpu.models import generate as jgen
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
import akka_allreduce_tpu_torch.serving as tserve
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import generate as tgen
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.parallel.ep import MoEConfig as TMoE
from akka_allreduce_tpu_torch.parity import greedy_agree

torch.backends.cuda.matmul.allow_tf32 = False

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=32, rope=True, moe_every=2)
# capacity factor E / k: a capacity of N slots an expert never binds
WIDE = dict(n_experts=4, d_ff=128, capacity_factor=2.0, router_k=2)
LANES, PAGE = 3, 4


def configs(moe: dict, dtype="float32"):
    jcfg = jtf.TransformerConfig(**MODEL, moe=JMoE(**moe),
                                 dtype=getattr(jnp, dtype))
    tcfg = ttf.TransformerConfig(**MODEL, moe=TMoE(**moe),
                                 dtype=getattr(torch, dtype))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def wide():
    jcfg, tcfg = configs(WIDE)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    return jcfg, jparams, tcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_loss_aux_and_grads_match_jax(cf):
    moe = dict(WIDE, capacity_factor=cf, aux_loss_coef=1e-2)
    jcfg, tcfg = configs(moe)
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    tokens = np.random.default_rng(1).integers(0, 97, size=(2, 24),
                                               dtype=np.int32)

    def mean_loss(p):
        ls, w, aux = jtf.next_token_loss_and_aux(p, jnp.asarray(tokens),
                                                 jcfg)
        return ls / w, aux

    (loss, aux), grads = jax.jit(jax.value_and_grad(
        mean_loss, has_aux=True))(jparams)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ls, w, taux = ttf.next_token_loss_and_aux(params,
                                              torch.from_numpy(tokens), tcfg)
    tloss = ls / w
    got = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(taux["aux_loss"]),
                               float(aux["aux_loss"]), rtol=1e-5)
    assert float(taux["dispatch_fraction"]) == \
        float(aux["dispatch_fraction"])
    assert (float(aux["dispatch_fraction"]) < 1.0) == (cf < 1.0)
    for g, want in zip(got, jax.tree.leaves(grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_moe_bf16_logits_match_jax():
    jcfg, tcfg = configs(WIDE, "bfloat16")
    jparams = jtf.init_transformer(jax.random.key(2), jcfg)
    tokens = np.random.default_rng(2).integers(0, 97, size=(2, 16),
                                               dtype=np.int32)
    want = jax.jit(lambda p, t: jtf.transformer_apply(p, t, jcfg))(
        jparams, jnp.asarray(tokens))
    got = ttf.transformer_apply(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams)), torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def path_logits(jparams, jcfg, prompt, toks) -> np.ndarray:
    """JAX's logits along its own token path (one causal forward over the
    sequence padded to max_seq; capacity cannot bind at WIDE)."""
    seq = np.zeros((1, jcfg.max_seq), np.int32)
    full = list(prompt) + list(toks[:-1])
    seq[0, :len(full)] = full
    logits = jtf.transformer_apply(jparams, jnp.asarray(seq), jcfg)[0]
    return np.asarray(logits)[len(prompt) - 1:len(full)]


def test_moe_generate_matches_jax(wide):
    jcfg, jparams, tcfg, tparams = wide
    prompt = np.random.default_rng(3).integers(0, 97, size=(1, 5),
                                               dtype=np.int32)
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                                    steps=10))[0]
    got = tgen.generate(tparams, torch.from_numpy(prompt), tcfg,
                        steps=10)[0].numpy()
    ok, why = greedy_agree(want, got, path_logits(jparams, jcfg,
                                                  prompt[0], want))
    assert ok, why


def make_requests(mod, n: int, steps: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [mod.Request(
        rid=rid, prompt=tuple(int(x) for x in rng.integers(
            0, MODEL["vocab_size"], size=(3, 5)[rid % 2])),
        max_new_tokens=steps, submitted_at=0.0) for rid in range(n)]


def run(mod, engine, reqs) -> dict:
    sched = mod.RequestScheduler(
        mod.SchedulerConfig(max_queue_depth=len(reqs)),
        num_slots=engine.num_slots)
    for r in reqs:
        sched.submit(r)
    return mod.serve_loop(engine, sched, max_dispatches=500)


def test_moe_engines_match_jax(wide):
    jcfg, jparams, tcfg, tparams = wide
    want = run(jserve, jserve.ServingEngine(
        jparams, jcfg, jserve.EngineConfig(num_slots=LANES)),
        make_requests(jserve, 6, 6, seed=4))
    engines = {
        "slot": tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
            num_slots=LANES)),
        **{f"paged_{impl}": tserve.PagedServingEngine(
            tparams, tcfg, tserve.PagedEngineConfig(
                num_slots=LANES, page_size=PAGE, attention_impl=impl))
           for impl in ("gather", "kernel")},
        # the target's first layer (dense) drafts for the MoE target
        "speculative": tserve.SpeculativeEngine(
            tparams, tcfg, {**tparams, "layers": tparams["layers"][:1]},
            ttf.TransformerConfig(**{**MODEL, "n_layers": 1},
                                  moe=TMoE(**WIDE)),
            tserve.EngineConfig(num_slots=LANES, draft_steps=3)),
    }
    for name, engine in engines.items():
        got = run(tserve, engine, make_requests(tserve, 6, 6, seed=4))
        assert got.keys() == want.keys(), name
        for rid, (ref_toks, _) in want.items():
            req = make_requests(tserve, 6, 6, seed=4)[rid]
            ok, why = greedy_agree(ref_toks, got[rid][0], path_logits(
                jparams, jcfg, req.prompt, ref_toks))
            assert ok, f"{name} rid {rid}: {why}"
