"""The int8 KV cache of the port against the JAX package.

* ``quantize_kv`` values and scales bitwise JAX's on the same inputs
  (abs-max / 127 floored at 1e-30, round half to even, clip to ±127);
  ``dequantize_kv`` likewise.
* The cache and pool layouts: int8 values, one f32 scale per (position,
  head), under a third of the float bytes; an unknown format refused.
* ``tests/test_generate.py::TestQuantizedKV``'s logit bound: decode the
  same token stream against both formats; prefill logits equal, every
  decode step's logits within 0.1 and within 0.1 of the logit scale —
  for ``decode_step`` and for the slot and paged engines' steps.
* int8 ``generate`` and the int8 slot and paged engines agree with the
  JAX package's int8 paths under the decode-parity rule
  (``parity.greedy_agree``, the JAX int8 logits as the reference), and
  the paged kernel path refuses an int8 pool, as JAX's ``"pallas"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_allreduce_tpu.serving as jserve
import akka_allreduce_tpu_torch.serving as tserve
from akka_allreduce_tpu.models import generate as jgen
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import generate as tgen
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.parity import greedy_agree
from akka_allreduce_tpu_torch.serving.engine import (_paged_decode_step,
                                                     _slot_decode_step)

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=32, rope=True)


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ttf.TransformerConfig(**MODEL), tparams


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise_jax(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, 5, 2, 16)) * rng.uniform(0.01, 20, (3, 5, 2, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector: the 1e-30 floor
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 127.0]  # ties to even at scale 1
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = convert.params_from_jax(np.asarray(jx))
    jq, js = jgen.quantize_kv(jx)
    tq, ts = tgen.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (ts.numpy() == np.asarray(js)).all()
    back = tgen.dequantize_kv(tq, ts, torch.float32).numpy()
    assert (back == np.asarray(jgen.dequantize_kv(jq, js,
                                                  jnp.float32))).all()


def test_cache_and_pool_layouts(weights):
    _, _, tcfg, _ = weights
    cf = tgen.init_kv_cache(tcfg, 2)
    cq = tgen.init_kv_cache(tcfg, 2, kv_dtype="int8")
    assert cq["k"].dtype == torch.int8
    assert cq["k_scale"].shape == cq["k"].shape[:-1]
    size = lambda c: sum(c[n].numel() * c[n].element_size()  # noqa: E731
                         for n in ("k", "v", "k_scale", "v_scale") if n in c)
    assert size(cq) < size(cf) / 3
    pool = tgen.init_kv_pool(tcfg, 5, 4, kv_dtype="int8")
    assert pool["v_scale"].shape == (2, 5, 4, 2)
    with pytest.raises(ValueError, match="kv_dtype"):
        tgen.init_kv_cache(tcfg, 1, kv_dtype="int4")


def test_decode_step_logit_bound_vs_float_cache(weights):
    """The JAX test's bound: prefill logits equal (prompt attention reads
    the fresh block K/V), each decode step within 0.1 and 0.1 x scale."""
    _, _, tcfg, tparams = weights
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, 97, (2, 6)))
    cf, lf = tgen.prefill(tparams, tgen.init_kv_cache(tcfg, 2), toks, tcfg)
    cq, lq = tgen.prefill(tparams, tgen.init_kv_cache(tcfg, 2,
                                                      kv_dtype="int8"),
                          toks, tcfg)
    assert torch.equal(lf, lq)
    worst = 0.0
    tok = lf.argmax(-1).to(torch.int32)
    for _ in range(8):
        cf, lf = tgen.decode_step(tparams, cf, tok, tcfg)
        cq, lq = tgen.decode_step(tparams, cq, tok, tcfg)
        worst = max(worst, float((lf - lq).abs().max()))
        tok = lf.argmax(-1).to(torch.int32)
    assert 0.0 < worst < 0.1
    assert worst < 0.1 * float(lf.abs().max())


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_engine_steps_logit_bound(weights, paged):
    """The engines' int8 steps against their float twins on one token
    stream, 3 lanes at different positions: the same bound."""
    _, _, tcfg, tparams = weights
    kw = dict(num_slots=3)
    mk = (lambda dt: tserve.PagedServingEngine(
        tparams, tcfg, tserve.PagedEngineConfig(page_size=4, kv_dtype=dt,
                                                **kw))) if paged else (
        lambda dt: tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
            kv_dtype=dt, **kw)))
    engines = [mk(None), mk("int8")]
    for e in engines:
        for rid, n in enumerate((3, 5, 7)):
            e.admit(tserve.Request(rid=rid, prompt=tuple(range(1, n + 1)),
                                   max_new_tokens=10))
    assert torch.equal(engines[0]._state["logits"],
                       engines[1]._state["logits"])
    worst = 0.0
    pos = torch.tensor([3, 5, 7])
    tok = engines[0]._state["logits"].argmax(-1).to(torch.int32)
    for _ in range(6):
        outs = []
        for e in engines:
            kv = {n: t for n, t in e._state.items() if n != "logits"}
            if paged:
                _, lg = _paged_decode_step(tparams, kv, tok, pos,
                                           e._page_table_device(), tcfg,
                                           "gather")
            else:
                _, lg = _slot_decode_step(tparams, kv, tok, pos, tcfg)
            outs.append(lg)
        worst = max(worst, float((outs[0] - outs[1]).abs().max()))
        tok = outs[0].argmax(-1).to(torch.int32)
        pos = pos + 1
    assert 0.0 < worst < 0.1
    assert worst < 0.1 * float(outs[0].abs().max())
    assert engines[1].kv_cache_bytes() < engines[0].kv_cache_bytes() / 3


def jax_int8_logits(jparams, jcfg, prompt, toks) -> np.ndarray:
    """JAX's int8 decode logits along its own stream."""
    cache = jgen.init_kv_cache(jcfg, 1, kv_dtype="int8")
    cache, lg = jgen.prefill(jparams, cache, jnp.asarray([prompt]), jcfg)
    out = [np.asarray(lg[0])]
    for t in toks[:-1]:
        cache, lg = jgen.decode_step(jparams, cache,
                                     jnp.asarray([t], jnp.int32), jcfg)
        out.append(np.asarray(lg[0]))
    return np.stack(out)


def test_generate_int8_matches_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    prompt = [5, 17, 2, 40, 33]
    want = np.asarray(jgen.generate(jparams, jnp.asarray([prompt]), jcfg,
                                    steps=12, kv_dtype="int8"))[0]
    got = tgen.generate(tparams, torch.tensor([prompt]), tcfg, steps=12,
                        kv_dtype="int8")[0].tolist()
    ok, why = greedy_agree(want, got, jax_int8_logits(jparams, jcfg,
                                                      prompt, want))
    assert ok, why


def make_requests(mod, n=7, steps=7):
    rng = np.random.default_rng(5)
    return [mod.Request(rid=rid, prompt=tuple(int(x) for x in rng.integers(
        0, MODEL["vocab_size"], size=(3, 5)[rid % 2])),
        max_new_tokens=steps, submitted_at=0.0) for rid in range(n)]


def run(mod, engine, reqs) -> dict:
    sched = mod.RequestScheduler(mod.SchedulerConfig(),
                                 num_slots=engine.num_slots)
    for r in reqs:
        sched.submit(r)
    return mod.serve_loop(engine, sched, max_dispatches=400)


@pytest.mark.parametrize("steps", [1, 4])
def test_int8_engines_match_jax(weights, steps):
    jcfg, jparams, tcfg, tparams = weights
    want = run(jserve, jserve.ServingEngine(jparams, jcfg, jserve.EngineConfig(
        num_slots=3, kv_dtype="int8", decode_steps=steps)),
        make_requests(jserve))
    engines = {
        "slot": tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
            num_slots=3, kv_dtype="int8", decode_steps=steps)),
        "paged": tserve.PagedServingEngine(
            tparams, tcfg, tserve.PagedEngineConfig(
                num_slots=3, kv_dtype="int8", decode_steps=steps,
                page_size=4))}
    for name, engine in engines.items():
        got = run(tserve, engine, make_requests(tserve))
        for r in make_requests(tserve):
            ref = want[r.rid][0]
            ok, why = greedy_agree(ref, got[r.rid][0], jax_int8_logits(
                jparams, jcfg, r.prompt, ref))
            assert ok, f"{name} rid {r.rid}: {why}"
    assert engines["paged"].pool.pages_in_use == 0


def test_kernel_path_refuses_an_int8_pool():
    with pytest.raises(ValueError, match="float pools only"):
        tserve.PagedEngineConfig(kv_dtype="int8", attention_impl="kernel")
    tserve.PagedEngineConfig(kv_dtype="int8", attention_impl="gather")
