"""The port's serving engines against the JAX package's, under churn.

One closed load (more requests than lanes, some with an EOS) goes
through the JAX package's ``ServingEngine`` and ``PagedServingEngine``
(gather) with ``serve_loop``, and through the port's slot, paged-gather
and paged-kernel engines (the kernel engine takes the plain path on CPU
tensors), at decode_steps S in {1, 4}, on the same weights
(``convert.params_from_jax``). Every request's tokens must agree with
the JAX slot engine's under the decode-parity rule (top-2 gap > 1e-3,
akka_allreduce_tpu_torch/parity.py), finish reasons must match where the
tokens do, and the port's page pool must drain back to full capacity.
f32 on the CPU; TF32 is off for CUDA matmuls (``allow_tf32 = False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_allreduce_tpu.serving as jserve
from akka_allreduce_tpu.models import transformer as jtf
import akka_allreduce_tpu_torch.serving as tserve
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.ops.kernels import attention as port_attn
from akka_allreduce_tpu_torch.parity import greedy_agree

torch.backends.cuda.matmul.allow_tf32 = False

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=32, rope=True)
LANES, PAGE = 3, 4


def make_requests(mod, n: int, steps: int, seed: int,
                  eos: "dict | None" = None) -> list:
    """``n`` requests of prompt length 3 or 5; ``eos`` maps rid -> EOS."""
    rng = np.random.default_rng(seed)
    return [mod.Request(
        rid=rid, prompt=tuple(int(x) for x in rng.integers(
            0, MODEL["vocab_size"], size=(3, 5)[rid % 2])),
        max_new_tokens=steps, eos_token=(eos or {}).get(rid),
        submitted_at=0.0) for rid in range(n)]


def eos_map(tparams, tcfg, steps: int) -> dict:
    """Every third request stops at the third token it would emit."""
    from akka_allreduce_tpu_torch.models.generate import generate
    out = {}
    for req in make_requests(tserve, 8, 7, seed=steps)[::3]:
        toks = generate(tparams, torch.tensor([req.prompt]), tcfg, steps=3)
        out[req.rid] = int(toks[0, 2])
    return out


def run(mod, engine, reqs) -> dict:
    sched = mod.RequestScheduler(
        mod.SchedulerConfig(max_queue_depth=len(reqs)),
        num_slots=engine.num_slots)
    for r in reqs:
        sched.submit(r)
    return mod.serve_loop(engine, sched, max_dispatches=500)


def path_logits(jparams, jcfg, prompt, toks) -> np.ndarray:
    """JAX's logits along its own token path: one causal forward over the
    sequence padded to max_seq (padding cannot reach earlier positions)."""
    seq = np.zeros((1, jcfg.max_seq), np.int32)
    full = list(prompt) + list(toks[:-1])
    seq[0, :len(full)] = full
    logits = jtf.transformer_apply(jparams, jnp.asarray(seq), jcfg)[0]
    return np.asarray(logits)[len(prompt) - 1:len(full)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jtf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, ttf.TransformerConfig(**MODEL), tparams


@pytest.mark.parametrize("steps", [1, 4])
def test_engines_match_jax_under_churn(weights, steps):
    jcfg, jparams, tcfg, tparams = weights
    eos = eos_map(tparams, tcfg, steps)
    want = run(jserve, jserve.ServingEngine(
        jparams, jcfg, jserve.EngineConfig(num_slots=LANES,
                                           decode_steps=steps)),
        make_requests(jserve, 8, 7, seed=steps, eos=eos))
    want_paged = run(jserve, jserve.PagedServingEngine(
        jparams, jcfg, jserve.PagedEngineConfig(
            num_slots=LANES, decode_steps=steps, page_size=PAGE)),
        make_requests(jserve, 8, 7, seed=steps, eos=eos))
    assert want_paged == want  # the JAX package's own bitwise contract
    reqs = make_requests(tserve, 8, 7, seed=steps, eos=eos)
    assert want.keys() == {r.rid for r in reqs}
    assert any(reason == "eos" for _, reason in want.values())

    engines = {
        "slot": tserve.ServingEngine(tparams, tcfg, tserve.EngineConfig(
            num_slots=LANES, decode_steps=steps)),
        **{f"paged_{impl}": tserve.PagedServingEngine(
            tparams, tcfg, tserve.PagedEngineConfig(
                num_slots=LANES, decode_steps=steps, page_size=PAGE,
                attention_impl=impl)) for impl in ("gather", "kernel")},
    }
    launches = port_attn.PAGED_ATTENTION_LAUNCHES
    for name, engine in engines.items():
        got = run(tserve, engine,
                  make_requests(tserve, 8, 7, seed=steps, eos=eos))
        assert got.keys() == want.keys(), name
        for req in reqs:
            ref_toks, ref_reason = want[req.rid]
            toks, reason = got[req.rid]
            ok, why = greedy_agree(ref_toks, toks, path_logits(
                jparams, jcfg, req.prompt, ref_toks))
            assert ok, f"{name} rid {req.rid}: {why}"
            if list(toks) == list(ref_toks):
                assert reason == ref_reason, f"{name} rid {req.rid}"
        assert engine.peak_occupied == LANES
        if name != "slot":
            engine.pool.check_invariants()
            assert engine.pool.pages_in_use == 0
            assert engine.pool.free_pages == engine.pool.capacity
    # CPU tensors: the kernel engine ran the plain version, no launches
    assert port_attn.PAGED_ATTENTION_LAUNCHES == launches


def test_shared_prompts_split_and_match_slot_engine(weights):
    """Identical prompts share their pages; the first decode write splits
    the shared tail (COW) and the tokens stay the slot engine's."""
    _, _, tcfg, tparams = weights
    reqs = [tserve.Request(rid=i, prompt=(7, 8, 9, 10, 11, 12),
                           max_new_tokens=5, submitted_at=0.0)
            for i in range(4)]
    slot = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=2)), reqs)
    engine = tserve.PagedServingEngine(tparams, tcfg,
                                       tserve.PagedEngineConfig(
                                           num_slots=2, page_size=PAGE))
    paged = run(tserve, engine, [tserve.Request(
        rid=r.rid, prompt=r.prompt, max_new_tokens=5, submitted_at=0.0)
        for r in reqs])
    assert paged == slot
    summary = engine.paging_summary()
    assert summary["pages_shared_total"] > 0
    assert summary["cow_splits_total"] > 0
    assert engine.pool.pages_in_use == 0


def test_kernel_with_window_and_bad_impl_are_refused(weights):
    _, _, tcfg, tparams = weights
    windowed = ttf.TransformerConfig(**MODEL, attn_window=4)
    with pytest.raises(ValueError, match="window"):
        tserve.PagedServingEngine(tparams, windowed,
                                  tserve.PagedEngineConfig(
                                      attention_impl="kernel"))
    with pytest.raises(ValueError, match="attention_impl"):
        tserve.PagedEngineConfig(attention_impl="pallas")
    with pytest.raises(ValueError, match="decode_steps"):
        tserve.PagedEngineConfig(decode_steps=0)


def test_mha_without_rope_agrees_with_full_forward():
    """The learned-position (no rope) MHA model through the paged kernel
    engine (plain path on CPU) and the slot engine agrees with the full
    forward under the decode-parity rule."""
    cfg = ttf.TransformerConfig(vocab_size=97, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq=32)
    params = ttf.init_transformer(torch.Generator().manual_seed(3), cfg)
    engines = [
        tserve.PagedServingEngine(params, cfg, tserve.PagedEngineConfig(
            num_slots=2, page_size=PAGE, decode_steps=2,
            attention_impl="kernel")),
        tserve.ServingEngine(params, cfg, tserve.EngineConfig(
            num_slots=2))]
    for engine in engines:
        reqs = make_requests(tserve, 5, 6, seed=9)
        got = run(tserve, engine, reqs)
        for req in reqs:
            toks = got[req.rid][0]
            seq = torch.tensor([list(req.prompt) + toks[:-1]])
            logits = ttf.transformer_apply(params, seq, cfg)[0]
            want = logits[len(req.prompt) - 1:].argmax(-1).tolist()
            ok, why = greedy_agree(want, toks,
                                   logits[len(req.prompt) - 1:].numpy())
            assert ok, f"{type(engine).__name__} rid {req.rid}: {why}"
    assert engines[1].prefill_shapes == {3, 5}


@pytest.mark.parametrize("steps", [1, 4])
def test_stop_tokens_end_requests_with_reason_stop(weights, steps):
    """A request stops at the first occurrence of one of its stop tokens
    (host check at S=1, device latch at S>1); the stop token is each
    stream's last token that did not occur earlier in it."""
    _, _, tcfg, tparams = weights
    base = run(tserve, tserve.ServingEngine(tparams, tcfg,
                                            tserve.EngineConfig(num_slots=2)),
               make_requests(tserve, 4, 6, seed=11))
    stop_reqs = []
    cut = {}
    for r in make_requests(tserve, 4, 6, seed=11):
        toks = base[r.rid][0]
        cut[r.rid] = max(i for i in range(6) if toks[i] not in toks[:i]) + 1
        stop_reqs.append(tserve.Request(
            rid=r.rid, prompt=r.prompt, max_new_tokens=6,
            stop_tokens=(toks[cut[r.rid] - 1],), submitted_at=0.0))
    engine = tserve.PagedServingEngine(tparams, tcfg,
                                       tserve.PagedEngineConfig(
                                           num_slots=2, page_size=PAGE,
                                           decode_steps=steps,
                                           attention_impl="kernel"))
    results = run(tserve, engine, stop_reqs)
    for r in stop_reqs:
        toks, reason = results[r.rid]
        assert reason == "stop"
        assert toks == base[r.rid][0][:cut[r.rid]]
    engine.pool.check_invariants()
    assert engine.pool.pages_in_use == 0


@pytest.mark.parametrize("steps", [1, 4])
def test_poisoned_lane_fails_its_request_and_retries(weights, steps):
    """A lane whose carried logits go non-finite fails ITS request with
    reason ``nan`` (the finite-output guard rides the one readback); the
    serve loop requeues it under the retry budget and it then completes
    with the tokens an unpoisoned run gives; the other lanes never see
    it."""
    _, _, tcfg, tparams = weights
    clean = run(tserve, tserve.ServingEngine(
        tparams, tcfg, tserve.EngineConfig(num_slots=2)),
        make_requests(tserve, 3, 5, seed=21))
    engine = tserve.PagedServingEngine(tparams, tcfg,
                                       tserve.PagedEngineConfig(
                                           num_slots=2, page_size=PAGE,
                                           decode_steps=steps))
    step = engine.step
    poisoned = []

    def poison_once():
        if not poisoned and engine.occupied:
            engine._state["logits"][0] = float("nan")
            poisoned.append(engine._slots[0].req.rid)
        return step()

    engine.step = poison_once
    metrics = tserve.ServingMetrics()
    sched = tserve.RequestScheduler(
        tserve.SchedulerConfig(retry=tserve.RetryPolicy(base_delay=0.0)),
        num_slots=2)
    for r in make_requests(tserve, 3, 5, seed=21):
        metrics.on_submit(r.rid)
        sched.submit(r)
    results = tserve.serve_loop(engine, sched, metrics=metrics,
                                max_dispatches=200)
    assert results == clean
    assert metrics.requests_failed == 1 and metrics.retries_total == 1
    assert engine.pool.pages_in_use == 0
    # the registry reads the same cells the summary renders
    summary = metrics.summary()
    assert metrics.registry.value("serve_completed_total") == \
        summary["requests"]["completed"] == 3
    assert metrics.registry.value("serve_retries_total") == 1
    assert metrics.registry.value("serve_ttft_seconds").count == 3
