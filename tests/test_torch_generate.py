"""Greedy ``generate`` of the port against the JAX package's.

Same weights (``convert.params_from_jax``), same numpy prompts. Greedy
tokens must equal JAX's wherever JAX's top-2 logit gap exceeds 1e-3 (the
decode-parity rule, akka_allreduce_tpu_torch/parity.py); JAX's logits
along its own token path come from one full forward. f32 on the CPU.
TF32 is off for CUDA matmuls (``allow_tf32 = False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import generate as jgen
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import generate as tgen
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.parity import greedy_agree

torch.backends.cuda.matmul.allow_tf32 = False

CONFIGS = {
    "gqa_rope": dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=32, rope=True),
    "mha_gelu": dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2,
                     d_ff=128, max_seq=32),
}


def jax_path_logits(jparams, jcfg, prompt_row, toks_row) -> np.ndarray:
    """JAX's logits that picked each of its tokens (one full forward)."""
    seq = np.concatenate([prompt_row, toks_row[:-1]])[None]
    logits = jtf.transformer_apply(jparams, jnp.asarray(seq), jcfg)[0]
    return np.asarray(logits)[len(prompt_row) - 1:]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_match_jax_under_gap_rule(name):
    jcfg = jtf.TransformerConfig(**CONFIGS[name])
    tcfg = ttf.TransformerConfig(**CONFIGS[name])
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, size=(3, 7)).astype(np.int32)
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                                    steps=12))
    got = tgen.generate(tparams, torch.from_numpy(prompt).long(), tcfg,
                        steps=12).numpy()
    assert got.shape == want.shape == (3, 12) and got.dtype == np.int32
    for i in range(3):
        ok, why = greedy_agree(want[i], got[i],
                               jax_path_logits(jparams, jcfg, prompt[i],
                                               want[i]))
        assert ok, f"row {i}: {why}"


def test_eos_lengths_match_jax():
    jcfg = jtf.TransformerConfig(**CONFIGS["gqa_rope"])
    tcfg = ttf.TransformerConfig(**CONFIGS["gqa_rope"])
    jparams = jtf.init_transformer(jax.random.key(4), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, size=(4, 5)).astype(np.int32)
    free = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg,
                                    steps=10))
    eos = int(free[0, 3])  # a token row 0 emits mid-stream
    jt, jl = jgen.generate(jparams, jnp.asarray(prompt), jcfg, steps=10,
                           eos_token=eos)
    tt, tl = tgen.generate(tparams, torch.from_numpy(prompt).long(), tcfg,
                           steps=10, eos_token=eos)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl[0]) <= 4


def test_multi_step_decode_latches_like_single_steps():
    """The block decode's device latch over the engine's per-lane step: a
    lane stops writing KV and advancing at its EOS, and every token before
    equals single-step greedy decode."""
    from akka_allreduce_tpu_torch.serving.engine import _slot_decode_step
    tcfg = ttf.TransformerConfig(**CONFIGS["gqa_rope"])
    params = ttf.init_transformer(torch.Generator().manual_seed(0), tcfg)
    prompt = torch.tensor([[5, 9, 2, 7], [8, 1, 3, 6]])
    want = tgen.generate(params, prompt, tcfg, steps=6)
    # lane 1's EOS: its first token that did not occur earlier in its row
    k = next(i for i in range(1, 6)
             if int(want[1, i]) not in want[1, :i].tolist())
    cache = tgen.init_kv_cache(tcfg, 2)
    cache, logits = tgen.prefill(params, cache, prompt, tcfg)
    kv = {"k": cache["k"], "v": cache["v"]}
    eos = torch.tensor([-1, int(want[1, k])], dtype=torch.int32)
    (_, _, pos, done, remaining, bad), toks = tgen.multi_step_decode(
        params, kv, logits, torch.tensor([4, 4], dtype=torch.int32),
        torch.zeros(2, dtype=torch.bool),
        torch.tensor([6, 6], dtype=torch.int32), eos,
        torch.full((2, 1), -1, dtype=torch.int32), 5,
        lambda p, kv, tok, pos, mask: _slot_decode_step(p, kv, tok, pos,
                                                        tcfg, mask))
    assert torch.equal(toks[:, 0], want[0, :5])
    assert torch.equal(toks[:k + 1, 1], want[1, :k + 1])
    assert done.tolist() == [False, True] and not bad.any()
    assert pos.tolist() == [9, 4 + k]
    assert remaining.tolist() == [1, 6 - (k + 1)]
