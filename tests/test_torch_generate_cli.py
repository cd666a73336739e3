"""``generate`` and ``eval`` on a port checkpoint, against the JAX package.

A tiny model trained by the port's ``train --ckpt-dir --ema-decay 0.9
--device cpu`` (once for the module). ``generate`` (raw weights and
``--use-ema``) decodes greedily; its tokens must equal JAX
``models/generate.py generate`` on ``convert.params_to_jax`` of the same
weights wherever ``parity.py``'s top-2 gap rule applies (the reference's
logits, from one JAX forward over its own stream, decide where the two
may part). Sampled ``generate --temperature --top-k --top-p --seed`` is
held to JAX's ``generate(key=jax.random.key(seed))`` under the same rule
on the perturbed scores (the reference's filtered logits plus its Gumbel
noise). ``generate --draft-ckpt-dir`` (the second checkpoint as the
draft) emits the plain greedy tokens, and sampled speculation JAX's
``speculative_sample`` tokens for the same key. ``eval``'s ``ce_nats_per_token`` is held within 1e-5
relative of JAX's pure cross-entropy (``next_token_loss_and_aux`` less the
aux term) over the same windows (``data.eval_batches``). Every exit-2
path of both commands is driven.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.data import eval_batches as jax_eval_batches
from akka_allreduce_tpu.data import load_corpus as jax_load_corpus
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.models.generate import generate as jax_generate
from akka_allreduce_tpu_torch import cli, convert, parity
from akka_allreduce_tpu_torch.models.train import tree_leaves
from akka_allreduce_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_transformer)
from akka_allreduce_tpu_torch.runtime.checkpoint import (CheckpointConfig,
                                                         CheckpointManager)

MODEL = ["--vocab", "61", "--d-model", "64", "--n-heads", "4",
         "--kv-heads", "2", "--rope", "--d-ff", "128"]
SEQ = 24
JCFG = jtf.TransformerConfig(vocab_size=61, d_model=64, n_heads=4,
                             n_kv_heads=2, n_layers=2, d_ff=128,
                             max_seq=SEQ, rope=True)
PROMPT = [5, 17, 2, 40, 33]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Checkpoint directories: one trained with --ema-decay, one without;
    and a .bin corpus of token ids < 61."""
    root = tmp_path_factory.mktemp("gen")
    for name, extra in (("ema", ["--ema-decay", "0.9"]), ("plain", [])):
        assert cli.main(["train", "--device", "cpu", *MODEL, "--seq",
                         str(SEQ), "--steps", "3", "--lr", "1e-2",
                         "--log-every", "10", "--ckpt-every", "3",
                         "--ckpt-dir", str(root / name), *extra]) == 0
    corpus = root / "corpus.bin"
    np.random.default_rng(0).integers(0, 61, size=5 * SEQ + 7).astype(
        "<u2").tofile(corpus)
    return root


def weights(ckpt_dir, item):
    like = init_transformer(
        torch.Generator().manual_seed(0),
        TransformerConfig(vocab_size=61, d_model=64, n_heads=4,
                          n_kv_heads=2, n_layers=2, d_ff=128, max_seq=SEQ,
                          rope=True))
    _, params, _ = CheckpointManager(CheckpointConfig(str(ckpt_dir))
                                     ).restore_params(like, item=item)
    return {"port": params, "jax": convert.params_to_jax(params)}


def gen_argv(ckpt_dir, *flags):
    return ["generate", "--device", "cpu", "--ckpt-dir", str(ckpt_dir),
            *MODEL, "--max-seq", str(SEQ), "--tokens", "4", *flags]


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_generate_matches_jax_greedy(ckpt, capsys, use_ema):
    steps = 12
    argv = gen_argv(ckpt / "ema", "--prompt-tokens",
                    ",".join(map(str, PROMPT)), "--tokens", str(steps))
    assert cli.main(argv + (["--use-ema"] if use_ema else [])) == 0
    out = capsys.readouterr()
    got = [int(t) for t in out.out.strip().split(",")]
    item = "ema" if use_ema else "params"
    assert f"({item})" in out.err
    w = weights(ckpt / "ema", item)["jax"]
    prompt = jnp.asarray(np.asarray(PROMPT, np.int32))[None]
    ref = np.asarray(jax_generate(w, prompt, JCFG, steps=steps))[0]
    logits = np.asarray(jtf.transformer_apply(w, jnp.concatenate(
        [prompt, jnp.asarray(ref[None, :-1])], axis=1), JCFG))[0]
    ref_logits = logits[len(PROMPT) - 1:]
    ok, why = parity.greedy_agree(ref, got, ref_logits)
    assert ok, why
    assert len(got) == steps


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_sampled_matches_jax(ckpt, capsys, seed):
    import jax
    from akka_allreduce_tpu.models.generate import apply_sample_filters
    steps, temperature, top_k, top_p = 10, 0.8, 20, 0.9
    assert cli.main(gen_argv(
        ckpt / "ema", "--prompt-tokens", ",".join(map(str, PROMPT)),
        "--tokens", str(steps), "--temperature", str(temperature),
        "--top-k", str(top_k), "--top-p", str(top_p), "--seed",
        str(seed))) == 0
    got = [int(t) for t in capsys.readouterr().out.strip().split(",")]
    w = weights(ckpt / "ema", "params")["jax"]
    prompt = jnp.asarray(np.asarray(PROMPT, np.int32))[None]
    key = jax.random.key(seed)
    ref = np.asarray(jax_generate(w, prompt, JCFG, steps=steps, key=key,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p))[0]
    logits = jtf.transformer_apply(w, jnp.concatenate(
        [prompt, jnp.asarray(ref[None, :-1])], axis=1), JCFG)[0]
    scores = apply_sample_filters(logits[len(PROMPT) - 1:], temperature,
                                  top_k, top_p) + jnp.stack([
        jax.random.gumbel(jax.random.fold_in(key, j), (1, 61))[0]
        for j in range(steps)])
    ok, why = parity.greedy_agree(ref, got, np.asarray(scores))
    assert ok, why


def test_generate_speculative_greedy_and_sampled(ckpt, capsys):
    """The second checkpoint drafts for the first: greedy speculation
    prints the plain greedy tokens; sampled speculation prints JAX's
    ``speculative_sample`` tokens for the same key."""
    import jax
    from akka_allreduce_tpu.models.speculate import speculative_sample
    ids = ",".join(map(str, PROMPT))
    base = gen_argv(ckpt / "ema", "--prompt-tokens", ids, "--tokens", "10")
    assert cli.main(base) == 0
    plain = capsys.readouterr().out.strip()
    spec = base + ["--draft-ckpt-dir", str(ckpt / "plain"),
                   "--speculate-k", "3"]
    assert cli.main(spec) == 0
    out = capsys.readouterr()
    assert out.out.strip() == plain
    assert "speculative:" in out.err and "target passes" in out.err
    assert cli.main(spec + ["--temperature", "0.9", "--top-k", "12",
                            "--seed", "5"]) == 0
    got = [int(t) for t in capsys.readouterr().out.strip().split(",")]
    want, _ = speculative_sample(
        weights(ckpt / "ema", "params")["jax"],
        weights(ckpt / "plain", "params")["jax"],
        jnp.asarray(np.asarray(PROMPT, np.int32))[None], JCFG, JCFG, 10,
        key=jax.random.key(5), k=3, temperature=0.9, top_k=12)
    assert got == np.asarray(want)[0].tolist()


def test_ema_and_raw_weights_differ(ckpt):
    raw = weights(ckpt / "ema", "params")["port"]
    ema = weights(ckpt / "ema", "ema")["port"]
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(raw), tree_leaves(ema)))


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_eval_matches_jax_cross_entropy(ckpt, capsys, use_ema):
    corpus = str(ckpt / "corpus.bin")
    argv = ["eval", "--device", "cpu", "--ckpt-dir", str(ckpt / "ema"),
            "--data-file", corpus, *MODEL, "--max-seq", str(SEQ),
            "--batch", "2"] + (["--use-ema"] if use_ema else [])
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    w = weights(ckpt / "ema", "ema" if use_ema else "params")["jax"]
    ce, n = 0.0, 0.0
    for arr in jax_eval_batches(jax_load_corpus(corpus), 2, SEQ):
        loss, w_sum, aux = jtf.next_token_loss_and_aux(
            w, jnp.asarray(arr), JCFG)
        ce += float(loss - aux["aux_loss"] * w_sum)
        n += float(w_sum)
    assert got["windows"] == 5 and got["tokens"] == int(n) == 5 * (SEQ - 1)
    assert got["ce_nats_per_token"] == pytest.approx(ce / n, rel=1e-5)
    assert "bits_per_byte" not in got  # a uint16 corpus, not bytes


@pytest.mark.parametrize("flags,match", [
    ([], "exactly one of --prompt / --prompt-tokens"),
    (["--prompt", "a", "--prompt-tokens", "1"], "exactly one"),
    (["--prompt", "hi"], "byte-level but vocab=61"),
    (["--prompt-tokens", "1,x"], "bad --prompt-tokens"),
    (["--prompt-tokens", "1,61"], "out of vocab range"),
    (["--prompt-tokens", ","], "empty prompt"),
    (["--prompt-tokens", "1", "--tokens", str(SEQ)], "exceeds --max-seq"),
    (["--prompt-tokens", "1", "--temperature", "-1"], "must be >= 0"),
    (["--prompt-tokens", "1", "--top-k", "3"], "need --temperature > 0"),
    (["--prompt-tokens", "1", "--temperature", "1", "--top-k", "0"],
     "--top-k must be >= 1"),
    (["--prompt-tokens", "1", "--temperature", "1", "--top-p", "1.5"],
     "--top-p must be in (0, 1]"),
    (["--prompt-tokens", "1", "--temperature", "0.7", "--top-p", "0"],
     "--top-p must be in (0, 1]"),
    (["--prompt-tokens", "1", "--draft-ckpt-dir", "d",
      "--speculate-k", "0"], "--speculate-k must be >= 1"),
    (["--prompt-tokens", "1", "--tokens", "20", "--draft-ckpt-dir", "d"],
     "headroom"),
    (["--prompt-tokens", "1", "--draft-ckpt-dir", "d", "--temperature",
      "0.5", "--top-p", "0"], "--top-p must be in (0, 1]"),
    # MoE models are ported: MoE flags against a dense checkpoint are the
    # wrong model shape
    (["--prompt-tokens", "1", "--moe-experts", "4"],
     "cannot restore item 'params'")])
def test_generate_refusals_exit_2(ckpt, capsys, flags, match):
    assert cli.main(gen_argv(ckpt / "ema", *flags)) == 2
    assert match in capsys.readouterr().err


def test_generate_checkpoint_faults_exit_2(ckpt, tmp_path, capsys):
    # --use-ema on a checkpoint saved without EMA: no fall back
    assert cli.main(gen_argv(ckpt / "plain", "--prompt-tokens", "1",
                             "--use-ema")) == 2
    err = capsys.readouterr().err
    assert "cannot restore item 'ema'" in err
    assert "trained without --ema-decay?" in err
    assert "available items: ['opt_state', 'params']" in err
    # no checkpoint at all, for the target or for the draft
    assert cli.main(gen_argv(tmp_path / "none", "--prompt-tokens", "1")) == 2
    assert "no checkpoint found" in capsys.readouterr().err
    assert cli.main(gen_argv(ckpt / "ema", "--prompt-tokens", "1",
                             "--draft-ckpt-dir",
                             str(tmp_path / "nodraft"))) == 2
    assert f"no checkpoint found in {tmp_path / 'nodraft'}" in \
        capsys.readouterr().err
    # the wrong model shape
    argv = gen_argv(ckpt / "ema", "--prompt-tokens", "1")
    argv[argv.index("--d-ff") + 1] = "64"
    assert cli.main(argv) == 2
    assert "wrong --d-model/--vocab/--max-seq" in capsys.readouterr().err


def test_eval_refusals_exit_2(ckpt, tmp_path, capsys):
    base = ["eval", "--device", "cpu", "--ckpt-dir", str(ckpt / "ema"),
            *MODEL, "--max-seq", str(SEQ)]
    assert cli.main(base + ["--data-file", str(tmp_path / "no.bin")]) == 2
    assert "no such corpus" in capsys.readouterr().err
    wide = tmp_path / "wide.bin"
    np.asarray([1, 2, 70] * 20, "<u2").tofile(wide)
    assert cli.main(base + ["--data-file", str(wide)]) == 2
    assert "wrong --vocab" in capsys.readouterr().err
    short = tmp_path / "short.bin"
    np.asarray([1, 2, 3], "<u2").tofile(short)
    assert cli.main(base + ["--data-file", str(short)]) == 2
    assert "smaller than one window" in capsys.readouterr().err
    assert cli.main(base + ["--data-file", str(short), "--moe-experts",
                            "2"]) == 2
    assert "cannot restore item 'params'" in capsys.readouterr().err
    assert cli.main(["eval", "--device", "cpu", "--ckpt-dir",
                     str(ckpt / "plain"), *MODEL, "--max-seq", str(SEQ),
                     "--data-file", str(ckpt / "corpus.bin"),
                     "--use-ema"]) == 2
    assert "cannot restore item 'ema'" in capsys.readouterr().err
