"""The port's ``serve`` and ``train`` commands on the CPU.

``serve --device cpu`` on the tiny model prints one JSON line carrying
the JAX serve command's summary keys; ``--device cuda`` on a machine
without CUDA exits non-zero; the kernel read path with a sliding window
is refused; and one seed draws the same synthetic load as the JAX
command. ``train --device cpu`` prints the JAX command's step lines and
its report carries losses, times and launch counts (0: the CPU runs the
kernels' plain versions); without ``--device cpu`` and without CUDA it
raises. TF32 is off for CUDA matmuls (``allow_tf32 = False``).
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from akka_allreduce_tpu.serving import ServingMetrics as JaxServingMetrics
from akka_allreduce_tpu_torch import cli

torch.backends.cuda.matmul.allow_tf32 = False

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--vocab", "97", "--d-model", "64", "--n-heads", "4",
        "--kv-heads", "2", "--n-layers", "2", "--d-ff", "128", "--rope",
        "--max-seq", "32", "--requests", "5", "--prompt-len", "3:6",
        "--max-new-tokens", "6", "--slots", "2"]

# the JAX command's report keys that the port's engines produce
JAX_REPORT_KEYS = {"config", "blocked_on_memory", "completed_reasons",
                   "dead_letter", "dead_letter_dropped",
                   "prefill_dispatches", "prefill_programs", "kv_cache_mb"}


@pytest.mark.parametrize("engine", [
    [], ["--paged", "--page-size", "4", "--paged-attention", "kernel",
         "--decode-steps", "4"]])
def test_serve_cpu_prints_one_json_line_with_jax_keys(capsys, engine):
    rc = cli.main(["serve", "--device", "cpu", *TINY, *engine])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    report = json.loads(lines[0])
    jax_keys = set(JaxServingMetrics().summary()) | JAX_REPORT_KEYS
    assert jax_keys <= set(report), jax_keys - set(report)
    assert report["requests"]["completed"] == 5
    assert report["tokens"]["decode"] == 5 * 6
    assert report["device"]["type"] == "cpu"
    assert ("paging" in report) == bool(engine)
    if engine:
        assert report["paging"]["pages_in_use"] == 0
        assert report["config"]["paged_attention"] == "kernel"


@pytest.mark.parametrize("command", [["serve", *TINY], ["train"]])
def test_cuda_without_cuda_exits_nonzero(command):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "akka_allreduce_tpu_torch.cli", *command],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_kernel_with_attn_window_is_refused(capsys):
    rc = cli.main(["serve", "--device", "cpu", *TINY, "--paged",
                   "--paged-attention", "kernel", "--attn-window", "4"])
    assert rc == 2
    assert "window" in capsys.readouterr().err


def test_bad_flags_exit_2(capsys):
    assert cli.main(["serve", "--device", "cpu", *TINY,
                     "--max-new-tokens", "40"]) == 2
    assert "exceeds --max-seq" in capsys.readouterr().err


def test_synthetic_load_matches_the_jax_command():
    """One seed, one load: the port draws prompts and arrivals exactly
    as akka_allreduce_tpu/cli.py's serve does (same generator, same
    order of draws)."""
    args = argparse.Namespace(seed=7, requests=6, load="open",
                              arrival_rate=3.0, vocab=97,
                              max_new_tokens=4, eos_token=None)
    reqs = cli.make_requests(args, 3, 9)
    rng = np.random.default_rng(7)
    arrivals = np.cumsum(rng.exponential(1 / 3.0, size=6))
    for i, req in enumerate(reqs):
        plen = int(rng.integers(3, 10))
        prompt = tuple(int(x) for x in rng.integers(0, 97, size=plen))
        assert req.prompt == prompt and req.rid == i
        assert req.arrival - reqs[0].arrival == pytest.approx(
            arrivals[i] - arrivals[0])


TRAIN_TINY = ["train", "--device", "cpu", "--vocab", "61", "--d-model", "64",
              "--n-heads", "4", "--kv-heads", "2", "--rope", "--d-ff", "128",
              "--seq", "24", "--steps", "3", "--log-every", "2"]


def test_train_cpu_prints_step_lines_and_reports(capsys):
    assert cli.main(TRAIN_TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    # the JAX command's cadence: the first step, then every --log-every
    assert [ln.split(":")[0] for ln in steps] == ["step    1", "step    2"]
    assert all("loss" in ln and "tok/s)" in ln for ln in steps)
    report = cli.run_train(cli.build_parser().parse_args(TRAIN_TINY))
    assert len(report["losses"]) == len(report["step_ms"]) == 3
    assert all(np.isfinite(report["losses"]))
    assert report["config"]["batch"] == 2 and report["config"]["seq"] == 24
    assert report["launches"] == {"flash_fwd": 0, "flash_dq": 0,
                                  "flash_dkv": 0}
    assert report["mfu"] is None and report["device"]["type"] == "cpu"


def test_train_draws_the_jax_commands_batches():
    """Step i's synthetic batch is default_rng(i).integers(0, vocab,
    (b, t), int32), as akka_allreduce_tpu/cli.py train draws it: the same
    seed gives the same first loss from the same weights."""
    from akka_allreduce_tpu_torch.models import train
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    args = cli.build_parser().parse_args(TRAIN_TINY + ["--steps", "1"])
    report = cli.run_train(args)
    cfg = cli.train_config(args, 24)
    params = init_transformer(torch.Generator().manual_seed(0), cfg.model)
    state = train.make_train_state(cfg, params=params)
    tokens = np.random.default_rng(0).integers(0, 61, size=(2, 24),
                                               dtype=np.int32)
    _, metrics = train.make_grad_step(cfg)(state.params,
                                           torch.from_numpy(tokens))
    assert report["losses"] == [float(metrics["loss"])]


@pytest.mark.parametrize("flags,match", [
    (["--optimizer", "sgd"], "A5"),
    (["--batch", "4", "--grad-accum", "3"], "divide")])
def test_train_refusals_exit_2(capsys, flags, match):
    assert cli.main(TRAIN_TINY + flags) == 2
    assert match in capsys.readouterr().err
