"""The port's ``serve`` command on the CPU.

``serve --device cpu`` on the tiny model prints one JSON line carrying
the JAX serve command's summary keys; ``--device cuda`` on a machine
without CUDA exits non-zero; the kernel read path with a sliding window
is refused; and one seed draws the same synthetic load as the JAX
command. TF32 is off for CUDA matmuls (``allow_tf32 = False``).
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


def test_cuda_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "akka_allreduce_tpu_torch.cli", "serve",
         *TINY], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
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
