"""The port's ``serve``, ``train`` and ``emulate`` commands on the CPU.

``serve --device cpu`` on the tiny model prints one JSON line carrying
the JAX serve command's summary keys; ``--device cuda`` on a machine
without CUDA exits non-zero; the kernel read path with a sliding window
is refused; and one seed draws the same synthetic load as the JAX
command. ``train --device cpu`` prints the JAX command's step lines and
its report carries losses, times and launch counts (0: the CPU runs the
kernels' plain versions); without ``--device cpu`` and without CUDA it
raises. ``emulate --device cpu`` prints the JAX command's lines
(``completed N/N rounds ...``, ``fuzz: ... 0 violations``), refuses what
it refuses with exit code 2, and without ``--device cpu`` and without
CUDA raises; ``emulate --engine native`` runs the C++ engine on the host
and prints its line. ``master`` and ``worker`` take the JAX commands'
flags with their defaults and choices (the worker adds ``--device`` and
``--assert-honest``); a C++ engine given ``--device`` exits 2, and a
Python worker without ``--device cpu`` and without CUDA raises. TF32 is
off for CUDA matmuls (``allow_tf32 = False``).
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


# -- emulate ------------------------------------------------------------------

EMULATE_SCRIPT = ["emulate", "--device", "cpu", "--workers", "4",
                  "--data-size", "778", "--max-chunk-size", "3",
                  "--max-lag", "3", "--th-complete", "1.0",
                  "--assert-multiple", "4"]


def test_emulate_cpu_prints_the_jax_commands_lines(capsys):
    """The reference's script config (scripts/testAllreduceMaster.sc)
    completes 100/100 rounds with ``output == 4 x input`` checked at each
    checkpoint, printing the JAX command's lines: rank 0's ``MB in s at
    MB/s`` per checkpoint, then ``completed N/N rounds ...``."""
    assert cli.main(EMULATE_SCRIPT) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert all(" MB in " in ln and ln.endswith(" MB/s") for ln in lines[:2])
    assert lines[2].startswith("completed 100/100 rounds in ")
    assert lines[2].endswith("(4 workers, dataSize=778, chunk=3, maxLag=3)")


def test_emulate_trace_file_and_kill_rank(capsys, tmp_path):
    path = tmp_path / "trace.jsonl"
    rc = cli.main(["emulate", "--device", "cpu", "--workers", "4",
                   "--data-size", "64", "--max-chunk-size", "16",
                   "--max-round", "3", "--th-allreduce", "0.75",
                   "--th-reduce", "0.75", "--th-complete", "0.75",
                   "--kill-rank", "2", "--trace-file", str(path)])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[0] == f"trace -> {path}"
    assert out[1].startswith("completed 3/3 rounds in ")
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["rank"] for r in rows if r["kind"] == "worker_dead"] == [2]


def test_emulate_fuzz_prints_zero_violations(capsys):
    assert cli.main(["emulate", "--device", "cpu", "--fuzz", "3"]) == 0
    out = capsys.readouterr().out.strip()
    assert out.startswith("fuzz: 11 schedules x 100 rounds each, "
                          "0 violations (")


@pytest.mark.parametrize("flags,match", [
    (["--assert-multiple", "2"], "requires all thresholds at 1.0"),
    (["--kill-rank", "2"], "is not a worker seat (0..1)"),
    (["--kill-rank", "-1"], "is not a worker seat"),
    (["--fuzz", "5", "--workers", "4", "--kill-rank", "3",
      "--th-allreduce", "0.9", "--th-reduce", "0.6", "--th-complete", "0.6"],
     "needs ceil(0.9*4)=4 workers"),
    (["--fuzz", "2", "--trace-file", "t.jsonl"], "writes no trace"),
    (["--engine", "native", "--trace-file", "t.jsonl"],
     "--engine native does not produce traces"),
    (["--engine", "native"], "--device cpu cannot be used with --engine "
                             "native")])
def test_emulate_refusals_exit_2(capsys, flags, match):
    assert cli.main(["emulate", "--device", "cpu", *flags]) == 2
    assert match in capsys.readouterr().err


def test_emulate_native_engine_runs_on_the_host(capsys):
    """``emulate --engine native`` (refused before the C++ engines were
    ported) runs the reference's script config on the C++ engine, with
    ``output == 4 x input`` checked on every flush inside the engine, and
    says in its line that it ran on the host."""
    argv = [a for a in EMULATE_SCRIPT if a not in ("--device", "cpu")]
    assert cli.main(argv + ["--engine", "native"]) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith("completed 100/100 rounds in ")
    assert line.endswith(" rounds/s, 404 flushes, native engine, host)")


def _subparser(parser, name):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[name]
    raise KeyError(name)


def _flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["master", "worker"])
def test_master_and_worker_flags_match_the_jax_commands(command):
    from akka_allreduce_tpu import cli as jax_cli
    jax_parser = argparse.ArgumentParser()
    sub = jax_parser.add_subparsers(dest="cmd")
    getattr(jax_cli, f"_add_{command}")(sub)
    want = _flags(_subparser(jax_parser, command))
    got = _flags(_subparser(cli.build_parser(), command))
    assert {k: got[k] for k in want} == want
    extra = {"master": set(), "worker": {"device", "assert_honest"}}
    assert set(got) - set(want) == extra[command]
    if command == "worker":
        assert got["device"][1] is None  # the engine picks: cuda or none


@pytest.mark.parametrize("argv", [
    ["worker", "--native", "--device", "cpu"],
    ["worker", "--native", "--device", "cuda"],
    ["worker", "--native", "--assert-honest"],
    ["emulate", "--engine", "native", "--device", "cuda"]])
def test_native_engines_refuse_device_flags(capsys, argv):
    assert cli.main(argv) == 2
    assert "error: " in capsys.readouterr().err


def test_master_takes_no_device(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["master", "--device", "cpu"])
    assert exc.value.code == 2


def test_worker_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["worker", "--master-port", "9", "--timeout", "1"])


def test_emulate_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-m", "akka_allreduce_tpu_torch.cli", "emulate"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr
