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
    (["--batch", "4", "--grad-accum", "3"], "divide"),
    (["--steps-per-dispatch", "0"], "steps-per-dispatch"),
    (["--steps-per-dispatch", "2", "--deadline-ms", "50"],
     "single-process exact path"),
    (["--ema-decay", "1.0"], "ema_decay")])
def test_train_refusals_exit_2(capsys, flags, match):
    assert cli.main(TRAIN_TINY + flags) == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("device,refused", [("cuda", True), ("cpu", False)])
def test_train_chunks_across_ranks_on_the_card_need_ipc(device, refused):
    """``--steps-per-dispatch > 1`` across ranks captures the sync into a
    CUDA graph on the card, which the host-staged gloo wire cannot be:
    refused there, naming ipc (checked from the flags alone); on the CPU
    the gloo ranks run their chunks step by step."""
    args = cli.build_parser().parse_args(TRAIN_TINY + [
        "--steps-per-dispatch", "2", "--dp", "2", "--dist-backend", "gloo",
        "--device", device])
    if refused:
        with pytest.raises(ValueError, match="needs --dist-backend ipc"):
            cli._check_train_flags(args)
    else:
        assert cli._check_train_flags(args)[2] == "gloo"


def test_train_sgd_runs(capsys):
    """``--optimizer sgd`` (refused by the one-card slice) trains."""
    assert cli.main(TRAIN_TINY + ["--optimizer", "sgd",
                                  "--sgd-momentum", "0.5"]) == 0
    assert "step    2: loss" in capsys.readouterr().out


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


# the JAX command's backend flags, for which the port's commands take
# --device
JAX_BACKEND_FLAGS = {"platform", "compile_cache", "xla_overlap",
                     "xla_overlap_mem_pct"}


@pytest.mark.parametrize("command", ["generate", "eval"])
def test_generate_and_eval_flags_match_the_jax_commands(command):
    from akka_allreduce_tpu import cli as jax_cli
    jax_parser = argparse.ArgumentParser()
    sub = jax_parser.add_subparsers(dest="cmd")
    getattr(jax_cli, f"_add_{command}")(sub)
    want = _flags(_subparser(jax_parser, command))
    got = _flags(_subparser(cli.build_parser(), command))
    assert {k: got[k] for k in set(want) - JAX_BACKEND_FLAGS} == {
        k: v for k, v in want.items() if k not in JAX_BACKEND_FLAGS}
    assert set(got) - set(want) == {"device"}
    assert got["device"][1] == "cuda"


@pytest.mark.parametrize("flag", [
    "accum_schedule", "optimizer", "sgd_momentum", "ema_decay",
    "metrics_file", "metrics_interval", "xprof_dir", "xprof_steps",
    "steps_per_dispatch"])
def test_train_a5_flags_match_the_jax_command(flag):
    from akka_allreduce_tpu import cli as jax_cli
    jax_parser = argparse.ArgumentParser()
    sub = jax_parser.add_subparsers(dest="cmd")
    jax_cli._add_train(sub)
    want = _flags(_subparser(jax_parser, "train"))[flag]
    got = _flags(_subparser(cli.build_parser(), "train"))[flag]
    # choices as a tuple or a list: the same values in the same order
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert list(got[2] or []) == list(want[2] or [])


@pytest.mark.parametrize("flag", [
    "kv_cache", "prefill_buckets", "temperature", "top_k", "top_p",
    "speculative", "draft_steps", "draft_layers", "policy",
    "deadline_slack_s", "ckpt_dir", "use_ema", "tie_embeddings",
    "watchdog_timeout", "chaos", "drain_dir", "preempt_poll",
    "preempt_interval", "max_attempts", "retry_base_delay", "retry_jitter",
    "tpot_estimate", "queue_depth", "th_step", "trace_file",
    "metrics_file", "metrics_interval", "selfcheck"])
def test_serve_a6_flags_match_the_jax_command(flag):
    from akka_allreduce_tpu import cli as jax_cli
    jax_parser = argparse.ArgumentParser()
    sub = jax_parser.add_subparsers(dest="cmd")
    jax_cli._add_serve(sub)
    want = _flags(_subparser(jax_parser, "serve"))[flag]
    got = _flags(_subparser(cli.build_parser(), "serve"))[flag]
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert list(got[2] or []) == list(want[2] or [])


@pytest.mark.parametrize("flags", [
    ["--kv-cache", "int8"],
    ["--kv-cache", "int8", "--paged", "--page-size", "4",
     "--decode-steps", "4"],
    ["--prefill-buckets", "4,8"],
    ["--temperature", "0.8", "--top-k", "20", "--top-p", "0.95"],
    ["--temperature", "0.8", "--paged", "--page-size", "4",
     "--paged-attention", "kernel", "--decode-steps", "4"],
    ["--speculative", "--draft-steps", "3", "--draft-layers", "1"],
    ["--speculative", "--paged", "--page-size", "4", "--temperature",
     "0.9"],
    ["--policy", "deadline", "--deadline-slack-s", "100"]],
    ids=["int8", "int8-paged-s4", "buckets", "sampled", "sampled-kernel",
         "speculative", "speculative-paged-sampled", "deadline"])
def test_serve_a6_runs_on_the_cpu(capsys, flags):
    assert cli.main(["serve", "--device", "cpu", *TINY, *flags]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["requests"]["completed"] == 5
    assert report["tokens"]["decode"] == 5 * 6
    cfg = report["config"]
    assert cfg["kv_cache"] == ("int8" if "int8" in flags else "model")
    assert cfg["temperature"] == float(flags[flags.index("--temperature")
                                             + 1]
                                       if "--temperature" in flags else 0)
    if "--prefill-buckets" in flags:
        assert cfg["prefill_buckets"] == [4, 8]
        assert report["prefill_programs"] <= 2
    if "--speculative" in flags:
        spec = report["speculative"]
        assert spec["draft_proposed"] == (spec["draft_accepted"]
                                          + spec["draft_rejected"])
        assert cfg["draft_layers"] == 1
    if "--paged" in flags:
        assert report["paging"]["pages_in_use"] == 0
    assert report["evictions"] == 0


def test_serve_evicts_requests_past_their_deadline(capsys):
    """A slack of a microsecond: every request is past its deadline after
    its first dispatch and is evicted between dispatches, its slot
    refilled the same iteration."""
    assert cli.main(["serve", "--device", "cpu", *TINY, "--policy",
                     "deadline", "--deadline-slack-s", "1e-6"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["completed_reasons"] == {"evicted": 5}
    assert report["evictions"] == 5
    assert report["faults"]["evictions_total"] == 5
    assert report["faults"]["deadline_misses_total"] == 5
    assert report["tokens"]["decode"] == 0 < report["tokens"]["wasted"]


@pytest.mark.parametrize("flags,match", [
    (["--kv-cache", "int8", "--paged", "--paged-attention", "kernel"],
     "float pools only"),
    (["--speculative", "--decode-steps", "4"], "pick one"),
    (["--speculative", "--prefill-buckets", "8"], "exact-length"),
    (["--speculative", "--paged", "--paged-attention", "kernel"],
     "gather path"),
    (["--speculative", "--draft-layers", "3"], "--draft-layers must be"),
    (["--speculative", "--draft-steps", "0"], "--draft-steps must be"),
    (["--paged", "--prefill-buckets", "8"], "slot-engine knob"),
    (["--prefill-buckets", "4"], "smaller than --prompt-len max"),
    (["--prefill-buckets", "4,x"], "bad --prefill-buckets"),
    (["--top-k", "5"], "require --temperature > 0"),
    (["--temperature", "-1"], "--temperature must be >= 0"),
    (["--temperature", "1", "--top-p", "2"], "--top-p must be in (0, 1]"),
    (["--watchdog-timeout", "-1"], "--watchdog-timeout must be >= 0"),
    (["--chaos", "3"], "--chaos requires --selfcheck"),
    (["--selfcheck", "--chaos", "3", "--paged"],
     "--chaos runs the slot-engine fault matrix"),
    (["--selfcheck"], "ROADMAP A10")])
def test_serve_a6_refusals_exit_2(capsys, flags, match):
    assert cli.main(["serve", "--device", "cpu", *TINY, *flags]) == 2
    assert match in capsys.readouterr().err


def test_serve_fault_and_telemetry_flags_on_the_cpu(capsys, tmp_path):
    """The scheduler's flags reach it (a queue of 3 sheds 2 of 5 closed
    submits), the armed watchdog never trips a healthy run, the trace
    holds one serve_step span a decode dispatch and one serve_prefill a
    prefill, and the metrics snapshot's counters are the report's."""
    from akka_allreduce_tpu_torch.runtime.tracing import Tracer
    from akka_allreduce_tpu_torch.telemetry.registry import \
        parse_prometheus_text
    trace, prom = tmp_path / "t.jsonl", tmp_path / "m.prom"
    assert cli.main(["serve", "--device", "cpu", *TINY, "--paged",
                     "--page-size", "4", "--paged-attention", "kernel",
                     "--watchdog-timeout", "30", "--max-attempts", "2",
                     "--retry-base-delay", "0.01", "--queue-depth", "3",
                     "--th-step", "0.5", "--trace-file", str(trace),
                     "--metrics-file", str(prom), "--metrics-interval",
                     "0.05"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["requests"] == {"submitted": 5, "completed": 3,
                                  "rejected": 2, "failed_attempts": 0}
    assert report["config"]["th_step"] == 0.5
    assert report["watchdog_trips"] == 0
    assert report["drained"] == report["resumed"] == 0
    assert report["device_time"]["host_ms"]["count"] \
        == report["decode_dispatches"]
    kinds = [ev["kind"] for ev in Tracer.read_jsonl(str(trace))]
    assert kinds.count("serve_step") == report["decode_dispatches"]
    assert kinds.count("engine_dispatch") == report["decode_dispatches"]
    assert kinds.count("serve_prefill") == report["prefill_dispatches"]
    assert kinds.count("serve_reject") == 2
    assert kinds.count("serve_complete") == 3
    snap = parse_prometheus_text(prom.read_text())
    for name, want in (
            ("serve_submitted_total", 5), ("serve_rejected_total", 2),
            ("serve_completed_total", 3),
            ("serve_decode_tokens_total", report["tokens"]["decode"]),
            ("serve_watchdog_trips_total", 0),
            ("serve_drain_persisted_total", 0)):
        assert snap[(name, ())] == want, name
    assert snap[("engine_dispatch_host_ms_count", ())] \
        == report["decode_dispatches"]


@pytest.mark.parametrize("steps", ["1", "4"])
def test_serve_selfcheck_chaos_on_the_cpu(capsys, steps):
    """``serve --selfcheck --chaos 3``: the fault matrix passes and its
    ledger is the JAX harness's for this seed."""
    assert cli.main(["serve", "--selfcheck", "--chaos", "3",
                     "--decode-steps", steps, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["selfcheck"] == "ok", out["failures"]
    assert out["faults_fired"] == [["engine.dispatch", "hang", 1],
                                   ["engine.dispatch", "raise", 3],
                                   ["engine.logits", "nan", 6],
                                   ["serve.loop", "preempt", 12]]
    assert (out["watchdog_trips"], out["retries"], out["dead_letters"]) \
        == (1, 7, 0)
    assert out["churn_new_prefill_shapes"] == 0
    assert out["churn_kernel_libraries_loaded"] == 0


@pytest.mark.parametrize("flags", [
    ["--selfcheck", "--chaos", "3"],
    [*TINY, "--watchdog-timeout", "1", "--drain-dir", "never-made"]])
def test_serve_fault_paths_without_cuda_raise(flags):
    """Without CUDA and without ``--device cpu`` the selfcheck and an
    armed serve raise before any work (no drain directory is made)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs one without")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["serve", *flags])
    assert not (REPO / "never-made").exists()


def test_serve_from_a_checkpoint(capsys, tmp_path):
    """``serve --ckpt-dir`` reads the weights ``train --ckpt-dir`` saved
    (raw, or the EMA item with --use-ema) and serves them: its tokens are
    the port's generate on those weights."""
    from akka_allreduce_tpu_torch.models.generate import generate
    from akka_allreduce_tpu_torch.runtime.checkpoint import (
        CheckpointConfig, CheckpointManager)
    ckpt = str(tmp_path / "ck")
    assert cli.main(TRAIN_TINY + ["--ckpt-dir", ckpt, "--ckpt-every", "3",
                                  "--ema-decay", "0.9"]) == 0
    capsys.readouterr()
    model = ["--vocab", "61", "--d-model", "64", "--n-heads", "4",
             "--kv-heads", "2", "--rope", "--d-ff", "128", "--max-seq",
             "24", "--requests", "3", "--prompt-len", "3:5",
             "--max-new-tokens", "5", "--slots", "2"]
    for extra in ([], ["--use-ema"]):
        args = cli.build_parser().parse_args(
            ["serve", "--device", "cpu", "--ckpt-dir", ckpt, *model,
             *extra])
        _report, results, engine = cli.run_serve(args)
        like = {k: v for k, v in engine.params.items()}
        _, want_params, _ = CheckpointManager(CheckpointConfig(ckpt)
                                              ).restore_params(
            like, item="ema" if extra else "params")
        for rid, (toks, _) in results.items():
            req = cli.make_requests(args, 3, 5)[rid]
            ref = generate(want_params, torch.tensor([req.prompt]),
                           engine.cfg, steps=5)[0].tolist()
            assert toks == ref
    assert cli.main(["serve", "--device", "cpu", "--ckpt-dir",
                     str(tmp_path / "none"), *model]) == 2
    assert "no checkpoint found" in capsys.readouterr().err


# -- expert and tensor parallelism (ROADMAP A7 part 1) ----------------------

@pytest.mark.parametrize("flags,mesh", [
    (["--tp", "2"], "dp=1 tp=2 sp=1 pp=1 ep=1"),
    (["--ep", "2", "--moe-experts", "4"], "dp=1 tp=1 sp=1 pp=1 ep=2")])
def test_train_tp_and_ep_print_the_jax_step_lines(capfd, flags, mesh):
    """``train --tp 2`` and ``--ep 2 --moe-experts 4`` on two gloo ranks:
    rank 0 alone prints the JAX command's mesh line and step lines."""
    assert cli.main(TRAIN_TINY + ["--log-every", "1"] + flags) == 0
    out = capfd.readouterr().out.strip().splitlines()
    steps = [ln for ln in out if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == [
        "step    1", "step    2", "step    3"]
    assert all("loss" in ln and "tok/s)" in ln for ln in steps)
    assert sum(ln.startswith(f"mesh {mesh}; batch=") for ln in out) == 1
    assert ("moe_experts=4" in "".join(out)) == ("--moe-experts" in flags)


@pytest.mark.parametrize("flags,match", [
    (["--dp", "0", "--tp", "2"], "dp*tp*sp*pp*ep = 2 != 1 devices"),
    (["--pp", "2", "--grad-accum", "2"],
     "--grad-accum does not compose with --pp"),
    (["--pp", "3"], "pp=3 must divide n_layers=2"),
    (["--pp", "2", "--pp-schedule", "1f1b", "--moe-experts", "4",
      "--moe-every", "1"], "dense layers only"),
    (["--microbatches", "2"], "--microbatches requires --pp > 1"),
    (["--pp", "2", "--moe-experts", "4", "--moe-every", "2"],
     "--pp > 1 needs homogeneous layers"),
    (["--tp", "2", "--steps-per-dispatch", "2", "--deadline-ms", "50"],
     "single-process exact path"),
    (["--tp", "3"], "tp=3 must divide n_heads=4"),
    (["--ep", "3", "--moe-experts", "4", "--batch", "6"],
     "ep=3 must divide n_experts=4"),
    (["--ep", "2", "--moe-experts", "4", "--batch", "3"],
     "must divide over 2 data ranks (dp x ep)"),
    (["--dp", "2", "--sp", "2", "--ep", "2", "--moe-experts", "2",
      "--grad-quant", "ef8", "--grad-schedule", "hierarchical"],
     "needs exactly two >1 data axes")])
def test_train_mesh_refusals_exit_2(capsys, flags, match):
    assert cli.main(TRAIN_TINY + flags) == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("flags,line", [
    (["--tp", "2", "--deadline-ms", "50", "--straggle-prob", "0.5"],
     "lossy rounds:"),
    (["--pp", "2", "--deadline-ms", "50", "--straggle-prob", "0.5"],
     "lossy rounds:"),
    (["--ep", "2", "--moe-experts", "4", "--steps-per-dispatch", "2"],
     "step    3:")], ids=["tp-deadline", "pp-deadline", "ep-chunks"])
def test_train_deadlines_and_chunks_run_on_sharded_meshes(capfd, flags,
                                                          line):
    """``--deadline-ms`` with ``--tp`` / ``--pp`` and
    ``--steps-per-dispatch`` with ``--ep`` run on two gloo ranks: rank 0
    prints the deadline's ``[masked k/n ranks ...]`` step lines and its
    summary, or the chunks' step lines (the last chunk's step)."""
    assert cli.main(TRAIN_TINY + ["--log-every", "1"] + flags) == 0
    out = capfd.readouterr().out
    assert line in out
    if "--deadline-ms" in flags:
        steps = [ln for ln in out.splitlines() if ln.startswith("step ")]
        assert len(steps) == 3
        assert all("[masked " in ln and "/1 ranks" in ln for ln in steps)


def test_train_chunks_on_tp_checkpoint_the_full_layout(tmp_path):
    """``--tp 2 --steps-per-dispatch 2 --ckpt-dir``: a checkpoint at a
    chunk's end holds the full layout (wq whole), as the per-step run's
    does, and the run resumes from it at tp=2 with the per-step run's
    losses."""
    flags = ["--tp", "2", "--steps-per-dispatch", "2", "--ckpt-every",
             "2", "--log-every", "1"]
    chunked = cli.run_train(cli.build_parser().parse_args(
        TRAIN_TINY + flags + ["--steps", "2", "--ckpt-dir",
                              str(tmp_path / "c")]))
    params = torch.load(tmp_path / "c" / "1" / "params.pt",
                        weights_only=True)
    assert tuple(params["layers"][0]["wq"].shape) == (64, 64)
    resumed = cli.run_train(cli.build_parser().parse_args(
        TRAIN_TINY + flags + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "c")]))
    assert resumed["config"]["start_step"] == 2
    plain = cli.run_train(cli.build_parser().parse_args(
        TRAIN_TINY + ["--tp", "2", "--steps", "4"]))
    np.testing.assert_allclose(chunked["losses"] + resumed["losses"],
                               plain["losses"], rtol=1e-6)


def test_moe_checkpoint_runs_generate_eval_and_serve(capsys, tmp_path):
    """An MoE model trained at ep=2 (its checkpoint in the full layout)
    decodes with ``generate``, scores with ``eval`` and serves with
    ``serve`` at one rank on the CPU, each given the MoE flags."""
    ckpt = str(tmp_path / "moe")
    moe = ["--moe-experts", "4", "--moe-every", "2", "--router-k", "2",
           "--capacity-factor", "2.0"]
    assert cli.main(TRAIN_TINY + moe + ["--ep", "2", "--steps", "2",
                                        "--ckpt-dir", ckpt]) == 0
    model = ["--vocab", "61", "--d-model", "64", "--n-heads", "4",
             "--kv-heads", "2", "--rope", "--d-ff", "128", *moe]
    capsys.readouterr()
    assert cli.main(["generate", "--device", "cpu", "--ckpt-dir", ckpt,
                     *model, "--max-seq", "24", "--prompt-tokens", "1,2,3",
                     "--tokens", "5"]) == 0
    toks = capsys.readouterr().out.strip().split(",")
    assert len(toks) == 5 and all(0 <= int(t) < 61 for t in toks)
    corpus = tmp_path / "c.bin"
    np.random.default_rng(0).integers(0, 61, 200).astype("<u2").tofile(
        corpus)
    assert cli.main(["eval", "--device", "cpu", "--ckpt-dir", ckpt, *model,
                     "--max-seq", "24", "--data-file", str(corpus)]) == 0
    assert np.isfinite(json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])[
        "ce_nats_per_token"])
    assert cli.main(["serve", "--device", "cpu", "--ckpt-dir", ckpt, *model,
                     "--max-seq", "24", "--requests", "3", "--prompt-len",
                     "3:5", "--max-new-tokens", "4", "--slots", "2",
                     "--paged", "--page-size", "4", "--paged-attention",
                     "kernel"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"]["completed"] == 3


def test_tp_checkpoint_restores_at_one_rank_and_resumes(capfd, tmp_path):
    """``train --tp 2 --ckpt-dir`` saves the full, unsharded layout: one
    rank restores it (its params the tp=1 run's from the same seed within
    1e-5, on sgd with global-norm clipping), ``generate`` decodes from it
    at one rank, and a tp=2 run that resumes from its step-1 checkpoint
    ends bitwise where the uninterrupted run ended (losses and
    checkpointed params)."""
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    from akka_allreduce_tpu_torch.runtime.checkpoint import (
        CheckpointConfig, CheckpointManager)
    # sgd: an update linear in the gradient (adam's division by sqrt(v)
    # would magnify the f32 order of the tp sums where a gradient is
    # near 0); the clip reads the norm of the whole model
    base = TRAIN_TINY + ["--clip-norm", "0.5", "--optimizer", "sgd"]
    one, two, part = (str(tmp_path / n) for n in ("one", "two", "part"))
    r1 = cli.run_train(cli.build_parser().parse_args(
        base + ["--ckpt-dir", one]))
    r2 = cli.run_train(cli.build_parser().parse_args(
        base + ["--tp", "2", "--ckpt-dir", two, "--ckpt-every", "1"]))
    np.testing.assert_allclose(r2["losses"], r1["losses"], rtol=1e-5)
    cfg = cli.train_config(cli.build_parser().parse_args(base), 24).model
    like = init_transformer(torch.Generator().manual_seed(0), cfg)

    def restored(path):
        return tree_leaves(CheckpointManager(CheckpointConfig(path))
                           .restore_params(like)[1])
    for a, b in zip(restored(two), restored(one)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    capfd.readouterr()
    assert cli.main(["generate", "--device", "cpu", "--ckpt-dir", two,
                     "--vocab", "61", "--d-model", "64", "--n-heads", "4",
                     "--kv-heads", "2", "--rope", "--d-ff", "128",
                     "--max-seq", "24", "--prompt-tokens", "1,2",
                     "--tokens", "4"]) == 0
    assert len(capfd.readouterr().out.strip().split(",")) == 4
    # resume: the run's step-1 checkpoint alone, step 3 from it
    import shutil
    shutil.copytree(two, part)
    shutil.rmtree(os.path.join(part, "2"))
    resumed = cli.run_train(cli.build_parser().parse_args(
        base + ["--tp", "2", "--ckpt-dir", part]))
    assert resumed["config"]["start_step"] == 2
    assert resumed["losses"] == r2["losses"][2:]
    for a, b in zip(restored(part), restored(two)):
        assert torch.equal(a, b)


# -- pipeline parallelism (ROADMAP A7 part 2) --------------------------------

def test_train_pp_prints_the_jax_schedule_line(capfd):
    """``train --pp 2 --microbatches 2`` on two gloo ranks: rank 0 prints
    the JAX command's mesh line with the real microbatch count and its
    schedule line."""
    assert cli.main(TRAIN_TINY + ["--pp", "2", "--microbatches", "2",
                                  "--steps", "2", "--log-every", "1"]) == 0
    out = capfd.readouterr().out.strip().splitlines()
    assert sum(ln.startswith("mesh dp=1 tp=1 sp=1 pp=2 ep=1; batch=4 "
                             "seq=24 microbatches=2") for ln in out) == 1
    assert ("pp=2 x 2 microbatches, schedule gpipe: bubble gpipe 33.3% "
            "(resident 3 microbatches) | 1f1b 50.0% (resident 2)") in out
    assert [ln.split(":")[0] for ln in out if ln.startswith("step ")] == [
        "step    1", "step    2"]


def test_pp_checkpoint_restores_at_one_rank_and_resumes(capfd, tmp_path):
    """``train --pp 2 --ckpt-dir`` saves the gathered full list layout:
    its losses and params are the pp=1 run's within 1e-5, ``generate``
    at one rank decodes the same greedy tokens from either checkpoint,
    and its step-1 checkpoint (the adam moments in it) resumes at pp=1
    within 1e-5 of the pp=2 run's last loss and at pp=2 bitwise (losses
    and checkpointed params)."""
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    from akka_allreduce_tpu_torch.runtime.checkpoint import (
        CheckpointConfig, CheckpointManager)
    base = TRAIN_TINY + ["--batch", "4"]
    pp2 = ["--pp", "2", "--microbatches", "2"]
    one, two, part = (str(tmp_path / n) for n in ("one", "two", "part"))
    r1 = cli.run_train(cli.build_parser().parse_args(
        base + ["--ckpt-dir", one]))
    r2 = cli.run_train(cli.build_parser().parse_args(
        base + pp2 + ["--ckpt-dir", two, "--ckpt-every", "1"]))
    np.testing.assert_allclose(r2["losses"], r1["losses"], rtol=1e-5)
    cfg = cli.train_config(cli.build_parser().parse_args(base), 24).model
    like = init_transformer(torch.Generator().manual_seed(0), cfg)

    def restored(path):
        return tree_leaves(CheckpointManager(CheckpointConfig(path))
                           .restore_params(like)[1])
    for a, b in zip(restored(two), restored(one)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    tokens = []
    for path in (two, one):
        capfd.readouterr()
        assert cli.main(["generate", "--device", "cpu", "--ckpt-dir", path,
                         "--vocab", "61", "--d-model", "64", "--n-heads",
                         "4", "--kv-heads", "2", "--rope", "--d-ff", "128",
                         "--max-seq", "24", "--prompt-tokens", "1,2",
                         "--tokens", "6"]) == 0
        tokens.append(capfd.readouterr().out.strip().splitlines()[-1])
    assert tokens[0] == tokens[1] and len(tokens[0].split(",")) == 6
    import shutil
    shutil.copytree(two, part)
    shutil.rmtree(os.path.join(part, "2"))
    at_one = cli.run_train(cli.build_parser().parse_args(
        base + ["--ckpt-dir", part]))
    assert at_one["config"]["start_step"] == 2
    np.testing.assert_allclose(at_one["losses"], r2["losses"][2:],
                               rtol=1e-5)
    shutil.rmtree(part)
    shutil.copytree(two, part)
    shutil.rmtree(os.path.join(part, "2"))
    at_two = cli.run_train(cli.build_parser().parse_args(
        base + pp2 + ["--ckpt-dir", part]))
    assert at_two["config"]["start_step"] == 2
    assert at_two["losses"] == r2["losses"][2:]
    for a, b in zip(restored(part), restored(two)):
        assert torch.equal(a, b)


def test_pp_stacked_jax_train_state_converts_to_the_ports(tmp_path):
    """A JAX training checkpoint of a pp=2 run (its layers stacked: the
    params and adafactor's stacked ``v_row`` / ``v_col``) goes through
    ``convert.train_state_from_jax`` into the list layout, and equals
    the port's own state after the same step at pp=2 (``full_layout``),
    from the same weights and batch: params within 1e-5, moments within
    1e-4 relative, the counts equal."""
    import importlib.util

    import jax
    import jax.numpy as jnp

    from akka_allreduce_tpu.models import train as jtrain
    from akka_allreduce_tpu.models import transformer as jtf
    from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
    from akka_allreduce_tpu.parallel.pp import unstack_layer_params
    from akka_allreduce_tpu.runtime.checkpoint import (CheckpointConfig,
                                                       CheckpointManager)
    from akka_allreduce_tpu_torch import convert
    from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

    from torch_pp_ranks import mesh_cases
    model = dict(vocab_size=256, d_model=128, n_heads=4, n_layers=2,
                 d_ff=256, max_seq=16)
    kw = dict(bucket_elems=256, optimizer="adafactor", learning_rate=1e-2,
              attn_impl="local", microbatches=2)
    tokens = np.random.default_rng(0).integers(0, 256, size=(4, 16),
                                               dtype=np.int32)
    mesh = make_device_mesh(MeshSpec(pp=2), devices=jax.devices()[:2])
    jcfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**model), **kw)
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0),
                                                     jcfg, mesh)
    init = jax.tree.map(np.asarray, dict(params, layers=unstack_layer_params(
        params["layers"], model["n_layers"])))
    step = jtrain.make_train_step(jcfg, mesh, opt, donate=False)
    params, opt_state, _ = step(params, opt_state, jnp.asarray(tokens))
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path / "jax")))
    mgr.save(0, params, opt_state, {"data_step": 0}, force=True)
    mgr.wait_until_finished()
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
        / "orbax_to_torch.py"
    spec = importlib.util.spec_from_file_location("orbax_to_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    _, items = script.read_orbax_step(str(tmp_path / "jax"))
    assert isinstance(items["params"]["layers"], dict)  # stacked
    cfg = cli.train_config(cli.build_parser().parse_args(
        ["train", "--optimizer", "adafactor", "--d-model", "128",
         "--vocab", "256", "--d-ff", "256", "--n-layers", "2",
         "--bucket-elems", "256"]), 16)
    conv = convert.train_state_from_jax(items, cfg)
    port = spawn_ranks(mesh_cases, 2, "gloo", "cpu", [
        ("train_state_case", {"pp": 2}, (model, kw, init, tokens))])[0][0]
    for a, b in zip(tree_leaves(conv["params"]),
                    tree_leaves(port["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    got, want = conv["opt_state"]["optimizer"], port["opt"]
    assert conv["opt_state"]["count"] == 1
    assert [g["params"] for g in got["param_groups"]] == [
        g["params"] for g in want["param_groups"]]
    assert sorted(got["state"]) == sorted(want["state"])
    for j, per in want["state"].items():
        assert sorted(got["state"][j]) == sorted(per)
        for k, v in per.items():
            if v.dim():
                np.testing.assert_allclose(
                    got["state"][j][k].numpy(), v.numpy(), rtol=1e-4,
                    atol=1e-4 * float(v.abs().max()), err_msg=f"{j} {k}")
            else:
                assert float(got["state"][j][k]) == float(v)


COORD = ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
         "--process-id", "0"]


@pytest.mark.parametrize("flags,local", [
    (COORD + ["--deadline-ms", "50", "--tp", "2"], 2),
    (COORD + ["--deadline-ms", "50", "--ep", "2", "--moe-experts", "4"], 2),
    (COORD + ["--deadline-ms", "50", "--pp", "2"], 2)],
    ids=["hybrid-tp", "hybrid-ep", "hybrid-pp"])
def test_train_coordinator_local_meshes_accepted(flags, local):
    """The hybrid on a local tp / ep / pp mesh (ROADMAP A9 part 2): the
    flags pass every check before a store is joined; each process's
    local mesh is its tp x ep x pp ranks, over its rows of the batch."""
    args = cli.build_parser().parse_args(TRAIN_TINY + flags)
    b, _t, backend = cli._check_train_flags(args)
    assert cli.is_hybrid(args) and backend == "gloo"
    assert args.dp * args.sp * args.ep * args.tp * args.pp == local
    assert b % (args.num_processes * args.dp * args.ep) == 0


@pytest.mark.parametrize("flags,match", [
    (COORD + ["--deadline-ms", "50", "--steps-per-dispatch", "2"],
     "single-process exact path (no --deadline-ms / --coordinator)"),
    (COORD + ["--steps-per-dispatch", "2", "--dp", "2"],
     "single-process exact path (no --deadline-ms / --coordinator)"),
    (COORD + ["--deadline-ms", "50", "--guard-recompiles"],
     "--guard-recompiles needs the per-step loop"),
    (["--guard-recompiles"], "ROADMAP A11"),
    (["--coordinator", "127.0.0.1:1"], "needs --num-processes"),
    (["--num-processes", "2"], "need --coordinator"),
    (COORD[:4] + ["--process-id", "2"], "must be in 0..1"),
    (COORD + ["--dp", "3"], "must divide over --num-processes 2")],
    ids=["hybrid-chunks", "exact-chunks", "hybrid-guard", "guard",
         "no-count", "no-coord", "bad-id", "exact-mesh"])
def test_train_coordinator_refusals_exit_2(capsys, flags, match):
    """What ``--coordinator`` refuses before any store is joined (the
    JAX command's refusals)."""
    assert cli.main(TRAIN_TINY + flags) == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    "coordinator", "num_processes", "process_id", "retain_rounds",
    "th_allreduce", "down_after", "dcn_bucket_elems", "master_timeout_s",
    "trace_file", "guard_recompiles"])
def test_train_a9_flags_match_the_jax_command(flag):
    from akka_allreduce_tpu import cli as jax_cli
    jax_parser = argparse.ArgumentParser()
    sub = jax_parser.add_subparsers(dest="cmd")
    jax_cli._add_train(sub)
    want = _flags(_subparser(jax_parser, "train"))[flag]
    got = _flags(_subparser(cli.build_parser(), "train"))[flag]
    assert got[:2] + got[3:] == want[:2] + want[3:]
