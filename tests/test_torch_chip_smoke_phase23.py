"""Phase 23 of ``chip_smoke.py`` (``train --steps-per-dispatch`` across
ranks: CUDA-graph chunks on the ipc transport, ROADMAP A5 part 2)
rehearsed at a tiny size on the CPU, with its helpers.

On the CPU the chunks run step by step on gloo ranks (no graph, no
transport, no launch counted), so the rehearsal holds what the phase
computes around them: every graphed run against its eager reference
bitwise (f32, ef8 and int8 at dp=2, gqa4 at sp=2), the resume at the
chunk boundary bitwise the uninterrupted run, and the fault control (one
rank's rounding seeds a step off) outside the check. The transport
counts a replay is held to on the card come from the step's calls, which
are pinned against a recorded step on gloo ranks, and at the flagship
against what the card counted (12 calls, 216 stretches and 216 stream
waits a replay on f32; 18, 84 and 84 on ef8 and int8). One
file a phase, so that ``--dist loadfile`` spreads the rehearsals; each
runs on one intra-op thread (``tests/torch_rehearsal.py``).
"""

import json

import numpy as np
import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY_DP = ["train", "--d-model", "64", "--n-heads", "4", "--n-layers", "2",
           "--d-ff", "128", "--vocab", "97", "--seq", "16", "--batch", "4",
           "--lr", "1e-3", "--steps", "3", "--log-every", "1", "--device",
           "cpu", "--dp", "2", "--dist-backend", "gloo"]
TINY_SP = ["train", "--d-model", "64", "--n-heads", "4", "--kv-heads", "2",
           "--rope", "--n-layers", "4", "--d-ff", "128", "--vocab", "97",
           "--seq", "32", "--batch", "2", "--bf16", "--lr", "1e-3",
           "--steps", "3", "--log-every", "1", "--device", "cpu"]


def test_phase23_rehearsal(monkeypatch, capfd):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "DP_ARGV", TINY_DP)
    monkeypatch.setattr(chip_smoke, "SP_ARGV", TINY_SP)
    out = chip_smoke.phase_a5_ranks(torch)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a5_ranks')]
    by = {}
    for ln in lines:
        by.setdefault(ln["phase"], []).append(ln)
    graphs = {ln["run"]: ln for ln in by["a5_ranks_graph"]}
    assert set(graphs) == {"none", "ef8", "int8", "gqa4 sp=2 bf16"}
    for row in graphs.values():
        assert row["losses_bitwise"] and row["params_bitwise"]
        assert len(row["losses"]) == row["steps"]
        assert row["replays"] == [0, 0]  # the CPU captures nothing
    assert graphs["ef8"]["residuals_bitwise"]
    assert graphs["gqa4 sp=2 bf16"]["steps"] == 2 * chip_smoke.A5R_SP_SPD
    resume = by["a5_ranks_resume"][0]
    assert resume["resumed_start_step"] == chip_smoke.A5R_SPD
    assert resume["losses_bitwise"] and resume["residuals_bitwise"]
    control = by["a5_ranks_control"][0]
    assert not control["control_passed"]
    assert control["control_losses"][0] == control["eager_losses"][0]
    assert out["transport"] == 0
    assert out["sync"] == dict.fromkeys(chip_smoke.SYNC_KERNELS, 0)


def test_phase23_argv_helpers():
    argv = chip_smoke.a5r_argv(chip_smoke.DP_ARGV, 6, "ef8", 3)
    assert argv[argv.index("--steps") + 1] == "6"
    assert argv[argv.index("--steps-per-dispatch") + 1] == "3"
    assert argv[argv.index("--grad-quant") + 1] == "ef8"
    assert argv[argv.index("--lr-schedule") + 1] == "cosine"
    assert argv[argv.index("--dist-backend") + 1] == "ipc"
    two = chip_smoke.with_layers(chip_smoke.SP_ARGV, 2)
    assert two[two.index("--n-layers") + 1] == "2"
    assert chip_smoke.SP_ARGV[chip_smoke.SP_ARGV.index("--n-layers")
                              + 1] == "8"


@pytest.mark.parametrize("wire", ["none", "int8", "ef8"])
def test_phase23_step_calls_are_a_recorded_steps(wire):
    """``dp_step_transport_calls`` against the collectives one train step
    makes on two gloo ranks (the calls a chunk's graph captures)."""
    from akka_allreduce_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer)
    from akka_allreduce_tpu_torch.ops.bucketing import tree_bucket_spec
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    from torch_multi_step_ranks import step_calls
    model = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                 max_seq=16)
    kw = {"bucket_elems": 512, "learning_rate": 1e-2,
          "grad_transport": "f32" if wire == "none" else wire}
    tokens = np.random.default_rng(0).integers(0, 61, size=(4, 16),
                                               dtype=np.int32)
    got = spawn_ranks(step_calls, 2, "gloo", "cpu", model, kw, tokens)
    spec = tree_bucket_spec(init_transformer(
        torch.Generator().manual_seed(0), TransformerConfig(**model)), 512)
    want = chip_smoke.dp_step_transport_calls(spec.num_buckets, 512, 2,
                                              wire)
    assert got[0] == got[1] == want


@pytest.mark.parametrize("wire,calls,stretches,copies,waits", [
    ("none", 12, 216, 228, 216), ("ef8", 18, 84, 102, 84),
    ("int8", 18, 84, 102, 84)])
def test_phase23_a_flagship_replays_transport_counts(wire, calls, stretches,
                                                     copies, waits):
    """At the flagship (541,130,752 params: 8,257 buckets of 65,536) a
    replay of 3 steps on rank 0 of two enqueues, in 64 MiB chunks, what
    the card's run counted."""
    buckets = -(-541_130_752 // chip_smoke.BUCKET_ELEMS)
    got = chip_smoke.replay_transport_counts(
        chip_smoke.dp_step_transport_calls(buckets, chip_smoke.BUCKET_ELEMS,
                                           2, wire),
        2, chip_smoke.A5R_SPD, chip_smoke.chunk_of(2))
    assert chip_smoke.chunk_of(2) == 64 << 20
    assert (got["transport_calls"], got["transport_launches"],
            got["transport_copies"], got["stream_waits"]) == (
        calls, stretches, copies, waits)
