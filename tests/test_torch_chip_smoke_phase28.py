"""Phase 28 of ``chip_smoke.py`` (training across processes, ROADMAP A9
part 1) rehearsed at a tiny size on the CPU.

The plan's arithmetic first: on the card's argv the straggle draws of
process 1 (``default_rng(step)`` after the global batch) make round 1
the one late round, with round 2 after it for the control; the phase's
limit fits the script's budget beside the rest of the script. Then every
check of (a) and (b) on the plain versions: two ``cli train
--coordinator --deadline-ms`` child processes at the phase's flags
against ``--dp 2`` on gloo ranks (the rank pool of two, as on the card),
the straggling process masked in the predicted round on both
processes, the control outside the bound, the full-width run's round
split, and the kernel launch counts those of the CPU (none).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY = ["train", "--d-model", "32", "--n-heads", "2", "--n-layers", "2",
        "--d-ff", "64", "--vocab", "97", "--seq", "32", "--batch", "4",
        "--lr", "1e-2", "--steps", "3", "--log-every", "1", "--device",
        "cpu"]
# the whole script's slowest run on the card before phase 28 (PERF.md
# §5, "The script": NVIDIA H100 80GB HBM3, 700 W) and the limit the
# script must end within
SCRIPT_S, LIMIT_S = 934.1, 1200.0


def test_phase28_plan_on_the_cards_argv():
    from akka_allreduce_tpu_torch import cli
    base = cli.build_parser().parse_args(chip_smoke.A9_ARGV)
    draws = chip_smoke.straggle_draws(base.steps, chip_smoke.A9_PROCS,
                                      base.batch, base.seq, base.vocab)
    prob, late = chip_smoke.a9_straggle(draws[:, 1])
    assert late == 1
    assert [bool(d < prob) for d in draws[:, 1]] == [False, True, False]
    # the flagship's 8 layers: rows 10-12 launch once a layer a step
    full = cli.build_parser().parse_args(chip_smoke.A9_FULL_ARGV)
    assert full.n_layers * chip_smoke.A9_FULL_STEPS == 24
    assert full.bf16_grads and full.dcn_bucket_elems == 0
    assert SCRIPT_S + chip_smoke.A9_SECONDS < LIMIT_S


def test_phase28_rehearsal(monkeypatch, capfd):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    monkeypatch.setattr(chip_smoke, "A9_ARGV", TINY)
    monkeypatch.setattr(chip_smoke, "A9_FULL_ARGV", TINY + [
        "--bf16-grads", "--max-lag", "0", "--retain-rounds", "8",
        "--deadline-ms", "60000"])
    monkeypatch.setattr(chip_smoke, "A9_DEADLINE_FLOOR_MS", 1500.0)
    monkeypatch.setattr(chip_smoke, "A9_SECONDS", 600)
    try:
        out = chip_smoke.phase_a9(torch)
    finally:
        chip_smoke.close_pools()
    lines = {json.loads(ln)["phase"]: json.loads(ln)
             for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a9_')}
    parity = lines["a9_parity"]
    assert max(parity["rel_err"]) <= chip_smoke.A9_LOSS_TOL
    assert parity["n_masked"] == [[0, 0, 0], [0, 0, 0]]
    straggle = lines["a9_straggle"]
    assert straggle["late_round"] == 1
    assert straggle["n_masked"] == [[0, 1, 0], [0, 1, 0]]
    assert straggle["worker_valid_peers"] == [True, False]
    assert straggle["checksums_equal"]
    assert straggle["control_rel_err"] > chip_smoke.A9_LOSS_TOL
    # the round before the late one is (a1)'s; the late round reports
    # process 0's loss alone
    assert straggle["losses"][0] == parity["losses"][0]
    full = lines["a9_full_width"]
    for split in full["split"].values():
        assert split["set_mb_per_s"] > 0 and split["payload_gb"] > 0
        assert split["peak_rss_gb"] > 0
    assert full["masked_reduce_launches"] == [0, 0]
    assert out["flash"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert out["flash_f32"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert set(lines["a9_phase_seconds"]["parts"]) == {
        "dp2_reference", "a1", "a2", "b"}
