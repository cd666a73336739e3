"""Phase 21 of ``chip_smoke.py`` (the A5 training paths: optimizer
families, EMA, overlapped accumulation, CUDA-graph chunks on one rank,
telemetry) rehearsed at a tiny size on the CPU.

One file a phase, so that ``--dist loadfile`` spreads the rehearsals
over the workers; each runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402


A5_TINY = ["train", "--d-model", "32", "--n-heads", "4", "--n-layers", "2",
           "--d-ff", "64", "--vocab", "97", "--seq", "16", "--batch", "4",
           "--lr", "1e-3", "--steps", "6", "--log-every", "1", "--device",
           "cpu"]


def test_phase21_rehearsal(monkeypatch, capfd):
    """Phase 21 at a tiny size on the CPU (gloo ranks, the generate /
    eval processes on --device cpu; the CPU wrappers count no launch):
    every part's checks pass, the fault control lands outside the bound,
    and the lines carry what PERF.md reads."""
    from akka_allreduce_tpu_torch import cli
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "TRAIN_ARGV", A5_TINY)
    monkeypatch.setattr(chip_smoke, "DP_ARGV", chip_smoke.with_steps(
        A5_TINY, 3) + ["--dp", "2", "--dist-backend", "gloo",
                       "--bucket-elems", "256"])
    monkeypatch.setattr(chip_smoke, "A5_EVAL_WINDOWS", 4)
    monkeypatch.setattr(chip_smoke, "A5_EVAL_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "A5_PROMPT_TOKENS", 4)
    monkeypatch.setattr(chip_smoke, "A5_GENERATE_TOKENS", 4)
    monkeypatch.setattr(chip_smoke, "A5_SECONDS", 600)
    monkeypatch.setattr(chip_smoke, "expected_sync_launches",
                        lambda *a, **k: dict.fromkeys(
                            chip_smoke.SYNC_KERNELS, 0))
    report = cli.run_train(cli.build_parser().parse_args(A5_TINY))
    trained = {"losses": report["losses"],
               "wall_ms_per_step": report["wall_ms_per_step"],
               "optimizer_state_gb": report["optimizer_state_gb"],
               "idle_share": "not measured"}
    out = chip_smoke.phase_a5(torch, trained)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    by = {}
    for ln in lines:
        by.setdefault(ln["phase"], []).append(ln)
    assert [r["optimizer"] for r in by["a5_family"]] == ["lion", "adafactor",
                                                        "sgd"]
    assert [r["optimizer"] for r in by["a5_update"]] == ["lion", "adafactor",
                                                        "sgd"]
    ema = by["a5_ema"][0]
    assert ema["subprocess_rcs"] == {"generate": 0, "eval": 0, "control": 2}
    assert ema["ema_item_bitwise"] and len(ema["save_seconds"]) == 2
    checks = by["a5_overlap_checks"][0]
    assert checks["step0_bitwise"]
    assert max(checks["control_rel_diff"][1:]) > checks["loss_rtol"]
    assert len(by["a5_overlap"]) == 4
    assert by["a5_graph"][0]["bitwise_eager"]
    assert by["a5_telemetry"][0]["train_steps_total"] == 3
    assert out["flash"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
