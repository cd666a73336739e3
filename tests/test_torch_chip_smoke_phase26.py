"""Phase 26 of ``chip_smoke.py`` (pipeline parallelism, ROADMAP A7 part
2) rehearsed at a tiny size on the CPU, on gloo ranks.

Every check of (a)-(d) passes on the plain versions: (a) gpipe and 1f1b
at pp=2 give the one-rank step's gradients within the phase's bound,
and the control (the two stages' layers swapped) lands above its floor;
(b) and (c) train both schedules with finite losses, the transfers
along pp counted a step (gpipe: one each way a tick, m + s - 1 ticks
each way; 1f1b: two a tick over m + 2(s - 1) ticks), the schedule stats
in the report and the launch counts the CPU implies (none); the peak
check of (c) needs the card's allocator and is left to it; (d) a
one-rank ``cli generate`` process restores the pp=2 checkpoint's
tokens, and the control (the stages swapped) differs. The batches run
in one ``RankPool`` of two ranks, as on the card, with the kernel
launch counts zeroed by the phase's own runs. One file a phase, so that
``--dist loadfile`` spreads the rehearsals; it runs on one intra-op
thread (``tests/torch_rehearsal.py``).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY = ["train", "--d-model", "32", "--n-heads", "4", "--n-layers", "4",
        "--d-ff", "64", "--vocab", "97", "--seq", "16", "--batch", "8",
        "--lr", "1e-3", "--steps", "3", "--log-every", "1", "--device",
        "cpu"]


def test_phase26_rehearsal(monkeypatch, capfd):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "A7PP_PARITY_MODEL", dict(
        vocab_size=97, d_model=32, n_heads=4, n_layers=4, d_ff=64,
        max_seq=16))
    monkeypatch.setattr(chip_smoke, "A7_PARITY_BATCH", (2, 16))
    monkeypatch.setattr(chip_smoke, "A7PP_ARGV", TINY)
    monkeypatch.setattr(chip_smoke, "A7PP_CKPT_ARGV", chip_smoke.set_flag(
        chip_smoke.set_flag(chip_smoke.set_flag(TINY, "--steps", 2),
                            "--seq", 32), "--n-layers", 2))
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    try:
        out = chip_smoke.phase_a7pp(torch)
    finally:
        chip_smoke.close_pools()
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a7pp_')]
    by = {}
    for ln in lines:
        by.setdefault(ln["phase"], []).append(ln)
    (parity,) = by["a7pp_parity"]
    assert parity["held"] and parity["control_outside"]
    assert max(parity["gpipe_rel_err"], parity["1f1b_rel_err"]) < 1e-5
    assert parity["control_rel_err"] > 1e-1
    train = {ln["run"]: ln for ln in by["a7pp_train"]}
    assert set(train) == {"gpipe m=4", "1f1b m=4", "gpipe m=8", "1f1b m=8"}
    s = 2
    for name, row in train.items():
        sched, m = row["schedule"], row["microbatches"]
        ticks = (2 * (m + s - 1) if sched == "gpipe"
                 else 2 * (m + 2 * (s - 1)))
        for rank in row["exchanges"]:
            assert rank["pp_ppermute"]["calls_per_step"] == ticks, name
            assert rank["pp_ppermute"]["ms_per_step"] == "not measured"
        assert row["mesh"] == "dp=1 tp=1 sp=1 pp=2 ep=1"
        assert row["pp_schedule_stats"]["1f1b"]["resident_microbatches"] \
            == min(m, 2 * s - 1)
        assert len(row["losses"]) == row["steps"]
        assert row["launches"] == row["expected_launches"]
    assert "a7pp_memory" not in by  # the card's allocator only
    (ckpt,) = by["a7pp_checkpoint"]
    assert ckpt["equal"] and not ckpt["control_equal"]
    assert out["flash"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert out["masked_reduce"] == 0 and out["transport"] == 0


def test_phase26_expected_launches():
    """A rank's rows 1 and 10-12 on the card at the flagship's 8 layers
    on two stages, 4 microbatches, 3 steps: gpipe 16 launches of each
    flash kernel a step, 1f1b 32 of the forward (its recompute) and 16
    of the others; one masked reduce a step (the pp sum of the non-layer
    gradients)."""
    assert chip_smoke.DEVICE == "cuda"
    gpipe = chip_smoke.a7pp_expected_launches("gpipe", 8, 4, 3)
    one_f = chip_smoke.a7pp_expected_launches("1f1b", 8, 4, 3)
    assert gpipe["flash"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 48)
    assert one_f["flash"] == {"flash_fwd": 96, "flash_dq": 48,
                              "flash_dkv": 48}
    assert gpipe["masked_reduce"] == one_f["masked_reduce"] == 3
