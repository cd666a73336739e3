"""Phase 28 (c), (d) and (e) of ``chip_smoke.py`` (training across
processes, ROADMAP A9 part 2) rehearsed at a tiny size on the CPU.

The plan's arithmetic first: on the card's argv the straggle draws of
three processes at batch 15 x 640 make process 2 late in rounds 1 and 2
and no other worker late in 5 rounds; the new checks' limits fit the
script's budget. Then every check of (c) and (d) on the plain versions,
on the world-4 pool's gloo ranks as on the card: two processes, each a
local tp=2 mesh (a tp line of the pool), against ``--dp 2 --tp 2``; three
processes with process 2 masked, auto-downed and caught up, at the
card's deadline factor and floor; and (e)'s codec on a small vector in a
process of its own, as beside the card's build.
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY = ["train", "--d-model", "256", "--n-heads", "2", "--n-layers", "2",
        "--d-ff", "1024", "--vocab", "97", "--seq", "32", "--batch", "4",
        "--lr", "1e-2", "--steps", "3", "--log-every", "1", "--device",
        "cpu"]
# this PR's slower archive run of the whole script on the card and (c) and
# (d)'s part of it (PERF.md §5, "The script": NVIDIA H100 80GB HBM3, 700 W),
# the script's aim, which leaves room for a 1.3x slower host under the
# limit, and the limit the script must end within
MEASURED_S, MESH_S, TARGET_S, LIMIT_S = 844.1, 42.5, 940.0, 1200.0


def test_phase28_mesh_plan_on_the_cards_argv():
    from akka_allreduce_tpu_torch import cli
    batch, seq, steps = chip_smoke.A9D_SHAPE
    argv = chip_smoke.set_flag(chip_smoke.A9_ARGV, "--seq", seq)
    vocab = cli.build_parser().parse_args(argv).vocab
    draws = chip_smoke.straggle_draws(steps, chip_smoke.A9D_PROCS, batch,
                                      seq, vocab)
    prob, late = chip_smoke.a9_two_late(draws)
    assert late == 1
    assert [[bool(d < prob) for d in row[1:]] for row in draws] == [
        [False, False], [False, True], [False, True], [False, False],
        [False, False]]
    assert batch % chip_smoke.A9D_PROCS == 0
    # the budget: the script within its aim, and (c) and (d) stopped by
    # their limit before a run of theirs takes it past the script's
    assert MEASURED_S <= TARGET_S
    assert MEASURED_S - MESH_S + chip_smoke.A9_MESH_SECONDS <= LIMIT_S
    # (e)'s process, joined after the build, waits at most twice its
    # limit from the script's start
    assert MEASURED_S + 2 * chip_smoke.A9_CODEC_SECONDS <= LIMIT_S


def test_phase28_mesh_rehearsal(monkeypatch, capfd):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    monkeypatch.setattr(chip_smoke, "A9_ARGV", TINY)
    monkeypatch.setattr(chip_smoke, "A9D_SHAPE", (12, 32, 5))
    monkeypatch.setattr(chip_smoke, "A9_MESH_SECONDS", 600)
    monkeypatch.setattr(chip_smoke, "A9_CODEC_ELEMS", 200_000)
    codec = chip_smoke.a9_codec_start()
    try:
        out = chip_smoke.phase_a9_mesh(torch)
    finally:
        chip_smoke.close_pools()
    row = chip_smoke.a9_codec_join(codec)
    lines = {json.loads(ln)["phase"]: json.loads(ln)
             for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a9_')}
    mesh = lines["a9_mesh"]
    assert max(mesh["rel_err"]) <= chip_smoke.A9_LOSS_TOL
    assert mesh["n_masked"] == [[0, 0, 0], [0, 0, 0]]
    assert mesh["crcs_equal"] and mesh["checksums_equal"]
    assert mesh["local_losses_equal"]
    for split in mesh["split"].values():
        assert split["gather_ms"] >= 0 and split["bcast_ms"] >= 0
    three = lines["a9_three"]
    assert three["late_rounds"] == [1, 2]
    # the card's floor: (c)'s rounds are ms here
    assert three["deadline_ms"] == chip_smoke.A9_DEADLINE_FLOOR_MS
    assert three["downed"][2] == [2]
    assert sum(three["caught_up"]) > 0 and "reupped_at" in three
    assert three["crcs_equal"] and three["losses_equal"]
    assert three["counts_as_masked"]
    assert three["bucket_counts"][:3] == [[3], [2], [2]]
    assert set(lines["a9_mesh_phase_seconds"]["parts"]) == {
        "dp2_tp2_reference", "c", "d"}
    assert out["flash_f32"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert out["masked_reduce"] == 0
    assert row["within_one_step"] and row["encode_rss_gb"] >= 0
    assert lines["a9_int8_codec"]["elems"] == 200_000
    assert lines["a9_int8_codec"]["beside"] == "build"
