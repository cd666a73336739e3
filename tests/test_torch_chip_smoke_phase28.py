"""Phase 28 of ``chip_smoke.py`` (training across processes, ROADMAP A9
part 1) rehearsed at a tiny size on the CPU.

The plan's arithmetic first: (a)'s depth and steps, (b)'s launches a
process, and the phase's limit beside the rest of the script. Then
every check of (a) and (b) on the plain versions: two ``cli train
--coordinator --deadline-ms`` processes at the phase's flags against
``--dp 2`` on gloo ranks (the rank pool of two, as on the card), the
full-width run's round split, and the kernel launch counts those of the
CPU (none). The straggling process is (d)'s, three processes:
``tests/test_torch_chip_smoke_phase28_mesh.py``.
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
    # A9_MODEL at 2 layers ((c)'s), (a) cut to 1, 2 steps; the straggling
    # process is (d)'s (tests/test_torch_chip_smoke_phase28_mesh.py)
    base = cli.build_parser().parse_args(chip_smoke.A9_ARGV)
    assert (base.n_layers, base.steps, base.batch % chip_smoke.A9_PROCS) \
        == (2, 2, 0)
    assert chip_smoke.A9A_LAYERS == 1
    # the flagship's 8 layers: rows 10-12 launch once a layer a step
    full = cli.build_parser().parse_args(chip_smoke.A9_FULL_ARGV)
    assert full.n_layers * chip_smoke.A9_FULL_STEPS == 16
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
    assert parity["checksums_equal"]
    full = lines["a9_full_width"]
    for split in full["split"].values():
        assert split["set_mb_per_s"] > 0 and split["payload_gb"] > 0
        assert split["peak_rss_gb"] > 0
    assert full["masked_reduce_launches"] == [0, 0]
    assert out["flash"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert out["flash_f32"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert set(lines["a9_phase_seconds"]["parts"]) == {
        "dp2_reference", "a1", "b"}
