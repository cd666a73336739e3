"""Phase 17 of ``chip_smoke.py`` (the hierarchical schedule at full width,
the autotuner's plans, the bench rows) rehearsed at a tiny size on the
CPU: the plain versions launch no kernel, so the expected launches are
zeroed, and the ipc runs ride gloo.

One file a phase, so that ``--dist loadfile`` spreads the rehearsals
over the workers; each runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import json

import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY_TRAIN = ["train", "--d-model", "64", "--n-heads", "2", "--n-layers",
              "1", "--d-ff", "128", "--vocab", "97", "--seq", "32",
              "--batch", "4", "--steps", "3", "--log-every", "1",
              "--bucket-elems", "1024", "--device", "cpu"]


@pytest.fixture
def phase17_on_cpu(monkeypatch):
    """Phase 17 at a tiny size on the CPU: the plain versions launch no
    kernel, so the expected launches are zeroed; the loss bound is this
    size's own (the sound run's gap read 4.3e-4, the dropped-line
    control's 2.0e-3, the no-update control's 1.6e-2)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "HIER_ARGV", TINY_TRAIN)
    # the ipc transport needs the card: the CPU ranks ride gloo, and the
    # ipc run's twin is then a second gloo run
    on_cpu = {"cuda": "cpu", "ipc": "gloo"}
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "HIER_DIST", [
        on_cpu.get(a, a) for a in chip_smoke.HIER_DIST])
    monkeypatch.setattr(chip_smoke, "AUTO_ARGV", [
        on_cpu.get(a, a) for a in chip_smoke.AUTO_ARGV])
    monkeypatch.setattr(chip_smoke, "BENCH_BACKEND", "gloo")
    monkeypatch.setattr(chip_smoke, "BENCH_GOODPUT", (20_000, 4096))
    monkeypatch.setattr(chip_smoke, "BENCH_PAYLOADS", ((20_000, 4096),))
    monkeypatch.setattr(chip_smoke, "BENCH_SET_S", 0.05)
    monkeypatch.setattr(chip_smoke, "HIER_LOSS_ATOL", 1e-3)
    monkeypatch.setattr(chip_smoke, "expected_sync_launches",
                        lambda *a, **k: dict.fromkeys(
                            chip_smoke.SYNC_KERNELS, 0))
    monkeypatch.setattr(chip_smoke, "expected_attention_launches",
                        lambda *a, **k: {
                            "ring": dict.fromkeys(chip_smoke.RING_REPLACES, 0),
                            "flash": dict.fromkeys(chip_smoke.FLASH_REPLACES,
                                                   0)})


def test_phase17_full_width_run_rehearsal(phase17_on_cpu):
    out = chip_smoke.phase_hierarchical(torch)
    row = out["row"]
    assert row["num_buckets"] == -(-row["params"] // 1024)
    assert len(set(row["param_checksums"])) == 1
    assert row["loss_rel_diff"][0] <= chip_smoke.SP_LOSS_RTOL
    assert chip_smoke.HIER_DIST[-1] == "hierarchical"


def test_phase17_auto_plans_rehearsal(phase17_on_cpu, tmp_path):
    hashes = chip_smoke.phase_auto(torch, str(tmp_path))["hashes"]
    assert hashes[0] == hashes[1] != hashes[2]


def test_phase17_bench_rows_rehearsal(phase17_on_cpu, capfd):
    assert chip_smoke.phase_bench_rows(torch) == {"rows": 1 + 5 + 4}
    rows = [ln for ln in capfd.readouterr().out.splitlines()
            if ln.startswith('{"phase": "bench_row"')]
    assert len(rows) == 10
    assert '"metric": "allreduce_goodput_0.02M_f32_4cpu"' in rows[0]
    for row in map(json.loads, rows):
        # every row says what resolved it: the rounds of its sets (sized
        # up from 4 / 1 to BENCH_SET_S) and the spread its reps allow
        assert row["spread"] >= 0
        if row["unit"] == "GB/s":
            lo, hi = row["rounds"]
            assert hi >= chip_smoke.BENCH_R_HI and lo == max(1, hi // 4)
