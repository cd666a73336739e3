"""Phase 19 of ``chip_smoke.py`` (the protocol plane on the card)
rehearsed at a tiny size on the CPU.

One file a phase, so that ``--dist loadfile`` spreads the rehearsals
over the workers; each runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import json

import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402


TINY_PROTOCOL = {
    "a": ["emulate", "--workers", "4", "--data-size", "26",
          "--max-chunk-size", "3", "--max-lag", "3", "--max-round", "12",
          "--checkpoint", "5", "--th-complete", "1.0",
          "--assert-multiple", "4"],
    "b": ["emulate", "--workers", "4", "--data-size", "26",
          "--max-chunk-size", "3", "--max-lag", "3", "--max-round", "12",
          "--th-allreduce", "0.75", "--th-reduce", "0.75",
          "--th-complete", "0.75", "--kill-rank", "1"],
    "c": ["emulate", "--workers", "2", "--data-size", "96",
          "--max-chunk-size", "16", "--max-lag", "1", "--th-complete",
          "1.0", "--max-round", "3", "--checkpoint", "1"],
    "d": ["emulate", "--fuzz", "2", "--workers", "3", "--data-size", "15",
          "--max-round", "3", "--assert-multiple", "3", "--th-complete",
          "1.0"]}


def test_phase19_rehearsal(monkeypatch, capfd):
    """Phase 19 at a tiny size on the CPU (the card's run on the CPU
    twin's device, so no launch is counted): every part passes its
    checks, (a) and (b) bitwise their twins, one line a part."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "PROTOCOL_PARTS", TINY_PROTOCOL)
    monkeypatch.setattr(chip_smoke, "PROTOCOL_PUMP_BITE", 1)
    out = chip_smoke.phase_protocol(torch, n_params=1000)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()]
    parts = [ln["part"] for ln in lines if ln["phase"] == "protocol"]
    assert parts == ["a", "b", "c", "d"]
    a, b, c, d = (out["lines"][p] for p in "abcd")
    assert a["bitwise_twin"] and b["bitwise_twin"]
    assert a["rounds"] == b["rounds"] == 12 and c["rounds"] == 3
    assert a["flushes"] == [13] * 4 and b["flushes"][1] == 0
    assert len(a["sink_mb_per_s"]) == 2 and len(c["sink_mb_per_s"]) == 3
    assert len(c["round_s"]) == 3 and c["run_s"] >= sum(c["round_s"])
    assert c["rounds_per_s"] == pytest.approx(3 / c["run_s"])
    assert c["profile"]["round"] == 1 and c["profile"]["messages"] > 0
    assert d["violations"] == 0 and d["schedules"] == 4 + 5 + 2
    # the CPU runs the plain reduce: nothing launched, nothing expected
    # of the counter; the tracer still sees every fired reduce
    assert out["launches"] == 0 and a["reduce_fired"] > 0
    # 26 floats in blocks of 7, 7, 7, 5: 3 + 3 + 3 + 2 chunk reduces a
    # round, 13 flushed rounds
    assert a["expected_launches"] == a["reduce_fired"] == 11 * 13
