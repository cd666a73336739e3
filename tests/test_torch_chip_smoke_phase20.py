"""Phase 20 of ``chip_smoke.py`` (the protocol plane across processes)
rehearsed at a tiny size on the CPU.

One file a phase, so that ``--dist loadfile`` spreads the rehearsals
over the workers; each runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402


def test_phase20_rehearsal(monkeypatch, capfd):
    """Phase 20 at a tiny size on the CPU (card workers on ``--device
    cpu``, so no launch is counted): the mixed engines and the kill part
    pass their checks, (f) runs the C++ engine."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CLUSTER_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CLUSTER_COPY_REPS", 3)
    monkeypatch.setattr(chip_smoke, "CLUSTER_PARTS", {
        "b": chip_smoke.CLUSTER_PARTS["b"],
        "e": chip_smoke.CLUSTER_PARTS["e"]})
    monkeypatch.setattr(chip_smoke, "CLUSTER_ROUNDS",
                        {"a": 20, "b": 12, "e": 16})
    out = chip_smoke.phase_cluster(torch, n_params=1000)
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()]
    parts = [ln["part"] for ln in lines if ln["phase"] == "cluster"]
    assert parts == ["copies", "b", "e", "f"]
    assert out["lines"]["b"]["rounds"] == 12
    assert out["lines"]["b"]["worker_rcs"] == [0, 0, 0, 0]
    e = out["lines"]["e"]
    assert e["rounds"] == 16 and len(e["downs_at_round"]) == 1
    assert sorted(e["worker_rcs"]) == [-9, 0, 0, 0]
    assert out["lines"]["f"]["rounds"] == 20
    assert out["launches"] == 0
