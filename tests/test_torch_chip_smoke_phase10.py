"""Phase 10 of ``chip_smoke.py`` (four ranks, every wire x schedule and the
hierarchical cases) rehearsed at a tiny bucket matrix on four gloo CPU
ranks.

One file a phase, so that ``--dist loadfile`` spreads the rehearsals
over the workers; each runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402


def test_phase10_rehearsal_with_the_hierarchical_cases(monkeypatch):
    """Phase 10 at a tiny bucket matrix on four CPU ranks, (dp 2, sp 2):
    every case passes, the two hierarchical ones (masked and not) among
    them."""
    assert [c for c in chip_smoke.SYNC4_CASES
            if c["schedule"] == "hierarchical"] == [
        {"transport": "ef8", "schedule": "hierarchical", "masked": m}
        for m in (False, True)] and chip_smoke.SYNC4_SP == 2
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SYNC4_SHAPE", (10, 1024))
    assert chip_smoke.phase_sync4(torch) == {
        "cases": len(chip_smoke.SYNC4_CASES)}
