"""Phase 27 of ``chip_smoke.py`` (the parallel axes' compositions,
ROADMAP A7 part 3) rehearsed at a tiny size on the CPU, on gloo ranks.

Every check of (a)-(c) passes on the plain versions: (a) at dp=2 x
tp=2, dp=2 x pp=2 (gpipe) and ep=2 (MoE) the round that masks data rank
1 gives data rank 0's gradients alone within the phase's bound, the
unmasked round (the control) lands outside it, the trainer reports one
masked and one dropped rank, and at ep the expert gradients of both
rounds are bitwise equal; (b) each chunked run (tp=2, ep=2 on f32 and
ef8, pp=2 under gpipe and 1f1b) is bitwise its eager chunks (on the CPU
both run step by step), and the control (a later chunk rounding with
the keys of the chunk before) differs; (c) the MoE run at ep=2 under
``--deadline-ms`` reports the rounds the straggle draws predict. The
batches run in ``RankPool``s of two and four ranks, as on the card,
with the kernel launch counts those of the CPU (none). One file a
phase, so that ``--dist loadfile`` spreads the rehearsals; it runs on
one intra-op thread (``tests/torch_rehearsal.py``).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY = ["train", "--d-model", "32", "--n-heads", "4", "--n-layers", "4",
        "--d-ff", "64", "--vocab", "97", "--seq", "16", "--batch", "8",
        "--lr", "1e-3", "--steps", "6", "--log-every", "1", "--device",
        "cpu"]
MOE = ["--moe-experts", "4", "--router-k", "2", "--capacity-factor",
       "1.25", "--moe-every", "2"]


def test_phase27_rehearsal(monkeypatch, capfd):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    monkeypatch.setattr(chip_smoke, "A7C_MASK_MODEL", dict(
        vocab_size=97, d_model=32, n_heads=4, n_layers=4, d_ff=64,
        max_seq=16, moe_every=2))
    monkeypatch.setattr(chip_smoke, "A7_PARITY_MOE", dict(
        n_experts=4, d_ff=64, capacity_factor=4.0, router_k=2,
        aux_loss_coef=0.0))
    monkeypatch.setattr(chip_smoke, "A7C_MASK_MESHES", tuple(
        (n, w, m, None if moe is None else chip_smoke.A7_PARITY_MOE, kw)
        for n, w, m, moe, kw in chip_smoke.A7C_MASK_MESHES))
    monkeypatch.setattr(chip_smoke, "A7C_MASK_BATCH", (4, 16))
    monkeypatch.setattr(chip_smoke, "A7_MOE_ARGV", TINY + MOE)
    monkeypatch.setattr(chip_smoke, "A7C_CHUNK_RUNS", tuple(
        (n, TINY + MOE if n.startswith("ep") else TINY, mesh)
        for n, _, mesh in chip_smoke.A7C_CHUNK_RUNS))
    try:
        out = chip_smoke.phase_a7c(torch, 1.0)
    finally:
        chip_smoke.close_pools()
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a7c_')]
    by: dict = {}
    for ln in lines:
        by.setdefault(ln["phase"], []).append(ln)
    mask = {ln["mesh"]: ln for ln in by["a7c_mask"]}
    assert set(mask) == {"dp=2 tp=2", "dp=2 pp=2", "ep=2 moe"}
    for row in mask.values():
        assert row["held"] and row["control_outside"]
        assert row["reports_agree"] and row["n_data_ranks"] == 2
        assert row["masked_rel_err"] < 1e-5 < 1e-1 < row["unmasked_rel_err"]
    assert mask["ep=2 moe"]["expert_bitwise"] == [True, True]
    chunks = {ln["run"]: ln for ln in by["a7c_chunks"]}
    assert set(chunks) == {"tp=2", "ep=2 f32", "ep=2 ef8", "pp=2 gpipe",
                           "pp=2 1f1b"}
    for row in chunks.values():
        assert row["losses_bitwise"] and row["params_bitwise"]
        assert len(row["losses"]) == chip_smoke.A7C_STEPS
        assert row["replays"] == [0, 0]  # the CPU runs chunks step by step
    assert chunks["ep=2 ef8"]["residuals_bitwise"]
    (control,) = by["a7c_control"]
    assert not control["control_passed"]
    assert control["control_losses"][:4] == control["eager_losses"][:4]
    (deadline,) = by["a7c_deadline"]
    assert deadline["rounds"] == deadline["predicted_rounds"]
    assert deadline["masked_round_count"] >= 1
    assert out["flash"] == dict.fromkeys(chip_smoke.FLASH_REPLACES, 0)
    assert out["sync"] == dict.fromkeys(chip_smoke.SYNC_KERNELS, 0)
    assert out["transport"] == 0


def test_phase27_launches_a_replay():
    """Rank 0's launches a step on the card at the flagship's 8 layers:
    tp=2 the flash kernels once a layer and 4 masked reduces a layer (the
    tp sums); ep=2 one masked reduce (f32) or one fused ef8 sync's
    quantizes and dequantizes; pp=2 at 4 microbatches 16 of each flash
    kernel (1f1b's forward 32) and one masked reduce (the pp sum)."""
    per = chip_smoke.a7c_per_step
    assert per("tp=2", 8) == {
        "flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8, "masked_reduce": 32,
        "quantize_int8_block": 0, "quantize_int8_block_rtn": 0,
        "dequantize_int8_block": 0}
    assert per("ep=2 f32", 8)["masked_reduce"] == 1
    ef8 = per("ep=2 ef8", 8)
    assert (ef8["masked_reduce"], ef8["quantize_int8_block"],
            ef8["quantize_int8_block_rtn"],
            ef8["dequantize_int8_block"]) == (0, 1, 1, 3)
    gpipe, one_f = per("pp=2 gpipe", 8), per("pp=2 1f1b", 8)
    assert gpipe["flash_fwd"] == gpipe["flash_dq"] == 16
    assert one_f["flash_fwd"] == 32 and one_f["flash_dkv"] == 16
    assert gpipe["masked_reduce"] == one_f["masked_reduce"] == 1
