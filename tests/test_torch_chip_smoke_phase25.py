"""Phase 25 of ``chip_smoke.py`` (expert and tensor parallelism, ROADMAP
A7 part 1) rehearsed at a tiny size on the CPU, on gloo ranks.

Every check of (a)-(e) passes on the plain versions: (a) the ep=2 and
tp=2 steps give the one-rank step's gradients within the phase's bound
with every token dispatched, and each fault control (one rank's
all_to_all blocks swapped, the first tp sum skipped) lands outside it;
(b) and (c) train with finite losses, MoE metrics in range, the ep
exchange twice a MoE layer each way a step and the tp sums four a layer,
and the launch counts the CPU implies (none); (d) MoE serving completes
every request with the gather path's greedy tokens on the kernel
engine (its plain version here) and the rolled-experts control outside
the rule; (e) a one-rank ``cli generate`` process restores the tp=2
checkpoint's tokens, and the control (wq's halves swapped) differs. The
batches run in one ``RankPool`` of two ranks, as on the card. One file a
phase, so that ``--dist loadfile`` spreads the rehearsals; each
runs on one intra-op thread (``tests/torch_rehearsal.py``).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

TINY = ["train", "--d-model", "64", "--n-heads", "4", "--n-layers", "2",
        "--d-ff", "128", "--vocab", "97", "--seq", "16", "--batch", "4",
        "--lr", "1e-3", "--steps", "3", "--log-every", "1", "--device",
        "cpu"]
TINY_SERVE = ["serve", "--vocab", "97", "--d-model", "64", "--n-heads", "4",
              "--kv-heads", "2", "--n-layers", "2", "--d-ff", "128", "--rope",
              "--max-seq", "64", "--paged", "--page-size", "4", "--slots",
              "4", "--requests", "6", "--prompt-len", "4:12",
              "--max-new-tokens", "8", "--decode-steps", "4", "--load",
              "closed", "--seed", "0", "--device", "cpu", "--moe-experts",
              "4", "--moe-every", "2", "--router-k", "2",
              "--capacity-factor", "2.0"]


def test_phase25_rehearsal(monkeypatch, capfd):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DIST", "gloo")
    monkeypatch.setattr(chip_smoke, "A7_PARITY_MODEL", dict(
        vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_seq=16, moe_every=2))
    monkeypatch.setattr(chip_smoke, "A7_PARITY_MOE", dict(
        n_experts=4, d_ff=64, capacity_factor=2.0, router_k=2,
        aux_loss_coef=0.0))
    monkeypatch.setattr(chip_smoke, "A7_PARITY_BATCH", (2, 16))
    monkeypatch.setattr(chip_smoke, "A7_MOE_ARGV", TINY + [
        "--moe-experts", "4", "--router-k", "2", "--capacity-factor",
        "1.25", "--moe-every", "2"])
    monkeypatch.setattr(chip_smoke, "A7_TP_ARGV", TINY)
    monkeypatch.setattr(chip_smoke, "A7_SERVE_ARGV", TINY_SERVE)
    monkeypatch.setattr(chip_smoke, "A7_CKPT_ARGV", chip_smoke.set_flag(
        chip_smoke.set_flag(TINY, "--steps", 2), "--seq", 32))
    steps = {}

    def main_path(attention, engine, name):
        assert attention.PAGED_ATTENTION_LAUNCHES == 0
        steps[name] = engine.cfg.n_layers * engine.decode_dispatches \
            * engine.ecfg.decode_steps
        return steps[name]

    monkeypatch.setattr(chip_smoke, "a6_main_path", main_path)
    # the batches share one pool of two rank processes, as on the card
    monkeypatch.setattr(chip_smoke, "POOLED", True)
    try:
        out = chip_smoke.phase_a7(torch)
    finally:
        chip_smoke.close_pools()
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a7_')]
    by = {}
    for ln in lines:
        by.setdefault(ln["phase"], []).append(ln)
    parity = {ln["run"]: ln for ln in by["a7_parity"]}
    assert set(parity) == {"ep=2", "tp=2"}
    for row in parity.values():
        assert row["held"] and row["control_outside"]
        assert row["sharded_rel_err"] < 1e-5 < 1e-2 < row["control_rel_err"]
        assert row["dispatch_fractions"] == [1.0, 1.0]
    train = {ln["run"]: ln for ln in by["a7_train"]}
    moe = train["ep=2"]["exchanges"][0]
    # 1 MoE layer: its all_to_all twice forward and twice backward a step
    assert moe["all_to_all"]["calls_per_step"] == 4
    assert "tp_psum" not in moe
    # 2 layers: 2 forward sums and 2 backward boundary sums a layer
    assert train["tp=2"]["exchanges"][0]["tp_psum"]["calls_per_step"] == 8
    assert train["ep=2"]["mesh"] == "dp=1 tp=1 sp=1 pp=1 ep=2"
    serve = by["a7_serve"][0]
    assert serve["completed"] == 6 and serve["greedy_agree"] == 6
    assert serve["control_agree"] == 0
    assert out["paged"] == steps["a7 moe kernel"] > 0
    ckpt = by["a7_checkpoint"][0]
    assert ckpt["equal"] and not ckpt["control_equal"]
    assert out["sync"] == dict.fromkeys(chip_smoke.SYNC_KERNELS, 0)
    assert out["transport"] == 0


def test_phase25_expected_launches():
    """A rank's rows 1 and 10-12 a step on the card: the flash kernels
    once a layer; one masked reduce (the dense sync over the ep line) on
    (b), four tp sums a layer on (c)."""
    assert chip_smoke.DEVICE == "cuda"
    ep = chip_smoke.a7_expected_launches("ep", 8, 3)
    tp = chip_smoke.a7_expected_launches("tp", 8, 3)
    assert ep["flash"] == tp["flash"] == dict.fromkeys(
        chip_smoke.FLASH_REPLACES, 24)
    assert ep["masked_reduce"] == 3 and tp["masked_reduce"] == 96
