"""Phase 22 of ``chip_smoke.py`` (the A6 serving paths) rehearsed at a
tiny size on the CPU.

One file a phase, so that ``--dist loadfile`` spreads the rehearsals
over the workers; each runs on one intra-op thread
(``tests/torch_rehearsal.py``).
"""

import json

import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402


TINY_SERVE = ["serve", "--vocab", "97", "--d-model", "64", "--n-heads", "4",
              "--kv-heads", "2", "--n-layers", "8", "--d-ff", "128", "--rope",
              "--max-seq", "64", "--paged", "--page-size", "4", "--slots",
              "4", "--requests", "8", "--prompt-len", "4:16",
              "--max-new-tokens", "8", "--decode-steps", "4", "--load",
              "closed", "--seed", "0", "--device", "cpu"]


def test_phase22_rehearsal(monkeypatch, capfd):
    """Phase 22 at a tiny size on the CPU (8 layers: the draft takes 4):
    every check of (a)-(e) passes on the plain versions, the fault
    control (the key index off by one) lands outside the rule for every
    request, and the main-path runs ran n_layers x steps decode steps
    (the CPU launches no kernel: the count stays 0)."""
    from akka_allreduce_tpu_torch import cli
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SERVE_ARGV", TINY_SERVE)
    monkeypatch.setattr(chip_smoke, "A6_BUCKETS", "8,16")
    monkeypatch.setattr(chip_smoke, "A6_SAMPLED_SPEC_REQUESTS", 4)
    steps = {}

    def main_path(attention, engine, name):
        assert attention.PAGED_ATTENTION_LAUNCHES == 0
        steps[name] = engine.cfg.n_layers * engine.decode_dispatches \
            * engine.ecfg.decode_steps
        return steps[name]

    monkeypatch.setattr(chip_smoke, "a6_main_path", main_path)
    parse = cli.build_parser().parse_args
    kernel, _, _ = cli.run_serve(parse(TINY_SERVE + ["--paged-attention",
                                                     "kernel"]))
    _, gather, _ = cli.run_serve(parse(TINY_SERVE + ["--paged-attention",
                                                     "gather"]))
    out = chip_smoke.phase_a6(torch, {"report": kernel, "gather": gather})
    assert out["launches"] == {"sampled": steps["sampled_kernel_s4"],
                               "bf16": steps["bf16_kernel"],
                               "evict": steps["evict_kernel"]}
    assert steps["sampled_kernel_s4"] == 8 * 4 * 4  # 2 waves of 2 blocks
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a6_')]
    by = {ln["phase"]: ln for ln in lines}
    assert by["a6_sampled_parity"]["fault_control_passed"] == 0
    assert by["a6_prng"]["bits_equal"]
    assert by["a6_eviction"]["evicted"] == [0, 1, 2, 3]
    assert out["int8"]["slot"]["ratio"] > 3
    paged = out["speculative"]["paged"]
    assert paged["draft_pages_free"] == paged["draft_pages_total"]
    assert paged["draft_proposed"] == (paged["draft_accepted"]
                                       + paged["draft_rejected"])
