"""Phase 24 of ``chip_smoke.py`` (the A6 part 2 serving paths: the
watchdog and faults, drain/restore across processes, the serve trace)
rehearsed at a tiny size on the CPU, on one intra-op thread
(``tests/torch_rehearsal.py``). The two ``cli serve`` children of (d) run
as real processes here too.
"""

import json

import pytest
import torch

from torch_rehearsal import one_intra_op_thread  # noqa: F401,E402

import chip_smoke  # noqa: E402

# one token a dispatch and a long budget: child 1 is still decoding when
# its second poll reads TRUE, however fast the host
TINY_SERVE = ["serve", "--vocab", "97", "--d-model", "64", "--n-heads", "4",
              "--kv-heads", "2", "--n-layers", "2", "--d-ff", "128", "--rope",
              "--max-seq", "128", "--paged", "--page-size", "4", "--slots",
              "4", "--requests", "8", "--prompt-len", "4:16",
              "--max-new-tokens", "100", "--decode-steps", "1", "--load",
              "closed", "--seed", "0", "--device", "cpu"]


@pytest.fixture
def tiny_phase24(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SERVE_ARGV", TINY_SERVE)
    monkeypatch.setattr(chip_smoke, "A24_CHILD_REQUESTS", 4)
    monkeypatch.setattr(chip_smoke, "A24_PREEMPT_INTERVAL_S", 0.05)
    monkeypatch.setattr(chip_smoke, "A24_PREEMPT_AT_POLL", 2)
    # the CPU's seconds say nothing of the card's budget
    monkeypatch.setattr(chip_smoke, "A24_SECONDS", 600)
    # a healthy tiny dispatch beside busy test workers stays far under
    monkeypatch.setattr(chip_smoke, "A24_WATCHDOG_S", 2.0)
    # the A/B's 58 one-token dispatches inside the tiny max_seq
    monkeypatch.setattr(chip_smoke, "A24_AB_TOKENS", 100)


def test_phase24_rehearsal(tiny_phase24, capfd):
    """Every check of (a)-(e) passes on the plain versions: the faults
    fire and reconcile, the streams agree (retried and untouched ones
    bitwise), the late dispatch leaves the live engines alone, the
    control fails the comparison, the children drain and restore, and
    child 2's trace and snapshot match its report. The CPU launches no
    kernel, so row 13's counts stay 0."""
    out = chip_smoke.phase_a24(torch)
    assert out["launches"] == {"faults": 0, "watchdog_cost": 0}
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith('{"phase": "a24_')]
    by = {}
    for ln in lines:
        by.setdefault(ln["phase"], []).append(ln)
    assert [ln["decode_steps"] for ln in by["a24_selfcheck"]] == [1, 4]
    faults = by["a24_faults"][0]
    assert faults["watchdog_trips"] == 1
    assert faults["abandoned_dispatches"] == 1
    assert faults["live_state_untouched"]
    assert faults["restored"] and faults["retried"]
    assert not faults["control"]["passed"]
    # the hang's recovery and the raise's, each back to full capacity
    assert len(faults["pool_after_recover"]) == 2
    assert all(used == 0 and free == cap
               for used, free, cap in faults["pool_after_recover"])
    proc = by["a24_processes"][0]
    assert proc["child1"]["drained"] == 4
    assert proc["child2"]["resumed"] == 4
    assert proc["drain_file_cleared"]
    assert proc["trace"]["serve_step"] == proc["child2"]["decode_dispatches"]
    assert proc["snapshot_counters_off"] == {}
    cost = by["a24_watchdog_cost"][0]
    assert set(cost["wall_ms_per_step"]) == {"armed", "unarmed"}
    ab = cost["interleaved"]
    assert {k: len(v) for k, v in ab["blocks_ms_per_step"].items()} == {
        "armed": 6, "unarmed": 6}
    assert ab["dispatches"] == 2 + 6 * 2 * 4 + 2 * 4
    assert 0 < cost["handoff_us_per_dispatch"] < 1e6


def test_control_fails_and_restore_parity_holds(tiny_phase24):
    """``a24_stream_check``: a stream equal to the reference is bitwise;
    one less a token (the control) fails ``greedy_agree``."""
    from akka_allreduce_tpu_torch import cli
    from akka_allreduce_tpu_torch.serving import (RequestScheduler,
                                                  SchedulerConfig)
    args = chip_smoke.a24_args(torch, [])
    mcfg, params = cli.serve_model(args, torch.device("cpu"))
    reqs = {r.rid: r for r in chip_smoke.a24_requests(args)}
    sched = RequestScheduler(SchedulerConfig(), num_slots=args.slots)
    for r in reqs.values():
        sched.submit(r)
    base, _, _ = cli.serve_until_done(
        lambda: cli.build_engine(args, params, mcfg), sched)
    same = chip_smoke.a24_stream_check(torch, params, mcfg, reqs, base,
                                       base, reqs)
    assert same == {"requests": 8, "bitwise": 8, "failures": []}
    toks = base[3][0]
    cut = {3: (toks[:9] + toks[10:], base[3][1])}
    bad = chip_smoke.a24_stream_check(torch, params, mcfg, reqs, base, cut,
                                      [3])
    assert bad["bitwise"] == 0 and len(bad["failures"]) == 1
