"""Training on the hierarchical and auto schedules: the port against JAX.

JAX initialises the weights on a ``MeshSpec(dp=2, sp=2)`` mesh and trains
3 steps on the ef8 wire with ``transport_schedule="hierarchical"``; the
port's ``train --dp 2 --sp 2 --grad-quant ef8 --grad-schedule
hierarchical`` runs from the same weights on four gloo ranks on the CPU.
Pins: step 1's loss at rtol 1e-5 of JAX's (no sync has acted yet), steps
2–3 within 3e-3 of JAX's (the rounding bits differ), a bound that two
fault controls must land outside: no update at step 1 (``--lr 0``) and
one dp line's gradient dropped at step 1 (a deadline draw that masks that
line); ranks ending bitwise equal, each rank's residual
nonzero only in its own sp column shard; ``--grad-schedule auto`` on the
same mesh measuring hierarchical alone and training bitwise as the
flagged schedule. The command prints the JAX command's lines (the plan
measured, then reloaded from ``--plan-dir`` with the sidecar's bytes
unchanged; the note without a directory). Under ``--deadline-ms`` the
masks of each sp line agree (counts are multiples of sp) and a round
whose every line has a late rank runs exact.
"""

import argparse
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch import cli, convert
from akka_allreduce_tpu_torch.runtime.pacer import RoundClock
from akka_allreduce_tpu_torch.runtime.straggler import DeadlineTrainer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=32, rope=True)
B, T, STEPS, LR = 4, 32, 3, 1e-2
ARGV = ["train", "--device", "cpu", "--vocab", "97", "--d-model", "64",
        "--n-heads", "4", "--kv-heads", "2", "--rope", "--n-layers", "2",
        "--d-ff", "128", "--seq", str(T), "--batch", str(B), "--lr",
        str(LR), "--steps", str(STEPS), "--bucket-elems", "256",
        "--log-every", "1"]
HIER = ["--dp", "2", "--sp", "2", "--grad-quant", "ef8"]
# steps 2-3 against JAX: the sound run's gap read 4.3e-4, the fault
# controls' step-2 gaps 2.2e-2 (one dp line dropped) and 7.0e-2 (no
# update); the bound is the geometric mean of the sound gap and the
# smaller control
HIER_LOSS_ATOL = 3e-3


def args(*extra) -> argparse.Namespace:
    return cli.build_parser().parse_args(ARGV + list(extra))


@pytest.fixture(scope="module")
def jax_run():
    mesh = make_device_mesh(MeshSpec(dp=2, sp=2), devices=jax.devices()[:4])
    cfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                             bucket_elems=256, learning_rate=LR,
                             attn_impl="local", grad_transport="ef8",
                             transport_schedule="hierarchical")
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0), cfg,
                                                     mesh)
    init = jax.tree.map(np.asarray, params)
    ef = jtrain.init_ef_state(cfg, mesh, params)
    step = jtrain.make_train_step(cfg, mesh, opt)
    losses = []
    for i in range(STEPS):
        tokens = np.random.default_rng(i).integers(0, 97, size=(B, T),
                                                   dtype=np.int32)
        params, opt_state, m, ef = step(params, opt_state,
                                        jnp.asarray(tokens), ef)
        losses.append(float(m["loss"]))
    return init, losses


@pytest.fixture(scope="module")
def port_run(jax_run):
    init, _ = jax_run
    return cli.run_train(args(*HIER, "--grad-schedule", "hierarchical"),
                         params=convert.params_from_jax(init))


def test_hierarchical_training_matches_jax(jax_run, port_run):
    _, want = jax_run
    got = port_run["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert np.abs(np.subtract(got, want)).max() < HIER_LOSS_ATOL
    assert port_run["config"]["transport_schedule"] == "hierarchical"
    assert port_run["dist"] == {"backend": "gloo", "world": 4}


@pytest.mark.parametrize("fault", ["no_update", "dropped_line"])
def test_fault_controls_land_outside_the_loss_bound(jax_run, fault):
    """Each fault moves step 2's loss off JAX's by more than the bound:
    at ``--lr 0`` step 1 updates nothing; under ``--deadline-ms`` a
    straggle draw that makes one dp line late masks that line's two
    ranks, so step 1 syncs the other line's gradient alone."""
    init, want = jax_run
    extra = ["--lr", "0"]
    if fault == "dropped_line":
        a = args(*HIER)
        draws = chip_smoke.straggle_draws(1, 4, a.batch, a.seq, a.vocab)
        prob, _ = chip_smoke.choose_line_drop(draws, 2)
        extra = ["--deadline-ms", "50", "--straggle-prob", repr(prob)]
    run = cli.run_train(args(*HIER, "--grad-schedule", "hierarchical",
                             *extra), params=convert.params_from_jax(init))
    if fault == "dropped_line":
        first = run["deadline"]["rounds"][0]
        assert (first["n_dropped"], first["fell_back"]) == (2, False)
    assert run["losses"][0] == pytest.approx(want[0], rel=1e-5)
    assert abs(run["losses"][1] - want[1]) > HIER_LOSS_ATOL


def test_ranks_equal_and_residuals_in_their_own_shard(port_run):
    ranks = port_run["ranks"]
    assert len({r["param_checksum"] for r in ranks}) == 1
    for r in ranks:
        assert r["residual_shape"][1] == 256
        shards = r["residual_abs_max_by_sp_shard"]
        mine = r["rank"] % 2
        assert shards[mine] > 0 and shards[1 - mine] == 0


def test_auto_measures_hierarchical_and_trains_as_flagged(jax_run, port_run,
                                                          tmp_path):
    init, _ = jax_run
    run = cli.run_train(args(*HIER, "--grad-schedule", "auto",
                             "--plan-dir", str(tmp_path)),
                        params=convert.params_from_jax(init))
    plan = run["collective_plan"]["plan"]
    assert plan["axes"] == [["dp", 2], ["sp", 2]] and plan["wire"] == "ef8"
    (entry,) = plan["entries"].values()
    assert entry["schedule"] == "hierarchical" and entry["note"] == ""
    assert list(entry["timings_us"]) == ["hierarchical"]
    assert run["losses"] == port_run["losses"]
    assert [r["param_checksum"] for r in run["ranks"]] == \
        [r["param_checksum"] for r in port_run["ranks"]]


PLAN_LINE = re.compile(r"collective plan [0-9a-f]{16} (measured|reloaded) "
                       r"in \d+\.\ds: \{'8x65536': '([a-z0-9:]+)'\}")


def test_cli_prints_the_jax_lines(capfd, tmp_path):
    base = ["train", "--device", "cpu", "--steps", "2", "--log-every", "1"]
    assert cli.main(base + HIER + ["--grad-schedule", "hierarchical"]) == 0
    out = capfd.readouterr().out.splitlines()
    assert any("dp=2 sp=2 (gloo) wire=ef8 schedule=hierarchical" in ln
               for ln in out)
    assert [ln.split(":")[0] for ln in out if ln.startswith("step ")] == [
        "step    1", "step    2"]
    sidecar = tmp_path / "collective_plan.json"
    seen = []
    for _ in range(2):
        assert cli.main(base + ["--dp", "2", "--grad-schedule", "auto",
                                "--plan-dir", str(tmp_path)]) == 0
        out = capfd.readouterr().out.splitlines()
        (line,) = [ln for ln in out if ln.startswith("collective plan ")]
        match = PLAN_LINE.fullmatch(line)
        assert match and match.group(2) in ("fused", "windowed:4", "swing")
        seen.append((match.group(1), line.split()[2], sidecar.read_bytes()))
    assert [s[0] for s in seen] == ["measured", "reloaded"]
    assert seen[0][1:] == seen[1][1:]  # the same hash, the same bytes
    assert cli.main(base + HIER + ["--grad-schedule", "auto"]) == 0
    out = capfd.readouterr().out.splitlines()
    assert "note: --grad-schedule auto without --plan-dir/--ckpt-dir: the " \
        "plan is measured fresh every start (give it a directory to " \
        "reload on restart)" in out
    (line,) = [ln for ln in out if ln.startswith("collective plan ")]
    assert PLAN_LINE.fullmatch(line).group(2) == "hierarchical"


def test_deadline_masks_agree_within_each_sp_line(capfd):
    report = cli.run_train(args(*HIER, "--grad-schedule", "hierarchical",
                                "--steps", "5", "--deadline-ms", "50",
                                "--straggle-prob", "0.25"))
    rounds = report["deadline"]["rounds"]
    counts = [r["min_bucket_count"] for r in rounds]
    for r, count in zip(rounds, counts):
        lines_ok = [all(r["valid_peers"][i:i + 2]) for i in (0, 2)]
        assert r["fell_back"] == (not any(lines_ok))
        assert count == (4 if r["fell_back"] else 2 * sum(lines_ok))
        # a late rank drops its whole line: what the round left out
        assert r["n_dropped"] == (0 if r["fell_back"] else 4 - count)
    steps = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("step ")]
    for r, ln in zip(rounds, steps):
        dropped = f", {r['n_dropped']} dropped with their sp lines"
        assert (dropped in ln) == (r["n_dropped"] > r["n_masked"])
    # the draws give a round with one late line and a fallback round
    assert 2 in counts and any(r["fell_back"] for r in rounds)
    assert all(np.isfinite(report["losses"]))
    assert len({r["param_checksum"] for r in report["ranks"]}) == 1


def test_deadline_trainer_masks_whole_lines():
    masks = []

    def step(state, tokens, valid):
        masks.append(valid)
        return {}
    clock = RoundClock(4, deadline_s=0.05)
    trainer = DeadlineTrainer(step, clock, num_buckets=3, max_lag=0, line=2)
    for late in ([1], [0, 3], []):
        r = trainer.open_round()
        for peer in range(4):
            clock.report_offset(r, peer, 0.1 if peer in late else 0.0)
        trainer.run_round(None, None)
    trainer.drain()
    assert [m[:, 0].tolist() for m in masks] == [
        [0, 0, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]]
    assert [r.fell_back for r in trainer.reports] == [False, True, False]
    assert [r.n_masked for r in trainer.reports] == [1, 2, 0]
    assert [r.n_dropped for r in trainer.reports] == [2, 0, 0]
    with pytest.raises(ValueError, match="must divide"):
        DeadlineTrainer(step, clock, num_buckets=3, line=3)
