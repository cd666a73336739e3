"""Straggler-tolerant training: the port's pacer, clock, masked step,
deadline trainer and ``train --deadline-ms`` against the JAX package.

(a) ``RoundPacer`` / ``RoundClock``: the JAX classes and the port's run
one scripted schedule each (the case lists of ``test_dp_runtime.py`` and
``test_straggler_deadline.py``) and give equal results. (b) The masked
grad step: JAX ``make_grad_step(dynamic_valid=True)`` on a dp=2 CPU mesh
and the port on two gloo ranks, masks "rank 1 all masked", per bucket
and all valid: f32 gradients within rtol 1e-5, bf16 inside the bf16
sync's envelope, ``min_bucket_count`` exact; int8 and ef8 draw their
rounding from other generators than JAX's, so they are held to the
masked-row contract inside the port (a masked rank's data cannot reach
the result, ef8 residual rows of masked buckets come back bitwise) with
JAX's counts (its int32 count sum does not depend on the wire). (c)
``DeadlineTrainer`` end to end at dp=4, 14 rounds: scripted stragglers,
an all-masked fallback, a cold straggler and the pacer's bound; reports
and counts exact, losses within rtol 1e-4. (d) Mask rows at dp=1, sp=2.
(e) ``cli.py train --deadline-ms``: its masks are the JAX command's
draws, its losses a JAX ``DeadlineTrainer``'s fed those masks (rtol
1e-4), its step lines and refusals, and an ef8 deadline run resumed from
a checkpoint equals the uninterrupted run bitwise.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu.runtime import pacer as jpacer
from akka_allreduce_tpu.runtime.straggler import \
    DeadlineTrainer as JaxDeadlineTrainer
from akka_allreduce_tpu_torch import cli
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
from akka_allreduce_tpu_torch.runtime import pacer as tpacer

import torch_straggler_ranks as ranks

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=16, rope=True)
BUCKET = 256
B, T, LR = 4, 16, 1e-2
ARGV = ["train", "--device", "cpu", "--vocab", "97", "--d-model", "64",
        "--n-heads", "4", "--kv-heads", "2", "--rope", "--n-layers", "2",
        "--d-ff", "128", "--seq", str(T), "--batch", str(B), "--lr",
        str(LR), "--steps", "4", "--bucket-elems", str(BUCKET),
        "--log-every", "1", "--dp", "2"]
DEADLINE = ["--deadline-ms", "50", "--straggle-prob", "0.5"]


def jax_config(wire="f32", grad_axes=("dp",), lr=LR):
    return jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                              grad_axes=grad_axes, bucket_elems=BUCKET,
                              learning_rate=lr, attn_impl="local",
                              grad_transport=wire)


def jax_state(spec: MeshSpec, cfg, seed=0):
    mesh = make_device_mesh(spec, devices=jax.devices()[:spec.dp * spec.sp])
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(seed),
                                                     cfg, mesh)
    return mesh, params, opt_state, opt


def tokens_for(seed, b=B, t=T):
    return np.random.default_rng(seed).integers(0, 97, size=(b, t),
                                                dtype=np.int32)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def flat(tree):
    return np.concatenate([x.reshape(-1) for x in leaves(tree)])


# -- (a) the pacer and the clock -------------------------------------------

@pytest.mark.parametrize("max_lag", [0, 1, 2])
def test_pacer_window_matches_jax(max_lag):
    """Ten rounds through each pacer: the same rounds run, the same
    window after every submit (never more than max_lag + 1 unharvested),
    the same order of completion."""
    runs = []
    for mod, zeros in ((jpacer, lambda: jnp.zeros((4,))),
                       (tpacer, lambda: torch.zeros(4))):
        pacer = mod.RoundPacer(max_lag=max_lag)
        seen, trace = [], []

        def step(r):
            seen.append(r)
            return zeros()
        for _ in range(10):
            pacer.submit(step)
            trace.append((pacer.round, list(pacer.completed_rounds),
                          len(pacer._inflight)))
        pacer.drain()
        runs.append((seen, trace, pacer.completed_rounds))
    assert runs[0] == runs[1]
    seen, trace, completed = runs[1]
    assert seen == completed == list(range(10))
    assert all(r - len(done) <= max_lag + 1 for r, done, _ in trace)
    if max_lag == 0:  # lockstep: the previous round is retired first
        assert all(len(done) == r - 1 for r, done, _ in trace)


def test_pacer_refuses_a_negative_lag_and_reports_harvests():
    for mod in (jpacer, tpacer):
        with pytest.raises(ValueError, match="max_lag must be >= 0"):
            mod.RoundPacer(max_lag=-1)
    harvested = []
    pacer = tpacer.RoundPacer(max_lag=1, on_harvest=harvested.append)
    for _ in range(4):
        pacer.submit(lambda r: torch.ones(()))
    assert harvested == [0, 1]
    pacer.drain()
    assert harvested == pacer.completed_rounds == [0, 1, 2, 3]


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# (name, num_peers, deadline_s, script): "at" sets the clock; the query
# ops ("valid", "open", "count", "arrived") record their answers
CLOCK_CASES = [
    ("deadline_masks", 4, 1.0, [
        ("at", 100.0), ("open_round", 0), ("report_arrival", 0, 0),
        ("at", 100.5), ("report_arrival", 0, 1), ("at", 102.0),
        ("report_arrival", 0, 2), ("valid", 0), ("count", 0),
        ("arrived", 0, 3)]),
    ("expire_rotates_window", 2, 1.0, [
        ("open_round", 0), ("open_round", 1), ("report_arrival", 0, 0),
        ("expire", 1), ("valid", 0), ("valid", 1), ("open", 0),
        ("open", 1)]),
    ("report_offset_against_deadline", 3, 1.0, [
        ("at", 5.0), ("open_round", 0), ("report_offset", 0, 0, 0.5),
        ("report_offset", 0, 1, 1.0), ("report_offset", 0, 2, 1.01),
        ("valid", 0), ("open", 0), ("expire", 1), ("open", 0)]),
    ("offset_requires_open_round", 1, 1.0, [
        ("report_offset", 3, 0, 0.0)]),
    ("cold_straggler_and_late_report", 3, 0.5, [
        ("open_round", 0), ("report_offset", 0, 0, 0.1),
        ("report_offset", 0, 1, 0.2), ("valid", 0), ("expire", 1),
        ("report_arrival", 0, 2, 9.0), ("count", 0), ("valid", 0),
        ("expire", 1), ("count", 0), ("arrived", 0, 2)]),
]


def run_clock(mod, num_peers, deadline_s, script):
    fake = _FakeClock()
    clock = mod.RoundClock(num_peers, deadline_s, clock=fake)
    out = []
    for op, *a in script:
        if op == "at":
            fake.t = a[0]
        elif op == "valid":
            out.append(clock.valid_peers(*a))
        elif op == "open":
            out.append(clock.is_open(*a))
        elif op == "count":
            out.append(clock.arrival_count(*a))
        elif op == "arrived":
            out.append(clock.has_arrived(*a))
        else:
            try:
                getattr(clock, op)(*a)
            except ValueError as exc:
                out.append(("ValueError", str(exc)))
    return out


@pytest.mark.parametrize("name,num_peers,deadline_s,script", CLOCK_CASES,
                         ids=[c[0] for c in CLOCK_CASES])
def test_clock_matches_jax(name, num_peers, deadline_s, script):
    want = run_clock(jpacer, num_peers, deadline_s, script)
    assert run_clock(tpacer, num_peers, deadline_s, script) == want
    expected = {
        "deadline_masks": [[True, True, False, False], 3, False],
        "expire_rotates_window": [[False, False], [False, False], False,
                                  True],
        "report_offset_against_deadline": [[True, True, False], True,
                                           False],
        "offset_requires_open_round": [
            ("ValueError", "round 3 was never opened")],
        "cold_straggler_and_late_report": [
            [True, True, False], 1, [False, False, False], 0, False]}
    assert want == expected[name]


# -- (b) the masked grad step at dp=2 --------------------------------------

def masks(nb):
    """The masks of the grad-step cases, each (2, nb) f32."""
    rank1 = np.ones((2, nb), np.float32)
    rank1[1] = 0.0
    rank0 = np.ones((2, nb), np.float32)
    rank0[0] = 0.0
    per_bucket = np.array([[(r + b) % 3 != 0 for b in range(nb)]
                           for r in range(2)], np.float32)
    per_bucket[:, 0] = 0.0  # bucket 0 arrives from nobody
    return {"rank1": rank1, "rank0": rank0, "per_bucket": per_bucket,
            "all": np.ones((2, nb), np.float32)}


@pytest.fixture(scope="module")
def grad_cases():
    """JAX's dynamic-valid grad step (f32 and bf16 wires) on a dp=2 mesh
    and the port's on two gloo ranks, from the same weights and batch."""
    cfg = jax_config()
    mesh, params, _, _ = jax_state(MeshSpec(dp=2), cfg)
    init = jax.tree.map(np.asarray, params)
    nb = jtrain.dense_bucket_count(cfg, mesh, params)
    ms = masks(nb)
    tokens = tokens_for(5)
    want = {}
    for wire in ("f32", "bf16"):
        step = jax.jit(jtrain.make_grad_step(jax_config(wire), mesh,
                                             dynamic_valid=True))
        for name, m in ms.items():
            grads, metrics = step(params, jnp.asarray(tokens), valid=m)
            want[wire, name] = (jax.tree.map(np.asarray, grads),
                                int(metrics["min_bucket_count"]))
    resid = np.random.default_rng(1).normal(
        size=(nb, BUCKET)).astype(np.float32) * 1e-2
    cases = [(w, name, m, resid if w == "ef8" else None, False)
             for w in ("f32", "bf16", "int8", "ef8")
             for name, m in ms.items()]
    cases += [(w, "rank1-garbled", ms["rank1"],
               resid if w == "ef8" else None, True)
              for w in ("f32", "int8", "ef8")]
    out = spawn_ranks(ranks.masked_grad_steps, 2, "gloo", "cpu", MODEL,
                      BUCKET, init, tokens,
                      [(w, m, r, g) for w, _, m, r, g in cases])
    got = {(w, name): [o[k] for o in out]
           for k, (w, name, _, _, _) in enumerate(cases)}
    return {"want": want, "got": got, "masks": ms, "resid": resid,
            "nb": nb}


def test_dense_bucket_count_matches_jax(grad_cases):
    cfg = ttrain.TrainConfig(model=ttrain.TransformerConfig(**MODEL),
                             bucket_elems=BUCKET)
    from akka_allreduce_tpu_torch.models.transformer import init_transformer
    params = init_transformer(torch.Generator().manual_seed(0), cfg.model)
    assert ttrain.dense_bucket_count(cfg, params) == grad_cases["nb"]
    assert ttrain.data_rank_count(cfg) == 1


@pytest.mark.parametrize("mask", ["rank1", "rank0", "per_bucket", "all"])
def test_f32_masked_step_matches_jax(grad_cases, mask):
    want_grads, want_count = grad_cases["want"]["f32", mask]
    for grads, count, _ in grad_cases["got"]["f32", mask]:
        assert count == want_count
        for g, w in zip(leaves(grads), leaves(want_grads)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    assert {m: grad_cases["want"]["f32", m][1]
            for m in grad_cases["masks"]} == {
        "rank1": 1, "rank0": 1, "per_bucket": 0, "all": 2}


@pytest.mark.parametrize("mask", ["rank1", "per_bucket", "all"])
def test_bf16_masked_step_inside_the_sync_envelope(grad_cases, mask):
    """The bf16 wire's envelope of the exact sum (test_torch_dp.py's:
    2 x 2^-8 of the absolute contributions, here each rank's gradient
    |g_r| where its bucket arrived, times the count rescale 2 / count),
    against JAX's bf16 and f32 results; the counts exact."""
    got = grad_cases["got"]
    # each rank's own gradient, from the f32 rounds where it alone arrived
    # (the sum is then 2 g_r exactly)
    g0 = flat(got["f32", "rank1"][0][0]) / 2
    g1 = flat(got["f32", "rank0"][0][0]) / 2
    m = grad_cases["masks"][mask]
    per_elem = np.repeat(m, BUCKET, axis=1)[:, :g0.size]
    count = per_elem.sum(axis=0)
    scale = np.where(count > 0, 2 / np.maximum(count, 1), 0)
    abs_sum = (np.abs(g0) * per_elem[0] + np.abs(g1) * per_elem[1]) * scale
    envelope = 2 * 2.0 ** -8 * abs_sum + 1e-7
    for ref in ("f32", "bf16"):
        want, want_count = grad_cases["want"][ref, mask]
        for grads, count_, _ in got["bf16", mask]:
            assert count_ == want_count
            assert np.all(np.abs(flat(grads) - flat(want)) <= envelope)


@pytest.mark.parametrize("wire", ["int8", "ef8"])
def test_quantized_masked_rows_contribute_exact_zeros(grad_cases, wire):
    got, ms = grad_cases["got"], grad_cases["masks"]
    for mask in ms:
        outs = got[wire, mask]
        assert flat(outs[0][0]).tobytes() == flat(outs[1][0]).tobytes()
        assert [o[1] for o in outs] == \
            [grad_cases["want"]["f32", mask][1]] * 2
    # rank 1's data, all masked, cannot reach the result
    for a, b in zip(got[wire, "rank1"], got[wire, "rank1-garbled"]):
        assert flat(a[0]).tobytes() == flat(b[0]).tobytes()
    # a bucket that arrived from nobody averages to zeros
    assert not flat(got[wire, "per_bucket"][0][0])[:BUCKET].any()
    if wire == "ef8":
        resid = grad_cases["resid"]
        assert np.array_equal(got[wire, "rank1"][1][2], resid)
        assert not np.array_equal(got[wire, "rank1"][0][2], resid)
        for r in range(2):
            rows = ms["per_bucket"][r] == 0
            new = got[wire, "per_bucket"][r][2]
            assert np.array_equal(new[rows], resid[rows])
            assert not np.array_equal(new[~rows], resid[~rows])


def test_f32_masked_rank_data_cannot_reach_the_result(grad_cases):
    got = grad_cases["got"]
    for a, b in zip(got["f32", "rank1"], got["f32", "rank1-garbled"]):
        assert flat(a[0]).tobytes() == flat(b[0]).tobytes()


def test_dynamic_step_needs_a_mask():
    cfg = ttrain.TrainConfig(model=ttrain.TransformerConfig(**MODEL),
                             bucket_elems=BUCKET)
    state = ttrain.make_train_state(cfg, torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(cfg, dynamic_valid=True)
    tokens = torch.from_numpy(tokens_for(0))
    with pytest.raises(ValueError, match="dynamic_valid step needs a "
                                         "per-round valid mask"):
        step(state, tokens)
    with pytest.raises(ValueError, match=r"n_data_ranks=1"):
        step(state, tokens, np.ones((2, 3), np.float32))
    assert state.step == 0
    with pytest.raises(ValueError, match="dynamic_valid=True"):
        ttrain.make_train_step(cfg)(state, tokens, np.ones((1, 3)))


# -- (c) the deadline trainer end to end at dp=4 ---------------------------

def script_offsets():
    """Rounds 0-11: every third round one rotating rank misses the 0.5 s
    deadline (arrives at 1.0 s; the rest at 0.1 s); round 12: every rank
    late (the exact fallback); round 13: rank 3 never reports (a cold
    straggler)."""
    out = []
    for i in range(12):
        straggler = (i // 3) % 4 if i % 3 == 0 else None
        out.append([1.0 if p == straggler else 0.1 for p in range(4)])
    out.append([2.0] * 4)
    out.append([0.0, 0.0, 0.0, None])
    return out


@pytest.fixture(scope="module")
def trainer_runs():
    cfg = jax_config(lr=3e-3)
    mesh, params, opt_state, opt = jax_state(MeshSpec(dp=4), cfg, seed=2)
    init = jax.tree.map(np.asarray, params)
    tokens = tokens_for(9)
    step = jtrain.make_train_step(cfg, mesh, opt, dynamic_valid=True)
    clock = jpacer.RoundClock(4, 0.5, clock=lambda: 0.0)
    trainer = JaxDeadlineTrainer(
        step, clock, jtrain.dense_bucket_count(cfg, mesh, params),
        max_lag=2)
    want = {"losses": [], "min_counts": [], "inflight": []}
    for per_peer in script_offsets():
        r = trainer.open_round()
        for peer, off in enumerate(per_peer):
            if off is not None:
                clock.report_offset(r, peer, off)
        params, opt_state, metrics = trainer.run_round(
            params, opt_state, jnp.asarray(tokens))
        want["losses"].append(float(metrics["loss"]))
        want["min_counts"].append(int(metrics["min_bucket_count"]))
        want["inflight"].append(len(trainer.pacer._inflight))
    trainer.drain()
    want["reports"] = [(rep.round, rep.valid_peers, rep.n_masked,
                        rep.fell_back) for rep in trainer.reports]
    want["completed"] = trainer.pacer.completed_rounds
    want["masked_round_count"] = trainer.masked_round_count
    got = spawn_ranks(ranks.deadline_rounds, 4, "gloo", "cpu", MODEL,
                      {"bucket_elems": BUCKET, "learning_rate": 3e-3},
                      init, tokens, script_offsets(), 0.5, 2)
    return want, got


def test_trainer_reports_and_counts_equal_jax(trainer_runs):
    want, got = trainer_runs
    for run in got:
        assert run["reports"] == want["reports"]
        assert run["min_counts"] == want["min_counts"]
        assert run["masked_round_count"] == want["masked_round_count"]
    counts = want["min_counts"]
    assert counts[:12] == [3 if i % 3 == 0 else 4 for i in range(12)]
    # the all-late round ran exact but reports what the clock saw
    assert counts[12] == 4 and want["reports"][12][2:] == (4, True)
    # the silent peer is masked without stalling the round
    assert counts[13] == 3 and want["reports"][13][1][3] is False
    assert want["masked_round_count"] == 6


def test_trainer_losses_match_jax(trainer_runs):
    want, got = trainer_runs
    for run in got:
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=1e-4)
    assert want["losses"][-1] < want["losses"][0]


def test_trainer_pacer_bounds_rounds_in_flight(trainer_runs):
    want, got = trainer_runs
    for run in got:
        assert max(run["inflight"]) <= 3  # max_lag 2: the ring's depth
        assert run["completed"] == want["completed"] == list(range(14))
    assert max(want["inflight"]) <= 3


# -- (d) mask rows follow the (dp, sp) order -------------------------------

def test_sp_rank_row_at_dp1_sp2():
    cfg = jax_config(grad_axes=("dp", "sp"))
    mesh, params, _, _ = jax_state(MeshSpec(dp=1, sp=2), cfg)
    nb = jtrain.dense_bucket_count(cfg, mesh, params)
    assert jtrain.data_rank_count(cfg, mesh) == 2
    mask = np.ones((2, nb), np.float32)
    mask[1] = 0.0
    tokens = tokens_for(3)
    step = jax.jit(jtrain.make_grad_step(cfg, mesh, dynamic_valid=True))
    want, metrics = step(params, jnp.asarray(tokens), valid=mask)
    assert int(metrics["min_bucket_count"]) == 1
    out = spawn_ranks(ranks.masked_grad_steps, 2, "gloo", "cpu", MODEL,
                      BUCKET, jax.tree.map(np.asarray, params), tokens,
                      [("f32", mask, None, False)], sp=2)
    for ((grads, count, _),) in out:
        assert count == 1
        # atol 1e-6: the ring attention sums in another order than JAX's,
        # which moves gradients near zero by ~2e-7
        for g, w in zip(leaves(grads), leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- (e) train --deadline-ms ------------------------------------------------

def args(*extra) -> argparse.Namespace:
    return cli.build_parser().parse_args(ARGV + list(extra))


def cli_lates(steps, prob, ranks_=2):
    """The JAX command's straggle draw: ``default_rng(i)`` draws the
    global batch, then one ``random()`` per data rank in rank order."""
    out = []
    for i in range(steps):
        rng = np.random.default_rng(i)
        rng.integers(0, 97, size=(B, T), dtype=np.int32)
        out.append([rng.random() < prob for _ in range(ranks_)])
    return out


@pytest.fixture(scope="module")
def deadline_cli():
    """JAX weights on a dp=2 mesh, a JAX DeadlineTrainer fed the CLI's
    draws, and the port's command from the same weights."""
    cfg = jax_config()
    mesh, params, opt_state, opt = jax_state(MeshSpec(dp=2), cfg)
    init = jax.tree.map(np.asarray, params)
    step = jtrain.make_train_step(cfg, mesh, opt, dynamic_valid=True)
    clock = jpacer.RoundClock(2, 0.05)
    trainer = JaxDeadlineTrainer(
        step, clock, jtrain.dense_bucket_count(cfg, mesh, params))
    losses = []
    for i, lates in enumerate(cli_lates(4, 0.5)):
        r = trainer.open_round()
        for peer, late in enumerate(lates):
            clock.report_offset(r, peer, (2.0 if late else 0.0) * 0.05)
        params, opt_state, m = trainer.run_round(
            params, opt_state, jnp.asarray(tokens_for(i)))
        losses.append(float(m["loss"]))
    trainer.drain()
    return init, losses, trainer.reports


def test_cli_deadline_masks_losses_and_lines(deadline_cli, capfd):
    from akka_allreduce_tpu_torch import convert
    init, want_losses, want_reports = deadline_cli
    report = cli.run_train(args(*DEADLINE),
                           params=convert.params_from_jax(init))
    out = capfd.readouterr().out.splitlines()
    lates = cli_lates(4, 0.5)
    rounds = report["deadline"]["rounds"]
    assert [r["valid_peers"] for r in rounds] == \
        [[not x for x in late] for late in lates] == \
        [list(rep.valid_peers) for rep in want_reports]
    assert [r["n_masked"] for r in rounds] == [sum(x) for x in lates]
    assert [r["min_bucket_count"] for r in rounds] == \
        [2 - sum(x) for x in lates]
    assert report["deadline"]["masked_round_count"] == 1
    np.testing.assert_allclose(report["losses"], want_losses, rtol=1e-4)
    steps = [ln for ln in out if ln.startswith("step ")]
    assert steps[0].endswith("[masked 1/2 ranks, min_count 1]")
    assert all(ln.endswith("[masked 0/2 ranks, min_count 2]")
               for ln in steps[1:]) and len(steps) == 4
    assert "lossy rounds: 1/4 had masked contributions (0 all-masked, " \
        "ran exact for liveness)" in out
    sums = [r["param_checksum"] for r in report["ranks"]]
    assert sums[0] == sums[1]


def test_cli_fallback_line_at_one_rank(capfd):
    """One data rank that is late falls back to an exact round."""
    report = cli.run_train(cli.build_parser().parse_args(
        ["train", "--device", "cpu", "--steps", "2", "--log-every", "1",
         "--deadline-ms", "5", "--straggle-prob", "1.0", "--max-lag",
         "0"]))
    out = capfd.readouterr().out
    assert "[masked 1/1 ranks FELL BACK TO EXACT, min_count 1]" in out
    assert "lossy rounds: 2/2 had masked contributions (2 all-masked" in out
    assert [r["fell_back"] for r in report["deadline"]["rounds"]] == \
        [True, True]
    assert report["deadline"]["max_lag"] == 0


@pytest.mark.parametrize("flags,match", [
    (["--deadline-ms", "-1"], "--deadline-ms must be >= 0 (0 disables "
                              "deadlines)"),
    (["--straggle-prob", "0.5"], "--straggle-prob needs --deadline-ms"),
    (["--deadline-ms", "50", "--max-lag", "-1"], "max_lag must be >= 0")])
def test_deadline_refusals_exit_2(capsys, flags, match):
    assert cli.main(ARGV + flags) == 2
    assert match in capsys.readouterr().err


def test_ef8_deadline_resume_equals_the_uninterrupted_run(tmp_path):
    flags = ["--grad-quant", "ef8", "--ckpt-every", "1", *DEADLINE]

    def run(steps, directory=None):
        extra = ["--ckpt-dir", str(directory)] if directory else []
        return cli.run_train(args(*flags, "--steps", str(steps), *extra))

    whole = run(4)
    run(2, tmp_path)
    resumed = run(4, tmp_path)
    assert resumed["config"]["start_step"] == 2
    assert [r["step"] for r in resumed["deadline"]["rounds"]] == [2, 3]
    assert whole["deadline"]["rounds"][2:] == resumed["deadline"]["rounds"]
    assert resumed["losses"] == whole["losses"][2:]
    assert resumed["ranks"][1]["param_checksum"] == \
        whole["ranks"][1]["param_checksum"]
