"""Sequence-parallel training: the port's ``train --sp`` against the JAX step.

JAX initialises the weights on a ``MeshSpec(sp=2)`` mesh and
``convert.params_from_jax`` carries them into the port; the same global
batches (``default_rng(i)``, as both commands draw them) then train
through JAX's ``make_train_step`` (``attn_impl="local"``: its pure ring)
on ``MeshSpec(sp=2)`` and ``MeshSpec(dp=2, sp=2)``, and through the port's
``run_train`` with ``--sp 2`` and ``--dp 2 --sp 2`` gloo ranks on the CPU
(its default attention: the ring of the flash kernels' plain versions).
Pins: the f32 step-0 loss at rtol 1e-5 and the 3-step trajectory at rtol
1e-4 of JAX's, as ``test_torch_train_dp.py``; the sp run equal to the
port's own sp=1 run on the same global batch at rtol 1e-5 (a wrong token
count or boundary target moves step 0 by percents); a windowed model
under sp against its sp=1 run; ranks ending bitwise equal; an ef8
``--sp 2`` checkpoint resume equal to the run without the interruption;
and the command's refusals.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch import cli, convert

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=32, rope=True)
B, T, STEPS, LR = 4, 32, 3, 1e-2
ARGV = ["train", "--device", "cpu", "--vocab", "97", "--d-model", "64",
        "--n-heads", "4", "--kv-heads", "2", "--rope", "--n-layers", "2",
        "--d-ff", "128", "--seq", str(T), "--batch", str(B), "--lr",
        str(LR), "--steps", str(STEPS), "--bucket-elems", "256",
        "--log-every", "1"]


def args(*extra) -> argparse.Namespace:
    return cli.build_parser().parse_args(ARGV + list(extra))


def jax_losses(spec: MeshSpec, init=None):
    """JAX's 3-step losses on ``spec`` (and its initial weights)."""
    n = spec.dp * spec.sp
    mesh = make_device_mesh(spec, devices=jax.devices()[:n])
    cfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                             bucket_elems=256, learning_rate=LR,
                             attn_impl="local")
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0), cfg,
                                                     mesh)
    first = jax.tree.map(np.asarray, params)
    step = jtrain.make_train_step(cfg, mesh, opt)
    losses = []
    for i in range(STEPS):
        tokens = np.random.default_rng(i).integers(0, 97, size=(B, T),
                                                   dtype=np.int32)
        params, opt_state, m = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(m["loss"]))
    return first, losses


@pytest.fixture(scope="module")
def jax_sp2():
    return jax_losses(MeshSpec(sp=2))


@pytest.fixture(scope="module")
def port_sp2(jax_sp2):
    init, _ = jax_sp2
    return cli.run_train(args("--sp", "2"),
                         params=convert.params_from_jax(init))


def test_sp2_matches_jax(jax_sp2, port_sp2):
    _, want = jax_sp2
    got = port_sp2["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert port_sp2["dist"] == {"backend": "gloo", "world": 2}
    assert (port_sp2["config"]["dp"], port_sp2["config"]["sp"]) == (1, 2)


def test_dp2_sp2_matches_jax(jax_sp2):
    init, _ = jax_sp2
    _, want = jax_losses(MeshSpec(dp=2, sp=2))
    run = cli.run_train(args("--dp", "2", "--sp", "2"),
                        params=convert.params_from_jax(init))
    np.testing.assert_allclose(run["losses"][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(run["losses"], want, rtol=1e-4)
    assert run["dist"]["world"] == 4
    assert len({r["param_checksum"] for r in run["ranks"]}) == 1


def test_sp2_equals_sp1_on_the_same_global_batch(jax_sp2, port_sp2):
    init, _ = jax_sp2
    one = cli.run_train(args(), params=convert.params_from_jax(init))
    np.testing.assert_allclose(port_sp2["losses"], one["losses"], rtol=1e-5)


def test_ranks_end_bitwise_equal_and_report(port_sp2):
    ranks = port_sp2["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["param_checksum"] == ranks[1]["param_checksum"]
    assert all(len(r["attn_exchange_ms"]) == STEPS
               and all(ms > 0 for ms in r["attn_exchange_ms"])
               for r in ranks)
    # the CPU runs the plain versions: no kernel launched
    assert not any(port_sp2["ring_launches"].values())
    assert not any(port_sp2["launches"].values())


@pytest.mark.parametrize("impl", [None, "local"])
def test_windowed_model_under_sp_equals_sp1(impl):
    """The neighbour-tail exchange (window 12 over T_local 16): the flash
    path ("auto") and the plain path ("local") against one rank."""
    one = cli.run_train(args("--attn-window", "12"), attn_impl=impl)
    two = cli.run_train(args("--attn-window", "12", "--sp", "2"),
                        attn_impl=impl)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)


def test_cli_sp2_prints_the_step_lines(capfd):
    rc = cli.main(["train", "--device", "cpu", "--sp", "2", "--steps", "2",
                   "--log-every", "1"])
    out = capfd.readouterr().out.strip().splitlines()
    assert rc == 0
    steps = [ln for ln in out if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == ["step    1", "step    2"]
    # the default sequence is 32 x sp
    assert any("seq=64" in ln and "dp=1 sp=2 (gloo)" in ln for ln in out)


def test_sp2_ef8_checkpoint_resume_equals_the_uninterrupted_run(tmp_path):
    """Rank 0 writes params and optimizer, each rank its own residual
    (the two sp ranks' gradients, and so their residuals, differ)."""
    ckpt = ["--sp", "2", "--grad-quant", "ef8", "--ckpt-every", "1"]

    def run(steps, directory=None):
        extra = ["--ckpt-dir", str(directory)] if directory else []
        return cli.run_train(args(*ckpt, "--steps", str(steps), *extra))

    whole = run(4)
    first = run(2, tmp_path)
    assert sorted(p.name for p in (tmp_path / "1").iterdir()) == [
        "extra.json", "opt_state.pt", "params.pt", "sync-0.pt", "sync-1.pt"]
    resumed = run(4, tmp_path)
    assert resumed["config"]["start_step"] == 2
    assert first["losses"] + resumed["losses"] == whole["losses"]
    assert resumed["ranks"][1]["param_checksum"] == \
        whole["ranks"][1]["param_checksum"]


@pytest.mark.parametrize("flags,match", [
    (["--dp", "2", "--sp", "2", "--grad-quant", "int8"],
     "needs a single >1 data axis, got dp=2 sp=2"),
    (["--dp", "2", "--sp", "2", "--grad-schedule", "windowed"],
     "needs a single >1 data axis"),
    (["--sp", "3", "--seq", "30", "--grad-schedule", "swing"],
     "power-of-two data-axis size"),
    (["--sp", "3"], "must divide over --sp 3"),
    (["--sp", "2", "--attn-window", "20"], "window - 1 <= local sequence"),
    (["--sp", "0"], "must be >= 1")])
def test_refusals_exit_2(capsys, flags, match):
    assert cli.main(ARGV + flags) == 2
    assert match in capsys.readouterr().err
