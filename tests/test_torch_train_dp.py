"""Data-parallel training: the port's ``train --dp 2`` against the JAX step.

JAX initialises the weights on a dp=2 mesh and ``convert.params_from_jax``
carries them into the port; the same global batches (``default_rng(i)``,
as both commands draw them) then train through JAX's ``make_train_step``
on the mesh and through the port's ``run_train`` with two gloo ranks on
the CPU, each rank on its half of the batch. Pins: f32 step-0 loss at
rtol 1e-5 and the 3-step loss trajectory at rtol 1e-4 of JAX's; dp=2
against the port's own dp=1 on the same global batch at rtol 1e-5; the
int8 and ef8 wires inside the JAX tests' fixed loss bound (0.05) of the
f32 run; ranks ending with bitwise-equal parameters; the command's output
and its refusals.
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
             n_layers=2, d_ff=128, max_seq=16, rope=True)
B, T, STEPS, LR = 4, 16, 3, 1e-2
ARGV = ["train", "--device", "cpu", "--vocab", "97", "--d-model", "64",
        "--n-heads", "4", "--kv-heads", "2", "--rope", "--n-layers", "2",
        "--d-ff", "128", "--seq", str(T), "--batch", str(B), "--lr",
        str(LR), "--steps", str(STEPS), "--bucket-elems", "256",
        "--log-every", "1"]


def args(*extra) -> argparse.Namespace:
    return cli.build_parser().parse_args(ARGV + list(extra))


@pytest.fixture(scope="module")
def jax_run():
    """JAX weights on a dp=2 mesh and its 3-step losses."""
    mesh = make_device_mesh(MeshSpec(dp=2), devices=jax.devices()[:2])
    cfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                             grad_axes=("dp",), bucket_elems=256,
                             learning_rate=LR, attn_impl="local")
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0), cfg,
                                                     mesh)
    init = jax.tree.map(np.asarray, params)
    step = jtrain.make_train_step(cfg, mesh, opt)
    losses = []
    for i in range(STEPS):
        tokens = np.random.default_rng(i).integers(0, 97, size=(B, T),
                                                   dtype=np.int32)
        params, opt_state, m = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(m["loss"]))
    return init, losses


@pytest.fixture(scope="module")
def f32_dp2(jax_run):
    init, _ = jax_run
    return cli.run_train(args("--dp", "2"),
                         params=convert.params_from_jax(init))


def test_dp2_f32_matches_jax(jax_run, f32_dp2):
    _, want = jax_run
    got = f32_dp2["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert f32_dp2["dist"] == {"backend": "gloo", "world": 2}
    assert f32_dp2["config"]["dp"] == 2 and f32_dp2["config"]["batch"] == B


def test_dp2_equals_dp1_on_the_same_global_batch(jax_run, f32_dp2):
    init, _ = jax_run
    one = cli.run_train(args(), params=convert.params_from_jax(init))
    np.testing.assert_allclose(f32_dp2["losses"], one["losses"], rtol=1e-5)


def test_ranks_end_bitwise_equal_and_report(f32_dp2):
    ranks = f32_dp2["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["param_checksum"] == ranks[1]["param_checksum"]
    assert all(len(r["sync_ms"]) == STEPS for r in ranks)
    assert all(r["peak_memory_gb"] is None for r in ranks)  # the CPU
    # the CPU runs the plain versions: no kernel launched
    assert not any(f32_dp2["sync_launches"].values())
    assert not any(f32_dp2["launches"].values())


@pytest.mark.parametrize("wire", ["int8", "ef8"])
def test_quantized_wires_stay_near_f32(jax_run, f32_dp2, wire):
    """The JAX tests' fixed bound (TestEf8Training: 0.05 per step)."""
    init, _ = jax_run
    run = cli.run_train(args("--dp", "2", "--grad-quant", wire),
                        params=convert.params_from_jax(init))
    assert all(np.isfinite(run["losses"]))
    deltas = np.abs(np.subtract(run["losses"], f32_dp2["losses"]))
    assert deltas.max() < 0.05, deltas
    assert run["losses"] != f32_dp2["losses"]  # it did quantize
    sums = [r["param_checksum"] for r in run["ranks"]]
    assert sums[0] == sums[1]


def test_cli_dp2_ef8_prints_the_step_lines(capfd):
    rc = cli.main(["train", "--device", "cpu", "--dp", "2", "--grad-quant",
                   "ef8", "--steps", "3", "--log-every", "1"])
    out = capfd.readouterr().out.strip().splitlines()
    assert rc == 0
    steps = [ln for ln in out if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == [
        "step    1", "step    2", "step    3"]  # rank 0 alone prints
    assert all("loss" in ln and "tok/s)" in ln for ln in steps)
    assert any("dp=2 (gloo) wire=ef8" in ln for ln in out)


@pytest.mark.parametrize("flags,match", [
    (["--dp", "2", "--grad-schedule", "hierarchical"],
     "pair it with --grad-quant ef8"),
    (["--dp", "2", "--grad-quant", "ef8", "--grad-schedule",
      "hierarchical"], "needs exactly two >1 data axes"),
    (["--dp", "2", "--sp", "2", "--grad-quant", "int8", "--grad-schedule",
      "auto"], "needs a single >1 data axis"),
    (["--dp", "3", "--grad-schedule", "swing", "--batch", "6"],
     "power-of-two"),
    (["--dp", "3"], "divide over --dp"),
    (["--dp", "2", "--dist-backend", "nccl"], "--dist-backend gloo"),
    (["--int8-grads", "--grad-quant", "ef8"], "contradicts"),
    (["--int8-grads", "--bf16-grads"], "ONE gradient wire")])
def test_refusals_exit_2(capsys, flags, match):
    assert cli.main(ARGV + flags) == 2
    assert match in capsys.readouterr().err


def test_grad_wire_aliases():
    assert cli.grad_wire(args("--int8-grads")) == "int8"
    assert cli.grad_wire(args("--bf16-grads", "--grad-quant", "bf16")) == \
        "bf16"
    assert cli.grad_wire(args("--grad-quant", "none")) == "f32"
    assert cli.train_config(args("--grad-quant", "ef8", "--grad-schedule",
                                 "swing", "--grad-windows", "3"), T) \
        .grad_transport == "ef8"


def test_dp2_ef8_checkpoint_resume_equals_the_uninterrupted_run(tmp_path):
    """Rank 0 writes params and optimizer, each rank its residual; the
    resumed run restores them (the residual bitwise) and continues as if
    never stopped."""
    ckpt = ["--dp", "2", "--grad-quant", "ef8", "--ckpt-every", "1"]

    def run(steps, directory=None):
        extra = ["--ckpt-dir", str(directory)] if directory else []
        return cli.run_train(args(*ckpt, "--steps", str(steps),
                                  *extra))

    whole = run(4)
    first = run(2, tmp_path)
    assert sorted(p.name for p in (tmp_path / "1").iterdir()) == [
        "extra.json", "opt_state.pt", "params.pt", "sync-0.pt", "sync-1.pt"]
    resumed = run(4, tmp_path)
    assert resumed["config"]["start_step"] == 2
    assert first["losses"] + resumed["losses"] == whole["losses"]
    assert resumed["ranks"][0]["param_checksum"] == \
        whole["ranks"][0]["param_checksum"]
