"""The orbax converter (``scripts/orbax_to_torch.py``, mapping in
``akka_allreduce_tpu_torch/convert.py``): a JAX training checkpoint
resumed by the port.

The JAX package trains a tiny model for 2 steps and saves it through its
own ``CheckpointManager`` (adamw with EMA; lion, adafactor and sgd; adamw
on the ef8 wire at dp=2 with the ``sync`` item). The script converts the
step; every array of the port's checkpoint is bitwise the orbax array it
came from (params, the chain's moments and counts, the EMA, each rank's
residual). ``train --ckpt-dir`` of the port then resumes and takes 2 more
steps on the batches the JAX run takes next: losses at rtol 1e-4 of
JAX's continuation (the port's train parity bound,
``tests/test_torch_train.py``) on the f32 wire, within the JAX tests'
fixed bound of 0.05 on ef8 (its rounding bits are the port's own, so
only statistical parity holds); parameters at atol 2e-4, rtol 1e-3 (the
five-step bound of ``test_torch_train.py``). A checkpoint without
``opt_state`` or ``params`` fails with an error that names them (ROADMAP
C6), and a chain of another family or length fails naming the flags.
"""

import importlib.util
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu.runtime.checkpoint import (CheckpointConfig,
                                                   CheckpointManager)
from akka_allreduce_tpu_torch import cli, convert
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
    / "orbax_to_torch.py"
MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=1, d_ff=256,
             max_seq=16)
B, T, LR, BUCKET = 4, 16, 1e-2, 256
ARGV = ["train", "--device", "cpu", "--vocab", "97", "--d-model", "64",
        "--n-heads", "4", "--n-layers", "1", "--d-ff", "256", "--seq",
        str(T), "--batch", str(B), "--lr", str(LR), "--bucket-elems",
        str(BUCKET), "--log-every", "1"]
# (optimizer, ema_decay, wire, dp)
CASES = {"adamw_ema": ("adamw", 0.9, "f32", 1),
         "lion": ("lion", 0.0, "f32", 1),
         "adafactor": ("adafactor", 0.0, "f32", 1),
         "sgd": ("sgd", 0.0, "f32", 1),
         "ef8_dp2": ("adamw", 0.0, "ef8", 2)}


def script():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batch(i):
    return np.random.default_rng(i).integers(0, MODEL["vocab_size"],
                                             size=(B, T), dtype=np.int32)


def jax_run(case, directory):
    """2 JAX steps saved at step 1 (the JAX command's item set), then 2
    more: the continuation's losses and final params, and the saved
    state as numpy."""
    fam, ema, wire, dp = CASES[case]
    mesh = make_device_mesh(MeshSpec(dp=dp), devices=jax.devices()[:dp])
    cfg = jtrain.TrainConfig(
        model=jtf.TransformerConfig(**MODEL), grad_axes=("dp",),
        bucket_elems=BUCKET, learning_rate=LR, optimizer=fam,
        ema_decay=ema, grad_transport=wire, attn_impl="local")
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0), cfg,
                                                     mesh)
    step = jtrain.make_train_step(cfg, mesh, opt, donate=False)
    ef = jtrain.init_ef_state(cfg, mesh, params)
    losses = []

    def run(i):
        nonlocal params, opt_state, ef
        tokens = jnp.asarray(batch(i))
        if ef is None:
            params, opt_state, m = step(params, opt_state, tokens)
        else:
            params, opt_state, m, ef = step(params, opt_state, tokens, ef)
        losses.append(float(m["loss"]))
    for i in range(2):
        run(i)
    mgr = CheckpointManager(CheckpointConfig(str(directory)))
    mgr.save(1, params, opt_state, {"data_step": 1}, force=True,
             ema=jtrain.get_ema_params(opt_state),
             sync=None if ef is None else {"residual": ef})
    mgr.wait_until_finished()
    saved = {"params": jax.tree.map(np.asarray, params),
             "opt_state": jax.tree.map(np.asarray, opt_state),
             "ef": None if ef is None else np.asarray(ef)}
    for i in range(2, 4):
        run(i)
    return saved, losses[2:], jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=list(CASES))
def converted(request, tmp_path_factory):
    case = request.param
    fam, ema, wire, dp = CASES[case]
    root = tmp_path_factory.mktemp(case)
    saved, cont, final = jax_run(case, root / "jax")
    mod = script()
    out = root / "port"
    path = mod.convert(str(root / "jax"), str(out), mod.port_config(
        fam, ema, bucket_elems=BUCKET))
    return case, saved, cont, final, str(out), path


def test_converted_arrays_are_the_orbax_arrays(converted):
    case, saved, _, _, _, path = converted
    fam, ema, _, dp = CASES[case]
    load = lambda name: torch.load(os.path.join(path, name),  # noqa: E731
                                   weights_only=True)
    params = tree_leaves(load("params.pt"))
    want = tree_leaves(convert.params_from_jax(saved["params"]))
    assert all(torch.equal(a, b) for a, b in zip(params, want))
    opt = load("opt_state.pt")
    counter, core = saved["opt_state"][0], saved["opt_state"][1]
    assert opt["count"] == int(counter.count) == 2
    # the port's optimizer numbers its leaves group by group: rank >= 2
    # first (weight decay), then the rest; sgd has one group
    order = (list(range(len(params))) if fam == "sgd" else
             [i for i, p in enumerate(params) if p.dim() >= 2]
             + [i for i, p in enumerate(params) if p.dim() < 2])
    state = opt["optimizer"]["state"]
    fields = {"adamw": {"exp_avg": "mu", "exp_avg_sq": "nu"},
              "lion": {"mu": "mu"}, "sgd": {"trace": "trace"},
              "adafactor": {"v": "v", "v_row": "v_row", "v_col": "v_col"}
              }[fam]
    slot = core[0]
    for k, leaf in enumerate(order):
        for port_key, jax_key in fields.items():
            if port_key not in state[k]:
                assert fam == "adafactor"  # the other factor's placeholder
                continue
            moment = tree_leaves(convert.params_from_jax(
                getattr(slot, jax_key)))[leaf]
            assert torch.equal(state[k][port_key], moment), (leaf, port_key)
        if fam in ("adamw", "adafactor"):
            assert float(state[k]["step"]) == int(slot.count) == 2
    if ema:
        got = tree_leaves(load("ema.pt"))
        want = tree_leaves(convert.params_from_jax(
            jtrain.get_ema_params(saved["opt_state"])))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert not os.path.exists(os.path.join(path, "ema.pt"))
    if saved["ef"] is not None:
        for r in range(dp):
            assert torch.equal(load(f"sync-{r}.pt"),
                               torch.from_numpy(saved["ef"][r]))


def test_the_port_resumes_within_the_parity_bound(converted):
    case, _, cont, final, out, _ = converted
    fam, ema, wire, dp = CASES[case]
    flags = ["--steps", "4", "--ckpt-dir", out, "--optimizer", fam]
    if ema:
        flags += ["--ema-decay", str(ema)]
    if dp > 1:
        flags += ["--dp", str(dp), "--grad-quant", wire]
    report = cli.run_train(cli.build_parser().parse_args(ARGV + flags))
    assert report["config"]["start_step"] == 2
    if wire == "ef8":
        np.testing.assert_allclose(report["losses"], cont, rtol=0,
                                   atol=0.05)
        return
    np.testing.assert_allclose(report["losses"], cont, rtol=1e-4)
    got = torch.load(os.path.join(out, "3", "params.pt"), weights_only=True)
    for a, b in zip(tree_leaves(got),
                    tree_leaves(convert.params_from_jax(final))):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=2e-4,
                                   rtol=1e-3)


def test_a_checkpoint_without_opt_state_or_params_names_them(tmp_path):
    """ROADMAP C6: the JAX package's legacy fallback reads
    ``raw["opt_state"]`` unguarded (a bare KeyError); the converter names
    the missing items."""
    cfg = script().port_config("adamw")
    with pytest.raises(ValueError, match="lacks opt_state .*'params'"):
        convert.train_state_from_jax({"params": {"w": np.ones((2, 2))},
                                      "extra": {}}, cfg)
    with pytest.raises(ValueError, match="lacks params and opt_state"):
        convert.train_state_from_jax({"extra": {}}, cfg)
    # an orbax step that holds params alone (a weights-only save)
    import orbax.checkpoint as ocp
    mgr = ocp.CheckpointManager(str(tmp_path / "jax"))
    mgr.save(0, args=ocp.args.Composite(
        params=ocp.args.StandardSave({"w": np.ones((2, 2), np.float32)})))
    mgr.wait_until_finished()
    with pytest.raises(ValueError, match="lacks opt_state"):
        script().convert(str(tmp_path / "jax"), str(tmp_path / "out"), cfg)


def test_a_chain_of_another_family_or_length_names_the_flags(converted):
    case, saved, _, _, _, _ = converted
    if case != "lion":
        pytest.skip("one checkpoint suffices")
    params = convert.params_from_jax(saved["params"])
    mod = script()
    raw = [{"count": np.asarray(2)}, [{"count": np.asarray(2),
                                       "mu": saved["params"]}, None, None]]
    with pytest.raises(ValueError, match="--optimizer adamw keeps"):
        convert.optimizer_state_from_jax(mod.port_config("adamw"), params,
                                         raw)
    with pytest.raises(ValueError, match="has 2 slots; this run's"):
        convert.optimizer_state_from_jax(
            mod.port_config("lion", ema_decay=0.5), params, raw)
    got = convert.optimizer_state_from_jax(mod.port_config("lion"), params,
                                           raw)
    assert got["count"] == 2
