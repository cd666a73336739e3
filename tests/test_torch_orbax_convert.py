"""The orbax converter (``scripts/orbax_to_torch.py``, mapping in
``akka_allreduce_tpu_torch/convert.py``): a JAX training checkpoint
resumed by the port.

The JAX package trains a tiny model for 2 steps and saves it through its
own ``CheckpointManager`` (adamw with EMA; lion, adafactor and sgd; adamw
on the ef8 wire with the ``sync`` item at dp=2, at dp=2 x pp=2 (planes of
each stage's stacked tree) and, for an MoE model, at ep=2 (the
``{"dense", "expert"}`` planes)). The script converts the step, with the
run's mesh flags; every array of the port's checkpoint is bitwise the
orbax array it came from (params, the chain's moments and counts, the
EMA, each port rank's residual: the JAX plane that
``convert.jax_plane_index`` names, JAX stacking its planes over ``(dp,
sp, ep, tp, pp)`` and the port numbering its ranks over ``(pp, dp, ep,
sp, tp)``; at dp=2 x pp=2 the two orders differ; the stages' copies
of a replicated leaf drift apart on ef8 at pp > 1, ROADMAP C15, so such
a leaf is held element by element to one of them). ``train --ckpt-dir``
of the port then resumes, at the same mesh, and takes 2 more
steps on the batches the JAX run takes next: losses at rtol 1e-4 of
JAX's continuation (the port's train parity bound,
``tests/test_torch_train.py``) on the f32 wire, within the JAX tests'
fixed bound of 0.05 on ef8 (its rounding bits are the port's own, so
only statistical parity holds); parameters at atol 2e-4, rtol 1e-3 (the
five-step bound of ``test_torch_train.py``). A checkpoint without
``opt_state`` or ``params`` fails with an error that names them (ROADMAP
C6), a chain of another family or length fails naming the flags, and
so do planes that do not fit the mesh the flags name (their count, or a
rank's bucket count). The permutation is held against JAX's own layout:
the device that holds plane j of a JAX residual is the port's rank
whose plane ``jax_plane_index`` says is j.
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
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu.runtime.checkpoint import (CheckpointConfig,
                                                   CheckpointManager)
from akka_allreduce_tpu_torch import cli, convert
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" \
    / "orbax_to_torch.py"
MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=1, d_ff=256,
             max_seq=16)
MOE = dict(n_experts=4, d_ff=256, capacity_factor=1.25, router_k=2)
B, T, LR, BUCKET = 4, 16, 1e-2, 256
ARGV = ["train", "--device", "cpu", "--vocab", "97", "--d-model", "64",
        "--n-heads", "4", "--n-layers", "1", "--d-ff", "256", "--seq",
        str(T), "--batch", str(B), "--lr", str(LR), "--bucket-elems",
        str(BUCKET), "--log-every", "1"]
# (optimizer, ema_decay, wire, mesh)
CASES = {"adamw_ema": ("adamw", 0.9, "f32", {"dp": 1}),
         "lion": ("lion", 0.0, "f32", {"dp": 1}),
         "adafactor": ("adafactor", 0.0, "f32", {"dp": 1}),
         "sgd": ("sgd", 0.0, "f32", {"dp": 1}),
         "ef8_dp2": ("adamw", 0.0, "ef8", {"dp": 2}),
         "moe_ef8_ep2": ("adamw", 0.0, "ef8", {"ep": 2}),
         "ef8_dp2_pp2": ("adamw", 0.0, "ef8", {"dp": 2, "pp": 2})}


def model_of(case):
    """The case's JAX model fields and the port flags that name them: an
    MoE model (every layer 4 experts) for ep, two layers for pp (one a
    stage, two microbatches)."""
    mesh = CASES[case][3]
    if mesh.get("ep", 1) > 1:
        return dict(MODEL, moe_every=1), MOE, [
            "--moe-experts", "4", "--moe-every", "1", "--router-k", "2",
            "--capacity-factor", "1.25"]
    if mesh.get("pp", 1) > 1:
        return dict(MODEL, n_layers=2), None, ["--n-layers", "2"]
    return MODEL, None, []


def mesh_flags(mesh):
    return [f for a, n in mesh.items() for f in (f"--{a}", str(n))]


def top_copies(tree):
    """Each leaf of ``tree`` outside the layers (a JAX tree on the mesh):
    its full copies, one a device that holds it whole. A replicated
    leaf's copies are one array, except the non-layer leaves of an ef8
    run at pp > 1, whose stages' copies differ (ROADMAP C15): the
    checkpoint then holds pieces of each."""
    return {k: [np.asarray(s.data) for s in v.addressable_shards
                if s.data.shape == v.shape]
            for k, v in tree.items() if k != "layers"}


def top_keys(tree):
    """The top-level key of each leaf of the JAX params-shaped ``tree``
    in the port's list layout."""
    port = convert.params_from_jax(listed(tree))
    return [k for k in sorted(port) for _ in tree_leaves(port[k])]


def same_leaf(got, want, copies) -> bool:
    """``got`` bitwise ``want``, or (a non-layer leaf whose copies differ)
    every element bitwise that element of one of its ``copies``: orbax
    writes the pieces of a replicated array from different replicas."""
    if torch.equal(got, want):
        return True
    if not copies:
        return False
    stack = torch.stack([torch.from_numpy(np.array(c)) for c in copies])
    return bool((stack == got).any(dim=0).all())


def listed(tree):
    """A params-shaped numpy tree in the list layout (a pp run's stacked
    layers unstacked, as the converter writes them)."""
    return convert.unstack_jax_items({"params": tree})["params"]


def port_rank(r, mesh):
    """The port's rank ``r`` on ``mesh`` (a ``RankGroup`` without a
    process group: coordinates only)."""
    from akka_allreduce_tpu_torch.parallel.group import RankGroup
    world = int(np.prod(list(mesh.values())))
    return RankGroup(r, world, "gloo", torch.device("cpu"), mesh.get("sp", 1),
                     ep=mesh.get("ep", 1), tp=mesh.get("tp", 1),
                     pp=mesh.get("pp", 1))


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
    fam, ema, wire, spec = CASES[case]
    spec = MeshSpec(**spec)
    mesh = make_device_mesh(spec, devices=jax.devices()[:spec.size])
    model, moe, _ = model_of(case)
    cfg = jtrain.TrainConfig(
        model=jtf.TransformerConfig(
            **model, moe=None if moe is None else JMoE(**moe)),
        grad_axes=("dp",), bucket_elems=BUCKET, learning_rate=LR,
        optimizer=fam, ema_decay=ema, grad_transport=wire,
        attn_impl="local", microbatches=spec.pp)
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
    slot = opt_state[1][0]
    saved = {"params": jax.tree.map(np.asarray, params),
             "opt_state": jax.tree.map(np.asarray, opt_state),
             "ef": None if ef is None else jax.tree.map(np.asarray, ef),
             "copies": {k: top_copies(getattr(slot, k))
                        for k in ("mu", "nu", "trace", "v")
                        if isinstance(getattr(slot, k, None), dict)}}
    saved["copies"]["params"] = top_copies(params)
    for i in range(2, 4):
        run(i)
    return saved, losses[2:], jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=list(CASES))
def converted(request, tmp_path_factory):
    case = request.param
    fam, ema, wire, mesh = CASES[case]
    root = tmp_path_factory.mktemp(case)
    saved, cont, final = jax_run(case, root / "jax")
    mod = script()
    out = root / "port"
    if len(mesh) > 1 or "dp" not in mesh:  # the script's mesh flags
        mod.main([str(root / "jax"), str(out), "--optimizer", fam,
                  "--bucket-elems", str(BUCKET), *mesh_flags(mesh)])
        path = os.path.join(str(out), "1")
    else:
        path = mod.convert(str(root / "jax"), str(out), mod.port_config(
            fam, ema, bucket_elems=BUCKET))
    return case, saved, cont, final, str(out), path


def test_converted_arrays_are_the_orbax_arrays(converted):
    case, saved, _, _, _, path = converted
    fam, ema, _, mesh = CASES[case]
    load = lambda name: torch.load(os.path.join(path, name),  # noqa: E731
                                   weights_only=True)
    params = tree_leaves(load("params.pt"))
    want = tree_leaves(convert.params_from_jax(listed(saved["params"])))
    tops = top_keys(saved["params"])
    copies = saved["copies"]
    assert all(same_leaf(a, b, copies["params"].get(k, []))
               for a, b, k in zip(params, want, tops))
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
                listed(getattr(slot, jax_key))))[leaf]
            assert same_leaf(state[k][port_key], moment, copies.get(
                jax_key, {}).get(tops[leaf], [])), (leaf, port_key)
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
        world = int(np.prod(list(mesh.values())))
        for r in range(world):
            j = convert.jax_plane_index(port_rank(r, mesh))
            got = load(f"sync-{r}.pt")
            if isinstance(saved["ef"], dict):
                assert set(got) == set(saved["ef"]) == {"dense", "expert"}
                for k, planes in saved["ef"].items():
                    assert torch.equal(got[k], torch.from_numpy(planes[j]))
            else:
                assert torch.equal(got, torch.from_numpy(saved["ef"][j]))
        assert not os.path.exists(os.path.join(path, f"sync-{world}.pt"))


def test_the_port_resumes_within_the_parity_bound(converted):
    case, _, cont, final, out, _ = converted
    fam, ema, wire, mesh = CASES[case]
    flags = ["--steps", "4", "--ckpt-dir", out, "--optimizer", fam]
    if ema:
        flags += ["--ema-decay", str(ema)]
    if wire != "f32":
        flags += mesh_flags(mesh) + ["--grad-quant", wire]
    report = cli.run_train(cli.build_parser().parse_args(
        ARGV + model_of(case)[2] + flags))
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


@pytest.mark.parametrize("mesh", [dict(dp=2, pp=2), dict(sp=2, ep=2),
                                  dict(dp=2, ep=2, tp=2),
                                  dict(ep=2, pp=2, tp=2)],
                         ids=["dp2-pp2", "sp2-ep2", "dp2-ep2-tp2",
                              "ep2-pp2-tp2"])
def test_plane_index_is_the_jax_layouts(mesh):
    """A JAX residual stacked over ``_ef_state_axes`` on a mesh: the
    device that holds plane j sits at the mesh coordinates of the port
    rank whose ``jax_plane_index`` is j."""
    spec = MeshSpec(**mesh)
    jmesh = make_device_mesh(spec, devices=jax.devices()[:spec.size])
    axes = tuple(a for a in ("dp", "sp", "ep", "tp", "pp")
                 if mesh.get(a, 1) > 1)
    arr = jax.device_put(np.zeros((spec.size, 1), np.float32),
                         jax.sharding.NamedSharding(
                             jmesh, jax.sharding.PartitionSpec(axes, None)))
    names = list(jmesh.axis_names)
    seen = set()
    for shard in arr.addressable_shards:
        j = shard.index[0].start or 0
        at = np.argwhere(jmesh.devices == shard.device)[0]
        coords = dict(zip(names, (int(c) for c in at)))
        r = 0
        for a in ("pp", "dp", "ep", "sp", "tp"):
            r = r * mesh.get(a, 1) + coords.get(a, 0)
        assert convert.jax_plane_index(port_rank(r, mesh)) == j
        seen.add(r)
    assert seen == set(range(spec.size))


def test_planes_that_do_not_fit_the_mesh_name_the_flags(converted):
    case, _, _, _, out, _ = converted
    if case != "ef8_dp2_pp2":
        pytest.skip("one checkpoint suffices")
    _, params = script().read_orbax_step(
        os.path.join(os.path.dirname(out), "jax"))
    cfg = script().port_config("adamw", bucket_elems=BUCKET)
    with pytest.raises(ValueError, match=r"planes are \(4, .* at --dp 2 "
                       r"--sp 1 --ep 1 --tp 1 --pp 1 \(--dp --sp --ep "
                       r"--tp --pp"):
        convert.train_state_from_jax(params, cfg, mesh={"dp": 2})
    with pytest.raises(ValueError, match="--dp --sp --ep --tp --pp"):
        convert.train_state_from_jax(params, cfg, mesh={"dp": 1, "tp": 4})
    with pytest.raises(ValueError, match=r"rank 0's are \(4,\)"):
        convert.train_state_from_jax(params, cfg, mesh={"dp": 4})
    got = convert.train_state_from_jax(params, cfg,
                                       mesh={"dp": 2, "pp": 2})
    assert len(got["sync"]) == 4
