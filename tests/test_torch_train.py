"""The port's one-card training step against the JAX package's.

JAX initialises the weights (``make_train_state(key(0))`` on a one-device
mesh, as tests/test_optimizer.py builds it); ``convert.params_from_jax``
carries them into the port. The same numpy batches then go through JAX's
``make_grad_step`` / ``make_train_step`` with ``attn_impl="local"`` and
through the port's, whose attention is the flash path ("auto": on CPU
tensors the kernels' plain versions) or the plain "local" oracle.

Tolerances: f32 step-0 loss at rtol 1e-5 and gradients at atol 1e-5 /
rtol 1e-4 (XLA and PyTorch sum in other orders; the flash path's
online-softmax arithmetic adds ~1e-6); the 5-step loss trajectory at
rtol 1e-4 (adam divides by sqrt(v), which magnifies rounding of tiny
gradients a little each step); bf16 compute at rtol 2e-2 on the loss and
5e-2 of each leaf's largest gradient (bf16 rounds activations at other
places in the two frameworks). Where both sides are the port on the same
inputs the results are equal. Also pinned: where optax and torch differ
(global-norm clipping, the schedule's step count, the decay mask).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch import cli, convert
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models import transformer as ttf

torch.backends.cuda.matmul.allow_tf32 = False

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq=16, rope=True)
B, T = 4, 16


def mesh():
    return make_device_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])


def configs(**kw):
    port_kw = {k: v for k, v in kw.items() if k != "attn_impl_port"}
    jcfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                              grad_axes=("dp",), bucket_elems=256,
                              attn_impl="local", **port_kw)
    tcfg = ttrain.TrainConfig(model=ttf.TransformerConfig(**MODEL),
                              bucket_elems=256,
                              attn_impl=kw.get("attn_impl_port", "auto"),
                              **port_kw)
    return jcfg, tcfg


def jax_state(jcfg):
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0),
                                                     jcfg, mesh())
    return params, opt_state, opt


def port_params(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def batch(i: int) -> np.ndarray:
    return np.random.default_rng(i).integers(0, MODEL["vocab_size"],
                                             size=(B, T), dtype=np.int32)


def flat(tree) -> list:
    """Leaves of a JAX or port params tree in the port's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [np.asarray(tree.detach().float() if isinstance(
        tree, torch.Tensor) else tree, np.float32)]


@pytest.mark.parametrize("attn", ["auto", "local"])
def test_step0_loss_grads_and_metrics_match_jax(attn):
    jcfg, tcfg = configs(attn_impl_port=attn)
    jparams, _, _ = jax_state(jcfg)
    j_grads, j_metrics = jtrain.make_grad_step(jcfg, mesh())(
        jparams, jnp.asarray(batch(0)))
    state = ttrain.make_train_state(tcfg, params=port_params(jparams))
    t_grads, t_metrics = ttrain.make_grad_step(tcfg)(
        state.params, torch.from_numpy(batch(0)))
    assert set(t_metrics) == set(j_metrics)
    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    for key in ("tokens", "min_bucket_count", "aux_loss",
                "dispatch_fraction"):
        assert float(t_metrics[key]) == float(j_metrics[key]), key
    assert t_metrics["min_bucket_count"].dtype == torch.int32
    for got, want in zip(flat(t_grads), flat(j_grads)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("opt_kw", [
    dict(learning_rate=1e-2),
    dict(learning_rate=1e-2, lr_schedule="cosine", warmup_steps=2,
         total_steps=5, clip_norm=0.5),
], ids=["adamw_constant", "cosine_warmup_clip"])
def test_five_step_loss_trajectory_matches_jax(opt_kw):
    jcfg, tcfg = configs(**opt_kw)
    jparams, opt_state, opt = jax_state(jcfg)
    state = ttrain.make_train_state(tcfg, params=port_params(jparams))
    j_step = jtrain.make_train_step(jcfg, mesh(), opt)
    t_step = ttrain.make_train_step(tcfg)
    j_losses, t_losses = [], []
    for i in range(5):
        jparams, opt_state, jm = j_step(jparams, opt_state,
                                        jnp.asarray(batch(i)))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(t_step(state, torch.from_numpy(batch(i)))
                              ["loss"]))
    assert state.step == 5
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    for got, want in zip(flat(state.params), flat(jparams)):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_bf16_compute_step_matches_jax():
    jcfg, tcfg = configs(compute_dtype="bf16")
    jparams, _, _ = jax_state(jcfg)
    j_grads, j_metrics = jtrain.make_grad_step(jcfg, mesh())(
        jparams, jnp.asarray(batch(1)))
    state = ttrain.make_train_state(tcfg, params=port_params(jparams))
    t_grads, t_metrics = ttrain.make_grad_step(tcfg)(
        state.params, torch.from_numpy(batch(1)))
    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(j_metrics["loss"]), rtol=2e-2)
    for got, want in zip(flat(t_grads), flat(j_grads)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-2 * np.abs(want).max())


def test_remat_gives_the_same_grads():
    jcfg, tcfg = configs()
    jparams, _, _ = jax_state(jcfg)
    params = ttrain.make_train_state(tcfg,
                                     params=port_params(jparams)).params
    tokens = torch.from_numpy(batch(2))
    plain, _ = ttrain.make_grad_step(tcfg)(params, tokens)
    remat_cfg = ttrain.TrainConfig(**{**tcfg.__dict__, "remat": True})
    remat, _ = ttrain.make_grad_step(remat_cfg)(params, tokens)
    for got, want in zip(flat(remat), flat(plain)):
        np.testing.assert_array_equal(got, want)


def test_grad_accum_two_gives_the_deferred_sum():
    jcfg, tcfg = configs(grad_accum=2)
    jparams, _, _ = jax_state(jcfg)
    j_grads, j_metrics = jtrain.make_grad_step(jcfg, mesh())(
        jparams, jnp.asarray(batch(3)))
    params = ttrain.make_train_state(tcfg,
                                     params=port_params(jparams)).params
    tokens = torch.from_numpy(batch(3))
    t_grads, t_metrics = ttrain.make_grad_step(tcfg)(params, tokens)
    whole, whole_metrics = ttrain.make_grad_step(
        ttrain.TrainConfig(**{**tcfg.__dict__, "grad_accum": 1}))(params,
                                                                  tokens)
    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(t_metrics["loss"]),
                               float(whole_metrics["loss"]), rtol=1e-6)
    for got, want, one in zip(flat(t_grads), flat(j_grads), flat(whole)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got, one, atol=1e-6, rtol=1e-5)


def train_args(tmp_path, steps, ckpt=True):
    return cli.build_parser().parse_args(
        ["train", "--device", "cpu", "--steps", str(steps), "--vocab", "97",
         "--d-model", "64", "--n-heads", "4", "--kv-heads", "2", "--rope",
         "--d-ff", "128", "--seq", "16", "--batch", "4", "--lr", "1e-2",
         "--log-every", "1", "--ckpt-every", "1"]
        + (["--ckpt-dir", str(tmp_path / "ckpt")] if ckpt else []))


def test_checkpoint_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    whole = cli.run_train(train_args(tmp_path, 4, ckpt=False))
    first = cli.run_train(train_args(tmp_path, 2))
    resumed = cli.run_train(train_args(tmp_path, 4))
    assert "resumed from step 1" in capsys.readouterr().out
    assert resumed["config"]["start_step"] == 2
    assert first["losses"] + resumed["losses"] == whole["losses"]


def test_checkpoint_manager_round_trip_and_retention(tmp_path):
    from akka_allreduce_tpu_torch.runtime import checkpoint as ckpt
    _, tcfg = configs()
    state = ttrain.make_train_state(
        tcfg, generator=torch.Generator().manual_seed(1))
    ttrain.make_train_step(tcfg)(state, torch.from_numpy(batch(0)))
    mgr = ckpt.CheckpointManager(ckpt.CheckpointConfig(
        str(tmp_path), keep=2, save_interval_steps=2))
    opt = {"optimizer": state.optimizer.state_dict(), "count": state.step}
    assert [mgr.maybe_save(s, state.params, opt, {"data_step": s})
            for s in range(5)] == [True, False, True, False, True]
    assert mgr.steps() == [2, 4] and mgr.latest_step() == 4
    fresh = ttrain.make_train_state(
        tcfg, generator=torch.Generator().manual_seed(2))
    step, params, opt_state, extra = mgr.restore(
        fresh.params, {"optimizer": fresh.optimizer.state_dict()})
    assert (step, extra, opt_state["count"]) == (4, {"data_step": 4}, 1)
    for got, want in zip(flat(params), flat(state.params)):
        np.testing.assert_array_equal(got, want)
    fresh.optimizer.load_state_dict(opt_state["optimizer"])
    _, only, _ = mgr.restore_params(fresh.params, step=2)
    assert len(flat(only)) == len(flat(state.params))
    ckpt.save_state_json(str(tmp_path), "side", {"a": 1})
    assert ckpt.load_state_json(str(tmp_path), "side") == {"a": 1}
    assert ckpt.load_state_json(str(tmp_path), "absent") is None


# -- where optax and torch differ -----------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_is_optax_global_norm_rule(max_norm):
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in
             ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttrain.clip_by_global_norm_(got, max_norm)
    assert (float(norm) < max_norm) == (max_norm == 50.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_cosine_schedule_reads_the_pre_increment_count():
    jcfg, tcfg = configs(learning_rate=3e-3, lr_schedule="cosine",
                         warmup_steps=3, total_steps=10)
    j_sched = jtrain.make_lr_schedule(jcfg)
    t_sched = ttrain.make_lr_schedule(tcfg)
    counts = range(13)
    np.testing.assert_allclose([t_sched(c) for c in counts],
                               [float(j_sched(c)) for c in counts],
                               rtol=1e-6, atol=1e-12)
    assert t_sched(0) == 0.0 and ttrain.lr_at(tcfg, 3) == pytest.approx(3e-3)
    with pytest.raises(ValueError, match="total_steps"):
        ttrain.make_lr_schedule(ttrain.TrainConfig(
            model=tcfg.model, lr_schedule="cosine", warmup_steps=4,
            total_steps=4))


def test_weight_decay_mask_excludes_rank_below_two():
    """A zero-gradient step moves only the decayed leaves, by optax's
    amount: rank >= 2 leaves shrink by lr * wd, norm gains stay."""
    jcfg, tcfg = configs(learning_rate=0.1, weight_decay=0.5)
    jparams, opt_state, opt = jax_state(jcfg)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    updates, _ = opt.update(zeros, opt_state, jparams)
    want = optax.apply_updates(jparams, updates)
    state = ttrain.make_train_state(tcfg, params=port_params(jparams))
    decayed = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    for p in ttrain.tree_leaves(state.params):
        assert (id(p) in decayed) == (p.dim() >= 2)
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    for got, want_leaf, before in zip(flat(state.params), flat(want),
                                      flat(jparams)):
        np.testing.assert_allclose(got, want_leaf, rtol=1e-6, atol=1e-7)
        if got.ndim < 2:
            np.testing.assert_array_equal(got, before)


@pytest.mark.parametrize("kw,match", [
    (dict(ema_decay=1.0), "ema_decay"), (dict(ema_decay=-0.1), "ema_decay"),
    (dict(accum_schedule="eager"), "accum_schedule"),
    (dict(optimizer="nope"), "unknown optimizer")])
def test_left_out_options_raise(kw, match):
    _, tcfg = configs()
    cfg = ttrain.TrainConfig(**{**tcfg.__dict__, **kw})
    with pytest.raises(ValueError, match=match):
        ttrain.make_grad_step(cfg)


@pytest.mark.parametrize("kw", [
    dict(optimizer="lion"), dict(optimizer="adafactor"),
    dict(optimizer="sgd"), dict(ema_decay=0.9),
    dict(grad_accum=2, accum_schedule="overlap")],
    ids=["lion", "adafactor", "sgd", "ema", "overlap"])
def test_a5_options_train(kw):
    """The options the one-card slice refused now train: two steps, a
    finite loss, the EMA (when kept) moved off the initial masters."""
    jcfg, tcfg = configs()
    cfg = ttrain.TrainConfig(**{**tcfg.__dict__, "learning_rate": 1e-2,
                                **kw})
    state = ttrain.make_train_state(
        cfg, params=port_params(jax_state(jcfg)[0]))
    first = [p.detach().clone() for p in ttrain.tree_leaves(state.params)]
    step = ttrain.make_train_step(cfg)
    losses = [float(step(state, torch.from_numpy(batch(i)))["loss"])
              for i in range(2)]
    assert all(np.isfinite(losses)) and state.step == 2
    if cfg.ema_decay:
        assert any(not torch.equal(e, f) for e, f in zip(
            ttrain.tree_leaves(state.ema), first))


def test_blockwise_attention_matches_jax():
    from akka_allreduce_tpu.parallel import ring_attention as jra
    from akka_allreduce_tpu_torch.parallel import ring_attention as tra
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    want = np.asarray(jra.blockwise_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_size=16))
    got = tra.blockwise_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_size=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        tra.blockwise_causal_attention(*(torch.from_numpy(a) for a in
                                         (q, k, v)), block_size=24)


def test_flops_match_jax():
    from akka_allreduce_tpu.models import flops as jflops
    from akka_allreduce_tpu_torch.models import flops as tflops
    for extra in ({}, {"attn_window": 5}, {"ffn": "swiglu"}):
        jcfg = jtf.TransformerConfig(**{**MODEL, **extra})
        tcfg = ttf.TransformerConfig(**{**MODEL, **extra})
        assert tflops.transformer_step_flops(tcfg, 8, 16) == \
            jflops.transformer_step_flops(jcfg, 8, 16)
    assert tflops.chip_peak_flops("cpu") is None


def test_data_batches_match_jax():
    from akka_allreduce_tpu import data as jdata
    from akka_allreduce_tpu_torch import data as tdata
    jc, tc = jdata.synthetic_corpus(50, 999, 3), tdata.synthetic_corpus(
        50, 999, 3)
    np.testing.assert_array_equal(tc.batch(7, 4, 16), jc.batch(7, 4, 16))
    assert tc.max_token() == jc.max_token()


def test_next_token_loss_matches_jax():
    jcfg = jtf.TransformerConfig(**MODEL)
    tcfg = ttf.TransformerConfig(**MODEL)
    jparams = jtf.init_transformer(jax.random.key(3), jcfg)
    tok = batch(5)
    want = jtf.next_token_loss(jparams, jnp.asarray(tok), jcfg)
    got = ttf.next_token_loss(port_params(jparams), torch.from_numpy(tok),
                              tcfg)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert float(got[1]) == float(want[1]) == B * (T - 1)
    _, aux = ttf.transformer_apply_with_aux(
        port_params(jparams), torch.from_numpy(tok), tcfg)
    assert {k: float(v) for k, v in aux.items()} == {
        "aux_loss": 0.0, "dispatch_fraction": 1.0}
