"""The port's lion, adafactor and sgd against the JAX package's optax chain.

The same seeded numpy params and gradients go through JAX's
``make_optimizer(TrainConfig(...))`` (step counter, optional global-norm
clip, the family) and through the port's ``make_train_state`` +
``apply_update`` (clip, the family at the schedule's rate, the count) for
five steps. Bounds: adafactor and sgd at rtol 1e-6, atol 1e-7 (XLA may
fuse a multiply-add that PyTorch rounds twice); lion at an absolute 1e-4
of a 1e-3 learning rate, well under the 2e-3 that one flipped sign moves
an element by, so any flip fails. The params tree holds leaves that
adafactor factors both ways round (both dims >= 128), a matrix it does
not (one dim < 128) and a vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.models.optim import factored_dims

SHAPES = {"embed": (160, 192), "wide": (128, 300), "tall": (300, 130),
          "small": (8, 130), "norm": (24,)}
MODEL = dict(vocab_size=31, d_model=32, n_heads=4, n_layers=1, d_ff=64,
             max_seq=16)
LR = {"lion": 1e-3, "adafactor": 1e-2, "sgd": 5e-2, "sgd0": 5e-2,
      "adamw": 1e-3}
STEPS = 5


def params_np(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def grads_np(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(size=s) * 0.3).astype(np.float32)
            for k, s in SHAPES.items()}


def configs(fam: str, **kw):
    family = "sgd" if fam.startswith("sgd") else fam
    kw = dict(optimizer=family, learning_rate=LR[fam], **kw)
    if fam == "sgd0":
        kw["sgd_momentum"] = 0.0
    jcfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL), **kw)
    tcfg = ttrain.TrainConfig(model=ttf.TransformerConfig(**MODEL), **kw)
    return jcfg, tcfg


def run_jax(jcfg, steps=STEPS, start=None) -> dict:
    opt = jtrain.make_optimizer(jcfg)
    params = {k: jnp.asarray(v) for k, v in (start or params_np()).items()}
    state = opt.init(params)
    update = jax.jit(opt.update)
    for i in range(steps):
        grads = {k: jnp.asarray(v) for k, v in grads_np(i).items()}
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def run_port(tcfg, steps=STEPS, start=None, device_step=False
             ) -> "tuple[dict, object]":
    params = {k: torch.from_numpy(v.copy())
              for k, v in (start or params_np()).items()}
    state = ttrain.make_train_state(tcfg, params=params,
                                    device_step=device_step)
    for i in range(steps):
        g = grads_np(i)
        ttrain.apply_update(tcfg, state, [
            torch.from_numpy(g[name]) for name in _leaf_names(state)])
    return ({k: v.detach().numpy() for k, v in state.params.items()},
            state)


def _leaf_names(state) -> list:
    ids = {id(v): k for k, v in state.params.items()}
    return [ids[id(p)] for p in ttrain.tree_leaves(state.params)]


def check(fam, got: dict, want: dict) -> None:
    for k in SHAPES:
        if fam == "lion":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("fam", ["lion", "adafactor", "sgd", "sgd0"])
def test_five_steps_match_the_optax_chain(fam, clip, schedule):
    kw = dict(clip_norm=clip, lr_schedule=schedule)
    if schedule == "cosine":
        kw.update(warmup_steps=2, total_steps=STEPS)
    jcfg, tcfg = configs(fam, **kw)
    got, state = run_port(tcfg)
    check(fam, got, run_jax(jcfg))
    assert state.step == STEPS


# (warmup, total steps): the five steps cross the warmup into the decay;
# the second schedule also runs past its end (counts 4 > 3 read the last
# rate)
DEVICE_STEP_SCHEDULES = {"warmup_decay": (2, STEPS), "past_end": (1, 3)}


@pytest.mark.parametrize("schedule", sorted(DEVICE_STEP_SCHEDULES))
@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("fam", ["lion", "adafactor", "sgd", "sgd0",
                                 "adamw"])
def test_device_step_state_matches_the_optax_chain(fam, clip, schedule):
    """The state of ``--steps-per-dispatch`` chunks (a tensor step count
    indexing the schedule's table of rates, a shared rate tensor) through
    the same five steps as the per-step state, against the JAX chain."""
    warmup, total = DEVICE_STEP_SCHEDULES[schedule]
    jcfg, tcfg = configs(fam, clip_norm=clip, lr_schedule="cosine",
                         warmup_steps=warmup, total_steps=total)
    got, state = run_port(tcfg, device_step=True)
    check(fam, got, run_jax(jcfg))
    assert state.count is not None and state.step == STEPS
    np.testing.assert_array_equal(
        state.lr_table.numpy(),
        np.float32([ttrain.lr_at(tcfg, c) for c in range(total + 1)]))


def test_the_leaves_are_factored_as_optax_factors_them():
    from optax._src.factorized import _factored_dims
    for shape in SHAPES.values():
        assert factored_dims(shape) == _factored_dims(shape, True, 128)
    assert factored_dims((160, 192)) == (0, 1)
    assert factored_dims((300, 130)) == (1, 0)
    assert factored_dims((8, 130)) is None


@pytest.mark.parametrize("fam", ["lion", "adafactor"])
def test_decay_mask_at_weight_decay_half(fam):
    """Weight decay 0.5 (JAX tests/test_optimizer.py's huge decay):
    vectors move exactly as without decay, matrices as optax decays them
    — adafactor's decay comes after the learning rate, so a port that
    scaled it by lr would miss by 1/lr on every matrix."""
    jcfg, tcfg = configs(fam, weight_decay=0.5)
    got, _ = run_port(tcfg, steps=1)
    check(fam, got, run_jax(jcfg, steps=1))
    _, tcfg0 = configs(fam, weight_decay=0.0)
    plain, _ = run_port(tcfg0, steps=1)
    start = params_np()
    for k, shape in SHAPES.items():
        if len(shape) < 2:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
        else:
            assert not np.allclose(got[k], plain[k], atol=1e-7), k
            assert np.abs(got[k] - start[k]).max() > 0, k


def state_bytes(optimizer) -> int:
    return sum(v.numel() * v.element_size()
               for per in optimizer.state.values()
               for v in per.values() if isinstance(v, torch.Tensor))


def test_adafactor_state_is_factored():
    """Its second moments are O(r + c) a matrix: the state lands under
    0.75 x adamw's (JAX tests/test_optimizer.py's pin) after one step
    on a transformer whose matrices are factored."""
    model = ttf.TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                                  n_layers=2, d_ff=512, max_seq=32)
    sizes = {}
    for fam in ("adafactor", "adamw", "lion"):
        cfg = ttrain.TrainConfig(model=model, optimizer=fam)
        state = ttrain.make_train_state(
            cfg, generator=torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, size=(2, 32), dtype=np.int32))
        ttrain.make_train_step(cfg)(state, tokens)
        sizes[fam] = state_bytes(state.optimizer)
    psize = sum(p.numel() * 4 for p in ttrain.tree_leaves(state.params))
    assert sizes["adamw"] >= 2 * psize
    assert sizes["lion"] == psize
    assert sizes["adafactor"] < 0.75 * sizes["adamw"], sizes


def test_unknown_family_rejected():
    _, tcfg = configs("lion")
    cfg = ttrain.TrainConfig(**{**tcfg.__dict__, "optimizer": "adagrab"})
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_optimizer(cfg, {"w": torch.zeros(2, 2)})


@pytest.mark.parametrize("fam,lr", [("adafactor", 5e-3), ("sgd", 5e-2),
                                    ("lion", 1e-3)])
def test_family_learns(fam, lr):
    """A train step per family on one fixed batch: the loss falls."""
    model = ttf.TransformerConfig(**{**MODEL, "max_seq": 32})
    cfg = ttrain.TrainConfig(model=model, optimizer=fam, learning_rate=lr)
    state = ttrain.make_train_state(
        cfg, generator=torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 31, size=(2, 32), dtype=np.int32))
    losses = [float(step(state, tokens)["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
