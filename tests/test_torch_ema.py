"""The port's EMA weights against the JAX package's ``param_ema``, and the
checkpoint's ``ema`` item.

The recurrence: the same numpy params and updates go through JAX's
``param_ema`` transform (the chain's last slot: ``d * ema + (1 - d) *
(p + u)``) and through the port's ``update_ema`` on the post-update
masters ``p + u``, for four steps, at rtol 1e-6, atol 1e-7 (XLA may fuse
a multiply-add that PyTorch rounds twice). The training pin replays the
recurrence by hand from the per-step masters of the port's own train step
(JAX tests/test_ema.py's first case). The checkpoint: the item round
trips bitwise, ``restore_params(item="ema")`` reads it alone, a resume
brings it back in place, and a checkpoint without one names the items it
has.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.models.train import param_ema
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models.transformer import TransformerConfig
from akka_allreduce_tpu_torch.runtime.checkpoint import (CheckpointConfig,
                                                         CheckpointManager,
                                                         restore_or_init)

MCFG = TransformerConfig(vocab_size=31, d_model=32, n_heads=4, n_layers=1,
                         d_ff=64, max_seq=16)
SHAPES = {"a": (16, 24), "b": (24,), "c": (3, 5, 7)}


def tokens(seed=0, b=4, t=16):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 31, size=(b, t), dtype=np.int32))


def test_recurrence_matches_param_ema():
    d = 0.9
    rng = np.random.default_rng(0)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = param_ema(d)
    jstate = tx.init({k: jnp.asarray(v) for k, v in p.items()})
    ema = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    for _ in range(4):
        u = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
             for k, s in SHAPES.items()}
        _, jstate = tx.update({k: jnp.asarray(v) for k, v in u.items()},
                              jstate, {k: jnp.asarray(v)
                                       for k, v in p.items()})
        p = {k: p[k] + u[k] for k in p}  # the post-update params
        ttrain.update_ema(ema, {k: torch.from_numpy(v) for k, v in p.items()},
                          d)
    for k in SHAPES:
        np.testing.assert_allclose(ema[k].numpy(),
                                   np.asarray(jstate.ema[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_ema_tracks_post_update_masters_exactly():
    """The train step's EMA equals the recurrence replayed from the
    post-update masters bitwise (the same arithmetic, same order), and
    starts as a copy of the initial masters, not zeros."""
    d = 0.8
    cfg = ttrain.TrainConfig(model=MCFG, learning_rate=1e-2, ema_decay=d,
                             optimizer="lion")
    state = ttrain.make_train_state(
        cfg, generator=torch.Generator().manual_seed(0))
    expect = [p.detach().clone() for p in ttrain.tree_leaves(state.params)]
    for e, p in zip(ttrain.tree_leaves(state.ema),
                    ttrain.tree_leaves(state.params)):
        assert torch.equal(e, p) and e is not p
    step = ttrain.make_train_step(cfg)
    for i in range(3):
        step(state, tokens(i))
        expect = [d * e + (1 - d) * p.detach() for e, p in zip(
            expect, ttrain.tree_leaves(state.params))]
    for want, got in zip(expect, ttrain.tree_leaves(state.ema)):
        assert torch.equal(got, want)


def test_no_ema_by_default():
    state = ttrain.make_train_state(ttrain.TrainConfig(model=MCFG),
                                    generator=torch.Generator().manual_seed(0))
    assert state.ema is None


def test_bad_decay_rejected():
    with pytest.raises(ValueError, match="ema_decay"):
        ttrain.make_optimizer(ttrain.TrainConfig(model=MCFG, ema_decay=1.0),
                              {"w": torch.zeros(2, 2)})


def _trained(ema_decay, steps=2):
    cfg = ttrain.TrainConfig(model=MCFG, learning_rate=1e-2,
                             ema_decay=ema_decay)
    state = ttrain.make_train_state(
        cfg, generator=torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(cfg)
    for i in range(steps):
        step(state, tokens(i))
    return cfg, state


def _opt(state):
    return {"optimizer": state.optimizer.state_dict(), "count": state.step}


def test_ema_item_round_trip_and_params_only_restore(tmp_path):
    cfg, state = _trained(0.9)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(1, state.params, _opt(state), {"data_step": 1}, force=True,
             ema=state.ema)
    assert mgr.items() == ["params", "opt_state", "ema"]
    fresh = ttrain.make_train_state(
        cfg, generator=torch.Generator().manual_seed(5))
    step, only, extra = mgr.restore_params(fresh.params, item="ema")
    assert step == 1 and extra == {"data_step": 1}
    for a, b in zip(ttrain.tree_leaves(only), ttrain.tree_leaves(state.ema)):
        assert torch.equal(a, b)
    # the raw weights differ from the EMA
    _, raw, _ = mgr.restore_params(fresh.params)
    assert any(not torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(raw), ttrain.tree_leaves(only)))
    # a resume brings the EMA back in place, bitwise
    nxt, _, _, _, _ = restore_or_init(CheckpointConfig(str(tmp_path)),
                                      fresh.params, _opt(fresh),
                                      ema=fresh.ema)
    assert nxt == 2
    for a, b in zip(ttrain.tree_leaves(fresh.ema),
                    ttrain.tree_leaves(state.ema)):
        assert torch.equal(a, b)


def test_missing_ema_item_fails_with_item_name(tmp_path):
    cfg, state = _trained(0.0, steps=1)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(0, state.params, _opt(state), force=True)
    with pytest.raises(KeyError, match="'ema'.*available items: "
                                       r"\['opt_state', 'params'\]"):
        mgr.restore_params(state.params, item="ema")
    # a run with --ema-decay cannot resume from it either
    _, with_ema = _trained(0.9, steps=0)
    with pytest.raises(KeyError, match="ema"):
        mgr.restore(with_ema.params, _opt(with_ema), ema=with_ema.ema)
