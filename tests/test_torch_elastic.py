"""``runtime/elastic.py`` against the JAX package's.

* ``QuorumTracker`` and ``shrink_spec`` bitwise JAX's over a grid of
  specs, fractions and survivor counts, the errors and the 0.55 x 100
  rounding case included; the controller's full cycle and its park.
* Four gloo ranks at dp=2 x tp=2 take a step; ranks 2-3 (host 1) leave;
  the survivors re-form dp=1 x tp=2 through an ``ElasticController``
  (a new process group on a prefix of the store named by the
  generation), reshard (parameters, optimizer state and EMA bitwise)
  and take two more steps. Each loss is within 1e-5 of JAX's
  ``make_train_step`` on 4, then 2, virtual CPU devices from the same
  weights.
* Survivors that do not hold their new coordinates' shard (ranks 1 and
  2: the new rank 0 was tp 1) receive it from the lowest-ranked holder,
  bitwise; a survivor set without one shard raises JAX's "restore from
  checkpoint" error (ROADMAP C16: JAX's reshard reads the lost devices'
  buffers).
* The port's ``TcpRouter`` heartbeat detector downs a hung host and
  drives the controller (JAX ``test_elastic_liveness.py``).
"""

import dataclasses
import datetime
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec as JMeshSpec
from akka_allreduce_tpu.runtime import elastic as jel
from akka_allreduce_tpu_torch.parallel.group import RankGroup, spawn_ranks
from akka_allreduce_tpu_torch.runtime import elastic as tel

import torch_elastic_ranks as ranks

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=16)
KW = dict(learning_rate=1e-2, bucket_elems=256, ema_decay=0.9)


def batch(seed: int, rows: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, MODEL["vocab_size"], size=(rows, 16), dtype=np.int32)


SPECS = [dict(dp=4, tp=2), dict(dp=2, tp=4), dict(dp=3, sp=2),
         dict(dp=2, ep=2, pp=2), dict(dp=1, tp=2, sp=2), dict(dp=8)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_shrink_spec_is_jax(spec):
    jspec, tspec = JMeshSpec(**spec), tel.MeshSpec(**spec)
    assert tspec.size == jspec.size
    for n in range(0, jspec.size + 3):
        try:
            want = jel.shrink_spec(jspec, n)
        except RuntimeError as exc:
            with pytest.raises(RuntimeError) as got:
                tel.shrink_spec(tspec, n)
            assert str(got.value) == str(exc)
            continue
        got = tel.shrink_spec(tspec, n)
        assert dataclasses.asdict(got) == {
            k: getattr(want, k) for k in ("dp", "tp", "sp", "ep", "pp")}


@pytest.mark.parametrize("fraction", [0.1, 0.25, 0.5, 0.55, 0.75, 0.9, 1.0])
def test_quorum_tracker_is_jax(fraction):
    for total in (1, 3, 4, 7, 10, 100):
        j, t = jel.QuorumTracker(total, fraction), \
            tel.QuorumTracker(total, fraction)
        assert t.min_quorum == j.min_quorum
        events = itertools.chain(
            (("up", r) for r in range(total)),
            (("lost", r) for r in range(0, total, 2)),
            (("lost", 0),), (("up", 0), ("up", 0)))
        for kind, r in events:
            getattr(j, f"member_{kind}")(r)
            getattr(t, f"member_{kind}")(r)
            assert (t.generation, t.quorum_ok(), t.alive) == \
                (j.generation, j.quorum_ok(), j.alive)
            assert t.is_current(j.generation)
            assert not t.is_current(j.generation - 1)
    # IEEE noise: 0.55 * 100 is 55.000000000000006
    assert tel.QuorumTracker(100, 0.55).min_quorum == 55
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="not in"):
            tel.QuorumTracker(4, bad)


def test_controller_full_cycle():
    """4 hosts x 2 ranks: up, lose one, shrink, rejoin, regrow, the
    callback seeing each generation (JAX ``test_controller_full_cycle``;
    the plan stands for the mesh)."""
    reforms = []
    ctl = tel.ElasticController(
        tel.MeshSpec(dp=4, tp=2), total_hosts=4, ranks_per_host=2,
        min_fraction=0.5,
        on_reform=lambda plan, gen: reforms.append((gen, plan.spec.dp)))
    for r in range(4):
        ctl.handle_member_up(r)
    assert ctl.group.spec.dp == 4 and ctl.group.ranks == tuple(range(8))
    plan = ctl.handle_member_lost(1)
    assert plan.spec.dp == 3 and not ctl.parked
    assert plan.ranks == (0, 1, 4, 5, 6, 7)
    assert [plan.new_rank(r) for r in plan.ranks] == list(range(6))
    plan = ctl.handle_member_up(1)
    assert plan.spec.dp == 4 and reforms[-1][1] == 4
    # host 1's ranks rejoin holding nothing; the members hold the rest
    assert plan.held[2] is None and plan.held[3] is None
    assert plan.held[4] == (0, 0, 0, 0) and plan.held[5] == (0, 0, 0, 1)
    gens = [g for g, _ in reforms]
    assert gens == sorted(gens) and len(set(gens)) == len(gens)
    # an incomplete replica's ranks stay idle
    idle = tel.plan(tel.MeshSpec(dp=2, tp=4), [0, 1, 2, 3, 5, 6, 7], 9)
    assert idle.spec.dp == 1 and idle.new_rank(5) is None
    assert idle.new_rank(3) == 3


def test_plan_chooses_members_by_coordinate():
    """dp=2 x tp=2 loses rank 1 (hosts of one rank): dp becomes 1, and of
    the survivors [0, 2, 3] the new group takes old 0 (tp 0) and old 3
    (tp 1), the only holder of tp 1, and leaves old 2 idle. After host 0
    is lost and rejoins, old 2 and 3 hold the shards and old 0 none, so
    old 0 stays idle."""
    ctl = tel.ElasticController(tel.MeshSpec(dp=2, tp=2), total_hosts=4,
                                ranks_per_host=1)
    for r in range(4):
        ctl.tracker.member_up(r)
    plan = ctl.handle_member_lost(1)
    assert plan.ranks == (0, 3, 2) and plan.spec == tel.MeshSpec(tp=2)
    assert [plan.new_rank(r) for r in (0, 3, 2)] == [0, 1, None]
    assert plan.held == ((0, 0, 0, 0), (0, 0, 0, 1))
    ctl.handle_member_lost(0)
    plan = ctl.handle_member_up(0)
    assert plan.ranks == (2, 3, 0) and plan.new_rank(0) is None
    # when the first spec.size survivors hold every shard, they are it
    assert tel.plan(tel.MeshSpec(dp=3, tp=2), [0, 2, 3, 4, 5],
                    1).ranks == (0, 2, 3, 4, 5)


def test_controller_parks_without_quorum():
    ctl = tel.ElasticController(tel.MeshSpec(dp=4, tp=2), total_hosts=4,
                                ranks_per_host=2, min_fraction=0.75)
    for r in range(4):
        ctl.handle_member_up(r)
    ctl.handle_member_lost(0)
    assert not ctl.parked
    out = ctl.handle_member_lost(1)
    assert out is None and ctl.parked and ctl.group is None
    assert ctl.handle_member_up(0) is not None and not ctl.parked


def test_reshard_without_a_shard_raises():
    """Ranks 1 and 3 of dp=2 x tp=2 both held tp 1: no survivor holds tp
    0. Raised before any collective (this group has no process group)."""
    old = tel.MeshSpec(dp=2, tp=2)
    plan = tel.plan(old, [1, 3], generation=2)
    assert plan.spec == tel.MeshSpec(dp=1, tp=2)
    group = RankGroup(0, 2, "gloo", torch.device("cpu"), tp=2)
    with pytest.raises(RuntimeError, match="restore from checkpoint"):
        tel.reshard(None, plan, group)


def _jax_losses(batches, meshes):
    """JAX ``make_train_step`` on the first mesh for batch 0 (the
    weights of :func:`jax_params`), the state resharded onto the second
    for the rest."""
    from akka_allreduce_tpu.models.train import place_opt_state
    from akka_allreduce_tpu.parallel.mesh import make_device_mesh
    cfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                             grad_axes=("dp",), attn_impl="local", **KW)
    mesh = make_device_mesh(JMeshSpec(**meshes[0]),
                            devices=jax.devices()[:4])
    params, opt_state, opt = jtrain.make_train_state(jax.random.key(0), cfg,
                                                     mesh)
    step = jtrain.make_train_step(cfg, mesh, opt)
    params, opt_state, m = step(params, opt_state, jnp.asarray(batches[0]))
    losses = [float(m["loss"])]
    new = make_device_mesh(JMeshSpec(**meshes[1]), devices=jax.devices()[:2])
    params = jel.reshard(params, jtrain.param_specs(cfg.model), new)
    opt_state = place_opt_state(opt, opt_state, params, new)
    step = jtrain.make_train_step(cfg, new, opt)
    for b in batches[1:]:
        params, opt_state, m = step(params, opt_state, jnp.asarray(b))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def jax_params():
    cfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                             grad_axes=("dp",), attn_impl="local", **KW)
    from akka_allreduce_tpu.parallel.mesh import make_device_mesh
    mesh = make_device_mesh(JMeshSpec(dp=2, tp=2), devices=jax.devices()[:4])
    params, _, _ = jtrain.make_train_state(jax.random.key(0), cfg, mesh)
    return params


def _spawn(params, batches, survivors):
    server = dist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=60))
    return spawn_ranks(ranks.lose_and_reform, 4, "gloo", "cpu", MODEL,
                       KW, jax.tree.map(np.asarray, params), batches,
                       ("127.0.0.1", server.port), survivors, tp=2,
                       timeout=300)


def test_host_lost_survivors_reform_and_match_jax(jax_params):
    batches = [batch(0, 4), batch(1, 2), batch(2, 2)]
    out = _spawn(jax_params, batches, [0, 1])
    want = _jax_losses(batches, [dict(dp=2, tp=2),
                                             dict(dp=1, tp=2)])
    for r in (2, 3):  # left after the first step
        assert out[r]["rank"] is None
        assert out[r]["losses"] == out[0]["losses"][:1]
    for r in (0, 1):
        got = out[r]
        assert got["rank"] == r and got["spec"] == tel.MeshSpec(dp=1, tp=2)
        assert got["generations"] == [3]  # two hosts up, one lost
        for b, a in zip(got["before"], got["after"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5,
                                   atol=1e-5)
    assert out[0]["losses"] == out[1]["losses"]


def test_survivors_take_the_shards_they_lacked(jax_params):
    """Ranks 0 and 3 leave: the new rank 0 (old 1, tp 1) takes tp 0's
    shard from the new rank 1 (old 2), and the new rank 1 takes tp 1's
    from the new rank 0 (the lowest-ranked holder), bitwise."""
    batches = [batch(0, 4), batch(1, 2)]
    out = _spawn(jax_params, batches, [1, 2])
    assert [o["rank"] for o in out] == [None, 0, 1, None]
    # old rank 2 held (tp 0): its state is now the new rank 0's (old 1)
    for new_old, holder in ((1, 2), (2, 1)):
        for b, a in zip(out[holder]["before"], out[new_old]["after"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert out[1]["losses"] == out[2]["losses"]
    assert np.isfinite(out[1]["losses"]).all()


def test_idle_survivor_never_holds_the_only_shard(jax_params):
    """Rank 1 leaves (hosts of one rank): the new group is old 0 (tp 0)
    and old 3 (tp 1), each keeping its shard bitwise, and old 2 stays
    idle; the losses match JAX's 4 -> 2 device run within 1e-5."""
    batches = [batch(0, 4), batch(1, 2)]
    out = _spawn(jax_params, batches, [0, 2, 3])
    want = _jax_losses(batches, [dict(dp=2, tp=2), dict(dp=1, tp=2)])
    assert [o["rank"] for o in out] == [0, None, None, 1]
    assert out[2]["generations"] == [5]  # four hosts up, one lost
    for r in (0, 3):
        for b, a in zip(out[r]["before"], out[r]["after"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(out[r]["losses"], want, rtol=1e-5,
                                   atol=1e-5)


def test_detector_drives_the_controller():
    """Host 0's router watches host 1's by heartbeat; host 1 stops
    polling, the detector downs it, deathwatch drives the controller:
    the plan shrinks to host 0's ranks (JAX
    ``test_hung_host_downed_then_training_reforms``)."""
    from akka_allreduce_tpu_torch.protocol.tcp import TcpRouter
    events = []
    ctl = tel.ElasticController(
        tel.MeshSpec(dp=8), total_hosts=2, ranks_per_host=4,
        min_fraction=0.5, on_reform=lambda plan, gen: events.append(
            (gen, plan)))
    rank_of_addr = {}
    with TcpRouter(role="master", heartbeat_interval_s=0.05,
                   unreachable_after_s=0.4) as a:
        a.on_terminated = lambda ref: ctl.handle_member_lost(
            rank_of_addr[tuple(ref.addr)])
        with TcpRouter(role="worker", heartbeat_interval_s=0.05) as b:
            b.register("agent1", handler=lambda m: None)
            b.dial(a.addr)
            rank_of_addr[tuple(b.addr)] = 1
            ctl.tracker.member_up(0)
            plan = ctl.handle_member_up(1)
            assert plan.spec.size == 8
            events.clear()
            deadline = time.monotonic() + 3.0
            while not events and time.monotonic() < deadline:
                a.poll(0.05)
            assert events, "detector never downed the hung host"
            gen, plan = events[-1]
            assert plan.spec == tel.MeshSpec(dp=4)
            assert plan.ranks == (0, 1, 2, 3) and not ctl.parked
            assert gen == ctl.tracker.generation == 3
