"""The port's DCN trainer against the JAX package's.

* The wire codec: the same vector, loss, tokens and seed give bitwise
  JAX's bytes for the f32, bf16 and int8 wires, and decode to bitwise
  JAX's vectors.
* The token-weighted mean: the same rows and payloads (masked peers, a
  partial peer, uneven token counts, every wire) give a mean vector
  bitwise the one JAX's ``_apply_round`` hands its optimizer.
* The whole trainer: the JAX ``DcnDeadlineTrainer`` and the port's, each
  as two processes in two threads over a ``tests/kv_fake.py
  FakeKvClient``, on a small transformer (2 layers, d_model 64) whose
  JAX weights ``convert.params_from_jax`` carries into the port, three
  rounds on the same batches (each process its half of the rows).
  Tolerances: the losses at rtol 1e-5 and the parameters at atol 1e-4
  (XLA and PyTorch sum in other orders, ~1e-7 a step; adam divides by
  sqrt(v), so an entry whose gradient is near zero can move by a good
  part of the 1e-3 learning rate on a rounding difference: one entry
  in 79,296 moved 2.8e-5 here); the two processes of one framework end
  bitwise equal (their CRC check runs every round).
* A process whose local mesh has two ranks (spawned; the local f32 sync
  runs the masked reduce's path) beside a process of one: every local
  rank ends bitwise equal to the other process, and the losses match
  one process stepping on the whole batch (rtol 1e-5).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kv_fake import FakeKvClient

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu.runtime import dcn_train as jdcn
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.models import train as ttrain
from akka_allreduce_tpu_torch.models import transformer as ttf
from akka_allreduce_tpu_torch.runtime import dcn_train as tdcn

MODEL = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=16)
B, T, LR = 4, 16, 1e-3


def batch(i: int) -> np.ndarray:
    return np.random.default_rng(i).integers(0, MODEL["vocab_size"],
                                             size=(B, T), dtype=np.int32)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_codec_is_bitwise_jax(wire):
    rng = np.random.default_rng(3)
    for n, seed in ((1, 0), (1000, 7), (65536 + 513, 12345)):
        vec = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3)
               ).astype(np.float32)
        want = jdcn.encode_payload(vec, 2.5, 2 ** 33 + 7, wire, seed=seed)
        got = tdcn.encode_payload(vec, 2.5, 2 ** 33 + 7, wire, seed=seed)
        assert got == want
        jl, jt, jv = jdcn.decode_payload(want)
        tl, tt, tv = tdcn.decode_payload(got)
        assert (tl, tt) == (jl, jt)
        assert tv.dtype == np.float32
        np.testing.assert_array_equal(tv.view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


def test_bf16_bits_rounded_with_the_gradient_are_the_codecs():
    """On the bf16 wire the trainer rounds the gradient where it lives
    (on the card: half the bytes to copy off it); the bucket it publishes
    is bitwise JAX's ``encode_payload`` of the f32 vector."""
    _, jtr, ttr = _stub_trainers("bf16", 1, None)
    rng = np.random.default_rng(1)
    grads = {"a": torch.from_numpy(rng.standard_normal((7, 5)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(11).astype(
            np.float32) * 1e-3)}
    bits = ttr._host_wire(grads)
    vec = np.concatenate([grads["a"].numpy().ravel(), grads["b"].numpy()])
    assert bits.dtype == np.int16
    assert tdcn._HDR.pack(2.0, 9, 2) + bits.tobytes() == \
        jdcn.encode_payload(vec, 2.0, 9, "bf16")
    jtr.close()
    ttr.close()


def _stub_trainers(wire, n, B_elems):
    """A JAX and a port trainer (rank 0 of ``n``) over one fake store,
    their wire cut into ``B_elems`` buckets."""
    client = FakeKvClient()
    kw = dict(deadline_s=5.0, rank=0, num_processes=n, client=client,
              wire=wire, dcn_bucket_elems=B_elems, hb_interval_s=0.0,
              retain_rounds=16)
    j = jdcn.DcnDeadlineTrainer(
        type("C", (), {"bucket_elems": 64})(), None,
        __import__("optax").sgd(1.0), grad_step=lambda *a: None, **kw)
    t = tdcn.DcnDeadlineTrainer(
        type("C", (), {"bucket_elems": 64})(), None,
        grad_step=lambda *a: None, namespace="port", **kw)
    return client, j, t


@pytest.mark.parametrize("wire,size,chunk", [
    ("f32", 1000, 300), ("bf16", 1000, 300), ("int8", 1000, 300),
    # buckets of several of the mean's 1Mi-element ranges
    ("f32", 2_500_000, 1_500_000), ("bf16", 2_500_000, 1_500_000)])
def test_mean_vector_is_bitwise_jax(wire, size, chunk):
    n, r = 4, 5
    client, jtr, ttr = _stub_trainers(wire, n, chunk)
    params_j = {"a": jnp.zeros((10, 60), jnp.float32),
                "b": jnp.zeros(size - 600, jnp.float32)}
    params_t = {"a": torch.zeros(10, 60), "b": torch.zeros(size - 600)}
    jtr._ensure_apply(params_j)
    ttr._ensure_apply(params_t)
    got_j = []
    jtr._apply = lambda p, o, v: (got_j.append(np.asarray(v)), (p, o))[1]
    rng = np.random.default_rng(0)
    tokens = [30.0, 90.0, 0.0, 45.0]
    own = None
    for p in range(n):
        vec = rng.standard_normal(size).astype(np.float32)
        if tokens[p] == 0.0:
            vec[:] = np.nan  # an empty local batch: weighted out
        parts = [tdcn.encode_payload(vec[lo:lo + chunk], 1.0 + p,
                                     tokens[p], wire,
                                     seed=(r * n + p) * 4 + b)
                 for b, lo in enumerate(range(0, size, chunk))]
        buckets = len(parts)
        if p == 0:
            own = parts
        for tr in (jtr, ttr):
            for b, data in enumerate(parts):
                client.key_value_set_bytes(tr._gkey(r, p, b), data)
    # peer 3 landed its first bucket only; peer 2 is in but carries 0
    # tokens
    rows = [[True] * buckets] * 3 + [[True] + [False] * (buckets - 1)]
    _, _, jrep = jtr._apply_round(None, None, r, rows, own)
    vec, trep = ttr._mean_vector(r, rows, own)
    np.testing.assert_array_equal(vec.view(np.uint32),
                                  got_j[0].view(np.uint32))
    assert trep.loss == jrep.loss
    assert trep.bucket_counts == jrep.bucket_counts == (3,) + (2,) * (
        buckets - 1)
    assert (trep.n_masked, trep.n_partial) == (jrep.n_masked, jrep.n_partial)
    jtr.close()
    ttr.close()


def _drive(tr, steps, step_fn, results, errors):
    try:
        results[tr.rank] = step_fn(tr, steps)
    except Exception as exc:  # noqa: BLE001 - surfaced by the test body
        errors[tr.rank] = exc
    finally:
        tr.close()


def _run_pair(make, step_fn, steps=3):
    client = FakeKvClient()
    trainers = [make(rank, client) for rank in range(2)]
    results, errors = {}, {}
    threads = [threading.Thread(target=_drive,
                                args=(tr, steps, step_fn, results, errors),
                                daemon=True) for tr in trainers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "trainer thread hung"
    assert not errors, errors
    return results


def _flat(tree) -> np.ndarray:
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    if isinstance(tree, (list, tuple)):
        return np.concatenate([_flat(v) for v in tree])
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return np.asarray(tree, np.float32).reshape(-1)


def test_trainer_three_rounds_match_jax():
    jcfg = jtrain.TrainConfig(model=jtf.TransformerConfig(**MODEL),
                              grad_axes=("dp",), bucket_elems=256,
                              attn_impl="local", learning_rate=LR)
    tcfg = ttrain.TrainConfig(model=ttf.TransformerConfig(**MODEL),
                              bucket_elems=256, learning_rate=LR)
    mesh = make_device_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    init, _, _ = jtrain.make_train_state(jax.random.key(0), jcfg, mesh)
    start = jax.tree.map(np.asarray, init)
    kw = dict(deadline_s=60.0, num_processes=2, retain_rounds=16,
              hb_interval_s=0.1, hb_timeout_s=0.0, check_every=1,
              dcn_bucket_elems=20000)

    def make_j(rank, client):
        params, opt_state, opt = jtrain.make_train_state(
            jax.random.key(0), jcfg, mesh)
        tr = jdcn.DcnDeadlineTrainer(jcfg, mesh, opt, rank=rank,
                                     client=client, **kw)
        tr.state = (params, opt_state)
        return tr

    def step_j(tr, steps):
        params, opt_state = tr.state
        losses = []
        for i in range(steps):
            rows = batch(i)[tr.rank * 2:(tr.rank + 1) * 2]
            params, opt_state, rep = tr.run_round(params, opt_state,
                                                  jnp.asarray(rows))
            losses.append(rep.loss)
        return losses, _flat(jax.tree.map(np.asarray, params))

    def make_t(rank, client):
        tr = tdcn.DcnDeadlineTrainer(tcfg, None, rank=rank, client=client,
                                     **kw)
        tr.state = ttrain.make_train_state(
            tcfg, params=convert.params_from_jax(start))
        return tr

    def step_t(tr, steps):
        losses = []
        for i in range(steps):
            rows = batch(i)[tr.rank * 2:(tr.rank + 1) * 2]
            rep = tr.run_round(tr.state, torch.from_numpy(rows.copy()))
            losses.append(rep.loss)
        return losses, _flat(tr.state.params)

    jres = _run_pair(make_j, step_j)
    tres = _run_pair(make_t, step_t)
    for res in (jres, tres):
        assert res[0][0] == res[1][0]
        np.testing.assert_array_equal(res[0][1], res[1][1])
    np.testing.assert_allclose(tres[0][0], jres[0][0], rtol=1e-5)
    np.testing.assert_allclose(tres[0][1], jres[0][1], atol=1e-4)
    # the trainer moved the weights (three real updates)
    assert np.abs(tres[0][1] - _flat(start)).max() > 1e-4


def test_a_local_mesh_of_two_ranks_beside_a_process_of_one():
    """Process 0 is a local dp=2 mesh (two spawned ranks: rank 0 the DCN
    participant, its peer following it over the local group); process 1
    trains here, its local world one. Both take half the batch rows."""
    import datetime

    import torch.distributed as dist

    import torch_dcn_ranks as ranks

    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

    server = dist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=60))
    out = {}

    def process_one():
        out[1] = ranks.train_process(
            None, 1, ("127.0.0.1", server.port), ranks.BATCHES)

    t = threading.Thread(target=process_one, daemon=True)
    t.start()
    local = spawn_ranks(ranks.train_process, 2, "gloo", "cpu", 0,
                        ("127.0.0.1", server.port), ranks.BATCHES)
    t.join(timeout=300)
    assert not t.is_alive()
    losses, weights = out[1]
    for l_losses, l_weights in local:
        assert l_losses == losses
        np.testing.assert_array_equal(l_weights, weights)
    # one process stepping on the whole batch
    state = ttrain.make_train_state(
        ranks.CFG, generator=torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(ranks.CFG)
    want = [float(step(state, torch.from_numpy(b))["loss"])
            for b in ranks.BATCHES]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
