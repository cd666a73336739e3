"""The hybrid on local tp / ep / pp meshes against the JAX package's.

JAX's ``DcnDeadlineTrainer`` takes any local mesh: its wire vector is the
process's whole gradient tree (the global arrays, ``tree_bucket_spec``
order; at pp > 1 the stacked layers, the non-layer leaves after the pp
sum), and every process applies the masked mean to its own sharded
state. Here two JAX trainers (two threads over a ``tests/kv_fake.py
FakeKvClient``, each on its own local mesh of two virtual CPU devices)
and two port processes (four spawned gloo ranks: process = the ``dp``
index, its local group the ``tp``, ``ep`` or ``pp`` line through the
rank) run three rounds from the same weights on the same rows, at
local ``MeshSpec(tp=2)``, ``(ep=2)`` on an MoE model and ``(pp=2)`` on
the f32 and the bf16 wires (ROADMAP C15: pp is held on these wires, on
which every stage's copy of the replicated leaves stays bitwise).

* Losses within rtol 1e-5 and the final whole weights within atol 1e-4
  of JAX's (XLA and PyTorch sum in other orders; see
  ``test_torch_dcn_train.py`` for the atol); both port processes end
  bitwise equal (their CRC check runs every round).
* Round 0's published f32 buckets: bitwise the JAX codec's bytes for the
  port's whole gradient tree, whose structure is JAX's global tree (the
  stacked layers at pp=2), and within rtol 1e-4, atol 1e-6 of the bytes
  JAX's trainer published (the leaf order: a misplaced leaf is off by
  the gradients' own size).
"""

import datetime
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from kv_fake import FakeKvClient

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.ops.bucketing import tree_to_vector as jvector
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu.runtime import dcn_train as jdcn
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

import torch_dcn_mesh_ranks as ranks

MODEL = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=16)
MOE = dict(n_experts=4, d_ff=64, capacity_factor=8.0, router_k=2,
           aux_loss_coef=0.0)
KW = dict(bucket_elems=256, attn_impl="local", learning_rate=1e-3)
TRAINER = dict(deadline_s=60.0, retain_rounds=16, hb_interval_s=0.1,
               hb_timeout_s=0.0, check_every=1, dcn_bucket_elems=20000)
# (name, local mesh axis, model, moe, train kw, DCN wire)
CASES = [("tp2", "tp", MODEL, None, {}, "f32"),
         ("ep2", "ep", dict(MODEL, moe_every=2), MOE, {}, "f32"),
         ("pp2", "pp", MODEL, None, dict(microbatches=2), "f32"),
         ("pp2-bf16", "pp", MODEL, None, dict(microbatches=2), "bf16")]
BATCHES = [np.random.default_rng(i).integers(0, 61, size=(8, 16),
                                             dtype=np.int32)
           for i in range(3)]


def _jcfg(model, moe, kw):
    return jtrain.TrainConfig(model=jtf.TransformerConfig(
        **{**model, "moe": None if moe is None else JMoE(**moe)}),
        **{**KW, **kw})


def _flat(tree) -> np.ndarray:
    return np.asarray(jvector(jax.tree.map(jnp.asarray, tree)))


def _jax_pair(axis, model, moe, kw, wire):
    """Two JAX trainers on local meshes of two devices each; per
    process: losses, final whole params, round 0's buckets."""
    cfg = _jcfg(model, moe, kw)
    client = FakeKvClient()
    out, errors = {}, {}

    def run(p):
        try:
            mesh = make_device_mesh(MeshSpec(**{axis: 2}),
                                    devices=jax.devices()[2 * p:2 * p + 2])
            params, opt_state, opt = jtrain.make_train_state(
                jax.random.key(0), cfg, mesh)
            tr = jdcn.DcnDeadlineTrainer(cfg, mesh, opt, rank=p,
                                         num_processes=2, client=client,
                                         wire=wire, **TRAINER)
            losses = []
            try:
                for b in BATCHES:
                    rows = b[p * 4:(p + 1) * 4]
                    params, opt_state, rep = tr.run_round(
                        params, opt_state, jnp.asarray(rows))
                    losses.append(rep.loss)
                payload = [client.key_value_try_get_bytes(tr._gkey(0, p, k))
                           for k in range(tr._n_chunks)]
            finally:
                tr.close()
            out[p] = (losses, _flat(params), payload)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errors[p] = exc
    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "JAX trainer thread hung"
    assert not errors, errors
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX's pairs, and every case on one spawn of four gloo ranks."""
    jax_out, runs_ = {}, []
    server = dist.TCPStore("127.0.0.1", 0, is_master=True,
                           wait_for_workers=False,
                           timeout=datetime.timedelta(seconds=120))
    for name, axis, model, moe, kw, wire in CASES:
        cfg = _jcfg(model, moe, kw)
        mesh = make_device_mesh(MeshSpec(**{axis: 2}),
                                devices=jax.devices()[:2])
        params, _, _ = jtrain.make_train_state(jax.random.key(0), cfg, mesh)
        jax_out[name] = _jax_pair(axis, model, moe, kw, wire)
        runs_.append((name, axis, model, moe, {**KW, **kw},
                      jax.tree.map(np.asarray, params), BATCHES,
                      ("127.0.0.1", server.port),
                      dict(TRAINER, wire=wire)))
    mesh = {"tp": dict(tp=2), "ep": dict(ep=2), "pp": dict(pp=2)}
    port = {}
    # one spawn: the (dp=2, X=2) meshes share the world of four; each
    # case builds its own mesh group (torch_pp_ranks.mesh_cases)
    got = spawn_ranks(ranks.mesh_cases, 4, "gloo", "cpu",
                      [(mesh[case[1]], run) for run, case in
                       zip(runs_, CASES)], timeout=600)
    for k, (name, *_r) in enumerate(CASES):
        port[name] = [rank[k] for rank in got]
    return jax_out, port


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_trainer_pair_matches_jax(runs, name):
    jax_out, port = runs
    got = port[name]
    # the two processes' lead ranks, and every local rank alike
    leads = [r for r in got if r["lead"]]
    assert len(leads) == 2
    for r in got:
        assert r["losses"] == leads[0]["losses"]
        np.testing.assert_array_equal(r["params"], leads[0]["params"])
        assert r["crc"] == leads[0]["crc"]
    np.testing.assert_allclose(leads[0]["losses"], jax_out[name][0][0],
                               rtol=1e-5)
    np.testing.assert_allclose(leads[0]["params"], jax_out[name][0][1],
                               atol=1e-4)
    assert np.abs(leads[0]["params"] - jax_out[name][1][1]).max() < 1e-4


@pytest.mark.parametrize("name", ["tp2", "pp2"])
def test_round0_payload_is_jax(runs, name):
    jax_out, port = runs
    for p, lead in enumerate(r for r in port[name] if r["lead"]):
        grads = convert.params_to_jax(lead["grads0"])
        vec = _flat(grads)
        loss, toks, _ = jdcn._HDR.unpack_from(lead["payload"][0])
        n = TRAINER["dcn_bucket_elems"]
        want = [jdcn.encode_payload(vec[lo:lo + n], loss, toks, "f32")
                for lo in range(0, vec.size, n)]
        assert lead["payload"] == want
        if name == "pp2":  # the JAX global tree: the layers stacked
            assert isinstance(grads["layers"], dict)
            assert next(iter(grads["layers"].values())).shape[0] == 2
        jvec = np.concatenate([jdcn.decode_payload(d)[2]
                               for d in jax_out[name][p][2]])
        np.testing.assert_allclose(vec, jvec, rtol=1e-4, atol=1e-6)
