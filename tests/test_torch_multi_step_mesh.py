"""``--steps-per-dispatch`` chunks on tp / ep / pp meshes against the JAX
package, and the ``ipc`` transport's replayed plan across several lines.

JAX ``make_multi_step`` scans the train step on any mesh. The port's
chunk runner (``models/train.py make_multi_step``), on two gloo ranks at
(tp=2), (ep=2) MoE on the f32 and ef8 wires and (pp=2) under gpipe and
1f1b, from JAX's weights and batches, runs two chunks of two steps (on
the CPU step by step; on the card one CUDA graph replay a chunk, which
``chip_smoke.py`` phase 27 holds bitwise against its eager chunks). On
the f32 wire its losses and final parameters, gathered to the full list
layout, match JAX's at ``rtol 2e-4, atol 2e-5``. The ef8 wire rounds
with the port's own bits (not JAX's threefry), so its losses are held to
the JAX tests' fixed bound of 0.05 and, bitwise, to the port's own
step-by-step run.

A captured chunk on such a mesh makes transport calls on several
buffers: the tp lines, the ep lines, the pp lines and the syncs'
sub-meshes. ``transport.emulate_replays`` runs one step's calls of all
of them (the tp sums' all_to_all and all_gather, the ep exchange, the pp
transfers both ways, the dense sync's) as one captured plan, replayed
twice after an eager warm-up with the counters of every buffer rewound
between replays: each replay's outputs equal the same calls made
eagerly, bitwise; without the rewind the second replay fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from akka_allreduce_tpu.models import train as jtrain
from akka_allreduce_tpu.models import transformer as jtf
from akka_allreduce_tpu.parallel.ep import MoEConfig as JMoE
from akka_allreduce_tpu.parallel.mesh import MeshSpec, make_device_mesh
from akka_allreduce_tpu_torch import convert
from akka_allreduce_tpu_torch.ops.bucketing import tree_leaves
from akka_allreduce_tpu_torch.ops.kernels import transport as T
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

from torch_mesh_ranks import mesh_cases

MODEL = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq=64)
MOE = dict(n_experts=4, d_ff=64, capacity_factor=8.0, router_k=2,
           aux_loss_coef=0.0)
KW = dict(bucket_elems=256, attn_impl="local", learning_rate=1e-3)
SPD, STEPS = 2, 4
# (name, mesh, model, moe, kw)
CASES = [
    ("tp2", dict(tp=2), MODEL, None, {}),
    ("ep2-moe-f32", dict(ep=2), dict(MODEL, moe_every=2), MOE, {}),
    ("ep2-moe-ef8", dict(ep=2), dict(MODEL, moe_every=2), MOE,
     {"grad_transport": "ef8"}),
    ("pp2-gpipe", dict(pp=2), MODEL, None, {"microbatches": 2}),
    ("pp2-1f1b", dict(pp=2), MODEL, None,
     {"microbatches": 2, "pp_schedule": "1f1b"}),
]


def batches():
    return np.random.default_rng(4).integers(
        0, MODEL["vocab_size"], size=(STEPS, 8, 32), dtype=np.int32)


def port_leaves(tree_np):
    if isinstance(tree_np["layers"], dict):
        tree_np = convert.unstack_jax_items({"params": tree_np})["params"]
    return tree_leaves(convert.params_from_jax(tree_np))


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: JAX's initial weights (numpy), and ``make_multi_step``'s
    losses and final parameters (port layout) over two chunks."""
    toks = batches()
    out = {}
    for name, mesh, model, moe, kw in CASES:
        spec = MeshSpec(**mesh)
        jmesh = make_device_mesh(spec, devices=jax.devices()[:spec.size])
        jcfg = jtrain.TrainConfig(
            model=jtf.TransformerConfig(
                **{**model, "moe": None if moe is None else JMoE(**moe)}),
            **{**KW, **kw})
        params, opt_state, opt = jtrain.make_train_state(
            jax.random.key(0), jcfg, jmesh)
        init = jax.tree.map(np.asarray, params)
        run = jtrain.make_multi_step(jcfg, jmesh, opt)
        ef = jtrain.init_ef_state(jcfg, jmesh, params)
        losses = []
        for i in range(0, STEPS, SPD):
            chunk = jnp.asarray(toks[i:i + SPD])
            if ef is None:
                params, opt_state, ms = run(params, opt_state, chunk)
            else:
                params, opt_state, ms, ef = run(params, opt_state, chunk,
                                                ef)
            losses += [float(x) for x in np.asarray(ms["loss"])]
        out[name] = {"init": init, "losses": losses,
                     "params": port_leaves(jax.tree.map(np.asarray,
                                                        params))}
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """Every case's chunks on two gloo ranks (one spawn), and the ef8
    case step by step (chunks of one) beside its chunks of two."""
    toks = list(batches())
    cases = [("chunk_case", mesh, (model, moe, {**KW, **kw},
                                   jax_runs[name]["init"], toks, SPD))
             for name, mesh, model, moe, kw in CASES]
    _, mesh, model, moe, kw = CASES[2]
    cases.append(("chunk_case", mesh, (model, moe, {**KW, **kw},
                                       jax_runs[CASES[2][0]]["init"], toks,
                                       1)))
    got = spawn_ranks(mesh_cases, 2, "gloo", "cpu", cases)
    out = {name: [r[k] for r in got] for k, (name, *_) in enumerate(CASES)}
    out["ef8-per-step"] = [r[len(CASES)] for r in got]
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_chunks_match_jax_make_multi_step_on_the_mesh(jax_runs, port_runs,
                                                      name):
    want = jax_runs[name]
    for rank in port_runs[name]:
        assert rank["step"] == STEPS
        if name.endswith("ef8"):
            np.testing.assert_allclose(rank["losses"], want["losses"],
                                       rtol=0, atol=0.05)
            continue
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-5)
        got = tree_leaves(rank["params"])
        assert len(got) == len(want["params"])
        for g, w in zip(got, want["params"]):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-5)


def test_ef8_chunks_are_the_per_step_run(port_runs):
    """The ef8 chunks of two steps are bitwise the same run step by
    step: each step's rounding keys are its own step's."""
    for chunked, plain in zip(port_runs["ep2-moe-ef8"],
                              port_runs["ef8-per-step"]):
        assert chunked["losses"] == plain["losses"]
        assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(
            tree_leaves(chunked["params"]), tree_leaves(plain["params"])))


# -- the transport's replayed plan across lines ------------------------------

N, CHUNK = 4, 4096
# a (pp=2, tp=2)-shaped world of four ranks, r = 2 pp_h + tp_l: its tp
# lines, its pp lines (the pp transfers; also standing in for an ep line)
# and the world (a sync's sub-mesh over every rank)
TP = [(0, 1), (2, 3)]
PP = [(0, 2), (1, 3)]


def step_calls(rng):
    """One step's transport calls on three kinds of buffer: a tp sum
    (all_to_all, then all_gather, on the tp lines, 3 chunks a pair),
    the ep exchange both ways (all_to_all on the pp lines, in f32), the
    pp transfers (ppermute +1 and -1 on the pp lines, bf16-sized), the
    dense sync (all_to_all and all_gather over the world)."""
    def xs(shape, dtype=np.float32):
        return [rng.normal(size=shape).astype(dtype) for _ in range(N)]
    return [
        ("all_to_all", xs((2, 3 * CHUNK // 8)), {"lines": TP}),
        ("all_gather", xs((CHUNK // 4 + 3,)), {"lines": TP}),
        ("all_to_all", xs((2, 5, 7)), {"lines": PP}),
        ("all_to_all", xs((2, 5, 7)), {"lines": PP}),
        ("ppermute", xs((CHUNK // 2 + 1,), np.float16),
         {"lines": PP, "shift": 1}),
        ("ppermute", xs((CHUNK // 2 + 1,), np.float16),
         {"lines": PP, "shift": -1}),
        ("all_to_all", xs((4, 2 * CHUNK // 16)), {}),
        ("all_gather", xs((CHUNK // 8,)), {}),
    ]


def expected(calls):
    """What each call gives each global rank, from its definition."""
    out = []
    for kind, xs, kw in calls:
        lines = kw.get("lines") or [tuple(range(N))]
        got = [None] * N
        for line in lines:
            n = len(line)
            for i, g in enumerate(line):
                if kind == "all_to_all":
                    got[g] = np.stack([xs[line[p]][i] for p in range(n)])
                elif kind == "all_gather":
                    got[g] = np.concatenate([xs[p] for p in line])
                else:  # ppermute: from the rank -shift steps away
                    got[g] = xs[line[(i - kw["shift"]) % n]]
        out.append(got)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replays_across_lines_equal_eager_calls(seed):
    rng = np.random.default_rng(seed)
    warm = step_calls(rng)
    replays = [step_calls(rng) for _ in range(2)]
    got_warm, got = T.emulate_replays(replays, N, CHUNK, seed=seed,
                                      warmup=warm)
    eager = T.emulate(warm + replays[0] + replays[1], N, CHUNK, seed=seed)
    flat = got_warm + got[0] + got[1]
    want = expected(warm + replays[0] + replays[1])
    assert len(flat) == len(eager) == len(want)
    for k, (a, b, w) in enumerate(zip(flat, eager, want)):
        for r in range(N):
            np.testing.assert_array_equal(a[r], b[r], err_msg=f"call {k}")
            np.testing.assert_array_equal(a[r], w[r], err_msg=f"call {k}")


def test_replays_across_lines_need_every_buffer_rewound():
    rng = np.random.default_rng(7)
    warm = step_calls(rng)
    replays = [step_calls(rng) for _ in range(2)]
    try:
        _, got = T.emulate_replays(replays, N, CHUNK, warmup=warm,
                                   rewind=False)
    except AssertionError:
        return  # a half overwritten or pulled before its push
    want = expected(replays[1])
    assert any(not np.array_equal(a, b) for call, ref in zip(got[1], want)
               for a, b in zip(call, ref))
