"""The port's ring and swing allreduce against the JAX package's, on the CPU.

The same per-rank vectors (numpy, from a seed; n x 256 elements) go
through JAX's ``pallas_ring_allreduce`` / ``pallas_swing_allreduce``
(``interpret=True``) under ``shard_map`` on an n-device ``dp`` mesh, and
through the port's ``peer_ring_allreduce`` / ``peer_swing_allreduce`` on
n gloo ranks (CPU tensors: the plain versions), spawned once per n. Pins,
all bitwise (both sides do the same lone f32 adds in the same order):
the ring at n = 2, 3, 4 and the swing at n = 2, 4; a 4-step loop at n = 4
whose next input is ``carry + sum / n`` (the JAX tests' ``lax.scan``
loop); the plain ring against the numpy simulation of the ring schedule
(``test_ring_schedule_index_math``); every rank equal. Also: both
schedules along each axis of a (dp 2, sp 2) mesh, the identity on one
rank, the JAX functions' ``ValueError``s, the mesh coordinates the
schedules address, and that CPU tensors launch nothing.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from akka_allreduce_tpu.ops.pallas_kernels import (pallas_ring_allreduce,
                                                   pallas_swing_allreduce)
from akka_allreduce_tpu.parallel.mesh import single_axis_mesh
from akka_allreduce_tpu_torch.ops.kernels import ring
from akka_allreduce_tpu_torch.parallel.group import RankGroup, spawn_ranks
from torch_ring_ranks import allreduce_loop

JAX_FN = {"ring": pallas_ring_allreduce, "swing": pallas_swing_allreduce}
LOOP = 4
# n -> the (schedule, steps) cases run on n ranks
CASES = {2: [("ring", 1), ("swing", 1)], 3: [("ring", 1)],
         4: [("ring", 1), ("swing", 1), ("ring", LOOP), ("swing", LOOP)]}


def inputs(n: int, schedule: str, steps: int) -> np.ndarray:
    rng = np.random.default_rng(100 * n + 10 * steps + len(schedule))
    return rng.normal(size=(n, n * 256)).astype(np.float32)


def jax_loop(schedule: str, x: np.ndarray, steps: int) -> np.ndarray:
    """(n, steps, elems): each rank's sum at each step of the loop."""
    n = x.shape[0]
    fn = JAX_FN[schedule]
    mesh = single_axis_mesh("dp", devices=jax.devices()[:n])

    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
             check_vma=False)
    def run(b):
        def one(carry, _):
            total = fn(carry, "dp", interpret=True)
            return carry + total / jnp.float32(n), total
        _, sums = jax.lax.scan(one, b[0], None, length=steps)
        return sums[None]
    return np.asarray(jax.jit(run)(x))


@pytest.fixture(scope="module")
def runs():
    """{(n, schedule, steps): (port (n, steps, elems), x)} and the
    launch counts every rank reported."""
    out, launches = {}, []
    for n, cases in CASES.items():
        args = [(s, "dp", inputs(n, s, steps), steps) for s, steps in cases]
        ranks = spawn_ranks(allreduce_loop, n, "gloo", "cpu", args)
        for i, (schedule, steps) in enumerate(cases):
            out[n, schedule, steps] = (
                np.stack([r["sums"][i] for r in ranks]), args[i][2])
        launches += [r["launches"] for r in ranks]
    return out, launches


SINGLE = [(n, s) for n, cases in CASES.items() for s, steps in cases
          if steps == 1]


@pytest.mark.parametrize("n,schedule", SINGLE,
                         ids=[f"{s}-n{n}" for n, s in SINGLE])
def test_plain_matches_jax_interpret_bitwise(runs, n, schedule):
    port, x = runs[0][n, schedule, 1]
    want = jax_loop(schedule, x, 1)
    assert port.shape == want.shape == (n, 1, x.shape[1])
    np.testing.assert_array_equal(port, want)
    for r in range(1, n):  # every rank holds the same bits
        np.testing.assert_array_equal(port[r], port[0])
    np.testing.assert_allclose(port[0, 0], x.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["ring", "swing"])
def test_step_loop_matches_jax_bitwise_per_step(runs, schedule):
    port, x = runs[0][4, schedule, LOOP]
    want = jax_loop(schedule, x, LOOP)
    for step in range(LOOP):
        np.testing.assert_array_equal(port[:, step], want[:, step],
                                      err_msg=f"step {step}")


def simulate_ring(local: np.ndarray) -> np.ndarray:
    """The ring schedule of ``test_ring_schedule_index_math`` over whole
    ring blocks: (n, elems) inputs -> (n, elems) outputs."""
    n = local.shape[0]
    blocks = local.reshape(n, n, -1)  # [device, block]
    carry = [blocks[i][i].copy() for i in range(n)]
    out = np.zeros_like(blocks)
    for s in range(n - 1):
        sent = [c.copy() for c in carry]
        for i in range(n):
            carry[i] = sent[(i - 1) % n] + blocks[i][(i - 1 - s) % n]
    for i in range(n):
        out[i][(i + 1) % n] = carry[i]
    for s in range(n - 1):
        sent = [c.copy() for c in carry]
        for i in range(n):
            out[i][(i - s) % n] = carry[i] = sent[(i - 1) % n]
    return out.reshape(n, -1)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_plain_ring_matches_schedule_simulation(runs, n):
    port, x = runs[0][n, "ring", 1]
    np.testing.assert_array_equal(port[:, 0], simulate_ring(x))


def test_cpu_tensors_launch_no_kernel(runs):
    assert runs[1] and all(c == {"ring_allreduce": 0, "swing_allreduce": 0}
                           for c in runs[1])


ONE_RANK_INPUTS = {
    "f32": lambda x: x,
    "bf16": lambda x: x.to(torch.bfloat16),  # JAX: lax.psum, any dtype
    "2d": lambda x: x.reshape(2, -1)}        # and any shape


@pytest.mark.parametrize("kind", list(ONE_RANK_INPUTS))
@pytest.mark.parametrize("fn", [ring.peer_ring_allreduce,
                                ring.peer_swing_allreduce])
def test_one_rank_is_the_identity(fn, kind):
    x = ONE_RANK_INPUTS[kind](torch.from_numpy(inputs(1, "ring", 1)[0]))
    assert fn(x, RankGroup.single()) is x
    assert ring.counts() == {"ring_allreduce": 0, "swing_allreduce": 0}


@pytest.mark.parametrize("fn,world,elems,match", [
    (ring.peer_ring_allreduce, 4, 4 * 128 + 4, "ring blocks"),
    (ring.peer_ring_allreduce, 4, 2 * 128, "ring blocks"),
    (ring.peer_swing_allreduce, 3, 3 * 128, "power-of-two"),
    (ring.peer_swing_allreduce, 4, 100, "128")])
def test_refusals_match_jax(fn, world, elems, match):
    """Checked before any exchange, so no process group is needed."""
    group = RankGroup(0, world, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        fn(torch.zeros(elems), group)


@pytest.mark.parametrize("fn", [ring.peer_ring_allreduce,
                                ring.peer_swing_allreduce])
def test_refuses_other_dtypes(fn):
    group = RankGroup(0, 2, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(512, dtype=torch.float64), group)


def test_axis_rank_on_a_dp2_sp2_mesh():
    """The global ranks the schedules address along each axis: rank
    (i, j) = i * sp + j, the other coordinate kept."""
    for r in range(4):
        g = RankGroup(r, 4, "gloo", torch.device("cpu"), sp=2)
        i, j = divmod(r, 2)
        assert [g.axis_rank("sp", k) for k in range(2)] == [i * 2, i * 2 + 1]
        assert [g.axis_rank("dp", k) for k in range(2)] == [j, 2 + j]


MESH_CASES = [(s, a) for s in ("ring", "swing") for a in ("sp", "dp")]


@pytest.fixture(scope="module")
def mesh_runs():
    """Each schedule along each axis of a (dp 2, sp 2) mesh of four
    ranks: {(schedule, axis): (world, elems) sums}, and the inputs."""
    x = np.random.default_rng(5).normal(size=(4, 512)).astype(np.float32)
    ranks = spawn_ranks(allreduce_loop, 4, "gloo", "cpu",
                        [(s, a, x, 1) for s, a in MESH_CASES], sp=2)
    return {c: np.stack([r["sums"][i][0] for r in ranks])
            for i, c in enumerate(MESH_CASES)}, x


@pytest.mark.parametrize("schedule,axis", MESH_CASES)
def test_schedules_along_one_axis_of_a_mesh(mesh_runs, schedule, axis):
    """Rank (i, j) = 2 i + j sums with the rank that differs only in the
    axis' coordinate: one f32 add, so bitwise the numpy sum."""
    got, x = mesh_runs[0][schedule, axis], mesh_runs[1]
    for r in range(4):
        peer = r ^ 1 if axis == "sp" else r ^ 2
        np.testing.assert_array_equal(got[r], x[r] + x[peer])


def test_peer_buffers_need_a_cuda_group():
    group = RankGroup(0, 2, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        group.peer_buffers("dp", (1,), 4096)
