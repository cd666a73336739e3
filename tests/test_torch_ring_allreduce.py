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

The kernels' own schedule (push / reduce / gather through per-rank
buffers, every block summed by its owner in the schedule's add order) is
pinned through its plain-torch emulation, ``ring.schedule_emulation``:
bitwise the JAX kernels in interpret mode for the ring at n = 2, 3, 4 and
the swing at n = 2, 4, 8 (ragged and empty blocks too), on one call and on
the 4-call loop, with inputs whose exponents spread so far that a wrong
add order changes the bits (asserted); and, as pure Python, the buffer
layout, the bytes a rank moves and the waits a call.
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
        group.peer_buffers("dp", 4096)


def test_a_group_without_kernel_calls_counts_and_waits_nothing():
    """With no kernel call made (the CPU path), the device count of
    kernels that ran and the count of stream waits are 0, and ``wait``
    returns at once: there is no buffer to wait on."""
    group = RankGroup(0, 2, "gloo", torch.device("cpu"))
    assert ring.kernels_run(group) == 0
    assert ring.stream_waits() == 0
    ring.wait(group, timeout=0.0)


# -- the kernels' schedule, emulated in plain torch ---------------------------

# (schedule, n, elems): even blocks, then ragged and empty swing blocks
# (640 = 5 lanes: at n = 4 blocks of 2, 2, 1, 0 lanes; at n = 8 five of one)
EMULATED = [("ring", 2, 2 * 384), ("ring", 3, 3 * 384), ("ring", 4, 4 * 384),
            ("swing", 2, 2 * 384), ("swing", 4, 4 * 384),
            ("swing", 8, 8 * 384), ("swing", 4, 640), ("swing", 8, 640)]
EMULATED_IDS = [f"{s}-n{n}-{e}" for s, n, e in EMULATED]


def wide_inputs(n: int, elems: int, seed: int) -> np.ndarray:
    """(n, elems) f32 whose exponents spread over 2^-20 .. 2^20, so the
    add order decides most elements' low bits."""
    rng = np.random.default_rng(seed)
    scale = np.exp2(rng.integers(-20, 21, size=(n, elems)))
    return (rng.normal(size=(n, elems)) * scale).astype(np.float32)


def emulate(schedule: str, x: np.ndarray) -> np.ndarray:
    outs = ring.schedule_emulation([torch.from_numpy(r.copy()) for r in x],
                                   schedule)
    return np.stack([o.numpy() for o in outs])


@pytest.mark.parametrize("schedule,n,elems", EMULATED, ids=EMULATED_IDS)
def test_schedule_emulation_matches_jax_interpret_bitwise(schedule, n,
                                                          elems):
    x = wide_inputs(n, elems, 10 * n + len(schedule))
    want = jax_loop(schedule, x, 1)[:, 0]
    np.testing.assert_array_equal(emulate(schedule, x), want)


@pytest.mark.parametrize("schedule", ["ring", "swing"])
def test_schedule_emulation_loop_matches_jax_bitwise(schedule):
    """The file's 4-call loop at n = 4: next input ``carry + sum / n``."""
    n = 4
    x = wide_inputs(n, n * 384, 7)
    want = jax_loop(schedule, x, LOOP)
    carry = x
    for step in range(LOOP):
        total = emulate(schedule, carry)
        np.testing.assert_array_equal(total, want[:, step],
                                      err_msg=f"step {step}")
        carry = carry + total / np.float32(n)


def reversed_chain(parts: list) -> torch.Tensor:
    acc = parts[-1]
    for p in parts[-2::-1]:
        acc = acc + p
    return acc


def left_tree(parts: list) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


@pytest.mark.parametrize("schedule,n,elems",
                         [c for c in EMULATED if c[1] > 2],
                         ids=[i for c, i in zip(EMULATED, EMULATED_IDS)
                              if c[1] > 2])
def test_inputs_tell_the_add_orders_apart(schedule, n, elems):
    """On these inputs another add order gives other bits: the ring's
    chain reversed, the swing's tree leaning left ((x0 + x1) + x2) + x3.
    So the bitwise tests above would catch a wrong order."""
    x = torch.from_numpy(wide_inputs(n, elems, 10 * n + len(schedule)))
    for b in range(n):
        lo, hi = ring.block_range(b, elems, n)
        if lo == hi:
            continue
        parts = [x[q, lo:hi] for q in ring.add_order(b, n, schedule)]
        right = ring.owner_sum(parts, schedule)
        wrong = (reversed_chain if schedule == "ring" else left_tree)(parts)
        assert not torch.equal(right, wrong), f"block {b}"


@pytest.mark.parametrize("n,elems,want", [
    (2, 768, [(0, 384), (384, 768)]),
    (4, 2048, [(0, 512), (512, 1024), (1024, 1536), (1536, 2048)]),
    (4, 640, [(0, 256), (256, 512), (512, 640), (640, 640)]),
    (8, 256, [(0, 128), (128, 256)] + [(256, 256)] * 6)])
def test_buffer_layout(n, elems, want):
    """Blocks of whole lanes (the ring's numel / n; the last ragged or
    empty), rank r owning block r + 1, and each buffer's 2(n - 1) slots:
    inbound first, gather after, each sender's slot its distance less
    one, then the 128 bytes of counters."""
    s = ring.block_elems(elems, n)
    assert [ring.block_range(b, elems, n) for b in range(n)] == want
    assert [ring.owned_block(r, n) for r in range(n)] == [
        (r + 1) % n for r in range(n)]
    assert ring.buffer_bytes(n, elems) == 8 * (n - 1) * s + 128
    for dst in range(n):
        srcs = [q for q in range(n) if q != dst]
        assert sorted(ring.inbound_offset(q, dst, n, elems)
                      for q in srcs) == [i * s for i in range(n - 1)]
        assert sorted(ring.gather_offset(q, dst, n, elems)
                      for q in srcs) == [(n - 1 + i) * s
                                         for i in range(n - 1)]
        assert ring.inbound_offset((dst + 1) % n, dst, n, elems) == 0
    with pytest.raises(ValueError, match="own buffer"):
        ring.slot(1, 1, n)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_rank_bytes_count_the_schedule(n):
    """2N + 4(n - 1)/n N a rank on even blocks (4N at two ranks, 5N at
    four): push and gather read and store (n - 1)/n N each, reduce reads
    N and stores N. Two waits and three kernels a call."""
    elems = n * 128 * 6
    p = 4 * elems
    for r in range(n):
        assert ring.rank_bytes(n, elems, r) == 2 * p + 4 * (n - 1) * p // n
    assert (ring.WAITS_PER_CALL, ring.KERNELS_PER_CALL) == (2, 3)


def test_rank_bytes_on_ragged_blocks():
    """640 elements at n = 4: blocks of 256, 256, 128, 0, owned by ranks
    3, 0, 1, 2; a rank moves its peers' blocks twice and its own 2n
    times."""
    got = [ring.rank_bytes(4, 640, r) for r in range(4)]
    own = [256, 128, 0, 256]
    assert got == [4 * (4 * (640 - o) + 8 * o) for o in own]
