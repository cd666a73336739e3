"""The rank transport (``--dist-backend ipc``, ``ops/kernels/transport.py``)
on the CPU: its schedule, emulated on numpy bytes, against gloo ranks and
JAX's collectives.

Pins:

* ``transport.emulate`` — every rank's push / pull stretches and stream
  waits of :func:`transport.rank_plan`, interleaved one op at a time —
  is bitwise what gloo CPU ranks give for ``all_to_all``, ``all_gather``,
  ``exchange`` and ``ppermute`` at n = 2, 3 and 4 and on both lines of a
  (2, 2) mesh, in f32, bf16 and int8, with payloads of several chunks
  and a ragged last one (a 40-byte chunk here; 64 MiB on the card);
* ``all_to_all`` and ``all_gather`` through the emulation equal
  ``lax.all_to_all`` / ``lax.all_gather`` on the JAX tests' virtual CPU
  mesh;
* the layout: slots, halves and counters never overlap (a hypothesis
  property), and the emulation catches a plan without its consumed
  waits (a half overwritten) and ranks that make different calls (a
  deadlock);
* ``ipc`` refuses the CPU everywhere and never falls back to gloo.

The card tests (``tests/test_torch_kernels_cuda.py -k transport``) run
the same cases on ``ipc`` ranks against their gloo twins, and a peer that
skips a call.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

import torch_transport_ranks as tr
from akka_allreduce_tpu.parallel.mesh import single_axis_mesh
from akka_allreduce_tpu_torch import cli
from akka_allreduce_tpu_torch.ops.kernels import transport as T
from akka_allreduce_tpu_torch.parallel.group import (RankGroup,
                                                     check_backend,
                                                     spawn_ranks)

CHUNK = 40  # bytes: every payload below takes 2-3 chunks, the last ragged
SCENARIOS, SHAPES = tr.SCENARIOS, tr.SHAPES
payload, scenario_cases = tr.payload, tr.scenario_cases


def lines(world: int, sp: int, scope: str) -> list:
    """The global ranks of every line of ``scope``, in line order."""
    if scope == "world":
        return [tuple(range(world))]
    if scope == "sp":
        return [tuple(i * sp + j for j in range(sp))
                for i in range(world // sp)]
    return [tuple(i * sp + j for i in range(world // sp))
            for j in range(sp)]


def emulated(name: str, cases: list) -> list:
    """Per case, every global rank's output bytes through the
    transport's schedule: each buffer (the world's, or a line's) runs its
    calls as one sequence, so the pairs' chunk counts carry from call to
    call."""
    world, sp = SCENARIOS[name]
    got = [[None] * world for _ in cases]
    for scope in sorted({c[0] for c in cases}):
        idx = [i for i, c in enumerate(cases) if c[0] == scope]
        for line in lines(world, sp, scope):
            calls = []
            for i in idx:
                _, kind, _, xs, kw = cases[i]
                calls.append((kind, [xs[g] for g in line], kw))
            outs = T.emulate(calls, len(line), CHUNK, seed=len(line))
            for i, per_rank in zip(idx, outs):
                for q, g in enumerate(line):
                    got[i][g] = per_rank[q].reshape(-1).view(np.uint8)
    return got


_RUNS: dict = {}


def scenario_run(name: str) -> tuple:
    """The cases of one spawn, the gloo ranks' bytes and the emulation's
    (spawned once per scenario and kept for its cases)."""
    if name not in _RUNS:
        world, sp = SCENARIOS[name]
        cases = scenario_cases(name)
        gloo = spawn_ranks(tr.run_cases, world, "gloo", "cpu", cases, sp=sp)
        _RUNS[name] = cases, gloo, emulated(name, cases)
    return _RUNS[name]


CASE_INDEX = [(name, i) for name in SCENARIOS
              for i in range(len(scenario_cases(name)))]


@pytest.mark.parametrize(
    "name,index", CASE_INDEX,
    ids=[f"{n}-{c[0]}-{c[1]}-{c[2]}-{i}" for n, i in CASE_INDEX
         for c in [scenario_cases(n)[i]]])
def test_emulation_is_bitwise_gloo(name, index):
    """Every rank's bytes through the emulated transport equal its gloo
    rank's."""
    cases, gloo, emu = scenario_run(name)
    scope, kind, dtype = cases[index][:3]
    for r, outs in enumerate(gloo):
        assert np.array_equal(outs[index], emu[index][r]), (
            f"{name} {scope} {kind} {dtype}: rank {r}")


def test_every_scenario_covers_the_collectives_and_dtypes():
    for name in SCENARIOS:
        cases = scenario_cases(name)
        assert {c[1] for c in cases} == set(T.COLLECTIVES)
        assert {c[2] for c in cases} == set(SHAPES)
        # every payload takes more than one chunk, the last one ragged
        for scope, kind, dtype, xs, kw in cases:
            n = 2 if scope != "world" else SCENARIOS[name][0]
            pair = xs[0].nbytes // (n if kind == "all_to_all" else 1)
            assert T.chunk_count(pair, CHUNK) > 1 and pair % CHUNK


def jax_run(fn, n, x):
    mesh = single_axis_mesh("dp", devices=jax.devices()[:n])

    @partial(jax.shard_map, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
             check_vma=False)
    def run(xs):
        return fn(xs[0])[None]

    return np.asarray(run(jnp.asarray(x)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["all_to_all", "all_gather"])
def test_emulation_matches_jax_collectives(kind, dtype, n):
    rng = np.random.default_rng(n)
    shape = ((n,) if kind == "all_to_all" else ()) + SHAPES[dtype]
    xs = [payload(rng, dtype, shape) for _ in range(n)]
    if kind == "all_to_all":
        fn = partial(jax.lax.all_to_all, axis_name="dp", split_axis=0,
                     concat_axis=0)
    else:
        fn = partial(jax.lax.all_gather, axis_name="dp", axis=0, tiled=True)
    want = jax_run(fn, n, np.stack(xs))
    got = T.emulate([(kind, xs, {})], n, CHUNK, seed=3)[0]
    for r in range(n):
        np.testing.assert_array_equal(got[r], want[r])


@settings(max_examples=60, deadline=None)
@given(n=st.integers(2, T.MAX_RANKS), chunk=st.integers(1, 1 << 12),
       nbytes=st.integers(0, 1 << 15))
def test_slots_halves_and_counters_never_overlap(n, chunk, nbytes):
    """Within a rank's buffer every (sender, half) range is its own and
    ends before the counters; every sender's ``ready`` and every
    receiver's ``consumed`` is its own word inside the counters; chunks g
    and g + 1 of a pair use different halves, and the consumed wait
    before chunk g waits for chunk g - 2, the last in its half."""
    dst = n - 1
    ranges = sorted((T.slot_offset(s, dst, n, g, chunk),
                     T.slot_offset(s, dst, n, g, chunk) + chunk)
                    for s in range(n) if s != dst for g in (0, 1))
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))
    assert ranges[-1][1] <= T.counters_offset(n, chunk)
    words = ([T.ready_offset(s, dst, n, chunk) for s in range(n) if s != dst]
             + [T.consumed_offset(d, dst, n, chunk)
                for d in range(n) if d != dst])
    assert len(set(words)) == 2 * (n - 1)
    lo = T.counters_offset(n, chunk)
    assert all(lo <= w and w + 8 <= lo + T.ABANDONED_WORD * 8 for w in words)
    assert T.buffer_bytes(n, chunk) == lo + T.COUNTER_BYTES
    assert T.ABANDONED_WORD * 8 + 16 <= T.COUNTER_BYTES
    for g in range(4):
        assert (T.slot_offset(0, 1, n, g, chunk)
                != T.slot_offset(0, 1, n, g + 1, chunk))
    assert T.consumed_target(0) == T.consumed_target(1) == 0
    assert T.consumed_target(2) == 1  # chunk 0 copied out
    spans = T.chunk_ranges(nbytes, chunk)
    assert len(spans) == T.chunk_count(nbytes, chunk)
    assert sum(hi - lo for lo, hi in spans) == nbytes
    assert all(0 < hi - lo <= chunk for lo, hi in spans)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 5), chunk=st.integers(1, 24),
       elems=st.integers(0, 40), seed=st.integers(0, 1 << 16))
def test_any_interleaving_moves_every_byte(n, chunk, elems, seed):
    """Two all_to_alls, an all_gather and a ppermute on one buffer, the
    ranks interleaved by ``seed``: no half is overwritten early, no rank
    deadlocks, and every output is the collective's."""
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, 255, (n, elems), dtype=np.uint8) for _ in range(n)]
    ys = [rng.integers(0, 255, (elems,), dtype=np.uint8) for _ in range(n)]
    outs = T.emulate([("all_to_all", xs, {}), ("all_gather", ys, {}),
                      ("ppermute", ys, {"shift": 1}),
                      ("all_to_all", xs, {})], n, chunk, seed)
    for r in range(n):
        want = np.stack([xs[p][r] for p in range(n)])
        np.testing.assert_array_equal(outs[0][r], want)
        np.testing.assert_array_equal(outs[3][r], want)
        np.testing.assert_array_equal(outs[1][r], np.concatenate(ys))
        np.testing.assert_array_equal(outs[2][r], ys[(r - 1) % n])


def test_a_plan_without_consumed_waits_overwrites_a_half(monkeypatch):
    """The emulation's guard bites: with the consumed waits gone a fast
    sender lands chunk 2 in a half whose chunk 0 is still unread."""
    monkeypatch.setattr(T, "consumed_target", lambda g: 0)
    xs = [np.full((2, 200), r, np.uint8) for r in range(2)]
    with pytest.raises(AssertionError, match="overwrites"):
        for seed in range(20):
            T.emulate([("all_to_all", xs, {})], 2, 16, seed)


def test_ranks_that_make_different_calls_deadlock():
    xs = [np.zeros((2, 64), np.uint8) for _ in range(2)]
    with pytest.raises(AssertionError, match="deadlock"):
        T.emulate([("ppermute", [xs[0][0], xs[1]], {"shift": 1})], 2, 16)


def test_rank_plan_pushes_one_chunk_ahead_of_its_pulls():
    ops = T.rank_plan([1], [1], 3 * 16 + 5, {1: 4}, {1: 4}, 16)
    kinds = [op[0] if op[0] != "wait" else op[1] for op in ops]
    assert kinds == ["consumed", "push", "consumed", "push", "ready", "pull",
                     "consumed", "push", "ready", "pull", "consumed", "push",
                     "ready", "pull", "ready", "pull"]
    pushes = [op[2] for op in ops if op[0] == "push"]
    assert pushes == [((1, 4),), ((1, 5),), ((1, 6),), ((1, 7),)]
    waits = [op[3] for op in ops if op[0] == "wait"]
    assert waits == [3, 4, 5, 5, 6, 6, 7, 8]


def test_routes_of_each_collective():
    a2a = T.routes("all_to_all", 1, 3, 30)
    assert a2a["sends"] == [(0, 0), (2, 20)] and a2a["recvs"] == a2a["sends"]
    assert a2a["local"] == [(10, 10, 10)] and a2a["pair_bytes"] == 10
    ag = T.routes("all_gather", 2, 3, 8)
    assert ag["recvs"] == [(0, 0), (1, 8)] and ag["out_bytes"] == 24
    assert T.routes("ppermute", 0, 4, 8, shift=-1)["sends"] == [(3, 0)]
    assert T.routes("ppermute", 0, 4, 8, shift=-1)["recvs"] == [(1, 0)]
    with pytest.raises(ValueError):
        T.routes("exchange", 1, 2, 8, peer=1)
    with pytest.raises(ValueError):
        T.routes("scatter", 0, 2, 8)


def test_the_buffers_of_a_2x2_mesh_fit_the_cap():
    """A rank of a (2, 2) mesh holds the world's buffer (3 senders) and
    its two lines' (1 sender each): 10 chunks of the full 64 MiB, under
    the cap."""
    chunk = T.chunk_bytes([4, 2, 2])
    assert chunk == T.CHUNK_BYTES
    held = T.buffer_bytes(4, chunk) + 2 * T.buffer_bytes(2, chunk)
    assert held == 10 * T.CHUNK_BYTES + 3 * T.COUNTER_BYTES
    assert held <= T.BUFFER_CAP_BYTES


def mesh_sizes(world: int, sp: int) -> list:
    """What ``group.transport_sizes`` gives a rank of the mesh: the
    world, then the lines it is on (``axis_lines``)."""
    from akka_allreduce_tpu_torch.parallel.group import axis_lines
    return [world] + [len(ln) for ln in axis_lines(world, sp) if 0 in ln]


@settings(max_examples=80, deadline=None)
@given(world=st.integers(2, T.MAX_RANKS), data=st.data())
def test_every_mesh_up_to_max_ranks_fits_the_cap(world, data):
    """Any (world / sp, sp) mesh the ipc backend takes: one chunk for all
    of a rank's buffers, at most 64 MiB and aligned, and the buffers
    together within 1 GiB; the full chunk up to four ranks."""
    sp = data.draw(st.sampled_from(
        [d for d in range(1, world + 1) if world % d == 0]))
    sizes = mesh_sizes(world, sp)
    chunk = T.chunk_bytes(sizes)
    assert 0 < chunk <= T.CHUNK_BYTES and chunk % T.CHUNK_ALIGN == 0
    held = sum(T.buffer_bytes(n, chunk) for n in sizes)
    assert held <= T.BUFFER_CAP_BYTES
    if world <= 4:
        assert chunk == T.CHUNK_BYTES
    # a larger aligned chunk would not fit (or passes the largest)
    bigger = chunk + T.CHUNK_ALIGN
    assert (chunk == T.CHUNK_BYTES or sum(
        T.buffer_bytes(n, bigger) for n in sizes) > T.BUFFER_CAP_BYTES)


def test_a_dp4_sp2_mesh_takes_a_smaller_chunk():
    """dp 4 x sp 2: 7 + 1 + 3 senders, 22 halves in 1 GiB."""
    chunk = T.chunk_bytes(mesh_sizes(8, 2))
    assert mesh_sizes(8, 2) == [8, 2, 4]
    assert chunk == (T.BUFFER_CAP_BYTES - 3 * T.COUNTER_BYTES) // 22 // \
        T.CHUNK_ALIGN * T.CHUNK_ALIGN
    assert chunk < T.CHUNK_BYTES
    with pytest.raises(ValueError, match="no chunk"):
        T.chunk_bytes([T.MAX_RANKS], cap=T.CHUNK_ALIGN)


def test_ipc_refuses_more_ranks_than_its_tables():
    with pytest.raises(ValueError, match="at most 32"):
        check_backend("ipc", "cuda", T.MAX_RANKS + 1)


class _Ended:
    def query(self):
        return True


def given_up_call(monkeypatch) -> "T._Line":
    """A buffer whose call the watchdog gave up, not raised yet."""
    rec = T._Line(bufs=None, chunk=T.CHUNK_BYTES, sent={}, received={},
                  error="ipc transport: rank 0's all_gather (call 7 ...) did "
                        "not end within 30 s of its start")
    rec.pending.append(T._Pending(_Ended(), _Ended(), 7, "all_gather", []))
    monkeypatch.setitem(T._LINES, (0, 1), rec)
    return rec


def test_a_given_up_call_is_raised_once(monkeypatch):
    """``wait`` raises a call the watchdog gave up, once; later waits
    return (the buffer itself refuses further calls)."""
    rec = given_up_call(monkeypatch)
    with pytest.raises(RuntimeError, match="did not end within"):
        T.wait()
    assert rec.reported and not rec.pending
    T.wait(timeout=0.0)


def test_a_rank_whose_last_call_was_given_up_fails_at_exit(monkeypatch):
    """``free_peer_buffers``, which every ``spawn_ranks`` rank runs after
    its function returns, raises a given-up call that no one waited on,
    before its barriers (no process group is needed to see it), and
    drops the transport's state."""
    from akka_allreduce_tpu_torch.parallel.group import free_peer_buffers
    given_up_call(monkeypatch)
    with pytest.raises(RuntimeError, match="did not end within"):
        free_peer_buffers(RankGroup(0, 2, "ipc", torch.device("cpu")))
    assert not T._LINES


def test_ipc_refuses_the_cpu():
    with pytest.raises(ValueError, match="gloo"):
        check_backend("ipc", "cpu", 2)
    with pytest.raises(ValueError, match="gloo"):
        spawn_ranks(tr.run_cases, 2, "ipc", "cpu", [])


def test_train_on_ipc_with_the_cpu_raises_and_never_falls_back():
    args = cli.build_parser().parse_args(
        ["train", "--device", "cpu", "--dp", "2", "--dist-backend", "ipc",
         "--steps", "1"])
    with pytest.raises(ValueError, match="gloo"):
        cli.run_train(args)


@pytest.mark.parametrize("kind", T.COLLECTIVES)
def test_a_cpu_tensor_under_ipc_raises(kind):
    group = RankGroup(0, 2, "ipc", torch.device("cpu"))
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        if kind == "all_to_all":
            group.all_to_all(x)
        elif kind == "all_gather":
            group.all_gather(x)
        elif kind == "exchange":
            group.exchange(x, 1)
        else:
            group.ppermute(x, "dp", 1)


def test_no_call_counts_nothing():
    T.reset_counts()
    assert T.counts()["transport_launches"] == 0
    assert T.counts()["transport_calls"] == 0
    assert T.stream_waits() == 0
    T.wait(None, timeout=0.0)  # no buffer: returns at once
