"""The port's collective autotuner against the JAX package's.

The cases of ``tests/test_autotune.py``: with the same injected
measurement cell the port's plan JSON and ``plan_hash`` are
byte-identical to JAX's (single axis and the (dp, sp) two-axis group);
``feasible_arms`` and ``resolve_schedule`` agree with JAX on a grid of
wire x live sizes x rows x plan; the sidecar round-trips, reloads
instead of measuring, measures again on a fingerprint mismatch or a
corrupt file; a raising arm is recorded and falls back. JAX's
zero-recompile contract becomes "one resolved schedule per class": a
frozen plan dispatches one schedule on every round and every rank, and
``auto`` is bitwise the schedule it pins. Across gloo ranks on the CPU,
ranks whose clocks disagree (and whose arms fail on one rank only) still
build the same plan, and the default harness measures on the real group.
"""

import json

import jax
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.ops import autotune as ja
from akka_allreduce_tpu.parallel.mesh import (MeshSpec, make_device_mesh,
                                              single_axis_mesh)
from akka_allreduce_tpu_torch.ops import autotune as ta
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

import torch_autotune_ranks as ranks

N = 8
TIMINGS = {"fused": 2e-3, "windowed:4": 1.5e-3, "swing": 1e-3,
           "hierarchical": 1.25e-3}


class FakeGroup:
    """A stand-in for a ``RankGroup`` of ``world`` ranks in one process
    whose peers all report what this rank does (the plan's inputs are
    then the same on every rank, as an injected cell makes them)."""

    def __init__(self, world=N, sp=1):
        self.rank, self.world, self.sp = 0, world, sp
        self.device = torch.device("cpu")

    def axis_size(self, axis):
        return self.sp if axis == "sp" else self.world // self.sp

    def all_gather(self, x):
        return torch.cat([x] * self.world)

    def barrier(self):
        pass


class BackendGroup(FakeGroup):
    """A :class:`FakeGroup` whose ranks name their rank transport."""

    def __init__(self, backend, world=N, sp=1):
        super().__init__(world, sp)
        self.backend = backend


def cell(timings):
    """An injected measurement cell: fixed seconds per arm, an exception
    raised where the script says so."""
    def run(arm, rows, cols):
        if arm not in timings:
            raise RuntimeError(f"no timing scripted for {arm}")
        t = timings[arm]
        if isinstance(t, Exception):
            raise t
        return t
    return run


def jax_plan(shapes, wire, timings, sp=1):
    if sp == 1:
        mesh, axes = single_axis_mesh("dp", devices=jax.devices()[:N]), "dp"
    else:
        mesh = make_device_mesh(MeshSpec(dp=N // sp, sp=sp),
                                devices=jax.devices()[:N])
        axes = ("dp", "sp")
    return ja.measure_plan(mesh, axes, shapes, wire=wire,
                           measure_cell=cell(timings))


@pytest.mark.parametrize("wire,sp", [("f32", 1), ("ef8", 1), ("int8", 1),
                                     ("f32", 4), ("ef8", 2), ("int8", 4)])
@pytest.mark.parametrize("timings", [
    TIMINGS, {**TIMINGS, "swing": 3e-3},
    {**TIMINGS, "windowed:4": RuntimeError("host noise")},
    {k: RuntimeError("no cell survived") for k in TIMINGS}],
    ids=["base", "slow-swing", "raising-arm", "all-raise"])
def test_plan_bytes_and_hash_equal_jax(wire, sp, timings):
    shapes = [(4, 512), (16, 2048), (1, 256)]
    want = jax_plan(shapes, wire, timings, sp)
    got = ta.measure_plan(FakeGroup(N, sp), shapes, wire=wire,
                          measure_cell=cell(timings))
    assert got.canonical_bytes() == want.canonical_bytes()
    assert got.plan_hash == want.plan_hash


LIVE = [[], [8], [6], [1], [2, 4], [1, 8], [1, 6], [3, 2]]


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "ef8"])
def test_feasible_arms_and_resolve_agree_with_jax(wire):
    def pin(schedule, windows=1):
        return ja.CollectivePlan(wire=wire, axes=(("dp", 8),), entries={
            ja.plan_key(4, 512): ja.PlanEntry(schedule, windows, {})})
    plans = [None, ja.CollectivePlan(wire=wire, axes=(), entries={})] + [
        pin(s, w) for s, w in (("fused", 1), ("windowed", 2), ("swing", 1),
                               ("hierarchical", 1))]
    for live in LIVE:
        for rows in (1, 3, 8):
            assert ta.feasible_arms(wire, live, rows) == \
                ja.feasible_arms(wire, live, rows)
        for plan in plans:
            port = None if plan is None else ta.CollectivePlan.from_json(
                plan.to_json())
            for rows in (4, 5):
                assert ta.resolve_schedule(port, rows, 512, live, wire) == \
                    ja.resolve_schedule(plan, rows, 512, live, wire)


def test_winner_is_the_measured_minimum():
    plan = ta.measure_plan(FakeGroup(), [(8, 256)], wire="f32",
                           measure_cell=cell({"fused": 5e-3,
                                              "windowed:4": 1e-3,
                                              "swing": 2e-3}))
    e = plan.lookup(8, 256)
    assert (e.schedule, e.num_windows) == ("windowed", 4)
    assert set(e.timings_us) == {"fused", "windowed:4", "swing"}


def test_markdown_table_renders_every_arm():
    plan = ta.measure_plan(FakeGroup(), [(4, 512), (4, 4096)], wire="f32",
                           measure_cell=cell({"fused": 2e-3,
                                              "windowed:4": 3e-3,
                                              "swing": 1e-3}))
    table = ta.plan_markdown_table(plan)
    assert "4 x 512" in table and "4 x 4096" in table
    assert "**swing**" in table and "swing (us/round)" in table
    assert table == ja.plan_markdown_table(ja.CollectivePlan.from_json(
        plan.to_json()))


def test_raising_arm_falls_back_to_survivors():
    plan = ta.measure_plan(FakeGroup(), [(4, 512)], wire="f32",
                           measure_cell=cell({"fused": 2e-3,
                                              "windowed:4": RuntimeError(
                                                  "host noise"),
                                              "swing": 3e-3}))
    e = plan.lookup(4, 512)
    assert e.schedule == "fused" and "windowed:4" not in e.timings_us
    assert "host noise" in e.note


def test_every_arm_raising_yields_the_hand_flag_default():
    boom = RuntimeError("no cell survived")
    plan = ta.measure_plan(FakeGroup(), [(4, 512)], wire="f32",
                           measure_cell=cell(dict.fromkeys(TIMINGS, boom)))
    e = plan.lookup(4, 512)
    assert (e.schedule, e.num_windows) == ("fused", 1)
    assert "hand-flag default" in e.note and plan.plan_hash


class TestSidecar:
    def test_round_trip_is_byte_identical(self, tmp_path):
        plan = ta.measure_plan(FakeGroup(), [(4, 512)], wire="ef8",
                               measure_cell=cell(TIMINGS))
        ta.save_plan(str(tmp_path), plan)
        back = ta.load_plan(str(tmp_path))
        assert back.canonical_bytes() == plan.canonical_bytes()
        # the JAX package reads the port's sidecar to the same plan
        assert ja.load_plan(str(tmp_path)).plan_hash == plan.plan_hash

    def test_reload_instead_of_remeasure(self, tmp_path):
        calls = []

        def counting(arm, rows, cols):
            calls.append(arm)
            return TIMINGS[arm]
        p1, reused1 = ta.load_or_measure(str(tmp_path), FakeGroup(),
                                         [(4, 512)], wire="f32",
                                         measure_cell=counting)
        assert not reused1 and calls
        calls.clear()
        p2, reused2 = ta.load_or_measure(str(tmp_path), FakeGroup(),
                                         [(4, 512)], wire="f32",
                                         measure_cell=counting)
        assert reused2 and not calls and p2.plan_hash == p1.plan_hash

    def test_fingerprint_mismatch_remeasures(self, tmp_path):
        c = cell(TIMINGS)
        ta.load_or_measure(str(tmp_path), FakeGroup(), [(4, 512)],
                           wire="f32", measure_cell=c)
        _, reused = ta.load_or_measure(str(tmp_path), FakeGroup(),
                                       [(4, 512)], wire="ef8",
                                       measure_cell=c)
        assert not reused  # another wire
        _, reused = ta.load_or_measure(str(tmp_path), FakeGroup(),
                                       [(4, 512), (32, 512)], wire="ef8",
                                       measure_cell=c)
        assert not reused  # a class the sidecar lacks
        _, reused = ta.load_or_measure(str(tmp_path), FakeGroup(N, 2),
                                       [(4, 512), (32, 512)], wire="ef8",
                                       measure_cell=c)
        assert not reused  # another mesh

    def test_a_plan_is_not_reloaded_across_rank_transports(self, tmp_path):
        """A plan timed on the gloo host wire is measured again for an
        ``ipc`` group (the backend is in the fingerprint and the hash);
        a plan saved under the same backend reloads byte for byte."""
        calls = []

        def counting(arm, rows, cols):
            calls.append(arm)
            return TIMINGS[arm]
        sidecar = tmp_path / "collective_plan.json"
        gloo, _ = ta.load_or_measure(str(tmp_path), BackendGroup("gloo"),
                                     [(4, 512)], wire="f32",
                                     measure_cell=counting)
        assert gloo.backend == "gloo" and json.loads(
            sidecar.read_text())["backend"] == "gloo"
        calls.clear()
        ipc, reused = ta.load_or_measure(str(tmp_path), BackendGroup("ipc"),
                                         [(4, 512)], wire="f32",
                                         measure_cell=counting)
        assert not reused and calls and ipc.backend == "ipc"
        assert ipc.plan_hash != gloo.plan_hash
        saved = sidecar.read_bytes()
        calls.clear()
        again, reused = ta.load_or_measure(str(tmp_path),
                                           BackendGroup("ipc"), [(4, 512)],
                                           wire="f32", measure_cell=counting)
        assert reused and not calls
        assert again.canonical_bytes() == ipc.canonical_bytes()
        assert sidecar.read_bytes() == saved

    def test_corrupt_sidecar_remeasures(self, tmp_path):
        (tmp_path / "collective_plan.json").write_text(
            json.dumps({"version": 1, "wire": "f32"}))  # no axes
        assert ta.load_plan(str(tmp_path)) is None
        plan, reused = ta.load_or_measure(str(tmp_path), FakeGroup(),
                                          [(4, 512)], wire="f32",
                                          measure_cell=cell(TIMINGS))
        assert not reused and plan.lookup(4, 512) is not None


def test_no_plan_or_class_is_the_flag_default():
    assert ta.resolve_schedule(None, 4, 512, [8], "f32") == ("fused", 4)
    empty = ta.CollectivePlan(wire="f32", axes=(("dp", 8),), entries={})
    assert ta.resolve_schedule(empty, 4, 512, [8], "f32") == ("fused", 4)
    assert ta.resolve_schedule(None, 4, 512, [2, 4], "ef8") == \
        ("hierarchical", 4)


def _grads(world, seed=11):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(24, 40)).astype(np.float32),
             "b": rng.normal(size=(40,)).astype(np.float32)}
            for _ in range(world)]


def _pin(schedule, windows=1, world=4):
    # 24 x 40 + 40 = 1000 elements: 4 bucket rows of 256
    return ta.CollectivePlan(wire="f32", axes=(("dp", world),), entries={
        ta.plan_key(4, 256): ta.PlanEntry(schedule, windows,
                                          {schedule: 1.0})})


@pytest.fixture(scope="module")
def dispatch():
    cases = [("fused", None, 4), ("auto", _pin("fused"), 4),
             ("swing", None, 4), ("auto", _pin("swing"), 4),
             ("windowed", None, 2), ("auto", _pin("windowed", 2), 4),
             ("auto", ta.CollectivePlan(wire="f32", axes=(("dp", 4),),
                                        entries={}), 4)]
    return spawn_ranks(ranks.dispatch_rounds, 4, "gloo", "cpu", _grads(4),
                       cases)


@pytest.mark.parametrize("fixed,auto,schedule", [
    (0, 1, "fused"), (2, 3, "swing"), (4, 5, "windowed"), (0, 6, "fused")])
def test_auto_is_bitwise_the_schedule_it_pins(dispatch, fixed, auto,
                                              schedule):
    for rank in dispatch:
        for (want, _), (got, ran) in zip(rank[fixed], rank[auto]):
            assert ran == schedule
            for k in want:
                assert torch.equal(want[k], got[k])


def test_one_resolved_schedule_per_class(dispatch):
    """A frozen plan gives every round and every rank one schedule."""
    for case in range(1, 7, 2):
        assert len({ran for rank in dispatch for _, ran in rank[case]}) == 1


def test_ranks_with_other_clocks_build_one_plan():
    shapes = [(4, 512), (16, 2048)]
    got = spawn_ranks(ranks.skewed_plan, 2, "gloo", "cpu", shapes, TIMINGS)
    assert got[0] == got[1]
    plan = ta.CollectivePlan.from_json(json.loads(got[0]))
    e = plan.lookup(4, 512)
    # the slowest rank's time per arm (rank 1's, twice rank 0's), the
    # arm that failed on one rank dropped on both
    assert e.timings_us == {"fused": 4000.0, "windowed:4": 3000.0}
    assert e.schedule == "windowed" and "rank 1" in e.note


def test_default_harness_measures_on_the_ranks(tmp_path):
    d = str(tmp_path)
    first = spawn_ranks(ranks.measured_plan, 2, "gloo", "cpu", d,
                        [(4, 1024)], "f32")
    assert first[0] == first[1] and not first[0][1]
    plan = ta.CollectivePlan.from_json(json.loads(first[0][0]))
    e = plan.lookup(4, 1024)
    assert set(e.timings_us) == {"fused", "windowed:4", "swing"}
    assert e.note == "" and all(t > 0 for t in e.timings_us.values())
    before = (tmp_path / "collective_plan.json").read_bytes()
    again = spawn_ranks(ranks.measured_plan, 2, "gloo", "cpu", d,
                        [(4, 1024)], "f32")
    assert again[0] == (first[0][0], True) == again[1]
    assert (tmp_path / "collective_plan.json").read_bytes() == before


def test_time_rounds_sizes_the_sets_to_set_seconds(monkeypatch):
    """On a host clock that a round advances by 2 ms: ``set_seconds``
    0.05 turns the 2 / 1 rounds asked for into the 25 a 0.05 s set
    holds, ``rounds_lo`` a quarter of them, and the two-point delta
    reads the round's 2 ms; without it, or when the warm-up set already
    takes ``set_seconds``, the rounds stay as asked."""
    clock = [0.0]
    monkeypatch.setattr(ta.time, "perf_counter", lambda: clock[0])

    def run(rounds, rep):
        clock[0] += 2e-3 * rounds
    t = ta.time_rounds(FakeGroup(world=1), run, 2, 1, 3, "a round",
                       set_seconds=0.05)
    assert (t.rounds_hi, t.rounds_lo) == (25, 6)
    assert t.hi == pytest.approx((0.05,) * 3)
    assert t.lo == pytest.approx((0.012,) * 3)
    assert t.seconds == pytest.approx(2e-3) and t.spread == pytest.approx(0)
    fixed = ta.time_rounds(FakeGroup(world=1), run, 2, 1, 1, "a round")
    assert (fixed.rounds_hi, fixed.rounds_lo) == (2, 1)
    # a warm-up that already fills the set keeps the rounds asked for
    full = ta.time_rounds(FakeGroup(world=1), run, 2, 1, 1, "a round",
                          set_seconds=0.003)
    assert (full.rounds_hi, full.rounds_lo) == (2, 1)


def test_round_timing_spread_is_the_reps_range():
    """Sets of 8 and 2 rounds: the slowest hi set against the fastest lo
    set gives (9 - 1) / 6, the reverse (8 - 2) / 6; their gap over the
    median-based round time."""
    t = ta.RoundTiming(seconds=1.0, rounds_hi=8, rounds_lo=2,
                       hi=(8.0, 9.0, 8.5), lo=(1.0, 2.0, 1.5))
    assert t.spread == pytest.approx((8 / 6 - 6 / 6) / 1.0)
