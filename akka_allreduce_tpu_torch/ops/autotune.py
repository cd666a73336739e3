"""Topology-aware collective autotuner: the measured schedule per bucket class.

Counterpart of ``akka_allreduce_tpu/ops/autotune.py``. The gradient sync
has a schedule x wire matrix — (fused / windowed / swing / hierarchical)
x (f32 / bf16 / int8 / ef8) — and the winning schedule flips with the
payload size and the group: latency-bound small buckets want the
log-step swing, bandwidth-bound large ones the two-phase family. This
module measures that instead of leaving it to hand-set flags:

* :func:`measure_plan` times every feasible (schedule, windows) arm per
  bucket-size class on the rank group the train step syncs over (a
  Python loop of rounds, chained through ``abs() + 1e-12``, the ef8
  residual carried from round to round; the two-point delta of the
  medians of ``reps`` sets, :func:`time_rounds`) and records each class's
  winner;
* :class:`CollectivePlan` is the deterministic result: canonical JSON
  (sorted keys, fixed rounding), so the same measurements serialise to
  byte-identical plans, content-hashed for the logs;
* :func:`save_plan` / :func:`load_plan` keep it as a JSON sidecar through
  ``runtime/checkpoint.py``'s atomic write-then-rename, and
  :func:`load_or_measure` reloads it instead of measuring again when its
  fingerprint (version, wire, sync-group axes and rank transport, every
  requested class)
  still matches;
* :func:`resolve_schedule` is the dispatch half:
  ``GradSyncConfig.transport_schedule="auto"`` resolves each bucket
  matrix's class against the plan before dispatch, so a frozen plan gives
  every class one fixed schedule.

Every rank measures the same arms in the same order and takes the same
decisions. A rank's clock is its own, so after each class the ranks
all-gather their timings (and their errors) and every rank takes the
SLOWEST rank's time per arm before the argmin: the plan is then
identical on every rank. Without that, ranks could pick different
winners, dispatch different schedules, and the wire would deadlock. The
decision to widen a two-point span is agreed the same way.

A measurement cell that raises is recorded in its entry's ``note`` and
the class falls back to the surviving arms, or to the hand-flag default
``fused``: the autotuner may never be worse than not having one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from functools import partial
from typing import Callable, Optional, Sequence

import torch


PLAN_VERSION = 1
PLAN_SIDECAR = "collective_plan"

# arms are "fused", "windowed:<W>", "swing", "hierarchical": the
# windowed arm carries its window count, which is part of the schedule


def _arm_schedule(arm: str) -> "tuple[str, int]":
    if arm.startswith("windowed:"):
        return "windowed", int(arm.split(":", 1)[1])
    return arm, 1


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One bucket-size class's verdict: the winning schedule (and window
    count when windowed), every arm's round time in microseconds (the
    slowest rank's median), and a note (fallback reasons, errors)."""

    schedule: str
    num_windows: int
    timings_us: dict
    note: str = ""

    def as_dict(self) -> dict:
        return {"schedule": self.schedule,
                "num_windows": self.num_windows,
                "timings_us": {k: round(float(v), 3)
                               for k, v in sorted(self.timings_us.items())},
                "note": self.note}

    @staticmethod
    def from_dict(d: dict) -> "PlanEntry":
        return PlanEntry(schedule=d["schedule"],
                         num_windows=int(d["num_windows"]),
                         timings_us=dict(d.get("timings_us", {})),
                         note=d.get("note", ""))


def plan_key(rows: int, cols: int) -> str:
    """The bucket-size-class key: the (num_buckets, bucket_elems) shape
    of one sync's bucket matrix."""
    return f"{int(rows)}x{int(cols)}"


@dataclasses.dataclass
class CollectivePlan:
    """The serialised verdict. ``axes`` is the ordered (axis, size) tuple
    of the sync group's live axes the plan was measured on (part of the
    fingerprint: a plan never silently crosses meshes); ``wire`` the
    transport it was measured with; ``backend`` the rank transport under
    it (``gloo``, ``ipc``, ...; None for a group that names none, whose
    JSON is then the JAX package's byte for byte), also part of the
    fingerprint: a plan timed on the host wire is no plan for the device
    wire."""

    wire: str
    axes: tuple
    entries: dict
    version: int = PLAN_VERSION
    backend: Optional[str] = None

    def lookup(self, rows: int, cols: int) -> Optional[PlanEntry]:
        return self.entries.get(plan_key(rows, cols))

    # -- canonical serialisation (same measurements => same bytes) -------

    def to_json(self) -> dict:
        doc = {
            "version": self.version,
            "wire": self.wire,
            "axes": [[str(a), int(n)] for a, n in self.axes],
            "entries": {k: self.entries[k].as_dict()
                        for k in sorted(self.entries)},
        }
        if self.backend is not None:
            doc["backend"] = self.backend
        return doc

    def canonical_bytes(self) -> bytes:
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode()

    @property
    def plan_hash(self) -> str:
        return hashlib.sha256(self.canonical_bytes()).hexdigest()[:16]

    @staticmethod
    def from_json(doc: dict) -> "CollectivePlan":
        return CollectivePlan(
            wire=doc["wire"],
            axes=tuple((str(a), int(n)) for a, n in doc["axes"]),
            entries={k: PlanEntry.from_dict(v)
                     for k, v in doc.get("entries", {}).items()},
            version=int(doc.get("version", PLAN_VERSION)),
            backend=doc.get("backend"),
        )


def live_axes(group) -> tuple:
    """The (axis, size) pairs of ``group``'s axes that move bytes (size
    > 1), outer first in the group's own order (a sub-mesh's, such as
    the dense sync's ``("dp", "sp", "ep")``): the plan's ``axes``. A
    group object without an ``axis_order`` has the ``(dp, sp)`` mesh."""
    order = getattr(group, "axis_order", ("dp", "sp"))
    return tuple((a, group.axis_size(a)) for a in order
                 if group.axis_size(a) > 1)


def feasible_arms(wire: str, live_sizes: Sequence[int], rows: int,
                  num_windows: int = 4) -> list:
    """The arms a (wire, group, shape) cell may run: what
    ``parallel/dp.py`` dispatches, so no arm is measured that the sync
    could not run. ``live_sizes``: the >1 axis sizes, outer first."""
    two_axis_quant = len(live_sizes) == 2 and wire in ("int8", "ef8")
    # the quantized two-phase does not span two axes: on that geometry
    # the ef8 hierarchical hybrid is the only arm
    arms = [] if two_axis_quant else ["fused"]
    if len(live_sizes) == 1:
        n = live_sizes[0]
        w = min(int(num_windows), int(rows))
        if w > 1:
            arms.append(f"windowed:{w}")
        if n & (n - 1) == 0:
            arms.append("swing")
    elif len(live_sizes) == 2 and wire == "ef8":
        arms.append("hierarchical")
    return arms


def _gather_json(group, obj) -> list:
    """Every rank's JSON-able ``obj``, in rank order (one all-gather of
    the lengths, one of the padded UTF-8 bytes)."""
    if group.world == 1:
        return [obj]
    data = torch.tensor(list(json.dumps(obj).encode()), dtype=torch.uint8)
    lens = group.all_gather(torch.tensor([data.numel()],
                                         device=group.device)).cpu()
    buf = torch.zeros((1, int(lens.max())), dtype=torch.uint8)
    buf[0, :data.numel()] = data
    got = group.all_gather(buf.to(group.device)).cpu()
    return [json.loads(bytes(got[r, :int(lens[r])].tolist()).decode())
            for r in range(group.world)]


def _sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class RoundTiming:
    """A two-point round time: ``seconds`` a round (the median-of-reps
    delta between the sets of ``rounds_hi`` and ``rounds_lo`` rounds),
    and each set's ``reps`` host-clock times."""

    seconds: float
    rounds_hi: int
    rounds_lo: int
    hi: tuple
    lo: tuple

    @property
    def spread(self) -> float:
        """The range of the per-round times the reps allow (the slowest
        hi set against the fastest lo set, and the reverse), relative to
        ``seconds``: how far the sets resolve the round."""
        span = self.rounds_hi - self.rounds_lo
        worst = (max(self.hi) - min(self.lo)) / span
        best = (min(self.hi) - max(self.lo)) / span
        return (worst - best) / self.seconds


def time_rounds(group, run: Callable, rounds_hi: int, rounds_lo: int,
                reps: int, what: str,
                set_seconds: Optional[float] = None) -> RoundTiming:
    """This rank's two-point round time of ``run(rounds, rep)`` (which
    runs ``rounds`` chained rounds and reads one value back; ``rep`` -1
    is the warm-up): a warm-up set of ``rounds_hi`` first, then each set
    timed on the host clock between device synchronisations after a
    barrier, the median of ``reps`` times. A delta that noise makes
    non-positive on any rank widens ``rounds_hi`` once to ``4
    rounds_hi`` on every rank (the decision all-gathered, so the ranks
    stay in step).

    ``set_seconds`` sizes the sets to the payload: when the warm-up took
    less than that on the slowest rank, ``rounds_hi`` becomes the rounds
    a warm set of that many seconds holds there, ``rounds_lo`` a quarter
    of them, so a small payload is timed over as long a set as a large
    one's."""
    dev = group.device

    def timed(rounds):
        ts = []
        for rep in range(reps):
            group.barrier()
            _sync_device(dev)
            t0 = time.perf_counter()
            run(rounds, rep)
            _sync_device(dev)
            ts.append(time.perf_counter() - t0)
        return ts

    def median(ts):
        return sorted(ts)[len(ts) // 2]

    def slowest(rounds):
        group.barrier()
        t0 = time.perf_counter()
        run(rounds, -1)
        _sync_device(dev)
        return max(_gather_json(group, time.perf_counter() - t0))

    took = slowest(rounds_hi)  # the warm-up
    if set_seconds is not None and took < set_seconds:
        took = slowest(rounds_hi)  # a warm set
        rounds_hi = max(rounds_hi, -(-int(set_seconds * rounds_hi * 1e6)
                                     // max(int(took * 1e6), 1)))
        rounds_lo = max(1, rounds_hi // 4)
    hi, lo = timed(rounds_hi), timed(rounds_lo)
    per_round = (median(hi) - median(lo)) / (rounds_hi - rounds_lo)
    if min(_gather_json(group, per_round)) <= 0:
        # noise swamped some rank's delta: every rank widens once
        rounds_hi = 4 * rounds_hi
        hi = timed(rounds_hi)
        per_round = (median(hi) - median(lo)) / (rounds_hi - rounds_lo)
    if per_round <= 0:
        raise RuntimeError(f"two-point timing failed twice for {what}: "
                           f"host too noisy for this cell")
    return RoundTiming(per_round, rounds_hi, rounds_lo, tuple(hi),
                       tuple(lo))


def cell_rounds(group, wire: str, arm: str, rows: int, cols: int,
                seed: int, plan=None) -> Callable:
    """``run(rounds, rep)`` for :func:`time_rounds`: ``allreduce_gradients``
    of one (arm, rows x cols) cell in a loop of rounds on ``group``, each
    round's input ``abs(previous mean) + 1e-12`` (no round can be skipped
    or folded), the ef8 residual carried from round to round, a fresh key
    a round. ``arm`` ``"auto"`` dispatches through ``plan``."""
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)

    schedule, windows = _arm_schedule(arm)
    cfg = GradSyncConfig(
        bucket_elems=cols, average=True, rescale_target=1.0,
        return_elem_counts=False, transport=wire,
        transport_schedule=schedule, num_windows=windows, plan=plan)
    quantized = wire in ("int8", "ef8")
    dev = group.device
    x0 = torch.zeros((rows * cols,), dtype=torch.float32, device=dev)

    def run(rounds, rep):
        x = x0 + float(max(rep, 0)) * 1e-3
        r = torch.zeros((rows, cols), dtype=torch.float32,
                        device=dev) if wire == "ef8" else None
        for i in range(rounds):
            res = allreduce_gradients(
                {"g": x.abs() + 1e-12}, cfg, group,
                quant_key=(seed, i) if quantized else None, residual=r)
            x, r = res.grads["g"], res.residual
        float(x[0])

    return run


def _default_measure_cell(group, wire: str, arm: str, rows: int, cols: int,
                          *, rounds_hi: int, rounds_lo: int, reps: int,
                          seed: int) -> float:
    """This rank's round time (seconds) of one (arm, shape) cell:
    :func:`time_rounds` of :func:`cell_rounds`."""
    return time_rounds(group, cell_rounds(group, wire, arm, rows, cols,
                                          seed),
                       rounds_hi, rounds_lo, reps,
                       f"arm {arm!r} at {rows}x{cols}").seconds


def measure_plan(group, shapes: Sequence, wire: str = "f32",
                 num_windows: int = 4,
                 rounds_hi: Optional[int] = None,
                 rounds_lo: Optional[int] = None,
                 reps: int = 3, seed: int = 11,
                 measure_cell: Optional[Callable] = None,
                 log: Optional[Callable] = None) -> CollectivePlan:
    """Measure every feasible arm per bucket-size class on ``group`` (a
    ``RankGroup``; every rank calls this with the same arguments) and
    return the :class:`CollectivePlan`, identical on every rank.

    ``shapes``: the ``(rows, cols)`` bucket-matrix classes the train
    step's syncs dispatch (``dense_bucket_count`` x ``bucket_elems``).
    ``measure_cell(arm, rows, cols) -> seconds`` replaces the timing
    harness (tests inject fixed values: the same measurements give a
    byte-identical plan). A cell that raises is recorded and the class
    falls back to the surviving arms, or to ``fused`` when none
    survived. ``rounds_hi`` defaults to 6, ``rounds_lo`` to
    ``rounds_hi // 4`` (at least 1)."""
    if rounds_hi is None:
        rounds_hi = 6
    if rounds_lo is None:
        rounds_lo = max(1, rounds_hi // 4)
    live = live_axes(group)
    live_sizes = [n for _, n in live]
    cell = measure_cell or partial(
        _default_measure_cell, group, wire, rounds_hi=rounds_hi,
        rounds_lo=rounds_lo, reps=reps, seed=seed)
    entries = {}
    for rows, cols in shapes:
        rows, cols = int(rows), int(cols)
        arms = feasible_arms(wire, live_sizes, rows, num_windows)
        mine: dict = {}
        for arm in arms:
            try:
                mine[arm] = float(cell(arm, rows, cols))
            except Exception as exc:  # noqa: BLE001 - the fallback is the
                # contract: a broken cell must not take the run down
                mine[arm] = f"{arm}: {type(exc).__name__}: {exc}"
        ranks = _gather_json(group, mine)
        timings: dict = {}
        notes: list = []
        for arm in arms:
            got = [r[arm] for r in ranks]
            errors = [g for g in got if isinstance(g, str)]
            if errors:
                notes.append(errors[0])  # the lowest failing rank's
                continue
            t = max(got)  # the slowest rank's
            timings[arm] = round(t * 1e6, 3)
            if log:
                log(f"autotune: {plan_key(rows, cols)} {arm} "
                    f"{t * 1e6:.1f} us/round")
        if timings:
            win = min(sorted(timings), key=lambda a: timings[a])
            schedule, windows = _arm_schedule(win)
            note = "; ".join(notes)
        else:
            schedule, windows = "fused", 1
            note = ("no feasible arm, hand-flag default" if not notes
                    else "all cells failed, hand-flag default: "
                    + "; ".join(notes))
        entries[plan_key(rows, cols)] = PlanEntry(
            schedule=schedule, num_windows=windows, timings_us=timings,
            note=note)
    return CollectivePlan(wire=wire, axes=live, entries=entries,
                          backend=getattr(group, "backend", None))


# -- sidecar persistence (runtime/checkpoint.py atomics) -------------------

def save_plan(directory: str, plan: CollectivePlan,
              name: str = PLAN_SIDECAR) -> str:
    """Atomic write-then-rename JSON sidecar (a crash mid-save leaves the
    previous complete plan, never a torn one)."""
    from akka_allreduce_tpu_torch.runtime.checkpoint import save_state_json
    return save_state_json(directory, name, plan.to_json())


def load_plan(directory: str,
              name: str = PLAN_SIDECAR) -> Optional[CollectivePlan]:
    from akka_allreduce_tpu_torch.runtime.checkpoint import load_state_json
    doc = load_state_json(directory, name)
    if doc is None:
        return None
    try:
        return CollectivePlan.from_json(doc)
    except (KeyError, TypeError, ValueError):
        return None  # a corrupt sidecar: the caller measures again


def load_or_measure(directory: Optional[str], group, shapes: Sequence,
                    wire: str = "f32", log: Optional[Callable] = None,
                    **measure_kw) -> tuple:
    """The restart contract: reload the sidecar instead of measuring
    when its fingerprint (version, wire, the group's live axes and rank
    transport, every requested class) matches on every rank and every
    rank read the same plan; otherwise measure and save again (rank 0
    writes). Returns
    ``(plan, reused)``. ``directory=None`` measures without saving."""
    live = live_axes(group)
    want = {plan_key(r, c) for r, c in shapes}
    if directory is not None:
        plan = load_plan(directory)
        ok = (plan is not None and plan.version == PLAN_VERSION
              and plan.wire == wire and tuple(plan.axes) == live
              and plan.backend == getattr(group, "backend", None)
              and want <= set(plan.entries))
        hashes = _gather_json(group, plan.plan_hash if ok else None)
        if hashes[0] is not None and len(set(hashes)) == 1:
            return plan, True
    plan = measure_plan(group, shapes, wire=wire, log=log, **measure_kw)
    if directory is not None and group.rank == 0:
        save_plan(directory, plan)
    return plan, False


# -- dispatch --------------------------------------------------------------

def resolve_schedule(plan: Optional[CollectivePlan], rows: int, cols: int,
                     live_sizes: Sequence[int], wire: str,
                     default_windows: int = 4) -> tuple:
    """``transport_schedule="auto"`` -> the (schedule, windows) this
    bucket matrix dispatches. Pure Python on the plan: a frozen plan
    resolves a class the same way on every call.

    A missing plan, a missing class, or a winner the live mesh cannot run
    (the group shrank, an axis folded) fall back to the hand-flag default
    ``("fused", default_windows)``, except on the (ef8, two >1 axes)
    geometry, where the quantized two-phase cannot dispatch and
    ``hierarchical`` is the flag an operator would have set."""
    n_live = len([n for n in live_sizes if n > 1])
    fallback = ("hierarchical" if wire == "ef8" and n_live == 2
                else "fused", default_windows)
    if plan is None:
        return fallback
    entry = plan.lookup(rows, cols)
    if entry is None:
        return fallback
    s = entry.schedule
    if s in ("windowed", "swing") and n_live != 1:
        return fallback
    if s == "swing":
        n = next(sz for sz in live_sizes if sz > 1)  # n_live == 1 here
        if n & (n - 1):
            return fallback
    if s == "hierarchical" and (n_live != 2 or wire != "ef8"):
        return fallback
    if s == "fused" and wire in ("int8", "ef8") and n_live == 2:
        return fallback  # the quantized two-phase cannot span two axes
    return s, (entry.num_windows if s == "windowed" else default_windows)


# -- operator surface ------------------------------------------------------

def plan_markdown_table(plan: CollectivePlan) -> str:
    """The crossover table of a measured plan: one row per bucket-size
    class, every arm's round time, the winner starred."""
    group = " x ".join(f"{a}={n}" for a, n in plan.axes) or "1 rank"
    arms: list = []
    for e in plan.entries.values():
        for a in e.timings_us:
            if a not in arms:
                arms.append(a)
    arms.sort(key=lambda a: ("fused", "windowed", "swing",
                             "hierarchical").index(_arm_schedule(a)[0]))
    lines = [
        f"| bucket class ({group}, wire {plan.wire}) | "
        + " | ".join(f"{a} (us/round)" for a in arms) + " | winner |",
        "|" + "---|" * (len(arms) + 2),
    ]

    def _k(item):
        r, c = item[0].split("x")
        return int(r) * int(c), item[0]
    for key, e in sorted(plan.entries.items(), key=_k):
        rows, cols = key.split("x")
        win = (e.schedule if e.schedule != "windowed"
               else f"windowed:{e.num_windows}")
        cells = [f"{e.timings_us[a]:.1f}" if a in e.timings_us else "—"
                 for a in arms]
        lines.append(f"| {rows} x {cols} | " + " | ".join(cells)
                     + f" | **{win}** |")
    return "\n".join(lines)


def _measure_rank(group, shapes, wire, out_dir):
    plan = measure_plan(group, shapes, wire=wire,
                        log=print if group.rank == 0 else None)
    if group.rank == 0:
        print(f"plan hash {plan.plan_hash} over {group.world} rank(s) "
              f"on {group.device}")
        print(plan_markdown_table(plan))
        print(json.dumps(plan.to_json(), indent=1))
        if out_dir:
            print("wrote", save_plan(out_dir, plan))
    return plan.plan_hash


def _main() -> int:
    """``python -m akka_allreduce_tpu_torch.ops.autotune`` — measure a
    plan on ``--ranks`` gloo rank processes (sharing the card, or on the
    CPU with ``--device cpu``) and print its table and JSON."""
    import argparse

    from akka_allreduce_tpu_torch.device import resolve_device
    # the rank function by its module's name (``-m`` runs this file as
    # ``__main__``, which a spawned rank cannot import by name)
    from akka_allreduce_tpu_torch.ops.autotune import _measure_rank
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--wire", default="f32",
                    choices=("f32", "bf16", "int8", "ef8"))
    ap.add_argument("--shapes", default="8x40960,8x327680,8x1310720,"
                                        "8x3145728",
                    help="comma list of ROWSxCOLS bucket classes")
    ap.add_argument("--ranks", type=int, default=2,
                    help="gloo rank processes, one data axis")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the ranks share the card) or cpu")
    ap.add_argument("--out-dir", default=None,
                    help="persist the sidecar here (atomic)")
    args = ap.parse_args()
    shapes = [tuple(map(int, s.split("x")))
              for s in args.shapes.split(",")]
    device = resolve_device(args.device).type
    spawn_ranks(_measure_rank, args.ranks, "gloo", device, shapes,
                args.wire, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
