"""Gradient-sync benchmark rows: the port's first two, under the JAX names.

Counterpart of two functions of ``akka_allreduce_tpu/bench.py``:

* :func:`measure_device_goodput` — payload GB/s of the full sync path
  (bucketize, the wire, the rescale, debucketize), optionally lossy;
* :func:`measure_quantized_collectives` — the fused f32 sum against the
  swing schedule, the ef8 wire, ``auto`` (a plan built from this run's
  measured f32 arms) and ``hierarchical``, per payload class, with the
  ``quantized_collectives_{arm}_speedup_*`` claim rows.

Each is a generator of JSON-able rows (``metric``, ``value``, ``unit``,
``note``; ``error`` instead of a value when an arm could not run). The
ranks are ``spawn_ranks`` processes that share one card (or run on the
CPU) under ``backend``: on ``ipc`` the payloads move device to device
through CUDA IPC peer memory on the card, on ``gloo`` through host
memory; neither is NVLink between cards, so the rows price the sync as
the port runs it on one card, not a cluster's fabric. The backend
defaults to ``ipc`` on the card and ``gloo`` on the CPU.

Methodology, as the JAX package's, through the autotuner's harness
(``ops/autotune.py`` :func:`time_rounds`): every round's input is a
function of the previous round's output (the sync's mean through
``abs``, or a fresh draw plus ``1e-30`` of it), so no round can be
skipped; a set of rounds is timed on the host clock between device
synchronisations, after a barrier, with a warm-up set first; the
per-round time is the two-point delta between the medians of ``reps``
sets of ``r_hi`` and ``r_lo`` rounds, widened once to ``4 r_hi`` when
noise makes it non-positive. ``set_seconds`` sizes the sets to the
payload instead (``r_hi`` the rounds a set of that many seconds holds,
``r_lo`` a quarter), so a small payload is not timed over a few
milliseconds of host-clock noise. Each rank times itself; the ranks
all-gather their times and every rank takes the slowest rank's (the
collective's time). Every row carries its ``rounds`` and its
``spread``: the range of round times its reps allow, relative to the
value (a claim row: the sum of its two arms').

The hierarchical arm runs on a 2 x (n/2) ``(dp, sp)`` group where the
JAX package's uses ``(dp, ep)``: the port's mesh has no ``ep`` axis, and
``sp`` is its inner (ICI) axis. The rest of the JAX ``bench.py`` and its
``cli bench`` are not ported yet (ROADMAP.md A10).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from akka_allreduce_tpu_torch.ops.autotune import (CollectivePlan, PlanEntry,
                                                   RoundTiming, _gather_json,
                                                   cell_rounds, plan_key,
                                                   time_rounds)

ELEMS = 25_000_000        # 25M float32 = 100 MB
BUCKET_ELEMS = 3_125_000  # 8 buckets, exact fit
R_HI, R_LO = 200, 50
# the reference's netty-TCP 10GbE wire ceiling: the vs_baseline
# denominator where no HBM roofline applies (the CPU)
REFERENCE_TRANSPORT_CEILING_GBPS = 1.25
# HBM peak of the card, by torch.cuda.get_device_name (NVIDIA data sheet)
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
# four bucket-size classes from the latency-bound small end to the
# ResNet-50-sized bandwidth end: the range over which the winners flip
BUCKET_ELEMS_ALIGNED = 3_276_800
QUANTIZED_AB_PAYLOADS = ((250_000, 32_768),
                         (1_000_000, 131_072),
                         (2_500_000, 327_680),
                         (25_000_000, BUCKET_ELEMS_ALIGNED))
ARM_NOTES = {
    "fused": "fused f32 sum (the baseline)",
    "swing": "swing ±2^t exchange schedule, f32 payload, log2(n) hops",
    "ef8": "block-quantized int8 + error feedback (residual carried "
           "round to round, fresh key per round), fused two-phase",
    "auto": "autotuned dispatch: CollectivePlan built from this run's "
            "measured f32 arms, resolved before dispatch "
            "(ops/autotune.py)",
    "hierarchical": "ICI x DCN hybrid on a 2 x (n/2) (dp, sp) group: "
                    "exact rs/ag over sp, ef8 exchange + error feedback "
                    "over dp (the JAX package's (dp, ep) mesh)",
}


def _backend(backend: Optional[str], device: str) -> str:
    return backend or ("ipc" if device == "cuda" else "gloo")


def _wire_note(backend: str, n: int, name: str) -> str:
    return (f"{n} {backend} ranks on {name}, "
            + ("device-to-device wire (CUDA IPC peer memory)"
               if backend == "ipc" else "host-memory wire"))


def _label(device: str) -> str:
    return "gpu" if device == "cuda" else device


def _slowest(group, timing: RoundTiming) -> RoundTiming:
    """The slowest rank's timing, the same on every rank."""
    got = _gather_json(group, dataclasses.asdict(timing))
    return RoundTiming(**max(got, key=lambda t: t["seconds"]))


# -- the goodput row -------------------------------------------------------

def _goodput_rank(group, elems: int, bucket: int, r_hi: int, r_lo: int,
                  valid_fraction: float, reps: int, transport: str,
                  schedule: str, num_windows: int,
                  set_seconds: Optional[float]) -> dict:
    from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                      allreduce_gradients)
    dev = group.device
    n = group.world
    num_buckets = -(-elems // bucket)
    lossy = valid_fraction < 1.0
    cfg = GradSyncConfig(bucket_elems=bucket, average=True,
                         rescale_target=float(n) if lossy else 1.0,
                         return_elem_counts=False, transport=transport,
                         transport_schedule=schedule,
                         num_windows=num_windows)
    valid = None
    if lossy:
        # staggered per rank, so per-bucket counts land strictly between
        # 1 and n: the partial-count rescale regime
        n_valid = max(1, int(round(valid_fraction * num_buckets)))
        base = torch.zeros((num_buckets,), device=dev)
        base[:n_valid] = 1.0
        valid = torch.roll(base, group.rank)

    def run(rounds, rep):
        gen = torch.Generator(dev).manual_seed(1000 * (rep + 1) + group.rank)
        carry = torch.zeros((elems,), device=dev)
        for _ in range(rounds):
            # a fresh draw each round; the carry keeps the rounds chained
            x = torch.rand((elems,), generator=gen, device=dev)
            carry = allreduce_gradients(
                {"g": (x + carry * 1e-30).abs()}, cfg, group,
                valid=valid).grads["g"]
        float(carry[0])

    return dataclasses.asdict(_slowest(group, time_rounds(
        group, run, r_hi, r_lo, reps, "the goodput", set_seconds)))


def measure_device_goodput(elems: int = ELEMS,
                           bucket_elems: int = BUCKET_ELEMS,
                           r_hi: int = R_HI, r_lo: int = R_LO,
                           valid_fraction: float = 1.0, reps: int = 3,
                           transport: str = "f32",
                           transport_schedule: str = "fused",
                           num_windows: int = 1, ranks: int = 4,
                           device: str = "cuda",
                           set_seconds: Optional[float] = None,
                           backend: Optional[str] = None
                           ) -> Iterator[dict]:
    """Goodput (payload GB/s) of the full sync path on ``ranks`` rank
    processes on ``device`` (the card, unless ``"cpu"``) under
    ``backend`` (default ``ipc`` on the card, ``gloo`` on the CPU): yields the
    JAX package's ``allreduce_goodput_{M}M_{wire}_{n}{label}`` row, its
    value from the slowest rank's two-point round time (``set_seconds``:
    see the module docstring). ``valid_fraction < 1`` runs the lossy
    masked path (that fraction of buckets contributes per round, the
    result count-rescaled)."""
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    if transport not in ("f32", "bf16"):
        raise ValueError(f"measure_device_goodput supports transport "
                         f"f32|bf16, got {transport!r}")
    if not 0 < r_lo < r_hi:
        raise ValueError(f"need 0 < r_lo < r_hi, got {r_lo}/{r_hi}")
    dev = resolve_device(device)
    backend = _backend(backend, dev.type)
    stats = spawn_ranks(_goodput_rank, ranks, backend, dev.type, elems,
                        bucket_elems, r_hi, r_lo, valid_fraction, reps,
                        transport, transport_schedule, num_windows,
                        set_seconds)[0]
    timing = RoundTiming(**stats)
    gbps = elems * 4 / timing.seconds / 1e9
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    hbm = HBM_PEAK_GBPS.get(name)
    if hbm:
        vs = round(gbps / hbm, 3)
        frame = (f"vs_baseline = fraction of the {name} HBM peak "
                 f"({hbm:g} GB/s)")
    else:
        vs = round(gbps / REFERENCE_TRANSPORT_CEILING_GBPS, 2)
        frame = ("vs_baseline = value / 1.25 GB/s, the reference's "
                 "netty-TCP 10GbE wire ceiling (no HBM peak applies)")
    wire = "f32" if ranks == 1 else transport
    yield {
        "metric": f"allreduce_goodput_{elems / 1e6:g}M_{wire}_{ranks}"
                  f"{_label(dev.type)}",
        "value": round(gbps, 2), "unit": "GB/s", "vs_baseline": vs,
        "rounds": [timing.rounds_lo, timing.rounds_hi],
        "spread": round(timing.spread, 3),
        "note": (f"two-point delta of the medians of {reps} sets of "
                 f"{timing.rounds_lo} / {timing.rounds_hi} rounds, "
                 f"{timing.seconds * 1e3:.3f} ms a round; "
                 f"{_wire_note(backend, ranks, name)}; full "
                 f"sync path (bucketize->{transport_schedule} "
                 f"{transport}->rescale->debucketize); {frame}")}


# -- the transport A/B -----------------------------------------------------

def _arm_timing(group, arm: str, elems: int, bucket: int, r_hi: int,
                r_lo: int, reps: int, set_seconds: Optional[float],
                plan=None) -> RoundTiming:
    """The slowest rank's round time of one arm on ``group`` (the flat
    group, or the (dp, sp) group for hierarchical): the autotuner's
    cell, its wire ef8 for the ef8 and hierarchical arms."""
    wire = "ef8" if arm in ("ef8", "hierarchical") else "f32"
    run = cell_rounds(group, wire, "fused" if arm == "ef8" else arm,
                      -(-elems // bucket), bucket, seed=11, plan=plan)
    return _slowest(group, time_rounds(group, run, r_hi, r_lo, reps, arm,
                                       set_seconds))


def _quantized_rank(group, payloads, r_hi: int, r_lo: int, reps: int,
                    label: str, set_seconds: Optional[float]) -> list:
    """Every row of :func:`measure_quantized_collectives` on this rank
    (rank 0's are the ones reported; every rank computes the same)."""
    n = group.world
    flat = dataclasses.replace(group, sp=1)  # the world as one axis
    pow2 = n & (n - 1) == 0
    hier_ok = n >= 4 and n % 2 == 0 and group.sp == n // 2
    device_name = (torch.cuda.get_device_name(group.device)
                   if group.device.type == "cuda" else "cpu")
    ident = (f"; {_wire_note(group.backend, n, device_name)}"
             + ("; 1 rank: schedule identity — every arm IS the fused "
                "path, deltas are jitter" if n == 1 else ""))
    rows = []
    for elems, bucket in payloads:
        mega = f"{elems / 1e6:g}"
        nb = -(-elems // bucket)
        base = None
        f32_times: dict = {}  # arm -> us/round, the auto plan's input
        for arm in ("fused", "swing", "ef8", "auto", "hierarchical"):
            metric = f"quantized_collectives_{arm}_{mega}M_{n}{label}"
            if arm == "swing" and not pow2:
                rows.append({"metric": metric, "value": 0.0, "unit": "GB/s",
                             "error": f"swing needs a power-of-two group, "
                                      f"got {n} ranks"})
                continue
            if arm == "hierarchical" and not hier_ok:
                rows.append({"metric": metric, "value": 0.0, "unit": "GB/s",
                             "error": f"hierarchical needs an even group "
                                      f"of >= 4 ranks as a 2 x (n/2) "
                                      f"mesh, got {n} ranks, sp "
                                      f"{group.sp}"})
                continue
            plan = None
            if arm == "auto":
                if not f32_times:
                    rows.append({"metric": metric, "value": 0.0,
                                 "unit": "GB/s",
                                 "error": "no f32 arm survived to build "
                                          "the plan from"})
                    continue
                win = min(f32_times, key=f32_times.get)
                plan = CollectivePlan(
                    wire="f32", backend=group.backend,
                    axes=(("dp", n),) if n > 1 else (),
                    entries={plan_key(nb, bucket): PlanEntry(
                        schedule=win, num_windows=1,
                        timings_us={a: round(t, 3)
                                    for a, t in f32_times.items()})})
            try:
                timing = _arm_timing(
                    group if arm == "hierarchical" else flat, arm, elems,
                    bucket, r_hi, r_lo, reps, set_seconds, plan=plan)
            except Exception as e:  # noqa: BLE001 - bank the row, move on
                rows.append({"metric": metric, "value": 0.0, "unit": "GB/s",
                             "error": f"{type(e).__name__}: {e}"})
                continue
            g = elems * 4 / timing.seconds / 1e9
            note = f"{ARM_NOTES[arm]}, buckets of {bucket}" + ident
            if arm == "auto":
                note += f"; plan winner {win}, hash {plan.plan_hash}"
            rows.append({"metric": metric, "value": round(g, 3),
                         "unit": "GB/s",
                         "rounds": [timing.rounds_lo, timing.rounds_hi],
                         "spread": round(timing.spread, 3), "note": note})
            if arm in ("fused", "swing"):
                f32_times[arm] = timing.seconds * 1e6  # us/round
            if arm == "fused":
                base, base_spread = g, timing.spread
            elif base:
                # the claim rows: each transport's goodput as a fraction
                # of the fused sum on the same card in the same run
                rows.append({
                    "metric": f"quantized_collectives_{arm}_speedup_{mega}M",
                    "value": round(g / base, 3), "unit": "x",
                    "spread": round(timing.spread + base_spread, 3),
                    "note": f"{arm} vs fused sum at {mega}M floats "
                            f"({n}{label}){ident}"})
    return rows


def measure_quantized_collectives(payloads=QUANTIZED_AB_PAYLOADS,
                                  r_hi: Optional[int] = None,
                                  r_lo: Optional[int] = None,
                                  reps: Optional[int] = None,
                                  ranks: int = 4,
                                  device: str = "cuda",
                                  set_seconds: Optional[float] = None,
                                  backend: Optional[str] = None
                                  ) -> Iterator[dict]:
    """The gradient-sync transport A/B over ``payloads`` (``(elems,
    bucket_elems)`` classes) on ``ranks`` rank processes on ``device``
    under ``backend`` (as :func:`measure_device_goodput`): per payload
    the fused f32 sum (the baseline), swing, the ef8 wire, ``auto`` (a
    plan from this run's fused and swing times: its goodput must track
    the winning fixed arm) and ``hierarchical`` (a 2 x (n/2) ``(dp,
    sp)`` group), one row each, then a
    ``quantized_collectives_{arm}_speedup_{M}M`` claim row per arm. One
    spawn runs them all; the rows are yielded when it returns.
    ``set_seconds``: see the module docstring. Defaults: ``r_hi`` 6,
    ``r_lo`` ``r_hi // 4`` (at least 1), ``reps`` 2 (the JAX package's
    off the TPU)."""
    from akka_allreduce_tpu_torch.device import resolve_device
    from akka_allreduce_tpu_torch.parallel.group import spawn_ranks
    if r_hi is None:
        r_hi = 6
    if r_lo is None:
        r_lo = max(1, r_hi // 4)
    if reps is None:
        reps = 2
    dev = resolve_device(device)
    sp = ranks // 2 if ranks >= 4 and ranks % 2 == 0 else 1
    rows = spawn_ranks(_quantized_rank, ranks, _backend(backend, dev.type),
                       dev.type,
                       tuple(payloads), r_hi, r_lo, reps, _label(dev.type),
                       set_seconds, sp=sp)[0]
    yield from rows
