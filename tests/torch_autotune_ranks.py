"""Rank-side helpers of the port's autotuner tests.

Spawned ranks import this module by name, so it imports no JAX.
"""

import torch

from akka_allreduce_tpu_torch.ops.autotune import (load_or_measure,
                                                   measure_plan)
from akka_allreduce_tpu_torch.parallel.dp import (GradSyncConfig,
                                                  allreduce_gradients)


def skewed_plan(group, shapes: list, timings: dict) -> bytes:
    """A plan measured with ``timings`` (arm -> seconds) scaled by
    (rank + 1) on this rank, the swing arm raising on rank 1: every
    rank must still return the same canonical bytes."""
    def cell(arm, rows, cols):
        if arm == "swing" and group.rank == 1:
            raise RuntimeError("swing broke on rank 1")
        return timings[arm] * (group.rank + 1)
    return measure_plan(group, shapes, wire="f32",
                        measure_cell=cell).canonical_bytes()


def measured_plan(group, directory, shapes: list, wire: str) -> tuple:
    """``load_or_measure`` with the default timing harness, cut short."""
    plan, reused = load_or_measure(directory, group, shapes, wire=wire,
                                   rounds_hi=2, rounds_lo=1, reps=1)
    return plan.canonical_bytes(), reused


def dispatch_rounds(group, grads: list, cases: list,
                    rounds: int = 3) -> list:
    """Per case ``(schedule, plan, num_windows)``, ``rounds`` syncs of
    this rank's tree of ``grads`` (numpy) on ``schedule`` (with ``plan``
    for "auto"): per round the synced tree and the schedule that ran."""
    mine = {k: torch.from_numpy(v) for k, v in grads[group.rank].items()}
    out = []
    for schedule, plan, num_windows in cases:
        cfg = GradSyncConfig(bucket_elems=256, transport_schedule=schedule,
                             num_windows=num_windows, plan=plan,
                             return_elem_counts=False)
        runs = []
        for _ in range(rounds):
            res = allreduce_gradients(mine, cfg, group)
            runs.append((res.grads, res.schedule))
        out.append(runs)
    return out
