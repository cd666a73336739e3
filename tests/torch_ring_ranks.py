"""Rank-side helpers of the port's ring and swing allreduce tests.

Spawned ranks import this module by name, so it imports no JAX. A rank
receives every rank's input as one ``(world, elems)`` numpy array and
takes the row of its global rank.
"""

import time

import numpy as np
import torch

from akka_allreduce_tpu_torch.ops.kernels import ring

KERNEL = {"ring": ring.peer_ring_allreduce,
          "swing": ring.peer_swing_allreduce}
PLAIN = {"ring": ring.ring_allreduce_reference,
         "swing": ring.swing_allreduce_reference}


def allreduce_loop(group, cases: list) -> dict:
    """Per case ``(schedule, axis, x, steps)``: this rank's sum at each
    step of a loop whose next input is ``carry + sum / n`` (the JAX
    tests' ``lax.scan`` loop), as a ``(steps, elems)`` array; and the
    kernels' launch counts after every case."""
    sums = []
    for schedule, axis, x, steps in cases:
        n = group.axis_size(axis)
        carry = torch.from_numpy(x[group.rank].copy()).to(group.device)
        got = []
        for _ in range(steps):
            total = KERNEL[schedule](carry, group, axis)
            got.append(total.cpu().numpy())
            carry = carry + total / n
        sums.append(np.stack(got))
    return {"sums": sums, "launches": ring.counts()}


def kernel_vs_plain(group, schedule: str, elems: int, steps: int) -> dict:
    """On the card: per step of the loop above (inputs from a generator
    seeded by the rank), whether the kernel's sum is bitwise its plain
    version's; the launches; and a checksum of the last sum."""
    n = group.axis_size("dp")
    gen = torch.Generator(group.device).manual_seed(group.rank)
    carry = torch.randn(elems, generator=gen, device=group.device)
    ring.reset_counts()
    same = []
    for _ in range(steps):
        got = KERNEL[schedule](carry, group)
        ring.wait(group)
        want = PLAIN[schedule](carry, group)
        same.append(bool(torch.equal(got, want)))
        carry = carry + got / n
    return {"bitwise": same, "launches": ring.counts(),
            "checksum": int(got.view(torch.int32).sum())}


def _timed_wait(group, timeout: float) -> "tuple[str | None, float]":
    t0 = time.monotonic()
    try:
        ring.wait(group, timeout=timeout)
    except RuntimeError as e:
        return str(e), time.monotonic() - t0
    return None, time.monotonic() - t0


def stalled_call(group, elems: int, timeout: float, peer: str) -> dict:
    """On the card, two ranks: both make ring call 1; rank 0 makes call
    2 and rank 1 does not, until rank 0's ``ring.wait(timeout=...)`` has
    raised (a barrier on the host wire). Then rank 1 either returns
    without making it (``peer="stops"``: its process ends while rank 0's
    runs on) or makes it late (``"late"``), when rank 0 has abandoned
    the call, so rank 1's own wait raises too. Each rank reports its
    wait's error and seconds, how long a device synchronise took after
    it, and the error of a further call on the abandoned buffer."""
    gen = torch.Generator(group.device).manual_seed(group.rank)
    x = torch.randn(elems, generator=gen, device=group.device)
    KERNEL["ring"](x, group)
    ring.wait(group)
    out = {"error": None, "seconds": None, "sync_seconds": None,
           "next_call_error": None}
    if group.rank == 0:
        KERNEL["ring"](x, group)
        out["error"], out["seconds"] = _timed_wait(group, timeout)
        group.barrier()
    else:
        group.barrier()
        if peer == "stops":
            return out
        KERNEL["ring"](x, group)
        out["error"], out["seconds"] = _timed_wait(group, timeout)
    t0 = time.monotonic()
    torch.cuda.synchronize()
    out["sync_seconds"] = time.monotonic() - t0
    if out["error"] is not None:
        try:
            KERNEL["ring"](x, group)
        except RuntimeError as e:
            out["next_call_error"] = str(e)
    if peer == "late":
        group.barrier()  # rank 0's buffer outlives rank 1's late call
    return out
