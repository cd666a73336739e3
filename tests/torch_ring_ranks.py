"""Rank-side helpers of the port's ring and swing allreduce tests.

Spawned ranks import this module by name, so it imports no JAX. A rank
receives every rank's input as one ``(world, elems)`` numpy array and
takes the row of its global rank.
"""

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
        want = PLAIN[schedule](carry, group)
        same.append(bool(torch.equal(got, want)))
        carry = carry + got / n
    return {"bitwise": same, "launches": ring.counts(),
            "checksum": int(got.view(torch.int32).sum())}
