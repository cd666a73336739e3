"""Rank-side helper of the port's hierarchical tests.

Spawned ranks import this module by name, so it imports no JAX.
"""

from akka_allreduce_tpu_torch.ops.collectives import (swing_allreduce,
                                                      two_phase_allreduce)


def line_sums(x, group) -> dict:
    """Per mesh axis, the two-phase and the swing sum of ``x`` over this
    rank's line along it (``RankGroup.along``), and the line's size and
    this rank's coordinate on it."""
    out = {}
    for axis in ("dp", "sp"):
        line = group.along(axis)
        out[axis] = (two_phase_allreduce(x, line), swing_allreduce(x, line),
                     line.world, line.rank)
    return out
