"""The ``ipc`` transport under CUDA graph replays, on the CPU.

A chunk of train steps captured into one CUDA graph replays its
transport calls with the targets of the capture (``transport.capture``).
Before each replay every rank drains, meets the others, writes its
buffers' ``ready`` / ``consumed`` back to their values at the capture
(``transport.rewind``) and meets them again (``RankGroup.replay_boundary``).
``transport.emulate_replays`` runs that sequence on numpy bytes: a warm-up
of eager calls, then R replays of one captured plan, each with new
inputs. Pins:

* with the rewind, every replay at n = 2 and 4, under seeded
  interleavings of the ranks' ops, is bitwise what gloo CPU ranks give
  for the same calls run eagerly, and no half is overwritten before its
  receiver copied it out;
* without the rewind (the control) the second replay's waits are already
  met: a half is overwritten or pulled before its push (AssertionError),
  or an output is wrong;
* a replay must make the captured calls (a graph's buffers are fixed);
* ``transport.capture``'s bookkeeping: the host mirrors go back to their
  values at the capture's start, and the counts lose what the capture
  added and record it as one replay's worth.
"""

import numpy as np
import pytest

import torch_transport_ranks as tr
from akka_allreduce_tpu_torch.ops.kernels import transport as T
from akka_allreduce_tpu_torch.parallel.group import spawn_ranks

CHUNK = 40  # bytes: every payload takes 2-3 chunks, the last ragged
REPLAYS = 3


def world_cases(n: int, seed: int) -> list:
    """Every collective in every dtype over the whole group of ``n``, the
    inputs drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return tr.make_cases(n, 1, tr.SHAPES, lambda dtype, shape: [
        tr.payload(rng, dtype, shape) for _ in range(n)])


def as_calls(cases: list) -> list:
    """The cases as ``transport.emulate`` takes them (the transport moves
    bytes: bfloat16 rides as its uint16 bit patterns)."""
    return [(kind, list(xs), kw) for _, kind, _, xs, kw in cases]


_GLOO: dict = {}


def gloo_run(n: int) -> "tuple[list, list, list]":
    """The warm-up cases, each replay's cases and the gloo ranks' bytes
    of all of them run eagerly in that order (one spawn per n)."""
    if n not in _GLOO:
        warm = world_cases(n, 100 + n)
        replays = [world_cases(n, 200 + 10 * n + r) for r in range(REPLAYS)]
        flat = warm + [c for cases in replays for c in cases]
        gloo = spawn_ranks(tr.run_cases, n, "gloo", "cpu", flat)
        _GLOO[n] = warm, replays, gloo
    return _GLOO[n]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_replays_with_the_rewind_are_bitwise_gloo(n, seed):
    warm, replays, gloo = gloo_run(n)
    got_warm, got = T.emulate_replays([as_calls(c) for c in replays], n,
                                      CHUNK, seed=seed,
                                      warmup=as_calls(warm))
    emulated = got_warm + [outs for replay in got for outs in replay]
    assert len(emulated) == len(gloo[0])
    for i, per_rank in enumerate(emulated):
        for r in range(n):
            assert np.array_equal(per_rank[r].reshape(-1).view(np.uint8),
                                  gloo[r][i]), (i, r)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_replays_without_the_rewind_fail(n, seed):
    warm, replays, gloo = gloo_run(n)
    try:
        got_warm, got = T.emulate_replays(
            [as_calls(c) for c in replays], n, CHUNK, seed=seed,
            warmup=as_calls(warm), rewind=False)
    except AssertionError:
        return
    emulated = got_warm + [outs for replay in got for outs in replay]
    assert any(not np.array_equal(per_rank[r].reshape(-1).view(np.uint8),
                                  gloo[r][i])
               for i, per_rank in enumerate(emulated) for r in range(n))


def test_a_replay_makes_the_captured_calls():
    calls = as_calls(world_cases(2, 1))
    with pytest.raises(ValueError, match="other calls than the captured"):
        T.emulate_replays([calls, calls[:-1]], 2, CHUNK)


class _Bufs:
    line, rank, done, calls = (0, 1), 0, None, 0


def test_capture_restores_the_mirrors_and_moves_the_counts(monkeypatch):
    """A capture enqueues nothing on the device: after it the host
    mirrors are back at the capture's start and the counts lose what
    the calls inside it added; ``per_replay`` keeps that for each
    replay."""
    rec = T._Line(_Bufs(), CHUNK, {0: 5, 1: 7}, {0: 0, 1: 9})
    monkeypatch.setattr(T, "_LINES", {(0, 1): rec})
    T.reset_counts()
    T.TRANSPORT_LAUNCHES = 4
    with T.capture() as cap:
        assert T._WATCH["paused"]
        rec.sent[1] += 3
        rec.received[1] += 2
        T.TRANSPORT_LAUNCHES += 10
        T._COUNTS["calls"] += 2
        cap.calls[(0, 1)] = 2
    assert not T._WATCH["paused"]
    assert rec.sent == {0: 5, 1: 7} and rec.received == {0: 0, 1: 9}
    assert cap.base[(0, 1)] == ({0: 5, 1: 7}, {0: 0, 1: 9})
    assert cap.end[(0, 1)] == ({0: 5, 1: 10}, {0: 0, 1: 11})
    assert T.TRANSPORT_LAUNCHES == 4 and T._COUNTS["calls"] == 0
    assert cap.per_replay["transport_launches"] == 10
    assert cap.per_replay["transport_calls"] == 2
    assert cap.stream_waits == 0
    T.reset_counts()
