"""The port's protocol staging buffers against the JAX host plane's.

Every scenario of ``tests/test_buffers_scattered.py`` and
``tests/test_buffers_reduced.py`` (the ports of the reference's
ScatteredDataBufferSpec and ReducedDataBufferSpec) runs twice from the
same seeded inputs: on the JAX package's numpy buffers and on the port's
buffers on the CPU (``device="cpu"``: the chunk reduce takes the masked
reduce's plain version, on a strided slab of the staging row). Each run
keeps the scenario's own assertions; then everything the two runs read
back — reduced chunks, counts, gates, reassembled outputs and element
counts — must agree bitwise, dtypes included. The ``==`` gates fire
exactly once, an overrunning chunk raises ``IndexError`` before any
copy with the count not bumped, and missing chunks read as zeros with
count 0, on both sides.

``buffer_state_from_numpy`` (convert.py) carries a JAX buffer's
mid-round state into a port buffer that then goes on bitwise as the JAX
buffer does.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu import buffers as jax_buffers
from akka_allreduce_tpu_torch import buffers as port_buffers
from akka_allreduce_tpu_torch.buffers import base as port_base
from akka_allreduce_tpu_torch.convert import buffer_state_from_numpy


class Side:
    """One engine's buffer classes, with the scenario's inputs made the
    way that engine takes them (numpy for JAX, CPU tensors for the port)
    and everything read back turned into numpy for the log."""

    def __init__(self, name: str, seed: int):
        self.name = name
        self.rng = np.random.default_rng(seed)
        self.log: list = []
        if name == "jax":
            self.Scattered = jax_buffers.ScatteredDataBuffer
            self.Reduced = jax_buffers.ReducedDataBuffer
            self.kw = {}
        else:
            self.Scattered = port_buffers.ScatteredDataBuffer
            self.Reduced = port_buffers.ReducedDataBuffer
            self.kw = {"device": "cpu"}

    def scattered(self, *args):
        return self.Scattered(*args, **self.kw)

    def reduced(self, *args):
        return self.Reduced(*args, **self.kw)

    def arr(self, a) -> "np.ndarray | torch.Tensor":
        a = np.asarray(a, dtype=np.float32)
        return a if self.name == "jax" else torch.from_numpy(a.copy())

    def random_floats(self, n):
        return self.arr(self.rng.random(n, dtype=np.float32))

    def rec(self, x):
        """Log a value read back (numpy for both sides) and return it."""
        if isinstance(x, tuple):
            return tuple(self.rec(v) for v in x)
        if isinstance(x, torch.Tensor):
            x = x.numpy()
        if isinstance(x, np.ndarray):
            x = x.copy()
        self.log.append(x)
        return x


def assert_same_log(a: list, b: list) -> None:
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), (i, x, y)
            assert x.dtype == y.dtype and x.shape == y.shape, (i, x, y)
            assert x.tobytes() == y.tobytes(), (i, x, y)
        else:
            assert type(x) is type(y) and x == y, (i, x, y)


def both(scenario, seed=0):
    """Run ``scenario(side)`` on the JAX buffers, then on the port's, from
    the same seed; their logs must be bitwise equal."""
    logs = []
    for name in ("jax", "port"):
        side = Side(name, seed)
        scenario(side)
        logs.append(side.log)
    assert logs[0], "the scenario logged nothing"
    assert_same_log(*logs)


# -- ScatteredDataBufferSpec (tests/test_buffers_scattered.py) -------------

def scattered_behavior_story(s):
    buf = s.scattered(5, 4, 4, 0.75, 3)
    row = 1
    assert tuple(buf.temporal_buffer.shape) == (4, 4, 5)
    last_chunk = buf.num_chunks - 1
    before = s.rec(buf.temporal_buffer[1] + 0)
    with pytest.raises(IndexError):
        buf.store(s.random_floats(3), row, 0, last_chunk)
    assert s.rec(buf.count(row, last_chunk)) == 0
    s.rec(buf.temporal_buffer[1] + 0)  # no copy was made
    assert_same_log([before], [s.log[-1]])
    excess = buf.num_chunks * 3 - 5
    buf.store(s.random_floats(3 - excess), row, 0, last_chunk)
    assert s.rec(buf.count(row, last_chunk)) == 1
    expected = [False, False, True]
    for i in range(3):
        buf.store(s.random_floats(3), row, src_id=i, chunk_id=0)
        assert s.rec(buf.reach_reducing_threshold(row, 0)) is expected[i]
    empty_reduced, empty_count = s.rec(buf.reduce(0, 0))
    assert empty_count == 0 and empty_reduced.sum() == 0
    reduced, counts = s.rec(buf.reduce(row, 0))
    assert counts == 3
    # a fourth arrival is absorbed: the == gate does not fire again
    buf.store(s.random_floats(3), row, src_id=3, chunk_id=0)
    assert s.rec(buf.reach_reducing_threshold(row, 0)) is False
    s.rec(buf.reduce(row, 0))
    s.rec(buf.reduce(row, last_chunk))


def scattered_summation_story(s):
    buf = s.scattered(2, 2, 2, 1.0, 3)
    for i in range(2):
        buf.store(s.arr(np.full(2, float(i))), row=0, src_id=i, chunk_id=0)
        _, count = s.rec(buf.reduce(0, 0))
        assert count == i + 1
    reduced, _ = s.rec(buf.reduce(0, 0))
    np.testing.assert_array_equal(reduced, np.full(2, 1.0, dtype=np.float32))
    init_array, count_zero = s.rec(buf.reduce(1, 0))
    assert count_zero == 0
    np.testing.assert_array_equal(init_array, np.zeros(2, dtype=np.float32))


def ring_rotation_story(s):
    buf = s.scattered(4, 2, 3, 1.0, 2)
    buf.store(s.arr(np.ones(2)), row=0, src_id=0, chunk_id=0)
    buf.store(s.arr(np.ones(2) * 3), row=1, src_id=0, chunk_id=1)
    buf.up()
    assert s.rec(buf.count(0, 1)) == 1
    assert s.rec(buf.count(2, 0)) == 0
    reduced, _ = s.rec(buf.reduce(2, 0))
    assert reduced.sum() == 0
    s.rec(buf.reduce(0, 1))
    s.rec(buf.temporal_offset)


def tiny_reduce_threshold_story(s):
    buf = s.scattered(4, 4, 2, 0.2, 4)
    assert s.rec(buf.min_chunk_required) == 1
    buf.store(s.arr(np.ones(4)), 0, 0, 0)
    assert s.rec(buf.reach_reducing_threshold(0, 0)) is True


def scattered_negative_src_story(s):
    buf = s.scattered(4, 2, 2, 1.0, 4)
    with pytest.raises(IndexError):
        buf.store(s.arr(np.ones(4)), 0, -1, 0)
    s.rec(buf.count(0, 0))


# -- ReducedDataBufferSpec (tests/test_buffers_reduced.py) -----------------

def reduced_even_blocks_story(s):
    buf = s.reduced(5, 5, 15, 3, 4, 0.7, 2)
    row = 1
    assert tuple(buf.temporal_buffer.shape) == (4, 3, 5)
    output, count = s.rec(buf.get_with_counts(row))
    assert output.sum() == 0 and count.sum() == 0
    to_store = s.random_floats(2)
    buf.store(to_store, row, src_id=0, chunk_id=0, count=3)
    output, count = s.rec(buf.get_with_counts(row))
    np.testing.assert_array_equal(output[:2], np.asarray(to_store))
    assert (count[:2] == 3).all()
    src, chunk = 2, buf.num_chunks - 1
    with pytest.raises(IndexError):
        buf.store(s.random_floats(2), row, src, chunk, count=3)
    s.rec(buf.reach_completion_threshold(row))
    last_chunk_size = 5 - (buf.num_chunks - 1) * 2
    to_store = s.random_floats(last_chunk_size)
    buf.store(to_store, row, src, chunk, count=3)
    output, _ = s.rec(buf.get_with_counts(row))
    np.testing.assert_array_equal(output[15 - last_chunk_size:],
                                  np.asarray(to_store))
    assert s.rec(buf.reach_completion_threshold(row)) is False
    buf.store(s.random_floats(2), row, src_id=0, chunk_id=1, count=3)
    assert s.rec(buf.reach_completion_threshold(row)) is False
    buf.store(s.random_floats(2), row, src_id=1, chunk_id=0, count=3)
    buf.store(s.random_floats(2), row, src_id=1, chunk_id=1, count=3)
    assert s.rec(buf.reach_completion_threshold(row)) is False
    buf.store(s.random_floats(2), row, src_id=2, chunk_id=1, count=3)
    assert s.rec(buf.reach_completion_threshold(row)) is True
    reduced, counts = s.rec(buf.get_with_counts(row))
    assert reduced.shape == counts.shape
    missing = [4, 9, 10, 11]
    for i in missing:
        assert reduced[i] == 0 and counts[i] == 0
    assert all(counts[i] == 3 for i in range(15) if i not in missing)
    # one more store: the == gate has passed and does not fire again
    buf.store(s.random_floats(2), row, src_id=1, chunk_id=1, count=3)
    assert s.rec(buf.reach_completion_threshold(row)) is False


def reduced_uneven_completion_story(s):
    buf = s.reduced(6, 4, 16, 3, 4, 1.0, 2)
    row = 1
    assert s.rec(buf.reach_completion_threshold(row)) is False
    for chunk_id in range(3):
        for peer_id in range(2):
            buf.store(s.random_floats(2), row, peer_id, chunk_id, count=3)
            assert s.rec(buf.reach_completion_threshold(row)) is False
    buf.store(s.random_floats(2), row, 2, 0, count=3)
    assert s.rec(buf.reach_completion_threshold(row)) is False
    buf.store(s.random_floats(2), row, 2, 1, count=3)
    assert s.rec(buf.reach_completion_threshold(row)) is True
    s.rec(buf.get_with_counts(row))


def reduced_uneven_reassembly_story(s):
    buf = s.reduced(6, 4, 16, 3, 4, 1.0, 2)
    row = 1
    for peer in range(3):
        block = 4 if peer == 2 else 6
        for chunk in range(buf.get_num_chunk(block)):
            size = min(2, block - 2 * chunk)
            buf.store(s.arr(np.full(size, peer + 1)), row, peer, chunk,
                      count=peer + 1)
    out, counts = s.rec(buf.get_with_counts(row))
    np.testing.assert_array_equal(out[:6], np.full(6, 1.0))
    np.testing.assert_array_equal(out[6:12], np.full(6, 2.0))
    np.testing.assert_array_equal(out[12:16], np.full(4, 3.0))
    assert (counts[:6] == 1).all() and (counts[6:12] == 2).all()
    assert (counts[12:16] == 3).all()
    buf.up()
    s.rec(buf.get_with_counts(0))
    s.rec(buf.get_with_counts(3))


def more_peers_than_elements_story(s):
    buf = s.reduced(1, 0, 4, 8, 2, 1.0, 2)
    assert s.rec(buf.total_chunks) == 4
    assert s.rec(buf.min_chunk_required) == 4
    for peer in range(4):
        buf.store(s.arr(np.ones(1) * (peer + 1)), 0, peer, 0, count=1)
    assert s.rec(buf.reach_completion_threshold(0)) is True
    s.rec(buf.get_with_counts(0))


def reduced_tiny_threshold_story(s):
    buf = s.reduced(5, 5, 15, 3, 4, 0.1, 2)
    assert s.rec(buf.min_chunk_required) == 1
    buf.store(s.arr(np.ones(2)), 0, 0, 0, count=3)
    assert s.rec(buf.reach_completion_threshold(0)) is True
    s.rec(buf.get_with_counts(0))


def reduced_negative_src_story(s):
    buf = s.reduced(5, 5, 15, 3, 4, 0.7, 2)
    with pytest.raises(IndexError):
        buf.store(s.arr(np.ones(2)), 0, -1, 0, count=3)
    s.rec(buf.get_with_counts(0))


@pytest.mark.parametrize("scenario", [
    scattered_behavior_story, scattered_summation_story, ring_rotation_story,
    tiny_reduce_threshold_story, scattered_negative_src_story,
    reduced_even_blocks_story, reduced_uneven_completion_story,
    reduced_uneven_reassembly_story, more_peers_than_elements_story,
    reduced_tiny_threshold_story, reduced_negative_src_story],
    ids=lambda f: f.__name__)
def test_buffers_match_jax_bitwise(scenario):
    both(scenario)


def test_state_lives_where_it_should():
    """Data on the device, control on the host: the ring is a tensor on
    the buffer's device, the counts host numpy, the gates Python bools,
    and each store is one copy (no copy when the bounds fail)."""
    buf = port_buffers.ScatteredDataBuffer(6, 3, 2, 1.0, 4, device="cpu")
    assert isinstance(buf.temporal_buffer, torch.Tensor)
    assert buf.temporal_buffer.device.type == "cpu"
    assert isinstance(buf.count_filled, np.ndarray)
    before = port_base.STORE_COPIES
    buf.store(torch.ones(4), 0, 1, 0)
    with pytest.raises(IndexError):
        buf.store(torch.ones(4), 0, 1, 1)
    assert port_base.STORE_COPIES == before + 1
    assert type(buf.reach_reducing_threshold(0, 0)) is bool
    red = port_buffers.ReducedDataBuffer(3, 3, 6, 2, 2, 1.0, 2, device="cpu")
    assert type(red.reach_completion_threshold(0)) is bool
    out, count = red.get_with_counts(0)
    assert out.dtype == torch.float32 and count.dtype == torch.int32


@pytest.mark.parametrize("peers,data_size,chunk,lag", [
    (4, 195, 3, 4), (3, 10, 4, 2), (2, 7, 7, 1)])
def test_chunk_reduce_on_strided_slabs_matches_numpy_sum(peers, data_size,
                                                          chunk, lag):
    """Every chunk of every row, filled from the same seeded values on
    both sides, reduces bitwise as numpy's ``sum(axis=0, dtype=float32)``
    of the JAX buffer: the peers added in index order."""
    rng = np.random.default_rng(data_size)
    jb = jax_buffers.ScatteredDataBuffer(data_size, peers, lag, 1.0, chunk)
    pb = port_buffers.ScatteredDataBuffer(data_size, peers, lag, 1.0, chunk,
                                          device="cpu")
    for row in range(lag):
        for c in range(jb.num_chunks):
            n = min(chunk, data_size - c * chunk)
            for p in range(peers):
                v = (rng.standard_normal(n) * 100).astype(np.float32)
                jb.store(v, row, p, c)
                pb.store(torch.from_numpy(v), row, p, c)
    for row in range(lag):
        for c in range(jb.num_chunks):
            want, wn = jb.reduce(row, c)
            got, gn = pb.reduce(row, c)
            assert wn == gn == peers
            assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", ["scattered", "reduced"])
def test_buffer_state_from_numpy_continues_bitwise(kind):
    """A JAX buffer partway through its rounds (rotated, partly filled)
    carried into a port buffer: the two then take the same stores and
    read back the same bytes."""
    rng = np.random.default_rng(5)
    if kind == "scattered":
        jb = jax_buffers.ScatteredDataBuffer(7, 3, 3, 0.7, 3)
    else:
        jb = jax_buffers.ReducedDataBuffer(3, 1, 7, 3, 3, 0.7, 2)
    n_chunks = jb.num_chunks

    def store(buf, v, row, src, c, to_port):
        payload = torch.from_numpy(v) if to_port else v
        if kind == "scattered":
            buf.store(payload, row, src, c)
        else:
            buf.store(payload, row, src, c, count=src + 1)

    def size(c):
        return min(jb.max_chunk_size, jb.data_size - c * jb.max_chunk_size)

    for row in range(3):
        store(jb, rng.random(size(0), dtype=np.float32), row, row % 3, 0,
              False)
    jb.up()
    store(jb, rng.random(size(n_chunks - 1), dtype=np.float32), 1, 2,
          n_chunks - 1, False)
    pb = buffer_state_from_numpy(jb, device="cpu")
    assert type(pb).__name__ == type(jb).__name__
    assert pb.temporal_offset == jb.temporal_offset == 1
    for step in range(6):
        row, src, c = step % 3, (step + 1) % 3, step % n_chunks
        v = rng.random(size(c), dtype=np.float32)
        store(jb, v, row, src, c, False)
        store(pb, v, row, src, c, True)
        if kind == "scattered":
            want, wn = jb.reduce(row, c)
            got, gn = pb.reduce(row, c)
            assert wn == gn
            assert pb.reach_reducing_threshold(row, c) \
                == jb.reach_reducing_threshold(row, c)
        else:
            want, wn = jb.get_with_counts(row)
            got, gn = pb.get_with_counts(row)
            assert gn.numpy().tobytes() == wn.tobytes()
            assert pb.reach_completion_threshold(row) \
                == jb.reach_completion_threshold(row)
        assert got.numpy().tobytes() == want.tobytes()
        if step == 3:
            jb.up()
            pb.up()
    with pytest.raises(ValueError, match="geometry"):
        buffer_state_from_numpy(
            jb, into=port_buffers.ScatteredDataBuffer(8, 3, 3, 0.7, 3,
                                                      device="cpu"))
