"""The rounding keys of a captured chunk (``ops/collectives.py
ChunkKeys``) and the int8 quantizer's seed read from device memory (row
4, ``quantize_int8_prng`` with a seed tensor), on the CPU.

A CUDA graph of N train steps cannot hash a key on the host at each
replay: while it is captured each int8 quantize takes a slot of an int64
seed table and each ef8 bit draw a generator of its own, and before each
replay ``ChunkKeys.fill`` writes the seeds of the keys the replay's steps
derive. Pins: after ``fill(b)`` slot j of step i holds ``key_seed`` of
step ``b + i``'s key j (every key grows from ``quant_key(step)``), and
each generator draws bitwise the eager ``wire_bits`` of its key; the
quantizer given that slot gives bitwise the by-value seed's values; the
eager path keeps hashing on the host (its bits do not change); a chunk
refuses keys of other steps, more draws than its eager step made, and a
capture that left slots unused.
"""

import numpy as np
import pytest
import torch

from akka_allreduce_tpu_torch.models.train import quant_key
from akka_allreduce_tpu_torch.ops import collectives as co
from akka_allreduce_tpu_torch.ops.kernels import quantized as qz


def int8_keys(step: int, rank: int = 1) -> list:
    """The two keys one int8 sync of ``step`` derives on ``rank``
    (phase 1 and phase 2: ``split(fold_in(key, rank))``)."""
    return co.split(co.fold_in(quant_key(step), rank))


def ef8_keys(step: int, rank: int = 1) -> list:
    """The key of one ef8 sync's phase-2 draw on ``rank``."""
    return [co.fold_in(quant_key(step), rank)]


def captured(n: int, base: int) -> co.ChunkKeys:
    """A chunk of ``n`` steps from ``base`` whose int8 and ef8 calls were
    made inside :func:`co.chunk_keys`, as a capture makes them."""
    chunk = co.ChunkKeys(n, base, "cpu", 2, 1)
    with co.chunk_keys(chunk):
        for i in range(n):
            for key in int8_keys(base + i):
                co._quantize_seed(key)
            for key in ef8_keys(base + i):
                co.wire_bits((3, 5), key, "cpu")
    chunk.check_complete()
    return chunk


def as_int64(seed: int) -> int:
    return seed - 2 ** 64 if seed >= 2 ** 63 else seed


@pytest.mark.parametrize("base", [5, 11, 0])
def test_fill_writes_each_steps_seeds(base):
    chunk = captured(3, 5)
    chunk.fill(base)
    want = [as_int64(co.key_seed(k)) for i in range(3)
            for k in int8_keys(base + i)]
    assert chunk.table.tolist() == want
    for i, gen in enumerate(chunk.generators):
        got = torch.randint(-2 ** 31, 2 ** 31, (3, 5), dtype=torch.int32,
                            generator=gen)
        assert torch.equal(got, co.wire_bits((3, 5), ef8_keys(base + i)[0],
                                             "cpu"))


def test_the_keys_grow_from_the_steps_quant_key():
    assert co.shift_step(int8_keys(7)[1], 9) == int8_keys(9)[1]
    chunk = captured(2, 4)
    seeds, bits = chunk.keys_at(10)
    assert seeds == int8_keys(10) + int8_keys(11)
    assert bits == ef8_keys(10) + ef8_keys(11)


def test_a_table_slot_quantizes_as_its_seed_by_value():
    chunk = captured(2, 0)
    chunk.fill(3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 130)).astype(np.float32))
    for j, key in enumerate(int8_keys(3) + int8_keys(4)):
        v, s = qz.quantize_int8_prng(x, chunk.table[j:j + 1])
        want_v, want_s = qz.quantize_int8_prng(x, co.key_seed(key))
        assert torch.equal(v, want_v) and torch.equal(s, want_s)


@pytest.mark.parametrize("seed", [0, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1])
def test_a_seed_tensor_holds_the_seeds_64_bits(seed):
    t = qz.seed_tensor(seed, "cpu")
    assert t.dtype == torch.int64 and t.shape == (1,)
    assert int(t.item()) & (2 ** 64 - 1) == seed
    x = torch.linspace(-3, 3, 520).reshape(4, 130)
    assert torch.equal(qz.quantize_int8_prng(x, t)[0],
                       qz.quantize_int8_prng(x, seed)[0])


def test_a_seed_tensor_must_be_one_int64_on_xs_device():
    x = torch.ones((2, 128))
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="one int64"):
            qz.quantize_int8_prng(x, bad)


def test_the_eager_path_hashes_on_the_host():
    """Outside a capture nothing reads a table: the seeds and bits are
    the host hash's, and ``record_keys`` lists the keys in order."""
    key = int8_keys(2)[0]
    with co.record_keys() as keys:
        assert co._quantize_seed(key) == co.key_seed(key)
        bits = co.wire_bits((2, 3), ef8_keys(2)[0], "cpu")
    assert keys == [("seed", key), ("bits", ef8_keys(2)[0])]
    gen = torch.Generator().manual_seed(co.key_seed(ef8_keys(2)[0]))
    assert torch.equal(bits, torch.randint(-2 ** 31, 2 ** 31, (2, 3),
                                           dtype=torch.int32, generator=gen))


def test_a_chunk_refuses_what_its_eager_step_did_not_derive():
    chunk = co.ChunkKeys(2, 5, "cpu", 1, 0)
    with co.chunk_keys(chunk):
        with pytest.raises(ValueError, match="a key of step 7"):
            co._quantize_seed(int8_keys(7)[0])
        co._quantize_seed(int8_keys(5)[0])
        co._quantize_seed(int8_keys(6)[0])
        with pytest.raises(RuntimeError, match="more seeds"):
            co._quantize_seed(int8_keys(6)[1])
        with pytest.raises(RuntimeError, match="more draws"):
            co.wire_bits((1, 1), ef8_keys(5)[0], "cpu")
    chunk.check_complete()
    short = co.ChunkKeys(2, 0, "cpu", 1, 1)
    with pytest.raises(RuntimeError, match="derived 0 seeds"):
        short.check_complete()
