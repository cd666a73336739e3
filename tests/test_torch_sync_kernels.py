"""The gradient sync's kernels (plain versions) against the JAX package's.

Row 1, the masked reduce, against ``fused_masked_reduce`` in interpret
mode and against ``masked_reduce_staged(impl="xla")``: allclose at rtol
1e-6 (the sums run in another order), the count exact. Rows 2, 3, 5, 6
and 7, the int8 quantizers and dequantizers, against the JAX kernels in
interpret mode given the same bits: bitwise, values and scales. Row 4
(Philox inside the kernel) has no JAX counterpart to match, the TPU's
hardware generator: its wire-format invariants, its unbiasedness over 64
seeds at the JAX test's bound, distinct streams, and Philox4x32-10's
published known answers. On the CPU every wrapper runs its plain version;
the kernels are held against them on the card (``chip_smoke.py`` phase
8, ``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_allreduce_tpu.ops.masked import masked_reduce_staged as j_staged
from akka_allreduce_tpu.ops.pallas_kernels import quantized as jq
from akka_allreduce_tpu.ops.pallas_kernels.reduce import fused_masked_reduce
from akka_allreduce_tpu_torch.ops import masked as tmasked
from akka_allreduce_tpu_torch.ops.kernels import masked_reduce as tmr
from akka_allreduce_tpu_torch.ops.kernels import quantized as tq


# -- row 1 -----------------------------------------------------------------

@pytest.mark.parametrize("peers,elems,valid,target", [
    (4, 256, [1, 1, 0, 1], 1.0),          # a straggler
    (2, 128, [0, 0], 1.0),                # zero contributors
    (4, 128, [1, 1, 1, 0], 4.0),          # target rescale
    (3, 1001, [1, 0, 1], 2.0),            # ragged elems
    (8, 3000, [1, 1, 1, 0, 1, 1, 1, 1], 8.0),
], ids=["straggler", "zero", "target", "ragged", "bench_shape"])
def test_masked_reduce_matches_jax(peers, elems, valid, target):
    rng = np.random.default_rng(elems)
    staged = rng.normal(size=(peers, elems)).astype(np.float32)
    v = np.asarray(valid, np.int32)
    want, want_n = fused_masked_reduce(jnp.asarray(staged), jnp.asarray(v),
                                       target=target, interpret=True)
    xla, xla_n = j_staged(jnp.asarray(staged), jnp.asarray(v), target=target,
                          impl="xla")
    got, n = tmasked.masked_reduce_staged(torch.from_numpy(staged),
                                          torch.from_numpy(v), target)
    assert got.dtype == torch.float32 and n.dtype == torch.int32
    assert int(n) == int(want_n) == int(xla_n) == sum(valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=1e-6,
                               atol=1e-7)
    if not sum(valid):
        assert not got.any()


def test_masked_reduce_sums_peers_in_order():
    """The plain version and the kernel add peer 0, then 1, ...: each
    element's sum is the same ordered f32 sum whatever the width, so a
    window of the columns reduces bitwise as the whole does."""
    rng = np.random.default_rng(3)
    staged = torch.from_numpy(rng.normal(size=(4, 500)).astype(np.float32))
    ones = torch.ones(4)
    whole, _ = tmr.masked_reduce(staged, ones, 4.0)
    part, _ = tmr.masked_reduce(staged[:, 100:300].contiguous(), ones, 4.0)
    assert torch.equal(part, whole[100:300])
    ordered = ((staged[0] + staged[1]) + staged[2]) + staged[3]
    assert torch.equal(whole, ordered)


def test_masked_reduce_checks_shapes():
    with pytest.raises(ValueError, match="valid must be"):
        tmr.masked_reduce(torch.zeros(3, 4), torch.ones(2))
    with pytest.raises(ValueError, match="float32"):
        tmr.masked_reduce(torch.zeros(3, 4, dtype=torch.float64),
                          torch.ones(3))
    assert tmr.MASKED_REDUCE_LAUNCHES == 0  # the CPU never launches


# -- rows 2, 3, 5, 6, 7: bitwise given the same bits -----------------------

def _x_bits(rows, cols, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, cols)).astype(np.float32)
    x[0, :3] *= 100.0  # an outlier
    x[-1] = 0.0        # an all-zero row: the 1e-30 scale floor
    bits = rng.integers(0, 2 ** 32, size=(rows, cols), dtype=np.uint32)
    return x, bits


@pytest.mark.parametrize("rows,cols", [(8, 512), (5, 1000), (3, 1001)])
def test_per_row_quantize_and_dequantize_bitwise(rows, cols):
    x, bits = _x_bits(rows, cols, rows * cols)
    jv, js = jq.quantize_int8(jnp.asarray(x), jnp.asarray(bits),
                              interpret=True)
    tv, ts = tq.quantize_int8(torch.from_numpy(x),
                              torch.from_numpy(bits.view(np.int32)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jq.dequantize_int8(jv, js, interpret=True)
    td = tq.dequantize_int8(tv, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("cols,block", [(256, 128), (1000, 128), (1000, 512),
                                        (1001, 512)])
def test_block_quantizers_and_dequantize_bitwise(cols, block):
    x, bits = _x_bits(4, cols, cols + block)
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(tq.block_scales(torch.from_numpy(x),
                                                  block).numpy(),
                                  np.asarray(jq.block_scales(jx, block)))
    jv, js = jq.quantize_int8_block(jx, jnp.asarray(bits), block,
                                    interpret=True)
    tv, ts = tq.quantize_int8_block(torch.from_numpy(x),
                                    torch.from_numpy(bits.view(np.int32)),
                                    block)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jr, jrs = jq.quantize_int8_block_rtn(jx, block, interpret=True)
    tr, trs = tq.quantize_int8_block_rtn(torch.from_numpy(x), block)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
    for jval, tval in ((jv, tv), (jr, tr)):
        np.testing.assert_array_equal(
            tq.dequantize_int8_block(tval, ts, block).numpy(),
            np.asarray(jq.dequantize_int8_block(jval, js, block,
                                                interpret=True)))


def test_round_half_to_even():
    """Ties round to even (``torch.round`` and ``jnp.round`` alike)."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 122])
    v, s = tq.quantize_int8_block_rtn(x, 128)
    assert float(s[0, 0]) == 1.0
    assert v[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_leading_batch_dims_flatten():
    x, bits = _x_bits(6, 300, 9)
    tx, tb = torch.from_numpy(x), torch.from_numpy(bits.view(np.int32))
    v, s = tq.quantize_int8_block(tx.view(2, 3, 300), tb.view(2, 3, 300),
                                  128)
    v2, s2 = tq.quantize_int8_block(tx, tb, 128)
    assert v.shape == (2, 3, 300) and s.shape == (2, 3, 3)
    assert torch.equal(v.view(6, 300), v2) and torch.equal(s.view(6, 3), s2)
    assert torch.equal(tq.dequantize_int8_block(v, s, 128).view(6, 300),
                       tq.dequantize_int8_block(v2, s2, 128))
    pv, ps = tq.quantize_int8(tx.view(2, 3, 300), tb.view(2, 3, 300))
    assert ps.shape == (2, 3, 1)
    assert tq.dequantize_int8(pv, ps).shape == (2, 3, 300)


@pytest.mark.parametrize("block", [64, 100, 200])
def test_block_not_a_multiple_of_128_is_refused(block):
    x = torch.ones(2, 256)
    with pytest.raises(ValueError, match="128"):
        tq.quantize_int8_block_rtn(x, block)
    with pytest.raises(ValueError, match="128"):
        tq.dequantize_int8_block(torch.zeros(2, 256, dtype=torch.int8),
                                 torch.ones(2, 4), block)
    with pytest.raises(ValueError, match="128"):
        jq.quantize_int8_block_rtn(jnp.asarray(x.numpy()), block,
                                   interpret=True)


# -- row 4: Philox inside the kernel ---------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """Random123's published known answers for Philox4x32-10."""
    c = [torch.tensor([v], dtype=torch.int64) for v in counter]
    got = tq.philox4x32_10(c[0], c[1], key[0] | key[1] << 32, c[2], c[3])
    assert tuple(int(w) for w in got) == want


def test_philox_words_do_not_depend_on_the_slice():
    seed = 0x0123456789ABCDEF
    whole = tq.philox_words(0, 1000, seed)
    assert torch.equal(tq.philox_words(37, 501, seed), whole[37:538])
    assert int(whole.min()) >= 0 and int(whole.max()) < 2 ** 32
    # distinct streams per seed, and per element
    other = tq.philox_words(0, 1000, seed + 1)
    assert (other != whole).float().mean() > 0.99
    assert len(set(whole.tolist())) > 990


def test_prng_quantize_wire_invariants():
    """|v| <= 127, scales bitwise the JAX kernels' per-row scales, and
    each value is floor(x/s) or floor(x/s) + 1; the plain version's row
    slices draw the words the whole matrix would."""
    x, _ = _x_bits(6, 700, 11)
    v, s = tq.quantize_int8_prng(torch.from_numpy(x), seed=5)
    _, js = jq.quantize_int8(jnp.asarray(x),
                             jnp.zeros(x.shape, jnp.uint32), interpret=True)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    vv = v.numpy().astype(np.int32)
    assert np.abs(vv).max() <= 127
    low = np.floor(x / s.numpy())
    assert np.all((vv == np.clip(low, -127, 127))
                  | (vv == np.clip(low + 1, -127, 127)))
    words = tq.philox_words(0, x.size, 5).view(x.shape)
    ref = tq.quantize_reference(torch.from_numpy(x), s, 700, "bits",
                                words.to(torch.int32))
    assert torch.equal(v, ref)


def test_prng_quantize_is_unbiased_over_seeds():
    """The JAX kernel test's bound: the mean of 64 draws is within 0.2
    of a quantization step of the input."""
    x = torch.full((1, 256), 0.37)
    x[0, 0] = 1.0  # scale 1/127: 0.37 sits between two grid points
    acc = torch.zeros((1, 256), dtype=torch.float64)
    for seed in range(64):
        v, s = tq.quantize_int8_prng(x, seed=seed)
        acc += tq.dequantize_int8(v, s).double()
    step = float(s[0, 0])
    assert float((acc / 64 - x.double()).abs().mean()) < 0.2 * step
    draws = {tq.quantize_int8_prng(x, seed=seed)[0].numpy().tobytes()
             for seed in range(8)}
    assert len(draws) == 8  # distinct streams per seed


def test_launch_counters_start_at_zero_on_the_cpu():
    x = torch.ones(2, 256)
    tq.quantize_int8_block_rtn(x, 128)
    tq.quantize_int8_prng(x, 1)
    assert set(tq.launch_counts()) == {
        "quantize_int8", "dequantize_int8", "quantize_int8_prng",
        "quantize_int8_block", "quantize_int8_block_rtn",
        "dequantize_int8_block"}
    assert not any(tq.launch_counts().values())
    jax.block_until_ready(jnp.zeros(1))  # JAX stays importable beside it
