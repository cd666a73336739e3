"""JAX's counter-based PRNG, ``threefry2x32``, on torch tensors.

The sampled decode paths of the JAX package draw their noise from
``jax.random`` keys (``models/generate.py sample_step_key``: token j's
key is ``fold_in(base, j)``). The port draws the same bits from the same
keys, so a sampled stream can be held to JAX's token for token. This
module is written from ``jax._src.prng`` and ``jax._src.random`` (jax
0.9.0) with ``jax_threefry_partitionable=True``, the default there:

* a key is two uint32 words; :func:`key` ``(seed)`` is ``[seed >> 32,
  seed & 0xFFFFFFFF]`` after JAX's 32-bit seed conversion, i.e.
  ``[0, seed mod 2**32]``. A key here is its words, so JAX's
  ``key_data`` has no counterpart and :func:`wrap_key_data` only checks
  the words' type and range;
* :func:`fold_in` hashes the counter pair ``(0, data)`` under the key;
* :func:`split` and :func:`bits` hash the flat index of every element
  of the requested shape, its 64 bits as the counter pair ``(hi, lo)``;
  32 random bits are the two output words xor-ed;
* :func:`uniform` puts the top mantissa bits under the exponent of 1.0,
  :func:`gumbel` is ``-log(-log(u))`` over ``[tiny, 1)``, and
  :func:`categorical` is the argmax of logits plus Gumbel noise drawn
  at the logits' own shape.

Words are uint32 values held in int64 tensors (torch has no uint32
arithmetic on every device) and masked to 32 bits after each add and
shift, so the same code runs on the CPU and the card. A key is an int64
tensor whose last axis has the two words; leading axes are a batch of
keys, and every function draws for all of them in one vectorised
threefry pass (no Python loop over keys).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (total bits, mantissa bits) of the float dtypes ``uniform`` draws
_FLOAT_BITS = {torch.float32: (32, 23), torch.bfloat16: (16, 7),
               torch.float16: (16, 10)}
_INT_VIEW = {32: torch.int32, 16: torch.int16}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """The 20-round Threefry-2x32 block cipher of counters (x0, x1) under
    key (k0, k1), elementwise over broadcast int64 tensors of uint32
    values. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device: "torch.device | str" = "cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s two words, ``(2,)`` int64."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def wrap_key_data(data, device: "torch.device | str | None" = None
                  ) -> torch.Tensor:
    """Raw words (``(..., 2)``, any integer type) -> a key tensor."""
    t = torch.as_tensor(data, device=device)
    return t.to(torch.int64) & _MASK


def _words(k: torch.Tensor, ndim: int) -> "tuple[torch.Tensor, ...]":
    """A key batch's two words, shaped to broadcast against ``ndim``
    trailing axes."""
    view = k.shape[:-1] + (1,) * ndim
    return k[..., 0].reshape(view), k[..., 1].reshape(view)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from a key and an integer (a
    scalar, or a tensor broadcast against the key batch)."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counters(shape: tuple, device) -> "tuple[torch.Tensor, torch.Tensor]":
    """``prng.iota_2x32_shape``: the flat row-major index of every
    element of ``shape`` as (hi, lo) words."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _hash(k: torch.Tensor, shape: tuple):
    hi, lo = _counters(tuple(shape), k.device)
    k0, k1 = _words(k, len(shape))
    return threefry2x32(k0, k1, hi, lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``(..., num, 2)`` keys."""
    y0, y1 = _hash(k, (num,))
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape: tuple, width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: ``width``-bit words (8, 16 or 32) of
    ``k.shape[:-1] + shape``, as int64 values."""
    y0, y1 = _hash(k, shape)
    return (y0 ^ y1) & ((1 << width) - 1)


def uniform(k: torch.Tensor, shape: tuple = (),
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` over ``[minval, maxval)``."""
    nbits, nmant = _FLOAT_BITS[dtype]
    rng_bits = nbits if nmant >= 8 else 8
    b = bits(k, shape, rng_bits)
    # the bits of 1.0 and the shifted mantissa both stay below the sign
    # bit, so the word fits the signed view unchanged
    one = torch.tensor(1.0, dtype=dtype).view(_INT_VIEW[nbits]).item()
    fbits = (b >> (rng_bits - nmant)) | one
    floats = fbits.to(_INT_VIEW[nbits]).view(dtype) - torch.tensor(
        1.0, dtype=dtype, device=k.device)
    lo = torch.tensor(minval, dtype=dtype, device=k.device)
    hi = torch.tensor(maxval, dtype=dtype, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: torch.Tensor, shape: tuple = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low", the default)."""
    u = uniform(k, shape, dtype, minval=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis with one key: the
    noise is drawn at ``logits.shape``. With a batch of keys ``(L, 2)``
    and logits ``(L, ...)``, row i draws with key i at shape
    ``logits.shape[1:]``."""
    shape = tuple(logits.shape[k.dim() - 1:])
    noise = gumbel(k, shape, logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
