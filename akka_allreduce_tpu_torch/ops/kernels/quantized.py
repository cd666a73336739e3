"""Int8 wire quantization: the plain PyTorch versions and the CUDA kernels.

The counterparts of ``akka_allreduce_tpu/ops/pallas_kernels/quantized.py``
for the int8 and ef8 gradient wires: symmetric int8 with per-row or
per-block f32 scales, stochastic or round-to-nearest-even rounding.

Wrappers (CPU tensors take the plain version; CUDA tensors launch
``csrc/quantize.cu`` or raise), each with its launch counter:

=============================  =========================================
:func:`quantize_int8`          per-row scales, bits tensor (row 2)
:func:`dequantize_int8`        ``values * scale`` per row (row 3)
:func:`quantize_int8_prng`     per-row scales, Philox bits in the kernel
                               (row 4)
:func:`quantize_int8_block`    block scales, bits tensor (row 5)
:func:`quantize_int8_block_rtn`  block scales, round half to even (row 6)
:func:`dequantize_int8_block`  ``values * scale`` per block (row 7)
=============================  =========================================

The rounding rule is the JAX package's ``_stochastic_round``: ``floor(s)
+ (s - floor(s) > (w >> 8) * 2^-24)``, clipped to ±127, from one uint32
word ``w`` per element. Torch has few uint32 operations, so a bits tensor
is int32 holding the same 32 bits. Given the same bits, values and scales
equal the JAX kernels' bitwise. :func:`quantize_int8_prng` draws its words
with Philox4x32-10 (:func:`philox_words`), a function of (seed, element
index) that the plain version computes too; the JAX kernel's TPU hardware
PRNG cannot be matched, so its bits (not its rule) differ.

Scales are computed outside the kernels, as the JAX package does
(:func:`row_scales`, :func:`block_scales`: abs-max / 127 as an IEEE
division, floored at 1e-30; block scales pad the row with zeros to a block
multiple). Every wrapper takes leading batch dimensions and flattens them
into rows. A ``block`` that is not a multiple of 128 raises, as in the
JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from akka_allreduce_tpu_torch.ops.kernels import build

# kernel launches since import (or since a caller reset them to 0); the
# plain versions never count
QUANTIZE_INT8_LAUNCHES = 0
DEQUANTIZE_INT8_LAUNCHES = 0
QUANTIZE_INT8_PRNG_LAUNCHES = 0
QUANTIZE_INT8_BLOCK_LAUNCHES = 0
QUANTIZE_INT8_BLOCK_RTN_LAUNCHES = 0
DEQUANTIZE_INT8_BLOCK_LAUNCHES = 0

_MODE = {"rtn": 0, "bits": 1, "philox": 2}
_LAUNCH: dict = {}

# Philox4x32-10 constants (Salmon et al., "Parallel random numbers: as
# easy as 1, 2, 3", SC 2011)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_CHUNK = 1 << 22  # elements per plain-version slice (bounds its memory)


def _launcher():
    if not _LAUNCH:
        lib = build.load("quantize")
        q = lib.quantize_launch
        q.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int64] * 4 + [ctypes.c_uint64,
                                                ctypes.c_void_p,
                                                ctypes.c_void_p])
        q.restype = ctypes.c_int
        d = lib.dequantize_launch
        d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 \
            + [ctypes.c_void_p]
        d.restype = ctypes.c_int
        err = lib.quantize_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LAUNCH.update(quantize=q, dequantize=d, error=err)
    return _LAUNCH


# -- scales (outside the kernels, as in the JAX package) ------------------

def _div127(abs_max: torch.Tensor) -> torch.Tensor:
    """``max(abs_max / 127, 1e-30)``, dividing by a tensor: a Python
    divisor would make torch multiply by 1/127 on CUDA."""
    d = torch.full((), 127.0, dtype=torch.float32, device=abs_max.device)
    return torch.div(abs_max, d).clamp_min(1e-30)


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """(rows, cols) f32 -> (rows, 1) symmetric per-row scales."""
    return _div127(x.abs().amax(dim=1, keepdim=True))


def block_scales(x: torch.Tensor, block: int) -> torch.Tensor:
    """(rows, cols) f32 -> (rows, ceil(cols / block)) symmetric per-block
    scales; the row pads with zeros to a block multiple (zeros never
    raise an abs-max)."""
    rows, cols = x.shape
    a = x.abs()
    if cols % block:
        a = F.pad(a, (0, block - cols % block))
    return _div127(a.view(rows, -1, block).amax(dim=2))


def _check_block(block: int) -> None:
    if block % 128 or block < 128:
        raise ValueError(f"block must be a multiple of 128 lanes, got "
                         f"{block}")


# -- Philox4x32-10, in plain PyTorch --------------------------------------

def _mulhilo(a: int, b: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """(high, low) 32 bits of ``a * b`` for a constant ``a`` and int64
    ``b`` holding uint32 values, without overflowing int64: ``a`` is split
    into 16-bit halves."""
    t = b * (a & 0xFFFF)
    s = b * (a >> 16) + (t >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(c0: torch.Tensor, c1: torch.Tensor, seed: int,
                  c2: Optional[torch.Tensor] = None,
                  c3: Optional[torch.Tensor] = None
                  ) -> "tuple[torch.Tensor, ...]":
    """The four output words of Philox4x32-10 for counters (c0, c1, c2,
    c3) (int64 tensors of uint32 values; c2 and c3 default to 0, as the
    kernel draws) and the 64-bit key ``seed`` (low word first)."""
    c2 = torch.zeros_like(c0) if c2 is None else c2
    c3 = torch.zeros_like(c0) if c3 is None else c3
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(start: int, count: int, seed: int,
                 device="cpu") -> torch.Tensor:
    """The uint32 words (as int64) of elements ``[start, start + count)``:
    element ``i`` takes word ``i % 4`` of counter ``i // 4``, as the
    kernel draws them."""
    g0, g1 = start // 4, (start + count + 3) // 4
    g = torch.arange(g0, g1, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10(g & _U32, g >> 32, seed), dim=1)
    off = start - 4 * g0
    return words.reshape(-1)[off:off + count]


# -- the plain versions ---------------------------------------------------

def _element_scales(scales: torch.Tensor, block: int,
                    cols: int) -> torch.Tensor:
    return scales.repeat_interleave(block, dim=1)[:, :cols]


def quantize_reference(x: torch.Tensor, scales: torch.Tensor, block: int,
                       mode: str, bits: Optional[torch.Tensor] = None,
                       seed: int = 0) -> torch.Tensor:
    """The plain version of every quantize kernel: ``x`` (rows, cols) f32,
    ``scales`` (rows, ceil(cols / block)); ``mode`` is "rtn", "bits"
    (``bits`` int32, x's shape) or "philox" (words from ``seed``).
    Returns the int8 values. Runs in row slices to bound memory."""
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    step = max(1, _CHUNK // max(cols, 1))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        scaled = torch.div(x[r0:r1], _element_scales(scales[r0:r1], block,
                                                     cols))
        if mode == "rtn":
            q = torch.round(scaled)  # half to even, as jnp.round
        else:
            if mode == "bits":
                u24 = torch.bitwise_and(bits[r0:r1] >> 8, 0xFFFFFF)
            elif mode == "philox":
                u24 = philox_words(r0 * cols, (r1 - r0) * cols, seed,
                                   x.device).view(r1 - r0, cols) >> 8
            else:
                raise ValueError(f"unknown rounding mode {mode!r}")
            low = torch.floor(scaled)
            q = low + (scaled - low > u24.float() * 2.0 ** -24).float()
        out[r0:r1] = q.clamp_(-127.0, 127.0).to(torch.int8)
    return out


def dequantize_reference(values: torch.Tensor, scales: torch.Tensor,
                         block: int) -> torch.Tensor:
    """The plain version of both dequantize kernels."""
    return values.float() * _element_scales(scales, block, values.shape[1])


# -- the wrappers ---------------------------------------------------------

def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]) if t.dim() != 2 else t


def _check_quantize(x: torch.Tensor, bits: Optional[torch.Tensor]) -> None:
    if x.dim() < 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (..., rows, cols) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if bits is not None and (bits.shape != x.shape
                             or bits.dtype != torch.int32
                             or bits.device != x.device):
        raise ValueError(f"bits must be int32 of x's shape {tuple(x.shape)} "
                         f"on {x.device}, got {tuple(bits.shape)} "
                         f"{bits.dtype} on {bits.device}")


def _quantize(x: torch.Tensor, scales: torch.Tensor, block: int, mode: str,
              bits: Optional[torch.Tensor], seed: int,
              seed_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Values for 2-D ``x``: the plain version on the CPU, the kernel on
    CUDA (the caller counts the launch). ``seed_ptr``, a one-element
    int64 tensor on ``x``'s device, takes the place of ``seed``: the
    kernel reads it when it runs."""
    if x.device.type == "cpu":
        if seed_ptr is not None:
            seed = int(seed_ptr.reshape(()).item()) & (2 ** 64 - 1)
        return quantize_reference(x, scales, block, mode, bits, seed)
    if x.device.type != "cuda":
        raise ValueError(f"int8 quantize runs on cpu or cuda, got {x.device}")
    if not x.is_contiguous() or (bits is not None
                                 and not bits.is_contiguous()):
        raise ValueError("the int8 quantize kernels need contiguous inputs")
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=torch.int8, device=x.device)
    lib = _launcher()
    scales = scales.contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib["quantize"](_MODE[mode], x.data_ptr(),
                             None if bits is None else bits.data_ptr(),
                             scales.data_ptr(), out.data_ptr(), rows, cols,
                             scales.shape[1], block, seed & (2 ** 64 - 1),
                             None if seed_ptr is None
                             else seed_ptr.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"int8 quantize kernel launch failed: "
                           f"{lib['error'](rc).decode()} ({rc})")
    return out


def _dequantize(values: torch.Tensor, scales: torch.Tensor,
                block: int) -> torch.Tensor:
    if values.dtype != torch.int8 or values.dim() != 2:
        raise ValueError(f"values must be (..., rows, cols) int8, got "
                         f"{tuple(values.shape)} {values.dtype}")
    rows, cols = values.shape
    nb = -(-cols // block)
    if tuple(scales.shape) != (rows, nb) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be ({rows}, {nb}) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if values.device.type == "cpu":
        return dequantize_reference(values, scales, block)
    if values.device.type != "cuda":
        raise ValueError(f"int8 dequantize runs on cpu or cuda, got "
                         f"{values.device}")
    if not values.is_contiguous():
        raise ValueError("the int8 dequantize kernels need contiguous values")
    out = torch.empty((rows, cols), dtype=torch.float32, device=values.device)
    lib = _launcher()
    scales = scales.contiguous()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib["dequantize"](values.data_ptr(), scales.data_ptr(),
                               out.data_ptr(), rows, cols, nb, block, stream)
    if rc != 0:
        raise RuntimeError(f"int8 dequantize kernel launch failed: "
                           f"{lib['error'](rc).decode()} ({rc})")
    return out


def quantize_int8(x: torch.Tensor, bits: torch.Tensor
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
    """x (..., rows, cols) f32, bits int32 of x's shape -> (int8 values
    of x's shape, f32 scales (..., rows, 1)): per-row scales, stochastic
    rounding from ``bits``."""
    global QUANTIZE_INT8_LAUNCHES
    _check_quantize(x, bits)
    x2, scales = _rows(x), row_scales(_rows(x))
    values = _quantize(x2, scales, max(x2.shape[1], 1), "bits", _rows(bits),
                       0)
    if x.device.type == "cuda":
        QUANTIZE_INT8_LAUNCHES += 1
    return values.view(x.shape), scales.view(x.shape[:-1] + (1,))


def seed_tensor(seed: int, device) -> torch.Tensor:
    """A 64-bit seed as the one-element int64 tensor that
    :func:`quantize_int8_prng` reads it from (the same 64 bits, two's
    complement)."""
    seed = int(seed) & (2 ** 64 - 1)
    return torch.tensor([seed - 2 ** 64 if seed >= 2 ** 63 else seed],
                        dtype=torch.int64, device=device)


def quantize_int8_prng(x: torch.Tensor, seed: "int | torch.Tensor"
                       ) -> "tuple[torch.Tensor, torch.Tensor]":
    """As :func:`quantize_int8`, the words drawn by Philox4x32-10 keyed
    by the 64-bit ``seed`` (vary it per round) inside the kernel: no bits
    tensor exists in device memory. ``seed`` is a Python int, or a
    one-element int64 tensor on ``x``'s device holding its 64 bits
    (:func:`seed_tensor`), which the kernel reads when it runs (a CUDA
    graph's replay draws the words of the seed written there before it);
    one seed gives the same words either way."""
    global QUANTIZE_INT8_PRNG_LAUNCHES
    _check_quantize(x, None)
    seed_ptr = None
    if isinstance(seed, torch.Tensor):
        if (seed.dtype != torch.int64 or seed.numel() != 1
                or seed.device != x.device):
            raise ValueError(f"a seed tensor is one int64 on {x.device}, "
                             f"got {tuple(seed.shape)} {seed.dtype} on "
                             f"{seed.device}")
        seed_ptr, seed = seed, 0
    x2, scales = _rows(x), row_scales(_rows(x))
    values = _quantize(x2, scales, max(x2.shape[1], 1), "philox", None,
                       int(seed), seed_ptr)
    if x.device.type == "cuda":
        QUANTIZE_INT8_PRNG_LAUNCHES += 1
    return values.view(x.shape), scales.view(x.shape[:-1] + (1,))


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of the per-row quantizers: (..., rows, cols) int8 and
    (..., rows, 1) f32 -> f32."""
    global DEQUANTIZE_INT8_LAUNCHES
    v2 = _rows(values)
    out = _dequantize(v2, _rows(scales), max(v2.shape[1], 1))
    if values.device.type == "cuda":
        DEQUANTIZE_INT8_LAUNCHES += 1
    return out.view(values.shape)


def quantize_int8_block(x: torch.Tensor, bits: torch.Tensor, block: int
                        ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Block-scale stochastic quantize: x (..., rows, cols) f32, bits
    int32 of x's shape -> (int8 values, f32 scales (..., rows,
    ceil(cols / block)))."""
    global QUANTIZE_INT8_BLOCK_LAUNCHES
    _check_block(block)
    _check_quantize(x, bits)
    x2 = _rows(x)
    scales = block_scales(x2, block)
    values = _quantize(x2, scales, block, "bits", _rows(bits), 0)
    if x.device.type == "cuda":
        QUANTIZE_INT8_BLOCK_LAUNCHES += 1
    return values.view(x.shape), scales.view(x.shape[:-1] + scales.shape[1:])


def quantize_int8_block_rtn(x: torch.Tensor, block: int
                            ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Block-scale deterministic quantize (round half to even): the
    error-feedback wire format, a pure function of ``x``."""
    global QUANTIZE_INT8_BLOCK_RTN_LAUNCHES
    _check_block(block)
    _check_quantize(x, None)
    x2 = _rows(x)
    scales = block_scales(x2, block)
    values = _quantize(x2, scales, block, "rtn", None, 0)
    if x.device.type == "cuda":
        QUANTIZE_INT8_BLOCK_RTN_LAUNCHES += 1
    return values.view(x.shape), scales.view(x.shape[:-1] + scales.shape[1:])


def dequantize_int8_block(values: torch.Tensor, scales: torch.Tensor,
                          block: int) -> torch.Tensor:
    """Inverse of the block-scale quantizers: (..., rows, cols) int8 and
    (..., rows, ceil(cols / block)) f32 -> f32."""
    global DEQUANTIZE_INT8_BLOCK_LAUNCHES
    _check_block(block)
    out = _dequantize(_rows(values), _rows(scales), block)
    if values.device.type == "cuda":
        DEQUANTIZE_INT8_BLOCK_LAUNCHES += 1
    return out.view(values.shape)


def launch_counts() -> dict:
    """The six counters by kernel name."""
    return {"quantize_int8": QUANTIZE_INT8_LAUNCHES,
            "dequantize_int8": DEQUANTIZE_INT8_LAUNCHES,
            "quantize_int8_prng": QUANTIZE_INT8_PRNG_LAUNCHES,
            "quantize_int8_block": QUANTIZE_INT8_BLOCK_LAUNCHES,
            "quantize_int8_block_rtn": QUANTIZE_INT8_BLOCK_RTN_LAUNCHES,
            "dequantize_int8_block": DEQUANTIZE_INT8_BLOCK_LAUNCHES}

