"""The allreduce collectives of the gradient sync, rank-local.

Counterpart of ``akka_allreduce_tpu/ops/collectives.py``. Each function
runs on every rank of a :class:`~akka_allreduce_tpu_torch.parallel.group.
RankGroup` (where the JAX function runs inside ``shard_map`` over a mesh
axis) and returns this rank's result:

* :func:`two_phase_allreduce` / :func:`psum_allreduce` — reduce-scatter +
  all-gather along the last axis. The scatter is an ``all_to_all`` of the
  ranks' blocks; the blocks that arrive are reduced on the device by the
  masked-reduce kernel in rank order (``ops/kernels/masked_reduce.py``),
  so every element's sum is the same ordered f32 sum on every schedule;
  then an ``all_gather``. ``psum_allreduce`` is the same sum over the
  flattened tensor (the JAX package's ``lax.psum`` is XLA's own).
* :func:`pipelined_two_phase_allreduce` — the windowed schedule, bitwise
  the fused one.
* :func:`quantized_two_phase_allreduce` — int8 on the wire with per-row
  scales and stochastic rounding on both hops.
* :func:`ef8_two_phase_allreduce` — block scales and error feedback.
* :func:`swing_allreduce` / :func:`quantized_swing_allreduce` — the ±2^t
  exchange schedule on a power-of-two group.
* :func:`hierarchical_allreduce` — the ICI x DCN hybrid on the ``(dp,
  sp)`` mesh: the exact two-phase over each ``sp`` line, the ef8 wire
  over each ``dp`` line (:meth:`RankGroup.along`).
* :func:`exact_allreduce` — the standalone driver over a stacked array.

Quantization keys. The JAX package derives threefry keys with
``fold_in`` / ``split``; the port cannot reproduce threefry. A key here is
a tuple of Python ints that grows the same way (:func:`fold_in` appends,
:func:`split` appends a split marker and an index), and :func:`key_seed`
hashes it on the host into a 64-bit seed (no device sync). The seed keys
the Philox stream inside the int8 wire's quantize kernel, or the
``torch.Generator`` that draws the bits tensor of the ef8 wire's
stochastic leg. The tuples follow the JAX derivation step for
step (per rank, per phase, per window; for swing per hop and subgroup),
so the same ranks share and the same ranks differ in their rounding
noise; but the bits differ from JAX's, so int8 parity with the JAX
package is statistical only.

Keys of a captured chunk. A CUDA graph that captures N train steps
cannot hash a key on the host at each replay. :class:`ChunkKeys` stands
in while the chunk is captured (:func:`chunk_keys`): each int8 quantize
reads its seed from a slot of an int64 device table, each ef8 bits
tensor is drawn from a generator of its own registered with the graph,
and :meth:`ChunkKeys.fill` writes, before each replay, the seeds of the
keys that the replay's steps derive (one host-to-device copy, and a
``manual_seed`` a generator), so step s of a replay draws bitwise the
bits of an eager step s. :func:`record_keys` lists the keys an eager
step derives, in order (how many slots a step takes).
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Optional

import torch

from akka_allreduce_tpu_torch.ops.kernels.masked_reduce import masked_reduce
from akka_allreduce_tpu_torch.device import resolve_device
from akka_allreduce_tpu_torch.ops.kernels.quantized import (
    dequantize_int8, dequantize_int8_block, quantize_int8_block,
    quantize_int8_block_rtn, quantize_int8_prng, seed_tensor)
from akka_allreduce_tpu_torch.parallel.group import RankGroup, spawn_ranks

# ef8 scale-block width: one f32 scale per this many int8 columns (the JAX
# package's default; a multiple of 128, as the block kernels require)
DEFAULT_EF_BLOCK = 512


# -- keys ------------------------------------------------------------------

def fold_in(key: tuple, data: int) -> tuple:
    return tuple(key) + (int(data),)


def split(key: tuple, num: int = 2) -> list:
    return [tuple(key) + (-1, i) for i in range(num)]


def key_seed(key: tuple) -> int:
    """A 64-bit seed from a key tuple (the same on every process)."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def wire_bits(shape, key: tuple, device) -> torch.Tensor:
    """An int32 tensor of random words for the bits-input block
    quantizer, from a generator on ``device`` seeded with ``key`` (while
    a chunk is captured, the chunk's generator for this draw)."""
    if _KEYS["record"] is not None:
        _KEYS["record"].append(("bits", key))
    if _KEYS["chunk"] is not None:
        gen = _KEYS["chunk"].generator(key)
    else:
        gen = torch.Generator(device=device).manual_seed(key_seed(key))
    return torch.randint(-2 ** 31, 2 ** 31, tuple(shape), dtype=torch.int32,
                         generator=gen, device=device)


def _quantize_seed(key: tuple) -> "int | torch.Tensor":
    """The int8 wire's seed for ``key``: hashed on the host, or while a
    chunk is captured the device slot that holds it."""
    if _KEYS["record"] is not None:
        _KEYS["record"].append(("seed", key))
    if _KEYS["chunk"] is not None:
        return _KEYS["chunk"].seed(key)
    return key_seed(key)


# -- the keys of a captured chunk -----------------------------------------

# "record": the list an eager step appends its keys to; "chunk": the
# ChunkKeys of a chunk being captured
_KEYS: dict = {"record": None, "chunk": None}


@contextlib.contextmanager
def record_keys():
    """Yields the list of ``("seed" | "bits", key)`` that the int8 and
    ef8 wires derive inside the block, in order (an eager step's keys:
    what a captured chunk's slots stand for)."""
    keys: list = []
    _KEYS["record"] = keys
    try:
        yield keys
    finally:
        _KEYS["record"] = None


def shift_step(key: tuple, step: int) -> tuple:
    """``key`` as step ``step`` derives it: every rounding key of a train
    step grows from ``quant_key(step)`` = ``(root, step, ...)``, so its
    second element is the step."""
    return (key[0], int(step)) + tuple(key[2:])


class ChunkKeys:
    """The rounding keys of a chunk of ``n`` train steps captured from
    step ``base`` on, one CUDA graph: ``seeds_per_step`` int8 seeds and
    ``bits_per_step`` ef8 bit draws a step (:func:`record_keys` of one
    eager step counts them). ``table`` holds the seeds (int64, on
    ``device``), ``generators`` one generator a draw; register them with
    the graph before its capture (:meth:`register`). While the chunk is
    captured (:func:`chunk_keys`) each wire call takes the next slot and
    its key is kept; :meth:`fill` then writes the seeds of step ``b +
    i``'s keys for a replay of steps ``b .. b + n - 1``."""

    def __init__(self, n: int, base: int, device, seeds_per_step: int,
                 bits_per_step: int):
        self.n, self.base = n, int(base)
        self.table = torch.zeros((n * seeds_per_step,), dtype=torch.int64,
                                 device=device)
        self.generators = [torch.Generator(device=device)
                           for _ in range(n * bits_per_step)]
        self.seed_keys: list = []
        self.bit_keys: list = []

    def register(self, graph) -> None:
        """Register every generator with ``graph`` (a
        ``torch.cuda.CUDAGraph``, before its capture begins): a replay
        then draws from the seed the generator holds when it starts."""
        for gen in self.generators:
            graph.register_generator_state(gen)

    def _take(self, keys: list, size: int, key: tuple, what: str) -> int:
        step = int(key[1])
        if not self.base <= step < self.base + self.n:
            raise ValueError(f"a key of step {step} in a chunk of steps "
                             f"{self.base}..{self.base + self.n - 1}")
        if len(keys) == size:
            raise RuntimeError(f"the captured chunk draws more {what} than "
                               f"its eager step did ({size // self.n} a "
                               f"step)")
        keys.append(key)
        return len(keys) - 1

    def seed(self, key: tuple) -> torch.Tensor:
        """The table slot of the next int8 seed (a one-element view)."""
        i = self._take(self.seed_keys, self.table.numel(), key, "seeds")
        return self.table[i:i + 1]

    def generator(self, key: tuple) -> torch.Generator:
        """The generator of the next ef8 bit draw."""
        i = self._take(self.bit_keys, len(self.generators), key, "draws")
        return self.generators[i]

    def check_complete(self) -> None:
        """Raise unless the capture took every slot (each step derived
        what the eager step did)."""
        if (len(self.seed_keys) != self.table.numel()
                or len(self.bit_keys) != len(self.generators)):
            raise RuntimeError(
                f"the captured chunk derived {len(self.seed_keys)} seeds "
                f"and {len(self.bit_keys)} draws, its eager steps "
                f"{self.table.numel()} and {len(self.generators)}")

    def keys_at(self, base: int) -> "tuple[list, list]":
        """The seed keys and draw keys of a replay of steps ``base ..
        base + n - 1``, slot by slot."""
        def move(keys):
            return [shift_step(k, base + int(k[1]) - self.base)
                    for k in keys]
        return move(self.seed_keys), move(self.bit_keys)

    def fill(self, base: int) -> None:
        """Before a replay of steps ``base .. base + n - 1``: the seeds
        of their keys into the table (one host-to-device copy) and into
        the generators."""
        seeds, bits = self.keys_at(base)
        if seeds:
            self.table.copy_(torch.cat([seed_tensor(key_seed(k), "cpu")
                                        for k in seeds]))
        for gen, k in zip(self.generators, bits):
            gen.manual_seed(key_seed(k))


@contextlib.contextmanager
def chunk_keys(keys: ChunkKeys):
    """While a chunk is captured: the int8 and ef8 wires take their
    seeds and generators from ``keys``."""
    _KEYS["chunk"] = keys
    try:
        yield keys
    finally:
        _KEYS["chunk"] = None


# -- exact sums ------------------------------------------------------------

def _rank_sum(staged: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of the (n, ...) blocks the ranks sent, on the device, in rank
    order, as f32 (the masked reduce with every rank valid and target n:
    its scale is n / n = 1 exactly)."""
    flat = staged.reshape(n, -1)
    if flat.dtype != torch.float32:
        flat = flat.float()
    ones = torch.ones((n,), dtype=torch.float32, device=staged.device)
    total, _ = masked_reduce(flat.contiguous(), ones, target=float(n))
    return total.view(staged.shape[1:])


def _pad_scatter_geometry(x: torch.Tensor, n: int
                          ) -> "tuple[torch.Tensor, int]":
    """Zero-pad the last axis to a multiple of the group size (the zeros
    sum harmlessly at the end); returns ``(padded, original_len)``."""
    e = x.shape[-1]
    pad = (-e) % n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x, e


def _reduce_scatter(xp: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """The tiled reduce-scatter of the last axis (length a multiple of the
    group): this rank's block of the sum, in the payload's dtype."""
    n = group.world
    c = xp.shape[-1] // n
    blocks = xp.reshape(-1, n, c).transpose(0, 1).contiguous()
    total = _rank_sum(group.all_to_all(blocks), n)
    return total.to(xp.dtype).reshape(xp.shape[:-1] + (c,))


def _all_gather_last(s: torch.Tensor, group: RankGroup) -> torch.Tensor:
    n, c = group.world, s.shape[-1]
    g = group.all_gather(s.reshape(1, -1)).reshape(n, -1, c)
    return g.transpose(0, 1).reshape(s.shape[:-1] + (n * c,))


def two_phase_allreduce(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Reduce-scatter + all-gather along the last axis; any length (a
    length the group does not divide pads with zeros and trims)."""
    if group.world == 1:
        return x
    xp, e = _pad_scatter_geometry(x, group.world)
    return _all_gather_last(_reduce_scatter(xp, group), group)[..., :e]


def psum_allreduce(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """The sum over ranks, any shape: the two-phase sum of the flattened
    tensor (bitwise :func:`two_phase_allreduce` for the same values)."""
    if group.world == 1:
        return x
    return two_phase_allreduce(x.reshape(1, -1), group).reshape(x.shape)


def pipelined_two_phase_allreduce(x: torch.Tensor, group: RankGroup,
                                  num_windows: int = 2) -> torch.Tensor:
    """Windowed two-phase allreduce of a ``(num_buckets, bucket_elems)``
    matrix: the bucket axis split into ``num_windows`` windows, window
    i+1's reduce-scatter issued before window i's all-gather (the JAX
    package's interleaved order). Every element still takes one
    reduce-scatter and one all-gather with the same rank-order sum, so
    the result is bitwise :func:`two_phase_allreduce`'s.
    ``num_windows`` must divide the bucket count."""
    if x.dim() != 2:
        raise ValueError(
            f"expected (num_buckets, bucket_elems), got {tuple(x.shape)}")
    if num_windows < 1:
        raise ValueError(f"num_windows must be >= 1, got {num_windows}")
    b = x.shape[0]
    if b % num_windows:
        raise ValueError(
            f"num_windows={num_windows} does not divide num_buckets={b}: "
            f"pad the bucket axis with zero rows to a multiple of "
            f"num_windows (parallel/dp.py's windowed path does this), or "
            f"pick num_windows from the divisors of {b}")
    if num_windows == 1 or group.world == 1:
        return two_phase_allreduce(x, group)
    xp, e = _pad_scatter_geometry(x, group.world)
    wb = b // num_windows
    windows = [xp[i * wb:(i + 1) * wb] for i in range(num_windows)]
    out = [None] * num_windows
    scattered = _reduce_scatter(windows[0], group)
    for i in range(1, num_windows):
        next_scattered = _reduce_scatter(windows[i], group)
        out[i - 1] = _all_gather_last(scattered, group)
        scattered = next_scattered
    out[num_windows - 1] = _all_gather_last(scattered, group)
    return torch.cat(out, dim=0)[..., :e]


# -- the int8 wire ---------------------------------------------------------

def _quantize_rows(x2d: torch.Tensor, key: tuple
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """(rows, c) f32 -> (int8 values, (rows, 1) f32 scales), per-row
    scales, stochastic rounding from the Philox stream keyed by ``key``
    (the JAX package's TPU default, the in-kernel-PRNG quantizer)."""
    return quantize_int8_prng(x2d, _quantize_seed(key))


def _dequantize_rows(values: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    return dequantize_int8(values, scales)


def _window_sizes(m: int, num_windows: int, n: int) -> list:
    """Row offsets of windows carving ``m`` owner row-groups of ``n``
    rows into near-equal contiguous chunks."""
    sizes = [(m // num_windows + (i < m % num_windows)) * n
             for i in range(num_windows)]
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return offs


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)
    return x


def quantized_two_phase_allreduce(buckets: torch.Tensor, key: tuple,
                                  group: RankGroup, num_windows: int = 1
                                  ) -> torch.Tensor:
    """Reduce-scatter + all-gather with int8 payloads: one scale per
    bucket row, stochastic rounding on both hops, f32 accumulation.
    Bucket rows are block-distributed to their owner ranks (rows pad with
    zeros to a multiple of the group); ``num_windows > 1`` carves the
    owner row-groups into windows issued on the interleaved schedule."""
    if buckets.dim() != 2:
        raise ValueError(
            f"expected (num_buckets, bucket_elems), got "
            f"{tuple(buckets.shape)}")
    if num_windows < 1:
        raise ValueError(f"num_windows must be >= 1, got {num_windows}")
    n = group.world
    if n == 1:
        return buckets
    b, e = buckets.shape
    buckets = _pad_rows(buckets, n)
    bp = buckets.shape[0]
    key = fold_in(key, group.rank)

    def phase1(win, k1):
        rows_per_rank = win.shape[0] // n
        values, scales = _quantize_rows(win, k1)
        recv_v = group.all_to_all(values.view(n, rows_per_rank, e))
        recv_s = group.all_to_all(scales.view(n, rows_per_rank, 1))
        return (recv_v.float() * recv_s).sum(dim=0)

    def phase2(reduced, k2):
        out_v, out_s = _quantize_rows(reduced, k2)
        return _dequantize_rows(group.all_gather(out_v),
                                group.all_gather(out_s))

    num_windows = min(num_windows, bp // n)
    if num_windows == 1:
        k1, k2 = split(key)
        return phase2(phase1(buckets, k1), k2)[:b]
    offs = _window_sizes(bp // n, num_windows, n)
    wins = [buckets[offs[i]:offs[i + 1]] for i in range(num_windows)]
    keys = [split(fold_in(key, i)) for i in range(num_windows)]
    out = [None] * num_windows
    reduced = phase1(wins[0], keys[0][0])
    for i in range(1, num_windows):
        next_reduced = phase1(wins[i], keys[i][0])
        out[i - 1] = phase2(reduced, keys[i - 1][1])
        reduced = next_reduced
    out[num_windows - 1] = phase2(reduced, keys[num_windows - 1][1])
    return torch.cat(out, dim=0)[:b]


# -- the ef8 wire ----------------------------------------------------------

def _quantize_blocks(x2d: torch.Tensor, block: int,
                     key: Optional[tuple] = None
                     ) -> "tuple[torch.Tensor, torch.Tensor]":
    """(rows, e) f32 -> (int8 values, f32 scales (rows, ceil(e/block))).
    ``key=None`` is deterministic round-to-nearest (the error-feedback
    rule); a key selects stochastic rounding from a bits tensor."""
    if key is None:
        return quantize_int8_block_rtn(x2d, block)
    return quantize_int8_block(x2d, wire_bits(x2d.shape, key, x2d.device),
                               block)


def _dequantize_blocks(values: torch.Tensor, scales: torch.Tensor,
                       block: int) -> torch.Tensor:
    """Inverse of :func:`_quantize_blocks`; leading batch dims allowed."""
    return dequantize_int8_block(values, scales, block)


def ef8_phase2_rows(num_buckets: int, group: int) -> int:
    """Row count of the phase-2 residual: the owner rows this rank
    broadcasts (bucket rows padded to a multiple of the group, divided
    by it)."""
    return (num_buckets + (-num_buckets) % group) // max(group, 1)


def _mask_rows(x: torch.Tensor, valid: Optional[torch.Tensor]
               ) -> torch.Tensor:
    return x if valid is None else x * valid.to(x.dtype)[:, None]


def ef8_two_phase_allreduce(buckets: torch.Tensor, key: tuple,
                            group: RankGroup,
                            residual: Optional[torch.Tensor] = None,
                            valid: Optional[torch.Tensor] = None,
                            num_windows: int = 1,
                            block_elems: int = DEFAULT_EF_BLOCK,
                            residual2: Optional[torch.Tensor] = None):
    """Block-quantized two-phase allreduce with error feedback: phase 1
    quantizes ``buckets + residual`` with round-to-nearest and carries
    ``comp - dequant(sent)`` forward; phase 2 rounds stochastically, or
    with ``residual2`` (owner-rows-shaped, fused schedule only) also
    round-to-nearest with its own feedback. A masked row (``valid`` 0)
    sends exact zeros and keeps its residual unchanged. Returns
    ``(summed, new_residual)`` or, with ``residual2``, ``(summed,
    new_residual, new_residual2)``."""
    if buckets.dim() != 2:
        raise ValueError(
            f"expected (num_buckets, bucket_elems), got "
            f"{tuple(buckets.shape)}")
    if num_windows < 1:
        raise ValueError(f"num_windows must be >= 1, got {num_windows}")
    if block_elems < 1:
        raise ValueError(f"block_elems must be >= 1, got {block_elems}")
    if residual is None:
        residual = torch.zeros_like(buckets)
    if residual.shape != buckets.shape:
        raise ValueError(
            f"residual shape {tuple(residual.shape)} != buckets shape "
            f"{tuple(buckets.shape)} — the error-feedback state is one f32 "
            f"residual per bucket element (re-init it when the model or "
            f"bucket_elems changes)")
    if residual2 is not None and num_windows != 1:
        raise ValueError(
            "phase-2 error feedback (residual2) needs the fused schedule "
            "(num_windows=1): the windowed carve re-partitions owner rows "
            "per window")
    n = group.world
    if n == 1:
        out = _mask_rows(buckets, valid)
        if residual2 is not None:
            return out, residual, residual2
        return out, residual
    comp = _mask_rows(buckets + residual, valid)
    b, e = buckets.shape
    comp_p = _pad_rows(comp, n)
    bp = comp_p.shape[0]
    key = fold_in(key, group.rank)

    def phase1(win):
        rows_per_rank = win.shape[0] // n
        values, scales = _quantize_blocks(win, block_elems)
        deq_local = _dequantize_blocks(values, scales, block_elems)
        nb = scales.shape[1]
        recv_v = group.all_to_all(values.view(n, rows_per_rank, e))
        recv_s = group.all_to_all(scales.view(n, rows_per_rank, nb))
        reduced = _dequantize_blocks(recv_v, recv_s, block_elems).sum(dim=0)
        return reduced, deq_local

    def phase2(reduced, k2):
        out_v, out_s = _quantize_blocks(reduced, block_elems, key=k2)
        return _dequantize_blocks(group.all_gather(out_v),
                                  group.all_gather(out_s), block_elems)

    num_windows = min(num_windows, bp // n)
    new_residual2 = residual2
    if num_windows == 1:
        reduced, deq_local = phase1(comp_p)
        if residual2 is not None:
            if tuple(residual2.shape) != (bp // n, e):
                raise ValueError(
                    f"residual2 shape {tuple(residual2.shape)} != owner rows "
                    f"({bp // n}, {e}) — the phase-2 state is one f32 "
                    f"residual per broadcast element "
                    f"(ef8_phase2_rows(num_buckets, group) rows)")
            comp2 = reduced + residual2
            v2, s2 = _quantize_blocks(comp2, block_elems)
            new_residual2 = comp2 - _dequantize_blocks(v2, s2, block_elems)
            out = _dequantize_blocks(group.all_gather(v2),
                                     group.all_gather(s2), block_elems)[:b]
        else:
            out = phase2(reduced, key)[:b]
        deq = deq_local[:b]
    else:
        offs = _window_sizes(bp // n, num_windows, n)
        wins = [comp_p[offs[i]:offs[i + 1]] for i in range(num_windows)]
        keys = [fold_in(key, i) for i in range(num_windows)]
        out_w = [None] * num_windows
        deq_w = [None] * num_windows
        reduced, deq_w[0] = phase1(wins[0])
        for i in range(1, num_windows):
            next_reduced, deq_w[i] = phase1(wins[i])
            out_w[i - 1] = phase2(reduced, keys[i - 1])
            reduced = next_reduced
        out_w[num_windows - 1] = phase2(reduced, keys[num_windows - 1])
        out = torch.cat(out_w, dim=0)[:b]
        deq = torch.cat(deq_w, dim=0)[:b]
    new_residual = comp[:b] - deq
    if valid is not None:
        new_residual = torch.where(valid.bool()[:, None], new_residual,
                                   residual)
    if residual2 is not None:
        return out, new_residual, new_residual2
    return out, new_residual


# -- the swing schedule ----------------------------------------------------

def _check_power_of_two(n: int) -> None:
    if n & (n - 1):
        raise ValueError(
            f"swing schedule needs a power-of-two group, got {n} ranks: "
            f"the ±2^t exchange pairing only closes on powers of two — use "
            f"the fused or windowed schedule for this group")


def swing_allreduce(x: torch.Tensor, group: RankGroup,
                    axis: Optional[str] = None) -> torch.Tensor:
    """log2(n) exchange-and-add steps, step t with the rank at XOR
    distance 2^t, each moving the full running sum (``out = out +
    partner's out``). Every rank folds the same balanced pairwise tree
    (f32 addition commutes), so the result is bitwise identical across
    ranks and runs. Over the whole world, or along one mesh ``axis``."""
    n = group.world if axis is None else group.axis_size(axis)
    if n == 1:
        return x
    _check_power_of_two(n)
    my = group.rank if axis is None else group.axis_index(axis)
    out = x
    for t in range(n.bit_length() - 1):
        peer = my ^ (1 << t)
        if axis is not None:
            peer = group.axis_rank(axis, peer)
        out = out + group.exchange(out, peer)
    return out


def quantized_swing_allreduce(buckets: torch.Tensor, key: tuple,
                              group: RankGroup,
                              residual: Optional[torch.Tensor] = None,
                              valid: Optional[torch.Tensor] = None,
                              block_elems: Optional[int] = None):
    """The swing exchange with int8 payloads: each hop quantizes the
    running sum, dequantizes the peer's and accumulates in f32.
    ``block_elems=None`` is per-row scales with stochastic rounding every
    hop; an int selects block scales, and with ``residual`` the first hop
    (this rank's own contribution) rounds to nearest and feeds its error
    back. ``valid`` masks rows at hop 0 (their residual carries over).
    Returns ``(summed, new_residual)`` (None when no residual was given).

    Rounding keys are per subgroup: after hop t every rank of subgroup
    ``rank >> t`` holds the same partial sum, and quantizing it with the
    same key keeps those ranks identical; rank-local keys would let them
    drift apart."""
    if buckets.dim() != 2:
        raise ValueError(
            f"expected (num_buckets, bucket_elems), got "
            f"{tuple(buckets.shape)}")
    if residual is not None and residual.shape != buckets.shape:
        raise ValueError(
            f"residual shape {tuple(residual.shape)} != buckets shape "
            f"{tuple(buckets.shape)} — the error-feedback state is one f32 "
            f"residual per bucket element (re-init it when the model or "
            f"bucket_elems changes)")
    if residual is not None and block_elems is None:
        raise ValueError("error feedback (a residual) needs block scales: "
                         "pass block_elems")
    n = group.world
    if n == 1:
        return _mask_rows(buckets, valid), residual
    _check_power_of_two(n)

    def quant(mat, k):
        if block_elems is None:
            return _quantize_rows(mat, k)
        return _quantize_blocks(mat, block_elems, key=k)

    def deq(v, s):
        if block_elems is None:
            return _dequantize_rows(v, s)
        return _dequantize_blocks(v, s, block_elems)

    new_residual = residual
    acc = buckets
    for t in range(n.bit_length() - 1):
        kt = fold_in(fold_in(key, t), group.rank >> t)
        if t == 0:
            comp = _mask_rows(acc if residual is None else acc + residual,
                              valid)
            v, s = quant(comp, None if residual is not None else kt)
            d = deq(v, s)
            if residual is not None:
                nr = comp - d
                new_residual = nr if valid is None else torch.where(
                    valid.bool()[:, None], nr, residual)
            # the accumulator adopts its own dequant: both sides of every
            # exchange then fold identical values
            acc = d
        else:
            v, s = quant(acc, kt)
            acc = deq(v, s)
        peer = group.rank ^ (1 << t)
        acc = acc + deq(group.exchange(v, peer), group.exchange(s, peer))
    return acc, new_residual


def hierarchical_allreduce(buckets: torch.Tensor, key: tuple,
                           group: RankGroup,
                           residual: Optional[torch.Tensor] = None,
                           valid: Optional[torch.Tensor] = None,
                           block_elems: int = DEFAULT_EF_BLOCK,
                           dcn_axis: str = "dp", ici_axis: str = "sp"):
    """The ICI x DCN hybrid schedule: the exact reduce-scatter of the
    columns over ``ici_axis`` (the fast links), the ef8 two-phase with
    error feedback on this rank's column shard over ``dcn_axis`` (the
    slow group: ``payload / (4 |ici|)`` bytes a rank instead of
    ``payload``), then the exact all-gather over ``ici_axis``. Outer =
    DCN = ``dp``, inner = ICI = ``sp``: the JAX mesh order.

    ``residual`` keeps the full bucket shape on every schedule; a rank
    updates only the columns of the shard it owns after the
    reduce-scatter. ``valid`` masks rows for the round: a masked row
    contributes exact zeros to both legs and keeps its residual. The
    masks of one ``ici_axis`` line must agree (a deadline masks whole
    lines, never half of one). ``|ici| = 1`` is the ef8 two-phase over
    DCN; ``|dcn| = 1`` leaves the exact two-phase over ICI with the
    residual unchanged. Returns ``(summed, new_residual)``."""
    if buckets.dim() != 2:
        raise ValueError(
            f"expected (num_buckets, bucket_elems), got "
            f"{tuple(buckets.shape)}")
    if residual is None:
        residual = torch.zeros_like(buckets)
    if residual.shape != buckets.shape:
        raise ValueError(
            f"residual shape {tuple(residual.shape)} != buckets shape "
            f"{tuple(buckets.shape)} — the error-feedback state keeps the "
            f"full bucket shape on every schedule (hierarchical updates "
            f"only the owned-shard columns)")
    ici, dcn = group.along(ici_axis), group.along(dcn_axis)
    if ici.world == 1:
        return ef8_two_phase_allreduce(buckets, key, dcn, residual=residual,
                                       valid=valid, block_elems=block_elems)
    e = buckets.shape[1]
    xp, _ = _pad_scatter_geometry(_mask_rows(buckets, valid), ici.world)
    cols = xp.shape[-1] // ici.world
    lo, hi = ici.rank * cols, (ici.rank + 1) * cols
    # the exact reduce phase: this rank owns the line's sum of its
    # column shard (the masked-reduce kernel adds the line's blocks)
    shard = _reduce_scatter(xp, ici)
    # the owned shard's residual columns (padded columns carry zero
    # gradient, quantize to exact zeros and keep a zero residual)
    resid_p, _ = _pad_scatter_geometry(residual, ici.world)
    # decorrelate the phase-2 draws of the line's ranks
    key = fold_in(key, ici.rank)
    out_shard, new_shard = ef8_two_phase_allreduce(
        shard, key, dcn, residual=resid_p[:, lo:hi].contiguous(),
        valid=valid, block_elems=block_elems)
    out = _all_gather_last(out_shard, ici)[..., :e]
    new_residual = resid_p.clone()
    new_residual[:, lo:hi] = new_shard
    return out, new_residual[:, :e].contiguous()


# -- the standalone driver -------------------------------------------------

def _exact_rank(group: RankGroup, stacked: torch.Tensor,
                two_phase: bool) -> torch.Tensor:
    x = stacked[group.rank].to(group.device)
    fn = two_phase_allreduce if two_phase else psum_allreduce
    return fn(x, group)


def exact_allreduce(stacked: torch.Tensor, two_phase: bool = False,
                    device: str = "cuda", backend: Optional[str] = None
                    ) -> torch.Tensor:
    """``stacked[i]`` is rank i's contribution: one rank process per row
    runs the allreduce, and every row of the result is the full sum (the
    reference's ``output == sum over workers`` invariant,
    AllreduceWorker.scala:337-339). Runs on ``cuda`` unless ``device``
    is ``"cpu"``; ``backend`` defaults to nccl on cuda, gloo on the CPU
    (NCCL needs one GPU per rank: pass ``backend="gloo"`` to share
    cards)."""
    dev = resolve_device(device).type
    backend = backend or ("nccl" if dev == "cuda" else "gloo")
    outs = spawn_ranks(_exact_rank, stacked.shape[0], backend, dev,
                       stacked.detach().cpu(), two_phase)
    return torch.stack(outs)
