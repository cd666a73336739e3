// Tensor-core tiles of the f32 attention, in split TF32: the folds of the
// f32 flash forward, dq and dk/dv (flash_attention.cu) and of the f32
// ring forward, dq and dk/dv (ring_flash.cu), and their epilogues: the
// flash kernels store their rows, the ring kernels add them into the
// travelling accumulators (query_tile_epilogue, dkv_tf32_epilogue) or
// write their carry back in place.
//
// Replaces, for f32 inputs: akka_allreduce_tpu/ops/pallas_kernels/
// attention.py _fwd_kernel (:113), _dq_kernel (:153) and _dkv_kernel
// (:184), and ring_flash.py _ring_fwd_kernel (:61), _ring_dq_kernel (:94)
// and _ring_dkv_kernel (:121), the same tiles on one hop's block. Their
// tile arithmetic: attention.py _softmax_tile (:79), the online softmax
// (m' = max(m, rowmax s), corr = exp(min(m, m') - m'), p = exp(s - m'),
// exactly 0 on a masked lane, l' = l corr + rowsum p, acc' = acc corr + p
// v), and _bwd_tile (:99): p = exp(s - lse), exactly 0 on a masked lane;
// dp = dO v^T; ds = p (dp - delta) scale; dq += ds k; dv += p^T dO and dk
// += ds^T q, summed over the GQA group; all in f32.
//
// Split TF32 (CUTLASS's OpMultiplyAddFastF32, "3xTF32"): every operand x
// is split into hi = x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds) and lo = x - hi, which the tensor core
// truncates to TF32 (split_tf32), and each product is hi.lo + lo.hi +
// hi.hi on mma.sync.m16n8k8 tf32 with f32 accumulators (lo.lo, ~2^-22 of
// the product, dropped; the small terms first). One TF32 product keeps
// ~11 bits and misses the f32 reference's 2e-5 (forward) and 5e-5
// (gradients); the split keeps ~20, ~1e-6 relative
// (tests/torch_split_tf32.py emulates both). The tensor core's f32 sums
// round toward zero, so no accumulator takes more than one pass's
// products (tf32_pk): the running sums are f32 adds, rounded to nearest.
//
// Bound: ~4 (forward), ~6 (dq) and ~8 (dk/dv) flops per head-dim element
// of every live (q, k) pair, three tensor-core products each: 495 TFLOP/s
// of TF32 (dense) is ~165 TFLOP/s of f32 work, against the CUDA cores' 67
// (the flash kernels at B 8, T 2048, H 16, D 128, causal: forward 0.83
// ms, dq 1.25, dk/dv 1.67; a past ring hop at B 8, T 1024, H 16, H_kv 4,
// D 128: forward 0.42, dq 0.62, dk/dv 0.83; chip_smoke.py computes the
// bounds from the live pairs). The inputs, the outputs and the f32 carry
// or accumulators add ~8 bytes a head-dim element, far under that. On
// mma.sync the split's integer and f32 instructions, not the tensor core,
// set the pace (~3 a split element), so the design spends as few as it
// can:
//   * Every product on mma.sync (split TF32), the score tiles kept in
//     registers: an m16n8 accumulator holds columns {2t, 2t + 1} of row
//     lane / 4 (t = lane % 4) and a tf32 A fragment wants {t, t + 4}, so
//     the k index of the next product is relabelled (logical t <->
//     physical 2t, t + 4 <-> 2t + 1; the sum over k is the same) and P /
//     dS feed it straight from registers: a = {c0, c2, c1, c3}, split once
//     a pass.
//   * The block's resident tile (Q in the forward, Q and dO in dq, K and
//     V in dk/dv) is split once when it lands, into a hi and a lo copy in
//     shared memory (split_tile), so S = Q K^T and dP = dO V^T (S^T, dP^T
//     in dk/dv) read their A operand ready-split: split in every warp at
//     every product it cost ~2 of the ~9 instructions an mma took. The
//     backward's streamed tiles are split in registers as they are read
//     (a second pair of copies would not fit). The forward keeps one
//     resident tile where dq keeps two, so its streamed K and V would fit
//     as hi and lo copies too, but splitting them once a block so was
//     ~27% slower than splitting them in every warp's registers (NVIDIA
//     H100 80GB HBM3, 700 W: the flash forward at B 8, T 2048, H 16, D
//     128, causal 3.88 ms against 3.05): two more block-wide barriers and
//     a pass of the whole block a half, and twice the shared loads of K
//     and V a warp.
//   * Operands reduced over D come through ldmatrix, an 8 x 4 f32 tile
//     read as 8 x 8 b16: each lane gets the word at row lane / 4, column
//     lane % 4, which is the tf32 fragment's element. ldmatrix.trans moves
//     16-bit halves and does not serve 32-bit elements, so the B operands
//     reduced over a tile's rows (K in dq += dS K, dO in dv += P^T dO, Q in
//     dk += dS^T Q) are read with 64-bit shared loads: with the relabelled
//     k, b0 and b1 come from rows 2t and 2t + 1, and the output columns
//     are paired (below) so that one float2 holds the b0 (or b1) of two
//     neighbouring n8 tiles.
//   * Paired output columns: in the accumulators of those products, n8
//     tiles 2p and 2p + 1 hold D columns 16p + 2 (lane / 4) + {0, 1}, so
//     a lane ends with 4 neighbouring columns of each of its rows,
//     16p + 4t + {0..3} = {acc[2p][2i], acc[2p + 1][2i], acc[2p][2i + 1],
//     acc[2p + 1][2i + 1]} of row lane / 4 + 8i (paired_cols): one float4
//     a row and tile pair in the epilogue.
//   * Shared tiles of D + 4 floats a row (528 bytes at D = 128): the 8 row
//     addresses of an ldmatrix fall in 8 different 16-byte bank groups,
//     and a half-warp's float2 loads from rows 2t, columns 2 (lane / 4)
//     cover the 32 banks once: no bank conflicts.
//   * The streamed tile (K and V in dq, Q, dO, lse and delta in dk/dv) is
//     copied by cp.async (16 bytes a thread; rows past T zero-filled by
//     the copy itself) into one buffer, in two halves of 32 rows: each
//     pass takes a half, and when it is done its rows are refilled with
//     the next tile's, under the other half's products.
//   * 8 warps a block, two to each 16 rows of the block's own tile, the
//     pair splitting each pass's 32 streamed rows 16 + 16: two warps a
//     scheduler, and 16 x 16 score tiles. Each warp sums its own share;
//     at the end the pair exchanges halves of its sums through the freed
//     shared memory (dq: half the columns each; dk/dv: dk to one warp, dv
//     to the other), in f32, and each warp stores its half.
//
//   * The forward's online softmax is not linear in the keys, so each warp
//     of a pair carries its own (m, l, acc) over its 16 keys of each pass,
//     and the pair merges them once at the end, through the freed shared
//     memory: m = max(m0, m1), l and acc rescaled by exp(m_i - m).
//
// Work layout: 64-row tiles. Forward and dq: one block per (query tile,
// query head, batch), walking the live key band (the longest causal bands
// launched first); dk/dv: one block per (key tile, KV head, batch), walking the
// GQA group x live query tiles (in blockIdx order: key tile 0 has the
// longest causal band), so the group sums in f32 registers and is
// written once (no atomics: two launches give the same bits). The
// causal mask leaves a contiguous band of live tiles (live_tiles; a
// window or offsets can leave it empty) and only that band is loaded; a
// masked lane gets p = 0 exactly (dq_scores / dkv_scores write 0), so a
// row with no live key or query sums exactly 0, and a block whose band is
// empty still zeroes its sums and runs its epilogue (the flash kernels'
// outputs start uninitialised); lanes past Tk and rows past Tq contribute
// nothing and are not stored; a tile whose pairs are all live, by
// causality and the window, skips the per-element mask (tile_full).
//
// Shared memory: the backward's resident tile pair with their lo copies
// and the streamed pair (dk/dv also a query tile's lse and delta): 202,752
// / 203,264 bytes at D = 128, one block of 8 warps an SM; 104,448 /
// 104,960 at D = 64, two; 55,296 / 55,808 at D = 32. The forward: Q hi
// and lo and the streamed K and V, 135,168 bytes at D = 128. Registers
// (ptxas -v, sm_90a; no spill accepted): at D = 128 a dq warp holds its dq share (16 x 128 f32 = 64)
// and S, dP (8 + 8): 213; a dk/dv warp its dk and dv shares (2 x 64) and
// S^T, dP^T: 255; a forward warp its acc share (64) and S (8): 216 (the
// flash and the ring kernel of each fold alike, to a few registers: the
// epilogue derives its addresses after the fold). The launch bounds say
// one block an SM (the forward: two at D = 32, fwd_tf32_min_blocks):
// without, ptxas aims at more blocks (it cannot see the dynamic shared
// memory) and spills under their register budget; the forward spilled
// under two blocks at D = 64 (128 registers) and three at D = 32 (80).

#pragma once

#include "flash_mma.cuh"

namespace {

// padded shared-memory row of a D-wide f32 tile (16 bytes of padding)
template <int D>
__host__ __device__ constexpr int tf32_ld() { return D + 4; }
template <int D>
__host__ __device__ constexpr int tf32_tile() { return kTile * tf32_ld<D>(); }

// six tiles: the two resident ones, each with its lo copy, and the two
// streamed ones (dk/dv also a query tile's lse and delta)
template <int D>
constexpr size_t dq_tf32_smem() {
  return 6 * static_cast<size_t>(tf32_tile<D>()) * sizeof(float);
}
template <int D>
constexpr size_t dkv_tf32_smem() {
  return 6 * static_cast<size_t>(tf32_tile<D>()) * sizeof(float)
         + 2 * kTile * sizeof(float);
}

// the forward's tiles: Q hi and lo, K and V
template <int D>
constexpr size_t fwd_tf32_smem() {
  return 4 * static_cast<size_t>(tf32_tile<D>()) * sizeof(float);
}
// the forward's blocks an SM that the launch bounds ask for: one at D =
// 128 and 64, two at 32
template <int D>
constexpr int fwd_tf32_min_blocks() { return D == 32 ? 2 : 1; }

// rows of one pass over the streamed tile, and of one streamed copy
constexpr int kHalf = kTile / 2;
// a block of either fold: 8 warps, two to each 16 rows of the block's own
// tile, the pair splitting each pass's 32 streamed rows 16 + 16
constexpr int kTf32Threads = 256;

// x = hi + lo to ~2^-21 of x, as the tensor core reads them: it ignores
// the 13 low mantissa bits of a tf32 operand, so hi = x's bits + half a
// TF32 ulp is x rounded to nearest, ties away from zero (cvt.rna.tf32.f32
// for a finite x: ptxas lowers that to this add behind a NaN guard, three
// instructions and a predicate), and lo = x - hi, exact in f32, is
// truncated to TF32 (|lo| <= 2^-11 |x|, so the cut is < 2^-21 |x|). One
// integer add, one mask and one f32 subtraction an element.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}
__device__ __forceinline__ void split_tf32(const unsigned (&x)[4],
                                           unsigned (&hi)[4],
                                           unsigned (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(x[e]), hi[e], lo[e]);
}

// c (16 x 8 f32) += a (16 x 8 tf32, row) * b (8 x 8 tf32, col). Not
// volatile: a pure function of its operands, which the compiler may
// schedule between the other tiles' products.
__device__ __forceinline__ void mma1688(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Split TF32 on two n8 tiles that share the A operand: c0 += a b (b0,
// b1 of b's hi and lo words), c1 += a b' (b0', b1'); the small terms
// first, the two tiles' products interleaved so that no product waits on
// the one before it.
__device__ __forceinline__ void mma3x2(float (&c0)[4], float (&c1)[4],
                                       const unsigned (&ah)[4],
                                       const unsigned (&al)[4],
                                       const unsigned (&bh)[4],
                                       const unsigned (&bl)[4]) {
  // bh / bl: {b0, b1} of the first tile, then of the second
  mma1688(c0, al, bh[0], bh[1]);
  mma1688(c1, al, bh[2], bh[3]);
  mma1688(c0, ah, bl[0], bl[1]);
  mma1688(c1, ah, bl[2], bl[3]);
  mma1688(c0, ah, bh[0], bh[1]);
  mma1688(c1, ah, bh[2], bh[3]);
}

// Two floats from shared memory (a shared-window address, 8-byte aligned)
__device__ __forceinline__ float2 lds2(unsigned a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

// Fragment addresses within a padded f32 tile, for this lane:
//   A of a 16 x 8 block (rows = M, columns = K): matrices rows 0-7 / 8-15
//   x columns 0-3 / 4-7, registers {a0, a1, a2, a3};
__device__ __forceinline__ int frag_a32(int row0, int col0, int lane,
                                        int ld) {
  return (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0
         + (lane >> 4) * 4;
}
//   B of two n8 tiles from a tile whose rows are N and columns K
//   (registers: b0, b1 of the first n8 tile, then of the second).
__device__ __forceinline__ int frag_b32(int n0, int k0, int lane, int ld) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0
         + ((lane >> 3) & 1) * 4;
}

// In place, the words of a resident padded f32 tile (every thread of the
// block a share) become their split_tf32 hi parts, and the tile after it
// (lo = hi + tf32_tile) gets the lo parts: split once for the block's
// whole loop instead of at every product in every warp.
template <int D, int kThreadsN>
__device__ __forceinline__ void split_tile(float* hi) {
  constexpr int kChunks = D / 4;
  float* lo = hi + tf32_tile<D>();
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreadsN) {
    const int off = (c / kChunks) * tf32_ld<D>() + (c % kChunks) * 4;
    float4 x = *reinterpret_cast<float4*>(hi + off), l;
    unsigned h[4], w[4];
    split_tf32(x.x, h[0], w[0]);
    split_tf32(x.y, h[1], w[1]);
    split_tf32(x.z, h[2], w[2]);
    split_tf32(x.w, h[3], w[3]);
    x = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    l = make_float4(__uint_as_float(w[0]), __uint_as_float(w[1]),
                    __uint_as_float(w[2]), __uint_as_float(w[3]));
    *reinterpret_cast<float4*>(hi + off) = x;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// c[j] (the n8 tile of B rows 8j..8j+7) += A[0..16)[0..D) . B[0..N)[0..D)^T
// in split TF32, reduced over D: A at this warp's 16 rows of a resident
// tile already split (split_tile: hi words at A, lo at A + tf32_tile), B
// at the first of N rows of a streamed padded f32 tile, split here.
template <int D, int N>
__device__ __forceinline__ void tf32_nt(float (&c)[N / 8][4], const float* A,
                                        const float* B, int lane) {
  constexpr int kLd = tf32_ld<D>();
  // one base register each, every fragment an immediate offset from it
  const unsigned aa = opaque(smem_addr(A + frag_a32(0, 0, lane, kLd)));
  const unsigned ba = opaque(smem_addr(B + frag_b32(0, 0, lane, kLd)));
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    unsigned ah[4], al[4], bb[N / 16][4];
    ldsm_x4(ah, aa + 4 * 8 * kk);
    ldsm_x4(al, aa + 4 * (tf32_tile<D>() + 8 * kk));
#pragma unroll
    for (int np = 0; np < N / 16; ++np)
      ldsm_x4(bb[np], ba + 4 * (16 * np * kLd + 8 * kk));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      unsigned bh[4], bl[4];
      split_tf32(bb[np], bh, bl);
      mma3x2(c[2 * np], c[2 * np + 1], ah, al, bh, bl);
    }
  }
}

// c (16 x D, paired columns) += P . B[0..N)[0..D) in split TF32: P is this
// lane's m16n8 fragments of the previous product (16 rows x N, its
// columns the reduction axis, relabelled: a = {c0, c2, c1, c3}), split
// once; B a padded f32 tile in shared memory at the first of its N rows,
// read as float2 from rows 2t and 2t + 1 of each 8-row k-block. The
// tensor core rounds its f32 sums toward zero, so a long chain of
// products into one accumulator drifts (~n 2^-24 of it after n products:
// 4e-4 on dv over a 4,096-query group): the products of this P go into
// fresh registers, 4 n8 tiles (kGroup column pairs) at a time, and are
// added into c in f32, rounded to nearest.
template <int D, int N>
__device__ __forceinline__ void tf32_pk(float (&c)[D / 8][4],
                                        const float (&p)[N / 8][4],
                                        const float* B, int lane) {
  constexpr int kLd = tf32_ld<D>();
  constexpr int kGroup = 2;
  const unsigned bp =
      opaque(smem_addr(B + 2 * (lane & 3) * kLd + 2 * (lane >> 2)));
  unsigned ah[N / 8][4], al[N / 8][4];
#pragma unroll
  for (int kb = 0; kb < N / 8; ++kb) {
    split_tf32(p[kb][0], ah[kb][0], al[kb][0]);
    split_tf32(p[kb][2], ah[kb][1], al[kb][1]);
    split_tf32(p[kb][1], ah[kb][2], al[kb][2]);
    split_tf32(p[kb][3], ah[kb][3], al[kb][3]);
  }
#pragma unroll
  for (int g0 = 0; g0 < D / 16; g0 += kGroup) {
    float t[2 * kGroup][4];
    zero_frags(t);
#pragma unroll
    for (int kb = 0; kb < N / 8; ++kb) {
      float2 x[kGroup][2];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const unsigned row = bp + 4 * (8 * kb * kLd + 16 * (g0 + i));
        x[i][0] = lds2(row);
        x[i][1] = lds2(row + 4 * kLd);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        unsigned bh[4], bl[4];  // {b0, b1} of tile 2i, then of 2i + 1
        split_tf32(x[i][0].x, bh[0], bl[0]);
        split_tf32(x[i][1].x, bh[1], bl[1]);
        split_tf32(x[i][0].y, bh[2], bl[2]);
        split_tf32(x[i][1].y, bh[3], bl[3]);
        mma3x2(t[2 * i], t[2 * i + 1], ah[kb], al[kb], bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * kGroup; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[2 * g0 + i][e] += t[i][e];
  }
}

// This lane's 4 neighbouring columns 16p + 4 (lane % 4) + {0..3} of row
// lane / 4 + 8i, from accumulators in the paired-column layout.
template <int D>
__device__ __forceinline__ float4 paired_cols(const float (&acc)[D / 8][4],
                                              int p, int i) {
  return make_float4(acc[2 * p][2 * i], acc[2 * p + 1][2 * i],
                     acc[2 * p][2 * i + 1], acc[2 * p + 1][2 * i + 1]);
}

// row[16 p + 4 (lane % 4) + {0..3}] = (kAdd: row[...] +) this lane's
// paired-column accumulators of row i (0: lane / 4, 1: + 8), for column
// pairs p in [P0, P1), one float4 per 16 columns.
template <bool kAdd, int D, int P0, int P1>
__device__ __forceinline__ void put_paired_row(float* row,
                                               const float (&acc)[D / 8][4],
                                               int i) {
  row += 4 * (threadIdx.x % 4);
#pragma unroll
  for (int p = P0; p < P1; ++p) {
    float4* ptr = reinterpret_cast<float4*>(row + 16 * p);
    float4 a = paired_cols<D>(acc, p, i);
    if (kAdd) {
      const float4 x = *ptr;
      a = make_float4(x.x + a.x, x.y + a.y, x.z + a.z, x.w + a.w);
    }
    *ptr = a;
  }
}

// This lane's paired-column accumulators of row i (0: lane / 4, 1: + 8)
// from row[16 p + 4 (lane % 4) + {0..3}], for every column pair: the
// inverse of put_paired_row.
template <int D>
__device__ __forceinline__ void get_paired_row(const float* row,
                                               float (&acc)[D / 8][4],
                                               int i) {
  row += 4 * (threadIdx.x % 4);
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(row + 16 * p);
    acc[2 * p][2 * i] = a.x;
    acc[2 * p + 1][2 * i] = a.y;
    acc[2 * p][2 * i + 1] = a.z;
    acc[2 * p + 1][2 * i + 1] = a.w;
  }
}

// Start copying rows [first, first + kRowsN) of a 64-row f32 tile (row
// stride `st` floats in device memory, D contiguous; `src` is the tile's
// row 0, always a valid address) into a padded shared tile, kThreadsN
// threads sharing the 16-byte chunks; rows past `valid` become zeros.
template <int D, int kRowsN, int kThreadsN>
__device__ __forceinline__ void cp_rows32(float* dst,
                                          const float* __restrict__ src,
                                          long long st, int first,
                                          int valid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  static_assert(kRowsN * kChunks % kThreadsN == 0, "whole chunks a thread");
  // opaque: the addresses are computed here, at each copy, and not kept
  // in registers across the main loop
  const int tid = static_cast<int>(opaque(threadIdx.x));
#pragma unroll
  for (int i = 0; i < kRowsN * kChunks / kThreadsN; ++i) {
    const int c = tid + i * kThreadsN;
    const int r = first + c / kChunks;
    const int e = (c % kChunks) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * tf32_ld<D>() + e, ok ? src + r * st + e : src, ok);
  }
}

// Start copying lse and delta of query rows [first, first + kHalf) of a
// tile (rows past `valid` zero-filled): threads 0-31 lse, 32-63 delta.
__device__ __forceinline__ void cp_stats(float* sL, float* sDel,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         long long row0, int first,
                                         int valid) {
  if (threadIdx.x >= 2 * kHalf) return;
  const int i = first + threadIdx.x % kHalf;
  const bool ok = i < valid;
  const float* src = threadIdx.x < kHalf ? lse : delta;
  float* dst = threadIdx.x < kHalf ? sL : sDel;
  cp_async4(dst + i, src + row0 + (ok ? i : 0), ok);
}

// Start copying half hf (rows hf kHalf ..) of key tile kt of K and V (kb,
// vb: the KV head's row 0).
template <int D>
__device__ __forceinline__ void load_kv_half(float* sK, float* sV,
                                             const float* __restrict__ kb,
                                             const float* __restrict__ vb,
                                             const Geom& g, int kt, int hf) {
  const int k0 = kt * kTile;
  cp_rows32<D, kHalf, kTf32Threads>(sK, kb + k0 * g.k_st, g.k_st,
                                    hf * kHalf, g.Tk - k0);
  cp_rows32<D, kHalf, kTf32Threads>(sV, vb + k0 * g.v_st, g.v_st,
                                    hf * kHalf, g.Tk - k0);
}

// Start copying half hf of query tile q0 of head h, batch b: Q, dO and
// the rows' lse and delta.
template <int D>
__device__ __forceinline__ void load_q_half(
    float* sQ, float* sDO, float* sL, float* sDel,
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Geom& g, int b, int h, int q0, int hf) {
  cp_rows32<D, kHalf, kTf32Threads>(sQ, q + b * g.q_sb + q0 * g.q_st +
                                           h * g.q_sh,
                                   g.q_st, hf * kHalf, g.Tq - q0);
  cp_rows32<D, kHalf, kTf32Threads>(sDO, dout + b * g.do_sb + q0 * g.do_st +
                                            h * g.do_sh,
                                   g.do_st, hf * kHalf, g.Tq - q0);
  cp_stats(sL, sDel, lse, delta,
           (static_cast<long long>(b) * g.H + h) * g.Tq + q0, hf * kHalf,
           g.Tq - q0);
}

// ---------------------------------------------------------------- forward
// Fold every live key tile of KV head h / group into the online-softmax
// state of query tile q0 of head h, batch b: the key loop of an f32
// forward kernel (flash_fwd_tf32_mma_kernel, ring_fwd_tf32_mma_kernel), on
// kTf32Threads threads. q, k, v are the arrays' bases. Warp w takes query
// rows 16 (w % 4) + lane / 4 and + 8; Q stays resident, split once
// (split_tile); each key tile runs in two halves of kHalf keys, warps 0-3
// taking the first 16 of a half and warps 4-7 the other 16 (S = Q K^T,
// fwd_scores, acc += P V, paired columns), and when a half is done its
// rows of K and V are refilled with the next tile's, under the other
// half.
// m, l and acc hold each warp's own state on entry (the flash kernels
// start empty; the ring kernel gives its carry to warps 0-3 and starts
// warps 4-7 empty) and, on return, the pair's merged state: m and l of
// its rows in both warps, acc of columns 0 .. D/2 (acc[0 .. D/16)) in
// warps 0-3 and of D/2 .. D (acc[D/16 .. D/8)) in warps 4-7, the other
// half of acc left partial.
template <int D>
__device__ __forceinline__ void fwd_tf32_fold(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const Geom& g, int b, int h, int q0,
    float scale, float (&m)[2], float (&l)[2], float (&acc)[D / 8][4]) {
  constexpr int kLd = tf32_ld<D>();
  constexpr int kT = tf32_tile<D>();
  constexpr int kHalfJ = D / 16;
  constexpr int kSlot = D / 4 + 4;  // floats a thread sends: half of acc, m, l
  static_assert(kTf32Threads * kSlot <= 2 * kT, "the merge fits Q");
  float* sQ = smem;                          // hi, then lo
  float* sK = sQ + 2 * kT;
  float* sV = sK + kT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wk = warp / 4;
  const int tq = lane & 3;
  const int hk = h / (g.H / g.Hkv);
  int lo, hi;
  live_tiles(q0, true, g, lo, hi);

  const float* kb = k + b * g.k_sb + hk * g.k_sh;
  const float* vb = v + b * g.v_sb + hk * g.v_sh;
  // groups: {Q, half 0 of K and V}, then {half 1}
  if (lo <= hi) {
    cp_rows32<D, kTile, kTf32Threads>(
        sQ, q + b * g.q_sb + q0 * g.q_st + h * g.q_sh, g.q_st, 0, g.Tq - q0);
    load_kv_half<D>(sK, sV, kb, vb, g, lo, 0);
  }
  cp_async_commit();
  if (lo <= hi) load_kv_half<D>(sK, sV, kb, vb, g, lo, 1);
  cp_async_commit();
  if (lo <= hi) {  // block-uniform
    cp_async_wait<1>();
    __syncthreads();  // Q has landed
    split_tile<D, kTf32Threads>(sQ);
  }

  const int r0 = q0 + 16 * wr + (lane >> 2);  // this lane's rows r0, r0 + 8
  const float scale2 = scale * kLog2e;
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    const bool full = tile_full(q0, k0, g);
#pragma unroll 1  // one half at a time
    for (int hf = 0; hf < 2; ++hf) {
      const int ks = hf * kHalf + 16 * wk;  // this warp's 16 keys
      cp_async_wait<1>();
      __syncthreads();  // this half's rows have landed
      float s[2][4], corr[2];
      zero_frags(s);
      tf32_nt<D, 16>(s, sQ + 16 * wr * kLd, sK + ks * kLd, lane);
      if (full)
        fwd_scores<true, true>(s, r0, k0 + ks, tq, scale, scale2, m, l, corr,
                               g);
      else
        fwd_scores<false, true>(s, r0, k0 + ks, tq, scale, scale2, m, l,
                                corr, g);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      tf32_pk<D, 16>(acc, s, sV + ks * kLd, lane);

      __syncthreads();  // every warp is done with this half's rows
      if (kt < hi) load_kv_half<D>(sK, sV, kb, vb, g, kt + 1, hf);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done

  // the merge: warp (wr, wk) sends its m, l and the half of acc its
  // partner keeps, element e of lane l at [slot][e][l] (constant indices
  // in each branch: a register array indexed at run time would live in
  // local memory); both warps then hold the same m and l (the merge is
  // symmetric)
  float* mine = sQ + (wk * 4 + wr) * kSlot * 32 + lane;
  const float* theirs = sQ + ((1 - wk) * 4 + wr) * kSlot * 32 + lane;
#pragma unroll
  for (int j = 0; j < kHalfJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mine[(4 * j + e) * 32] = wk == 0 ? acc[kHalfJ + j][e] : acc[j][e];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mine[(D / 4 + i) * 32] = m[i];
    mine[(D / 4 + 2 + i) * 32] = l[i];
  }
  __syncthreads();
  float c_mine[2], c_theirs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_t = theirs[(D / 4 + i) * 32];
    const float m_new = fmaxf(m[i], m_t);
    c_mine[i] = exp2f((m[i] - m_new) * kLog2e);
    c_theirs[i] = exp2f((m_t - m_new) * kLog2e);
    l[i] = l[i] * c_mine[i] + theirs[(D / 4 + 2 + i) * 32] * c_theirs[i];
    m[i] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kHalfJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = theirs[(4 * j + e) * 32] * c_theirs[e >> 1];
      if (wk == 0)
        acc[j][e] = acc[j][e] * c_mine[e >> 1] + y;
      else
        acc[kHalfJ + j][e] = acc[kHalfJ + j][e] * c_mine[e >> 1] + y;
    }
}

// --------------------------------------------------------------------- dq
// dq of query tile q0 of head h, batch b, against every live key tile of
// KV head h / group: the key loop of an f32 dq kernel
// (flash_dq_tf32_mma_kernel, ring_dq_tf32_mma_kernel), on kTf32Threads
// threads. q, k, v, dout are
// the arrays' bases. Warp w takes query rows 16 (w % 4) + lane / 4 and +
// 8; Q and dO stay resident, split once (split_tile); each key tile runs
// in two halves of kHalf keys, warps 0-3 taking the first 16 of a half
// and warps 4-7 the other 16 (S = Q K^T and dP = dO V^T, dq_scores, dQ +=
// dS K, paired columns), and when a half is done its rows of K and V are
// refilled with the next tile's, under the other half. At the end the two warps of each query
// row exchange halves of their sums through Q's freed hi and lo copies,
// in f32: on return warps 0-3 hold the whole dq of their rows' columns
// 0 .. D/2 (acc[0 .. D/16)) and warps 4-7 of columns D/2 .. D (acc[D/16
// .. D/8)); the other half of acc is left partial.
template <int D>
__device__ __forceinline__ void dq_tf32_fold(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Geom& g, int b, int h, int q0, float scale,
    float (&acc)[D / 8][4]) {
  constexpr int kLd = tf32_ld<D>();
  constexpr int kT = tf32_tile<D>();
  constexpr int kSend = D / 4;  // floats a thread sends: half of acc
  static_assert(kTf32Threads * kSend <= 2 * kT, "the exchange fits Q");
  float* sQ = smem;          // hi, then lo
  float* sDO = sQ + 2 * kT;  // hi, then lo
  float* sK = sDO + 2 * kT;
  float* sV = sK + kT;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wk = warp / 4;
  const int gr = lane >> 2, tq = lane & 3;
  const int hk = h / (g.H / g.Hkv);
  int lo, hi;
  live_tiles(q0, true, g, lo, hi);

  const float* kb = k + b * g.k_sb + hk * g.k_sh;
  const float* vb = v + b * g.v_sb + hk * g.v_sh;
  // groups: {Q, dO, half 0 of K and V}, then {half 1}
  if (lo <= hi) {
    cp_rows32<D, kTile, kTf32Threads>(
        sQ, q + b * g.q_sb + q0 * g.q_st + h * g.q_sh, g.q_st, 0, g.Tq - q0);
    cp_rows32<D, kTile, kTf32Threads>(
        sDO, dout + b * g.do_sb + q0 * g.do_st + h * g.do_sh, g.do_st, 0,
        g.Tq - q0);
    load_kv_half<D>(sK, sV, kb, vb, g, lo, 0);
  }
  cp_async_commit();
  if (lo <= hi) load_kv_half<D>(sK, sV, kb, vb, g, lo, 1);
  cp_async_commit();
  if (lo <= hi) {  // block-uniform
    cp_async_wait<1>();
    __syncthreads();  // Q and dO have landed
    split_tile<D, kTf32Threads>(sQ);
    split_tile<D, kTf32Threads>(sDO);
  }

  // this lane's two query rows, r0 and r0 + 8
  const int r0 = q0 + 16 * wr + gr;
  const long long row0 = (static_cast<long long>(b) * g.H + h) * g.Tq;
  float lse2[2], del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    lse2[i] = qi < g.Tq ? lse[row0 + qi] * kLog2e : 0.f;
    del[i] = qi < g.Tq ? delta[row0 + qi] : 0.f;
  }
  const float scale2 = scale * kLog2e;
  zero_frags(acc);

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    const bool full = tile_full(q0, k0, g);
#pragma unroll 1  // one half at a time
    for (int hf = 0; hf < 2; ++hf) {
      const int ks = hf * kHalf + 16 * wk;  // this warp's 16 keys
      cp_async_wait<1>();
      __syncthreads();  // this half's rows have landed
      float s[2][4], dp[2][4];
      zero_frags(s);
      zero_frags(dp);
      tf32_nt<D, 16>(s, sQ + 16 * wr * kLd, sK + ks * kLd, lane);
      tf32_nt<D, 16>(dp, sDO + 16 * wr * kLd, sV + ks * kLd, lane);
      if (full)
        dq_scores<true>(s, dp, r0, k0 + ks, tq, lse2, del, scale2, scale, g);
      else
        dq_scores<false>(s, dp, r0, k0 + ks, tq, lse2, del, scale2, scale,
                         g);
      tf32_pk<D, 16>(acc, s, sK + ks * kLd, lane);

      __syncthreads();  // every warp is done with this half's rows
      if (kt < hi) load_kv_half<D>(sK, sV, kb, vb, g, kt + 1, hf);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done

  // the exchange: warp (wr, wk) sends the half of acc its partner keeps,
  // element e of lane l at [slot][e][l] (constant indices in each branch:
  // a register array indexed at run time would live in local memory)
  float* mine = sQ + (wk * 4 + wr) * kSend * 32 + lane;
  const float* theirs = sQ + ((1 - wk) * 4 + wr) * kSend * 32 + lane;
  constexpr int kHalfJ = D / 16;
#pragma unroll
  for (int j = 0; j < kHalfJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mine[(4 * j + e) * 32] = wk == 0 ? acc[kHalfJ + j][e] : acc[j][e];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kHalfJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = theirs[(4 * j + e) * 32];
      if (wk == 0)
        acc[j][e] += y;
      else
        acc[kHalfJ + j][e] += y;
    }
}

// The epilogue of an f32 dq or forward kernel: the block's query rows, as
// dq_tf32_fold and fwd_tf32_fold leave them (warps 0-3 hold columns 0 ..
// D/2 of their rows, warps 4-7 the rest), stored (kAdd false: the flash
// kernels' dq or o, the ring forward's carry) or added (true: the ring's
// travelling dq) into out (B, Tq, H, D) f32. The addresses are derived
// afresh (opaque), so that none stays live across the fold's main loop.
template <bool kAdd, int D>
__device__ __forceinline__ void query_tile_epilogue(float* out,
                                                 const float (&acc)[D / 8][4],
                                                 const Geom& g, int b, int h,
                                                 int q0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * (warp % 4) + (lane >> 2);
  const int be = static_cast<int>(opaque(b)), he = static_cast<int>(opaque(h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= g.Tq) continue;
    float* row =
        out + ((static_cast<long long>(be) * g.Tq + qi) * g.H + he) * D;
    if (warp < 4)
      put_paired_row<kAdd, D, 0, D / 32>(row, acc, i);
    else
      put_paired_row<kAdd, D, D / 32, D / 16>(row, acc, i);
  }
}

// ------------------------------------------------------------------ dk/dv
// dk and dv of key tile k0 of KV head hk, batch b, summed over the GQA
// group's query heads and their live query tiles: the query loop of an
// f32 dk/dv kernel (flash_dkv_tf32_mma_kernel, ring_dkv_tf32_mma_kernel),
// on kTf32Threads threads.
// Warp w takes key rows 16 (w % 4) + lane / 4 and + 8; K and V stay
// resident, split once (split_tile); each query tile runs in two halves
// of kHalf queries, warps 0-3 taking the first 16 of a half and warps 4-7
// the other 16 (S^T = K Q^T and dP^T = V dO^T, dkv_scores, dV += P^T dO,
// dK += dS^T Q, paired columns), and when a half is done its rows of Q,
// dO, lse and delta are refilled with the next iteration's, under the
// other half. At the end
// the two warps of each key row exchange halves of their sums through
// the freed Q and dO buffers, in f32: on return warps 0-3 hold the whole
// dk_acc and warps 4-7 the whole dv_acc of their rows (the other array
// is left partial). Each warp holds dk and dv (2 x 64 registers at D =
// 128) and a 16 x 16 score tile of each kind (8 + 8); 4 warps with
// 16 x 32 score tiles took 255 registers and spilled.
template <int D>
__device__ __forceinline__ void dkv_tf32_fold(
    float* smem, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Geom& g, int b, int hk, int k0, float scale,
    float (&dk_acc)[D / 8][4], float (&dv_acc)[D / 8][4]) {
  constexpr int kLd = tf32_ld<D>();
  constexpr int kT = tf32_tile<D>();
  constexpr int kAcc = D / 2;  // accumulator floats a thread, each array
  static_assert(kTf32Threads * kAcc <= 2 * kT, "the exchange fits Q and dO");
  float* sK = smem;         // hi, then lo
  float* sV = sK + 2 * kT;  // hi, then lo
  float* sQ = sV + 2 * kT;
  float* sDO = sQ + kT;
  float* sL = sDO + kT;
  float* sDel = sL + kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp % 4, wq = warp / 4;
  const int gr = lane >> 2, tq = lane & 3;
  const int group = g.H / g.Hkv;
  int lo, hi;
  live_tiles(k0, false, g, lo, hi);
  const int n_live = hi - lo + 1;
  const int n_it = n_live > 0 ? group * n_live : 0;

  // iteration it: query head hk * group + it / n_live, tile lo + it %
  // n_live; groups: {K, V, half 0}, then {half 1}
  if (n_it > 0) {
    cp_rows32<D, kTile, kTf32Threads>(
        sK, k + b * g.k_sb + k0 * g.k_st + hk * g.k_sh, g.k_st, 0, g.Tk - k0);
    cp_rows32<D, kTile, kTf32Threads>(
        sV, v + b * g.v_sb + k0 * g.v_st + hk * g.v_sh, g.v_st, 0, g.Tk - k0);
    load_q_half<D>(sQ, sDO, sL, sDel, q, dout, lse, delta, g, b, hk * group,
                   lo * kTile, 0);
  }
  cp_async_commit();
  if (n_it > 0)
    load_q_half<D>(sQ, sDO, sL, sDel, q, dout, lse, delta, g, b, hk * group,
                   lo * kTile, 1);
  cp_async_commit();
  if (n_it > 0) {  // block-uniform
    cp_async_wait<1>();
    __syncthreads();  // K and V have landed
    split_tile<D, kTf32Threads>(sK);
    split_tile<D, kTf32Threads>(sV);
  }

  const int kr0 = k0 + 16 * wk + gr;  // this lane's key rows kr0, kr0 + 8
  const float scale2 = scale * kLog2e;
  zero_frags(dk_acc);
  zero_frags(dv_acc);

  for (int it = 0; it < n_it; ++it) {
    const int q0 = (lo + it % n_live) * kTile;
    const bool full = tile_full(q0, k0, g);
#pragma unroll 1  // one half at a time
    for (int hf = 0; hf < 2; ++hf) {
      const int qs = hf * kHalf + 16 * wq;  // this warp's 16 queries
      cp_async_wait<1>();
      __syncthreads();  // this half's rows have landed
      float s[2][4], dp[2][4];
      zero_frags(s);
      zero_frags(dp);
      tf32_nt<D, 16>(s, sK + 16 * wk * kLd, sQ + qs * kLd, lane);
      tf32_nt<D, 16>(dp, sV + 16 * wk * kLd, sDO + qs * kLd, lane);
      if (full)
        dkv_scores<true>(s, dp, kr0, q0, qs, tq, sL, sDel, scale2, scale, g);
      else
        dkv_scores<false>(s, dp, kr0, q0, qs, tq, sL, sDel, scale2, scale,
                          g);
      tf32_pk<D, 16>(dv_acc, s, sDO + qs * kLd, lane);
      tf32_pk<D, 16>(dk_acc, dp, sQ + qs * kLd, lane);

      __syncthreads();  // every warp is done with this half's rows
      if (it + 1 < n_it)
        load_q_half<D>(sQ, sDO, sL, sDel, q, dout, lse, delta, g, b,
                       hk * group + (it + 1) / n_live,
                       (lo + (it + 1) % n_live) * kTile, hf);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done

  // the exchange: warp (wk, wq) sends the array its partner keeps (dv
  // from warps 0-3, dk from 4-7), element e of lane l at [slot][e][l]
  float* x = sQ;
  float* mine = x + (wq * 4 + wk) * kAcc * 32 + lane;
  const float* theirs = x + ((1 - wq) * 4 + wk) * kAcc * 32 + lane;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mine[(4 * j + e) * 32] = wq == 0 ? dv_acc[j][e] : dk_acc[j][e];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = theirs[(4 * j + e) * 32];
      if (wq == 0)
        dk_acc[j][e] += y;
      else
        dv_acc[j][e] += y;
    }
}


// The epilogue of an f32 dk/dv kernel: the block's key rows, as
// dkv_tf32_fold leaves them (warps 0-3 hold dk, warps 4-7 dv), stored
// (kAdd false) or added (true) into dk and dv (B, Tk, H_kv, D) f32, from
// addresses derived afresh (opaque).
template <bool kAdd, int D>
__device__ __forceinline__ void dkv_tf32_epilogue(
    float* dk, float* dv, const float (&dk_acc)[D / 8][4],
    const float (&dv_acc)[D / 8][4], const Geom& g, int b, int hk, int k0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kr0 = k0 + 16 * (warp % 4) + (lane >> 2);
  const int be = static_cast<int>(opaque(b));
  const int hke = static_cast<int>(opaque(hk));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kr0 + 8 * i;
    if (kj >= g.Tk) continue;
    const long long off =
        ((static_cast<long long>(be) * g.Tk + kj) * g.Hkv + hke) * D;
    if (warp < 4)
      put_paired_row<kAdd, D, 0, D / 16>(dk + off, dk_acc, i);
    else
      put_paired_row<kAdd, D, 0, D / 16>(dv + off, dv_acc, i);
  }
}

}  // namespace
