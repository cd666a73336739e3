// Tensor-core tiles of the bf16 flash attention (flash_attention.cu) and
// of the bf16 ring flash attention (ring_flash.cu).
//
// Replaces, for bf16 inputs: akka_allreduce_tpu/ops/pallas_kernels/
// attention.py _fwd_kernel (:113), _dq_kernel (:153) and _dkv_kernel
// (:184), whose tile arithmetic is _softmax_tile (:79) and _bwd_tile
// (:99), and ring_flash.py _ring_fwd_kernel (:61), _ring_dq_kernel (:94)
// and _ring_dkv_kernel (:121), the same tiles on one hop's block with f32
// carries and accumulators. One fold per product serves the flash and the
// ring kernel: fwd_mma_fold, dq_mma_fold, dkv_mma_fold; each kernel adds
// only its epilogue (the flash kernels store bf16, the ring's read and
// write their f32 state in the fragments' layout). In f32 every flash and
// ring kernel runs flash_tf32.cuh's split-TF32 folds (the forward's
// online softmax is fwd_scores, shared with the bf16 forward here).
//
// Bound: ~4 (forward), ~6 (dq) and ~8 (dk/dv) flops per head-dim element
// of every live (q, k) pair, hundreds of flops per byte moved, so the
// tensor cores' 989 TFLOP/s (bf16, dense) bound every kernel here (the
// ring's f32 carry and accumulators add 8 bytes a head-dim element of q,
// or of k and v, read and written once: well under the operations' time).
// These tiles put every product on the tensor cores:
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 in inline PTX:
//     bf16 operands, f32 accumulators, exactly the Pallas kernels' cast
//     points (s in f32, l summed from the unrounded f32 p, p and ds
//     rounded to bf16 only as operands of the second products,
//     preferred_element_type=f32 everywhere); only the order of the f32
//     sums differs.
//   * Operands reach the tensor cores through ldmatrix (x4: four 8x8
//     matrices a warp), .trans where the product's reduction axis is the
//     row axis of the shared-memory tile (V in o += p V; K in dq += ds K;
//     Q and dO in dk += ds^T Q and dv += p^T dO). Shared-memory rows are
//     padded by 16 bytes, so the 8 row addresses of each 8x8 matrix fall
//     in 8 different 16-byte bank groups: no bank conflicts.
//   * The score tiles never touch shared memory: an m16n8 accumulator
//     pair is the m16k16 A fragment of the next product once rounded to
//     bf16 and packed two to a register (FlashAttention-2's layout).
//   * The streamed operand is copied by cp.async (16 bytes a thread;
//     lse/delta 4 bytes, the rows need not be 16-byte aligned) under the
//     products: in dq (K/V tiles) and dk/dv (Q/dO tiles with their lse
//     and delta) double-buffered, the next tile's copy under the current
//     tile's products; in the forward one buffer each of K and V, a
//     tile's V copied under its S = Q K^T and the next tile's K under
//     O += P V, so three blocks fit an SM. Rows past T are zero-filled by
//     the copy itself (src-size 0).
//
// Work layout: 64-row tiles, 4 warps (128 threads); warp w owns rows
// 16w..16w+15 of the block's own tile (query rows in the forward and dq,
// key rows in dk/dv). Blocks as flash_tiles.cuh lays them out: forward
// and dq one per (query tile, query head, batch), walking the live key tiles
// (dq the longest causal bands first); dk/dv one per (key tile, KV head,
// batch), walking the GQA group x live query tiles, so dk and dv sum over
// the group in f32 registers and are written once (no atomics: the result
// is deterministic). The causal / window mask leaves a contiguous band
// of live tiles (tile_live), and only that band is loaded; masked lanes
// get p = 0 exactly (the where-guard: in the forward a row whose live
// keys all lie in later tiles keeps p = 0 and its state unchanged; in
// the backward exp(NEG_INF - lse) is 0), lanes past Tk are masked, rows
// past Tq contribute nothing and are neither read from a carry nor
// stored. A tile whose pairs are all live (tile_full) skips the
// per-element mask.
//
// Registers per thread (ptxas -v, sm_90a; no spills accepted; the flash
// and the ring kernel of each fold take the same count, except where
// said):
//   forward, D = 128: 168 under __launch_bounds__(128, 3), three blocks
//          an SM (the O accumulator 16 x 128 f32 a warp = 64, S 16 x 64
//          = 32, one step's Q and K fragments 4 + 16; Q is re-read from
//          shared memory at each k-step, and the fragment addresses are
//          immediates off one opaque base a tile: with Q's fragments
//          kept in registers the forward took 223); D = 64: 174 (flash)
//          and 176 (ring), two blocks an SM; D = 32: what the registers
//          give.
//   dq,    D = 128: 226 (the dq accumulator 16 x 128 f32 a warp = 64, S
//          and dP 16 x 64 f32 = 32 + 32, one step's K and V fragments
//          32, loaded together ahead of their products); D = 64: 128.
//   dk/dv, D = 128: 244 (the dk and dv accumulators 2 x 64; S^T and dP^T
//          over half the query tile at a time, kSubQ = 32 columns, 16 +
//          16, the halves kept apart by "#pragma unroll 1": unrolled,
//          ptxas spilled at 255); D = 64: 188.
//   The ring's epilogues read and write their f32 state only after the
//   fold, from addresses derived afresh (opaque), so they add nothing to
//   the main loop's live registers (an address kept across the fold cost
//   the ring forward a 16-byte spill).
// Shared memory: forward Q, K, V; dq Q, dO + 2 x (K, V); dk/dv K, V + 2 x
// (Q, dO, lse, delta): 52,224 / 104,448 / 105,472 bytes at D = 128 (three
// forward blocks an SM, two of the others), 27,648 / 55,296 / 56,320 at
// D = 64, 15,360 / 30,720 / 31,744 at D = 32.
//
// Head dims 32, 64 and 128 (the CLI's default model has D = 32): the
// products that walk D in 16-column steps take min(4, D / 16) steps a
// group (kNGroup).

#pragma once

#include "flash_tiles.cuh"

namespace {

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// padded shared-memory row of a D-wide bf16 tile (16 bytes of padding)
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }
template <int D>
__host__ __device__ constexpr int mma_tile() { return kTile * mma_ld<D>(); }

template <int D>
constexpr size_t fwd_mma_smem() {
  return 3 * static_cast<size_t>(mma_tile<D>()) * sizeof(bf16);
}
// The forwards' blocks an SM that the launch bounds ask for: at D = 128
// three (168 registers a thread, and 3 x 52,224 bytes of shared memory),
// at D = 64 and 32 what the registers give unasked.
template <int D>
constexpr int fwd_mma_min_blocks() { return D == 128 ? 3 : 1; }
template <int D>
constexpr size_t dq_mma_smem() {
  return 6 * static_cast<size_t>(mma_tile<D>()) * sizeof(bf16);
}
template <int D>
constexpr size_t dkv_mma_smem() {
  return 6 * static_cast<size_t>(mma_tile<D>()) * sizeof(bf16)
         + 4 * kTile * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying rows [0, valid) of a 64-row tile (row stride `st`
// elements in device memory, D contiguous) into a padded shared tile;
// rows past `valid` become zeros. `src` row 0 is always a valid address.
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* __restrict__ src,
                                        long long st, int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(kTile * kChunks % kMmaThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * mma_ld<D>() + e, ok ? src + r * st + e : src, ok);
  }
}

// Start copying a query tile's 64 f32 lse and delta values (rows past Tq
// zero-filled): threads 0-63 lse, 64-127 delta.
__device__ __forceinline__ void cp_rows(float* sL, float* sDel,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        long long row0, int valid) {
  const int i = threadIdx.x % kTile;
  const float* src = threadIdx.x < kTile ? lse : delta;
  float* dst = threadIdx.x < kTile ? sL : sDel;
  const bool ok = i < valid;
  cp_async4(dst + i, src + row0 + (ok ? i : 0), ok);
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8m..8m+7 address matrix m); register m is this lane's pair of
// matrix m: row lane/4, columns 2(lane%4), +1 (.trans: the transpose's).
// The address is a shared-window address (smem_addr) or a generic
// pointer into shared memory.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  ldsm_x4(r, smem_addr(p));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  ldsm_x4_t(r, smem_addr(p));
}

// x, which the compiler may no longer treat as known: a per-lane base
// address taken through it inside a loop stays one register, and each
// fragment's offset from it an immediate of the ldmatrix, instead of
// every fragment address being hoisted out of the loop into a register
// of its own.
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// 2^x for the forward's softmax: ex2 in bf16, whose p rounds to bf16
// anyway; exp2f (2 ulp, denormals kept) in f32, as the f32 backward's
// score tiles take it
template <bool kF32>
__device__ __forceinline__ float softmax_exp2(float x) {
  return kF32 ? exp2f(x) : ex2(x);
}

// n16 column groups of D that one pass of a product over D takes
template <int D>
constexpr int kNGroup = D / 16 < 4 ? D / 16 : 4;

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment addresses within a padded tile, for this lane (row0/col0: the
// 16 x 16 block's corner):
//   A of a row-major 16 x 16 block (rows = M, columns = K);
__device__ __forceinline__ int frag_a(int row0, int col0, int lane, int ld) {
  return (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
//   B of two n8 tiles from a tile whose rows are N and columns K
//   (registers: b0, b1 of the first n8 tile, then of the second);
__device__ __forceinline__ int frag_b_nk(int n0, int k0, int lane, int ld) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0
         + ((lane >> 3) & 1) * 8;
}
//   B of two n8 tiles from a tile whose rows are K and columns N (.trans).
__device__ __forceinline__ int frag_b_kn(int k0, int n0, int lane, int ld) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0
         + (lane >> 4) * 8;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two m16n8 f32 accumulators (columns 16kb..16kb+15) rounded to bf16 as
// the m16k16 A fragment of the next product.
__device__ __forceinline__ void to_a_frag(unsigned (&a)[4],
                                          const float (&lo)[4],
                                          const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The live tiles [lo, hi] of the other side, a contiguous band (lo > hi:
// none): key tiles of query tile own0 (dq, own_query) or query tiles of
// key tile own0 (dk/dv).
__device__ __forceinline__ void live_tiles(int own0, bool own_query,
                                           const Geom& g, int& lo, int& hi) {
  lo = 0;
  hi = -1;
  const int n = ((own_query ? g.Tk : g.Tq) + kTile - 1) / kTile;
  for (int t = 0; t < n; ++t)
    if (own_query ? tile_live(own0, t * kTile, g)
                  : tile_live(t * kTile, own0, g)) {
      if (hi < lo) lo = t;
      hi = t;
    }
}

// Every (q, k) pair of the tile pair is unmasked and inside the arrays, so
// the elementwise step needs no pair_live (most tiles of a long causal
// sequence).
__device__ __forceinline__ bool tile_full(int q0, int k0, const Geom& g) {
  if (q0 + kTile > g.Tq || k0 + kTile > g.Tk) return false;
  if (!g.causal) return true;
  const int nearest = (q0 + g.q_off) - (k0 + g.k_off + kTile - 1);
  const int farthest = (q0 + g.q_off + kTile - 1) - (k0 + g.k_off);
  return nearest >= 0 && (g.window <= 0 || farthest < g.window);
}

// dq's elementwise step on this lane's 16 x 8N score tile (keys k0 +
// ...): s becomes ds = p (dp - delta) scale, p = exp(s scale - lse), 0 on
// masked lanes.
template <bool kFull, int N>
__device__ __forceinline__ void dq_scores(float (&s)[N][4],
                                          const float (&dp)[N][4],
                                          int r0, int k0, int tq,
                                          const float (&lse2)[2],
                                          const float (&del)[2], float scale2,
                                          float scale, const Geom& g) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool live =
          kFull || pair_live(r0 + 8 * i, k0 + 8 * j + 2 * tq + (e & 1), g);
      const float p = live ? exp2f(fmaf(s[j][e], scale2, -lse2[i])) : 0.f;
      s[j][e] = p * (dp[j][e] - del[i]) * scale;
    }
}

// dk/dv's on a 16-key x N-query transposed tile (query columns c0 + ...):
// s becomes p^T, dp becomes ds^T, from the columns' lse and delta.
template <bool kFull, int N>
__device__ __forceinline__ void dkv_scores(float (&s)[N][4], float (&dp)[N][4],
                                           int kr0, int q0, int c0, int tq,
                                           const float* cL, const float* cDel,
                                           float scale2, float scale,
                                           const Geom& g) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 8 * j + 2 * tq + (e & 1);
      const bool live = kFull || pair_live(q0 + c, kr0 + 8 * (e >> 1), g);
      const float p =
          live ? exp2f(fmaf(s[j][e], scale2, -cL[c] * kLog2e)) : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - cDel[c]) * scale;
    }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// A score row of an m16n8 fragment lives in the 4 lanes of a quad
// (lane / 4 = the row, lane % 4 = the column pair): its max and sum take
// two shuffles.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The forward's elementwise step on this lane's 16 x 8N score tile (raw
// q . k, rows r0 and r0 + 8, keys k0 + ...): _softmax_tile's online
// softmax. m and l are in natural-log units, as the carry is stored; only
// the exponentials run in the exp2 domain (softmax_exp2), so nothing is
// converted on load or store. s becomes p = exp(s scale - m'), exactly 0
// on masked lanes (the where-guard: a row whose live keys all lie in
// later tiles keeps p = 0 and corr = exp(min(m, m') - m') = 1, so an
// empty carry stays empty); l sums the unrounded f32 p; corr[i] is
// returned for the accumulator.
template <bool kFull, bool kF32 = false, int N>
__device__ __forceinline__ void fwd_scores(float (&s)[N][4], int r0, int k0,
                                           int tq, float scale, float scale2,
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], const Geom& g) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!kFull && !pair_live(r0 + 8 * (e >> 1), k0 + 8 * j + 2 * tq + (e & 1), g))
        s[j][e] = kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float mb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // max(s) scale == max(s scale): the scale is positive
    const float row = quad_max(mx[i]);
    const float m_new = fmaxf(m[i], row > kNegInf / 2 ? row * scale : kNegInf);
    corr[i] = softmax_exp2<kF32>((fminf(m[i], m_new) - m_new) * kLog2e);
    m[i] = m_new;
    mb[i] = m_new * kLog2e;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = kFull || s[j][e] > kNegInf / 2
                          ? softmax_exp2<kF32>(fmaf(s[j][e], scale2, -mb[i]))
                          : 0.f;
      s[j][e] = p;
      sum[i] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
}

// ---------------------------------------------------------------- forward
// Fold every live key tile of KV head hk into the online-softmax state of
// query tile q0 (this lane's rows 16 warp + lane / 4, + 8): the key loop
// of both forward kernels (flash_fwd_mma_kernel, ring_fwd_mma_kernel).
// q, k and v point at (b, row 0, head) of their arrays. One shared tile
// each of Q, K and V (52,224 bytes at D = 128, so three blocks an SM):
// the copy of a tile's V runs under its S = Q K^T and the elementwise
// step, the copy of the next tile's K under O += P V. S = Q K^T on
// mma.sync (Q's A fragments read from shared memory at each k-step, K's
// rows the n axis: no transpose), the elementwise step on the accumulator
// fragments, P repacked in registers as the A fragment of O += P V (V
// read transposed). m, l and acc hold the state on entry (empty, or the
// ring's carry) and on exit.
template <int D>
__device__ __forceinline__ void fwd_mma_fold(bf16* smem, const bf16* __restrict__ q,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const Geom& g, int q0, float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 8][4]) {
  constexpr int kLd = mma_ld<D>();
  constexpr int kT = mma_tile<D>();
  bf16* sQ = smem;
  bf16* sK = sQ + kT;
  bf16* sV = sK + kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane & 3;
  const int r0 = q0 + 16 * warp + (lane >> 2);
  int lo, hi;
  live_tiles(q0, true, g, lo, hi);
  if (lo > hi) return;  // block-uniform: no copy was started

  cp_tile<D>(sQ, q + q0 * g.q_st, g.q_st, g.Tq - q0);
  cp_tile<D>(sK, k + lo * kTile * g.k_st, g.k_st, g.Tk - lo * kTile);
  cp_async_commit();
  const float scale2 = scale * kLog2e;

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    cp_async_wait<0>();
    __syncthreads();  // K has landed; every warp is done with the last V
    cp_tile<D>(sV, v + k0 * g.v_st, g.v_st, g.Tk - k0);
    cp_async_commit();

    // S = Q K^T: 16 query rows x 64 keys a warp
    const unsigned qa = opaque(smem_addr(sQ + frag_a(16 * warp, 0, lane, kLd)));
    const unsigned ka = opaque(smem_addr(sK + frag_b_nk(0, 0, lane, kLd)));
    float s[8][4];
    zero_frags(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned aq[4], bk[4][4];
      ldsm_x4(aq, qa + 2 * 16 * kk);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldsm_x4(bk[np], ka + 2 * (16 * np * kLd + 16 * kk));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma16816(s[2 * np], aq, bk[np][0], bk[np][1]);
        mma16816(s[2 * np + 1], aq, bk[np][2], bk[np][3]);
      }
    }

    float corr[2];
    if (tile_full(q0, k0, g))
      fwd_scores<true>(s, r0, k0, tq, scale, scale2, m, l, corr, g);
    else
      fwd_scores<false>(s, r0, k0, tq, scale, scale2, m, l, corr, g);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    cp_async_wait<0>();
    __syncthreads();  // V has landed; every warp is done with this K
    if (kt < hi) {
      const int n0 = (kt + 1) * kTile;
      cp_tile<D>(sK, k + n0 * g.k_st, g.k_st, g.Tk - n0);
    }
    cp_async_commit();

    // O += bf16(P) V, V read transposed
    const unsigned va = opaque(smem_addr(sV + frag_b_kn(0, 0, lane, kLd)));
#pragma unroll
    for (int kb2 = 0; kb2 < 4; ++kb2) {
      unsigned a[4];
      to_a_frag(a, s[2 * kb2], s[2 * kb2 + 1]);
#pragma unroll
      for (int n0 = 0; n0 < D / 16; n0 += kNGroup<D>) {
        unsigned bv[kNGroup<D>][4];
#pragma unroll
        for (int i = 0; i < kNGroup<D>; ++i)
          ldsm_x4_t(bv[i], va + 2 * (16 * kb2 * kLd + 16 * (n0 + i)));
#pragma unroll
        for (int i = 0; i < kNGroup<D>; ++i) {
          mma16816(acc[2 * (n0 + i)], a, bv[i][0], bv[i][1]);
          mma16816(acc[2 * (n0 + i) + 1], a, bv[i][2], bv[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------------- dq
// dq of query tile q0 of head h, batch b, against every live key tile of
// KV head h / group, into this lane's f32 fragments acc (rows 16 warp +
// lane / 4 and + 8; zeroed here): the key loop of both dq kernels
// (flash_dq_mma_kernel, ring_dq_mma_kernel). Q and dO stay resident, K and
// V are double-buffered by cp.async (the next tile's copy under this
// tile's products). S = Q K^T and dP = dO V^T on mma.sync, dq_scores on
// the accumulator fragments, dS repacked in registers as the A fragment
// of dQ += dS K (K read transposed).
template <int D>
__device__ __forceinline__ void dq_mma_fold(
    bf16* smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Geom& g, int b, int h, int q0, float scale,
    float (&acc)[D / 8][4]) {
  constexpr int kLd = mma_ld<D>();
  constexpr int kT = mma_tile<D>();
  bf16* sQ = smem;
  bf16* sDO = sQ + kT;
  bf16* sK = sDO + kT;      // 2 stages
  bf16* sV = sK + 2 * kT;   // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int hk = h / (g.H / g.Hkv);
  int lo, hi;
  live_tiles(q0, true, g, lo, hi);

  const bf16* kb = k + b * g.k_sb + hk * g.k_sh;
  const bf16* vb = v + b * g.v_sb + hk * g.v_sh;
  if (lo <= hi) {
    cp_tile<D>(sQ, q + b * g.q_sb + q0 * g.q_st + h * g.q_sh, g.q_st,
               g.Tq - q0);
    cp_tile<D>(sDO, dout + b * g.do_sb + q0 * g.do_st + h * g.do_sh, g.do_st,
               g.Tq - q0);
    cp_tile<D>(sK, kb + lo * kTile * g.k_st, g.k_st, g.Tk - lo * kTile);
    cp_tile<D>(sV, vb + lo * kTile * g.v_st, g.v_st, g.Tk - lo * kTile);
  }
  cp_async_commit();

  // this lane's two query rows, r0 and r0 + 8
  const int r0 = q0 + 16 * warp + gr;
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
    const int stage = (kt - lo) & 1;
    if (kt < hi) {
      const int n0 = (kt + 1) * kTile;
      cp_tile<D>(sK + (stage ^ 1) * kT, kb + n0 * g.k_st, g.k_st, g.Tk - n0);
      cp_tile<D>(sV + (stage ^ 1) * kT, vb + n0 * g.v_st, g.v_st, g.Tk - n0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + stage * kT;
    const bf16* cV = sV + stage * kT;
    const int k0 = kt * kTile;

    // S = Q K^T and dP = dO V^T: 16 query rows x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // every fragment of the step first, then its 16 products: the
      // loads' latency overlaps instead of stalling each product
      unsigned aq[4], ado[4], bk[4][4], bv[4][4];
      ldsm_x4(aq, sQ + frag_a(16 * warp, 16 * kk, lane, kLd));
      ldsm_x4(ado, sDO + frag_a(16 * warp, 16 * kk, lane, kLd));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        ldsm_x4(bk[np], cK + frag_b_nk(16 * np, 16 * kk, lane, kLd));
        ldsm_x4(bv[np], cV + frag_b_nk(16 * np, 16 * kk, lane, kLd));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma16816(s[2 * np], aq, bk[np][0], bk[np][1]);
        mma16816(s[2 * np + 1], aq, bk[np][2], bk[np][3]);
        mma16816(dp[2 * np], ado, bv[np][0], bv[np][1]);
        mma16816(dp[2 * np + 1], ado, bv[np][2], bv[np][3]);
      }
    }

    if (tile_full(q0, k0, g))
      dq_scores<true>(s, dp, r0, k0, tq, lse2, del, scale2, scale, g);
    else
      dq_scores<false>(s, dp, r0, k0, tq, lse2, del, scale2, scale, g);

    // dQ += bf16(dS) K, K read transposed
#pragma unroll
    for (int kb2 = 0; kb2 < 4; ++kb2) {
      unsigned a[4];
      to_a_frag(a, s[2 * kb2], s[2 * kb2 + 1]);
#pragma unroll
      for (int n0 = 0; n0 < D / 16; n0 += kNGroup<D>) {
        unsigned bk[kNGroup<D>][4];
#pragma unroll
        for (int i = 0; i < kNGroup<D>; ++i)
          ldsm_x4_t(bk[i], cK + frag_b_kn(16 * kb2, 16 * (n0 + i), lane, kLd));
#pragma unroll
        for (int i = 0; i < kNGroup<D>; ++i) {
          mma16816(acc[2 * (n0 + i)], a, bk[i][0], bk[i][1]);
          mma16816(acc[2 * (n0 + i) + 1], a, bk[i][2], bk[i][3]);
        }
      }
    }
    __syncthreads();  // this stage is overwritten two tiles on
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ dk/dv
// dk and dv of key tile k0 of KV head hk, batch b, summed over the GQA
// group's query heads and their live query tiles, into this lane's f32
// fragments dk_acc and dv_acc (key rows 16 warp + lane / 4 and + 8; zeroed
// here): the query loop of both dk/dv kernels (flash_dkv_mma_kernel,
// ring_dkv_mma_kernel). K and V stay resident, Q, dO and their lse and
// delta rows are double-buffered by cp.async. S^T = K Q^T and dP^T = V
// dO^T on mma.sync, dkv_scores on the accumulator fragments, P^T and dS^T
// repacked in registers as the A fragments of dV += P^T dO and dK += dS^T
// Q (dO and Q read transposed).
template <int D>
__device__ __forceinline__ void dkv_mma_fold(
    bf16* smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Geom& g, int b, int hk, int k0, float scale,
    float (&dk_acc)[D / 8][4], float (&dv_acc)[D / 8][4]) {
  constexpr int kLd = mma_ld<D>();
  constexpr int kT = mma_tile<D>();
  // query columns per pass over the score tile: at D = 128 the two
  // accumulators take 128 registers, so S^T and dP^T go in halves
  constexpr int kSubQ = D == 128 ? 32 : 64;
  bf16* sK = smem;
  bf16* sV = sK + kT;
  bf16* sQ = sV + kT;        // 2 stages
  bf16* sDO = sQ + 2 * kT;   // 2 stages
  float* sL = reinterpret_cast<float*>(sDO + 2 * kT);  // 2 stages of 64
  float* sDel = sL + 2 * kTile;                         // 2 stages of 64

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int group = g.H / g.Hkv;
  int lo, hi;
  live_tiles(k0, false, g, lo, hi);
  const int n_live = hi - lo + 1;
  const int n_it = n_live > 0 ? group * n_live : 0;

  // iteration it: query head hk * group + it / n_live, tile lo + it % n_live
  auto load_stage = [&](int it, int stage) {
    const int h = hk * group + it / n_live;
    const int q0 = (lo + it % n_live) * kTile;
    cp_tile<D>(sQ + stage * kT, q + b * g.q_sb + q0 * g.q_st + h * g.q_sh,
               g.q_st, g.Tq - q0);
    cp_tile<D>(sDO + stage * kT,
               dout + b * g.do_sb + q0 * g.do_st + h * g.do_sh, g.do_st,
               g.Tq - q0);
    cp_rows(sL + stage * kTile, sDel + stage * kTile, lse, delta,
            (static_cast<long long>(b) * g.H + h) * g.Tq + q0, g.Tq - q0);
  };
  if (n_it > 0) {
    cp_tile<D>(sK, k + b * g.k_sb + k0 * g.k_st + hk * g.k_sh, g.k_st,
               g.Tk - k0);
    cp_tile<D>(sV, v + b * g.v_sb + k0 * g.v_st + hk * g.v_sh, g.v_st,
               g.Tk - k0);
    load_stage(0, 0);
  }
  cp_async_commit();

  const int kr0 = k0 + 16 * warp + gr;  // this lane's key rows kr0, kr0 + 8
  const float scale2 = scale * kLog2e;
  zero_frags(dk_acc);
  zero_frags(dv_acc);

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_it) load_stage(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + stage * kT;
    const bf16* cDO = sDO + stage * kT;
    const float* cL = sL + stage * kTile;
    const float* cDel = sDel + stage * kTile;
    const int q0 = (lo + it % n_live) * kTile;
    const bool full = tile_full(q0, k0, g);

#pragma unroll 1  // one half at a time: unrolled, D = 128 spills
    for (int qs = 0; qs < kTile; qs += kSubQ) {
      // S^T = K Q^T and dP^T = V dO^T: 16 key rows x kSubQ queries a warp
      float s[kSubQ / 8][4], dp[kSubQ / 8][4];
#pragma unroll
      for (int j = 0; j < kSubQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned ak[4], av[4];
        ldsm_x4(ak, sK + frag_a(16 * warp, 16 * kk, lane, kLd));
        ldsm_x4(av, sV + frag_a(16 * warp, 16 * kk, lane, kLd));
        unsigned bq[kSubQ / 16][4], bo[kSubQ / 16][4];
#pragma unroll
        for (int np = 0; np < kSubQ / 16; ++np) {
          ldsm_x4(bq[np], cQ + frag_b_nk(qs + 16 * np, 16 * kk, lane, kLd));
          ldsm_x4(bo[np], cDO + frag_b_nk(qs + 16 * np, 16 * kk, lane, kLd));
        }
#pragma unroll
        for (int np = 0; np < kSubQ / 16; ++np) {
          mma16816(s[2 * np], ak, bq[np][0], bq[np][1]);
          mma16816(s[2 * np + 1], ak, bq[np][2], bq[np][3]);
          mma16816(dp[2 * np], av, bo[np][0], bo[np][1]);
          mma16816(dp[2 * np + 1], av, bo[np][2], bo[np][3]);
        }
      }

      if (full)
        dkv_scores<true>(s, dp, kr0, q0, qs, tq, cL, cDel, scale2, scale, g);
      else
        dkv_scores<false>(s, dp, kr0, q0, qs, tq, cL, cDel, scale2, scale, g);

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, dO and Q transposed
#pragma unroll
      for (int kb2 = 0; kb2 < kSubQ / 16; ++kb2) {
        unsigned ap[4], ads[4];
        to_a_frag(ap, s[2 * kb2], s[2 * kb2 + 1]);
        to_a_frag(ads, dp[2 * kb2], dp[2 * kb2 + 1]);
#pragma unroll
        for (int n0 = 0; n0 < D / 16; n0 += 2) {
          unsigned bo[2][4], bq[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int off = frag_b_kn(qs + 16 * kb2, 16 * (n0 + i), lane, kLd);
            ldsm_x4_t(bo[i], cDO + off);
            ldsm_x4_t(bq[i], cQ + off);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int n = 2 * (n0 + i);
            mma16816(dv_acc[n], ap, bo[i][0], bo[i][1]);
            mma16816(dv_acc[n + 1], ap, bo[i][2], bo[i][3]);
            mma16816(dk_acc[n], ads, bq[i][0], bq[i][1]);
            mma16816(dk_acc[n + 1], ads, bq[i][2], bq[i][3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is overwritten two iterations on
  }
  cp_async_wait<0>();
}

}  // namespace
