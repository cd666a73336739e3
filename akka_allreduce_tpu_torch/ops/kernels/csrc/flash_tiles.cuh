// Shared tile machinery of the flash attention kernels (flash_attention.cu)
// and the ring flash attention kernels (ring_flash.cu): the geometry and
// its masks, the launch and dtype dispatch, and the CUDA-core forward fold
// of the f32 flash and ring forwards.
//
// What one tile pair computes, with s = (q . k) * D^-1/2 in f32 and masked
// lanes at NEG_INF (causal: key position k_off + j above query position
// q_off + i; window: also keys `window` or more positions back; keys past
// Tk), is the Pallas helpers' arithmetic
// (akka_allreduce_tpu/ops/pallas_kernels/attention.py _softmax_tile and
// _bwd_tile):
//   forward  m' = max(m, rowmax s), corr = exp(min(m, m') - m'),
//            p = exp(s - m') (exactly 0 on masked lanes),
//            l' = l corr + rowsum p, acc' = acc corr + p v
//   dq       p = exp(s - lse), dp = dO v^T, ds = p (dp - delta) scale,
//            dq += ds k
//   dk, dv   dv += p^T dO, dk += ds^T q, summed over the GQA group.
// Cast points follow the Pallas kernels: p is rounded to V's type before
// the PV product, ds to K's type for dq and to Q's for dk, p to dO's for
// dv; every product accumulates in f32.
//
// Layout of the work, which every fold keeps (here and in flash_mma.cuh,
// flash_tf32.cuh):
//   * 64-row tiles. The TPU runs its key axis (forward, dq) or its group
//     x query axis (dk/dv) as a sequential grid dimension and carries the
//     state in scratch; here that axis is a loop inside one block (a
//     fold) and the state lives in registers:
//       forward, dq: one block per (query tile, query head, batch);
//       dk/dv:       one block per (key tile, KV head, batch), looping over
//                    the g query heads of the group x their query tiles, so
//                    dk and dv accumulate the whole group in f32 and are
//                    written once: no atomics, a deterministic result.
//   * Tiles that the causal / window mask leaves empty are skipped
//     (_tile_live_local and ring_flash.py _tile_live). Ragged T (not a
//     multiple of 64) is masked at the edge: rows past T load as zeros,
//     lanes past Tk are masked, rows past Tq are not stored and contribute
//     nothing.
//   * q, k, v and dO are read in the model's (B, T, H, D) layout through
//     their strides (no relayout); K/V tiles of KV head hk are staged in
//     shared memory, so GQA needs no repeated heads.
//
// The fold here (fwd_fold, 256 threads) runs the products as CUDA-core
// FMAs in f32 from shared-memory tiles (rows padded by 16 bytes, so the
// vector reads of 8 rows at one column hit 8 different bank groups).
// Thread t owns rows t/8 and t/8 + 32 of a tile and columns t%8 + 8j of a
// score tile, or 4-wide column groups (t%8)*4 + 32j of a D-wide
// accumulator, so a score row's 8 owners are 8 neighbouring lanes and its
// max and sum are 3 shuffles. f32 inputs stay f32 (one TF32 product would
// break parity with the f32 reference). It reaches ~2% of the bf16 bound
// (every product an f32 FMA from shared memory, the score tile
// round-tripped through shared memory, synchronous tile loads), so every
// other flash and ring-flash kernel runs on tensor cores: the bf16
// forward, dq and dk/dv on flash_mma.cuh's folds, the f32 dq and dk/dv on
// flash_tf32.cuh's split-TF32 folds. Only the f32 flash forward
// (attention.py _fwd_kernel :113, flash_attention.cu) and the f32 ring
// forward (ring_flash.py _ring_fwd_kernel :61, ring_flash.cu) still run
// fwd_fold.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // rows of a query or key tile
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / 8;    // 32: a thread's rows are ty, ty+32
constexpr int kRows = kTile / kRowStep;   // 2 rows per thread
constexpr int kLdp = kTile + 4;           // padded f32 score-tile row
constexpr float kNegInf = -1e30f;

struct Geom {
  int B, H, Hkv, Tq, Tk, causal, window, q_off, k_off;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
};

// padded shared-memory row length of a D-wide tile, in elements
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and widened back: the Pallas kernels' .astype(T)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Copy rows [0, valid) of a 64-row tile (row stride `st` elements in
// device memory, D contiguous) into shared memory with 16-byte loads;
// rows past `valid` become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long st, int valid) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = D / kPer;
  constexpr int kLd = ld<T, D>();
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * kPer;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * st + e);
    *reinterpret_cast<uint4*>(dst + r * kLd + e) = v;
  }
}

// c[i][j] = sum_d A[ty + 32 i][d] * B[tx + 8 j][d]: a 64 x 64 tile of row
// dot products between two padded shared-memory tiles.
template <typename T, int D>
__device__ __forceinline__ void rowdot(const T* A, const T* B, int ty, int tx,
                                       float (&c)[kRows][8]) {
  constexpr int kLd = ld<T, D>();
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float a[kRows][4], b[8][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) load4(A + (ty + kRowStep * i) * kLd + d, a[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) load4(B + (tx + 8 * j) * kLd + d, b[j]);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j] = fmaf(a[i][e], b[j][e], c[i][j]);
  }
}

// acc[i][4 jj + e] += sum_c P[ty + 32 i][c] * B[c][4 tx + 32 jj + e]: a
// 64 x 64 f32 tile times a 64 x D shared-memory tile, into registers.
template <typename T, int D>
__device__ __forceinline__ void accum(const float* P, const T* B, int ty,
                                      int tx, float (&acc)[kRows][D / 8]) {
  constexpr int kLd = ld<T, D>();
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float p[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) load4(P + (ty + kRowStep * i) * kLdp + c, p[i]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        float b[4];
        load4(B + (c + cc) * kLd + 4 * tx + 32 * jj, b);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * jj + e] = fmaf(p[i][cc], b[e], acc[i][4 * jj + e]);
      }
    }
  }
}

// Some (q, k) pair of the tile pair may be unmasked: _tile_live_local.
__device__ __forceinline__ bool tile_live(int q0, int k0, const Geom& g) {
  if (!g.causal) return true;
  bool live = k0 + g.k_off <= q0 + g.q_off + kTile - 1;
  if (g.window > 0) live = live && (k0 + g.k_off + kTile - 1 > q0 + g.q_off - g.window);
  return live;
}

// Query row qi may attend key row kj (both in-array indices).
__device__ __forceinline__ bool pair_live(int qi, int kj, const Geom& g) {
  if (qi >= g.Tq || kj >= g.Tk) return false;
  if (!g.causal) return true;
  const int dq = (g.q_off + qi) - (g.k_off + kj);
  return dq >= 0 && (g.window <= 0 || dq < g.window);
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <typename T, int D>
constexpr size_t tile_bytes() {
  return static_cast<size_t>(kTile) * ld<T, D>() * sizeof(T);
}
constexpr size_t kScoreBytes = static_cast<size_t>(kTile) * kLdp * sizeof(float);

// Shared memory of the forward: sQ sK sV + a score tile.
template <typename T, int D>
constexpr size_t fwd_smem() { return 3 * tile_bytes<T, D>() + kScoreBytes; }

// --------------------------------------------------------------- the fold
// Fold every live key tile of KV head hk into the online-softmax state of
// query tile q0 (this thread's rows ty, ty + 32): the key loop of a forward
// kernel. sQ holds the query tile; sK, sV and sP are scratch.
template <typename T, int D>
__device__ __forceinline__ void fwd_fold(const T* sQ, T* sK, T* sV, float* sP,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v, const Geom& g,
                                         int b, int hk, int q0, float scale,
                                         float (&m)[kRows], float (&l)[kRows],
                                         float (&acc)[kRows][D / 8]) {
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int n_k = (g.Tk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(q0, k0, g)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, k + b * g.k_sb + k0 * g.k_st + hk * g.k_sh, g.k_st,
                    g.Tk - k0);
    load_tile<T, D>(sV, v + b * g.v_sb + k0 * g.v_st + hk * g.v_sh, g.v_st,
                    g.Tk - k0);
    __syncthreads();
    float s[kRows][8];
    rowdot<T, D>(sQ, sK, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kRowStep * i;
      float m_tile = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] *= scale;
        if (!pair_live(q0 + r, k0 + tx + 8 * j, g)) s[i][j] = kNegInf;
        m_tile = fmaxf(m_tile, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(m_tile));
      const float corr = expf(fminf(m[i], m_new) - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the where-guard: a row whose live keys all lie in later tiles
        // keeps exactly 0 here instead of exp(NEG_INF - NEG_INF) = 1
        const float p = s[i][j] > kNegInf / 2 ? expf(s[i][j] - m_new) : 0.f;
        p_sum += p;
        sP[r * kLdp + tx + 8 * j] = round_to(p, T());
      }
      l[i] = l[i] * corr + row_sum8(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < D / 8; ++e) acc[i][e] *= corr;
    }
    __syncthreads();
    accum<T, D>(sP, sV, ty, tx, acc);
  }
}

// ----------------------------------------------------------------- launch
Geom read_geom(const int64_t* a) {
  Geom g;
  g.B = static_cast<int>(a[0]);
  g.H = static_cast<int>(a[1]);
  g.Hkv = static_cast<int>(a[2]);
  g.Tq = static_cast<int>(a[3]);
  g.Tk = static_cast<int>(a[4]);
  g.causal = static_cast<int>(a[5]);
  g.window = static_cast<int>(a[6]);
  g.q_off = static_cast<int>(a[7]);
  g.k_off = static_cast<int>(a[8]);
  g.q_sb = a[9];   g.q_st = a[10];  g.q_sh = a[11];
  g.k_sb = a[12];  g.k_st = a[13];  g.k_sh = a[14];
  g.v_sb = a[15];  g.v_st = a[16];  g.v_sh = a[17];
  g.do_sb = a[18]; g.do_st = a[19]; g.do_sh = a[20];
  return g;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// One launch: lift the kernel's dynamic shared-memory limit, launch it on
// stream s, return the status.
template <typename... P, typename... A>
int launch_kernel(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                  cudaStream_t s, A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128.
#define FLASH_DISPATCH(CALL)                                              \
  if (dtype == 0 && head_dim == 64) return CALL(float, 64);               \
  if (dtype == 0 && head_dim == 128) return CALL(float, 128);             \
  if (dtype == 1 && head_dim == 64) return CALL(__nv_bfloat16, 64);       \
  if (dtype == 1 && head_dim == 128) return CALL(__nv_bfloat16, 128);     \
  return static_cast<int>(cudaErrorInvalidValue)

}  // namespace
