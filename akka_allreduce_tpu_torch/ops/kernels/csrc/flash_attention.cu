// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/attention.py
//   _fwd_kernel  (forward: O and the f32 log-sum-exp)
//   _dq_kernel   (backward: dq from LSE and delta)
//   _dkv_kernel  (backward: dk and dv, summed over the GQA group)
//
// What they compute per batch b and query head h (KV head hk = h / g,
// g = H / H_kv): o = softmax(s) v with lse = m + log(l) (online softmax),
// dq and (dk, dv) recomputed from lse and delta = rowsum(dO . O). The tile
// arithmetic, its cast points, the work layout and the masks are those of
// flash_tiles.cuh, which ring_flash.cu shares; each kernel here is one
// fold over the other side's tiles (which loads its own tile) and an
// epilogue that stores the result. Every fold is one that ring_flash.cu's
// kernel of the same product runs too.
//
// Bound: at the training shape (T = 2048, D = 128) the work is ~4 (fwd),
// ~6 (dq) and ~8 (dk/dv) flops per D-element of every live (q, k) pair,
// hundreds of flops per byte moved, so the arithmetic rate bounds it: the
// tensor cores' 989 TFLOP/s for bf16 (B 8, T 2048, H 16, D 128, causal:
// fwd 0.139 ms, dq 0.209 ms, dk/dv 0.278 ms); for f32 ~165 TFLOP/s of f32
// work as three TF32 tensor-core products (fwd 0.83 ms, dq 1.25 ms, dk/dv
// 1.67 ms). What the design does about it, per dtype:
//   * bf16 (_fwd_kernel, _dq_kernel, _dkv_kernel): tensor-core tiles,
//     flash_mma.cuh (mma.sync m16n8k16 from ldmatrix, the score tiles
//     kept in registers, the streamed tiles double-buffered by cp.async):
//     flash_fwd_mma_kernel, flash_dq_mma_kernel, flash_dkv_mma_kernel;
//   * f32 (_fwd_kernel, _dq_kernel, _dkv_kernel): tensor-core tiles in
//     split TF32, flash_tf32.cuh (each product as three TF32 products,
//     hi.lo + lo.hi + hi.hi, which keeps parity with the f32 reference
//     where one TF32 product would break it): flash_fwd_tf32_mma_kernel,
//     flash_dq_tf32_mma_kernel, flash_dkv_tf32_mma_kernel.
// A query row with no live key (an empty band, a window, offsets) has l
// = 0 and acc = 0; the forwards store o = 0 for it (acc / 1, not 0 / 0)
// and lse = m + log l = -inf.

#include <type_traits>

#include "flash_tf32.cuh"

namespace {

// ---------------------------------------------------------------- forward
// The bf16 forward on tensor cores (replaces _fwd_kernel for bf16; bound
// by the tensor cores, 0.139 ms at the training shape): fwd_mma_fold
// (flash_mma.cuh) from an empty state, then o = acc / l rounded to bf16
// and lse = m + log l in natural-log units. 4 warps of 16 query rows, no
// atomics.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, fwd_mma_min_blocks<D>())
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.H / g.Hkv);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero_frags(acc);
  fwd_mma_fold<D>(reinterpret_cast<bf16*>(smem),
                  q + b * g.q_sb + h * g.q_sh, k + b * g.k_sb + hk * g.k_sh,
                  v + b * g.v_sb + hk * g.v_sh, g, q0, scale, m, l, acc);

  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= g.Tq) continue;
    bf16* row = o + ((static_cast<long long>(b) * g.Tq + qi) * g.H + h) * D;
    const float den = l[i] > 0.f ? l[i] : 1.f;  // no live key: o = 0
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    if (tq == 0)
      lse[(static_cast<long long>(b) * g.H + h) * g.Tq + qi] = m[i] + logf(l[i]);
  }
}

// The f32 forward on tensor cores in split TF32 (replaces _fwd_kernel for
// f32; bound by three TF32 products a product, 0.83 ms at the training
// shape): flash_tf32.cuh's fwd_tf32_fold from an empty state on the flash
// grid, the longest causal bands first, then o = acc / l stored by each
// warp for its half of its rows' columns, one float4 per 16 columns
// (query_tile_epilogue), and lse = m + log l in natural-log units.
template <int D>
__global__ void __launch_bounds__(kTf32Threads, fwd_tf32_min_blocks<D>())
flash_fwd_tf32_mma_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  zero_frags(acc);
  fwd_tf32_fold<D>(reinterpret_cast<float*>(smem), q, k, v, g, b, h, q0,
                   scale, m, l, acc);
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) den[i] = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= den[e >> 1];
  query_tile_epilogue<false, D>(o, acc, g, b, h, q0);

  // m and l are the pair's merged ones in both warps: warps 0-3 store
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 4 * 32 || (lane & 3) != 0) return;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi < g.Tq)
      lse[(static_cast<long long>(b) * g.H + h) * g.Tq + qi] =
          m[i] + logf(l[i]);
  }
}

// --------------------------------------------------------------------- dq
// The bf16 dq (replaces _dq_kernel for bf16): dq_mma_fold, then dq
// rounded to bf16. The causal band grows with the query tile, so the
// longest blocks go first.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  float acc[D / 8][4];
  dq_mma_fold<D>(reinterpret_cast<bf16*>(smem), q, k, v, dout, lse, delta, g,
                 b, h, q0, scale, acc);

  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= g.Tq) continue;
    bf16* row = dq + ((static_cast<long long>(b) * g.Tq + qi) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// The f32 dq on tensor cores in split TF32 (replaces _dq_kernel for f32;
// bound by three TF32 products a product, 1.25 ms at the training
// shape): flash_tf32.cuh's dq_tf32_fold on the flash grid, the longest
// causal bands first, then each warp stores its half of its rows, one
// float4 per 16 columns (query_tile_epilogue).
template <int D>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_dq_tf32_mma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  float acc[D / 8][4];
  dq_tf32_fold<D>(reinterpret_cast<float*>(smem), q, k, v, dout, lse, delta,
                  g, b, h, q0, scale, acc);
  query_tile_epilogue<false, D>(dq, acc, g, b, h, q0);
}

// ------------------------------------------------------------------ dk/dv
// The bf16 dk/dv (replaces _dkv_kernel for bf16): dkv_mma_fold, then dk
// and dv rounded to bf16, written once (no atomics).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  dkv_mma_fold<D>(reinterpret_cast<bf16*>(smem), q, k, v, dout, lse, delta,
                  g, b, hk, k0, scale, dk_acc, dv_acc);

  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int kr0 = k0 + 16 * (threadIdx.x / 32) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kr0 + 8 * i;
    if (kj >= g.Tk) continue;
    const long long off =
        ((static_cast<long long>(b) * g.Tk + kj) * g.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// The f32 dk/dv on tensor cores in split TF32 (replaces _dkv_kernel for
// f32; 1.67 ms at the training shape): dkv_tf32_fold on the flash grid in
// blockIdx order (key tile 0 has the longest causal band), then warps
// 0-3 store their rows' dk and warps 4-7 their dv, written once (no
// atomics: dkv_tf32_epilogue).
template <int D>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_dkv_tf32_mma_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  dkv_tf32_fold<D>(reinterpret_cast<float*>(smem), q, k, v, dout, lse,
                   delta, g, b, hk, k0, scale, dk_acc, dv_acc);
  dkv_tf32_epilogue<false, D>(dk, dv, dk_acc, dv_acc, g, b, hk, k0);
}

// ----------------------------------------------------------------- launch
// bf16 on the tensor-core tiles (flash_mma.cuh), f32 on split TF32
// (flash_tf32.cuh)
template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const Geom& g, float scale, cudaStream_t s) {
  auto run = [&](auto kernel, size_t smem, int threads) {
    return launch_kernel(
        kernel, dim3(tiles(g.Tq), g.H, g.B), threads, smem, s,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), g, scale);
  };
  if constexpr (std::is_same<T, bf16>::value)
    return run(flash_fwd_mma_kernel<D>, fwd_mma_smem<D>(), kMmaThreads);
  else
    return run(flash_fwd_tf32_mma_kernel<D>, fwd_tf32_smem<D>(),
               kTf32Threads);
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* out, const Geom& g,
       float scale, cudaStream_t s) {
  auto run = [&](auto kernel, size_t smem, int threads) {
    return launch_kernel(
        kernel, dim3(tiles(g.Tq), g.H, g.B), threads, smem, s,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(out), g, scale);
  };
  if constexpr (std::is_same<T, bf16>::value)
    return run(flash_dq_mma_kernel<D>, dq_mma_smem<D>(), kMmaThreads);
  else
    return run(flash_dq_tf32_mma_kernel<D>, dq_tf32_smem<D>(), kTf32Threads);
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, const Geom& g,
        float scale, cudaStream_t s) {
  auto run = [&](auto kernel, size_t smem, int threads) {
    return launch_kernel(
        kernel, dim3(tiles(g.Tk), g.Hkv, g.B), threads, smem, s,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), g, scale);
  };
  if constexpr (std::is_same<T, bf16>::value)
    return run(flash_dkv_mma_kernel<D>, dkv_mma_smem<D>(), kMmaThreads);
  else
    return run(flash_dkv_tf32_mma_kernel<D>, dkv_tf32_smem<D>(),
               kTf32Threads);
}

}  // namespace

// Each entry point returns the launch status (cudaSuccess == 0). Shapes,
// types, strides and alignment are checked by the Python wrappers
// (akka_allreduce_tpu_torch/ops/kernels/flash_attention.py); `geom` is
// the int64 block they build: B, H, H_kv, Tq, Tk, causal, window (0 =
// none), q_off, k_off, then (batch, time, head) strides of q, k, v, dO.
extern "C" int flash_fwd_launch(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, void* o,
                                void* lse, const int64_t* geom, float scale,
                                void* stream) {
  const Geom g = read_geom(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) fwd<T, D>(q, k, v, o, lse, g, scale, s)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_dq_launch(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* out,
                               const int64_t* geom, float scale, void* stream) {
  const Geom g = read_geom(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) dq<T, D>(q, k, v, dout, lse, delta, out, g, scale, s)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int flash_dkv_launch(int dtype, int head_dim, const void* q,
                                const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, const int64_t* geom, float scale,
                                void* stream) {
  const Geom g = read_geom(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, g, scale, s)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
