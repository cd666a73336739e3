// Ring flash attention, one ring hop per launch, for Hopper (sm_90a).
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/ring_flash.py
//   _ring_fwd_kernel  (fold the resident K/V block into the carries)
//   _ring_dq_kernel   (the f32 partial dq from the resident block)
//   _ring_dkv_kernel  (the f32 partial dk, dv of the visiting block)
//
// Under sequence parallelism rank r owns positions [r T, (r + 1) T); K/V
// blocks travel around the sp ring and each hop scores this rank's
// queries (q_off = r T) against the block of rank src (k_off = src T).
// The offsets are runtime ints: the host knows the rank and the hop.
//
//   ring_fwd  reads the running (m, l) (B, H, T) f32 and acc (B, T, H, D)
//             f32 of this rank's queries, folds in every live key tile of
//             the hop's block (fwd_mma_fold in bf16, fwd_tf32_fold in f32:
//             the where-guard keeps a fully masked row exactly 0) and writes
//             them back UNNORMALISED, m in natural-log units; the caller
//             divides acc by l and takes lse = m + log l once, after the
//             last hop.
//   ring_dq   adds this hop's partial dq, kept in f32 registers over the
//             key tiles, into the travelling f32 dq (B, T, H, D): one
//             read-modify-write per element, so dq = dq + partial as in
//             the JAX step.
//   ring_dkv  adds the visiting block's partial (dk, dv) at H_kv heads,
//             summed in f32 over the GQA group's query heads, into the
//             travelling f32 dk, dv (B, T, H_kv, D). One block per (key
//             tile, KV head, batch) walks the whole group: no atomics.
//
// Each block owns its rows of the carry or of the accumulators, so they
// are updated in place (no second copy of the f32 state on the card).
// The tile arithmetic, cast points and masks are the flash kernels':
// every hop kernel runs the fold of the flash kernel of the same product,
// the same function that flash_attention.cu runs, flash_mma.cuh's
// tensor-core folds in bf16 and flash_tf32.cuh's split-TF32 folds in f32.
// Ragged T is masked at the edge.
//
// Bound: a hop is the flash kernel's work on a (T, T) block pair, ~4 (fwd),
// ~6 (dq), ~8 (dk/dv) flops per D-element of every live (q, k) pair, so at
// T = 1024, D = 128 the arithmetic rate bounds it (989 TFLOP/s bf16 on the
// tensor cores; in f32 ~165 TFLOP/s of f32 work as three TF32 products at
// 495; a past hop at B 8, H 16, H_kv 4 in bf16: forward 0.0695 ms, dq
// 0.1042, dk/dv 0.1390; in split TF32: forward 0.42, dq 0.62, dk/dv 0.83);
// the f32 carries and accumulators add 2 x 4 B per D-element read and
// written, well under the operations' time. What the design does about
// it: every hop kernel runs the flash kernels' tensor-core fold and only
// its epilogue is the ring's. In bf16 (flash_mma.cuh: mma.sync from
// ldmatrix, the score tiles kept in registers, the streamed tiles copied
// by cp.async under the products) ring_fwd_mma_kernel (fwd_mma_fold)
// loads and stores the carry, ring_dq_mma_kernel (dq_mma_fold) and
// ring_dkv_mma_kernel (dkv_mma_fold) add their f32 fragments into the
// accumulators, one float2 at a time. In f32 every product runs on the
// tensor cores as three TF32 products (one would break parity with the
// f32 reference): ring_fwd_tf32_mma_kernel (fwd_tf32_fold) loads and
// stores the carry, ring_dq_tf32_mma_kernel (dq_tf32_fold) and
// ring_dkv_tf32_mma_kernel (dkv_tf32_fold) add their paired-column
// fragments one float4 at a time.

#include <type_traits>

#include "flash_tf32.cuh"

namespace {

// ---------------------------------------------------------------- forward
// The bf16 hop on tensor cores (replaces _ring_fwd_kernel for bf16): each
// block loads its rows' carry into the accumulator fragments' layout (m
// and l for rows lane / 4 and + 8, acc as float2 at columns 2 (lane % 4)
// + {0, 1} of each 8-wide n-tile), runs fwd_mma_fold (flash_mma.cuh) and
// writes the carry back in place, unnormalised and in natural-log units,
// as it came.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, fwd_mma_min_blocks<D>())
ring_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, float* __restrict__ m_io,
                    float* __restrict__ l_io, float* __restrict__ acc_io,
                    Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (g.H / g.Hkv);
  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
  // row qi's m and l of (batch bb, head hh), and its acc at this lane's
  // first column
  auto ml_at = [&](int bb, int hh, int qi) {
    return (static_cast<long long>(bb) * g.H + hh) * g.Tq + qi;
  };
  auto acc_at = [&](int bb, int hh, int qi) {
    return ((static_cast<long long>(bb) * g.Tq + qi) * g.H + hh) * D + 2 * tq;
  };

  // rows past Tq start empty and are never stored
  float m[2], l[2], acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    const bool in = qi < g.Tq;
    m[i] = in ? m_io[ml_at(b, h, qi)] : kNegInf;
    l[i] = in ? l_io[ml_at(b, h, qi)] : 0.f;
    const float* row = acc_io + acc_at(b, h, qi);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = in ? *reinterpret_cast<const float2*>(row + 8 * j)
                          : make_float2(0.f, 0.f);
      acc[j][2 * i] = x.x;
      acc[j][2 * i + 1] = x.y;
    }
  }
  fwd_mma_fold<D>(reinterpret_cast<bf16*>(smem),
                  q + b * g.q_sb + h * g.q_sh, k + b * g.k_sb + hk * g.k_sh,
                  v + b * g.v_sb + hk * g.v_sh, g, q0, scale, m, l, acc);

  // the store addresses are derived afresh (opaque), so that the load's
  // do not stay live across the fold: under the launch bounds' 168
  // registers they spilled
  const int be = static_cast<int>(opaque(b)), he = static_cast<int>(opaque(h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= g.Tq) continue;
    float* row = acc_io + acc_at(be, he, qi);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    if (tq == 0) {
      m_io[ml_at(be, he, qi)] = m[i];
      l_io[ml_at(be, he, qi)] = l[i];
    }
  }
}

// The f32 hop on tensor cores in split TF32 (replaces _ring_fwd_kernel
// for f32; a past hop at the sequence-parallel slice's shape is bound at
// 0.42 ms): warps 0-3 load their rows' carry into the fold's layout (m
// and l for rows lane / 4 and + 8, acc in paired columns, one float4 per
// 16 columns) and warps 4-7 start empty; fwd_tf32_fold (flash_tf32.cuh)
// merges the pair, and each warp writes its half of the carry's columns
// back in place (query_tile_epilogue), unnormalised and in natural-log
// units, as it came; warps 0-3 write m and l. The grid is the flash
// kernel's, the longest causal bands first. A row with no live key in
// the hop comes back bitwise as it came (corr = 1, p = 0; the empty
// partner's share is scaled by exp(NEG_INF - m) = 0).
template <int D>
__global__ void __launch_bounds__(kTf32Threads, fwd_tf32_min_blocks<D>())
ring_fwd_tf32_mma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         float* __restrict__ m_io, float* __restrict__ l_io,
                         float* __restrict__ acc_io, Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * (warp % 4) + (lane >> 2);
  const long long ml0 = (static_cast<long long>(b) * g.H + h) * g.Tq;

  // rows past Tq start empty and are never stored
  float m[2], l[2], acc[D / 8][4];
  zero_frags(acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    const bool in = warp < 4 && qi < g.Tq;
    m[i] = in ? m_io[ml0 + qi] : kNegInf;
    l[i] = in ? l_io[ml0 + qi] : 0.f;
    if (in)
      get_paired_row<D>(
          acc_io + ((static_cast<long long>(b) * g.Tq + qi) * g.H + h) * D,
          acc, i);
  }
  fwd_tf32_fold<D>(reinterpret_cast<float*>(smem), q, k, v, g, b, h, q0,
                   scale, m, l, acc);
  query_tile_epilogue<false, D>(acc_io, acc, g, b, h, q0);

  // m and l are the pair's merged ones in both warps: warps 0-3 store
  if (threadIdx.x >= 4 * 32 || (lane & 3) != 0) return;
  const int be = static_cast<int>(opaque(b)), he = static_cast<int>(opaque(h));
  const long long ml = (static_cast<long long>(be) * g.H + he) * g.Tq;
  const int rs = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = rs + 8 * i;
    if (qi < g.Tq) {
      m_io[ml + qi] = m[i];
      l_io[ml + qi] = l[i];
    }
  }
}

// ------------------------------------------------- dq and dk/dv, bf16
// row[8 j + 2 (lane % 4) + {0, 1}] += this lane's accumulator pair of
// fragment row i (0: lane / 4, 1: + 8), one float2 read-modify-write at a
// time: the ring forward's carry layout.
template <int D>
__device__ __forceinline__ void add_frag_row(float* row,
                                             const float (&acc)[D / 8][4],
                                             int i) {
  row += 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float2* p = reinterpret_cast<float2*>(row + 8 * j);
    float2 x = *p;
    x.x += acc[j][2 * i];
    x.y += acc[j][2 * i + 1];
    *p = x;
  }
}

// The bf16 hops on tensor cores (replace _ring_dq_kernel and
// _ring_dkv_kernel for bf16): the flash backward's folds (flash_mma.cuh
// dq_mma_fold, dkv_mma_fold) on the hop's offsets, then the f32 partials
// added in place into the travelling accumulators. The grids are the
// flash kernels'. The accumulator addresses are derived afresh after the
// fold (opaque), so that no address stays live across its main loop.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
ring_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq_io,
                   Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  float acc[D / 8][4];
  dq_mma_fold<D>(reinterpret_cast<bf16*>(smem), q, k, v, dout, lse, delta, g,
                 b, h, q0, scale, acc);

  const int lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * (threadIdx.x / 32) + (lane >> 2);
  const int be = static_cast<int>(opaque(b)), he = static_cast<int>(opaque(h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= g.Tq) continue;
    add_frag_row<D>(
        dq_io + ((static_cast<long long>(be) * g.Tq + qi) * g.H + he) * D,
        acc, i);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
ring_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dk_io, float* __restrict__ dv_io,
                    Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  dkv_mma_fold<D>(reinterpret_cast<bf16*>(smem), q, k, v, dout, lse, delta,
                  g, b, hk, k0, scale, dk_acc, dv_acc);

  const int lane = threadIdx.x % 32;
  const int kr0 = k0 + 16 * (threadIdx.x / 32) + (lane >> 2);
  const int be = static_cast<int>(opaque(b));
  const int hke = static_cast<int>(opaque(hk));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kr0 + 8 * i;
    if (kj >= g.Tk) continue;
    const long long off =
        ((static_cast<long long>(be) * g.Tk + kj) * g.Hkv + hke) * D;
    add_frag_row<D>(dk_io + off, dk_acc, i);
    add_frag_row<D>(dv_io + off, dv_acc, i);
  }
}

// ------------------------------------------------- dq and dk/dv, f32
// The f32 hops on tensor cores in split TF32 (replace _ring_dq_kernel and
// _ring_dkv_kernel for f32): flash_tf32.cuh's dq_tf32_fold and
// dkv_tf32_fold on the hop's offsets, then the f32 partials added in
// place into the travelling accumulators, each warp its half (dq: half
// the columns of its rows; dk/dv: warps 0-3 dk, 4-7 dv). Bound: three
// TF32 products a product at 495 TFLOP/s, ~165 TFLOP/s of f32 work (a
// past hop at B 8, T 1024, H 16, H_kv 4, D 128: dq 0.62 ms, dk/dv 0.83);
// the design's answer is in flash_tf32.cuh, and so are the epilogues
// (query_tile_epilogue, dkv_tf32_epilogue, which the flash kernels share:
// here they add one float4 per 16 columns, deriving the accumulator
// addresses afresh after the fold). The grids are the bf16 kernels' (dq
// the longest causal bands first), 8 warps a block (kTf32Threads), one
// block an SM at D = 128 (~200 KB of shared memory), two at D = 64; the
// launch bounds say one block an SM, so that ptxas does not spill to fit
// more.
template <int D>
__global__ void __launch_bounds__(kTf32Threads, 1)
ring_dq_tf32_mma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_io, Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  float acc[D / 8][4];
  dq_tf32_fold<D>(reinterpret_cast<float*>(smem), q, k, v, dout, lse, delta,
                  g, b, h, q0, scale, acc);
  query_tile_epilogue<true, D>(dq_io, acc, g, b, h, q0);
}

template <int D>
__global__ void __launch_bounds__(kTf32Threads, 1)
ring_dkv_tf32_mma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk_io, float* __restrict__ dv_io,
                         Geom g, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  dkv_tf32_fold<D>(reinterpret_cast<float*>(smem), q, k, v, dout, lse,
                   delta, g, b, hk, k0, scale, dk_acc, dv_acc);
  dkv_tf32_epilogue<true, D>(dk_io, dv_io, dk_acc, dv_acc, g, b, hk, k0);
}

// ----------------------------------------------------------------- launch
// bf16 on the tensor-core tiles (flash_mma.cuh), f32 on split TF32
// (flash_tf32.cuh)
template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* m, void* l,
        void* acc, const Geom& g, float scale, cudaStream_t s) {
  auto run = [&](auto kernel, size_t smem, int threads) {
    return launch_kernel(
        kernel, dim3(tiles(g.Tq), g.H, g.B), threads, smem, s,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(acc), g, scale);
  };
  if constexpr (std::is_same<T, bf16>::value)
    return run(ring_fwd_mma_kernel<D>, fwd_mma_smem<D>(), kMmaThreads);
  else
    return run(ring_fwd_tf32_mma_kernel<D>, fwd_tf32_smem<D>(),
               kTf32Threads);
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dq_io, const Geom& g,
       float scale, cudaStream_t s) {
  auto run = [&](auto kernel, size_t smem, int threads) {
    return launch_kernel(
        kernel, dim3(tiles(g.Tq), g.H, g.B), threads, smem, s,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq_io), g, scale);
  };
  if constexpr (std::is_same<T, bf16>::value)
    return run(ring_dq_mma_kernel<D>, dq_mma_smem<D>(), kMmaThreads);
  else
    return run(ring_dq_tf32_mma_kernel<D>, dq_tf32_smem<D>(), kTf32Threads);
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk_io, void* dv_io,
        const Geom& g, float scale, cudaStream_t s) {
  auto run = [&](auto kernel, size_t smem, int threads) {
    return launch_kernel(
        kernel, dim3(tiles(g.Tk), g.Hkv, g.B), threads, smem, s,
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk_io), static_cast<float*>(dv_io), g, scale);
  };
  if constexpr (std::is_same<T, bf16>::value)
    return run(ring_dkv_mma_kernel<D>, dkv_mma_smem<D>(), kMmaThreads);
  else
    return run(ring_dkv_tf32_mma_kernel<D>, dkv_tf32_smem<D>(),
               kTf32Threads);
}

}  // namespace

// Each entry point returns the launch status (cudaSuccess == 0). Shapes,
// types, strides, contiguity and alignment are checked by the Python
// wrappers (akka_allreduce_tpu_torch/ops/kernels/ring_flash.py); `geom` is
// the flash kernels' int64 block: B, H, H_kv, Tq, Tk, causal, window
// (always 0 here), q_off, k_off, then (batch, time, head) strides of q,
// k, v, dO. The f32 carries and accumulators are contiguous.
extern "C" int ring_fwd_launch(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, void* m, void* l,
                               void* acc, const int64_t* geom, float scale,
                               void* stream) {
  const Geom g = read_geom(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) fwd<T, D>(q, k, v, m, l, acc, g, scale, s)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int ring_dq_launch(int dtype, int head_dim, const void* q,
                              const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dq_io,
                              const int64_t* geom, float scale, void* stream) {
  const Geom g = read_geom(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) dq<T, D>(q, k, v, dout, lse, delta, dq_io, g, scale, s)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" int ring_dkv_launch(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk_io,
                               void* dv_io, const int64_t* geom, float scale,
                               void* stream) {
  const Geom g = read_geom(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(T, D) dkv<T, D>(q, k, v, dout, lse, delta, dk_io, dv_io, g, scale, s)
  FLASH_DISPATCH(CALL);
#undef CALL
}

extern "C" const char* ring_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
