// Paged decode attention for Hopper (sm_90a), one query token per lane.
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/attention.py
//           _paged_fwd_kernel (called through paged_attention).
//
// What it computes: for every decode lane b and query head h,
//   out[b, 0, h] = softmax_j(q[b,0,h] . K[j] * D^-1/2) @ V
// over the lane's logical positions j <= pos[b], where logical position j
// lives at pool row (page_table[b, j / P], j % P) and query head h reads
// KV head h / (H / h_kv) (grouped-query attention). The pools keep the
// serving engine's layout (num_pages, P, h_kv, D), row-major.
//
// Design (simple and right first):
//   * one thread block per (kv head, lane): grid (h_kv, B);
//   * one warp per query head of the group (g = H / h_kv warps);
//   * the block walks the lane's live pages j < ceil((pos+1)/P), reading
//     page_table[b, j] itself (Hopper has no scalar prefetch). Each page's
//     K and V tiles (P x D each) are copied into shared memory with 16-byte
//     cp.async, double-buffered: page j+1 is in flight while page j is
//     used. The tile is staged once for the whole group, so the narrow
//     pool is read once per group;
//   * per page, each warp first computes all the page's scores (lanes
//     split D, a butterfly of warp shuffles sums each score), then one max
//     and one sum for the page — the Pallas kernel's _softmax_tile — and
//     then the value product. The running max, sum and accumulator stay in
//     f32 registers; the division happens once at the end;
//   * positions past pos[b] are skipped, which is what the NEG_INF mask
//     of the plain version amounts to (position 0 is always live, so the
//     sum is never 0 and a parked lane at pos 0 comes out finite).
//
// Bound: bytes. Each live K/V row is read once from device memory
// (2 * live_positions * h_kv * D * sizeof(T) per call), against
// ~4 * H * D flops per position: far below the card's ~20 flop/byte
// f32 ridge, so the memory rate is the limit.
//
// What holds it back: at the serving slice's shape (B=8, h_kv=4) it
// launches only B * h_kv = 32 blocks on 132 SMs, each walking its pages
// in sequence. Splitting a lane's pages across blocks (with a second pass
// that merges the partial softmax states) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;  // head_dim <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Start the copy of one page's K and V tiles (P x D each, rows strided by
// h_kv * D in the pool) into shared memory, 16 bytes per cp.async.
template <typename T>
__device__ __forceinline__ void load_page(T* k_dst, T* v_dst,
                                          const T* __restrict__ k_pages,
                                          const T* __restrict__ v_pages,
                                          size_t base, size_t row_stride,
                                          int page_size, int head_dim) {
  constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte copy
  const int row_chunks = head_dim / kChunk;
  const int n = page_size * row_chunks;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int t = c / row_chunks;
    const int e = (c - t * row_chunks) * kChunk;
    const size_t src = base + t * row_stride + e;
    cp_async16(k_dst + t * head_dim + e, k_pages + src);
    cp_async16(v_dst + t * head_dim + e, v_pages + src);
  }
}

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ pos, T* __restrict__ out, int n_heads,
    int h_kv, int head_dim, int page_size, int n_pt, float scale) {
  // shared memory: [2 buffers][K tile, V tile][P * D] of T, then the
  // per-warp score rows [g][P] of float
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = page_size * head_dim;
  T* tiles = reinterpret_cast<T*>(smem_raw);
  const int group = n_heads / h_kv;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* scores = reinterpret_cast<float*>(tiles + 4 * tile) +
                  warp * page_size;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int per_lane = head_dim / kWarp;
  const int head = hk * group + warp;

  const int lane_pos = pos[b];
  int n_live = lane_pos / page_size + 1;  // ceil((pos + 1) / P)
  if (n_live > n_pt) n_live = n_pt;
  const int32_t* table = page_table + static_cast<size_t>(b) * n_pt;
  const size_t row_stride = static_cast<size_t>(h_kv) * head_dim;
  const size_t page_stride = static_cast<size_t>(page_size) * row_stride;

  const T* q_row = q + (static_cast<size_t>(b) * n_heads + head) * head_dim;
  float qv[kMaxPerLane];
  float acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    qv[i] = i < per_lane ? to_float(q_row[lane + i * kWarp]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  load_page(tiles, tiles + tile, k_pages, v_pages,
            table[0] * page_stride + hk * head_dim, row_stride, page_size,
            head_dim);
  cp_async_commit();
  for (int j = 0; j < n_live; ++j) {
    if (j + 1 < n_live) {
      T* next = tiles + ((j + 1) & 1) * 2 * tile;
      load_page(next, next + tile, k_pages, v_pages,
                table[j + 1] * page_stride + hk * head_dim, row_stride,
                page_size, head_dim);
    }
    cp_async_commit();
    cp_async_wait_one();  // page j has landed (page j+1 may be in flight)
    __syncthreads();
    const T* k_tile = tiles + (j & 1) * 2 * tile;
    const T* v_tile = k_tile + tile;
    int valid = lane_pos - j * page_size + 1;
    if (valid > page_size) valid = page_size;

    // 1. every score of the page, and the page's max
    float m_page = kNegInf;
#pragma unroll 4
    for (int t = 0; t < valid; ++t) {
      const T* k_row = k_tile + t * head_dim;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) s += qv[i] * to_float(k_row[lane + i * kWarp]);
      }
      s = warp_sum(s) * scale;
      if (lane == 0) scores[t] = s;
      m_page = fmaxf(m_page, s);
    }
    __syncwarp();
    // 2. rescale the running state once for the page; probabilities
    const float m_new = fmaxf(m, m_page);
    const float corr = expf(m - m_new);
    float p_sum = 0.f;
    for (int t = lane; t < valid; t += kWarp) {
      const float p = expf(scores[t] - m_new);
      scores[t] = p;
      p_sum += p;
    }
    l = l * corr + warp_sum(p_sum);
    __syncwarp();
    // 3. the value product
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int t = 0; t < valid; ++t) {
      const float p = scores[t];
      const T* v_row = v_tile + t * head_dim;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) acc[i] += p * to_float(v_row[lane + i * kWarp]);
      }
    }
    m = m_new;
    __syncthreads();  // every warp is done with this buffer and its scores
  }

  T* o_row = out + (static_cast<size_t>(b) * n_heads + head) * head_dim;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < per_lane) store(&o_row[lane + i * kWarp], acc[i] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* pos, void* out, int batch,
           int n_heads, int h_kv, int head_dim, int page_size, int n_pt,
           float scale, cudaStream_t stream) {
  const int group = n_heads / h_kv;
  const size_t smem = 4 * static_cast<size_t>(page_size) * head_dim * sizeof(T) +
                      static_cast<size_t>(group) * page_size * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(h_kv, batch);
  const dim3 block(group * kWarp);
  paged_attention_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), n_heads, h_kv,
      head_dim, page_size, n_pt, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch status
// (cudaSuccess == 0). Shapes and types are checked by the Python wrapper
// (akka_allreduce_tpu_torch/ops/kernels/attention.py paged_attention).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table, const void* pos,
                                      void* out, int batch, int n_heads,
                                      int h_kv, int head_dim, int page_size,
                                      int n_pt, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k_pages, v_pages, page_table, pos, out, batch,
                         n_heads, h_kv, head_dim, page_size, n_pt, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, pos, out,
                                 batch, n_heads, h_kv, head_dim, page_size,
                                 n_pt, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
