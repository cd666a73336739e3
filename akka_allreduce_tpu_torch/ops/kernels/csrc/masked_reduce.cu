// Masked peer reduction for Hopper (sm_90a).
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/reduce.py _kernel
//           (called through fused_masked_reduce / masked_reduce_staged).
//
// What it computes, for a (peers, elems) f32 staging matrix whose rows lie
// ld floats apart (ld = elems for a contiguous matrix; the protocol
// plane's chunk reduce passes a slab of a wider staging row) and a
// (peers,) f32 mask:
//   count  = sum_p valid[p]
//   out[e] = (sum_p valid[p] * staged[p, e]) * (count > 0 ? target / max(count, 1) : 0)
// and writes count once, truncated to int32. The peers are summed in order
// p = 0, 1, ... in f32 with no fused multiply-add, so the result is a pure
// function of the inputs: the same for any grid, any column split and any
// window of the columns.
//
// Design (simple and right first): one pass over the columns. A thread
// owns 4 consecutive columns and reads each peer's 4 values with one
// 16-byte load (the scalar path takes rows whose length or leading
// dimension is not a multiple of 4, or a base that is not 16-byte
// aligned); a grid-stride loop covers any width. No shared memory, no
// tensor cores.
//
// Bound: bytes. Each staged value is read once and each output written
// once (4 * (peers + 1) bytes per column) for 2 * peers flops: far below
// the card's f32 ridge, so the memory rate is the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mask_scale(const float* __restrict__ valid,
                                            int peers, float target,
                                            float* count_out) {
  float count = 0.f;
  for (int p = 0; p < peers; ++p) count = __fadd_rn(count, valid[p]);
  *count_out = count;
  return count > 0.f ? __fdiv_rn(target, fmaxf(count, 1.f)) : 0.f;
}

__global__ void masked_reduce_vec4(const float* __restrict__ staged,
                                   const float* __restrict__ valid,
                                   float* __restrict__ out,
                                   int32_t* __restrict__ count_out,
                                   int peers, int64_t elems, int64_t ld,
                                   float target) {
  float count;
  const float scale = mask_scale(valid, peers, target, &count);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count_out = static_cast<int32_t>(count);
  }
  const int64_t n4 = elems / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < peers; ++p) {
      const float v = valid[p];
      const float4 x =
          reinterpret_cast<const float4*>(staged + p * ld)[i];
      acc.x = __fadd_rn(acc.x, __fmul_rn(v, x.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(v, x.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(v, x.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(v, x.w));
    }
    acc.x = __fmul_rn(acc.x, scale);
    acc.y = __fmul_rn(acc.y, scale);
    acc.z = __fmul_rn(acc.z, scale);
    acc.w = __fmul_rn(acc.w, scale);
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

__global__ void masked_reduce_scalar(const float* __restrict__ staged,
                                     const float* __restrict__ valid,
                                     float* __restrict__ out,
                                     int32_t* __restrict__ count_out,
                                     int peers, int64_t elems, int64_t ld,
                                     float target) {
  float count;
  const float scale = mask_scale(valid, peers, target, &count);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count_out = static_cast<int32_t>(count);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < elems; e += stride) {
    float acc = 0.f;
    for (int p = 0; p < peers; ++p) {
      acc = __fadd_rn(acc, __fmul_rn(valid[p], staged[p * ld + e]));
    }
    out[e] = __fmul_rn(acc, scale);
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16/SM
  return static_cast<int>(blocks);
}

}  // namespace

// Returns the launch status (cudaSuccess == 0). Shapes, types and
// strides are checked by the Python wrapper
// (akka_allreduce_tpu_torch/ops/kernels/masked_reduce.py): each row's
// elements are contiguous, rows ld floats apart.
extern "C" int masked_reduce_launch(const void* staged, const void* valid,
                                    void* out, void* count, int peers,
                                    int64_t elems, int64_t ld, float target,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = elems % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(staged) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    masked_reduce_vec4<<<grid_for(elems / 4), kThreads, 0, s>>>(
        static_cast<const float*>(staged), static_cast<const float*>(valid),
        static_cast<float*>(out), static_cast<int32_t*>(count), peers, elems,
        ld, target);
  } else {
    masked_reduce_scalar<<<grid_for(elems), kThreads, 0, s>>>(
        static_cast<const float*>(staged), static_cast<const float*>(valid),
        static_cast<float*>(out), static_cast<int32_t*>(count), peers, elems,
        ld, target);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* masked_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
