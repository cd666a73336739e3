// Symmetric int8 quantize and dequantize for Hopper (sm_90a): the wire
// format of the int8 and ef8 gradient sync.
//
// Replaces, in akka_allreduce_tpu/ops/pallas_kernels/quantized.py:
//   _quantize_kernel            (quantize_int8: per-row scales, bits input)
//   _dequantize_kernel          (dequantize_int8)
//   _quantize_prng_kernel       (quantize_int8_prng: per-row scales, bits
//                                from a generator inside the kernel)
//   _quantize_block_kernel      (quantize_int8_block: block scales, bits)
//   _quantize_block_rtn_kernel  (quantize_int8_block_rtn: block scales,
//                                round half to even)
//   _dequantize_block_kernel    (dequantize_int8_block)
//
// What it computes, for x (rows, cols) f32 and scales (rows, nb) f32, one
// scale per `block` columns (per-row scales: nb = 1, block = cols):
//   scaled = x / scale                     (IEEE division, rounded once)
//   stochastic: floor(scaled) + (scaled - floor(scaled) > (w >> 8) * 2^-24)
//   round to nearest: rint(scaled)         (half to even)
//   value  = clip(that, -127, 127) as int8
// and the inverse value * scale. w is a uint32 random word per element:
// read from a bits tensor (BITS) or drawn here by Philox4x32-10 (PHILOX),
// keyed by the 64-bit seed with the counter (element index / 4, 0, 0)
// and element 4g + j taking word j of group g. The stream is thus a pure
// function of (seed, element index): the same for any grid, and the
// plain PyTorch version draws the same words (bitwise-equal wire bytes).
// The JAX package's hardware PRNG cannot be matched; its bits differ.
// The seed comes by value, or (`seed_ptr` non-null) as a uint64 in device
// memory that the kernel reads when it runs: a CUDA graph that captured
// the launch then draws the words of whatever seed was written there
// before its replay, and the words of one seed are the same either way.
//
// Scales are computed outside the kernels, as the JAX package does
// (per-row or per-block abs-max / 127, floored at 1e-30).
//
// Design (simple and right first): a thread owns 4 consecutive elements
// of the row-major matrix. Where the row length and the block width are
// multiples of 4 and the pointers aligned, the 4 share one row and one
// scale and move as one 16-byte f32 load (and a 16-byte bits load) and
// one 4-byte int8 store; otherwise each element is handled alone. A
// grid-stride loop covers any size. No shared memory, no tensor cores; no
// fast-math, so the division and the rounding are IEEE's.
//
// Bound: bytes. Per element 4 (x) + 1 (value) bytes, + 4 with a bits
// tensor; 1 + 4 to dequantize; a few f32 operations (and for PHILOX ~20
// integer operations) per element are far below the card's ALU rates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRtn = 0;
constexpr int kBits = 1;
constexpr int kPhilox = 2;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

template <int Mode>
__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               uint32_t word) {
  const float scaled = __fdiv_rn(x, scale);
  float q;
  if (Mode == kRtn) {
    q = rintf(scaled);
  } else {
    const float low = floorf(scaled);
    const float frac = __fsub_rn(scaled, low);
    const float u = __fmul_rn(__uint2float_rn(word >> 8),
                              5.9604644775390625e-08f);  // 2^-24
    q = __fadd_rn(low, frac > u ? 1.f : 0.f);
  }
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(q));
}

template <int Mode>
__global__ void quantize_kernel(const float* __restrict__ x,
                                const int32_t* __restrict__ bits,
                                const float* __restrict__ scales,
                                int8_t* __restrict__ out, int64_t total,
                                int64_t cols, int64_t nb, int64_t block,
                                uint64_t seed,
                                const uint64_t* __restrict__ seed_ptr,
                                bool vec) {
  const int64_t groups = (total + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (Mode == kPhilox && seed_ptr != nullptr) seed = *seed_ptr;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (Mode == kPhilox) {
      w = philox4x32_10(make_uint4(static_cast<uint32_t>(g),
                                   static_cast<uint32_t>(g >> 32), 0u, 0u),
                        key);
    }
    const int64_t i0 = 4 * g;
    if (vec) {
      const int64_t row = i0 / cols;
      const int64_t col = i0 - row * cols;
      const float s = scales[row * nb + col / block];
      const float4 xv = reinterpret_cast<const float4*>(x)[g];
      if (Mode == kBits) {
        const int4 b = reinterpret_cast<const int4*>(bits)[g];
        w = make_uint4(b.x, b.y, b.z, b.w);
      }
      char4 q;
      q.x = quantize_one<Mode>(xv.x, s, w.x);
      q.y = quantize_one<Mode>(xv.y, s, w.y);
      q.z = quantize_one<Mode>(xv.z, s, w.z);
      q.w = quantize_one<Mode>(xv.w, s, w.w);
      reinterpret_cast<char4*>(out)[g] = q;
    } else {
      for (int j = 0; j < 4 && i0 + j < total; ++j) {
        const int64_t i = i0 + j;
        const int64_t row = i / cols;
        const int64_t col = i - row * cols;
        const uint32_t word =
            Mode == kBits ? static_cast<uint32_t>(bits[i]) : word_of(w, j);
        out[i] = quantize_one<Mode>(x[i], scales[row * nb + col / block],
                                    word);
      }
    }
  }
}

__global__ void dequantize_kernel(const int8_t* __restrict__ values,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, int64_t total,
                                  int64_t cols, int64_t nb, int64_t block,
                                  bool vec) {
  const int64_t groups = (total + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = 4 * g;
    if (vec) {
      const int64_t row = i0 / cols;
      const int64_t col = i0 - row * cols;
      const float s = scales[row * nb + col / block];
      const char4 v = reinterpret_cast<const char4*>(values)[g];
      reinterpret_cast<float4*>(out)[g] = make_float4(
          __fmul_rn(static_cast<float>(v.x), s),
          __fmul_rn(static_cast<float>(v.y), s),
          __fmul_rn(static_cast<float>(v.z), s),
          __fmul_rn(static_cast<float>(v.w), s));
    } else {
      for (int j = 0; j < 4 && i0 + j < total; ++j) {
        const int64_t i = i0 + j;
        const int64_t row = i / cols;
        const int64_t col = i - row * cols;
        out[i] = __fmul_rn(static_cast<float>(values[i]),
                           scales[row * nb + col / block]);
      }
    }
  }
}

int grid_for(int64_t total) {
  int64_t blocks = ((total + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16/SM
  return static_cast<int>(blocks);
}

bool aligned(const void* p, uintptr_t n) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// mode: 0 = round half to even, 1 = stochastic from `bits` (int32 words
// read as uint32), 2 = stochastic from Philox4x32-10 keyed by `seed`, or
// by the uint64 at `seed_ptr` (device memory) when that is non-null.
// Returns the launch status (cudaSuccess == 0). Shapes, types and
// contiguity are checked by the Python wrapper
// (akka_allreduce_tpu_torch/ops/kernels/quantized.py).
extern "C" int quantize_launch(int mode, const void* x, const void* bits,
                               const void* scales, void* out, int64_t rows,
                               int64_t cols, int64_t nb, int64_t block,
                               uint64_t seed, const void* seed_ptr,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = rows * cols;
  const bool vec = cols % 4 == 0 && block % 4 == 0 && aligned(x, 16) &&
                   aligned(bits, 16) && aligned(out, 4);
  const dim3 grid(grid_for(total));
  const float* xf = static_cast<const float*>(x);
  const int32_t* bi = static_cast<const int32_t*>(bits);
  const float* sc = static_cast<const float*>(scales);
  int8_t* o = static_cast<int8_t*>(out);
  const uint64_t* sp = static_cast<const uint64_t*>(seed_ptr);
  if (mode == kRtn) {
    quantize_kernel<kRtn><<<grid, kThreads, 0, s>>>(
        xf, bi, sc, o, total, cols, nb, block, seed, sp, vec);
  } else if (mode == kBits) {
    quantize_kernel<kBits><<<grid, kThreads, 0, s>>>(
        xf, bi, sc, o, total, cols, nb, block, seed, sp, vec);
  } else if (mode == kPhilox) {
    quantize_kernel<kPhilox><<<grid, kThreads, 0, s>>>(
        xf, bi, sc, o, total, cols, nb, block, seed, sp, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_launch(const void* values, const void* scales,
                                 void* out, int64_t rows, int64_t cols,
                                 int64_t nb, int64_t block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = rows * cols;
  const bool vec = cols % 4 == 0 && block % 4 == 0 && aligned(values, 4) &&
                   aligned(out, 16);
  dequantize_kernel<<<grid_for(total), kThreads, 0, s>>>(
      static_cast<const int8_t*>(values), static_cast<const float*>(scales),
      static_cast<float*>(out), total, cols, nb, block, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
