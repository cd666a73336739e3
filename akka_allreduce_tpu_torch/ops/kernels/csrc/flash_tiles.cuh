// Shared tile machinery of the flash attention kernels (flash_attention.cu)
// and the ring flash attention kernels (ring_flash.cu): the geometry and
// its masks, and the launch and dtype dispatch.
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
// Layout of the work, which every fold keeps (flash_mma.cuh in bf16,
// flash_tf32.cuh in f32):
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
// Every flash and ring-flash kernel runs on the tensor cores: in bf16 on
// flash_mma.cuh's folds (mma.sync m16n8k16), in f32 on flash_tf32.cuh's
// (mma.sync m16n8k8 in split TF32: three TF32 products a product).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // rows of a query or key tile
constexpr float kNegInf = -1e30f;

struct Geom {
  int B, H, Hkv, Tq, Tk, causal, window, q_off, k_off;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
};

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

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64 or 128.
#define FLASH_DISPATCH(CALL)                                              \
  if (dtype == 0 && head_dim == 32) return CALL(float, 32);               \
  if (dtype == 0 && head_dim == 64) return CALL(float, 64);               \
  if (dtype == 0 && head_dim == 128) return CALL(float, 128);             \
  if (dtype == 1 && head_dim == 32) return CALL(__nv_bfloat16, 32);       \
  if (dtype == 1 && head_dim == 64) return CALL(__nv_bfloat16, 64);       \
  if (dtype == 1 && head_dim == 128) return CALL(__nv_bfloat16, 128);     \
  return static_cast<int>(cudaErrorInvalidValue)

}  // namespace
