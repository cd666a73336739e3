// Peer-memory ring and swing allreduce for Hopper (sm_90a), between the
// processes of a rank group.
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/ring.py
//           _ring_kernel  (called through pallas_ring_allreduce) and
//           _swing_kernel (called through pallas_swing_allreduce).
//
// What it computes: the sum over the n ranks of a flat f32 vector, every
// rank ending with the whole sum, on the TPU kernels' schedules and in
// their add order, each element a lone f32 add per step (no fast math), so
// the result is bitwise the plain version's
// (akka_allreduce_tpu_torch/ops/kernels/ring.py):
//   ring  — the vector as n ring blocks. Reduce-scatter steps t = 0..n-2:
//           the carry starts as block `my`; at step t the rank receives
//           the left neighbour's carry and adds block (my-1-t) mod n
//           (carry = received + local). After them the carry is the whole
//           sum of block (my+1) mod n. All-gather steps t = n-1..2n-3
//           forward the newest complete block; at phase step s the rank
//           receives block (my-s) mod n.
//   swing — log2(n) steps; at step t the rank exchanges its running sum
//           with the rank at XOR distance 2^t: out = out + partner's out.
//
// The TPU kernels' remote DMA becomes a store into the receiver's memory.
// Every rank owns one symmetric buffer (allocated with cudaMalloc and
// shared through CUDA IPC by parallel/group.py): two payload slots and a
// flag record per grid block. A sender stores its payload straight into
// the receiver's slot through the IPC mapping and then sets the
// receiver's `ready` flag of that slot; the receiver polls its own flags
// and reads its own slots. The same code runs between processes on one
// card and between cards over NVLink.
//
// Flow control. Steps are numbered across calls: T = steps run on the
// buffer before this call (the wrapper's counter, equal on every rank
// since all ranks make the same calls) + the step within the call. The
// payload of step T goes into slot T mod 2 and its flag value is T + 1:
//   ready[s]  = T + 1 of the last payload stored into slot s;
//   consumed  = T + 1 of the last payload this rank has read.
// Before it stores step T's payload, the sender waits until the receiver
// has consumed step T - 2, the last payload of that slot (the TPU
// kernels' slot-free grant). Flags only grow, so they never need a reset,
// and a value left by call k cannot let call k + 1 race ahead: this takes
// the place of the TPU kernels' "the final step grants nothing"
// (ring.py:102-109, :214-222). Flag loads are system-scope acquires and
// flag stores system-scope releases after the block's payload stores and
// a __syncthreads(), so no stale L1 line is read; payload slots are read
// with L2-only loads (__ldcg).
//
// Grid. A persistent grid of at most one block per SM: every block is
// resident, so a spinning block never waits on one that is not scheduled.
// Block g owns a fixed range of columns (a multiple of 128) of every ring
// block (of the whole vector for the swing) and runs its own copy of the
// schedule with its own flags: no block waits on another block of its own
// grid, only on block g of its neighbours.
//
// Waiting. Thread 0 of a block spins on a flag with __nanosleep under a
// deadline read from %globaltimer. Past the deadline it prints the rank,
// block, step and flag values and traps: a broken protocol becomes a CUDA
// error at the next synchronise, never a hang. Between processes on one
// card without MPS the card time-slices between the ranks' contexts, so a
// handshake can cost a time slice; the protocol stays correct.
//
// Bound: bytes. Per rank the ring reads its input once, writes its output
// once, and stores 2(n-1)/n of the vector into peer slots and reads the
// same back; the swing stores and reads the whole vector once per step.
// Each element costs one add, far below the card's f32 ridge. On one card
// all ranks share its memory rate. The kernels fuse the add with the
// forward store (the reduce-scatter carry and the swing's next payload are
// never stored locally first) and move float4s.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBlocks = 256;   // flag records per buffer
constexpr int kMaxSwingSteps = 16;
constexpr int64_t kLane = 128;    // a block's columns are whole lanes

typedef unsigned long long u64;

struct Flags {  // one per grid block, in the receiving rank's buffer
  u64 ready[2];
  u64 consumed;
  u64 pad;
};

struct SwingPeers {  // step t's partner's buffer, mapped into this process
  char* buf[kMaxSwingSteps];
};

__device__ __forceinline__ u64 load_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(u64* p, u64 v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block waits until *flag >= want. Past the deadline thread 0 prints
// what it waited for and traps.
__device__ void block_wait(const u64* flag, u64 want, const char* what,
                           int rank, u64 step, u64 deadline) {
  if (threadIdx.x == 0) {
    unsigned ns = 32;
    u64 got;
    while ((got = load_acquire(flag)) < want) {
      if (global_ns() > deadline) {
        printf("ring_allreduce.cu: rank %d block %d step %llu: deadline "
               "passed waiting for %s >= %llu (holds %llu)\n",
               rank, static_cast<int>(blockIdx.x), step, what, want, got);
        __trap();
      }
      __nanosleep(ns);
      if (ns < 2048) ns <<= 1;
    }
  }
  __syncthreads();
}

// Publishes the block's stores (and the end of its reads) before `value`.
__device__ void block_signal(u64* flag, u64 value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    store_release(flag, value);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4* slot(char* buf, int64_t slot_elems,
                                        u64 step) {
  return reinterpret_cast<float4*>(buf) + (step & 1) * (slot_elems / 4);
}

__device__ __forceinline__ Flags* flags(char* buf, int64_t slot_elems) {
  return reinterpret_cast<Flags*>(buf + 2 * slot_elems * 4) + blockIdx.x;
}

__global__ void __launch_bounds__(kThreads)
    ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                char* mine, char* right, int n, int my, int64_t block_elems,
                int64_t cols, u64 base, int rank, u64 timeout_ns) {
  const u64 deadline = global_ns() + timeout_ns;
  const int64_t bq = block_elems / 4;  // float4s per ring block
  const int64_t lo = blockIdx.x * cols / 4;
  const int64_t hi = min(lo + cols / 4, bq);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  Flags* mf = flags(mine, block_elems);
  Flags* rf = flags(right, block_elems);
  const int steps = 2 * (n - 1);

  // step 0's payload: my own block, into the right neighbour's slot
  block_wait(&rf->consumed, base > 0 ? base - 1 : 0, "right consumed", rank,
             base, deadline);
  {
    float4* dst = slot(right, block_elems, base);
    const float4* src = x4 + my * bq;
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      dst[i] = src[i];
    }
  }
  block_signal(&rf->ready[base & 1], base + 1);

  for (int t = 0; t < steps; ++t) {
    const u64 T = base + t;
    const bool send = t + 1 < steps;
    block_wait(&mf->ready[T & 1], T + 1, "own ready", rank, T, deadline);
    if (send) {
      block_wait(&rf->consumed, T, "right consumed", rank, T + 1, deadline);
    }
    const float4* recv = slot(mine, block_elems, T);
    float4* dst = slot(right, block_elems, T + 1);
    if (t < n - 1) {
      // reduce-scatter: carry = received + local block (ring.py:133)
      const float4* local = x4 + (((my - 1 - t) % n + n) % n) * bq;
      float4* owned = t == n - 2 ? out4 + ((my + 1) % n) * bq : nullptr;
      for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const float4 c = add4(__ldcg(recv + i), local[i]);
        if (owned) owned[i] = c;
        dst[i] = c;  // every reduce-scatter step sends on
      }
    } else {
      // all-gather: block (my - s) mod n arrives complete
      float4* got = out4 + (((my - (t - (n - 1))) % n + n) % n) * bq;
      for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const float4 c = __ldcg(recv + i);
        got[i] = c;
        if (send) dst[i] = c;
      }
    }
    block_signal(&mf->consumed, T + 1);
    if (send) block_signal(&rf->ready[(T + 1) & 1], T + 2);
  }
}

__global__ void __launch_bounds__(kThreads)
    swing_kernel(const float* __restrict__ x, float* __restrict__ out,
                 char* mine, SwingPeers peers, int steps, int64_t elems,
                 int64_t cols, u64 base, int rank, u64 timeout_ns) {
  const u64 deadline = global_ns() + timeout_ns;
  const int64_t lo = blockIdx.x * cols / 4;
  const int64_t hi = min(lo + cols / 4, elems / 4);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  Flags* mf = flags(mine, elems);

  // step 0's payload: my input, into the first partner's slot
  Flags* pf = flags(peers.buf[0], elems);
  block_wait(&pf->consumed, base > 0 ? base - 1 : 0, "partner consumed",
             rank, base, deadline);
  {
    float4* dst = slot(peers.buf[0], elems, base);
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      dst[i] = x4[i];
    }
  }
  block_signal(&pf->ready[base & 1], base + 1);

  for (int t = 0; t < steps; ++t) {
    const u64 T = base + t;
    const bool send = t + 1 < steps;
    block_wait(&mf->ready[T & 1], T + 1, "own ready", rank, T, deadline);
    char* next = send ? peers.buf[t + 1] : nullptr;
    if (send) {
      pf = flags(next, elems);
      block_wait(&pf->consumed, T, "partner consumed", rank, T + 1,
                 deadline);
    }
    const float4* recv = slot(mine, elems, T);
    const float4* cur = t == 0 ? x4 : out4;
    float4* dst = send ? slot(next, elems, T + 1) : nullptr;
    // out = out + partner's out (ring.py:223)
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const float4 c = add4(cur[i], __ldcg(recv + i));
      out4[i] = c;
      if (send) dst[i] = c;
    }
    block_signal(&mf->consumed, T + 1);
    if (send) block_signal(&pf->ready[(T + 1) & 1], T + 2);
  }
}

// Blocks and columns per block for `cols` columns (a multiple of 128):
// at most one block per SM and kMaxBlocks, no empty block.
int grid_for(int64_t cols, int64_t* per_block) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t lanes = cols / kLane;
  int64_t blocks = sms < kMaxBlocks ? sms : kMaxBlocks;
  if (blocks > lanes) blocks = lanes;
  const int64_t per = (lanes + blocks - 1) / blocks;
  *per_block = per * kLane;
  return static_cast<int>((lanes + per - 1) / per);
}

}  // namespace

// ---- peer buffers (parallel/group.py) -----------------------------------

// The flag records' bytes after a buffer's two slots.
extern "C" int64_t ring_allreduce_flag_bytes() {
  return static_cast<int64_t>(kMaxBlocks) * sizeof(Flags);
}

// cudaMalloc, never PyTorch's caching allocator: an IPC handle names the
// base of an allocation. Zeroed (the flags start at 0) and synchronised
// before the handle leaves the process.
extern "C" int peer_alloc(int64_t bytes, void** ptr) {
  cudaError_t rc = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (rc == cudaSuccess) rc = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (rc == cudaSuccess) rc = cudaDeviceSynchronize();
  return static_cast<int>(rc);
}

extern "C" int peer_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int peer_get_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(rc);
}

extern "C" int peer_open_handle(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int peer_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int peer_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// ---- the kernels (ops/kernels/ring.py) ----------------------------------

// Returns the launch status (cudaSuccess == 0). The Python wrapper checks
// dtype, shape, contiguity and divisibility (elems % (n * 128) == 0).
// `mine` is this rank's buffer, `right` the right neighbour's, mapped;
// each holds two slots of block_elems floats and the flag records.
extern "C" int ring_allreduce_launch(const void* x, void* out, void* mine,
                                     void* right, int n, int my,
                                     int64_t block_elems, uint64_t base,
                                     int rank, uint64_t timeout_ns,
                                     void* stream) {
  int64_t cols = 0;
  const int blocks = grid_for(block_elems, &cols);
  ring_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<char*>(mine), static_cast<char*>(right), n, my,
      block_elems, cols, base, rank, timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

// `peers` holds `steps` = log2(n) mapped buffers, step t's partner first;
// each buffer holds two slots of elems floats and the flag records.
extern "C" int swing_allreduce_launch(const void* x, void* out, void* mine,
                                      void* const* peers, int steps,
                                      int64_t elems, uint64_t base, int rank,
                                      uint64_t timeout_ns, void* stream) {
  if (steps < 1 || steps > kMaxSwingSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SwingPeers p;
  for (int t = 0; t < kMaxSwingSteps; ++t) {
    p.buf[t] = t < steps ? static_cast<char*>(peers[t]) : nullptr;
  }
  int64_t cols = 0;
  const int blocks = grid_for(elems, &cols);
  swing_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<char*>(mine), p, steps, elems, cols, base, rank,
      timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ring_allreduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
