// Peer memory between the processes of a rank group, shared by the
// peer-memory allreduce (ring_allreduce.cu) and the rank transport
// (transport.cu).
//
// Device side: the release signals a stretch sends its peers, the
// abandon check and launch count at a stretch's start, and the ticket
// that picks a grid's last block. Host side: the buffers themselves
// (cudaMalloc and CUDA IPC handles, used by parallel/group.py), the
// driver's stream-wait entry point (fetched through
// cudaGetDriverEntryPoint, no -lcuda), the side stream and pinned words
// that read or release counters while a call's stream is blocked, and
// the error strings. Each library that includes this file gets its own
// copy of the host state.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace peer_mem {

typedef unsigned long long u64;

constexpr int kMaxRanks = 32;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: a full SM

__device__ __forceinline__ void release_add(u64* p, u64 v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A counter with one writer that only grows: max, so that a value an
// abandon raised (peer_mem_release) is never lowered by a late signal.
__device__ __forceinline__ void release_max(u64* p, u64 v) {
  asm volatile("red.release.sys.global.max.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// False in every thread of the block once the buffer's calls were
// abandoned (`abandoned` non-zero): the stretch then reads and stores
// nothing and signals no peer. Else the grid's first block counts the
// stretch in `ran` and the stretch runs.
__device__ __forceinline__ bool begin_stretch(const u64* abandoned,
                                              u64* ran) {
  const bool first = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;
  if (__syncthreads_or(threadIdx.x == 0 &&
                       *reinterpret_cast<const volatile u64*>(abandoned) !=
                           0)) {
    return false;
  }
  if (first) atomicAdd(ran, 1ull);
  return true;
}

// After the block's stores, in thread 0: true in the grid's last block to
// get here, with every block's stores fenced at system scope. The ticket
// is reset for the next stretch (which launches after this one ends).
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __threadfence_system();
  const unsigned blocks = gridDim.x * gridDim.y;
  if (atomicAdd(ticket, 1u) != blocks - 1) return false;
  *ticket = 0;
  __threadfence_system();
  return true;
}

inline int grid_x(long long units, int per_block, int rows) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (units + per_block - 1) / per_block;
  long long cap = static_cast<long long>(sms) * kBlocksPerSm / rows;
  if (cap < 1) cap = 1;
  const long long g = want < cap ? want : cap;
  return static_cast<int>(g < 1 ? 1 : g);
}

typedef CUresult (*WaitValue64)(CUstream, CUdeviceptr, cuuint64_t,
                                unsigned int);
typedef CUresult (*DeviceGet)(CUdevice*, int);
typedef CUresult (*DeviceGetAttribute)(int*, CUdevice_attribute, CUdevice);
typedef CUresult (*GetErrorString)(CUresult, const char**);

namespace {

WaitValue64 g_wait = nullptr;
GetErrorString g_error = nullptr;
// For reading or releasing counters while a call's stream is blocked: a
// stream that never waits on the legacy stream, and pinned memory (a
// pageable copy may serialise behind the blocked stream). Made at init.
cudaStream_t g_side = nullptr;
constexpr int kHostWords = 2 * kMaxRanks + 8;
u64* g_host = nullptr;
// Stream waits enqueued since load.
unsigned long long g_waits = 0;

}  // namespace

// Driver errors travel as negative codes; the runtime's are positive.
constexpr int kNoDriverEntryPoint = -100000;
constexpr int kNoStreamMemOps = -100001;

inline void* entry_point(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t rc = cudaGetDriverEntryPointByVersion(
      name, &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t rc =
      cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn
                                                                   : nullptr;
}

// Fetches the driver's stream-wait entry point and checks that the current
// device takes 64-bit stream memory operations. 0, or an error code.
inline int init() {
  if (g_wait != nullptr) return 0;
  auto error = reinterpret_cast<GetErrorString>(entry_point("cuGetErrorString"));
  auto wait = reinterpret_cast<WaitValue64>(entry_point("cuStreamWaitValue64"));
  auto get = reinterpret_cast<DeviceGet>(entry_point("cuDeviceGet"));
  auto attr =
      reinterpret_cast<DeviceGetAttribute>(entry_point("cuDeviceGetAttribute"));
  if (!error || !wait || !get || !attr) return kNoDriverEntryPoint;
  g_error = error;
  int ordinal = 0;
  cudaError_t rt = cudaGetDevice(&ordinal);
  if (rt != cudaSuccess) return static_cast<int>(rt);
  CUdevice dev;
  CUresult rc = get(&dev, ordinal);
  int can = 0;
  if (rc == CUDA_SUCCESS) {
    rc = attr(&can, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev);
  }
  if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  if (!can) return kNoStreamMemOps;
  rt = cudaStreamCreateWithFlags(&g_side, cudaStreamNonBlocking);
  if (rt == cudaSuccess) {
    rt = cudaHostAlloc(reinterpret_cast<void**>(&g_host),
                       kHostWords * sizeof(u64), cudaHostAllocDefault);
  }
  if (rt != cudaSuccess) return static_cast<int>(rt);
  g_wait = wait;
  return 0;
}

// The stream waits until the u64 at `counter` is >= `want`: a stream
// memory operation, off the SMs.
inline int wait_counter(cudaStream_t stream, const u64* counter, u64 want) {
  if (g_wait == nullptr) return kNoDriverEntryPoint;
  const CUresult rc =
      g_wait(reinterpret_cast<CUstream>(stream),
             reinterpret_cast<CUdeviceptr>(counter), want,
             CU_STREAM_WAIT_VALUE_GEQ);
  if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  ++g_waits;
  return 0;
}

// `count` u64 words at `words` (this rank's own buffer), read on the side
// stream into `values`.
inline int read_words(const void* words, int count, uint64_t* values) {
  if (g_wait == nullptr) return kNoDriverEntryPoint;
  if (count < 0 || count > kHostWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t rc = cudaMemcpyAsync(g_host, words, count * sizeof(u64),
                                   cudaMemcpyDeviceToHost, g_side);
  if (rc == cudaSuccess) rc = cudaStreamSynchronize(g_side);
  if (rc == cudaSuccess) memcpy(values, g_host, count * sizeof(u64));
  return static_cast<int>(rc);
}

// Gives up the calls on a buffer so that a stream blocked in one of its
// waits drains: on the side stream, set the u64 at `abandoned` (the
// stretches still queued then read, store and signal nothing), then set
// the `count` waited-on counters at `counters` to `want`, which frees
// every wait on them. The buffer takes no call after it.
inline int abandon(void* abandoned, void* counters, int count, u64 want) {
  if (g_wait == nullptr) return kNoDriverEntryPoint;
  if (count < 0 || count > kHostWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) g_host[i] = want;
  cudaError_t rc = cudaMemsetAsync(abandoned, 0xff, sizeof(u64), g_side);
  if (rc == cudaSuccess) {
    rc = cudaMemcpyAsync(counters, g_host, count * sizeof(u64),
                         cudaMemcpyHostToDevice, g_side);
  }
  if (rc == cudaSuccess) rc = cudaStreamSynchronize(g_side);
  return static_cast<int>(rc);
}

inline const char* error_string(int code) {
  if (code == kNoDriverEntryPoint) {
    return "the CUDA driver's stream memory operations "
           "(cuStreamWaitValue64) could not be fetched";
  }
  if (code == kNoStreamMemOps) {
    return "the device does not take 64-bit stream memory operations "
           "(CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS is 0)";
  }
  if (code < 0) {
    const char* s = nullptr;
    if (g_error != nullptr &&
        g_error(static_cast<CUresult>(-code), &s) == CUDA_SUCCESS && s) {
      return s;
    }
    return "CUDA driver error";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace peer_mem
