// The rank transport's device side (Hopper, sm_90a): moves the payloads
// of RankGroup's all_to_all, all_gather, exchange and ppermute between the
// processes of a rank group through CUDA IPC peer memory, device memory
// to device memory, on the caller's stream. It ports no Pallas kernel: it
// is the wire under the JAX package's lax.all_to_all / all_gather /
// ppermute, which on the TPU ride ICI. It moves bytes and never adds them.
//
// Layout (ops/kernels/transport.py holds it as pure functions; this file
// gets resolved addresses only). Every rank of a group (the world, or one
// axis line of the mesh) owns one symmetric buffer (cudaMalloc, shared
// through CUDA IPC by parallel/group.py): for each of its n - 1 senders a
// slot of two halves of one chunk each, then the counters:
//   ready[slot(s)]    — chunks sender s has pushed into this rank's slots
//                       (written by s only);
//   consumed[slot(d)] — chunks of this rank's that receiver d has copied
//                       out of its slots (written by d only);
//   abandoned, ran, ticket — this rank's own.
// A payload streams through its pair's slot chunk by chunk; chunk g of a
// pair (counted over every call on the buffer) lands in half g mod 2.
//
// A call is, per chunk, one push stretch (copy the chunk into each
// receiver's slot, then raise that receiver's ready to g + 1) and one pull
// stretch (copy each sender's chunk out of this rank's slot, then raise
// that sender's consumed to g + 1), each a launch of transport_copy_kernel
// with one row per peer. Before a push of chunk g >= 2 the stream waits
// for consumed >= g - 1 (the chunk that used the half last is out); before
// a pull of chunk g it waits for ready >= g + 1. Both waits are stream
// memory operations (cuStreamWaitValue64, peer_mem.cuh), off the SMs: a
// rank whose peers have not signalled holds no SM, which matters where
// the ranks' contexts time-slice one card. The push of chunk c + 1 is
// enqueued before the pull of chunk c, so a peer's push can overlap this
// rank's copy-out; every wait points at an earlier stretch of another
// rank, so the order cannot deadlock (transport.py's emulation runs it).
//
// Counters only grow and each has one writer, so a signal is a
// system-scope release max of the absolute target: never lowered, not even
// by a late signal after an abandon raised the counters (transport.py's
// wait / watchdog, transport_abandon: queued stretches become no-ops and
// every wait is freed, so the stream drains and the host can raise).
//
// A CUDA graph may capture calls (ops/kernels/transport.py `capture`):
// the waits become the graph's memory-operation nodes and the stretches
// its kernel nodes, each with the targets the host gave it at capture.
// Before each replay every rank has drained the previous one and met the
// others (a gloo barrier), and transport_rewind writes its own buffer's
// ready / consumed words back to the values the chunk was captured at;
// after a second barrier the replay's targets hold again. The only time a
// counter is lowered: no signal is in flight then.
//
// Bound: bytes. Each payload byte is read and written twice (push, pull),
// 4 N of HBM traffic for N bytes received; ranks sharing the card share
// its memory rate.

#include "peer_mem.cuh"

namespace {

using peer_mem::kMaxRanks;
using peer_mem::kThreads;
using peer_mem::u64;

constexpr int kUnroll = 4;  // uint4s in flight a thread
constexpr int kCounterBytes = 1024;

struct Counters {  // after the slots of every rank's buffer
  u64 ready[kMaxRanks - 1];     // [slot of the sender]
  u64 consumed[kMaxRanks - 1];  // [slot of the receiver]
  u64 abandoned;                // this rank's own: non-zero once given up
  u64 ran;                      // this rank's own: stretches that ran
  unsigned ticket;              // this rank's own: blocks of a stretch done
};
static_assert(sizeof(Counters) <= kCounterBytes, "counters overflow");

struct Row {  // one peer's copy in a stretch
  const unsigned char* src;
  unsigned char* dst;
  long long bytes;
};

struct RowTable {
  Row r[kMaxRanks];
};

struct Signal {  // a peer's counter and the value it is raised to
  u64* counter;
  u64 value;
};

struct SignalTable {
  Signal s[kMaxRanks];
};

__device__ __forceinline__ void copy_row(const Row& r) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(r.src) |
      reinterpret_cast<unsigned long long>(r.dst);
  long long done = 0;
  if ((align & 15) == 0) {
    const long long n16 = r.bytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(r.src);
    uint4* d = reinterpret_cast<uint4*>(r.dst);
    long long i = t;
    for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(s + i + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d[i + u * stride] = v[u];
    }
    for (; i < n16; i += stride) d[i] = __ldcg(s + i);
    done = n16 << 4;
  }
  // the tail, or a row whose ends are not 16-byte aligned, byte by byte
  for (long long b = done + t; b < r.bytes; b += stride) {
    r.dst[b] = __ldcg(r.src + b);
  }
}

// Row blockIdx.y of the table, then (the grid's last block) every signal.
__global__ void __launch_bounds__(kThreads)
    transport_copy_kernel(const __grid_constant__ RowTable rows,
                          const __grid_constant__ SignalTable signals,
                          int nsignals, Counters* mine) {
  if (!peer_mem::begin_stretch(&mine->abandoned, &mine->ran)) return;
  copy_row(rows.r[blockIdx.y]);
  __syncthreads();
  if (threadIdx.x == 0 && peer_mem::last_block(&mine->ticket)) {
    for (int i = 0; i < nsignals; ++i) {
      peer_mem::release_max(signals.s[i].counter, signals.s[i].value);
    }
  }
}

}  // namespace

// ---- peer buffers (parallel/group.py) -----------------------------------

// cudaMalloc, never PyTorch's caching allocator: an IPC handle names the
// base of an allocation. Zeroed (the counters start at 0) and synchronised
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

// ---- the transport (ops/kernels/transport.py) ----------------------------

extern "C" int64_t transport_counter_bytes() { return kCounterBytes; }

extern "C" int transport_max_ranks() { return kMaxRanks; }

extern "C" int transport_init() { return peer_mem::init(); }

// One stretch on `stream`: `rows` holds nrows x (src, dst, bytes), row i
// copied by blockIdx.y == i; then `signals` (nsignals x (counter, value))
// are raised. `counters` is this rank's. 0 or an error code.
extern "C" int transport_copy(const uint64_t* rows, int nrows,
                              const uint64_t* signals, int nsignals,
                              void* counters, void* stream) {
  if (peer_mem::g_wait == nullptr) return peer_mem::kNoDriverEntryPoint;
  if (nrows < 1 || nrows > kMaxRanks || nsignals < 0 ||
      nsignals > kMaxRanks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowTable rt{};
  SignalTable st{};
  long long most = 0;
  for (int i = 0; i < nrows; ++i) {
    rt.r[i] = {reinterpret_cast<const unsigned char*>(rows[3 * i]),
               reinterpret_cast<unsigned char*>(rows[3 * i + 1]),
               static_cast<long long>(rows[3 * i + 2])};
    if (rt.r[i].bytes > most) most = rt.r[i].bytes;
  }
  for (int i = 0; i < nsignals; ++i) {
    st.s[i] = {reinterpret_cast<u64*>(signals[2 * i]),
               static_cast<u64>(signals[2 * i + 1])};
  }
  const int gx = peer_mem::grid_x(most, kThreads * 16 * kUnroll, nrows);
  transport_copy_kernel<<<dim3(gx, nrows), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rt, st, nsignals, static_cast<Counters*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// The stream waits until the u64 at `counter` (this rank's) is >= want.
extern "C" int transport_wait(void* stream, const void* counter,
                              uint64_t want) {
  return peer_mem::wait_counter(static_cast<cudaStream_t>(stream),
                                static_cast<const u64*>(counter), want);
}

// ready[0..31), consumed[0..31), abandoned and ran of this rank's
// counters, read on the side stream (the call's stream may be blocked).
extern "C" int transport_read(const void* counters, uint64_t* values) {
  return peer_mem::read_words(counters, 2 * (kMaxRanks - 1) + 2, values);
}

// Gives up every call on the buffer whose counters are at `counters`:
// queued stretches become no-ops and every ready / consumed wait is freed
// (both raised to `want`).
extern "C" int transport_abandon(void* counters, uint64_t want) {
  Counters* c = static_cast<Counters*>(counters);
  return peer_mem::abandon(&c->abandoned, c->ready, 2 * (kMaxRanks - 1),
                           want);
}

// Writes this rank's ready[0..count) and consumed[0..count) words to
// `ready` and `consumed` (count values each), on the side stream, and
// waits for the write. Only between replays of a captured chunk, with no
// call of any rank in flight on the buffer.
extern "C" int transport_rewind(void* counters, const uint64_t* ready,
                                const uint64_t* consumed, int count) {
  if (peer_mem::g_wait == nullptr) return peer_mem::kNoDriverEntryPoint;
  if (count < 0 || count > kMaxRanks - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Counters* c = static_cast<Counters*>(counters);
  for (int i = 0; i < count; ++i) {
    peer_mem::g_host[i] = ready[i];
    peer_mem::g_host[kMaxRanks + i] = consumed[i];
  }
  cudaError_t rc = cudaMemcpyAsync(c->ready, peer_mem::g_host,
                                   count * sizeof(u64),
                                   cudaMemcpyHostToDevice, peer_mem::g_side);
  if (rc == cudaSuccess) {
    rc = cudaMemcpyAsync(c->consumed, peer_mem::g_host + kMaxRanks,
                         count * sizeof(u64), cudaMemcpyHostToDevice,
                         peer_mem::g_side);
  }
  if (rc == cudaSuccess) rc = cudaStreamSynchronize(peer_mem::g_side);
  return static_cast<int>(rc);
}

extern "C" uint64_t transport_stream_waits() { return peer_mem::g_waits; }

// Adds `delta` to the stream-wait count: a capture enqueues no wait, a
// replay enqueues those it captured.
extern "C" void transport_add_waits(int64_t delta) {
  peer_mem::g_waits += static_cast<unsigned long long>(delta);
}

extern "C" const char* transport_error_string(int code) {
  return peer_mem::error_string(code);
}
