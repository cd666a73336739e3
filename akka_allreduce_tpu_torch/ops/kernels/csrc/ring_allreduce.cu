// Peer-memory ring and swing allreduce for Hopper (sm_90a), between the
// processes of a rank group.
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/ring.py
//           _ring_kernel  (called through pallas_ring_allreduce) and
//           _swing_kernel (called through pallas_swing_allreduce).
//
// What it computes: the sum over the n ranks of a flat f32 vector, every
// rank ending with the whole sum, each element in the TPU kernels' add
// order, as lone f32 adds (__fadd_rn, no fast math), so the result is
// bitwise the plain version's (akka_allreduce_tpu_torch/ops/kernels/ring.py):
//   ring  — block b of the n ring blocks sums to
//           ((x_b[b] + x_{b+1}[b]) + x_{b+2}[b]) + ... + x_{b-1}[b]
//           (rank indices mod n): the reduce-scatter's carry chain;
//   swing — every element is the balanced tree
//           ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)), which every
//           rank of the XOR exchanges ends with.
// f32 addition commutes bitwise, so whichever rank owns a block can compute
// either order from all the ranks' contributions. The TPU schedules fix the
// add order, not how the bytes travel; on this card one data movement
// serves both.
//
// Schedule. The vector is cut into n blocks of whole 128-lanes (the last
// may be ragged or empty; ring.py's block_range). Rank r owns block
// (r + 1) mod n, as the TPU ring's reduce-scatter leaves it. Every rank
// owns one symmetric buffer (cudaMalloc, shared through CUDA IPC by
// parallel/group.py) holding n - 1 inbound slots, n - 1 gather slots and
// the counters; ring.py's layout functions place them, and the wrapper
// passes this file resolved addresses only. A call is three kernels on the
// caller's stream:
//   push   — for each peer p, store the block p owns from x into slot
//            `inbound[my]` of p's buffer; then add 1 to each peer's `push`;
//   (the stream waits until this rank's `push` >= (n - 1) * call)
//   reduce — sum the n contributions of the owned block (x's own block and
//            the n - 1 inbound slots) in the schedule's order; store the sum
//            into out and into slot `gather[my]` of every peer's buffer;
//            then add 1 to each peer's `reduce`;
//   (the stream waits until this rank's `reduce` >= (n - 1) * call)
//   gather — copy each gather slot into out at the sending owner's block.
// Two cross-rank waits a call at every n; x is read once and out written
// once.
//
// Flow control comes from stream order: no slot parity, no `consumed`
// flags. Counters only grow: the wrapper numbers the calls on a buffer
// (1, 2, ...), every rank makes the same calls, so after call k each
// counter holds (n - 1) * k and nothing is ever reset.
//   - Rank r's push of call k + 1 writes p's inbound slot. It follows r's
//     gather wait of call k, which saw p's reduce signal of call k, which p
//     sends after its reduce has read every inbound slot.
//   - Rank r's reduce of call k + 1 writes p's gather slot. It follows r's
//     push wait of call k + 1, which saw p's push signal of call k + 1; p
//     pushes only after its own gather of call k, the last read of that
//     slot.
// The wrapper also makes each call's stream wait on the previous call's
// end event, so a caller who changes streams between calls keeps the order.
//
// Waits off the SMs. Each wait is a stream memory operation
// (cuStreamWaitValue64, CU_STREAM_WAIT_VALUE_GEQ) on a counter in the
// rank's own buffer, fetched through cudaGetDriverEntryPoint (no -lcuda),
// after checking CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS once.
// No kernel waits, so a rank whose peers have not signalled holds no SM,
// and the kernels need not be persistent: each is a streaming grid sized
// for bandwidth. A stream wait cannot time out: ring.py's `wait` polls the
// last call's end event on the host and, past its deadline, abandons the
// buffer's calls (peer_allreduce_abandon: a flag that turns the queued
// stretches into no-ops, then counters raised to free the waits), so the
// stream drains whether or not the peer ever makes the call, and raises,
// naming the counters. The buffers, the wait, the abandon path and the
// signal's ticket are peer_mem.cuh's, shared with the rank transport
// (transport.cu).
//
// Signals. A stretch signals its peers after all of its stores: each block
// fences (__threadfence_system) and takes a ticket; the last block resets
// the ticket and does one system-scope release add on each peer's counter.
// That costs one add per peer a stretch, from the card, where a stream
// write of the value (cuStreamWriteValue64) would be n - 1 more host calls
// a stretch and a counter per sender, so n - 1 waits in place of one.
// Slots written by peers are read with L2-only loads (__ldcg).
//
// Bound: bytes. Per rank of N bytes: push reads and stores (n - 1) / n N,
// reduce reads N and stores N, gather reads and stores (n - 1) / n N:
// 2N + 4 (n - 1) / n N (4N at two ranks, 5N at four). Each element costs
// n - 1 adds, far below the card's f32 ridge. On one card the ranks share
// its memory rate. The function itself needs only 2N (read x, write out):
// a design that routes through peer slots cannot reach that bound.

#include "peer_mem.cuh"

namespace {

using peer_mem::kMaxRanks;
using peer_mem::kThreads;
using peer_mem::u64;

constexpr int kUnroll = 4;       // float4s in flight a thread
constexpr int kCounterBytes = 128;

struct Counters {  // at the end of every rank's buffer
  u64 push;        // + 1 from each peer after its push
  u64 reduce;      // + 1 from each peer after its reduce
  u64 abandoned;   // this rank's own: non-zero once wait() gave up
  u64 ran;         // this rank's own: its stretches that ran, one each
  u64 pad[4];
  unsigned ticket;  // this rank's own: blocks of the running stretch done
};
static_assert(sizeof(Counters) <= kCounterBytes, "counters overflow");

struct Copy {  // one stretch's copy for one peer
  const float4* src;
  float4* dst;
  long long n4;  // float4s
};

struct CopyTable {
  Copy c[kMaxRanks - 1];
};

struct Peers {  // the peers' counters, mapped into this process
  Counters* p[kMaxRanks - 1];
};

struct Sources {  // the reduce's inputs, in the schedule's add order
  const float4* p[kMaxRanks];
};

struct Dests {  // out's owned block, then every peer's gather slot
  float4* p[kMaxRanks];
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// After the block's stores: the last block of the grid adds 1 to `which`
// (0 push, 1 reduce) of every peer's counters.
__device__ void stretch_done(Counters* mine, const Peers& peers, int npeers,
                             int which) {
  __syncthreads();
  if (threadIdx.x == 0 && peer_mem::last_block(&mine->ticket)) {
    for (int p = 0; p < npeers; ++p) {
      peer_mem::release_add(
          which ? &peers.p[p]->reduce : &peers.p[p]->push, 1);
    }
  }
}

// False once the buffer's calls were abandoned (peer_allreduce_abandon);
// else the stretch is counted in `ran` (phase 14 of chip_smoke.py reads
// the kernels a call from it) and runs.
__device__ __forceinline__ bool begin_stretch(Counters* mine) {
  return peer_mem::begin_stretch(&mine->abandoned, &mine->ran);
}

// push (signal 0) and gather (signal -1): row blockIdx.y of the table.
__global__ void __launch_bounds__(kThreads)
    peer_copy_kernel(const __grid_constant__ CopyTable table, Counters* mine,
                     const __grid_constant__ Peers peers, int npeers,
                     int signal) {
  if (!begin_stretch(mine)) return;
  const Copy c = table.c[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < c.n4; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(c.src + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c.dst[i + u * stride] = v[u];
  }
  for (; i < c.n4; i += stride) c.dst[i] = __ldcg(c.src + i);
  if (signal >= 0) stretch_done(mine, peers, npeers, signal);
}

// The swing's balanced tree over sources [kLo, kLo + kCount).
template <int kLo, int kCount>
struct Tree {
  static __device__ __forceinline__ float4 sum(const Sources& s,
                                               long long i) {
    return add4(Tree<kLo, kCount / 2>::sum(s, i),
                Tree<kLo + kCount / 2, kCount / 2>::sum(s, i));
  }
};

template <int kLo>
struct Tree<kLo, 1> {
  static __device__ __forceinline__ float4 sum(const Sources& s,
                                               long long i) {
    return __ldcg(s.p[kLo] + i);
  }
};

// The owner's sums of kU elements (i, i + stride, ...): kLog 0 the ring's
// chain over the n sources in order, every element's loads issued before
// its add; kLog > 0 the swing's tree over n = 2^kLog sources in rank order.
template <int kLog, int kU>
__device__ __forceinline__ void owner_sums(const Sources& s, int n,
                                           long long i, long long stride,
                                           float4 (&acc)[kU]) {
  if constexpr (kLog > 0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      acc[u] = Tree<0, (1 << kLog)>::sum(s, i + u * stride);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u] = __ldcg(s.p[0] + i + u * stride);
    for (int q = 1; q < n; ++q) {
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = __ldcg(s.p[q] + i + u * stride);
#pragma unroll
      for (int u = 0; u < kU; ++u) acc[u] = add4(acc[u], v[u]);
    }
  }
}

template <int kLog, int kU>
__device__ __forceinline__ void reduce_store(const Sources& s,
                                             const Dests& d, int n,
                                             long long i, long long stride) {
  float4 acc[kU];
  owner_sums<kLog, kU>(s, n, i, stride, acc);
  for (int q = 0; q < n; ++q) {
#pragma unroll
    for (int u = 0; u < kU; ++u) d.p[q][i + u * stride] = acc[u];
  }
}

template <int kLog>
__global__ void __launch_bounds__(kThreads)
    peer_reduce_kernel(const __grid_constant__ Sources s,
                       const __grid_constant__ Dests d, int n, long long n4,
                       Counters* mine, const __grid_constant__ Peers peers) {
  if (!begin_stretch(mine)) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    reduce_store<kLog, kUnroll>(s, d, n, i, stride);
  }
  for (; i < n4; i += stride) reduce_store<kLog, 1>(s, d, n, i, stride);
  stretch_done(mine, peers, n - 1, 1);
}

int grid_x(long long n4, int rows) {
  return peer_mem::grid_x(n4, kThreads * kUnroll, rows);
}

}  // namespace

// ---- the kernels (ops/kernels/ring.py) ----------------------------------

// The counters' bytes at the end of a buffer.
extern "C" int64_t peer_allreduce_counter_bytes() { return kCounterBytes; }

extern "C" int peer_allreduce_max_ranks() { return kMaxRanks; }

// Fetches the driver's stream-wait entry point and checks that the current
// device takes 64-bit stream memory operations. 0, or a negative code.
extern "C" int peer_allreduce_init() { return peer_mem::init(); }

// `push`, `reduce`, `abandoned` and `ran` of the counters at `counters`
// (this rank's), read on the side stream: the host's view of a stalled
// call (ring.py wait) and of the stretches that ran.
extern "C" int peer_allreduce_read_counters(const void* counters,
                                            uint64_t* values) {
  return peer_mem::read_words(counters, 4, values);
}

// Gives up the calls on the buffer whose counters are at `counters`
// (this rank's), so that a stream blocked in one of its waits drains: on
// the side stream, set `abandoned` (the stretches still queued then read,
// store and signal nothing), then raise `push` and `reduce` to `want`,
// which frees both waits. Called by ring.py's wait past its deadline; the
// buffer takes no call after it.
extern "C" int peer_allreduce_abandon(void* counters, uint64_t want) {
  Counters* c = static_cast<Counters*>(counters);
  return peer_mem::abandon(&c->abandoned, &c->push, 2, want);
}

// Stream waits enqueued since load: phase 14 of chip_smoke.py reads the
// waits a call from it.
extern "C" uint64_t peer_allreduce_stream_waits() { return peer_mem::g_waits; }

// One call: push, wait, reduce, wait, gather on `stream`. Tables hold
// device addresses that ring.py resolved from the layout:
//   push, gather — npeers rows of (src, dst, float4s);
//   sources      — the n reduce inputs in the schedule's add order;
//   dests        — out's owned block, then the npeers peers' gather slots;
//   counters     — this rank's, then the npeers peers' (the same offset);
// n4 is the owned block's float4s; swing_log 0 selects the ring's chain,
// k > 0 the swing's tree over 2^k = n sources. Returns 0 or an error code
// (peer_allreduce_error_string). peer_allreduce_init must have returned 0.
extern "C" int peer_allreduce_launch(const uint64_t* push,
                                     const uint64_t* gather,
                                     const uint64_t* sources,
                                     const uint64_t* dests, int n,
                                     int64_t n4, int swing_log,
                                     const uint64_t* counters, uint64_t call,
                                     void* stream) {
  if (peer_mem::g_wait == nullptr) return peer_mem::kNoDriverEntryPoint;
  if (n < 2 || n > kMaxRanks || (swing_log > 0 && n != (1 << swing_log))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int npeers = n - 1;
  CopyTable pt{}, gt{};
  Peers peers{};
  Sources src{};
  Dests dst{};
  long long push_max = 0, gather_max = 0;
  for (int p = 0; p < npeers; ++p) {
    pt.c[p] = {reinterpret_cast<const float4*>(push[3 * p]),
               reinterpret_cast<float4*>(push[3 * p + 1]),
               static_cast<long long>(push[3 * p + 2])};
    gt.c[p] = {reinterpret_cast<const float4*>(gather[3 * p]),
               reinterpret_cast<float4*>(gather[3 * p + 1]),
               static_cast<long long>(gather[3 * p + 2])};
    if (pt.c[p].n4 > push_max) push_max = pt.c[p].n4;
    if (gt.c[p].n4 > gather_max) gather_max = gt.c[p].n4;
    peers.p[p] = reinterpret_cast<Counters*>(counters[1 + p]);
  }
  for (int q = 0; q < n; ++q) {
    src.p[q] = reinterpret_cast<const float4*>(sources[q]);
    dst.p[q] = reinterpret_cast<float4*>(dests[q]);
  }
  Counters* mine = reinterpret_cast<Counters*>(counters[0]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const u64 want = static_cast<u64>(npeers) * call;

  peer_copy_kernel<<<dim3(grid_x(push_max, npeers), npeers), kThreads, 0,
                     st>>>(pt, mine, peers, npeers, 0);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) rc = peer_mem::wait_counter(st, &mine->push, want);
  if (rc != 0) return rc;

  const int gx = grid_x(n4, 1);
  switch (swing_log) {
#define RING_REDUCE_CASE(k)                                                 \
  case k:                                                                  \
    peer_reduce_kernel<k><<<gx, kThreads, 0, st>>>(src, dst, n, n4, mine,  \
                                                   peers);                 \
    break;
    RING_REDUCE_CASE(0)
    RING_REDUCE_CASE(1)
    RING_REDUCE_CASE(2)
    RING_REDUCE_CASE(3)
    RING_REDUCE_CASE(4)
    RING_REDUCE_CASE(5)
#undef RING_REDUCE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) rc = peer_mem::wait_counter(st, &mine->reduce, want);
  if (rc != 0) return rc;

  peer_copy_kernel<<<dim3(grid_x(gather_max, npeers), npeers), kThreads, 0,
                     st>>>(gt, mine, peers, npeers, -1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* peer_allreduce_error_string(int code) {
  return peer_mem::error_string(code);
}
