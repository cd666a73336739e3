// Paged decode attention for Hopper (sm_90a), one query token per lane:
// a split-KV kernel whose blocks merge their partial softmaxes in a
// thread-block cluster.
//
// Replaces: akka_allreduce_tpu/ops/pallas_kernels/attention.py
//           _paged_fwd_kernel (called through paged_attention).
//
// What it computes: for every decode lane b and query head h,
//   out[b, 0, h] = softmax_j(q[b,0,h] . K[j] * D^-1/2) @ V
// over the lane's logical positions j <= pos[b], where logical position j
// lives at pool row (page_table[b, j / P], j % P) and query head h reads
// KV head h / g, g = H / h_kv (grouped-query attention). The pools keep
// the serving engine's layout (num_pages, P, h_kv, D), row-major.
//
// Bound: bytes. Each live K/V row is read once from device memory
// (2 * live_positions * h_kv * D * sizeof(T) per call) against ~4 * H * D
// flops per position: ~2 flops a byte in f32, ~4 in bf16, far below the
// card's ridge. The kernel stays on CUDA cores; what it has to do is keep
// enough bytes in flight across the whole card.
//
// Design:
//   * Split-KV grid (h_kv, B, S). Block s of lane b reads pos[b] itself
//     (no host read) and takes a contiguous share of ceil(n_live / S) of
//     the lane's n_live = ceil((pos+1)/P) live pages, so a short lane does
//     not leave most splits idle. It reads its share's page-table entries
//     once into shared memory, and never one at or past n_live. The
//     wrapper picks S (paged_splits: at most 8, a portable cluster, so
//     that h_kv * B * S fills the card's SMs about twice; 256 blocks at
//     B 8, h_kv 4).
//   * Several pages in flight per block: a ring of 2-8 stages (64 KB in
//     all), a stage holding whole pages' K and V rows, as many as the
//     wrapper says (paged_stage_pages: up to 64 keys and 32 KB, two f32
//     pages or four bf16 pages at D 128, P 16). Every
//     thread fills a stage with 16-byte cp.async that arrive on the
//     stage's mbarrier (cp.async.mbarrier.arrive.noinc); the stage is
//     refilled right after the block barrier that ends its last use.
//     One bulk copy a row (cp.async.bulk) from one warp was slower.
//   * Scores for many keys at once: 8 threads own one key (16 keys a
//     round), each holding D / 8 elements of K in registers and the
//     group's query heads four at a time (the q tile stays in registers
//     across steps when the group fits one tile and D <= 128); the four
//     dot products are reduced over the 8 threads with 4 shuffles (a
//     transposed butterfly), not a per-key chain.
//   * The block width is 4 warps for every group size g from 1 (MHA) to
//     32: heads are handled in tiles of 4, padded with zero queries.
//     __launch_bounds__(128, 3) up to D 128: three blocks an SM, so that
//     the 8-block clusters all find room at once (at 176 registers only
//     two fitted, and the long cache ran slower); two above D 128, where
//     168 registers spilled at D 224.
//   * Per step, JAX's _softmax_tile over the step's live keys: each
//     head's max and sum (32 lanes a head at g <= 4, fewer for larger
//     groups), corr = exp(min(m, m_new) - m_new), l from the unrounded p,
//     and p rounded to the pool dtype before the value product;
//     accumulators stay f32, split over key subsets where the (head tile,
//     4-column chunk) items leave threads free, and the division happens
//     once at the end.
//   * Merge in the cluster: the S blocks of one (kv head, lane) form one
//     cluster. Each leaves (m, l, acc[g][D]) in its shared memory; after
//     cluster.sync() block rank r merges a slice of the g x D outputs by
//     reading its peers' states through distributed shared memory:
//     M = max_s m_s, w_s = exp(min(m_s, M) - M), out = sum_s w_s acc_s /
//     sum_s w_s l_s. No workspace, no atomics, no second launch. A split
//     with no live key keeps m = -1e30 (JAX's finite NEG_INF), l = 0 and
//     acc = 0, so its weight is exactly 0; split 0 always holds position
//     0, so the sum is never 0 and a lane parked at pos 0 comes out
//     finite.
//   * Shared-memory banks: 8 threads read one K row's 128 contiguous
//     bytes in f32; in bf16 (8-byte reads, a half-warp reading two rows)
//     odd rows of a length that is a multiple of 128 bytes are stored
//     with the halves of each 128-byte segment swapped.
//
// What holds it back (PERF.md, row 13): a call costs ~10 us before any
// K/V byte moves (launch, then pos -> page ids -> first copy, three
// dependent reads from a cold cache, and the cluster merge), so at the
// serving shape the 2 us bound is out of reach; at a long cache the f32
// kernel reaches ~60% of its byte bound and bf16 ~40% (per-step compute
// with two blocks an SM, and the fixed cost, weigh twice as much there).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kKeyLanes = 8;                     // threads per key (scores)
constexpr int kKeySlots = kThreads / kKeyLanes;  // keys scored at a time
constexpr int kTile = 4;                         // query heads per tile
constexpr int kMaxTiles = 8;                     // g <= 32
constexpr int kStageBudget = 64 * 1024;   // bytes of all K/V stages
constexpr int kMaxStages = 8;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* page_table;
  const int32_t* pos;
  void* out;
  int n_heads, h_kv, group, page_size, n_pt;
  int splits, stages, stage_pages, tiles, key_sets, head_lanes;
  float scale;
  unsigned q_off, sp_off, state_off, ids_off, bar_off;  // smem bytes
};

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* o) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&a);
  v.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}
// p as the value product reads it: rounded to the pool's dtype (JAX's
// p.astype(v.dtype))
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Wait for the stage's copies; a copy that never lands traps after 10 s
// (the CUDA context is then lost and the next synchronise raises) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  uint64_t start = 0;
  while (true) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > 10000000000ull) {
      printf("paged_attention.cu: block (%d, %d, %d): a stage's copies "
             "did not land within 10 s\n",
             blockIdx.x, blockIdx.y, blockIdx.z);
      __trap();
    }
  }
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// the thread's earlier cp.asyncs arrive on `bar` when they land (one of
// its kThreads expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ float group_max(float x, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float group_sum(float x, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The four partial dot products s[0..3] of one key, each spread over the
// 8 threads kl = 0..7 of its key group, summed with 4 shuffles: every
// round halves the values a thread keeps. Thread kl ends with head
// kl / 2's total (both threads of a pair hold it).
__device__ __forceinline__ float reduce_tile(const float* s, int kl) {
  const bool hi4 = kl & 4;
  float keep0 = hi4 ? s[2] : s[0];
  float keep1 = hi4 ? s[3] : s[1];
  keep0 += __shfl_xor_sync(0xffffffffu, hi4 ? s[0] : s[2], 4);
  keep1 += __shfl_xor_sync(0xffffffffu, hi4 ? s[1] : s[3], 4);
  const bool hi2 = kl & 2;
  float keep = hi2 ? keep1 : keep0;
  keep += __shfl_xor_sync(0xffffffffu, hi2 ? keep0 : keep1, 2);
  return keep + __shfl_xor_sync(0xffffffffu, keep, 1);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, NC <= 4 ? 3 : 2)
    paged_attention_kernel(const Params p) {
  constexpr int D = NC * 32;
  constexpr int kChunks = D / 4;            // 4-element column chunks a row
  constexpr int kMaxItems = (NC + 1) / 2;   // value items a thread
  constexpr bool kHoldQ = NC <= 4;          // q tile in registers
  // bf16 rows whose length is a multiple of 128 bytes: a half-warp reads
  // two rows' first 64 bytes, so odd rows swap the halves of each
  // 128-byte segment (element index ^ 32) to keep them off one bank set
  constexpr int kSwz = (sizeof(T) == 2 && D % 64 == 0) ? 32 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int g = p.group;
  const int P = p.page_size;
  const int n_ht = p.tiles;
  const int n_stages = p.stages;
  const int pps = p.stage_pages;  // pages a stage
  const int stage_keys = pps * P;
  const int stage_elems = 2 * stage_keys * D;
  T* stages = reinterpret_cast<T*>(smem);
  float* q_sh = reinterpret_cast<float*>(smem + p.q_off);  // [4 n_ht][D]
  // [n_ht][stage_keys][4]: scores, then p
  float* sp_sh = reinterpret_cast<float*>(smem + p.sp_off);
  float* m_sh = reinterpret_cast<float*>(smem + p.state_off);
  float* l_sh = m_sh + kTile * n_ht;
  float* corr_sh = l_sh + kTile * n_ht;
  int32_t* ids_sh = reinterpret_cast<int32_t*>(smem + p.ids_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.bar_off);

  // this split's share of the lane's live pages
  const int lane_pos = p.pos[b];
  int n_live = lane_pos / P + 1;  // ceil((pos + 1) / P)
  if (n_live > p.n_pt) n_live = p.n_pt;
  const int share = (n_live + p.splits - 1) / p.splits;
  const int first = split * share;
  const int n_mine = max(0, min(share, n_live - first));

  const T* q_grp = static_cast<const T*>(p.q) +
                   (static_cast<size_t>(b) * p.n_heads +
                    static_cast<size_t>(hk) * g) * D;
  for (int i = tid; i < kTile * n_ht * kChunks; i += kThreads) {
    const int h = i / kChunks;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (h < g) load4(q_grp + static_cast<size_t>(i) * 4, v);
    store4(q_sh + i * 4, v);
  }
  for (int h = tid; h < kTile * n_ht; h += kThreads) {
    m_sh[h] = kNegInf;
    l_sh[h] = 0.f;
  }
  // the split's page ids, read once: entries at or past n_live never are
  const int32_t* table =
      p.page_table + static_cast<size_t>(b) * p.n_pt + first;
  for (int i = tid; i < n_mine; i += kThreads) ids_sh[i] = table[i];
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) mbar_init(&bars[s], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const T* k_pages = static_cast<const T*>(p.k_pages);
  const T* v_pages = static_cast<const T*>(p.v_pages);
  const size_t row_stride = static_cast<size_t>(p.h_kv) * D;
  const size_t page_stride = static_cast<size_t>(P) * row_stride;
  const int n_steps = (n_mine + pps - 1) / pps;
  // start step j's pages (the split's pages j * pps ...) into stage
  // j % n_stages, K rows then V rows, one page after another
  auto fill_stage = [&](int j) {
    const int page0 = j * pps;
    const int pages = min(pps, n_mine - page0);
    T* k_dst = stages + (j % n_stages) * stage_elems;
    T* v_dst = k_dst + stage_keys * D;
    uint64_t* bar = &bars[j % n_stages];
    constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte copy
    constexpr int kRowCopies = D / kPer;
    for (int u = 0; u < pages; ++u) {
      const size_t base =
          static_cast<size_t>(ids_sh[page0 + u]) * page_stride +
          static_cast<size_t>(hk) * D;
      for (int c = tid; c < P * kRowCopies; c += kThreads) {
        const int t = c / kRowCopies;
        const int e = (c - t * kRowCopies) * kPer;
        const int r = u * P + t;  // the stage's row
        const int dst = r * D + (e ^ ((r & 1) * kSwz));
        cp_async16(k_dst + dst, k_pages + base + t * row_stride + e);
        cp_async16(v_dst + dst, v_pages + base + t * row_stride + e);
      }
    }
    cp_async_arrive(bar);
  };
  for (int j = 0; j < min(n_stages, n_steps); ++j) fill_stage(j);

  // value product: items (head tile, column chunk), over key subsets
  const int items = n_ht * kChunks;
  const int ks = items <= kThreads ? tid / items : 0;
  const int item0 = items <= kThreads ? tid % items : tid;
  const bool v_active = ks < p.key_sets;
  float acc[kMaxItems][kTile][4];
#pragma unroll
  for (int i = 0; i < kMaxItems; ++i)
#pragma unroll
    for (int h = 0; h < kTile; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;

  const int slot = tid / kKeyLanes;
  const int kl = tid % kKeyLanes;
  float qr[kHoldQ ? kTile : 1][kHoldQ ? NC : 1][4];
  int held = -1;

  for (int j = 0; j < n_steps; ++j) {
    mbar_wait(&bars[j % n_stages], (j / n_stages) & 1);
    __syncthreads();  // step j landed; every thread is done with step j-1
    if (j >= 1 && j - 1 + n_stages < n_steps) fill_stage(j - 1 + n_stages);
    const T* k_tile = stages + (j % n_stages) * stage_elems;
    const T* v_tile = k_tile + stage_keys * D;
    // the step's live keys: its pages' positions up to pos
    const int valid = min(min(pps, n_mine - j * pps) * P,
                          lane_pos - (first + j * pps) * P + 1);

    // 1. scores (q . k) * scale into sp_sh[tile][key][head of tile]
    for (int ht = 0; ht < n_ht; ++ht) {
      const float* q_tile = q_sh + ht * kTile * D;
      if constexpr (kHoldQ) {
        if (ht != held) {
#pragma unroll
          for (int h = 0; h < kTile; ++h)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              load4(q_tile + h * D + 4 * (kl + kKeyLanes * c), qr[h][c]);
          held = ht;
        }
      }
      for (int t0 = 0; t0 < valid; t0 += kKeySlots) {
        const int t = t0 + slot;
        float kr[NC][4];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (t < valid) {
            load4(k_tile + t * D +
                      ((4 * (kl + kKeyLanes * c)) ^ ((t & 1) * kSwz)),
                  kr[c]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) kr[c][e] = 0.f;
          }
        }
        float s[kTile];
#pragma unroll
        for (int h = 0; h < kTile; ++h) {
          s[h] = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            float qv[4];
            if constexpr (kHoldQ) {
#pragma unroll
              for (int e = 0; e < 4; ++e) qv[e] = qr[h][c][e];
            } else {
              load4(q_tile + h * D + 4 * (kl + kKeyLanes * c), qv);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) s[h] += qv[e] * kr[c][e];
          }
        }
        const float total = reduce_tile(s, kl);
        if (t < valid && (kl & 1) == 0) {
          sp_sh[(ht * stage_keys + t) * kTile + (kl >> 1)] =
              total * p.scale;
        }
      }
    }
    __syncthreads();

    // 2. per head (hl lanes each, every head in one round): the step's
    // max, the rescale, p (rounded) and its sum; every lane of the block
    // takes part in the shuffles
    {
      const int hl = p.head_lanes;
      const int h = tid / hl;
      const int sub = tid % hl;
      const bool live_h = h < kTile * n_ht;
      float* row = sp_sh + (h / kTile) * stage_keys * kTile + h % kTile;
      float m_step = kNegInf;
      if (live_h) {
        for (int t = sub; t < valid; t += hl) {
          m_step = fmaxf(m_step, row[t * kTile]);
        }
      }
      const float m_old = live_h ? m_sh[h] : kNegInf;
      const float m_new = fmaxf(m_old, group_max(m_step, hl));
      const float corr = expf(fminf(m_old, m_new) - m_new);
      float sum = 0.f;
      if (live_h) {
        for (int t = sub; t < valid; t += hl) {
          const float e = expf(row[t * kTile] - m_new);
          sum += e;
          row[t * kTile] = round_to(e, T());
        }
      }
      sum = group_sum(sum, hl);
      if (live_h && sub == 0) {
        m_sh[h] = m_new;
        l_sh[h] = l_sh[h] * corr + sum;
        corr_sh[h] = corr;
      }
    }
    __syncthreads();

    // 3. rescale the accumulators, then the value product
    if (v_active) {
#pragma unroll
      for (int i = 0; i < kMaxItems; ++i) {
        const int it = item0 + i * kThreads;
        if (it < items) {
          const int ht = it / kChunks;
          const int c = it - ht * kChunks;
          float corr[4];
          load4(corr_sh + ht * kTile, corr);
#pragma unroll
          for (int h = 0; h < kTile; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][h][e] *= corr[h];
          for (int t = ks; t < valid; t += p.key_sets) {
            float v[4], pr[4];
            load4(v_tile + t * D + ((4 * c) ^ ((t & 1) * kSwz)), v);
            load4(sp_sh + (ht * stage_keys + t) * kTile, pr);
#pragma unroll
            for (int h = 0; h < kTile; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][h][e] += pr[h] * v[e];
          }
        }
      }
    }
  }
  __syncthreads();  // the stages are free: they hold the partial sums now

  // the key subsets' accumulators, summed into acc_sh[head][D]
  float* acc_sh = reinterpret_cast<float*>(smem);  // [key_sets][4 n_ht][D]
  const int tile_elems = kTile * n_ht * D;
  if (v_active) {
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int it = item0 + i * kThreads;
      if (it < items) {
        const int ht = it / kChunks;
        const int c = it - ht * kChunks;
#pragma unroll
        for (int h = 0; h < kTile; ++h) {
          store4(acc_sh + ks * tile_elems + (ht * kTile + h) * D + 4 * c,
                 acc[i][h]);
        }
      }
    }
  }
  if (p.key_sets > 1) {
    __syncthreads();
    for (int i = tid; i < tile_elems / 4; i += kThreads) {
      float sum[4], part[4];
      load4(acc_sh + 4 * i, sum);
      for (int s = 1; s < p.key_sets; ++s) {
        load4(acc_sh + s * tile_elems + 4 * i, part);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[e] += part[e];
      }
      store4(acc_sh + 4 * i, sum);
    }
  }

  // merge the S splits' states through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_splits = p.splits;
  const unsigned rank = cluster.block_rank();
  T* out = static_cast<T*>(p.out) +
           (static_cast<size_t>(b) * p.n_heads +
            static_cast<size_t>(hk) * g) * D;
  for (int i = rank * kThreads + tid; i < g * kChunks;
       i += n_splits * kThreads) {
    const int h = i / kChunks;
    float m_max = kNegInf;
    for (int s = 0; s < n_splits; ++s) {
      m_max = fmaxf(m_max, cluster.map_shared_rank(m_sh, s)[h]);
    }
    float l_tot = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < n_splits; ++s) {
      const float m_s = cluster.map_shared_rank(m_sh, s)[h];
      const float w = expf(fminf(m_s, m_max) - m_max);
      l_tot += w * cluster.map_shared_rank(l_sh, s)[h];
      float a[4];
      load4(cluster.map_shared_rank(acc_sh, s) + 4 * i, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] += w * a[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] /= l_tot;
    store4(out + 4 * i, o);
  }
  cluster.sync();  // no block leaves while a peer still reads its state
}

// Shared-memory layout and launch geometry of one call; 0 on success.
template <typename T>
int plan(Params& p, int head_dim, size_t* smem) {
  const int n_chunks = head_dim / 4;
  p.tiles = (p.group + kTile - 1) / kTile;
  if (p.tiles > kMaxTiles || p.splits < 1 || p.stage_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t page = 2 * static_cast<size_t>(p.page_size) * head_dim *
                      sizeof(T);
  const size_t stage = p.stage_pages * page;
  p.stages = static_cast<int>(kStageBudget / stage);
  p.stages = p.stages < 2 ? 2 : (p.stages > kMaxStages ? kMaxStages : p.stages);
  // softmax: a power of two of lanes a head, all heads in one round
  p.head_lanes = 32;
  while (p.head_lanes * kTile * p.tiles > kThreads) p.head_lanes /= 2;
  const int items = p.tiles * n_chunks;
  p.key_sets = items <= kThreads ? kThreads / items : 1;
  const size_t acc = static_cast<size_t>(p.key_sets) * kTile * p.tiles *
                     head_dim * sizeof(float);
  size_t off = p.stages * stage > acc ? p.stages * stage : acc;
  off = (off + 15) / 16 * 16;
  p.q_off = static_cast<unsigned>(off);
  off += static_cast<size_t>(kTile) * p.tiles * head_dim * sizeof(float);
  p.sp_off = static_cast<unsigned>(off);
  off += static_cast<size_t>(p.tiles) * p.stage_pages * p.page_size *
         kTile * sizeof(float);
  p.state_off = static_cast<unsigned>(off);
  off += (3 * kTile * p.tiles * sizeof(float) + 15) / 16 * 16;
  p.ids_off = static_cast<unsigned>(off);  // a split's page ids
  off += ((p.n_pt + p.splits - 1) / p.splits * sizeof(int32_t) + 15) / 16 * 16;
  p.bar_off = static_cast<unsigned>(off);
  *smem = off + p.stages * sizeof(uint64_t);
  return 0;
}

template <typename T, int NC>
int launch_d(const Params& p, int batch, size_t smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, NC>;
  if (smem > 48 * 1024) {  // past the default limit: raise it (per device)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.h_kv, batch, p.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Params& p, int batch, int head_dim, cudaStream_t stream) {
  size_t smem = 0;
  const int rc = plan<T>(p, head_dim, &smem);
  if (rc != 0) return rc;
  switch (head_dim) {
    case 32: return launch_d<T, 1>(p, batch, smem, stream);
    case 64: return launch_d<T, 2>(p, batch, smem, stream);
    case 96: return launch_d<T, 3>(p, batch, smem, stream);
    case 128: return launch_d<T, 4>(p, batch, smem, stream);
    case 160: return launch_d<T, 5>(p, batch, smem, stream);
    case 192: return launch_d<T, 6>(p, batch, smem, stream);
    case 224: return launch_d<T, 7>(p, batch, smem, stream);
    case 256: return launch_d<T, 8>(p, batch, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; splits: blocks per (kv head, lane),
// launched as one cluster (at most 8, a portable cluster: more fails the
// launch); stage_pages: whole pages a shared-memory stage holds, the
// online softmax's step. The Python wrapper
// (akka_allreduce_tpu_torch/ops/kernels/attention.py paged_attention)
// picks both (paged_splits, paged_stage_pages) and checks shapes and
// types. Returns the launch status (cudaSuccess == 0).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table, const void* pos,
                                      void* out, int batch, int n_heads,
                                      int h_kv, int head_dim, int page_size,
                                      int n_pt, int splits,
                                      int stage_pages, float scale,
                                      void* stream) {
  Params p = {};
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.page_table = static_cast<const int32_t*>(page_table);
  p.pos = static_cast<const int32_t*>(pos);
  p.out = out;
  p.n_heads = n_heads;
  p.h_kv = h_kv;
  p.group = n_heads / h_kv;
  p.page_size = page_size;
  p.n_pt = n_pt;
  p.splits = splits;
  p.stage_pages = stage_pages;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, batch, head_dim, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, batch, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
