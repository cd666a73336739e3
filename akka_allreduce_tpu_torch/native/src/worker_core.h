// The ONE native worker state machine, shared by both deployments:
// the in-process cluster engine (cluster.cpp, FIFO message queue) and
// the cross-process remote engine (remote_worker.cpp, framed TCP).
// Both are C++ renderings of the Python spec protocol/worker.py
// (itself the behavioral port of the reference's worker actor,
// AllreduceWorker.scala:7-301); extracting the rules here closes the
// maintenance hazard of the same protocol living in two C++ copies.
//
// Semantics carried (SURVEY.md §3a):
//  * block ownership: step = ceil(dataSize/N), last block short/empty
//  * chunking: ceil(block/maxChunk) wire chunks
//  * thresholds: scatter gate max(1, int(thReduce*peers)), fired on ==
//    (exactly once); completion gate clamp(int(thComplete*total)),
//    fired on ==
//  * maxLag ring of maxLag+1 rows; catch-up force-completes stale
//    rounds; stale drops; future rounds defer behind a self Start
//  * rank-staggered fan-out (i+id)%N with self-delivery bypass
//  * count piggyback on ReduceBlock; flush zero-fills missing chunks
//    and expands chunk counts to elements
//
// Env policy interface (duck-typed; both deployments implement):
//   bool rank_alive(int rank);                       // peer map/alive
//   const float* source();                           // round input
//   void send_scatter(int dest, int chunk, int64_t round,
//                     const float* d, size_t n);
//   void send_reduce(int dest, int chunk, int64_t round, int64_t count,
//                    const float* d, size_t n);
//   void send_complete(int64_t round);
//   void defer_start(int64_t round);                 // self-queue
//   void defer_scatter(int src, int chunk, int64_t round,
//                      const float* d, size_t n);
//   void defer_reduce(int src, int chunk, int64_t round, int64_t count,
//                     const float* d, size_t n);
//   void flush_sink(int64_t round, const float* out, const int* counts,
//                   long n);                         // sink delivery
#ifndef AAT_WORKER_CORE_H_
#define AAT_WORKER_CORE_H_

#include <algorithm>
#include <cstdint>
#include <set>
#include <utility>
#include <vector>

#include "ring.h"

namespace aat {

template <class Env>
struct WorkerCore {
    Env* env = nullptr;
    int id = -1;
    int peer_num = 0;
    double th_reduce = 1.0, th_complete = 1.0;
    int max_lag = 0;
    int64_t round = -1, max_round = -1, max_scattered = -1;
    std::set<int64_t> completed;

    long data_size = 0;
    int max_chunk = 1024;
    std::vector<std::pair<long, long>> ranges;
    long my_block = 0, max_block = 0;
    Ring scatter_buf, reduce_buf;
    std::vector<int> reduce_counts;  // depth * peers * nchunks piggyback
    int scatter_gate = 0;
    long completion_gate = 0, total_chunks = 0;
    std::vector<float> out_data;
    std::vector<int> out_counts;

    void init(Env* e, int rank, int peers, double thr, double thc,
              int lag, long dsize, int chunk, int64_t start_round) {
        env = e;
        id = rank;
        peer_num = peers;
        th_reduce = thr;
        th_complete = thc;
        max_lag = lag;
        round = start_round;
        max_round = start_round - 1;
        max_scattered = start_round - 1;
        completed.clear();
        data_size = dsize;
        max_chunk = chunk;

        long step = data_size > 0
            ? (data_size + peer_num - 1) / peer_num : 0;
        ranges.clear();
        for (int i = 0; i < peer_num; ++i) {
            long lo = step > 0 ? std::min((long)i * step, data_size)
                               : data_size;
            long hi = step > 0 ? std::min((long)(i + 1) * step, data_size)
                               : data_size;
            ranges.emplace_back(lo, hi);
        }
        my_block = ranges[id].second - ranges[id].first;
        max_block = ranges[0].second - ranges[0].first;
        scatter_buf.init((int)my_block, peer_num, max_lag + 1, max_chunk);
        scatter_gate = peer_num > 0
            ? std::max(1, (int)(th_reduce * peer_num)) : 0;
        reduce_buf.init((int)max_block, peer_num, max_lag + 1, max_chunk);
        reduce_counts.assign(
            (size_t)(max_lag + 1) * peer_num *
                (reduce_buf.nchunks ? reduce_buf.nchunks : 1), 0);
        total_chunks = 0;
        for (int i = 0; i < peer_num; ++i) {
            long blk = ranges[i].second - ranges[i].first;
            if (blk > 0)
                total_chunks += (blk + max_chunk - 1) / max_chunk;
        }
        long gate = (long)(th_complete * total_chunks);
        completion_gate = total_chunks > 0
            ? std::min(std::max(1L, gate), total_chunks) : 0;
        out_data.resize(data_size);
        out_counts.resize(data_size);
    }

    // -- round start + catch-up (protocol/worker.py _handle_start) ---------

    void on_start(int64_t r) {
        if (r > max_round) max_round = r;
        // catch-up: force-complete rounds fallen out of the maxLag
        // window (reference: AllreduceWorker.scala:100-106)
        while (round < max_round - max_lag) {
            for (int k = 0; k < scatter_buf.nchunks; ++k) {
                long start = (long)k * max_chunk;
                long end = std::min(my_block, start + max_chunk);
                int t = scatter_buf.tidx(0);
                std::vector<float> red((size_t)(end - start), 0.f);
                for (int p = 0; p < peer_num; ++p) {
                    const float* row = scatter_buf.row_ptr(t, p);
                    for (long e = start; e < end; ++e)
                        red[e - start] += row[e];
                }
                int cnt = (int)scatter_buf.filled[
                    (size_t)t * scatter_buf.nchunks + k];
                broadcast(red.data(), red.size(), k, round, cnt);
            }
            complete(round, 0);
        }
        // pipeline scatters up to the newest round
        while (max_scattered < max_round) {
            scatter_round(max_scattered + 1);
            max_scattered += 1;
        }
        // prune completions below the window
        for (auto it = completed.begin(); it != completed.end();)
            it = (*it < round) ? completed.erase(it) : ++it;
    }

    // -- scatter phase -----------------------------------------------------

    void scatter_round(int64_t r) {
        // rank-staggered fan-out, self-delivery bypass
        // (reference: AllreduceWorker.scala:212-238)
        const float* src = env->source();
        for (int i = 0; i < peer_num; ++i) {
            int idx = (i + id) % peer_num;
            if (!env->rank_alive(idx)) continue;
            long lo = ranges[idx].first, hi = ranges[idx].second;
            long blk = hi - lo;
            long nch = blk > 0 ? (blk + max_chunk - 1) / max_chunk : 0;
            for (long c = 0; c < nch; ++c) {
                long cs = c * max_chunk;
                long ce = std::min(blk, cs + max_chunk);
                if (idx == id)
                    on_scatter(id, (int)c, r, src + lo + cs,
                               (size_t)(ce - cs));
                else
                    env->send_scatter(idx, (int)c, r, src + lo + cs,
                                      (size_t)(ce - cs));
            }
        }
    }

    void on_scatter(int src, int chunk, int64_t r, const float* d,
                    size_t n) {
        if (r < round || completed.count(r)) return;  // stale drop
        if (r <= max_round) {
            int row = (int)(r - round);
            if (!scatter_buf.store(d, n, row, src, chunk)) return;
            int t = scatter_buf.tidx(row);
            if (scatter_buf.filled[(size_t)t * scatter_buf.nchunks +
                                   chunk] == scatter_gate) {  // == once
                long start = (long)chunk * max_chunk;
                long end = std::min(my_block, start + max_chunk);
                std::vector<float> red((size_t)(end - start), 0.f);
                for (int p = 0; p < peer_num; ++p) {
                    const float* rowp = scatter_buf.row_ptr(t, p);
                    for (long e = start; e < end; ++e)
                        red[e - start] += rowp[e];
                }
                broadcast(red.data(), red.size(), chunk, r,
                          scatter_gate);
            }
        } else {
            // a round we haven't been started for: requeue behind a
            // self Start (reference: AllreduceWorker.scala:183-184)
            env->defer_start(r);
            env->defer_scatter(src, chunk, r, d, n);
        }
    }

    // -- reduce / broadcast phase ------------------------------------------

    void broadcast(const float* d, size_t n, int chunk, int64_t r,
                   int cnt) {
        for (int i = 0; i < peer_num; ++i) {
            int idx = (i + id) % peer_num;
            if (!env->rank_alive(idx)) continue;
            if (idx == id) on_reduce(id, chunk, r, cnt, d, n);
            else env->send_reduce(idx, chunk, r, cnt, d, n);
        }
    }

    void on_reduce(int src, int chunk, int64_t r, int64_t count,
                   const float* d, size_t n) {
        if ((long)n > max_chunk) return;  // guard (strict=no)
        if (r < round || completed.count(r)) return;  // stale drop
        if (r <= max_round) {
            int row = (int)(r - round);
            if (!reduce_buf.store(d, n, row, src, chunk)) return;
            int t = reduce_buf.tidx(row);
            reduce_counts[((size_t)t * peer_num + src) *
                          reduce_buf.nchunks + chunk] = (int)count;
            if (reduce_buf.total[t] == completion_gate)  // == : once
                complete(r, row);
        } else {
            env->defer_start(r);
            env->defer_reduce(src, chunk, r, count, d, n);
        }
    }

    // -- completion --------------------------------------------------------

    void complete(int64_t r, int row) {
        flush(r, row);
        env->send_complete(r);
        completed.insert(r);
        if (round == r) {
            for (;;) {
                round += 1;
                scatter_buf.up();
                reduce_buf.up();
                // retire the rotated-out reduce_counts row
                int t = reduce_buf.tidx(max_lag);
                std::fill(
                    reduce_counts.begin() +
                        (size_t)t * peer_num * reduce_buf.nchunks,
                    reduce_counts.begin() +
                        (size_t)(t + 1) * peer_num * reduce_buf.nchunks,
                    0);
                if (!completed.count(round)) break;
            }
        }
    }

    void flush(int64_t r, int row) {
        // reassemble output + per-element counts, zero-filling missing
        // chunks (reference: ReducedDataBuffer.scala:26-53)
        int t = reduce_buf.tidx(row);
        long transferred = 0, count_transferred = 0;
        for (int i = 0; i < peer_num; ++i) {
            const float* block = reduce_buf.row_ptr(t, i);
            long bs = std::min(data_size - transferred, max_block);
            if (bs > 0)
                std::memcpy(out_data.data() + transferred, block,
                            (size_t)bs * sizeof(float));
            for (int j = 0; j < reduce_buf.nchunks; ++j) {
                long csz = std::min((long)max_chunk,
                                    max_block - (long)max_chunk * j);
                long take = std::min(data_size - count_transferred, csz);
                if (take <= 0) break;
                int cnt = reduce_counts[((size_t)t * peer_num + i) *
                                        reduce_buf.nchunks + j];
                std::fill(out_counts.begin() + count_transferred,
                          out_counts.begin() + count_transferred + take,
                          cnt);
                count_transferred += take;
            }
            transferred += bs;
        }
        env->flush_sink(r, out_data.data(), out_counts.data(),
                        data_size);
    }
};

}  // namespace aat

#endif  // AAT_WORKER_CORE_H_
