// In-process native protocol cluster: master + N workers on one FIFO
// message queue, the C++ rendering of protocol/{master,worker}.py +
// buffers/* (which are themselves the behavioral port of the reference's
// Akka actors — AllreduceMaster.scala, AllreduceWorker.scala,
// buffer/*.scala). The Python engine remains the SPEC (every rule pinned
// by tests/test_protocol_worker.py); this engine exists because the
// reference's runtime is JVM-native while ours would otherwise be
// interpreted Python — the protocol-bound benchmark regime (tiny
// payloads, README config) measures the runtime, and a native runtime is
// what the reference brings to that fight.
//
// Semantics mirrored exactly (SURVEY.md §3a):
//  * block ownership: step = ceil(dataSize/N), last block short/empty
//  * chunking: ceil(block/maxChunk) wire chunks
//  * thresholds: scatter gate max(1, int(thReduce*peers)), fired on ==
//    (exactly once); completion gate clamp(int(thComplete*totalChunks)),
//    fired on ==; master gate numComplete >= totalWorkers*thAllreduce
//  * maxLag ring of maxLag+1 rows; catch-up force-completes stale rounds
//  * stale drops (round < current or already completed); future rounds
//    requeue behind a self-sent StartAllreduce
//  * rank-staggered fan-out (i+id)%N with self-delivery bypass
//  * count piggyback on ReduceBlock; flush zero-fills missing chunks and
//    expands chunk counts to elements
//  * deathwatch: a killed worker vanishes from the master's tally and
//    every peer map; thresholds then tolerate the gap
//
// Build: part of libaatpu.so (native/Makefile). C ABI at the bottom.

#include <time.h>

#include <cstdint>
#include <cstring>
#include <deque>
#include <set>
#include <vector>

#include "ring.h"
#include "worker_core.h"

namespace {

using aat::Ring;

struct Msg {
    enum Type { kStart, kScatter, kReduce, kComplete } type;
    int dest;   // worker rank, or -1 = master
    int round;
    int src;
    int chunk;
    int count;              // ReduceBlock piggyback
    std::vector<float> payload;
};

struct Cluster;

// In-process Env for the shared worker state machine (worker_core.h):
// sends become FIFO-queue messages, deferred messages re-enter the
// queue behind a self Start, and the sink is the reference's benchmark
// assertion (output == N x input, counts == N).
struct Worker {
    Cluster* cl = nullptr;
    aat::WorkerCore<Worker> core;  // core.id is THE rank (no duplicate)

    void init(Cluster* c, int rank);
    bool rank_alive(int rank);
    const float* source();
    void send_scatter(int dest, int chunk, int64_t round, const float* d,
                      size_t n);
    void send_reduce(int dest, int chunk, int64_t round, int64_t count,
                     const float* d, size_t n);
    void send_complete(int64_t round);
    void defer_start(int64_t round);
    void defer_scatter(int src, int chunk, int64_t round, const float* d,
                       size_t n);
    void defer_reduce(int src, int chunk, int64_t round, int64_t count,
                      const float* d, size_t n);
    void flush_sink(int64_t round, const float* out, const int* counts,
                    long n);
};

struct Cluster {
    // config
    int n = 0;
    long data_size = 0;
    int max_chunk = 1, max_lag = 0, max_round = 0;
    double th_reduce = 1, th_complete = 1, th_allreduce = 1;
    int assert_multiple = 0;

    // runtime
    std::deque<Msg> queue;
    std::vector<Worker> workers;
    std::vector<char> alive;
    std::vector<float> source;     // constant arange input, shared
    long outputs_flushed = 0;
    bool failed = false;           // sink assertion tripped

    // master state (protocol/master.py)
    int m_round = -1;
    int m_num_complete = 0;
    long rounds_completed = 0;
    std::vector<double> round_at;  // monotonic stamp per round advance

    static double now_s() {
        timespec ts{};
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return (double)ts.tv_sec + ts.tv_nsec * 1e-9;
    }

    void send(int dest, Msg&& m) {
        m.dest = dest;
        queue.emplace_back(std::move(m));
    }

    void master_on_complete(const Msg& m) {
        if (m.round != m_round) return;  // stale completion dropped
        m_num_complete += 1;
        if ((double)m_num_complete >= n * th_allreduce &&
            m_round < max_round) {
            rounds_completed += 1;
            round_at.push_back(now_s());
            m_round += 1;
            start_round();
        }
    }
    void start_round() {
        m_num_complete = 0;
        for (int i = 0; i < n; ++i)
            if (alive[i]) {
                Msg s; s.type = Msg::kStart; s.round = m_round;
                send(i, std::move(s));
            }
    }
    void kill(int rank) {
        // deathwatch: master tally and every peer map drop the rank
        // (reference: AllreduceMaster.scala:46-52,
        //  AllreduceWorker.scala:141-146)
        alive[rank] = 0;
    }

    void deliver(Msg& m) {
        if (m.dest == -1) { master_on_complete(m); return; }
        if (!alive[m.dest]) return;  // dead letter
        Worker& w = workers[m.dest];
        switch (m.type) {
            case Msg::kStart:
                w.core.on_start(m.round);
                break;
            case Msg::kScatter:
                w.core.on_scatter(m.src, m.chunk, m.round,
                                  m.payload.data(), m.payload.size());
                break;
            case Msg::kReduce:
                w.core.on_reduce(m.src, m.chunk, m.round, m.count,
                                 m.payload.data(), m.payload.size());
                break;
            default: break;
        }
    }

    long run(int kill_rank) {
        source.resize(data_size);
        for (long i = 0; i < data_size; ++i) source[i] = (float)i;
        workers.resize(n);
        alive.assign(n, 1);
        for (int i = 0; i < n; ++i) workers[i].init(this, i);
        // quorum formed: init is constructor state here; start round 0
        m_round = 0;
        start_round();
        if (kill_rank >= 0 && kill_rank < n) kill(kill_rank);

        // runaway cap scaled to the workload (protocol/cluster.py
        // _message_budget)
        long chunks = workers.empty() ? 1
            : (workers[0].core.max_block + max_chunk - 1) / max_chunk;
        if (chunks < 1) chunks = 1;
        long per_round = (long)n * n * 2 * chunks + 4L * n;
        long budget = 16L * per_round * (max_round + max_lag + 2);
        if (budget < 1000000L) budget = 1000000L;

        while (!queue.empty() && budget-- > 0 && !failed) {
            Msg m = std::move(queue.front());
            queue.pop_front();
            deliver(m);
        }
        return failed ? -1 : rounds_completed;
    }
};

void Worker::init(Cluster* c, int rank) {
    cl = c;
    core.init(this, rank, c->n, c->th_reduce, c->th_complete, c->max_lag,
              c->data_size, c->max_chunk, /*start_round=*/0);
}

bool Worker::rank_alive(int rank) { return cl->alive[rank] != 0; }

const float* Worker::source() { return cl->source.data(); }

void Worker::send_scatter(int dest, int chunk, int64_t round,
                          const float* d, size_t n) {
    Msg m; m.type = Msg::kScatter; m.round = (int)round; m.src = core.id;
    m.chunk = chunk;
    m.payload.assign(d, d + n);
    cl->send(dest, std::move(m));
}

void Worker::send_reduce(int dest, int chunk, int64_t round,
                         int64_t count, const float* d, size_t n) {
    Msg m; m.type = Msg::kReduce; m.round = (int)round; m.src = core.id;
    m.chunk = chunk; m.count = (int)count;
    m.payload.assign(d, d + n);
    cl->send(dest, std::move(m));
}

void Worker::send_complete(int64_t round) {
    Msg c; c.type = Msg::kComplete; c.round = (int)round; c.src = core.id;
    cl->send(-1, std::move(c));
}

void Worker::defer_start(int64_t round) {
    Msg s; s.type = Msg::kStart; s.round = (int)round;
    cl->send(core.id, std::move(s));
}

void Worker::defer_scatter(int src, int chunk, int64_t round,
                           const float* d, size_t n) {
    Msg m; m.type = Msg::kScatter; m.round = (int)round; m.src = src;
    m.chunk = chunk;
    m.payload.assign(d, d + n);
    cl->send(core.id, std::move(m));
}

void Worker::defer_reduce(int src, int chunk, int64_t round,
                          int64_t count, const float* d, size_t n) {
    Msg m; m.type = Msg::kReduce; m.round = (int)round; m.src = src;
    m.chunk = chunk; m.count = (int)count;
    m.payload.assign(d, d + n);
    cl->send(core.id, std::move(m));
}

void Worker::flush_sink(int64_t round, const float* out,
                        const int* counts, long n) {
    (void)round;
    cl->outputs_flushed += 1;
    if (cl->assert_multiple > 0) {
        // the reference's benchmark sink invariant: output == N x input,
        // counts == N (valid when all thresholds are 1.0; reference:
        // AllreduceWorker.scala:337-339)
        int nmul = cl->assert_multiple;
        for (long e = 0; e < n; ++e) {
            if (out[e] != (float)e * nmul || counts[e] != nmul) {
                cl->failed = true;
                return;
            }
        }
    }
}

}  // namespace

extern "C" {

// Run a full in-process cluster; returns rounds completed, or -1 when the
// correctness assertion (assert_multiple > 0) failed. out_flushed (may be
// null) receives the total number of sink flushes across workers.
// round_times (may be null, cap entries) receives per-round MONOTONIC
// completion stamps — the per-round spread canonical-scale benchmarks
// quote alongside the mean rate (scripts/bench_canonical.py).
long aat_cluster_run_timed(int workers, long data_size,
                           int max_chunk_size, int max_lag,
                           double th_reduce, double th_complete,
                           double th_allreduce, int max_round,
                           int kill_rank, int assert_multiple,
                           long* out_flushed, double* round_times,
                           long times_cap) {
    if (workers <= 0 || data_size < 0 || max_chunk_size <= 0 ||
        max_lag < 0 || max_round < 0)
        return -2;
    if (kill_rank >= workers || kill_rank < -1)
        return -2;  // no such seat (the python engine raises KeyError);
                    // only -1 means "no kill"
    Cluster c;
    c.n = workers;
    c.data_size = data_size;
    c.max_chunk = max_chunk_size;
    c.max_lag = max_lag;
    c.max_round = max_round;
    c.th_reduce = th_reduce;
    c.th_complete = th_complete;
    c.th_allreduce = th_allreduce;
    c.assert_multiple = assert_multiple;
    long rounds = c.run(kill_rank);
    if (out_flushed) *out_flushed = c.outputs_flushed;
    if (round_times) {
        long k = std::min<long>(times_cap, (long)c.round_at.size());
        for (long i = 0; i < k; ++i) round_times[i] = c.round_at[i];
    }
    return rounds;
}

long aat_cluster_run(int workers, long data_size, int max_chunk_size,
                     int max_lag, double th_reduce, double th_complete,
                     double th_allreduce, int max_round, int kill_rank,
                     int assert_multiple, long* out_flushed) {
    return aat_cluster_run_timed(workers, data_size, max_chunk_size,
                                 max_lag, th_reduce, th_complete,
                                 th_allreduce, max_round, kill_rank,
                                 assert_multiple, out_flushed, nullptr,
                                 0);
}

}  // extern "C"
