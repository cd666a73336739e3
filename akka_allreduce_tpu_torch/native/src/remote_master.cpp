// Cross-process native master engine: membership, rank assignment,
// worker init, and round pacing over the C++ TCP transport — the C++
// rendering of protocol/master.py (itself the behavioral port of the
// reference's master actor, AllreduceMaster.scala:12-90). With
// remote_worker.cpp this makes the canonical cluster all-native end to
// end: scripts/smoke_cluster.py --native runs five OS processes whose
// engines, codec, and transport are entirely C++, the deployment shape
// of the reference's JVM cluster under netty remoting.
//
// Semantics mirrored from protocol/master.py:
//  * forming: Hello arrival order = rank (lowest free seat); at quorum,
//    InitWorkers to everyone + StartAllreduce(0)
//  * pacing: tally CompleteAllreduce for the CURRENT round only;
//    advance at numComplete >= totalWorkers * thAllreduce
//    (reference: AllreduceMaster.scala:54-63)
//  * deathwatch: a disconnected (or heartbeat-silent, the
//    unreachable_after window — reference: application.conf:20) worker
//    frees its seat; a later joiner REUSES the lowest free seat, gets a
//    full init at the current round, and cold-start catch-up does the
//    rest (the fixed rejoin protocol/master.py documents)
//  * shutdown: after max_round rounds the master closes, and workers
//    treat the disconnect as cluster shutdown
//
// Build: part of libaatpu.so (native/Makefile). C ABI at the bottom.

#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <map>
#include <vector>

#include "wire_codec.h"

extern "C" {
void* aat_create(const char* bind_host, int port);
int aat_port(void* tp);
int aat_send(void* tp, int peer, const uint8_t* buf, uint64_t len);
int64_t aat_recv_len(void* tp);
int64_t aat_recv_take(void* tp, uint8_t* buf, uint64_t cap, int* src_peer);
int aat_poll_disconnect(void* tp);
void aat_close_peer(void* tp, int peer);
void aat_destroy(void* tp);
}

namespace {

using aat::Addr;
using aat::InitConfig;
using aat::enc_init;
using aat::enc_ping;
using aat::enc_start;
using aat::kComplete;
using aat::kHello;
using aat::kPing;
using aat::rd;
using aat::rd_addr;

double now_s() {
    using namespace std::chrono;
    return duration<double>(steady_clock::now().time_since_epoch())
        .count();
}

struct RemoteMaster {
    void* tp = nullptr;
    Addr self;
    InitConfig cfg;
    double th_allreduce = 1.0;
    int64_t max_round = 0;
    double hb_interval = 2.0;
    double unreachable_after = 10.0;  // <= 0 disables the detector
    int verbose = 0;

    std::map<int, Addr> workers;      // seat -> listen addr
    std::map<int, int> conn_of_rank;  // seat -> transport conn
    std::map<int, int> rank_of_conn;
    std::map<int, double> last_heard;
    std::map<int, double> peer_interval;  // advertised ping cadence
    int64_t round = -1;
    int num_complete = 0;
    long rounds_completed = 0;
    double last_ping = 0.0;
    std::vector<double> round_at;  // monotonic stamp per completed round

    void send_rank(int rank, const std::vector<uint8_t>& f) {
        auto it = conn_of_rank.find(rank);
        if (it == conn_of_rank.end()) return;  // dead-letter drop
        aat_send(tp, it->second, f.data(), f.size());
    }

    std::vector<std::pair<int, Addr>> book() const {
        return {workers.begin(), workers.end()};
    }

    void init_workers(int64_t start_round) {
        auto wb = book();
        for (const auto& [rank, _] : workers)
            send_rank(rank, enc_init(rank, cfg, start_round, self, wb));
    }

    void start_allreduce() {
        num_complete = 0;
        auto f = enc_start(round);
        for (const auto& [rank, _] : workers) send_rank(rank, f);
    }

    // -- membership (protocol/master.py member_up / terminated) ------------

    void member_up(const Addr& a, int conn) {
        // idempotent by address: workers RE-Hello until inited (their
        // cold-start self-healing — a first Hello lost in the join
        // burst must not strand them), and a repeat must refresh, not
        // burn a second seat
        for (const auto& [r, seated] : workers) {
            if (seated == a) {
                auto prev = conn_of_rank.find(r);
                if (prev != conn_of_rank.end() && prev->second != conn)
                    // same-addr refresh on a NEW conn: unmap the old
                    // one, or its later disconnect unseats the live
                    // worker we just re-registered
                    rank_of_conn.erase(prev->second);
                conn_of_rank[r] = conn;
                rank_of_conn[conn] = r;
                if (round >= 0) {
                    init_workers(round);
                    send_rank(r, enc_start(round));
                }
                return;
            }
        }
        int free_seat = -1;
        for (int r = 0; r < (int)cfg.worker_num; ++r)
            if (!workers.count(r)) { free_seat = r; break; }
        if (free_seat < 0) {
            if (verbose)
                std::fprintf(stderr, "master: joiner ignored — all %u "
                             "seats live\n", cfg.worker_num);
            return;
        }
        workers[free_seat] = a;
        conn_of_rank[free_seat] = conn;
        rank_of_conn[conn] = free_seat;
        if (round == -1) {  // forming: arrival order = rank
            std::printf("master: worker %d up, %zu/%u\n", free_seat,
                        workers.size(), cfg.worker_num);
            std::fflush(stdout);
            if (workers.size() >= cfg.worker_num) {
                init_workers(0);
                round = 0;
                start_allreduce();
            }
            return;
        }
        // running: seat REUSE + full re-init at the current round (the
        // joiner's cold-start catch-up force-completes the stale window)
        std::printf("master: worker rejoined as rank %d at round %lld\n",
                    free_seat, (long long)round);
        std::fflush(stdout);
        init_workers(round);
        send_rank(free_seat, enc_start(round));
    }

    void seat_down(int conn) {
        // dispatch() stamps last_heard for ANY conn that sent a frame
        // (rejected joiners included): sweep those maps even for
        // unseated conns, or worker churn leaks entries forever
        last_heard.erase(conn);
        peer_interval.erase(conn);
        auto it = rank_of_conn.find(conn);
        if (it == rank_of_conn.end()) return;
        int rank = it->second;
        rank_of_conn.erase(it);
        conn_of_rank.erase(rank);
        workers.erase(rank);
        std::printf("master: worker down at round %ld\n",
                    rounds_completed);
        std::fflush(stdout);
    }

    // -- round pacing (protocol/master.py _handle_complete) ----------------

    void on_complete(int64_t r) {
        if (r != round) return;  // stale completion dropped
        num_complete += 1;
        if ((double)num_complete >= cfg.worker_num * th_allreduce &&
            round < max_round) {
            rounds_completed += 1;
            round_at.push_back(now_s());
            round += 1;
            start_allreduce();
        }
    }

    // -- liveness (protocol/tcp.py _heartbeat: the down window widens to
    //    2x a slow-pinging peer's ADVERTISED cadence — silence for one
    //    full interval is legitimate — capped at 5x the local window so
    //    a misconfigured peer cannot opt out of detection entirely) ------

    void heartbeat() {
        double now = now_s();
        if (now - last_ping < hb_interval) return;
        last_ping = now;
        auto ping = enc_ping(hb_interval);
        for (auto it = rank_of_conn.begin(); it != rank_of_conn.end();) {
            int conn = it->first;
            ++it;  // seat_down below invalidates the iterator
            double heard = last_heard.count(conn) ? last_heard[conn] : now;
            if (!last_heard.count(conn)) last_heard[conn] = now;
            if (unreachable_after > 0) {
                double widened = 0.0;
                auto pi = peer_interval.find(conn);
                if (pi != peer_interval.end())
                    widened = std::min(2 * pi->second,
                                       5 * unreachable_after);
                double window = std::max(unreachable_after, widened);
                if (now - heard > window) {
                    std::fprintf(stderr,
                                 "master: downing unreachable worker "
                                 "(silent %.1fs, window %.1fs)\n",
                                 now - heard, window);
                    aat_close_peer(tp, conn);
                    seat_down(conn);
                    continue;
                }
            }
            aat_send(tp, conn, ping.data(), ping.size());
        }
    }

    void dispatch(const uint8_t* buf, size_t len, int conn) {
        size_t off = 0;
        uint8_t mtype;
        if (!rd(buf, len, off, &mtype)) return;
        last_heard[conn] = now_s();
        switch (mtype) {
            case kHello: {
                Addr a;
                if (!rd_addr(buf, len, off, &a)) return;
                uint8_t rlen;
                if (!rd(buf, len, off, &rlen)) return;
                if (off + rlen > len) return;
                std::string role(reinterpret_cast<const char*>(buf) + off,
                                 rlen);
                if (role == "worker") member_up(a, conn);
                break;
            }
            case kComplete: {
                int32_t src;
                int64_t r;
                if (rd(buf, len, off, &src) && rd(buf, len, off, &r))
                    on_complete(r);
                break;
            }
            case kPing: {
                double interval;
                if (rd(buf, len, off, &interval) && interval > 0)
                    peer_interval[conn] = interval;
                break;
            }
            default:
                break;  // liveness traffic only
        }
    }

    long run(const char* bind_host, int port, double timeout_s) {
        tp = aat_create(bind_host, port);
        if (!tp) return -3;
        self.host = bind_host;
        self.port = static_cast<uint32_t>(aat_port(tp));
        std::printf("master: listening on %s:%u, waiting for %u "
                    "workers\n", self.host.c_str(), self.port,
                    cfg.worker_num);
        std::fflush(stdout);
        std::vector<uint8_t> buf(1 << 16);
        double deadline = now_s() + timeout_s;
        while (rounds_completed < max_round && now_s() < deadline) {
            bool any = false;
            // BOUNDED drain: under load the transport thread refills
            // the queue faster than the engine empties it, so an
            // until-empty loop starves the disconnect sweep and the
            // heartbeat below indefinitely — a killed worker's seat
            // then never frees and this master never pings
            for (int burst = 0; burst < 512; ++burst) {
                int64_t need = aat_recv_len(tp);
                if (need < 0) break;
                if ((size_t)need > buf.size()) buf.resize(need * 2);
                int src = -1;
                int64_t got = aat_recv_take(tp, buf.data(), buf.size(),
                                            &src);
                if (got < 0) break;
                dispatch(buf.data(), (size_t)got, src);
                any = true;
            }
            for (;;) {
                int c = aat_poll_disconnect(tp);
                if (c < 0) break;
                seat_down(c);
            }
            heartbeat();
            if (!any) usleep(200);
        }
        std::printf("master: %ld/%lld rounds\n", rounds_completed,
                    (long long)max_round);
        std::fflush(stdout);
        aat_destroy(tp);
        return rounds_completed;
    }
};

}  // namespace

extern "C" {

// Serve membership + round pacing natively until max_round rounds
// complete (or timeout); returns rounds completed, or -3 when the
// listen socket could not bind. round_times (may be null, cap entries)
// receives per-round MONOTONIC completion stamps — the per-round
// spread the canonical-scale WIRE benchmarks quote (same contract as
// aat_cluster_run_timed in cluster.cpp).
long aat_remote_master_run_timed(const char* bind_host, int port,
                                 unsigned total_workers,
                                 uint64_t data_size,
                                 uint64_t max_chunk_size, unsigned max_lag,
                                 double th_reduce, double th_complete,
                                 double th_allreduce, int64_t max_round,
                                 double timeout_s, double hb_interval_s,
                                 double unreachable_after_s, int verbose,
                                 double* round_times, long cap) {
    if (total_workers == 0 || max_round < 0 || timeout_s <= 0) return -2;
    RemoteMaster m;
    m.cfg.worker_num = total_workers;
    m.cfg.data_size = data_size;
    m.cfg.max_chunk = max_chunk_size;
    m.cfg.max_lag = max_lag;
    m.cfg.th_reduce = th_reduce;
    m.cfg.th_complete = th_complete;
    m.th_allreduce = th_allreduce;
    m.max_round = max_round;
    m.hb_interval = hb_interval_s > 0 ? hb_interval_s : 2.0;
    m.unreachable_after = unreachable_after_s;
    m.verbose = verbose;
    long rounds = m.run(bind_host, port, timeout_s);
    if (round_times && rounds > 0) {
        long k = std::min(cap, (long)m.round_at.size());
        for (long i = 0; i < k; ++i) round_times[i] = m.round_at[i];
    }
    return rounds;
}

long aat_remote_master_run(const char* bind_host, int port,
                           unsigned total_workers, uint64_t data_size,
                           uint64_t max_chunk_size, unsigned max_lag,
                           double th_reduce, double th_complete,
                           double th_allreduce, int64_t max_round,
                           double timeout_s, double hb_interval_s,
                           double unreachable_after_s, int verbose) {
    return aat_remote_master_run_timed(
        bind_host, port, total_workers, data_size, max_chunk_size,
        max_lag, th_reduce, th_complete, th_allreduce, max_round,
        timeout_s, hb_interval_s, unreachable_after_s, verbose,
        nullptr, 0);
}

}  // extern "C"
