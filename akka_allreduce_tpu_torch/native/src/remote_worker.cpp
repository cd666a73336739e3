// Cross-process native worker engine: the shared C++ protocol worker
// (worker_core.h — ONE state machine for both native deployments)
// joined to the C++ framed TCP transport (transport.cpp) with the
// binary wire codec (protocol/wire.py) — the native engine running
// across real OS process boundaries, in the role the reference's JVM
// worker plays under Akka netty remoting (reference:
// AllreduceWorker.scala:303-346, application.conf:5-11).
//
// The protocol rules live in worker_core.h (mirroring the Python spec
// protocol/worker.py, pinned by tests/test_protocol_worker.py); this
// file is the DEPLOYMENT: transport dials, Hello/InitWorkers
// membership, the self-queue for deferred rounds, heartbeats, the
// throughput sink, and master-death shutdown. Peer-sum order is
// ascending rank — bit-identical f32 reductions across the Python and
// native engines, so both can serve one cluster interchangeably
// (pinned by tests/test_native_remote.py's mixed-engine cluster).
//
// Deployment protocol (protocol/tcp.py TcpRouter):
//   dial master -> Hello(own listen addr, "worker") -> InitWorkers
//   assigns rank + peer address book -> rounds run over lazily-dialed
//   peer connections (each greeted with Hello) -> CompleteAllreduce to
//   the master -> master disconnect = shutdown (the reference's
//   clusters stop by killing the master). Pings go out every heartbeat
//   interval so the master's failure detector (reference:
//   application.conf:20) keeps seeing this worker alive; until
//   InitWorkers arrives the greeting is re-sent each beat (cold-start
//   self-healing — a Hello lost in the join burst must not strand us).
//
// Build: part of libaatpu.so (native/Makefile). C ABI at the bottom.

#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <string>
#include <vector>

#include "wire_codec.h"
#include "worker_core.h"

extern "C" {
void* aat_create(const char* bind_host, int port);
int aat_port(void* tp);
int aat_connect(void* tp, const char* host, int port, int timeout_ms);
int aat_send(void* tp, int peer, const uint8_t* buf, uint64_t len);
int64_t aat_recv_len(void* tp);
int64_t aat_recv_take(void* tp, uint8_t* buf, uint64_t cap, int* src_peer);
int aat_poll_disconnect(void* tp);
void aat_close_peer(void* tp, int peer);
int aat_send_drained(void* tp, int peer);
void aat_destroy(void* tp);
}

namespace {

using aat::Addr;
using aat::enc_complete;
using aat::enc_hello;
using aat::enc_ping;
using aat::enc_reduce;
using aat::enc_scatter;
using aat::kComplete;
using aat::kHello;
using aat::kInit;
using aat::kPing;
using aat::kReduce;
using aat::kScatter;
using aat::kStart;
using aat::rd;
using aat::rd_addr;

// decoded protocol message (scatter/reduce/start only — the self queue)
struct PMsg {
    uint8_t type = 0;
    int src = 0, dest = 0, chunk = 0;
    int64_t round = 0, count = 0;
    std::vector<float> payload;
};

double now_s() {
    using namespace std::chrono;
    return duration<double>(steady_clock::now().time_since_epoch())
        .count();
}

// ---- the deployment (Env for worker_core.h) -----------------------------

struct RemoteWorker {
    void* tp = nullptr;
    Addr self;
    Addr master_addr;        // send target (Init-advertised once known)
    Addr dialed_master;      // the addr we actually dialed (CLI flags)
    bool master_known = false;
    bool master_gone = false;
    std::map<Addr, int> conn_of;
    std::map<int, Addr> addr_of_conn;
    int connect_timeout_ms = 10000;
    double hb_interval = 2.0;
    double last_ping = 0.0;
    int verbose = 0;

    // multi-seed failover (protocol/remote.py run_worker semantics):
    // any seed admits the joiner; rejoin_timeout > 0 turns master
    // disconnect into a cold-reset + redial through the seed list
    std::vector<Addr> seeds;
    double rejoin_timeout = 0.0;
    int generation = 0;       // epochs joined - 1 (fence gate)
    bool discarding = false;  // reset->rejoin window: drop stale blocks

    aat::WorkerCore<RemoteWorker> core;  // the shared state machine
    std::map<int, Addr> peers;  // rank -> listen addr (deathwatch prunes)
    std::vector<float> source_vec;  // constant arange input

    // sink (protocol/cluster.py ThroughputSink)
    long outputs_flushed = 0;
    int checkpoint = 10;
    int assert_multiple = 0;
    bool failed = false;
    double window_t0 = 0.0;

    std::deque<PMsg> self_q;  // requeue-behind-self-Start mail

    // -- connections ------------------------------------------------------

    int ensure_conn(const Addr& a) {
        auto it = conn_of.find(a);
        if (it != conn_of.end()) return it->second;
        int c = aat_connect(tp, a.host.c_str(),
                            static_cast<int>(a.port),
                            connect_timeout_ms);
        if (c < 0) return -1;
        conn_of[a] = c;
        addr_of_conn[c] = a;
        auto hello = enc_hello(self, "worker");
        aat_send(tp, c, hello.data(), hello.size());
        return c;
    }

    void send_frame(const Addr& a, const std::vector<uint8_t>& f) {
        int c = ensure_conn(a);
        if (c < 0) return;  // dead peer: dead-letter drop
        aat_send(tp, c, f.data(), f.size());
    }

    // -- Env interface consumed by WorkerCore ------------------------------

    bool rank_alive(int rank) { return peers.count(rank) > 0; }

    const float* source() { return source_vec.data(); }

    void send_scatter(int dest, int chunk, int64_t round, const float* d,
                      size_t n) {
        auto pit = peers.find(dest);
        if (pit == peers.end()) return;
        send_frame(pit->second,
                   enc_scatter(core.id, dest, chunk, round, d, n));
    }

    void send_reduce(int dest, int chunk, int64_t round, int64_t count,
                     const float* d, size_t n) {
        auto pit = peers.find(dest);
        if (pit == peers.end()) return;
        send_frame(pit->second,
                   enc_reduce(core.id, dest, chunk, round, count, d, n));
    }

    void send_complete(int64_t round) {
        if (master_known)
            send_frame(master_addr, enc_complete(core.id, round));
    }

    // Epoch fence (protocol/worker.py _stale_epoch_round): after a
    // multi-seed rejoin, a block whose round exceeds the newest Start by
    // more than the in-flight window cannot belong to the current master
    // epoch — self-starting it (the cold-start catch-up below) would
    // jump this worker decades ahead of the restarted master. Never
    // fences generation 0: catch-up jumps are the reference's own
    // semantics (AllreduceWorker.scala:183-184).
    bool stale_epoch_round(int64_t round) const {
        return generation > 0
            && round > core.max_round + core.max_lag + 1;
    }

    void defer_start(int64_t round) {
        if (stale_epoch_round(round)) return;
        PMsg s; s.type = kStart; s.round = round;
        self_q.push_back(std::move(s));
    }

    void defer_scatter(int src, int chunk, int64_t round, const float* d,
                       size_t n) {
        if (stale_epoch_round(round)) return;
        PMsg m; m.type = kScatter; m.src = src; m.dest = core.id;
        m.chunk = chunk; m.round = round;
        m.payload.assign(d, d + n);
        self_q.push_back(std::move(m));
    }

    void defer_reduce(int src, int chunk, int64_t round, int64_t count,
                      const float* d, size_t n) {
        if (stale_epoch_round(round)) return;
        PMsg m; m.type = kReduce; m.src = src; m.dest = core.id;
        m.chunk = chunk; m.round = round; m.count = count;
        m.payload.assign(d, d + n);
        self_q.push_back(std::move(m));
    }

    void flush_sink(int64_t r, const float* out, const int* counts,
                    long n) {
        outputs_flushed += 1;
        if (assert_multiple > 0) {
            for (long e = 0; e < n; ++e) {
                if (out[e] != (float)e * assert_multiple ||
                    counts[e] != assert_multiple) {
                    std::fprintf(stderr,
                                 "native worker %d: ASSERT output[%ld]="
                                 "%f count=%d != %d x input at round %lld"
                                 "\n", core.id, e, out[e], counts[e],
                                 assert_multiple, (long long)r);
                    failed = true;
                    return;
                }
            }
        }
        if (checkpoint > 0 && outputs_flushed % checkpoint == 0) {
            double dt = now_s() - window_t0;
            double mbs = dt > 0
                ? (double)n * 4 * checkpoint / dt / 1e6 : 0.0;
            std::printf("native worker %d: round %lld, %.2f MB/s\n",
                        core.id, (long long)r, mbs);
            std::fflush(stdout);
            window_t0 = now_s();
        }
    }

    // -- init (protocol/worker.py _handle_init) ----------------------------

    void on_init(const uint8_t* buf, size_t len, size_t off) {
        int32_t dest_id;
        uint32_t worker_num, lag32;
        double thr, thc;
        uint64_t dsz, chunk;
        int64_t start_round;
        if (!rd(buf, len, off, &dest_id) || !rd(buf, len, off, &worker_num)
            || !rd(buf, len, off, &thr) || !rd(buf, len, off, &thc)
            || !rd(buf, len, off, &lag32) || !rd(buf, len, off, &dsz)
            || !rd(buf, len, off, &chunk)
            || !rd(buf, len, off, &start_round))
            return;
        uint8_t has_master;
        if (!rd(buf, len, off, &has_master)) return;
        Addr maddr;
        if (has_master && !rd_addr(buf, len, off, &maddr)) return;
        if (has_master && !(maddr == dialed_master)) {
            // the master's ADVERTISED addr (e.g. its bind IP) may differ
            // from the host string we dialed: alias it to the dialed
            // connection so CompleteAllreduce rides the existing socket
            // instead of opening a duplicate that Hellos as a new member
            auto dit = conn_of.find(dialed_master);
            // assignment, not emplace: a stale alias from a previous
            // epoch (same advertised addr, dead conn) must be replaced
            if (dit != conn_of.end()) conn_of[maddr] = dit->second;
        }
        uint32_t count;
        if (!rd(buf, len, off, &count)) return;
        std::map<int, Addr> wmap;
        for (uint32_t i = 0; i < count; ++i) {
            int32_t rank;
            Addr a;
            if (!rd(buf, len, off, &rank) || !rd_addr(buf, len, off, &a))
                return;
            wmap[rank] = a;
        }
        if (core.id != -1) {  // re-init refreshes the peer map only
            peers = std::move(wmap);
            return;
        }
        if (has_master) { master_addr = maddr; master_known = true; }
        peers = std::move(wmap);
        source_vec.resize(dsz);
        for (uint64_t i = 0; i < dsz; ++i) source_vec[i] = (float)i;
        core.init(this, dest_id, (int)worker_num, thr, thc, (int)lag32,
                  (long)dsz, (int)chunk, start_round);
        window_t0 = now_s();
        if (verbose)
            std::fprintf(stderr,
                         "native worker %d: %d peers, block %ld\n",
                         core.id, core.peer_num, core.my_block);
    }

    // -- frame dispatch ----------------------------------------------------

    void dispatch(const uint8_t* buf, size_t len, int conn) {
        size_t off = 0;
        uint8_t mtype;
        if (!rd(buf, len, off, &mtype)) return;
        switch (mtype) {
            case kHello: {
                Addr a;
                if (!rd_addr(buf, len, off, &a)) return;
                // map the inbound connection; prefer an existing dialed
                // one for sending (protocol/tcp.py _handle_hello)
                addr_of_conn[conn] = a;
                conn_of.emplace(a, conn);
                break;
            }
            case kInit:
                on_init(buf, len, off);
                break;
            case kStart: {
                int64_t r;
                if (!rd(buf, len, off, &r)) break;
                if (core.id == -1) {
                    if (!discarding) defer_start(r);
                } else {
                    core.on_start(r);
                }
                break;
            }
            case kScatter: {
                PMsg m; m.type = kScatter;
                int32_t src, dest, chunk;
                uint64_t nbytes;
                if (!rd(buf, len, off, &src) || !rd(buf, len, off, &dest)
                    || !rd(buf, len, off, &chunk)
                    || !rd(buf, len, off, &m.round)
                    || !rd(buf, len, off, &nbytes))
                    return;
                // subtraction form: off + nbytes could wrap the uint64
                if (nbytes > len - off || nbytes % 4) return;
                m.src = src; m.dest = dest; m.chunk = chunk;
                m.payload.resize(nbytes / 4);
                std::memcpy(m.payload.data(), buf + off, nbytes);
                if (core.id == -1) {
                    // pre-rejoin window: old-epoch leftovers are
                    // DROPPED, not queued (protocol/worker.py reset())
                    if (!discarding) self_q.push_back(std::move(m));
                } else if (m.dest == core.id) {  // misroutes dropped
                    core.on_scatter(m.src, m.chunk, m.round,
                                    m.payload.data(), m.payload.size());
                }
                break;
            }
            case kReduce: {
                PMsg m; m.type = kReduce;
                int32_t src, dest, chunk;
                uint64_t nbytes;
                if (!rd(buf, len, off, &src) || !rd(buf, len, off, &dest)
                    || !rd(buf, len, off, &chunk)
                    || !rd(buf, len, off, &m.round)
                    || !rd(buf, len, off, &m.count)
                    || !rd(buf, len, off, &nbytes))
                    return;
                // subtraction form: off + nbytes could wrap the uint64
                if (nbytes > len - off || nbytes % 4) return;
                m.src = src; m.dest = dest; m.chunk = chunk;
                m.payload.resize(nbytes / 4);
                std::memcpy(m.payload.data(), buf + off, nbytes);
                if (core.id == -1) {
                    if (!discarding) self_q.push_back(std::move(m));
                } else if (m.dest == core.id) {  // misroutes dropped
                    core.on_reduce(m.src, m.chunk, m.round, m.count,
                                   m.payload.data(), m.payload.size());
                }
                break;
            }
            case kPing:
            case kComplete:
            default:
                break;  // liveness traffic / not for workers
        }
    }

    void drain_self_q() {
        // process only what was queued at entry (protocol/tcp.py
        // _drain_local): a requeueing handler must not starve inbound
        size_t n = self_q.size();
        for (size_t i = 0; i < n && !self_q.empty(); ++i) {
            PMsg m = std::move(self_q.front());
            self_q.pop_front();
            if (m.type == kStart) {
                if (core.id == -1) self_q.push_back(std::move(m));
                else core.on_start(m.round);
            } else if (core.id == -1) {
                self_q.push_back(std::move(m));
            } else if (m.dest != core.id) {
                // pre-init-queued frame addressed to another rank (e.g.
                // a reused listen port): drop, same as the dispatch-path
                // misroute guard — never stage foreign payloads
            } else if (m.type == kScatter) {
                core.on_scatter(m.src, m.chunk, m.round,
                                m.payload.data(), m.payload.size());
            } else if (m.type == kReduce) {
                core.on_reduce(m.src, m.chunk, m.round, m.count,
                               m.payload.data(), m.payload.size());
            }
        }
    }

    void drain_disconnects() {
        for (;;) {
            int c = aat_poll_disconnect(tp);
            if (c < 0) return;
            auto it = addr_of_conn.find(c);
            if (it == addr_of_conn.end()) continue;
            Addr a = it->second;
            addr_of_conn.erase(it);
            // sweep EVERY conn_of entry riding this conn, aliases
            // included: the master's advertised addr is aliased onto
            // the dialed conn (on_init), and a stale alias surviving a
            // failover would silently swallow the new epoch's
            // CompleteAllreduce sends
            for (auto cit = conn_of.begin(); cit != conn_of.end();) {
                if (cit->second == c) cit = conn_of.erase(cit);
                else ++cit;
            }
            if ((master_known && a == master_addr)
                || a == dialed_master) {
                master_gone = true;  // master death = shutdown
                continue;
            }
            // deathwatch: drop the dead rank; thresholds tolerate the
            // gap (protocol/worker.py terminated)
            for (auto pit = peers.begin(); pit != peers.end();) {
                if (pit->second == a) pit = peers.erase(pit);
                else ++pit;
            }
        }
    }

    void heartbeat() {
        double now = now_s();
        if (now - last_ping < hb_interval) return;
        last_ping = now;
        auto ping = enc_ping(hb_interval);
        for (auto& [a, c] : conn_of)
            aat_send(tp, c, ping.data(), ping.size());
        if (core.id == -1) {
            // cold-start self-healing: until InitWorkers arrives, keep
            // re-greeting the master (idempotent there) — a Hello lost
            // in the simultaneous join burst must not strand this
            // worker waiting forever
            auto it = conn_of.find(master_addr);
            if (it != conn_of.end()) {
                auto hello = enc_hello(self, "worker");
                aat_send(tp, it->second, hello.data(), hello.size());
            }
        }
    }

    // ONE bounded recv loop serving both the run loop and the rejoin
    // gap (a hand-maintained second copy would drift): hands each frame
    // to `handle`, returns whether anything arrived
    template <typename F>
    bool recv_burst(std::vector<uint8_t>& buf, F&& handle) {
        bool any = false;
        for (int burst = 0; burst < 512; ++burst) {
            int64_t need = aat_recv_len(tp);
            if (need < 0) break;
            if ((size_t)need > buf.size()) buf.resize(need * 2);
            int src = -1;
            int64_t got = aat_recv_take(tp, buf.data(), buf.size(), &src);
            if (got < 0) break;
            handle(buf.data(), (size_t)got, src);
            any = true;
        }
        return any;
    }

    // drain-and-drop during the rejoin gap: stale frames queued in the
    // transport must not survive into the new epoch (only peer Hellos
    // keep their conn mapping current)
    void drain_discard(std::vector<uint8_t>& buf) {
        recv_burst(buf, [&](const uint8_t* d, size_t len, int src) {
            size_t off = 0;
            uint8_t mtype;
            if (rd(d, len, off, &mtype) && mtype == kHello)
                dispatch(d, len, src);
        });
        drain_disconnects();
    }

    void reset_epoch() {
        core = aat::WorkerCore<RemoteWorker>();
        peers.clear();
        self_q.clear();
        master_known = false;
        master_gone = false;
        dialed_master = Addr{};
        generation += 1;
        discarding = true;
    }

    // cycle the seed list until one master admits us (any seed admits a
    // joiner — the reference's seed-node semantics)
    bool dial_any(double give_up, std::vector<uint8_t>& buf) {
        for (;;) {
            for (const auto& s : seeds) {
                int c = aat_connect(tp, s.host.c_str(),
                                    static_cast<int>(s.port), 2000);
                if (c >= 0) {
                    dialed_master = s;
                    master_addr = s;
                    master_known = true;
                    conn_of[s] = c;
                    addr_of_conn[c] = s;
                    auto hello = enc_hello(self, "worker");
                    aat_send(tp, c, hello.data(), hello.size());
                    discarding = false;  // joined: new-epoch traffic now
                    return true;
                }
            }
            if (now_s() >= give_up) return false;
            drain_discard(buf);
            usleep(200000);
        }
    }

    long run(double timeout_s) {
        tp = aat_create("127.0.0.1", 0);
        if (!tp) return -3;
        self.host = "127.0.0.1";
        self.port = static_cast<uint32_t>(aat_port(tp));
        std::vector<uint8_t> buf(1 << 20);
        double deadline = now_s() + timeout_s;
        // join-retry: the master may not be listening yet (seed-node
        // join retries, protocol/remote.py run_worker)
        if (!dial_any(deadline, buf)) { aat_destroy(tp); return -3; }
        for (;;) {
            while (!master_gone && !failed && now_s() < deadline) {
                drain_self_q();
                // BOUNDED drain (see remote_master.cpp): an until-empty
                // loop under sustained traffic starves the disconnect
                // sweep and the outbound heartbeat — the master's
                // failure detector would then falsely down a flooded-
                // but-healthy worker, and a dead master go unnoticed
                bool any = recv_burst(
                    buf, [&](const uint8_t* d, size_t len, int src) {
                        dispatch(d, len, src);
                    });
                drain_disconnects();
                heartbeat();
                if (!any && self_q.empty()) usleep(200);
            }
            if (master_gone && rejoin_timeout > 0 && !failed
                && now_s() < deadline) {
                // master epoch ended: cold-reset and rejoin through the
                // seeds (a restarted master reforms the cluster)
                if (verbose)
                    std::fprintf(stderr, "native worker: master gone, "
                                 "redialing %zu seed(s)\n", seeds.size());
                reset_epoch();
                double window = now_s() + rejoin_timeout;
                if (window > deadline) window = deadline;
                if (dial_any(window, buf)) continue;
            }
            break;
        }
        long rc = failed ? -1 : outputs_flushed;
        aat_destroy(tp);
        return rc;
    }
};

}  // namespace

extern "C" {

// Join a master from the seed list (comma-separated "host:port" pairs;
// any seed admits a joiner) as a native worker engine over the C++ TCP
// transport; run until the master disconnects (normal shutdown — or,
// with rejoin_timeout_s > 0, cold-reset and redial through the seeds:
// master-restart failover, engine parity with protocol/remote.py
// run_worker), the sink assertion fails, or timeout. Returns outputs
// flushed (>= 0), -1 on assertion failure, -3 when no master was ever
// reachable, -2 on a bad seed list.
long aat_remote_worker_run_seeds(const char* seeds_csv, int checkpoint,
                                 int assert_multiple, double timeout_s,
                                 double rejoin_timeout_s,
                                 double hb_interval_s, int verbose) {
    if (!seeds_csv || timeout_s <= 0) return -2;
    RemoteWorker w;
    std::string csv(seeds_csv);
    size_t pos = 0;
    while (pos <= csv.size()) {
        size_t comma = csv.find(',', pos);
        std::string entry = csv.substr(
            pos, comma == std::string::npos ? std::string::npos
                                            : comma - pos);
        if (!entry.empty()) {
            size_t colon = entry.rfind(':');
            if (colon == std::string::npos || colon + 1 >= entry.size())
                return -2;
            Addr a;
            a.host = entry.substr(0, colon);
            long p = std::strtol(entry.c_str() + colon + 1, nullptr, 10);
            if (p <= 0 || p > 65535 || a.host.empty()) return -2;
            a.port = static_cast<uint32_t>(p);
            w.seeds.push_back(std::move(a));
        }
        if (comma == std::string::npos) break;
        pos = comma + 1;
    }
    if (w.seeds.empty()) return -2;
    w.checkpoint = checkpoint;
    w.assert_multiple = assert_multiple;
    w.rejoin_timeout = rejoin_timeout_s > 0 ? rejoin_timeout_s : 0.0;
    w.hb_interval = hb_interval_s > 0 ? hb_interval_s : 2.0;
    w.verbose = verbose;
    return w.run(timeout_s);
}

// Single-seed compatibility entry (no failover).
long aat_remote_worker_run(const char* master_host, int master_port,
                           int checkpoint, int assert_multiple,
                           double timeout_s, double hb_interval_s,
                           int verbose) {
    if (!master_host || master_port <= 0) return -3;
    std::string csv = std::string(master_host) + ":"
        + std::to_string(master_port);
    long rc = aat_remote_worker_run_seeds(
        csv.c_str(), checkpoint, assert_multiple, timeout_s, 0.0,
        hb_interval_s, verbose);
    return rc == -2 ? -3 : rc;
}

}  // extern "C"
