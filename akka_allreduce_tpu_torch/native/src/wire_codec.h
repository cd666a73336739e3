// Binary wire codec shared by the cross-process native engines
// (remote_worker.cpp, remote_master.cpp) — must match protocol/wire.py
// byte-for-byte (little-endian, unaligned fields, the 5-message
// allreduce protocol + Hello/Ping transport greetings).
#ifndef AAT_WIRE_CODEC_H_
#define AAT_WIRE_CODEC_H_

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace aat {

enum MsgType : uint8_t {
    kHello = 0, kInit = 1, kStart = 2, kScatter = 3, kReduce = 4,
    kComplete = 5, kPing = 6,
};

struct Addr {
    std::string host;
    uint32_t port = 0;
    bool operator==(const Addr& o) const {
        return port == o.port && host == o.host;
    }
    bool operator<(const Addr& o) const {
        return host < o.host || (host == o.host && port < o.port);
    }
};

// little-endian unaligned field readers/writers
template <typename T>
inline bool rd(const uint8_t* buf, size_t len, size_t& off, T* out) {
    if (off + sizeof(T) > len) return false;
    std::memcpy(out, buf + off, sizeof(T));
    off += sizeof(T);
    return true;
}
template <typename T>
inline void wr(std::vector<uint8_t>& out, T v) {
    size_t n = out.size();
    out.resize(n + sizeof(T));
    std::memcpy(out.data() + n, &v, sizeof(T));
}

inline bool rd_addr(const uint8_t* buf, size_t len, size_t& off,
                    Addr* a) {
    uint16_t hlen;
    if (!rd(buf, len, off, &hlen)) return false;
    if (off + hlen > len) return false;
    a->host.assign(reinterpret_cast<const char*>(buf) + off, hlen);
    off += hlen;
    return rd(buf, len, off, &a->port);
}
inline void wr_addr(std::vector<uint8_t>& out, const Addr& a) {
    wr<uint16_t>(out, static_cast<uint16_t>(a.host.size()));
    out.insert(out.end(), a.host.begin(), a.host.end());
    wr<uint32_t>(out, a.port);
}

inline std::vector<uint8_t> enc_hello(const Addr& self,
                                      const char* role) {
    std::vector<uint8_t> out;
    wr<uint8_t>(out, kHello);
    wr_addr(out, self);
    size_t rlen = std::strlen(role);
    wr<uint8_t>(out, static_cast<uint8_t>(rlen));
    out.insert(out.end(), role, role + rlen);
    return out;
}
inline std::vector<uint8_t> enc_ping(double interval) {
    std::vector<uint8_t> out;
    wr<uint8_t>(out, kPing);
    wr<double>(out, interval);
    return out;
}
inline std::vector<uint8_t> enc_scatter(int src, int dest, int chunk,
                                        int64_t round, const float* data,
                                        size_t n) {
    std::vector<uint8_t> out;
    out.reserve(1 + 4 * 3 + 8 * 2 + n * 4);
    wr<uint8_t>(out, kScatter);
    wr<int32_t>(out, src);
    wr<int32_t>(out, dest);
    wr<int32_t>(out, chunk);
    wr<int64_t>(out, round);
    wr<uint64_t>(out, n * 4);
    size_t at = out.size();
    out.resize(at + n * 4);
    std::memcpy(out.data() + at, data, n * 4);
    return out;
}
inline std::vector<uint8_t> enc_reduce(int src, int dest, int chunk,
                                       int64_t round, int64_t count,
                                       const float* data, size_t n) {
    std::vector<uint8_t> out;
    out.reserve(1 + 4 * 3 + 8 * 3 + n * 4);
    wr<uint8_t>(out, kReduce);
    wr<int32_t>(out, src);
    wr<int32_t>(out, dest);
    wr<int32_t>(out, chunk);
    wr<int64_t>(out, round);
    wr<int64_t>(out, count);
    wr<uint64_t>(out, n * 4);
    size_t at = out.size();
    out.resize(at + n * 4);
    std::memcpy(out.data() + at, data, n * 4);
    return out;
}
inline std::vector<uint8_t> enc_complete(int src, int64_t round) {
    std::vector<uint8_t> out;
    wr<uint8_t>(out, kComplete);
    wr<int32_t>(out, src);
    wr<int64_t>(out, round);
    return out;
}
inline std::vector<uint8_t> enc_start(int64_t round) {
    std::vector<uint8_t> out;
    wr<uint8_t>(out, kStart);
    wr<int64_t>(out, round);
    return out;
}

struct InitConfig {
    uint32_t worker_num = 0;
    double th_reduce = 1.0, th_complete = 1.0;
    uint32_t max_lag = 0;
    uint64_t data_size = 0, max_chunk = 1;
};

// InitWorkers: "<BiIddIQQq" header fields, optional master addr, then
// the rank->addr book (protocol/wire.py encode, sorted by rank).
inline std::vector<uint8_t> enc_init(
    int dest_id, const InitConfig& c, int64_t start_round,
    const Addr& master, const std::vector<std::pair<int, Addr>>& workers) {
    std::vector<uint8_t> out;
    wr<uint8_t>(out, kInit);
    wr<int32_t>(out, dest_id);
    wr<uint32_t>(out, c.worker_num);
    wr<double>(out, c.th_reduce);
    wr<double>(out, c.th_complete);
    wr<uint32_t>(out, c.max_lag);
    wr<uint64_t>(out, c.data_size);
    wr<uint64_t>(out, c.max_chunk);
    wr<int64_t>(out, start_round);
    wr<uint8_t>(out, 1);
    wr_addr(out, master);
    wr<uint32_t>(out, static_cast<uint32_t>(workers.size()));
    for (const auto& [rank, a] : workers) {
        wr<int32_t>(out, rank);
        wr_addr(out, a);
    }
    return out;
}

}  // namespace aat

#endif  // AAT_WIRE_CODEC_H_
