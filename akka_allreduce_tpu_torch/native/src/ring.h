// maxLag-deep ring of [peer][element] staging rows with chunk counts —
// the C++ rendering of buffers/base.py (reference:
// AllReduceBuffer.scala:3-47). Shared by the in-process cluster engine
// (cluster.cpp) and the cross-process remote worker engine
// (remote_worker.cpp): one buffer implementation, two deployments.
#ifndef AAT_RING_H_
#define AAT_RING_H_

#include <cstdint>
#include <cstring>
#include <vector>

namespace aat {

struct Ring {
    int data_size = 0, peers = 0, depth = 1, chunk = 1, nchunks = 0;
    int offset = 0;
    std::vector<float> buf;       // depth * peers * data_size
    std::vector<int64_t> filled;  // depth * nchunks
    std::vector<int64_t> total;   // depth

    void init(int ds, int p, int d, int c) {
        data_size = ds; peers = p; depth = d; chunk = c;
        nchunks = ds > 0 ? (ds + c - 1) / c : 0;
        offset = 0;
        buf.assign((size_t)depth * peers * (size_t)ds, 0.f);
        filled.assign((size_t)depth * (nchunks ? nchunks : 1), 0);
        total.assign(depth, 0);
    }
    int tidx(int row) const { return (row + offset) % depth; }
    float* row_ptr(int t, int peer) {
        return buf.data() + ((size_t)t * peers + peer) * data_size;
    }
    bool store(const float* data, size_t len, int row, int src, int cid) {
        long start = (long)cid * chunk;
        if (cid < 0 || cid >= nchunks || start + (long)len > data_size ||
            src < 0 || src >= peers)
            return false;  // python raises IndexError; count NOT bumped
            // (cid bound matters independently of start: a zero-length
            // payload at cid == nchunks would index filled[] one past
            // its row — reachable from the network via remote_worker)
        int t = tidx(row);
        std::memcpy(row_ptr(t, src) + start, data, len * sizeof(float));
        filled[(size_t)t * nchunks + cid] += 1;
        total[t] += 1;
        return true;
    }
    void up() {
        offset = (offset + 1) % depth;
        int t = tidx(depth - 1);
        if (!buf.empty())  // empty-block ranks: data() may be null (UB)
            std::memset(row_ptr(t, 0), 0,
                        (size_t)peers * data_size * sizeof(float));
        std::fill(filled.begin() + (size_t)t * nchunks,
                  filled.begin() + (size_t)(t + 1) * nchunks, 0);
        total[t] = 0;
    }
};

}  // namespace aat

#endif  // AAT_RING_H_
