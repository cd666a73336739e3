// Native TCP message transport for the host protocol plane.
//
// The structural equivalent of the reference's Akka remoting over netty TCP
// (reference: application.conf:5-11; SURVEY.md §1 L1): a framed, FIFO
// per-connection, at-most-once byte transport. Message *semantics* (the
// 5-message allreduce protocol) live above in Python (protocol/wire.py),
// exactly as Akka's serializer sits above netty.
//
// Design: one background event-loop thread per transport, poll(2) over the
// listen socket + a self-pipe wakeup + all live connections. Frames are
// [u32 little-endian length][payload]. Inbound frames land on a locked
// queue drained by aat_recv_*; outbound frames are queued per connection
// and flushed on POLLOUT. Peer death surfaces on a disconnect queue —
// the deathwatch signal (reference: AllreduceMaster.scala:46-52).
//
// C ABI only: consumed from Python via ctypes (no pybind11 in this
// environment).

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMaxFrame = 1u << 30;  // 1 GiB sanity cap

struct Frame {
  int peer;
  std::vector<uint8_t> data;
};

struct Conn {
  int fd = -1;
  std::vector<uint8_t> inbuf;                 // partial-frame accumulation
  std::deque<std::vector<uint8_t>> outq;      // length-prefixed frames
  size_t out_off = 0;                         // bytes of outq.front() sent
};

struct Transport {
  int listen_fd = -1;
  int port = 0;
  int wake_r = -1, wake_w = -1;
  std::thread loop;
  std::mutex mu;
  std::unordered_map<int, Conn> conns;
  std::deque<Frame> inq;
  std::deque<int> disconnects;
  int next_peer = 0;
  bool stop = false;

  void wake() {
    uint8_t b = 1;
    ssize_t rc = write(wake_w, &b, 1);
    (void)rc;  // pipe full == loop already awake
  }
};

void set_nonblocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Extract complete frames from a connection's inbuf onto the inbound queue.
// Returns false on a corrupt stream (insane frame length): the caller must
// drop the connection — once desynced there is no refrainable boundary.
// Caller holds t->mu.
bool extract_frames(Transport* t, int peer, Conn& c) {
  size_t off = 0;
  bool ok = true;
  while (c.inbuf.size() - off >= 4) {
    uint32_t len;
    memcpy(&len, c.inbuf.data() + off, 4);
    if (len > kMaxFrame) {
      ok = false;
      break;
    }
    if (c.inbuf.size() - off - 4 < len) break;
    Frame f;
    f.peer = peer;
    f.data.assign(c.inbuf.begin() + off + 4,
                  c.inbuf.begin() + off + 4 + len);
    t->inq.push_back(std::move(f));
    off += 4 + len;
  }
  if (off > 0) c.inbuf.erase(c.inbuf.begin(), c.inbuf.begin() + off);
  return ok;
}

// Caller holds t->mu. Closes fd and records the disconnect.
void drop_conn(Transport* t, int peer) {
  auto it = t->conns.find(peer);
  if (it == t->conns.end()) return;
  close(it->second.fd);
  t->conns.erase(it);
  t->disconnects.push_back(peer);
}

void event_loop(Transport* t) {
  std::vector<pollfd> pfds;
  std::vector<int> peer_of;  // parallel to pfds from index 2 on
  for (;;) {
    pfds.clear();
    peer_of.clear();
    pfds.push_back({t->wake_r, POLLIN, 0});
    pfds.push_back({t->listen_fd, POLLIN, 0});
    {
      std::lock_guard<std::mutex> g(t->mu);
      if (t->stop) return;
      for (auto& [peer, c] : t->conns) {
        short ev = POLLIN;
        if (!c.outq.empty()) ev |= POLLOUT;
        pfds.push_back({c.fd, ev, 0});
        peer_of.push_back(peer);
      }
    }
    if (poll(pfds.data(), pfds.size(), 1000) < 0) {
      if (errno == EINTR) continue;
      return;
    }
    if (pfds[0].revents & POLLIN) {  // drain the wake pipe
      uint8_t buf[64];
      while (read(t->wake_r, buf, sizeof(buf)) > 0) {}
    }
    if (pfds[1].revents & POLLIN) {  // accept new peers
      for (;;) {
        int fd = accept(t->listen_fd, nullptr, nullptr);
        if (fd < 0) break;
        set_nonblocking(fd);
        set_nodelay(fd);
        std::lock_guard<std::mutex> g(t->mu);
        Conn c;
        c.fd = fd;
        t->conns.emplace(t->next_peer++, std::move(c));
      }
    }
    for (size_t i = 2; i < pfds.size(); ++i) {
      int peer = peer_of[i - 2];
      short re = pfds[i].revents;
      if (re == 0) continue;
      std::lock_guard<std::mutex> g(t->mu);
      auto it = t->conns.find(peer);
      if (it == t->conns.end()) continue;
      Conn& c = it->second;
      if (re & (POLLERR | POLLNVAL)) {
        drop_conn(t, peer);
        continue;
      }
      if (re & POLLIN) {
        bool dead = false;
        for (;;) {
          uint8_t buf[65536];
          ssize_t n = read(c.fd, buf, sizeof(buf));
          if (n > 0) {
            c.inbuf.insert(c.inbuf.end(), buf, buf + n);
          } else if (n == 0) {
            dead = true;
            break;
          } else {
            if (errno != EAGAIN && errno != EWOULDBLOCK) dead = true;
            break;
          }
        }
        if (!extract_frames(t, peer, c)) dead = true;
        if (dead) {
          drop_conn(t, peer);
          continue;
        }
      }
      if (re & POLLOUT) {
        while (!c.outq.empty()) {
          auto& front = c.outq.front();
          ssize_t n = write(c.fd, front.data() + c.out_off,
                            front.size() - c.out_off);
          if (n < 0) {
            if (errno != EAGAIN && errno != EWOULDBLOCK) drop_conn(t, peer);
            break;
          }
          c.out_off += static_cast<size_t>(n);
          if (c.out_off == front.size()) {
            c.outq.pop_front();
            c.out_off = 0;
          } else {
            break;  // kernel buffer full
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Create a transport listening on bind_host:port (port 0 = ephemeral).
// Returns nullptr on failure.
void* aat_create(const char* bind_host, int port) {
  auto* t = new Transport();
  t->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (t->listen_fd < 0) {
    delete t;
    return nullptr;
  }
  int one = 1;
  setsockopt(t->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
    close(t->listen_fd);
    delete t;
    return nullptr;
  }
  if (bind(t->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0
      || listen(t->listen_fd, 128) < 0) {
    close(t->listen_fd);
    delete t;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(t->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  t->port = ntohs(addr.sin_port);
  set_nonblocking(t->listen_fd);
  int pipefd[2];
  if (pipe(pipefd) < 0) {
    close(t->listen_fd);
    delete t;
    return nullptr;
  }
  t->wake_r = pipefd[0];
  t->wake_w = pipefd[1];
  set_nonblocking(t->wake_r);
  t->loop = std::thread(event_loop, t);
  return t;
}

int aat_port(void* tp) { return static_cast<Transport*>(tp)->port; }

// Dial a peer with a bounded wait: a dead host must not freeze the
// single-threaded protocol engine for the kernel's SYN-retry window
// (~2 min) — the engine's send path reaches here via _ensure_conn.
// Returns a peer id >= 0, or -1 on failure/timeout.
int aat_connect(void* tp, const char* host, int port, int timeout_ms) {
  auto* t = static_cast<Transport*>(tp);
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr)
    return -1;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    freeaddrinfo(res);
    return -1;
  }
  set_nonblocking(fd);
  int rc = connect(fd, res->ai_addr, res->ai_addrlen);
  freeaddrinfo(res);
  if (rc < 0) {
    // EINTR: the connect still proceeds asynchronously (POSIX) — wait for
    // it like EINPROGRESS so a stray signal can't fail a healthy dial.
    if (errno != EINPROGRESS && errno != EINTR) {
      close(fd);
      return -1;
    }
    // Deadline-based wait: an EINTR re-poll gets only the REMAINING time,
    // so periodic signals (profilers, timers) cannot extend the bound.
    timespec t0{};
    clock_gettime(CLOCK_MONOTONIC, &t0);
    int64_t deadline_ms = int64_t(t0.tv_sec) * 1000 + t0.tv_nsec / 1000000
                          + timeout_ms;
    for (;;) {
      timespec now{};
      clock_gettime(CLOCK_MONOTONIC, &now);
      int64_t remaining = deadline_ms - (int64_t(now.tv_sec) * 1000
                                         + now.tv_nsec / 1000000);
      if (remaining <= 0) {
        close(fd);
        return -1;
      }
      pollfd p{fd, POLLOUT, 0};
      int pr = poll(&p, 1, static_cast<int>(remaining));
      if (pr > 0) break;
      if (pr == 0 || errno != EINTR) {  // timeout or real poll error
        close(fd);
        return -1;
      }
    }
    int err = 0;
    socklen_t elen = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) < 0 || err != 0) {
      close(fd);
      return -1;
    }
  }
  set_nodelay(fd);
  int peer;
  {
    std::lock_guard<std::mutex> g(t->mu);
    peer = t->next_peer++;
    Conn c;
    c.fd = fd;
    t->conns.emplace(peer, std::move(c));
  }
  t->wake();
  return peer;
}

// Enqueue one frame to a peer. Returns 0, or -1 if the peer is gone.
int aat_send(void* tp, int peer, const uint8_t* buf, uint64_t len) {
  auto* t = static_cast<Transport*>(tp);
  if (len > kMaxFrame) return -1;
  std::vector<uint8_t> frame(4 + len);
  uint32_t len32 = static_cast<uint32_t>(len);
  memcpy(frame.data(), &len32, 4);
  memcpy(frame.data() + 4, buf, len);
  {
    std::lock_guard<std::mutex> g(t->mu);
    auto it = t->conns.find(peer);
    if (it == t->conns.end()) return -1;
    it->second.outq.push_back(std::move(frame));
  }
  t->wake();
  return 0;
}

// Length of the next inbound frame, or -1 if the queue is empty.
int64_t aat_recv_len(void* tp) {
  auto* t = static_cast<Transport*>(tp);
  std::lock_guard<std::mutex> g(t->mu);
  if (t->inq.empty()) return -1;
  return static_cast<int64_t>(t->inq.front().data.size());
}

// Pop the next inbound frame into buf (cap bytes). Returns the frame length,
// or -1 if empty / cap too small (frame stays queued if cap is too small).
int64_t aat_recv_take(void* tp, uint8_t* buf, uint64_t cap, int* src_peer) {
  auto* t = static_cast<Transport*>(tp);
  std::lock_guard<std::mutex> g(t->mu);
  if (t->inq.empty()) return -1;
  Frame& f = t->inq.front();
  if (f.data.size() > cap) return -1;
  memcpy(buf, f.data.data(), f.data.size());
  if (src_peer != nullptr) *src_peer = f.peer;
  int64_t n = static_cast<int64_t>(f.data.size());
  t->inq.pop_front();
  return n;
}

// Pop one dead peer id, or -1 if none.
int aat_poll_disconnect(void* tp) {
  auto* t = static_cast<Transport*>(tp);
  std::lock_guard<std::mutex> g(t->mu);
  if (t->disconnects.empty()) return -1;
  int peer = t->disconnects.front();
  t->disconnects.pop_front();
  return peer;
}

// Close one peer connection deliberately (no disconnect event for it).
void aat_close_peer(void* tp, int peer) {
  auto* t = static_cast<Transport*>(tp);
  std::lock_guard<std::mutex> g(t->mu);
  auto it = t->conns.find(peer);
  if (it == t->conns.end()) return;
  close(it->second.fd);
  t->conns.erase(it);
}

// True when every queued outbound byte for `peer` has hit the kernel.
int aat_send_drained(void* tp, int peer) {
  auto* t = static_cast<Transport*>(tp);
  std::lock_guard<std::mutex> g(t->mu);
  auto it = t->conns.find(peer);
  if (it == t->conns.end()) return 1;
  return it->second.outq.empty() ? 1 : 0;
}

int aat_num_connected(void* tp) {
  auto* t = static_cast<Transport*>(tp);
  std::lock_guard<std::mutex> g(t->mu);
  return static_cast<int>(t->conns.size());
}

void aat_destroy(void* tp) {
  auto* t = static_cast<Transport*>(tp);
  {
    std::lock_guard<std::mutex> g(t->mu);
    t->stop = true;
  }
  t->wake();
  t->loop.join();
  for (auto& [peer, c] : t->conns) close(c.fd);
  close(t->listen_fd);
  close(t->wake_r);
  close(t->wake_w);
  delete t;
}

}  // extern "C"
