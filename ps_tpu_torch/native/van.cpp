// Native "van": heartbeat liveness over UDP + framed tensor messages over
// TCP.
//
// The reference family's ZMQ van carries BOTH the data plane (tensor
// push/pull) and the control plane (connect/barrier/heartbeat). On TPU the
// sync data plane is XLA collectives over ICI/DCN (SURVEY.md §3 row 9); what
// remains host-side is (a) liveness — every node beats, every node watches
// its peers, a silent peer is declared dead instead of the job hanging in a
// collective — and (b) the ASYNC data plane (SURVEY.md §4d): async workers
// are deliberately unsynchronized processes, so their grad/param exchange
// with the server process cannot ride a collective and travels as framed
// byte messages over TCP (the `tv_*` ABI below; ps_tpu/control/tensor_van.py
// does the tensor encoding). Kept native (C++, like the reference's van) so
// beat/poll latency and bulk sends are independent of the Python
// interpreter (GIL pauses during jit dispatch must not fake a death, and a
// multi-MB push must not stall the beat loops).
//
// Exposed as a C ABI for ctypes (ps_tpu/control/heartbeat.py,
// ps_tpu/control/tensor_van.py). Threading model: one receiver thread per
// heartbeat server, one sender thread per heartbeat client; TCP handles are
// plain blocking sockets driven by the caller's threads (ctypes releases
// the GIL for the duration of each call); handles are opaque pointers.

#include <arpa/inet.h>
#include <fcntl.h>
#include <limits.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <cerrno>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

struct Beat {
  uint32_t magic;    // 'PSHB' beat | 'PSGB' goodbye
  uint32_t node_id;
  uint64_t seq;
};

constexpr uint32_t kMagic = 0x50534842;    // "PSHB"
constexpr uint32_t kGoodbye = 0x50534742;  // "PSGB" — clean leave, not death

struct Server {
  int fd = -1;
  int port = 0;
  int timeout_ms = 1000;
  std::atomic<bool> stop{false};
  std::thread rx;
  std::mutex mu;  // beat table — pslint: hot-lock
  std::map<uint32_t, Clock::time_point> last_seen;
  std::map<uint32_t, uint64_t> last_seq;
  std::map<uint32_t, uint64_t> beat_addr;  // ip:port the node beats from
  std::set<uint32_t> left;  // nodes that said goodbye: never declared dead

  static uint64_t addr_key(const sockaddr_in& a) {
    return ((uint64_t)a.sin_addr.s_addr << 16) | a.sin_port;
  }

  void run() {
    Beat b;
    sockaddr_in src{};
    socklen_t slen = sizeof(src);
    while (!stop.load(std::memory_order_relaxed)) {
      slen = sizeof(src);
      ssize_t n = recvfrom(fd, &b, sizeof(b), 0, (sockaddr*)&src, &slen);
      if (n == (ssize_t)sizeof(b) &&
          (b.magic == kMagic || b.magic == kGoodbye)) {
        std::lock_guard<std::mutex> lock(mu);
        if (b.magic == kGoodbye) {
          // a goodbye permanently suppresses death detection for the node,
          // so it is only honored from the exact source address the node's
          // beats came from — a stray or forged datagram from anywhere
          // else cannot silence the detector (beats share the client fd,
          // so a genuine goodbye always matches)
          auto it = beat_addr.find(b.node_id);
          if (it == beat_addr.end() || it->second != addr_key(src)) continue;
          left.insert(b.node_id);
          last_seen[b.node_id] = Clock::now();
          continue;
        }
        last_seen[b.node_id] = Clock::now();
        last_seq[b.node_id] = b.seq;
        beat_addr[b.node_id] = addr_key(src);
      }
      // timeouts fall through so the stop flag is polled
    }
  }
};

struct Client {
  int fd = -1;
  sockaddr_in dest{};
  uint32_t node_id = 0;
  int interval_ms = 100;
  std::atomic<bool> stop{false};
  std::thread tx;

  void run() {
    Beat b{kMagic, node_id, 0};
    while (!stop.load(std::memory_order_relaxed)) {
      ++b.seq;
      sendto(fd, &b, sizeof(b), 0, (sockaddr*)&dest, sizeof(dest));
      std::this_thread::sleep_for(std::chrono::milliseconds(interval_ms));
    }
  }
};

}  // namespace

extern "C" {

// Start a heartbeat monitor bound to `bind_addr:port` (0 = ephemeral port).
// `bind_addr` is a dotted-quad IPv4 address — "0.0.0.0" accepts beats from
// any host (pod deployments), "127.0.0.1" restricts to this host (tests).
// A node is "alive" once its first beat arrives and "dead" when silent >
// timeout_ms — unless it said goodbye first (clean leave, state "left").
void* hb_server_start(const char* bind_addr, int port, int timeout_ms) {
  // no SO_REUSEADDR: a port collision must fail loudly at bind, not split
  // the beat stream between two silently-coexisting sockets
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) return nullptr;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  addr.sin_port = htons((uint16_t)port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &len);
  timeval tv{0, 100 * 1000};  // 100ms recv timeout: stop-flag poll cadence
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

  auto* s = new Server();
  s->fd = fd;
  s->port = ntohs(addr.sin_port);
  s->timeout_ms = timeout_ms;
  s->rx = std::thread([s] { s->run(); });
  return s;
}

int hb_server_port(void* h) { return static_cast<Server*>(h)->port; }

// Fill `out` (capacity `cap`) with ids in the given state; returns the count.
// state 0 = alive (beating within timeout), 1 = dead (seen, then silent
// WITHOUT a goodbye), 2 = left (sent a goodbye — clean membership change).
int hb_server_poll(void* h, int state, uint32_t* out, int cap) {
  auto* s = static_cast<Server*>(h);
  auto now = Clock::now();
  auto horizon = std::chrono::milliseconds(s->timeout_ms);
  std::lock_guard<std::mutex> lock(s->mu);
  int n = 0;
  for (const auto& kv : s->last_seen) {
    int st = s->left.count(kv.first) ? 2
             : ((now - kv.second) > horizon ? 1 : 0);
    if (st == state && n < cap) out[n++] = kv.first;
  }
  return n;
}

uint64_t hb_server_seq(void* h, uint32_t node_id) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->last_seq.find(node_id);
  return it == s->last_seq.end() ? 0 : it->second;
}

// Milliseconds since node_id's last beat (a goodbye refreshes last_seen
// too, so a just-left node ages from its goodbye); -1 = never seen. The
// coordinator's membership view (ps_tpu/elastic) and ps_top render this
// as the per-peer "beat age" column.
int64_t hb_server_age_ms(void* h, uint32_t node_id) {
  auto* s = static_cast<Server*>(h);
  auto now = Clock::now();
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->last_seen.find(node_id);
  if (it == s->last_seen.end()) return -1;
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             now - it->second)
      .count();
}

void hb_server_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  s->stop.store(true);
  if (s->rx.joinable()) s->rx.join();
  close(s->fd);
  delete s;
}

// Start beating `node_id` at `host:port` every interval_ms. `host` must be
// a dotted-quad IPv4 address (the Python wrapper resolves hostnames);
// anything else is a hard error, never a silent localhost fallback.
void* hb_client_start(const char* host, int port, uint32_t node_id,
                      int interval_ms) {
  sockaddr_in dest{};
  dest.sin_family = AF_INET;
  dest.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &dest.sin_addr) != 1) return nullptr;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  auto* c = new Client();
  c->fd = fd;
  c->node_id = node_id;
  c->interval_ms = interval_ms;
  c->dest = dest;
  c->tx = std::thread([c] { c->run(); });
  return c;
}

// Announce a clean leave: a burst of goodbye datagrams (UDP may drop some;
// any one arriving flips the peer's state to "left" permanently). Safe to
// call while the beat thread runs — concurrent sendto on one UDP fd is
// per-datagram atomic.
void hb_client_goodbye(void* h) {
  auto* c = static_cast<Client*>(h);
  Beat b{kGoodbye, c->node_id, ~0ull};
  for (int i = 0; i < 3; ++i) {
    sendto(c->fd, &b, sizeof(b), 0, (sockaddr*)&c->dest, sizeof(c->dest));
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
}

void hb_client_stop(void* h) {
  auto* c = static_cast<Client*>(h);
  c->stop.store(true);
  if (c->tx.joinable()) c->tx.join();
  close(c->fd);
  delete c;
}

// ---------------------------------------------------------------------------
// Tensor van: length-framed byte messages over TCP. A frame on the wire is
// [u64 little-endian length][length bytes]. The payload encoding (tensor
// trees) lives in Python; this layer only moves opaque frames reliably.
// All calls are blocking (ctypes releases the GIL); one connection is meant
// to be driven by one thread at a time.

namespace {

constexpr uint64_t kMaxFrame = 1ull << 34;  // 16 GiB sanity bound

bool read_exact(int fd, void* buf, uint64_t n) {
  auto* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;  // peer closed or hard error
    }
    p += r;
    n -= (uint64_t)r;
  }
  return true;
}

bool write_exact(int fd, const void* buf, uint64_t n) {
  auto* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= (uint64_t)r;
  }
  return true;
}

struct Listener {
  int fd = -1;
  int port = 0;
};

struct Conn {
  int fd = -1;
  uint64_t pending = 0;  // size of the frame body announced but not yet read
};

}  // namespace

// Listen on bind_addr:port (0 = ephemeral). Returns nullptr on failure.
void* tv_listen(const char* bind_addr, int port, int backlog) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) return nullptr;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  addr.sin_port = htons((uint16_t)port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(fd, backlog) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t len = sizeof(addr);
  getsockname(fd, (sockaddr*)&addr, &len);
  auto* l = new Listener();
  l->fd = fd;
  l->port = ntohs(addr.sin_port);
  return l;
}

int tv_listener_port(void* h) { return static_cast<Listener*>(h)->port; }

// Accept one connection; timeout_ms < 0 blocks forever; returns nullptr on
// timeout or listener close.
void* tv_accept(void* h, int timeout_ms) {
  auto* l = static_cast<Listener*>(h);
  // poll(), not SO_RCVTIMEO on the listener: some kernels/sandboxes (e.g.
  // gVisor-style runtimes) do not honor RCVTIMEO for accept(2), which
  // turned every accept-poll tick into an indefinite block (and every
  // service stop() into a full 5s thread-join timeout)
  pollfd p{l->fd, POLLIN, 0};
  int r = poll(&p, 1, timeout_ms);  // timeout_ms < 0 blocks indefinitely
  if (r <= 0 || !(p.revents & POLLIN)) return nullptr;
  int fd = accept(l->fd, nullptr, nullptr);
  if (fd < 0) return nullptr;
  // the accepted fd INHERITS the listener's SO_RCVTIMEO (the accept-poll
  // cadence) on Linux — clear it, or any >timeout idle gap between client
  // requests would surface as a spurious EAGAIN "peer closed"
  timeval off{0, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &off, sizeof(off));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Conn();
  c->fd = fd;
  return c;
}

void tv_listener_close(void* h) {
  auto* l = static_cast<Listener*>(h);
  close(l->fd);
  delete l;
}

// Connect to host:port (dotted quad; Python resolves names). nullptr on
// failure/timeout. timeout_ms bounds the CONNECT only — once connected the
// socket blocks indefinitely (a server mid-jit-compile may legitimately
// take minutes to answer; a short lingering SO_RCVTIMEO would misreport
// that as a dead peer and desync the framing).
void* tv_connect(const char* host, int port, int timeout_ms) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return nullptr;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  if (timeout_ms >= 0) {
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return nullptr;
  }
  timeval off{0, 0};  // clear the connect deadline: block forever from here
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &off, sizeof(off));
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Conn();
  c->fd = fd;
  return c;
}

// Send one frame. Returns 1 on success, 0 on a broken connection.
int tv_send(void* h, const void* buf, uint64_t n) {
  auto* c = static_cast<Conn*>(h);
  uint64_t len_le = n;  // this ABI is little-endian-host only (x86/ARM)
  if (!write_exact(c->fd, &len_le, sizeof(len_le))) return 0;
  return write_exact(c->fd, buf, n) ? 1 : 0;
}

// Send one frame gathered from `n` buffers WITHOUT any staging copy: the
// u64 length prefix plus every buffer goes out through sendmsg(2) scatter-
// gather iovecs (batched at IOV_MAX, partial writes resumed mid-iovec).
// The Python side hands live tensor memoryviews straight here — this is
// what deletes the per-frame staging bytearray of the legacy encode path.
// Returns 1 on success, 0 on a broken connection.
int tv_send_vec(void* h, const void** bufs, const uint64_t* lens, int n) {
  auto* c = static_cast<Conn*>(h);
  uint64_t total = 0;
  for (int i = 0; i < n; ++i) total += lens[i];
  uint64_t len_le = total;  // little-endian-host only, like tv_send
  std::vector<iovec> iov;
  iov.reserve((size_t)n + 1);
  iov.push_back({&len_le, sizeof(len_le)});
  for (int i = 0; i < n; ++i)
    if (lens[i]) iov.push_back({const_cast<void*>(bufs[i]), (size_t)lens[i]});
  size_t idx = 0;
  while (idx < iov.size()) {
    size_t cnt = iov.size() - idx;
    if (cnt > (size_t)IOV_MAX) cnt = (size_t)IOV_MAX;
    msghdr mh{};
    mh.msg_iov = &iov[idx];
    mh.msg_iovlen = cnt;
    ssize_t r = sendmsg(c->fd, &mh, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return 0;
    }
    while (r > 0 && idx < iov.size()) {
      if ((size_t)r >= iov[idx].iov_len) {
        r -= (ssize_t)iov[idx].iov_len;
        ++idx;
      } else {
        iov[idx].iov_base = (char*)iov[idx].iov_base + r;
        iov[idx].iov_len -= (size_t)r;
        r = 0;
      }
    }
  }
  return 1;
}

// Non-blocking (or bounded) readability probe: 1 when the next tv_recv_size
// would not block — data pending OR the peer hung up (EOF is "readable").
// The shm lane's poll loops use this to watch the TCP side for spilled
// frames and peer death without ever blocking on the socket.
int tv_poll_readable(void* h, int timeout_ms) {
  auto* c = static_cast<Conn*>(h);
  pollfd p{c->fd, POLLIN, 0};
  int r = poll(&p, 1, timeout_ms);
  return (r > 0 && (p.revents & (POLLIN | POLLHUP | POLLERR))) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Shared-memory ring primitives (ps_tpu/control/shm_lane.py). The lane's
// hot path must not run under the Python interpreter lock: ctypes releases
// the GIL for each of these calls, so frame copies run truly parallel with
// the peer thread (the same-process worker+server topology of every test
// and bench here) and the cursor waits burn no interpreter time at all.
// Cursors are published with release stores and read with acquire loads —
// the cross-process ordering contract the pure-Python seqlock could only
// approximate on TSO hardware.

// memcpy with the GIL released (ctypes drops it for the call's duration).
// pslint: hot-path
void tv_memcpy(void* dst, const void* src, uint64_t n) {
  memcpy(dst, src, n);
}

// Fault a fresh mapping in NOW (GIL-free), at negotiation time. mode 1:
// zero-fill (creator — allocates the backing pages); mode 2: rewrite one
// byte per page in place (attacher — maps the existing pages WITH write
// access; only safe while no traffic flows, i.e. during negotiation);
// mode 0: read-touch only. Without this, every first pass around a ring
// pays a page fault per 4 KiB — an order of magnitude over the copy
// itself on sandboxed kernels.
// pslint: hot-path
void tv_prefault(void* addr, uint64_t n, int mode) {
  if (mode == 1) {
    memset(addr, 0, n);
    return;
  }
  auto* p = static_cast<volatile char*>(addr);
  if (mode == 2) {
    for (uint64_t i = 0; i < n; i += 4096) p[i] = p[i];
    return;
  }
  uint64_t sum = 0;
  for (uint64_t i = 0; i < n; i += 4096) sum += (uint64_t)p[i];
  (void)sum;
}

// pslint: hot-path
uint64_t tv_load_u64(const void* addr) {
  return reinterpret_cast<const std::atomic<uint64_t>*>(addr)->load(
      std::memory_order_acquire);
}

// pslint: hot-path
void tv_store_u64(void* addr, uint64_t v) {
  reinterpret_cast<std::atomic<uint64_t>*>(addr)->store(
      v, std::memory_order_release);
}

// Futex-free adaptive wait until *addr != last or ~timeout_us elapses,
// in three phases tuned for hostile (sandboxed) kernels as much as bare
// metal: (1) a brief hot spin catches back-to-back traffic for free;
// (2) a yield-spin — check + sched_yield — carries the typical multi-MB
// frame latency (~ms) with wakeup granularity of one yield (µs..tens of
// µs under gVisor-style sandboxes) while handing the core to the peer's
// copy; (3) nanosleeps from 0.5 ms doubling to 2 ms, because sleep is
// the only phase that is truly free and some sandbox kernels round every
// nanosleep up to ~0.5 ms anyway — idle connections decay here and cost
// ~nothing. Returns 1 (changed in a spin phase), 2 (changed after
// sleeping), 0 (timeout — the caller re-checks its closed/peer-death
// conditions and calls again). GIL-free throughout (ctypes).
// `skip_spin`: nonzero jumps straight to the sleep phase — the caller
// passes it after a previous slice already timed out, so long-idle
// connections pay sleeps only, never re-burning the spin phases.
// pslint: hot-path
int tv_wait_u64(const void* addr, uint64_t last, int timeout_us,
                int skip_spin) {
  auto* p = reinterpret_cast<const std::atomic<uint64_t>*>(addr);
  auto start = Clock::now();
  auto deadline = start + std::chrono::microseconds(timeout_us);
  if (!skip_spin) {
    for (int i = 0; i < 512; ++i)
      if (p->load(std::memory_order_acquire) != last) return 1;
    auto yield_until =
        std::min(deadline, start + std::chrono::microseconds(3000));
    while (Clock::now() < yield_until) {
      if (p->load(std::memory_order_acquire) != last) return 1;
      std::this_thread::yield();
    }
  }
  int64_t ns = 500 * 1000;
  while (true) {
    if (p->load(std::memory_order_acquire) != last) return 2;
    if (Clock::now() >= deadline) return 0;
    std::this_thread::sleep_for(std::chrono::nanoseconds(ns));
    ns = std::min<int64_t>(ns * 2, 2 * 1000 * 1000);
  }
}

// Read the next frame's size (blocking). Returns -1 on EOF/error, -2 on an
// insane frame. The body MUST then be drained with tv_recv_into.
int64_t tv_recv_size(void* h) {
  auto* c = static_cast<Conn*>(h);
  uint64_t n = 0;
  if (!read_exact(c->fd, &n, sizeof(n))) return -1;
  if (n > kMaxFrame) return -2;
  c->pending = n;
  return (int64_t)n;
}

// Read exactly n bytes of the announced frame body into buf. 1 on success.
int tv_recv_into(void* h, void* buf, uint64_t n) {
  auto* c = static_cast<Conn*>(h);
  if (n > c->pending) return 0;
  if (!read_exact(c->fd, buf, n)) return 0;
  c->pending -= n;
  return 1;
}

// Sever the connection WITHOUT freeing the handle: any thread blocked in
// tv_recv_size/tv_recv_into on this conn wakes with EOF and can run its own
// tv_close. This is how a server interrupts serve threads that block
// indefinitely on idle clients (the fd outlives the shutdown; only tv_close
// frees).
void tv_shutdown(void* h) {
  auto* c = static_cast<Conn*>(h);
  shutdown(c->fd, SHUT_RDWR);
}

void tv_close(void* h) {
  auto* c = static_cast<Conn*>(h);
  shutdown(c->fd, SHUT_RDWR);
  close(c->fd);
  delete c;
}

// Wrap an already-connected fd (e.g. one detached from the event loop
// below) as a blocking Conn handle the Channel wrapper can drive.
void* tv_adopt_fd(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl >= 0) fcntl(fd, F_SETFL, fl & ~O_NONBLOCK);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Conn();
  c->fd = fd;
  return c;
}

// ---------------------------------------------------------------------------
// Native epoll event loop ("nl_*"): the server-side serve/pump hot loop for
// N connections on a small fixed pool of native threads — accept, frame
// reads, and scatter-gather reply writes all run here with the Python
// interpreter entirely out of the picture. Python's part shrinks to ONE
// pump thread calling nl_poll (GIL released), which hands back a BATCH of
// complete request frames; the pump decodes/dispatches each and answers
// with nl_reply_vec (immediate non-blocking writev of the live reply
// tensors; any unsent tail is buffered and dribbled out by the loop on
// EPOLLOUT). Per-connection cost is one ~200-byte struct + one epoll
// registration instead of a Python thread + stack — the thing that keeps
// per-connection overhead flat to 64+ workers.
//
// Threading model: `nthreads` loop threads, each owning a private epoll
// set; connections are assigned round-robin at accept and are only read /
// destroyed by their owner thread. Cross-thread work arrives either as a
// queued command (run by the owner between epoll_wait batches) or through
// the per-connection write mutex (nl_reply_vec runs on the Python pump
// thread). Lock order: loop table mutex -> per-conn write mutex; the
// ready queue has its own mutex. Request bodies are malloc'd per frame
// and owned by Python from nl_poll until nl_body_free.

namespace {

constexpr uint32_t kNlMaxOutstanding = 1024;  // queued frames per conn
// before the peer is declared abusive (every in-tree client is
// request/reply per connection, so the real depth is 1..window)
constexpr uint64_t kNlMaxWbufBacklog = 64ull << 20;  // staged-reply
// BACKLOG bound per conn: one reply of any size may stage its unsent
// tail, but a pipelining peer that stops READING does not get further
// replies copied behind it without limit — the threaded path's blocking
// send bounded this to one in-flight reply; here the bound is explicit

struct NlThread;

// ---------------------------------------------------------------------------
// In-loop telemetry: per-stripe log2-bucket histograms + counters. The hot
// path (loop threads reading frames, the pump claiming them) only ever does
// relaxed atomic increments into its OWN stripe — no locks, no allocation —
// and nl_hist_snapshot aggregates across stripes on read. The bucket
// geometry is an exact mirror of ps_tpu/obs/metrics.Histogram's defaults
// (lo=1e-6 s, hi=3600 s, 4 sub-buckets per octave), so a snapshot's raw
// buckets merge LOSSLESSLY into the Python registry and the coordinator's
// pooled-sample fleet quantiles (state_add) with no re-bucketing.

constexpr int kNlHistSub = 4;       // sub-buckets per octave (2^(1/4))
constexpr int kNlHistNb = 127;      // ceil(log2(3600 / 1e-6) * kNlHistSub)
constexpr int kNlHistBuckets = kNlHistNb + 2;  // + underflow + overflow
constexpr double kNlHistLo = 1e-6;  // seconds (1 ns..1 µs = underflow bin)
constexpr int kNlHistCount = 4;
// nl_hist_snapshot `which` indices (ctypes mirrors these by position)
constexpr int kNlHistReadFrame = 0;  // first byte -> frame complete
constexpr int kNlHistQueueWait = 1;  // frame complete -> claimed by pump
constexpr int kNlHistReadHit = 2;    // frame complete -> cache reply written
constexpr int kNlHistFlush = 3;      // tail staged -> EPOLLOUT drain done

struct NlHist {
  std::atomic<uint64_t> counts[kNlHistBuckets]{};
  std::atomic<uint64_t> total{0}, sum_ns{0};
  std::atomic<uint64_t> min_ns{~0ull}, max_ns{0};
};

struct NlStripe {
  NlHist hist[kNlHistCount];
};

// Slow-frame flight capture: a frame whose in-loop latency crossed the
// configured threshold leaves a bounded ring entry (kind byte, size, conn,
// per-stage timings, and the request's propagated trace context when the
// frame's meta carries one) for the Python pump to drain into a
// `slow_frame` flight event + a reconstructed span.
constexpr size_t kNlSlowRing = 256;
constexpr int kNlTidLen = 20;  // 16-hex id + NUL, padded to 8-byte multiple

struct NlSlowFrame {
  uint64_t conn = 0, size = 0;
  uint32_t kind = 0;
  uint64_t read_ns = 0, wait_ns = 0, serve_ns = 0;
  uint64_t mono_ns = 0;  // steady-clock stamp at record time
  char trace[kNlTidLen] = {0};
  char span[kNlTidLen] = {0};
};

// pslint: hot-path
uint64_t nl_now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             Clock::now().time_since_epoch())
      .count();
}

// One sample into one stripe's histogram: the same bucket formula as
// obs.metrics.Histogram.record (floor(log2(v/lo) * SUB) + 1, edge bins at
// 0 and nb+1), relaxed atomics only.
// pslint: hot-path
void nl_hist_add(NlHist& h, uint64_t ns) {
  double v = (double)ns * 1e-9;
  int k;
  if (v < kNlHistLo) {
    k = 0;
  } else {
    k = (int)(std::log2(v / kNlHistLo) * kNlHistSub) + 1;
    if (k < 1) k = 1;
    if (k > kNlHistNb) k = kNlHistNb + 1;
  }
  h.counts[k].fetch_add(1, std::memory_order_relaxed);
  h.total.fetch_add(1, std::memory_order_relaxed);
  h.sum_ns.fetch_add(ns, std::memory_order_relaxed);
  uint64_t cur = h.max_ns.load(std::memory_order_relaxed);
  while (ns > cur &&
         !h.max_ns.compare_exchange_weak(cur, ns,
                                         std::memory_order_relaxed)) {
  }
  cur = h.min_ns.load(std::memory_order_relaxed);
  while (ns < cur &&
         !h.min_ns.compare_exchange_weak(cur, ns,
                                         std::memory_order_relaxed)) {
  }
}

// Best-effort trace-context sniff over a complete frame body. The body
// layout is [u8 kind][u32 worker][u64 meta_len][json meta][raw buffers]
// (ps_tpu/control/tensor_van.py); a propagated context is the meta's
// `"tc": ["<trace>", "<span>"]` entry (json.dumps spacing, but tolerant
// of none). Scan is bounded to the meta region (capped at 4 KiB — in-tree
// encoders put `tc` in the first few hundred bytes), copies at most 16 hex
// chars per id, and never allocates — it only runs for frames ALREADY
// classified slow, never on the ordinary path.
void nl_extract_tc(const char* body, uint64_t len, char* trace, char* span) {
  trace[0] = span[0] = 0;
  if (body == nullptr || len < 13) return;
  uint64_t mlen;
  memcpy(&mlen, body + 5, 8);
  if (mlen > len - 13) return;
  uint64_t scan = mlen > 4096 ? 4096 : mlen;
  const char* meta = body + 13;
  static const char kKey[] = "\"tc\":";
  const uint64_t klen = sizeof(kKey) - 1;
  if (scan < klen) return;
  uint64_t i = 0;
  bool found = false;
  for (; i + klen <= scan; ++i) {  // <=: the last valid start offset is
    if (memcmp(meta + i, kKey, klen) == 0) {  // scan - klen inclusive
      found = true;
      break;
    }
  }
  if (!found) return;
  i += klen;
  char* out[2] = {trace, span};
  int which = 0;
  for (; i < scan && which < 2; ++i) {
    if (meta[i] != '"') continue;
    ++i;  // inside the string
    int n = 0;
    while (i < scan && meta[i] != '"' && n < kNlTidLen - 1)
      out[which][n++] = meta[i++];
    out[which][n] = 0;
    ++which;
  }
  if (which < 2) span[0] = 0;  // torn scan: never emit half a context
}

struct NlConn {
  int fd = -1;
  uint64_t id = 0;
  int owner = 0;  // loop-thread index
  // read state: owner thread only
  uint8_t lenbuf[8];
  int lenoff = 0;
  char* body = nullptr;  // frame body mid-read
  uint64_t body_len = 0, body_off = 0;
  uint64_t t_frame_ns = 0;  // first byte of the current frame (owner only)
  uint64_t t_stall_ns = 0;  // tail staged, not yet drained (guarded by wmu)
  bool dead = false;  // removed from the table; freed at iteration end
  // write state: guarded by wmu (pump thread replies, owner flushes)
  std::mutex wmu;
  std::string wbuf;  // unsent reply tail (only populated when the
  size_t woff = 0;   // immediate non-blocking writev could not finish)
  uint32_t outstanding = 0;  // frames queued/claimed, reply not yet sent
  uint32_t pins = 0;  // repliers inside the conn (guarded by loop tmu):
  // nl_reply_vec pins under a BRIEF table lock, writes under wmu only,
  // unpins; destroy waits for 0 — so a multi-MB reply memcpy never
  // serializes accepts/destroys/other replies behind the global table
  bool want_write = false;   // EPOLLOUT armed
  bool close_after = false;  // goodbye: destroy once the tail drains
  int prio = 0;  // drain priority of the staged tail (guarded by wmu):
  // lowest flushes first when several conns await EPOLLOUT service in
  // one epoll batch — bucket replies carry their bucket index, so the
  // front-of-model bytes a worker's next step needs leave first
};

struct NlReq {
  uint64_t conn_id;
  char* body;
  uint64_t len;
  uint64_t read_ns;    // first byte -> frame complete (0 = stats off)
  uint64_t ready_ns;   // frame-complete stamp for the queue-wait measure
  uint64_t admit_gen;  // native admission stamp (0 = not classified):
  // admit_floor + 1 captured when the owner thread classified this PUSH
  // frame fresh — Python skips its per-key dedup scan only while its
  // _read_gen still equals stamp - 1 (no apply landed in between)
};

struct NlThread {
  int epfd = -1;
  int evfd = -1;
  int idx = 0;  // this thread's stripe index (set once at nl_start)
  std::thread th;
  std::mutex cmu;
  std::vector<std::function<void(NlThread&)>> cmds;
  std::vector<NlConn*> graveyard;  // owner-thread only (and nl_stop)
};

// One native read-cache entry: a verbatim request body (exact-match key —
// byte-identical READ frames share one entry, and a hash collision can
// never serve the wrong reply) mapped to a ready-to-send reply buffer
// (u64 length prefix already prepended). Entries are immutable after
// construction and held by shared_ptr, so a hit can serve from one while
// an invalidation drops the table's reference concurrently.
struct NlCacheEntry {
  std::string key;    // full request body bytes
  std::string reply;  // [u64 le length][reply frame bytes]
  uint64_t gen = 0;   // publish generation (see cache_floor)
  // per-key invalidation tags (sorted): opaque u64s naming the state this
  // reply covers (the sparse service hashes each (table, row id) of the
  // cached id-set). An EMPTY set means "no claim" — such entries drop on
  // every tagged invalidation, so dense whole-tree replies and over-cap
  // id-sets stay exactly as conservative as before.
  std::vector<uint64_t> tags;
  // conditional-read entries (nl_cache_put_cond): the key is the request
  // body with the "cond" version DIGITS EXCISED, so readers at different
  // known versions share one entry; vfloor is the server version the
  // cached NOT_MODIFIED reply stamps — a sniffed request version v
  // serves iff v >= vfloor (the exact comparison the pump would make,
  // and entry liveness under invalidation-on-apply proves the state the
  // floor was taken against is still current).
  bool cond = false;
  uint64_t vfloor = 0;
};

//: bounded tail window of the meta region the push-token sniff walks
//: (the token lives in `extra`, the LAST top-level meta key)
constexpr uint64_t kNlAdmitScan = 4096;
//: longest worker push nonce the native ledger mirrors (in-tree nonces
//: are short uuid hex; anything longer punts to the pump)
constexpr int kNlAdmitNonceMax = 96;

// One worker's native push-admission ledger mirror: the engine's settled
// dedup bounds for the worker's CURRENT nonce. `lo` = every key the
// worker pushes is settled at seq <= lo (a frame with pseq <= lo is a
// PURE replay, ackable from the template alone); `hi` = no recorded OR
// stamped-fresh seq exceeds hi (a frame with pseq > hi is FRESH — the
// serve advances hi immediately, so a racing duplicate of the same seq
// punts to the pump instead of also stamping fresh). Python publishes an
// entry only when the worker's ledger is EXACT (one uniform nonce across
// every key); everything else punts.
struct NlAdmitEntry {
  std::string nonce;
  uint64_t lo = 0;
  uint64_t hi = 0;
};

struct NlLoop {
  Listener* listener = nullptr;  // borrowed: Python closes it after nl_stop
  std::atomic<bool> stop{false};
  std::atomic<bool> accepting{true};
  int nthreads = 1;
  std::deque<NlThread> threads;  // deque: NlThread is not movable
  // pslint: lock-order: tmu -> wmu
  std::mutex tmu;                // conn table — pslint: hot-lock
  std::condition_variable pin_cv;  // destroy/detach wait out repliers
  std::map<uint64_t, NlConn*> conns;
  uint64_t next_id = 1;
  uint64_t rr = 0;
  std::mutex qmu;  // ready queue — pslint: hot-lock
  std::condition_variable qcv;
  std::deque<NlReq> ready;
  std::atomic<uint64_t> iters{0}, accepted{0}, requests{0};
  std::atomic<uint64_t> popped{0}, freed{0};
  // Native read cache (the zero-upcall pull path, README "Read path"):
  // committed-state reply buffers published by Python (nl_cache_put on a
  // READ miss), answered entirely inside the loop threads on a hit — no
  // GIL, no upcall, no Python. cachemu is a LEAF lock: taken alone to
  // look up / mutate the table, always released before the per-conn wmu
  // write — never nested with tmu/qmu/wmu, so it adds no lock-order
  // edges. cache_floor is the invalidation generation: Python bumps it
  // on every committed apply (nl_cache_invalidate), and a put whose gen
  // predates the floor is refused — the race where a snapshot taken
  // before an apply is published after it can therefore never park a
  // stale reply in the cache.
  std::mutex cachemu;
  std::map<uint64_t, std::vector<std::shared_ptr<NlCacheEntry>>> cache;
  std::deque<std::shared_ptr<NlCacheEntry>> cache_fifo;  // eviction order
  uint64_t cache_floor = 0;
  uint64_t cache_bytes = 0;
  uint64_t cache_limit = 0;  // 0 = cache disabled
  // first body byte marking a cacheable frame; atomic so the read hot
  // path can gate on it without touching cachemu for ordinary frames
  std::atomic<int> cache_kind{-1};
  std::atomic<uint64_t> cache_hits{0}, cache_miss{0}, cache_puts{0},
      cache_rejects{0}, cache_invals{0};
  // conditional-read hits: the subset of cache_hits answered from a
  // version-floor entry (a NOT_MODIFIED revalidation served natively)
  std::atomic<uint64_t> cache_cond_hits{0};
  // in-loop telemetry (see the NlHist block above): one stripe per loop
  // thread plus one shared by the pump/punted callers (index nthreads).
  // stats_on/slow_ns are read per frame with relaxed loads — toggling
  // costs the hot path one branch.
  std::unique_ptr<NlStripe[]> stripes;
  std::atomic<int> stats_on{1};
  std::atomic<uint64_t> slow_ns{0};  // 0 = slow-frame watchdog off
  // staged-reply tail accounting (updated under each conn's wmu; atomics
  // so nl_stats_snapshot reads them without touching any conn lock)
  std::atomic<uint64_t> tail_staged{0};   // cumulative bytes ever staged
  std::atomic<uint64_t> tail_backlog{0};  // staged minus drained/dropped
  std::atomic<uint64_t> tail_flushes{0};  // tails drained to empty
  // slow-frame ring. slowmu is a LEAF lock (nothing else is ever taken
  // under it) and is only touched for frames already past the threshold,
  // so it is deliberately NOT a hot lock.
  std::mutex slowmu;
  std::deque<NlSlowFrame> slow_ring;
  std::atomic<uint64_t> slow_total{0}, slow_dropped{0};
  // Native push admission (the zero-upcall push plane, README "Push
  // path"): Python mirrors each worker's dedup ledger here so the owner
  // thread can classify an arriving PUSH frame without an upcall — pure
  // replays are acked from `admit_ack` (the byte-exact OK the pump
  // would produce, worker id patched in per serve), role refusals from
  // `admit_refusal` (armed only while this shard must refuse pushes:
  // backup role, fenced zombie), and fresh frames are STAMPED with
  // admit_floor + 1 and queued as usual. admitmu is a LEAF lock like
  // cachemu: taken alone for the ledger/template touch, always released
  // before the per-conn wmu write — never nested with tmu/qmu/wmu, so
  // it adds no lock-order edges. admit_floor is the same invalidation
  // generation the read cache uses: every committed apply raises it
  // (nl_admit_invalidate), a publish below it is refused, and Python
  // trusts a fresh stamp only while the floor it was taken at is still
  // current — so a pre-apply classification can never ack (or skip the
  // dedup scan for) a post-apply replay.
  std::mutex admitmu;  // pslint: hot-lock
  std::map<uint32_t, NlAdmitEntry> admit;
  std::string admit_ack;      // [u64 le length][reply frame], or empty
  std::string admit_refusal;  // same shape; armed = non-empty
  uint64_t admit_floor = 0;
  // first body byte marking an admissible frame; atomic so the read hot
  // path gates on it without touching admitmu (mirrors cache_kind)
  std::atomic<int> admit_kind{-1};
  std::atomic<uint64_t> admit_acks{0}, admit_refusals{0};
  std::atomic<uint64_t> admit_fresh{0}, admit_punts{0};
};

uint64_t nl_cache_hash(const char* p, uint64_t n) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a 64
  for (uint64_t i = 0; i < n; ++i) {
    h ^= (uint8_t)p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// Drop one entry from the table + fifo (cachemu held). `e` is BY VALUE
// on purpose: a caller may hand in a reference aliasing the very vector
// slot erased below — the copy keeps the entry alive for the fifo scan
// and the byte accounting after that slot is destroyed.
void nl_cache_erase(NlLoop* l, std::shared_ptr<NlCacheEntry> e,
                    uint64_t hv) {
  auto it = l->cache.find(hv);
  if (it != l->cache.end()) {
    auto& v = it->second;
    for (size_t i = 0; i < v.size(); ++i) {
      if (v[i] == e) {
        v.erase(v.begin() + i);
        break;
      }
    }
    if (v.empty()) l->cache.erase(it);
  }
  for (size_t i = 0; i < l->cache_fifo.size(); ++i) {
    if (l->cache_fifo[i] == e) {
      l->cache_fifo.erase(l->cache_fifo.begin() + i);
      break;
    }
  }
  l->cache_bytes -= e->key.size() + e->reply.size();
}

void nl_wake(NlThread& t) {
  uint64_t one = 1;
  ssize_t r = write(t.evfd, &one, sizeof(one));
  (void)r;
}

// Record one over-threshold frame into the bounded slow ring. Only called
// for frames already classified slow, so the leaf mutex + the bounded tc
// scan cost nothing on the ordinary path. Oldest entries are overwritten
// (counted) when the pump falls behind.
void nl_slow_record(NlLoop* l, uint64_t conn, const char* body,
                    uint64_t len, uint64_t read_ns, uint64_t wait_ns,
                    uint64_t serve_ns) {
  NlSlowFrame f;
  f.conn = conn;
  f.size = len;
  f.kind = len ? (uint8_t)body[0] : 0;
  f.read_ns = read_ns;
  f.wait_ns = wait_ns;
  f.serve_ns = serve_ns;
  f.mono_ns = nl_now_ns();
  nl_extract_tc(body, len, f.trace, f.span);
  std::lock_guard<std::mutex> lock(l->slowmu);
  if (l->slow_ring.size() >= kNlSlowRing) {
    l->slow_ring.pop_front();
    l->slow_dropped.fetch_add(1, std::memory_order_relaxed);
  }
  l->slow_ring.push_back(f);
  l->slow_total.fetch_add(1, std::memory_order_relaxed);
}

// Tail staged into a conn's write buffer (wmu held by the caller): account
// the backlog and stamp the stall start when the tail opens.
void nl_tail_staged(NlLoop* l, NlConn* c, uint64_t nbytes,
                    bool was_empty) {
  l->tail_staged.fetch_add(nbytes, std::memory_order_relaxed);
  l->tail_backlog.fetch_add(nbytes, std::memory_order_relaxed);
  if (was_empty) c->t_stall_ns = nl_now_ns();
}

// Owner thread (or nl_stop after join): unlink + free one connection.
// pslint: owns: body -- c->body here is a MID-READ frame that was never
// queued (queued frames move their pointer into the ready queue and
// null c->body), so no ownership ever transferred to Python
void nl_destroy(NlLoop* l, NlThread& t, NlConn* c) {
  {
    std::unique_lock<std::mutex> lock(l->tmu);
    l->conns.erase(c->id);  // erased first: no NEW pin can be taken
    while (c->pins > 0) l->pin_cv.wait(lock);  // a replier mid-write
    // still holds live pointers into the struct and its fd
  }
  {
    // pins are drained and the conn left the table, so the write state is
    // quiescent: any unflushed tail dies with the conn — return it to the
    // backlog gauge so the fleet view never reports ghost bytes
    std::lock_guard<std::mutex> wl(c->wmu);
    if (c->wbuf.size() > c->woff)
      l->tail_backlog.fetch_sub(c->wbuf.size() - c->woff,
                                std::memory_order_relaxed);
    c->woff = c->wbuf.size();
  }
  epoll_ctl(t.epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  free(c->body);
  c->body = nullptr;
  c->dead = true;
  t.graveyard.push_back(c);  // freed at iteration end: events already
  // fetched in this batch may still point at the struct
}

// Owner thread: write one ready-made reply (length prefix included) to
// c under the per-conn wmu only — the shared tail of the native serve
// paths (read-cache hits and push-admission acks/refusals; the caller's
// table lock — cachemu or admitmu — is already released, since a
// multi-KB reply send must not serialize other lookups/puts; same
// ordering discipline as nl_reply_vec's staged-tail path). Returns
// false ONLY for the pipelining punt: a peer with earlier frames still
// queued at the pump would see its replies reordered — per-connection
// reply order is part of the framed request/reply contract, so such a
// frame must take the pump path behind them. (In-tree clients are
// strict request/reply, so that branch costs real workloads nothing;
// the decrement in nl_reply_vec happens under this same wmu and writes
// under the same hold, so outstanding == 0 here proves every prior
// reply is fully written or staged ahead of us in wbuf.) True =
// handled: written, staged for EPOLLOUT, or severed as protocol abuse.
bool nl_serve_bytes(NlLoop* l, NlThread& t, NlConn* c, const char* data,
                    size_t len) {
  std::lock_guard<std::mutex> wl(c->wmu);
  if (c->outstanding != 0) return false;
  if (!c->wbuf.empty() && c->wbuf.size() - c->woff > kNlMaxWbufBacklog) {
    // pipelining peer stopped reading: bound server memory (same
    // protocol-abuse sever as nl_reply_vec)
    shutdown(c->fd, SHUT_RDWR);
    return true;
  }
  // a native reply is front-of-model-critical serving traffic: priority
  // 0 (the min rule matches nl_reply_vec — a staged tail keeps its most
  // urgent frame's priority)
  c->prio = c->wbuf.empty() ? 0 : std::min(c->prio, 0);
  if (c->wbuf.empty()) {
    size_t off = 0;
    while (off < len) {
      ssize_t r = send(c->fd, data + off, len - off,
                       MSG_DONTWAIT | MSG_NOSIGNAL);
      if (r < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        shutdown(c->fd, SHUT_RDWR);  // owner reaps on the EOF event
        return true;
      }
      off += (size_t)r;
    }
    if (off < len) {
      nl_tail_staged(l, c, len - off, true);
      c->wbuf.append(data + off, len - off);
    }
  } else {
    // a tail is already staged: whole frames append behind it in order
    nl_tail_staged(l, c, len, false);
    c->wbuf.append(data, len);
  }
  if (!c->wbuf.empty() && !c->want_write) {
    c->want_write = true;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.ptr = c;
    epoll_ctl(t.epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
  return true;
}

// Bounded token sniff for conditional READ frames: extract the caller's
// known version (`"cond": <int>`) from the meta region without a JSON
// parser — the same discipline as nl_admit_token below. The token lives
// in `extra`, the LAST top-level meta region by the encoder contract,
// and the encoders place "cond" LAST within extra, so the scan walks a
// bounded TAIL window and takes the LAST occurrence (the sparse
// per-table `"conds":` map cannot shadow it: its quoted key does not
// match the `"cond":` literal). On success fills *v with the version
// and *dlo/*dhi with the digit run's [start, end) BODY offsets — the
// range both the serve-side lookup and the publish-side key excise, so
// readers at different known versions share one spliced cache key.
// Returns 0 when the frame carries no parseable token: the caller
// treats the frame as unconditional (exact-match semantics only).
int nl_cond_token(const char* body, uint64_t len, uint64_t* v,
                  uint64_t* dlo, uint64_t* dhi) {
  if (body == nullptr || len < 13) return 0;
  uint64_t mlen;
  memcpy(&mlen, body + 5, 8);
  if (mlen > len - 13) return 0;
  const char* meta = body + 13;
  uint64_t lo = mlen > kNlAdmitScan ? mlen - kNlAdmitScan : 0;
  static const char kCond[] = "\"cond\":";
  const int64_t cl = (int64_t)sizeof(kCond) - 1;
  int64_t ci = -1;
  for (int64_t i = (int64_t)mlen - cl; i >= (int64_t)lo; --i) {
    if (memcmp(meta + i, kCond, (size_t)cl) == 0) {
      ci = i;
      break;
    }
  }
  if (ci < 0) return 0;
  uint64_t i = (uint64_t)(ci + cl);
  while (i < mlen && meta[i] == ' ') ++i;
  uint64_t dstart = i;
  if (i >= mlen || meta[i] < '0' || meta[i] > '9') return 0;
  uint64_t val = 0;
  for (; i < mlen && meta[i] >= '0' && meta[i] <= '9'; ++i) {
    if (val > (~0ull - 9) / 10) return 0;  // implausible: not a token
    val = val * 10 + (uint64_t)(meta[i] - '0');
  }
  *v = val;
  *dlo = 13 + dstart;  // body offsets (13-byte header + meta offset)
  *dhi = 13 + i;
  return 1;
}

// Owner thread: answer one cacheable frame from the native read cache.
// Returns true when the frame was SERVED (reply written or staged — the
// caller frees the body and moves on); false = miss, queue it to Python
// as usual (the strict fallback: anything the cache cannot answer takes
// the pump path, so replies are bitwise identical by construction — the
// cache only ever echoes buffers Python published). Two lookup shapes:
// exact byte match (unconditional frames, and conditional repeats at
// the very same known version), then — for frames carrying a "cond"
// token — the version-floor path: the token's digits are excised from
// the body and the spliced key looked up among conditional entries; a
// sniffed version v at or above the entry's vfloor gets the cached
// NOT_MODIFIED reply, byte-identical to what the pump would produce
// (same comparison, and entry liveness proves the state unchanged).
bool nl_cache_serve(NlLoop* l, NlThread& t, NlConn* c) {
  std::shared_ptr<NlCacheEntry> e;
  bool cond_hit = false;
  {
    std::lock_guard<std::mutex> lock(l->cachemu);
    if (!l->cache_limit) return false;
    uint64_t hv = nl_cache_hash(c->body, c->body_len);
    auto it = l->cache.find(hv);
    if (it != l->cache.end()) {
      for (auto& cand : it->second) {
        if (!cand->cond && cand->key.size() == c->body_len &&
            memcmp(cand->key.data(), c->body, c->body_len) == 0) {
          e = cand;
          break;
        }
      }
    }
    if (!e) {
      uint64_t v = 0, dlo = 0, dhi = 0;
      if (nl_cond_token(c->body, c->body_len, &v, &dlo, &dhi)) {
        std::string spliced;
        spliced.reserve(c->body_len - (dhi - dlo));
        spliced.append(c->body, dlo);
        spliced.append(c->body + dhi, c->body_len - dhi);
        uint64_t hv2 = nl_cache_hash(spliced.data(), spliced.size());
        auto it2 = l->cache.find(hv2);
        if (it2 != l->cache.end()) {
          for (auto& cand : it2->second) {
            if (cand->cond && cand->key.size() == spliced.size() &&
                memcmp(cand->key.data(), spliced.data(),
                       spliced.size()) == 0 &&
                v >= cand->vfloor) {
              e = cand;
              cond_hit = true;
              break;
            }
          }
        }
      }
    }
    if (!e) {
      l->cache_miss.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
  }
  if (!nl_serve_bytes(l, t, c, e->reply.data(), e->reply.size())) {
    // pipelining punt (see nl_serve_bytes): the pump answers it
    l->cache_miss.fetch_add(1, std::memory_order_relaxed);
    return false;
  }
  l->cache_hits.fetch_add(1, std::memory_order_relaxed);
  if (cond_hit)
    l->cache_cond_hits.fetch_add(1, std::memory_order_relaxed);
  return true;
}

// Bounded token sniff for admissible PUSH-kind frames: extract the
// worker's dedup token (`"pseq": <int>`, `"pnonce": "<str>"`) from the
// meta region without a JSON parser — the same discipline as
// nl_extract_tc. The token lives in `extra`, the LAST top-level meta
// key by the encoder contract, so the scan walks a bounded TAIL window
// of the meta and takes the LAST occurrence of each key (a tensor name
// embedding the literal text cannot shadow the real token). Returns the
// nonce length (> 0) with *pseq filled, or 0 when the frame carries no
// parseable token — the caller punts: the pump's full JSON decode is
// the oracle for every frame this scan cannot classify.
int nl_admit_token(const char* body, uint64_t len, uint64_t* pseq,
                   char* nonce) {
  if (body == nullptr || len < 13) return 0;
  uint64_t mlen;
  memcpy(&mlen, body + 5, 8);
  if (mlen > len - 13) return 0;
  const char* meta = body + 13;
  uint64_t lo = mlen > kNlAdmitScan ? mlen - kNlAdmitScan : 0;
  static const char kSeq[] = "\"pseq\":";
  static const char kNonce[] = "\"pnonce\":";
  const int64_t sl = (int64_t)sizeof(kSeq) - 1;
  const int64_t nl = (int64_t)sizeof(kNonce) - 1;
  int64_t si = -1, ni = -1;
  for (int64_t i = (int64_t)mlen - sl; i >= (int64_t)lo; --i) {
    if (memcmp(meta + i, kSeq, (size_t)sl) == 0) {
      si = i;
      break;
    }
  }
  if (si < 0) return 0;
  for (int64_t i = (int64_t)mlen - nl; i >= (int64_t)lo; --i) {
    if (memcmp(meta + i, kNonce, (size_t)nl) == 0) {
      ni = i;
      break;
    }
  }
  if (ni < 0) return 0;
  uint64_t i = (uint64_t)(si + sl);
  while (i < mlen && meta[i] == ' ') ++i;
  if (i >= mlen || meta[i] < '0' || meta[i] > '9') return 0;
  uint64_t v = 0;
  for (; i < mlen && meta[i] >= '0' && meta[i] <= '9'; ++i) {
    if (v > (~0ull - 9) / 10) return 0;  // implausible: not a token
    v = v * 10 + (uint64_t)(meta[i] - '0');
  }
  *pseq = v;
  i = (uint64_t)(ni + nl);
  while (i < mlen && meta[i] == ' ') ++i;
  if (i >= mlen || meta[i] != '"') return 0;  // null/non-string nonce
  ++i;
  int n = 0;
  while (i < mlen && meta[i] != '"') {
    // in-tree nonces are short uuid hex — an escape or an over-long
    // nonce is not one of ours: punt rather than guess
    if (meta[i] == '\\' || n >= kNlAdmitNonceMax) return 0;
    nonce[n++] = meta[i++];
  }
  if (i >= mlen || n == 0) return 0;
  return n;
}

// Owner thread: classify one admissible PUSH frame against the native
// ledger mirror. Returns 1 when the frame was SERVED natively (replay
// ack or role refusal written — the caller frees the body and moves
// on), 2 when it is FRESH (the caller queues it to the pump stamped
// with *admit_gen — the floor at classification time + 1, which Python
// trusts only while no apply has landed since), or 0 to PUNT: queue it
// unstamped, exactly the pre-admission path. The strict-fallback mirror
// of nl_cache_serve: anything this tier cannot prove takes the pump, so
// reply bytes stay identical by construction — the templates only ever
// echo frames Python published.
int nl_admit_serve(NlLoop* l, NlThread& t, NlConn* c,
                   uint64_t* admit_gen) {
  if (c->body_len < 13) return 0;
  uint32_t worker;
  memcpy(&worker, c->body + 1, 4);
  uint64_t pseq = 0;
  char nonce[kNlAdmitNonceMax];
  int nlen = nl_admit_token(c->body, c->body_len, &pseq, nonce);
  std::string reply;     // template copied out under admitmu: the send
  bool refusal = false;  // happens under the conn's wmu only
  {
    std::lock_guard<std::mutex> lock(l->admitmu);
    if (!l->admit_refusal.empty()) {
      // role refusal (backup / fenced zombie): every admissible frame
      // gets the typed ERR the pump would produce, token or not
      reply = l->admit_refusal;
      refusal = true;
    } else if (nlen <= 0) {
      l->admit_punts.fetch_add(1, std::memory_order_relaxed);
      return 0;
    } else {
      auto it = l->admit.find(worker);
      if (it == l->admit.end() ||
          it->second.nonce.size() != (size_t)nlen ||
          memcmp(it->second.nonce.data(), nonce, (size_t)nlen) != 0) {
        // unknown worker, or a restarted one (new nonce): the pump's
        // full ledger is the oracle until the next publish
        l->admit_punts.fetch_add(1, std::memory_order_relaxed);
        return 0;
      }
      NlAdmitEntry& e = it->second;
      if (pseq > e.hi) {
        // fresh: advance the pending bound NOW, so a racing duplicate
        // of the same seq punts instead of also stamping fresh
        e.hi = pseq;
        *admit_gen = l->admit_floor + 1;
        l->admit_fresh.fetch_add(1, std::memory_order_relaxed);
        return 2;
      }
      if (pseq > e.lo || l->admit_ack.empty()) {
        // in-window: a seq some key may not have settled yet (stamped
        // fresh, apply not yet published back) — only the pump's
        // per-key scan can answer it
        l->admit_punts.fetch_add(1, std::memory_order_relaxed);
        return 0;
      }
      reply = l->admit_ack;  // pure replay: every key settled <= lo
    }
  }
  // patch the requesting worker's id into the template (reply layout:
  // [u64 le length][kind u8][worker u32 le]...; templates are validated
  // >= 13 frame bytes at publish, so offset 9..13 is in bounds)
  memcpy(&reply[9], &worker, 4);
  if (!nl_serve_bytes(l, t, c, reply.data(), reply.size())) {
    // pipelining punt (see nl_serve_bytes): the pump answers it
    l->admit_punts.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  if (refusal)
    l->admit_refusals.fetch_add(1, std::memory_order_relaxed);
  else
    l->admit_acks.fetch_add(1, std::memory_order_relaxed);
  return 1;
}

// Owner thread: read everything available on c; queue complete frames.
void nl_read(NlLoop* l, NlThread& t, NlConn* c) {
  while (true) {
    if (c->body == nullptr) {
      ssize_t r = recv(c->fd, c->lenbuf + c->lenoff, 8 - c->lenoff, 0);
      if (r == 0) { nl_destroy(l, t, c); return; }
      if (r < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        nl_destroy(l, t, c);
        return;
      }
      if (c->lenoff == 0 && l->stats_on.load(std::memory_order_relaxed))
        c->t_frame_ns = nl_now_ns();  // first byte of a new frame
      c->lenoff += (int)r;
      if (c->lenoff < 8) continue;
      uint64_t len;
      memcpy(&len, c->lenbuf, 8);
      c->lenoff = 0;
      if (len > kMaxFrame) { nl_destroy(l, t, c); return; }
      c->body = static_cast<char*>(malloc(len ? len : 1));
      if (!c->body) { nl_destroy(l, t, c); return; }
      c->body_len = len;
      c->body_off = 0;
    }
    while (c->body_off < c->body_len) {
      ssize_t r = recv(c->fd, c->body + c->body_off,
                       c->body_len - c->body_off, 0);
      if (r == 0) { nl_destroy(l, t, c); return; }
      if (r < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        nl_destroy(l, t, c);
        return;
      }
      c->body_off += (uint64_t)r;
    }
    // frame complete: the read-latency sample lands now; the completion
    // stamp rides the queue entry so the pump measures its own wait
    bool stats = l->stats_on.load(std::memory_order_relaxed) != 0;
    uint64_t done_ns = 0, read_ns = 0;
    if (stats) {
      done_ns = nl_now_ns();
      if (c->t_frame_ns) {
        read_ns = done_ns - c->t_frame_ns;
        nl_hist_add(l->stripes[t.idx].hist[kNlHistReadFrame], read_ns);
      }  // no first-byte stamp (stats were off then): skip the sample
    }
    // cleared UNCONDITIONALLY: a stamp taken before a stats toggle must
    // never survive into a later frame as a phantom multi-second sample
    c->t_frame_ns = 0;
    {
      int ck = l->cache_kind.load(std::memory_order_relaxed);
      if (ck >= 0 && c->body_len >= 1 && (uint8_t)c->body[0] == (uint8_t)ck
          && nl_cache_serve(l, t, c)) {
        // answered (or severed) natively: the frame never queued, so it
        // never counts as outstanding and Python never sees it. This is
        // the zero-upcall path — its service time is only visible here.
        if (stats) {
          uint64_t serve_ns = nl_now_ns() - done_ns;
          nl_hist_add(l->stripes[t.idx].hist[kNlHistReadHit], serve_ns);
          uint64_t thr = l->slow_ns.load(std::memory_order_relaxed);
          if (thr && read_ns + serve_ns > thr)
            nl_slow_record(l, c->id, c->body, c->body_len, read_ns, 0,
                           serve_ns);
        }
        // pslint: owns: body -- cache-hit frame answered on the owner
        // thread BEFORE the queue push: still thread-private, no
        // ownership ever transferred to Python
        free(c->body);
        c->body = nullptr;
        c->body_len = c->body_off = 0;
        continue;
      }
    }
    uint64_t admit_gen = 0;
    {
      int ak = l->admit_kind.load(std::memory_order_relaxed);
      if (ak >= 0 && c->body_len >= 1
          && (uint8_t)c->body[0] == (uint8_t)ak) {
        int rc = nl_admit_serve(l, t, c, &admit_gen);
        if (rc == 1) {
          // answered natively (replay ack or role refusal): the frame
          // never queued, Python never saw it — the zero-upcall push
          // path, same life cycle as a read-cache hit above
          if (stats) {
            uint64_t serve_ns = nl_now_ns() - done_ns;
            uint64_t thr = l->slow_ns.load(std::memory_order_relaxed);
            if (thr && read_ns + serve_ns > thr)
              nl_slow_record(l, c->id, c->body, c->body_len, read_ns, 0,
                             serve_ns);
          }
          // pslint: owns: body -- admission-served frame answered on
          // the owner thread BEFORE the queue push: still
          // thread-private, no ownership ever transferred to Python
          free(c->body);
          c->body = nullptr;
          c->body_len = c->body_off = 0;
          continue;
        }
      }
    }
    uint32_t out;
    {
      std::lock_guard<std::mutex> lock(c->wmu);
      out = ++c->outstanding;
    }
    if (out > kNlMaxOutstanding) {
      // pslint: owns: body -- abuse path, BEFORE the queue push: this
      // frame is still thread-private, nothing transferred yet
      free(c->body);
      c->body = nullptr;
      nl_destroy(l, t, c);
      return;
    }
    {
      std::lock_guard<std::mutex> lock(l->qmu);
      // pslint: transfers: body -- from this push the body is Python's,
      // nl_poll hands it out and ONLY nl_body_free may release it; the
      // UAF gate: any new native free of a body needs an owns: claim
      l->ready.push_back({c->id, c->body, c->body_len, read_ns, done_ns,
                          admit_gen});
    }
    l->requests.fetch_add(1, std::memory_order_relaxed);
    l->qcv.notify_one();
    c->body = nullptr;
    c->body_len = c->body_off = 0;
  }
}

// Owner thread: flush the buffered reply tail; returns false when the
// connection must be destroyed (hard error, or goodbye fully flushed).
bool nl_flush(NlLoop* l, NlThread& t, NlConn* c) {
  std::lock_guard<std::mutex> lock(c->wmu);
  while (c->woff < c->wbuf.size()) {
    ssize_t r = send(c->fd, c->wbuf.data() + c->woff,
                     c->wbuf.size() - c->woff, MSG_DONTWAIT | MSG_NOSIGNAL);
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
      return false;
    }
    c->woff += (size_t)r;
    l->tail_backlog.fetch_sub((uint64_t)r, std::memory_order_relaxed);
  }
  // tail fully drained: the EPOLLOUT stall this conn paid ends here
  if (c->t_stall_ns) {
    if (l->stats_on.load(std::memory_order_relaxed))
      nl_hist_add(l->stripes[t.idx].hist[kNlHistFlush],
                  nl_now_ns() - c->t_stall_ns);
    l->tail_flushes.fetch_add(1, std::memory_order_relaxed);
    c->t_stall_ns = 0;
  }
  if (c->wbuf.capacity() > (1u << 20)) {
    // release a large spill's capacity instead of pinning it for the
    // connection's lifetime (64 conns that each spilled once would
    // otherwise hold their high-water marks forever)
    std::string().swap(c->wbuf);
  } else {
    c->wbuf.clear();
  }
  c->woff = 0;
  if (c->close_after) return false;
  if (c->want_write) {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = c;
    epoll_ctl(t.epfd, EPOLL_CTL_MOD, c->fd, &ev);
    c->want_write = false;
  }
  return true;
}

void nl_accept(NlLoop* l, NlThread& t0) {
  while (l->accepting.load(std::memory_order_relaxed)) {
    int fd = accept(l->listener->fd, nullptr, nullptr);
    if (fd < 0) return;  // EAGAIN (nonblocking listener) or closed
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    auto* c = new NlConn();
    c->fd = fd;
    int ti;
    {
      std::lock_guard<std::mutex> lock(l->tmu);
      c->id = l->next_id++;
      ti = (int)(l->rr++ % (uint64_t)l->nthreads);
      c->owner = ti;
      l->conns[c->id] = c;
    }
    l->accepted.fetch_add(1, std::memory_order_relaxed);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = c;
    if (ti == 0) {
      epoll_ctl(t0.epfd, EPOLL_CTL_ADD, fd, &ev);
    } else {
      NlThread& t = l->threads[ti];
      {
        std::lock_guard<std::mutex> lock(t.cmu);
        t.cmds.push_back([c](NlThread& th) {
          if (c->dead) return;
          epoll_event e{};
          e.events = EPOLLIN;
          e.data.ptr = c;
          epoll_ctl(th.epfd, EPOLL_CTL_ADD, c->fd, &e);
        });
      }
      nl_wake(t);
    }
  }
}

void nl_thread_run(NlLoop* l, int ti) {
  NlThread& t = l->threads[ti];
  epoll_event evs[64];
  std::vector<std::pair<int, NlConn*>> writable;  // (prio, conn) per batch
  while (!l->stop.load(std::memory_order_relaxed)) {
    int n = epoll_wait(t.epfd, evs, 64, 100);
    l->iters.fetch_add(1, std::memory_order_relaxed);
    {
      std::vector<std::function<void(NlThread&)>> cmds;
      {
        std::lock_guard<std::mutex> lock(t.cmu);
        cmds.swap(t.cmds);
      }
      for (auto& cmd : cmds) cmd(t);
    }
    for (int i = 0; i < n; ++i) {
      void* p = evs[i].data.ptr;
      if (p == (void*)&t) {  // eventfd wakeup: drain it
        uint64_t v;
        ssize_t r = read(t.evfd, &v, sizeof(v));
        (void)r;
        continue;
      }
      if (p == (void*)l) {  // listener (thread 0 only)
        nl_accept(l, t);
        continue;
      }
      auto* c = static_cast<NlConn*>(p);
      if (c->dead) continue;  // a command in this batch destroyed it
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        // flush what we can first: a goodbye OK may still be in the
        // tail while the peer half-closed its side
        if (!(evs[i].events & EPOLLOUT) || !nl_flush(l, t, c)) {
          nl_destroy(l, t, c);
          continue;
        }
      }
      if (evs[i].events & EPOLLIN) nl_read(l, t, c);
      if (!c->dead && (evs[i].events & EPOLLOUT)) {
        // defer the tail flush: writable conns in THIS batch drain in
        // priority order below, not epoll arrival order — the
        // ByteScheduler-style writev scheduler (a conn may appear once
        // per batch; epoll never duplicates an fd within one wait)
        writable.emplace_back(0, c);
      }
    }
    if (!writable.empty()) {
      // snapshot each conn's priority ONCE under its write mutex (never
      // inside the comparator — a sort must not take locks per compare),
      // then drain lowest-priority-number first; conn id breaks ties so
      // the order is reproducible across batches
      for (auto& w : writable) {
        std::lock_guard<std::mutex> lw(w.second->wmu);
        w.first = w.second->prio;
      }
      std::sort(writable.begin(), writable.end(),
                [](const std::pair<int, NlConn*>& a,
                   const std::pair<int, NlConn*>& b) {
                  return a.first != b.first ? a.first < b.first
                                            : a.second->id < b.second->id;
                });
      for (auto& w : writable) {
        NlConn* c = w.second;
        if (c->dead) continue;
        if (!nl_flush(l, t, c)) nl_destroy(l, t, c);
      }
      writable.clear();
    }
    for (auto* g : t.graveyard) delete g;
    t.graveyard.clear();
  }
}

}  // namespace

// Start the event loop over an existing tv_listen handle: the loop takes
// over accepting (the listener fd goes non-blocking and into thread 0's
// epoll set). `nthreads` loop threads serve connections round-robin.
// The listener handle stays owned by the caller — close it only AFTER
// nl_stop. Returns nullptr on failure.
void* nl_start(void* listener, int nthreads) {
  auto* lst = static_cast<Listener*>(listener);
  if (!lst || nthreads < 1 || nthreads > 64) return nullptr;
  auto* l = new NlLoop();
  l->listener = lst;
  l->nthreads = nthreads;
  // telemetry stripes: one per loop thread + one shared by the pump and
  // punted repliers (index nthreads) — allocated once, before any thread
  // can record, so the hot path never checks for them
  l->stripes.reset(new NlStripe[(size_t)nthreads + 1]());
  int fl = fcntl(lst->fd, F_GETFL, 0);
  fcntl(lst->fd, F_SETFL, fl | O_NONBLOCK);
  bool ok = true;
  for (int i = 0; i < nthreads; ++i) {
    l->threads.emplace_back();
    NlThread& t = l->threads.back();
    t.idx = i;
    t.epfd = epoll_create1(0);
    t.evfd = eventfd(0, EFD_NONBLOCK);
    if (t.epfd < 0 || t.evfd < 0) { ok = false; break; }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = (void*)&t;
    epoll_ctl(t.epfd, EPOLL_CTL_ADD, t.evfd, &ev);
  }
  if (ok) {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = (void*)l;
    ok = epoll_ctl(l->threads[0].epfd, EPOLL_CTL_ADD, lst->fd, &ev) == 0;
  }
  if (!ok) {
    for (auto& t : l->threads) {
      if (t.epfd >= 0) close(t.epfd);
      if (t.evfd >= 0) close(t.evfd);
    }
    delete l;
    return nullptr;
  }
  for (int i = 0; i < nthreads; ++i)
    l->threads[i].th = std::thread([l, i] { nl_thread_run(l, i); });
  return l;
}

// Pump upcall: block (GIL released by ctypes) until >= 1 complete request
// is ready, then fill the out arrays with up to `cap` of them. Returns the
// batch size (0 = timeout), or -1 once the loop is stopping AND drained.
// Each body pointer is owned by the caller until nl_body_free. `admits`
// (nullable — nl_poll passes nullptr for the legacy shape) receives each
// frame's native admission stamp: 0 = not classified, otherwise the
// admission floor at classification time + 1 for a frame the owner
// thread proved FRESH — Python may skip its per-key dedup scan for it
// only while its _read_gen still equals stamp - 1 (no apply landed in
// between; see the NlLoop admit members).
int nl_poll2(void* h, uint64_t* conn_ids, void** bodies, uint64_t* lens,
             uint64_t* admits, int cap, int timeout_ms) {
  auto* l = static_cast<NlLoop*>(h);
  // claimed entries' telemetry stamps: captured during the pop, recorded
  // AFTER qmu is released (qmu is a hot lock — the histogram math and the
  // slow-frame classification happen outside it). Reserved before the
  // lock so the pop allocates nothing while holding it.
  std::vector<std::pair<uint64_t, uint64_t>> tel;  // (read_ns, ready_ns)
  tel.reserve((size_t)(cap > 0 ? cap : 0));
  std::unique_lock<std::mutex> lock(l->qmu);
  if (l->ready.empty()) {
    if (l->stop.load(std::memory_order_relaxed)) return -1;
    // wait_until(system_clock), NOT wait_for: libstdc++ 10 lowers
    // wait_for to pthread_cond_clockwait, which this toolchain's TSan
    // does not intercept — the wait's internal unlock/relock becomes
    // invisible and every later qmu use reports as a phantom race /
    // double lock. system_clock waits lower to the intercepted
    // pthread_cond_timedwait. (A wall-clock jump can stretch one 100ms
    // poll tick; the pump loops, so that is harmless.)
    l->qcv.wait_until(lock, std::chrono::system_clock::now()
                                + std::chrono::milliseconds(timeout_ms),
                      [l] { return !l->ready.empty()
                                 || l->stop.load(std::memory_order_relaxed); });
  }
  if (l->ready.empty())
    return l->stop.load(std::memory_order_relaxed) ? -1 : 0;
  int n = 0;
  while (n < cap && !l->ready.empty()) {
    NlReq& r = l->ready.front();
    conn_ids[n] = r.conn_id;
    bodies[n] = r.body;
    lens[n] = r.len;
    if (admits != nullptr) admits[n] = r.admit_gen;
    tel.emplace_back(r.read_ns, r.ready_ns);
    ++n;
    l->ready.pop_front();
  }
  l->popped.fetch_add((uint64_t)n, std::memory_order_relaxed);
  lock.unlock();
  if (l->stats_on.load(std::memory_order_relaxed)) {
    // ready-queue wait (frame complete -> claimed by THIS pump call),
    // recorded into the pump's own stripe; the slow-frame check covers
    // the whole in-loop life of a pump-bound frame (read + wait). The
    // bodies are still native-owned until nl_body_free, so the trace
    // sniff reads live memory.
    uint64_t now = nl_now_ns();
    uint64_t thr = l->slow_ns.load(std::memory_order_relaxed);
    NlHist& qh = l->stripes[l->nthreads].hist[kNlHistQueueWait];
    for (int i = 0; i < n; ++i) {
      if (!tel[i].second) continue;  // frame read while stats were off
      uint64_t wait = now > tel[i].second ? now - tel[i].second : 0;
      nl_hist_add(qh, wait);
      if (thr && tel[i].first + wait > thr)
        nl_slow_record(l, conn_ids[i], (const char*)bodies[i], lens[i],
                       tel[i].first, wait, 0);
    }
  }
  return n;
}

// The pre-admission pump upcall shape, kept for drivers that never read
// admission stamps (sanitizer harness legs, older pumps): exactly
// nl_poll2 with no admits out-array.
int nl_poll(void* h, uint64_t* conn_ids, void** bodies, uint64_t* lens,
            int cap, int timeout_ms) {
  return nl_poll2(h, conn_ids, bodies, lens, nullptr, cap, timeout_ms);
}

// Reply to one request: an immediate non-blocking scatter-gather writev of
// the u64 length prefix + the caller's live buffers; whatever the socket
// would not take NOW is copied to the connection's tail buffer and flushed
// by the owner loop thread on EPOLLOUT (the caller's buffers are NEVER
// referenced after this returns). `close_after` severs the connection once
// the reply is fully on the wire (SHUTDOWN goodbyes). `prio` tags any
// staged tail for the priority writev drain: when several conns await
// EPOLLOUT service in one epoll batch, lower-priority-number tails flush
// first (bucket replies pass their bucket index — front-of-model bytes
// leave before tail-layer bytes). Returns 1, or 0 when the connection is
// already gone (the worker vanished mid-reply).
int nl_reply_vec(void* h, uint64_t conn_id, const void** bufs,
                 const uint64_t* lens, int n, int close_after, int prio) {
  auto* l = static_cast<NlLoop*>(h);
  NlConn* c;
  {
    // pin under a BRIEF table lock, then write under the per-conn wmu
    // only: a multi-MB reply must not serialize accepts/destroys/other
    // repliers behind the global table. nl_destroy waits out the pin
    // before freeing, so the struct and fd stay valid for the write.
    std::lock_guard<std::mutex> tlock(l->tmu);
    auto it = l->conns.find(conn_id);
    if (it == l->conns.end()) return 0;
    c = it->second;
    ++c->pins;
  }
  std::unique_lock<std::mutex> wlock(c->wmu);
  if (c->outstanding) --c->outstanding;
  // a staged tail drains as one FIFO string: its priority is its most
  // urgent frame's (min), never simply the LAST reply's — a tiny
  // low-urgency ack appended behind a front-of-model tail must not
  // demote it (or promote a tail-layer payload it rides behind). A
  // fresh (empty-tail) reply starts the conn's priority over.
  c->prio = c->wbuf.empty() ? prio : std::min(c->prio, prio);
  uint64_t total = 0;
  for (int i = 0; i < n; ++i) total += lens[i];
  uint64_t len_le = total;
  bool fail = false;
  if (c->wbuf.empty()) {
    // fast path: hand the live buffers straight to the kernel
    std::vector<iovec> iov;
    iov.reserve((size_t)n + 1);
    iov.push_back({&len_le, sizeof(len_le)});
    for (int i = 0; i < n; ++i)
      if (lens[i])
        iov.push_back({const_cast<void*>(bufs[i]), (size_t)lens[i]});
    size_t idx = 0;
    while (idx < iov.size()) {
      size_t cnt = iov.size() - idx;
      if (cnt > (size_t)IOV_MAX) cnt = (size_t)IOV_MAX;
      msghdr mh{};
      mh.msg_iov = &iov[idx];
      mh.msg_iovlen = cnt;
      ssize_t r = sendmsg(c->fd, &mh, MSG_DONTWAIT | MSG_NOSIGNAL);
      if (r < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        fail = true;
        break;
      }
      while (r > 0 && idx < iov.size()) {
        if ((size_t)r >= iov[idx].iov_len) {
          r -= (ssize_t)iov[idx].iov_len;
          ++idx;
        } else {
          iov[idx].iov_base = (char*)iov[idx].iov_base + r;
          iov[idx].iov_len -= (size_t)r;
          r = 0;
        }
      }
    }
    // stage only the unsent tail (zero bytes in the common case)
    uint64_t staged = 0;
    for (; idx < iov.size(); ++idx) {
      c->wbuf.append((const char*)iov[idx].iov_base, iov[idx].iov_len);
      staged += iov[idx].iov_len;
    }
    if (staged) nl_tail_staged(l, c, staged, true);
  } else if (c->wbuf.size() - c->woff > kNlMaxWbufBacklog) {
    // the peer has stopped reading while pipelining more requests:
    // refusing to buffer further replies bounds server memory (the
    // conn is severed as protocol abuse, like the outstanding cap)
    fail = true;
  } else {
    // a tail is already queued: append whole frames behind it in order
    nl_tail_staged(l, c, sizeof(len_le) + total, false);
    c->wbuf.append((const char*)&len_le, sizeof(len_le));
    for (int i = 0; i < n; ++i)
      if (lens[i]) c->wbuf.append((const char*)bufs[i], (size_t)lens[i]);
  }
  int ret = 1;
  if (fail) {
    // hard send error: sever; the owner thread observes EOF and reaps
    shutdown(c->fd, SHUT_RDWR);
    ret = 0;
  } else {
    if (close_after) c->close_after = true;
    if ((!c->wbuf.empty() || c->close_after) && !c->want_write) {
      // arm EPOLLOUT so the owner flushes the tail (or reaps the
      // goodbye: a writable socket fires it immediately)
      c->want_write = true;
      epoll_event ev{};
      ev.events = EPOLLIN | EPOLLOUT;
      ev.data.ptr = c;
      epoll_ctl(l->threads[c->owner].epfd, EPOLL_CTL_MOD, c->fd, &ev);
    }
  }
  wlock.unlock();
  {
    std::lock_guard<std::mutex> tlock(l->tmu);
    if (--c->pins == 0) l->pin_cv.notify_all();
  }
  return ret;
}

// Release one request body handed out by nl_poll (after the reply — the
// reply buffers may alias the request's tensors).
// pslint: owns: body -- THE release endpoint of the transfer contract:
// Python (the owner since nl_poll) is the only caller
void nl_body_free(void* h, void* body) {
  auto* l = static_cast<NlLoop*>(h);
  free(body);
  l->freed.fetch_add(1, std::memory_order_relaxed);
}

// Detach a connection from the loop and return its raw fd (blocking mode
// restored) — the SHM_SETUP path: a negotiated shared-memory lane needs a
// dedicated serve thread (its ring wait is already GIL-free native code;
// epoll cannot wait on ring cursors). Runs ON the owner thread via the
// command queue so it cannot race the read path. Returns -1 if the
// connection is gone (or the loop is stopping).
int nl_detach(void* h, uint64_t conn_id) {
  auto* l = static_cast<NlLoop*>(h);
  NlConn* c = nullptr;
  int ti = 0;
  {
    std::lock_guard<std::mutex> lock(l->tmu);
    auto it = l->conns.find(conn_id);
    if (it == l->conns.end()) return -1;
    c = it->second;
    ti = c->owner;
  }
  struct DetachState {
    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    bool abandoned = false;  // caller timed out: the command must CLOSE
    int out_fd = -1;         // the fd instead of handing it to nobody
  };
  // shared_ptr, not stack refs: if this wait times out, the command may
  // still run later (nl_stop executes leftovers) and must not write to a
  // dead frame
  auto st = std::make_shared<DetachState>();
  NlThread& t = l->threads[ti];
  {
    std::lock_guard<std::mutex> lock(t.cmu);
    t.cmds.push_back([l, conn_id, st](NlThread& th) {
      NlConn* c2 = nullptr;
      {
        std::unique_lock<std::mutex> tl(l->tmu);
        auto it = l->conns.find(conn_id);
        if (it != l->conns.end()) {
          c2 = it->second;
          l->conns.erase(it);
          // a replier mid-write holds the struct and fd: wait it out
          // (same discipline as nl_destroy) before handing the fd away
          while (c2->pins > 0) l->pin_cv.wait(tl);
        }
      }
      int fd = -1;
      if (c2 != nullptr) {
        epoll_ctl(th.epfd, EPOLL_CTL_DEL, c2->fd, nullptr);
        fd = c2->fd;
        int fl = fcntl(fd, F_GETFL, 0);
        fcntl(fd, F_SETFL, fl & ~O_NONBLOCK);
        // pslint: owns: body -- mid-read frame only (same as
        // nl_destroy): a queued frame's pointer already left c2->body
        free(c2->body);
        c2->body = nullptr;
        c2->dead = true;
        th.graveyard.push_back(c2);
      }
      std::lock_guard<std::mutex> dl(st->mu);
      if (st->abandoned) {
        // the caller gave up: the conn is already out of the table, so
        // nl_stop would never close this fd — do it here or it leaks
        // (and the peer hangs forever with no EOF)
        if (fd >= 0) close(fd);
      } else {
        st->out_fd = fd;
      }
      st->done = true;
      st->cv.notify_one();
    });
  }
  nl_wake(t);
  std::unique_lock<std::mutex> lock(st->mu);
  // bounded wait: if the loop stopped before running the command,
  // nl_stop executes leftovers after joining — done still flips.
  // wait_until(system_clock), not wait_for: see nl_poll (TSan does not
  // intercept the clockwait that wait_for lowers to on this toolchain)
  st->cv.wait_until(lock, std::chrono::system_clock::now()
                              + std::chrono::seconds(10),
                    [&st] { return st->done; });
  if (!st->done) st->abandoned = true;  // late command closes the fd
  return st->done ? st->out_fd : -1;
}

// Stop admitting connections (the first leg of the drain): the listener
// leaves thread 0's epoll set and pending accepts are abandoned.
void nl_stop_accept(void* h) {
  auto* l = static_cast<NlLoop*>(h);
  l->accepting.store(false, std::memory_order_relaxed);
  epoll_ctl(l->threads[0].epfd, EPOLL_CTL_DEL, l->listener->fd, nullptr);
}

// Sever every live connection NOW (stop()/kill()): each peer observes EOF
// and each owner thread reaps its conns on the resulting events.
void nl_shutdown_conns(void* h) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->tmu);
  for (auto& kv : l->conns) shutdown(kv.second->fd, SHUT_RDWR);
}

// Requests not yet fully answered: ready-queue frames + frames claimed by
// Python (nl_poll'd, not yet nl_body_free'd) + connections with an
// unflushed reply tail. The drain in stop() waits for 0.
uint64_t nl_pending(void* h) {
  auto* l = static_cast<NlLoop*>(h);
  uint64_t claimed = l->popped.load(std::memory_order_relaxed)
                     - l->freed.load(std::memory_order_relaxed);
  uint64_t unflushed = 0;
  {
    std::lock_guard<std::mutex> lock(l->tmu);
    for (auto& kv : l->conns) {
      std::lock_guard<std::mutex> wl(kv.second->wmu);
      if (!kv.second->wbuf.empty()) ++unflushed;
    }
  }
  uint64_t ready;
  {
    std::lock_guard<std::mutex> lock(l->qmu);
    ready = (uint64_t)l->ready.size();
  }
  return ready + claimed + unflushed;
}

int nl_conn_count(void* h) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->tmu);
  return (int)l->conns.size();
}

// out[6]: iterations, accepted, requests, live conns, pending, claimed.
void nl_stats(void* h, uint64_t* out) {
  auto* l = static_cast<NlLoop*>(h);
  out[0] = l->iters.load(std::memory_order_relaxed);
  out[1] = l->accepted.load(std::memory_order_relaxed);
  out[2] = l->requests.load(std::memory_order_relaxed);
  out[3] = (uint64_t)nl_conn_count(h);
  out[4] = nl_pending(h);
  out[5] = l->popped.load(std::memory_order_relaxed)
           - l->freed.load(std::memory_order_relaxed);
}

// Configure the in-loop telemetry: `stats_on` gates every histogram
// stamp (off = the pre-telemetry hot path plus one relaxed load per
// frame), `slow_frame_ns` arms the slow-frame watchdog (0 = off) — any
// frame whose in-loop latency (read + queue wait, or read + native serve)
// exceeds it records a bounded ring entry for nl_slow_drain. Safe at any
// time; normally called once at service start from the PS_NL_STATS /
// PS_NL_SLOW_FRAME_MS knobs.
void nl_telemetry_config(void* h, int stats_on, uint64_t slow_frame_ns) {
  auto* l = static_cast<NlLoop*>(h);
  l->stats_on.store(stats_on ? 1 : 0, std::memory_order_relaxed);
  l->slow_ns.store(slow_frame_ns, std::memory_order_relaxed);
}

// Aggregate one in-loop histogram across every stripe. `which`: 0 = frame
// read latency, 1 = ready-queue wait, 2 = native READ-hit service time,
// 3 = EPOLLOUT tail-flush latency. Fills out[0]=total, out[1]=sum_ns,
// out[2]=min_ns (~0 when empty), out[3]=max_ns, out[4..4+nb) = raw bucket
// counts in the exact geometry of ps_tpu/obs/metrics.Histogram's defaults
// (lo=1e-6 s, hi=3600 s, 4 sub-buckets/octave — mergeable via state_add).
// Returns the bucket count (the caller sizes `out` as 4 + that), or -1
// for an unknown `which`.
int nl_hist_snapshot(void* h, int which, uint64_t* out) {
  auto* l = static_cast<NlLoop*>(h);
  if (which < 0 || which >= kNlHistCount) return -1;
  uint64_t total = 0, sum = 0, mn = ~0ull, mx = 0;
  for (int b = 0; b < kNlHistBuckets; ++b) out[4 + b] = 0;
  for (int s = 0; s <= l->nthreads; ++s) {
    NlHist& hh = l->stripes[s].hist[which];
    total += hh.total.load(std::memory_order_relaxed);
    sum += hh.sum_ns.load(std::memory_order_relaxed);
    uint64_t smn = hh.min_ns.load(std::memory_order_relaxed);
    uint64_t smx = hh.max_ns.load(std::memory_order_relaxed);
    if (smn < mn) mn = smn;
    if (smx > mx) mx = smx;
    for (int b = 0; b < kNlHistBuckets; ++b)
      out[4 + b] += hh.counts[b].load(std::memory_order_relaxed);
  }
  out[0] = total;
  out[1] = sum;
  out[2] = mn;
  out[3] = mx;
  return kNlHistBuckets;
}

// out[8]: current staged-tail backlog bytes, cumulative bytes ever
// staged, tails drained to empty, slow frames recorded, slow-ring
// overwrites (pump fell behind), stats_on, the armed slow threshold (ns),
// reserved 0.
void nl_stats_snapshot(void* h, uint64_t* out) {
  auto* l = static_cast<NlLoop*>(h);
  out[0] = l->tail_backlog.load(std::memory_order_relaxed);
  out[1] = l->tail_staged.load(std::memory_order_relaxed);
  out[2] = l->tail_flushes.load(std::memory_order_relaxed);
  out[3] = l->slow_total.load(std::memory_order_relaxed);
  out[4] = l->slow_dropped.load(std::memory_order_relaxed);
  out[5] = (uint64_t)l->stats_on.load(std::memory_order_relaxed);
  out[6] = l->slow_ns.load(std::memory_order_relaxed);
  out[7] = 0;
}

// Drain up to `cap` slow-frame ring entries (oldest first). `vals` holds
// 7 u64 slots per entry: conn id, kind byte, body size, read_ns, wait_ns,
// serve_ns, age_ns (record -> this drain). `tids` holds 2*20 bytes per
// entry: the NUL-terminated trace id then the parent span id sniffed from
// the frame's `tc` header (empty strings when the request was untraced).
// Returns the entry count.
int nl_slow_drain(void* h, uint64_t* vals, char* tids, int cap) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->slowmu);
  uint64_t now = nl_now_ns();
  int n = 0;
  while (n < cap && !l->slow_ring.empty()) {
    NlSlowFrame& f = l->slow_ring.front();
    uint64_t* v = vals + (size_t)n * 7;
    v[0] = f.conn;
    v[1] = f.kind;
    v[2] = f.size;
    v[3] = f.read_ns;
    v[4] = f.wait_ns;
    v[5] = f.serve_ns;
    v[6] = now > f.mono_ns ? now - f.mono_ns : 0;
    char* t = tids + (size_t)n * (2 * kNlTidLen);
    memcpy(t, f.trace, kNlTidLen);
    memcpy(t + kNlTidLen, f.span, kNlTidLen);
    l->slow_ring.pop_front();
    ++n;
  }
  return n;
}

// Test seam: record one KNOWN duration into stripe 0 of histogram
// `which` through the exact bucket math the loop's hot path uses — the
// fleet-merge exactness test feeds controlled samples through the real
// native bucketing and diffs the merged quantiles against numpy.
void nl_hist_record(void* h, int which, uint64_t ns) {
  auto* l = static_cast<NlLoop*>(h);
  if (which < 0 || which >= kNlHistCount) return;
  nl_hist_add(l->stripes[0].hist[which], ns);
}

// Begin shutdown WITHOUT freeing: loop threads exit, nl_poll drains the
// remaining ready frames and then returns -1. The Python pump exits on
// that -1; only then may nl_stop run.
void nl_begin_stop(void* h) {
  auto* l = static_cast<NlLoop*>(h);
  l->stop.store(true, std::memory_order_relaxed);
  l->accepting.store(false, std::memory_order_relaxed);
  for (auto& t : l->threads) nl_wake(t);
  l->qcv.notify_all();
}

// Join + free. Contract: no nl_poll/nl_reply_vec/nl_detach caller may be
// inside the handle (the Python driver joins its pump first). Bodies still
// claimed by Python are NOT freed here (Python may hold live views into
// them); unclaimed ready-queue bodies are.
// pslint: owns: body -- only mid-read conn bodies and UNCLAIMED ready
// entries are freed; claimed bodies stay Python-owned until
// nl_body_free (the exact UAF window PR 9 closed)
void nl_stop(void* h) {
  auto* l = static_cast<NlLoop*>(h);
  nl_begin_stop(h);
  for (auto& t : l->threads)
    if (t.th.joinable()) t.th.join();
  for (auto& t : l->threads) {
    // leftover commands (e.g. a detach posted as the loop stopped) must
    // still resolve their waiters
    std::vector<std::function<void(NlThread&)>> cmds;
    {
      std::lock_guard<std::mutex> lock(t.cmu);
      cmds.swap(t.cmds);
    }
    for (auto& cmd : cmds) cmd(t);
    for (auto* g : t.graveyard) delete g;
    t.graveyard.clear();
  }
  {
    std::lock_guard<std::mutex> lock(l->tmu);
    for (auto& kv : l->conns) {
      close(kv.second->fd);
      free(kv.second->body);
      delete kv.second;
    }
    l->conns.clear();
  }
  {
    std::lock_guard<std::mutex> lock(l->qmu);
    for (auto& r : l->ready) free(r.body);
    l->ready.clear();
  }
  for (auto& t : l->threads) {
    close(t.epfd);
    close(t.evfd);
  }
  delete l;
}

// ---------------------------------------------------------------------------
// Native read cache ("hot-key serving"): Python publishes complete,
// version-stamped reply frames; the loop answers byte-identical cacheable
// requests without an upcall. See the NlLoop cache members for the
// invalidation-generation contract.

// Enable (or resize) the cache: frames whose FIRST body byte equals
// `kind` are cacheable; `max_bytes` bounds key+reply memory (0 disables
// and clears). Safe at any time; normally called once at service start.
void nl_cache_config(void* h, int kind, uint64_t max_bytes) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->cachemu);
  l->cache_kind.store(max_bytes ? kind : -1, std::memory_order_relaxed);
  l->cache_limit = max_bytes;
  if (!max_bytes) {
    l->cache.clear();
    l->cache_fifo.clear();
    l->cache_bytes = 0;
  }
}

// Shared store body of every publish flavor (cachemu taken here): floor
// refusal, same-key replace (cond flag included in the match — an exact
// entry never shadows a spliced one), FIFO eviction, byte budget.
// Buffers are copied, never retained. Internal — not ABI.
namespace {

int nl_cache_store(void* h, const void* key, uint64_t klen,
                   const void* buf, uint64_t len, uint64_t gen,
                   const uint64_t* tags, int ntags, bool cond,
                   uint64_t vfloor) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->cachemu);
  uint64_t need = klen + len + 8;
  if (!l->cache_limit || gen < l->cache_floor || need > l->cache_limit) {
    l->cache_rejects.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  uint64_t hv = nl_cache_hash((const char*)key, klen);
  // replace an existing entry for the same request (a republish after
  // an invalidation cleared the table is the common case; same-key
  // duplicates must not accumulate)
  auto it = l->cache.find(hv);
  if (it != l->cache.end()) {
    std::shared_ptr<NlCacheEntry> old;
    for (auto& cand : it->second) {
      if (cand->cond == cond && cand->key.size() == klen &&
          memcmp(cand->key.data(), key, klen) == 0) {
        old = cand;  // copy FIRST: cand aliases the slot erase destroys
        break;
      }
    }
    if (old) nl_cache_erase(l, old, hv);
  }
  while (l->cache_bytes + need > l->cache_limit && !l->cache_fifo.empty()) {
    auto victim = l->cache_fifo.front();
    nl_cache_erase(l, victim,
                   nl_cache_hash(victim->key.data(), victim->key.size()));
  }
  auto e = std::make_shared<NlCacheEntry>();
  e->key.assign((const char*)key, klen);
  uint64_t len_le = len;
  e->reply.reserve(len + 8);
  e->reply.append((const char*)&len_le, sizeof(len_le));
  e->reply.append((const char*)buf, len);
  e->gen = gen;
  e->cond = cond;
  e->vfloor = vfloor;
  if (ntags > 0 && tags != nullptr) {
    e->tags.assign(tags, tags + ntags);
    std::sort(e->tags.begin(), e->tags.end());
  }
  l->cache[hv].push_back(e);
  l->cache_fifo.push_back(e);
  l->cache_bytes += klen + e->reply.size();
  l->cache_puts.fetch_add(1, std::memory_order_relaxed);
  return 1;
}

}  // namespace

// Publish one reply with per-key invalidation tags: `tags`/`ntags` name
// the state slice the reply covers (the sparse service hashes each
// (table, row id) of the cached id-set) so nl_cache_invalidate_tags can
// drop ONLY intersecting entries. ntags == 0 publishes an untagged entry
// — the pre-tag behavior: dropped by every invalidation, tagged or not.
// Everything else is nl_cache_put's contract (floor refusal, budget,
// FIFO eviction, buffers copied never retained).
int nl_cache_put_tagged(void* h, const void* key, uint64_t klen,
                        const void* buf, uint64_t len, uint64_t gen,
                        const uint64_t* tags, int ntags) {
  return nl_cache_store(h, key, klen, buf, len, gen, tags, ntags,
                        false, 0);
}

// Publish one conditional (NOT_MODIFIED) reply with a version floor:
// `key`/`klen` are the CONDITIONAL request's body bytes — the "cond"
// token is sniffed and its digits excised HERE, with the same bounded
// tail scan the serve side runs, so request and publish derive the
// spliced key by identical rules and can never disagree. `vfloor` is
// the server version the reply stamps: any later conditional request
// whose sniffed version >= vfloor gets this reply natively (the pump's
// own unchanged-target comparison). A key with no parseable token falls
// back to an exact-match publish — strictly conservative: byte-repeats
// still serve, no floor sharing. Floor refusal, budget, FIFO eviction
// and tag semantics are nl_cache_put_tagged's contract unchanged.
int nl_cache_put_cond(void* h, const void* key, uint64_t klen,
                      const void* buf, uint64_t len, uint64_t gen,
                      const uint64_t* tags, int ntags, uint64_t vfloor) {
  uint64_t v = 0, dlo = 0, dhi = 0;
  if (!nl_cond_token((const char*)key, klen, &v, &dlo, &dhi))
    return nl_cache_store(h, key, klen, buf, len, gen, tags, ntags,
                          false, 0);
  std::string spliced;
  spliced.reserve(klen - (dhi - dlo));
  spliced.append((const char*)key, dlo);
  spliced.append((const char*)key + dhi, klen - dhi);
  return nl_cache_store(h, spliced.data(), spliced.size(), buf, len,
                        gen, tags, ntags, true, vfloor);
}

// Publish one reply: `key`/`klen` are the request body bytes the entry
// answers (exact match), `buf`/`len` the reply frame (the length prefix
// is prepended here), `gen` the publish generation captured UNDER the
// engine lock with the snapshot. Returns 1 stored, 0 refused — gen below
// the invalidation floor (an apply superseded this snapshot), cache
// disabled, or the entry alone over budget. Oldest entries evict first
// when the budget would overflow. Caller's buffers are copied; never
// retained.
int nl_cache_put(void* h, const void* key, uint64_t klen, const void* buf,
                 uint64_t len, uint64_t gen) {
  return nl_cache_put_tagged(h, key, klen, buf, len, gen, nullptr, 0);
}

// Invalidation-on-apply: raise the publish floor to `gen` and drop every
// cached entry. Called by the engine (under its apply lock) on every
// committed state change a cached reply could observe — a put racing
// this call either lands first (cleared here) or arrives after with a
// pre-bump gen (refused at the floor). Entries mid-serve survive via
// their shared_ptr; new lookups miss immediately.
void nl_cache_invalidate(void* h, uint64_t gen) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->cachemu);
  if (gen > l->cache_floor) l->cache_floor = gen;
  if (!l->cache_fifo.empty()) {
    l->cache.clear();
    l->cache_fifo.clear();
    l->cache_bytes = 0;
  }
  l->cache_invals.fetch_add(1, std::memory_order_relaxed);
}

// Per-key invalidation (the sparse read path's ROADMAP follow-up): raise
// the publish floor to `gen` — exactly nl_cache_invalidate's race
// contract, so an in-flight pre-apply publish of ANY id-set is still
// refused — but drop only the entries whose tag set intersects
// `tags`/`ntags` (plus untagged entries, which claim nothing and must
// stay conservative). Cached replies for id-sets disjoint from the
// applied rows keep serving natively: their row bytes are untouched by
// this apply — only their version STAMP now trails, which the bounded-
// staleness contract already treats as grounds for fallback, never as a
// correctness violation.
void nl_cache_invalidate_tags(void* h, uint64_t gen, const uint64_t* tags,
                              int ntags) {
  auto* l = static_cast<NlLoop*>(h);
  std::vector<uint64_t> want(tags, tags + (ntags > 0 ? ntags : 0));
  std::sort(want.begin(), want.end());
  std::lock_guard<std::mutex> lock(l->cachemu);
  if (gen > l->cache_floor) l->cache_floor = gen;
  // ONE partition pass over the fifo (survivors keep their eviction
  // order), victims unlinked from their hash bucket directly — never
  // nl_cache_erase's per-victim fifo scan, which would make a mass
  // invalidation O(victims x entries) while every hit/publish waits on
  // cachemu
  std::deque<std::shared_ptr<NlCacheEntry>> keep;
  uint64_t freed = 0;
  for (auto& e : l->cache_fifo) {
    bool hit = e->tags.empty();
    if (!hit) {
      // both sides sorted: one linear merge pass per entry
      size_t i = 0, j = 0;
      while (i < e->tags.size() && j < want.size()) {
        if (e->tags[i] == want[j]) {
          hit = true;
          break;
        }
        if (e->tags[i] < want[j]) ++i;
        else ++j;
      }
    }
    if (!hit) {
      keep.push_back(e);
      continue;
    }
    freed += e->key.size() + e->reply.size();
    uint64_t hv = nl_cache_hash(e->key.data(), e->key.size());
    auto it = l->cache.find(hv);
    if (it != l->cache.end()) {
      auto& v = it->second;
      for (size_t i = 0; i < v.size(); ++i) {
        if (v[i] == e) {
          v.erase(v.begin() + i);
          break;
        }
      }
      if (v.empty()) l->cache.erase(it);
    }
  }
  l->cache_fifo.swap(keep);
  l->cache_bytes -= freed;
  l->cache_invals.fetch_add(1, std::memory_order_relaxed);
}

// out[9]: hits, misses, puts, rejects, invalidations, entries, bytes,
// floor, cond_hits. Hits are frames answered with zero upcalls; misses
// are cacheable-kind frames that fell through to the pump; cond_hits is
// the subset of hits served from a version-floor (NOT_MODIFIED) entry.
void nl_cache_stats(void* h, uint64_t* out) {
  auto* l = static_cast<NlLoop*>(h);
  out[0] = l->cache_hits.load(std::memory_order_relaxed);
  out[1] = l->cache_miss.load(std::memory_order_relaxed);
  out[2] = l->cache_puts.load(std::memory_order_relaxed);
  out[3] = l->cache_rejects.load(std::memory_order_relaxed);
  out[4] = l->cache_invals.load(std::memory_order_relaxed);
  out[8] = l->cache_cond_hits.load(std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(l->cachemu);
  out[5] = (uint64_t)l->cache_fifo.size();
  out[6] = l->cache_bytes;
  out[7] = l->cache_floor;
}

// ---------------------------------------------------------------------------
// Native push admission ("zero-upcall push plane"): Python mirrors each
// worker's dedup ledger plus the engine's replay-ack / role-refusal
// reply frames; the loop classifies PUSH frames on the owner thread —
// pure replays and refusals answered with zero upcalls, fresh frames
// stamped and queued. See the NlLoop admit members for the floor
// contract.

// Arm admission for frames whose FIRST body byte equals `kind` (the
// wire kind — tv.PUSH or tv.ROW_PUSH); kind < 0 disables and clears the
// ledger and both templates. Safe at any time; normally called once at
// service start.
void nl_admit_config(void* h, int kind) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->admitmu);
  l->admit_kind.store(kind < 0 ? -1 : kind, std::memory_order_relaxed);
  if (kind < 0) {
    l->admit.clear();
    l->admit_ack.clear();
    l->admit_refusal.clear();
  }
}

// Publish one worker's ledger mirror entry: `nonce` its CURRENT push
// nonce, `lo` the settled bound (every key the worker pushes settled at
// seq <= lo), `hi` the recorded bound (no recorded seq above hi), `gen`
// the publish generation captured under the engine lock AFTER the
// apply's invalidation bump. Returns 1 stored, 0 refused — admission
// off, gen below the floor (a later apply superseded this snapshot), or
// a malformed nonce/window. A same-nonce republish keeps the larger
// lo/hi (frames stamped fresh between the apply and this publish have
// already advanced the pending bound past the ledger's).
int nl_admit_put(void* h, uint32_t worker, const void* nonce,
                 uint64_t nonce_len, uint64_t lo, uint64_t hi,
                 uint64_t gen) {
  auto* l = static_cast<NlLoop*>(h);
  if (nonce == nullptr || nonce_len == 0 ||
      nonce_len > (uint64_t)kNlAdmitNonceMax || lo > hi)
    return 0;
  std::lock_guard<std::mutex> lock(l->admitmu);
  if (l->admit_kind.load(std::memory_order_relaxed) < 0 ||
      gen < l->admit_floor)
    return 0;
  NlAdmitEntry& e = l->admit[worker];
  if (e.nonce.size() == nonce_len &&
      memcmp(e.nonce.data(), nonce, nonce_len) == 0) {
    if (lo > e.lo) e.lo = lo;
    if (hi > e.hi) e.hi = hi;
  } else {
    e.nonce.assign((const char*)nonce, nonce_len);
    e.lo = lo;
    e.hi = hi;
  }
  return 1;
}

// Publish the replay-ack template: the COMPLETE reply frame (no length
// prefix; prepended here, like nl_cache_put) the pump would send for a
// full-dedup replay, captured under the engine lock with the version
// stamp the ledger's `lo` bounds cover. The worker id at frame bytes
// 1..5 is patched per serve. len == 0 clears. Returns 1 stored, 0
// refused — gen below the floor (an apply changed the version this
// template reports) or a frame too short to patch.
int nl_admit_set_ack(void* h, const void* buf, uint64_t len,
                     uint64_t gen) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->admitmu);
  if (len == 0) {
    l->admit_ack.clear();
    return 1;
  }
  if (buf == nullptr || len < 13 || gen < l->admit_floor) return 0;
  uint64_t len_le = len;
  l->admit_ack.clear();
  l->admit_ack.reserve(len + 8);
  l->admit_ack.append((const char*)&len_le, sizeof(len_le));
  l->admit_ack.append((const char*)buf, len);
  return 1;
}

// Publish (or clear, len == 0) the role-refusal template: the typed ERR
// every admissible frame gets while this shard must refuse pushes
// (backup role, fenced zombie). NOT floor-gated — role does not change
// on applies; promotion re-seeds through nl_admit_reset first.
int nl_admit_set_refusal(void* h, const void* buf, uint64_t len) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->admitmu);
  if (len == 0) {
    l->admit_refusal.clear();
    return 1;
  }
  if (buf == nullptr || len < 13) return 0;
  uint64_t len_le = len;
  l->admit_refusal.clear();
  l->admit_refusal.reserve(len + 8);
  l->admit_refusal.append((const char*)&len_le, sizeof(len_le));
  l->admit_refusal.append((const char*)buf, len);
  return 1;
}

// Invalidation-on-apply (the push twin of nl_cache_invalidate): raise
// the floor to `gen` and drop the version-stamped ack template. The
// LEDGER persists — its bounds only ever advance, so a stale entry is
// conservative (it punts frames a fresher mirror would ack, never the
// reverse), while dropping it would punt EVERY frame until the next
// publish.
void nl_admit_invalidate(void* h, uint64_t gen) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->admitmu);
  if (gen > l->admit_floor) l->admit_floor = gen;
  l->admit_ack.clear();
}

// Structural re-seed (promotion, fence, migrate, pause/resume): raise
// the floor and drop the ledger AND both templates. The caller
// republishes whatever the new role/state allows.
void nl_admit_reset(void* h, uint64_t gen) {
  auto* l = static_cast<NlLoop*>(h);
  std::lock_guard<std::mutex> lock(l->admitmu);
  if (gen > l->admit_floor) l->admit_floor = gen;
  l->admit.clear();
  l->admit_ack.clear();
  l->admit_refusal.clear();
}

// out[8]: acks (native replay OKs), refusals (native typed ERRs), fresh
// (frames stamped + queued), punts (admissible frames the pump had to
// classify), ledger entries, floor, ack armed, refusal armed.
void nl_admit_stats(void* h, uint64_t* out) {
  auto* l = static_cast<NlLoop*>(h);
  out[0] = l->admit_acks.load(std::memory_order_relaxed);
  out[1] = l->admit_refusals.load(std::memory_order_relaxed);
  out[2] = l->admit_fresh.load(std::memory_order_relaxed);
  out[3] = l->admit_punts.load(std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(l->admitmu);
  out[4] = (uint64_t)l->admit.size();
  out[5] = l->admit_floor;
  out[6] = l->admit_ack.empty() ? 0 : 1;
  out[7] = l->admit_refusal.empty() ? 0 : 1;
}

}  // extern "C"
