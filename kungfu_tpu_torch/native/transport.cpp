// Native host-side message transport — the C++ rchannel equivalent.
//
// Copy of kungfu_tpu/native/transport.cpp with two additions: a channel
// created on port 0 binds a port the kernel assigns, takes it into its
// own peer spec (the src field of every frame it sends, and its unix
// socket path), and reports it through kf_host_port; kf_host_shutdown
// stops a channel without freeing it, so the Python wrapper can let
// every call that entered leave before kf_host_close frees it.  The
// wire format is unchanged.
//
// Wire-compatible with kungfu_tpu_torch/comm/host.py (little-endian framing:
//   magic u32 | token u32 | conn_type u8 | src_len u16 | src
//   | name_len u16 | name | payload_len u32 | payload
// ), so a native channel and a Python channel interoperate freely.
// This is the TPU build's analog of the reference's Go transport
// (srcs/go/rchannel/{connection,client,server,handler}): typed named
// messages over TCP, rendezvous-by-name receive queues keyed by the
// cluster-version token (fencing, connection.go:28-47,77-87), pooled
// per-peer sender connections (client/connection_pool.go), 500x200ms
// connect retries (config.go:16-18), and ping echo (handler/ping.go).
//
// Exposed as a flat C API consumed via ctypes (no pybind11 in this
// environment); see kungfu_tpu_torch/native/transport.py.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

#include <cerrno>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Timed condition waits pick their clock per build: libstdc++ lowers
// steady_clock waits to pthread_cond_clockwait, which GCC 10's TSan does
// NOT intercept — the hidden unlock/relock inside the wait corrupts
// TSan's lock-ownership model and floods the run with bogus "double
// lock" / missing happens-before reports.  Sanitizer builds therefore
// wait on the (intercepted) system clock; production keeps the
// jump-proof steady clock.
#if defined(__SANITIZE_THREAD__)
using wait_clock = std::chrono::system_clock;
#else
using wait_clock = std::chrono::steady_clock;
#endif

constexpr uint32_t kMagic = 0x4B465450;  // "KFTP"
constexpr int kConnPing = 1;
constexpr int kConnControl = 2;
constexpr int kConnCollective = 3;
constexpr int kConnPeerToPeer = 4;

// framing sanity limits: the wire is unauthenticated, so a u32 length
// from a stray/hostile connection must not drive a near-4 GiB allocation
// (std::bad_alloc in a stream thread would std::terminate the worker).
// 3 GiB admits any realistic single blob (a ~700M-param f32 model);
// SENDERS enforce the same bound loudly (error, not a silent remote
// connection drop), keeping the failure next to its cause.
constexpr uint32_t kMaxFrame = 3u << 30;  // shared with comm/host.py MAX_FRAME
constexpr uint16_t kMaxMetaLen = 4096;    // src / name fields

// callback: return 0 if consumed, nonzero to fall through to the queue
using msg_cb = int (*)(const char *name, const uint8_t *payload,
                       uint32_t len, const char *src);

struct Msg {
    uint32_t token = 0;
    uint8_t conn_type = 0;
    std::string src;
    std::string name;
    std::string payload;
};

bool read_exact(int fd, void *buf, size_t n) {
    auto *p = static_cast<char *>(buf);
    while (n > 0) {
        ssize_t r = ::read(fd, p, n);
        if (r <= 0) { return false; }
        p += r;
        n -= static_cast<size_t>(r);
    }
    return true;
}

bool write_all(int fd, const void *buf, size_t n) {
    const auto *p = static_cast<const char *>(buf);
    while (n > 0) {
        ssize_t r = ::write(fd, p, n);
        if (r <= 0) { return false; }
        p += r;
        n -= static_cast<size_t>(r);
    }
    return true;
}

void put_u16(std::string &out, uint16_t v) {
    char b[2] = {static_cast<char>(v & 0xff), static_cast<char>(v >> 8)};
    out.append(b, 2);
}

void put_u32(std::string &out, uint32_t v) {
    char b[4];
    for (int i = 0; i < 4; ++i) { b[i] = static_cast<char>((v >> (8 * i)) & 0xff); }
    out.append(b, 4);
}

uint16_t get_u16(const uint8_t *p) {
    return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

uint32_t get_u32(const uint8_t *p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
}

std::string encode_head(uint32_t token, uint8_t conn_type, const std::string &src,
                        const std::string &name, uint32_t payload_len) {
    std::string out;
    out.reserve(17 + src.size() + name.size());
    put_u32(out, kMagic);
    put_u32(out, token);
    out.push_back(static_cast<char>(conn_type));
    put_u16(out, static_cast<uint16_t>(src.size()));
    out.append(src);
    put_u16(out, static_cast<uint16_t>(name.size()));
    out.append(name);
    put_u32(out, payload_len);
    return out;
}

std::string encode_msg(uint32_t token, uint8_t conn_type, const std::string &src,
                       const std::string &name, const uint8_t *payload,
                       uint32_t payload_len) {
    std::string out = encode_head(token, conn_type, src, name, payload_len);
    if (payload_len > 0) { out.append(reinterpret_cast<const char *>(payload), payload_len); }
    return out;
}

// gather-write header + payload without staging them into one buffer (the
// payload copy dominated send cost for MB-scale gradient chunks)
bool writev_all(int fd, const void *head, size_t head_n, const void *payload,
                size_t payload_n) {
    struct iovec iov[2];
    iov[0].iov_base = const_cast<void *>(head);
    iov[0].iov_len = head_n;
    iov[1].iov_base = const_cast<void *>(payload);
    iov[1].iov_len = payload_n;
    int iovcnt = payload_n > 0 ? 2 : 1;
    struct iovec *cur = iov;
    while (iovcnt > 0) {
        ssize_t w = ::writev(fd, cur, iovcnt);
        if (w < 0) {
            if (errno == EINTR) { continue; }
            return false;
        }
        size_t n = static_cast<size_t>(w);
        while (iovcnt > 0 && n >= cur->iov_len) {
            n -= cur->iov_len;
            ++cur;
            --iovcnt;
        }
        if (iovcnt > 0 && n > 0) {
            cur->iov_base = static_cast<char *>(cur->iov_base) + n;
            cur->iov_len -= n;
        }
    }
    return true;
}

// header through payload_len; the payload itself is read separately so
// the stream loop can route it straight into a registered receive buffer
bool decode_head(int fd, Msg &m, uint32_t &payload_len) {
    uint8_t head[11];
    if (!read_exact(fd, head, sizeof(head))) { return false; }
    if (get_u32(head) != kMagic) { return false; }
    m.token = get_u32(head + 4);
    m.conn_type = head[8];
    uint16_t src_len = get_u16(head + 9);
    if (src_len > kMaxMetaLen) { return false; }
    m.src.resize(src_len);
    if (src_len && !read_exact(fd, &m.src[0], src_len)) { return false; }
    uint8_t nl[2];
    if (!read_exact(fd, nl, 2)) { return false; }
    uint16_t name_len = get_u16(nl);
    if (name_len > kMaxMetaLen) { return false; }
    m.name.resize(name_len);
    if (name_len && !read_exact(fd, &m.name[0], name_len)) { return false; }
    uint8_t pl[4];
    if (!read_exact(fd, pl, 4)) { return false; }
    payload_len = get_u32(pl);
    if (payload_len > kMaxFrame) { return false; }
    return true;
}

bool decode_msg(int fd, Msg &m) {
    uint32_t payload_len = 0;
    if (!decode_head(fd, m, payload_len)) { return false; }
    m.payload.resize(payload_len);
    if (payload_len && !read_exact(fd, &m.payload[0], payload_len)) { return false; }
    return true;
}

bool split_peer(const std::string &peer, std::string &host, uint16_t &port) {
    auto pos = peer.rfind(':');
    if (pos == std::string::npos) { return false; }
    host = peer.substr(0, pos);
    long p = ::strtol(peer.c_str() + pos + 1, nullptr, 10);
    if (p <= 0 || p > 65535) { return false; }
    port = static_cast<uint16_t>(p);
    return true;
}

// colocated peers talk over a unix domain socket (reference: sockfile
// /tmp/kungfu-run-<port>.sock, plan/addr.go:24; UseUnixSock=true const).
// Keyed by host AND port: loopback-alias multi-host simulations give the
// same port to one worker on every host, so port alone would alias peers.
// Sockfiles live in a per-uid mode-0700 directory (not world-writable
// /tmp directly) so another local user can neither squat nor intercept;
// must stay in lockstep with kungfu_tpu_torch/comm/host.py unix_sock_path.
// "" = no safe directory available (another user pre-created it, say);
// callers then skip the unix listener / fall back to TCP
std::string unix_sock_dir() {
    const char *env = ::getenv("KF_SOCK_DIR");
    std::string dir =
        env != nullptr && env[0] != '\0'
            ? std::string(env)
            : "/tmp/kf-tpu-" + std::to_string(::getuid());
    ::mkdir(dir.c_str(), 0700);
    // an existing dir must actually be OURS and private — mkdir's EEXIST
    // says nothing about who owns it (a squatter could pre-create it 0777
    // and then swap sockfiles under us)
    struct stat st;
    if (::lstat(dir.c_str(), &st) != 0 || !S_ISDIR(st.st_mode) ||
        st.st_uid != ::getuid() || (st.st_mode & 0077) != 0) {
        return "";
    }
    return dir;
}

std::string unix_sock_path(const std::string &host, uint16_t port) {
    std::string dir = unix_sock_dir();
    if (dir.empty()) { return ""; }
    return dir + "/" + host + "-" + std::to_string(port) + ".sock";
}

// deep socket buffers: a sender must be able to dump a full default
// chunk (1 MiB) and move on instead of context-switching every ~208 KiB
// (the kernel default) while the single-core receiver drains
void set_deep_buffers(int fd) {
    int sz = 4 << 20;
    ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof(sz));
    ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof(sz));
}

int connect_unix_once(const std::string &path, double timeout_s) {
    if (path.empty()) { return -1; }
    int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) { return -1; }
    set_deep_buffers(fd);
    if (timeout_s > 0) {
        struct timeval tv;
        tv.tv_sec = static_cast<long>(timeout_s);
        tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
        ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    }
    struct sockaddr_un addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    if (path.size() >= sizeof(addr.sun_path)) {
        ::close(fd);
        return -1;
    }
    std::strncpy(addr.sun_path, path.c_str(), sizeof(addr.sun_path) - 1);
    if (::connect(fd, reinterpret_cast<struct sockaddr *>(&addr), sizeof(addr)) != 0) {
        ::close(fd);
        return -1;
    }
    return fd;
}

int connect_once(const std::string &host, uint16_t port, double timeout_s) {
    // peer specs may carry hostnames, not just dotted quads (the Python
    // backend resolves via create_connection) — use getaddrinfo
    struct addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo *res = nullptr;
    if (::getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints, &res) != 0 ||
        res == nullptr) {
        return -1;
    }
    int fd = -1;
    for (struct addrinfo *ai = res; ai != nullptr; ai = ai->ai_next) {
        fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) { continue; }
        if (timeout_s > 0) {
            struct timeval tv;
            tv.tv_sec = static_cast<long>(timeout_s);
            tv.tv_usec = static_cast<long>((timeout_s - tv.tv_sec) * 1e6);
            ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
            ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        }
        if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) { break; }
        ::close(fd);
        fd = -1;
    }
    ::freeaddrinfo(res);
    if (fd < 0) { return -1; }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    set_deep_buffers(fd);
    return fd;
}

struct QueueKey {
    uint8_t conn_type;
    std::string src;
    std::string name;
    uint32_t token;  // 0 for non-collective
    bool operator<(const QueueKey &o) const {
        if (conn_type != o.conn_type) { return conn_type < o.conn_type; }
        if (src != o.src) { return src < o.src; }
        if (name != o.name) { return name < o.name; }
        return token < o.token;
    }
};

struct PoolEntry {
    std::mutex mu;      // serializes senders; held across connect retries
    std::mutex fd_mu;   // guards fd open/close handoff; never held long
    int fd_ = -1;       // guarded_by(fd_mu)
    // ::close happens only under fd_mu (or in the destructor, when the
    // last shared_ptr holder is by construction the only thread left);
    // reset_connections only ever shutdown()s under fd_mu, so it can
    // neither race a sender's close nor hit a kernel-recycled fd number
    ~PoolEntry() {
        if (fd_ >= 0) { ::close(fd_); }
    }
    void retire_fd() {
        std::lock_guard<std::mutex> lk(fd_mu);
        if (fd_ >= 0) {
            ::close(fd_);
            fd_ = -1;
        }
    }
    void install_fd(int new_fd) {
        std::lock_guard<std::mutex> lk(fd_mu);
        fd_ = new_fd;
    }
};

struct ConnSlot {
    int stream_fd_ = -1;  // guarded_by(conns_mu_)  (writes; the stream
                          // loop reads its own fd lock-free by design)
    std::thread thread;
    std::atomic<bool> done{false};
};

// a registered zero-copy receive destination (the reference's
// RecvInto/WaitRecvBuf, handler/collective.go:34-65, minus the wire flag:
// registration is receiver-side only, so the format stays compatible).
// Owned by the recv_into stack frame; the map holds a borrowed pointer.
struct RegBuf {
    uint8_t *buf;
    uint32_t cap;
    uint32_t got = 0;
    // 0 waiting, 1 filled, 2 failed (conn dropped mid-read), 3 claimed
    // (stream thread is writing into buf — the owner must not return).
    // While the RegBuf is REACHABLE through the regbufs_ map, state
    // transitions happen under q_mu_; once deregistered it is owned by
    // a single frame again.
    int state = 0;  // guarded_by(q_mu_)
};

class Channel {
  public:
    Channel(std::string self_spec, const std::string &bind_host, uint16_t port,
            uint32_t token, bool use_unix)
        : self_(std::move(self_spec)), token_(token), use_unix_(use_unix) {
        auto pos = self_.rfind(':');
        self_host_ = pos == std::string::npos ? self_ : self_.substr(0, pos);
        listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
        if (listen_fd_ < 0) { return; }
        int one = 1;
        ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
        struct sockaddr_in addr;
        std::memset(&addr, 0, sizeof(addr));
        addr.sin_family = AF_INET;
        addr.sin_port = htons(port);
        if (bind_host.empty() || bind_host == "0.0.0.0") {
            addr.sin_addr.s_addr = INADDR_ANY;
        } else if (::inet_pton(AF_INET, bind_host.c_str(), &addr.sin_addr) != 1) {
            ::close(listen_fd_);
            listen_fd_ = -1;
            return;
        }
        if (::bind(listen_fd_, reinterpret_cast<struct sockaddr *>(&addr),
                   sizeof(addr)) != 0 ||
            ::listen(listen_fd_, 128) != 0) {
            ::close(listen_fd_);
            listen_fd_ = -1;
            return;
        }
        if (port == 0) {
            // port 0: the kernel assigned one; this channel's peer spec
            // (and so every frame's src and its sockfile) carries it
            struct sockaddr_in got;
            socklen_t got_len = sizeof(got);
            if (::getsockname(listen_fd_, reinterpret_cast<struct sockaddr *>(&got),
                              &got_len) != 0) {
                ::close(listen_fd_);
                listen_fd_ = -1;
                return;
            }
            port = ntohs(got.sin_port);
            self_ = self_host_ + ":" + std::to_string(port);
        }
        port_ = port;
        if (use_unix_) {
            // composed server: a second listener on the colocated-peer
            // sockfile (reference runs TCP and unix listeners together,
            // rchannel/server/composed)
            unix_path_ = unix_sock_path(self_host_, port);
            if (unix_path_.empty()) { use_unix_ = false; }
        }
        // close_all() wakes blocked accept()s through this pipe: the
        // shutdown(listen_fd) trick only works for TCP listeners — a
        // blocked accept on an AF_UNIX listener is NOT woken by
        // shutdown on Linux, which left close_all() hanging forever
        // whenever the unix listener was idle (found by the TSan churn
        // stress).  accept loops poll {listener, wake_pipe} instead.
        if (::pipe(wake_pipe_) != 0) { wake_pipe_[0] = wake_pipe_[1] = -1; }
        if (use_unix_) {
            ::unlink(unix_path_.c_str());
            unix_listen_fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
            if (unix_listen_fd_ >= 0) {
                struct sockaddr_un ua;
                std::memset(&ua, 0, sizeof(ua));
                ua.sun_family = AF_UNIX;
                std::strncpy(ua.sun_path, unix_path_.c_str(), sizeof(ua.sun_path) - 1);
                if (::bind(unix_listen_fd_, reinterpret_cast<struct sockaddr *>(&ua),
                           sizeof(ua)) != 0 ||
                    ::listen(unix_listen_fd_, 128) != 0) {
                    ::close(unix_listen_fd_);
                    unix_listen_fd_ = -1;  // TCP-only; not fatal
                }
            }
        }
        running_ = true;
        accept_thread_ = std::thread([this] { accept_loop(listen_fd_, true); });
        if (unix_listen_fd_ >= 0) {
            unix_accept_thread_ =
                std::thread([this] { accept_loop(unix_listen_fd_, false); });
        }
    }

    bool ok() const { return listen_fd_ >= 0; }

    uint16_t port() const { return port_; }

    // RAII in-flight marker; declare FIRST in an entry point so its
    // release (and the close_all wakeup) runs after every lock is gone.
    // The count changes ONLY under q_mu_ — the same mutex close_all's
    // drain predicate evaluates under — so (a) an entry that raced past
    // the predicate load cannot be missed, and (b) the releasing thread
    // cannot touch a freed channel: while it holds q_mu_ for the
    // decrement, close_all is still inside its cv_ wait.  Entries are
    // REFUSED once running_ is false (`ok` = false; callers return
    // their closed status) — a late send must not dial out and install
    // fresh pool fds on a channel being torn down.
    struct ApiGuard {
        Channel *ch;
        bool ok;
        // force=true: count the entry even while closing (never refuse)
        // — for calls whose CLEANUP contract must hold during the close
        // window (recv_cancel: a registration may still be claimed by a
        // stream thread that close_all has not joined yet)
        explicit ApiGuard(Channel *c, bool force = false) : ch(c), ok(false) {
            std::lock_guard<std::mutex> lk(ch->q_mu_);
            if (!force && !ch->running_.load()) { return; }
            ++ch->api_inflight_;
            ok = true;
        }
        ~ApiGuard() {
            if (!ok) { return; }
            std::lock_guard<std::mutex> lk(ch->q_mu_);
            if (--ch->api_inflight_ == 0) { ch->cv_.notify_all(); }
        }
    };

    ~Channel() { close_all(); }

    void close_all() {
        {
            // running_ flips under q_mu_ and the wakeup is sent under it
            // too, so a receiver that checked running_ and is about to
            // wait cannot miss the shutdown notification
            std::lock_guard<std::mutex> lk(q_mu_);
            if (!running_.exchange(false)) {
                // never started or already closed; still reap a half-open fd
                if (listen_fd_ >= 0) { ::close(listen_fd_); listen_fd_ = -1; }
                return;
            }
            cv_.notify_all();
        }
        // wake the accept loops (pipe write covers the AF_UNIX listener,
        // which shutdown() does not wake; shutdown stays as belt and
        // braces for the TCP one), then wait until both threads have
        // exited so the loop can never accept() on an fd number the
        // kernel recycled for another socket
        if (wake_pipe_[1] >= 0) {
            char one = 1;
            (void)!::write(wake_pipe_[1], &one, 1);
        }
        ::shutdown(listen_fd_, SHUT_RDWR);
        if (unix_listen_fd_ >= 0) { ::shutdown(unix_listen_fd_, SHUT_RDWR); }
        if (accept_thread_.joinable()) { accept_thread_.join(); }
        if (unix_accept_thread_.joinable()) { unix_accept_thread_.join(); }
        ::close(listen_fd_);
        if (unix_listen_fd_ >= 0) {
            ::close(unix_listen_fd_);
            ::unlink(unix_path_.c_str());
            unix_listen_fd_ = -1;
        }
        {
            std::lock_guard<std::mutex> lk(conns_mu_);
            for (auto &slot : conns_) {
                if (slot->stream_fd_ >= 0) { ::shutdown(slot->stream_fd_, SHUT_RDWR); }
            }
        }
        // stream loops close their own fds on exit; join them all.
        // After the joins every thread that could touch conns_ (the
        // accept loops and the stream loops themselves) has exited, so
        // the clear is provably single-threaded — lock-free by design:
        for (auto &slot : conns_) {
            if (slot->thread.joinable()) { slot->thread.join(); }
        }
        conns_.clear();  // kflint: allow(lock-discipline)
        reset_connections_impl();  // running_ is false; the gated public
        // entry would refuse, but the pool must still be torn down
        listen_fd_ = -1;
        for (int i = 0; i < 2; ++i) {
            if (wake_pipe_[i] >= 0) {
                ::close(wake_pipe_[i]);
                wake_pipe_[i] = -1;
            }
        }
        // a blocked receiver woke with rc=2 (closed); wait until every
        // recv call AND every other in-flight API entry has actually
        // left before the caller may delete us
        std::unique_lock<std::mutex> lk(q_mu_);
        while (recv_inflight_ != 0 || api_inflight_ != 0) {
            if (cv_.wait_until(lk, wait_clock::now() +
                                       std::chrono::milliseconds(200)) ==
                std::cv_status::timeout) {
                // re-sweep: shut down any pool fd a racing send managed
                // to install anyway, so its blocked writev unblocks and
                // the in-flight call can drain
                lk.unlock();
                reset_connections_impl();
                lk.lock();
            }
        }
    }

    void set_token(uint32_t token) {
        ApiGuard api{this};
        if (!api.ok) { return; }
        std::lock_guard<std::mutex> lk(q_mu_);
        token_ = token;
        for (auto it = queues_.begin(); it != queues_.end();) {
            if (it->first.conn_type == kConnCollective && it->first.token < token) {
                it = queues_.erase(it);
            } else {
                ++it;
            }
        }
    }

    uint32_t token() const { return token_.load(); }

    void set_control_cb(msg_cb cb) { control_cb_ = cb; }
    void set_p2p_cb(msg_cb cb) { p2p_cb_ = cb; }

    // 0 ok, -1 unreachable, -3 payload over kMaxFrame
    int send(const std::string &peer, const std::string &name,
             const uint8_t *payload, uint32_t len, int conn_type, int retries) {
        ApiGuard api{this};
        if (!api.ok) { return -1; }  // closed: unreachable by definition
        if (len > kMaxFrame) { return -3; }
        std::string host;
        uint16_t port = 0;
        if (!split_peer(peer, host, port)) { return -1; }
        {
            std::lock_guard<std::mutex> lk(stats_mu_);
            egress_[peer] += len;
        }
        // header staged separately; the payload goes straight from the
        // caller's buffer to the kernel via writev (no MB-scale memcpy)
        std::string head = encode_head(token_.load(), static_cast<uint8_t>(conn_type),
                                       self_, name, len);
        std::shared_ptr<PoolEntry> entry;
        {
            std::lock_guard<std::mutex> lk(pool_mu_);
            auto &slot = pool_[peer];
            if (!slot) { slot = std::make_shared<PoolEntry>(); }
            entry = slot;
        }
        std::lock_guard<std::mutex> lk(entry->mu);
        // a connect that finishes after close_all's pool sweep must not
        // install a socket nothing will ever shut down (the close drain
        // would then hang behind a writev blocked on backpressure)
        auto install_open = [&](int fd) -> bool {
            if (!running_.load()) { ::close(fd); return false; }
            entry->install_fd(fd);
            return true;
        };
        if (entry->fd_ < 0) {
            int fd = connect_retry(host, port, retries);
            if (fd < 0 || !install_open(fd)) { return -1; }
        }
        if (!writev_all(entry->fd_, head.data(), head.size(), payload, len)) {
            // stale pooled socket (peer restarted): reconnect once.
            // retire before the (potentially long) reconnect so a
            // concurrent reset_connections sees fd=-1, not a dead number
            entry->retire_fd();
            int fd = connect_retry(host, port, retries);
            if (fd < 0 || !install_open(fd)) { return -1; }
            if (!writev_all(entry->fd_, head.data(), head.size(), payload, len)) {
                entry->retire_fd();
                return -1;
            }
        }
        return 0;
    }

    // 0 ok (out/out_len set, caller frees), 1 timeout, 2 closed.
    // timeout_s < 0 means wait forever (a huge finite value would
    // overflow duration_cast into a deadline in the past).
    int recv(const std::string &src, const std::string &name, int conn_type,
             double timeout_s, uint8_t **out, uint32_t *out_len) {
        QueueKey key{static_cast<uint8_t>(conn_type), src, name,
                     conn_type == kConnCollective ? token_.load() : 0};
        const bool forever = timeout_s < 0;
        std::unique_lock<std::mutex> lk(q_mu_);
        // close_all() blocks on this counter before the channel is freed
        ++recv_inflight_;
        struct Guard {
            Channel *ch;
            ~Guard() {
                if (--ch->recv_inflight_ == 0) { ch->cv_.notify_all(); }
            }
        } guard{this};
        auto deadline =
            wait_clock::now() +
            (forever ? wait_clock::duration::zero()
                     : std::chrono::duration_cast<wait_clock::duration>(
                           std::chrono::duration<double>(timeout_s)));
        for (;;) {
            auto it = queues_.find(key);
            if (it != queues_.end() && !it->second.empty()) {
                std::string payload = std::move(it->second.front());
                it->second.pop_front();
                // copy outside q_mu_: a multi-MB p2p blob must not
                // head-of-line block dispatch and every other recv
                lk.unlock();
                *out_len = static_cast<uint32_t>(payload.size());
                *out = static_cast<uint8_t *>(::malloc(payload.size() ? payload.size() : 1));
                std::memcpy(*out, payload.data(), payload.size());
                lk.lock();  // Guard's decrement runs under q_mu_
                return 0;
            }
            if (!running_.load()) { return 2; }
            if (forever) {
                cv_.wait(lk);
            } else if (cv_.wait_until(lk, deadline) == std::cv_status::timeout) {
                return 1;
            }
        }
    }

    // Pre-register a receive buffer for (src, name): the stream thread
    // writes the payload straight into rb->buf on arrival (zero-copy),
    // BEFORE the caller blocks in recv_await — so a sender that races
    // ahead of the receiver still lands in place instead of detouring
    // through the queue (allocation + two copies).  If a matching payload
    // is already queued it is consumed immediately (rb->state = 1).
    // 0 ok, 2 closed, -2 queued-size mismatch (payload left queued),
    // -3 duplicate registration for the key.
    // The caller MUST follow up with recv_await or recv_cancel on the
    // same rb — the map holds a raw pointer into the caller's frame.
    int recv_register(const std::string &src, const std::string &name,
                      int conn_type, RegBuf *rb) {
        ApiGuard api{this};
        if (!api.ok) { return 2; }  // closed
        QueueKey key{static_cast<uint8_t>(conn_type), src, name,
                     conn_type == kConnCollective ? token_.load() : 0};
        std::unique_lock<std::mutex> lk(q_mu_);
        if (!running_.load()) { return 2; }
        auto it = queues_.find(key);
        if (it != queues_.end() && !it->second.empty()) {
            if (it->second.front().size() != rb->cap) { return -2; }
            std::string payload = std::move(it->second.front());
            it->second.pop_front();
            // copy outside q_mu_ (an MB-scale memcpy under the global
            // queue lock would stall every stream thread); rb is not in
            // the map, so no other thread can touch it — single-owner
            // writes, deliberately outside the lock:
            lk.unlock();
            std::memcpy(rb->buf, payload.data(), payload.size());
            rb->got = rb->cap;
            rb->state = 1;  // kflint: allow(lock-discipline)
            return 0;
        }
        if (!regbufs_.emplace(key, rb).second) { return -3; }
        return 0;
    }

    // Abandon a registration made by recv_register (error-path cleanup).
    // Blocks while the stream thread holds a claim on the buffer — after
    // return, no live pointer to rb remains anywhere in the channel.
    void recv_cancel(const std::string &src, const std::string &name,
                     int conn_type, RegBuf *rb) {
        // forced: even mid-close a stream thread may hold a claim on rb
        // (state 3) until close_all joins it — returning early would let
        // the caller free rb under that live pointer
        ApiGuard api{this, /*force=*/true};
        QueueKey key{static_cast<uint8_t>(conn_type), src, name,
                     conn_type == kConnCollective ? token_.load() : 0};
        std::unique_lock<std::mutex> lk(q_mu_);
        while (rb->state == 3) { cv_.wait(lk); }
        auto it = regbufs_.find(key);
        if (it != regbufs_.end() && it->second == rb) { regbufs_.erase(it); }
    }

    // Wait for a buffer registered with recv_register to fill.
    // 0 ok, 1 timeout, 2 closed, -2 queued-size mismatch.  On ANY return
    // the registration is gone (no dangling pointer).
    int recv_await(const std::string &src, const std::string &name,
                   int conn_type, double timeout_s, RegBuf *rb,
                   uint32_t *got) {
        QueueKey key{static_cast<uint8_t>(conn_type), src, name,
                     conn_type == kConnCollective ? token_.load() : 0};
        const bool forever = timeout_s < 0;
        std::unique_lock<std::mutex> lk(q_mu_);
        ++recv_inflight_;
        struct Guard {
            Channel *ch;
            ~Guard() {
                if (--ch->recv_inflight_ == 0) { ch->cv_.notify_all(); }
            }
        } guard{this};
        auto deadline =
            wait_clock::now() +
            (forever ? wait_clock::duration::zero()
                     : std::chrono::duration_cast<wait_clock::duration>(
                           std::chrono::duration<double>(timeout_s)));
        auto deregister = [&] {
            auto it = regbufs_.find(key);
            if (it != regbufs_.end() && it->second == rb) { regbufs_.erase(it); }
        };
        for (;;) {
            // resolution order matters: while CLAIMED (state 3) the stream
            // thread is writing into buf and holds a pointer to the
            // caller's frame — nothing may return until the claim resolves
            if (rb->state == 1) {
                deregister();
                *got = rb->got;
                return 0;
            }
            if (rb->state == 2) {
                deregister();
                return 2;
            }
            if (rb->state == 0) {
                // a queued payload (arrived with a non-matching key state,
                // or a duplicate keyed send) wins over waiting
                auto it = queues_.find(key);
                if (it != queues_.end() && !it->second.empty()) {
                    deregister();
                    if (it->second.front().size() != rb->cap) { return -2; }
                    std::string payload = std::move(it->second.front());
                    it->second.pop_front();
                    lk.unlock();
                    std::memcpy(rb->buf, payload.data(), payload.size());
                    lk.lock();
                    *got = rb->cap;
                    return 0;
                }
                if (!running_.load()) {
                    deregister();
                    return 2;
                }
            }
            if (forever || rb->state == 3) {
                cv_.wait(lk);
            } else if (cv_.wait_until(lk, deadline) == std::cv_status::timeout) {
                if (rb->state == 0) {
                    deregister();
                    return 1;
                }
            }
        }
    }

    // Zero-copy receive into a caller-owned buffer (the reference's
    // registered-buffer RecvInto, handler/collective.go:34-65).
    // 0 ok, 1 timeout, 2 closed, -2 size mismatch (payload left queued —
    // caller falls back to recv()).
    int recv_into(const std::string &src, const std::string &name,
                  int conn_type, double timeout_s, uint8_t *buf, uint32_t cap,
                  uint32_t *got) {
        QueueKey key{static_cast<uint8_t>(conn_type), src, name,
                     conn_type == kConnCollective ? token_.load() : 0};
        const bool forever = timeout_s < 0;
        std::unique_lock<std::mutex> lk(q_mu_);
        ++recv_inflight_;
        struct Guard {
            Channel *ch;
            ~Guard() {
                if (--ch->recv_inflight_ == 0) { ch->cv_.notify_all(); }
            }
        } guard{this};
        auto deadline =
            wait_clock::now() +
            (forever ? wait_clock::duration::zero()
                     : std::chrono::duration_cast<wait_clock::duration>(
                           std::chrono::duration<double>(timeout_s)));
        RegBuf rb{buf, cap};
        bool registered = false;
        auto deregister = [&] {
            if (registered) {
                auto it = regbufs_.find(key);
                if (it != regbufs_.end() && it->second == &rb) { regbufs_.erase(it); }
                registered = false;
            }
        };
        for (;;) {
            // resolution order matters: while CLAIMED (state 3) the stream
            // thread is writing into buf and holds a pointer to this stack
            // frame — nothing (queue hits, timeouts, shutdown) may return
            // until the claim resolves to filled/failed.
            if (rb.state == 1) {
                deregister();
                *got = rb.got;
                return 0;
            }
            if (rb.state == 2) {
                // sender connection died mid-fill: the buffer holds a torn
                // payload and the message is gone — surface as closed
                deregister();
                return 2;
            }
            if (rb.state == 0) {
                // a queued payload (arrived before registration, or a
                // duplicate keyed send) wins over waiting
                auto it = queues_.find(key);
                if (it != queues_.end() && !it->second.empty()) {
                    deregister();
                    if (it->second.front().size() != cap) { return -2; }
                    std::string payload = std::move(it->second.front());
                    it->second.pop_front();
                    lk.unlock();
                    std::memcpy(buf, payload.data(), payload.size());
                    lk.lock();
                    *got = cap;
                    return 0;
                }
                if (!running_.load()) {
                    deregister();
                    return 2;
                }
                if (!registered) {
                    registered = regbufs_.emplace(key, &rb).second;
                }
            }
            if (forever || rb.state == 3) {
                cv_.wait(lk);
            } else if (cv_.wait_until(lk, deadline) == std::cv_status::timeout) {
                if (rb.state == 0) {
                    deregister();
                    return 1;
                }
            }
        }
    }

    int ping(const std::string &peer, double timeout_s) {
        ApiGuard api{this};
        if (!api.ok) { return 1; }  // closed: not reachable
        std::string host;
        uint16_t port = 0;
        if (!split_peer(peer, host, port)) { return -1; }
        int fd = connect_once(host, port, timeout_s);
        if (fd < 0) { return -1; }
        std::string data =
            encode_msg(token_.load(), kConnPing, self_, "ping", nullptr, 0);
        Msg reply;
        int rc = (write_all(fd, data.data(), data.size()) && decode_msg(fd, reply))
                     ? 0
                     : -1;
        ::close(fd);
        return rc;
    }

    void reset_connections() {
        ApiGuard api{this};
        if (!api.ok) { return; }  // close_all resets the pool itself
        reset_connections_impl();
    }

    void reset_connections_impl() {
        std::vector<std::shared_ptr<PoolEntry>> entries;
        {
            std::lock_guard<std::mutex> lk(pool_mu_);
            for (auto &kv : pool_) { entries.push_back(kv.second); }
            pool_.clear();
        }
        // shutdown (not close) without taking the per-entry *send* lock:
        // a sender stuck retrying toward a dead peer must not block the
        // reset.  fd_mu makes the read-and-shutdown atomic against a
        // sender's close-and-replace, and the actual close stays with
        // the last shared_ptr holder (PoolEntry destructor)
        for (auto &e : entries) {
            std::lock_guard<std::mutex> lk(e->fd_mu);
            if (e->fd_ >= 0) { ::shutdown(e->fd_, SHUT_RDWR); }
        }
    }

    // newline-separated "src bytes" ingress totals; returns bytes written
    int ingress_snapshot(char *out, int cap) {
        ApiGuard api{this};
        if (!api.ok) { return 0; }
        return counter_snapshot(ingress_, out, cap);
    }

    // egress totals — counted in send() so traffic from the native engine
    // executor (which never crosses the python send wrapper) is included
    int egress_snapshot(char *out, int cap) {
        ApiGuard api{this};
        if (!api.ok) { return 0; }
        return counter_snapshot(egress_, out, cap);
    }

    int counter_snapshot(const std::map<std::string, uint64_t> &counters,
                         char *out, int cap) {
        std::string s;
        {
            std::lock_guard<std::mutex> lk(stats_mu_);
            for (auto &kv : counters) {
                s += kv.first + " " + std::to_string(kv.second) + "\n";
            }
        }
        int n = static_cast<int>(s.size());
        if (n >= cap) { return -n; }  // caller retries with bigger buffer
        std::memcpy(out, s.data(), s.size());
        out[n] = '\0';
        return n;
    }

  private:
    int connect_retry(const std::string &host, uint16_t port, int retries) {
        const bool colocated = use_unix_ && host == self_host_;
        for (int i = 0; i < retries && running_.load(); ++i) {
            if (colocated) {
                int fd = connect_unix_once(unix_sock_path(host, port), 10.0);
                if (fd >= 0) { return fd; }
                // fall through: peer may be TCP-only (e.g. python backend
                // with unix disabled)
            }
            int fd = connect_once(host, port, 10.0);
            if (fd >= 0) { return fd; }
            // reference: 500 x 200ms (config.go:16-18)
            std::this_thread::sleep_for(std::chrono::milliseconds(200));
        }
        return -1;
    }

    void accept_loop(int lfd, bool is_tcp) {
        while (running_.load()) {
            // poll before accept: the wake pipe is the portable shutdown
            // signal (a blocked accept on an AF_UNIX listener survives
            // shutdown()); the byte is never drained, so one write wakes
            // both accept loops
            struct pollfd pfds[2];
            pfds[0].fd = lfd;
            pfds[0].events = POLLIN;
            pfds[1].fd = wake_pipe_[0];
            pfds[1].events = POLLIN;
            int nfds = wake_pipe_[0] >= 0 ? 2 : 1;
            int pr = ::poll(pfds, nfds, wake_pipe_[0] >= 0 ? -1 : 200);
            if (!running_.load()) { return; }
            if (pr <= 0 || (pfds[0].revents & POLLIN) == 0) { continue; }
            int fd = ::accept(lfd, nullptr, nullptr);
            if (fd < 0) {
                if (!running_.load()) { return; }
                continue;
            }
            if (is_tcp) {
                int one = 1;
                ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
            }
            set_deep_buffers(fd);
            {
                std::lock_guard<std::mutex> lk(conns_mu_);
                // reap finished connections so short-lived clients (pings
                // arrive on a fresh connection each) don't grow the
                // registry — their fds were closed by their stream loops
                for (auto it = conns_.begin(); it != conns_.end();) {
                    if ((*it)->done.load()) {
                        (*it)->thread.join();
                        it = conns_.erase(it);
                    } else {
                        ++it;
                    }
                }
                auto slot = std::make_shared<ConnSlot>();
                slot->stream_fd_ = fd;
                slot->thread = std::thread([this, slot] { stream_loop(slot.get()); });
                conns_.push_back(std::move(slot));
            }
        }
    }

    // one pooled client sends many messages per connection (reference
    // Stream(), handler.go:30-41); the stream loop owns its fd's close.
    // The close runs under conns_mu_ — the same lock close_all() holds
    // while shutdown()ing open fds — so a shutdown can never hit an fd
    // number the kernel has already recycled for an unrelated socket.
    void stream_loop(ConnSlot *slot) {
        // any exception (bad_alloc on a huge-but-legal frame, etc.) drops
        // THIS connection instead of std::terminate'ing the whole worker
        try {
            Msg m;
            uint32_t plen = 0;
            while (running_.load() && decode_head(slot->stream_fd_, m, plen)) {
                bool consumed = false;
                if (!read_payload(slot->stream_fd_, m, plen, consumed)) { break; }
                if (!consumed) { dispatch(m, slot->stream_fd_); }
            }
        } catch (...) {
        }
        {
            std::lock_guard<std::mutex> lk(conns_mu_);
            ::close(slot->stream_fd_);
            slot->stream_fd_ = -1;
        }
        // done flips only after the fd is retired; the accept loop joins
        // (reaps) exclusively done slots, so it never blocks on a thread
        // that is itself waiting for conns_mu_
        slot->done.store(true);
    }

    // read the payload off the socket — directly into a registered
    // receive buffer when one matches (zero-copy path: no allocation, no
    // queue hop, no malloc'd copy for the ctypes boundary), else into
    // m.payload for normal dispatch.  Runs on the stream thread.
    bool read_payload(int fd, Msg &m, uint32_t plen, bool &consumed) {
        consumed = false;
        // p2p registrations (the gossip pull path) key on token 0 — p2p
        // traffic is not epoch-fenced (matches recv/recv_into/QueueKey)
        if (m.conn_type == kConnCollective || m.conn_type == kConnPeerToPeer) {
            std::unique_lock<std::mutex> lk(q_mu_);
            if (m.conn_type != kConnCollective || m.token >= token_.load()) {
                auto it = regbufs_.find(QueueKey{
                    m.conn_type, m.src, m.name,
                    m.conn_type == kConnCollective ? m.token : 0});
                if (it != regbufs_.end() && it->second->state == 0 &&
                    it->second->cap == plen) {
                    RegBuf *rb = it->second;
                    rb->state = 3;  // claimed: owner must wait for us
                    lk.unlock();
                    bool ok = plen == 0 || read_exact(fd, rb->buf, plen);
                    lk.lock();
                    rb->got = plen;
                    rb->state = ok ? 1 : 2;
                    cv_.notify_all();
                    {
                        std::lock_guard<std::mutex> slk(stats_mu_);
                        ingress_[m.src] += plen;
                    }
                    consumed = true;
                    return ok;
                }
            }
        }
        m.payload.resize(plen);
        return plen == 0 || read_exact(fd, &m.payload[0], plen);
    }

    void dispatch(Msg &m, int fd) {
        {
            std::lock_guard<std::mutex> lk(stats_mu_);
            ingress_[m.src] += m.payload.size();
        }
        if (m.conn_type == kConnPing) {
            std::string reply =
                encode_msg(token_.load(), kConnPing, self_, m.name, nullptr, 0);
            write_all(fd, reply.data(), reply.size());
            return;
        }
        if (m.conn_type == kConnControl && control_cb_ != nullptr) {
            if (control_cb_(m.name.c_str(),
                            reinterpret_cast<const uint8_t *>(m.payload.data()),
                            static_cast<uint32_t>(m.payload.size()),
                            m.src.c_str()) == 0) {
                return;
            }
        }
        if (m.conn_type == kConnPeerToPeer && p2p_cb_ != nullptr &&
            m.name.rfind("req.", 0) == 0) {
            if (p2p_cb_(m.name.c_str(),
                        reinterpret_cast<const uint8_t *>(m.payload.data()),
                        static_cast<uint32_t>(m.payload.size()),
                        m.src.c_str()) == 0) {
                return;
            }
        }
        std::lock_guard<std::mutex> lk(q_mu_);
        uint32_t qtoken = 0;
        if (m.conn_type == kConnCollective) {
            // fencing: queue under the sender's epoch; a stale-epoch
            // arrival (older than current) can never be read — drop it.
            // A future-epoch arrival is preserved (the sender already
            // moved on and will not retry).
            if (m.token < token_.load()) { return; }
            qtoken = m.token;
        }
        queues_[QueueKey{m.conn_type, m.src, m.name, qtoken}].push_back(
            std::move(m.payload));
        cv_.notify_all();
    }

    std::string self_;
    std::string self_host_;
    uint16_t port_ = 0;
    std::atomic<uint32_t> token_;
    std::atomic<bool> running_{false};
    bool use_unix_ = false;
    int listen_fd_ = -1;
    int unix_listen_fd_ = -1;
    int wake_pipe_[2] = {-1, -1};  // close_all -> accept_loop wakeup
    std::string unix_path_;
    std::thread accept_thread_;
    std::thread unix_accept_thread_;

    std::mutex conns_mu_;
    std::vector<std::shared_ptr<ConnSlot>> conns_;  // guarded_by(conns_mu_)

    std::mutex q_mu_;
    std::condition_variable cv_;
    std::map<QueueKey, std::deque<std::string>> queues_;  // guarded_by(q_mu_)
    std::map<QueueKey, RegBuf *> regbufs_;  // guarded_by(q_mu_)  borrowed ptrs
    int recv_inflight_ = 0;  // guarded_by(q_mu_)
    // in-flight count for API entries NOT covered by recv_inflight_
    // (send / recv_register / recv_cancel / ping / ...): close_all()
    // drains BOTH before the caller may delete the channel — a thread
    // still inside send() while another thread closed the channel was
    // a use-after-free (gossip puller vs. peer teardown).  Guarded by
    // q_mu_ (see ApiGuard for why atomicity alone is not enough).
    int api_inflight_ = 0;  // guarded_by(q_mu_)

    std::mutex pool_mu_;
    std::map<std::string, std::shared_ptr<PoolEntry>> pool_;  // guarded_by(pool_mu_)

    std::mutex stats_mu_;
    std::map<std::string, uint64_t> ingress_;  // guarded_by(stats_mu_)
    std::map<std::string, uint64_t> egress_;   // guarded_by(stats_mu_)

    msg_cb control_cb_ = nullptr;
    msg_cb p2p_cb_ = nullptr;
};

// ---------------------------------------------------------------------
// Native graph-collective executor — the reference's runGraphs hot loop
// (srcs/go/kungfu/session/session.go:222-321) run entirely in C++: chunk
// split (np.array_split-compatible so python/native peers interoperate),
// chunk→graph-pair hash, recv/accumulate(send) reduce stage, broadcast
// stage.  Receives use the channel's registered-buffer path; accumulation
// calls the native reduce kernel (reduce.cpp, same .so).  One ctypes
// crossing per COLLECTIVE instead of per message.
// ---------------------------------------------------------------------

struct MeGraph {
    // me-centric adjacency of one (reduce, bcast) pair
    bool r_selfloop = false;
    std::vector<int32_t> r_prevs, r_nexts;
    bool b_selfloop = false;
    std::vector<int32_t> b_prevs, b_nexts;
};

uint64_t engine_name_hash(const std::string &name) {
    // must match kungfu_tpu_torch.comm.engine.name_based_hash (sum of ord^2)
    uint64_t h = 0;
    for (unsigned char c : name) { h += uint64_t(c) * uint64_t(c); }
    return h;
}

}  // namespace

extern "C" {

// from reduce.cpp (same shared object)
int kf_transform2(void *dst, const void *src, int64_t n, int32_t dtype,
                  int32_t op);
}

namespace {

// returns 0 ok, 1 timeout, 2 closed, -1 bad args, -4 reduce error
int engine_run_chunk(Channel *ch, const std::vector<std::string> &peers,
                     const MeGraph &g, uint8_t *chunk, uint64_t chunk_bytes,
                     int64_t elems, int32_t dtype, int32_t op,
                     const std::string &tag, double timeout_s,
                     std::vector<uint8_t> &scratch) {
    const std::string rtag = tag + ".r";
    const std::string btag = tag + ".b";
    uint32_t got = 0;
    const bool have = g.r_selfloop;  // chunk already holds our contribution
    const size_t nprev = g.r_prevs.size();

    // pre-register reduce-phase receives before touching the wire: a
    // peer that sends before we get around to its recv lands straight in
    // its target buffer instead of detouring through the queue (an
    // allocation plus two full copies per miss).  Registration runs a
    // SLIDING WINDOW of kRegWindow buffers — high-fan-in graphs (a STAR
    // root at np=64) would otherwise hold O(fan_in * chunk) scratch;
    // the window keeps the zero-copy overlap with O(1) extra memory.
    constexpr size_t kRegWindow = 4;
    std::vector<RegBuf> rbs(nprev);
    std::vector<uint8_t *> tgt(nprev, nullptr);
    const size_t n_scratch = std::min(nprev, kRegWindow);
    if (scratch.size() < n_scratch * chunk_bytes) {
        scratch.resize(n_scratch * chunk_bytes);
    }
    std::vector<uint8_t *> free_slots;
    for (size_t s_i = 0; s_i < n_scratch; ++s_i) {
        free_slots.push_back(scratch.data() + s_i * chunk_bytes);
    }
    int rc = 0;
    size_t reg_hi = 0;  // prevs [await_i, reg_hi) are registered
    auto register_next = [&]() -> int {
        auto &rb = rbs[reg_hi];
        if (!have && reg_hi == 0) {
            tgt[reg_hi] = chunk;  // first contribution lands in place
        } else {
            tgt[reg_hi] = free_slots.back();
            free_slots.pop_back();
        }
        rb.buf = tgt[reg_hi];
        rb.cap = static_cast<uint32_t>(chunk_bytes);
        int r = ch->recv_register(peers[g.r_prevs[reg_hi]], rtag,
                                  kConnCollective, &rb);
        if (r == 0) { ++reg_hi; }
        return r;
    };
    auto cancel_tail = [&](size_t from) {
        // error path: every outstanding registration must be withdrawn
        // before the stack frame holding the RegBufs unwinds
        for (size_t j = from; j < reg_hi; ++j) {
            ch->recv_cancel(peers[g.r_prevs[j]], rtag, kConnCollective, &rbs[j]);
        }
    };
    while (reg_hi < nprev) {
        const bool needs_slot = have || reg_hi > 0;  // else lands in chunk
        if (needs_slot && free_slots.empty()) { break; }
        rc = register_next();
        if (rc != 0) {
            cancel_tail(0);
            return rc == -3 ? -1 : rc;
        }
    }
    for (size_t i = 0; i < nprev; ++i) {
        rc = ch->recv_await(peers[g.r_prevs[i]], rtag, kConnCollective,
                            timeout_s, &rbs[i], &got);
        if (rc != 0) {
            cancel_tail(i + 1);
            return rc;
        }
        if (tgt[i] != chunk) {
            if (kf_transform2(chunk, tgt[i], elems, dtype, op) != 0) {
                cancel_tail(i + 1);
                return -4;
            }
            free_slots.push_back(tgt[i]);  // slot drained, reusable
        }
        while (reg_hi < nprev && !free_slots.empty()) {
            rc = register_next();
            if (rc != 0) {
                cancel_tail(i + 1);
                return rc == -3 ? -1 : rc;
            }
        }
    }
    for (int32_t nxt : g.r_nexts) {
        if (ch->send(peers[nxt], rtag, chunk,
                     static_cast<uint32_t>(chunk_bytes), kConnCollective,
                     500) != 0) {
            return 2;
        }
    }
    // the broadcast receive reuses the chunk buffer, so it registers only
    // after the reduce sends complete (our bcast parent cannot have the
    // result earlier anyway — it transitively needs our contribution)
    if (!g.b_selfloop && !g.b_prevs.empty()) {
        rc = ch->recv_into(peers[g.b_prevs[0]], btag, kConnCollective,
                           timeout_s, chunk,
                           static_cast<uint32_t>(chunk_bytes), &got);
        if (rc != 0) { return rc; }
    }
    for (int32_t nxt : g.b_nexts) {
        if (ch->send(peers[nxt], btag, chunk,
                     static_cast<uint32_t>(chunk_bytes), kConnCollective,
                     500) != 0) {
            return 2;
        }
    }
    return 0;
}

}  // namespace

extern "C" {

void *kf_host_create(const char *self_spec, const char *bind_host,
                     uint32_t port, uint32_t token, int use_unix) {
    auto *ch = new Channel(self_spec, bind_host ? bind_host : "",
                           static_cast<uint16_t>(port), token, use_unix != 0);
    if (!ch->ok()) {
        delete ch;
        return nullptr;
    }
    return ch;
}

// the port the channel's TCP listener is bound to (the one the kernel
// assigned when kf_host_create was given port 0)
uint32_t kf_host_port(void *h) { return static_cast<Channel *>(h)->port(); }

void kf_host_close(void *h) {
    auto *ch = static_cast<Channel *>(h);
    ch->close_all();
    delete ch;
}

// stop the channel without freeing it: every blocked call wakes with the
// closed status and has left when this returns, and later entries are
// refused; kf_host_close then frees it (a second addition to the copy)
void kf_host_shutdown(void *h) { static_cast<Channel *>(h)->close_all(); }

void kf_host_set_token(void *h, uint32_t token) {
    static_cast<Channel *>(h)->set_token(token);
}

uint32_t kf_host_token(void *h) { return static_cast<Channel *>(h)->token(); }

int kf_host_send(void *h, const char *peer, const char *name,
                 const uint8_t *payload, uint32_t len, int conn_type,
                 int retries) {
    return static_cast<Channel *>(h)->send(peer, name, payload, len, conn_type,
                                           retries);
}

int kf_host_recv(void *h, const char *src, const char *name, int conn_type,
                 double timeout_s, uint8_t **out, uint32_t *out_len) {
    return static_cast<Channel *>(h)->recv(src, name, conn_type, timeout_s, out,
                                           out_len);
}

void kf_host_buf_free(uint8_t *p) { ::free(p); }

// 0 ok, 1 timeout, 2 closed, -2 size mismatch (payload queued; fall back
// to kf_host_recv)
int kf_host_recv_into(void *h, const char *src, const char *name,
                      int conn_type, double timeout_s, uint8_t *buf,
                      uint32_t cap, uint32_t *got) {
    return static_cast<Channel *>(h)->recv_into(src, name, conn_type,
                                                timeout_s, buf, cap, got);
}

// Staged zero-copy receive for request/response pulls: register the
// destination buffer BEFORE dispatching the request, so the response
// streams socket->buf even when it races the receiver (recv_into
// registers after the caller's send — a fast responder then detours
// through the queue, costing an alloc + two copies on a ~100 MiB blob).
// Returns an opaque handle for kf_host_recv_finish / kf_host_recv_abort,
// or null with *rc_out set: 2 closed, -2 queued-size-mismatch (payload
// left queued; fall back to kf_host_recv), -3 duplicate registration.
// rc_out 0 with a non-null handle may ALREADY be filled (a queued
// payload of the right size was consumed at register time) — finish
// resolves either way.  The buffer MUST stay alive and unwritten until
// finish/abort returns.
void *kf_host_recv_begin(void *h, const char *src, const char *name,
                         int conn_type, uint8_t *buf, uint32_t cap,
                         int *rc_out) {
    auto *rb = new RegBuf{buf, cap};
    int rc = static_cast<Channel *>(h)->recv_register(src, name, conn_type, rb);
    *rc_out = rc;
    if (rc != 0) {
        delete rb;
        return nullptr;
    }
    return rb;
}

// 0 ok (*got set), 1 timeout, 2 closed, -2 queued-size-mismatch.  The
// handle is consumed on every return (recv_await guarantees no live
// pointer remains in the channel).
int kf_host_recv_finish(void *h, const char *src, const char *name,
                        int conn_type, double timeout_s, void *rbp,
                        uint32_t *got) {
    auto *rb = static_cast<RegBuf *>(rbp);
    int rc = static_cast<Channel *>(h)->recv_await(src, name, conn_type,
                                                   timeout_s, rb, got);
    delete rb;
    return rc;
}

// Abandon a registration (e.g. the request send failed); consumes the
// handle after any in-flight claim on the buffer resolves.
void kf_host_recv_abort(void *h, const char *src, const char *name,
                        int conn_type, void *rbp) {
    auto *rb = static_cast<RegBuf *>(rbp);
    static_cast<Channel *>(h)->recv_cancel(src, name, conn_type, rb);
    delete rb;
}

int kf_host_ping(void *h, const char *peer, double timeout_s) {
    return static_cast<Channel *>(h)->ping(peer, timeout_s);
}

void kf_host_reset_connections(void *h) {
    static_cast<Channel *>(h)->reset_connections();
}

void kf_host_set_control_cb(void *h, msg_cb cb) {
    static_cast<Channel *>(h)->set_control_cb(cb);
}

void kf_host_set_p2p_cb(void *h, msg_cb cb) {
    static_cast<Channel *>(h)->set_p2p_cb(cb);
}

int kf_host_ingress_snapshot(void *h, char *out, int cap) {
    return static_cast<Channel *>(h)->ingress_snapshot(out, cap);
}

int kf_host_egress_snapshot(void *h, char *out, int cap) {
    return static_cast<Channel *>(h)->egress_snapshot(out, cap);
}

// Chunked graph allreduce over the channel, fully native (one ctypes
// crossing per collective).  buf is reduced IN PLACE.
//
//   peers_csv:    "host:port,..." in rank order
//   graph_data:   per pair [r_selfloop, n_rp, rp..., n_rn, rn...,
//                           b_selfloop, n_bp, bp..., n_bn, bn...] (i32),
//                 me-centric adjacency; pair_offsets[n_pairs+1] slices it
//   hash_mode:    0 = chunk-index round robin, 1 = name hash (shard.go)
//   stats_out:    [n_pairs*2] += (bytes, seconds) per pair (may be null)
//
// returns 0 ok, 1 timeout, 2 closed/unreachable, -1 bad args, -4 reduce
int kf_engine_all_reduce(void *h, const char *peers_csv, uint8_t *buf,
                         uint64_t nbytes, int64_t elem_size, int32_t dtype,
                         int32_t op, const int32_t *graph_data,
                         const int32_t *pair_offsets, int32_t n_pairs,
                         const char *tag, int32_t hash_mode,
                         uint64_t chunk_size, double timeout_s,
                         int32_t max_threads, double *stats_out) {
    auto *ch = static_cast<Channel *>(h);
    if (n_pairs <= 0 || elem_size <= 0 || nbytes % elem_size != 0) {
        return -1;
    }
    std::vector<std::string> peers;
    {
        std::string s(peers_csv);
        size_t pos = 0;
        while (pos <= s.size()) {
            size_t c = s.find(',', pos);
            if (c == std::string::npos) { c = s.size(); }
            if (c > pos) { peers.emplace_back(s.substr(pos, c - pos)); }
            pos = c + 1;
        }
    }
    std::vector<MeGraph> graphs(n_pairs);
    for (int32_t p = 0; p < n_pairs; ++p) {
        const int32_t *d = graph_data + pair_offsets[p];
        MeGraph &g = graphs[p];
        size_t i = 0;
        g.r_selfloop = d[i++] != 0;
        for (int32_t k = d[i++]; k > 0; --k) { g.r_prevs.push_back(d[i++]); }
        for (int32_t k = d[i++]; k > 0; --k) { g.r_nexts.push_back(d[i++]); }
        g.b_selfloop = d[i++] != 0;
        for (int32_t k = d[i++]; k > 0; --k) { g.b_prevs.push_back(d[i++]); }
        for (int32_t k = d[i++]; k > 0; --k) { g.b_nexts.push_back(d[i++]); }
    }

    // chunk boundaries must replicate np.array_split over ELEMENTS so
    // python-backend peers slice identically
    const uint64_t total_elems = nbytes / uint64_t(elem_size);
    uint64_t n_chunks = (nbytes + chunk_size - 1) / chunk_size;
    if (n_chunks == 0) { n_chunks = 1; }
    if (n_chunks > total_elems && total_elems > 0) { n_chunks = total_elems; }
    const uint64_t base = total_elems / n_chunks;
    const uint64_t rem = total_elems % n_chunks;

    std::mutex stats_mu;
    std::atomic<int> first_err{0};
    const std::string tag_s(tag);
    const uint64_t name_h = engine_name_hash(tag_s);

    auto run_chunk = [&](uint64_t ci, uint64_t elem_off, uint64_t elems,
                         std::vector<uint8_t> &scratch) {
        const int32_t gi = static_cast<int32_t>(
            (hash_mode == 1 ? name_h : ci) % uint64_t(n_pairs));
        uint8_t *cbuf = buf + elem_off * uint64_t(elem_size);
        const uint64_t cbytes = elems * uint64_t(elem_size);
        auto t0 = std::chrono::steady_clock::now();
        int rc = engine_run_chunk(ch, peers, graphs[gi], cbuf, cbytes,
                                  static_cast<int64_t>(elems), dtype, op,
                                  tag_s + ".c" + std::to_string(ci), timeout_s,
                                  scratch);
        if (rc != 0) {
            int expect = 0;
            first_err.compare_exchange_strong(expect, rc);
            return;
        }
        if (stats_out != nullptr) {
            double dt = std::chrono::duration<double>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
            std::lock_guard<std::mutex> lk(stats_mu);
            stats_out[2 * gi] += double(cbytes);
            stats_out[2 * gi + 1] += dt;
        }
    };

    if (n_chunks == 1) {
        std::vector<uint8_t> scratch;
        run_chunk(0, 0, total_elems, scratch);
        return first_err.load();
    }
    const int nthreads = std::max(
        1, std::min<int>(max_threads > 0 ? max_threads : 8,
                         static_cast<int>(n_chunks)));
    std::atomic<uint64_t> next{0};
    std::vector<std::thread> workers;
    workers.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) {
        workers.emplace_back([&] {
            std::vector<uint8_t> scratch;
            for (;;) {
                uint64_t ci = next.fetch_add(1);
                if (ci >= n_chunks) { return; }
                uint64_t off = ci < rem ? ci * (base + 1)
                                        : rem * (base + 1) + (ci - rem) * base;
                uint64_t elems = ci < rem ? base + 1 : base;
                run_chunk(ci, off, elems, scratch);
            }
        });
    }
    for (auto &w : workers) { w.join(); }
    return first_err.load();
}

}  // extern "C"
