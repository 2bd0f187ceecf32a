// TSan stress driver for the port's native transport (transport.cpp), a
// copy of kungfu_tpu/native/stress.cpp.
//
// Channel open/send/close churn as a standalone, fully TSan-instrumented
// binary: teardown racing in-flight sends and receives, connection resets
// mid-traffic, a receiver parked forever woken by the close.  (A TSan
// runtime must be present at process start, so this is a binary, not a
// library loaded into python.)  Differences from the reference's: each
// channel binds a port the kernel assigns (kf_host_create with port 0,
// read back through kf_host_port), so concurrent runs never collide, and
// the teardown race goes through kf_host_shutdown before kf_host_close,
// as the port's Python wrapper does; SIGPIPE is ignored, as in python.
//
// Build and run: kungfu_tpu_torch.native.build_stress() gives the path of
// _build/kfstress-tsan; run it with the number of rounds (default 4).  A
// clean run exits 0, prints "all rounds clean" on stderr and no
// "WARNING: ThreadSanitizer".

#include <atomic>
#include <csignal>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void *kf_host_create(const char *self_spec, const char *bind_host,
                     uint32_t port, uint32_t token, int use_unix);
void kf_host_close(void *h);
void kf_host_shutdown(void *h);
uint32_t kf_host_port(void *h);
void kf_host_set_token(void *h, uint32_t token);
int kf_host_send(void *h, const char *peer, const char *name,
                 const uint8_t *payload, uint32_t len, int conn_type,
                 int retries);
int kf_host_recv(void *h, const char *src, const char *name, int conn_type,
                 double timeout_s, uint8_t **out, uint32_t *out_len);
void kf_host_buf_free(uint8_t *p);
int kf_host_recv_into(void *h, const char *src, const char *name,
                      int conn_type, double timeout_s, uint8_t *buf,
                      uint32_t cap, uint32_t *got);
int kf_host_ping(void *h, const char *peer, double timeout_s);
void kf_host_reset_connections(void *h);
}

namespace {

constexpr int kConnCollective = 3;
constexpr int kConnPeerToPeer = 4;
constexpr uint32_t kMsgBytes = 8192;
constexpr int kMsgsPerThread = 12;

std::atomic<int> failures{0};

void fail(const char *what) {
    std::fprintf(stderr, "stress: FAIL %s\n", what);
    failures.fetch_add(1);
}

std::string spec(uint16_t port) {
    return "127.0.0.1:" + std::to_string(port);
}

void sender(void *ch, const std::string &peer, int tid, int conn_type) {
    std::vector<uint8_t> payload(kMsgBytes, static_cast<uint8_t>(tid));
    std::string name = "m" + std::to_string(tid);
    for (int i = 0; i < kMsgsPerThread; ++i) {
        if (kf_host_send(ch, peer.c_str(), name.c_str(), payload.data(),
                         kMsgBytes, conn_type, 50) != 0) {
            fail("send");
            return;
        }
    }
}

void receiver(void *ch, const std::string &src, int tid, int conn_type) {
    std::string name = "m" + std::to_string(tid);
    for (int i = 0; i < kMsgsPerThread; ++i) {
        if (i % 2 == 0) {
            uint8_t *out = nullptr;
            uint32_t n = 0;
            int rc = kf_host_recv(ch, src.c_str(), name.c_str(), conn_type,
                                  20.0, &out, &n);
            if (rc != 0 || n != kMsgBytes) {
                fail("recv");
                return;
            }
            kf_host_buf_free(out);
        } else {
            std::vector<uint8_t> buf(kMsgBytes);
            uint32_t got = 0;
            int rc = kf_host_recv_into(ch, src.c_str(), name.c_str(),
                                       conn_type, 20.0, buf.data(), kMsgBytes,
                                       &got);
            if (rc != 0 || got != kMsgBytes) {
                fail("recv_into");
                return;
            }
        }
    }
}

// late traffic toward a channel being closed: sends must fail cleanly
// (refused/unreachable), never crash or wedge the closing thread
void late_sender(void *ch, const std::string &peer, std::atomic<bool> *stop) {
    uint8_t b[64] = {0};
    while (!stop->load()) {
        kf_host_send(ch, peer.c_str(), "late", b, sizeof(b), kConnPeerToPeer, 1);
    }
}

// a receiver parked forever: close_all must wake it with rc=2 (closed)
void parked_receiver(void *ch, const std::string &src) {
    uint8_t *out = nullptr;
    uint32_t n = 0;
    int rc = kf_host_recv(ch, src.c_str(), "never", kConnPeerToPeer, -1.0,
                          &out, &n);
    if (rc == 0) { kf_host_buf_free(out); }
}

void run_round(int round) {
    const bool use_unix = round % 2 == 1;
    // port 0: each channel binds a port the kernel assigns and takes it
    // into its own spec
    void *a = kf_host_create(spec(0).c_str(), "127.0.0.1", 0, 0, use_unix);
    void *b = kf_host_create(spec(0).c_str(), "127.0.0.1", 0, 0, use_unix);
    if (a == nullptr || b == nullptr) {
        fail("create");
        if (a != nullptr) { kf_host_close(a); }
        if (b != nullptr) { kf_host_close(b); }
        return;
    }
    const std::string sa = spec(static_cast<uint16_t>(kf_host_port(a)));
    const std::string sb = spec(static_cast<uint16_t>(kf_host_port(b)));

    std::vector<std::thread> ts;
    for (int t = 0; t < 4; ++t) {
        const int ct = t % 2 == 0 ? kConnCollective : kConnPeerToPeer;
        ts.emplace_back(sender, a, sb, t, ct);
        ts.emplace_back(receiver, b, sa, t, ct);
    }
    for (int t = 4; t < 6; ++t) {
        ts.emplace_back(sender, b, sa, t, kConnPeerToPeer);
        ts.emplace_back(receiver, a, sb, t, kConnPeerToPeer);
    }
    ts.emplace_back([&] {
        for (int i = 0; i < 4; ++i) {
            if (kf_host_ping(a, sb.c_str(), 5.0) != 0) { fail("ping"); }
            std::this_thread::sleep_for(std::chrono::milliseconds(5));
        }
    });
    // connection churn mid-traffic: pooled sender fds get shutdown()
    // under the senders' feet, forcing the stale-socket reconnect path
    ts.emplace_back([&] {
        for (int i = 0; i < 3; ++i) {
            std::this_thread::sleep_for(std::chrono::milliseconds(10));
            kf_host_reset_connections(a);
            kf_host_reset_connections(b);
        }
    });
    for (auto &t : ts) { t.join(); }

    // teardown race: close B under live late traffic + a parked recv
    std::atomic<bool> stop{false};
    std::thread late(late_sender, a, sb, &stop);
    std::thread parked(parked_receiver, b, sa);
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    // must drain in-flight API entries and wake the recv; the free waits
    // until both have left, as the Python wrapper's close does
    kf_host_shutdown(b);
    stop.store(true);
    late.join();
    parked.join();
    kf_host_close(b);
    kf_host_close(a);
}

}  // namespace

int main(int argc, char **argv) {
    // the library runs inside python, which ignores SIGPIPE, and writes to
    // sockets a closing peer may have reset: the binary must ignore it too
    // (the reference's binary dies of it in its first teardown race)
    std::signal(SIGPIPE, SIG_IGN);
    int rounds = argc > 1 ? std::atoi(argv[1]) : 4;
    for (int r = 0; r < rounds; ++r) {
        run_round(r);
        std::fprintf(stderr, "stress: round %d ok\n", r);
    }
    if (failures.load() != 0) {
        std::fprintf(stderr, "stress: %d failure(s)\n", failures.load());
        return 1;
    }
    std::fprintf(stderr, "stress: all rounds clean\n");
    return 0;
}
