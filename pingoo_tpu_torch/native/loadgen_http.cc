// HTTP load generator for the end-to-end WAF bench: drives the native
// httpd front door (loadgen_http -> httpd -> verdict ring -> sidecar ->
// 403/proxy -> pong) over real sockets with keep-alive connections and
// reports throughput + added-latency percentiles as one JSON line.
//
// Every request is timestamped at send and at response completion, so
// the measured latency covers the WHOLE added path: head parse, ring
// enqueue, sidecar batch, device verdict, verdict application, and (for
// clean traffic) the proxied upstream round trip.
//
// Usage: loadgen_http <port> <n_requests> <concurrency> <attack_permille>
//
// Attack paths match pingoo_tpu/utils/crs.py corpus staples
// (`/etc/passwd`, `\.\./`) so the 403 path is exercised at the given
// permille; 403s close the connection (the data plane's canned
// responses are connection: close) and the generator reconnects.

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

const char* kCleanPaths[] = {
    "/api/v1/users?page=2", "/index.html", "/static/app.9f3c2.js",
    "/blog/2026/07/scaling-wafs", "/products/widget-2000?sort=price",
};
// Request-line-legal attack shapes (no raw spaces) hitting CRS corpus
// staples that appear even in small generated rulesets (utils/crs.py
// XSS cores: `(?i)<script`, `(?i)eval\(`).
const char* kAttackPaths[] = {
    "/page?x=<script>alert(1)</script>",
    "/?b=eval(atob('x'))",
};

struct Conn {
  int fd = -1;
  std::string inbuf;
  std::string outreq;   // pending request bytes
  double sent_at = 0;
  bool in_flight = false;
  bool expect_close = false;
  long long content_left = -1;  // -1: head not parsed yet
};

struct Stats {
  long long sent = 0, done = 0, blocked = 0, errors = 0;
  std::vector<double> lat;
};

int connect_nonblock(uint16_t port) {
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 &&
      errno != EINPROGRESS) {
    close(fd);
    return -1;
  }
  return fd;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s <port> <n_requests> <concurrency> "
                 "<attack_permille>\n",
                 argv[0]);
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);
  uint16_t port = static_cast<uint16_t>(std::atoi(argv[1]));
  long long n_requests = std::atoll(argv[2]);
  int concurrency = std::atoi(argv[3]);
  int permille = std::atoi(argv[4]);

  int ep = epoll_create1(0);
  std::vector<Conn> conns(concurrency);
  Stats st;
  st.lat.reserve(static_cast<size_t>(n_requests));
  long long seq = 0;

  auto arm = [&](int slot, uint32_t events) {
    epoll_event e{};
    e.events = events;
    e.data.u32 = static_cast<uint32_t>(slot);
    epoll_ctl(ep, EPOLL_CTL_MOD, conns[slot].fd, &e);
  };

  auto open_conn = [&](int slot) -> bool {
    Conn& c = conns[slot];
    c = Conn();
    c.fd = connect_nonblock(port);
    if (c.fd < 0) return false;
    epoll_event e{};
    e.events = EPOLLOUT | EPOLLIN;
    e.data.u32 = static_cast<uint32_t>(slot);
    epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &e);
    return true;
  };

  auto queue_request = [&](int slot) {
    Conn& c = conns[slot];
    if (c.in_flight || st.sent >= n_requests) return;
    bool attack = (seq % 1000) < permille;
    const char* path =
        attack ? kAttackPaths[seq % 2] : kCleanPaths[seq % 5];
    ++seq;
    c.outreq = std::string("GET ") + path +
               " HTTP/1.1\r\nhost: bench.test\r\nuser-agent: "
               "pingoo-bench/1.0\r\n\r\n";
    c.sent_at = now_s();
    c.in_flight = true;
    c.content_left = -1;
    c.inbuf.clear();
    ++st.sent;
  };

  for (int i = 0; i < concurrency; ++i) {
    if (!open_conn(i)) return 1;
    queue_request(i);
  }

  double deadline = now_s() + 120.0;
  double t_start = now_s();
  while (st.done + st.errors < n_requests && now_s() < deadline) {
    epoll_event events[256];
    int n = epoll_wait(ep, events, 256, 50);
    for (int i = 0; i < n; ++i) {
      int slot = static_cast<int>(events[i].data.u32);
      Conn& c = conns[slot];
      if (c.fd < 0) continue;
      bool reset = false;
      if (events[i].events & (EPOLLHUP | EPOLLERR)) reset = true;

      if (!reset && (events[i].events & EPOLLOUT) && !c.outreq.empty()) {
        ssize_t w = send(c.fd, c.outreq.data(), c.outreq.size(), MSG_NOSIGNAL);
        if (w > 0) c.outreq.erase(0, static_cast<size_t>(w));
        else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK)
          reset = true;
      }
      if (!reset && (events[i].events & EPOLLIN)) {
        char buf[16384];
        ssize_t r;
        while ((r = read(c.fd, buf, sizeof(buf))) > 0)
          c.inbuf.append(buf, static_cast<size_t>(r));
        if (r == 0) reset = true;  // handled after response parse
        // Parse one response: head + content-length body.
        if (c.in_flight && c.content_left == -1) {
          size_t he = c.inbuf.find("\r\n\r\n");
          if (he != std::string::npos) {
            std::string head = c.inbuf.substr(0, he + 4);
            c.inbuf.erase(0, he + 4);
            int status = 0;
            if (head.size() > 12) status = atoi(head.c_str() + 9);
            c.content_left = 0;
            size_t p = head.find("ontent-length:");
            if (p != std::string::npos)
              c.content_left = atoll(head.c_str() + p + 14);
            c.expect_close =
                head.find("connection: close") != std::string::npos;
            if (status == 403) ++st.blocked;
            if (status == 0) {
              ++st.errors;
              c.in_flight = false;
              reset = true;
            }
          }
        }
        if (c.in_flight && c.content_left >= 0) {
          long long take = std::min<long long>(
              c.content_left, static_cast<long long>(c.inbuf.size()));
          c.inbuf.erase(0, static_cast<size_t>(take));
          c.content_left -= take;
          if (c.content_left == 0) {
            st.lat.push_back(now_s() - c.sent_at);
            ++st.done;
            c.in_flight = false;
            if (c.expect_close) {
              reset = true;
            } else {
              queue_request(slot);
            }
          }
        }
      }
      if (reset) {
        if (c.in_flight) {
          // Count an aborted in-flight request as an error unless the
          // close raced a completed parse above.
          ++st.errors;
          c.in_flight = false;
        }
        epoll_ctl(ep, EPOLL_CTL_DEL, c.fd, nullptr);
        close(c.fd);
        c.fd = -1;
        if (st.sent < n_requests) {
          if (open_conn(slot)) queue_request(slot);
        }
        continue;
      }
      if (c.fd >= 0)
        arm(slot, EPOLLIN | (c.outreq.empty() ? 0 : EPOLLOUT));
    }
  }
  double elapsed = now_s() - t_start;

  std::sort(st.lat.begin(), st.lat.end());
  auto pct = [&](double q) -> double {
    if (st.lat.empty()) return 0;
    size_t idx = static_cast<size_t>(q * (st.lat.size() - 1));
    return st.lat[idx] * 1000.0;
  };
  std::printf(
      "{\"completed\": %lld, \"blocked\": %lld, \"errors\": %lld, "
      "\"elapsed_s\": %.3f, \"req_per_s\": %.1f, \"p50_ms\": %.3f, "
      "\"p90_ms\": %.3f, \"p99_ms\": %.3f}\n",
      st.done, st.blocked, st.errors, elapsed,
      elapsed > 0 ? st.done / elapsed : 0.0, pct(0.50), pct(0.90),
      pct(0.99));
  return st.done > 0 ? 0 : 1;
}
