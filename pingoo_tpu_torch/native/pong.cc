// pong: minimal keep-alive HTTP upstream for benchmarks and tests —
// the native equivalent of the reference's pong test server
// (/root/reference/pong/pong.rs: "a Simple HTTP server to test
// Pingoo's capabilities"). Single-threaded epoll, fixed 200 response,
// keep-alive; fast enough that the proxy under test, not the upstream,
// is always the bottleneck.
//
// Usage: pong <port>   (binds 127.0.0.1; prints {"listening": port})

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

const char kResponse[] =
    "HTTP/1.1 200 OK\r\ncontent-type: text/plain\r\n"
    "content-length: 4\r\nconnection: keep-alive\r\n\r\npong";

struct Conn {
  std::string inbuf;
  std::string outbuf;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <port>\n", argv[0]);
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);
  int port = std::atoi(argv[1]);

  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(lfd, 2048) != 0) {
    std::perror("bind/listen");
    return 1;
  }
  if (port == 0) {
    socklen_t alen = sizeof(addr);
    getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
    port = ntohs(addr.sin_port);
  }

  int ep = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = lfd;
  epoll_ctl(ep, EPOLL_CTL_ADD, lfd, &ev);
  std::unordered_map<int, Conn> conns;

  std::printf("{\"listening\": %d}\n", port);
  std::fflush(stdout);

  while (true) {
    epoll_event events[256];
    int n = epoll_wait(ep, events, 256, -1);
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      if (fd == lfd) {
        while (true) {
          int cfd = accept4(lfd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          conns[cfd] = Conn();
          epoll_event ce{};
          ce.events = EPOLLIN;
          ce.data.fd = cfd;
          epoll_ctl(ep, EPOLL_CTL_ADD, cfd, &ce);
        }
        continue;
      }
      auto it = conns.find(fd);
      if (it == conns.end()) continue;
      Conn& c = it->second;
      bool closed = false;
      if (events[i].events & (EPOLLHUP | EPOLLERR)) {
        closed = true;
      } else if (events[i].events & EPOLLIN) {
        char buf[16384];
        ssize_t r;
        while ((r = read(fd, buf, sizeof(buf))) > 0)
          c.inbuf.append(buf, static_cast<size_t>(r));
        if (r == 0) closed = true;
        // GET/HEAD requests only: each head is one request.
        size_t he;
        while ((he = c.inbuf.find("\r\n\r\n")) != std::string::npos) {
          c.inbuf.erase(0, he + 4);
          c.outbuf.append(kResponse, sizeof(kResponse) - 1);
        }
        if (c.inbuf.size() > 65536) closed = true;  // junk flood
      }
      if (!closed && !c.outbuf.empty()) {
        ssize_t w = send(fd, c.outbuf.data(), c.outbuf.size(), MSG_NOSIGNAL);
        if (w > 0) c.outbuf.erase(0, static_cast<size_t>(w));
        else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK)
          closed = true;
        epoll_event ce{};
        ce.events = EPOLLIN | (c.outbuf.empty() ? 0 : EPOLLOUT);
        ce.data.fd = fd;
        epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ce);
      }
      if (closed) {
        epoll_ctl(ep, EPOLL_CTL_DEL, fd, nullptr);
        close(fd);
        conns.erase(it);
      }
    }
  }
  return 0;
}
