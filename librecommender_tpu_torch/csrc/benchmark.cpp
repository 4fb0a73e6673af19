// Native load generator for the serving tier (reference analog:
// libserving/actix_serving/src/bin/benchmark.rs) — the Python client is
// GIL-bound and measures itself; this drives N threads of sequential
// requests over persistent HTTP/1.1 connections and reports req/s and
// latency percentiles from the client side.
//
// The port's copy of the JAX package's
// librecommender_tpu/serving/native_server/benchmark.cpp, kept in step
// with it.
//
// Usage: benchmark <host> <port> <path> <n_threads> <n_requests> [max_user]
//   e.g. benchmark 127.0.0.1 8080 /knn/recommend 8 100000 6000

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

int connect_to(const char* host, int port) {
  const int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  ::inet_pton(AF_INET, host, &addr.sin_addr);
  if (::connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

// Send one request and read one full response (Content-Length framed).
bool roundtrip(int fd, const std::string& req, std::string& buf) {
  size_t off = 0;
  while (off < req.size()) {
    const auto n = ::send(fd, req.data() + off, req.size() - off, MSG_NOSIGNAL);
    if (n <= 0) return false;
    off += n;
  }
  buf.clear();
  char tmp[8192];
  size_t body_start = std::string::npos, content_len = 0;
  while (true) {
    if (body_start != std::string::npos &&
        buf.size() >= body_start + content_len)
      return true;
    const auto n = ::recv(fd, tmp, sizeof(tmp), 0);
    if (n <= 0) return false;
    buf.append(tmp, n);
    if (body_start == std::string::npos) {
      const auto p = buf.find("\r\n\r\n");
      if (p != std::string::npos) {
        body_start = p + 4;
        auto cl = buf.find("Content-Length:");
        if (cl != std::string::npos)
          content_len = std::strtoul(buf.c_str() + cl + 15, nullptr, 10);
      }
    }
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 6) {
    std::cerr << "usage: benchmark <host> <port> <path> <n_threads> "
                 "<n_requests> [max_user]\n";
    return 1;
  }
  const char* host = argv[1];
  const int port = std::atoi(argv[2]);
  const std::string path = argv[3];
  const int n_threads = std::atoi(argv[4]);
  const long n_requests = std::atol(argv[5]);
  const long max_user = argc > 6 ? std::atol(argv[6]) : 1000;

  std::atomic<long> remaining(n_requests);
  std::atomic<long> failures(0);
  std::vector<std::vector<double>> lat(n_threads);
  std::vector<std::thread> threads;
  const auto t0 = std::chrono::steady_clock::now();
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t] {
      std::mt19937 rng(t + 1);
      int fd = connect_to(host, port);
      std::string buf;
      lat[t].reserve(n_requests / n_threads + 1);
      while (remaining.fetch_sub(1) > 0) {
        if (fd < 0) fd = connect_to(host, port);
        if (fd < 0) {
          failures.fetch_add(1);
          continue;
        }
        const long uid = (long)(rng() % max_user);
        const std::string body =
            "{\"user\": " + std::to_string(uid) + ", \"n_rec\": 10}";
        const std::string req =
            "POST " + path + " HTTP/1.1\r\nHost: x\r\nContent-Type: "
            "application/json\r\nContent-Length: " +
            std::to_string(body.size()) + "\r\n\r\n" + body;
        const auto s = std::chrono::steady_clock::now();
        if (!roundtrip(fd, req, buf)) {
          ::close(fd);
          fd = -1;
          failures.fetch_add(1);
          continue;
        }
        lat[t].push_back(
            std::chrono::duration<double>(std::chrono::steady_clock::now() - s)
                .count());
      }
      if (fd >= 0) ::close(fd);
    });
  }
  for (auto& th : threads) th.join();
  const double wall =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  std::vector<double> all;
  for (auto& v : lat) all.insert(all.end(), v.begin(), v.end());
  if (all.empty()) {
    std::cerr << "no successful requests\n";
    return 1;
  }
  std::sort(all.begin(), all.end());
  auto pct = [&](double p) {
    return all[std::min(all.size() - 1, (size_t)(p * all.size()))] * 1e3;
  };
  std::cout << "{\"req_per_s\": " << (double)all.size() / wall
            << ", \"p50_ms\": " << pct(0.50) << ", \"p99_ms\": " << pct(0.99)
            << ", \"n_ok\": " << all.size() << ", \"n_fail\": " << failures
            << "}\n";
  return 0;
}
