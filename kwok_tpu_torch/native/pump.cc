// kwok_tpu native HTTP pump: batched pipelined unary requests.
//
// The engine's patch egress and the soak rig's load generation are
// request-per-object HTTP (the Kubernetes API has no batch verb), so at
// O(10k) objects/s the per-request client cost dominates a Python sender —
// especially on small hosts where engine, loader and apiserver share
// cores. This pump issues a whole batch of prepared (method, path, body)
// requests over a small pool of persistent connections, pipelining within
// each connection (write side streams all requests in large buffers; read
// side consumes responses in order), entirely outside the GIL.
//
// Protocol assumptions (valid for kube-apiservers and the mock): HTTP/1.1
// keep-alive, responses carry Content-Length or chunked bodies, response
// bodies are discarded (the engine learns outcomes from the watch echo;
// only status codes are reported back).
//
// Failure contract: if a connection dies mid-batch, every unsent/unread
// request on it gets status 0 and the connection is re-established on the
// next call; the Python caller decides whether to retry.
//
// Build: part of libkwokcodec.so (see native/__init__.py _build).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Conn {
  int fd = -1;
};

struct Pump {
  std::string host;
  int port = 0;
  std::vector<Conn> conns;
  std::string header_extra;  // e.g. "Authorization: Bearer ...\r\n"
  // send-path attribution (ISSUE 11): cumulative wall ns split between
  // the request-writing side and the response-reading side, summed
  // across connections (they overlap, so write+read can exceed batch).
  // Two clock reads per connection per BATCH — amortized over hundreds
  // of requests, so the stats are always on.
  std::atomic<uint64_t> batches{0};
  std::atomic<uint64_t> requests{0};
  std::atomic<uint64_t> batch_ns{0};
  std::atomic<uint64_t> write_ns{0};
  std::atomic<uint64_t> read_ns{0};
};

uint64_t pump_now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

std::mutex g_pumps_mu;
std::map<int64_t, Pump*> g_pumps;
int64_t g_next_id = 1;

int dial(const std::string& host, int port) {
  struct addrinfo hints;
  memset(&hints, 0, sizeof hints);
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  char portbuf[16];
  snprintf(portbuf, sizeof portbuf, "%d", port);
  if (getaddrinfo(host.c_str(), portbuf, &hints, &res) != 0) return -1;
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    // a stalled (not dead) server must fail the batch, not wedge the
    // engine's egress forever — the Python client this replaces had a
    // per-request timeout; timed-out requests report status 0
    struct timeval tv{60, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  }
  return fd;
}

bool send_all(int fd, const char* data, size_t n) {
  while (n > 0) {
    ssize_t w = send(fd, data, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    data += w;
    n -= (size_t)w;
  }
  return true;
}

struct Slices {
  const char* blob;
  const int64_t* off;
  const char* ptr(int64_t i) const { return blob + off[i]; }
  int64_t len(int64_t i) const { return off[i + 1] - off[i]; }
};

// Streaming response reader over a buffered connection.
struct RespReader {
  int fd;
  std::string buf;
  size_t pos = 0;

  bool fill() {
    char tmp[65536];
    ssize_t n = recv(fd, tmp, sizeof tmp, 0);
    if (n <= 0) return false;
    if (pos > (1u << 20) && pos * 2 > buf.size()) {
      buf.erase(0, pos);
      pos = 0;
    }
    buf.append(tmp, n);
    return true;
  }

  // reads until the delimiter appears at/after pos; returns index or npos
  size_t find(const char* delim) {
    size_t at;
    while ((at = buf.find(delim, pos)) == std::string::npos) {
      if (!fill()) return std::string::npos;
    }
    return at;
  }

  bool need(size_t n) {
    while (buf.size() - pos < n) {
      if (!fill()) return false;
    }
    return true;
  }

  // Parses one response; returns status code or 0 on connection error.
  int read_response() {
    size_t hdr_end = find("\r\n\r\n");
    if (hdr_end == std::string::npos) return 0;
    std::string head = buf.substr(pos, hdr_end - pos);
    pos = hdr_end + 4;
    int code = 0;
    size_t sp = head.find(' ');
    if (sp != std::string::npos) code = atoi(head.c_str() + sp + 1);
    // locate framing headers (case-insensitive)
    long content_len = -1;
    bool chunked = false;
    size_t lpos = 0;
    while (lpos < head.size()) {
      size_t e = head.find("\r\n", lpos);
      if (e == std::string::npos) e = head.size();
      std::string line = head.substr(lpos, e - lpos);
      lpos = e + 2;
      size_t colon = line.find(':');
      if (colon == std::string::npos) continue;
      std::string k = line.substr(0, colon);
      for (auto& c : k) c = (char)tolower((unsigned char)c);
      std::string v = line.substr(colon + 1);
      size_t a = v.find_first_not_of(" \t");
      if (a != std::string::npos) v = v.substr(a);
      if (k == "content-length") content_len = atol(v.c_str());
      else if (k == "transfer-encoding" && v.rfind("chunked", 0) == 0)
        chunked = true;
    }
    if (chunked) {
      while (true) {
        size_t le = find("\r\n");
        if (le == std::string::npos) return 0;
        long sz = strtol(buf.c_str() + pos, nullptr, 16);
        pos = le + 2;
        if (!need((size_t)sz + 2)) return 0;
        pos += (size_t)sz + 2;
        if (sz == 0) break;
      }
    } else if (content_len > 0) {
      if (!need((size_t)content_len)) return 0;
      pos += (size_t)content_len;
    }
    return code;
  }
};

// Appends the COMPLETE wire frame (request line + headers + body) of
// request i to `out` — the one pluggable piece of run_conn, so the
// classic 4-slice batch and the fused template-emit batch (codec.cc
// kwok_emit_pods -> kwok_pump_send2) share every byte of the
// connection/pipelining/failure machinery.
using FrameFn = std::function<void(std::string&, int32_t)>;

void run_conn(Pump* p, size_t ci, const FrameFn& frame,
              const std::vector<int32_t>& idxs, int32_t* status_out) {
  Conn& c = p->conns[ci];
  if (c.fd < 0) c.fd = dial(p->host, p->port);
  if (c.fd < 0) {
    for (int32_t i : idxs) status_out[i] = 0;
    return;
  }

  // writer thread streams all requests; this thread reads responses
  bool write_ok = true;
  std::thread writer([&] {
    uint64_t w0 = pump_now_ns();
    [&] {
      std::string out;
      out.reserve(1 << 20);
      for (int32_t i : idxs) {
        frame(out, i);
        if (out.size() >= (1 << 20)) {
          if (!send_all(c.fd, out.data(), out.size())) {
            write_ok = false;
            return;
          }
          out.clear();
        }
      }
      if (!out.empty() && !send_all(c.fd, out.data(), out.size()))
        write_ok = false;
    }();
    p->write_ns.fetch_add(pump_now_ns() - w0, std::memory_order_relaxed);
  });

  uint64_t r0 = pump_now_ns();
  RespReader rr{c.fd};
  size_t done = 0;
  for (; done < idxs.size(); done++) {
    int code = rr.read_response();
    if (code == 0) break;
    status_out[idxs[done]] = code;
  }
  p->read_ns.fetch_add(pump_now_ns() - r0, std::memory_order_relaxed);
  writer.join();
  if (done < idxs.size() || !write_ok) {
    for (size_t i = done; i < idxs.size(); i++) status_out[idxs[i]] = 0;
    close(c.fd);
    c.fd = -1;
  }
}

// ONE copy of the handle-lookup contract (nullptr = unknown handle, the
// callers' -1): every entry point resolves its Pump* here, exactly once.
Pump* lookup_pump(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_pumps_mu);
  auto it = g_pumps.find(handle);
  return it == g_pumps.end() ? nullptr : it->second;
}

// Shared batch body of kwok_pump_send / kwok_pump_send2: shard indices
// round-robin across the pool, run the connection threads, account
// stats, count 2xx. `p` is the caller's already-resolved pump.
int64_t pump_send_batch(Pump* p, int32_t n, const FrameFn& frame,
                        int32_t* status_out) {
  uint64_t b0 = pump_now_ns();

  size_t nconn = p->conns.size();
  std::vector<std::vector<int32_t>> shards(nconn);
  for (int32_t i = 0; i < n; i++) shards[i % nconn].push_back(i);

  std::vector<std::thread> threads;
  for (size_t ci = 0; ci < nconn; ci++) {
    if (shards[ci].empty()) continue;
    threads.emplace_back(run_conn, p, ci, std::cref(frame),
                         std::cref(shards[ci]), status_out);
  }
  for (auto& t : threads) t.join();
  p->batches.fetch_add(1, std::memory_order_relaxed);
  p->requests.fetch_add((uint64_t)n, std::memory_order_relaxed);
  p->batch_ns.fetch_add(pump_now_ns() - b0, std::memory_order_relaxed);

  int64_t ok = 0;
  for (int32_t i = 0; i < n; i++)
    if (status_out[i] >= 200 && status_out[i] < 300) ok++;
  return ok;
}

// One full request frame; the path is spliced from up to three pieces
// (prefix + per-request path + suffix — send2's "{base}{path}{suffix}").
void append_frame(std::string& out, const std::string& host,
                  const std::string& extra, const char* method,
                  int64_t method_len, const char* path0, int64_t path0_len,
                  const char* path, int64_t path_len,
                  const char* path2, int64_t path2_len, const char* ctype,
                  int64_t ctype_len, const char* body, int64_t body_len) {
  char clen[64];
  out.append(method, method_len);
  out += ' ';
  if (path0_len) out.append(path0, path0_len);
  out.append(path, path_len);
  if (path2_len) out.append(path2, path2_len);
  out += " HTTP/1.1\r\nHost: ";
  out += host;
  out += "\r\nContent-Type: ";
  if (ctype_len > 0) out.append(ctype, ctype_len);
  else out += "application/json";
  out += "\r\n";
  out += extra;
  int n = snprintf(clen, sizeof clen, "Content-Length: %lld\r\n\r\n",
                   (long long)body_len);
  out.append(clen, n);
  out.append(body, body_len);
}

}  // namespace

extern "C" {

int64_t kwok_pump_open(const char* host, int32_t port, int32_t nconn,
                       const char* header_extra) {
  Pump* p = new Pump;
  p->host = host;
  p->port = port;
  p->conns.resize(nconn > 0 ? nconn : 1);
  if (header_extra && header_extra[0]) p->header_extra = header_extra;
  std::lock_guard<std::mutex> lk(g_pumps_mu);
  int64_t id = g_next_id++;
  g_pumps[id] = p;
  return id;
}

// Issues n requests split round-robin across the pool; blocks until every
// response is read (or its connection died). status_out[i] = HTTP code, or
// 0 for connection failure. Returns the count of codes in [200, 300).
int64_t kwok_pump_send(int64_t handle, int32_t n,
                       const char* method_blob, const int64_t* method_off,
                       const char* path_blob, const int64_t* path_off,
                       const char* ctype_blob, const int64_t* ctype_off,
                       const char* body_blob, const int64_t* body_off,
                       int32_t* status_out) {
  Pump* p = lookup_pump(handle);
  if (!p) return -1;
  Slices method{method_blob, method_off};
  Slices path{path_blob, path_off};
  Slices ctype{ctype_blob, ctype_off};
  Slices body{body_blob, body_off};
  FrameFn frame = [&](std::string& out, int32_t i) {
    append_frame(out, p->host, p->header_extra, method.ptr(i),
                 method.len(i), nullptr, 0, path.ptr(i), path.len(i),
                 nullptr, 0, ctype.ptr(i), ctype.len(i), body.ptr(i),
                 body.len(i));
  };
  return pump_send_batch(p, n, frame, status_out);
}

// Single-method batch over a shared path prefix/suffix and ONE content
// type: "{method} {base}{path[i]}{suffix}" with body[i] — the wire shape
// of the engine's emit batches (every request is a status PATCH), built
// without per-request method/ctype marshalling. Called by codec.cc's
// fused kwok_emit_pods; also exported for direct use.
int64_t kwok_pump_send2(int64_t handle, int32_t n, const char* method,
                        const char* base, int64_t base_len,
                        const char* path_blob, const int64_t* path_off,
                        const char* suffix, int64_t suffix_len,
                        const char* ctype, int64_t ctype_len,
                        const char* body_blob, const int64_t* body_off,
                        int32_t* status_out) {
  Pump* p = lookup_pump(handle);
  if (!p) return -1;
  Slices path{path_blob, path_off};
  Slices body{body_blob, body_off};
  int64_t method_len = (int64_t)strlen(method);
  FrameFn frame = [&](std::string& out, int32_t i) {
    append_frame(out, p->host, p->header_extra, method, method_len, base,
                 base_len, path.ptr(i), path.len(i), suffix, suffix_len,
                 ctype, ctype_len, body.ptr(i), body.len(i));
  };
  return pump_send_batch(p, n, frame, status_out);
}

// Send-path attribution snapshot: out[5] = {batches, requests, batch_s,
// write_s, read_s}. write/read are summed across the pool's overlapping
// per-connection threads, so each can exceed batch_s on multi-conn pumps.
void kwok_pump_stats(int64_t handle, double* out) {
  Pump* p = lookup_pump(handle);
  if (!p) {
    for (int i = 0; i < 5; i++) out[i] = 0;
    return;
  }
  out[0] = (double)p->batches.load(std::memory_order_relaxed);
  out[1] = (double)p->requests.load(std::memory_order_relaxed);
  out[2] = (double)p->batch_ns.load(std::memory_order_relaxed) / 1e9;
  out[3] = (double)p->write_ns.load(std::memory_order_relaxed) / 1e9;
  out[4] = (double)p->read_ns.load(std::memory_order_relaxed) / 1e9;
}

void kwok_pump_close(int64_t handle) {
  Pump* p = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_pumps_mu);
    auto it = g_pumps.find(handle);
    if (it != g_pumps.end()) {
      p = it->second;
      g_pumps.erase(it);
    }
  }
  if (!p) return;
  for (Conn& c : p->conns)
    if (c.fd >= 0) close(c.fd);
  delete p;
}

}  // extern "C"
