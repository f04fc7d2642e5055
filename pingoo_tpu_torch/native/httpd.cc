// Native HTTP(S) data plane: epoll listener -> verdict ring -> action.
//
// The C++ half of the architecture split (SURVEY.md §7 item 1: "Host
// data plane (C++): listeners ... proxying"): a non-blocking epoll event
// loop accepts plain-TCP or TLS connections, parses HTTP/1.1 requests,
// enqueues each request's tuple into the shared-memory verdict ring
// (pingoo_ring.h), and on the TPU sidecar's verdict either serves
// 403 / a captcha redirect or proxies the request upstream.
//
// Per-REQUEST policy (reference hyper serves each request through the
// rules loop, http_listener.rs:133-274): connections are keep-alive and
// every request on them is framed (Content-Length / chunked), verdicted
// through the ring, and proxied on its own upstream connection with
// `connection: close` injected — bytes beyond the current request's
// body are never forwarded, so pipelining cannot bypass the WAF.
//
// Captcha gate (reference http_listener.rs:200-236): requests under
// /__pingoo/captcha are proxied to the control-plane upstream (the
// Python listener serving the PoW API); the __pingoo_captcha_verified
// cookie is verified HERE (Ed25519 JWT against the shared JWKS file,
// claims exp/iss/challenge_passed/client_id — client_id =
// b64url(SHA256(ip||ua||host)), captcha.rs:409-421). The verdict byte's
// two lanes (bits 0-1 unverified action, bit 2 verified-block,
// native_ring.py) are applied according to the client's verified state —
// a verified client skips Captcha actions but still blocks on Block.
//
// TLS (reference listeners/mod.rs:112-154 LazyConfigAcceptor): a
// client-hello callback inspects SNI + ALPN before any config is
// chosen; `acme-tls/1` handshakes get the ephemeral tls-alpn-01
// challenge certificate for the requested domain (RFC 8737; reference
// acme.rs:180-242) and close after the handshake; everything else gets
// the SNI-matched certificate (exact, then wildcard, then default).
// Certificates live as <name>.pem/<name>.key pairs in --tls-dir
// ("default" = fallback; "_.example.com" = *.example.com); challenge
// certs as <domain>.pem/.key in --alpn-dir, re-read per handshake
// because they are ephemeral.
//
// Event-loop invariants:
//   * epoll data carries SockRef (conn, side); closes are deferred to
//     the end of the batch so stale events for a reused fd can never
//     touch a fresh connection.
//   * SIGPIPE is ignored; short writes buffer and arm EPOLLOUT.
//   * A sidecar stall fails OPEN three times over: ring-full -> proxy
//     without a verdict immediately; a verdict never arriving -> the
//     per-iteration deadline sweep fails the request open after
//     kVerdictTimeoutMs (mirrors the reference's rule-error fail-open,
//     pingoo/rules.rs:41-44); a stale heartbeat (older than
//     kSidecarTimeoutMs, ring header v5) -> degraded mode: every
//     awaiting ticket fails open at once and new requests bypass the
//     ring until a fresh heartbeat lifts it (docs/RESILIENCE.md).
//   * Idle sweeps cover every state: head/handshake after
//     kIdleTimeoutS, awaiting-verdict via sweep_verdict_deadlines()
//     (fail open), proxying after kProxyIdleTimeoutS.
//
// Usage: httpd <listen-port> <ring-file> <upstream-host> <upstream-port>
//          [--captcha-upstream host:port] [--jwks path]
//          [--tls-dir dir] [--alpn-dir dir]
// TLS is enabled iff --tls-dir is given.

#include <arpa/inet.h>
#include <dirent.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#include "nghttp2_shim.h"
#include "up_h2_link.h"
#include "ossl_shim.h"
#include "pingoo_ring.h"

namespace {

const char kH2Preface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
constexpr size_t kH2PrefaceLen = 24;

constexpr size_t kMaxHead = 32 * 1024;
constexpr size_t kMaxBufferedDefault = 1 << 20;  // per-direction backlog

// Request-head byte cap, env-tunable (PINGOO_MAX_HEADER_BYTES) and
// shared with the Python listener plane (host/httpd.py reads the same
// knob) so oversized-head handling is identical on both: exceed it and
// the request gets 431, not a parser-dependent mix of 400/close
// (ISSUE 11 fuzzer parity). Response heads from upstreams keep the
// compile-time kMaxHead — that bound protects us from the upstream,
// not the client, and is not part of the request-parse surface.
inline size_t parse_max_req_head() {
  const char* e = getenv("PINGOO_MAX_HEADER_BYTES");
  if (e == nullptr || *e == '\0') return kMaxHead;
  long n = atol(e);
  if (n < 256) {
    fprintf(stderr,
            "PINGOO_MAX_HEADER_BYTES=%s out of range (< 256); using %zu\n",
            e, kMaxHead);
    return kMaxHead;
  }
  return static_cast<size_t>(n);
}
const size_t kMaxReqHead = parse_max_req_head();

// Request-body byte cap (PINGOO_MAX_BODY_BYTES, default 16 MiB — the
// Python listener's historical MAX_BODY_BYTES). A Content-Length
// beyond it is refused up front with 413. Chunked uploads stream
// through under the proxy backpressure gates instead of buffering, so
// they are bounded by PINGOO_MAX_BUFFER rather than this knob — a
// documented delta vs the Python plane, which buffers the whole body
// (docs/FUZZING.md known-deltas).
inline long long parse_max_body_bytes() {
  const char* e = getenv("PINGOO_MAX_BODY_BYTES");
  long long def = 16LL * 1024 * 1024;
  if (e == nullptr || *e == '\0') return def;
  long long n = atoll(e);
  if (n < 1) {
    fprintf(stderr, "PINGOO_MAX_BODY_BYTES=%s out of range (< 1); using %lld\n",
            e, def);
    return def;
  }
  return n;
}
const long long kMaxBodyBytes = parse_max_body_bytes();

// Streaming request-body inspection (ISSUE 13, docs/BODY_STREAMING.md):
// PINGOO_BODY_INSPECT=on streams h1 request bodies through the ring's
// body slots so the sidecar can scan payloads across chunk boundaries;
// the request holds until the body verdict merges with the metadata
// verdict. off (the default) is the bit-exact status quo. Every error
// path fails OPEN to metadata-only, never closed.
inline bool parse_body_inspect() {
  const char* e = getenv("PINGOO_BODY_INSPECT");
  return e != nullptr && (strcmp(e, "on") == 0 || strcmp(e, "1") == 0);
}
const bool kBodyInspect = parse_body_inspect();

// Buffering cap, env-tunable (PINGOO_MAX_BUFFER) so tests can exercise
// the backpressure/re-pump paths without multi-MB payloads. Resolved
// once at process start; out-of-range values warn and fall back.
inline size_t parse_max_buffered() {
  const char* e = getenv("PINGOO_MAX_BUFFER");
  if (e == nullptr || *e == '\0') return kMaxBufferedDefault;
  long n = atol(e);
  if (n < 4096) {
    fprintf(stderr, "PINGOO_MAX_BUFFER=%s out of range (< 4096); using %zu\n",
            e, kMaxBufferedDefault);
    return kMaxBufferedDefault;
  }
  return static_cast<size_t>(n);
}
const size_t kMaxBuffered = parse_max_buffered();
constexpr time_t kIdleTimeoutS = 30;
constexpr time_t kTunnelIdleS = 300;     // upgraded (WebSocket) tunnels

// Per-request verdict fail-open deadline (ISSUE 10). Defaulted from
// the scheduler's deadline budget — 1500 x PINGOO_DEADLINE_MS, which
// keeps the historical 3 s at the 2 ms default (the first sidecar
// batch can sit behind a multi-second XLA compile) while configuring
// both knobs in one place. PINGOO_VERDICT_TIMEOUT_MS overrides it
// directly; out-of-range values warn and fall back.
inline uint64_t parse_verdict_timeout_ms() {
  double deadline_ms = 2.0;
  if (const char* d = getenv("PINGOO_DEADLINE_MS")) {
    double v = atof(d);
    if (v > 0) deadline_ms = v;
  }
  uint64_t def = static_cast<uint64_t>(deadline_ms * 1500.0);
  if (def == 0) def = 1;
  const char* e = getenv("PINGOO_VERDICT_TIMEOUT_MS");
  if (e == nullptr || *e == '\0') return def;
  long n = atol(e);
  if (n <= 0) {
    fprintf(stderr,
            "PINGOO_VERDICT_TIMEOUT_MS=%s out of range (<= 0); using %llu\n",
            e, static_cast<unsigned long long>(def));
    return def;
  }
  return static_cast<uint64_t>(n);
}
const uint64_t kVerdictTimeoutMs = parse_verdict_timeout_ms();

// Sidecar liveness window (ISSUE 10, docs/RESILIENCE.md): with a ring
// attached, a heartbeat older than this flips the plane into the
// degraded fast-path (immediate fail-open, no per-request stall) until
// a fresh heartbeat arrives. 0 disables detection.
inline uint64_t parse_sidecar_timeout_ms() {
  const char* e = getenv("PINGOO_SIDECAR_TIMEOUT_MS");
  if (e == nullptr || *e == '\0') return 500;
  long n = atol(e);
  return n > 0 ? static_cast<uint64_t>(n) : 0;
}
const uint64_t kSidecarTimeoutMs = parse_sidecar_timeout_ms();
// TCP proxy mode (reference tcp_proxy_service.rs:30-84): 3 connect
// tries, 3 s timeout each. The reference sleeps 5 ms between tries;
// this plane re-dials immediately on a failed connect (a fresh random
// upstream each time), which only tightens the retry window.
constexpr int kTcpConnectRetriesDefault = 3;
constexpr time_t kTcpConnectTimeoutS = 3;

inline int tcp_connect_retries() {
  static int v = [] {
    const char* e = getenv("PINGOO_TCP_RETRIES");
    int n = e != nullptr ? atoi(e) : 0;
    return n > 0 ? n : kTcpConnectRetriesDefault;
  }();
  return v;
}
constexpr size_t kMaxReplay = 64 * 1024;  // pooled-retry replay budget
// nghttp2 data-provider sentinel: no DATA available now; the session
// parks the stream until nghttp2_session_resume_data.
constexpr ssize_t kNghttp2ErrDeferred = -508;  // NGHTTP2_ERR_DEFERRED
// Streamed h2 responses buffer at most this much de-framed body before
// the upstream read side is paused (per stream).
constexpr size_t kH2PendingCap = 256 * 1024;
constexpr int kH2MaxStreamUpstreams = 32;  // concurrent upstreams per conn
// Connection-level receive window: 8x the (default 64KB) per-stream
// window, so one debt-parked upload stream cannot exhaust the window
// shared by its siblings (see start_h2).
constexpr int32_t kH2ConnRecvWindow = 8 * 65535;
constexpr time_t kProxyIdleTimeoutS = 60;
constexpr int kMaxRequestsPerConn = 1000;

// ---------------------------------------------------------------------------
// small utils

int b64url_val(char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '-') return 62;
  if (c == '_') return 63;
  return -1;
}

bool b64url_decode(const std::string& in, std::string* out) {
  out->clear();
  int bits = 0, acc = 0;
  for (char c : in) {
    if (c == '=') break;
    int v = b64url_val(c);
    if (v < 0) return false;
    acc = (acc << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out->push_back(static_cast<char>((acc >> bits) & 0xFF));
    }
  }
  return true;
}

std::string b64url_encode(const unsigned char* data, size_t len) {
  static const char tab[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_";
  std::string out;
  size_t i = 0;
  while (i + 3 <= len) {
    unsigned v = (data[i] << 16) | (data[i + 1] << 8) | data[i + 2];
    out += tab[(v >> 18) & 63];
    out += tab[(v >> 12) & 63];
    out += tab[(v >> 6) & 63];
    out += tab[v & 63];
    i += 3;
  }
  if (len - i == 1) {
    unsigned v = data[i] << 16;
    out += tab[(v >> 18) & 63];
    out += tab[(v >> 12) & 63];
  } else if (len - i == 2) {
    unsigned v = (data[i] << 16) | (data[i + 1] << 8);
    out += tab[(v >> 18) & 63];
    out += tab[(v >> 12) & 63];
    out += tab[(v >> 6) & 63];
  }
  return out;
}

std::string lower(std::string s) {
  for (auto& ch : s) ch = static_cast<char>(tolower(ch));
  return s;
}

std::string trim(const std::string& s) {
  size_t a = 0, b = s.size();
  while (a < b && (s[a] == ' ' || s[a] == '\t')) ++a;
  while (b > a && (s[b - 1] == ' ' || s[b - 1] == '\t' || s[b - 1] == '\r'))
    --b;
  return s.substr(a, b - a);
}

// Flat-JSON string field extraction ("key":"value"). Sufficient for the
// JWT payloads and JWKS files this framework itself writes (no escapes
// in base64url/id values; a token with escapes simply fails the gate,
// which fails SAFE — the client is treated as unverified).
bool json_str(const std::string& j, const std::string& key, std::string* out) {
  std::string pat = "\"" + key + "\"";
  size_t p = j.find(pat);
  if (p == std::string::npos) return false;
  p = j.find(':', p + pat.size());
  if (p == std::string::npos) return false;
  ++p;
  while (p < j.size() && (j[p] == ' ')) ++p;
  if (p >= j.size() || j[p] != '"') return false;
  size_t e = j.find('"', p + 1);
  if (e == std::string::npos) return false;
  *out = j.substr(p + 1, e - p - 1);
  return out->find('\\') == std::string::npos;
}

bool json_num(const std::string& j, const std::string& key, long long* out) {
  std::string pat = "\"" + key + "\"";
  size_t p = j.find(pat);
  if (p == std::string::npos) return false;
  p = j.find(':', p + pat.size());
  if (p == std::string::npos) return false;
  ++p;
  while (p < j.size() && j[p] == ' ') ++p;
  char* end = nullptr;
  long long v = strtoll(j.c_str() + p, &end, 10);
  if (end == j.c_str() + p) return false;
  *out = v;
  return true;
}

bool json_true(const std::string& j, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t p = j.find(pat);
  if (p == std::string::npos) return false;
  p = j.find(':', p + pat.size());
  if (p == std::string::npos) return false;
  ++p;
  while (p < j.size() && j[p] == ' ') ++p;
  return j.compare(p, 4, "true") == 0;
}

// ---------------------------------------------------------------------------
// captcha-verified gate: Ed25519 JWT against the shared JWKS file

class CaptchaGate {
 public:
  // Loads the first EdDSA key from the JWKS file (written by the Python
  // CaptchaManager, host/captcha.py). Returns false if unavailable —
  // the gate then treats every client as unverified (fail safe).
  bool load(const char* jwks_path) {
    path_ = jwks_path;
    return reload();
  }

  bool reload() {
    struct stat st;
    if (stat(path_.c_str(), &st) != 0) return pkey_ != nullptr;
    if (pkey_ != nullptr && st.st_mtime == loaded_mtime_) return true;
    FILE* f = fopen(path_.c_str(), "r");
    if (!f) return pkey_ != nullptr;
    std::string text;
    char buf[4096];
    size_t n;
    while ((n = fread(buf, 1, sizeof(buf), f)) > 0) text.append(buf, n);
    fclose(f);
    std::string x;
    std::string raw;
    if (!json_str(text, "x", &x) || !b64url_decode(x, &raw) ||
        raw.size() != 32)
      return pkey_ != nullptr;
    EVP_PKEY* pk = EVP_PKEY_new_raw_public_key(
        EVP_PKEY_ED25519, nullptr,
        reinterpret_cast<const unsigned char*>(raw.data()), raw.size());
    if (pk == nullptr) return pkey_ != nullptr;
    if (pkey_ != nullptr) EVP_PKEY_free(pkey_);
    pkey_ = pk;
    loaded_mtime_ = st.st_mtime;
    return true;
  }

  // Re-stat the JWKS periodically so a control plane that starts (or
  // rotates keys) AFTER this process does not leave every client
  // permanently unverified — the same freshness discipline as the
  // per-handshake challenge-cert reads.
  void maybe_reload(time_t now) {
    if (path_.empty() || now - last_check_ < 5) return;
    last_check_ = now;
    reload();
  }

  bool available() const { return pkey_ != nullptr; }

  // Mirrors host/jwt.py parse_and_verify + captcha.py is_verified:
  // EdDSA alg, valid signature, exp within 5s drift, iss == "pingoo",
  // challenge_passed == true, client_id constant-time-equals ours.
  bool verify(const std::string& token, const std::string& client_id,
              time_t now) const {
    if (!pkey_) return false;
    size_t d1 = token.find('.');
    if (d1 == std::string::npos) return false;
    size_t d2 = token.find('.', d1 + 1);
    if (d2 == std::string::npos || token.find('.', d2 + 1) != std::string::npos)
      return false;
    std::string header_json, payload_json, sig;
    if (!b64url_decode(token.substr(0, d1), &header_json)) return false;
    if (!b64url_decode(token.substr(d1 + 1, d2 - d1 - 1), &payload_json))
      return false;
    if (!b64url_decode(token.substr(d2 + 1), &sig) || sig.size() != 64)
      return false;
    std::string alg;
    if (!json_str(header_json, "alg", &alg) || alg != "EdDSA") return false;

    EVP_MD_CTX* ctx = EVP_MD_CTX_new();
    if (!ctx) return false;
    bool ok = false;
    if (EVP_DigestVerifyInit(ctx, nullptr, nullptr, nullptr, pkey_) == 1) {
      const std::string signed_part = token.substr(0, d2);
      ok = EVP_DigestVerify(
               ctx, reinterpret_cast<const unsigned char*>(sig.data()),
               sig.size(),
               reinterpret_cast<const unsigned char*>(signed_part.data()),
               signed_part.size()) == 1;
    }
    EVP_MD_CTX_free(ctx);
    if (!ok) return false;

    // exp is REQUIRED here (the CaptchaManager always sets it; a signed
    // token without one would otherwise never expire on this plane).
    long long exp = 0;
    if (!json_num(payload_json, "exp", &exp) || exp + 5 < now) return false;
    long long nbf = 0;
    if (json_num(payload_json, "nbf", &nbf) && nbf - 5 > now) return false;
    std::string iss;
    if (!json_str(payload_json, "iss", &iss) || iss != "pingoo") return false;
    if (!json_true(payload_json, "challenge_passed")) return false;
    std::string cid;
    if (!json_str(payload_json, "client_id", &cid)) return false;
    if (cid.size() != client_id.size()) return false;
    return CRYPTO_memcmp(cid.data(), client_id.data(), cid.size()) == 0;
  }

 private:
  std::string path_;
  EVP_PKEY* pkey_ = nullptr;
  time_t loaded_mtime_ = 0;
  time_t last_check_ = 0;
};

std::string captcha_client_id(const std::string& ip, const std::string& ua,
                              const std::string& host) {
  std::string input = ip + ua + host;
  unsigned char md[32];
  unsigned int mdlen = 0;
  EVP_Digest(input.data(), input.size(), md, &mdlen, EVP_sha256(), nullptr);
  return b64url_encode(md, mdlen);
}

// ---------------------------------------------------------------------------
// TLS: cert store + client-hello SNI/ALPN inspection

struct TlsStore {
  SSL_CTX* fallback = nullptr;                       // "default" pair
  std::unordered_map<std::string, SSL_CTX*> exact;   // domain -> ctx
  std::unordered_map<std::string, SSL_CTX*> wildcard;  // parent -> ctx
  std::string alpn_dir;  // tls-alpn-01 challenge certs, may be empty

  SSL_CTX* match(const std::string& name) const {
    auto it = exact.find(name);
    if (it != exact.end()) return it->second;
    size_t dot = name.find('.');
    if (dot != std::string::npos) {
      auto w = wildcard.find(name.substr(dot + 1));
      if (w != wildcard.end()) return w->second;
    }
    return fallback;
  }
};

SSL_CTX* make_server_ctx(const std::string& cert, const std::string& key) {
  SSL_CTX* ctx = SSL_CTX_new(TLS_server_method());
  if (!ctx) return nullptr;
  // Partial-write + moving-buffer + auto-retry (SSL_CTRL_MODE): the
  // event loop retries writes from a std::string that may reallocate.
  SSL_CTX_ctrl(ctx, /*SSL_CTRL_MODE=*/33, 7, nullptr);
  SSL_CTX_set_min_proto_version_shim(ctx, TLS1_2_VERSION);
  if (SSL_CTX_use_certificate_chain_file(ctx, cert.c_str()) != 1 ||
      SSL_CTX_use_PrivateKey_file(ctx, key.c_str(), SSL_FILETYPE_PEM) != 1 ||
      SSL_CTX_check_private_key(ctx) != 1) {
    SSL_CTX_free(ctx);
    ERR_clear_error();
    return nullptr;
  }
  return ctx;
}

bool load_tls_store(const char* dir, TlsStore* store) {
  DIR* d = opendir(dir);
  if (!d) return false;
  dirent* ent;
  while ((ent = readdir(d)) != nullptr) {
    std::string fname = ent->d_name;
    if (fname.size() < 5 || fname.compare(fname.size() - 4, 4, ".pem") != 0)
      continue;
    std::string base = fname.substr(0, fname.size() - 4);
    std::string cert = std::string(dir) + "/" + fname;
    std::string key = std::string(dir) + "/" + base + ".key";
    SSL_CTX* ctx = make_server_ctx(cert, key);
    if (!ctx) continue;
    if (base == "default") {
      store->fallback = ctx;
    } else if (base.size() > 2 && base[0] == '_' && base[1] == '.') {
      store->wildcard[base.substr(2)] = ctx;
    } else {
      store->exact[base] = ctx;
    }
  }
  closedir(d);
  return store->fallback != nullptr || !store->exact.empty() ||
         !store->wildcard.empty();
}

// A hostname safe to use as a lookup key AND a file-name component
// (the tls-alpn-01 challenge path is built from it): DNS charset only,
// no dot-runs — rejects "../" traversal outright.
bool valid_sni_name(const std::string& s) {
  if (s.empty() || s.size() > 253 || s[0] == '.' || s[0] == '-') return false;
  char prev = 0;
  for (char ch : s) {
    bool ok = (ch >= 'a' && ch <= 'z') || (ch >= 'A' && ch <= 'Z') ||
              (ch >= '0' && ch <= '9') || ch == '.' || ch == '-';
    if (!ok) return false;
    if (ch == '.' && prev == '.') return false;
    prev = ch;
  }
  return true;
}

// Parse SNI host out of the raw server_name ClientHello extension.
std::string parse_sni_ext(const unsigned char* p, size_t len) {
  if (len < 5) return "";
  size_t list_len = (p[0] << 8) | p[1];
  if (list_len + 2 > len || p[2] != 0) return "";  // type 0 = host_name
  size_t name_len = (p[3] << 8) | p[4];
  if (5 + name_len > len) return "";
  std::string name(reinterpret_cast<const char*>(p + 5), name_len);
  return valid_sni_name(name) ? name : "";
}

bool alpn_ext_offers(const unsigned char* p, size_t len, const char* proto) {
  if (len < 2) return false;
  size_t list_len = (p[0] << 8) | p[1];
  size_t plen = strlen(proto);
  size_t i = 2;
  if (2 + list_len > len) return false;
  while (i < 2 + list_len) {
    size_t n = p[i];
    if (i + 1 + n > len) return false;
    if (n == plen && memcmp(p + i + 1, proto, n) == 0) return true;
    i += 1 + n;
  }
  return false;
}

// ---------------------------------------------------------------------------
// HTTP message framing

struct BodyFramer {
  enum Mode { kNone, kContentLength, kChunked, kUntilEof } mode = kNone;
  long long remaining = 0;  // kContentLength
  // chunked state
  enum CState { kSize, kData, kDataCrlf, kTrailer } cstate = kSize;
  std::string linebuf;
  bool done = false;
  bool bad = false;  // malformed framing: caller must refuse/close

  void reset_none() { *this = BodyFramer(); done = true; }
  void reset_cl(long long n) {
    *this = BodyFramer();
    mode = kContentLength;
    remaining = n;
    done = n == 0;
  }
  void reset_chunked() {
    *this = BodyFramer();
    mode = kChunked;
  }
  void reset_eof() {
    *this = BodyFramer();
    mode = kUntilEof;
  }

  // How many of data[0..len) belong to the current message. Sets done.
  // With `payload` set, the message's PAYLOAD bytes (de-chunked — no
  // chunk-size lines or trailers) are appended to it; the h2 bridge
  // re-frames upstream h1 responses and must not leak h1 framing.
  size_t consume(const char* data, size_t len, std::string* payload = nullptr) {
    if (done) return 0;
    switch (mode) {
      case kNone:
        done = true;
        return 0;
      case kUntilEof:
        if (payload) payload->append(data, len);
        return len;  // done only at EOF (caller decides)
      case kContentLength: {
        size_t take = static_cast<size_t>(remaining) < len
                          ? static_cast<size_t>(remaining)
                          : len;
        remaining -= static_cast<long long>(take);
        if (remaining == 0) done = true;
        if (payload) payload->append(data, take);
        return take;
      }
      case kChunked:
        return consume_chunked(data, len, payload);
    }
    return 0;
  }

  size_t consume_chunked(const char* data, size_t len,
                         std::string* payload = nullptr) {
    size_t used = 0;
    while (used < len && !done) {
      char c = data[used];
      switch (cstate) {
        case kSize:
          linebuf.push_back(c);
          ++used;
          if (linebuf.size() > 1024) {  // junk flood
            bad = true;
            done = true;
            return used;
          }
          if (linebuf.size() >= 2 &&
              linebuf.compare(linebuf.size() - 2, 2, "\r\n") == 0) {
            // Chunk size must be plain hex (extensions after ';' are
            // tolerated); a leading '-' or garbage would make
            // `remaining` negative and the cast in kData wrap to ~2^64.
            // Every byte of the size field before ';' (extension) or CRLF
            // must be hex — strtoll would silently stop at garbage like
            // "1x3" and desync framing against a strict upstream.
            size_t hex_len = 0;
            while (hex_len + 2 < linebuf.size()) {
              char hc = linebuf[hex_len];
              bool is_hex = (hc >= '0' && hc <= '9') ||
                            (hc >= 'a' && hc <= 'f') ||
                            (hc >= 'A' && hc <= 'F');
              if (!is_hex) break;
              ++hex_len;
            }
            // BWS after the size (before ';' or CRLF) is tolerated —
            // h11 accepts "3 \r\n"/"3\t\r\n" and the two planes must
            // frame identically (differential fuzzer, ISSUE 11).
            size_t bws_end = hex_len;
            while (bws_end + 2 < linebuf.size() &&
                   (linebuf[bws_end] == ' ' || linebuf[bws_end] == '\t'))
              ++bws_end;
            bool valid_size =
                hex_len > 0 &&
                (bws_end + 2 == linebuf.size() || linebuf[bws_end] == ';');
            long long sz = valid_size ? strtoll(linebuf.c_str(), nullptr, 16)
                                      : -1;
            linebuf.clear();
            if (!valid_size || sz < 0 || sz > (1LL << 40)) {
              bad = true;
              done = true;
              return used;
            }
            if (sz == 0) {
              cstate = kTrailer;
            } else {
              remaining = sz;
              cstate = kData;
            }
          }
          break;
        case kData: {
          size_t take = static_cast<size_t>(remaining) < (len - used)
                            ? static_cast<size_t>(remaining)
                            : (len - used);
          remaining -= static_cast<long long>(take);
          if (payload) payload->append(data + used, take);
          used += take;
          if (remaining == 0) cstate = kDataCrlf;
          break;
        }
        case kDataCrlf:
          linebuf.push_back(c);
          ++used;
          if (linebuf.size() == 2) {
            if (linebuf != "\r\n") {  // chunk data must end with exact CRLF
              bad = true;
              done = true;
              linebuf.clear();
              return used;
            }
            linebuf.clear();
            cstate = kSize;
          }
          break;
        case kTrailer:
          linebuf.push_back(c);
          ++used;
          if (linebuf.size() >= 2 &&
              linebuf.compare(linebuf.size() - 2, 2, "\r\n") == 0) {
            if (linebuf == "\r\n") {
              done = true;  // empty line ends trailers
            }
            linebuf.clear();
          }
          break;
      }
    }
    return used;
  }
};

struct Parsed {
  std::string method, target, path, host, user_agent;
  std::string accept;           // Accept header (metrics content nego)
  std::string verified_cookie;  // __pingoo_captcha_verified value
  long long content_length = 0;
  bool has_content_length = false;
  bool bad_content_length = false;  // duplicate/garbage Content-Length
  bool obs_fold = false;  // obsolete line folding seen (RFC 7230 §3.2.4)
  bool bad_header = false;  // colonless line / ws before colon / bare LF
  bool has_host = false;    // first Host seen; a repeat sets bad_header
  bool chunked = false;
  bool has_transfer_encoding = false;
  bool keep_alive = true;  // HTTP/1.1 default
  bool conn_upgrade = false;    // Connection header listed "upgrade"
  std::string upgrade_value;    // Upgrade header token (e.g. websocket)
  bool ok = false;
  std::string raw_head;  // original head (h1; empty for h2 streams)

  bool is_upgrade() const {
    return conn_upgrade && !upgrade_value.empty();
  }
  // h2 streams carry their full header list here instead of raw_head.
  std::vector<std::pair<std::string, std::string>> h2_headers;
};

// A concrete upstream address plus its transport policy: a `tls`
// target gets a verified OpenSSL client connection (SNI + hostname
// check against `sni`), matching the reference's pooled hyper-rustls
// client (http_proxy_service.rs:54-71).
struct UpTarget {
  sockaddr_in sa{};
  bool tls = false;
  bool h2 = false;        // cleartext prior-knowledge h2 upstream (h2://)
  bool internal = false;  // the loopback control plane: identity headers
                          // (x-pingoo-internal) may be sent to it
  std::string sni;
};

// One multiplexed HTTP/2 request in flight on a connection.
struct SockRef;

struct H2Stream {
  Parsed p;
  std::string body;
  bool complete = false;
  // Per-stream proxy state: streams are serviced CONCURRENTLY, each
  // with its own upstream connection and de-framed response stream
  // (reference: hyper multiplexes + streams bodies, http_listener.rs:276).
  int up_fd = -1;
  bool up_connected = false;
  bool up_eof = false;
  bool up_trunc = false;        // upstream ended with an ERROR, not clean EOF
  UpH2Link* up_h2 = nullptr;    // non-null: upstream link speaks h2
  std::string up_head;          // synthesized h1 head (until ALPN decides)
  std::string up_body;          // request-body bytes pending the h2 link
  bool up_proto_pending = false;
  // Streamed request bodies (reference: hyper streams them): the
  // stream dispatches at END_HEADERS; DATA arriving after dispatch
  // forwards straight to the upstream instead of buffering in `body`.
  bool ready_queued = false;    // pushed to h2_ready once
  bool up_dispatched = false;   // upstream head synthesized
  bool up_body_chunked = false;  // forwarding with h1 chunked framing
  uint64_t window_debt = 0;     // received-but-unconsumed body bytes
                                // (released as the upstream drains)
  bool up_pooled = false;
  uint64_t up_key = 0;
  UpTarget up_target{};
  SSL* up_ssl = nullptr;        // non-null on TLS upstream links
  bool up_tcp_ok = false;       // TCP connect completed
  bool up_tls_hs = false;       // client handshake in progress
  bool up_hs_want_write = false;  // handshake blocked on EPOLLOUT
  bool up_rd_want_write = false;  // SSL_read wants the write event
  bool up_wr_want_read = false;   // SSL_write wants the read event
  std::string upbuf;       // request bytes awaiting the upstream socket
  std::string up_replay;   // pooled-retry replay copy
  std::string resp_head_buf;
  bool resp_head_done = false;
  BodyFramer resp_body;
  bool up_keep = false;
  bool up_junk = false;
  bool submitted = false;  // response HEADERS handed to nghttp2
  std::string pending;     // de-framed DATA bytes awaiting the session
  bool data_eof = false;   // response body complete
  bool verified = false;   // captcha cookie verified for this stream
  bool up_queued = false;  // verdicted; waiting for an upstream slot
  uint64_t ticket = UINT64_MAX;
  uint64_t enq_ms = 0;
  time_t verdict_at = 0;
  SockRef* up_ref = nullptr;  // heap ref handed to epoll (deferred free)
};

std::string strip_host_port(const std::string& value);
std::string extract_verified_cookie(const std::string& value);

// Parse a request head (request line + headers).
Parsed parse_head(const std::string& head) {
  Parsed p;
  // A bare LF (not preceded by CR) inside the head is invisible to the
  // CRLF line scan below: "ua\nx-smuggle: 1" would read as ONE header
  // value here while an LF-tolerant parser (h11 accepts bare-LF line
  // endings at the transport layer) sees TWO lines — exactly the
  // per-hop disagreement request smuggling needs. Reject the head.
  for (size_t i = 0; i < head.size(); ++i)
    if (head[i] == '\n' && (i == 0 || head[i - 1] != '\r'))
      p.bad_header = true;
  size_t line_end = head.find("\r\n");
  if (line_end == std::string::npos) return p;
  const std::string line = head.substr(0, line_end);
  size_t sp1 = line.find(' ');
  size_t sp2 = line.rfind(' ');
  if (sp1 == std::string::npos || sp2 == sp1) return p;
  p.method = line.substr(0, sp1);
  p.target = line.substr(sp1 + 1, sp2 - sp1 - 1);
  if (p.method.empty() || p.target.empty()) return p;
  if (line.compare(sp2 + 1, 8, "HTTP/1.1") == 0) {
    p.keep_alive = true;
  } else if (line.compare(sp2 + 1, 8, "HTTP/1.0") == 0) {
    p.keep_alive = false;
  } else {
    return p;
  }
  size_t q = p.target.find('?');
  p.path = q == std::string::npos ? p.target : p.target.substr(0, q);

  size_t pos = line_end + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos || eol == pos) break;
    if (head[pos] == ' ' || head[pos] == '\t') {
      // Obsolete line folding (RFC 7230 §3.2.4). Previously skipped
      // silently — but the Python plane's h11 parser REJECTS folds, so
      // a folded Transfer-Encoding read one way by this parser and
      // another by anything downstream is a smuggling vector the
      // differential fuzzer flags (ISSUE 11). Reject at admission.
      p.obs_fold = true;
      pos = eol + 2;
      continue;
    }
    size_t colon = head.find(':', pos);
    if (colon == std::string::npos || colon >= eol) {
      // A field line without a colon is not skippable noise: a parser
      // that drops it and one that rejects the message (h11 does)
      // disagree about every header that follows (RFC 9112 §2.2).
      p.bad_header = true;
      pos = eol + 2;
      continue;
    }
    {
      // RFC 7230 §3.2.4: whitespace between field-name and ":" MUST be
      // rejected — "Host : x" is a smuggling classic (one hop reads a
      // Host header, the next reads none).
      char last = colon > pos ? head[colon - 1] : '\0';
      if (last == ' ' || last == '\t') p.bad_header = true;
      std::string name = lower(head.substr(pos, colon - pos));
      std::string value = trim(head.substr(colon + 1, eol - colon - 1));
      if (name == "host") {
        // RFC 9112 §3.2: more than one Host is a MUST-reject (h11
        // refuses too). First-wins here + last-wins upstream would
        // route and verdict on different vhosts.
        if (p.has_host) p.bad_header = true;
        p.has_host = true;
        p.host = strip_host_port(value);
      } else if (name == "user-agent") {
        p.user_agent = value;
      } else if (name == "accept") {
        p.accept = lower(value);
      } else if (name == "content-length") {
        // RFC 7230 §3.3.3: reject non-numeric values and ANY repeat —
        // even value-identical duplicates (h11 refuses them too, and a
        // first-wins upstream may not treat them as identical after
        // its own normalization). Silent last-wins framing would
        // desync the proxy from the upstream (request smuggling).
        bool numeric = !value.empty();
        for (char ch : value)
          if (ch < '0' || ch > '9') numeric = false;
        long long v = numeric ? strtoll(value.c_str(), nullptr, 10) : -1;
        if (!numeric || v < 0 || p.has_content_length) {
          p.bad_content_length = true;
        } else {
          p.content_length = v;
          p.has_content_length = true;
        }
      } else if (name == "transfer-encoding") {
        p.has_transfer_encoding = true;
        if (lower(value).find("chunked") != std::string::npos)
          p.chunked = true;
      } else if (name == "connection") {
        std::string v = lower(value);
        if (v.find("close") != std::string::npos) p.keep_alive = false;
        if (v.find("keep-alive") != std::string::npos) p.keep_alive = true;
        if (v.find("upgrade") != std::string::npos) p.conn_upgrade = true;
      } else if (name == "upgrade") {
        p.upgrade_value = value;
      } else if (name == "cookie" && p.verified_cookie.empty()) {
        p.verified_cookie = extract_verified_cookie(value);
      }
    }
    pos = eol + 2;
  }
  p.raw_head = head;
  p.ok = true;
  return p;
}

// "name: value" lines of an h1 head (after the start line) -> pairs.
void parse_header_lines(
    const std::string& head,
    std::vector<std::pair<std::string, std::string>>* out) {
  size_t le = head.find("\r\n");
  size_t pos = le == std::string::npos ? head.size() : le + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos || eol == pos) break;
    size_t colon = head.find(':', pos);
    if (colon != std::string::npos && colon < eol) {
      out->emplace_back(head.substr(pos, colon - pos),
                        trim(head.substr(colon + 1, eol - colon - 1)));
    }
    pos = eol + 2;
  }
}

// Strip a :port (IPv6-bracket aware) — the shared host normalization
// for h1 Host headers and h2 :authority (get_host semantics).
std::string strip_host_port(const std::string& value) {
  if (!value.empty() && value[0] == '[') {
    size_t close = value.find(']');
    return close == std::string::npos ? value : value.substr(0, close + 1);
  }
  size_t port_colon = value.rfind(':');
  return port_colon == std::string::npos ? value
                                         : value.substr(0, port_colon);
}

// Extract __pingoo_captcha_verified from a Cookie header value.
std::string extract_verified_cookie(const std::string& value) {
  size_t cp = 0;
  while (cp < value.size()) {
    size_t semi = value.find(';', cp);
    std::string part = trim(value.substr(
        cp, semi == std::string::npos ? std::string::npos : semi - cp));
    size_t eq = part.find('=');
    if (eq != std::string::npos &&
        part.substr(0, eq) == "__pingoo_captcha_verified")
      return part.substr(eq + 1);
    if (semi == std::string::npos) break;
    cp = semi + 1;
  }
  return "";
}

bool is_hop_header(const std::string& lname) {
  return lname == "connection" || lname == "keep-alive" ||
         lname == "proxy-connection" || lname == "upgrade" ||
         lname == "te" || lname == "trailer" ||
         lname == "proxy-authenticate" || lname == "proxy-authorization";
}

bool drop_request_header(const std::string& lname, bool chunked);

// Rewrite the client's request head for the upstream: strip hop-by-hop
// headers, inject connection: close (one upstream connection per
// verdicted request — the enforced scope), add forwarding headers
// (reference http_proxy_service.rs:114-190).
std::string rewrite_request_head(const Parsed& p, const std::string& client_ip,
                                 bool tls,
                                 const std::string& internal_token) {
  const std::string& head = p.raw_head;
  size_t line_end = head.find("\r\n");
  std::string out = head.substr(0, line_end + 2);
  size_t pos = line_end + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos || eol == pos) break;
    size_t colon = head.find(':', pos);
    std::string lname = colon != std::string::npos && colon < eol
                            ? lower(head.substr(pos, colon - pos))
                            : "";
    if (!drop_request_header(lname, p.chunked)) {
      out.append(head, pos, eol + 2 - pos);
    }
    pos = eol + 2;
  }
  if (p.is_upgrade()) {
    // Protocol upgrade (WebSocket): preserve the upgrade intent — the
    // hop-header strip above removed the client's Connection/Upgrade
    // pair, re-emit it canonically (reference serves with upgrades,
    // http_listener.rs:277).
    out += "connection: upgrade\r\nupgrade: " + p.upgrade_value + "\r\n";
  } else {
    // keep-alive so the upstream connection can be pooled for reuse
    // (reference proxies over a pooled client, http_proxy_service.rs:54-71)
    out += "connection: keep-alive\r\n";
  }
  if (!p.chunked && p.has_content_length)
    out += "content-length: " + std::to_string(p.content_length) + "\r\n";
  out += "x-forwarded-for: " + client_ip + "\r\n";
  out += std::string("x-forwarded-proto: ") + (tls ? "https" : "http") + "\r\n";
  if (!p.host.empty()) out += "x-forwarded-host: " + p.host + "\r\n";
  out += "pingoo-client-ip: " + client_ip + "\r\n";
  // Hops to the loopback control plane carry the per-boot internal
  // token so the Python listener can bind x-forwarded-for trust to
  // THIS proxy rather than to anything that can dial 127.0.0.1
  // (spoofed client identity would defeat captcha binding + IP rules).
  if (!internal_token.empty())
    out += "x-pingoo-internal: " + internal_token + "\r\n";
  out += "\r\n";
  return out;
}

// is_hop_header, plus the request-smuggling hygiene rule (RFC 7230
// §3.3.3): when Transfer-Encoding frames the body, any Content-Length
// must NOT reach the upstream — the proxy framed by TE and a
// CL-trusting upstream would see a different body boundary.
bool drop_request_header(const std::string& lname, bool chunked) {
  if (is_hop_header(lname)) return true;
  // The proxy re-derives body framing and appends its own canonical
  // content-length; forwarding the client's copies verbatim would let
  // duplicate/odd values desync upstream framing (RFC 7230 §3.3.3).
  if (lname == "content-length") return true;
  (void)chunked;
  // Identity headers the upstream must only ever receive from THIS
  // proxy — client-supplied copies would spoof the trusted client IP
  // (reference strips and re-sets the same set,
  // http_proxy_service.rs:114-190).
  if (lname.compare(0, 7, "pingoo-") == 0) return true;
  if (lname == "x-pingoo-internal") return true;
  return lname == "x-forwarded-for" || lname == "x-forwarded-proto" ||
         lname == "x-forwarded-host";
}

// Parsed upstream response head.
struct RespHead {
  int status = 0;
  bool chunked = false;
  long long content_length = -1;  // -1 = absent
  std::string rewritten;          // head to send downstream
  bool ok = false;
  // The UPSTREAM connection may be pooled for reuse after this
  // response: explicit body framing and no connection: close (HTTP/1.0
  // defaults to close unless keep-alive is announced).
  bool upstream_keep = false;
};

// Response headers this proxy never forwards downstream: hop-by-hop
// headers plus upstream identity/behavior headers (reference
// http_proxy_service.rs:37-43,197-201). One predicate shared by final
// and interim (1xx) head rewriting so the strip policy cannot diverge.
bool strip_response_header(const std::string& lname) {
  return is_hop_header(lname) || lname == "server" ||
         lname == "x-accel-buffering" || lname == "alt-svc";
}

// Rewrite the upstream response head for the client: strip hop-by-hop
// headers and upstream server identity, set server: pingoo (reference
// http_proxy_service.rs:37-43,197-201), and pin the connection header
// to our keep-alive decision.
RespHead rewrite_response_head(const std::string& head, bool client_keep) {
  RespHead r;
  size_t line_end = head.find("\r\n");
  if (line_end == std::string::npos) return r;
  const std::string line = head.substr(0, line_end);
  // Shortest legal status line is "HTTP/1.x NNN" (12 chars); anything
  // shorter would index out of bounds below.
  if (line.size() < 12 || line.compare(0, 7, "HTTP/1.") != 0 ||
      line[8] != ' ')
    return r;
  r.status = atoi(line.c_str() + 9);
  if (r.status < 100 || r.status > 999) return r;
  bool http10 = line.compare(0, 8, "HTTP/1.0") == 0;
  bool conn_close = false, conn_keep = false;
  std::string out = "HTTP/1.1" + line.substr(8) + "\r\n";
  size_t pos = line_end + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos || eol == pos) break;
    size_t colon = head.find(':', pos);
    std::string lname = colon != std::string::npos && colon < eol
                            ? lower(head.substr(pos, colon - pos))
                            : "";
    std::string value = colon != std::string::npos && colon < eol
                            ? trim(head.substr(colon + 1, eol - colon - 1))
                            : "";
    if (lname == "connection") {
      std::string lv = lower(value);
      if (lv.find("close") != std::string::npos) conn_close = true;
      if (lv.find("keep-alive") != std::string::npos) conn_keep = true;
    }
    if (lname == "transfer-encoding") {
      if (lower(value).find("chunked") != std::string::npos) r.chunked = true;
      out.append(head, pos, eol + 2 - pos);
    } else if (lname == "content-length") {
      r.content_length = strtoll(value.c_str(), nullptr, 10);
      out.append(head, pos, eol + 2 - pos);
    } else if (strip_response_header(lname)) {
      // dropped
    } else {
      out.append(head, pos, eol + 2 - pos);
    }
    pos = eol + 2;
  }
  out += "server: pingoo\r\n";
  bool has_body_framing = r.chunked || r.content_length >= 0 ||
                          r.status == 204 || r.status == 304;
  bool keep = client_keep && has_body_framing;
  out += keep ? "connection: keep-alive\r\n" : "connection: close\r\n";
  out += "\r\n";
  r.rewritten = out;
  r.upstream_keep =
      has_body_framing && !conn_close && (!http10 || conn_keep);
  r.ok = true;
  return r;
}

// Rewrite a 1xx interim head with the same hop-header/server-identity
// stripping as final responses (keeping the status line; interim heads
// carry no body framing or connection semantics of their own).
std::string rewrite_interim_head(const std::string& head) {
  size_t line_end = head.find("\r\n");
  if (line_end == std::string::npos) return head;
  std::string out = head.substr(0, line_end) + "\r\n";
  size_t pos = line_end + 2;
  while (pos < head.size()) {
    size_t eol = head.find("\r\n", pos);
    if (eol == std::string::npos || eol == pos) break;
    size_t colon = head.find(':', pos);
    std::string lname = colon != std::string::npos && colon < eol
                            ? lower(head.substr(pos, colon - pos))
                            : "";
    if (!strip_response_header(lname)) {
      out.append(head, pos, eol + 2 - pos);
    }
    pos = eol + 2;
  }
  out += "\r\n";
  return out;
}

// ---------------------------------------------------------------------------
// connections

enum class ConnState {
  kHandshake,
  kReadingHead,
  kAwaitingVerdict,
  kProxying,
  kTunnel,   // protocol upgrade accepted: raw bidirectional splice
  kH2,       // HTTP/2 connection (nghttp2 session owns framing)
  kClosing,  // drain outbuf, then close
};

struct Conn;

struct SockRef {
  Conn* conn = nullptr;  // nullptr = the listening socket
  bool is_upstream = false;
  int32_t h2_sid = 0;  // nonzero: a per-h2-stream upstream socket
};

struct Conn {
  int fd = -1;
  int upstream_fd = -1;
  SSL* ssl = nullptr;           // non-null on TLS connections
  SSL_CTX* owned_ctx = nullptr;  // per-conn challenge ctx (tls-alpn-01)
  bool ssl_want_write = false;
  bool acme_challenge = false;
  ConnState state = ConnState::kReadingHead;

  std::string inbuf;   // client bytes not yet consumed
  std::string outbuf;  // bytes pending to client
  std::string upbuf;   // bytes pending to upstream

  // current request cycle
  Parsed req;
  BodyFramer req_body;
  bool req_body_forwarded = false;  // all request bytes handed to upbuf
  bool captcha_verified = false;
  int requests_served = 0;

  // Streaming body inspection (ISSUE 13, docs/BODY_STREAMING.md) — h1
  // cycles only. The body de-frames through a SEPARATE scan framer so
  // inbuf keeps the raw bytes for the normal post-verdict forwarding
  // path; the body verdict ticket is the request ticket with bit 63
  // set (PINGOO_BODY_VERDICT_BIT).
  bool body_inspect = false;       // this cycle streams body windows
  uint64_t body_flow = UINT64_MAX; // ring ticket doubling as the flow id
  BodyFramer body_scan;            // de-framing copy (req_body untouched)
  std::string body_win;            // de-framed payload pending a window
  uint32_t body_win_seq = 0;       // next window sequence number
  uint64_t body_total = 0;         // de-framed payload bytes seen so far
  size_t body_raw_seen = 0;        // inbuf prefix already scan-framed
  bool body_final_sent = false;    // FINAL window enqueued
  uint64_t body_fin_ms = 0;        // monotonic ms at FINAL enqueue
  bool meta_pending = false;       // meta verdict stashed, awaiting body
  uint8_t meta_action = 0;         // stashed metadata verdict byte
  bool body_verdict_done = false;  // body verdict byte landed
  uint8_t body_action = 0;         // body verdict byte

  // upstream response
  std::string resp_head_buf;
  bool resp_head_done = false;
  BodyFramer resp_body;
  bool close_after_response = false;

  uint64_t ticket = UINT64_MAX;
  char peer_ip[INET6_ADDRSTRLEN] = {0};
  uint16_t peer_port = 0;
  bool dead = false;
  bool upstream_connected = false;
  bool upstream_eof = false;
  bool up_trunc = false;        // upstream ended with an ERROR, not clean EOF
  int tcp_attempts = 0;         // tcp-proxy mode: connect tries so far
  time_t tcp_connect_at = 0;    // tcp-proxy mode: when this try started
  bool down_shut = false;       // write side toward the CLIENT shut
                                // (tcp mode: upstream FIN propagated)
  UpH2Link* up_h2 = nullptr;    // non-null: upstream link speaks h2
  std::string up_head;          // rewritten h1 head (kept until the
                                // upstream protocol is decided by ALPN)
  bool up_proto_pending = false;  // TLS target: h1-vs-h2 awaits ALPN
  uint64_t up_key = 0;          // pool key of the connected target
  UpTarget up_target{};         // connected target (pooled-retry)
  SSL* up_ssl = nullptr;        // non-null on TLS upstream links
  bool up_tcp_ok = false;       // TCP connect completed
  bool up_tls_hs = false;       // client handshake in progress
  bool up_hs_want_write = false;  // handshake blocked on EPOLLOUT
  bool up_rd_want_write = false;  // SSL_read wants the write event
  bool up_wr_want_read = false;   // SSL_write wants the read event
  bool upstream_keep = false;   // response head allows connection reuse
  bool upstream_junk = false;   // upstream sent bytes past the response
  uint64_t enq_ms = 0;          // monotonic ms at ring enqueue (metrics)
  bool up_shut = false;         // tunnel: upstream write side FIN'd
  bool upstream_pooled = false; // current upstream fd came from the pool
  std::string up_replay;        // bytes sent upstream (pooled-retry replay)
  bool client_eof = false;
  time_t last_active = 0;
  SockRef client_ref;
  SockRef upstream_ref;

  // -- HTTP/2 mode (state == kH2) --
  nghttp2_session* h2 = nullptr;
  std::unordered_map<int32_t, H2Stream> h2_streams;
  std::vector<int32_t> h2_ready;   // completed requests awaiting service
  std::vector<int32_t> h2_proxy_wait;  // verdicted, waiting for a slot
  int h2_upstreams = 0;            // streams with an open upstream socket
  // Per-stream response bodies served through the data provider (a
  // client flow-control stall can defer DATA past the next stream).
  std::unordered_map<int32_t, std::pair<std::string, size_t>> h2_send;
  time_t verdict_at = 0;           // when the active ticket was enqueued
};

class Server;
Server* g_server = nullptr;
volatile sig_atomic_t g_sigterm = 0;

const char k403[] =
    "HTTP/1.1 403 Forbidden\r\nserver: pingoo\r\n"
    "content-type: text/plain\r\ncontent-length: 9\r\n"
    "connection: close\r\n\r\nForbidden";
const char kCaptcha[] =
    "HTTP/1.1 302 Found\r\nserver: pingoo\r\n"
    "location: /__pingoo/captcha\r\ncontent-length: 0\r\n"
    "connection: close\r\n\r\n";
const char k502[] =
    "HTTP/1.1 502 Bad Gateway\r\nserver: pingoo\r\n"
    "content-type: text/plain\r\ncontent-length: 11\r\n"
    "connection: close\r\n\r\nBad Gateway";
const char k400[] =
    "HTTP/1.1 400 Bad Request\r\nserver: pingoo\r\n"
    "content-length: 0\r\nconnection: close\r\n\r\n";
const char k413[] =
    "HTTP/1.1 413 Content Too Large\r\nserver: pingoo\r\n"
    "content-length: 0\r\nconnection: close\r\n\r\n";
const char k431[] =
    "HTTP/1.1 431 Request Header Fields Too Large\r\nserver: pingoo\r\n"
    "content-length: 0\r\nconnection: close\r\n\r\n";
const char k404[] =
    "HTTP/1.1 404 Not Found\r\nserver: pingoo\r\n"
    "content-type: text/plain\r\ncontent-length: 9\r\n"
    "connection: close\r\n\r\nNot Found";

// -- service routing table ---------------------------------------------------
//
// The reference selects the FIRST service whose route predicate matches
// the request and load-balances across that service's discovered
// upstreams (http_listener.rs:266-270, http_proxy_service.rs:101,118,
// service_registry.rs:54-103). Here the route decision is computed by
// the verdict sidecar ON DEVICE (the route predicates ride the same
// batched verdict as the WAF rules) and arrives in the verdict byte's
// bits 3-7: the winning service's order index, 31 = no service matched.
// This plane owns only the dispatch: service order -> upstream set ->
// random member.
//
// The table is a text file written by the control plane (registry
// snapshots, native_ring.write_services_file) and hot-reloaded on
// mtime change, the same freshness discipline as the JWKS gate:
//
//   pingoo-services v1
//   service 0 web
//   upstream 127.0.0.1 8081
//   upstream 127.0.0.1 8082
//   service 1 api
//   upstream 127.0.0.1 9001
//   upstream 10.0.0.9 8443 tls backend.example.com
//
// An `upstream <ip> <port> tls <server-name>` entry is proxied over a
// verified TLS client connection (SNI + hostname check against
// <server-name>), matching the reference's pooled hyper-rustls client
// (http_proxy_service.rs:54-71).
struct ServiceTable {
  std::string path;
  std::vector<std::string> names;
  std::vector<std::vector<UpTarget>> upstreams;  // by service order
  std::vector<std::string> static_roots;  // "" = not a static service
  bool loaded = false;
  time_t last_check_ = 0;
  time_t mtime_s_ = 0;
  long mtime_ns_ = 0;

  bool reload() {
    struct stat st;
    if (path.empty() || stat(path.c_str(), &st) != 0) return loaded;
    if (loaded && st.st_mtime == mtime_s_ &&
        st.st_mtim.tv_nsec == mtime_ns_)
      return true;
    FILE* f = fopen(path.c_str(), "r");
    if (f == nullptr) return loaded;
    std::vector<std::string> new_names;
    std::vector<std::vector<UpTarget>> new_ups;
    std::vector<std::string> new_static;
    int static_consumed = 0;
    char line[512];
    bool ok = true;
    while (fgets(line, sizeof(line), f) != nullptr) {
      char a[256], b[256], sni[256];
      int port = 0, order = 0;
      if (sscanf(line, "service %d %255s", &order, a) == 2) {
        if (order != static_cast<int>(new_names.size()) || order > 30) {
          // Orders must be dense and in file order, and fit the 5-bit
          // route field (0-30; 31 is the no-match sentinel).
          ok = false;
          break;
        }
        new_names.emplace_back(a);
        new_ups.emplace_back();
        new_static.emplace_back();
      } else if (char sroot[384];
                 sscanf(line, "static %383s%n", sroot,
                        &static_consumed) == 1) {
        // Static site root for the CURRENT service (reference
        // http_static_site_service.rs): files <= 500 KB are served
        // from this binary; bigger ones proxy to the service's
        // upstream list (the streaming control plane).
        const char* tail = line + static_consumed;
        while (*tail == ' ' || *tail == '\t') tail++;
        if (new_static.empty() ||
            (*tail != '\0' && *tail != '\n' && *tail != '\r')) {
          // trailing fields (version skew) or a root past the %383s
          // scan width: reject the table, keep the last good one —
          // the same fail-closed rule as the tls/h2/internal markers.
          ok = false;
          break;
        }
        new_static.back() = sroot;
      } else if (int consumed = 0;
                 sscanf(line, "upstream %255s %d%n", b, &port,
                        &consumed) == 2) {
        if (new_ups.empty() || port <= 0 || port > 65535) {
          ok = false;
          break;
        }
        UpTarget t;
        t.sa.sin_family = AF_INET;
        t.sa.sin_port = htons(static_cast<uint16_t>(port));
        if (inet_pton(AF_INET, b, &t.sa.sin_addr) != 1) {
          ok = false;
          break;
        }
        const char* rest = line + consumed;
        while (*rest == ' ' || *rest == '\t') rest++;
        if (strncmp(rest, "tls", 3) == 0 &&
            (rest[3] == ' ' || rest[3] == '\t')) {
          int used = 0;
          if (sscanf(rest, "tls %255s%n", sni, &used) == 1) {
            const char* tail = rest + used;
            while (*tail == ' ' || *tail == '\t') tail++;
            if (*tail != '\0' && *tail != '\n' && *tail != '\r') {
              ok = false;  // fields past the name (version skew, or an
              // over-long truncated name): reject, keep last good table
              break;
            }
            t.tls = true;
            t.sni = sni;
          } else {
            // `tls` with no server name must NOT fail open to a
            // plaintext hop: reject the table, keep the last good one.
            ok = false;
            break;
          }
        } else if (strncmp(rest, "h2", 2) == 0 &&
                   (rest[2] == '\0' || rest[2] == '\n' || rest[2] == '\r' ||
                    rest[2] == ' ' || rest[2] == '\t')) {
          const char* tail = rest + 2;
          while (*tail == ' ' || *tail == '\t') tail++;
          if (*tail != '\0' && *tail != '\n' && *tail != '\r') {
            ok = false;  // fields past the marker: version skew
            break;
          }
          t.h2 = true;  // cleartext prior-knowledge h2 target
        } else if (strncmp(rest, "internal", 8) == 0 &&
                   (rest[8] == '\0' || rest[8] == '\n' || rest[8] == '\r' ||
                    rest[8] == ' ' || rest[8] == '\t')) {
          const char* tail = rest + 8;
          while (*tail == ' ' || *tail == '\t') tail++;
          if (*tail != '\0' && *tail != '\n' && *tail != '\r') {
            ok = false;  // fields past the marker: version skew
            break;
          }
          t.internal = true;  // loopback control-plane target
        } else if (*rest != '\0' && *rest != '\n' && *rest != '\r') {
          ok = false;  // unknown trailing fields: same fail-closed rule
          break;
        }
        new_ups.back().push_back(std::move(t));
      }
      // other lines (header, comments, blank) are ignored
    }
    fclose(f);
    if (!ok || new_names.empty()) return loaded;  // keep last good table
    names = std::move(new_names);
    upstreams = std::move(new_ups);
    static_roots = std::move(new_static);
    loaded = true;
    mtime_s_ = st.st_mtime;
    mtime_ns_ = st.st_mtim.tv_nsec;
    return true;
  }

  void maybe_reload(time_t now) {
    if (path.empty() || now == last_check_) return;
    last_check_ = now;
    reload();
  }
};

class Server {
 public:
  Server(int ep, void* ring, const sockaddr_in& upstream,
         const sockaddr_in* captcha_upstream, CaptchaGate* gate,
         TlsStore* tls, ServiceTable* services = nullptr,
         SSL_CTX* up_ctx = nullptr, std::string internal_token = "",
         bool tcp_mode = false)
      : ep_(ep),
        ring_(ring),
        upstream_(upstream),
        gate_(gate),
        tls_(tls),
        services_(services),
        up_ctx_(up_ctx),
        internal_token_(std::move(internal_token)),
        tcp_mode_(tcp_mode) {
    if (captcha_upstream) {
      captcha_upstream_ = *captcha_upstream;
      has_captcha_upstream_ = true;
    }
  }

  // -- service routing -------------------------------------------------------

  enum class Route { kOk, kNoService, kNoUpstream };

  // Resolve the verdict byte's route bits (bits 3-7: service order,
  // 31 = none matched) to a concrete upstream address. Without a
  // services table every request goes to the single argv upstream
  // (the pre-routing deployment shape).
  Route pick_route_target(uint8_t route, UpTarget* out) {
    if (services_ == nullptr || !services_->loaded) {
      out->sa = upstream_;
      out->internal = true;  // the argv upstream is the loopback plane
      return Route::kOk;
    }
    if (route >= services_->upstreams.size()) return Route::kNoService;
    const auto& set = services_->upstreams[route];
    if (set.empty()) return Route::kNoUpstream;
    // xorshift32: cheap per-request random member selection, matching
    // the reference's random upstream pick (http_proxy_service.rs:101).
    rng_ ^= rng_ << 13;
    rng_ ^= rng_ >> 17;
    rng_ ^= rng_ << 5;
    *out = set[rng_ % set.size()];
    return Route::kOk;
  }

  // Fail-open target (ring full / verdict timeout): no route decision
  // exists, so fall back to the FIRST service — the same default the
  // argv upstream provides without a table.
  bool default_target(UpTarget* out) {
    if (services_ == nullptr || !services_->loaded) {
      out->sa = upstream_;
      out->internal = true;  // the argv upstream is the loopback plane
      return true;
    }
    if (!services_->upstreams.empty() && !services_->upstreams[0].empty()) {
      return pick_route_target(0, out) == Route::kOk;
    }
    return false;
  }

  // -- native static site serving -------------------------------------------
  // Reference http_static_site_service.rs:83-257: GET/HEAD only (405),
  // traversal guard (404), dir -> index.html, extensionless -> .html
  // prettify, ETag = SHA256(path, size, mtime_ns) with If-None-Match
  // -> 304, <= 500 KB files cached (500 entries); larger files proxy
  // to the service's upstream list (the control plane streams them —
  // the one delta from the reference, which streams in-binary).

  struct StaticFile {
    uint64_t size = 0;
    uint64_t mtime_ns = 0;
    std::string data;
  };
  static constexpr uint64_t kStaticCacheFileLimit = 500000;  // 500 KB
  static constexpr size_t kStaticCacheEntries = 500;

  static const char* mime_for(const std::string& path) {
    size_t dot = path.rfind('.');
    std::string ext = dot == std::string::npos ? "" : path.substr(dot + 1);
    for (auto& ch : ext) ch = static_cast<char>(tolower(ch));
    if (ext == "html" || ext == "htm") return "text/html";
    if (ext == "css") return "text/css";
    if (ext == "js" || ext == "mjs") return "text/javascript";
    if (ext == "json") return "application/json";
    if (ext == "png") return "image/png";
    if (ext == "jpg" || ext == "jpeg") return "image/jpeg";
    if (ext == "gif") return "image/gif";
    if (ext == "svg") return "image/svg+xml";
    if (ext == "webp") return "image/webp";
    if (ext == "ico") return "image/vnd.microsoft.icon";
    if (ext == "txt") return "text/plain";
    if (ext == "xml") return "application/xml";
    if (ext == "pdf") return "application/pdf";
    if (ext == "wasm") return "application/wasm";
    if (ext == "woff2") return "font/woff2";
    if (ext == "woff") return "font/woff";
    if (ext == "mp4") return "video/mp4";
    return "application/octet-stream";
  }

  struct StaticResult {
    int status = 0;         // 200 / 304 / 404 / 405 / 500
    bool oversized = false;  // caller proxies to the upstream list
    std::string body;
    std::vector<std::pair<std::string, std::string>> headers;
    uint64_t file_size = 0;  // entity size (HEAD advertises it)
  };

  StaticResult static_lookup(const std::string& root,
                             const std::string& method,
                             const std::string& target,
                             const std::string& if_none_match) {
    StaticResult out;
    auto plain = [&out](int status, const char* body) -> StaticResult& {
      out.status = status;
      out.body = body;
      out.headers.emplace_back("content-type", "text/plain");
      out.file_size = out.body.size();
      return out;
    };
    if (method != "GET" && method != "HEAD")
      return plain(405, "Method Not Allowed");
    std::string path = target.substr(0, target.find('?'));
    // trim leading/trailing '/' like the reference, then guard
    size_t b = path.find_first_not_of('/');
    size_t e = path.find_last_not_of('/');
    path = b == std::string::npos ? "" : path.substr(b, e - b + 1);
    if (path.find("/..") != std::string::npos ||
        path.find("../") != std::string::npos || path == ".." ||
        path.find("//") != std::string::npos)
      return plain(404, "Not Found");
    std::string full = root + "/" + path;
    struct stat st;
    if (stat(full.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) {
      full += path.empty() ? "index.html" : "/index.html";
      if (stat(full.c_str(), &st) != 0 || S_ISDIR(st.st_mode))
        return plain(404, "Not Found");
    } else if (stat(full.c_str(), &st) != 0) {
      // prettify: extensionless /page -> /page.html
      size_t slash = full.rfind('/');
      if (full.find('.', slash + 1) != std::string::npos)
        return plain(404, "Not Found");
      full += ".html";
      if (stat(full.c_str(), &st) != 0 || S_ISDIR(st.st_mode))
        return plain(404, "Not Found");
    }
    uint64_t size = static_cast<uint64_t>(st.st_size);
    uint64_t mtime_ns = static_cast<uint64_t>(st.st_mtim.tv_sec) *
                            1000000000ull +
                        static_cast<uint64_t>(st.st_mtim.tv_nsec);
    // ETag = sha256(path, size_le, mtime_le) (reference :150-160)
    unsigned char md[32];
    unsigned int mdlen = 0;
    std::string etag_src = full;
    etag_src.append(reinterpret_cast<const char*>(&size), 8);
    etag_src.append(reinterpret_cast<const char*>(&mtime_ns), 8);
    EVP_Digest(etag_src.data(), etag_src.size(), md, &mdlen, EVP_sha256(),
               nullptr);
    static const char hexd[] = "0123456789abcdef";
    std::string etag = "\"";
    for (unsigned i = 0; i < mdlen; ++i) {
      etag += hexd[md[i] >> 4];
      etag += hexd[md[i] & 15];
    }
    etag += "\"";
    std::vector<std::pair<std::string, std::string>> base_headers = {
        {"content-type", mime_for(full)},
        {"cache-control", "public, max-age=0, must-revalidate"},
        {"etag", etag},
    };
    // If-None-Match (W/ prefix + quotes stripped, reference :161-183)
    std::string inm = if_none_match;
    size_t s0 = inm.find_first_not_of(" \t");
    if (s0 != std::string::npos) inm = inm.substr(s0);
    if (inm.compare(0, 2, "W/") == 0) inm = inm.substr(2);
    while (!inm.empty() && (inm.front() == '"')) inm.erase(0, 1);
    while (!inm.empty() && (inm.back() == '"' || inm.back() == ' '))
      inm.pop_back();
    if (!inm.empty() && etag == "\"" + inm + "\"") {
      out.status = 304;
      out.headers = base_headers;
      out.file_size = size;
      return out;
    }
    if (size > kStaticCacheFileLimit) {
      out.oversized = true;  // control plane streams it
      return out;
    }
    auto it = file_cache_.find(full);
    if (it != file_cache_.end() && it->second.size == size &&
        it->second.mtime_ns == mtime_ns) {
      out.status = 200;
      out.body = it->second.data;
      out.headers = base_headers;
      out.file_size = size;
      return out;
    }
    FILE* f = fopen(full.c_str(), "rb");
    if (f == nullptr)
      return plain(500, "Internal Server Error");
    std::string data;
    data.resize(size);
    size_t got = fread(data.data(), 1, size, f);
    fclose(f);
    if (got != size) {
      // stat-then-read race: the file was truncated/replaced between
      // the stat and the read. Serving `got` bytes under the stat'd
      // content-length would corrupt the client's framing, and caching
      // the short body would pin the corruption until the mtime
      // changes again — fail the request and cache nothing.
      return plain(500, "Internal Server Error");
    }
    if (file_cache_.size() >= kStaticCacheEntries)
      file_cache_.erase(file_cache_.begin());
    file_cache_[full] = StaticFile{size, mtime_ns, data};
    out.status = 200;
    out.body = std::move(data);
    out.headers = base_headers;
    out.file_size = size;
    return out;
  }

  // Generic keep-alive-aware h1 response for natively served content.
  // content_length < 0 omits the header entirely (304: RFC 9110 §8.6 —
  // a stated length must match the SELECTED representation, and the
  // 304 carries no body to derive it from).
  void respond_h1(Conn* c, int status, const char* reason,
                  const std::vector<std::pair<std::string, std::string>>&
                      extra_headers,
                  const std::string& body, bool head_only,
                  long long content_length) {
    bool keep = c->req.keep_alive && c->req_body.done;
    c->outbuf += "HTTP/1.1 " + std::to_string(status) + " " + reason +
                 "\r\nserver: pingoo\r\n";
    if (content_length >= 0)
      c->outbuf += "content-length: " + std::to_string(content_length) +
                   "\r\n";
    for (const auto& kv : extra_headers)
      c->outbuf += kv.first + ": " + kv.second + "\r\n";
    c->outbuf += keep ? "connection: keep-alive\r\n\r\n"
                      : "connection: close\r\n\r\n";
    if (!head_only) c->outbuf += body;
    if (!flush_out(c)) {
      mark_close(c);
      return;
    }
    if (!keep) {
      c->state = ConnState::kClosing;
      if (c->outbuf.empty()) mark_close(c);
      else update_client_events(c);
      return;
    }
    begin_request_cycle(c);
  }

  static const char* reason_for(int status) {
    switch (status) {
      case 200: return "OK";
      case 304: return "Not Modified";
      case 404: return "Not Found";
      case 405: return "Method Not Allowed";
      default: return "Internal Server Error";
    }
  }

  // True when the request was fully answered natively; false -> the
  // caller proxies to the service's upstream list (oversized file).
  bool try_static_h1(Conn* c, const std::string& root) {
    std::string inm;
    const std::string& head = c->req.raw_head;
    size_t pos = head.find("\r\n");
    pos = pos == std::string::npos ? head.size() : pos + 2;
    while (pos < head.size()) {
      size_t eol = head.find("\r\n", pos);
      if (eol == std::string::npos || eol == pos) break;
      size_t colon = head.find(':', pos);
      if (colon != std::string::npos && colon < eol) {
        std::string nm = lower(head.substr(pos, colon - pos));
        if (nm == "if-none-match") {
          size_t vs = colon + 1;
          while (vs < eol && head[vs] == ' ') vs++;
          inm = head.substr(vs, eol - vs);
          break;
        }
      }
      pos = eol + 2;
    }
    StaticResult r = static_lookup(root, c->req.method, c->req.target, inm);
    if (r.oversized) return false;
    bool head_only = c->req.method == "HEAD" || r.status == 304;
    long long cl = r.status == 304
                       ? -1
                       : static_cast<long long>(r.file_size);
    respond_h1(c, r.status, reason_for(r.status), r.headers, r.body,
               head_only, cl);
    return true;
  }

  bool try_static_h2(Conn* c, int32_t sid, H2Stream& st,
                     const std::string& root) {
    std::string inm;
    for (const auto& kv : st.p.h2_headers) {
      if (kv.first == "if-none-match") {
        inm = kv.second;
        break;
      }
    }
    StaticResult r = static_lookup(root, st.p.method, st.p.target, inm);
    if (r.oversized) return false;
    bool head_only = st.p.method == "HEAD" || r.status == 304;
    // 304 omits content-length (RFC 9110 §8.6); HEAD advertises the
    // full entity size while sending no body.
    long long cl = r.status == 304
                       ? -1
                       : static_cast<long long>(r.file_size);
    h2_submit(c, sid, r.status, r.headers,
              head_only ? std::string() : r.body, cl);
    h2_process_next(c);
    return true;
  }

  void dispatch_route(Conn* c, uint8_t route) {
    if (services_ != nullptr && services_->loaded &&
        route < services_->static_roots.size() &&
        !services_->static_roots[route].empty()) {
      if (try_static_h1(c, services_->static_roots[route])) return;
      // oversized file: fall through to the service's upstream list
    }
    UpTarget target;
    switch (pick_route_target(route, &target)) {
      case Route::kOk:
        start_proxy(c, target);
        return;
      case Route::kNoService:
        // Reference: no service matched -> 404 (http_listener.rs:270).
        stats_.no_service++;
        respond_close(c, k404);
        return;
      case Route::kNoUpstream:
        respond_502(c);
        return;
    }
  }

  void h2_dispatch_route(Conn* c, int32_t sid, uint8_t route) {
    if (services_ != nullptr && services_->loaded &&
        route < services_->static_roots.size() &&
        !services_->static_roots[route].empty()) {
      auto it = c->h2_streams.find(sid);
      if (it != c->h2_streams.end() &&
          try_static_h2(c, sid, it->second,
                        services_->static_roots[route]))
        return;
    }
    UpTarget target;
    switch (pick_route_target(route, &target)) {
      case Route::kOk:
        h2_start_stream_proxy(c, sid, target);
        return;
      case Route::kNoService:
        stats_.no_service++;
        h2_respond_simple(c, sid, 404, "Not Found");
        return;
      case Route::kNoUpstream:
        stats_.upstream_fail++;
        h2_respond_simple(c, sid, 502, "Bad Gateway");
        return;
    }
  }

  void fail_open_proxy(Conn* c) {
    UpTarget target;
    if (default_target(&target)) {
      start_proxy(c, target);
    } else {
      respond_502(c);
    }
  }

  void h2_stream_fail_open(Conn* c, int32_t sid) {
    UpTarget target;
    if (default_target(&target)) {
      h2_start_stream_proxy(c, sid, target);
    } else {
      stats_.upstream_fail++;
      h2_respond_simple(c, sid, 502, "Bad Gateway");
    }
  }

  TlsStore* tls() { return tls_; }

  void add_client(int cfd, const sockaddr_in& peer, SSL_CTX* base_ctx) {
    Conn* c = new Conn();
    c->fd = cfd;
    c->last_active = now_;
    c->client_ref.conn = c;
    c->upstream_ref.conn = c;
    c->upstream_ref.is_upstream = true;
    inet_ntop(AF_INET, &peer.sin_addr, c->peer_ip, sizeof(c->peer_ip));
    c->peer_port = ntohs(peer.sin_port);
    if (base_ctx != nullptr) {
      c->ssl = SSL_new(base_ctx);
      SSL_set_fd(c->ssl, cfd);
      SSL_set_accept_state(c->ssl);
      c->state = ConnState::kHandshake;
      // The client-hello callback needs the Conn to stash challenge
      // state; OpenSSL gives us per-SSL ex_data, but a side map is
      // simpler with the shim surface we declare.
      ssl_conn_[c->ssl] = c;
    }
    conns_.insert(c);
    epoll_event ce{};
    ce.events = EPOLLIN;
    ce.data.ptr = &c->client_ref;
    epoll_ctl(ep_, EPOLL_CTL_ADD, cfd, &ce);
    if (tcp_mode_ && c->ssl == nullptr) start_tcp_proxy(c);
    // tcp+tls: the handshake completes first (SNI cert store +
    // acme-tls/1 interception run exactly as for https — reference
    // accept_tls_connection serves both listener kinds,
    // listeners/mod.rs:112-154), then on_handshake starts the pump.
  }

  // -- raw TCP(+TLS) fronting (reference tcp_listener.rs:39-70 +
  //    tcp_proxy_service.rs:30-84): accept -> pick a random upstream
  //    (3 tries, 3 s connect timeout) -> bidirectional byte splice.
  //    Reuses the kTunnel state machine (the WebSocket splice path).

  void start_tcp_proxy(Conn* c) {
    UpTarget target;
    if (!default_target(&target)) {
      // Empty table (discovery warm-up / all upstreams gone): park and
      // let the retry ladder ride through the outage instead of
      // dropping the client on first sight.
      tcp_proxy_fail(c);
      return;
    }
    if (target.tls && up_ctx_ == nullptr) {
      stats_.upstream_fail++;
      mark_close(c);
      return;
    }
    int ufd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (ufd < 0 ||
        (connect(ufd, reinterpret_cast<const sockaddr*>(&target.sa),
                 sizeof(target.sa)) != 0 &&
         errno != EINPROGRESS)) {
      if (ufd >= 0) close(ufd);
      tcp_proxy_fail(c);
      return;
    }
    c->upstream_fd = ufd;
    c->up_key = 0;
    c->up_target = target;
    c->upstream_pooled = false;
    reset_up_link(c);
    c->tcp_connect_at = now_;
    c->state = ConnState::kTunnel;
    epoll_event ue{};
    ue.events = EPOLLOUT | EPOLLIN;
    ue.data.ptr = &c->upstream_ref;
    epoll_ctl(ep_, EPOLL_CTL_ADD, ufd, &ue);
    update_client_events(c);
  }

  void tcp_proxy_fail(Conn* c) {
    // Retry CONNECT only — once bytes may have flowed, a re-dial would
    // splice two different upstream streams together.
    bool mid_stream = c->upstream_connected;
    close_upstream(c);
    if (!mid_stream && ++c->tcp_attempts < tcp_connect_retries()) {
      if (c->tcp_attempts == 1) {
        // First failure: immediate re-dial (fresh random member).
        start_tcp_proxy(c);
      } else {
        // Later failures: PARK (state kTunnel, no upstream fd); the
        // per-second sweep re-dials, so retries span real upstream
        // recovery time (container restart, discovery refresh) instead
        // of burning all tries in one ECONNREFUSED microsecond — the
        // reference sleeps between tries and re-snapshots upstreams
        // for the same reason (tcp_proxy_service.rs:86-112).
        c->state = ConnState::kTunnel;
        c->tcp_connect_at = now_;
        update_client_events(c);
      }
      return;
    }
    stats_.upstream_fail++;
    mark_close(c);
  }

  Conn* conn_for_ssl(SSL* ssl) {
    auto it = ssl_conn_.find(ssl);
    return it == ssl_conn_.end() ? nullptr : it->second;
  }

  void mark_close(Conn* c) {
    if (c->dead) return;
    c->dead = true;
    doomed_.push_back(c);
  }

  void flush_doomed() {
    for (Conn* c : doomed_) {
      if (c->h2 != nullptr) {
        nghttp2_session_del(c->h2);
        c->h2 = nullptr;
      }
      if (c->ssl) {
        SSL_shutdown(c->ssl);
        ssl_conn_.erase(c->ssl);
        SSL_free(c->ssl);
        ERR_clear_error();
      }
      if (c->owned_ctx) SSL_CTX_free(c->owned_ctx);
      if (c->fd >= 0) {
        epoll_ctl(ep_, EPOLL_CTL_DEL, c->fd, nullptr);
        close(c->fd);
      }
      close_upstream(c);
      for (auto& kv : c->h2_streams)
        h2_release_stream_resources(c, kv.second);
      if (c->ticket != UINT64_MAX) awaiting_.erase(c->ticket);
      body_abort(c);  // frees the sidecar flow + the demux entry
      conns_.erase(c);
      delete c;
    }
    doomed_.clear();
    for (SockRef* r : doomed_refs_) {
      r->conn = nullptr;
      delete r;
    }
    doomed_refs_.clear();
  }

  void set_now(time_t t) { now_ = t; }

  void queue_ssl_resume(Conn* c, int32_t sid) {
    for (const auto& e : ssl_resume_)
      if (e.first == c && e.second == sid) return;
    ssl_resume_.emplace_back(c, sid);
  }

  // Deliver reads for data already decrypted inside SSL objects: epoll
  // cannot signal it (nothing is on the fd), so update_*_events queues
  // the link and the main loop drains the queue after each batch.
  void process_ssl_resume() {
    if (ssl_resume_.empty()) return;
    std::vector<std::pair<Conn*, int32_t>> work;
    work.swap(ssl_resume_);
    for (const auto& e : work) {
      Conn* c = e.first;
      if (conns_.find(c) == conns_.end() || c->dead) continue;
      if (e.second == 0) {
        if (c->upstream_fd >= 0 && proxy_live(c))
          on_upstream_event(c, EPOLLIN);
      } else {
        h2_stream_upstream_event(c, e.second, EPOLLIN);
      }
    }
  }

  bool awaiting_verdicts() const {
    return !awaiting_.empty() || !body_awaiting_.empty();
  }

  // -- metrics ---------------------------------------------------------------
  // The serving path must be observable where the traffic actually is
  // (SURVEY §5 calls the metrics surface a build requirement): counters
  // + a verdict-wait histogram, served at /__pingoo/metrics on both
  // protocols. The reference ships no metrics endpoint at all.

  struct Stats {
    uint64_t requests = 0;        // parsed requests (h1 cycles + h2 streams)
    uint64_t blocked = 0;         // 403 verdicts applied
    uint64_t captcha = 0;         // challenge redirects served
    uint64_t ua_rejected = 0;     // empty/oversized UA pre-ring 403s
    uint64_t fail_open = 0;       // ring-full + verdict-timeout proxies
    uint64_t no_service = 0;      // route bits said no service (404)
    uint64_t upstream_fail = 0;   // 502s
    uint64_t upstream_tls_fail = 0;  // client handshake/verify failures
    uint64_t verdicts = 0;        // verdict bytes applied
    uint64_t degraded_entered = 0;  // degraded-mode transitions (enter)
    // Streaming body inspection (ISSUE 13, PINGOO_BODY_INSPECT=on).
    uint64_t body_flows = 0;      // h1 cycles armed for inspection
    uint64_t body_windows = 0;    // body windows enqueued to the ring
    uint64_t body_bytes = 0;      // de-framed payload bytes enqueued
    uint64_t body_verdicts = 0;   // body verdict bytes consumed
    uint64_t body_fail_open = 0;  // flows degraded to metadata-only
                                  // (ring full / hold cap / deadline /
                                  // degraded mode / bad framing)
    uint64_t body_h2_skipped = 0; // h2 streams left metadata-only
    // log-scale verdict wait histogram (enqueue -> apply), upper bounds
    // in ms: 1, 2, 5, 10, 50, 100, 1000, +inf — the SHARED bucket set
    // (pingoo_tpu/obs/schema.py SHARED_WAIT_BUCKETS_MS); the JSON
    // surface folds the last two into its legacy "inf" key.
    uint64_t wait_hist[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint64_t wait_sum_ms = 0;     // for the histogram _sum series
  };

  static uint64_t now_ms() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000 +
           static_cast<uint64_t>(ts.tv_nsec) / 1000000;
  }

  void record_wait(uint64_t ms) {
    static const uint64_t bounds[7] = {1, 2, 5, 10, 50, 100, 1000};
    int b = 7;
    for (int i = 0; i < 7; ++i) {
      if (ms < bounds[i]) {
        b = i;
        break;
      }
    }
    stats_.wait_hist[b]++;
    stats_.wait_sum_ms += ms;
  }

  // JSON body, built with std::string: the old fixed 1024-byte snprintf
  // buffer was ~100 bytes from silent truncation (= invalid JSON on the
  // wire) and every new field raised the risk. Schema is back-compat:
  // the legacy keys keep their names, the ring telemetry block rides
  // under "ring", and the legacy 7-bucket "verdict_wait_ms_hist" folds
  // the new le1000 bucket into its "inf" key.
  std::string metrics_body() {
    uint64_t tel[PINGOO_TELEMETRY_WORDS];
    pingoo_ring_telemetry_snapshot(ring_, tel);
    uint64_t ring_pending = tel[3];
    size_t pooled = 0;
    for (const auto& kv : upstream_pool_) pooled += kv.second.size();
    std::string out = "{";
    auto kv_u64 = [&out](const char* key, uint64_t v, bool first = false) {
      if (!first) out += ", ";
      out += "\"";
      out += key;
      out += "\": ";
      out += std::to_string(v);
    };
    kv_u64("requests", stats_.requests, true);
    kv_u64("blocked", stats_.blocked);
    kv_u64("captcha", stats_.captcha);
    kv_u64("ua_rejected", stats_.ua_rejected);
    kv_u64("fail_open", stats_.fail_open);
    kv_u64("no_service", stats_.no_service);
    kv_u64("upstream_fail", stats_.upstream_fail);
    kv_u64("upstream_tls_fail", stats_.upstream_tls_fail);
    kv_u64("verdicts", stats_.verdicts);
    out += ", \"verdict_wait_ms_hist\": {";
    static const char* kHistKeys[6] = {"le1",  "le2",  "le5",
                                       "le10", "le50", "le100"};
    for (int i = 0; i < 6; ++i) {
      if (i) out += ", ";
      out += "\"";
      out += kHistKeys[i];
      out += "\": ";
      out += std::to_string(stats_.wait_hist[i]);
    }
    out += ", \"inf\": " +
           std::to_string(stats_.wait_hist[6] + stats_.wait_hist[7]);
    out += "}";
    kv_u64("ring_pending", ring_pending);
    kv_u64("awaiting", awaiting_.size());
    kv_u64("connections", conns_.size());
    kv_u64("pooled_upstreams", pooled);
    kv_u64("degraded", degraded_ ? 1 : 0);
    kv_u64("degraded_entered", stats_.degraded_entered);
    kv_u64("sidecar_up", (sidecar_seen_ && !degraded_) ? 1 : 0);
    kv_u64("sidecar_epoch", sidecar_epoch_);
    out += ", \"body\": {";
    kv_u64("flows", stats_.body_flows, true);
    kv_u64("windows", stats_.body_windows);
    kv_u64("bytes", stats_.body_bytes);
    kv_u64("verdicts", stats_.body_verdicts);
    kv_u64("fail_open", stats_.body_fail_open);
    kv_u64("h2_skipped", stats_.body_h2_skipped);
    kv_u64("awaiting", body_awaiting_.size());
    out += "}";
    out += ", \"ring\": {";
    kv_u64("enqueued", tel[0], true);
    kv_u64("enqueue_full", tel[1]);
    kv_u64("dequeued", tel[2]);
    kv_u64("depth", tel[3]);
    kv_u64("depth_hwm", tel[4]);
    kv_u64("verdicts_posted", tel[5]);
    kv_u64("verdict_post_full", tel[6]);
    kv_u64("wait_sum_ms", tel[7]);
    out += "}}";
    return out;
  }

  // Prometheus text exposition, metric names shared with the Python
  // plane (pingoo_tpu/obs/schema.py — the parity test's contract).
  std::string metrics_prometheus() {
    uint64_t tel[PINGOO_TELEMETRY_WORDS];
    pingoo_ring_telemetry_snapshot(ring_, tel);
    size_t pooled = 0;
    for (const auto& kv : upstream_pool_) pooled += kv.second.size();
    const std::string plane = "{plane=\"native\"}";
    std::string out;
    auto metric = [&out, &plane](const char* type, const char* name,
                                 uint64_t v) {
      out += "# TYPE ";
      out += name;
      out += " ";
      out += type;
      out += "\n";
      out += name;
      out += plane;
      out += " " + std::to_string(v) + "\n";
    };
    metric("counter", "pingoo_requests_total", stats_.requests);
    metric("counter", "pingoo_blocked_total", stats_.blocked);
    metric("counter", "pingoo_captcha_total", stats_.captcha);
    metric("counter", "pingoo_fail_open_total", stats_.fail_open);
    metric("counter", "pingoo_ua_rejected_total", stats_.ua_rejected);
    metric("counter", "pingoo_no_service_total", stats_.no_service);
    metric("counter", "pingoo_upstream_fail_total", stats_.upstream_fail);
    metric("counter", "pingoo_upstream_tls_fail_total",
           stats_.upstream_tls_fail);
    metric("counter", "pingoo_verdicts_total", stats_.verdicts);
    metric("gauge", "pingoo_connections", conns_.size());
    metric("gauge", "pingoo_pooled_upstreams", pooled);
    // Sidecar supervision (ISSUE 10): sidecar_up stays 0 until a
    // heartbeat has ever landed, so "no sidecar yet" and "sidecar
    // died" alert the same way; epoch counts (re)attaches.
    metric("gauge", "pingoo_sidecar_up",
           (sidecar_seen_ && !degraded_) ? 1 : 0);
    metric("gauge", "pingoo_degraded_mode", degraded_ ? 1 : 0);
    metric("gauge", "pingoo_sidecar_epoch", sidecar_epoch_);
    metric("counter", "pingoo_degraded_entered_total",
           stats_.degraded_entered);
    // Streaming body inspection (ISSUE 13, obs/schema.py BODY_METRICS;
    // the carry-depth histogram is scanner-side and lives on the
    // sidecar's exposition). Degrades carry the caller-side reasons.
    metric("counter", "pingoo_body_windows_total", stats_.body_windows);
    metric("counter", "pingoo_body_bytes_total", stats_.body_bytes);
    metric("gauge", "pingoo_body_flows_active", body_awaiting_.size());
    out += "# TYPE pingoo_body_degrade_total counter\n";
    out += "pingoo_body_degrade_total{plane=\"native\",reason=\"fail_open\"} " +
           std::to_string(stats_.body_fail_open) + "\n";
    out += "pingoo_body_degrade_total{plane=\"native\",reason=\"h2\"} " +
           std::to_string(stats_.body_h2_skipped) + "\n";
    metric("counter", "pingoo_ring_enqueued_total", tel[0]);
    metric("counter", "pingoo_ring_enqueue_full_total", tel[1]);
    metric("counter", "pingoo_ring_dequeued_total", tel[2]);
    metric("gauge", "pingoo_ring_depth", tel[3]);
    metric("gauge", "pingoo_ring_depth_hwm", tel[4]);
    metric("counter", "pingoo_ring_verdicts_posted_total", tel[5]);
    metric("counter", "pingoo_ring_verdict_post_full_total", tel[6]);
    // Verdict wait histogram (enqueue -> verdict-apply), shared bucket
    // bounds with the Python plane's pingoo_verdict_wait_ms.
    static const char* kLe[7] = {"1", "2", "5", "10", "50", "100", "1000"};
    out += "# TYPE pingoo_verdict_wait_ms histogram\n";
    uint64_t cum = 0, total = 0;
    for (int i = 0; i < 8; ++i) total += stats_.wait_hist[i];
    for (int i = 0; i < 7; ++i) {
      cum += stats_.wait_hist[i];
      out += "pingoo_verdict_wait_ms_bucket{plane=\"native\",le=\"";
      out += kLe[i];
      out += "\"} " + std::to_string(cum) + "\n";
    }
    out += "pingoo_verdict_wait_ms_bucket{plane=\"native\",le=\"+Inf\"} " +
           std::to_string(total) + "\n";
    out += "pingoo_verdict_wait_ms_sum" + plane + " " +
           std::to_string(stats_.wait_sum_ms) + "\n";
    out += "pingoo_verdict_wait_ms_count" + plane + " " +
           std::to_string(total) + "\n";
    return out;
  }

  // Accept-negotiated body + content type: Prometheus text by default
  // (what a scraper's GET or plain curl sees), the back-compat JSON
  // under Accept: application/json.
  static bool accept_wants_json(const Parsed& p) {
    return p.accept.find("application/json") != std::string::npos;
  }

  std::string metrics_negotiated(const Parsed& p, const char** ctype) {
    if (accept_wants_json(p)) {
      *ctype = "application/json";
      return metrics_body();
    }
    *ctype = "text/plain; version=0.0.4; charset=utf-8";
    return metrics_prometheus();
  }

  std::string metrics_response(const Parsed& p) {
    const char* ctype = nullptr;
    std::string body = metrics_negotiated(p, &ctype);
    return "HTTP/1.1 200 OK\r\nserver: pingoo\r\ncontent-type: " +
           std::string(ctype) + "\r\ncontent-length: " +
           std::to_string(body.size()) + "\r\nconnection: close\r\n\r\n" +
           body;
  }

  // -- flight recorder -------------------------------------------------------
  // Bounded ring of the last kFlightN requests that reached a verdict
  // decision (ISSUE 5): the ring ticket (this plane's correlation id,
  // joins sidecar-side records at trace id "t-<ticket>"), the enqueue
  // -> apply wait, the raw verdict byte, the decided action, and a
  // sanitized method/path prefix with an FNV-1a digest over the tuple
  // fields. Served as JSON at /__pingoo/flightrecorder (h1 + h2) and
  // dumped to stderr when the SIGTERM drain starts — the native-plane
  // counterpart of pingoo_tpu/obs/flightrecorder.py.

  struct FlightEntry {
    uint64_t ticket = UINT64_MAX;  // UINT64_MAX = no ring ticket
    uint64_t wait_ms = 0;          // enqueue -> verdict apply (0 = n/a)
    uint64_t ts_ms = 0;            // CLOCK_MONOTONIC ms at record time
    uint32_t digest = 0;           // FNV-1a over method|host|path|ua
    uint8_t verdict = 0;           // raw verdict byte from the ring
    uint8_t decided = 0;           // 0 proxy 1 block 2 captcha 3 fail-open
    char method[8] = {0};
    char path[48] = {0};           // sanitized prefix, for humans
  };
  static constexpr size_t kFlightN = 256;
  FlightEntry flight_[kFlightN];
  uint64_t flight_next_ = 0;

  static uint32_t fnv1a(uint32_t h, const std::string& s) {
    for (unsigned char ch : s) {
      h ^= ch;
      h *= 16777619u;
    }
    return h;
  }

  void flight_record(const Parsed& req, uint64_t ticket, uint64_t enq_ms,
                     uint8_t verdict, uint8_t decided) {
    FlightEntry& e = flight_[flight_next_++ % kFlightN];
    uint64_t now = now_ms();
    e.ticket = ticket;
    e.wait_ms = enq_ms ? now - enq_ms : 0;
    e.ts_ms = now;
    uint32_t h = 2166136261u;
    h = fnv1a(h, req.method);
    h = fnv1a(h, req.host);
    h = fnv1a(h, req.path);
    h = fnv1a(h, req.user_agent);
    e.digest = h;
    std::snprintf(e.method, sizeof(e.method), "%s", req.method.c_str());
    // The stored path is display-only: JSON-hostile bytes (quotes,
    // backslash, controls, non-ASCII) become '_' at record time so the
    // dump below can emit it verbatim.
    size_t n = 0;
    for (char ch : req.path) {
      if (n + 1 >= sizeof(e.path)) break;
      e.path[n++] =
          (ch >= 0x20 && ch < 0x7f && ch != '"' && ch != '\\') ? ch : '_';
    }
    e.path[n] = 0;
    e.verdict = verdict;
    e.decided = decided;
  }

  std::string flightrecorder_json() {
    uint64_t total = flight_next_;
    size_t live = total < kFlightN ? static_cast<size_t>(total) : kFlightN;
    uint64_t start = total - live;
    std::string out = "{\"plane\": \"native\", \"capacity\": " +
                      std::to_string(kFlightN) +
                      ", \"recorded_total\": " + std::to_string(total) +
                      ", \"entries\": [";
    for (size_t i = 0; i < live; ++i) {
      const FlightEntry& e = flight_[(start + i) % kFlightN];
      if (i) out += ", ";
      out += "{\"ticket\": ";
      out += e.ticket == UINT64_MAX ? std::string("null")
                                    : std::to_string(e.ticket);
      char digest_hex[16];
      std::snprintf(digest_hex, sizeof(digest_hex), "%08x", e.digest);
      out += ", \"digest\": \"";
      out += digest_hex;
      out += "\", \"wait_ms\": " + std::to_string(e.wait_ms) +
             ", \"ts_ms\": " + std::to_string(e.ts_ms) +
             ", \"verdict\": " + std::to_string(e.verdict) +
             ", \"decided\": " + std::to_string(e.decided) +
             ", \"method\": \"" + e.method + "\", \"path\": \"" + e.path +
             "\"}";
    }
    out += "]}";
    return out;
  }

  std::string flightrecorder_response() {
    std::string body = flightrecorder_json();
    return "HTTP/1.1 200 OK\r\nserver: pingoo\r\ncontent-type: "
           "application/json\r\ncontent-length: " +
           std::to_string(body.size()) + "\r\nconnection: close\r\n\r\n" +
           body;
  }

  // -- cross-plane timeline (ISSUE 17) ---------------------------------------
  // Chrome-trace JSON synthesized from the SAME FlightEntry stamps the
  // flight recorder keeps: one "verdict_wait" span per recorded request,
  // [ts_ms - wait_ms, ts_ms] on the CLOCK_MONOTONIC timebase the ring
  // and both Python planes share, so tools/timeline_capture.py can
  // merge this dump with /__pingoo/timeline from the Python plane by
  // plain concatenation (same clock; the `clock` block pins it to wall
  // time for offline viewing). No extra hot-path stamps: this endpoint
  // only re-reads what flight_record() already wrote.

  std::string timeline_json() {
    uint64_t total = flight_next_;
    size_t live = total < kFlightN ? static_cast<size_t>(total) : kFlightN;
    uint64_t start = total - live;
    std::string out =
        "{\"displayTimeUnit\": \"ms\", \"clock\": {\"unit\": "
        "\"monotonic_us\", \"monotonic_now_us\": " +
        std::to_string(now_ms() * 1000) +
        ", \"wall_now_s\": " + std::to_string(::time(nullptr)) +
        "}, \"traceEvents\": [{\"ph\": \"M\", \"name\": \"process_name\", "
        "\"pid\": 3, \"tid\": 0, \"args\": {\"name\": \"pingoo:native\"}}";
    for (size_t i = 0; i < live; ++i) {
      const FlightEntry& e = flight_[(start + i) % kFlightN];
      if (!e.ts_ms) continue;
      uint64_t t0_us = (e.ts_ms - e.wait_ms) * 1000;
      out += ", {\"ph\": \"X\", \"pid\": 3, \"tid\": 1, \"name\": "
             "\"verdict_wait\", \"cat\": \"native\", \"ts\": " +
             std::to_string(t0_us) +
             ", \"dur\": " + std::to_string(e.wait_ms * 1000) +
             ", \"args\": {\"trace_id\": ";
      out += e.ticket == UINT64_MAX
                 ? std::string("null")
                 : "\"t-" + std::to_string(e.ticket) + "\"";
      out += ", \"decided\": " + std::to_string(e.decided) +
             ", \"path\": \"" + e.path + "\"}}";
    }
    out += "]}";
    return out;
  }

  std::string timeline_response() {
    std::string body = timeline_json();
    return "HTTP/1.1 200 OK\r\nserver: pingoo\r\ncontent-type: "
           "application/json\r\ncontent-length: " +
           std::to_string(body.size()) + "\r\nconnection: close\r\n\r\n" +
           body;
  }

  // -- graceful drain --------------------------------------------------------
  // SIGTERM stops accepting and drains in-flight requests with a hard
  // cap (reference drains with a 20 s limit, listeners/mod.rs:28 +
  // http_listener.rs:111-116). main() owns the drain state and calls
  // this every loop iteration once the listener is closed.

  // Close connections with no request in flight; returns live count.
  // Busy connections finish their response, return to kReadingHead,
  // and are collected on the next tick.
  size_t drain_tick() {
    for (Conn* c : conns_) {
      if (c->dead) continue;
      if (c->state == ConnState::kReadingHead && c->inbuf.empty() &&
          c->outbuf.empty())
        mark_close(c);
      else if (c->state == ConnState::kH2 && c->h2_streams.empty() &&
               c->h2_ready.empty() && c->outbuf.empty())
        // Idle h2 connection: no stream being serviced or queued. An
        // abrupt close (no GOAWAY) is within spec for shutdown; clients
        // retry idempotent requests on a fresh connection.
        mark_close(c);
    }
    flush_doomed();
    return conns_.size();
  }

  void sweep_idle() {
    for (Conn* c : conns_) {
      if (c->dead) continue;
      time_t idle = now_ - c->last_active;
      switch (c->state) {
        case ConnState::kHandshake:
        case ConnState::kReadingHead:
        case ConnState::kClosing:
          if (idle > kIdleTimeoutS) mark_close(c);
          break;
        case ConnState::kAwaitingVerdict:
          // Verdict deadlines are ms-granularity and handled by
          // sweep_verdict_deadlines() every event-loop pass; nothing
          // to do on the 1 s tick.
          break;
        case ConnState::kProxying:
          if (idle > kProxyIdleTimeoutS) mark_close(c);
          break;
        case ConnState::kTunnel:
          if (tcp_mode_ && !c->upstream_connected && c->upstream_fd < 0) {
            start_tcp_proxy(c);  // parked retry: re-dial this sweep
            break;
          }
          if (tcp_mode_ && !c->upstream_connected && c->upstream_fd >= 0 &&
              now_ - c->tcp_connect_at > kTcpConnectTimeoutS) {
            tcp_proxy_fail(c);  // reference: 3 s connect timeout/try
            break;
          }
          // WebSockets idle legitimately (pings may be minutes apart).
          if (idle > kTunnelIdleS) mark_close(c);
          break;
        case ConnState::kH2:
          // Streams stuck awaiting verdicts fail open on their own
          // ms-granularity timers in sweep_verdict_deadlines().
          if (idle > kProxyIdleTimeoutS) mark_close(c);
          break;
      }
    }
  }

  // -- transport (plain / TLS) ----------------------------------------------

  // >0 bytes, 0 clean EOF, -1 would-block, -2 error.
  ssize_t t_read(Conn* c, char* buf, size_t n) {
    if (c->ssl == nullptr) {
      ssize_t r = read(c->fd, buf, n);
      if (r > 0) return r;
      if (r == 0) return 0;
      return (errno == EAGAIN || errno == EWOULDBLOCK) ? -1 : -2;
    }
    int r = SSL_read(c->ssl, buf, static_cast<int>(n));
    if (r > 0) return r;
    int err = SSL_get_error(c->ssl, r);
    ERR_clear_error();
    if (err == SSL_ERROR_ZERO_RETURN) return 0;
    if (err == SSL_ERROR_WANT_READ) return -1;
    if (err == SSL_ERROR_WANT_WRITE) {
      c->ssl_want_write = true;
      return -1;
    }
    return -2;
  }

  ssize_t t_write(Conn* c, const char* buf, size_t n) {
    if (c->ssl == nullptr) {
      ssize_t w = send(c->fd, buf, n, MSG_NOSIGNAL);
      if (w >= 0) return w;
      return (errno == EAGAIN || errno == EWOULDBLOCK) ? -1 : -2;
    }
    int w = SSL_write(c->ssl, buf, static_cast<int>(n));
    if (w > 0) return w;
    int err = SSL_get_error(c->ssl, w);
    ERR_clear_error();
    if (err == SSL_ERROR_WANT_WRITE) {
      c->ssl_want_write = true;
      return -1;
    }
    if (err == SSL_ERROR_WANT_READ) return -1;
    return -2;
  }

  // Flush c->outbuf to the client; false = connection error.
  bool flush_out(Conn* c) {
    while (!c->outbuf.empty()) {
      ssize_t w = t_write(c, c->outbuf.data(), c->outbuf.size());
      if (w > 0) {
        c->outbuf.erase(0, static_cast<size_t>(w));
      } else if (w == -1) {
        break;
      } else {
        return false;
      }
    }
    return true;
  }

  void update_client_events(Conn* c) {
    uint32_t ev = 0;
    switch (c->state) {
      case ConnState::kHandshake:
      case ConnState::kReadingHead:
        ev = EPOLLIN;
        break;
      case ConnState::kAwaitingVerdict:
        // Verdict quiesce — except under streaming body inspection
        // (ISSUE 13), which keeps pulling body bytes (bounded by the
        // hold cap) while the verdicts compute.
        if (c->body_inspect && !c->body_final_sent && !c->client_eof &&
            c->inbuf.size() < kMaxBuffered)
          ev = EPOLLIN;
        break;
      case ConnState::kProxying:
        // Level-triggered epoll: a half-closed or backpressured client
        // with EPOLLIN armed would wake the loop forever — disarm the
        // read side at EOF / at the buffered cap.
        if (!c->client_eof && c->inbuf.size() < kMaxBuffered) ev = EPOLLIN;
        break;
      case ConnState::kTunnel:
        if (!c->client_eof && c->upbuf.size() < kMaxBuffered) ev = EPOLLIN;
        break;
      case ConnState::kH2:
        // Frame ingest continues while a stream verdicts/proxies (other
        // streams keep multiplexing in).
        if (!c->client_eof) ev = EPOLLIN;
        break;
      case ConnState::kClosing:
        ev = 0;
        break;
    }
    if (!c->outbuf.empty() || c->ssl_want_write) ev |= EPOLLOUT;
    epoll_event e{};
    e.events = ev;
    e.data.ptr = &c->client_ref;
    epoll_ctl(ep_, EPOLL_CTL_MOD, c->fd, &e);
  }

  void update_upstream_events(Conn* c) {
    if (c->upstream_fd < 0) return;
    uint32_t ev = 0;
    if (c->up_tls_hs) {
      // Arm exactly the wanted direction: EPOLLOUT is level-triggered
      // "almost always ready", so arming it while the handshake wants
      // bytes would spin the loop.
      ev = c->up_hs_want_write ? EPOLLOUT : EPOLLIN;
    } else {
      // Same level-trigger discipline: stop reading an EOF'd upstream
      // and pause reads while the client-side buffer is at its cap.
      bool can_read = !c->upstream_eof && c->outbuf.size() < kMaxBuffered;
      if (can_read) ev = EPOLLIN;
      if (!c->upbuf.empty() || !c->upstream_connected) ev |= EPOLLOUT;
      if (c->up_rd_want_write) ev |= EPOLLOUT;
      if (c->up_wr_want_read) ev |= EPOLLIN;
      // Records already decrypted inside the SSL object do not show on
      // the fd, so epoll alone cannot resume a read paused for
      // backpressure: queue an explicit resume once there is room.
      if (can_read && c->up_ssl != nullptr && SSL_pending(c->up_ssl) > 0)
        queue_ssl_resume(c, 0);
    }
    epoll_event e{};
    e.events = ev;
    e.data.ptr = &c->upstream_ref;
    epoll_ctl(ep_, EPOLL_CTL_MOD, c->upstream_fd, &e);
  }

  // Queue a canned response and switch to drain-then-close.
  void respond_close(Conn* c, const char* response) {
    c->outbuf.append(response);
    c->state = ConnState::kClosing;
    if (!flush_out(c)) {
      mark_close(c);
      return;
    }
    if (c->outbuf.empty()) {
      mark_close(c);
      return;
    }
    update_client_events(c);
  }

  void close_upstream(Conn* c) {
    if (c->up_h2 != nullptr) {
      delete c->up_h2;
      c->up_h2 = nullptr;
    }
    if (c->up_ssl != nullptr) {
      SSL_shutdown(c->up_ssl);  // best-effort close_notify (nonblocking)
      SSL_free(c->up_ssl);
      ERR_clear_error();
      c->up_ssl = nullptr;
    }
    if (c->upstream_fd >= 0) {
      epoll_ctl(ep_, EPOLL_CTL_DEL, c->upstream_fd, nullptr);
      close(c->upstream_fd);
      c->upstream_fd = -1;
    }
    reset_up_link(c);
  }

  void reset_up_link(Conn* c) {
    c->up_proto_pending = false;
    c->up_head.clear();
    c->upstream_connected = false;
    c->upstream_eof = false;
    c->up_trunc = false;
    c->up_tcp_ok = false;
    c->up_tls_hs = false;
    c->up_hs_want_write = false;
    c->up_rd_want_write = false;
    c->up_wr_want_read = false;
  }

  // -- upstream TLS client ---------------------------------------------------
  // The connector's client side of the reference's pooled hyper-rustls
  // client (http_proxy_service.rs:54-71): verified-by-default TLS with
  // SNI + hostname (or IP-SAN) checks against the table's server name.

  static constexpr ssize_t kIoAgain = -1;  // would block (want flags set)
  static constexpr ssize_t kIoErr = -2;    // fatal transport error

  bool up_tls_begin(const UpTarget& t, int fd, SSL** out,
                    bool offer_h2 = true) {
    if (up_ctx_ == nullptr) return false;
    SSL* ssl = SSL_new(up_ctx_);
    if (ssl == nullptr) return false;
    SSL_set_fd(ssl, fd);
    SSL_set_connect_state(ssl);
    const char* name = t.sni.c_str();
    in_addr probe{};
    bool name_ok;
    if (inet_pton(AF_INET, name, &probe) == 1) {
      // Literal-address target: verify against an IP SAN, no SNI
      // (RFC 6066 §3 forbids literal addresses in server_name).
      name_ok = X509_VERIFY_PARAM_set1_ip_asc(SSL_get0_param(ssl), name) == 1;
    } else {
      name_ok = SSL_set1_host(ssl, name) == 1 &&
                SSL_set_tlsext_host_name_shim(ssl, name) == 1;
    }
    if (!name_ok) {
      // Proceeding would handshake with chain-but-no-name verification
      // — a silent downgrade; fail the hop instead (502).
      SSL_free(ssl);
      ERR_clear_error();
      return false;
    }
    if (!tcp_mode_ && offer_h2) {
      // Offer h2 like the reference's hyper-rustls client
      // (http_proxy_service.rs:54-71); the upstream picks. tcp mode
      // splices raw bytes, where ALPN is not ours to negotiate, and
      // upgrade (WebSocket) requests must stay h1 — a 101 tunnel
      // cannot ride an h2 hop, so the caller pins h1 for those.
      static const unsigned char kAlpn[] = "\x02h2\x08http/1.1";
      SSL_set_alpn_protos(ssl, kAlpn, sizeof(kAlpn) - 1);
    }
    *out = ssl;
    return true;
  }

  // Drive the client handshake: 1 done, 0 in progress, -1 fatal (which
  // includes certificate verification failures; SSL_VERIFY_PEER makes
  // OpenSSL abort the handshake on an untrusted or name-mismatched
  // chain).
  static int up_tls_step(SSL* ssl, bool* want_write) {
    ERR_clear_error();
    int r = SSL_do_handshake(ssl);
    if (r == 1) return 1;
    int e = SSL_get_error(ssl, r);
    if (e == SSL_ERROR_WANT_READ) {
      *want_write = false;
      return 0;
    }
    if (e == SSL_ERROR_WANT_WRITE) {
      *want_write = true;
      return 0;
    }
    return -1;
  }

  // send/recv with the same EAGAIN discipline whether the link is
  // plaintext or TLS. Cross-direction wants (renegotiation-free TLS 1.3
  // still hits them on KeyUpdate) are surfaced through the flags so the
  // event mask can arm the other direction.
  static ssize_t up_send_raw(int fd, SSL* ssl, const void* p, size_t n,
                             bool* wr_want_read) {
    if (ssl == nullptr) {
      ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
      if (w >= 0) return w;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return kIoAgain;
      return kIoErr;
    }
    ERR_clear_error();
    int w = SSL_write(ssl, p, static_cast<int>(n));
    if (w > 0) return w;
    int e = SSL_get_error(ssl, w);
    if (e == SSL_ERROR_WANT_WRITE) return kIoAgain;
    if (e == SSL_ERROR_WANT_READ) {
      *wr_want_read = true;
      return kIoAgain;
    }
    return kIoErr;
  }

  static ssize_t up_recv_raw(int fd, SSL* ssl, void* p, size_t n,
                             bool* rd_want_write) {
    if (ssl == nullptr) {
      ssize_t r = read(fd, p, n);
      if (r >= 0) return r;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return kIoAgain;
      return kIoErr;
    }
    ERR_clear_error();
    int r = SSL_read(ssl, p, static_cast<int>(n));
    if (r > 0) return r;
    int e = SSL_get_error(ssl, r);
    if (e == SSL_ERROR_ZERO_RETURN) return 0;  // clean close_notify
    if (e == SSL_ERROR_WANT_READ) return kIoAgain;
    if (e == SSL_ERROR_WANT_WRITE) {
      *rd_want_write = true;
      return kIoAgain;
    }
    // SSL_ERROR_SYSCALL with ret==0 is a TCP FIN without close_notify:
    // an unauthenticated party able to inject a FIN could otherwise
    // truncate a response and have it forwarded as a complete one.
    // Treat it as an error so it 502s / aborts instead (rustls surfaces
    // the same condition as UnexpectedEof).
    return kIoErr;
  }

  // A pooled upstream died before sending ANY response bytes: replay

  // the request once on a fresh connection (false when not applicable).
  bool try_pooled_retry(Conn* c) {
    if (!c->upstream_pooled || c->up_replay.empty()) return false;
    if (!c->resp_head_buf.empty() || c->resp_head_done)
      return false;  // response started: not safe to replay
    close_upstream(c);
    int ufd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (ufd < 0 ||
        (connect(ufd, reinterpret_cast<const sockaddr*>(&c->up_target.sa),
                 sizeof(c->up_target.sa)) != 0 &&
         errno != EINPROGRESS)) {
      if (ufd >= 0) close(ufd);
      return false;
    }
    c->upstream_fd = ufd;
    c->upstream_pooled = false;  // one retry only
    reset_up_link(c);  // a TLS target re-handshakes on the fresh socket
    c->upbuf = c->up_replay;
    epoll_event ue{};
    ue.events = EPOLLOUT | EPOLLIN;
    ue.data.ptr = &c->upstream_ref;
    epoll_ctl(ep_, EPOLL_CTL_ADD, ufd, &ue);
    update_client_events(c);
    return true;
  }

  // h1 502 (h2 streams fail through h2_respond_simple). Tears the
  // failed upstream down FIRST so a retry/new proxy never races an fd
  // still registered in epoll.
  void respond_502(Conn* c) {
    if (tcp_mode_) {
      // No HTTP on this plane: connect-phase failures retry, mid-
      // stream failures drop the connection (the reference's
      // copy_bidirectional just ends on error).
      tcp_proxy_fail(c);
      return;
    }
    if (try_pooled_retry(c)) return;
    stats_.upstream_fail++;
    close_upstream(c);
    respond_close(c, k502);
  }

  // Abort one h2 stream without fabricating a response (e.g. a
  // truncated upstream body must NOT become a well-formed short 200).
  void h2_abort_stream(Conn* c, int32_t sid) {
    nghttp2_submit_rst_stream(c->h2, 0, sid, NGHTTP2_INTERNAL_ERROR);
    h2_flush(c);
  }

  // -- upstream connection pool ----------------------------------------------
  // Completed keep-alive upstream responses park their connection here
  // for reuse by the next request to the same target — the reference
  // proxies through a pooled client (http_proxy_service.rs:54-71);
  // connection-per-request measurably caps the whole data plane at the
  // loopback connect rate. Idle entries are validated with a MSG_PEEK
  // probe on pop (a server that closed the idle conn is detected before
  // any request bytes are risked) and expired by the sweep.

  struct PooledUpstream {
    int fd;
    SSL* ssl;  // non-null: an established TLS client session
    std::string sni;  // the name the session was verified for
    time_t since;
    UpH2Link* h2link = nullptr;  // non-null: an established h2 session
  };
  static constexpr size_t kPoolPerTarget = 256;
  static constexpr time_t kPoolIdleS = 30;

  static uint64_t target_key(const UpTarget& t) {
    uint64_t key =
        (static_cast<uint64_t>(t.sa.sin_addr.s_addr) << 16) | t.sa.sin_port;
    if (t.tls) {
      key |= 1ULL << 63;
      key ^= std::hash<std::string>{}(t.sni) & 0x7FFF000000000000ULL;
    }
    if (t.h2) key |= 1ULL << 62;  // h1 and h2:// pools must never mix:
    // a pooled h1 keep-alive socket handed to an h2 request would get
    // a client preface mid-session (and vice versa)
    return key;
  }

  // Drain whatever session frames an idle pooled h2 connection has
  // pending (PING, SETTINGS, GOAWAY) through its nghttp2 session.
  // Returns false when the session is no longer usable.
  static bool h2_pool_prefeed(PooledUpstream* pc) {
    char buf[4096];
    std::string sink;  // no stream is open: nothing synthesizes
    for (;;) {
      ssize_t r;
      if (pc->ssl != nullptr) {
        ERR_clear_error();
        int rr = SSL_read(pc->ssl, buf, sizeof(buf));
        if (rr <= 0) {
          int e = SSL_get_error(pc->ssl, rr);
          if (e == SSL_ERROR_WANT_READ) break;  // drained
          return false;  // close_notify / FIN / error
        }
        r = rr;
      } else {
        r = recv(pc->fd, buf, sizeof(buf), MSG_DONTWAIT);
        if (r == 0) return false;
        if (r < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          return false;
        }
      }
      if (!pc->h2link->feed(buf, static_cast<size_t>(r), &sink))
        return false;
    }
    return !pc->h2link->goaway && !pc->h2link->failed;
  }

  bool pop_pooled(const UpTarget& t, PooledUpstream* out) {
    auto it = upstream_pool_.find(target_key(t));
    if (it == upstream_pool_.end()) return false;
    auto& vec = it->second;
    while (!vec.empty()) {
      // The 64-bit key folds the SNI lossily; a hash alias must never
      // hand out a session verified for a different name, so entries
      // are matched exactly (LIFO over the matching entries).
      size_t pick = vec.size();
      for (size_t i = vec.size(); i-- > 0;) {
        if (vec[i].sni == t.sni) {
          pick = i;
          break;
        }
      }
      if (pick == vec.size()) return false;
      PooledUpstream pc = vec[pick];
      vec.erase(vec.begin() + pick);
      if (pc.ssl != nullptr) {
        // SSL_peek processes buffered records (quietly consuming
        // TLS 1.3 session tickets): on an h1 link app data means a
        // poisoned connection; on an h2 link pending bytes are session
        // frames — feed them through the session NOW so an idle-drain
        // GOAWAY is detected here instead of 502ing the next request
        // (the h1 path covers the same race with pooled replay, which
        // h2 links do not carry).
        char probe;
        ERR_clear_error();
        int r = SSL_peek(pc.ssl, &probe, 1);
        bool alive =
            r <= 0 && SSL_get_error(pc.ssl, r) == SSL_ERROR_WANT_READ;
        if (!alive && r > 0 && pc.h2link != nullptr)
          alive = h2_pool_prefeed(&pc);
        ERR_clear_error();
        if (alive) {
          *out = pc;
          return true;
        }
        SSL_free(pc.ssl);
        ERR_clear_error();
        close(pc.fd);
        if (pc.h2link != nullptr) delete pc.h2link;
        continue;
      }
      char probe;
      ssize_t r = recv(pc.fd, &probe, 1, MSG_PEEK | MSG_DONTWAIT);
      bool alive = r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK);
      if (!alive && r > 0 && pc.h2link != nullptr)
        alive = h2_pool_prefeed(&pc);
      if (alive) {
        *out = pc;
        return true;
      }
      close(pc.fd);  // closed by the server, or stray bytes: unusable
      if (pc.h2link != nullptr) delete pc.h2link;
    }
    return false;
  }

  void release_upstream(Conn* c) {
    auto& vec = upstream_pool_[c->up_key];
    if (c->up_key == 0 || vec.size() >= kPoolPerTarget) {
      close_upstream(c);
      return;
    }
    epoll_ctl(ep_, EPOLL_CTL_DEL, c->upstream_fd, nullptr);
    vec.push_back(PooledUpstream{c->upstream_fd, c->up_ssl,
                                 c->up_target.sni, now_, c->up_h2});
    c->upstream_fd = -1;
    c->up_ssl = nullptr;
    c->up_h2 = nullptr;  // session ownership moved into the pool entry
    reset_up_link(c);
  }

  void sweep_pool() {
    for (auto& kv : upstream_pool_) {
      auto& vec = kv.second;
      size_t keep = 0;
      for (size_t i = 0; i < vec.size(); ++i) {
        if (now_ - vec[i].since > kPoolIdleS) {
          if (vec[i].ssl != nullptr) {
            SSL_shutdown(vec[i].ssl);
            SSL_free(vec[i].ssl);
            ERR_clear_error();
          }
          close(vec[i].fd);
          if (vec[i].h2link != nullptr) delete vec[i].h2link;
        } else {
          vec[keep++] = vec[i];
        }
      }
      vec.resize(keep);
    }
  }

  // Adopt (or create) an h2 session for this connection's upstream
  // link and frame the rewritten request onto it.
  bool begin_upstream_h2(Conn* c, UpH2Link* link) {
    if (c->req.is_upgrade()) {
      // Protocol upgrades (WebSocket) cannot ride an h2 upstream hop.
      if (link != nullptr) delete link;
      stats_.upstream_fail++;
      close_upstream(c);
      respond_close(c, k502);
      return false;
    }
    if (link == nullptr) {
      link = new UpH2Link();
      if (!link->init()) {
        delete link;
        stats_.upstream_fail++;
        close_upstream(c);
        respond_close(c, k502);
        return false;
      }
    } else {
      link->reset_for_reuse();
    }
    c->up_h2 = link;
    bool has_body = !c->req_body.done;
    if (!link->submit(c->up_head, c->up_target.tls, has_body) ||
        !link->pump_send(&c->upbuf)) {
      stats_.upstream_fail++;
      close_upstream(c);  // deletes the link
      respond_close(c, k502);
      return false;
    }
    // Pooled-retry replay is h1-shaped (raw byte replay); an h2 link
    // would need a fresh stream submission instead — disabled.
    c->up_replay.clear();
    c->upstream_pooled = false;
    return true;
  }

  void finish_upstream_send_setup(Conn* c) {
    pump_request_body(c);
    if (c->up_h2 == nullptr) {
      // A POOLED connection can die between the liveness probe and our
      // write (server idle-timeout race). Keep the sent bytes around
      // so the request can be replayed once on a FRESH connection
      // instead of surfacing a spurious 502 (the reference's pooled
      // client retries the same way). Oversized bodies disable it.
      c->up_replay = c->upbuf;
      if (c->up_replay.size() > kMaxReplay) {
        c->up_replay.clear();
        c->upstream_pooled = false;
      }
    }
  }

  void start_proxy(Conn* c, const UpTarget& target) {
    uint64_t key = target_key(target);
    if (target.tls && up_ctx_ == nullptr) {
      stats_.upstream_fail++;
      close_upstream(c);
      respond_close(c, k502);
      return;
    }
    PooledUpstream pc{-1, nullptr, std::string(), 0};
    bool pooled = pop_pooled(target, &pc);
    if (pooled && pc.h2link != nullptr && c->req.is_upgrade()) {
      // Upgrades must ride h1: hand the h2 session back and dial a
      // fresh connection whose ALPN offer is pinned to http/1.1.
      upstream_pool_[key].push_back(pc);
      pooled = false;
      pc = PooledUpstream{-1, nullptr, std::string(), 0};
    }
    int ufd = pc.fd;
    if (!pooled) {
      ufd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
      if (ufd < 0 ||
          (connect(ufd, reinterpret_cast<const sockaddr*>(&target.sa),
                   sizeof(target.sa)) != 0 &&
           errno != EINPROGRESS)) {
        if (ufd >= 0) close(ufd);
        respond_502(c);
        return;
      }
    }
    c->upstream_fd = ufd;
    c->up_key = key;
    c->up_target = target;
    c->upstream_pooled = pooled;
    reset_up_link(c);
    c->up_ssl = pooled ? pc.ssl : nullptr;
    c->upstream_connected = pooled;  // pooled TLS links are post-handshake
    c->up_tcp_ok = pooled;
    c->upstream_keep = false;
    c->upstream_junk = false;
    c->up_shut = false;
    c->resp_head_buf.clear();
    c->resp_head_done = false;
    c->last_active = now_;

    c->state = ConnState::kProxying;
    c->up_head = rewrite_request_head(
        c->req, c->peer_ip, c->ssl != nullptr,
        target.internal ? internal_token_ : std::string());
    // Upstream protocol: h2 for table-marked h2:// targets and pooled
    // h2 sessions; ALPN decides fresh TLS links after the handshake
    // (reference hyper client, http_proxy_service.rs:54-71).
    if (pooled && pc.h2link != nullptr) {
      if (!begin_upstream_h2(c, pc.h2link)) return;
    } else if (target.h2) {
      if (!begin_upstream_h2(c, nullptr)) return;
    } else if (target.tls && !pooled) {
      c->up_proto_pending = true;  // decided at handshake completion
    } else {
      c->upbuf = c->up_head;
    }
    if (!c->up_proto_pending) finish_upstream_send_setup(c);

    epoll_event ue{};
    ue.events = EPOLLOUT | EPOLLIN;
    ue.data.ptr = &c->upstream_ref;
    epoll_ctl(ep_, EPOLL_CTL_ADD, ufd, &ue);
    update_client_events(c);
  }

  // Raw client->upstream splice for an accepted protocol upgrade.
  void on_tunnel_client_event(Conn* c, uint32_t events) {
    c->last_active = now_;
    if (events & EPOLLIN) {
      char buf[16384];
      for (;;) {
        if (c->upbuf.size() > kMaxBuffered) break;  // backpressure
        ssize_t r = t_read(c, buf, sizeof(buf));
        if (r > 0) {
          c->upbuf.append(buf, static_cast<size_t>(r));
        } else if (r == 0) {
          c->client_eof = true;
          break;
        } else if (r == -1) {
          break;
        } else {
          mark_close(c);
          return;
        }
      }
      flush_upstream(c);
    }
    if (events & EPOLLOUT) {
      c->ssl_want_write = false;
      if (!flush_out(c)) {
        mark_close(c);
        return;
      }
    }
    // Half-close propagation in both directions (tcp mode closes only
    // when both sides finished; WebSocket tunnels close as a unit).
    tunnel_check_done(c);
    if (c->dead) return;
    update_client_events(c);
    update_upstream_events(c);
  }

  // Move request-body bytes from inbuf into upbuf per the framer.
  void pump_request_body(Conn* c) {
    if (c->up_proto_pending) return;  // body buffers raw in inbuf until
                                      // ALPN picks the upstream framing
    if (c->req_body_forwarded) return;
    if (c->up_h2 != nullptr) {
      if (!c->inbuf.empty() && !c->req_body.done &&
          c->up_h2->body.size() < kMaxBuffered) {
        // The bound: nghttp2 flow control (64 KB windows) holds body
        // bytes in the link, not upbuf, so the upbuf cap alone cannot
        // backpressure a slow h2 upstream. Leaving bytes in inbuf
        // engages the client-read gate (kProxying arms EPOLLIN only
        // below the inbuf cap).
        std::string payload;  // h2 DATA carries the DE-FRAMED body
        size_t take =
            c->req_body.consume(c->inbuf.data(), c->inbuf.size(), &payload);
        if (!payload.empty())
          c->up_h2->append_body(payload.data(), payload.size());
        c->inbuf.erase(0, take);
      }
      if (c->req_body.bad) {
        mark_close(c);
        return;
      }
      if (c->req_body.done && !c->req_body_forwarded) {
        c->req_body_forwarded = true;
        c->up_h2->finish_body();
      }
      c->up_h2->pump_send(&c->upbuf);
      return;
    }
    if (!c->inbuf.empty() && !c->req_body.done) {
      size_t take = c->req_body.consume(c->inbuf.data(), c->inbuf.size());
      c->upbuf.append(c->inbuf, 0, take);
      if (c->upstream_pooled) {
        c->up_replay.append(c->inbuf, 0, take);
        if (c->up_replay.size() > kMaxReplay) {
          c->up_replay.clear();
          c->upstream_pooled = false;  // too big to replay: no retry
        }
      }
      c->inbuf.erase(0, take);
    }
    if (c->req_body.bad) {  // malformed chunked framing mid-stream
      mark_close(c);
      return;
    }
    if (c->req_body.done) c->req_body_forwarded = true;
  }

  // -- streaming body inspection (ISSUE 13, docs/BODY_STREAMING.md) ----------
  //
  // With PINGOO_BODY_INSPECT=on, an h1 request whose head enqueued a
  // ring ticket ALSO streams its de-framed body to the ring's body
  // slots as bounded windows while the connection holds in
  // kAwaitingVerdict (the verdict quiesce normally disarms client
  // reads; inspection re-arms them under the kMaxBuffered hold cap).
  // The raw bytes stay in inbuf untouched — the post-dispatch
  // pump_request_body path forwards them exactly as before — so a
  // failed inspection degrades coverage, never framing. The sidecar
  // posts the flow's verdict on the SHARED verdict ring with bit 63
  // set; apply_verdict holds a proxy-decided metadata verdict until it
  // lands, then merges (engine/bodyscan.py merge_actions semantics).
  // Every error path — body ring full, hold cap overflow, degraded
  // mode, verdict deadline, malformed framing — fails OPEN to
  // metadata-only verdicts. h2 client streams are not inspected this
  // iteration (counted: body_h2_skipped).

  // Twin of engine/bodyscan.py merge_actions: the metadata plane's
  // nonzero unverified lane (bits 0-1) wins, verified-block (bit 2)
  // ORs, route bits (3-7) ride the metadata verdict unchanged.
  static uint8_t merge_body_action(uint8_t meta, uint8_t body) {
    uint8_t unverified = (meta & 3) ? (meta & 3) : (body & 3);
    return static_cast<uint8_t>((meta & 0xf8) | ((meta | body) & 4) |
                                unverified);
  }

  // Reset inspection state and drop the verdict-demux entry.
  void body_clear(Conn* c) {
    if (c->body_flow != UINT64_MAX) body_awaiting_.erase(c->body_flow);
    c->body_inspect = false;
    c->body_flow = UINT64_MAX;
    c->body_scan = BodyFramer();
    c->body_win.clear();
    c->body_win_seq = 0;
    c->body_total = 0;
    c->body_raw_seen = 0;
    c->body_final_sent = false;
    c->body_fin_ms = 0;
    c->meta_pending = false;
    c->meta_action = 0;
    c->body_verdict_done = false;
    c->body_action = 0;
  }

  // Tear down inspection; a best-effort ABORT window lets the sidecar
  // free its per-flow carry state immediately instead of waiting out
  // the flow TTL. Safe on conns that were never armed.
  void body_abort(Conn* c) {
    if (!c->body_inspect) return;
    if (!c->body_final_sent)
      pingoo_ring_enqueue_body(ring_, c->body_flow, c->body_win_seq,
                               c->body_total, nullptr, 0,
                               PINGOO_BODY_FLAG_ABORT);
    body_clear(c);
  }

  // Stop inspecting this flow and unblock the request: the stashed
  // metadata verdict (if any) applies alone — fail open, never stall.
  void body_fail_open(Conn* c) {
    stats_.body_fail_open++;
    uint64_t ticket = c->body_flow;
    bool meta = c->meta_pending;
    uint8_t action = c->meta_action;
    body_abort(c);
    if (meta && !c->dead) apply_verdict(c, action, ticket);
  }

  // Degraded-mode entry: no sidecar is alive to answer FINAL windows.
  void body_fail_open_all() {
    if (body_awaiting_.empty()) return;
    std::vector<Conn*> flows;
    flows.reserve(body_awaiting_.size());
    for (const auto& kv : body_awaiting_) flows.push_back(kv.second);
    for (Conn* c : flows)
      if (!c->dead && c->body_inspect) body_fail_open(c);
  }

  // Feed raw inbuf bytes past body_raw_seen through the scan framer,
  // window the de-framed payload, and enqueue full windows. The framer
  // stops at the message boundary, so pipelined next-request bytes are
  // never scanned.
  void body_scan_pump(Conn* c) {
    if (!c->body_inspect || c->body_final_sent) return;
    if (c->body_raw_seen < c->inbuf.size() && !c->body_scan.done) {
      std::string payload;
      size_t take = c->body_scan.consume(c->inbuf.data() + c->body_raw_seen,
                                         c->inbuf.size() - c->body_raw_seen,
                                         &payload);
      c->body_raw_seen += take;
      if (!payload.empty()) {
        c->body_win.append(payload);
        c->body_total += payload.size();
      }
    }
    if (c->body_scan.bad) {
      // Malformed framing: the real framer hits the same bytes after
      // dispatch and closes the connection — just stop inspecting.
      body_fail_open(c);
      return;
    }
    while (c->body_inspect &&
           (c->body_win.size() >= PINGOO_BODY_WINDOW_CAP ||
            (c->body_scan.done && !c->body_final_sent))) {
      uint32_t n = static_cast<uint32_t>(
          std::min<size_t>(c->body_win.size(), PINGOO_BODY_WINDOW_CAP));
      bool fin = c->body_scan.done && n == c->body_win.size();
      int rc = pingoo_ring_enqueue_body(
          ring_, c->body_flow, c->body_win_seq, c->body_total,
          c->body_win.data(), n, fin ? PINGOO_BODY_FLAG_FINAL : 0);
      if (rc != 0) {  // body ring full: degrade this flow
        body_fail_open(c);
        return;
      }
      c->body_win_seq++;
      stats_.body_windows++;
      stats_.body_bytes += n;
      c->body_win.erase(0, n);
      if (fin) {
        c->body_final_sent = true;
        c->body_fin_ms = now_ms();
      }
    }
  }

  // Arm inspection for this h1 cycle: the head already enqueued the
  // ring ticket (flow id), pipelined body bytes may already sit in
  // inbuf. Called only under kBodyInspect && !degraded_.
  void body_arm(Conn* c) {
    c->body_inspect = true;
    c->body_flow = c->ticket;
    if (c->req.chunked) c->body_scan.reset_chunked();
    else c->body_scan.reset_cl(c->req.content_length);
    body_awaiting_[c->body_flow] = c;
    stats_.body_flows++;
    body_scan_pump(c);
    // EOF already seen with the body incomplete: it can never finish.
    if (c->body_inspect && c->client_eof && !c->body_scan.done)
      body_fail_open(c);
  }

  // Client readable while kAwaitingVerdict with inspection armed: pull
  // body bytes into inbuf (they stay there for the post-verdict pump)
  // and stream windows. Distinct from on_client_readable: no head
  // parsing, and the hold cap fails inspection open instead of closing
  // the connection.
  void on_body_readable(Conn* c) {
    c->last_active = now_;
    char buf[16384];
    while (c->body_inspect && !c->body_final_sent &&
           c->inbuf.size() < kMaxBuffered) {
      ssize_t r = t_read(c, buf, sizeof(buf));
      if (r > 0) {
        c->inbuf.append(buf, static_cast<size_t>(r));
        body_scan_pump(c);
      } else if (r == 0) {
        c->client_eof = true;
        if (c->body_inspect && !c->body_scan.done) body_fail_open(c);
        break;
      } else if (r == -1) {
        break;
      } else {
        mark_close(c);
        return;
      }
    }
    // Hold cap reached with the body still incomplete: the remainder
    // cannot buffer pre-verdict — degrade and let the proxy
    // backpressure gates stream it after dispatch.
    if (c->body_inspect && !c->body_scan.done &&
        c->inbuf.size() >= kMaxBuffered)
      body_fail_open(c);
    if (!c->dead) update_client_events(c);
  }

  // A bit-63 verdict from the shared ring: record it; if the metadata
  // verdict is already stashed, merge and finish the request.
  void on_body_verdict(uint64_t flow, uint8_t action) {
    auto it = body_awaiting_.find(flow);
    if (it == body_awaiting_.end()) return;  // died / degraded meanwhile
    Conn* c = it->second;
    body_awaiting_.erase(it);
    if (c->dead || !c->body_inspect) return;
    stats_.body_verdicts++;
    c->body_verdict_done = true;
    c->body_action = action;
    c->body_flow = UINT64_MAX;  // demux entry gone
    if (c->meta_pending) {
      uint8_t meta = c->meta_action;
      c->meta_pending = false;
      apply_verdict(c, meta, flow);  // merges via body_verdict_done
    }
    // else: the metadata verdict is still in flight; apply_verdict
    // merges when it lands.
  }

  // -- verdict flow ---------------------------------------------------------

  void drain_verdicts() {
    uint64_t ticket;
    uint8_t action;
    float score;
    while (pingoo_ring_poll_verdict(ring_, &ticket, &action, &score) == 0) {
      if (ticket & PINGOO_BODY_VERDICT_BIT) {
        on_body_verdict(ticket & ~PINGOO_BODY_VERDICT_BIT, action);
        continue;
      }
      auto it = awaiting_.find(ticket);
      if (it == awaiting_.end()) continue;  // connection died meanwhile
      Conn* c = it->second.conn;
      int32_t sid = it->second.sid;
      awaiting_.erase(it);
      if (c->dead) continue;
      if (sid != 0) {
        auto sit = c->h2_streams.find(sid);
        if (sit == c->h2_streams.end()) continue;  // stream reset meanwhile
        sit->second.ticket = UINT64_MAX;
        apply_h2_verdict(c, sid, action, ticket);
        h2_flush(c);
      } else {
        c->ticket = UINT64_MAX;
        apply_verdict(c, action, ticket);
      }
    }
  }

  // -- sidecar supervision (ISSUE 10, docs/RESILIENCE.md) --------------------
  // Two independent fail-open layers above the ring-full path:
  //   1. sweep_verdict_deadlines(): per-ticket ms-granularity deadline
  //      (kVerdictTimeoutMs) checked every event-loop pass — replaces
  //      the old once-a-second kVerdictTimeoutS sweep whose coarse
  //      clock added up to ~1 s of detection slop.
  //   2. check_sidecar_liveness(): ring-header heartbeat (v5). A stamp
  //      older than kSidecarTimeoutMs flips degraded mode: every
  //      awaiting ticket fails open NOW and run_policy bypasses the
  //      ring entirely, so a dead sidecar costs one detection window
  //      instead of one verdict timeout per request. A fresh heartbeat
  //      (the restarted sidecar's attach bumps the epoch) lifts it.

  // Fail one awaiting ticket open and record it. The awaiting_ entry
  // must already be erased (or never inserted) by the caller.
  void fail_open_ticket(Conn* c, int32_t sid, uint64_t ticket) {
    stats_.fail_open++;
    if (sid != 0) {
      auto sit = c->h2_streams.find(sid);
      if (sit == c->h2_streams.end()) return;  // stream reset meanwhile
      sit->second.ticket = UINT64_MAX;
      flight_record(sit->second.p, ticket, sit->second.enq_ms, 0, 3);
      h2_stream_fail_open(c, sid);
      h2_flush(c);
    } else {
      c->ticket = UINT64_MAX;
      body_abort(c);  // dispatching without a verdict: stop inspecting
      flight_record(c->req, ticket, c->enq_ms, 0, 3);
      fail_open_proxy(c);
    }
  }

  void sweep_verdict_deadlines() {
    sweep_body_deadlines();
    if (awaiting_.empty()) return;
    uint64_t now = now_ms();
    if (now == last_deadline_sweep_ms_) return;  // at most one pass per ms
    last_deadline_sweep_ms_ = now;
    // Collect first: fail_open_ticket mutates conns/streams and must
    // not run under the awaiting_ iterator.
    expired_.clear();
    for (const auto& kv : awaiting_) {
      const Awaiting& aw = kv.second;
      uint64_t enq = 0;
      if (aw.sid != 0) {
        auto sit = aw.conn->h2_streams.find(aw.sid);
        if (sit != aw.conn->h2_streams.end()) enq = sit->second.enq_ms;
      } else {
        enq = aw.conn->enq_ms;
      }
      if (enq != 0 && now - enq > kVerdictTimeoutMs)
        expired_.push_back(kv.first);
    }
    for (uint64_t ticket : expired_) {
      auto it = awaiting_.find(ticket);
      if (it == awaiting_.end()) continue;
      Awaiting aw = it->second;
      awaiting_.erase(it);
      if (aw.conn->dead) continue;
      fail_open_ticket(aw.conn, aw.sid, ticket);
    }
  }

  // A request whose metadata verdict already said "proxy" is blocked
  // solely on the body verdict once its FINAL window is enqueued; the
  // same kVerdictTimeoutMs budget bounds that wait (ISSUE 13).
  void sweep_body_deadlines() {
    if (body_awaiting_.empty()) return;
    uint64_t now = now_ms();
    body_expired_.clear();
    for (const auto& kv : body_awaiting_) {
      Conn* c = kv.second;
      if (c->meta_pending && c->body_fin_ms != 0 &&
          now - c->body_fin_ms > kVerdictTimeoutMs)
        body_expired_.push_back(c);
    }
    for (Conn* c : body_expired_)
      if (!c->dead && c->body_inspect) body_fail_open(c);
  }

  void fail_open_all_awaiting() {
    std::vector<std::pair<uint64_t, Awaiting>> inflight;
    inflight.reserve(awaiting_.size());
    for (const auto& kv : awaiting_) inflight.push_back(kv);
    awaiting_.clear();
    for (const auto& kv : inflight) {
      if (kv.second.conn->dead) continue;
      fail_open_ticket(kv.second.conn, kv.second.sid, kv.first);
    }
  }

  bool degraded() const { return degraded_; }

  void check_sidecar_liveness() {
    if (kSidecarTimeoutMs == 0 || tcp_mode_) return;
    uint64_t lv[5];  // epoch, heartbeat_ms, posted_floor, req_tail, now_ms
    pingoo_ring_liveness(ring_, lv);
    sidecar_epoch_ = lv[0];
    // Bootstrap: until a sidecar has ever attached (heartbeat 0) the
    // per-request deadline governs — flipping degraded here would only
    // mask a missing sidecar during bring-up.
    if (lv[1] == 0) return;
    sidecar_seen_ = true;
    uint64_t age = lv[4] > lv[1] ? lv[4] - lv[1] : 0;
    bool stale = age > kSidecarTimeoutMs;
    if (stale && !degraded_) {
      degraded_ = true;
      stats_.degraded_entered++;
      std::fprintf(stderr,
                   "pingoo-httpd: DEGRADED (sidecar heartbeat %llu ms stale, "
                   "epoch %llu); failing %zu awaiting ticket(s) open\n",
                   static_cast<unsigned long long>(age),
                   static_cast<unsigned long long>(lv[0]),
                   awaiting_.size());
      flight_record_transition("degraded-enter");
      fail_open_all_awaiting();
      body_fail_open_all();  // no sidecar will answer FINAL windows
    } else if (!stale && degraded_) {
      degraded_ = false;
      std::fprintf(stderr,
                   "pingoo-httpd: RECOVERED (sidecar epoch %llu heartbeat "
                   "fresh); resuming ring enqueues\n",
                   static_cast<unsigned long long>(lv[0]));
      flight_record_transition("degraded-exit");
    }
  }

  // Degrade/recover transitions land in the flight recorder as
  // synthetic SYS entries so /__pingoo/flightrecorder shows them
  // inline with the requests they affected.
  void flight_record_transition(const char* what) {
    Parsed p;
    p.method = "SYS";
    p.path = std::string("/") + what;
    flight_record(p, UINT64_MAX, 0, 0, 3);
  }

  // Verdict byte: bits 0-1 unverified action, bit 2 verified-block
  // (native_ring.py RingSidecar) — the reference loop skips Captcha
  // actions for verified clients but still blocks on Block
  // (http_listener.rs:251-264). Applies to the h1 cycle or the h2
  // connection's active stream.
  void apply_verdict(Conn* c, uint8_t action, uint64_t ticket = UINT64_MAX) {
    if (c->body_inspect) {
      if (c->body_verdict_done) {
        action = merge_body_action(action, c->body_action);
        body_clear(c);
      } else {
        uint8_t meta_decided =
            c->captcha_verified ? ((action & 4) ? 1 : 0) : (action & 3);
        if (meta_decided == 0) {
          // Metadata says proxy: hold the request until the body
          // verdict (or its fail-open) completes the picture; body
          // windows keep streaming meanwhile.
          c->meta_pending = true;
          c->meta_action = action;
          return;
        }
        body_abort(c);  // metadata alone decides: cancel inspection
      }
    }
    stats_.verdicts++;
    if (c->enq_ms) record_wait(now_ms() - c->enq_ms);
    uint8_t decided;  // 0 proxy, 1 block, 2 captcha
    if (c->captcha_verified) {
      decided = (action & 4) ? 1 : 0;
    } else {
      decided = action & 3;
    }
    flight_record(c->req, ticket, c->enq_ms, action, decided);
    if (decided == 1) {
      stats_.blocked++;
      respond_close(c, k403);
    } else if (decided == 2) {
      stats_.captcha++;
      respond_close(c, kCaptcha);
    } else {
      dispatch_route(c, (action >> 3) & 0x1f);
    }
  }

  void apply_h2_verdict(Conn* c, int32_t sid, uint8_t action,
                        uint64_t ticket = UINT64_MAX) {
    stats_.verdicts++;
    H2Stream& st = c->h2_streams[sid];
    if (st.enq_ms) record_wait(now_ms() - st.enq_ms);
    uint8_t decided = st.verified ? ((action & 4) ? 1 : 0) : (action & 3);
    flight_record(st.p, ticket, st.enq_ms, action, decided);
    if (decided == 1) {
      stats_.blocked++;
      h2_respond_simple(c, sid, 403, "Forbidden");
    } else if (decided == 2) {
      stats_.captcha++;
      h2_respond_redirect(c, sid);
    } else {
      h2_dispatch_route(c, sid, (action >> 3) & 0x1f);
    }
  }

  // -- request cycle --------------------------------------------------------

  void begin_request_cycle(Conn* c) {
    body_abort(c);  // stray inspection state never crosses cycles
    c->state = ConnState::kReadingHead;
    c->req = Parsed();
    c->req_body = BodyFramer();
    c->req_body_forwarded = false;
    c->captcha_verified = false;
    c->resp_head_buf.clear();
    c->resp_head_done = false;
    c->resp_body = BodyFramer();
    c->close_after_response = false;
    // Pipelined bytes may already hold the next request.
    if (!c->inbuf.empty() || c->client_eof) try_process_head(c, c->client_eof);
    if (!c->dead && c->state == ConnState::kReadingHead)
      update_client_events(c);
  }

  void on_client_readable(Conn* c) {
    c->last_active = now_;
    char buf[16384];
    bool eof = false;
    for (;;) {
      ssize_t r = t_read(c, buf, sizeof(buf));
      if (r > 0) {
        size_t old = c->inbuf.size();
        c->inbuf.append(buf, static_cast<size_t>(r));
        if (c->inbuf.size() > kMaxReqHead + kMaxBuffered) {
          mark_close(c);
          return;
        }
        // Stop draining once a full head is buffered: the request
        // BODY must flow under the proxy states' backpressure gates —
        // a fast client front-loading a multi-MB upload would
        // otherwise blow the inbuf cap before proxying even starts.
        // (The h2 preface contains its own CRLFCRLF, so h2 handoff
        // breaks here too and the h2 machinery takes over.)
        if (c->inbuf.find("\r\n\r\n", old > 3 ? old - 3 : 0) !=
            std::string::npos)
          break;
      } else if (r == 0) {
        eof = true;
        break;
      } else if (r == -1) {
        break;
      } else {
        mark_close(c);
        return;
      }
    }
    try_process_head(c, eof);
  }

  void try_process_head(Conn* c, bool eof) {
    if (c->state != ConnState::kReadingHead) {
      if (eof && c->state != ConnState::kProxying &&
          c->state != ConnState::kH2)
        mark_close(c);
      return;
    }
    // HTTP/2 detection: every h2 client (ALPN-negotiated or cleartext
    // prior knowledge) opens with the 24-byte preface (RFC 7540 §3.5),
    // mirroring the reference's hyper auto h1/h2 builder.
    size_t cmp = std::min(c->inbuf.size(), kH2PrefaceLen);
    if (cmp > 0 && std::memcmp(c->inbuf.data(), kH2Preface, cmp) == 0) {
      if (c->inbuf.size() < kH2PrefaceLen) {
        if (eof) mark_close(c);
        return;  // wait for the full preface
      }
      if (!start_h2(c)) {
        mark_close(c);
        return;
      }
      std::string initial;
      initial.swap(c->inbuf);
      h2_pump(c, initial.data(), initial.size());
      return;
    }
    size_t head_end = c->inbuf.find("\r\n\r\n");
    if (head_end == std::string::npos) {
      if (c->inbuf.size() > kMaxReqHead) {
        // 431, not 400: the Python listener plane answers its
        // PINGOO_MAX_HEADER_BYTES breach the same way (parity test in
        // tests/test_fuzz_corpus.py).
        respond_close(c, k431);
        return;
      }
      if (eof) mark_close(c);  // EOF before a complete head
      return;
    }
    if (head_end + 4 > kMaxReqHead) {
      respond_close(c, k431);
      return;
    }
    Parsed p = parse_head(c->inbuf.substr(0, head_end + 4));
    if (!p.ok) {
      respond_close(c, k400);
      return;
    }
    c->inbuf.erase(0, head_end + 4);
    c->req = p;
    if (++c->requests_served > kMaxRequestsPerConn) c->req.keep_alive = false;

    // A Transfer-Encoding we cannot frame (anything but chunked), a
    // malformed/duplicated Content-Length, TE and CL together, obsolete
    // header folding, or a malformed field line would desync the proxy
    // from the upstream: refuse them (RFC 9112 §6.1/§6.3 smuggling
    // rules; RFC 7230 §3.2.4). The Python listener plane applies the
    // identical gate (host/httpd.py strict_head_violation) so the
    // differential fuzzer holds both to one behavior.
    if ((p.has_transfer_encoding && !p.chunked) || p.bad_content_length ||
        (p.has_transfer_encoding && p.has_content_length) || p.obs_fold ||
        p.bad_header) {
      respond_close(c, k400);
      return;
    }
    // Declared body beyond the cap: refuse before framing starts (the
    // Python plane enforces the same PINGOO_MAX_BODY_BYTES with 413).
    if (p.has_content_length && p.content_length > kMaxBodyBytes) {
      respond_close(c, k413);
      return;
    }
    // Request body framing (bytes beyond it are the NEXT request and
    // are never forwarded with this one).
    if (p.chunked) {
      c->req_body.reset_chunked();
    } else if (p.content_length > 0) {
      c->req_body.reset_cl(p.content_length);
    } else {
      c->req_body.reset_none();
    }
    c->req_body_forwarded = c->req_body.done;

    if (c->req.path == "/__pingoo/metrics") {
      respond_close(c, metrics_response(c->req).c_str());
      return;
    }
    if (c->req.path == "/__pingoo/flightrecorder") {
      respond_close(c, flightrecorder_response().c_str());
      return;
    }
    if (c->req.path == "/__pingoo/timeline") {
      respond_close(c, timeline_response().c_str());
      return;
    }
    Policy outcome = run_policy(c);
    switch (outcome) {
      case Policy::kBlock:
        respond_close(c, k403);
        return;
      case Policy::kCaptchaRedirect:
        respond_close(c, kCaptcha);
        return;
      case Policy::kCaptchaUpstream:
        {
          UpTarget t;
          t.sa = captcha_upstream_;
          t.internal = true;
          start_proxy(c, t);
        }
        return;
      case Policy::kFailOpenProxy:
        stats_.fail_open++;
        flight_record(c->req, UINT64_MAX, 0, 0, 3);  // 3 = fail-open
        fail_open_proxy(c);
        return;
      case Policy::kAwaitVerdict:
        c->state = ConnState::kAwaitingVerdict;
        // Streaming body inspection (ISSUE 13): a body-bearing request
        // also streams windows to the sidecar while it holds here.
        if (kBodyInspect && !degraded_ && !c->req_body.done) body_arm(c);
        update_client_events(c);  // quiesce until the verdict arrives
        return;
    }
  }

  // The shared per-request WAF policy (reference hot path,
  // http_listener.rs:196-264): UA gate, host cap, captcha-path routing,
  // cookie verification, ring enqueue. Protocol-agnostic — the h1 cycle
  // and the h2 stream loop both act on the returned decision. Reads
  // c->req; sets c->captcha_verified and, for kAwaitVerdict,
  // c->ticket + the awaiting_ map entry.
  enum class Policy {
    kBlock,            // 403 (UA gate or captcha upstream missing)
    kCaptchaRedirect,  // redirect to the challenge
    kCaptchaUpstream,  // proxy to the control plane
    kFailOpenProxy,    // ring full: proxy without a verdict
    kAwaitVerdict,     // enqueued; verdict callback decides
  };

  Policy run_policy(Conn* c, int32_t sid = 0) {
    stats_.requests++;
    Parsed& req = sid != 0 ? c->h2_streams[sid].p : c->req;
    // Empty or oversized UA -> 403 before the ring. The >= is the
    // reference's own explicit check (http_listener.rs:196).
    if (req.user_agent.empty() || req.user_agent.size() >= 256) {
      stats_.ua_rejected++;
      return Policy::kBlock;
    }
    // Over-long host becomes EMPTY, not truncated (get_host,
    // http_listener.rs:284-296).
    if (req.host.size() > 256) req.host.clear();

    // Captcha endpoints bypass rules and go to the control plane — and
    // they come BEFORE the cookie gate, exactly like the reference
    // (http_listener.rs:200-204 precede :222-236), or a client with a
    // stale cookie could never reach the challenge to clear it.
    if (req.path.compare(0, 17, "/__pingoo/captcha") == 0)
      return has_captcha_upstream_ ? Policy::kCaptchaUpstream
                                   : Policy::kBlock;

    // Captcha-verified cookie (Ed25519 JWT against the shared JWKS).
    // An INVALID present cookie serves the challenge immediately
    // (reference http_listener.rs:222-236) — here: redirect.
    std::string client_id = captcha_client_id(
        c->peer_ip, req.user_agent, req.host);
    if (gate_ != nullptr) gate_->maybe_reload(now_);
    bool verified = false;
    if (!req.verified_cookie.empty() && gate_ != nullptr &&
        gate_->available()) {
      if (gate_->verify(req.verified_cookie, client_id, now_)) {
        verified = true;
      } else {
        return Policy::kCaptchaRedirect;
      }
    }
    if (sid != 0) c->h2_streams[sid].verified = verified;
    else c->captcha_verified = verified;

    // Degraded fast-path (stale sidecar heartbeat): don't enqueue a
    // ticket no one will answer — fail open immediately instead of
    // stalling the request for a verdict timeout.
    if (degraded_) return Policy::kFailOpenProxy;

    uint8_t ip[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0xff, 0xff, 0, 0, 0, 0};
    in_addr v4{};
    inet_pton(AF_INET, c->peer_ip, &v4);
    std::memcpy(ip + 12, &v4, 4);
    char country[2] = {'X', 'X'};
    uint64_t ticket = pingoo_ring_enqueue_request(
        ring_, req.method.data(), req.method.size(), req.host.data(),
        req.host.size(), req.path.data(), req.path.size(),
        req.target.data(), req.target.size(), req.user_agent.data(),
        req.user_agent.size(), ip, c->peer_port, 0, country);
    if (ticket == UINT64_MAX) {
      // Verdict ring full (sidecar stalled): FAIL OPEN — proxy without
      // a verdict (pingoo/rules.rs:41-44).
      return Policy::kFailOpenProxy;
    }
    if (sid != 0) {
      H2Stream& st = c->h2_streams[sid];
      st.ticket = ticket;
      st.verdict_at = now_;
      st.enq_ms = now_ms();
    } else {
      c->ticket = ticket;
      c->verdict_at = now_;
      c->enq_ms = now_ms();
    }
    awaiting_[ticket] = Awaiting{c, sid};
    return Policy::kAwaitVerdict;
  }

  // -- HTTP/2 mode -----------------------------------------------------------
  //
  // nghttp2 owns framing/HPACK/flow control; requests surface through
  // the callbacks below and run the SAME run_policy/ring path as h1.
  // Streams are serviced CONCURRENTLY — each proxied stream owns an
  // upstream socket and a streaming DATA provider, so responses flow
  // as the upstream delivers them (no whole-body buffering) and a slow
  // stream never blocks its siblings (reference: hyper auto builder,
  // http_listener.rs:276-278).

  bool start_h2(Conn* c) {
    nghttp2_session_callbacks* cbs = nullptr;
    if (nghttp2_session_callbacks_new(&cbs) != 0) return false;
    nghttp2_session_callbacks_set_on_header_callback(cbs, h2_on_header);
    nghttp2_session_callbacks_set_on_frame_recv_callback(cbs,
                                                         h2_on_frame_recv);
    nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
        cbs, h2_on_data_chunk);
    nghttp2_session_callbacks_set_on_stream_close_callback(
        cbs, h2_on_stream_close);
    // MANUAL receive-window management (no_auto_window_update +
    // nghttp2_session_consume): streamed request bodies only open the
    // client's send window as the UPSTREAM drains, so a slow upstream
    // backpressures the client through h2 flow control instead of
    // forcing a buffer-or-reset choice here.
    nghttp2_option* opt = nullptr;
    if (nghttp2_option_new(&opt) != 0) {
      nghttp2_session_callbacks_del(cbs);
      return false;
    }
    nghttp2_option_set_no_auto_window_update(opt, 1);
    int rv = nghttp2_session_server_new2(&c->h2, cbs, c, opt);
    nghttp2_option_del(opt);
    nghttp2_session_callbacks_del(cbs);
    if (rv != 0) return false;
    // Bound per-connection stream state: without this SETTINGS entry
    // RFC 7540 defaults to UNLIMITED concurrent streams — one client
    // could park thousands of buffered requests (the h1 plane's
    // kMaxHead/kMaxRequestsPerConn caps would be bypassed).
    nghttp2_settings_entry iv[] = {
        {NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 128}};
    nghttp2_submit_settings(c->h2, 0, iv, 1);
    // Upload head-of-line blocking: with manual window management, one
    // stream whose body is debt-parked behind a slow upstream holds its
    // received-but-unconsumed bytes against BOTH windows — and the
    // connection-level window defaults to the same 64KB as one stream,
    // so a single parked upload could close the shared window for every
    // other stream on the connection. Raise the connection window to
    // several per-stream windows so per-stream flow control is the
    // binding limit and siblings keep flowing.
    nghttp2_session_set_local_window_size(c->h2, NGHTTP2_FLAG_NONE, 0,
                                          kH2ConnRecvWindow);
    c->state = ConnState::kH2;
    return true;
  }

  // Feed bytes to the session, service ready streams, flush output.
  void h2_pump(Conn* c, const char* data, size_t len) {
    if (len > 0) {
      ssize_t n = nghttp2_session_mem_recv(
          c->h2, reinterpret_cast<const uint8_t*>(data), len);
      if (n < 0 || static_cast<size_t>(n) != len) {
        mark_close(c);
        return;
      }
    }
    h2_process_next(c);
    h2_flush(c);
    if (!c->dead && !nghttp2_session_want_read(c->h2) &&
        !nghttp2_session_want_write(c->h2))
      mark_close(c);  // session finished (GOAWAY processed)
  }

  void h2_flush(Conn* c) {
    // Client-side backpressure: stop pulling frames out of nghttp2 once
    // outbuf is at the cap — a client that raises its flow-control
    // windows but never reads its socket must not grow outbuf without
    // bound (streamed DATA bypasses the per-stream pending cap the
    // moment it leaves `pending`). nghttp2 keeps the frames queued;
    // the client-socket EPOLLOUT path resumes the drain.
    while (c->outbuf.size() < kMaxBuffered) {
      const uint8_t* out = nullptr;
      ssize_t n = nghttp2_session_mem_send(c->h2, &out);
      if (n <= 0) break;
      c->outbuf.append(reinterpret_cast<const char*>(out),
                       static_cast<size_t>(n));
    }
    if (!flush_out(c)) {
      mark_close(c);
      return;
    }
    update_client_events(c);
    // outbuf may have drained below the cap: re-arm upstream reads that
    // h2_update_stream_events paused on the outbuf gate.
    if (c->outbuf.size() < kMaxBuffered) {
      for (auto& [sid, st] : c->h2_streams) {
        if (st.up_fd >= 0 && st.up_ref != nullptr)
          h2_update_stream_events(c, st);
      }
    }
  }

  // Service every completed stream CONCURRENTLY — each proxied stream
  // gets its own upstream socket, so a slow stream never head-of-line
  // blocks the connection (reference: hyper multiplexes streams,
  // http_listener.rs:276). The upstream-socket count per connection is
  // capped; excess ready streams wait their turn in h2_ready.
  void h2_process_next(Conn* c) {
    // First hand freed upstream slots to streams whose verdict already
    // said proxy.
    while (!c->h2_proxy_wait.empty() &&
           c->h2_upstreams < kH2MaxStreamUpstreams) {
      int32_t sid = c->h2_proxy_wait.front();
      c->h2_proxy_wait.erase(c->h2_proxy_wait.begin());
      auto it = c->h2_streams.find(sid);
      if (it == c->h2_streams.end() || !it->second.up_queued) continue;
      it->second.up_queued = false;
      h2_start_stream_proxy(c, sid, it->second.up_target);
    }
    // Policy runs for EVERY ready stream regardless of upstream-slot
    // availability: 403s, captcha redirects, and the metrics endpoint
    // need no upstream, and kAwaitVerdict must enqueue to the verdict
    // ring promptly. Proxy outcomes that hit the per-connection slot
    // cap are parked by h2_start_stream_proxy (h2_proxy_wait) and
    // dispatched as slots free.
    size_t i = 0;
    while (i < c->h2_ready.size()) {
      int32_t sid = c->h2_ready[i];
      c->h2_ready.erase(c->h2_ready.begin() + i);
      auto it = c->h2_streams.find(sid);
      if (it == c->h2_streams.end()) continue;  // reset meanwhile
      if (it->second.p.path == "/__pingoo/metrics") {
        const char* ctype = nullptr;
        std::string body = metrics_negotiated(it->second.p, &ctype);
        h2_submit(c, sid, 200, {{"content-type", ctype}}, std::move(body));
        continue;
      }
      if (it->second.p.path == "/__pingoo/flightrecorder") {
        h2_submit(c, sid, 200, {{"content-type", "application/json"}},
                  flightrecorder_json());
        continue;
      }
      if (it->second.p.path == "/__pingoo/timeline") {
        h2_submit(c, sid, 200, {{"content-type", "application/json"}},
                  timeline_json());
        continue;
      }
      // h2 client streams are not body-inspected this iteration
      // (ISSUE 13, docs/BODY_STREAMING.md): DATA can arrive after the
      // stream dispatches, so a held-verdict design needs per-stream
      // flow accounting first. Counted, metadata-only.
      if (kBodyInspect &&
          (!it->second.body.empty() || !it->second.complete))
        stats_.body_h2_skipped++;
      Policy outcome = run_policy(c, sid);
      switch (outcome) {
        case Policy::kBlock:
          h2_respond_simple(c, sid, 403, "Forbidden");
          break;
        case Policy::kCaptchaRedirect:
          h2_respond_redirect(c, sid);
          break;
        case Policy::kCaptchaUpstream:
          {
            UpTarget t;
            t.sa = captcha_upstream_;
          t.internal = true;
            h2_start_stream_proxy(c, sid, t);
          }
          break;
        case Policy::kFailOpenProxy:
          stats_.fail_open++;
          flight_record(it->second.p, UINT64_MAX, 0, 0, 3);  // fail-open
          h2_stream_fail_open(c, sid);
          break;
        case Policy::kAwaitVerdict:
          break;  // the verdict callback services this stream
      }
    }
  }


  // -- per-stream upstream proxying (concurrent h2) --------------------------

  void h2_close_stream_upstream(Conn* c, H2Stream& st) {
    if (st.up_h2 != nullptr) {
      delete st.up_h2;
      st.up_h2 = nullptr;
    }
    st.up_proto_pending = false;
    if (st.up_ssl != nullptr) {
      SSL_shutdown(st.up_ssl);
      SSL_free(st.up_ssl);
      ERR_clear_error();
      st.up_ssl = nullptr;
    }
    st.up_tcp_ok = false;
    st.up_tls_hs = false;
    st.up_hs_want_write = false;
    st.up_rd_want_write = false;
    st.up_wr_want_read = false;
    if (st.up_fd >= 0) {
      epoll_ctl(ep_, EPOLL_CTL_DEL, st.up_fd, nullptr);
      close(st.up_fd);
      st.up_fd = -1;
      c->h2_upstreams--;
    }
    if (st.up_ref != nullptr) {
      // Events already harvested this batch may still hold the ref:
      // mark it dead and free it after the batch (like doomed conns).
      st.up_ref->h2_sid = -1;
      doomed_refs_.push_back(st.up_ref);
      st.up_ref = nullptr;
    }
    st.up_connected = false;
  }

  void h2_release_stream_resources(Conn* c, H2Stream& st) {
    if (st.ticket != UINT64_MAX) {
      awaiting_.erase(st.ticket);
      st.ticket = UINT64_MAX;
    }
    h2_close_stream_upstream(c, st);
  }

  // Response complete: pool the upstream connection when it is clean,
  // then service streams that were waiting for an upstream slot.
  void h2_stream_finish_upstream(Conn* c, H2Stream& st) {
    bool can_pool = st.resp_body.done &&
                    st.resp_body.mode != BodyFramer::kUntilEof &&
                    !st.up_eof && st.up_keep && !st.up_junk &&
                    st.complete &&  // streamed request body fully in
                    st.upbuf.empty() &&  // request fully sent: an early
                    // response over unsent body bytes would poison the
                    // pooled connection for its next user
                    st.up_key != 0 && st.up_fd >= 0 &&
                    (st.up_h2 == nullptr ||
                     (!st.up_h2->goaway && !st.up_h2->failed)) &&
                    upstream_pool_[st.up_key].size() < kPoolPerTarget;
    if (can_pool) {
      epoll_ctl(ep_, EPOLL_CTL_DEL, st.up_fd, nullptr);
      upstream_pool_[st.up_key].push_back(
          PooledUpstream{st.up_fd, st.up_ssl, st.up_target.sni, now_,
                         st.up_h2});
      st.up_fd = -1;
      st.up_ssl = nullptr;
      st.up_h2 = nullptr;  // ownership moved into the pool entry
      c->h2_upstreams--;
      if (st.up_ref != nullptr) {
        st.up_ref->h2_sid = -1;
        doomed_refs_.push_back(st.up_ref);
        st.up_ref = nullptr;
      }
      st.up_connected = false;
    } else {
      h2_close_stream_upstream(c, st);
    }
    h2_process_next(c);
  }

  void h2_update_stream_events(Conn* c, H2Stream& st) {
    if (st.up_fd < 0 || st.up_ref == nullptr) return;
    uint32_t ev = 0;
    if (st.up_tls_hs) {
      ev = st.up_hs_want_write ? EPOLLOUT : EPOLLIN;
    } else {
      // Read from the upstream only while BOTH buffers have room: the
      // per-stream pending cap bounds de-framed bytes awaiting nghttp2,
      // and the connection outbuf cap bounds bytes a non-reading client
      // has already been framed (h2_flush re-arms when it drains).
      bool can_read = !st.up_eof && st.pending.size() < kH2PendingCap &&
                      c->outbuf.size() < kMaxBuffered;
      if (can_read) ev = EPOLLIN;
      if (!st.upbuf.empty() || !st.up_connected) ev |= EPOLLOUT;
      if (st.up_rd_want_write) ev |= EPOLLOUT;
      if (st.up_wr_want_read) ev |= EPOLLIN;
      if (can_read && st.up_ssl != nullptr && SSL_pending(st.up_ssl) > 0)
        queue_ssl_resume(c, st.up_ref->h2_sid);
    }
    epoll_event e{};
    e.events = ev;
    e.data.ptr = st.up_ref;
    epoll_ctl(ep_, EPOLL_CTL_MOD, st.up_fd, &e);
  }

  // Put the head + whatever body bytes are buffered onto an h1
  // upstream link, with the stream's framing mode applied.
  void h2_stream_attach_h1_body(H2Stream& st) {
    st.upbuf = st.up_head;
    if (st.up_body_chunked) {
      h1_chunk_wrap(&st.upbuf, st.up_body.data(), st.up_body.size());
      if (st.complete) st.upbuf += "0\r\n\r\n";
    } else {
      st.upbuf += st.up_body;
    }
    st.up_body.clear();
  }

  // Adopt (or create) an h2 session for one downstream stream's
  // upstream link; buffered body bytes attach now, later ones stream
  // via h2_stream_body_chunk.
  bool h2_stream_begin_up_h2(Conn* c, int32_t sid, H2Stream& st,
                             UpH2Link* link) {
    if (link == nullptr) {
      link = new UpH2Link();
      if (!link->init()) {
        delete link;
        stats_.upstream_fail++;
        h2_close_stream_upstream(c, st);
        h2_respond_simple(c, sid, 502, "Bad Gateway");
        return false;
      }
    } else {
      link->reset_for_reuse();
    }
    st.up_h2 = link;
    bool has_body = !st.up_body.empty() || !st.complete;
    bool ok = link->submit(st.up_head, st.up_target.tls, has_body);
    if (ok && !st.up_body.empty()) {
      link->append_body(st.up_body.data(), st.up_body.size());
      st.up_body.clear();
    }
    if (ok && st.complete) link->finish_body();
    if (!ok || !link->pump_send(&st.upbuf)) {
      stats_.upstream_fail++;
      h2_close_stream_upstream(c, st);  // deletes the link
      h2_respond_simple(c, sid, 502, "Bad Gateway");
      return false;
    }
    st.up_replay.clear();  // raw-byte replay is h1-shaped: disabled
    st.up_pooled = false;
    return true;
  }

  void h2_start_stream_proxy(Conn* c, int32_t sid,
                             const UpTarget& target) {
    auto it = c->h2_streams.find(sid);
    if (it == c->h2_streams.end()) return;
    H2Stream& st = it->second;
    if (c->h2_upstreams >= kH2MaxStreamUpstreams) {
      // The per-connection upstream cap binds on EVERY dispatch path
      // (verdicts arrive for all ready streams at once): park the
      // stream until a slot frees (h2_process_next drains the queue).
      st.up_target = target;
      st.up_queued = true;
      c->h2_proxy_wait.push_back(sid);
      return;
    }
    uint64_t key = target_key(target);
    if (target.tls && up_ctx_ == nullptr) {
      stats_.upstream_fail++;
      h2_respond_simple(c, sid, 502, "Bad Gateway");
      return;
    }
    PooledUpstream pc{-1, nullptr, std::string(), 0};
    bool pooled = pop_pooled(target, &pc);
    int ufd = pc.fd;
    if (!pooled) {
      ufd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
      if (ufd < 0 ||
          (connect(ufd, reinterpret_cast<const sockaddr*>(&target.sa),
                   sizeof(target.sa)) != 0 &&
           errno != EINPROGRESS)) {
        if (ufd >= 0) close(ufd);
        stats_.upstream_fail++;
        h2_respond_simple(c, sid, 502, "Bad Gateway");
        return;
      }
    }
    st.up_fd = ufd;
    c->h2_upstreams++;  // before any failure path: h2_close_stream_
    // upstream decrements whenever up_fd >= 0, so counting after a
    // fallible step would underflow the cap counter
    st.up_key = key;
    st.up_target = target;
    st.up_pooled = pooled;
    st.up_ssl = pooled ? pc.ssl : nullptr;
    st.up_connected = pooled;
    st.up_tcp_ok = pooled;
    st.up_tls_hs = false;
    st.up_hs_want_write = false;
    st.up_rd_want_write = false;
    st.up_wr_want_read = false;
    st.up_eof = false;
    st.up_trunc = false;
    st.up_keep = false;
    st.up_junk = false;
    st.resp_head_buf.clear();
    st.resp_head_done = false;
    st.resp_body = BodyFramer();
    st.pending.clear();
    st.data_eof = false;
    st.submitted = false;
    // Body framing mode: complete bodies get a derived length;
    // streaming ones pass the client's content-length through or fall
    // back to chunked (decided BEFORE head synthesis).
    st.up_body_chunked = false;
    if (!st.complete) {
      bool has_cl = false;
      for (const auto& kv : st.p.h2_headers)
        if (kv.first == "content-length") has_cl = true;
      st.up_body_chunked = !has_cl;
    }
    st.up_dispatched = true;
    st.up_head = h2_upstream_head(c, st);
    st.up_body = std::move(st.body);  // raw bytes buffered so far
    st.body.clear();
    st.up_proto_pending = false;
    if (pooled && pc.h2link != nullptr) {
      if (!h2_stream_begin_up_h2(c, sid, st, pc.h2link)) return;
    } else if (target.h2) {
      if (!h2_stream_begin_up_h2(c, sid, st, nullptr)) return;
    } else if (target.tls && !pooled) {
      st.up_proto_pending = true;  // ALPN decides after the handshake
    } else {
      h2_stream_attach_h1_body(st);
    }
    if (!st.up_proto_pending && st.up_h2 == nullptr && st.complete) {
      // Replay is a raw byte copy: only a FULLY-KNOWN body can replay.
      st.up_replay = st.upbuf;
      if (st.up_replay.size() > kMaxReplay) {
        st.up_replay.clear();
        st.up_pooled = false;
      }
    } else if (st.up_h2 == nullptr && !st.complete) {
      st.up_replay.clear();
      st.up_pooled = false;
    }
    st.up_ref = new SockRef{c, true, sid};
    epoll_event ue{};
    ue.events = EPOLLOUT | EPOLLIN;
    ue.data.ptr = st.up_ref;
    epoll_ctl(ep_, EPOLL_CTL_ADD, ufd, &ue);
    // Pre-dispatch bytes may have closed the client's window; now that
    // they are on the forwarding path the drain hook will reopen it —
    // kick once for the case where everything already fits.
    h2_stream_release_window(c, sid, st);
  }

  bool h2_try_stream_retry(Conn* c, int32_t sid, H2Stream& st) {
    if (!st.up_pooled || st.up_replay.empty()) return false;
    if (!st.resp_head_buf.empty() || st.resp_head_done) return false;
    h2_close_stream_upstream(c, st);
    int ufd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (ufd < 0 ||
        (connect(ufd, reinterpret_cast<const sockaddr*>(&st.up_target.sa),
                 sizeof(st.up_target.sa)) != 0 &&
         errno != EINPROGRESS)) {
      if (ufd >= 0) close(ufd);
      return false;
    }
    st.up_fd = ufd;
    st.up_pooled = false;  // one retry only
    st.up_connected = false;  // close already reset the TLS link state
    st.up_eof = false;
    st.up_trunc = false;
    st.upbuf = st.up_replay;
    st.up_ref = new SockRef{c, true, sid};
    c->h2_upstreams++;
    epoll_event ue{};
    ue.events = EPOLLOUT | EPOLLIN;
    ue.data.ptr = st.up_ref;
    epoll_ctl(ep_, EPOLL_CTL_ADD, ufd, &ue);
    return true;
  }

  // Shared response-header build for the canned and streamed submit
  // paths: ONE copy of the connection-specific-header filter, so the
  // two paths cannot drift (connection-specific headers are illegal in
  // h2, RFC 9113 §8.2.2).
  void h2_submit_response_nva(Conn* c, int32_t sid,
                              const std::string& status,
                              const std::vector<std::pair<std::string,
                                                          std::string>>& hdrs,
                              long long content_length,
                              nghttp2_data_provider* prd) {
    std::vector<nghttp2_nv> nva;
    std::vector<std::string> keep;
    keep.reserve(hdrs.size() * 2 + 8);
    nva.reserve(hdrs.size() + 4);
    auto push = [&](const std::string& n, const std::string& v) {
      keep.push_back(n);
      const std::string& nn = keep.back();
      keep.push_back(v);
      const std::string& vv = keep.back();
      nghttp2_nv nv{};
      nv.name = reinterpret_cast<uint8_t*>(const_cast<char*>(nn.data()));
      nv.value = reinterpret_cast<uint8_t*>(const_cast<char*>(vv.data()));
      nv.namelen = nn.size();
      nv.valuelen = vv.size();
      nv.flags = NGHTTP2_NV_FLAG_NONE;
      nva.push_back(nv);
    };
    push(":status", status);
    for (const auto& kv : hdrs) {
      std::string lname = lower(kv.first);
      if (is_hop_header(lname) || lname == "content-length" ||
          lname == "transfer-encoding" || lname == "server" ||
          lname == "alt-svc" || lname.compare(0, 8, "x-accel-") == 0)
        continue;
      push(lname, kv.second);
    }
    push("server", "pingoo");
    if (content_length >= 0)
      push("content-length", std::to_string(content_length));
    if (nghttp2_submit_response(c->h2, sid, nva.data(), nva.size(), prd) !=
        0)
      c->h2_send.erase(sid);
  }

  // Non-final (1xx) HEADERS: no data provider, stream stays open for
  // the final response. Headers go through the same strip policy as
  // final heads (strip_response_header via parse of the rewritten
  // interim head).
  void h2_submit_interim(Conn* c, int32_t sid, int status,
                         const std::string& head) {
    std::string clean = rewrite_interim_head(head);
    std::vector<std::pair<std::string, std::string>> hdrs;
    parse_header_lines(clean, &hdrs);
    std::vector<nghttp2_nv> nva;
    std::vector<std::string> keep;
    keep.reserve(hdrs.size() * 2 + 2);
    nva.reserve(hdrs.size() + 1);
    auto push = [&](const std::string& n, const std::string& v) {
      keep.push_back(n);
      const std::string& nn = keep.back();
      keep.push_back(v);
      const std::string& vv = keep.back();
      nghttp2_nv nv{};
      nv.name = reinterpret_cast<uint8_t*>(const_cast<char*>(nn.data()));
      nv.value = reinterpret_cast<uint8_t*>(const_cast<char*>(vv.data()));
      nv.namelen = nn.size();
      nv.valuelen = vv.size();
      nv.flags = NGHTTP2_NV_FLAG_NONE;
      nva.push_back(nv);
    };
    push(":status", std::to_string(status));
    for (const auto& kv : hdrs) push(lower(kv.first), kv.second);
    nghttp2_submit_headers(c->h2, 0, sid, nullptr, nva.data(), nva.size(),
                           nullptr);
  }

  // Submit the response HEADERS with a STREAMING data provider: DATA
  // frames flow from st.pending as the upstream delivers bytes (no
  // whole-body buffering; responses larger than memory stream through).
  void h2_submit_streaming(Conn* c, int32_t sid, const RespHead& rh,
                           const std::string& head) {
    std::vector<std::pair<std::string, std::string>> hdrs;
    parse_header_lines(head, &hdrs);
    nghttp2_data_provider prd{};
    prd.read_callback = h2_data_read;
    h2_submit_response_nva(c, sid, std::to_string(rh.status), hdrs,
                           rh.content_length, &prd);
  }

  // Returns false when the stream was aborted/serviced and reading
  // must stop (the H2Stream reference may no longer be valid).
  bool h2_stream_upstream_data(Conn* c, int32_t sid, H2Stream& st,
                               const char* data, size_t len) {
    if (!st.resp_head_done) {
      st.resp_head_buf.append(data, len);
      for (;;) {
        size_t he = st.resp_head_buf.find("\r\n\r\n");
        if (he == std::string::npos) {
          if (st.resp_head_buf.size() > kMaxHead) {
            h2_close_stream_upstream(c, st);
            h2_abort_stream(c, sid);
            return false;
          }
          return true;
        }
        std::string head = st.resp_head_buf.substr(0, he + 4);
        int status = 0;
        if (head.size() >= 12 && head.compare(0, 7, "HTTP/1.") == 0 &&
            head[8] == ' ')
          status = atoi(head.c_str() + 9);
        if (status >= 100 && status < 200) {
          // Forward interim responses as non-final h2 HEADERS (hyper
          // relays them; reference http_listener.rs:276-278), with the
          // same hop-header/identity stripping as final heads. 101 is
          // not representable in h2 — drop it like nghttp2 would.
          if (status != 101) h2_submit_interim(c, sid, status, head);
          st.resp_head_buf.erase(0, he + 4);
          continue;
        }
        std::string rest = st.resp_head_buf.substr(he + 4);
        st.resp_head_buf.clear();
        RespHead rh = rewrite_response_head(head, false);
        if (!rh.ok) {
          h2_close_stream_upstream(c, st);
          stats_.upstream_fail++;
          h2_respond_simple(c, sid, 502, "Bad Gateway");
          h2_process_next(c);
          return false;
        }
        st.up_keep = rh.upstream_keep;
        bool head_only = st.p.method == "HEAD" || rh.status == 204 ||
                         rh.status == 304;
        if (head_only) st.resp_body.reset_none();
        else if (rh.chunked) st.resp_body.reset_chunked();
        else if (rh.content_length >= 0)
          st.resp_body.reset_cl(rh.content_length);
        else st.resp_body.reset_eof();
        st.resp_head_done = true;
        h2_submit_streaming(c, sid, rh, head);
        st.submitted = true;
        if (!rest.empty()) {
          size_t take = st.resp_body.consume(rest.data(), rest.size(),
                                             &st.pending);
          if (take < rest.size()) st.up_junk = true;
          if (st.resp_body.bad) {
            h2_close_stream_upstream(c, st);
            h2_abort_stream(c, sid);
            return false;
          }
          nghttp2_session_resume_data(c->h2, sid);
        }
        return true;
      }
    }
    if (!st.resp_body.done) {
      size_t take = st.resp_body.consume(data, len, &st.pending);
      if (take < len && st.resp_body.done) st.up_junk = true;
      if (st.resp_body.bad) {
        h2_close_stream_upstream(c, st);
        h2_abort_stream(c, sid);
        return false;
      }
      if (st.submitted && !st.pending.empty())
        nghttp2_session_resume_data(c->h2, sid);
    } else if (len > 0) {
      st.up_junk = true;
    }
    return true;
  }

  void h2_stream_check_done(Conn* c, int32_t sid, H2Stream& st) {
    if (!st.resp_head_done) {
      if (st.up_eof) {
        if (h2_try_stream_retry(c, sid, st)) return;
        h2_close_stream_upstream(c, st);
        stats_.upstream_fail++;
        h2_respond_simple(c, sid, 502, "Bad Gateway");
        h2_process_next(c);
      }
      return;
    }
    bool done = st.resp_body.done ||
                (st.resp_body.mode == BodyFramer::kUntilEof && st.up_eof &&
                 !st.up_trunc);
    if (done && !st.data_eof) {
      st.data_eof = true;
      if (st.resp_body.mode == BodyFramer::kUntilEof)
        st.resp_body.done = true;  // EOF framing: input ended the body
      nghttp2_session_resume_data(c->h2, sid);
      h2_stream_finish_upstream(c, st);
      return;
    }
    if (st.up_eof && !st.resp_body.done && !st.data_eof &&
        (st.resp_body.mode != BodyFramer::kUntilEof || st.up_trunc)) {
      // Truncated CL/chunked response — or an EOF-delimited body ended
      // by a transport ERROR (TLS: FIN without close_notify, which an
      // attacker can inject) rather than a clean close: reset the
      // stream so the client sees the failure instead of a
      // certified-complete short body (rustls: UnexpectedEof).
      h2_close_stream_upstream(c, st);
      h2_abort_stream(c, sid);
      h2_process_next(c);
    }
  }

  void h2_stream_upstream_event(Conn* c, int32_t sid, uint32_t events) {
    auto it = c->h2_streams.find(sid);
    if (it == c->h2_streams.end()) return;
    H2Stream& st = it->second;
    if (st.up_fd < 0) return;
    c->last_active = now_;
    if (!st.up_connected) {
      if (!st.up_tcp_ok && (events & (EPOLLOUT | EPOLLERR))) {
        int err = 0;
        socklen_t elen = sizeof(err);
        getsockopt(st.up_fd, SOL_SOCKET, SO_ERROR, &err, &elen);
        if (err != 0) {
          if (!h2_try_stream_retry(c, sid, st)) {
            h2_close_stream_upstream(c, st);
            stats_.upstream_fail++;
            h2_respond_simple(c, sid, 502, "Bad Gateway");
            h2_process_next(c);
          }
          h2_flush(c);
          return;
        }
        st.up_tcp_ok = true;
        if (st.up_target.tls) {
          if (!up_tls_begin(st.up_target, st.up_fd, &st.up_ssl)) {
            h2_close_stream_upstream(c, st);
            stats_.upstream_fail++;
            h2_respond_simple(c, sid, 502, "Bad Gateway");
            h2_process_next(c);
            h2_flush(c);
            return;
          }
          st.up_tls_hs = true;
        } else {
          st.up_connected = true;
        }
      }
      if (st.up_tls_hs) {
        int hs = up_tls_step(st.up_ssl, &st.up_hs_want_write);
        if (hs < 0) {
          stats_.upstream_tls_fail++;
          h2_close_stream_upstream(c, st);
          stats_.upstream_fail++;
          h2_respond_simple(c, sid, 502, "Bad Gateway");
          h2_process_next(c);
          h2_flush(c);
          return;
        }
        if (hs == 0) {
          h2_update_stream_events(c, st);
          return;
        }
        st.up_tls_hs = false;
        st.up_connected = true;
        if (st.up_proto_pending) {
          st.up_proto_pending = false;
          const unsigned char* ap = nullptr;
          unsigned aplen = 0;
          SSL_get0_alpn_selected(st.up_ssl, &ap, &aplen);
          if (aplen == 2 && memcmp(ap, "h2", 2) == 0) {
            if (!h2_stream_begin_up_h2(c, sid, st, nullptr)) {
              h2_flush(c);
              return;
            }
          } else {
            h2_stream_attach_h1_body(st);
            if (st.complete) {
              st.up_replay = st.upbuf;
              if (st.up_replay.size() > kMaxReplay) {
                st.up_replay.clear();
                st.up_pooled = false;
              }
            } else {
              st.up_replay.clear();
              st.up_pooled = false;
            }
          }
        }
      }
      if (!st.up_connected) return;  // TCP connect still pending
    }
    if ((events & EPOLLOUT) || st.up_wr_want_read) {
      while (!st.upbuf.empty() && st.up_connected) {
        st.up_wr_want_read = false;
        ssize_t w = up_send_raw(st.up_fd, st.up_ssl, st.upbuf.data(),
                                st.upbuf.size(), &st.up_wr_want_read);
        if (w > 0) {
          st.upbuf.erase(0, static_cast<size_t>(w));
        } else if (w == kIoAgain) {
          break;
        } else {
          if (!h2_try_stream_retry(c, sid, st)) {
            h2_close_stream_upstream(c, st);
            if (!st.resp_head_done) {
              stats_.upstream_fail++;
              h2_respond_simple(c, sid, 502, "Bad Gateway");
            } else {
              h2_abort_stream(c, sid);
            }
            h2_process_next(c);
          }
          h2_flush(c);
          return;
        }
      }
      // upstream writes drained some backlog: reopen the client's
      // send window if debt was parked on this stream
      h2_stream_release_window(c, sid, st);
    }
    if ((events & EPOLLIN) || st.up_rd_want_write) {
      char buf[16384];
      while (st.up_fd >= 0) {
        if (st.pending.size() > kH2PendingCap) break;  // backpressure
        st.up_rd_want_write = false;
        ssize_t r = up_recv_raw(st.up_fd, st.up_ssl, buf, sizeof(buf),
                                &st.up_rd_want_write);
        if (r > 0 && st.up_h2 != nullptr) {
          std::string synth;
          if (!st.up_h2->feed(buf, static_cast<size_t>(r), &synth)) {
            h2_close_stream_upstream(c, st);
            if (!st.resp_head_done) {
              stats_.upstream_fail++;
              h2_respond_simple(c, sid, 502, "Bad Gateway");
            } else {
              h2_abort_stream(c, sid);
            }
            h2_process_next(c);
            h2_flush(c);
            return;
          }
          st.up_h2->pump_send(&st.upbuf);
          if (!synth.empty() &&
              !h2_stream_upstream_data(c, sid, st, synth.data(),
                                       synth.size())) {
            h2_flush(c);
            return;  // stream aborted/serviced: st may be gone
          }
        } else if (r > 0) {
          if (!h2_stream_upstream_data(c, sid, st, buf,
                                       static_cast<size_t>(r))) {
            h2_flush(c);
            return;  // stream aborted/serviced: st may be gone
          }
        } else if (r == kIoAgain) {
          break;
        } else {
          st.up_eof = true;
          if (r == kIoErr) st.up_trunc = true;  // FIN sans close_notify /
          break;                                // transport error
        }
      }
    }
    if (events & (EPOLLHUP | EPOLLERR)) st.up_eof = true;
    h2_stream_check_done(c, sid, st);
    // After check_done the stream's upstream may be released; the map
    // entry itself survives until nghttp2 closes the stream.
    auto again = c->h2_streams.find(sid);
    if (again != c->h2_streams.end() && again->second.up_fd >= 0)
      h2_update_stream_events(c, again->second);
    h2_flush(c);
  }

  static constexpr long long kClFromBody = -2;  // derive from body.size()

  void h2_submit(Conn* c, int32_t sid, int status,
                 const std::vector<std::pair<std::string, std::string>>&
                     headers,
                 std::string body, long long content_length = kClFromBody) {
    // kClFromBody derives the length from the body; >= 0 overrides it
    // (HEAD advertises the entity size while sending no body); -1
    // omits the header entirely (304 responses).
    if (content_length == kClFromBody)
      content_length = static_cast<long long>(body.size());
    c->h2_send[sid] = {std::move(body), 0};
    nghttp2_data_provider prd{};
    prd.read_callback = h2_data_read;
    h2_submit_response_nva(c, sid, std::to_string(status), headers,
                           content_length, &prd);
  }

  void h2_respond_simple(Conn* c, int32_t sid, int status,
                         const char* text) {
    h2_submit(c, sid, status,
              {{"content-type", "text/plain"}}, text);
  }

  void h2_respond_redirect(Conn* c, int32_t sid) {
    h2_submit(c, sid, 302, {{"location", "/__pingoo/captcha"}}, "");
  }

  // Synthesized upstream h1 request head for the active h2 stream
  // (h2 streams have no raw h1 head to rewrite). HEAD ONLY — the body
  // is framed by the caller per st's streaming mode: complete bodies
  // get a derived content-length, streamed ones pass the client's
  // content-length through or fall back to chunked.
  std::string h2_upstream_head(Conn* c, const H2Stream& st) {
    const Parsed& p = st.p;
    std::string out = p.method + " " + p.target + " HTTP/1.1\r\n";
    if (!p.host.empty()) out += "host: " + p.host + "\r\n";
    const std::string* client_cl = nullptr;
    for (const auto& kv : p.h2_headers) {
      if (kv.first == "content-length") client_cl = &kv.second;
      if (drop_request_header(kv.first, false) || kv.first == "host")
        continue;
      out += kv.first + ": " + kv.second + "\r\n";
    }
    out += "connection: keep-alive\r\n";
    if (st.complete) {
      if (!st.body.empty())
        out += "content-length: " + std::to_string(st.body.size()) + "\r\n";
    } else if (client_cl != nullptr) {
      out += "content-length: " + *client_cl + "\r\n";
    } else if (st.up_body_chunked) {
      out += "transfer-encoding: chunked\r\n";
    }
    out += "x-forwarded-for: " + std::string(c->peer_ip) + "\r\n";
    out += std::string("x-forwarded-proto: ") +
           (c->ssl != nullptr ? "https" : "http") + "\r\n";
    if (!p.host.empty()) out += "x-forwarded-host: " + p.host + "\r\n";
    if (st.up_target.internal && !internal_token_.empty())
      out += "x-pingoo-internal: " + internal_token_ + "\r\n";
    out += "pingoo-client-ip: " + std::string(c->peer_ip) + "\r\n\r\n";
    return out;
  }

  static void h1_chunk_wrap(std::string* out, const char* d, size_t n) {
    if (n == 0) return;  // a zero-size chunk would terminate the body
    char sz[32];
    snprintf(sz, sizeof(sz), "%zx\r\n", n);
    out->append(sz);
    out->append(d, n);
    out->append("\r\n");
  }

  // Forward one streamed request-body chunk / the end-of-body mark to
  // the stream's upstream (called from the nghttp2 receive callbacks).
  void h2_stream_body_chunk(Conn* c, H2Stream& st, const char* d,
                            size_t n) {
    if (st.up_proto_pending || st.up_queued || st.up_fd < 0) {
      st.up_body.append(d, n);  // framed at adoption/dispatch
      return;
    }
    if (st.up_h2 != nullptr) {
      st.up_h2->append_body(d, n);
      st.up_h2->pump_send(&st.upbuf);
    } else if (st.up_body_chunked) {
      h1_chunk_wrap(&st.upbuf, d, n);
    } else {
      st.upbuf.append(d, n);
    }
    h2_update_stream_events(c, st);
  }

  // Reopen the client's send window once the upstream has drained the
  // backlog below half the cap (manual flow control: window debt
  // accrued in h2_on_data_chunk). Must run from every path that
  // shrinks the stream's pending bytes.
  void h2_stream_release_window(Conn* c, int32_t sid, H2Stream& st) {
    if (st.window_debt == 0 || c->h2 == nullptr) return;
    size_t pending = st.upbuf.size() + st.up_body.size() +
                     (st.up_h2 != nullptr ? st.up_h2->body.size() : 0);
    if (pending >= kMaxBuffered / 2) return;
    nghttp2_session_consume(c->h2, sid,
                            static_cast<size_t>(st.window_debt));
    st.window_debt = 0;
    h2_flush(c);  // the WINDOW_UPDATE frames must reach the wire
  }

  void h2_stream_body_finish(Conn* c, H2Stream& st) {
    if (st.up_proto_pending || st.up_queued || st.up_fd < 0)
      return;  // adoption/dispatch sees st.complete and finishes
    if (st.up_h2 != nullptr) {
      st.up_h2->finish_body();
      st.up_h2->pump_send(&st.upbuf);
    } else if (st.up_body_chunked) {
      st.upbuf += "0\r\n\r\n";
    }
    h2_update_stream_events(c, st);
  }

  static int h2_on_header(nghttp2_session*, const void* frame,
                          const uint8_t* name, size_t namelen,
                          const uint8_t* value, size_t valuelen, uint8_t,
                          void* user_data) {
    Conn* c = static_cast<Conn*>(user_data);
    const auto* hd = static_cast<const nghttp2_frame_hd*>(frame);
    H2Stream& st = c->h2_streams[hd->stream_id];
    std::string n(reinterpret_cast<const char*>(name), namelen);
    std::string v(reinterpret_cast<const char*>(value), valuelen);
    Parsed& p = st.p;
    if (n == ":method") {
      p.method = v;
    } else if (n == ":path") {
      p.target = v;
      size_t q = v.find('?');
      p.path = q == std::string::npos ? v : v.substr(0, q);
    } else if (n == ":authority") {
      p.host = strip_host_port(v);
    } else if (!n.empty() && n[0] == ':') {
      // other pseudo-headers ignored
    } else {
      if (n == "user-agent") p.user_agent = trim(v);
      if (n == "accept") p.accept = lower(trim(v));
      if (n == "cookie" && p.verified_cookie.empty())
        p.verified_cookie = extract_verified_cookie(v);
      p.h2_headers.emplace_back(lower(n), v);
    }
    return 0;
  }

  static int h2_on_frame_recv(nghttp2_session*, const void* frame,
                              void* user_data) {
    Conn* c = static_cast<Conn*>(user_data);
    const auto* hd = static_cast<const nghttp2_frame_hd*>(frame);
    bool end_stream = (hd->flags & NGHTTP2_FLAG_END_STREAM) != 0;
    if (hd->type == NGHTTP2_FRAME_HEADERS &&
        (hd->flags & NGHTTP2_FLAG_END_HEADERS) != 0) {
      auto it = c->h2_streams.find(hd->stream_id);
      if (it == c->h2_streams.end()) return 0;
      H2Stream& st = it->second;
      if (!st.ready_queued) {
        // Dispatch at END_HEADERS (the verdict tuple needs no body):
        // request bodies STREAM to the upstream as DATA arrives, like
        // the reference's hyper service (http_listener.rs:276).
        st.ready_queued = true;
        st.complete = end_stream;
        st.p.ok = !st.p.method.empty() && !st.p.target.empty();
        c->h2_ready.push_back(hd->stream_id);
      } else if (end_stream && !st.complete) {
        // TRAILERS: a second HEADERS frame carrying END_STREAM ends
        // the body exactly like a final DATA frame would.
        st.complete = true;
        if (st.up_dispatched && g_server != nullptr)
          g_server->h2_stream_body_finish(c, st);
      }
      return 0;
    }
    if (hd->type == NGHTTP2_FRAME_DATA && end_stream) {
      auto it = c->h2_streams.find(hd->stream_id);
      if (it != c->h2_streams.end() && !it->second.complete) {
        H2Stream& st = it->second;
        st.complete = true;
        if (st.up_dispatched && g_server != nullptr)
          g_server->h2_stream_body_finish(c, st);
      }
    }
    return 0;
  }

  static int h2_on_data_chunk(nghttp2_session* sess, uint8_t,
                              int32_t stream_id, const uint8_t* data,
                              size_t len, void* user_data) {
    Conn* c = static_cast<Conn*>(user_data);
    H2Stream& st = c->h2_streams[stream_id];
    if (st.up_dispatched && g_server != nullptr) {
      // Streamed forwarding under manual flow control: bytes are
      // CONSUMED (window reopened) only while the pending backlog is
      // under half the cap; past that they accrue window debt, the
      // client's send window closes, and the debt is released as the
      // upstream drains (h2_stream_release_window). Bodies of ANY
      // size stream through at the pace of the slowest hop.
      g_server->h2_stream_body_chunk(
          c, st, reinterpret_cast<const char*>(data), len);
      size_t pending = st.upbuf.size() + st.up_body.size() +
                       (st.up_h2 != nullptr ? st.up_h2->body.size() : 0);
      if (pending < kMaxBuffered / 2) {
        nghttp2_session_consume(sess, stream_id, len);
      } else {
        st.window_debt += len;
      }
      return 0;
    }
    // Pre-dispatch (or non-proxy outcome) bytes buffer in st.body
    // under the same debt-based window withholding: small bodies
    // consume freely (the verdict round-trip must not stall the
    // client), larger ones close the window until dispatch drains the
    // buffer — st.body stays bounded by cap/2 plus the client's
    // in-flight window, with no resets. Debt parked on a stream that
    // never proxies (403/captcha) is returned to the connection
    // window at stream close.
    st.body.append(reinterpret_cast<const char*>(data), len);
    if (st.body.size() < kMaxBuffered / 2) {
      nghttp2_session_consume(sess, stream_id, len);
    } else {
      st.window_debt += len;
    }
    return 0;
  }

  static int h2_on_stream_close(nghttp2_session* sess, int32_t stream_id,
                                uint32_t, void* user_data) {
    Conn* c = static_cast<Conn*>(user_data);
    auto it = c->h2_streams.find(stream_id);
    if (it != c->h2_streams.end()) {
      if (it->second.window_debt > 0) {
        // the stream window dies with the stream, but unconsumed bytes
        // still hold CONNECTION window — leak enough of them and every
        // other stream on the session stalls
        nghttp2_session_consume_connection(
            sess, static_cast<size_t>(it->second.window_debt));
        it->second.window_debt = 0;
      }
      if (g_server != nullptr)
        g_server->h2_release_stream_resources(c, it->second);
      c->h2_streams.erase(it);
    }
    c->h2_send.erase(stream_id);
    if (g_server != nullptr) g_server->h2_process_next(c);
    return 0;
  }

  static ssize_t h2_data_read(nghttp2_session*, int32_t stream_id,
                              uint8_t* buf, size_t length,
                              uint32_t* data_flags, nghttp2_data_source*,
                              void* user_data) {
    Conn* c = static_cast<Conn*>(user_data);
    auto it = c->h2_send.find(stream_id);
    if (it != c->h2_send.end()) {  // canned (non-proxied) response
      const std::string& body = it->second.first;
      size_t& off = it->second.second;
      size_t n = std::min(body.size() - off, length);
      if (n > 0) {
        std::memcpy(buf, body.data() + off, n);
        off += n;
      }
      if (off >= body.size()) {
        *data_flags = NGHTTP2_DATA_FLAG_EOF;
        c->h2_send.erase(it);
      }
      return static_cast<ssize_t>(n);
    }
    // Streamed proxied response: DATA flows as the upstream delivers it.
    auto sit = c->h2_streams.find(stream_id);
    if (sit == c->h2_streams.end()) {
      *data_flags = NGHTTP2_DATA_FLAG_EOF;
      return 0;
    }
    H2Stream& st = sit->second;
    if (st.pending.empty()) {
      if (st.data_eof) {
        *data_flags = NGHTTP2_DATA_FLAG_EOF;
        return 0;
      }
      return kNghttp2ErrDeferred;  // resumed when more bytes arrive
    }
    size_t n = std::min(st.pending.size(), length);
    std::memcpy(buf, st.pending.data(), n);
    st.pending.erase(0, n);
    if (st.pending.empty() && st.data_eof)
      *data_flags = NGHTTP2_DATA_FLAG_EOF;
    // Draining below the cap re-arms the paused upstream read side.
    if (g_server != nullptr && st.up_fd >= 0)
      g_server->h2_update_stream_events(c, st);
    return static_cast<ssize_t>(n);
  }

  void drop_ticket(Conn* c) {
    if (c->ticket != UINT64_MAX) {
      awaiting_.erase(c->ticket);
      c->ticket = UINT64_MAX;
    }
  }

  void on_h2_event(Conn* c, uint32_t events) {
    c->last_active = now_;
    if (events & EPOLLIN) {
      char buf[16384];
      for (;;) {
        ssize_t r = t_read(c, buf, sizeof(buf));
        if (r > 0) {
          h2_pump(c, buf, static_cast<size_t>(r));
          if (c->dead) return;
        } else if (r == 0) {
          mark_close(c);
          return;
        } else if (r == -1) {
          break;
        } else {
          mark_close(c);
          return;
        }
      }
    }
    if (events & EPOLLOUT) {
      c->ssl_want_write = false;
      h2_flush(c);
    }
  }

  // -- proxy phase ----------------------------------------------------------

  void on_proxy_client_event(Conn* c, uint32_t events) {
    c->last_active = now_;
    if (events & EPOLLIN) {
      char buf[16384];
      for (;;) {
        ssize_t r = t_read(c, buf, sizeof(buf));
        if (r > 0) {
          c->inbuf.append(buf, static_cast<size_t>(r));
          if (c->inbuf.size() > kMaxBuffered) break;  // backpressure
        } else if (r == 0) {
          // Half-close: remember it (update_client_events disarms the
          // read side) — the response direction may continue.
          c->client_eof = true;
          if (!c->req_body.done && c->req_body.mode == BodyFramer::kUntilEof)
            c->req_body.done = true;
          break;
        } else if (r == -1) {
          break;
        } else {
          mark_close(c);
          return;
        }
      }
      pump_request_body(c);
      flush_upstream(c);
    }
    if (events & EPOLLOUT) {
      c->ssl_want_write = false;
      if (!flush_out(c)) {
        mark_close(c);
        return;
      }
      maybe_finish_response(c);
      if (c->dead || c->state != ConnState::kProxying) return;
    }
    update_client_events(c);
    update_upstream_events(c);
  }

  void flush_upstream(Conn* c) {
    while (!c->upbuf.empty() && c->upstream_fd >= 0 && c->upstream_connected) {
      c->up_wr_want_read = false;
      ssize_t w = up_send_raw(c->upstream_fd, c->up_ssl, c->upbuf.data(),
                              c->upbuf.size(), &c->up_wr_want_read);
      if (w > 0) {
        c->upbuf.erase(0, static_cast<size_t>(w));
      } else if (w == kIoAgain) {
        break;
      } else {
        // Upstream write failure mid-request: 502 if nothing sent yet,
        // else close.
        if (c->resp_head_done && c->state != ConnState::kH2) mark_close(c);
        else respond_502(c);
        return;
      }
    }
  }

  bool proxy_live(Conn* c) const {
    return c->state == ConnState::kProxying ||
           c->state == ConnState::kTunnel;
  }

  void on_upstream_event(Conn* c, uint32_t events) {
    c->last_active = now_;
    if (!c->upstream_connected) {
      if (!c->up_tcp_ok && (events & (EPOLLOUT | EPOLLERR))) {
        int err = 0;
        socklen_t len = sizeof(err);
        getsockopt(c->upstream_fd, SOL_SOCKET, SO_ERROR, &err, &len);
        if (err != 0) {
          close_upstream(c);
          respond_502(c);
          return;
        }
        c->up_tcp_ok = true;
        if (c->up_target.tls) {
          if (!up_tls_begin(c->up_target, c->upstream_fd, &c->up_ssl,
                               !c->req.is_upgrade())) {
            close_upstream(c);
            respond_502(c);
            return;
          }
          c->up_tls_hs = true;
        } else {
          c->upstream_connected = true;
        }
      }
      if (c->up_tls_hs) {
        int hs = up_tls_step(c->up_ssl, &c->up_hs_want_write);
        if (hs < 0) {
          stats_.upstream_tls_fail++;
          close_upstream(c);
          respond_502(c);
          return;
        }
        if (hs == 0) {
          update_upstream_events(c);
          return;
        }
        c->up_tls_hs = false;
        c->upstream_connected = true;
        if (c->up_proto_pending) {
          c->up_proto_pending = false;
          const unsigned char* ap = nullptr;
          unsigned aplen = 0;
          SSL_get0_alpn_selected(c->up_ssl, &ap, &aplen);
          if (aplen == 2 && memcmp(ap, "h2", 2) == 0) {
            if (!begin_upstream_h2(c, nullptr)) return;
          } else {
            c->upbuf = c->up_head;
          }
          finish_upstream_send_setup(c);
        }
      }
      if (!c->upstream_connected) return;  // TCP connect still pending
    }
    if (events & EPOLLOUT || c->up_wr_want_read) flush_upstream(c);
    if (c->dead || !proxy_live(c)) return;
    if ((events & EPOLLIN) || c->up_rd_want_write) {
      char buf[16384];
      for (;;) {
        if (c->outbuf.size() > kMaxBuffered) break;  // backpressure
        c->up_rd_want_write = false;
        ssize_t r = up_recv_raw(c->upstream_fd, c->up_ssl, buf, sizeof(buf),
                                &c->up_rd_want_write);
        if (r > 0 && c->up_h2 != nullptr) {
          std::string synth;
          if (!c->up_h2->feed(buf, static_cast<size_t>(r), &synth)) {
            if (!c->resp_head_done) {
              respond_502(c);
            } else {
              mark_close(c);
            }
            return;
          }
          if (!synth.empty()) {
            on_upstream_data(c, synth.data(), synth.size());
            // The synthesized bytes may COMPLETE the response: the
            // link is then released/closed (up_h2 == nullptr) and the
            // connection may already be proxying a pipelined next
            // request (even over a fresh link) — this event context is
            // stale either way.
            if (c->dead || !proxy_live(c) || c->up_h2 == nullptr) return;
          }
          // acks/window updates the session owes after the feed, and
          // any request-body bytes the 1 MiB link cap left stranded in
          // inbuf — the client may be done sending (no more client
          // events), so the upstream's WINDOW_UPDATEs must re-drive
          // the pump or a large upload deadlocks here.
          pump_request_body(c);
          if (c->dead) return;
          c->up_h2->pump_send(&c->upbuf);
        } else if (r > 0) {
          on_upstream_data(c, buf, static_cast<size_t>(r));
          if (c->dead || !proxy_live(c)) return;
        } else if (r == 0) {
          c->upstream_eof = true;
          break;
        } else if (r == kIoAgain) {
          break;
        } else {
          c->upstream_eof = true;
          c->up_trunc = true;  // FIN sans close_notify / transport error
          break;
        }
      }
    }
    if (events & (EPOLLHUP | EPOLLERR)) c->upstream_eof = true;
    if (!flush_out(c)) {
      mark_close(c);
      return;
    }
    maybe_finish_response(c);
    if (c->dead || !proxy_live(c)) return;
    update_client_events(c);
    update_upstream_events(c);
  }

  // h1 proxy: stream the upstream response to the client, rewriting
  // the head (and entering raw-tunnel mode on an accepted upgrade).
  void on_upstream_data(Conn* c, const char* data, size_t len) {
    if (c->state == ConnState::kTunnel) {
      c->outbuf.append(data, len);  // raw splice after the 101
      return;
    }
    if (!c->resp_head_done) {
      c->resp_head_buf.append(data, len);
      // Parse heads in a loop: 1xx interim responses (e.g. 100
      // Continue for Expect: 100-continue POSTs) are relayed and the
      // FINAL response head follows on the same connection.
      for (;;) {
        size_t he = c->resp_head_buf.find("\r\n\r\n");
        if (he == std::string::npos) {
          if (c->resp_head_buf.size() > kMaxHead) mark_close(c);
          return;
        }
        std::string head = c->resp_head_buf.substr(0, he + 4);
        RespHead rh = rewrite_response_head(head, c->req.keep_alive);
        if (!rh.ok) {
          respond_502(c);
          return;
        }
        if (rh.status == 101 && c->req.is_upgrade()) {
          // Upgrade accepted: relay the 101 head VERBATIM — its
          // Connection/Upgrade/Sec-WebSocket-* headers are the
          // handshake — then splice raw bytes both ways until either
          // side closes (reference http_listener.rs:277
          // serve_connection_with_upgrades).
          c->outbuf += head;
          c->outbuf += c->resp_head_buf.substr(he + 4);
          c->resp_head_buf.clear();
          c->resp_head_done = true;
          c->close_after_response = true;
          c->state = ConnState::kTunnel;
          // Frames an optimistic client sent right after its upgrade
          // request are sitting in inbuf — splice them into the tunnel
          // (the Python plane forwards h11 trailing_data the same way).
          if (!c->inbuf.empty()) {
            c->upbuf += c->inbuf;
            c->inbuf.clear();
            flush_upstream(c);
          }
          update_client_events(c);
          update_upstream_events(c);
          return;
        }
        if (rh.status >= 100 && rh.status < 200) {
          // interim: strip hop/identity headers like final heads, keep
          // the 1xx status line, keep parsing for the final head
          c->outbuf += rewrite_interim_head(head);
          c->resp_head_buf.erase(0, he + 4);
          continue;
        }
        bool head_only = c->req.method == "HEAD" || rh.status == 204 ||
                         rh.status == 304;
        c->upstream_keep = rh.upstream_keep;
        if (head_only) {
          c->resp_body.reset_none();
        } else if (rh.chunked) {
          c->resp_body.reset_chunked();
        } else if (rh.content_length >= 0) {
          c->resp_body.reset_cl(rh.content_length);
        } else {
          c->resp_body.reset_eof();
          c->close_after_response = true;  // EOF-delimited: client closes too
        }
        if (!c->req.keep_alive) c->close_after_response = true;
        c->outbuf += rh.rewritten;
        // Remaining bytes after the head are body bytes.
        std::string rest = c->resp_head_buf.substr(he + 4);
        c->resp_head_buf.clear();
        c->resp_head_done = true;
        if (!rest.empty()) {
          size_t take = c->resp_body.consume(rest.data(), rest.size());
          c->outbuf.append(rest, 0, take);
          // bytes past the response end are junk; drop them (and never
          // pool a connection that sent them)
          if (take < rest.size()) c->upstream_junk = true;
          if (c->resp_body.bad) mark_close(c);
        }
        return;
      }
    }
    if (!c->resp_body.done) {
      size_t take = c->resp_body.consume(data, len);
      c->outbuf.append(data, take);
      if (take < len && c->resp_body.done) c->upstream_junk = true;
    } else if (len > 0) {
      c->upstream_junk = true;
    }
    if (c->resp_body.bad) mark_close(c);  // malformed upstream chunking
  }

  // Tunnel teardown policy. WebSocket tunnels close as a unit once the
  // upstream ends; raw TCP (tcp-proxy mode) propagates each side's FIN
  // independently like the reference's copy_bidirectional
  // (tcp_proxy_service.rs:74-82) and closes only when BOTH directions
  // are finished.
  void tunnel_check_done(Conn* c) {
    if (c->client_eof && c->upbuf.empty() && !c->up_shut &&
        c->upstream_fd >= 0) {
      if (c->up_ssl != nullptr) SSL_shutdown(c->up_ssl);
      shutdown(c->upstream_fd, SHUT_WR);
      c->up_shut = true;
    }
    if (c->upstream_eof && c->outbuf.empty()) {
      if (!tcp_mode_) {
        mark_close(c);
        return;
      }
      if (!c->down_shut) {
        if (c->ssl != nullptr) SSL_shutdown(c->ssl);
        shutdown(c->fd, SHUT_WR);
        c->down_shut = true;
      }
      // half-open: keep relaying client -> upstream until the client
      // finishes too (or the idle sweep reaps the connection)
      if (c->client_eof && c->upbuf.empty()) mark_close(c);
    }
  }

  void maybe_finish_response(Conn* c) {
    if (c->state == ConnState::kTunnel) {
      tunnel_check_done(c);
      return;
    }
    if (c->state != ConnState::kProxying || !c->resp_head_done) {
      // EOF from upstream before any response head -> 502
      if (c->state == ConnState::kProxying && c->upstream_eof &&
          !c->resp_head_done) {
        if (try_pooled_retry(c)) return;
        stats_.upstream_fail++;
        respond_close(c, k502);
      }
      return;
    }
    bool body_done = c->resp_body.done ||
                     (c->resp_body.mode == BodyFramer::kUntilEof &&
                      c->upstream_eof && !c->up_trunc);
    if (!body_done) {
      if (c->upstream_eof && !c->resp_body.done &&
          (c->resp_body.mode != BodyFramer::kUntilEof || c->up_trunc)) {
        // Truncated upstream response (explicit framing cut short, or
        // an EOF-delimited TLS body ended by FIN without close_notify):
        // relay what we have, then close — never pool, and for
        // explicitly framed bodies the client sees the short read.
        c->close_after_response = true;
        body_done = true;
      } else {
        return;
      }
    }
    if (!c->outbuf.empty()) return;  // keep draining first
    // Reuse the upstream connection when the response left it in a
    // known-clean state: explicit framing fully consumed, no EOF, no
    // bytes past the response end, and the upstream allows keep-alive.
    if (c->resp_body.done && c->resp_body.mode != BodyFramer::kUntilEof &&
        !c->upstream_eof && c->upstream_keep && !c->upstream_junk &&
        c->upbuf.empty() && c->req_body_forwarded &&
        (c->up_h2 == nullptr ||
         (!c->up_h2->goaway && !c->up_h2->failed))) {
      release_upstream(c);
    } else {
      close_upstream(c);
    }
    if (c->close_after_response) {
      mark_close(c);
      return;
    }
    begin_request_cycle(c);
  }

  // -- TLS handshake --------------------------------------------------------

  void on_handshake(Conn* c) {
    c->last_active = now_;
    c->ssl_want_write = false;
    int r = SSL_do_handshake(c->ssl);
    if (r == 1) {
      if (c->acme_challenge) {
        // tls-alpn-01: the validation server only needs the handshake
        // (RFC 8737 §3); close once it completes.
        mark_close(c);
        return;
      }
      if (tcp_mode_) {
        start_tcp_proxy(c);
        return;
      }
      c->state = ConnState::kReadingHead;
      update_client_events(c);
      return;
    }
    int err = SSL_get_error(c->ssl, r);
    ERR_clear_error();
    if (err == SSL_ERROR_WANT_READ) {
      update_client_events(c);
      return;
    }
    if (err == SSL_ERROR_WANT_WRITE) {
      c->ssl_want_write = true;
      update_client_events(c);
      return;
    }
    mark_close(c);
  }

  void handle(SockRef* ref, uint32_t events) {
    Conn* c = ref->conn;
    if (c == nullptr || ref->h2_sid < 0) return;  // dead stream ref
    if (c->dead) return;  // stale event within this batch
    if (ref->is_upstream) {
      if (ref->h2_sid > 0) {
        h2_stream_upstream_event(c, ref->h2_sid, events);
      } else if (proxy_live(c)) {
        on_upstream_event(c, events);
      }
      return;
    }
    switch (c->state) {
      case ConnState::kHandshake:
        if (events & (EPOLLHUP | EPOLLERR)) mark_close(c);
        else on_handshake(c);
        break;
      case ConnState::kReadingHead:
        if (events & (EPOLLIN | EPOLLHUP)) on_client_readable(c);
        else if (events & EPOLLOUT) {
          c->ssl_want_write = false;
          if (!flush_out(c)) mark_close(c);
          else update_client_events(c);
        }
        break;
      case ConnState::kAwaitingVerdict:
        if ((events & EPOLLIN) && c->body_inspect) on_body_readable(c);
        if (!c->dead && (events & (EPOLLHUP | EPOLLERR))) mark_close(c);
        break;
      case ConnState::kProxying:
        if (events & (EPOLLHUP | EPOLLERR)) {
          // client side error/hangup
          mark_close(c);
          return;
        }
        on_proxy_client_event(c, events);
        break;
      case ConnState::kTunnel:
        if (events & EPOLLERR) {
          mark_close(c);
          return;
        }
        // EPOLLHUP fires once BOTH directions are shut — pending bytes
        // are still readable, so drain first (the read loop's r==0
        // sets client_eof). HUP cannot be masked by a 0 event mask, so
        // an ALREADY-drained client is handled here: close when its
        // relay backlog is through; otherwise stop watching the client
        // fd entirely (nothing can arrive or be delivered) and let
        // upstream EPOLLOUT drain the remaining upbuf tail.
        if ((events & EPOLLHUP) && c->client_eof) {
          if (c->upbuf.empty()) {
            mark_close(c);
          } else {
            epoll_ctl(ep_, EPOLL_CTL_DEL, c->fd, nullptr);
            update_upstream_events(c);
          }
          return;
        }
        on_tunnel_client_event(
            c, events | ((events & EPOLLHUP) ? EPOLLIN : 0u));
        break;
      case ConnState::kH2:
        if (events & (EPOLLHUP | EPOLLERR)) {
          mark_close(c);
          return;
        }
        on_h2_event(c, events);
        break;
      case ConnState::kClosing:
        if (events & (EPOLLHUP | EPOLLERR)) mark_close(c);
        else if (events & EPOLLOUT) {
          c->ssl_want_write = false;
          if (!flush_out(c) || c->outbuf.empty()) mark_close(c);
        }
        break;
    }
  }

 private:
  int ep_;
  void* ring_;
  sockaddr_in upstream_;
  sockaddr_in captcha_upstream_{};
  bool has_captcha_upstream_ = false;
  CaptchaGate* gate_;
  TlsStore* tls_;
  ServiceTable* services_ = nullptr;
  SSL_CTX* up_ctx_ = nullptr;  // upstream TLS client context
  std::unordered_map<std::string, StaticFile> file_cache_;  // static sites
  std::string internal_token_;  // per-boot control-plane trust token
  bool tcp_mode_ = false;  // raw TCP(+TLS) fronting: no HTTP, no verdicts
  // Links whose SSL object holds decrypted-but-undelivered bytes (no fd
  // readiness will fire for them); drained after each event batch.
  std::vector<std::pair<Conn*, int32_t>> ssl_resume_;
  uint32_t rng_ = 0x9e3779b9;  // xorshift32 state for upstream choice
  std::unordered_map<uint64_t, std::vector<PooledUpstream>> upstream_pool_;
  Stats stats_;
  std::unordered_set<Conn*> conns_;
  struct Awaiting {
    Conn* conn;
    int32_t sid;  // 0 = the h1 request cycle, else an h2 stream
  };
  std::unordered_map<uint64_t, Awaiting> awaiting_;
  // Streaming body inspection (ISSUE 13): flow id (= the plain ring
  // ticket) -> inspecting conn, for bit-63 verdict demux.
  std::unordered_map<uint64_t, Conn*> body_awaiting_;
  std::vector<Conn*> body_expired_;  // sweep_body_deadlines scratch
  // Sidecar supervision state (ISSUE 10, docs/RESILIENCE.md).
  bool degraded_ = false;        // heartbeat stale: bypass the ring
  bool sidecar_seen_ = false;    // a sidecar heartbeat has ever landed
  uint64_t sidecar_epoch_ = 0;   // last epoch read from the ring header
  uint64_t last_deadline_sweep_ms_ = 0;
  std::vector<uint64_t> expired_;  // sweep_verdict_deadlines scratch
  std::vector<SockRef*> doomed_refs_;  // per-stream refs freed after the batch
  std::unordered_map<SSL*, Conn*> ssl_conn_;
  std::vector<Conn*> doomed_;
  time_t now_ = 0;
};

int alpn_select_cb(SSL* ssl, const unsigned char** out, unsigned char* outlen,
                   const unsigned char* in, unsigned int inlen, void* arg);

// ClientHello callback: inspect SNI + ALPN BEFORE any config decision
// (the reference's LazyConfigAcceptor, listeners/mod.rs:112-154).
// acme-tls/1 -> swap in the ephemeral challenge cert for the domain.
int client_hello_cb(SSL* ssl, int* al, void* arg) {
  (void)al;
  TlsStore* store = static_cast<TlsStore*>(arg);
  const unsigned char* ext = nullptr;
  size_t ext_len = 0;
  std::string sni;
  if (SSL_client_hello_get0_ext(ssl, TLSEXT_TYPE_server_name, &ext,
                                &ext_len) == 1)
    sni = parse_sni_ext(ext, ext_len);
  bool acme = false;
  if (SSL_client_hello_get0_ext(ssl, TLSEXT_TYPE_alpn, &ext, &ext_len) == 1)
    acme = alpn_ext_offers(ext, ext_len, "acme-tls/1");

  Conn* c = g_server ? g_server->conn_for_ssl(ssl) : nullptr;
  if (acme && !sni.empty() && !store->alpn_dir.empty()) {
    // Challenge certs are ephemeral files written by the ACME client
    // (host/acme.py); load fresh per handshake.
    std::string cert = store->alpn_dir + "/" + sni + ".pem";
    std::string key = store->alpn_dir + "/" + sni + ".key";
    SSL_CTX* ch = make_server_ctx(cert, key);
    if (ch != nullptr && c != nullptr) {
      c->acme_challenge = true;
      c->owned_ctx = ch;
      // ALPN selection runs against the swapped-in context, which must
      // therefore carry the callback too — RFC 8737 requires acme-tls/1
      // to actually be negotiated, not just tolerated.
      SSL_CTX_set_alpn_select_cb(ch, alpn_select_cb, nullptr);
      SSL_set_SSL_CTX(ssl, ch);
      return SSL_CLIENT_HELLO_SUCCESS;
    }
    if (ch) SSL_CTX_free(ch);
    return SSL_CLIENT_HELLO_ERROR;  // no challenge staged for this name
  }
  SSL_CTX* chosen = store->match(sni);
  if (chosen != nullptr) SSL_set_SSL_CTX(ssl, chosen);
  return SSL_CLIENT_HELLO_SUCCESS;
}

// ALPN negotiation: acme-tls/1 for challenge handshakes (RFC 8737
// REQUIRES the protocol be negotiated), http/1.1 otherwise.
int alpn_select_cb(SSL* ssl, const unsigned char** out, unsigned char* outlen,
                   const unsigned char* in, unsigned int inlen, void* arg) {
  (void)arg;
  Conn* c = g_server ? g_server->conn_for_ssl(ssl) : nullptr;
  bool acme = c != nullptr && c->acme_challenge;
  // Server preference order (the reference's hyper auto builder serves
  // h1+h2, http_listener.rs:276-278); every h2 client still sends the
  // RFC 7540 preface, which is what actually switches the connection.
  const char* prefs_normal[] = {"h2", "http/1.1"};
  const char* prefs_acme[] = {"acme-tls/1"};
  const char** prefs = acme ? prefs_acme : prefs_normal;
  size_t nprefs = acme ? 1 : 2;
  for (size_t p = 0; p < nprefs; ++p) {
    const char* want = prefs[p];
    size_t wlen = strlen(want);
    unsigned int i = 0;
    while (i < inlen) {
      unsigned int n = in[i];
      if (i + 1 + n > inlen) break;
      if (n == wlen && memcmp(in + i + 1, want, n) == 0) {
        *out = in + i + 1;
        *outlen = static_cast<unsigned char>(n);
        return SSL_TLSEXT_ERR_OK;
      }
      i += 1 + n;
    }
  }
  return SSL_TLSEXT_ERR_NOACK;  // no overlap: proceed without ALPN
}

bool parse_hostport(const char* s, sockaddr_in* out) {
  std::string hp = s;
  size_t colon = hp.rfind(':');
  if (colon == std::string::npos) return false;
  std::string host = hp.substr(0, colon);
  std::string port = hp.substr(colon + 1);
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 ||
      res == nullptr)
    return false;
  std::memcpy(out, res->ai_addr, sizeof(*out));
  freeaddrinfo(res);
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s <listen-port> <ring-file> <upstream-host> "
                 "<upstream-port> [--captcha-upstream host:port] "
                 "[--jwks path] [--tls-dir dir] [--alpn-dir dir] "
                 "[--services path] [--bind addr] [--upstream-ca pem] "
                 "[--internal-token-file path] [--tcp-proxy]\n",
                 argv[0]);
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);  // peer resets must not kill the data plane
  int listen_port = std::atoi(argv[1]);
  const char* ring_path = argv[2];
  const char* up_host = argv[3];
  const char* up_port = argv[4];

  const char* jwks_path = nullptr;
  const char* tls_dir = nullptr;
  const char* alpn_dir = nullptr;
  const char* services_path = nullptr;
  const char* bind_addr = nullptr;
  const char* upstream_ca = nullptr;
  const char* internal_token_file = nullptr;
  bool tcp_mode = false;
  sockaddr_in captcha_upstream{};
  bool has_captcha = false;
  for (int i = 5; i < argc; i += 2) {
    if (strcmp(argv[i], "--tcp-proxy") == 0) {
      tcp_mode = true;
      i -= 1;  // flag takes no operand
      continue;
    }
    if (i + 1 >= argc) break;  // every remaining option takes a value
    if (strcmp(argv[i], "--captcha-upstream") == 0) {
      if (!parse_hostport(argv[i + 1], &captcha_upstream)) {
        std::fprintf(stderr, "bad --captcha-upstream\n");
        return 2;
      }
      has_captcha = true;
    } else if (strcmp(argv[i], "--jwks") == 0) {
      jwks_path = argv[i + 1];
    } else if (strcmp(argv[i], "--tls-dir") == 0) {
      tls_dir = argv[i + 1];
    } else if (strcmp(argv[i], "--alpn-dir") == 0) {
      alpn_dir = argv[i + 1];
    } else if (strcmp(argv[i], "--services") == 0) {
      services_path = argv[i + 1];
    } else if (strcmp(argv[i], "--bind") == 0) {
      bind_addr = argv[i + 1];
    } else if (strcmp(argv[i], "--upstream-ca") == 0) {
      upstream_ca = argv[i + 1];
    } else if (strcmp(argv[i], "--internal-token-file") == 0) {
      internal_token_file = argv[i + 1];
    }
  }
  // Per-boot token authenticating this proxy to the loopback control
  // plane (file, not argv: /proc/<pid>/cmdline is world-readable).
  std::string internal_token;
  if (internal_token_file != nullptr) {
    FILE* tf = fopen(internal_token_file, "r");
    if (tf == nullptr) {
      std::fprintf(stderr, "cannot read --internal-token-file %s\n",
                   internal_token_file);
      return 2;
    }
    char tok[256] = {0};
    size_t tn = fread(tok, 1, sizeof(tok) - 1, tf);
    fclose(tf);
    while (tn > 0 && (tok[tn - 1] == '\n' || tok[tn - 1] == '\r' ||
                      tok[tn - 1] == ' '))
      tok[--tn] = '\0';
    internal_token.assign(tok, tn);
  }

  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(up_host, up_port, &hints, &res) != 0 || res == nullptr) {
    std::fprintf(stderr, "cannot resolve upstream %s:%s\n", up_host, up_port);
    return 1;
  }
  sockaddr_in upstream{};
  std::memcpy(&upstream, res->ai_addr, sizeof(upstream));
  freeaddrinfo(res);

  int rfd = open(ring_path, O_RDWR);
  if (rfd < 0) {
    std::perror("open ring");
    return 1;
  }
  struct stat st;
  fstat(rfd, &st);
  void* ring =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, rfd, 0);
  if (ring == MAP_FAILED || pingoo_ring_attach(ring, nullptr) != 0) {
    std::fprintf(stderr, "ring attach failed\n");
    return 1;
  }

  CaptchaGate gate;
  if (jwks_path != nullptr && !gate.load(jwks_path)) {
    std::fprintf(stderr,
                 "warning: JWKS unavailable at %s; all clients treated as "
                 "unverified\n",
                 jwks_path);
  }

  TlsStore tls_store;
  SSL_CTX* base_ctx = nullptr;
  if (tls_dir != nullptr) {
    if (alpn_dir != nullptr) tls_store.alpn_dir = alpn_dir;
    if (!load_tls_store(tls_dir, &tls_store)) {
      std::fprintf(stderr, "no usable certificates in %s\n", tls_dir);
      return 1;
    }
    base_ctx = tls_store.fallback != nullptr
                   ? tls_store.fallback
                   : (!tls_store.exact.empty()
                          ? tls_store.exact.begin()->second
                          : tls_store.wildcard.begin()->second);
    // Install inspection callbacks on every loaded context (the
    // connection's context can be swapped by the client-hello cb).
    auto install = [&](SSL_CTX* ctx) {
      SSL_CTX_set_client_hello_cb(ctx, client_hello_cb, &tls_store);
      SSL_CTX_set_alpn_select_cb(ctx, alpn_select_cb, nullptr);
    };
    if (tls_store.fallback) install(tls_store.fallback);
    for (auto& kv : tls_store.exact) install(kv.second);
    for (auto& kv : tls_store.wildcard) install(kv.second);
  }

  ServiceTable services;
  if (services_path != nullptr) {
    services.path = services_path;
    services.reload();  // absent file is fine: table loads when written
  }

  // Upstream TLS client context: verification is mandatory (the
  // reference's hyper-rustls client has no insecure mode,
  // http_proxy_service.rs:54-71) against either the system roots or an
  // explicit --upstream-ca bundle (private-CA deployments, tests).
  SSL_CTX* up_ctx = SSL_CTX_new(TLS_client_method());
  if (up_ctx != nullptr) {
    SSL_CTX_set_min_proto_version_shim(up_ctx, TLS1_2_VERSION);
    SSL_CTX_set_mode_shim(up_ctx, SSL_MODE_ENABLE_PARTIAL_WRITE |
                                      SSL_MODE_ACCEPT_MOVING_WRITE_BUFFER);
    SSL_CTX_set_verify(up_ctx, SSL_VERIFY_PEER, nullptr);
    int roots_ok;
    if (upstream_ca != nullptr) {
      roots_ok = SSL_CTX_load_verify_locations(up_ctx, upstream_ca, nullptr);
    } else {
      roots_ok = SSL_CTX_set_default_verify_paths(up_ctx);
    }
    if (!roots_ok) {
      std::fprintf(stderr, "cannot load upstream trust roots%s%s\n",
                   upstream_ca ? " from " : "", upstream_ca ? upstream_ca : "");
      return 1;
    }
    static const unsigned char kAlpn[] = "\x08http/1.1";
    SSL_CTX_set_alpn_protos(up_ctx, kAlpn, sizeof(kAlpn) - 1);
  }

  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  setsockopt(lfd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  // Default bind stays loopback (the co-located control-plane shape);
  // --bind makes the native plane the public front door.
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (bind_addr != nullptr &&
      inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) {
    std::fprintf(stderr, "bad --bind address %s\n", bind_addr);
    return 2;
  }
  addr.sin_port = htons(static_cast<uint16_t>(listen_port));
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(lfd, 2048) != 0) {
    std::perror("bind/listen");
    return 1;
  }

  int ep = epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.ptr = nullptr;  // nullptr marks the listening socket
  epoll_ctl(ep, EPOLL_CTL_ADD, lfd, &ev);

  Server server(ep, ring, upstream, has_captcha ? &captcha_upstream : nullptr,
                &gate, tls_dir ? &tls_store : nullptr,
                services_path ? &services : nullptr, up_ctx,
                internal_token, tcp_mode);
  g_server = &server;
  // SIGTERM starts a graceful drain: stop accepting, finish in-flight
  // requests, exit when idle or after the 20 s cap (the reference's
  // drain bound, listeners/mod.rs:28 + http_listener.rs:111-116).
  struct sigaction sa {};
  sa.sa_handler = [](int) { g_sigterm = 1; };
  sigaction(SIGTERM, &sa, nullptr);
  std::printf("{\"listening\": %d, \"tls\": %s, \"services\": %s}\n",
              listen_port, tls_dir ? "true" : "false",
              services_path ? "true" : "false");
  std::fflush(stdout);

  constexpr time_t kDrainCapS = 20;
  bool draining = false;
  time_t drain_start = 0;
  time_t last_sweep = time(nullptr);
  while (true) {
    epoll_event events[256];
    // Busy-poll while requests are awaiting verdicts: the sidecar posts
    // to the shared-memory ring without any fd to wake us, so sleeping
    // the epoll timeout would add up to 1 ms to EVERY verdict. With no
    // verdicts outstanding, 1 ms keeps the idle loop cheap.
    int n = epoll_wait(ep, events, 256,
                       server.awaiting_verdicts() ? 0 : 1);
    time_t now = time(nullptr);
    server.set_now(now);
    server.drain_verdicts();
    // Sidecar supervision (ISSUE 10): heartbeat check (a few shm
    // loads) + ms-granularity verdict deadlines (self-throttled to one
    // pass per ms) run every iteration, so a dead sidecar costs one
    // detection window, not a seconds-long stall.
    server.check_sidecar_liveness();
    server.sweep_verdict_deadlines();

    if (g_sigterm && !draining) {
      draining = true;
      drain_start = now;
      epoll_ctl(ep, EPOLL_CTL_DEL, lfd, nullptr);
      close(lfd);
      lfd = -1;
      std::printf("{\"draining\": true}\n");
      std::fflush(stdout);
      // SIGTERM drain auto-dump (ISSUE 5): the flight recorder lives
      // only in memory; stderr keeps the stdout protocol lines
      // ("draining"/"drained") parseable for the harness scripts.
      std::fprintf(stderr, "%s\n", server.flightrecorder_json().c_str());
      std::fflush(stderr);
    }

    for (int i = 0; i < n; ++i) {
      if (events[i].data.ptr == nullptr) {
        if (lfd < 0) continue;  // stale accept event during drain
        while (true) {
          sockaddr_in peer{};
          socklen_t plen = sizeof(peer);
          int cfd = accept4(lfd, reinterpret_cast<sockaddr*>(&peer), &plen,
                            SOCK_NONBLOCK);
          if (cfd < 0) break;
          int nd = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &nd, sizeof(nd));
          server.add_client(cfd, peer, base_ctx);
        }
        continue;
      }
      SockRef* ref = static_cast<SockRef*>(events[i].data.ptr);
      server.handle(ref, events[i].events);
    }
    server.process_ssl_resume();
    server.flush_doomed();
    if (draining) {
      size_t live = server.drain_tick();
      if (live == 0 || now - drain_start >= kDrainCapS) {
        std::printf("{\"drained\": true, \"remaining\": %zu}\n", live);
        std::fflush(stdout);
        return 0;
      }
    }
    if (now != last_sweep) {
      server.sweep_idle();
      server.sweep_pool();
      server.flush_doomed();
      services.maybe_reload(now);
      last_sweep = now;
    }
  }
  return 0;
}
