// -- upstream HTTP/2 link ----------------------------------------------------
// The reference's pooled hyper client speaks h2 to upstreams — via ALPN
// on TLS hops or cleartext prior knowledge for h2:// targets
// (http_proxy_service.rs:54-71). This bridge keeps the rest of the
// proxy h1-shaped: the request side parses the ALREADY-REWRITTEN h1
// head (rewrite_request_head / h2_upstream_head output) into h2
// frames, and the response side synthesizes well-formed h1 bytes from
// the h2 response, which the existing RespHead/BodyFramer machinery
// consumes unchanged on both downstream paths.

#ifndef PINGOO_UP_H2_LINK_H_
#define PINGOO_UP_H2_LINK_H_

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

#include "nghttp2_shim.h"

struct UpH2Link {
  nghttp2_session* sess = nullptr;
  int32_t sid = -1;
  std::string body;  // de-framed request body pending DATA frames
  bool body_eof = false;
  bool data_deferred = false;
  int status = 0;
  std::vector<std::pair<std::string, std::string>> resp_headers;
  // Response TRAILERS (a HEADERS frame after the head): forwarded as h1
  // chunked trailers after the 0-chunk — gRPC's grpc-status/-message
  // live there and must survive the h2->h1 bridge.
  std::vector<std::pair<std::string, std::string>> resp_trailers;
  bool resp_headers_done = false;
  bool resp_done = false;  // END_STREAM seen
  bool failed = false;     // stream/session error: caller 502s/aborts
  bool goaway = false;     // session not reusable after this response
  bool head_emitted = false;
  bool chunked_out = false;
  std::string synth;  // synthesized h1 response bytes

  ~UpH2Link() {
    if (sess != nullptr) nghttp2_session_del(sess);
  }

  static ssize_t read_body(nghttp2_session*, int32_t, uint8_t* buf,
                           size_t length, uint32_t* data_flags,
                           nghttp2_data_source* source, void*) {
    UpH2Link* l = static_cast<UpH2Link*>(source->ptr);
    if (l->body.empty()) {
      if (l->body_eof) {
        *data_flags = NGHTTP2_DATA_FLAG_EOF;
        return 0;
      }
      l->data_deferred = true;
      return NGHTTP2_ERR_DEFERRED;
    }
    size_t n = l->body.size() < length ? l->body.size() : length;
    memcpy(buf, l->body.data(), n);
    l->body.erase(0, n);
    return static_cast<ssize_t>(n);
  }

  static int on_header(nghttp2_session*, const void* frame,
                       const uint8_t* name, size_t namelen,
                       const uint8_t* value, size_t valuelen, uint8_t,
                       void* user_data) {
    UpH2Link* l = static_cast<UpH2Link*>(user_data);
    const auto* hd = static_cast<const nghttp2_frame_hd*>(frame);
    if (hd->type != NGHTTP2_FRAME_HEADERS || hd->stream_id != l->sid)
      return 0;
    std::string n(reinterpret_cast<const char*>(name), namelen);
    std::string v(reinterpret_cast<const char*>(value), valuelen);
    if (l->head_emitted) {
      // A HEADERS frame after the emitted head is the trailer section.
      if (!n.empty() && n[0] != ':')
        l->resp_trailers.emplace_back(std::move(n), std::move(v));
      return 0;
    }
    if (n == ":status") {
      l->status = atoi(v.c_str());
    } else if (!n.empty() && n[0] != ':') {
      l->resp_headers.emplace_back(std::move(n), std::move(v));
    }
    return 0;
  }

  void emit_head(bool end_stream) {
    // Interim (1xx) responses re-arm for the final head; the existing
    // h1 response parser relays them the same way it does for h1
    // upstreams.
    bool interim = status >= 100 && status < 200;
    synth += "HTTP/1.1 " + std::to_string(status) + " \r\n";
    bool have_cl = false;
    for (const auto& kv : resp_headers) {
      // h2 carries no connection-specific headers, but defensively
      // skip any the peer smuggled (they would corrupt h1 framing).
      if (kv.first == "connection" || kv.first == "transfer-encoding" ||
          kv.first == "keep-alive" || kv.first == "upgrade")
        continue;
      if (kv.first == "content-length") have_cl = true;
      synth += kv.first + ": " + kv.second + "\r\n";
    }
    if (!interim) {
      if (end_stream && !have_cl) {
        synth += "content-length: 0\r\n";
      } else if (!have_cl) {
        chunked_out = true;
        synth += "transfer-encoding: chunked\r\n";
      }
    }
    synth += "\r\n";
    if (interim) {
      status = 0;
      resp_headers.clear();
    } else {
      head_emitted = true;
      resp_headers_done = true;
    }
  }

  static int on_frame_recv(nghttp2_session*, const void* frame,
                           void* user_data) {
    UpH2Link* l = static_cast<UpH2Link*>(user_data);
    const auto* hd = static_cast<const nghttp2_frame_hd*>(frame);
    if (hd->type == NGHTTP2_FRAME_GOAWAY) {
      l->goaway = true;
      return 0;
    }
    if (hd->stream_id != l->sid) return 0;
    bool end_stream = (hd->flags & NGHTTP2_FLAG_END_STREAM) != 0;
    if (hd->type == NGHTTP2_FRAME_HEADERS && !l->head_emitted &&
        (hd->flags & NGHTTP2_FLAG_END_HEADERS) != 0) {
      l->emit_head(end_stream);
    }
    if (end_stream && l->head_emitted && !l->resp_done) {
      if (l->chunked_out) {
        // h1 chunked framing carries trailers between the 0-chunk and
        // the final CRLF; the downstream h1 relay passes the raw bytes
        // through, and the BodyFramer's kTrailer state consumes them
        // where the body is de-chunked (h2 downstream re-framing drops
        // them — recorded in COMPONENTS.md Known deltas).
        l->synth += "0\r\n";
        for (const auto& kv : l->resp_trailers)
          l->synth += kv.first + ": " + kv.second + "\r\n";
        l->synth += "\r\n";
      }
      l->resp_done = true;
    }
    return 0;
  }

  static int on_data_chunk(nghttp2_session*, uint8_t, int32_t stream_id,
                           const uint8_t* data, size_t len,
                           void* user_data) {
    UpH2Link* l = static_cast<UpH2Link*>(user_data);
    if (stream_id != l->sid || !l->head_emitted) return 0;
    if (l->chunked_out) {
      char sz[32];
      snprintf(sz, sizeof(sz), "%zx\r\n", len);
      l->synth += sz;
      l->synth.append(reinterpret_cast<const char*>(data), len);
      l->synth += "\r\n";
    } else {
      l->synth.append(reinterpret_cast<const char*>(data), len);
    }
    return 0;
  }

  static int on_stream_close(nghttp2_session*, int32_t stream_id,
                             uint32_t error_code, void* user_data) {
    UpH2Link* l = static_cast<UpH2Link*>(user_data);
    if (stream_id != l->sid) return 0;
    if (error_code != 0 || !l->resp_done) l->failed = true;
    return 0;
  }

  bool init() {
    nghttp2_session_callbacks* cbs = nullptr;
    if (nghttp2_session_callbacks_new(&cbs) != 0) return false;
    nghttp2_session_callbacks_set_on_header_callback(cbs, on_header);
    nghttp2_session_callbacks_set_on_frame_recv_callback(cbs,
                                                         on_frame_recv);
    nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
        cbs, on_data_chunk);
    nghttp2_session_callbacks_set_on_stream_close_callback(
        cbs, on_stream_close);
    int rv = nghttp2_session_client_new(&sess, cbs, this);
    nghttp2_session_callbacks_del(cbs);
    if (rv != 0) return false;
    nghttp2_settings_entry iv[] = {
        {NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 64}};
    return nghttp2_submit_settings(sess, 0, iv, 1) == 0;
  }

  // Re-arm per-request state for a POOLED session's next request.
  void reset_for_reuse() {
    sid = -1;
    body.clear();
    body_eof = false;
    data_deferred = false;
    status = 0;
    resp_headers.clear();
    resp_trailers.clear();
    resp_headers_done = false;
    resp_done = false;
    head_emitted = false;
    chunked_out = false;
    synth.clear();
  }

  // Parse the proxy's own rewritten h1 request head (well-formed by
  // construction) into an h2 request. `tls` picks :scheme.
  bool submit(const std::string& h1_head, bool tls, bool has_body) {
    size_t line_end = h1_head.find("\r\n");
    if (line_end == std::string::npos) return false;
    std::string first = h1_head.substr(0, line_end);
    size_t sp1 = first.find(' ');
    size_t sp2 = first.rfind(' ');
    if (sp1 == std::string::npos || sp2 <= sp1) return false;
    std::string method = first.substr(0, sp1);
    std::string target = first.substr(sp1 + 1, sp2 - sp1 - 1);
    std::string scheme = tls ? "https" : "http";
    std::string authority;
    std::vector<std::pair<std::string, std::string>> hdrs;
    size_t pos = line_end + 2;
    while (pos < h1_head.size()) {
      size_t eol = h1_head.find("\r\n", pos);
      if (eol == std::string::npos || eol == pos) break;
      size_t colon = h1_head.find(':', pos);
      if (colon == std::string::npos || colon >= eol) return false;
      std::string nm = h1_head.substr(pos, colon - pos);
      for (auto& ch : nm)
        ch = static_cast<char>(tolower(static_cast<unsigned char>(ch)));
      size_t vs = colon + 1;
      while (vs < eol && h1_head[vs] == ' ') vs++;
      std::string val = h1_head.substr(vs, eol - vs);
      pos = eol + 2;
      if (nm == "host") {
        authority = val;
        continue;
      }
      // connection-specific headers are forbidden on h2
      if (nm == "connection" || nm == "keep-alive" ||
          nm == "transfer-encoding" || nm == "upgrade" || nm == "te")
        continue;
      hdrs.emplace_back(std::move(nm), std::move(val));
    }
    std::vector<nghttp2_nv> nva;
    auto nv = [&](const std::string& n, const std::string& v) {
      nghttp2_nv e;
      e.name = reinterpret_cast<uint8_t*>(const_cast<char*>(n.data()));
      e.namelen = n.size();
      e.value = reinterpret_cast<uint8_t*>(const_cast<char*>(v.data()));
      e.valuelen = v.size();
      e.flags = NGHTTP2_NV_FLAG_NONE;
      nva.push_back(e);
    };
    static const std::string kM = ":method", kP = ":path", kS = ":scheme",
                             kA = ":authority";
    nv(kM, method);
    nv(kS, scheme);
    if (!authority.empty()) nv(kA, authority);
    nv(kP, target);
    for (const auto& kv : hdrs) nv(kv.first, kv.second);
    nghttp2_data_provider prd{};
    prd.source.ptr = this;
    prd.read_callback = read_body;
    sid = nghttp2_submit_request(sess, nullptr, nva.data(), nva.size(),
                                 has_body ? &prd : nullptr, nullptr);
    return sid > 0;
  }

  void append_body(const char* d, size_t n) {
    body.append(d, n);
    if (data_deferred && sess != nullptr && sid > 0) {
      data_deferred = false;
      nghttp2_session_resume_data(sess, sid);
    }
  }

  void finish_body() {
    body_eof = true;
    if (data_deferred && sess != nullptr && sid > 0) {
      data_deferred = false;
      nghttp2_session_resume_data(sess, sid);
    }
  }

  // Frames the session wants on the wire -> append to *out.
  bool pump_send(std::string* out) {
    for (;;) {
      const uint8_t* data = nullptr;
      ssize_t n = nghttp2_session_mem_send(sess, &data);
      if (n < 0) return false;
      if (n == 0) return true;
      out->append(reinterpret_cast<const char*>(data),
                  static_cast<size_t>(n));
    }
  }

  // Bytes off the wire -> synthesized h1 into *out. False on fatal.
  bool feed(const char* d, size_t n, std::string* out) {
    ssize_t rv = nghttp2_session_mem_recv(
        sess, reinterpret_cast<const uint8_t*>(d), n);
    if (rv < 0 || static_cast<size_t>(rv) != n) return false;
    if (!synth.empty()) {
      out->append(synth);
      synth.clear();
    }
    return !failed;
  }
};

#endif  // PINGOO_UP_H2_LINK_H_
