// Minimal nghttp2 ABI declarations for the native data plane's HTTP/2
// support. Same situation as ossl_shim.h: the environment ships the
// runtime library (libnghttp2.so.14) but no development headers, so the
// handful of functions/structs used are declared here against the
// stable nghttp2 ABI (cross-checked with the Python ctypes binding in
// host/h2.py, which exercises the same surface). Linked with
// -l:libnghttp2.so.14.

#ifndef PINGOO_NGHTTP2_SHIM_H_
#define PINGOO_NGHTTP2_SHIM_H_

#include <stddef.h>
#include <stdint.h>
#include <sys/types.h>

extern "C" {

typedef struct nghttp2_session nghttp2_session;
typedef struct nghttp2_session_callbacks nghttp2_session_callbacks;

typedef struct {
  uint8_t* name;
  uint8_t* value;
  size_t namelen;
  size_t valuelen;
  uint8_t flags;
} nghttp2_nv;

// Every member of the nghttp2_frame union begins with this header.
typedef struct {
  size_t length;
  int32_t stream_id;
  uint8_t type;
  uint8_t flags;
  uint8_t reserved;
} nghttp2_frame_hd;

typedef union {
  int fd;
  void* ptr;
} nghttp2_data_source;

typedef ssize_t (*nghttp2_data_source_read_callback)(
    nghttp2_session* session, int32_t stream_id, uint8_t* buf, size_t length,
    uint32_t* data_flags, nghttp2_data_source* source, void* user_data);

typedef struct {
  nghttp2_data_source source;
  nghttp2_data_source_read_callback read_callback;
} nghttp2_data_provider;

#define NGHTTP2_NV_FLAG_NONE 0
#define NGHTTP2_FLAG_NONE 0
#define NGHTTP2_FLAG_END_STREAM 0x1
#define NGHTTP2_FRAME_DATA 0
#define NGHTTP2_FRAME_HEADERS 1
#define NGHTTP2_DATA_FLAG_EOF 0x1
#define NGHTTP2_ERR_CALLBACK_FAILURE -902
#define NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS 3
#define NGHTTP2_INTERNAL_ERROR 2
#define NGHTTP2_FLAG_END_HEADERS 0x4
#define NGHTTP2_FRAME_GOAWAY 7
#define NGHTTP2_ERR_DEFERRED -508

typedef struct {
  int32_t settings_id;
  uint32_t value;
} nghttp2_settings_entry;

typedef int (*on_header_cb)(nghttp2_session*, const void* frame,
                            const uint8_t* name, size_t namelen,
                            const uint8_t* value, size_t valuelen,
                            uint8_t flags, void* user_data);
typedef int (*on_frame_recv_cb)(nghttp2_session*, const void* frame,
                                void* user_data);
typedef int (*on_data_chunk_cb)(nghttp2_session*, uint8_t flags,
                                int32_t stream_id, const uint8_t* data,
                                size_t len, void* user_data);
typedef int (*on_stream_close_cb)(nghttp2_session*, int32_t stream_id,
                                  uint32_t error_code, void* user_data);

int nghttp2_session_callbacks_new(nghttp2_session_callbacks** out);
void nghttp2_session_callbacks_del(nghttp2_session_callbacks* cbs);
void nghttp2_session_callbacks_set_on_header_callback(
    nghttp2_session_callbacks*, on_header_cb);
void nghttp2_session_callbacks_set_on_frame_recv_callback(
    nghttp2_session_callbacks*, on_frame_recv_cb);
void nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
    nghttp2_session_callbacks*, on_data_chunk_cb);
void nghttp2_session_callbacks_set_on_stream_close_callback(
    nghttp2_session_callbacks*, on_stream_close_cb);

int nghttp2_session_client_new(nghttp2_session** out,
                               const nghttp2_session_callbacks* cbs,
                               void* user_data);
int nghttp2_submit_request(nghttp2_session* session, const void* pri_spec,
                           const nghttp2_nv* nva, size_t nvlen,
                           const nghttp2_data_provider* data_prd,
                           void* stream_user_data);
typedef struct nghttp2_option nghttp2_option;
int nghttp2_option_new(nghttp2_option** out);
void nghttp2_option_del(nghttp2_option* opt);
void nghttp2_option_set_no_auto_window_update(nghttp2_option* opt, int val);
int nghttp2_session_server_new2(nghttp2_session** out,
                                const nghttp2_session_callbacks* cbs,
                                void* user_data,
                                const nghttp2_option* opt);
int nghttp2_session_consume(nghttp2_session* session, int32_t stream_id,
                            size_t size);
int nghttp2_session_set_local_window_size(nghttp2_session* session,
                                          uint8_t flags, int32_t stream_id,
                                          int32_t window_size);
int nghttp2_session_consume_connection(nghttp2_session* session,
                                       size_t size);
int nghttp2_session_server_new(nghttp2_session** out,
                               const nghttp2_session_callbacks* cbs,
                               void* user_data);
void nghttp2_session_del(nghttp2_session* session);
ssize_t nghttp2_session_mem_recv(nghttp2_session* session, const uint8_t* in,
                                 size_t inlen);
ssize_t nghttp2_session_mem_send(nghttp2_session* session,
                                 const uint8_t** out);
int nghttp2_submit_settings(nghttp2_session* session, uint8_t flags,
                            const void* iv, size_t niv);
int nghttp2_submit_response(nghttp2_session* session, int32_t stream_id,
                            const nghttp2_nv* nva, size_t nvlen,
                            const nghttp2_data_provider* data_prd);
// pri_spec declared as const void*: we only ever pass NULL, so the
// struct layout never matters on this side of the ABI.
int nghttp2_submit_headers(nghttp2_session* session, uint8_t flags,
                           int32_t stream_id, const void* pri_spec,
                           const nghttp2_nv* nva, size_t nvlen,
                           void* stream_user_data);
int nghttp2_submit_rst_stream(nghttp2_session* session, uint8_t flags,
                              int32_t stream_id, uint32_t error_code);
int nghttp2_session_resume_data(nghttp2_session* session, int32_t stream_id);
int nghttp2_session_want_read(nghttp2_session* session);
int nghttp2_session_want_write(nghttp2_session* session);

}  // extern "C"

#endif  // PINGOO_NGHTTP2_SHIM_H_
