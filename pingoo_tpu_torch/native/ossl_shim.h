// Minimal OpenSSL 3 ABI declarations for the native data plane.
//
// This environment ships the OpenSSL 3 RUNTIME (libssl.so.3 /
// libcrypto.so.3) but not the development headers, so the handful of
// functions and constants the TLS transport and JWT verification need
// are declared here against the stable OpenSSL 3.0 ABI (all types are
// opaque pointers; the numeric constants below are fixed ABI values,
// cross-checked against openssl/ssl.h 3.0). Linked with
// -l:libssl.so.3 -l:libcrypto.so.3 (see Makefile).

#ifndef PINGOO_OSSL_SHIM_H_
#define PINGOO_OSSL_SHIM_H_

#include <stddef.h>

extern "C" {

typedef struct ssl_ctx_st SSL_CTX;
typedef struct ssl_st SSL;
typedef struct ssl_method_st SSL_METHOD;
typedef struct evp_pkey_st EVP_PKEY;
typedef struct evp_md_ctx_st EVP_MD_CTX;
typedef struct evp_md_st EVP_MD;
typedef struct engine_st ENGINE;
typedef struct x509_verify_param_st X509_VERIFY_PARAM;

// ---- libssl ----
const SSL_METHOD* TLS_server_method(void);
const SSL_METHOD* TLS_client_method(void);
SSL_CTX* SSL_CTX_new(const SSL_METHOD* method);
void SSL_CTX_free(SSL_CTX* ctx);
int SSL_CTX_use_certificate_chain_file(SSL_CTX* ctx, const char* file);
int SSL_CTX_use_PrivateKey_file(SSL_CTX* ctx, const char* file, int type);
int SSL_CTX_check_private_key(const SSL_CTX* ctx);
long SSL_CTX_ctrl(SSL_CTX* ctx, int cmd, long larg, void* parg);
void SSL_CTX_set_client_hello_cb(SSL_CTX* ctx,
                                 int (*cb)(SSL*, int*, void*), void* arg);
void SSL_CTX_set_alpn_select_cb(
    SSL_CTX* ctx,
    int (*cb)(SSL*, const unsigned char**, unsigned char*,
              const unsigned char*, unsigned int, void*),
    void* arg);

// Client-side (upstream connector) surface: verification policy,
// hostname/IP checks, SNI, ALPN offer, buffered-data probes.
int SSL_CTX_set_default_verify_paths(SSL_CTX* ctx);
int SSL_CTX_load_verify_locations(SSL_CTX* ctx, const char* CAfile,
                                  const char* CApath);
void SSL_CTX_set_verify(SSL_CTX* ctx, int mode,
                        int (*verify_callback)(int, void*));
int SSL_CTX_set_alpn_protos(SSL_CTX* ctx, const unsigned char* protos,
                            unsigned int protos_len);

SSL* SSL_new(SSL_CTX* ctx);
void SSL_free(SSL* ssl);
int SSL_set_fd(SSL* ssl, int fd);
void SSL_set_accept_state(SSL* ssl);
void SSL_set_connect_state(SSL* ssl);
int SSL_set1_host(SSL* ssl, const char* hostname);
long SSL_ctrl(SSL* ssl, int cmd, long larg, void* parg);
long SSL_get_verify_result(const SSL* ssl);
int SSL_peek(SSL* ssl, void* buf, int num);
int SSL_pending(const SSL* ssl);
int SSL_has_pending(const SSL* ssl);
X509_VERIFY_PARAM* SSL_get0_param(SSL* ssl);
int X509_VERIFY_PARAM_set1_ip_asc(X509_VERIFY_PARAM* param,
                                  const char* ipasc);
int SSL_do_handshake(SSL* ssl);
int SSL_read(SSL* ssl, void* buf, int num);
int SSL_write(SSL* ssl, const void* buf, int num);
int SSL_shutdown(SSL* ssl);
int SSL_get_error(const SSL* ssl, int ret);
int SSL_is_init_finished(const SSL* ssl);
SSL_CTX* SSL_set_SSL_CTX(SSL* ssl, SSL_CTX* ctx);
const char* SSL_get_servername(const SSL* ssl, const int type);
int SSL_set_alpn_protos(SSL* ssl, const unsigned char* protos,
                        unsigned int protos_len);
void SSL_get0_alpn_selected(const SSL* ssl, const unsigned char** data,
                            unsigned int* len);
int SSL_client_hello_get0_ext(SSL* ssl, unsigned int type,
                              const unsigned char** out, size_t* outlen);
unsigned long ERR_get_error(void);
void ERR_clear_error(void);

#define SSL_FILETYPE_PEM 1
#define SSL_ERROR_NONE 0
#define SSL_ERROR_SSL 1
#define SSL_ERROR_WANT_READ 2
#define SSL_ERROR_WANT_WRITE 3
#define SSL_ERROR_SYSCALL 5
#define SSL_ERROR_ZERO_RETURN 6
#define SSL_CTRL_SET_MIN_PROTO_VERSION 123
#define SSL_CTRL_SET_TLSEXT_HOSTNAME 55
#define SSL_CTRL_MODE 33
#define SSL_MODE_ENABLE_PARTIAL_WRITE 0x1L
#define SSL_MODE_ACCEPT_MOVING_WRITE_BUFFER 0x2L
#define SSL_VERIFY_NONE 0
#define SSL_VERIFY_PEER 1
#define X509_V_OK 0
#define TLS1_2_VERSION 0x0303
#define TLS1_3_VERSION 0x0304
#define TLSEXT_NAMETYPE_host_name 0
#define TLSEXT_TYPE_server_name 0
#define TLSEXT_TYPE_alpn 16
#define SSL_TLSEXT_ERR_OK 0
#define SSL_TLSEXT_ERR_ALERT_FATAL 2
#define SSL_TLSEXT_ERR_NOACK 3
#define SSL_CLIENT_HELLO_SUCCESS 1
#define SSL_CLIENT_HELLO_ERROR 0

static inline long SSL_CTX_set_min_proto_version_shim(SSL_CTX* ctx, int ver) {
  return SSL_CTX_ctrl(ctx, SSL_CTRL_SET_MIN_PROTO_VERSION, ver, nullptr);
}

static inline long SSL_set_tlsext_host_name_shim(SSL* ssl, const char* name) {
  return SSL_ctrl(ssl, SSL_CTRL_SET_TLSEXT_HOSTNAME, TLSEXT_NAMETYPE_host_name,
                  const_cast<char*>(name));
}

static inline long SSL_CTX_set_mode_shim(SSL_CTX* ctx, long mode) {
  return SSL_CTX_ctrl(ctx, SSL_CTRL_MODE, mode, nullptr);
}

// ---- libcrypto ----
int EVP_Digest(const void* data, size_t count, unsigned char* md,
               unsigned int* size, const EVP_MD* type, ENGINE* impl);
const EVP_MD* EVP_sha256(void);

EVP_PKEY* EVP_PKEY_new_raw_public_key(int type, ENGINE* e,
                                      const unsigned char* key, size_t keylen);
void EVP_PKEY_free(EVP_PKEY* pkey);
EVP_MD_CTX* EVP_MD_CTX_new(void);
void EVP_MD_CTX_free(EVP_MD_CTX* ctx);
int EVP_DigestVerifyInit(EVP_MD_CTX* ctx, void** pctx, const EVP_MD* type,
                         ENGINE* e, EVP_PKEY* pkey);
int EVP_DigestVerify(EVP_MD_CTX* ctx, const unsigned char* sig, size_t siglen,
                     const unsigned char* tbs, size_t tbslen);
int CRYPTO_memcmp(const void* a, const void* b, size_t len);

#define EVP_PKEY_ED25519 1087

}  // extern "C"

#endif  // PINGOO_OSSL_SHIM_H_
