// Shared-memory verdict ring: the host-data-plane <-> TPU-sidecar
// transport (SURVEY.md §7 architecture split item 4: "lock-free
// shared-memory ring (fixed-size slots mirroring RequestData/ClientData,
// pingoo/rules.rs:17-34) ... batching window tuned against the 2ms p99
// budget; verdict bitmap return").
//
// Layout: one file mapping = [RingHeader][request slots][verdict slots].
// Both rings are Vyukov bounded MPMC queues (per-slot sequence numbers),
// so any number of data-plane threads can enqueue requests while the
// sidecar drains batches, and verdicts flow back keyed by ticket id.
//
// The slot field layout mirrors pingoo_tpu/engine/batch.py field specs
// (method 16 / host 256 / path 2048 / url 2048 / user_agent 256 bytes,
// v6-mapped ip words, asn/port columns) so the Python side can decode a
// whole batch with one numpy structured view, no per-field parsing.
// A request whose field exceeded its cap at enqueue time carries
// PINGOO_SLOT_FLAG_TRUNCATED, and — for path/url — its FULL strings in
// a claimed spill slot (v3): the sidecar re-evaluates such rows over
// the untruncated bytes (native_ring.RingSidecar), mirroring the
// Python listener's overflow re-evaluation (engine/service.py). Only
// when the spill pool is exhausted does a row fall back to slot-view
// matching (still counted via truncated_rows).

#ifndef PINGOO_RING_H_
#define PINGOO_RING_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
#define PINGOO_ALIGN8 alignas(8)
#define PINGOO_ALIGN64 alignas(64)
#else
#define PINGOO_ALIGN8 _Alignas(8)
#define PINGOO_ALIGN64 _Alignas(64)
#endif

#ifdef __cplusplus
extern "C" {
#endif

#define PINGOO_RING_MAGIC 0x50474f52u  // "PGOR"
// v4: slot carries enq_ms (monotonic enqueue timestamp) and the header
// grows an atomic telemetry block (ISSUE 2 observability).
// v5: the header grows a liveness block (ISSUE 10 sidecar supervision):
// sidecar_epoch (monotonically bumped on every sidecar attach, so the
// data plane can tell a restart from a stall), sidecar_heartbeat_ms
// (stamped by the sidecar each poll cycle; the httpd event loop flips
// into the degraded fast-path when it goes stale past
// PINGOO_SIDECAR_TIMEOUT_MS), and posted_floor (all tickets below it
// have verdicts posted — the crash-reattach reconciliation scans
// [posted_floor, req_tail) for orphans).
// v6: body-window ring (ISSUE 13 streaming body inspection). A third
// Vyukov ring of fixed-count bounded slots carries de-framed request
// body bytes as (flow ticket, win_seq, FINAL/ABORT flags) windows from
// the data plane to the sidecar; body verdicts ride the EXISTING
// verdict ring with PINGOO_BODY_VERDICT_BIT set in the ticket. The
// header gains body_slot_size/body_capacity up front and a
// body_head/body_tail cache-line pair at the end.
#define PINGOO_RING_VERSION 6u

#define PINGOO_METHOD_CAP 16
#define PINGOO_HOST_CAP 256
#define PINGOO_PATH_CAP 2048
#define PINGOO_URL_CAP 2048
#define PINGOO_UA_CAP 256

#define PINGOO_SLOT_FLAG_TRUNCATED 0x1u

// Overflow spill: a request whose path/url exceeds the fixed slot caps
// claims one spill slot and carries its FULL strings there, so the
// consumer can evaluate flagged rows over untruncated bytes — matching
// the reference, which matches full strings (http_listener.rs:140-141).
// 64 KiB covers both strings at the data plane's 32 KiB head cap.
// spill_idx == PINGOO_SPILL_NONE means no spill (not truncated, or the
// spill area was exhausted — then the row is matched on the slot view
// and only counted, the pre-v3 behavior).
#define PINGOO_SPILL_SLOTS 64u
#define PINGOO_SPILL_DATA_CAP 65536u
#define PINGOO_SPILL_NONE 0xFFu

typedef struct {
  PINGOO_ALIGN8 uint64_t state;  // 0 free / 1 claimed (CAS by producers)
  uint32_t url_len;
  uint32_t path_len;
  char data[PINGOO_SPILL_DATA_CAP];  // url bytes then path bytes
} PingooSpillSlot;

// Body-window ring (v6, ISSUE 13): the data plane streams each request
// body as bounded windows of DE-FRAMED payload bytes (chunked TE
// already decoded) tagged with the owning request ticket and a per-flow
// sequence number, so the sidecar threads NFA/DFA carry state across
// windows (engine/bodyscan.py) and a payload split across DATA frames
// matches bit-identically to the contiguous scan. Fixed slot count —
// independent of the request-ring capacity — bounds the in-flight body
// bytes at PINGOO_BODY_SLOTS * PINGOO_BODY_WINDOW_CAP = 1 MiB.
#define PINGOO_BODY_SLOTS 256u
#define PINGOO_BODY_WINDOW_CAP 4096u
#define PINGOO_BODY_FLAG_FINAL 0x1u  // last window of the flow
#define PINGOO_BODY_FLAG_ABORT 0x2u  // flow died (client reset): drop state
// Body verdicts share the verdict ring: the sidecar posts them with
// this bit set in the ticket so the data plane demuxes meta vs body
// verdicts without a second return ring.
#define PINGOO_BODY_VERDICT_BIT 0x8000000000000000ull

typedef struct {
  PINGOO_ALIGN8 uint64_t seq;  // Vyukov slot sequence
  uint64_t flow;               // request ticket that owns this body
  uint32_t win_seq;            // 0-based window index within the flow
  uint32_t win_len;            // payload bytes in data[]
  uint64_t total_len;          // body bytes up to + including this window
  uint8_t flags;               // PINGOO_BODY_FLAG_*
  uint8_t _pad[7];
  char data[PINGOO_BODY_WINDOW_CAP];
} PingooBodySlot;

typedef struct {
  // Vyukov slot sequence: slot is writable when seq == pos, readable
  // when seq == pos + 1.
  PINGOO_ALIGN8 uint64_t seq;
  uint64_t ticket;  // request id chosen by the producer
  uint64_t enq_ms;  // CLOCK_MONOTONIC ms at enqueue (set by the ring);
                    // consumers feed it back via pingoo_ring_record_waits
                    // so the telemetry block's verdict-wait histogram
                    // measures enqueue -> verdict-post per request
  uint16_t method_len, host_len, path_len, url_len, ua_len;
  uint16_t remote_port;
  uint8_t ip[16];  // big-endian, v4 addresses v6-mapped (::ffff:a.b.c.d)
  uint32_t asn;
  char country[2];
  uint8_t flags;      // PINGOO_SLOT_FLAG_* (set by enqueue)
  uint8_t spill_idx;  // PINGOO_SPILL_NONE or the claimed spill slot
  char method[PINGOO_METHOD_CAP];
  char host[PINGOO_HOST_CAP];
  char path[PINGOO_PATH_CAP];
  char url[PINGOO_URL_CAP];
  char user_agent[PINGOO_UA_CAP];
} PingooRequestSlot;

typedef struct {
  PINGOO_ALIGN8 uint64_t seq;
  uint64_t ticket;
  // Two-lane encoding (the reference action loop diverges per client
  // captcha state, http_listener.rs:251-264): bits 0-1 = action for an
  // UNVERIFIED client (0 none, 1 block, 2 captcha); bit 2 = a VERIFIED
  // client must be blocked. Consumers mask: (action & 3) / (action & 4).
  uint8_t action;
  uint8_t _pad[3];
  float bot_score;
} PingooVerdictSlot;

// Verdict-wait histogram bucket upper bounds (ms); the last bucket is
// +inf. Shared with both planes' Prometheus exposition
// (pingoo_verdict_wait_ms, pingoo_tpu/obs/schema.py).
#define PINGOO_WAIT_BUCKETS 8u
// bounds: 1, 2, 5, 10, 50, 100, 1000, +inf

// Atomic telemetry block inside the shared header (v4): counters the
// producers/consumers maintain with relaxed fetch-adds so queue health
// (depth high-water mark, full-ring stalls, enqueue->verdict-post wait)
// is visible to BOTH planes' /__pingoo/metrics scrape without any
// side-channel. All fields monotonic except depth (derived).
typedef struct {
  PINGOO_ALIGN64 uint64_t enqueued;     // request slots enqueued
  uint64_t enqueue_full;                // enqueues refused: request ring full
  uint64_t dequeued;                    // request slots dequeued
  uint64_t depth_hwm;                   // high-water mark of queued requests
  uint64_t verdicts_posted;             // verdict slots posted
  uint64_t verdict_post_full;           // posts refused: verdict ring full
  uint64_t wait_sum_ms;                 // sum of recorded waits (ms)
  uint64_t wait_hist[PINGOO_WAIT_BUCKETS];  // enqueue -> verdict-post
} PingooRingTelemetry;

// Flat snapshot order for pingoo_ring_telemetry_snapshot (one uint64
// array keeps the ctypes binding to a single pointer): enqueued,
// enqueue_full, dequeued, depth (head - tail, sampled now), depth_hwm,
// verdicts_posted, verdict_post_full, wait_sum_ms, wait_hist[8].
#define PINGOO_TELEMETRY_WORDS (8u + PINGOO_WAIT_BUCKETS)

typedef struct {
  uint32_t magic;
  uint32_t version;
  uint32_t capacity;  // power of two, same for request+verdict rings
  uint32_t request_slot_size;
  uint32_t verdict_slot_size;
  uint32_t body_slot_size;  // sizeof(PingooBodySlot) (v6)
  uint32_t body_capacity;   // PINGOO_BODY_SLOTS (v6)
  PINGOO_ALIGN64 uint64_t req_head;  // producer ticket counter
  PINGOO_ALIGN64 uint64_t req_tail;  // consumer counter
  PINGOO_ALIGN64 uint64_t ver_head;
  PINGOO_ALIGN64 uint64_t ver_tail;
  PINGOO_ALIGN64 PingooRingTelemetry telemetry;
  // Liveness block (v5, ISSUE 10): its own cache line so heartbeat
  // stores never contend with the head/tail CAS lines.
  PINGOO_ALIGN64 uint64_t sidecar_epoch;   // bumped on sidecar attach
  uint64_t sidecar_heartbeat_ms;           // pingoo_ring_now_ms stamp
  uint64_t posted_floor;                   // tickets < floor have verdicts
  // Body-window ring counters (v6): their own cache lines, same
  // single-producer/single-consumer contention split as req/ver.
  PINGOO_ALIGN64 uint64_t body_head;
  PINGOO_ALIGN64 uint64_t body_tail;
} PingooRingHeader;

// Size of the full mapping for a given capacity.
size_t pingoo_ring_bytes(uint32_t capacity);

// Initialize a fresh ring inside `mem` (caller maps the file/shm).
void pingoo_ring_init(void* mem, uint32_t capacity);

// Validate an existing mapping; returns 0 on success.
int pingoo_ring_attach(void* mem, uint32_t* capacity_out);

// Enqueue one request; returns the ticket id, or UINT64_MAX if full.
uint64_t pingoo_ring_enqueue_request(
    void* mem, const char* method, uint32_t method_len, const char* host,
    uint32_t host_len, const char* path, uint32_t path_len, const char* url,
    uint32_t url_len, const char* ua, uint32_t ua_len, const uint8_t ip[16],
    uint16_t remote_port, uint32_t asn, const char country[2]);

// Dequeue up to `max` requests into `out`; returns the count.
uint32_t pingoo_ring_dequeue_requests(void* mem, PingooRequestSlot* out,
                                      uint32_t max);

// Post a verdict; returns 0 on success, -1 if the verdict ring is full.
int pingoo_ring_post_verdict(void* mem, uint64_t ticket, uint8_t action,
                             float bot_score);

// Post a batch of verdicts in one call (one ctypes/FFI hop for the
// Python sidecar instead of one per ticket); returns how many were
// posted — fewer than `n` only when the verdict ring filled up, in
// which case the caller retries from that index.
uint32_t pingoo_ring_post_verdicts(void* mem, const uint64_t* tickets,
                                   const uint8_t* actions, uint32_t n);

// Poll one verdict; returns 0 on success, -1 if empty.
int pingoo_ring_poll_verdict(void* mem, uint64_t* ticket_out,
                             uint8_t* action_out, float* score_out);

// Enqueue one body window (v6). `len` must be <= PINGOO_BODY_WINDOW_CAP
// (-2 otherwise); returns 0 on success, -1 when the body ring is full —
// the producer then fails the flow open to metadata-only verdicts
// rather than stalling the event loop.
int pingoo_ring_enqueue_body(void* mem, uint64_t flow, uint32_t win_seq,
                             uint64_t total_len, const char* data,
                             uint32_t len, uint8_t flags);

// Dequeue up to `max` body windows into `out`; returns the count.
uint32_t pingoo_ring_dequeue_bodies(void* mem, PingooBodySlot* out,
                                    uint32_t max);

// Read a claimed spill slot's full strings. Returns 0 on success and
// fills the pointers/lengths (data stays valid until release).
int pingoo_ring_spill_read(void* mem, uint8_t idx, const char** url,
                           uint32_t* url_len, const char** path,
                           uint32_t* path_len);

// Release a spill slot back to the free pool (consumer side, after the
// row's verdict was computed over the untruncated strings).
void pingoo_ring_spill_release(void* mem, uint8_t idx);

// Copy the telemetry block into out[PINGOO_TELEMETRY_WORDS] (flat
// order documented at PINGOO_TELEMETRY_WORDS above). Relaxed loads:
// a scrape-time snapshot, not a linearization point.
void pingoo_ring_telemetry_snapshot(void* mem, uint64_t* out);

// Record n enqueue->now waits into the telemetry wait histogram; the
// consumer passes the dequeued slots' enq_ms values at verdict-post
// time (one FFI hop per batch for the Python sidecar).
void pingoo_ring_record_waits(void* mem, const uint64_t* enq_ms,
                              uint32_t n);

// CLOCK_MONOTONIC milliseconds — the enq_ms time base, exported so
// out-of-process consumers compute waits against the same clock.
uint64_t pingoo_ring_now_ms(void);

// -- Liveness / supervision protocol (v5, ISSUE 10) --------------------------

// Sidecar attach: bump the epoch (release), stamp the first heartbeat,
// and return the NEW epoch. Called once per sidecar boot/reattach; a
// data plane observing the epoch change knows the previous consumer is
// gone and any reconciliation is the new epoch's responsibility.
uint64_t pingoo_ring_sidecar_attach(void* mem);

// Stamp the heartbeat with pingoo_ring_now_ms() (relaxed store; the
// sidecar calls this every poll cycle — staleness, not ordering, is
// the signal).
void pingoo_ring_heartbeat(void* mem);

// Snapshot the liveness block into out[5]: epoch, heartbeat_ms,
// posted_floor, req_tail, now_ms — one call so the data plane's event
// loop reads a consistent-enough picture with a single FFI/shm touch.
void pingoo_ring_liveness(void* mem, uint64_t out[5]);

// Advance the posted floor to `ticket` (monotonic max; relaxed CAS
// loop so late batch completions can't move it backwards). All tickets
// below the floor have verdicts posted.
void pingoo_ring_set_posted_floor(void* mem, uint64_t ticket);

// Reclaim one orphaned request ticket during crash-reattach
// reconciliation (tickets in [posted_floor, req_tail)). Returns 0 and
// copies the slot into `out` when the request bytes are still intact
// (the new sidecar re-evaluates them); returns -1 when the bytes are
// gone (a producer reclaimed the slot — the caller fail-opens the
// ticket instead). Also releases slots wedged by a consumer that died
// between its tail-CAS and seq-release, which would otherwise stall
// the ring forever at that position.
int pingoo_ring_reclaim_request(void* mem, uint64_t ticket,
                                PingooRequestSlot* out);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // PINGOO_RING_H_
