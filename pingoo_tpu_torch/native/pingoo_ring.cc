// Vyukov bounded MPMC rings over a shared mapping. See pingoo_ring.h.

#include "pingoo_ring.h"

#include <time.h>

#include <atomic>
#include <cstring>

namespace {

inline std::atomic<uint64_t>* as_atomic(uint64_t* p) {
  return reinterpret_cast<std::atomic<uint64_t>*>(p);
}

inline void tel_add(uint64_t* field, uint64_t n) {
  as_atomic(field)->fetch_add(n, std::memory_order_relaxed);
}

// CAS-max: racing producers may publish interleaved highs; the final
// value is the max of all observed depths, which is what a high-water
// mark means.
inline void tel_max(uint64_t* field, uint64_t v) {
  auto* a = as_atomic(field);
  uint64_t cur = a->load(std::memory_order_relaxed);
  while (v > cur &&
         !a->compare_exchange_weak(cur, v, std::memory_order_relaxed)) {
  }
}

// Verdict-wait bucket upper bounds in ms (last bucket +inf); keep in
// sync with PINGOO_WAIT_BUCKETS and obs/schema.SHARED_WAIT_BUCKETS_MS.
const uint64_t kWaitBoundsMs[PINGOO_WAIT_BUCKETS - 1] = {1,  2,   5,   10,
                                                         50, 100, 1000};

inline uint32_t wait_bucket(uint64_t ms) {
  for (uint32_t i = 0; i < PINGOO_WAIT_BUCKETS - 1; ++i) {
    if (ms < kWaitBoundsMs[i]) return i;
  }
  return PINGOO_WAIT_BUCKETS - 1;
}

struct Layout {
  PingooRingHeader* header;
  PingooRequestSlot* req;
  PingooVerdictSlot* ver;
  PingooSpillSlot* spill;
  PingooBodySlot* body;
};

Layout layout(void* mem, uint32_t capacity) {
  Layout l;
  l.header = static_cast<PingooRingHeader*>(mem);
  l.req = reinterpret_cast<PingooRequestSlot*>(
      static_cast<char*>(mem) + sizeof(PingooRingHeader));
  l.ver = reinterpret_cast<PingooVerdictSlot*>(
      reinterpret_cast<char*>(l.req) + sizeof(PingooRequestSlot) * capacity);
  l.spill = reinterpret_cast<PingooSpillSlot*>(
      reinterpret_cast<char*>(l.ver) + sizeof(PingooVerdictSlot) * capacity);
  l.body = reinterpret_cast<PingooBodySlot*>(
      reinterpret_cast<char*>(l.spill) +
      sizeof(PingooSpillSlot) * PINGOO_SPILL_SLOTS);
  return l;
}

// Claim a free spill slot (CAS over the small fixed pool); returns
// PINGOO_SPILL_NONE when every slot is in flight.
uint8_t spill_claim(Layout& l) {
  for (uint32_t i = 0; i < PINGOO_SPILL_SLOTS; ++i) {
    auto* st = as_atomic(&l.spill[i].state);
    uint64_t expect = 0;
    if (st->compare_exchange_strong(expect, 1, std::memory_order_acquire))
      return static_cast<uint8_t>(i);
  }
  return PINGOO_SPILL_NONE;
}

// Returns true if the source exceeded the cap (the slot then carries a
// truncated view and must be flagged for off-device re-evaluation).
inline bool copy_capped(char* dst, uint32_t cap, const char* src, uint32_t len,
                        uint16_t* len_out) {
  uint32_t n = len < cap ? len : cap;
  std::memcpy(dst, src, n);
  if (n < cap) std::memset(dst + n, 0, cap - n);
  *len_out = static_cast<uint16_t>(n);
  return len > cap;
}

}  // namespace

extern "C" {

size_t pingoo_ring_bytes(uint32_t capacity) {
  return sizeof(PingooRingHeader) +
         capacity * (sizeof(PingooRequestSlot) + sizeof(PingooVerdictSlot)) +
         PINGOO_SPILL_SLOTS * sizeof(PingooSpillSlot) +
         PINGOO_BODY_SLOTS * sizeof(PingooBodySlot);
}

void pingoo_ring_init(void* mem, uint32_t capacity) {
  std::memset(mem, 0, pingoo_ring_bytes(capacity));
  Layout l = layout(mem, capacity);
  l.header->magic = PINGOO_RING_MAGIC;
  l.header->version = PINGOO_RING_VERSION;
  l.header->capacity = capacity;
  l.header->request_slot_size = sizeof(PingooRequestSlot);
  l.header->verdict_slot_size = sizeof(PingooVerdictSlot);
  l.header->body_slot_size = sizeof(PingooBodySlot);
  l.header->body_capacity = PINGOO_BODY_SLOTS;
  for (uint32_t i = 0; i < capacity; ++i) {
    as_atomic(&l.req[i].seq)->store(i, std::memory_order_relaxed);
    as_atomic(&l.ver[i].seq)->store(i, std::memory_order_relaxed);
  }
  for (uint32_t i = 0; i < PINGOO_BODY_SLOTS; ++i)
    as_atomic(&l.body[i].seq)->store(i, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

int pingoo_ring_attach(void* mem, uint32_t* capacity_out) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  if (header->magic != PINGOO_RING_MAGIC ||
      header->version != PINGOO_RING_VERSION ||
      header->request_slot_size != sizeof(PingooRequestSlot) ||
      header->verdict_slot_size != sizeof(PingooVerdictSlot) ||
      header->body_slot_size != sizeof(PingooBodySlot) ||
      header->body_capacity != PINGOO_BODY_SLOTS) {
    return -1;
  }
  if (capacity_out) *capacity_out = header->capacity;
  return 0;
}

uint64_t pingoo_ring_enqueue_request(
    void* mem, const char* method, uint32_t method_len, const char* host,
    uint32_t host_len, const char* path, uint32_t path_len, const char* url,
    uint32_t url_len, const char* ua, uint32_t ua_len, const uint8_t ip[16],
    uint16_t remote_port, uint32_t asn, const char country[2]) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  uint32_t cap = header->capacity;
  Layout l = layout(mem, cap);
  auto* head = as_atomic(&header->req_head);

  uint64_t pos = head->load(std::memory_order_relaxed);
  for (;;) {
    PingooRequestSlot* slot = &l.req[pos & (cap - 1)];
    uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
    intptr_t diff = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
    if (diff == 0) {
      if (head->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        slot->ticket = pos;
        slot->enq_ms = pingoo_ring_now_ms();
        bool truncated = false;
        truncated |= copy_capped(slot->method, PINGOO_METHOD_CAP, method,
                                 method_len, &slot->method_len);
        truncated |= copy_capped(slot->host, PINGOO_HOST_CAP, host, host_len,
                                 &slot->host_len);
        truncated |= copy_capped(slot->path, PINGOO_PATH_CAP, path, path_len,
                                 &slot->path_len);
        truncated |= copy_capped(slot->url, PINGOO_URL_CAP, url, url_len,
                                 &slot->url_len);
        truncated |= copy_capped(slot->user_agent, PINGOO_UA_CAP, ua, ua_len,
                                 &slot->ua_len);
        std::memcpy(slot->ip, ip, 16);
        slot->remote_port = remote_port;
        slot->asn = asn;
        slot->country[0] = country[0];
        slot->country[1] = country[1];
        slot->flags = truncated ? PINGOO_SLOT_FLAG_TRUNCATED : 0;
        slot->spill_idx = PINGOO_SPILL_NONE;
        // Over-cap path/url: park the FULL strings in a spill slot so
        // the consumer evaluates this row over untruncated bytes
        // (method/host/ua overflows are normalized before enqueue by
        // both data planes: host empties, UA 403s).
        if ((path_len > PINGOO_PATH_CAP || url_len > PINGOO_URL_CAP) &&
            url_len + path_len <= PINGOO_SPILL_DATA_CAP) {
          uint8_t sidx = spill_claim(l);
          if (sidx != PINGOO_SPILL_NONE) {
            PingooSpillSlot* sp = &l.spill[sidx];
            sp->url_len = url_len;
            sp->path_len = path_len;
            std::memcpy(sp->data, url, url_len);
            std::memcpy(sp->data + url_len, path, path_len);
            slot->spill_idx = sidx;
          }
        }
        as_atomic(&slot->seq)->store(pos + 1, std::memory_order_release);
        PingooRingTelemetry* tel = &header->telemetry;
        tel_add(&tel->enqueued, 1);
        uint64_t tail =
            as_atomic(&header->req_tail)->load(std::memory_order_relaxed);
        if (pos + 1 > tail) tel_max(&tel->depth_hwm, pos + 1 - tail);
        return pos;
      }
    } else if (diff < 0) {
      tel_add(&header->telemetry.enqueue_full, 1);
      return UINT64_MAX;  // full
    } else {
      pos = head->load(std::memory_order_relaxed);
    }
  }
}

uint32_t pingoo_ring_dequeue_requests(void* mem, PingooRequestSlot* out,
                                      uint32_t max) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  uint32_t cap = header->capacity;
  Layout l = layout(mem, cap);
  auto* tail = as_atomic(&header->req_tail);

  uint32_t count = 0;
  while (count < max) {
    uint64_t pos = tail->load(std::memory_order_relaxed);
    PingooRequestSlot* slot = &l.req[pos & (cap - 1)];
    uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
    intptr_t diff =
        static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
    if (diff == 0) {
      if (tail->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        std::memcpy(&out[count], slot, sizeof(PingooRequestSlot));
        as_atomic(&slot->seq)->store(pos + cap, std::memory_order_release);
        ++count;
      }
    } else {
      break;  // empty
    }
  }
  if (count) tel_add(&header->telemetry.dequeued, count);
  return count;
}

int pingoo_ring_post_verdict(void* mem, uint64_t ticket, uint8_t action,
                             float bot_score) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  uint32_t cap = header->capacity;
  Layout l = layout(mem, cap);
  auto* head = as_atomic(&header->ver_head);

  uint64_t pos = head->load(std::memory_order_relaxed);
  for (;;) {
    PingooVerdictSlot* slot = &l.ver[pos & (cap - 1)];
    uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
    intptr_t diff = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
    if (diff == 0) {
      if (head->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        slot->ticket = ticket;
        slot->action = action;
        slot->bot_score = bot_score;
        as_atomic(&slot->seq)->store(pos + 1, std::memory_order_release);
        tel_add(&header->telemetry.verdicts_posted, 1);
        return 0;
      }
    } else if (diff < 0) {
      tel_add(&header->telemetry.verdict_post_full, 1);
      return -1;  // full
    } else {
      pos = head->load(std::memory_order_relaxed);
    }
  }
}

int pingoo_ring_spill_read(void* mem, uint8_t idx, const char** url,
                           uint32_t* url_len, const char** path,
                           uint32_t* path_len) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  Layout l = layout(mem, header->capacity);
  if (idx >= PINGOO_SPILL_SLOTS) return -1;
  PingooSpillSlot* sp = &l.spill[idx];
  if (as_atomic(&sp->state)->load(std::memory_order_acquire) != 1) return -1;
  if (sp->url_len + sp->path_len > PINGOO_SPILL_DATA_CAP) return -1;
  *url = sp->data;
  *url_len = sp->url_len;
  *path = sp->data + sp->url_len;
  *path_len = sp->path_len;
  return 0;
}

void pingoo_ring_spill_release(void* mem, uint8_t idx) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  Layout l = layout(mem, header->capacity);
  if (idx >= PINGOO_SPILL_SLOTS) return;
  as_atomic(&l.spill[idx].state)->store(0, std::memory_order_release);
}

uint32_t pingoo_ring_post_verdicts(void* mem, const uint64_t* tickets,
                                   const uint8_t* actions, uint32_t n) {
  for (uint32_t i = 0; i < n; ++i) {
    if (pingoo_ring_post_verdict(mem, tickets[i], actions[i], 0.0f) != 0)
      return i;  // ring full: caller resumes from index i
  }
  return n;
}

uint64_t pingoo_ring_now_ms(void) {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 +
         static_cast<uint64_t>(ts.tv_nsec) / 1000000;
}

void pingoo_ring_record_waits(void* mem, const uint64_t* enq_ms,
                              uint32_t n) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  PingooRingTelemetry* tel = &header->telemetry;
  uint64_t now = pingoo_ring_now_ms();
  uint64_t sum = 0;
  uint64_t bucket_n[PINGOO_WAIT_BUCKETS] = {0};
  for (uint32_t i = 0; i < n; ++i) {
    // A clock-skewed (or zero) enq_ms clamps to 0 rather than wrapping
    // into the +inf bucket.
    uint64_t ms = enq_ms[i] && now > enq_ms[i] ? now - enq_ms[i] : 0;
    sum += ms;
    bucket_n[wait_bucket(ms)]++;
  }
  tel_add(&tel->wait_sum_ms, sum);
  for (uint32_t b = 0; b < PINGOO_WAIT_BUCKETS; ++b) {
    if (bucket_n[b]) tel_add(&tel->wait_hist[b], bucket_n[b]);
  }
}

void pingoo_ring_telemetry_snapshot(void* mem, uint64_t* out) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  PingooRingTelemetry* tel = &header->telemetry;
  auto rd = [](uint64_t* p) {
    return as_atomic(p)->load(std::memory_order_relaxed);
  };
  uint64_t head = rd(&header->req_head);
  uint64_t tail = rd(&header->req_tail);
  out[0] = rd(&tel->enqueued);
  out[1] = rd(&tel->enqueue_full);
  out[2] = rd(&tel->dequeued);
  out[3] = head > tail ? head - tail : 0;  // current depth
  out[4] = rd(&tel->depth_hwm);
  out[5] = rd(&tel->verdicts_posted);
  out[6] = rd(&tel->verdict_post_full);
  out[7] = rd(&tel->wait_sum_ms);
  for (uint32_t b = 0; b < PINGOO_WAIT_BUCKETS; ++b)
    out[8 + b] = rd(&tel->wait_hist[b]);
}

// -- Liveness / supervision protocol (v5, ISSUE 10) --------------------------

uint64_t pingoo_ring_sidecar_attach(void* mem) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  uint64_t epoch =
      as_atomic(&header->sidecar_epoch)->fetch_add(1, std::memory_order_acq_rel)
      + 1;
  as_atomic(&header->sidecar_heartbeat_ms)
      ->store(pingoo_ring_now_ms(), std::memory_order_release);
  return epoch;
}

void pingoo_ring_heartbeat(void* mem) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  as_atomic(&header->sidecar_heartbeat_ms)
      ->store(pingoo_ring_now_ms(), std::memory_order_relaxed);
}

void pingoo_ring_liveness(void* mem, uint64_t out[5]) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  out[0] = as_atomic(&header->sidecar_epoch)->load(std::memory_order_acquire);
  out[1] = as_atomic(&header->sidecar_heartbeat_ms)
               ->load(std::memory_order_relaxed);
  out[2] = as_atomic(&header->posted_floor)->load(std::memory_order_relaxed);
  out[3] = as_atomic(&header->req_tail)->load(std::memory_order_relaxed);
  out[4] = pingoo_ring_now_ms();
}

void pingoo_ring_set_posted_floor(void* mem, uint64_t ticket) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  // CAS-max: batches complete FIFO on one drain thread today, but a
  // monotonic floor must survive any future completion reordering.
  auto* a = as_atomic(&header->posted_floor);
  uint64_t cur = a->load(std::memory_order_relaxed);
  while (ticket > cur &&
         !a->compare_exchange_weak(cur, ticket, std::memory_order_release)) {
  }
}

int pingoo_ring_reclaim_request(void* mem, uint64_t ticket,
                                PingooRequestSlot* out) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  uint32_t cap = header->capacity;
  Layout l = layout(mem, cap);
  PingooRequestSlot* slot = &l.req[ticket & (cap - 1)];
  uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
  if (seq == ticket + 1) {
    // The dead consumer CASed req_tail past this position but died
    // before releasing the slot seq: the bytes are intact, and nothing
    // else will ever touch this slot (a producer needs seq == ticket +
    // cap) — copy, then release, or the ring wedges here forever on
    // wraparound.
    std::memcpy(out, slot, sizeof(PingooRequestSlot));
    as_atomic(&slot->seq)->store(ticket + cap, std::memory_order_release);
    tel_add(&header->telemetry.dequeued, 1);
    return 0;
  }
  if (seq == ticket + cap) {
    // Cleanly consumed and released. The bytes survive until a producer
    // claims position ticket+cap, so guard the copy seqlock-style: the
    // producer CASes req_head past ticket+cap BEFORE writing, so an
    // unmoved head after the copy proves the bytes were stable.
    uint64_t head =
        as_atomic(&header->req_head)->load(std::memory_order_acquire);
    if (head <= ticket + cap) {
      std::memcpy(out, slot, sizeof(PingooRequestSlot));
      std::atomic_thread_fence(std::memory_order_acquire);
      uint64_t head2 =
          as_atomic(&header->req_head)->load(std::memory_order_acquire);
      uint64_t seq2 = as_atomic(&slot->seq)->load(std::memory_order_acquire);
      if (head2 <= ticket + cap && seq2 == ticket + cap &&
          out->ticket == ticket) {
        return 0;
      }
    }
  }
  return -1;  // bytes gone (slot reused): the caller fail-opens
}

int pingoo_ring_poll_verdict(void* mem, uint64_t* ticket_out,
                             uint8_t* action_out, float* score_out) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  uint32_t cap = header->capacity;
  Layout l = layout(mem, cap);
  auto* tail = as_atomic(&header->ver_tail);

  for (;;) {
    uint64_t pos = tail->load(std::memory_order_relaxed);
    PingooVerdictSlot* slot = &l.ver[pos & (cap - 1)];
    uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
    intptr_t diff =
        static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
    if (diff == 0) {
      if (tail->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        *ticket_out = slot->ticket;
        *action_out = slot->action;
        *score_out = slot->bot_score;
        as_atomic(&slot->seq)->store(pos + cap, std::memory_order_release);
        return 0;
      }
    } else {
      return -1;  // empty
    }
  }
}

// -- Body-window ring (v6, ISSUE 13) -----------------------------------------

int pingoo_ring_enqueue_body(void* mem, uint64_t flow, uint32_t win_seq,
                             uint64_t total_len, const char* data,
                             uint32_t len, uint8_t flags) {
  if (len > PINGOO_BODY_WINDOW_CAP) return -2;
  auto* header = static_cast<PingooRingHeader*>(mem);
  Layout l = layout(mem, header->capacity);
  auto* head = as_atomic(&header->body_head);
  const uint32_t bcap = PINGOO_BODY_SLOTS;

  uint64_t pos = head->load(std::memory_order_relaxed);
  for (;;) {
    PingooBodySlot* slot = &l.body[pos & (bcap - 1)];
    uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
    intptr_t diff = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
    if (diff == 0) {
      if (head->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        slot->flow = flow;
        slot->win_seq = win_seq;
        slot->win_len = len;
        slot->total_len = total_len;
        slot->flags = flags;
        if (len) std::memcpy(slot->data, data, len);
        as_atomic(&slot->seq)->store(pos + 1, std::memory_order_release);
        return 0;
      }
    } else if (diff < 0) {
      return -1;  // full: producer fails the flow open to metadata-only
    } else {
      pos = head->load(std::memory_order_relaxed);
    }
  }
}

uint32_t pingoo_ring_dequeue_bodies(void* mem, PingooBodySlot* out,
                                    uint32_t max) {
  auto* header = static_cast<PingooRingHeader*>(mem);
  Layout l = layout(mem, header->capacity);
  auto* tail = as_atomic(&header->body_tail);
  const uint32_t bcap = PINGOO_BODY_SLOTS;

  uint32_t count = 0;
  while (count < max) {
    uint64_t pos = tail->load(std::memory_order_relaxed);
    PingooBodySlot* slot = &l.body[pos & (bcap - 1)];
    uint64_t seq = as_atomic(&slot->seq)->load(std::memory_order_acquire);
    intptr_t diff =
        static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
    if (diff == 0) {
      if (tail->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        std::memcpy(&out[count], slot, sizeof(PingooBodySlot));
        as_atomic(&slot->seq)->store(pos + bcap, std::memory_order_release);
        ++count;
      }
    } else {
      break;  // empty
    }
  }
  return count;
}

}  // extern "C"
