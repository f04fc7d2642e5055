// Bit-parallel NFA advance (the sticky-accept algebra of
// compiler/nfa.py) over one [B, Lc] byte chunk whose first column sits
// at global position toff[b]; returns the new [B, W] state.
//
// Replaces the Pallas kernel pingoo_tpu/ops/pallas_scan.py `_kernel`
// (wrapper `fused_scan_chunk`) with the same contract. Per live byte
// (0 <= t < len, t = toff + column):
//     adv  = (S << 1) | init_unanchored | (t == 0 ? init_anchored : 0)
//     adv |= carry_mask & (pre-step bit 31 of word w-1)
//     passes x P: x = (adv & opt) + opt; adv |= x ^ opt;
//                 between passes adv |= carry_mask & (x < opt of w-1)
//     S    = (adv | (S & rep)) & cls_table[cls_map[byte]]
//
// Design: one warp per row, four rows per block. Word w lives in lane
// w / K, slot w % K (K words per lane), so a word's left neighbour is in
// the same lane except for slot 0, whose neighbour is the previous
// lane's last slot: one __shfl_up_sync per carry. The shift carry is a
// funnel shift of the PRE-step word w-1, masked to bit 31 where
// carry_mask continues the span; the escape carry of pass p is pass p's
// `x < opt` of word w-1, added before pass p+1.
//   * K, the pass count P and the carry are template arguments (chosen
//     by ops/nfa_scan.py `kernel_variant`): passes unroll, and a bank
//     without carry runs no carry code and one pass. Without the escape
//     carry a second pass sets no new bit: within a run of opt bits the
//     first pass already sets every bit from the run's lowest active bit
//     through one past its top, and adding opt to that run gives the same
//     bits back. With carry, P = 2 unrolls the corpus banks' two passes
//     and P = 0 loops over the runtime pass count (1, or 3 or more).
//   * The byte -> class -> table-row lookup is off the dependent chain.
//     A row's live bytes are read 32 columns at a time, one coalesced
//     byte per lane a block ahead of use, and turned into table-row
//     offsets through the shared class map; each step takes its offset
//     with __shfl_sync, and step i+1's table words are loaded while step
//     i computes.
//   * The class table sits in shared memory with each class row padded
//     to 32 * K words, so a lane's K words are aligned 16-, 8- or 4-byte
//     loads that no two lanes of a load phase serve from one bank (the
//     16-byte units of K = 8 and 16 are swizzled by lane). A padded table
//     above 227 KB is read from global memory (L2) unpadded instead.
//   * Only a row's first live column can sit at t == 0, so that step is
//     peeled; the loop injects init_unanchored alone. A row walks only
//     its live columns, one contiguous run, so there is no pad byte to
//     skip, and the TPU kernel's pair stepping needs no counterpart: the
//     walk and the state are the same for either.
//   * Each warp issues its row's global loads (offset, length, state,
//     first bytes) before the block stages the table, so the two
//     latencies overlap. Four rows per block gives short launches (the
//     main path's recheck is ~100 rows of 64 columns) more blocks, each
//     staging its own copy of the table. Rows keep their static order: a
//     longest-first order built on the device balanced full-width
//     batches better, but its extra launch cost short launches more.
//
// Banks wider than 512 words (32 lanes x 16 words) run in segments of 512
// words, one launch each, in word order. Every carry flows from word w-1
// to word w and never back, so segment k's state never depends on
// segment k+1: a segment needs from the one below only the carries into
// its word 0, per column. The SEG instantiations (K = 16, with carry)
// take them from a per-row, per-column buffer (bit 0: the pre-step bit
// 31 of the word below; bit p+1: that word's escape `x < opt` of pass p)
// in place of lane 0's shuffles, and lane 31 writes the same bits of the
// segment's top word for the next segment. A bank without carry has no
// cross-word term, so its segments run the plain instantiations.
//
// What bounds it on an H100: integer issue at full width (chip_smoke.py
// counts the operations per word and byte for its bound) and the rows'
// unequal lengths, as each SM's share is the sum of its rows; on short
// launches the chain of dependent steps per row (two shuffles per step
// with carry) and the staging. The bytes moved are B * Lc input bytes
// and 2 * B * W * 4 state bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // rows per block
constexpr int THREADS = 32 * WARPS;

struct Args {
  const uint8_t* data;
  int B, Lc;
  const int32_t *lens, *toff;  // toff null: every row starts at toff_all
  int toff_all;
  const int32_t* cls_map;
  const uint32_t* cls_table;
  int C, W;
  int tW, sW;  // row strides (words) of cls_table and of the states
  const uint32_t *init_a, *init_u, *opt, *rep, *carry;
  int passes;
  const uint32_t* state_in;
  uint32_t* state_out;
  int tab_in_smem;
  // SEG only: the carries into word 0 from the segment below, and those
  // out of the top word for the segment above ([B, Lc] each; null for
  // the first and the last segment).
  const uint32_t* cin;
  uint32_t* cout;
};

// 16-byte unit swizzle of a lane for K = 8, 16 (units per lane 2, 4):
// the 8 lanes of a 16-byte load phase then hit 8 distinct bank groups.
// Other K need none: K = 4, 12 step 1 or 3 units, K = 2, 6 step 1 or 3
// 8-byte units, K = 1, 3 step 1 or 3 words per lane.
template <int K>
__device__ __forceinline__ int unit_swizzle(int lane) {
  if constexpr (K == 8) return (lane >> 2) & 1;
  if constexpr (K == 16) return (lane >> 1) & 3;
  return 0;
}

// Position of word w in a padded shared-memory class row.
template <int K>
__device__ __forceinline__ int smem_pos(int w) {
  if constexpr (K == 8 || K == 16) {
    constexpr int U = K / 4;
    const int lane = w / K, k = w % K;
    return ((lane * U + ((k >> 2) ^ unit_swizzle<K>(lane))) << 2) + (k & 3);
  }
  return w;
}

// Stage the [C, W] class table into the padded layout: 16-byte loads of
// a flat table (all of a round issued before its stores), word loads of
// a segment's rows, then the pad words zeroed.
template <int K>
__device__ __forceinline__ void stage_table(uint32_t* tab_s, const Args& a) {
  constexpr int WS = 32 * K;
  constexpr int R = 8;  // 16-byte loads in flight per thread
  const int W = a.W, n = a.C * a.W;
  auto put = [&](int f, uint32_t v) {
    const int c = f / W;
    tab_s[c * WS + smem_pos<K>(f - c * W)] = v;
  };
  int done = 0;
  if (a.tW == W && (reinterpret_cast<uintptr_t>(a.cls_table) & 15) == 0) {
    const uint4* g4 = reinterpret_cast<const uint4*>(a.cls_table);
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += R * THREADS) {
      uint4 v[R];
#pragma unroll
      for (int u = 0; u < R; ++u)
        if (i + u * THREADS < n4) v[u] = __ldg(g4 + i + u * THREADS);
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int j = i + u * THREADS;
        if (j < n4) {
          put(4 * j, v[u].x);
          put(4 * j + 1, v[u].y);
          put(4 * j + 2, v[u].z);
          put(4 * j + 3, v[u].w);
        }
      }
    }
    done = n4 << 2;
  }
  for (int f = done + threadIdx.x; f < n; f += THREADS) {
    const int c = f / W;
    put(f, a.cls_table[(size_t)c * a.tW + f - c * W]);
  }
  const int pad = WS - W;
  for (int i = threadIdx.x; i < a.C * pad; i += THREADS) {
    const int c = i / pad;
    tab_s[c * WS + smem_pos<K>(W + i - c * pad)] = 0u;
  }
}

// The lane's K table words of the class row at `off` (words).
template <int K>
__device__ __forceinline__ void load_row(uint32_t (&m)[K], int off, int lane,
                                         int swz, const uint32_t* tab_s,
                                         const Args& a, bool in_smem) {
  if (in_smem) {
    const uint32_t* p = tab_s + off;
    if constexpr (K % 4 == 0) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p) + lane * (K / 4);
#pragma unroll
      for (int i = 0; i < K / 4; ++i) {
        const uint4 v = p4[i ^ swz];
        m[4 * i] = v.x;
        m[4 * i + 1] = v.y;
        m[4 * i + 2] = v.z;
        m[4 * i + 3] = v.w;
      }
    } else if constexpr (K % 2 == 0) {
      const uint2* p2 = reinterpret_cast<const uint2*>(p) + lane * (K / 2);
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        const uint2 v = p2[i];
        m[2 * i] = v.x;
        m[2 * i + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) m[k] = p[lane * K + k];
    }
  } else {
    const uint32_t* p = a.cls_table + off + lane * K;
#pragma unroll
    for (int k = 0; k < K; ++k) m[k] = lane * K + k < a.W ? __ldg(p + k) : 0u;
  }
}

// One byte step on a lane's K words. cm1 is carry_mask's bit 0 and cm31
// the same at bit 31; both are 0 for the bank's word 0, so lane 0's
// wrapped-around shuffles carry nothing in. With SEG, lane 0 takes the
// carries into the segment's word 0 from `cin` instead, and the step
// returns the carries out of lane 31's top word (meaningful on lane 31).
template <int K, int P, bool CARRY, bool SEG>
__device__ __forceinline__ uint32_t nfa_step(
    uint32_t (&S)[K], const uint32_t (&m)[K], const uint32_t (&inj)[K],
    const uint32_t (&op)[K], const uint32_t (&rp)[K],
    const uint32_t (&cm31)[K], const uint32_t (&cm1)[K], int passes,
    int lane, uint32_t cin) {
  uint32_t adv[K];
  uint32_t cout = 0;
  if constexpr (CARRY) {
    uint32_t prev = __shfl_up_sync(FULL, S[K - 1], 1);
    if constexpr (SEG) {
      if (lane == 0) prev = cin << 31;
      cout = S[K - 1] >> 31;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      adv[k] = __funnelshift_l((k ? S[k - 1] : prev) & cm31[k], S[k], 1) |
               inj[k];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) adv[k] = (S[k] << 1) | inj[k];
  }
  const int np = P ? P : passes;
#pragma unroll
  for (int p = 0; p < np; ++p) {
    uint32_t x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x[k] = (adv[k] & op[k]) + op[k];  // wraps when a closure escapes
      adv[k] |= x[k] ^ op[k];
    }
    if (CARRY && p + 1 < np) {
      const uint32_t top = x[K - 1] < op[K - 1] ? 1u : 0u;
      uint32_t esc = __shfl_up_sync(FULL, top, 1);
      if constexpr (SEG) {
        if (lane == 0) esc = (cin >> (p + 1)) & 1u;
        cout |= top << (p + 1);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t e = k ? (x[k - 1] < op[k - 1] ? 1u : 0u) : esc;
        adv[k] |= e & cm1[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) S[k] = (adv[k] | (S[k] & rp[k])) & m[k];
  return cout;
}

template <int K, int P, bool CARRY, bool SEG>
__global__ void __launch_bounds__(THREADS) nfa_chunk_kernel(const Args a) {
  extern __shared__ uint4 smem4[];
  int32_t* cmap = reinterpret_cast<int32_t*>(smem4);  // class row offsets
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(smem4) + 256;
  const int lane = threadIdx.x & 31;
  const int w0 = lane * K;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool in_smem = a.tab_in_smem != 0;

  // The row's global loads, ahead of the staging. Live columns are the
  // contiguous run [lo, hi) with 0 <= toff + column < len.
  uint32_t S[K], inj0[K];
  int lo = 0, hi = 0, byte0 = 0, nb = 0;
  uint32_t cin0 = 0, ncb = 0;  // SEG: carries in, first column and ahead
  const uint8_t* row = a.data;
  const uint32_t* cin_row = nullptr;
  uint32_t* cout_row = nullptr;
  if (b < a.B) {
    const long long t0 = a.toff ? a.toff[b] : a.toff_all;
    const long long end = (long long)a.lens[b] - t0;
    lo = t0 < 0 ? (int)(-t0 < a.Lc ? -t0 : a.Lc) : 0;
    hi = end < lo ? lo : (end > a.Lc ? a.Lc : (int)end);
    row += (size_t)b * a.Lc;
    const bool anch = t0 + lo == 0;  // the first live column is at t == 0
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool ok = w0 + k < a.W;
      S[k] = ok ? a.state_in[(size_t)b * a.sW + w0 + k] : 0u;
      inj0[k] = ok ? a.init_u[w0 + k] | (anch ? a.init_a[w0 + k] : 0u) : 0u;
    }
    if (lo < hi) byte0 = row[lo];
    nb = lo + 1 + lane < hi ? row[lo + 1 + lane] : 0;
    if constexpr (SEG) {
      if (a.cin) {
        cin_row = a.cin + (size_t)b * a.Lc;
        if (lo < hi) cin0 = cin_row[lo];
        ncb = lo + 1 + lane < hi ? cin_row[lo + 1 + lane] : 0u;
      }
      if (a.cout) cout_row = a.cout + (size_t)b * a.Lc;
    }
  }
  uint32_t iu[K], op[K], rp[K], cm31[K], cm1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = w0 + k;
    const bool ok = w < a.W;
    iu[k] = ok ? a.init_u[w] : 0u;
    op[k] = ok ? a.opt[w] : 0u;
    rp[k] = ok ? a.rep[w] : 0u;
    cm1[k] = ok && (w > 0 || SEG) ? a.carry[w] & 1u : 0u;
    cm31[k] = cm1[k] << 31;
  }

  const int stride = in_smem ? 32 * K : a.tW;
  for (int i = threadIdx.x; i < 256; i += THREADS)
    cmap[i] = a.cls_map[i] * stride;
  if (in_smem) stage_table<K>(tab_s, a);
  __syncthreads();
  if (b >= a.B) return;  // the whole warp leaves together

  const int swz = unit_swizzle<K>(lane);
  if (lo < hi) {
    uint32_t m[K];
    load_row<K>(m, cmap[byte0], lane, swz, tab_s, a, in_smem);
    const uint32_t c = nfa_step<K, P, CARRY, SEG>(S, m, inj0, op, rp, cm31,
                                                   cm1, a.passes, lane, cin0);
    if (SEG && cout_row && lane == 31) cout_row[lo] = c;
    ++lo;
  }
  for (int base = lo; base < hi; base += 32) {
    const int off = cmap[nb];  // column base + lane's class row
    const int n = hi - base < 32 ? hi - base : 32;
    nb = base + 32 + lane < hi ? row[base + 32 + lane] : 0;
    uint32_t cb = 0;
    if constexpr (SEG) {
      cb = ncb;
      if (cin_row) ncb = base + 32 + lane < hi ? cin_row[base + 32 + lane] : 0u;
    }
    uint32_t cur[K];
    load_row<K>(cur, __shfl_sync(FULL, off, 0), lane, swz, tab_s, a, in_smem);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      uint32_t nxt[K];
      load_row<K>(nxt, __shfl_sync(FULL, off, j + 1 < n ? j + 1 : j), lane,
                  swz, tab_s, a, in_smem);
      uint32_t cin = 0;
      if constexpr (SEG) cin = __shfl_sync(FULL, cb, j);
      const uint32_t c = nfa_step<K, P, CARRY, SEG>(S, cur, iu, op, rp, cm31,
                                                     cm1, a.passes, lane, cin);
      if (SEG && cout_row && lane == 31) cout_row[base + j] = c;
#pragma unroll
      for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (w0 + k < a.W) a.state_out[(size_t)b * a.sW + w0 + k] = S[k];
}

constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

template <int K, int P, bool CARRY, bool SEG = false>
cudaError_t launch(Args a, cudaStream_t st) {
  const size_t cmap_bytes = 256 * sizeof(int32_t);
  const size_t tab_bytes = (size_t)a.C * 32 * K * sizeof(uint32_t);
  a.tab_in_smem = cmap_bytes + tab_bytes <= SMEM_MAX;
  const size_t smem = a.tab_in_smem ? cmap_bytes + tab_bytes : cmap_bytes;
  auto kern = nfa_chunk_kernel<K, P, CARRY, SEG>;
  if (smem > SMEM_DEFAULT) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(a.B + WARPS - 1) / WARPS, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// P: 2 unrolled passes, or 0 for a loop over a.passes (any other count);
// a bank without carry runs P = 1 only.
template <int K>
cudaError_t launch_k(const Args& a, int P, int carry, cudaStream_t st) {
  if (!carry) {
    return P == 1 ? launch<K, 1, false>(a, st) : cudaErrorInvalidValue;
  }
  if (P == 2) return launch<K, 2, true>(a, st);
  if (P == 0) return launch<K, 0, true>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// seg: one segment of a bank wider than 512 words (K = 16 with carry;
// cin/cout as in Args, either may be null). The pointers of a segment
// (table, vectors, states) point at its first word in the bank's own
// tensors, whose rows are tW (table) and sW (states) words apart.
extern "C" int pingoo_nfa_scan_chunk(
    const void* data, int B, int Lc, const void* lens, const void* toff,
    int toff_all, const void* cls_map, const void* cls_table, int C, int W,
    int tW, int sW, const void* init_a, const void* init_u, const void* opt,
    const void* rep, const void* carry, int passes, int K, int P, int has_carry,
    const void* state_in, void* state_out, int seg, const void* cin,
    void* cout, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (passes < 1 || W > 32 * K || tW < W || sW < W)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)data, B, Lc, (const int32_t*)lens,
               (const int32_t*)toff, toff_all, (const int32_t*)cls_map,
               (const uint32_t*)cls_table, C, W, tW, sW,
               (const uint32_t*)init_a, (const uint32_t*)init_u,
               (const uint32_t*)opt, (const uint32_t*)rep,
               (const uint32_t*)carry, passes,
               (const uint32_t*)state_in, (uint32_t*)state_out, 0,
               (const uint32_t*)cin, (uint32_t*)cout};
  cudaStream_t st = (cudaStream_t)stream;
  if (seg) {
    // Carries out of a pass count above 31 would not fit their word.
    if (K != 16 || !has_carry || passes > 31) return (int)cudaErrorInvalidValue;
    if (P == 2) return (int)launch<16, 2, true, true>(a, st);
    if (P == 0) return (int)launch<16, 0, true, true>(a, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (K) {
    case 1: return (int)launch_k<1>(a, P, has_carry, st);
    case 2: return (int)launch_k<2>(a, P, has_carry, st);
    case 3: return (int)launch_k<3>(a, P, has_carry, st);
    case 4: return (int)launch_k<4>(a, P, has_carry, st);
    case 6: return (int)launch_k<6>(a, P, has_carry, st);
    case 8: return (int)launch_k<8>(a, P, has_carry, st);
    case 12: return (int)launch_k<12>(a, P, has_carry, st);
    case 16: return (int)launch_k<16>(a, P, has_carry, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pingoo_nfa_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
