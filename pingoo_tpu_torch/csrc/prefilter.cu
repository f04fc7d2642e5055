// Stage-A literal prefilter: packed multi-literal shift-AND over the byte
// fields of one batch, every field in one launch.
//
// Replaces the Pallas kernel pingoo_tpu/ops/prefilter.py:246 `_pf_kernel`
// (`pl.pallas_call` at :301, wrapper `_fused_prefilter`), with the chunk
// contract of `prefilter_scan_chunk`: per column i, while toff + i < len,
//     S' = ((S << 1) | init) & tab[byte]
// and H |= S every column (a column past the row's length leaves S as it
// is). A field's epilogue can also write its [B, F] factor hits,
// (H[accept_word[f]] & accept_mask[f]) != 0 (`prefilter_extract`), so
// Stage A is one launch from a fresh state to the hits. The TPU kernel
// gathered tab[byte] with a one-hot x u16-halves matmul; here it is one
// shared-memory load.
//
// What bounds it on an H100: integer issue. Per live byte and word a step
// is a load, a shift, an AND-OR and an OR; the bytes (the rows once, the
// [256, Wp] table, B * F hits) are far below the memory rate. On the main
// path's short rows (32-128 columns) a launch's fixed cost and the table's
// staging are most of the time. The design:
//   * One launch scans up to MAX_FIELDS fields, each described by value in
//     the kernel's parameters (no descriptor copy); block ranges select the
//     field. A fresh state is made in registers, and a field's S and H are
//     read and written only when its caller passes them.
//   * The table sits in shared memory when it fits (up to about 213 words
//     with the block's H rows): one mbarrier, 16 KB `cp.async.bulk` copies
//     from the first warp's lanes, overlapped with the rows' first loads.
//     A larger table is read through L1 from L2 (`__ldg`). The wrapper pads
//     the table with TABLE_PAD zero words so that a lane past the bank's
//     last word reads inside it; those words are never stored.
//   * A unit of work is (row, segment, slice). Lanes cover consecutive
//     words, K = ceil(Wp / 32) words per lane, so a table lookup
//     tab[byte * Wp + w] is one conflict-free LDS per word and the K loads
//     of a step are independent. A bank of at most 16 words runs several
//     units per warp on G = next_pow2(Wp) lanes each; a bank wider than 256
//     words runs in slices of 256 words (K = 8), one unit per slice. A
//     row's slices share a block while they fit its 16 units; past that
//     (a bank of more than 4096 words) they spread over several blocks,
//     each holding, writing and reading for hits only its own words.
//   * A unit's row bytes are read once: each lane of the unit loads 16
//     bytes of the row (a unit of G lanes loads 16 * G columns, one round
//     ahead of use), and each step takes its byte from a __shfl_sync
//     broadcast of four bytes at a time.
//   * Exact column segments: factors never span a word and bit 0 of every
//     factor is re-armed by `init` each step, so bit base+j of S at column
//     t depends only on bytes t-j .. t, with j <= 31. A segment starting at
//     column s > WARM walks from column s - WARM with S = 0, and from column
//     s on its S is exact; a segment with s <= WARM walks from column 0
//     from S_in. S from a zero start is a subset of the exact S at every
//     column, so a segment may OR its warm-up columns into H too: they are
//     live, and the segment that owns them ORs the exact value. Each row's
//     segments sit in one block and OR their H into its shared-memory row;
//     S_out comes from the segment that holds the row's last live column.
//     `ops/prefilter.py` `segment_length` picks the segment length.
//   * The fields' blocks are issued longest walk first, so that the short
//     blocks fill in behind the long ones (the main path's user_agent
//     field, 16 blocks of 128 rows, ran last and set the launch's time).
//   * The epilogue writes hits with one thread per factor over the
//     block's rows (coalesced bytes, no division); each thread loads its
//     factor's accept word and mask before the walk.
//   * 16 warps a block. On the H100 8 warps were faster at full width and
//     slower on the main path; walking several rows per unit, capping the
//     registers, or reading the table from L2 on short rows were slower.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_FIELDS = 4;
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int SLICE_WORDS = 256;  // words of a unit: 32 lanes x K = 8
constexpr int WARM = 32;          // warm-up columns: >= 31, a multiple of 16
constexpr int TABLE_PAD = 256;    // zero words after the table
constexpr int SMEM_MAX = 227 * 1024;
constexpr int COPY_BYTES = 16 * 1024;  // per bulk copy, one per lane

}  // namespace

// One field as the host describes it (ops/prefilter.py `_Field`). A null
// S_in / H_in is a fresh (zero) state; a null S_out / H_out / hits is not
// written. `toff` null: every row starts at toff_all.
struct PfField {
  const uint8_t* data;  // [B, Lc], rows `stride` bytes apart
  const int32_t* lens;
  const int32_t* toff;
  const uint32_t* tab;  // [256 * Wp + TABLE_PAD]
  const uint32_t* init;
  const int32_t* accept_word;
  const uint32_t* accept_mask;
  const uint32_t* S_in;
  const uint32_t* H_in;
  uint32_t* S_out;
  uint32_t* H_out;
  uint8_t* hits;  // [B, F] bool
  long long stride;
  int Lc, toff_all, Wp, F;
  int seg;  // columns per segment, a multiple of 16
};

namespace {

struct Field {
  PfField d;
  int K, G;       // words per lane, lanes per unit
  int nseg, nsl;  // segments and slices of a row
  int nsb, nbs;   // slices per block, blocks per row
  int rows;       // rows per block
  int block0;     // the field's first block
  int in_smem;    // the table is staged
  int vec;        // rows are read 16 bytes at a time
};

struct Args {
  Field f[MAX_FIELDS];
  int nf, B;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// Bytes [i, i + 16) of a row as four little-endian words, zero at and
// past column n.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int i, int n,
                                        bool vec) {
  if (i >= n) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + i));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (i + j < n) w[j >> 2] |= (uint32_t)__ldg(row + i + j) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool SMEM>
__device__ __forceinline__ uint32_t ld(const uint32_t* p) {
  if constexpr (SMEM) return *p;
  return __ldg(p);
}

// Walk one unit: row b, segment k, words [w0, w0 + K * G) (lane's words
// w0 + kk * G + gl), ORing H into Hrow[word - hw]. `active` is false for
// a lane whose unit lies past the batch or the bank; it still takes part
// in the warp's shuffles.
template <int K, bool SMEM>
__device__ __forceinline__ void walk(const Field& f, int b, int k, int w0,
                                     bool active, const uint32_t* tab_s,
                                     uint32_t* Hrow, int hw, uint32_t mb) {
  const PfField& d = f.d;
  const int G = K > 1 ? 32 : f.G;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int gb = lane - gl;
  const int Wp = d.Wp;
  const int wl = w0 + gl;  // the lane's first word

  int steps = 0, s = 0, w = 0, n = 0;
  const uint8_t* row = d.data;
  if (active) {
    const long long t0 = d.toff ? d.toff[b] : d.toff_all;
    const long long live = (long long)d.lens[b] - t0;
    steps = live <= 0 ? 0 : (live < d.Lc ? (int)live : d.Lc);
    s = k * d.seg;
    const int e = s + d.seg < steps ? s + d.seg : steps;
    w = s > WARM ? s - WARM : 0;
    n = e > s ? e - w : 0;
    row += (long long)b * d.stride;
  }
  const int end = w + n;
  const bool vec = f.vec != 0;
  uint4 cur = load16(row, w + 16 * gl, end, vec);

  uint32_t S[K], H[K], ini[K];
  const size_t rw = (size_t)b * Wp;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int word = wl + kk * G;
    const bool ok = active && word < Wp;
    ini[kk] = ok ? __ldg(d.init + word) : 0u;
    S[kk] = ok && w == 0 && d.S_in ? d.S_in[rw + word] : 0u;
    H[kk] = ok && k == 0 && d.H_in ? d.H_in[rw + word] : 0u;
    // No live column: H |= S_in once (when the chunk has any column).
    if (k == 0 && steps == 0 && d.Lc > 0) H[kk] |= S[kk];
  }
  // Several units per warp walk to the longest of them.
  const int nmax = G < 32 ? __reduce_max_sync(FULL, n) : n;
  if constexpr (SMEM) mbar_wait(mb, 0);

  // The lane's first word of table row 0, and a row's size, in bytes.
  const char* tab = reinterpret_cast<const char*>((SMEM ? tab_s : d.tab) + wl);
  const int Wp4 = 4 * Wp;
  auto step = [&](uint32_t byte) {
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(tab + (int)byte * Wp4);
    uint32_t m[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) m[kk] = ld<SMEM>(p + kk * G);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      S[kk] = ((S[kk] << 1) | ini[kk]) & m[kk];
      H[kk] |= S[kk];
    }
  };
  for (int r0 = 0; r0 < nmax; r0 += 16 * G) {
    const uint4 nxt = load16(row, w + r0 + 16 * (G + gl), end, vec);
    for (int j = 0; j < G; ++j) {
      const int c0 = r0 + 16 * j;
      if (c0 >= nmax) break;
      const uint32_t q[4] = {__shfl_sync(FULL, cur.x, gb + j),
                             __shfl_sync(FULL, cur.y, gb + j),
                             __shfl_sync(FULL, cur.z, gb + j),
                             __shfl_sync(FULL, cur.w, gb + j)};
      if (c0 + 16 <= n) {
#pragma unroll
        for (int t = 0; t < 16; ++t) step(__byte_perm(q[t >> 2], 0, 0x4440 | (t & 3)));
      } else {
#pragma unroll
        for (int t = 0; t < 16; ++t)
          if (c0 + t < n) step(__byte_perm(q[t >> 2], 0, 0x4440 | (t & 3)));
      }
    }
    cur = nxt;
  }
  if (!active) return;

  // S_out: the segment that holds the row's last live column (column 0's
  // segment when none is live).
  const int last = steps > 0 ? steps - 1 : 0;
  const bool put_s = d.S_out && s <= last && last < s + d.seg;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int word = wl + kk * G;
    if (word >= Wp) continue;
    if (put_s) d.S_out[rw + word] = S[kk];
    if (f.nseg > 1) {
      if (H[kk]) atomicOr(Hrow + word - hw, H[kk]);
    } else {
      Hrow[word - hw] = H[kk];
    }
  }
}

// walk<K> for the field's K, over the K <= KMAX a kernel is built for.
template <int KK, int KMAX, bool SMEM>
__device__ __forceinline__ void walk_k(int K, const Field& f, int b, int k,
                                       int w0, bool active,
                                       const uint32_t* tab_s, uint32_t* Hrow,
                                       int hw, uint32_t mb) {
  if constexpr (KK < KMAX) {
    if (K != KK)
      return walk_k<KK + 1, KMAX, SMEM>(K, f, b, k, w0, active, tab_s, Hrow,
                                        hw, mb);
  }
  walk<KK, SMEM>(f, b, k, w0, active, tab_s, Hrow, hw, mb);
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
    pf_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint4 smem4[];
  __shared__ uint64_t bar;
  int fi = 0;
#pragma unroll
  for (int i = 1; i < MAX_FIELDS; ++i)
    if (i < a.nf && (int)blockIdx.x >= a.f[i].block0) fi = i;
  const Field& f = a.f[fi];
  const int Wp = f.d.Wp;
  const bool in_smem = f.in_smem != 0;
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* Hs = tab_s + (in_smem ? 256 * Wp + TABLE_PAD : 0);
  const int tbytes = (256 * Wp + TABLE_PAD) * 4;
  const uint32_t mb = smem_addr(&bar);
  if (in_smem && threadIdx.x == 0) {
    // One arrival, which also expects every byte of the table.
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
        "r"(tbytes)
        : "memory");
  }
  // The block's rows and words: nbs blocks a row group, each of nsb
  // slices from word wlo, `span` words of H a row.
  const int bi = blockIdx.x - f.block0;
  const int rb = f.nbs > 1 ? bi / f.nbs : bi;
  const int wlo = (bi - rb * f.nbs) * f.nsb * SLICE_WORDS;
  const int span = Wp - wlo < f.nsb * SLICE_WORDS ? Wp - wlo
                                                  : f.nsb * SLICE_WORDS;
  const int b0 = rb * f.rows;
  // The thread's unit: units are numbered warp by warp, G lanes each, and
  // a row's nseg x nsb units are consecutive.
  const int G = f.G;
  const int lu = (threadIdx.x >> 5) * (32 / G) + (threadIdx.x & 31) / G;
  const int parts = f.nseg * f.nsb;
  const int r = lu / parts;
  const int k = (lu - r * parts) / f.nsb;
  const int sl = lu - r * parts - k * f.nsb;
  if (f.nseg > 1)
    for (int i = threadIdx.x; i < f.rows * span; i += THREADS) Hs[i] = 0u;
  __syncthreads();
  if (in_smem && threadIdx.x < 32) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(f.d.tab);
    for (int off = threadIdx.x * COPY_BYTES; off < tbytes;
         off += 32 * COPY_BYTES) {
      const int nb = tbytes - off < COPY_BYTES ? tbytes - off : COPY_BYTES;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(tab_s) + off),
          "l"(reinterpret_cast<uint64_t>(src + off)), "r"(nb), "r"(mb)
          : "memory");
    }
  }
  const int w0 = wlo + sl * SLICE_WORDS;
  const bool active = r < f.rows && b0 + r < a.B && w0 < Wp;
  // The epilogue's first factor of this thread, loaded ahead of the walk.
  const int F = f.d.hits ? f.d.F : 0;
  int aw0 = 0;
  uint32_t am0 = 0u;
  if ((int)threadIdx.x < F) {
    aw0 = __ldg(f.d.accept_word + threadIdx.x);
    am0 = __ldg(f.d.accept_mask + threadIdx.x);
  }
  uint32_t* Hrow = Hs + (active ? r : 0) * span;
  if (in_smem)
    walk_k<1, KMAX, true>(f.K, f, b0 + r, k, w0, active, tab_s, Hrow, wlo,
                          mb);
  else
    walk_k<1, KMAX, false>(f.K, f, b0 + r, k, w0, active, tab_s, Hrow, wlo,
                           mb);
  if (in_smem) mbar_wait(mb, 0);  // no block leaves with a copy in flight
  __syncthreads();

  // Epilogue: the block's rows of H and of the factor hits.
  const int rows = a.B - b0 < f.rows ? a.B - b0 : f.rows;
  if (f.d.H_out) {
    uint32_t* out = f.d.H_out + (size_t)b0 * Wp + wlo;
    if (span == Wp) {
      for (int i = threadIdx.x; i < rows * Wp; i += THREADS) out[i] = Hs[i];
    } else {
      for (int rr = 0; rr < rows; ++rr)
        for (int i = threadIdx.x; i < span; i += THREADS)
          out[(size_t)rr * Wp + i] = Hs[rr * span + i];
    }
  }
  // Thread j writes factor j (and j + THREADS, ...) of every row, in the
  // block that holds its accept word.
  uint8_t* hits = f.d.hits + (size_t)b0 * F;
  for (int j = threadIdx.x; j < F; j += THREADS) {
    const int aw =
        (j == (int)threadIdx.x ? aw0 : __ldg(f.d.accept_word + j)) - wlo;
    const uint32_t am =
        j == (int)threadIdx.x ? am0 : __ldg(f.d.accept_mask + j);
    if (aw < 0 || aw >= span) continue;
    for (int rr = 0; rr < rows; ++rr)
      hits[(size_t)rr * F + j] = (Hs[rr * span + aw] & am) != 0u;
  }
}

}  // namespace

// Scan `nf` fields of a B-row batch in one launch. Returns a cudaError_t.
extern "C" int pingoo_prefilter_scan(const PfField* fields, int nf, int B,
                                     void* stream) {
  if (nf < 1 || nf > MAX_FIELDS) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  Args a{};
  a.nf = nf;
  a.B = B;
  // Fields in order of their rows' walk, longest first, so that the
  // longest blocks start first: the walk's columns, weighed by the words
  // per lane plus a step's own work.
  int order[MAX_FIELDS];
  for (int i = 0; i < nf; ++i) order[i] = i;
  auto cost = [&](int i) {
    const PfField& d = fields[i];
    const int cols = d.Lc < d.seg ? d.Lc : d.seg + WARM;
    const int per_lane = (d.Wp + 31) / 32;
    return (long long)cols * (per_lane + 2);
  };
  for (int i = 1; i < nf; ++i)
    for (int j = i; j > 0 && cost(order[j]) > cost(order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  int blocks = 0, kmax = 1;
  size_t dyn = 0;
  for (int i = 0; i < nf; ++i) {
    Field& f = a.f[i];
    f.d = fields[order[i]];
    const PfField& d = f.d;
    if (d.Wp < 1 || d.Lc < 0 || d.seg < 16 || d.seg % 16 != 0 ||
        (d.hits && d.F < 1) ||
        (reinterpret_cast<uintptr_t>(d.tab) & 15) != 0)
      return (int)cudaErrorInvalidValue;
    int G = 1;
    while (G < 32 && G < d.Wp) G *= 2;
    f.G = G;
    f.nsl = (d.Wp + SLICE_WORDS - 1) / SLICE_WORDS;
    f.K = f.nsl > 1 ? 8 : (d.Wp + G - 1) / G;
    f.nseg = d.Lc > d.seg ? (d.Lc + d.seg - 1) / d.seg : 1;
    const int units = WARPS * (32 / G);  // per block
    if (f.nseg > units) return (int)cudaErrorInvalidValue;
    f.nsb = f.nsl < units / f.nseg ? f.nsl : units / f.nseg;
    f.nbs = (f.nsl + f.nsb - 1) / f.nsb;
    f.rows = units / (f.nseg * f.nsb);
    f.block0 = blocks;
    blocks += (B + f.rows - 1) / f.rows * f.nbs;
    const int span = d.Wp < f.nsb * SLICE_WORDS ? d.Wp : f.nsb * SLICE_WORDS;
    const size_t tab_bytes = ((size_t)256 * d.Wp + TABLE_PAD) * 4;
    const size_t h_bytes = (size_t)f.rows * span * 4;
    f.in_smem = f.nsl == 1 && tab_bytes + h_bytes + 16 <= SMEM_MAX;
    f.vec = (reinterpret_cast<uintptr_t>(d.data) & 15) == 0 &&
            d.stride % 16 == 0 && d.Lc % 16 == 0;
    const size_t need = (f.in_smem ? tab_bytes : 0) + h_bytes;
    if (need + 16 > SMEM_MAX) return (int)cudaErrorInvalidValue;
    dyn = need > dyn ? need : dyn;
    kmax = f.K > kmax ? f.K : kmax;
  }
  auto kern = kmax <= 2 ? pf_kernel<2> : pf_kernel<8>;
  static int dyn_set[2] = {48 * 1024 - 16, 48 * 1024 - 16};
  int& set = dyn_set[kmax <= 2 ? 0 : 1];
  if ((int)dyn > set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX - 16);
    if (e != cudaSuccess) return (int)e;
    set = SMEM_MAX - 16;
  }
  kern<<<blocks, THREADS, dyn, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* pingoo_prefilter_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
