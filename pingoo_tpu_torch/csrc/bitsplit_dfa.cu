// Bitsplit-DFA walk over one [B, Lc] byte chunk, carrying the DFA state
// and the sticky accept accumulator H in and out.
//
// Replaces the Pallas kernel pingoo_tpu/ops/bitsplit_dfa.py:248
// `_dfa_kernel` (`pl.pallas_call` at :312, wrapper `_fused_dfa` :294),
// with the chunk contract of `dfa_scan_chunk`: while t_offset + i < len,
//     H |= step_accept[state];  state = trans[state, byte_cls[byte]]
// The absolute-end accepts (`end_accept[state]`) are applied afterwards
// by `dfa_finalize`, exactly as in the chunked reference.
//
// What bounds it on an H100: a row's walk is a chain of dependent table
// loads, one per live byte, and nothing in the algorithm shortens it. The
// bytes (B * Lc in, B * (1 + Wh) * 4 out) and the operations (about Wh + 3
// per byte) are far below the card's rates, so the latency of one step
// and the fixed cost of a launch decide the time. The TPU kernel selected
// the next state with a one-hot matmul; here a step is an indexed load,
// and the design shortens that load:
//   * The table in the kernel's own layout, built once per table by
//     ops/bitsplit_dfa.py `kernel_layout`: `trans` as 16-bit entries, then
//     `step_accept` as it is. With S <= 32768 an entry is the next state
//     shifted left by one, its bit 0 set when that state has any step
//     accept; with up to 65536 states it is the bare state. Half-size
//     entries put `dfa_url` (S = 1009, C = 58: 117 KB of entries and
//     20 KB of accepts) in shared memory, and the flag takes the accept
//     loads off every step whose state accepts nothing, which is almost
//     every step of a walk.
//   * A layout that fits (path "smem") is staged once per block with
//     one-dimensional bulk copies (`cp.async.bulk`, the TMA's 1-D form),
//     16 KB each from a lane of the first warp, that complete on an
//     mbarrier while the threads load their rows. A step is then one
//     dependent shared-memory load, a shift and one multiply-add. A
//     layout that does not fit (`dfa_path`, `dfa_win_url`: 325 and 337 KB
//     of entries) is read through the read-only data path (path "l2"):
//     the states a walk visits most stay in the SM's L1, which the kernel
//     leaves as large as it can. Staging paid even at the main path's
//     64 columns on the H100; staging only the hot low-numbered states of
//     a large table, with a select per step, lengthened every step's
//     chain more than it saved.
//   * The byte -> class lookup is off the chain: a row's bytes are read
//     16 at a time, four blocks (64 bytes) ahead, so a main-path row of
//     64 columns is in registers before the staging completes, and each
//     step's class column (its byte address in the table) is formed from
//     the shared class map before the state it indexes is known.
//   * One thread per row, the state and H[Wh] in registers (Wh up to 8
//     is a template argument; wider banks keep H in the output rows).
//     ROWS rows per block: fewer fill more SMs at 2048 rows, but each
//     block stages its own copy of the table; 128 was the fastest of 32,
//     64, 128 and 256 on the main path's launches and at full width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_MAX = 227 * 1024;
constexpr int STATIC_SMEM = 256 * 4 + 16;  // class map + mbarrier
constexpr int COPY_BYTES = 16 * 1024;      // per bulk copy, one per lane
constexpr int AHEAD = 4;  // 16-byte blocks of a row in flight
constexpr int ROWS = 128;  // rows (threads) per block

struct Args {
  const uint8_t* data;
  int B, Lc;
  const int32_t* lens;
  const int32_t* toff;  // null: every row starts at toff_all
  int toff_all;
  // The kernel's layout: trans_bytes of 16-bit entries [S, C], then
  // accept_bytes of step accepts [S, Wh]; both multiples of 16 bytes.
  const uint8_t* layout;
  int trans_bytes, accept_bytes;
  const int32_t* byte_cls;
  int C, Wh;
  int shift;  // 1: entry = next << 1 | flag; 0: entry = next
  const int32_t* state_in;
  const uint32_t* H_in;
  int32_t* state_out;
  uint32_t* H_out;
  int vec;  // rows are 16-byte aligned: read them 16 bytes at a time
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

template <bool SMEM, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (SMEM) return *p;
  return __ldg(p);
}

template <int WH, bool SMEM>
__global__ void dfa_chunk_kernel(const Args a) {
  extern __shared__ uint4 layout_s[];
  __shared__ int32_t cls_s[256];
  __shared__ uint64_t bar;
  const int nbytes = a.trans_bytes + a.accept_bytes;
  const uint32_t mb = smem_addr(&bar);
  if constexpr (SMEM) {
    // Thread 0 sets up the mbarrier (one arrival, which also expects
    // every byte); the first warp's lanes each issue one bulk copy.
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mb),
          "r"(nbytes)
          : "memory");
    }
    __syncthreads();
    for (int off = threadIdx.x * COPY_BYTES; threadIdx.x < 32 && off < nbytes;
         off += 32 * COPY_BYTES) {
      const int n = nbytes - off < COPY_BYTES ? nbytes - off : COPY_BYTES;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(layout_s) + off),
          "l"(reinterpret_cast<uint64_t>(a.layout + off)), "r"(n), "r"(mb)
          : "memory");
    }
  }

  // The row's global loads, while the table is on its way.
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  int steps = 0, s = 0;
  const uint8_t* row = a.data;
  uint32_t H[WH > 0 ? WH : 1];
  uint4 blk[AHEAD];  // the row's next AHEAD blocks of 16 bytes
  if (b < a.B) {
    const long long t0 = a.toff ? a.toff[b] : a.toff_all;
    const long long live = (long long)a.lens[b] - t0;
    steps = live <= 0 ? 0 : (live < a.Lc ? (int)live : a.Lc);
    row += (size_t)b * a.Lc;
    s = a.state_in[b];
    if constexpr (WH > 0) {
#pragma unroll
      for (int k = 0; k < WH; ++k) H[k] = a.H_in[(size_t)b * WH + k];
    } else {
      for (int k = 0; k < a.Wh; ++k)
        a.H_out[(size_t)b * a.Wh + k] = a.H_in[(size_t)b * a.Wh + k];
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) blk[k] = load16(row, 16 * k, steps, a.vec);
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls_s[i] = a.byte_cls[i];
  __syncthreads();  // the class map
  if constexpr (SMEM) mbar_wait(mb, 0);
  if (b >= a.B) return;

  const uint8_t* tab = SMEM ? reinterpret_cast<const uint8_t*>(layout_s)
                            : a.layout;
  const uint32_t* acc = reinterpret_cast<const uint32_t*>(tab + a.trans_bytes);
  const int C2 = 2 * a.C, sh = a.shift;
  const uint32_t unflagged = sh ? 0u : 1u;
  uint32_t* Hg = a.H_out + (size_t)b * a.Wh;  // WH == 0 only
  uint32_t f = 1;  // the carried state's accepts carry no flag
  auto step = [&](uint32_t byte) {
    // The class's column, off the chain: the entry is then one
    // multiply-add of the state away.
    const uint8_t* col = tab + 2 * cls_s[byte];
    if (f) {
      const uint32_t* p = acc + (size_t)s * (WH > 0 ? WH : a.Wh);
      if constexpr (WH > 0) {
#pragma unroll
        for (int k = 0; k < WH; ++k) H[k] |= ld<SMEM>(p + k);
      } else {
        for (int k = 0; k < a.Wh; ++k) Hg[k] |= ld<SMEM>(p + k);
      }
    }
    const uint32_t e =
        ld<SMEM>(reinterpret_cast<const uint16_t*>(col + s * C2));
    s = (int)(e >> sh);
    f = (e | unflagged) & 1u;
  };

  int base = 0;
  for (; base + 16 <= steps; base += 16) {
    const uint4 cur = blk[0];
#pragma unroll
    for (int k = 0; k + 1 < AHEAD; ++k) blk[k] = blk[k + 1];
    blk[AHEAD - 1] = load16(row, base + 16 * AHEAD, steps, a.vec);
    const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) step((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
  }
  const int rest = steps - base;
  if (rest > 0) {
    const uint4 cur = blk[0];
    const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int j = 0; j < 15; ++j)
      if (j < rest) step((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
  }
  a.state_out[b] = s;
  if constexpr (WH > 0) {
#pragma unroll
    for (int k = 0; k < WH; ++k) a.H_out[(size_t)b * WH + k] = H[k];
  }
}

template <int WH, bool SMEM>
cudaError_t launch(const Args& a, cudaStream_t st) {
  auto kern = dfa_chunk_kernel<WH, SMEM>;
  const int dyn = SMEM ? a.trans_bytes + a.accept_bytes : 0;
  if (SMEM) {
    if (dyn + STATIC_SMEM > SMEM_MAX) return cudaErrorInvalidValue;
    static int dyn_set = 48 * 1024 - STATIC_SMEM;
    if (dyn > dyn_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
      if (e != cudaSuccess) return e;
      dyn_set = dyn;
    }
  } else {
    static bool carved = false;  // as much of the SM's 256 KB for L1
    if (!carved) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
      if (e != cudaSuccess) return e;
      carved = true;
    }
  }
  kern<<<(a.B + ROWS - 1) / ROWS, ROWS, dyn, st>>>(a);
  return cudaGetLastError();
}

template <bool SMEM>
cudaError_t launch_wh(const Args& a, cudaStream_t st) {
  switch (a.Wh) {
    case 1: return launch<1, SMEM>(a, st);
    case 2: return launch<2, SMEM>(a, st);
    case 3: return launch<3, SMEM>(a, st);
    case 4: return launch<4, SMEM>(a, st);
    case 5: return launch<5, SMEM>(a, st);
    case 6: return launch<6, SMEM>(a, st);
    case 7: return launch<7, SMEM>(a, st);
    case 8: return launch<8, SMEM>(a, st);
  }
  return launch<0, SMEM>(a, st);
}

}  // namespace

// The contract of the JAX package's chunk walk; the table arrives in the
// kernel's layout (`layout`, with the byte sizes of its two blocks and
// its entry `shift`), staged into shared memory when it fits there.
// `toff` may be null: every row then starts at `toff_all`.
extern "C" int pingoo_bitsplit_dfa_chunk(
    const void* data, int B, int Lc, const void* lens, const void* toff,
    int toff_all, const void* layout, int trans_bytes, int accept_bytes,
    const void* byte_cls, int C, int Wh, int shift, const void* state_in,
    const void* H_in, void* state_out, void* H_out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Wh < 1 || (shift != 0 && shift != 1) ||
      ((trans_bytes | accept_bytes) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(layout) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)data, B, Lc, (const int32_t*)lens,
               (const int32_t*)toff, toff_all, (const uint8_t*)layout,
               trans_bytes, accept_bytes, (const int32_t*)byte_cls, C, Wh,
               shift, (const int32_t*)state_in, (const uint32_t*)H_in,
               (int32_t*)state_out, (uint32_t*)H_out,
               Lc % 16 == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0};
  cudaStream_t st = (cudaStream_t)stream;
  const bool in_smem = trans_bytes + accept_bytes + STATIC_SMEM <= SMEM_MAX;
  return (int)(in_smem ? launch_wh<true>(a, st) : launch_wh<false>(a, st));
}

extern "C" const char* pingoo_bitsplit_dfa_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
