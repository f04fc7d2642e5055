// Bit-parallel NFA advance (the sticky-accept algebra of
// compiler/nfa.py) over one [B, Lc] byte chunk whose first column sits
// at global position toff[b]; returns the new [B, W] state.
//
// Replaces the Pallas kernel pingoo_tpu/ops/pallas_scan.py `_kernel`
// (wrapper `fused_scan_chunk`) with the same contract. Per live byte
// (0 <= t < len, t = toff + column):
//     adv  = (S << 1) | init_unanchored | (t == 0 ? init_anchored : 0)
//     adv |= carry_mask & (pre-step bit 31 of word w-1)
//     passes x 1+extra: x = (adv & opt) + opt; adv |= x ^ opt;
//                       between passes adv |= carry_mask & (x < opt of w-1)
//     S    = (adv | (S & rep)) & cls_table[cls_map[byte]]
//
// Design: one warp per row. Word w lives in lane w / K, slot w % K (K =
// ceil(W / 32) words per lane, a template argument), so a word's left
// neighbour is in the same lane except for slot 0, whose neighbour is
// the previous lane's last slot: one __shfl_up_sync per carry. The
// shift carry reads the PRE-step top bit of word w-1, and the escape
// carry of pass p reads pass p's `x < opt` of word w-1 before pass p+1.
// The class map and the [C, W] class table (26 KB for the url bank) sit
// in shared memory. All lanes of a warp share the row, so the length
// gate is warp-uniform: the kernel walks only the row's live columns,
// which are one contiguous run. PAIR unrolls the walk two columns per
// iteration (the TPU kernel's pair stepping); a trailing odd column is
// skipped structurally, never read as a pad byte, so both steppings give
// the same state.
//
// What bounds it on an H100: the dependent chain of Lc steps per row
// (each ~10 + 6 * passes integer ops per word plus one shared-memory
// lookup and one or two shuffles), i.e. latency; the bytes moved are
// B * Lc input bytes and 2 * B * W * 4 state bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <int K, bool PAIR>
__global__ void nfa_chunk_kernel(
    const uint8_t* __restrict__ data, int B, int Lc,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ toff,
    const int32_t* __restrict__ cls_map, const uint32_t* __restrict__ cls_table,
    int C, int W, const uint32_t* __restrict__ init_a,
    const uint32_t* __restrict__ init_u, const uint32_t* __restrict__ opt,
    const uint32_t* __restrict__ rep, const uint32_t* __restrict__ carry,
    int passes, int has_carry, int table_in_smem,
    const uint32_t* __restrict__ state_in, uint32_t* __restrict__ state_out) {
  extern __shared__ uint32_t smem[];
  int32_t* cmap = reinterpret_cast<int32_t*>(smem);
  uint32_t* tab_s = smem + 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cmap[i] = cls_map[i];
  if (table_in_smem) {
    for (int i = threadIdx.x; i < C * W; i += blockDim.x) tab_s[i] = cls_table[i];
  }
  __syncthreads();
  const uint32_t* tab = table_in_smem ? tab_s : cls_table;

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int w0 = lane * K;

  uint32_t S[K], ia[K], iu[K], op[K], rp[K], cm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = w0 + k;
    const bool ok = w < W;
    S[k] = ok ? state_in[(size_t)b * W + w] : 0u;
    ia[k] = ok ? init_a[w] : 0u;
    iu[k] = ok ? init_u[w] : 0u;
    op[k] = ok ? opt[w] : 0u;
    rp[k] = ok ? rep[w] : 0u;
    cm[k] = ok ? carry[w] : 0u;
  }

  const long long t0 = toff[b];
  const long long len = lens[b];
  // Live columns: 0 <= t0 + i < len, one contiguous run [lo, hi).
  long long lo = t0 < 0 ? -t0 : 0;
  long long hi = len - t0;
  if (hi > Lc) hi = Lc;
  const uint8_t* row = data + (size_t)b * Lc;

  auto step = [&](int i) {
    const bool at0 = (t0 + i) == 0;
    const uint32_t* bc = tab + (size_t)cmap[row[i]] * W + w0;
    // Pre-step top bit of the previous lane's last word (shift carry).
    uint32_t top_prev = __shfl_up_sync(FULL, S[K - 1] >> 31, 1);
    if (lane == 0) top_prev = 0u;
    uint32_t adv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      adv[k] = (S[k] << 1) | iu[k] | (at0 ? ia[k] : 0u);
    }
    if (has_carry) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t cin = k ? (S[k - 1] >> 31) : top_prev;
        adv[k] |= cin & cm[k];
      }
    }
    for (int p = 0; p < passes; ++p) {
      uint32_t esc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t x = (adv[k] & op[k]) + op[k];  // wraps mod 2^32
        esc[k] = x < op[k] ? 1u : 0u;
        adv[k] |= x ^ op[k];
      }
      if (has_carry && p + 1 < passes) {
        uint32_t esc_prev = __shfl_up_sync(FULL, esc[K - 1], 1);
        if (lane == 0) esc_prev = 0u;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint32_t ein = k ? esc[k - 1] : esc_prev;
          adv[k] |= ein & cm[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t m = (w0 + k < W) ? bc[k] : 0u;
      S[k] = (adv[k] | (S[k] & rp[k])) & m;
    }
  };

  if (PAIR) {
    for (long long i = lo; i < hi; i += 2) {
      step((int)i);
      if (i + 1 < hi) step((int)(i + 1));  // odd tail: no pad column
    }
  } else {
    for (long long i = lo; i < hi; ++i) step((int)i);
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = w0 + k;
    if (w < W) state_out[(size_t)b * W + w] = S[k];
  }
}

struct Args {
  const uint8_t* data;
  int B, Lc;
  const int32_t *lens, *toff, *cls_map;
  const uint32_t* cls_table;
  int C, W;
  const uint32_t *init_a, *init_u, *opt, *rep, *carry;
  int passes, has_carry;
  const uint32_t* state_in;
  uint32_t* state_out;
};

constexpr int ROWS_PER_BLOCK = 8;  // 8 warps, one row each
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

template <int K, bool PAIR>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const size_t tab_bytes = (size_t)a.C * a.W * sizeof(uint32_t);
  const size_t with_tab = 256 * sizeof(int32_t) + tab_bytes;
  const int in_smem = with_tab <= SMEM_MAX ? 1 : 0;
  const size_t smem = in_smem ? with_tab : 256 * sizeof(int32_t);
  auto kern = nfa_chunk_kernel<K, PAIR>;
  if (smem > SMEM_DEFAULT) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const dim3 block(32 * ROWS_PER_BLOCK);
  kern<<<grid, block, smem, st>>>(a.data, a.B, a.Lc, a.lens, a.toff,
                                  a.cls_map, a.cls_table, a.C, a.W,
                                  a.init_a, a.init_u, a.opt, a.rep, a.carry,
                                  a.passes, a.has_carry, in_smem,
                                  a.state_in, a.state_out);
  return cudaGetLastError();
}

template <bool PAIR>
cudaError_t dispatch(const Args& a, cudaStream_t st) {
  const int k = (a.W + 31) / 32;
  if (k <= 1) return launch<1, PAIR>(a, st);
  if (k <= 2) return launch<2, PAIR>(a, st);
  if (k <= 3) return launch<3, PAIR>(a, st);
  if (k <= 4) return launch<4, PAIR>(a, st);
  if (k <= 6) return launch<6, PAIR>(a, st);
  if (k <= 8) return launch<8, PAIR>(a, st);
  if (k <= 12) return launch<12, PAIR>(a, st);
  if (k <= 16) return launch<16, PAIR>(a, st);
  return cudaErrorInvalidValue;  // wider than 512 words: refused by the wrapper
}

}  // namespace

extern "C" int pingoo_nfa_scan_chunk(
    const void* data, int B, int Lc, const void* lens, const void* toff,
    const void* cls_map, const void* cls_table, int C, int W,
    const void* init_a, const void* init_u, const void* opt, const void* rep,
    const void* carry, int passes, int has_carry, int pair,
    const void* state_in, void* state_out, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  Args a{(const uint8_t*)data, B, Lc, (const int32_t*)lens,
         (const int32_t*)toff, (const int32_t*)cls_map,
         (const uint32_t*)cls_table, C, W, (const uint32_t*)init_a,
         (const uint32_t*)init_u, (const uint32_t*)opt,
         (const uint32_t*)rep, (const uint32_t*)carry, passes, has_carry,
         (const uint32_t*)state_in, (uint32_t*)state_out};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(pair ? dispatch<true>(a, st) : dispatch<false>(a, st));
}

extern "C" const char* pingoo_nfa_scan_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
