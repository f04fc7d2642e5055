// Bitsplit-DFA walk over one [B, Lc] byte chunk, carrying the DFA state
// and the sticky accept accumulator H in and out.
//
// Replaces the Pallas kernel pingoo_tpu/ops/bitsplit_dfa.py `_dfa_kernel`
// (wrapper `_fused_dfa`), with the chunk contract of `dfa_scan_chunk`:
// while t_offset + i < len,
//     H |= step_accept[state];  state = trans[state, byte_cls[byte]]
// The absolute-end accepts (`end_accept[state]`) are applied afterwards
// by `dfa_finalize`, exactly as in the chunked reference.
//
// Design: one thread per row; the state and H[Wh] stay in registers for
// the whole chunk (Wh is a template argument up to 8; wider banks carry H
// in the output buffer). The TPU kernel selected the next state with a
// one-hot matmul; here it is a plain indexed load: `trans` is int32
// [S, C] read through __ldg — the url/path tables (1009x58 and
// 2852x57 entries, up to 650 KB) do not fit in shared memory and stay in
// L2. The 256-entry byte -> class map sits in shared memory.
//
// What bounds it on an H100: the dependent chain of Lc table loads per
// row (latency); the bytes moved are B*L input bytes and B*Wh*4 output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int WH>
__global__ void dfa_chunk_kernel(const uint8_t* __restrict__ data, int B,
                                 int Lc, const int32_t* __restrict__ lens,
                                 const int32_t* __restrict__ toff,
                                 const int32_t* __restrict__ trans,
                                 const int32_t* __restrict__ byte_cls,
                                 const uint32_t* __restrict__ step_accept,
                                 int C, int Wh,
                                 const int32_t* __restrict__ state_in,
                                 const uint32_t* __restrict__ H_in,
                                 int32_t* __restrict__ state_out,
                                 uint32_t* __restrict__ H_out) {
  __shared__ int32_t cls_s[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cls_s[i] = byte_cls[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long live = (long long)lens[b] - (long long)toff[b];
  const int steps = live <= 0 ? 0 : (live < Lc ? (int)live : Lc);
  const uint8_t* row = data + (size_t)b * Lc;
  int s = state_in[b];
  if (WH > 0) {
    uint32_t H[WH > 0 ? WH : 1];
#pragma unroll
    for (int k = 0; k < WH; ++k) H[k] = H_in[(size_t)b * WH + k];
    for (int i = 0; i < steps; ++i) {
      const uint32_t* acc = step_accept + (size_t)s * WH;
#pragma unroll
      for (int k = 0; k < WH; ++k) H[k] |= __ldg(acc + k);
      s = __ldg(trans + (size_t)s * C + cls_s[__ldg(row + i)]);
    }
#pragma unroll
    for (int k = 0; k < WH; ++k) H_out[(size_t)b * WH + k] = H[k];
  } else {
    // Any width: H lives in the output rows.
    uint32_t* H = H_out + (size_t)b * Wh;
    for (int k = 0; k < Wh; ++k) H[k] = H_in[(size_t)b * Wh + k];
    for (int i = 0; i < steps; ++i) {
      const uint32_t* acc = step_accept + (size_t)s * Wh;
      for (int k = 0; k < Wh; ++k) H[k] |= __ldg(acc + k);
      s = __ldg(trans + (size_t)s * C + cls_s[__ldg(row + i)]);
    }
  }
  state_out[b] = s;
}

template <int WH>
void launch(dim3 grid, dim3 block, cudaStream_t st, const uint8_t* data,
            int B, int Lc, const int32_t* lens, const int32_t* toff,
            const int32_t* trans, const int32_t* byte_cls,
            const uint32_t* step_accept, int C, int Wh,
            const int32_t* state_in, const uint32_t* H_in,
            int32_t* state_out, uint32_t* H_out) {
  dfa_chunk_kernel<WH><<<grid, block, 0, st>>>(
      data, B, Lc, lens, toff, trans, byte_cls, step_accept, C, Wh,
      state_in, H_in, state_out, H_out);
}

}  // namespace

extern "C" int pingoo_bitsplit_dfa_chunk(
    const void* data, int B, int Lc, const void* lens, const void* toff,
    const void* trans, const void* byte_cls, const void* step_accept, int C,
    int Wh, const void* state_in, const void* H_in, void* state_out,
    void* H_out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const dim3 grid((B + threads - 1) / threads), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
#define PINGOO_DFA_ARGS                                                     \
  grid, block, st, (const uint8_t*)data, B, Lc, (const int32_t*)lens,      \
      (const int32_t*)toff, (const int32_t*)trans, (const int32_t*)byte_cls, \
      (const uint32_t*)step_accept, C, Wh, (const int32_t*)state_in,       \
      (const uint32_t*)H_in, (int32_t*)state_out, (uint32_t*)H_out
  switch (Wh) {
    case 1: launch<1>(PINGOO_DFA_ARGS); break;
    case 2: launch<2>(PINGOO_DFA_ARGS); break;
    case 3: launch<3>(PINGOO_DFA_ARGS); break;
    case 4: launch<4>(PINGOO_DFA_ARGS); break;
    case 5: launch<5>(PINGOO_DFA_ARGS); break;
    case 6: launch<6>(PINGOO_DFA_ARGS); break;
    case 7: launch<7>(PINGOO_DFA_ARGS); break;
    case 8: launch<8>(PINGOO_DFA_ARGS); break;
    default: launch<0>(PINGOO_DFA_ARGS); break;
  }
#undef PINGOO_DFA_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* pingoo_bitsplit_dfa_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
