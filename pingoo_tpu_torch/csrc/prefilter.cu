// Stage-A literal prefilter: packed multi-literal shift-AND over one
// [B, Lc] byte chunk, carrying (S, H) in and out.
//
// Replaces the Pallas kernel pingoo_tpu/ops/prefilter.py `_pf_kernel`
// (wrapper `_fused_prefilter`), with the chunk contract of
// `prefilter_scan_chunk`: per step
//     S' = ((S << 1) | init) & tab[byte]      while t_offset + i < len
//     H |= S
// Factors never span words, so every (row, word) pair is independent:
// one thread per pair, the carry in registers for the whole chunk.
//
// What bounds it on an H100: the dependent chain of Lc table lookups
// per thread (latency), not bytes — each row's bytes are read once per
// word of the bank and the [256, Wp] table (53 KB for the url bank)
// stays in L1/L2, read through __ldg. Dead columns (past the row's
// length) are skipped: the live columns of a row are a prefix.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pf_chunk_kernel(const uint8_t* __restrict__ data, int B,
                                int Lc, const int32_t* __restrict__ lens,
                                const int32_t* __restrict__ toff,
                                const uint32_t* __restrict__ init,
                                const uint32_t* __restrict__ tab, int W,
                                const uint32_t* __restrict__ S_in,
                                const uint32_t* __restrict__ H_in,
                                uint32_t* __restrict__ S_out,
                                uint32_t* __restrict__ H_out) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)B * W) return;
  const int b = (int)(gid / W);
  const int w = (int)(gid % W);
  uint32_t S = S_in[gid];
  uint32_t H = H_in[gid];
  const uint32_t ini = __ldg(init + w);
  // Column i is live while toff + i < len: a prefix of the chunk.
  const long long live = (long long)__ldg(lens + b) - (long long)__ldg(toff + b);
  const int steps = live <= 0 ? 0 : (live < Lc ? (int)live : Lc);
  const uint8_t* row = data + (size_t)b * Lc;
  for (int i = 0; i < steps; ++i) {
    const uint32_t bc = __ldg(tab + (size_t)__ldg(row + i) * W + w);
    S = ((S << 1) | ini) & bc;
    H |= S;
  }
  // A gated column leaves S as it is and still ORs it into H.
  if (Lc > 0) H |= S;
  S_out[gid] = S;
  H_out[gid] = H;
}

}  // namespace

extern "C" int pingoo_prefilter_chunk(const void* data, int B, int Lc,
                                      const void* lens, const void* toff,
                                      const void* init, const void* tab,
                                      int W, const void* S_in,
                                      const void* H_in, void* S_out,
                                      void* H_out, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  const long long n = (long long)B * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  pf_chunk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, B, Lc, (const int32_t*)lens,
      (const int32_t*)toff, (const uint32_t*)init, (const uint32_t*)tab, W,
      (const uint32_t*)S_in, (const uint32_t*)H_in, (uint32_t*)S_out,
      (uint32_t*)H_out);
  return (int)cudaGetLastError();
}

extern "C" const char* pingoo_prefilter_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
