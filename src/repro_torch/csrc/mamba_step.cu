// B8: the fire-gated Mamba decode step, by hand for Hopper.
//
// Replaces src/repro/kernels/mamba_scan/step.py mamba_step_events_pallas
// (body mamba_step_kernel).  For each batch row b, with the fired gate
// g = dt * silu(xconv) carried as blk_m == 1 block events over the DI
// channels:
//
//   h' = h dA + g B^T  on live DI-blocks,  h dA  on dead ones
//   y  = sum_{n<N} h' C
//
// The TPU walks one grid step per batch row and every DI-block inside it;
// that would be B CTAs here (4 of 132 SMs at batch 4).  Instead there is
// one CTA per (DI-block kb, row b): at Hymba-1.5B's DI = 1600, blk_k = 16,
// batch 4 that is 100 x 4 = 400 CTAs of 256 threads, each owning one
// block's bk x N contiguous state elements (neighbouring threads,
// neighbouring addresses: coalesced).  The CTA reads its live bit
// (live_block_mask, read in place of the TPU's scalar prefetch); a live
// block finds its event among the row's live slots (e < counts[b] only;
// padding slots repeat the last live index and are never visited).  The
// state update uses round-to-nearest intrinsics that nvcc never contracts,
// so h' is bitwise the plain version's  h * dA + g[..., None] * B  (a
// separate multiply, multiply and add); a dead block writes h dA alone.
// The readout keeps each h' C product in shared memory and one thread per
// channel sums its N products in order n = 0..N-1.  Channels >= DI of a
// ragged last block are masked here: no padded copies of dA or h.
//
// Bound on the H100: bytes.  Each row reads h and dA and writes h', all
// f32 (B, DI, N): 3 x 409.6 KB at batch 4, DI 1600, N 16, plus ~52 KB of
// events, B, C and y — 1.28 MB, ~0.38 us at 3.35 TB/s, so launch latency
// dominates.
#include "mnf_common.cuh"

__global__ void mnf_mamba_step_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ live,
    const float* __restrict__ da, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ h,
    float* __restrict__ y, float* __restrict__ h_new, int64_t E, int DI,
    int N, int bk, int nkb) {
  extern __shared__ float prod[];        // (bk, N) readout products
  __shared__ int slot;                   // this block's event slot, or -1
  const int kb = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  if (tid == 0) slot = -1;
  __syncthreads();
  if (live[b * nkb + kb]) {
    const int cnt = (int)min((int64_t)counts[b], E);
    for (int e = tid; e < cnt; e += blockDim.x)
      if (idx[b * E + e] == kb) slot = e;  // live slots name distinct blocks
  }
  __syncthreads();
  const int c0 = kb * bk;
  const int width = min(bk, DI - c0);    // the block's channels inside DI
  const float* gate = slot >= 0 ? vals + (b * E + slot) * bk : nullptr;
  const float* brow = bm + b * N;
  const float* crow = cm + b * N;
  for (int i = tid; i < width * N; i += blockDim.x) {
    const int c = i / N, n = i - c * N;
    const int64_t off = (b * DI + c0 + c) * N + n;
    const float dec = __fmul_rn(h[off], da[off]);
    const float hn = gate ? __fadd_rn(dec, __fmul_rn(gate[c], brow[n])) : dec;
    h_new[off] = hn;
    prod[i] = __fmul_rn(hn, crow[n]);
  }
  __syncthreads();
  for (int c = tid; c < width; c += blockDim.x) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s = __fadd_rn(s, prod[c * N + n]);
    y[b * DI + c0 + c] = s;
  }
}

// vals (B, E, 1, bk) f32, idx (B, E) / counts (B,) / live (B, nkb) int32,
// da, h (B, DI, N) f32, bm, cm (B, N) f32 -> y (B, DI), h_new (B, DI, N).
extern "C" int mnf_mamba_step(const void* vals, const void* idx,
                              const void* counts, const void* live,
                              const void* da, const void* bm, const void* cm,
                              const void* h, void* y, void* h_new, int64_t B,
                              int64_t E, int64_t DI, int64_t N, int64_t bk,
                              int64_t nkb, void* stream) {
  const size_t smem = (size_t)(bk * N) * sizeof(float);
  mnf_mamba_step_kernel<<<dim3((unsigned)nkb, (unsigned)B), 256, smem,
                          (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)idx, (const int32_t*)counts,
      (const int32_t*)live, (const float*)da, (const float*)bm,
      (const float*)cm, (const float*)h, (float*)y, (float*)h_new, E,
      (int)DI, (int)N, (int)bk, (int)nkb);
  return (int)cudaGetLastError();
}
