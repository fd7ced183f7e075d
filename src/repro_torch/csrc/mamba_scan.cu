// B10: the selective scan of the Mamba prefill, by hand for Hopper.
//
// Replaces src/repro/kernels/mamba_scan/kernel.py mamba_scan_pallas (body
// mamba_scan_kernel) with its padding wrapper mamba_scan/ops.py mamba_scan.
// For each batch row b and channel d, over the caller's precomputed
// streams da = exp(dt A), dbx = (dt x) B:
//
//   h_t = da_t h_{t-1} + dbx_t          (h: (DI, N); h_{-1} = h0, or 0)
//   y_t = sum_{n<N} h_t[:, n] c_t[n]
//
// The TPU keeps a (D_blk, N) state in VMEM and walks T in a sequential grid
// dimension.  Here one thread owns one state element (b, d, n) in a register
// and walks t = 0..T-1 itself; a CTA holds 256 / N whole channels (16 at
// Hymba's N = 16), so at Hymba-1.5B batch 4 (DI 1600) there are 100 x 4 =
// 400 CTAs of 256 threads — one thread per (row, channel) would give only
// 50 CTAs of 128 on 132 SMs.  Each thread loads the da, dbx and c of
// kSteps timesteps at once (they do not depend on h, so the loads are in
// flight together) before it walks them; neighbouring threads read
// neighbouring addresses (coalesced).  The state update uses round-to-
// nearest intrinsics that nvcc never contracts, so h is bitwise the plain
// version's  da * h + dbx  (a separate multiply and add).  The readout puts
// each h c product in shared memory (double-buffered: one barrier a step)
// and the channel's n = 0 thread sums its N products in order.  Channels
// >= DI of the last CTA are masked here: no padded copies of the streams.
// T needs no padding either: the loop ends at T.
//
// Bound on the H100: bytes.  da and dbx are read once (B, T, DI, N) f32
// each — 2 x 13.1 MB at batch 4, prompt 32, DI 1600, N 16 — plus c, h0, y
// and h: ~27.9 MB, ~8.3 us at 3.35 TB/s.  The walk is sequential in T with
// a barrier and an N-term sum a step, so latency, not bytes, sets its time.
#include "mnf_common.cuh"

namespace {
constexpr int kThreads = 256;   // threads per CTA for N <= 256
constexpr int kSteps = 8;       // timesteps loaded ahead per thread
}  // namespace

__global__ void mnf_mamba_scan_kernel(
    const float* __restrict__ da, const float* __restrict__ dbx,
    const float* __restrict__ c, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int64_t T, int DI,
    int N, int cpc) {
  extern __shared__ float prod[];        // (2, cpc * N) readout products
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ch = tid / N, n = tid - ch * N;
  const int d = blockIdx.x * cpc + ch;
  const int64_t b = blockIdx.y;
  const bool valid = d < DI;
  const int64_t step = (int64_t)DI * N;  // one timestep of da / dbx
  const int64_t base = b * T * step + (int64_t)d * N + n;
  const int64_t state = (b * DI + d) * N + n;
  float h = (valid && h0 != nullptr) ? h0[state] : 0.f;
  int buf = 0;
  for (int64_t t0 = 0; t0 < T; t0 += kSteps) {
    float a[kSteps], x[kSteps], cc[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t t = t0 + j;
      const bool in = valid && t < T;
      a[j] = in ? da[base + t * step] : 0.f;
      x[j] = in ? dbx[base + t * step] : 0.f;
      cc[j] = in ? c[(b * T + t) * N + n] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t t = t0 + j;
      if (t >= T) break;                 // the same for every thread
      if (valid) {
        h = __fadd_rn(__fmul_rn(a[j], h), x[j]);
        prod[buf * nt + tid] = __fmul_rn(h, cc[j]);
      }
      __syncthreads();
      if (valid && n == 0) {
        const float* p = prod + buf * nt + ch * N;
        float s = 0.f;
        for (int k = 0; k < N; ++k) s = __fadd_rn(s, p[k]);
        y[(b * T + t) * DI + d] = s;
      }
      buf ^= 1;                          // the next step writes the other half
    }
  }
  if (valid) h_out[state] = h;
}

// da, dbx (B, T, DI, N) f32, c (B, T, N) f32, h0 (B, DI, N) f32 or null
// (zeros) -> y (B, T, DI), h_out (B, DI, N).
extern "C" int mnf_mamba_scan(const void* da, const void* dbx, const void* c,
                              const void* h0, void* y, void* h_out,
                              int64_t B, int64_t T, int64_t DI, int64_t N,
                              void* stream) {
  const int cpc = N >= kThreads ? 1 : (int)(kThreads / N);
  const int threads = cpc * (int)N;
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  mnf_mamba_scan_kernel<<<dim3((unsigned)((DI + cpc - 1) / cpc), (unsigned)B),
                          threads, smem, (cudaStream_t)stream>>>(
      (const float*)da, (const float*)dbx, (const float*)c,
      (const float*)h0, (float*)y, (float*)h_out, T, (int)DI, (int)N, cpc);
  return (int)cudaGetLastError();
}
