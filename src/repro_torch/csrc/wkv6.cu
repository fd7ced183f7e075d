// B9 / B9': the WKV6 recurrence (RWKV6 prefill form), by hand for Hopper.
//
// Replaces src/repro/kernels/wkv6/kernel.py wkv6_pallas (body wkv6_kernel)
// and the multi-head pallas_call of src/repro/kernels/wkv6/ops.py wkv6: one
// C entry serves both, row g taking the bonus row u[g % H] (H = 1 for the
// single-head op).  For each row g = (batch, head), head dim D, t = 0..T-1:
//
//   o_t = (sum_{d<D} r_t u k_t) v_t + r_t^T S          (bonus + readout)
//   S  <- diag(w_t) S + k_t v_t^T                      (decay + increment)
//
// The TPU keeps the (D, D) state in VMEM across a sequential chunk grid
// dimension and pads T with w = 1.  Here one CTA owns one row for the whole
// sequence: thread (x, y) holds column j = x, rows i = y, y + by, ... of S
// in registers (16 of them at D = 64, by = 4), so the state never leaves
// the SM until the end.  The CTA stages kChunk tokens of r, k, v, w in
// shared memory at a time (coalesced row loads); one thread a token sums
// each staged token's bonus  sum r u k  in order d = 0..D-1.  Then each
// token costs one barrier: every thread writes its column partial of r^T S
// (fmaf over its rows, ascending), the y = 0 threads sum the by partials
// in order and write o, and every thread updates its own state elements
// with round-to-nearest intrinsics that nvcc never contracts, so S is
// bitwise the plain version's  w[..., None] * S + k[..., None] * v  (a
// separate multiply, multiply and add).  The partials are double-buffered,
// so the next token may write while this one is read.  T needs no padding:
// the loop ends at T.
//
// Bound on the H100: bytes at prompt lengths, operations (~5 D^2 per row
// and token) only for T >> D.  At RWKV6-7B batch 4 (G = 256 rows of D =
// 64), prompt 32: r, k, v, w (4 x 2.1 MB f32) and o (2.1 MB) plus S out
// (4.2 MB) — ~14.7 MB, ~4.4 us at 3.35 TB/s.  Each token's barrier and
// D / by dependent fmaf's make the walk latency-bound.
#include "mnf_common.cuh"

namespace {
constexpr int kMaxD = 64;       // widest head: S lives in registers
constexpr int kChunk = 32;      // tokens staged in shared memory at a time
constexpr int kThreads = 256;
constexpr int kRows = kMaxD * kMaxD / kThreads;  // state rows per thread
}  // namespace

__global__ void __launch_bounds__(kThreads) mnf_wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_out, int64_t T, int D,
    int H) {
  __shared__ float rs[kChunk * kMaxD], ks[kChunk * kMaxD];
  __shared__ float vs[kChunk * kMaxD], ws[kChunk * kMaxD];
  __shared__ float us[kMaxD], att[kChunk];
  __shared__ float part[2 * kThreads];   // (2, by, D) readout partials
  const int64_t g = blockIdx.x;
  const int j = threadIdx.x, y = threadIdx.y, by = blockDim.y;
  const int tid = y * D + j, nt = D * by;
  const float* s0g = s0 != nullptr ? s0 + g * D * D : nullptr;
  float s[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = y + m * by;
    s[m] = (i < D && s0g != nullptr) ? s0g[(int64_t)i * D + j] : 0.f;
  }
  for (int c = tid; c < D; c += nt) us[c] = u[(g % H) * D + c];
  int buf = 0;
  for (int64_t t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = (int)min((int64_t)kChunk, T - t0);
    __syncthreads();                     // the last chunk's readers are done
    const int64_t off = (g * T + t0) * D;
    for (int c = tid; c < tc * D; c += nt) {
      rs[c] = r[off + c];
      ks[c] = k[off + c];
      vs[c] = v[off + c];
      ws[c] = w[off + c];
    }
    __syncthreads();
    for (int tt = tid; tt < tc; tt += nt) {  // the bonus, a token a thread
      const float* rt = rs + tt * D;
      const float* kt = ks + tt * D;
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(__fmul_rn(rt[d], us[d]), kt[d], a);
      att[tt] = a;                       // read after the token's barrier
    }
    for (int tt = 0; tt < tc; ++tt) {
      const float* rt = rs + tt * D;
      const float* kt = ks + tt * D;
      const float* wt = ws + tt * D;
      const float vj = vs[tt * D + j];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = y + m * by;
        if (i < D) acc = fmaf(rt[i], s[m], acc);
      }
      part[buf * kThreads + y * D + j] = acc;
      __syncthreads();
      if (y == 0) {
        float sum = 0.f;
        for (int q = 0; q < by; ++q)
          sum = __fadd_rn(sum, part[buf * kThreads + q * D + j]);
        o[off + (int64_t)tt * D + j] = fmaf(att[tt], vj, sum);
      }
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int i = y + m * by;
        if (i < D)
          s[m] = __fadd_rn(__fmul_rn(wt[i], s[m]), __fmul_rn(kt[i], vj));
      }
      buf ^= 1;
    }
  }
  float* sg = s_out + g * D * D;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int i = y + m * by;
    if (i < D) sg[(int64_t)i * D + j] = s[m];
  }
}

// r, k, v, w (G, T, D) f32, u (H, D) f32, s0 (G, D, D) f32 or null (zeros)
// -> o (G, T, D), s_out (G, D, D).  D <= 64.
extern "C" int mnf_wkv6(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* o, void* s_out, int64_t G, int64_t T,
                        int64_t D, int64_t H, void* stream) {
  int by = (int)(kThreads / D);
  if (by > D) by = (int)D;
  mnf_wkv6_kernel<<<dim3((unsigned)G), dim3((unsigned)D, (unsigned)by), 0,
                    (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)o, (float*)s_out, T,
      (int)D, (int)H);
  return (int)cudaGetLastError();
}
