// B7: the fire-gated WKV6 decode step, by hand for Hopper.
//
// Replaces src/repro/kernels/wkv6/step.py wkv6_step_events_pallas (body
// wkv6_step_kernel).  For each row g = (batch, head), with the fired key
// drive k carried as blk_m == 1 block events:
//
//   o  = (sum_{d<D} r u k) v + r S                (bonus + state readout)
//   S' = w S + k v^T  on live K-blocks,  w S  on dead ones
//
// One CTA per row g.  The CTA scatters its live events (slots e <
// counts[g] only; padding slots repeat the last live index and are never
// visited) into a shared row buffer, stages r, u, v, w and the live mask
// (live_block_mask, read in place of the TPU's scalar prefetch) in shared
// memory, then walks the (D, D) state once: thread (x, y) owns columns j =
// x, x + blockDim.x, ... and rows i = y, y + blockDim.y, ...; it reads
// S[i, j] (neighbouring threads, neighbouring columns: coalesced), writes
// S'[i, j] and accumulates r_i S[i, j] for the readout, whose per-row-slice
// partials are summed in shared memory in a fixed order.  The state update
// uses round-to-nearest intrinsics that nvcc never contracts, so S' is
// bitwise the plain version's  w[..., None] * S + k[..., None] * v  (a
// separate multiply, multiply and add); a dead block writes w S alone.
//
// Bound on the H100: bytes.  Each row reads and writes its f32 state once
// (2 * 16 KB at head_dim 64); at RWKV6-7B batch 4 (G = 256) that is 8.4 MB
// per layer-step, ~2.5 us at 3.35 TB/s, so launch overhead dominates.
#include "mnf_common.cuh"

__global__ void mnf_wkv6_step_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ live,
    const float* __restrict__ r, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s, float* __restrict__ o,
    float* __restrict__ s_new, int64_t E, int D, int bk, int nkb) {
  extern __shared__ float smem[];
  const int dp = nkb * bk;
  float* kbuf = smem;                    // (dp,) scattered key drive
  float* rs = kbuf + dp;                 // (D,) each
  float* us = rs + D;
  float* vs = us + D;
  float* ws = vs + D;
  float* part = ws + D;                  // (blockDim.y, D) readout partials
  int* lv = (int*)(part + blockDim.y * D);  // (nkb,) live mask
  const int64_t g = blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int c = tid; c < dp; c += nt) kbuf[c] = 0.f;
  for (int c = tid; c < D; c += nt) {
    rs[c] = r[g * D + c];
    us[c] = u[g * D + c];
    vs[c] = v[g * D + c];
    ws[c] = w[g * D + c];
  }
  for (int c = tid; c < nkb; c += nt) lv[c] = live[g * nkb + c];
  __syncthreads();
  const int cnt = (int)min((int64_t)counts[g], E);
  for (int c = tid; c < cnt * bk; c += nt) {
    const int e = c / bk, j = c - e * bk;
    kbuf[idx[g * E + e] * bk + j] = vals[(g * E + e) * bk + j];
  }
  __syncthreads();

  const float* sg = s + g * D * D;
  float* sng = s_new + g * D * D;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float vj = vs[j];
    float acc = 0.f;
    for (int i = threadIdx.y; i < D; i += blockDim.y) {
      const float sij = sg[(int64_t)i * D + j];
      acc = fmaf(rs[i], sij, acc);
      const float dec = __fmul_rn(ws[i], sij);
      sng[(int64_t)i * D + j] =
          lv[i / bk] ? __fadd_rn(dec, __fmul_rn(kbuf[i], vj)) : dec;
    }
    part[threadIdx.y * D + j] = acc;
  }
  __syncthreads();
  if (threadIdx.y != 0) return;
  float att = 0.f;                       // reduced over the logical D only
  for (int d = 0; d < D; ++d) att = fmaf(__fmul_rn(rs[d], us[d]), kbuf[d], att);
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float sum = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) sum = __fadd_rn(sum, part[y * D + j]);
    o[g * D + j] = fmaf(att, vs[j], sum);
  }
}

// vals (G, E, 1, bk) f32, idx (G, E) / counts (G,) / live (G, nkb) int32,
// r, v, w, u (G, D) f32, s (G, D, D) f32 -> o (G, D), s_new (G, D, D).
extern "C" int mnf_wkv6_step(const void* vals, const void* idx,
                             const void* counts, const void* live,
                             const void* r, const void* v, const void* w,
                             const void* u, const void* s, void* o,
                             void* s_new, int64_t G, int64_t E, int64_t D,
                             int64_t bk, int64_t nkb, void* stream) {
  const int bx = (int)(D < 128 ? D : 128);
  int by = 256 / bx;
  if (by > D) by = (int)D;
  if (by < 1) by = 1;
  const size_t smem = (size_t)(nkb * bk + 4 * D + by * D) * sizeof(float) +
                      (size_t)nkb * sizeof(int);
  mnf_wkv6_step_kernel<<<dim3((unsigned)G), dim3(bx, by), smem,
                         (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)idx, (const int32_t*)counts,
      (const int32_t*)live, (const float*)r, (const float*)v,
      (const float*)w, (const float*)u, (const float*)s, (float*)o,
      (float*)s_new, E, (int)D, (int)bk, (int)nkb);
  return (int)cudaGetLastError();
}
