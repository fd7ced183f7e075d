// B7: the fire-gated WKV6 decode step, by hand for Hopper.
//
// Replaces src/repro/kernels/wkv6/step.py wkv6_step_events_pallas (body
// wkv6_step_kernel).  For each row g = (batch, head), with the fired key
// drive k carried as blk_m == 1 block events:
//
//   o  = (sum_{d<D} r u k) v + r S                (bonus + state readout)
//   S' = w S + k v^T  on live K-blocks,  w S  on dead ones
//
// Bound on the H100: bytes.  Each row reads and writes its f32 state once
// (2 * 16 KB at head_dim 64); at RWKV6-7B batch 4 (G = 256) that is 8.4 MB
// a layer-step, ~2.5 us at 3.35 TB/s: one DRAM round trip and the launch
// are a large share of it, so the design keeps the whole state in flight
// at once and puts nothing in front of its loads.
//
// A CTA takes a row g (or a share of its columns, when a row has more
// column chunks than a CTA has threads, or kSplit asks for it).  Thread
// (y, c) owns columns 4c..4c+3 (one 16-byte chunk; 1 column where D % 4
// != 0 or a state pointer is not 16-byte aligned) of rows y, y + ny, ...
// and issues the loads of its first kRows rows, with their r, w, u, before
// anything else: at D 64 that is the whole 16 KB row, 4 float4 a thread
// of 256.  Meanwhile warp 0 zeroes a shared row buffer and scatters the
// live events into it (slots e < min(counts[g], E) only: padding slots
// repeat the last live index and are never visited), marking each one's
// block live: that is live_block_mask, derived here, so the wrapper
// launches nothing beside the kernel.  The event loads do not wait on
// counts or on each other: a lane of warp 0 loads every slot's value and
// address it will scatter (up to kScatter of each) before it stores, and
// the count only gates the stores, so the drive costs one round trip, in
// the shadow of the state's (measured: as fast as no scatter at all, and
// faster than with the event loads ahead of warp 0's state loads;
// tools/torch_pool_step_variants.py).  One barrier, then each thread
// writes S' of its chunks as float4 through round-to-nearest intrinsics
// that nvcc never contracts, so S' is bitwise the plain version's
// w[..., None] * S + k[..., None] * v  (a separate multiply, multiply and
// add); a dead block writes w S alone.
//
// The readout sum_i r_i S[i, j] and the bonus sum_d r u k reduce in one
// fixed order that does not look at liveness: each thread sums its rows
// ascending (the bonus by the threads of the first chunk), the ny partials
// are summed ascending in shared memory, o = fmaf(bonus, v, readout).  So a
// θ = 0 drive gives o and S' bitwise this kernel's output on the all-live
// drive of the same values (DESIGN.md §13's within-backend contract).
#include "mnf_common.cuh"

namespace {

constexpr int kStepThreads = 256;  // threads a CTA (at most)
constexpr int kRows = 4;           // state rows a thread holds at once
constexpr int kSplit = 1;          // CTAs a row at least (column shares)
constexpr int kScatter = 4;        // event values a lane of warp 0 loads at once

}  // namespace

// Shared memory: kbuf[nkb * bk] (the scattered key drive), lv[nkb] (live
// blocks), part[ny][D + 1] (readout partials; column D the bonus's).
template <int V>
__global__ void __launch_bounds__(kStepThreads) mnf_wkv6_step_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ counts, const float* __restrict__ r,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s,
    float* __restrict__ o, float* __restrict__ s_new, int E, int D, int bk,
    int nkb, int split, int ncc, int ny) {
  extern __shared__ float smem[];
  const int dp = nkb * bk;
  float* kbuf = smem;
  int* lv = reinterpret_cast<int*>(kbuf + dp);
  float* part = reinterpret_cast<float*>(lv + nkb);
  const int64_t g = blockIdx.x / split;
  const int c0 = (int)(blockIdx.x % split) * ncc;   // first chunk of the CTA
  const int tid = threadIdx.x;
  const int y = tid / ncc, cl = tid - y * ncc;
  const int j = (c0 + cl) * V;                       // first column
  const bool in = y < ny;        // threads past ncc * ny pad the last warp
  const bool on = in && j < D;
  const float* sg = s + g * D * D;
  float* sng = s_new + g * D * D;
  const float* rg = r + g * D;
  const float* wg = w + g * D;
  const float* ug = u + g * D;

  float sv[kRows][V], ri[kRows], wi[kRows], ui[kRows];
  auto fetch = [&](int row0) {           // rows row0, row0 + ny, ... of y
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = row0 + q * ny;
      if (on && i < D) {
        ldv<V>(sg + (int64_t)i * D + j, sv[q]);
        ri[q] = rg[i], wi[q] = wg[i], ui[q] = ug[i];
      }
    }
  };
  // warp 0 (whole warps) scatters the drive and marks the live blocks:
  // it loads kScatter * 32 slots' values and addresses at once, stores
  // them, and goes on while slots are left
  const int ne = E * bk;
  int cnt = 0;
  float ex[kScatter];
  int ee[kScatter], eb[kScatter];
  auto load_events = [&](int base) {
#pragma unroll
    for (int q = 0; q < kScatter; ++q) {
      const int c = base + q * 32 + tid;
      ee[q] = c / bk;
      if (c < ne) ex[q] = vals[g * ne + c], eb[q] = idx[g * E + ee[q]];
    }
  };
  auto store_events = [&](int base) {
#pragma unroll
    for (int q = 0; q < kScatter; ++q) {
      const int c = base + q * 32 + tid;
      if (c < ne && ee[q] < cnt && eb[q] >= 0 && eb[q] < nkb) {
        const int jj = c - ee[q] * bk;
        kbuf[eb[q] * bk + jj] = ex[q];
        if (jj == 0) lv[eb[q]] = 1;
      }
    }
  };
  fetch(y);                            // the state first

  float vj[V];
#pragma unroll
  for (int c = 0; c < V; ++c) vj[c] = on ? v[g * D + j + c] : 0.f;
  if (tid < 32) {
    cnt = (int)min((int64_t)counts[g], (int64_t)E);
    load_events(0);
    for (int c = tid; c < dp; c += 32) kbuf[c] = 0.f;
    for (int c = tid; c < nkb; c += 32) lv[c] = 0;
    __syncwarp();
    for (int base = 0;;) {
      store_events(base);
      base += kScatter * 32;
      if (base >= ne) break;
      load_events(base);
    }
  }
  __syncthreads();

  float acc[V], bonus = 0.f;
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  for (int row0 = y;;) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = row0 + q * ny;
      if (!on || i >= D) break;
      const float ki = kbuf[i];
      const bool live = lv[i / bk] != 0;
      float x[V];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        acc[c] = fmaf(ri[q], sv[q][c], acc[c]);
        const float dec = __fmul_rn(wi[q], sv[q][c]);
        x[c] = live ? __fadd_rn(dec, __fmul_rn(ki, vj[c])) : dec;
      }
      stv<V>(sng + (int64_t)i * D + j, x);
      if (cl == 0) bonus = fmaf(__fmul_rn(ri[q], ui[q]), ki, bonus);
    }
    row0 += kRows * ny;
    if (!on || row0 >= D) break;
    fetch(row0);
  }
  if (on) {
#pragma unroll
    for (int c = 0; c < V; ++c) part[y * (D + 1) + j + c] = acc[c];
  }
  if (in && cl == 0) part[y * (D + 1) + D] = bonus;
  __syncthreads();
  for (int jj = c0 * V + tid; jj < min(D, (c0 + ncc) * V);
       jj += blockDim.x) {
    float sum = 0.f, att = 0.f;
    for (int yy = 0; yy < ny; ++yy) {
      sum = __fadd_rn(sum, part[yy * (D + 1) + jj]);
      att = __fadd_rn(att, part[yy * (D + 1) + D]);
    }
    o[g * D + jj] = fmaf(att, v[g * D + jj], sum);
  }
}

// vals (G, E, 1, bk) f32, idx (G, E) / counts (G,) int32, r, v, w, u
// (G, D) f32, s (G, D, D) f32 -> o (G, D), s_new (G, D, D).
extern "C" int mnf_wkv6_step(const void* vals, const void* idx,
                             const void* counts, const void* r, const void* v,
                             const void* w, const void* u, const void* s,
                             void* o, void* s_new, int64_t G, int64_t E,
                             int64_t D, int64_t bk, int64_t nkb,
                             void* stream) {
  if (E * bk >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const int V = D % 4 == 0 && (uintptr_t)s % 16 == 0 &&
                        (uintptr_t)s_new % 16 == 0
                    ? 4
                    : 1;
  // column chunks a CTA: the row's, cut into kSplit shares at least and
  // into as many as keep a share within one CTA's threads
  const int64_t nc = D / V;
  int64_t split = kSplit < nc ? kSplit : nc;
  while ((nc + split - 1) / split > kStepThreads) ++split;
  const int64_t ncc = (nc + split - 1) / split;
  int64_t ny = kStepThreads / ncc;
  if (ny > D) ny = D;
  const size_t smem = (size_t)(nkb * bk + nkb + ny * (D + 1)) * 4;
  if (smem > 48 << 10) return (int)cudaErrorInvalidValue;
  const unsigned threads = (unsigned)((ncc * ny + 31) / 32 * 32);
  const dim3 grid((unsigned)(G * split));
  cudaStream_t st = (cudaStream_t)stream;
#define MNF_LAUNCH(V_)                                                       \
  mnf_wkv6_step_kernel<V_><<<grid, threads, smem, st>>>(                   \
      (const float*)vals, (const int32_t*)idx, (const int32_t*)counts,       \
      (const float*)r, (const float*)v, (const float*)w, (const float*)u,    \
      (const float*)s, (float*)o, (float*)s_new, (int)E, (int)D, (int)bk,    \
      (int)nkb, (int)split, (int)ncc, (int)ny)
  if (V == 4)
    MNF_LAUNCH(4);
  else
    MNF_LAUNCH(1);
#undef MNF_LAUNCH
  return (int)cudaGetLastError();
}
