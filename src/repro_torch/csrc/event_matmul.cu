// B2: the block-event multiply phase, by hand for Hopper.
//
// Replaces src/repro/kernels/event_matmul/kernel.py event_matmul_pallas
// (body event_matmul_kernel).  y[g] = sum_{e < counts[g]}
// a_vals[g, e] @ W[a_idx[g, e]*bk : +bk, :], f32 accumulate.
//
// A CTA takes one (row group g, N tile); thread (x, y) owns output column
// n = tile*blockDim.x + x of row y.  It walks only the live events of its
// group (not the padded E) and reads the weight row-block each event names,
// so only event-addressed weights leave device memory.  Neighbouring
// threads read neighbouring columns of a weight row (coalesced); the
// activation value is a broadcast.  The ragged N edge is masked, W is not
// padded.  Bound on the H100: bytes for FC layers (each weight tile read
// once per row group), f32 FMA issue for the per-tap conv layers.
#include "mnf_common.cuh"

__global__ void mnf_event_matmul_kernel(const float* __restrict__ a_vals,
                                        const int32_t* __restrict__ a_idx,
                                        const int32_t* __restrict__ counts,
                                        const float* __restrict__ w,
                                        float* __restrict__ out, int64_t E,
                                        int bm, int bk, int64_t N) {
  const int64_t g = blockIdx.x;
  const int r = threadIdx.y;
  const int64_t n = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int cnt = min((int64_t)counts[g], E);  // counts may exceed a cut capacity
  float acc = 0.f;
  for (int e = 0; e < cnt; ++e) {
    const int64_t kb = a_idx[g * E + e];
    const float* a_row = a_vals + ((g * E + e) * bm + r) * bk;
    acc = mnf_tile_dot(a_row, w + kb * bk * N + n, N, bk, acc);
  }
  out[(g * bm + r) * N + n] = acc;
}

extern "C" int mnf_event_matmul(const void* a_vals, const void* a_idx,
                                const void* counts, const void* w, void* out,
                                int64_t G, int64_t E, int64_t bm, int64_t bk,
                                int64_t N, void* stream) {
  const int tn = mnf_cols_per_cta(bm);
  dim3 block(tn, (unsigned)bm);
  dim3 grid((unsigned)G, (unsigned)((N + tn - 1) / tn));
  mnf_event_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)a_vals, (const int32_t*)a_idx, (const int32_t*)counts,
      (const float*)w, (float*)out, E, (int)bm, (int)bk, N);
  return (int)cudaGetLastError();
}
