// B2 and B5: the block-event multiply phase, by hand for Hopper.
//
// Replaces src/repro/kernels/event_matmul/kernel.py event_matmul_pallas
// (body event_matmul_kernel) and event_matmul_int8_pallas (body
// event_matmul_int8_kernel).  y[g] = sum_{e < counts[g]}
// a_vals[g, e] @ W[a_idx[g, e]*bk : +bk, :], f32 accumulate; B5's tiles are
// int8 codes dequantized at load (mnf_common.cuh MnfInt8Tile), one kernel
// body for both.
//
// A CTA takes one (row group g, N tile); thread (x, y) owns output column
// n = tile*blockDim.x + x of row y.  It walks only the live events of its
// group (not the padded E) and reads the weight row-block each event names,
// so only event-addressed weights leave device memory.  Neighbouring
// threads read neighbouring columns of a weight row (coalesced); the
// activation value is a broadcast.  The ragged N edge is masked, W is not
// padded.  Bound on the H100: bytes for FC layers (each weight tile read
// once per row group), f32 FMA issue for the per-tap conv layers; int8
// tiles cut the activation bytes 4x, not the weight bytes that dominate.
#include "mnf_common.cuh"

template <typename Tile>
__global__ void mnf_event_matmul_kernel(
    const typename Tile::T* __restrict__ a_vals,
    const int32_t* __restrict__ a_idx, const int32_t* __restrict__ counts,
    const float* __restrict__ scale, const int32_t* __restrict__ zero_point,
    const float* __restrict__ w, float* __restrict__ out, int64_t E, int bm,
    int bk, int64_t N) {
  const int64_t g = blockIdx.x;
  const int r = threadIdx.y;
  const int64_t n = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Tile tile(scale, zero_point);
  const int cnt = min((int64_t)counts[g], E);  // counts may exceed a cut capacity
  float acc = 0.f;
  for (int e = 0; e < cnt; ++e) {
    const int64_t kb = a_idx[g * E + e];
    const typename Tile::T* a_row = a_vals + ((g * E + e) * bm + r) * bk;
    acc = mnf_tile_dot(a_row, w + kb * bk * N + n, N, bk, acc, tile);
  }
  out[(g * bm + r) * N + n] = acc;
}

template <typename Tile>
static int launch_event_matmul(const void* a_vals, const void* a_idx,
                               const void* counts, const void* scale,
                               const void* zero_point, const void* w,
                               void* out, int64_t G, int64_t E, int64_t bm,
                               int64_t bk, int64_t N, void* stream) {
  const int tn = mnf_cols_per_cta(bm);
  dim3 block(tn, (unsigned)bm);
  dim3 grid((unsigned)G, (unsigned)((N + tn - 1) / tn));
  mnf_event_matmul_kernel<Tile><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const typename Tile::T*)a_vals, (const int32_t*)a_idx,
      (const int32_t*)counts, (const float*)scale,
      (const int32_t*)zero_point, (const float*)w, (float*)out, E, (int)bm,
      (int)bk, N);
  return (int)cudaGetLastError();
}

extern "C" int mnf_event_matmul(const void* a_vals, const void* a_idx,
                                const void* counts, const void* w, void* out,
                                int64_t G, int64_t E, int64_t bm, int64_t bk,
                                int64_t N, void* stream) {
  return launch_event_matmul<MnfF32Tile>(a_vals, a_idx, counts, nullptr,
                                         nullptr, w, out, G, E, bm, bk, N,
                                         stream);
}

// scale: 1-element f32, zero_point: 1-element int32, both device pointers.
extern "C" int mnf_event_matmul_int8(const void* a_vals, const void* a_idx,
                                     const void* counts, const void* scale,
                                     const void* zero_point, const void* w,
                                     void* out, int64_t G, int64_t E,
                                     int64_t bm, int64_t bk, int64_t N,
                                     void* stream) {
  return launch_event_matmul<MnfInt8Tile>(a_vals, a_idx, counts, scale,
                                          zero_point, w, out, G, E, bm, bk,
                                          N, stream);
}
