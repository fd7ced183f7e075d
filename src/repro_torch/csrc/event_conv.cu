// B3 and B6: the fused strip conv, one launch per conv layer, by hand for
// Hopper.
//
// Replaces src/repro/kernels/event_conv/kernel.py event_conv_pallas (body
// event_conv_kernel) and event_conv_int8_pallas (body
// event_conv_int8_kernel).  For output strip g and each compacted subtap t
// of the strip_tap_map plan:
//   tap_acc = sum_{e < cnt[g,t]} remap_t(a[src[g,t], e]) @ ws[tap[t]*nkb + a_idx]
//   acc += tap_acc
// where remap_t moves out row i <- src row stride*i + shift[t], exact 0
// where no row maps.  The TPU kernel moved rows with a 0/1 selection
// matmul; here the thread of output row i loads source row
// stride*i + shift[t] directly and skips the subtap when it falls outside
// the tile.  The tap_acc -> acc flush per subtap reproduces the per-tap
// path's `acc = acc + tap` order, and mnf_tile_dot keeps B2's term order
// (mnf_common.cuh), so the result is bitwise the per-tap event matmul's.
//
// B6 is the same body with MnfInt8Tile: each int8 code is dequantized as
// it is loaded from a sourced row, so the dequantize comes before the
// remap and an unsourced row stays exact 0 whatever the zero point (the
// thread never loads it).
//
// A CTA takes one (output strip, N tile), threads over (column, row).  The
// gathered events are never materialized: the plan indexes the input
// stream in place.  Bound on the H100: f32 FMA issue (CUDA cores, no
// tensor cores in this simple first version).
#include "mnf_common.cuh"

template <typename Tile>
__global__ void mnf_event_conv_kernel(
    const typename Tile::T* __restrict__ a_vals,
    const int32_t* __restrict__ a_idx, const int32_t* __restrict__ tap,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ src,
    const int32_t* __restrict__ cnt, const float* __restrict__ scale,
    const int32_t* __restrict__ zero_point, const float* __restrict__ ws,
    float* __restrict__ out, int64_t E, int bm, int bk, int64_t N, int64_t T,
    int64_t nkb, int row_stride) {
  const int64_t g = blockIdx.x;
  const int i = threadIdx.y;
  const int64_t n = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Tile tile(scale, zero_point);
  float acc = 0.f;
  for (int64_t t = 0; t < T; ++t) {
    float tap_acc = 0.f;
    const int c = min((int64_t)cnt[g * T + t], E);
    const int srow = row_stride * i + shift[t];
    if (c > 0 && srow >= 0 && srow < bm) {
      const int64_t s = src[g * T + t];
      const int64_t slab = (int64_t)tap[t] * nkb;
      for (int e = 0; e < c; ++e) {
        const int64_t kb = a_idx[s * E + e];
        const typename Tile::T* a_row = a_vals + ((s * E + e) * bm + srow) * bk;
        tap_acc = mnf_tile_dot(a_row, ws + (slab + kb) * bk * N + n, N, bk,
                               tap_acc, tile);
      }
    }
    acc += tap_acc;
  }
  out[(g * bm + i) * N + n] = acc;
}

template <typename Tile>
static int launch_event_conv(const void* a_vals, const void* a_idx,
                             const void* tap, const void* shift,
                             const void* src, const void* cnt,
                             const void* scale, const void* zero_point,
                             const void* ws, void* out, int64_t G_out,
                             int64_t E, int64_t bm, int64_t bk, int64_t N,
                             int64_t T, int64_t nkb, int64_t row_stride,
                             void* stream) {
  const int tn = mnf_cols_per_cta(bm);
  dim3 block(tn, (unsigned)bm);
  dim3 grid((unsigned)G_out, (unsigned)((N + tn - 1) / tn));
  mnf_event_conv_kernel<Tile><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const typename Tile::T*)a_vals, (const int32_t*)a_idx,
      (const int32_t*)tap, (const int32_t*)shift, (const int32_t*)src,
      (const int32_t*)cnt, (const float*)scale, (const int32_t*)zero_point,
      (const float*)ws, (float*)out, E, (int)bm, (int)bk, N, T, nkb,
      (int)row_stride);
  return (int)cudaGetLastError();
}

extern "C" int mnf_event_conv(const void* a_vals, const void* a_idx,
                              const void* tap, const void* shift,
                              const void* src, const void* cnt, const void* ws,
                              void* out, int64_t G_out, int64_t E, int64_t bm,
                              int64_t bk, int64_t N, int64_t T, int64_t nkb,
                              int64_t row_stride, void* stream) {
  return launch_event_conv<MnfF32Tile>(a_vals, a_idx, tap, shift, src, cnt,
                                       nullptr, nullptr, ws, out, G_out, E,
                                       bm, bk, N, T, nkb, row_stride, stream);
}

// scale: 1-element f32, zero_point: 1-element int32, both device pointers.
extern "C" int mnf_event_conv_int8(const void* a_vals, const void* a_idx,
                                   const void* tap, const void* shift,
                                   const void* src, const void* cnt,
                                   const void* scale, const void* zero_point,
                                   const void* ws, void* out, int64_t G_out,
                                   int64_t E, int64_t bm, int64_t bk,
                                   int64_t N, int64_t T, int64_t nkb,
                                   int64_t row_stride, void* stream) {
  return launch_event_conv<MnfInt8Tile>(a_vals, a_idx, tap, shift, src, cnt,
                                        scale, zero_point, ws, out, G_out, E,
                                        bm, bk, N, T, nkb, row_stride, stream);
}
