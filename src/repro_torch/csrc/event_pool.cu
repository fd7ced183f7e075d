// B4: the event-native max-pools, by hand for Hopper (both grids).
//
// Segment max keyed by each event's K-block address, identity 0: the fire
// phase emits non-negative values and event-absent positions are exactly
// 0, so the result is bitwise the dense max-pool of the fired map.  Max is
// exact and order-free, and each thread owns its output channel column, so
// no atomics are needed.  Both kernels walk live events only and read the
// input stream in place through the plan.  Bound on the H100: bytes.
//
// B4b replaces src/repro/kernels/event_pool/kernel.py event_pool_pallas
// (body event_pool_kernel): CTA = one output pixel p; for each window tap
// t it picks row row[p,t] of tile a[src[p,t], e] (a direct load where the
// TPU kernel used a 0/1 selection matmul).
//
// B4a replaces event_pool_window_pallas (body event_pool_window_kernel):
// CTA = one output strip (8 pooled pixels); for each subtap t every thread
// keeps the 8 rows of its column in registers and max-accumulates source
// row stride*i + shift[t] where that row lies inside the tile.
#include "mnf_common.cuh"

__global__ void mnf_event_pool_kernel(const float* __restrict__ a_vals,
                                      const int32_t* __restrict__ a_idx,
                                      const int32_t* __restrict__ row,
                                      const int32_t* __restrict__ src,
                                      const int32_t* __restrict__ cnt,
                                      float* __restrict__ out, int64_t E,
                                      int bm, int bk, int64_t nkb, int64_t T) {
  const int64_t p = blockIdx.x;
  const int64_t cols = nkb * bk;
  for (int64_t col = threadIdx.x; col < cols; col += blockDim.x) {
    const int64_t kb = col / bk;
    const int j = (int)(col % bk);
    float m = 0.f;
    for (int64_t t = 0; t < T; ++t) {
      const int c = min((int64_t)cnt[p * T + t], E);
      const int64_t s = src[p * T + t];
      const int r = row[p * T + t];
      for (int e = 0; e < c; ++e) {
        if (a_idx[s * E + e] == kb) {
          m = fmaxf(m, a_vals[((s * E + e) * bm + r) * bk + j]);
        }
      }
    }
    out[p * cols + col] = m;
  }
}

__global__ void mnf_event_pool_window_kernel(const float* __restrict__ a_vals,
                                             const int32_t* __restrict__ a_idx,
                                             const int32_t* __restrict__ shift,
                                             const int32_t* __restrict__ src,
                                             const int32_t* __restrict__ cnt,
                                             float* __restrict__ out,
                                             int64_t E, int bk, int64_t nkb,
                                             int64_t T, int row_stride) {
  constexpr int BM = 8;  // STRIP_W: the window grid takes strip streams only
  const int64_t g = blockIdx.x;
  const int64_t cols = nkb * bk;
  for (int64_t col = threadIdx.x; col < cols; col += blockDim.x) {
    const int64_t kb = col / bk;
    const int j = (int)(col % bk);
    float m[BM];
#pragma unroll
    for (int i = 0; i < BM; ++i) m[i] = 0.f;
    for (int64_t t = 0; t < T; ++t) {
      const int c = min((int64_t)cnt[g * T + t], E);
      const int64_t s = src[g * T + t];
      const int d = shift[t];
      for (int e = 0; e < c; ++e) {
        if (a_idx[s * E + e] != kb) continue;
        const float* tile = a_vals + (s * E + e) * BM * bk + j;
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const int sr = row_stride * i + d;
          if (sr >= 0 && sr < BM) m[i] = fmaxf(m[i], tile[sr * bk]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BM; ++i) out[(g * BM + i) * cols + col] = m[i];
  }
}

extern "C" int mnf_event_pool(const void* a_vals, const void* a_idx,
                              const void* row, const void* src,
                              const void* cnt, void* out, int64_t P,
                              int64_t E, int64_t bm, int64_t bk, int64_t nkb,
                              int64_t T, void* stream) {
  mnf_event_pool_kernel<<<(unsigned)P, mnf_col_threads(nkb * bk), 0,
                          (cudaStream_t)stream>>>(
      (const float*)a_vals, (const int32_t*)a_idx, (const int32_t*)row,
      (const int32_t*)src, (const int32_t*)cnt, (float*)out, E, (int)bm,
      (int)bk, nkb, T);
  return (int)cudaGetLastError();
}

extern "C" int mnf_event_pool_window(const void* a_vals, const void* a_idx,
                                     const void* shift, const void* src,
                                     const void* cnt, void* out, int64_t G_out,
                                     int64_t E, int64_t bk, int64_t nkb,
                                     int64_t T, int64_t row_stride,
                                     void* stream) {
  mnf_event_pool_window_kernel<<<(unsigned)G_out, mnf_col_threads(nkb * bk), 0,
                                 (cudaStream_t)stream>>>(
      (const float*)a_vals, (const int32_t*)a_idx, (const int32_t*)shift,
      (const int32_t*)src, (const int32_t*)cnt, (float*)out, E, (int)bk, nkb,
      T, (int)row_stride);
  return (int)cudaGetLastError();
}
