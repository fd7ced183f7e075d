// B1: the fused fire phase, by hand for Hopper.
//
// Replaces src/repro/kernels/fire_compact/kernel.py fire_compact_pallas
// (body fire_compact_kernel).  One pass over an (M, K) accumulator:
//   fired = a > theta (|a| > theta with magnitude) ? a : 0,
//   optional fake-quant clip(rint(x / s), -128, 127) * s (s > 0),
//   occ[tile] = any element of the (bm, bk) tile fired  (int32).
// One thread owns one tile, so the occupancy flag needs no atomics; the
// threads of a warp own neighbouring tiles of a tile row, so each tile row
// they read together is contiguous.  Bound on the H100: bytes (read acc
// once, write fired once).
#include "mnf_common.cuh"

__global__ void mnf_fire_compact_kernel(const float* __restrict__ acc,
                                        float* __restrict__ fired,
                                        int32_t* __restrict__ occ, int64_t M,
                                        int64_t K, int bm, int bk,
                                        float threshold, int magnitude,
                                        float qscale) {
  const int64_t nkb = K / bk;
  const int64_t tile = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= (M / bm) * nkb) return;
  const int64_t ti = tile / nkb, tj = tile % nkb;
  int any = 0;
  for (int r = 0; r < bm; ++r) {
    const int64_t base = (ti * bm + r) * K + tj * bk;
    for (int j = 0; j < bk; ++j) {
      const float a = acc[base + j];
      const int live = magnitude ? (fabsf(a) > threshold) : (a > threshold);
      float f = live ? a : 0.f;
      if (qscale > 0.f) {
        f = fminf(fmaxf(rintf(f / qscale), -128.f), 127.f) * qscale;
      }
      fired[base + j] = f;
      any |= live;
    }
  }
  occ[tile] = any;
}

extern "C" int mnf_fire_compact(const void* acc, void* fired, void* occ,
                                int64_t M, int64_t K, int64_t bm, int64_t bk,
                                float threshold, int64_t magnitude,
                                float qscale, void* stream) {
  const int64_t tiles = (M / bm) * (K / bk);
  const int threads = 256;
  dim3 grid((unsigned)((tiles + threads - 1) / threads));
  mnf_fire_compact_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)acc, (float*)fired, (int32_t*)occ, M, K, (int)bm, (int)bk,
      threshold, (int)magnitude, qscale);
  return (int)cudaGetLastError();
}
