// B1: the fused fire phase, by hand for Hopper.
//
// Replaces src/repro/kernels/fire_compact/kernel.py fire_compact_pallas
// (body fire_compact_kernel).  One pass over an (M, K) accumulator:
//   live = a > theta (|a| > theta with magnitude), fired = live ? a : 0,
//   optional fake-quant clip(rint(fired / s), -128, 127) * s (s > 0, a
//   true division: the build has no fast math),
//   occ[tile] = any element of the (bm, bk) tile is live  (int32).
// Elementwise, so any thread layout gives the plain version's bits.  Bound
// on the H100: bytes (read acc once, write fired once, occ once).
//
// Design: a streaming pass.  A thread takes one 16-byte chunk of a row
// (4 columns; 1 where bk % 4 != 0 or a pointer is not 16-byte aligned)
// down a row group -- max(1, 8 / bm) whole tile rows ("bands") of bm rows
// -- loading 8 rows at once, so each thread has 8 loads in flight with
// bm 1 (pixel streams) as with bm 8 (strips).  Consecutive threads take
// consecutive chunks of a row, so a warp reads and writes 512 bytes (two
// rows of 256 where a row is 64 columns).  It ORs `live` per band into a
// bit set; the occupancy flag of a tile is the OR over the bk / 4 lanes of
// the tile, by __shfl_xor where that is a power of two up to 32 (the
// tile's lanes then lie inside one warp), else by a flag per tile in
// shared memory (a CTA takes whole row groups).  No atomics and no second
// launch.  Loads and stores carry the evict-first hint (__ldcs, __stcs):
// each byte is touched once, and the hints gained 3-5% at every VGG16
// shape timed.  At VGG16's acc (200704, 64) it runs a few % behind
// torch.relu and cudaMemcpy; so does the same pass with no fire and no
// flags (tools/torch_fire_variants.py, PERF.md).
#include "mnf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;     // rows a thread loads at once
constexpr int kFlagSmem = 48 << 10;

}  // namespace

template <int V, bool SHFL>
__global__ void __launch_bounds__(kThreads) mnf_fire_compact_kernel(
    const float* __restrict__ acc, float* __restrict__ fired,
    int32_t* __restrict__ occ, int64_t M, int64_t K, int bm, int bk,
    int bands, int groups, float threshold, int magnitude, float qscale) {
  extern __shared__ int flag[];          // !SHFL: [groups][bands][nkb]
  const int64_t kc = K / V;              // chunks a row
  const int gc = bk / V;                 // chunks a tile row
  const int64_t nkb = K / bk, nband = M / bm;
  const int rows = bands * bm;           // rows a row group
  const int64_t rg0 = (int64_t)blockIdx.x * groups;
  const int64_t items = groups * kc;
  const int nflag = groups * bands * (int)nkb;
  const MnfDiv band_of(bm);
  if (!SHFL) {
    for (int i = threadIdx.x; i < nflag; i += blockDim.x) flag[i] = 0;
    __syncthreads();
  }
  for (int64_t it0 = 0; it0 < items; it0 += blockDim.x) {
    const int64_t it = it0 + threadIdx.x;
    const int64_t gl = it / kc, cq = it - gl * kc;
    const int64_t row0 = (rg0 + gl) * rows;
    const bool on = it < items && row0 < M;
    unsigned bits = 0;                   // bit u: band u has a live value
    if (on) {
      const int nrows = (int)min((int64_t)rows, M - row0);
      const float* a = acc + row0 * K + cq * V;
      float* f = fired + row0 * K + cq * V;
      for (int r0 = 0; r0 < nrows; r0 += kRows) {
        float x[kRows][V];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r >= nrows) break;
          const float* p = a + (int64_t)(r0 + r) * K;
          if constexpr (V == 4) {
            const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
            x[r][0] = t.x, x[r][1] = t.y, x[r][2] = t.z, x[r][3] = t.w;
          } else {
            x[r][0] = __ldcs(p);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r >= nrows) break;
          int any = 0;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float v = x[r][i];
            const int live = magnitude ? (fabsf(v) > threshold)
                                       : (v > threshold);
            float y = live ? v : 0.f;
            if (qscale > 0.f)
              y = fminf(fmaxf(rintf(y / qscale), -128.f), 127.f) * qscale;
            x[r][i] = y;
            any |= live;
          }
          float* q = f + (int64_t)(r0 + r) * K;
          if constexpr (V == 4)
            __stcs(reinterpret_cast<float4*>(q),
                   make_float4(x[r][0], x[r][1], x[r][2], x[r][3]));
          else
            __stcs(q, x[r][0]);
          bits |= (unsigned)any << band_of(r0 + r);
        }
      }
    }
    if constexpr (SHFL) {
      for (int w = 1; w < gc; w <<= 1)
        bits |= __shfl_xor_sync(0xffffffffu, bits, w);
      if (on && cq % gc == 0) {
        const int64_t b0 = (rg0 + gl) * bands, tj = cq / gc;
        for (int u = 0; u < bands && b0 + u < nband; ++u)
          occ[(b0 + u) * nkb + tj] = (bits >> u) & 1;
      }
    } else if (on && bits) {
      for (int u = 0; u < bands; ++u)
        if ((bits >> u) & 1) flag[(gl * bands + u) * nkb + cq / gc] = 1;
    }
  }
  if (!SHFL) {
    __syncthreads();
    const int64_t b0 = rg0 * bands;
    for (int i = threadIdx.x; i < nflag; i += blockDim.x)
      if (b0 + i / nkb < nband) occ[b0 * nkb + i] = flag[i];
  }
}

extern "C" int mnf_fire_compact(const void* acc, void* fired, void* occ,
                                int64_t M, int64_t K, int64_t bm, int64_t bk,
                                float threshold, int64_t magnitude,
                                float qscale, void* stream) {
  const int V = bk % 4 == 0 && (uintptr_t)acc % 16 == 0 &&
                        (uintptr_t)fired % 16 == 0
                    ? 4
                    : 1;
  const int gc = (int)(bk / V);
  const bool shfl = gc <= 32 && (gc & (gc - 1)) == 0;
  const int64_t kc = K / V, nkb = K / bk;
  // bands a row group: 8 rows a thread where bm divides into them
  int bands = bm < kRows ? (int)(kRows / bm) : 1;
  // whole row groups a CTA, as many as its threads cover
  int groups = kc < kThreads ? (int)(kThreads / kc) : 1;
  size_t smem = 0;
  if (!shfl) {   // flags [groups][bands][nkb] in shared memory
    while (groups > 1 && (size_t)groups * bands * nkb * 4 > kFlagSmem)
      --groups;
    while (bands > 1 && (size_t)groups * bands * nkb * 4 > kFlagSmem)
      --bands;
    smem = (size_t)groups * bands * nkb * 4;
    if (smem > kFlagSmem) return (int)cudaErrorInvalidValue;
  }
  const int64_t row_groups = (M / bm + bands - 1) / bands;
  const unsigned grid = (unsigned)((row_groups + groups - 1) / groups);
  cudaStream_t s = (cudaStream_t)stream;
#define MNF_LAUNCH(V_, S_)                                                   \
  mnf_fire_compact_kernel<V_, S_><<<grid, kThreads, smem, s>>>(             \
      (const float*)acc, (float*)fired, (int32_t*)occ, M, K, (int)bm,        \
      (int)bk, bands, groups, threshold, (int)magnitude, qscale)
  if (V == 4 && shfl)
    MNF_LAUNCH(4, true);
  else if (V == 4)
    MNF_LAUNCH(4, false);
  else if (shfl)
    MNF_LAUNCH(1, true);
  else
    MNF_LAUNCH(1, false);
#undef MNF_LAUNCH
  return (int)cudaGetLastError();
}
