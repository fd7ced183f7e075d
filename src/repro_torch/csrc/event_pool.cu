// B4: the event-native max-pools, by hand for Hopper (both grids).
//
// Segment max keyed by each event's K-block address, identity 0: the fire
// phase emits non-negative values and event-absent positions are exactly
// 0, so the result is bitwise the dense max-pool of the fired map.  Max is
// exact and order-free, so any thread layout gives the plain version's
// bits, and no atomics are needed.  Both kernels walk live events only and
// read the input stream in place through the plan.  Bound on the H100:
// bytes.
//
// B4b replaces src/repro/kernels/event_pool/kernel.py event_pool_pallas
// (body event_pool_kernel), whose grid (P, T, E) visits each live event
// once and max-accumulates its picked row at its address.  Here a group of
// threads (32-256, a power of two) takes one output pixel p, several
// pixels a CTA.  First the group reads the plan of its T taps (source,
// picked row, clamped count) and then each tap's live a_idx once, into a
// table slot[t][kb] in shared memory (-1: tap t's source has no event at
// K-block kb).  That rests on the live addresses of a source group being
// distinct (they ascend strictly: tests/test_torch_events.py pins it for
// every B4b call of a VGG16-topology forward).  Then the lanes take the
// output columns 4 at a time (16-byte loads and stores; 1 at a time where
// bk % 4 != 0 or a pointer is not 16-byte aligned): for each tap they look
// the slot up, load row row[p,t] of that live tile (a direct load where
// the TPU kernel used a 0/1 selection matmul) and take fmaxf from +0 in
// registers, then store once.  Each live tile row is read once and each
// output written once.  A table wider than the CTA's share of shared
// memory is walked in windows of K-blocks.
//
// B4a replaces event_pool_window_pallas (body event_pool_window_kernel),
// whose grid (G_out, T, E) remaps each live event tile of subtap t (out
// row i <- source row stride*i + shift[t], a 0/1 selection matmul) and
// max-accumulates it at its address.  Here, as in B4b, a group of threads
// (32-64) takes one output strip g (8 pooled pixels), several strips a
// CTA: it reads the strip's plan once (source strip, clamped count of each
// subtap), tables each subtap's live events by address (slot[t][kb], one
// writer an address: the same distinct-address precondition), then the
// lanes take (output row i, K-block, 4 columns): for each subtap whose
// source row stride*i + shift[t] lies in [0, 8) and whose slot is live,
// one 16-byte load of that tile row (a direct load where the TPU kernel
// multiplied by a selection matrix), fmaxf from +0 in registers, one
// 16-byte store.  Each live tile row a window reads is read once.
#include "mnf_common.cuh"

namespace {

constexpr int kPoolThreads = 256;      // threads a CTA (B4a and B4b)
constexpr int kPoolSmem = 16 << 10;    // a CTA's plan and slot tables
constexpr int kStripRows = 8;          // B4a: STRIP_W, rows of a strip tile
constexpr int kWindowGroup = 64;       // B4a: threads a strip at most

// A group's slot table of the K-block window [kb0, kb0 + w): slot[t * kbw
// + k] = e, the live event of (sub)tap t's source at K-block kb0 + k, or
// -1.  One writer an address: a source group's live a_idx are distinct.
// Every thread of the CTA calls it (it holds the CTA's two barriers).
__device__ __forceinline__ void table_slots(
    int* slot, const int64_t* aoff, const int* live,
    const int32_t* __restrict__ a_idx, int T, int E, int kbw, int kb0,
    int w, int lane, int gsz, bool on, const MnfDiv& per_tap) {
  for (int i = lane; i < T * kbw; i += gsz) slot[i] = -1;
  __syncthreads();
  if (on)
    for (int i = lane; i < T * E; i += gsz) {
      const int t = per_tap(i), e = i - t * E;
      if (e < live[t]) {
        const int k = a_idx[aoff[t] + e] - kb0;
        if (k >= 0 && k < w) slot[t * kbw + k] = e;
      }
    }
  __syncthreads();
}

}  // namespace

// Shared memory of a CTA of npix pixels: base[npix][T] (offset of row
// row[p,t] of slot 0 of tap t's source tile group), aoff[npix][T] (that
// group's first a_idx), live[npix][T] (its clamped count), then
// slot[npix][T][kbw].
template <int V>
__global__ void __launch_bounds__(kPoolThreads) mnf_event_pool_kernel(
    const float* __restrict__ a_vals, const int32_t* __restrict__ a_idx,
    const int32_t* __restrict__ row, const int32_t* __restrict__ src,
    const int32_t* __restrict__ cnt, float* __restrict__ out, int64_t P,
    int E, int bm, int bk, int nkb, int T, int gsz, int kbw) {
  extern __shared__ int64_t pool_smem[];
  const int npix = blockDim.x / gsz;
  const int g = threadIdx.x / gsz, lane = threadIdx.x % gsz;
  int64_t* base = pool_smem + g * T;
  int64_t* aoff = pool_smem + (npix + g) * T;
  int* live = reinterpret_cast<int*>(pool_smem + 2 * npix * T) + g * T;
  int* slot = reinterpret_cast<int*>(pool_smem + 2 * npix * T) + npix * T +
              g * T * kbw;
  const int64_t p = (int64_t)blockIdx.x * npix + g;
  const bool on = p < P;
  const int64_t tile = (int64_t)bm * bk, cols = (int64_t)nkb * bk;
  const int vb = bk / V;                 // V-wide chunks a K-block row
  const MnfDiv per_kb(vb), per_tap(E);
  if (on)
    for (int t = lane; t < T; t += gsz) {
      const int s = src[p * T + t];
      base[t] = ((int64_t)s * E * bm + row[p * T + t]) * bk;
      aoff[t] = (int64_t)s * E;
      live[t] = min(cnt[p * T + t], E);
    }
  for (int kb0 = 0; kb0 < nkb; kb0 += kbw) {
    const int w = min(kbw, nkb - kb0);
    table_slots(slot, aoff, live, a_idx, T, E, kbw, kb0, w, lane, gsz, on,
                per_tap);
    if (on)
      for (int c = lane; c < w * vb; c += gsz) {
        const int k = per_kb(c), j = (c - k * vb) * V;
        float m[V];
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = 0.f;
#pragma unroll 4
        for (int t = 0; t < T; ++t) {
          const int e = slot[t * kbw + k];
          if (e < 0) continue;
          float x[V];
          ldv<V>(a_vals + base[t] + e * tile + j, x);
#pragma unroll
          for (int i = 0; i < V; ++i) m[i] = fmaxf(m[i], x[i]);
        }
        stv<V>(out + p * cols + (int64_t)(kb0 + k) * bk + j, m);
      }
    if (kb0 + kbw < nkb) __syncthreads();   // before the next window's fill
  }
}

// Shared memory of a CTA of nstrip strips: aoff[nstrip][T] (first a_idx
// of subtap t's source strip), live[nstrip][T] (its clamped count),
// sh[T] (the plan's row shifts), then slot[nstrip][T][kbw].
template <int V>
__global__ void __launch_bounds__(kPoolThreads) mnf_event_pool_window_kernel(
    const float* __restrict__ a_vals, const int32_t* __restrict__ a_idx,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ src,
    const int32_t* __restrict__ cnt, float* __restrict__ out, int64_t G,
    int E, int bk, int nkb, int T, int row_stride, int gsz, int kbw) {
  constexpr int BM = kStripRows;
  extern __shared__ int64_t pool_smem[];
  const int nstrip = blockDim.x / gsz;
  const int g = threadIdx.x / gsz, lane = threadIdx.x % gsz;
  int64_t* aoff = pool_smem + g * T;
  int* live = reinterpret_cast<int*>(pool_smem + nstrip * T) + g * T;
  int* sh = reinterpret_cast<int*>(pool_smem + nstrip * T) + nstrip * T;
  int* slot = sh + T + g * T * kbw;
  const int64_t strip = (int64_t)blockIdx.x * nstrip + g;
  const bool on = strip < G;
  const int64_t tile = (int64_t)BM * bk, cols = (int64_t)nkb * bk;
  const int vb = bk / V;                 // V-wide chunks a K-block row
  const MnfDiv per_kb(vb), per_tap(E);
  for (int t = threadIdx.x; t < T; t += blockDim.x) sh[t] = shift[t];
  if (on)
    for (int t = lane; t < T; t += gsz) {
      aoff[t] = (int64_t)src[strip * T + t] * E;
      live[t] = min(cnt[strip * T + t], E);
    }
  for (int kb0 = 0; kb0 < nkb; kb0 += kbw) {
    const int w = min(kbw, nkb - kb0);
    table_slots(slot, aoff, live, a_idx, T, E, kbw, kb0, w, lane, gsz, on,
                per_tap);
    if (on) {
      const int row_chunks = w * vb;     // chunks an output row's window
      const MnfDiv per_row(row_chunks);
      for (int c = lane; c < BM * row_chunks; c += gsz) {
        const int i = per_row(c), q = c - i * row_chunks;
        const int k = per_kb(q), j = (q - k * vb) * V;
        float m[V];
#pragma unroll
        for (int v = 0; v < V; ++v) m[v] = 0.f;
#pragma unroll 8
        for (int t = 0; t < T; ++t) {
          const int sr = row_stride * i + sh[t];
          const int e = slot[t * kbw + k];
          if (sr < 0 || sr >= BM || e < 0) continue;
          float x[V];
          ldv<V>(a_vals + (aoff[t] + e) * tile + sr * bk + j, x);
#pragma unroll
          for (int v = 0; v < V; ++v) m[v] = fmaxf(m[v], x[v]);
        }
        stv<V>(out + (strip * BM + i) * cols + (int64_t)(kb0 + k) * bk + j,
               m);
      }
    }
    if (kb0 + kbw < nkb) __syncthreads();   // before the next window's fill
  }
}

extern "C" int mnf_event_pool(const void* a_vals, const void* a_idx,
                              const void* row, const void* src,
                              const void* cnt, void* out, int64_t P,
                              int64_t E, int64_t bm, int64_t bk, int64_t nkb,
                              int64_t T, void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  if (T * E >= lim || nkb * bk >= lim) return (int)cudaErrorInvalidValue;
  const int V = bk % 4 == 0 && (uintptr_t)a_vals % 16 == 0 &&
                        (uintptr_t)out % 16 == 0
                    ? 4
                    : 1;
  // a group of threads a pixel, as wide as its chunks (32-256); pixels a
  // CTA halved while the grid would leave SMs idle (fewer than 2 CTAs an
  // SM of the H100's 132)
  int gsz = 32;
  while (gsz < nkb * bk / V && gsz < kPoolThreads) gsz *= 2;
  int npix = kPoolThreads / gsz;
  while (npix > 1 && (P + npix - 1) / npix < 2 * 132) npix /= 2;
  // slot[T][kbw] in what is left of the CTA's share (20 bytes a tap go
  // to the plan); at least one K-block a window
  const int64_t fit = (kPoolSmem / npix - 20 * T) / (4 * T);
  const int64_t kbw = fit < 1 ? 1 : fit < nkb ? fit : nkb;
  const size_t smem = (size_t)npix * T * (20 + 4 * kbw);
  if (smem > 48 << 10) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((P + npix - 1) / npix);
  cudaStream_t s = (cudaStream_t)stream;
#define MNF_LAUNCH(V_)                                                       \
  mnf_event_pool_kernel<V_><<<grid, npix * gsz, smem, s>>>(                 \
      (const float*)a_vals, (const int32_t*)a_idx, (const int32_t*)row,      \
      (const int32_t*)src, (const int32_t*)cnt, (float*)out, P, (int)E,      \
      (int)bm, (int)bk, (int)nkb, (int)T, gsz, (int)kbw)
  if (V == 4)
    MNF_LAUNCH(4);
  else
    MNF_LAUNCH(1);
#undef MNF_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int mnf_event_pool_window(const void* a_vals, const void* a_idx,
                                     const void* shift, const void* src,
                                     const void* cnt, void* out, int64_t G_out,
                                     int64_t E, int64_t bk, int64_t nkb,
                                     int64_t T, int64_t row_stride,
                                     void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  if (T * E >= lim || kStripRows * nkb * bk >= lim)
    return (int)cudaErrorInvalidValue;
  const bool wide = bk % 4 == 0 && (uintptr_t)a_vals % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  const int V = wide ? 4 : 1;
  // a group of threads a strip, as wide as its chunks (32-64: 2 chunks a
  // lane at pool1, 4 at pool2); strips a CTA halved while the grid would
  // leave SMs idle (fewer than 2 CTAs an SM of the H100's 132)
  int gsz = 32;
  while (gsz < kStripRows * nkb * bk / V && gsz < kWindowGroup) gsz *= 2;
  int nstrip = kPoolThreads / gsz;
  while (nstrip > 1 && (G_out + nstrip - 1) / nstrip < 2 * 132) nstrip /= 2;
  // slot[T][kbw] in what is left of the CTA's share (12 bytes a subtap go
  // to the plan, 4 a subtap to the shifts); at least one K-block a window
  const int64_t fit = ((kPoolSmem - 4 * T) / nstrip - 12 * T) / (4 * T);
  const int64_t kbw = fit < 1 ? 1 : fit < nkb ? fit : nkb;
  const size_t smem = (size_t)nstrip * T * (12 + 4 * kbw) + 4 * T;
  if (smem > 48 << 10) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((G_out + nstrip - 1) / nstrip);
  cudaStream_t s = (cudaStream_t)stream;
#define MNF_LAUNCH(V_)                                                       \
  mnf_event_pool_window_kernel<V_><<<grid, nstrip * gsz, smem, s>>>(        \
      (const float*)a_vals, (const int32_t*)a_idx, (const int32_t*)shift,    \
      (const int32_t*)src, (const int32_t*)cnt, (float*)out, G_out, (int)E,  \
      (int)bk, (int)nkb, (int)T, (int)row_stride, gsz, (int)kbw)
  if (V == 4)
    MNF_LAUNCH(4);
  else
    MNF_LAUNCH(1);
#undef MNF_LAUNCH
  return (int)cudaGetLastError();
}
