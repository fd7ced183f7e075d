// B8: the fire-gated Mamba decode step, by hand for Hopper.
//
// Replaces src/repro/kernels/mamba_scan/step.py mamba_step_events_pallas
// (body mamba_step_kernel).  For each batch row b, with the fired gate
// g = dt * silu(xconv) carried as blk_m == 1 block events over the DI
// channels:
//
//   h' = h dA + g B^T  on live DI-blocks,  h dA  on dead ones
//   y  = sum_{n<N} h' C
//
// Bound on the H100: bytes.  Each row reads h and dA and writes h', all
// f32 (B, DI, N): 3 x 409.6 KB at Hymba-1.5B's batch 4, DI 1600, N 16,
// plus ~40 KB of events, B, C and y — 1.27 MB, ~0.38 us at 3.35 TB/s.  A
// launch and one DRAM round trip are most of that, so the design puts
// nothing in front of the state's loads and waits on one dependent load
// at most.
//
// A CTA takes kBlocks DI-blocks of one row (the TPU walks a row a grid
// step).  Thread (c, q) of a block owns channel c and the state columns
// of chunk q, q + L, ... (a chunk: 4 columns, one 16-byte access, where N
// % 4 == 0 and every state pointer is 16-byte aligned; else 1 column);
// the L lanes of a channel are neighbours in one warp.  Each thread first
// issues the loads of its first chunk of h, dA, B and C, and with them the
// row's count and the address and gate value of slot kb, where a
// compacted row keeps block kb when no block before it is dead (every
// block of an all-live row).  A slot e counts only below min(counts[b],
// E) — the count gates the compare, not the loads: padding slots repeat
// the last live index and are never taken, exactly live_block_mask's
// rule, derived here, so the wrapper launches nothing beside the kernel.
// Where slot kb names block kb, that is the block's slot (live slots name
// distinct blocks).  A warp with a block it does not name searches: a
// lane loads kSearch slots' addresses at once, compares, and
// __reduce_max_sync hands each lane its block's slot (-1: dead), whose
// gate is then one dependent load.  No shared memory, no barrier.  The
// update uses round-to-nearest intrinsics that nvcc never contracts, so
// h' is bitwise the plain version's  h * dA + g[..., None] * B  (a
// separate multiply, multiply and add); a dead block writes h dA alone.
// h' is stored as the chunk it was loaded.
//
// The readout sum_n h' C is reduced in one fixed order that does not look
// at liveness: each lane sums its columns ascending, then the channel's L
// lanes by __shfl_xor_sync (xor L/2, ..., 1).  So a θ = 0 drive gives y
// and h' bitwise this kernel's output on the all-live drive of the same
// values (DESIGN.md §13's within-backend contract).  Channels >= DI of a
// ragged last block are masked: no padded copies of dA or h.
#include "mnf_common.cuh"

namespace {

constexpr int kBlocks = 2;   // DI-blocks a CTA
constexpr int kSearch = 4;   // event slots a lane loads at once
constexpr int kMaxThreads = 1024;

}  // namespace

template <int V>
__global__ void __launch_bounds__(kMaxThreads) mnf_mamba_step_kernel(
    const float* __restrict__ vals, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ counts, const float* __restrict__ da,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ h, float* __restrict__ y,
    float* __restrict__ h_new, int E, int DI, int N, int bk, int nkb,
    int L) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int per_block = bk * L;
  const int j = tid / per_block;                 // the CTA's block
  const int c = (tid - j * per_block) / L;       // channel in the block
  const int q = tid - j * per_block - c * L;     // the lane's first chunk
  const int kb0 = blockIdx.x * kBlocks;
  const int64_t b = blockIdx.y;
  const int ch = (kb0 + j) * bk + c;
  const bool on = j < kBlocks && kb0 + j < nkb && ch < DI;
  const int chunks = N / V;
  const int64_t row = (b * DI + ch) * N;

  float hv[V], dv[V], bv[V], cv[V];
  auto fetch = [&](int k) {
    if (on) {
      ldv<V>(h + row + k * V, hv);
      ldv<V>(da + row + k * V, dv);
      ldv<V>(bm + b * N + k * V, bv);
      ldv<V>(cm + b * N + k * V, cv);
    }
  };
  fetch(q);                                      // the state first
  // slot kb, where a compacted row keeps block kb when no block before it
  // is dead: its address and gate come with the state and the count
  const int guess = on && kb0 + j < E ? kb0 + j : -1;
  int at_guess = -1;
  float g_guess = 0.f;
  if (guess >= 0) {
    at_guess = idx[b * E + guess];
    g_guess = vals[(b * E + guess) * bk + c];
  }
  const int cnt = (int)min((int64_t)counts[b], (int64_t)E);
  const bool hit = guess < cnt && at_guess == kb0 + j;
  int slot = hit ? guess : -1;
  // a warp with a block that slot kb does not name searches every slot
  // below the count for the CTA's blocks
  if (__any_sync(0xffffffffu, on && !hit)) {
    int found[kBlocks];
#pragma unroll
    for (int jj = 0; jj < kBlocks; ++jj) found[jj] = -1;
    for (int base = 0; base < E; base += 32 * kSearch) {
      int ib[kSearch];
#pragma unroll
      for (int s = 0; s < kSearch; ++s) {
        const int e = base + s * 32 + lane;
        ib[s] = e < E ? idx[b * E + e] : -1;
      }
#pragma unroll
      for (int s = 0; s < kSearch; ++s) {
        const int e = base + s * 32 + lane;
#pragma unroll
        for (int jj = 0; jj < kBlocks; ++jj)
          if (e < cnt && ib[s] == kb0 + jj) found[jj] = e;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBlocks; ++jj) {
      const int f = __reduce_max_sync(0xffffffffu, found[jj]);
      if (jj == j) slot = f;
    }
  }
  const float g = slot == guess ? g_guess
                  : on && slot >= 0 ? vals[(b * E + slot) * bk + c] : 0.f;

  float s = 0.f;
  for (int k = q;;) {
    float x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float dec = __fmul_rn(hv[v], dv[v]);
      x[v] = slot >= 0 ? __fadd_rn(dec, __fmul_rn(g, bv[v])) : dec;
      s = __fadd_rn(s, __fmul_rn(x[v], cv[v]));
    }
    if (on) stv<V>(h_new + row + k * V, x);
    k += L;
    if (k >= chunks) break;                      // the same for every lane
    fetch(k);
  }
  for (int m = L >> 1; m > 0; m >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
  if (on && q == 0) y[b * DI + ch] = s;
}

// vals (B, E, 1, bk) f32, idx (B, E) / counts (B,) int32, da, h (B, DI, N)
// f32, bm, cm (B, N) f32 -> y (B, DI), h_new (B, DI, N).
extern "C" int mnf_mamba_step(const void* vals, const void* idx,
                              const void* counts, const void* da,
                              const void* bm, const void* cm, const void* h,
                              void* y, void* h_new, int64_t B, int64_t E,
                              int64_t DI, int64_t N, int64_t bk, int64_t nkb,
                              void* stream) {
  if (kBlocks * bk > kMaxThreads || E * bk >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const bool wide = N % 4 == 0 && (uintptr_t)da % 16 == 0 &&
                    (uintptr_t)h % 16 == 0 && (uintptr_t)h_new % 16 == 0 &&
                    (uintptr_t)bm % 16 == 0 && (uintptr_t)cm % 16 == 0;
  const int V = wide ? 4 : 1;
  // lanes a channel: the largest power of two that divides its chunks,
  // at most a warp, with a CTA within kMaxThreads
  const int64_t chunks = N / V;
  int64_t L = 1;
  while (L < 32 && chunks % (2 * L) == 0) L *= 2;
  while (L > 1 && kBlocks * bk * L > kMaxThreads) L /= 2;
  const unsigned threads = (unsigned)((kBlocks * bk * L + 31) / 32 * 32);
  const dim3 grid((unsigned)((nkb + kBlocks - 1) / kBlocks), (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
#define MNF_LAUNCH(V_)                                                       \
  mnf_mamba_step_kernel<V_><<<grid, threads, 0, st>>>(                     \
      (const float*)vals, (const int32_t*)idx, (const int32_t*)counts,       \
      (const float*)da, (const float*)bm, (const float*)cm, (const float*)h, \
      (float*)y, (float*)h_new, (int)E, (int)DI, (int)N, (int)bk, (int)nkb,  \
      (int)L)
  if (V == 4)
    MNF_LAUNCH(4);
  else
    MNF_LAUNCH(1);
#undef MNF_LAUNCH
  return (int)cudaGetLastError();
}
