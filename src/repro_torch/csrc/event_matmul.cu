// B2 and B5: the block-event multiply phase, by hand for Hopper.
//
// Replaces src/repro/kernels/event_matmul/kernel.py event_matmul_pallas
// (:163, body event_matmul_kernel) and event_matmul_int8_pallas (:126,
// body event_matmul_int8_kernel).  y[g] = sum_{e < counts[g]}
// a_vals[g, e] @ W[a_idx[g, e]*bk : +bk, :], f32 accumulate; B5's tiles
// are int8 codes, dequantized as (q - zp) * scale (mnf_common.cuh
// MnfInt8Tile), one kernel body for both.
//
// The order is the contract (mnf_common.cuh): every output element sums
// its group's events e ascending, then j ascending within the bk columns,
// each term an fmaf into one f32 register.  Strip == per-tap (B3 vs B2)
// and chained == round trip rest on it, so nothing here splits K, sums in
// a tree or uses tensor cores.
//
// Design.  A CTA takes TG = TM / bm whole row groups and one TN-column
// tile.  It scans its groups' live events (e < min(counts, E)) into a
// shared slot table slot[g][kb] = e and takes the ascending union of the
// K-blocks they name.  Then it walks that union row by row -- union row p
// is W row union[p / bk] * bk + p % bk -- R rows a stage.  Each stage's
// (R x TN) weight rows stream into a ring of S stages in shared memory by
// cp.async (16 bytes a copy, 4 where N, bk or a pointer is not aligned),
// S - 1 stages in flight.  Each stage's (R x TM) activation values are
// loaded AD stages ahead into registers (4 consecutive values a load) and
// stored to shared memory once per CTA, B5's dequantized there.  A row
// whose group does not name a union block gets exact zeros for that
// block's rows, and the weight rows past the union's end are zeros, so
// every thread runs the same unpredicated RM x RN register-tile update,
// one fmaf a term.  Each output still sums exactly its own events e
// ascending, j ascending: a zero activation adds fmaf(+0, w, acc) == acc
// for a model's finite weights (the rule mnf_common.cuh states, on which
// B3's strip tiles already rest; only an exact -0 accumulator would turn
// +0, and +0 == -0), and the union is ascending because each group's live
// a_idx is (encode_block_events compacts in ascending K-block order,
// retile_block_events equals that encode of the dense twin,
// gather_row_groups moves whole groups; pinned in
// tests/test_torch_events.py).  Each live weight row leaves device memory
// once per CTA for all its groups, one shared load feeds RM (or RN) FMAs,
// and each thread runs RM x RN independent chains.
//
// Two CTA shapes, chosen by shape in the launcher:
// - FC (G * bm <= 4: the FC layers at batch 4): all groups in one CTA of
//   64 threads (2 outputs each) over a 32-column tile, so W -- 411 MB at
//   FC1, larger than the 50 MB L2 -- is read from device memory once.
//   Bound: bytes (FC1: 0.12 ms at 3.35 TB/s).  R = 64, S = 8, AD = 4, and
//   16 rows' operands loaded before their FMAs.  What holds it (H100
//   runs, PERF.md): FC1 has 16384 outputs, so two a thread leave two warps
//   an SM, and their walk, not the weight stream, sets the time -- no
//   weight traffic at all still took 0.47 ms, and bulk (TMA) copies or a
//   deeper ring changed nothing.
// - Conv (thousands of pixel groups, E <= 64, W_tap <= 1 MB: the per-tap
//   convs): 64 groups x 64 columns a CTA, 128 threads of 8 x 4 outputs,
//   R = 32, S = 3, AD = 1; W_tap stays in L2 and each staged block serves
//   64 groups instead of one.  Bound: f32 FMA issue (conv4_2 per tap: 1.6
//   GFLOP, 0.025 ms at 67 TFLOP/s).
// The union is built in windows of WB K-blocks (one window for every
// layer VGG16 and LeNet-300-100 have); a window's pipeline drains before
// the next.  The kernel allocates nothing and never synchronises the
// host, so a CUDA graph can capture it.
#include "mnf_common.cuh"

namespace {

constexpr int kScanUnroll = 8;   // a_idx loads in flight a thread (scan)

template <int TM_, int TN_, int RM_, int RN_, int R_, int S_, int AD_,
          int QB_, int WB_>
struct MnfMatmulShape {
  static constexpr int TM = TM_;   // rows (groups x bm) a CTA
  static constexpr int TN = TN_;   // columns a CTA
  static constexpr int RM = RM_;   // rows a thread
  static constexpr int RN = RN_;   // columns a thread
  static constexpr int R = R_;     // union rows a stage
  static constexpr int S = S_;     // pipeline stages
  static constexpr int AD = AD_;   // stages the activations load ahead
  static constexpr int QB = QB_;   // rows whose operands load before their FMAs
  static constexpr int WB = WB_;   // K-blocks a union window
  static constexpr int kThreads = (TM / RM) * (TN / RN);
  static constexpr int AST = TM + 4;  // row stride of a staged [q][m] tile
  static constexpr size_t kSmem =
      4 * ((size_t)S * R * TN + (size_t)S * R * AST + (size_t)TM * WB + WB +
           WB / 32 + TM + 4);
  static_assert(kThreads % 32 == 0 && TM % 4 == 0 && R % 8 == 0, "");
  static_assert((TM * R) % (4 * kThreads) == 0 && TM * R / kThreads <= 32,
                "whole 4-wide chunks a thread, a live bit each");
  static_assert(WB % 32 == 0 && AD >= 1 && AD <= S - 2 && R % QB == 0, "");
};

using FcShape = MnfMatmulShape<4, 32, 2, 1, 64, 8, 4, 16, 4096>;
using ConvShape = MnfMatmulShape<64, 64, 8, 4, 32, 3, 1, 1, 64>;

// VA consecutive activation values (f32 or int8 codes) from device memory:
// one 16-byte (f32) or 4-byte (int8) load when VA == 4.
template <int VA, typename T>
__device__ __forceinline__ void ldg(const T* p, T (&v)[VA]) {
  if constexpr (VA == 4 && sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VA == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// The slot table of one union window: slot[g * WB + kb - w0] = e for every
// live event (e < cnt[g]) of the CTA's groups whose address kb lies in
// [w0, w0 + WB); a_idx read V entries a load (V = 4: E % 4 == 0, so the
// four share a group), kScanUnroll loads in flight.  Returns the largest
// live address the thread saw.
template <int V, int NT, int WB>
__device__ __forceinline__ int scan_events(const int32_t* __restrict__ idx,
                                           int tot, int E, const int* cnt,
                                           int* slot, int w0, int tid) {
  int local_max = -1;
  for (int p0 = tid * V; p0 < tot; p0 += NT * V * kScanUnroll) {
    int kb[kScanUnroll][V];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int p = p0 + u * NT * V;
      if constexpr (V == 4) {
        const int4 t = p < tot ? *reinterpret_cast<const int4*>(idx + p)
                               : make_int4(-1, -1, -1, -1);
        kb[u][0] = t.x, kb[u][1] = t.y, kb[u][2] = t.z, kb[u][3] = t.w;
      } else {
        kb[u][0] = p < tot ? idx[p] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int p = p0 + u * NT * V;
      if (p >= tot) break;
      const int g = p / E, e0 = p - g * E;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (e0 + k >= cnt[g]) break;
        local_max = max(local_max, kb[u][k]);
        const int l = kb[u][k] - w0;
        if (l >= 0 && l < WB) slot[g * WB + l] = e0 + k;
      }
    }
  }
  return local_max;
}

}  // namespace

// ALIGNED: N % 4 == 0, bk % 4 == 0 and W and a_vals 16-byte (f32) or
// 4-byte (int8) aligned -- weight rows copied 16 bytes a cp.async,
// activations loaded 4 consecutive values a load; else one value each.
template <typename Tile, typename Sh, bool ALIGNED>
__global__ void __launch_bounds__(Sh::kThreads) mnf_event_matmul_kernel(
    const typename Tile::T* __restrict__ a_vals,
    const int32_t* __restrict__ a_idx, const int32_t* __restrict__ counts,
    const float* __restrict__ scale, const int32_t* __restrict__ zero_point,
    const float* __restrict__ w, float* __restrict__ out, int64_t G, int E,
    int bm, int bk, int64_t N) {
  using T = typename Tile::T;
  constexpr int TM = Sh::TM, TN = Sh::TN, RM = Sh::RM, RN = Sh::RN;
  constexpr int R = Sh::R, S = Sh::S, AD = Sh::AD, WB = Sh::WB;
  constexpr int NT = Sh::kThreads, AST = Sh::AST;
  constexpr int VEC = ALIGNED ? 4 : 1;          // floats a weight copy
  constexpr int VA = ALIGNED ? 4 : 1;           // values an activation load
  constexpr int QL = 8 / VA;                    // loads over 8 rows of q
  constexpr int CH = TM * R / (VA * NT);        // activation loads a thread
  constexpr int CPR = TN / VEC;                 // copies a weight row
  constexpr int WPER = R * CPR / NT;            // copies a thread a stage
  constexpr int QB = Sh::QB;
  constexpr int UQ = QB == 1 ? R : 1;           // unroll of the row loop
  static_assert((R * CPR) % NT == 0, "");

  extern __shared__ __align__(16) float smem[];
  float* ws_ring = smem;                                  // [S][R][TN]
  float* as_ring = ws_ring + S * R * TN;                  // [S][R][AST]
  int* slot = (int*)(as_ring + S * R * AST);              // [TM][WB]
  int* ulist = slot + TM * WB;                            // [WB]
  uint32_t* ubits = (uint32_t*)(ulist + WB);              // [WB / 32]
  int* cnt = (int*)(ubits + WB / 32);                     // [TM]
  int* misc = cnt + TM;           // [0] union length, [1] largest address

  const int tid = threadIdx.x, lane = tid & 31;
  const int tg = TM / bm;
  const int64_t g0 = (int64_t)blockIdx.x * tg;
  const int ng = (int)min((int64_t)tg, G - g0);
  const int rows = ng * bm;
  const int64_t n0 = (int64_t)blockIdx.y * TN;
  const Tile tile(scale, zero_point);
  const MnfDiv div_bk(bk), div_bm(bm);
  const T* a_base = a_vals + g0 * E * bm * bk;
  const int32_t* idx_base = a_idx + g0 * E;
  // this thread's output tile
  const int mr0 = (tid / (TN / RN)) * RM, nc0 = (tid % (TN / RN)) * RN;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int i = tid; i < ng; i += NT)
    cnt[i] = (int)max((int64_t)0, min((int64_t)counts[g0 + i], (int64_t)E));
  if (tid == 0) misc[1] = -1;
  int maxkb = -1;

  for (int w0 = 0;; w0 += WB) {
    for (int i = tid; i < ng * WB; i += NT) slot[i] = -1;
    __syncthreads();
    // -- the slot table: slot[g][kb - w0] = e for each live event --------
    {
      const bool v4 = E % 4 == 0 && (uintptr_t)idx_base % 16 == 0;
      const int local_max =
          v4 ? scan_events<4, NT, WB>(idx_base, ng * E, E, cnt, slot, w0, tid)
             : scan_events<1, NT, WB>(idx_base, ng * E, E, cnt, slot, w0, tid);
      if (w0 == 0) {
        const int m = __reduce_max_sync(~0u, local_max);
        if (lane == 0) atomicMax(&misc[1], m);
      }
    }
    __syncthreads();
    if (w0 == 0) maxkb = misc[1];
    // -- the union of the window: a bit per K-block any group names ------
    const int lim = max(0, min(WB, maxkb - w0 + 1));
    for (int l0 = 0; l0 < lim; l0 += NT) {
      const int l = l0 + tid;
      bool any = false;
      if (l < lim)
        for (int g = 0; g < ng; ++g) any |= slot[g * WB + l] >= 0;
      const uint32_t b = __ballot_sync(~0u, any);
      if (lane == 0 && l < lim) ubits[l >> 5] = b;
    }
    __syncthreads();
    if (tid < 32) {                    // compact the bits, ascending
      const int nwords = (lim + 31) / 32;
      const int per = (nwords + 31) / 32;
      const int lo = min(lane * per, nwords), hi = min(lo + per, nwords);
      int c = 0;
      for (int i = lo; i < hi; ++i) c += __popc(ubits[i]);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl += v;
      }
      int o = incl - c;
      for (int i = lo; i < hi; ++i)
        for (uint32_t b = ubits[i]; b; b &= b - 1) ulist[o++] = i * 32 + __ffs(b) - 1;
      if (lane == 31) misc[0] = incl;
    }
    __syncthreads();

    // -- the walk: union rows p = 0 .. P-1, R a stage ---------------------
    const int P = misc[0] * bk;
    const int nst = (P + R - 1) / R;

    auto issue_w = [&](int t) {      // cp.async the stage's weight rows
      if (t >= nst) return;
      float* dst = ws_ring + (t % S) * R * TN;
#pragma unroll 4
      for (int i = 0; i < WPER; ++i) {
        const int c = tid + i * NT, q = c / CPR, cc = c - q * CPR;
        const int p = t * R + q;
        const int64_t n = n0 + cc * VEC;
        if (p >= P) {                  // past the union: exact zeros
#pragma unroll
          for (int v = 0; v < VEC; ++v) dst[q * TN + cc * VEC + v] = 0.f;
        } else if (n < N) {
          const int ub = div_bk(p);
          const int64_t row = (int64_t)(w0 + ulist[ub]) * bk + (p - ub * bk);
          cp_async<VEC * 4>(dst + q * TN + cc * VEC, w + row * N + n);
        }
      }
    };
    // load k of a thread: rows q .. q+VA-1 of the stage (one K-block: VA
    // divides bk), tile row m
    auto chunk = [&](int k, int& q, int& m) {
      const int c = tid + k * NT;
      q = ((c / (QL * TM)) * QL + c % QL) * VA;
      m = (c / QL) % TM;
    };
    auto load_a = [&](int t, T (&v)[CH][VA]) {  // -> its live bits
      uint32_t live = 0;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        int q, m;
        chunk(k, q, m);
        const int p = t * R + q;
#pragma unroll
        for (int u = 0; u < VA; ++u) v[k][u] = T(0);
        if (t < nst && p < P && m < rows) {
          const int ub = div_bk(p), g = div_bm(m);
          const int e = slot[g * WB + ulist[ub]];
          if (e >= 0) {
            ldg<VA>(a_base + (((int64_t)g * E + e) * bm + (m - g * bm)) * bk +
                        (p - ub * bk),
                    v[k]);
            live |= 1u << k;
          }
        }
      }
      return live;
    };
    auto store_a = [&](int t, const T (&v)[CH][VA], uint32_t live) {
      if (t >= nst) return;
      float* dst = as_ring + (t % S) * R * AST;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        int q, m;
        chunk(k, q, m);
#pragma unroll
        for (int u = 0; u < VA; ++u)
          dst[(q + u) * AST + m] = (live >> k) & 1u ? tile(&v[k][u], 0) : 0.f;
      }
    };

    // Activations in flight: at step i, ring[i % AD] holds the values of
    // stage i + S - 1 - AD (loaded at step i - AD, its live bits in
    // alive[i % AD]); it is stored and refilled with stage i + S - 1.  The
    // step loop is unrolled by AD so that every ring index is static: a
    // register is never moved while its load is in flight.
    T ring[AD][CH][VA];
    uint32_t alive[AD];
    for (int t = 0; t < S - 1; ++t) {    // prologue: stages 0 .. S-2
      issue_w(t);
      cp_async_commit();
      if (t < S - 1 - AD) store_a(t, ring[0], load_a(t, ring[0]));
    }
#pragma unroll
    for (int k = 0; k < AD; ++k) alive[k] = load_a(k + S - 1 - AD, ring[k]);
    for (int i0 = 0; i0 < nst; i0 += AD) {
#pragma unroll
      for (int k = 0; k < AD; ++k) {
        const int i = i0 + k;
        if (i >= nst) break;
        cp_async_wait<S - 2>();
        __syncthreads();
        store_a(i + S - 1 - AD, ring[k], alive[k]);
        issue_w(i + S - 1);
        cp_async_commit();
        alive[k] = load_a(i + S - 1, ring[k]);
        // stage i: every thread the same unpredicated register-tile update
        const float* as = as_ring + (i % S) * R * AST + mr0;
        const float* ws = ws_ring + (i % S) * R * TN + nc0;
        // QB rows' operands are loaded before their FMAs, so that with
        // few warps an SM (FC) one row's shared-memory latency does not
        // stall the next row's FMA chain
#pragma unroll UQ
        for (int q0 = 0; q0 < R; q0 += QB) {
          float a[QB][RM], b[QB][RN];
#pragma unroll
          for (int u = 0; u < QB; ++u) {
            lds<RM>(as + (q0 + u) * AST, a[u]);
            lds<RN>(ws + (q0 + u) * TN, b[u]);
          }
#pragma unroll
          for (int u = 0; u < QB; ++u)
#pragma unroll
            for (int r = 0; r < RM; ++r)
#pragma unroll
              for (int c = 0; c < RN; ++c)
                acc[r][c] = fmaf(a[u][r], b[u][c], acc[r][c]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (w0 + WB > maxkb) break;
  }

  // -- write the tile; rows past the CTA's groups and columns >= N masked --
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = mr0 + r;
    if (m >= rows) continue;
    float* o = out + (g0 * bm + m) * N + n0 + nc0;
    if constexpr (VEC == 4 && RN % 4 == 0) {
#pragma unroll
      for (int c = 0; c < RN; c += 4)
        if (n0 + nc0 + c < N)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2],
                          acc[r][c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < RN; ++c)
        if (n0 + nc0 + c < N) o[c] = acc[r][c];
    }
  }
}

template <typename Tile, typename Sh, bool ALIGNED>
static int launch_shape(const void* a_vals, const void* a_idx,
                        const void* counts, const void* scale,
                        const void* zero_point, const void* w, void* out,
                        int64_t G, int64_t E, int64_t bm, int64_t bk,
                        int64_t N, cudaStream_t stream) {
  auto kern = mnf_event_matmul_kernel<Tile, Sh, ALIGNED>;
  static bool sized = false;   // the attribute once, not at every launch
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int64_t tg = Sh::TM / bm;
  const dim3 grid((unsigned)((G + tg - 1) / tg),
                  (unsigned)((N + Sh::TN - 1) / Sh::TN));
  kern<<<grid, Sh::kThreads, Sh::kSmem, stream>>>(
      (const typename Tile::T*)a_vals, (const int32_t*)a_idx,
      (const int32_t*)counts, (const float*)scale,
      (const int32_t*)zero_point, (const float*)w, (float*)out, G, (int)E,
      (int)bm, (int)bk, N);
  return (int)cudaGetLastError();
}

template <typename Tile>
static int launch_event_matmul(const void* a_vals, const void* a_idx,
                               const void* counts, const void* scale,
                               const void* zero_point, const void* w,
                               void* out, int64_t G, int64_t E, int64_t bm,
                               int64_t bk, int64_t N, void* stream) {
  const bool fc = G * bm <= FcShape::TM;
  const bool aligned = N % 4 == 0 && bk % 4 == 0 && (uintptr_t)w % 16 == 0 &&
                       (uintptr_t)a_vals % (4 * sizeof(typename Tile::T)) == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define MNF_LAUNCH(SH, A)                                                  \
  launch_shape<Tile, SH, A>(a_vals, a_idx, counts, scale, zero_point, w,  \
                            out, G, E, bm, bk, N, s)
  if (fc) return aligned ? MNF_LAUNCH(FcShape, true) : MNF_LAUNCH(FcShape, false);
  return aligned ? MNF_LAUNCH(ConvShape, true) : MNF_LAUNCH(ConvShape, false);
#undef MNF_LAUNCH
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
