// B3 and B6: the fused strip conv, one launch per conv layer, by hand for
// Hopper.
//
// Replaces src/repro/kernels/event_conv/kernel.py event_conv_pallas (:168,
// body event_conv_kernel :76) and event_conv_int8_pallas (:227, body
// event_conv_int8_kernel :115).  For output strip g (8 pixels of one output
// row) and each compacted subtap t of the strip_tap_map plan:
//   tap_acc = sum_{e < cnt[g,t]} remap_t(a[src[g,t], e]) @ ws[tap[t]*nkb + a_idx]
//   acc += tap_acc
// where remap_t moves out row i <- src row stride*i + shift[t], exact 0
// where no row maps.  B6 takes int8 codes and dequantizes each sourced one
// as (q - zp) * scale (mnf_common.cuh MnfInt8Tile); one body for both.
//
// The per-tap flush.  The straddle parts (subtaps) of one tap are
// contiguous in the plan, taps ascend, and the parts of a tap source each
// output row of a strip exactly once (pinned for every geometry the port
// plans in tests/test_torch_events.py).  So an output row's sum is, tap by
// tap: its one sourcing part's events e ascending, j ascending, one fmaf
// each into tap_acc from +0, then acc += tap_acc; the other parts add an
// exact +0 (acc starts at +0 and an f32 add of two values that are not
// both -0 is never -0).  This kernel sums per tap and flushes once per tap:
// bitwise a per-subtap flush (the plain version's order, ref.py) and the
// per-tap path's `acc = acc + tap` (B2 x k*k).
//
// Bound on the H100: f32 FMA issue on CUDA cores (conv1_2 of VGG16@224 at
// batch 4: 14.8 GFLOP, 0.22 ms at 67 TFLOP/s); no tensor cores (the
// exactness lane).
//
// Design.  A CTA takes 16 consecutive output strips (128 output rows) and
// a 64-column tile; each of its 128 threads holds 8 x 8 outputs -- one
// strip's 8 rows by 8 columns -- tap_acc in registers and acc in a shared
// memory tile that only the thread itself touches.  First the CTA reads
// its plan: for each (strip, subtap) the live K-blocks of the source strip
// as a bit set, for each tap the union of those sets over the CTA's strips
// and the tap's parts, and a table of stages: the union's rows ascending,
// 16 a stage (union row p of a tap is weight row
// (tap*nkb + union[p / bk])*bk + p % bk), tap after tap, a tap with an
// empty union skipped.  A stage's (16 x 64) weight rows stream through a
// ring of 4 stages by cp.async (16 bytes a copy; 4 where N, bk or a
// pointer is not aligned), each read once per CTA for its 128 rows.  Its
// (16 x 128) activations are loaded two stages ahead into registers, one
// output row a thread -- the row's sourcing part of the tap, its source
// strip, and its event e of the block: the count of the row's live blocks
// below it, since a_idx ascends -- and stored to shared memory once per
// CTA, B6's dequantized there.  A row whose source strip lacks the block,
// or that lies past the layer's strips, gets exact zeros, so every thread
// runs the same 8 x 8 register-tile update, one fmaf a term.  Two CTAs an
// SM (~165 registers a thread).  What holds it (H100 runs of
// tools/torch_conv_variants.py, PERF.md): with no operand traffic at all
// the walk still takes ~0.35 ms at conv1_2 (~62% of the FMA rate); the
// operand traffic adds ~0.13 ms on top, most of it the activation loads.
// The kernel allocates nothing and never synchronises the host, so a CUDA
// graph can capture it.
#include "mnf_common.cuh"

namespace {

constexpr int kStrips = 16;             // output strips a CTA
constexpr int kBM = 8;                  // rows (pixels) a strip
constexpr int kTM = kStrips * kBM;      // output rows a CTA
constexpr int kTN = 64;                 // output columns a CTA
constexpr int kThreads = 128;           // 8 x 8 outputs a thread
constexpr int kR = 16;                  // union rows a stage
constexpr int kS = 4;                   // weight ring stages
constexpr int kAST = kTM + 4;           // row stride of a staged [q][m] tile
constexpr size_t kMaxSmem = 232448;     // shared memory a CTA can have
static_assert(kThreads == kTM && kThreads == kStrips * (kTN / 8) &&
                  kR % 8 == 0 && kR <= 32 && kR * kTN % (4 * kThreads) == 0,
              "");

// The dynamic shared memory of one CTA: the rings and the accumulator
// tile, then the plan tables sized by the plan's T subtaps, nkb K-blocks
// and bk.
struct ConvLayout {
  int T, nw, nkb, smax;
  __host__ __device__ ConvLayout(int T_, int nkb_, int bk)
      : T(T_), nw((nkb_ + 31) / 32), nkb(nkb_),
        smax(T_ * ((nkb_ * bk + kR - 1) / kR)) {}
  __host__ __device__ size_t floats() const {
    return (size_t)kS * kR * kTN + 2 * kR * kAST + kTM * kTN;
  }
  __host__ __device__ size_t lists() const { return (size_t)kStrips * T; }
  // lbits, s_of; per subtap: shift, first; per tap: t0 (T + 1), tap
  // index, union count, union offset, stages, stage offset, union bits
  // (nw), union (nkb); per stage: tap, stage in tap; misc 4
  __host__ __device__ size_t ints() const {
    return lists() * nw + lists() + 2 * (size_t)T + (T + 1) +
           5 * (size_t)T + (size_t)T * nw + (size_t)T * nkb +
           2 * (size_t)smax + 4;
  }
  __host__ __device__ size_t bytes() const { return 4 * (floats() + ints()); }
};

// 8 consecutive activation values (f32 or int8 codes) from device memory:
// two 16-byte loads (f32) or two 4-byte loads (int8).
template <typename T>
__device__ __forceinline__ void ldg8(const T* p, T* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const char4* c = reinterpret_cast<const char4*>(p);
    const char4 a = c[0], b = c[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

}  // namespace

// ALIGNED: bk % 8 == 0, N % 4 == 0, ws 16-byte and a_vals 16-byte (f32) or
// 8-byte (int8) aligned -- 8 union rows from a multiple of 8 are 8
// consecutive values of one K-block, loaded at once, and weight rows are
// copied 16 bytes a cp.async; else one value each.  Offsets are 32-bit:
// the launcher refuses tensors of 2^31 elements or more.
template <typename Tile, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2) mnf_event_conv_kernel(
    const typename Tile::T* __restrict__ a_vals,
    const int32_t* __restrict__ a_idx, const int32_t* __restrict__ tap,
    const int32_t* __restrict__ shift, const int32_t* __restrict__ src,
    const int32_t* __restrict__ cnt, const float* __restrict__ scale,
    const int32_t* __restrict__ zero_point, const float* __restrict__ ws,
    float* __restrict__ out, int G, int E, int bk, int N, int T, int nkb,
    int stride) {
  using T8 = typename Tile::T;
  constexpr int VEC = ALIGNED ? 4 : 1;          // floats a weight copy
  constexpr int CPR = kTN / VEC;                // copies a weight row
  const ConvLayout lay(T, nkb, bk);
  const int nw = lay.nw;

  extern __shared__ __align__(16) float smem[];
  float* ws_ring = smem;                                  // [kS][kR][kTN]
  float* as_ring = ws_ring + kS * kR * kTN;               // [2][kR][kAST]
  float* acc_s = as_ring + 2 * kR * kAST;                 // [kTM][kTN]
  uint32_t* lbits = (uint32_t*)(acc_s + kTM * kTN);       // [lists][nw]
  int* s_of = (int*)(lbits + lay.lists() * nw);           // [lists]
  int* shift_s = s_of + lay.lists();                      // [T]
  int* first = shift_s + T;                               // [T]
  int* t0 = first + T;                                    // [T + 1]
  int* tapv = t0 + T + 1;                                 // [T]
  int* ucnt = tapv + T;                                   // [T]
  int* uoff = ucnt + T;                                   // [T]
  int* nst = uoff + T;                                    // [T]
  int* soff = nst + T;                                    // [T]
  uint32_t* ubits = (uint32_t*)(soff + T);                // [T][nw]
  int* ulist = (int*)(ubits + T * nw);                    // [T * nkb]
  int* stau = ulist + T * nkb;                            // [smax]
  int* sst = stau + lay.smax;                             // [smax]
  int* misc = sst + lay.smax;              // [0] taps, [1] stages

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * kStrips;
  const int n0 = blockIdx.y * kTN;
  const Tile tile(scale, zero_point);
  const MnfDiv div_bk(bk);

  // -- the plan: tap groups (contiguous subtaps of one tap index) ---------
  for (int t = tid; t < T; t += kThreads) {
    const int v = tap[t];
    shift_s[t] = shift[t];
    tapv[t] = v;
    first[t] = t == 0 || tap[t - 1] != v;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < T; ++t)
      if (first[t]) {
        tapv[n] = tapv[t];
        t0[n++] = t;
      }
    t0[n] = T;
    misc[0] = n;
  }
  // -- each (strip, subtap): the source strip's live K-blocks as bits ------
  for (int l = tid; l < kStrips * T; l += kThreads) {
    const int gl = l / T, t = l - gl * T, g = g0 + gl;
    uint32_t* b = lbits + l * nw;
    for (int w = 0; w < nw; ++w) b[w] = 0;
    int c = 0, s = 0;
    if (g < G) {
      c = max(0, min(cnt[g * T + t], E));
      s = src[g * T + t];
    }
    s_of[l] = s;
    const int32_t* idx = a_idx + s * E;
#pragma unroll 4
    for (int e = 0; e < c; ++e) {
      const int kb = idx[e];
      if ((unsigned)kb < (unsigned)nkb) b[kb >> 5] |= 1u << (kb & 31);
    }
  }
  __syncthreads();
  const int ntaps = misc[0];
  // -- each tap: the union over the CTA's strips and the tap's parts -------
  for (int k = tid; k < ntaps * nw; k += kThreads) {
    const int tau = k / nw, w = k - tau * nw;
    uint32_t u = 0;
    for (int gl = 0; gl < kStrips; ++gl)
      for (int t = t0[tau]; t < t0[tau + 1]; ++t)
        u |= lbits[(gl * T + t) * nw + w];
    ubits[k] = u;
  }
  __syncthreads();
  for (int tau = tid; tau < ntaps; tau += kThreads) {
    int c = 0;
    for (int w = 0; w < nw; ++w) c += __popc(ubits[tau * nw + w]);
    ucnt[tau] = c;
    nst[tau] = (c * bk + kR - 1) / kR;
  }
  __syncthreads();
  if (tid == 0) {
    int off = 0, ns = 0;
    for (int tau = 0; tau < ntaps; ++tau) {
      uoff[tau] = off;
      soff[tau] = ns;
      off += ucnt[tau];
      ns += nst[tau];
    }
    misc[1] = ns;
  }
  __syncthreads();
  // -- the union lists and the stage table: stage i is stage sst[i] of tap
  //    stau[i] (taps with an empty union have none) -------------------------
  for (int tau = tid; tau < ntaps; tau += kThreads) {
    int o = uoff[tau];
    for (int w = 0; w < nw; ++w)
      for (uint32_t b = ubits[tau * nw + w]; b; b &= b - 1)
        ulist[o++] = w * 32 + __ffs(b) - 1;
    for (int st = 0; st < nst[tau]; ++st) {
      stau[soff[tau] + st] = tau;
      sst[soff[tau] + st] = st;
    }
  }
  __syncthreads();
  const int nstages = misc[1];

  // -- the walk ------------------------------------------------------------
  // this thread's weight copies of a stage: row q of it, column chunk cc4
  auto issue_w = [&](int i, int slot) {
    const int tau = stau[i], p0 = sst[i] * kR, P = ucnt[tau] * bk;
    const int slab = tapv[tau] * nkb;
    const int* ul = ulist + uoff[tau];
    float* dst = ws_ring + slot * kR * kTN;
#pragma unroll
    for (int u = 0; u < kR * CPR / kThreads; ++u) {
      const int k = tid + u * kThreads;
      const int q = k / CPR, cc4 = k - q * CPR, p = p0 + q;
      const int n = n0 + cc4 * VEC;
      float* d = dst + q * kTN + cc4 * VEC;
      if (p < P && n < N) {
        const int ub = div_bk(p);
        cp_async<VEC * 4>(d, ws + ((slab + ul[ub]) * bk + p - ub * bk) * N + n);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) d[v] = 0.f;
      }
    }
  };

  // this thread's output row of the activation tile: strip tid / 8, row
  // tid % 8; per tap, its sourcing part's live bits and its first value
  const int row_i = tid & (kBM - 1), row_g = tid / kBM;
  int row_tau = -1, row_list = 0, row_base = 0;
  uint32_t row_bits = 0;            // the live bits when nkb <= 32
  bool row_live = false;
  auto load_a = [&](int i, T8 (&v)[kR]) -> uint32_t {
#pragma unroll
    for (int q = 0; q < kR; ++q) v[q] = T8(0);
    const int tau = stau[i];
    if (tau != row_tau) {
      row_tau = tau;
      row_live = false;
      if (g0 + row_g < G)
        for (int t = t0[tau]; t < t0[tau + 1]; ++t) {
          const int r = stride * row_i + shift_s[t];
          if (r >= 0 && r < kBM) {
            row_list = row_g * T + t;
            row_base = (s_of[row_list] * E * kBM + r) * bk;
            row_bits = lbits[row_list * nw];
            row_live = true;
            break;
          }
        }
    }
    if (!row_live) return 0u;
    const int* ul = ulist + uoff[tau];
    const int P = ucnt[tau] * bk, p0 = sst[i] * kR;
    // the event of K-block kb in the row's live set: the number of live
    // blocks below it (a strip's live a_idx ascend), or -1
    auto event_of = [&](int kb) {
      const int w = kb >> 5;
      const uint32_t bit = 1u << (kb & 31);
      const uint32_t word = nw == 1 ? row_bits : lbits[row_list * nw + w];
      if (!(word & bit)) return -1;
      int e = __popc(word & (bit - 1));
      for (int k = 0; k < w; ++k) e += __popc(lbits[row_list * nw + k]);
      return e;
    };
    uint32_t live = 0;
    if constexpr (ALIGNED) {   // 8 rows p .. p+7 lie in one K-block
#pragma unroll
      for (int q = 0; q < kR; q += 8) {
        const int p = p0 + q;
        if (p >= P) break;
        const int ub = div_bk(p);
        const int e = event_of(ul[ub]);
        if (e < 0) continue;
        ldg8(a_vals + row_base + e * kBM * bk + (p - ub * bk), v + q);
        live |= 0xffu << q;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int p = p0 + q;
        if (p >= P) break;
        const int ub = div_bk(p);
        const int e = event_of(ul[ub]);
        if (e >= 0) {
          v[q] = a_vals[row_base + e * kBM * bk + (p - ub * bk)];
          live |= 1u << q;
        }
      }
    }
    return live;
  };
  // an f32 value that was not loaded is 0 already; a code is dequantized
  // only where it was loaded (with zp != 0, a code of 0 is no zero value)
  auto store_a = [&](int slot, const T8 (&v)[kR], uint32_t live) {
    float* dst = as_ring + slot * kR * kAST + tid;
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      if constexpr (sizeof(T8) == 4)
        dst[q * kAST] = tile(&v[q], 0);
      else
        dst[q * kAST] = (live >> q) & 1u ? tile(&v[q], 0) : 0.f;
    }
  };

  // this thread's outputs: strip tm, columns tn*4 .. +3 and 32 + tn*4 .. +3;
  // tap_acc in registers, acc in shared memory (only this thread's own)
  const int tm = tid / 8, tn = tid % 8;
  float* acc = acc_s + tm * 8 * kTN + tn * 4;
  float tap_acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) tap_acc[r][c] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(acc + r * kTN + h * 32) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int i = 0; i < kS - 1; ++i) {    // prologue: weight stages 0 .. S-2
    if (i < nstages) issue_w(i, i);
    cp_async_commit();
  }
  T8 va[kR];
  uint32_t alive = 0;
  if (nstages > 0) {                    // stage 0 stored now, stage 1 at
    alive = load_a(0, va);              // step 0
    store_a(0, va, alive);
  }
  if (nstages > 1) alive = load_a(1, va);
  for (int i = 0; i < nstages; ++i) {
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (i + 1 < nstages) store_a((i + 1) & 1, va, alive);
    if (i + kS - 1 < nstages) issue_w(i + kS - 1, (i + kS - 1) % kS);
    cp_async_commit();
    if (i + 2 < nstages) alive = load_a(i + 2, va);
    // stage i: the same unpredicated 8 x 8 update in every thread, 8 rows
    // unrolled (aligned: nq is a multiple of 8)
    const int tau = stau[i], st = sst[i];
    const int nq = min(kR, ucnt[tau] * bk - st * kR);
    const float* as = as_ring + (i & 1) * kR * kAST + tm * 8;
    const float* wsp = ws_ring + (i % kS) * kR * kTN + tn * 4;
#pragma unroll 1
    for (int q0 = 0; q0 < nq; q0 += 8) {
#pragma unroll
      for (int q = q0; q < q0 + 8; ++q) {
        if (!ALIGNED && q >= nq) break;
        float a[8], b[4], b2[4];
        lds<8>(as + q * kAST, a);
        lds<4>(wsp + q * kTN, b);
        lds<4>(wsp + q * kTN + 32, b2);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            tap_acc[r][c] = fmaf(a[r], b[c], tap_acc[r][c]);
            tap_acc[r][c + 4] = fmaf(a[r], b2[c], tap_acc[r][c + 4]);
          }
      }
    }
    if (st + 1 == nst[tau]) {           // the tap's last stage: flush
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4* o = reinterpret_cast<float4*>(acc + r * kTN + h * 32);
          float4 v = *o;
          float* t = tap_acc[r] + 4 * h;
          v.x = __fadd_rn(v.x, t[0]), v.y = __fadd_rn(v.y, t[1]);
          v.z = __fadd_rn(v.z, t[2]), v.w = __fadd_rn(v.w, t[3]);
          *o = v;
          t[0] = t[1] = t[2] = t[3] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  // -- write the tile; strips past G and columns >= N masked ----------------
  const int g = g0 + tm;
  if (g >= G) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* o = out + (g * kBM + r) * N + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = h * 32 + tn * 4;
      const float4 v = *reinterpret_cast<const float4*>(acc + r * kTN + h * 32);
      if constexpr (VEC == 4) {
        if (n0 + n < N) *reinterpret_cast<float4*>(o + n) = v;
      } else {
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n0 + n + c < N) o[n + c] = f[c];
      }
    }
  }
}

template <typename Tile, bool ALIGNED>
static int launch_aligned(const void* a_vals, const void* a_idx,
                          const void* tap, const void* shift, const void* src,
                          const void* cnt, const void* scale,
                          const void* zero_point, const void* ws, void* out,
                          int64_t G_out, int64_t E, int64_t bk, int64_t N,
                          int64_t T, int64_t nkb, int64_t row_stride,
                          cudaStream_t stream) {
  auto kern = mnf_event_conv_kernel<Tile, ALIGNED>;
  const size_t smem = ConvLayout((int)T, (int)nkb, (int)bk).bytes();
  static size_t sized = 0;   // the attributes only when they must grow
  if (smem > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && sized == 0)   // four CTAs an SM
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  const dim3 grid((unsigned)((G_out + kStrips - 1) / kStrips),
                  (unsigned)((N + kTN - 1) / kTN));
  kern<<<grid, kThreads, smem, stream>>>(
      (const typename Tile::T*)a_vals, (const int32_t*)a_idx,
      (const int32_t*)tap, (const int32_t*)shift, (const int32_t*)src,
      (const int32_t*)cnt, (const float*)scale, (const int32_t*)zero_point,
      (const float*)ws, (float*)out, (int)G_out, (int)E, (int)bk, (int)N,
      (int)T, (int)nkb, (int)row_stride);
  return (int)cudaGetLastError();
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
  // kernels/event_conv/kernel.py refuses the first two with a message; a
  // plan too large for a CTA's shared memory returns cudaErrorInvalidValue
  const int64_t lim = (int64_t)1 << 31;
  if (bm != kBM || G_out * kBM * N >= lim || G_out * T >= lim ||
      ConvLayout((int)T, (int)nkb, (int)bk).bytes() > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      bk % 8 == 0 && N % 4 == 0 && (uintptr_t)ws % 16 == 0 &&
      (uintptr_t)a_vals % (sizeof(typename Tile::T) == 4 ? 16 : 8) == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define MNF_LAUNCH(A)                                                        \
  launch_aligned<Tile, A>(a_vals, a_idx, tap, shift, src, cnt, scale,       \
                          zero_point, ws, out, G_out, E, bk, N, T, nkb,     \
                          row_stride, s)
  return aligned ? MNF_LAUNCH(true) : MNF_LAUNCH(false);
#undef MNF_LAUNCH
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
