// B10: the selective scan of the Mamba prefill, by hand for Hopper.
//
// Replaces src/repro/kernels/mamba_scan/kernel.py mamba_scan_pallas (body
// mamba_scan_kernel) with its padding wrapper mamba_scan/ops.py mamba_scan.
// For each batch row b and channel d:
//
//   h_t = da_t h_{t-1} + dbx_t          (h: (DI, N); h_{-1} = h0, or 0)
//   y_t = sum_{n<N} h_t[:, n] c_t[n]
//
// Two entries share one walk.  mnf_mamba_scan takes the streams da and
// dbx, (B, T, DI, N) f32, as the TPU kernel does.  mnf_mamba_scan_fused
// takes their sources — dt and x (B, T, DI), A (DI, N), B and C (B, T, N),
// f32 or bf16 (bf16 -> f32 is exact) — and forms each element's streams in
// registers with the prefill's own operations in its own order:
// da = expf(dt * A) (a round-to-nearest multiply, then the expf that
// torch.exp runs), dbx = (dt * x) * B (two round-to-nearest multiplies).
// So a step of either entry sees the same da and dbx, and the fused entry
// reads no stream at all.
//
// The TPU keeps a (D_blk, N) state in VMEM and walks T in a sequential grid
// dimension.  Here a thread keeps V state elements (b, d, n..n+V-1) of one
// channel in registers and walks t = 0..T-1 itself.  The walk is bound by
// its instructions a step, not by bytes (measured: with no input loaded it
// takes most of its time), so at N = 16 (Hymba's) a thread takes V = 4
// elements: one 16-byte load a stream a step (8 bytes for four bf16 of B
// or C; four 4-byte loads where a row is not aligned to that), four
// independent update chains, and the step's pointer, loop and bound work
// paid once for four elements; 4 lanes a channel, 16 channels a CTA of 64
// threads: 400 CTAs at Hymba-1.5B batch 4 (DI 1600).  Any other N takes
// V = 1, a thread an element, 256 / N channels a CTA.  The loads are
// software-pipelined: a thread keeps the raw inputs of the next `depth`
// steps in registers (8 at V = 4, which may use up to 255 registers; 4 at
// V = 1); a step takes its slot's values, issues the load of the step
// `depth` ahead into the slot, then updates h.  Only the last groups of
// steps check t against T.  The update uses round-to-nearest intrinsics
// that nvcc never contracts, so h is bitwise the plain version's
// da * h + dbx  (a separate multiply and add).
//
// The readout y_t stays off the walk's chain.  At N = 16 a thread sums its
// 4 products ascending, then a channel's 4 lanes reduce 4 steps at once
// (reduce_steps: 3 shuffles for 4 steps, each step's sum bitwise the
// butterfly xor 2, 1), lane q storing step q's.  Any other N (up to
// 1024; no model runs another on the card) puts the products in shared
// memory (double-buffered: one barrier a step) and the channel's n = 0
// thread sums them in order.
// Each order is fixed and depends on N alone, so two launches with h
// carried equal one over the whole T, and both entries' y are bitwise
// equal.  Channels >= DI of the last CTA are masked (their loads read
// channel 0): no padded copies of the inputs; T needs no padding either.
//
// Bound on the H100.  Streams entry: bytes — da and dbx are read once,
// 2 x 13.1 MB at batch 4, prompt 32, DI 1600, N 16, plus c, h0, y and h:
// ~27.9 MB, ~8.3 us at 3.35 TB/s.  Fused entry: ~1/16 of those bytes (dt
// and x are N times narrower than a stream); its time is the walk's
// instructions (an expf an element and step) and the step's latency.
#include <cuda_bf16.h>

#include "mnf_common.cuh"

namespace {

constexpr int kThreads = 256;    // threads a CTA at V = 1 (N <= 256)
constexpr int kThreads4 = 64;    // threads a CTA at V = 4 (N = 16)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive values of type In widened to f32 at use (bf16 -> f32 is
// exact): V accesses, or one (16 or 8 bytes) where WIDE.
template <typename In, int V, bool WIDE>
struct Vec {
  In v[V];
  __device__ __forceinline__ void load(const In* p) {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
  __device__ __forceinline__ float get(int i) const { return widen(v[i]); }
};
template <>
struct Vec<float, 4, true> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 4, true> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    const unsigned w = i < 2 ? v.x : v.y;
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};

}  // namespace

struct MambaScanStreamArgs {
  const float* da;
  const float* dbx;
  const float* c;
};

// The streams entry: da, dbx (B, T, DI, N) f32, c (B, T, N) f32.
template <int V_, bool WIDE>
struct MambaScanStreams {
  static constexpr int V = V_;
  static constexpr bool wide = WIDE;
  static constexpr int depth = V == 4 ? 8 : 4;   // steps in flight
  static constexpr int max_threads = V == 4 ? 256 : 1024;
  using Args = MambaScanStreamArgs;
  struct Raw {
    Vec<float, V, WIDE> a, x, c;
  };
  const float *pa, *px, *pc;
  int64_t step, cstep;
  __device__ __forceinline__ MambaScanStreams(const Args& g, int64_t b,
                                              int d, int n, int64_t T,
                                              int DI, int N)
      : step((int64_t)DI * N), cstep(N) {
    const int64_t base = b * T * step + (int64_t)d * N + n;
    pa = g.da + base;
    px = g.dbx + base;
    pc = g.c + b * T * N + n;
  }
  // the raw inputs of the next step (steps are loaded in order)
  __device__ __forceinline__ Raw load() {
    Raw r;
    r.a.load(pa), r.x.load(px), r.c.load(pc);
    pa += step, px += step, pc += cstep;
    return r;
  }
  __device__ __forceinline__ void form(const Raw& r, int v, float& a,
                                       float& x, float& c) const {
    a = r.a.get(v), x = r.x.get(v), c = r.c.get(v);
  }
};

template <typename In>
struct MambaScanSourceArgs {
  const In* dt;
  const In* x;
  const float* A;
  const In* B;
  const In* C;
  int64_t dt_b, dt_t, x_b, x_t, B_b, B_t, C_b, C_t;
};

// The fused entry: dt, x (B, T, DI) and B, C (B, T, N) of type In, each
// with its own row and step strides (unit stride in the last dimension),
// A (DI, N) f32.  A thread keeps one pointer a source, each advanced a
// step at a time.
template <typename In, int V_, bool WIDE>
struct MambaScanSources {
  static constexpr int V = V_;
  static constexpr bool wide = WIDE;
  static constexpr int depth = V == 4 ? 8 : 4;   // steps in flight
  static constexpr int max_threads = V == 4 ? 256 : 1024;
  using Args = MambaScanSourceArgs<In>;
  struct Raw {
    Vec<In, 1, false> dt, x;
    Vec<In, V, WIDE> b, c;
  };
  const In *pdt, *px, *pb, *pc;     // the next step to load
  const Args& g;
  float a[V];
  __device__ __forceinline__ MambaScanSources(const Args& g_, int64_t b,
                                              int d, int n, int64_t, int,
                                              int N)
      : pdt(g_.dt + b * g_.dt_b + d), px(g_.x + b * g_.x_b + d),
        pb(g_.B + b * g_.B_b + n), pc(g_.C + b * g_.C_b + n), g(g_) {
    Vec<float, V, WIDE> av;
    av.load(g_.A + (int64_t)d * N + n);
#pragma unroll
    for (int v = 0; v < V; ++v) a[v] = av.get(v);
  }
  // the raw inputs of the next step (steps are loaded in order)
  __device__ __forceinline__ Raw load() {
    Raw r;
    r.dt.load(pdt), r.x.load(px), r.b.load(pb), r.c.load(pc);
    pdt += g.dt_t, px += g.x_t, pb += g.B_t, pc += g.C_t;
    return r;
  }
  __device__ __forceinline__ void form(const Raw& r, int v, float& da,
                                       float& dbx, float& c) const {
    const float dt = r.dt.get(0);
    da = expf(__fmul_rn(dt, a[v]));
    dbx = __fmul_rn(__fmul_rn(dt, r.x.get(0)), r.b.get(v));
    c = r.c.get(v);
  }
};

// Src::V state elements a thread: at V = 4 (N = 16) a channel's 4 lanes
// reduce the readouts of 4 steps at once; at V = 1 the readout goes
// through shared memory.
template <class Src>
__global__ void __launch_bounds__(Src::max_threads) mnf_mamba_scan_kernel(
    typename Src::Args g, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ h_out, int64_t T, int DI,
    int N, int cpc) {
  constexpr int V = Src::V;
  constexpr int kDepth = Src::depth;
  // steps whose readouts reduce at once (= a channel's lanes)
  constexpr int kBatch = V == 4 ? 4 : 1;
  constexpr int kUnroll = kBatch > kDepth ? kBatch : kDepth;
  extern __shared__ float prod[];        // (2, blockDim) readout products
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lanes = N / V;
  const int ch = tid / lanes, q = tid - ch * lanes;
  const int d = blockIdx.x * cpc + ch;
  const int64_t b = blockIdx.y;
  const bool valid = d < DI;
  Src src(g, b, valid ? d : 0, q * V, T, DI, N);
  const int64_t state = (b * DI + d) * N + q * V;
  float h[V];
  Vec<float, V, Src::wide> hv{};
  if (valid && h0 != nullptr) hv.load(h0 + state);
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = hv.get(v);
  typename Src::Raw ring[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j)
    if (j < T) ring[j] = src.load();
  float pv[kBatch];
  int buf = 0;

  // kUnroll steps from t0; CHECK: some step or load of them lies past T
  auto walk = [&](int64_t t0, auto check) {
    constexpr bool CHECK = decltype(check)::value;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t t = t0 + j;
      const bool in = !CHECK || t < T;   // the same for every thread
      float p = 0.f;
      if (in) {
        const typename Src::Raw r = ring[j % kDepth];
        if (!CHECK || t + kDepth < T) ring[j % kDepth] = src.load();
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float a, x, c;
          src.form(r, v, a, x, c);
          h[v] = __fadd_rn(__fmul_rn(a, h[v]), x);
          const float pr = __fmul_rn(h[v], c);
          p = v == 0 ? pr : __fadd_rn(p, pr);
        }
      }
      if constexpr (V == 4) {
        pv[j % kBatch] = p;
        if (j % kBatch == kBatch - 1) {
          reduce_steps<kBatch>(pv, q);
          const int64_t ts = t - (kBatch - 1) + q;
          if (valid && ts < T) y[(b * T + ts) * DI + d] = pv[0];
        }
      } else if (in) {
        prod[buf * nt + tid] = p;
        __syncthreads();
        if (valid && q == 0) {
          const float* s = prod + buf * nt + ch * N;
          float sum = 0.f;
          for (int k = 0; k < N; ++k) sum = __fadd_rn(sum, s[k]);
          y[(b * T + t) * DI + d] = sum;
        }
        buf ^= 1;                        // the next step writes the other half
      }
    }
  };
  int64_t t0 = 0;
  for (; t0 + kUnroll + kDepth <= T; t0 += kUnroll) walk(t0, Checked<false>{});
  for (; t0 < T; t0 += kUnroll) walk(t0, Checked<true>{});
  if (valid) {
    if constexpr (V == 4 && Src::wide) {
      stv<4>(h_out + state, h);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) h_out[state + v] = h[v];
    }
  }
}

namespace {

// S4 and S4n: the N = 16 walk with 16-byte (8 for bf16) or 4 single
// accesses a stream; S1: a thread a state element.
template <class S1, class S4, class S4n>
int launch_scan(const typename S1::Args& g, bool wide, const void* h0,
                void* y, void* h_out, int64_t B, int64_t T, int64_t DI,
                int64_t N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* h0f = (const float*)h0;
  if (N == 16) {
    const int cpc = kThreads4 / 4;
    const dim3 grid((unsigned)((DI + cpc - 1) / cpc), (unsigned)B);
    if (wide && (uintptr_t)h0 % 16 == 0 && (uintptr_t)h_out % 16 == 0)
      mnf_mamba_scan_kernel<S4><<<grid, kThreads4, 0, st>>>(
          g, h0f, (float*)y, (float*)h_out, T, (int)DI, (int)N, cpc);
    else
      mnf_mamba_scan_kernel<S4n><<<grid, kThreads4, 0, st>>>(
          g, h0f, (float*)y, (float*)h_out, T, (int)DI, (int)N, cpc);
    return (int)cudaGetLastError();
  }
  const int cpc = N >= kThreads ? 1 : (int)(kThreads / N);
  const int threads = cpc * (int)N;
  const dim3 grid((unsigned)((DI + cpc - 1) / cpc), (unsigned)B);
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  mnf_mamba_scan_kernel<S1><<<grid, threads, smem, st>>>(
      g, h0f, (float*)y, (float*)h_out, T, (int)DI, (int)N, cpc);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

}  // namespace

// da, dbx (B, T, DI, N) f32, c (B, T, N) f32, h0 (B, DI, N) f32 or null
// (zeros) -> y (B, T, DI), h_out (B, DI, N).
extern "C" int mnf_mamba_scan(const void* da, const void* dbx, const void* c,
                              const void* h0, void* y, void* h_out,
                              int64_t B, int64_t T, int64_t DI, int64_t N,
                              void* stream) {
  const MambaScanStreamArgs g{(const float*)da, (const float*)dbx,
                              (const float*)c};
  const bool wide = aligned(da, 16) && aligned(dbx, 16) && aligned(c, 16);
  return launch_scan<MambaScanStreams<1, false>, MambaScanStreams<4, true>,
                     MambaScanStreams<4, false>>(g, wide, h0, y, h_out, B, T,
                                                 DI, N, stream);
}

// dt, x (B, T, DI) and bm, cm (B, T, N), all f32 (bf16 == 0) or all bf16
// (bf16 == 1), each with strides (s_b, s_t, 1) given in elements; a (DI, N)
// f32; h0 (B, DI, N) f32 or null (zeros) -> y (B, T, DI), h_out (B, DI, N).
extern "C" int mnf_mamba_scan_fused(
    const void* dt, const void* x, const void* a, const void* bm,
    const void* cm, const void* h0, void* y, void* h_out, int64_t B,
    int64_t T, int64_t DI, int64_t N, int64_t dt_b, int64_t dt_t,
    int64_t x_b, int64_t x_t, int64_t b_b, int64_t b_t, int64_t c_b,
    int64_t c_t, int64_t bf16, void* stream) {
  // four B or C values a load: their rows aligned to four elements
  const int64_t size = bf16 ? 2 : 4;
  const bool wide = aligned(a, 16) && aligned(bm, 4 * size) &&
                    aligned(cm, 4 * size) && b_b % 4 == 0 && b_t % 4 == 0 &&
                    c_b % 4 == 0 && c_t % 4 == 0;
  if (bf16) {
    using In = __nv_bfloat16;
    const MambaScanSourceArgs<In> g{(const In*)dt, (const In*)x,
                                    (const float*)a, (const In*)bm,
                                    (const In*)cm, dt_b, dt_t, x_b, x_t,
                                    b_b, b_t, c_b, c_t};
    return launch_scan<MambaScanSources<In, 1, false>,
                       MambaScanSources<In, 4, true>,
                       MambaScanSources<In, 4, false>>(g, wide, h0, y, h_out,
                                                      B, T, DI, N, stream);
  }
  const MambaScanSourceArgs<float> g{(const float*)dt, (const float*)x,
                                     (const float*)a, (const float*)bm,
                                     (const float*)cm, dt_b, dt_t, x_b, x_t,
                                     b_b, b_t, c_b, c_t};
  return launch_scan<MambaScanSources<float, 1, false>,
                     MambaScanSources<float, 4, true>,
                     MambaScanSources<float, 4, false>>(g, wide, h0, y, h_out,
                                                        B, T, DI, N, stream);
}
