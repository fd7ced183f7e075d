// B10: the selective scan of the Mamba prefill, by hand for Hopper.
//
// Replaces src/repro/kernels/mamba_scan/kernel.py mamba_scan_pallas (body
// mamba_scan_kernel) with its padding wrapper mamba_scan/ops.py mamba_scan.
// For each batch row b and channel d:
//
//   h_t = da_t h_{t-1} + dbx_t          (h: (DI, N); h_{-1} = h0, or 0)
//   y_t = sum_{n<N} h_t[:, n] c_t[n]
//
// Two entries share one walk (a third, the fused entry's backward
// mnf_mamba_scan_fused_bwd, closes the file).  mnf_mamba_scan takes the streams da and
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

// ---------------------------------------------------------------------------
// The backward of the fused entry: mnf_mamba_scan_fused_bwd.
//
// Replaces no TPU kernel: the JAX package trains Hymba by differentiating
// XLA's associative scan (src/repro/models/ssm.py mamba_apply) and has no
// backward kernel.  The port's forward is this file's kernel, so its
// gradient is a kernel too.  With lambda_t the loss's gradient in h_t
// (kernels/mamba_scan/ref.py mamba_scan_fused_bwd_ref, the specification):
//
//   lambda_{T-1} = gh + gy_{T-1} c_{T-1},
//   lambda_t = gy_t c_t + da_{t+1} lambda_{t+1},
//   d(dbx_t) = lambda_t,  d(da_t) = lambda_t h_{t-1},  dh0 = da_0 lambda_0;
//   through da = exp(s), s = dt A:  ds = d(da) da,  d(dt) += sum_n ds A,
//                                   dA += sum_{b,t} ds dt;
//   through dbx = u B, u = dt x:    du = sum_n lambda B,  d(dt) += du x,
//                                   dx = du dt,  dB += sum_d lambda u;
//   through y_t = sum_n h_t c_t:    dC_t = sum_d gy_t h_t.
//
// Three kernels a launch, no host sync and no allocation (the wrapper hands
// one f32 scratch buffer), so the launch can be captured in a CUDA graph:
//
// 1. mnf_mamba_scan_bwd_walk: a thread a state element (b, d, n), a
//    channel's N lanes side by side in one warp (N a power of two up to
//    32).  It walks the chunk forward from h0 with the forward kernel's own
//    operations (each h_t bitwise the forward's) and keeps every h_t in the
//    scratch ((B, T, DI, N) f32): h_{t-1} is read back, never recomputed by
//    inverting h_t = da h + dbx, since da can be near 0.  Then it walks
//    t = T-1 .. 0 carrying lambda, stores each lambda_t in the scratch, and
//    sums its per-element terms over the channel's lanes with xor shuffles
//    (fixed order) into d(dt) and dx, which need no other thread; dh0 is
//    per element; dA's sum over t stays in a register, one partial a batch
//    row.
// 2. mnf_mamba_scan_bwd_bc: dB and dC are sums over DI channels, which
//    other CTAs own.  Per-slice partials instead of atomicAdd, so that two
//    launches give the same bits: a thread a (b, t, n) and slice of DI
//    (kSlices slices) sums its channels in order from the stored h_t and
//    lambda_t.
// 3. mnf_sum_rows: the partials summed in order (dB and dC over the
//    slices, dA over the batch rows).
//
// A simple kernel, right first: the walk's state traffic is 2 x (B, T,
// DI, N) f32 written and read back through the scratch, far above the
// bytes the function needs (its inputs and gradients, which are N times
// narrower), and its step is bound by latency (expf, shuffles).
// ---------------------------------------------------------------------------

namespace {

constexpr int kBwdThreads = 256;  // threads a CTA of the walk and the sums
constexpr int kSlices = 16;       // DI slices of the dB / dC partials

template <typename In>
__global__ void __launch_bounds__(kBwdThreads) mnf_mamba_scan_bwd_walk(
    MambaScanSourceArgs<In> g, const float* __restrict__ h0,
    const float* __restrict__ gy, const float* __restrict__ gh,
    float* __restrict__ hs, float* __restrict__ lam_s,
    float* __restrict__ g_dt, float* __restrict__ g_x,
    float* __restrict__ g_h0, float* __restrict__ g_a_part, int64_t T,
    int DI, int N, int cpc) {
  const int tid = threadIdx.x;
  const int ch = tid / N, n = tid - ch * N;
  const int d = blockIdx.x * cpc + ch;
  const int64_t b = blockIdx.y;
  const bool valid = d < DI;           // a channel's lanes agree
  const int dc = valid ? d : 0;        // masked channels read channel 0
  const float a = g.A[(int64_t)dc * N + n];
  const In* pdt = g.dt + b * g.dt_b + dc;
  const In* px = g.x + b * g.x_b + dc;
  const In* pb = g.B + b * g.B_b + n;
  const In* pc = g.C + b * g.C_b + n;
  const int64_t step = (int64_t)DI * N;
  const int64_t elem = (b * T * DI + dc) * N + n;  // (b, 0, d, n)
  const int64_t state = (b * DI + dc) * N + n;     // (b, d, n)

  // the forward walk, each h_t kept
  float h = (valid && h0 != nullptr) ? h0[state] : 0.f;
  const float h_init = h;
  for (int64_t t = 0; t < T; ++t) {
    const float dt = widen(pdt[t * g.dt_t]);
    const float da = expf(__fmul_rn(dt, a));
    const float dbx = __fmul_rn(__fmul_rn(dt, widen(px[t * g.x_t])),
                                widen(pb[t * g.B_t]));
    h = __fadd_rn(__fmul_rn(da, h), dbx);
    if (valid) hs[elem + t * step] = h;
  }

  // the reverse walk
  float lam = (valid && gh != nullptr) ? gh[state] : 0.f;
  float acc_a = 0.f;
  for (int64_t t = T - 1; t >= 0; --t) {
    const float dt = widen(pdt[t * g.dt_t]);
    const float xv = widen(px[t * g.x_t]);
    const float bv = widen(pb[t * g.B_t]);
    const float cv = widen(pc[t * g.C_t]);
    const float gyv = valid ? gy[(b * T + t) * DI + d] : 0.f;
    const float h_prev =
        t == 0 ? h_init : (valid ? hs[elem + (t - 1) * step] : 0.f);
    const float da = expf(__fmul_rn(dt, a));
    lam = __fadd_rn(lam, __fmul_rn(gyv, cv));          // lambda_t
    if (valid) lam_s[elem + t * step] = lam;
    const float gs = __fmul_rn(__fmul_rn(lam, h_prev), da);
    acc_a = __fadd_rn(acc_a, __fmul_rn(gs, dt));
    float s1 = __fmul_rn(gs, a);     // d(dt) through da
    float s2 = __fmul_rn(lam, bv);   // du through dbx
    for (int m = N >> 1; m > 0; m >>= 1) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
      s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, m));
    }
    if (valid && n == 0) {
      const int64_t o = (b * T + t) * DI + d;
      g_dt[o] = __fadd_rn(s1, __fmul_rn(s2, xv));
      g_x[o] = __fmul_rn(s2, dt);
    }
    lam = __fmul_rn(lam, da);         // carried to step t - 1
  }
  if (valid) {
    if (g_h0 != nullptr) g_h0[state] = lam;
    g_a_part[state] = acc_a;
  }
}

// part_b / part_c (kSlices, B, T, N): slice s of DI summed in order.
template <typename In>
__global__ void __launch_bounds__(kBwdThreads) mnf_mamba_scan_bwd_bc(
    MambaScanSourceArgs<In> g, const float* __restrict__ gy,
    const float* __restrict__ hs, const float* __restrict__ lam_s,
    float* __restrict__ part_b, float* __restrict__ part_c, int64_t B,
    int64_t T, int DI, int N, int per) {
  const int64_t total = B * T * N;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int s = blockIdx.y;
  const int n = (int)(i % N);
  const int64_t bt = i / N;
  const int64_t t = bt % T, b = bt / T;
  const In* pdt = g.dt + b * g.dt_b + t * g.dt_t;
  const In* px = g.x + b * g.x_b + t * g.x_t;
  const float* pgy = gy + bt * DI;
  const float* ph = hs + bt * DI * N + n;
  const float* pl = lam_s + bt * DI * N + n;
  const int d0 = s * per;
  const int d1 = d0 + per < DI ? d0 + per : DI;
  float sb = 0.f, sc = 0.f;
  for (int d = d0; d < d1; ++d) {
    const float u = __fmul_rn(widen(pdt[d]), widen(px[d]));
    sb = __fadd_rn(sb, __fmul_rn(u, pl[(int64_t)d * N]));
    sc = __fadd_rn(sc, __fmul_rn(pgy[d], ph[(int64_t)d * N]));
  }
  part_b[s * total + i] = sb;
  part_c[s * total + i] = sc;
}

// out[m] = sum over r < R of part[r M + m], in order.
__global__ void __launch_bounds__(kBwdThreads) mnf_sum_rows(
    const float* __restrict__ part, float* __restrict__ out, int R,
    int64_t M) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s = __fadd_rn(s, part[r * M + m]);
  out[m] = s;
}

unsigned blocks(int64_t n) {
  return (unsigned)((n + kBwdThreads - 1) / kBwdThreads);
}

template <typename In>
int launch_scan_bwd(const MambaScanSourceArgs<In>& g, const float* h0,
                    const float* gy, const float* gh, float* g_dt,
                    float* g_x, float* g_a, float* g_b, float* g_c,
                    float* g_h0, float* scratch, int64_t B, int64_t T,
                    int64_t DI, int64_t N, cudaStream_t st) {
  const int64_t elems = B * T * DI * N, btn = B * T * N;
  float* hs = scratch;
  float* lam = hs + elems;
  float* part_a = lam + elems;
  float* part_b = part_a + B * DI * N;
  float* part_c = part_b + kSlices * btn;
  const int cpc = kBwdThreads / (int)N;
  const dim3 grid((unsigned)((DI + cpc - 1) / cpc), (unsigned)B);
  mnf_mamba_scan_bwd_walk<In><<<grid, kBwdThreads, 0, st>>>(
      g, h0, gy, gh, hs, lam, g_dt, g_x, g_h0, part_a, T, (int)DI, (int)N,
      cpc);
  const int per = (int)((DI + kSlices - 1) / kSlices);
  mnf_mamba_scan_bwd_bc<In><<<dim3(blocks(btn), kSlices), kBwdThreads, 0,
                              st>>>(g, gy, hs, lam, part_b, part_c, B, T,
                                    (int)DI, (int)N, per);
  mnf_sum_rows<<<blocks(btn), kBwdThreads, 0, st>>>(part_b, g_b, kSlices,
                                                    btn);
  mnf_sum_rows<<<blocks(btn), kBwdThreads, 0, st>>>(part_c, g_c, kSlices,
                                                    btn);
  mnf_sum_rows<<<blocks(DI * N), kBwdThreads, 0, st>>>(part_a, g_a, (int)B,
                                                       DI * N);
  return (int)cudaGetLastError();
}

}  // namespace

// The gradients of mnf_mamba_scan_fused.  dt, x, bm, cm, a, h0 as there
// (h0 null: zeros); gy (B, T, DI) f32; gh (B, DI, N) f32 or null (zeros);
// N a power of two up to 32.  Writes, all f32: g_dt, g_x (B, T, DI), g_a
// (DI, N), g_b, g_c (B, T, N), g_h0 (B, DI, N; skipped where null).
// scratch: 2 B T DI N + B DI N + 2 kSlices B T N floats.
extern "C" int mnf_mamba_scan_fused_bwd(
    const void* dt, const void* x, const void* a, const void* bm,
    const void* cm, const void* h0, const void* gy, const void* gh,
    void* g_dt, void* g_x, void* g_a, void* g_b, void* g_c, void* g_h0,
    void* scratch, int64_t B, int64_t T, int64_t DI, int64_t N,
    int64_t dt_b, int64_t dt_t, int64_t x_b, int64_t x_t, int64_t b_b,
    int64_t b_t, int64_t c_b, int64_t c_t, int64_t bf16, void* stream) {
  if (N < 1 || N > 32 || (N & (N - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *h0f = (const float*)h0, *gyf = (const float*)gy,
              *ghf = (const float*)gh;
  float *o_dt = (float*)g_dt, *o_x = (float*)g_x, *o_a = (float*)g_a,
        *o_b = (float*)g_b, *o_c = (float*)g_c, *o_h0 = (float*)g_h0,
        *sc = (float*)scratch;
  if (bf16) {
    using In = __nv_bfloat16;
    const MambaScanSourceArgs<In> g{(const In*)dt, (const In*)x,
                                    (const float*)a, (const In*)bm,
                                    (const In*)cm, dt_b, dt_t, x_b, x_t,
                                    b_b, b_t, c_b, c_t};
    return launch_scan_bwd<In>(g, h0f, gyf, ghf, o_dt, o_x, o_a, o_b, o_c,
                               o_h0, sc, B, T, DI, N, st);
  }
  const MambaScanSourceArgs<float> g{(const float*)dt, (const float*)x,
                                     (const float*)a, (const float*)bm,
                                     (const float*)cm, dt_b, dt_t, x_b, x_t,
                                     b_b, b_t, c_b, c_t};
  return launch_scan_bwd<float>(g, h0f, gyf, ghf, o_dt, o_x, o_a, o_b, o_c,
                                o_h0, sc, B, T, DI, N, st);
}
