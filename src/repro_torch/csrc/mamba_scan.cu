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
// Two kernels a call, no host sync, no atomics and no allocation (the
// wrapper hands one f32 scratch buffer), so a call can be captured in a
// CUDA graph and two calls give the same bits:
//
// 1. mnf_mamba_scan_bwd: the forward kernel's thread layout (at N = 16 a
//    thread keeps V = 4 state elements of one channel, 4 lanes a channel,
//    64 channels a CTA; any other N a thread an element, a channel's N
//    lanes in one warp).  Nothing of (B, T, DI, N) goes through memory:
//    - forward, the chunk from h0 with the forward's own operations,
//      keeping only the state entering each segment of kBwdSeg (S) steps
//      (a checkpoint) in a (B, ceil(T/S), DI, N) f32 scratch;
//    - backward, segments last to first: the segment's states and decays
//      recomputed from its checkpoint into shared memory (each h_t
//      bitwise the forward's; h_{t-1} is never recovered by inverting the
//      update, da can be near 0), then walked back carrying lambda in
//      registers with no expf.  A thread sums its V terms of d(dt) and du
//      in registers, and a channel's lanes reduce 4 steps at once
//      (reduce_steps: 3 shuffles for 4 steps).  dA's sum over t stays in
//      registers, one partial a batch row.
//    - every segment's inputs (dt, x, gy of the CTA's channels, B, C) are
//      read from device memory by the whole CTA a segment ahead, all loads
//      of a segment in flight at once, into registers, then stored to one
//      of two shared tiles: the walks read shared memory only.  The walk
//      is bound by its instructions and the latency of its steps: with
//      each step's loads from device memory on its chain, the walk took
//      1.5x as long (measured at Hymba-1.5B's training launch).
//    - dB_t and dC_t sum over channels, which this CTA and others own: the
//      warp's channels are summed by shuffles (at V = 4 all 8 products of
//      the warp's 8 channels at once, reduce_steps: 7 shuffles a step),
//      each warp's sums stored in shared memory for the segment, and at
//      the segment's end (one barrier) the warps are summed in order into
//      one partial a CTA column.
// 2. mnf_mamba_scan_bwd_sum: the partials summed in order (dB and dC over
//    the CTA columns, dA over the batch rows).
//
// Each order is fixed and depends only on the shape.  Bound on the H100:
// operations (mamba_scan_fused_bwd_work: 20N + 4 a (b, t, d)), ~0.03 ms at
// Hymba-1.5B's training launch; the kernel walks each state three times
// (forward for the checkpoints, the recompute, the walk back).
// ---------------------------------------------------------------------------

namespace {

// Picked by measurement (tools/torch_mamba_variants.py): S 8 against 4
// and 16, 64 channels a CTA against 16 and 32.  The checkpoints stay in
// device memory: at 64 channels a CTA the rest of its shared memory is
// 86 KB, so within two CTAs an SM its checkpoints would fit beside it
// only up to T 48, and at 16 channels a CTA keeping them in shared memory
// measured no faster.
constexpr int kBwdSeg = 8;            // S: steps a segment
constexpr int kBwdChannels4 = 64;     // channels a CTA at V = 4 (N = 16)
constexpr int kBwdThreads1 = 256;     // threads a CTA at V = 1
constexpr int kBwdMaxSmem = 232448;   // the H100's shared memory a CTA
constexpr int kSumThreads = 256;

// A CTA's shape and shared memory: kernels/mamba_scan/kernel.py bwd_plan
// mirrors it (the launcher sizes the scratch from it).
struct BwdPlan {
  int V, threads, cpc, warps, nseg, ncol;
  size_t smem;   // bytes: the products (S, warps, 2, N), the segment's
                 // states and decays (2, S, threads, V), two input tiles
                 // (S, 3 cpc + 2 N)
};

BwdPlan bwd_plan(int64_t T, int64_t DI, int64_t N) {
  BwdPlan p;
  p.V = N == 16 ? 4 : 1;
  p.threads = p.V == 4 ? kBwdChannels4 * 4 : kBwdThreads1;
  p.cpc = p.threads / (int)(N / p.V);
  p.warps = p.threads / 32;
  p.nseg = (int)((T + kBwdSeg - 1) / kBwdSeg);
  p.ncol = (int)((DI + p.cpc - 1) / p.cpc);
  p.smem = sizeof(float) * (size_t)kBwdSeg *
           (p.warps * 2 * N + 2 * p.cpc * N + 2 * (3 * p.cpc + 2 * N));
  return p;
}

__device__ __forceinline__ float pick4(const float (&v)[4], int q) {
  return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}

template <int V>
__host__ __device__ constexpr int bwd_threads() {
  return V == 4 ? kBwdChannels4 * 4 : kBwdThreads1;
}

template <typename In, int V>
__global__ void __launch_bounds__(bwd_threads<V>()) mnf_mamba_scan_bwd(
    MambaScanSourceArgs<In> g, const float* __restrict__ h0,
    const float* __restrict__ gy, const float* __restrict__ gh,
    float* __restrict__ ck_g, float* __restrict__ g_dt,
    float* __restrict__ g_x, float* __restrict__ g_h0,
    float* __restrict__ part_a, float* __restrict__ part_bc, int64_t T,
    int DI, int N, int cpc) {
  constexpr int S = kBwdSeg;
  constexpr int NT = bwd_threads<V>();
  static_assert(V == 1 || S % 4 == 0, "V = 4 reduces 4 steps at once");
  // a thread's share of a tile: per-channel rows (dt, x, gy: S cpc each,
  // cpc <= NT / 4 at V = 4, <= NT at V = 1) and B, C (S N each, N <= 32)
  constexpr int KCH = V == 4 ? S / 4 : S;
  constexpr int KBC = (S * (V == 4 ? 16 : 32) + NT - 1) / NT;
  extern __shared__ __align__(16) float bwd_smem[];
  if constexpr (V == 4) N = 16, cpc = NT / 4;   // constants at V = 4
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int warps = NT / 32;
  const int lanes = N / V;
  const int ch = tid / lanes, q = tid - ch * lanes;
  const int col0 = blockIdx.x * cpc;
  const int d = col0 + ch;
  const int64_t b = blockIdx.y;
  const bool valid = d < DI;            // a channel's lanes agree
  const int dc = valid ? d : 0;
  const int n0 = q * V;
  const int nseg = (int)((T + S - 1) / S);
  const int lcpc = __ffs(cpc) - 1, ln = __ffs(N) - 1;   // both powers of 2
  const int sc = S * cpc, sn = S * N;   // a tile: dt, x, gy, then B, C
  const int tile = 3 * sc + 2 * sn;
  const int red_row = warps * 2 * N;    // a step's products: (warps, 2, N)
  float* red = bwd_smem;
  // the segment's states h_{t0 + j - 1} at hbs[j * NT * V] and decays
  // da_{t0 + j} at das[j * NT * V]
  float* hbs = red + S * red_row + tid * V;
  float* das = hbs + S * NT * V;
  float* tiles = red + S * red_row + 2 * S * NT * V;
  // the checkpoint of segment k at ck[k * ck_step] (masked threads keep
  // none)
  float* ck = ck_g + ((int64_t)b * nseg * DI + dc) * N + n0;
  const int64_t ck_step = (int64_t)DI * N;
  const int64_t state = ((int64_t)b * DI + dc) * N + n0;
  float a[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = __ldg(g.A + (int64_t)dc * N + n0 + v);

  // a segment's inputs, read from device memory a segment ahead into
  // registers (every load of a tile in flight at once), then stored to
  // one of two shared tiles: the walk reads shared memory only
  float pre_ch[3][KCH], pre_bc[2][KBC];
  auto prefetch = [&](int k) {
    const int64_t t0 = (int64_t)k * S;
#pragma unroll
    for (int i = 0; i < KCH; ++i) {
      const int e = tid + i * NT;
      const int64_t t = t0 + (e >> lcpc);
      const int dd = col0 + (e & (cpc - 1));
      const bool ok = e < sc && t < T && dd < DI;
      pre_ch[0][i] =
          ok ? widen(__ldg(g.dt + b * g.dt_b + t * g.dt_t + dd)) : 0.f;
      pre_ch[1][i] =
          ok ? widen(__ldg(g.x + b * g.x_b + t * g.x_t + dd)) : 0.f;
      pre_ch[2][i] = ok ? __ldg(gy + (b * T + t) * DI + dd) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < KBC; ++i) {
      const int e = tid + i * NT;
      const int64_t t = t0 + (e >> ln);
      const int n = e & (N - 1);
      const bool ok = e < sn && t < T;
      pre_bc[0][i] = ok ? widen(__ldg(g.B + b * g.B_b + t * g.B_t + n)) : 0.f;
      pre_bc[1][i] = ok ? widen(__ldg(g.C + b * g.C_b + t * g.C_t + n)) : 0.f;
    }
  };
  auto commit = [&](float* tl) {
#pragma unroll
    for (int i = 0; i < KCH; ++i) {
      const int e = tid + i * NT;
      if (e < sc) {
        tl[e] = pre_ch[0][i];
        tl[sc + e] = pre_ch[1][i];
        tl[2 * sc + e] = pre_ch[2][i];
      }
    }
#pragma unroll
    for (int i = 0; i < KBC; ++i) {
      const int e = tid + i * NT;
      if (e < sn) {
        tl[3 * sc + e] = pre_bc[0][i];
        tl[3 * sc + sn + e] = pre_bc[1][i];
      }
    }
  };
  // one step of the forward, its own operations: h_t from h_{t-1}
  auto step = [&](const float* tl, int j, float (&h)[V], float (&da)[V]) {
    const float dt = tl[j * cpc + ch];
    const float u = __fmul_rn(dt, tl[sc + j * cpc + ch]);
    float bv[V];
    ldv<V>(tl + 3 * sc + j * N + n0, bv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      da[v] = expf(__fmul_rn(dt, a[v]));
      h[v] = __fadd_rn(__fmul_rn(da[v], h[v]), __fmul_rn(u, bv[v]));
    }
  };

  // 1. the forward walk, keeping the state entering each segment
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    h[v] = (valid && h0 != nullptr) ? h0[state + v] : 0.f;
  int buf = 0;
  prefetch(0);
  for (int k = 0; k < nseg; ++k) {
    if (valid) stv<V>(ck + k * ck_step, h);
    if (k + 1 == nseg) break;           // the last segment's states: in 2.
    float* tl = tiles + buf * tile;
    commit(tl);
    buf ^= 1;
    __syncthreads();
    prefetch(k + 1);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float da[V];
      step(tl, j, h, da);
    }
  }

  // 2. the reverse walk, a segment at a time
  float lam[V], acc_a[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    lam[v] = (valid && gh != nullptr) ? gh[state + v] : 0.f;
    acc_a[v] = 0.f;
  }
  float p1[4], p2[4], dtq[4], xq[4];    // V = 4: 4 steps' sums over n
  for (int k = nseg - 1; k >= 0; --k) {
    const int64_t t0 = (int64_t)k * S;
    const int len = (int)(T - t0 < S ? T - t0 : S);   // the same in a CTA
    float* tl = tiles + buf * tile;
    commit(tl);
    buf ^= 1;
    __syncthreads();                    // the tile in; red free again
    if (k > 0) prefetch(k - 1);
    if (valid) {
      ldv<V>(ck + k * ck_step, h);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j < len) {
        float da[V];
        stv<V>(hbs + j * NT * V, h);
        step(tl, j, h, da);
        stv<V>(das + j * NT * V, da);
      }
    }
    // h = h_{t0 + len - 1}
#pragma unroll
    for (int j = S - 1; j >= 0; --j) {
      float dt = 0.f, xv = 0.f, s1 = 0.f, s2 = 0.f;
      if (j < len) {
        dt = tl[j * cpc + ch];
        xv = tl[sc + j * cpc + ch];
        const float gyv = tl[2 * sc + j * cpc + ch];
        const float u = __fmul_rn(dt, xv);
        float bv[V], cv[V], hp[V];      // hp = h_{t-1}
        ldv<V>(tl + 3 * sc + j * N + n0, bv);
        ldv<V>(tl + 3 * sc + sn + j * N + n0, cv);
        ldv<V>(hbs + j * NT * V, hp);
        float da[V];
        ldv<V>(das + j * NT * V, da);
        float pbc[2 * V];               // lambda u (dB), then gy h (dC)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          pbc[V + v] = valid ? __fmul_rn(gyv, h[v]) : 0.f;
          lam[v] = __fadd_rn(lam[v], __fmul_rn(gyv, cv[v]));
          pbc[v] = valid ? __fmul_rn(lam[v], u) : 0.f;
          const float gs = __fmul_rn(__fmul_rn(lam[v], hp[v]), da[v]);
          acc_a[v] = __fadd_rn(acc_a[v], __fmul_rn(gs, dt));
          const float e1 = __fmul_rn(gs, a[v]);
          const float e2 = __fmul_rn(lam[v], bv[v]);
          s1 = v == 0 ? e1 : __fadd_rn(s1, e1);
          s2 = v == 0 ? e2 : __fadd_rn(s2, e2);
          lam[v] = __fmul_rn(lam[v], da[v]);   // carried to step t - 1
          h[v] = hp[v];
        }
        // the warp's channels summed; a warp's (2, N) sums of step j
        float* row = red + j * red_row + warp * 2 * N;
        if constexpr (V == 4) {
          const int c = lane >> 2;      // the channel in the warp, 0..7
          reduce_steps<8, 4>(pbc, c);
          row[(c >> 2) * N + n0 + (c & 3)] = pbc[0];
        } else {
          for (int m = lanes; m < 32; m <<= 1) {
            pbc[0] = __fadd_rn(pbc[0],
                               __shfl_xor_sync(0xffffffffu, pbc[0], m));
            pbc[1] = __fadd_rn(pbc[1],
                               __shfl_xor_sync(0xffffffffu, pbc[1], m));
          }
          if (lane < lanes) row[q] = pbc[0], row[N + q] = pbc[1];
        }
      }
      // d(dt) and dx: the channel's lanes summed
      if constexpr (V == 4) {
        p1[j & 3] = s1, p2[j & 3] = s2, dtq[j & 3] = dt, xq[j & 3] = xv;
        if ((j & 3) == 0 && j < len) {
          reduce_steps<4>(p1, q);
          reduce_steps<4>(p2, q);
          if (valid && j + q < len) {
            const int64_t o = (b * T + t0 + j + q) * DI + d;
            g_dt[o] = __fadd_rn(p1[0], __fmul_rn(p2[0], pick4(xq, q)));
            g_x[o] = __fmul_rn(p2[0], pick4(dtq, q));
          }
        }
      } else if (j < len) {
        for (int m = lanes >> 1; m > 0; m >>= 1) {
          s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
          s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, m));
        }
        if (valid && q == 0) {
          const int64_t o = (b * T + t0 + j) * DI + d;
          g_dt[o] = __fadd_rn(s1, __fmul_rn(s2, xv));
          g_x[o] = __fmul_rn(s2, dt);
        }
      }
    }
    // the segment's dB, dC of this CTA column: its warps summed in order
    __syncthreads();
    const int64_t btn = (int64_t)gridDim.y * T * N;
    for (int i = tid; i < len * 2 * N; i += NT) {
      const int j = i >> (ln + 1), r = i - j * 2 * N;
      const int kind = r >> ln, n = r - kind * N;
      const float* p = red + j * red_row + r;
      float s = p[0];
#pragma unroll
      for (int w = 1; w < warps; ++w) s = __fadd_rn(s, p[w * 2 * N]);
      part_bc[((int64_t)kind * gridDim.x + blockIdx.x) * btn +
              (b * T + t0 + j) * N + n] = s;
    }
  }
  if (valid) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (g_h0 != nullptr) g_h0[state + v] = lam[v];
      part_a[state + v] = acc_a[v];
    }
  }
}

// g_b / g_c [m] = sum over the ncol CTA columns of part_bc, g_a [m] = sum
// over the B batch rows of part_a, each in order.
__global__ void __launch_bounds__(kSumThreads) mnf_mamba_scan_bwd_sum(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    float* __restrict__ g_b, float* __restrict__ g_c,
    float* __restrict__ g_a, int ncol, int B, int64_t btn, int64_t din) {
  const int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m < 2 * btn) {
    const int kind = m >= btn;
    const int64_t r = m - kind * btn;
    const float* p = part_bc + (int64_t)kind * ncol * btn + r;
    float s = p[0];
    for (int c = 1; c < ncol; ++c) s = __fadd_rn(s, p[c * btn]);
    (kind ? g_c : g_b)[r] = s;
  } else if (m < 2 * btn + din) {
    const int64_t r = m - 2 * btn;
    float s = part_a[r];
    for (int i = 1; i < B; ++i) s = __fadd_rn(s, part_a[i * din + r]);
    g_a[r] = s;
  }
}

template <typename In, int V>
int launch_bwd(const MambaScanSourceArgs<In>& g, const BwdPlan& p,
               const float* h0, const float* gy, const float* gh,
               float* ck, float* g_dt, float* g_x, float* g_h0,
               float* part_a, float* part_bc, int64_t B, int64_t T,
               int64_t DI, int64_t N, cudaStream_t st) {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(mnf_mamba_scan_bwd<In, V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kBwdMaxSmem);
    cudaFuncSetAttribute(mnf_mamba_scan_bwd<In, V>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    set = true;
  }
  mnf_mamba_scan_bwd<In, V>
      <<<dim3((unsigned)p.ncol, (unsigned)B), p.threads, p.smem, st>>>(
          g, h0, gy, gh, ck, g_dt, g_x, g_h0, part_a, part_bc, T, (int)DI,
          (int)N, p.cpc);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_scan_bwd(const MambaScanSourceArgs<In>& g, const float* h0,
                    const float* gy, const float* gh, float* g_dt,
                    float* g_x, float* g_a, float* g_b, float* g_c,
                    float* g_h0, float* scratch, int64_t B, int64_t T,
                    int64_t DI, int64_t N, cudaStream_t st) {
  const BwdPlan p = bwd_plan(T, DI, N);
  if (p.smem > (size_t)kBwdMaxSmem) return (int)cudaErrorInvalidValue;
  const int64_t btn = B * T * N, din = DI * N;
  float* ck = scratch;
  float* part_a = ck + B * p.nseg * din;
  float* part_bc = part_a + B * din;
  const int rc =
      p.V == 4 ? launch_bwd<In, 4>(g, p, h0, gy, gh, ck, g_dt, g_x, g_h0,
                                   part_a, part_bc, B, T, DI, N, st)
               : launch_bwd<In, 1>(g, p, h0, gy, gh, ck, g_dt, g_x, g_h0,
                                   part_a, part_bc, B, T, DI, N, st);
  if (rc) return rc;
  const int64_t total = 2 * btn + din;
  mnf_mamba_scan_bwd_sum<<<(unsigned)((total + kSumThreads - 1) /
                                      kSumThreads),
                           kSumThreads, 0, st>>>(part_bc, part_a, g_b, g_c,
                                                 g_a, p.ncol, (int)B, btn,
                                                 din);
  return (int)cudaGetLastError();
}

}  // namespace

// The gradients of mnf_mamba_scan_fused.  dt, x, bm, cm, a, h0 as there
// (h0 null: zeros); gy (B, T, DI) f32; gh (B, DI, N) f32 or null (zeros);
// N a power of two up to 32.  Writes, all f32: g_dt, g_x (B, T, DI), g_a
// (DI, N), g_b, g_c (B, T, N), g_h0 (B, DI, N; skipped where null).
// scratch (bwd_plan; kernel.py mamba_scan_fused_bwd_scratch): the
// checkpoints (B, ceil(T / S), DI, N), then part_a (B, DI, N), then
// part_bc (2, ncol, B, T, N) floats.
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
    return launch_scan_bwd<In>(g, h0f, gyf, ghf, o_dt, o_x, o_a, o_b,
                               o_c, o_h0, sc, B, T, DI, N, st);
  }
  const MambaScanSourceArgs<float> g{(const float*)dt, (const float*)x,
                                     (const float*)a, (const float*)bm,
                                     (const float*)cm, dt_b, dt_t, x_b, x_t,
                                     b_b, b_t, c_b, c_t};
  return launch_scan_bwd<float>(g, h0f, gyf, ghf, o_dt, o_x, o_a, o_b,
                                o_c, o_h0, sc, B, T, DI, N, st);
}
