// B9 / B9': the WKV6 recurrence (RWKV6 prefill form), by hand for Hopper.
//
// Replaces src/repro/kernels/wkv6/kernel.py wkv6_pallas (body wkv6_kernel)
// and the multi-head pallas_call of src/repro/kernels/wkv6/ops.py wkv6: one
// C entry and one body serve both, row g = (b, h) taking the bonus row
// u[h] (H = 1 for the single-head op).  For each row, head dim D,
// t = 0..T-1:
//
//   o_t = (sum_{d<D} r_t u k_t) v_t + r_t^T S          (bonus + readout)
//   S  <- diag(w_t) S + k_t v_t^T                      (decay + increment)
//
// Inputs as they lie: r, k, v and w are each f32 or bf16 (bf16 -> f32 is
// exact, as the TPU kernel's cast at load), each (B, H, T, D) with a unit
// stride along D and its own strides along b, h and t, so the prefill's
// (B, H, T, D) views of its (B, T, H, D) projections go in without a copy.
// u (H, D) and s0 (B, H, D, D) are f32; o (B, H, T, D) and S f32.
//
// The TPU keeps the (D, D) state in VMEM across a sequential chunk grid
// dimension.  Here a CTA owns a row for the whole sequence, and the
// columns of S are independent: column j evolves from the token's shared
// r, k, w and its own v_j.  A group of kLanes = 8 lanes owns 2 (or 4)
// adjacent columns and splits the rows: lane q holds the row quads p = q
// and q + 8 (rows 4p..4p+3) of its columns in registers, 16 (or 32) state
// elements.  A token costs each lane a 16-byte shared-memory load of r, k
// and w a quad and one of v, the readout fmaf chain over its rows, and the
// update in round-to-nearest intrinsics that nvcc never contracts, so S is
// bitwise the plain version's  w[..., None] * S + k[..., None] * v  (a
// multiply, a multiply and an add).  The readout stays in registers: every
// 8 tokens the group reduces its lanes' partials with 7 shuffles a column
// (reduce_steps), lane q ending with token q's sum, which it stores with
// the bonus as o = fmaf(att, v_j, sum).  No barrier a token.
//
// What bounds the walk is not the f32 pipe alone: every 16-byte load
// takes the SM's shared-memory port for 4 cycles (128 bytes a cycle), so
// a thread's loads an update fall with the columns it holds (3 per 4 rows,
// shared by its columns) while its warps' count falls too.  2 columns a
// thread (256 threads a row) suit a short walk; from kLongT tokens on a
// thread takes 4 (128 threads, half the loads an update).  Measured with
// tools/torch_wkv6_variants.py; the columns a thread do not enter the
// order of any sum.
//
// Staging: tokens come in chunks of kChunk = 32.  Each thread owns the
// same granules (4 elements of one token row) of every input in every
// chunk: it copies them from device memory into a raw stage with
// cp.async (16 bytes for four f32, 8 for four bf16; 4- or 8-byte copies,
// or 2-byte plain ones, where a row or stride is not aligned to that),
// waits for its own copies, widens them to f32 into one of two work
// buffers, sums the bonus of its tokens (a token's granules lie in one
// warp: a multiply chain over its 4 elements, then a butterfly over the
// granules), and issues the next chunk's copies into the stage it just
// read.  So a chunk costs one barrier, and a chunk is in flight while one
// is walked (kDepth = 1).
//
// Orders depend on D alone (granules of 4, lane quads p = q + 8m, 8-token
// readout groups), never on G, T, the grid or a row's type, strides or
// alignment: B9 on a head's rows is bitwise B9''s slice, and two launches
// with S carried equal one.  T needs no padding: the loop ends at T.
//
// Bound on the H100.  RWKV6-7B batch 4 (G = 256 rows of D = 64) at prompt
// 2000 with the prefill's bf16 r, k, v and f32 w: ~463 MB moved (0.138 ms
// at 3.35 TB/s), but 4 f32 instructions a state element and token (the
// readout fmaf, two multiplies, an add) that the bitwise contract keeps
// apart: 8.4 G lane-instructions, 0.25 ms at 33.5 T a second.  At prompt
// 32 ~11.5 MB, 3.4 us.
#include <cuda_bf16.h>

#include "mnf_common.cuh"

namespace {

constexpr int kMaxD = 64;        // widest head: S lives in registers
constexpr int kLanes = 8;        // lanes a column group: they split the rows
// adjacent columns a thread: kColsShort (kMaxD / 2 * kLanes threads a
// row) below kLongT tokens, kColsLong from there on (half the threads,
// each with half the shared-memory loads an update); o and S do not
// depend on it
constexpr int kColsShort = 2;
constexpr int kColsLong = 4;
constexpr int64_t kLongT = 128;
constexpr int kGroup = kLanes;   // tokens whose readouts reduce at once
constexpr int kChunk = 32;       // tokens a stage
constexpr int kDepth = 1;        // chunks in flight while a chunk is walked
constexpr int kMaxUnit = 16;     // widest copy, bytes
constexpr int kMinThreads = 32;  // a CTA is at least a warp
constexpr int kQuads = kMaxD / 4 / kLanes;            // row quads a lane
// split a row's columns over CTAs while the rows leave SMs idle: off, as
// measured (B9's 4 rows took half again as long: each CTA stages the row)
constexpr bool kSplit = false;
constexpr int kInputs = 4;                            // r, k, v, w
constexpr int kMaxSmem = 2 * kInputs * kChunk * kMaxD * 4 + 2 * kChunk * 4 +
                         kDepth * kInputs * kChunk * kMaxD * 4;

struct Input {         // one of r, k, v, w
  const char* p;
  int64_t sb, sh, st;  // strides along b, h, t in bytes
  int size;            // bytes an element: 2 (bf16) or 4 (f32)
  int unit;            // bytes a copy: 16, 8, 4 or 2
  int per;             // elements a copy (unit / size; divides D)
  int off;             // bytes from a raw stage's start
};

struct Wkv6Args {
  Input in[kInputs];
  const float* u;      // (H, D)
  const float* s0;     // (G, D, D) or null (zeros)
  float* o;            // (G, T, D)
  float* s_out;        // (G, D, D)
  int64_t T;
  int D, H;
  int Dp;              // D rounded up to whole granules
  int gpt;             // granules a token row (Dp / 4)
  int P2;              // lanes a token row takes in staging: gpt, a power of 2
  int groups;          // column groups a CTA
  int stage;           // bytes a raw stage
};

// One copy of UNIT bytes; 2-byte copies are plain (cp.async takes 4, 8, 16).
__device__ __forceinline__ void copy_unit(char* dst, const char* src,
                                          int unit) {
  switch (unit) {
    case 16: cp_async<16>(dst, src); break;
    case 8: cp_async<8>(dst, src); break;
    case 4: cp_async<4>(dst, src); break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
  }
}

// The four elements d0..d0+3 of a row: one copy where the row allows a
// whole granule (16 bytes of f32, 8 of bf16), else in.per elements a copy
// and zeros for those at or past D.
__device__ __forceinline__ void copy_granule(char* dst, const char* src,
                                             int d0, int D, const Input& in) {
  if (in.per == 4) {
    if (in.size == 4)
      cp_async<16>(dst, src);
    else
      cp_async<8>(dst, src);
    return;
  }
  for (int e = 0; e < 4; e += in.per) {
    char* s = dst + e * in.size;
    if (d0 + e < D) {
      copy_unit(s, src + e * in.size, in.unit);
    } else {
      for (int z = 0; z < in.unit; z += 2)
        *reinterpret_cast<uint16_t*>(s + z) = 0;
    }
  }
}

// A granule of a raw stage widened to f32.
__device__ __forceinline__ float4 widen(const char* p, int size) {
  if (size == 4) return *reinterpret_cast<const float4*>(p);
  const uint2 b = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(b.x << 16),
                     __uint_as_float(b.x & 0xffff0000u),
                     __uint_as_float(b.y << 16),
                     __uint_as_float(b.y & 0xffff0000u));
}

// sum_e r_e u_e k_e over a granule, in order e = 0..3
__device__ __forceinline__ float bonus4(float4 r, const float (&u)[4],
                                        float4 k) {
  float a = __fmul_rn(__fmul_rn(r.x, u[0]), k.x);
  a = fmaf(__fmul_rn(r.y, u[1]), k.y, a);
  a = fmaf(__fmul_rn(r.z, u[2]), k.z, a);
  return fmaf(__fmul_rn(r.w, u[3]), k.w, a);
}

}  // namespace

// FULL: every lane's kQuads quads lie inside Dp (D in 61..64).
template <bool FULL, int COLS>
__global__ void __launch_bounds__(kMaxD / COLS * kLanes, 2)
    mnf_wkv6_kernel(const __grid_constant__ Wkv6Args a) {
  extern __shared__ float4 smem4[];
  float* work = reinterpret_cast<float*>(smem4);     // (2, 4, kChunk, Dp)
  float* att = work + 2 * kInputs * kChunk * a.Dp;   // (2, kChunk)
  char* raw = reinterpret_cast<char*>(att + 2 * kChunk);  // kDepth stages
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t g = blockIdx.x;
  const int64_t b = g / a.H;
  const int h = (int)(g - b * a.H);
  const int D = a.D, Dp = a.Dp;
  const int64_t T = a.T;
  const int64_t nchunks = (T + kChunk - 1) / kChunk;

  // the granules this thread stages: x of tokens tfirst, tfirst + tstep, ..
  const int x = tid % a.P2, tfirst = tid / a.P2, tstep = nt / a.P2;
  const char* src[kInputs];             // granule x of the row's token 0
#pragma unroll
  for (int i = 0; i < kInputs; ++i)
    src[i] = a.in[i].p + b * a.in[i].sb + h * a.in[i].sh +
             4 * x * a.in[i].size;
  float u4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    u4[e] = 4 * x + e < D ? a.u[(int64_t)h * D + 4 * x + e] : 0.f;

  auto issue = [&](int64_t c, int slot) {   // chunk c into a raw stage
    char* stage = raw + slot * a.stage;
    if (c < nchunks && x < a.gpt) {
      for (int t = tfirst; t < kChunk; t += tstep) {
        const int64_t tok = c * kChunk + t;
        if (tok >= T) break;
#pragma unroll
        for (int i = 0; i < kInputs; ++i) {
          const Input& in = a.in[i];
          copy_granule(stage + in.off + (t * Dp + 4 * x) * in.size,
                       src[i] + tok * in.st, 4 * x, D, in);
        }
      }
    }
    cp_async_commit();
  };

  // chunk c, landed in a raw stage, widened into work buffer buf, and its
  // tokens' bonus att = sum_d r u k (a warp's trip count is uniform)
  auto land = [&](int64_t c, int slot, int buf) {
    const char* stage = raw + slot * a.stage;
    float* wb = work + buf * kInputs * kChunk * Dp;
    for (int t = tfirst; t < kChunk; t += tstep) {
      float bonus = 0.f;
      if (x < a.gpt && c * kChunk + t < T) {
        float4 f[kInputs];
#pragma unroll
        for (int i = 0; i < kInputs; ++i) {
          f[i] = widen(stage + a.in[i].off + (t * Dp + 4 * x) * a.in[i].size,
                       a.in[i].size);
          *reinterpret_cast<float4*>(wb + (i * kChunk + t) * Dp + 4 * x) =
              f[i];
        }
        bonus = bonus4(f[0], u4, f[1]);
      }
      for (int m = a.P2 / 2; m >= 1; m >>= 1)
        bonus = __fadd_rn(bonus, __shfl_xor_sync(0xffffffffu, bonus, m));
      if (x == 0) att[buf * kChunk + t] = bonus;
    }
  };

  // the column group's lane q and its COLS columns j0, j0 + 1, ...
  const int q = tid % kLanes;
  const int j0 = (blockIdx.y * a.groups + tid / kLanes) * COLS;
  const bool valid = j0 < D;
  const int jj = valid ? j0 : 0;
  const int64_t srow = g * D * D;
  float s[kQuads][4][COLS];
#pragma unroll
  for (int m = 0; m < kQuads; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int i = 4 * (q + kLanes * m) + e;
        s[m][e][cc] = valid && a.s0 != nullptr && i < D && j0 + cc < D
                          ? a.s0[srow + (int64_t)i * D + j0 + cc]
                          : 0.f;
      }

  // walk chunk c from work buffer buf; CHECK: the chunk ends before kChunk
  auto walk = [&](int64_t c, int buf, auto check) {
    constexpr bool CHECK = decltype(check)::value;
    const int tc = CHECK ? (int)(T - c * kChunk) : kChunk;
    const float* wr = work + buf * kInputs * kChunk * Dp;
    const float* wk = wr + kChunk * Dp;
    const float* wv = wk + kChunk * Dp;
    const float* ww = wv + kChunk * Dp;
    const float* at = att + buf * kChunk;
    float* obase = a.o + (g * T + c * kChunk) * D + j0;
    for (int t0 = 0; t0 < tc; t0 += kGroup) {
      float pv[COLS][kGroup];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        const int tt = t0 + n;
        float p[COLS];
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) p[cc] = 0.f;
        if (!CHECK || tt < tc) {
          float vj[COLS];
          lds<COLS>(wv + tt * Dp + jj, vj);
#pragma unroll
          for (int m = 0; m < kQuads; ++m) {
            const int pq = q + kLanes * m;
            if (FULL || pq < a.gpt) {
              float r4[4], k4[4], w4[4];
              lds<4>(wr + tt * Dp + 4 * pq, r4);
              lds<4>(wk + tt * Dp + 4 * pq, k4);
              lds<4>(ww + tt * Dp + 4 * pq, w4);
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int cc = 0; cc < COLS; ++cc) {
                  float& se = s[m][e][cc];
                  p[cc] = fmaf(r4[e], se, p[cc]);
                  se = __fadd_rn(__fmul_rn(w4[e], se),
                                 __fmul_rn(k4[e], vj[cc]));
                }
            }
          }
        }
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) pv[cc][n] = p[cc];
      }
      // lane q ends with token q % kGroup's readout: a butterfly over the
      // lane bits at or above kGroup, then reduce_steps over the rest
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
#pragma unroll
        for (int m = kLanes / 2; m >= kGroup; m >>= 1)
#pragma unroll
          for (int n = 0; n < kGroup; ++n)
            pv[cc][n] = __fadd_rn(pv[cc][n],
                                  __shfl_xor_sync(0xffffffffu, pv[cc][n], m));
        reduce_steps<kGroup>(pv[cc], q % kGroup);
      }
      const int tt = t0 + q;                 // lane q's token
      if (q < kGroup && valid && (!CHECK || tt < tc)) {
        float vq[COLS], out[COLS];
        lds<COLS>(wv + tt * Dp + jj, vq);
        const float bonus = at[tt];
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc)
          out[cc] = fmaf(bonus, vq[cc], pv[cc][0]);
        float* orow = obase + tt * D;
        if (COLS == 2 && j0 + 2 <= D && D % 2 == 0) {
          *reinterpret_cast<float2*>(orow) = make_float2(out[0], out[1]);
        } else if (j0 + COLS <= D && D % COLS == 0) {
          stv<COLS>(orow, out);
        } else {
#pragma unroll
          for (int cc = 0; cc < COLS; ++cc)
            if (j0 + cc < D) orow[cc] = out[cc];
        }
      }
    }
  };

#pragma unroll
  for (int sl = 0; sl < kDepth; ++sl) issue(sl, sl);
  cp_async_wait<kDepth - 1>();
  land(0, 0, 0);
  issue(kDepth, 0);
  __syncthreads();
  for (int64_t c = 0; c < nchunks; ++c) {
    const int buf = (int)(c & 1);
    if ((c + 1) * kChunk <= T)
      walk(c, buf, Checked<false>{});
    else
      walk(c, buf, Checked<true>{});
    if (c + 1 < nchunks) {
      const int slot = (int)((c + 1) % kDepth);
      cp_async_wait<kDepth - 1>();           // this thread's chunk c + 1
      land(c + 1, slot, buf ^ 1);
      issue(c + 1 + kDepth, slot);           // into the stage just landed
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < kQuads; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int cc = 0; cc < COLS; ++cc) {
        const int i = 4 * (q + kLanes * m) + e;
        if (valid && i < D && j0 + cc < D)
          a.s_out[srow + (int64_t)i * D + j0 + cc] = s[m][e][cc];
      }
}

namespace {

// The widest copy (bytes) that every row of an input allows: a whole
// number of elements that divides D, with the base and the strides
// aligned to it.
int unit_bytes(const void* p, int64_t sb, int64_t sh, int64_t st, int64_t D,
               int size) {
  for (int per = 4; per > 1; per /= 2) {
    const int bytes = per * size;
    if (bytes <= kMaxUnit && D % per == 0 && (uintptr_t)p % bytes == 0 &&
        sb % per == 0 && sh % per == 0 && st % per == 0)
      return bytes;
  }
  return size;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <bool FULL, int COLS>
int launch(Wkv6Args& a, int64_t G, size_t smem, cudaStream_t st) {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(mnf_wkv6_kernel<FULL, COLS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    cudaFuncSetAttribute(mnf_wkv6_kernel<FULL, COLS>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    set = true;
  }
  // column groups a CTA: the row's, as a power of two (with kSplit,
  // halved while the grid holds fewer CTAs than the card has SMs)
  const int64_t row_groups = (a.D + COLS - 1) / COLS;
  int groups = kMaxD / COLS;
  while (groups / 2 >= row_groups && groups * kLanes / 2 >= kMinThreads)
    groups /= 2;
  while (kSplit && groups * kLanes / 2 >= kMinThreads &&
         G * ((row_groups + groups - 1) / groups) < sm_count())
    groups /= 2;
  a.groups = groups;
  const unsigned nblk = (unsigned)((row_groups + groups - 1) / groups);
  mnf_wkv6_kernel<FULL, COLS><<<dim3((unsigned)G, nblk), groups * kLanes,
                                smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, H, T, D), each f32 (its bit of bf16 clear) or bf16 (bit
// set: r 1, k 2, v 4, w 8), unit stride along D and strides (b, h, t) in
// elements; u (H, D) f32; s0 (B, H, D, D) f32 or null (zeros) -> o (B, H,
// T, D), s_out (B, H, D, D) f32, both contiguous.  D <= 64.
extern "C" int mnf_wkv6(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* o, void* s_out, int64_t B, int64_t H,
                        int64_t T, int64_t D, int64_t r_b, int64_t r_h,
                        int64_t r_t, int64_t k_b, int64_t k_h, int64_t k_t,
                        int64_t v_b, int64_t v_h, int64_t v_t, int64_t w_b,
                        int64_t w_h, int64_t w_t, int64_t bf16,
                        void* stream) {
  Wkv6Args a{};
  const void* ptrs[kInputs] = {r, k, v, w};
  const int64_t strides[kInputs][3] = {
      {r_b, r_h, r_t}, {k_b, k_h, k_t}, {v_b, v_h, v_t}, {w_b, w_h, w_t}};
  a.D = (int)D;
  a.H = (int)H;
  a.T = T;
  a.Dp = (int)((D + 3) / 4 * 4);
  a.gpt = a.Dp / 4;
  a.P2 = 1;
  while (a.P2 < a.gpt) a.P2 *= 2;
  int off = 0;
  for (int i = 0; i < kInputs; ++i) {
    Input& in = a.in[i];
    in.p = (const char*)ptrs[i];
    in.size = (bf16 >> i) & 1 ? 2 : 4;
    in.unit = unit_bytes(in.p, strides[i][0], strides[i][1], strides[i][2],
                         D, in.size);
    in.per = in.unit / in.size;
    in.sb = strides[i][0] * in.size;
    in.sh = strides[i][1] * in.size;
    in.st = strides[i][2] * in.size;
    in.off = off;
    off += kChunk * a.Dp * in.size;
  }
  a.stage = off;
  a.u = (const float*)u;
  a.s0 = (const float*)s0;
  a.o = (float*)o;
  a.s_out = (float*)s_out;
  const int64_t G = B * H;
  const size_t smem = (size_t)2 * kInputs * kChunk * a.Dp * 4 +
                      2 * kChunk * 4 + (size_t)kDepth * a.stage;
  cudaStream_t st = (cudaStream_t)stream;
  const bool full = a.gpt == kQuads * kLanes;
  if (T >= kLongT)
    return full ? launch<true, kColsLong>(a, G, smem, st)
                : launch<false, kColsLong>(a, G, smem, st);
  return full ? launch<true, kColsShort>(a, G, smem, st)
              : launch<false, kColsShort>(a, G, smem, st);
}
