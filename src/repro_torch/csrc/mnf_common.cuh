// Shared pieces of the MNF event kernels for Hopper (sm_90a).
//
// The order every event kernel keeps: one output element sums its events e
// ascending, then the bk columns of each event tile row j ascending, each
// term an fmaf into one f32 register.  The event matmul (B2/B5,
// event_matmul.cu) and the strip conv (B3/B6, event_conv.cu) both walk
// those terms from a register tile of outputs; the strip conv sums each
// tap into its own register (tap_acc) and adds it to the layer's (acc)
// once the tap is done, as the per-tap path adds tap after tap.  A kernel
// that multiplies a block of rows at once gives a row that lacks the block
// exact zero activations: fmaf(+0, w, acc) == acc for a finite weight (only
// an exact -0 accumulator would turn +0, and +0 == -0), so every output
// still sums exactly its own terms.  That is what makes strip == per-tap
// and chained == round trip bitwise on the card.
//
// The tile loader is the one thing the int8 kernels change: MnfF32Tile
// reads f32 values, MnfInt8Tile dequantizes int8 codes as (q - zp) * scale
// with explicit round-to-nearest intrinsics, which nvcc never contracts.
// That is exactly the float quantize.dequantize gives, so an int8 kernel is
// bitwise its f32 twin fed the dequantized tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct MnfF32Tile {
  using T = float;
  __device__ __forceinline__ MnfF32Tile(const float*, const int32_t*) {}
  __device__ __forceinline__ float operator()(const float* a, int j) const {
    return a[j];
  }
};

// scale and zero_point are 1-element device arrays (the stream's QParams,
// the image of the TPU kernels' scalar prefetch): read once per thread.
struct MnfInt8Tile {
  using T = int8_t;
  float zp, scale;
  __device__ __forceinline__ MnfInt8Tile(const float* s, const int32_t* z)
      : zp((float)*z), scale(*s) {}
  __device__ __forceinline__ float operator()(const int8_t* a, int j) const {
    return __fmul_rn(__fsub_rn((float)a[j], zp), scale);
  }
};

// p -> p / d, a shift when d is a power of two.
struct MnfDiv {
  int d, sh = 0;
  bool pow2;
  __device__ __forceinline__ explicit MnfDiv(int d_)
      : d(d_), pow2((d_ & (d_ - 1)) == 0) {
    while ((1 << sh) < d) ++sh;
  }
  __device__ __forceinline__ int operator()(int p) const {
    return pow2 ? p >> sh : p / d;
  }
};

// One asynchronous copy of BYTES (16, 8 or 4) from device to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// V consecutive floats of device memory, one 16-byte access where V is 4
// (the pools B4, the gated WKV6 step B7).
template <int V>
__device__ __forceinline__ void ldv(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = x[i];
  }
}

// K consecutive floats from shared memory, as wide as K allows.
template <int K>
__device__ __forceinline__ void lds(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x, v[k + 1] = t.y, v[k + 2] = t.z, v[k + 3] = t.w;
    }
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

// The K products v[s] of K steps in each of a group's K lanes (lane q of
// the group: K lanes of a warp STRIDE apart, K a power of two <= 16 / 32
// / STRIDE; the selective scan B10, the WKV6 recurrence B9) reduced over
// the lanes at once: at each level m = K/2, ..., 1 a lane keeps half its
// values and adds the partner lane q ^ m's other half, so lane q ends with
// step q's sum in v[0].  Each step's sum pairs the lanes as the butterfly
// xor m = K/2, ..., 1 does, and an add does not depend on the order of its
// two operands: bitwise that butterfly's, with K - 1 shuffles for K steps.
template <int K, int STRIDE = 1>
__device__ __forceinline__ void reduce_steps(float (&v)[K], int q) {
#pragma unroll
  for (int m = K / 2; m >= 1; m >>= 1) {
    const bool upper = (q & m) != 0;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = upper ? v[i] : v[i + m];
      const float keep = upper ? v[i + m] : v[i];
      v[i] = __fadd_rn(keep,
                       __shfl_xor_sync(0xffffffffu, send, m * STRIDE));
    }
  }
}

// A compile-time flag for a generic lambda's tag argument: whether a walk
// of steps checks each against T (the scans B9, B10).
template <bool B>
struct Checked {
  static constexpr bool value = B;
};
