// Shared pieces of the MNF event kernels for Hopper (sm_90a).
//
// The order every event kernel keeps: one output element sums its events e
// ascending, then the bk columns of each event tile row j ascending, each
// term an fmaf into one f32 register.  mnf_tile_dot is that inner tile dot
// of the fused strip conv (B3/B6); the event matmul (B2/B5,
// event_matmul.cu) walks the same terms in the same order from a register
// tile.  A row that is all zero in a tile adds fmaf(0, w, acc) == acc
// exactly.  That is what makes strip == per-tap and chained == round-trip
// bitwise on the card.
//
// The tile loader is the one thing the int8 kernels change: MnfF32Tile
// reads f32 values, MnfInt8Tile dequantizes int8 codes at load as
// (q - zp) * scale with explicit round-to-nearest intrinsics, which nvcc
// never contracts.  That is exactly the float quantize.dequantize gives,
// so an int8 kernel is bitwise its f32 twin fed the dequantized tiles.
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

template <typename Tile>
__device__ __forceinline__ float mnf_tile_dot(
    const typename Tile::T* __restrict__ a_row,
    const float* __restrict__ w_col, int64_t ldw, int bk, float acc,
    const Tile& tile) {
  for (int j = 0; j < bk; ++j) {
    acc = fmaf(tile(a_row, j), w_col[(int64_t)j * ldw], acc);
  }
  return acc;
}

// Columns per CTA for a (row group, N tile) CTA with threads over
// (column, row): 128 threads for pixel rows, 256 for 8-row strips.
static inline int mnf_cols_per_cta(int64_t bm) {
  return bm == 1 ? 128 : 32;
}

// Threads of a CTA that loops over channel columns (the pools).
static inline int mnf_col_threads(int64_t cols) {
  int64_t t = (cols + 31) / 32 * 32;
  return (int)(t < 256 ? t : 256);
}
