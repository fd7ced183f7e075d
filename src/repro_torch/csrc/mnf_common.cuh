// Shared pieces of the MNF event kernels for Hopper (sm_90a).
//
// mnf_tile_dot is the one inner tile dot of the event matmul (B2) and the
// fused strip conv (B3): one output element's sum over the bk columns of
// an event tile row, j ascending, fmaf into an f32 register.  Both kernels
// walk their events e ascending and call it per event, so a row that is
// all zero in a tile adds fmaf(0, w, acc) == acc exactly.  That is what
// makes strip == per-tap and chained == round-trip bitwise on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float mnf_tile_dot(const float* __restrict__ a_row,
                                              const float* __restrict__ w_col,
                                              int64_t ldw, int bk, float acc) {
  for (int j = 0; j < bk; ++j) {
    acc = fmaf(a_row[j], w_col[(int64_t)j * ldw], acc);
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
