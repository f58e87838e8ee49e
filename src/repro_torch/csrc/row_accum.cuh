// Shared pieces of the one-warp-per-row gather-aggregate kernels: K1
// (cache_lookup.cu) and the predecessors of K2 and K3 (rowwarp.cu).
//
// Layout: one warp owns one destination row b; the block holds
// kRowsPerBlock such warps.  Lane l of the warp owns the columns
// d = d0 + j * 32 + l (j < kColsPerLane) of each pass over D, so each load
// instruction of the warp reads 32 neighbouring elements of one row.
// A pass covers 32 * kColsPerLane = 256 columns; wider rows take more
// passes, and every column index is tested against D, so a D that is not a
// multiple of 32 (100, 48, ...) reads nothing past the end of a row.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;   // warps (destination rows) per block
constexpr int kColsPerLane = 8;    // columns a lane accumulates per pass
constexpr int kPassCols = kWarp * kColsPerLane;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[j] += wk * row[d0 + j * 32 + lane] for every column below D.
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn:
// no fmaf, and nvcc may not contract them), which is exactly what the plain
// PyTorch version's `out + w * rows` does, so kernel and plain version agree
// bit for bit on any float32 input, not only on integer-valued ones.
template <typename T>
__device__ __forceinline__ void accumulate_row(float (&acc)[kColsPerLane],
                                               const T* __restrict__ row,
                                               float wk, int d0, int lane,
                                               int D) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int d = d0 + j * kWarp + lane;
    if (d < D) acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, to_f32(row[d])));
  }
}

__device__ __forceinline__ void store_row(const float (&acc)[kColsPerLane],
                                          float* __restrict__ out_row, int d0,
                                          int lane, int D) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int d = d0 + j * kWarp + lane;
    if (d < D) out_row[d] = acc[j];
  }
}

inline dim3 row_grid(int64_t B) {
  return dim3(static_cast<unsigned>((B + kRowsPerBlock - 1) / kRowsPerBlock));
}

inline dim3 row_block() { return dim3(kWarp, kRowsPerBlock); }

}  // namespace repro_torch
