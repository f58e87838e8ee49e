// The one-warp-per-row kernels of K2 and K3 that the row-tile kernels
// (gather_agg.cu, gns_sample_agg.cu on tile_accum.cuh) replaced, kept
// built for comparison only: chip_smoke.py times them beside the tile
// kernels in the same call (prev_ms), and a card test holds each tile
// kernel bitwise equal to its predecessor.  No path of the port launches
// them.  They go with row_accum.cuh, when K1 moves to the tile layout.
//
// Layout (row_accum.cuh): one warp owns one destination row, 8 rows per
// block; lane l of the warp owns the columns l, l + 32, ... of the row and
// walks the K lanes in order, one load of 4 bytes per column per lane.
// gns_sample_agg_rowwarp draws lane l < K of its row in lane l of the warp
// and passes (row, w) to the whole warp by __shfl_sync.  Both are bitwise
// their plain versions, as the tile kernels are.
#include "kernels.h"
#include "row_accum.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_agg_rowwarp_kernel(const T* __restrict__ feat,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ w,
                          float* __restrict__ out, int64_t B, int K, int D) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (b >= B) return;
  const int lane = threadIdx.x;
  const int32_t* idx_b = idx + b * K;
  const float* w_b = w + b * K;
  for (int d0 = 0; d0 < D; d0 += kPassCols) {
    float acc[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const T* row = feat + static_cast<int64_t>(idx_b[k]) * D;
      accumulate_row(acc, row, w_b[k], d0, lane, D);
    }
    store_row(acc, out + b * D, d0, lane, D);
  }
}

}  // namespace

void launch_gather_agg_rowwarp(const void* feat, int feat_bf16,
                               const int32_t* idx, const float* w,
                               float* out, int64_t B, int K, int D,
                               cudaStream_t stream) {
  if (feat_bf16) {
    gather_agg_rowwarp_kernel<__nv_bfloat16>
        <<<row_grid(B), row_block(), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(feat), idx, w, out, B, K, D);
  } else {
    gather_agg_rowwarp_kernel<float><<<row_grid(B), row_block(), 0, stream>>>(
        static_cast<const float*>(feat), idx, w, out, B, K, D);
  }
}

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mix32(uint32_t key_lo, uint32_t key_hi,
                                          uint32_t row, uint32_t lane) {
  uint32_t h = 0x9E3779B9u;
  h = fmix32(h ^ key_lo);
  h = fmix32(h ^ key_hi);
  h = fmix32(h ^ row);
  return fmix32(h ^ lane);
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gns_sample_agg_rowwarp_kernel(const int32_t* __restrict__ indptr,
                              const int32_t* __restrict__ indices, int64_t cap,
                              const float* __restrict__ deg,
                              const float* __restrict__ hitp,
                              const T* __restrict__ table,
                              const int32_t* __restrict__ dst_rows,
                              const int32_t* __restrict__ fb_rows,
                              const float* __restrict__ fb_w, uint32_t key_lo,
                              uint32_t key_hi, float* __restrict__ out,
                              int32_t* __restrict__ lane_rows,
                              float* __restrict__ lane_w, int64_t B, int K,
                              int D) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (b >= B) return;              // uniform across the warp
  const int lane = threadIdx.x;

  // --- the draw: lane l < K makes lane l's (row, w) in registers --------
  int32_t row = -1;
  float w = 0.0f;
  if (lane < K) {
    const int32_t dst = dst_rows[b];
    if (dst < 0) {                 // uncached: the host's fallback lane
      row = fb_rows[b * K + lane];
      w = fb_w[b * K + lane];
    } else {
      const int32_t start = indptr[dst];
      const int32_t n_c = indptr[dst + 1] - start;
      const bool take_all = n_c <= K;
      int32_t off;
      if (take_all) {
        off = min(lane, max(n_c - 1, 0));
      } else {
        const uint32_t bits = mix32(key_lo, key_hi, static_cast<uint32_t>(b),
                                    static_cast<uint32_t>(lane));
        off = static_cast<int32_t>(bits % static_cast<uint32_t>(n_c));
      }
      int64_t flat = static_cast<int64_t>(start) + off;
      flat = flat < 0 ? 0 : (flat >= cap ? cap - 1 : flat);
      const int32_t drawn = indices[flat];
      if (n_c > 0 && (!take_all || lane < n_c)) {
        const float ncf = fmaxf(static_cast<float>(n_c), 1.0f);
        const float frac = __fdiv_rn(fminf(static_cast<float>(K), ncf), ncf);
        const float coeff =
            fmaxf(__fmul_rn(hitp[max(drawn, 0)], frac), 1e-6f);
        row = drawn;
        w = __fdiv_rn(1.0f, __fmul_rn(coeff, fmaxf(deg[dst], 1.0f)));
      }
    }
    if (lane_rows != nullptr) {
      lane_rows[b * K + lane] = row;
      lane_w[b * K + lane] = w;
    }
    if (row < 0) w = 0.0f;         // dead lane: w = 0 times row 0
  }

  // --- the gather: the whole warp walks the K lanes in ascending order ---
  for (int d0 = 0; d0 < D; d0 += kPassCols) {
    float acc[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int32_t r = __shfl_sync(0xffffffffu, row, k);
      const float wk = __shfl_sync(0xffffffffu, w, k);
      accumulate_row(acc, table + static_cast<int64_t>(max(r, 0)) * D, wk,
                     d0, lane, D);
    }
    store_row(acc, out + b * D, d0, lane, D);
  }
}

}  // namespace

void launch_gns_sample_agg_rowwarp(
    const int32_t* indptr, const int32_t* indices, int64_t cap,
    const float* deg, const float* hitp, const void* table, int table_bf16,
    const int32_t* dst_rows, const int32_t* fb_rows, const float* fb_w,
    uint32_t key_lo, uint32_t key_hi, float* out, int32_t* lane_rows,
    float* lane_w, int64_t B, int K, int D, cudaStream_t stream) {
  if (table_bf16) {
    gns_sample_agg_rowwarp_kernel<__nv_bfloat16>
        <<<row_grid(B), row_block(), 0, stream>>>(
            indptr, indices, cap, deg, hitp,
            static_cast<const __nv_bfloat16*>(table), dst_rows, fb_rows, fb_w,
            key_lo, key_hi, out, lane_rows, lane_w, B, K, D);
  } else {
    gns_sample_agg_rowwarp_kernel<float>
        <<<row_grid(B), row_block(), 0, stream>>>(
        indptr, indices, cap, deg, hitp, static_cast<const float*>(table),
        dst_rows, fb_rows, fb_w, key_lo, key_hi, out, lane_rows, lane_w, B, K,
        D);
  }
}

}  // namespace repro_torch
