// K3: device GNS input layer — draw, importance weight and gather-aggregate
// in one pass.
//
//   per destination row b and lane l < K:
//     cached row (dst_rows[b] >= 0): draw from the generation's CSR over
//       table rows; n_c = its cached-neighbor count.  n_c <= K takes all of
//       them (lanes past n_c are dead), n_c > K draws
//       off = mix32(key_lo, key_hi, b, l) % n_c, with replacement;
//       w = 1 / (max(hitp[row] * (min(K, n_c) / n_c), 1e-6) * max(deg, 1))
//     uncached row (dst_rows[b] < 0): the host's fallback lane
//       (fb_rows[b, l], fb_w[b, l]) as it is
//   out[b, :] = sum_l w_l * table[max(row_l, 0), :]    (l ascending, f32;
//                                                       dead lanes w = 0)
//
// Replaces the TPU kernel repro/sampling/kernels.py::slot_gather_agg_pallas
// and folds in the draw that the reference leaves to XLA (draw_lanes, merged
// with the fallback lanes in gns_sample_agg).  The Pallas kernel reads the
// drawn rows from SMEM through scalar prefetch and runs a (B, D/block, K)
// grid with K innermost.  Here one warp owns a destination row: lanes
// 0..K-1 each make one draw in registers (native uint32 fmix32 chain, the
// same bits as repro_torch/sampling/rng.py), the (row, w) pairs reach the
// whole warp by __shfl_sync, and the warp accumulates the K rows in
// ascending order with row_accum.cuh, as K1 and K2 do.  The drawn lanes
// never touch device memory unless the caller asks for them (lane_rows,
// lane_w), which lets a test hold the draw to its plain version bit for bit.
//
// What bounds it on an H100: HBM bytes, dominated by the output.  At the
// training shape of preset paper_train (B = 176,000, K = 5, D = 100, a
// 305-row f32 table) it writes 70.4 MB of output and reads 7 MB of fallback
// lanes, 0.7 MB of dst_rows and a 122 KB table: about 78 MB, 23 us at
// 3.35 TB/s, against two flops per gathered element and a few integer ops
// per lane.  The design moves only those bytes: the output is written once
// (each warp store covers 32 neighbouring columns of one row), the fallback
// lanes and dst_rows are read once, and the table and the CSR are small
// enough to stay in L2 across the whole launch.  No TMA, no pipelining yet.
//
// Rounding: the weight is computed with __fdiv_rn / __fmul_rn, and the sum
// with __fmul_rn then __fadd_rn (row_accum.cuh), so nvcc contracts nothing
// into an FMA; the result is bitwise the plain version's in
// repro_torch/sampling/kernels.py on any input.  Indices are not checked on
// the device: dst_rows must lie in [-1, table_rows), fb_rows in
// [-1, table_rows).  K <= 32 (the wrapper checks).
#include "kernels.h"
#include "row_accum.cuh"

namespace repro_torch {
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
gns_sample_agg_kernel(const int32_t* __restrict__ indptr,
                      const int32_t* __restrict__ indices, int64_t cap,
                      const float* __restrict__ deg,
                      const float* __restrict__ hitp,
                      const T* __restrict__ table,
                      const int32_t* __restrict__ dst_rows,
                      const int32_t* __restrict__ fb_rows,
                      const float* __restrict__ fb_w, uint32_t key_lo,
                      uint32_t key_hi, float* __restrict__ out,
                      int32_t* __restrict__ lane_rows,
                      float* __restrict__ lane_w, int64_t B, int K, int D) {
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

void launch_gns_sample_agg(const int32_t* indptr, const int32_t* indices,
                           int64_t cap, const float* deg, const float* hitp,
                           const void* table, int table_bf16,
                           const int32_t* dst_rows, const int32_t* fb_rows,
                           const float* fb_w, uint32_t key_lo, uint32_t key_hi,
                           float* out, int32_t* lane_rows, float* lane_w,
                           int64_t B, int K, int D, cudaStream_t stream) {
  if (table_bf16) {
    gns_sample_agg_kernel<__nv_bfloat16>
        <<<row_grid(B), row_block(), 0, stream>>>(
            indptr, indices, cap, deg, hitp,
            static_cast<const __nv_bfloat16*>(table), dst_rows, fb_rows, fb_w,
            key_lo, key_hi, out, lane_rows, lane_w, B, K, D);
  } else {
    gns_sample_agg_kernel<float><<<row_grid(B), row_block(), 0, stream>>>(
        indptr, indices, cap, deg, hitp, static_cast<const float*>(table),
        dst_rows, fb_rows, fb_w, key_lo, key_hi, out, lane_rows, lane_w, B, K,
        D);
  }
}

}  // namespace repro_torch
