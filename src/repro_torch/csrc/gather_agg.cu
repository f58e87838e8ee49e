// K2: weighted gather-aggregate for GraphSAGE layers 1..L-1.
//
//   out[b, :] = sum_k w[b, k] * feat[idx[b, k], :]      (k ascending, f32)
//
// Replaces the TPU kernel repro/kernels/gather_agg.py::gather_agg_pallas.
// That kernel runs a (B, D/block_d, K) grid with K innermost, so one output
// tile stays in VMEM while the K rows stream in.  Here one warp owns a
// destination row and loops over k itself (the sequential K axis becomes a
// loop inside the warp); the sum lives in registers, and each output element
// is written once.
//
// What bounds it on an H100: HBM bytes.  Per call it reads the rows its
// lanes name (B*K*D*elt bytes, or each distinct row once when repeats hit
// in L2), idx and w (B*K*8) and writes the output (B*D*4), against two
// flops per gathered element, far below the card's flop-per-byte balance.
// The design spends nothing but loads on the rows: each warp load
// instruction reads 32 neighbouring elements of one row (one 128-byte line
// in f32), each lane keeps 8 independent loads in flight per k, and nothing
// is staged through shared memory.  Rows that repeat across
// destinations are left to L2.  No wgmma, TMA or pipelining yet.
//
// Every lane is accumulated, including lanes with w == 0 (padding), in
// ascending k, product and sum rounded separately (see row_accum.cuh): the
// result is bitwise the plain version's in repro_torch/kernels/gather_agg.py.
// Indices must lie in [0, N); they are not checked on the device.
#include "kernels.h"
#include "row_accum.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_agg_kernel(const T* __restrict__ feat, const int32_t* __restrict__ idx,
                  const float* __restrict__ w, float* __restrict__ out,
                  int64_t B, int K, int D) {
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

void launch_gather_agg(const void* feat, int feat_bf16, const int32_t* idx,
                       const float* w, float* out, int64_t B, int K, int D,
                       cudaStream_t stream) {
  if (feat_bf16) {
    gather_agg_kernel<__nv_bfloat16><<<row_grid(B), row_block(), 0, stream>>>(
        static_cast<const __nv_bfloat16*>(feat), idx, w, out, B, K, D);
  } else {
    gather_agg_kernel<float><<<row_grid(B), row_block(), 0, stream>>>(
        static_cast<const float*>(feat), idx, w, out, B, K, D);
  }
}

}  // namespace repro_torch
