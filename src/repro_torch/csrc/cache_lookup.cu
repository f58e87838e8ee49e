// K1: fused cache lookup + GraphSAGE layer-0 gather-aggregate.
//
//   out[b, :] = sum_k w[b, k] * h0(idx[b, k])           (k ascending, f32)
//   h0(r)     = slots[r] >= 0 ? cache[slots[r], :] : streamed[r, :]
//
// Replaces the TPU kernel repro/kernels/cache_lookup.py::
// cache_lookup_agg_pallas.  That kernel needs the per-lane slots
// slots[idx[b, k]] pre-gathered on the XLA side (SMEM cannot hold the full
// slot map) and DMAs BOTH candidate rows every grid step, selecting the live
// one on the VPU.  Here one warp owns a destination row, loops over k
// itself, reads slots[idx[b, k]] in the kernel (one broadcast load per
// lane) and then loads ONLY the live row: the branch is uniform across the
// warp, so nothing diverges and the dead row costs no bytes.  h0 is never
// materialised.
//
// What bounds it on an H100: HBM bytes.  Per call it reads the live rows
// its lanes name (B*K*D*elt bytes, elt of the cache table for hits and 4
// for streamed misses, or each distinct row once when repeats hit in L2),
// idx, w and the lanes' slots (B*K*12) and writes the output (B*D*4),
// against two flops per gathered element.  The design moves only those
// bytes (no pre-gather pass, no dead-row loads); each warp load instruction
// reads 32 neighbouring elements of one row and each lane keeps 8 loads in
// flight per k.  No wgmma, TMA or pipelining yet.
//
// Every lane is accumulated, including lanes with w == 0 (padding), in
// ascending k, product and sum rounded separately (see row_accum.cuh): the
// result is bitwise the plain version's in
// repro_torch/kernels/cache_lookup.py.  idx must lie in [0, S0) and slots in
// [-1, C); they are not checked on the device.
#include "kernels.h"
#include "row_accum.cuh"

namespace repro_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
cache_lookup_agg_kernel(const T* __restrict__ cache,
                        const float* __restrict__ streamed,
                        const int32_t* __restrict__ slots,
                        const int32_t* __restrict__ idx,
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
      const int32_t r = idx_b[k];
      const int32_t s = slots[r];
      if (s >= 0) {
        accumulate_row(acc, cache + static_cast<int64_t>(s) * D, w_b[k], d0,
                       lane, D);
      } else {
        accumulate_row(acc, streamed + static_cast<int64_t>(r) * D, w_b[k],
                       d0, lane, D);
      }
    }
    store_row(acc, out + b * D, d0, lane, D);
  }
}

}  // namespace

void launch_cache_lookup_agg(const void* cache, int cache_bf16,
                             const float* streamed, const int32_t* slots,
                             const int32_t* idx, const float* w, float* out,
                             int64_t B, int K, int D, cudaStream_t stream) {
  if (cache_bf16) {
    cache_lookup_agg_kernel<__nv_bfloat16>
        <<<row_grid(B), row_block(), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(cache), streamed, slots, idx, w,
            out, B, K, D);
  } else {
    cache_lookup_agg_kernel<float><<<row_grid(B), row_block(), 0, stream>>>(
        static_cast<const float*>(cache), streamed, slots, idx, w, out, B, K,
        D);
  }
}

}  // namespace repro_torch
