// K2: weighted gather-aggregate for GraphSAGE layers 1..L-1.
//
//   out[b, :] = sum_k w[b, k] * feat[idx[b, k], :]      (k ascending, f32)
//
// Replaces the TPU kernel repro/kernels/gather_agg.py::gather_agg_pallas
// (a (B, D/block_d, K) grid with K innermost, one output tile in VMEM while
// the K rows stream in).
//
// What bounds it on an H100: at the serving shapes of preset paper_train
// (layer 1: B = 16b rows, K = 10; layer 2: B = b, K = 15; D = 256, f32;
// b = 128 or 512) the bytes the function needs are 1.6-23 MB, 0.5-7 us at
// 3.35 TB/s, so the launch and the memory's latency bound the small calls:
// at b=128 layer 2 the whole call is 128 rows.  At b=512 layer 1 the lanes
// name 84 MB of rows, most of them repeats that L2 serves, and that
// traffic bounds it.
//
// The design (tile_accum.cuh): a block owns a tile of rows; its threads
// first copy the tile's idx and w into shared memory in one coalesced pass,
// then each thread owns one 16-byte column group of a row, writes its K
// row loads ahead of their sums (8 at a time), and stores its 4 sums as
// one 16-byte word.  The tile plan gives each block one row of D = 256 (64
// threads): 128 blocks at b=128 layer 2, 8,192 at b=512 layer 1, one
// column group per thread, so a call waits out about three round trips to
// memory (idx and w, the rows, the store) and the shared memory the tile
// takes (80-120 bytes) leaves the SM's L1 to the rows.  K may be any size:
// 32 lanes of each row at a time, the partial sums carried in the output.
//
// Bitwise the plain version in repro_torch/kernels/gather_agg.py on any
// input (tile_accum.cuh).  Indices must lie in [0, N); they are not checked
// on the device.
#include "kernels.h"
#include "tile_accum.cuh"

namespace repro_torch {
namespace {

template <typename T, bool kVec>
__global__ void __launch_bounds__(tile::kMaxThreads)
gather_agg_kernel(const T* __restrict__ feat, const int32_t* __restrict__ idx,
                  const float* __restrict__ w, float* __restrict__ out,
                  int64_t B, int K, int D, int tile_rows) {
  const tile::Lanes s =
      tile::tile_lanes(tile_rows, min(K, tile::kLaneChunk));
  const int64_t b0 = tile::tile_start(tile_rows);
  const int rows = tile::tile_len(b0, tile_rows, B);
  const auto resolve = [&](int64_t g, int32_t& code, float& wt) {
    code = idx[g];
    wt = w[g];
  };
  tile::gather_lanes(tile::OneTable<T, kVec>{feat}, resolve, s, K, out, b0,
                     rows, D);
}

// K2's units per block (tile_accum.cuh): one row of D = 256 per block.
constexpr int kUnitsPerBlock = 64;

template <typename T>
void launch(const T* feat, const int32_t* idx, const float* w, float* out,
            int64_t B, int K, int D, int vec, int tile_rows,
            cudaStream_t stream) {
  const tile::Plan p = tile::plan(K, D, vec, kUnitsPerBlock, tile_rows);
  const dim3 grid = tile::tile_grid(B, p.rows);
  const size_t smem = tile::lanes_bytes(p.rows, K);
  if (vec) {
    gather_agg_kernel<T, true><<<grid, p.threads, smem, stream>>>(
        feat, idx, w, out, B, K, D, p.rows);
  } else {
    gather_agg_kernel<T, false><<<grid, p.threads, smem, stream>>>(
        feat, idx, w, out, B, K, D, p.rows);
  }
}

}  // namespace

void launch_gather_agg(const void* feat, int feat_bf16, const int32_t* idx,
                       const float* w, float* out, int64_t B, int K, int D,
                       int vec, int tile_rows, cudaStream_t stream) {
  if (feat_bf16) {
    launch(static_cast<const __nv_bfloat16*>(feat), idx, w, out, B, K, D,
           vec, tile_rows, stream);
  } else {
    launch(static_cast<const float*>(feat), idx, w, out, B, K, D, vec,
           tile_rows, stream);
  }
}

}  // namespace repro_torch
