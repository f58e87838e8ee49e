// K1: fused cache lookup + GraphSAGE layer-0 gather-aggregate.
//
//   out[b, :] = sum_k w[b, k] * h0(idx[b, k])           (k ascending, f32)
//   h0(r)     = slots[r] >= 0 ? cache[slots[r], :] : streamed[r, :]
//
// Replaces the TPU kernel repro/kernels/cache_lookup.py::
// cache_lookup_agg_pallas.  h0 is never materialised.
//
// What bounds it on an H100 (preset paper_train, K = 5, D = 100, a 305-row
// cache):
//   * at the training shape of the host backend's fused input (B = 176,000
//     padded rows over a [1,056,000, 100] streamed array), the padded
//     output: 70.4 MB of the 77.6 MB the call needs (idx and w 7.0 MB;
//     the live lanes name a few hundred distinct rows, most of them cache
//     rows), 23 us at 3.35 TB/s.  The padded rows' lanes (idx 0, w 0) all
//     name one row, which stays in L1;
//   * at the serving shapes (b=128: B = 22,528, 10.0 MB, 3.0 us; b=512:
//     B = 90,112, 39.8 MB, 11.9 us), the launch and the memory's latency:
//     each lane is a chain of three dependent loads (idx, then slots[idx],
//     then the row), so a thread that walks its lanes alone waits out
//     three round trips per lane.
//
// The design (tile_accum.cuh, as K2 and K3): a block owns a tile of 40
// rows at D = 100 (1024 units per block, K3's plan; scripts/tile_sweep.py
// times the alternatives), 8 blocks per SM at 32 registers.  In the lane pass every thread of the block
// takes (row, lane) pairs of the tile, 200 of 256 at K = 5, reads
// r = idx[b, k] and s = slots[r] and stores the lane's code, s on a hit
// and ~r on a miss, beside w[b, k] in shared memory: the tile's idx ->
// slots chains are all in flight at once, and the gather pass reads the
// codes from shared memory.  There each thread owns 16-byte column groups
// (4 per thread at D = 100), writes its K row loads ahead of their sums,
// and stores its 4 sums as one 16-byte word, so the output, the bulk of
// the bytes, is written in full words by neighbouring threads.  With an
// f32 cache the lane's base pointer is a select between the two tables:
// no branch.  K may be any size: 32 lanes of each row at a time, the
// partial sums carried in the output, as K2 does.
//
// Why the TPU kernel's scheme is not carried over: its index maps DMA
// BOTH candidate rows (cache row and streamed row) into VMEM at every
// grid step and select on the VPU, because a BlockSpec cannot choose its
// source by data; and it needs the lanes' slots gathered on the XLA side
// first, since SMEM cannot hold the slot map.  On the H100 a thread picks
// its row by the slot and reads only that one, so a dead candidate row
// costs no bytes, and the slots are read in the kernel, so no pre-gather
// pass writes and reads a [B, K] array.
//
// Every lane is accumulated, w = 0 padding included, from the row the
// plain version reads, product and sum rounded separately (tile_accum.cuh):
// the result is bitwise the plain version's in
// repro_torch/kernels/cache_lookup.py on any input.  idx must lie in
// [0, S0) and slots in [-1, C); they are not checked on the device.
#include "kernels.h"
#include "tile_accum.cuh"

namespace repro_torch {
namespace {

// Blocks of 256 threads that the kernel must fit 8 of on an SM (its 2048
// threads): at most 32 registers, as K2 and K3 take unasked.  Left to
// itself the compiler gives the f32 vector kernel 42 (the select between
// the two tables keeps both base addresses live), which fits 5 blocks, and
// K1 ran slower at all three main-path shapes in scripts/tile_sweep.py.
constexpr int kMinBlocksPerSm = 8;

template <typename T, bool kVec>
__global__ void __launch_bounds__(tile::kMaxThreads, kMinBlocksPerSm)
cache_lookup_agg_kernel(const T* __restrict__ cache,
                        const float* __restrict__ streamed,
                        const int32_t* __restrict__ slots,
                        const int32_t* __restrict__ idx,
                        const float* __restrict__ w, float* __restrict__ out,
                        int64_t B, int K, int D, int tile_rows) {
  const tile::Lanes s =
      tile::tile_lanes(tile_rows, min(K, tile::kLaneChunk));
  const int64_t b0 = tile::tile_start(tile_rows);
  const int rows = tile::tile_len(b0, tile_rows, B);
  const auto resolve = [&](int64_t g, int32_t& code, float& wt) {
    const int32_t r = idx[g];
    const int32_t slot = slots[r];
    code = slot >= 0 ? slot : ~r;    // a cache row, or streamed row r
    wt = w[g];
  };
  tile::gather_lanes(tile::TwoTables<T, kVec>{cache, streamed}, resolve, s,
                     K, out, b0, rows, D);
}

// K1's units per block (tile_accum.cuh): 40 rows of D = 100 per block.
constexpr int kUnitsPerBlock = 1024;

template <typename T>
void launch(const T* cache, const float* streamed, const int32_t* slots,
            const int32_t* idx, const float* w, float* out, int64_t B, int K,
            int D, int vec, int tile_rows, cudaStream_t stream) {
  const tile::Plan p = tile::plan(K, D, vec, kUnitsPerBlock, tile_rows);
  const dim3 grid = tile::tile_grid(B, p.rows);
  const size_t smem = tile::lanes_bytes(p.rows, K);
  if (vec) {
    cache_lookup_agg_kernel<T, true><<<grid, p.threads, smem, stream>>>(
        cache, streamed, slots, idx, w, out, B, K, D, p.rows);
  } else {
    cache_lookup_agg_kernel<T, false><<<grid, p.threads, smem, stream>>>(
        cache, streamed, slots, idx, w, out, B, K, D, p.rows);
  }
}

}  // namespace

void launch_cache_lookup_agg(const void* cache, int cache_bf16,
                             const float* streamed, const int32_t* slots,
                             const int32_t* idx, const float* w, float* out,
                             int64_t B, int K, int D, int vec, int tile_rows,
                             cudaStream_t stream) {
  if (cache_bf16) {
    launch(static_cast<const __nv_bfloat16*>(cache), streamed, slots, idx, w,
           out, B, K, D, vec, tile_rows, stream);
  } else {
    launch(static_cast<const float*>(cache), streamed, slots, idx, w, out, B,
           K, D, vec, tile_rows, stream);
  }
}

}  // namespace repro_torch
