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
// Row range: `table` holds the global rows [row_lo, row_lo + row_count)
// of the cache (one shard of a row-sharded table, or the whole table with
// row_lo = 0 and row_count = table_rows, which gives the unsharded result
// bit for bit).  The draw and the fallback merge run over the whole CSR as
// above; a lane whose row lies outside the range gets weight 0 and reads
// nothing of its own (local row 0, as a dead lane), a lane inside reads
// local row row - row_lo.  So the partials of the shards sum to the
// unsharded result, with only zero terms added.  row_count = 0 (an empty
// table) writes zeros and loads no row.
//
// Replaces the TPU kernel repro/sampling/kernels.py::slot_gather_agg_pallas
// and folds in the draw that the reference leaves to XLA (draw_lanes, merged
// with the fallback lanes in gns_sample_agg).  The Pallas kernel reads the
// drawn rows from SMEM through scalar prefetch and runs a (B, D/block, K)
// grid with K innermost.
//
// What bounds it on an H100: HBM bytes, dominated by the output.  At the
// training shape of preset paper_train (B = 176,000, K = 5, D = 100, a
// 305-row f32 table) it writes 70.4 MB of output and reads 7 MB of fallback
// lanes, 0.7 MB of dst_rows and a 122 KB table: about 78 MB, 23 us at
// 3.35 TB/s, against two flops per gathered element and a few integer ops
// per lane.  At the bucket-128 serving shape (B = 22,528) it is 10 MB, 3 us,
// and the launch and latency show.
//
// The design (tile_accum.cuh): a block owns a tile of 40 rows (D = 100).
// Pass 1 runs the draw for every (row, lane) pair of the tile, one pair
// per thread (200 of 256), so the tile's chains of dependent loads
// (dst_rows -> indptr -> indices -> hitp) are all in flight together; the
// fallback lanes are read beside dst_rows, not after it, which takes one
// round trip off the chain of the uncached rows (almost all of them at the
// training shape; the cached rows' unused fallback lanes cost 8 bytes a
// lane).  The lanes go to shared memory, and to lane_rows/lane_w when the
// caller asks (coalesced: the tile's lanes are contiguous there).  Pass 2
// gathers: a thread owns four 16-byte column groups in turn (25 per row),
// issues each one's K loads and stores one 16-byte word, so the output,
// the bulk of the bytes, is written in full 16-byte words by neighbouring
// threads.  At 32 registers and 1.6 KB of shared memory, 8 blocks (320
// rows) are resident per SM, and the table (122 KB at paper_train) stays
// in L1.  b in mix32 is the global row index (b0 + r), never the
// tile-local one.
//
// Rounding: the weight is computed with __fdiv_rn / __fmul_rn, and the sum
// with __fmul_rn then __fadd_rn (tile_accum.cuh), so nvcc contracts nothing
// into an FMA; the result is bitwise the plain version's in
// repro_torch/sampling/kernels.py on any input.  Indices are not checked on
// the device: dst_rows must lie in [-1, table_rows), fb_rows in
// [-1, table_rows).  K <= 32 (the wrapper checks).
#include "kernels.h"
#include "tile_accum.cuh"

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(tile::kMaxThreads)
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
                      float* __restrict__ lane_w, int32_t row_lo,
                      int32_t row_count, int64_t B, int K, int D,
                      int tile_rows) {
  const tile::Lanes s = tile::tile_lanes(tile_rows, K);
  const int64_t b0 = tile::tile_start(tile_rows);
  const int rows = tile::tile_len(b0, tile_rows, B);

  // --- pass 1: the draw, one (row, lane) pair per thread -----------------
  for (int t = threadIdx.x; t < rows * K; t += blockDim.x) {
    const int r = t / K;
    const int lane = t - r * K;
    const int64_t b = b0 + r;
    const int64_t g = b0 * K + t;            // = b * K + lane
    const int32_t dst = dst_rows[b];
    int32_t row = fb_rows[g];                // uncached: the fallback lane
    float w = fb_w[g];
    if (dst >= 0) {
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
      row = -1;
      w = 0.0f;
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
      lane_rows[g] = row;
      lane_w[g] = w;
    }
    // dead or outside [row_lo, row_lo + row_count): w = 0 times local row 0
    const bool mine = row >= row_lo && row - row_lo < row_count;
    s.code[t] = mine ? row - row_lo : 0;
    s.w[t] = mine ? w : 0.0f;
  }
  __syncthreads();

  // --- pass 2: the gather, lanes in ascending order (none of an empty
  // table: the sums stay 0) -----------------------------------------------
  tile::gather_tile(tile::OneTable<T, kVec>{table}, s, row_count > 0 ? K : 0,
                    true, out, b0, rows, D);
}

// K3's units per block (tile_accum.cuh): 40 rows of D = 100 per block.
constexpr int kUnitsPerBlock = 1024;

template <typename T, bool kVec>
void launch_path(const int32_t* indptr, const int32_t* indices,
                 int64_t cap, const float* deg, const float* hitp,
                 const T* table, const int32_t* dst_rows,
                 const int32_t* fb_rows, const float* fb_w, uint32_t key_lo,
                 uint32_t key_hi, float* out, int32_t* lane_rows,
                 float* lane_w, int32_t row_lo, int32_t row_count, int64_t B,
                 int K, int D, int tile_rows, cudaStream_t stream) {
  const tile::Plan p = tile::plan(K, D, kVec, kUnitsPerBlock, tile_rows);
  gns_sample_agg_kernel<T, kVec>
      <<<tile::tile_grid(B, p.rows), p.threads,
         tile::lanes_bytes(p.rows, K), stream>>>(
          indptr, indices, cap, deg, hitp, table, dst_rows, fb_rows, fb_w,
          key_lo, key_hi, out, lane_rows, lane_w, row_lo, row_count, B, K, D,
          p.rows);
}

template <typename T>
void launch(const int32_t* indptr, const int32_t* indices, int64_t cap,
            const float* deg, const float* hitp, const T* table,
            const int32_t* dst_rows, const int32_t* fb_rows, const float* fb_w,
            uint32_t key_lo, uint32_t key_hi, float* out, int32_t* lane_rows,
            float* lane_w, int32_t row_lo, int32_t row_count, int64_t B,
            int K, int D, int vec, int tile_rows, cudaStream_t stream) {
  if (vec) {
    launch_path<T, true>(indptr, indices, cap, deg, hitp, table, dst_rows,
                         fb_rows, fb_w, key_lo, key_hi, out, lane_rows,
                         lane_w, row_lo, row_count, B, K, D, tile_rows,
                         stream);
  } else {
    launch_path<T, false>(indptr, indices, cap, deg, hitp, table, dst_rows,
                          fb_rows, fb_w, key_lo, key_hi, out, lane_rows,
                          lane_w, row_lo, row_count, B, K, D, tile_rows,
                          stream);
  }
}

}  // namespace

void launch_gns_sample_agg(const int32_t* indptr, const int32_t* indices,
                           int64_t cap, const float* deg, const float* hitp,
                           const void* table, int table_bf16,
                           const int32_t* dst_rows, const int32_t* fb_rows,
                           const float* fb_w, uint32_t key_lo, uint32_t key_hi,
                           float* out, int32_t* lane_rows, float* lane_w,
                           int32_t row_lo, int32_t row_count, int64_t B,
                           int K, int D, int vec, int tile_rows,
                           cudaStream_t stream) {
  if (table_bf16) {
    launch(indptr, indices, cap, deg, hitp,
           static_cast<const __nv_bfloat16*>(table), dst_rows, fb_rows, fb_w,
           key_lo, key_hi, out, lane_rows, lane_w, row_lo, row_count, B, K, D,
           vec, tile_rows, stream);
  } else {
    launch(indptr, indices, cap, deg, hitp, static_cast<const float*>(table),
           dst_rows, fb_rows, fb_w, key_lo, key_hi, out, lane_rows, lane_w,
           row_lo, row_count, B, K, D, vec, tile_rows, stream);
  }
}

}  // namespace repro_torch
