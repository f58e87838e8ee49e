// Plain C++ launch interface of the port's CUDA kernels.
//
// Only bindings.cpp includes torch headers; the .cu files include this
// header and cuda_runtime.h alone, so nvcc never parses PyTorch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

// K1's, K2's and K3's tiles hold at most this many destination rows
// (tile_accum.cuh).
constexpr int kMaxTileRows = 64;

// out[b, :] = sum_k w[b, k] * feat[idx[b, k], :]        (K2, gather_agg.cu)
// feat [N, D] float32 (feat_bf16 == 0) or bfloat16 (feat_bf16 == 1).
// vec != 0: 4 columns per access (D % 4 == 0, feat 16-byte (f32) or 8-byte
// (bf16) aligned, out 16-byte aligned), else one.  tile_rows 0: the
// kernel's own tile plan; 1..kMaxTileRows: that many rows per tile.
void launch_gather_agg(const void* feat, int feat_bf16, const int32_t* idx,
                       const float* w, float* out, int64_t B, int K, int D,
                       int vec, int tile_rows, cudaStream_t stream);

// out[b, :] = sum_k w[b, k] * h0(idx[b, k])              (K1, cache_lookup.cu)
// h0(r) = slots[r] >= 0 ? cache[slots[r], :] : streamed[r, :]
// cache [C, D] float32 (cache_bf16 == 0) or bfloat16; streamed [S0, D] f32.
// vec and tile_rows as K2's (vec: both tables aligned).
void launch_cache_lookup_agg(const void* cache, int cache_bf16,
                             const float* streamed, const int32_t* slots,
                             const int32_t* idx, const float* w, float* out,
                             int64_t B, int K, int D, int vec, int tile_rows,
                             cudaStream_t stream);

// The device GNS input layer                           (K3, gns_sample_agg.cu)
// per row b: draw K lanes from the CSR (indptr, indices[cap], deg, hitp)
// when dst_rows[b] >= 0, else take the fallback lanes fb_rows/fb_w; then
// out[b, :] = sum_l w_l * table[row_l - row_lo, :] over the lanes whose row
// lies in [row_lo, row_lo + row_count), the rows table [row_count, D]
// holds (float32 when table_bf16 == 0, else bfloat16; the whole table:
// row_lo = 0, row_count = C).  lane_rows/lane_w [B, K] receive the merged
// lanes when not null.  K <= 32; vec and tile_rows as K2's.
void launch_gns_sample_agg(const int32_t* indptr, const int32_t* indices,
                           int64_t cap, const float* deg, const float* hitp,
                           const void* table, int table_bf16,
                           const int32_t* dst_rows, const int32_t* fb_rows,
                           const float* fb_w, uint32_t key_lo, uint32_t key_hi,
                           float* out, int32_t* lane_rows, float* lane_w,
                           int32_t row_lo, int32_t row_count, int64_t B,
                           int K, int D, int vec, int tile_rows,
                           cudaStream_t stream);

// Blocked attention with an online softmax      (K4, flash_attention.cu)
// q/out [B, Hq, Sq, Dh], k/v [B, Hkv, Sk, Dh], all float32 (bf16 == 0) or
// all bfloat16, contiguous; Hq % Hkv == 0, Dh <= 256.  Query row i sits at
// position i + q_offset; key j is visible when j < kv_len, and j <= i +
// q_offset when causal, and j > i + q_offset - window when window > 0.
void launch_flash_attention(const void* q, const void* k, const void* v,
                            void* out, int bf16, int B, int Hq, int Hkv,
                            int Sq, int Sk, int Dh, float scale, int causal,
                            int window, int kv_len, int q_offset,
                            cudaStream_t stream);

// K4, route (i): split-KV attention for at most 16 rows per (b, kv head)
// (flash_attention_split.cu).  Pass 1, grid (splits, Hkv, B): keys
// [col_begin, col_end) cut into chunks of `chunk` (a multiple of 32), each
// shared by `ways` warps per group of rows; each block writes one partial
// (m, l, acc[Dh]) per row to part_ml [B, Hkv, splits, G * Sq, 2] and
// part_acc [..., Dh], f32.  Needs ceil(G * Sq / (8 / ways)) <= 4.  Pass 2
// combines the splits into out.
void launch_flash_split_partial(const void* q, const void* k, const void* v,
                                float* part_acc, float* part_ml, int bf16,
                                int B, int Hq, int Hkv, int Sq, int Sk,
                                int Dh, float scale, int causal, int window,
                                int kv_len, int q_offset, int col_begin,
                                int col_end, int chunk, int splits, int ways,
                                cudaStream_t stream);
void launch_flash_split_combine(const float* part_acc, const float* part_ml,
                                void* out, int bf16, int B, int Hq, int Hkv,
                                int Sq, int Dh, int n_part,
                                cudaStream_t stream);

// K4, route (ii): FlashAttention-2 on the tensor cores (mma.sync), bf16
// only (flash_attention_tc.cu); the arguments of launch_flash_attention.
void launch_flash_attention_tc(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Sq,
                               int Sk, int Dh, float scale, int causal,
                               int window, int kv_len, int q_offset,
                               cudaStream_t stream);

}  // namespace repro_torch
