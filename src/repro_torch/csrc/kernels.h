// Plain C++ launch interface of the port's CUDA kernels.
//
// Only bindings.cpp includes torch headers; the .cu files include this
// header and cuda_runtime.h alone, so nvcc never parses PyTorch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

// out[b, :] = sum_k w[b, k] * feat[idx[b, k], :]        (K2, gather_agg.cu)
// feat [N, D] float32 (feat_bf16 == 0) or bfloat16 (feat_bf16 == 1).
void launch_gather_agg(const void* feat, int feat_bf16, const int32_t* idx,
                       const float* w, float* out, int64_t B, int K, int D,
                       cudaStream_t stream);

// out[b, :] = sum_k w[b, k] * h0(idx[b, k])              (K1, cache_lookup.cu)
// h0(r) = slots[r] >= 0 ? cache[slots[r], :] : streamed[r, :]
// cache [C, D] float32 (cache_bf16 == 0) or bfloat16; streamed [S0, D] f32.
void launch_cache_lookup_agg(const void* cache, int cache_bf16,
                             const float* streamed, const int32_t* slots,
                             const int32_t* idx, const float* w, float* out,
                             int64_t B, int K, int D, cudaStream_t stream);

}  // namespace repro_torch
