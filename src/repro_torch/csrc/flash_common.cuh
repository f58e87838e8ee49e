// Shared pieces of K4's routes (flash_attention_split.cu,
// flash_attention_tc.cu, flash_attention.cu): the warp width and the
// widening of an element to f32; the Pallas kernel's mask value, 16-byte
// cp.async copies with zero fill, the visibility rule of a (query
// position, key) pair, and the output store.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace repro_torch {

constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

namespace flash {

constexpr float kNeg = -1e30f;        // the Pallas kernel's _NEG, never -inf
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes global -> shared, asynchronous; when !valid nothing is read and
// the 16 bytes are zero-filled (the src-size operand is 0), so a tile's
// rows past kv_len, and the padded head-dim columns, read as 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Key c is visible from the query at absolute position pos.
__device__ __forceinline__ bool visible(int c, int pos, int kv_lim,
                                        int causal, int window) {
  bool vis = c < kv_lim;
  if (causal) vis = vis && c <= pos;
  if (window > 0) vis = vis && c > pos - window;
  return vis;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace flash
}  // namespace repro_torch
