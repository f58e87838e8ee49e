// K4: blocked attention with an online softmax (FlashAttention forward).
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / G, j, :])
//                     @ v[b, h / G, :, :]          over the visible keys j
//
// Query row i sits at absolute position p = i + q_offset; key j is visible
// when j < kv_len, and j <= p when causal, and j > p - window when a window
// is set.  A row that sees no key comes out as 0.  G = Hq / Hkv (GQA: kv
// head = q head / G).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas.  That kernel runs a (B, Hq, Sq/bq, Sk/bk) grid with
// the kv blocks innermost, carries (m, l, acc) across them in VMEM scratch
// and skips tiles no row of its block can see (pl.when).  Here one block
// owns one (b, kv head) and kRows consecutive rows of the group's row space
// (row = query position * G + head in group), so one K/V tile in shared
// memory serves every query head of the group; the sequential kv axis
// becomes a loop inside the block over the keys that some row of the block
// can see (the causal wedge and the window band are cut at the ends of the
// loop, as pl.when does per tile).
//
// Per tile of 32 keys: every thread of the block stages K and V (as f32) in
// shared memory; each warp owns kRowsPerWarp rows and lane j computes the
// score of key j for each of them (f32 dot over Dh, q already cast to f32
// and multiplied by scale, as the Pallas kernel does before its dot).  A
// warp max and a warp sum give the online softmax in the Pallas kernel's
// order: m_new = max(m, tile max); p = exp(s - m_new), 0 where masked;
// alpha = exp(m - m_new); l = l * alpha + sum p; acc = acc * alpha + p @ v.
// acc[Dh] is spread over the lanes (lane l owns d = l + 32 i) in registers;
// the scaled queries are read from shared memory as float4 broadcasts;
// the output is acc / max(l, 1e-30), cast to q's type once, at the end.
// Masked scores are -1e30, never -inf, so no exp sees inf - inf.  expf and
// IEEE division throughout; no fast math.
//
// What bounds it on an H100: for decode (Sq = 1) HBM bytes, the K/V it
// reads; for prefill-sized causal or windowed attention the operations,
// 4 * Dh per visible (row, key) pair, at 67 TFLOP/s for f32 on the CUDA
// cores.  This kernel is route (iii) of flash_attention_cuda: it takes the
// float32 calls with more than 16 rows per (batch, kv head).  The products
// stay on the CUDA cores in f32 because the tensor cores would run f32 as
// TF32 (about three decimal digits), which the f32 limits (2e-5 / 1e-4)
// do not allow.  Few-row calls (decode) take the split-KV route
// (flash_attention_split.cu) and bf16 prefill the tensor-core route
// (flash_attention_tc.cu); the wrapper also exposes this kernel by name, as
// the in-call baseline the other routes are timed against.
#include "flash_common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kFaWarps = 8;                    // warps per block
constexpr int kRowsPerWarp = 4;                // query rows each warp owns
constexpr int kRows = kFaWarps * kRowsPerWarp; // rows per block
constexpr int kTile = kWarp;                   // keys per tile: one per lane
constexpr float kNeg = -1e30f;                 // the Pallas kernel's _NEG
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store_elt(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elt(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);                    // round to nearest even
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Shared memory: K tile [kTile][Dh + 1] (the odd pitch keeps lane j's reads
// of row j on distinct banks), V tile [kTile][Dh], the block's scaled
// queries [kRows][Dh]; all f32.
inline size_t smem_bytes(int dh) {
  return sizeof(float) *
         (static_cast<size_t>(kTile) * (dh + 1) + kTile * dh + kRows * dh);
}

// NDL: acc columns per lane, ceil(Dh / 32) rounded up to 1, 2, 4 or 8.
template <typename T, int NDL>
__global__ void __launch_bounds__(kFaWarps * kWarp)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Sq, int Sk, int Dh, float scale,
                       int causal, int window, int kv_len, int q_offset) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = Dh + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * pitch;
  float* q_s = v_s + kTile * Dh;

  const int group = Hq / Hkv;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = group * Sq;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  constexpr int kThreads = kFaWarps * kWarp;

  for (int e = tid; e < kRows * Dh; e += kThreads) {
    const int r = e / Dh;
    const int d = e - r * Dh;
    const int row = row0 + r;
    float x = 0.0f;
    if (row < n_rows) {
      const int h = hk * group + row % group;
      const int i = row / group;
      x = to_f32(q[((static_cast<int64_t>(b) * Hq + h) * Sq + i) * Dh + d]) *
          scale;
    }
    q_s[e] = x;
  }

  // keys that some row of this block can see: [col_begin, col_end)
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int p_lo = row0 / group + q_offset;
  const int p_hi = last_row / group + q_offset;
  const int kv_lim = min(kv_len, Sk);
  int col_end = kv_lim;
  if (causal) col_end = min(col_end, p_hi + 1);
  const int col_begin = window > 0 ? max(0, p_lo - window + 1) : 0;

  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * Sk * Dh;
  const T* k_bh = k + kv_base;
  const T* v_bh = v + kv_base;

  const int r_first = warp * kRowsPerWarp;     // this warp's rows
  int pos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][NDL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    pos[rr] = (row0 + r_first + rr) / group + q_offset;
    m[rr] = kNeg;
    l[rr] = 0.0f;
#pragma unroll
    for (int i = 0; i < NDL; ++i) acc[rr][i] = 0.0f;
  }

  for (int c0 = col_begin; c0 < col_end; c0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    for (int e = tid; e < kTile * Dh; e += kThreads) {
      const int j = e / Dh;
      const int d = e - j * Dh;
      const int c = c0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (c < col_end) {
        kx = to_f32(k_bh[static_cast<int64_t>(c) * Dh + d]);
        vx = to_f32(v_bh[static_cast<int64_t>(c) * Dh + d]);
      }
      k_s[j * pitch + d] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    // scores of key c for the warp's rows (lane j holds key c0 + j)
    const int c = c0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.0f;
    const float* k_row = k_s + lane * pitch;
    const float4* q_w = reinterpret_cast<const float4*>(q_s + r_first * Dh);
    const int dq = Dh / 4;           // Dh % 8 == 0: rows are float4-aligned
    for (int d4 = 0; d4 < dq; ++d4) {
      const float k0 = k_row[4 * d4], k1 = k_row[4 * d4 + 1];
      const float k2 = k_row[4 * d4 + 2], k3 = k_row[4 * d4 + 3];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float4 qv = q_w[rr * dq + d4];   // one broadcast read
        s[rr] += qv.x * k0;
        s[rr] += qv.y * k1;
        s[rr] += qv.z * k2;
        s[rr] += qv.w * k3;
      }
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      bool vis = c < kv_lim;
      if (causal) vis = vis && c <= pos[rr];
      if (window > 0) vis = vis && c > pos[rr] - window;
      const float sc = vis ? s[rr] : kNeg;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      p[rr] = vis ? expf(sc - m_new) : 0.0f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < NDL; ++i) acc[rr][i] *= alpha;
    }
    for (int j = 0; j < kTile; ++j) {
      float vj[NDL];
#pragma unroll
      for (int i = 0; i < NDL; ++i) {
        const int d = lane + i * kWarp;
        vj[i] = d < Dh ? v_s[j * Dh + d] : 0.0f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = __shfl_sync(kFull, p[rr], j);
#pragma unroll
        for (int i = 0; i < NDL; ++i) acc[rr][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + r_first + rr;
    if (row >= n_rows) break;
    const int h = hk * group + row % group;
    const int i_q = row / group;
    T* o = out + ((static_cast<int64_t>(b) * Hq + h) * Sq + i_q) * Dh;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + i * kWarp;
      if (d < Dh) store_elt(o + d, acc[rr][i] / denom);
    }
  }
}

template <typename T, int NDL>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int Hq, int Hkv, int Sq, int Sk, int Dh, float scale, int causal,
            int window, int kv_len, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_attention_kernel<T, NDL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int n_rows = (Hq / Hkv) * Sq;
  const dim3 grid((n_rows + kRows - 1) / kRows, Hkv, B);
  flash_attention_kernel<T, NDL><<<grid, kFaWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Sk, Dh,
      scale, causal, window, kv_len, q_offset);
}

template <typename T>
void launch_dh(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Sq, int Sk, int Dh, float scale,
               int causal, int window, int kv_len, int q_offset,
               cudaStream_t stream) {
  const int ndl = (Dh + kWarp - 1) / kWarp;
  if (ndl <= 1) {
    launch<T, 1>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale, causal, window,
                 kv_len, q_offset, stream);
  } else if (ndl <= 2) {
    launch<T, 2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale, causal, window,
                 kv_len, q_offset, stream);
  } else if (ndl <= 4) {
    launch<T, 4>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale, causal, window,
                 kv_len, q_offset, stream);
  } else {
    launch<T, 8>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale, causal, window,
                 kv_len, q_offset, stream);
  }
}

}  // namespace

void launch_flash_attention(const void* q, const void* k, const void* v,
                            void* out, int bf16, int B, int Hq, int Hkv,
                            int Sq, int Sk, int Dh, float scale, int causal,
                            int window, int kv_len, int q_offset,
                            cudaStream_t stream) {
  if (bf16) {
    launch_dh<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale,
                             causal, window, kv_len, q_offset, stream);
  } else {
    launch_dh<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale, causal,
                     window, kv_len, q_offset, stream);
  }
}

}  // namespace repro_torch
