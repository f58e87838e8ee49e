// K4, route (ii): FlashAttention-2 forward on the tensor cores, bf16.
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / G, j, :])
//                     @ v[b, h / G, :, :]          over the visible keys j
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas for bf16 calls with many query rows (prefill-sized
// causal or windowed attention).  Semantics are the Pallas kernel's: query
// row i sits at position i + q_offset; key j is visible when j < kv_len,
// and j <= position when causal, and j > position - window when a window
// is set; masked scores are -1e30, never -inf; softmax statistics in f32,
// l >= 1e-30; a row that sees no key is 0; one cast to bf16 at the end.
//
// What bounds it on an H100: bf16 operations, 4 * Dh per visible (row, key)
// pair at 989 TFLOP/s on the tensor cores: 0.122 ms for qwen2-7b's geometry
// (28/4 heads, Dh 128, 4096 causal), 0.391 ms for h2o-danube3's (32/8
// heads, Dh 120, 8192 causal, window 4096).  CUDA-core f32 (67 TFLOP/s)
// cannot come near that, so both products run on the tensor cores:
//
// * A block owns one (batch, kv head) and 128 consecutive rows of the
//   group's row space (row = position * G + head in group), so one K/V tile
//   in shared memory serves all G query heads of the group.  Up to DP = 128
//   it has 4 warps of 32 rows, so each K and V fragment read from shared
//   memory feeds two mma (half the shared-memory reads per mma of 8 warps
//   of 16 rows, and faster on the H100); at DP = 256, 8 warps of 16 rows
//   keep the accumulators in registers.  The key loop runs only over keys
//   some row of the block sees (the causal wedge and the window band are
//   cut at its ends, as pl.when skips tiles), and blockIdx.x runs
//   backwards, so the row tiles with the most keys under a causal mask
//   start first.
// * The head dim is padded in shared memory to DP = 64, 128 or 256 with
//   zero columns (danube's 120 -> 128); rows are padded by 16 bytes, so the
//   8 rows of each ldmatrix fall on distinct banks.
// * S = Q K^T runs as mma.sync.m16n8k16 (bf16 in, f32 accumulate), with Q
//   and K fragments from shared memory through ldmatrix (Q held in
//   registers at DP = 64).  The scale multiplies S in f32 after the
//   product: the product of two bf16 values is exact in f32, so this equals
//   the plain version's (q * scale) . k up to f32 rounding.  It is folded
//   with log2(e), so that exp(x) is one ex2.approx (2 ulp, as exp2f) of
//   x * log2(e).
// * The online softmax runs in registers in f32, per row: quad shuffles
//   give the row max; p = exp(s - m_new), 0 where masked (a masked score
//   is -1e30, whose exp2 is 0 against any row max, or against 0 while the
//   row has seen no key); l sums the f32 p (per thread, one quad sum at
//   the end).  P is then rounded to bf16 in registers and reused as the A
//   operand of O += P V (also mma.sync, f32 accumulate, V fragments
//   through ldmatrix.trans).  The rounding of P is
//   the one rounding the plain version does not make (2^-9 relative per
//   weight, averaged over the keys); l is taken from the unrounded p.
// * K/V tiles of BN keys (64; 32 at DP = 256, to keep the accumulators in
//   registers) go through a two-stage shared-memory ring filled by 16-byte
//   cp.async copies: the next tile loads while this one computes.  Rows
//   past the block's last visible key are zero-filled by cp.async's
//   src-size operand, so nothing past kv_len is ever read: a poisoned tail
//   reaches no exp and no product.  Tiles that no row of the block masks
//   skip the mask arithmetic.
//
// mma.sync reaches Hopper's tensor cores from plain CUDA C++; wgmma with TMA
// and warp specialisation, the design that approaches the card's peak, is
// what this kernel still lacks.  IEEE division; no fast math.
#include "flash_common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

using flash::kNeg;

constexpr int kBM = 128;                     // rows per block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit (ex2.approx.ftz: within 2 ulp, as
// exp2f; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(flash::kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(flash::kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(flash::kFull, x, 1);
  return x + __shfl_xor_sync(flash::kFull, x, 2);
}

template <int DP, int BN>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (DP + 8) * (kBM + 4 * BN);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// A (16x16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8,
// 2t+8..).  B (16x8): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).  C (16x8):
// c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
//
// DP: padded head dim; BN: keys per tile; WM: 16-row blocks per warp (a
// warp with two reuses each K and V fragment it loads twice, halving the
// shared-memory reads per mma).  Thread row r of the warp: 16 * (r / 2) +
// g + 8 * (r % 2).
template <int DP, int BN, int WM>
__global__ void __launch_bounds__(kBM / (16 * WM) * 32)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                int Sk, int Dh, float scale, int causal, int window,
                int kv_len, int q_offset) {
  constexpr int kThreads = kBM / (16 * WM) * 32;
  constexpr int kPitch = DP + 8;             // elements: 16 bytes of pad
  constexpr int kPieces = DP / 8;            // 16-byte pieces per row
  constexpr bool kQRegs = DP * WM <= 128;    // Q fragments kept in registers
  constexpr int kSB = BN / 8;                // S column blocks
  constexpr int kOB = DP / 8;                // O column blocks
  constexpr int kR = 2 * WM;                 // rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + kBM * kPitch;  // [stage][K, V][BN][kPitch]

  const int group = Hq / Hkv;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = group * Sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pieces = Dh / 8;                 // pieces that hold data

  for (int e = tid; e < kBM * kPieces; e += kThreads) {
    const int r = e / kPieces;
    const int ch = e - r * kPieces;
    const int row = row0 + r;
    const bool ok = row < n_rows && ch < pieces;
    int64_t off = 0;
    if (ok) {
      const int h = hk * group + row % group;
      off = ((static_cast<int64_t>(b) * Hq + h) * Sq + row / group) * Dh +
            ch * 8;
    }
    flash::cp_async16(q_s + r * kPitch + ch * 8, q + off, ok);
  }

  // keys that some row of this block can see: [col_begin, col_end)
  const int last_row = min(row0 + kBM, n_rows) - 1;
  const int p_lo = row0 / group + q_offset;
  const int p_hi = last_row / group + q_offset;
  const int kv_lim = min(kv_len, Sk);
  int col_end = kv_lim;
  if (causal) col_end = min(col_end, p_hi + 1);
  const int col_begin = window > 0 ? max(0, p_lo - window + 1) : 0;
  const int n_tiles =
      col_end > col_begin ? (col_end - col_begin + BN - 1) / BN : 0;

  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * Sk * Dh;
  const __nv_bfloat16* k_bh = k + kv_base;
  const __nv_bfloat16* v_bh = v + kv_base;
  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* k_dst = kv_s + stage * 2 * BN * kPitch;
    __nv_bfloat16* v_dst = k_dst + BN * kPitch;
    const int c0 = col_begin + t * BN;
    for (int e = tid; e < BN * kPieces; e += kThreads) {
      const int j = e / kPieces;
      const int ch = e - j * kPieces;
      const bool ok = c0 + j < col_end && ch < pieces;
      const int64_t off = ok ? static_cast<int64_t>(c0 + j) * Dh + ch * 8 : 0;
      flash::cp_async16(k_dst + j * kPitch + ch * 8, k_bh + off, ok);
      flash::cp_async16(v_dst + j * kPitch + ch * 8, v_bh + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  flash::cp_async_commit();                  // group 0: Q and tile 0

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int w_row = warp * 16 * WM;          // the warp's first block row
  float m[kR], l[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
  }
  float o[WM][kOB][4];
#pragma unroll
  for (int w = 0; w < WM; ++w)
#pragma unroll
    for (int n = 0; n < kOB; ++n)
      o[w][n][0] = o[w][n][1] = o[w][n][2] = o[w][n][3] = 0.0f;
  uint32_t qf[kQRegs ? WM : 1][kQRegs ? DP / 16 : 1][4];
  // ldmatrix row addresses of this lane: A (Q), B (K) and B^T (V) tiles
  const __nv_bfloat16* q_lane =
      q_s + (w_row + (lane & 15)) * kPitch + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * kPitch +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                     (lane >> 4) * 8;
  // scores in log2 units: exp2(s * scale * log2(e) - m) = exp(s * scale - m')
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();               // Q and tile `it` have landed
    __syncthreads();
    const __nv_bfloat16* k_t = kv_s + stage * 2 * BN * kPitch;
    const __nv_bfloat16* v_t = k_t + BN * kPitch;
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int w = 0; w < WM; ++w)
#pragma unroll
          for (int ks = 0; ks < DP / 16; ++ks)
            ldmatrix_x4(qf[w][ks], q_lane + 16 * w * kPitch + ks * 16);
      }
    }

    float s[WM][kSB][4];
#pragma unroll
    for (int w = 0; w < WM; ++w)
#pragma unroll
      for (int n = 0; n < kSB; ++n)
        s[w][n][0] = s[w][n][1] = s[w][n][2] = s[w][n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t a[WM][4];
#pragma unroll
      for (int w = 0; w < WM; ++w) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[w][x] = qf[w][ks][x];
        } else {
          ldmatrix_x4(a[w], q_lane + 16 * w * kPitch + ks * 16);
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < kSB / 2; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_t + n2 * 16 * kPitch + k_lane + ks * 16);
#pragma unroll
        for (int w = 0; w < WM; ++w) {
          mma_bf16(s[w][2 * n2], a[w], kb[0], kb[1]);
          mma_bf16(s[w][2 * n2 + 1], a[w], kb[2], kb[3]);
        }
      }
    }

    // scale, mask, online softmax: thread row r is s[r / 2][.][2 (r % 2)
    // + {0, 1}]
    const int c0 = col_begin + it * BN;
    const bool masked = c0 + BN > kv_lim ||
                        (causal && c0 + BN - 1 > p_lo) ||
                        (window > 0 && c0 <= p_hi - window);
#pragma unroll
    for (int w = 0; w < WM; ++w) {
#pragma unroll
      for (int n = 0; n < kSB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[w][n][e] * scale_log2;
          if (masked) {
            const int c = c0 + n * 8 + 2 * t4 + (e & 1);
            const int pos =
                (row0 + w_row + 16 * w + g + 8 * (e / 2)) / group + q_offset;
            if (!flash::visible(c, pos, kv_lim, causal, window)) x = kNeg;
          }
          s[w][n][e] = x;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int w = r / 2;
      const int e0 = 2 * (r % 2);
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < kSB; ++n)
        mx = fmaxf(mx, fmaxf(s[w][n][e0], s[w][n][e0 + 1]));
      mx = quad_max(mx);
      // a row that has seen no key yet keeps mx = -1e30; subtracting 0
      // instead sends its masked scores, like every masked score, to
      // exp2(-1e30 - ...) = 0
      const float base = mx == kNeg ? 0.0f : mx;
      const float alpha = ex2(m[r] - base);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kSB; ++n) {
#pragma unroll
        for (int e = e0; e < e0 + 2; ++e) {
          const float p = ex2(s[w][n][e] - base);
          s[w][n][e] = p;
          sum += p;
        }
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kOB; ++n) {
        o[w][n][e0] *= alpha;
        o[w][n][e0 + 1] *= alpha;
      }
    }

    // O += P V: the S accumulators of key blocks 2kk, 2kk+1 are the A
    // fragment of keys 16kk..16kk+15, once rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[WM][4];
#pragma unroll
      for (int w = 0; w < WM; ++w) {
        a[w][0] = pack_bf16(s[w][2 * kk][0], s[w][2 * kk][1]);
        a[w][1] = pack_bf16(s[w][2 * kk][2], s[w][2 * kk][3]);
        a[w][2] = pack_bf16(s[w][2 * kk + 1][0], s[w][2 * kk + 1][1]);
        a[w][3] = pack_bf16(s[w][2 * kk + 1][2], s[w][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < kOB / 2; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_t + kk * 16 * kPitch + v_lane + n2 * 16);
#pragma unroll
        for (int w = 0; w < WM; ++w) {
          mma_bf16(o[w][2 * n2], a[w], vb[0], vb[1]);
          mma_bf16(o[w][2 * n2 + 1], a[w], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();                         // the stage may be refilled
  }
  flash::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int w = r / 2;
    const int half = r % 2;
    const int row = row0 + w_row + 16 * w + g + 8 * half;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= n_rows) continue;
    const int h = hk * group + row % group;
    __nv_bfloat16* dst =
        out + ((static_cast<int64_t>(b) * Hq + h) * Sq + row / group) * Dh;
#pragma unroll
    for (int n = 0; n < kOB; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < Dh)
        flash::store_pair(dst + d, o[w][n][2 * half] / den,
                          o[w][n][2 * half + 1] / den);
    }
  }
}

template <int DP, int BN, int WM>
void launch_tc(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Sq, int Sk, int Dh, float scale,
               int causal, int window, int kv_len, int q_offset,
               cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DP, BN>();
  cudaFuncSetAttribute(flash_tc_kernel<DP, BN, WM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int n_rows = (Hq / Hkv) * Sq;
  const dim3 grid((n_rows + kBM - 1) / kBM, Hkv, B);
  flash_tc_kernel<DP, BN, WM><<<grid, kBM / (16 * WM) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Sk, Dh, scale, causal,
      window, kv_len, q_offset);
}

}  // namespace

void launch_flash_attention_tc(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Sq,
                               int Sk, int Dh, float scale, int causal,
                               int window, int kv_len, int q_offset,
                               cudaStream_t stream) {
  if (Dh <= 64) {
    launch_tc<64, 64, 2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale, causal,
                         window, kv_len, q_offset, stream);
  } else if (Dh <= 128) {
    launch_tc<128, 64, 2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale,
                          causal, window, kv_len, q_offset, stream);
  } else {
    launch_tc<256, 32, 1>(q, k, v, out, B, Hq, Hkv, Sq, Sk, Dh, scale,
                          causal, window, kv_len, q_offset, stream);
  }
}

}  // namespace repro_torch
