// K4, route (i): split-KV attention for few query rows (decode).
//
//   out[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / G, j, :])
//                     @ v[b, h / G, :, :]          over the visible keys j
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas for calls whose rows per (batch, kv head), G * Sq,
// are at most 16: every served K4 call is one (single-token
// cross-attention, Sq = 1).  Semantics are the Pallas kernel's: query row i
// sits at position i + q_offset; key j is visible when j < kv_len, and
// j <= position when causal, and j > position - window when a window is
// set; masked scores are -1e30, never -inf; statistics in f32; a row that
// sees no key is 0; one cast to q's type at the end.
//
// What bounds it on an H100: HBM bytes.  At the serve shape (B=4, 16 heads,
// 1 query, 1024 keys, Dh=64, bf16) the call must read 16.8 MB of K and V,
// 5.0 us at 3.35 TB/s, against 8.4 MFLOP of arithmetic.  A kernel with one
// block per (batch, kv head) has 64 blocks for 132 SMs and leaves the
// memory system mostly idle, so the design spreads the keys over the card:
//
// Pass 1, grid (splits, Hkv, B).  The wrapper cuts the keys some row can
// see, [col_begin, col_end), into `splits` contiguous chunks (a multiple of
// 32 keys, at most 80 KB of K and V), about two blocks per SM: 4 chunks of
// 256 keys, 256 blocks of 8 warps, at the serve shape (on the H100, blocks
// of 8 warps finished sooner than twice as many of 4, and two of them per
// SM hide more of each warp's serial work than one).  The 8 warps
// split the chunk's 32-key tiles (`ways` warps per group of up to 4 rows;
// with up to 4 rows every warp takes every 8th tile).  The warps that share
// a tile copy it into shared memory together, as 16-byte cp.async copies
// all in flight at once, K and V of each tile in their own groups, in
// order (rows padded to 16 bytes past a multiple of 128, so lane j's
// 16-byte reads of key row j fall on distinct banks), and wait only for
// each other: a warp scores a tile as soon as its K has landed, while the
// rest is still in flight.  Each warp runs the Pallas kernel's online
// softmax in f32 for its rows: lane j scores key j (q cast to f32 and
// scaled, as the Pallas kernel does before its dot); m_new = max(m, tile
// max); p = exp(s - m_new), 0 where masked; alpha = exp(m - m_new);
// l = l * alpha + sum p; acc = acc * alpha + p @ v, with acc[Dh] spread
// over the lanes two columns at a time.  The warps that share rows merge
// their (m, l, acc) through shared memory by the rule of pass 2, and the
// block writes one partial (m, l, acc[Dh]) per row to f32 scratch.  A
// split that sees no key of a row writes m = -1e30, l = 0, acc = 0 for it.
//
// Pass 2, launched as a programmatic dependent launch (its launch overlaps
// pass 1, which triggers it once its copies are issued; griddepcontrol.wait
// holds it until pass 1's results are visible), one warp per output row:
// out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with w_s = exp(m_s -
// max_s m_s), computed as a running merge over the splits, cast once.  A
// split that saw no key enters with weight 0 (or, when no split saw a key,
// l = 0 and acc = 0: the row is 0), so no NaN.  expf and IEEE division
// throughout; no fast math.  The wrapper allocates
// the scratch; the kernels allocate nothing.
#include "flash_common.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

using flash::kFull;
using flash::kNeg;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kTile = kWarp;                 // keys per warp tile
constexpr int kCombineWarps = 4;             // output rows per block

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

// 16 bytes of a key row in shared memory, as f32.
__device__ __forceinline__ void load16_f32(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row pitch of the K/V chunk in shared memory, in elements: the row's bytes
// rounded up to 128, plus 16.
template <typename T>
__host__ __device__ inline int kv_pitch(int dh) {
  const int bytes = (dh * static_cast<int>(sizeof(T)) + 127) / 128 * 128;
  return (bytes + 16) / static_cast<int>(sizeof(T));
}

// RPW: rows per warp (1, 2 or 4); NP: column pairs per lane, ceil(Dh / 64)
// rounded up to 1, 2 or 4.
template <typename T, int RPW, int NP>
__global__ void __launch_bounds__(kThreads)
split_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int Hq, int Hkv, int Sq,
                     int Sk, int Dh, float scale, int causal, int window,
                     int kv_len, int q_offset, int col_begin, int col_end,
                     int chunk, int ways) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = kv_pitch<T>(Dh);
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + chunk * pitch;
  float* q_s = reinterpret_cast<float*>(v_s + chunk * pitch);

  const int group = Hq / Hkv;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = group * Sq;
  const int ng = kWarps / ways;              // groups of rows
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;

  const int grp = warp % ng;                 // this warp's group of rows
  const int kw = warp / ng;                  // and its share of the tiles

  // this warp's rows of q, requested before the K/V copies so that they do
  // not queue behind them: element e = lane + 32 i of rows r_first..
  const int r_first = grp * RPW;
  T q_reg[RPW * 8];                          // RPW * Dh / 32 <= RPW * 8
#pragma unroll
  for (int i = 0; i < RPW * 8; ++i) {
    const int e = lane + kWarp * i;
    const int r = r_first + e / Dh;
    q_reg[i] = T{};
    if (e < RPW * Dh && r < n_rows) {
      const int h = hk * group + r % group;
      q_reg[i] = q[((static_cast<int64_t>(b) * Hq + h) * Sq + r / group) * Dh +
                   e % Dh];
    }
  }

  // this block's keys, [c_lo, c_hi); the last tile's rows past c_hi are
  // zero-filled.  The ng warps that share tiles t = kw, kw + ways, ...
  // copy them together and wait only for each other (a named barrier).
  const int c_lo = col_begin + split * chunk;
  const int c_hi = min(c_lo + chunk, col_end);
  const int n_tiles = c_hi > c_lo ? (c_hi - c_lo + kTile - 1) / kTile : 0;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + hk) * Sk * Dh;
  const int pieces = Dh / kVec;              // 16-byte pieces per row, <= 64
  const int set_threads = ng * kWarp;
  const int set_tid = grp * kWarp + lane;
  // piece e = set_tid + i * set_threads of a tile is (row e / pieces, piece
  // e % pieces), stepped without a division per copy.  Each of the set's
  // tiles goes in two groups, K then V, in order: the warp starts on a
  // tile's scores once its K has landed, while the rest is in flight.
  const int j_step = set_threads / pieces, ch_step = set_threads % pieces;
  int n_mine = 0;                            // this warp's tiles
  for (int t = kw; t < n_tiles; t += ways, ++n_mine) {
    for (int kv = 0; kv < 2; ++kv) {
      const T* src = kv ? v : k;
      T* dst = kv ? v_s : k_s;
      int j = set_tid / pieces, ch = set_tid % pieces;
      while (j < kTile) {
        const int row = t * kTile + j;
        const bool ok = c_lo + row < c_hi;
        const int64_t off = kv_base +
            (ok ? static_cast<int64_t>(c_lo + row) * Dh + ch * kVec : 0);
        flash::cp_async16(dst + row * pitch + ch * kVec, src + off, ok);
        j += j_step;
        ch += ch_step;
        if (ch >= pieces) {
          ch -= pieces;
          ++j;
        }
      }
      flash::cp_async_commit();
    }
  }
  // the combine may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // q cast to f32 and scaled, in this warp's own slice of shared memory
  float* q_w = q_s + warp * RPW * Dh;
#pragma unroll
  for (int i = 0; i < RPW * 8; ++i) {
    const int e = lane + kWarp * i;
    if (e < RPW * Dh) q_w[e] = to_f32(q_reg[i]) * scale;
  }
  // the warps that share this warp's tiles (and copied them with it)
  auto set_sync = [&]() {
    if (ng == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kw), "r"(set_threads)
                   : "memory");
    }
  };
  // wait until at most `pending` of this thread's groups are in flight,
  // then for the set's other threads
  auto landed = [&](int pending) {
    switch (pending) {
      case 0: flash::cp_async_wait<0>(); break;
      case 1: flash::cp_async_wait<1>(); break;
      case 2: flash::cp_async_wait<2>(); break;
      case 3: flash::cp_async_wait<3>(); break;
      case 4: flash::cp_async_wait<4>(); break;
      case 5: flash::cp_async_wait<5>(); break;
      case 6: flash::cp_async_wait<6>(); break;
      default: flash::cp_async_wait<7>(); break;   // waits for more: safe
    }
    set_sync();
  };

  const int kv_lim = min(kv_len, Sk);
  int pos[RPW];
  float m[RPW], l[RPW], acc[RPW][NP][2];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    pos[rr] = (r_first + rr) / group + q_offset;
    m[rr] = kNeg;
    l[rr] = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[rr][i][0] = acc[rr][i][1] = 0.0f;
  }

  for (int t = kw, i_mine = 0; t < n_tiles; t += ways, ++i_mine) {
    landed(2 * (n_mine - i_mine) - 1);       // K of tile t
    const int j = t * kTile + lane;          // lane j scores key c_lo + j
    const int c = c_lo + j;
    const T* k_row = k_s + j * pitch;
    float s[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr] = 0.0f;
    for (int d = 0; d < Dh; d += kVec) {
      float kx[kVec];
      load16_f32(k_row + d, kx);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4* qv = reinterpret_cast<const float4*>(q_w + rr * Dh + d);
#pragma unroll
        for (int u = 0; u < kVec / 4; ++u) {
          const float4 qq = qv[u];           // one broadcast read
          s[rr] += qq.x * kx[4 * u];
          s[rr] += qq.y * kx[4 * u + 1];
          s[rr] += qq.z * kx[4 * u + 2];
          s[rr] += qq.w * kx[4 * u + 3];
        }
      }
    }

    float p[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const bool vis =
          c < c_hi && flash::visible(c, pos[rr], kv_lim, causal, window);
      const float sc = vis ? s[rr] : kNeg;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      p[rr] = vis ? expf(sc - m_new) : 0.0f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        acc[rr][i][0] *= alpha;
        acc[rr][i][1] *= alpha;
      }
    }
    landed(2 * (n_mine - i_mine) - 2);       // V of tile t
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      const T* v_row = v_s + (t * kTile + jj) * pitch;
      float2 vv[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 2 * lane + 2 * kWarp * i;
        vv[i] = d < Dh ? load_pair(v_row + d) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float pj = __shfl_sync(kFull, p[rr], jj);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[rr][i][0] += pj * vv[i].x;
          acc[rr][i][1] += pj * vv[i].y;
        }
      }
    }
  }

  // merge the `ways` warps that share a group of rows through shared
  // memory (the chunk is consumed): [ways][ng * RPW][Dh + 2]
  flash::cp_async_wait<0>();                 // (a warp with no tile)
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(smem_raw);
  const int stride = Dh + 2;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    float* slot = mrg + (kw * ng * RPW + r_first + rr) * stride;
    if (lane == 0) {
      slot[Dh] = m[rr];
      slot[Dh + 1] = l[rr];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = 2 * lane + 2 * kWarp * i;
      if (d < Dh) {
        slot[d] = acc[rr][i][0];
        slot[d + 1] = acc[rr][i][1];
      }
    }
  }
  __syncthreads();
  if (kw != 0) return;

  // this split's partial of each row: scratch [B, Hkv, splits, n_rows, .]
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = r_first + rr;
    if (r >= n_rows) break;
    float mx = kNeg;
#pragma unroll 8
    for (int w = 0; w < ways; ++w)
      mx = fmaxf(mx, mrg[(w * ng * RPW + r) * stride + Dh]);
    float lsum = 0.0f, out[NP][2];
#pragma unroll
    for (int i = 0; i < NP; ++i) out[i][0] = out[i][1] = 0.0f;
#pragma unroll 8
    for (int w = 0; w < ways; ++w) {
      const float* src = mrg + (w * ng * RPW + r) * stride;
      const float e = expf(src[Dh] - mx);
      lsum += e * src[Dh + 1];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int d = 2 * lane + 2 * kWarp * i;
        if (d < Dh) {
          out[i][0] += e * src[d];
          out[i][1] += e * src[d + 1];
        }
      }
    }
    const int64_t slot =
        ((static_cast<int64_t>(b) * Hkv + hk) * gridDim.x + split) * n_rows +
        r;
    if (lane == 0) {
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = lsum;
    }
    float* dst = part_acc + slot * Dh;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = 2 * lane + 2 * kWarp * i;
      if (d < Dh) flash::store_pair(dst + d, out[i][0], out[i][1]);
    }
  }
}

// One warp per output row; NP column pairs per lane as in pass 1.
template <typename T, int NP>
__global__ void __launch_bounds__(kCombineWarps * kWarp)
split_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     int Hq, int Hkv, int Sq, int Dh, int n_part) {
  const int group = Hq / Hkv;
  const int n_rows = group * Sq;
  const int r = blockIdx.x * kCombineWarps + threadIdx.x / kWarp;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % kWarp;
  // launched early (programmatic dependent launch): wait for pass 1
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (r >= n_rows) return;
  // partial s of this row sits at slot0 + s * n_rows
  const int64_t slot0 =
      (static_cast<int64_t>(b) * Hkv + hk) * n_part * n_rows + r;

  // a running merge, partial by partial (the loads of several partials in
  // flight at once): M' = max(M, m_s); acc = acc exp(M - M') + acc_s
  // exp(m_s - M'); the same for l
  float mx = kNeg, lsum = 0.0f, acc[NP][2];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll 8
  for (int s = 0; s < n_part; ++s) {
    const int64_t slot = slot0 + static_cast<int64_t>(s) * n_rows;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * slot);
    float2 a[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int d = 2 * lane + 2 * kWarp * i;
      a[i] = d < Dh ? *reinterpret_cast<const float2*>(part_acc + slot * Dh +
                                                       d)
                    : make_float2(0.0f, 0.0f);
    }
    const float m_new = fmaxf(mx, ml.x);
    const float keep = expf(mx - m_new);
    const float w = expf(ml.x - m_new);
    lsum = lsum * keep + w * ml.y;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      acc[i][0] = acc[i][0] * keep + w * a[i].x;
      acc[i][1] = acc[i][1] * keep + w * a[i].y;
    }
    mx = m_new;
  }
  const float denom = fmaxf(lsum, 1e-30f);

  const int h = hk * group + r % group;
  T* o = out + ((static_cast<int64_t>(b) * Hq + h) * Sq + r / group) * Dh;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int d = 2 * lane + 2 * kWarp * i;
    if (d < Dh) flash::store_pair(o + d, acc[i][0] / denom,
                                  acc[i][1] / denom);
  }
}

template <typename T, int RPW, int NP>
void launch_partial(const void* q, const void* k, const void* v,
                    float* part_acc, float* part_ml, int B, int Hq, int Hkv,
                    int Sq, int Sk, int Dh, float scale, int causal,
                    int window, int kv_len, int q_offset, int col_begin,
                    int col_end, int chunk, int splits, int ways,
                    cudaStream_t stream) {
  const size_t smem =
      2 * static_cast<size_t>(chunk) * kv_pitch<T>(Dh) * sizeof(T) +
      sizeof(float) * static_cast<size_t>(kWarps) * RPW * Dh;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(split_partial_kernel<T, RPW, NP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 grid(splits, Hkv, B);
  split_partial_kernel<T, RPW, NP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_acc, part_ml, Hq, Hkv, Sq, Sk, Dh,
      scale, causal, window, kv_len, q_offset, col_begin, col_end, chunk,
      ways);
}

template <typename T, int RPW>
void launch_partial_np(const void* q, const void* k, const void* v,
                       float* part_acc, float* part_ml, int B, int Hq,
                       int Hkv, int Sq, int Sk, int Dh, float scale,
                       int causal, int window, int kv_len, int q_offset,
                       int col_begin, int col_end, int chunk, int splits,
                       int ways, cudaStream_t stream) {
  if (Dh <= 2 * kWarp) {
    launch_partial<T, RPW, 1>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                              Dh, scale, causal, window, kv_len, q_offset,
                              col_begin, col_end, chunk, splits, ways,
                              stream);
  } else if (Dh <= 4 * kWarp) {
    launch_partial<T, RPW, 2>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                              Dh, scale, causal, window, kv_len, q_offset,
                              col_begin, col_end, chunk, splits, ways,
                              stream);
  } else {
    launch_partial<T, RPW, 4>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                              Dh, scale, causal, window, kv_len, q_offset,
                              col_begin, col_end, chunk, splits, ways,
                              stream);
  }
}

template <typename T>
void launch_partial_rpw(const void* q, const void* k, const void* v,
                        float* part_acc, float* part_ml, int B, int Hq,
                        int Hkv, int Sq, int Sk, int Dh, float scale,
                        int causal, int window, int kv_len, int q_offset,
                        int col_begin, int col_end, int chunk, int splits,
                        int ways, cudaStream_t stream) {
  const int n_rows = (Hq / Hkv) * Sq;
  const int ng = kWarps / ways;
  const int rpw = (n_rows + ng - 1) / ng;    // the wrapper keeps it <= 4
  if (rpw <= 1) {
    launch_partial_np<T, 1>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                            Dh, scale, causal, window, kv_len, q_offset,
                            col_begin, col_end, chunk, splits, ways, stream);
  } else if (rpw <= 2) {
    launch_partial_np<T, 2>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                            Dh, scale, causal, window, kv_len, q_offset,
                            col_begin, col_end, chunk, splits, ways, stream);
  } else {
    launch_partial_np<T, 4>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                            Dh, scale, causal, window, kv_len, q_offset,
                            col_begin, col_end, chunk, splits, ways, stream);
  }
}

template <typename T, int NP>
void launch_combine(const float* part_acc, const float* part_ml, void* out,
                    int B, int Hq, int Hkv, int Sq, int Dh, int n_part,
                    cudaStream_t stream) {
  const int n_rows = (Hq / Hkv) * Sq;
  // programmatic dependent launch (Hopper): the combine's launch overlaps
  // the end of pass 1, and its griddepcontrol.wait keeps the order
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows + kCombineWarps - 1) / kCombineWarps, Hkv, B);
  cfg.blockDim = dim3(kCombineWarps * kWarp);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, split_combine_kernel<T, NP>, part_acc, part_ml,
                     static_cast<T*>(out), Hq, Hkv, Sq, Dh, n_part);
}

template <typename T>
void launch_combine_np(const float* part_acc, const float* part_ml,
                       void* out, int B, int Hq, int Hkv, int Sq, int Dh,
                       int n_part, cudaStream_t stream) {
  if (Dh <= 2 * kWarp) {
    launch_combine<T, 1>(part_acc, part_ml, out, B, Hq, Hkv, Sq, Dh, n_part,
                         stream);
  } else if (Dh <= 4 * kWarp) {
    launch_combine<T, 2>(part_acc, part_ml, out, B, Hq, Hkv, Sq, Dh, n_part,
                         stream);
  } else {
    launch_combine<T, 4>(part_acc, part_ml, out, B, Hq, Hkv, Sq, Dh, n_part,
                         stream);
  }
}

}  // namespace

void launch_flash_split_partial(const void* q, const void* k, const void* v,
                                float* part_acc, float* part_ml, int bf16,
                                int B, int Hq, int Hkv, int Sq, int Sk,
                                int Dh, float scale, int causal, int window,
                                int kv_len, int q_offset, int col_begin,
                                int col_end, int chunk, int splits, int ways,
                                cudaStream_t stream) {
  if (bf16) {
    launch_partial_rpw<__nv_bfloat16>(
        q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk, Dh, scale, causal,
        window, kv_len, q_offset, col_begin, col_end, chunk, splits, ways,
        stream);
  } else {
    launch_partial_rpw<float>(q, k, v, part_acc, part_ml, B, Hq, Hkv, Sq, Sk,
                              Dh, scale, causal, window, kv_len, q_offset,
                              col_begin, col_end, chunk, splits, ways,
                              stream);
  }
}

void launch_flash_split_combine(const float* part_acc, const float* part_ml,
                                void* out, int bf16, int B, int Hq, int Hkv,
                                int Sq, int Dh, int n_part,
                                cudaStream_t stream) {
  if (bf16) {
    launch_combine_np<__nv_bfloat16>(part_acc, part_ml, out, B, Hq, Hkv, Sq,
                                     Dh, n_part, stream);
  } else {
    launch_combine_np<float>(part_acc, part_ml, out, B, Hq, Hkv, Sq, Dh,
                             n_part, stream);
  }
}

}  // namespace repro_torch
