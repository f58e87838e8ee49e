// Row tiles: the layout of the gather-aggregate kernels K1
// (cache_lookup.cu), K2 (gather_agg.cu) and K3 (gns_sample_agg.cu).
//
//   out[b, :] = sum_k w[b, k] * row(code[b, k])[:]     (k ascending, f32)
//
// where a lane's code names the row it reads: a row of one table for K2
// and K3 (OneTable), a row of the cache or of the streamed rows for K1
// (TwoTables).  They replace the TPU kernels repro/kernels/gather_agg.py::
// gather_agg_pallas, repro/sampling/kernels.py::slot_gather_agg_pallas and
// repro/kernels/cache_lookup.py::cache_lookup_agg_pallas, whose
// (B, D/block, K) grids keep one output tile in VMEM while the K rows
// stream in.  On an H100 the function moves bytes and does two flops per
// gathered element, so what bounds it is:
//   * at K1's and K3's training shape (B = 176,000, K = 5, D = 100), the
//     70.4 MB of output out of about 78 MB in all: 23 us at 3.35 TB/s, if
//     enough stores and loads are in flight to cover the memory's latency;
//   * at the serving shapes (K2: B = 128 to 8,192 rows of D = 256; K1:
//     22,528 or 90,112 rows of D = 100), the launch and the memory's
//     latency: a few hundred KB to 40 MB move in 0.5-12 us at 3.35 TB/s,
//     so every round trip a thread waits out shows.
//
// What the tile layout does about it.  A block owns a tile of `rows`
// consecutive destination rows, in two passes:
//   1. Lanes.  Every thread of the block resolves (row, lane) pairs of the
//      tile into shared memory, a code and a weight each: K2 copies its idx
//      and w in one coalesced pass; K1 follows idx to slots there; K3 runs
//      its draw there.  So all the tile's dependent-load chains are in
//      flight together.  One __syncthreads() follows.
//   2. Gather.  A thread owns units (tile row, column group): 4 columns on
//      the vector path, each row read as 16 bytes (f32) or 8 bytes (bf16)
//      and the sum stored as 16 bytes; one column on the scalar path.  It
//      reads the unit's lanes from shared memory and writes its row loads
//      kLoadChunk = 8 at a time ahead of their sums in ascending k; the
//      last K % 8 lanes go in one step of their exact size (a switch), so
//      no load or sum is issued for a lane that does not exist: K = 5
//      costs 5 loads, not 8 with 3 predicated off, and the compiler is
//      free to keep the kernels at 32 registers, 8 blocks of 256 threads
//      per SM (the predicated form took 60-66 registers and was 1.5x
//      slower on K3; K1 asks for 8 blocks in its launch bounds).  Units are numbered row-major, so neighbouring
//      threads read neighbouring words of a row and write neighbouring
//      16-byte words of the tile's contiguous output.
//
// Shared memory holds kLaneChunk = 32 lanes per row: K3 takes K <= 32 in
// one pass; K1 and K2 take any K, 32 lanes at a time (gather_lanes), the
// partial sum of a unit passing from one chunk to the next through its own
// output word (read back by the thread that wrote it, exactly, so the order
// of the sum stays ascending k).
//
// Tile size (tile::plan, called by each kernel's launcher with the
// kernel's units per block): rows = units-per-block / units-per-row,
// clamped to [1, kMaxTileRows]; threads = rows times the larger of units
// and lanes, rounded up to a warp, at most 256.  No shape of the port's
// paths needs a smaller tile to fill the card (K2 at D = 256 already takes
// one row per block; K1 and K3 launch 564 to 4,400 blocks).
//   * K2 takes 64 units per block, one per thread.  Its rows come from a
//     feature matrix in device memory, so each unit waits out a round
//     trip, and small blocks keep the most loads in flight: one row of
//     D = 256 per block, 64 threads (b=128 layer 2: 128 blocks; b=512
//     layer 1: 8,192).
//   * K1 and K3 take 1024, four per thread of a 256-thread block: 40 rows
//     at D = 100, 4,400 blocks at the training shape.  Their live rows
//     come mostly from the small cache table, which stays in L1, so a
//     thread's extra units cost little, and a large tile keeps its 200
//     lane chains in flight together; smaller tiles were slower in
//     scripts/tile_sweep.py, which passes its own tile sizes through the
//     launchers' tile_rows.
//
// Only some shapes take the vector path: D % 4 == 0 and every table
// 16-byte (f32) or 8-byte (bf16) aligned; the output is the wrapper's own,
// allocated aligned.  The wrapper picks the path (access_path,
// lookup_access_path); both paths are this kernel.
//
// Every lane is accumulated, dead and padded lanes included (K3's name row
// 0 with w = 0; K1's read the row the plain version reads; either stays in
// L1: instructions, not bytes), product and sum rounded separately
// (__fmul_rn, then __fadd_rn; no atomics, no split-K), so the kernels are
// bitwise their plain versions on any input.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "kernels.h"

namespace repro_torch {
namespace tile {

constexpr int kLaneChunk = 32;     // lanes per row in shared memory at once
constexpr int kLoadChunk = 8;      // row loads a thread keeps in flight
constexpr int kMaxThreads = 256;   // threads per block at most

// A launch: `rows` destination rows per block, `threads` per block.
struct Plan {
  int rows;
  int threads;
};

// The tile plan above for K lanes of D columns; `rows` > 0 takes that
// tile size instead of the rule's.
inline Plan plan(int K, int D, bool vec, int units_per_block, int rows) {
  int units = vec ? D / 4 : D;
  if (units < 1) units = 1;
  if (rows <= 0) {
    rows = units_per_block / units;
    rows = rows < 1 ? 1 : (rows > kMaxTileRows ? kMaxTileRows : rows);
  }
  const int lanes = K < kLaneChunk ? K : kLaneChunk;
  const int work = rows * (units > lanes ? units : lanes);
  const int threads = (work + 31) / 32 * 32;
  return {rows, threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                            : threads)};
}

// The tile's lanes in dynamic shared memory, row r's lane l at r * kn + l
// (kn lanes in this chunk): a code (which row the lane reads, as its row
// source reads it) and a weight, rows * min(K, 32) * 8 bytes, 16 KB at
// most, and only what the tile needs, so that the rest of the SM's 256 KB
// stays L1 for the gathered rows.
struct Lanes {
  int32_t* code;
  float* w;
};

__device__ __forceinline__ Lanes tile_lanes(int tile_rows, int lane_chunk) {
  extern __shared__ int32_t lanes_smem[];
  return {lanes_smem,
          reinterpret_cast<float*>(lanes_smem + tile_rows * lane_chunk)};
}

inline size_t lanes_bytes(int tile_rows, int K) {
  return static_cast<size_t>(tile_rows) * (K < kLaneChunk ? K : kLaneChunk) *
         (sizeof(int32_t) + sizeof(float));
}

__device__ __forceinline__ void axpy(float& acc, float w, float v) {
  acc = __fadd_rn(acc, __fmul_rn(w, v));
}

__device__ __forceinline__ float4 widen(float4 v) { return v; }

// Four bf16 -> four f32: a bf16 is the high half of its f32.
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Packed;                         // four elements of T in one access
template <>
struct Packed<float> { using type = float4; };
template <>
struct Packed<__nv_bfloat16> { using type = uint2; };

// The sum of one unit: four f32 columns (kVec) or one.
template <bool kVec>
struct Sum;

template <>
struct Sum<true> {
  using type = float4;
  __device__ static void add(float4& acc, float w, float4 v) {
    axpy(acc.x, w, v.x);
    axpy(acc.y, w, v.y);
    axpy(acc.z, w, v.z);
    axpy(acc.w, w, v.w);
  }
  __device__ static float4* at(float* out, int64_t b, int D, int c) {
    return reinterpret_cast<float4*>(out + b * D) + c;
  }
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

template <>
struct Sum<false> {
  using type = float;
  __device__ static void add(float& acc, float w, float v) {
    axpy(acc, w, v);
  }
  __device__ static float* at(float* out, int64_t b, int D, int c) {
    return out + b * D + c;
  }
  __device__ static float zero() { return 0.f; }
};

// Unit c of row `row` of a [*, D] table of T, as one access reads it.
template <typename T, bool kVec>
struct Unit;

template <typename T>
struct Unit<T, true> {
  using Raw = typename Packed<T>::type;
  __device__ static Raw load(const T* __restrict__ table, int32_t row,
                             int D, int c) {
    return __ldg(reinterpret_cast<const Raw*>(
                     table + static_cast<int64_t>(row) * D) + c);
  }
};

template <typename T>
struct Unit<T, false> {
  using Raw = T;
  __device__ static Raw load(const T* __restrict__ table, int32_t row,
                             int D, int c) {
    return table[static_cast<int64_t>(row) * D + c];
  }
};

// Row sources.  A source maps a lane's code to the row it reads: load()
// issues the read of unit c, value() turns what came back into f32 once it
// is summed (given the code again), and kChunk is how many loads a thread
// writes ahead of their sums.

// K2's and K3's: one table of T; the code is the row.
template <typename T, bool kVec>
struct OneTable {
  static constexpr bool kVector = kVec;
  static constexpr int kChunk = kLoadChunk;
  using Raw = typename Unit<T, kVec>::Raw;
  const T* table;
  __device__ Raw load(int32_t code, int D, int c) const {
    return Unit<T, kVec>::load(table, code, D, c);
  }
  __device__ static typename Sum<kVec>::type value(int32_t, Raw raw) {
    return widen(raw);
  }
};

// K1's: code >= 0 is row `code` of the cache (T), code < 0 is row ~code of
// the streamed rows (f32), as the lane pass resolves slots[idx].
template <typename T, bool kVec>
struct TwoTables;

// An f32 cache: both tables have one width, so the lane's base pointer and
// row are selects and every load issues without a branch.
template <bool kVec>
struct TwoTables<float, kVec> {
  static constexpr bool kVector = kVec;
  static constexpr int kChunk = kLoadChunk;
  using Raw = typename Unit<float, kVec>::Raw;
  const float* cache;
  const float* streamed;
  __device__ Raw load(int32_t code, int D, int c) const {
    const bool hit = code >= 0;
    return Unit<float, kVec>::load(hit ? cache : streamed,
                                   hit ? code : ~code, D, c);
  }
  __device__ static typename Sum<kVec>::type value(int32_t, Raw raw) {
    return raw;
  }
};

// A bf16 cache beside f32 streamed rows: the two reads differ in width.
// Both land in the same raw registers (a hit's 8 bytes in the first two
// words of the 16, a scalar hit's 16 bits in the low half of the word), so
// a slot costs the registers of the wider read, not of both; value()
// widens by the code.
template <>
struct TwoTables<__nv_bfloat16, true> {
  static constexpr bool kVector = true;
  static constexpr int kChunk = kLoadChunk;
  using Raw = uint4;
  const __nv_bfloat16* cache;
  const float* streamed;
  __device__ Raw load(int32_t code, int D, int c) const {
    if (code >= 0) {
      const uint2 h = Unit<__nv_bfloat16, true>::load(cache, code, D, c);
      return make_uint4(h.x, h.y, 0u, 0u);
    }
    const float4 f = Unit<float, true>::load(streamed, ~code, D, c);
    return make_uint4(__float_as_uint(f.x), __float_as_uint(f.y),
                      __float_as_uint(f.z), __float_as_uint(f.w));
  }
  __device__ static float4 value(int32_t code, Raw raw) {
    if (code >= 0) return widen(make_uint2(raw.x, raw.y));
    return make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                       __uint_as_float(raw.z), __uint_as_float(raw.w));
  }
};

template <>
struct TwoTables<__nv_bfloat16, false> {
  static constexpr bool kVector = false;
  static constexpr int kChunk = kLoadChunk;
  using Raw = uint32_t;
  const __nv_bfloat16* cache;
  const float* streamed;
  __device__ Raw load(int32_t code, int D, int c) const {
    if (code >= 0) {
      return __ldg(reinterpret_cast<const unsigned short*>(cache) +
                   static_cast<int64_t>(code) * D + c);
    }
    return __float_as_uint(Unit<float, false>::load(streamed, ~code, D, c));
  }
  __device__ static float value(int32_t code, Raw raw) {
    return __uint_as_float(code >= 0 ? raw << 16 : raw);
  }
};

// acc += lane_w[j] * row(lane_code[j]), unit c, for j = 0..N-1 in order,
// the N loads written before the first sum.  Nothing for N > the source's
// kChunk: the remainder switch below names every N < kLoadChunk, and a
// source with a smaller kChunk never reaches the larger ones.
template <int N, typename Src>
__device__ __forceinline__ void sum_lanes(
    typename Sum<Src::kVector>::type& acc, const Src& src,
    const int32_t* lane_code, const float* lane_w, int D, int c) {
  if constexpr (N <= Src::kChunk) {
    typename Src::Raw v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = src.load(lane_code[j], D, c);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Sum<Src::kVector>::add(acc, lane_w[j], Src::value(lane_code[j], v[j]));
    }
  }
}

// Pass 2 over the tile's first `rows` rows (rows b0 ...), lanes 0..kn-1 of
// the chunk in `s`.  `first`: the chunk holds lane 0, so each sum starts at
// 0; otherwise it starts from the unit's output word, which this thread
// wrote in the previous chunk.  The lanes go kChunk at a time, then the
// remainder in one step of its exact size (a switch), so a thread issues
// exactly kn loads and kn sums: no predicated-off slots, and registers for
// kChunk loads at most.
template <typename Src>
__device__ __forceinline__ void gather_tile(const Src& src, const Lanes& s,
                                            int kn, bool first,
                                            float* __restrict__ out,
                                            int64_t b0, int rows, int D) {
  constexpr bool kVec = Src::kVector;
  constexpr int kChunk = Src::kChunk;
  using S = Sum<kVec>;
  const int units = kVec ? D / 4 : D;
  const int n = rows * units;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / units;
    const int c = i - r * units;
    const int32_t* lane_code = s.code + r * kn;
    const float* lane_w = s.w + r * kn;
    typename S::type* dst = S::at(out, b0 + r, D, c);
    typename S::type acc = first ? S::zero() : *dst;
    int k0 = 0;
    for (; k0 + kChunk <= kn; k0 += kChunk) {
      sum_lanes<kChunk>(acc, src, lane_code + k0, lane_w + k0, D, c);
    }
    const int32_t* cc = lane_code + k0;
    const float* ww = lane_w + k0;
    switch (kn - k0) {
      case 7: sum_lanes<7>(acc, src, cc, ww, D, c); break;
      case 6: sum_lanes<6>(acc, src, cc, ww, D, c); break;
      case 5: sum_lanes<5>(acc, src, cc, ww, D, c); break;
      case 4: sum_lanes<4>(acc, src, cc, ww, D, c); break;
      case 3: sum_lanes<3>(acc, src, cc, ww, D, c); break;
      case 2: sum_lanes<2>(acc, src, cc, ww, D, c); break;
      case 1: sum_lanes<1>(acc, src, cc, ww, D, c); break;
      default: break;
    }
    *dst = acc;
  }
}

// Both passes for any K, kLaneChunk lanes of each row at a time (once for
// K <= 32, and for K = 0, which writes zeros): resolve(g, code, w) sets
// the code and weight of the lane at flat index g = b * K + l of the
// [B, K] lane arrays.
template <typename Src, typename Resolve>
__device__ __forceinline__ void gather_lanes(const Src& src,
                                             const Resolve& resolve,
                                             const Lanes& s, int K,
                                             float* __restrict__ out,
                                             int64_t b0, int rows, int D) {
  int l0 = 0;
  do {
    const int kn = min(kLaneChunk, K - l0);
    if (l0 > 0) __syncthreads();     // the last chunk's gather is done
    for (int t = threadIdx.x; t < rows * kn; t += blockDim.x) {
      const int r = t / kn;
      resolve((b0 + r) * K + l0 + (t - r * kn), s.code[t], s.w[t]);
    }
    __syncthreads();
    gather_tile(src, s, kn, l0 == 0, out, b0, rows, D);
    l0 += kLaneChunk;
  } while (l0 < K);
}

// The tile's rows: b0 and how many of its `tile_rows` lie below B.
__device__ __forceinline__ int64_t tile_start(int tile_rows) {
  return static_cast<int64_t>(blockIdx.x) * tile_rows;
}
__device__ __forceinline__ int tile_len(int64_t b0, int tile_rows,
                                        int64_t B) {
  return static_cast<int>(B - b0 < tile_rows ? B - b0 : tile_rows);
}

inline dim3 tile_grid(int64_t B, int tile_rows) {
  return dim3(static_cast<unsigned>((B + tile_rows - 1) / tile_rows));
}

}  // namespace tile
}  // namespace repro_torch
