// Python bindings of the port's CUDA kernels.  The only source that includes
// torch/extension.h; the Python wrappers in repro_torch/kernels/ check
// device, type, shape and contiguity and allocate the outputs before they
// call in here.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

// The access path the Python wrapper chose for one table
// (repro_torch/kernels/gather_agg.py::access_path; K1 checks both of its
// tables) and a tile size given in place of the kernel's own plan (0),
// checked here because a wrong one would fault on the device.
void check_tiles(const torch::Tensor& table, const torch::Tensor& out,
                 bool vec, int64_t tile_rows) {
  TORCH_CHECK(tile_rows >= 0 && tile_rows <= repro_torch::kMaxTileRows,
              "tile_rows ", tile_rows, " not in [0, ",
              repro_torch::kMaxTileRows, "]");
  if (vec) {
    const auto align = static_cast<uintptr_t>(4 * table.element_size());
    TORCH_CHECK(table.size(1) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table.data_ptr()) % align ==
                        0 &&
                    reinterpret_cast<uintptr_t>(out.data_ptr()) % 16 == 0,
                "the vector path needs D % 4 == 0 and aligned rows");
  }
}

void gather_agg(const torch::Tensor& feat, const torch::Tensor& idx,
                const torch::Tensor& w, torch::Tensor out, bool vec,
                int64_t tile_rows) {
  check_tiles(feat, out, vec, tile_rows);
  const c10::cuda::CUDAGuard guard(feat.device());
  repro_torch::launch_gather_agg(
      feat.data_ptr(), feat.scalar_type() == at::kBFloat16,
      idx.data_ptr<int32_t>(), w.data_ptr<float>(), out.data_ptr<float>(),
      idx.size(0), static_cast<int>(idx.size(1)),
      static_cast<int>(feat.size(1)), vec, static_cast<int>(tile_rows),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void cache_lookup_agg(const torch::Tensor& cache,
                      const torch::Tensor& streamed,
                      const torch::Tensor& slots, const torch::Tensor& idx,
                      const torch::Tensor& w, torch::Tensor out, bool vec,
                      int64_t tile_rows) {
  check_tiles(cache, out, vec, tile_rows);
  check_tiles(streamed, out, vec, tile_rows);
  const c10::cuda::CUDAGuard guard(cache.device());
  repro_torch::launch_cache_lookup_agg(
      cache.data_ptr(), cache.scalar_type() == at::kBFloat16,
      streamed.data_ptr<float>(), slots.data_ptr<int32_t>(),
      idx.data_ptr<int32_t>(), w.data_ptr<float>(), out.data_ptr<float>(),
      idx.size(0), static_cast<int>(idx.size(1)),
      static_cast<int>(cache.size(1)), vec, static_cast<int>(tile_rows),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void gns_sample_agg(const torch::Tensor& indptr, const torch::Tensor& indices,
                    const torch::Tensor& deg, const torch::Tensor& hitp,
                    const torch::Tensor& table, const torch::Tensor& dst_rows,
                    const torch::Tensor& fb_rows, const torch::Tensor& fb_w,
                    int64_t key_lo, int64_t key_hi, torch::Tensor out,
                    torch::Tensor lane_rows, torch::Tensor lane_w,
                    bool write_lanes, int64_t row_lo, int64_t row_count,
                    bool vec, int64_t tile_rows) {
  check_tiles(table, out, vec, tile_rows);
  TORCH_CHECK(fb_rows.size(1) <= 32, "K3 takes at most 32 lanes");
  TORCH_CHECK(row_lo >= 0 && row_count == table.size(0) &&
                  row_lo + row_count <= deg.size(0),
              "K3's row range [", row_lo, ", ", row_lo + row_count,
              ") must be the table's rows within the CSR's ", deg.size(0));
  const c10::cuda::CUDAGuard guard(table.device());
  repro_torch::launch_gns_sample_agg(
      indptr.data_ptr<int32_t>(), indices.data_ptr<int32_t>(),
      indices.size(0), deg.data_ptr<float>(), hitp.data_ptr<float>(),
      table.data_ptr(), table.scalar_type() == at::kBFloat16,
      dst_rows.data_ptr<int32_t>(), fb_rows.data_ptr<int32_t>(),
      fb_w.data_ptr<float>(), static_cast<uint32_t>(key_lo),
      static_cast<uint32_t>(key_hi), out.data_ptr<float>(),
      write_lanes ? lane_rows.data_ptr<int32_t>() : nullptr,
      write_lanes ? lane_w.data_ptr<float>() : nullptr,
      static_cast<int32_t>(row_lo), static_cast<int32_t>(row_count),
      dst_rows.size(0), static_cast<int>(fb_rows.size(1)),
      static_cast<int>(table.size(1)),
      vec, static_cast<int>(tile_rows), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, torch::Tensor out, double scale,
                     bool causal, int64_t window, int64_t kv_len,
                     int64_t q_offset) {
  const c10::cuda::CUDAGuard guard(q.device());
  repro_torch::launch_flash_attention(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      q.scalar_type() == at::kBFloat16, static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(k.size(2)),
      static_cast<int>(q.size(3)), static_cast<float>(scale), causal,
      static_cast<int>(window), static_cast<int>(kv_len),
      static_cast<int>(q_offset), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_attention_split(const torch::Tensor& q, const torch::Tensor& k,
                           const torch::Tensor& v, torch::Tensor out,
                           torch::Tensor part_acc, torch::Tensor part_ml,
                           double scale, bool causal, int64_t window,
                           int64_t kv_len, int64_t q_offset,
                           int64_t col_begin, int64_t col_end, int64_t chunk,
                           int64_t splits, int64_t ways) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int bf16 = q.scalar_type() == at::kBFloat16;
  const auto stream = at::cuda::getCurrentCUDAStream();
  repro_torch::launch_flash_split_partial(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), part_acc.data_ptr<float>(),
      part_ml.data_ptr<float>(), bf16, static_cast<int>(q.size(0)),
      static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(k.size(2)),
      static_cast<int>(q.size(3)), static_cast<float>(scale), causal,
      static_cast<int>(window), static_cast<int>(kv_len),
      static_cast<int>(q_offset), static_cast<int>(col_begin),
      static_cast<int>(col_end), static_cast<int>(chunk),
      static_cast<int>(splits), static_cast<int>(ways), stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  repro_torch::launch_flash_split_combine(
      part_acc.data_ptr<float>(), part_ml.data_ptr<float>(), out.data_ptr(),
      bf16, static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)),
      static_cast<int>(q.size(3)), static_cast<int>(part_ml.size(2)),
      stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_attention_tc(const torch::Tensor& q, const torch::Tensor& k,
                        const torch::Tensor& v, torch::Tensor out,
                        double scale, bool causal, int64_t window,
                        int64_t kv_len, int64_t q_offset) {
  const c10::cuda::CUDAGuard guard(q.device());
  repro_torch::launch_flash_attention_tc(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(k.size(1)), static_cast<int>(q.size(2)),
      static_cast<int>(k.size(2)), static_cast<int>(q.size(3)),
      static_cast<float>(scale), causal, static_cast<int>(window),
      static_cast<int>(kv_len), static_cast<int>(q_offset),
      at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gather_agg", &gather_agg,
        "K2: out[b] = sum_k w[b,k] * feat[idx[b,k]] in row tiles (writes "
        "out)");
  m.def("cache_lookup_agg", &cache_lookup_agg,
        "K1: fused cache lookup + layer-0 gather-aggregate in row tiles "
        "(writes out)");
  m.def("gns_sample_agg", &gns_sample_agg,
        "K3: device GNS draw + importance weight + gather-aggregate "
        "in row tiles over the table rows [row_lo, row_lo + row_count) "
        "(writes out, and lane_rows/lane_w when write_lanes)");
  m.def("flash_attention", &flash_attention,
        "K4: blocked attention with an online softmax; window <= 0 means "
        "none (writes out)");
  m.def("flash_attention_split", &flash_attention_split,
        "K4 route (i): split-KV partials, then their combine (two launches; "
        "writes part_acc, part_ml and out)");
  m.def("flash_attention_tc", &flash_attention_tc,
        "K4 route (ii): FlashAttention-2 on the tensor cores, bf16 "
        "(writes out)");
}
