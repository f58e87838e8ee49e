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

void gather_agg(const torch::Tensor& feat, const torch::Tensor& idx,
                const torch::Tensor& w, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(feat.device());
  repro_torch::launch_gather_agg(
      feat.data_ptr(), feat.scalar_type() == at::kBFloat16,
      idx.data_ptr<int32_t>(), w.data_ptr<float>(), out.data_ptr<float>(),
      idx.size(0), static_cast<int>(idx.size(1)),
      static_cast<int>(feat.size(1)), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void cache_lookup_agg(const torch::Tensor& cache,
                      const torch::Tensor& streamed,
                      const torch::Tensor& slots, const torch::Tensor& idx,
                      const torch::Tensor& w, torch::Tensor out) {
  const c10::cuda::CUDAGuard guard(cache.device());
  repro_torch::launch_cache_lookup_agg(
      cache.data_ptr(), cache.scalar_type() == at::kBFloat16,
      streamed.data_ptr<float>(), slots.data_ptr<int32_t>(),
      idx.data_ptr<int32_t>(), w.data_ptr<float>(), out.data_ptr<float>(),
      idx.size(0), static_cast<int>(idx.size(1)),
      static_cast<int>(cache.size(1)), at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gather_agg", &gather_agg,
        "K2: out[b] = sum_k w[b,k] * feat[idx[b,k]] (writes out)");
  m.def("cache_lookup_agg", &cache_lookup_agg,
        "K1: fused cache lookup + layer-0 gather-aggregate (writes out)");
}
