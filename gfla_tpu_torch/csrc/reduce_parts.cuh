// Fixed-order sum of per-CTA partial sums, shared by the backward kernels
// (warp_bwd.cu, attn_math_bwd.cu). A TPU kernel adds its weight gradients
// across a sequential grid; CUDA CTAs run in no order, so each writes its own
// partial and this kernel adds them in index order: the result does not
// depend on scheduling.
#pragma once

#include <cuda_runtime.h>

namespace gfla {
namespace {  // internal linkage: each including file has its own copy

// out[e] = sum over p of part[p * n + e], p in order.
__global__ void reduce_parts(const float* __restrict__ part, int n_parts,
                             size_t n, float* __restrict__ out) {
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
#pragma unroll 8
    for (int p = 0; p < n_parts; ++p) s += part[static_cast<size_t>(p) * n + e];
    out[e] = s;
  }
}

int launch_reduce(const float* part, int n_parts, size_t n, float* out,
                  cudaStream_t stream) {
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  reduce_parts<<<grid, threads, 0, stream>>>(part, n_parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gfla
