// A sum over parts in a fixed order, for the cross-block sums of the
// backward kernels (wkv6_bwd.cu: du over b; mamba_scan_bwd.cu: dB and dC
// over the blocks, dA over b): each block writes its part, and one launch
// of its own adds them, so a gradient repeats bit for bit with no atomics.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// out[i] = sum over q = 0 .. K - 1 of part[q count + i], in that order
__global__ void fixed_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int K,
                                 size_t count) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int q = 0; q < K; ++q) s += part[q * count + i];
  out[i] = s;
}

// Launches fixed_sum_kernel on ``st``; returns its CUDA error (0: none).
inline int fixed_sum(const float* part, float* out, int K, size_t count,
                     cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  fixed_sum_kernel<<<blocks, 256, 0, st>>>(part, out, K, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
