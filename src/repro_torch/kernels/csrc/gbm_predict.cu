// Boosted-tree ensemble inference for Hopper (sm_90a), with the engine's
// normalisation epilogue fused in.
//
// Replaces repro/kernels/gbm_predict.py::_gbm_kernel (the Pallas TPU kernel)
// together with the jitted epilogue of repro/core/engine.py
// (_gbm_kernel_executable): out[i] = epi(f0 + sum_t leaf[t][leaf_of(t, x_i)]),
// where epi(r) = exp(clip(r, -30, 30)) when y_scale == 0 (log target) and
// r * max(y_scale, 1e-12) otherwise.
//
// What bounds it on this card: each row walks T trees of D levels, and every
// level is a shared-memory load (feature id, threshold) whose address depends
// on the previous one, so a row costs T x D dependent shared-memory loads and
// moves only (d + 1) x 4 bytes of device memory.  It is bound by that chain
// of dependent loads, not by bytes.  This first design does nothing about it
// yet: one thread per row, 256 threads per block, the tree tables staged into
// shared memory a tile of trees at a time, the row's features in registers.
//
// The TPU kernel re-cast every gather as a one-hot contraction because the
// TPU has no cheap gather; a GPU gathers directly, so none of that carries
// over.  Unsplittable nodes carry thr = +inf and are NOT clamped: a +inf or
// NaN feature compares false against it and goes left, as the plain version
// (repro_torch.kernels.gbm_predict.gbm_predict_plain) and the JAX oracle do.
//
// Leaves are added in tree order t = 0..T-1 starting from f0, the order of
// the plain version, so the raw sums agree bit for bit; only expf in the
// epilogue may differ from torch.exp by an ulp or two.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// DMAX: the largest feature count this instantiation takes.  The row's
// features live in registers; a feature is picked by an unrolled select so
// that the array is never indexed dynamically (which would put it in local
// memory).
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
gbm_predict_kernel(const float* __restrict__ X, const int* __restrict__ feat,
                   const float* __restrict__ thr,
                   const float* __restrict__ leaf,
                   const float* __restrict__ f0,
                   const float* __restrict__ y_scale,
                   float* __restrict__ out, int n, int d, int n_trees,
                   int depth, int tile_trees) {
  extern __shared__ unsigned char smem_raw[];
  const int n_int = (1 << depth) - 1;
  const int n_leaf = n_int + 1;
  int* s_feat = reinterpret_cast<int*>(smem_raw);
  float* s_thr = reinterpret_cast<float*>(s_feat + tile_trees * n_int);
  float* s_leaf = s_thr + tile_trees * n_int;

  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = row < n;
  float x[DMAX];
#pragma unroll
  for (int k = 0; k < DMAX; ++k)
    x[k] = (active && k < d) ? X[row * d + k] : 0.0f;

  float acc = f0[0];
  for (int t0 = 0; t0 < n_trees; t0 += tile_trees) {
    const int nt = min(tile_trees, n_trees - t0);
    __syncthreads();  // every thread is done with the previous tile
    const int64_t base_int = static_cast<int64_t>(t0) * n_int;
    const int64_t base_leaf = static_cast<int64_t>(t0) * n_leaf;
    for (int i = threadIdx.x; i < nt * n_int; i += kThreads) {
      s_feat[i] = feat[base_int + i];
      s_thr[i] = thr[base_int + i];
    }
    for (int i = threadIdx.x; i < nt * n_leaf; i += kThreads)
      s_leaf[i] = leaf[base_leaf + i];
    __syncthreads();
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const int* tf = s_feat + t * n_int;
        const float* tt = s_thr + t * n_int;
        int idx = 0;
        for (int level = 0; level < depth; ++level) {
          const int f = tf[idx];
          float v = x[0];
#pragma unroll
          for (int k = 1; k < DMAX; ++k) v = (f == k) ? x[k] : v;
          idx = 2 * idx + 1 + (v > tt[idx] ? 1 : 0);
        }
        acc += s_leaf[t * n_leaf + idx - n_int];
      }
    }
  }
  if (active) {
    const float ys = y_scale[0];
    float r;
    if (ys == 0.0f) {
      // written with comparisons so that NaN passes through, as in
      // torch.clamp and jnp.clip (fminf/fmaxf would drop it)
      const float c = acc < -30.0f ? -30.0f : (acc > 30.0f ? 30.0f : acc);
      r = expf(c);
    } else {
      r = acc * (ys < 1e-12f ? 1e-12f : ys);
    }
    out[row] = r;
  }
}

template <int DMAX>
void launch(const float* X, const int* feat, const float* thr,
            const float* leaf, const float* f0, const float* y_scale,
            float* out, int n, int d, int n_trees, int depth, int tile_trees,
            cudaStream_t stream) {
  const int n_int = (1 << depth) - 1;
  const size_t smem = static_cast<size_t>(tile_trees) *
                      (2 * n_int + n_int + 1) * sizeof(float);
  const int blocks = (n + kThreads - 1) / kThreads;
  gbm_predict_kernel<DMAX><<<blocks, kThreads, smem, stream>>>(
      X, feat, thr, leaf, f0, y_scale, out, n, d, n_trees, depth, tile_trees);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer; f0 and y_scale point at one float each.  Launches on ``stream``
// of ``device``, does not synchronise and allocates nothing.  Returns
// cudaGetLastError() after the launch (0 on success).  The caller checks
// shapes, d <= 16 and the shared-memory size of a tile.
extern "C" int gbm_predict_launch(const void* X, const void* feat,
                                  const void* thr, const void* leaf,
                                  const void* f0, const void* y_scale,
                                  void* out, int n, int d, int n_trees,
                                  int depth, int tile_trees, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const auto* Xp = static_cast<const float*>(X);
  const auto* fp = static_cast<const int*>(feat);
  const auto* tp = static_cast<const float*>(thr);
  const auto* lp = static_cast<const float*>(leaf);
  const auto* f0p = static_cast<const float*>(f0);
  const auto* ysp = static_cast<const float*>(y_scale);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 4)
    launch<4>(Xp, fp, tp, lp, f0p, ysp, op, n, d, n_trees, depth, tile_trees, s);
  else if (d <= 8)
    launch<8>(Xp, fp, tp, lp, f0p, ysp, op, n, d, n_trees, depth, tile_trees, s);
  else
    launch<16>(Xp, fp, tp, lp, f0p, ysp, op, n, d, n_trees, depth, tile_trees, s);
  return static_cast<int>(cudaGetLastError());
}
