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
// level is a shared-memory load whose address depends on the previous one.
// A row moves only (d + 1) x 4 bytes of device memory and does D compares
// and one add a tree, so neither bytes nor operations bound it: the issued
// instructions and shared-memory loads per (row, tree) do once the card is
// full, and the dependent chain of loads does while it is not.  The design,
// one lever per cause:
//
// * A tree is staged as a heap in shared memory: the nodes of levels
//   0..D-2 as 8-byte (feature id, threshold) pairs, an aligned int and
//   float, from byte 8; the nodes of level D-1 as 16-byte (feature id,
//   threshold, left leaf, right leaf), 16-aligned.  A level is one load,
//   and the last one also brings both leaves, so a tree of depth D takes D
//   loads and no address arithmetic after its last compare.  A walker keeps
//   its node as a byte offset: the child of the node at o is at
//   2 o - base + 8 right (4 o - 3 base - 8 2^(D-1) + 16 right into the last
//   level), one compare, one select and one multiply-add.  The depth is a
//   template parameter (1-4; 0 is the generic instance for 5-10), so the
//   levels unroll and tree offsets are constants.  Staging packs the
//   tables with 4-byte cp.async copies, all in flight at once; the whole
//   ensemble is staged once per block when it fits the plan's tile (200
//   trees of depth 3 take 19.2 KB), larger ones go in tiles.
// * A thread walks kChains trees at once: that many independent chains of
//   loads, whose leaves are then added in tree order.
// * When the rows alone cannot fill the card (the serving shape, n = 24,576
//   rows on 132 SMs), the plan splits a tile's trees into `slices`
//   contiguous runs.  Thread (row, slice) walks its run; slice 0 adds its
//   leaves to the row's sum directly, the others write theirs to shared
//   memory vals[t - split][row] (rows consecutive, so a warp's stores do not
//   conflict), and after a barrier slice 0 adds those in tree order.  Rows
//   past n skip the walk but reach every barrier.
// * The row's features stay in registers, picked by an unrolled select
//   (DMAX is the exact feature count up to 4, else 8 or 16); no array is
//   indexed dynamically.
// * Blocks loop over chunks of `rows` rows, so a grid of the card's resident
//   blocks stages a small ensemble once however many rows there are.
//
// The plan (rows a block, slices, tile trees, shared-memory bytes, blocks)
// is made by repro_torch/kernels/gbm_predict.py:plan and passed in.
//
// The TPU kernel re-cast every gather as a one-hot contraction because the
// TPU has no cheap gather; a GPU gathers directly, so none of that carries
// over.  Unsplittable nodes carry thr = +inf and are NOT clamped: a +inf or
// NaN feature compares false against it and goes left, as the plain version
// (repro_torch.kernels.gbm_predict.gbm_predict_plain) and the JAX oracle do.
//
// Leaves are added in tree order t = 0..T-1 starting from f0, the order of
// the plain version, so the raw sums agree bit for bit; only expf in the
// epilogue may differ from torch.exp by an ulp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // rows a block x slices
// Trees a thread walks at once: 8 while the row's features take at most 4
// registers, 4 above, so that no instance needs more than the 64 registers
// of __launch_bounds__(kMaxThreads, 2).  The loops over groups of trees
// stay rolled (unroll 1): unrolled, ptxas keeps more loads in flight and
// spills at 1 feature.
template <int DMAX>
constexpr int kChains = DMAX <= 4 ? 8 : 4;

struct __align__(8) Node {   // levels 0..D-2
  int feat;
  float thr;
};

struct __align__(16) LastNode {   // level D-1
  int feat;
  float thr;
  float left, right;   // the leaves below it
};

struct Args {
  const float* X;
  const int* feat;
  const float* thr;
  const float* leaf;
  const float* f0;
  const float* y_scale;
  float* out;
  int n, d, n_trees, depth;
  int rows;        // rows a block, a multiple of 32
  int slices;      // threads that share a row's trees
  int tile_trees;  // trees staged into shared memory at a time
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Byte offset of a tree's last level, and a tree's bytes in shared memory.
__device__ __forceinline__ int last_level_bytes(int depth) {
  return depth > 1 ? 8 << (depth - 1) : 16;
}
__device__ __forceinline__ int tree_bytes(int depth) {
  return last_level_bytes(depth) + (16 << (depth - 1));
}

// Trees [t0, t0 + nt) into smem, tree_bytes(depth) bytes each.
__device__ void stage(unsigned char* smem, const Args& a, int t0, int nt,
                      int depth) {
  const int n_int = (1 << depth) - 1;
  const int n_upper = (1 << (depth - 1)) - 1;
  const int last = last_level_bytes(depth), tb = tree_bytes(depth);
  const int* feat = a.feat + static_cast<int64_t>(t0) * n_int;
  const float* thr = a.thr + static_cast<int64_t>(t0) * n_int;
  const float* leaf = a.leaf + static_cast<int64_t>(t0) * (n_int + 1);
  for (int i = threadIdx.x; i < nt * n_int; i += blockDim.x) {
    const int t = i / n_int, k = i - t * n_int;
    unsigned char* e = smem + t * tb +
        (k < n_upper ? 8 * (k + 1) : last + 16 * (k - n_upper));
    cp_async4(e, feat + i);
    cp_async4(e + 4, thr + i);
  }
  for (int i = threadIdx.x; i < nt * (n_int + 1); i += blockDim.x) {
    const int t = i / (n_int + 1), k = i - t * (n_int + 1);
    cp_async4(smem + t * tb + last + 16 * (k >> 1) + 8 + 4 * (k & 1),
              leaf + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x[f], without indexing x: at 4 features by the two bits of f, else by
// comparing f with each feature id in turn (which ptxas compiles to fewer
// instructions below 4).
template <int DMAX>
__device__ __forceinline__ float pick(const float (&x)[DMAX], int f) {
  if constexpr (DMAX == 4) {
    const float lo = (f & 1) ? x[1] : x[0];
    const float hi = (f & 1) ? x[3] : x[2];
    return (f & 2) ? hi : lo;
  }
  float v = x[0];
#pragma unroll
  for (int k = 1; k < DMAX; ++k) v = (f == k) ? x[k] : v;
  return v;
}

// The leaf values of K consecutive trees, whose heaps start `first` bytes
// into shared memory and `stride` bytes apart: K independent chains of
// dependent loads.
template <int DMAX, int DEPTH, int K>
__device__ __forceinline__ void walk(const unsigned char* smem,
                                     unsigned first, unsigned stride,
                                     int depth, const float (&x)[DMAX],
                                     float (&v)[K]) {
  unsigned o[K];
#pragma unroll
  for (int j = 0; j < K; ++j) o[j] = first + j * stride + (depth > 1 ? 8 : 16);
  auto upper_level = [&]() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const Node e = *reinterpret_cast<const Node*>(smem + o[j]);
      o[j] = 2u * o[j] - (first + j * stride) +
             (pick(x, e.feat) > e.thr ? 8u : 0u);
    }
  };
  if (depth > 1) {
    if constexpr (DEPTH > 0) {
#pragma unroll
      for (int l = 0; l < DEPTH - 2; ++l) upper_level();
    } else {
#pragma unroll 1
      for (int l = 0; l < depth - 2; ++l) upper_level();
    }
    const unsigned last_start = 8u << (depth - 1);  // level D-1's offset
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const Node e = *reinterpret_cast<const Node*>(smem + o[j]);
      o[j] = 4u * o[j] - 3u * (first + j * stride) - last_start +
             (pick(x, e.feat) > e.thr ? 16u : 0u);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const LastNode e = *reinterpret_cast<const LastNode*>(smem + o[j]);
    v[j] = pick(x, e.feat) > e.thr ? e.right : e.left;
  }
}

// Trees [lo, hi) of the staged tile, kChains at a time: added to acc in tree
// order, or (STORE) written to vals[(t - first) * rows + r].
template <int DMAX, int DEPTH, bool STORE>
__device__ __forceinline__ float walk_run(const unsigned char* smem,
                                          int depth, const float (&x)[DMAX],
                                          int lo, int hi, float acc,
                                          float* vals, int first, int rows,
                                          int r) {
  constexpr int K = kChains<DMAX>;
  const unsigned stride = tree_bytes(depth);
  int t = lo;
#pragma unroll 1
  for (; t + K <= hi; t += K) {
    float v[K];
    walk<DMAX, DEPTH, K>(smem, t * stride, stride, depth, x, v);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if constexpr (STORE)
        vals[(t + j - first) * rows + r] = v[j];
      else
        acc += v[j];
    }
  }
#pragma unroll 1
  for (; t < hi; ++t) {
    float v[1];
    walk<DMAX, DEPTH, 1>(smem, t * stride, stride, depth, x, v);
    if constexpr (STORE)
      vals[(t - first) * rows + r] = v[0];
    else
      acc += v[0];
  }
  return acc;
}

template <int DMAX, int DEPTH>
__global__ void __launch_bounds__(kMaxThreads, 2)
gbm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int depth = DEPTH > 0 ? DEPTH : a.depth;
  float* vals =
      reinterpret_cast<float*>(smem_raw + a.tile_trees * tree_bytes(depth));
  const int r = threadIdx.x % a.rows;
  const int slice = threadIdx.x / a.rows;
  const bool one_tile = a.tile_trees >= a.n_trees;
  const float f0 = a.f0[0];

  if (one_tile) {
    stage(smem_raw, a, 0, a.n_trees, depth);
    __syncthreads();
  }
  for (int64_t c = blockIdx.x; c * a.rows < a.n; c += gridDim.x) {
    const int64_t row = c * a.rows + r;
    const bool active = row < a.n;
    float x[DMAX];
#pragma unroll
    for (int k = 0; k < DMAX; ++k)
      x[k] = (active && k < a.d) ? __ldg(a.X + row * a.d + k) : 0.0f;

    float acc = f0;
    for (int t0 = 0; t0 < a.n_trees; t0 += a.tile_trees) {
      const int nt = min(a.tile_trees, a.n_trees - t0);
      if (!one_tile) {
        __syncthreads();  // every thread is done with the previous tile
        stage(smem_raw, a, t0, nt, depth);
        __syncthreads();
      }
      // slice s walks trees [lo, hi); slice 0 the first `split` of them
      const int split = nt / a.slices;
      const int lo = slice * nt / a.slices;
      const int hi = (slice + 1) * nt / a.slices;
      if (active && slice == 0)
        acc = walk_run<DMAX, DEPTH, false>(smem_raw, depth, x, lo, hi, acc,
                                           vals, split, a.rows, r);
      else if (active)
        walk_run<DMAX, DEPTH, true>(smem_raw, depth, x, lo, hi, acc, vals,
                                    split, a.rows, r);
      if (a.slices > 1) {
        __syncthreads();  // every slice's leaves are in vals
        if (slice == 0 && active) {
#pragma unroll 8
          for (int t = split; t < nt; ++t)
            acc += vals[(t - split) * a.rows + r];
        }
        __syncthreads();  // vals is free for the next tile or chunk
      }
    }
    if (slice == 0 && active) {
      const float ys = a.y_scale[0];
      float out;
      if (ys == 0.0f) {
        // written with comparisons so that NaN passes through, as in
        // torch.clamp and jnp.clip (fminf/fmaxf would drop it)
        const float cl = acc < -30.0f ? -30.0f : (acc > 30.0f ? 30.0f : acc);
        out = expf(cl);
      } else {
        out = acc * (ys < 1e-12f ? 1e-12f : ys);
      }
      a.out[row] = out;
    }
  }
}

using Kernel = void (*)(Args);

template <int DMAX>
Kernel kernel_for_depth(int depth) {
  switch (depth) {
    case 1: return gbm_kernel<DMAX, 1>;
    case 2: return gbm_kernel<DMAX, 2>;
    case 3: return gbm_kernel<DMAX, 3>;
    case 4: return gbm_kernel<DMAX, 4>;
    default: return gbm_kernel<DMAX, 0>;
  }
}

Kernel kernel_for(int d, int depth) {
  switch (d) {
    case 1: return kernel_for_depth<1>(depth);
    case 2: return kernel_for_depth<2>(depth);
    case 3: return kernel_for_depth<3>(depth);
    case 4: return kernel_for_depth<4>(depth);
    default:
      return d <= 8 ? kernel_for_depth<8>(depth) : kernel_for_depth<16>(depth);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a device
// pointer; f0 and y_scale point at one float each.  Launches `blocks` blocks
// of rows x slices threads with smem_bytes of dynamic shared memory on
// ``stream`` of ``device``, does not synchronise and allocates nothing.
// Returns cudaGetLastError() after the launch (0 on success).  The caller
// checks shapes, d <= 16, depth <= 10, and makes the plan.
extern "C" int gbm_predict_launch(const void* X, const void* feat,
                                  const void* thr, const void* leaf,
                                  const void* f0, const void* y_scale,
                                  void* out, int n, int d, int n_trees,
                                  int depth, int rows, int slices,
                                  int tile_trees, int smem_bytes, int blocks,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (rows < 32 || rows % 32 || slices < 1 || rows * slices > kMaxThreads ||
      tile_trees < 1 || blocks < 1 || d < 1 || d > 16 || depth < 1 ||
      depth > 10)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel k = kernel_for(d, depth);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{static_cast<const float*>(X), static_cast<const int*>(feat),
         static_cast<const float*>(thr), static_cast<const float*>(leaf),
         static_cast<const float*>(f0), static_cast<const float*>(y_scale),
         static_cast<float*>(out), n, d, n_trees, depth, rows, slices,
         tile_trees};
  k<<<blocks, rows * slices, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
