// Flash decode for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache, split over the cache and merged by a second kernel.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (the Pallas TPU
// kernel).  It computes the same function: s = (q * scale) . k in float32,
// s = cap * tanh(s / cap) when a softcap is set, a slot masked to the finite
// NEG_INF = -2e38 unless its position p satisfies p <= pos and p > pos -
// window (window 0: no lower bound), softmax over the cache, times v, out in
// q's type.  The kv head of query head h is h / G.  The position of slot j
// is j, or k_pos[j] when a slot -> position map is given (the ring buffer of
// a sliding-window cache: modeling/attention.py builds it, with 2**30 for an
// empty slot).
//
// What bounds it on this card: the cache.  A decode step reads every valid
// K/V byte once and does 4 flops per byte pair, so it is bound by device
// memory (3.35 TB/s): about 5 us for a gemma3-1b global layer at batch 8
// and 2120 positions, about 1.3 us for a 512-slot local layer.  What the
// design does: the TPU grid (batch, kv head, cache block) with the cache
// block axis sequential becomes split-K.  The wrapper restricts the cache
// to the positions the mask can keep when there is no slot map ([pos -
// window + 1, pos]), cuts that range into parts of a few dozen slots, and
// gives each part to one warp, so that a batch of 8 with one kv head still
// spreads over all SMs.  A warp walks its slots in order; lane l holds dims
// [l * hd/32, (l+1) * hd/32) of one K row (16-byte loads for bf16 at hd
// 256, one contiguous 512-byte row per warp), the G query rows of the kv
// head share every K/V row read, and each score is reduced across the warp
// by shuffles.  The warp keeps (m, l, acc) for its G rows in registers with
// the Pallas update order and writes them, unnormalised, to a float32
// scratch that the wrapper allocates.  The combine kernel merges the parts
// of one (batch, head): M = max m_i, out = sum acc_i exp(m_i - M) /
// max(sum l_i exp(m_i - M), 1e-30), with the weights exp(m_i - M) computed
// once per part into shared memory.  A part whose slots are all masked has
// m = NEG_INF and weight exp(NEG_INF - M) = 0, as a fully masked block heals
// in the TPU kernel.  This first design is latency-bound, not
// bandwidth-bound, at the serving shape: a warp walks its slots one after
// another through a chain of shuffles and exponentials, and the partial
// sums make a round trip through device memory between two launches.
// Keys processed in batches per warp, and one launch, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // parts per block of the split pass
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float2 bf2f(uint32_t u) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = u;
  return __bfloat1622float2(h);
}

// VEC consecutive elements at p (aligned to VEC elements) as float32.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      out[i] = a.x; out[i + 1] = a.y; out[i + 2] = a.z; out[i + 3] = a.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 2) {
    const float2 a = bf2f(*reinterpret_cast<const uint32_t*>(p));
    out[0] = a.x; out[1] = a.y;
  } else if constexpr (VEC == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf2f(u.x), b = bf2f(u.y);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const float2 a = bf2f(u.x), b = bf2f(u.y), c = bf2f(u.z), d = bf2f(u.w);
      out[i] = a.x; out[i + 1] = a.y; out[i + 2] = b.x; out[i + 3] = b.y;
      out[i + 4] = c.x; out[i + 5] = c.y; out[i + 6] = d.x; out[i + 7] = d.y;
    }
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp per part: slots [lo + part * per_part, min(hi, ... + per_part)).
// part_m, part_l: [B, H, n_parts]; part_acc: [B, H, n_parts, HD].
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ k_pos,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int L, int H, int KV,
                    float scale, int pos, int window, float softcap, int lo,
                    int hi, int per_part, int n_parts) {
  constexpr int VEC = HD / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = blockIdx.x * kWarps + warp;
  if (part >= n_parts) return;  // no block-wide barrier below
  const int b = blockIdx.y / KV, kh = blockIdx.y % KV;
  const int j0 = lo + part * per_part;
  const int j1 = min(hi, j0 + per_part);

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<VEC>(q + (static_cast<size_t>(b) * H + kh * G + g) * HD + lane * VEC,
                  qv[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[g][e] *= scale;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t row = static_cast<size_t>(KV) * HD;
  const T* kb = kc + (static_cast<size_t>(b) * L * KV + kh) * HD + lane * VEC;
  const T* vb = vc + (static_cast<size_t>(b) * L * KV + kh) * HD + lane * VEC;
#pragma unroll 2
  for (int j = j0; j < j1; ++j) {
    float kv[VEC], vv[VEC];
    load_vec<VEC>(kb + j * row, kv);
    load_vec<VEC>(vb + j * row, vv);
    const int p = k_pos ? k_pos[j] : j;
    const bool ok = p <= pos && (window == 0 || p > pos - window);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s = fmaf(qv[g][e], kv[e], s);
      s = warp_sum(s);
      if (softcap != 0.f) s = softcap * tanhf(s / softcap);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[g], s);
      const float corr = expf(m[g] - m_new);
      const float pr = expf(s - m_new);
      l[g] = l[g] * corr + pr;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e] * corr);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t idx = (static_cast<size_t>(b) * H + kh * G + g) * n_parts + part;
    if (lane == 0) {
      part_m[idx] = m[g];
      part_l[idx] = l[g];
    }
    float* dst = part_acc + idx * HD + lane * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = acc[g][e];
  }
}

// Reduce x over the block (blockDim.x a multiple of 32, at most 1024);
// every thread gets the result.  ``red`` is 32 floats of shared memory.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : (kMax ? kNegInf : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may be reused
  return x;
}

// One block of HD threads per (batch, head); thread c owns output dim c.
// The parts' weights exp(m_i - M) are computed once, in parallel, into
// shared memory (n_parts floats), so the loop over parts is a chain of
// independent loads and FMAs.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int HD,
                                      int n_parts) {
  extern __shared__ float w[];  // [n_parts]
  __shared__ float red[32];
  const size_t bh = blockIdx.x;
  const int c = threadIdx.x;
  const float* pm = part_m + bh * n_parts;
  const float* pl = part_l + bh * n_parts;
  float M = kNegInf;
  for (int i = c; i < n_parts; i += blockDim.x) M = fmaxf(M, pm[i]);
  M = block_reduce<true>(M, red);
  float den = 0.f;
  for (int i = c; i < n_parts; i += blockDim.x) {
    w[i] = expf(pm[i] - M);
    den = fmaf(pl[i], w[i], den);
  }
  den = block_reduce<false>(den, red);  // its barriers publish w
  const float* pa = part_acc + bh * n_parts * HD + c;
  float num = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_parts; ++i)
    num = fmaf(pa[static_cast<size_t>(i) * HD], w[i], num);
  store1(out + bh * HD + c, num / fmaxf(den, 1e-30f));
}

template <typename T, int HD, int G>
int launch_split(const void* q, const void* k, const void* v, const int* k_pos,
                 float* pm, float* pl, float* pa, int B, int L, int H, int KV,
                 float scale, int pos, int window, float softcap, int lo,
                 int hi, int per_part, int n_parts, cudaStream_t s) {
  const dim3 grid((n_parts + kWarps - 1) / kWarps, B * KV);
  decode_split_kernel<T, HD, G><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_pos, pm, pl, pa, L, H, KV, scale, pos,
      window, softcap, lo, hi, per_part, n_parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* k_pos, float* pm, float* pl, float* pa, int B,
               int L, int H, int KV, float scale, int pos, int window,
               float softcap, int lo, int hi, int per_part, int n_parts,
               cudaStream_t s) {
#define DECODE_G(g_)                                                          \
  case g_:                                                                    \
    return launch_split<T, HD, g_>(q, k, v, k_pos, pm, pl, pa, B, L, H, KV,   \
                                   scale, pos, window, softcap, lo, hi,       \
                                   per_part, n_parts, s);
  switch (G) {
    DECODE_G(1)
    DECODE_G(2)
    DECODE_G(4)
    DECODE_G(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_G
}

template <typename T>
int dispatch_hd(int hd, int G, const void* q, const void* k, const void* v,
                const int* k_pos, float* pm, float* pl, float* pa, int B,
                int L, int H, int KV, float scale, int pos, int window,
                float softcap, int lo, int hi, int per_part, int n_parts,
                cudaStream_t s) {
  switch (hd) {
    case 64: return dispatch_g<T, 64>(G, q, k, v, k_pos, pm, pl, pa, B, L, H, KV, scale, pos, window, softcap, lo, hi, per_part, n_parts, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, k_pos, pm, pl, pa, B, L, H, KV, scale, pos, window, softcap, lo, hi, per_part, n_parts, s);
    case 256: return dispatch_g<T, 256>(G, q, k, v, k_pos, pm, pl, pa, B, L, H, KV, scale, pos, window, softcap, lo, hi, per_part, n_parts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Every pointer is a contiguous
// device pointer; q [B, H, hd], caches [B, L, KV, hd] of one type (dtype 0:
// float32, 1: bfloat16), 16-byte aligned; k_pos is int32 [L] or null;
// part_m, part_l float32 [B, H, n_parts], part_acc float32 [B, H, n_parts,
// hd].  Each launches on ``stream`` of ``device``, does not synchronise,
// allocates nothing and returns cudaGetLastError() after its launch (0 on
// success).  The caller checks shapes, G = H / KV in {1, 2, 4, 8}, hd in
// {64, 128, 256}, 0 <= lo < hi <= L, n_parts = ceil((hi - lo) / per_part),
// and n_parts * 4 bytes within the combine block's 48 KB of shared memory.
extern "C" int decode_attention_split_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    void* part_m, void* part_l, void* part_acc, int B, int L, int H, int KV,
    int hd, int dtype, float scale, int pos, int window, float softcap,
    int lo, int hi, int per_part, int n_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || n_parts <= 0) return 0;
  const int G = H / KV;
  auto s = static_cast<cudaStream_t>(stream);
  auto* kp = static_cast<const int*>(k_pos);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch_hd<float>(hd, G, q, k, v, kp, pm, pl, pa, B, L, H, KV,
                              scale, pos, window, softcap, lo, hi, per_part,
                              n_parts, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, G, q, k, v, kp, pm, pl, pa, B, L, H,
                                      KV, scale, pos, window, softcap, lo, hi,
                                      per_part, n_parts, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_attention_combine_launch(const void* part_m,
                                               const void* part_l,
                                               const void* part_acc, void* out,
                                               int B, int H, int hd,
                                               int n_parts, int dtype,
                                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pm = static_cast<const float*>(part_m);
  const auto* pl = static_cast<const float*>(part_l);
  const auto* pa = static_cast<const float*>(part_acc);
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(H);
  const size_t smem = sizeof(float) * static_cast<size_t>(n_parts);
  if (dtype == 0)
    decode_combine_kernel<float><<<blocks, hd, smem, s>>>(
        pm, pl, pa, static_cast<float*>(out), hd, n_parts);
  else if (dtype == 1)
    decode_combine_kernel<__nv_bfloat16><<<blocks, hd, smem, s>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), hd, n_parts);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
