// Forward flash attention for Hopper (sm_90a): online-softmax attention with
// a causal mask, a sliding window, a logit softcap and grouped KV heads.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel).  It computes the same function: s = (q * scale) . k in float32,
// s = cap * tanh(s / cap) when a softcap is set, keys masked to the finite
// NEG_INF = -2e38 unless k < S, k <= q (causal) and k > q - window, then the
// Pallas update order m_new = max(m, rowmax(s)), corr = exp(m - m_new),
// p = exp(s - m_new), l = l * corr + rowsum(p), acc = acc * corr + p . v, and
// out = acc / max(l, 1e-30) in q's type.  The kv head of query head h is
// h / (H / KV).
//
// What bounds it on this card: at the serving shape (B 8, S 2048, H 4, KV 1,
// hd 256, bf16) a causal layer does 69 GFLOP against 84 MB of input and
// output, so the card's bound is the tensor cores' 989 TFLOP/s (0.07 ms).
// This first design does not reach the tensor cores: it multiplies in
// float32 FMAs out of shared memory, so it is bound by the float32 pipe and
// by shared-memory bandwidth, tens of times above the bound.  What the design
// does: the TPU kernel's sequential kv-block grid axis (with m, l, acc carried
// in VMEM scratch) becomes a loop inside one block; one block of 256 threads
// per (batch, head, 64-row q tile); each 64-row K/V tile is staged once in
// shared memory as float32 and used by all 64 query rows; every thread owns
// a 4 x 4 patch of the score tile and a 4 x hd/16 patch of the output, with
// the same four rows in both, so m and l stay in registers and reduce across
// the 16 lanes of a row group by warp shuffles.  Kv tiles that the causal
// mask or the window empty for the whole q tile are skipped: that leaves the
// function unchanged, because every query row keeps its own position, and a
// row whose first visited tile is fully masked heals on the next tile
// (corr = exp(NEG_INF - m) = 0).  Ragged S is masked (k < S) and zero-filled
// in shared memory, never padded in device memory.  Q and K are stored
// transposed ([hd][64]) so that the score loop reads both as float4 without
// bank conflicts.  Shared memory: (3 hd + 64) x 64 x 4 bytes, 208 KB at
// hd = 256, above the 48 KB static limit, so the launch raises the block's
// dynamic shared-memory limit first.  A wgmma/TMA version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = u.x;
  *reinterpret_cast<uint32_t*>(&b) = u.y;
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(HD) * kBQ + 2 * HD * kBK +
                          kBK * kBQ);
}

// Rows row0 .. row0+63 of src (row r at src + r * stride) into dst
// transposed, dst[d * 64 + r] = mul * src[r][d]; rows >= S are zero.
// Consecutive threads take consecutive rows, so the transposed stores hit
// consecutive banks.
template <typename T, int HD>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 int row0, int S,
                                                 size_t stride, float mul) {
  for (int i = threadIdx.x; i < 64 * (HD / 4); i += kThreads) {
    const int r = i % 64, d = (i / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      x = load4(src + static_cast<size_t>(row0 + r) * stride + d);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    dst[(d + 0) * 64 + r] = x.x;
    dst[(d + 1) * 64 + r] = x.y;
    dst[(d + 2) * 64 + r] = x.z;
    dst[(d + 3) * 64 + r] = x.w;
  }
}

// Rows row0 .. row0+63 of src into dst as they are, dst[r * HD + d].
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int S, size_t stride) {
  for (int i = threadIdx.x; i < 64 * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = load4(src + static_cast<size_t>(row0 + r) * stride + d);
    store4(dst + r * HD + d, x);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, float scale, int causal, int window, float softcap) {
  constexpr int NC4 = HD / 64;  // float4 column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][64], q * scale
  float* Kt = Qt + HD * kBQ;                     // [HD][64]
  float* Vs = Kt + HD * kBK;                     // [64][HD]
  float* Pt = Vs + kBK * HD;                     // [64 keys][64 rows]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;   // rows tr*4 .. tr*4+3 of the q tile
  const int tc = tid & 15;   // score columns tc*4 ..; output columns g*64+tc*4 ..
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const T* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kh) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;

  stage_transposed<T, HD>(Qt, qb, q0, S, q_stride, scale);

  float m[4], l[4], acc[4][NC4 * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC4 * 4; ++c) acc[i][c] = 0.f;
  }

  // keys that some row of this q tile may attend: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + kBQ) : S;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kBK, t_hi = (kv_hi + kBK - 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed; Qt is visible
    stage_transposed<T, HD>(Kt, kb, k0, S, kv_stride, 1.f);
    stage_rows<T, HD>(Vs, vb, k0, S, kv_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBQ + tr * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kBK + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc * 4 + j;
        float x = s[i][j];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window) ok = ok && kj > qi - window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
      l[i] = l[i] * corr + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC4 * 4; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tc * 4 + j) * kBQ + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + j * kBQ + tr * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NC4; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(Vs + j * HD + g * 64 + tc * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pv[i], w.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pv[i], w.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pv[i], w.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pv[i], w.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + qi) * q_stride +
              static_cast<size_t>(h) * HD;
#pragma unroll
    for (int g = 0; g < NC4; ++g)
      store4(orow + g * 64 + tc * 4,
             make_float4(acc[i][g * 4 + 0] / den, acc[i][g * 4 + 1] / den,
                         acc[i][g * 4 + 2] / den, acc[i][g * 4 + 3] / den));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, int KV, float scale, int causal,
                int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, o: [B, S, H, hd]; k, v:
// [B, S, KV, hd]; all contiguous device pointers of one type (dtype 0:
// float32, 1: bfloat16), 16-byte aligned.  Launches on ``stream`` of
// ``device``, does not synchronise and allocates nothing.  Returns the CUDA
// error of the attribute call or of the launch (0 on success).  The caller
// checks shapes, H % KV == 0 and hd in {64, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd, int dtype,
                                      float scale, int causal, int window,
                                      float softcap, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, scale, causal,
                              window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, scale,
                                      causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
