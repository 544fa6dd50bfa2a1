// Backward of flash attention for Hopper (sm_90a): the gradients dq, dk and
// dv of the function that flash_attention.cu computes (causal mask, sliding
// window, logit softcap, grouped KV heads), from the forward's output O and
// its log-sum-exp LSE.
//
// Replaces no TPU kernel: the JAX package has no backward for any Pallas
// kernel and trains through jnp attention under jax.value_and_grad.  This is
// the port's gradient of repro/kernels/flash_attention.py::_flash_kernel's
// function, so that training on the card goes through the hand-written
// forward and a hand-written backward, with no library call between them.
//
// The arithmetic, float32 inside for both input types, in this order (with
// s = (q * scale) . k, the forward's score):
//   delta[i] = sum_d dO[i, d] * O[i, d]                     (flash_bwd_delta)
//   c = cap * tanh(s / cap) when a softcap is set, else s; the masked pairs
//   (k >= S, k > q when causal, k <= q - window) have p = 0;
//   p = exp(c - LSE[i]);  dP = dO . v;
//   dS = p * (dP - delta[i]) * (1 - tanh^2(s / cap))  (no factor without a
//   softcap);
//   dV[j] = sum_i p dO[i];  dK[j] = sum_i dS (q[i] * scale)  (flash_bwd_dkdv)
//   dQ[i] = scale * sum_j dS k[j]                             (flash_bwd_dq)
// and each result is rounded once to the input type.  There are no atomics:
// every output element is summed by one thread in a fixed order, so a call
// repeats bit for bit on the same card and shapes.  flash_bwd_dkdv runs one
// block per (key tile, batch, kv head) and loops over the G query heads of
// the group and over the query tiles the masks keep, so that dK and dV of a
// group are summed in registers; flash_bwd_dq runs one block per (query
// tile, batch, head), longest causal rows first, and loops over the key
// tiles the masks keep.
//
// What bounds it on this card: at gemma3-1b's training shape (B 2, S 4096,
// 4 heads over 1 of hd 256, causal) the three launches do about 200 GFLOP of
// float32 arithmetic against 0.1 GB of inputs and outputs, so the bound is
// the card's arithmetic, not the bytes.  This first design is SIMT: float32
// FMAs out of shared memory, 256 threads a block, each thread a 4 x BK/16
// patch of the score tile (rows tr + 16 i, keys tc + 16 j, so that a warp's
// loads of 16 rows of a padded tile hit distinct banks) and a patch of the
// accumulators with float4 columns.  Tiles: 64 query rows; 64 keys (hd 64,
// 128) or 32 (hd 256), rows padded by 4 floats; shared memory 103 / 169 /
// 217 KB (dkdv) and 86 / 152 / 208 KB (dq).  It leaves the tensor cores
// idle; a wgmma/TMA design is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups

template <int HD>
struct Tiles {
  static constexpr int BQ = 64;                // query rows a step
  static constexpr int BK = HD == 256 ? 32 : 64;  // keys a tile
  static constexpr int LD = HD + 4;            // padded row, floats
  static constexpr int PLD = BK + 1;           // padded P / dS row, floats
  static constexpr int NJ = BK / 16;           // keys a thread holds
  static constexpr int NG = HD / 64;           // float4 columns a thread holds
  static constexpr int DKDV_FLOATS = 2 * BK * LD + 2 * BQ * LD +
                                     2 * BQ * PLD + 2 * BQ;
  static constexpr int DQ_FLOATS = 2 * BQ * LD + 2 * BK * LD + BQ * PLD;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ``rows`` rows from row0 of src (row r at src + r * stride) into dst as
// float32, dst[r * LD + d] = mul * src[r][d]; rows >= S are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows, int S, size_t stride,
                                      float mul) {
  constexpr int LD = Tiles<HD>::LD;
  for (int i = threadIdx.x; i < rows * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      x = ld4(src + static_cast<size_t>(row0 + r) * stride + d);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    st4(dst + r * LD + d, x);
  }
}

// c[a][j] = sum_d A[tr + 16 a][d] * Bm[tc + 16 j][d] over padded rows.
template <int HD, int NJ>
__device__ __forceinline__ void dot_tile(float (&c)[4][NJ], const float* A,
                                         const float* Bm, int tr, int tc) {
  constexpr int LD = Tiles<HD>::LD;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) c[a][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = ld4(A + (tr + 16 * a) * LD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) y[j] = ld4(Bm + (tc + 16 * j) * LD + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float s = c[a][j];
        s = fmaf(x[a].x, y[j].x, s);
        s = fmaf(x[a].y, y[j].y, s);
        s = fmaf(x[a].z, y[j].z, s);
        s = fmaf(x[a].w, y[j].w, s);
        c[a][j] = s;
      }
  }
}

// From the scores s and dP of a thread's patch (rows q0 + tr + 16 a, keys
// k0 + tc + 16 j), p and dS as the header says; masked pairs give 0.
template <int NJ>
__device__ __forceinline__ void softmax_grad(float (&s)[4][NJ],
                                             float (&dp)[4][NJ],
                                             const float (&lse)[4],
                                             const float (&dl)[4], int q0,
                                             int k0, int tr, int tc, int S,
                                             int causal, int window,
                                             float softcap) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + tr + 16 * a;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kj = k0 + tc + 16 * j;
      float c = s[a][j], dt = 1.f;
      if (softcap != 0.f) {
        const float t = tanhf(c / softcap);
        c = softcap * t;
        dt = 1.f - t * t;
      }
      bool ok = qi < S && kj < S;
      if (causal) ok = ok && kj <= qi;
      if (window) ok = ok && kj > qi - window;
      const float p = ok ? expf(c - lse[a]) : 0.f;
      s[a][j] = p;
      dp[a][j] = p * (dp[a][j] - dl[a]) * dt;
    }
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int S, int H,
                       int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * S * H) return;
  const T* orow = o + row * hd;       // rows of [B, S, H] in memory order
  const T* grow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(grow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const int i = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
    delta[(static_cast<size_t>(b) * H + h) * S + i] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, float scale,
                      int causal, int window, float softcap) {
  using C = Tiles<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, PLD = C::PLD;
  constexpr int NJ = C::NJ, NG = C::NG;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* Vs = Ks + BK * LD;                      // [BK][LD]
  float* Qs = Vs + BK * LD;                      // [BQ][LD], q * scale
  float* Gs = Qs + BQ * LD;                      // [BQ][LD], dO
  float* Ps = Gs + BQ * LD;                      // [BQ][PLD]
  float* Ss = Ps + BQ * PLD;                     // [BQ][PLD], dS
  float* Ls = Ss + BQ * PLD;                     // [BQ] LSE
  float* Ds = Ls + BQ;                           // [BQ] delta

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * S * KV + kh) * HD;
  stage<T, HD>(Ks, k + kv_off, k0, BK, S, kv_stride, 1.f);
  stage<T, HD>(Vs, v + kv_off, k0, BK, S, kv_stride, 1.f);

  float4 ak[NJ][NG], av[NJ][NG];  // dK, dV of keys k0 + tr + 16 j
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      ak[j][g] = make_float4(0.f, 0.f, 0.f, 0.f);
      av[j][g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // query rows that some key of this tile may be attended from: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (static_cast<size_t>(b) * S * H + h) * HD;
    const size_t r_off = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile is consumed; K, V are visible
      stage<T, HD>(Qs, q + q_off, q0, BQ, S, q_stride, scale);
      stage<T, HD>(Gs, dout + q_off, q0, BQ, S, q_stride, 1.f);
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lse[r_off + q0 + tid] : 0.f;
        Ds[tid] = in ? delta[r_off + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][NJ], dp[4][NJ], l4[4], d4[4];
      dot_tile<HD, NJ>(s, Qs, Ks, tr, tc);
      dot_tile<HD, NJ>(dp, Gs, Vs, tr, tc);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        l4[a] = Ls[tr + 16 * a];
        d4[a] = Ds[tr + 16 * a];
      }
      softmax_grad<NJ>(s, dp, l4, d4, q0, k0, tr, tc, S, causal, window,
                       softcap);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          Ps[(tr + 16 * a) * PLD + tc + 16 * j] = s[a][j];
          Ss[(tr + 16 * a) * PLD + tc + 16 * j] = dp[a][j];
        }
      __syncthreads();

      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Qs[i]
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pj[NJ], sj[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          pj[j] = Ps[i * PLD + tr + 16 * j];
          sj[j] = Ss[i * PLD + tr + 16 * j];
        }
#pragma unroll
        for (int gg = 0; gg < NG; ++gg) {
          const float4 x = ld4(Gs + i * LD + 64 * gg + 4 * tc);
          const float4 y = ld4(Qs + i * LD + 64 * gg + 4 * tc);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            av[j][gg].x = fmaf(pj[j], x.x, av[j][gg].x);
            av[j][gg].y = fmaf(pj[j], x.y, av[j][gg].y);
            av[j][gg].z = fmaf(pj[j], x.z, av[j][gg].z);
            av[j][gg].w = fmaf(pj[j], x.w, av[j][gg].w);
            ak[j][gg].x = fmaf(sj[j], y.x, ak[j][gg].x);
            ak[j][gg].y = fmaf(sj[j], y.y, ak[j][gg].y);
            ak[j][gg].z = fmaf(sj[j], y.z, ak[j][gg].z);
            ak[j][gg].w = fmaf(sj[j], y.w, ak[j][gg].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int kj = k0 + tr + 16 * j;
    if (kj >= S) continue;
    const size_t off = (static_cast<size_t>(b) * S + kj) * kv_stride +
                       static_cast<size_t>(kh) * HD;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      st4(dk + off + 64 * gg + 4 * tc, ak[j][gg]);
      st4(dv + off + 64 * gg + 4 * tc, av[j][gg]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, float scale, int causal, int window,
                    float softcap) {
  using C = Tiles<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, PLD = C::PLD;
  constexpr int NJ = C::NJ, NG = C::NG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD], q * scale
  float* Gs = Qs + BQ * LD;                      // [BQ][LD], dO
  float* Ks = Gs + BQ * LD;                      // [BK][LD]
  float* Vs = Ks + BK * LD;                      // [BK][LD]
  float* Ss = Vs + BK * LD;                      // [BQ][PLD], dS

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  // q tiles slowest and in reverse, so the longest causal rows start first
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_off = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t kv_off = (static_cast<size_t>(b) * S * KV + kh) * HD;
  const size_t r_off = (static_cast<size_t>(b) * H + h) * S;
  stage<T, HD>(Qs, q + q_off, q0, BQ, S, q_stride, scale);
  stage<T, HD>(Gs, dout + q_off, q0, BQ, S, q_stride, 1.f);
  float l4[4], d4[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + tr + 16 * a;
    l4[a] = qi < S ? lse[r_off + qi] : 0.f;
    d4[a] = qi < S ? delta[r_off + qi] : 0.f;
  }

  float4 acc[4][NG];  // dQ of rows q0 + tr + 16 a
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[a][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  // keys that some row of this q tile may attend: [k_lo, k_hi)
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Q, dO are visible
    stage<T, HD>(Ks, k + kv_off, k0, BK, S, kv_stride, 1.f);
    stage<T, HD>(Vs, v + kv_off, k0, BK, S, kv_stride, 1.f);
    __syncthreads();

    float s[4][NJ], dp[4][NJ];
    dot_tile<HD, NJ>(s, Qs, Ks, tr, tc);
    dot_tile<HD, NJ>(dp, Gs, Vs, tr, tc);
    softmax_grad<NJ>(s, dp, l4, d4, q0, k0, tr, tc, S, causal, window,
                     softcap);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        Ss[(tr + 16 * a) * PLD + tc + 16 * j] = dp[a][j];
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] k[j]
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = Ss[(tr + 16 * a) * PLD + j];
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        const float4 x = ld4(Ks + j * LD + 64 * gg + 4 * tc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][gg].x = fmaf(sa[a], x.x, acc[a][gg].x);
          acc[a][gg].y = fmaf(sa[a], x.y, acc[a][gg].y);
          acc[a][gg].z = fmaf(sa[a], x.z, acc[a][gg].z);
          acc[a][gg].w = fmaf(sa[a], x.w, acc[a][gg].w);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + tr + 16 * a;
    if (qi >= S) continue;
    T* row = dq + (static_cast<size_t>(b) * S + qi) * q_stride +
             static_cast<size_t>(h) * HD;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      const float4 x = acc[a][gg];
      st4(row + 64 * gg + 4 * tc,
          make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
  }
}

template <typename T, int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int S, int H, int KV, float scale, int causal,
                int window, float softcap, cudaStream_t stream) {
  using C = Tiles<HD>;
  const int smem = static_cast<int>(sizeof(float)) * C::DKDV_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BK - 1) / C::BK, KV, B);
  flash_bwd_dkdv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int KV, float scale, int causal, int window,
              float softcap, cudaStream_t stream) {
  using C = Tiles<HD>;
  const int smem = static_cast<int>(sizeof(float)) * C::DQ_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dkdv(int hd, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int S, int H, int KV, float scale,
                  int causal, int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dkdv<T, 256>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dq(int hd, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, int B, int S, int H, int KV, float scale,
                int causal, int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dq<T, 256>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  q, o, dout, dq: [B, S, H, hd];
// k, v, dk, dv: [B, S, KV, hd]; lse, delta: float32 [B, H, S]; all
// contiguous device pointers, the tensors of one type (dtype 0: float32,
// 1: bfloat16), 16-byte aligned.  Each launches on ``stream`` of ``device``,
// does not synchronise and allocates nothing, and returns the CUDA error of
// its attribute call or launch (0 on success).  The caller checks shapes,
// H % KV == 0, hd in {64, 128, 256} and the grid's size.

extern "C" int flash_bwd_delta_launch(const void* o, const void* dout,
                                      float* delta, int B, int S, int H,
                                      int hd, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  const long long rows = static_cast<long long>(B) * S * H;
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    flash_bwd_delta_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        B, S, H, hd);
  else if (dtype == 1)
    flash_bwd_delta_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, B, S, H, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int S, int H,
                                     int KV, int hd, int dtype, float scale,
                                     int causal, int window, float softcap,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkdv<float>(hd, q, k, v, dout, lse, delta, dk, dv, B, S,
                                H, KV, scale, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_dkdv<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dk,
                                        dv, B, S, H, KV, scale, causal,
                                        window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int S, int H, int KV,
                                   int hd, int dtype, float scale, int causal,
                                   int window, float softcap, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float>(hd, q, k, v, dout, lse, delta, dq, B, S, H, KV,
                              scale, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(hd, q, k, v, dout, lse, delta, dq, B,
                                      S, H, KV, scale, causal, window,
                                      softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
