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
// The arithmetic, in this order (s the forward's score of the dtype's
// route: (q * scale) . k in float32, (q . k) * scale in bf16):
//   delta[i] = sum_d dO[i, d] * O[i, d]                     (flash_bwd_delta)
//   c = cap * tanh(s / cap) when a softcap is set, else s; the masked pairs
//   (k >= S, k > q when causal, k <= q - window) have p = 0;
//   p = exp(c - LSE[i]);  dP = dO . v;
//   dS = p * (dP - delta[i]) * (1 - tanh^2(s / cap))  (no factor without a
//   softcap);
//   dV[j] = sum_i p dO[i];  dK[j] = sum_i dS (q[i] * scale)  (flash_bwd_dkdv)
//   dQ[i] = scale * sum_j dS k[j]                             (flash_bwd_dq)
// and each result is rounded once to the input type.  There are no atomics:
// every output element is summed in one fixed order, so a call repeats bit
// for bit on the same card and shapes.  Tiles that every mask empties are
// skipped (the loops' bounds); masks are applied only on a tile that crosses
// one.  The dtype picks the route; there is no fallback.
//
// bfloat16, the training route (namespace tc).  What bounds it on this
// card: at gemma3-1b's training microbatch (B 2, S 4096, 4 query heads over
// 1 kv head of hd 256, causal) the five products are 14 hd FLOP a kept
// pair, 0.24 TFLOP against 0.1 GB of inputs and outputs (0.17 GB with the
// partials below), so the bound is the tensor cores' 989 TFLOP/s, not the
// bytes.  The design is the bf16 forward's:
//   - Q, dO, K and V come in by TMA (4-D tensor maps over the [B, S, heads,
//     hd] tensors, 128-byte swizzle, 64-column chunks, rows >= S
//     zero-filled) into rings of stages with full and empty mbarriers; one
//     producer warp (setmaxnreg.dec) and two consumer warpgroups
//     (setmaxnreg.inc to 232 registers);
//   - all five products are wgmma with bf16 operands and float32
//     accumulators.  Scores are formed as the forward forms them (scale
//     after the product, log2 units, exp2), so p = exp2(c - LSE log2 e)
//     agrees with the forward's own LSE.  P and dS are rounded to bf16 in
//     registers before their products, as the forward rounds P before P.V;
//     the float32-inside plain version makes neither rounding.
//   flash_bwd_dkdv_wgmma: one block per (key tile of 64, query head, batch),
//   key tiles launched in order (the first have the longest causal
//   columns).  K and V of the tile stay resident; Q, dO and the rows' lse
//   and delta stream through the ring (64 query rows a stage).  Computed
//   key-major ("swap AB"), so that P^T and dS^T come out of the score
//   products in registers already in wgmma's A-fragment layout.  The two
//   consumer warpgroups split the work by accumulator: warpgroup 1 owns dV
//   (S^T = K . Q^T, both from shared memory; P; dV += P^T . dO, P^T from
//   registers and dO as the MN-major B), warpgroup 2 owns dK (dP^T =
//   V . dO^T; dS; dK += dS^T . Q).  Warpgroup 1 hands P dtanh to warpgroup
//   2 through a float32 exchange in shared memory, guarded by two named
//   barriers; dS is 0 wherever P is masked.  Each warpgroup thus holds one
//   64 x hd accumulator (hd / 2 registers), a 64 x 64 score tile (32) and
//   its bf16 fragments (16).  dK and dV of a kv group are split over its G
//   query heads, so that the grid fills the card: with G > 1 each block
//   writes its head's float32 dK and dV into a scratch tensor [2, B, S, H,
//   hd] that the wrapper allocates, and flash_bwd_dkdv_sum, a bytes-bound
//   launch, adds the G heads of each group in the order g = 0 .. G-1 and
//   rounds once (with G = 1 the block rounds and stores dk and dv itself).
//   flash_bwd_dq_wgmma: one block per (query tile of 128, head, batch),
//   longest causal rows first; Q, dO, lse and delta resident, K and V
//   streamed (32 keys a stage at hd 256, 64 below); each consumer
//   warpgroup owns 64 rows: S = Q . K^T and dP = dO . V^T from shared
//   memory, dS in registers, dQ += dS . K with K as the MN-major B.
// Blocks and makespan at the training microbatch on 132 SMs, one block an
// SM, in tile steps of 4096 (query, key) pairs (bwd_schedule in
// kernels/flash_attention.py): global layer dkdv 512 blocks, 16,640 steps,
// makespan 127 (the SIMT design: 256 blocks, longest 256 steps of 2048
// pairs); dq 256 blocks, makespan 128.  Local layer (window 512): dkdv 512
// blocks, makespan 36; dq 256 blocks, makespan 40.
// Budget.  Shared memory a block (1 KB of alignment slack included), dkdv:
// K and V resident (2 x 64 x hd x 2 bytes), NS Q/dO stages (2 x 64 x hd x
// 2 bytes each; NS 2 at hd 256, 3 below), the 16 KB exchange, 512 bytes of
// lse and delta a stage: 83 / 147 / 210 KB at hd 64 / 128 / 256; dq: Q and
// dO resident (2 x 128 x hd x 2 bytes) and NS K/V stages: 81 / 161 / 193
// KB.  Registers: 168 a thread at launch, the producer at 40 and the
// consumers at 232 after setmaxnreg.  At hd 256 a dkdv consumer holds 128
// accumulator registers, 32 of the score tile and 16 of its fragments; a
// dq consumer 128 + 16 + 16 (S, dP at 32 keys) + 8.  ptxas must report no
// spills (chip_smoke.py's train_kernel phase checks).
//
// float32, the parity route: the first design, kept as it was.  wgmma
// would take float32 only as TF32, about three decimal digits, which puts
// the float32 parity limits at risk.  SIMT: float32 FMAs out of shared
// memory, 256 threads a block, each thread a 4 x BK/16 patch of the score
// tile (rows tr + 16 i, keys tc + 16 j, so that a warp's loads of 16 rows
// of a padded tile hit distinct banks) and a patch of the accumulators with
// float4 columns.  flash_bwd_dkdv runs one block per (key tile, batch, kv
// head) and loops over the G query heads of the group and the query tiles
// the masks keep, so that dK and dV of a group are summed in registers;
// flash_bwd_dq runs one block per (query tile, batch, head), longest causal
// rows first.  Tiles: 64 query rows; 64 keys (hd 64, 128) or 32 (hd 256),
// rows padded by 4 floats; shared memory 103 / 169 / 217 KB (dkdv) and
// 86 / 152 / 208 KB (dq).  It leaves the tensor cores idle.
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

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

// dK / dV of a group summed over its G query heads, bf16 route: part is
// float32 [2][B, S, H, hd] (dK's per-head partials, then dV's) and dk, dv
// bf16 [B, S, KV, hd]; each float4 of an output adds the heads of its
// group in the order g = 0 .. G-1 and is rounded once.  Bound by the bytes:
// the loads of four heads go out together, the adds keep their order.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, long long rows,
                          int G, int hd) {
  const long long n4 = rows * (hd / 4);   // float4s of one output
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < 2 * n4; i += stride) {
    const int which = i >= n4;             // 0: dK, 1: dV
    const long long j = i - which * n4;
    const long long r = j / (hd / 4);      // row (b, s, kv head)
    const int d = static_cast<int>(j % (hd / 4)) * 4;
    const float* src = part + (which * rows + r) * G * hd + d;
    float4 acc = ld4(src);
    for (int g0 = 1; g0 < G; g0 += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g0 + u < G) x[u] = ld4(src + static_cast<size_t>(g0 + u) * hd);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g0 + u < G) {
          acc.x += x[u].x; acc.y += x[u].y; acc.z += x[u].z; acc.w += x[u].w;
        }
    }
    st4((which ? dv : dk) + r * hd + d, acc);
  }
}

// ---------------------------------------------------------------- bfloat16

namespace tc {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
// named barriers of the dkdv blocks' P dtanh exchange (0 is __syncthreads)
constexpr int kXFull = 1, kXEmpty = 2;

template <int HD>
struct DkdvCfg {
  static constexpr int BK = 64;                  // keys a block, resident
  static constexpr int BQ = 64;                  // query rows a stage
  static constexpr int NS = HD == 256 ? 2 : 3;   // stages of the Q/dO ring
  static constexpr int CHUNKS = HD / 64;         // 128-byte column chunks
  static constexpr int KV_BYTES = BK * HD * 2;   // K or V
  static constexpr int Q_BYTES = BQ * HD * 2;    // one Q or one dO stage
  static constexpr int X_BYTES = BK * BQ * 4;    // float32 P dtanh exchange
  static constexpr int L_BYTES = 2 * BQ * 4;     // a stage's lse and delta
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the swizzled tiles start on 1024-byte boundaries
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * NS * Q_BYTES +
                              X_BYTES + NS * L_BYTES + BAR_BYTES;
};

template <int HD>
struct DqCfg {
  static constexpr int BQ = 128;                 // query rows a block
  static constexpr int BK = HD == 256 ? 32 : 64; // keys a stage
  static constexpr int NS = HD == 256 ? 2 : 3;   // stages of the K/V ring
  static constexpr int CHUNKS = HD / 64;
  static constexpr int Q_BYTES = BQ * HD * 2;    // Q or dO, resident
  static constexpr int KV_BYTES = BK * HD * 2;   // one K or one V stage
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * NS * KV_BYTES +
                              BAR_BYTES;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The forward's bf16 score of a raw product x = q . k in log2 units (the
// scale after the product; with a softcap cap * tanh(x scale / cap)), and
// the softcap's derivative factor dt = 1 - tanh^2 (1 without one).
__device__ __forceinline__ float score_log2(float x, float scale,
                                            float softcap, float& dt) {
  if (softcap != 0.f) {
    const float t = tanhf(x * scale / softcap);
    dt = 1.f - t * t;
    return softcap * t * kLog2e;
  }
  dt = 1.f;
  return x * (scale * kLog2e);
}

// Block layout: warp 0 loads (lane 0 issues every TMA load, the warp
// copies each stage's lse and delta); warpgroup 1 computes S^T = K . Q^T,
// P, and dV += P^T . dO; warpgroup 2 computes dP^T = V . dO^T, dS from the
// P dtanh that warpgroup 1 leaves in the exchange, and dK += dS^T . Q.  In
// a consumer warpgroup thread t (warp w = t / 32, lane l) holds keys
// ka = k0 + 16 w + l / 4 and ka + 8; accumulator register 4 j + e of an
// m64nN product holds column 8 j + 2 (l % 4) + (e & 1) of row ka (e < 2)
// or ka + 8 (e >= 2), so a score tile's registers are already the
// A-fragment layout of the products that take P^T and dS^T.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ part, int B, int S, int H,
                            int KV, float scale, int causal, int window,
                            float softcap) {
  using C = DkdvCfg<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::KV_BYTES;
  const uint32_t sQ = sV + C::KV_BYTES;          // NS stages of Q
  const uint32_t sG = sQ + NS * C::Q_BYTES;      // NS stages of dO
  const uint32_t sX = sG + NS * C::Q_BYTES;      // the exchange
  const uint32_t sL = sX + C::X_BYTES;           // NS stages of lse, delta
  const uint32_t kv_full = sL + NS * C::L_BYTES; // then full[NS], empty[NS]
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * NS;
  float* xch = reinterpret_cast<float*>(smem_raw + (sX - raw));
  float* lds = reinterpret_cast<float*>(smem_raw + (sL - raw));

  // key tiles slowest and in order: the first ones have the longest
  // causal columns
  const int bh = blockIdx.x % (B * H);
  const int k0 = static_cast<int>(blockIdx.x / (B * H)) * BK;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);
  // query rows that some key of this tile may be attended from: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;
  const int t_lo = q_lo / BQ;
  const int n_steps = (q_hi + BQ - 1) / BQ - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: warp 0
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const size_t r_off = (static_cast<size_t>(b) * H + h) * S;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(sK + c * BK * 128, &tk, kv_full, c * 64, kh, k0, b);
          tma_load(sV + c * BK * 128, &tv, kv_full, c * 64, kh, k0, b);
        }
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % NS;
        const int q0 = (t_lo + i) * BQ;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        // the stage's lse (in log2 units) and delta; rows >= S read 0
        float* ls = lds + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < S;
          ls[r] = in ? lse[r_off + q0 + r] * kLog2e : 0.f;
          ls[BQ + r] = in ? delta[r_off + q0 + r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          // the arrival releases the warp's stores with the TMA bytes
          const uint32_t bar = full0 + 8 * s;
          mbar_expect_tx(bar, 2 * C::Q_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load(sQ + s * C::Q_BYTES + c * BQ * 128, &tq, bar, c * 64, h,
                     q0, b);
            tma_load(sG + s * C::Q_BYTES + c * BQ * 128, &tdo, bar, c * 64,
                     h, q0, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: c 0 the P / dV warpgroup, c 1 the dS / dK warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int ka = k0 + (t / 32) * 16 + lane / 4, kb = ka + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t sA = c == 0 ? sK : sV;   // A of the score product
    const uint32_t sB = c == 0 ? sQ : sG;   // its B, stage 0
    const uint32_t sR = c == 0 ? sG : sQ;   // B of the accumulation, stage 0

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % NS;
      const int q0 = (t_lo + i) * BQ;
      mbar_wait(full0 + 8 * s, (i / NS) & 1);

      // S^T = K . Q^T (c 0) or dP^T = V . dO^T (c 1): 64 keys x 64 rows
      float sc[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) sc[j] = 0.f;
      const uint32_t bst = sB + s * C::Q_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;  // 16 columns of a chunk
        wgmma_ss(sc, sw128_desc(sA + (ks / 4) * BK * 128 + off, 16, 1024),
                 sw128_desc(bst + (ks / 4) * BQ * 128 + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const float* ls = lds + s * 2 * BQ;
      if (c == 0) {
        // P = exp2(score - lse) and P dtanh for the exchange; masks only on
        // a tile that crosses one
        const bool edge = q0 + BQ > S || k0 + BK > S ||
                          (causal && k0 + BK - 1 > q0) ||
                          (window && k0 <= q0 + BQ - 1 - window);
        if (i > 0) named_sync(kXEmpty, 256);  // the last tile's is read
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int qc = 8 * (j / 4) + col0 + (j & 1);
          float dt;
          float p = exp2f(score_log2(sc[j], scale, softcap, dt) - ls[qc]);
          if (edge) {
            const int qi = q0 + qc, kj = (j & 2) ? kb : ka;
            bool ok = qi < S && kj < S;
            if (causal) ok = ok && kj <= qi;
            if (window) ok = ok && kj > qi - window;
            p = ok ? p : 0.f;
          }
          xch[j * 128 + t] = p * dt;
          sc[j] = p;
        }
        named_arrive(kXFull, 256);
      } else {
        // dS = P dtanh (dP - delta): zero wherever P is masked
        named_sync(kXFull, 256);
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int qc = 8 * (j / 4) + col0 + (j & 1);
          sc[j] = xch[j * 128 + t] * (sc[j] - ls[BQ + qc]);
        }
        named_arrive(kXEmpty, 256);
      }

      // dV += P^T . dO (c 0) or dK += dS^T . Q (c 1): P^T and dS^T rounded
      // to bf16 in registers, the stage's dO or Q as the MN-major B
      uint32_t a[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 2; j += 2) a[j / 2] = pack_bf16(sc[j], sc[j + 1]);
      const uint32_t rst = sR + s * C::Q_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                               a[4 * kk + 3]};
        wgmma_rs(acc, f, sw128_desc(rst + kk * 16 * 128, BQ * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty0 + 8 * s);
    }
    if (c == 0 && n_steps > 0) named_sync(kXEmpty, 256);  // the last read

    // epilogue: dK carries the scale (q * scale in the product)
    const float mul = c == 0 ? 1.f : scale;
    if (part != nullptr) {
      // this head's float32 partial: dK's [B, S, H, hd] first, then dV's
      const size_t stride = static_cast<size_t>(H) * HD;
      float* out = part + (c == 0 ? static_cast<size_t>(B) * S * stride : 0);
      float* ra = out + (static_cast<size_t>(b) * S + ka) * stride +
                  static_cast<size_t>(h) * HD + col0;
      float* rb = ra + 8 * stride;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (ka < S)
          *reinterpret_cast<float2*>(ra + 8 * j) =
              make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
        if (kb < S)
          *reinterpret_cast<float2*>(rb + 8 * j) =
              make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
      }
    } else {
      // G = 1: the head is the group; round once to bf16
      const size_t stride = static_cast<size_t>(KV) * HD;
      __nv_bfloat16* out = c == 0 ? dv : dk;
      __nv_bfloat16* ra = out + (static_cast<size_t>(b) * S + ka) * stride +
                          static_cast<size_t>(kh) * HD + col0;
      __nv_bfloat16* rb = ra + 8 * stride;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        if (ka < S)
          *reinterpret_cast<uint32_t*>(ra + 8 * j) =
              pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
        if (kb < S)
          *reinterpret_cast<uint32_t*>(rb + 8 * j) =
              pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
      }
    }
  }
}

// Block layout: thread 0 (warpgroup 0) loads; warpgroups 1 and 2 own query
// rows q0 .. q0+63 and q0+64 .. q0+127, each computing S = Q . K^T and
// dP = dO . V^T for its rows, dS, and dQ += dS . K.  Thread t holds rows
// qa = row_lo + 16 w + l / 4 and qa + 8 (the forward's layout).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int B, int S,
                          int H, int KV, float scale, int causal, int window,
                          float softcap) {
  using C = DqCfg<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + C::Q_BYTES;            // dO
  const uint32_t sK = sG + C::Q_BYTES;            // NS stages
  const uint32_t sV = sK + NS * C::KV_BYTES;      // NS stages
  const uint32_t q_full = sV + NS * C::KV_BYTES;  // then full[NS], empty[NS]
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * NS;

  // q tiles slowest and in reverse, so the longest causal rows start first
  const int nq = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / (B * H))) * BQ;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);
  // keys that some row of this q tile may attend: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BK;
  const int n_tiles = (kv_hi + BK - 1) / BK - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c) {
        tma_load(sQ + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
        tma_load(sG + c * BQ * 128, &tdo, q_full, c * 64, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * C::KV_BYTES);
        const int k0 = (t_lo + i) * BK;
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(sK + s * C::KV_BYTES + c * BK * 128, &tk, bar, c * 64, kh,
                   k0, b);
          tma_load(sV + s * C::KV_BYTES + c * BK * 128, &tv, bar, c * 64, kh,
                   k0, b);
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q0 + (wg - 1) * 64;          // this warpgroup's rows
    const int qa = row_lo + (t / 32) * 16 + lane / 4, qb = qa + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t sQw = sQ + (wg - 1) * 64 * 128;  // chunk c at + c BQ 128
    const uint32_t sGw = sG + (wg - 1) * 64 * 128;
    const size_t r_off = (static_cast<size_t>(b) * H + h) * S;
    const float l_a = qa < S ? lse[r_off + qa] * kLog2e : 0.f;
    const float l_b = qb < S ? lse[r_off + qb] * kLog2e : 0.f;
    const float d_a = qa < S ? delta[r_off + qa] : 0.f;
    const float d_b = qb < S ? delta[r_off + qb] : 0.f;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      const int k0 = (t_lo + i) * BK;
      mbar_wait(full0 + 8 * s, (i / NS) & 1);
      // empty for every row of this warpgroup: nothing to add
      const bool dead = (causal && k0 > row_lo + 63) ||
                        (window && k0 + BK - 1 <= row_lo - window);
      if (!dead) {
        float sc[BK / 2], dp[BK / 2];
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.f;
        const uint32_t kst = sK + s * C::KV_BYTES;
        const uint32_t vst = sV + s * C::KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;  // 16 columns of a chunk
          wgmma_ss(sc, sw128_desc(sQw + (ks / 4) * BQ * 128 + off, 16, 1024),
                   sw128_desc(kst + (ks / 4) * BK * 128 + off, 16, 1024), 1);
        }
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss(dp, sw128_desc(sGw + (ks / 4) * BQ * 128 + off, 16, 1024),
                   sw128_desc(vst + (ks / 4) * BK * 128 + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // dS = P dtanh (dP - delta), masks only on a tile that crosses one
        const bool edge = k0 + BK > S || row_lo + 64 > S ||
                          (causal && k0 + BK - 1 > row_lo) ||
                          (window && k0 <= row_lo + 63 - window);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const bool rb = j & 2;
          float dt;
          float p = exp2f(score_log2(sc[j], scale, softcap, dt) -
                          (rb ? l_b : l_a));
          if (edge) {
            const int kj = k0 + 8 * (j / 4) + col0 + (j & 1);
            const int qi = rb ? qb : qa;
            bool ok = qi < S && kj < S;
            if (causal) ok = ok && kj <= qi;
            if (window) ok = ok && kj > qi - window;
            p = ok ? p : 0.f;
          }
          sc[j] = p * dt * (dp[j] - (rb ? d_b : d_a));
        }
        uint32_t a[BK / 4];
#pragma unroll
        for (int j = 0; j < BK / 2; j += 2)
          a[j / 2] = pack_bf16(sc[j], sc[j + 1]);

        // dQ += dS . K: dS rounded to bf16 in registers, the stage's K as
        // the MN-major B (16 key rows from row 16 kk)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                 a[4 * kk + 3]};
          wgmma_rs(acc, f, sw128_desc(kst + kk * 16 * 128, BK * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (t == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: dq = scale * acc, rounded once to bf16
    const size_t q_stride = static_cast<size_t>(H) * HD;
    __nv_bfloat16* oa =
        dq + (static_cast<size_t>(b) * S + qa) * q_stride + h * HD + col0;
    __nv_bfloat16* ob = oa + 8 * q_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (qa < S)
        *reinterpret_cast<uint32_t*>(oa + 8 * j) =
            pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (qb < S)
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch

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

int launch_dkdv_simt(int hd, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int S, int H, int KV,
                     float scale, int causal, int window, float softcap,
                     cudaStream_t s) {
  switch (hd) {
    case 64: return launch_dkdv<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dkdv<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dkdv<float, 256>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_dq_simt(int hd, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int S, int H, int KV, float scale,
                   int causal, int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dq<float, 256>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A bf16 [B, S, heads, hd] tensor as a 4-D tensor map, innermost first;
// boxes of {64 columns (128 bytes), 1 head, rows, 1 batch}, 128-byte
// swizzle, out-of-range rows read as zero.
CUresult make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                  int B, int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The four tensor maps of a bf16 launch: q and dO with boxes of q_rows
// rows, k and v with boxes of k_rows rows.
int make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
              const void* k, const void* v, int B, int S, int H, int KV,
              int hd, int q_rows, int k_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUresult r = make_map(enc, &m[0], q, B, S, H, hd, q_rows);
  if (r == CUDA_SUCCESS) r = make_map(enc, &m[1], dout, B, S, H, hd, q_rows);
  if (r == CUDA_SUCCESS) r = make_map(enc, &m[2], k, B, S, KV, hd, k_rows);
  if (r == CUDA_SUCCESS) r = make_map(enc, &m[3], v, B, S, KV, hd, k_rows);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_dkdv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, float* part, int B, int S, int H,
                   int KV, float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  using C = tc::DkdvCfg<HD>;
  CUtensorMap m[4];
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, HD, C::BQ, C::BK);
  if (rc != 0) return rc;
  auto kernel = tc::flash_bwd_dkdv_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nk = (S + C::BK - 1) / C::BK;
  kernel<<<nk * B * H, tc::kThreads, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, B, S, H, KV, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int S, int H, int KV, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  using C = tc::DqCfg<HD>;
  CUtensorMap m[4];
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, HD, C::BQ, C::BK);
  if (rc != 0) return rc;
  auto kernel = tc::flash_bwd_dq_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (S + C::BQ - 1) / C::BQ;
  kernel<<<nq * B * H, tc::kThreads, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), B,
      S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  q, o, dout, dq: [B, S, H, hd];
// k, v, dk, dv: [B, S, KV, hd]; lse, delta: float32 [B, H, S]; all
// contiguous device pointers, the tensors of one type (dtype 0: float32,
// the SIMT route; 1: bfloat16, the wgmma/TMA route), 16-byte aligned.  Each
// launches on ``stream`` of ``device``, does not synchronise and allocates
// nothing, and returns the CUDA error of its attribute call or launch (0 on
// success; cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled, cudaErrorInvalidValue when it refuses a map).
// The caller checks shapes, H % KV == 0, hd in {64, 128, 256} and the
// grid's size.

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

// part: null, or (bf16 with H > KV) float32 [2, B, S, H, hd] that receives
// each head's dK and then dV unsummed, for flash_bwd_dkdv_sum_launch; dk
// and dv are then not written.  float32 ignores it.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, float* part, int B,
                                     int S, int H, int KV, int hd, int dtype,
                                     float scale, int causal, int window,
                                     float softcap, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkdv_simt(hd, q, k, v, dout, lse, delta, dk, dv, B, S, H,
                            KV, scale, causal, window, softcap, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_dkdv_tc<64>(q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dkdv_tc<128>(q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dkdv_tc<256>(q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk, dv (bf16 [B, S, KV, hd]) from the partials ``part`` (float32
// [2, B, S, KV * G, hd]) of flash_bwd_dkdv_launch.
extern "C" int flash_bwd_dkdv_sum_launch(const float* part, void* dk,
                                         void* dv, int B, int S, int KV,
                                         int G, int hd, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  const long long rows = static_cast<long long>(B) * S * KV;
  const long long n = 2 * rows * (hd / 4);
  const long long blocks = (n + kThreads - 1) / kThreads;
  flash_bwd_dkdv_sum_kernel<<<static_cast<unsigned>(
                                  blocks < 1048576 ? blocks : 1048576),
                              kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      rows, G, hd);
  return static_cast<int>(cudaGetLastError());
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
    return launch_dq_simt(hd, q, k, v, dout, lse, delta, dq, B, S, H, KV,
                          scale, causal, window, softcap, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_dq_tc<64>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dq_tc<128>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dq_tc<256>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
