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
// MLA's head dims (minicpm3-4b's training: q and k heads of 96, v heads of
// 64) are a pair of their own, (HDQK, HDV) = (96, 64), on both routes.  At
// the MLA training microbatch (B 1, S 4096, 40 heads over 40, causal: 335.6
// M kept pairs) dkdv does 640 FLOP a pair (S and dK over 96, dP and dV over
// 64), 0.2172 ms at 989 TFLOP/s, and dq 512 (S, dQ over 96, dP over 64),
// 0.1737 ms, against tens of MB: the tensor cores bound both.  bf16 runs
// two kernels of its own, flash_bwd_dkdv_mla and flash_bwd_dq_mla ("MLA's
// backward" below: persistent, each consumer warpgroup on its own keys or
// rows of an item end to end); with G > 1 the partials are
// dK's [B, S, H, 96] followed by dV's [B, S, H, 64] in one scratch buffer,
// and flash_bwd_dkdv_sum adds each at its own width.  The shared tc
// kernels above serve the equal head dims only.  float32: the SIMT kernels
// with q/k rows padded to 100 floats and v/dO rows to 68; a thread's float4
// column groups cover columns 64 gg + 4 tc, and at 96 the second group
// only for tc < 8 (in_row), so that each column has one thread; shared
// memory 117 KB (dkdv) and 100 KB (dq).
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

// HDQK: the head dim of q and k (and of dq, dk); HDV: of v, dO, O and dv.
template <int HDQK, int HDV>
struct Tiles {
  static constexpr int BQ = 64;                // query rows a step
  static constexpr int BK = HDQK == 256 ? 32 : 64;  // keys a tile
  static constexpr int LD = HDQK + 4;          // padded q / k row, floats
  static constexpr int LDV = HDV + 4;          // padded v / dO row, floats
  static constexpr int PLD = BK + 1;           // padded P / dS row, floats
  static constexpr int NJ = BK / 16;           // keys a thread holds
  // float4 column groups a thread holds of a q/k row (the last one partial
  // at 96: see in_row) and of a v row
  static constexpr int NG = (HDQK + 63) / 64;
  static constexpr int NGV = HDV / 64;
  static constexpr int DKDV_FLOATS = BK * LD + BK * LDV + BQ * LD +
                                     BQ * LDV + 2 * BQ * PLD + 2 * BQ;
  static constexpr int DQ_FLOATS = BQ * LD + BQ * LDV + BK * LD + BK * LDV +
                                   BQ * PLD;
};

// Whether column group gg of thread column tc (columns 64 gg + 4 tc .. + 3)
// lies inside a row of HD columns: always where HD is a multiple of 64; at
// HD 96 the second group only for tc < 8, so that each of the 96 columns
// belongs to exactly one of a row group's 16 threads (tc 0-15 take columns
// 0-63, tc 0-7 columns 64-95 as well).
template <int HD>
__device__ __forceinline__ bool in_row(int gg, int tc) {
  if constexpr (HD % 64 == 0) return true;
  else return 64 * gg + 4 * tc < HD;
}

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
// float32, dst[r * LD + d] = mul * src[r][d] for the HD columns of a row;
// rows >= S are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows, int S, size_t stride,
                                      float mul) {
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

// c[a][j] = sum_d A[tr + 16 a][d] * Bm[tc + 16 j][d] over the HD columns
// of rows padded to LD.
template <int HD, int LD, int NJ>
__device__ __forceinline__ void dot_tile(float (&c)[4][NJ], const float* A,
                                         const float* Bm, int tr, int tc) {
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

template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, int KV, float scale,
                      int causal, int window, float softcap) {
  using C = Tiles<HDQK, HDV>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int PLD = C::PLD, NJ = C::NJ, NG = C::NG, NGV = C::NGV;
  constexpr bool kEq = HDQK == HDV;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][LD]
  float* Vs = Ks + BK * LD;                      // [BK][LDV]
  float* Qs = Vs + BK * LDV;                     // [BQ][LD], q * scale
  float* Gs = Qs + BQ * LD;                      // [BQ][LDV], dO
  float* Ps = Gs + BQ * LDV;                     // [BQ][PLD]
  float* Ss = Ps + BQ * PLD;                     // [BQ][PLD], dS
  float* Ls = Ss + BQ * PLD;                     // [BQ] LSE
  float* Ds = Ls + BQ;                           // [BQ] delta

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t q_stride = static_cast<size_t>(H) * HDQK;
  const size_t kv_stride = static_cast<size_t>(KV) * HDQK;
  const size_t kv_off = (static_cast<size_t>(b) * S * KV + kh) * HDQK;
  // v, dO and dv rows at HDV (the same strides and offsets where HDV = HDQK)
  const size_t g_stride = kEq ? q_stride : static_cast<size_t>(H) * HDV;
  const size_t v_stride = kEq ? kv_stride : static_cast<size_t>(KV) * HDV;
  const size_t v_off =
      kEq ? kv_off : (static_cast<size_t>(b) * S * KV + kh) * HDV;
  stage<T, HDQK, LD>(Ks, k + kv_off, k0, BK, S, kv_stride, 1.f);
  stage<T, HDV, LDV>(Vs, v + v_off, k0, BK, S, v_stride, 1.f);

  float4 ak[NJ][NG], av[NJ][NGV];  // dK, dV of keys k0 + tr + 16 j
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      ak[j][g] = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kEq) av[j][g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if constexpr (!kEq) {
#pragma unroll
      for (int g = 0; g < NGV; ++g) av[j][g] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // query rows that some key of this tile may be attended from: [q_lo, q_hi)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(S, k0 + BK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t q_off = (static_cast<size_t>(b) * S * H + h) * HDQK;
    const size_t g_off = kEq ? q_off : (static_cast<size_t>(b) * S * H + h) * HDV;
    const size_t r_off = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile is consumed; K, V are visible
      stage<T, HDQK, LD>(Qs, q + q_off, q0, BQ, S, q_stride, scale);
      stage<T, HDV, LDV>(Gs, dout + g_off, q0, BQ, S, g_stride, 1.f);
      if (tid < BQ) {
        const bool in = q0 + tid < S;
        Ls[tid] = in ? lse[r_off + q0 + tid] : 0.f;
        Ds[tid] = in ? delta[r_off + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][NJ], dp[4][NJ], l4[4], d4[4];
      dot_tile<HDQK, LD, NJ>(s, Qs, Ks, tr, tc);
      dot_tile<HDV, LDV, NJ>(dp, Gs, Vs, tr, tc);
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
        if constexpr (kEq) {
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
        } else {
#pragma unroll
          for (int gg = 0; gg < NGV; ++gg) {
            const float4 x = ld4(Gs + i * LDV + 64 * gg + 4 * tc);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              av[j][gg].x = fmaf(pj[j], x.x, av[j][gg].x);
              av[j][gg].y = fmaf(pj[j], x.y, av[j][gg].y);
              av[j][gg].z = fmaf(pj[j], x.z, av[j][gg].z);
              av[j][gg].w = fmaf(pj[j], x.w, av[j][gg].w);
            }
          }
#pragma unroll
          for (int gg = 0; gg < NG; ++gg) {
            if (!in_row<HDQK>(gg, tc)) continue;
            const float4 y = ld4(Qs + i * LD + 64 * gg + 4 * tc);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              ak[j][gg].x = fmaf(sj[j], y.x, ak[j][gg].x);
              ak[j][gg].y = fmaf(sj[j], y.y, ak[j][gg].y);
              ak[j][gg].z = fmaf(sj[j], y.z, ak[j][gg].z);
              ak[j][gg].w = fmaf(sj[j], y.w, ak[j][gg].w);
            }
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
                       static_cast<size_t>(kh) * HDQK;
    if constexpr (kEq) {
#pragma unroll
      for (int gg = 0; gg < NG; ++gg) {
        st4(dk + off + 64 * gg + 4 * tc, ak[j][gg]);
        st4(dv + off + 64 * gg + 4 * tc, av[j][gg]);
      }
    } else {
      const size_t voff = (static_cast<size_t>(b) * S + kj) * v_stride +
                          static_cast<size_t>(kh) * HDV;
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
        if (in_row<HDQK>(gg, tc)) st4(dk + off + 64 * gg + 4 * tc, ak[j][gg]);
#pragma unroll
      for (int gg = 0; gg < NGV; ++gg)
        st4(dv + voff + 64 * gg + 4 * tc, av[j][gg]);
    }
  }
}

template <typename T, int HDQK, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int KV, float scale, int causal, int window,
                    float softcap) {
  using C = Tiles<HDQK, HDV>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDV = C::LDV;
  constexpr int PLD = C::PLD, NJ = C::NJ, NG = C::NG;
  constexpr bool kEq = HDQK == HDV;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LD], q * scale
  float* Gs = Qs + BQ * LD;                      // [BQ][LDV], dO
  float* Ks = Gs + BQ * LDV;                     // [BK][LD]
  float* Vs = Ks + BK * LD;                      // [BK][LDV]
  float* Ss = Vs + BK * LDV;                     // [BQ][PLD], dS

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  // q tiles slowest and in reverse, so the longest causal rows start first
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const size_t q_stride = static_cast<size_t>(H) * HDQK;
  const size_t kv_stride = static_cast<size_t>(KV) * HDQK;
  const size_t q_off = (static_cast<size_t>(b) * S * H + h) * HDQK;
  const size_t kv_off = (static_cast<size_t>(b) * S * KV + kh) * HDQK;
  // dO and v rows at HDV (the same where HDV = HDQK)
  const size_t g_stride = kEq ? q_stride : static_cast<size_t>(H) * HDV;
  const size_t v_stride = kEq ? kv_stride : static_cast<size_t>(KV) * HDV;
  const size_t g_off = kEq ? q_off : (static_cast<size_t>(b) * S * H + h) * HDV;
  const size_t v_off =
      kEq ? kv_off : (static_cast<size_t>(b) * S * KV + kh) * HDV;
  const size_t r_off = (static_cast<size_t>(b) * H + h) * S;
  stage<T, HDQK, LD>(Qs, q + q_off, q0, BQ, S, q_stride, scale);
  stage<T, HDV, LDV>(Gs, dout + g_off, q0, BQ, S, g_stride, 1.f);
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
    stage<T, HDQK, LD>(Ks, k + kv_off, k0, BK, S, kv_stride, 1.f);
    stage<T, HDV, LDV>(Vs, v + v_off, k0, BK, S, v_stride, 1.f);
    __syncthreads();

    float s[4][NJ], dp[4][NJ];
    dot_tile<HDQK, LD, NJ>(s, Qs, Ks, tr, tc);
    dot_tile<HDV, LDV, NJ>(dp, Gs, Vs, tr, tc);
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
        if (!in_row<HDQK>(gg, tc)) continue;
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
             static_cast<size_t>(h) * HDQK;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      if (!in_row<HDQK>(gg, tc)) continue;
      const float4 x = acc[a][gg];
      st4(row + 64 * gg + 4 * tc,
          make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
    }
  }
}

// dK / dV of a group summed over its G query heads, bf16 route: part_k is
// float32 [B, S, H, hd] (dK's per-head partials) and part_v [B, S, H, hdv]
// (dV's), dk bf16 [B, S, KV, hd] and dv [B, S, KV, hdv]; each float4 of an
// output adds the heads of its group in the order g = 0 .. G-1 and is
// rounded once.  Bound by the bytes: the loads of four heads go out
// together, the adds keep their order.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part_k,
                          const float* __restrict__ part_v,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, long long rows,
                          int G, int hd, int hdv) {
  const long long nk4 = rows * (hd / 4);  // float4s of dk, then of dv
  const long long n4 = nk4 + rows * (hdv / 4);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n4; i += stride) {
    const int which = i >= nk4;            // 0: dK, 1: dV
    const int w = which ? hdv : hd;
    const long long j = i - which * nk4;
    const long long r = j / (w / 4);       // row (b, s, kv head)
    const int d = static_cast<int>(j % (w / 4)) * 4;
    const float* src = (which ? part_v : part_k) + r * G * w + d;
    float4 acc = ld4(src);
    for (int g0 = 1; g0 < G; g0 += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g0 + u < G) x[u] = ld4(src + static_cast<size_t>(g0 + u) * w);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g0 + u < G) {
          acc.x += x[u].x; acc.y += x[u].y; acc.z += x[u].z; acc.w += x[u].w;
        }
    }
    st4((which ? dv : dk) + r * w + d, acc);
  }
}

// ---------------------------------------------------------------- bfloat16

namespace tc {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
// named barriers of the dkdv blocks' P dtanh exchange (0 is __syncthreads)
constexpr int kXFull = 1, kXEmpty = 2;

// The equal-dim instances (HDQK = HDV = 64, 128, 256): q, k, v and dO in
// 64-column (128-byte, 128-byte-swizzled) chunks.  MLA's (96, 64) has
// kernels of their own (MlaDkdvCfg, MlaDqCfg below).
template <int HDQK, int HDV>
struct DkdvCfg {
  static constexpr int BK = 64;                  // keys a block, resident
  static constexpr int BQ = 64;                  // query rows a stage
  static constexpr int NS = HDQK == 256 ? 2 : 3; // stages of the Q/dO ring
  static constexpr int CHUNKS = HDQK / 64;       // column chunks of a row
  static constexpr int K_BYTES = BK * HDQK * 2;  // K, resident
  static constexpr int V_BYTES = BK * HDV * 2;   // V, resident
  static constexpr int Q_BYTES = BQ * HDQK * 2;  // one Q stage
  static constexpr int G_BYTES = BQ * HDV * 2;   // one dO stage
  static constexpr int X_BYTES = BK * BQ * 4;    // float32 P dtanh exchange
  static constexpr int L_BYTES = 2 * BQ * 4;     // a stage's lse and delta
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the swizzled tiles start on 1024-byte boundaries
  static constexpr int SMEM = 1024 + K_BYTES + V_BYTES +
                              NS * (Q_BYTES + G_BYTES) + X_BYTES +
                              NS * L_BYTES + BAR_BYTES;
};

template <int HDQK, int HDV>
struct DqCfg {
  static constexpr int BQ = 128;                 // query rows a block
  static constexpr int BK = HDQK == 256 ? 32 : 64;  // keys a stage
  static constexpr int NS = HDQK == 256 ? 2 : 3; // stages of the K/V ring
  static constexpr int CHUNKS = HDQK / 64;
  static constexpr int Q_BYTES = BQ * HDQK * 2;  // Q, resident
  static constexpr int G_BYTES = BQ * HDV * 2;   // dO, resident
  static constexpr int K_BYTES = BK * HDQK * 2;  // one K stage
  static constexpr int V_BYTES = BK * HDV * 2;   // one V stage
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  static constexpr int SMEM = 1024 + Q_BYTES + G_BYTES +
                              NS * (K_BYTES + V_BYTES) + BAR_BYTES;
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

// Rows ka (in_a) and ka + 8 (in_b) of a thread's m64nN accumulator (NA =
// N / 2 registers) times mul, from ra, rows ``stride`` elements apart:
// float32 pairs, or bf16 pairs rounded once.
template <int NA>
__device__ __forceinline__ void store_rows(float* ra, size_t stride,
                                           const float (&acc)[NA], float mul,
                                           bool in_a, bool in_b) {
  float* rb = ra + 8 * stride;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    if (in_a)
      *reinterpret_cast<float2*>(ra + 8 * j) =
          make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (in_b)
      *reinterpret_cast<float2*>(rb + 8 * j) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

template <int NA>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ra, size_t stride,
                                           const float (&acc)[NA], float mul,
                                           bool in_a, bool in_b) {
  __nv_bfloat16* rb = ra + 8 * stride;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    if (in_a)
      *reinterpret_cast<uint32_t*>(ra + 8 * j) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (in_b)
      *reinterpret_cast<uint32_t*>(rb + 8 * j) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
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
template <int HDQK, int HDV>
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
  using C = DkdvCfg<HDQK, HDV>;
  constexpr int BK = C::BK, BQ = C::BQ, NS = C::NS, HD = HDQK;
  static_assert(HDQK == HDV, "MLA's (96, 64) has kernels of its own");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + C::K_BYTES;
  const uint32_t sQ = sV + C::V_BYTES;           // NS stages of Q
  const uint32_t sG = sQ + NS * C::Q_BYTES;      // NS stages of dO
  const uint32_t sX = sG + NS * C::G_BYTES;      // the exchange
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
        mbar_expect_tx(kv_full, C::K_BYTES + C::V_BYTES);
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
          mbar_expect_tx(bar, C::Q_BYTES + C::G_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load(sQ + s * C::Q_BYTES + c * BQ * 128, &tq, bar, c * 64,
                     h, q0, b);
            tma_load(sG + s * C::G_BYTES + c * BQ * 128, &tdo, bar, c * 64,
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
template <int HDQK, int HDV>
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
  using C = DqCfg<HDQK, HDV>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS, HD = HDQK;
  static_assert(HDQK == HDV, "MLA's (96, 64) has kernels of its own");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + C::Q_BYTES;            // dO
  const uint32_t sK = sG + C::G_BYTES;            // NS stages
  const uint32_t sV = sK + NS * C::K_BYTES;       // NS stages
  const uint32_t q_full = sV + NS * C::V_BYTES;   // then full[NS], empty[NS]
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
      mbar_expect_tx(q_full, C::Q_BYTES + C::G_BYTES);
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c) {
        tma_load(sQ + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
        tma_load(sG + c * BQ * 128, &tdo, q_full, c * 64, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, C::K_BYTES + C::V_BYTES);
        const int k0 = (t_lo + i) * BK;
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(sK + s * C::K_BYTES + c * BK * 128, &tk, bar, c * 64, kh,
                   k0, b);
          tma_load(sV + s * C::V_BYTES + c * BK * 128, &tv, bar, c * 64, kh,
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
    // this warpgroup's 64 rows of Q and of dO (chunk c at + c BQ 128)
    const uint32_t sQw = sQ + (wg - 1) * 64 * 128;
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
        const uint32_t kst = sK + s * C::K_BYTES;
        const uint32_t vst = sV + s * C::V_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;  // 16 columns of a chunk
          wgmma_ss(sc, sw128_desc(sQw + (ks / 4) * BQ * 128 + off, 16, 1024),
                   sw128_desc(kst + (ks / 4) * BK * 128 + off, 16, 1024), 1);
        }
#pragma unroll
        for (int ks = 0; ks < HDV / 16; ++ks) {
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

// ----------------------------------------- MLA's backward: q.k 96, v 64
//
// minicpm3-4b's training attends per head with q and k rows of 96 columns
// and v rows of 64.  A kept pair costs 640 FLOP in dkdv (S^T and dK over
// 96, dP^T and dV over 64) and 512 in dq, so at 64 x 64 tiles a product is
// short, and the exponentials and the dS arithmetic between the products
// take about as long as the products themselves.  The two kernels below
// keep each consumer warpgroup on its own rows of one item end to end, so
// that its elementwise work runs under its own products and under the
// other warpgroup's, and nothing is exchanged between warpgroups:
//   - dkdv: an item is BK = 128 keys of one (batch, head), K and V resident;
//     each of the two consumer warpgroups owns 64 of the keys and computes
//     all four products for them (S^T = K . Q^T over 96, dP^T = V . dO^T
//     over 64, dV += P^T . dO at N 64, dK += dS^T . Q at N 96), so one
//     64-row Q/dO stage of the ring feeds 128 keys.  Registers: dV 32, dK
//     48, S^T 32, dP^T 32, the bf16 fragments of P^T and dS^T 16 + 16.
//   - dq: an item is BQ = 64 NWG query rows of one (batch, head), Q and dO
//     resident; each consumer warpgroup owns 64 rows (S = Q . K^T over 96,
//     dP = dO . V^T over 64, dQ += dS . K at N 96); K/V stages of 64 keys.
//     Registers: dQ 48, S 32, dP 32, the bf16 fragments of dS 16.
//   - inside a warpgroup, step i issues S(i), then stage i - 1's
//     accumulating products, then dP(i), as three commit groups; P's
//     exponentials run as soon as S(i) lands (wgmma.wait_group 2: the
//     accumulating products and dP(i) still in flight), dS after dP(i), so
//     that the tensor cores hold this warpgroup's work while its threads
//     compute.  The scale and log2 e fold into the exponent, p = ex2(s c -
//     lse log2 e), one FFMA before a bare MUFU.EX2 (as the forward's
//     flash_fwd_mla_kernel); a stage that crosses a mask edge, or any stage
//     with a softcap, takes a general path that scores, caps and masks
//     element by element after both products have landed;
//   - every product is issued on a path that ptxas can see is the same for
//     the whole warpgroup: the warpgroup index comes through __shfl_sync
//     (warp-uniform), and the step loop is peeled (the first stage's S and
//     dP before it, the last stage's accumulating products after it), so
//     that no wgmma sits under a condition inside the loop.  With products
//     issued under such conditions ptxas serializes the kernel's wgmma
//     instructions (its notes C7520, "compiler-inserted WG.AR in divergent
//     path", and, with the index alone, C7514, accumulator registers read
//     between start and end of the pipeline stage), which chip_smoke.py's
//     bwd_build refuses: on an H100 dkdv and dq then take about 1.0 ms
//     together against 0.73 peeled;
//   - tried and not kept: the two warpgroups taking turns at issuing their
//     products (named barriers, a turn a stage), whose products sit under
//     conditions (ptxas serialized it too, C7515; it was slower still);
//     three consumer warpgroups (192 keys or rows an item), which at 160
//     registers a consumer spill in both kernels; K in dq as a 64-column
//     128-byte box and a 32-column 64-byte one (two products a k16 step),
//     slower than three 32-column boxes (both measured before the loop was
//     peeled);
//   - a warpgroup skips the products of a stage that every mask empties for
//     its own rows (the causal diagonal, a window, rows or keys past S) but
//     still waits for the stage and arrives on its empty barrier;
//   - q's and k's 96 columns come in as three 32-column boxes with 64-byte
//     swizzle (one tensor map each), so that dK += dS^T . Q and dQ += dS .
//     K are one m64n96k16 product a k16 step with Q or K as the MN-major B
//     (atoms a box apart); v and dO in one 64-column 128-byte-swizzled box;
//   - the grid is persistent, one block an SM: a block walks every
//     gridDim.x-th *pair* of items of one (batch, head), tile t and tile
//     n - 1 - t (``mla_bwd_item``), the longer first, so that under the
//     causal mask every pair costs the same (at minicpm3-4b's microbatch
//     127 + 3 = 130 warpgroup stages in dkdv); the pairs are (batch,
//     head)-major, so that the ~132 in flight share the Q and dO (dkdv) or
//     K and V (dq) of about 8 heads through L2.  The forward's order (single
//     items, longest first, rotated by the head) gives a makespan of 846
//     stages an SM against the pairs' 650, the ideal being 630
//     (``bwd_schedule``); the producer loads the next item's resident tiles
//     behind an empty barrier of their own while the consumers finish the
//     current item's last products and its epilogue, and the ring's stage
//     and phase count on across items.
// At minicpm3-4b's microbatch (B 1, S 4096, 40 heads over 40, causal): dkdv
// 1,280 items in 640 pairs on 132 blocks, 83,200 warpgroup stages of 4096
// pairs, makespan 650; dq the same at NWG 2.  Shared memory: dkdv 123 KB
// (K 24 KB and V 16 KB resident, four Q/dO stages of 12 + 8 KB with their
// lse and delta), dq 121 KB (Q 24 KB, dO 16 KB, four K/V stages of 12 + 8
// KB).  Registers: 168 a thread at launch, the producer at 40 and the
// consumers at 232 after setmaxnreg.
struct MlaDkdvCfg {
  static constexpr int HDQK = 96;
  static constexpr int HDV = 64;
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int BK = 64 * NWG;              // keys an item, resident
  static constexpr int BQ = 64;                    // query rows a stage
  static constexpr int NS = 4;                     // stages of the Q/dO ring
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int CW = 32;                    // q/k box columns
  static constexpr int CHUNKS = HDQK / CW;         // q/k boxes
  static constexpr int K_BYTES = BK * HDQK * 2;    // K, resident
  static constexpr int V_BYTES = BK * HDV * 2;     // V, resident
  static constexpr int Q_BYTES = BQ * HDQK * 2;    // one Q stage
  static constexpr int G_BYTES = BQ * HDV * 2;     // one dO stage
  static constexpr int L_BYTES = 2 * BQ * 4;       // a stage's lse and delta
  static constexpr int BAR_BYTES = 8 * (2 + 2 * NS);
  static constexpr int SMEM = 1024 + K_BYTES + V_BYTES +
                              NS * (Q_BYTES + G_BYTES) + NS * L_BYTES +
                              BAR_BYTES;
};

struct MlaDqCfg {
  static constexpr int HDQK = 96;
  static constexpr int HDV = 64;
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int BQ = 64 * NWG;              // query rows an item
  static constexpr int BK = 64;                    // keys a stage
  static constexpr int NS = 4;                     // stages of the K/V ring
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int CW = 32;                    // q/k box columns
  static constexpr int CHUNKS = HDQK / CW;         // q/k boxes
  static constexpr int Q_BYTES = BQ * HDQK * 2;    // Q, resident
  static constexpr int G_BYTES = BQ * HDV * 2;     // dO, resident
  static constexpr int K_BYTES = BK * HDQK * 2;    // one K stage
  static constexpr int V_BYTES = BK * HDV * 2;     // one V stage
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int BAR_BYTES = 8 * (2 + 2 * NS);
  static constexpr int SMEM = 1024 + Q_BYTES + G_BYTES + NS * STAGE_BYTES +
                              BAR_BYTES;
};

// An item of MLA's persistent backward: tile t0 (the item's first key in
// dkdv, its first query row in dq) of one (batch, head), and the stages
// [t_lo, t_lo + n) of the other side that some pair of it may keep.
struct MlaBwdItem {
  int t0, b, h, kh, t_lo, n;
};

// The number of items of pair ``unit`` (units are (batch, head)-major, np
// a (batch, head)): tiles p and nt - 1 - p of the nt tiles of a (batch,
// head), one item where they meet.
__device__ __forceinline__ int mla_bwd_items(int unit, int np, int nt) {
  const int p = unit % np;
  return nt - 1 - p == p ? 1 : 2;
}

__device__ __forceinline__ MlaBwdItem mla_bwd_item(int unit, int half, int np,
                                                   int nt, int tile_rows,
                                                   int stage_rows,
                                                   bool dkdv, int S, int H,
                                                   int KV, int causal,
                                                   int window) {
  MlaBwdItem it;
  const int bh = unit / np, p = unit % np;
  const int first = dkdv ? p : nt - 1 - p;
  it.t0 = (half ? nt - 1 - first : first) * tile_rows;
  it.b = bh / H;
  it.h = bh % H;
  it.kh = it.h / (H / KV);
  int lo, hi;
  if (dkdv) {   // query rows that some key of the item may be attended from
    lo = causal ? it.t0 : 0;
    hi = window ? min(S, it.t0 + tile_rows - 1 + window) : S;
  } else {      // keys that some row of the item may attend
    hi = causal ? min(S, it.t0 + tile_rows) : S;
    lo = window ? max(0, it.t0 - window + 1) : 0;
  }
  it.t_lo = lo / stage_rows;
  it.n = (hi + stage_rows - 1) / stage_rows - it.t_lo;
  return it;
}

// S^T = K . Q^T over 96 columns for a warpgroup's 64 keys (A, K-major)
// and a stage's 64 query rows (B, K-major): two k16 steps (32 bytes) in
// each 64-byte-swizzled 32-column box, K's boxes abox bytes apart, Q's
// bbox.
__device__ __forceinline__ void mla_bwd_issue_s(float (&sc)[32], uint32_t a,
                                                uint32_t abox, uint32_t b,
                                                uint32_t bbox) {
#pragma unroll
  for (int ks = 0; ks < 6; ++ks) {
    const uint32_t off = (ks % 2) * 32;
    wgmma_ss(sc, sw64_desc(a + (ks / 2) * abox + off, 512),
             sw64_desc(b + (ks / 2) * bbox + off, 512), ks > 0);
  }
}

// dP^T = V . dO^T over 64 columns, both operands K-major in one
// 128-byte-swizzled box.
__device__ __forceinline__ void mla_bwd_issue_dp(float (&dp)[32], uint32_t a,
                                                 uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss(dp, sw128_desc(a + ks * 32, 16, 1024),
             sw128_desc(b + ks * 32, 16, 1024), ks > 0);
}

// acc (m64n96) += A . B over 64 rows of B: A the bf16 fragments f (four a
// k16 step), B MN-major in three 32-column atoms ``atoms`` bytes apart.
__device__ __forceinline__ void mla_bwd_issue_n96(float (&acc)[48],
                                                  const uint32_t (&f)[16],
                                                  uint32_t b, uint32_t atoms) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                           f[4 * kk + 3]};
    wgmma_rs(acc, a, sw64_desc(b + kk * 16 * 64, atoms, 512));
  }
}

// acc (m64n64) += A . B over 64 rows of B: B MN-major in one 128-byte-
// swizzled 64-column box.
__device__ __forceinline__ void mla_bwd_issue_n64(float (&acc)[32],
                                                  const uint32_t (&f)[16],
                                                  uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2],
                           f[4 * kk + 3]};
    wgmma_rs(acc, a, sw128_desc(b + kk * 16 * 128, 64 * 128, 1024));
  }
}

__device__ __forceinline__ void mla_bwd_pack(uint32_t (&f)[16],
                                             const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (four bf16x2 a
// thread), B in shared memory K-major (B^T stored row by row).
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr) : "memory");
  return x;
}

// The wgmma A fragments of a warpgroup's 64 resident rows (thread t: rows
// r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns 16 ks + 2 (t % 4) + {0,
// 1} and + 8 of k16 step ks) read out of a tile as TMA left it: 32-column
// boxes of 64-byte rows with 64-byte swizzle, ``box`` bytes apart (q, k:
// KS 6), or one 64-column box of 128-byte rows with 128-byte swizzle (v,
// dO: KS 4).  The tile starts on a 1024-byte boundary; swizzling XORs the
// 16-byte chunk index (bits 4+) with the row bits above 128 bytes.
template <int KS>
__device__ __forceinline__ void mla_bwd_frags(uint32_t (&f)[4 * KS],
                                              uint32_t tile, uint32_t box,
                                              int t) {
  const uint32_t r = (t / 32) * 16 + (t % 32) / 4, c = 4 * (t % 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t row = r + 8 * (e & 1), col = c + 16 * (e >> 1);
      uint32_t o;
      if constexpr (KS == 6) {       // 64-byte rows: (2 bits) ^ (2 bits)
        o = row * 64 + 32 * (ks % 2) + col;
        o = (ks / 2) * box + (o ^ (((o >> 7) & 3u) << 4));
      } else {                       // 128-byte rows: (3 bits) ^ (3 bits)
        o = row * 128 + 32 * ks + col;
        o ^= ((o >> 7) & 7u) << 4;
      }
      f[4 * ks + e] = lds32(tile + o);
    }
  }
}

// S = A . B^T over 96 columns with A's fragments in registers (f, six k16
// steps) and B K-major in three 64-byte-swizzled 32-column boxes ``bbox``
// bytes apart.
__device__ __forceinline__ void mla_bwd_issue_s_rs(float (&sc)[32],
                                                   const uint32_t (&f)[24],
                                                   uint32_t b, uint32_t bbox) {
#pragma unroll
  for (int ks = 0; ks < 6; ++ks) {
    const uint32_t a[4] = {f[4 * ks], f[4 * ks + 1], f[4 * ks + 2],
                           f[4 * ks + 3]};
    wgmma_rs_k(sc, a, sw64_desc(b + (ks / 2) * bbox + (ks % 2) * 32, 512),
               ks > 0);
  }
}

// dP = A . B^T over 64 columns, A's fragments in registers (four k16
// steps), B K-major in one 128-byte-swizzled box.
__device__ __forceinline__ void mla_bwd_issue_dp_rs(float (&dp)[32],
                                                    const uint32_t (&f)[16],
                                                    uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {f[4 * ks], f[4 * ks + 1], f[4 * ks + 2],
                           f[4 * ks + 3]};
    wgmma_rs_k(dp, a, sw128_desc(b + ks * 32, 16, 1024), ks > 0);
  }
}

// Block layout: warp 0 loads (lane 0 issues every TMA load, the warp
// copies each stage's lse, in log2 units, and delta); consumer warpgroup
// c = 1, 2 owns keys t0 + 64 (c - 1) .. + 63 of each item.  In a consumer
// thread t (warp w, lane l) holds keys ka = 16 w + l / 4 and ka + 8 of
// them; accumulator register 4 j + e of an m64nN product holds column
// 8 j + 2 (l % 4) + (e & 1) of row ka (e < 2) or ka + 8, so the score
// tiles' registers are the A-fragment layout of dV's and dK's products.
// Every consumer warp arrives once on each empty barrier (count 4 NWG).
__global__ void __launch_bounds__(MlaDkdvCfg::THREADS, 1)
flash_bwd_dkdv_mla_kernel(const __grid_constant__ CUtensorMap tq,
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
  using C = MlaDkdvCfg;
  constexpr int BK = C::BK, BQ = C::BQ, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;     // three boxes of BK rows
  const uint32_t sV = sK + C::K_BYTES;
  const uint32_t sQ = sV + C::V_BYTES;            // NS stages of Q
  const uint32_t sG = sQ + NS * C::Q_BYTES;       // NS stages of dO
  const uint32_t sL = sG + NS * C::G_BYTES;       // NS stages of lse, delta
  const uint32_t kv_full = sL + NS * C::L_BYTES;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full0 = kv_empty + 8, empty0 = full0 + 8 * NS;
  float* lds = reinterpret_cast<float*>(smem_raw + (sL - raw));
  const int nk = (S + BK - 1) / BK, np = (nk + 1) / 2;
  const int n_units = np * B * H;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 4 * C::NWG);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform (as the compiler sees it), so that the warpgroup's
  // branches around its wgmma products are not divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: warp 0
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int g = 0, j = 0;   // Q/dO stages filled, items begun
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        for (int half = 0; half < mla_bwd_items(u, np, nk); ++half, ++j) {
          const MlaBwdItem it = mla_bwd_item(u, half, np, nk, BK, BQ, true, S,
                                             H, KV, causal, window);
          mbar_wait(kv_empty, (j & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(kv_full, C::K_BYTES + C::V_BYTES);
#pragma unroll
            for (int c = 0; c < C::CHUNKS; ++c)
              tma_load(sK + c * BK * 64, &tk, kv_full, c * C::CW, it.kh, it.t0,
                       it.b);
            tma_load(sV, &tv, kv_full, 0, it.kh, it.t0, it.b);
          }
          const size_t r_off = (static_cast<size_t>(it.b) * H + it.h) * S;
          for (int i = 0; i < it.n; ++i, ++g) {
            const int s = g % NS;
            const int q0 = (it.t_lo + i) * BQ;
            mbar_wait(empty0 + 8 * s, ((g / NS) & 1) ^ 1);
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
              mbar_expect_tx(bar, C::Q_BYTES + C::G_BYTES);
#pragma unroll
              for (int c = 0; c < C::CHUNKS; ++c)
                tma_load(sQ + s * C::Q_BYTES + c * BQ * 64, &tq, bar,
                         c * C::CW, it.h, q0, it.b);
              tma_load(sG + s * C::G_BYTES, &tdo, bar, 0, it.h, q0, it.b);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int col0 = 2 * (lane % 4);
  const float cl = scale * kLog2e;
  const uint32_t sKw = sK + c * 64 * 64;          // this warpgroup's keys
  const uint32_t sVw = sV + c * 64 * 128;
  int g = 0, j = 0;   // Q/dO stages consumed, items begun
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    for (int half = 0; half < mla_bwd_items(u, np, nk); ++half, ++j) {
      const MlaBwdItem it = mla_bwd_item(u, half, np, nk, BK, BQ, true, S, H,
                                         KV, causal, window);
      const int kw0 = it.t0 + 64 * c;              // this warpgroup's keys
      const int ka = kw0 + (t / 32) * 16 + lane / 4, kb = ka + 8;
      // the stages with a pair of this warpgroup to add: [a, e); the
      // causal mask empties a prefix, the window a suffix
      auto q0_of = [&](int i) { return (it.t_lo + i) * BQ; };
      auto dead = [&](int i) {
        const int q0 = q0_of(i);
        return kw0 >= S || (causal && q0 + BQ - 1 < kw0) ||
               (window && q0 - window >= kw0 + 63);
      };
      int a = 0, e = it.n;
      while (a < e && dead(a)) ++a;
      while (e > a && dead(e - 1)) --e;
      auto slot = [&](int i) { return (g + i) % NS; };
      auto wait_full = [&](int i) {
        mbar_wait(full0 + 8 * slot(i), ((g + i) / NS) & 1);
      };
      auto release = [&](int i) {
        if (lane == 0) mbar_arrive(empty0 + 8 * slot(i));
      };
      auto general = [&](int i) {
        const int q0 = q0_of(i);
        return softcap != 0.f || q0 + BQ > S || kw0 + 64 > S ||
               (causal && kw0 + 63 > q0) ||
               (window && kw0 <= q0 + BQ - 1 - window);
      };

      float acc_v[32], acc_k[48];                  // dV, dK of this thread
#pragma unroll
      for (int x = 0; x < 32; ++x) acc_v[x] = 0.f;
#pragma unroll
      for (int x = 0; x < 48; ++x) acc_k[x] = 0.f;
      mbar_wait(kv_full, j & 1);
      // S^T and dP^T of stage i, K and V (this warpgroup's rows) as A
      auto issue_s = [&](float (&sc)[32], int i) {
        mla_bwd_issue_s(sc, sKw, BK * 64, sQ + slot(i) * C::Q_BYTES, BQ * 64);
      };
      auto issue_dp = [&](float (&dp)[32], int i) {
        mla_bwd_issue_dp(dp, sVw, sG + slot(i) * C::G_BYTES);
      };
      for (int i = 0; i < a; ++i) {
        wait_full(i);
        release(i);
      }
      if (a < e) {
        float sc[32], dp[32];
        uint32_t pf[16], df[16];
        // stage i's P^T and dS^T from S^T (landed) and dP^T (in flight
        // with stage i - 1's accumulating products), rounded to bf16 in
        // registers; then stage i - 1's ring slot is free
        auto step = [&](int i) {
          fence_regs(sc);
          const float* ls = lds + slot(i) * 2 * BQ;
          const bool gen = general(i);
          if (!gen) {
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int qc = 8 * (x / 4) + col0 + (x & 1);
              sc[x] = ex2(fmaf(sc[x], cl, -ls[qc]));
            }
          }
          wgmma_wait<0>();
          fence_regs(dp);
          if (i > a) release(i - 1);
          if (i + 1 == e && lane == 0) mbar_arrive(kv_empty);
          if (gen) {
            // scores, caps and masks element by element
            const int q0 = q0_of(i);
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int qc = 8 * (x / 4) + col0 + (x & 1);
              const int qi = q0 + qc, kj = (x & 2) ? kb : ka;
              float dt;
              const float y = score_log2(sc[x], scale, softcap, dt);
              bool ok = qi < S && kj < S;
              if (causal) ok = ok && kj <= qi;
              if (window) ok = ok && kj > qi - window;
              const float p = ok ? ex2(y - ls[qc]) : 0.f;
              sc[x] = p;
              dp[x] = p * dt * (dp[x] - ls[BQ + qc]);
            }
          } else {
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int qc = 8 * (x / 4) + col0 + (x & 1);
              dp[x] = sc[x] * (dp[x] - ls[BQ + qc]);
            }
          }
          mla_bwd_pack(pf, sc);
          mla_bwd_pack(df, dp);
        };
        // dV += P^T . dO and dK += dS^T . Q of stage i, the stage's dO and
        // Q as the MN-major B
        auto issue_acc = [&](int i) {
          mla_bwd_issue_n64(acc_v, pf, sG + slot(i) * C::G_BYTES);
          mla_bwd_issue_n96(acc_k, df, sQ + slot(i) * C::Q_BYTES, BQ * 64);
          wgmma_commit();
        };
        wait_full(a);
        wgmma_fence();
        issue_s(sc, a);
        wgmma_commit();
        issue_dp(dp, a);
        wgmma_commit();
        wgmma_wait<1>();
        step(a);
        for (int i = a + 1; i < e; ++i) {
          // S^T(i), then stage i - 1's accumulating products and dP^T(i)
          // run on while P^T(i) is computed
          wait_full(i);
          wgmma_fence();
          issue_s(sc, i);
          wgmma_commit();
          issue_acc(i - 1);
          issue_dp(dp, i);
          wgmma_commit();
          wgmma_wait<2>();
          step(i);
        }
        wgmma_fence();
        issue_acc(e - 1);
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
        release(e - 1);
      } else if (lane == 0) {
        mbar_arrive(kv_empty);
      }
      for (int i = e; i < it.n; ++i) {
        wait_full(i);
        release(i);
      }
      g += it.n;

      // epilogue, while the producer loads the next item's K and V: dK
      // carries the scale (q * scale in the product)
      const size_t row = static_cast<size_t>(it.b) * S + ka;
      if (part != nullptr) {
        // this head's float32 partials: dK's [B, S, H, 96], then dV's
        // [B, S, H, 64]
        const size_t sk = static_cast<size_t>(H) * C::HDQK;
        const size_t sv = static_cast<size_t>(H) * C::HDV;
        store_rows(part + static_cast<size_t>(B) * S * sk + row * sv +
                       static_cast<size_t>(it.h) * C::HDV + col0,
                   sv, acc_v, 1.f, ka < S, kb < S);
        store_rows(part + row * sk + static_cast<size_t>(it.h) * C::HDQK +
                       col0,
                   sk, acc_k, scale, ka < S, kb < S);
      } else {
        // G = 1: the head is the group; round once to bf16
        const size_t sk = static_cast<size_t>(KV) * C::HDQK;
        const size_t sv = static_cast<size_t>(KV) * C::HDV;
        store_rows(dv + row * sv + static_cast<size_t>(it.kh) * C::HDV + col0,
                   sv, acc_v, 1.f, ka < S, kb < S);
        store_rows(dk + row * sk + static_cast<size_t>(it.kh) * C::HDQK +
                       col0,
                   sk, acc_k, scale, ka < S, kb < S);
      }
    }
  }
}

// Block layout: thread 0 (warpgroup 0) loads; consumer warpgroup w = 1 ..
// NWG owns query rows t0 + 64 (w - 1) .. + 63 of each item, thread t rows
// qa = 16 (t / 32) + (t % 32) / 4 and qa + 8 of them (the forward's
// layout).  Every consumer warp arrives once on each empty barrier.
__global__ void __launch_bounds__(MlaDqCfg::THREADS, 1)
flash_bwd_dq_mla_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int B, int S, int H,
                        int KV, float scale, int causal, int window,
                        float softcap) {
  using C = MlaDqCfg;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // three boxes
  const uint32_t sG = sQ + C::Q_BYTES;            // dO
  const uint32_t sK = sG + C::G_BYTES;            // NS stages [K | V]
  const uint32_t q_full = sK + NS * C::STAGE_BYTES;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * NS;
  const int nq = (S + BQ - 1) / BQ, np = (nq + 1) / 2;
  const int n_units = np * B * H;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * C::NWG);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform (as the compiler sees it), so that the warpgroup's
  // branches around its wgmma products are not divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int g = 0, j = 0;   // K/V stages filled, items begun
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        for (int half = 0; half < mla_bwd_items(u, np, nq); ++half, ++j) {
          const MlaBwdItem it = mla_bwd_item(u, half, np, nq, BQ, BK, false,
                                             S, H, KV, causal, window);
          mbar_wait(q_empty, (j & 1) ^ 1);
          mbar_expect_tx(q_full, C::Q_BYTES + C::G_BYTES);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load(sQ + c * BQ * 64, &tq, q_full, c * C::CW, it.h, it.t0,
                     it.b);
          tma_load(sG, &tdo, q_full, 0, it.h, it.t0, it.b);
          for (int i = 0; i < it.n; ++i, ++g) {
            const int s = g % NS;
            mbar_wait(empty0 + 8 * s, ((g / NS) & 1) ^ 1);
            const uint32_t bar = full0 + 8 * s, st = sK + s * C::STAGE_BYTES;
            const int k0 = (it.t_lo + i) * BK;
            mbar_expect_tx(bar, C::STAGE_BYTES);
#pragma unroll
            for (int c = 0; c < C::CHUNKS; ++c)
              tma_load(st + c * BK * 64, &tk, bar, c * C::CW, it.kh, k0, it.b);
            tma_load(st + C::K_BYTES, &tv, bar, 0, it.kh, k0, it.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
  const int w = wg - 1;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int col0 = 2 * (lane % 4);
  const float cl = scale * kLog2e;
  const uint32_t sQw = sQ + w * 64 * 64;          // this warpgroup's rows
  const uint32_t sGw = sG + w * 64 * 128;
  const size_t q_stride = static_cast<size_t>(H) * C::HDQK;
  int g = 0, j = 0;   // K/V stages consumed, items begun
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    for (int half = 0; half < mla_bwd_items(u, np, nq); ++half, ++j) {
      const MlaBwdItem it = mla_bwd_item(u, half, np, nq, BQ, BK, false, S,
                                         H, KV, causal, window);
      const int row_lo = it.t0 + 64 * w;           // this warpgroup's rows
      const int qa = row_lo + (t / 32) * 16 + lane / 4, qb = qa + 8;
      const size_t r_off = (static_cast<size_t>(it.b) * H + it.h) * S;
      const float l_a = qa < S ? lse[r_off + qa] * kLog2e : 0.f;
      const float l_b = qb < S ? lse[r_off + qb] * kLog2e : 0.f;
      const float d_a = qa < S ? delta[r_off + qa] : 0.f;
      const float d_b = qb < S ? delta[r_off + qb] : 0.f;
      // the stages with a pair of this warpgroup to add: [a, e); the
      // window empties a prefix, the causal mask a suffix
      auto k0_of = [&](int i) { return (it.t_lo + i) * BK; };
      auto dead = [&](int i) {
        const int k0 = k0_of(i);
        return row_lo >= S || (causal && k0 > row_lo + 63) ||
               (window && k0 + BK - 1 <= row_lo - window);
      };
      int a = 0, e = it.n;
      while (a < e && dead(a)) ++a;
      while (e > a && dead(e - 1)) --e;
      auto slot = [&](int i) { return (g + i) % NS; };
      auto stage = [&](int i) { return sK + slot(i) * C::STAGE_BYTES; };
      auto wait_full = [&](int i) {
        mbar_wait(full0 + 8 * slot(i), ((g + i) / NS) & 1);
      };
      auto release = [&](int i) {
        if (lane == 0) mbar_arrive(empty0 + 8 * slot(i));
      };
      auto general = [&](int i) {
        const int k0 = k0_of(i);
        return softcap != 0.f || k0 + BK > S || row_lo + 64 > S ||
               (causal && k0 + BK - 1 > row_lo) ||
               (window && k0 <= row_lo + 63 - window);
      };

      float acc[48];                               // dQ of this thread
#pragma unroll
      for (int x = 0; x < 48; ++x) acc[x] = 0.f;
      mbar_wait(q_full, j & 1);
      // this warpgroup's rows of Q and dO as the A fragments of S and dP,
      // in registers for the whole item: the buffer is free for the next
      // item's at once
      uint32_t qf[24], gf[16];
      mla_bwd_frags<6>(qf, sQw, BQ * 64, t);
      mla_bwd_frags<4>(gf, sGw, 0, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
      auto issue_s = [&](float (&sc)[32], int i) {
        mla_bwd_issue_s_rs(sc, qf, stage(i), BK * 64);
      };
      auto issue_dp = [&](float (&dp)[32], int i) {
        mla_bwd_issue_dp_rs(dp, gf, stage(i) + C::K_BYTES);
      };
      for (int i = 0; i < a; ++i) {
        wait_full(i);
        release(i);
      }
      if (a < e) {
        float sc[32], dp[32];
        uint32_t df[16];
        // stage i's dS from S (landed) and dP (in flight with stage i - 1's
        // dQ product), rounded to bf16 in registers; then stage i - 1's
        // ring slot is free
        auto step = [&](int i) {
          fence_regs(sc);
          const bool gen = general(i);
          if (!gen) {
#pragma unroll
            for (int x = 0; x < 32; ++x)
              sc[x] = ex2(fmaf(sc[x], cl, (x & 2) ? -l_b : -l_a));
          }
          wgmma_wait<0>();
          fence_regs(dp);
          if (i > a) release(i - 1);
          if (gen) {
            const int k0 = k0_of(i);
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int kj = k0 + 8 * (x / 4) + col0 + (x & 1);
              const int qi = (x & 2) ? qb : qa;
              float dt;
              const float y = score_log2(sc[x], scale, softcap, dt);
              bool ok = qi < S && kj < S;
              if (causal) ok = ok && kj <= qi;
              if (window) ok = ok && kj > qi - window;
              const float p = ok ? ex2(y - ((x & 2) ? l_b : l_a)) : 0.f;
              dp[x] = p * dt * (dp[x] - ((x & 2) ? d_b : d_a));
            }
          } else {
#pragma unroll
            for (int x = 0; x < 32; ++x)
              dp[x] = sc[x] * (dp[x] - ((x & 2) ? d_b : d_a));
          }
          mla_bwd_pack(df, dp);
        };
        // dQ += dS . K of stage i, the stage's K as the MN-major B
        auto issue_acc = [&](int i) {
          mla_bwd_issue_n96(acc, df, stage(i), BK * 64);
          wgmma_commit();
        };
        wait_full(a);
        wgmma_fence();
        issue_s(sc, a);
        wgmma_commit();
        issue_dp(dp, a);
        wgmma_commit();
        wgmma_wait<1>();
        step(a);
        for (int i = a + 1; i < e; ++i) {
          // S(i), then stage i - 1's dQ product and dP(i) run on while
          // P(i) is computed
          wait_full(i);
          wgmma_fence();
          issue_s(sc, i);
          wgmma_commit();
          issue_acc(i - 1);
          issue_dp(dp, i);
          wgmma_commit();
          wgmma_wait<2>();
          step(i);
        }
        wgmma_fence();
        issue_acc(e - 1);
        wgmma_wait<0>();
        fence_regs(acc);
        release(e - 1);
      }
      for (int i = e; i < it.n; ++i) {
        wait_full(i);
        release(i);
      }
      g += it.n;

      // epilogue, while the producer loads the next item: dq = scale * acc,
      // rounded once to bf16
      store_rows(dq + (static_cast<size_t>(it.b) * S + qa) * q_stride +
                     static_cast<size_t>(it.h) * C::HDQK + col0,
                 q_stride, acc, scale, qa < S, qb < S);
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch

template <typename T, int HDQK, int HDV>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                int B, int S, int H, int KV, float scale, int causal,
                int window, float softcap, cudaStream_t stream) {
  using C = Tiles<HDQK, HDV>;
  const int smem = static_cast<int>(sizeof(float)) * C::DKDV_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HDQK, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BK - 1) / C::BK, KV, B);
  flash_bwd_dkdv_kernel<T, HDQK, HDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDQK, int HDV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int H, int KV, float scale, int causal, int window,
              float softcap, cudaStream_t stream) {
  using C = Tiles<HDQK, HDV>;
  const int smem = static_cast<int>(sizeof(float)) * C::DQ_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HDQK, HDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  flash_bwd_dq_kernel<T, HDQK, HDV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// A bf16 [B, S, heads, hd] tensor as a 4-D tensor map, innermost first;
// boxes of {cols columns, 1 head, rows, 1 batch}: 64 columns (128 bytes)
// with 128-byte swizzle, or 32 (64 bytes) with 64-byte swizzle;
// out-of-range rows read as zero.
CUresult make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                  int B, int S, int heads, int hd, int rows, int cols = 64) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The four tensor maps of a bf16 launch: q and dO with boxes of q_rows
// rows, k and v with boxes of k_rows rows; q and k (head dim hd) in chunks
// of qk_cols columns, dO and v (hdv) in chunks of 64.
int make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
              const void* k, const void* v, int B, int S, int H, int KV,
              int hd, int hdv, int qk_cols, int q_rows, int k_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUresult r = make_map(enc, &m[0], q, B, S, H, hd, q_rows, qk_cols);
  if (r == CUDA_SUCCESS) r = make_map(enc, &m[1], dout, B, S, H, hdv, q_rows);
  if (r == CUDA_SUCCESS) r = make_map(enc, &m[2], k, B, S, KV, hd, k_rows, qk_cols);
  if (r == CUDA_SUCCESS) r = make_map(enc, &m[3], v, B, S, KV, hdv, k_rows);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HDQK, int HDV>
int launch_dkdv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, float* part, int B, int S, int H,
                   int KV, float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  using C = tc::DkdvCfg<HDQK, HDV>;
  CUtensorMap m[4];
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, HDQK, HDV, 64, C::BQ,
                     C::BK);
  if (rc != 0) return rc;
  auto kernel = tc::flash_bwd_dkdv_wgmma_kernel<HDQK, HDV>;
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

template <int HDQK, int HDV>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int S, int H, int KV, float scale,
                 int causal, int window, float softcap, cudaStream_t stream) {
  using C = tc::DqCfg<HDQK, HDV>;
  CUtensorMap m[4];
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, HDQK, HDV, 64, C::BQ,
                     C::BK);
  if (rc != 0) return rc;
  auto kernel = tc::flash_bwd_dq_wgmma_kernel<HDQK, HDV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (S + C::BQ - 1) / C::BQ;
  kernel<<<nq * B * H, tc::kThreads, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), B,
      S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// The grid of MLA's persistent kernels: one block for each of the
// ``units`` pairs of items, at most as many as fit on the card at once.
// That bound (SMs times resident blocks) is asked of the runtime once a
// kernel and device, on the first launch there.
template <auto kernel>
int persistent_grid(int threads, int smem, long long units, int* grid) {
  constexpr int kDevices = 64;
  static int most[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device < 0 || device >= kDevices))
    err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && most[device] == 0) {
    int sms = 0, resident = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                          threads, smem);
    if (err == cudaSuccess) most[device] = sms * resident;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bound = most[device];
  *grid = static_cast<int>(units < bound ? units : bound);
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// MLA's (96, 64) bf16 dkdv: q and k through 32-column maps (64-byte
// swizzle), v and dO through 64-column ones; K and V boxes of an item's
// 128 keys, Q and dO boxes of a stage's 64 rows.
int launch_dkdv_mla(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, float* part, int B, int S, int H,
                    int KV, float scale, int causal, int window, float softcap,
                    cudaStream_t stream) {
  using C = tc::MlaDkdvCfg;
  CUtensorMap m[4];
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, C::HDQK, C::HDV, C::CW,
                     C::BQ, C::BK);
  if (rc != 0) return rc;
  const long long units = static_cast<long long>((S + C::BK - 1) / C::BK + 1) /
                          2 * B * H;
  int grid = 0;
  rc = persistent_grid<tc::flash_bwd_dkdv_mla_kernel>(C::THREADS, C::SMEM,
                                                    units, &grid);
  if (rc != 0) return rc;
  tc::flash_bwd_dkdv_mla_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, B, S, H, KV, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// MLA's (96, 64) bf16 dq: Q and dO boxes of an item's BQ rows, K and V
// boxes of a stage's 64 keys.
int launch_dq_mla(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int S, int H, int KV, float scale,
                  int causal, int window, float softcap, cudaStream_t stream) {
  using C = tc::MlaDqCfg;
  CUtensorMap m[4];
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, C::HDQK, C::HDV, C::CW,
                     C::BQ, C::BK);
  if (rc != 0) return rc;
  const long long units = static_cast<long long>((S + C::BQ - 1) / C::BQ + 1) /
                          2 * B * H;
  int grid = 0;
  rc = persistent_grid<tc::flash_bwd_dq_mla_kernel>(C::THREADS, C::SMEM,
                                                  units, &grid);
  if (rc != 0) return rc;
  tc::flash_bwd_dq_mla_kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), B,
      S, H, KV, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// The dkdv launch of the route and head-dim pair: (64, 64), (128, 128),
// (256, 256) or MLA's (96, 64), whose bf16 route has a kernel of its own.
template <int HDQK, int HDV>
int launch_dkdv_pair(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, float* part, int B, int S, int H,
                     int KV, float scale, int causal, int window,
                     float softcap, cudaStream_t s) {
  if (dtype == 0)
    return launch_dkdv<float, HDQK, HDV>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
  if (dtype == 1) {
    if constexpr (HDQK != HDV)
      return launch_dkdv_mla(q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    else
      return launch_dkdv_tc<HDQK, HDV>(q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HDQK, int HDV>
int launch_dq_pair(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int S, int H, int KV, float scale,
                   int causal, int window, float softcap, cudaStream_t s) {
  if (dtype == 0)
    return launch_dq<float, HDQK, HDV>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
  if (dtype == 1) {
    if constexpr (HDQK != HDV)
      return launch_dq_mla(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    else
      return launch_dq_tc<HDQK, HDV>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  q, dq: [B, S, H, hd]; o, dout:
// [B, S, H, hdv]; k, dk: [B, S, KV, hd]; v, dv: [B, S, KV, hdv]; lse,
// delta: float32 [B, H, S]; all contiguous device pointers, the tensors of
// one type (dtype 0: float32, the SIMT route; 1: bfloat16, the wgmma/TMA
// route), 16-byte aligned.  (hd, hdv) is one of (64, 64), (128, 128),
// (256, 256) and MLA's (96, 64).  Each launches on ``stream`` of
// ``device``, does not synchronise and allocates nothing, and returns the
// CUDA error of its attribute call or launch (0 on success;
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled,
// cudaErrorInvalidValue when it refuses a map or there is no instance for
// (hd, hdv)).  The caller checks shapes, H % KV == 0, (hd, hdv) and the
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

// part: null, or (bf16 with H > KV) float32 [B, S, H, hd] of each head's
// dK followed by [B, S, H, hdv] of its dV, unsummed, for
// flash_bwd_dkdv_sum_launch; dk and dv are then not written.  float32
// ignores it.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, float* part, int B,
                                     int S, int H, int KV, int hd, int hdv,
                                     int dtype, float scale, int causal,
                                     int window, float softcap, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 96 && hdv == 64)
    return launch_dkdv_pair<96, 64>(dtype, q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
  if (hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_dkdv_pair<64, 64>(dtype, q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dkdv_pair<128, 128>(dtype, q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dkdv_pair<256, 256>(dtype, q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk (bf16 [B, S, KV, hd]) and dv ([B, S, KV, hdv]) from the partials of
// flash_bwd_dkdv_launch: part_k float32 [B, S, KV * G, hd], part_v
// [B, S, KV * G, hdv].
extern "C" int flash_bwd_dkdv_sum_launch(const float* part_k,
                                         const float* part_v, void* dk,
                                         void* dv, int B, int S, int KV,
                                         int G, int hd, int hdv, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  const long long rows = static_cast<long long>(B) * S * KV;
  const long long n = rows * (hd / 4) + rows * (hdv / 4);
  const long long blocks = (n + kThreads - 1) / kThreads;
  flash_bwd_dkdv_sum_kernel<<<static_cast<unsigned>(
                                  blocks < 1048576 ? blocks : 1048576),
                              kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part_k, part_v, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), rows, G, hd, hdv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int S, int H, int KV,
                                   int hd, int hdv, int dtype, float scale,
                                   int causal, int window, float softcap,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 96 && hdv == 64)
    return launch_dq_pair<96, 64>(dtype, q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
  if (hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_dq_pair<64, 64>(dtype, q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch_dq_pair<128, 128>(dtype, q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch_dq_pair<256, 256>(dtype, q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
