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
// 64) are a pair of their own, (HDQK, HDV) = (96, 64), on both routes; the
// (64, 64), (128, 128) and (256, 256) instances compile the code they
// compiled before (the 96-only code sits in if-constexpr branches).  At the
// MLA training microbatch (B 1, S 4096, 40 heads over 40, causal: 335.6 M
// kept pairs) dkdv does 640 FLOP a pair (S and dK over 96, dP and dV over
// 64), 0.2172 ms at 989 TFLOP/s, and dq 512 (S, dQ over 96, dP over 64),
// 0.1737 ms, against tens of MB: the tensor cores bound both.  The bf16
// design is the one above, widths split:
//   - q's and k's 96 columns come in as three 32-column boxes with 64-byte
//     swizzle (one tensor map each, as at the other widths), so that a
//     96-column operand is one swizzle mode across three 32-column atoms:
//     S = Q . K^T and S^T = K . Q^T take six k16 steps, two in each box,
//     and dK += dS^T . Q and dQ += dS . K are one m64n96k16 product a k16
//     step with Q or K as the MN-major B (atoms BQ or BK rows of 64 bytes
//     apart).  A 128-byte-swizzled box of 64 and a 64-byte one of 32 would
//     split those products in two, and 96 is not a multiple of the
//     128-byte swizzle's 64-column atom;
//   - v and dO keep their 64-column, 128-byte-swizzled chunk;
//   - the dkdv warpgroups' accumulators differ: dV 64 columns (32
//     registers), dK 96 (48);
//   - with G > 1 the partials are dK's [B, S, H, 96] followed by dV's
//     [B, S, H, 64] in one scratch buffer, and flash_bwd_dkdv_sum adds each
//     at its own width.
// Shared memory at (96, 64): dkdv 99 KB (K 12 KB and V 8 KB resident, three
// Q/dO stages of 12 + 8 KB, the exchange), dq 101 KB (Q 24 KB, dO 16 KB,
// three K/V stages of 12 + 8 KB).  float32: the SIMT kernels with q/k rows
// padded to 100 floats and v/dO rows to 68; a thread's float4 column
// groups cover columns 64 gg + 4 tc, and at 96 the second group only for
// tc < 8 (in_row), so that each column has one thread; shared memory 117 KB
// (dkdv) and 100 KB (dq).
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

// HDQK: the head dim of q and k; HDV: of v and dO.  q and k come in as
// CHUNKS column chunks of CW columns: 64 (128 bytes, 128-byte swizzle) at
// hd 64 / 128 / 256, 32 (64 bytes, 64-byte swizzle) at MLA's 96, so that
// one swizzle spans a 96-column operand (three 32-column atoms) and dK's and
// dQ's products stay one wgmma of N 96; v and dO in 64-column chunks.
template <int HDQK, int HDV>
struct DkdvCfg {
  static constexpr int BK = 64;                  // keys a block, resident
  static constexpr int BQ = 64;                  // query rows a stage
  static constexpr int NS = HDQK == 256 ? 2 : 3; // stages of the Q/dO ring
  static constexpr int CW = HDQK % 64 == 0 ? 64 : 32;  // q/k chunk columns
  static constexpr int CHUNKS = HDQK / CW;       // q/k column chunks
  static constexpr int VCHUNKS = HDV / 64;       // v/dO column chunks
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
  static constexpr int CW = HDQK % 64 == 0 ? 64 : 32;
  static constexpr int CHUNKS = HDQK / CW;
  static constexpr int VCHUNKS = HDV / 64;
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
// A-fragment layout of the products that take P^T and dS^T.  At MLA's
// (96, 64) the two warpgroups' products differ in width: warpgroup 1 takes
// S^T over 96 columns (six k16 steps in the 64-byte-swizzled chunks of K
// and Q) and holds dV at N 64 (32 registers); warpgroup 2 takes dP^T over
// 64 and holds dK at N 96 (48 registers), Q the MN-major B of three
// 32-column atoms; each warpgroup's products sit in a branch of its own.
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
  constexpr bool kEq = HDQK == HDV;
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
        if constexpr (kEq) {
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load(sK + c * BK * 128, &tk, kv_full, c * 64, kh, k0, b);
            tma_load(sV + c * BK * 128, &tv, kv_full, c * 64, kh, k0, b);
          }
        } else {
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load(sK + c * BK * 2 * C::CW, &tk, kv_full, c * C::CW, kh,
                     k0, b);
#pragma unroll
          for (int c = 0; c < C::VCHUNKS; ++c)
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
          if constexpr (kEq) {
#pragma unroll
            for (int c = 0; c < C::CHUNKS; ++c) {
              tma_load(sQ + s * C::Q_BYTES + c * BQ * 128, &tq, bar, c * 64,
                       h, q0, b);
              tma_load(sG + s * C::G_BYTES + c * BQ * 128, &tdo, bar, c * 64,
                       h, q0, b);
            }
          } else {
#pragma unroll
            for (int c = 0; c < C::CHUNKS; ++c)
              tma_load(sQ + s * C::Q_BYTES + c * BQ * 2 * C::CW, &tq, bar,
                       c * C::CW, h, q0, b);
#pragma unroll
            for (int c = 0; c < C::VCHUNKS; ++c)
              tma_load(sG + s * C::G_BYTES + c * BQ * 128, &tdo, bar, c * 64,
                       h, q0, b);
          }
        }
      }
    }
  } else if constexpr (kEq) {
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
  } else {
    // ---- consumers at (HDQK, HDV) = (96, 64): c 0 the P / dV warpgroup,
    // c 1 the dS / dK warpgroup, as above with products of their own widths
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int ka = k0 + (t / 32) * 16 + lane / 4, kb = ka + 8;
    const int col0 = 2 * (lane % 4);

    float acc_v[HDV / 2], acc_k[HDQK / 2];   // dV (c 0), dK (c 1)
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDQK / 2; ++i) acc_k[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % NS;
      const int q0 = (t_lo + i) * BQ;
      const uint32_t qst = sQ + s * C::Q_BYTES, gst = sG + s * C::G_BYTES;
      mbar_wait(full0 + 8 * s, (i / NS) & 1);

      float sc[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) sc[j] = 0.f;
      if (c == 0) {
        // S^T = K . Q^T over HDQK: two k16 steps (32 bytes) in each of the
        // 64-byte-swizzled chunks of K and of the stage's Q
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDQK / 16; ++ks) {
          const uint32_t off = (ks % 2) * 32;
          wgmma_ss(sc, sw64_desc(sK + (ks / 2) * BK * 64 + off, 512),
                   sw64_desc(qst + (ks / 2) * BQ * 64 + off, 512), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
      } else {
        // dP^T = V . dO^T over HDV, 128-byte-swizzled chunks
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDV / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss(sc, sw128_desc(sV + (ks / 4) * BK * 128 + off, 16, 1024),
                   sw128_desc(gst + (ks / 4) * BQ * 128 + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(sc);

      const float* ls = lds + s * 2 * BQ;
      if (c == 0) {
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
        named_sync(kXFull, 256);
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int qc = 8 * (j / 4) + col0 + (j & 1);
          sc[j] = xch[j * 128 + t] * (sc[j] - ls[BQ + qc]);
        }
        named_arrive(kXEmpty, 256);
      }

      uint32_t a[BQ / 4];
#pragma unroll
      for (int j = 0; j < BQ / 2; j += 2) a[j / 2] = pack_bf16(sc[j], sc[j + 1]);
      if (c == 0) {
        // dV += P^T . dO: dO the MN-major B, one 64-column chunk
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                 a[4 * kk + 3]};
          wgmma_rs(acc_v, f, sw128_desc(gst + kk * 16 * 128, BQ * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
      } else {
        // dK += dS^T . Q: Q the MN-major B of N 96, its three 32-column
        // atoms BQ rows of 64 bytes apart
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                                 a[4 * kk + 3]};
          wgmma_rs(acc_k, f, sw64_desc(qst + kk * 16 * 64, BQ * 64, 512));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_k);
      }
      if (t == 0) mbar_arrive(empty0 + 8 * s);
    }
    if (c == 0 && n_steps > 0) named_sync(kXEmpty, 256);  // the last read

    // epilogue: dK carries the scale (q * scale in the product)
    const size_t row = static_cast<size_t>(b) * S + ka;
    if (part != nullptr) {
      // this head's float32 partials: dK's [B, S, H, HDQK], then dV's
      // [B, S, H, HDV]
      const size_t sk = static_cast<size_t>(H) * HDQK;
      const size_t sv = static_cast<size_t>(H) * HDV;
      if (c == 0)
        store_rows(part + static_cast<size_t>(B) * S * sk + row * sv +
                       static_cast<size_t>(h) * HDV + col0,
                   sv, acc_v, 1.f, ka < S, kb < S);
      else
        store_rows(part + row * sk + static_cast<size_t>(h) * HDQK + col0,
                   sk, acc_k, scale, ka < S, kb < S);
    } else {
      // G = 1: the head is the group; round once to bf16
      const size_t sk = static_cast<size_t>(KV) * HDQK;
      const size_t sv = static_cast<size_t>(KV) * HDV;
      if (c == 0)
        store_rows(dv + row * sv + static_cast<size_t>(kh) * HDV + col0, sv,
                   acc_v, 1.f, ka < S, kb < S);
      else
        store_rows(dk + row * sk + static_cast<size_t>(kh) * HDQK + col0, sk,
                   acc_k, scale, ka < S, kb < S);
    }
  }
}

// Block layout: thread 0 (warpgroup 0) loads; warpgroups 1 and 2 own query
// rows q0 .. q0+63 and q0+64 .. q0+127, each computing S = Q . K^T and
// dP = dO . V^T for its rows, dS, and dQ += dS . K.  Thread t holds rows
// qa = row_lo + 16 w + l / 4 and qa + 8 (the forward's layout).  At MLA's
// (96, 64) S takes six k16 steps in the 64-byte-swizzled chunks of Q and
// K, and dQ is one m64n96 product a k16 step, K the MN-major B of three
// 32-column atoms (48 accumulator registers).
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
  constexpr bool kEq = HDQK == HDV;
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
      if constexpr (kEq) {
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(sQ + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
          tma_load(sG + c * BQ * 128, &tdo, q_full, c * 64, h, q0, b);
        }
      } else {
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load(sQ + c * BQ * 2 * C::CW, &tq, q_full, c * C::CW, h, q0, b);
#pragma unroll
        for (int c = 0; c < C::VCHUNKS; ++c)
          tma_load(sG + c * BQ * 128, &tdo, q_full, c * 64, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, C::K_BYTES + C::V_BYTES);
        const int k0 = (t_lo + i) * BK;
        if constexpr (kEq) {
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load(sK + s * C::K_BYTES + c * BK * 128, &tk, bar, c * 64, kh,
                     k0, b);
            tma_load(sV + s * C::V_BYTES + c * BK * 128, &tv, bar, c * 64, kh,
                     k0, b);
          }
        } else {
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c)
            tma_load(sK + s * C::K_BYTES + c * BK * 2 * C::CW, &tk, bar,
                     c * C::CW, kh, k0, b);
#pragma unroll
          for (int c = 0; c < C::VCHUNKS; ++c)
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
    // this warpgroup's 64 rows of Q (chunk c at + c BQ 2 CW) and of dO
    // (chunk c at + c BQ 128); at equal head dims sQw shares the product
    // (wg - 1) * 64 * 128 with sGw, which keeps those instances' SASS
    uint32_t sQw;
    if constexpr (kEq) sQw = sQ + (wg - 1) * 64 * 128;
    else sQw = sQ + (wg - 1) * 64 * 2 * C::CW;
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
        if constexpr (kEq) {
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks) {
            const uint32_t off = (ks % 4) * 32;  // 16 columns of a chunk
            wgmma_ss(sc, sw128_desc(sQw + (ks / 4) * BQ * 128 + off, 16, 1024),
                     sw128_desc(kst + (ks / 4) * BK * 128 + off, 16, 1024), 1);
          }
        } else {
          // two k16 steps (32 bytes) in each 64-byte-swizzled chunk
#pragma unroll
          for (int ks = 0; ks < HDQK / 16; ++ks) {
            const uint32_t off = (ks % 2) * 32;
            wgmma_ss(sc, sw64_desc(sQw + (ks / 2) * BQ * 64 + off, 512),
                     sw64_desc(kst + (ks / 2) * BK * 64 + off, 512), 1);
          }
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
          if constexpr (kEq)
            wgmma_rs(acc, f, sw128_desc(kst + kk * 16 * 128, BK * 128, 1024));
          else   // three 32-column atoms, BK rows of 64 bytes apart
            wgmma_rs(acc, f, sw64_desc(kst + kk * 16 * 64, BK * 64, 512));
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
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, HDQK, HDV, C::CW, C::BQ,
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
  int rc = make_maps(m, q, dout, k, v, B, S, H, KV, HDQK, HDV, C::CW, C::BQ,
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

// The dkdv launch of the route and head-dim pair: (64, 64), (128, 128),
// (256, 256) or MLA's (96, 64).
template <int HDQK, int HDV>
int launch_dkdv_pair(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, float* part, int B, int S, int H,
                     int KV, float scale, int causal, int window,
                     float softcap, cudaStream_t s) {
  if (dtype == 0)
    return launch_dkdv<float, HDQK, HDV>(q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, scale, causal, window, softcap, s);
  if (dtype == 1)
    return launch_dkdv_tc<HDQK, HDV>(q, k, v, dout, lse, delta, dk, dv, part, B, S, H, KV, scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HDQK, int HDV>
int launch_dq_pair(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int S, int H, int KV, float scale,
                   int causal, int window, float softcap, cudaStream_t s) {
  if (dtype == 0)
    return launch_dq<float, HDQK, HDV>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
  if (dtype == 1)
    return launch_dq_tc<HDQK, HDV>(q, k, v, dout, lse, delta, dq, B, S, H, KV, scale, causal, window, softcap, s);
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
