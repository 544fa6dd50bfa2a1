// The gradient of WKV6 (the RWKV6 chunked linear attention) for Hopper
// (sm_90a).  The forward (wkv6.cu) computes, chunk by chunk of C = 16
// tokens, with lw = max(log(max(w, 1e-38)), -9), cum its inclusive prefix
// over the chunk, ce = cum - lw, ref = cum[C/2], last = cum[C-1]:
//
//   a = r e^(ce-ref), b = k e^(ref-cum), rq = r e^ce, kd = k e^(last-cum)
//   sc[t][s] = a[t] . b[s] (s < t, else 0),   diag[t] = sum_d r u k
//   y[t] = sc[t] . v + diag[t] v[t] + rq[t] . S
//   S' = diag(e^last) S + kd^T v
//
// This kernel replaces no Pallas kernel: the JAX package differentiates
// its chunked oracle (repro/kernels/ref.py::wkv6_chunked_ref, the function
// of repro/kernels/wkv6.py::_wkv6_kernel) with jax.grad.  Given dy and the
// gradient of the final state, it walks the chunks in reverse, carrying dS
// (the gradient of the state leaving the chunk) in float32:
//
//   dsc = mask(dy v^T), ddiag[t] = dy[t] . v[t]
//   dv = sc^T dy + diag dy + kd dS,  da = dsc b,  db = dsc^T a
//   drq = dy S^T,  dkd = v dS^T,  ddecay[d] = dS[d] . S[d]
//   dr = da e^(ce-ref) + drq e^ce + ddiag u k,  dk = db e^(ref-cum)
//        + dkd e^(last-cum) + ddiag u r
//   d cum_excl = da a + drq rq;  d cum = -(db b) - (dkd kd), plus
//   sum_t (db b - da a) at ref and sum_s dkd kd + ddecay e^last at last;
//   d lw = (the reverse cumsum of d cum + d cum_excl) - d cum_excl;
//   dw = d lw * (1, 0.5 or 0 as log w is above, at or below -9) / w
//   dS <- diag(e^last) dS + rq^T dy,   du += sum_t ddiag r k
//
// and needs the state entering each chunk, S: the forward's training
// instance writes them ([B, H, S/16, hd, hd] float32), and this kernel
// reads them.
//
// What bounds it on this card: at rwkv6-3b's training microbatch (B 1,
// S 4096, H 40, hd 64) the function reads r, k, v, w and dy and writes dr,
// dk, dv and dw, 378.8 MB of float32 (0.113 ms at 3.35 TB/s), against
// 6.4 GFLOP of products (0.095 ms at the 67 TFLOP/s float32 peak outside
// the tensor cores): bytes bound it.  A first design (one block per
// (batch, head) walking all 256 chunks on FMAs) took 2.93 ms: 40 blocks
// held 40 of the 132 SMs, each at a tenth of an SM's float32 rate.  What
// this design does:
//   * The chunks of each (b, h) are split into segments, one block each:
//     grid (segments, H, B).  dS is linear in the chunks with a diagonal
//     decay, so the dS entering a segment's last chunk is a fold of the
//     later segments' own folds: a first launch (wkv6_bwd_fold_kernel,
//     one block per (b, h, segment > 0), reading only r, w and dy) folds
//     its chunks in reverse from zero, L <- diag(e^last) L + rq^T dy, and
//     keeps the product D of its decays per row; a second launch
//     (wkv6_bwd_carry_kernel) scans those pairs from ds_end in a fixed
//     order, X_s = D_{s+1} X_{s+1} + L_{s+1}; the main launch then walks
//     its segment's chunks from X_s and writes dr, dk, dv, dw, its du
//     partial and (segment 0) ds0.  The states come from the forward, so
//     nothing is recomputed.  A product of decays can underflow to 0 (a
//     chunk's e^last reaches e^-144): it multiplies X by 0 as the
//     sequential walk multiplies dS by 0 chunk by chunk, never inf by 0.
//     Writing dS for every chunk instead would move 168 MB twice more at
//     the training shape; the pairs move 2 x 8.5 MB.  The plan
//     (kernels/wkv6.py:bwd_segments) takes the segment count s in 1 .. 64
//     that minimises ceil(B H s / (2 x 132)) x (ceil(chunks / s) + 1)
//     chunk-steps, two blocks resident an SM: at B 1, S 4096, H 40, 13
//     segments of 19-20 chunks, 520 blocks in 2 waves of 264 slots,
//     makespan 42 chunk-steps where one block per (b, h) took 256; at B 8,
//     S 2048, 4 segments of 32 chunks, 1,280 blocks in 5 waves.
//   * Every product of K = hd or K = 16 runs on the tensor cores,
//     mma.sync.m16n8k8 in TF32 with the 3xTF32 split (tf32_mma.cuh, shared
//     with wkv6.cu): one TF32 product keeps about 3 digits, too few at
//     1e-4.  Per chunk, warp w (of 8) takes, at hd 64: half the K of one
//     n-tile of the scores or their gradient (the two halves summed, with
//     the mask, as the next stage reads them); n-tile w of drq = dy S^T,
//     of dkd = v dS^T and of dv's kd dS; 4 of the 32 m16n8 tiles of dS,
//     held in float32 accumulator registers across the chunks and
//     published to shared memory at the start of the next; then n-tile w
//     of dv's sc^T dy, of da = dsc b and of db = dsc^T a.
//   * Thread (dim d, tokens 4q .. 4q + 3) makes the decayed operands (the
//     decay prefix: a sum over its 4 tokens, then a scan over the 4 lanes
//     of the dim, two shuffles), keeps r, k, w and the prefix in
//     registers, and after the products makes dr, dk, d lw (the reverse
//     cumsum the same way), dw and du's share, with no second pass through
//     shared memory.  The diagonals sum over a warp's 8 dims by shuffles
//     and over the warps where they are read.
//   * The next chunk's v and dy come into a second buffer by cp.async at
//     the start of a chunk; its r, k, w once this one's operands are made,
//     and its state once the products that read this one's are done.  104
//     KB of shared memory and at most 128 registers a thread: two blocks
//     an SM.  Four block barriers a chunk.
// du is summed per (b, h, segment) over its chunks in reverse order, then
// over (b, segment) by a last launch of fixed order (fixed_sum.cuh): no
// atomics, so the gradient repeats bit for bit.  Masked scores (s >= t)
// are never kept: their exponents can overflow, and a select drops them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kC = 16;                 // tokens per chunk
constexpr int kThreads = 256;
constexpr float kLogWMin = -9.0f;

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A of an m16n8k8 product, element (m, k) at p[m sm + k sk], split
__device__ __forceinline__ void frag_a(FragA& f, const float* p, int sm,
                                       int sk, int g, int tg) {
  split(p[g * sm + tg * sk], f.hi[0], f.lo[0]);
  split(p[(g + 8) * sm + tg * sk], f.hi[1], f.lo[1]);
  split(p[g * sm + (tg + 4) * sk], f.hi[2], f.lo[2]);
  split(p[(g + 8) * sm + (tg + 4) * sk], f.hi[3], f.lo[3]);
}

// B of an m16n8k8 product, element (k, n) at p[k sk + n sn], split
__device__ __forceinline__ void frag_b(FragB& f, const float* p, int sk,
                                       int sn, int g, int tg) {
  f.load(p[tg * sk + g * sn], p[(tg + 4) * sk + g * sn]);
}

// c0 += a_lo b_hi + a_hi b_lo, c1 += a_hi b_hi: two chains, summed at the
// end, so that back-to-back mma.sync do not all wait on one another
__device__ __forceinline__ void mma3(float (&c0)[4], float (&c1)[4],
                                     const FragA& a, const FragB& b) {
  mma_tf32(c0, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c1, a.hi, b.hi[0], b.hi[1]);
  mma_tf32(c0, a.hi, b.lo[0], b.lo[1]);
}

// c (rows g, g + 8; columns 2 tg, 2 tg + 1 of an m16n8 tile) to p[m ld + n]
__device__ __forceinline__ void store_c(float* p, int ld, const float (&c0)[4],
                                        const float (&c1)[4], int g, int tg) {
  *reinterpret_cast<float2*>(p + g * ld + 2 * tg) =
      make_float2(c0[0] + c1[0], c0[1] + c1[1]);
  *reinterpret_cast<float2*>(p + (g + 8) * ld + 2 * tg) =
      make_float2(c0[2] + c1[2], c0[3] + c1[3]);
}

// The decay prefix of dim d at tokens 4 tq .. 4 tq + 3 (w at wp[i * ld]):
// lw, its inclusive prefix over the chunk, and the prefix at C/2 and C-1.
// All 32 lanes of the warp take part; the 4 lanes of a dim are 8 apart.
struct Prefix {
  float lw[4], cm[4], ref, last;
  __device__ __forceinline__ void make(const float* wp, int ld, int lane) {
    const int tq = lane >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lw[i] = fmaxf(logf(fmaxf(wp[i * ld], 1e-38f)), kLogWMin);
      cm[i] = i ? cm[i - 1] + lw[i] : lw[i];
    }
    float x = cm[3];
    float o = __shfl_up_sync(0xffffffffu, x, 8);
    if (tq >= 1) x += o;
    o = __shfl_up_sync(0xffffffffu, x, 16);
    if (tq >= 2) x += o;
    const float excl = x - cm[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) cm[i] += excl;
    ref = __shfl_sync(0xffffffffu, cm[0], 16 + (lane & 7));
    last = __shfl_sync(0xffffffffu, cm[3], 24 + (lane & 7));
  }
};

// The m16n8 tiles of an hd x hd matrix (dS, or a fold L) that warp `warp`
// holds in accumulator registers: TPW consecutive tiles, row-tile-major.
template <int HD>
struct Tiles {
  static constexpr int NT = HD / 8, MT = HD / 16;
  static constexpr int TPW = MT * NT >= 8 ? MT * NT / 8 : 1;
  __device__ __forceinline__ static bool has(int warp) {
    return warp * TPW < MT * NT;
  }
  __device__ __forceinline__ static int row(int warp, int m, int g) {
    return 16 * ((warp * TPW + m) / NT) + g;          // and row + 8
  }
  __device__ __forceinline__ static int col(int warp, int m, int tg) {
    return 8 * ((warp * TPW + m) % NT) + 2 * tg;      // and col + 1
  }
};

// x[m] (the tiles of Tiles<HD>) <- diag(decay) x + rq^T dy, rq [kC][lr],
// dy [kC][ld]: K = 16 tokens, each TF32 product over the tiles in turn
template <int HD>
__device__ __forceinline__ void fold_chunk(float (&x)[Tiles<HD>::TPW][4],
                                           const float* rq, int lr,
                                           const float* dy, int ld,
                                           const float* decay, int warp,
                                           int g, int tg) {
  using T = Tiles<HD>;
#pragma unroll
  for (int m = 0; m < T::TPW; ++m) {
    const int i0 = T::row(warp, m, g);
    const float e0 = decay[i0], e1 = decay[i0 + 8];
    x[m][0] *= e0; x[m][1] *= e0;
    x[m][2] *= e1; x[m][3] *= e1;
  }
#pragma unroll
  for (int k0 = 0; k0 < kC; k0 += 8) {
    FragA fa[T::TPW];
    FragB fb[T::TPW];
#pragma unroll
    for (int m = 0; m < T::TPW; ++m) {
      const int i0 = T::row(warp, m, g) - g;
      const int j0 = T::col(warp, m, tg) - 2 * tg;
      frag_a(fa[m], rq + k0 * lr + i0, 1, lr, g, tg);     // (i, t) = rq[t][i]
      frag_b(fb[m], dy + k0 * ld + j0, ld, 1, g, tg);     // (t, j) = dy[t][j]
    }
#pragma unroll
    for (int m = 0; m < T::TPW; ++m)
      mma_tf32(x[m], fa[m].lo, fb[m].hi[0], fb[m].hi[1]);
#pragma unroll
    for (int m = 0; m < T::TPW; ++m)
      mma_tf32(x[m], fa[m].hi, fb[m].lo[0], fb[m].lo[1]);
#pragma unroll
    for (int m = 0; m < T::TPW; ++m)
      mma_tf32(x[m], fa[m].hi, fb[m].hi[0], fb[m].hi[1]);
  }
}

// chunk range of segment `seg` of `nseg` over n chunks
__device__ __forceinline__ void seg_range(int seg, int nseg, int n, int& c0,
                                          int& c1) {
  c0 = static_cast<int>(static_cast<long long>(seg) * n / nseg);
  c1 = static_cast<int>(static_cast<long long>(seg + 1) * n / nseg);
}

// ---------------------------------------------------------------- the fold

template <int HD>
struct FoldSmem {
  static constexpr int P = HD + 4, PK = HD + 8;
  alignas(16) float in[2][3][kC][P];          // r, w, dy of a chunk
  alignas(16) float rq[kC][PK];
  float decay[HD];
};

// One block per (b, h, segment 1 .. nseg - 1): L = the segment's chunks
// folded in reverse from zero, D = the product of their decays by row.
template <int HD>
__global__ void __launch_bounds__(kThreads, 3)
wkv6_bwd_fold_kernel(const float* __restrict__ r, const float* __restrict__ w,
                     const float* __restrict__ dy, float* __restrict__ fold_l,
                     float* __restrict__ fold_d, int S, int H, int nseg) {
  using T = Tiles<HD>;
  constexpr int P = FoldSmem<HD>::P, PK = FoldSmem<HD>::PK, Q = HD / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FoldSmem<HD>& sm = *reinterpret_cast<FoldSmem<HD>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int seg = blockIdx.x + 1, h = blockIdx.y, bb = blockIdx.z;
  int c0, c1;
  seg_range(seg, nseg, S / kC, c0, c1);
  const size_t row = static_cast<size_t>(H) * HD;
  const size_t base = static_cast<size_t>(bb) * S * row +
                      static_cast<size_t>(h) * HD;
  const size_t pair = (static_cast<size_t>(bb) * H + h) * nseg + seg;
  const bool has_d = warp < HD / 8;
  const int tq = lane >> 3, d = 8 * warp + (lane & 7);

  auto fetch = [&](int ci, int buf) {
    for (int e = tid; e < 3 * kC * Q; e += kThreads) {
      const int a = e / (kC * Q), t = (e / Q) % kC, j = 4 * (e % Q);
      cp_async16(&sm.in[buf][a][t][j],
                 (a == 0 ? r : (a == 1 ? w : dy)) + base +
                     static_cast<size_t>(ci * kC + t) * row + j);
    }
    cp_commit();
  };
  fetch(c1 - 1, 0);

  float x[T::TPW][4] = {};
  float dprod = 1.f;                           // lanes tq == 0
  for (int ci = c1 - 1; ci >= c0; --ci) {
    const int buf = (c1 - 1 - ci) & 1;
    cp_wait_all();
    __syncthreads();   // this chunk is staged; the last one's rq is read
    if (ci > c0) fetch(ci - 1, buf ^ 1);
    if (has_d) {
      Prefix p;
      p.make(&sm.in[buf][1][4 * tq][d], P, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        sm.rq[t][d] = sm.in[buf][0][t][d] * __expf(p.cm[i] - p.lw[i]);
      }
      if (tq == 0) {
        const float e = __expf(p.last);
        sm.decay[d] = e;
        dprod *= e;
      }
    }
    __syncthreads();
    if (T::has(warp))
      fold_chunk<HD>(x, &sm.rq[0][0], PK, &sm.in[buf][2][0][0], P, sm.decay,
                     warp, g, tg);
  }

  if (T::has(warp)) {
    float* out = fold_l + pair * HD * HD;
#pragma unroll
    for (int m = 0; m < T::TPW; ++m) {
      const int i0 = T::row(warp, m, g), j = T::col(warp, m, tg);
      *reinterpret_cast<float2*>(out + i0 * HD + j) =
          make_float2(x[m][0], x[m][1]);
      *reinterpret_cast<float2*>(out + (i0 + 8) * HD + j) =
          make_float2(x[m][2], x[m][3]);
    }
  }
  if (has_d && tq == 0) fold_d[pair * HD + d] = dprod;
}

// One thread per 4 elements of an (b, h)'s hd x hd carry: X_{nseg-1} =
// ds_end (or zeros), X_s = D_{s+1} X_{s+1} + L_{s+1}, in that order.
template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_carry_kernel(const float* __restrict__ ds_end,
                      const float* __restrict__ fold_l,
                      const float* __restrict__ fold_d,
                      float* __restrict__ carry, int H, int nseg) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= HD * HD / 4) return;
  const int i = 4 * e / HD;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float4 x = ds_end ? *reinterpret_cast<const float4*>(
                          ds_end + bh * HD * HD + 4 * e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t p0 = bh * nseg;
  *reinterpret_cast<float4*>(carry + (p0 + nseg - 1) * HD * HD + 4 * e) = x;
  for (int s = nseg - 2; s >= 0; --s) {
    const float dd = fold_d[(p0 + s + 1) * HD + i];
    const float4 l = *reinterpret_cast<const float4*>(
        fold_l + (p0 + s + 1) * HD * HD + 4 * e);
    x = make_float4(fmaf(dd, x.x, l.x), fmaf(dd, x.y, l.y),
                    fmaf(dd, x.z, l.z), fmaf(dd, x.w, l.w));
    *reinterpret_cast<float4*>(carry + (p0 + s) * HD * HD + 4 * e) = x;
  }
}

// ---------------------------------------------------------------- the walk

template <int HD>
struct Smem {
  static constexpr int P = HD + 4;             // row stride (floats)
  static constexpr int PK = HD + 8;            // rq, read as [t][i] by (tg, g)
  alignas(16) float vdy[2][2][kC][P];          // v, dy of a chunk, 2 buffers
  alignas(16) float rkw[3][kC][P];             // r, k, w of a chunk
  alignas(16) float S[HD][P];                  // the state entering it
  alignas(16) float dS[HD][P];                 // dS leaving it
  alignas(16) float a[kC][P];                  // r e^(ce - ref)
  alignas(16) float b[kC][P];                  // k e^(ref - cum)
  alignas(16) float kd[kC][P];                 // k e^(last - cum)
  alignas(16) float rq[kC][PK];                // r e^ce
  alignas(16) float gr[4][kC][P];              // da, drq, db, dkd
  alignas(16) float scp[2][2][kC][kC + 4];     // [sc | dsc][K half]: partial
  float decay[HD];                             // e^last
  float dpart[2][HD / 8][kC];                  // diag, ddiag over 8 dims
};

enum { V = 0, DY = 1 };
enum { R = 0, K_ = 1, W = 2 };
enum { DA = 0, DRQ = 1, DB = 2, DKD = 3 };

// the masked score (or its gradient) at (t, s): the two K halves summed
template <int HD>
__device__ __forceinline__ float score(const Smem<HD>& sm, int which, int t,
                                       int s) {
  return s < t ? sm.scp[which][0][t][s] + sm.scp[which][1][t][s] : 0.f;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ states,
                const float* __restrict__ dy,
                const float* __restrict__ carry, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, int S, int H, int nseg) {
  static_assert(HD == 16 || HD == 32 || HD == 64, "hd in {16, 32, 64}");
  using T = Tiles<HD>;
  constexpr int P = Smem<HD>::P, PK = Smem<HD>::PK;
  constexpr int Q = HD / 4;                    // float4 columns of a row
  constexpr int NT = HD / 8;                   // n-tiles of hd columns
  constexpr int KH = HD / 2;                   // a score warp's K half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int seg = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int n_chunks = S / kC;
  int c0, c1;
  seg_range(seg, nseg, n_chunks, c0, c1);
  const size_t row = static_cast<size_t>(H) * HD;      // one token's stride
  const size_t base = static_cast<size_t>(bb) * S * row +
                      static_cast<size_t>(h) * HD;     // token 0 of (b, h)
  const size_t bh = static_cast<size_t>(bb) * H + h;
  const float* st_bh = states + bh * n_chunks * HD * HD;

  // the per-dim stages: dim d = 8 warp + (lane & 7) of tokens 4 tq ..
  // 4 tq + 3; the 4 lanes of one dim are 8 apart
  const bool has_d = warp < HD / 8;            // whole warps
  const int tq = lane >> 3, d = 8 * warp + (lane & 7);
  const float ud = has_d ? u[h * HD + d] : 0.f;
  // the n-tile of drq, dkd, dv, da and db this warp makes
  const bool nt_warp = NT >= 8 || warp < NT;
  const int j0 = 8 * warp;                     // its first column
  float du_acc = 0.f;                          // lanes tq == 0

  // dS leaving the segment's last chunk, as accumulator tiles
  float ds[T::TPW][4];
  if (T::has(warp)) {
    const float* src = carry + (bh * nseg + seg) * HD * HD;
#pragma unroll
    for (int m = 0; m < T::TPW; ++m) {
      const int i0 = T::row(warp, m, g), j = T::col(warp, m, tg);
      const float2 x0 = *reinterpret_cast<const float2*>(src + i0 * HD + j);
      const float2 x1 =
          *reinterpret_cast<const float2*>(src + (i0 + 8) * HD + j);
      ds[m][0] = x0.x; ds[m][1] = x0.y;
      ds[m][2] = x1.x; ds[m][3] = x1.y;
    }
  }

  auto fetch_vdy = [&](int ci, int buf) {
    for (int e = tid; e < 2 * kC * Q; e += kThreads) {
      const int a = e / (kC * Q), t = (e / Q) % kC, j = 4 * (e % Q);
      cp_async16(&sm.vdy[buf][a][t][j],
                 (a ? dy : v) + base + static_cast<size_t>(ci * kC + t) * row +
                     j);
    }
  };
  auto fetch_rkw = [&](int ci) {
    for (int e = tid; e < 3 * kC * Q; e += kThreads) {
      const int a = e / (kC * Q), t = (e / Q) % kC, j = 4 * (e % Q);
      cp_async16(&sm.rkw[a][t][j],
                 (a == 0 ? r : (a == 1 ? k : w)) + base +
                     static_cast<size_t>(ci * kC + t) * row + j);
    }
  };
  auto fetch_s = [&](int ci) {
    const float* st = st_bh + static_cast<size_t>(ci) * HD * HD;
    for (int e = tid; e < HD * Q; e += kThreads) {
      const int i = e / Q, j = 4 * (e % Q);
      cp_async16(&sm.S[i][j], st + i * HD + j);
    }
  };
  fetch_vdy(c1 - 1, 0);
  fetch_rkw(c1 - 1);
  fetch_s(c1 - 1);
  cp_commit();

  for (int ci = c1 - 1; ci >= c0; --ci) {
    const int buf = (c1 - 1 - ci) & 1;
    const auto& vv = sm.vdy[buf][V];
    const auto& yy = sm.vdy[buf][DY];
    const size_t tok0 = base + static_cast<size_t>(ci) * kC * row;
    cp_wait_all();
    __syncthreads();   // this chunk is staged; the last one is done
    if (T::has(warp)) {   // publish dS leaving this chunk
#pragma unroll
      for (int m = 0; m < T::TPW; ++m) {
        const int i0 = T::row(warp, m, g), j = T::col(warp, m, tg);
        *reinterpret_cast<float2*>(&sm.dS[i0][j]) =
            make_float2(ds[m][0], ds[m][1]);
        *reinterpret_cast<float2*>(&sm.dS[i0 + 8][j]) =
            make_float2(ds[m][2], ds[m][3]);
      }
    }
    if (ci > c0) {
      fetch_vdy(ci - 1, buf ^ 1);
      cp_commit();
    }

    // 1: the decayed operands of dim d at this thread's 4 tokens, and the
    // diagonals' sums over the warp's 8 dims
    Prefix p;
    float rr[4], kk[4], ww[4];
    if (has_d) {
      p.make(&sm.rkw[W][4 * tq][d], P, lane);
      float dp[4], dq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        rr[i] = sm.rkw[R][t][d];
        kk[i] = sm.rkw[K_][t][d];
        ww[i] = sm.rkw[W][t][d];
        const float ce = p.cm[i] - p.lw[i];
        sm.a[t][d] = rr[i] * __expf(ce - p.ref);
        sm.b[t][d] = kk[i] * __expf(p.ref - p.cm[i]);
        sm.rq[t][d] = rr[i] * __expf(ce);
        sm.kd[t][d] = kk[i] * __expf(p.last - p.cm[i]);
        dp[i] = rr[i] * ud * kk[i];
        dq[i] = yy[t][d] * vv[t][d];
      }
      if (tq == 0) sm.decay[d] = __expf(p.last);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) {
          dp[i] += __shfl_xor_sync(0xffffffffu, dp[i], m);
          dq[i] += __shfl_xor_sync(0xffffffffu, dq[i], m);
        }
      }
      if ((lane & 7) == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sm.dpart[0][warp][4 * tq + i] = dp[i];
          sm.dpart[1][warp][4 * tq + i] = dq[i];
        }
      }
    }
    __syncthreads();
    if (ci > c0) {     // the staged r, k, w are read
      fetch_rkw(ci - 1);
      cp_commit();
    }

    // 2: ddecay; the K = hd products; the dS update in registers
    float ddecay = 0.f;
    if (has_d) {
#pragma unroll
      for (int j = 0; j < HD / 4; ++j)
        ddecay = fmaf(sm.dS[d][tq * (HD / 4) + j], sm.S[d][tq * (HD / 4) + j],
                      ddecay);
      ddecay += __shfl_xor_sync(0xffffffffu, ddecay, 8);
      ddecay += __shfl_xor_sync(0xffffffffu, ddecay, 16);
    }
    {   // the scores (which 0: a b^T) or their gradient (1: dy v^T), n-tile
        // nt, dims [KH kh, KH (kh + 1)): one per warp
      const int which = warp >> 2, nt = (warp >> 1) & 1, kh = warp & 1;
      const float* pa = which ? &yy[0][0] : &sm.a[0][0];
      const float* pb = which ? &vv[0][0] : &sm.b[0][0];
      float c[2][4] = {};
#pragma unroll
      for (int k0 = KH * kh; k0 < KH * (kh + 1); k0 += 8) {
        FragA fa;
        FragB fb;
        frag_a(fa, pa + k0, P, 1, g, tg);                 // (t, d)
        frag_b(fb, pb + 8 * nt * P + k0, 1, P, g, tg);    // (d, s) = b[s][d]
        mma3(c[0], c[1], fa, fb);
      }
      store_c(&sm.scp[which][kh][0][8 * nt], kC + 4, c[0], c[1], g, tg);
    }
    float dva[2][4] = {};                      // this warp's n-tile of dv
    if (nt_warp) {
      float q[2][4] = {}, x[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < HD; k0 += 8) {
        FragA fy, fv, fk;
        FragB fs, fd, fe;
        frag_a(fy, &yy[0][k0], P, 1, g, tg);              // dy (t, j)
        frag_a(fv, &vv[0][k0], P, 1, g, tg);              // v (t, j)
        frag_a(fk, &sm.kd[0][k0], P, 1, g, tg);           // kd (s, i)
        frag_b(fs, &sm.S[j0][k0], 1, P, g, tg);           // (j, i) = S[i][j]
        frag_b(fd, &sm.dS[j0][k0], 1, P, g, tg);          // (j, i) = dS[i][j]
        frag_b(fe, &sm.dS[k0][j0], P, 1, g, tg);          // (i, j) = dS[i][j]
        mma3(q[0], q[1], fy, fs);                         // drq
        mma3(x[0], x[1], fv, fd);                         // dkd
        mma3(dva[0], dva[1], fk, fe);                     // kd dS
      }
      store_c(&sm.gr[DRQ][0][j0], P, q[0], q[1], g, tg);
      store_c(&sm.gr[DKD][0][j0], P, x[0], x[1], g, tg);
    }
    if (T::has(warp))
      fold_chunk<HD>(ds, &sm.rq[0][0], PK, &yy[0][0], P, sm.decay, warp, g,
                     tg);
    __syncthreads();
    if (ci > c0) {     // the staged state is read
      fetch_s(ci - 1);
      cp_commit();
    }

    // 3: the K = 16 products: dv (+ sc^T dy + diag dy), da, db
    if (nt_warp) {
      float xa[2][4] = {}, xb[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kC; k0 += 8) {
        FragA fsc, fda, fdb;
        split(score(sm, 0, k0 + tg, g), fsc.hi[0], fsc.lo[0]);      // (s, t)
        split(score(sm, 0, k0 + tg, g + 8), fsc.hi[1], fsc.lo[1]);
        split(score(sm, 0, k0 + tg + 4, g), fsc.hi[2], fsc.lo[2]);
        split(score(sm, 0, k0 + tg + 4, g + 8), fsc.hi[3], fsc.lo[3]);
        split(score(sm, 1, g, k0 + tg), fda.hi[0], fda.lo[0]);      // (t, s)
        split(score(sm, 1, g + 8, k0 + tg), fda.hi[1], fda.lo[1]);
        split(score(sm, 1, g, k0 + tg + 4), fda.hi[2], fda.lo[2]);
        split(score(sm, 1, g + 8, k0 + tg + 4), fda.hi[3], fda.lo[3]);
        split(score(sm, 1, k0 + tg, g), fdb.hi[0], fdb.lo[0]);      // (s, t)
        split(score(sm, 1, k0 + tg, g + 8), fdb.hi[1], fdb.lo[1]);
        split(score(sm, 1, k0 + tg + 4, g), fdb.hi[2], fdb.lo[2]);
        split(score(sm, 1, k0 + tg + 4, g + 8), fdb.hi[3], fdb.lo[3]);
        FragB fy, fb, fa;
        frag_b(fy, &yy[k0][j0], P, 1, g, tg);             // dy (t, j)
        frag_b(fb, &sm.b[k0][j0], P, 1, g, tg);           // b (s, i)
        frag_b(fa, &sm.a[k0][j0], P, 1, g, tg);           // a (t, i)
        mma3(dva[0], dva[1], fsc, fy);
        mma3(xa[0], xa[1], fda, fb);
        mma3(xb[0], xb[1], fdb, fa);
      }
      store_c(&sm.gr[DA][0][j0], P, xa[0], xa[1], g, tg);
      store_c(&sm.gr[DB][0][j0], P, xb[0], xb[1], g, tg);
      float dg0 = 0.f, dg1 = 0.f;
#pragma unroll
      for (int q = 0; q < HD / 8; ++q) {
        dg0 += sm.dpart[0][q][g];
        dg1 += sm.dpart[0][q][g + 8];
      }
      const int j = j0 + 2 * tg;
      const float2 y0 = *reinterpret_cast<const float2*>(&yy[g][j]);
      const float2 y1 = *reinterpret_cast<const float2*>(&yy[g + 8][j]);
      *reinterpret_cast<float2*>(dv + tok0 + g * row + j) =
          make_float2(fmaf(dg0, y0.x, dva[0][0] + dva[1][0]),
                      fmaf(dg0, y0.y, dva[0][1] + dva[1][1]));
      *reinterpret_cast<float2*>(dv + tok0 + (g + 8) * row + j) =
          make_float2(fmaf(dg1, y1.x, dva[0][2] + dva[1][2]),
                      fmaf(dg1, y1.y, dva[0][3] + dva[1][3]));
    }
    __syncthreads();

    // 4: dr, dk, d lw through the reverse cumsum, dw, and du's share
    if (has_d) {
      float gce[4], gc[4], dref = 0.f, dlast = 0.f, dus = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        float ddiag = 0.f;
#pragma unroll
        for (int q = 0; q < HD / 8; ++q) ddiag += sm.dpart[1][q][t];
        const float ce = p.cm[i] - p.lw[i];
        const float dda = sm.gr[DA][t][d], ddrq = sm.gr[DRQ][t][d];
        const float ddb = sm.gr[DB][t][d], ddkd = sm.gr[DKD][t][d];
        const float dgu = ddiag * ud;
        const size_t o = tok0 + static_cast<size_t>(t) * row + d;
        dr[o] = dda * __expf(ce - p.ref) + ddrq * __expf(ce) + dgu * kk[i];
        dk[o] = ddb * __expf(p.ref - p.cm[i]) +
                ddkd * __expf(p.last - p.cm[i]) + dgu * rr[i];
        const float x1 = dda * sm.a[t][d], x2 = ddrq * sm.rq[t][d];
        const float x3 = ddb * sm.b[t][d], x4 = ddkd * sm.kd[t][d];
        gce[i] = x1 + x2;
        gc[i] = gce[i] - x3 - x4;
        dref += x3 - x1;
        dlast += x4;
        dus = fmaf(ddiag, rr[i] * kk[i], dus);
      }
#pragma unroll
      for (int m = 8; m < 32; m <<= 1) {
        dref += __shfl_xor_sync(0xffffffffu, dref, m);
        dlast += __shfl_xor_sync(0xffffffffu, dlast, m);
        dus += __shfl_xor_sync(0xffffffffu, dus, m);
      }
      if (tq == 2) gc[0] += dref;                        // t = 8, ref
      if (tq == 3) gc[3] += dlast + ddecay * __expf(p.last);   // last
      // the reverse cumsum: this thread's tokens, then the later lanes'
      float sfx[4];
#pragma unroll
      for (int i = 3; i >= 0; --i) sfx[i] = gc[i] + (i < 3 ? sfx[i + 1] : 0.f);
      float x = sfx[0];                 // the sum over lanes tq .. 3
      float o = __shfl_down_sync(0xffffffffu, x, 8);
      if (tq <= 2) x += o;
      o = __shfl_down_sync(0xffffffffu, x, 16);
      if (tq <= 1) x += o;
      const float later = x - sfx[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        const float wv = fmaxf(ww[i], 1e-38f);
        const float lwr = logf(wv);
        const float side = lwr > kLogWMin ? 1.f
                           : (lwr == kLogWMin ? 0.5f : 0.f);
        const float glw = sfx[i] + later - gce[i];
        dw[tok0 + static_cast<size_t>(t) * row + d] =
            side > 0.f ? glw * side / wv : 0.f;
      }
      if (tq == 0) du_acc += dus;
    }
  }

  if (seg == 0 && T::has(warp)) {   // dS entering chunk 0
    float* out = ds0 + bh * HD * HD;
#pragma unroll
    for (int m = 0; m < T::TPW; ++m) {
      const int i0 = T::row(warp, m, g), j = T::col(warp, m, tg);
      *reinterpret_cast<float2*>(out + i0 * HD + j) =
          make_float2(ds[m][0], ds[m][1]);
      *reinterpret_cast<float2*>(out + (i0 + 8) * HD + j) =
          make_float2(ds[m][2], ds[m][3]);
    }
  }
  if (has_d && tq == 0)
    du_part[((static_cast<size_t>(bb) * nseg + seg) * H + h) * HD + d] =
        du_acc;
}

template <class K>
int set_smem(K kernel, int bytes, int device, int& attr_device) {
  if (attr_device == device) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attr_device = device;
  return 0;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* states, const float* dy,
           const float* ds_end, float* dr, float* dk, float* dv, float* dw,
           float* du, float* ds0, float* fold_l, float* fold_d, float* carry,
           float* du_part, int B, int S, int H, int nseg, int parts,
           int device, cudaStream_t stream) {
  static int attr_fold = -1, attr_walk = -1;
  int rc = set_smem(wkv6_bwd_fold_kernel<HD>,
                    static_cast<int>(sizeof(FoldSmem<HD>)), device, attr_fold);
  if (rc == 0)
    rc = set_smem(wkv6_bwd_kernel<HD>, static_cast<int>(sizeof(Smem<HD>)),
                  device, attr_walk);
  if (rc == 0 && (parts & 1) && nseg > 1) {
    wkv6_bwd_fold_kernel<HD><<<dim3(nseg - 1, H, B), kThreads,
                               sizeof(FoldSmem<HD>), stream>>>(
        r, w, dy, fold_l, fold_d, S, H, nseg);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0 && (parts & 2)) {
    constexpr int blocks = (HD * HD / 4 + kThreads - 1) / kThreads;
    wkv6_bwd_carry_kernel<HD><<<dim3(blocks, H, B), kThreads, 0, stream>>>(
        ds_end, fold_l, fold_d, carry, H, nseg);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0 && (parts & 4)) {
    wkv6_bwd_kernel<HD><<<dim3(nseg, H, B), kThreads, sizeof(Smem<HD>),
                          stream>>>(r, k, v, w, u, states, dy, carry, dr, dk,
                                    dv, dw, du_part, ds0, S, H, nseg);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0 && (parts & 8))
    rc = fixed_sum(du_part, du, B * nseg, static_cast<size_t>(H) * HD,
                   stream);
  return rc;
}

// Blocks of each launch resident on one SM at head dim hd, as the runtime
// computes them (which: 0 the fold, 1 the carry scan, 2 the walk); -1 for
// an hd the kernel does not take, or the CUDA error negated.
template <int HD>
int resident(int which) {
  int n = 0;
  cudaError_t err;
  if (which == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, wkv6_bwd_carry_kernel<HD>, kThreads, 0);
  } else if (which == 0) {
    err = cudaFuncSetAttribute(wkv6_bwd_fold_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(FoldSmem<HD>)));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_bwd_fold_kernel<HD>, kThreads, sizeof(FoldSmem<HD>));
  } else {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem<HD>)));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_bwd_kernel<HD>, kThreads, sizeof(Smem<HD>));
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" int wkv6_bwd_resident(int hd, int which) {
  switch (hd) {
    case 16: return resident<16>(which);
    case 32: return resident<32>(which);
    case 64: return resident<64>(which);
    default: return -1;
  }
}

// Plain C entry point, loaded with ctypes.  r, k, v, w, dy and dr, dk, dv,
// dw: [B, S, H, hd]; u, du: [H, hd]; states: [B, H, S / 16, hd, hd] (the
// forward's training output); ds_end (may be null: zeros), ds0: [B, H, hd,
// hd]; scratch fold_l, carry: [B, H, nseg, hd, hd], fold_d: [B, H, nseg,
// hd], du_part: [B, nseg, H, hd]; all float32, contiguous, 16-byte aligned
// device pointers.  nseg, the segments a (b, h)'s chunks are split into,
// is in 1 .. S / 16.  Launches the fold (when nseg > 1), the carry scan,
// the walk and du's sum over (b, segment) on ``stream`` of ``device``, each
// where its bit of ``parts`` is set (1, 2, 4, 8: the gradient needs all
// four, 15; one alone is for timing it); does not synchronise and
// allocates nothing.  Returns the first CUDA error of
// the launches (0 on success).  The caller checks the shapes, S % 16 == 0
// and hd in {16, 32, 64}.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* states, const void* dy,
                               const void* ds_end, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* ds0,
                               void* fold_l, void* fold_d, void* carry,
                               void* du_part, int B, int S, int H, int hd,
                               int nseg, int parts, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || S <= 0 || S % kC || H <= 0 || H > 65535 ||
      nseg < 1 || nseg > S / kC)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (hd) {
#define WKV6_BWD_CASE(HD)                                                    \
  case HD:                                                                   \
    return launch<HD>(c(r), c(k), c(v), c(w), c(u), c(states), c(dy),        \
                      c(ds_end), m(dr), m(dk), m(dv), m(dw), m(du), m(ds0),  \
                      m(fold_l), m(fold_d), m(carry), m(du_part), B, S, H,   \
                      nseg, parts, device, st);
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
#undef WKV6_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
