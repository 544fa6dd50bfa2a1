// WKV6, the RWKV6 linear-attention recurrence, chunked, for Hopper (sm_90a):
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//
// Replaces repro/kernels/wkv6.py::_wkv6_kernel (the Pallas TPU kernel).  It
// computes the same function, chunk by chunk of C = 16 tokens, in float32:
// lw = max(log(max(w, 1e-38)), -9); cum = the inclusive prefix of lw over the
// chunk, cum_excl = cum - lw, ref = cum[C/2];
//   sc[t][s] = sum_d r[t,d] exp(cum_excl[t,d] - ref[d]) k[s,d] exp(ref[d] - cum[s,d])
//              for s < t, else 0
//   y[t] = sc[t] . v + (sum_d r[t,d] u[d] k[t,d]) v[t] + (r[t] * exp(cum_excl[t])) . S
//   S' = diag(exp(cum[C-1])) S + sum_s (k[s] * exp(cum[C-1] - cum[s])) v[s]^T
// and returns y and the state after the last chunk.
//
// What bounds it on this card: at rwkv6-3b's serving shape (B 8, S 2048,
// H 40, hd 64) the call reads r, k, v, w and writes y, 839 MB of float32
// (0.25 ms at 3.35 TB/s), against 13.4 GFLOP of products (0.20 ms at the
// 67 TFLOP/s float32 peak outside the tensor cores): bytes bound the
// function, with the products close behind.  This kernel is bound instead
// by one block's chain of 128 chunks and by the rate of TF32 mma.sync on
// an SM that holds three such chains.  What the design does:
//   * One block of 256 threads owns one (batch, head) and all hd value
//     columns and walks its chunks in order, so the decayed operands of a
//     chunk (a, b, rq, kd, the decay and the u diagonal) are made once (an
//     earlier design ran four blocks per head, one per 16 value columns,
//     each redoing them).  Thread (dim d, tokens 4q .. 4q + 3) makes them
//     from inputs staged in shared memory: the decay prefix is a sum over
//     its 4 tokens, then a scan of those sums over the 4 lanes of the dim
//     (two shuffles).  The next chunk's r, k, w, v are copied in by
//     cp.async while this one's products run, so no register holds a load
//     across the chunk.
//   * The products run on the tensor cores, mma.sync.m16n8k8 in TF32 with
//     the 3xTF32 split (x = hi + lo, a.b = a_lo b_hi + a_hi b_lo + a_hi
//     b_hi, float32 sums): about float32 accuracy, where one TF32 product
//     keeps about 3 digits, too few for 64-term sums at rtol 1e-3.  A
//     fragment read from shared memory feeds 8 to 16 multiply-adds, where
//     float32 FMAs fed from shared memory were bound by its bandwidth.
//       - the scores sc = a . b^T, 16 x 16, split over hd across warps
//         0-3, then summed by them with the mask: s < t kept, the u
//         diagonal on s == t, zeros above;
//       - the outputs, by warps 0-3, as one product y = [sc | rq] . [v ; S]
//         of depth 16 + hd, two n-tiles of 8 columns a warp at hd 64, the
//         two small TF32 products in one accumulator and the large one in
//         another, ordered so that back-to-back mma.sync do not wait on one
//         another;
//       - the state update S' = diag(decay) S + kd^T v, by warps 4-7 at the
//         same time as the scores and outputs (it needs only the old state,
//         kd, v and the decay): warp 4 + m holds rows 16 m .. 16 m + 15 of
//         S in float32 accumulator registers across all chunks and publishes
//         them to shared memory at the start of the next chunk, where the
//         outputs read them.
//     Row strides are padded so that a warp's fragment reads fall in 32
//     distinct banks.  Two block barriers and two of warps 0-3 a chunk.
//   * 320 blocks at the serving shape, three resident on an SM (at most 80
//     registers a thread, 64 KB of shared memory a block): one wave, with
//     56 SMs holding three blocks and 76 two.  Splitting the sequence into
//     segments would fill the card evenly, but each segment then needs the
//     state of the ones before it: a correction pass re-reads r and w and
//     rewrites y (up to 80% more bytes than the call must move), or a
//     state pass re-reads k, v and w.
// The inputs are read in place in their [B, S, H, hd] layout, with no
// transposes.  Masked scores (s > t) are computed but never kept: their
// exponents can overflow, and a select drops them.  The decay prefix is
// added in another order than a sequential cumsum, which moves the output
// by about 1e-6 relative; the exponentials are __expf (MUFU ex2), within
// about 1e-5 relative for arguments up to the 72 the clamp allows.
//
// Training adds one output: the instance kStates = true also writes the
// state entering every chunk, [B, H, S / 16, hd, hd] float32, which
// wkv6_bwd.cu reads (the state warps store their accumulators when they
// publish them).  It may take 128 registers a thread (two blocks an SM,
// where the 80 of three spill those stores); training runs one block a
// (batch, head) at B 1, 40 blocks.  The serving instance, kStates = false,
// has none of that code.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kC = 16;                 // tokens per chunk
constexpr int kThreads = 256;
constexpr float kLogWMin = -9.0f;

// Row strides (floats) chosen so that the fragment reads of a warp fall in
// 32 distinct banks: a, b and rq are read as [row g][column tg] (a stride
// of 4 or 20 mod 32), kd and Bm as [row tg][column g] (a stride of 8 or 24
// mod 32).
template <int HD>
struct Smem {
  static constexpr int PR = HD + 4;            // a, b, rq and staged rows
  static constexpr int PK = HD + 8;            // kd and Bm rows
  static constexpr int SW = HD / 8 < 4 ? HD / 8 : 4;   // warps of the scores
  alignas(16) float stage[4][kC][PR];          // the next chunk's r, k, w, v
  alignas(16) float a[kC][PR];                 // r exp(cum_excl - ref)
  alignas(16) float b[kC][PR];                 // k exp(ref - cum)
  alignas(16) float rq[kC][PR];                // r exp(cum_excl)
  alignas(16) float kd[kC][PK];                // k exp(cum_last - cum)
  alignas(16) float Bm[kC + HD][PK];           // [v ; S], S as [d][j]
  alignas(16) float sp[SW][kC][kC + 4];        // the scores' partial sums
  alignas(16) float sc[kC][kC + 4];            // the scores, masked
  alignas(16) float decay[HD];                 // exp(cum_last)
  float diag_part[HD / 8][kC];                 // r u k summed over 8 dims
};

template <int HD, bool kStates>
__global__ void __launch_bounds__(kThreads, kStates ? 2 : 3)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_end, int S, int H,
            float* __restrict__ states) {
  static_assert(HD == 16 || HD == 32 || HD == 64, "hd in {16, 32, 64}");
  constexpr int NT = HD / 8;                   // n-tiles of 8 value columns
  constexpr int YW = NT < 4 ? NT : 4;          // warps of the output product
  constexpr int YN = NT / YW;                  // n-tiles an output warp
  constexpr int SW = Smem<HD>::SW;             // warps of the scores
  constexpr int SK = HD / SW;                  // dims a score warp sums
  constexpr int NH = NT < 4 ? NT : 4;          // state n-tiles loaded at once
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int h = blockIdx.x, bb = blockIdx.y;
  const size_t row = static_cast<size_t>(H) * HD;     // one token's stride
  const size_t base = static_cast<size_t>(bb) * S * row +
                      static_cast<size_t>(h) * HD;    // token 0 of (b, h)
  const size_t sbase = (static_cast<size_t>(bb) * H + h) * HD * HD;

  // phase A: dim d = 8 warp + dd of tokens 4 tq .. 4 tq + 3, lane 8 tq +
  // dd; the 4 lanes of one dim are 8 apart.  Staging: float4 (token st,
  // dims sj .. sj + 3) of each input
  const bool has_in = tid < kC * HD / 4;   // whole warps
  const int tq = lane >> 3, d = 8 * warp + (lane & 7);
  const int st = tid / (HD / 4), sj = 4 * (tid % (HD / 4));
  const float ud = has_in ? u[h * HD + d] : 0.f;
  // the state: warp 4 + m holds rows 16 m .. 16 m + 15 of S as the
  // accumulators of NT m16n8 tiles
  const int mt = warp - 4;
  const bool has_s = mt >= 0 && mt < HD / 16;
  const int d0 = 16 * mt + g;               // rows d0 (c0, c1), d0 + 8 (c2, c3)

  float sacc[NT][4];
  if (has_s) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = 8 * n + 2 * tg;
      if (s0) {
        const float2 x0 = *reinterpret_cast<const float2*>(
            s0 + sbase + static_cast<size_t>(d0) * HD + j);
        const float2 x1 = *reinterpret_cast<const float2*>(
            s0 + sbase + static_cast<size_t>(d0 + 8) * HD + j);
        sacc[n][0] = x0.x; sacc[n][1] = x0.y;
        sacc[n][2] = x1.x; sacc[n][3] = x1.y;
      } else {
        sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
      }
    }
  }

  // the next chunk's inputs go to shared memory by cp.async, so no
  // register holds a load in flight; each thread waits for its own copies
  // before the barrier that opens the chunk
  auto fetch = [&](int t0) {
    if (has_in) {
      const size_t o = base + static_cast<size_t>(t0 + st) * row + sj;
      cp_async16(&sm.stage[0][st][sj], r + o);
      cp_async16(&sm.stage[1][st][sj], k + o);
      cp_async16(&sm.stage[2][st][sj], w + o);
      cp_async16(&sm.stage[3][st][sj], v + o);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  fetch(0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const int n_chunks = S / kC;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kC;
    __syncthreads();   // this chunk's inputs are staged; the last one is read
    if (has_s) {       // the state entering this chunk, for the outputs
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = 8 * n + 2 * tg;
        *reinterpret_cast<float2*>(&sm.Bm[kC + d0][j]) =
            make_float2(sacc[n][0], sacc[n][1]);
        *reinterpret_cast<float2*>(&sm.Bm[kC + d0 + 8][j]) =
            make_float2(sacc[n][2], sacc[n][3]);
      }
      if constexpr (kStates) {   // the state entering chunk ci
        float* st = states + (sbase / (HD * HD) * (S / kC) + ci) * HD * HD;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int j = 8 * n + 2 * tg;
          *reinterpret_cast<float2*>(st + static_cast<size_t>(d0) * HD + j) =
              make_float2(sacc[n][0], sacc[n][1]);
          *reinterpret_cast<float2*>(st + static_cast<size_t>(d0 + 8) * HD + j) =
              make_float2(sacc[n][2], sacc[n][3]);
        }
      }
    }
    // A: the decayed operands of dim d at this thread's 4 tokens.  The
    // decay prefix: a sum over the thread's tokens, then a scan of those
    // sums over the 4 lanes of the dim (two shuffles)
    if (has_in) {
      *reinterpret_cast<float4*>(&sm.Bm[st][sj]) =
          *reinterpret_cast<const float4*>(&sm.stage[3][st][sj]);
      float lw[4], cm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lw[i] = fmaxf(logf(fmaxf(sm.stage[2][4 * tq + i][d], 1e-38f)),
                      kLogWMin);
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
      const float ref = __shfl_sync(0xffffffffu, cm[0], 16 + (lane & 7));
      const float last = __shfl_sync(0xffffffffu, cm[3], 24 + (lane & 7));
      float dp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        const float rv = sm.stage[0][t][d], kv = sm.stage[1][t][d];
        const float ce = cm[i] - lw[i];
        sm.a[t][d] = rv * __expf(ce - ref);
        sm.b[t][d] = kv * __expf(ref - cm[i]);
        sm.rq[t][d] = rv * __expf(ce);
        sm.kd[t][d] = kv * __expf(last - cm[i]);
        dp[i] = rv * ud * kv;
      }
      if (tq == 0) sm.decay[d] = __expf(last);
      // the u diagonal: this warp's 8 dims of each token
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int m = 1; m < 8; m <<= 1)
          dp[i] += __shfl_xor_sync(0xffffffffu, dp[i], m);
      }
      if ((lane & 7) == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sm.diag_part[warp][4 * tq + i] = dp[i];
      }
    }
    __syncthreads();
    if (ci + 1 < n_chunks) fetch(t0 + kC);   // the staged inputs are read

    if (warp < 4) {
      // B (warps 0 .. SW - 1): partial scores a . b^T over dims [SK w,
      // SK (w + 1)); the two small TF32 products in one accumulator, the
      // large one in another
      if (warp < SW) {
        float c[2][2][4] = {};
#pragma unroll
        for (int k0 = SK * warp; k0 < SK * (warp + 1); k0 += 8) {
          FragA fa;
          fa.load(&sm.a[0][0], Smem<HD>::PR, k0, g, tg);
          FragB fb[2];
#pragma unroll
          for (int n = 0; n < 2; ++n)
            fb[n].load(sm.b[8 * n + g][k0 + tg], sm.b[8 * n + g][k0 + tg + 4]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_tf32(c[0][n], fa.lo, fb[n].hi[0], fb[n].hi[1]);
            mma_tf32(c[1][n], fa.hi, fb[n].hi[0], fb[n].hi[1]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_tf32(c[0][n], fa.hi, fb[n].lo[0], fb[n].lo[1]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s = 8 * n + 2 * tg;
          *reinterpret_cast<float2*>(&sm.sp[warp][g][s]) =
              make_float2(c[0][n][0] + c[1][n][0], c[0][n][1] + c[1][n][1]);
          *reinterpret_cast<float2*>(&sm.sp[warp][g + 8][s]) =
              make_float2(c[0][n][2] + c[1][n][2], c[0][n][3] + c[1][n][3]);
        }
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      // the scores summed: s < t kept, the u diagonal on s == t, zeros
      // above (two entries a thread)
#pragma unroll
      for (int e = tid; e < kC * kC; e += 128) {
        const int t = e / kC, s = e % kC;
        float x = 0.f, dg = 0.f;
#pragma unroll
        for (int q = 0; q < SW; ++q) x += sm.sp[q][t][s];
#pragma unroll
        for (int q = 0; q < HD / 8; ++q) dg += sm.diag_part[q][t];
        sm.sc[t][s] = s < t ? x : (s == t ? dg : 0.f);
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      // C (warps 0 .. YW - 1): y = [sc | rq] . [v ; S], YN n-tiles a warp
      if (warp < YW) {
        float acc[2][YN][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < kC + HD; k0 += 8) {
          FragA fa;
          if (k0 < kC)
            fa.load(&sm.sc[0][0], kC + 4, k0, g, tg);
          else
            fa.load(&sm.rq[0][0], Smem<HD>::PR, k0 - kC, g, tg);
          FragB fb[YN];
#pragma unroll
          for (int n = 0; n < YN; ++n) {
            const int j = 8 * (warp * YN + n) + g;
            fb[n].load(sm.Bm[k0 + tg][j], sm.Bm[k0 + tg + 4][j]);
          }
#pragma unroll
          for (int n = 0; n < YN; ++n) {
            mma_tf32(acc[0][n], fa.lo, fb[n].hi[0], fb[n].hi[1]);
            mma_tf32(acc[1][n], fa.hi, fb[n].hi[0], fb[n].hi[1]);
          }
#pragma unroll
          for (int n = 0; n < YN; ++n)
            mma_tf32(acc[0][n], fa.hi, fb[n].lo[0], fb[n].lo[1]);
        }
#pragma unroll
        for (int n = 0; n < YN; ++n) {
          const int j = 8 * (warp * YN + n) + 2 * tg;
          float o[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i] = acc[0][n][i] + acc[1][n][i];
          *reinterpret_cast<float2*>(y + base + static_cast<size_t>(t0 + g) * row + j) =
              make_float2(o[0], o[1]);
          *reinterpret_cast<float2*>(y + base + static_cast<size_t>(t0 + g + 8) * row + j) =
              make_float2(o[2], o[3]);
        }
      }
    } else if (has_s) {
      // the state update: S' = diag(decay) S + kd^T v, rows d0 and d0 + 8;
      // NH n-tiles at a time, each TF32 product over them in turn, so that
      // back-to-back mma.sync do not wait on one another
      const float e0 = sm.decay[d0], e1 = sm.decay[d0 + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        sacc[n][0] *= e0; sacc[n][1] *= e0;
        sacc[n][2] *= e1; sacc[n][3] *= e1;
      }
#pragma unroll
      for (int k0 = 0; k0 < kC; k0 += 8) {
        FragA fa;                         // kd^T: rows d, columns s
        split(sm.kd[k0 + tg][d0], fa.hi[0], fa.lo[0]);
        split(sm.kd[k0 + tg][d0 + 8], fa.hi[1], fa.lo[1]);
        split(sm.kd[k0 + tg + 4][d0], fa.hi[2], fa.lo[2]);
        split(sm.kd[k0 + tg + 4][d0 + 8], fa.hi[3], fa.lo[3]);
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += NH) {
          FragB fb[NH];
#pragma unroll
          for (int n = 0; n < NH; ++n)
            fb[n].load(sm.Bm[k0 + tg][8 * (n0 + n) + g],
                       sm.Bm[k0 + tg + 4][8 * (n0 + n) + g]);
#pragma unroll
          for (int n = 0; n < NH; ++n)
            mma_tf32(sacc[n0 + n], fa.lo, fb[n].hi[0], fb[n].hi[1]);
#pragma unroll
          for (int n = 0; n < NH; ++n)
            mma_tf32(sacc[n0 + n], fa.hi, fb[n].lo[0], fb[n].lo[1]);
#pragma unroll
          for (int n = 0; n < NH; ++n)
            mma_tf32(sacc[n0 + n], fa.hi, fb[n].hi[0], fb[n].hi[1]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }

  if (has_s) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = 8 * n + 2 * tg;
      *reinterpret_cast<float2*>(s_end + sbase + static_cast<size_t>(d0) * HD + j) =
          make_float2(sacc[n][0], sacc[n][1]);
      *reinterpret_cast<float2*>(s_end + sbase + static_cast<size_t>(d0 + 8) * HD + j) =
          make_float2(sacc[n][2], sacc[n][3]);
    }
  }
}

template <int HD, bool kStates>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_end,
           float* states, int B, int S, int H, int device,
           cudaStream_t stream) {
  static int attr_device = -1;
  if (attr_device != device) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<HD, kStates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem<HD>)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_device = device;
  }
  const dim3 grid(H, B);
  wkv6_kernel<HD, kStates><<<grid, kThreads, sizeof(Smem<HD>), stream>>>(
      r, k, v, w, u, s0, y, s_end, S, H, states);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const float* r, const float* k, const float* v, const float* w,
              const float* u, const float* s0, float* y, float* s_end,
              float* states, int B, int S, int H, int device,
              cudaStream_t stream) {
  if (states != nullptr)
    return launch<HD, true>(r, k, v, w, u, s0, y, s_end, states, B, S, H,
                            device, stream);
  return launch<HD, false>(r, k, v, w, u, s0, y, s_end, nullptr, B, S, H,
                           device, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  r, k, v, w, y: [B, S, H, hd];
// u: [H, hd]; s0 (may be null: zeros), s_end: [B, H, hd, hd]; states (may
// be null: the serving instance) [B, H, S / 16, hd, hd]; all float32,
// contiguous, 16-byte aligned device pointers.  Launches on ``stream`` of
// ``device``, does not synchronise and allocates nothing.  Returns the CUDA
// error of the launch (0 on success).  The caller checks the shapes,
// S % 16 == 0 and hd in {16, 32, 64}.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_end, void* states, int B, int S,
                           int H, int hd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || S % kC) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* ef = static_cast<float*>(s_end);
  auto* tf = static_cast<float*>(states);
  switch (hd) {
    case 16: return launch_hd<16>(rf, kf, vf, wf, uf, sf, yf, ef, tf, B, S, H, device, st);
    case 32: return launch_hd<32>(rf, kf, vf, wf, uf, sf, yf, ef, tf, B, S, H, device, st);
    case 64: return launch_hd<64>(rf, kf, vf, wf, uf, sf, yf, ef, tf, B, S, H, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

