// The gradient of the Mamba selective scan for Hopper (sm_90a).  The
// forward (mamba_scan.cu) computes
//
//   h_t = e_t h_{t-1} + x_t B_t,  e_t = exp(dt_t A),  x_t = dt_t u_t,
//   y_t = C_t . h_t
//
// for every (b, d) channel and its N states.  This kernel replaces no
// Pallas kernel: the JAX package differentiates its scan
// (repro/kernels/ref.py::mamba_scan_ref, the function of
// repro/kernels/mamba_scan.py::_mamba_kernel) with jax.grad.  Given dy and
// the gradient of h_end it walks time in reverse with g, the gradient of
// h_t:
//
//   g_t = C_t dy_t + e_{t+1} g_{t+1}          (g_{S-1} adds dh_end)
//   du_t = dt_t sum_n g_t B_t,  d(dt)_t = u_t sum_n g_t B_t
//          + sum_n g_t h_{t-1} e_t A
//   dA += g_t h_{t-1} e_t dt_t,  dB_t = sum_d g_t x_t,  dC_t = sum_d dy_t h_t
//   dh0 = e_0 g_0
//
// h_{t-1} is never had by dividing out e_t: exp(dt A) underflows to 0 at
// jamba's A and dt.  The forward's training instance writes the state
// entering every tile of 64 steps ([B, S/64, D, N] float32), and this
// kernel recomputes the states from it.
//
// What bounds it on this card: at jamba's training microbatch (B 1, S 4096,
// D 16,384, N 16) the function reads u, dt and dy and writes du and d(dt),
// 1.34 GB of float32, 0.40 ms at 3.35 TB/s; it takes one exponential per
// (b, t, d, n), 1.07 G (0.26 ms on the special-function units at 16 per SM
// per clock on 132 SMs at 1.98 GHz), and some 20 float32 operations each.
// A first design (one thread per (channel, state), 64 recomputed states in
// registers) took 5.8 ms: each reverse step's sums over n and over d were
// chains of lane shuffles, some 60 instructions per (channel, state) step.
// What this design does:
//   * Thread (channel d, state group q) holds 4 of the channel's N states
//     (G = N / 4 lanes a channel, 32 / G channels a warp), so the sums over
//     n (sum_n g B, sum_n g h e A) are 3 adds in registers; d(dt) is
//     linear in them, so the channel's lanes reduce-scatter the pair
//     (sum_n g B, d(dt)) in log2 G = 2 shuffles at N 16, and lanes q 0 and
//     1 write du and d(dt).  The 4 states are independent chains: the
//     throughput comes from them and from 16 warps an SM (a block of 512
//     threads, 128 channels at N 16, one block an SM: 128 blocks at B 1).
//   * The sums over d, dB_t and dC_t: each lane's 8 values (4 of g x, 4 of
//     dy h) are reduce-scattered over the warp's channels in 3 halving
//     steps (lanes whose bit is set keep the upper half and add their
//     partner's), 7 shuffles a step, leaving lane (v << 2 | q) with the
//     warp's sum of value v of group q; the block adds its 16 warps' sums
//     in a fixed order every 8 steps and writes one partial per block of
//     128 channels ([D/128, B, S, N] each for dB and dC, 33.5 MB at the
//     training shape), which a launch of fixed order sums (fixed_sum.cuh).
//   * h_{t-1} comes from a two-level checkpoint: a tile's pass forward from
//     the forward's checkpoint keeps the state entering each of its 8
//     sub-tiles of 8 steps in shared memory (64 KB a block); each sub-tile,
//     latest first, recomputes its 8 states and their e_t into registers
//     (64 a thread) and walks them in reverse, reusing e_t: 1.875
//     exponentials per element (the first pass skips the last sub-tile),
//     ex2.approx(dt * A log2 e) as in the forward.
//   * A tile's B_t and C_t, and a sub-tile's dt, u and dy of the block's
//     channels, come into shared memory by cp.async a tile and a sub-tile
//     ahead; u and dt of the next tile are prefetched into L2 for its
//     first pass, which reads them from there one sub-tile ahead in
//     registers.  Steps past S and channels past D read zeros: dt = u = dy
//     = B = C = 0 gives e = 1 and adds nothing, so g and the sums pass
//     through unchanged and an idle lane adds nothing to dB and dC.
//   The walk is bound by its instruction rate: a reverse step is some 90
//   instructions a lane (4 states), of which the sums over d take about
//   36; the first pass, 4 exponentials a step a lane, by the
//   special-function units.
// dA is summed per (b, d, n) over time, then over b by a launch of fixed
// order.  No atomics: the gradient repeats bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // steps between the forward's checkpoints
constexpr int kSub = 8;          // steps of a sub-tile
constexpr int kNSub = kTile / kSub;
constexpr int kNS = 4;           // states a thread holds

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// v[0 .. 2K) -> v[0 .. K): the lanes whose bit m is set keep the upper
// half, the others the lower, each adding its partner's copy
template <int K>
__device__ __forceinline__ void halve(float* v, int m, int lane) {
  const bool up = lane & m;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    const float send = up ? v[e] : v[e + K];
    const float keep = up ? v[e + K] : v[e];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

template <int N>
struct Cfg {
  static constexpr int G = N / kNS;                  // lanes a channel
  static constexpr int CPW = 32 / G;                 // channels a warp
  static constexpr int CPB = kWarps * CPW;           // channels a block
};

// shared memory, in floats: the tile's B and C, two buffers [step][B n |
// C n]; the sub-tiles' entering states [sub][state][thread]; a sub-tile's
// dt, u and dy of the block's channels, two buffers [array][step][channel];
// the warps' sums of dB and dC, two buffers [warp][step][lane]
template <int N>
struct Layout {
  static constexpr int bc = 0;
  static constexpr int chk = bc + 2 * kTile * 2 * N;
  static constexpr int stage = chk + kNSub * kNS * kThreads;
  static constexpr int part = stage + 2 * 3 * kSub * Cfg<N>::CPB;
  static constexpr int floats = part + 2 * kWarps * kSub * 32;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
mamba_scan_bwd_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bin,
                      const float* __restrict__ Cin,
                      const float* __restrict__ chk,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh_end,
                      float* __restrict__ du, float* __restrict__ ddt,
                      float* __restrict__ dA_part, float* __restrict__ dh0,
                      float* __restrict__ part_b, float* __restrict__ part_c,
                      int Bsz, int S, int D) {
  using C = Cfg<N>;
  using L = Layout<N>;
  constexpr int CPB = C::CPB;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) float smem[];
  float* sbc = smem + L::bc;
  float* schk = smem + L::chk;
  float* sstage = smem + L::stage;
  float* spart = smem + L::part;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane % C::G, ch = warp * C::CPW + lane / C::G;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int c0 = blk * CPB;                    // the block's first channel
  const int d = c0 + ch;
  const bool active = d < D;
  const int dc = active ? d : D - 1;           // idle lanes read a channel
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t row = static_cast<size_t>(D);
  const size_t bs = static_cast<size_t>(b) * S;
  const int wd = c0 + warp * C::CPW;           // the warp's first channel

  float a2[kNS], g[kNS], da[kNS];
  {
    const float4 av = *reinterpret_cast<const float4*>(
        A + static_cast<size_t>(dc) * N + kNS * q);
    a2[0] = av.x * kLog2e; a2[1] = av.y * kLog2e;
    a2[2] = av.z * kLog2e; a2[3] = av.w * kLog2e;
    const float4 ge = dh_end != nullptr
        ? *reinterpret_cast<const float4*>(
              dh_end + (static_cast<size_t>(b) * D + dc) * N + kNS * q)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    g[0] = ge.x; g[1] = ge.y; g[2] = ge.z; g[3] = ge.w;
#pragma unroll
    for (int s = 0; s < kNS; ++s) da[s] = 0.f;
  }

  // the tile's B and C: rows past S are zeros
  auto fetch_bc = [&](int j, int buf) {
    const int t0 = j * kTile;
    float* dst = sbc + buf * kTile * 2 * N;
    for (int e = tid; e < kTile * 2 * N / 4; e += kThreads) {
      const int i = e / (2 * N / 4), c4 = 4 * (e % (2 * N / 4));
      float* o = dst + i * 2 * N + c4;
      if (t0 + i < S)
        cp_async16(o, (c4 < N ? Bin : Cin) + (bs + t0 + i) * N + c4 % N);
      else
        *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // dt, u and dy of the block's channels at steps ts .. ts + kSub - 1:
  // zeros past S and past D, so an idle lane adds nothing to dB and dC.
  // 16 bytes a copy where rows are 16-byte aligned (D % 4 == 0), else 4
  auto fetch_stage = [&](int ts, int buf) {
    float* dst = sstage + buf * 3 * kSub * CPB;
    if (D % 4 == 0) {
      for (int e = tid; e < 3 * kSub * CPB / 4; e += kThreads) {
        const int a = e / (kSub * CPB / 4), i = (e / (CPB / 4)) % kSub;
        const int c = 4 * (e % (CPB / 4));
        float* o = dst + (a * kSub + i) * CPB + c;
        if (ts + i < S && c0 + c < D)
          cp_async16(o, (a == 0 ? dt : (a == 1 ? u : dy)) + (bs + ts + i) * row +
                             c0 + c);
        else
          *reinterpret_cast<float4*>(o) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < 3 * kSub * CPB; e += kThreads) {
        const int a = e / (kSub * CPB), i = (e / CPB) % kSub, c = e % CPB;
        float* o = dst + (a * kSub + i) * CPB + c;
        if (ts + i < S && c0 + c < D)
          cp_async4(o, (a == 0 ? dt : (a == 1 ? u : dy)) + (bs + ts + i) * row +
                            c0 + c);
        else
          *o = 0.f;
      }
    }
  };
  // u and dt of tile j into L2 for its first pass: lane l of each warp
  // takes (step, array) pairs l, l + 32, ... at the warp's first channel
  auto prefetch_tile = [&](int j) {
    if (wd >= D) return;
    const int t0 = j * kTile;
    for (int e = lane; e < 2 * kTile; e += 32) {
      const int i = e >> 1;
      if (t0 + i < S) prefetch_l2((e & 1 ? u : dt) + (bs + t0 + i) * row + wd);
    }
  };
  // dt and u of steps t0 .. t0 + kSub - 1 of this channel (0 past S)
  auto load_sub = [&](int t0, float (&dtr)[kSub], float (&ur)[kSub]) {
    const float* pd = dt + (bs + t0) * row + dc;
    const float* pu = u + (bs + t0) * row + dc;
#pragma unroll
    for (int i = 0; i < kSub; ++i, pd += row, pu += row) {
      const bool ok = t0 + i < S;
      dtr[i] = ok ? *pd : 0.f;
      ur[i] = ok ? *pu : 0.f;
    }
  };
  // the block's sums of dB_t and dC_t at steps ts .. ts + kSub - 1 over
  // its warps, in order, from the part buffer pbuf
  auto block_sums = [&](int ts, int pbuf) {
    if (tid < kSub * 2 * N) {
      const int i = tid / (2 * N), r = tid % (2 * N);
      const int which = r / N, n = r % N;
      const int l = ((which * kNS + n % kNS) << 2) | (n / kNS);
      const float* pp = spart + pbuf * kWarps * kSub * 32 + i * 32 + l;
      float part[4] = {0.f, 0.f, 0.f, 0.f};    // 4 chains, added in order
#pragma unroll
      for (int w = 0; w < kWarps; ++w) part[w % 4] += pp[w * kSub * 32];
      const float sum = (part[0] + part[1]) + (part[2] + part[3]);
      if (ts + i < S)
        (which ? part_c : part_b)[((static_cast<size_t>(blk) * Bsz + b) * S +
                                   ts + i) * N + n] = sum;
    }
  };

  fetch_bc(n_tiles - 1, 0);
  fetch_stage((n_tiles - 1) * kTile + (kNSub - 1) * kSub, 0);
  cp_commit();
  int it = 0, pend_ts = 0;                      // sub-tiles walked so far
  for (int j = n_tiles - 1; j >= 0; --j) {
    const int t0 = j * kTile, buf = (n_tiles - 1 - j) & 1;
    const float* tbc = sbc + buf * kTile * 2 * N;
    cp_wait_all();
    __syncthreads();   // this tile's B and C are in; the last tile is done
    if (j > 0) {
      fetch_bc(j - 1, buf ^ 1);
      cp_commit();
      prefetch_tile(j - 1);
    }

    // pass 1: forward from the checkpoint, keeping the state entering
    // each sub-tile; dt and u one sub-tile ahead in registers
    {
      const float4 hv = *reinterpret_cast<const float4*>(
          chk + ((static_cast<size_t>(b) * n_tiles + j) * D + dc) * N +
          kNS * q);
      float h[kNS] = {hv.x, hv.y, hv.z, hv.w};
      float dtn[kSub], un[kSub];
      load_sub(t0, dtn, un);
#pragma unroll 1
      for (int k = 0; k < kNSub - 1; ++k) {
        float dtr[kSub], ur[kSub];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          dtr[i] = dtn[i];
          ur[i] = un[i];
        }
        if (k + 2 < kNSub) load_sub(t0 + (k + 1) * kSub, dtn, un);
#pragma unroll
        for (int s = 0; s < kNS; ++s)
          schk[(k * kNS + s) * kThreads + tid] = h[s];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float4 bv = *reinterpret_cast<const float4*>(
              tbc + (k * kSub + i) * 2 * N + kNS * q);
          const float bn[kNS] = {bv.x, bv.y, bv.z, bv.w};
          const float x = dtr[i] * ur[i];
#pragma unroll
          for (int s = 0; s < kNS; ++s)
            h[s] = ex2(dtr[i] * a2[s]) * h[s] + x * bn[s];
        }
      }
#pragma unroll
      for (int s = 0; s < kNS; ++s)
        schk[((kNSub - 1) * kNS + s) * kThreads + tid] = h[s];
    }

    // pass 2: each sub-tile, latest first: its states and decays
    // recomputed into registers, then its steps in reverse
#pragma unroll 1
    for (int k = kNSub - 1; k >= 0; --k, ++it) {
      const int ts = t0 + k * kSub;               // the sub-tile's step 0
      cp_wait_all();
      __syncthreads();   // its dt, u, dy are in; the last part is written
      if (ts > 0) {      // the next sub-tile, in this tile or the last
        fetch_stage(ts - kSub, (it + 1) & 1);
        cp_commit();
      }
      if (it > 0) block_sums(pend_ts, (it + 1) & 1);
      const float* sdt = sstage + (it & 1) * 3 * kSub * CPB + ch;
      const float* su = sdt + kSub * CPB;
      const float* sdy = su + kSub * CPB;
      float hin[kNS], hs[kSub][kNS], es[kSub][kNS];
#pragma unroll
      for (int s = 0; s < kNS; ++s)
        hin[s] = schk[(k * kNS + s) * kThreads + tid];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float4 bv = *reinterpret_cast<const float4*>(
            tbc + (k * kSub + i) * 2 * N + kNS * q);
        const float bn[kNS] = {bv.x, bv.y, bv.z, bv.w};
        const float dti = sdt[i * CPB];
        const float x = dti * su[i * CPB];
#pragma unroll
        for (int s = 0; s < kNS; ++s) {
          es[i][s] = ex2(dti * a2[s]);
          hs[i][s] = es[i][s] * (i ? hs[i - 1][s] : hin[s]) + x * bn[s];
        }
      }
      float* wpart = spart + ((it & 1) * kWarps + warp) * kSub * 32;
      // where this lane writes du (or d(dt), lane q 1) at the sub-tile's
      // last step; the walk steps it back a row a step
      const bool store = active && (C::G == 1 || q < 2);
      const size_t last = (bs + ts + kSub - 1) * row + dc;
      float* pdu = (C::G > 1 && q == 1 ? ddt : du) + last;
      float* pddt = ddt + last;                 // N 4: one lane a channel
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const float* bc = tbc + (k * kSub + i) * 2 * N + kNS * q;
        const float4 bv = *reinterpret_cast<const float4*>(bc);
        const float4 cv = *reinterpret_cast<const float4*>(bc + N);
        const float bn[kNS] = {bv.x, bv.y, bv.z, bv.w};
        const float cn[kNS] = {cv.x, cv.y, cv.z, cv.w};
        const float dti = sdt[i * CPB], ui = su[i * CPB], dyi = sdy[i * CPB];
        const float x = dti * ui;
        float sx = 0.f, sq = 0.f, v[2 * kNS];   // sx = sum_n g B, sq: g h e A
#pragma unroll
        for (int s = 0; s < kNS; ++s) {
          g[s] = fmaf(cn[s], dyi, g[s]);                       // g_t
          const float ge = g[s] * (i ? hs[i - 1][s] : hin[s]) * es[i][s];
          da[s] = fmaf(ge, dti, da[s]);
          sx = fmaf(g[s], bn[s], sx);
          sq = fmaf(ge, a2[s], sq);
          v[s] = g[s] * x;                                     // dB's share
          v[kNS + s] = dyi * hs[i][s];                         // dC's share
          g[s] = es[i][s] * g[s];                              // e_t g_t
        }
        // d(dt) = u sx + sq is linear in the lanes' shares: the channel's
        // lanes reduce-scatter (sx, d(dt)), even lanes keeping sx
        float t = fmaf(ui, sx, sq * kLn2);
        if (C::G >= 2) {
          const float send = q & 1 ? sx : t;
          sx = (q & 1 ? t : sx) + __shfl_xor_sync(0xffffffffu, send, 1);
#pragma unroll
          for (int m = 2; m < C::G; m <<= 1)
            sx += __shfl_xor_sync(0xffffffffu, sx, m);
        }
        // over d: reduce-scatter the 8 values over the warp's channels
        halve<4>(v, 16, lane);
        halve<2>(v, 8, lane);
        halve<1>(v, 4, lane);
#pragma unroll
        for (int m = 2; m >= C::G; m >>= 1)
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
        wpart[i * 32 + lane] = v[0];
        if (store && ts + i < S) {
          if (C::G == 1) {
            *pdu = sx * dti;
            *pddt = t;
          } else {                  // du by lane q 0, d(dt) by lane q 1
            *pdu = q ? sx : sx * dti;
          }
        }
        pdu -= row;
        pddt -= row;
      }
      pend_ts = ts;
    }
  }
  __syncthreads();   // the last sub-tile's sums are in
  block_sums(pend_ts, (it + 1) & 1);

  if (active) {
    const size_t o = (static_cast<size_t>(b) * D + d) * N + kNS * q;
    *reinterpret_cast<float4*>(dh0 + o) = make_float4(g[0], g[1], g[2], g[3]);
    *reinterpret_cast<float4*>(dA_part + o) =
        make_float4(da[0], da[1], da[2], da[3]);
  }
}

template <int N>
int launch(const float* u, const float* dt, const float* A, const float* B,
           const float* C, const float* chk, const float* dy,
           const float* dh_end, float* du, float* ddt, float* dA, float* dB,
           float* dC, float* dh0, float* part_b, float* part_c,
           float* part_a, int Bsz, int S, int D, int parts, int device,
           cudaStream_t st) {
  constexpr int bytes = Layout<N>::floats * 4;
  static int attr_device = -1;
  if (attr_device != device) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_device = device;
  }
  const int n_blk = (D + Cfg<N>::CPB - 1) / Cfg<N>::CPB;
  int rc = 0;
  if (parts & 1) {
    mamba_scan_bwd_kernel<N><<<dim3(n_blk, Bsz), kThreads, bytes, st>>>(
        u, dt, A, B, C, chk, dy, dh_end, du, ddt, part_a, dh0, part_b, part_c,
        Bsz, S, D);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0 && (parts & 2)) {
    const size_t bsn = static_cast<size_t>(Bsz) * S * N;
    rc = fixed_sum(part_b, dB, n_blk, bsn, st);
    if (rc == 0) rc = fixed_sum(part_c, dC, n_blk, bsn, st);
    if (rc == 0)
      rc = fixed_sum(part_a, dA, Bsz, static_cast<size_t>(D) * N, st);
  }
  return rc;
}

template <int N>
int resident() {
  constexpr int bytes = Layout<N>::floats * 4;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mamba_scan_bwd_kernel<N>, kThreads, bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// The channels a block owns at state size N (0 for an N the kernel does
// not take): the wrapper sizes the per-block partials [ceil(D / this), B,
// S, N] by it.
extern "C" int mamba_scan_bwd_block_channels(int N) {
  switch (N) {
    case 4: return Cfg<4>::CPB;
    case 8: return Cfg<8>::CPB;
    case 16: return Cfg<16>::CPB;
    default: return 0;
  }
}

// Blocks of the reverse walk resident on one SM at state size N, as the
// runtime computes them; -1 for an N the kernel does not take, or the CUDA
// error negated.
extern "C" int mamba_scan_bwd_resident(int N) {
  switch (N) {
    case 4: return resident<4>();
    case 8: return resident<8>();
    case 16: return resident<16>();
    default: return -1;
  }
}

// Plain C entry point, loaded with ctypes.  u, dt, dy and du, ddt:
// [B, S, D]; A, dA: [D, N]; B_in, C_in and dB, dC: [B, S, N]; chk:
// [B, ceil(S / 64), D, N] (the forward's training output); dh_end (may be
// null: zeros), dh0: [B, D, N]; scratch part_b, part_c: [ceil(D / block
// channels), B, S, N] and part_a: [B, D, N]; all float32, contiguous,
// 16-byte aligned device pointers.  Launches the reverse walk (bit 1 of
// ``parts``), then the sums of dB and dC over the blocks and of dA over b
// (bit 2), on ``stream`` of ``device``: the gradient needs both, 3; one
// alone is for timing it.  Does not synchronise and allocates nothing.
// Returns the
// first CUDA error of the launches (0 on success).  The caller checks the
// shapes and N in {4, 8, 16}.
extern "C" int mamba_scan_bwd_launch(
    const void* u, const void* dt, const void* A, const void* B_in,
    const void* C_in, const void* chk, const void* dy, const void* dh_end,
    void* du, void* ddt, void* dA, void* dB, void* dC, void* dh0,
    void* part_b, void* part_c, void* part_a, int Bsz, int S, int D, int N,
    int parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bsz <= 0 || Bsz > 65535 || S <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (N) {
#define MAMBA_BWD_CASE(NN)                                                   \
  case NN:                                                                   \
    return launch<NN>(c(u), c(dt), c(A), c(B_in), c(C_in), c(chk), c(dy),    \
                      c(dh_end), m(du), m(ddt), m(dA), m(dB), m(dC), m(dh0), \
                      m(part_b), m(part_c), m(part_a), Bsz, S, D, parts,     \
                      device, st);
    MAMBA_BWD_CASE(4)
    MAMBA_BWD_CASE(8)
    MAMBA_BWD_CASE(16)
#undef MAMBA_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
