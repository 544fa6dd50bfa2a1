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
// entering every tile of 64 steps ([B, S/64, D, N] float32, 67 MB at B 1,
// S 4096, D 16,384, N 16), and this kernel recomputes each tile's 64
// states from it before it walks the tile in reverse.
//
// What bounds it on this card: at jamba's training microbatch (B 1, S 4096,
// D 16,384, N 16) the call reads u, dt and dy and writes du and d(dt), 1.34
// GB of float32, and reads the checkpoints (67 MB): 1.41 GB, 0.42 ms at
// 3.35 TB/s (the per-block partials of dB and dC add 4 x 67 MB).  It takes two exponentials per (b, t, d, n), one to recompute
// the state and one in the reverse step (2 x 1.07 G, 0.51 ms at 16 per SM
// per clock on 132 SMs at 1.98 GHz), and some 20 float32 operations each.
// What the design does: the forward keeps one channel's 16 states in one
// thread's registers, but the reverse walk needs a tile's 64 states of
// each, 1,024 registers a thread.  So here a thread owns one (channel,
// state n) pair and keeps its 64 recomputed states in registers (the
// loops are unrolled); the sums over n (of g B and of g h e A) are N-lane
// shuffles.  A block of 256 threads owns 64 channels of one batch row,
// 256 / N at a time (4 passes at N 16) with each pass's g and dA kept in
// shared memory between tiles; grid (D / 64, B): 256 blocks at B 1, two
// resident on an SM (at most 128 registers a thread).  Each tile's B and C
// and each pass's u, dt and dy are staged in shared memory by the whole
// block, coalesced, and a ragged last tile is padded with steps that
// change nothing, so the 64 steps run unrolled with no branches and the
// steps' loads and shuffles overlap.  The sums over channels, dB_t and
// dC_t, are taken in each warp with shuffles, added per warp over the
// passes in shared memory, summed over the block's warps in a fixed order
// and written per block ([D/64, B, S, N], 67 MB each at the training
// shape); a second launch sums the blocks in a fixed order, and a third
// sums dA over b.  No atomics: the gradient repeats bit for bit.  The
// exponentials are ex2.approx(dt * A log2 e), as in the forward.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 64;    // channels a block owns
constexpr int kTile = 64;        // steps between the forward's checkpoints
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared memory, in floats: the warps' sums [warp][step][dB n | dC n];
// each pass's g and dA [pass][thread]; the tile's B and C [step][B n | C n];
// a pass's u, dt and dy [3][step][channel]
template <int N>
struct Layout {
  static constexpr int CPP = kThreads / N;           // channels a pass
  static constexpr int NP = kChannels / CPP;         // passes
  static constexpr int part = 0;
  static constexpr int carry = part + kWarps * kTile * 2 * N;
  static constexpr int dacc = carry + NP * kThreads;
  static constexpr int bc = dacc + NP * kThreads;
  static constexpr int udy = bc + kTile * 2 * N;
  static constexpr int floats = udy + 3 * kTile * CPP;
};

// two blocks an SM at jamba's N 16 (128 registers a thread); N 4 and 8 run
// several passes a tile and would spill at that cap, so they take one
template <int N>
__global__ void __launch_bounds__(kThreads, N >= 16 ? 2 : 1)
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
  using L = Layout<N>;
  constexpr int CPP = L::CPP, NP = L::NP;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) float smem[];
  float* part = smem + L::part;
  float* carry = smem + L::carry;
  float* dacc = smem + L::dacc;
  float* sbc = smem + L::bc;
  float* su = smem + L::udy;
  float* sdt = su + kTile * CPP;
  float* sdy = sdt + kTile * CPP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tid % N, ch = tid / N;
  const int b = blockIdx.y, blk = blockIdx.x;
  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t row = static_cast<size_t>(D);

  for (int p = 0; p < NP; ++p) {
    const int d = blk * kChannels + p * CPP + ch;
    carry[p * kThreads + tid] =
        dh_end != nullptr && d < D
            ? dh_end[(static_cast<size_t>(b) * D + d) * N + n] : 0.f;
    dacc[p * kThreads + tid] = 0.f;
  }

  for (int j = n_tiles - 1; j >= 0; --j) {
    const int t0 = j * kTile, nt = min(kTile, S - t0);
    float* wpart = part + warp * kTile * 2 * N;
    __syncthreads();   // the last tile's readers of its sums are done
    for (int i = lane; i < kTile * 2 * N; i += 32) wpart[i] = 0.f;
    // a ragged last tile is padded with steps of dt = u = dy = B = C = 0:
    // e = 1 and nothing is added, so g and the sums pass through unchanged
    for (int e = tid; e < kTile * 2 * N; e += kThreads) {
      const int i = e / (2 * N), q = e % (2 * N);
      sbc[e] = i < nt ? (q < N ? Bin : Cin)[(static_cast<size_t>(b) * S + t0
                                             + i) * N + q % N] : 0.f;
    }

#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      const int c0 = blk * kChannels + p * CPP;   // the pass's channel 0
      const int d = c0 + ch;
      const bool active = d < D;
      const int dc = active ? d : D - 1;       // idle lanes read a channel
      __syncthreads();   // the last pass's readers of u, dt, dy are done
      for (int e = tid; e < 3 * kTile * CPP; e += kThreads) {
        const int a = e / (kTile * CPP), i = (e / CPP) % kTile, c = e % CPP;
        const float* src = a == 0 ? u : (a == 1 ? dt : dy);
        const int cc = min(c0 + c, D - 1);
        su[e] = i < nt ? src[(static_cast<size_t>(b) * S + t0 + i) * row + cc]
                       : 0.f;
      }
      __syncthreads();
      const float a = A[static_cast<size_t>(dc) * N + n];
      const float a2 = a * kLog2e;
      const float h_in =
          chk[((static_cast<size_t>(b) * n_tiles + j) * D + dc) * N + n];

      // the tile's states h_{t0} .. h_{t0 + 63}, recomputed
      float hs[kTile];
      float h = h_in;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float dti = sdt[i * CPP + ch];
        h = ex2(dti * a2) * h + (dti * su[i * CPP + ch]) * sbc[i * 2 * N + n];
        hs[i] = h;
      }
      // the reverse walk
      float g = carry[p * kThreads + tid];
      float da_ = dacc[p * kThreads + tid];
#pragma unroll
      for (int i = kTile - 1; i >= 0; --i) {
        const float dti = sdt[i * CPP + ch], ui = su[i * CPP + ch];
        const float dyi = sdy[i * CPP + ch];
        const float bn = sbc[i * 2 * N + n], cn = sbc[i * 2 * N + N + n];
        g = fmaf(cn, dyi, g);                           // g_t
        const float e = ex2(dti * a2);
        const float hp = i ? hs[i - 1] : h_in;          // h_{t-1}
        const float ge = g * hp * e;
        da_ = fmaf(ge, dti, da_);
        float sx = g * bn, sq = ge * a;                 // sums over n
        float pb = active ? g * (dti * ui) : 0.f;       // sums over d
        float pc = active ? dyi * hs[i] : 0.f;
#pragma unroll
        for (int m = 1; m < N; m <<= 1) {
          sx += __shfl_xor_sync(0xffffffffu, sx, m);
          sq += __shfl_xor_sync(0xffffffffu, sq, m);
        }
#pragma unroll
        for (int m = N; m < 32; m <<= 1) {
          pb += __shfl_xor_sync(0xffffffffu, pb, m);
          pc += __shfl_xor_sync(0xffffffffu, pc, m);
        }
        if (lane < N) {
          wpart[i * 2 * N + n] += pb;
          wpart[i * 2 * N + N + n] += pc;
        }
        if (n == 0 && active && i < nt) {
          const size_t o = (static_cast<size_t>(b) * S + t0 + i) * row + d;
          du[o] = sx * dti;
          ddt[o] = fmaf(sx, ui, sq);
        }
        g = e * g;                                      // e_t g_t
      }
      carry[p * kThreads + tid] = g;
      dacc[p * kThreads + tid] = da_;
    }
    __syncthreads();   // every warp's sums of this tile are in

    // the block's sums of dB_t and dC_t, over its warps in order
    for (int e = tid; e < nt * 2 * N; e += kThreads) {
      const int i = e / (2 * N), q = e % (2 * N);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[(w * kTile + i) * 2 * N + q];
      float* out = q < N ? part_b : part_c;
      out[((static_cast<size_t>(blk) * Bsz + b) * S + t0 + i) * N + q % N] =
          s;
    }
  }

  for (int p = 0; p < NP; ++p) {
    const int d = blk * kChannels + p * CPP + ch;
    if (d < D) {
      const size_t o = (static_cast<size_t>(b) * D + d) * N + n;
      dh0[o] = carry[p * kThreads + tid];
      dA_part[o] = dacc[p * kThreads + tid];
    }
  }
}

template <int N>
int launch(const float* u, const float* dt, const float* A, const float* B,
           const float* C, const float* chk, const float* dy,
           const float* dh_end, float* du, float* ddt, float* dA, float* dB,
           float* dC, float* dh0, float* part_b, float* part_c,
           float* part_a, int Bsz, int S, int D, int device,
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
  const int n_blk = (D + kChannels - 1) / kChannels;
  mamba_scan_bwd_kernel<N><<<dim3(n_blk, Bsz), kThreads, bytes, st>>>(
      u, dt, A, B, C, chk, dy, dh_end, du, ddt, part_a, dh0, part_b, part_c,
      Bsz, S, D);
  int rc = static_cast<int>(cudaGetLastError());
  const size_t bsn = static_cast<size_t>(Bsz) * S * N;
  if (rc == 0) rc = fixed_sum(part_b, dB, n_blk, bsn, st);
  if (rc == 0) rc = fixed_sum(part_c, dC, n_blk, bsn, st);
  if (rc == 0) rc = fixed_sum(part_a, dA, Bsz, static_cast<size_t>(D) * N, st);
  return rc;
}

}  // namespace

// The channels a block owns: the wrapper sizes the per-block partials
// [ceil(D / this), B, S, N] by it.
extern "C" int mamba_scan_bwd_block_channels() { return kChannels; }

// Plain C entry point, loaded with ctypes.  u, dt, dy and du, ddt:
// [B, S, D]; A, dA: [D, N]; B_in, C_in and dB, dC: [B, S, N]; chk:
// [B, ceil(S / 64), D, N] (the forward's training output); dh_end (may be
// null: zeros), dh0: [B, D, N]; scratch part_b, part_c: [ceil(D / 64), B,
// S, N] and part_a: [B, D, N]; all float32, contiguous device pointers.
// Launches the reverse walk, then the sums of dB and dC over the blocks and
// of dA over b, on ``stream`` of ``device``; does not synchronise and
// allocates nothing.  Returns the first CUDA error of the launches (0 on
// success).  The caller checks the shapes and N in {4, 8, 16}.
extern "C" int mamba_scan_bwd_launch(
    const void* u, const void* dt, const void* A, const void* B_in,
    const void* C_in, const void* chk, const void* dy, const void* dh_end,
    void* du, void* ddt, void* dA, void* dB, void* dC, void* dh0,
    void* part_b, void* part_c, void* part_a, int Bsz, int S, int D, int N,
    int device, void* stream) {
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
                      m(part_b), m(part_c), m(part_a), Bsz, S, D, device, st);
    MAMBA_BWD_CASE(4)
    MAMBA_BWD_CASE(8)
    MAMBA_BWD_CASE(16)
#undef MAMBA_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
