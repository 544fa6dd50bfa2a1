// The Mamba selective scan for Hopper (sm_90a):
//
//   h_t = exp(dt_t * A) h_{t-1} + (dt_t * u_t) B_t,   y_t = C_t . h_t
//
// with u, dt [B, S, D]; A [D, N]; B_in, C_in [B, S, N]; h0 (or zeros) and
// h_end [B, D, N].  Replaces repro/kernels/mamba_scan.py::_mamba_kernel (the
// Pallas TPU kernel): the same function, in float32 inside, y written in u's
// type (float32 or bfloat16) and h_end in float32.  There is no D-skip here:
// the model adds it.
//
// What bounds it on this card: at jamba-1.5-large's serving shape (B 8,
// S 2048, D 16,384, N 16, float32 u and dt) the call reads u and dt and
// writes y, 3.2 GB (0.97 ms at 3.35 TB/s); it also takes 4.29 G exponentials
// (one per (b, t, d, n)), which the special-function units complete at 16 per
// SM per clock (1.03 ms on 132 SMs at 1.98 GHz), and some 30 GFLOP of
// float32 multiplies and adds (0.45 ms at 67 TFLOP/s).  The exponentials
// and the bytes bound it about equally.  What the design does: the TPU
// kernel ran lanes across channels with the state of a 512-channel block in
// VMEM and a sequential chunk axis.  Here one thread owns one (b, d) channel
// and keeps its N states in registers for the whole sequence, so the
// recurrence needs no communication at all.  A block is 128 consecutive
// channels of one batch row (grid (D / 128, B): 1,024 blocks at the serving
// shape); its threads read u and dt and write y coalesced along d.  B_t and
// C_t are the same for every channel of a row, so the block stages them for
// 64 time steps at a time in shared memory (8 KB) and every thread reads
// them there as broadcasts.  u and dt are loaded eight steps ahead into
// registers, so the loads of the next group overlap the arithmetic of the
// current one.  exp(dt A) is computed as ex2.approx(dt * (A log2 e)) with
// A log2 e formed once per channel: one multiply and one special-function
// instruction per state, about 1e-6 relative from the exact exp.
//
// Training adds one output: the instance kChk = true (float32 u only) also
// writes the state entering every tile of kTile = 64 steps, [B, ceil(S /
// 64), D, N] float32, which mamba_scan_bwd.cu recomputes each tile's
// states from.  The serving instances, kChk = false, have none of that
// code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kTile = 64;       // time steps of B_t, C_t staged at a time
constexpr int kGroup = 8;       // time steps of u, dt held in registers

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as Tensor.to
}

template <int N, typename T, bool kChk>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bin,
                  const float* __restrict__ Cin, const float* __restrict__ h0,
                  T* __restrict__ y, float* __restrict__ h_end, int S, int D,
                  float* __restrict__ chk) {
  __shared__ float sB[kTile * N];
  __shared__ float sC[kTile * N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;
  const int dc = active ? d : 0;   // idle threads read a valid channel

  constexpr float kLog2e = 1.4426950408889634f;
  float a2[N], h[N];
  const size_t hrow = (static_cast<size_t>(b) * D + dc) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = A[static_cast<size_t>(dc) * N + n] * kLog2e;
    h[n] = h0 != nullptr ? h0[hrow + n] : 0.0f;
  }

  const size_t row = static_cast<size_t>(D);
  const T* ub = u + static_cast<size_t>(b) * S * row + dc;
  const float* db = dt + static_cast<size_t>(b) * S * row + dc;
  T* yb = y + static_cast<size_t>(b) * S * row + dc;
  const float* Bb = Bin + static_cast<size_t>(b) * S * N;
  const float* Cb = Cin + static_cast<size_t>(b) * S * N;

  // u, dt of the group in flight, loaded one group ahead
  float un[kGroup], dn[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    un[i] = i < S ? load_f(ub + i * row) : 0.0f;
    dn[i] = i < S ? load_f(db + i * row) : 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    if constexpr (kChk) {   // the state entering this tile
      if (active) {
        float* c = chk + ((static_cast<size_t>(b) * ((S + kTile - 1) / kTile)
                           + t0 / kTile) * D + d) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) c[n] = h[n];
      }
    }
    __syncthreads();   // the previous tile's readers are done
    for (int i = threadIdx.x; i < nt * N; i += kThreads) {
      sB[i] = Bb[static_cast<size_t>(t0) * N + i];
      sC[i] = Cb[static_cast<size_t>(t0) * N + i];
    }
    __syncthreads();

    for (int g = 0; g < nt; g += kGroup) {
      float uc[kGroup], dcur[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        uc[i] = un[i];
        dcur[i] = dn[i];
      }
      const int tn = t0 + g + kGroup;   // first step of the next group
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const bool ok = tn + i < S;
        un[i] = ok ? load_f(ub + static_cast<size_t>(tn + i) * row) : 0.0f;
        dn[i] = ok ? load_f(db + static_cast<size_t>(tn + i) * row) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int t = g + i;
        if (t < nt) {
          const float dti = dcur[i];
          const float du = dti * uc[i];
          const float* bt = sB + t * N;
          const float* ct = sC + t * N;
          float acc = 0.0f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = ex2(dti * a2[n]) * h[n] + du * bt[n];
            acc = fmaf(h[n], ct[n], acc);
          }
          if (active) store_f(yb + static_cast<size_t>(t0 + t) * row, acc);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_end[hrow + n] = h[n];
  }
}

template <int N, typename T>
int launch(const void* u, const float* dt, const float* A, const float* B,
           const float* C, const float* h0, void* y, float* h_end, float* chk,
           int Bsz, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, Bsz);
  if (chk != nullptr) {   // training: float32 u only
    if constexpr (!std::is_same<T, float>::value)
      return static_cast<int>(cudaErrorInvalidValue);
    mamba_scan_kernel<N, float, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(u), dt, A, B, C, h0,
        static_cast<float*>(y), h_end, S, D, chk);
  } else {
    mamba_scan_kernel<N, T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(u), dt, A, B, C, h0, static_cast<T*>(y), h_end,
        S, D, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* u, const float* dt, const float* A, const float* B,
               const float* C, const float* h0, void* y, float* h_end,
               float* chk, int Bsz, int S, int D, int N, cudaStream_t st) {
  switch (N) {
    case 4: return launch<4, T>(u, dt, A, B, C, h0, y, h_end, chk, Bsz, S, D, st);
    case 8: return launch<8, T>(u, dt, A, B, C, h0, y, h_end, chk, Bsz, S, D, st);
    case 16: return launch<16, T>(u, dt, A, B, C, h0, y, h_end, chk, Bsz, S, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  u, y: [B, S, D] in float32
// (u_bf16 = 0) or bfloat16 (u_bf16 = 1); dt: [B, S, D], A: [D, N],
// B_in, C_in: [B, S, N], h0 (may be null: zeros) and h_end: [B, D, N], all
// float32; chk (may be null: the serving instance) [B, ceil(S / 64), D, N]
// float32; every pointer contiguous on ``device``.  Launches on ``stream``,
// does not synchronise and allocates nothing.  Returns the CUDA error of the
// launch (0 on success).  The caller checks the shapes and N in {4, 8, 16}.
extern "C" int mamba_scan_launch(const void* u, const void* dt, const void* A,
                                 const void* B_in, const void* C_in,
                                 const void* h0, void* y, void* h_end,
                                 void* chk, int Bsz, int S, int D, int N,
                                 int u_bf16,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Bsz <= 0 || Bsz > 65535 || S <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(B_in);
  const auto* Cf = static_cast<const float*>(C_in);
  const auto* hf = static_cast<const float*>(h0);
  auto* ef = static_cast<float*>(h_end);
  auto* cf = static_cast<float*>(chk);
  if (u_bf16)
    return dispatch_n<__nv_bfloat16>(u, dtf, Af, Bf, Cf, hf, y, ef, cf, Bsz,
                                     S, D, N, st);
  return dispatch_n<float>(u, dtf, Af, Bf, Cf, hf, y, ef, cf, Bsz, S, D, N,
                           st);
}
