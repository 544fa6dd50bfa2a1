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
// 67 TFLOP/s float32 peak): bytes bound it.  What the design does: the TPU
// kernel's sequential chunk axis (state carried in VMEM scratch) becomes a
// loop inside one block.  Column j of S and of y depends only on column j of
// v, so a block owns a 16-column slice of the value dimension: the grid is
// (hd / 16, H, B), 1,280 blocks at the serving shape where (B, H) alone would
// give 320 on 132 SMs.  Each block recomputes the chunk's decay prefixes and
// its 16 x 16 score matrix (cheap: 16 K FMAs).  256 threads: one per (t, s)
// score, one per (t, j) output, and hd / 16 entries of the block's [hd, 16]
// state slice each, kept in registers in float32 across all chunks and
// mirrored, transposed, into shared memory for the output phase.  A chunk
// takes three barriers: the decay prefix is a shuffle scan over the 16
// lanes that hold one dimension's tokens, so the decayed operands are made
// in registers straight from the loads; the products read their operands
// as float4 from rows padded to hd + 4 floats, since shared-memory loads
// bound them.  Registers are capped at 64 a thread so that four blocks fit
// on an SM (1,280 blocks then run in three waves, not four).  The next
// chunk's r, k, w, v are loaded into registers (one float4 each) while the
// current chunk is computed.  The inputs are read in place in their
// [B, S, H, hd] layout, with no transposes.  Masked scores (s >= t) are
// never computed: their exponents could overflow, and they are zero.  The
// shuffle scan adds the decay prefix in another order than a sequential
// cumsum, which moves the output by about 1e-6 relative.  Float32 FMAs, no
// tensor cores: a wgmma version is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                 // tokens per chunk
constexpr int kVB = 16;                // value columns per block
constexpr int kThreads = kC * kVB;     // 256
constexpr float kLogWMin = -9.0f;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows padded to HD + 4 floats: 16-byte aligned for float4 reads, and the
// rows that eight neighbouring threads read as float4 fall in distinct
// bank groups.
template <int HD>
struct Smem {
  static constexpr int P = HD + 4;
  alignas(16) float a[kC][P];           // r exp(cum_excl - ref)
  alignas(16) float b[kC][P];           // k exp(ref - cum)
  alignas(16) float rq[kC][P];          // r exp(cum_excl)
  alignas(16) float kd[kC][P];          // k exp(cum_last - cum)
  alignas(16) float sc[kC][kC + 4];     // strictly-lower scores
  alignas(16) float st[kVB][P];         // state slice, transposed: st[j][d]
  alignas(16) float v[kC][kVB];
  alignas(16) float decay[HD];          // exp(cum_last)
  float diag_part[HD / 4][kC];          // r u k summed over 4 dims
  float diag[kC];
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 4)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_end, int S, int H) {
  static_assert(kC * HD / 4 <= kThreads, "one float4 of r, k, w per thread");
  static_assert(HD % kVB == 0, "hd is a multiple of 16");
  constexpr int DP = HD / kVB;          // state rows a thread owns
  __shared__ Smem<HD> sm;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kVB;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const size_t row = static_cast<size_t>(H) * HD;     // one token's stride
  const size_t base = static_cast<size_t>(bb) * S * row +
                      static_cast<size_t>(h) * HD;    // token 0 of (b, h)
  const size_t sbase = (static_cast<size_t>(bb) * H + h) * HD * HD;

  // this thread's state entries: column sj, rows sd .. sd + DP - 1, kept in
  // registers across chunks and mirrored into st for the output phase
  const int sj = tid % kVB, sd = (tid / kVB) * DP;
  float sreg[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    sreg[i] = s0 ? s0[sbase + static_cast<size_t>(sd + i) * HD + j0 + sj]
                 : 0.f;
    sm.st[sj][sd + i] = sreg[i];
  }

  // this thread's float4 of r, k, w: token lt = its lane mod 16, dims ld ..
  // ld + 3, so that a dimension's 16 tokens sit in 16 neighbouring lanes
  // (the prefix is a shuffle scan) and lanes t and t + 16 read the two
  // halves of one 32-byte sector
  const bool has_rkw = tid < kC * HD / 4;   // whole warps: HD >= 16
  const int lt = tid % kC, ld = 4 * (tid / kC);
  const bool has_v = tid < kC * kVB / 4;
  const int vt = tid / (kVB / 4), vj = 4 * (tid % (kVB / 4));
  float4 pr, pk, pw, pv, uu;
  if (has_rkw) uu = *reinterpret_cast<const float4*>(u + h * HD + ld);
  auto fetch = [&](int t0) {
    if (has_rkw) {
      const size_t o = base + static_cast<size_t>(t0 + lt) * row + ld;
      pr = *reinterpret_cast<const float4*>(r + o);
      pk = *reinterpret_cast<const float4*>(k + o);
      pw = *reinterpret_cast<const float4*>(w + o);
    }
    if (has_v) {
      const size_t o = base + static_cast<size_t>(t0 + vt) * row + j0 + vj;
      pv = *reinterpret_cast<const float4*>(v + o);
    }
  };
  fetch(0);

  const int n_chunks = S / kC;
  const int t = tid / kVB, c = tid % kVB;   // (t, s) score or (t, j) output
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kC;
    // A: the decayed operands of this thread's (token, 4 dims), from the
    // prefetched registers; then start loading the next chunk
    if (has_rkw) {
      const float rv[4] = {pr.x, pr.y, pr.z, pr.w};
      const float kv[4] = {pk.x, pk.y, pk.z, pk.w};
      const float wv[4] = {pw.x, pw.y, pw.z, pw.w};
      const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
      float a4[4], b4[4], rq4[4], kd4[4], dec4[4], dpart = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float lw = fmaxf(logf(fmaxf(wv[q], 1e-38f)), kLogWMin);
        float cm = lw;                    // inclusive prefix over tokens
#pragma unroll
        for (int off = 1; off < kC; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, cm, off, kC);
          if (lt >= off) cm += o;
        }
        const float ref = __shfl_sync(0xffffffffu, cm, kC / 2, kC);
        const float last = __shfl_sync(0xffffffffu, cm, kC - 1, kC);
        const float ce = cm - lw;
        a4[q] = rv[q] * expf(ce - ref);
        b4[q] = kv[q] * expf(ref - cm);
        rq4[q] = rv[q] * expf(ce);
        kd4[q] = kv[q] * expf(last - cm);
        dec4[q] = expf(last);
        dpart = fmaf(rv[q] * uv[q], kv[q], dpart);
      }
      *reinterpret_cast<float4*>(&sm.a[lt][ld]) =
          make_float4(a4[0], a4[1], a4[2], a4[3]);
      *reinterpret_cast<float4*>(&sm.b[lt][ld]) =
          make_float4(b4[0], b4[1], b4[2], b4[3]);
      *reinterpret_cast<float4*>(&sm.rq[lt][ld]) =
          make_float4(rq4[0], rq4[1], rq4[2], rq4[3]);
      *reinterpret_cast<float4*>(&sm.kd[lt][ld]) =
          make_float4(kd4[0], kd4[1], kd4[2], kd4[3]);
      if (lt == 0)
        *reinterpret_cast<float4*>(&sm.decay[ld]) =
            make_float4(dec4[0], dec4[1], dec4[2], dec4[3]);
      sm.diag_part[ld / 4][lt] = dpart;
    }
    if (has_v) *reinterpret_cast<float4*>(&sm.v[vt][vj]) = pv;
    if (ci + 1 < n_chunks) fetch(t0 + kC);
    __syncthreads();

    // B: strictly-lower scores (thread (t, s)), the u diagonal (s == t),
    // and the new state in registers (written to st after the outputs)
    {
      float acc = 0.f;
      if (c < t) {
#pragma unroll
        for (int d = 0; d < HD; d += 4)
          acc = dot4(*reinterpret_cast<const float4*>(&sm.a[t][d]),
                     *reinterpret_cast<const float4*>(&sm.b[c][d]), acc);
      } else if (c == t) {
#pragma unroll
        for (int g = 0; g < HD / 4; ++g) acc += sm.diag_part[g][t];
        sm.diag[t] = acc;
        acc = 0.f;
      }
      sm.sc[t][c] = acc;
    }
    {
      float snew[DP];
#pragma unroll
      for (int i = 0; i < DP; ++i) snew[i] = 0.f;
#pragma unroll
      for (int s = 0; s < kC; ++s) {
        const float vs = sm.v[s][sj];
        if constexpr (DP == 4) {
          const float4 kq = *reinterpret_cast<const float4*>(&sm.kd[s][sd]);
          snew[0] = fmaf(kq.x, vs, snew[0]);
          snew[1] = fmaf(kq.y, vs, snew[1]);
          snew[2] = fmaf(kq.z, vs, snew[2]);
          snew[3] = fmaf(kq.w, vs, snew[3]);
        } else {
#pragma unroll
          for (int i = 0; i < DP; ++i)
            snew[i] = fmaf(sm.kd[s][sd + i], vs, snew[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < DP; ++i)
        sreg[i] = fmaf(sm.decay[sd + i], sreg[i], snew[i]);
    }
    __syncthreads();

    // C: output (thread (t, j)): intra-chunk, diagonal, carried state
    {
      float intra = 0.f;
#pragma unroll
      for (int s = 0; s < kC; ++s) intra = fmaf(sm.sc[t][s], sm.v[s][c], intra);
      intra = fmaf(sm.diag[t], sm.v[t][c], intra);
      float cross = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4)
        cross = dot4(*reinterpret_cast<const float4*>(&sm.rq[t][d]),
                     *reinterpret_cast<const float4*>(&sm.st[c][d]), cross);
      y[base + static_cast<size_t>(t0 + t) * row + j0 + c] = intra + cross;
    }
    __syncthreads();

    // D: publish the new state for the next chunk's outputs (read after
    // that chunk's barriers A and B)
    if constexpr (DP == 4) {
      *reinterpret_cast<float4*>(&sm.st[sj][sd]) =
          make_float4(sreg[0], sreg[1], sreg[2], sreg[3]);
    } else {
#pragma unroll
      for (int i = 0; i < DP; ++i) sm.st[sj][sd + i] = sreg[i];
    }
  }

#pragma unroll
  for (int i = 0; i < DP; ++i)
    s_end[sbase + static_cast<size_t>(sd + i) * HD + j0 + sj] = sreg[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_end, int B,
           int S, int H, cudaStream_t stream) {
  const dim3 grid(HD / kVB, H, B);
  wkv6_kernel<HD><<<grid, kThreads, 0, stream>>>(r, k, v, w, u, s0, y, s_end,
                                                 S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  r, k, v, w, y: [B, S, H, hd];
// u: [H, hd]; s0 (may be null: zeros), s_end: [B, H, hd, hd]; all float32,
// contiguous, 16-byte aligned device pointers.  Launches on ``stream`` of
// ``device``, does not synchronise and allocates nothing.  Returns the CUDA
// error of the launch (0 on success).  The caller checks the shapes,
// S % 16 == 0 and hd in {16, 32, 64}.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* s_end, int B, int S, int H, int hd,
                           int device, void* stream) {
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
  switch (hd) {
    case 16: return launch<16>(rf, kf, vf, wf, uf, sf, yf, ef, B, S, H, st);
    case 32: return launch<32>(rf, kf, vf, wf, uf, sf, yf, ef, B, S, H, st);
    case 64: return launch<64>(rf, kf, vf, wf, uf, sf, yf, ef, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
