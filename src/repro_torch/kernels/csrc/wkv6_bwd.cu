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
// instance writes them ([B, H, S/16, hd, hd] float32, 168 MB at B 1,
// S 4096, H 40, hd 64), and this kernel reads them.  du is summed per
// (b, h) over the chunks in reverse order, then over b in a second launch
// of fixed order (no atomics: the gradient repeats bit for bit).
//
// What bounds it on this card: at rwkv6-3b's training microbatch (B 1,
// S 4096, H 40, hd 64) the call reads r, k, v, w, dy and the states and
// writes dr, dk, dv, dw: 545 MB of float32 (0.163 ms at 3.35 TB/s), against
// 7.05 GFLOP of products (0.105 ms at the 67 TFLOP/s float32 peak outside
// the tensor cores): bytes bound the function.  This kernel is bound
// instead by one block's chain of 256 chunks: 40 blocks hold 40 of the 132
// SMs.  What the design does: one block of 256 threads owns one
// (batch, head), as the forward does, and walks its chunks in reverse.
// The next chunk's r, k, v, w, dy and state come into a second buffer of
// shared memory by cp.async while this one's run.  Every product is a
// float32 FMA loop on the SIMT cores from shared memory (full float32, no
// TF32): the K = hd products as row-by-row dots on float4 loads, the
// K = 16 products four output columns a thread.  The decay prefix and the
// reverse cumsum of d lw are taken as the forward takes its prefix: thread
// (dim d, tokens 4q .. 4q + 3) sums its tokens, then scans the 4 lanes of
// the dim with two shuffles.  Masked scores (s >= t) are never formed:
// their exponents can overflow.  Six block barriers a chunk.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixed_sum.cuh"

namespace {

constexpr int kC = 16;                 // tokens per chunk
constexpr int kThreads = 256;
constexpr float kLogWMin = -9.0f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// sum_k a[k] b[k] over K floats, both 16-byte aligned
template <int K>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; k += 4) acc = dot4(ld4(a + k), ld4(b + k), acc);
  return acc;
}

// acc[0..3] += sum_k A[k * sa] * B[k * ldb + 0..3] over K terms
template <int K>
__device__ __forceinline__ void col_rows(float4& acc, const float* A, int sa,
                                         const float* B, int ldb) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = A[k * sa];
    const float4 y = ld4(B + k * ldb);
    acc.x = fmaf(x, y.x, acc.x);
    acc.y = fmaf(x, y.y, acc.y);
    acc.z = fmaf(x, y.z, acc.z);
    acc.w = fmaf(x, y.w, acc.w);
  }
}

template <int HD>
struct Smem {
  static constexpr int P = HD + 4;             // row stride (floats)
  alignas(16) float in[2][5][kC][P];           // r, k, v, w, dy of a chunk
  alignas(16) float S[2][HD][P];               // the state entering it
  alignas(16) float dS[HD][P];                 // the carried gradient
  alignas(16) float op[8][kC][P];              // a, b, rq, kd, ea, eb, eq, ek
  alignas(16) float gr[4][kC][P];              // da, drq, db, dkd, then
                                               // da a, drq rq, db b, dkd kd
  alignas(16) float sc[kC][kC + 4];            // the masked scores
  alignas(16) float dsc[kC][kC + 4];           // their gradient, masked
  float diag[kC], ddiag[kC];
  float decay[HD], ddecay[HD];
};

enum { R = 0, K_ = 1, V = 2, W = 3, DY = 4 };
enum { A = 0, B = 1, RQ = 2, KD = 3, EA = 4, EB = 5, EQ = 6, EK = 7 };
enum { DA = 0, DRQ = 1, DB = 2, DKD = 3 };

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ states,
                const float* __restrict__ dy,
                const float* __restrict__ ds_end, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, int S, int H) {
  static_assert(HD == 16 || HD == 32 || HD == 64, "hd in {16, 32, 64}");
  constexpr int P = Smem<HD>::P;
  constexpr int Q = HD / 4;                    // float4 columns of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int n_chunks = S / kC;
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
  float du_acc = 0.f;                          // lanes tq == 0

  // the carried gradient of the state leaving the chunk
  for (int e = tid; e < HD * Q; e += kThreads) {
    const int i = e / Q, j = 4 * (e % Q);
    const float4 x = ds_end ? ld4(ds_end + bh * HD * HD + i * HD + j)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&sm.dS[i][j]) = x;
  }

  auto fetch = [&](int ci) {
    const int buf = ci & 1;
    const float* src[5] = {r, k, v, w, dy};
    for (int e = tid; e < 5 * kC * Q; e += kThreads) {
      const int a = e / (kC * Q), t = (e / Q) % kC, j = 4 * (e % Q);
      cp_async16(&sm.in[buf][a][t][j],
                 src[a] + base + static_cast<size_t>(ci * kC + t) * row + j);
    }
    const float* st = st_bh + static_cast<size_t>(ci) * HD * HD;
    for (int e = tid; e < HD * Q; e += kThreads) {
      const int i = e / Q, j = 4 * (e % Q);
      cp_async16(&sm.S[buf][i][j], st + i * HD + j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch(n_chunks - 1);

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int buf = ci & 1;
    auto& in = sm.in[buf];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();   // this chunk is staged; the last one is done
    if (ci > 0) fetch(ci - 1);

    // 1: the decayed operands of dim d at this thread's 4 tokens
    if (has_d) {
      float lw[4], cm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lw[i] = fmaxf(logf(fmaxf(in[W][4 * tq + i][d], 1e-38f)), kLogWMin);
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        const float rv = in[R][t][d], kv = in[K_][t][d];
        const float ce = cm[i] - lw[i];
        const float ea = __expf(ce - ref), eb = __expf(ref - cm[i]);
        const float eq = __expf(ce), ek = __expf(last - cm[i]);
        sm.op[EA][t][d] = ea;
        sm.op[EB][t][d] = eb;
        sm.op[EQ][t][d] = eq;
        sm.op[EK][t][d] = ek;
        sm.op[A][t][d] = rv * ea;
        sm.op[B][t][d] = kv * eb;
        sm.op[RQ][t][d] = rv * eq;
        sm.op[KD][t][d] = kv * ek;
      }
      if (tq == 0) sm.decay[d] = __expf(last);
    }
    __syncthreads();

    // 2: the K = hd dots: scores and their gradient (s < t), the
    // diagonals, drq = dy S^T, dkd = v dS^T, ddecay
    for (int e = tid; e < 2 * kC * kC; e += kThreads) {
      const int which = e / (kC * kC), t = (e / kC) % kC, s = e % kC;
      float x = 0.f;
      if (s < t)
        x = which ? dot_rows<HD>(&in[DY][t][0], &in[V][s][0])
                  : dot_rows<HD>(&sm.op[A][t][0], &sm.op[B][s][0]);
      (which ? sm.dsc : sm.sc)[t][s] = x;
    }
    for (int e = tid; e < 2 * kC; e += kThreads) {
      const int t = e % kC;
      float x = 0.f;
      if (e < kC) {
#pragma unroll 8
        for (int j = 0; j < HD; ++j)
          x = fmaf(in[R][t][j] * u[h * HD + j], in[K_][t][j], x);
        sm.diag[t] = x;
      } else {
        sm.ddiag[t] = dot_rows<HD>(&in[DY][t][0], &in[V][t][0]);
      }
    }
    for (int e = tid; e < 2 * kC * HD; e += kThreads) {
      const int which = e / (kC * HD), t = (e / HD) % kC, i = e % HD;
      if (which)
        sm.gr[DKD][t][i] = dot_rows<HD>(&in[V][t][0], &sm.dS[i][0]);
      else
        sm.gr[DRQ][t][i] = dot_rows<HD>(&in[DY][t][0], &sm.S[buf][i][0]);
    }
    for (int i = tid; i < HD; i += kThreads)
      sm.ddecay[i] = dot_rows<HD>(&sm.dS[i][0], &sm.S[buf][i][0]);
    __syncthreads();

    // 3: the K = 16 products, four columns a thread: dv (with its K = hd
    // term kd dS), da, db, and the new dS kept in registers until every
    // read of the old one is done
    for (int e = tid; e < 3 * kC * Q; e += kThreads) {
      const int which = e / (kC * Q), t = (e / Q) % kC, j = 4 * (e % Q);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (which == 0) {          // dv[s = t]
        col_rows<kC>(acc, &sm.sc[0][t], kC + 4, &in[DY][0][j], P);
        const float dg = sm.diag[t];
        const float4 g = ld4(&in[DY][t][j]);
        acc.x = fmaf(dg, g.x, acc.x);
        acc.y = fmaf(dg, g.y, acc.y);
        acc.z = fmaf(dg, g.z, acc.z);
        acc.w = fmaf(dg, g.w, acc.w);
        col_rows<HD>(acc, &sm.op[KD][t][0], 1, &sm.dS[0][j], P);
        *reinterpret_cast<float4*>(
            dv + base + static_cast<size_t>(ci * kC + t) * row + j) = acc;
      } else if (which == 1) {   // da[t] = dsc[t] b
        col_rows<kC>(acc, &sm.dsc[t][0], 1, &sm.op[B][0][j], P);
        *reinterpret_cast<float4*>(&sm.gr[DA][t][j]) = acc;
      } else {                   // db[s = t] = dsc[:, s]^T a
        col_rows<kC>(acc, &sm.dsc[0][t], kC + 4, &sm.op[A][0][j], P);
        *reinterpret_cast<float4*>(&sm.gr[DB][t][j]) = acc;
      }
    }
    constexpr int NS = (HD * Q + kThreads - 1) / kThreads;
    float4 ds_new[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int e = tid + m * kThreads;
      if (e < HD * Q) {
        const int i = e / Q, j = 4 * (e % Q);
        const float dc = sm.decay[i];
        const float4 o = ld4(&sm.dS[i][j]);
        float4 acc = make_float4(dc * o.x, dc * o.y, dc * o.z, dc * o.w);
        col_rows<kC>(acc, &sm.op[RQ][0][i], P, &in[DY][0][j], P);
        ds_new[m] = acc;
      }
    }
    __syncthreads();   // the old dS is read
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int e = tid + m * kThreads;
      if (e < HD * Q) {
        const int i = e / Q, j = 4 * (e % Q);
        *reinterpret_cast<float4*>(&sm.dS[i][j]) = ds_new[m];
      }
    }

    // 4: dr and dk, and the four products that d lw is made of
    for (int e = tid; e < kC * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      const float dda = sm.gr[DA][t][i], ddrq = sm.gr[DRQ][t][i];
      const float ddb = sm.gr[DB][t][i], ddkd = sm.gr[DKD][t][i];
      const float dgu = sm.ddiag[t] * u[h * HD + i];
      const size_t o = base + static_cast<size_t>(ci * kC + t) * row + i;
      dr[o] = dda * sm.op[EA][t][i] + ddrq * sm.op[EQ][t][i] +
              dgu * in[K_][t][i];
      dk[o] = ddb * sm.op[EB][t][i] + ddkd * sm.op[EK][t][i] +
              dgu * in[R][t][i];
      sm.gr[DA][t][i] = dda * sm.op[A][t][i];
      sm.gr[DRQ][t][i] = ddrq * sm.op[RQ][t][i];
      sm.gr[DB][t][i] = ddb * sm.op[B][t][i];
      sm.gr[DKD][t][i] = ddkd * sm.op[KD][t][i];
    }
    __syncthreads();

    // 5: d lw through the reverse cumsum, dw, and du's share (dim d)
    if (has_d) {
      float gce[4], gc[4], dref = 0.f, dlast = 0.f, dus = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * tq + i;
        const float x1 = sm.gr[DA][t][d], x2 = sm.gr[DRQ][t][d];
        const float x3 = sm.gr[DB][t][d], x4 = sm.gr[DKD][t][d];
        gce[i] = x1 + x2;
        gc[i] = gce[i] - x3 - x4;
        dref += x3 - x1;
        dlast += x4;
        dus = fmaf(sm.ddiag[t], in[R][t][d] * in[K_][t][d], dus);
      }
#pragma unroll
      for (int m = 8; m < 32; m <<= 1) {
        dref += __shfl_xor_sync(0xffffffffu, dref, m);
        dlast += __shfl_xor_sync(0xffffffffu, dlast, m);
        dus += __shfl_xor_sync(0xffffffffu, dus, m);
      }
      if (tq == 2) gc[0] += dref;                        // t = 8, ref
      if (tq == 3) gc[3] += dlast + sm.ddecay[d] * sm.decay[d];   // last
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
        const float wv = fmaxf(in[W][t][d], 1e-38f);
        const float lwr = logf(wv);
        const float side = lwr > kLogWMin ? 1.f
                           : (lwr == kLogWMin ? 0.5f : 0.f);
        const float glw = sfx[i] + later - gce[i];
        dw[base + static_cast<size_t>(ci * kC + t) * row + d] =
            side > 0.f ? glw * side / wv : 0.f;
      }
      if (tq == 0) du_acc += dus;
    }
  }
  __syncthreads();   // the last dS is written

  for (int e = tid; e < HD * Q; e += kThreads) {
    const int i = e / Q, j = 4 * (e % Q);
    *reinterpret_cast<float4*>(ds0 + bh * HD * HD + i * HD + j) =
        ld4(&sm.dS[i][j]);
  }
  if (has_d && tq == 0) du_part[bh * HD + d] = du_acc;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* states, const float* dy,
           const float* ds_end, float* dr, float* dk, float* dv, float* dw,
           float* du_part, float* du, float* ds0, int B, int S, int H,
           int device, cudaStream_t stream) {
  static int attr_device = -1;
  if (attr_device != device) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem<HD>)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_device = device;
  }
  wkv6_bwd_kernel<HD><<<dim3(H, B), kThreads, sizeof(Smem<HD>), stream>>>(
      r, k, v, w, u, states, dy, ds_end, dr, dk, dv, dw, du_part, ds0, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return fixed_sum(du_part, du, B, static_cast<size_t>(H) * HD, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  r, k, v, w, dy and dr, dk, dv,
// dw: [B, S, H, hd]; u, du: [H, hd]; states: [B, H, S / 16, hd, hd] (the
// forward's training output); ds_end (may be null: zeros), ds0: [B, H, hd,
// hd]; du_part: [B, H, hd] scratch; all float32, contiguous, 16-byte aligned
// device pointers.  Launches the reverse walk, then du's sum over b, on
// ``stream`` of ``device``; does not synchronise and allocates nothing.
// Returns the first CUDA error of the launches (0 on success).  The caller
// checks the shapes, S % 16 == 0 and hd in {16, 32, 64}.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* states, const void* dy,
                               const void* ds_end, void* dr, void* dk,
                               void* dv, void* dw, void* du_part, void* du,
                               void* ds0, int B, int S, int H, int hd,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0 || S % kC || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (hd) {
    case 16:
      return launch<16>(c(r), c(k), c(v), c(w), c(u), c(states), c(dy),
                        c(ds_end), m(dr), m(dk), m(dv), m(dw), m(du_part),
                        m(du), m(ds0), B, S, H, device, st);
    case 32:
      return launch<32>(c(r), c(k), c(v), c(w), c(u), c(states), c(dy),
                        c(ds_end), m(dr), m(dk), m(dv), m(dw), m(du_part),
                        m(du), m(ds0), B, S, H, device, st);
    case 64:
      return launch<64>(c(r), c(k), c(v), c(w), c(u), c(states), c(dy),
                        c(ds_end), m(dr), m(dk), m(dv), m(dw), m(du_part),
                        m(du), m(ds0), B, S, H, device, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
