// Multi-head latent attention (MLA) decode for Hopper (sm_90a): one query
// token per (batch, head) against the absorbed latent cache, minicpm3-4b's
// instance (40 heads, latent width 256, shared rope width 32).
//
// Replaces no Pallas kernel: repro/modeling/attention.py::_mla_apply
// computes MLA decode in jnp, in absorbed form (:457-475), and this kernel
// is its attention core (:464-473), written beside
// decode_attention.cu (the port of repro/kernels/decode_attention.py),
// which cannot take it: 40 query rows over one latent "kv head", a q.k
// width of 288 and a value width of 256.  With q_lat = q_nope . wk_b
// [B, H, C] and q_rope [B, H, R] it computes, per (batch b, head h),
//   s_l = (q_lat[h] . ckv[l] + q_rope[h] . krope[l]) * scale   (float32),
// keeps slots l <= pos (a masked slot's score, the finite NEG_INF = -2e38,
// weighs exp(NEG_INF - m) = 0, so the kernel walks only [0, pos]), takes
// the softmax and returns o[h] = sum_l p_l ckv[l] / sum_l p_l in q's type.
// The values are the same ckv rows as the keys' first C columns, so one
// staged tile serves both products.
//
// What bounds it on this card: the latent cache.  A decode step reads
// every kept latent byte once (576 bytes a slot in bf16) and does
// 2 (288 + 256) flops a slot and head, about 75 flops a byte at 40 heads,
// below the 295 at which the tensor cores and not the memory bound bf16:
// at batch 8 and pos 2080 a layer reads 9.59 MB, 2.86 us at 3.35 TB/s.
// What the design does about it:
//   * The grid is (parts, batch): a block of 4 warps owns one part, a run
//     of per_part slots, of one batch row's cache, for all 40 heads, so
//     every latent byte is read once.  The wrapper picks per_part and the
//     number of parts so that the grid is one wave of resident blocks
//     (mla_decode_config reports the block's shared memory and its
//     resident blocks an SM).
//   * The block stages its slots in tiles (bf16 64 slots, float32 32)
//     through a ring of NS stages of shared memory, filled by cp.async (16
//     bytes a thread, zero-filled past the run), each staged row [ckv |
//     krope | 16 bytes of padding, so that ldmatrix and float4 reads of
//     eight rows fall in distinct banks].  q_lat | q_rope is staged once,
//     the same way.
//   * Each tile takes three steps, separated by __syncthreads:
//     1. scores into a float32 [40 heads][slots] buffer.  bf16: tensor
//        cores, mma.sync.m16n8k16, S^T = K . Q^T with M = 16 slots (warp w
//        takes slots 16 w ..), N = 8 heads (five n8 tiles cover the 40
//        heads with no padding), K = 16 of the 288 dims (18 steps), K by
//        ldmatrix from the ring and Q^T by ldmatrix from the staged q.
//        float32: SIMT FMAs, lane l scores slot l for the warp's 10 heads.
//     2. the online-softmax update: warp w owns heads 10 w .. 10 w + 9 and
//        keeps their running max m and sum l; it writes P (bf16 rounded,
//        or float32 over the scores) and each head's correction
//        exp(m_old - m_new) to shared memory.
//     3. O^T = O^T * corr + V^T . P^T.  bf16: mma.sync with M = 16 value
//        dims, N = 8 heads, K = 16 slots; warp w owns value dims 64 w ..
//        64 w + 63, 4 m16 x 5 n8 tiles, 80 float accumulators a lane (one
//        warp holding all 256 dims would need 320); V^T by ldmatrix.trans
//        from the same staged ckv rows, P^T by ldmatrix.  float32: a
//        thread owns 4 dims of 20 heads.
//   * The parts of one batch row merge in a second, small launch (grid 40
//     heads x batch, 64 threads of 4 dims each), in the order p = 0 ..
//     n - 1 with the Pallas rule out = sum_p acc_p exp(m_p - M) /
//     max(sum_p l_p exp(m_p - M), 1e-30), M = max_p m_p: a part's partial
//     output is 40 x 256 floats, so one block merging every part, as
//     decode_attention.cu's last block does for its G <= 8 rows, would read
//     n x 40 KB alone.  With one part the main launch writes the output.
//     No atomics: every call gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kH = 40;          // query heads
constexpr int kC = 256;         // latent width: the values' width
constexpr int kR = 32;          // shared rope width
constexpr int kD = kC + kR;     // a score's dot product
constexpr int kW = 4;           // warps a block
constexpr int kThreads = kW * 32;
constexpr int kHW = kH / kW;    // heads whose softmax a warp keeps
constexpr int kMergeThreads = kC / 4;

template <typename T>
struct Cfg {
  static constexpr int TS = sizeof(T) == 2 ? 64 : 32;   // slots a tile
  static constexpr int NS = sizeof(T) == 2 ? 3 : 2;     // stages of the ring
  static constexpr int ROW = kD + 16 / static_cast<int>(sizeof(T));
  static constexpr int STAGE = TS * ROW;                // elements
  static constexpr int SROW = TS + 4;                   // float scores a head
  static constexpr int PROW = TS + 8;                   // bf16 P a head
  static constexpr int RING_BYTES = NS * STAGE * static_cast<int>(sizeof(T));
  static constexpr int Q_BYTES = kH * ROW * static_cast<int>(sizeof(T));
  static constexpr int S_BYTES = kH * SROW * 4;
  static constexpr int P_BYTES = sizeof(T) == 2 ? kH * PROW * 2 : 0;
  // then corr, m and l of each head
  static constexpr int SMEM = RING_BYTES + Q_BYTES + S_BYTES + P_BYTES +
                              3 * kH * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[0 .. 3] += a . b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B operands of two k16 steps of one n8 tile, from a [n][k] bf16 array
// (row stride ``ld`` elements) whose rows are the n8 tile's 8 rows: r[0],
// r[1] for columns k0 .. k0 + 15, r[2], r[3] for k0 + 16 .. k0 + 31.
__device__ __forceinline__ void ldmatrix_b2(uint32_t (&r)[4],
                                            const __nv_bfloat16* rows, int ld,
                                            int k0, int lane) {
  ldmatrix_x4(r, rows + (lane & 7) * ld + k0 + (lane >> 3) * 8);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q_lat;   // [B, kH, kC]
  const void* q_rope;  // [B, kH, kR]
  const void* ckv;     // [B, L, kC]
  const void* krope;   // [B, L, kR]
  void* out;           // [B, kH, kC]
  float* part;         // acc [B, n_parts, kH, kC], then (m, l) [B, n_parts, kH, 2]
  int L;
  float scale;
  int hi, per_part, n_parts;
};

// Rows [kD] = a[kA] | b[kD - kA] of ``n`` rows into dst (row stride ROW),
// 16 bytes a thread; rows at and past ``valid`` are zero-filled (source
// row 0 is read in their place, for a valid address).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* a, const T* b,
                                           int a_w, int n, int valid,
                                           int tid) {
  using C = Cfg<T>;
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int CPR = kD / EPC;                           // chunks a row
  for (int c = tid; c < n * CPR; c += kThreads) {
    const int r = c / CPR, e = (c % CPR) * EPC;
    const bool in = r < valid;
    const size_t src_r = in ? r : 0;
    const T* src = e < a_w ? a + src_r * a_w + e
                           : b + src_r * (kD - a_w) + (e - a_w);
    cp_async16(dst + r * C::ROW + e, src, in ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const Args a) {
  using C = Cfg<T>;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + C::RING_BYTES);
  float* ss = reinterpret_cast<float*>(smem + C::RING_BYTES + C::Q_BYTES);
  bf* ps = reinterpret_cast<bf*>(smem + C::RING_BYTES + C::Q_BYTES +
                                 C::S_BYTES);
  float* s_corr = reinterpret_cast<float*>(smem + C::RING_BYTES + C::Q_BYTES +
                                           C::S_BYTES + C::P_BYTES);
  float* s_m = s_corr + kH;
  float* s_l = s_m + kH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int part = blockIdx.x, b = blockIdx.y;
  const int j0 = part * a.per_part;
  const int j1 = min(a.hi, j0 + a.per_part);
  const int n_tiles = (j1 - j0 + C::TS - 1) / C::TS;   // >= 1 by the plan
  const T* ckv = static_cast<const T*>(a.ckv) + static_cast<size_t>(b) * a.L * kC;
  const T* krope = static_cast<const T*>(a.krope) + static_cast<size_t>(b) * a.L * kR;

  // q_lat | q_rope of the 40 heads, in the first tile's group
  stage_rows<T>(qs, static_cast<const T*>(a.q_lat) + static_cast<size_t>(b) * kH * kC,
                static_cast<const T*>(a.q_rope) + static_cast<size_t>(b) * kH * kR,
                kC, kH, kH, tid);
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = j0 + s * C::TS;
      stage_rows<T>(ring + s * C::STAGE, ckv + static_cast<size_t>(t0) * kC,
                    krope + static_cast<size_t>(t0) * kR, kC, C::TS, j1 - t0,
                    tid);
    }
    cp_async_commit();
  }

  // the softmax state of heads 10 warp + i
  float m[kHW], l[kHW];
#pragma unroll
  for (int i = 0; i < kHW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // O^T: bf16 acc[md][n][e] is value dim 64 warp + 16 md + g + 8 (e >> 1) of
  // head 8 n + 2 t + (e & 1); float32 acc[i][e] is dim 4 (tid % 64) + e of
  // head 20 (tid / 64) + i
  constexpr int NACC = 80;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + C::NS - 1;
    if (nxt < n_tiles) {
      const int t0 = j0 + nxt * C::TS;
      stage_rows<T>(ring + (nxt % C::NS) * C::STAGE,
                    ckv + static_cast<size_t>(t0) * kC,
                    krope + static_cast<size_t>(t0) * kR, kC, C::TS, j1 - t0,
                    tid);
    }
    cp_async_commit();
    cp_async_wait<C::NS - 1>();
    __syncthreads();
    const T* st = ring + (it % C::NS) * C::STAGE;
    const int valid = j1 - (j0 + it * C::TS);      // slots of the tile in the run

    // ---- 1. scores ss[h][slot], scaled; -inf past the run
    if constexpr (sizeof(T) == 2) {
      float sc[5][4];
#pragma unroll
      for (int n = 0; n < 5; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      const bf* krow = st + (warp * 16 + (lane & 15)) * C::ROW + (lane >> 4) * 8;
#pragma unroll 3
      for (int kb = 0; kb < kD / 16; kb += 2) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, krow + kb * 16);
        ldmatrix_x4(a1, krow + kb * 16 + 16);
#pragma unroll
        for (int n = 0; n < 5; ++n) {
          uint32_t qf[4];
          ldmatrix_b2(qf, qs + n * 8 * C::ROW, C::ROW, kb * 16, lane);
          mma_bf16(sc[n], a0, qf[0], qf[1]);
          mma_bf16(sc[n], a1, qf[2], qf[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = warp * 16 + g + 8 * (e >> 1);
        const bool in = slot < valid;
#pragma unroll
        for (int n = 0; n < 5; ++n)
          ss[(8 * n + 2 * t + (e & 1)) * C::SROW + slot] =
              in ? sc[n][e] * a.scale : -INFINITY;
      }
    } else {
      float s[kHW];
#pragma unroll
      for (int i = 0; i < kHW; ++i) s[i] = 0.f;
      const float* kr = st + lane * C::ROW;
      const float* qw = qs + warp * kHW * C::ROW;
#pragma unroll 2
      for (int d = 0; d < kD; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < kHW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * C::ROW + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
      const bool in = lane < valid;
#pragma unroll
      for (int i = 0; i < kHW; ++i)
        ss[(warp * kHW + i) * C::SROW + lane] = in ? s[i] * a.scale : -INFINITY;
    }
    __syncthreads();

    // ---- 2. online softmax of heads 10 warp + i: P and the corrections
#pragma unroll
    for (int i = 0; i < kHW; ++i) {
      const int h = warp * kHW + i;
      float x[C::TS / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < C::TS / 32; ++k) {
        x[k] = ss[h * C::SROW + lane + 32 * k];
        mx = fmaxf(mx, x[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < C::TS / 32; ++k) {
        const float p = expf(x[k] - m_new);
        sum += p;
        if constexpr (sizeof(T) == 2)
          ps[h * C::PROW + lane + 32 * k] = __float2bfloat16_rn(p);
        else
          ss[h * C::SROW + lane + 32 * k] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = fmaf(l[i], corr, sum);
      if (lane == 0) s_corr[h] = corr;
    }
    __syncthreads();

    // ---- 3. O^T = O^T * corr + V^T . P^T
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int n = 0; n < 5; ++n) {
        const float c0 = s_corr[8 * n + 2 * t], c1 = s_corr[8 * n + 2 * t + 1];
#pragma unroll
        for (int md = 0; md < 4; ++md) {
          float* d = acc + (md * 5 + n) * 4;
          d[0] *= c0;
          d[1] *= c1;
          d[2] *= c0;
          d[3] *= c1;
        }
      }
#pragma unroll
      for (int ks = 0; ks < C::TS / 16; ks += 2) {
        uint32_t pf[5][4];
#pragma unroll
        for (int n = 0; n < 5; ++n)
          ldmatrix_b2(pf[n], ps + n * 8 * C::PROW, C::PROW, ks * 16, lane);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int md = 0; md < 4; ++md) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, st + ((ks + kk) * 16 + ((lane >> 4) << 3) +
                                        (lane & 7)) * C::ROW +
                                      warp * 64 + md * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int n = 0; n < 5; ++n)
              mma_bf16(acc + (md * 5 + n) * 4, vf, pf[n][2 * kk],
                       pf[n][2 * kk + 1]);
          }
        }
      }
    } else {
      const int d4 = 4 * (tid % 64), hb = 20 * (tid / 64);
#pragma unroll
      for (int i = 0; i < 20; ++i) {
        const float c = s_corr[hb + i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i * 4 + e] *= c;
      }
#pragma unroll 2
      for (int j = 0; j < C::TS; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(st + j * C::ROW + d4);
#pragma unroll
        for (int i = 0; i < 20; ++i) {
          const float p = ss[(hb + i) * C::SROW + j];
          acc[i * 4 + 0] = fmaf(p, v.x, acc[i * 4 + 0]);
          acc[i * 4 + 1] = fmaf(p, v.y, acc[i * 4 + 1]);
          acc[i * 4 + 2] = fmaf(p, v.z, acc[i * 4 + 2]);
          acc[i * 4 + 3] = fmaf(p, v.w, acc[i * 4 + 3]);
        }
      }
    }
    __syncthreads();   // the stage, the scores and P are rewritten after this
  }
  cp_async_wait<0>();

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kHW; ++i) {
      s_m[warp * kHW + i] = m[i];
      s_l[warp * kHW + i] = l[i];
    }
  }
  __syncthreads();

  // the output (one part) or this part's (acc, m, l)
  const bool alone = a.n_parts == 1;
  const size_t row0 = (static_cast<size_t>(b) * a.n_parts + part) * kH;
  float* pacc = a.part + row0 * kC;
  if (!alone && tid < kH) {
    float* pml = a.part + static_cast<size_t>(gridDim.y) * a.n_parts * kH * kC +
                 (row0 + tid) * 2;
    pml[0] = s_m[tid];
    pml[1] = s_l[tid];
  }
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(b) * kH * kC;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int md = 0; md < 4; ++md)
#pragma unroll
      for (int n = 0; n < 5; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = 8 * n + 2 * t + (e & 1);
          const int dim = warp * 64 + md * 16 + g + 8 * (e >> 1);
          const float x = acc[(md * 5 + n) * 4 + e];
          if (alone)
            store1(out + h * kC + dim, x / fmaxf(s_l[h], 1e-30f));
          else
            pacc[h * kC + dim] = x;
        }
  } else {
    const int d4 = 4 * (tid % 64), hb = 20 * (tid / 64);
#pragma unroll
    for (int i = 0; i < 20; ++i) {
      const int h = hb + i;
      float4 x = make_float4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2],
                             acc[i * 4 + 3]);
      if (alone) {
        const float den = fmaxf(s_l[h], 1e-30f);
        x = make_float4(x.x / den, x.y / den, x.z / den, x.w / den);
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + h * kC + d4) = x;
      } else {
        *reinterpret_cast<float4*>(pacc + h * kC + d4) = x;
      }
    }
  }
}

// The parts of one (batch, head) merged: grid (kH, B), 64 threads of 4
// value dims each.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                 int n) {
  const int h = blockIdx.x, b = blockIdx.y, d = 4 * threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * n * kH + h;   // part 0's row
  const float* pml = part + static_cast<size_t>(gridDim.y) * n * kH * kC;
  float M = kNegInf;
  for (int p = 0; p < n; ++p) M = fmaxf(M, __ldg(pml + (row0 + p * kH) * 2));
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < n; ++p) {
    const size_t r = row0 + static_cast<size_t>(p) * kH;
    const float w = expf(__ldg(pml + r * 2) - M);
    den = fmaf(__ldg(pml + r * 2 + 1), w, den);
    const float4 x = __ldg(reinterpret_cast<const float4*>(part + r * kC + d));
    num.x = fmaf(x.x, w, num.x);
    num.y = fmaf(x.y, w, num.y);
    num.z = fmaf(x.z, w, num.z);
    num.w = fmaf(x.w, w, num.w);
  }
  den = fmaxf(den, 1e-30f);
  T* o = out + (static_cast<size_t>(b) * kH + h) * kC + d;
  store1(o, num.x / den);
  store1(o + 1, num.y / den);
  store1(o + 2, num.z / den);
  store1(o + 3, num.w / den);
}

// Lets mla_decode_kernel<T> take Cfg::SMEM bytes of dynamic shared memory
// on ``device`` (once a device).
template <typename T>
cudaError_t allow_smem(int device) {
  static int attr_device = -1;
  if (attr_device == device) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<T>::SMEM);
  if (err == cudaSuccess) attr_device = device;
  return err;
}

template <typename T>
int launch(const Args& a, int B, int device, cudaStream_t s) {
  const cudaError_t err = allow_smem<T>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.per_part <= 0 || a.hi <= 0 || a.hi > a.L ||
      static_cast<long long>(a.n_parts) * a.per_part < a.hi ||
      static_cast<long long>(a.n_parts - 1) * a.per_part >= a.hi)
    return static_cast<int>(cudaErrorInvalidValue);
  mla_decode_kernel<T><<<dim3(a.n_parts, B), kThreads, Cfg<T>::SMEM, s>>>(a);
  if (a.n_parts > 1)
    mla_merge_kernel<T><<<dim3(kH, B), kMergeThreads, 0, s>>>(
        a.part, static_cast<T*>(a.out), a.n_parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int config(int device, int* cfg) {
  cudaError_t err = allow_smem<T>(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cfg[3], mla_decode_kernel<T>, kThreads, Cfg<T>::SMEM);
  cfg[0] = Cfg<T>::TS;
  cfg[1] = kW;
  cfg[2] = Cfg<T>::SMEM;
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a contiguous
// device pointer of one type (dtype 0: float32, 1: bfloat16), 16-byte
// aligned: q_lat and out [B, H, C], q_rope [B, H, R], ckv [B, L, C], krope
// [B, L, R]; part is float32 scratch of B * n_parts * H * (C + 2) floats
// (unused when n_parts is 1).  Part p walks slots p * per_part .. (p + 1) *
// per_part, clipped to hi = pos + 1; every part holds at least one slot.
// Launches on ``stream`` of ``device`` (the merge too, when n_parts > 1),
// does not synchronise, allocates nothing and returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for (H, C, R)
// other than (40, 256, 32) or parts that do not cover [0, hi).
extern "C" int mla_decode_launch(const void* q_lat, const void* q_rope,
                                 const void* ckv, const void* krope,
                                 void* out, void* part, int B, int H, int L,
                                 int C, int R, int dtype, float scale,
                                 int hi, int per_part, int n_parts,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (H != kH || C != kC || R != kR || n_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_lat, q_rope, ckv, krope, out, static_cast<float*>(part), L,
               scale, hi, per_part, n_parts};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, device, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's tiling at ``dtype`` on ``device``, for the wrapper's plan:
// cfg[0] slots a tile, cfg[1] warps a block, cfg[2] its dynamic shared
// memory in bytes, cfg[3] the blocks of it resident on one SM.  Returns 0
// or a CUDA error.
extern "C" int mla_decode_config(int dtype, int device, int* cfg) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) return config<float>(device, cfg);
  if (dtype == 1) return config<__nv_bfloat16>(device, cfg);
  return static_cast<int>(cudaErrorInvalidValue);
}
