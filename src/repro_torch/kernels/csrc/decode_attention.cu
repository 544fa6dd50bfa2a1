// Flash decode for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache, in one launch.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (the Pallas TPU
// kernel).  It computes the same function: s = (q * scale) . k in float32,
// s = cap * tanh(s / cap) when a softcap is set, a slot masked to the finite
// NEG_INF = -2e38 unless its position p satisfies p <= pos and p > pos -
// window (window 0: no lower bound), softmax over the cache, times v, out in
// q's type.  The kv head of query head h is h / G.  The position of slot j
// is j, or k_pos[j] when a slot -> position map is given (the ring buffer of
// a sliding-window cache: modeling/attention.py builds it, with 2**30 for an
// empty slot).
//
// What bounds it on this card: the cache.  A decode step reads every valid
// K/V byte once and does 4 flops per byte pair, so it is bound by device
// memory (3.35 TB/s): about 20 us for jamba's attention layer (batch 8,
// 2,081 positions, 8 kv heads of 128), 5 us for a gemma3-1b global layer.
// What the design does about it:
//   * The grid is (parts, batch * kv heads).  A block of W warps (Cfg::W,
//     1 to 4 by the shared memory a warp's ring takes) owns one part of the
//     slots of one (batch, kv head); each warp owns a run of per_warp slots
//     of the part and keeps (m, l, acc) for all G query rows of the kv
//     head, so every K/V byte is read once.
//     The wrapper picks per_warp and the number of parts so that the grid
//     is one wave of resident blocks (decode_attention_config reports W,
//     the block's shared memory and its resident blocks an SM).
//   * A warp stages its slots in tiles of kT = 32 through a private ring of
//     kNS = 3 stages of shared memory, filled by cp.async (16 bytes a lane,
//     consecutive lanes on consecutive bytes of a row; slots past the run
//     are zero-filled), so two tiles are in flight while one is scored.
//     Rows are padded by 16 bytes, so ldmatrix and float4 reads of eight
//     rows fall in distinct banks.
//   * bf16: tensor cores, mma.sync.m16n8k16 (bf16 operands, float32 sums).
//     S^T = K . Q^T with M = 16 slots, N = 8 query rows (G < 8 pads the
//     rows with zero queries), K = 16 dims: K by ldmatrix from the ring, Q^T
//     held in registers for the whole run.  Then O^T += V^T . P^T with M =
//     16 dims, K = 16 slots: V^T by ldmatrix.trans, P^T from a small
//     per-warp buffer in shared memory to which each lane writes its P
//     rounded to bf16 (the accumulator layout of S^T is not the operand
//     layout of P^T).  The scale is applied to the float32 scores.
//   * float32: SIMT, no tensor cores (the float32 limits are 2e-5): lane l
//     scores slot l of the tile for every query row from shared memory
//     (q * scale is staged once a block), P goes through shared memory, and
//     lane l accumulates a slice of hd / 32 dims of every row.
//   * One online-softmax update per tile and row: the tile's max by three
//     (bf16) or five (float32) shuffles, one rescale of the accumulator; the
//     row sums stay partial per lane until the end of the run.
//   * One launch: the W warps of a block merge through shared memory; the
//     parts of one (batch, kv head) merge in the last block to finish.
//     Each block writes its (m, l, acc) to a float32 scratch the wrapper
//     allocates, makes it visible (__threadfence), and takes a ticket from
//     a per-(batch, kv head) counter; the block that draws n_parts - 1
//     merges every part and resets the counter to 0, so the next call
//     finds it zeroed and no memset launch is needed.  This was chosen over
//     a thread-block cluster with a merge through distributed shared
//     memory because a cluster holds at most 8 (portably) blocks, and at
//     batch 8 with one kv head a (batch, kv head) needs 16 parts to fill
//     the card.  The counters belong to one stream: two calls running at
//     once on two streams must not share them.
//   * The merge keeps the Pallas rule: out = sum_i acc_i exp(m_i - M) /
//     max(sum_i l_i exp(m_i - M), 1e-30), M = max_i m_i.  A masked slot
//     scores NEG_INF and counts like any other (so a fully masked input
//     gives the plain version's uniform average); a zero-filled slot past
//     the run scores -inf and weighs 0; a part whose slots are all masked
//     has m = NEG_INF and weight exp(NEG_INF - M) = 0 next to any part
//     with a kept slot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kT = 32;               // slots a tile
constexpr int kNS = 3;               // stages of a warp's ring
constexpr int kRingBudget = 212992;  // bytes of ring a block may take
constexpr int kMaxWarps = 4;
constexpr int kPST = kT + 8;         // bf16 P rows, padded: no bank conflicts

template <typename T, int HD>
struct Cfg {
  static constexpr int PAD = 16 / static_cast<int>(sizeof(T));
  static constexpr int ROW = HD + PAD;              // elements a staged row
  static constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;  // chunks a row
  static constexpr int STAGE = 2 * kT * ROW;        // K then V, elements
  static constexpr int WARP_RING = kNS * STAGE * static_cast<int>(sizeof(T));
  static constexpr int W = kRingBudget / WARP_RING < kMaxWarps
                               ? kRingBudget / WARP_RING : kMaxWarps;
  // after the rings: bf16, each warp's P [8][kPST]; float32, q * scale
  // [8][HD] for the block and each warp's P [8][kT]
  static constexpr int EXTRA = sizeof(T) == 2
                                   ? W * 8 * kPST * 2
                                   : 8 * HD * 4 + W * 8 * kT * 4;
  static constexpr int SMEM = W * WARP_RING + EXTRA;
  static_assert(W >= 1, "one warp's ring must fit the budget");
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

// d += a . b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* k_pos;
  void* out;
  float* part;      // acc [B * KV, n_parts, G, HD], then (m, l) [.., 2]
  int* counters;    // [B * KV], zero between calls
  int L, H, KV;
  float scale;
  int pos, window;
  float softcap;
  int lo, hi, per_warp, n_parts;
};

// What the mask makes of slot j: 0 past the run (zero-filled, weight 0), 1
// dropped by the mask (score NEG_INF), 2 kept.
__device__ __forceinline__ int slot_state(int j, int j1, const Args& a) {
  if (j >= j1) return 0;
  const int p = a.k_pos ? __ldg(a.k_pos + j) : j;
  return p <= a.pos && (a.window == 0 || p > a.pos - a.window) ? 2 : 1;
}

// The score after the softcap and the mask.
__device__ __forceinline__ float masked(float s, int state, const Args& a) {
  if (state == 0) return -INFINITY;
  if (state == 1) return kNegInf;
  return a.softcap != 0.f ? a.softcap * tanhf(s / a.softcap) : s;
}

// Stage slots [t0, t0 + kT) of (b, kv head) into one stage of the ring:
// K rows then V rows, zero-filled at and past j1.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* stage, const T* kc, const T* vc,
                                          size_t head0, size_t row, int t0,
                                          int j1, int lane) {
  using C = Cfg<T, HD>;
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
#pragma unroll 4
  for (int c = lane; c < kT * C::CPR; c += 32) {
    const int r = c / C::CPR, ch = c % C::CPR;
    const int j = t0 + r;
    const bool in = j < j1;
    const size_t off = head0 + static_cast<size_t>(in ? j : t0) * row +
                       ch * EPC;
    cp_async16(stage + r * C::ROW + ch * EPC, kc + off, in ? 16 : 0);
    cp_async16(stage + (kT + r) * C::ROW + ch * EPC, vc + off, in ? 16 : 0);
  }
}

// One warp's run [j0, j1) on the bf16 route.  Leaves the warp's m, l and
// unnormalised acc of rows g < G in wm [G], wl [G], wacc [G][HD].
template <int HD, int G>
__device__ void warp_run_bf16(const Args& a, __nv_bfloat16* ring,
                              __nv_bfloat16* ps, int b, int kh, int j0,
                              int j1, float* wm, float* wl, float* wacc) {
  using C = Cfg<__nv_bfloat16, HD>;
  using bf = __nv_bfloat16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf* kc = static_cast<const bf*>(a.k);
  const bf* vc = static_cast<const bf*>(a.v);
  const size_t row = static_cast<size_t>(a.KV) * HD;
  const size_t head0 = static_cast<size_t>(b) * a.L * row +
                       static_cast<size_t>(kh) * HD;

  // Q^T as the B operand: lane (g, t) holds q[row g][16 kb + 2t, +1] and
  // [16 kb + 8 + 2t, +1]; rows g >= G are zero
  uint32_t qf[HD / 16][2];
  {
    const bf* qb = static_cast<const bf*>(a.q) +
                   (static_cast<size_t>(b) * a.H + kh * G + g) * HD;
#pragma unroll
    for (int kb = 0; kb < HD / 16; ++kb) {
      qf[kb][0] = g < G ? *reinterpret_cast<const uint32_t*>(qb + kb * 16 + 2 * t) : 0u;
      qf[kb][1] = g < G ? *reinterpret_cast<const uint32_t*>(qb + kb * 16 + 8 + 2 * t) : 0u;
    }
  }
  // O^T accumulators: acc[md][e] is dim 16 md + g + 8 (e >> 1), row 2t + (e & 1)
  float acc[HD / 16][4];
#pragma unroll
  for (int md = 0; md < HD / 16; ++md)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[md][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_tiles = j1 > j0 ? (j1 - j0 + kT - 1) / kT : 0;
#pragma unroll
  for (int s = 0; s < kNS - 1; ++s) {
    if (s < n_tiles)
      load_tile<bf, HD>(ring + s * C::STAGE, kc, vc, head0, row, j0 + s * kT,
                        j1, lane);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + kNS - 1;
    if (nxt < n_tiles)
      load_tile<bf, HD>(ring + (nxt % kNS) * C::STAGE, kc, vc, head0, row,
                        j0 + nxt * kT, j1, lane);
    cp_async_commit();
    cp_async_wait<kNS - 1>();
    __syncwarp();
    const bf* ks = ring + (it % kNS) * C::STAGE;
    const bf* vs = ks + kT * C::ROW;
    const int t0 = j0 + it * kT;

    // S^T = K . Q^T: sc[mb][e] is slot 16 mb + g + 8 (e >> 1), row 2t + (e & 1)
    float sc[kT / 16][4];
#pragma unroll
    for (int mb = 0; mb < kT / 16; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mb][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < HD / 16; ++kb) {
#pragma unroll
      for (int mb = 0; mb < kT / 16; ++mb) {
        uint32_t af[4];
        ldmatrix_x4(af, ks + (mb * 16 + (lane & 15)) * C::ROW + kb * 16 +
                            (lane >> 4) * 8);
        mma_bf16(sc[mb], af, qf[kb][0], qf[kb][1]);
      }
    }
    // one online-softmax update for the tile, rows 2t and 2t + 1
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int mb = 0; mb < kT / 16; ++mb) {
      const int st[2] = {slot_state(t0 + mb * 16 + g, j1, a),
                         slot_state(t0 + mb * 16 + g + 8, j1, a)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[mb][e] = masked(sc[mb][e] * a.scale, st[e >> 1], a);
        mx[e & 1] = fmaxf(mx[e & 1], sc[mb][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int mb = 0; mb < kT / 16; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[mb][e] - m[e & 1]);
        l[e & 1] += p;
        ps[(2 * t + (e & 1)) * kPST + mb * 16 + g + 8 * (e >> 1)] =
            __float2bfloat16_rn(p);
      }
#pragma unroll
    for (int md = 0; md < HD / 16; ++md) {
      acc[md][0] *= corr[0];
      acc[md][1] *= corr[1];
      acc[md][2] *= corr[0];
      acc[md][3] *= corr[1];
    }
    __syncwarp();
    // O^T += V^T . P^T
#pragma unroll
    for (int ks16 = 0; ks16 < kT / 16; ++ks16) {
      const uint32_t pb0 = *reinterpret_cast<const uint32_t*>(
          ps + g * kPST + ks16 * 16 + 2 * t);
      const uint32_t pb1 = *reinterpret_cast<const uint32_t*>(
          ps + g * kPST + ks16 * 16 + 8 + 2 * t);
#pragma unroll
      for (int md = 0; md < HD / 16; ++md) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, vs + (ks16 * 16 + ((lane >> 4) << 3) +
                                    (lane & 7)) * C::ROW +
                                  md * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[md], af, pb0, pb1);
      }
    }
    __syncwarp();   // the stage and P are rewritten after this
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
  __syncthreads();   // every warp is done with its ring: the merge reuses it
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 2 * t + (e & 1);
    if (r < G) {
#pragma unroll
      for (int md = 0; md < HD / 16; ++md)
        wacc[r * HD + md * 16 + g + 8 * (e >> 1)] = acc[md][e];
      if (g == 0 && e < 2) {
        wm[r] = m[e];
        wl[r] = l[e];
      }
    }
  }
}

// One warp's run [j0, j1) on the float32 route (SIMT).  qs holds q * scale
// [G][HD]; ps is the warp's P [G][kT].
template <int HD, int G>
__device__ void warp_run_f32(const Args& a, float* ring, const float* qs,
                             float* ps, int b, int kh, int j0, int j1,
                             float* wm, float* wl, float* wacc) {
  using C = Cfg<float, HD>;
  constexpr int CW = HD / 32 >= 4 ? 4 : HD / 32;  // dims a lane reads at once
  constexpr int NCH = HD / 32 / CW;              // such reads a slot
  const int lane = threadIdx.x & 31;
  const float* kc = static_cast<const float*>(a.k);
  const float* vc = static_cast<const float*>(a.v);
  const size_t row = static_cast<size_t>(a.KV) * HD;
  const size_t head0 = static_cast<size_t>(b) * a.L * row +
                       static_cast<size_t>(kh) * HD;
  float acc[G][NCH * CW];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < NCH * CW; ++e) acc[g][e] = 0.f;
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int n_tiles = j1 > j0 ? (j1 - j0 + kT - 1) / kT : 0;
#pragma unroll
  for (int s = 0; s < kNS - 1; ++s) {
    if (s < n_tiles)
      load_tile<float, HD>(ring + s * C::STAGE, kc, vc, head0, row,
                           j0 + s * kT, j1, lane);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + kNS - 1;
    if (nxt < n_tiles)
      load_tile<float, HD>(ring + (nxt % kNS) * C::STAGE, kc, vc, head0, row,
                           j0 + nxt * kT, j1, lane);
    cp_async_commit();
    cp_async_wait<kNS - 1>();
    __syncwarp();
    const float* ks = ring + (it % kNS) * C::STAGE;
    const float* vs = ks + kT * C::ROW;
    const int st = slot_state(j0 + it * kT + lane, j1, a);

    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const float* kr = ks + lane * C::ROW;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + g * HD + d);
        s[g] = fmaf(qv.x, kv.x, s[g]);
        s[g] = fmaf(qv.y, kv.y, s[g]);
        s[g] = fmaf(qv.z, kv.z, s[g]);
        s[g] = fmaf(qv.w, kv.w, s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sg = masked(s[g], st, a);
      float mx = sg;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float corr = expf(m[g] - m_new);
      m[g] = m_new;
      const float p = expf(sg - m_new);
      l[g] = fmaf(l[g], corr, p);
      ps[g * kT + lane] = p;
#pragma unroll
      for (int e = 0; e < NCH * CW; ++e) acc[g][e] *= corr;
    }
    __syncwarp();
#pragma unroll 4
    for (int jj = 0; jj < kT; ++jj) {
      float vv[NCH * CW];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float* src = vs + jj * C::ROW + c * 32 * CW + lane * CW;
        if constexpr (CW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[c * 4] = x.x; vv[c * 4 + 1] = x.y;
          vv[c * 4 + 2] = x.z; vv[c * 4 + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[c * 2] = x.x; vv[c * 2 + 1] = x.y;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[g * kT + jj];
#pragma unroll
        for (int e = 0; e < NCH * CW; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
    __syncwarp();   // the stage and P are rewritten after this
  }
  cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
  __syncthreads();   // every warp is done with its ring: the merge reuses it
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e)
        wacc[g * HD + c * 32 * CW + lane * CW + e] = acc[g][c * CW + e];
    if (lane == 0) {
      wm[g] = m[g];
      wl[g] = l[g];
    }
  }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(Cfg<T, HD>::W * 32)
decode_kernel(const Args a) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ float s_mx[G], s_den[G];
  const int tid = threadIdx.x, warp = tid >> 5, nt = C::W * 32;
  const int part = blockIdx.x, bkv = blockIdx.y;
  const int b = bkv / a.KV, kh = bkv % a.KV;
  const int j0 = a.lo + (part * C::W + warp) * a.per_warp;
  const int j1 = min(a.hi, j0 + a.per_warp);
  T* ring = reinterpret_cast<T*>(smem) + warp * (kNS * C::STAGE);
  unsigned char* extra = smem + C::W * C::WARP_RING;
  // after the runs: [W][G] m, [W][G] l, [W][G][HD] acc, over the rings
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + C::W * G;
  float* wacc = wl + C::W * G;

  if constexpr (sizeof(T) == 2) {
    __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(extra) + warp * 8 * kPST;
    warp_run_bf16<HD, G>(a, ring, ps, b, kh, j0, j1, wm + warp * G,
                         wl + warp * G, wacc + warp * G * HD);
  } else {
    float* qs = reinterpret_cast<float*>(extra);
    float* ps = qs + 8 * HD + warp * 8 * kT;
    const float* q = static_cast<const float*>(a.q) +
                     (static_cast<size_t>(b) * a.H + kh * G) * HD;
    for (int i = tid; i < G * HD; i += nt) qs[i] = q[i] * a.scale;
    __syncthreads();
    warp_run_f32<HD, G>(a, ring, qs, ps, b, kh, j0, j1, wm + warp * G,
                        wl + warp * G, wacc + warp * G * HD);
  }
  __syncthreads();

  // merge the block's warps: (M, L, A) of each row g and dim d
  const bool alone = a.n_parts == 1;
  const int n = a.n_parts;
  const size_t n_rows = static_cast<size_t>(gridDim.y) * n * G;
  float* pacc = a.part + static_cast<size_t>(bkv) * n * G * HD;
  float* pml = a.part + n_rows * HD + static_cast<size_t>(bkv) * n * G * 2;
  for (int i = tid; i < G * HD; i += nt) {
    const int g = i / HD, d = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < C::W; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < C::W; ++w) {
      const float x = expf(wm[w * G + g] - M);
      L = fmaf(wl[w * G + g], x, L);
      A = fmaf(wacc[(w * G + g) * HD + d], x, A);
    }
    if (alone) {
      store1(static_cast<T*>(a.out) +
                 (static_cast<size_t>(b) * a.H + kh * G + g) * HD + d,
             A / fmaxf(L, 1e-30f));
    } else {
      pacc[(static_cast<size_t>(part) * G + g) * HD + d] = A;
      if (d == 0) {
        pml[(part * G + g) * 2] = M;
        pml[(part * G + g) * 2 + 1] = L;
      }
    }
  }
  if (alone) return;

  // the last block of this (batch, kv head) to finish merges the parts
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + bkv, 1) == n - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* wt = reinterpret_cast<float*>(smem);   // [n][G] weights
  float* wl_ = wt + n * G;                      // [n][G] weight * l
  for (int i = tid; i < n * G; i += nt) {
    wt[i] = __ldcg(pml + 2 * i);
    wl_[i] = __ldcg(pml + 2 * i + 1);
  }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf;
    for (int p = 0; p < n; ++p) M = fmaxf(M, wt[p * G + tid]);
    s_mx[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < n * G; i += nt) {
    wt[i] = expf(wt[i] - s_mx[i % G]);
    wl_[i] *= wt[i];
  }
  __syncthreads();
  if (tid < G) {
    float den = 0.f;
    for (int p = 0; p < n; ++p) den += wl_[p * G + tid];
    s_den[tid] = den;
  }
  __syncthreads();
  // out = sum_p w_p acc_p / den: X float4 of (row, 4 dims) a thread, PC
  // parts a round, so that up to 16 float4 loads are in flight at once
  constexpr int Q = G * HD / 4;
  constexpr int X = (Q + C::W * 32 - 1) / (C::W * 32);
  constexpr int PC = X >= 16 ? 1 : 16 / X;
  float4 num[X];
#pragma unroll
  for (int x = 0; x < X; ++x) num[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < n; p0 += PC) {
    float4 val[X][PC];
#pragma unroll
    for (int x = 0; x < X; ++x) {
      const int i = tid + x * nt, g = i / (HD / 4), d4 = i % (HD / 4);
#pragma unroll
      for (int c = 0; c < PC; ++c)
        val[x][c] = i < Q && p0 + c < n
                        ? __ldcg(reinterpret_cast<const float4*>(
                                     pacc + (static_cast<size_t>(p0 + c) * G + g) * HD) + d4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int x = 0; x < X; ++x) {
      const int g = (tid + x * nt) / (HD / 4);
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const float wp = p0 + c < n && g < G ? wt[(p0 + c) * G + g] : 0.f;
        num[x].x = fmaf(val[x][c].x, wp, num[x].x);
        num[x].y = fmaf(val[x][c].y, wp, num[x].y);
        num[x].z = fmaf(val[x][c].z, wp, num[x].z);
        num[x].w = fmaf(val[x][c].w, wp, num[x].w);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < X; ++x) {
    const int i = tid + x * nt;
    if (i < Q) {
      const int g = i / (HD / 4), d = 4 * (i % (HD / 4));
      const float den = fmaxf(s_den[g], 1e-30f);
      T* o = static_cast<T*>(a.out) +
             (static_cast<size_t>(b) * a.H + kh * G + g) * HD + d;
      store1(o, num[x].x / den);
      store1(o + 1, num[x].y / den);
      store1(o + 2, num[x].z / den);
      store1(o + 3, num[x].w / den);
    }
  }
  if (tid == 0) a.counters[bkv] = 0;
}

// Lets decode_kernel<T, HD, G> take Cfg::SMEM bytes of dynamic shared
// memory on ``device`` (once a device).
template <typename T, int HD, int G>
cudaError_t allow_smem(int device) {
  static int attr_device = -1;
  if (attr_device == device) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<T, HD>::SMEM);
  if (err == cudaSuccess) attr_device = device;
  return err;
}

template <typename T, int HD, int G>
int launch(const Args& a, int B, int device, cudaStream_t s) {
  using C = Cfg<T, HD>;
  const cudaError_t err = allow_smem<T, HD, G>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long covered =
      static_cast<long long>(a.n_parts) * C::W * a.per_warp;
  const long long merge_floats =
      static_cast<long long>(C::W) * G * (HD + 2) > 2LL * a.n_parts * G
          ? static_cast<long long>(C::W) * G * (HD + 2)
          : 2LL * a.n_parts * G;
  if (a.per_warp <= 0 || a.per_warp % 16 || covered < a.hi - a.lo ||
      merge_floats * 4 > static_cast<long long>(C::W) * C::WARP_RING)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.n_parts, B * a.KV);
  decode_kernel<T, HD, G><<<grid, C::W * 32, C::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cfg = {kT, W, SMEM, resident blocks an SM} of decode_kernel<T, HD, G>.
template <typename T, int HD, int G>
int config(int device, int* cfg) {
  using C = Cfg<T, HD>;
  cudaError_t err = allow_smem<T, HD, G>(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cfg[3], decode_kernel<T, HD, G>, C::W * 32, C::SMEM);
  cfg[0] = kT;
  cfg[1] = C::W;
  cfg[2] = C::SMEM;
  return static_cast<int>(err);
}

// f.template run<T, HD, G>() for the runtime (dtype, hd, G), or
// cudaErrorInvalidValue where there is no such instantiation.
template <typename T, int HD, typename F>
int dispatch_g(int G, F&& f) {
  switch (G) {
    case 1: return f.template run<T, HD, 1>();
    case 2: return f.template run<T, HD, 2>();
    case 4: return f.template run<T, HD, 4>();
    case 8: return f.template run<T, HD, 8>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename F>
int dispatch_hd(int hd, int G, F&& f) {
  switch (hd) {
    case 64: return dispatch_g<T, 64>(G, f);
    case 128: return dispatch_g<T, 128>(G, f);
    case 256: return dispatch_g<T, 256>(G, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int dispatch(int dtype, int hd, int G, F&& f) {
  if (dtype == 0) return dispatch_hd<float>(hd, G, f);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, G, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  const Args& a;
  int B, device;
  cudaStream_t s;
  template <typename T, int HD, int G>
  int run() const { return launch<T, HD, G>(a, B, device, s); }
};

struct Config {
  int device;
  int* cfg;
  template <typename T, int HD, int G>
  int run() const { return config<T, HD, G>(device, cfg); }
};

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a contiguous
// device pointer; q and out [B, H, hd], caches [B, L, KV, hd], all of one
// type (dtype 0: float32, 1: bfloat16), 16-byte aligned; k_pos is int32
// [L] or null; part is float32 scratch of B * KV * n_parts * (H / KV) *
// (hd + 2) floats, each part's acc [B * KV, n_parts, H / KV, hd] then its
// (m, l) [B * KV, n_parts, H / KV, 2] (unused when n_parts is 1); counters is int32 [B * KV], zero on entry
// and left zero.  Warp w of part i walks slots lo + (i * W + w) * per_warp
// .. + per_warp, clipped to hi, where W is the warps of a block at (dtype,
// hd) (Cfg::W).  Launches on ``stream`` of ``device``, does not
// synchronise, allocates nothing and returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue when per_warp is not a
// positive multiple of 16, the parts do not cover [lo, hi), or the merge
// does not fit the block's shared memory.  The caller checks shapes, G =
// H / KV in {1, 2, 4, 8}, hd in {64, 128, 256} and 0 <= lo < hi <= L.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    void* out, void* part, void* counters, int B, int L, int H, int KV,
    int hd, int dtype, float scale, int pos, int window, float softcap,
    int lo, int hi, int per_warp, int n_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV || n_parts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const int*>(k_pos), out,
         static_cast<float*>(part), static_cast<int*>(counters), L, H, KV,
         scale, pos, window, softcap, lo, hi, per_warp, n_parts};
  return dispatch(dtype, hd, H / KV,
                  Launch{a, B, device, static_cast<cudaStream_t>(stream)});
}

// The tiling of the kernel at (dtype, hd, G) on ``device``, for the
// wrapper's plan: cfg[0] = kT slots a tile, cfg[1] = W warps a block,
// cfg[2] = its dynamic shared memory in bytes (Cfg::SMEM), cfg[3] = the
// blocks of it resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor:
// shared memory, registers and threads).  Returns 0 or a CUDA error.
extern "C" int decode_attention_config(int dtype, int hd, int G, int device,
                                       int* cfg) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch(dtype, hd, G, Config{device, cfg});
}
