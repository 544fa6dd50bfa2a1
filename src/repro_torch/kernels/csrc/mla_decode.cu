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
// The parts of one batch row's cache go to the blocks of one thread-block
// cluster (grid (parts, batch), cluster (parts, 1, 1)); the wrapper's plan
// (``mla_plan``) gives each part a run of whole tiles, as many parts as
// keep the card's SMs busy, at most a cluster's worth.
//
// bfloat16, the serving route (namespace tc):
//   * one producer thread loads q_lat | q_rope once and the part's slots
//     through a ring of NS stages of TS slots by TMA (3-D tensor maps over
//     the tensors as they are; ckv in 64-column boxes with 128-byte swizzle,
//     krope and q_rope in 32-column boxes with 64-byte swizzle; q's 40 head
//     rows in a 64-row box, rows 40-63 filled with zeros), full and empty
//     mbarriers; a run of up to NS tiles is requested at once (108 KB of
//     bytes in flight an SM);
//   * one consumer warpgroup puts the heads on wgmma's M side, 40 padded to
//     64 (the call sits far below the ridge, so the padding costs no time):
//     S [64 x TS] = [q_lat | q_rope] . [ckv | krope]^T, 18 k16 steps out of
//     shared memory; the scores stay in registers, a head is a row, so its
//     max and sum reduce over a quad of lanes; P is rounded to bf16 in the
//     A-fragment layout and O [64 x 256] += P . ckv takes ckv as the
//     MN-major B operand from the same staged rows (m64n256k16, 128
//     accumulators a thread: one warpgroup holds all 256 value dims, so no
//     P goes through shared memory);
//   * tile i's S and tile i-1's P . V are issued together, and the softmax
//     of tile i starts when S lands (wgmma.wait_group 1).  ptxas places
//     most of its exponentials after the P . V wait; pinning them ahead of
//     it (a shared store of the sums) measured no faster.  A part's walk
//     takes about 2.8 us and 0.8 us a tile on an H100 (PERF.md, PR 25);
//   * the parts merge inside the launch, over distributed shared memory:
//     each block owns a run of the 40 heads; every part writes its rows of
//     O and (m, l) to its own shared memory and sends each owner its
//     heads' rows with one bulk copy (cp.async.bulk to the owner's shared
//     memory, completing on the owner's mbarrier); each owner waits for
//     its n copies and adds its heads' parts from its own memory in the
//     order p = 0 .. n - 1 with the Pallas rule out = sum_p acc_p 2^(m_p -
//     M) / max(sum_p l_p 2^(m_p - M), 1e-30), M = max_p m_p (log2 units).
//     (Two earlier designs measured worse: reading every part's rows from
//     their blocks after a cluster sync, 0.008 of 0.018 ms; threads
//     storing them into the owners' memory one float2 at a time, about
//     0.005.)  No partials in device memory, no second launch, no atomics:
//     every call gives the same bits.
//
// float32, the parity route (namespace simt): the first design, kept: the
// block of 4 warps walks its part in tiles of 32 slots staged by cp.async,
// scores, softmax and O^T on the SIMT pipe in three __syncthreads-separated
// steps; the parts merge in a second launch that reads float32 partials
// (B * parts * H * (C + 2) floats of scratch).
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr int kH = 40;          // query heads
constexpr int kC = 256;         // latent width: the values' width
constexpr int kR = 32;          // shared rope width
constexpr int kD = kC + kR;     // a score's dot product

struct Args {
  const void* q_lat;   // [B, kH, kC]
  const void* q_rope;  // [B, kH, kR]
  const void* ckv;     // [B, L, kC]
  const void* krope;   // [B, L, kR]
  void* out;           // [B, kH, kC]
  float* part;         // float32: acc [B, n_parts, kH, kC], then (m, l) [B, n_parts, kH, 2]
  int L;
  float scale;
  int hi, per_part, n_parts;
};

// ----------------------------------------------------------------- float32

namespace simt {

constexpr int kW = 4;           // warps a block
constexpr int kThreads = kW * 32;
constexpr int kHW = kH / kW;    // heads whose softmax a warp keeps
constexpr int kMergeThreads = kC / 4;
constexpr int TS = 32;          // slots a tile
constexpr int NS = 2;           // stages of the ring
constexpr int ROW = kD + 4;     // floats a staged row: 16 bytes of padding
constexpr int STAGE = TS * ROW;
constexpr int SROW = TS + 4;    // float scores a head
constexpr int RING_BYTES = NS * STAGE * 4;
constexpr int Q_BYTES = kH * ROW * 4;
constexpr int S_BYTES = kH * SROW * 4;
// then corr, m and l of each head
constexpr int SMEM = RING_BYTES + Q_BYTES + S_BYTES + 3 * kH * 4;

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

// Rows [kD] = a[kA] | b[kD - kA] of ``n`` rows into dst (row stride ROW),
// 16 bytes a thread; rows at and past ``valid`` are zero-filled (source
// row 0 is read in their place, for a valid address).
__device__ __forceinline__ void stage_rows(float* dst, const float* a,
                                           const float* b, int a_w, int n,
                                           int valid, int tid) {
  constexpr int CPR = kD / 4;                             // chunks a row
  for (int c = tid; c < n * CPR; c += kThreads) {
    const int r = c / CPR, e = (c % CPR) * 4;
    const bool in = r < valid;
    const size_t src_r = in ? r : 0;
    const float* src = e < a_w ? a + src_r * a_w + e
                               : b + src_r * (kD - a_w) + (e - a_w);
    cp_async16(dst + r * ROW + e, src, in ? 16 : 0);
  }
}

// Each tile takes three steps, separated by __syncthreads: 1. scores into a
// float32 [40 heads][slots] buffer, lane l scoring slot l for the warp's 10
// heads; 2. the online-softmax update, warp w owning heads 10 w .. 10 w + 9
// (running max m and sum l), P over the scores and each head's correction
// exp(m_old - m_new) to shared memory; 3. O = O * corr + P . V, a thread
// owning 4 dims of 20 heads.
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + RING_BYTES);
  float* ss = reinterpret_cast<float*>(smem + RING_BYTES + Q_BYTES);
  float* s_corr = reinterpret_cast<float*>(smem + RING_BYTES + Q_BYTES +
                                           S_BYTES);
  float* s_m = s_corr + kH;
  float* s_l = s_m + kH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = blockIdx.x, b = blockIdx.y;
  const int j0 = part * a.per_part;
  const int j1 = min(a.hi, j0 + a.per_part);
  const int n_tiles = (j1 - j0 + TS - 1) / TS;   // >= 1 by the plan
  const float* ckv = static_cast<const float*>(a.ckv) + static_cast<size_t>(b) * a.L * kC;
  const float* krope = static_cast<const float*>(a.krope) + static_cast<size_t>(b) * a.L * kR;

  // q_lat | q_rope of the 40 heads, in the first tile's group
  stage_rows(qs, static_cast<const float*>(a.q_lat) + static_cast<size_t>(b) * kH * kC,
             static_cast<const float*>(a.q_rope) + static_cast<size_t>(b) * kH * kR,
             kC, kH, kH, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = j0 + s * TS;
      stage_rows(ring + s * STAGE, ckv + static_cast<size_t>(t0) * kC,
                 krope + static_cast<size_t>(t0) * kR, kC, TS, j1 - t0, tid);
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
  // acc[i][e] is dim 4 (tid % 64) + e of head 20 (tid / 64) + i
  float acc[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int nxt = it + NS - 1;
    if (nxt < n_tiles) {
      const int t0 = j0 + nxt * TS;
      stage_rows(ring + (nxt % NS) * STAGE, ckv + static_cast<size_t>(t0) * kC,
                 krope + static_cast<size_t>(t0) * kR, kC, TS, j1 - t0, tid);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const float* st = ring + (it % NS) * STAGE;
    const int valid = j1 - (j0 + it * TS);      // slots of the tile in the run

    // ---- 1. scores ss[h][slot], scaled; -inf past the run
    {
      float s[kHW];
#pragma unroll
      for (int i = 0; i < kHW; ++i) s[i] = 0.f;
      const float* kr = st + lane * ROW;
      const float* qw = qs + warp * kHW * ROW;
#pragma unroll 2
      for (int d = 0; d < kD; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int i = 0; i < kHW; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * ROW + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
      const bool in = lane < valid;
#pragma unroll
      for (int i = 0; i < kHW; ++i)
        ss[(warp * kHW + i) * SROW + lane] = in ? s[i] * a.scale : -INFINITY;
    }
    __syncthreads();

    // ---- 2. online softmax of heads 10 warp + i: P and the corrections
#pragma unroll
    for (int i = 0; i < kHW; ++i) {
      const int h = warp * kHW + i;
      float mx = ss[h * SROW + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      const float p = expf(ss[h * SROW + lane] - m_new);
      ss[h * SROW + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = fmaf(l[i], corr, sum);
      if (lane == 0) s_corr[h] = corr;
    }
    __syncthreads();

    // ---- 3. O = O * corr + P . V
    const int d4 = 4 * (tid % 64), hb = 20 * (tid / 64);
#pragma unroll
    for (int i = 0; i < 20; ++i) {
      const float c = s_corr[hb + i];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i * 4 + e] *= c;
    }
#pragma unroll 2
    for (int j = 0; j < TS; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(st + j * ROW + d4);
#pragma unroll
      for (int i = 0; i < 20; ++i) {
        const float p = ss[(hb + i) * SROW + j];
        acc[i * 4 + 0] = fmaf(p, v.x, acc[i * 4 + 0]);
        acc[i * 4 + 1] = fmaf(p, v.y, acc[i * 4 + 1]);
        acc[i * 4 + 2] = fmaf(p, v.z, acc[i * 4 + 2]);
        acc[i * 4 + 3] = fmaf(p, v.w, acc[i * 4 + 3]);
      }
    }
    __syncthreads();   // the stage and the scores are rewritten after this
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
  float* out = static_cast<float*>(a.out) + static_cast<size_t>(b) * kH * kC;
  const int d4 = 4 * (tid % 64), hb = 20 * (tid / 64);
#pragma unroll
  for (int i = 0; i < 20; ++i) {
    const int h = hb + i;
    float4 x = make_float4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2],
                           acc[i * 4 + 3]);
    if (alone) {
      const float den = fmaxf(s_l[h], 1e-30f);
      x = make_float4(x.x / den, x.y / den, x.z / den, x.w / den);
      *reinterpret_cast<float4*>(out + h * kC + d4) = x;
    } else {
      *reinterpret_cast<float4*>(pacc + h * kC + d4) = x;
    }
  }
}

// The parts of one (batch, head) merged: grid (kH, B), 64 threads of 4
// value dims each, in the order p = 0 .. n - 1.
__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
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
  *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * kH + h) * kC + d) =
      make_float4(num.x / den, num.y / den, num.z / den, num.w / den);
}

int launch(const Args& a, int B, int device, cudaStream_t s) {
  static int attr_device = -1;
  if (attr_device != device) {
    const cudaError_t err = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_device = device;
  }
  mla_decode_kernel<<<dim3(a.n_parts, B), kThreads, SMEM, s>>>(a);
  if (a.n_parts > 1)
    mla_merge_kernel<<<dim3(kH, B), kMergeThreads, 0, s>>>(
        a.part, static_cast<float*>(a.out), a.n_parts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------- bfloat16

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

struct Cfg {
  static constexpr int TS = 64;                   // slots a tile
  static constexpr int NS = 3;                    // stages of the ring
  static constexpr int THREADS = 256;             // producer warpgroup, consumer warpgroup
  static constexpr int MAX_PARTS = 16;            // blocks of a cluster
  static constexpr int QC_BYTES = 64 * 128;       // 64 head rows of 64 q_lat columns
  static constexpr int Q_BYTES = 4 * QC_BYTES + 64 * 64;        // q_lat | q_rope
  static constexpr int KC_BYTES = TS * 128;       // TS slots of 64 ckv columns
  static constexpr int STAGE_BYTES = 4 * KC_BYTES + TS * 64;    // ckv | krope
  static constexpr int RING_BYTES = NS * STAGE_BYTES;
  // a head's row of a part's output: O, then (m, l), then 6 floats of
  // padding: rows 264 floats apart put the float2 stores of a warp's 8
  // heads in distinct banks, and bulk copies move multiples of 16 bytes
  static constexpr int ROW_BYTES = (kC + 8) * 4;
  // rows the parts send to a block, one (part, owned head) each: n parts
  // times at most ceil(40 / n) heads, under 40 + MAX_PARTS
  static constexpr int RECV_ROWS = kH + MAX_PARTS;
  static constexpr int RECV_BYTES = RECV_ROWS * ROW_BYTES;
  static constexpr int BAR_BYTES = 8 * (2 + 2 * NS);
  static constexpr int SMEM = 1024 + Q_BYTES + RING_BYTES + RECV_BYTES + BAR_BYTES;
};
static_assert(kH * Cfg::ROW_BYTES + 4 * (Cfg::MAX_PARTS + 1) * kH <=
                  Cfg::RING_BYTES,
              "a part's rows and the merge's weights fit in the ring it no "
              "longer needs");

// Fetches a tensor map into the cache before its first load needs it.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The cluster barrier in its two halves: every thread of every block
// arrives, then waits for all.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of the same shared-memory byte in the block of cluster rank
// ``rank``.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// ``bytes`` of this block's shared memory at ``src`` to ``dst`` in a block
// of the cluster (an address from at_rank), completing them on that
// block's mbarrier ``bar``; the bulk-copy engine moves them, no thread.
__device__ __forceinline__ void bulk_to_rank(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// Heads are owned by the blocks of a cluster in contiguous runs: rank r
// owns heads owned_lo(r) = ceil(r 40 / n) .. owned_lo(r + 1) - 1.
__device__ __forceinline__ int owned_lo(int r, int n) {
  return (r * kH + n - 1) / n;
}

// S [64 heads x TS slots] = [q_lat | q_rope] . [ckv | krope]^T: 16 k16
// steps through the four 128-byte-swizzled ckv chunks, 2 through the
// 64-byte-swizzled rope chunk.
__device__ __forceinline__ void issue_s(float (&sc)[32], uint32_t sq,
                                        uint32_t st) {
  // offsets go into the descriptors' 16-byte address field
  const uint64_t dq = sw128_desc(sq, 16, 1024), dk = sw128_desc(st, 16, 1024);
  const uint64_t dqr = sw64_desc(sq + 4 * Cfg::QC_BYTES, 512);
  const uint64_t dkr = sw64_desc(st + 4 * Cfg::KC_BYTES, 512);
#pragma unroll
  for (int ks = 0; ks < 16; ++ks)
    wgmma_ss(sc, dq + ((ks / 4) * Cfg::QC_BYTES + (ks % 4) * 32) / 16,
             dk + ((ks / 4) * Cfg::KC_BYTES + (ks % 4) * 32) / 16, ks > 0);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) wgmma_ss(sc, dqr + 2 * ks, dkr + 2 * ks, 1);
}

// O [64 x 256] += P . ckv over a tile's TS slots, ckv the MN-major B
// operand: value-dim chunks of 64 KC_BYTES apart, 8-slot groups 1024 bytes.
__device__ __forceinline__ void issue_pv(float (&acc)[128],
                                         const uint32_t (&p)[16],
                                         uint32_t st) {
  const uint64_t dv = sw128_desc(st, Cfg::KC_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < Cfg::TS / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs(acc, a, dv + kk * 16 * 128 / 16);
  }
}

// The online-softmax update of one tile in log2 units: sc holds heads ra
// (j & 2 == 0) and rb of this thread over slot columns 8 (j / 4) + col0 +
// (j & 1); slots at and past ``valid`` are masked.  On return sc holds
// p = 2^(s - m_new), m and l are updated (l per thread) and corr_* =
// 2^(m_old - m_new).
__device__ __forceinline__ void softmax(float (&sc)[32], float& m_a,
                                        float& m_b, float& l_a, float& l_b,
                                        float& corr_a, float& corr_b,
                                        int valid, int col0, float c) {
  // two running maxima and sums a head (j / 4 % 2), halving the chains,
  // each started from its first element (j < 8, j even)
  float mx[2][2], sm[2][2];
  auto first = [](int j) { return j < 8 && !(j & 1); };
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float x = sc[j] * c;
    if (valid < Cfg::TS && 8 * (j / 4) + col0 + (j & 1) >= valid) x = kNegInf;
    sc[j] = x;
    float& m = mx[(j >> 1) & 1][(j >> 2) & 1];
    m = first(j) ? x : fmaxf(m, x);
  }
  const float mn_a = fmaxf(m_a, quad_max(fmaxf(mx[0][0], mx[0][1])));
  const float mn_b = fmaxf(m_b, quad_max(fmaxf(mx[1][0], mx[1][1])));
  corr_a = ex2(m_a - mn_a);
  corr_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float e = ex2(sc[j] - ((j & 2) ? mn_b : mn_a));
    float& l = sm[(j >> 1) & 1][(j >> 2) & 1];
    l = first(j) ? e : l + e;
    sc[j] = e;
  }
  l_a = l_a * corr_a + (sm[0][0] + sm[0][1]);
  l_b = l_b * corr_b + (sm[1][0] + sm[1][1]);
}

// grid (parts, batch), cluster (parts, 1, 1): part p walks slots p *
// per_part .. min(hi, (p + 1) * per_part).  Thread 0 loads; warpgroup 1
// computes, thread t (warp w, lane l) holding heads ra = 16 w + l / 4 and
// ra + 8 and, in an m64nN accumulator, register 4 j + e at column 8 j + 2
// (l % 4) + (e & 1) of head ra (e < 2) or ra + 8.  The merge: each block
// owns a run of heads (``owned_lo``); every part writes its rows of O and
// (m, l) to its own shared memory (the ring, free by then) and sends each
// owner its heads' rows by one bulk copy into the owner's receive rows
// (part p, head i at row p ceil(40 / n) + i), which completes on the
// owner's receive barrier; each owner waits for its n copies and adds its
// heads' parts from its own memory.  The cluster's one barrier, arrived
// at right after the barriers are set up and waited for before the first
// copy, keeps copies from reaching a block that has not begun.  ``flags``
// bit 0 skips the merge (timing the walk alone; the output is then not
// written).
__global__ void __launch_bounds__(Cfg::THREADS, 1)
mla_decode_wgmma_kernel(const __grid_constant__ CUtensorMap tql,
                        const __grid_constant__ CUtensorMap tqr,
                        const __grid_constant__ CUtensorMap tck,
                        const __grid_constant__ CUtensorMap tkr,
                        __nv_bfloat16* __restrict__ out, float scale, int hi,
                        int per_part, int flags) {
  constexpr int TS = Cfg::TS, NS = Cfg::NS, ROW = Cfg::ROW_BYTES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (sQ - smem_u32(smem_raw));  // sQ, generic
  const uint32_t sR = sQ + Cfg::Q_BYTES;            // the ring; sent rows
  const uint32_t sV = sR + Cfg::RING_BYTES;         // received rows
  const uint32_t q_full = sV + Cfg::RECV_BYTES;
  const uint32_t recv = q_full + 8;
  const uint32_t full0 = recv + 8, empty0 = full0 + 8 * NS;

  const int part = blockIdx.x, b = blockIdx.y, n = gridDim.x;
  const int j0 = part * per_part;
  const int j1 = min(hi, j0 + per_part);
  const int n_tiles = j1 > j0 ? (j1 - j0 + TS - 1) / TS : 0;
  const bool merge = !(flags & 1);
  const int hpb = (kH + n - 1) / n;                 // received rows a part
  const int h0 = owned_lo(part, n), nh = owned_lo(part + 1, n) - h0;

  if (threadIdx.x == 0) {
    prefetch_map(&tql);
    prefetch_map(&tqr);
    prefetch_map(&tck);
    prefetch_map(&tkr);
    mbar_init(q_full, 1);
    mbar_init(recv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (merge) mbar_expect_tx(recv, n * nh * ROW);
  }
  __syncthreads();
  if (merge) cluster_arrive_relaxed();

  const int lane = threadIdx.x % 32;
  const int ra = ((threadIdx.x / 32) % 4) * 16 + lane / 4, rb = ra + 8;
  const int col0 = 2 * (lane % 4);
  if (threadIdx.x == 0) {
    // ---- producer: q once, then the part's tiles through the ring
    mbar_expect_tx(q_full, Cfg::Q_BYTES);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      tma_load(sQ + c * Cfg::QC_BYTES, &tql, q_full, 64 * c, 0, b);
    tma_load(sQ + 4 * Cfg::QC_BYTES, &tqr, q_full, 0, 0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
      const uint32_t bar = full0 + 8 * s, st = sR + s * Cfg::STAGE_BYTES;
      const int t0 = j0 + i * TS;
      mbar_expect_tx(bar, Cfg::STAGE_BYTES);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tma_load(st + c * Cfg::KC_BYTES, &tck, bar, 64 * c, t0, b);
      tma_load(st + 4 * Cfg::KC_BYTES, &tkr, bar, 0, t0, b);
    }
  } else if (threadIdx.x >= 128) {
    // ---- consumer warpgroup
    const float c = scale * kLog2e;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    auto stage = [&](int i) { return sR + (i % NS) * Cfg::STAGE_BYTES; };
    auto wait_full = [&](int i) {
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
    };
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      float sc[32], corr_a, corr_b;
      uint32_t p[16];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      wait_full(0);
      wgmma_fence();
      issue_s(sc, sQ, stage(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, j1 - j0, col0, c);
#pragma unroll
      for (int k = 0; k < 16; ++k) p[k] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
      for (int i = 1; i < n_tiles; ++i) {
        wait_full(i);
        wgmma_fence();
        issue_s(sc, sQ, stage(i));
        wgmma_commit();
        issue_pv(acc, p, stage(i - 1));
        wgmma_commit();
        wgmma_wait<1>();     // S of tile i; P . V of tile i - 1 runs on
        fence_regs(sc);
        softmax(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, j1 - j0 - i * TS,
                col0, c);
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % NS));
#pragma unroll
        for (int k = 0; k < 128; ++k) acc[k] *= (k & 2) ? corr_b : corr_a;
#pragma unroll
        for (int k = 0; k < 16; ++k) p[k] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
      }
      wgmma_fence();
      issue_pv(acc, p, stage(n_tiles - 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    if (merge) {
      // this part's rows into the ring: every load has landed and been read
      float* const send = reinterpret_cast<float*>(sm + Cfg::Q_BYTES);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (ra < kH)
          *reinterpret_cast<float2*>(send + ra * (ROW / 4) + 8 * k + col0) =
              make_float2(acc[4 * k], acc[4 * k + 1]);
        if (rb < kH)
          *reinterpret_cast<float2*>(send + rb * (ROW / 4) + 8 * k + col0) =
              make_float2(acc[4 * k + 2], acc[4 * k + 3]);
      }
      if ((lane & 3) == 0) {
        if (ra < kH)
          *reinterpret_cast<float2*>(send + ra * (ROW / 4) + kC) =
              make_float2(m_a, l_a);
        if (rb < kH)
          *reinterpret_cast<float2*>(send + rb * (ROW / 4) + kC) =
              make_float2(m_b, l_b);
      }
      // the rows, written by this proxy, are read by the bulk copies'
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  }
  if (!merge) return;
  __syncthreads();
  cluster_wait();                        // every block has begun
  if (threadIdx.x < n) {
    // ---- each owner's heads' rows of this part: thread r's bulk copy
    const int r = threadIdx.x;
    const int lo = owned_lo(r, n), cnt = owned_lo(r + 1, n) - lo;
    bulk_to_rank(at_rank(sV + part * hpb * ROW, r), sR + lo * ROW,
                 cnt * ROW, at_rank(recv, r));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  mbar_wait(recv, 0);                    // every part's rows of our heads

  // ---- this block's heads, their parts added in the order p = 0 .. n - 1:
  // first each (part, head)'s weight 2^(m_p - M) and each head's sum of
  // l_p times it, into the ring past the sent rows
  const float* const rv = reinterpret_cast<const float*>(sm + (sV - sQ));
  float* const wgt = reinterpret_cast<float*>(sm + Cfg::Q_BYTES + kH * ROW);
  if (threadIdx.x < nh) {
    const int i = threadIdx.x;
    float2 ml[Cfg::MAX_PARTS];
    float M = kNegInf, den = 0.f;
#pragma unroll
    for (int p = 0; p < Cfg::MAX_PARTS; ++p)
      if (p < n)
        ml[p] = *reinterpret_cast<const float2*>(rv + (p * hpb + i) * (ROW / 4) + kC);
#pragma unroll
    for (int p = 0; p < Cfg::MAX_PARTS; ++p)
      if (p < n) M = fmaxf(M, ml[p].x);
#pragma unroll
    for (int p = 0; p < Cfg::MAX_PARTS; ++p)
      if (p < n) {
        const float wp = ex2(ml[p].x - M);
        den = fmaf(ml[p].y, wp, den);
        wgt[p * kH + i] = wp;
      }
    wgt[Cfg::MAX_PARTS * kH + i] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * kH + h0) * kC;
  for (int f = threadIdx.x; f < nh * (kC / 4); f += Cfg::THREADS) {
    const int i = f / (kC / 4), d = 4 * (f % (kC / 4));
    float4 x[Cfg::MAX_PARTS];
#pragma unroll
    for (int p = 0; p < Cfg::MAX_PARTS; ++p)
      if (p < n)
        x[p] = *reinterpret_cast<const float4*>(rv + (p * hpb + i) * (ROW / 4) + d);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < Cfg::MAX_PARTS; ++p)
      if (p < n) {
        const float wp = wgt[p * kH + i];
        num.x = fmaf(x[p].x, wp, num.x);
        num.y = fmaf(x[p].y, wp, num.y);
        num.z = fmaf(x[p].z, wp, num.z);
        num.w = fmaf(x[p].w, wp, num.w);
      }
    const float den = wgt[Cfg::MAX_PARTS * kH + i];
    *reinterpret_cast<uint2*>(ob + i * kC + d) =
        make_uint2(pack_bf16(num.x / den, num.y / den),
                   pack_bf16(num.z / den, num.w / den));
  }
  // this block's sent rows stay until the copies have read them
  if (threadIdx.x < n)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A bf16 [B, rows, cols] tensor as a 3-D tensor map, innermost first, with
// boxes of {64 columns, box_rows, 1} and 128-byte swizzle (cols 256) or
// {32, box_rows, 1} and 64-byte swizzle (cols 32); rows past the tensor
// read as zero.
CUresult make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                  int B, int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(cols) * 2;
  const cuuint64_t strides[2] = {row, row * rows};
  const bool wide = cols == kC;
  const cuuint32_t box[3] = {wide ? 64u : 32u,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             wide ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Lets the kernel take Cfg::SMEM bytes of dynamic shared memory and
// clusters of up to MAX_PARTS blocks on ``device`` (once a device).
cudaError_t allow(int device) {
  static int attr_device = -1;
  if (attr_device == device) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mla_decode_wgmma_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) attr_device = device;
  return err;
}

cudaLaunchConfig_t launch_config(int n_parts, int B, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_parts, B, 1);
  cfg.blockDim = dim3(Cfg::THREADS, 1, 1);
  cfg.dynamicSmemBytes = Cfg::SMEM;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_parts;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch(const Args& a, int B, int device, cudaStream_t s, int flags) {
  cudaError_t err = allow(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_parts > Cfg::MAX_PARTS) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tql, tqr, tck, tkr;
  CUresult r = make_map(enc, &tql, a.q_lat, B, kH, kC, 64);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tqr, a.q_rope, B, kH, kR, 64);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tck, a.ckv, B, a.L, kC, Cfg::TS);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tkr, a.krope, B, a.L, kR, Cfg::TS);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(a.n_parts, B, s, &attr);
  err = cudaLaunchKernelEx(&cfg, mla_decode_wgmma_kernel, tql, tqr, tck, tkr,
                           static_cast<__nv_bfloat16*>(a.out), a.scale, a.hi,
                           a.per_part, flags);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of n blocks resident at once on the card, for n = 1 ..
// MAX_PARTS, in clusters[n - 1] (0 for a size it refuses).
cudaError_t resident_clusters(int device, int* clusters) {
  cudaError_t err = allow(device);
  for (int n = 1; n <= Cfg::MAX_PARTS && err == cudaSuccess; ++n) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t lc = launch_config(n, 1, nullptr, &attr);
    if (cudaOccupancyMaxActiveClusters(&clusters[n - 1],
                                       mla_decode_wgmma_kernel, &lc) !=
        cudaSuccess) {
      clusters[n - 1] = 0;
      cudaGetLastError();
    }
  }
  return err;
}

}  // namespace tc

}  // namespace

// Plain C entry point, loaded with ctypes.  Every pointer is a contiguous
// device pointer of one type (dtype 0: float32, 1: bfloat16), 16-byte
// aligned: q_lat and out [B, H, C], q_rope [B, H, R], ckv [B, L, C], krope
// [B, L, R]; part is float32 scratch of B * n_parts * H * (C + 2) floats
// for the float32 route's merge (unused when n_parts is 1, and by bf16).
// Part p walks slots p * per_part .. (p + 1) * per_part, clipped to hi =
// pos + 1; the float32 route wants every part to hold a slot, the bf16
// route takes at most 16 parts (one cluster).  ``flags`` bit 0 (bf16)
// skips the merge, for timing the walk alone.  Launches on ``stream`` of
// ``device`` (the float32 merge too, when n_parts > 1), does not
// synchronise, allocates nothing and returns the CUDA error of the
// launches (0 on success), cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled, or cudaErrorInvalidValue for (H, C, R) other
// than (40, 256, 32) or parts that do not cover [0, hi).
extern "C" int mla_decode_launch(const void* q_lat, const void* q_rope,
                                 const void* ckv, const void* krope,
                                 void* out, void* part, int B, int H, int L,
                                 int C, int R, int dtype, float scale,
                                 int hi, int per_part, int n_parts,
                                 int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (H != kH || C != kC || R != kR || n_parts <= 0 || per_part <= 0 ||
      hi <= 0 || hi > L || static_cast<long long>(n_parts) * per_part < hi)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_lat, q_rope, ckv, krope, out, static_cast<float*>(part), L,
               scale, hi, per_part, n_parts};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (static_cast<long long>(n_parts - 1) * per_part >= hi)
      return static_cast<int>(cudaErrorInvalidValue);
    return simt::launch(a, B, device, s);
  }
  if (dtype == 1) return tc::launch(a, B, device, s, flags);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's tiling at ``dtype`` on ``device``, for the wrapper's plan:
// cfg[0] slots a tile, cfg[1] warps a block, cfg[2] its dynamic shared
// memory in bytes, cfg[3] the blocks of it resident on one SM, cfg[4] the
// most parts a batch row may take (bf16: a cluster's MAX_PARTS; float32:
// its merge's 1024), and for bf16 cfg[5 + n - 1] the clusters of n blocks
// resident at once, n = 1 .. 16.  cfg holds 21 ints.  Returns 0 or a CUDA
// error.
extern "C" int mla_decode_config(int dtype, int device, int* cfg) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 4; i < 21; ++i) cfg[i] = 0;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(simt::mla_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               simt::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &cfg[3], simt::mla_decode_kernel, simt::kThreads, simt::SMEM);
    cfg[0] = simt::TS;
    cfg[1] = simt::kW;
    cfg[2] = simt::SMEM;
    cfg[4] = 1024;
    return static_cast<int>(err);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  err = tc::allow(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cfg[3], tc::mla_decode_wgmma_kernel, tc::Cfg::THREADS,
        tc::Cfg::SMEM);
  cfg[0] = tc::Cfg::TS;
  cfg[1] = tc::Cfg::THREADS / 32;
  cfg[2] = tc::Cfg::SMEM;
  cfg[4] = tc::Cfg::MAX_PARTS;
  if (err == cudaSuccess) err = tc::resident_clusters(device, cfg + 5);
  return static_cast<int>(err);
}
