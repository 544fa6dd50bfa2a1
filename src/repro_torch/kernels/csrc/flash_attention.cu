// Forward flash attention for Hopper (sm_90a): online-softmax attention with
// a causal mask, a sliding window, a logit softcap and grouped KV heads.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel).  Both routes below compute its function: scores q . k times the
// scale in float32 (the float32 route scales q before the product, the bf16
// route the product), s = cap * tanh(s / cap) when a softcap is set, keys
// masked to the finite NEG_INF = -2e38 unless k < S, k <= q (causal) and
// k > q - window, then the Pallas update order m_new = max(m, rowmax(s)),
// corr = exp(m - m_new), p = exp(s - m_new), l = l * corr + rowsum(p),
// acc = acc * corr + p . v, and out = acc / max(l, 1e-30) in q's type.  The
// kv head of query head h is h / (H / KV).  Kv tiles that the causal mask or
// the window empty for a whole q tile are skipped: that leaves the function
// unchanged, because every query row keeps its own position, and a row whose
// first visited tile is fully masked heals on the next tile
// (corr = exp(NEG_INF - m) = 0).  Ragged S is masked (k < S), never padded
// in device memory.  The dtype picks the route; there is no fallback.
//
// bfloat16, the serving route (namespace tc).  What bounds it on this card:
// at jamba's attention layer (B 8, S 2048, 64 heads over 8 of hd 128,
// causal) it does 550 GFLOP against 0.6 GB of input and output, and at
// gemma3-1b's global layer (4 heads over 1 of hd 256) 69 GFLOP against
// 84 MB, so the bound is the tensor cores' 989 TFLOP/s, not the bytes.  The
// design is the one Hopper's tensor cores want:
//   - one block per (batch, query head, 128-row q tile), q tiles launched
//     longest causal rows first;
//   - Q, K and V come in by TMA (cp.async.bulk.tensor, 4-D tensor maps over
//     the [B, S, heads, hd] tensors as they are, 128-byte swizzle, rows >= S
//     zero-filled) in 64-column chunks; Q once, K and V through a ring of
//     NS stages, each with a full and an empty mbarrier;
//   - one producer thread (its warpgroup gives registers back with
//     setmaxnreg.dec) issues every load; two consumer warpgroups
//     (setmaxnreg.inc) own 64 query rows each;
//   - S = Q . K^T is wgmma with both operands in shared memory, float32
//     accumulators; the scale (folded with log2 e, so exp is ex2) comes
//     after the product; row max and row sum reduce over the four lanes of
//     a quad; a kv tile is masked element by element only where it crosses
//     a mask edge, and skipped where it is empty for the warpgroup's rows;
//   - P is rounded to bf16 in registers, where the S accumulators' layout is
//     already wgmma's A-fragment layout, and O += P . V is wgmma with V from
//     shared memory as an MN-major B operand (transpose bit);
//   - the epilogue divides by max(l, 1e-30) and stores bf16 pairs.
// Both routes take an optional float32 lse [B, H, S]: training passes it,
// and an instance of the kernel with LSE = true also stores each row's
// log-sum-exp m + log(l) in natural units for the backward
// (flash_attention_bwd.cu); serving passes null and runs the LSE = false
// instance, the kernel as it was before, and the output's bytes are the
// same either way.
// Rounding P to bf16 is a second rounding that the Pallas kernel, float32
// inside, does not make; it stays inside the bf16 tolerance of the tests.
// Tiles (BK keys a stage, NS stages; dynamic shared memory with 1 KB of
// alignment slack): hd 64 BK 128 NS 3, 113 KB; hd 128 BK 128 NS 2, 161 KB;
// hd 256 BK 64 NS 2, 193 KB; ptxas: 168 registers at launch (40 for the
// producer, 232 for the consumers after setmaxnreg), no spills.  MLA's q.k
// head 96 and v head 64 (minicpm3's prefill: the per-head keys [k_nope |
// shared k_rope] and values) has a kernel of its own, flash_fwd_mla_kernel
// below (192-row items, BK 64, NS 4, 117 KB, a persistent grid).
//
// float32, the parity route (namespace simt): the first design, kept as it
// was.  wgmma would take float32 only as TF32, about three decimal digits,
// which puts the float32 limits of the parity runs and the card tests (1e-3
// relative, 2e-5 absolute) at risk, so float32 multiplies in float32 FMAs
// out of shared memory: bound by the float32 pipe and shared-memory
// bandwidth, tens of times above the bound.  One block of 256 threads per
// (batch, head, 64-row q tile); each 64-row K/V tile is staged once in
// shared memory as float32 and used by all 64 query rows; every thread owns
// a 4 x 4 patch of the score tile and a 4 x hd/16 patch of the output, with
// the same four rows in both, so m and l stay in registers and reduce across
// the 16 lanes of a row group by warp shuffles.  Q and K are stored
// transposed ([hd][64]) so that the score loop reads both as float4 without
// bank conflicts.  Shared memory: (3 hd + 64) x 64 x 4 bytes, 208 KB at
// hd = 256.
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

// ----------------------------------------------------------------- float32

namespace simt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int HDQK, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(HDQK) * kBQ + HDQK * kBK +
                          HDV * kBK + kBK * kBQ);
}

// Rows row0 .. row0+63 of src (row r at src + r * stride) into dst
// transposed, dst[d * 64 + r] = mul * src[r][d]; rows >= S are zero.
// Consecutive threads take consecutive rows, so the transposed stores hit
// consecutive banks.
template <typename T, int HD>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 int row0, int S,
                                                 size_t stride, float mul) {
  for (int i = threadIdx.x; i < 64 * (HD / 4); i += kThreads) {
    const int r = i % 64, d = (i / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      x = load4(src + static_cast<size_t>(row0 + r) * stride + d);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    dst[(d + 0) * 64 + r] = x.x;
    dst[(d + 1) * 64 + r] = x.y;
    dst[(d + 2) * 64 + r] = x.z;
    dst[(d + 3) * 64 + r] = x.w;
  }
}

// Rows row0 .. row0+63 of src into dst as they are, dst[r * HD + d].
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int S, size_t stride) {
  for (int i = threadIdx.x; i < 64 * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) x = load4(src + static_cast<size_t>(row0 + r) * stride + d);
    store4(dst + r * HD + d, x);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// HDQK: q and k's head dim; HDV: v's and the output's.
template <typename T, int HDQK, int HDV, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, float scale, int causal, int window, float softcap,
                 float* __restrict__ lse) {
  constexpr int NC4 = HDV / 64;  // float4 column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HDQK][64], q * scale
  float* Kt = Qt + HDQK * kBQ;                   // [HDQK][64]
  float* Vs = Kt + HDQK * kBK;                   // [64][HDV]
  float* Pt = Vs + kBK * HDV;                    // [64 keys][64 rows]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;   // rows tr*4 .. tr*4+3 of the q tile
  const int tc = tid & 15;   // score columns tc*4 ..; output columns g*64+tc*4 ..
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const T* qb = q + (static_cast<size_t>(b) * S * H + h) * HDQK;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kh) * HDQK;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kh) * HDV;
  const size_t q_stride = static_cast<size_t>(H) * HDQK;
  const size_t k_stride = static_cast<size_t>(KV) * HDQK;
  const size_t v_stride = static_cast<size_t>(KV) * HDV;
  const size_t o_stride = static_cast<size_t>(H) * HDV;

  stage_transposed<T, HDQK>(Qt, qb, q0, S, q_stride, scale);

  float m[4], l[4], acc[4][NC4 * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC4 * 4; ++c) acc[i][c] = 0.f;
  }

  // keys that some row of this q tile may attend: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + kBQ) : S;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kBK, t_hi = (kv_hi + kBK - 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed; Qt is visible
    stage_transposed<T, HDQK>(Kt, kb, k0, S, k_stride, 1.f);
    stage_rows<T, HDV>(Vs, vb, k0, S, v_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDQK; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBQ + tr * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kBK + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc * 4 + j;
        float x = s[i][j];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window) ok = ok && kj > qi - window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], row_max16(rmax));
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
      l[i] = l[i] * corr + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC4 * 4; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tc * 4 + j) * kBQ + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + j * kBQ + tr * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NC4; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(Vs + j * HDV + g * 64 + tc * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g * 4 + 0] = fmaf(pv[i], w.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(pv[i], w.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(pv[i], w.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(pv[i], w.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(b) * S + qi) * o_stride +
              static_cast<size_t>(h) * HDV;
#pragma unroll
    for (int g = 0; g < NC4; ++g)
      store4(orow + g * 64 + tc * 4,
             make_float4(acc[i][g * 4 + 0] / den, acc[i][g * 4 + 1] / den,
                         acc[i][g * 4 + 2] / den, acc[i][g * 4 + 3] / den));
    // the row's log-sum-exp for the backward: m and l are the same in the
    // 16 lanes of a row group
    if constexpr (LSE) {
      if (tc == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + qi] = m[i] + logf(l[i]);
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------- bfloat16

namespace tc {

constexpr int kBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// HDQK: q and k's head dim, HDV: v's (equal in every instance; MLA's
// unequal pair has its own kernel, flash_fwd_mla_kernel).
template <int HDQK, int HDV>
struct Cfg {
  static constexpr int BK = HDQK == 256 ? 64 : 128;       // keys per stage
  static constexpr int NS = HDQK + HDV <= 160 ? 3 : 2;    // stages of the ring
  static constexpr int QK_CHUNKS = (HDQK + 63) / 64;      // 128-byte column chunks
  static constexpr int V_CHUNKS = HDV / 64;
  static constexpr int Q_BYTES = kBQ * QK_CHUNKS * 128;
  static constexpr int K_BYTES = BK * QK_CHUNKS * 128;    // one K stage
  static constexpr int V_BYTES = BK * HDV * 2;            // one V stage
  static constexpr int KV_BYTES = K_BYTES;                // the larger of the two
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the swizzled tiles start on 1024-byte boundaries
  static constexpr int SMEM = 1024 + Q_BYTES + NS * (K_BYTES + V_BYTES) + BAR_BYTES;
};


// Block layout: thread 0 (warpgroup 0) loads, warpgroups 1 and 2 compute
// query rows q0 .. q0+63 and q0+64 .. q0+127.  In a consumer warpgroup,
// thread t (warp w = t / 32, lane l) holds rows ra = 16 w + l / 4 and
// ra + 8 of its 64; accumulator register 4 j + e of an m64nN product holds
// column 8 j + 2 (l % 4) + (e & 1) of row ra (e < 2) or ra + 8 (e >= 2).
template <int HDQK, int HDV, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int B, int S, int H,
                       int KV, float scale, int causal, int window,
                       float softcap, float* __restrict__ lse) {
  using C = Cfg<HDQK, HDV>;
  constexpr int BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;             // NS stages
  const uint32_t sV = sK + NS * C::K_BYTES;        // NS stages
  const uint32_t q_full = sV + NS * C::V_BYTES;    // then full[NS], empty[NS]
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * NS;

  // q tiles slowest and in reverse, so the longest causal rows start first
  const int nq = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / (B * H)) * kBQ;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KV);
  // keys that some row of this q tile may attend: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + kBQ) : S;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / BK;
  const int n_tiles = (kv_hi + BK - 1) / BK - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::QK_CHUNKS; ++c)
        tma_load(sQ + c * kBQ * 128, &tq, q_full, c * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, C::K_BYTES + C::V_BYTES);
        const int k0 = (t_lo + i) * BK;
#pragma unroll
        for (int c = 0; c < C::QK_CHUNKS; ++c) {
          tma_load(sK + s * C::K_BYTES + c * BK * 128, &tk, bar, c * 64, kh,
                   k0, b);
          if (c < C::V_CHUNKS)
            tma_load(sV + s * C::V_BYTES + c * BK * 128, &tv, bar, c * 64, kh,
                     k0, b);
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_lo = q0 + (wg - 1) * 64;          // this warpgroup's rows
    const int qa = row_lo + (t / 32) * 16 + lane / 4, qb = qa + 8;
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // Q rows of this warpgroup: chunk c at sQ + c * 128 rows * 128 B
    const uint32_t sQw = sQ + (wg - 1) * 64 * 128;

    float acc[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      const int k0 = (t_lo + i) * BK;
      mbar_wait(full0 + 8 * s, (i / NS) & 1);
      // empty for every row of this warpgroup: nothing to add
      const bool dead = (causal && k0 > row_lo + 63) ||
                        (window && k0 + BK - 1 <= row_lo - window);
      if (!dead) {
        float sc[BK / 2];
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
        const uint32_t kst = sK + s * C::K_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HDQK / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;  // 16 columns of a chunk
          wgmma_ss(sc,
                   sw128_desc(sQw + (ks / 4) * kBQ * 128 + off, 16, 1024),
                   sw128_desc(kst + (ks / 4) * BK * 128 + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // scores in log2 units, softcap, masks
        const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row_lo) ||
                          (window && k0 <= row_lo + 63 - window);
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          float x = sc[j];
          if (softcap != 0.f)
            x = softcap * tanhf(x * scale / softcap) * kLog2e;
          else
            x *= scale_log2;
          if (edge) {
            const int kj = k0 + 8 * (j / 4) + col0 + (j & 1);
            const int qi = (j & 2) ? qb : qa;
            bool ok = kj < S;
            if (causal) ok = ok && kj <= qi;
            if (window) ok = ok && kj > qi - window;
            x = ok ? x : kNegInf;
          }
          sc[j] = x;
          if (j & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
        }
        const float mn_a = fmaxf(m_a, quad_max(mx_a));
        const float mn_b = fmaxf(m_b, quad_max(mx_b));
        const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t p[BK / 4];
#pragma unroll
        for (int j = 0; j < BK / 2; j += 2) {
          const float mn = (j & 2) ? mn_b : mn_a;
          const float e0 = exp2f(sc[j] - mn), e1 = exp2f(sc[j + 1] - mn);
          if (j & 2) sum_b += e0 + e1; else sum_a += e0 + e1;
          p[j / 2] = pack_bf16(e0, e1);
        }
        // per-thread partial sums; the quad's lanes share corr
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
#pragma unroll
        for (int j = 0; j < HDV / 2; ++j) acc[j] *= (j & 2) ? corr_b : corr_a;

        const uint32_t vst = sV + s * C::V_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                 p[4 * kk + 3]};
          // V as the MN-major B operand: 16 key rows from row 16 kk; column
          // chunks of 64 BK * 128 bytes apart, 8-row groups 1024 bytes apart
          wgmma_rs(acc, a, sw128_desc(vst + kk * 16 * 128, BK * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (t == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: the quad's partial sums, then out = acc / max(l, 1e-30)
    const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
    const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
    const size_t o_stride = static_cast<size_t>(H) * HDV;
    __nv_bfloat16* oa =
        o + (static_cast<size_t>(b) * S + qa) * o_stride + h * HDV + col0;
    __nv_bfloat16* ob = oa + 8 * o_stride;
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j) {
      if (qa < S)
        *reinterpret_cast<uint32_t*>(oa + 8 * j) =
            pack_bf16(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (qb < S)
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            pack_bf16(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
    // the rows' log-sum-exp for the backward, in natural units: m is in
    // log2 units (kLog2e folded into the scale), l sums exp2 and is at
    // least 1 (the row's maximum adds exp2(0)), so it is den
    if constexpr (LSE) {
      if ((lane & 3) == 0) {
        float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
        if (qa < S) lrow[qa] = (m_a + log2f(den_a)) * kLn2;
        if (qb < S) lrow[qb] = (m_b + log2f(den_b)) * kLn2;
      }
    }
  }
}

// ------------------------------------------- MLA's prefill: q.k 96, v 64
//
// minicpm3-4b's prefill attends per head with q and k rows of 96 columns
// (nope 64 | rope 32) and v rows of 64.  At its serving shape (B 8, S 2048,
// 40 heads, causal) the products take 0.217 ms at the bf16 peak, and the
// exponentials (671 M kept scores at 16 a clock on each SM) about 0.16 ms:
// 0.74 of the product time, where at hd 256 they are 0.23.  A score here
// carries 160 multiply-adds, so the softmax's handful of instructions a
// score (max, FFMA, EX2, sum, pack, rescale) takes the SM's four issue
// slots about as long as the tensor cores take the products.  The design:
//   - three consumer warpgroups of 64 query rows (a 192-row q item, BQ)
//     share each staged K/V tile: the tensor cores see three chains of
//     products, and a staged key serves 1.5x the rows of a 128-row tile;
//   - inside a warpgroup, tile i's S = Q . K^T and tile i-1's O += P . V
//     are issued together; the softmax of tile i runs on S as soon as S
//     lands (wgmma.wait_group 1), O is rescaled after (wait_group 0).
//     ptxas places most exponentials after that second wait; pinning them
//     ahead of it measured no faster;
//   - the scale and log2 e fold into the exponent, p = ex2(x c - m c), one
//     FFMA before a bare MUFU.EX2 (ex2.approx.ftz); the running max is kept
//     over the raw scores (max commutes with a positive scale; a negative
//     one takes the max of -x), in four chains a row.  Tiles that cross a
//     mask edge, and any tile with a softcap, take a general path that
//     scores, caps and masks element by element;
//   - q's and k's 96 columns come in as a 64-column box with 128-byte
//     swizzle and a 32-column box with 64-byte swizzle (two tensor maps on
//     each tensor), not two zero-padded 128-byte boxes: Q takes 36 KB, a
//     stage of 64 keys 20 KB (117 KB in all);
//   - the grid is persistent: one block an SM walks every gridDim.x-th
//     (batch, head, q tile) item (``mla_item``: the items in flight at once
//     share their heads' K and V through L2), and the producer loads the
//     next item's Q and K/V while the consumers finish the last tiles and
//     the epilogue of the one before.  The Q buffer has its own empty
//     barrier; the ring's stage and phase count on across items.
// Registers: the producer gives back to 32 (setmaxnreg), the consumers take
// 160 (S 32, O 32, P 16 a thread at 64 keys a stage).
// Measured on an H100 (PERF.md, PR 25): 128 keys a stage (S 64 registers)
// spills and runs 5% slower; two consumer warpgroups, 10-20% slower; the
// warpgroups taking turns to issue their products (named barriers), a
// second Q buffer, warpgroups staggered at the start, skipping the rescale
// where no max moved, or a share of the exponentials as an FMA polynomial,
// each slower; q tiles as the
// slowest index of the items (132 heads' K and V in flight, read from
// device memory by every q tile) 0.79 against 0.70 ms at 128 keys, and the
// (batch, head)-major order without the rotation 1.01 (a block always
// draws the same q tile); clock stamps put about half of a warpgroup's
// time in its softmax and most of the rest in issuing and queueing its
// products, 7% in waiting for data.
struct MlaCfg {
  static constexpr int NWG = 3;                    // consumer warpgroups
  static constexpr int BQ = 64 * NWG;              // query rows an item
  static constexpr int BK = 64;                    // keys a stage
  static constexpr int NS = 4;                     // stages of the ring
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int PRODUCER_REGS = NWG == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = NWG == 3 ? 160 : 232;
  static constexpr int QA_BYTES = BQ * 128;        // q columns 0-63
  static constexpr int QB_BYTES = BQ * 64;         // q columns 64-95
  static constexpr int KA_BYTES = BK * 128;        // k columns 0-63
  static constexpr int KB_BYTES = BK * 64;         // k columns 64-95
  static constexpr int V_BYTES = BK * 128;
  static constexpr int STAGE_BYTES = KA_BYTES + KB_BYTES + V_BYTES;
  static constexpr int BAR_BYTES = 8 * (2 + 2 * NS);
  static constexpr int SMEM = 1024 + QA_BYTES + QB_BYTES + NS * STAGE_BYTES + BAR_BYTES;
};

// One item of the persistent grid: a q tile of one (batch, head), and the
// kv tiles [t_lo, t_lo + n_tiles) that some row of it may attend.  The
// (batch, head) is the item's slowest index, so that the ~132 items in
// flight at once share the K and V of about 12 heads through L2 (with q
// tiles slowest they would be 132 heads, whose K and V, read again by each
// of 11 q tiles, come from device memory every time: 1.3 GB at minicpm3's
// prefill).  Inside a (batch, head) the q tiles run longest causal rows
// first, rotated by the (batch, head)'s index, so that a block, which
// takes every gridDim.x-th item, meets every length in turn.
struct MlaItem {
  int q0, b, h, kh, t_lo, n_tiles;
};

__device__ __forceinline__ MlaItem mla_item(int item, int nq, int S, int H,
                                            int KV, int causal, int window) {
  using C = MlaCfg;
  MlaItem it;
  const int bh = item / nq;
  it.q0 = (nq - 1 - (item % nq + bh) % nq) * C::BQ;
  it.b = bh / H;
  it.h = bh % H;
  it.kh = it.h / (H / KV);
  const int kv_hi = causal ? min(S, it.q0 + C::BQ) : S;
  const int kv_lo = window ? max(0, it.q0 - window + 1) : 0;
  it.t_lo = kv_lo / C::BK;
  it.n_tiles = (kv_hi + C::BK - 1) / C::BK - it.t_lo;
  return it;
}

// S = Q . K^T for a warpgroup's 64 rows and a stage's BK keys: 4 k16
// steps in the 128-byte-swizzled columns 0-63, 2 in the 64-byte-swizzled
// columns 64-95.
__device__ __forceinline__ void mla_issue_s(float (&sc)[MlaCfg::BK / 2],
                                            uint32_t qa, uint32_t qb,
                                            uint32_t st) {
  // a k16 step is 32 bytes further along the rows: 2 in the descriptors'
  // 16-byte address field
  const uint64_t da = sw128_desc(qa, 16, 1024), dk = sw128_desc(st, 16, 1024);
  const uint64_t db = sw64_desc(qb, 512);
  const uint64_t dkb = sw64_desc(st + MlaCfg::KA_BYTES, 512);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_ss(sc, da + 2 * ks, dk + 2 * ks, ks > 0);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) wgmma_ss(sc, db + 2 * ks, dkb + 2 * ks, 1);
}

// O += P . V over a stage's BK keys, V the MN-major B operand.
__device__ __forceinline__ void mla_issue_pv(float (&acc)[32],
                                             const uint32_t (&p)[MlaCfg::BK / 4],
                                             uint32_t st) {
  // 16 keys are 16 rows of 128 bytes further: 128 in the address field
  const uint64_t dv = sw128_desc(st + MlaCfg::KA_BYTES + MlaCfg::KB_BYTES,
                                 MlaCfg::BK * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < MlaCfg::BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs(acc, a, dv + 128 * kk);
  }
}

// The online-softmax update of one tile's scores, in log2 units: sc holds
// rows qa (j & 2 == 0) and qb of this thread; on return it holds p =
// 2^(score - m_new), m and l are updated (l per thread; the quad's partial
// sums add up in the epilogue) and corr_* = 2^(m_old - m_new).  ``general``
// (a mask edge or a softcap) scores, caps and masks element by element as
// the equal-dim kernel does; otherwise the scale folds into the exponent.
__device__ __forceinline__ void mla_softmax(
    float (&sc)[MlaCfg::BK / 2], float& m_a, float& m_b, float& l_a,
    float& l_b, float& corr_a, float& corr_b, bool general, int k0, int qa,
    int qb, int col0, int S, int causal, int window, float scale, float c,
    float softcap) {
  constexpr int N = MlaCfg::BK / 2;
  // four running maxima and sums a row (j / 4 % 4), so that no chain of
  // dependent FMNMX or FADD runs the length of the tile; each starts from
  // its first element (j < 16, j even), which saves 16 instructions a tile
  float mx[2][4], sm[2][4];
  auto first = [](int j) { return j < 16 && !(j & 1); };
  if (general) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float x = sc[j];
      if (softcap != 0.f)
        x = softcap * tanhf(x * scale / softcap) * kLog2e;
      else
        x *= c;
      const int kj = k0 + 8 * (j / 4) + col0 + (j & 1);
      const int qi = (j & 2) ? qb : qa;
      bool ok = kj < S;
      if (causal) ok = ok && kj <= qi;
      if (window) ok = ok && kj > qi - window;
      x = ok ? x : kNegInf;
      sc[j] = x;
      float& m = mx[(j >> 1) & 1][(j >> 2) & 3];
      m = first(j) ? x : fmaxf(m, x);
    }
  } else {
    // max over the raw scores: c x is largest where x is (c >= 0) or -x is
    if (c >= 0.f) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float& m = mx[(j >> 1) & 1][(j >> 2) & 3];
        m = first(j) ? sc[j] : fmaxf(m, sc[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float& m = mx[(j >> 1) & 1][(j >> 2) & 3];
        m = first(j) ? -sc[j] : fmaxf(m, -sc[j]);
      }
    }
  }
  const float s_a = general ? 1.f : fabsf(c);
  const float mn_a = fmaxf(m_a, s_a * quad_max(fmaxf(fmaxf(mx[0][0], mx[0][1]),
                                                     fmaxf(mx[0][2], mx[0][3]))));
  const float mn_b = fmaxf(m_b, s_a * quad_max(fmaxf(fmaxf(mx[1][0], mx[1][1]),
                                                     fmaxf(mx[1][2], mx[1][3]))));
  corr_a = ex2(m_a - mn_a);
  corr_b = ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  // general: p = 2^(y - m); else p = 2^(x c - m), one FFMA
  const float cc = general ? 1.f : c;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float e = ex2(fmaf(sc[j], cc, (j & 2) ? -mn_b : -mn_a));
    float& l = sm[(j >> 1) & 1][(j >> 2) & 3];
    l = first(j) ? e : l + e;
    sc[j] = e;
  }
  l_a = l_a * corr_a + ((sm[0][0] + sm[0][1]) + (sm[0][2] + sm[0][3]));
  l_b = l_b * corr_b + ((sm[1][0] + sm[1][1]) + (sm[1][2] + sm[1][3]));
}

__device__ __forceinline__ void mla_pack(uint32_t (&p)[MlaCfg::BK / 4],
                                         const float (&sc)[MlaCfg::BK / 2]) {
#pragma unroll
  for (int j = 0; j < MlaCfg::BK / 4; ++j)
    p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

// Block layout: thread 0 (warpgroup 0) loads; consumer warpgroup w = 1 ..
// NWG computes rows q0 + 64 (w - 1) .. + 63 of each item, with the thread
// and register layout of the equal-dim kernel.  Every consumer warp
// arrives once on each empty barrier (count 4 NWG), after its own wgmma
// wait.
template <bool LSE>
__global__ void __launch_bounds__(MlaCfg::THREADS, 1)
flash_fwd_mla_kernel(const __grid_constant__ CUtensorMap tqa,
                     const __grid_constant__ CUtensorMap tqb,
                     const __grid_constant__ CUtensorMap tka,
                     const __grid_constant__ CUtensorMap tkb,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, int B, int S, int H,
                     int KV, float scale, int causal, int window,
                     float softcap, float* __restrict__ lse) {
  using C = MlaCfg;
  constexpr int BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQA = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQB = sQA + C::QA_BYTES;
  const uint32_t sK = sQB + C::QB_BYTES;           // NS stages [KA | KB | V]
  const uint32_t q_full = sK + NS * C::STAGE_BYTES;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * NS;
  const int nq = (S + C::BQ - 1) / C::BQ;
  const int n_items = nq * B * H;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * C::NWG);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int g = 0, j = 0;   // kv stages filled, items begun
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
        const MlaItem it = mla_item(item, nq, S, H, KV, causal, window);
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, C::QA_BYTES + C::QB_BYTES);
        tma_load(sQA, &tqa, q_full, 0, it.h, it.q0, it.b);
        tma_load(sQB, &tqb, q_full, 64, it.h, it.q0, it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++g) {
          const int s = g % NS;
          mbar_wait(empty0 + 8 * s, ((g / NS) & 1) ^ 1);
          const uint32_t bar = full0 + 8 * s, st = sK + s * C::STAGE_BYTES;
          const int k0 = (it.t_lo + i) * BK;
          mbar_expect_tx(bar, C::STAGE_BYTES);
          tma_load(st, &tka, bar, 0, it.kh, k0, it.b);
          tma_load(st + C::KA_BYTES, &tkb, bar, 64, it.kh, k0, it.b);
          tma_load(st + C::KA_BYTES + C::KB_BYTES, &tv, bar, 0, it.kh, k0,
                   it.b);
        }
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int col0 = 2 * (lane % 4);
  const float c = scale * kLog2e;
  const uint32_t sQAw = sQA + (wg - 1) * 64 * 128;
  const uint32_t sQBw = sQB + (wg - 1) * 64 * 64;
  const size_t o_stride = static_cast<size_t>(H) * 64;
  int g = 0, j = 0;   // kv stages consumed, items begun
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
    const MlaItem it = mla_item(item, nq, S, H, KV, causal, window);
    const int row_lo = it.q0 + (wg - 1) * 64;      // this warpgroup's rows
    const int qa = row_lo + (t / 32) * 16 + lane / 4, qb = qa + 8;
    // the tiles with a row of this warpgroup to add: [a, e); the window
    // empties a prefix, the causal mask a suffix
    int a = 0, e = it.n_tiles;
    auto dead = [&](int i) {
      const int k0 = (it.t_lo + i) * BK;
      return (causal && k0 > row_lo + 63) ||
             (window && k0 + BK - 1 <= row_lo - window);
    };
    while (a < e && dead(a)) ++a;
    while (e > a && dead(e - 1)) --e;
    auto stage = [&](int i) { return sK + ((g + i) % NS) * C::STAGE_BYTES; };
    auto wait_full = [&](int i) {
      mbar_wait(full0 + 8 * ((g + i) % NS), ((g + i) / NS) & 1);
    };
    auto release = [&](int i) {
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g + i) % NS));
    };
    auto general = [&](int i) {
      const int k0 = (it.t_lo + i) * BK;
      return softcap != 0.f || k0 + BK > S ||
             (causal && k0 + BK - 1 > row_lo) ||
             (window && k0 <= row_lo + 63 - window);
    };

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    mbar_wait(q_full, j & 1);
    for (int i = 0; i < a; ++i) {
      wait_full(i);
      release(i);
    }
    if (a < e) {
      float sc[BK / 2], corr_a, corr_b;
      uint32_t p[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      wait_full(a);
      wgmma_fence();
      mla_issue_s(sc, sQAw, sQBw, stage(a));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (a + 1 == e && lane == 0) mbar_arrive(q_empty);
      mla_softmax(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, general(a),
                  (it.t_lo + a) * BK, qa, qb, col0, S, causal, window, scale,
                  c, softcap);
      mla_pack(p, sc);
      for (int i = a + 1; i < e; ++i) {
        wait_full(i);
        wgmma_fence();
        mla_issue_s(sc, sQAw, sQBw, stage(i));
        wgmma_commit();
        mla_issue_pv(acc, p, stage(i - 1));
        wgmma_commit();
        wgmma_wait<1>();     // S of tile i; P . V of tile i - 1 runs on
        fence_regs(sc);
        if (i + 1 == e && lane == 0) mbar_arrive(q_empty);
        mla_softmax(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, general(i),
                    (it.t_lo + i) * BK, qa, qb, col0, S, causal, window,
                    scale, c, softcap);
        wgmma_wait<0>();
        fence_regs(acc);
        release(i - 1);
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] *= (k & 2) ? corr_b : corr_a;
        mla_pack(p, sc);
      }
      wgmma_fence();
      mla_issue_pv(acc, p, stage(e - 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(e - 1);
    } else if (lane == 0) {
      mbar_arrive(q_empty);
    }
    for (int i = e; i < it.n_tiles; ++i) {
      wait_full(i);
      release(i);
    }
    g += it.n_tiles;

    // epilogue, while the producer loads the next item: the quad's partial
    // sums, then out = acc / max(l, 1e-30)
    const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
    const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
    __nv_bfloat16* oa =
        o + (static_cast<size_t>(it.b) * S + qa) * o_stride + it.h * 64 + col0;
    __nv_bfloat16* ob = oa + 8 * o_stride;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (qa < S)
        *reinterpret_cast<uint32_t*>(oa + 8 * k) =
            pack_bf16(acc[4 * k] / den_a, acc[4 * k + 1] / den_a);
      if (qb < S)
        *reinterpret_cast<uint32_t*>(ob + 8 * k) =
            pack_bf16(acc[4 * k + 2] / den_b, acc[4 * k + 3] / den_b);
    }
    if constexpr (LSE) {
      if ((lane & 3) == 0) {
        float* lrow = lse + (static_cast<size_t>(it.b) * H + it.h) * S;
        if (qa < S) lrow[qa] = (m_a + log2f(den_a)) * kLn2;
        if (qb < S) lrow[qb] = (m_b + log2f(den_b)) * kLn2;
      }
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch

// A bf16 [B, S, heads, hd] tensor as a 4-D tensor map, innermost first;
// boxes of {cols columns, 1 head, rows, 1 batch}: 64 columns (128 bytes)
// with 128-byte swizzle, or 32 (64 bytes) with 64-byte swizzle;
// out-of-range rows read as zero.
CUresult make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                  int B, int S, int heads, int hd, int rows, int cols = 64) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HDQK, int HDV>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int H, int KV, float scale,
              int causal, int window, float softcap, cudaStream_t stream) {
  using C = tc::Cfg<HDQK, HDV>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, B, S, H, HDQK, tc::kBQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, k, B, S, KV, HDQK, C::BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, v, B, S, KV, HDV, C::BK);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  // the serving instance (no lse) is the kernel as it was before training
  auto kernel = lse != nullptr ? tc::flash_fwd_wgmma_kernel<HDQK, HDV, true>
                               : tc::flash_fwd_wgmma_kernel<HDQK, HDV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (S + tc::kBQ - 1) / tc::kBQ;
  kernel<<<nq * B * H, tc::kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, scale,
      causal, window, softcap, lse);
  return static_cast<int>(cudaGetLastError());
}

// MLA's (96, 64) bf16 instance: q and k through a 64-column and a
// 32-column map each, the persistent grid one block an SM.
int launch_mla(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, float scale,
               int causal, int window, float softcap, cudaStream_t stream) {
  using C = tc::MlaCfg;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tqa, tqb, tka, tkb, tv;
  CUresult r = make_map(enc, &tqa, q, B, S, H, 96, C::BQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tqb, q, B, S, H, 96, C::BQ, 32);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tka, k, B, S, KV, 96, C::BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tkb, k, B, S, KV, 96, C::BK, 32);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, v, B, S, KV, 64, C::BK);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lse != nullptr ? tc::flash_fwd_mla_kernel<true>
                               : tc::flash_fwd_mla_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      static_cast<long long>((S + C::BQ - 1) / C::BQ) * B * H;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      tqa, tqb, tka, tkb, tv, static_cast<__nv_bfloat16*>(o), B, S, H, KV,
      scale, causal, window, softcap, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int HDQK, int HDV>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, float scale,
                int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = simt::smem_bytes<HDQK, HDV>();
  auto kernel = lse != nullptr ? simt::flash_fwd_kernel<float, HDQK, HDV, true>
                               : simt::flash_fwd_kernel<float, HDQK, HDV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + simt::kBQ - 1) / simt::kBQ, H, B);
  kernel<<<grid, simt::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, scale,
      causal, window, softcap, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int HDQK, int HDV>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int S, int H, int KV, float scale, int causal,
           int window, float softcap, cudaStream_t s) {
  if (dtype == 0)
    return launch_simt<HDQK, HDV>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                  window, softcap, s);
  if (dtype == 1)
    return launch_tc<HDQK, HDV>(q, k, v, o, lse, B, S, H, KV, scale, causal,
                                window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q: [B, S, H, hd]; k: [B, S, KV,
// hd]; v: [B, S, KV, hdv]; o: [B, S, H, hdv]; (hd, hdv) one of (64, 64),
// (128, 128), (256, 256) and MLA's (96, 64); all contiguous device
// pointers of one type (dtype 0:
// float32, the SIMT route; 1: bfloat16, the wgmma/TMA route), 16-byte
// aligned.  lse: null (serving), or float32 [B, H, S] that receives each
// row's natural log-sum-exp of its masked, softcapped scores, for the
// backward; the output is the same either way.  Launches on ``stream`` of ``device``, does not synchronise and
// allocates nothing.  Returns the CUDA error of the attribute call or of the
// launch (0 on success); cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled, cudaErrorInvalidValue when it refuses a map or
// there is no instance for (hd, hdv).  The caller checks shapes, H % KV ==
// 0, (hd, hdv) and the grid's size.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int S, int H, int KV, int hd,
                                      int hdv, int dtype, float scale,
                                      int causal, int window, float softcap,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (hd == 96 && hdv == 64) {
    if (dtype == 0)
      return launch_simt<96, 64>(q, k, v, o, lse, B, S, H, KV, scale, causal, window, softcap, s);
    if (dtype == 1)
      return launch_mla(q, k, v, o, lse, B, S, H, KV, scale, causal, window, softcap, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd != hdv) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch<64, 64>(dtype, q, k, v, o, lse, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch<128, 128>(dtype, q, k, v, o, lse, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch<256, 256>(dtype, q, k, v, o, lse, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
