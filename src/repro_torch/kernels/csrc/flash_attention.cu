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
// Rounding P to bf16 is a second rounding that the Pallas kernel, float32
// inside, does not make; it stays inside the bf16 tolerance of the tests.
// Tiles (BK keys a stage, NS stages; dynamic shared memory with 1 KB of
// alignment slack): hd 64 BK 128 NS 3, 113 KB; hd 128 BK 128 NS 2, 161 KB;
// hd 256 BK 64 NS 2, 193 KB.  ptxas: 168 registers at launch (40 for the
// producer, 232 for the consumers after setmaxnreg), no spills.
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(HD) * kBQ + 2 * HD * kBK +
                          kBK * kBQ);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KV, float scale, int causal, int window, float softcap) {
  constexpr int NC4 = HD / 64;  // float4 column groups of the output per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][64], q * scale
  float* Kt = Qt + HD * kBQ;                     // [HD][64]
  float* Vs = Kt + HD * kBK;                     // [64][HD]
  float* Pt = Vs + kBK * HD;                     // [64 keys][64 rows]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;   // rows tr*4 .. tr*4+3 of the q tile
  const int tc = tid & 15;   // score columns tc*4 ..; output columns g*64+tc*4 ..
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const T* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kh) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;

  stage_transposed<T, HD>(Qt, qb, q0, S, q_stride, scale);

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
    stage_transposed<T, HD>(Kt, kb, k0, S, kv_stride, 1.f);
    stage_rows<T, HD>(Vs, vb, k0, S, kv_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
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
        const float4 w = *reinterpret_cast<const float4*>(Vs + j * HD + g * 64 + tc * 4);
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
    T* orow = o + (static_cast<size_t>(b) * S + qi) * q_stride +
              static_cast<size_t>(h) * HD;
#pragma unroll
    for (int g = 0; g < NC4; ++g)
      store4(orow + g * 64 + tc * 4,
             make_float4(acc[i][g * 4 + 0] / den, acc[i][g * 4 + 1] / den,
                         acc[i][g * 4 + 2] / den, acc[i][g * 4 + 3] / den));
  }
}

}  // namespace simt

// ---------------------------------------------------------------- bfloat16

namespace tc {

constexpr int kBQ = 128;       // query rows per block: two warpgroups of 64
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;  // keys per stage
  static constexpr int NS = HD == 64 ? 3 : 2;      // stages of the K/V ring
  static constexpr int CHUNKS = HD / 64;           // 128-byte column chunks
  static constexpr int Q_BYTES = kBQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;     // one K or one V stage
  static constexpr int BAR_BYTES = 8 * (1 + 2 * NS);
  // 1024 bytes of slack: the swizzled tiles start on 1024-byte boundaries
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * NS * KV_BYTES + BAR_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase differs from ``parity``.  A wait of 10 s
// means a load that never lands: trap, so that the call fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// One box of a 4-D tensor map ({64 columns, 1 head, rows, 1 batch}) into
// shared memory, completing ``bytes`` on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled tile whose
// rows are 128 bytes: start address, leading and stride byte offsets (in
// 16-byte units), layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the registers of an accumulator in program order around the
// asynchronous wgmma, so that no read of them moves above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory, both
// K-major (B^T stored row by row), float32 accumulators.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory, both
// K-major (B^T stored row by row), float32 accumulators.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (four bf16x2 a
// thread), B in shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (four bf16x2 a
// thread), B in shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers (four bf16x2 a
// thread), B in shared memory MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block layout: thread 0 (warpgroup 0) loads, warpgroups 1 and 2 compute
// query rows q0 .. q0+63 and q0+64 .. q0+127.  In a consumer warpgroup,
// thread t (warp w = t / 32, lane l) holds rows ra = 16 w + l / 4 and
// ra + 8 of its 64; accumulator register 4 j + e of an m64nN product holds
// column 8 j + 2 (l % 4) + (e & 1) of row ra (e < 2) or ra + 8 (e >= 2).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int B, int S, int H,
                       int KV, float scale, int causal, int window,
                       float softcap) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, NS = C::NS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;             // NS stages
  const uint32_t sV = sK + NS * C::KV_BYTES;       // NS stages
  const uint32_t q_full = sV + NS * C::KV_BYTES;   // then full[NS], empty[NS]
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
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_load(sQ + c * kBQ * 128, &tq, q_full, c * 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * C::KV_BYTES);
        const int k0 = (t_lo + i) * BK;
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(sK + s * C::KV_BYTES + c * BK * 128, &tk, bar, c * 64, kh,
                   k0, b);
          tma_load(sV + s * C::KV_BYTES + c * BK * 128, &tv, bar, c * 64, kh,
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

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
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
        const uint32_t kst = sK + s * C::KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          const uint32_t off = (ks % 4) * 32;  // 16 columns of a chunk
          wgmma_ss(sc,
                   sw128_desc(sQw + (ks / 4) * kBQ * 128 + off, 16, 1024),
                   sw128_desc(kst + (ks / 4) * BK * 128 + off, 16, 1024), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
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
        for (int j = 0; j < HD / 2; ++j) acc[j] *= (j & 2) ? corr_b : corr_a;

        const uint32_t vst = sV + s * C::KV_BYTES;
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
        wgmma_wait_all();
        fence_regs(acc);
      }
      if (t == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: the quad's partial sums, then out = acc / max(l, 1e-30)
    const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
    const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
    const size_t q_stride = static_cast<size_t>(H) * HD;
    __nv_bfloat16* oa =
        o + (static_cast<size_t>(b) * S + qa) * q_stride + h * HD + col0;
    __nv_bfloat16* ob = oa + 8 * q_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (qa < S)
        *reinterpret_cast<uint32_t*>(oa + 8 * j) =
            pack_bf16(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (qb < S)
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            pack_bf16(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
  }
}

}  // namespace tc

// ------------------------------------------------------------------ launch

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 [B, S, heads, hd] tensor as a 4-D tensor map, innermost first;
// boxes of {64 columns (128 bytes), 1 head, rows, 1 batch}, 128-byte
// swizzle, out-of-range rows read as zero.
CUresult make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr,
                  int B, int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, float scale, int causal, int window,
              float softcap, cudaStream_t stream) {
  using C = tc::Cfg<HD>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, B, S, H, HD, tc::kBQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, k, B, S, KV, HD, C::BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, v, B, S, KV, HD, C::BK);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (S + tc::kBQ - 1) / tc::kBQ;
  tc::flash_fwd_wgmma_kernel<HD><<<nq * B * H, tc::kThreads, C::SMEM,
                                   stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, scale, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, float scale, int causal, int window,
                float softcap, cudaStream_t stream) {
  const size_t smem = simt::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      simt::flash_fwd_kernel<float, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + simt::kBQ - 1) / simt::kBQ, H, B);
  simt::flash_fwd_kernel<float, HD><<<grid, simt::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int S, int H, int KV, float scale, int causal, int window,
           float softcap, cudaStream_t s) {
  if (dtype == 0)
    return launch_simt<HD>(q, k, v, o, B, S, H, KV, scale, causal, window,
                           softcap, s);
  if (dtype == 1)
    return launch_tc<HD>(q, k, v, o, B, S, H, KV, scale, causal, window,
                         softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, o: [B, S, H, hd]; k, v:
// [B, S, KV, hd]; all contiguous device pointers of one type (dtype 0:
// float32, the SIMT route; 1: bfloat16, the wgmma/TMA route), 16-byte
// aligned.  Launches on ``stream`` of ``device``, does not synchronise and
// allocates nothing.  Returns the CUDA error of the attribute call or of the
// launch (0 on success); cudaErrorNotSupported when the driver has no
// cuTensorMapEncodeTiled, cudaErrorInvalidValue when it refuses a map.  The caller checks shapes, H % KV == 0, hd in
// {64, 128, 256} and the grid's size.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd, int dtype,
                                      float scale, int causal, int window,
                                      float softcap, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || S <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(dtype, q, k, v, o, B, S, H, KV, scale, causal, window, softcap, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, S, H, KV, scale, causal, window, softcap, s);
    case 256: return launch<256>(dtype, q, k, v, o, B, S, H, KV, scale, causal, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
