// TF32 tensor-core products with the 3xTF32 split, shared by the WKV6
// kernels (wkv6.cu, wkv6_bwd.cu): x = hi + lo, both TF32, and
// a.b = a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 sums on
// mma.sync.m16n8k8 (about float32 accuracy, where one TF32 product keeps
// about 3 digits); the fragment loaders of that shape; a 16-byte cp.async.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 22 bits, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of an m16n8k8 product from a row-major [16][ld] tile at p
// (rows g and g + 8, columns tg and tg + 4 of the 8 at column k0), split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void load(const float* p, int ld, int k0, int g,
                                       int tg) {
    split(p[g * ld + k0 + tg], hi[0], lo[0]);
    split(p[(g + 8) * ld + k0 + tg], hi[1], lo[1]);
    split(p[g * ld + k0 + tg + 4], hi[2], lo[2]);
    split(p[(g + 8) * ld + k0 + tg + 4], hi[3], lo[3]);
  }
};

// The TF32 parts of a B operand (rows tg and tg + 4 of an 8 x 8 tile).
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void load(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

}  // namespace
