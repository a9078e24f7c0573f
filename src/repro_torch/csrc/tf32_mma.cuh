// Float32-accurate matrix products on Hopper's tensor cores: TF32
// mma.sync.m16n8k8 run three times per product ("3xTF32").
//
// Each f32 operand x is split in registers into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds (add 0x1000 to the bits, keep the top 19). The
// product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, three mma
// into one f32 accumulator; the dropped a_lo b_lo is below 2^-22 |a b|.
// One pass (a_hi b_hi alone) keeps about 11 bits, which the f32 gates
// refuse. Shared memory holds plain f32: the split is made where a
// fragment is read.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4; (row, column)):
//   A (16 x 8): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (k t, n g)  b1 (k t + 4, n g)
//   C (16 x 8): c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// The order of k inside one mma is free. So a C fragment serves as the A
// fragment of a next product whose k runs over C's columns, with k slot t
// standing for column 2t and slot t + 4 for column 2t + 1:
// a = {c0, c2, c1, c3} (`split_c_as_a`), and that product reads its B rows
// 2t and 2t + 1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct FragA {                     // an A fragment, split
  uint32_t hi[4], lo[4];
};

struct FragB {                     // a B fragment, split
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA split_a(const float (&x)[4]) {
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], f.hi[i], f.lo[i]);
  return f;
}

// the A fragment {c0, c2, c1, c3} of a C fragment (see above)
__device__ __forceinline__ FragA split_c_as_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return split_a(a);
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// c += a b, one TF32 tensor-core product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in f32 accuracy: the small terms first, then hi hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// Four 8 x 4 f32 tiles from shared memory, one register each: lane l
// passes the address of row l % 8 of tile l / 8 (16-byte aligned) and gets
// row l / 4, column l % 4 of tile i in r[i], the (g, t) entry of a
// fragment (ldmatrix moves 8 x 8 b16 tiles, i.e. 8 x 4 of 32 bits).
__device__ __forceinline__ void ldsm_x4(float (&r)[4], const float* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  uint32_t x0, x1, x2, x3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
               : "r"(s)
               : "memory");
  r[0] = __uint_as_float(x0);
  r[1] = __uint_as_float(x1);
  r[2] = __uint_as_float(x2);
  r[3] = __uint_as_float(x3);
}
