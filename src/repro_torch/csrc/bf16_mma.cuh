// bf16 products on Hopper's tensor cores: mma.sync.m16n8k16 with bf16
// operands and an f32 accumulator, the bf16 twin of tf32_mma.cuh.
//
// A bf16 x bf16 product is exact in f32, so a product over bf16 inputs
// loses nothing but the f32 sum's rounding. Operands that are f32 (the
// softmax P and dS of flash attention, held as C fragments) are rounded to
// bf16, to nearest even, where they become A fragments (a relative error
// of at most 2^-8).
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4; (row, column); each
// 32-bit register holds two bf16, the lower column in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t + 8..)
//                a3 (g + 8, 2t + 8..)
//   B (16 x 8):  b0 (k 2t..2t+1, n g)  b1 (k 2t + 8.., n g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// So the C fragments of two neighbouring 8-column tiles, n and n + 1, are
// the A fragment of a next product whose k runs over those 16 columns:
// a = {c_n[0..1], c_n[2..3], c_{n+1}[0..1], c_{n+1}[2..3]} (`c_as_a`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// two floats as one register of two bf16 (x in the low half), rounded to
// nearest even
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b, one bf16 tensor-core product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16-column slice of C fragments, c0 the columns
// 0-7 and c1 8-15 (see above), rounded to bf16
__device__ __forceinline__ void c_as_a(const float (&c0)[4],
                                       const float (&c1)[4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Four 8 x 8 bf16 matrices from shared memory: lane l passes the address
// of row l % 8 of matrix l / 8 (16-byte aligned); r[i] gets row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i, or, transposed
// (`ldsm_x4_t`), column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
