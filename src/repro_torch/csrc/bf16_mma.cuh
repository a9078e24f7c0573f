// bf16 A fragments from f32 accumulators, for the bf16 flash kernels'
// register-A wgmma products (P V, P^T dO, dS^T Q, dS K; wgmma.cuh).
//
// A bf16 x bf16 product is exact in f32, so a product over bf16 inputs
// loses nothing but the f32 sum's rounding. Operands that are f32 (the
// softmax P and dS of flash attention, held as accumulators) are rounded
// to bf16, to nearest even, where they become A fragments (a relative
// error of at most 2^-8).
//
// A warp's 16 rows of a wgmma accumulator are laid out as mma.sync.
// m16n8k16's C fragments, and its register A operand as that mma's A
// fragment (g = lane / 4, t = lane % 4; (row, column); each 32-bit
// register holds two bf16, the lower column in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t + 8..)
//                a3 (g + 8, 2t + 8..)
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

// The A fragment of a 16-column slice of C fragments, c0 the columns
// 0-7 and c1 8-15 (see above), rounded to bf16
__device__ __forceinline__ void c_as_a(const float (&c0)[4],
                                       const float (&c1)[4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}
