// The int4 wire format's per-element rule, shared by every kernel that
// writes codes (quant4.cu's pack, fused_compress.cu's projection + pack) or
// reads them (quant4.cu's unpack, fused_compress.cu's reconstruction), so
// the packed bytes stay bit-identical to kernels/ref.py's quant4_pack_ref
// and the decoded values to quant4_unpack_ref:
//
//   scale = amax * f32(1/7), 1.0 where that is 0 (XLA's jitted form of
//           amax / 7: a multiply by the rounded reciprocal);
//   code  = clamp(round_half_even(x / scale), -8, 7) as a 4-bit two's
//           complement nibble (IEEE division, no --use_fast_math; rintf
//           rounds half to even, as jnp.round);
//   value = float(sign-extended code) * scale, one rounding.
#pragma once

#include <stdint.h>

__device__ __forceinline__ float block_scale(float amax) {
  const float s = amax * (1.0f / 7.0f);
  return s == 0.f ? 1.f : s;
}

__device__ __forceinline__ uint32_t code4(float x, float scale) {
  float q = rintf(x / scale);
  q = fminf(fmaxf(q, -8.f), 7.f);
  return ((uint32_t)(int)q) & 0xFu;
}

__device__ __forceinline__ float decode4(uint32_t nibble, float scale) {
  const int c = (int)(nibble & 0xFu);
  return (float)(c >= 8 ? c - 16 : c) * scale;
}
