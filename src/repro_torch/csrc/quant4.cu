// Block-wise symmetric int4 pack and unpack for Hopper (sm_90a), float32.
//
// Replaces the TPU kernels src/repro/kernels/quant4.py::_pack_kernel and
// ::_unpack_kernel (wrappers quant4_pack_pallas / quant4_unpack_pallas), the
// wire format of the DiLoCoX compressor:
//
//   pack:   per block of `block` elements of the flat input (zero padded
//           past n): scale = amax * f32(1/7), 1.0 where that is 0;
//           code = clamp(round_half_even(x / scale), -8, 7); two codes per
//           byte, the even index in the low nibble.
//   unpack: sign-extend each nibble, times its block's scale; n outputs.
//
// Numerics are those of the jitted JAX reference (kernels/ref.py), in
// quant4_codes.cuh: XLA turns `amax / 7.0` into a multiply by f32(1/7), so
// the scale multiplies; the codes divide with an IEEE division (no
// --use_fast_math) and round with rintf (half to even, as jnp.round).
// Bytes are bit-identical.
//
// Bound on this card: memory. Pack reads 4 bytes and writes half a byte
// per element (plus 4 bytes of scale per block); unpack the reverse. A few
// flops per element, far below the f32 rate.
//
// Design: one warp per quantization block, 8 warps per 256-thread block.
// Each lane walks the block's (even, odd) pairs with a stride of 32 pairs,
// so neighbouring lanes touch neighbouring 8-byte pairs. Pass 1 takes the
// absolute max with a shuffle reduction; pass 2 re-reads the pairs (from L1)
// and writes one byte per pair.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant4_codes.cuh"

#define WARPS_PER_BLOCK 8

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
quant4_pack_kernel(const float* __restrict__ x, long long n, int block,
                   long long nblk, uint8_t* __restrict__ packed,
                   float* __restrict__ scales) {
  const long long b = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= nblk) return;
  const int lane = threadIdx.x & 31;
  const long long base = b * block;
  const int half = block >> 1;
  float amax = 0.f;
  for (int j = lane; j < half; j += 32) {
    const long long i = base + 2 * j;
    const float x0 = i < n ? x[i] : 0.f;
    const float x1 = i + 1 < n ? x[i + 1] : 0.f;
    amax = fmaxf(amax, fmaxf(fabsf(x0), fabsf(x1)));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = block_scale(amax);
  for (int j = lane; j < half; j += 32) {
    const long long i = base + 2 * j;
    const float x0 = i < n ? x[i] : 0.f;
    const float x1 = i + 1 < n ? x[i + 1] : 0.f;
    packed[b * half + j] = (uint8_t)(code4(x0, scale) | (code4(x1, scale) << 4));
  }
  if (lane == 0) scales[b] = scale;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
quant4_unpack_kernel(const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, long long n, int block,
                     long long nblk, float* __restrict__ out) {
  const long long b = (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (b >= nblk) return;
  const int lane = threadIdx.x & 31;
  const int half = block >> 1;
  const float scale = scales[b];
  for (int j = lane; j < half; j += 32) {
    const uint32_t byte = packed[b * half + j];
    const long long i = b * block + 2 * j;
    if (i < n) out[i] = decode4(byte, scale);
    if (i + 1 < n) out[i + 1] = decode4(byte >> 4, scale);
  }
}

static inline unsigned grid_for(long long nblk) {
  return (unsigned)((nblk + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

extern "C" int quant4_pack_f32(const void* x, long long n, int block,
                               void* packed, void* scales, void* stream) {
  const long long nblk = (n + block - 1) / block;
  if (nblk == 0) return 0;
  quant4_pack_kernel<<<grid_for(nblk), WARPS_PER_BLOCK * 32, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, n, block, nblk, (uint8_t*)packed, (float*)scales);
  return (int)cudaGetLastError();
}

extern "C" int quant4_unpack_f32(const void* packed, const void* scales,
                                 long long n, int block, void* out,
                                 void* stream) {
  const long long nblk = (n + block - 1) / block;
  if (nblk == 0) return 0;
  quant4_unpack_kernel<<<grid_for(nblk), WARPS_PER_BLOCK * 32, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const float*)scales, n, block, nblk,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
