// Block-wise symmetric int4 pack and unpack for Hopper (sm_90a), float32,
// over a batch of rows.
//
// Replaces the TPU kernels src/repro/kernels/quant4.py::_pack_kernel and
// ::_unpack_kernel (wrappers quant4_pack_pallas / quant4_unpack_pallas), the
// wire format of the DiLoCoX compressor, and the JAX package's jax.vmap of
// them over a leaf's matrices (repro/core/mesh_compression.py): one launch
// covers B rows of n values, each row padded to whole blocks on its own.
//
//   pack:   per block of `block` values of a row (zero padded past n):
//           scale = amax * f32(1/7), 1.0 where that is 0;
//           code = clamp(round_half_even(x / scale), -8, 7); two codes per
//           byte, the even index in the low nibble.
//   unpack: sign-extend each nibble, times its block's scale; n outputs a
//           row.
//
// Numerics are those of the jitted JAX reference (kernels/ref.py), in
// quant4_codes.cuh: XLA turns `amax / 7.0` into a multiply by f32(1/7), so
// the scale multiplies; the codes divide with an IEEE division (no
// --use_fast_math) and round with rintf (half to even, as jnp.round).
// Bytes are bit-identical.
//
// Rows: row k of an operand starts (k / R) * s0 + (k % R) * s1 elements
// past its base (64-bit offsets; B <= 65,535, the grid's y). R = B is one
// row stride (the rows of a (B, m, r) tensor); R < B also takes a gathered
// wire buffer, whose rows lie a constant stride apart inside each rank's
// chunk and a chunk apart across ranks.
//
// Bound on this card: memory. Pack reads 4 bytes and writes half a byte
// per value (plus 4 bytes of scale per block); unpack the reverse. A few
// flops per value, far below the f32 rate.
//
// Design: the grid's y is the row (so a row's offsets take one 32-bit
// division a thread, once), its x the row's blocks; one warp per
// quantization block, 8 warps per 256-thread block. In a 256-value
// segment lane l owns two quads, values 4l..4l+3 and 128+4l..128+4l+3, so
// that each 16-byte access of a warp covers 512 contiguous bytes (whole
// sectors): pack loads the quads as two 16-byte loads, keeps them in
// registers, takes the block's absmax with shuffles, codes them and stores
// two 16-bit halves (bytes 2l, 2l+1 and 64+2l, 64+2l+1); unpack loads the
// halves and stores two 16-byte vectors. A quad that is not whole (the
// ragged tail, a block that is not a multiple of 4) or not aligned (a row
// that starts off a 16-byte boundary) takes scalar loads and stores of the
// same values, so both paths give the same bits. Blocks of more than 256
// values (WIDE) loop over segments; the pack then reads each segment twice
// (absmax, then codes).
//
// Why one block a warp: 64 resident warps an SM with 1 KB each in flight
// already cover HBM's latency (3.35 TB/s x ~1 us over 132 SMs is ~25 KB
// an SM), while 4 blocks a warp made each warp's chain of loads, shuffles
// and divisions 4 times as long, which the many launches of a few blocks
// pay in full (PERF.md: 4 blocks a warp were slower on every set of
// launches but the mesh round's unpacks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant4_codes.cuh"

#define WARPS_PER_BLOCK 8
#define SEG 256                     // values a warp covers at once
#define QUAD 128                    // offset of a lane's second quad

struct Rows {
  long long s0, s1;                 // elements: across and within groups
};

struct Batch {
  long long n, nblk;                // values a row, blocks a row
  int R, block;                     // rows a group, values a block
};

// Row blockIdx.y's first element of an operand.
__device__ __forceinline__ long long row_at(int R, Rows r) {
  const int k = blockIdx.y, g = k / R;
  return g * r.s0 + (long long)(k - g * R) * r.s1;
}

// The values of a quad that lie in the block, given its first value `at`
// inside the block.
__device__ __forceinline__ int quad_values(int block, int at) {
  return min(max(block - at, 0), 4);
}

// Loads a quad of values starting at row[e] (0 past n or past the block).
__device__ __forceinline__ void load4(const float* __restrict__ row,
                                      long long e, long long n, int nv,
                                      float* v) {
  const float* p = row + e;
  if (nv == 4 && e + 4 <= n && ((uintptr_t)p & 15) == 0) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (k < nv && e + k < n) ? p[k] : 0.f;
  }
}

__device__ __forceinline__ float warp_amax(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// The quad's 4 codes as 16 bits, value 0 in the low nibble.
__device__ __forceinline__ uint32_t code_quad(const float* v, float scale) {
  return code4(v[0], scale) | (code4(v[1], scale) << 4)
         | (code4(v[2], scale) << 8) | (code4(v[3], scale) << 12);
}

// Stores a quad's nv / 2 code bytes (one 16-bit store when both are there
// and the address is 2-byte aligned).
__device__ __forceinline__ void store_quad(uint8_t* p, uint32_t h, int nv) {
  if (nv == 4 && ((uintptr_t)p & 1) == 0) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)h;
  } else {
    for (int j = 0; j < nv / 2; ++j) p[j] = (uint8_t)(h >> (8 * j));
  }
}

__device__ __forceinline__ uint32_t load_quad(const uint8_t* p, int nv) {
  if (nv == 4 && ((uintptr_t)p & 1) == 0)
    return *reinterpret_cast<const uint16_t*>(p);
  uint32_t h = 0;
  for (int j = 0; j < nv / 2; ++j) h |= (uint32_t)p[j] << (8 * j);
  return h;
}

// One quantization block a warp. A block of at most SEG values is loaded
// once and kept in registers; a WIDE block loops over its segments twice,
// for the absmax and then for the codes (the second pass from L1/L2).
template <bool WIDE>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
quant4_pack_kernel(const float* __restrict__ x, Rows xr,
                   uint8_t* __restrict__ packed, Rows pr,
                   float* __restrict__ scales, Rows sr, Batch bt) {
  const long long blk =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (blk >= bt.nblk) return;
  const int lane = threadIdx.x & 31;
  const float* xblk = x + row_at(bt.R, xr) + blk * bt.block;
  const long long n = bt.n - blk * bt.block;   // the row's values from here
  float v[8];
  float amax = 0.f;
  for (int s = 0; s < (WIDE ? bt.block : 1); s += SEG) {
    load4(xblk, s + 4 * lane, n, quad_values(bt.block, s + 4 * lane), v);
    load4(xblk, s + QUAD + 4 * lane, n,
          quad_values(bt.block, s + QUAD + 4 * lane), v + 4);
#pragma unroll
    for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
  }
  const float scale = block_scale(warp_amax(amax));
  uint8_t* pblk = packed + row_at(bt.R, pr) + blk * (bt.block / 2);
  for (int s = 0; s < (WIDE ? bt.block : 1); s += SEG) {
    const int nv0 = quad_values(bt.block, s + 4 * lane);
    const int nv1 = quad_values(bt.block, s + QUAD + 4 * lane);
    if (WIDE) {
      load4(xblk, s + 4 * lane, n, nv0, v);
      load4(xblk, s + QUAD + 4 * lane, n, nv1, v + 4);
    }
    store_quad(pblk + s / 2 + 2 * lane, code_quad(v, scale), nv0);
    store_quad(pblk + (s + QUAD) / 2 + 2 * lane, code_quad(v + 4, scale),
               nv1);
  }
  if (lane == 0) scales[row_at(bt.R, sr) + blk] = scale;
}

// Decodes a quad and stores its values that lie below n.
__device__ __forceinline__ void store_values(float* o, long long e,
                                             long long n, int nv,
                                             uint32_t h, float scale) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = decode4(h >> (4 * k), scale);
  if (nv == 4 && e + 4 <= n && ((uintptr_t)(o + e) & 15) == 0) {
    *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < nv && e + k < n; ++k) o[e + k] = v[k];
  }
}

// One quantization block a warp; a WIDE block loops over its segments.
template <bool WIDE>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
quant4_unpack_kernel(const uint8_t* __restrict__ packed, Rows pr,
                     const float* __restrict__ scales, Rows sr,
                     float* __restrict__ out, Rows orr, Batch bt) {
  const long long blk =
      (long long)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (blk >= bt.nblk) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* pblk = packed + row_at(bt.R, pr) + blk * (bt.block / 2);
  const float scale = scales[row_at(bt.R, sr) + blk];
  float* oblk = out + row_at(bt.R, orr) + blk * bt.block;
  const long long n = bt.n - blk * bt.block;   // the row's values from here
  for (int s = 0; s < (WIDE ? bt.block : 1); s += SEG) {
    const int nv0 = quad_values(bt.block, s + 4 * lane);
    const int nv1 = quad_values(bt.block, s + QUAD + 4 * lane);
    const uint32_t h0 = load_quad(pblk + s / 2 + 2 * lane, nv0);
    const uint32_t h1 = load_quad(pblk + (s + QUAD) / 2 + 2 * lane, nv1);
    store_values(oblk, s + 4 * lane, n, nv0, h0, scale);
    store_values(oblk, s + QUAD + 4 * lane, n, nv1, h1, scale);
  }
}

// ceil(nblk / 8) x B: a warp a block, a grid row a batch row.
static inline dim3 grid_for(long long nblk, long long B) {
  return dim3((unsigned)((nblk + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK),
              (unsigned)B);
}

extern "C" int quant4_pack_f32(const void* x, long long xs0, long long xs1,
                               void* packed, long long ps0, long long ps1,
                               void* scales, long long ss0, long long ss1,
                               long long B, long long R, long long n,
                               int block, void* stream) {
  const long long nblk = (n + block - 1) / block;
  if (B * nblk == 0) return 0;
  const Batch bt{n, nblk, (int)R, block};
  const Rows xr{xs0, xs1}, pr{ps0, ps1}, sr{ss0, ss1};
  auto* kernel = block <= SEG ? quant4_pack_kernel<false>
                              : quant4_pack_kernel<true>;
  kernel<<<grid_for(nblk, B), WARPS_PER_BLOCK * 32, 0,
           (cudaStream_t)stream>>>((const float*)x, xr, (uint8_t*)packed, pr,
                                   (float*)scales, sr, bt);
  return (int)cudaGetLastError();
}

extern "C" int quant4_unpack_f32(const void* packed, long long ps0,
                                 long long ps1, const void* scales,
                                 long long ss0, long long ss1, void* out,
                                 long long os0, long long os1, long long B,
                                 long long R, long long n, int block,
                                 void* stream) {
  const long long nblk = (n + block - 1) / block;
  if (B * nblk == 0) return 0;
  const Batch bt{n, nblk, (int)R, block};
  const Rows pr{ps0, ps1}, sr{ss0, ss1}, orr{os0, os1};
  auto* kernel = block <= SEG ? quant4_unpack_kernel<false>
                              : quant4_unpack_kernel<true>;
  kernel<<<grid_for(nblk, B), WARPS_PER_BLOCK * 32, 0,
           (cudaStream_t)stream>>>((const uint8_t*)packed, pr,
                                   (const float*)scales, sr, (float*)out, orr,
                                   bt);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
