// The fused outer-step compressor for Hopper (sm_90a), float32: the kernels
// per (m, n) parameter matrix M = delta (+ e), rank r <= 64.
//
// Replaces the TPU kernels of src/repro/kernels/fused_compress.py:
//   _proj_kernel        P = (D + E) @ Qm          (m, r)
//     <- pgemm::proj_gemm_kernel<false, ...> (proj_gemm.cuh) over K = n in
//        S splits, then pgemm::split_sum_kernel (skipped when S = 1: the
//        GEMM writes P)
//   _proj_t_pack_kernel Q = (D + E)^T @ P         (n, r), and the int4 codes
//                       and scales of the flat row-major Q
//                       (quant4_pack_ref's layout)
//     <- pgemm::proj_gemm_kernel<true, ...> over K = m in S splits, then
//        t_pack_finish_kernel: the split sum, Q, and the pack
//   _recon_kernel       hat = deq(P) @ deq(Q)^T   (m, n) from the packed
//                       payload, and with EF e' = (D + E) - hat
//     <- decode_kernel (P and Q to f32 scratch, once), then
//        rgemm::rank_gemm_kernel (rank_gemm.cuh) with the EF epilogue
// The r x r Cholesky-QR of P runs between the first two on the host side,
// as in the JAX driver.
//
// Bound on this card: each projection streams the (m, n) matrix once
// (twice with E) and does 2*m*n*r flops; at r = 64 that is 32 flops per
// 4-byte element read, so the f32 rate (67 TFLOP/s on SIMT cores) bounds
// rather than HBM (3.35 TB/s); the reconstruction writes the (m, n) matrix
// once for the same flops. The products are f32 and held to f32 gates,
// so they stay on the SIMT cores: wgmma has no f32 operand kind, and TF32
// keeps about 10 mantissa bits. The two GEMMs and their design notes are
// in proj_gemm.cuh and rank_gemm.cuh, shared with lowrank_mm.cu.
//
// Rank mask: the wrapper passes Qm = Q_warm * mask and a P whose masked
// columns are exactly 0, so masked columns of Q (and their codes) are 0.
//
// Packing in t_pack_finish_kernel: a block owns `tile_rows` rows of Q,
// chosen by the wrapper so that tile_rows * r is a whole number of
// quantization blocks (tile_rows is a multiple of 64 and of
// block / gcd(r, block)); it sums their partials into shared memory and
// writes them to Q, then one warp per quantization block takes the absmax
// and packs two codes per byte with quant4.cu's rule (quant4_codes.cuh).
// Rows past n are zero, so the last quantization block is padded with
// zeros as the reference pads.
//
// The reconstruction decodes each factor once (decode_kernel, one warp per
// quantization block: one scale read, 8 codes per 32-bit word, 32-bit
// index math), quant4_unpack's arithmetic, so hat is bit for bit
// lowrank_mm(unpack(P), unpack(Q)^T), the mesh runtime's decompression.

#include <cuda_runtime.h>
#include <stdint.h>

#include "proj_gemm.cuh"
#include "quant4_codes.cuh"
#include "rank_gemm.cuh"

#define TILE 64
#define R_MAX 64
#define FINISH_THREADS 1024
#define DECODE_WARPS 8

using pgemm::split_sum1;
using pgemm::split_sum4;

// ---------------------------------------------------------------------------
// t_pack's second pass: the split sum of `tile_rows` rows of Q into shared
// memory and Q, then the int4 pack of the tile's flat values. ws may be q
// itself (S = 1): each element is read, then written, by one thread.
// ---------------------------------------------------------------------------

// one block per SM: without it ptxas holds 1024 threads to 32 registers
__global__ void __launch_bounds__(FINISH_THREADS, 1)
t_pack_finish_kernel(const float* ws, float* q,
                     uint8_t* __restrict__ packed, float* __restrict__ scales,
                     int n, int r, int splits, long long split_stride,
                     int tile_rows, int block, long long nblk_total) {
  extern __shared__ __align__(16) float qtile[];  // (tile_rows, r): flat Q
  const int tid = threadIdx.x;
  const long long total = (long long)n * r;
  const long long base = (long long)blockIdx.x * tile_rows * r;
  const int elems = tile_rows * r;                 // a multiple of 4
  for (int x = 4 * tid; x < elems; x += 4 * FINISH_THREADS) {
    const long long g = base + x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g + 4 <= total) {
      v = split_sum4(ws, g, splits, split_stride);
      *reinterpret_cast<float4*>(q + g) = v;
    } else {
      float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (g + t < total) {
          w[t] = split_sum1(ws, g + t, splits, split_stride);
          q[g + t] = w[t];
        }
      }
      v = make_float4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<float4*>(qtile + x) = v;
  }
  __syncthreads();

  // pack the tile's flat (tile_rows * r) values: one warp per quant block
  const int warp = tid >> 5, lane = tid & 31;
  const int nblk_tile = elems / block;
  const int half = block >> 1;
  for (int bl = warp; bl < nblk_tile; bl += FINISH_THREADS / 32) {
    const long long gb = (long long)blockIdx.x * nblk_tile + bl;
    if (gb >= nblk_total) break;
    const float* x = qtile + (long long)bl * block;
    float amax = 0.f;
    for (int j = lane; j < half; j += 32)
      amax = fmaxf(amax, fmaxf(fabsf(x[2 * j]), fabsf(x[2 * j + 1])));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = block_scale(amax);
    for (int j = lane; j < half; j += 32)
      packed[gb * half + j] =
          (uint8_t)(code4(x[2 * j], scale) | (code4(x[2 * j + 1], scale) << 4));
    if (lane == 0) scales[gb] = scale;
  }
}

// ---------------------------------------------------------------------------
// the reconstruction's first pass: out[f] = decode4(code f, scale of f's
// block) for f < n_out, one warp per quantization block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DECODE_WARPS * 32)
decode_kernel(const uint8_t* __restrict__ packed,
              const float* __restrict__ scales, int n_out, int block,
              int nblk, bool words, float* __restrict__ out) {
  const int b = blockIdx.x * DECODE_WARPS + (threadIdx.x >> 5);
  if (b >= nblk) return;
  const int lane = threadIdx.x & 31;
  const int half = block >> 1;
  const float scale = scales[b];
  const uint8_t* p = packed + b * half;
  const int base = b * block;
  if (words) {
    // block % 8 == 0 and 4-byte aligned codes: a 32-bit word holds 8 codes,
    // two float4 of output
    for (int w = lane; w < half / 4; w += 32) {
      const uint32_t x = reinterpret_cast<const uint32_t*>(p)[w];
      const int f = base + 8 * w;
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = decode4(x >> (4 * t), scale);
      if (f + 8 <= n_out) {
        reinterpret_cast<float4*>(out + f)[0] =
            make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(out + f)[1] =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int t = 0; t < 8 && f + t < n_out; ++t) out[f + t] = v[t];
      }
    }
  } else {
    for (int j = lane; j < half; j += 32) {
      const uint32_t x = p[j];
      const int f = base + 2 * j;
      if (f < n_out) out[f] = decode4(x, scale);
      if (f + 1 < n_out) out[f + 1] = decode4(x >> 4, scale);
    }
  }
}

static int launch_decode(const void* packed, const void* scales, int n_out,
                         int block, float* out, cudaStream_t stream) {
  const int nblk = (n_out + block - 1) / block;
  const bool words = block % 8 == 0 && ((uintptr_t)packed & 3) == 0 &&
                     ((uintptr_t)out & 15) == 0;
  decode_kernel<<<(nblk + DECODE_WARPS - 1) / DECODE_WARPS, DECODE_WARPS * 32,
                  0, stream>>>((const uint8_t*)packed, (const float*)scales,
                               n_out, block, nblk, words, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C entry points: launch on the caller's stream, return cudaGetLastError()
// ---------------------------------------------------------------------------

// P = (D + E) @ Qm; ws holds splits x ceil4(m r) floats (unused at S = 1)
extern "C" int fused_project_f32(const void* d, const void* e, const void* qm,
                                 void* p, void* ws, int m, int n, int r,
                                 int splits, int chunk, void* stream) {
  if (r < 1 || r > R_MAX || !pgemm::split_plan_ok(n, splits, chunk) ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* out = splits == 1 ? (float*)p : (float*)ws;
  int err = pgemm::launch_proj_gemm<false>(
      (const float*)d, (const float*)e, (const float*)qm, out, 1, m, n, n, r,
      splits, chunk, 0, 0, s);
  if (err != 0 || splits == 1) return err;
  return pgemm::launch_split_sum((const float*)ws, (float*)p,
                                 (long long)m * r, splits, s);
}

// Q = (D + E)^T @ P and its int4 pack; ws holds splits x ceil4(n r) floats,
// or is q itself at S = 1
extern "C" int fused_project_t_pack_f32(const void* d, const void* e,
                                        const void* p, void* q, void* ws,
                                        void* packed, void* scales, int m,
                                        int n, int r, int splits, int chunk,
                                        int tile_rows, int block,
                                        void* stream) {
  if (r < 1 || r > R_MAX || tile_rows <= 0 || tile_rows % TILE ||
      block <= 0 || block % 2 || (tile_rows * r) % block ||
      !pgemm::split_plan_ok(m, splits, chunk) || !ws)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = pgemm::launch_proj_gemm<true>(
      (const float*)d, (const float*)e, (const float*)p, (float*)ws, 1, n, m,
      n, r, splits, chunk, 0, 0, s);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * (size_t)tile_rows * r;
  if (smem > 48 * 1024) {
    cudaError_t attr = cudaFuncSetAttribute(
        t_pack_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const long long nblk_total = ((long long)n * r + block - 1) / block;
  t_pack_finish_kernel<<<(unsigned)((n + tile_rows - 1) / tile_rows),
                         FINISH_THREADS, smem, s>>>(
      (const float*)ws, (float*)q, (uint8_t*)packed, (float*)scales, n, r,
      splits, pgemm::split_stride((long long)n * r), tile_rows, block,
      nblk_total);
  return (int)cudaGetLastError();
}

// hat = deq(P) @ deq(Q)^T and, with enew, e' = D (+ E) - hat. pf, qf:
// (m, r) and (n, r) f32 scratch for the decoded factors; (m + n) r must
// fit in an int (the wrapper checks)
extern "C" int fused_reconstruct_f32(const void* pp, const void* sp,
                                     const void* pq, const void* sq,
                                     const void* d, const void* e, void* hat,
                                     void* enew, void* pf, void* qf, int m,
                                     int n, int r, int block, void* stream) {
  if (r < 1 || r > R_MAX || block <= 0 || block % 2 || (enew && !d))
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_decode(pp, sp, m * r, block, (float*)pf, s);
  if (err != 0) return err;
  err = launch_decode(pq, sq, n * r, block, (float*)qf, s);
  if (err != 0) return err;
  // A = P (m, r) row-major; B = Q^T: column j is row j of Q
  const rgemm::Operand a = {(const float*)pf, 0, r, 1};
  const rgemm::Operand b = {(const float*)qf, 0, r, 1};
  return rgemm::launch_rank_gemm(a, b, 1, m, n, r, (float*)hat,
                                 (const float*)d, (const float*)e,
                                 (float*)enew, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
