// The fused outer-step compressor for Hopper (sm_90a), float32: three
// kernels per (m, n) parameter matrix M = delta (+ e), rank r <= 64.
//
// Replaces the TPU kernels of src/repro/kernels/fused_compress.py:
//   proj_kernel        <- _proj_kernel        P = (D + E) @ Qm          (m, r)
//   proj_t_pack_kernel <- _proj_t_pack_kernel Q = (D + E)^T @ P         (n, r)
//                         and, in the same kernel, the int4 codes and scales
//                         of the flat row-major Q (quant4_pack_ref's layout)
//   recon_kernel       <- _recon_kernel       hat = deq(P) @ deq(Q)^T   (m, n)
//                         from the packed payload, and with EF
//                         e' = (D + E) - hat
// The r x r Cholesky-QR of P runs between the first two on the host side,
// as in the JAX driver.
//
// Bound on this card: each kernel streams the (m, n) matrix once (twice
// with E) and does 2*m*n*r flops; at r = 64, 32 flops per 4-byte element
// read, so the f32 rate (67 TFLOP/s on SIMT cores) bounds rather than
// HBM (3.35 TB/s). This first version is a shared-memory tiled SIMT GEMM:
// 64 x 64 output tiles, 256 threads with a 4 x 4 register tile each, K in
// steps of 32, the EF add done on the operand tile as it lands in shared
// memory (D + E never exists in device memory). wgmma/TMA are later work.
//
// Sums: every output element accumulates its K terms in index order with
// fma, so the reconstruction is within a few ulps of the unfused chain
// (the contract of tests/test_kernels.py bounds it by 16 eps |Pq||Qq|^T),
// and the forward recon and the decompress dual (same kernel, no EF)
// are bitwise equal.
//
// Rank mask: the wrapper passes Qm = Q_warm * mask and a P whose masked
// columns are exactly 0, so masked columns of Q (and their codes) are 0.
//
// Packing inside proj_t_pack_kernel: a block owns `tile_rows` rows of Q,
// chosen by the wrapper so that tile_rows * r is a whole number of
// quantization blocks (tile_rows is a multiple of 64 and of
// block / gcd(r, block)); it computes them 64 rows at a time into shared
// memory, then one warp per quantization block takes the absmax and packs
// two codes per byte with quant4.cu's rule (quant4_codes.cuh). Rows past n
// are zero, so the last quantization block is padded with zeros as the
// reference pads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant4_codes.cuh"

#define TILE 64
#define BK 32
#define N_THREADS 256
#define R_MAX 64

// ---------------------------------------------------------------------------
// shared: 64 x 64 register-tiled product over a K chunk held in shared memory
//   As[k][i] : operand rows of the output tile (k-major)
//   Bs[k][j] : operand columns of the output tile (k-major)
// thread (ty, tx) owns rows ty + 16*a and columns tx + 16*b, a, b in 0..3
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_chunk(const float (*As)[TILE + 1],
                                          const float (*Bs)[TILE], int kmax,
                                          int ty, int tx, float acc[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kmax; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// kernel 3: P = (D + E) @ Qm
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(N_THREADS)
proj_kernel(const float* __restrict__ d, const float* __restrict__ e,
            const float* __restrict__ qm, float* __restrict__ p,
            int m, int n, int r) {
  __shared__ float As[BK][TILE + 1];   // (D+E)[i0 + i, k0 + k] at As[k][i]
  __shared__ float Bs[BK][TILE];       // Qm[k0 + k, j] at Bs[k][j]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long i0 = (long long)blockIdx.x * TILE;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += BK) {
    // 64 rows x 32 columns of D (+E); 32 consecutive threads read a row
    for (int idx = tid; idx < TILE * BK; idx += N_THREADS) {
      const int i = idx / BK, k = idx % BK;
      const long long row = i0 + i;
      const int col = k0 + k;
      float v = 0.f;
      if (row < m && col < n) {
        const long long off = row * (long long)n + col;
        v = d[off];
        if (e) v += e[off];
      }
      As[k][i] = v;
    }
    for (int idx = tid; idx < BK * TILE; idx += N_THREADS) {
      const int k = idx / TILE, j = idx % TILE;
      const int row = k0 + k;
      Bs[k][j] = (row < n && j < r) ? qm[(long long)row * r + j] : 0.f;
    }
    __syncthreads();
    mma_chunk(As, Bs, min(BK, n - k0), ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = i0 + ty + 16 * a;
    if (row >= m) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = tx + 16 * b;
      if (col < r) p[row * r + col] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 4: Q = (D + E)^T @ P, with the int4 pack of Q in the same kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(N_THREADS)
proj_t_pack_kernel(const float* __restrict__ d, const float* __restrict__ e,
                   const float* __restrict__ p, float* __restrict__ q,
                   uint8_t* __restrict__ packed, float* __restrict__ scales,
                   int m, int n, int r, int tile_rows, int block,
                   long long nblk_total) {
  extern __shared__ float qtile[];     // (tile_rows, r) row-major: flat Q
  __shared__ float As[BK][TILE + 1];   // (D+E)[k0 + k, j0 + j] at As[k][j]
  __shared__ float Bs[BK][TILE];       // P[k0 + k, c] at Bs[k][c]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long t0 = (long long)blockIdx.x * tile_rows;   // first Q row

  for (int sub = 0; sub < tile_rows; sub += TILE) {
    const long long j0 = t0 + sub;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < m; k0 += BK) {
      // 32 rows x 64 columns of D (+E); 64 consecutive threads read a row
      for (int idx = tid; idx < BK * TILE; idx += N_THREADS) {
        const int k = idx / TILE, j = idx % TILE;
        const long long row = k0 + k;
        const long long col = j0 + j;
        float v = 0.f;
        if (row < m && col < n) {
          const long long off = row * (long long)n + col;
          v = d[off];
          if (e) v += e[off];
        }
        As[k][j] = v;
      }
      for (int idx = tid; idx < BK * TILE; idx += N_THREADS) {
        const int k = idx / TILE, c = idx % TILE;
        const long long row = k0 + k;
        Bs[k][c] = (row < m && c < r) ? p[row * r + c] : 0.f;
      }
      __syncthreads();
      mma_chunk(As, Bs, (int)min((long long)BK, (long long)m - k0), ty, tx,
                acc);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int lrow = sub + ty + 16 * a;
      const long long row = t0 + lrow;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx + 16 * b;
        if (col >= r) continue;
        const float v = row < n ? acc[a][b] : 0.f;
        qtile[lrow * r + col] = v;
        if (row < n) q[row * r + col] = v;
      }
    }
  }
  __syncthreads();

  // pack the tile's flat (tile_rows * r) values: one warp per quant block
  const int warp = tid >> 5, lane = tid & 31;
  const int nblk_tile = tile_rows * r / block;
  const int half = block >> 1;
  for (int bl = warp; bl < nblk_tile; bl += N_THREADS / 32) {
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
// kernel 5: hat = deq(P) @ deq(Q)^T from the payload; with EF e' = M - hat
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dequant(const uint8_t* __restrict__ packed,
                                         const float* __restrict__ scales,
                                         long long f, int block) {
  const uint32_t byte = packed[f >> 1];
  int c = (int)((f & 1) ? (byte >> 4) : (byte & 0xFu));
  c = c >= 8 ? c - 16 : c;
  return (float)c * scales[f / block];
}

__global__ void __launch_bounds__(N_THREADS)
recon_kernel(const uint8_t* __restrict__ pp, const float* __restrict__ sp,
             const uint8_t* __restrict__ pq, const float* __restrict__ sq,
             const float* __restrict__ d, const float* __restrict__ e,
             float* __restrict__ hat, float* __restrict__ enew,
             int m, int n, int r, int block) {
  __shared__ float As[R_MAX][TILE + 1];   // Pq[i0 + i, c] at As[c][i]
  __shared__ float Bs[R_MAX][TILE];       // Qq[j0 + j, c] at Bs[c][j]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long i0 = (long long)blockIdx.y * TILE;
  const long long j0 = (long long)blockIdx.x * TILE;
  for (int idx = tid; idx < TILE * r; idx += N_THREADS) {
    const int i = idx / r, c = idx % r;
    const long long row = i0 + i;
    As[c][i] = row < m ? dequant(pp, sp, row * r + c, block) : 0.f;
    const long long qrow = j0 + i;
    Bs[c][i] = qrow < n ? dequant(pq, sq, qrow * r + c, block) : 0.f;
  }
  __syncthreads();
  float acc[4][4] = {};
  mma_chunk(As, Bs, r, ty, tx, acc);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = i0 + ty + 16 * a;
    if (row >= m) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long col = j0 + tx + 16 * b;
      if (col >= n) continue;
      const long long off = row * (long long)n + col;
      hat[off] = acc[a][b];
      if (enew) {
        float v = d[off];
        if (e) v += e[off];
        enew[off] = v - acc[a][b];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C entry points: launch on the caller's stream, return cudaGetLastError()
// ---------------------------------------------------------------------------

extern "C" int fused_project_f32(const void* d, const void* e, const void* qm,
                                 void* p, int m, int n, int r, void* stream) {
  if (r > R_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((m + TILE - 1) / TILE));
  proj_kernel<<<grid, N_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)e, (const float*)qm, (float*)p, m, n, r);
  return (int)cudaGetLastError();
}

extern "C" int fused_project_t_pack_f32(const void* d, const void* e,
                                        const void* p, void* q, void* packed,
                                        void* scales, int m, int n, int r,
                                        int tile_rows, int block,
                                        void* stream) {
  if (r > R_MAX || tile_rows % TILE || (tile_rows * r) % block)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)tile_rows * r;
  const size_t smem_static = sizeof(float) * BK * (2 * TILE + 1);
  if (smem + smem_static > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        proj_t_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nblk_total = ((long long)n * r + block - 1) / block;
  dim3 grid((unsigned)((n + tile_rows - 1) / tile_rows));
  proj_t_pack_kernel<<<grid, N_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)e, (const float*)p, (float*)q,
      (uint8_t*)packed, (float*)scales, m, n, r, tile_rows, block,
      nblk_total);
  return (int)cudaGetLastError();
}

extern "C" int fused_reconstruct_f32(const void* pp, const void* sp,
                                     const void* pq, const void* sq,
                                     const void* d, const void* e, void* hat,
                                     void* enew, int m, int n, int r,
                                     int block, void* stream) {
  if (r > R_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + TILE - 1) / TILE), (unsigned)((m + TILE - 1) / TILE));
  recon_kernel<<<grid, N_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pp, (const float*)sp, (const uint8_t*)pq,
      (const float*)sq, (const float*)d, (const float*)e, (float*)hat,
      (float*)enew, m, n, r, block);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
