// The K-resident f32 GEMM of a rank-r product, shared by fused_compress.cu
// (the compressor's reconstruction deq(P) deq(Q)^T, with the EF residual)
// and lowrank_mm.cu (the mesh outer step's P Q^T, batched):
//
//   out[z] = A[z] @ B[z]      (m, K) @ (K, n), K <= 64
//
// Each operand is read through its element strides: A(i, k) at
// a.p[z a.s_b + i a.s_x + k a.s_k], B(k, j) at b.p[z b.s_b + j b.s_x +
// k b.s_k]. Both uses hand it k-contiguous rows (P row-major, Q^T a view
// of a row-major Q).
//
// Bound on this card: 2 K flops per 4-byte output element, 32 per byte at
// K = 64, so the f32 rate (67 TFLOP/s on SIMT cores) bounds, with HBM (3.35
// TB/s) close behind; with the EF epilogue (read d, write hat and e') HBM.
//
// Design: the whole K fits in shared memory, so there is no K loop over
// device memory and no second pass. An output tile is 128 x 128; 256
// threads each run an 8 x 8 register tile over k = 0 .. K-1 and store
// their outputs as float4.
//
// rank_gemm_kernel (B k-contiguous, K a multiple of 4: every use on the
// main path) is persistent: two blocks per SM, each owns a contiguous run
// of output tiles in (batch, row tile, column tile) order. It stages its
// 128 A rows once per row tile (k-major, As[k][i], through registers) and
// keeps them while it walks the columns; the next tile's 128 B rows move
// by 16-byte cp.async into the second half of a double buffer while the
// current tile is multiplied, so staging overlaps the FMAs and the
// previous tile's stores. B stays row-major in shared memory (Bs[j][k],
// the 16-byte chunk q of row j at chunk q ^ (j / 4 % 8), so a quarter warp
// reads eight distinct bank groups), and the FMA loop takes k four at a
// time: one float4 of B per column, then the four k in order.
// rank_gemm_simple_kernel (any other layout) stages both tiles per output
// tile, one float at a time.
//
// Sum order: each output element sums k = 0 .. K-1 in index order with fma
// from 0 in both kernels, the order of the kernels they replace
// (recon_kernel, and lowrank_mm's mm_kernel and proj_gemm_kernel at
// S = 1), so the bits depend neither on the operands' layout, nor on the
// batch, nor on which block computes a tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "proj_gemm.cuh"

namespace rgemm {

constexpr int BM = 128;            // output rows per tile
constexpr int BN = 128;            // output columns per tile
constexpr int KMAX = 64;
constexpr int THREADS = 256;       // 16 x 16 threads, an 8 x 8 register tile each
constexpr int LDA = BM + 4;        // row stride of a staged A k row
constexpr int LDB = BN + 4;        // (simple kernel) row stride of a B k row
constexpr int BROW = KMAX;         // (persistent kernel) floats per B row
constexpr int SMEM_SIMPLE = KMAX * (LDA + LDB) * (int)sizeof(float);
constexpr int SMEM_PERSISTENT =
    (KMAX * LDA + 2 * BN * BROW) * (int)sizeof(float);
constexpr int BLOCKS_PER_SM = 2;   // 128 registers, 99,328 B of shared memory

// how an operand's tile is staged: float4 along k, or one float at a time
// with k or the row index fastest across threads
enum Stage { K_VEC = 0, K_FAST = 1, X_FAST = 2 };

struct Operand {
  const float* p;
  long long s_b, s_x, s_k;         // element strides: batch, row/column, k
};

// S[k][x] (row stride ld) = operand(x0 + x, k) for x < 128, k < K, zero
// past `extent`. K_VEC: float4 q of row x, a warp on 32 rows at one q, so
// the k-major stores hit 32 distinct banks; every load is in flight before
// the first store.
__device__ __forceinline__ void stage_kmajor(float* __restrict__ S, int ld,
                                             Operand o, long long z,
                                             long long x0, int extent, int K,
                                             int mode) {
  const float* p = o.p + z * o.s_b;
  const int tid = threadIdx.x;
  if (mode == K_VEC) {
    constexpr int SLOTS = 128 * KMAX / 4 / THREADS;
    const int nq = K >> 2;
    float4 v[SLOTS];
#pragma unroll
    for (int l = 0; l < SLOTS; ++l) {
      const int c = tid + THREADS * l;
      const int x = c & 127, q = c >> 7;
      v[l] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < nq && x0 + x < extent)
        v[l] = __ldg(reinterpret_cast<const float4*>(p + (x0 + x) * o.s_x +
                                                     4 * q));
    }
#pragma unroll
    for (int l = 0; l < SLOTS; ++l) {
      const int c = tid + THREADS * l;
      const int x = c & 127, q = c >> 7;
      if (q < nq) {
        S[(4 * q) * ld + x] = v[l].x;
        S[(4 * q + 1) * ld + x] = v[l].y;
        S[(4 * q + 2) * ld + x] = v[l].z;
        S[(4 * q + 3) * ld + x] = v[l].w;
      }
    }
  } else {
    for (int c = tid; c < 128 * K; c += THREADS) {
      const int x = mode == K_FAST ? c / K : c & 127;
      const int k = mode == K_FAST ? c - x * K : c >> 7;
      S[k * ld + x] = x0 + x < extent
                          ? __ldg(p + (x0 + x) * o.s_x + k * o.s_k)
                          : 0.f;
    }
  }
}

// Bs[j][chunk q ^ (j / 4 % 8)] = B(j0 + j, 4q .. 4q + 3) by 16-byte
// cp.async, zeros past n; a warp copies two rows' 256 contiguous bytes
__device__ __forceinline__ void prefetch_b(float* __restrict__ Bs, Operand o,
                                           long long z, long long j0, int n,
                                           int nq) {
  const float* p = o.p + z * o.s_b;
#pragma unroll
  for (int l = 0; l < BN * (KMAX / 4) / THREADS; ++l) {
    const int c = threadIdx.x + THREADS * l;
    const int q = c & 15, j = c >> 4;
    if (q < nq) {
      const bool ok = j0 + j < n;
      cp_async16(Bs + j * BROW + 4 * (q ^ ((j >> 2) & 7)),
                 p + (ok ? (j0 + j) * o.s_x + 4 * q : 0), ok);
    }
  }
}

// the epilogue of one tile: out = acc, and with EF enew = d (+ e) - acc.
// Thread (ty, tx) owns rows 4ty + {0..3}, 64 + 4ty + {0..3} and columns
// 4tx + {0..3}, 64 + 4tx + {0..3}. VEC_OUT: n a multiple of 4 and every
// output-side pointer 16-byte aligned, so rows move as float4.
template <bool EF, bool VEC_OUT>
__device__ __forceinline__ void store_tile(
    const float (&acc)[8][8], float* __restrict__ out, long long i0,
    long long j0, int m, int n, int ty, int tx, const float* __restrict__ d,
    const float* __restrict__ e, float* __restrict__ enew) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = i0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = j0 + h * (BN / 2) + 4 * tx;
      const long long off = row * n + col;
      if (VEC_OUT && col < n) {
        const float4 o = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                     acc[i][4 * h + 2], acc[i][4 * h + 3]);
        *reinterpret_cast<float4*>(out + off) = o;
        if (EF) {
          float4 x = __ldg(reinterpret_cast<const float4*>(d + off));
          if (e) {
            const float4 y = __ldg(reinterpret_cast<const float4*>(e + off));
            x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
          }
          *reinterpret_cast<float4*>(enew + off) =
              make_float4(x.x - o.x, x.y - o.y, x.z - o.z, x.w - o.w);
        }
      } else if (!VEC_OUT) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (col + t < n) {
            const float v = acc[i][4 * h + t];
            out[off + t] = v;
            if (EF) {
              float x = d[off + t];
              if (e) x += e[off + t];
              enew[off + t] = x - v;
            }
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// EF = false: out[z] = A[z] @ B[z]. EF = true (batch 1): out = hat, and
// enew = d (+ e) - hat, the same (m, n) row-major layout. B is K_VEC.
// Tiles u in [tiles * blockIdx.x / gridDim.x, tiles * (blockIdx.x + 1) /
// gridDim.x), u = (z * row_tiles + row tile) * col_tiles + column tile.
template <bool EF, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
rank_gemm_kernel(Operand a, Operand b, int m, int n, int K, int a_mode,
                 float* __restrict__ out, long long so_b, int tiles,
                 const float* __restrict__ d, const float* __restrict__ e,
                 float* __restrict__ enew) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + KMAX * LDA;               // two buffers of BN x BROW
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nq = K >> 2;
  const int col_tiles = (n + BN - 1) / BN;
  const int row_tiles = (m + BM - 1) / BM;
  int u = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int u_end = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  if (u >= u_end) return;
  int rz = u / col_tiles;                       // z * row_tiles + row tile
  stage_kmajor(As, LDA, a, rz / row_tiles, (long long)(rz % row_tiles) * BM,
               m, K, a_mode);
  prefetch_b(Bs, b, rz / row_tiles, (long long)(u % col_tiles) * BN, n, nq);
  cp_async_commit();
  // this thread's B chunks: columns 4tx + c and 64 + 4tx + c share the
  // swizzle tx % 8
  const int swz = tx & 7;
  for (int cur = 0; u < u_end; ++u, cur ^= 1) {
    const int rz_next = (u + 1) / col_tiles;
    if (u + 1 < u_end)
      prefetch_b(Bs + (cur ^ 1) * BN * BROW, b, rz_next / row_tiles,
                 (long long)((u + 1) % col_tiles) * BN, n, nq);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const float* Bc = Bs + cur * BN * BROW;
    float acc[8][8];
    zero_acc(acc);
    for (int q = 0; q < nq; ++q) {
      float4 bq[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = (c < 4 ? 4 * tx + c : BN / 2 + 4 * tx + c - 4);
        bq[c] = *reinterpret_cast<const float4*>(Bc + j * BROW +
                                                 4 * (q ^ swz));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * q + kk;
        const float4 a0 =
            *reinterpret_cast<const float4*>(As + k * LDA + 4 * ty);
        const float4 a1 =
            *reinterpret_cast<const float4*>(As + k * LDA + BM / 2 + 4 * ty);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          bv[c] = kk == 0 ? bq[c].x
                          : kk == 1 ? bq[c].y : kk == 2 ? bq[c].z : bq[c].w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    store_tile<EF, VEC_OUT>(acc, out + (rz / row_tiles) * so_b,
                            (long long)(rz % row_tiles) * BM,
                            (long long)(u % col_tiles) * BN, m, n, ty, tx, d,
                            e, enew);
    __syncthreads();                 // As and Bs[cur] are free again
    if (u + 1 < u_end && rz_next != rz) {
      rz = rz_next;
      stage_kmajor(As, LDA, a, rz / row_tiles,
                   (long long)(rz % row_tiles) * BM, m, K, a_mode);
    }
  }
  cp_async_wait_all();
}

// any layout: one output tile per block, both tiles staged k-major
template <bool EF, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
rank_gemm_simple_kernel(Operand a, Operand b, int m, int n, int K,
                        int a_mode, int b_mode, float* __restrict__ out,
                        long long so_b, const float* __restrict__ d,
                        const float* __restrict__ e, float* __restrict__ enew) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + KMAX * LDA;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long z = blockIdx.z;
  const long long i0 = (long long)blockIdx.y * BM;
  const long long j0 = (long long)blockIdx.x * BN;
  stage_kmajor(As, LDA, a, z, i0, m, K, a_mode);
  stage_kmajor(Bs, LDB, b, z, j0, n, K, b_mode);
  __syncthreads();
  float acc[8][8];
  zero_acc(acc);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDA + 4 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * LDA + BM / 2 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LDB + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * LDB + BN / 2 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  store_tile<EF, VEC_OUT>(acc, out + z * so_b, i0, j0, m, n, ty, tx, d, e,
                          enew);
}

// the stage mode of an operand: float4 along k where its k stride is 1,
// K, its row stride and its batch stride are multiples of 4 and its
// pointer is 16-byte aligned; else k fastest where k is contiguous; else
// the row index fastest (contiguous columns, or any strides)
static inline int stage_mode(const Operand& o, int K) {
  if (o.s_k == 1 && K % 4 == 0 && o.s_x % 4 == 0 && o.s_b % 4 == 0 &&
      pgemm::aligned16(o.p))
    return K_VEC;
  return o.s_k == 1 ? K_FAST : X_FAST;
}

// the persistent kernel's blocks: two per SM of the current device
static inline int resident_blocks() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 132;
  return BLOCKS_PER_SM * sms;
}

// out (batch, m, n) contiguous = A @ B; with enew (batch 1): the EF
// epilogue. Launches on `stream`, returns cudaGetLastError().
static int launch_rank_gemm(Operand a, Operand b, int batch, int m, int n,
                            int K, float* out, const float* d, const float* e,
                            float* enew, cudaStream_t stream) {
  if (K < 1 || K > KMAX || batch < 1 || batch > 65535 ||
      (m + BM - 1) / BM > 65535 || (enew && (batch != 1 || !d)))
    return (int)cudaErrorInvalidValue;
  const long long so_b = (long long)m * n;
  using pgemm::aligned16;
  const bool vec = n % 4 == 0 && aligned16(out) && (!d || aligned16(d)) &&
                   (!e || aligned16(e)) && (!enew || aligned16(enew));
  const int am = stage_mode(a, K), bm = stage_mode(b, K);
  const long long tiles = (long long)batch * ((m + BM - 1) / BM) *
                          ((n + BN - 1) / BN);
  if (bm == K_VEC && tiles <= 0x7fffffff) {
    const unsigned grid =
        (unsigned)(tiles < resident_blocks() ? tiles : resident_blocks());
#define RANK_GEMM(EF, V)                                                     \
  do {                                                                       \
    cudaError_t attr = cudaFuncSetAttribute(                                 \
        rank_gemm_kernel<EF, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        SMEM_PERSISTENT);                                                    \
    if (attr != cudaSuccess) return (int)attr;                               \
    rank_gemm_kernel<EF, V><<<grid, THREADS, SMEM_PERSISTENT, stream>>>(     \
        a, b, m, n, K, am, out, so_b, (int)tiles, d, e, enew);               \
  } while (0)
    if (enew) {
      if (vec) RANK_GEMM(true, true);
      else RANK_GEMM(true, false);
    } else {
      if (vec) RANK_GEMM(false, true);
      else RANK_GEMM(false, false);
    }
#undef RANK_GEMM
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM),
                  (unsigned)batch);
#define RANK_GEMM(EF, V)                                                     \
  do {                                                                       \
    cudaError_t attr = cudaFuncSetAttribute(                                 \
        rank_gemm_simple_kernel<EF, V>,                                      \
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_SIMPLE);           \
    if (attr != cudaSuccess) return (int)attr;                               \
    rank_gemm_simple_kernel<EF, V><<<grid, THREADS, SMEM_SIMPLE, stream>>>(  \
        a, b, m, n, K, am, bm, out, so_b, d, e, enew);                       \
  } while (0)
  if (enew) {
    if (vec) RANK_GEMM(true, true);
    else RANK_GEMM(true, false);
  } else {
    if (vec) RANK_GEMM(false, true);
    else RANK_GEMM(false, false);
  }
#undef RANK_GEMM
  return (int)cudaGetLastError();
}

}  // namespace rgemm
