// The split-K f32 GEMM of a narrow output, shared by fused_compress.cu (the
// compressor's projections P = (D + E) Qm and Q = (D + E)^T P) and
// lowrank_mm.cu (the mesh outer step's P = M Q and Q = M^T P, batched):
//
//   out[z][s] = A[z][:, chunk s] @ B[z][chunk s, :]      (rows, r <= 64)
//
// for the 128-row tile blockIdx.x, the K chunk s = blockIdx.y and the
// matrix z = blockIdx.z of a batch, where
//   KMAJOR = false:  A(i, k) = D[i * lda + k] (+E), k-contiguous rows
//   KMAJOR = true:   A(i, k) = D[k * lda + i] (+E), i-contiguous (D^T read
//                    through its strides: no copy)
// and B (K, r) row-major. VEC: r, lda and the batch strides multiples of 4,
// the A tile's float4 axis (K for !KMAJOR, rows for KMAJOR) a multiple of
// 4 and every pointer 16-byte aligned, so tiles move as float4; otherwise
// as floats. Each output element sums its chunk in index order with fma;
// the layout changes only how tiles move, never that order, so a view and
// its contiguous copy give the same bits.
//
// Bound on this card: at r = 64, 2 * 64 flops per 4-byte element of D, so
// the f32 rate (67 TFLOP/s on SIMT cores) bounds rather than HBM.
//
// Design: a block owns a 128 x 64 output tile, the whole factor width, and
// tiles only the long dimension. 128 threads each hold an 8 x 8 register
// tile (64 FMAs per four float4 shared-memory reads); K advances in steps
// of 16 through a two-stage ring in shared memory. The next K tile is in
// flight while this one is multiplied: a k-major A (KMAJOR) and B move by
// 16-byte cp.async straight into the ring; a k-minor A tile is loaded into
// registers before the FMAs and stored transposed after them. The EF
// operand e (WITH_E) is added on the operand tile, through registers.
//
// Split-K: the long dimension of a factor is often only 2,048 rows, i.e.
// 16 tiles for 132 SMs, while K runs to 98,304. The wrappers' plan
// (kernels/_plan.py::split_k, a function of (tiles, K) alone) cuts K into
// S chunks of `chunk` terms (a multiple of the K step; the last chunk ends
// at K) so that tiles x S blocks fill the card. Split s writes its partial
// to a workspace; split_sum_kernel adds the S partials in split order. No
// atomics: every output element is, bit for bit, the same function of its
// inputs in every call and in every batch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace pgemm {

constexpr int BM = 128;            // output rows per block
constexpr int BN = 64;             // output columns: all of r <= 64
constexpr int BK = 16;             // K step
constexpr int THREADS = 128;       // 16 x 8 threads, an 8 x 8 register tile each
constexpr int A_LD = BM + 4;       // row stride of the A tile in shared memory
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
//   As[k][i] (stride A_LD): A(row0 + i, k0 + k), k-major
//   Bs[k][c] (stride BN):   B(k0 + k, c), zero for c >= r
// thread (ty, tx) owns rows 4ty + {0..3}, 64 + 4ty + {0..3} and columns
// 4tx + {0..3}, 32 + 4tx + {0..3} of the tile
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fma_tile(const float* __restrict__ As,
                                         const float* __restrict__ Bs,
                                         int ty, int tx, float acc[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * A_LD + 4 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * A_LD + BM / 2 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * BN + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * BN + BN / 2 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <bool KMAJOR, bool WITH_E, bool VEC>
struct ProjTiles {
  // A moves by cp.async only where it is k-major and needs no add
  static constexpr bool ASYNC_A = KMAJOR && !WITH_E;

  const float* d;
  const float* e;
  const float* b;
  long long row0;
  int lda, rows, k_end, r;
  float st[16];                 // the next A tile, staged in registers

  // the A element (or float4) that slot l of this thread moves:
  // its tile coordinates (k, i) and whether it lies inside the matrix
  __device__ __forceinline__ void a_slot(int l, int tid, int k0, int& k,
                                         int& i, bool& ok) const {
    if (VEC && !KMAJOR) {
      // 128 rows x 4 float4 of k: a warp takes 16 rows, two float4 each,
      // so that the transposed stores below hit 32 distinct banks
      const int lane = tid & 31, q = lane & 3;
      const int g = (tid >> 5) + 4 * (l >> 1);
      i = 16 * g + (lane >> 2) + 8 * ((q >> 1) ^ (l & 1));
      k = 4 * q;
    } else if (VEC) {            // 16 rows of k x 32 float4 of i
      const int c = tid + THREADS * l;
      k = c >> 5;
      i = 4 * (c & 31);
    } else if (!KMAJOR) {        // 128 rows x 16 k, 16 threads per row
      const int c = tid + THREADS * l;
      k = c & 15;
      i = c >> 4;
    } else {                     // 16 rows of k x 128 i
      const int c = tid + THREADS * l;
      k = c >> 7;
      i = c & 127;
    }
    ok = k0 + k < k_end && row0 + i < rows;
  }

  __device__ __forceinline__ long long a_off(int k0, int k, int i) const {
    return KMAJOR ? (long long)(k0 + k) * lda + row0 + i
                  : (row0 + i) * lda + k0 + k;
  }

  // start the copies (and register loads) of the K tile at k0 into As, Bs
  __device__ __forceinline__ void load(int tid, int k0, float* As,
                                       float* Bs) {
    constexpr int A_SLOTS = VEC ? 4 : 16;
#pragma unroll
    for (int l = 0; l < A_SLOTS; ++l) {
      int k, i;
      bool ok;
      a_slot(l, tid, k0, k, i, ok);
      const long long off = ok ? a_off(k0, k, i) : 0;
      if (ASYNC_A) {
        if (VEC) cp_async16(As + k * A_LD + i, d + off, ok);
        else cp_async4(As + k * A_LD + i, d + off, ok);
      } else if (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
          v = __ldg(reinterpret_cast<const float4*>(d + off));
          if (WITH_E)
            v = add4(v, __ldg(reinterpret_cast<const float4*>(e + off)));
        }
        st[4 * l] = v.x;
        st[4 * l + 1] = v.y;
        st[4 * l + 2] = v.z;
        st[4 * l + 3] = v.w;
      } else {
        float v = 0.f;
        if (ok) {
          v = __ldg(d + off);
          if (WITH_E) v += __ldg(e + off);
        }
        st[l] = v;
      }
    }
    constexpr int B_SLOTS = VEC ? 2 : 8;
#pragma unroll
    for (int l = 0; l < B_SLOTS; ++l) {
      const int c = tid + THREADS * l;
      const int k = VEC ? c >> 4 : c >> 6;
      const int j = VEC ? 4 * (c & 15) : c & 63;
      const bool ok = k0 + k < k_end && j < r;
      const float* src = b + (ok ? (long long)(k0 + k) * r + j : 0);
      if (VEC) cp_async16(Bs + k * BN + j, src, ok);
      else cp_async4(Bs + k * BN + j, src, ok);
    }
  }

  // store the register-staged A tile (k-major) into As
  __device__ __forceinline__ void store(int tid, int k0, float* As) const {
    if (ASYNC_A) return;
    constexpr int A_SLOTS = VEC ? 4 : 16;
#pragma unroll
    for (int l = 0; l < A_SLOTS; ++l) {
      int k, i;
      bool ok;
      a_slot(l, tid, k0, k, i, ok);
      if (!VEC) {
        As[k * A_LD + i] = st[l];
      } else if (KMAJOR) {
        *reinterpret_cast<float4*>(As + k * A_LD + i) = make_float4(
            st[4 * l], st[4 * l + 1], st[4 * l + 2], st[4 * l + 3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) As[(k + t) * A_LD + i] = st[4 * l + t];
      }
    }
  }
};

// blocks per SM without spills (ptxas -v): four (128 registers) for the
// float4 instances without e, three (170) where e's loads or scalar tiles
// need more, two for the k-minor scalar tiles. BATCHED: matrix z of the
// batch starts at d + z sa_b, b + z sb_b, and its (rows, r) output,
// row-major, at out + s split_stride + z rows r; the compressor's
// single-matrix instances (BATCHED = false) compile without those offsets.
template <bool KMAJOR, bool WITH_E, bool VEC, bool BATCHED>
__global__ void __launch_bounds__(THREADS,
                                  VEC && !WITH_E ? 4 : (VEC || KMAJOR ? 3 : 2))
proj_gemm_kernel(const float* __restrict__ d, const float* __restrict__ e,
                 const float* __restrict__ b, float* __restrict__ out,
                 int rows, int K, int lda, int r, int chunk,
                 long long split_stride, long long sa_b, long long sb_b) {
  __shared__ __align__(16) float As[2][BK * A_LD];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int k_begin = blockIdx.y * chunk;
  const long long z = BATCHED ? blockIdx.z : 0;
  ProjTiles<KMAJOR, WITH_E, VEC> tiles;
  tiles.d = BATCHED ? d + z * sa_b : d;
  tiles.e = BATCHED && WITH_E ? e + z * sa_b : e;
  tiles.b = BATCHED ? b + z * sb_b : b;
  tiles.row0 = (long long)blockIdx.x * BM;
  tiles.lda = lda;
  tiles.rows = rows;
  tiles.k_end = min(K, k_begin + chunk);
  tiles.r = r;
  const int n_steps = (tiles.k_end - k_begin + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  tiles.load(tid, k_begin, As[0], Bs[0]);
  cp_async_commit();
  tiles.store(tid, k_begin, As[0]);
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    const int k_next = k_begin + (t + 1) * BK;
    const bool more = t + 1 < n_steps;
    if (more) {
      tiles.load(tid, k_next, As[cur ^ 1], Bs[cur ^ 1]);
      cp_async_commit();
    }
    // terms past the chunk's end are zeros in both tiles: fma adds +0
    fma_tile(As[cur], Bs[cur], ty, tx, acc);
    if (more) {
      tiles.store(tid, k_next, As[cur ^ 1]);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  out += blockIdx.y * split_stride;
  if (BATCHED) out += z * rows * r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = tiles.row0 + (i < 4 ? 4 * ty + i
                                              : BM / 2 + 4 * ty + i - 4);
    if (row >= rows) continue;
    float* o = out + row * r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * (BN / 2) + 4 * tx;
      if (VEC) {
        if (c < r)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (c + t < r) o[c + t] = acc[i][4 * h + t];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the split sum: out[g] = ws[0][g] + ws[1][g] + ... + ws[S-1][g], left to
// right (the plan's split order), four elements per thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ float split_sum1(const float* ws, long long g,
                                            int splits,
                                            long long split_stride) {
  float acc = ws[g];
  for (int s = 1; s < splits; ++s) acc += ws[s * split_stride + g];
  return acc;
}

__device__ __forceinline__ float4 split_sum4(const float* ws, long long g,
                                             int splits,
                                             long long split_stride) {
  float4 acc = *reinterpret_cast<const float4*>(ws + g);
#pragma unroll 8
  for (int s = 1; s < splits; ++s)
    acc = add4(acc, *reinterpret_cast<const float4*>(ws + s * split_stride
                                                     + g));
  return acc;
}

__global__ void __launch_bounds__(SUM_THREADS)
split_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                 long long total, int splits, long long split_stride) {
  const long long g = 4 * ((long long)blockIdx.x * SUM_THREADS + threadIdx.x);
  if (g + 4 <= total) {
    *reinterpret_cast<float4*>(out + g) =
        split_sum4(ws, g, splits, split_stride);
  } else {
    for (long long x = g; x < total; ++x)
      out[x] = split_sum1(ws, x, splits, split_stride);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the plan's chunks cover [0, K) once and none is empty
static inline bool split_plan_ok(int K, int splits, int chunk) {
  return splits >= 1 && splits <= 65535 && chunk > 0 && chunk % BK == 0 &&
         (long long)(splits - 1) * chunk < K &&
         (long long)splits * chunk >= K;
}

static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// the partials' stride in the workspace: whole float4s
static inline long long split_stride(long long elems) {
  return (elems + 3) / 4 * 4;
}

// out (S = 1) or the workspace (S > 1) of `batch` (rows, r) products;
// split_stride(batch * rows * r) floats apart in the workspace
template <bool KMAJOR>
static int launch_proj_gemm(const float* d, const float* e, const float* b,
                            float* out, int batch, int rows, int K,
                            long long lda, int r, int splits, int chunk,
                            long long sa_b, long long sb_b,
                            cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || lda < 0 || lda > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool vec = r % 4 == 0 && lda % 4 == 0 &&
                   (KMAJOR ? rows : K) % 4 == 0 && sa_b % 4 == 0 &&
                   sb_b % 4 == 0 && aligned16(d) && (!e || aligned16(e)) &&
                   aligned16(b) && aligned16(out);
  const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)splits,
                  (unsigned)batch);
  const long long stride = split_stride((long long)batch * rows * r);
#define PROJ_GEMM(W, V)                                                      \
  do {                                                                       \
    if (batch == 1)                                                          \
      proj_gemm_kernel<KMAJOR, W, V, false><<<grid, THREADS, 0, stream>>>(   \
          d, e, b, out, rows, K, (int)lda, r, chunk, stride, 0, 0);          \
    else                                                                     \
      proj_gemm_kernel<KMAJOR, W, V, true><<<grid, THREADS, 0, stream>>>(    \
          d, e, b, out, rows, K, (int)lda, r, chunk, stride, sa_b, sb_b);    \
  } while (0)
  if (e) {
    if (vec) PROJ_GEMM(true, true);
    else PROJ_GEMM(true, false);
  } else {
    if (vec) PROJ_GEMM(false, true);
    else PROJ_GEMM(false, false);
  }
#undef PROJ_GEMM
  return (int)cudaGetLastError();
}

// out = the sum of the S partials of `total` elements, in split order
static inline int launch_split_sum(const float* ws, float* out,
                                   long long total, int splits,
                                   cudaStream_t stream) {
  const long long groups = (total + 3) / 4;
  split_sum_kernel<<<(unsigned)((groups + SUM_THREADS - 1) / SUM_THREADS),
                     SUM_THREADS, 0, stream>>>(ws, out, total, splits,
                                               split_stride(total));
  return (int)cudaGetLastError();
}

}  // namespace pgemm
