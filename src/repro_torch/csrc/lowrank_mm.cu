// Batched matrix product for Hopper (sm_90a): C[z] = A[z] @ B[z], f32
// accumulation, f32 or bf16 operands, strided (transposed) views.
//
// Replaces the TPU kernel src/repro/kernels/lowrank_mm.py::_mm_kernel
// (wrapper matmul_pallas): the PowerSGD products of the mesh runtime's
// outer step (core/mesh_compression.py), per low-rank matrix
//   P = M Q        (m, n) @ (n, r)
//   Q = M^T P      (n, m) @ (m, r)      M^T read through its strides
//   hat = P Q^T    (m, r) @ (r, n)      Q^T read through its strides
// batched over the C * lead matrices of a cluster-stacked leaf.
//
// What carries over from the Pallas kernel: an f32 accumulator per output
// tile and, within a block, the K loop as the innermost dimension. The
// Pallas wrapper pads both operands to tile multiples (_pad_to); here
// loads past m, n or k read zeros and stores past m or n are skipped, so
// no padded copy exists. A transposed operand is a view: each kernel takes
// the operands' element strides, so Q = M^T P never copies the 16-400 MB M.
//
// Three routes, chosen by the wrapper (kernels/lowrank_mm.py::_route) from
// dtypes, shapes and strides:
//   split    f32, n <= 64, B row-major, A with a unit stride: the split-K
//            GEMM of proj_gemm.cuh (P = M Q and Q = M^T P), with the plan
//            kernels/_plan.py::split_k(ceil(m / 128), k), a function of
//            (m, k) alone, then the fixed-order split sum (S > 1);
//   rank     f32, k <= 64: the K-resident GEMM of rank_gemm.cuh (P Q^T);
//   general  anything else (bf16 operands, wide products): mm_kernel below.
// Every output element sums its k terms in index order with fma (within
// each split chunk, then the chunks left to right, on the split route), so
// the result does not depend on the operands' layout or on the batch: a
// transposed view gives the same bits as a contiguous copy of it, and a
// batched launch gives each matrix the bits of its own launch.
//
// Bound on this card: at r = 64 the projections do 2 * 64 flops per 4-byte
// element of M, 32 per byte, so the f32 rate (67 TFLOP/s outside the
// tensor cores) bounds them rather than HBM (3.35 TB/s); the
// reconstruction writes 4 bytes per 128 flops, near the balance point.
//
// mm_kernel (general route): 64 x 64 output tiles, 256 threads with a
// 4 x 4 register tile each, K in steps of 32, grid (n / 64, m / 64, batch).
// Types: each operand is f32 or bf16 (converted to f32 as it lands in
// shared memory); the output is bf16 only when both operands are, else f32
// (jnp.promote_types).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "proj_gemm.cuh"
#include "rank_gemm.cuh"

#define MM_TILE 64
#define MM_BK 32
#define MM_THREADS 256

enum Route { GENERAL = 0, SPLIT = 1, RANK = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// As[k][i] holds A[i0 + i, k0 + k]; Bs[k][j] holds B[k0 + k, j0 + j]. Both
// rows are padded to 65 floats so that the column-order stores of the
// transposed loaders hit 32 different banks. Thread (ty, tx) owns output
// rows ty + 16 a and columns tx + 16 b, a, b in 0..3.
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(MM_THREADS)
mm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
          TO* __restrict__ c, int m, int n, int k, long long sa_b,
          long long sa_m, long long sa_k, long long sb_b, long long sb_k,
          long long sb_n) {
  __shared__ float As[MM_BK][MM_TILE + 1];
  __shared__ float Bs[MM_BK][MM_TILE + 1];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long i0 = (long long)blockIdx.y * MM_TILE;
  const long long j0 = (long long)blockIdx.x * MM_TILE;
  const long long z = blockIdx.z;
  a += z * sa_b;
  b += z * sb_b;
  c += z * (long long)m * n;
  // coalescing: walk the operand's unit-stride dimension across threads
  const bool a_rows = sa_k == 1;                  // A row-major: k fastest
  const bool b_rows = sb_n == 1 || sb_k != 1;     // B row-major: n fastest
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += MM_BK) {
    for (int idx = tid; idx < MM_TILE * MM_BK; idx += MM_THREADS) {
      const int i = a_rows ? idx / MM_BK : idx % MM_TILE;
      const int kk = a_rows ? idx % MM_BK : idx / MM_TILE;
      const long long row = i0 + i;
      const int col = k0 + kk;
      As[kk][i] = (row < m && col < k) ? to_f32(a[row * sa_m + col * sa_k])
                                       : 0.f;
    }
    for (int idx = tid; idx < MM_TILE * MM_BK; idx += MM_THREADS) {
      const int j = b_rows ? idx % MM_TILE : idx / MM_BK;
      const int kk = b_rows ? idx / MM_TILE : idx % MM_BK;
      const int row = k0 + kk;
      const long long col = j0 + j;
      Bs[kk][j] = (row < k && col < n) ? to_f32(b[row * sb_k + col * sb_n])
                                       : 0.f;
    }
    __syncthreads();
    const int kmax = min(MM_BK, k - k0);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) av[s] = As[kk][ty + 16 * s];
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = Bs[kk][tx + 16 * s];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long row = i0 + ty + 16 * p;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long col = j0 + tx + 16 * q;
      if (col < n) store(c + row * n + col, acc[p][q]);
    }
  }
}

template <typename TA, typename TB, typename TO>
static int launch(const void* a, const void* b, void* c, int batch, int m,
                  int n, int k, long long sa_b, long long sa_m, long long sa_k,
                  long long sb_b, long long sb_k, long long sb_n,
                  cudaStream_t stream) {
  dim3 grid((unsigned)((n + MM_TILE - 1) / MM_TILE),
            (unsigned)((m + MM_TILE - 1) / MM_TILE), (unsigned)batch);
  mm_kernel<TA, TB, TO><<<grid, MM_THREADS, 0, stream>>>(
      (const TA*)a, (const TB*)b, (TO*)c, m, n, k, sa_b, sa_m, sa_k, sb_b,
      sb_k, sb_n);
  return (int)cudaGetLastError();
}

static int general(const void* a, int a_bf16, const void* b, int b_bf16,
                   void* c, int batch, int m, int n, int k, long long sa_b,
                   long long sa_m, long long sa_k, long long sb_b,
                   long long sb_k, long long sb_n, cudaStream_t s) {
  if ((m + MM_TILE - 1) / MM_TILE > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf;
  if (!a_bf16 && !b_bf16)
    return launch<float, float, float>(a, b, c, batch, m, n, k, sa_b, sa_m,
                                       sa_k, sb_b, sb_k, sb_n, s);
  if (!a_bf16 && b_bf16)
    return launch<float, bf, float>(a, b, c, batch, m, n, k, sa_b, sa_m, sa_k,
                                    sb_b, sb_k, sb_n, s);
  if (a_bf16 && !b_bf16)
    return launch<bf, float, float>(a, b, c, batch, m, n, k, sa_b, sa_m, sa_k,
                                    sb_b, sb_k, sb_n, s);
  return launch<bf, bf, bf>(a, b, c, batch, m, n, k, sa_b, sa_m, sa_k, sb_b,
                            sb_k, sb_n, s);
}

// split route: rows m, K = k, r = n; ws holds splits x ceil4(batch m n)
// floats (unused at S = 1)
static int split(const float* a, const float* b, float* c, float* ws,
                 int batch, int m, int n, int k, long long sa_b,
                 long long sa_m, long long sa_k, long long sb_b, int splits,
                 int chunk, cudaStream_t s) {
  if (n > pgemm::BN || !pgemm::split_plan_ok(k, splits, chunk) ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  float* out = splits == 1 ? c : ws;
  int err;
  if (sa_k == 1)
    err = pgemm::launch_proj_gemm<false>(a, nullptr, b, out, batch, m, k,
                                         sa_m, n, splits, chunk, sa_b, sb_b, s);
  else if (sa_m == 1)
    err = pgemm::launch_proj_gemm<true>(a, nullptr, b, out, batch, m, k, sa_k,
                                        n, splits, chunk, sa_b, sb_b, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || splits == 1) return err;
  return pgemm::launch_split_sum(ws, c, (long long)batch * m * n, splits, s);
}

// C entry point. a_bf16 / b_bf16: 0 for f32, 1 for bf16; the output, a
// contiguous (batch, m, n) tensor, is bf16 iff both are. Strides are in
// elements. route: GENERAL, SPLIT (B row-major: sb_n == 1, sb_k == n; a
// plan (splits, chunk) and, for S > 1, the workspace ws) or RANK (k <= 64).
// Launches on the caller's stream, returns cudaGetLastError().
extern "C" int lowrank_mm(const void* a, int a_bf16, const void* b, int b_bf16,
                          void* c, int batch, int m, int n, int k,
                          long long sa_b, long long sa_m, long long sa_k,
                          long long sb_b, long long sb_k, long long sb_n,
                          int route, int splits, int chunk, void* ws,
                          void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (route == GENERAL)
    return general(a, a_bf16, b, b_bf16, c, batch, m, n, k, sa_b, sa_m, sa_k,
                   sb_b, sb_k, sb_n, s);
  if (a_bf16 || b_bf16) return (int)cudaErrorInvalidValue;
  if (route == SPLIT) {
    if (sb_n != 1 || sb_k != n) return (int)cudaErrorInvalidValue;
    return split((const float*)a, (const float*)b, (float*)c, (float*)ws,
                 batch, m, n, k, sa_b, sa_m, sa_k, sb_b, splits, chunk, s);
  }
  if (route == RANK) {
    const rgemm::Operand ao = {(const float*)a, sa_b, sa_m, sa_k};
    const rgemm::Operand bo = {(const float*)b, sb_b, sb_n, sb_k};
    return rgemm::launch_rank_gemm(ao, bo, batch, m, n, k, (float*)c, nullptr,
                                   nullptr, nullptr, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
