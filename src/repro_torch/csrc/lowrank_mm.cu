// Batched tiled matrix product for Hopper (sm_90a): C[z] = A[z] @ B[z],
// f32 accumulation, f32 or bf16 operands, strided (transposed) views.
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
// tile and the K loop as the innermost dimension. The TPU grid walks K in
// order and keeps the accumulator in VMEM between grid steps; here a loop
// inside the block walks K and the accumulator lives in registers. The
// Pallas wrapper pads both operands to tile multiples (_pad_to); here loads
// past m, n or k read zeros and stores past m or n are skipped, so no
// padded copy exists. A transposed operand is a view: the kernel takes each
// operand's (batch, row, column) element strides, and the tile loaders pick
// the thread order that keeps neighbouring threads on neighbouring
// addresses for either layout, so Q = M^T P never copies the 16-400 MB M.
//
// Types: each operand is f32 or bf16 (converted to f32 as it lands in
// shared memory); the output is bf16 only when both operands are, else f32
// (jnp.promote_types). Every output element sums its k terms in index
// order with fma, so the result does not depend on the operands' layout:
// a transposed view gives the same bits as a contiguous copy of it.
//
// Bound on this card: at r = 64 the projections do 2 * 64 flops per 4-byte
// element of M, 32 per byte, so the f32 rate (67 TFLOP/s outside the
// tensor cores) bounds them rather than HBM (3.35 TB/s); the
// reconstruction writes 4 bytes per 128 flops, near the balance point.
// This first version is a shared-memory SIMT GEMM: 64 x 64 output tiles,
// 256 threads with a 4 x 4 register tile each, K in steps of 32, grid
// (n / 64, m / 64, batch). A product with a narrow output (n = r = 64) and
// few rows (m = 2,048) gets only 32 blocks per matrix and a long serial K
// loop: split-K, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64
#define BK 32
#define N_THREADS 256

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
__global__ void __launch_bounds__(N_THREADS)
mm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
          TO* __restrict__ c, int m, int n, int k, long long sa_b,
          long long sa_m, long long sa_k, long long sb_b, long long sb_k,
          long long sb_n) {
  __shared__ float As[BK][TILE + 1];
  __shared__ float Bs[BK][TILE + 1];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long i0 = (long long)blockIdx.y * TILE;
  const long long j0 = (long long)blockIdx.x * TILE;
  const long long z = blockIdx.z;
  a += z * sa_b;
  b += z * sb_b;
  c += z * (long long)m * n;
  // coalescing: walk the operand's unit-stride dimension across threads
  const bool a_rows = sa_k == 1;                  // A row-major: k fastest
  const bool b_rows = sb_n == 1 || sb_k != 1;     // B row-major: n fastest
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < TILE * BK; idx += N_THREADS) {
      const int i = a_rows ? idx / BK : idx % TILE;
      const int kk = a_rows ? idx % BK : idx / TILE;
      const long long row = i0 + i;
      const int col = k0 + kk;
      As[kk][i] = (row < m && col < k) ? to_f32(a[row * sa_m + col * sa_k])
                                       : 0.f;
    }
    for (int idx = tid; idx < TILE * BK; idx += N_THREADS) {
      const int j = b_rows ? idx % TILE : idx / BK;
      const int kk = b_rows ? idx / TILE : idx % BK;
      const int row = k0 + kk;
      const long long col = j0 + j;
      Bs[kk][j] = (row < k && col < n) ? to_f32(b[row * sb_k + col * sb_n])
                                       : 0.f;
    }
    __syncthreads();
    const int kmax = min(BK, k - k0);
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
  dim3 grid((unsigned)((n + TILE - 1) / TILE), (unsigned)((m + TILE - 1) / TILE),
            (unsigned)batch);
  mm_kernel<TA, TB, TO><<<grid, N_THREADS, 0, stream>>>(
      (const TA*)a, (const TB*)b, (TO*)c, m, n, k, sa_b, sa_m, sa_k, sb_b,
      sb_k, sb_n);
  return (int)cudaGetLastError();
}

// C entry point. a_bf16 / b_bf16: 0 for f32, 1 for bf16; the output, a
// contiguous (batch, m, n) tensor, is bf16 iff both are. Strides are in
// elements. Launches on the caller's stream, returns cudaGetLastError().
extern "C" int lowrank_mm(const void* a, int a_bf16, const void* b, int b_bf16,
                          void* c, int batch, int m, int n, int k,
                          long long sa_b, long long sa_m, long long sa_k,
                          long long sb_b, long long sb_k, long long sb_n,
                          void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k < 0) return 0;
  if ((m + TILE - 1) / TILE > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
