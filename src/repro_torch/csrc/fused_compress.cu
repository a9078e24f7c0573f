// The fused outer-step compressor for Hopper (sm_90a), float32: the kernels
// per (m, n) parameter matrix M = delta (+ e), rank r <= 64.
//
// Replaces the TPU kernels of src/repro/kernels/fused_compress.py:
//   _proj_kernel        P = (D + E) @ Qm          (m, r)
//     <- proj_gemm_kernel<false, ...> over K = n in S splits, then
//        split_sum_kernel (skipped when S = 1: the GEMM writes P)
//   _proj_t_pack_kernel Q = (D + E)^T @ P         (n, r), and the int4 codes
//                       and scales of the flat row-major Q
//                       (quant4_pack_ref's layout)
//     <- proj_gemm_kernel<true, ...> over K = m in S splits, then
//        t_pack_finish_kernel: the split sum, Q, and the pack
//   _recon_kernel       hat = deq(P) @ deq(Q)^T   (m, n) from the packed
//                       payload, and with EF e' = (D + E) - hat
//     <- recon_kernel
// The r x r Cholesky-QR of P runs between the first two on the host side,
// as in the JAX driver.
//
// Bound on this card: each projection streams the (m, n) matrix once
// (twice with E) and does 2*m*n*r flops; at r = 64 that is 32 flops per
// 4-byte element read, so the f32 rate (67 TFLOP/s on SIMT cores) bounds
// rather than HBM (3.35 TB/s). The products are f32 and held to f32 gates,
// so they stay on the SIMT cores: wgmma has no f32 operand kind, and TF32
// keeps about 10 mantissa bits.
//
// The projections' GEMM (proj_gemm_kernel): the output is (rows, r <= 64),
// so a block owns a 128 x 64 output tile, the whole factor width, and
// tiles only the long dimension. 128 threads each hold an 8 x 8 register
// tile (64 FMAs per four float4 shared-memory reads), K advances in steps
// of 16 through a two-stage ring in shared memory. The next K tile is in
// flight while this one is multiplied: for Q = D^T P both operands are
// k-major in device memory, so 16-byte cp.async copies them straight into
// the ring; for P = D Qm the D tile (k-minor) is loaded into registers
// before the FMAs and stored transposed after them. The EF operand e
// (WITH_E) is added on the operand tile, through registers.
//
// Split-K: the long dimension of a factor is often only 2,048 rows, i.e.
// 16 tiles for 132 SMs, while K runs to 98,304. The wrapper's plan
// (kernels/fused_compress.py::_split_k) cuts K into S chunks of `chunk`
// terms (a multiple of the K step; the last chunk ends at K) so that
// tiles x S blocks fill the card. Split s writes its partial (rows, r)
// block to a workspace; a second kernel adds the S partials in split
// order. No atomics: every output element is, bit for bit, the same
// function of its inputs in every call (sequential fma over each chunk in
// index order, then the chunk partials left to right), so the trainer is
// deterministic on the card, the fused EF form equals the hoisted one,
// and the sum keeps the f32 bounds that chip_smoke.py's _gate_product
// states for any order (16 eps sqrt(K) |terms|).
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant4_codes.cuh"

#define TILE 64
#define N_THREADS 256
#define R_MAX 64

#define BM 128                 // projection output rows per block
#define BN 64                  // projection output columns: all of r <= 64
#define BK 16                  // K step
#define GEMM_THREADS 128       // 16 x 8 threads, an 8 x 8 register tile each
#define A_LD (BM + 4)          // row stride of the A tile in shared memory
#define SUM_THREADS 256
#define FINISH_THREADS 1024

// ---------------------------------------------------------------------------
// recon: 64 x 64 register-tiled product over a K chunk held in shared memory
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
// cp.async: 16- and 4-byte copies into shared memory; src_size 0 fills the
// destination with zeros and reads nothing (the tile's ragged edge)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// the projections' GEMM: out[s] = A[:, chunk s] @ B[chunk s, :] for the
// 128-row tile blockIdx.x and the K chunk s = blockIdx.y, where
//   KMAJOR = false (project):   A(i, k) = D[i, k] (+E), rows = m, K = n
//   KMAJOR = true  (t_pack):    A(j, k) = D[k, j] (+E), rows = n, K = m
// and B (K, r) row-major (Qm or P). VEC: n and r multiples of 4 and every
// pointer 16-byte aligned, so tiles move as float4; otherwise as floats.
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
  int rows, k_end, n, r;
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
    } else if (VEC) {            // 16 rows of k x 32 float4 of j
      const int c = tid + GEMM_THREADS * l;
      k = c >> 5;
      i = 4 * (c & 31);
    } else if (!KMAJOR) {        // 128 rows x 16 k, 16 threads per row
      const int c = tid + GEMM_THREADS * l;
      k = c & 15;
      i = c >> 4;
    } else {                     // 16 rows of k x 128 j
      const int c = tid + GEMM_THREADS * l;
      k = c >> 7;
      i = c & 127;
    }
    ok = k0 + k < k_end && row0 + i < rows;
  }

  __device__ __forceinline__ long long a_off(int k0, int k, int i) const {
    return KMAJOR ? (long long)(k0 + k) * n + row0 + i
                  : (row0 + i) * (long long)n + k0 + k;
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
      const int c = tid + GEMM_THREADS * l;
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
// instances the compressor launches (no e, float4 tiles), three (170)
// where e's loads or scalar tiles need more, two for project's scalar
// tiles
template <bool KMAJOR, bool WITH_E, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS,
                                  VEC && !WITH_E ? 4 : (VEC || KMAJOR ? 3 : 2))
proj_gemm_kernel(const float* __restrict__ d, const float* __restrict__ e,
                 const float* __restrict__ b, float* __restrict__ out,
                 int rows, int K, int n, int r, int chunk,
                 long long split_stride) {
  __shared__ __align__(16) float As[2][BK * A_LD];
  __shared__ __align__(16) float Bs[2][BK * BN];
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int k_begin = blockIdx.y * chunk;
  ProjTiles<KMAJOR, WITH_E, VEC> tiles;
  tiles.d = d;
  tiles.e = e;
  tiles.b = b;
  tiles.row0 = (long long)blockIdx.x * BM;
  tiles.rows = rows;
  tiles.k_end = min(K, k_begin + chunk);
  tiles.n = n;
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

// the plan's chunks cover [0, K) once and none is empty
static bool split_plan_ok(int K, int splits, int chunk) {
  return splits >= 1 && splits <= 65535 && chunk > 0 && chunk % BK == 0 &&
         (long long)(splits - 1) * chunk < K &&
         (long long)splits * chunk >= K;
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// the partials' stride in the workspace: whole float4s
static long long split_stride(int rows, int r) {
  return ((long long)rows * r + 3) / 4 * 4;
}

template <bool KMAJOR>
static int launch_proj_gemm(const float* d, const float* e, const float* b,
                            float* out, int rows, int K, int n, int r,
                            int splits, int chunk, cudaStream_t stream) {
  const bool vec = n % 4 == 0 && r % 4 == 0 && aligned16(d) &&
                   (!e || aligned16(e)) && aligned16(b) && aligned16(out);
  const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)splits);
  const long long stride = split_stride(rows, r);
#define PROJ_GEMM(W, V)                                                      \
  proj_gemm_kernel<KMAJOR, W, V><<<grid, GEMM_THREADS, 0, stream>>>(         \
      d, e, b, out, rows, K, n, r, chunk, stride)
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

// P = (D + E) @ Qm; ws holds splits x ceil4(m r) floats (unused at S = 1)
extern "C" int fused_project_f32(const void* d, const void* e, const void* qm,
                                 void* p, void* ws, int m, int n, int r,
                                 int splits, int chunk, void* stream) {
  if (r < 1 || r > R_MAX || !split_plan_ok(n, splits, chunk) ||
      (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* out = splits == 1 ? (float*)p : (float*)ws;
  int err = launch_proj_gemm<false>((const float*)d, (const float*)e,
                                    (const float*)qm, out, m, n, n, r,
                                    splits, chunk, s);
  if (err != 0 || splits == 1) return err;
  const long long total = (long long)m * r;
  const long long groups = (total + 3) / 4;
  split_sum_kernel<<<(unsigned)((groups + SUM_THREADS - 1) / SUM_THREADS),
                     SUM_THREADS, 0, s>>>((const float*)ws, (float*)p, total,
                                          splits, split_stride(m, r));
  return (int)cudaGetLastError();
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
      !split_plan_ok(m, splits, chunk) || !ws)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_proj_gemm<true>((const float*)d, (const float*)e,
                                   (const float*)p, (float*)ws, n, m, n, r,
                                   splits, chunk, s);
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
      splits, split_stride(n, r), tile_rows, block, nblk_total);
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
