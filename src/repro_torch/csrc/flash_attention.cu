// Causal GQA flash attention for Hopper (sm_90a), float32: a forward kernel
// and a FlashAttention-2-style backward in three kernels, with no atomics.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel      <- _flash_kernel (pallas_call at :96)
//                            O = softmax(Q K^T / sqrt(d), mask) V, and the
//                            per-row log-sum-exp lse (B, H, Sq), f32, that
//                            the backward reads
// The TPU kernel has no gradient (the JAX package defines no custom_vjp for
// it); the backward is new, the gradient of ref.flash_attention_ref:
//   flash_bwd_dot_kernel  D = rowsum(dO * O)                       (B, H, Sq)
//   flash_bwd_dkdv_kernel dK, dV of one (b, kv head, k tile), summed over
//                         the G query heads of its group and the q tiles at
//                         or below the diagonal in a fixed order: no
//                         atomics, so two calls are bitwise equal
//   flash_bwd_dq_kernel   dQ of one (b, h, q tile)
// Both passes recompute P = exp(S - lse) and dS = P * (dP - D).
//
// Layouts: q (B, Sq, H, d), k and v (B, Sk, KV, d), read through the
// strides the wrapper passes (last dim contiguous): no transposed copies, as
// the JAX wrapper makes (:80-82). Query head h reads KV head h / G,
// G = H / KV, by index; the KV heads are never repeated. o, dO, dq
// (B, Sq, H, d) and dk, dv (B, Sk, KV, d) are contiguous. The causal mask is
// top-left aligned (key j is seen by query i iff j <= i), for Sq != Sk too,
// as in the reference; masked scores are -1e30, not -inf.
//
// Bound on this card: per unmasked (q, k) pair the forward does 4 d flops
// (a row of Q K^T and of P V) and the backward 10 d (S again, dP, dV, dK,
// dQ). At the training shape (B 4, S 512, H 32, d 64, causal) the forward
// is 4.3 GFLOP against 67 MB of q, k, v and o: 0.064 ms at 67 TFLOP/s of
// f32 SIMT against 0.020 ms at 3.35 TB/s of HBM. So it is bound by
// operations (TF32 is off: f32 is the configs' param dtype), and the
// backward the more so.
//
// Design (a first, simple version: SIMT fma, no wgmma, no TMA). 256
// threads as a 16 x 16 grid (ty, tx); every tile product is register-tiled,
// thread (ty, tx) owning rows ty + 16 i and columns tx + 16 j. Tiles sit in
// dynamic shared memory with an odd row pitch (d + 1, BK + 1, BQ + 1), so
// neither the row-wise nor the column-wise reads of a product conflict.
// The forward keeps the online-softmax state (m, l and the output rows) in
// registers, in f32; a row's max and sum reduce over the 16 lanes of a
// half warp that own it. A loop over k tiles inside the block takes the
// place of the Pallas K grid axis. Under the causal mask a block visits
// only the k tiles at or below its diagonal (the dK/dV kernel only the q
// tiles at or above it); ragged tails of Sq and Sk are masked, so every S
// works, 384 included (the Pallas kernel asserts S % 256 == 0 there).
// Tiles: BQ = 64 queries; BK = 64 keys for d <= 128, 32 for d = 256, where
// the dK/dV kernel holds 214.5 KB of shared memory (opted in above 48 KB).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define N_THREADS 256
#define BQ 64
#define NEG_BIG (-1e30f)

struct Strides {        // elements between consecutive b, s and head indices
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// register-tiled products over tiles in shared memory
// ---------------------------------------------------------------------------

// c[i][j] += sum_k A[ty + 16 i][k] * B[tx + 16 j][k]   (A B^T, row-major tiles)
template <int RI, int CJ, int INNER>
__device__ __forceinline__ void dot_rows(const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb,
                                         int ty, int tx, float c[RI][CJ]) {
#pragma unroll 4
  for (int k = 0; k < INNER; ++k) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[(tx + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// c[i][j] += sum_k A[ty + 16 i][k] * B[k][tx + 16 j]   (A B, row-major tiles)
template <int RI, int CJ, int INNER>
__device__ __forceinline__ void mul_cols(const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int ldb,
                                         int ty, int tx, float c[RI][CJ]) {
#pragma unroll 4
  for (int k = 0; k < INNER; ++k) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// rows r0 .. r0 + R - 1 of one head of a (B, S, heads, D) tensor into a
// (R, D + 1) tile; `base` points at (b, 0, head, 0); rows >= S read as 0
template <int D, int R>
__device__ __forceinline__ void load_rows(float* __restrict__ tile,
                                          const float* __restrict__ base,
                                          long long row_stride, int r0,
                                          int S) {
  for (int idx = threadIdx.x; idx < R * D; idx += N_THREADS) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    tile[r * (D + 1) + c] = row < S ? base[row * row_stride + c] : 0.f;
  }
}

// max and sum over the 16 lanes of a half warp (the lanes sharing ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool masked(int row, int col, int Sq, int Sk,
                                       int causal) {
  return row >= Sq || col >= Sk || (causal && col > row);
}

// number of k tiles a q tile starting at q0 must visit
__device__ __forceinline__ int k_tiles(int q0, int Sq, int Sk, int bk,
                                       int causal) {
  int n = (Sk + bk - 1) / bk;
  if (causal) n = min(n, (min(q0 + BQ, Sq) - 1) / bk + 1);
  return n;
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, b * H + h)
// ---------------------------------------------------------------------------

template <int D, int BK>
__global__ void __launch_bounds__(N_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int G, int Sq, int Sk,
                 Strides sq, Strides sk, Strides sv, int causal, float scale) {
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = D / 16;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // (BQ, LD)
  float* Ks = Qs + BQ * LD;       // (BK, LD)
  float* Vs = Ks + BK * LD;       // (BK, LD)
  float* Ps = Vs + BK * LD;       // (BQ, LP)
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  load_rows<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = k_tiles(q0, Sq, Sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the previous tile's readers are done
    load_rows<D, BK>(Ks, kb, sk.s, k0, Sk);
    load_rows<D, BK>(Vs, vb, sv.s, k0, Sk);
    __syncthreads();
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    dot_rows<RI, CJ, D>(Qs, LD, Ks, LD, ty, tx, s);
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        // rows past Sq are never stored, so only columns are masked here
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (edge && (col >= Sk || (causal && col > row))) x = NEG_BIG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mul_cols<RI, DJ, BK>(Ps, LP, Vs, LD, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) lse[((long long)b * H + h) * Sq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward 1: D = rowsum(dO * O), one warp per (b, s, h) row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(N_THREADS)
flash_bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                     float* __restrict__ Dout, int H, int Sq,
                     long long rows) {
  const long long row = ((long long)blockIdx.x * N_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;        // uniform across the warp
  const float* orow = o + row * D;
  const float* drow = dO + row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], drow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % H, s = (row / H) % Sq;
    const long long b = row / ((long long)H * Sq);
    Dout[(b * H + h) * Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// backward 2: dK, dV of one (k tile, b * KV + kv head)
// ---------------------------------------------------------------------------

template <int D, int BK>
__global__ void __launch_bounds__(N_THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ Dd, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int KV, int Sq, int Sk,
                      Strides sq, Strides sk, Strides sv, int causal,
                      float scale) {
  constexpr int RI = BK / 16, CQ = BQ / 16, DJ = D / 16;
  constexpr int LD = D + 1, LP = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;               // (BK, LD)
  float* Vs = Ks + BK * LD;       // (BK, LD)
  float* Qs = Vs + BK * LD;       // (BQ, LD)
  float* dOs = Qs + BQ * LD;      // (BQ, LD)
  float* Ps = dOs + BQ * LD;      // (BK, LP): P^T
  float* dSs = Ps + BK * LP;      // (BK, LP): dS^T
  float* lse_s = dSs + BK * LP;   // (BQ,)
  float* D_s = lse_s + BQ;        // (BQ,)
  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long do_s = (long long)H * D;
  load_rows<D, BK>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, Sk);
  load_rows<D, BK>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, Sk);

  float dk_acc[RI][DJ], dv_acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;   // first q tile with a row >= k0
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* D_h = Dd + ((long long)b * H + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();            // the previous tile's readers are done
      load_rows<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
      load_rows<D, BQ>(dOs, dO + (long long)b * Sq * do_s + h * D, do_s,
                       q0, Sq);
      for (int r = threadIdx.x; r < BQ; r += N_THREADS) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse_h[q0 + r] : 0.f;
        D_s[r] = in ? D_h[q0 + r] : 0.f;
      }
      __syncthreads();
      float sT[RI][CQ], dpT[RI][CQ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) sT[i][j] = dpT[i][j] = 0.f;
      dot_rows<RI, CQ, D>(Ks, LD, Qs, LD, ty, tx, sT);    // S^T  (k, q)
      dot_rows<RI, CQ, D>(Vs, LD, dOs, LD, ty, tx, dpT);  // dP^T (k, q)
      const bool edge = q0 + BQ > Sq || k0 + BK > Sk
                        || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int c = tx + 16 * j;
          float p = expf(sT[i][j] * scale - lse_s[c]);
          if (edge && masked(q0 + c, k0 + ty + 16 * i, Sq, Sk, causal))
            p = 0.f;
          Ps[(ty + 16 * i) * LP + c] = p;
          dSs[(ty + 16 * i) * LP + c] = p * (dpT[i][j] - D_s[c]);
        }
      }
      __syncthreads();
      mul_cols<RI, DJ, BQ>(Ps, LP, dOs, LD, ty, tx, dv_acc);   // P^T dO
      mul_cols<RI, DJ, BQ>(dSs, LP, Qs, LD, ty, tx, dk_acc);   // dS^T Q
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    const long long off = (((long long)b * Sk + row) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j] * scale;
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dQ of one (q tile, b * H + h)
// ---------------------------------------------------------------------------

template <int D, int BK>
__global__ void __launch_bounds__(N_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dd, float* __restrict__ dq,
                    int H, int G, int Sq, int Sk, Strides sq, Strides sk,
                    Strides sv, int causal, float scale) {
  constexpr int RI = BQ / 16, CJ = BK / 16, DJ = D / 16;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // (BQ, LD)
  float* dOs = Qs + BQ * LD;      // (BQ, LD)
  float* Ks = dOs + BQ * LD;      // (BK, LD)
  float* Vs = Ks + BK * LD;       // (BK, LD)
  float* dSs = Vs + BK * LD;      // (BQ, LP)
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long do_s = (long long)H * D;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  load_rows<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_rows<D, BQ>(dOs, dO + (long long)b * Sq * do_s + h * D, do_s, q0,
                   Sq);

  float lse_r[RI], D_r[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = ((long long)b * H + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    D_r[i] = row < Sq ? Dd[at] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = k_tiles(q0, Sq, Sk, BK, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<D, BK>(Ks, kb, sk.s, k0, Sk);
    load_rows<D, BK>(Vs, vb, sv.s, k0, Sk);
    __syncthreads();
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<RI, CJ, D>(Qs, LD, Ks, LD, ty, tx, s);     // S  (q, k)
    dot_rows<RI, CJ, D>(dOs, LD, Vs, LD, ty, tx, dp);   // dP (q, k)
    const bool edge = q0 + BQ > Sq || k0 + BK > Sk
                      || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] * scale - lse_r[i]);
        if (edge && masked(q0 + ty + 16 * i, k0 + c, Sq, Sk, causal))
          p = 0.f;
        dSs[(ty + 16 * i) * LP + c] = p * (dp[i][j] - D_r[i]);
      }
    }
    __syncthreads();
    mul_cols<RI, DJ, BK>(dSs, LP, Ks, LD, ty, tx, acc);     // dS K
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    float* dqrow = dq + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqrow[tx + 16 * j] = acc[i][j] * scale;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const float *q, *k, *v, *o, *dO, *lse;
  float *out, *lse_out, *Dd, *dq, *dk, *dv;
  int B, H, KV, Sq, Sk, causal;
  Strides sq, sk, sv;
  float scale;
  cudaStream_t stream;
};

template <int D, int BK>
static int launch_fwd(const Args& a) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1)
                                       + BQ * (BK + 1));
  cudaError_t err = allow_smem(flash_fwd_kernel<D, BK>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((a.Sq + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  flash_fwd_kernel<D, BK><<<grid, N_THREADS, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.lse_out, a.H, a.H / a.KV, a.Sq, a.Sk, a.sq,
      a.sk, a.sv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D, int BK>
static int launch_bwd(const Args& a) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_dot_kernel<D><<<(unsigned)((rows * 32 + N_THREADS - 1)
                                       / N_THREADS),
                            N_THREADS, 0, a.stream>>>(a.o, a.dO, a.Dd, a.H,
                                                      a.Sq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 1)
                                          + 2 * BK * (BQ + 1) + 2 * BQ);
  err = allow_smem(flash_bwd_dkdv_kernel<D, BK>, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((unsigned)((a.Sk + BK - 1) / BK), (unsigned)(a.B * a.KV));
  flash_bwd_dkdv_kernel<D, BK><<<grid_kv, N_THREADS, smem_kv, a.stream>>>(
      a.q, a.k, a.v, a.dO, a.lse, a.Dd, a.dk, a.dv, a.H, a.KV, a.Sq, a.Sk,
      a.sq, a.sk, a.sv, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (D + 1)
                                         + BQ * (BK + 1));
  err = allow_smem(flash_bwd_dq_kernel<D, BK>, smem_q);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((unsigned)((a.Sq + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  flash_bwd_dq_kernel<D, BK><<<grid_q, N_THREADS, smem_q, a.stream>>>(
      a.q, a.k, a.v, a.dO, a.lse, a.Dd, a.dq, a.H, a.H / a.KV, a.Sq, a.Sk,
      a.sq, a.sk, a.sv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

// head dims 32, 64, 128, 256 (the ported configs'); BK 32 at 256 so the
// dK/dV kernel's tiles fit in shared memory
template <bool FWD>
static int dispatch(int d, const Args& a) {
  switch (d) {
    case 32: return FWD ? launch_fwd<32, 64>(a) : launch_bwd<32, 64>(a);
    case 64: return FWD ? launch_fwd<64, 64>(a) : launch_bwd<64, 64>(a);
    case 128: return FWD ? launch_fwd<128, 64>(a) : launch_bwd<128, 64>(a);
    case 256: return FWD ? launch_fwd<256, 32>(a) : launch_bwd<256, 32>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool valid(int B, int H, int KV, int Sq, int Sk) {
  return B > 0 && KV > 0 && H % KV == 0 && Sq > 0 && Sk > 0
         && (long long)B * H <= 65535;
}

extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Sk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, void* stream) {
  if (!valid(B, H, KV, Sq, Sk)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.out = (float*)o;
  a.lse_out = (float*)lse;
  a.B = B; a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.causal = causal;
  a.sq = {qsb, qss, qsh};
  a.sk = {ksb, kss, ksh};
  a.sv = {vsb, vss, vsh};
  a.scale = 1.0f / sqrtf((float)d);
  a.stream = (cudaStream_t)stream;
  return dispatch<true>(d, a);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* Dd, void* dq, void* dk, void* dv,
    int B, int H, int KV, int Sq, int Sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    void* stream) {
  if (!valid(B, H, KV, Sq, Sk)) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.o = (const float*)o;
  a.dO = (const float*)dO;
  a.lse = (const float*)lse;
  a.Dd = (float*)Dd;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.B = B; a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.causal = causal;
  a.sq = {qsb, qss, qsh};
  a.sk = {ksb, kss, ksh};
  a.sv = {vsb, vss, vsh};
  a.scale = 1.0f / sqrtf((float)d);
  a.stream = (cudaStream_t)stream;
  return dispatch<false>(d, a);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
