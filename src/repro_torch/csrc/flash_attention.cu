// Causal GQA flash attention for Hopper (sm_90a), float32 and bf16: a
// forward kernel and a FlashAttention-2-style backward in four kernels,
// with no atomics.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel       <- _flash_kernel (pallas_call at :96), f32:
//                             O = softmax(Q K^T / sqrt(d), mask) V, and the
//                             per-row log-sum-exp lse (B, H, Sq), f32, that
//                             the backward reads
//   flash_fwd_wgmma_kernel <- the same, bf16 (below)
// The TPU kernel has no gradient (the JAX package defines no custom_vjp for
// it); the backward is new, the gradient of ref.flash_attention_ref:
//   flash_bwd_dot_kernel   D = rowsum(dO * O)                      (B, H, Sq)
//   flash_bwd_dkdv_kernel  dK, dV of one (b, query head, k tile) over one
//                          range of q tiles: the dK/dV of its KV head when
//                          G = 1 and one range, else a partial
//   flash_bwd_dq_kernel    dQ of one (b, h, q tile) over one range of its k
//                          tiles: dQ itself when there is one range, else a
//                          partial
//   flash_sum_parts_kernel dK, dV (dQ) = the partials summed in a fixed
//                          order (query head of the group, then range)
//   flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel: dK/dV and dQ
//                          in bf16 (below)
// Both passes recompute P = exp(S - lse) and dS = P * (dP - D). No atomics,
// so two calls are bitwise equal.
//
// Layouts: q (B, Sq, H, d), k and v (B, Sk, KV, d), read through the
// strides the wrapper passes (last dim contiguous, every pointer and stride
// a multiple of 16 bytes): no transposed copies, as the JAX wrapper makes
// (:80-82). Query head h reads KV head h / G, G = H / KV, by index. o, dO,
// dq (B, Sq, H, d) and dk, dv (B, Sk, KV, d) are contiguous. The causal
// mask is top-left aligned (key j is seen by query i iff j <= i), for
// Sq != Sk too, as in the reference; masked scores are -1e30, not -inf.
//
// Bound on this card: per unmasked (q, k) pair the forward does 4 d flops
// (a row of Q K^T and of P V) and the backward 10 d (S again, dP, dV, dK,
// dQ). The products run on the tensor cores as 3xTF32 (tf32_mma.cuh: three
// TF32 mma per product keep the f32 gates; one does not), so the least
// time is 3 x flops at 495 TFLOP/s: at the training shape (B 4, S 512,
// H 32, d 64, causal) 0.026 ms forward and 0.065 ms backward, against
// 0.020 ms of HBM traffic forward; 0.064 and 0.161 ms at the f32 SIMT
// rate. Operations bound both.
//
// Design (f32). 128 threads, 4 warps, two blocks an SM where shared memory
// allows; a block keeps 64 rows resident (16 per warp: queries in the
// forward and dQ, keys in dK/dV) and streams the other side in tiles
// through a two-stage ring filled by 16-byte cp.async, so the next tile is
// in flight while this one is multiplied. Streamed rows (tile_rows,
// q_tile_rows, dq_tile_rows): the forward 64, 64, 32, 16 at d = 32, 64,
// 128, 256; dK/dV's q tiles 32 at d <= 64, else 16; dQ's k tiles 64 at
// d <= 64, else 16. At d <= 64 the dK/dV kernel splits each Q and dO tile
// into its TF32 parts once, into tiles of their own, sparing its warps 3
// of every 4 splits of a B element; elsewhere each warp splits the
// fragments it reads. At NT <= 2 (16-row tiles) the two score products S
// and dP run in one loop. Rows have a pitch of d + 4
// floats: 16-byte aligned, and every fragment read (ldmatrix for the
// k-contiguous operands, two 32-bit loads at rows 2t, 2t + 1 for the
// products over S's columns) falls on 32 distinct banks. S (and dP) stay
// in registers in the mma's C layout; the online softmax (m, l, the O
// accumulator) too, with row max and sum over the 4 lanes of a quad. P and
// dS pass through shared memory only between the two warp groups at d =
// 256 (below): their C fragments are the A fragments of P V, dS K, P^T dO
// and dS^T Q (tf32_mma.cuh). Under the causal mask a block visits only the
// tiles at or below (dK/dV: at or above) its diagonal; ragged tails of Sq
// and Sk are masked, so every S works, 384 included (the Pallas kernel
// asserts S % 256 == 0 there). The forward and dQ grids run the longest
// causal q tiles first.
//
// The backward keeps 8 warps on each SM at every d. At d <= 128 its
// kernels take at most 104,960 B of shared memory (d = 128: 16-row
// streamed tiles, 101,632 B dK/dV and 101,376 B dQ), so two 4-warp blocks
// share an SM. At d = 256 the resident K, V (or Q, dO) tiles alone take
// 133,120 B, so a block is 8 warps in two groups over the same 64
// resident rows: group 0 computes S, group 1 dP, each for its warp's 16
// rows; they trade P and dP through shared memory (8 KB), both form dS,
// and each group accumulates half of the dK/dV (dQ) columns, so S and dP
// are computed once per (k tile, q tile) for all d columns.
//
// The forward's grid: one block per (q tile, b * H + h, range of k
// tiles). Where B H ceil(Sq / 64) blocks cannot fill the card (gemma3-1b's
// global layers: 32), the plan (kernels/_plan.py::flash_fwd_plan, a
// function of the shape) cuts each q tile's k tiles into ranges of
// `chunk` tiles, range r holding tiles [r chunk, (r + 1) chunk); a range
// past its q tile's causal tiles returns at once. Each range writes its
// partial (m, l, unnormalised O) to a workspace, and flash_fwd_merge_kernel
// merges a row's ranges in increasing order (online_merge.cuh, the
// recurrence of the paged merge). With one range the kernel writes o and
// lse itself. The d = 256 forward keeps one block an SM (133,120 B: the
// Q tile and two stages of 16-row K and V tiles): two would need 113 KB
// each, so 8-row tiles (one n-tile a warp, twice the syncs per key) or
// one stage (no copy in flight); the plan sizes its ranges to the 132
// blocks the card holds instead.
//
// Grids that fill the card, with no atomics. dK/dV: one block per (k tile,
// b * H + h, range). A block per query head gives B H ceil(Sk / 64)
// blocks (the KV head's G-fold sum moves to the partials). Causal k tiles
// differ in length (k tile 0 sees every q tile, the last few), so where
// those blocks come to less than two waves of the card the plan
// (kernels/_plan.py::flash_dkdv_plan, a function of the shape alone) cuts
// each k tile's q tiles into ranges of `chunk` tiles, `split` ranges.
// With G split > 1 partials, flash_sum_parts_kernel adds them in order
// (query head of the group, then range); a range past its k tile's q
// tiles returns at once and the sum skips it. dQ: one block per (q tile,
// b * H + h, range); the plan (flash_dq_plan) cuts each q tile's k tiles
// into ranges of `chunk` tiles the same way, and their partials are
// summed in range order.
//
// bf16 (the *_bf16 entry points) over bf16 q, k, v, o and dO, writing o,
// dq, dk and dv in bf16; lse, D, the partials and every sum stay f32. Q
// K^T, dO V^T and their transposes multiply bf16 by bf16, exact per term
// as JAX's f32 dot of the upcast inputs (repro/kernels/flash_attention.py:
// 38-41); P and dS are f32 and enter their products rounded to bf16 (one
// product; a hi + lo split, two products, was as right within chip_smoke's
// gates and slower). Bound: 4 d (10 d) flops a pair at the card's bf16
// tensor rate, 989 TFLOP/s; at the training shape (B 4, S 512, H 32, d 64)
// HBM traffic bounds both passes (forward 0.010 ms, 0.009 of flops;
// backward 0.020, 0.011 of flops), at one qwen1.5-107b layer (B 1, S
// 4,096, H 64, KV 8, d 128) their flops (0.278 and 0.695 ms).
//
// The bf16 kernels of the forward and of dK/dV and dQ are Hopper's own:
// the f32 kernels' grids, range plans (with their own tiles), partials and
// sums, but one warpgroup of 4 warps over 64 resident rows (two
// warpgroups in the backward at d = 256), every product a wgmma
// (wgmma.cuh). A score product (S = Q K^T, or S^T = K Q^T and dP^T = V
// dO^T in dK/dV, S and dP = dO V^T in dQ; m64n{tile}k16) reads both
// operands K-major from shared memory; a product over the scores (O += P
// V; dV += P^T dO, dK += dS^T Q; dQ += dS K; m64n{d}k16) takes P or dS
// from registers (the score accumulator is laid out as mma.sync's C
// fragments, two of which are an A fragment, rounded to bf16 once) and
// reads V, dO, Q or K MN-major with the transpose bit from the same tile
// the score product read K-major, so no transposed copy is made. Tiles
// have no padded pitch: TMA (cp.async.bulk.tensor, through tensor maps of
// q, k, v and dO's strides built per call) writes them with the 128-byte
// swizzle the descriptors name (64-byte at d = 32), a d = 128 or 256 row
// as 2 or 4 slabs of 128 bytes, each a tile of its own; ragged rows read
// as zeros. The resident tiles come once; one thread keeps a ring of
// streamed stages in flight on mbarriers while the warpgroup multiplies,
// and refills a stage once the block is done with it. Tiles, blocks an SM
// (the launch bound: what registers allow) and rings (the SM's shared
// memory split evenly among those blocks) are WgmmaFwd's and WgmmaBwd's:
// the forward streams k tiles of 64 keys (32 at d = 256) at 4, 3, 2, 2
// blocks an SM (d = 32, 64, 128, 256); dK/dV q tiles of 64 queries (32 at
// d >= 128, where dK and dV hold 128 registers a thread) at 3, 3, 2, 1
// blocks; dQ k tiles of 64 (32 at d = 256) at 4, 3, 2, 1. dK/dV's lse and
// D slices pass through shared memory, one entry a thread staged a q tile
// ahead; at d = 256 warpgroup 0 forms the scores and P, warpgroup 1 dP,
// and they trade them through shared memory as the f32 two-group body
// does. Where G > 1 or the plan splits, the f32 partials of dK/dV and dQ
// are summed by flash_sum_parts_kernel in the f32 order; at the qwen1.5-
// 107b layer (G = 8) they are 0.54 GB written and read, 0.16 ms at HBM
// rate, the next lever for that shape.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "online_merge.cuh"
#include "tf32_mma.cuh"
#include "wgmma.cuh"

#define N_THREADS 128           // 4 warps; two blocks an SM, so up to 255
                                // registers a thread (the SM's 65,536)
#define ROWS 64                 // resident rows of a block, 16 per warp
#define DOT_THREADS 256
#define SUM_THREADS 256
#define MERGE_THREADS 256
#define MERGE_BATCH 8
#define NEG_BIG (-1e30f)
#define LOG2E 1.4426950408889634f
#define LN2 0.6931471805599453f
#define SM_SMEM 233472          // shared memory of an H100 SM ...
#define BLOCK_SMEM 1024         // ... of which each resident block reserves

struct Strides {        // elements between consecutive b, s and head indices
  long long b, s, h;
};

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

// elements of a tile row in shared memory at head dim D: D and 16 bytes
template <int D, typename T>
__host__ __device__ constexpr int pitch() {
  return D + 16 / (int)sizeof(T);
}

// rows of a k tile the forward streams at head dim D (the shared memory
// budget)
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D <= 64 ? 64 : (D == 128 ? 32 : 16);
}

// The bf16 forward's block (flash_fwd_wgmma_kernel) at head dim D; its
// plan twins in kernels/_plan.py are flash_tile(d, 2) (BK),
// flash_fwd_blocks (BLOCKS) and flash_fwd_smem(d, 2) (SMEM).
template <int D>
struct WgmmaFwd {
  // keys of a k tile, the N of S = Q K^T: 32 at d = 256, where the O
  // accumulator alone takes 128 registers a thread
  static constexpr int BK = D == 256 ? 32 : 64;
  // blocks an SM, the launch bound: what the registers of S, P and O
  // (BK / 2 + BK / 8 + D / 2 a thread, and the rest) leave room for
  static constexpr int BLOCKS = D == 32 ? 4 : D == 64 ? 3 : 2;
  // a tile row as TMA writes it: a slab of 128 bytes (64 at d = 32) with
  // the swizzle of that width; d = 128 and 256 rows are 2 and 4 slabs,
  // each slab a tile of its own
  static constexpr int ROW_BYTES = D == 32 ? 64 : 128;
  static constexpr int SLAB = ROW_BYTES / 2;              // bf16 a slab row
  static constexpr int SLABS = D / SLAB;
  static constexpr uint32_t LAYOUT = D == 32 ? 2 : 1;     // wgmma.cuh
  static constexpr int Q_BYTES = 2 * ROWS * D;
  static constexpr int TILE_BYTES = 2 * BK * D;
  // the SM's share of one of BLOCKS blocks, so that exactly BLOCKS fit,
  // and as many stages of K and V as it holds beside the alignment and Q
  static constexpr int SMEM = SM_SMEM / BLOCKS - BLOCK_SMEM;
  static constexpr int STAGES = (SMEM - 1024 - Q_BYTES) / (2 * TILE_BYTES);
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

// The bf16 backward's blocks (flash_bwd_dkdv_wgmma_kernel, KV_*, and
// flash_bwd_dq_wgmma_kernel, Q_*) at head dim D; their plan twins in
// kernels/_plan.py are flash_q_tile(d, 2) (BQ), flash_dq_tile(d, 2) (BK),
// flash_bwd_blocks(d, 2) (KV_BLOCKS, Q_BLOCKS), flash_dkdv_smem(d, 2) and
// flash_dq_smem(d, 2) (KV_SMEM, Q_SMEM).
template <int D>
struct WgmmaBwd {
  // warpgroups of a block: two at d = 256, each owning half of dK/dV's
  // (dQ's) columns, since all of them would take 256 registers a thread
  static constexpr int WG = D == 256 ? 2 : 1;
  static constexpr int DC = D / WG;
  // rows of the streamed tiles, the N of the score products: dK/dV's q
  // tiles 32 at d >= 128, where dK and dV take 128 registers a thread;
  // dQ's k tiles 32 at d = 256, as the forward's
  static constexpr int BQ = D >= 128 ? 32 : 64;
  static constexpr int BK = D == 256 ? 32 : 64;
  // blocks an SM, the launch bounds: what the registers of the
  // accumulators (2 DC / 2 or DC / 2), both score tiles (BQ or BK) and
  // their bf16 A fragments leave room for
  static constexpr int KV_BLOCKS = D <= 64 ? 3 : D == 256 ? 1 : 2;
  static constexpr int Q_BLOCKS = D == 32 ? 4 : D == 64 ? 3 : D == 128 ? 2 : 1;
  // tile rows as TMA writes them: WgmmaFwd's slabs
  static constexpr int ROW_BYTES = D == 32 ? 64 : 128;
  static constexpr int SLAB = ROW_BYTES / 2;
  static constexpr int SLABS = D / SLAB;
  static constexpr uint32_t LAYOUT = D == 32 ? 2 : 1;
  static constexpr int RES_BYTES = 2 * ROWS * D;      // a resident tile
  static constexpr int KV_STAGE = 4 * BQ * D;         // a Q and a dO tile
  static constexpr int Q_STAGE = 4 * BK * D;          // a K and a V tile
  static constexpr int VEC_BYTES = 16 * BQ;           // two (lse, D) slices
  // the P / dP trade of two warpgroups (xchg_put): 2 x 4 warps x N / 8
  // C fragments of 4 floats a lane
  static constexpr int KV_XCHG = WG == 2 ? 512 * BQ : 0;
  static constexpr int Q_XCHG = WG == 2 ? 512 * BK : 0;
  // the SM's share of one of BLOCKS blocks, and as many stages as it
  // holds beside the alignment, the resident tiles and the rest
  static constexpr int KV_SMEM = SM_SMEM / KV_BLOCKS - BLOCK_SMEM;
  static constexpr int Q_SMEM = SM_SMEM / Q_BLOCKS - BLOCK_SMEM;
  static constexpr int KV_STAGES =
      (KV_SMEM - 1024 - 2 * RES_BYTES - VEC_BYTES - KV_XCHG) / KV_STAGE;
  static constexpr int Q_STAGES =
      (Q_SMEM - 1024 - 2 * RES_BYTES - Q_XCHG) / Q_STAGE;
  static_assert(KV_STAGES >= 2 && Q_STAGES >= 2,
                "rings of at least two stages");
};

// rows of the k tiles the forward over T streams: the f32 kernel's
// tile_rows, the bf16 kernel's BK
template <int D, typename T>
__host__ __device__ constexpr int fwd_tile() {
  if constexpr (is_bf16<T>) {
    return WgmmaFwd<D>::BK;
  } else {
    return tile_rows<D>();
  }
}

// whether the f32 dK/dV kernel splits each Q and dO tile into its TF32
// parts once, into tiles of their own, or each warp splits the B
// fragments it reads. At d <= 64 the split copies of 32-row q tiles fit
// two blocks an SM, and they spare the 4 warps 3 of every 4 splits of a B
// element (the same in the forward and dQ, on 32-row k tiles, lost more
// than it saved).
template <int D>
__host__ __device__ constexpr bool presplit() {
  return D <= 64;
}

// rows of a q tile the f32 dK/dV kernel streams at head dim D: 16 at d >=
// 128, so that two blocks share an SM at d = 128
template <int D>
__host__ __device__ constexpr int q_tile_rows() {
  return D <= 64 ? 32 : 16;
}

// rows of a k tile the f32 dQ kernel streams at head dim D (16 at d >=
// 128, as dK/dV's q tiles)
template <int D>
__host__ __device__ constexpr int dq_tile_rows() {
  return D <= 64 ? 64 : 16;
}

// rows of the q tiles the dK/dV kernel over T streams, and of the k tiles
// the dQ kernel streams: the f32 kernels' q_tile_rows and dq_tile_rows,
// the bf16 kernels' BQ and BK
template <int D, typename T>
__host__ __device__ constexpr int dkdv_tile() {
  if constexpr (is_bf16<T>) {
    return WgmmaBwd<D>::BQ;
  } else {
    return q_tile_rows<D>();
  }
}

template <int D, typename T>
__host__ __device__ constexpr int dq_tile() {
  if constexpr (is_bf16<T>) {
    return WgmmaBwd<D>::BK;
  } else {
    return dq_tile_rows<D>();
  }
}

// warp groups of a backward block: two at d = 256, where the resident
// tiles leave room for one block an SM, else one
template <int D>
__host__ __device__ constexpr int groups() {
  return D == 256 ? 2 : 1;
}

// floats of the P / dP exchange of a two-group block (NT n-tiles of 16 x 8
// per warp, 4 warps a group): each warp's C fragments, lane-minor
template <int D, int NT>
__host__ __device__ constexpr int xchg_floats() {
  return groups<D>() == 2 ? 2 * 4 * NT * 4 * 32 : 0;
}

// ---------------------------------------------------------------------------
// tiles and fragments
// ---------------------------------------------------------------------------

// rows r0 .. r0 + R - 1 of one head of a (B, S, heads, D) tensor into an
// (R, pitch) tile by 16-byte cp.async (4 f32 or 8 bf16); `base` points at
// (b, 0, head, 0); rows >= S are zeros
template <int D, int R, int NTH = N_THREADS, typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ tile,
                                          const T* __restrict__ base,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int E = 16 / sizeof(T), C = D / E;
  for (int idx = threadIdx.x; idx < R * C; idx += NTH) {
    const int r = idx / C, c = (idx % C) * E, row = r0 + r;
    const bool ok = row < S;
    cp_async16(reinterpret_cast<float*>(tile + r * pitch<D, T>() + c),
               reinterpret_cast<const float*>(
                   ok ? base + row * row_stride + c : base),
               ok);
  }
}

// R entries v[r0 ..] of a row vector into shared memory; past S, zeros
template <int R, int NTH = N_THREADS>
__device__ __forceinline__ void load_vec(float* __restrict__ dst,
                                         const float* __restrict__ v, int r0,
                                         int S) {
  for (int r = threadIdx.x; r < R; r += NTH) {
    const bool ok = r0 + r < S;
    cp_async4(dst + r, ok ? v + r0 + r : v, ok);
  }
}

// an (R, D + 4) f32 tile's TF32 parts, hi and lo, in the same layout
template <int D, int R>
__device__ __forceinline__ void split_tile(const float* __restrict__ x,
                                           float* __restrict__ hi,
                                           float* __restrict__ lo) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < R * C; idx += N_THREADS) {
    const int at = idx / C * (D + 4) + idx % C * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<float4*>(hi + at) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + at) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// A streamed tile as the B operand of a product: its f32 rows, split where
// a fragment is read, or (Split) its TF32 parts from split_tile. Both keep
// the f32 tile's layout; `at` moves either to an element.
struct Split {
  const float* hi;
  const float* lo;
};

__device__ __forceinline__ const float* at(const float* t, int off) {
  return t + off;
}

__device__ __forceinline__ Split at(Split t, int off) {
  return {t.hi + off, t.lo + off};
}

// the tile itself, or (PS, f32 only) its split at `parts` (hi, then lo n
// floats on)
template <bool PS, typename P>
__device__ __forceinline__ auto b_operand(P tile, const float* parts, int n) {
  if constexpr (PS) {
    return Split{parts, parts + n};
  } else {
    return tile;
  }
}

// B fragments of two k steps of an n-tile, by one ldmatrix at `t` (each)
__device__ __forceinline__ void frag_b2(const float* t, FragB& f0,
                                        FragB& f1) {
  float b[4];
  ldsm_x4(b, t);
  f0 = split_b(b[0], b[1]);
  f1 = split_b(b[2], b[3]);
}

__device__ __forceinline__ void frag_b2(Split t, FragB& f0, FragB& f1) {
  float h[4], l[4];
  ldsm_x4(h, t.hi);
  ldsm_x4(l, t.lo);
  f0 = {{__float_as_uint(h[0]), __float_as_uint(h[1])},
        {__float_as_uint(l[0]), __float_as_uint(l[1])}};
  f1 = {{__float_as_uint(h[2]), __float_as_uint(h[3])},
        {__float_as_uint(l[2]), __float_as_uint(l[3])}};
}

// the B fragment {t[0], t[ld]} (two 32-bit reads)
__device__ __forceinline__ FragB frag_b(const float* t, int ld) {
  return split_b(t[0], t[ld]);
}

__device__ __forceinline__ FragB frag_b(Split t, int ld) {
  return {{__float_as_uint(t.hi[0]), __float_as_uint(t.hi[ld])},
          {__float_as_uint(t.lo[0]), __float_as_uint(t.lo[ld])}};
}

// rows 16 w .. 16 w + 15 (the warp's), columns kk .. kk + 7 of a tile with
// pitch LD, as an A fragment
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* __restrict__ rows16,
                                        int kk, int lane) {
  float r[4];
  ldsm_x4(r, rows16 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + kk
                 + 4 * (lane >> 4));
  return split_a(r);
}

// C[16 x 8 n] += A[16 rows, D] B[8 n rows, D]^T for n-tiles n = 0 .. NT - 1
// of `Bt` (rows 8 n ..): both operands k-contiguous, read by ldmatrix; two
// k steps per round, the B tile of one n-tile over both in one ldmatrix.
// At NT <= 2 (16-row tiles) the k range's two halves accumulate apart, so
// that each warp has 2 NT chains of D / 16 products in flight instead of
// NT of D / 8, and C = (the lower half's sum) + (the upper half's)
template <int D, int NT, typename BT>
__device__ __forceinline__ void dot_rows(const float* __restrict__ A16,
                                         BT Bt, int lane, float (&c)[NT][4]) {
  constexpr int LD = D + 4;
  const auto brow = at(Bt, (lane & 7) * LD + 4 * (lane >> 3));
  if constexpr (NT > 2) {
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 16) {
      const FragA a0 = frag_a<LD>(A16, kk, lane);
      const FragA a1 = frag_a<LD>(A16, kk + 8, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        FragB b0, b1;
        frag_b2(at(brow, 8 * n * LD + kk), b0, b1);
        mma_3xtf32(c[n], a0, b0);
        mma_3xtf32(c[n], a1, b1);
      }
    }
  } else {
    constexpr int H = D / 2;
    float u[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < H; kk += 16) {
      const FragA a0 = frag_a<LD>(A16, kk, lane);
      const FragA a1 = frag_a<LD>(A16, kk + 8, lane);
      const FragA e0 = frag_a<LD>(A16, kk + H, lane);
      const FragA e1 = frag_a<LD>(A16, kk + H + 8, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        FragB b0, b1, f0, f1;
        frag_b2(at(brow, 8 * n * LD + kk), b0, b1);
        frag_b2(at(brow, 8 * n * LD + kk + H), f0, f1);
        mma_3xtf32(c[n], a0, b0);
        mma_3xtf32(u[n], e0, f0);
        mma_3xtf32(c[n], a1, b1);
        mma_3xtf32(u[n], e1, f1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += u[n][e];
  }
}

// c1 += A1 B1^T and c2 += A2 B2^T (dot_rows): one after the other, or, at
// NT <= 2, in one loop with each k range's halves apart as in dot_rows, so
// that eight accumulator chains are in flight; the same sums either way
template <int D, int NT, typename BT>
__device__ __forceinline__ void dot_pair(const float* __restrict__ A1, BT B1,
                                         const float* __restrict__ A2, BT B2,
                                         int lane, float (&c1)[NT][4],
                                         float (&c2)[NT][4]) {
  if constexpr (NT > 2) {
    dot_rows<D, NT>(A1, B1, lane, c1);
    dot_rows<D, NT>(A2, B2, lane, c2);
  } else {
    constexpr int LD = D + 4, H = D / 2;
    const int boff = (lane & 7) * LD + 4 * (lane >> 3);
    float u1[NT][4], u2[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) u1[n][e] = u2[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < H; kk += 16) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = kk + half * H;
        const FragA a0 = frag_a<LD>(A1, k0, lane);
        const FragA a1 = frag_a<LD>(A1, k0 + 8, lane);
        const FragA e0 = frag_a<LD>(A2, k0, lane);
        const FragA e1 = frag_a<LD>(A2, k0 + 8, lane);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          FragB b0, b1, f0, f1;
          frag_b2(at(B1, boff + 8 * n * LD + k0), b0, b1);
          frag_b2(at(B2, boff + 8 * n * LD + k0), f0, f1);
          float (&x1)[4] = half ? u1[n] : c1[n];
          float (&x2)[4] = half ? u2[n] : c2[n];
          mma_3xtf32(x1, a0, b0);
          mma_3xtf32(x2, e0, f0);
          mma_3xtf32(x1, a1, b1);
          mma_3xtf32(x2, e1, f1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c1[n][e] += u1[n][e];
        c2[n][e] += u2[n][e];
      }
  }
}

// acc[16 x 8 j] += P[16, 8 KT] M[8 KT, cols c0 + 8 j ..] for j < CT, with
// P held as C fragments p[KT] (columns = M's rows) and M a tile of pitch
// D + 4 read at rows 8 k + 2t, 8 k + 2t + 1
template <int D, int KT, int CT, typename BT>
__device__ __forceinline__ void mul_rows(const float (&p)[KT][4], BT M,
                                         int c0, int lane,
                                         float (&acc)[CT][4]) {
  constexpr int LD = D + 4;
  const auto m = at(M, 2 * (lane & 3) * LD + c0 + (lane >> 2));
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const FragA a = split_c_as_a(p[k]);
#pragma unroll
    for (int j = 0; j < CT; ++j)
      mma_3xtf32(acc[j], a, frag_b(at(m, 8 * k * LD + 8 * j), LD));
  }
}

// stores of two or four f32 results as T, and one element as f32
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool masked(int row, int col, int Sq, int Sk,
                                       int causal) {
  return row >= Sq || col >= Sk || (causal && col > row);
}

// number of k tiles of `bk` keys a q tile starting at q0 must visit
__device__ __forceinline__ int k_tiles(int q0, int Sq, int Sk, int bk,
                                       int causal) {
  int n = (Sk + bk - 1) / bk;
  if (causal) n = min(n, (min(q0 + ROWS, Sq) - 1) / bk + 1);
  return n;
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, b * H + h, range of k tiles)
// ---------------------------------------------------------------------------

// Range blockIdx.z holds k tiles [z chunk, (z + 1) chunk) of the q tile's
// causal ones. One range (gridDim.z == 1): o and lse. Else the range's
// partial: its unnormalised O in ws[z] (o's layout, B Sq H D floats each),
// then (m, l) per (z, b, h, row) after the gridDim.z accumulators.
// f32 (the bf16 forward is flash_fwd_wgmma_kernel).
template <int D>
__global__ void __launch_bounds__(N_THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ ws, int H,
                 int G, int Sq, int Sk, Strides sq, Strides sk, Strides sv,
                 int causal, float scale, int chunk) {
  using T = float;
  constexpr int BK = tile_rows<D>(), LD = pitch<D, T>(), NT = BK / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) float smem[];
  T* Qs = reinterpret_cast<T*>(smem);   // (ROWS, LD)
  T* Ks = Qs + ROWS * LD;               // 2 stages x (BK, LD)
  T* Vs = Ks + 2 * BK * LD;             // 2 stages x (BK, LD)
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int n_kt = k_tiles(q0, Sq, Sk, BK, causal);
  const int kt_lo = blockIdx.z * chunk;
  if (kt_lo >= n_kt) return;      // past this q tile's tiles: no partial
  const int kt_hi = min(n_kt, kt_lo + chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  load_tile<D, ROWS>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<D, BK>(Ks, kb, sk.s, kt_lo * BK, Sk);
  load_tile<D, BK>(Vs, vb, sv.s, kt_lo * BK, Sk);
  cp_async_commit();

  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const T* Qw = Qs + 16 * warp * LD;
  const int row0 = q0 + 16 * warp + g;      // this thread's rows: +0, +8
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BK;
    if (kt + 1 < kt_hi) {
      load_tile<D, BK>(Ks + (st ^ 1) * BK * LD, kb, sk.s, k0 + BK, Sk);
      load_tile<D, BK>(Vs + (st ^ 1) * BK * LD, vb, sv.s, k0 + BK, Sk);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    dot_rows<D, NT>(Qw, (const T*)(Ks + st * BK * LD), lane, s);  // Q K^T

    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rows past Sq are never stored, so only columns are masked here
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (edge && (col >= Sk || (causal && col > row))) x = NEG_BIG;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e >> 1];
    mul_rows<D, NT, DT>(s, (const T*)(Vs + st * BK * LD), 0, lane,
                        acc);                                    // O += P V
    __syncthreads();              // this stage's readers are done
  }
  // a row whose keys in this range are all masked keeps m = -1e30 (its
  // l and O are then sums of e^0 terms): the merge weighs it by
  // e^(-1e30 - m) = 0, as range 0, which holds key 0, is live for every row
  const long long n_o = (long long)gridDim.y * Sq * D;     // o's size
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float sum = quad_sum(l[r]);
    if (row >= Sq) continue;
    const long long at = (((long long)b * Sq + row) * H + h) * D + 2 * t;
    if (gridDim.z == 1) {
      const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
      for (int i = 0; i < DT; ++i)
        store2(o + at + 8 * i, acc[i][2 * r] / denom,
               acc[i][2 * r + 1] / denom);
      if (t == 0) lse[((long long)b * H + h) * Sq + row] = m[r] + logf(sum);
    } else {
      float* part = ws + blockIdx.z * n_o + at;
#pragma unroll
      for (int i = 0; i < DT; ++i)
        store2(part + 8 * i, acc[i][2 * r], acc[i][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(
            ws + gridDim.z * n_o
            + 2 * ((((long long)blockIdx.z * gridDim.y + blockIdx.y) * Sq)
                   + row)) = make_float2(m[r], sum);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on wgmma: one block per (q tile, b * H + h, range of k tiles)
// ---------------------------------------------------------------------------

// Range blockIdx.z holds k tiles [z chunk, (z + 1) chunk) of the q tile's
// causal ones, and writes what flash_fwd_kernel writes (o and lse, or the
// range's partial), from the same online softmax: S = Q K^T and O += P V
// are wgmma products of the block's one warpgroup, Q and K from swizzled
// shared memory, P from registers (its S accumulator rounded to bf16), V
// MN-major from shared memory. Thread 0 brings Q, then K and V tiles into
// a ring of STAGES stages by TMA, each stage's copies completing on its
// mbarrier, and refills a stage once the whole block has multiplied it.
// Scores are kept in log2 units (scale log2(e) folded in, exp2).
template <int D>
__global__ void __launch_bounds__(N_THREADS, WgmmaFwd<D>::BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       float* __restrict__ ws, int H, int G, int Sq, int Sk,
                       int causal, float scale, int chunk) {
  using C = WgmmaFwd<D>;
  constexpr int BK = C::BK, NT = BK / 8, DT = D / 8, NS = C::STAGES;
  constexpr int RB = C::ROW_BYTES, KS = C::SLAB / 16;  // k steps a slab
  extern __shared__ __align__(16) uint8_t smem_wg[];
  // the tiles from the first 1,024-byte boundary (the swizzle's atoms);
  // the barriers in the gap before them, or after them where it is short
  const uint32_t gap = (1024 - (smem_u32(smem_wg) & 1023)) & 1023;
  uint8_t* Qs = smem_wg + gap;                 // SLABS x (ROWS, RB)
  uint8_t* Ks = Qs + C::Q_BYTES;               // NS x SLABS x (BK, RB)
  uint8_t* Vs = Ks + NS * C::TILE_BYTES;       // NS x SLABS x (BK, RB)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gap >= 8 * (NS + 1) ? smem_wg : Vs + NS * C::TILE_BYTES);
  uint64_t* q_full = full + NS;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int n_kt = k_tiles(q0, Sq, Sk, BK, causal);
  const int kt_lo = blockIdx.z * chunk;
  if (kt_lo >= n_kt) return;      // past this q tile's tiles: no partial
  const int n = min(n_kt, kt_lo + chunk) - kt_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // tile kt_lo + i of K and V into stage i % NS, one box a slab
  const CUtensorMap *mk = &tk, *mv = &tv;
  auto load_kv = [&](int i) {
    const int st = i % NS, k0 = (kt_lo + i) * BK;
    mbar_expect_tx(full + st, 2 * C::TILE_BYTES);
#pragma unroll
    for (int s = 0; s < C::SLABS; ++s) {
      const int at = st * C::TILE_BYTES + s * BK * RB;
      tma_load_4d(Ks + at, mk, full + st, s * C::SLAB, kvh, k0, b);
      tma_load_4d(Vs + at, mv, full + st, s * C::SLAB, kvh, k0, b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch(mk);
    tma_prefetch(mv);
    mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
    for (int s = 0; s < C::SLABS; ++s)
      tma_load_4d(Qs + s * ROWS * RB, &tq, q_full, s * C::SLAB, h, q0, b);
    for (int i = 0; i < min(NS, n); ++i) load_kv(i);
  }

  // descriptors of stage 0's K and V tiles and of Q, moved by byte offsets
  const uint64_t dq = smem_desc(Qs, 16, 8 * RB, C::LAYOUT);
  const uint64_t dk = smem_desc(Ks, 16, 8 * RB, C::LAYOUT);
  const uint64_t dv = smem_desc(Vs, BK * RB, 8 * RB, C::LAYOUT);
  const float sl2 = scale * LOG2E;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int row0 = q0 + 16 * warp + g;      // this thread's rows: +0, +8
  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % NS, k0 = (kt_lo + i) * BK;
    mbar_wait(full + st, (i / NS) & 1);
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    wgmma_fence();                                            // S = Q K^T
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int slab = kk / KS, at = (kk % KS) * 32;
      wgmma_ss<BK>(s, desc_at(dq, slab * ROWS * RB + at),
                   desc_at(dk, st * C::TILE_BYTES + slab * BK * RB + at),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rows past Sq are never stored, so only columns are masked here
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * sl2;
        if (edge && (col >= Sk || (causal && col > row))) x = NEG_BIG;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t p[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) c_as_a(s[2 * j], s[2 * j + 1], p[j]);
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    wgmma_fence();                                            // O += P V
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      wgmma_rs<D>(acc, p[j], desc_at(dv, st * C::TILE_BYTES + j * 16 * RB));
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(p);
    __syncthreads();              // every warp's products on `st` are done
    if (threadIdx.x == 0 && i + NS < n) load_kv(i + NS);
  }
  // as flash_fwd_kernel's, with m back in natural-log units
  const long long n_o = (long long)gridDim.y * Sq * D;     // o's size
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float sum = quad_sum(l[r]), mr = m[r] * LN2;
    if (row >= Sq) continue;
    const long long at = (((long long)b * Sq + row) * H + h) * D + 2 * t;
    if (gridDim.z == 1) {
      const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
      for (int i = 0; i < DT; ++i)
        store2(o + at + 8 * i, acc[i][2 * r] / denom,
               acc[i][2 * r + 1] / denom);
      if (t == 0) lse[((long long)b * H + h) * Sq + row] = mr + logf(sum);
    } else {
      float* part = ws + blockIdx.z * n_o + at;
#pragma unroll
      for (int i = 0; i < DT; ++i)
        store2(part + 8 * i, acc[i][2 * r], acc[i][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(
            ws + gridDim.z * n_o
            + 2 * ((((long long)blockIdx.z * gridDim.y + blockIdx.y) * Sq)
                   + row)) = make_float2(mr, sum);
    }
  }
}

// o and lse from the forward's partials: block (b * Sq + row, y), one
// thread per four elements of the row's H D, merging the row's live
// ranges in increasing order (online_merge.cuh); the thread of column 0
// writes lse = m + log l
template <int D, typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
flash_fwd_merge_kernel(const float* __restrict__ ws, T* __restrict__ o,
                       float* __restrict__ lse, int B, int H, int Sq, int Sk,
                       int causal, int chunk, int split) {
  const int e = 4 * (blockIdx.y * MERGE_THREADS + threadIdx.x);  // h D + c
  if (e >= H * D) return;
  const int h = e / D, row = blockIdx.x % Sq, b = blockIdx.x / Sq;
  const int n_kt = k_tiles(row / ROWS * ROWS, Sq, Sk, fwd_tile<D, T>(),
                           causal);
  const long long n_o = (long long)B * Sq * H * D;          // o's size
  const long long i = (long long)blockIdx.x * H * D + e;    // in o
  const long long bhr = ((long long)b * H + h) * Sq + row;
  const float* ml = ws + split * n_o + 2 * bhr;             // + z step
  const long long step = 2LL * B * H * Sq;
  const MergedState<float4> r = ordered_merge<MERGE_BATCH, float4>(
      0, (n_kt - 1) / chunk, [&](int z) { return ml[z * step]; },
      [&](int z) { return ml[z * step + 1]; },
      [&](int z) {
        return *reinterpret_cast<const float4*>(ws + z * n_o + i);
      });
  const float denom = fmaxf(r.l, 1e-30f);
  store4(o + i, make_float4(r.o.x / denom, r.o.y / denom, r.o.z / denom,
                            r.o.w / denom));
  if (e % D == 0) lse[bhr] = r.m + logf(r.l);
}

// ---------------------------------------------------------------------------
// backward 1: D = rowsum(dO * O), one warp per (b, s, h) row
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(DOT_THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                     float* __restrict__ Dout, int H, int Sq,
                     long long rows) {
  const long long row =
      ((long long)blockIdx.x * DOT_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;        // uniform across the warp
  const T* orow = o + row * D;
  const T* drow = dO + row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
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
// backward 2: dK, dV of one (k tile, b * H + h, range)
// ---------------------------------------------------------------------------

// A C fragment set p[NT][4] of one warp to the exchange slot x (lane-minor,
// so a warp's 32 lanes store and load 32 consecutive floats), and back
template <int NT>
__device__ __forceinline__ void xchg_put(float* x, const float (&p)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 * n + e) * 32] = p[n][e];
}

template <int NT>
__device__ __forceinline__ void xchg_get(const float* x, float (&p)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[n][e] = x[(4 * n + e) * 32];
}

// The write-out of a dK/dV block (b, query head h, k tile, range
// blockIdx.z): its keys key0 and key0 + 8 (this lane's C rows), columns c0
// + 8 j + 2 (lane % 4); dK (times the scale) and dV in T where G = 1 and
// one range, else the f32 partial (h % G) split + range, in the order
// flash_sum_parts_kernel adds them.
template <int D, int CT, typename T>
__device__ __forceinline__ void write_dkdv(
    const float (&dk_acc)[CT][4], const float (&dv_acc)[CT][4],
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ parts, int H,
    int G, int Sk, int key0, int c0, float scale, int split) {
  const int b = blockIdx.y / H, h = blockIdx.y % H, KV = H / G, kvh = h / G;
  const int t = threadIdx.x % 4;
  const long long n_out = (long long)gridDim.y / H * Sk * KV * D;
  const int n_parts = G * split;
  const long long part = (long long)(h % G) * split + blockIdx.z;
  float* part_k = parts + part * n_out;
  float* part_v = parts + (n_parts + part) * n_out;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const long long off = (((long long)b * Sk + key) * KV + kvh) * D + c0
                          + 2 * t;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float xk = dk_acc[j][2 * r] * scale;
      const float yk = dk_acc[j][2 * r + 1] * scale;
      if (n_parts == 1) {
        store2(dk + off + 8 * j, xk, yk);
        store2(dv + off + 8 * j, dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      } else {
        store2(part_k + off + 8 * j, xk, yk);
        store2(part_v + off + 8 * j, dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
      }
    }
  }
}

// The write-out of a dQ block (b, h, q tile, range blockIdx.z): its rows
// row0 and row0 + 8, columns c0 + 8 i + 2 (lane % 4), times the scale;
// dQ in T where there is one range, else f32 partial blockIdx.z.
template <int D, int CT, typename T>
__device__ __forceinline__ void write_dq(const float (&acc)[CT][4],
                                         T* __restrict__ dq,
                                         float* __restrict__ parts, int H,
                                         int Sq, int row0, int c0,
                                         float scale, int split) {
  const int b = blockIdx.y / H, h = blockIdx.y % H, t = threadIdx.x % 4;
  const long long n_out = (long long)gridDim.y * Sq * D;   // dq's size
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const long long off = (((long long)b * Sq + row) * H + h) * D + c0 + 2 * t;
#pragma unroll
    for (int i = 0; i < CT; ++i) {
      const float x = acc[i][2 * r] * scale, y = acc[i][2 * r + 1] * scale;
      if (split == 1)
        store2(dq + off + 8 * i, x, y);
      else
        store2(parts + blockIdx.z * n_out + off + 8 * i, x, y);
    }
  }
}

// f32 (the bf16 kernel is flash_bwd_dkdv_wgmma_kernel).
template <int D>
__global__ void __launch_bounds__(128 * groups<D>(), 3 - groups<D>())
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ Dd, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ parts,
                      int H, int G, int Sq, int Sk, Strides sq, Strides sk,
                      Strides sv, int causal, float scale, int split,
                      int chunk) {
  using T = float;
  constexpr int WG = groups<D>(), NTH = 128 * WG;
  constexpr int BQ = q_tile_rows<D>(), DC = D / WG;
  constexpr int LD = pitch<D, T>(), NT = BQ / 8, CT = DC / 8;
  // a ring stage: Q (BQ, LD) and dO (BQ, LD) of T, lse (BQ) and D (BQ) f32
  constexpr int STAGE = 2 * BQ * LD * (int)sizeof(T) + 2 * BQ * 4;  // bytes
  constexpr bool PS = presplit<D>();
  extern __shared__ __align__(16) float smem[];
  T* Ks = reinterpret_cast<T*>(smem);   // (ROWS, LD)
  T* Vs = Ks + ROWS * LD;               // (ROWS, LD)
  char* ring = reinterpret_cast<char*>(Vs + ROWS * LD);   // 2 stages
  float* Qp = reinterpret_cast<float*>(ring + 2 * STAGE);  // PS: this Q
                                  // tile's TF32 hi, lo (BQ, LD) each
  float* dOp = Qp + 2 * BQ * LD;  // PS: dO's
  float* X = reinterpret_cast<float*>(ring + 2 * STAGE);  // WG = 2: P^T
                                  // (group 0), dP^T (group 1)
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int range = blockIdx.z;
  const int k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp % 4, grp = warp / 4, c0 = grp * DC;
  const int g = lane / 4, t = lane % 4;
  const long long do_s = (long long)H * D;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dO + (long long)b * Sq * do_s + h * D;
  const float* lse_h = lse + ((long long)b * H + h) * Sq;
  const float* D_h = Dd + ((long long)b * H + h) * Sq;
  // this block's q tiles: range `range`, of `chunk` tiles, of those at or
  // above the diagonal; past them, none (with partials, no work at all)
  const int nq = (Sq + BQ - 1) / BQ;
  const int first = causal ? min(k0 / BQ, nq) : 0;
  const int qt_lo = min(nq, first + range * chunk);
  const int qt_hi = min(nq, qt_lo + chunk);
  if (G * split > 1 && qt_lo >= qt_hi) return;   // the sum skips it

  load_tile<D, ROWS, NTH>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, Sk);
  load_tile<D, ROWS, NTH>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, Sk);
  auto load_q = [&](char* st, int qt) {
    T* Qt = reinterpret_cast<T*>(st);
    float* vecs = reinterpret_cast<float*>(Qt + 2 * BQ * LD);
    load_tile<D, BQ, NTH>(Qt, qb, sq.s, qt * BQ, Sq);
    load_tile<D, BQ, NTH>(Qt + BQ * LD, dob, do_s, qt * BQ, Sq);
    load_vec<BQ, NTH>(vecs, lse_h, qt * BQ, Sq);
    load_vec<BQ, NTH>(vecs + BQ, D_h, qt * BQ, Sq);
  };
  if (qt_lo < qt_hi) load_q(ring, qt_lo);
  cp_async_commit();

  float dk_acc[CT][4], dv_acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const T* Kw = Ks + 16 * kw * LD;
  const T* Vw = Vs + 16 * kw * LD;
  const int key0 = k0 + 16 * kw + g;        // this thread's keys: +0, +8
  float* Xw = X + (grp * 4 + kw) * NT * 4 * 32 + lane;        // mine
  const float* Xo = X + ((1 - grp) * 4 + kw) * NT * 4 * 32 + lane;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    char* st = ring + ((qt - qt_lo) & 1) * STAGE;
    if (qt + 1 < qt_hi) {
      load_q(ring + ((qt + 1 - qt_lo) & 1) * STAGE, qt + 1);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const T* Qt = reinterpret_cast<const T*>(st);
    const T* dOt = Qt + BQ * LD;
    const float* lse_s = reinterpret_cast<const float*>(dOt + BQ * LD);
    const float* D_s = lse_s + BQ;
    const int q0 = qt * BQ;
    if constexpr (PS) {
      split_tile<D, BQ>(Qt, Qp, Qp + BQ * LD);
      split_tile<D, BQ>(dOt, dOp, dOp + BQ * LD);
      __syncthreads();
    }
    const auto Qb = b_operand<PS>(Qt, Qp, BQ * LD);
    const auto dOb = b_operand<PS>(dOt, dOp, BQ * LD);
    float sT[NT][4], dpT[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
    if constexpr (WG == 1)
      dot_pair<D, NT>(Kw, Qb, Vw, dOb, lane, sT, dpT);   // S^T, dP^T (k, q)
    else if (grp == 0)
      dot_rows<D, NT>(Kw, Qb, lane, sT);                 // S^T
    else
      dot_rows<D, NT>(Vw, dOb, lane, dpT);               // dP^T
    const bool edge = q0 + BQ > Sq || k0 + ROWS > Sk
                      || (causal && k0 + ROWS - 1 > q0);
    // P^T = exp(S^T - lse), masked; dS^T = P^T (dP^T - D)
    auto p_of = [&](int n, int e) {
      const int c = 8 * n + 2 * t + (e & 1);
      const float p = expf(sT[n][e] * scale - lse_s[c]);
      return edge && masked(q0 + c, key0 + 8 * (e >> 1), Sq, Sk, causal)
                 ? 0.f : p;
    };
    if constexpr (WG == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = p_of(n, e);
          sT[n][e] = p;
          dpT[n][e] = p * (dpT[n][e] - D_s[8 * n + 2 * t + (e & 1)]);
        }
    } else {                     // trade P^T and dP^T between the groups
      if (grp == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[n][e] = p_of(n, e);
        xchg_put<NT>(Xw, sT);
      } else {
        xchg_put<NT>(Xw, dpT);
      }
      __syncthreads();
      if (grp == 0) xchg_get<NT>(Xo, dpT); else xchg_get<NT>(Xo, sT);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpT[n][e] = sT[n][e] * (dpT[n][e] - D_s[8 * n + 2 * t + (e & 1)]);
    }
    mul_rows<D, NT, CT>(sT, dOb, c0, lane, dv_acc);  // dV += P^T dO
    mul_rows<D, NT, CT>(dpT, Qb, c0, lane, dk_acc);  // dK += dS^T Q
    __syncthreads();              // this stage's (and X's) readers are done
  }
  cp_async_wait_all();            // an empty range leaves K, V in flight
  write_dkdv<D>(dk_acc, dv_acc, dk, dv, parts, H, G, Sk, key0, c0, scale,
                split);
}

// Ranges with work among a row's partials: dK/dV rows are keys (their k
// tile's q tiles of `tile` rows, from its diagonal), dQ rows queries
// (their q tile's k tiles of `tile` keys), cut into ranges of `chunk`
__device__ __forceinline__ int live_ranges(bool key_rows, int row, int Sq,
                                           int Sk, int tile, int causal,
                                           int chunk) {
  if (key_rows) {
    const int nq = (Sq + tile - 1) / tile;
    const int first = causal ? min(row / ROWS * ROWS / tile, nq) : 0;
    return (nq - first + chunk - 1) / chunk;
  }
  return (k_tiles(row / ROWS * ROWS, Sq, Sk, tile, causal) + chunk - 1)
         / chunk;
}

// out[y] (n4 float4, written as T) = the partials of its row with work,
// parts[y][g split + r] for g < G, r < the row's live ranges (each n4
// float4), summed in that order; y = blockIdx.y. A row of `row4` float4,
// S_rows rows a batch.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
flash_sum_parts_kernel(const float4* __restrict__ parts, T* out0, T* out1,
                       int G, int split, long long n4, int row4, int S_rows,
                       int key_rows, int Sq, int Sk, int tile, int causal,
                       int chunk) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n4) return;
  const int row = (int)((i / row4) % S_rows);
  const int live = live_ranges(key_rows, row, Sq, Sk, tile, causal, chunk);
  const float4* src = parts + blockIdx.y * G * split * n4 + i;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g)
    for (int r = 0; r < live; ++r) {
      const float4 x = src[(g * split + r) * n4];
      if (g == 0 && r == 0) {
        acc = x;
      } else {
        acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z,
                          acc.w + x.w);
      }
    }
  store4((blockIdx.y ? out1 : out0) + 4 * i, acc);
}

// ---------------------------------------------------------------------------
// backward 3: dQ of one (q tile, b * H + h, range of its k tiles)
// ---------------------------------------------------------------------------

// f32 (the bf16 kernel is flash_bwd_dq_wgmma_kernel).
template <int D>
__global__ void __launch_bounds__(128 * groups<D>(), 3 - groups<D>())
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dd, float* __restrict__ dq,
                    float* __restrict__ parts, int H, int G, int Sq, int Sk,
                    Strides sq, Strides sk, Strides sv, int causal,
                    float scale, int split, int chunk) {
  using T = float;
  constexpr int WG = groups<D>(), NTH = 128 * WG;
  constexpr int BK = dq_tile_rows<D>(), LD = pitch<D, T>(), NT = BK / 8;
  constexpr int DC = D / WG, CT = DC / 8;
  extern __shared__ __align__(16) float smem[];
  T* Qs = reinterpret_cast<T*>(smem);   // (ROWS, LD)
  T* dOs = Qs + ROWS * LD;              // (ROWS, LD)
  T* Ks = dOs + ROWS * LD;              // 2 stages x (BK, LD)
  T* Vs = Ks + 2 * BK * LD;             // 2 stages x (BK, LD)
  float* X = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // WG = 2: P
                                        // (group 0), dP (group 1)
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp % 4, grp = warp / 4, c0 = grp * DC;
  const int g = lane / 4, t = lane % 4;
  const long long do_s = (long long)H * D;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  // this block's k tiles: range blockIdx.z, of `chunk` tiles, of those at
  // or below the diagonal; past them, none (with partials, no work at all)
  const int n_kt = k_tiles(q0, Sq, Sk, BK, causal);
  const int kt_lo = min(n_kt, (int)blockIdx.z * chunk);
  const int kt_hi = min(n_kt, kt_lo + chunk);
  if (split > 1 && kt_lo >= kt_hi) return;       // the sum skips it
  load_tile<D, ROWS, NTH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<D, ROWS, NTH>(dOs, dO + (long long)b * Sq * do_s + h * D, do_s,
                          q0, Sq);
  if (kt_lo < kt_hi) {
    load_tile<D, BK, NTH>(Ks, kb, sk.s, kt_lo * BK, Sk);
    load_tile<D, BK, NTH>(Vs, vb, sv.s, kt_lo * BK, Sk);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * qw + g;        // this thread's rows: +0, +8
  float lse_r[2], D_r[2], acc[CT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + row;
    lse_r[r] = row < Sq ? lse[at] : 0.f;
    D_r[r] = row < Sq ? Dd[at] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const T* Qw = Qs + 16 * qw * LD;
  const T* dOw = dOs + 16 * qw * LD;
  float* Xw = X + (grp * 4 + qw) * NT * 4 * 32 + lane;        // mine
  const float* Xo = X + ((1 - grp) * 4 + qw) * NT * 4 * 32 + lane;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1, k0 = kt * BK;
    if (kt + 1 < kt_hi) {
      load_tile<D, BK, NTH>(Ks + (st ^ 1) * BK * LD, kb, sk.s, k0 + BK, Sk);
      load_tile<D, BK, NTH>(Vs + (st ^ 1) * BK * LD, vb, sv.s, k0 + BK, Sk);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * LD;
    const T* Vt = Vs + st * BK * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (WG == 1)
      dot_pair<D, NT>(Qw, Kt, dOw, Vt, lane, s, dp);    // S, dP (q, k)
    else if (grp == 0)
      dot_rows<D, NT>(Qw, Kt, lane, s);                  // S
    else
      dot_rows<D, NT>(dOw, Vt, lane, dp);                // dP
    const bool edge = q0 + ROWS > Sq || k0 + BK > Sk
                      || (causal && k0 + BK - 1 > q0);
    // P = exp(S - lse), masked; dS = P (dP - D), into s
    auto p_of = [&](int n, int e) {
      const int r = e >> 1;
      const float p = expf(s[n][e] * scale - lse_r[r]);
      return edge && masked(row0 + 8 * r, k0 + 8 * n + 2 * t + (e & 1), Sq,
                            Sk, causal)
                 ? 0.f : p;
    };
    if constexpr (WG == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p_of(n, e) * (dp[n][e] - D_r[e >> 1]);
    } else {                     // trade P and dP between the groups
      if (grp == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = p_of(n, e);
        xchg_put<NT>(Xw, s);
      } else {
        xchg_put<NT>(Xw, dp);
      }
      __syncthreads();
      if (grp == 0) xchg_get<NT>(Xo, dp); else xchg_get<NT>(Xo, s);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] * (dp[n][e] - D_r[e >> 1]);
    }
    mul_rows<D, NT, CT>(s, Kt, c0, lane, acc);    // dQ += dS K
    __syncthreads();              // this stage's (and X's) readers are done
  }
  cp_async_wait_all();            // an empty range leaves Q, dO in flight
  write_dq<D>(acc, dq, parts, H, Sq, row0, c0, scale, split);
}

// ---------------------------------------------------------------------------
// bf16 backward on wgmma: dK, dV of one (k tile, b * H + h, range); dQ of
// one (q tile, b * H + h, range)
// ---------------------------------------------------------------------------

// Range blockIdx.z holds q tiles [z chunk, (z + 1) chunk) of those at or
// above the k tile's diagonal, and the block writes what
// flash_bwd_dkdv_kernel writes (dK/dV, or the f32 partial (h % G) split +
// z), with its WG warpgroups over the k tile's 64 keys. Thread 0 brings K
// and V once, then the Q and dO tiles of its q tiles into a ring of
// KV_STAGES stages by TMA, each stage's copies completing on its mbarrier,
// and refills a stage once the block has multiplied it; thread x < 2 BQ
// stages entry x of the next q tile's lse (in log2 units) and D. Per q
// tile: S^T = K Q^T and dP^T = V dO^T (wgmma_ss, both operands K-major),
// then P^T = 2^(S^T scale log2 e - lse log2 e), masked, and dS^T = P^T
// (dP^T - D) in registers, then dV += P^T dO and dK += dS^T Q (wgmma_rs:
// P^T and dS^T rounded to bf16 from their accumulators, dO and Q read
// MN-major from the same tiles through a second descriptor). At d = 256
// warpgroup 0 forms S^T and P^T, warpgroup 1 dP^T; they trade them
// through shared memory, and each accumulates half of dK's and dV's
// columns.
template <int D>
__global__ void __launch_bounds__(128 * WgmmaBwd<D>::WG,
                                  WgmmaBwd<D>::KV_BLOCKS)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ Dd,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            float* __restrict__ parts, int H, int G, int Sq,
                            int Sk, int causal, float scale, int split,
                            int chunk) {
  using C = WgmmaBwd<D>;
  constexpr int BQ = C::BQ, NT = BQ / 8, DC = C::DC, CT = DC / 8;
  constexpr int NS = C::KV_STAGES, RB = C::ROW_BYTES, KS = C::SLAB / 16;
  constexpr int HALF = C::KV_STAGE / 2;       // a stage: Q, then dO
  extern __shared__ __align__(16) uint8_t smem_wg[];
  // the tiles from the first 1,024-byte boundary; the barriers in the gap
  // before them, or after everything where it is short
  const uint32_t gap = (1024 - (smem_u32(smem_wg) & 1023)) & 1023;
  uint8_t* Ks = smem_wg + gap;                // SLABS x (ROWS, RB)
  uint8_t* Vs = Ks + C::RES_BYTES;            // SLABS x (ROWS, RB)
  uint8_t* ring = Vs + C::RES_BYTES;          // NS x 2 x SLABS x (BQ, RB)
  float* vec = reinterpret_cast<float*>(ring + NS * C::KV_STAGE);
                                  // 2 slots x (lse log2 e, D) x BQ
  float* X = vec + 4 * BQ;        // WG = 2: P^T (warpgroup 0), dP^T (1)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gap >= 8 * (NS + 1) ? smem_wg
                          : reinterpret_cast<uint8_t*>(X) + C::KV_XCHG);
  uint64_t* kv_full = full + NS;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int range = blockIdx.z;
  const int k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp % 4, grp = warp / 4, c0 = grp * DC;
  const int g = lane / 4, t = lane % 4;
  // this block's q tiles, as flash_bwd_dkdv_kernel's
  const int nq = (Sq + BQ - 1) / BQ;
  const int first = causal ? min(k0 / BQ, nq) : 0;
  const int qt_lo = min(nq, first + range * chunk);
  const int n = min(nq, qt_lo + chunk) - qt_lo;
  if (G * split > 1 && n == 0) return;        // the sum skips it
  const float* lse_h = lse + ((long long)b * H + h) * Sq;
  const float* D_h = Dd + ((long long)b * H + h) * Sq;
  // this thread's entry of q tile qt_lo + i's slice: lse log2 e (x < BQ)
  // or D (x < 2 BQ); zero past Sq and past the block's tiles
  auto vec_entry = [&](int i) {
    const int x = threadIdx.x, row = (qt_lo + i) * BQ + x % BQ;
    if (x >= 2 * BQ || i >= n || row >= Sq) return 0.f;
    return x < BQ ? lse_h[row] * LOG2E : D_h[row];
  };
  // q tile qt_lo + i of Q and dO into stage i % NS, one box a slab
  const CUtensorMap *mq = &tq, *mdo = &tdo;
  auto load_q = [&](int i) {
    const int st = i % NS, q0 = (qt_lo + i) * BQ;
    uint8_t* at = ring + st * C::KV_STAGE;
    mbar_expect_tx(full + st, C::KV_STAGE);
#pragma unroll
    for (int s = 0; s < C::SLABS; ++s) {
      tma_load_4d(at + s * BQ * RB, mq, full + st, s * C::SLAB, h, q0, b);
      tma_load_4d(at + HALF + s * BQ * RB, mdo, full + st, s * C::SLAB, h,
                  q0, b);
    }
  };
  if (n > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s <= NS; ++s) mbar_init(full + s, 1);
      mbar_init_fence();
    }
    if (threadIdx.x < 2 * BQ) vec[threadIdx.x] = vec_entry(0);
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_prefetch(mq);
      tma_prefetch(mdo);
      mbar_expect_tx(kv_full, 2 * C::RES_BYTES);
#pragma unroll
      for (int s = 0; s < C::SLABS; ++s) {
        tma_load_4d(Ks + s * ROWS * RB, &tk, kv_full, s * C::SLAB, kvh, k0,
                    b);
        tma_load_4d(Vs + s * ROWS * RB, &tv, kv_full, s * C::SLAB, kvh, k0,
                    b);
      }
      for (int i = 0; i < min(NS, n); ++i) load_q(i);
    }
  }

  // descriptors: K and V as the A operands (K-major); stage 0's Q and dO
  // as the B operands of the scores (K-major) and, from this warpgroup's
  // columns, of dK and dV (MN-major); moved by byte offsets
  const uint64_t dKa = smem_desc(Ks, 16, 8 * RB, C::LAYOUT);
  const uint64_t dVa = smem_desc(Vs, 16, 8 * RB, C::LAYOUT);
  const uint64_t dQk = smem_desc(ring, 16, 8 * RB, C::LAYOUT);
  const uint64_t dOk = smem_desc(ring + HALF, 16, 8 * RB, C::LAYOUT);
  const uint64_t dQm = smem_desc(ring, BQ * RB, 8 * RB, C::LAYOUT);
  const uint64_t dOm = smem_desc(ring + HALF, BQ * RB, 8 * RB, C::LAYOUT);
  const uint32_t cols = grp * (DC / C::SLAB) * BQ * RB;
  const float sl2 = scale * LOG2E;
  float dk_acc[CT][4], dv_acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int key0 = k0 + 16 * kw + g;        // this thread's keys: +0, +8
  float* Xw = X + (grp * 4 + kw) * NT * 4 * 32 + lane;        // mine
  const float* Xo = X + ((1 - grp) * 4 + kw) * NT * 4 * 32 + lane;
  if (n > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % NS, q0 = (qt_lo + i) * BQ;
    const uint32_t so = st * C::KV_STAGE;
    const float next = vec_entry(i + 1);
    mbar_wait(full + st, (i / NS) & 1);
    float sT[NT][4], dpT[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    wgmma_fence();                          // S^T = K Q^T, dP^T = V dO^T
    if (C::WG == 1 || grp == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int slab = kk / KS, at = (kk % KS) * 32;
        wgmma_ss<BQ>(sT, desc_at(dKa, slab * ROWS * RB + at),
                     desc_at(dQk, so + slab * BQ * RB + at), kk > 0);
      }
    }
    if (C::WG == 1 || grp == 1) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int slab = kk / KS, at = (kk % KS) * 32;
        wgmma_ss<BQ>(dpT, desc_at(dVa, slab * ROWS * RB + at),
                     desc_at(dOk, so + slab * BQ * RB + at), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(sT);
    hold(dpT);

    const float* lse_s = vec + (i & 1) * 2 * BQ;
    const float* D_s = lse_s + BQ;
    const bool edge = q0 + BQ > Sq || k0 + ROWS > Sk
                      || (causal && k0 + ROWS - 1 > q0);
    // P^T = 2^(S^T scale log2 e - lse log2 e), masked; dS^T = P^T (dP^T - D)
    auto p_of = [&](int j, int e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const float p = exp2f(fmaf(sT[j][e], sl2, -lse_s[c]));
      return edge && masked(q0 + c, key0 + 8 * (e >> 1), Sq, Sk, causal)
                 ? 0.f : p;
    };
    if constexpr (C::WG == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = p_of(j, e);
          sT[j][e] = p;
          dpT[j][e] = p * (dpT[j][e] - D_s[8 * j + 2 * t + (e & 1)]);
        }
    } else {                     // trade P^T and dP^T between warpgroups
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[j][e] = p_of(j, e);
        xchg_put<NT>(Xw, sT);
      } else {
        xchg_put<NT>(Xw, dpT);
      }
      __syncthreads();
      if (grp == 0) xchg_get<NT>(Xo, dpT); else xchg_get<NT>(Xo, sT);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpT[j][e] = sT[j][e] * (dpT[j][e] - D_s[8 * j + 2 * t + (e & 1)]);
    }
    uint32_t pa[NT / 2][4], da[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      c_as_a(sT[2 * j], sT[2 * j + 1], pa[j]);
      c_as_a(dpT[2 * j], dpT[2 * j + 1], da[j]);
    }
    wgmma_fence();                          // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      wgmma_rs<DC>(dv_acc, pa[j], desc_at(dOm, so + cols + j * 16 * RB));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      wgmma_rs<DC>(dk_acc, da[j], desc_at(dQm, so + cols + j * 16 * RB));
    wgmma_commit();
    wgmma_wait_all();
    hold(dv_acc);
    hold(dk_acc);
    hold(pa);
    hold(da);
    if (threadIdx.x < 2 * BQ) vec[((i + 1) & 1) * 2 * BQ + threadIdx.x] = next;
    __syncthreads();              // the block's products on `st` are done
    if (threadIdx.x == 0 && i + NS < n) load_q(i + NS);
  }

  write_dkdv<D>(dk_acc, dv_acc, dk, dv, parts, H, G, Sk, key0, c0, scale,
                split);
}

// Range blockIdx.z holds k tiles [z chunk, (z + 1) chunk) of the q tile's
// causal ones, and the block writes what flash_bwd_dq_kernel writes (dQ,
// or the f32 partial z), with its WG warpgroups over the q tile's 64
// queries: Q and dO come once by TMA, the K and V tiles through a ring of
// Q_STAGES stages. Per k tile: S = Q K^T and dP = dO V^T (wgmma_ss), P
// and dS = P (dP - D) in registers (lse and D of the thread's two rows
// held from the start), then dQ += dS K (wgmma_rs, K read MN-major from
// the tile the scores read K-major). At d = 256 the warpgroups split S
// and dP and trade them, as in dK/dV, and each owns half of dQ's columns.
template <int D>
__global__ void __launch_bounds__(128 * WgmmaBwd<D>::WG,
                                  WgmmaBwd<D>::Q_BLOCKS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ Dd, bf16* __restrict__ dq,
                          float* __restrict__ parts, int H, int G, int Sq,
                          int Sk, int causal, float scale, int split,
                          int chunk) {
  using C = WgmmaBwd<D>;
  constexpr int BK = C::BK, NT = BK / 8, DC = C::DC, CT = DC / 8;
  constexpr int NS = C::Q_STAGES, RB = C::ROW_BYTES, KS = C::SLAB / 16;
  constexpr int HALF = C::Q_STAGE / 2;        // a stage: K, then V
  extern __shared__ __align__(16) uint8_t smem_wg[];
  const uint32_t gap = (1024 - (smem_u32(smem_wg) & 1023)) & 1023;
  uint8_t* Qs = smem_wg + gap;                // SLABS x (ROWS, RB)
  uint8_t* dOs = Qs + C::RES_BYTES;           // SLABS x (ROWS, RB)
  uint8_t* ring = dOs + C::RES_BYTES;         // NS x 2 x SLABS x (BK, RB)
  float* X = reinterpret_cast<float*>(ring + NS * C::Q_STAGE);
                                  // WG = 2: P (warpgroup 0), dP (1)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      gap >= 8 * (NS + 1) ? smem_wg
                          : reinterpret_cast<uint8_t*>(X) + C::Q_XCHG);
  uint64_t* q_full = full + NS;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp % 4, grp = warp / 4, c0 = grp * DC;
  const int g = lane / 4, t = lane % 4;
  // this block's k tiles, as flash_bwd_dq_kernel's
  const int n_kt = k_tiles(q0, Sq, Sk, BK, causal);
  const int kt_lo = min(n_kt, (int)blockIdx.z * chunk);
  const int n = min(n_kt, kt_lo + chunk) - kt_lo;
  if (split > 1 && n == 0) return;            // the sum skips it
  // k tile kt_lo + i of K and V into stage i % NS, one box a slab
  const CUtensorMap *mk = &tk, *mv = &tv;
  auto load_kv = [&](int i) {
    const int st = i % NS, k0 = (kt_lo + i) * BK;
    uint8_t* at = ring + st * C::Q_STAGE;
    mbar_expect_tx(full + st, C::Q_STAGE);
#pragma unroll
    for (int s = 0; s < C::SLABS; ++s) {
      tma_load_4d(at + s * BK * RB, mk, full + st, s * C::SLAB, kvh, k0, b);
      tma_load_4d(at + HALF + s * BK * RB, mv, full + st, s * C::SLAB, kvh,
                  k0, b);
    }
  };
  if (n > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s <= NS; ++s) mbar_init(full + s, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_prefetch(mk);
      tma_prefetch(mv);
      mbar_expect_tx(q_full, 2 * C::RES_BYTES);
#pragma unroll
      for (int s = 0; s < C::SLABS; ++s) {
        tma_load_4d(Qs + s * ROWS * RB, &tq, q_full, s * C::SLAB, h, q0, b);
        tma_load_4d(dOs + s * ROWS * RB, &tdo, q_full, s * C::SLAB, h, q0,
                    b);
      }
      for (int i = 0; i < min(NS, n); ++i) load_kv(i);
    }
  }

  const int row0 = q0 + 16 * qw + g;        // this thread's rows: +0, +8
  float lse_r[2], D_r[2], acc[CT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + row;
    lse_r[r] = row < Sq ? lse[at] * LOG2E : 0.f;
    D_r[r] = row < Sq ? Dd[at] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < CT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // descriptors: Q and dO as the A operands (K-major); stage 0's K and V
  // as the B operands of the scores (K-major), and K, from this
  // warpgroup's columns, of dQ (MN-major)
  const uint64_t dQa = smem_desc(Qs, 16, 8 * RB, C::LAYOUT);
  const uint64_t dOa = smem_desc(dOs, 16, 8 * RB, C::LAYOUT);
  const uint64_t dKk = smem_desc(ring, 16, 8 * RB, C::LAYOUT);
  const uint64_t dVk = smem_desc(ring + HALF, 16, 8 * RB, C::LAYOUT);
  const uint64_t dKm = smem_desc(ring, BK * RB, 8 * RB, C::LAYOUT);
  const uint32_t cols = grp * (DC / C::SLAB) * BK * RB;
  const float sl2 = scale * LOG2E;
  float* Xw = X + (grp * 4 + qw) * NT * 4 * 32 + lane;        // mine
  const float* Xo = X + ((1 - grp) * 4 + qw) * NT * 4 * 32 + lane;
  if (n > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % NS, k0 = (kt_lo + i) * BK;
    const uint32_t so = st * C::Q_STAGE;
    mbar_wait(full + st, (i / NS) & 1);
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    wgmma_fence();                          // S = Q K^T, dP = dO V^T
    if (C::WG == 1 || grp == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int slab = kk / KS, at = (kk % KS) * 32;
        wgmma_ss<BK>(s, desc_at(dQa, slab * ROWS * RB + at),
                     desc_at(dKk, so + slab * BK * RB + at), kk > 0);
      }
    }
    if (C::WG == 1 || grp == 1) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int slab = kk / KS, at = (kk % KS) * 32;
        wgmma_ss<BK>(dp, desc_at(dOa, slab * ROWS * RB + at),
                     desc_at(dVk, so + slab * BK * RB + at), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
    hold(dp);

    const bool edge = q0 + ROWS > Sq || k0 + BK > Sk
                      || (causal && k0 + BK - 1 > q0);
    // P = 2^(S scale log2 e - lse log2 e), masked; dS = P (dP - D), into s
    auto p_of = [&](int j, int e) {
      const int r = e >> 1;
      const float p = exp2f(fmaf(s[j][e], sl2, -lse_r[r]));
      return edge && masked(row0 + 8 * r, k0 + 8 * j + 2 * t + (e & 1), Sq,
                            Sk, causal)
                 ? 0.f : p;
    };
    if constexpr (C::WG == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p_of(j, e) * (dp[j][e] - D_r[e >> 1]);
    } else {                     // trade P and dP between warpgroups
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = p_of(j, e);
        xchg_put<NT>(Xw, s);
      } else {
        xchg_put<NT>(Xw, dp);
      }
      __syncthreads();
      if (grp == 0) xchg_get<NT>(Xo, dp); else xchg_get<NT>(Xo, s);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (dp[j][e] - D_r[e >> 1]);
    }
    uint32_t da[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) c_as_a(s[2 * j], s[2 * j + 1], da[j]);
    wgmma_fence();                                            // dQ += dS K
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      wgmma_rs<DC>(acc, da[j], desc_at(dKm, so + cols + j * 16 * RB));
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(da);
    __syncthreads();              // the block's products on `st` are done
    if (threadIdx.x == 0 && i + NS < n) load_kv(i + NS);
  }

  write_dq<D>(acc, dq, parts, H, Sq, row0, c0, scale, split);
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

// shared memory bytes of each kernel's block, the one place the launchers
// and flash_attention_occupancy read them (kernels/_plan.py::
// flash_fwd_smem, flash_dkdv_smem, flash_dq_smem model them for the plans,
// given the element size)
template <int D, typename T>
constexpr size_t fwd_smem() {
  if constexpr (is_bf16<T>) {
    return WgmmaFwd<D>::SMEM;
  } else {
    return sizeof(T) * (ROWS + 4 * tile_rows<D>()) * pitch<D, T>();
  }
}

// the forward kernel over T: flash_fwd_kernel in f32, the wgmma kernel in
// bf16
template <int D, typename T>
static const void* fwd_kernel() {
  if constexpr (is_bf16<T>) {
    return (const void*)flash_fwd_wgmma_kernel<D>;
  } else {
    return (const void*)flash_fwd_kernel<D>;
  }
}

template <int D, typename T>
constexpr size_t dkdv_smem() {
  if constexpr (is_bf16<T>) {
    return WgmmaBwd<D>::KV_SMEM;
  } else {
    constexpr int BQ = q_tile_rows<D>(), LD = pitch<D, T>();
    return sizeof(T) * (2 * ROWS * LD + 2 * 2 * BQ * LD)
           + sizeof(float) * (2 * 2 * BQ + 4 * presplit<D>() * BQ * LD
                              + xchg_floats<D, BQ / 8>());
  }
}

template <int D, typename T>
constexpr size_t dq_smem() {
  if constexpr (is_bf16<T>) {
    return WgmmaBwd<D>::Q_SMEM;
  } else {
    constexpr int BT = dq_tile_rows<D>(), LD = pitch<D, T>();
    return sizeof(T) * (2 * ROWS * LD + 4 * BT * LD)
           + sizeof(float) * xchg_floats<D, BT / 8>();
  }
}

// the dK/dV and dQ kernels over T: the f32 mma.sync kernels, the bf16
// wgmma kernels
template <int D, typename T>
static const void* dkdv_kernel() {
  if constexpr (is_bf16<T>) {
    return (const void*)flash_bwd_dkdv_wgmma_kernel<D>;
  } else {
    return (const void*)flash_bwd_dkdv_kernel<D>;
  }
}

template <int D, typename T>
static const void* dq_kernel() {
  if constexpr (is_bf16<T>) {
    return (const void*)flash_bwd_dq_wgmma_kernel<D>;
  } else {
    return (const void*)flash_bwd_dq_kernel<D>;
  }
}

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *out, *dq, *dk, *dv;
  float *lse_out, *Dd, *parts;
  int B, H, KV, Sq, Sk, causal, split, dq_split, chunk, dq_chunk;
  Strides sq, sk, sv;
  float scale;
  cudaStream_t stream;
};

// cuTensorMapEncodeTiled, from the driver through the runtime (no libcuda
// at link time), or null where the driver lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The TMA map of a (B, S, heads, D) bf16 tensor read through its strides
// (elements; multiples of 8, as `valid` checks): dims D, heads, S, B
// (innermost first), boxes of `rows` rows of one head by a slab of
// WgmmaFwd<D>::SLAB columns with the slab's swizzle. Rows past S read as
// zeros (the ragged tail).
template <int D>
static cudaError_t tile_map(CUtensorMap* map, const void* base, int heads,
                            int S, int B, const Strides& st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2 * (cuuint64_t)st.h, 2 * (cuuint64_t)st.s,
                                 2 * (cuuint64_t)st.b};
  const cuuint32_t box[4] = {(cuuint32_t)WgmmaFwd<D>::SLAB, 1,
                             (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the bf16 forward's launch: q, k and v's tensor maps, then the kernel
template <int D>
static cudaError_t launch_fwd_wgmma(const Args& a, dim3 grid) {
  using C = WgmmaFwd<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tile_map<D>(&tq, a.q, a.H, a.Sq, a.B, a.sq, ROWS);
  if (err == cudaSuccess)
    err = tile_map<D>(&tk, a.k, a.KV, a.Sk, a.B, a.sk, C::BK);
  if (err == cudaSuccess)
    err = tile_map<D>(&tv, a.v, a.KV, a.Sk, a.B, a.sv, C::BK);
  if (err == cudaSuccess)
    err = allow_smem(flash_fwd_wgmma_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D><<<grid, N_THREADS, C::SMEM, a.stream>>>(
      tq, tk, tv, (bf16*)a.out, a.lse_out, a.parts, a.H, a.H / a.KV, a.Sq,
      a.Sk, a.causal, a.scale, a.chunk);
  return cudaGetLastError();
}

// the tensor maps of q, k, v and dO (contiguous) for a bf16 backward
// kernel, m[0 .. 3]: boxes of q_rows rows of q and dO, kv_rows of k and v
template <int D>
static cudaError_t bwd_maps(const Args& a, int q_rows, int kv_rows,
                            CUtensorMap (&m)[4]) {
  const Strides so = {(long long)a.Sq * a.H * D, (long long)a.H * D, D};
  cudaError_t err = tile_map<D>(&m[0], a.q, a.H, a.Sq, a.B, a.sq, q_rows);
  if (err == cudaSuccess)
    err = tile_map<D>(&m[1], a.k, a.KV, a.Sk, a.B, a.sk, kv_rows);
  if (err == cudaSuccess)
    err = tile_map<D>(&m[2], a.v, a.KV, a.Sk, a.B, a.sv, kv_rows);
  if (err == cudaSuccess)
    err = tile_map<D>(&m[3], a.dO, a.H, a.Sq, a.B, so, q_rows);
  return err;
}

// the dK/dV kernel over T on its grid; the bf16 kernel after its tensor
// maps (q and dO in q tiles, k and v in the resident 64 rows)
template <int D, typename T>
static cudaError_t launch_dkdv(const Args& a, dim3 grid) {
  constexpr size_t smem = dkdv_smem<D, T>();
  const int G = a.H / a.KV;
  cudaError_t err = allow_smem(dkdv_kernel<D, T>(), smem);
  if constexpr (is_bf16<T>) {
    using C = WgmmaBwd<D>;
    CUtensorMap m[4];
    if (err == cudaSuccess) err = bwd_maps<D>(a, C::BQ, ROWS, m);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_wgmma_kernel<D><<<grid, 128 * C::WG, smem, a.stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.Dd, (bf16*)a.dk, (bf16*)a.dv,
        a.parts, a.H, G, a.Sq, a.Sk, a.causal, a.scale, a.split, a.chunk);
  } else {
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<D><<<grid, 128 * groups<D>(), smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dO, a.lse,
        a.Dd, (T*)a.dk, (T*)a.dv, a.parts, a.H, G, a.Sq, a.Sk, a.sq, a.sk,
        a.sv, a.causal, a.scale, a.split, a.chunk);
  }
  return cudaGetLastError();
}

// the dQ kernel over T on its grid, its partials at `parts`; the bf16
// kernel after its tensor maps (q and dO in the resident 64 rows, k and v
// in k tiles)
template <int D, typename T>
static cudaError_t launch_dq(const Args& a, dim3 grid, float* parts) {
  constexpr size_t smem = dq_smem<D, T>();
  const int G = a.H / a.KV;
  cudaError_t err = allow_smem(dq_kernel<D, T>(), smem);
  if constexpr (is_bf16<T>) {
    using C = WgmmaBwd<D>;
    CUtensorMap m[4];
    if (err == cudaSuccess) err = bwd_maps<D>(a, ROWS, C::BK, m);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wgmma_kernel<D><<<grid, 128 * C::WG, smem, a.stream>>>(
        m[0], m[1], m[2], m[3], a.lse, a.Dd, (bf16*)a.dq, parts, a.H, G,
        a.Sq, a.Sk, a.causal, a.scale, a.dq_split, a.dq_chunk);
  } else {
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D><<<grid, 128 * groups<D>(), smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dO, a.lse,
        a.Dd, (T*)a.dq, parts, a.H, G, a.Sq, a.Sk, a.sq, a.sk, a.sv,
        a.causal, a.scale, a.dq_split, a.dq_chunk);
  }
  return cudaGetLastError();
}

// `split` ranges of `chunk` k tiles each (kernels/_plan.py::
// flash_fwd_plan); with split > 1, a.parts holds split B Sq H D partial
// accumulators, then split B H Sq (m, l) pairs
template <int D, typename T>
static int launch_fwd(const Args& a) {
  constexpr int BK = fwd_tile<D, T>();
  if ((long long)a.split * a.chunk < (a.Sk + BK - 1) / BK)
    return (int)cudaErrorInvalidValue;       // the ranges miss k tiles
  dim3 grid((unsigned)((a.Sq + ROWS - 1) / ROWS), (unsigned)(a.B * a.H),
            (unsigned)a.split);
  cudaError_t err;
  if constexpr (is_bf16<T>) {
    err = launch_fwd_wgmma<D>(a, grid);
  } else {
    constexpr size_t smem = fwd_smem<D, T>();
    err = allow_smem(flash_fwd_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<D><<<grid, N_THREADS, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.lse_out,
        a.parts, a.H, a.H / a.KV, a.Sq, a.Sk, a.sq, a.sk, a.sv, a.causal,
        a.scale, a.chunk);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || a.split == 1) return (int)err;
  dim3 grid_m((unsigned)(a.B * a.Sq),
              (unsigned)((a.H * D / 4 + MERGE_THREADS - 1) / MERGE_THREADS));
  flash_fwd_merge_kernel<D, T><<<grid_m, MERGE_THREADS, 0, a.stream>>>(
      a.parts, (T*)a.out, a.lse_out, a.B, a.H, a.Sq, a.Sk, a.causal, a.chunk,
      a.split);
  return (int)cudaGetLastError();
}

// `split` ranges of `chunk` q tiles per dK/dV block and `dq_split` ranges
// of `dq_chunk` k tiles per dQ block (kernels/_plan.py)
template <int D, typename T>
static int launch_bwd(const Args& a) {
  constexpr int BT = dq_tile<D, T>(), BQ = dkdv_tile<D, T>();
  if ((long long)a.split * a.chunk < (a.Sq + BQ - 1) / BQ
      || (long long)a.dq_split * a.dq_chunk < (a.Sk + BT - 1) / BT)
    return (int)cudaErrorInvalidValue;       // the ranges miss tiles
  const int G = a.H / a.KV;
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_dot_kernel<D, T><<<(unsigned)((rows * 32 + DOT_THREADS - 1)
                                          / DOT_THREADS),
                               DOT_THREADS, 0, a.stream>>>(
      (const T*)a.o, (const T*)a.dO, a.Dd, a.H, a.Sq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 grid_kv((unsigned)((a.Sk + ROWS - 1) / ROWS), (unsigned)(a.B * a.H),
               (unsigned)a.split);
  err = launch_dkdv<D, T>(a, grid_kv);
  if (err != cudaSuccess) return (int)err;
  // the partials: 2 G split of dk's size, then dq_split of dq's
  const int n_parts = G * a.split;
  const long long n_kv4 = (long long)a.B * a.Sk * a.KV * D / 4;
  float* parts_q = a.parts + (n_parts > 1 ? 2 * n_parts * n_kv4 * 4 : 0);
  if (n_parts > 1) {
    dim3 grid_sum((unsigned)((n_kv4 + SUM_THREADS - 1) / SUM_THREADS), 2);
    flash_sum_parts_kernel<T><<<grid_sum, SUM_THREADS, 0, a.stream>>>(
        (const float4*)a.parts, (T*)a.dk, (T*)a.dv, G, a.split, n_kv4,
        a.KV * D / 4, a.Sk, 1, a.Sq, a.Sk, BQ, a.causal, a.chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  dim3 grid_q((unsigned)((a.Sq + ROWS - 1) / ROWS), (unsigned)(a.B * a.H),
              (unsigned)a.dq_split);
  err = launch_dq<D, T>(a, grid_q, parts_q);
  if (err != cudaSuccess || a.dq_split == 1) return (int)err;
  const long long n_q4 = (long long)a.B * a.Sq * a.H * D / 4;
  flash_sum_parts_kernel<T><<<(unsigned)((n_q4 + SUM_THREADS - 1)
                                         / SUM_THREADS),
                              SUM_THREADS, 0, a.stream>>>(
      (const float4*)parts_q, (T*)a.dq, (T*)nullptr, 1, a.dq_split, n_q4,
      a.H * D / 4, a.Sq, 0, a.Sq, a.Sk, BT, a.causal, a.dq_chunk);
  return (int)cudaGetLastError();
}

// head dims 32, 64, 128, 256 (the ported configs')
template <bool FWD, typename T>
static int dispatch(int d, const Args& a) {
  switch (d) {
    case 32: return FWD ? launch_fwd<32, T>(a) : launch_bwd<32, T>(a);
    case 64: return FWD ? launch_fwd<64, T>(a) : launch_bwd<64, T>(a);
    case 128: return FWD ? launch_fwd<128, T>(a) : launch_bwd<128, T>(a);
    case 256: return FWD ? launch_fwd<256, T>(a) : launch_bwd<256, T>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// shape, and the 16-byte alignment cp.async needs of q, k, v (strides in
// elements of `esize` bytes)
static bool valid(const Args& a, int esize) {
  const Strides* st[3] = {&a.sq, &a.sk, &a.sv};
  const long long m = 16 / esize - 1;
  for (const Strides* s : st)
    if ((s->b | s->s | s->h) & m) return false;
  return a.B > 0 && a.KV > 0 && a.H % a.KV == 0 && a.Sq > 0 && a.Sk > 0
         && (long long)a.B * a.H <= 65535 && aligned16(a.q)
         && aligned16(a.k) && aligned16(a.v);
}

static Args make_args(const void* q, const void* k, const void* v, int B,
                      int H, int KV, int Sq, int Sk, int d, long long qsb,
                      long long qss, long long qsh, long long ksb,
                      long long kss, long long ksh, long long vsb,
                      long long vss, long long vsh, int causal,
                      void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B; a.H = H; a.KV = KV; a.Sq = Sq; a.Sk = Sk; a.causal = causal;
  a.split = a.dq_split = a.chunk = a.dq_chunk = 1;
  a.sq = {qsb, qss, qsh};
  a.sk = {ksb, kss, ksh};
  a.sv = {vsb, vss, vsh};
  a.scale = 1.0f / sqrtf((float)d);
  a.stream = (cudaStream_t)stream;
  return a;
}

static int fwd_entry(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int KV, int Sq, int Sk, int d,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, int causal,
                     int split, int chunk, void* ws, void* stream,
                     int esize) {
  Args a = make_args(q, k, v, B, H, KV, Sq, Sk, d, qsb, qss, qsh, ksb, kss,
                     ksh, vsb, vss, vsh, causal, stream);
  if (!valid(a, esize) || split < 1 || chunk < 1 || split > 65535
      || (split > 1 && !aligned16(ws)))
    return (int)cudaErrorInvalidValue;
  a.out = o;
  a.lse_out = (float*)lse;
  a.parts = (float*)ws;
  a.split = split;
  a.chunk = chunk;
  return esize == 4 ? dispatch<true, float>(d, a)
                    : dispatch<true, bf16>(d, a);
}

// `split` ranges of `chunk` k tiles per q tile (kernels/_plan.py::
// flash_fwd_plan); `ws` holds split (B Sq H d + 2 B H Sq) floats when
// split > 1
extern "C" int flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Sk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int split,
    int chunk, void* ws, void* stream) {
  return fwd_entry(q, k, v, o, lse, B, H, KV, Sq, Sk, d, qsb, qss, qsh, ksb,
                   kss, ksh, vsb, vss, vsh, causal, split, chunk, ws, stream,
                   4);
}

// the same over bf16 q, k, v and o (lse and ws f32)
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Sq, int Sk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int split,
    int chunk, void* ws, void* stream) {
  return fwd_entry(q, k, v, o, lse, B, H, KV, Sq, Sk, d, qsb, qss, qsh, ksb,
                   kss, ksh, vsb, vss, vsh, causal, split, chunk, ws, stream,
                   2);
}

static int bwd_entry(const void* q, const void* k, const void* v,
                     const void* o, const void* dO, const void* lse, void* Dd,
                     void* dq, void* dk, void* dv, int B, int H, int KV,
                     int Sq, int Sk, int d, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, int causal, int split, int chunk,
                     int dq_split, int dq_chunk, void* parts, void* stream,
                     int esize) {
  Args a = make_args(q, k, v, B, H, KV, Sq, Sk, d, qsb, qss, qsh, ksb, kss,
                     ksh, vsb, vss, vsh, causal, stream);
  if (!valid(a, esize) || split < 1 || dq_split < 1 || chunk < 1
      || dq_chunk < 1 || split > 65535 || dq_split > 65535 || !aligned16(dO)
      || (((H / KV) * split > 1 || dq_split > 1) && !aligned16(parts)))
    return (int)cudaErrorInvalidValue;
  a.o = o;
  a.dO = dO;
  a.lse = (const float*)lse;
  a.Dd = (float*)Dd;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.parts = (float*)parts;
  a.split = split;
  a.chunk = chunk;
  a.dq_split = dq_split;
  a.dq_chunk = dq_chunk;
  return esize == 4 ? dispatch<false, float>(d, a)
                    : dispatch<false, bf16>(d, a);
}

// `split` ranges of `chunk` q tiles per dK/dV block and `dq_split` ranges
// of `dq_chunk` k tiles per dQ block (kernels/_plan.py); `parts` holds 2
// (H / KV) split partials of dk's size when (H / KV) split > 1, then
// dq_split of dq's when dq_split > 1
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* Dd, void* dq, void* dk, void* dv,
    int B, int H, int KV, int Sq, int Sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int split, int chunk, int dq_split, int dq_chunk, void* parts,
    void* stream) {
  return bwd_entry(q, k, v, o, dO, lse, Dd, dq, dk, dv, B, H, KV, Sq, Sk, d,
                   qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, split,
                   chunk, dq_split, dq_chunk, parts, stream, 4);
}

// the same over bf16 q, k, v, o, dO, dq, dk and dv (lse, D and the
// partials f32)
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* Dd, void* dq, void* dk, void* dv,
    int B, int H, int KV, int Sq, int Sk, int d, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int split, int chunk, int dq_split, int dq_chunk, void* parts,
    void* stream) {
  return bwd_entry(q, k, v, o, dO, lse, Dd, dq, dk, dv, B, H, KV, Sq, Sk, d,
                   qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, split,
                   chunk, dq_split, dq_chunk, parts, stream, 2);
}

// kind 0, 1, 2: the forward, dK/dV or dQ kernel at head dim D over T;
// its threads, shared memory bytes, and the blocks an SM holds at
// once as the runtime reports them for that launch
template <int D, typename T>
static int occupancy(int kind, int* threads, int* smem, int* blocks) {
  const void* fn = kind == 0 ? fwd_kernel<D, T>()
                 : kind == 1 ? dkdv_kernel<D, T>() : dq_kernel<D, T>();
  const size_t bytes = kind == 0 ? fwd_smem<D, T>()
                     : kind == 1 ? dkdv_smem<D, T>() : dq_smem<D, T>();
  *threads = kind == 0 ? N_THREADS : 128 * groups<D>();
  *smem = (int)bytes;
  cudaError_t err = allow_smem(fn, bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            *threads, bytes);
}

template <typename T>
static int occupancy_of(int d, int kind, int* threads, int* smem,
                        int* blocks) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return occupancy<32, T>(kind, threads, smem, blocks);
    case 64: return occupancy<64, T>(kind, threads, smem, blocks);
    case 128: return occupancy<128, T>(kind, threads, smem, blocks);
    case 256: return occupancy<256, T>(kind, threads, smem, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_occupancy(int d, int kind, int* threads,
                                         int* smem, int* blocks) {
  return occupancy_of<float>(d, kind, threads, smem, blocks);
}

extern "C" int flash_attention_occupancy_bf16(int d, int kind, int* threads,
                                              int* smem, int* blocks) {
  return occupancy_of<bf16>(d, kind, threads, smem, blocks);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
