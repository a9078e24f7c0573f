// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/serve/attention_paged.py::_paged_kernel
// (pallas_call at :158, wrapper pallas_paged_attention). Computes, for every
// slot s and query head h, one decode step of attention over the slot's
// paged KV cache:
//
//   o[s, h] = softmax_k(q[s, h] . K[k] / sqrt(dh) + mask) @ V
//
// where key position k = page * ps + row is read from physical page
// table[s, page], query head h reads KV head h / G, and the mask keeps
// k <= lengths[s] and, with a window, k > lengths[s] - window. Positions
// come from the table column index, never from page contents, so whatever
// scratch page 0 or a page's unwritten rows hold never reaches a live slot.
//
// Bound on this card: decode attention is bytes-bound. It reads each live
// K/V row once (2 * KV * dh * 4 bytes per live key per slot) and does 4
// flops per loaded float for each of the G query heads of a group (at most
// 8 in the served models), so the least time is the live K/V bytes over
// 3.35 TB/s. Tensor cores would buy nothing, so every product here is f32
// SIMT.
//
// Design. Two kernels, no atomics:
//  * paged_partial_kernel, grid (n_chunks, KV, S), 128 threads: one block
//    per (chunk of pages, KV head, slot). The plan (kernels/_plan.py::
//    paged_plan, a function of P, ps and dh alone) cuts every slot's table
//    into chunks of pages_per_chunk pages, so a long context spreads over
//    many blocks and short ones over a few. A block reads its own
//    lengths[s] and table entries (the TPU kernel got them by scalar
//    prefetch), works out the live keys [lo, hi] (k <= len, and k > len -
//    window), and returns at once if its chunk holds none. Otherwise it
//    issues every 16-byte cp.async of its chunk before it waits on any: q
//    and the K rows as one group, the V rows as a second, so V lands while
//    the scores are computed (the plan bounds a chunk to 16 KB of K, so the
//    whole chunk fits and a ring would only delay the later copies). A
//    (key, kv) row is dh contiguous floats at a stride of KV * dh.
//    Scores: LK lanes per key (key_lanes: as few as fill the block, so at
//    most a few shuffles), each lane float4s of dh, four query heads at a
//    time on each loaded K float4. The softmax of the chunk: one warp per
//    query head, max and sum by warp shuffles. P.V: threads over (key
//    part, dh/4), float4 accumulators in registers for four query heads
//    at a time on each loaded V float4, the key parts then summed in order
//    through shared memory. Out: the chunk's (m, l) and unnormalised acc.
//  * paged_merge_kernel, grid (ceil(G * dh / 128), KV, S), one thread per
//    output element: merges a slot's live chunks in increasing chunk
//    order, m = max m_c, l = sum l_c exp(m_c - m), o = sum acc_c
//    exp(m_c - m) / max(l, 1e-30), the TPU kernel's online recurrence and
//    _flush (attention_paged.py:115-129) over chunks, with the loads of
//    MERGE_BATCH chunks issued before any is used (online_merge.cuh, the
//    recurrence the flash forward's merge shares).
// Every sum of slot s runs in an order fixed by the plan and s's own
// length, so its bits do not depend on the other slots or on S, and two
// calls give the same bits.
//
// bf16 (paged_attention_bf16): q, the K/V pool and the output in bf16,
// everything else as above in f32. The same 16-byte cp.async copies (8
// bf16) stage the chunk, which then takes half the shared memory; each
// read from shared memory takes 4 bf16 (8 bytes) and converts them to a
// float4, so the scores, the online softmax, P.V and the merge
// (online_merge.cuh) run in f32, and the merge writes bf16. The bytes
// bound halves with the K/V bytes. The plan's chunks hold 16 KB of K as in
// f32, so twice the keys (kernels/_plan.py::paged_plan's esize).
//
// Envelope (checked by the Python wrapper, and again here): float32 or
// bfloat16, contiguous 16-byte aligned tensors, dh a multiple of 16 bytes
// (dh % 4 == 0 in f32, % 8 in bf16), dh <= 256, ps <= 64, int32 table and
// lengths, lengths[s] < P * ps (the engine writes the key at lengths[s]
// before it attends), smem_bytes() within 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "online_merge.cuh"

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)
#define N_THREADS 128
#define N_WARPS (N_THREADS / 32)
#define MERGE_BATCH 8

// the live key positions [lo, hi] of a slot of length len
__device__ __forceinline__ void live_keys(int len, int window, int n_keys,
                                          int* lo, int* hi) {
  *hi = min(len, n_keys - 1);
  *lo = window > 0 ? min(max(0, len - window + 1), *hi) : 0;
}

// Lanes per key in the score loop: the largest power of two that is at
// most dh / 4, at most 32, and keeps LK * C within the block, so a chunk's
// keys take one pass over the block with the fewest shuffles.
__host__ __device__ __forceinline__ int key_lanes(int C, int quads) {
  int LK = 1;
  while (2 * LK <= quads && 2 * LK <= 32 && 2 * LK * C <= N_THREADS) LK <<= 1;
  return LK;
}

// The K rows' pitch in elements (kernels/_plan.py::paged_k_pitch). f32:
// dh, padded by whole float4s so that the 8 lanes of each 16-byte load
// phase (8 / LK keys x LK lanes) fall on distinct banks. bf16 (8-byte
// loads): dh, or dh + 8 where a key's quads are not read by neighbouring
// lanes (LK < dh / 4), keeping rows 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ int k_pitch(int dh, int LK) {
  const int quads = dh >> 2;
  if (sizeof(T) == 2) return dh + 8 * (LK < quads);
  return dh + 4 * (LK < 8 ? ((LK - quads) % 8 + 8) % 8 : 0);
}

// kernels/_plan.py::paged_smem_bytes: K, V and q rows of T, then the f32
// P.V partial sums and scores and the int32 cache rows
template <typename T>
static size_t smem_bytes(int chunk_pages, int ps, int G, int dh) {
  const int C = chunk_pages * ps;
  const size_t pitch = k_pitch<T>(dh, key_lanes(C, dh >> 2));
  return sizeof(T) * ((size_t)C * pitch + (size_t)C * dh + (size_t)G * dh)
         + 4 * (16 * N_THREADS + (size_t)G * C + C);
}

// four consecutive elements as a float4 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *(const float4*)p;
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *(const uint2*)p;
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
  const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float from_f32(float x, float) { return x; }

__device__ __forceinline__ bf16 from_f32(float x, bf16) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(N_THREADS)
paged_partial_kernel(const T* __restrict__ q,          // (S, KV * G, dh)
                     const T* __restrict__ k,          // (NP, ps, KV, dh)
                     const T* __restrict__ v,          // (NP, ps, KV, dh)
                     const int* __restrict__ table,    // (S, P)
                     const int* __restrict__ lengths,  // (S,)
                     float* __restrict__ acc_ws,  // (S, KV, n_chunks, G, dh)
                     float* __restrict__ ml_ws,   // (S, KV, n_chunks, G, 2)
                     int P, int ps, int KV, int G, int dh, int window,
                     float scale, int chunk_pages, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int kv = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int C = chunk_pages * ps;          // keys of a whole chunk
  const int quads = dh >> 2;
  const int LK = key_lanes(C, quads);
  const int kp = k_pitch<T>(dh, LK);

  T* k_s = reinterpret_cast<T*>(smem);     // (C, kp)
  T* v_s = k_s + (size_t)C * kp;           // (C, dh)
  T* q_s = v_s + (size_t)C * dh;           // (G, dh)
  float4* red_s = (float4*)(q_s + (size_t)G * dh);   // (4 * N_THREADS,)
  float* p_s = (float*)(red_s + 4 * N_THREADS);      // (G, C)
  int* rows_s = (int*)(p_s + (size_t)G * C);         // (C,)

  // the length, and the cache row (physical page * ps + slot) of each key
  // of the chunk, read together
  const int len = lengths[s];
  const int key0 = c * C;
  for (int jj = tid; jj < C; jj += N_THREADS) {
    const int pg = (key0 + jj) / ps;
    rows_s[jj] = pg < P ? table[(size_t)s * P + pg] * ps + (key0 + jj - pg * ps)
                        : 0;
  }
  int lo, hi;
  live_keys(len, window, P * ps, &lo, &hi);
  const int k0 = max(lo, key0);
  const int k1 = min(hi, key0 + C - 1);
  if (k0 > k1) return;                     // no live key: the merge skips c
  const int n = k1 - k0 + 1;
  const int* rows = rows_s + (k0 - key0);

  // 16-byte copies: E elements each, W = dh / E of a row
  constexpr int E = 16 / sizeof(T);
  const int W = dh / E;
  const T* q_blk = q + ((size_t)s * KV + kv) * G * dh;
  for (int i = tid; i < G * W; i += N_THREADS)
    cp_async16((float*)(q_s + E * i), (const float*)(q_blk + E * i), true);
  __syncthreads();                         // rows_s

  // a thread copies the 16 bytes w of keys r0w, r0w + per_copy, ... (K,
  // then V)
  const size_t row_stride = (size_t)KV * dh;
  const int per_copy = N_THREADS / W;
  const int r0w = tid / W;
  const int w = tid - r0w * W;
  const T* k_head = k + (size_t)kv * dh + E * w;
  const T* v_head = v + (size_t)kv * dh + E * w;
  if (r0w < per_copy) {
    for (int j = r0w; j < n; j += per_copy)
      cp_async16((float*)(k_s + (size_t)j * kp + E * w),
                 (const float*)(k_head + (size_t)rows[j] * row_stride), true);
  }
  cp_async_commit();                       // group 0: q and K
  if (r0w < per_copy) {
    for (int j = r0w; j < n; j += per_copy)
      cp_async16((float*)(v_s + (size_t)j * dh + E * w),
                 (const float*)(v_head + (size_t)rows[j] * row_stride), true);
  }
  cp_async_commit();                       // group 1: V
  cp_async_wait_prior();
  __syncthreads();

  // scores: LK lanes per key, float4 over dh, four query heads at a time
  // on each loaded K float4
  const int ql = tid & (LK - 1);
  for (int j0 = 0; j0 < n; j0 += N_THREADS / LK) {
    const int j = j0 + tid / LK;
    const bool ok = j < n;
    const T* krow = k_s + (size_t)(ok ? j : 0) * kp;
    for (int g0 = 0; g0 < G; g0 += 4) {
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int x4 = ql; x4 < quads; x4 += LK) {
        const float4 b = load4(krow + 4 * x4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (g0 + u < G) {
            const float4 a = load4(q_s + (size_t)(g0 + u) * dh + 4 * x4);
            dot[u] = fmaf(a.x, b.x, dot[u]);
            dot[u] = fmaf(a.y, b.y, dot[u]);
            dot[u] = fmaf(a.z, b.z, dot[u]);
            dot[u] = fmaf(a.w, b.w, dot[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (g0 + u < G) {
          for (int off = LK >> 1; off > 0; off >>= 1)
            dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
          if (ok && ql == 0) p_s[(size_t)(g0 + u) * C + j] = dot[u] * scale;
        }
      }
    }
  }
  __syncthreads();

  // the chunk's softmax: one warp per query head
  const int lane = tid & 31;
  const size_t part = ((size_t)s * KV + kv) * n_chunks + c;
  for (int g = tid >> 5; g < G; g += N_WARPS) {
    float* prow = p_s + (size_t)g * C;
    float m = NEG_INF;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, prow[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      l += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ml_ws[(part * G + g) * 2] = m;
      ml_ws[(part * G + g) * 2 + 1] = l;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // P.V: threads over (key part r0, quad x of dh), each V quad feeding
  // four query heads at a time; then the key parts are summed in order
  float* acc_out = acc_ws + part * G * dh;
  const int parts = N_THREADS / quads;
  const int r0 = tid / quads;
  const int x = tid - r0 * quads;
  const bool copier = r0 < parts;
  for (int g0 = 0; g0 < G; g0 += 4) {
    if (copier) {
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = r0; j < n; j += parts) {
        const float4 b = load4(v_s + (size_t)j * dh + 4 * x);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (g0 + u < G) {
            const float p = p_s[(size_t)(g0 + u) * C + j];
            a[u].x = fmaf(p, b.x, a[u].x);
            a[u].y = fmaf(p, b.y, a[u].y);
            a[u].z = fmaf(p, b.z, a[u].z);
            a[u].w = fmaf(p, b.w, a[u].w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) red_s[(u * parts + r0) * quads + x] = a[u];
    }
    __syncthreads();
    for (int it = tid; it < 4 * quads; it += N_THREADS) {
      const int u = it / quads;
      const int xx = it - u * quads;
      if (g0 + u < G) {
        float4 a = red_s[u * parts * quads + xx];
        for (int r = 1; r < parts; ++r) {
          const float4 b = red_s[(u * parts + r) * quads + xx];
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        *(float4*)(acc_out + (size_t)(g0 + u) * dh + 4 * xx) = a;
      }
    }
    __syncthreads();                       // red_s, for the next g0
  }
}

// grid (ceil(G * dh / N_THREADS), KV, S): one thread per output element
template <typename T>
__global__ void __launch_bounds__(N_THREADS)
paged_merge_kernel(const float* __restrict__ acc_ws,
                   const float* __restrict__ ml_ws,
                   const int* __restrict__ lengths,
                   T* __restrict__ out,                // (S, KV * G, dh)
                   int P, int ps, int KV, int G, int dh, int window,
                   int chunk_pages, int n_chunks) {
  const int i = blockIdx.x * N_THREADS + threadIdx.x;     // g * dh + d
  const int kv = blockIdx.y;
  const int s = blockIdx.z;
  if (i >= G * dh) return;
  int lo, hi;
  live_keys(lengths[s], window, P * ps, &lo, &hi);
  const int C = chunk_pages * ps;
  const int c0 = lo / C;
  const int c1 = hi / C;
  const size_t first = ((size_t)s * KV + kv) * n_chunks;   // chunk 0's part
  const float* ml = ml_ws + (first * G + i / dh) * 2;      // + c * G * 2
  const float* acc = acc_ws + first * G * dh + i;          // + c * G * dh
  const MergedState<float> r = ordered_merge<MERGE_BATCH, float>(
      c0, c1, [&](int c) { return ml[(size_t)c * G * 2]; },
      [&](int c) { return ml[(size_t)c * G * 2 + 1]; },
      [&](int c) { return acc[(size_t)c * G * dh]; });
  out[((size_t)s * KV + kv) * G * dh + i] =
      from_f32(r.o / fmaxf(r.l, 1e-30f), T());
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ws holds S * KV * n_chunks * G * (dh + 2) floats: the partial
// accumulators (dh per head), then (m, l) per head.
template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* table, const void* lengths, void* out, void* ws,
                  int S, int P, int ps, int KV, int G, int dh, int window,
                  float scale, int chunk_pages, int n_chunks, void* stream) {
  if (dh % (16 / (int)sizeof(T)) || dh > 256 || ps > 64 || chunk_pages < 1
      || (long long)chunk_pages * n_chunks < P || S > 65535 || KV > 65535
      || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(ws))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(chunk_pages, ps, G, dh);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float* acc_ws = (float*)ws;
  float* ml_ws = acc_ws + (size_t)S * KV * n_chunks * G * dh;
  cudaStream_t st = (cudaStream_t)stream;
  paged_partial_kernel<T><<<dim3(n_chunks, KV, S), N_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)table,
      (const int*)lengths, acc_ws, ml_ws, P, ps, KV, G, dh, window, scale,
      chunk_pages, n_chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_merge_kernel<T><<<dim3((G * dh + N_THREADS - 1) / N_THREADS, KV, S),
                          N_THREADS, 0, st>>>(
      acc_ws, ml_ws, (const int*)lengths, (T*)out, P, ps, KV, G, dh, window,
      chunk_pages, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_f32(const void* q, const void* k, const void* v,
                                   const void* table, const void* lengths,
                                   void* out, void* ws, int S, int P, int ps,
                                   int KV, int G, int dh, int window,
                                   float scale, int chunk_pages, int n_chunks,
                                   void* stream) {
  return launch<float>(q, k, v, table, lengths, out, ws, S, P, ps, KV, G, dh,
                       window, scale, chunk_pages, n_chunks, stream);
}

// bf16 q, K/V pool and out (ws f32)
extern "C" int paged_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* table,
                                    const void* lengths, void* out, void* ws,
                                    int S, int P, int ps, int KV, int G,
                                    int dh, int window, float scale,
                                    int chunk_pages, int n_chunks,
                                    void* stream) {
  return launch<bf16>(q, k, v, table, lengths, out, ws, S, P, ps, KV, G, dh,
                      window, scale, chunk_pages, n_chunks, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
