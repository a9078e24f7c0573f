// The ordered merge of partial softmax states, shared by the two kernels
// that split one softmax over blocks: paged decode attention's merge
// (paged_attention.cu, chunks of pages) and the flash forward's (
// flash_attention.cu, ranges of k tiles).
//
// Partial c holds (m_c, l_c, a_c): the running max of its scores, the sum
// of exp(s - m_c) and the unnormalised exp(s - m_c)-weighted sum of one
// output element. Over c = c0 .. c1, in increasing order:
//   m = max m_c,  l = sum l_c e^(m_c - m),  o = sum a_c e^(m_c - m)
// and the caller writes o / max(l, 1e-30) (and m + log l, the row's
// log-sum-exp). A partial whose scores were all masked (m_c = -1e30)
// weighs e^(-1e30 - m) = 0 beside any live one. The loads of BATCH
// partials are issued before any is used; the sums still run in order, so
// the bits depend only on the partials.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// o += a w, for one output element or four
__device__ __forceinline__ void merge_add(float& o, float a, float w) {
  o += a * w;
}

__device__ __forceinline__ void merge_add(float4& o, const float4& a,
                                          float w) {
  o.x += a.x * w;
  o.y += a.y * w;
  o.z += a.z * w;
  o.w += a.w * w;
}

template <typename T>
struct MergedState {
  float m, l;
  T o;
};

// m_of(c), l_of(c), a_of(c): partial c's m, l and output element(s), T
// float or float4
template <int BATCH, typename T, typename MOf, typename LOf, typename AOf>
__device__ __forceinline__ MergedState<T> ordered_merge(int c0, int c1,
                                                        MOf m_of, LOf l_of,
                                                        AOf a_of) {
  constexpr float NEG = -1e30f;
  float m = NEG;
  for (int cb = c0; cb <= c1; cb += BATCH) {
    float mb[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) mb[u] = cb + u <= c1 ? m_of(cb + u) : NEG;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) m = fmaxf(m, mb[u]);
  }
  float l = 0.f;
  T o{};
  for (int cb = c0; cb <= c1; cb += BATCH) {
    float mb[BATCH], lb[BATCH];
    T ab[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const bool live = cb + u <= c1;
      mb[u] = live ? m_of(cb + u) : NEG;
      lb[u] = live ? l_of(cb + u) : 0.f;
      ab[u] = live ? a_of(cb + u) : T{};
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (cb + u <= c1) {                  // in increasing order
        const float w = expf(mb[u] - m);
        l += lb[u] * w;
        merge_add(o, ab[u], w);
      }
    }
  }
  return {m, l, o};
}
