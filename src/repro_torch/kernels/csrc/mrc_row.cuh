// The per-row sum order of the fixed-block MRC log-weights, shared by the
// two forms in mrc_logw.cu (the u-fed mrc_logw and the keyed encoder), so
// that the keyed encoder's logW is bit-identical to the u-fed kernel fed
// the same candidates.
//
// A row of S elements is cut into chunks of four (chunk q holds elements
// 4q..4q+3; elements past S count as x = 0, a = 0).  A group of G lanes
// owns the row, G = ceil(S/4) rounded up to a power of two, at most 32, so
// that every lane of the group holds a chunk (S = 16: 4 lanes, 8 rows a
// warp; S >= 128: the whole warp).  Lane l of the group adds its chunks
// q = l, l + G, ... in that order, each chunk's four products in element
// order by fmaf, from 0; the group then adds its lanes' sums by an xor
// butterfly, which leaves the same bits in every lane of the group.  The
// candidate-independent sum over b is the same sum with x = 1.
#pragma once

#include <cuda_runtime.h>

namespace {

// Lanes that own one row of S elements.
__host__ __device__ inline int mrc_group_lanes(int s) {
  const int chunks = (s + 3) / 4;
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  return g;
}

// One chunk of x (0 or 1) times a into a lane's partial sum.
__device__ __forceinline__ float chunk_fma(float acc, float4 x, float4 a) {
  acc = fmaf(x.x, a.x, acc);
  acc = fmaf(x.y, a.y, acc);
  acc = fmaf(x.z, a.z, acc);
  acc = fmaf(x.w, a.w, acc);
  return acc;
}

// x = 1 on the elements of chunk q that lie inside the row, 0 past it.
__device__ __forceinline__ float4 ones_chunk(int q, int s) {
  const int e = 4 * q;
  return make_float4(e < s ? 1.f : 0.f, e + 1 < s ? 1.f : 0.f, e + 2 < s ? 1.f : 0.f,
                     e + 3 < s ? 1.f : 0.f);
}

// Chunk q of a row of length s: scalar loads masked by e < s (0 past it),
// or one 16-byte load (kVec: s % 4 == 0 and the row 16-byte aligned).
template <bool kVec>
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ row, int q, int s) {
  const int e = 4 * q;
  if (kVec) return *reinterpret_cast<const float4*>(row + e);
  return make_float4(e < s ? row[e] : 0.f, e + 1 < s ? row[e + 1] : 0.f,
                     e + 2 < s ? row[e + 2] : 0.f, e + 3 < s ? row[e + 3] : 0.f);
}

// The sum of the G lanes' partial sums.  Every lane of the warp calls it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum_s b[s] of one row in the shared order; every lane of the warp calls
// it, lane lg of its group.
template <int G, bool kVec>
__device__ __forceinline__ float row_bias(const float* __restrict__ brow, int lg, int s) {
  const int nq = (s + 3) >> 2;
  float acc = 0.f;
  for (int q = lg; q < nq; q += G) acc = chunk_fma(acc, ones_chunk(q, s), load_chunk<kVec>(brow, q, s));
  return group_sum<G>(acc);
}

}  // namespace
