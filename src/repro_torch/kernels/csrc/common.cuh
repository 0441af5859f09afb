// Helpers shared by the port's kernels: f32 arithmetic on f32 or bf16
// storage and a cheap 2^x (flash_attn.cu, rwkv_chunk.cu); the
// Threefry-2x32 generator of jax.random, cp.async staging and the argmax
// order of torch.argmax (segment_logw.cu, mrc_logw.cu).  Included by their
// sources; the build hashes it with them (kernels/build.py), so an edit
// here rebuilds every one of them.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x with ex2.approx.ftz: relative error ~2^-22; results below 2^-126,
// which no sum of these kernels can tell from 0, flush to 0.  Both kernels
// take it only on exponents <= 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Threefry-2x32, 20 rounds, in native uint32 arithmetic: the block function
// of repro_torch/prng.py (threefry2x32, _ROTATIONS, _PARITY, the key
// schedule), which reproduces jax.random under partitionable threefry.
// 20 rounds of add, rotate (one funnel shift) and xor, and the 5 key
// injections: uniform_at compiles to 70 SASS instructions on sm_90a (adds
// split between IADD3 and IMAD).  Written out with no arrays, so that
// everything stays in registers.
__device__ __forceinline__ void threefry_round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1, bool odd) {
  threefry_round(x0, x1, odd ? 17 : 13);
  threefry_round(x0, x1, odd ? 29 : 15);
  threefry_round(x0, x1, odd ? 16 : 26);
  threefry_round(x0, x1, odd ? 24 : 6);
}

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_rounds(x0, x1, false);
  x0 += k1;
  x1 += k2 + 1u;
  threefry_rounds(x0, x1, true);
  x0 += k2;
  x1 += k0 + 2u;
  threefry_rounds(x0, x1, false);
  x0 += k0;
  x1 += k1 + 3u;
  threefry_rounds(x0, x1, true);
  x0 += k1;
  x1 += k2 + 4u;
  threefry_rounds(x0, x1, false);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.fold_in(key, data): threefry2x32(key, (0, data)).
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t data) {
  return threefry2x32(key.x, key.y, 0u, data);
}

// Element j (< 2^32) of jax.random.uniform(key, shape) in float32: the
// 32 bits y0 ^ y1 at counter (0, j), their top 23 bits as the mantissa of
// a float in [1, 2), minus 1 (prng._bits_to_unit_float).
__device__ __forceinline__ float uniform_at(uint2 key, uint32_t j) {
  const uint2 y = threefry2x32(key.x, key.y, 0u, j);
  return __uint_as_float(((y.x ^ y.y) >> 9) | 0x3F800000u) - 1.0f;
}

// A threefry key held as the port holds it: two uint32 words in int64.
__device__ __forceinline__ uint2 load_key(const long long* key) {
  return make_uint2(static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1]));
}

// NaN-aware "a beats b" of torch.argmax: NaN is the maximum, and among
// equal values the first index wins.  A reduction by it gives the same
// index in any order.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace
