// Helpers shared by the model kernels (flash_attn.cu, rwkv_chunk.cu): f32
// arithmetic on f32 or bf16 storage, and a cheap 2^x.  Included by their
// sources; the build hashes it with them (kernels/build.py), so an edit
// here rebuilds both.
#pragma once

#include <cuda_bf16.h>

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

}  // namespace
