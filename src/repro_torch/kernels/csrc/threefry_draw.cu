// The draws of repro_torch/prng.py on Hopper (sm_90a): one launch a draw.
//
// Not a TPU kernel.  The reference draws with jax.random, which XLA fuses
// into one loop; prng.py spells Threefry-2x32 out as ~180 int64 torch
// elementwise ops masked to 32 bits, each a pass over the whole tensor
// (PERF.md §5: the STE's mask draw was 99.6% of an FL round, the stochastic
// sign's draw 61% of a signed training step).  This kernel computes the
// same bits in native uint32 (common.cuh's threefry2x32) and writes one of
// four epilogues, row-major (rows, cols):
//
//   words      (y0, y1) as int64, (rows, cols, 2)      split, fold_in
//   bits       y0 ^ y1 as int64                         random_bits
//   unit       its top 23 bits as a float32 in [0, 1)   uniform, uniform_at
//   bernoulli  unit < p as bool, p float32              bernoulli
//
// Keys: int64 words, row r's key at keys + r * key_stride (0: one key for
// every row).  Positions: implicit, base + c at column c of every row (the
// row-major iota of a draw's shape), or explicit int64 positions, row r at
// pos + r * pos_stride; position j is the counter (j >> 32, j mod 2^32),
// so positions >= 2^32 stay exact.  p: row r at p + r * p_stride.  The
// output is contiguous.
//
// Bound.  A draw is ~70 SASS instructions (PERF.md §6's probe of
// uniform_at); bytes are the output, plus p or the explicit positions.
// The STE's mask, bernoulli at (10, 203264): 2.03 M draws, 4.3 us of issue
// on 132 SMs x 128 lanes at 1.98 GHz, against 10.2 MB, 3.0 us at
// 3.35 TB/s: instruction-bound.  One range of the stochastic sign,
// uniform_at at 2^24 explicit positions: 35 us of issue against 201 MB,
// 60 us: memory-bound.
//
// Design.  A block is 256 threads, blockDim.x of them along a row (32 to
// 256, the fewest that cover it) and 256 / blockDim.x rows; the grid is
// (column blocks, row blocks), and rows past gridDim.y * blockDim.y are
// walked grid-stride, so no index is divided by cols.  A thread loads its
// row's key once and draws P consecutive positions of it (16 bernoulli, 8
// unit, 4 bits or words): one 16-byte store of bools, two of floats or of
// bit patterns, four of word pairs; p and explicit positions come in
// 16-byte loads.  That vector path needs a launch whose columns are a
// multiple of P and whose pointers and row strides are 16-byte aligned
// (the wrapper decides); otherwise each position is loaded and stored on
// its own and the ragged end is masked.  The P draws are independent, so
// their instructions interleave.  No shared or local memory, no
// synchronisation, no allocation: the launch is safe to capture in a CUDA
// graph.
//
// Interface: plain C functions for ctypes.  threefry_draw launches on the
// given stream with the wrapper's geometry, does not synchronise and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum Epilogue : int { kWords = 0, kBits = 1, kUnit = 2, kBernoulli = 3 };

// Positions a thread draws, by epilogue (words, bits, unit, bernoulli):
// each epilogue's stores come to 16-byte vectors.  The one table of them:
// kernels/threefry_draw.py reads it from this file for its geometry.
template <int E>
__host__ __device__ constexpr int positions() {
  constexpr int kPositions[] = {4, 4, 8, 16};
  return kPositions[E];
}

struct Draw {
  const long long* keys;
  long long key_stride;
  const long long* pos;    // explicit positions, or null
  long long pos_stride;
  unsigned long long base;  // implicit positions: base + column
  const float* p;           // bernoulli's probabilities, or null
  long long p_stride;
  void* out;
  long long rows, cols;
};

__device__ __forceinline__ uint2 draw_at(uint2 key, unsigned long long j) {
  return threefry2x32(key.x, key.y, static_cast<uint32_t>(j >> 32), static_cast<uint32_t>(j));
}

// prng._bits_to_unit_float: the top 23 bits as the mantissa of [1, 2), minus 1.
__device__ __forceinline__ float unit_float(uint2 y) {
  return __uint_as_float(((y.x ^ y.y) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ long long bits(uint2 y) {
  return static_cast<long long>(y.x ^ y.y);  // zero-extended, as prng's int64 words
}

template <int E, bool kExplicit, bool kVec>
__global__ void __launch_bounds__(kThreads) threefry_draw_kernel(const Draw d) {
  constexpr int P = positions<E>();
  const long long c0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * P;
  if (c0 >= d.cols) return;
  // The positions this thread owns in a row: all P on the vector path,
  // else up to the row's ragged end.
  const int n = kVec ? P : static_cast<int>(min(static_cast<long long>(P), d.cols - c0));
  const long long row_step = static_cast<long long>(gridDim.y) * blockDim.y;
  for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; r < d.rows;
       r += row_step) {
    const uint2 key = load_key(d.keys + r * d.key_stride);
    unsigned long long j[P];
    if constexpr (kExplicit) {
      const long long* src = d.pos + r * d.pos_stride + c0;
      if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < P / 2; ++k) {
          const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(src) + k);
          j[2 * k] = static_cast<unsigned long long>(v.x);
          j[2 * k + 1] = static_cast<unsigned long long>(v.y);
        }
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          j[i] = i < n ? static_cast<unsigned long long>(__ldg(src + i)) : 0ull;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) j[i] = d.base + static_cast<unsigned long long>(c0 + i);
    }
    float q[E == kBernoulli ? P : 1];
    if constexpr (E == kBernoulli) {  // issued before the draws, which hide its latency
      const float* pr = d.p + r * d.p_stride + c0;
      if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < P / 4; ++k) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(pr) + k);
          q[4 * k] = v.x;
          q[4 * k + 1] = v.y;
          q[4 * k + 2] = v.z;
          q[4 * k + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) q[i] = i < n ? __ldg(pr + i) : 0.f;
      }
    }
    uint2 y[P];
#pragma unroll
    for (int i = 0; i < P; ++i) y[i] = draw_at(key, j[i]);
    const long long at = r * d.cols + c0;  // this thread's first output element
    if constexpr (E == kWords) {
      longlong2* o = static_cast<longlong2*>(d.out) + at;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (i < n) o[i] = make_longlong2(y[i].x, y[i].y);
      }
    } else if constexpr (E == kBits) {
      long long* o = static_cast<long long*>(d.out) + at;
      if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < P / 2; ++k) {
          reinterpret_cast<longlong2*>(o)[k] = make_longlong2(bits(y[2 * k]), bits(y[2 * k + 1]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (i < n) o[i] = bits(y[i]);
        }
      }
    } else if constexpr (E == kUnit) {
      float* o = static_cast<float*>(d.out) + at;
      if constexpr (kVec) {
#pragma unroll
        for (int k = 0; k < P / 4; ++k) {
          reinterpret_cast<float4*>(o)[k] =
              make_float4(unit_float(y[4 * k]), unit_float(y[4 * k + 1]),
                          unit_float(y[4 * k + 2]), unit_float(y[4 * k + 3]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (i < n) o[i] = unit_float(y[i]);
        }
      }
    } else {
      uint8_t* o = static_cast<uint8_t*>(d.out) + at;
      if constexpr (kVec) {  // byte b of word k is position 4 k + b (little-endian)
        uint32_t w[P / 4];
#pragma unroll
        for (int k = 0; k < P / 4; ++k) {
          w[k] = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            w[k] |= static_cast<uint32_t>(unit_float(y[4 * k + b]) < q[4 * k + b]) << (8 * b);
          }
        }
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (i < n) o[i] = static_cast<uint8_t>(unit_float(y[i]) < q[i]);
        }
      }
    }
  }
}

template <int E>
void launch(const Draw& d, bool expl, bool vec, dim3 grid, dim3 block, cudaStream_t st) {
  if (expl) {
    if (vec) threefry_draw_kernel<E, true, true><<<grid, block, 0, st>>>(d);
    else threefry_draw_kernel<E, true, false><<<grid, block, 0, st>>>(d);
  } else {
    if (vec) threefry_draw_kernel<E, false, true><<<grid, block, 0, st>>>(d);
    else threefry_draw_kernel<E, false, false><<<grid, block, 0, st>>>(d);
  }
}

}  // namespace

// One draw.  pos null: implicit positions base + column.  p: bernoulli's
// only.  vec: the 16-byte path (the caller checked its alignment).  The
// block is (threads_x, 256 / threads_x), the grid (blocks_x, blocks_y).
extern "C" int threefry_draw(int epilogue, const void* keys, long long key_stride,
                             const void* pos, long long pos_stride, unsigned long long base,
                             const void* p, long long p_stride, void* out, long long rows,
                             long long cols, int vec, int threads_x, int blocks_x, int blocks_y,
                             void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (threads_x < 32 || threads_x > kThreads || kThreads % threads_x != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Draw d{static_cast<const long long*>(keys), key_stride,
               static_cast<const long long*>(pos), pos_stride, base,
               static_cast<const float*>(p), p_stride, out, rows, cols};
  const dim3 grid(blocks_x, blocks_y);
  const dim3 block(threads_x, kThreads / threads_x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool expl = pos != nullptr;
  switch (epilogue) {
    case kWords: launch<kWords>(d, expl, vec, grid, block, st); break;
    case kBits: launch<kBits>(d, expl, vec, grid, block, st); break;
    case kUnit: launch<kUnit>(d, expl, vec, grid, block, st); break;
    case kBernoulli:
      if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      launch<kBernoulli>(d, expl, vec, grid, block, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* threefry_draw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
