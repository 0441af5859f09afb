// MRC importance log-weights on Hopper (sm_90a).
//
//   logW[nb, i] = sum_s x[nb, i, s] * a[nb, s]  +  sum_s b[nb, s]
//
// x: (NB, NIS, S) float32 candidate bits in {0, 1}; a, b: (NB, S) float32
// log-ratio coefficients (core/bernoulli.log_ratio_coeffs); out: (NB, NIS).
//
// Replaces the TPU kernel src/repro/kernels/mrc_weights.py::mrc_logw_pallas
// (pallas_call at mrc_weights.py:71), which streamed (128, 128) tiles of x
// through VMEM into an MXU matvec and needed NIS and S padded to 128.
//
// Bound.  Every element of x is read once for one multiply-add, so the
// kernel moves 4 bytes per 2 flops: it is memory-bound by a wide margin
// (the H100 would need ~20 flop/byte of fp32 before compute mattered).  At
// the quickstart's shapes (NB = 10 clients x 220 blocks, NIS = 64, S = 128)
// that is 72.1 MB of x per round, ~22 us at 3.35 TB/s; a, b and out add
// 2.8 MB.  The matvec is far too skinny for tensor cores.
//
// Design.  One CTA per block row nb, one warp per candidate row i (warps
// stride over NIS, so ragged NIS needs no padding).  Lanes read x along S
// with coalesced float4 loads when S % 4 == 0 and the pointers are 16-byte
// aligned, else with scalar loads masked by s < S, so ragged S needs no
// padding pass either.  A shuffle tree reduces the warp's partial sums.
// The candidate-independent term sum_s b[nb, s] is reduced once per block
// row by warp 0 and broadcast through shared memory.
//
// Later (ROADMAP Queue 2, item 1): fuse the candidate draw (threefry),
// the u < p compare, this dot, the Gumbel add and the argmax into one
// kernel, so x never reaches device memory at all.
//
// Interface: a plain C function for ctypes.  It launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
mrc_logw_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, float* __restrict__ out,
                int nis, int s) {
  const int nb = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* arow = a + static_cast<size_t>(nb) * s;

  __shared__ float bias_smem;
  if (warp == 0) {
    const float* brow = b + static_cast<size_t>(nb) * s;
    float acc = 0.f;
    for (int j = lane; j < s; j += 32) acc += brow[j];
    acc = warp_sum(acc);
    if (lane == 0) bias_smem = acc;
  }
  __syncthreads();
  const float bias = bias_smem;

  for (int i = warp; i < nis; i += kWarps) {
    const size_t row = static_cast<size_t>(nb) * nis + i;
    const float* xrow = x + row * s;
    float acc = 0.f;
    if (kVec4) {
      const float4* x4 = reinterpret_cast<const float4*>(xrow);
      const float4* a4 = reinterpret_cast<const float4*>(arow);
      const int s4 = s >> 2;
      for (int j = lane; j < s4; j += 32) {
        const float4 xv = x4[j];
        const float4 av = __ldg(a4 + j);
        acc = fmaf(xv.x, av.x, acc);
        acc = fmaf(xv.y, av.y, acc);
        acc = fmaf(xv.z, av.z, acc);
        acc = fmaf(xv.w, av.w, acc);
      }
    } else {
      for (int j = lane; j < s; j += 32) {
        acc = fmaf(xrow[j], __ldg(arow + j), acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc + bias;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int mrc_logw_launch(const void* x, const void* a, const void* b,
                               void* out, int nb, int nis, int s,
                               void* stream) {
  if (nb <= 0 || nis <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  if (s % 4 == 0 && aligned16(x) && aligned16(a)) {
    mrc_logw_kernel<true><<<nb, kThreads, 0, st>>>(xf, af, bf, of, nis, s);
  } else {
    mrc_logw_kernel<false><<<nb, kThreads, 0, st>>>(xf, af, bf, of, nis, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mrc_logw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
