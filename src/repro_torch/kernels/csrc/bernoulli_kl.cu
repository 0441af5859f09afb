// Bernoulli KL reductions on Hopper (sm_90a).
//
//   kl(q, p) = q (log q - log p) + (1 - q) (log1p(-q) - log1p(-p)),
//   with q and p clipped to [1e-6, 1 - 1e-6] first (natural log, nats).
//
// Two entry points over the same elementwise KL, both float32 in and out:
//
//   bernoulli_kl_rows: q, p (R, S) -> out (R,),  out[r] = scale * sum_s kl
//   bernoulli_kl_cols: q, p (N, D) -> out (D,),  out[j] = scale * sum_i kl
//
// The rows form gives per-block sums and, on the flat (1, n*d) view with
// scale = 1/n, the cohort-mean total KL that AdaptiveAvgAllocation reads.
// The cols form gives the cohort-mean KL profile that AdaptiveAllocation
// reads: each thread walks one parameter's N clients down a column, so the
// (n, d) -> (d, n) transpose and pad of the TPU route never happen.
//
// Replaces the TPU kernel src/repro/kernels/bernoulli_kl.py::
// bernoulli_kl_pallas (pallas_call at bernoulli_kl.py:46), which streamed
// (1, 512) tiles through VMEM and carried each row's sum across a
// sequential grid axis.
//
// Bound.  Each element is read once (8 bytes of q and p) for four logs and
// a few flops: memory-bound on the card.  At the adaptive path's shape
// (10 x 28160) the inputs are 2.25 MB, under a microsecond at 3.35 TB/s,
// so a call is launch-bound.
//
// Design.  Rows: pass 1 gives each (row, chunk of kChunk elements) a CTA
// that writes one partial sum; pass 2 sums each row's partials in order.
// A row of at most kChunk elements skips pass 2.  Cols: one thread per
// column, clients summed in index order.  Every sum runs in a fixed order
// (no float atomics), so a run is deterministic.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing (the caller passes the
// partials buffer) and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;
constexpr float kLo = 1e-6f;
constexpr float kHi = 0.999999f;

__device__ __forceinline__ float kl_elem(float q, float p) {
  q = fminf(fmaxf(q, kLo), kHi);
  p = fminf(fmaxf(p, kLo), kHi);
  return q * (logf(q) - logf(p)) + (1.f - q) * (log1pf(-q) - log1pf(-p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the CTA in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (warp == 0) {
    r = lane < kWarps ? warp_part[lane] : 0.f;
    r = warp_sum(r);
  }
  return r;
}

// grid (rows, chunks): one partial per (row, chunk), or the row's scaled
// sum straight into out when the row has one chunk.
__global__ void __launch_bounds__(kThreads)
kl_rows_pass1(const float* __restrict__ q, const float* __restrict__ p,
              float* __restrict__ dst, int s, int chunks, float scale) {
  const int row = blockIdx.x;
  const int chunk = blockIdx.y;
  const size_t base = static_cast<size_t>(row) * s + static_cast<size_t>(chunk) * kChunk;
  const int len = min(kChunk, s - chunk * kChunk);
  float acc = 0.f;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    acc += kl_elem(q[base + j], p[base + j]);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    dst[static_cast<size_t>(row) * chunks + chunk] = chunks == 1 ? acc * scale : acc;
  }
}

// grid (rows): out[row] = scale * sum of the row's partials, in order.
__global__ void __launch_bounds__(kThreads)
kl_rows_pass2(const float* __restrict__ part, float* __restrict__ out,
              int chunks, float scale) {
  const float* row = part + static_cast<size_t>(blockIdx.x) * chunks;
  float acc = 0.f;
  for (int j = threadIdx.x; j < chunks; j += kThreads) acc += row[j];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc * scale;
}

__global__ void __launch_bounds__(kThreads)
kl_cols(const float* __restrict__ q, const float* __restrict__ p,
        float* __restrict__ out, int n, int d, float scale) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const size_t at = static_cast<size_t>(i) * d + j;
    acc += kl_elem(q[at], p[at]);
  }
  out[j] = acc * scale;
}

}  // namespace

// Most chunks a row may have (grid y); the wrapper refuses longer rows.
extern "C" long long bernoulli_kl_max_row(void) {
  return 65535LL * kChunk;
}

// Number of float partials bernoulli_kl_rows needs for (rows, s).
extern "C" long long bernoulli_kl_rows_scratch(int rows, int s) {
  const int chunks = (s + kChunk - 1) / kChunk;
  return chunks > 1 ? static_cast<long long>(rows) * chunks : 0;
}

extern "C" int bernoulli_kl_rows(const void* q, const void* p, void* out,
                                 void* part, int rows, int s, float scale,
                                 void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* pf = static_cast<const float*>(p);
  float* of = static_cast<float*>(out);
  if (s <= 0) {
    cudaMemsetAsync(of, 0, sizeof(float) * rows, st);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (s + kChunk - 1) / kChunk;
  if (chunks == 1) {
    kl_rows_pass1<<<dim3(rows, 1), kThreads, 0, st>>>(qf, pf, of, s, 1, scale);
    return static_cast<int>(cudaGetLastError());
  }
  float* pa = static_cast<float*>(part);
  kl_rows_pass1<<<dim3(rows, chunks), kThreads, 0, st>>>(qf, pf, pa, s, chunks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kl_rows_pass2<<<rows, kThreads, 0, st>>>(pa, of, chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bernoulli_kl_cols(const void* q, const void* p, void* out,
                                 int n, int d, float scale, void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (d + kThreads - 1) / kThreads;
  kl_cols<<<blocks, kThreads, 0, st>>>(static_cast<const float*>(q),
                                       static_cast<const float*>(p),
                                       static_cast<float*>(out), n, d, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bernoulli_kl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
