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
// reads: each thread walks its parameters' N clients down the columns, so
// the (n, d) -> (d, n) transpose and pad of the TPU route never happen.
//
// Replaces the TPU kernel src/repro/kernels/bernoulli_kl.py::
// bernoulli_kl_pallas (pallas_call at bernoulli_kl.py:46), which streamed
// (1, 512) tiles through VMEM and carried each row's sum across a
// sequential grid axis.
//
// Bound.  Each element is read once (8 bytes of q and p) for four logs and
// a few flops: memory-bound on the card.  At the adaptive path's shape
// (10 x 28160) the inputs are 2.25 MB, under a microsecond at 3.35 TB/s,
// so a call is bound by launch latency: each form is one launch.
//
// Design.  Rows: one CTA per (row, chunk of kChunk elements) sums its
// chunk; a row of one chunk writes its result straight away.  Otherwise
// each CTA writes its partial, __threadfence()s and takes a ticket from
// the row's counter (atomicAdd); the CTA that draws the row's last ticket
// sums the row's partials in index order (one fixed tree), writes the
// result and resets the counter to 0 for the next call.  So rows and total
// are one launch, with no second pass.  The partials and counters are
// scratch that the caller holds across calls (zeroed once): calls on one
// stream run in order, so one stream's calls never share them at once.
// Cols: one column per thread, clients summed in index order.  (Four
// columns a thread with 16-byte loads measured twice as slow on the card:
// at d = 28160 that leaves 7040 threads, too few to hide the logs'
// latency.)  Every sum runs in a fixed order (no float atomics), so a run
// is deterministic.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError().

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
// Every thread calls it; it may be called again after a __syncthreads().
__device__ __forceinline__ float block_sum(float v, float* warp_part) {
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

// grid (rows, chunks).  part: (rows, chunks) floats and ticket: (rows,)
// counters, all 0 on entry and on exit (unused when chunks == 1).
__global__ void __launch_bounds__(kThreads)
kl_rows(const float* __restrict__ q, const float* __restrict__ p, float* __restrict__ out,
        float* part, unsigned* ticket, int s, float scale) {
  __shared__ float warp_part[kWarps];
  __shared__ bool last;
  const int row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const size_t base = static_cast<size_t>(row) * s + static_cast<size_t>(chunk) * kChunk;
  const int len = min(kChunk, s - chunk * kChunk);
  float acc = 0.f;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    acc += kl_elem(q[base + j], p[base + j]);
  }
  acc = block_sum(acc, warp_part);
  if (chunks == 1) {
    if (threadIdx.x == 0) out[row] = acc * scale;
    return;
  }
  float* row_part = part + static_cast<size_t>(row) * chunks;
  if (threadIdx.x == 0) {
    row_part[chunk] = acc;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket + row, 1u) == static_cast<unsigned>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float sum = 0.f;
  for (int j = threadIdx.x; j < chunks; j += kThreads) sum += __ldcg(row_part + j);
  sum = block_sum(sum, warp_part);
  if (threadIdx.x == 0) {
    out[row] = sum * scale;
    ticket[row] = 0u;  // ready for the next call on this stream
  }
}

// One column per thread, clients summed in index order (the loop unrolled
// 5-fold, so a thread's loads of 5 clients are in flight at once).
__global__ void __launch_bounds__(kThreads)
kl_cols(const float* __restrict__ q, const float* __restrict__ p, float* __restrict__ out,
        int n, int d, float scale) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
#pragma unroll 5
  for (int i = 0; i < n; ++i) {
    const size_t at = static_cast<size_t>(i) * d + j;
    acc += kl_elem(__ldg(q + at), __ldg(p + at));
  }
  out[j] = acc * scale;
}

}  // namespace

// Elements per chunk of the rows form: a row of s elements has
// ceil(s / kChunk) chunks, at most 65535 (grid y).
extern "C" int bernoulli_kl_chunk(void) { return kChunk; }

// part: rows * chunks floats and ticket: rows counters, zeroed once by the
// caller and held across calls on one stream (unused for one chunk).
extern "C" int bernoulli_kl_rows(const void* q, const void* p, void* out, void* part,
                                 void* ticket, int rows, int s, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (s <= 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * rows, st);
    return static_cast<int>(cudaGetLastError());
  }
  const int chunks = (s + kChunk - 1) / kChunk;
  kl_rows<<<dim3(rows, chunks), kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(ticket), s, scale);
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
