// Segment MRC importance log-weights on Hopper (sm_90a).
//
//   logW[c, i, s] = sum_{e in s} where(u[i, e] < p[c, e], a[c, e], 0)
//                 + sum_{e in s} b[c, e]
//
// u: (NIS, D) float32 candidate uniforms, shared by the C clients
// (BiCompFL-GR draws every client's candidates from one key; the PR
// variants' private candidates come with those variants); p, a, b: (C, D)
// float32 clipped prior and log-ratio
// coefficients (core/bernoulli.log_ratio_coeffs); seg: (D,) int32 segment
// ids, non-decreasing from 0 (core/mrc._validate_seg_ids), so every
// segment is one contiguous run of parameters; out: (C, NIS, n_seg).
// Ids >= n_seg are dropped and an empty segment sums to 0, as the
// reference's segment_sum does.
//
// Replaces the TPU kernel src/repro/kernels/segment_logw.py::
// segment_logw_pallas (pallas_call at segment_logw.py:92), which reduced
// each (128, 128) tile of where(u < p, a, 0) per segment on the MXU by a
// matmul with a one-hot (TILE_D, NSEG) segment matrix.  Contiguous
// segments make that matmul unnecessary: a segmented sum over runs does it
// with no one-hot, no tensor cores (so no TF32) and no padding pass.
//
// Bound.  u is read once and serves every client; p, a, b and seg are read
// once per row group from L2.  At the adaptive path's shape (C = 10,
// NIS = 64, D = 28160) the bytes are u 7.2 MB + p, a, b 3.4 MB + seg and
// out, ~10.7 MB, ~3.2 us at 3.35 TB/s; the compares and adds, ~36 M, take
// under a microsecond at the fp32 rate.  Memory-bound.
//
// Design.  D is cut into tiles of kTile parameters.  A segment that spans
// several tiles is cut at the tile edges into pieces, so one long segment
// (KL concentrated in few parameters) is spread over many CTAs instead of
// one warp.  Piece (segment s, tile k) has the index s + k: distinct for
// every piece, since a later tile's segments start where an earlier one's
// end, and fewer than n_seg + n_tiles.
//
//   pass 1, grid (tiles, row groups of kRows): the CTA stages its u tile
//     in shared memory once for all clients, then for each client c stages
//     p, a and walks
//     (piece, row) items, one warp each: lanes stride over the piece's
//     parameters, a shuffle tree sums them, lane 0 writes the piece's
//     partial.  Row group 0 also sums b over each piece, once per client
//     and piece, not per candidate row.
//   pass 2, one thread per (c, i, s): finds the segment's run by binary
//     search in seg and adds its pieces' partials in tile order, then the
//     b pieces.
//
// Every sum runs in a fixed order (no float atomics): deterministic.
//
// Later (ROADMAP Queue 2): draw u in-kernel (threefry), add the Gumbel
// noise and take the argmax, so the (NIS, D) uniforms never reach device
// memory.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing (the caller passes the
// partial buffers) and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;   // parameters per tile
constexpr int kRows = 16;    // candidate rows per CTA

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// First position in seg[0, n) whose id is >= s (seg is non-decreasing).
__device__ __forceinline__ int lower_bound(const int* seg, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
seg_pass1(const float* __restrict__ u, const float* __restrict__ p, const float* __restrict__ a,
          const float* __restrict__ b, const int* __restrict__ seg,
          float* __restrict__ part, float* __restrict__ bpart,
          int clients, int nis, int d, int n_seg, int n_pieces) {
  __shared__ float su[kRows][kTile];
  __shared__ float sp[kTile];
  __shared__ float sa[kTile];
  __shared__ int sseg[kTile];

  const int tile = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int t0 = tile * kTile;
  const int len = min(kTile, d - t0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < len; e += kThreads) sseg[e] = seg[t0 + e];
  __syncthreads();
  const int s_first = sseg[0];
  const int s_last = min(sseg[len - 1], n_seg - 1);
  if (s_first > s_last) return;  // every id of the tile is dropped (>= n_seg)
  const int n_tp = s_last - s_first + 1;
  const int rows = min(kRows, nis - r0);
  for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int e = idx - r * kTile;
    su[r][e] = (r < rows && e < len)
        ? u[static_cast<size_t>(r0 + r) * d + t0 + e] : 1.f;
  }

  for (int c = 0; c < clients; ++c) {
    const size_t cd = static_cast<size_t>(c) * d + t0;
    for (int e = threadIdx.x; e < len; e += kThreads) {
      sp[e] = p[cd + e];
      sa[e] = a[cd + e];
    }
    __syncthreads();

    for (int item = warp; item < n_tp * kRows; item += kWarps) {
      const int j = item / kRows;
      const int r = item - j * kRows;
      if (r >= rows) continue;
      const int s = s_first + j;
      const int lo = lower_bound(sseg, len, s);
      const int hi = lower_bound(sseg, len, s + 1);
      float acc = 0.f;
      for (int e = lo + lane; e < hi; e += 32) {
        acc += su[r][e] < sp[e] ? sa[e] : 0.f;
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        part[(static_cast<size_t>(c) * nis + r0 + r) * n_pieces + s + tile] = acc;
      }
    }
    if (blockIdx.y == 0) {
      for (int j = warp; j < n_tp; j += kWarps) {
        const int s = s_first + j;
        const int lo = lower_bound(sseg, len, s);
        const int hi = lower_bound(sseg, len, s + 1);
        float acc = 0.f;
        for (int e = lo + lane; e < hi; e += 32) acc += b[cd + e];
        acc = warp_sum(acc);
        if (lane == 0) bpart[static_cast<size_t>(c) * n_pieces + s + tile] = acc;
      }
    }
    __syncthreads();  // sp, sa are restaged for the next client
  }
}

__global__ void __launch_bounds__(kThreads)
seg_pass2(const float* __restrict__ part, const float* __restrict__ bpart,
          const int* __restrict__ seg, float* __restrict__ out,
          long long total, int nis, int d, int n_seg, int n_pieces) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int s = static_cast<int>(idx % n_seg);
  const long long ci = idx / n_seg;       // c * nis + i
  const long long c = ci / nis;
  const int lo = lower_bound(seg, d, s);
  const int hi = lower_bound(seg, d, s + 1);
  float xs = 0.f, bs = 0.f;
  if (lo < hi) {
    const int k0 = lo / kTile;
    const int k1 = (hi - 1) / kTile;
    const float* pr = part + ci * n_pieces + s;
    const float* br = bpart + c * n_pieces + s;
    for (int k = k0; k <= k1; ++k) xs += pr[k];
    for (int k = k0; k <= k1; ++k) bs += br[k];
  }
  out[idx] = xs + bs;
}

}  // namespace

// Piece slots per (client, row) row of the partial buffers:
// part is (C, NIS, n_pieces) and bpart (C, n_pieces) floats.
extern "C" int segment_logw_pieces(int d, int n_seg) {
  return n_seg + (d + kTile - 1) / kTile;
}

extern "C" int segment_logw_launch(const void* u, const void* p,
                                   const void* a, const void* b, const void* seg, void* part, void* bpart,
                                   void* out, int clients, int nis, int d,
                                   int n_seg, void* stream) {
  if (clients <= 0 || nis <= 0 || n_seg <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(clients) * nis * n_seg;
  if (d <= 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * total, st);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_pieces = segment_logw_pieces(d, n_seg);
  const dim3 grid1((d + kTile - 1) / kTile, (nis + kRows - 1) / kRows);
  seg_pass1<<<grid1, kThreads, 0, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(p),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(seg), static_cast<float*>(part),
      static_cast<float*>(bpart), clients, nis, d, n_seg, n_pieces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks2 = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  seg_pass2<<<blocks2, kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(bpart),
      static_cast<const int*>(seg), static_cast<float*>(out), total, nis, d,
      n_seg, n_pieces);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_logw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
