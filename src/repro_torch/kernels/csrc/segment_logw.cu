// Segment MRC importance log-weights, and the segment codec's encoder fused
// around them, on Hopper (sm_90a).
//
//   logW[c, i, s] = sum_{e in s} where(u[i, e] < p[c, e], a[c, e], 0)
//                 + sum_{e in s} b[c, e]
//
// u: (NIS, D) float32 candidate uniforms, shared by the C clients
// (BiCompFL-GR draws every client's candidates from one key); p, a, b:
// (C, D) float32 clipped prior and log-ratio coefficients
// (core/bernoulli.log_ratio_coeffs); seg: (D,) int32 segment ids,
// non-decreasing from 0 (core/mrc._validate_seg_ids), so every segment is
// one contiguous run of parameters; logW: (C, NIS, n_seg).  Ids >= n_seg
// are dropped and an empty segment sums to 0, as the reference's
// segment_sum does.
//
// Replaces the TPU kernel src/repro/kernels/segment_logw.py::
// segment_logw_pallas (pallas_call at segment_logw.py:92), which reduced
// each (128, 128) tile of where(u < p, a, 0) per segment on the MXU by a
// matmul with a one-hot (TILE_D, NSEG) segment matrix.  Contiguous
// segments make that matmul unnecessary: a segmented sum over runs on the
// CUDA cores in IEEE fp32 does it, with no one-hot, no TF32 and no padding.
//
// Two forms share one pass 1, templated on where u comes from:
//
//   u-fed (segment_logw_launch): u is read from memory, 16-byte loads.
//     The counterpart of segment_logw_pallas and of the seg_logw_fn hook.
//   keyed (segment_mrc_encode_launch): u is drawn in the kernel, bit for
//     bit prng.uniform(prng.fold_in(key, i), (D,)) -- row key
//     fold_in(key, i) once per row, then element e = uniform_at(row key, e)
//     (common.cuh) -- so the (NIS, D) uniforms never reach device memory.
//     The key is one (2,) key shared by the C clients (key_stride 0:
//     BiCompFL-GR's common candidates, one draw serves the cohort) or one
//     key per client, key[c] at key + 2 c (key_stride 2: the PR variants'
//     private candidates, one draw per client).
//     Pass 2 then adds the Gumbel noise of select_key[c] and takes the
//     argmax; pass 3 re-thresholds the chosen rows into the sample.  These
//     are core/mrc's whole segment encoder: draw, weights, Gumbel, argmax,
//     gather, which on the unfused route cost ~500 launches of int64
//     elementwise threefry and a (NIS, D) tensor.
//
// Bound.  u-fed, at the adaptive path's shape (C = 10, NIS = 64,
// D = 28160): u 7.2 MB + p, a, b 3.4 MB + seg and logW, ~10.7 MB, ~3.2 us
// at 3.35 TB/s; memory-bound.  Keyed: ~3.5 MB of p, a, b, seg and outputs
// (~1 us), but NIS * D = 1.8 M threefry draws of 70 SASS instructions
// each (threefry2x32 and the float conversion, as chip_smoke.py reads
// them from a probe) at the issue ceiling of 128 thread instructions per
// SM a clock: instruction-bound, ~3.8 us at the card's clock; with
// per-client keys C times the draws, ~38 us.
//
// Design.
//
//   pass 1, grid (tiles of kTile = 512 parameters, groups of kWarps = 8
//     candidate rows), 256 threads: warp w owns row i of the tile, lane l
//     the strip of kStrip = 16 consecutive parameters [16 l, 16 l + 16).
//     The thread gets its strip of u once, into registers (four float4,
//     drawn or loaded), and then loops over the C clients: u is read or drawn once
//     for the cohort, never once per client -- except under per-client
//     keys, where the loop draws each client's strip from fold_in(key[c], i)
//     before that client's sums.  p and a of all clients of
//     the tile are staged in shared memory by cp.async (16-byte copies
//     where aligned), strips padded to 20 floats so the float4 reads are
//     free of bank conflicts; the first client's copies are one group, the
//     rest another, so the first client's compares start while the rest
//     arrive (and the keyed form draws u while all of them arrive).  At
//     most kMaxStage clients are staged at a time (40 KB at C = 10).
//       Per client the thread sums its strip's runs in registers, closing
//     a run at a segment boundary (a strip of one run, almost every strip
//     on the path, is a plain sum); a run inside the strip is a whole piece
//     and is written at once.  The runs that cross strips are joined by a
//     warp-segmented inclusive scan over the lanes (five shuffle steps, in
//     a fixed order; which steps add depends only on the segmentation and
//     is worked out once).  A segment that spans tiles is cut at the tile
//     edges into pieces, so one long segment is spread over many CTAs;
//     piece (segment s, tile k) has the slot s + k, distinct for every
//     piece and below n_seg + n_tiles.  The b sums of (client, tile) are
//     the same reduction over b, spread over the CTAs' warps.
//     Occupancy: 440 CTAs at the path's shape, up to 4 resident per SM
//     (64 registers a thread, 51 KB of shared memory each), so the whole
//     grid is resident at once: 24-32 warps per SM.
//   pass 2, one warp per (client, segment): lanes cover the rows (NIS = 64
//     gives 2 per lane), each adds its row's pieces in tile order and the
//     segment's b pieces, and writes logW.  Keyed form: it also adds
//     -log(-log(clamp(u_g, 1e-12, 1 - 1e-12))), u_g drawn from
//     select_key[c] at flat position i * n_seg + s (the layout of
//     prng.uniform(select_key, (n_is, n_seg))), and takes the warp's
//     argmax, the first maximal index winning as in torch.argmax.
//   pass 3, select (keyed form, and the decoder): one thread per (c, e)
//     takes row = idx[c, seg[e]] and regenerates that row's element only,
//     uniform_at(fold_in(key[c], row), e) (key[c] = key under the shared
//     key), and writes (u < p[c, e]) as float.
//
// Every sum runs in a fixed order (no float atomics): a call is bitwise
// deterministic.  Built without --use_fast_math: logf is the accurate one,
// the same libm the plain route calls on the card.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing (the caller passes the
// piece buffers) and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;     // candidate rows per CTA
constexpr int kStrip = 16;                // consecutive parameters per thread
constexpr int kTile = 32 * kStrip;        // 512 parameters: one warp per tile row
constexpr int kPadStrip = kStrip + 4;     // shared-memory stride of a strip
constexpr int kPadTile = 32 * kPadStrip;  // 640 floats per staged client array
constexpr int kMaxStage = 16;             // clients staged at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pad(int e) { return (e >> 4) * kPadStrip + (e & 15); }

// First position in seg[0, n) whose id is >= s (seg is non-decreasing),
// found by the whole warp: each step probes 32 evenly spaced positions and
// keeps the gap before the first that is >= s (3 steps for n = 28160,
// where a binary search takes 15 dependent loads).
__device__ __forceinline__ int warp_lower_bound(const int* seg, int n, int s) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + lane * step;
    const unsigned ge = __ballot_sync(kFull, pos >= hi || seg[pos] >= s);
    const int first = ge ? __ffs(ge) - 1 : 32;
    if (first == 0) return lo;
    const int next_lo = lo + (first - 1) * step + 1;
    hi = min(lo + first * step, hi);
    lo = next_lo;
  }
  return lo;
}

// The segmentation of one lane's strip and how its runs join its
// neighbours' (client independent: worked out once per thread).  Packed
// into five registers, so that the client loop keeps the strip of u and
// its sums in registers under the 64-register cap.
struct Strip {
  int n;              // valid parameters in the strip (0..16)
  int f, g;           // ids of its first and last parameter (-1 if n == 0)
  unsigned ends;      // bit k: a run ends at parameter k
  unsigned bits;      // first_end + 1 | last_start << 5 | take << 10 |
                      // from_left << 15 | to_right << 16
  __device__ __forceinline__ int nruns() const { return __popc(ends); }
  // where the first run ends (n - 1 for one run, -1 for none)
  __device__ __forceinline__ int first_end() const { return static_cast<int>(bits & 31u) - 1; }
  // where the last run starts (0 for one run)
  __device__ __forceinline__ int last_start() const { return (bits >> 5) & 31u; }
  // bit j: scan step j (offset 2^j) adds the left lane's value
  __device__ __forceinline__ unsigned take() const { return (bits >> 10) & 31u; }
  // the first run continues the left lane's last run
  __device__ __forceinline__ bool from_left() const { return (bits >> 15) & 1u; }
  // the last run continues into the right lane
  __device__ __forceinline__ bool to_right() const { return (bits >> 16) & 1u; }
};

__device__ __forceinline__ Strip strip_of(const int* seg, int t0, int len) {
  const int lane = threadIdx.x & 31;
  const int* sid = seg + t0 + lane * kStrip;
  Strip st;
  st.n = max(0, min(kStrip, len - lane * kStrip));
  st.f = st.g = -1;
  st.ends = 0u;
  if (st.n > 0) {
    int ids[kStrip];  // all 16 loads in flight at once
#pragma unroll
    for (int k = 0; k < kStrip; ++k) ids[k] = k < st.n ? sid[k] : -1;
    st.f = ids[0];
#pragma unroll
    for (int k = 1; k < kStrip; ++k) {
      if (k < st.n && ids[k] != ids[k - 1]) st.ends |= 1u << (k - 1);
      if (k == st.n - 1) st.g = ids[k];
    }
    if (st.n == 1) st.g = ids[0];
    st.ends |= 1u << (st.n - 1);
  }
  const unsigned first_end1 = st.ends ? __ffs(st.ends) : 0;
  const unsigned before_last = st.ends & ~(1u << max(st.n - 1, 0));
  const unsigned last_start = before_last ? 32 - __clz(before_last) : 0;
  const int g_left = __shfl_up_sync(kFull, st.g, 1);
  const int f_right = __shfl_down_sync(kFull, st.f, 1);
  const bool from_left = lane > 0 && st.f >= 0 && g_left == st.f;
  const bool to_right = lane < 31 && st.g >= 0 && f_right == st.g;
  // Segmented inclusive scan of the last runs' sums over the lanes: a lane
  // whose strip is one run continuing from the left accumulates, every
  // other lane starts afresh.  Which of the five steps add is fixed here.
  int start = !(from_left && st.nruns() == 1);
  unsigned take = 0u;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int off = 1 << j;
    const int up = __shfl_up_sync(kFull, start, off);
    if (lane >= off && !start) {
      take |= 1u << j;
      start = up;
    }
  }
  st.bits = first_end1 | last_start << 5 | take << 10 | static_cast<unsigned>(from_left) << 15 |
            static_cast<unsigned>(to_right) << 16;
  return st;
}

// Sums the strip's values over its runs and across the warp's tile row,
// and writes the sum of every piece of this tile to dst[s] (s the piece's
// segment id), for s < n_seg.  ``vals(q)`` gives the strip's values
// 4q..4q+3 (0 past the strip's end), so that no more than four are live at
// a time.  Every lane of the warp calls it.  The first and last runs' sums
// (one and the same for a strip of one run) are taken by every lane in one
// branch-free pass, so that the lanes of a tile row with a segment
// boundary do not diverge; runs strictly inside a strip (3 runs or more:
// segments shorter than a strip) take a second pass.  Each run is summed
// in order, k ascending.
template <typename Vals>
__device__ __forceinline__ void reduce_pieces(const Vals& vals, const Strip& st,
                                              const int* ids, float* dst, int n_seg) {
  const int first_end = st.first_end();
  const int last_start = st.last_start();
  const int nruns = st.nruns();
  float head = 0.f, tail = 0.f;
#pragma unroll
  for (int q = 0; q < kStrip / 4; ++q) {
    const float4 v4 = vals(q);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      head += k <= first_end ? v[j] : 0.f;
      tail += k >= last_start ? v[j] : 0.f;
    }
  }
  if (nruns > 2) {  // the runs between the first and the last
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kStrip / 4; ++q) {
      const float4 v4 = vals(q);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        if (k > first_end && k < last_start) {
          acc += v[j];
          if ((st.ends >> k) & 1u) {
            const int s = ids[k];
            if (s < n_seg) dst[s] = acc;
            acc = 0.f;
          }
        }
      }
    }
  }
  float sc = tail;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float up = __shfl_up_sync(kFull, sc, 1 << j);
    if ((st.take() >> j) & 1u) sc = up + sc;
  }
  const float carry = __shfl_up_sync(kFull, sc, 1);
  if (nruns > 1 && st.f < n_seg) dst[st.f] = st.from_left() ? carry + head : head;
  if (nruns > 0 && !st.to_right() && st.g < n_seg) dst[st.g] = sc;
}

// Stage p and a of clients [c0, c0 + cnt) of the tile into shared memory.
template <bool kVec>
__device__ __forceinline__ void stage(float* sp, float* sa, const float* __restrict__ p,
                                      const float* __restrict__ a, int c0, int cnt,
                                      int d, int t0, int len) {
  if (kVec) {  // len is a multiple of 4 and every row start 16-byte aligned
    const int q4 = len >> 2;
    for (int idx = threadIdx.x; idx < cnt * q4; idx += kThreads) {
      const int j = idx / q4;
      const int e = (idx - j * q4) << 2;
      const size_t src = static_cast<size_t>(c0 + j) * d + t0 + e;
      const int dst = j * kPadTile + pad(e);
      cp_async16(sp + dst, p + src);
      cp_async16(sa + dst, a + src);
    }
  } else {
    for (int idx = threadIdx.x; idx < cnt * len; idx += kThreads) {
      const int j = idx / len;
      const int e = idx - j * len;
      const size_t src = static_cast<size_t>(c0 + j) * d + t0 + e;
      const int dst = j * kPadTile + pad(e);
      cp_async4(sp + dst, p + src);
      cp_async4(sa + dst, a + src);
    }
  }
}

// The thread's strip of u: four float4 in registers (no array and no
// address taken, so none of it lands in local memory).
struct UStrip {
  float4 q0, q1, q2, q3;
  __device__ __forceinline__ float4 get(int q) const {
    return q == 0 ? q0 : q == 1 ? q1 : q == 2 ? q2 : q3;
  }
  __device__ __forceinline__ void set(int q, float4 v) {
    if (q == 0) q0 = v; else if (q == 1) q1 = v; else if (q == 2) q2 = v; else q3 = v;
  }
};

// where(u < p, a, 0) of one (client, row), four values at a time; p and a
// are read as float4 from the strip's padded row in shared memory.
struct SelectVals {
  UStrip u;
  const float* sp;
  const float* sa;
  __device__ __forceinline__ float4 operator()(int q) const {
    const float4 uu = u.get(q);
    const float4 pp = *reinterpret_cast<const float4*>(sp + 4 * q);
    const float4 aa = *reinterpret_cast<const float4*>(sa + 4 * q);
    return make_float4(uu.x < pp.x ? aa.x : 0.f, uu.y < pp.y ? aa.y : 0.f,
                       uu.z < pp.z ? aa.z : 0.f, uu.w < pp.w ? aa.w : 0.f);
  }
};

// b of one client over the strip (0 past its end), read from memory;
// kVec: 16 bytes at a time (the strip's length is then a multiple of 4).
template <bool kVec>
struct BVals {
  const float* br;
  int n;
  __device__ __forceinline__ float4 operator()(int q) const {
    const int k = 4 * q;
    if (kVec) {
      return k < n ? *reinterpret_cast<const float4*>(br + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return make_float4(k < n ? br[k] : 0.f, k + 1 < n ? br[k + 1] : 0.f,
                       k + 2 < n ? br[k + 2] : 0.f, k + 3 < n ? br[k + 3] : 0.f);
  }
};

// Resident CTAs per SM asked of ptxas: 4 (64 registers a thread, 8-12
// bytes spilled) keeps the path's 440 CTAs in one wave and measured a
// little faster on the card than 3 (80 registers, no spill).
constexpr int kMinBlocks = 4;

// The strip of u of one row: drawn (kKeyed) or read; +inf past the
// strip's end and for a row past NIS, so that u < p is false there.
template <bool kKeyed, bool kVec>
__device__ __forceinline__ UStrip strip_u(const float* __restrict__ u_in,
                                          const long long* __restrict__ key, int row,
                                          bool has_row, int d, int t0, const Strip& st) {
  const int lane = threadIdx.x & 31;
  UStrip u;
  if (kKeyed) {
    const uint2 rk = fold_in(load_key(key), static_cast<uint32_t>(row));
    const uint32_t e0 = static_cast<uint32_t>(t0 + lane * kStrip);
#pragma unroll
    for (int q = 0; q < kStrip / 4; ++q) {
      const uint32_t e = e0 + 4 * q;
      const int k = 4 * q;
      u.set(q, make_float4(has_row && k < st.n ? uniform_at(rk, e) : INFINITY,
                           has_row && k + 1 < st.n ? uniform_at(rk, e + 1) : INFINITY,
                           has_row && k + 2 < st.n ? uniform_at(rk, e + 2) : INFINITY,
                           has_row && k + 3 < st.n ? uniform_at(rk, e + 3) : INFINITY));
    }
  } else {
    const float* ur = u_in + static_cast<size_t>(has_row ? row : 0) * d + t0 + lane * kStrip;
#pragma unroll
    for (int q = 0; q < kStrip / 4; ++q) {
      const int k = 4 * q;
      float4 x = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      if (kVec) {
        if (has_row && k < st.n) x = *reinterpret_cast<const float4*>(ur + k);
      } else if (has_row) {
        x = make_float4(k < st.n ? ur[k] : INFINITY, k + 1 < st.n ? ur[k + 1] : INFINITY,
                        k + 2 < st.n ? ur[k + 2] : INFINITY,
                        k + 3 < st.n ? ur[k + 3] : INFINITY);
      }
      u.set(q, x);
    }
  }
  return u;
}

// Pass 1.  kKeyed: u drawn from key (client c's from key + c * key_stride);
// else read from u_in.  kVec: p, a (and u, b) rows may be read 16 bytes at a
// time.  part: (C, NIS, n_pieces), bpart: (C, n_pieces).  Grid (tiles, row
// groups of kWarps).
template <bool kKeyed, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
seg_pass1(const float* __restrict__ u_in, const long long* __restrict__ key,
          const float* __restrict__ p, const float* __restrict__ a,
          const float* __restrict__ b, const int* __restrict__ seg,
          float* __restrict__ part, float* __restrict__ bpart, int clients, int nis,
          int d, int n_seg, int n_pieces, int n_stage, int key_stride) {
  extern __shared__ float4 smem4[];
  float* sp = reinterpret_cast<float*>(smem4);
  float* sa = sp + n_stage * kPadTile;

  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int len = min(kTile, d - t0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int cnt = min(n_stage, clients);
  stage<kVec>(sp, sa, p, a, 0, 1, d, t0, len);
  cp_async_commit();
  stage<kVec>(sp + kPadTile, sa + kPadTile, p, a, 1, cnt - 1, d, t0, len);
  cp_async_commit();

  const Strip st = strip_of(seg, t0, len);

  // b sums of (client, tile): row independent, spread over the row groups'
  // warps.
  for (int c = blockIdx.y + gridDim.y * warp; c < clients; c += gridDim.y * kWarps) {
    const BVals<kVec> vals{b + static_cast<size_t>(c) * d + t0 + lane * kStrip, st.n};
    reduce_pieces(vals, st, seg + t0 + lane * kStrip,
                  bpart + static_cast<size_t>(c) * n_pieces + tile, n_seg);
  }

  const int row = blockIdx.y * kWarps + warp;
  const bool has_row = row < nis;   // uniform over the warp
  SelectVals sv;
  // Client 0's strip (every client's under a shared key), while copies arrive.
  sv.u = strip_u<kKeyed, kVec>(u_in, key, row, has_row, d, t0, st);
  const int off = lane * kPadStrip;
  for (int c0 = 0; c0 < clients; c0 += n_stage) {
    if (c0 > 0) {
      cnt = min(n_stage, clients - c0);
      __syncthreads();  // every warp is done with the previous clients
      stage<kVec>(sp, sa, p, a, c0, 1, d, t0, len);
      cp_async_commit();
      stage<kVec>(sp + kPadTile, sa + kPadTile, p, a, c0 + 1, cnt - 1, d, t0, len);
      cp_async_commit();
    }
    float* dst = part + (static_cast<size_t>(c0) * nis + row) * n_pieces + tile;
    for (int j = 0; j < cnt; ++j) {
      if (j == 0) {  // the first client's copies have landed
        cp_async_wait<1>();
        __syncthreads();
      }
      if (j == 1) {  // and the others'
        cp_async_wait<0>();
        __syncthreads();
      }
      if (kKeyed && key_stride != 0 && c0 + j > 0) {  // this client's own strip
        sv.u = strip_u<kKeyed, kVec>(u_in, key + static_cast<size_t>(c0 + j) * key_stride,
                                     row, has_row, d, t0, st);
      }
      if (has_row) {
        sv.sp = sp + j * kPadTile + off;
        sv.sa = sa + j * kPadTile + off;
        reduce_pieces(sv, st, seg + t0 + lane * kStrip,
                      dst + static_cast<size_t>(j) * nis * n_pieces, n_seg);
      }
    }
    cp_async_wait<0>();  // (one client: the empty second group)
  }
}

// Pass 2, one warp per (client, segment).  kKeyed: add the Gumbel noise of
// select_key[c] and write the argmax to idx (C, n_seg).
template <bool kKeyed>
__global__ void __launch_bounds__(kThreads)
seg_pass2(const float* __restrict__ part, const float* __restrict__ bpart,
          const int* __restrict__ seg, const long long* __restrict__ select_key,
          float* __restrict__ out, long long* __restrict__ idx, int clients, int nis,
          int d, int n_seg, int n_pieces) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(clients) * n_seg) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int c = static_cast<int>(w / n_seg);
  const int s = static_cast<int>(w - static_cast<long long>(c) * n_seg);
  const int lo = warp_lower_bound(seg, d, s);
  const int hi = warp_lower_bound(seg, d, s + 1);
  const int k0 = lo / kTile;
  const int k1 = lo < hi ? (hi - 1) / kTile : k0 - 1;  // no piece if empty
  const float* br = bpart + static_cast<size_t>(c) * n_pieces + s;
  float bs = 0.f;
  for (int k = k0; k <= k1; ++k) bs += br[k];
  uint2 sk = make_uint2(0u, 0u);
  if (kKeyed) sk = load_key(select_key + 2 * static_cast<size_t>(c));
  float best = -INFINITY;
  int best_i = 0x7fffffff;
  for (int i = lane; i < nis; i += 32) {
    const size_t ci = static_cast<size_t>(c) * nis + i;
    const float* pr = part + ci * n_pieces + s;
    float xs = 0.f;
    for (int k = k0; k <= k1; ++k) xs += pr[k];
    const float lw = xs + bs;
    out[ci * n_seg + s] = lw;
    if (kKeyed) {
      const uint32_t j = static_cast<uint32_t>(static_cast<uint64_t>(i) * n_seg + s);
      const float ug = fminf(fmaxf(uniform_at(sk, j), 1e-12f), 1.0f - 1e-12f);
      const float score = lw + -logf(-logf(ug));
      if (beats(score, i, best, best_i)) {
        best = score;
        best_i = i;
      }
    }
  }
  if (kKeyed) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, best_i, off);
      if (beats(ov, oi, best, best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane == 0) idx[w] = best_i;
  }
}

// Pass 3: sample[c, e] = uniform_at(fold_in(key[c], idx[c, seg[e]]), e) < p[c, e]
// (0 where seg[e] >= n_seg); key[c] is at key + c * key_stride.
__global__ void __launch_bounds__(kThreads)
seg_select(const long long* __restrict__ key, const long long* __restrict__ idx,
           const float* __restrict__ p, const int* __restrict__ seg,
           float* __restrict__ sample, long long total, int d, int n_seg, int key_stride) {
  const uint2 k0 = load_key(key);
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * kThreads) {
    const long long c = t / d;
    const int e = static_cast<int>(t - c * d);
    const int s = seg[e];
    float x = 0.f;
    if (s < n_seg) {
      const uint32_t r = static_cast<uint32_t>(idx[c * n_seg + s]);
      const uint2 k = key_stride ? load_key(key + c * key_stride) : k0;
      x = uniform_at(fold_in(k, r), static_cast<uint32_t>(e)) < p[t] ? 1.f : 0.f;
    }
    sample[t] = x;
  }
}

template <bool kKeyed>
cudaError_t launch_pass1(const float* u, const long long* key, const float* p,
                         const float* a, const float* b, const int* seg, float* part,
                         float* bpart, int clients, int nis, int d, int n_seg,
                         int n_pieces, int key_stride, cudaStream_t st) {
  const int n_stage = clients < kMaxStage ? clients : kMaxStage;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n_stage) * kPadTile;
  const bool vec = d % 4 == 0 && aligned16(p) && aligned16(a) && aligned16(b) &&
                   (kKeyed || aligned16(u));
  const dim3 grid((d + kTile - 1) / kTile, (nis + kWarps - 1) / kWarps);
  auto kernel = vec ? seg_pass1<kKeyed, true> : seg_pass1<kKeyed, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(u, key, p, a, b, seg, part, bpart, clients, nis, d,
                                       n_seg, n_pieces, n_stage, key_stride);
  return cudaGetLastError();
}

unsigned blocks_for(long long warps_or_threads, int per_block) {
  return static_cast<unsigned>((warps_or_threads + per_block - 1) / per_block);
}

}  // namespace

// Piece slots per (client, row) row of the piece buffers:
// part is (C, NIS, n_pieces) and bpart (C, n_pieces) floats.
extern "C" int segment_logw_pieces(int d, int n_seg) {
  return n_seg + (d + kTile - 1) / kTile;
}

// u-fed form: logW (C, NIS, n_seg) from u (NIS, D).
extern "C" int segment_logw_launch(const void* u, const void* p, const void* a,
                                   const void* b, const void* seg, void* part, void* bpart,
                                   void* out, int clients, int nis, int d, int n_seg,
                                   void* stream) {
  if (clients <= 0 || nis <= 0 || n_seg <= 0 || d <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pieces = segment_logw_pieces(d, n_seg);
  cudaError_t err = launch_pass1<false>(
      static_cast<const float*>(u), nullptr, static_cast<const float*>(p),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(seg), static_cast<float*>(part), static_cast<float*>(bpart),
      clients, nis, d, n_seg, n_pieces, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_pass2<false><<<blocks_for(static_cast<long long>(clients) * n_seg, kWarps), kThreads,
                     0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(bpart),
      static_cast<const int*>(seg), nullptr, static_cast<float*>(out), nullptr, clients, nis,
      d, n_seg, n_pieces);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3 alone (the decoder): sample (C, D) from idx (C, n_seg); key is
// one (2,) key (key_stride 0) or (C, 2), one per client (key_stride 2).
extern "C" int segment_select_launch(const void* key, const void* idx, const void* p,
                                     const void* seg, void* sample, int clients, int d,
                                     int n_seg, int key_stride, void* stream) {
  if (key_stride != 0 && key_stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(clients) * d;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  seg_select<<<blocks_for(total, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<const long long*>(idx),
      static_cast<const float*>(p), static_cast<const int*>(seg),
      static_cast<float*>(sample), total, d, n_seg, key_stride);
  return static_cast<int>(cudaGetLastError());
}

// Keyed form, the whole segment encoder: logW (C, NIS, n_seg), idx
// (C, n_seg) int64 and sample (C, D) from the candidate key -- (2,), shared
// by the clients (key_stride 0), or (C, 2), one per client (key_stride 2)
// -- and select_key (C, 2) (int64 words), in three launches.
extern "C" int segment_mrc_encode_launch(const void* key, const void* select_key,
                                         const void* p, const void* a, const void* b,
                                         const void* seg, void* part, void* bpart,
                                         void* logw, void* idx, void* sample, int clients,
                                         int nis, int d, int n_seg, int key_stride,
                                         void* stream) {
  if (key_stride != 0 && key_stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (clients <= 0 || nis <= 0 || n_seg <= 0 || d <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_pieces = segment_logw_pieces(d, n_seg);
  cudaError_t err = launch_pass1<true>(
      nullptr, static_cast<const long long*>(key), static_cast<const float*>(p),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(seg), static_cast<float*>(part), static_cast<float*>(bpart),
      clients, nis, d, n_seg, n_pieces, key_stride, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_pass2<true><<<blocks_for(static_cast<long long>(clients) * n_seg, kWarps), kThreads, 0,
                    st>>>(
      static_cast<const float*>(part), static_cast<const float*>(bpart),
      static_cast<const int*>(seg), static_cast<const long long*>(select_key),
      static_cast<float*>(logw), static_cast<long long*>(idx), clients, nis, d, n_seg,
      n_pieces);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return segment_select_launch(key, idx, p, seg, sample, clients, d, n_seg, key_stride,
                               stream);
}

extern "C" const char* segment_logw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
