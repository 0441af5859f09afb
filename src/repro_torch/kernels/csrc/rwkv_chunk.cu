// Chunked RWKV-6 time-mix from a zero state on Hopper (sm_90a).
//
// Per (batch, head), with c_t = cumsum(logw) inside a chunk of C = 64
// tokens (c_{t-1} computed as c_t - logw_t, as the reference does) and a
// (Dh, Dh) f32 state S carried from chunk to chunk (S = 0 at the start):
//
//   o_t = (r_t . e^{c_{t-1}}) S
//         + sum_{s<t} (sum_k r_tk k_sk e^{min(c_{t-1,k} - c_{s,k}, 0)}) v_s
//         + (sum_k r_tk u_k k_tk) v_t
//   S'  = e^{c_C} . S + sum_s (k_s e^{c_C - c_s}) v_s^T
//
// r, k, v, logw: (B, S, H, 64), f32 or bf16 (all four alike), upcast on
// load; u: (H, 64) f32; out: (B, S, H, 64) contiguous, in r's type;
// scratch: (B, S, H, 64) f32, contiguous, written by pass A, read by B.  The
// last axis of each input must have stride 1; the others are read through
// their strides.  A ragged last chunk is read as the reference pads it:
// r, k, v = 0 and logw = 0.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_chunk.py::
// rwkv_chunk_pallas (pallas_call at rwkv_chunk.py:90), whose wrapper
// (repro/kernels/ops.py:149) folded the heads into the batch, padded S to
// the chunk and tiled u per (batch, head).  Here the kernel reads the
// model's layout and indexes u by head; and the (C, C, Dh) pairwise-decay
// tensor that the TPU kernel built in VMEM (rwkv_chunk.py:55-56) never
// exists: each score computes its exponentials as it needs them.
//
// Bound.  At RWKV-6 1.6B's prefill (B 2, S 4096, H 32, Dh 64, f32) the
// bytes are r, k, v, logw in and out written, 335 MB: 0.100 ms at
// 3.35 TB/s.  The fewest operations the function needs are the per-token
// recurrence's, about 5 Dh^2 per token and head (r.S, then S = w*S + k v^T):
// 5.5e9, or 0.082 ms at 67 TFLOP/s.  So the function is bound by its bytes.
// This chunked form does more work than that, ~7.6e9 f32 operations plus
// the C * C * Dh / 2 pairwise exponentials per chunk (5.4e8 here), which
// run on the SFUs at a sixteenth of the FMA rate; the chunks buy parallel
// work across the tokens of a chunk, which the recurrence lacks.
//
// Design: two launches from one wrapper call, so that the pairwise part
// and the state carry each fill the card.
//
// Pass A, intra-chunk (grid (chunks, H, B): 4096 CTAs of 256 threads at the
// prefill shape).  A CTA stages one chunk's r, k, v and logw (all loads
// issued before the first is stored; f32, rows padded to 65 floats so that
// column reads do not conflict), forms the u bonus per token, scans logw
// down the columns into c_t and c_{t-1}, computes the strictly lower (C, C)
// scores with their pairwise exponentials once (each thread a 4 x 4 block,
// rows ty + 16 i, columns tx + 16 j), and writes o_intra + bonus to the f32
// scratch.  The pairwise exponent
// x = min(c_{t-1} - c_s, 0) (the difference taken first, as the reference
// does) is at most 0, so it is taken as 2^(x log2 e): ex2's relative
// error is ~2^-22, and rounding x * log2 e adds |x| 2^-24 in the exponent,
// so a term e^x r k is off by at most ~6e-8 x e^x |x| of |r k|, under
// 2.2e-8 |r k| for every x <= 0, far inside the 1e-5 the kernel is held to.
//
// Pass B, inter-chunk (grid (B * H, 64 / G), G = 16 value columns: 256 CTAs
// at the prefill shape).  A CTA walks the chunks in order with its (64, G)
// slice of the state S in shared memory, transposed.  Per chunk it stages
// r, k (transposed), logw and its G columns of v (transposed), recomputes
// c_t and c_{t-1} with the same scan as pass A (2 C Dh exponentials a chunk,
// 1/16 of pass A's), forms r e^{c_{t-1}} and k e^{c_C - c_s}, writes out =
// scratch + (r e^{c_{t-1}}) S[:, cols] in r's type (four warps), and
// updates S[:, cols] = e^{c_C} S + (k e^{c_C - c_s})^T v[:, cols] into a
// second copy of the slice (the other four) in the same phase; each thread
// a 4 x 2 block, reading float4s along rows padded to 68 floats.  No CTA repeats the (C, C)
// exponentials, so the four column groups of a head cost no SFU work twice.
// The scan runs in registers: the thread that sums rows 16 q .. 16 q + 15
// of column d scales exactly those (t, d) of r and k.  A chunk step is then
// three barriers over 8 warps, with ~2 CTAs to an SM: this pass is bound by
// the latency of that chain, not by its bytes or operations.
//
// Both passes scan logw with all 256 threads (four 16-row segments per
// column, their sums added in order) and take every exponential with
// ex2.approx.ftz on an exponent <= 0: relative error ~2^-22, and results
// below 2^-126 (far under what the sums can resolve) flush to 0.
//
// Cost of the split.  The scratch is written and read once: 2 x 4 B S H 64
// = 134 MB at the prefill shape, ~0.04 ms at 3.35 TB/s.  Pass B also reads
// r, k and logw once per column group (4 times), mostly from L2.  Neither
// counts in the function's bound above.  Tensor cores are not used: the
// per-channel decay inside the score sum cannot be factored out of it
// (e^{-c_s} overflows for logw down to -e^8).
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kC = 64;         // chunk length
constexpr int kD = 64;         // head size
constexpr int kG = 16;         // value columns of the state per pass-B CTA
constexpr int kLd = kD + 1;    // padded row stride for column access
constexpr int kLv = kD + 4;    // padded row stride for float4 access along rows
constexpr int kTile = kC * kLd;
constexpr int kThreads = 256;  // 16 x 16

// Element strides of (r, k, v, logw) x (batch, sequence, head), by value.
struct Strides {
  int64_t s[12];
};

// One chunk of one (batch, head) of x, rows t0 .. t0 + kC - 1, columns
// c0 .. c0 + NCOL - 1, zeros past the sequence: kC * NCOL / kThreads values
// per thread, all loads issued before any is used (load), then written to
// shared memory as [t][d] or, TRANS, as [d][t], with row stride ld (put).
template <int NCOL>
constexpr int kPer = kC * NCOL / kThreads;

template <int NCOL, typename T>
__device__ __forceinline__ void load(float (&buf)[kPer<NCOL>], const T* x,
                                     int64_t step, int t0, int seq, int c0) {
#pragma unroll
  for (int i = 0; i < kPer<NCOL>; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / NCOL, d = idx % NCOL;
    buf[i] = t0 + t < seq ? to_f32(x[(int64_t)(t0 + t) * step + c0 + d]) : 0.f;
  }
}

template <int NCOL, bool TRANS = false>
__device__ __forceinline__ void put(float* dst, int ld, const float (&buf)[kPer<NCOL>]) {
#pragma unroll
  for (int i = 0; i < kPer<NCOL>; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = idx / NCOL, d = idx % NCOL;
    dst[TRANS ? d * ld + t : t * ld + d] = buf[i];
  }
}

// c_t and c_{t-1} down every column of a chunk, by all kThreads threads:
// thread (q, d) sums rows 16 q .. 16 q + 15 of column d, the four partial
// sums are added in order, and each thread then writes its rows.  cp holds
// logw on entry and c_{t-1} = c_t - logw_t (the reference's form) on exit;
// cs holds c_t.  Pass B does the same sums in the same order in registers,
// so both passes see the same c.  part: (4, Dh) floats of scratch.  Begins
// and ends with all threads synced.
__device__ __forceinline__ void scan_chunk(float* cp, float* cs, float* part) {
  const int d = threadIdx.x & (kD - 1), q = threadIdx.x >> 6, t0 = 16 * q;
  float c = 0.f;
#pragma unroll
  for (int t = t0; t < t0 + 16; ++t) c += cp[t * kLd + d];
  part[q * kD + d] = c;
  __syncthreads();
  c = 0.f;
  for (int p = 0; p < q; ++p) c += part[p * kD + d];
#pragma unroll
  for (int t = t0; t < t0 + 16; ++t) {
    const float w = cp[t * kLd + d];
    c += w;
    cs[t * kLd + d] = c;
    cp[t * kLd + d] = c - w;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv_intra(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ lw, const float* __restrict__ u,
           float* __restrict__ scratch, int seq, int h, Strides sd) {
  const int64_t* st = sd.s;
  extern __shared__ float smem[];
  float* rs = smem;              // r, then the scores (t, s), 0 where s >= t
  float* ks = rs + kTile;
  float* vs = ks + kTile;
  float* cp = vs + kTile;        // logw, then c_{t-1}
  float* cs = cp + kTile;        // c_t
  float* bonus = cs + kTile;     // (C,) sum_k r u k
  float* part = bonus + kC;      // (4, Dh) scan partial sums

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int t0 = blockIdx.x * kC, hh = blockIdx.y, b = blockIdx.z;
  {
    float b0[kPer<kD>], b1[kPer<kD>];
    load<kD>(b0, r + b * st[0] + hh * st[2], st[1], t0, seq, 0);
    load<kD>(b1, k + b * st[3] + hh * st[5], st[4], t0, seq, 0);
    put<kD>(rs, kLd, b0);
    put<kD>(ks, kLd, b1);
    load<kD>(b0, v + b * st[6] + hh * st[8], st[7], t0, seq, 0);
    load<kD>(b1, lw + b * st[9] + hh * st[11], st[10], t0, seq, 0);
    put<kD>(vs, kLd, b0);
    put<kD>(cp, kLd, b1);
  }
  __syncthreads();

  // (1) The u bonus per token (four threads a token, 16 channels each),
  // then c_t and c_{t-1}.
  {
    const int t = tid >> 2, d0 = 16 * (tid & 3);
    const float* ub = u + hh * kD;
    float acc = 0.f;
#pragma unroll
    for (int d = d0; d < d0 + 16; ++d) acc += rs[t * kLd + d] * ub[d] * ks[t * kLd + d];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if ((tid & 3) == 0) bonus[t] = acc;
  }
  scan_chunk(cp, cs, part);

  // (2) scores p[t][s] = sum_k r_tk k_sk e^{min(c_{t-1,k} - c_{s,k}, 0)}, s < t.
  float p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
  if (tx < ty + 48) {  // some (i, j) of this thread's block lies below the diagonal
    for (int d = 0; d < kD; ++d) {
      float rt[4], ct[4], kk[4], cc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rt[i] = rs[(ty + 16 * i) * kLd + d];
        ct[i] = cp[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * kLd + d];
        cc[j] = cs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (tx + 16 * j < ty + 16 * i)
            p[i][j] += rt[i] * kk[j] * ex2(fminf(ct[i] - cc[j], 0.f) * kLog2e);
    }
  }
  __syncthreads();  // every thread has read r
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) rs[(ty + 16 * i) * kLd + tx + 16 * j] = p[i][j];
  __syncthreads();

  // (3) o_intra + bonus, to the scratch.
  float oa[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oa[i][j] = 0.f;
  for (int s = 0; s < kC; ++s) {
    float pa[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = rs[(ty + 16 * i) * kLd + s];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = vs[s * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) oa[i][j] = fmaf(pa[i], vv[j], oa[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t0 + t >= seq) continue;
    float* orow = scratch + (((int64_t)b * seq + t0 + t) * h + hh) * kD;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      orow[c] = oa[i][j] + bonus[t] * vs[t * kLd + c];
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv_inter(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ lw, const float* __restrict__ scratch, T* __restrict__ out,
           int seq, int h, Strides sd) {
  const int64_t* st = sd.s;
  extern __shared__ float smem[];
  // Rows of kLv floats are read as float4s along the row.
  float* rs = smem;              // [t][d]: r, then r e^{c_{t-1}}
  float* kt = rs + kC * kLv;     // [d][s]: k transposed, then k e^{c_C - c_s}
  float* vt = kt + kD * kLv;     // [j][s]: columns c0 .. c0 + G - 1 of v, transposed
  float* sT = vt + kG * kLv;     // [j][d]: the same columns of the state, transposed,
                                 // twice: read one, write the other, then swap
  float* part = sT + 2 * kG * kLv;  // (4, Dh) scan partial sums
  float* decay = part + 4 * kD;  // (Dh,) e^{c_C}

  const int tid = threadIdx.x;
  const bool update = tid >= kThreads / 2;        // products: which of the two
  const int ty = (tid & 127) >> 3, tx = tid & 7;  // and the 4 x 2 block in it
  const int d = tid & (kD - 1), q = tid >> 6;     // scan: column d, rows 16 q .. 16 q + 15
  const int b = blockIdx.x / h, hh = blockIdx.x - b * h, c0 = blockIdx.y * kG;
  const T* rb = r + b * st[0] + hh * st[2];
  const T* kb = k + b * st[3] + hh * st[5];
  const T* vb = v + b * st[6] + hh * st[8];
  const T* lb = lw + b * st[9] + hh * st[11] + d;

  for (int idx = tid; idx < kG * kLv; idx += kThreads) sT[idx] = 0.f;

  for (int t0 = 0, cur = 0; t0 < seq; t0 += kC, cur ^= 1) {
    const float* s_in = sT + cur * kG * kLv;
    float* s_out = sT + (cur ^ 1) * kG * kLv;
    float br[kPer<kD>], bk[kPer<kD>], bv[kPer<kG>], w[16], intra[4][2];
    if (!update) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float* at = scratch + (((int64_t)b * seq + t) * h + hh) * kD + c0 + tx;
        intra[i][0] = t < seq ? at[0] : 0.f;
        intra[i][1] = t < seq ? at[8] : 0.f;
      }
    }
    load<kD>(br, rb, st[1], t0, seq, 0);
    load<kD>(bk, kb, st[4], t0, seq, 0);
    load<kG>(bv, vb, st[7], t0, seq, c0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = t0 + 16 * q + i;
      w[i] = t < seq ? to_f32(lb[(int64_t)t * st[10]]) : 0.f;
    }
    __syncthreads();  // the previous chunk's tiles are no longer read
    put<kD>(rs, kLv, br);
    put<kD, true>(kt, kLv, bk);
    put<kG, true>(vt, kLv, bv);

    // The scan of pass A (same sums in the same order), held in registers:
    // this thread's rows of column d, then r e^{c_{t-1}} and k e^{c_C - c_s}
    // for exactly those (t, d).  c_C is the four segment sums added in order.
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) c += w[i];
    part[q * kD + d] = c;
    __syncthreads();
    float off = 0.f, total = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p < q) off += part[p * kD + d];
      total += part[p * kD + d];
    }
    c = off;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = 16 * q + i;
      c += w[i];
      rs[t * kLv + d] *= ex2((c - w[i]) * kLog2e);
      kt[d * kLv + t] *= ex2((total - c) * kLog2e);
    }
    if (q == 0) decay[d] = ex2(total * kLog2e);
    __syncthreads();

    // Warps 0-3: out = scratch + (r e^{c_{t-1}}) S_in[:, cols].  Warps 4-7:
    // S_out[:, cols] = e^{c_C} S_in + (k e^{c_C - c_s})^T v[:, cols].  The
    // two are independent, so one phase.  Thread (ty, tx) of a group: rows
    // ty + 16 i, columns tx and tx + 8 (a 4 x 2 block; each float4 read
    // serves 8 products).
    const float* a = update ? kt : rs;
    const float* bm = update ? vt : s_in;
    float acc[4][2] = {};
#pragma unroll 4
    for (int dd = 0; dd < kD; dd += 4) {
      const float4 b0 = *reinterpret_cast<const float4*>(bm + tx * kLv + dd);
      const float4 b1 = *reinterpret_cast<const float4*>(bm + (tx + 8) * kLv + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLv + dd);
        acc[i][0] = dot4(a4, b0, acc[i][0]);
        acc[i][1] = dot4(a4, b1, acc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tx + 8 * c;
        if (update) {
          s_out[col * kLv + row] = decay[row] * s_in[col * kLv + row] + acc[i][c];
        } else if (t0 + row < seq) {
          const int64_t at = (((int64_t)b * seq + t0 + row) * h + hh) * kD + c0 + col;
          store(out + at, intra[i][c] + acc[i][c]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           float* scratch, void* out, int b, int seq, int h, const int64_t* strides,
           cudaStream_t stream) {
  Strides sd;
  for (int i = 0; i < 12; ++i) sd.s[i] = strides[i];
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* lp = static_cast<const T*>(lw);
  const size_t smem_a = sizeof(float) * (5 * (size_t)kTile + kC + 4 * kD);
  const size_t smem_b = sizeof(float) * ((size_t)(kC + kD + 3 * kG) * kLv + 5 * kD);
  cudaError_t e = cudaFuncSetAttribute(rwkv_intra<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rwkv_inter<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (e != cudaSuccess) return (int)e;
  rwkv_intra<T><<<dim3((seq + kC - 1) / kC, h, b), kThreads, smem_a, stream>>>(
      rp, kp, vp, lp, u, scratch, seq, h, sd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rwkv_inter<T><<<dim3(b * h, kD / kG), kThreads, smem_b, stream>>>(
      rp, kp, vp, lp, scratch, static_cast<T*>(out), seq, h, sd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides (host memory), (r, k, v, logw) x (batch,
// sequence, head).  dtype: 0 = float32, 1 = bfloat16.  The head size is 64
// (checked by the Python wrapper).  scratch: (B, S, H, 64) f32, contiguous.
int rwkv_chunk_launch(const void* r, const void* k, const void* v, const void* lw,
                      const void* u, void* scratch, void* out, int b, int seq, int h,
                      const int64_t* strides, int dtype, void* stream) {
  if (b <= 0 || seq <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch<float>(r, k, v, lw, uf, sc, out, b, seq, h, strides, s);
  return launch<__nv_bfloat16>(r, k, v, lw, uf, sc, out, b, seq, h, strides, s);
}

const char* rwkv_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
