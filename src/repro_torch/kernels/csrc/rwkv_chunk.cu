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
// load; u: (H, 64) f32; out: (B, S, H, 64) contiguous, in r's type.  The
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
// Design.  One CTA of 256 threads owns one (batch, head) and walks its
// chunks in order, with the state S in shared memory (16 KB) for the whole
// sequence.  Per chunk it stages r, k, v and logw (f32, rows padded to 65
// floats so that column reads do not conflict), and then, each step
// separated by a barrier: (1) 64 threads scan logw down the columns into
// c_t and c_{t-1} while 64 others form the u bonus per token; (2) each
// thread computes a 4 x 4 block of the strictly lower (C, C) score matrix
// (rows ty + 16 i, columns tx + 16 j) with its pairwise exponentials; (3)
// r becomes r e^{c_{t-1}} and k becomes k e^{c_C - c_s} in place; (4) each
// thread sums its 4 x 4 block of o from the inter-chunk, intra-chunk and
// bonus terms and writes it; (5) each thread updates its 4 x 4 block of S.
// Another split, a grid of (batch * head, Dh / 16) over the state's value
// columns, would fill more SMs at B 2 (64 CTAs for 132 SMs), but every one
// of its CTAs would recompute the (C, C) scores, the SFU-bound part, so it
// would do four times the exponentials; this kernel does them once.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;         // chunk length
constexpr int kD = 64;         // head size
constexpr int kLd = kD + 1;    // padded row stride in shared memory
constexpr int kTile = kC * kLd;
constexpr int kThreads = 256;  // 16 x 16

// Element strides of (r, k, v, logw) x (batch, sequence, head), by value.
struct Strides {
  int64_t s[12];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ lw,
                  const float* __restrict__ u, T* __restrict__ out, int seq, int h,
                  Strides sd) {
  const int64_t* st = sd.s;
  extern __shared__ float smem[];
  float* rs = smem;              // r, then r e^{c_{t-1}}
  float* ks = rs + kTile;        // k, then k e^{c_C - c_s}
  float* vs = ks + kTile;
  float* cp = vs + kTile;        // logw, then c_{t-1}
  float* cs = cp + kTile;        // c_t
  float* ps = cs + kTile;        // scores (t, s), 0 where s >= t
  float* ss = ps + kTile;        // state (k, v)
  float* bonus = ss + kD * kLd;  // (C,) sum_k r u k

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / h, hh = blockIdx.x - b * h;
  const T* ptr[4] = {r + b * st[0] + hh * st[2], k + b * st[3] + hh * st[5],
                     v + b * st[6] + hh * st[8], lw + b * st[9] + hh * st[11]};
  const int64_t step[4] = {st[1], st[4], st[7], st[10]};
  float* dst[4] = {rs, ks, vs, cp};
  const float* ub = u + hh * kD;

  for (int idx = tid; idx < kD * kLd; idx += kThreads) ss[idx] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += kC) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int idx = tid; idx < kC * kD; idx += kThreads) {
      const int t = idx / kD, d = idx - t * kD;
      const bool in = t0 + t < seq;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        dst[a][t * kLd + d] = in ? to_f32(ptr[a][(int64_t)(t0 + t) * step[a] + d]) : 0.f;
    }
    __syncthreads();

    // (1) c_t and c_{t-1} down each channel; the u bonus per token.
    if (tid < kD) {
      float c = 0.f;
      for (int t = 0; t < kC; ++t) {
        const float w = cp[t * kLd + tid];
        c += w;
        cs[t * kLd + tid] = c;
        cp[t * kLd + tid] = c - w;
      }
    } else if (tid < kD + kC) {
      const int t = tid - kD;
      float acc = 0.f;
      for (int d = 0; d < kD; ++d) acc += rs[t * kLd + d] * ub[d] * ks[t * kLd + d];
      bonus[t] = acc;
    }
    __syncthreads();

    // (2) scores p[t][s] = sum_k r_tk k_sk e^{min(c_{t-1,k} - c_{s,k}, 0)}, s < t.
    {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
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
              p[i][j] += rt[i] * kk[j] * expf(fminf(ct[i] - cc[j], 0.f));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kLd + tx + 16 * j] = p[i][j];
    }
    __syncthreads();

    // (3) r e^{c_{t-1}} and k e^{c_C - c_s}, in place.
    for (int idx = tid; idx < kC * kD; idx += kThreads) {
      const int t = idx / kD, d = idx - t * kD;
      rs[t * kLd + d] *= expf(cp[t * kLd + d]);
      ks[t * kLd + d] *= expf(cs[(kC - 1) * kLd + d] - cs[t * kLd + d]);
    }
    __syncthreads();

    // (4) o = inter + intra + bonus.
    {
      float oi[4][4], oa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) oi[i][j] = oa[i][j] = 0.f;
      for (int d = 0; d < kD; ++d) {
        float a[4], sv[4], pa[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = rs[(ty + 16 * i) * kLd + d];
          pa[i] = ps[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sv[j] = ss[d * kLd + tx + 16 * j];
          vv[j] = vs[d * kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            oi[i][j] = fmaf(a[i], sv[j], oi[i][j]);
            oa[i][j] = fmaf(pa[i], vv[j], oa[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t >= seq) continue;
        T* orow = out + (((int64_t)b * seq + t0 + t) * h + hh) * kD;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          store(orow + c, oi[i][j] + oa[i][j] + bonus[t] * vs[t * kLd + c]);
        }
      }
    }
    __syncthreads();  // every thread has read the old state

    // (5) S' = e^{c_C} . S + sum_s (k_s e^{c_C - c_s}) v_s^T.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const float decay = expf(cs[(kC - 1) * kLd + row]);
      float acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = 0.f;
      for (int s = 0; s < kC; ++s) {
        const float kd = ks[s * kLd + row];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(kd, vs[s * kLd + tx + 16 * j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* sp = ss + row * kLd + tx + 16 * j;
        *sp = decay * *sp + acc[j];
      }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const float* u,
           void* out, int b, int seq, int h, const int64_t* strides, cudaStream_t stream) {
  Strides sd;
  for (int i = 0; i < 12; ++i) sd.s[i] = strides[i];
  const size_t smem = sizeof(float) * (6 * (size_t)kTile + kD * kLd + kC);
  auto kern = rwkv_chunk_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<b * h, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), u, static_cast<T*>(out), seq, h, sd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: 12 element strides (host memory), (r, k, v, logw) x (batch,
// sequence, head).  dtype: 0 = float32, 1 = bfloat16.  The head
// size is 64 (checked by the Python wrapper).
int rwkv_chunk_launch(const void* r, const void* k, const void* v, const void* lw,
                      const void* u, void* out, int b, int seq, int h,
                      const int64_t* strides, int dtype, void* stream) {
  if (b <= 0 || seq <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  if (dtype == 0) return launch<float>(r, k, v, lw, uf, out, b, seq, h, strides, s);
  return launch<__nv_bfloat16>(r, k, v, lw, uf, out, b, seq, h, strides, s);
}

const char* rwkv_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
