// Flash attention (causal or sliding-window softmax attention with an
// online softmax in f32) on Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, h / rep]
//
// over the keys j that the mask leaves: j < Skv, j <= i when causal,
// j > i - window when window > 0.  q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv,
// Dh), H = rep * Hkv (GQA); f32 or bf16 (all three alike), upcast to f32 on
// load; out: (B, Sq, H, Dh) contiguous, in q's type.  The last axis of each
// input must have stride 1; the other axes are read through their strides.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::
// flash_attention_pallas (pallas_call at flash_attn.py:95).  Its wrapper
// (repro/kernels/ops.py:120) repeated the kv heads, folded the heads into
// the batch and padded Sq, Skv and Dh to 128 for the MXU; this kernel reads
// the model's (B, S, H, Dh) layout directly, takes the kv head as h / rep,
// and masks the ragged edges itself, so none of those copies exists.
//
// Bound.  At the prefill shape of Qwen3-1.7B (B 2, S 4096, H 16, Hkv 8,
// Dh 128, bf16, causal) the work is 4 B H S^2 Dh / 2 = 1.37e11 flop:
// 0.139 ms on the bf16 tensor cores (989 TFLOP/s), the card's least time;
// the bytes (q, k, v in, out written, ~100 MB) take 0.03 ms.  This kernel
// does its arithmetic in f32 on the CUDA cores, as the TPU kernel did in
// f32, so its own floor is 2.05 ms at 67 TFLOP/s, and its inner products
// read their operands from shared memory.
//
// Design.  One CTA of 256 threads per (64 query rows, head, batch).  It
// keeps the scaled Q tile in shared memory and walks the kv tiles of 64
// keys that the causal or window mask leaves (wholly masked tiles are
// skipped; a row's masked entries inside a visited tile score NEG_INF =
// -1e9, as the reference model's scan does).  Per tile: K is staged
// transposed and padded (conflict-free column reads), V row-major; each
// thread computes a 4 x 4 block of scores (rows ty + 16 i, keys tx + 16 j),
// the 16 threads of a row reduce its max and sum with shuffles, P goes to
// shared memory, and each thread updates its 4 rows x ceil(Dh/16) columns
// of the f32 accumulator in registers.  The running max and denominator
// live in registers (replicated over a row's 16 threads).  The output is
// acc / max(l, 1e-30).  No tensor cores yet: wgmma with bf16 operands, TMA
// loads and warp specialisation are the later, faster design.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = kBK + 1;  // row stride of the transposed K and of P
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int NCOL>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out,
                  int sq, int skv, int h, int dh, int rep,
                  int64_t qsb, int64_t qss, int64_t qsh,
                  int64_t ksb, int64_t kss, int64_t ksh,
                  int64_t vsb, int64_t vss, int64_t vsh,
                  int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // (kBQ, dh)
  float* kt = qs + kBQ * dh;            // (dh, kPad): K transposed
  float* vs = kt + dh * kPad;           // (kBK, dh)
  float* ps = vs + kBK * dh;            // (kBQ, kPad)

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int hk = hh / rep;
  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int idx = tid; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh, d = idx - r * dh;
    qs[idx] = (q0 + r < sq) ? to_f32(qb[(int64_t)(q0 + r) * qss + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[i][j] = 0.f;
  }

  // kv tiles the mask leaves for rows q0 .. q0 + kBQ - 1.
  int kend = skv;
  if (causal) kend = min(kend, q0 + kBQ);
  int kstart = 0;
  if (window > 0) kstart = max(0, q0 - window + 1) / kBK * kBK;

  for (int k0 = kstart; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBK * dh; idx += kThreads) {
      const int c = idx / dh, d = idx - c * dh;
      const bool in = k0 + c < skv;
      kt[d * kPad + c] = in ? to_f32(kb[(int64_t)(k0 + c) * kss + d]) : 0.f;
      vs[idx] = in ? to_f32(vb[(int64_t)(k0 + c) * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * dh + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kt[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NCOL; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[NCOL];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int col = tx + 16 * j;
        vv[j] = col < dh ? vs[c * dh + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NCOL; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((int64_t)b * sq + r) * h + hh) * dh;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int col = tx + 16 * j;
      if (col < dh) store(orow + col, acc[i][j] * inv);
    }
  }
}

template <typename T, int NCOL>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
           int skv, int h, int hkv, int dh, const int64_t* st, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBQ * dh + (size_t)dh * kPad +
                                       (size_t)kBK * dh + (size_t)kBQ * kPad);
  auto kern = flash_attn_kernel<T, NCOL>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, h, dh, h / hkv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b, int sq,
             int skv, int h, int hkv, int dh, const int64_t* st, int causal,
             int window, float scale, cudaStream_t stream) {
  switch ((dh + 15) / 16) {
#define CASE(n) \
    case n: return launch<T, n>(q, k, v, out, b, sq, skv, h, hkv, dh, st, causal, \
                                window, scale, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// strides: 9 element strides (q, k, v) x (batch, sequence, head).
// dtype: 0 = float32, 1 = bfloat16.  dh <= 128 and a multiple of 8, h a
// multiple of hkv (checked by the Python wrapper).
int flash_attn_launch(const void* q, const void* k, const void* v, void* out, int b,
                      int sq, int skv, int h, int hkv, int dh, const int64_t* strides,
                      int dtype, int causal, int window, float scale, void* stream) {
  if (sq <= 0 || b <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, sq, skv, h, hkv, dh, strides, causal, window,
                           scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, hkv, dh, strides, causal,
                                 window, scale, s);
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
