// MRC importance log-weights over fixed-size blocks, and the fixed-block
// encoder fused around them, on Hopper (sm_90a).
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
// Two forms share one per-row sum order (mrc_row.cuh):
//
//   u-fed (mrc_logw_launch): x is read from memory.  The counterpart of
//     mrc_logw_pallas and of core/mrc's logw_fn hook.
//   keyed (mrc_fixed_encode_launch): core/mrc.encode_fixed's whole encoder.
//     Candidate row i of block j of client c is drawn in the kernel, bit for
//     bit prng.uniform(prng.fold_in(key_c, j), (NIS, S))[i] -- block key
//     fold_in(key_c, j) once per block, element (i, s) = uniform_at(block
//     key, i S + s) (common.cuh) -- and compared with p[c, j, :], so neither
//     the (C, B, NIS, S) uniforms nor x ever reach device memory.  key_c is
//     one (2,) key shared by the C clients (key_stride 0: BiCompFL-GR's
//     common candidates, drawn once for the cohort) or client c's own, at
//     key + 2 c (key_stride 2: the PR variants' private candidates).  The
//     kernel then adds the Gumbel noise -log(-log(clamp(u_g, 1e-12,
//     1 - 1e-12))), u_g = uniform_at(fold_in(select_key_c, j), i), takes the
//     argmax over the NIS rows (the first maximal index wins, as in
//     torch.argmax) and writes the chosen row's bits: logW (C, B, NIS),
//     idx (C, B) int64 and sample (C, B, S), in one launch.
//
// Bound.  u-fed: every element of x is read once for one multiply-add, 4
// bytes per 2 flops, memory-bound by far.  GR (2200, 64, 128): 72.1 MB of
// x, a, b and out 2.8 MB, ~0.022 ms at 3.35 TB/s; CFL (17600, 256, 16):
// 288 MB of x, 308.6 MB in all, ~0.092 ms.
// Keyed: the bytes are p, a, b, logW, idx and sample (CFL: 3.4 MB in, 18 MB
// of logW out, ~7 us), but every candidate element and every Gumbel
// uniform is a threefry draw of 70 SASS instructions on sm_90a (21 of them
// IMADs on the FMA pipe; chip_smoke.py reads the count from a probe), and
// an SM issues at most 128 thread instructions a clock (3.345e13/s on 132
// SMs at 1980 MHz): instruction-bound.  GR, shared key (C 10, B 220,
// NIS 64, S 128): 1.80e6 candidate + 1.41e5 Gumbel draws, ~0.0041 ms; PR
// uplink, client keys: 1.80e7 + 1.41e5, ~0.038 ms; CFL, shared key
// (B 1760, NIS 256, S 16): 7.21e6 + 4.51e6, ~0.025 ms.
//
// Design.
//
//   The row layout (mrc_row.cuh): a group of G = pow2(ceil(S/4)) <= 32
//   lanes owns a candidate row, each lane one 16-byte chunk of it (and
//   every G-th further chunk where S > 128), so at S = 16 four lanes own a
//   row and a warp covers 8 rows: every lane loads or draws, and a row pays
//   a 2-step shuffle instead of the 5-step tree of a warp per row.  Both
//   forms sum a row in this order, so the keyed form's logW is bit-identical
//   to the u-fed form fed prng's x.
//   u-fed: one CTA of 256 threads per block row nb; each lane keeps its
//     chunk of a in a register where S <= 4 G (one chunk per lane) and loads
//     four rows' chunks of x before it adds any of them (16-byte loads where
//     S % 4 == 0 and the pointers are aligned, else scalar loads masked by
//     s < S).  sum_s b is the same group sum with x = 1.
//   keyed: one CTA of 256 threads per block j (under client keys, per
//     (block, client)).  p and a of the CTA's clients for block j are staged
//     in shared memory by cp.async (zero past S), at most 16 clients a pass.
//     Each lane draws its chunk of a candidate row into registers once and
//     weighs it against every staged client (x = u < p, then the shared
//     fmaf order), so under a shared key a candidate is drawn once for the
//     cohort; the groups' sums go to a (clients, NIS) array in shared
//     memory.  Then every thread takes (client, row) pairs: writes logW,
//     draws the Gumbel uniform and stores the score in place; a warp per
//     client takes the argmax (a fixed reduction by beats(), common.cuh);
//     the chosen row's S elements are drawn again (S draws per client
//     instead of keeping NIS S uniforms) and written as bits.
//
// Every sum runs in a fixed order and no float atomics are used: a call is
// bitwise deterministic.  Built without --use_fast_math: logf is the
// accurate one, the same libm the plain route calls on the card.
//
// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "mrc_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;           // u-fed: rows of x loaded before any is summed
constexpr int kMaxStage = 16;              // keyed: clients weighed per pass over the rows
constexpr int kMaxSmem = 96 * 1024;        // keyed: dynamic shared memory a CTA may take
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// u-fed form.
// ---------------------------------------------------------------------------

template <int G, bool kVec>
__global__ void __launch_bounds__(kThreads)
mrc_logw_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, float* __restrict__ out, int nis, int s) {
  constexpr int kGroups = kThreads / G;
  const int nb = blockIdx.x;
  const int lg = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int nq = (s + 3) >> 2;
  const float* arow = a + static_cast<size_t>(nb) * s;
  const float bias = row_bias<G, kVec>(b + static_cast<size_t>(nb) * s, lg, s);
  const float* xb = x + static_cast<size_t>(nb) * nis * s;
  float* orow = out + static_cast<size_t>(nb) * nis;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (nq <= G) {  // one chunk per lane: a stays in a register
    const bool has = lg < nq;
    const float4 av = has ? load_chunk<kVec>(arow, lg, s) : zero;
    for (int i0 = 0; i0 < nis; i0 += kRowsInFlight * kGroups) {
      float4 xv[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int i = i0 + r * kGroups + group;
        xv[r] = has && i < nis ? load_chunk<kVec>(xb + static_cast<size_t>(i) * s, lg, s) : zero;
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int i = i0 + r * kGroups + group;
        const float acc = group_sum<G>(has ? chunk_fma(0.f, xv[r], av) : 0.f);
        if (lg == 0 && i < nis) orow[i] = acc + bias;
      }
    }
  } else {  // S > 128: every lane adds several chunks of the row
    for (int i0 = 0; i0 < nis; i0 += kGroups) {
      const int i = i0 + group;
      float acc = 0.f;
      if (i < nis) {
        const float* xrow = xb + static_cast<size_t>(i) * s;
        for (int q = lg; q < nq; q += G) {
          acc = chunk_fma(acc, load_chunk<kVec>(xrow, q, s), load_chunk<kVec>(arow, q, s));
        }
      }
      acc = group_sum<G>(acc);
      if (lg == 0 && i < nis) orow[i] = acc + bias;
    }
  }
}

template <int G>
cudaError_t launch_logw_g(const float* x, const float* a, const float* b, float* out, int nb,
                          int nis, int s, bool vec, cudaStream_t st) {
  if (vec) {
    mrc_logw_kernel<G, true><<<nb, kThreads, 0, st>>>(x, a, b, out, nis, s);
  } else {
    mrc_logw_kernel<G, false><<<nb, kThreads, 0, st>>>(x, a, b, out, nis, s);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Keyed form: the whole fixed-block encoder.
// ---------------------------------------------------------------------------

// Stage p and a of clients [c0, c0 + cnt) of block j into rows of s4
// floats, zero past s.  vec: s % 4 == 0 and p, a 16-byte aligned.
__device__ __forceinline__ void stage_block(float* sp, float* sa, const float* __restrict__ p,
                                            const float* __restrict__ a, int c0, int cnt,
                                            int j, int n_blocks, int s, int s4, bool vec) {
  if (vec) {
    const int q4 = s >> 2;
    for (int t = threadIdx.x; t < cnt * q4; t += kThreads) {
      const int c = t / q4;
      const int e = (t - c * q4) << 2;
      const size_t src = (static_cast<size_t>(c0 + c) * n_blocks + j) * s + e;
      cp_async16(sp + c * s4 + e, p + src);
      cp_async16(sa + c * s4 + e, a + src);
    }
  } else {
    for (int t = threadIdx.x; t < cnt * s4; t += kThreads) {
      const int c = t / s4;
      const int e = t - c * s4;
      if (e < s) {
        const size_t src = (static_cast<size_t>(c0 + c) * n_blocks + j) * s + e;
        cp_async4(sp + c * s4 + e, p + src);
        cp_async4(sa + c * s4 + e, a + src);
      } else {
        sp[c * s4 + e] = 0.f;
        sa[c * s4 + e] = 0.f;
      }
    }
  }
  cp_async_commit();
}

// kStage: clients a CTA weighs per pass -- kMaxStage under a shared key (the
// CTA serves the cohort), 1 under client keys (grid.y is the client).
template <int G, int kStage>
__global__ void __launch_bounds__(kThreads)
mrc_encode_kernel(const long long* __restrict__ key, const long long* __restrict__ select_key,
                  const float* __restrict__ p, const float* __restrict__ a,
                  const float* __restrict__ b, float* __restrict__ logw,
                  long long* __restrict__ idx, float* __restrict__ sample, int clients,
                  int n_blocks, int nis, int s, int n_stage, int sel_stride, bool vec) {
  constexpr int kGroups = kThreads / G;
  extern __shared__ float4 smem4[];
  __shared__ uint2 ssel[kStage];
  __shared__ float sbias[kStage];
  __shared__ int schosen[kStage];

  const int j = blockIdx.x;
  const int lg = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nq = (s + 3) >> 2;
  const int s4 = 4 * nq;
  float* sp = reinterpret_cast<float*>(smem4);
  float* sa = sp + n_stage * s4;
  float* slw = sa + n_stage * s4;

  const int c_lo = kStage == 1 ? static_cast<int>(blockIdx.y) : 0;
  const int c_hi = kStage == 1 ? c_lo + 1 : clients;
  const uint2 bkey = fold_in(load_key(key + 2 * static_cast<size_t>(kStage == 1 ? c_lo : 0)),
                             static_cast<uint32_t>(j));

  for (int c0 = c_lo; c0 < c_hi; c0 += n_stage) {
    const int cnt = min(n_stage, c_hi - c0);
    if (c0 > c_lo) __syncthreads();  // the previous pass is done with shared memory
    stage_block(sp, sa, p, a, c0, cnt, j, n_blocks, s, s4, vec);
    if (threadIdx.x < cnt) {
      ssel[threadIdx.x] = fold_in(
          load_key(select_key + static_cast<size_t>(c0 + threadIdx.x) * sel_stride),
          static_cast<uint32_t>(j));
    }
    for (int cb = 0; cb < cnt; cb += kGroups) {  // warp-uniform trip count
      const int c = cb + group;
      const float* brow = b + (static_cast<size_t>(c0 + min(c, cnt - 1)) * n_blocks + j) * s;
      const float v = row_bias<G, false>(brow, lg, s);
      if (lg == 0 && c < cnt) sbias[c] = v;
    }
    cp_async_wait<0>();
    __syncthreads();

    // The candidate rows: group -> row i, lane -> its chunks; each chunk is
    // drawn once and weighed against every staged client.
    for (int i0 = 0; i0 < nis; i0 += kGroups) {
      const int i = i0 + group;
      const bool row_ok = i < nis;
      float acc[kStage];
#pragma unroll
      for (int c = 0; c < kStage; ++c) acc[c] = 0.f;
      for (int q = lg; q < nq; q += G) {
        const int e = 4 * q;
        const uint32_t at = static_cast<uint32_t>(i) * static_cast<uint32_t>(s) + e;
        // u = 1 past the row (and for a row past NIS): x = 0 there, as p = 0
        const float4 u = make_float4(row_ok && e < s ? uniform_at(bkey, at) : 1.f,
                                     row_ok && e + 1 < s ? uniform_at(bkey, at + 1) : 1.f,
                                     row_ok && e + 2 < s ? uniform_at(bkey, at + 2) : 1.f,
                                     row_ok && e + 3 < s ? uniform_at(bkey, at + 3) : 1.f);
#pragma unroll
        for (int c = 0; c < kStage; ++c) {
          if (c < cnt) {
            const float4 pp = *reinterpret_cast<const float4*>(sp + c * s4 + e);
            const float4 aa = *reinterpret_cast<const float4*>(sa + c * s4 + e);
            const float4 xx = make_float4(u.x < pp.x ? 1.f : 0.f, u.y < pp.y ? 1.f : 0.f,
                                          u.z < pp.z ? 1.f : 0.f, u.w < pp.w ? 1.f : 0.f);
            acc[c] = chunk_fma(acc[c], xx, aa);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kStage; ++c) {
        if (c < cnt) {  // cnt is uniform over the CTA
          const float v = group_sum<G>(acc[c]);
          if (lg == 0 && row_ok) slw[c * nis + i] = v + sbias[c];
        }
      }
    }
    __syncthreads();

    // logW out; score = logW + Gumbel noise, in place.
    for (int t = threadIdx.x; t < cnt * nis; t += kThreads) {
      const int c = t / nis;
      const int i = t - c * nis;
      const float lw = slw[t];
      logw[(static_cast<size_t>(c0 + c) * n_blocks + j) * nis + i] = lw;
      const float ug = fminf(fmaxf(uniform_at(ssel[c], static_cast<uint32_t>(i)), 1e-12f),
                             1.0f - 1e-12f);
      slw[t] = lw + -logf(-logf(ug));
    }
    __syncthreads();

    // The argmax over the rows, a warp per client.
    for (int c = warp; c < cnt; c += kWarps) {
      float best = -INFINITY;
      int best_i = 0x7fffffff;
      for (int i = lane; i < nis; i += 32) {
        const float v = slw[c * nis + i];
        if (beats(v, i, best, best_i)) {
          best = v;
          best_i = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, best_i, off);
        if (beats(ov, oi, best, best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      if (lane == 0) {
        idx[static_cast<size_t>(c0 + c) * n_blocks + j] = best_i;
        schosen[c] = best_i;
      }
    }
    __syncthreads();

    // The chosen rows' bits, drawn again.
    for (int t = threadIdx.x; t < cnt * s; t += kThreads) {
      const int c = t / s;
      const int e = t - c * s;
      const uint32_t at = static_cast<uint32_t>(schosen[c]) * static_cast<uint32_t>(s) + e;
      sample[(static_cast<size_t>(c0 + c) * n_blocks + j) * s + e] =
          uniform_at(bkey, at) < sp[c * s4 + e] ? 1.f : 0.f;
    }
  }
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory on the
// current device.  Set once per device (bit `dev` of `done`): the call costs
// host time, and a launch then needs no call of its own.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int G>
cudaError_t launch_encode_g(const long long* key, const long long* sel, const float* p,
                            const float* a, const float* b, float* logw, long long* idx,
                            float* sample, int clients, int n_blocks, int nis, int s,
                            int key_stride, int sel_stride, cudaStream_t st) {
  const int s4 = 4 * ((s + 3) / 4);
  const size_t per_client = sizeof(float) * (2 * static_cast<size_t>(s4) + nis);
  const int cap = static_cast<int>(kMaxSmem / per_client);
  const int want = key_stride ? 1 : min(clients, kMaxStage);
  const int n_stage = min(want, cap);
  if (n_stage < 1) return cudaErrorInvalidValue;
  const size_t smem = per_client * n_stage;
  const bool vec = s % 4 == 0 && aligned16(p) && aligned16(a);
  static std::atomic<unsigned long long> set_one{0}, set_many{0};
  auto kernel = key_stride ? mrc_encode_kernel<G, 1> : mrc_encode_kernel<G, kMaxStage>;
  cudaError_t err = allow_max_smem(kernel, key_stride ? set_one : set_many);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, key_stride ? clients : 1);
  kernel<<<grid, kThreads, smem, st>>>(key, sel, p, a, b, logw, idx, sample, clients, n_blocks,
                                       nis, s, n_stage, sel_stride, vec);
  return cudaGetLastError();
}

}  // namespace

// u-fed form: logW (NB, NIS) from x (NB, NIS, S), a, b (NB, S).
extern "C" int mrc_logw_launch(const void* x, const void* a, const void* b, void* out, int nb,
                               int nis, int s, void* stream) {
  if (nb <= 0 || nis <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* of = static_cast<float*>(out);
  const bool vec = s % 4 == 0 && aligned16(x) && aligned16(a) && aligned16(b);
  switch (mrc_group_lanes(s)) {
    case 1: return static_cast<int>(launch_logw_g<1>(xf, af, bf, of, nb, nis, s, vec, st));
    case 2: return static_cast<int>(launch_logw_g<2>(xf, af, bf, of, nb, nis, s, vec, st));
    case 4: return static_cast<int>(launch_logw_g<4>(xf, af, bf, of, nb, nis, s, vec, st));
    case 8: return static_cast<int>(launch_logw_g<8>(xf, af, bf, of, nb, nis, s, vec, st));
    case 16: return static_cast<int>(launch_logw_g<16>(xf, af, bf, of, nb, nis, s, vec, st));
    default: return static_cast<int>(launch_logw_g<32>(xf, af, bf, of, nb, nis, s, vec, st));
  }
}

// The largest S * 2 + NIS (in floats, S rounded up to a multiple of 4)
// that one client of the keyed form may stage.
extern "C" int mrc_fixed_encode_max_row_floats() {
  return kMaxSmem / static_cast<int>(sizeof(float));
}

// Keyed form, the whole fixed-block encoder: logW (C, B, NIS), idx (C, B)
// int64 and sample (C, B, S) from p, a, b (C, B, S), the candidate key --
// (2,), shared by the clients (key_stride 0), or (C, 2), one per client
// (key_stride 2) -- and select_key (2,) (sel_stride 0) or (C, 2)
// (sel_stride 2), int64 words; one launch.
extern "C" int mrc_fixed_encode_launch(const void* key, const void* select_key, const void* p,
                                       const void* a, const void* b, void* logw, void* idx,
                                       void* sample, int clients, int n_blocks, int nis, int s,
                                       int key_stride, int sel_stride, void* stream) {
  if ((key_stride != 0 && key_stride != 2) || (sel_stride != 0 && sel_stride != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (clients <= 0 || n_blocks <= 0 || nis <= 0 || s <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(key);
  const long long* sk = static_cast<const long long*>(select_key);
  const float* pf = static_cast<const float*>(p);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* lw = static_cast<float*>(logw);
  long long* ix = static_cast<long long*>(idx);
  float* sm = static_cast<float*>(sample);
#define MRC_ENCODE(G)                                                                        \
  launch_encode_g<G>(k, sk, pf, af, bf, lw, ix, sm, clients, n_blocks, nis, s, key_stride, \
                     sel_stride, st)
  switch (mrc_group_lanes(s)) {
    case 1: return static_cast<int>(MRC_ENCODE(1));
    case 2: return static_cast<int>(MRC_ENCODE(2));
    case 4: return static_cast<int>(MRC_ENCODE(4));
    case 8: return static_cast<int>(MRC_ENCODE(8));
    case 16: return static_cast<int>(MRC_ENCODE(16));
    default: return static_cast<int>(MRC_ENCODE(32));
  }
#undef MRC_ENCODE
}

extern "C" const char* mrc_logw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
