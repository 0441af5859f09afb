// Flash attention (causal or sliding-window softmax attention with an
// online softmax in f32) on Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, h / rep]
//
// over the keys j that the mask leaves: j < Skv, j <= i when causal,
// j > i - window when window > 0.  q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv,
// Dh), H = rep * Hkv (GQA); f32 or bf16 (all three alike); out: (B, Sq, H,
// Dh) contiguous, in q's type.  The last axis of each input must have
// stride 1; the other axes are read through their strides.  A masked score
// is NEG_INF = -1e9 and the running max starts there, as in the reference
// model's scan; the output is acc / max(l, 1e-30).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::
// flash_attention_pallas (pallas_call at flash_attn.py:95).  Its wrapper
// (repro/kernels/ops.py:120) repeated the kv heads, folded the heads into
// the batch and padded Sq, Skv and Dh to 128 for the MXU; these kernels
// read the model's (B, S, H, Dh) layout directly, take the kv head as
// h / rep, and mask the ragged edges themselves, so none of those copies
// exists.  Two kernels, chosen by the input type alone:
//
// bf16: tensor cores (wgmma) fed by TMA.
//
//   Bound.  At the prefill shape of Qwen3-1.7B (B 2, S 4096, H 16, Hkv 8,
//   Dh 128, causal) the work is 4 B H Dh (visible pairs) = 1.37e11 flop:
//   0.139 ms on the bf16 tensor cores (989 TFLOP/s), the card's least time;
//   the bytes (q, k, v in, out written, ~100 MB) take 0.03 ms.  This kernel
//   does P.V twice (below), so its own floor is 1.5x that, ~0.21 ms.
//
//   Design.  One CTA of three warpgroups owns 128 query rows of one (b, h);
//   the grid is (ceil(Sq / 128), H, B), q blocks launched longest causal
//   rows first.  Warpgroup 0 is the producer: one thread issues TMA tile
//   loads of Q (once) and of K and V tiles of 64 keys into a ring of three
//   stages, each completed on an mbarrier; it then gives up its registers
//   (setmaxnreg 24).  Warpgroups 1 and 2 (setmaxnreg 240) each own 64 query
//   rows.  Tiles are 128-byte-swizzled panels of 64 bf16 columns, one panel
//   for Dh <= 64 and two up to 128; a Dh that is not a multiple of 64 is
//   zero-filled by TMA past Dh (the tensor map's extent), so the padded
//   columns add nothing.  Per tile a consumer (1) computes S = Q K^T with
//   wgmma m64n64k16 from shared memory into f32 registers (products of
//   bf16 values are exact in f32, so S differs from the f32 einsum only in
//   summation order); (2) scales S by scale * log2(e), masks it only on a
//   tile that crosses the diagonal, the window edge or Skv, takes the row
//   max over the four lanes that share a row, and forms P = 2^(S - m) in
//   f32 (ex2.approx); the row sum l is taken from the f32 P; (3) splits P
//   into P_hi =
//   bf16(P) and P_lo = bf16(P - P_hi) and adds P_hi V and P_lo V with
//   register-A wgmmas (V MN-major in shared memory) into one f32 O.  A
//   single bf16 P would err by ~2^-9 |v| / sqrt(n) in the output, above the
//   1e-5 x sum p|v| that the kernel is held to where the output is near 0;
//   the split leaves at most 2^-18 per weight.  Tiles that the mask covers
//   wholly for a warpgroup's rows are skipped (the producer does not load
//   tiles that the whole CTA skips).  Tensor maps are encoded on the host
//   per call from the model's strides (no copy): base pointers must be
//   16-byte aligned and byte strides multiples of 16 (the wrapper raises
//   ValueError otherwise); cuTensorMapEncodeTiled is reached through
//   cudaGetDriverEntryPoint, so the library does not link libcuda.
//
// f32: split-TF32 on the tensor cores (wgmma), fed by a transform warpgroup.
//
//   Bound.  At the training shape of Qwen3-1.7B (B 2, S 1024, H 16, Hkv 8,
//   Dh 128, causal) the work is 8.6e9 flop: 0.128 ms at the 67 TFLOP/s of
//   f32 on the CUDA cores.  The tensor cores take f32 only as TF32 (11
//   significant bits, 495 TFLOP/s), too coarse for the 1e-5 the kernel is
//   held to, so each product a.b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi
//   with a_hi = tf32(a), a_lo = tf32(a - a_hi) (a_lo b_lo, ~2^-22 |ab|, is
//   dropped): three TF32 products for one, 0.052 ms at 495 TFLOP/s.  The
//   bytes (q, k, v read, out written, 50 MB) take 0.015 ms: compute-bound.
//   At the prefill shape (S 4096) the split's floor is 0.833 ms (2.05 ms on
//   the CUDA cores).
//
//   Design.  One CTA of two warpgroups owns 64 query rows of one (b, h); the
//   grid is (ceil(Sq / 64), H, B), q blocks launched longest causal rows
//   first.  TF32 wgmma reads both shared-memory operands K-major only (the
//   transposed layouts exist for 16-bit types alone), and P V needs V^T with
//   the keys contiguous, which TMA cannot write; so no TMA: the whole CTA
//   first loads Q with 16-byte loads, scales it in f32 (q * scale, rounded
//   as the reference rounds it) and writes Q_hi and Q_lo as 128-byte-
//   swizzled K-major panels of 32 columns; then warpgroup 0 (transform)
//   loads each tile of 32 keys of K and V into registers (predicated loads,
//   offsets computed once), splits it and writes K (per panel its 32 K_hi
//   rows, then its 32 K_lo rows) and V^T_hi, V^T_lo (Dh x keys; a 4 x 4
//   block of V transposed in registers is one 16-byte chunk a column) into
//   a ring of two stages, each handed over by an mbarrier (full: 128
//   arrivals after fence.proxy.async; empty: one a consumer warp).  The
//   transposition costs no shared memory beyond V^T's planes: V goes from
//   device memory to registers to its place.  A stage is 64 KB at Dh 128,
//   Q's planes 64 KB: 193 KB of the 227.  Warpgroup 1 (consumer) per tile
//   (1) computes S from shared memory: one m64n64k8 wgmma takes Q_hi
//   against a panel's K_hi and K_lo rows at once (Q_hi K_hi^T and
//   Q_hi K_lo^T side by side), one m64n32k8 takes Q_lo K_hi^T, the even and
//   odd k8 steps in two sets of accumulators; S = Q_hi K_hi^T + (Q_hi K_lo^T
//   + Q_lo K_hi^T) is summed on the CUDA cores, the small terms kept apart
//   because the tensor cores round each k8 step's sum towards zero at the
//   accumulator's magnitude; (2) scales S by log2(e), masks it only on a
//   tile that crosses the diagonal, the window edge or Skv (tiles the mask
//   covers wholly are outside the CTA's range), and forms P = 2^(S - m) in
//   f32 with the row sum l from it; (3) splits P into P_hi and P_lo in
//   registers and adds P_hi V_hi + P_hi V_lo + P_lo V_hi with register-A
//   m64n32k8 wgmmas into a fresh per-tile accumulator, which the CUDA cores
//   add to O (O c + O_tile).  Accumulating into O itself in the tensor cores
//   drifts with those roundings: over 4096 keys it measured 3.0x the bound
//   on an H100 (tools/flash_f32_study.py).  P leaves S's accumulator as
//   lane t's keys (2t, 2t + 1) of each 8, while a k8 A fragment holds
//   columns (t, t + 4): V^T stores each 8 keys in the order 0, 2, 4, 6, 1,
//   3, 5, 7, so the accumulator registers are the A fragment as they stand
//   (no shuffle, no pass through shared memory).  The rounding to TF32 is
//   cvt.rna's (to nearest, ties away from zero), done on the bit pattern so
//   the low 13 bits are 0.  Pointers and byte strides must be 16-byte
//   aligned, as for bf16 (the wrapper raises ValueError).

// Interface: plain C functions for ctypes.  They launch on the given
// stream, do not synchronise, allocate nothing and return
// cudaGetLastError(), or kEncodeError + the driver's CUresult when a
// tensor map cannot be encoded.

#include <cuda.h>          // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kEncodeError = 100000;  // + CUresult of cuTensorMapEncodeTiled

// ---------------------------------------------------------------------------
// Hopper building blocks of both kernels: mbarriers, wgmma descriptors and fences.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// wgmma descriptor of a 128-byte-swizzled tile whose 8-row groups are 1024
// bytes apart.  The same 1024 goes in both offset fields: for a K-major
// operand the leading offset is unused, and for the bf16 kernel's MN-major
// V each instruction spans one 64-column panel, so only the 8-key step is
// used.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(64) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma's operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the issue or the wait.
template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// f32: split-TF32 on the tensor cores (wgmma).
// ---------------------------------------------------------------------------
namespace tf32 {

constexpr int kRows = 64;                  // query rows per CTA: one consumer warpgroup
constexpr int kKeys = 32;                  // keys per kv tile: one 128-byte row of f32
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kThreads = 256;              // transform warpgroup + consumer warpgroup
constexpr int kQPanel = kRows * 128;       // bytes of one Q panel (32 columns)
constexpr int kKPanel = kKeys * 128;       // bytes of 32 rows: K_hi or K_lo of a panel; V^T

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32's rounding, written on the bit pattern so that the low
// 13 bits are exactly 0 and the value is exactly what the tensor cores read.
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// hi = tf32(x), lo = tf32(x - hi); x - hi is exact in f32.  hi + lo is x to
// 2^-22 |x|.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - hi);
}

__device__ __forceinline__ void split_store(uint8_t* hi, uint8_t* lo, float4 x) {
  float4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = l;
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `r` of a tile of
// 128-byte rows under SWIZZLE_128B (chunk ^ (r mod 8); 8-row groups of 1024 B).
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// D (64 x 32 or 64 x 64, f32) += A (64 x 8) B (8 x N), tf32 operands; D is
// overwritten when scale_d is 0.  wgmma_ss: A and B in shared memory, both
// K-major (TF32 takes no other layout).  wgmma_rs: A in registers, a0 =
// (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4) for lane
// 4 g + t of each warp's 16 rows.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, "
      "p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// NP = ceil(Dh / 32) panels of 32 columns.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_tf32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                int sq, int skv, int h, int dh, int rep,
                int64_t qsb, int64_t qss, int64_t qsh,
                int64_t ksb, int64_t kss, int64_t ksh,
                int64_t vsb, int64_t vss, int64_t vsh,
                int causal, int window, float scale) {
  constexpr int kPlane = NP * kKPanel;     // one V^T plane (32 NP rows); K takes two
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* const qhi = base;                               // NP panels of Q, hi
  uint8_t* const qlo = qhi + NP * kQPanel;                 // and lo
  uint8_t* const ring = qlo + NP * kQPanel;                // per stage: K, V^T hi, V^T lo
  const uint32_t bars = smem_u32(ring + kStages * 4 * kPlane);
  // plane(s, 0): K, per 32-column panel its 32 K_hi rows then its 32 K_lo
  // rows (one 64-row B operand); plane(s, 2), plane(s, 3): V^T hi and lo.
  auto plane = [&](int s, int which) { return ring + (s * 4 + which) * kPlane; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;        // longest rows first
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / rep;
  const int kend = causal ? min(skv, q0 + kRows) : skv;
  const int kstart = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int ntiles = kend > kstart ? (kend - kstart + kKeys - 1) / kKeys : 0;
  const int tid = threadIdx.x;
  const int d4 = dh >> 2;                                     // float4s per row

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 128);  // every transform thread
      mbar_init(empty(s), 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Q scaled in f32 (the reference's q * scale, with its rounding), split
  // once into hi and lo K-major panels (rows past Sq are zeros).
  const float* qb = q + b * qsb + hh * qsh;
  for (int idx = tid; idx < kRows * d4; idx += kThreads) {
    const int r = idx / d4, c = idx - r * d4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) {
      x = load4(qb + (int64_t)(q0 + r) * qss + 4 * c);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    const uint32_t off = (c >> 3) * kQPanel + swz(r, c & 7);
    split_store(qhi + off, qlo + off, x);
  }
  fence_proxy_async();   // generic-proxy writes, read by wgmma (the async proxy)
  __syncthreads();

  if (tid < 128) {
    // Transform warpgroup: loads each K and V tile, splits it, and writes
    // K (keys x Dh, K-major) and V^T (Dh x keys, K-major) as hi and lo planes.
    // A thread's elements sit at the same places in every tile: their
    // offsets are computed once.  Loads are predicated into zeroed
    // registers (a select on a load's value would wait for it).
    const float* kb = k + b * ksb + hk * ksh;
    const float* vb = v + b * vsb + hk * vsh;
    constexpr int kK = 2 * NP;           // K float4s a thread, at most (32 x 8 NP / 128)
    constexpr int kV = (NP + 1) / 2;     // V items (4 keys x 4 columns) a thread, at most
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    int kkey[kK], vkey[kV];              // key within the tile (kKeys: none)
    int64_t kgo[kK];                     // element offset of the float4 from the tile's first key
    uint32_t kso[kK];                    // byte offset in the K plane
    int vcol[kV];                        // V item's first column
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const int idx = tid + 128 * j, r = idx / d4, c = idx - r * d4;
      kkey[j] = idx < kKeys * d4 ? r : kKeys;
      kgo[j] = (int64_t)r * kss + 4 * c;
      kso[j] = (c >> 3) * 2 * kKPanel + swz(r, c & 7);
    }
    // V item (g, e, c): keys 8 g + e + 2 m (m = 0..3), columns 4 c .. 4 c + 3.
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int idx = tid + 128 * j, ge = idx & 7;
      vkey[j] = idx < 8 * d4 ? 8 * (ge >> 1) + (ge & 1) : kKeys;
      vcol[j] = 4 * (idx >> 3);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const int k0 = kstart + i * kKeys;
      const float* kt0 = kb + (int64_t)k0 * kss;
      float4 kx[kK], vx[kV][4];
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        kx[j] = zero;
        if (kkey[j] < kKeys && k0 + kkey[j] < skv) kx[j] = load4(kt0 + kgo[j]);
      }
#pragma unroll
      for (int j = 0; j < kV; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int key = k0 + vkey[j] + 2 * m;
          vx[j][m] = zero;
          if (vkey[j] < kKeys && key < skv) vx[j][m] = load4(vb + (int64_t)key * vss + vcol[j]);
        }
      mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < kK; ++j)
        if (kkey[j] < kKeys)
          split_store(plane(s, 0) + kso[j], plane(s, 0) + kso[j] + kKPanel, kx[j]);
      // V^T row d holds the tile's keys in the order of P's register
      // fragment: within each group of 8 keys, positions 0..3 hold keys
      // 0, 2, 4, 6 and positions 4..7 keys 1, 3, 5, 7, so that the
      // accumulator's (key 2t, key 2t + 1) pair of lane t is its A operand's
      // (column t, column t + 4) as it stands.  16-byte chunk 2 g + e of row
      // d holds keys 8 g + e + {0, 2, 4, 6}: one item's column d.
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        if (vkey[j] < kKeys) {
          const int ge = (tid + 128 * j) & 7;
          const float4* x = vx[j];
          const float4 cols[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                                  make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                                  make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                                  make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t off = swz(vcol[j] + e, ge);
            split_store(plane(s, 2) + off, plane(s, 3) + off, cols[e]);
          }
        }
      }
      fence_proxy_async();
      mbar_arrive(full(s));
    }
  } else {
    // Consumer warpgroup: the block's 64 query rows.
    const int t = tid - 128, warp = t / 32, lane = t % 32;
    const int row = q0 + 16 * warp + lane / 4;     // this thread's rows: row, row + 8
    const int col = 2 * (lane % 4);                // and keys/columns 8 n + col, + 1
    const int dh8 = dh >> 3;
    const uint32_t qh = smem_u32(qhi), ql = smem_u32(qlo);

    float o[NP][16];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 16; ++j) o[p][j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const int k0 = kstart + i * kKeys;
      const uint32_t kt = smem_u32(plane(s, 0));
      const uint32_t vh = smem_u32(plane(s, 2)), vl = smem_u32(plane(s, 3));
      mbar_wait(full(s), (i / kStages) & 1);

      // (1) S = Q_hi K_hi^T + (Q_hi K_lo^T + Q_lo K_hi^T): the small terms in
      // accumulators of their own, so that their roundings are relative to
      // their own size, not S's.  One m64n64k8 takes Q_hi against a panel's
      // K_hi and K_lo rows together: columns 0..31 of sq are Q_hi K_hi^T,
      // columns 32..63 Q_hi K_lo^T; sx is Q_lo K_hi^T.  Even and odd k8
      // steps go to two sets of accumulators: two independent chains.
      float sq[2][32], sx[2][16];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int j = 0; j < 32; ++j) sq[c][j] = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) sx[c][j] = 0.f;
        hold(sq[c]);
        hold(sx[c]);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NP; ++kk) {
        if (kk < dh8) {
          const uint32_t qo = (kk / 4) * kQPanel + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * 2 * kKPanel + (kk % 4) * 32;
          wgmma_ss(sq[kk & 1], desc(qh + qo), desc(kt + ko), kk > 1);
          wgmma_ss(sx[kk & 1], desc(ql + qo), desc(kt + ko), kk > 1);
        }
      }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        hold(sq[c]);
        hold(sx[c]);
      }

      // (2) Online softmax in f32, log2 units; masks only on an edge tile.
      const bool masked = k0 + kKeys > skv || (causal && k0 + kKeys - 1 > q0) ||
                          (window > 0 && k0 <= q0 + kRows - 1 - window);
      float sc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float big = sq[0][j] + sq[1][j];
        const float small = (sq[0][16 + j] + sq[1][16 + j]) + (sx[0][j] + sx[1][j]);
        float x = (big + small) * kLog2e;
        if (masked) {
          const int kpos = k0 + 8 * (j / 4) + col + (j & 1);
          const int qpos = row + ((j & 2) ? 8 : 0);
          bool ok = kpos < skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = kNegInf;
        }
        sc[j] = x;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float r0 = 0.f, r1 = 0.f;
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // keys 8 n + col, + 1 of rows row, row + 8: A columns t, t + 4 (V^T's order)
        const float p00 = ex2(sc[4 * n] - mx0), p01 = ex2(sc[4 * n + 1] - mx0);
        const float p10 = ex2(sc[4 * n + 2] - mx1), p11 = ex2(sc[4 * n + 3] - mx1);
        r0 += p00 + p01;
        r1 += p10 + p11;
        const float a[4] = {p00, p10, p01, p11};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float hi, lo;
          split(a[e], hi, lo);
          phi[n][e] = __float_as_uint(hi);
          plo[n][e] = __float_as_uint(lo);
        }
      }
      l0 = l0 * c0 + r0;
      l1 = l1 * c1 + r1;

      // (3) O = O c + (P_hi V_hi + P_hi V_lo + P_lo V_hi): the tile's terms in
      // a fresh accumulator, added to O on the CUDA cores.
      float ot[NP][16];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int j = 0; j < 16; ++j) ot[p][j] = 0.f;
        hold(ot[p]);
      }
      hold(phi);
      hold(plo);
      wg_fence();
#pragma unroll
      for (int n = 0; n < 4; ++n) {   // consecutive wgmmas on distinct accumulators
#pragma unroll
        for (int p = 0; p < NP; ++p) wgmma_rs(ot[p], phi[n], desc(vh + p * kKPanel + n * 32), n > 0);
#pragma unroll
        for (int p = 0; p < NP; ++p) wgmma_rs(ot[p], phi[n], desc(vl + p * kKPanel + n * 32), 1);
#pragma unroll
        for (int p = 0; p < NP; ++p) wgmma_rs(ot[p], plo[n], desc(vh + p * kKPanel + n * 32), 1);
      }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int p = 0; p < NP; ++p) hold(ot[p]);
      hold(phi);
      hold(plo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // this warp no longer reads stage s
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[p][4 * n] = fmaf(o[p][4 * n], c0, ot[p][4 * n]);
          o[p][4 * n + 1] = fmaf(o[p][4 * n + 1], c0, ot[p][4 * n + 1]);
          o[p][4 * n + 2] = fmaf(o[p][4 * n + 2], c1, ot[p][4 * n + 2]);
          o[p][4 * n + 3] = fmaf(o[p][4 * n + 3], c1, ot[p][4 * n + 3]);
        }
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= sq) continue;
      const float inv = half ? inv1 : inv0;
      float* orow = out + (((int64_t)b * sq + r) * h + hh) * dh;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 32 * p + 8 * n + col;
          if (c < dh)
            *reinterpret_cast<float2*>(orow + c) =
                make_float2(o[p][4 * n + 2 * half] * inv, o[p][4 * n + 2 * half + 1] * inv);
        }
    }
  }
}

template <int NP>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int hkv, int dh, const int64_t* st, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = 1024 + 2 * NP * kQPanel + kStages * 4 * NP * kKPanel + 16 * kStages;
  auto kern = flash_attn_tf32<NP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + kRows - 1) / kRows, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, skv, h, dh, h / hkv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out, int b, int sq,
             int skv, int h, int hkv, int dh, const int64_t* st, int causal,
             int window, float scale, cudaStream_t stream) {
  switch ((dh + 31) / 32) {
#define CASE(n) \
    case n: return launch<n>(q, k, v, out, b, sq, skv, h, hkv, dh, st, causal, window, \
                             scale, stream);
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 128;                 // query rows per CTA (2 x 64)
constexpr int kKeys = 64;                  // keys per kv tile
constexpr int kStages = 3;                 // K/V ring depth
constexpr int kThreads = 384;              // producer + two consumer warpgroups
constexpr int kPanel = 64;                 // bf16 columns in one 128-byte row
constexpr int kQPanel = kRows * 128;       // bytes of one Q panel
constexpr int kKVPanel = kKeys * 128;      // bytes of one K or V panel

// One (64 columns, rows, 1, 1) box of a 4-D (Dh, S, heads, B) tensor map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), bf16 operands.  wgmma_ss:
// A and B in shared memory, both K-major (D is overwritten when scale_d is
// 0).  wgmma_rs: A in registers (the accumulator layout of S, packed to
// bf16 pairs), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                 int sq, int skv, int h, int dh, int rep, int causal, int window,
                 float scale2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_tile = base;                               // NP panels of Q
  const uint32_t sk = sq_tile + NP * kQPanel;                  // kStages x NP panels
  const uint32_t sv = sk + kStages * NP * kKVPanel;
  const uint32_t bars = sv + kStages * NP * kKVPanel;
  const uint32_t qbar = bars + 16 * kStages;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;        // longest rows first
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / rep;
  const int kend = causal ? min(skv, q0 + kRows) : skv;
  const int kstart = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
  const int ntiles = kend > kstart ? (kend - kstart + kKeys - 1) / kKeys : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, NP * kQPanel);
#pragma unroll
      for (int p = 0; p < NP; ++p) tma_load(sq_tile + p * kQPanel, &qmap, qbar, p * kPanel, q0, hh, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        const int k0 = kstart + i * kKeys;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * NP * kKVPanel);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t off = (s * NP + p) * kKVPanel;
          tma_load(sk + off, &kmap, full(s), p * kPanel, k0, hk, b);
          tma_load(sv + off, &vmap, full(s), p * kPanel, k0, hk, b);
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int wlo = q0 + 64 * cw, whi = wlo + 63;
    const int row = wlo + 16 * warp + lane / 4;    // this thread's rows: row, row + 8
    const int col = 2 * (lane % 4);                // and columns 8 n + col, + 1
    const uint32_t qa = sq_tile + cw * 64 * 128;

    float o[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[p][j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const int k0 = kstart + i * kKeys;
      mbar_wait(full(s), (i / kStages) & 1);
      const bool skip = (causal && k0 > whi) || (window > 0 && k0 + kKeys - 1 <= wlo - window);
      if (!skip) {
        // (1) S = Q K^T.
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        hold(sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NP; ++kk) {
          const uint32_t koff = (kk % 4) * 32;   // 16 columns further along the row
          wgmma_ss(sc, desc(qa + (kk / 4) * kQPanel + koff),
                   desc(sk + (s * NP + kk / 4) * kKVPanel + koff), kk > 0);
        }
        wg_commit();
        wg_wait();
        hold(sc);

        // (2) Online softmax in f32, log2 units.
        const bool masked = k0 + kKeys > skv || (causal && k0 + kKeys - 1 > wlo) ||
                            (window > 0 && k0 <= whi - window);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float x = sc[j] * scale2;
          if (masked) {
            const int kpos = k0 + 8 * (j / 4) + col + (j & 1);
            const int qpos = row + ((j & 2) ? 8 : 0);
            bool ok = kpos < skv;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            if (!ok) x = kNegInf;
          }
          sc[j] = x;
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float r0 = 0.f, r1 = 0.f;
        uint32_t phi[4][4], plo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // keys 16 kk .. 16 kk + 15 = accumulator columns 8 (2 kk) .. 8 (2 kk + 1) + 7
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            // a = 0: row, keys 16 kk + col; 1: row + 8; 2: row, + 8; 3: row + 8, + 8
            const int j = 8 * kk + 4 * (a >> 1) + 2 * (a & 1);
            const float mrow = (a & 1) ? mx1 : mx0;
            const float p0 = ex2(sc[j] - mrow), p1 = ex2(sc[j + 1] - mrow);
            if (a & 1) r1 += p0 + p1; else r0 += p0 + p1;
            phi[kk][a] = pack_bf16(p0, p1);
            plo[kk][a] = pack_bf16(p0 - bf16_lo(phi[kk][a]), p1 - bf16_hi(phi[kk][a]));
          }
        }
        l0 = l0 * c0 + r0;
        l1 = l1 * c1 + r1;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[p][4 * n] *= c0;
            o[p][4 * n + 1] *= c0;
            o[p][4 * n + 2] *= c1;
            o[p][4 * n + 3] *= c1;
          }

        // (3) O += P_hi V + P_lo V.
#pragma unroll
        for (int p = 0; p < NP; ++p) hold(o[p]);
        hold(phi);
        hold(plo);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint64_t dv = desc(sv + (s * NP + p) * kKVPanel + kk * 16 * 128);
            wgmma_rs(o[p], phi[kk], dv);
            wgmma_rs(o[p], plo[kk], dv);
          }
        wg_commit();
        wg_wait();
#pragma unroll
        for (int p = 0; p < NP; ++p) hold(o[p]);
        hold(phi);
        hold(plo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // this warp no longer reads stage s
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= sq) continue;
      const float inv = half ? inv1 : inv0;
      __nv_bfloat16* orow = out + (((int64_t)b * sq + r) * h + hh) * dh;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = p * kPanel + 8 * n + col;
          if (c < dh)
            *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
                o[p][4 * n + 2 * half] * inv, o[p][4 * n + 2 * half + 1] * inv);
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of one (B, S, heads, Dh) input, boxes of (64 columns, rows).
// Element strides st = (batch, sequence, head).  Returns 0 or an error code.
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int dh,
             const int64_t* st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)seq, (cuuint64_t)heads, (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2, (cuuint64_t)st[0] * 2};
  cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                  strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int NP>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int hkv, int dh, const int64_t* st, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int rc = make_map(&qmap, q, b, sq, h, dh, st, kRows);
  if (rc == 0) rc = make_map(&kmap, k, b, skv, hkv, dh, st + 3, kKeys);
  if (rc == 0) rc = make_map(&vmap, v, b, skv, hkv, dh, st + 6, kKeys);
  if (rc != 0) return rc;
  const size_t smem = 1024 + NP * kQPanel + 2 * kStages * NP * kKVPanel + 8 * (2 * kStages + 1);
  auto kern = flash_attn_wgmma<NP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + kRows - 1) / kRows, h, b);
  kern<<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
                                         sq, skv, h, dh, h / hkv, causal, window,
                                         scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// strides: 9 element strides (q, k, v) x (batch, sequence, head).
// dtype: 0 = float32 (split-TF32 wgmma kernel), 1 = bfloat16 (wgmma + TMA
// kernel).  dh <= 128 and a multiple of 8, h a multiple of hkv, 16-byte-
// aligned pointers and strides (all checked by the Python wrapper).
int flash_attn_launch(const void* q, const void* k, const void* v, void* out, int b,
                      int sq, int skv, int h, int hkv, int dh, const int64_t* strides,
                      int dtype, int causal, int window, float scale, void* stream) {
  if (sq <= 0 || b <= 0 || h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tf32::dispatch(q, k, v, out, b, sq, skv, h, hkv, dh, strides, causal, window,
                          scale, s);
  if (dh <= 64)
    return tc::launch<1>(q, k, v, out, b, sq, skv, h, hkv, dh, strides, causal, window,
                         scale, s);
  return tc::launch<2>(q, k, v, out, b, sq, skv, h, hkv, dh, strides, causal, window, scale,
                       s);
}

const char* flash_attn_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
