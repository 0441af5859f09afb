#!/usr/bin/env python3
"""Study of the f32 flash kernel (``csrc/flash_attn.cu``, ``tf32::flash_attn_tf32``)
on one NVIDIA card:

    python3 tools/flash_f32_study.py

1. Accuracy at growing score magnitudes: the kernel, the plain version
   (``flash_attention_ref``) and float64, each pair's worst error over the
   bound the kernel is held to (1e-5 x the magnitude of the terms + 1e-6).
2. Two variants built from this checkout's source by text patches and run
   beside the kernel on the same inputs:

   * ``o_in_tensor_cores``: P V accumulated into O inside the tensor cores
     (no per-tile accumulator): its error over the bound at 4096 keys;
   * ``clock``: ``clock64()`` around each phase of one transform thread and
     one consumer thread per CTA, summed over CTAs: clocks a 32-key tile.

Every time is CUDA events over back-to-back launches, variants in turns
(kernel, variant, variant, kernel).  A patch that no longer matches the
source fails the run: the study follows the kernel's text.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attn as fa  # noqa: E402

TOL = 1e-5
SOURCE = build.source("flash_attn")
OUT = build.BUILD_DIR / "study"


def patched(name: str, patches: list) -> Path:
    """Write this checkout's flash source with ``patches`` (old, new, after)
    applied in the tf32 namespace only; ``after`` inserts new after old."""
    text = SOURCE.read_text()
    cut = text.index("namespace tc {")
    head, tail = text[:cut], text[cut:]
    for old, new, after in patches:
        if head.count(old) != 1:
            raise AssertionError(f"{name}: the source no longer holds one {old[:60]!r}")
        head = head.replace(old, old + new if after else new)
    if name == "clock":
        tail = tail.replace('extern "C" {\n', 'extern "C" {\n\n' + PROF_API, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "common.cuh").write_text((SOURCE.parent / "common.cuh").read_text())
    path = OUT / f"{name}.cu"
    path.write_text(head + tail)
    return path


PROF_API = """int flash_prof(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 16);
}
"""

O_PATCH = [
    ("""      float ot[NP][16];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int j = 0; j < 16; ++j) ot[p][j] = 0.f;
        hold(ot[p]);
      }""", """#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[p][4 * n] *= c0;
          o[p][4 * n + 1] *= c0;
          o[p][4 * n + 2] *= c1;
          o[p][4 * n + 3] *= c1;
        }
        hold(o[p]);
      }
      float (&ot)[NP][16] = o;""", False),
    ("wgmma_rs(ot[p], phi[n], desc(vh + p * kKPanel + n * 32), n > 0);",
     "wgmma_rs(ot[p], phi[n], desc(vh + p * kKPanel + n * 32), 1);", False),
    ("""          o[p][4 * n] = fmaf(o[p][4 * n], c0, ot[p][4 * n]);
          o[p][4 * n + 1] = fmaf(o[p][4 * n + 1], c0, ot[p][4 * n + 1]);
          o[p][4 * n + 2] = fmaf(o[p][4 * n + 2], c1, ot[p][4 * n + 2]);
          o[p][4 * n + 3] = fmaf(o[p][4 * n + 3], c1, ot[p][4 * n + 3]);""", "", False),
]

CLOCK_PATCH = [
    ("namespace tf32 {\n", "__device__ unsigned long long g_prof[16];\nnamespace tf32 {\n",
     False),
    ("    for (int i = 0; i < ntiles; ++i) {\n      const int s = i % kStages;\n"
     "      const int k0 = kstart + i * kKeys;\n      const float* kt0",
     "    unsigned long long P0 = 0, P1 = 0, P2 = 0;\n"
     "    for (int i = 0; i < ntiles; ++i) {\n      long long c0 = clock64();\n"
     "      const int s = i % kStages;\n      const int k0 = kstart + i * kKeys;\n"
     "      const float* kt0", False),
    ("      mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);\n",
     "      long long c1 = clock64();\n      mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);\n"
     "      long long c2 = clock64();\n", False),
    ("      fence_proxy_async();\n      mbar_arrive(full(s));\n    }\n",
     "      fence_proxy_async();\n      mbar_arrive(full(s));\n      long long c3 = clock64();\n"
     "      P0 += c1 - c0; P1 += c2 - c1; P2 += c3 - c2;\n    }\n"
     "    if (tid == 0) { atomicAdd(&g_prof[0], P0); atomicAdd(&g_prof[1], P1); "
     "atomicAdd(&g_prof[2], P2); atomicAdd(&g_prof[3], (unsigned long long)ntiles); }\n", False),
    ("    for (int i = 0; i < ntiles; ++i) {\n      const int s = i % kStages;\n"
     "      const int k0 = kstart + i * kKeys;\n      const uint32_t kt",
     "    unsigned long long Q[5] = {0, 0, 0, 0, 0};\n"
     "    for (int i = 0; i < ntiles; ++i) {\n      long long d0 = clock64();\n"
     "      const int s = i % kStages;\n      const int k0 = kstart + i * kKeys;\n"
     "      const uint32_t kt", False),
    ("      mbar_wait(full(s), (i / kStages) & 1);\n", "      long long d1 = clock64();\n", True),
    ("      // (2) Online softmax", "      long long d2 = clock64();\n      // (2) Online softmax",
     False),
    ("      // (3) O = O c", "      long long d3 = clock64();\n      // (3) O = O c", False),
    ("      if (lane == 0) mbar_arrive(empty(s));",
     "      long long d4c = clock64();\n      if (lane == 0) mbar_arrive(empty(s));", False),
    ("          o[p][4 * n + 3] = fmaf(o[p][4 * n + 3], c1, ot[p][4 * n + 3]);\n        }\n",
     "      long long d5 = clock64();\n      Q[0] += d1 - d0; Q[1] += d2 - d1; Q[2] += d3 - d2; "
     "Q[3] += d4c - d3; Q[4] += d5 - d4c;\n", True),
    ("  const float inv0 = 1.f / fmaxf(l0, 1e-30f)",
     "  if (t == 0) for (int j = 0; j < 5; ++j) atomicAdd(&g_prof[4 + j], Q[j]);\n"
     "    const float inv0 = 1.f / fmaxf(l0, 1e-30f)", False),
]


def load(path: Path) -> ctypes.CDLL:
    so = path.with_suffix(".so")
    proc = subprocess.run([build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-o", str(so), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                      ctypes.POINTER(ctypes.c_int64), ci, ci, ci,
                                      ctypes.c_float, vp]
    return lib


def run(lib, q, k, v, causal, scale):
    b, sq, h, dh = q.shape
    out = torch.empty_like(q)
    st = (ctypes.c_int64 * 9)(*(x for t in (q, k, v) for x in fa._strides(t)))
    build.check("flash_attn", fa._library(), lib.flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1], h,
        k.shape[2], dh, st, 0, int(causal), 0, float(scale),
        torch.cuda.current_stream().cuda_stream))
    return out


def inputs(shape, seed, q_scale=1.0):
    b, s, h, hkv, dh = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, s, h, dh, generator=g, device="cuda") * q_scale,
            torch.randn(b, s, hkv, dh, generator=g, device="cuda"),
            torch.randn(b, s, hkv, dh, generator=g, device="cuda"))


def exact(q, k, v, causal, scale):
    """Attention in float64, a head at a time."""
    rep = q.shape[2] // k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    for hh in range(q.shape[2]):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, hh].double(), k[:, :, hh // rep].double())
        s = s * scale
        if causal:
            s = s.masked_fill(j > i, -torch.inf)
        out[:, :, hh] = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1),
                                     v[:, :, hh // rep].double())
    return out


def over(a, b, tol):
    return float(((a.double() - b.double()).abs() / tol).max())


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_study: torch sees no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    kernel = fa._library()
    variants = {name: load(patched(name, patch))
                for name, patch in (("o_in_tensor_cores", O_PATCH), ("clock", CLOCK_PATCH))}

    print("1. accuracy, err / bound (kernel, plain version, float64):")
    for dh, q_scale in [(128, 1.0), (128, 4.0), (128, 6.0), (128, 8.0), (8, 5.0), (40, 6.0),
                        (64, 8.0)]:
        for seed in (11, 12):
            q, k, v = inputs((2, 200, 2, 1, dh), seed, q_scale)
            kw = dict(causal=True, scale=dh ** -0.5)
            got = run(kernel, q, k, v, **kw)
            want = fa.flash_attention_ref(q, k, v, **kw)
            tol = TOL * fa.flash_attention_ref(q, k, v.abs(), **kw) + 1e-6
            ex = exact(q, k, v, **kw)
            smax = float((torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2))
                          * kw["scale"]).abs().max())
            print(f"  Dh {dh}, q x {q_scale}, seed {seed}, max |S| {smax:.1f}: kernel-plain "
                  f"{over(got, want, tol):.4f}, kernel-float64 {over(got, ex, tol):.4f}, "
                  f"plain-float64 {over(want, ex, tol):.4f}")

    print("2. variants beside the kernel:")
    for shape, q_scale in [((2, 4096, 16, 8, 128), 1.0), ((1, 4096, 4, 2, 128), 3.0),
                           ((2, 1024, 16, 8, 128), 1.0)]:
        q, k, v = inputs(shape, 7, q_scale)
        kw = dict(causal=True, scale=shape[-1] ** -0.5)
        want = fa.flash_attention_ref(q, k, v, **kw)
        tol = TOL * fa.flash_attention_ref(q, k, v.abs(), **kw) + 1e-6
        errs = {n: over(run(lib, q, k, v, **kw), want, tol)
                for n, lib in (("kernel", kernel), *variants.items())}
        times = {n: [] for n in ("kernel", "o_in_tensor_cores")}
        for n in ("kernel", "o_in_tensor_cores", "o_in_tensor_cores", "kernel"):
            lib = kernel if n == "kernel" else variants[n]
            times[n].append(time_ms(lambda: run(lib, q, k, v, **kw)))
        print(f"  {shape} q x {q_scale}: err / bound {errs}; ms "
              f"{ {n: [round(t, 4) for t in ts] for n, ts in times.items()} }")
    clock = variants["clock"]
    clock.flash_prof.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    buf = (ctypes.c_ulonglong * 16)()
    for shape in [(2, 1024, 16, 8, 128), (2, 4096, 16, 8, 128)]:
        q, k, v = inputs(shape, 1)
        kw = dict(causal=True, scale=shape[-1] ** -0.5)
        run(clock, q, k, v, **kw)
        torch.cuda.synchronize()
        clock.flash_prof(buf, 1)
        run(clock, q, k, v, **kw)
        torch.cuda.synchronize()
        clock.flash_prof(buf, 0)
        n = buf[3]
        print(f"  clocks a tile at {shape} ({n} tiles): transform: loads issued "
              f"{buf[0] / n:.0f}, waiting for a free stage {buf[1] / n:.0f}, split and "
              f"stores {buf[2] / n:.0f}; consumer: waiting for the tile {buf[4] / n:.0f}, "
              f"S {buf[5] / n:.0f}, softmax {buf[6] / n:.0f}, P V {buf[7] / n:.0f}, "
              f"O update {buf[8] / n:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
