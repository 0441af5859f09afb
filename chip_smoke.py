#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit; nothing is swallowed):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernel(s) from this checkout's sources, in
   parallel (one ``nvcc`` per source), and print the build time and
   ``ptxas`` report;
3. hold each kernel, through the routing wrapper the main path calls
   (``kernels.ops``), against its plain PyTorch version on the card, at the
   main path's shapes and at ragged shapes, and time the kernel, the plain
   version and one PyTorch library call beside the kernel's bound;
4. drive the main path -- the quickstart's BiCompFL-GR training at full
   width (MLP 100->256->10, d = 28160, 10 clients, blocks of 128, 64
   candidates) -- for a few rounds on the card, with every kernel launch
   count set to 0 just before and read just after;
5. check the card's MRC codec against the port's CPU route on the same
   inputs at full width (the CPU route is tied to the JAX reference by the
   CPU tests);
6. trace two steady rounds with ``torch.profiler``: device time by kernel,
   and the device's idle share of an unprofiled steady round.

The second-to-last line is a JSON object ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when torch sees no CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import prng, quickstart  # noqa: E402
from repro_torch.core import mrc  # noqa: E402
from repro_torch.core.bernoulli import log_ratio_coeffs  # noqa: E402
from repro_torch.fl.engine import FLEngine  # noqa: E402
from repro_torch.kernels import mrc_weights, ops  # noqa: E402

ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
# fp32 S-term sums in another order than the plain version's GEMV: a few
# ulp of the partial sums (|logW| here is O(10..100)).
LOGW_RTOL, LOGW_ATOL = 1e-5, 1e-4
# The card's and the CPU's transcendental functions round differently, so
# a Gumbel-max near-tie may flip an index; everything else must agree.
MIN_INDEX_MATCH = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def logw_inputs(nb: int, nis: int, s: int, seed: int):
    """Candidates x = (u < p) and log-ratio coefficients, made on the card."""
    key = prng.PRNGKey(seed, device="cuda")
    ku, kq, kp = prng.split(key, 3)
    q = 0.15 + 0.7 * prng.uniform(kq, (nb, s))
    p = torch.clamp(q + 0.1 * prng.normal(kp, (nb, s)), 0.05, 0.95)
    x = (prng.uniform(ku, (nb, nis, s)) < p[:, None, :]).to(torch.float32)
    a, b = log_ratio_coeffs(q, p)
    return x.contiguous(), a.contiguous(), b.contiguous()


def check_mrc_logw(shape, seed):
    """Kernel (through ``ops.mrc_logw``, the main path's wrapper) vs plain
    version on one shape; returns the measured row.  Runs before the main
    path, which sets the launch count to 0 for its own run."""
    x, a, b = logw_inputs(*shape, seed)
    before = ops.mrc_logw.launches
    got = ops.mrc_logw(x, a, b)
    if ops.mrc_logw.launches != before + 1:
        raise AssertionError("ops.mrc_logw did not launch the kernel on the card")
    want = mrc_weights.mrc_logw_ref(x, a, b)
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = LOGW_ATOL + LOGW_RTOL * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"mrc_logw {shape}: max |err| {err.max().item()} "
                             f"beyond atol {LOGW_ATOL} + rtol {LOGW_RTOL}")
    bsum = b.sum(-1)[:, None, None]
    a3 = a[:, :, None]
    ms = cuda_time_ms(lambda: ops.mrc_logw(x, a, b))
    plain_ms = cuda_time_ms(lambda: mrc_weights.mrc_logw_ref(x, a, b))
    library_ms = cuda_time_ms(lambda: torch.baddbmm(bsum, x, a3))
    nb, nis, s = shape
    nbytes = 4 * (x.numel() + a.numel() + b.numel() + nb * nis)
    flops = 2 * x.numel() + b.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    row = {"shape": list(shape), "max_abs_err": err.max().item(), "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"mrc_logw {shape}: max|err| {row['max_abs_err']:.3e}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  baddbmm {library_ms:.4f} ms  "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {nbytes} B)")
    return row


def phase_main_path():
    """The quickstart's BiCompFL-GR at full width on the card."""
    cfg = quickstart.CONFIG
    n = cfg["n_clients"]
    ops.mrc_logw.launches = 0
    t0 = time.perf_counter()
    out = quickstart.run("cuda", rounds=ROUNDS, eval_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.mrc_logw.launches

    d = int(out["theta"].shape[0])
    n_blocks = -(-d // cfg["block_size"])
    n_ul = 1  # the quickstart conveys one sample per client and round
    ul = n * n_ul * n_blocks * math.log2(cfg["n_is"])
    dl = n * (n - 1) * n_ul * n_blocks * math.log2(cfg["n_is"])
    cum = [h["cum_bits"] for h in out["history"]]
    accs = [h["acc"] for h in out["history"]]
    m = out["meter"]
    log(f"main path: d {d}, {n_blocks} blocks, {ROUNDS} rounds in {wall:.3f} s; "
        f"mrc_logw launches {launches}; accuracy {accs}")
    ph = out["phase_seconds"]
    for label, sl in (("round 1 (warm-up)", slice(0, 1)),
                      (f"rounds 2-{ROUNDS} mean", slice(1, None))):
        log(f"{label}: " + ", ".join(
            f"{k} {1e3 * sum(v[sl]) / len(v[sl]):.3f} ms" for k, v in ph.items())
            + " (host clock, synchronised at phase ends)")
    if d != 28160 or n_blocks != 220:
        raise AssertionError(f"not the full-width model: d {d}, {n_blocks} blocks")
    if launches != ROUNDS * n_ul:
        raise AssertionError(f"mrc_logw launched {launches} times, expected "
                             f"{ROUNDS * n_ul} (rounds x n_ul)")
    if cum != [(t + 1) * (ul + dl) for t in range(ROUNDS)]:
        raise AssertionError(f"booked bits {cum}, expected {ul}+{dl} per round")
    if abs(m["uplink_bpp"] * n * d * ROUNDS - ROUNDS * ul) > 1e-6 * ROUNDS * ul:
        raise AssertionError(f"uplink bits {m['uplink_bpp'] * n * d * ROUNDS}")
    theta = out["theta"]
    if not all(math.isfinite(a) for a in accs) or not bool(torch.isfinite(theta).all()) \
            or float(theta.min()) < 0 or float(theta.max()) > 1:
        raise AssertionError("non-finite accuracy or theta outside [0, 1]")
    log(f"booked bits per round: uplink {ul:.0f}, downlink {dl:.0f}")
    steady = sum(sum(v[1:]) for v in ph.values()) / (ROUNDS - 1)
    return launches, steady


def phase_profile(steady_round_s: float):
    """Device time by kernel over 2 steady rounds, and the device's idle share
    of an unprofiled steady round (the profiler slows the host many-fold)."""
    task, spec, shards = quickstart.build("cuda")
    engine = FLEngine(task, spec)
    engine.run(shards, rounds=1)  # warm-up outside the window
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        engine.run(shards, rounds=2)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    if busy_ms == 0:
        log("profile: the profiler saw no device time (device busy: not measured)")
        return
    log(f"profile: device busy {busy_ms:.3f} ms per round in "
        f"{sum(e.count for e in kernels) // 2} kernels; steady round {1e3 * steady_round_s:.3f}"
        f" ms unprofiled -> device idle share {1 - busy_ms / (1e3 * steady_round_s):.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 2e3:8.3f} ms/round  x{e.count // 2:<5d} "
            f"{e.key[:100]}")


def phase_codec_vs_cpu():
    """Full-width MRC encode on the card (kernel) vs the CPU route (plain)."""
    cfg = quickstart.CONFIG
    n, nb, s, nis = cfg["n_clients"], 220, cfg["block_size"], cfg["n_is"]
    g = torch.Generator().manual_seed(7)
    q = 0.05 + 0.9 * torch.rand(n, nb, s, generator=g)
    p = torch.clamp(q + 0.05 * torch.randn(n, nb, s, generator=g), 0.05, 0.95)
    key = prng.PRNGKey(11, device="cpu")
    sels = prng.split(prng.PRNGKey(12, device="cpu"), n)
    cpu = mrc.encode_fixed(key, sels, q, p, n_is=nis)
    gpu = mrc.encode_fixed(key.cuda(), sels.cuda(), q.cuda(), p.cuda(), n_is=nis)
    gi = gpu.indices.cpu()
    same = gi == cpu.indices
    rate = float(same.to(torch.float32).mean())
    log(f"codec card vs cpu: index match {rate:.5f} over {same.numel()} blocks")
    if rate < MIN_INDEX_MATCH:
        raise AssertionError(f"card/cpu index match {rate} < {MIN_INDEX_MATCH}")
    if not torch.equal(gpu.sample.cpu()[same], cpu.sample[same]):
        raise AssertionError("same index, different decoded sample")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    sources = {"mrc_logw": mrc_weights.build}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {k: pool.submit(fn) for k, fn in sources.items()}
    builds = {k: f.result() for k, f in futures.items()}
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall")
    for name, res in builds.items():
        log(f"  {name}: {res['seconds']:.2f} s, built={res['built']}, {res['path']}")
        for line in res["log"].strip().splitlines():
            log(f"    {line}")

    main_row = check_mrc_logw((2200, 64, 128), seed=1)
    check_mrc_logw((7, 48, 100), seed=2)
    check_mrc_logw((5, 33, 7), seed=3)

    launches, steady_round_s = phase_main_path()
    phase_codec_vs_cpu()
    phase_profile(steady_round_s)

    kernels = [{"name": "mrc_logw", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mrc_logw.cu",
                "replaces": "src/repro/kernels/mrc_weights.py:71",
                "launches": launches,
                **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
