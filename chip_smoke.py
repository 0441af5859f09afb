#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit; nothing is swallowed):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written CUDA kernels from this checkout's sources, in
   parallel (one ``nvcc`` per source), and print the build times, the
   ``ptxas`` reports and a line per kernel (registers, spills, static
   shared memory); count the ``HGMMA`` (wgmma) instructions in each flash
   kernel's SASS (the bf16 ``flash_attn_wgmma`` and the f32 split-TF32
   ``flash_attn_tf32``), which must not be 0 for either;
3. hold ``prng``'s draw kernel (``ops.threefry_draw``) at the STE's mask
   and at one range of the stochastic sign bit for bit to its int64 route
   on the card, timed against its instruction or byte bound; then hold
   each kernel, through the routing wrapper the main paths call
   (``kernels.ops``), against its plain PyTorch version on the card, at the
   main paths' shapes (round 0 of the quickstart at full width for the KL
   and segment kernels), at ragged shapes and at degenerate segmentations,
   and time the kernel, the plain version and, where one exists, one
   PyTorch library call beside the kernel's bound; for the KL kernel also
   its device time and device launches per call (``torch.profiler``); for
   the keyed segment encoder (``ops.segment_mrc_encode``) also logW
   bit-identical to the u-fed kernel fed ``prng``'s draw, the near-tie
   count of its indices, and its time against the unfused route it
   replaced, with the keyed (threefry's instructions) and u-fed (bytes)
   bounds;
   the same encoder under per-client keys ``(C, 2)`` (the PR variants'
   private candidates, drawn once per client), logW bit-identical to the
   u-fed kernel fed ``prng``'s draw of each client's key, timed against
   its bound; the fused fixed-block encoder (``ops.mrc_fixed_encode``, the
   keyed form of ``mrc_logw``) at GR's shape (shared key), PR's uplink
   (one key per client), the CFL uplink's (17600 candidate rows of 16
   under Ber(1/2)) and ragged shapes: logW bit-identical to the u-fed
   ``mrc_logw`` fed ``prng``'s candidates, indices equal to the plain
   route's outside counted near-ties, the sample exact, timed against its
   plain version, the unfused route it replaced (prng's candidates through
   ``ops.mrc_logw``) and its instruction bound; the u-fed ``mrc_logw`` at
   the GR and CFL shapes with its device time beside ``torch.baddbmm``;
4. drive the three main paths on the host loop (``mode="host"``, as every
   run of phases 4-6) -- the quickstart's BiCompFL-GR at full width
   (MLP 100->256->10, d = 28160, 10 clients, 64 candidates) under
   ``FixedAllocation(128)``, ``AdaptiveAllocation(n_is=64)`` and
   ``AdaptiveAvgAllocation(n_is=64)`` -- for a few rounds each on the card,
   with every kernel launch count set to 0 just before each path and read
   just after; then ``mrc_logw`` (timed) and ``mrc_fixed_encode`` at the
   block sizes Adaptive-Avg chose;
   then the variant paths at the same width, 3 rounds each, with
   ``fl.federator.run_bicompfl``'s spec (``n_dl`` = 10, the paper's default):
   GR-Reconst (fixed), PR (fixed), PR (adaptive), PR-SplitDL (fixed), and
   PR at participation 0.5 (fixed, ``cohort_rng="jax"``, through
   ``FLEngine``), with launches, booked bits and cohorts asserted and the
   peak device memory logged; then conventional FL at
   ``examples/cfl_gradient_compression.py``'s full width (a dense MLP
   100->256->10, d = 28160, 10 clients), 3 rounds each:
   BiCompFL-GR-CFL with ``fl.federator.run_bicompfl_cfl``'s spec (one
   ``mrc_fixed_encode`` launch a round, asserted, with the reference's bits
   and bpp), and the seven baselines with ``fl.baselines.run_baseline``'s specs
   (the reference's bits; CSER and LIEC flush after round 2; no kernel
   launch); every fixed-block path launches ``mrc_fixed_encode`` once per
   encode and ``mrc_logw`` never;
5. check the card's codecs and KL statistics against the port's CPU routes
   on the same inputs (the CPU routes are tied to the JAX reference by the
   CPU tests); then one round of each variant channel's indices, card
   against CPU, on the round-0 inputs (the GR uplink's fixed encode too);
   one BiCompFL-GR-CFL round from the
   same state on the card and on the CPU (indices and bits), and one
   doublesqueeze round's EF states on the same inputs;
6. profile steady rounds of each path with ``torch.profiler``: device time
   by kernel, kernels per round, and the device's idle share of an
   unprofiled steady round; the adaptive path also on the unfused segment
   route (``seg_logw_fn=ops.segment_logw``), and GR fixed, PR fixed and
   the CFL path also on the unfused fixed-block route (prng's candidates
   through ``ops.mrc_logw``), as the before to the fused encoders' after;
   the five variant paths and the CFL path too; each with its peak device
   memory;
7. hold the model substrate's kernels (``ops.flash_attention``,
   ``ops.rwkv_time_mix``) against their plain versions at the serving
   path's full-width shapes -- attention of Qwen3-1.7B at (2, 4096, 16 heads,
   8 kv heads, 128) in bf16 and f32, RWKV-6 1.6B's mix at (2, 4096, 32, 64)
   -- and at ragged shapes (a sliding window, a ragged sequence, strong
   decay; for the bf16 wgmma kernel every Dh class, Sq off its 128-row
   blocks and Sq != Skv; RWKV with B * H above the 132 SMs and in bf16),
   with the same timings and bounds as phase 3 and
   ``scaled_dot_product_attention`` as attention's library yardstick;
   also at HuBERT's forward shape, (2, 4096, 16 heads, 16 kv heads, 80),
   non-causal, in bf16 and f32 (both timed, bound and SDPA), and at two
   small odd Dh-80 shapes (non-causal with Skv 450, causal with GQA); and
   at the training shape (2, 1024, 16, 8, 128), causal, in bf16 and in f32
   (timed: the f32 kernel's main path).  The f32 kernel's bound is its
   split-TF32 work, three TF32 products for each f32 one at 495 TFLOP/s
   (the 67 TFLOP/s of f32 on the CUDA cores is reported beside it);
8. prefill, bf16, full width and depth: ``transformer.prefill_step`` on
   (2, 4096) seeded tokens for ``qwen3-1.7b`` (28 layers) and
   ``rwkv6-1.6b`` (24 layers), counts set to 0 just before and read just
   after (one launch per layer of the kernel's mixer: 28 flash-attention
   and 24 RWKV launches); prefill time on the host clock after a warm-up,
   the peak device memory, and the kernels' share of the device time from
   ``torch.profiler``;
9. the same models in f32 at full depth: ``prefill_step``'s last logits on
   a (2, 256) prompt against 256 teacher-forced ``serve_step``s (the kernel
   against the decode path's einsum or per-token recurrence);
10. serving, bf16: ``launch.serve.Server(cfg, max_batch=4, max_seq=128)
   .generate`` on four seeded greedy requests (prompts of 16, 32, 48 and 64
   tokens, 16 new tokens each), twice, with no kernel launch (decode runs
   neither kernel, as in the reference); tokens per second;
11. (run between phases 6 and 7) the fused path, ``FLEngine.run(mode=
   "fused")`` -- the default of every entry point -- at full width on
   every path of phase 4 (GR fixed, adaptive and adaptive-avg; the five
   variant paths; BiCompFL-GR-CFL; the seven baselines, CSER's and LIEC's
   flush inside the run): a fresh engine captures its round as CUDA graphs (counts set to 0
   just before: each wrapper counts at the warm-up and the capture of each
   graph that holds its kernel, never at a replay); static plans must equal
   phase 4's host runs bit for bit (theta, theta_hat, bits, history),
   adaptive plans must pick the CPU fused run's buckets and book its bits on
   the same inputs; a second run of the signature must capture nothing and
   replay one graph per round (plus the eval, and the flush), bit for bit
   the first; a profiled run gives device time, kernels per round, the idle
   share and the port's kernels' launches per replayed round, which must
   equal the host loop's; the path's entry point (the quickstart's ``run``,
   ``run_bicompfl``, ``run_bicompfl_cfl``, ``run_baseline``, ``run_spec``)
   in its default mode must run the fused path to the same result; the fused and host
   steady round times and the peak device memory are printed;
12. (run after phase 11) wire audit, faults and kill-and-resume at the
   quickstart width (d = 28160, 10 clients), on the card only: a
   ``wire="audit"`` host run of 3 rounds on GR fixed, GR adaptive, PR
   fixed, BiCompFL-GR-CFL, doublesqueeze, M3 and FedAvg (counts set to 0
   just before and read just after), reconciled with 0 bits of slack and
   bit-identical to the same call's unaudited host run (the encoders
   launched as often), with the stream's bytes per round, framing bits and
   the audited round's time beside the unaudited one; the five
   ``registry.fault_matrix`` families under ``FaultPlan(drop_rate=0.3,
   straggler_rate=0.1, corrupt_rate=0.2, seed=1)`` for 4 rounds on the host
   loop and the fused path (the plan must bite; reports, theta, theta_hat
   and meters identical; booked retransmit bits the report's total), PR's
   faulted wire audit reconciled, the faulted fused PR round launching
   ``mrc_fixed_encode`` as often as the clean one (11 a replayed round, from
   the profiler), and the faulted and clean fused steady rounds; then a run
   killed after round 2 (later checkpoints deleted) and resumed, on PR and
   doublesqueeze, host and fused, clean and faulted, bit-identical to the
   uninterrupted run, with the checkpoint files' bytes and save times;
13. (run after phase 10) the MoE and Jamba configs at full width, cut in
   depth, bf16, seeded random weights: ``jamba-v0.1-52b``'s one unit of 8
   layers (7 Mamba and 1 attention; 4 MoE FFNs of 16 experts, top-2, and 4
   dense) and ``kimi-k2-1t-a32b``'s dense prefix layer and one MoE layer
   (384 experts, top-8, a shared expert): phase 8's prefill (1 and 2
   flash-attention launches; the share of MoE assignments dropped at
   capacity; Jamba profiled at (2, 512)), the first MoE layer's routing
   (``moe.route``) on the card against the CPU on the same f32 inputs and
   router (expert choices equal outside near ties, queue places and drops
   equal in every group without a flip), phase 10's serving on the same
   weights, and Jamba's unit in f32, prefill of (2, 128) (one dropless MoE
   group) against 128 decode steps, expert choices prefill vs decode equal
   outside near ties;
14. (run after phase 13) the last forward parts of the model substrate, bf16,
   seeded random weights, each model freed before the next:
   ``hubert-xlarge`` at full depth (48 layers, 2.52 GB), ``transformer
   .forward`` on seeded f32 frames (2, 4096, 1280) x 0.02 (48 non-causal
   flash launches at Dh 80; logits (2, 4096, 504) finite; host time, peak
   memory, device profile), a 4-layer f32 cut card against the CPU on
   (2, 256) frames, and ``Server`` and ``serve_step`` refusing it;
   ``qwen2-vl-72b`` cut to 8 layers (19 GB): ``prefill_step`` of (2, 4096)
   with 1024 image embeddings on a 32 x 32 grid of M-RoPE positions and the
   text after it (8 flash launches), the last logits moved by the images,
   ``apply_mrope`` card vs CPU at (2, 4096, 64, 128), phase 10's serving
   (text only, M-RoPE decode), and a 2-layer f32 cut's prefill vs 128
   decode steps; ``qwen3-1.7b`` with the int8 KV cache: ``quantize_kv``
   card vs CPU on (4, 8192, 8, 128) (payloads and f16 scale bits equal),
   greedy ``Server.generate`` int8 against bf16 (tokens equal up to each
   request's first step whose bf16 top-2 margin is not above twice the
   logit difference; at least one decisive step), the cache bytes (ratio
   0.5625) and one timed ``serve_step`` of each cache at batch 4, S_max
   8192, position 4000;
15. (run after phase 14) training: the reduced ``qwen3-1.7b`` and
   ``rwkv6-1.6b`` in f32 (TF32 off), one ``launch.train.Trainer`` step on
   the card (counts set to 0 just before and read just after: one launch of
   the mixer's kernel a layer), the loss and every gradient leaf through the
   two kernels' autograd Functions (kernel forward, plain backward) card
   against CPU, and the stochastic sign's bits card against CPU (equal on
   equal probabilities; from the card's gradients equal but where the
   uniform lies within rounding of the probability); ``qwen3-1.7b`` at full
   width and depth as its config stands (bf16, remat, Adam), batch 4 x seq
   1024 in 2 microbatches, 3 steps with the stochastic sign and 3 without:
   losses finite, the parameters f32 after each step (the reference's
   promotion), one ``prng`` draw a step (the key's split) and the sign's
   ranges besides in a signed one,
   112 flash launches a step (28 layers, forward and remat's
   recompute, 2 microbatches), ms a step (bf16 step 1, f32 steady), tokens/s,
   the share of 989 (step 1) and 67 (steady) TFLOP/s that 6 N D makes, peak
   memory, a profiled f32 step and a profiled bf16 first step (device busy
   share, top operations); then
   ``repro_torch.train_100m`` for 50 steps on the card: the loss falls.

The second-to-last line is a JSON object ``{"kernels": [...]}``, a row a
kernel with its launches by path (``prng``'s draw kernel, ``threefry_draw``,
replaces no TPU kernel); the last is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when torch sees no CUDA device.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import re
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import cfl_gradient_compression, convert, prng, quickstart, spans  # noqa: E402
from repro_torch.core import mrc  # noqa: E402
from repro_torch.core.bernoulli import clip01, log_ratio_coeffs  # noqa: E402
from repro_torch.core.blocks import AdaptiveAllocation, AdaptiveAvgAllocation  # noqa: E402
from repro_torch.core.blocks import BlockPlan, FixedAllocation  # noqa: E402
from repro_torch.core.quantizers import mean_abs, stochastic_sign  # noqa: E402
from repro_torch.fl import channels  # noqa: E402
from repro_torch.fl.channels import TAG_TRAIN  # noqa: E402
from repro_torch.fl.baselines import BaselineConfig, run_baseline  # noqa: E402
from repro_torch.fl.data import Dataset  # noqa: E402
from repro_torch.fl.engine import FLEngine, MeanDeltaAggregator, _kl_stats, run_spec  # noqa: E402
from repro_torch.fl.federator import BiCompFLConfig, CFLConfig, run_bicompfl  # noqa: E402
from repro_torch.fl.federator import run_bicompfl_cfl  # noqa: E402
from repro_torch.fl.faults import FaultPlan  # noqa: E402
from repro_torch.fl.registry import ALL_BASELINES, baseline_spec, bicompfl_spec  # noqa: E402
from repro_torch.fl.registry import cfl_spec, fault_matrix  # noqa: E402
from repro_torch.kernels import bernoulli_kl, build, mrc_weights, ops  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import flash_attn, rwkv_chunk  # noqa: E402
from repro_torch.kernels import segment_logw as seg_kernel  # noqa: E402
from repro_torch.kernels.segment_logw import segment_logw_ref  # noqa: E402
from repro_torch import configs, train_100m  # noqa: E402
from repro_torch.data import batches_for  # noqa: E402
from repro_torch.launch import dryrun, op_cost, train as train_mod  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32, \
    PEAK_FLOPS_TF32  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROUNDS = 5
# H100 SXM, NVIDIA data sheet (``launch/mesh.py``): HBM3, f32 outside the
# tensor cores, bf16 tensor cores dense.
HBM_BYTES_PER_S, FP32_FLOPS_PER_S, BF16_FLOPS_PER_S = HBM_BW, PEAK_FLOPS_F32, PEAK_FLOPS_BF16
# The f32 flash kernel's rate: each f32 product is three TF32 products
# (a_hi b_hi + a_hi b_lo + a_lo b_hi) on the tensor cores, dense.
TF32_SPLIT_FLOPS_PER_S = PEAK_FLOPS_TF32 / 3
# fp32 S-term sums in another order than the plain version's GEMV: a few
# ulp of the partial sums (|logW| here is O(10..100)).
LOGW_RTOL, LOGW_ATOL = 1e-5, 1e-4
# KL and segment sums: float32 terms (and, card vs CPU, logs of two
# libraries in two algebraic forms) summed in another order.  The bound is
# relative to the sum of the terms' magnitudes, which is what fp32 rounding
# of a sum scales with: ~100 ulp of it, far above rounding noise and far
# below any wrong term.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
# The card's and the CPU's transcendental functions round differently, so
# a Gumbel-max near-tie may flip an index; everything else must agree.
MIN_INDEX_MATCH = 0.99
# The keyed encoder vs its plain version on the card: an index may differ
# only where the plain route's top-2 gap of logW + gumbel is below this
# (the segment sums run in another order).
NEAR_TIE = 1e-4
# Attention and the RWKV mix, kernel vs plain version: the same f32 terms
# summed in another order, held within 1e-5 x the magnitude of the terms
# (softmax-weighted |v|; |o|'s largest entry), plus, for a bf16 output, one
# bf16 ulp of the output (both round an f32 result to 8 mantissa bits).
MODEL_RTOL, BF16_ULPS = 1e-5, 1
# f32 prefill (the flash kernel, or the chunked RWKV kernel) against 256
# teacher-forced decode steps (einsum attention, per-token recurrence) at
# full depth: relative L2 error of the last position's logits.  Two
# summation orders of the same f32 function through 24-28 layers;
# expected ~1e-5, asserted with margin.
XCHECK_REL_L2 = 1e-3
XCHECK_PROMPT = 256
PREFILL_BATCH, PREFILL_SEQ = 2, 4096
PROFILED_STEPS = 8
# Phase 16: the dry run's predictions (made before the runs they predict),
# what the runs measured, and phase 8's prefill walls.
DRY, MEASURED, PREFILL_MS = {}, {}, {}
# The caching allocator rounds every block up to a multiple of 512 bytes,
# and hands out a block of the large pool (requests over 1 MiB) whole when
# splitting it would leave less than 1 MiB (``kSmallSize``);
# ``memory_allocated`` counts the blocks' sizes.
ALLOC_ROUND, LARGE_REQUEST = 512, 1 << 20
DRYRUN_PREFILL_ARCH = "qwen3-1.7b"
DRYRUN_PRODUCTION = [("qwen3-1.7b", s) for s in configs.SHAPES] + [("kimi-k2-1t-a32b",
                                                                     "decode_32k")]
MODELS = {"qwen3-1.7b": "flash_attention", "rwkv6-1.6b": "rwkv_time_mix"}
# Phase 13: the MoE and Jamba configs at full width, cut in depth (layers
# kept): Jamba's one unit of 8 (7 Mamba, 1 attention; 4 MoE, 4 dense FFNs),
# Kimi K2's dense prefix layer and one MoE layer.  Jamba's prefill is
# profiled at (2, 512): at (2, 4096) its Mamba token loop launches ~10^5
# kernels, too many to summarise.  Its f32 cross-check keeps B x S <= 256,
# one dropless MoE group, so that prefill and decode route alike.
MOE_CUTS = {"jamba-v0.1-52b": 8, "kimi-k2-1t-a32b": 2}
PROFILE_SEQ = {"jamba-v0.1-52b": 512}
MOE_XCHECK_PROMPT = 128
# Two computations of the router probabilities (card vs CPU, prefill vs
# decode) may choose other experts only for a token whose top-k gap is
# within the gap their measured difference allows (``tie_tol``); such
# tokens must stay at most this share of all.
MAX_NEAR_TIE_SHARE = 0.02
# Phase 14: Qwen2-VL cut to 8 layers at full width (its 1024 image
# embeddings as a 32 x 32 grid of M-RoPE positions; 2 layers in f32 for
# prefill vs decode), HuBERT at full depth with a 4-layer f32 cut held card
# against CPU on (2, 256) frames, and qwen3-1.7b's int8 KV cache at batch 4
# and S_max 8192, one step timed at position 4000.  M-RoPE card vs CPU,
# relative L2: the devices' pow, cos and sin round differently, and the
# angles reach thousands of radians.
VLM_CUT, VLM_GRID, VLM_XCHECK_LAYERS = 8, 32, 2
AUDIO_XCHECK_LAYERS, AUDIO_XCHECK_SEQ = 4, 256
KV_QUANT_BATCH, KV_QUANT_SEQ, KV_QUANT_POS = 4, 8192, 4000
MROPE_REL_L2 = 1e-6
# Phase 15: training.  qwen3-1.7b as its config stands (28 layers, d 2048,
# vocab 151936, bf16, remat) under Adam, batch 4 x seq 1024 in 2
# microbatches with kv_chunk = seq (the CLI's), 3 steps with the stochastic
# sign and 3 without; the reduced qwen3 and rwkv6 in f32 card vs CPU (72
# tokens cross a 64-token RWKV chunk): gradients through the same plain
# backward in two libraries' summation orders, and sign bits equal but where
# the uniform lies within SIGN_TIE of its probability (K = mean |g| sums in
# two orders); the 100M example for 50 steps.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS, TRAIN_LR = \
    "qwen3-1.7b", 4, 1024, 2, 3, 3e-4
TRAIN_CHECK, TRAIN_CHECK_SEQ = ("qwen3-1.7b", "rwkv6-1.6b"), 72
GRAD_RTOL, SIGN_TIE = 1e-5, 1e-6
TRAIN_100M_STEPS, TRAIN_100M_BATCH, TRAIN_100M_SEQ = 50, 8, 256
KERNELS = ("mrc_logw", "mrc_fixed_encode", "bernoulli_kl", "bernoulli_kl_total",
           "bernoulli_kl_profile", "segment_logw", "segment_mrc_encode", "segment_select",
           "flash_attention", "rwkv_time_mix", "threefry_draw")
# prng's draws on the card: every FL path draws (masks, keys, shuffles) as
# often as its task and codec make it, which the checks do not predict;
# a model's prefill and greedy decode draw nothing.
DRAWS = "threefry_draw"
# The keyed encoders are bound by their threefry draws.  A draw's cost is
# read from compiled code: two probe kernels, built from csrc/common.cuh
# with the kernels' nvcc flags, store in a loop either uniform_at(key, j)
# or j itself; a draw's SASS instructions are the difference of the two
# loop bodies (the key schedule is hoisted out of both, as it is out of
# the kernels' row loops).
THREEFRY_PROBE = r"""
#include <stdint.h>
#include "common.cuh"
extern "C" __global__ void draw_probe(float* out, uint2 key, unsigned n) {
#pragma unroll 1
  for (unsigned j = threadIdx.x; j < n; j += blockDim.x) out[j] = uniform_at(key, j);
}
extern "C" __global__ void index_probe(float* out, uint2 key, unsigned n) {
#pragma unroll 1
  for (unsigned j = threadIdx.x; j < n; j += blockDim.x) out[j] = __uint_as_float(j);
}
"""
# An H100 SM issues at most one warp instruction per clock from each of
# its four schedulers, whatever pipe the instruction goes to (ALU, FMA or
# another): 128 thread instructions per SM per clock, the rate behind the
# data sheet's 67 TFLOP/s of fp32 (an FFMA counted as two operations).
ISSUE_LANES_PER_SM, SMS = 128, 132
# Device function names of each model kernel (bf16 and f32 flash; RWKV's two passes).
KERNEL_SYMBOLS = {"flash_attention": ("flash_attn_wgmma", "flash_attn_tf32"),
                  "rwkv_time_mix": ("rwkv_intra", "rwkv_inter")}
PATHS = {"fixed": None, "adaptive": AdaptiveAllocation, "adaptive-avg": AdaptiveAvgAllocation}
# The other BiCompFL variants at the quickstart's width: (variant,
# allocation, participation, cohort RNG); n_dl = n_clients * n_ul = 10.
VARIANTS = {"GR-Reconst fixed": ("GR-Reconst", "fixed", 1.0, "numpy"),
            "PR fixed": ("PR", "fixed", 1.0, "numpy"),
            "PR adaptive": ("PR", "adaptive", 1.0, "numpy"),
            "PR fixed p=0.5 jax cohorts": ("PR", "fixed", 0.5, "jax"),
            "PR-SplitDL fixed": ("PR-SplitDL", "fixed", 1.0, "numpy")}
VARIANT_ROUNDS, N_DL = 3, 10
# The reference's cohorts (repro.fl.engine.FLEngine.cohort_schedule(3, 10, 5,
# seed 0, "jax"), computed with jax 0.9): what the card's run must draw.
JAX_COHORTS = [[0, 2, 4, 5, 9], [2, 5, 6, 8, 9], [0, 5, 6, 8, 9]]
# BiCompFL-GR-CFL and the baselines at examples/cfl_gradient_compression.py's
# configuration (10 clients, MLP 100->256->10, d = 28160; CFLConfig's
# n_is 256 and blocks of 16), 3 rounds each; CSER and LIEC sync every
# BASELINE_PERIOD rounds, so that a flush falls inside the run.
CFL_ROUNDS, BASELINE_PERIOD = 3, 2
CFL_LOGW_SHAPE = (10 * 1760, 256, 16)   # one round's encode as u-fed rows: (n * B, n_is, S)
# The reference's booked bits, cumulative per round, for the same runs
# (repro.fl: run_bicompfl_cfl and run_baseline with these settings, on the
# CPU), and the CFL run's bpp as the example prints them to 6 places.
CFL_REF_BITS = [1411200.0, 2822400.0, 4233600.0]
CFL_REF_BPP = {"bpp": "5.011364", "uplink_bpp": "0.501136", "downlink_bpp": "4.510227",
               "bpp_bc": "0.952159"}
BASELINE_REF_BITS = {"fedavg": [18022400.0, 36044800.0, 54067200.0],
                     "memsgd": [9293120.0, 18586240.0, 27879360.0],
                     "doublesqueeze": [563840.0, 1127680.0, 1691520.0],
                     "neolithic": [1127680.0, 2255360.0, 3383040.0],
                     "cser": [9293120.0, 36608640.0, 45901760.0],
                     "liec": [563840.0, 19150080.0, 19713920.0],
                     "m3": [2224640.0, 4449280.0, 6673920.0]}
# The paths driven on the fused path (phase 11): every path of phase 4, each
# compared with its host run there (a label of ``runs``); the port's kernels
# by device name.
FUSED_PATHS = (*PATHS, *VARIANTS, "cfl", *(f"baseline {s}" for s in ALL_BASELINES))
OWN_KERNELS = ("mrc_logw_kernel", "mrc_encode_kernel", "kl_rows", "kl_cols", "seg_pass",
               "seg_select")
# Phase 12: the wire-audited paths (labels of FUSED_PATHS), the fault plan
# (DESIGN.md §8's smoke rates), and the rounds of the faulted and resumed
# runs (a checkpoint every 2 rounds; the "crash" after round 2).
WIRE_PATHS = ("fixed", "adaptive", "PR fixed", "cfl", "baseline doublesqueeze",
              "baseline m3", "baseline fedavg")
WIRE_ROUNDS, FAULT_ROUNDS, CKPT_EVERY = 3, 4, 2
FAULT_PLAN = FaultPlan(drop_rate=0.3, straggler_rate=0.1, corrupt_rate=0.2, seed=1)
# Sign error feedback, card vs CPU on the same inputs: the scale mean|v|
# sums 28160 terms in two orders, so the compressed vectors and EF states
# agree to a few ulp of the scale; a sign may differ only within
# SIGN_MARGIN scales of zero.
EF_RTOL, SIGN_MARGIN = 2e-6, 1e-5


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


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes}


def ptxas_summary(text: str) -> list[str]:
    """One line per kernel from nvcc's ``-Xptxas -v`` report: registers,
    spill bytes and static shared memory (the dynamic part is set at launch)."""
    lines, fn, spill = [], None, ""
    for line in text.splitlines():
        if "Function properties for" in line:
            fn, spill = line.split("Function properties for")[-1].strip(), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            lines.append(f"{fn}: {line.split(':', 1)[-1].strip()}; {spill}")
            fn = None
    return lines


def flash_hgmma(path: str) -> dict:
    """``HGMMA`` (wgmma) instructions in the flash library's SASS
    (``cuobjdump -sass``), summed over the instantiations of each kernel
    named in ``KERNEL_SYMBOLS``."""
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for fn, code in sass_functions(sass).items():
        for name in KERNEL_SYMBOLS["flash_attention"]:
            if name in fn:
                out[name] = out.get(name, 0) + sum(ins.split()[1 if ins.startswith("@") else 0]
                                                   .startswith("HGMMA") for _, ins in code)
    return out


SASS_LINE = re.compile(r"^/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")


def sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` text -> {function: [(address, instruction)]};
    a label line (``.L_x_3:``) is kept as (address of the next
    instruction, the label)."""
    fns, cur, labels = {}, None, []
    for line in sass.splitlines():
        text = line.strip()
        m = SASS_LINE.match(text)
        if text.startswith("Function :"):
            cur = fns.setdefault(text.split(":", 1)[1].strip(), [])
        elif cur is not None and text.startswith(".") and text.endswith(":"):
            labels.append(text[:-1])
        elif cur is not None and m:
            cur.extend((int(m[1], 16), lab) for lab in labels)
            labels = []
            cur.append((int(m[1], 16), m[2]))
    return fns


def loop_body(code: list) -> list:
    """The instructions of a function's one loop, from the target of its
    backward branch to the branch itself, NOPs left out."""
    where = {ins: addr for addr, ins in code if ins.startswith(".")}
    for addr, ins in code:
        words = ins.split()
        if not any(w.split(".")[0] == "BRA" for w in words[:2]):
            continue
        target = words[-1].strip("`()")
        start = where.get(target, int(target, 16) if target.startswith("0x") else None)
        if start is not None and start < addr:
            return [i for a, i in code if start <= a <= addr and not i.startswith(".")
                    and not i.startswith("NOP")]
    raise AssertionError("no backward branch in the probe's SASS")


def threefry_instructions() -> tuple[int, dict]:
    """SASS instructions of one threefry draw (``uniform_at``), as the
    difference of the probe kernels' loop bodies; and the draw loop's
    instructions by opcode."""
    probe = build.BUILD_DIR / "threefry_probe.cu"
    probe.parent.mkdir(parents=True, exist_ok=True)
    probe.write_text(THREEFRY_PROBE)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                      "-Xptxas", "-v")]
    cubin = probe.with_suffix(".cubin")
    subprocess.run([build.cuda_tool("nvcc"), *flags, "-cubin", "-I", str(build.CSRC),
                    "-o", str(cubin), str(probe)], check=True, capture_output=True, text=True)
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    fns = sass_functions(sass)
    draw, index = loop_body(fns["draw_probe"]), loop_body(fns["index_probe"])
    ops_by_code = {}
    for ins in draw:
        code = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        ops_by_code[code.split(".")[0]] = ops_by_code.get(code.split(".")[0], 0) + 1
    n = len(draw) - len(index)
    if n < 60:
        raise AssertionError(f"threefry probe: {n} instructions a draw is below threefry's "
                             "20 rounds of add, rotate and xor")
    return n, ops_by_code


def launched_once(fn, *args, **kwargs):
    """Call an ``ops`` wrapper once and check that it launched its kernel."""
    before = fn.launches
    out = fn(*args, **kwargs)
    if fn.launches != before + 1:
        raise AssertionError(f"ops.{fn.__name__} did not launch its kernel on the card")
    torch.cuda.synchronize()
    return out


def reset_counts():
    for k in KERNELS:
        getattr(ops, k).launches = 0


def read_counts():
    return {k: getattr(ops, k).launches for k in KERNELS}


def drawn(launches, expect, label):
    """``expect`` with prng's draws as counted in ``launches``, which an FL
    run must show: it drew on the card."""
    if not launches[DRAWS]:
        raise AssertionError(f"{label}: prng drew nothing on the card")
    return {**expect, DRAWS: launches[DRAWS]}


def device_profile(fn, per: int = 1):
    """Run ``fn`` under ``torch.profiler``: (device busy ms per ``per``, the
    CUDA events with device time).  Busy is 0 when the profiler saw none.
    The program's spans drawn on the device's timeline (user annotations)
    are not device work and are left out."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in events) / 1e3 / per, events


def device_per_call(fn, calls: int = 50, expect: int | None = None, passes: int = 3):
    """(device ms per call, device kernels per call) of ``fn`` from
    ``torch.profiler`` over ``calls`` back-to-back calls; (0, 0) when the
    profiler saw no device time.

    With ``expect`` (the device kernels one call launches) a profile that
    holds fewer kernel records than ``expect * calls`` lost some of them and
    is no measurement: ``passes`` profiles are taken, the device time is the
    median of the complete ones, and None ("not measured") when none was
    complete."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(passes if expect else 1):
        busy, events = device_profile(lambda: [fn() for _ in range(calls)], calls)
        count = sum(e.count for e in events)
        if busy and expect and count < expect * calls:
            log(f"  profiler record incomplete: {count} of {expect * calls} device kernels "
                f"({busy:.4f} ms a call seen); profiling again")
            continue
        seen.append((busy, count / calls))
    if not seen:
        log(f"  the profiler lost kernel records in all {passes} passes: device time not "
            f"measured")
        return None, count / calls
    return sorted(seen)[len(seen) // 2]


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def timed_row(name, shape, err, kernel, plain, library, nbytes, flops,
              flops_per_s=FP32_FLOPS_PER_S, reps=50):
    row = {"shape": list(shape), "max_abs_err": err, "ms": cuda_time_ms(kernel, reps),
           "plain_ms": cuda_time_ms(plain, reps),
           "library_ms": cuda_time_ms(library, reps) if library is not None else None,
           **bound(nbytes, flops, flops_per_s)}
    lib = f"{row['library_ms']:.4f} ms" if library is not None else "none"
    log(f"{name} {tuple(shape)}: max|err| {err:.3e}  kernel {row['ms']:.4f} ms  "
        f"plain {row['plain_ms']:.4f} ms  library {lib}  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}, {nbytes:.0f} B)")
    return row


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def logw_inputs(nb: int, nis: int, s: int, seed: int):
    """Candidates x = (u < p) and log-ratio coefficients, made on the card."""
    key = prng.PRNGKey(seed, device="cuda")
    ku, kq, kp = prng.split(key, 3)
    q = 0.15 + 0.7 * prng.uniform(kq, (nb, s))
    p = torch.clamp(q + 0.1 * prng.normal(kp, (nb, s)), 0.05, 0.95)
    x = (prng.uniform(ku, (nb, nis, s)) < p[:, None, :]).to(torch.float32)
    a, b = log_ratio_coeffs(q, p)
    return x.contiguous(), a.contiguous(), b.contiguous()


def check_mrc_logw(shape, seed, timed=True, device=False):
    """Kernel (through ``ops.mrc_logw``) vs plain version on one shape;
    ``device`` adds its device time and device kernels per call."""
    x, a, b = logw_inputs(*shape, seed)
    got = launched_once(ops.mrc_logw, x, a, b)
    want = mrc_weights.mrc_logw_ref(x, a, b)
    err = (got - want).abs()
    tol = LOGW_ATOL + LOGW_RTOL * want.abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"mrc_logw {shape}: max |err| {err.max().item()} "
                             f"beyond atol {LOGW_ATOL} + rtol {LOGW_RTOL}")
    if not timed:
        log(f"mrc_logw {shape}: max|err| {err.max().item():.3e}")
        return None
    bsum = b.sum(-1)[:, None, None]
    a3 = a[:, :, None]
    work = kcost.mrc_logw(x, a, b)
    row = timed_row("mrc_logw", shape, err.max().item(), lambda: ops.mrc_logw(x, a, b),
                    lambda: mrc_weights.mrc_logw_ref(x, a, b),
                    lambda: torch.baddbmm(bsum, x, a3), work.nbytes, work.flops)
    if device:
        dev_ms, per_call = device_per_call(lambda: ops.mrc_logw(x, a, b), expect=1)
        row.update(device_ms=dev_ms, device_kernels_per_call=per_call)
        log(f"mrc_logw {tuple(shape)}: device {fmt_ms(dev_ms)} and {per_call:.2f} device "
            f"kernels per call (torch.profiler, 50 calls); {row['ms'] / row['bound_ms']:.2f}x "
            f"its bound; baddbmm takes {row['library_ms'] / row['ms']:.2f}x its time")
    return row


def check_threefry_draw(tf):
    """``prng``'s draw kernel (``ops.threefry_draw``) at the benchmark
    cells' draws -- the STE's mask, bernoulli at (10, 203264) under keys
    strided out of (10, 138, 2), and one range of the stochastic sign,
    uniform_at at 2^24 positions -- bit for bit its plain int64 route on
    the card, timed against its bound: the draws' SASS instructions at the
    issue rate, or the bytes of p or the positions and the output."""
    key = prng.PRNGKey(3, device="cuda")
    mk = prng.split(prng.split(key, 10), 138)[:, 0]
    p = prng.uniform(prng.fold_in(key, 1), (10, 203264))
    lo = 135 * 2 ** 24
    counts = torch.arange(lo, lo + 2 ** 24, device="cuda")
    rows = {}
    for label, args, shape in (("bernoulli, the STE's mask", (mk, (203264,), 0, "bernoulli", p),
                                (10, 203264)),
                               ("uniform_at, a range of the sign", (key, counts, 1, "unit"),
                                (2 ** 24,))):
        got = launched_once(ops.threefry_draw, *args)
        want = prng.draw_int64(*args)
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            raise AssertionError(f"threefry_draw {label}: {int((got != want).sum())} draws "
                                 "differ from the int64 route")
        work = kcost.threefry_draw(*args)
        row = timed_row(f"threefry_draw {label}", shape, 0.0,
                        lambda a=args: ops.threefry_draw(*a),
                        lambda a=args: prng.draw_int64(*a), None, work.nbytes,
                        work.draws * tf[0], tf[1], reps=20)
        row["device_ms"], row["device_kernels_per_call"] = device_per_call(
            lambda a=args: ops.threefry_draw(*a), 20, expect=1)
        row["plain_device_ms"], row["plain_kernels_per_call"] = device_per_call(
            lambda a=args: prng.draw_int64(*a), 5)
        row.update(threefry_draws=work.draws, threefry_instructions=tf[0])
        log(f"threefry_draw {label} {shape}: equal to the int64 route; kernel {row['ms']:.4f} "
            f"ms (device {fmt_ms(row['device_ms'])} in {row['device_kernels_per_call']:.1f} "
            f"kernels a call), int64 route {row['plain_ms']:.4f} ms (device "
            f"{fmt_ms(row['plain_device_ms'])} in {row['plain_kernels_per_call']:.1f} kernels); "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {work.draws:.0f} draws x "
            f"{tf[0]} SASS instructions at {tf[1]:.3e}/s; {work.nbytes:.0f} B); "
            f"{row['ms'] / row['bound_ms']:.2f}x its bound")
        rows[label] = row
    return rows


def round0_inputs():
    """Round 0 of the quickstart on the card: (posteriors, priors), (10, d).

    The same local training the engine runs, with the engine's keys, so the
    KL profile, plan and segment weights below are the main path's own.
    """
    task, _, shards = quickstart.build("cuda")
    theta_hat = task.init_theta()[None].repeat(shards.y.shape[0], 1)
    kt = mrc.round_key(prng.PRNGKey(quickstart.CONFIG["seed"], device="cuda"), 0)
    keys = prng.split(prng.fold_in(kt, TAG_TRAIN), shards.y.shape[0])
    payload = task.local_train(theta_hat, shards.x, shards.y, keys)
    torch.cuda.synchronize()
    return payload, theta_hat, kt


def kl_scale(q, p):
    """Per-element magnitude of the KL's two terms (what rounding scales with)."""
    q, p = clip01(q), clip01(p)
    return (q * (torch.log(q) - torch.log(p))).abs() \
        + ((1 - q) * (torch.log1p(-q) - torch.log1p(-p))).abs()


def assert_close_sums(name, got, want, scale):
    err = (got - want).abs()
    tol = SUM_RTOL * scale + SUM_ATOL
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
            or bool((err > tol).any()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max |err| {err.max().item()}, worst err/tol "
                             f"{(err / tol).max().item()}")
    return err.max().item()


def check_bernoulli_kl(payload, priors):
    """The three KL entry points vs their plain versions; times the two the
    adaptive paths call at their shape (10, 28160)."""
    p = clip01(priors)
    rows = {}
    n, d = payload.shape
    sc = kl_scale(payload, p)
    err = assert_close_sums("bernoulli_kl_profile (10, 28160)",
                            launched_once(ops.bernoulli_kl_profile, payload, p),
                            bernoulli_kl.profile_ref(payload, p), sc.sum(0) / n)
    work = kcost.bernoulli_kl_profile(payload, p)
    rows["profile"] = timed_row(
        "bernoulli_kl_profile", (n, d), err, lambda: ops.bernoulli_kl_profile(payload, p),
        lambda: bernoulli_kl.profile_ref(payload, p), None, work.nbytes, work.flops)
    err = assert_close_sums("bernoulli_kl_total (10, 28160)",
                            launched_once(ops.bernoulli_kl_total, payload, p),
                            bernoulli_kl.total_ref(payload, p), sc.sum() / n)
    work = kcost.bernoulli_kl_total(payload, p)
    rows["total"] = timed_row(
        "bernoulli_kl_total", (n, d), err, lambda: ops.bernoulli_kl_total(payload, p),
        lambda: bernoulli_kl.total_ref(payload, p), None, work.nbytes, work.flops)
    for form, fn in (("profile", ops.bernoulli_kl_profile), ("total", ops.bernoulli_kl_total)):
        dev_ms, per_call = device_per_call(lambda: fn(payload, p), expect=1)
        rows[form].update(device_ms=dev_ms, device_kernels_per_call=per_call)
        log(f"bernoulli_kl_{form} (10, 28160): device {fmt_ms(dev_ms)} and {per_call:.2f} "
            f"device kernels per call (torch.profiler, 50 calls); through ops "
            f"{rows[form]['ms']:.4f} ms (CUDA events, 50 back-to-back calls)")
        if dev_ms and per_call != 1:
            raise AssertionError(f"bernoulli_kl_{form}: {per_call} device launches per call")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in [(7, 3001), (3, 5), (1, 1), (4, 2048), (2200, 128), (1, 300000)]:
        q = torch.rand(shape, generator=gen, device="cuda")
        pp = torch.rand(shape, generator=gen, device="cuda")
        q[0, 0], pp[0, -1] = 0.0, 1.0
        sc = kl_scale(q, pp)
        errs = [assert_close_sums(f"bernoulli_kl {shape}", launched_once(ops.bernoulli_kl, q, pp),
                                  bernoulli_kl.rows_ref(q, pp), sc.sum(-1)),
                assert_close_sums(f"bernoulli_kl_total {shape}",
                                  launched_once(ops.bernoulli_kl_total, q, pp),
                                  bernoulli_kl.total_ref(q, pp), sc.sum() / shape[0]),
                assert_close_sums(f"bernoulli_kl_profile {shape}",
                                  launched_once(ops.bernoulli_kl_profile, q, pp),
                                  bernoulli_kl.profile_ref(q, pp), sc.sum(0) / shape[0])]
        again = (ops.bernoulli_kl(q, pp), ops.bernoulli_kl_total(q, pp))   # tickets reset
        if not (torch.equal(again[0], ops.bernoulli_kl(q, pp))
                and torch.equal(again[1], ops.bernoulli_kl_total(q, pp))):
            raise AssertionError(f"bernoulli_kl {shape}: two calls differ")
        log(f"bernoulli_kl {shape}: rows/total/profile max|err| "
            + " / ".join(f"{e:.3e}" for e in errs))
    return rows


def segment_inputs(payload, priors, kt, n_is):
    """The main path's segment_logw call of a round: shared candidates
    (n_is, d), clipped priors and log-ratio coefficients (10, d)."""
    u = seg_kernel.segment_candidates(kt, n_is, payload.shape[1])
    a, b = log_ratio_coeffs(clip01(payload), priors)
    return u, clip01(priors).contiguous(), a.contiguous(), b.contiguous()


def check_segment_case(label, u, p, a, b, seg, n_seg):
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device="cuda")
    got = launched_once(ops.segment_logw, u, p, a, b, seg_t, n_seg)
    want = segment_logw_ref(u, p, a, b, seg_t.long(), n_seg)
    mag = segment_logw_ref(torch.zeros_like(u), torch.ones_like(p), a.abs(), b.abs(),
                           seg_t.long(), n_seg)
    err = assert_close_sums(f"segment_logw {label}", got, want, mag)
    log(f"segment_logw {label}: u {tuple(u.shape)}, n_seg {n_seg}: max|err| {err:.3e}")
    return seg_t, got, want, err


def check_segment_logw(payload, priors, kt, seg, n_seg):
    """Main path's shapes (shared u (64, 28160), 10 clients, the round-0
    plan), degenerate segmentations and ragged shapes."""
    u, p, a, b = segment_inputs(payload, priors, kt, 64)
    seg_t, _, _, err = check_segment_case("main path", u, p, a, b, seg, n_seg)
    c, nis, d = p.shape[0], u.shape[0], u.shape[1]
    work = kcost.segment_logw(u, p, a, b, seg_t, n_seg)
    row = timed_row("segment_logw", (c, nis, d, n_seg), err,
                    lambda: ops.segment_logw(u, p, a, b, seg_t, n_seg),
                    lambda: segment_logw_ref(u, p, a, b, seg_t.long(), n_seg), None,
                    work.nbytes, work.flops)
    check_segment_case("one segment", u, p, a, b, np.zeros(d, np.int32), 1)
    check_segment_case("all singletons", u, p, a, b, np.arange(d, dtype=np.int32), d)
    rng = np.random.default_rng(3)
    cuts = np.sort(rng.choice(np.arange(1, d), size=600, replace=False))
    gaps = np.zeros(d, np.int32)
    gaps[cuts] = rng.integers(1, 3, cuts.size)                 # some ids skipped
    check_segment_case("skipped ids", u, p, a, b, np.cumsum(gaps).astype(np.int32),
                       int(gaps.sum()) + 1)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for cl, nis2, d2 in [(3, 33, 1001), (1, 1, 7), (2, 70, 513)]:
        uu = torch.rand(nis2, d2, generator=gen, device="cuda")
        pp = torch.rand(cl, d2, generator=gen, device="cuda")
        aa, bb = log_ratio_coeffs(torch.rand(cl, d2, generator=gen, device="cuda"), pp)
        sg = np.sort(rng.integers(0, max(d2 // 5, 1), d2)).astype(np.int32)
        sg -= sg[0]
        check_segment_case(f"ragged {cl} clients", uu, pp, aa.contiguous(),
                           bb.contiguous(), sg, int(sg[-1]) + 1)
    return row


def u_fed_logw(key, pc, a, b, seg_t, n_seg, n_is):
    """The u-fed kernel fed ``prng``'s draw of ``key``: one call for a
    shared (2,) key, one call per client for (C, 2) keys."""
    d = pc.shape[-1]
    if key.dim() == 1:
        return seg_kernel.segment_logw_cuda(seg_kernel.segment_candidates(key, n_is, d), pc,
                                            a, b, seg_t, n_seg)
    return torch.stack([seg_kernel.segment_logw_cuda(
        seg_kernel.segment_candidates(key[c], n_is, d), pc[c], a[c], b[c], seg_t, n_seg)
        for c in range(key.shape[0])])


def check_encode_case(label, key, sels, pc, a, b, seg, n_seg, n_is=64):
    """The keyed kernel through ``ops.segment_mrc_encode`` (``key`` (2,) or
    one per client, (C, 2)): logW bit-identical to the u-fed kernel fed
    prng's draw of the same key(s), logW within the
    sums' bound of the plain version, indices equal to the plain version's
    but at near-ties (counted, each below NEAR_TIE), the sample exact where
    the indices agree, and the select pass alone (the decoder) equal to the
    sample.  Returns (max |err| of logW, near-tie mismatches)."""
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device="cuda")
    seg_l = seg_t.long()
    d = pc.shape[-1]
    idx, sample, logw = launched_once(ops.segment_mrc_encode, key, sels, pc, a, b, seg_t,
                                      n_is, n_seg)
    fed = u_fed_logw(key, pc, a, b, seg_t, n_seg, n_is)
    if not torch.equal(logw, fed):
        raise AssertionError(f"segment_mrc_encode {label}: keyed and u-fed logW differ "
                             f"(max |diff| {(logw - fed).abs().max().item()})")
    w_idx, w_sample, w_logw = seg_kernel.segment_mrc_encode_ref(key, sels, pc, a, b, seg_l,
                                                                n_is, n_seg)
    mag = segment_logw_ref(torch.zeros(n_is, d, device="cuda"), torch.ones_like(pc), a.abs(),
                           b.abs(), seg_l, n_seg)
    err = assert_close_sums(f"segment_mrc_encode logW {label}", logw, w_logw, mag)
    gu = prng.uniform(sels, (n_is, n_seg))
    score = torch.sort(w_logw - torch.log(-torch.log(torch.clamp(gu, 1e-12, 1 - 1e-12))),
                       dim=-2).values
    gap = score[:, -1] - score[:, -2] if n_is > 1 else torch.full_like(score[:, 0], np.inf)
    diff = idx != w_idx
    worst = float(gap[diff].max()) if bool(diff.any()) else 0.0
    if worst >= NEAR_TIE:
        raise AssertionError(f"segment_mrc_encode {label}: index differs where the top-2 "
                             f"gap is {worst}")
    keep = ~diff[:, seg_l]
    dec = launched_once(ops.segment_select, key, idx, pc, seg_t)
    if not torch.equal(sample[keep], w_sample[keep]) or not torch.equal(dec, sample):
        raise AssertionError(f"segment_mrc_encode {label}: sample differs from the plain "
                             "route's or from the select pass's")
    log(f"segment_mrc_encode {label}: ({pc.shape[0]}, {n_is}, {d}, {n_seg}): logW "
        f"bit-identical to the u-fed kernel; max|err| vs plain {err:.3e}; near-tie index "
        f"mismatches {int(diff.sum())} of {diff.numel()} (largest top-2 gap among them "
        f"{worst:.3e}, bound {NEAR_TIE}); sample exact where the indices agree")
    return err, int(diff.sum())


def check_segment_encode(payload, priors, kt, seg, n_seg, tf, fed_row):
    """The keyed kernel at the main path's call of a round (10 clients,
    n_is = 64, the round-0 plan), at degenerate segmentations and ragged
    shapes; timed against its plain version and against the unfused route
    it replaced (prng draw, u-fed kernel, Gumbel draw, logs, argmax, gather),
    with the keyed bound (threefry's instructions at the issue rate) and the
    u-fed one."""
    n, d = payload.shape
    pc = clip01(priors).contiguous()
    a, b = (t.contiguous() for t in log_ratio_coeffs(clip01(payload), priors))
    sels = prng.split(prng.fold_in(kt, 7), n)
    err, ties = check_encode_case("main path", kt, sels, pc, a, b, seg, n_seg)
    check_encode_case("one segment", kt, sels, pc, a, b, np.zeros(d, np.int32), 1)
    check_encode_case("all singletons", kt, sels[:2], pc[:2], a[:2], b[:2],
                      np.arange(d, dtype=np.int32), d)
    check_encode_case("empty tail", kt, sels, pc, a, b, seg, n_seg + 5)
    rng = np.random.default_rng(4)
    for cl, nis, d2 in [(3, 33, 1001), (1, 1, 7), (17, 40, 3000)]:
        gen = torch.Generator(device="cuda").manual_seed(d2)
        qq, pp = (torch.rand(cl, d2, generator=gen, device="cuda") for _ in range(2))
        aa, bb = (t.contiguous() for t in log_ratio_coeffs(qq, pp))
        sg = np.sort(rng.integers(0, max(d2 // 5, 1), d2)).astype(np.int32)
        sg -= sg[0]
        check_encode_case(f"ragged {cl} clients", kt, prng.split(kt, cl), clip01(pp),
                          aa, bb, sg, int(sg[-1]) + 1, n_is=nis)

    seg_t = torch.as_tensor(seg, dtype=torch.int32, device="cuda")
    seg_l = seg_t.long()
    kernel = lambda: ops.segment_mrc_encode(kt, sels, pc, a, b, seg_t, 64, n_seg)  # noqa: E731
    plain = lambda: seg_kernel.segment_mrc_encode_ref(  # noqa: E731
        kt, sels, pc, a, b, seg_l, 64, n_seg)
    unfused = lambda: seg_kernel.segment_mrc_encode_ref(  # noqa: E731
        kt, sels, pc, a, b, seg_t, 64, n_seg, seg_logw_fn=ops.segment_logw)
    work = kcost.segment_mrc_encode(kt, sels, pc, a, b, seg_t, 64, n_seg)
    draws, nbytes = work.draws, work.nbytes
    row = timed_row("segment_mrc_encode", (n, 64, d, n_seg), err, kernel, plain, None,
                    nbytes, draws * tf[0], tf[1])
    row["unfused_ms"] = cuda_time_ms(unfused)
    row["device_ms"], row["device_kernels_per_call"] = device_per_call(kernel, 20, expect=3)
    row["unfused_device_ms"], row["unfused_kernels_per_call"] = device_per_call(unfused, 5)
    row.update(near_tie_mismatches=ties, threefry_draws=draws,
               threefry_instructions=tf[0], instructions_per_s=tf[1],
               u_fed_bound_ms=fed_row["bound_ms"])
    log(f"segment_mrc_encode vs the unfused route it replaced (prng draw of u, u-fed "
        f"segment_logw, Gumbel draw, logs, argmax, gather): kernel {row['ms']:.4f} ms "
        f"(device {fmt_ms(row['device_ms'])} in {row['device_kernels_per_call']:.1f} kernels "
        f"per call) vs unfused {row['unfused_ms']:.4f} ms (device "
        f"{row['unfused_device_ms']:.4f} ms in {row['unfused_kernels_per_call']:.1f} kernels "
        f"per call); keyed bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {draws} draws x "
        f"{tf[0]} SASS instructions at {tf[1]:.3e}/s), u-fed bound "
        f"{fed_row['bound_ms']:.4f} ms ({fed_row['bound_by']})")
    return row


def check_client_key_encode(payload, priors, kt, seg, n_seg, tf):
    """The keyed kernel under per-client keys, at PR adaptive's uplink call
    of a round (the 10 clients' private keys ``client_key(kt, i)``, n_is =
    64, the round-0 plan), at one client, degenerate segmentations and
    ragged shapes; a shared key repeated per client must give the shared
    form's results bit for bit.  Timed against its plain version and the
    bound of C times the shared form's draws."""
    n, d = payload.shape
    pc = clip01(priors).contiguous()
    a, b = (t.contiguous() for t in log_ratio_coeffs(clip01(payload), priors))
    keys = mrc.client_key(kt, torch.arange(n, device="cuda"))
    sels = prng.split(prng.fold_in(kt, 7), n)
    err, ties = check_encode_case("client keys, main path", keys, sels, pc, a, b, seg, n_seg)
    check_encode_case("client keys, one client", keys[:1], sels[:1], pc[:1], a[:1], b[:1],
                      seg, n_seg)
    check_encode_case("client keys, one segment", keys, sels, pc, a, b,
                      np.zeros(d, np.int32), 1)
    check_encode_case("client keys, all singletons", keys[:2], sels[:2], pc[:2], a[:2], b[:2],
                      np.arange(d, dtype=np.int32), d)
    rng = np.random.default_rng(5)
    for cl, nis, d2 in [(3, 33, 1001), (2, 16, 515), (17, 40, 3000)]:
        gen = torch.Generator(device="cuda").manual_seed(d2 + 1)
        qq, pp = (torch.rand(cl, d2, generator=gen, device="cuda") for _ in range(2))
        aa, bb = (t.contiguous() for t in log_ratio_coeffs(qq, pp))
        sg = np.sort(rng.integers(0, max(d2 // 5, 1), d2)).astype(np.int32)
        sg -= sg[0]
        check_encode_case(f"client keys, ragged {cl} clients",
                          mrc.client_key(kt, torch.arange(cl, device="cuda")),
                          prng.split(kt, cl), clip01(pp), aa, bb, sg, int(sg[-1]) + 1, n_is=nis)
    seg_t = torch.as_tensor(seg, dtype=torch.int32, device="cuda")
    shared = seg_kernel.segment_mrc_encode_cuda(kt, sels, pc, a, b, seg_t, 64, n_seg)
    repeated = seg_kernel.segment_mrc_encode_cuda(kt.expand(n, 2).contiguous(), sels, pc, a, b,
                                                  seg_t, 64, n_seg)
    if not all(torch.equal(x, y) for x, y in zip(shared, repeated)):
        raise AssertionError("segment_mrc_encode: a shared key repeated per client differs "
                             "from the shared form")
    kernel = lambda: ops.segment_mrc_encode(keys, sels, pc, a, b, seg_t, 64, n_seg)  # noqa: E731
    plain = lambda: seg_kernel.segment_mrc_encode_ref(  # noqa: E731
        keys, sels, pc, a, b, seg_t.long(), 64, n_seg)
    work = kcost.segment_mrc_encode(keys, sels, pc, a, b, seg_t, 64, n_seg)
    draws, nbytes = work.draws, work.nbytes
    row = timed_row("segment_mrc_encode, client keys", (n, 64, d, n_seg), err, kernel, plain,
                    None, nbytes, draws * tf[0], tf[1])
    row["device_ms"], row["device_kernels_per_call"] = device_per_call(kernel, 20, expect=3)
    row.update(near_tie_mismatches=ties, threefry_draws=draws, threefry_instructions=tf[0],
               instructions_per_s=tf[1])
    log(f"segment_mrc_encode, client keys ({n}, 64, {d}, {n_seg}): kernel {row['ms']:.4f} ms "
        f"(device {fmt_ms(row['device_ms'])} in {row['device_kernels_per_call']:.1f} kernels "
        f"per call), plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {draws} draws x {tf[0]} SASS instructions); a shared key "
        f"repeated per client gives the shared form's logW, indices and sample bit for bit")
    return row


def fixed_encode_inputs(payload, priors, size):
    """The fixed path's uplink encode of a round on the round-0 inputs: the
    clients' selection keys (10, 2) and the clipped priors and log-ratio
    coefficients in blocks, (10, d / size, size)."""
    n = payload.shape[0]
    qb = channels.to_blocks(clip01(payload), size)
    pb = channels.to_blocks(clip01(priors), size)
    a, b = log_ratio_coeffs(qb, pb)
    sels = prng.split(prng.PRNGKey(size, device="cuda"), n)
    return sels, clip01(pb).contiguous(), a.contiguous(), b.contiguous()


def cfl_encode_inputs(seed, n=10, d=28160, size=16):
    """The CFL uplink's encode: stochastic-sign posteriors of seeded deltas
    against Ber(1/2), (10, 1760, 16), and the clients' selection keys."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    delta = torch.randn(n, d, generator=gen, device="cuda")
    qb = channels.to_blocks(stochastic_sign(delta, temperature=mean_abs(delta) + 1e-12).q, size)
    pb = torch.full_like(qb, 0.5)
    a, b = log_ratio_coeffs(qb, pb)
    sels = prng.split(prng.PRNGKey(seed, device="cuda"), n)
    return sels, clip01(pb).contiguous(), a.contiguous(), b.contiguous()


def check_fixed_case(label, key, sels, pc, a, b, nis):
    """The keyed kernel through ``ops.mrc_fixed_encode`` (``key`` (2,) or
    one per client): logW bit-identical to the u-fed kernel fed prng's
    candidates of the same key(s), within the sums' bound of the plain
    version; indices equal to the plain version's but at near-ties (counted,
    each below NEAR_TIE); the sample exact where the indices agree and equal
    to the decoder's regeneration.  Returns (max |err| of logW, near-tie
    mismatches)."""
    idx, sample, logw = launched_once(ops.mrc_fixed_encode, key, sels, pc, a, b, nis)
    lead, (nb, s) = pc.shape[:-2], pc.shape[-2:]
    x = (mrc_weights.block_candidates(key, nb, nis, s) < pc[..., None, :]).to(torch.float32)
    fed = mrc_weights.mrc_logw_cuda(x.reshape(-1, nis, s), a.reshape(-1, s),
                                    b.reshape(-1, s)).reshape(lead + (nb, nis))
    del x
    if not torch.equal(logw, fed):
        raise AssertionError(f"mrc_fixed_encode {label}: keyed and u-fed logW differ "
                             f"(max |diff| {(logw - fed).abs().max().item()})")
    w_idx, w_sample, w_logw = mrc_weights.mrc_fixed_encode_ref(key, sels, pc, a, b, nis)
    mag = (a.abs().sum(-1) + b.abs().sum(-1))[..., None].expand_as(w_logw)
    err = assert_close_sums(f"mrc_fixed_encode logW {label}", logw, w_logw, mag)
    score = torch.sort(w_logw + mrc_weights.block_gumbel(sels, nb, nis), dim=-1).values
    gap = score[..., -1] - score[..., -2] if nis > 1 else torch.full_like(score[..., 0], np.inf)
    diff = idx != w_idx
    worst = float(gap[diff].max()) if bool(diff.any()) else 0.0
    if worst >= NEAR_TIE:
        raise AssertionError(f"mrc_fixed_encode {label}: index differs where the top-2 gap "
                             f"is {worst}")
    if not torch.equal(sample[~diff], w_sample[~diff]) \
            or not torch.equal(mrc.decode_fixed(key, idx, pc, n_is=nis), sample):
        raise AssertionError(f"mrc_fixed_encode {label}: sample differs from the plain "
                             "route's or from the decoder's")
    log(f"mrc_fixed_encode {label}: {tuple(pc.shape)}, n_is {nis}, key {tuple(key.shape)}: "
        f"logW bit-identical to the u-fed kernel; max|err| vs plain {err:.3e}; near-tie "
        f"index mismatches {int(diff.sum())} of {diff.numel()} (largest top-2 gap among "
        f"them {worst:.3e}, bound {NEAR_TIE}); sample exact where the indices agree")
    return err, int(diff.sum())


def time_fixed_encode(label, key, sels, pc, a, b, nis, err, ties, tf):
    """The keyed kernel against its plain version, the unfused route it
    replaced (prng draw, ``ops.mrc_logw``, Gumbel draw, logs, argmax,
    gather) and its bound: threefry's instructions for the candidate
    draws (once for the cohort under a shared key, once per client under
    client keys) and the Gumbel draws, or the bytes of p, a, b, logW, the
    indices and the sample."""
    c, nb, s = pc.shape
    kernel = lambda: ops.mrc_fixed_encode(key, sels, pc, a, b, nis)  # noqa: E731
    plain = lambda: mrc_weights.mrc_fixed_encode_ref(key, sels, pc, a, b, nis)  # noqa: E731
    unfused = lambda: mrc_weights.mrc_fixed_encode_ref(  # noqa: E731
        key, sels, pc, a, b, nis, logw_fn=ops.mrc_logw)
    work = kcost.mrc_fixed_encode(key, sels, pc, a, b, nis)
    draws, nbytes = work.draws, work.nbytes
    row = timed_row(f"mrc_fixed_encode {label}", (c, nb, nis, s), err, kernel, plain, None,
                    nbytes, draws * tf[0], tf[1], reps=20)
    row["unfused_ms"] = cuda_time_ms(unfused, reps=20)
    row["device_ms"], row["device_kernels_per_call"] = device_per_call(kernel, 20, expect=1)
    row["unfused_device_ms"], row["unfused_kernels_per_call"] = device_per_call(unfused, 5)
    row.update(key_shape=list(key.shape), near_tie_mismatches=ties, threefry_draws=draws,
               threefry_instructions=tf[0], instructions_per_s=tf[1])
    log(f"mrc_fixed_encode {label} ({c}, {nb}, {nis}, {s}), key {tuple(key.shape)}: kernel "
        f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])} in "
        f"{row['device_kernels_per_call']:.1f} kernels per call) vs unfused "
        f"{row['unfused_ms']:.4f} ms (device {row['unfused_device_ms']:.4f} ms in "
        f"{row['unfused_kernels_per_call']:.1f} kernels per call), plain "
        f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {draws} "
        f"draws x {tf[0]} SASS instructions at {tf[1]:.3e}/s; {nbytes} B); "
        f"{row['ms'] / row['bound_ms']:.2f}x its bound")
    return row


def check_fixed_encode(payload, priors, kt, tf):
    """The keyed fixed-block kernel at the main paths' calls -- GR's uplink
    (shared key, (10, 220, 128), n_is 64), PR's (the clients' private keys)
    and CFL's (shared key, (10, 1760, 16) against Ber(1/2), n_is 256) --
    and at ragged shapes; the three path shapes timed."""
    n = payload.shape[0]
    sels, pc, a, b = fixed_encode_inputs(payload, priors, 128)
    keys = mrc.client_key(kt, torch.arange(n, device="cuda"))
    rows = {}
    for label, key in (("GR, shared key", kt), ("PR uplink, client keys", keys)):
        err, ties = check_fixed_case(label, key, sels, pc, a, b, 64)
        rows[label] = time_fixed_encode(label, key, sels, pc, a, b, 64, err, ties, tf)
    csels, cpc, ca, cb = cfl_encode_inputs(40)
    err, ties = check_fixed_case("CFL, shared key", kt, csels, cpc, ca, cb, 256)
    rows["CFL"] = time_fixed_encode("CFL, shared key", kt, csels, cpc, ca, cb, 256, err, ties, tf)
    check_fixed_case("CFL, client keys", keys, csels, cpc, ca, cb, 256)
    check_fixed_case("GR-Reconst broadcast, (B, S) and a (2,) selection key", kt,
                     prng.fold_in(kt, 4), pc[0], a[0], b[0], 64)
    gen = torch.Generator(device="cuda").manual_seed(41)
    for cl, nb, s, nis in [(3, 7, 7, 33), (2, 5, 100, 48), (4, 3, 513, 20), (17, 9, 16, 40),
                           (2, 11, 1, 5)]:
        qq, pp = (torch.rand(cl, nb, s, generator=gen, device="cuda") for _ in range(2))
        aa, bb = (t.contiguous() for t in log_ratio_coeffs(qq, pp))
        ss = prng.split(prng.PRNGKey(s, device="cuda"), cl)
        for key in (kt, mrc.client_key(kt, torch.arange(cl, device="cuda"))):
            check_fixed_case(f"ragged {cl} clients", key, ss, clip01(pp).contiguous(), aa, bb,
                             nis)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main paths.
# ---------------------------------------------------------------------------


def logged(cls):
    """``cls`` with a record of every plan it returns."""
    class Logged(cls):
        def plan(self, kl, d):
            out = super().plan(kl, d)
            self.log.append(out)
            return out
    return Logged


def run_path(name):
    """One main path at full width for ``ROUNDS`` rounds, launch counts set
    to 0 just before and read just after.  Returns (launches, plans, out)."""
    cfg = dict(quickstart.CONFIG, allocation=name)
    task, spec, shards = quickstart.build("cuda", cfg)
    plans = None
    if PATHS[name] is not None:
        spec.allocation = logged(PATHS[name])(n_is=cfg["n_is"])
        spec.allocation.log = plans = []
    reset_counts()
    t0 = time.perf_counter()
    out = with_phases(lambda: FLEngine(task, spec).run(shards, rounds=ROUNDS, seed=cfg["seed"],
                                                       eval_every=1, mode="host"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"path {name}: {ROUNDS} rounds in {wall:.3f} s; launches {launches}; "
        f"accuracy {[round(h['acc'], 4) for h in out['history']]}")
    if plans is not None:
        log(f"  plans: " + "; ".join(
            f"round {t}: size {pl[0]}, {pl[1]} blocks, overhead {pl[3]}"
            for t, pl in enumerate(plans)))
    for label, key in (("round 1 (warm-up)", "first"), (f"rounds 2-{ROUNDS} mean", "steady")):
        log(f"  {label}: {phase_text(out['phase_ms'][key])}")
    return launches, plans, out


def check_path(name, launches, plans, out):
    """Launch counts, booked bits and sanity of one path's run."""
    c = quickstart.CONFIG
    n, d = c["n_clients"], int(out["theta"].shape[0])
    expect = {k: 0 for k in KERNELS}
    if name == "fixed":
        expect["mrc_fixed_encode"] = ROUNDS
        plans = [(c["block_size"], -(-d // c["block_size"]), None, 0.0)] * ROUNDS
    elif name == "adaptive":
        expect["segment_mrc_encode"] = expect["bernoulli_kl_profile"] = ROUNDS
    else:
        expect["mrc_fixed_encode"] = expect["bernoulli_kl_total"] = ROUNDS
    if d != 28160:
        raise AssertionError(f"not the full-width model: d {d}")
    if launches != drawn(launches, expect, f"path {name}"):
        raise AssertionError(f"path {name}: launches {launches}, expected {expect}")
    bits = math.log2(c["n_is"])
    cum, total = [], 0.0
    for pl in plans:
        if name == "adaptive" and (pl[0] is not None or int(pl[2][-1]) + 1 != pl[1]):
            raise AssertionError(f"adaptive plan is not a segmentation: {pl[:2]}")
        total += n * pl[1] * bits + n * (n - 1) * pl[1] * bits + pl[3] * n
        cum.append(total)
    got = [h["cum_bits"] for h in out["history"]]
    if len(plans) != ROUNDS or got != cum:
        raise AssertionError(f"path {name}: booked bits {got}, expected {cum}")
    theta = out["theta"]
    if not all(math.isfinite(h["acc"]) for h in out["history"]) \
            or not bool(torch.isfinite(theta).all()) \
            or float(theta.min()) < 0 or float(theta.max()) > 1:
        raise AssertionError(f"path {name}: non-finite accuracy or theta outside [0, 1]")
    log(f"  booked bits per round: {[round(b - a, 1) for a, b in zip([0.0] + cum, cum)]}")


def variant_allocation(kind):
    return logged(AdaptiveAllocation)(n_is=quickstart.CONFIG["n_is"]) if kind == "adaptive" \
        else logged(FixedAllocation)(quickstart.CONFIG["block_size"])


def run_variant(label, rounds=VARIANT_ROUNDS):
    """One variant path at full width, launch counts set to 0 just before
    and read just after, peak device memory from a reset just before.
    Returns (launches, plans, out, peak bytes)."""
    variant, kind, part, cohort_rng = VARIANTS[label]
    c = quickstart.CONFIG
    task, _, shards = quickstart.build("cuda")
    alloc = variant_allocation(kind)
    alloc.log = plans = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    # run_bicompfl's spec (n_dl = n * n_ul = N_DL), on the host loop.
    spec = bicompfl_spec(variant, allocation=alloc, n_is=c["n_is"], n_dl=N_DL,
                         participation=part)
    out = with_phases(lambda: FLEngine(task, spec).run(
        shards, rounds=rounds, seed=c["seed"], eval_every=1, cohort_rng=cohort_rng,
        mode="host"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"variant {label}: {rounds} rounds in {wall:.3f} s; launches {launches}; accuracy "
        f"{[round(h['acc'], 4) for h in out['history']]}; peak device memory "
        f"{peak / 2**20:.1f} MiB; rounds 2-{rounds} mean: "
        f"{phase_text(out['phase_ms']['steady'])}")
    return launches, plans, out, peak


def check_variant(label, launches, plans, out, rounds=VARIANT_ROUNDS):
    """Launches (1 uplink + N_DL downlink encodes a round), cohorts, booked
    bits against the variants' formulas, and the estimates' shape."""
    variant, kind, part, cohort_rng = VARIANTS[label]
    c = quickstart.CONFIG
    n, d = c["n_clients"], int(out["theta"].shape[0])
    n_act = max(1, int(round(part * n)))
    expect = {k: 0 for k in KERNELS}
    if kind == "adaptive":
        expect["segment_mrc_encode"] = rounds * (1 + N_DL)
        expect["bernoulli_kl_profile"] = rounds
    else:
        expect["mrc_fixed_encode"] = rounds * (1 + N_DL)
    if d != 28160 or launches != drawn(launches, expect, f"variant {label}"):
        raise AssertionError(f"variant {label}: d {d}, launches {launches}, expected {expect}")
    sched = out["active_schedule"]
    if sched.shape != (rounds, n_act) or (cohort_rng == "jax" and sched.tolist() !=
                                          JAX_COHORTS[:rounds]):
        raise AssertionError(f"variant {label}: cohorts {sched.tolist()}")
    bits, cum, total = math.log2(c["n_is"]), [], 0.0
    for pl in plans:
        nb = pl[1]
        if kind == "adaptive" and (pl[0] is not None or int(pl[2][-1]) + 1 != nb):
            raise AssertionError(f"adaptive plan is not a segmentation: {pl[:2]}")
        if kind == "fixed" and pl[:2] != (c["block_size"], -(-d // c["block_size"])):
            raise AssertionError(f"fixed plan {pl[:2]}")
        up = n_act * nb * bits + pl[3] * n
        if variant == "GR-Reconst":
            down = n * N_DL * nb * bits
        elif variant == "PR":
            down = n_act * N_DL * nb * bits
        else:  # PR-SplitDL: ceil(B / n) blocks per client, sentinel included
            down = n * N_DL * -(-nb // n) * bits
        total += up + down
        cum.append(total)
    got = [h["cum_bits"] for h in out["history"]]
    if len(plans) != rounds or got != cum:
        raise AssertionError(f"variant {label}: booked bits {got}, expected {cum}")
    theta, th = out["theta"], out["theta_hat"]
    if tuple(th.shape) != (n, d) or not all(math.isfinite(h["acc"]) for h in out["history"]) \
            or not bool(torch.isfinite(th).all() and torch.isfinite(theta).all()) \
            or float(th.min()) < 0 or float(th.max()) > 1:
        raise AssertionError(f"variant {label}: estimates not finite, not in [0, 1] or of "
                             f"shape {tuple(th.shape)}")
    if (variant == "GR-Reconst") != bool((th == th[0]).all()):
        raise AssertionError(f"variant {label}: clients' estimates equal only under "
                             "GR-Reconst's common candidates")
    log(f"  booked bits per round: {[round(b - a, 1) for a, b in zip([0.0] + cum, cum)]}; "
        f"cohorts {sched.tolist() if n_act < n else 'all'}")


def run_cfl(rounds=CFL_ROUNDS):
    """BiCompFL-GR-CFL at the example's full width through
    ``run_bicompfl_cfl``, launch counts set to 0 just before and read just
    after, peak device memory from a reset just before.  Returns
    (launches, out, peak bytes)."""
    task, theta0, shards = cfl_gradient_compression.build("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    # run_bicompfl_cfl's spec (CFLConfig's defaults), on the host loop.
    out = with_phases(lambda: FLEngine(task, cfl_spec()).run(
        shards, theta0, rounds=rounds, seed=0, eval_every=1, mode="host"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"path BiCompFL-GR-CFL: {rounds} rounds in {wall:.3f} s; launches {launches}; accuracy "
        f"{[round(h['acc'], 4) for h in out['history']]}; peak device memory "
        f"{peak / 2**20:.1f} MiB; rounds 2-{rounds} mean: "
        f"{phase_text(out['phase_ms']['steady'])}")
    return launches, out, peak


def check_cfl(launches, out, rounds=CFL_ROUNDS):
    """One ``mrc_fixed_encode`` launch a round and nothing else; the
    reference's bits and bpp; a finite model that every client tracks."""
    expect = {k: 0 for k in KERNELS}
    expect["mrc_fixed_encode"] = rounds
    theta, th = out["theta"], out["theta_hat"]
    if theta.shape != (28160,) or launches != drawn(launches, expect, "CFL"):
        raise AssertionError(f"CFL: d {tuple(theta.shape)}, launches {launches}, "
                             f"expected {expect}")
    got = [h["cum_bits"] for h in out["history"]]
    bpp = {k: f"{out['meter'][k]:.6f}" for k in CFL_REF_BPP}
    if got != CFL_REF_BITS[:rounds] or (rounds == 3 and bpp != CFL_REF_BPP):
        raise AssertionError(f"CFL: booked bits {got}, bpp {bpp}; the reference's "
                             f"{CFL_REF_BITS[:rounds]}, {CFL_REF_BPP}")
    if not bool(torch.isfinite(theta).all()) or not bool((th == theta[None]).all()) \
            or not all(math.isfinite(h["acc"]) for h in out["history"]):
        raise AssertionError("CFL: theta not finite, or the clients do not track it")
    log(f"  booked bits {got} and bpp {bpp}: the reference's")


def phase_baselines(rounds=CFL_ROUNDS):
    """The seven baselines at the example's width through ``run_baseline``,
    3 rounds each (CSER and LIEC flush after round 2): the reference's bits,
    a finite model, and no launch of a kernel but prng's draw kernel (no baseline
    reaches another).
    Returns ``{label: (launches, None, out)}``."""
    task, theta0, shards = cfl_gradient_compression.build("cuda")
    runs = {}
    for scheme in ALL_BASELINES:
        reset_counts()
        t0 = time.perf_counter()
        # run_baseline's spec, on the host loop.
        spec = baseline_spec(scheme, n=10, d=28160, reset_period=BASELINE_PERIOD)
        out = with_phases(lambda: FLEngine(task, spec).run(
            shards, theta0, rounds=rounds, seed=0, eval_every=1, mode="host"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        got = [h["cum_bits"] for h in out["history"]]
        if launches != drawn(launches, {k: 0 for k in KERNELS}, f"baseline {scheme}"):
            raise AssertionError(f"baseline {scheme}: kernel launches {launches}")
        if got != BASELINE_REF_BITS[scheme][:rounds]:
            raise AssertionError(f"baseline {scheme}: booked bits {got}, the reference's "
                                 f"{BASELINE_REF_BITS[scheme][:rounds]}")
        if not bool(torch.isfinite(out["theta"]).all() and torch.isfinite(out["theta_hat"]).all()) \
                or out["theta_hat"].shape != (10, 28160):
            raise AssertionError(f"baseline {scheme}: model not finite or of the wrong shape")
        log(f"baseline {scheme}: {rounds} rounds in {wall:.3f} s; bits {got} (the reference's); "
            f"bpp {out['meter']['bpp']:.6f}; accuracy "
            f"{[round(h['acc'], 4) for h in out['history']]}; no kernel launched but "
            f"{launches[DRAWS]} prng draws")
        runs[f"baseline {scheme}"] = (launches, None, out)
    return runs


# ---------------------------------------------------------------------------
# Phase 5: card vs CPU on the same inputs.
# ---------------------------------------------------------------------------


def phase_codec_vs_cpu(payload, priors, kt):
    """KL statistics, plans and both MRC codecs: card (kernels) vs the CPU
    routes (plain versions) on the same inputs."""
    cq, cp, ckt = payload.cpu(), priors.cpu(), kt.cpu()
    n, d = payload.shape
    cpu = _kl_stats(cq, cp, needs_profile=True)["profile"]                # (d,)
    card = _kl_stats(payload, priors, needs_profile=True)["profile"]
    card_mean = _kl_stats(payload, priors, needs_profile=False)["total"] / d  # mean KL, 0-d
    sc = kl_scale(cq, clip01(cp))
    err = assert_close_sums("KL profile card vs cpu", card.cpu(), cpu, sc.sum(0) / n)
    err_t = assert_close_sums("KL total card vs cpu", card_mean.cpu() * d, cpu.sum(),
                              sc.sum() / n)
    log(f"KL statistics card vs cpu: profile max|err| {err:.3e}, mean "
        f"{float(card_mean):.8f} vs {float(cpu.sum() / d):.8f} (|err| {err_t:.3e})")
    alloc, avg = AdaptiveAllocation(n_is=64), AdaptiveAvgAllocation(n_is=64)
    plan_card = alloc.plan(card.cpu().numpy(), d)
    plan_cpu = alloc.plan(cpu.numpy(), d)
    avg_card = avg.plan(card_mean.cpu().numpy(), d)
    avg_cpu = avg.plan(cpu.numpy(), d)
    if plan_card[1:2] + plan_card[3:] != plan_cpu[1:2] + plan_cpu[3:] \
            or not np.array_equal(plan_card[2], plan_cpu[2]) or avg_card != avg_cpu:
        raise AssertionError(f"plans differ card vs cpu: {plan_card[1]} vs {plan_cpu[1]} "
                             f"segments, avg {avg_card} vs {avg_cpu}")
    log(f"plans card vs cpu: equal (Adaptive {plan_card[1]} segments, "
        f"Adaptive-Avg size {avg_card[0]})")

    seg, n_seg = plan_cpu[2], plan_cpu[1]
    sels = prng.split(prng.PRNGKey(12, device="cpu"), n)
    q = clip01(cq)
    cres = mrc.encode_segments(ckt, sels, q, clip01(cp), seg, n_is=64, n_seg=n_seg)
    gres = mrc.encode_segments(kt, sels.cuda(), q.cuda(), clip01(priors), seg, n_is=64,
                               n_seg=n_seg)
    same = gres.indices.cpu() == cres.indices
    rate = float(same.to(torch.float32).mean())
    log(f"segment codec card vs cpu: index match {rate:.5f} over {same.numel()} segments")
    if rate < MIN_INDEX_MATCH:
        raise AssertionError(f"card/cpu segment index match {rate} < {MIN_INDEX_MATCH}")
    keep = same[torch.arange(n)[:, None], torch.as_tensor(seg, dtype=torch.int64)[None]]
    if not torch.equal(gres.sample.cpu()[keep], cres.sample[keep]):
        raise AssertionError("same segment index, different decoded sample")
    dec = mrc.decode_segments(kt, gres.indices, clip01(priors), seg, n_is=64)
    if not torch.equal(dec, gres.sample):
        raise AssertionError("decode_segments(encode_segments) is not the sample")

    nb, s = 220, quickstart.CONFIG["block_size"]
    g = torch.Generator().manual_seed(7)
    fq = 0.05 + 0.9 * torch.rand(n, nb, s, generator=g)
    fp = torch.clamp(fq + 0.05 * torch.randn(n, nb, s, generator=g), 0.05, 0.95)
    key = prng.PRNGKey(11, device="cpu")
    cpu_f = mrc.encode_fixed(key, sels, fq, fp, n_is=64)
    gpu_f = mrc.encode_fixed(key.cuda(), sels.cuda(), fq.cuda(), fp.cuda(), n_is=64)
    same = gpu_f.indices.cpu() == cpu_f.indices
    rate = float(same.to(torch.float32).mean())
    log(f"fixed codec card vs cpu: index match {rate:.5f} over {same.numel()} blocks")
    if rate < MIN_INDEX_MATCH:
        raise AssertionError(f"card/cpu index match {rate} < {MIN_INDEX_MATCH}")
    if not torch.equal(gpu_f.sample.cpu()[same], cpu_f.sample[same]):
        raise AssertionError("same index, different decoded sample")


def phase_variants_vs_cpu(payload, priors, kt, seg, n_seg):
    """One round of each variant channel's MRC indices, card vs CPU, on the
    round-0 inputs: the PR uplinks (private keys) and the PR downlink on a
    cohort of 3 (so that the CPU's int64 threefry stays within seconds),
    the GR uplink and the GR-Reconst and PR-SplitDL downlinks over all 10
    clients; one conveyed sample each.  An index may flip only where the card's and the
    CPU's sums round differently (MIN_INDEX_MATCH, as above)."""
    n, d = payload.shape
    active = np.linspace(0, n - 1, 3).astype(np.int64)     # [0, 4, 9] of 10
    fixed = BlockPlan(size=128, n_blocks=-(-d // 128), seg_ids=None, overhead_bits=0.0)
    segs = BlockPlan(size=None, n_blocks=n_seg, seg_ids=seg, overhead_bits=0.0)
    target = mrc.sample_mean(payload)
    cases = [("GR uplink, fixed", channels.MRCFixedChannel(n_is=64, shared=True), fixed, False),
             ("PR uplink, fixed", channels.MRCFixedChannel(n_is=64, shared=False), fixed, True),
             ("PR uplink, adaptive", channels.MRCAdaptiveChannel(n_is=64, shared=False), segs,
              True),
             ("PR downlink, fixed", channels.MRCPrivateDownlink(n_is=64), fixed, True),
             ("PR downlink, adaptive", channels.MRCPrivateDownlink(n_is=64), segs, True),
             ("GR-Reconst downlink, fixed", channels.MRCBroadcastDownlink(n_is=64), fixed, False),
             ("GR-Reconst downlink, adaptive", channels.MRCBroadcastDownlink(n_is=64), segs,
              False),
             ("PR-SplitDL downlink", channels.SplitBlockDownlink(n_is=64), fixed, False)]
    for label, chan, plan, partial in cases:
        idx = []
        for dev in ("cuda", "cpu"):
            ids = active if partial else np.arange(n)
            ctx = channels.RoundContext(t=0, key=kt.to(dev), n_clients=n, d=d, active=ids,
                                        plan=plan)
            if isinstance(chan, channels.StatelessUplink):
                rows = torch.as_tensor(ids, device="cuda")
                out = chan._transmit(ctx, payload[rows].to(dev), priors[rows].to(dev))
            else:
                out = chan._transmit(ctx, channels.ServerUpdate(theta=target.to(dev)),
                                     priors.to(dev))
            idx.append(out[0].cpu())
        same = idx[0] == idx[1]
        rate = float(same.to(torch.float32).mean())
        log(f"{label}: card vs cpu index match {rate:.5f} over {same.numel()} "
            f"{'segments' if plan.adaptive else 'blocks'}")
        if idx[0].shape != idx[1].shape or rate < MIN_INDEX_MATCH:
            raise AssertionError(f"{label}: card/cpu index match {rate} < {MIN_INDEX_MATCH}")


class RecordingCFLUplink(channels.QuantizedMRCUplink):
    """The CFL uplink, keeping each round's indices, temperatures and deltas."""

    def step_up(self, ctx, state, payload, priors):
        idxs, ks, g_hat, bits = self._transmit(ctx, payload, priors)
        self.log.append((idxs.cpu(), ks.cpu(), payload.cpu()))
        return g_hat, bits, state


def phase_cfl_vs_cpu():
    """One BiCompFL-GR-CFL round at full width from the same state (the
    card's task, theta0 and shards carried to the CPU value for value), on
    the card and on the CPU: indices equal but for Gumbel near-ties
    (MIN_INDEX_MATCH, as the variant checks count them), equal bits.
    Returns the card's round-0 deltas."""
    task, theta0, shards = cfl_gradient_compression.build("cuda")
    ctask, ctheta0 = convert.cfl_task(
        theta0.cpu(), task.x_test.cpu(), task.y_test.cpu(), dims=task.net.dims, device="cpu",
        local_epochs=task.local_epochs, batch_size=task.batch_size, local_lr=task.local_lr)
    runs = {}
    for dev, (tk, th, sh) in (("cuda", (task, theta0, shards)),
                              ("cpu", (ctask, ctheta0, Dataset(shards.x.cpu(),
                                                               shards.y.cpu())))):
        spec = cfl_spec()
        spec.uplink = RecordingCFLUplink(n_is=spec.uplink.n_is)
        spec.uplink.log = []
        out = FLEngine(tk, spec).run(sh, th, rounds=1, seed=0, mode="host")
        runs[dev] = (spec.uplink.log[0], out)
    (gi, gk, gp), gout = runs["cuda"]
    (ci, ck, cp), cout = runs["cpu"]
    same = gi == ci
    rate = float(same.to(torch.float32).mean())
    dk = float(((gk - ck).abs() / ck).max())
    dp = float((gp - cp).abs().max())
    dth = float((gout["theta"].cpu() - cout["theta"]).abs().max())
    log(f"CFL round card vs cpu: index match {rate:.5f} over {same.numel()} blocks; deltas "
        f"max|diff| {dp:.3e}; K max relative diff {dk:.3e}; theta max|diff| {dth:.3e}; "
        f"bits {gout['meter']['total_bits']:.0f} vs {cout['meter']['total_bits']:.0f}")
    if gi.shape != ci.shape or rate < MIN_INDEX_MATCH or gout["meter"] != cout["meter"]:
        raise AssertionError(f"CFL card vs cpu: index match {rate} < {MIN_INDEX_MATCH} or "
                             f"meters differ: {gout['meter']} vs {cout['meter']}")
    return gp.cuda()


def phase_ef_vs_cpu(deltas):
    """One doublesqueeze round on the same inputs (the card's CFL deltas of
    round 0 as the payload, zero EF memories), card vs CPU: uplink, the
    mean-delta aggregate, downlink.  Outputs, the EF states and the models
    agree within EF_RTOL of the scale, signs outside SIGN_MARGIN."""
    n, d = deltas.shape
    theta = prng.normal(prng.PRNGKey(21, device="cuda"), (d,)) * 0.1
    res = {}
    for dev in ("cuda", "cpu"):
        ctx = channels.RoundContext(t=0, key=prng.PRNGKey(0, device=dev), n_clients=n, d=d,
                                    active=np.arange(n))
        up, dn = channels.SignEFChannel(), channels.SignEFChannel()
        th = theta.to(dev)
        c, bits_up, e_up = up.step_up(ctx, up.init_up_state(n, d, dev), deltas.to(dev), None)
        update = MeanDeltaAggregator(1.0)(ctx, th, c)
        out, e_dn = dn.step_down(ctx, dn.init_down_state(n, d, dev), update, th,
                                 th[None].repeat(n, 1))
        res[dev] = {"uplink output": c, "uplink state": e_up, "downlink state": e_dn,
                    "theta": out.theta, "theta_hat": out.theta_hat,
                    "bits": (bits_up, out.bits)}
    worst = {}
    for key in ("uplink output", "uplink state", "downlink state", "theta", "theta_hat"):
        got, want = res["cuda"][key].cpu(), res["cpu"][key]
        scale = float(res["cpu"]["uplink output"].abs().max())
        err = float((got - want).abs().max())
        worst[key] = err / scale
        if err > EF_RTOL * scale:
            raise AssertionError(f"doublesqueeze card vs cpu: {key} max|diff| {err} beyond "
                                 f"{EF_RTOL} x scale {scale}")
    c_card, c_cpu = res["cuda"]["uplink output"].cpu(), res["cpu"]["uplink output"]
    sure = c_cpu.abs() > SIGN_MARGIN * c_cpu.abs().amax(-1, keepdim=True)
    if not torch.equal(torch.sign(c_card)[sure], torch.sign(c_cpu)[sure]) \
            or res["cuda"]["bits"] != res["cpu"]["bits"]:
        raise AssertionError("doublesqueeze card vs cpu: signs or bits differ")
    log("doublesqueeze round card vs cpu: max|diff| / scale " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()) + f"; bits {res['cuda']['bits']} equal")


# ---------------------------------------------------------------------------
# Phase 6: profile.
# ---------------------------------------------------------------------------


def phase_profile(name, rounds: int, unfused: bool = False):
    """Device time by kernel over ``rounds`` rounds of one path, and the
    device's idle share of an unprofiled steady round (the mean of rounds
    2-ROUNDS of an unprofiled run; the profiler slows the host many-fold).
    ``unfused``: the encoders take the routes the fused ones replaced (the
    adaptive uplink ``seg_logw_fn=ops.segment_logw``, the fixed-block codec
    under ``unfused_fixed_route``), for the before/after.  A name of
    ``VARIANTS`` profiles that variant path (n_dl = 10); the peak device
    memory is that of the unprofiled run."""
    run_kw = {"mode": "host"}
    if name in VARIANTS:
        variant, kind, part, cohort_rng = VARIANTS[name]
        task, _, shards = quickstart.build("cuda")
        alloc = quickstart.make_allocation(dict(quickstart.CONFIG, allocation=kind))
        spec = bicompfl_spec(variant, allocation=alloc, n_is=quickstart.CONFIG["n_is"],
                             n_dl=N_DL, participation=part)
        run_kw["cohort_rng"] = cohort_rng
    else:
        task, spec, shards = quickstart.build("cuda", dict(quickstart.CONFIG, allocation=name))
    if not unfused:
        return profile_engine(name, FLEngine(task, spec), shards, rounds, run_kw)
    if isinstance(spec.uplink, channels.MRCAdaptiveChannel):
        spec.uplink.seg_logw_fn = ops.segment_logw_fn()
    with unfused_fixed_route():
        return profile_engine(f"{name} (unfused route)", FLEngine(task, spec), shards, rounds,
                              run_kw)


def profile_cfl(rounds: int, unfused: bool = False):
    """``phase_profile`` of the BiCompFL-GR-CFL path (rounds 2-3 steady);
    ``unfused``: the uplink's encode under ``unfused_fixed_route``."""
    task, theta0, shards = cfl_gradient_compression.build("cuda")
    with unfused_fixed_route() if unfused else contextlib.nullcontext():
        return profile_engine("BiCompFL-GR-CFL" + (" (unfused route)" if unfused else ""),
                              FLEngine(task, cfl_spec()), shards, rounds,
                              {"theta0": theta0, "mode": "host"}, steady_rounds=CFL_ROUNDS)


@contextlib.contextmanager
def unfused_fixed_route():
    """The fixed-block codec's encoder (``ops.mrc_fixed_encode``, which
    ``core.mrc.encode_fixed`` calls) pointed at the route the fused kernel
    replaced: prng's candidates weighed by the u-fed ``ops.mrc_logw``, then
    the Gumbel draw, argmax and gather.  The before of the profiles'
    before/after; the launch counts are not read inside."""
    fused = ops.mrc_fixed_encode
    ops.mrc_fixed_encode = lambda *args: mrc_weights.mrc_fixed_encode_ref(  # noqa: E731
        *args, logw_fn=ops.mrc_logw)
    try:
        yield
    finally:
        ops.mrc_fixed_encode = fused


def profile_engine(name, engine, shards, rounds: int, run_kw, steady_rounds=ROUNDS):
    """The body of ``phase_profile``: a warm-up round, an unprofiled run of
    ``steady_rounds`` (its rounds 2.. give the steady round and the peak
    memory), then ``rounds`` profiled rounds."""
    engine.run(shards, rounds=1, **run_kw)  # warm-up outside the window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ph = with_phases(lambda: engine.run(shards, rounds=steady_rounds, **run_kw))["phase_ms"]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steady_ms = ph["steady"]["round"]
    busy_ms, kernels = device_profile(lambda: engine.run(shards, rounds=rounds, **run_kw),
                                      rounds)
    if busy_ms == 0:
        log(f"profile {name}: the profiler saw no device time (device busy: not measured)")
        return None
    per_round = sum(e.count for e in kernels) // rounds
    log(f"profile {name}: device busy {busy_ms:.3f} ms per round in {per_round} kernels; "
        f"steady round {steady_ms:.3f} ms unprofiled -> device idle share "
        f"{1 - busy_ms / steady_ms:.4f}; peak device memory {peak / 2**20:.1f} MiB")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < 10 or any(k in e.key for k in OWN_KERNELS):
            log(f"  {e.self_device_time_total / rounds / 1e3:8.3f} ms/round  "
                f"x{e.count // rounds:<5d} {e.key[:100]}")
    return {"device_busy_ms": busy_ms, "kernels_per_round": per_round,
            "steady_round_ms": steady_ms, "idle_share": 1 - busy_ms / steady_ms,
            "peak_memory_mib": peak / 2**20}


# ---------------------------------------------------------------------------
# Phase 11: the fused path (a round as CUDA graphs, replayed).
# ---------------------------------------------------------------------------


def fused_kind(label):
    """The allocation of a FUSED_PATHS label: fixed, adaptive or adaptive-avg."""
    if label in PATHS:
        return label
    return VARIANTS[label][1] if label in VARIANTS else "fixed"


def fused_spec(label):
    """A fresh spec of one fused path, as phase 4 builds it."""
    c = quickstart.CONFIG
    if label in PATHS:
        return bicompfl_spec("GR", allocation=quickstart.make_allocation(
            dict(c, allocation=label)), n_is=c["n_is"])
    if label in VARIANTS:
        variant, kind, part, _ = VARIANTS[label]
        return bicompfl_spec(variant, allocation=quickstart.make_allocation(
            dict(c, allocation=kind)), n_is=c["n_is"], n_dl=N_DL, participation=part)
    if label == "cfl":
        return cfl_spec()
    return baseline_spec(label.split()[1], n=10, d=28160, reset_period=BASELINE_PERIOD)


def fused_setup(label):
    """(task, spec, shards, run keywords, rounds) of one fused path on the
    card, as the host loop's phases build it (``label`` a key of FUSED_PATHS)."""
    c = quickstart.CONFIG
    if label in PATHS or label in VARIANTS:
        task, _, shards = quickstart.build("cuda")
        run_kw = {"seed": c["seed"], "eval_every": 1}
        if label in VARIANTS:
            return task, fused_spec(label), shards, dict(
                run_kw, cohort_rng=VARIANTS[label][3]), VARIANT_ROUNDS
        return task, fused_spec(label), shards, run_kw, ROUNDS
    task, theta0, shards = cfl_gradient_compression.build("cuda")
    return task, fused_spec(label), shards, {"theta0": theta0, "seed": 0, "eval_every": 1}, \
        CFL_ROUNDS


def entry_point_run(label, task, shards, run_kw, rounds):
    """The path through the entry point a user calls, in its default mode:
    the quickstart's ``run``, ``run_bicompfl``, ``run_bicompfl_cfl``,
    ``run_baseline``, or ``run_spec`` (the one that takes ``cohort_rng``)."""
    if label in PATHS:
        return quickstart.run("cuda", rounds=rounds, eval_every=1,
                              cfg={"allocation": label})
    if label == "cfl":
        return run_bicompfl_cfl(task, run_kw["theta0"], shards,
                                CFLConfig(rounds=rounds, seed=run_kw["seed"]))
    if label.startswith("baseline "):
        return run_baseline(task, run_kw["theta0"], shards, BaselineConfig(
            scheme=label.split()[1], rounds=rounds, seed=run_kw["seed"],
            reset_period=BASELINE_PERIOD))
    variant, kind, part, cohort_rng = VARIANTS[label]
    if cohort_rng == "jax":
        return run_spec(task, fused_spec(label), shards, rounds=rounds, **run_kw)
    c = quickstart.CONFIG
    return run_bicompfl(task, shards, BiCompFLConfig(
        variant=variant, allocation=quickstart.make_allocation(dict(c, allocation=kind)),
        n_is=c["n_is"], n_dl=N_DL, rounds=rounds, seed=run_kw["seed"], eval_every=1,
        participation=part))


def own_launches(events, rounds):
    """Device launches per round of the port's own kernels, by kernel name."""
    return {e.key: e.count / rounds for e in events if any(k in e.key for k in OWN_KERNELS)}


def with_phases(run):
    """``run()``, an FL run, inside ``spans.recording()`` on an empty span
    buffer; its result gets ``phase_ms``: the device ms of each phase of a
    round (``round``, ``train``, ``codec``, ``eval``; the spans ``fl.*``,
    CUDA events) in round 1 (``first``) and averaged over rounds 2..
    (``steady``), rounds without an eval counting 0 for it."""
    spans.clear()
    with spans.recording():
        out = run()
    recs = spans.records()
    rounds = [r for r in recs if r.name == "fl.round"]
    at = {r.index: i for i, r in enumerate(rounds)}
    per = [{"round": r.device_ms, "train": 0.0, "codec": 0.0, "eval": 0.0} for r in rounds]
    for r in recs:
        if r.parent in at and r.name in ("fl.train", "fl.codec", "fl.eval"):
            per[at[r.parent]][r.name[3:]] += r.device_ms
    steady = per[1:]
    out["phase_ms"] = {"first": per[0], "steady": {
        k: sum(p[k] for p in steady) / len(steady) for k in per[0]}}
    return out


def phase_text(ms):
    return ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()) + " (device time, CUDA events)"


def same_run(host, fused):
    """Bit for bit: theta, theta_hat, bits and history."""
    return (torch.equal(host["theta"], fused["theta"])
            and torch.equal(host["theta_hat"], fused["theta_hat"])
            and host["meter"] == fused["meter"] and host["history"] == fused["history"])


def cpu_copy(task, shards):
    """The card's mask task and shards carried to the CPU value for value."""
    ctask = convert.mask_task(task.w0_flat.cpu(), task.x_test.cpu(), task.y_test.cpu(),
                              dims=task.net.dims, device="cpu",
                              local_epochs=task.local_epochs, lr=task.lr,
                              batch_size=task.batch_size)
    return ctask, Dataset(shards.x.cpu(), shards.y.cpu())


def phase_fused(label, host_out, host_launches):
    """One path on the fused path at full width: a fresh engine's first run
    (captures; launch counts set to 0 just before and read just after,
    peak device memory from a reset just before), checked against the card's
    host run of the same path (static plans: bit for bit) or the CPU's fused
    run on the same inputs (adaptive plans: the same buckets and bits); a
    second, unprofiled run of the same signature (captures nothing, one
    replay per graph a round; its wall time over the rounds is the steady
    round); a profiled run (device time, kernels per round, the port's
    kernels' launches per replayed round against the host loop's)."""
    task, spec, shards, run_kw, rounds = fused_setup(label)
    kind = fused_kind(label)
    adaptive = kind != "fixed"
    engine = FLEngine(task, spec)
    gc.collect()                  # earlier paths' graphs and pools go first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what the run finds allocated
    reset_counts()
    t0 = time.perf_counter()
    out = engine.run(shards, rounds=rounds, mode="fused", **run_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    captured = engine.fused_capture_count
    n_eval = len(out["history"])
    flushes = rounds // spec.sync_period if spec.sync_period else 0
    # stats, eval and one graph a bucket; or train, codec, eval and the flush
    graphs = (2 + len(set(out["buckets"]))) if adaptive else 3 + bool(flushes)
    if out["mode"] != "fused" or captured != graphs:
        raise AssertionError(f"fused {label}: mode {out['mode']}, {captured} graphs "
                             f"captured, expected {graphs}")
    # The wrappers count where Python runs: the warm-up and the capture of
    # each graph that holds the kernel, never a replay.
    per_round = {k: v // rounds for k, v in host_launches.items()}
    expect = {k: 2 * v for k, v in per_round.items()}
    if adaptive:
        enc = "segment_mrc_encode" if kind == "adaptive" else "mrc_fixed_encode"
        expect[enc] = 2 * len(set(out["buckets"])) * per_round[enc]
    if launches != drawn(launches, expect, f"fused {label}"):
        raise AssertionError(f"fused {label}: launches {launches} at capture, expected {expect}")
    if adaptive:
        ctask, cshards = cpu_copy(task, shards)
        cpu = FLEngine(ctask, fused_spec(label)).run(cshards, rounds=rounds, mode="fused",
                                                     **run_kw)
        bits = [h["cum_bits"] for h in out["history"]]
        if out["buckets"] != cpu["buckets"] or bits != [h["cum_bits"] for h in cpu["history"]] \
                or out["meter"] != cpu["meter"]:
            raise AssertionError(f"fused {label}: buckets {out['buckets']}, bits {bits} on the "
                                 f"card; {cpu['buckets']}, "
                                 f"{[h['cum_bits'] for h in cpu['history']]} on the CPU")
        agree = (f"buckets {out['buckets']} and bits {bits} equal to the CPU fused run's "
                 f"(the host loop's exact plans booked {host_out['meter']['total_bits']:.0f})")
    else:
        if not same_run(host_out, out):
            dth = float((host_out["theta"] - out["theta"]).abs().max())
            raise AssertionError(f"fused {label} differs from the host loop: theta max|diff| "
                                 f"{dth:.3e}; meter {out['meter']} vs {host_out['meter']}")
        agree = "theta, theta_hat, bits and history bit-identical to the host loop's"
    if not all(math.isfinite(h["acc"]) for h in out["history"]) \
            or not bool(torch.isfinite(out["theta"]).all()):
        raise AssertionError(f"fused {label}: non-finite accuracy or theta")
    replays = engine.fused_replay_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = engine.run(shards, rounds=rounds, mode="fused", **run_kw)
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t0) / rounds
    replayed = engine.fused_replay_count - replays
    want = 2 * rounds + (0 if adaptive else flushes) + n_eval
    if engine.fused_capture_count != captured or replayed != want:
        raise AssertionError(f"fused {label}: a second run captured "
                             f"{engine.fused_capture_count - captured} graphs and replayed "
                             f"{replayed}, expected 0 and {want}")
    if not same_run(out, again):
        raise AssertionError(f"fused {label}: a replayed run differs from the first")
    busy_ms, events = device_profile(
        lambda: engine.run(shards, rounds=rounds, mode="fused", **run_kw), rounds)
    kernels = sum(e.count for e in events) / rounds
    fused_own = own_launches(events, rounds)
    _, host_events = device_profile(
        lambda: FLEngine(task, spec).run(shards, rounds=1, mode="host", **run_kw), 1)
    host_own = own_launches(host_events, 1)
    # prng's draw kernel is not among OWN_KERNELS: its launches a round
    # differ between the paths by the run's own draws
    if fused_own != host_own or (any(v for k, v in per_round.items() if k != DRAWS)
                                 and not fused_own):
        raise AssertionError(f"fused {label}: the port's kernels launch {fused_own} per "
                             f"replayed round, the host loop {host_own}")
    entry = entry_point_run(label, task, shards, run_kw, rounds)
    if entry["mode"] != "fused" or not same_run(out, entry):
        raise AssertionError(f"fused {label}: the entry point ran {entry['mode']}, or not "
                             "the fused run's result")
    host_ms = host_out["phase_ms"]["steady"]["round"]
    idle = 1 - busy_ms / steady_ms if busy_ms else float("nan")
    log(f"fused {label}: {rounds} rounds, first run {first_s:.3f} s ({captured} graphs "
        f"captured), {agree}; its entry point in its default mode ran the fused path to the "
        f"same result; steady round {steady_ms:.3f} ms fused (wall of a replayed run "
        f"/ rounds) vs {host_ms:.3f} ms host loop (rounds 2-{rounds}); device busy "
        f"{busy_ms:.3f} ms per round in {kernels:.1f} kernels, idle share {idle:.4f}; peak "
        f"device memory {peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB above the "
        f"{held / 2**20:.1f} MiB held before the run; the port's kernels per replayed round "
        f"{fused_own} (host loop {host_own}); launches at capture {launches}")
    return {"graphs": captured, "steady_round_ms": steady_ms, "host_round_ms": host_ms,
            "device_busy_ms": busy_ms, "kernels_per_round": kernels, "idle_share": idle,
            "peak_memory_mib": peak / 2**20, "held_before_mib": held / 2**20,
            "launches_per_round": fused_own,
            "capture_launches": launches}


# ---------------------------------------------------------------------------
# Phase 12: wire audit, faults and kill-and-resume.
# ---------------------------------------------------------------------------




def phase_wire(label):
    """One path's 3-round ``wire="audit"`` host run against the same call's
    unaudited host run on the card: bit for bit, the reconcile exact, the
    encoders launched as often."""
    task, _, shards, run_kw, _ = fused_setup(label)
    rounds = WIRE_ROUNDS
    reset_counts()
    plain = with_phases(lambda: FLEngine(task, fused_spec(label)).run(
        shards, rounds=rounds, mode="host", **run_kw))
    torch.cuda.synchronize()
    plain_launches = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    out = with_phases(lambda: FLEngine(task, fused_spec(label)).run(
        shards, rounds=rounds, mode="host", wire="audit", **run_kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rep = out["wire"]
    if rep["uplink_err_bits"] or rep["downlink_err_bits"] or not rep["messages"]:
        raise AssertionError(f"wire {label}: the audit does not reconcile exactly: {rep}")
    if not same_run(plain, out):
        raise AssertionError(f"wire {label}: the audited run differs from the unaudited one")
    for k in ("mrc_fixed_encode", "segment_mrc_encode", "mrc_logw", "segment_logw"):
        if launches[k] != plain_launches[k]:
            raise AssertionError(f"wire {label}: {k} launched {launches[k]} times audited, "
                                 f"{plain_launches[k]} unaudited")
    session = out["wire_session"]
    by_round = [sum(m.frame_bits for m in session.messages if m.round == t) / 8
                for t in range(rounds)]
    # Where the audit's time goes: each phase's device ms (rounds 2..), and a
    # profiled one-round run's device time and kernels, audited and not.
    split = {name: o["phase_ms"]["steady"] for name, o in (("audited", out),
                                                           ("unaudited", plain))}
    device = {}
    for name, kw in (("audited", {"wire": "audit"}), ("unaudited", {})):
        busy, events = device_profile(lambda kw=kw: FLEngine(task, fused_spec(label)).run(
            shards, rounds=1, mode="host", **kw, **run_kw))
        device[name] = {"busy_ms": busy, "kernels": sum(e.count for e in events)}
    row = {"stream_bytes_per_round": by_round, "payload_bits": rep["uplink_stream_bits"]
           + rep["downlink_stream_bits"], "framing_bits": session.framing_bits,
           "messages": len(session.messages), "audited_round_ms": split["audited"]["round"],
           "unaudited_round_ms": split["unaudited"]["round"], "phase_ms": split,
           "device_one_round": device, "wall_s": wall, "launches": launches}
    log(f"wire {label}: {rounds} audited rounds in {wall:.3f} s, reconciled with 0 bits of "
        f"slack and bit-identical to the unaudited host run; {len(session.messages)} frames, "
        f"stream bytes per round {by_round}, payload {row['payload_bits']:.0f} bits, framing "
        f"{session.framing_bits} bits; round {row['audited_round_ms']:.3f} ms audited vs "
        f"{row['unaudited_round_ms']:.3f} ms unaudited (device time, rounds 2-{rounds}; "
        f"phases {split}); one profiled round: device busy {device['audited']['busy_ms']:.3f} "
        f"ms in {device['audited']['kernels']} kernels audited, "
        f"{device['unaudited']['busy_ms']:.3f} ms in {device['unaudited']['kernels']} "
        f"unaudited; launches {launches}")
    return row


def fault_setup(kind):
    """(task, shards, run keywords) of a fault_matrix family at full width."""
    if kind == "mask":
        task, _, shards = quickstart.build("cuda")
        return task, shards, {"seed": quickstart.CONFIG["seed"], "eval_every": 1}
    task, theta0, shards = cfl_gradient_compression.build("cuda")
    return task, shards, {"theta0": theta0, "seed": 0, "eval_every": 1}


def encoder_launches(engine, shards, run_kw):
    """``mrc_fixed_encode``'s device launches per round of a replayed fused
    run (the profiler's kernel names)."""
    _, events = device_profile(
        lambda: engine.run(shards, rounds=FAULT_ROUNDS, mode="fused", **run_kw), FAULT_ROUNDS)
    return sum(e.count for e in events if "mrc_encode_kernel" in e.key) / FAULT_ROUNDS


def phase_faults(name, kind, factory):
    """One fault_matrix family under FAULT_PLAN: host loop and fused path
    identical, the plan biting, the retransmits booked; PR also its faulted
    wire audit and its encoder's launches per faulted fused round."""
    task, shards, run_kw = fault_setup(kind)
    host = with_phases(lambda: FLEngine(task, factory()).run(
        shards, rounds=FAULT_ROUNDS, mode="host", faults=FAULT_PLAN, **run_kw))
    engine = FLEngine(task, factory())
    fused = engine.run(shards, rounds=FAULT_ROUNDS, mode="fused", faults=FAULT_PLAN, **run_kw)
    rep = host["faults"]
    if rep["summary"]["faulty_rounds"] == 0:
        raise AssertionError(f"faults {name}: the plan drew no fault")
    if not same_run(host, fused) or fused["faults"] != rep:
        raise AssertionError(f"faults {name}: the fused run differs from the host loop's")
    if host["meter"]["retransmit_bits"] != rep["summary"]["retransmit_bits_total"]:
        raise AssertionError(f"faults {name}: booked {host['meter']['retransmit_bits']} "
                             f"retransmit bits, the report {rep['summary']}")
    if not all(math.isfinite(h["acc"]) for h in fused["history"]):
        raise AssertionError(f"faults {name}: non-finite accuracy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(shards, rounds=FAULT_ROUNDS, mode="fused", faults=FAULT_PLAN, **run_kw)
    torch.cuda.synchronize()
    faulted_ms = 1e3 * (time.perf_counter() - t0) / FAULT_ROUNDS
    clean_engine = FLEngine(task, factory())
    clean_engine.run(shards, rounds=FAULT_ROUNDS, mode="fused", **run_kw)     # captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean_engine.run(shards, rounds=FAULT_ROUNDS, mode="fused", **run_kw)
    torch.cuda.synchronize()
    clean_ms = 1e3 * (time.perf_counter() - t0) / FAULT_ROUNDS
    row = {"summary": rep["summary"], "faulted_fused_round_ms": faulted_ms,
           "clean_fused_round_ms": clean_ms, "host_round_ms": host["phase_ms"]["steady"]["round"]}
    extra = ""
    if name == "bicompfl-pr":
        faulted_enc = encoder_launches(engine, shards, dict(run_kw, faults=FAULT_PLAN))
        clean_enc = encoder_launches(clean_engine, shards, run_kw)
        if faulted_enc != clean_enc or clean_enc != 1 + N_DL:
            raise AssertionError(f"faults {name}: mrc_fixed_encode launches {faulted_enc} a "
                                 f"faulted fused round, {clean_enc} a clean one, expected "
                                 f"{1 + N_DL}")
        wired = FLEngine(task, factory()).run(shards, rounds=FAULT_ROUNDS, mode="host",
                                              wire="audit", faults=FAULT_PLAN, **run_kw)
        wrep = wired["wire"]
        # The audit books its bits from the frames on the stream, the host
        # loop from per-client shares of the nominal totals: the models are
        # the same, the retransmits the same copies.
        if wrep["uplink_err_bits"] or wrep["downlink_err_bits"] \
                or wrep["retransmit_err_bits"] or not wrep["retransmit_stream_bits"] \
                or not torch.equal(host["theta"], wired["theta"]) \
                or not torch.equal(host["theta_hat"], wired["theta_hat"]) \
                or not math.isclose(wired["meter"]["retransmit_bits"],
                                    host["meter"]["retransmit_bits"], rel_tol=1e-9):
            raise AssertionError(f"faults {name}: the faulted wire audit: {wrep}")
        row.update(encoder_launches_per_round=faulted_enc,
                   wasted_copies=len(wired["wire_session"].wasted))
        extra = (f"; mrc_fixed_encode {faulted_enc:.0f} launches a faulted fused round (clean "
                 f"{clean_enc:.0f}); the faulted wire audit reconciled with "
                 f"{len(wired['wire_session'].wasted)} corrupted copies, each refused by its "
                 f"CRC, bit-identical to the host loop")
    log(f"faults {name}: {rep['summary']}; host loop and fused path identical (report, theta, "
        f"theta_hat, meter); fused steady round {faulted_ms:.3f} ms faulted vs {clean_ms:.3f} "
        f"ms clean (wall of a replayed run / rounds), host round {row['host_round_ms']:.3f} "
        f"ms{extra}")
    return row


class TimedSaves(FLEngine):
    """An engine that times each checkpoint save (device-to-host copy, write,
    fsync, rename)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.save_ms = []

    def _save_state(self, *args, **kwargs):
        t0 = time.perf_counter()
        super()._save_state(*args, **kwargs)
        self.save_ms.append(1e3 * (time.perf_counter() - t0))


def phase_resume(name, kind, factory, mode, faults):
    """A run killed after round 2 and resumed from its checkpoint, against
    the uninterrupted run: bit for bit."""
    task, shards, run_kw = fault_setup(kind)
    kw = dict(rounds=FAULT_ROUNDS, mode=mode, faults=faults, **run_kw)
    full = FLEngine(task, factory()).run(shards, **kw)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        saver = TimedSaves(task, factory())
        saved = saver.run(shards, checkpoint_dir=ckdir, checkpoint_every=CKPT_EVERY, **kw)
        files = sorted(os.listdir(ckdir))
        nbytes = os.path.getsize(os.path.join(ckdir, files[0]))
        for f in files[1:]:
            os.remove(os.path.join(ckdir, f))
        resumed = FLEngine(task, factory()).run(shards, resume_from=ckdir, **kw)
    if files != ["ckpt_00000002.repro", "ckpt_00000004.repro"] or not same_run(full, saved) \
            or not same_run(full, resumed) or resumed.get("faults") != full.get("faults"):
        raise AssertionError(f"resume {name} {mode} faults={faults is not None}: the resumed "
                             f"run differs from the uninterrupted one ({files})")
    label = "faulted" if faults is not None else "clean"
    log(f"resume {name} {mode} {label}: killed after round {CKPT_EVERY}, resumed bit-identical "
        f"to the uninterrupted run; checkpoint {nbytes} bytes, saves "
        f"{[round(t, 3) for t in saver.save_ms]} ms")
    return {"checkpoint_bytes": nbytes, "save_ms": saver.save_ms}


def phase_wire_faults_resume():
    """Phase 12 (see the module docstring)."""
    t0 = time.perf_counter()
    wire = {label: phase_wire(label) for label in WIRE_PATHS}
    t_wire = time.perf_counter() - t0
    n, d = quickstart.CONFIG["n_clients"], 28160
    matrix = fault_matrix(n=n, d=d, n_is=quickstart.CONFIG["n_is"], block=128)
    faults = {name: phase_faults(name, kind, factory) for name, kind, factory in matrix}
    t_faults = time.perf_counter() - t0 - t_wire
    families = {name: (kind, factory) for name, kind, factory in matrix}
    resume = {f"{name} {mode} {label}": phase_resume(name, *families[name], mode, plan)
              for name in ("bicompfl-pr", "doublesqueeze") for mode in ("host", "fused")
              for label, plan in (("clean", None), ("faulted", FAULT_PLAN))}
    t_all = time.perf_counter() - t0
    log(f"phase 12 seconds: wire {t_wire:.1f}, faults {t_faults:.1f}, resume "
        f"{t_all - t_wire - t_faults:.1f}, total {t_all:.1f}")
    log(f"wire, faults, resume: {json.dumps({'wire': wire, 'faults': faults, 'resume': resume})}")
    return t_all


# ---------------------------------------------------------------------------
# Phase 7: the model substrate's kernels against their plain versions.
# ---------------------------------------------------------------------------


def assert_model_close(name, got, want, mag):
    """Kernel vs plain version within MODEL_RTOL x the terms' magnitude
    (+ BF16_ULPS bf16 ulp of the output for a bf16 output)."""
    tol = MODEL_RTOL * mag + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * torch.finfo(torch.bfloat16).eps * want.float().abs()
    err = (got.float() - want.float()).abs()
    if got.shape != want.shape or got.dtype != want.dtype \
            or not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max |err| {err.max().item()}, worst err/tol "
                             f"{(err / tol).max().item()}")
    return err.max().item()


def check_flash(shape, dtype, causal, window, seed, timed, skv=None,
                kv_chunk=flash_attn.KV_CHUNK):
    """``shape`` is (B, Sq, H, Hkv, Dh); the keys number ``skv`` (Sq if None);
    ``kv_chunk`` is the plain version's (and the wrapper's CPU route's)."""
    b, s, h, hkv, dh = shape
    skv = s if skv is None else skv
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, h, dh, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, scale=dh ** -0.5, kv_chunk=kv_chunk)
    got = launched_once(ops.flash_attention, q, k, v, **kw)
    want = flash_attn.flash_attention_ref(q, k, v, **kw)
    mag = flash_attn.flash_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    err = assert_model_close(f"flash_attention {shape} {dtype}", got, want, mag)
    label = (f"flash_attention {tuple(shape)} skv={skv} {str(dtype)[6:]} causal={causal} "
             f"window={window}")
    if not timed:
        log(f"{label}: max|err| {err:.3e}")
        return None
    del want, mag
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, scale=kw["scale"], enable_gqa=True)
    flops, nbytes, _ = kcost.flash_attention(q, k, v, causal, window)
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else TF32_SPLIT_FLOPS_PER_S
    log(f"{label}:")
    row = timed_row("flash_attention", shape, err,
                    lambda: ops.flash_attention(q, k, v, **kw),
                    lambda: flash_attn.flash_attention_ref(q, k, v, **kw), library,
                    nbytes, flops, rate, reps=10)
    if dtype == torch.float32:
        row["bound_f32_cuda_cores_ms"] = bound(nbytes, flops, FP32_FLOPS_PER_S)["bound_ms"]
        log(f"  the same work at 67 TFLOP/s (f32 on the CUDA cores): "
            f"{row['bound_f32_cuda_cores_ms']:.4f} ms")
    return row


def check_rwkv(shape, seed, timed, strong=False, dtype=torch.float32):
    b, s, h, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda") for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, dh, generator=gen, device="cuda") - 2.0)
    if strong:
        logw.fill_(-15.0)
    r, k, v, logw = (t.to(dtype) for t in (r, k, v, logw))
    u = 0.1 * torch.randn(h, dh, generator=gen, device="cuda")
    got = launched_once(ops.rwkv_time_mix, r, k, v, logw, u)
    want = rwkv_chunk.rwkv_time_mix_ref(r, k, v, logw, u)
    err = assert_model_close(f"rwkv_time_mix {shape}", got, want, want.float().abs().max())
    label = f"rwkv_time_mix {tuple(shape)} {str(dtype)[6:]}{' logw=-15' if strong else ''}"
    if not timed:
        log(f"{label}: max|err| {err:.3e}")
        return None
    work = kcost.rwkv_time_mix(r, k, v, logw, u)
    return timed_row("rwkv_time_mix", shape, err, lambda: ops.rwkv_time_mix(r, k, v, logw, u),
                     lambda: rwkv_chunk.rwkv_time_mix_ref(r, k, v, logw, u), None,
                     work.nbytes, work.flops, reps=10)


def phase_model_kernels():
    rows = {}
    full = (PREFILL_BATCH, PREFILL_SEQ, 16, 8, 128)   # Qwen3-1.7B's attention
    rows["flash_bf16"] = check_flash(full, torch.bfloat16, True, 0, 1, timed=True)
    rows["flash_f32"] = check_flash(full, torch.float32, True, 0, 2, timed=True)
    # Phase 13's attention layers at their prefill shape, causal as the
    # models run them (GQA groups of 8): bf16 for Kimi K2 and Jamba, and f32
    # at Jamba's heads (its f32 cross-check).
    for i, (arch, dtype) in enumerate([("kimi-k2-1t-a32b", torch.bfloat16),
                                       ("jamba-v0.1-52b", torch.bfloat16),
                                       ("jamba-v0.1-52b", torch.float32)]):
        c = configs.get(arch)
        check_flash((PREFILL_BATCH, PREFILL_SEQ, c.n_heads, c.n_kv_heads, c.head_dim), dtype,
                    True, 0, 30 + i, timed=False)
    for dtype in (torch.float32, torch.bfloat16):
        check_flash((1, 1000, 4, 2, 64), dtype, True, 256, 3, timed=False)
        check_flash((2, 333, 6, 3, 40), dtype, False, 0, 4, timed=False)
    # Phase 14's HuBERT attention at its forward shape, non-causal, Dh 80
    # (the bf16 kernel's second panel partial, the f32 kernel's 5-column
    # case), and two small odd Dh-80 cases in both types.
    c = configs.get("hubert-xlarge")
    hubert = (PREFILL_BATCH, PREFILL_SEQ, c.n_heads, c.n_kv_heads, c.head_dim)
    rows["flash_bf16_noncausal_dh80"] = check_flash(hubert, torch.bfloat16, False, 0, 40,
                                                    timed=True)
    rows["flash_f32_noncausal_dh80"] = check_flash(hubert, torch.float32, False, 0, 41,
                                                   timed=True)
    for dtype in (torch.float32, torch.bfloat16):
        check_flash((1, 300, 4, 4, 80), dtype, False, 0, 42, timed=False, skv=450)
        check_flash((2, 200, 4, 2, 80), dtype, True, 0, 43, timed=False)
    # The bf16 wgmma kernel at every Dh class, Sq off its 128-row blocks,
    # Sq != Skv and a window across tile edges.
    for i, (shape, causal, window, skv) in enumerate([
            ((1, 200, 2, 1, 8), True, 0, None), ((2, 200, 4, 2, 40), True, 0, None),
            ((2, 150, 4, 2, 64), True, 0, None), ((1, 330, 16, 8, 128), True, 0, None),
            ((1, 100, 4, 2, 64), True, 0, 300), ((1, 300, 2, 2, 128), True, 0, 100),
            ((2, 90, 4, 1, 40), False, 0, 250), ((1, 1000, 16, 8, 128), True, 256, None),
            ((1, 4095, 16, 8, 128), True, 0, None)]):
        check_flash(shape, torch.bfloat16, causal, window, 20 + i, timed=False, skv=skv)
    # Phase 15's training attention, causal, at the trainer's kv_chunk (the
    # sequence): qwen3-1.7b's microbatch in bf16 (step 1, the wgmma kernel)
    # and f32 (every later step: Adam promotes the parameters; timed), and
    # train_100m's in f32.
    c, m = configs.get(TRAIN_ARCH), train_100m.CFG_100M
    train = (TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, c.n_heads, c.n_kv_heads, c.head_dim)
    check_flash(train, torch.bfloat16, True, 0, 50, timed=False, kv_chunk=TRAIN_SEQ)
    rows["flash_f32_training"] = check_flash(train, torch.float32, True, 0, 51, timed=True,
                                             kv_chunk=TRAIN_SEQ)
    check_flash((TRAIN_100M_BATCH, TRAIN_100M_SEQ, m.n_heads, m.n_kv_heads, m.head_dim),
                torch.float32, True, 0, 52, timed=False, kv_chunk=TRAIN_100M_SEQ)
    rows["rwkv"] = check_rwkv((PREFILL_BATCH, PREFILL_SEQ, 32, 64), 5, timed=True)
    check_rwkv((1, 1000, 32, 64), 6, timed=False)
    check_rwkv((2, 4096, 32, 64), 7, timed=False, strong=True)
    check_rwkv((3, 1500, 48, 64), 8, timed=False)    # B * H = 144 > 132 SMs, ragged tail
    check_rwkv((2, 4096, 32, 64), 9, timed=False, dtype=torch.bfloat16)
    return rows


# ---------------------------------------------------------------------------
# Phases 8-10: the serving path of the model substrate.
# ---------------------------------------------------------------------------


def seeded_tokens(vocab, b, s, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen, device="cuda")


def mixer_launches(model) -> dict:
    """Each model kernel's launches in one prefill: one a layer of its mixer."""
    plans = transformer.layer_plans(model)
    expect = {k: 0 for k in KERNELS}
    expect["flash_attention"] = sum(mixer == "attn" for mixer, _ in plans)
    expect["rwkv_time_mix"] = sum(mixer == "rwkv6" for mixer, _ in plans)
    return expect


@contextlib.contextmanager
def recorded_routing():
    """Collect every ``moe.route`` result (in call order) while open."""
    seen, route = [], moe_mod.route

    def recording(*args, **kwargs):
        seen.append(route(*args, **kwargs))
        return seen[-1]

    moe_mod.route = recording
    try:
        yield seen
    finally:
        moe_mod.route = route


def median_wall_ms(fn, reps: int = 3) -> tuple[float, list]:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls)), walls


def prefill_path(arch, loaded=None, profile_seq=None, batch=None, forward=False):
    """Prefill at full width, bf16: counts (one launch per layer of the
    kernel's mixer), logits, host time, peak memory, the share of MoE
    assignments dropped at capacity, and the kernels' share of the device
    time (from a (2, ``profile_seq``) prefill where one is given).
    ``loaded`` is (cfg, model, params) (else the config's own, drawn here);
    ``batch`` the inputs (else seeded tokens); with ``forward`` the step is
    ``transformer.forward`` (logits at every position), else
    ``prefill_step``; it returns the launches and the logits."""
    if loaded is None:
        cfg = configs.get(arch)
        model = transformer.build(cfg)
        params = transformer.init_params(model, seed=0, device="cuda")
    else:
        cfg, model, params = loaded
    if batch is None:
        batch = {"tokens": seeded_tokens(cfg.vocab, PREFILL_BATCH, PREFILL_SEQ, 11)}
    step = transformer.forward if forward else transformer.prefill_step
    name = "forward" if forward else "prefill"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with recorded_routing() as routes:
        logits = step(model, params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = mixer_launches(model)
    if launches != expect:
        raise AssertionError(f"{name} {arch}: launches {launches}, expected {expect}")
    if len(routes) != moe_layer_count(model):
        raise AssertionError(f"{name} {arch}: {len(routes)} routings recorded, expected one "
                             f"for each of {moe_layer_count(model)} MoE layers")
    shape = (PREFILL_BATCH, PREFILL_SEQ if forward else 1, cfg.vocab)
    if tuple(logits.shape) != shape or logits.dtype != params["head"].dtype \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} {arch}: logits {tuple(logits.shape)} {logits.dtype} "
                             "not finite or of the wrong shape")
    drops = [round(1.0 - float(r.keep.float().mean()), 6) for r in routes]
    del routes
    wall, walls = median_wall_ms(lambda: step(model, params, batch))
    if loaded is None:
        PREFILL_MS[(arch, name)] = wall
    kernel = MODELS.get(arch, "flash_attention")
    tokens = PREFILL_BATCH * PREFILL_SEQ
    log(f"{name} {arch} {cfg.dtype} ({PREFILL_BATCH}, {PREFILL_SEQ}), {cfg.n_layers} layers: "
        f"launches {launches}; {wall:.3f} ms median of {[round(w, 3) for w in walls]} ms "
        f"(host clock, synchronised) = {tokens / wall * 1e3:.0f} tokens/s; peak device "
        f"memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} above the weights)"
        + (f"; MoE layers' share of assignments dropped at capacity {drops}" if drops else ""))
    if profile_seq:
        short = {"tokens": batch["tokens"][:, :profile_seq]}
        wall, _ = median_wall_ms(lambda: step(model, params, short))
        log(f"  profiled at ({PREFILL_BATCH}, {profile_seq}) (the full prefill launches too "
            f"many kernels to summarise): {wall:.3f} ms unprofiled (median of 3)")
        batch = short
    busy, events = device_profile(lambda: step(model, params, batch))
    names = KERNEL_SYMBOLS[kernel]
    own = sum(e.self_device_time_total for e in events if any(n in e.key for n in names)) / 1e3
    if busy == 0:
        log(f"  profile: the profiler saw no device time (kernel share: not measured)")
    else:
        log(f"  profile: device busy {busy:.3f} ms ({busy / wall:.4f} of the unprofiled "
            f"wall) in {sum(e.count for e in events)} kernels; {' + '.join(names)} "
            f"{own:.3f} ms = {own / busy:.4f} of the device time")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if loaded is None:
        del params
        torch.cuda.empty_cache()
    return launches, logits


def tie_gap(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the least gap between adjacent probabilities among its
    k + 1 largest: an expert choice may differ between two computations of
    the probabilities only where this is small."""
    top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).min(-1).values


def tie_tol(got_probs: torch.Tensor, want_probs: torch.Tensor) -> float:
    """The largest top-k gap at which two computations of the probabilities
    may order a token's experts differently: each probability moved by at
    most d = max |got - want|, so two experts swap only within 2 d (plus
    one float32 rounding of the gap)."""
    d = float((got_probs - want_probs).abs().max())
    return 2 * d + torch.finfo(torch.float32).eps


def routing_flips(label, got, want, gap, tol) -> tuple[int, int]:
    """(tokens whose expert choices differ, tokens within ``tol`` of a tie):
    each flip must be a near tie, and near ties a small share of tokens."""
    diff = (got != want).any(-1)
    far = diff & (gap > tol)
    if bool(far.any()):
        raise AssertionError(f"{label}: {int(far.sum())} tokens routed differently away from a "
                             f"near tie (least top-k gap {float(gap[far].min()):.3e}, "
                             f"allowed {tol:.3e})")
    near = int((gap <= tol).sum())
    if near > MAX_NEAR_TIE_SHARE * gap.numel():
        raise AssertionError(f"{label}: {near} of {gap.numel()} tokens lie within {tol:.3e} "
                             f"of a tie, above the share {MAX_NEAR_TIE_SHARE}")
    return int(diff.sum()), near


def moe_layer_count(model) -> int:
    return sum(kind == "moe" for _, kind in transformer.layer_plans(model))


def crosscheck_path(arch, cfg=None, prompt=XCHECK_PROMPT):
    """f32: prefill's last logits vs teacher-forced decode steps; on an MoE
    config also each MoE layer's expert choices, prefill vs decode (B *
    ``prompt`` <= 256 keeps both dropless)."""
    cfg = cfg or dataclasses.replace(configs.get(arch), dtype="float32")
    model = transformer.build(cfg)
    params = transformer.init_params(model, seed=1, device="cuda")
    toks = seeded_tokens(cfg.vocab, PREFILL_BATCH, prompt, 12)
    reset_counts()
    with recorded_routing() as pre_routes:
        pre = transformer.prefill_step(model, params, {"tokens": toks})[:, -1]
    launches = read_counts()
    cache = transformer.init_cache(model, PREFILL_BATCH, prompt, "cuda")
    t0 = time.perf_counter()
    with recorded_routing() as dec_routes:
        for t in range(prompt):
            dec, cache = transformer.serve_step(model, params, cache, toks[:, t:t + 1], t)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dec = dec[:, -1]
    rel = float(torch.linalg.vector_norm(pre - dec) / torch.linalg.vector_norm(dec))
    same = torch.equal(pre.argmax(-1), dec.argmax(-1))
    flips = []
    n_moe = moe_layer_count(model)
    if len(pre_routes) != n_moe or len(dec_routes) != n_moe * prompt:
        raise AssertionError(f"cross-check {arch}: {len(pre_routes)} prefill and "
                             f"{len(dec_routes)} decode routings recorded, expected {n_moe} "
                             f"and {n_moe * prompt}")
    for i, r in enumerate(pre_routes):
        if r.capacity != PREFILL_BATCH * prompt or not bool(r.keep.all()):
            raise AssertionError(f"cross-check {arch}: MoE layer {i}'s prefill is not dropless")
        # prefill's one group holds the tokens batch-major; decode step t
        # routes one group of the B tokens at t
        steps = [dec_routes[t * n_moe + i] for t in range(prompt)]
        got = torch.stack([d.gate_idx[0] for d in steps], 1)
        want = r.gate_idx[0].reshape(PREFILL_BATCH, prompt, -1)
        probs = r.probs[0].reshape(PREFILL_BATCH, prompt, -1)
        tol = tie_tol(torch.stack([d.probs[0] for d in steps], 1), probs)
        gap = tie_gap(probs, cfg.top_k)
        flips.append(routing_flips(f"cross-check {arch} MoE layer {i}", got, want, gap, tol)
                     + (tol,))
    expect = mixer_launches(model)
    log(f"cross-check {arch} f32 ({PREFILL_BATCH}, {prompt}), {cfg.n_layers} layers: "
        f"prefill ({launches[MODELS.get(arch, 'flash_attention')]} kernel launches) vs "
        f"{prompt} decode steps ({seconds:.2f} s): relative L2 {rel:.3e} (bound "
        f"{XCHECK_REL_L2}), argmax equal {same}, max|logit| {float(dec.abs().max()):.3f}"
        + (f"; per MoE layer (tokens routed differently, tokens within the allowed tie gap, "
           f"that gap = 2 max|dprob| + f32 eps): "
           f"{[(f, n, float(f'{t:.3e}')) for f, n, t in flips]}" if n_moe else ""))
    if launches != expect or not rel <= XCHECK_REL_L2 or not same:
        raise AssertionError(f"cross-check {arch}: kernel launches {launches} (expected "
                             f"{expect}), relative L2 {rel}, argmax equal {same}")
    del params, cache, pre_routes, dec_routes
    torch.cuda.empty_cache()
    return rel


def serve_path(arch, server=None):
    """``Server.generate`` at full width, bf16: lengths, range, determinism,
    no kernel launch; tokens per second, the device's busy share and the
    peak device memory."""
    cfg = configs.get(arch) if server is None else server.cfg
    if server is None:
        server = Server(cfg, max_batch=4, max_seq=128, seed=0, device="cuda")
    rng = np.random.default_rng(13)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n), max_new_tokens=16)
            for n in (16, 32, 48, 64)]
    server.generate(reqs[:1])   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(server.generate(reqs))
        walls.append(time.perf_counter() - t0)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    outs = runs[0]
    if any(launches.values()):
        raise AssertionError(f"serve {arch}: decode launched kernels {launches}")
    if [len(o) for o in outs] != [16] * 4 \
            or not all(((o >= 0) & (o < cfg.vocab)).all() for o in outs) \
            or not all(np.array_equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"serve {arch}: lengths {[len(o) for o in outs]}, tokens "
                             "out of range or not deterministic")
    steps, wall = 64 + 16 - 1, walls[1]
    log(f"serve {arch} {cfg.dtype}: 4 requests (prompts 16/32/48/64, 16 new tokens each) "
        f"in {walls[0]:.3f} s, then {wall:.3f} s = {64 / wall:.1f} generated tokens/s, "
        f"{steps} decode steps of batch 4 ({1e3 * wall / steps:.2f} ms/step); peak device "
        f"memory {peak / 2**20:.1f} MiB; launches {launches}; first tokens "
        f"{[o[:4].tolist() for o in outs]}")
    # Device time of PROFILED_STEPS decode steps at batch 4 (profiling all
    # of generate records ~2.4e5 kernels and takes minutes to summarise).
    cache = transformer.init_cache(server.model, 4, 128, "cuda")
    tok = torch.as_tensor(np.stack([r.prompt[:PROFILED_STEPS] for r in reqs]), device="cuda")

    def steps_run():
        c = cache
        for t in range(PROFILED_STEPS):
            _, c = transformer.serve_step(server.model, server.params, c, tok[:, t:t + 1], t)

    busy, events = device_profile(steps_run, PROFILED_STEPS)
    if busy == 0:
        log("  profile: the profiler saw no device time (busy share: not measured)")
    else:
        log(f"  profile of {PROFILED_STEPS} decode steps: device busy {busy:.3f} ms per step "
            f"in {sum(e.count for e in events) // PROFILED_STEPS} kernels = "
            f"{busy * steps / (1e3 * wall):.4f} of an unprofiled step")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3 / PROFILED_STEPS:8.3f} ms/step  "
                f"x{e.count // PROFILED_STEPS:<5d} {e.key[:90]}")
    del server, cache
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the MoE and Jamba configs.
# ---------------------------------------------------------------------------


def leaves(tree):
    """A parameter tree's (or a cache's) tensors."""
    if isinstance(tree, dict):
        return [v for sub in tree.values() for v in leaves(sub)]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in leaves(sub)]
    return [tree]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def moe_layer(model, params):
    """The first MoE layer's FFN parameters."""
    return next(p["ffn"] for (_, kind), p in zip(transformer.layer_plans(model),
                                                 params["layers"]) if kind == "moe")


def routing_vs_cpu(arch, cfg, router):
    """``moe.route`` on the card against the CPU on the same float32 inputs
    ((2, 4096) tokens in groups of 1024) and the same router: expert
    choices equal outside near ties, and the queue places and capacity
    decisions equal for every assignment to an expert that no flipped token
    names in its group (a flip moves only the places in its experts'
    queues)."""
    n = PREFILL_BATCH * PREFILL_SEQ // 1024
    gen = torch.Generator(device="cuda").manual_seed(14)
    xg = torch.randn(n, 1024, cfg.d_model, generator=gen, device="cuda")
    card = moe_mod.route(cfg, router, xg)
    cpu = moe_mod.route(cfg, router.cpu(), xg.cpu())
    card_idx = card.gate_idx.cpu()
    tol = tie_tol(card.probs.cpu(), cpu.probs)
    flips, near = routing_flips(f"routing {arch}", card_idx, cpu.gate_idx,
                                tie_gap(cpu.probs, cfg.top_k), tol)
    touched = torch.zeros(n, cfg.n_experts, dtype=torch.bool)
    for g, t in (card_idx != cpu.gate_idx).any(-1).nonzero().tolist():
        touched[g, card_idx[g, t]] = True
        touched[g, cpu.gate_idx[g, t]] = True
    clean = ~torch.gather(touched, 1, cpu.gate_idx.reshape(n, -1)).reshape(cpu.gate_idx.shape)
    for name in ("keep", "pos"):
        if not torch.equal(getattr(card, name).cpu()[clean], getattr(cpu, name)[clean]):
            raise AssertionError(f"routing {arch}: {name} differs card vs CPU at an assignment "
                                 "to an expert that no flipped token names")
    log(f"routing {arch} card vs CPU, f32 inputs ({n}, 1024, {cfg.d_model}), E {cfg.n_experts}, "
        f"top-{cfg.top_k}, C {card.capacity}: {flips} tokens with other experts, all within "
        f"the allowed tie gap {tol:.3e} (2 max|dprob| + f32 eps; {near} of {n * 1024} tokens "
        f"lie that near, bound {MAX_NEAR_TIE_SHARE}); places and capacity decisions equal at "
        f"{int(clean.sum())} of {clean.numel()} assignments (those to experts no flipped "
        f"token names); dropped {1.0 - float(cpu.keep.float().mean()):.6f} of the assignments")
    return flips


def moe_work(cfg, n_tok: int, group: int = 1024) -> tuple[float, float]:
    """(bytes, bf16 operations) of ``moe_ffn`` on ``n_tok`` tokens: every
    expert's weights read once, the input read and the output written once;
    the router, the one-hot dispatch and combine, the expert products over
    the E x C places of each group, and the shared expert."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    g = min(group, n_tok)
    n = -(-n_tok // g)
    c = moe_mod._capacity(cfg, g)
    weights = 2 * (3 * e * d * ff + 3 * d * ff * cfg.shared_experts) + 4 * d * e
    flops = (2 * n * g * d * e + 2 * 2 * n * g * e * c * d + 2 * 3 * n * e * c * d * ff
             + 2 * 3 * n_tok * d * ff * cfg.shared_experts)
    return weights + 2 * 2 * n_tok * d, flops


def moe_needed_work(cfg, r, n_tok: int) -> tuple[float, float, int, int]:
    """(bytes, bf16 operations, kept assignments, experts used) of the work
    ``moe_ffn``'s output needs on this run's routing ``r``: the weights of
    the experts that hold a kept assignment, the router and the shared
    expert read once, the input read and the output written once; the
    router, each kept assignment's expert product and the shared expert."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    k = cfg.top_k
    keep = r.keep.reshape(-1, k)[:n_tok]
    kept = int(keep.sum())
    used = int(torch.unique(r.gate_idx.reshape(-1, k)[:n_tok][keep]).numel())
    weights = 2 * (3 * used * d * ff + 3 * d * ff * cfg.shared_experts) + 4 * d * e
    flops = 2 * n_tok * d * e + 2 * 3 * kept * d * ff + 2 * 3 * n_tok * d * ff * cfg.shared_experts
    return weights + 2 * 2 * n_tok * d, flops, kept, used


def time_layers(arch, cfg, model, params):
    """The first MoE FFN at prefill (2, 4096) and decode (4, 1) shapes, and
    for Jamba the first Mamba mixer, each alone on seeded bf16 inputs.  Two
    bounds: the reference's dense algorithm's work (``moe_work``) and the
    work the output needs on this input's routing (``moe_needed_work``)."""
    moe = moe_layer(model, params)
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn(PREFILL_BATCH, PREFILL_SEQ, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    for label, inp, reps in (("prefill", x, 5), ("decode", x[0, :4, None].contiguous(), 20)):
        n_tok = inp.shape[0] * inp.shape[1]
        nbytes, flops = moe_work(cfg, n_tok)
        with recorded_routing() as routes:
            moe_mod.moe_ffn(cfg, moe, inp)
        need_bytes, need_flops, kept, used = moe_needed_work(cfg, routes[0], n_tok)
        ms = cuda_time_ms(lambda: moe_mod.moe_ffn(cfg, moe, inp), reps=reps, warmup=2)
        b = bound(nbytes, flops, BF16_FLOPS_PER_S)
        nb = bound(need_bytes, need_flops, BF16_FLOPS_PER_S)
        log(f"  {arch} moe_ffn {tuple(inp.shape)}: {ms:.3f} ms (CUDA events, {reps} calls); "
            f"dense algorithm's bound {b['bound_ms']:.3f} ms ({b['bound_by']}: "
            f"{nbytes / 1e9:.2f} GB, {flops / 1e12:.3f} TFLOP) = {ms / b['bound_ms']:.2f}x; "
            f"needed work's bound {nb['bound_ms']:.3f} ms ({nb['bound_by']}: "
            f"{need_bytes / 1e9:.2f} GB of {used} routed experts' and the shared weights, "
            f"{need_flops / 1e12:.3f} TFLOP for {kept} kept assignments) = "
            f"{ms / nb['bound_ms']:.2f}x")
    mixer = next((p["mixer"] for (kind, _), p in zip(transformer.layer_plans(model),
                                                     params["layers"]) if kind == "mamba"), None)
    if mixer is not None:
        st = mamba_mod.init_mamba_state(cfg, PREFILL_BATCH, torch.bfloat16, "cuda")
        ms = cuda_time_ms(lambda: mamba_mod.mamba_block(cfg, mixer, x, st), reps=2, warmup=1)
        st4 = mamba_mod.init_mamba_state(cfg, 4, torch.bfloat16, "cuda")
        step = cuda_time_ms(lambda: mamba_mod.decode_step(cfg, mixer, x[0, :4, None], st4),
                            reps=20, warmup=2)
        log(f"  {arch} mamba_block ({PREFILL_BATCH}, {PREFILL_SEQ}): {ms:.3f} ms; "
            f"decode_step (4, 1): {step:.3f} ms (CUDA events)")


def phase_moe_models():
    """Phase 13: Jamba (one unit of 8 layers) and Kimi K2 (its dense prefix
    layer and one MoE layer) at full width, bf16: prefill, routing card vs
    CPU, serving; Jamba's unit in f32, prefill vs decode."""
    out = {}
    for arch, n_layers in MOE_CUTS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers)
        server = Server(cfg, max_batch=4, max_seq=128, seed=0, device="cuda")
        log(f"{arch} cut to {n_layers} layers {transformer.layer_plans(server.model)}: "
            f"weights {tree_bytes(server.params) / 1e9:.2f} GB (bf16, float32 routers and SSM leaves), "
            f"drawn in {time.perf_counter() - t0:.1f} s")
        out[f"{arch} prefill"], _ = prefill_path(arch, (cfg, server.model, server.params),
                                                 PROFILE_SEQ.get(arch))
        routing_vs_cpu(arch, cfg, moe_layer(server.model, server.params)["router"])
        time_layers(arch, cfg, server.model, server.params)
        out[f"{arch} serve"] = serve_path(arch, server)
        del server
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 13 {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    arch = "jamba-v0.1-52b"
    crosscheck_path(arch, dataclasses.replace(configs.get(arch), n_layers=MOE_CUTS[arch],
                                              dtype="float32"), prompt=MOE_XCHECK_PROMPT)
    log(f"phase 13 {arch} f32 cross-check: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: Qwen2-VL's image inputs and M-RoPE, HuBERT's frames, the int8 KV
# cache.
# ---------------------------------------------------------------------------


def seeded_normal(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scale * torch.randn(shape, generator=gen, device="cuda")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def grid_positions(b: int, s: int, n_img: int, side: int) -> torch.Tensor:
    """(B, S, 3) M-RoPE ids in Qwen2-VL's scheme (arXiv:2409.12191 §2.1):
    image patch i < n_img at (t, h, w) = (0, i // side, i % side), text
    token j >= n_img at t = h = w = side + (j - n_img), after the grid's
    largest id."""
    i = torch.arange(s, device="cuda")
    text = side + i - n_img
    pos = torch.stack([torch.where(i < n_img, 0, text), torch.where(i < n_img, i // side, text),
                       torch.where(i < n_img, i % side, text)], -1)
    return pos[None].expand(b, s, 3)


def refused(label, fn) -> str:
    """``fn`` must raise ``ValueError``; its message."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{label} did not refuse an encoder-only config")


def phase_audio():
    """HuBERT at full width and depth, bf16: ``forward`` on seeded frames
    (48 flash launches, non-causal, Dh 80), profiled; a 4-layer f32 cut
    card against CPU; no decode step."""
    arch = "hubert-xlarge"
    t0 = time.perf_counter()
    cfg = configs.get(arch)
    model = transformer.build(cfg)
    params = transformer.init_params(model, seed=0, device="cuda")
    log(f"{arch}: {cfg.n_layers} layers, weights {tree_bytes(params) / 1e9:.3f} GB (bf16, no "
        f"embedding: frame inputs), drawn in {time.perf_counter() - t0:.1f} s")
    frames = seeded_normal((PREFILL_BATCH, PREFILL_SEQ, cfg.d_model), 16, 0.02)
    launches, logits = prefill_path(arch, (cfg, model, params), batch={"inputs": frames},
                                    forward=True)
    cache = transformer.init_cache(model, 1, 8, "cuda")
    why = [refused("Server", lambda: Server(cfg, max_batch=1, max_seq=8, device="cuda")),
           refused("serve_step", lambda: transformer.serve_step(
               model, params, cache, torch.zeros((1, 1), dtype=torch.long, device="cuda"), 0))]
    log(f"  {arch} refuses decode: Server: {why[0]!r}; serve_step: {why[1]!r}")
    del params, logits, cache
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=AUDIO_XCHECK_LAYERS, dtype="float32")
    model = transformer.build(cut)
    params = transformer.init_params(model, seed=1, device="cuda")
    x = seeded_normal((PREFILL_BATCH, AUDIO_XCHECK_SEQ, cfg.d_model), 17, 0.02)
    reset_counts()
    card = transformer.forward(model, params, {"inputs": x})
    torch.cuda.synchronize()
    flash = read_counts()["flash_attention"]
    cpu = transformer.forward(model, tree_to(params, "cpu"), {"inputs": x.cpu()})
    rel = rel_l2(card, cpu)
    log(f"  {arch} f32 cut to {AUDIO_XCHECK_LAYERS} layers, frames ({PREFILL_BATCH}, "
        f"{AUDIO_XCHECK_SEQ}): card ({flash} f32 flash launches) vs CPU logits relative L2 "
        f"{rel:.3e} (bound {XCHECK_REL_L2})")
    if flash != AUDIO_XCHECK_LAYERS or not rel <= XCHECK_REL_L2:
        raise AssertionError(f"{arch} card vs CPU: {flash} launches, relative L2 {rel}")
    del params, card
    torch.cuda.empty_cache()
    return {f"{arch} forward": launches}


def phase_vlm():
    """Qwen2-VL cut to 8 layers at full width, bf16: prefill of (2, 4096)
    with 1024 image embeddings on a 32 x 32 grid of M-RoPE positions (8
    flash launches), the image's effect on the last logits, ``apply_mrope``
    card vs CPU at the attention's shape, ``Server.generate`` (text only,
    M-RoPE decode, no launch); then 2 layers in f32, prefill vs decode."""
    arch = "qwen2-vl-72b"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(arch), n_layers=VLM_CUT)
    server = Server(cfg, max_batch=4, max_seq=128, seed=0, device="cuda")
    log(f"{arch} cut to {VLM_CUT} layers: weights {tree_bytes(server.params) / 1e9:.2f} GB "
        f"(bf16), drawn in {time.perf_counter() - t0:.1f} s")
    n_img = cfg.vlm_image_tokens
    batch = {"tokens": seeded_tokens(cfg.vocab, PREFILL_BATCH, PREFILL_SEQ, 11),
             "image_embeds": seeded_normal((PREFILL_BATCH, n_img, cfg.d_model), 18, 0.02),
             "positions": grid_positions(PREFILL_BATCH, PREFILL_SEQ, n_img, VLM_GRID)}
    launches, logits = prefill_path(arch, (cfg, server.model, server.params), batch=batch)
    moved = transformer.prefill_step(server.model, server.params,
                                     dict(batch, image_embeds=batch["image_embeds"] + 0.1))
    delta = float((moved.float() - logits.float()).abs().max())
    log(f"  {arch}: image embeddings + 0.1 move the last logits by up to {delta:.4e}")
    if not delta > 1e-6:
        raise AssertionError(f"{arch}: the image embeddings do not reach the last logits")
    del moved, logits
    x = seeded_normal((PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads, cfg.head_dim), 19)
    args = (cfg.rope_theta, cfg.mrope_sections)
    got = layers_mod.apply_mrope(x, batch["positions"], *args)
    rel = rel_l2(got, layers_mod.apply_mrope(x.cpu(), batch["positions"].cpu(), *args))
    inv = layers_mod.rope_freqs(cfg.head_dim, cfg.rope_theta, "cuda").cpu()
    n_inv = int((inv != layers_mod.rope_freqs(cfg.head_dim, cfg.rope_theta, "cpu")).sum())
    log(f"  apply_mrope {tuple(x.shape)} f32, grid positions: card vs CPU relative L2 "
        f"{rel:.3e} (bound {MROPE_REL_L2}); inverse frequencies that differ card vs CPU: "
        f"{n_inv} of {inv.numel()}")
    if not rel <= MROPE_REL_L2:
        raise AssertionError(f"apply_mrope card vs CPU: relative L2 {rel}")
    del x, got, batch
    served = serve_path(arch, server)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    crosscheck_path(arch, dataclasses.replace(configs.get(arch), n_layers=VLM_XCHECK_LAYERS,
                                              dtype="float32"), prompt=MOE_XCHECK_PROMPT)
    return {f"{arch} prefill": launches, f"{arch} serve": served}


def replay_logits(server, seqs: torch.Tensor, first: int) -> torch.Tensor:
    """Teacher-forced decode of ``seqs`` (B, T) from step 0: the f32 logits
    of steps ``first`` .. T - 1, (B, T - first, V)."""
    cache = transformer.init_cache(server.model, seqs.shape[0], server.max_seq, "cuda")
    out = []
    for t in range(seqs.shape[1]):
        logits, cache = transformer.serve_step(server.model, server.params, cache,
                                               seqs[:, t:t + 1], t)
        if t >= first:
            out.append(logits[:, 0].float())
    return torch.stack(out, 1)


def phase_kv_quant():
    """qwen3-1.7b's int8 KV cache at full width and depth: ``quantize_kv``
    card vs CPU (equal), greedy ``Server.generate`` int8 against bf16 (the
    tokens agree up to each request's first step that is not decisive),
    the cache bytes, and one timed decode step of each cache at S_max 8192."""
    arch = "qwen3-1.7b"
    cfg = configs.get(arch)
    x = seeded_normal((KV_QUANT_BATCH, KV_QUANT_SEQ, cfg.n_kv_heads, cfg.head_dim), 20, 3.0
                      ).to(torch.bfloat16)
    q, sc = layers_mod.quantize_kv(x)
    q_cpu, sc_cpu = layers_mod.quantize_kv(x.cpu())
    n_q = int((q.cpu() != q_cpu).sum())
    n_s = int((sc.cpu().view(torch.int16) != sc_cpu.view(torch.int16)).sum())
    log(f"quantize_kv {tuple(x.shape)} bf16 values: card vs CPU, {n_q} of {q.numel()} int8 "
        f"payloads and {n_s} of {sc.numel()} f16 scales differ")
    if n_q or n_s:
        raise AssertionError(f"quantize_kv card vs CPU: {n_q} payloads, {n_s} scales differ")
    del x, q, sc

    servers = {"bf16": Server(cfg, max_batch=4, max_seq=128, seed=0, device="cuda"),
               "int8": Server(dataclasses.replace(cfg, kv_cache_quant=True), max_batch=4,
                              max_seq=128, seed=0, device="cuda")}
    servers["int8"].load_params(servers["bf16"].params)
    rng = np.random.default_rng(13)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n), max_new_tokens=16)
            for n in (16, 32, 48, 64)]
    reset_counts()
    toks = {k: srv.generate(reqs) for k, srv in servers.items()}
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"int8-cache serve {arch}: decode launched kernels {launches}")
    # The bf16 run's sequences replayed through both caches: a step is
    # decisive where the bf16 top-2 margin exceeds twice the largest logit
    # difference int8 vs bf16 at that step (tests/test_kv_quant.py's rule).
    seqs = np.zeros((4, 64 + 15), np.int64)
    for i, r in enumerate(reqs):
        seqs[i, 64 - len(r.prompt):64] = r.prompt
        seqs[i, 64:] = toks["bf16"][i][:15]
    seqs = torch.as_tensor(seqs, device="cuda")
    lg, lq = (replay_logits(servers[k], seqs, 63) for k in ("bf16", "int8"))
    err = (lq - lg).abs().amax(dim=(0, 2))                            # (16,)
    top2 = torch.topk(lg, 2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1] > 2 * err).cpu()          # (4, 16)
    same = (lq.argmax(-1) == lg.argmax(-1)).cpu()
    agree = []
    for i in range(4):
        first = int((~decisive[i]).nonzero()[0]) if not bool(decisive[i].all()) else 16
        agree.append(int((toks["int8"][i][:first] == toks["bf16"][i][:first]).sum()) == first)
    log(f"serve {arch} greedy, int8 vs bf16 cache: logit difference per step {err.min():.4f}-"
        f"{err.max():.4f}; {int(decisive.sum())} of 64 steps decisive, argmax equal at "
        f"{int(same[decisive].sum())} of them ({int(same.sum())} of 64 in all); generated "
        f"tokens equal at {sum(int((a == b).sum()) for a, b in zip(toks['int8'], toks['bf16']))}"
        f" of 64, each request's up to its first step that is not decisive: {agree}")
    if not bool(decisive.any()) or not bool(same[decisive].all()) or not all(agree):
        raise AssertionError(f"int8 cache {arch}: decisive steps {int(decisive.sum())}, argmax "
                             f"equal there {bool(same[decisive].all())}, prefixes equal {agree}")
    del lg, lq

    caches = {k: transformer.init_cache(srv.model, KV_QUANT_BATCH, KV_QUANT_SEQ, "cuda")
              for k, srv in servers.items()}
    nbytes = {k: tree_bytes(c) for k, c in caches.items()}
    ratio = nbytes["int8"] / nbytes["bf16"]
    log(f"KV cache ({KV_QUANT_BATCH}, {KV_QUANT_SEQ}) x {cfg.n_layers} layers: bf16 "
        f"{nbytes['bf16'] / 1e9:.3f} GB, int8 {nbytes['int8'] / 1e9:.3f} GB, ratio {ratio}")
    if ratio != 0.5625:
        raise AssertionError(f"int8 cache bytes ratio {ratio}, expected 0.5625")
    tok = seeded_tokens(cfg.vocab, KV_QUANT_BATCH, 1, 21)
    params = servers["bf16"].params     # a step reads every weight but the embedding's rows
    weights = tree_bytes([params["layers"], params["final_norm"], params["head"]])
    steps = {}
    for k, srv in servers.items():
        def step(srv=srv, cache=caches[k]):
            transformer.serve_step(srv.model, srv.params, cache, tok, KV_QUANT_POS)
        ms = cuda_time_ms(step, reps=10, warmup=2)
        busy, events = device_profile(lambda: [step() for _ in range(5)], 5)
        cache_ms = bound(nbytes[k], 0)["bound_ms"]
        step_ms = bound(nbytes[k] + weights, 0)["bound_ms"]
        steps[k] = ms
        log(f"  serve_step {k} cache, batch {KV_QUANT_BATCH}, S_max {KV_QUANT_SEQ}, pos "
            f"{KV_QUANT_POS}: {ms:.3f} ms a step (CUDA events, 10 steps); device busy "
            f"{fmt_ms(busy or None)} a step in {sum(e.count for e in events) // 5} kernels "
            f"({busy / ms:.4f} of the step); bounds: the cache read {cache_ms:.3f} ms "
            f"({nbytes[k] / 1e9:.3f} GB), with the weights {step_ms:.3f} ms = {ms / step_ms:.2f}x")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
            log(f"    {e.self_device_time_total / 1e3 / 5:8.3f} ms/step  x{e.count // 5:<5d} "
                f"{e.key[:90]}")
    log(f"  int8 / bf16 step time: {steps['int8'] / steps['bf16']:.4f}")
    del servers, caches
    gc.collect()
    torch.cuda.empty_cache()
    return {f"{arch} int8-cache serve": launches}


def phase_multimodal_models():
    """Phase 14: HuBERT, Qwen2-VL and the int8 KV cache, one after the
    other, each model freed before the next."""
    out, seconds = {}, {}
    for name, fn in (("hubert", phase_audio), ("qwen2-vl", phase_vlm),
                     ("int8 cache", phase_kv_quant)):
        t0 = time.perf_counter()
        out.update(fn())
        seconds[name] = round(time.perf_counter() - t0, 1)
    log(f"phase 14 seconds: {seconds}")
    return out


# ---------------------------------------------------------------------------
# Phase 15: training.
# ---------------------------------------------------------------------------


def stacked_init(cfg, seed: int, device):
    """A config's seeded weights in the trainer's (the reference's stacked) layout."""
    model = transformer.build(cfg)
    return model, convert.stack_model_params(model, transformer.init_params(model, seed, device))


def loss_and_grads(model, tree, batch, device):
    """The training loss and its gradients (``tree_leaves`` order) at
    ``tree`` moved to ``device``, as the train step takes them."""
    tree = tree_map(lambda t: t.to(device).detach().requires_grad_(), tree)
    loss = train_mod.make_loss_fn(model, kv_chunk=TRAIN_CHECK_SEQ)(
        tree, train_mod.batch_tensors(batch, device))
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(tree))


def phase_train_vs_cpu():
    """The reduced qwen3 and rwkv6, f32 (TF32 off): one ``Trainer`` step on
    the card (counts set to 0 just before, read just after: one launch of
    the mixer's kernel a layer); the loss and every gradient leaf (through
    the two Functions: the kernel forward, the plain backward) card vs CPU;
    the stochastic sign's bits card vs CPU on the same gradients."""
    out = {}
    for arch in TRAIN_CHECK:
        cfg = configs.get(arch).reduced()
        model, tree = stacked_init(cfg, 21, "cpu")
        kernel = MODELS[arch]
        batch = next(batches_for(cfg, 2, TRAIN_CHECK_SEQ, seed=5, n=1))
        tr = train_mod.Trainer(cfg, lr=1e-3, kv_chunk=TRAIN_CHECK_SEQ, device="cuda",
                               grad_compression="stochastic_sign",
                               params=tree_map(lambda t: t.cuda(), tree))
        reset_counts()
        loss = tr.step(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        out[f"{arch} (reduced) train step"] = launches
        if launches[kernel] != cfg.n_layers or not math.isfinite(loss):
            raise AssertionError(f"train step {arch} (reduced): loss {loss}, launches "
                                 f"{launches}, expected {cfg.n_layers} of {kernel}")
        loss_card, g_card = loss_and_grads(model, tree, batch, "cuda")
        loss_cpu, g_cpu = loss_and_grads(model, tree, batch, "cpu")
        rel = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(g_card, g_cpu))
        loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
        keys = prng.split(prng.fold_in(prng.PRNGKey(7, device="cuda"), 1), len(g_card))
        flips = near = n = 0
        for i, g in enumerate(g_card):
            card = train_mod._stochastic_sign_compress(g, keys[i]).cpu()
            host = train_mod._stochastic_sign_compress(g.cpu(), keys[i].cpu())
            q = torch.sigmoid(g.cpu() / (g.cpu().abs().mean() + 1e-12))
            if not torch.equal(train_mod._bernoulli(keys[i], q.cuda()).cpu(),
                               train_mod._bernoulli(keys[i].cpu(), q)):
                raise AssertionError(f"{arch}: the sign draw differs card vs CPU on equal "
                                     f"probabilities (leaf {i})")
            # K = mean |g| sums in two orders: a sign may differ only where the
            # uniform lies within rounding of the probability
            tie = (prng.uniform(keys[i].cpu(), g.shape) - q).abs() <= SIGN_TIE
            flip = torch.sign(card) != torch.sign(host)
            if bool((flip & ~tie).any()):
                raise AssertionError(f"{arch}: sign bits card vs CPU differ away from ties "
                                     f"(leaf {i})")
            flips, near, n = flips + int(flip.sum()), near + int(tie.sum()), n + g.numel()
        log(f"train {arch} (reduced, f32, (2, {TRAIN_CHECK_SEQ})): Trainer step on the card "
            f"loss {loss:.6f}, launches {launches[kernel]} of {kernel}; card vs CPU: loss "
            f"relative {loss_rel:.3e}, gradients max|diff| / max|g| per leaf {rel:.3e} (bound "
            f"{GRAD_RTOL}); sign bits of {n} entries: {flips} differ, {near} within "
            f"{SIGN_TIE} of their probability; the draw equal on equal probabilities")
        if not rel <= GRAD_RTOL or not loss_rel <= GRAD_RTOL:
            raise AssertionError(f"train {arch} card vs CPU: gradients {rel}, loss {loss_rel}")
        del tr, g_card
    torch.cuda.empty_cache()
    return out


def train_full_width():
    """qwen3-1.7b as its config stands (bf16, remat, Adam), batch 4 x seq
    1024 in 2 microbatches: 3 steps with the stochastic sign, then 3
    without and one more profiled, then a bf16 first step profiled.  Per
    step: the loss (finite), ms (synchronised host clock), flash launches
    (counts set to 0 just before the step), the parameters' dtype after
    it; per run the peak memory."""
    cfg = configs.get(TRAIN_ARCH)
    n_params, tokens = cfg.params_count(), TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    batches = list(batches_for(cfg, TRAIN_BATCH, TRAIN_SEQ, n=TRAIN_STEPS))
    expect = 2 * TRAIN_MB * cfg.n_layers      # forward + remat's recompute, per microbatch
    runs, launches = {}, {k: 0 for k in KERNELS}
    predict_train()                           # phase 16 (a)'s prediction, before any trainer
    for comp in ("stochastic_sign", None):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = train_mod.Trainer(cfg, lr=TRAIN_LR, microbatches=TRAIN_MB, kv_chunk=TRAIN_SEQ,
                               grad_compression=comp, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        if comp is None:
            held = torch.cuda.memory_allocated() - before
            bt = train_mod.batch_tensors(batches[0], "cuda")
            MEASURED["train"] = {
                "init_growth": held, "batch_growth": torch.cuda.memory_allocated() - before - held,
                "batch_int_entries": sum(t.numel() for t in bt.values()
                                         if not t.is_floating_point()),
                "tensor_bytes": [t.numel() * t.element_size() for t in tree_leaves(
                    (tr.params, tr.opt_state, tr.key, bt)) if isinstance(t, torch.Tensor)]}
            del bt
        steps = []
        for i, b in enumerate(batches):
            if comp is None and i == 0:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
            reset_counts()
            t0 = time.perf_counter()
            loss = tr.step(b)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = read_counts()
            if comp is None and i == 0:
                MEASURED["train"].update(step1_peak=torch.cuda.max_memory_allocated(),
                                         step1_base=base, step1_ms=ms)
            for k, v in counts.items():
                launches[k] += v
            # the caching allocator's retries (cached blocks freed, cudaMalloc
            # again) are a cost of the memory's layout, not of the arithmetic
            steps.append({"loss": loss, "ms": ms, "flash": counts["flash_attention"],
                          "draws": counts[DRAWS],
                          "dtype": str(tr.params["head"].dtype).split(".")[1],
                          "alloc_retries": torch.cuda.memory_stats().get(
                              "num_alloc_retries", 0) - retries})
        peak = torch.cuda.max_memory_allocated()
        label = comp or "no compression"
        log(f"train {TRAIN_ARCH} {cfg.dtype}, remat, Adam, ({TRAIN_BATCH}, {TRAIN_SEQ}) in "
            f"{TRAIN_MB} microbatches, {label}: init {t_init:.1f} s; steps "
            f"{json.dumps(steps)}; peak device memory {peak / 2**20:.1f} MiB")
        if any(not math.isfinite(s["loss"]) or s["flash"] != expect or not s["draws"]
               or (s["draws"] == 1) != (comp is None) for s in steps) \
                or [s["dtype"] for s in steps] != ["float32"] * len(steps):
            raise AssertionError(f"train {TRAIN_ARCH} {label}: losses finite, {expect} flash "
                                 f"launches a step, one prng draw a step (the key's split) "
                                 f"and more under the sign, and f32 parameters after each "
                                 f"step expected; got {steps}")
        step1, steady = steps[0]["ms"], float(np.median([s["ms"] for s in steps[1:]]))
        runs[label] = {"steps": steps, "peak_mib": peak / 2**20, "step1_ms": step1,
                       "steady_ms": steady, "tokens_per_s_steady": tokens / steady * 1e3,
                       "mfu_step1_bf16": flops / (step1 / 1e3) / BF16_FLOPS_PER_S,
                       "mfu_steady_f32": flops / (steady / 1e3) / FP32_FLOPS_PER_S}
        if comp is None:
            runs[label].update(profile_step(tr, batches[0], steady, "f32 step"))
            runs["parts"] = step_parts(cfg, tr.params)
        log(f"  {label}: step 1 (bf16) {step1:.1f} ms, steady (f32) {steady:.1f} ms, "
            f"{tokens / steady * 1e3:.0f} tokens/s; 6 N D = {flops:.3e} flop (N "
            f"{n_params}): {runs[label]['mfu_step1_bf16']:.4f} of 989 TFLOP/s at step 1, "
            f"{runs[label]['mfu_steady_f32']:.4f} of 67 TFLOP/s steady")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    # the bf16 first step profiled on a fresh trainer (the runs time it unprofiled)
    tr = train_mod.Trainer(cfg, lr=TRAIN_LR, microbatches=TRAIN_MB, kv_chunk=TRAIN_SEQ,
                           seed=0, device="cuda")
    runs["bf16 step 1"] = profile_step(tr, batches[0], runs["no compression"]["step1_ms"],
                                       "bf16 step 1")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return runs, launches


def profile_step(tr, batch, wall_ms: float, label: str) -> dict:
    """One train step under ``torch.profiler``: device busy ms, its share of
    the unprofiled step's ``wall_ms``, and the top device operations."""
    busy, events = device_profile(lambda: tr.step(batch))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = {"busy_ms": busy, "busy_share": busy / wall_ms,
           "top": [(round(e.self_device_time_total / 1e3, 3), e.count, e.key[:80])
                   for e in top]}
    log(f"  profiled {label}: device busy {busy:.3f} ms = {busy / wall_ms:.4f} of the "
        f"unprofiled step, {sum(e.count for e in events)} kernels")
    for ms, count, key in out["top"]:
        log(f"    {ms:10.3f} ms  x{count:<6d} {key}")
    return out


def step_parts(cfg, params):
    """The f32 step's parts timed alone (CUDA events): the sign compression
    of every leaf (on the weights as stand-in gradients: the threefry's cost
    does not depend on the values), and one attention layer's flash forward
    and plain backward at the training shape, with the launches a step."""
    leaves = tree_leaves(params)
    keys = prng.split(prng.PRNGKey(3, device="cuda"), len(leaves))
    sign_ms = cuda_time_ms(lambda: [train_mod._stochastic_sign_compress(p, keys[i])
                                    for i, p in enumerate(leaves)], reps=1, warmup=1)
    b, s, h, hk, dh = TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(b, s, n, dh, generator=gen, device="cuda").requires_grad_()
               for n in (h, hk, hk))
    kw = dict(causal=True, scale=dh ** -0.5, kv_chunk=TRAIN_SEQ)
    dout = torch.randn(b, s, h, dh, generator=gen, device="cuda")
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, **kw), reps=10)
    out = ops.flash_attention(q, k, v, **kw)
    bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(out, (q, k, v), dout,
                                                      retain_graph=True), reps=5)
    n_fwd, n_bwd = 2 * TRAIN_MB * cfg.n_layers, TRAIN_MB * cfg.n_layers
    parts = {"sign_compress_ms": sign_ms, "flash_forward_ms": fwd_ms,
             "attention_backward_ms": bwd_ms,
             "attention_ms_per_step": n_fwd * fwd_ms + n_bwd * bwd_ms}
    log(f"  parts of an f32 step, alone: the sign compression of {len(leaves)} leaves "
        f"({sum(p.numel() for p in leaves)} entries) {sign_ms:.1f} ms; attention at ({b}, {s}, "
        f"{h}, {hk}, {dh}) f32: flash forward {fwd_ms:.3f} ms x {n_fwd}, the plain backward "
        f"{bwd_ms:.3f} ms x {n_bwd}: {parts['attention_ms_per_step']:.1f} ms a step")
    return parts


def predict_train():
    """Phase 16 (a)'s prediction for phase 15's full-width run: the same
    configuration dry-run on the one card's (1, 1) mesh."""
    t0 = time.perf_counter()
    totals, out, meta = dryrun.trace_combo(TRAIN_ARCH, "train_4k", make_host_mesh(),
                                           kv_chunk=TRAIN_SEQ, microbatches=TRAIN_MB,
                                           batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    DRY["train"] = {"totals": totals, **out}
    log(f"dry run of the training step ({TRAIN_ARCH}, ({TRAIN_BATCH}, {TRAIN_SEQ}) in "
        f"{TRAIN_MB} microbatches, (1, 1) mesh, {meta['optimizer']}), before the trainer: "
        f"{json.dumps(out['memory'])}; {out['roofline'].row()} "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_train():
    """Phase 15: (a) the Functions and the sign draw card vs CPU at reduced
    size, (b) qwen3-1.7b trained at full width, (c) ``train_100m`` for 50
    steps (the loss falls)."""
    seconds = {}
    t0 = time.perf_counter()
    out = phase_train_vs_cpu()
    seconds["card vs cpu"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    runs, launches = train_full_width()
    out[f"{TRAIN_ARCH} train"] = launches
    seconds["full width"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    reset_counts()
    _, losses = train_100m.run(steps=TRAIN_100M_STEPS, batch=TRAIN_100M_BATCH,
                               seq=TRAIN_100M_SEQ, device="cuda", log=None)
    torch.cuda.synchronize()
    out["train_100m"] = read_counts()
    seconds["100m"] = round(time.perf_counter() - t0, 1)
    log(f"train_100m ({train_100m.CFG_100M.params_count() / 1e6:.1f}M, f32): "
        f"{TRAIN_100M_STEPS} steps in {seconds['100m']} s, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {out['train_100m']}")
    if not losses[-1] < losses[0] or out["train_100m"]["flash_attention"] != \
            TRAIN_100M_STEPS * train_100m.CFG_100M.n_layers:
        raise AssertionError(f"train_100m: loss {losses[0]} -> {losses[-1]}, launches "
                             f"{out['train_100m']}")
    log(f"phase 15 seconds: {seconds}")
    log(f"training: {json.dumps(runs)}")
    return out


def check_args(label, predicted, growth, int_entries, tensor_bytes):
    """The dry run's argument bytes against the device memory the arguments
    took: token ids are int64 on the card (``batch_tensors``, ``randint``)
    and int32 in the specs, 4 bytes more an entry; the allocator gives each
    tensor of ``tensor_bytes`` under ``ALLOC_ROUND`` bytes more, and under
    1 MiB more again a large-pool one (``LARGE_REQUEST``)."""
    want = predicted + 4 * int_entries
    large = sum(n > LARGE_REQUEST for n in tensor_bytes)
    slack = ALLOC_ROUND * len(tensor_bytes) + LARGE_REQUEST * large
    log(f"  {label}: argument bytes predicted {predicted} (+{4 * int_entries} for int64 "
        f"token ids = {want}), measured growth {growth}: {growth - want} B over "
        f"({(growth - want) / want:.3e} of it), bound [0, {slack}) ({len(tensor_bytes)} "
        f"blocks, {large} of the large pool)")
    if sum(tensor_bytes) != want or not 0 <= growth - want < slack:
        raise AssertionError(f"{label}: predicted argument bytes {want}, the card's "
                             f"allocations grew by {growth}")


def phase_dryrun():
    """Phase 16: the dry run against the card.  (a) memory: argument bytes
    equal to what the arguments took on the card (the training step, the
    qwen3-1.7b prefill of (2, 4096)); temp and peak printed beside the
    measured peaks.  (b) FLOPs: ``op_cost`` over the prefill on the card
    counts the meta trace's matrix products outside attention; attention by
    each route's formula.  (c) each bound beside the measured time.  (d) the
    production mesh: ``run_combo`` on (16, 16), each ``ok`` or a documented
    ``skip``."""
    t0 = time.perf_counter()
    out = {}
    # (a) training
    pred, got = DRY["train"]["memory"], MEASURED["train"]
    log("phase 16 (a) memory:")
    check_args(f"train {TRAIN_ARCH}", pred["argument_bytes"],
               got["init_growth"] + got["batch_growth"], got["batch_int_entries"],
               got["tensor_bytes"])
    step1 = got["step1_peak"] - got["step1_base"]
    log(f"  train step 1 (bf16): predicted temp {pred['temp_bytes']} B, peak "
        f"{pred['peak_bytes']} B; measured {step1} B above the arguments, peak "
        f"max_memory_allocated {got['step1_peak']} B ({got['step1_peak'] / pred['peak_bytes']:.4f} "
        f"of the predicted peak)")
    out["train_memory"] = {"predicted": pred, "measured": got}
    # (a) and (b): the prefill of (2, 4096)
    arch = DRYRUN_PREFILL_ARCH
    meta_totals, pre, _ = dryrun.trace_combo(arch, "prefill_32k", make_host_mesh(),
                                             batch=PREFILL_BATCH, seq=PREFILL_SEQ)
    cfg = configs.get(arch)
    model = transformer.build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = transformer.init_params(model, seed=0, device="cuda")
    tokens = seeded_tokens(cfg.vocab, PREFILL_BATCH, PREFILL_SEQ, 11)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - before
    check_args(f"prefill {arch} ({PREFILL_BATCH}, {PREFILL_SEQ})",
               pre["memory"]["argument_bytes"], growth, tokens.numel(),
               [t.numel() * t.element_size() for t in tree_leaves((params, tokens))])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with op_cost.OpCost() as oc:
        logits = transformer.prefill_step(model, params, {"tokens": tokens})
    torch.cuda.synchronize()
    launches = read_counts()["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill: predicted temp {pre['memory']['temp_bytes']} B (the meta trace's plain "
        f"attention scan), peak {pre['memory']['peak_bytes']} B; measured {peak - base} B "
        f"above the arguments (the kernel route), peak {peak} B")
    card = oc.totals
    q = torch.empty((PREFILL_BATCH, PREFILL_SEQ, cfg.n_heads, cfg.head_dim), device="meta")
    kv = torch.empty((PREFILL_BATCH, PREFILL_SEQ, cfg.n_kv_heads, cfg.head_dim), device="meta")
    kernel_attn = cfg.n_layers * kcost.flash_attention(q, kv, kv, cfg.causal,
                                                        cfg.sliding_window).flops
    plain_attn = cfg.n_layers * op_cost.analyze(flash_attn.flash_attention_ref, q, kv, kv,
                                                causal=cfg.causal).flops
    regions = (card.flops_by_region, meta_totals.flops_by_region)
    log(f"phase 16 (b) FLOPs, prefill {arch} ({PREFILL_BATCH}, {PREFILL_SEQ}): outside "
        f"attention card {regions[0].get('', 0):.6e}, meta {regions[1].get('', 0):.6e}; "
        f"attention card (the kernel's formula, {launches} launches) "
        f"{regions[0].get('flash_attention', 0):.6e} (expected {kernel_attn:.6e}), meta (the "
        f"plain scan's) {regions[1].get('flash_attention', 0):.6e} (expected {plain_attn:.6e})")
    if set(regions[0]) != {"", "flash_attention"} or set(regions[1]) != set(regions[0]) \
            or regions[0][""] != regions[1][""] \
            or regions[0]["flash_attention"] != kernel_attn \
            or regions[1]["flash_attention"] != plain_attn \
            or card.ops.get("kernel:flash_attention") != cfg.n_layers:
        raise AssertionError(f"phase 16 (b): card {regions[0]}, meta {regions[1]}, kernel "
                             f"reports {card.ops.get('kernel:flash_attention')}")
    if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 16: the traced prefill's logits")
    del params, logits, tokens
    gc.collect()
    torch.cuda.empty_cache()
    out["prefill"] = {"predicted": pre["memory"], "measured_peak": peak,
                      "measured_temp": peak - base, "card_flops": card.flops,
                      "meta_flops": meta_totals.flops}
    # (c) the bounds beside the measured times
    log("phase 16 (c) roofline bounds against the measured times:")
    for label, rl, ms in (
            (f"prefill {arch} ({PREFILL_BATCH}, {PREFILL_SEQ}), phase 8", pre["roofline"],
             PREFILL_MS.get((arch, "prefill"))),
            (f"train {TRAIN_ARCH} bf16 step 1, phase 15", DRY["train"]["roofline"],
             MEASURED["train"]["step1_ms"])):
        row = rl.row()
        log(f"  {label}: bound {row['bound_s'] * 1e3:.3f} ms ({row['dominant']}; compute "
            f"{row['compute_s'] * 1e3:.3f}, memory {row['memory_s'] * 1e3:.3f}, collective "
            f"{row['collective_s'] * 1e3:.3f}); measured {fmt_ms(ms)}"
            + (f" = {ms / (row['bound_s'] * 1e3):.2f}x the bound" if ms else ""))
        out[label] = {"roofline": row, "measured_ms": ms}
    # (d) the production mesh
    log("phase 16 (d) run_combo on the (16, 16) mesh:")
    results = [dryrun.run_combo(a, shape, mesh=make_production_mesh(), verbose=True)
               for a, shape in DRYRUN_PRODUCTION]
    bad = [r for r in results if r["status"] not in ("ok", "skip")]
    out["production"] = {f"{r['arch']} {r['shape']}": r["status"] for r in results}
    if bad:
        raise AssertionError(f"phase 16 (d): {bad}")
    log(f"phase 16: {json.dumps(out['production'])} in {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"], capture_output=True,
                                  text=True, check=True).stdout.split()[0])
    issue_rate = SMS * ISSUE_LANES_PER_SM * sm_mhz * 1e6
    log(f"max SM clock {sm_mhz:.0f} MHz: {issue_rate:.3e} thread instructions/s issued on "
        f"{SMS} SMs x {ISSUE_LANES_PER_SM} lanes")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        futures = {k: pool.submit(build.build, k) for k in build.SOURCES}
    builds = {k: f.result() for k, f in futures.items()}
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall")
    for name, res in builds.items():
        log(f"  {name}: {res['seconds']:.2f} s, built={res['built']}, {res['path']}")
        for line in res["log"].strip().splitlines():
            log(f"    {line}")
        for line in ptxas_summary(res["log"]):
            log(f"  ptxas {name}: {line}")
    hgmma = flash_hgmma(builds["flash_attn"]["path"])
    log(f"flash_attn library: HGMMA instructions by kernel (cuobjdump -sass) {hgmma}")
    if sorted(hgmma) != sorted(KERNEL_SYMBOLS["flash_attention"]) or not all(hgmma.values()):
        raise AssertionError(f"each flash kernel (bf16 and f32) must issue wgmma: HGMMA "
                             f"counts by kernel {hgmma}")
    n_draw, by_code = threefry_instructions()
    tf = (n_draw, issue_rate)
    log(f"threefry draw (uniform_at, csrc/common.cuh): {n_draw} SASS instructions "
        f"(cuobjdump -sass of the probe kernels); the draw loop by opcode: {by_code}")

    # Phase 3.
    t3 = time.perf_counter()
    draw_rows = check_threefry_draw(tf)
    main_row = check_mrc_logw((2200, 64, 128), seed=1, device=True)
    cfl_row = check_mrc_logw(CFL_LOGW_SHAPE, seed=30, device=True)
    check_mrc_logw((7, 48, 100), seed=2, timed=False)
    check_mrc_logw((5, 33, 7), seed=3, timed=False)
    check_mrc_logw((550, 64, 512), seed=4, timed=False)
    payload, priors, kt = round0_inputs()
    kl_rows = check_bernoulli_kl(payload, priors)
    profile = bernoulli_kl.profile_ref(payload, clip01(priors)).cpu().numpy()
    _, n_seg, seg, _ = AdaptiveAllocation(n_is=64).plan(profile, payload.shape[1])
    seg_row = check_segment_logw(payload, priors, kt, seg, n_seg)
    enc_row = check_segment_encode(payload, priors, kt, seg, n_seg, tf, seg_row)
    ck_row = check_client_key_encode(payload, priors, kt, seg, n_seg, tf)
    t_fixed = time.perf_counter()
    fixed_rows = check_fixed_encode(payload, priors, kt, tf)
    t_fixed = time.perf_counter() - t_fixed
    t3 = time.perf_counter() - t3

    # Phase 4.
    runs = {}
    for name in PATHS:
        runs[name] = run_path(name)
        check_path(name, *runs[name])
    avg_sizes = sorted({pl[0] for pl in runs["adaptive-avg"][1]})
    n = quickstart.CONFIG["n_clients"]
    avg_rows = [check_mrc_logw((n * (-(-28160 // s)), 64, s), seed=10 + s) for s in avg_sizes]
    for size in avg_sizes:
        sels, pc, a, b = fixed_encode_inputs(payload, priors, size)
        check_fixed_case(f"Adaptive-Avg's blocks of {size}", kt, sels, pc, a, b, 64)
    t_var = time.perf_counter()
    peaks = {}
    for label in VARIANTS:
        launches, plans, out, peaks[label] = run_variant(label)
        check_variant(label, launches, plans, out)
        runs[label] = (launches, plans, out)
    t_var = time.perf_counter() - t_var
    t_cfl = time.perf_counter()
    cfl_launches, cfl_out, cfl_peak = run_cfl()
    check_cfl(cfl_launches, cfl_out)
    runs["cfl"] = (cfl_launches, None, cfl_out)
    peaks["cfl"] = cfl_peak
    runs.update(phase_baselines())
    t_cfl = time.perf_counter() - t_cfl

    # Phase 5.
    phase_codec_vs_cpu(payload, priors, kt)
    t5 = time.perf_counter()
    phase_variants_vs_cpu(payload, priors, kt, seg, n_seg)
    t5 = time.perf_counter() - t5
    t5c = time.perf_counter()
    phase_ef_vs_cpu(phase_cfl_vs_cpu())
    t5c = time.perf_counter() - t5c

    # Phase 6.
    t6 = time.perf_counter()
    profiles = {"fixed": phase_profile("fixed", 2),
                "fixed (unfused route)": phase_profile("fixed", 2, unfused=True),
                "adaptive": phase_profile("adaptive", 1),
                "adaptive (unfused route)": phase_profile("adaptive", 1, unfused=True),
                "adaptive-avg": phase_profile("adaptive-avg", 1),
                **{label: phase_profile(label, 1) for label in VARIANTS},
                "PR fixed (unfused route)": phase_profile("PR fixed", 1, unfused=True),
                "BiCompFL-GR-CFL": profile_cfl(1),
                "BiCompFL-GR-CFL (unfused route)": profile_cfl(1, unfused=True)}
    t6 = time.perf_counter() - t6

    # Phase 11.
    t11 = time.perf_counter()
    fused = {label: phase_fused(label, runs[label][2], runs[label][0]) for label in FUSED_PATHS}
    t11 = time.perf_counter() - t11
    log(f"fused phase: {t11:.1f} s")

    # Phase 12.
    phase_wire_faults_resume()
    log(f"variant phases' seconds: kernel checks {t3:.1f} (fixed-block encoder "
        f"{t_fixed:.1f}), paths {t_var:.1f} (peak device memory MiB "
        f"{ {k: round(v / 2**20, 1) for k, v in peaks.items()} }), card vs cpu {t5:.1f}, "
        f"profiles (all paths) {t6:.1f}; CFL and baselines: paths {t_cfl:.1f}, card vs cpu "
        f"{t5c:.1f}")

    t_fl = time.perf_counter()
    # Phase 7.
    model_rows = phase_model_kernels()

    # Phases 8-10.
    marks = [time.perf_counter()]
    prefill = {arch: prefill_path(arch)[0] for arch in MODELS}
    marks.append(time.perf_counter())
    for arch in MODELS:
        crosscheck_path(arch)
    marks.append(time.perf_counter())
    served = {arch: serve_path(arch) for arch in MODELS}
    marks.append(time.perf_counter())
    # Phase 13.
    moe_runs = phase_moe_models()
    marks.append(time.perf_counter())
    # Phase 14.
    moe_runs.update(phase_multimodal_models())
    marks.append(time.perf_counter())
    # Phase 15.
    moe_runs.update(phase_train())
    marks.append(time.perf_counter())
    # Phase 16.
    phase_dryrun()
    marks.append(time.perf_counter())
    log(f"phase seconds: build and FL phases 2-6 {t_fl - t0:.1f}, model kernels "
        f"{marks[0] - t_fl:.1f}, prefill {marks[1] - marks[0]:.1f}, cross-check "
        f"{marks[2] - marks[1]:.1f}, serve {marks[3] - marks[2]:.1f}, MoE and Jamba "
        f"{marks[4] - marks[3]:.1f}, HuBERT, Qwen2-VL and the int8 cache "
        f"{marks[5] - marks[4]:.1f}, training {marks[6] - marks[5]:.1f}, dry run "
        f"{marks[7] - marks[6]:.1f}")

    def by_path(*names, paths=None):
        return {p: sum(runs[p][0][k] for k in names) for p in (paths or runs)}

    shared_paths = [p for p in runs if p != "PR adaptive"]   # PR's keys are per client
    client_key_paths = ["PR fixed", "PR fixed p=0.5 jax cohorts", "PR-SplitDL fixed"]
    gr_fixed_paths = [p for p in runs if p not in client_key_paths + ["cfl"]]

    def by_model(name):
        return {**{f"{arch} prefill": prefill[arch][name] for arch in MODELS},
                **{f"{arch} serve": served[arch][name] for arch in MODELS},
                **{path: launches[name] for path, launches in moe_runs.items()}}

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    fixed_extra = {label: {k: v for k, v in row.items() if k not in keys}
                   for label, row in fixed_rows.items()}
    rows = [("mrc_logw", "mrc_logw", "src/repro/kernels/mrc_weights.py:71", main_row,
             by_path("mrc_logw"), {"form": "u-fed", "adaptive_avg_shapes": avg_rows,
                                   "cfl_shape": cfl_row}),
            ("mrc_fixed_encode", "mrc_logw", "src/repro/kernels/mrc_weights.py:71",
             fixed_rows["GR, shared key"], by_path("mrc_fixed_encode", paths=gr_fixed_paths),
             {"form": "keyed, one key shared by the clients",
              **fixed_extra["GR, shared key"]}),
            ("mrc_fixed_encode_client_keys", "mrc_logw", "src/repro/kernels/mrc_weights.py:71",
             fixed_rows["PR uplink, client keys"],
             by_path("mrc_fixed_encode", paths=client_key_paths),
             {"form": "keyed, one key per client", **fixed_extra["PR uplink, client keys"]}),
            ("mrc_fixed_encode_cfl", "mrc_logw", "src/repro/kernels/mrc_weights.py:71",
             fixed_rows["CFL"], by_path("mrc_fixed_encode", paths=["cfl"]),
             {"form": "keyed, one key shared by the clients, Ber(1/2) prior",
              **fixed_extra["CFL"]}),
            ("bernoulli_kl", "bernoulli_kl", "src/repro/kernels/bernoulli_kl.py:46",
             kl_rows["profile"],
             by_path("bernoulli_kl", "bernoulli_kl_total", "bernoulli_kl_profile"),
             {"profile": kl_rows["profile"], "total": kl_rows["total"]}),
            ("segment_logw", "segment_logw", "src/repro/kernels/segment_logw.py:92", seg_row,
             by_path("segment_logw"), {"shape": seg_row["shape"], "form": "u-fed"}),
            ("segment_mrc_encode", "segment_logw", "src/repro/kernels/segment_logw.py:92",
             enc_row, by_path("segment_mrc_encode", paths=shared_paths),
             {"form": "keyed", **{k: v for k, v in enc_row.items() if k not in keys}}),
            ("segment_mrc_encode_client_keys", "segment_logw",
             "src/repro/kernels/segment_logw.py:92", ck_row,
             by_path("segment_mrc_encode", paths=["PR adaptive"]),
             {"form": "keyed, one key per client",
              **{k: v for k, v in ck_row.items() if k not in keys}}),
            ("flash_attn", "flash_attn", "src/repro/kernels/flash_attn.py:95",
             model_rows["flash_bf16"], by_model("flash_attention"),
             {"shape": model_rows["flash_bf16"]["shape"], "dtype": "bfloat16",
              "f32": model_rows["flash_f32"],
              "f32_training": model_rows["flash_f32_training"],
              "f32_noncausal_dh80": model_rows["flash_f32_noncausal_dh80"],
              "bf16_noncausal_dh80": model_rows["flash_bf16_noncausal_dh80"],
              "hgmma_in_sass": hgmma}),
            ("rwkv_chunk", "rwkv_chunk", "src/repro/kernels/rwkv_chunk.py:90",
             model_rows["rwkv"], by_model("rwkv_time_mix"),
             {"shape": model_rows["rwkv"]["shape"]}),
            ("threefry_draw", "threefry_draw", None, draw_rows["bernoulli, the STE's mask"],
             {**by_path(DRAWS), **by_model(DRAWS)},
             {**{k: v for k, v in draw_rows["bernoulli, the STE's mask"].items()
                 if k not in keys},
              "uniform_at_sign_range": draw_rows["uniform_at, a range of the sign"],
              "fused_capture_launches": {p: f["capture_launches"][DRAWS]
                                         for p, f in fused.items()}})]
    # The fused paths: each kernel's device launches per replayed round (by
    # its device names, from the profiler) and its wrapper's count at capture.
    device_names = {"mrc_logw": ("mrc_logw_kernel",), "mrc_fixed_encode": ("mrc_encode_kernel",),
                    "bernoulli_kl": ("kl_rows", "kl_cols"), "segment_mrc_encode": ("seg_pass",
                                                                                    "seg_select")}
    wrappers = {"mrc_logw": ("mrc_logw",), "mrc_fixed_encode": ("mrc_fixed_encode",),
                "bernoulli_kl": ("bernoulli_kl", "bernoulli_kl_total", "bernoulli_kl_profile"),
                "segment_mrc_encode": ("segment_mrc_encode",)}

    def fused_by_path(name):
        base = next((b for b in device_names if name.startswith(b)), None)
        if base is None:
            return {}
        return {"fused_launches_per_round": {
                    p: sum(v for k, v in f["launches_per_round"].items()
                           if any(n in k for n in device_names[base]))
                    for p, f in fused.items()},
                "fused_capture_launches": {
                    p: sum(f["capture_launches"][w] for w in wrappers[base])
                    for p, f in fused.items()}}

    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu", "replaces": replaces,
                "launches": sum(per_path.values()), "launches_by_path": per_path,
                **{k: row[k] for k in keys}, **extra, **fused_by_path(name)}
               for name, src, replaces, row, per_path, extra in rows]
    for k in kernels:   # a bound is the least time the card could take
        measured = [t for t in (k["ms"], k.get("device_ms")) if t]
        if min(measured) < k["bound_ms"]:
            raise AssertionError(
                f"{k['name']}: measured {min(measured):.4f} ms (CUDA events {k['ms']:.4f} ms, "
                f"profiler {fmt_ms(k.get('device_ms'))} in "
                f"{k.get('device_kernels_per_call')} kernels a call) is below its bound "
                f"{k['bound_ms']:.4f} ms: the bound is not a bound")
        for label, row in k.items():   # the timed rows kept beside the main one
            if isinstance(row, dict) and "bound_ms" in row and row["ms"] < row["bound_ms"]:
                raise AssertionError(f"{k['name']} {label}: {row['ms']:.4f} ms is below its "
                                     f"bound {row['bound_ms']:.4f} ms: the bound is not a bound")
    log(f"FL profiles: {json.dumps(profiles)}")
    log(f"fused paths: {json.dumps(fused)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
