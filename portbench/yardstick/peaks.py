"""The chip's peaks, the work of the attention forward, and the kernel-name
rules the per-layer metrics read.  Frozen with the benchmark.

Every share is taken against the dense bf16 peak and the HBM rate of one
H100 SXM (NVIDIA's data sheet), whatever type the work runs in, so that no
later choice of precision or split can read above 100% of the same work;
float32 work reads low for it.
"""
from __future__ import annotations

import numpy as np

PEAK_FLOPS = 989e12          # dense bf16, FLOP/s
PEAK_BYTES = 3.35e12         # HBM3, bytes/s

# The port's hand-written FL kernels by device symbol (the list the
# profiles of ``chip_smoke.py`` read).
OWN_FL_KERNELS = ("mrc_logw_kernel", "mrc_encode_kernel", "kl_rows", "kl_cols", "seg_pass",
                  "seg_select")
# The attention forward kernels (``kernels/csrc/flash_attn.cu``): bf16, f32.
FLASH_FWD_KERNELS = ("flash_attn_wgmma", "flash_attn_tf32")
# cuBLAS and cuBLASLt GEMM kernels by name.
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")


def is_own_fl_kernel(name: str) -> bool:
    return any(k in name for k in OWN_FL_KERNELS)


def is_flash_fwd(name: str) -> bool:
    return any(k in name for k in FLASH_FWD_KERNELS)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return not is_flash_fwd(name) and any(m in low for m in GEMM_MARKS)


def visible_pairs(sq: int, skv: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the mask leaves."""
    i = np.arange(sq)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_work(b: int, sq: int, skv: int, h: int, hkv: int, dh: int, causal: bool,
                   elt_bytes: int, window: int = 0):
    """(FLOPs, bytes) of one attention forward: QK^T and PV over the visible
    pairs; q, k, v read and the output written once."""
    flops = 4 * b * h * dh * visible_pairs(sq, skv, causal, window)
    nbytes = elt_bytes * (2 * b * sq * h * dh + 2 * b * skv * hkv * dh)
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
