"""Block allocation for MRC (port of ``repro.core.blocks``, host plans).

* ``FixedAllocation``       -- constant block size d/B across rounds.
* ``AdaptiveAvgAllocation`` -- equal block sizes, the (single) size re-tuned
  each round so that the *average* KL per block tracks log(n_is); sizes are
  powers of two in [min_block, max_block].
* ``AdaptiveAllocation``    -- variable boundaries with (approximately)
  equal KL mass per block; boundaries are a segment-id vector.

``plan`` is the host control plane: numpy on the round's KL statistic, as
in the reference.  The bucketed plans of the reference's fused path
(``bucket_plans``, ``select_bucket``, ``finalize_plan``, ``bucket_grid``)
come with the port's fused path, and ``encode_plan``/``decode_plan`` with
its wire codec.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from .bernoulli import bern_kl


def _pad_to(d: int, block: int) -> int:
    return -(-d // block) * block


@dataclass(frozen=True)
class BlockPlan:
    """One round's block-allocation decision (host control plane).

    ``seg_ids`` is a numpy array (adaptive plans) or None; ``overhead_bits``
    and ``billable_blocks`` are Python numbers.
    """

    size: Optional[int]            # fixed block size (None for segment codec)
    n_blocks: int                  # number of blocks / segments (shapes)
    seg_ids: Any                   # per-parameter segment ids (adaptive only)
    overhead_bits: Any             # side information per client
    billable_blocks: Any = None    # actually-transmitted blocks, if fewer

    @property
    def adaptive(self) -> bool:
        return self.seg_ids is not None

    @property
    def billable(self):
        """Blocks that cross the wire; channels bill this, not ``n_blocks``."""
        return self.n_blocks if self.billable_blocks is None \
            else self.billable_blocks


@dataclass
class FixedAllocation:
    block_size: int = 256

    name = "Fixed"
    needs_kl = False  # plan() ignores the KL profile; the engine skips it

    def blocks_for(self, d: int) -> int:
        return _pad_to(d, self.block_size) // self.block_size

    def plan(self, kl_per_param, d: int):
        """Return (block_size, n_blocks, seg_ids=None, overhead_bits)."""
        return self.block_size, self.blocks_for(d), None, 0.0


@dataclass
class AdaptiveAvgAllocation:
    """Equal-size blocks, size re-tuned each round from the average KL.

    Target: per-block KL (in nats) ~ target_ratio * log(n_is); block sizes
    are powers of two in [min_block, max_block].  We book
    ceil(log2(max_block)) bits for the size update.
    """

    n_is: int = 256
    target_ratio: float = 1.0
    min_block: int = 32
    max_block: int = 4096

    name = "Adaptive-Avg"
    needs_kl = True
    needs_profile = False     # only the *mean* KL is consumed

    def plan(self, kl_per_param: Optional[np.ndarray], d: int):
        """``kl_per_param`` is the profile, or any array whose mean is the
        mean KL per parameter (the engine hands over ``total / d`` on the
        card)."""
        if kl_per_param is None:
            size = self.min_block * 8
        else:
            mean_kl = float(np.mean(kl_per_param)) + 1e-12
            target = self.target_ratio * math.log(self.n_is)
            size = target / mean_kl
        size = 2 ** int(np.clip(np.round(np.log2(max(size, 1))),
                                math.log2(self.min_block), math.log2(self.max_block)))
        n_blocks = _pad_to(d, size) // size
        return size, n_blocks, None, math.ceil(math.log2(self.max_block))


@dataclass
class AdaptiveAllocation:
    """Variable boundaries with equal KL mass per block (Isik et al. 2024).

    The number of blocks B is chosen so that total KL / B ~ log(n_is);
    boundaries come from cumulative-KL binning.  Overhead: B *
    ceil(log2(max_block)) bits for the block intervals (paper, Appendix E).
    """

    n_is: int = 256
    target_ratio: float = 1.0
    min_blocks: int = 4
    max_block: int = 4096

    name = "Adaptive"
    needs_kl = True
    needs_profile = True      # cumulative-KL binning needs the full profile

    def _cap(self, d: int) -> int:
        return max(self.min_blocks, d // 8)

    def plan(self, kl_per_param: Optional[np.ndarray], d: int):
        if kl_per_param is None:
            # Cold start: fall back to fixed 256-size blocks.
            size = 256
            n_blocks = _pad_to(d, size) // size
            seg = np.minimum(np.arange(d) // size, n_blocks - 1)
            return None, n_blocks, seg.astype(np.int32), 0.0
        total = float(np.sum(kl_per_param)) + 1e-12
        target = self.target_ratio * math.log(self.n_is)
        n_blocks = max(self.min_blocks, int(math.ceil(total / target)))
        n_blocks = min(n_blocks, self._cap(d))
        cum = np.cumsum(np.asarray(kl_per_param, dtype=np.float64))
        # boundary so each block holds ~ total/n_blocks KL mass
        edges = np.searchsorted(cum, np.linspace(0, total, n_blocks + 1)[1:-1])
        seg = np.zeros(d, dtype=np.int32)
        seg[edges] += 1
        seg = np.cumsum(seg).astype(np.int32)
        overhead = (int(seg.max()) + 1) * math.ceil(math.log2(self.max_block))
        return None, int(seg.max()) + 1, seg, float(overhead)


def kl_per_param(q, p) -> np.ndarray:
    return bern_kl(q, p).cpu().numpy()
