"""Block allocation for MRC (port of ``repro.core.blocks``, host plans).

* ``FixedAllocation``       -- constant block size d/B across rounds.
* ``AdaptiveAvgAllocation`` -- equal block sizes, the (single) size re-tuned
  each round so that the *average* KL per block tracks log(n_is); sizes are
  powers of two in [min_block, max_block].
* ``AdaptiveAllocation``    -- variable boundaries with (approximately)
  equal KL mass per block; boundaries are a segment-id vector.

``plan`` is the host control plane: numpy on the round's KL statistic, as
in the reference.  The bucket API is the fused path's counterpart, in
torch on the round's device, so that a captured round never leaves it:

* ``bucket_plans(d)`` -- a small static set of :class:`BlockPlan`
  templates (one captured graph each on the card);
* ``select_bucket(stats, d)`` -- the template's index, a 0-d int32 tensor,
  from the round's KL statistics (``{"profile", "total"}``);
* ``finalize_plan(template, stats, d)`` -- the template with its
  data-dependent pieces filled in on the device (segment ids, the billable
  segment count and the side information), no shape changed.

Each is the reference's expression for expression, in float32, so that the
port picks the reference's bucket and segment ids: ``finalize_plan``'s
cumulative sum adds in the order XLA's CPU scan adds (``scan_cumsum``) and
its bin edges come from jax's binary search (``searchsorted_left``); both
run the same float adds on the CPU and the card.

``encode_plan(plan, w)`` / ``decode_plan(r, d)`` are the plan's wire codec
(``repro_torch.wire``): the CTRL header that a wire-audited host round
sends each client, exactly the booked ``overhead_bits`` long.  They take a
host plan (numpy segment ids).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .bernoulli import bern_kl


def _pad_to(d: int, block: int) -> int:
    return -(-d // block) * block


def scan_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The float32 ``jnp.cumsum`` of a vector, in the order XLA's CPU backend
    adds: a blocked scan of base 16 -- sequential prefix sums inside blocks of
    16 (the last one zero-padded), the block totals scanned by the same rule,
    and the exclusive prefix of those totals added back.  Neither
    ``torch.cumsum`` nor one sequential sum rounds that way; this does, on
    the CPU and on the card alike (the same float adds in the same order)."""
    n = x.shape[0]
    xb = torch.nn.functional.pad(x, (0, -(-n // 16) * 16 - n)).reshape(-1, 16)
    cols = [xb[:, 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + xb[:, j])
    inc = torch.stack(cols, dim=1)
    if inc.shape[0] > 1:
        totals = scan_cumsum(inc[:, -1])
        inc = inc + torch.cat([totals.new_zeros(1), totals[:-1]])[:, None]
    return inc.reshape(-1)[:n]


def searchsorted_left(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(a, v)`` (side "left", jax's default ``scan``
    method): ceil(log2(len(a) + 1)) halving steps, each going left where
    ``v <= a[mid]``.  The same steps as jax's, so the same indices even
    where ``a`` is not quite sorted (a cumulative KL can step back by an ulp
    where a term rounds below 0); int64, on ``a``'s device."""
    n = a.shape[0]
    low = torch.zeros(v.shape, dtype=torch.int64, device=a.device)
    high = torch.full(v.shape, n, dtype=torch.int64, device=a.device)
    for _ in range(math.ceil(math.log2(n + 1))):
        mid = (low + high) // 2
        left = v <= a[mid]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device: a division by it rounds
    once on both devices (torch divides a Python number by a tensor as a
    reciprocal and a multiply)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _recip32(c: float, like: torch.Tensor) -> torch.Tensor:
    """float32(1) / float32(c) on ``like``'s device.  XLA compiles a division
    by a constant into a multiply by this reciprocal, so ``x / c`` in the
    reference is ``x * _recip32(c)`` here."""
    return _f32(float(np.float32(1.0) / np.float32(c)), like)


@dataclass(frozen=True)
class BlockPlan:
    """One round's block-allocation decision.

    Host control plane: ``seg_ids`` is a numpy array (adaptive plans) or
    None; ``overhead_bits`` and ``billable_blocks`` are Python numbers.
    Fused control plane (``finalize_plan``): ``seg_ids`` is an int32 tensor
    on the round's device, and ``overhead_bits`` / ``billable_blocks`` are
    0-d int32 tensors there; only ``size`` and ``n_blocks`` fix shapes.
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
    static_plan = True  # round-independent: eligible for the fused path

    def blocks_for(self, d: int) -> int:
        return _pad_to(d, self.block_size) // self.block_size

    def plan(self, kl_per_param, d: int):
        """Return (block_size, n_blocks, seg_ids=None, overhead_bits)."""
        return self.block_size, self.blocks_for(d), None, 0.0

    # -- wire codec: the plan is static config, zero bits cross the wire --
    def encode_plan(self, plan: "BlockPlan", w) -> None:
        pass

    def decode_plan(self, r, d: int) -> "BlockPlan":
        return BlockPlan(size=self.block_size, n_blocks=self.blocks_for(d),
                         seg_ids=None, overhead_bits=0.0)


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
    static_plan = False       # per-round size retuning ...
    needs_profile = False     # ... but only the *mean* KL is consumed

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

    # -- wire codec: the pow2 size exponent, exactly the booked overhead --
    def encode_plan(self, plan: "BlockPlan", w) -> None:
        from repro_torch.wire import codecs as wcodecs
        wcodecs.put_plan_avg(w, plan.size, self.max_block)

    def decode_plan(self, r, d: int) -> "BlockPlan":
        from repro_torch.wire import codecs as wcodecs
        size = wcodecs.get_plan_avg(r, self.max_block)
        return BlockPlan(size=size, n_blocks=_pad_to(d, size) // size, seg_ids=None,
                         overhead_bits=math.ceil(math.log2(self.max_block)))

    # -- bucketed (fused) control plane -----------------------------------

    def bucket_sizes(self) -> Tuple[int, ...]:
        lo = int(math.log2(self.min_block))
        hi = int(math.log2(self.max_block))
        return tuple(2 ** k for k in range(lo, hi + 1))

    def bucket_plans(self, d: int):
        overhead = float(math.ceil(math.log2(self.max_block)))
        return [BlockPlan(size=s, n_blocks=_pad_to(d, s) // s, seg_ids=None,
                          overhead_bits=overhead)
                for s in self.bucket_sizes()]

    def select_bucket(self, stats, d: int) -> torch.Tensor:
        """The bucket index from the round's total KL, as ``plan`` picks its
        size (the same target and pow2 rounding) in float32."""
        total = stats["total"]
        # XLA contracts ``total / d + 1e-12`` into one FMA of the reciprocal:
        # the float64 product of two floats is exact, rounded once more.
        mean_kl = (total.double() * float(np.float32(1.0) / np.float32(d))
                   + float(np.float32(1e-12))).float()
        size = torch.clamp(_f32(self.target_ratio * math.log(self.n_is), total) / mean_kl,
                           min=1.0)
        lo = math.log2(self.min_block)
        k = torch.clamp(torch.round(torch.log2(size)), lo, math.log2(self.max_block))
        return (k - lo).to(torch.int32)

    def finalize_plan(self, template: BlockPlan, stats, d: int) -> BlockPlan:
        return template  # nothing data-dependent beyond the size choice


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
    static_plan = False
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

    # -- wire codec: one (length - 1) field per billable segment ----------
    # The cold-start plan (no KL profile yet) books zero overhead, so it
    # writes zero bits; the decoder detects the empty header and rebuilds
    # the deterministic fixed-256 fallback from ``d`` alone.

    def _cold_plan(self, d: int) -> "BlockPlan":
        size = 256
        n_blocks = _pad_to(d, size) // size
        seg = np.minimum(np.arange(d) // size, n_blocks - 1).astype(np.int32)
        return BlockPlan(size=None, n_blocks=n_blocks, seg_ids=seg, overhead_bits=0.0)

    def encode_plan(self, plan: "BlockPlan", w) -> None:
        from repro_torch.wire import codecs as wcodecs
        if plan.overhead_bits:
            wcodecs.put_plan_segments(w, plan.seg_ids, self.max_block)

    def decode_plan(self, r, d: int) -> "BlockPlan":
        from repro_torch.wire import codecs as wcodecs
        if r.bits_left == 0:
            return self._cold_plan(d)
        seg = wcodecs.get_plan_segments(r, d, self.max_block)
        n_seg = int(seg[-1]) + 1
        overhead = n_seg * math.ceil(math.log2(self.max_block))
        return BlockPlan(size=None, n_blocks=n_seg, seg_ids=seg, overhead_bits=float(overhead))

    # -- bucketed (fused) control plane -----------------------------------

    def bucket_grid(self, d: int) -> Tuple[int, ...]:
        """Block-count grid: ratio 2 from ``min_blocks`` up to the cap."""
        cap = self._cap(d)
        grid = []
        b = self.min_blocks
        while b < cap:
            grid.append(b)
            b *= 2
        grid.append(cap)
        return tuple(grid)

    def bucket_plans(self, d: int):
        overhead = float(math.ceil(math.log2(self.max_block)))
        return [BlockPlan(size=None, n_blocks=nb, seg_ids=None, overhead_bits=nb * overhead)
                for nb in self.bucket_grid(d)]

    def select_bucket(self, stats, d: int) -> torch.Tensor:
        """The index of the largest bucket <= the exact block count: the
        number of grid entries <= the clipped count, less one (jax's
        ``searchsorted(grid, nb, side="right") - 1`` on a sorted grid)."""
        total = stats["total"] + 1e-12
        per_target = _recip32(self.target_ratio * math.log(self.n_is), total)
        nb = torch.clamp(torch.ceil(total * per_target), self.min_blocks, self._cap(d))
        grid = self.bucket_grid(d)
        idx = sum((nb >= float(g)).to(torch.int32) for g in grid) - 1
        return torch.clamp(idx, 0, len(grid) - 1).to(torch.int32)

    def finalize_plan(self, template: BlockPlan, stats, d: int) -> BlockPlan:
        """Equal-KL-mass binning into the bucket's block count, on the
        device.  Duplicate bin edges collapse (a scatter of 1, as the
        reference's ``.at[edges].set(1)``), so the billable count
        ``seg[-1] + 1`` -- what the channels bill -- may fall below the
        template's capacity, and segment 0 is empty when the first edge is
        0.  The ids are non-decreasing by construction."""
        klp = stats["profile"]
        nb = template.n_blocks
        cum = scan_cumsum(klp)
        total = cum[-1] + 1e-12
        targets = total * torch.arange(1, nb, dtype=torch.float32, device=klp.device) \
            * _recip32(nb, klp)
        edges = torch.clamp(searchsorted_left(cum, targets), 0, d - 1)
        seg = torch.zeros(d, dtype=torch.int32, device=klp.device).index_fill_(0, edges, 1)
        seg = torch.cumsum(seg, 0, dtype=torch.int32)
        billable = seg[-1] + 1
        return BlockPlan(size=None, n_blocks=nb, seg_ids=seg,
                         overhead_bits=billable * math.ceil(math.log2(self.max_block)),
                         billable_blocks=billable)


def kl_per_param(q, p) -> np.ndarray:
    return bern_kl(q, p).cpu().numpy()
