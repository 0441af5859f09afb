"""Block allocation for MRC (port of ``repro.core.blocks``, fixed path).

Only ``FixedAllocation`` is ported so far: a constant block size d/B across
rounds.  The adaptive allocations (``AdaptiveAvgAllocation``,
``AdaptiveAllocation``) and their bucketed plans come with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


def _pad_to(d: int, block: int) -> int:
    return -(-d // block) * block


@dataclass(frozen=True)
class BlockPlan:
    """One round's block-allocation decision (host control plane)."""

    size: Optional[int]            # fixed block size (None for segment codec)
    n_blocks: int                  # number of blocks (static shapes)
    seg_ids: Any                   # per-parameter segment ids (adaptive only)
    overhead_bits: Any             # side information per client

    @property
    def billable(self):
        """Blocks that cross the wire; channels bill this.  Every fixed block
        does (an adaptive plan's billable count comes with those plans)."""
        return self.n_blocks


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
