"""Scheme registry (port of ``repro.fl.registry``): BiCompFL-GR only, so far.

A scheme is an :class:`~repro_torch.fl.engine.EngineSpec` of (uplink,
downlink, aggregator).  The reference's ``pallas_logw`` switch is gone: on
the card the fixed-block importance weights always go through the CUDA
``mrc_logw`` kernel (``kernels.ops.mrc_logw``, the default ``logw_fn``).
"""
from __future__ import annotations

from repro_torch.core.blocks import FixedAllocation
from .channels import IndexRelayDownlink, MRCFixedChannel
from .engine import EngineSpec, MeanModelAggregator

BICOMPFL_VARIANTS = ("GR", "GR-Reconst", "PR", "PR-SplitDL")


def bicompfl_spec(variant: str, *, allocation, n_is: int = 256, n_ul: int = 1,
                  logw_fn=None) -> EngineSpec:
    """BiCompFL-GR (paper Algorithm 1) over fixed-size blocks.

    The GR downlink relays the ``n_ul`` uplink samples, so the reference's
    ``n_dl`` (the downlink sample count of the other variants) and its
    ``participation`` (PR only) come with the variants that read them.  The
    other variants and the adaptive allocations raise
    ``NotImplementedError`` until ported.
    """
    if variant not in BICOMPFL_VARIANTS:
        raise ValueError(variant)
    if variant != "GR":
        raise NotImplementedError(f"BiCompFL-{variant} is not ported yet "
                                  "(only GR)")
    if not isinstance(allocation, FixedAllocation):
        raise NotImplementedError(f"{type(allocation).__name__} is not ported "
                                  "yet (only FixedAllocation)")
    uplink = MRCFixedChannel(n_is=n_is, n_samples=n_ul, logw_fn=logw_fn)
    downlink = IndexRelayDownlink(n_is=n_is, n_samples=n_ul)
    return EngineSpec(uplink=uplink, downlink=downlink,
                      aggregator=MeanModelAggregator(), allocation=allocation,
                      name=f"BiCompFL-{variant}")
