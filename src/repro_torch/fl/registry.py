"""Scheme registry (port of ``repro.fl.registry``): BiCompFL-GR only, so far.

A scheme is an :class:`~repro_torch.fl.engine.EngineSpec` of (uplink,
downlink, aggregator).  The reference's ``pallas_logw`` and
``segment_logw_pallas`` switches are gone: on the card the importance
weights always go through the CUDA kernels (``kernels.ops.mrc_logw`` and
``kernels.ops.segment_logw``, the codecs' defaults).
"""
from __future__ import annotations

from repro_torch.core.blocks import (AdaptiveAllocation, AdaptiveAvgAllocation,
                                     FixedAllocation)
from .channels import IndexRelayDownlink, MRCAdaptiveChannel, MRCFixedChannel
from .engine import EngineSpec, MeanModelAggregator

BICOMPFL_VARIANTS = ("GR", "GR-Reconst", "PR", "PR-SplitDL")


def bicompfl_spec(variant: str, *, allocation, n_is: int = 256, n_ul: int = 1,
                  logw_fn=None) -> EngineSpec:
    """BiCompFL-GR (paper Algorithm 1) under any of the three allocations.

    ``AdaptiveAllocation`` encodes over variable segments
    (``MRCAdaptiveChannel``); ``FixedAllocation`` and
    ``AdaptiveAvgAllocation`` over equal blocks (``MRCFixedChannel``).  The
    GR downlink relays the ``n_ul`` uplink samples, so the reference's
    ``n_dl`` (the downlink sample count of the other variants) and its
    ``participation`` (PR only) come with the variants that read them.  The
    other variants raise ``NotImplementedError`` until ported.
    """
    if variant not in BICOMPFL_VARIANTS:
        raise ValueError(variant)
    if variant != "GR":
        raise NotImplementedError(f"BiCompFL-{variant} is not ported yet "
                                  "(only GR)")
    if isinstance(allocation, AdaptiveAllocation):
        uplink = MRCAdaptiveChannel(n_is=n_is, n_samples=n_ul)
    elif isinstance(allocation, (FixedAllocation, AdaptiveAvgAllocation)):
        uplink = MRCFixedChannel(n_is=n_is, n_samples=n_ul, logw_fn=logw_fn)
    else:
        raise NotImplementedError(f"{type(allocation).__name__} is not a ported "
                                  "allocation")
    downlink = IndexRelayDownlink(n_is=n_is, n_samples=n_ul)
    return EngineSpec(uplink=uplink, downlink=downlink,
                      aggregator=MeanModelAggregator(), allocation=allocation,
                      name=f"BiCompFL-{variant}")
