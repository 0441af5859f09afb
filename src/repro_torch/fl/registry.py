"""Scheme registry (port of ``repro.fl.registry``): the BiCompFL variants.

A scheme is an :class:`~repro_torch.fl.engine.EngineSpec` of (uplink,
downlink, aggregator).  The reference's ``pallas_logw`` and
``segment_logw_pallas`` switches are gone: on the card the importance
weights always go through the CUDA kernels (``kernels.ops.mrc_logw`` and
the segment encoder ``kernels.ops.segment_mrc_encode``, the codecs'
defaults).  CFL and the baselines come with later slices.
"""
from __future__ import annotations

from repro_torch.core.blocks import (AdaptiveAllocation, AdaptiveAvgAllocation,
                                     FixedAllocation)
from .channels import (IndexRelayDownlink, MRCAdaptiveChannel, MRCBroadcastDownlink,
                       MRCFixedChannel, MRCPrivateDownlink, SplitBlockDownlink)
from .engine import EngineSpec, MeanModelAggregator

BICOMPFL_VARIANTS = ("GR", "GR-Reconst", "PR", "PR-SplitDL")


def bicompfl_spec(variant: str, *, allocation, n_is: int = 256, n_ul: int = 1,
                  n_dl: int = 1, logw_fn=None, participation: float = 1.0) -> EngineSpec:
    """BiCompFL (probabilistic-mask) variants, paper Algorithms 1 & 2, under
    any of the three allocations.

    ``AdaptiveAllocation`` encodes over variable segments
    (``MRCAdaptiveChannel``); ``FixedAllocation`` and
    ``AdaptiveAvgAllocation`` over equal blocks (``MRCFixedChannel``).  GR
    and GR-Reconst draw candidates from the common round key, PR and
    PR-SplitDL from each client's private key.  ``n_dl`` (the downlink
    sample count of GR-Reconst, PR and PR-SplitDL) must be resolved by the
    caller (the paper's default is ``n_clients * n_ul``, see
    ``federator.run_bicompfl``); GR relays the ``n_ul`` uplink samples
    instead.  ``participation < 1`` needs private randomness (PR only).
    The reference's ``chunk`` is left out: it bounds the memory of the
    reference's ``vmap`` over blocks, and the port encodes a batch whole.
    """
    if variant not in BICOMPFL_VARIANTS:
        raise ValueError(variant)
    if participation < 1.0 and variant != "PR":
        raise ValueError("partial participation requires private shared "
                         "randomness (the PR variant); GR needs all clients "
                         "to track the common candidate stream, and SplitDL "
                         "partitions the downlink across the full cohort")
    shared = variant.startswith("GR")
    adaptive = isinstance(allocation, AdaptiveAllocation)
    if adaptive:
        uplink = MRCAdaptiveChannel(n_is=n_is, n_samples=n_ul, shared=shared)
    elif isinstance(allocation, (FixedAllocation, AdaptiveAvgAllocation)):
        uplink = MRCFixedChannel(n_is=n_is, n_samples=n_ul, shared=shared,
                                 logw_fn=logw_fn)
    else:
        raise NotImplementedError(f"{type(allocation).__name__} is not a ported "
                                  "allocation")
    if variant == "GR":
        downlink = IndexRelayDownlink(n_is=n_is, n_samples=n_ul)
    elif variant == "GR-Reconst":
        downlink = MRCBroadcastDownlink(n_is=n_is, n_samples=n_dl, logw_fn=logw_fn)
    elif variant == "PR":
        downlink = MRCPrivateDownlink(n_is=n_is, n_samples=n_dl, logw_fn=logw_fn)
    else:  # PR-SplitDL
        if adaptive:
            raise NotImplementedError("SplitDL is defined on fixed blocks")
        downlink = SplitBlockDownlink(n_is=n_is, n_samples=n_dl, logw_fn=logw_fn)
    return EngineSpec(uplink=uplink, downlink=downlink,
                      aggregator=MeanModelAggregator(), allocation=allocation,
                      participation=participation, name=f"BiCompFL-{variant}")
