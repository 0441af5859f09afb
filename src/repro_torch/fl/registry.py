"""Scheme registry (port of ``repro.fl.registry``): config -> (uplink,
downlink, aggregator) factories.

Every named FL scheme is a factory returning an
:class:`~repro_torch.fl.engine.EngineSpec`: the four BiCompFL variants,
BiCompFL-GR-CFL and the seven conventional-FL baselines.  The reference's
``pallas_logw`` and ``segment_logw_pallas`` switches are gone: on the card
the encoders always go through the CUDA kernels (the fused encoders
``kernels.ops.mrc_fixed_encode`` and ``kernels.ops.segment_mrc_encode``,
the codecs' defaults).  ``wire_scheme_ids`` (the frame-header scheme id
of every scheme) and ``fault_matrix`` (one scheme per uplink family, for
fault-injection sweeps) are the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.blocks import (AdaptiveAllocation, AdaptiveAvgAllocation,
                                     FixedAllocation)
from repro_torch.core.quantizers import FLOAT_BITS
from .channels import (DenseChannel, IndexRelayDownlink, MRCAdaptiveChannel,
                       MRCBroadcastDownlink, MRCFixedChannel, MRCPrivateDownlink,
                       QuantizedMRCUplink, SignEFChannel, SliceDownlink,
                       SplitBlockDownlink, TopKEFChannel)
from .engine import EngineSpec, MeanDeltaAggregator, MeanModelAggregator

BICOMPFL_VARIANTS = ("GR", "GR-Reconst", "PR", "PR-SplitDL")


def bicompfl_spec(variant: str, *, allocation, n_is: int = 256, n_ul: int = 1,
                  n_dl: int = 1, participation: float = 1.0) -> EngineSpec:
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
        uplink = MRCFixedChannel(n_is=n_is, n_samples=n_ul, shared=shared)
    else:
        raise NotImplementedError(f"{type(allocation).__name__} is not a ported "
                                  "allocation")
    if variant == "GR":
        downlink = IndexRelayDownlink(n_is=n_is, n_samples=n_ul)
    elif variant == "GR-Reconst":
        downlink = MRCBroadcastDownlink(n_is=n_is, n_samples=n_dl)
    elif variant == "PR":
        downlink = MRCPrivateDownlink(n_is=n_is, n_samples=n_dl)
    else:  # PR-SplitDL
        if adaptive:
            raise NotImplementedError("SplitDL is defined on fixed blocks")
        downlink = SplitBlockDownlink(n_is=n_is, n_samples=n_dl)
    return EngineSpec(uplink=uplink, downlink=downlink,
                      aggregator=MeanModelAggregator(), allocation=allocation,
                      participation=participation, name=f"BiCompFL-{variant}")


def cfl_spec(*, n_is: int = 256, n_ul: int = 1, block_size: int = 16,
             server_lr: float = 1.0) -> EngineSpec:
    """BiCompFL-GR-CFL: stochastic sign + MRC in conventional FL (Sec. 4).

    The uplink conveys each client's quantized delta against the Ber(1/2)
    prior on common candidates; the downlink relays the indices and the
    temperatures K (32 bits each), so every client tracks the same model.
    """
    return EngineSpec(
        uplink=QuantizedMRCUplink(n_is=n_is, n_samples=n_ul),
        downlink=IndexRelayDownlink(n_is=n_is, n_samples=n_ul, side_info_bits=FLOAT_BITS),
        aggregator=MeanDeltaAggregator(server_lr),
        allocation=FixedAllocation(block_size),
        name="BiCompFL-GR-CFL")


# ---------------------------------------------------------------------------
# Non-stochastic baselines (paper Section 4), simplified as in the reference
# (DESIGN.md).
# ---------------------------------------------------------------------------


def _fedavg(n, d, lr, period):
    return EngineSpec(DenseChannel(), DenseChannel(), MeanDeltaAggregator(lr),
                      name="fedavg")


def _memsgd(n, d, lr, period):
    return EngineSpec(SignEFChannel(), DenseChannel(), MeanDeltaAggregator(lr),
                      name="memsgd")


def _doublesqueeze(n, d, lr, period):
    return EngineSpec(SignEFChannel(), SignEFChannel(), MeanDeltaAggregator(lr),
                      name="doublesqueeze")


def _neolithic(n, d, lr, period):
    return EngineSpec(SignEFChannel(passes=2), SignEFChannel(passes=2),
                      MeanDeltaAggregator(lr), name="neolithic")


def _cser(n, d, lr, period):
    return EngineSpec(SignEFChannel(), DenseChannel(), MeanDeltaAggregator(lr),
                      sync_period=period, name="cser")


def _liec(n, d, lr, period):
    return EngineSpec(SignEFChannel(), SignEFChannel(), MeanDeltaAggregator(lr),
                      sync_period=period, name="liec")


def _m3(n, d, lr, period):
    k = max(d // n, 1)  # one budget shared by the top-k uplink and the slices
    return EngineSpec(TopKEFChannel(k=k), SliceDownlink(k=k),
                      MeanDeltaAggregator(lr), name="m3")


BASELINE_BUILDERS: Dict[str, Callable[[int, int, float, int], EngineSpec]] = {
    "fedavg": _fedavg,
    "memsgd": _memsgd,
    "doublesqueeze": _doublesqueeze,
    "neolithic": _neolithic,
    "cser": _cser,
    "liec": _liec,
    "m3": _m3,
}

ALL_BASELINES = tuple(BASELINE_BUILDERS)


def baseline_spec(scheme: str, *, n: int, d: int, server_lr: float = 1.0,
                  reset_period: int = 50) -> EngineSpec:
    """A baseline's EngineSpec; needs the cohort size and the model
    dimension (M3's top-k budget is d/n).  ``reset_period`` is the EF sync
    period of CSER and LIEC."""
    key = scheme.lower()
    if key not in BASELINE_BUILDERS:
        raise ValueError(scheme)
    return BASELINE_BUILDERS[key](n, d, server_lr, reset_period)


def all_schemes(*, n: int, d: int, n_is: int = 16, block: int = 64,
                n_dl: int = None, server_lr: float = 1.0,
                reset_period: int = 50, include_adaptive: bool = False):
    """Every named scheme as ``(name, task_kind, spec_factory)`` triples, in
    the reference's order.

    ``task_kind`` is "mask" (probabilistic-mask BiCompFL) or "delta"
    (conventional FL: BiCompFL-CFL and the baselines).  Factories build a
    fresh spec per call.  ``include_adaptive=True`` adds the KL-driven
    allocations (the segment codec on GR and PR, and GR under
    Adaptive-Avg).
    """
    ndl = n if n_dl is None else n_dl
    out = []
    for v in BICOMPFL_VARIANTS:
        out.append((f"bicompfl-{v.lower()}", "mask",
                    lambda v=v: bicompfl_spec(v, allocation=FixedAllocation(block),
                                              n_is=n_is, n_dl=ndl)))
    if include_adaptive:
        out.append(("bicompfl-gr-adaptive", "mask",
                    lambda: bicompfl_spec("GR", allocation=AdaptiveAllocation(n_is=n_is),
                                          n_is=n_is, n_dl=ndl)))
        out.append(("bicompfl-pr-adaptive", "mask",
                    lambda: bicompfl_spec("PR", allocation=AdaptiveAllocation(n_is=n_is),
                                          n_is=n_is, n_dl=ndl)))
        out.append(("bicompfl-gr-adaptive-avg", "mask",
                    lambda: bicompfl_spec(
                        "GR", allocation=AdaptiveAvgAllocation(
                            n_is=n_is, min_block=block // 2, max_block=8 * block),
                        n_is=n_is, n_dl=ndl)))
    out.append(("bicompfl-cfl", "delta",
                lambda: cfl_spec(n_is=n_is, block_size=16, server_lr=server_lr)))
    for s in ALL_BASELINES:
        out.append((s, "delta",
                    lambda s=s: baseline_spec(s, n=n, d=d, server_lr=server_lr,
                                              reset_period=reset_period)))
    return out


def wire_scheme_ids(*, n: int = 4, d: int = 64) -> Dict[str, int]:
    """Frame-header scheme ids for the full registry matrix.

    The engine stamps ``scheme_wire_id(spec.name)`` into every message of a
    wire-audited run; this enumerates the id of each registry scheme and
    fails loudly if two distinct spec names ever hash to the same 16-bit id.
    """
    from repro_torch.wire import scheme_wire_id
    ids: Dict[str, int] = {}
    by_id: Dict[int, str] = {}
    for _, _, factory in all_schemes(n=n, d=d, include_adaptive=True):
        name = factory().name
        wid = scheme_wire_id(name)
        if by_id.get(wid, name) != name:
            raise ValueError(f"wire scheme-id collision: {name!r} and {by_id[wid]!r} "
                             f"both hash to {wid:#06x}")
        by_id[wid] = name
        ids[name] = wid
    return ids


def fault_matrix(*, n: int, d: int, n_is: int = 16, block: int = 64,
                 n_dl: int = None, reset_period: int = 2):
    """One scheme per uplink channel family, for fault-injection sweeps.

    The fault machinery's degradation paths split by channel *family*, not
    by scheme, so each family is covered once:

    * ``bicompfl-pr``  -- MRC fixed-block uplink + client-specific
      (``downlink_recipients="active"``) MRC private downlink;
    * ``bicompfl-cfl`` -- quantized-MRC delta uplink, broadcast downlink;
    * ``doublesqueeze`` -- sign compression with error feedback on both
      links (EF rows must be carried for dropped clients);
    * ``m3``           -- top-k EF uplink;
    * ``fedavg``       -- dense float uplink, the no-compression control.

    Same ``(name, task_kind, factory)`` triples as :func:`all_schemes`.
    """
    ndl = n if n_dl is None else n_dl
    return [
        ("bicompfl-pr", "mask",
         lambda: bicompfl_spec("PR", allocation=FixedAllocation(block), n_is=n_is, n_dl=ndl)),
        ("bicompfl-cfl", "delta", lambda: cfl_spec(n_is=n_is, block_size=16)),
        ("doublesqueeze", "delta",
         lambda: baseline_spec("doublesqueeze", n=n, d=d, reset_period=reset_period)),
        ("m3", "delta", lambda: baseline_spec("m3", n=n, d=d, reset_period=reset_period)),
        ("fedavg", "delta",
         lambda: baseline_spec("fedavg", n=n, d=d, reset_period=reset_period)),
    ]
