"""Communication channels for the FL engine (port of ``repro.fl.channels``).

Each direction is a channel object that encodes what one party sends, what
the other reconstructs, and how many bits crossed the wire.  Uplinks
implement::

    step_up(ctx, state, payload, priors) -> (server_side_estimates, bits, state)

and downlinks::

    step_down(ctx, state, update, theta, theta_hat) -> (DownlinkResult, state)

with ``transmit`` / ``distribute`` as the stateless object shell.  Bits are
computed from shapes and the round's :class:`BlockPlan`, as Python floats.

This port holds BiCompFL-GR's channels: ``MRCFixedChannel`` (MRC uplink
over fixed blocks), ``MRCAdaptiveChannel`` (MRC uplink over the variable
segments of an adaptive plan), both on shared candidates, and
``IndexRelayDownlink``.  The wire codecs (``encode_up``, ``decode_up`` and
friends) and the fused path's ``pin`` come later.

The key-derivation tags are the reference's, so both packages draw the same
candidates and selections in every round.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import mrc
from repro_torch.core.bernoulli import clip01
from repro_torch.core.blocks import BlockPlan  # noqa: F401  (travels with the API)

# ---------------------------------------------------------------------------
# Key-derivation tags (shared-randomness schedule, identical to the reference).
# ---------------------------------------------------------------------------

TAG_TRAIN = 1          # per-round local-training keys
TAG_UL_SELECT = 2      # uplink Gumbel selection stream
TAG_DL_SHARED = 3      # downlink candidate stream
TAG_DL_SELECT_COMMON = 4   # downlink selection, common (GR-Reconst)
TAG_DL_SELECT_PRIVATE = 5  # downlink selection, per-client (PR variants)
TAG_COHORT = 6         # key-derived cohort sampling (not ported yet)

# State of a stateless channel.
EMPTY_STATE: Tuple = ()


def _vfold(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """fold_in(key, i) for every client id i -> stacked keys (n, 2)."""
    return prng.fold_in(key, ids)


# ---------------------------------------------------------------------------
# Block helpers.  Pad value 0.5 for BOTH q and p => padded entries have zero
# KL and never influence the selected index.  Batched over leading dims.
# ---------------------------------------------------------------------------


def to_blocks(v: torch.Tensor, size: int) -> torch.Tensor:
    d = v.shape[-1]
    b = -(-d // size)
    pad = b * size - d
    if pad:
        v = torch.cat([v, v.new_full(v.shape[:-1] + (pad,), 0.5)], dim=-1)
    return v.reshape(v.shape[:-1] + (b, size))


def from_blocks(m: torch.Tensor, d: int) -> torch.Tensor:
    return m.reshape(m.shape[:-2] + (-1,))[..., :d]


# ---------------------------------------------------------------------------
# Round context / server update.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RoundContext:
    """Everything a channel may need about the current global round."""

    t: int
    key: torch.Tensor     # kt = mrc.round_key(base, t) -- shared randomness
    n_clients: int
    d: int
    active: Any           # sorted global ids of the participating cohort
    plan: Optional[BlockPlan] = None

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def active_ids(self) -> torch.Tensor:
        return torch.as_tensor(self.active, dtype=torch.int64, device=self.key.device)


@dataclass(frozen=True)
class ServerUpdate:
    """Aggregator output: the proposed next server model.  BiCompFL works
    in model space, so the aggregate *is* the new model (the delta-space
    fields of the reference's baselines come with those schemes)."""

    theta: torch.Tensor


class DownlinkResult(NamedTuple):
    theta: torch.Tensor      # final server model after the downlink
    theta_hat: torch.Tensor  # (n_clients, d) client estimates
    bits: float


# ---------------------------------------------------------------------------
# Shells: the object API over the pure step functions.
# ---------------------------------------------------------------------------


class StatelessUplink:
    """Object shell + trivial state for uplinks without memory."""

    def init_up_state(self, n: int, d: int):
        return EMPTY_STATE

    def transmit(self, ctx, payload, priors):
        out, bits, _ = self.step_up(ctx, EMPTY_STATE, payload, priors)
        return out, bits


class StatelessDownlink:
    """Object shell + trivial state for downlinks without memory."""

    def init_down_state(self, n: int, d: int):
        return EMPTY_STATE

    def distribute(self, ctx, update, theta, theta_hat):
        res, _ = self.step_down(ctx, EMPTY_STATE, update, theta, theta_hat)
        return res


# ---------------------------------------------------------------------------
# MRC uplink over fixed-size blocks (the paper's C_mrc).
# ---------------------------------------------------------------------------


@dataclass
class MRCFixedChannel(StatelessUplink):
    """Uplink MRC over fixed-size blocks, batched across the cohort.

    GR: every client draws its candidates from the *common* round key (the
    PR variants' private keys come with those variants).  The cohort's
    blocks are encoded in one batch: one ``logw_fn`` call (one kernel launch
    on the card) per round and conveyed sample.
    """

    n_is: int = 256
    n_samples: int = 1
    logw_fn: Any = None

    def _transmit(self, ctx, payload, priors):
        """Returns (indices (n_act, n_samples, B), q_hat (n_act, d), bits)."""
        plan = ctx.plan
        kt = ctx.key
        qb = to_blocks(clip01(payload), plan.size)   # (n_act, B, S)
        pb = to_blocks(clip01(priors), plan.size)
        sels = _vfold(prng.fold_in(kt, TAG_UL_SELECT), ctx.active_ids)
        idxs, q_hat_b = mrc.transmit_fixed(
            kt, sels, qb, pb, n_is=self.n_is, n_samples=self.n_samples,
            logw_fn=self.logw_fn)
        bits = ctx.n_active * self.n_samples * plan.billable * math.log2(self.n_is)
        return idxs, from_blocks(q_hat_b, ctx.d), bits

    def step_up(self, ctx, state, payload, priors):
        _, q_hat, bits = self._transmit(ctx, payload, priors)
        return q_hat, bits, state


# ---------------------------------------------------------------------------
# MRC uplink over variable-size segments (adaptive allocation).
# ---------------------------------------------------------------------------


@dataclass
class MRCAdaptiveChannel(StatelessUplink):
    """Uplink MRC over variable-size segments (Isik et al. 2024 allocation).

    GR: every client's candidates come from the common round key, so the
    whole cohort's segment encode per conveyed sample is one
    ``ops.segment_mrc_encode`` call (on the card one kernel, which draws
    the candidates in place).  A ``seg_logw_fn`` (as in the reference)
    takes the unfused route instead: one ``(n_is, d)`` draw, weighed by it.
    """

    n_is: int = 256
    n_samples: int = 1
    seg_logw_fn: Any = None

    def _transmit(self, ctx, payload, priors):
        """Returns (indices (n_act, n_samples, n_seg), q_hat (n_act, d), bits)."""
        plan = ctx.plan
        kt = ctx.key
        sels = _vfold(prng.fold_in(kt, TAG_UL_SELECT), ctx.active_ids)
        idxs, q_hat = mrc.transmit_segments(
            kt, sels, clip01(payload), clip01(priors), plan.seg_ids, n_is=self.n_is,
            n_seg=plan.n_blocks, n_samples=self.n_samples, seg_logw_fn=self.seg_logw_fn)
        bits = ctx.n_active * self.n_samples * plan.billable * math.log2(self.n_is)
        return idxs, q_hat, bits

    def step_up(self, ctx, state, payload, priors):
        _, q_hat, bits = self._transmit(ctx, payload, priors)
        return q_hat, bits, state


# ---------------------------------------------------------------------------
# BiCompFL-GR downlink.
# ---------------------------------------------------------------------------


@dataclass
class IndexRelayDownlink(StatelessDownlink):
    """GR downlink: relay the other clients' uplink indices.

    With common candidates every client reconstructs the identical global
    model, so nothing is recomputed -- only the bits are booked: each client
    receives the (n-1) other clients' index streams.
    """

    n_is: int = 256
    n_samples: int = 1           # relayed samples per client (n_UL)
    broadcast_shareable: bool = True

    def step_down(self, ctx, state, update, theta, theta_hat):
        n = ctx.n_clients
        th = update.theta
        bits = n * (n - 1) * (self.n_samples * ctx.plan.billable
                              * math.log2(self.n_is))
        return DownlinkResult(th, th[None].repeat(n, 1), bits), state
