"""Communication channels for the FL engine (port of ``repro.fl.channels``).

Each direction is a channel object that encodes what one party sends, what
the other reconstructs, and how many bits crossed the wire.  Uplinks
implement::

    step_up(ctx, state, payload, priors) -> (server_side_estimates, bits, state)

and downlinks::

    step_down(ctx, state, update, theta, theta_hat) -> (DownlinkResult, state)

with the state made by ``init_up_state`` / ``init_down_state`` and carried
by the engine; the stateful (error-feedback) channels also implement
``flush_step(state, n, d) -> (residual, bits, state)`` for the periodic
sync.  Bits are computed from shapes and the round's :class:`BlockPlan`,
as Python numbers.

This port holds the channels of the four BiCompFL variants:
``MRCFixedChannel`` (MRC uplink over fixed blocks) and
``MRCAdaptiveChannel`` (MRC uplink over the variable segments of an
adaptive plan), each on shared (GR) or private (PR) candidates;
``IndexRelayDownlink`` (GR), ``MRCBroadcastDownlink`` (GR-Reconst),
``MRCPrivateDownlink`` (PR) and ``SplitBlockDownlink`` (PR-SplitDL).  It
also holds BiCompFL-GR-CFL's ``QuantizedMRCUplink`` (stochastic sign +
MRC against the Ber(1/2) prior) and the baselines' channels:
``DenseChannel``, ``SignEFChannel`` (sign + error feedback, also
Neolithic's repeated passes), ``TopKEFChannel`` and ``SliceDownlink``
(M3).  Those are step functions only: the reference's object shells that
keep the error-feedback memory in the channel (``transmit`` /
``distribute`` / ``flush`` / ``export_state`` on the EF channels), the
wire codecs (``encode_up``, ``decode_up`` and friends, ``flush_wire``) come
later.  The reference's ``pin`` is not needed: the port's fused path
replays the very kernels its host loop launches, so nothing is contracted
across stage boundaries.  Every channel also runs inside a captured CUDA
graph: no host copy, no host read, the cohort (``ctx.active``) and the plan
of a fused round already on the device.

The key-derivation tags are the reference's, so both packages draw the same
candidates and selections in every round.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mrc
from repro_torch.core.bernoulli import clip01
from repro_torch.core.blocks import BlockPlan  # noqa: F401  (travels with the API)
from repro_torch.core.quantizers import (FLOAT_BITS, mean_abs, sign_compress, stochastic_sign,
                                         topk_bits, topk_compress)

# ---------------------------------------------------------------------------
# Key-derivation tags (shared-randomness schedule, identical to the reference).
# ---------------------------------------------------------------------------

TAG_TRAIN = 1          # per-round local-training keys
TAG_UL_SELECT = 2      # uplink Gumbel selection stream
TAG_DL_SHARED = 3      # downlink candidate stream
TAG_DL_SELECT_COMMON = 4   # downlink selection, common (GR-Reconst)
TAG_DL_SELECT_PRIVATE = 5  # downlink selection, per-client (PR variants)
TAG_COHORT = 6         # key-derived cohort sampling (engine, cohort_rng="jax")

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
        """The cohort as an int64 tensor on the key's device: the fused path
        passes it there already (no copy), the host loop a numpy row."""
        return torch.as_tensor(self.active, dtype=torch.int64, device=self.key.device)


@dataclass(frozen=True)
class ServerUpdate:
    """Aggregator output: the proposed next server model.

    ``delta`` carries the aggregate update direction of delta-space schemes
    (``theta = theta_prev - lr * delta``: CFL and the baselines); it is None
    for model-space schemes (BiCompFL), whose aggregate *is* the new model.
    """

    theta: torch.Tensor
    delta: Optional[torch.Tensor] = None
    lr: float = 1.0


class DownlinkResult(NamedTuple):
    theta: torch.Tensor      # final server model after the downlink
    theta_hat: torch.Tensor  # (n_clients, d) client estimates
    bits: float


# ---------------------------------------------------------------------------
# Shells: the object API over the pure step functions.
# ---------------------------------------------------------------------------


class StatelessUplink:
    """Object shell + trivial state for uplinks without memory."""

    def init_up_state(self, n: int, d: int, device):
        return EMPTY_STATE

    def transmit(self, ctx, payload, priors):
        out, bits, _ = self.step_up(ctx, EMPTY_STATE, payload, priors)
        return out, bits

    def flush_step(self, state, n: int, d: int):
        return 0.0, 0.0, state


class StatelessDownlink:
    """Object shell + trivial state for downlinks without memory."""

    def init_down_state(self, n: int, d: int, device):
        return EMPTY_STATE

    def distribute(self, ctx, update, theta, theta_hat):
        res, _ = self.step_down(ctx, EMPTY_STATE, update, theta, theta_hat)
        return res

    def flush_step(self, state, n: int, d: int):
        return 0.0, 0.0, state


# ---------------------------------------------------------------------------
# MRC uplink over fixed-size blocks (the paper's C_mrc).
# ---------------------------------------------------------------------------


@dataclass
class MRCFixedChannel(StatelessUplink):
    """Uplink MRC over fixed-size blocks, batched across the cohort.

    ``shared=True`` (GR): every client draws its candidates from the
    *common* round key; ``shared=False`` (PR): client i from its private
    ``client_key(kt, i)``.  The cohort's blocks are encoded in one batch:
    one ``ops.mrc_fixed_encode`` call (one kernel launch on the card, which
    draws the candidates in place) per round and conveyed sample.
    """

    n_is: int = 256
    n_samples: int = 1
    shared: bool = True

    def _transmit(self, ctx, payload, priors):
        """Returns (indices (n_act, n_samples, B), q_hat (n_act, d), bits)."""
        plan = ctx.plan
        kt = ctx.key
        qb = to_blocks(clip01(payload), plan.size)   # (n_act, B, S)
        pb = to_blocks(clip01(priors), plan.size)
        sels = _vfold(prng.fold_in(kt, TAG_UL_SELECT), ctx.active_ids)
        skey = kt if self.shared else mrc.client_key(kt, ctx.active_ids)
        idxs, q_hat_b = mrc.transmit_fixed(
            skey, sels, qb, pb, n_is=self.n_is, n_samples=self.n_samples)
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

    The whole cohort's segment encode per conveyed sample is one
    ``ops.segment_mrc_encode`` call (on the card one kernel, which draws
    the candidates in place): from the common round key (``shared=True``,
    GR), or client i's from its private ``client_key(kt, i)``
    (``shared=False``, PR).  A ``seg_logw_fn`` (as in the reference) takes
    the unfused route instead: the ``(n_is, d)`` candidates drawn (once per
    client under private keys) and weighed by it.
    """

    n_is: int = 256
    n_samples: int = 1
    shared: bool = True
    seg_logw_fn: Any = None

    def _transmit(self, ctx, payload, priors):
        """Returns (indices (n_act, n_samples, n_seg), q_hat (n_act, d), bits)."""
        plan = ctx.plan
        kt = ctx.key
        sels = _vfold(prng.fold_in(kt, TAG_UL_SELECT), ctx.active_ids)
        skey = kt if self.shared else mrc.client_key(kt, ctx.active_ids)
        idxs, q_hat = mrc.transmit_segments(
            skey, sels, clip01(payload), clip01(priors), plan.seg_ids, n_is=self.n_is,
            n_seg=plan.n_blocks, n_samples=self.n_samples, seg_logw_fn=self.seg_logw_fn)
        bits = ctx.n_active * self.n_samples * plan.billable * math.log2(self.n_is)
        return idxs, q_hat, bits

    def step_up(self, ctx, state, payload, priors):
        _, q_hat, bits = self._transmit(ctx, payload, priors)
        return q_hat, bits, state


# ---------------------------------------------------------------------------
# BiCompFL-GR-CFL uplink: stochastic sign + MRC in conventional FL.
# ---------------------------------------------------------------------------


@dataclass
class QuantizedMRCUplink(StatelessUplink):
    """Conventional-FL uplink: stochastic sign -> MRC vs the Ber(1/2) prior.

    Each client maps its delta to a Bernoulli posterior q = sigmoid(delta/K)
    with per-client temperature K = mean|delta| (32-bit side information),
    conveys ``n_samples`` MRC samples against the uninformative prior on
    the common round key's candidates, and the server reconstructs the
    direction (2*q_hat - 1) * K.  The whole cohort is one batched encode:
    one ``ops.mrc_fixed_encode`` call (one kernel launch on the card) per
    round and conveyed sample.
    """

    n_is: int = 256
    n_samples: int = 1
    side_info_bits = FLOAT_BITS   # K, one float32 per client

    def _transmit(self, ctx, payload, priors):
        """Returns (indices (n_act, n_samples, B), K (n_act,), g_hat (n_act, d), bits)."""
        plan, kt, d = ctx.plan, ctx.key, ctx.d
        sels = _vfold(prng.fold_in(kt, TAG_UL_SELECT), ctx.active_ids)
        ks = mean_abs(payload) + 1e-12                               # (n_act, 1)
        qb = to_blocks(stochastic_sign(payload, temperature=ks).q, plan.size)
        idxs, q_hat_b = mrc.transmit_fixed(
            kt, sels, qb, qb.new_full(qb.shape, 0.5), n_is=self.n_is,
            n_samples=self.n_samples)
        g_hat = (2.0 * from_blocks(q_hat_b, d) - 1.0) * ks
        bits = ctx.n_active * (self.n_samples * plan.billable * math.log2(self.n_is)
                               + self.side_info_bits)
        return idxs, ks[:, 0], g_hat, bits

    def step_up(self, ctx, state, payload, priors):
        _, _, g_hat, bits = self._transmit(ctx, payload, priors)
        return g_hat, bits, state


# ---------------------------------------------------------------------------
# BiCompFL-GR downlink.
# ---------------------------------------------------------------------------


@dataclass
class IndexRelayDownlink(StatelessDownlink):
    """GR downlink: relay the other clients' uplink indices.

    With common candidates every client reconstructs the identical global
    model, so nothing is recomputed -- only the bits are booked: each client
    receives the (n-1) other clients' index streams, plus their per-client
    side information (CFL's temperatures K).
    """

    n_is: int = 256
    n_samples: int = 1           # relayed samples per client (n_UL)
    side_info_bits: float = 0.0
    broadcast_shareable: bool = True

    def step_down(self, ctx, state, update, theta, theta_hat):
        n = ctx.n_clients
        th = update.theta
        bits = n * (n - 1) * (self.n_samples * ctx.plan.billable
                              * math.log2(self.n_is) + self.side_info_bits)
        return DownlinkResult(th, th[None].repeat(n, 1), bits), state


# ---------------------------------------------------------------------------
# BiCompFL-GR-Reconst, PR and PR-SplitDL downlinks.
# ---------------------------------------------------------------------------


@dataclass
class MRCBroadcastDownlink(StatelessDownlink):
    """GR-Reconst downlink: one MRC re-transmission of the new model against
    the common prior; all clients share candidates and end with the same
    (noisy) estimate."""

    n_is: int = 256
    n_samples: int = 1           # n_DL
    broadcast_shareable: bool = True

    def _transmit(self, ctx, update, theta_hat):
        """Returns (indices (n_samples, B), estimate (d,), bits)."""
        kt, plan, d = ctx.key, ctx.plan, ctx.d
        skey = prng.fold_in(kt, TAG_DL_SHARED)
        sel = prng.fold_in(kt, TAG_DL_SELECT_COMMON)
        p_common = clip01(theta_hat[0])
        tgt = update.theta
        if plan.adaptive:
            idxs, est = mrc.transmit_segments(
                skey, sel, tgt, p_common, plan.seg_ids, n_is=self.n_is,
                n_seg=plan.n_blocks, n_samples=self.n_samples)
        else:
            idxs, est_b = mrc.transmit_fixed(
                skey, sel, to_blocks(tgt, plan.size), to_blocks(p_common, plan.size),
                n_is=self.n_is, n_samples=self.n_samples)
            est = from_blocks(est_b, d)
        bits = ctx.n_clients * self.n_samples * plan.billable * math.log2(self.n_is)
        return idxs, est, bits

    def step_down(self, ctx, state, update, theta, theta_hat):
        _, est, bits = self._transmit(ctx, update, theta_hat)
        return DownlinkResult(update.theta, clip01(est)[None].repeat(ctx.n_clients, 1),
                              bits), state


@dataclass
class MRCPrivateDownlink(StatelessDownlink):
    """PR downlink: per-client MRC of the new model against each client's
    own prior, on its private candidates ``fold_in(client_key(kt, i),
    TAG_DL_SHARED)``, batched over the cohort.  Under partial participation
    only the active cohort receives the downlink; the others keep stale
    estimates."""

    n_is: int = 256
    n_samples: int = 1           # n_DL
    broadcast_shareable: bool = False

    def _transmit(self, ctx, update, theta_hat):
        """Returns (indices (n_act, n_samples, B), estimates (n_act, d), bits)."""
        kt, plan, d = ctx.key, ctx.plan, ctx.d
        ids = ctx.active_ids
        skeys = prng.fold_in(mrc.client_key(kt, ids), TAG_DL_SHARED)
        sels = _vfold(prng.fold_in(kt, TAG_DL_SELECT_PRIVATE), ids)
        priors = clip01(theta_hat[ids])
        tgt = update.theta
        if plan.adaptive:
            idxs, est = mrc.transmit_segments(
                skeys, sels, tgt, priors, plan.seg_ids, n_is=self.n_is,
                n_seg=plan.n_blocks, n_samples=self.n_samples)
        else:
            idxs, est_b = mrc.transmit_fixed(
                skeys, sels, to_blocks(tgt, plan.size), to_blocks(priors, plan.size),
                n_is=self.n_is, n_samples=self.n_samples)
            est = from_blocks(est_b, d)
        bits = ctx.n_active * self.n_samples * plan.billable * math.log2(self.n_is)
        return idxs, est, bits

    def step_down(self, ctx, state, update, theta, theta_hat):
        _, est, bits = self._transmit(ctx, update, theta_hat)
        theta_hat = theta_hat.clone()
        theta_hat[ctx.active_ids] = clip01(est)
        return DownlinkResult(update.theta, theta_hat, bits), state


_OWNERSHIP: dict = {}


@dataclass
class SplitBlockDownlink(StatelessDownlink):
    """PR-SplitDL: each client receives MRC only for a disjoint 1/n of the
    blocks (downlink cost / n); the rest of its estimate stays as it is.

    Client i owns the interleaved blocks ``arange(i, B, n)``.  The lists are
    ragged when B % n != 0, so each is padded to ``max_len = ceil(B / n)``
    with a sentinel block B, a 0.5 row that is encoded, billed and then
    discarded: the whole downlink is one batched transmission.  Inside it a
    block's candidate key is ``fold_in(skey_i, j)`` with j the block's
    position in client i's list, not its global id.  Fixed blocks only.
    """

    n_is: int = 256
    n_samples: int = 1           # n_DL
    broadcast_shareable: bool = False

    @staticmethod
    def _ownership(n: int, n_blocks: int):
        """The padded (n, max_len) block-ownership table and ``max_len``."""
        max_len = -(-n_blocks // n)
        own_pad = np.full((n, max_len), n_blocks, np.int64)
        for i in range(n):
            own = np.arange(i, n_blocks, n)
            own_pad[i, :len(own)] = own
        return own_pad, max_len

    @staticmethod
    def _ownership_on(n: int, n_blocks: int, device) -> torch.Tensor:
        """The ownership table on ``device``, copied there once per (n,
        n_blocks, device): a captured round reads it, never copies it."""
        key = (n, n_blocks, torch.device(device))
        own = _OWNERSHIP.get(key)
        if own is None:
            own = _OWNERSHIP[key] = torch.as_tensor(
                SplitBlockDownlink._ownership(n, n_blocks)[0], device=device)
        return own

    def _transmit(self, ctx, update, theta_hat):
        """Returns (indices (n, n_samples, max_len), new theta_hat (n, d), bits)."""
        kt, plan, d = ctx.key, ctx.plan, ctx.d
        if plan.adaptive:
            raise NotImplementedError("SplitDL is defined on fixed blocks")
        n, size, n_blocks = ctx.n_clients, plan.size, plan.n_blocks
        max_len = -(-n_blocks // n)
        own = self._ownership_on(n, n_blocks, theta_hat.device)
        tb = to_blocks(update.theta, size)                         # (B, S)
        dummy = tb.new_full((1, size), 0.5)
        tb_ext = torch.cat([tb, dummy])                            # (B + 1, S)
        hb_ext = torch.cat([to_blocks(clip01(theta_hat), size),
                            dummy[None].expand(n, 1, size)], dim=1)  # (n, B + 1, S)
        ids = torch.arange(n, dtype=torch.int64, device=theta_hat.device)
        skeys = prng.fold_in(mrc.client_key(kt, ids), TAG_DL_SHARED)
        sels = _vfold(prng.fold_in(kt, TAG_DL_SELECT_PRIVATE), ids)
        rows = own[..., None].expand(n, max_len, size)
        idxs, est_b = mrc.transmit_fixed(
            skeys, sels, tb_ext[own], torch.take_along_dim(hb_ext, rows, dim=1),
            n_is=self.n_is, n_samples=self.n_samples)
        hb_ext = hb_ext.scatter(1, rows, clip01(est_b))  # owned lists hold no repeats
        bits = n * self.n_samples * max_len * math.log2(self.n_is)
        return idxs, from_blocks(hb_ext[:, :n_blocks], d), bits

    def step_down(self, ctx, state, update, theta, theta_hat):
        _, theta_hat, bits = self._transmit(ctx, update, theta_hat)
        return DownlinkResult(update.theta, theta_hat, bits), state


# ---------------------------------------------------------------------------
# Non-stochastic baseline channels.
# ---------------------------------------------------------------------------


@dataclass
class DenseChannel(StatelessUplink, StatelessDownlink):
    """Lossless 32-bit transmission; usable on either direction."""

    broadcast_shareable: bool = True

    def step_up(self, ctx, state, payload, priors):
        return payload, ctx.n_active * ctx.d * FLOAT_BITS, state

    def step_down(self, ctx, state, update, theta, theta_hat):
        th = update.theta
        return DownlinkResult(th, th[None].repeat(ctx.n_clients, 1),
                              ctx.n_clients * ctx.d * FLOAT_BITS), state

    def flush_step(self, state, n, d):
        # Stateless: a periodic sync through a dense channel only costs bits.
        return 0.0, n * d * FLOAT_BITS, state


def _require_full_cohort(ctx):
    if ctx.n_active != ctx.n_clients:
        raise ValueError("error-feedback uplinks require full participation")


@dataclass
class SignEFChannel:
    """Sign compression with error feedback; ``passes > 1`` repeats the
    compression on the residual (Neolithic's R-pass scheme, ~``passes``
    bits/param).

    As an uplink its state is the per-client EF memory (n, d); as a
    downlink the server-side memory (d,), and it steps the server *and*
    the clients with the compressed aggregate (DoubleSqueeze).
    """

    passes: int = 1
    broadcast_shareable: bool = True

    def _compress_passes(self, v):
        """Iterated sign compression over the last axis, also yielding the
        per-pass wire payload: (scale, sign-bit vector) per pass.  The
        reconstruction ``sum_r scale_r * (+-1)`` is ``sign_compress`` of
        each residual in turn."""
        comps = []
        c = None
        resid = v
        for _ in range(self.passes):
            scale = mean_abs(resid)
            sgn = resid >= 0
            step = sign_compress(resid)  # == scale * where(sgn, 1, -1)
            c = step if c is None else c + step
            resid = v - c
            comps.append((scale, sgn))
        return c, comps

    def _compress(self, v):
        c, _ = self._compress_passes(v)
        return c

    def init_up_state(self, n, d, device):
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    def init_down_state(self, n, d, device):
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def _bits(self, ctx):
        return ctx.n_clients * self.passes * (ctx.d + FLOAT_BITS)

    def step_up(self, ctx, e, payload, priors):
        _require_full_cohort(ctx)
        acc = payload + e
        c = self._compress(acc)
        return c, self._bits(ctx), acc - c

    def step_down(self, ctx, e, update, theta, theta_hat):
        g = update.delta if update.delta is not None \
            else (theta - update.theta) / update.lr
        agg = g + e
        c_s = self._compress(agg)
        return DownlinkResult(theta - update.lr * c_s, theta_hat - update.lr * c_s[None, :],
                              self._bits(ctx)), agg - c_s

    def flush_step(self, e, n, d):
        r = mrc.sample_mean(e) if e.dim() == 2 else e
        return r, n * d * FLOAT_BITS, torch.zeros_like(e)


@dataclass
class TopKEFChannel:
    """Top-k sparsification with error feedback (M3 uplink, k = d/n)."""

    k: int

    def init_up_state(self, n, d, device):
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    def step_up(self, ctx, e, payload, priors):
        _require_full_cohort(ctx)
        acc = payload + e
        c = topk_compress(acc, self.k)
        return c, ctx.n_clients * topk_bits(ctx.d, self.k), acc - c

    def flush_step(self, e, n, d):
        return mrc.sample_mean(e), n * d * FLOAT_BITS, torch.zeros_like(e)


@dataclass
class SliceDownlink(StatelessDownlink):
    """M3 downlink: each client receives a disjoint dense 1/n model slice;
    client estimates diverge (no broadcast saving possible).

    ``k`` is the slice width, M3's top-k uplink budget d/n; the last slice
    runs to d."""

    k: int
    broadcast_shareable: bool = False

    def step_down(self, ctx, state, update, theta, theta_hat):
        n, d, k = ctx.n_clients, ctx.d, self.k
        th = update.theta
        new_hat = theta_hat.clone()
        for i in range(n):
            lo = i * k
            hi = d if i == n - 1 else min((i + 1) * k, d)
            new_hat[i, lo:hi] = th[lo:hi]
        return DownlinkResult(th, new_hat, n * (d / n) * FLOAT_BITS), state
