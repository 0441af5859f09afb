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
(M3).

Every channel also speaks the reference's wire and shell protocol, which
the engine's ``wire="audit"`` host rounds run (``repro_torch.wire``):
``encode_up`` / ``decode_up`` (uplinks) and ``encode_down`` /
``decode_down`` (downlinks) serialize exactly the values the step
functions select -- MRC indices, plan-free dense and sign payloads, top-k
records -- and decode them back to the identical tensors; the tensors
cross to numpy only at that codec boundary.  The object shells
(``transmit`` / ``transmit_wire``, ``distribute`` / ``distribute_wire``,
``flush`` / ``flush_wire`` / ``decode_flush_up``, ``export_state`` /
``import_state`` / ``reset``) keep the error-feedback memory in
``self._e``, as the reference does.  The reference's ``pin`` is not
needed: the port's fused path replays the very kernels its host loop
launches, so nothing is contracted across stage boundaries.  Every step
function also runs inside a captured CUDA graph: no host copy, no host
read, the cohort (``ctx.active``) and the plan of a fused round already on
the device.

The key-derivation tags are the reference's, so both packages draw the same
candidates and selections in every round.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mrc
from repro_torch.core.bernoulli import clip01
from repro_torch.core.blocks import BlockPlan  # noqa: F401  (travels with the API)
from repro_torch.core.quantizers import (FLOAT_BITS, mean_abs, sign_compress, stochastic_sign,
                                         topk_bits, topk_compress, topk_indices)
from repro_torch.wire import (DIR_DOWN, DIR_FLUSH_UP, DIR_UP, SERVER, BitReader, BitWriter,
                              Message)
from repro_torch.wire import codecs as wcodecs

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
    # Aggregation weights over cohort positions under injected faults
    # (repro_torch.fl.faults): 0.0 for dropped / straggling / lost-uplink
    # clients, 1.0 for contributors; a float32 tensor on the round's device.
    # None on fault-free rounds, which keeps every aggregate bit-identical
    # to the fault-free engine's.
    up_weight: Any = None

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


@dataclass(frozen=True)
class WireEnv:
    """Decoder-side context for ``decode_down`` (cf. repro_torch.wire).

    Everything here is information the *receiving* party legitimately holds:
    its own uplink transmission (``up_msgs``, for index-relay downlinks),
    the shared uplink/aggregator definitions, the round's priors, and --
    server-side only -- the aggregator's proposed :class:`ServerUpdate`
    (used where the downlink result's ``theta`` never crosses the wire
    because it stays on the federator).
    """

    uplink: Any
    aggregator: Any
    priors: Any
    up_msgs: Any
    update: ServerUpdate


def _wire_msg(direction: int, sender: int, recipient: int, w: BitWriter) -> Message:
    """Seal a finished payload writer into an (unstamped) frame."""
    return Message(direction=direction, sender=int(sender), recipient=int(recipient),
                   payload=w.getvalue(), payload_bits=w.bits_written)


def _wire_reader(m: Message) -> BitReader:
    return BitReader(m.payload, m.payload_bits)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host: the codecs' side of the boundary."""
    return t.detach().cpu().numpy()


def _active(ctx) -> np.ndarray:
    """The round's cohort ids on the host."""
    a = ctx.active
    return _host(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _index_msgs(direction: int, ctx, idxs: torch.Tensor, n_is: int, *, up: bool):
    """One frame of MRC indices per cohort member: row j of ``idxs`` to
    (uplink) or from (downlink) the j-th active client."""
    rows = _host(idxs)
    msgs = []
    for j, cid in enumerate(_active(ctx)):
        w = BitWriter()
        wcodecs.put_indices(w, rows[j], n_is)
        msgs.append(_wire_msg(direction, cid, SERVER, w) if up
                    else _wire_msg(direction, SERVER, cid, w))
    return msgs


def _read_indices(msgs, shape, n_is: int, device) -> torch.Tensor:
    """The frames' index arrays stacked, ``(len(msgs), *shape)`` int64 on
    ``device``; each frame must be exactly consumed."""
    idxs = []
    for m in msgs:
        r = _wire_reader(m)
        idxs.append(wcodecs.get_indices(r, shape, n_is))
        r.expect_exhausted()
    return torch.as_tensor(np.stack(idxs).astype(np.int64), device=device)


def _read_dense_mean(msgs, d: int) -> torch.Tensor:
    """The mean of the frames' dense rows, rounded as the reference's
    ``jnp.mean`` (the EF flush residual the uplinks send), on the host: the
    engine moves it to the model's device."""
    rows = [wcodecs.get_dense(_wire_reader(m), d) for m in msgs]
    return mrc.sample_mean(torch.as_tensor(np.stack(rows)))


# ---------------------------------------------------------------------------
# Shells: the object API over the pure step functions.
# ---------------------------------------------------------------------------


class StatelessUplink:
    """Object shell + trivial state for uplinks without memory."""

    def init_up_state(self, n: int, d: int, device):
        return EMPTY_STATE

    def export_state(self):
        """Shell-state snapshot (fault-injection carry; trivial here)."""
        return EMPTY_STATE

    def import_state(self, state) -> None:
        pass

    def transmit(self, ctx, payload, priors):
        out, bits, _ = self.step_up(ctx, EMPTY_STATE, payload, priors)
        return out, bits

    def transmit_wire(self, ctx, payload, priors):
        """Like ``transmit`` but also returns the encoded wire messages."""
        out, bits, _, msgs = self.encode_up(ctx, EMPTY_STATE, payload, priors)
        return out, bits, msgs

    def flush_step(self, state, n: int, d: int):
        return 0.0, 0.0, state

    def flush(self, n: int, d: int):
        return 0.0, 0.0

    def flush_wire(self, n: int, d: int):
        r, bits = self.flush(n, d)
        return r, bits, []

    def decode_flush_up(self, msgs, n: int, d: int):
        return 0.0


class StatelessDownlink:
    """Object shell + trivial state for downlinks without memory."""

    # Downlink audience: "all" (every client holds an estimate of the
    # broadcast) or "active" (client-specific payloads for the cohort
    # only).  The engine's fault booking scales per-recipient bits by it.
    downlink_recipients = "all"

    def init_down_state(self, n: int, d: int, device):
        return EMPTY_STATE

    def export_state(self):
        return EMPTY_STATE

    def import_state(self, state) -> None:
        pass

    def distribute(self, ctx, update, theta, theta_hat):
        res, _ = self.step_down(ctx, EMPTY_STATE, update, theta, theta_hat)
        return res

    def distribute_wire(self, ctx, update, theta, theta_hat, up_msgs):
        res, _, msgs = self.encode_down(ctx, EMPTY_STATE, update, theta, theta_hat, up_msgs)
        return res, msgs

    def flush_step(self, state, n: int, d: int):
        return 0.0, 0.0, state

    def flush(self, n: int, d: int):
        return 0.0, 0.0


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

    # -- wire codec: per client, its (n_samples, B) index stream -----------

    def encode_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        return q_hat, bits, state, _index_msgs(DIR_UP, ctx, idxs, self.n_is, up=True)

    def decode_up(self, ctx, msgs, priors):
        plan, kt = ctx.plan, ctx.key
        idxs = _read_indices(msgs, (self.n_samples, plan.n_blocks), self.n_is, priors.device)
        skey = kt if self.shared else mrc.client_key(kt, ctx.active_ids)
        q_hat_b = mrc.receive_fixed(skey, idxs, to_blocks(clip01(priors), plan.size),
                                    n_is=self.n_is)
        return from_blocks(q_hat_b, ctx.d)


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

    # -- wire codec: per client, its (n_samples, n_seg) index stream -------

    def encode_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        return q_hat, bits, state, _index_msgs(DIR_UP, ctx, idxs, self.n_is, up=True)

    def decode_up(self, ctx, msgs, priors):
        plan, kt = ctx.plan, ctx.key
        idxs = _read_indices(msgs, (self.n_samples, plan.n_blocks), self.n_is, priors.device)
        skey = kt if self.shared else mrc.client_key(kt, ctx.active_ids)
        return mrc.receive_segments(skey, idxs, clip01(priors), plan.seg_ids, n_is=self.n_is)


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

    # -- wire codec ----------------------------------------------------------
    # Payload per client: the f32 temperature K (the booked 32-bit side
    # information), then the MRC index stream.

    def encode_up(self, ctx, state, payload, priors):
        idxs, ks, g_hat, bits = self._transmit(ctx, payload, priors)
        idxs, ks = _host(idxs), _host(ks)
        msgs = []
        for j, cid in enumerate(_active(ctx)):
            w = BitWriter()
            w.write_f32(ks[j])
            wcodecs.put_indices(w, idxs[j], self.n_is)
            msgs.append(_wire_msg(DIR_UP, cid, SERVER, w))
        return g_hat, bits, state, msgs

    def decode_up(self, ctx, msgs, priors):
        plan, kt, d = ctx.plan, ctx.key, ctx.d
        shape = (self.n_samples, plan.n_blocks)
        ks, idxs = [], []
        for m in msgs:
            r = _wire_reader(m)
            ks.append(r.read_f32())
            idxs.append(wcodecs.get_indices(r, shape, self.n_is))
            r.expect_exhausted()
        dev = ctx.key.device
        ks = torch.as_tensor(np.stack(ks), device=dev)[:, None]
        idxs = torch.as_tensor(np.stack(idxs).astype(np.int64), device=dev)
        p_blocks = torch.full((plan.n_blocks, plan.size), 0.5, dtype=torch.float32, device=dev)
        q_hat_b = mrc.receive_fixed(kt, idxs, p_blocks, n_is=self.n_is)
        return (2.0 * from_blocks(q_hat_b, d) - 1.0) * ks


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

    # -- wire codec ----------------------------------------------------------
    # The relay's payloads ARE the uplink payloads: each client receives the
    # (n-1) other clients' frames verbatim (for CFL those frames already
    # carry the K side information the channel books).

    def encode_down(self, ctx, state, update, theta, theta_hat, up_msgs):
        res, state = self.step_down(ctx, state, update, theta, theta_hat)
        if len(up_msgs) != ctx.n_clients:
            raise ValueError("index relay needs every client's uplink frame")
        msgs = []
        for rcpt in _active(ctx):
            for m in up_msgs:
                if m.sender == int(rcpt):
                    continue
                msgs.append(Message(direction=DIR_DOWN, sender=m.sender,
                                    recipient=int(rcpt), payload=m.payload,
                                    payload_bits=m.payload_bits))
        return res, state, msgs

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        """Reconstruct through the *first* client's receive path: its own
        transmission plus the n-1 relays, decoded with the shared uplink
        codec and re-aggregated -- with common candidates this must land on
        exactly the server's model."""
        n = ctx.n_clients
        active = _active(ctx)
        ref = int(active[0])
        by_sender = {m.sender: m for m in msgs if m.recipient == ref}
        own = [m for m in env.up_msgs if m.sender == ref]
        ordered = [own[0] if int(cid) == ref else by_sender[int(cid)] for cid in active]
        up_out = env.uplink.decode_up(ctx, ordered, env.priors)
        th = env.aggregator(ctx, theta, up_out).theta
        bits = n * (n - 1) * (self.n_samples * ctx.plan.billable
                              * math.log2(self.n_is) + self.side_info_bits)
        return DownlinkResult(th, th[None].repeat(n, 1), bits)


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

    # -- wire codec ----------------------------------------------------------
    # One index stream, broadcast: a frame with the same payload to every
    # active client (the channel bills per client, so the totals match).

    def encode_down(self, ctx, state, update, theta, theta_hat, up_msgs):
        idxs, est, bits = self._transmit(ctx, update, theta_hat)
        w = BitWriter()
        wcodecs.put_indices(w, _host(idxs), self.n_is)
        payload, nbits = w.getvalue(), w.bits_written
        msgs = [Message(direction=DIR_DOWN, sender=SERVER, recipient=int(cid),
                        payload=payload, payload_bits=nbits) for cid in _active(ctx)]
        res = DownlinkResult(update.theta, clip01(est)[None].repeat(ctx.n_clients, 1), bits)
        return res, state, msgs

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        kt, plan, d = ctx.key, ctx.plan, ctx.d
        skey = prng.fold_in(kt, TAG_DL_SHARED)
        idxs = _read_indices(msgs[:1], (self.n_samples, plan.n_blocks), self.n_is,
                             theta_hat.device)[0]
        p_common = clip01(theta_hat[0])
        if plan.adaptive:
            est = mrc.receive_segments(skey, idxs, p_common, plan.seg_ids, n_is=self.n_is)
        else:
            est = from_blocks(mrc.receive_fixed(skey, idxs, to_blocks(p_common, plan.size),
                                                n_is=self.n_is), d)
        bits = ctx.n_clients * self.n_samples * plan.billable * math.log2(self.n_is)
        return DownlinkResult(env.update.theta,
                              clip01(est)[None].repeat(ctx.n_clients, 1), bits)


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
    downlink_recipients = "active"  # client-specific payloads, cohort only

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

    # -- wire codec: per active client, its (n_samples, B) index stream ------

    def encode_down(self, ctx, state, update, theta, theta_hat, up_msgs):
        idxs, est, bits = self._transmit(ctx, update, theta_hat)
        new_hat = theta_hat.clone()
        new_hat[ctx.active_ids] = clip01(est)
        return (DownlinkResult(update.theta, new_hat, bits), state,
                _index_msgs(DIR_DOWN, ctx, idxs, self.n_is, up=False))

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        kt, plan, d = ctx.key, ctx.plan, ctx.d
        ids = ctx.active_ids
        skeys = prng.fold_in(mrc.client_key(kt, ids), TAG_DL_SHARED)
        priors = clip01(theta_hat[ids])
        idxs = _read_indices(msgs, (self.n_samples, plan.n_blocks), self.n_is,
                             theta_hat.device)
        if plan.adaptive:
            est = mrc.receive_segments(skeys, idxs, priors, plan.seg_ids, n_is=self.n_is)
        else:
            est = from_blocks(mrc.receive_fixed(skeys, idxs, to_blocks(priors, plan.size),
                                                n_is=self.n_is), d)
        new_hat = theta_hat.clone()
        new_hat[ids] = clip01(est)
        bits = ctx.n_active * self.n_samples * plan.billable * math.log2(self.n_is)
        return DownlinkResult(env.update.theta, new_hat, bits)


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

    def _frame(self, ctx, theta_hat):
        """What encoder and decoder share: the clients' candidate keys, the
        estimates' blocks with the sentinel appended ``(n, B + 1, S)``, the
        gather index of each client's owned list ``(n, max_len, S)``, and
        the bits."""
        plan = ctx.plan
        if plan.adaptive:
            raise NotImplementedError("SplitDL is defined on fixed blocks")
        n, size, n_blocks = ctx.n_clients, plan.size, plan.n_blocks
        max_len = -(-n_blocks // n)
        own = self._ownership_on(n, n_blocks, theta_hat.device)
        hb_ext = torch.cat([to_blocks(clip01(theta_hat), size),
                            theta_hat.new_full((n, 1, size), 0.5)], dim=1)  # (n, B + 1, S)
        ids = torch.arange(n, dtype=torch.int64, device=theta_hat.device)
        skeys = prng.fold_in(mrc.client_key(ctx.key, ids), TAG_DL_SHARED)
        rows = own[..., None].expand(n, max_len, size)
        bits = n * self.n_samples * max_len * math.log2(self.n_is)
        return own, hb_ext, skeys, rows, bits

    def _place(self, ctx, hb_ext, rows, est_b):
        """The new estimates: each client's owned blocks replaced."""
        hb_ext = hb_ext.scatter(1, rows, clip01(est_b))  # owned lists hold no repeats
        return from_blocks(hb_ext[:, :ctx.plan.n_blocks], ctx.d)

    def _transmit(self, ctx, update, theta_hat):
        """Returns (indices (n, n_samples, max_len), new theta_hat (n, d), bits)."""
        own, hb_ext, skeys, rows, bits = self._frame(ctx, theta_hat)
        tb = to_blocks(update.theta, ctx.plan.size)                 # (B, S)
        tb_ext = torch.cat([tb, tb.new_full((1, ctx.plan.size), 0.5)])  # (B + 1, S)
        ids = torch.arange(ctx.n_clients, dtype=torch.int64, device=theta_hat.device)
        sels = _vfold(prng.fold_in(ctx.key, TAG_DL_SELECT_PRIVATE), ids)
        idxs, est_b = mrc.transmit_fixed(
            skeys, sels, tb_ext[own], torch.take_along_dim(hb_ext, rows, dim=1),
            n_is=self.n_is, n_samples=self.n_samples)
        return idxs, self._place(ctx, hb_ext, rows, est_b), bits

    def step_down(self, ctx, state, update, theta, theta_hat):
        _, theta_hat, bits = self._transmit(ctx, update, theta_hat)
        return DownlinkResult(update.theta, theta_hat, bits), state

    # -- wire codec ----------------------------------------------------------
    # Per client: indices for its (padded) owned-block subset, sentinel
    # included -- the channel bills the padding, so the wire carries it.

    def encode_down(self, ctx, state, update, theta, theta_hat, up_msgs):
        idxs, new_hat, bits = self._transmit(ctx, update, theta_hat)
        return (DownlinkResult(update.theta, new_hat, bits), state,
                _index_msgs(DIR_DOWN, ctx, idxs, self.n_is, up=False))

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        own, hb_ext, skeys, rows, bits = self._frame(ctx, theta_hat)
        idxs = _read_indices(msgs, (self.n_samples, own.shape[1]), self.n_is,
                             theta_hat.device)
        est_b = mrc.receive_fixed(skeys, idxs, torch.take_along_dim(hb_ext, rows, dim=1),
                                  n_is=self.n_is)
        return DownlinkResult(env.update.theta, self._place(ctx, hb_ext, rows, est_b), bits)


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

    def flush(self, n, d):
        return 0.0, n * d * FLOAT_BITS

    # -- wire codec: raw big-endian f32 vectors ------------------------------

    def encode_up(self, ctx, state, payload, priors):
        rows = _host(payload)
        msgs = []
        for j, cid in enumerate(_active(ctx)):
            w = BitWriter()
            wcodecs.put_dense(w, rows[j])
            msgs.append(_wire_msg(DIR_UP, cid, SERVER, w))
        return payload, ctx.n_active * ctx.d * FLOAT_BITS, state, msgs

    def decode_up(self, ctx, msgs, priors):
        rows = []
        for m in msgs:
            r = _wire_reader(m)
            rows.append(wcodecs.get_dense(r, ctx.d))
            r.expect_exhausted()
        return torch.as_tensor(np.stack(rows), device=ctx.key.device)

    def encode_down(self, ctx, state, update, theta, theta_hat, up_msgs):
        res, state = self.step_down(ctx, state, update, theta, theta_hat)
        w = BitWriter()
        wcodecs.put_dense(w, _host(update.theta))
        payload, nbits = w.getvalue(), w.bits_written
        msgs = [Message(direction=DIR_DOWN, sender=SERVER, recipient=cid,
                        payload=payload, payload_bits=nbits) for cid in range(ctx.n_clients)]
        return res, state, msgs

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        r = _wire_reader(msgs[0])
        th = torch.as_tensor(wcodecs.get_dense(r, ctx.d), device=theta.device)
        r.expect_exhausted()
        return DownlinkResult(th, th[None].repeat(ctx.n_clients, 1),
                              ctx.n_clients * ctx.d * FLOAT_BITS)

    def flush_wire(self, n, d):
        # Dense channels hold no EF memory: the sync uplink is the zero
        # residual, serialized at the billed dense rate.
        r, bits = self.flush(n, d)
        msgs = []
        for cid in range(n):
            w = BitWriter()
            wcodecs.put_dense(w, np.zeros(d, np.float32))
            msgs.append(_wire_msg(DIR_FLUSH_UP, cid, SERVER, w))
        return r, bits, msgs

    def decode_flush_up(self, msgs, n, d):
        return _read_dense_mean(msgs, d)


def _require_full_cohort(ctx):
    if ctx.n_active != ctx.n_clients:
        raise ValueError("error-feedback uplinks require full participation")


class _EFShell:
    """The object shell of an error-feedback channel: the memory lives in
    ``self._e`` (None until the first round), threaded through the pure
    step functions, as in the reference."""

    def transmit(self, ctx, payload, priors):
        if self._e is None:
            self._e = torch.zeros_like(payload)
        out, bits, self._e = self.step_up(ctx, self._e, payload, priors)
        return out, bits

    def transmit_wire(self, ctx, payload, priors):
        if self._e is None:
            self._e = torch.zeros_like(payload)
        out, bits, self._e, msgs = self.encode_up(ctx, self._e, payload, priors)
        return out, bits, msgs

    def flush(self, n, d):
        if self._e is None:
            return 0.0, n * d * FLOAT_BITS
        r, bits, self._e = self.flush_step(self._e, n, d)
        return r, bits

    def flush_wire(self, n, d):
        """Uplink EF sync: every client uploads its dense residual row."""
        e = self._e if self._e is not None else torch.zeros((n, d), dtype=torch.float32)
        rows = _host(e if e.dim() == 2 else e[None].expand(n, d))
        msgs = []
        for cid in range(n):
            w = BitWriter()
            wcodecs.put_dense(w, rows[cid])
            msgs.append(_wire_msg(DIR_FLUSH_UP, cid, SERVER, w))
        r, bits = self.flush(n, d)
        return r, bits, msgs

    def decode_flush_up(self, msgs, n, d):
        return _read_dense_mean(msgs, d)

    def export_state(self):
        return self._e

    def import_state(self, state) -> None:
        self._e = state

    def reset(self):
        self._e = None


@dataclass
class SignEFChannel(_EFShell):
    """Sign compression with error feedback; ``passes > 1`` repeats the
    compression on the residual (Neolithic's R-pass scheme, ~``passes``
    bits/param).

    As an uplink its state is the per-client EF memory (n, d); as a
    downlink the server-side memory (d,), and it steps the server *and*
    the clients with the compressed aggregate (DoubleSqueeze).
    """

    passes: int = 1
    broadcast_shareable: bool = True
    _e: Optional[torch.Tensor] = field(default=None, repr=False)

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

    # -- wire codec ----------------------------------------------------------
    # Per client (uplink) / broadcast (downlink): ``passes`` records of one
    # f32 scale + a d-bit sign bitmap -- the booked passes * (d + 32).

    def _decode_compressed(self, r, d, device):
        c = None
        for _ in range(self.passes):
            scale, sgn = wcodecs.get_sign_pass(r, d)
            sgn = torch.as_tensor(sgn, device=device)
            step = torch.tensor(scale, device=device) * torch.where(sgn, 1.0, -1.0)
            c = step if c is None else c + step
        return c

    def _sign_payload(self, comps, j=None):
        w = BitWriter()
        for scale, sgn in comps:
            scale, sgn = _host(scale), _host(sgn)
            if j is not None:
                scale, sgn = scale[j], sgn[j]
            wcodecs.put_sign_pass(w, scale.reshape(-1)[0], sgn)
        return w

    def encode_up(self, ctx, e, payload, priors):
        _require_full_cohort(ctx)
        acc = payload + e
        c, comps = self._compress_passes(acc)
        msgs = [_wire_msg(DIR_UP, cid, SERVER, self._sign_payload(comps, j))
                for j, cid in enumerate(_active(ctx))]
        return c, self._bits(ctx), acc - c, msgs

    def decode_up(self, ctx, msgs, priors):
        rows = []
        for m in msgs:
            r = _wire_reader(m)
            rows.append(self._decode_compressed(r, ctx.d, ctx.key.device))
            r.expect_exhausted()
        return torch.stack(rows)

    def encode_down(self, ctx, e, update, theta, theta_hat, up_msgs):
        g = update.delta if update.delta is not None \
            else (theta - update.theta) / update.lr
        agg = g + e
        c_s, comps = self._compress_passes(agg)
        w = self._sign_payload(comps)
        payload, nbits = w.getvalue(), w.bits_written
        msgs = [Message(direction=DIR_DOWN, sender=SERVER, recipient=cid,
                        payload=payload, payload_bits=nbits) for cid in range(ctx.n_clients)]
        res = DownlinkResult(theta - update.lr * c_s, theta_hat - update.lr * c_s[None, :],
                             self._bits(ctx))
        return res, agg - c_s, msgs

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        r = _wire_reader(msgs[0])
        c_s = self._decode_compressed(r, ctx.d, theta.device)
        r.expect_exhausted()
        lr = env.update.lr
        return DownlinkResult(theta - lr * c_s, theta_hat - lr * c_s[None, :], self._bits(ctx))

    def distribute(self, ctx, update, theta, theta_hat):
        if self._e is None:
            self._e = torch.zeros_like(theta)
        res, self._e = self.step_down(ctx, self._e, update, theta, theta_hat)
        return res

    def distribute_wire(self, ctx, update, theta, theta_hat, up_msgs):
        if self._e is None:
            self._e = torch.zeros_like(theta)
        res, self._e, msgs = self.encode_down(ctx, self._e, update, theta, theta_hat, up_msgs)
        return res, msgs


@dataclass
class TopKEFChannel(_EFShell):
    """Top-k sparsification with error feedback (M3 uplink, k = d/n)."""

    k: int = 1
    _e: Optional[torch.Tensor] = field(default=None, repr=False)

    def init_up_state(self, n, d, device):
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    def step_up(self, ctx, e, payload, priors):
        _require_full_cohort(ctx)
        acc = payload + e
        c = topk_compress(acc, self.k)
        return c, ctx.n_clients * topk_bits(ctx.d, self.k), acc - c

    def flush_step(self, e, n, d):
        return mrc.sample_mean(e), n * d * FLOAT_BITS, torch.zeros_like(e)

    # -- wire codec ----------------------------------------------------------
    # Per client: k records of (ceil(log2 d)-bit index, f32 value) -- the
    # booked topk_bits(d, k), in ``lax.top_k``'s order.

    def encode_up(self, ctx, e, payload, priors):
        _require_full_cohort(ctx)
        acc = payload + e
        idxs = topk_indices(acc, self.k)
        vals = _host(torch.gather(acc, -1, idxs))
        c = topk_compress(acc, self.k)
        idxs = _host(idxs)
        msgs = []
        for j, cid in enumerate(_active(ctx)):
            w = BitWriter()
            wcodecs.put_topk(w, idxs[j], vals[j], ctx.d)
            msgs.append(_wire_msg(DIR_UP, cid, SERVER, w))
        return c, ctx.n_clients * topk_bits(ctx.d, self.k), acc - c, msgs

    def decode_up(self, ctx, msgs, priors):
        kk, dev = min(self.k, ctx.d), ctx.key.device
        rows = []
        for m in msgs:
            r = _wire_reader(m)
            idx, vals = wcodecs.get_topk(r, kk, ctx.d)
            r.expect_exhausted()
            rows.append(torch.zeros(ctx.d, dtype=torch.float32, device=dev).scatter(
                0, torch.as_tensor(idx.astype(np.int64), device=dev),
                torch.as_tensor(vals, device=dev)))
        return torch.stack(rows)


@dataclass
class SliceDownlink(StatelessDownlink):
    """M3 downlink: each client receives a disjoint dense 1/n model slice;
    client estimates diverge (no broadcast saving possible).

    ``k`` is the slice width, M3's top-k uplink budget d/n; the last slice
    runs to d."""

    k: int
    broadcast_shareable: bool = False

    def _bounds(self, n, d):
        k = self.k
        return [(i * k, d if i == n - 1 else min((i + 1) * k, d)) for i in range(n)]

    def step_down(self, ctx, state, update, theta, theta_hat):
        n, d = ctx.n_clients, ctx.d
        th = update.theta
        new_hat = theta_hat.clone()
        for i, (lo, hi) in enumerate(self._bounds(n, d)):
            new_hat[i, lo:hi] = th[lo:hi]
        return DownlinkResult(th, new_hat, n * (d / n) * FLOAT_BITS), state

    # -- wire codec ----------------------------------------------------------
    # Client i's message carries its dense f32 slice [i*k, hi); the slices
    # tile [0, d) so the stream totals d * 32 bits == the booked
    # n * (d/n) * 32 up to float round-off (cf. RECONCILE_REL_TOL).

    def encode_down(self, ctx, state, update, theta, theta_hat, up_msgs):
        res, state = self.step_down(ctx, state, update, theta, theta_hat)
        th = _host(res.theta)
        msgs = []
        for cid, (lo, hi) in enumerate(self._bounds(ctx.n_clients, ctx.d)):
            w = BitWriter()
            wcodecs.put_dense(w, th[lo:hi])
            msgs.append(_wire_msg(DIR_DOWN, SERVER, cid, w))
        return res, state, msgs

    def decode_down(self, ctx, msgs, theta, theta_hat, env: WireEnv):
        n, d = ctx.n_clients, ctx.d
        by_recipient = {m.recipient: m for m in msgs}
        new_hat = theta_hat.clone()
        for cid, (lo, hi) in enumerate(self._bounds(n, d)):
            r = _wire_reader(by_recipient[cid])
            sl = wcodecs.get_dense(r, hi - lo)
            r.expect_exhausted()
            new_hat[cid, lo:hi] = torch.as_tensor(sl, device=theta_hat.device)
        return DownlinkResult(env.update.theta, new_hat, n * (d / n) * FLOAT_BITS)
