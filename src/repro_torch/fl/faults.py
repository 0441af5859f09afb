"""Deterministic fault injection for the FL engine (cf. DESIGN.md §8); a
copy of ``repro.fl.faults`` (pure numpy), draw for draw.

Cross-device FL is not a perfect world: clients drop out mid-round,
stragglers miss the aggregation deadline, and physical links corrupt
frames.  This module makes all of that *deterministic and seeded*, the
same way the engine's ``cohort_schedule`` is: a :class:`FaultPlan` is
pure configuration, and :meth:`FaultPlan.schedule` precomputes every
fault of an R-round run as numpy tables **before** the run starts.  Both
engine paths consume the same tables -- the host loop reads them as
Python values, the fused path copies them into device buffers that its
captured rounds read -- so the same seed produces the *identical* fault trajectory in
``mode="host"`` and ``mode="fused"``, and a fault schedule can be
replayed, resumed mid-run, or audited without ever re-running training.

Fault taxonomy (per round t, per client i):

* **dropout** -- the client is offline for the whole round: it sends no
  uplink, receives no downlink, and its ``theta_hat`` row / EF-state row
  stay at their pre-round values (carried, not corrupted);
* **straggler** -- the client trains and transmits, but past the
  aggregation deadline: its uplink bits are billed (the traffic
  happened) yet its contribution is *excluded* from the aggregate; it
  still receives the downlink;
* **corruption** -- a delivery (one client's uplink bundle, or one
  recipient's downlink bundle) is hit by ``k`` corrupted frame copies
  before a clean one arrives.  Each corrupted copy is retransmitted
  (bounded by ``max_retries``, with exponential backoff recorded per
  round); ``k > max_retries`` means the delivery is **lost** -- the
  sender behaves like a straggler (uplink) or keeps its stale model
  (downlink).  Every corrupted copy's payload bits are booked into the
  BitMeter's ``retransmit_bits`` category.

All randomness is drawn from one ``numpy.random.default_rng`` stream in
a fixed order, as raw uniforms that thresholds/quantiles are applied to,
so the dropout pattern of ``seed=s`` does not change when
``corrupt_rate`` moves (and vice versa): fault dimensions are
independently reproducible.

Control traffic is modeled as protected: block-plan (CTRL) headers and
EF flush broadcasts ride reliable signaling and are never corrupted;
dropped clients still miss them (the engine scales their booking by the
online fraction).
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

import numpy as np


def _geom_failures(u: np.ndarray, p: float, cap: int) -> np.ndarray:
    """Corrupted copies before the first clean one, each copy bad w.p. p.

    Geometric inverse CDF derived from raw uniforms, so the same ``u``
    maps monotonically to failure counts as ``p`` moves:
    ``P[F >= k] = p^k``, hence ``F = floor(log(1-u) / log(p))``, capped
    at ``cap`` (= max_retries + 1, the "lost" bucket).
    """
    if p <= 0.0:
        return np.zeros(u.shape, dtype=np.int64)
    if p >= 1.0:
        return np.full(u.shape, cap, dtype=np.int64)
    f = np.floor(np.log1p(-u) / math.log(p)).astype(np.int64)
    return np.minimum(f, cap)


@dataclass(frozen=True)
class FaultPlan:
    """Seeded fault configuration; pure data, hashable, reusable."""

    drop_rate: float = 0.0        # P[client offline for a round]
    straggler_rate: float = 0.0   # P[online client misses the deadline]
    corrupt_rate: float = 0.0     # P[one frame copy corrupted in flight]
    max_retries: int = 3          # corrupted copies tolerated per delivery
    backoff_base_s: float = 0.05  # first retry delay (seconds, recorded)
    backoff_factor: float = 2.0   # delay multiplier per further retry
    seed: int = 0

    def __post_init__(self):
        for name in ("drop_rate", "straggler_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name}={v} outside [0, 1)")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} < 0")
        if self.backoff_base_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff must be nonnegative and nondecreasing")

    @property
    def trivial(self) -> bool:
        """True when this plan can never produce a fault."""
        return (self.drop_rate == 0.0 and self.straggler_rate == 0.0
                and self.corrupt_rate == 0.0)

    def backoff_s(self, n_failures: int) -> float:
        """Total backoff delay a delivery with ``n_failures`` retries paid."""
        return sum(self.backoff_base_s * self.backoff_factor ** j
                   for j in range(int(n_failures)))

    def schedule(self, rounds: int, n: int) -> "FaultSchedule":
        """Precompute the full fault trajectory (fixed draw order)."""
        rng = np.random.default_rng(self.seed + 0xFA17)
        u_drop = rng.random((rounds, n))
        u_straggle = rng.random((rounds, n))
        u_up = rng.random((rounds, n))
        u_dn = rng.random((rounds, n))
        # One uniform per potential frame copy: the corrupted bit position
        # of attempt a on link l (0=up, 1=down) of client i in round t.
        u_flip = rng.random((rounds, n, 2, self.max_retries + 2))
        cap = self.max_retries + 1
        return FaultSchedule(
            plan=self,
            rounds=rounds, n=n,
            drop=u_drop < self.drop_rate,
            straggle=u_straggle < self.straggler_rate,
            up_failures=_geom_failures(u_up, self.corrupt_rate, cap),
            dn_failures=_geom_failures(u_dn, self.corrupt_rate, cap),
            flip_u=u_flip)


@dataclass(frozen=True)
class FaultSchedule:
    """The precomputed fault tables of one run (numpy, host-resident)."""

    plan: FaultPlan
    rounds: int
    n: int
    drop: np.ndarray         # (rounds, n) bool: offline whole round
    straggle: np.ndarray     # (rounds, n) bool: missed deadline (if online)
    up_failures: np.ndarray  # (rounds, n) int: corrupted uplink copies
    dn_failures: np.ndarray  # (rounds, n) int: corrupted downlink copies
    flip_u: np.ndarray       # (rounds, n, 2, max_retries+2) bit-flip draws

    def round_view(self, t: int, active: np.ndarray,
                   dl_recipients: str = "all") -> "RoundFaults":
        """Resolve round ``t``'s tables against its cohort.

        ``dl_recipients`` is the downlink channel's audience: ``"all"``
        (broadcast-style, every client holds a theta_hat estimate) or
        ``"active"`` (client-specific payloads for the cohort only,
        e.g. the PR downlink).
        """
        if dl_recipients not in ("all", "active"):
            raise ValueError(dl_recipients)
        n = self.n
        mr = self.plan.max_retries
        in_cohort = np.zeros(n, dtype=bool)
        in_cohort[np.asarray(active, dtype=np.int64)] = True
        online = ~self.drop[t]
        senders = in_cohort & online
        up_lost = self.up_failures[t] > mr
        delivered_up = senders & ~up_lost
        contrib = delivered_up & ~self.straggle[t]
        up_wasted = np.where(senders,
                             np.minimum(self.up_failures[t], mr + 1), 0)
        nominal_recv = in_cohort if dl_recipients == "active" \
            else np.ones(n, dtype=bool)
        recv_sched = nominal_recv & online
        all_failed = not bool(contrib.any())
        if all_failed:
            # The server aborts the round before any broadcast: no
            # downlink traffic, clean or wasted, leaves the federator.
            delivered_dn = np.zeros(n, dtype=bool)
            dn_wasted = np.zeros(n, dtype=np.int64)
        else:
            delivered_dn = recv_sched & (self.dn_failures[t] <= mr)
            dn_wasted = np.where(recv_sched,
                                 np.minimum(self.dn_failures[t], mr + 1), 0)
        return RoundFaults(
            t=t, plan=self.plan, active=np.asarray(active, dtype=np.int64),
            in_cohort=in_cohort, online=online, senders=senders,
            delivered_up=delivered_up, contrib=contrib, up_wasted=up_wasted,
            nominal_recv=nominal_recv, delivered_dn=delivered_dn,
            dn_wasted=dn_wasted, all_failed=all_failed)

    def run_views(self, schedule: np.ndarray,
                  dl_recipients: str = "all") -> List["RoundFaults"]:
        """Round views for a whole cohort schedule (rounds, n_active)."""
        return [self.round_view(t, schedule[t], dl_recipients)
                for t in range(min(self.rounds, len(schedule)))]

    def flip_bit(self, t: int, client: int, link: int, attempt: int,
                 nbits: int) -> int:
        """Deterministic corrupted-bit position for one frame copy."""
        u = self.flip_u[t, client, link, min(attempt,
                                             self.flip_u.shape[-1] - 1)]
        return min(int(u * nbits), nbits - 1)


@dataclass(frozen=True)
class RoundFaults:
    """One round's resolved fault view (all masks over global client ids)."""

    t: int
    plan: FaultPlan
    active: np.ndarray        # cohort ids (sorted, from cohort_schedule)
    in_cohort: np.ndarray     # (n,) bool
    online: np.ndarray        # (n,) bool: not dropped this round
    senders: np.ndarray       # (n,) bool: cohort members that transmit
    delivered_up: np.ndarray  # (n,) bool: uplink bundle arrived clean
    contrib: np.ndarray       # (n,) bool: counted into the aggregate
    up_wasted: np.ndarray     # (n,) int: corrupted uplink copies billed
    nominal_recv: np.ndarray  # (n,) bool: downlink audience (no faults)
    delivered_dn: np.ndarray  # (n,) bool: downlink bundle arrived clean
    dn_wasted: np.ndarray     # (n,) int: corrupted downlink copies billed
    all_failed: bool          # zero contributors: the round aborts

    @property
    def faulty(self) -> bool:
        """Anything at all deviated from the fault-free round."""
        return (not bool(self.delivered_up[self.in_cohort].all())
                or bool((self.straggled).any())
                or int(self.up_wasted.sum()) > 0
                or int(self.dn_wasted.sum()) > 0
                or not bool(self.delivered_dn[self.nominal_recv].all()))

    @property
    def dropped(self) -> np.ndarray:
        return self.in_cohort & ~self.online

    @property
    def straggled(self) -> np.ndarray:
        return self.delivered_up & ~self.contrib

    @property
    def lost_up(self) -> np.ndarray:
        return self.senders & ~self.delivered_up

    @property
    def lost_dn(self) -> np.ndarray:
        return self.nominal_recv & self.online & ~self.delivered_dn \
            if not self.all_failed else np.zeros_like(self.online)

    # -- booking fractions (engine-side bit scaling) ----------------------

    @property
    def up_weight(self) -> np.ndarray:
        """(n_active,) f32 aggregation weights over cohort positions."""
        return self.contrib[self.active].astype(np.float32)

    def up_scale(self, n_active: int) -> float:
        """Delivered fraction of the nominal uplink total."""
        return float(self.delivered_up.sum()) / n_active

    def up_retrans_scale(self, n_active: int) -> float:
        return float(self.up_wasted.sum()) / n_active

    def dn_scale(self, denom: int) -> float:
        return float(self.delivered_dn.sum()) / denom

    def dn_retrans_scale(self, denom: int) -> float:
        return float(self.dn_wasted.sum()) / denom

    def overhead_scale(self) -> float:
        """Online fraction: CTRL side information reaches online clients."""
        return float(self.online.sum()) / len(self.online)

    @property
    def backoff_s(self) -> float:
        """Total retry backoff delay recorded for this round (seconds)."""
        return sum(self.plan.backoff_s(int(k))
                   for k in np.concatenate([self.up_wasted, self.dn_wasted])
                   if k)

    def event(self, retransmit_bits: float = 0.0) -> Optional[Dict[str, Any]]:
        """Event-log entry for ``out["faults"]``; None for clean rounds."""
        if not self.faulty and not self.all_failed:
            return None
        ids = np.arange(len(self.online))
        return {
            "round": self.t,
            "dropped": ids[self.dropped].tolist(),
            "stragglers": ids[self.straggled].tolist(),
            "lost_uplink": ids[self.lost_up].tolist(),
            "lost_downlink": ids[self.lost_dn].tolist(),
            "retransmits_up": int(self.up_wasted.sum()),
            "retransmits_down": int(self.dn_wasted.sum()),
            "retransmit_bits": float(retransmit_bits),
            "backoff_s": float(self.backoff_s),
            "survivors": int(self.contrib.sum()),
            "all_failed": bool(self.all_failed),
        }


def fault_report(plan: FaultPlan, views: List[RoundFaults],
                 retransmit_by_round) -> Dict[str, Any]:
    """Assemble ``out["faults"]``: config + event log + run summary.

    Built purely from the precomputed schedule and the engine's per-round
    retransmit bookings, so host and fused runs produce the identical
    report by construction.
    """
    events = []
    for rf in views:
        ev = rf.event(retransmit_bits=retransmit_by_round[rf.t]
                      if retransmit_by_round is not None else 0.0)
        if ev is not None:
            events.append(ev)
    return {
        "plan": asdict(plan),
        "events": events,
        "summary": {
            "rounds": len(views),
            "faulty_rounds": len(events),
            "all_failed_rounds": sum(e["all_failed"] for e in events),
            "dropped_total": sum(len(e["dropped"]) for e in events),
            "stragglers_total": sum(len(e["stragglers"]) for e in events),
            "lost_uplink_total": sum(len(e["lost_uplink"]) for e in events),
            "lost_downlink_total": sum(len(e["lost_downlink"])
                                       for e in events),
            "retransmits_total": sum(e["retransmits_up"]
                                     + e["retransmits_down"]
                                     for e in events),
            "retransmit_bits_total": sum(e["retransmit_bits"]
                                         for e in events),
            "backoff_s_total": sum(e["backoff_s"] for e in events),
        },
    }


def corrupt_copy(frame_bytes: bytes, bitpos: int) -> bytes:
    """One corrupted wire copy of a frame: ``bitpos`` flipped (MSB-first)."""
    out = bytearray(frame_bytes)
    out[bitpos // 8] ^= 0x80 >> (bitpos % 8)
    return bytes(out)
