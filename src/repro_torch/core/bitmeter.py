"""Communication accounting (bits, bpp) for all schemes.

Conventions follow the paper's tables (Appendix I):

* bpp columns are *per client, per parameter, per global round*;
* total bpp = uplink + downlink;
* bpp (BC): when a broadcast downlink exists, the downlink of every scheme
  whose downlink payload is identical for all clients is divided by n
  (BiCompFL-PR cannot profit -- its downlink is client-specific).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


class ReconcileError(AssertionError):
    """Booked bits diverge from a serialized wire stream (loud by design)."""


@dataclass
class BitMeter:
    """Accumulates uplink/downlink bits over rounds for one scheme."""

    n_clients: int
    d: int
    broadcast_downlink_shareable: bool = True  # False for PR-style downlinks
    uplink_bits: float = 0.0    # summed over clients and rounds
    downlink_bits: float = 0.0  # summed over clients and rounds
    retransmit_bits: float = 0.0  # corrupted-in-flight copies (both links)
    rounds: int = 0
    history: List[Dict[str, float]] = field(default_factory=list)

    def add_round(self, uplink_bits_total: float, downlink_bits_total: float,
                  overhead_bits: float = 0.0,
                  retransmit_bits: float = 0.0) -> None:
        """Book one global round. Totals are summed across clients.

        ``retransmit_bits`` are payload bits of frame copies that were
        corrupted in flight and had to be resent (or were lost after the
        retry budget): they count toward ``total_bits`` -- the real price
        of an unreliable link -- but never toward the per-direction
        *useful* payload totals the wire stream reconciles.
        """
        self.uplink_bits += uplink_bits_total + overhead_bits
        self.downlink_bits += downlink_bits_total
        self.retransmit_bits += retransmit_bits
        self.rounds += 1
        entry = {
            "round": self.rounds,
            "uplink_bits": uplink_bits_total + overhead_bits,
            "downlink_bits": downlink_bits_total,
            "cum_bits": self.uplink_bits + self.downlink_bits
            + self.retransmit_bits,
        }
        if retransmit_bits:
            entry["retransmit_bits"] = retransmit_bits
        self.history.append(entry)

    def book_run(self, uplink_bits, downlink_bits, overhead_bits=0.0,
                 retransmit_bits=0.0, snapshot_mask=None):
        """Book a whole run's rounds in one call (per-round total sequences).

        Used after a fused (device-resident) execution.  With a static
        block plan the per-round bit totals are data-independent Python
        floats and the meter replays them host-side with the same per-round
        float arithmetic as the host loop; with a bucketed adaptive plan
        the engine hands over the traced per-round bits vectors that came
        out of the scan.  ``overhead_bits`` is either one per-round scalar
        or a per-round sequence (the adaptive side-information varies with
        the round's plan).  Returns the ``(total_bits, total_bpp)``
        snapshot after each round where ``snapshot_mask`` is True (every
        round when None) -- the values the engine's history entries record
        at evaluation rounds.
        """
        per_round_overhead = hasattr(overhead_bits, "__len__")
        per_round_retrans = hasattr(retransmit_bits, "__len__")
        snaps = []
        for t, (u, dl) in enumerate(zip(uplink_bits, downlink_bits)):
            oh = overhead_bits[t] if per_round_overhead else overhead_bits
            rt = retransmit_bits[t] if per_round_retrans else retransmit_bits
            self.add_round(float(u), float(dl), overhead_bits=float(oh),
                           retransmit_bits=float(rt))
            if snapshot_mask is None or snapshot_mask[t]:
                snaps.append((self.total_bits, self.total_bpp))
        return snaps

    # --- per-client per-param per-round averages (the table columns) -----
    def _per(self, bits: float) -> float:
        if self.rounds == 0:
            return 0.0
        return bits / (self.n_clients * self.d * self.rounds)

    @property
    def uplink_bpp(self) -> float:
        return self._per(self.uplink_bits)

    @property
    def downlink_bpp(self) -> float:
        return self._per(self.downlink_bits)

    @property
    def retransmit_bpp(self) -> float:
        return self._per(self.retransmit_bits)

    @property
    def total_bpp(self) -> float:
        return self.uplink_bpp + self.downlink_bpp + self.retransmit_bpp

    @property
    def total_bpp_bc(self) -> float:
        """Total bpp when a broadcast downlink channel is available."""
        dl = self.downlink_bpp
        if self.broadcast_downlink_shareable:
            dl = dl / self.n_clients
        return self.uplink_bpp + dl + self.retransmit_bpp

    @property
    def total_bits(self) -> float:
        return self.uplink_bits + self.downlink_bits + self.retransmit_bits

    def reconcile(self, uplink_stream_bits: float,
                  downlink_stream_bits: float, *,
                  retransmit_stream_bits: float = 0.0,
                  framing_bits: float = 0.0,
                  n_messages: int = 0, frame_overhead_bits: int = 0,
                  tol_bits: float = 0.0,
                  rel_tol: float = 1e-9) -> Dict[str, float]:
        """Audit booked bits against serialized stream lengths.

        ``uplink_stream_bits`` / ``downlink_stream_bits`` are the summed
        *payload* bits of a wire stream per direction (framing excluded);
        they must match the booked per-direction totals within ``tol_bits``
        plus a ``rel_tol`` relative slack for float64 bookkeeping round-off
        (the codecs themselves are exact -- see repro.wire.frame for the
        tolerance contract).  ``retransmit_stream_bits`` are the summed
        payload bits of corrupted-in-flight frame copies and must match
        the booked ``retransmit_bits`` the same way.  When framing figures
        are supplied, the framing overhead must lie within the per-message
        envelope ``[n_messages * frame_overhead_bits,
        n_messages * (frame_overhead_bits + 7)]`` (header + CRC trailer +
        <8 pad bits).  Raises :class:`ReconcileError` on any divergence;
        returns the audit report otherwise.
        """
        def check(link: str, booked: float, stream: float) -> float:
            err = abs(booked - stream)
            tol = tol_bits + rel_tol * max(abs(booked), abs(stream))
            if err > tol:
                raise ReconcileError(
                    f"{link} booked {booked} bits but the wire stream "
                    f"carries {stream} payload bits (|diff| {err} > "
                    f"tolerance {tol})")
            return err

        up_err = check("uplink", self.uplink_bits, uplink_stream_bits)
        dn_err = check("downlink", self.downlink_bits, downlink_stream_bits)
        rt_err = check("retransmit", self.retransmit_bits,
                       retransmit_stream_bits)
        if n_messages:
            lo = n_messages * frame_overhead_bits
            hi = n_messages * (frame_overhead_bits + 7)
            if not lo <= framing_bits <= hi:
                raise ReconcileError(
                    f"framing overhead {framing_bits} bits outside "
                    f"[{lo}, {hi}] for {n_messages} messages of "
                    f"{frame_overhead_bits}-bit frame overhead")
        return {
            "uplink_booked_bits": self.uplink_bits,
            "uplink_stream_bits": uplink_stream_bits,
            "uplink_err_bits": up_err,
            "downlink_booked_bits": self.downlink_bits,
            "downlink_stream_bits": downlink_stream_bits,
            "downlink_err_bits": dn_err,
            "retransmit_booked_bits": self.retransmit_bits,
            "retransmit_stream_bits": retransmit_stream_bits,
            "retransmit_err_bits": rt_err,
            "framing_bits": framing_bits,
            "n_messages": n_messages,
        }

    def summary(self) -> Dict[str, float]:
        return {
            "bpp": self.total_bpp,
            "bpp_bc": self.total_bpp_bc,
            "uplink_bpp": self.uplink_bpp,
            "downlink_bpp": self.downlink_bpp,
            "retransmit_bpp": self.retransmit_bpp,
            "total_bits": self.total_bits,
            "retransmit_bits": self.retransmit_bits,
            "rounds": self.rounds,
        }
