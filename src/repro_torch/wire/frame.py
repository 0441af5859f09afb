"""Message framing: the self-describing envelope around channel payloads.

Every encoded channel payload travels inside one :class:`Message` frame:

====================  =====  ====================================
field                 bits   meaning
====================  =====  ====================================
magic                 16     ``MAGIC`` (0xB1C0)
version               8      ``VERSION`` (bump on layout change)
round                 32     global round index t
direction             8      DIR_* (uplink / downlink / control /
                             flush-up / flush-down)
scheme_id             16     crc32(scheme name) & 0xFFFF
sender                16     client id, or ``SERVER``
recipient             16     client id, or ``SERVER``
payload_bits          32     exact payload length in bits
====================  =====  ====================================

Header total: ``FRAME_HEADER_BITS`` = 144 (18 bytes, byte-aligned by
construction).  The payload follows immediately and is zero-padded to the
next byte boundary (< 8 pad bits per message); a ``FRAME_TRAILER_BITS`` =
32-bit CRC32 over the frame's header + payload + pad bytes closes the
frame (format v2), so frames concatenate into one byte stream that
:meth:`WireSession.parse` can split back apart *and* every frame carries
its own integrity check.  CRC32 detects every single-bit flip and every
burst error up to 32 bits; a mismatch raises
:class:`~repro_torch.wire.bitio.WireIntegrityError`, truncation or garbage
raises :class:`~repro_torch.wire.bitio.WireFormatError` -- both are
:class:`~repro_torch.wire.bitio.WireError`, never a bare ``IndexError``.

The **reconcile tolerance contract** (see DESIGN.md): booked BitMeter
bits and summed payload bits must agree to within ``RECONCILE_TOL_BITS``
(= 0.0 -- codecs are exact) plus a 1e-9 *relative* slack for float64
bookkeeping round-off (e.g. ``SliceDownlink`` books ``n * (d/n) * 32``,
whose float division may differ from the integer stream length by ULPs).
Framing overhead is audited separately: it must lie in
``[n_messages * FRAME_OVERHEAD_BITS,
n_messages * (FRAME_OVERHEAD_BITS + 7)]`` where ``FRAME_OVERHEAD_BITS``
= header + CRC trailer.  Retransmitted (corrupted-in-flight) frames are
tracked on the session as *wasted* copies: their payload bits reconcile
against the meter's ``retransmit_bits`` category, never against the
clean per-direction totals.  Widening any bound is a format change and
must be reflected in DESIGN.md (tests/test_wire.py and tests/test_torch_wire.py tripwire the
documented values).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .bitio import (BitReader, BitWriter, WireError, WireFormatError,
                    WireIntegrityError)

MAGIC = 0xB1C0
VERSION = 2   # v2: CRC32 trailer after the padded payload

DIR_UP = 0          # client -> server channel payload
DIR_DOWN = 1        # server -> client channel payload
DIR_CTRL = 2        # server -> client block-plan header (allocation overhead)
DIR_FLUSH_UP = 3    # client -> server EF-memory sync payload
DIR_FLUSH_DOWN = 4  # server -> client synced-model broadcast
_DIRECTIONS = (DIR_UP, DIR_DOWN, DIR_CTRL, DIR_FLUSH_UP, DIR_FLUSH_DOWN)

# Directions whose payload bits the BitMeter books on each link.
UPLINK_DIRS = frozenset({DIR_UP, DIR_CTRL, DIR_FLUSH_UP})
DOWNLINK_DIRS = frozenset({DIR_DOWN, DIR_FLUSH_DOWN})

SERVER = 0xFFFF     # sentinel id for the federator endpoint

FRAME_HEADER_BITS = 16 + 8 + 32 + 8 + 16 + 16 + 16 + 32  # == 144
FRAME_TRAILER_BITS = 32                                   # CRC32
FRAME_OVERHEAD_BITS = FRAME_HEADER_BITS + FRAME_TRAILER_BITS  # == 176
RECONCILE_TOL_BITS = 0.0
# Relative slack for float64 round-off in *booked* bits (not in streams).
RECONCILE_REL_TOL = 1e-9


@dataclass
class Message:
    """One framed payload.  Channels fill direction/sender/recipient and
    the payload; the engine stamps ``round`` and ``scheme_id``."""

    direction: int
    sender: int
    recipient: int
    payload: bytes
    payload_bits: int
    round: int = 0
    scheme_id: int = 0

    def __post_init__(self):
        if self.direction not in _DIRECTIONS:
            raise WireFormatError(f"unknown direction {self.direction}")
        if not (0 <= self.payload_bits <= 8 * len(self.payload)
                < self.payload_bits + 8):
            raise WireFormatError(
                f"payload of {len(self.payload)} bytes cannot carry "
                f"{self.payload_bits} bits (+<8 pad)")

    @property
    def frame_bits(self) -> int:
        """Bits this message occupies on the stream: header, padded
        payload, CRC trailer."""
        return FRAME_HEADER_BITS + 8 * len(self.payload) + FRAME_TRAILER_BITS

    def write_to(self, w: BitWriter) -> None:
        start = w.byte_offset  # frames start byte-aligned by construction
        w.write(MAGIC, 16)
        w.write(VERSION, 8)
        w.write(self.round, 32)
        w.write(self.direction, 8)
        w.write(self.scheme_id, 16)
        w.write(self.sender, 16)
        w.write(self.recipient, 16)
        w.write(self.payload_bits, 32)
        w.write_bits(self.payload, self.payload_bits)
        w.align()
        w.write(w.crc32(start), FRAME_TRAILER_BITS)

    def to_bytes(self) -> bytes:
        """This frame alone as wire bytes (header + payload + CRC)."""
        w = BitWriter()
        self.write_to(w)
        return w.getvalue()

    @classmethod
    def read_from(cls, r: BitReader) -> "Message":
        if r.bits_read % 8:
            raise WireFormatError(
                f"frame must start byte-aligned (bit {r.bits_read})")
        start = r.bits_read // 8
        if r.read(16) != MAGIC:
            raise WireFormatError("bad magic")
        ver = r.read(8)
        if ver != VERSION:
            raise WireFormatError(f"unsupported version {ver}")
        rnd = r.read(32)
        direction = r.read(8)
        scheme_id = r.read(16)
        sender = r.read(16)
        recipient = r.read(16)
        nbits = r.read(32)
        payload, _ = r.read_payload(nbits)
        r.align()
        expected = r.crc32(start, r.bits_read // 8)
        stored = r.read(FRAME_TRAILER_BITS)
        if stored != expected:
            raise WireIntegrityError(
                f"frame CRC mismatch (stored {stored:#010x}, computed "
                f"{expected:#010x}): frame corrupted in flight")
        return cls(direction=direction, sender=sender, recipient=recipient,
                   payload=payload, payload_bits=nbits, round=rnd,
                   scheme_id=scheme_id)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Message":
        """Parse exactly one frame from ``data`` (must consume it fully)."""
        r = BitReader(data)
        m = cls.read_from(r)
        if r.bits_left >= 8:
            raise WireFormatError(
                f"{r.bits_left} bits of trailing garbage after frame")
        return m


@dataclass
class WastedAttempt:
    """One corrupted-in-flight frame copy (retransmission accounting).

    ``frame`` is the *clean* message whose delivery the copy attempted;
    its payload/frame bits are what the retry cost on the wire.  The
    corrupted bytes themselves are not retained -- only their cost and
    the fault position, which is all the accounting needs."""

    frame: Message
    round: int
    attempt: int          # 0-based retry index for this delivery
    flipped_bit: int      # bit position corrupted in the frame copy

    @property
    def payload_bits(self) -> int:
        return self.frame.payload_bits

    @property
    def frame_bits(self) -> int:
        return self.frame.frame_bits


@dataclass
class WireSession:
    """All frames of one engine run, in transmission order.

    ``messages`` holds the *delivered* (clean) traffic that drives the
    trajectory; ``wasted`` holds corrupted copies that forced a
    retransmission (or exhausted the retry budget).  Only ``messages``
    serialize into :meth:`to_bytes` -- a parsed stream must be fully
    intact by construction -- while ``wasted`` reconciles against the
    BitMeter's ``retransmit_bits``."""

    scheme_id: int = 0
    messages: List[Message] = field(default_factory=list)
    wasted: List[WastedAttempt] = field(default_factory=list)

    def add(self, msgs, *, round: int) -> None:
        for m in msgs:
            m.round = round
            m.scheme_id = self.scheme_id
            self.messages.append(m)

    def add_wasted(self, msg: Message, *, round: int, attempt: int,
                   flipped_bit: int) -> None:
        msg.round = round
        msg.scheme_id = self.scheme_id
        self.wasted.append(WastedAttempt(frame=msg, round=round,
                                         attempt=attempt,
                                         flipped_bit=flipped_bit))

    # -- stream (de)serialization -----------------------------------------

    def to_bytes(self) -> bytes:
        w = BitWriter()
        for m in self.messages:
            m.write_to(w)
        return w.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "WireSession":
        r = BitReader(data)
        out = cls()
        while r.bits_left:
            idx, off = len(out.messages), r.bits_read // 8
            try:
                out.messages.append(Message.read_from(r))
            except WireError as e:
                raise type(e)(
                    f"frame {idx} at byte offset {off}: {e}") from e
            except Exception as e:  # defensive: no bare IndexError escapes
                raise WireFormatError(
                    f"frame {idx} at byte offset {off}: "
                    f"{type(e).__name__}: {e}") from e
        if out.messages:
            out.scheme_id = out.messages[0].scheme_id
        return out

    # -- audit totals ------------------------------------------------------

    def payload_bits(self, directions=None) -> int:
        return sum(m.payload_bits for m in self.messages
                   if directions is None or m.direction in directions)

    @property
    def uplink_payload_bits(self) -> int:
        return self.payload_bits(UPLINK_DIRS)

    @property
    def downlink_payload_bits(self) -> int:
        return self.payload_bits(DOWNLINK_DIRS)

    @property
    def retransmit_payload_bits(self) -> int:
        """Payload bits of every corrupted copy (any direction)."""
        return sum(wa.payload_bits for wa in self.wasted)

    @property
    def retransmit_frame_bits(self) -> int:
        return sum(wa.frame_bits for wa in self.wasted)

    @property
    def stream_bits(self) -> int:
        return sum(m.frame_bits for m in self.messages)

    @property
    def framing_bits(self) -> int:
        """Header + pad + CRC bits: stream length minus payload bits."""
        return self.stream_bits - self.payload_bits()

    def summary(self) -> Dict[str, float]:
        return {
            "messages": len(self.messages),
            "stream_bytes": -(-self.stream_bits // 8),
            "stream_bits": self.stream_bits,
            "payload_bits": self.payload_bits(),
            "uplink_payload_bits": self.uplink_payload_bits,
            "downlink_payload_bits": self.downlink_payload_bits,
            "framing_bits": self.framing_bits,
            "frame_header_bits": FRAME_HEADER_BITS,
            "frame_overhead_bits": FRAME_OVERHEAD_BITS,
            "wasted_messages": len(self.wasted),
            "retransmit_payload_bits": self.retransmit_payload_bits,
            "retransmit_frame_bits": self.retransmit_frame_bits,
        }

    def reconcile(self, meter) -> Dict[str, float]:
        """Audit booked bits against the serialized stream (fails loudly)."""
        report = meter.reconcile(
            self.uplink_payload_bits, self.downlink_payload_bits,
            retransmit_stream_bits=self.retransmit_payload_bits,
            framing_bits=self.framing_bits, n_messages=len(self.messages),
            frame_overhead_bits=FRAME_OVERHEAD_BITS,
            tol_bits=RECONCILE_TOL_BITS, rel_tol=RECONCILE_REL_TOL)
        report.update(self.summary())
        return report
