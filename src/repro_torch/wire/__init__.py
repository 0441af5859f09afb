"""repro_torch.wire: a real bitstream layer for every FL channel (a copy of
``repro.wire``, numpy and zlib only, so that the port imports nothing of
the reference; its bytes are the reference's, pinned by
``tests/golden/wire_session_v2.bin``).

The BitMeter books *theoretical* bits; this package makes the accounting
falsifiable.  Channels gain ``encode_up`` / ``decode_up`` /
``encode_down`` / ``decode_down`` hooks that serialize the exact values
the functional core selects (``repro_torch.fl.channels``; tensors cross to numpy at the codec
boundary), the engine's
``wire="audit"`` mode routes a whole host run through encode -> decode
each round (bit-identical trajectory, cf. tests/test_torch_wire.py), and
:meth:`WireSession.reconcile` fails loudly whenever booked bits diverge
from the serialized stream beyond the documented framing overhead.

Layers (lowest first): :mod:`.bitio` (MSB-first bit packing),
:mod:`.codecs` (per-channel-family payloads), :mod:`.frame` (message
envelope + session stream + the reconcile tolerance contract).
"""
from __future__ import annotations

import zlib

from .bitio import (BitReader, BitWriter, WireError,  # noqa: F401
                    WireFormatError, WireIntegrityError)
from .codecs import WireCapacityError  # noqa: F401
from .frame import (DIR_CTRL, DIR_DOWN, DIR_FLUSH_DOWN,  # noqa: F401
                    DIR_FLUSH_UP, DIR_UP, DOWNLINK_DIRS,
                    FRAME_HEADER_BITS, FRAME_OVERHEAD_BITS,
                    FRAME_TRAILER_BITS, MAGIC, Message, RECONCILE_REL_TOL,
                    RECONCILE_TOL_BITS, SERVER, UPLINK_DIRS, VERSION,
                    WastedAttempt, WireSession)


def scheme_wire_id(name: str) -> int:
    """Stable 16-bit scheme identifier for message framing."""
    return zlib.crc32(name.encode("utf-8")) & 0xFFFF
