"""MSB-first bit packing: the lowest layer of the wire format.

``BitWriter`` packs integer fields of arbitrary bit width into a byte
stream, most-significant bit first (network bit order), so a field of
width w always occupies exactly w bits regardless of byte boundaries.
``BitReader`` is its exact inverse.  Floats cross the wire as IEEE-754
big-endian bit patterns (``write_f32`` / ``read_f32``): the round-trip is
bit-exact by construction, never a decimal detour.

Both ends count bits (``bits_written`` / ``bits_read``) so codecs can be
audited against :class:`repro_torch.core.bitmeter.BitMeter` bookings, and both
support byte alignment (``align``) for framing payload boundaries.

Error taxonomy (all subclasses of :class:`WireError`, itself a ValueError
so pre-existing ``except ValueError`` call sites keep working):

* :class:`WireFormatError`   -- structurally malformed data: bad magic,
  overrunning reads (truncation), nonzero padding, out-of-contract widths;
* :class:`WireIntegrityError` -- structurally sound but corrupted in
  flight: the frame CRC32 trailer does not match the received bytes.

Anything raised while parsing wire bytes is a ``WireError`` -- never a bare
``IndexError`` or struct noise -- so retry loops can catch one type.
"""
from __future__ import annotations

import zlib

import numpy as np


class WireError(ValueError):
    """Base class: anything wrong with data on (or for) the wire."""


class WireFormatError(WireError):
    """Malformed or out-of-contract wire data (loud by design)."""


class WireIntegrityError(WireError):
    """Frame failed its CRC32 integrity check: corrupted in flight."""


class BitWriter:
    """Accumulates an MSB-first bit stream."""

    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0       # bit accumulator, MSB side filled first
        self._nacc = 0      # bits currently in the accumulator

    @property
    def bits_written(self) -> int:
        return 8 * len(self._bytes) + self._nacc

    def write(self, value: int, width: int) -> None:
        """Write ``value`` as an unsigned ``width``-bit field."""
        value = int(value)
        width = int(width)
        if width < 0:
            raise WireFormatError(f"negative width {width}")
        if width == 0:
            if value != 0:
                raise WireFormatError(f"value {value} in zero-width field")
            return
        if value < 0 or value >> width:
            raise WireFormatError(
                f"value {value} does not fit in {width} bits")
        self._acc = (self._acc << width) | value
        self._nacc += width
        while self._nacc >= 8:
            self._nacc -= 8
            self._bytes.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_f32(self, x) -> None:
        """Write one float32 as its big-endian IEEE-754 bit pattern."""
        self.write(int(np.float32(x).view(np.uint32)), 32)

    def write_f32_array(self, xs) -> None:
        arr = np.asarray(xs, dtype=np.float32).reshape(-1)
        if self._nacc == 0:  # byte-aligned: bulk big-endian append
            self._bytes.extend(arr.astype(">f4").tobytes())
            return
        for u in arr.view(np.uint32):
            self.write(int(u), 32)

    def write_bits(self, data: bytes, nbits: int) -> None:
        """Splice ``nbits`` MSB-first bits from ``data`` (relay payloads)."""
        if nbits > 8 * len(data):
            raise WireFormatError(
                f"asked for {nbits} bits from {len(data)} bytes")
        full, rem = divmod(int(nbits), 8)
        if self._nacc == 0:  # byte-aligned: bulk append of the whole bytes
            self._bytes.extend(data[:full])
        else:
            for b in data[:full]:
                self.write(b, 8)
        if rem:
            self.write(data[full] >> (8 - rem), rem)

    def align(self) -> int:
        """Zero-pad to the next byte boundary; returns the pad width (< 8)."""
        pad = (-self._nacc) % 8
        if pad:
            self.write(0, pad)
        return pad

    @property
    def byte_offset(self) -> int:
        """Current write position in whole bytes (must be byte-aligned)."""
        if self._nacc:
            raise WireFormatError(
                f"byte_offset taken mid-byte ({self._nacc} pending bits)")
        return len(self._bytes)

    def crc32(self, start_byte: int) -> int:
        """CRC32 of the bytes written since ``start_byte`` (aligned span)."""
        if self._nacc:
            raise WireFormatError(
                f"crc32 taken mid-byte ({self._nacc} pending bits)")
        return zlib.crc32(memoryview(self._bytes)[start_byte:]) & 0xFFFFFFFF

    def getvalue(self) -> bytes:
        """The stream so far, zero-padded to whole bytes (non-destructive)."""
        out = bytearray(self._bytes)
        if self._nacc:
            out.append((self._acc << (8 - self._nacc)) & 0xFF)
        return bytes(out)


class BitReader:
    """Reads an MSB-first bit stream produced by :class:`BitWriter`."""

    def __init__(self, data: bytes, nbits: int | None = None):
        self._data = bytes(data)
        self._nbits = 8 * len(self._data) if nbits is None else int(nbits)
        if self._nbits > 8 * len(self._data):
            raise WireFormatError(
                f"{self._nbits} bits promised but only "
                f"{len(self._data)} bytes present")
        self._pos = 0  # bit cursor

    @property
    def bits_read(self) -> int:
        return self._pos

    @property
    def bits_left(self) -> int:
        return self._nbits - self._pos

    def read(self, width: int) -> int:
        width = int(width)
        if width < 0:
            raise WireFormatError(f"negative width {width}")
        if width == 0:
            return 0
        if self._pos + width > self._nbits:
            raise WireFormatError(
                f"read of {width} bits overruns stream "
                f"({self.bits_left} left)")
        out = 0
        pos = self._pos
        remaining = width
        while remaining:
            byte = self._data[pos >> 3]
            offset = pos & 7
            take = min(8 - offset, remaining)
            chunk = (byte >> (8 - offset - take)) & ((1 << take) - 1)
            out = (out << take) | chunk
            pos += take
            remaining -= take
        self._pos = pos
        return out

    def read_f32(self) -> np.float32:
        return np.uint32(self.read(32)).view(np.float32)

    def read_f32_array(self, n: int) -> np.ndarray:
        if self._pos % 8 == 0 and self._pos + 32 * n <= self._nbits:
            start = self._pos >> 3  # byte-aligned: bulk big-endian view
            self._pos += 32 * n
            return np.frombuffer(self._data, dtype=">f4", count=n,
                                 offset=start).astype(np.float32)
        out = np.empty(n, dtype=np.uint32)
        for i in range(n):
            out[i] = self.read(32)
        return out.view(np.float32)

    def read_payload(self, nbits: int) -> tuple:
        """Extract ``nbits`` as a standalone ``(bytes, nbits)`` sub-stream."""
        nbits = int(nbits)
        if self._pos % 8 == 0:  # byte-aligned: bulk byte slice
            if self._pos + nbits > self._nbits:
                raise WireFormatError(
                    f"read of {nbits} bits overruns stream "
                    f"({self.bits_left} left)")
            start = self._pos >> 3
            nbytes = -(-nbits // 8)
            chunk = bytearray(self._data[start:start + nbytes])
            if nbits % 8:  # zero the trailing pad bits of the last byte
                chunk[-1] &= 0xFF << (8 - nbits % 8) & 0xFF
            self._pos += nbits
            return bytes(chunk), nbits
        w = BitWriter()
        full, rem = divmod(nbits, 8)
        for _ in range(full):
            w.write(self.read(8), 8)
        if rem:
            w.write(self.read(rem), rem)
        return w.getvalue(), nbits

    def align(self) -> None:
        pad = (-self._pos) % 8
        if pad and self.read(pad) != 0:
            raise WireFormatError("nonzero alignment padding")

    def crc32(self, start_byte: int, end_byte: int) -> int:
        """CRC32 of the underlying bytes in ``[start_byte, end_byte)``."""
        if not 0 <= start_byte <= end_byte <= len(self._data):
            raise WireFormatError(
                f"crc32 span [{start_byte}, {end_byte}) outside "
                f"{len(self._data)}-byte stream")
        return zlib.crc32(memoryview(self._data)[start_byte:end_byte]) \
            & 0xFFFFFFFF

    def expect_exhausted(self) -> None:
        if self.bits_left:
            raise WireFormatError(f"{self.bits_left} unread bits left")
