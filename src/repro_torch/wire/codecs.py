"""Payload codecs for every channel family (cf. DESIGN.md "Wire format").

Each codec writes *exactly* the bits its channel books in the BitMeter:

* **MRC index streams** -- one ``ceil(log2(n_is))``-bit field per conveyed
  sample per (billable) block.  Registry schemes use power-of-two ``n_is``,
  so the codec width equals the booked ``log2(n_is)`` exactly; a
  non-power-of-two ``n_is`` books fractional bits no integer codec can
  meet and is rejected loudly.
* **Block-plan headers** -- AdaptiveAvg: the pow2 size exponent in
  ``ceil(log2(max_block))`` bits.  Adaptive (segment) plans: one
  ``(length - 1)`` field of ``ceil(log2(max_block))`` bits per billable
  segment, exactly the ``billable * ceil(log2(max_block))`` overhead the
  allocation books; segments longer than ``max_block`` cannot be
  represented at the booked rate and raise :class:`WireCapacityError`.
* **Sign payloads** -- per compression pass: one f32 scale + a d-bit sign
  bitmap (``v >= 0``), i.e. the ``d + 32`` bits/pass the EF channels book.
* **Top-k records** -- per kept entry: a ``ceil(log2(d))``-bit index + an
  f32 value, matching ``quantizers.topk_bits``.
* **Dense payloads** -- raw big-endian f32, 32 bits/value.

All functions take/return numpy arrays; float round-trips are bit-exact.
"""
from __future__ import annotations

import math

import numpy as np

from .bitio import BitReader, BitWriter, WireFormatError


class WireCapacityError(WireFormatError):
    """A value cannot be represented at the booked field width."""


# ---------------------------------------------------------------------------
# MRC index streams.
# ---------------------------------------------------------------------------


def index_width(n_is: int) -> int:
    """Bits per MRC index; must equal the booked log2(n_is) exactly."""
    w = math.ceil(math.log2(n_is))
    if 2 ** w != n_is:
        raise WireCapacityError(
            f"n_is={n_is} books fractional bits per index "
            f"(log2={math.log2(n_is):.4f}); wire codecs need a power of two")
    return w


def put_indices(w: BitWriter, indices, n_is: int) -> None:
    """Write an index array (any shape) row-major at index_width bits each."""
    width = index_width(n_is)
    for v in np.asarray(indices, dtype=np.int64).reshape(-1):
        w.write(int(v), width)


def get_indices(r: BitReader, shape, n_is: int) -> np.ndarray:
    width = index_width(n_is)
    count = int(np.prod(shape))
    out = np.empty(count, dtype=np.int32)
    for i in range(count):
        out[i] = r.read(width)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Block-plan headers (the allocation side information).
# ---------------------------------------------------------------------------


def _plan_field_width(max_block: int) -> int:
    return math.ceil(math.log2(max_block))


def put_plan_avg(w: BitWriter, size: int, max_block: int) -> None:
    """AdaptiveAvg header: the pow2 block-size exponent."""
    k = int(math.log2(size))
    if 2 ** k != size:
        raise WireCapacityError(f"block size {size} is not a power of two")
    w.write(k, _plan_field_width(max_block))


def get_plan_avg(r: BitReader, max_block: int) -> int:
    return 2 ** r.read(_plan_field_width(max_block))


def put_plan_segments(w: BitWriter, seg_ids, max_block: int) -> None:
    """Adaptive header: per-segment ``length - 1`` fields.

    ``seg_ids`` must be the plan's non-decreasing per-parameter segment-id
    vector; every id in ``0..max`` occurs (duplicate bin edges collapse),
    so each length is >= 1 and ``length - 1`` fits ``ceil(log2(max_block))``
    bits iff the segment is no longer than ``max_block``.
    """
    seg = np.asarray(seg_ids, dtype=np.int64)
    if seg.size and (seg[0] != 0 or np.any(np.diff(seg) < 0)):
        raise WireFormatError(
            "plan seg_ids must be non-decreasing starting at 0: the header "
            "stores run-lengths, so any other ordering would round-trip to "
            "a different segmentation")
    lengths = np.bincount(seg, minlength=int(seg.max()) + 1)
    width = _plan_field_width(max_block)
    if np.any(lengths < 1):
        raise WireFormatError("empty segment in plan header")
    if np.any(lengths > max_block):
        raise WireCapacityError(
            f"segment of {int(lengths.max())} params exceeds max_block="
            f"{max_block}; the booked {width}-bit boundary fields cannot "
            "represent it")
    for ln in lengths:
        w.write(int(ln) - 1, width)


def get_plan_segments(r: BitReader, d: int, max_block: int) -> np.ndarray:
    """Read segment lengths until they tile [0, d); self-delimiting since
    every length is >= 1 and the lengths sum to exactly d."""
    width = _plan_field_width(max_block)
    lengths = []
    total = 0
    while total < d:
        ln = r.read(width) + 1
        lengths.append(ln)
        total += ln
    if total != d:
        raise WireFormatError(
            f"plan header lengths sum to {total}, expected {d}")
    return np.repeat(np.arange(len(lengths), dtype=np.int32),
                     np.asarray(lengths, dtype=np.int64))


# ---------------------------------------------------------------------------
# Sign / top-k / dense payloads.
# ---------------------------------------------------------------------------


def put_bitmap(w: BitWriter, bools) -> None:
    """Write a boolean vector as an MSB-first bitmap, 1 bit per entry."""
    arr = np.asarray(bools, dtype=bool).reshape(-1)
    w.write_bits(np.packbits(arr).tobytes(), arr.size)


def get_bitmap(r: BitReader, n: int) -> np.ndarray:
    data, _ = r.read_payload(n)
    return np.unpackbits(np.frombuffer(data, np.uint8), count=n).astype(bool)


def put_sign_pass(w: BitWriter, scale, signs) -> None:
    """One sign-EF compression pass: f32 scale + d-bit sign bitmap."""
    w.write_f32(scale)
    put_bitmap(w, signs)


def get_sign_pass(r: BitReader, d: int):
    scale = r.read_f32()
    return scale, get_bitmap(r, d)


def topk_index_width(d: int) -> int:
    return math.ceil(math.log2(max(d, 2)))  # matches quantizers.topk_bits


def put_topk(w: BitWriter, indices, values, d: int) -> None:
    iw = topk_index_width(d)
    idx = np.asarray(indices, dtype=np.int64).reshape(-1)
    val = np.asarray(values, dtype=np.float32).reshape(-1)
    if idx.shape != val.shape:
        raise WireFormatError("top-k index/value shape mismatch")
    for i, v in zip(idx, val):
        w.write(int(i), iw)
        w.write(int(np.float32(v).view(np.uint32)), 32)


def get_topk(r: BitReader, k: int, d: int):
    iw = topk_index_width(d)
    idx = np.empty(k, dtype=np.int32)
    val = np.empty(k, dtype=np.uint32)
    for i in range(k):
        idx[i] = r.read(iw)
        val[i] = r.read(32)
    return idx, val.view(np.float32)


def put_dense(w: BitWriter, values) -> None:
    w.write_f32_array(values)


def get_dense(r: BitReader, n: int) -> np.ndarray:
    return r.read_f32_array(n)
