"""``prng``'s draws on the card: the hand-written CUDA kernel and its layout.

Not a TPU kernel: the reference draws with ``jax.random``, which XLA fuses
into one loop, while ``prng`` spells Threefry-2x32 out in int64 torch ops
(its plain route, ``prng.draw_int64``).  On the card every draw of
``prng`` is one launch of ``csrc/threefry_draw.cu`` (``ops.threefry_draw``),
bit for bit the plain route.  A draw is ``(key, at, ndim, out, p)``:

* ``key``: int64 words ``(K..., 2)``;
* ``at``: a shape (positions ``0 .. prod(at) - 1``, row-major), an int
  (one position, ``fold_in``'s data) or an int64 tensor of positions
  whose last ``ndim`` axes are sample axes, the key's batch axes
  broadcasting against the rest;
* ``out``: ``"words"`` (``(y0, y1)``, int64, a trailing axis of 2),
  ``"bits"`` (``y0 ^ y1``, int64), ``"unit"`` (float32 in [0, 1)) or
  ``"bernoulli"`` (``unit < p``, bool; ``at`` is then
  ``p.shape[key.dim() - 1:]``).

``layout`` brings a draw to the kernel's form: ``rows`` keys, each drawing
``cols`` positions, every operand a ``(rows, cols)`` view with unit column
stride (copied only where no such view exists).  ``geometry`` picks the
block and grid.  Both are plain Python, so the CPU tests hold them, with
an emulation of the kernel, to ``prng``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import NamedTuple, Optional

import torch

from repro_torch.prng import DRAW_DTYPES, draw_dims

from . import build

NAME = "threefry_draw"
EPILOGUES = ("words", "bits", "unit", "bernoulli")
THREADS = 256
MAX_GRID_Y = 65535


def _positions() -> dict:
    """Positions a thread draws, by epilogue: csrc's ``kPositions``, read
    from the source so that the kernel and this layout share one table."""
    found = re.search(r"kPositions\[\] = \{([0-9, ]+)\}", build.source(NAME).read_text())
    return dict(zip(EPILOGUES, (int(v) for v in found.group(1).split(","))))


POSITIONS = _positions()


class Layout(NamedTuple):
    shape: tuple                    # the output's shape
    rows: int
    cols: int
    keys: torch.Tensor              # (rows, 2)
    pos: Optional[torch.Tensor]     # (rows, cols) int64 explicit positions, or None
    base: int                       # implicit positions: base + column
    p: Optional[torch.Tensor]       # (rows, cols) float32, bernoulli's


def _as_rows(t: torch.Tensor, lead: tuple, inner: tuple) -> torch.Tensor:
    """``t`` broadcast to ``lead + inner`` as a ``(rows, cols)`` view with
    unit column stride; a copy only where no such view exists."""
    v = t.expand(lead + inner).reshape(math.prod(lead), math.prod(inner))
    return v if v.shape[1] <= 1 or v.stride(1) == 1 else v.contiguous()


def row_stride(t: torch.Tensor) -> int:
    """The kernel's row stride of a ``(rows, cols)`` operand (0 for one row)."""
    return t.stride(0) if t.shape[0] > 1 else 0


def layout(key: torch.Tensor, at, ndim: int, out: str, p=None) -> Layout:
    lead, sample = draw_dims(key, at, ndim, out, p)
    pos = pt = None
    if out == "bernoulli":
        pt = _as_rows(p.detach(), lead, sample)
    elif isinstance(at, torch.Tensor):
        pos = _as_rows(at, lead, sample)
    base = at if isinstance(at, int) else 0
    shape = lead + sample + ((2,) if out == "words" else ())
    return Layout(shape, math.prod(lead), math.prod(sample), _as_rows(key, lead, (2,)), pos,
                  base, pt)


def geometry(rows: int, cols: int, out: str) -> tuple:
    """``(threads_x, threads_y, blocks_x, blocks_y)``: the fewest threads
    along a row (32 to 256) that cover its ``cols / P`` threads, the rest
    of the 256 on further rows; rows past the grid walked grid-stride."""
    need = -(-cols // POSITIONS[out])
    tx = next(t for t in (32, 64, 128, THREADS) if need <= t or t == THREADS)
    ty = THREADS // tx
    return tx, ty, -(-need // tx), min(-(-rows // ty), MAX_GRID_Y)


def vector_path(lay: Layout, res: torch.Tensor, out: str) -> bool:
    """Whether the launch may take the 16-byte path: whole vectors in every
    row, 16-byte aligned pointers and row strides."""
    def aligned(t, elems):
        return t.data_ptr() % 16 == 0 and row_stride(t) % elems == 0
    return lay.cols % POSITIONS[out] == 0 and res.data_ptr() % 16 == 0 \
        and (lay.pos is None or aligned(lay.pos, 2)) and (lay.p is None or aligned(lay.p, 4))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.threefry_draw.argtypes = [ci, vp, ll, vp, ll, ctypes.c_ulonglong, vp, ll, vp, ll, ll,
                                  ci, ci, ci, ci, vp]
    lib.threefry_draw.restype = ci
    return lib


def threefry_draw_cuda(key: torch.Tensor, at, ndim: int = 0, out: str = "bits",
                       p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One draw on the card, one launch (none for an empty draw)."""
    if key.dtype != torch.int64:
        raise TypeError(f"{NAME}: key is {key.dtype}, expected int64 (uint32 words)")
    if key.dim() == 0 or key.shape[-1] != 2 or out not in EPILOGUES:
        raise ValueError(f"{NAME}: key {tuple(key.shape)} must end in 2 words; out {out!r} "
                         f"one of {EPILOGUES}")
    if out == "bernoulli" and (p.dtype != torch.float32 or p.device != key.device):
        # torch's comparison promotes: compare the float32 uniforms as it does
        return threefry_draw_cuda(key, at, ndim, "unit") < p
    if isinstance(at, torch.Tensor) and (at.dtype != torch.int64 or at.device != key.device):
        raise TypeError(f"{NAME}: positions are {at.dtype} on {at.device}, expected int64 on "
                        f"the key's {key.device}")
    lay = layout(key, at, ndim, out, p)
    res = torch.empty(lay.shape, dtype=DRAW_DTYPES[out], device=key.device)
    if lay.rows * lay.cols == 0:
        return res
    tx, _, gx, gy = geometry(lay.rows, lay.cols, out)
    lib = _library()
    rc = build.launch(key.device, lib.threefry_draw, EPILOGUES.index(out), lay.keys.data_ptr(),
                      row_stride(lay.keys),
                      None if lay.pos is None else lay.pos.data_ptr(),
                      0 if lay.pos is None else row_stride(lay.pos), lay.base,
                      None if lay.p is None else lay.p.data_ptr(),
                      0 if lay.p is None else row_stride(lay.p), res.data_ptr(), lay.rows,
                      lay.cols, int(vector_path(lay, res, out)), tx, gx, gy)
    build.check(NAME, lib, rc)
    return res
