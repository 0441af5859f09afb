"""Bernoulli KL reductions: the hand-written CUDA kernel and its plain version.

    kl(q, p) = q (log q - log p) + (1 - q) (log1p(-q) - log1p(-p)),

with q and p clipped to [1e-6, 1 - 1e-6] (the reference's
``repro.kernels.ref.bernoulli_kl_ref``).  Port of
``repro.kernels.bernoulli_kl.bernoulli_kl_pallas`` (the TPU kernel).  The
CUDA source is ``csrc/bernoulli_kl.cu``; its header gives the bound and the
design.  Three functions over it:

* ``rows``:  q, p (R, S) -> (R,) per-row sums (``ops.bernoulli_kl``);
* ``total``: q, p (n, d) -> scalar, sum over everything / n
  (``ops.bernoulli_kl_total``, the mean-only statistic);
* ``profile``: q, p (n, d) -> (d,), per-parameter cohort mean
  (``ops.bernoulli_kl_profile``).

The ``*_ref`` functions are the plain PyTorch versions: the CPU route of
``kernels.ops`` and the oracle the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bernoulli import clip01

from . import build

NAME = "bernoulli_kl"


def kl_elem_ref(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Elementwise clipped KL in the kernel's log/log1p form."""
    q = clip01(q)
    p = clip01(p)
    return q * (torch.log(q) - torch.log(p)) + (1 - q) * (torch.log1p(-q) - torch.log1p(-p))


def rows_ref(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version: q, p (R, S) -> (R,)."""
    return kl_elem_ref(q, p).sum(-1)


def total_ref(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version: q, p (n, d) -> scalar, the cohort mean of the total KL."""
    return kl_elem_ref(q, p).sum() / q.shape[0]


def profile_ref(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version: q, p (n, d) -> (d,), the cohort-mean KL per parameter."""
    return kl_elem_ref(q, p).sum(0) / q.shape[0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bernoulli_kl_rows.argtypes = [vp, vp, vp, vp, vp, ci, ci, ctypes.c_float, vp]
    lib.bernoulli_kl_rows.restype = ci
    lib.bernoulli_kl_cols.argtypes = [vp, vp, vp, ci, ci, ctypes.c_float, vp]
    lib.bernoulli_kl_cols.restype = ci
    lib.bernoulli_kl_chunk.argtypes = []
    lib.bernoulli_kl_chunk.restype = ci
    lib.chunk = lib.bernoulli_kl_chunk()   # elements per CTA of the rows form
    return lib


# The rows form's partials and ticket counters, held across calls, one set
# per (device, stream): calls on one stream run in order, so no two calls
# share a set at once; the kernel leaves every counter at 0 for the next.
_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, n_part: int, n_ticket: int) -> tuple:
    key = (device.index, stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].numel() < n_part or held[1].numel() < n_ticket:
        n_part = max(n_part, held[0].numel() if held else 0)
        n_ticket = max(n_ticket, held[1].numel() if held else 0)
        held = (torch.empty(n_part, dtype=torch.float32, device=device),
                torch.zeros(n_ticket, dtype=torch.int32, device=device))
        _SCRATCH[key] = held
    return held


def _check(q: torch.Tensor, p: torch.Tensor) -> None:
    """One pass over what the kernels take; the detailed checks (and their
    messages) run only when it fails."""
    if q.dim() == 2 and q.shape == p.shape and q.dtype == p.dtype == torch.float32 \
            and q.device == p.device and q.device.type == "cuda" \
            and q.is_contiguous() and p.is_contiguous():
        return
    if q.dim() != 2 or q.shape != p.shape:
        raise ValueError(f"{NAME} needs q and p of one 2-D shape; got "
                         f"{tuple(q.shape)}, {tuple(p.shape)}")
    build.check_cuda_inputs(NAME, q, q=q, p=p)


def _rows_launch(q: torch.Tensor, p: torch.Tensor, rows: int, s: int, scale: float,
                 shape: tuple) -> torch.Tensor:
    lib = _library()
    chunks = -(-s // lib.chunk)
    if max(rows, s) > build.INT32_MAX or chunks > 65535:
        raise ValueError(f"{NAME}: rows of {s} elements (x {rows}) are too long")
    dev = q.device
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    part = ticket = 0      # one chunk: the kernel touches neither
    if chunks > 1:
        part, ticket = (t.data_ptr() for t in _scratch(dev, build.current_stream(dev),
                                                       rows * chunks, rows))
    rc = build.launch(dev, lib.bernoulli_kl_rows, q.data_ptr(), p.data_ptr(), out.data_ptr(),
                      part, ticket, rows, s, scale)
    build.check(NAME, lib, rc)
    return out


def rows_cuda(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-row sums on the card: q, p (R, S) -> (R,)."""
    _check(q, p)
    return _rows_launch(q, p, q.shape[0], q.shape[1], 1.0, (q.shape[0],))


def total_cuda(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Cohort-mean total on the card: the rows kernel over the flat (1, n*d)
    view, scaled by the float32 reciprocal of n.  Returns a 0-d tensor."""
    _check(q, p)
    n, d = q.shape
    return _rows_launch(q, p, 1, n * d, 1.0 / n, ())


def profile_cuda(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Cohort-mean profile on the card: q, p (n, d) -> (d,)."""
    _check(q, p)
    n, d = q.shape
    if max(n, d) > build.INT32_MAX:
        raise ValueError(f"{NAME}: dims {tuple(q.shape)} exceed int32")
    out = torch.empty(d, dtype=torch.float32, device=q.device)
    lib = _library()
    rc = build.launch(q.device, lib.bernoulli_kl_cols, q.data_ptr(), p.data_ptr(),
                      out.data_ptr(), n, d, 1.0 / n)
    build.check(NAME, lib, rc)
    return out
