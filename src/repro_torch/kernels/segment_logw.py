"""Segment MRC log-weights: the hand-written CUDA kernel and its plain version.

    logW[..., i, s] = sum_{e in s} where(u[i, e] < p[..., e], a[..., e], 0)
                    + sum_{e in s} b[..., e]

Port of ``repro.kernels.segment_logw.segment_logw_pallas`` (the TPU
kernel).  The CUDA source is ``csrc/segment_logw.cu``; its header gives the
bound and the design.  ``seg_ids`` must be non-decreasing from 0 (the
segment codec's contract, ``core.mrc._validate_seg_ids``): the kernel reads
each segment as one contiguous run.

Shapes: ``u`` is ``(NIS, D)``; ``p``, ``a``, ``b`` are ``(D,)`` or
``(C, D)``; ``seg_ids`` is ``(D,)``.  ``u`` is shared by the C clients
(BiCompFL-GR's common candidates), and the kernel reads it once for all of
them.  The result is ``(..., NIS, n_seg)``.

``segment_logw_ref`` is the plain PyTorch version (``where`` and
``index_add_``, bit-exact with the reference's ``segment_sum`` on the CPU):
the CPU route of ``kernels.ops.segment_logw`` and the oracle the kernel is
held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NAME = "segment_logw"


def segment_logw_ref(u: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Plain version; shapes as in the module docstring."""
    xa = torch.where(u < p[..., None, :], a[..., None, :], 0.0)
    out = xa.new_zeros(xa.shape[:-1] + (n_seg,)).index_add_(-1, seg_ids, xa)
    bsum = b.new_zeros(b.shape[:-1] + (n_seg,)).index_add_(-1, seg_ids, b)
    return out + bsum[..., None, :]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segment_logw_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                        ci, vp]
    lib.segment_logw_launch.restype = ci
    lib.segment_logw_pieces.argtypes = [ci, ci]
    lib.segment_logw_pieces.restype = ci
    return lib


def segment_logw_cuda(u: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on bad input."""
    lead = p.shape[:-1]
    if p.dim() not in (1, 2) or a.shape != p.shape or b.shape != p.shape:
        raise ValueError(f"{NAME}: p, a, b must share one (D,) or (C, D) shape; got "
                         f"{tuple(p.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    d = p.shape[-1]
    clients = p.shape[0] if p.dim() == 2 else 1
    if u.dim() != 2:
        raise ValueError(f"{NAME}: u {tuple(u.shape)} must be (NIS, D), shared by "
                         f"the clients")
    nis = u.shape[0]
    if u.shape[-1] != d or tuple(seg_ids.shape) != (d,):
        raise ValueError(f"{NAME}: u {tuple(u.shape)} and seg_ids "
                         f"{tuple(seg_ids.shape)} must end in D = {d}")
    build.check_cuda_inputs(NAME, u, u=u, p=p, a=a, b=b, seg_ids=seg_ids)
    n_seg = int(n_seg)
    if max(clients * nis * max(n_seg, 1), nis * d, d + n_seg) > build.INT32_MAX \
            or n_seg < 0:
        raise ValueError(f"{NAME}: sizes (C {clients}, NIS {nis}, D {d}, "
                         f"n_seg {n_seg}) out of range")
    lib = _library()
    pieces = lib.segment_logw_pieces(d, n_seg)
    out = torch.empty(lead + (nis, n_seg), dtype=torch.float32, device=u.device)
    part = torch.empty((clients, nis, pieces), dtype=torch.float32, device=u.device)
    bpart = torch.empty((clients, pieces), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.segment_logw_launch(
            u.data_ptr(), p.data_ptr(), a.data_ptr(), b.data_ptr(), seg_ids.data_ptr(),
            part.data_ptr(), bpart.data_ptr(), out.data_ptr(), clients, nis, d, n_seg,
            stream)
    build.check(NAME, lib, rc)
    return out
