"""Segment MRC log-weights and the fused segment encoder: the hand-written
CUDA kernel and its plain versions.

    logW[..., i, s] = sum_{e in s} where(u[i, e] < p[..., e], a[..., e], 0)
                    + sum_{e in s} b[..., e]

Port of ``repro.kernels.segment_logw.segment_logw_pallas`` (the TPU
kernel).  The CUDA source is ``csrc/segment_logw.cu``; its header gives the
bounds and the design.  ``seg_ids`` must be non-decreasing from 0 (the
segment codec's contract, ``core.mrc._validate_seg_ids``): the kernel reads
each segment as one contiguous run.  Three functions over it:

* ``segment_logw`` (u-fed): ``u`` ``(NIS, D)`` is read from memory; ``p``,
  ``a``, ``b`` are ``(D,)`` or ``(C, D)``; the result is ``(..., NIS,
  n_seg)``.  ``u`` is shared by the C clients (BiCompFL-GR's common
  candidates) and read once for all of them.  The counterpart of the TPU
  kernel and of the codec's ``seg_logw_fn`` hook.
* ``segment_mrc_encode`` (keyed): the whole segment encoder of
  ``core.mrc``.  Candidate row ``i`` is ``uniform(fold_in(shared_key, i),
  (D,))``, drawn in the kernel bit for bit as ``repro_torch.prng`` draws
  it, so the ``(NIS, D)`` uniforms never reach memory; ``shared_key`` is
  one ``(2,)`` key for the C clients or ``(C, 2)``, one per client (the PR
  variants' private candidates, drawn once per client); the kernel adds the
  Gumbel noise of ``select_key``, takes the argmax over the candidates and
  re-thresholds the chosen rows.  ``(indices (C, n_seg) int64, sample
  (C, D), logw (C, NIS, n_seg))``.
* ``segment_select``: the chosen rows' re-threshold alone, the decoder:
  ``sample[c, e] = uniform(fold_in(key[c], idx[c, seg[e]]), (D,))[e] < p[c, e]``
  (``key[c] = key`` under one shared key).

The ``*_ref`` functions are the plain PyTorch versions: the CPU routes of
``kernels.ops`` and the oracles the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import prng

from . import build

NAME = "segment_logw"


def segment_logw_ref(u: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Plain u-fed version; shapes as in the module docstring."""
    xa = torch.where(u < p[..., None, :], a[..., None, :], 0.0)
    out = xa.new_zeros(xa.shape[:-1] + (n_seg,)).index_add_(-1, seg_ids, xa)
    bsum = b.new_zeros(b.shape[:-1] + (n_seg,)).index_add_(-1, seg_ids, b)
    return out + bsum[..., None, :]


def segment_candidates(shared_key: torch.Tensor, n_is: int, d: int) -> torch.Tensor:
    """Candidate uniforms ``(K..., n_is, d)``: row r is ``uniform(fold_in(key, r), (d,))``.

    The plain versions draw in int64 torch ops (``prng.draw_int64``) on
    every device, so on the card they share no code with the kernels they
    check."""
    rows = torch.arange(n_is, dtype=torch.int64, device=shared_key.device)
    keys = prng.draw_int64(shared_key[..., None, :], rows, 0, "words")
    return prng.draw_int64(keys, (d,), 0, "unit")


def segment_mrc_encode_ref(shared_key: torch.Tensor, select_key: torch.Tensor,
                           pc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                           seg_ids: torch.Tensor, n_is: int, n_seg: int,
                           seg_logw_fn=segment_logw_ref):
    """Plain keyed version, the segment encoder's unfused route: draw the
    ``(n_is, d)`` candidates, weigh them with ``seg_logw_fn`` (the u-fed
    function), add the Gumbel noise, take the argmax and gather the chosen
    rows.  ``pc``, ``a``, ``b`` are ``(N..., d)`` and ``select_key``
    ``(N..., 2)``; ``shared_key`` is ``(2,)`` (one draw for the batch) or
    ``(C, 2)`` with ``(C, d)`` coefficients (one draw, and one
    ``seg_logw_fn`` call, per client).  Returns ``(indices (N..., n_seg),
    sample (N..., d), logw (N..., n_is, n_seg))``."""
    d = pc.shape[-1]
    u = segment_candidates(shared_key, n_is, d)                    # (K..., n_is, d)
    if shared_key.dim() == 1:
        logw = seg_logw_fn(u, pc, a, b, seg_ids, n_seg)            # (N..., n_is, n_seg)
    else:
        logw = torch.stack([seg_logw_fn(u[c], pc[c], a[c], b[c], seg_ids, n_seg)
                            for c in range(u.shape[0])])
    gu = prng.draw_int64(select_key, (n_is, n_seg), 0, "unit")     # (N..., n_is, n_seg)
    gumbel = -torch.log(-torch.log(torch.clamp(gu, 1e-12, 1.0 - 1e-12)))
    idx = torch.argmax(logw + gumbel, dim=-2)                      # (N..., n_seg)
    rows = idx[..., seg_ids.to(torch.int64)]                       # (N..., d)
    u = u.expand(rows.shape[:-1] + u.shape[-2:])                     # (N..., n_is, d)
    u_sel = torch.take_along_dim(u, rows[..., None, :], dim=-2)[..., 0, :]  # (N..., d)
    return idx, (u_sel < pc).to(torch.float32), logw


def segment_select_ref(shared_key: torch.Tensor, indices: torch.Tensor, pc: torch.Tensor,
                       seg_ids: torch.Tensor) -> torch.Tensor:
    """Plain decoder: re-threshold the chosen rows only, ``(N..., d)``
    (O(d), not O(d * n_is))."""
    d = pc.shape[-1]
    rows = indices.to(torch.int64)[..., seg_ids.to(torch.int64)]  # (N..., d)
    keys = prng.draw_int64(shared_key[..., None, :], rows & prng.MASK32, 0, "words")
    cols = torch.arange(d, dtype=torch.int64, device=pc.device)
    return (prng.draw_int64(keys, cols, 0, "unit") < pc).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segment_logw_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.segment_logw_launch.restype = ci
    lib.segment_mrc_encode_launch.argtypes = [vp] * 11 + [ci] * 5 + [vp]
    lib.segment_mrc_encode_launch.restype = ci
    lib.segment_select_launch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.segment_select_launch.restype = ci
    lib.segment_logw_pieces.argtypes = [ci, ci]
    lib.segment_logw_pieces.restype = ci
    return lib


def _check_sizes(clients: int, nis: int, d: int, n_seg: int) -> None:
    if n_seg < 0 or d >= 2 ** 32 or max(clients * nis * max(n_seg, 1), nis * d,
                                        clients * d, d + n_seg) > build.INT32_MAX:
        raise ValueError(f"{NAME}: sizes (C {clients}, NIS {nis}, D {d}, n_seg {n_seg}) "
                         "out of range")


def _coeffs(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(clients, d) of the (D,) or (C, D) p, a, b."""
    if p.dim() not in (1, 2) or a.shape != p.shape or b.shape != p.shape:
        raise ValueError(f"{NAME}: p, a, b must share one (D,) or (C, D) shape; got "
                         f"{tuple(p.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    return (p.shape[0] if p.dim() == 2 else 1), p.shape[-1]


def _pieces(lib, clients: int, nis: int, d: int, n_seg: int, device) -> tuple:
    n = lib.segment_logw_pieces(d, n_seg)
    return (torch.empty((clients, nis, n), dtype=torch.float32, device=device),
            torch.empty((clients, n), dtype=torch.float32, device=device))


def segment_logw_cuda(u: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """The u-fed kernel on the current stream; raises on bad input."""
    clients, d = _coeffs(p, a, b)
    if u.dim() != 2:
        raise ValueError(f"{NAME}: u {tuple(u.shape)} must be (NIS, D), shared by "
                         f"the clients")
    nis = u.shape[0]
    if u.shape[-1] != d or tuple(seg_ids.shape) != (d,):
        raise ValueError(f"{NAME}: u {tuple(u.shape)} and seg_ids "
                         f"{tuple(seg_ids.shape)} must end in D = {d}")
    build.check_cuda_inputs(NAME, u, u=u, p=p, a=a, b=b, seg_ids=seg_ids)
    n_seg = int(n_seg)
    _check_sizes(clients, nis, d, n_seg)
    lib = _library()
    alloc = torch.empty if d else torch.zeros     # no parameter: every sum is 0
    out = alloc(p.shape[:-1] + (nis, n_seg), dtype=torch.float32, device=u.device)
    part, bpart = _pieces(lib, clients, nis, d, n_seg, u.device)
    rc = build.launch(u.device, lib.segment_logw_launch, u.data_ptr(), p.data_ptr(),
                      a.data_ptr(), b.data_ptr(), seg_ids.data_ptr(), part.data_ptr(),
                      bpart.data_ptr(), out.data_ptr(), clients, nis, d, n_seg)
    build.check(NAME, lib, rc)
    return out


def segment_mrc_encode_cuda(shared_key: torch.Tensor, select_key: torch.Tensor,
                            pc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                            seg_ids: torch.Tensor, n_is: int, n_seg: int):
    """The keyed kernel (three launches) on the current stream; raises on
    bad input.  ``pc``, ``a``, ``b`` are ``(D,)`` or ``(C, D)`` and
    ``select_key`` ``(2,)`` or ``(C, 2)`` to match; ``shared_key`` is
    ``(2,)`` (shared by the clients) or ``select_key``'s shape (one per client)."""
    clients, d = _coeffs(pc, a, b)
    lead = pc.shape[:-1]
    if tuple(seg_ids.shape) != (d,):
        raise ValueError(f"{NAME}: seg_ids {tuple(seg_ids.shape)} must be (D,) = ({d},)")
    build.check_cuda_inputs(NAME, pc, p=pc, a=a, b=b, seg_ids=seg_ids)
    stride = build.check_key(NAME, "shared_key", shared_key, ((2,), tuple(lead) + (2,)), pc)
    build.check_key(NAME, "select_key", select_key, (tuple(lead) + (2,),), pc)
    nis, n_seg = int(n_is), int(n_seg)
    if nis <= 0 or d == 0:
        raise ValueError(f"{NAME}: n_is ({nis}) and D ({d}) must be positive")
    _check_sizes(clients, nis, d, n_seg)
    lib = _library()
    dev = pc.device
    logw = torch.empty(lead + (nis, n_seg), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (n_seg,), dtype=torch.int64, device=dev)
    sample = torch.empty(lead + (d,), dtype=torch.float32, device=dev)
    part, bpart = _pieces(lib, clients, nis, d, n_seg, dev)
    rc = build.launch(dev, lib.segment_mrc_encode_launch, shared_key.data_ptr(),
                      select_key.data_ptr(), pc.data_ptr(), a.data_ptr(), b.data_ptr(),
                      seg_ids.data_ptr(), part.data_ptr(), bpart.data_ptr(),
                      logw.data_ptr(), idx.data_ptr(), sample.data_ptr(), clients, nis, d,
                      n_seg, stride)
    build.check(NAME, lib, rc)
    return idx, sample, logw


def segment_select_cuda(shared_key: torch.Tensor, indices: torch.Tensor, pc: torch.Tensor,
                        seg_ids: torch.Tensor) -> torch.Tensor:
    """The select pass alone on the current stream: ``indices`` ``(N...,
    n_seg)`` int64, ``pc`` ``(N..., D)`` -> ``(N..., D)``; ``shared_key``
    ``(2,)`` or ``(N..., 2)``, one per row; raises on bad input."""
    d = pc.shape[-1]
    lead = pc.shape[:-1]
    if pc.dim() < 1 or indices.shape[:-1] != lead or tuple(seg_ids.shape) != (d,):
        raise ValueError(f"{NAME}: indices {tuple(indices.shape)}, p {tuple(pc.shape)} "
                         f"and seg_ids {tuple(seg_ids.shape)} do not match")
    build.check_cuda_inputs(NAME, pc, p=pc, seg_ids=seg_ids)
    stride = build.check_key(NAME, "shared_key", shared_key, ((2,), tuple(lead) + (2,)), pc)
    if indices.dtype != torch.int64 or indices.device != pc.device \
            or not indices.is_contiguous():
        raise ValueError(f"{NAME}: indices must be contiguous int64 on {pc.device}")
    n_seg = indices.shape[-1]
    clients = pc.numel() // d if d else 0
    _check_sizes(clients, 1, d, n_seg)
    lib = _library()
    sample = torch.empty(pc.shape, dtype=torch.float32, device=pc.device)
    rc = build.launch(pc.device, lib.segment_select_launch, shared_key.data_ptr(),
                      indices.data_ptr(), pc.data_ptr(), seg_ids.data_ptr(),
                      sample.data_ptr(), clients, d, n_seg, stride)
    build.check(NAME, lib, rc)
    return sample
