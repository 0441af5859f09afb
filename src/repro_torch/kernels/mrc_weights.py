"""MRC importance log-weights over fixed-size blocks, and the fixed-block
encoder fused around them: the hand-written CUDA kernel and its plain
versions.

    logW[nb, i] = sum_s x[nb, i, s] * a[nb, s] + sum_s b[nb, s]

Port of ``repro.kernels.mrc_weights.mrc_logw_pallas`` (the TPU kernel).
The CUDA source is ``csrc/mrc_logw.cu``; its header gives the bounds and
the design.  ``kernels.build`` compiles it on first use (``nvcc``,
``sm_90a``, a plain C interface bound with ``ctypes``).  Two functions over
it:

* ``mrc_logw`` (u-fed): the candidates ``x`` ``(NB, NIS, S)`` are read from
  memory.  The counterpart of the TPU kernel and of ``core.mrc``'s
  ``logw_fn`` hook.
* ``mrc_fixed_encode`` (keyed): the whole fixed-block encoder of
  ``core.mrc.encode_fixed``.  Candidate row ``i`` of block ``j`` is
  ``uniform(fold_in(key, j), (NIS, S))[i]``, drawn in the kernel bit for bit
  as ``repro_torch.prng`` draws it, and compared with the clipped prior, so
  neither the uniforms nor ``x`` reach memory; ``shared_key`` is one
  ``(2,)`` key for the C clients or ``(C, 2)``, one per client (the PR
  variants' private candidates).  The kernel adds the Gumbel noise of
  ``select_key``, takes the argmax over the candidates and writes the chosen
  rows.  ``(indices (C, B) int64, sample (C, B, S), logw (C, B, NIS))``.

Both forms sum a row in one order, so the keyed form's logW is
bit-identical to the u-fed form fed ``prng``'s ``x``.  The ``*_ref``
functions are the plain PyTorch versions: the CPU routes of
``kernels.ops`` and the oracles the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import prng

from . import build

NAME = "mrc_logw"


def mrc_logw_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain u-fed version: x (NB, NIS, S), a/b (NB, S) -> (NB, NIS)."""
    return torch.einsum("bis,bs->bi", x, a) + b.sum(-1, keepdim=True)


def block_keys(key: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """``fold_in(key, j)`` for every block j: ``(K..., 2)`` -> ``(K..., B, 2)``."""
    ids = torch.arange(n_blocks, dtype=torch.int64, device=key.device)
    return prng.fold_in(key[..., None, :], ids)


# The plain versions draw in int64 torch ops (``prng.draw_int64``) on every
# device, so on the card they share no code with the kernels they check.

def _plain_block_keys(key: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """``block_keys`` in int64 torch ops."""
    ids = torch.arange(n_blocks, dtype=torch.int64, device=key.device)
    return prng.draw_int64(key[..., None, :], ids, 0, "words")


def block_candidates(shared_key: torch.Tensor, n_blocks: int, n_is: int,
                     size: int) -> torch.Tensor:
    """All candidate uniforms of every block: ``(K..., B, n_is, size)``."""
    return prng.draw_int64(_plain_block_keys(shared_key, n_blocks), (n_is, size), 0, "unit")


def block_gumbel(select_key: torch.Tensor, n_blocks: int, n_is: int) -> torch.Tensor:
    """The selection noise of every block: ``(K..., B, n_is)``."""
    gu = prng.draw_int64(_plain_block_keys(select_key, n_blocks), (n_is,), 0, "unit")
    return -torch.log(-torch.log(torch.clamp(gu, 1e-12, 1.0 - 1e-12)))


def mrc_fixed_encode_ref(shared_key: torch.Tensor, select_key: torch.Tensor,
                         pc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, n_is: int,
                         logw_fn=mrc_logw_ref):
    """Plain keyed version, the fixed-block encoder's unfused route: draw
    every block's ``(n_is, S)`` candidates, weigh them with ``logw_fn`` (the
    u-fed function, one call for the batch), add the Gumbel noise, take the
    argmax and gather the chosen rows.  ``pc``, ``a``, ``b`` are ``(N...,
    B, S)``; ``shared_key`` is ``(2,)`` (one draw for the batch) or ``(N...,
    2)``, and ``select_key`` ``(N..., 2)`` (or ``(2,)``).  Returns
    ``(indices (N..., B), sample (N..., B, S), logw (N..., B, n_is))``."""
    n_blocks, s = pc.shape[-2:]
    u = block_candidates(shared_key, n_blocks, n_is, s)            # (K..., B, n_is, S)
    x = (u < pc[..., None, :]).to(torch.float32)                   # (N..., B, n_is, S)
    logw = logw_fn(x.reshape(-1, n_is, s), a.reshape(-1, s).contiguous(),
                   b.reshape(-1, s).contiguous()).reshape(x.shape[:-1])
    idx = torch.argmax(logw + block_gumbel(select_key, n_blocks, n_is), dim=-1)
    chosen = torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]
    return idx, chosen, logw


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mrc_logw_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.mrc_logw_launch.restype = ci
    lib.mrc_fixed_encode_launch.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.mrc_fixed_encode_launch.restype = ci
    lib.mrc_fixed_encode_max_row_floats.argtypes = []
    lib.mrc_fixed_encode_max_row_floats.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _max_row_floats() -> int:
    """Floats of p, a and logW one client of the keyed form may stage."""
    return _library().mrc_fixed_encode_max_row_floats()


def mrc_logw_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the u-fed kernel on the current stream; raises on bad input."""
    if x.dim() != 3 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mrc_logw needs x (NB, NIS, S) and a, b (NB, S); got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    nb, nis, s = x.shape
    if tuple(a.shape) != (nb, s) or tuple(b.shape) != (nb, s):
        raise ValueError(f"mrc_logw: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"must both be ({nb}, {s}) for x {tuple(x.shape)}")
    build.check_cuda_inputs(NAME, x, x=x, a=a, b=b)
    if max(nb, nis, s) > build.INT32_MAX:
        raise ValueError(f"mrc_logw: dims {tuple(x.shape)} exceed int32")
    alloc = torch.empty if s else torch.zeros     # no element: every sum is 0
    out = alloc((nb, nis), dtype=torch.float32, device=x.device)
    lib = _library()
    rc = build.launch(x.device, lib.mrc_logw_launch, x.data_ptr(), a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), nb, nis, s)
    build.check(NAME, lib, rc)
    return out


def mrc_fixed_encode_cuda(shared_key: torch.Tensor, select_key: torch.Tensor,
                          pc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, n_is: int):
    """The keyed kernel (one launch) on the current stream; raises on bad
    input.  ``pc``, ``a``, ``b`` are ``(B, S)`` or ``(C, B, S)`` and
    ``select_key`` ``(2,)`` or ``(C, 2)`` to match; ``shared_key`` is
    ``(2,)`` (shared by the clients) or ``select_key``'s shape (one per
    client)."""
    if pc.dim() not in (2, 3) or a.shape != pc.shape or b.shape != pc.shape:
        raise ValueError(f"{NAME}: p, a, b must share one (B, S) or (C, B, S) shape; got "
                         f"{tuple(pc.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    lead = tuple(pc.shape[:-2])
    clients = pc.shape[0] if lead else 1
    n_blocks, s = pc.shape[-2:]
    build.check_cuda_inputs(NAME, pc, p=pc, a=a, b=b)
    key_stride = build.check_key(NAME, "shared_key", shared_key, ((2,), lead + (2,)), pc)
    sel_stride = build.check_key(NAME, "select_key", select_key, (lead + (2,),), pc)
    nis = int(n_is)
    if nis <= 0 or n_blocks == 0 or s == 0:
        raise ValueError(f"{NAME}: n_is ({nis}), B ({n_blocks}) and S ({s}) must be positive")
    row_floats = 2 * (-(-s // 4) * 4) + nis
    if nis * s > 2 ** 32 or max(clients * n_blocks * max(nis, s), n_blocks) > build.INT32_MAX \
            or (key_stride and clients > 65535) or row_floats > _max_row_floats():
        raise ValueError(f"{NAME}: sizes (C {clients}, B {n_blocks}, NIS {nis}, S {s}) "
                         "out of range")
    dev = pc.device
    logw = torch.empty(lead + (n_blocks, nis), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (n_blocks,), dtype=torch.int64, device=dev)
    sample = torch.empty(pc.shape, dtype=torch.float32, device=dev)
    lib = _library()
    rc = build.launch(dev, lib.mrc_fixed_encode_launch, shared_key.data_ptr(),
                      select_key.data_ptr(), pc.data_ptr(), a.data_ptr(), b.data_ptr(),
                      logw.data_ptr(), idx.data_ptr(), sample.data_ptr(), clients, n_blocks,
                      nis, s, key_stride, sel_stride)
    build.check(NAME, lib, rc)
    return idx, sample, logw
