"""MRC importance log-weights: the hand-written CUDA kernel and its plain version.

    logW[nb, i] = sum_s x[nb, i, s] * a[nb, s] + sum_s b[nb, s]

Port of ``repro.kernels.mrc_weights.mrc_logw_pallas`` (the TPU kernel).
The CUDA source is ``csrc/mrc_logw.cu``; its header gives the bound and the
design.  ``kernels.build`` compiles it on first use (``nvcc``, ``sm_90a``,
a plain C interface bound with ``ctypes``).

``mrc_logw_ref`` is the plain PyTorch version: the CPU route of
``kernels.ops.mrc_logw`` and the oracle the kernel is held against on the
card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NAME = "mrc_logw"


def mrc_logw_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: x (NB, NIS, S), a/b (NB, S) -> (NB, NIS)."""
    return torch.einsum("bis,bs->bi", x, a) + b.sum(-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp = ctypes.c_void_p
    lib.mrc_logw_launch.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, vp]
    lib.mrc_logw_launch.restype = ctypes.c_int
    return lib


def mrc_logw_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on bad input."""
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
    out = torch.empty((nb, nis), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mrc_logw_launch(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), nb, nis, s, stream)
    build.check(NAME, lib, rc)
    return out
