"""Routing wrappers around the port's kernels (port of ``repro.kernels.ops``).

``mrc_logw`` takes the plain PyTorch version for a tensor on the CPU and the
hand-written CUDA kernel for a tensor on the card; it never falls back from
one to the other.  ``mrc_logw.launches`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from .mrc_weights import mrc_logw_cuda, mrc_logw_ref


def mrc_logw(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """logW = X @ a + sum(b); x (NB, NIS, S), a/b (NB, S) -> (NB, NIS).

    Drop-in ``logw_fn`` for ``repro_torch.core.mrc.encode_fixed`` (and its
    default there).  NIS and S may be ragged: the kernel needs no padding.
    """
    if x.device.type == "cpu":
        return mrc_logw_ref(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"mrc_logw runs on cpu or cuda, not {x.device}")
    out = mrc_logw_cuda(x, a, b)
    mrc_logw.launches += 1
    return out


mrc_logw.launches = 0


def mrc_logw_fn():
    """The ``logw_fn`` hook for ``encode_fixed`` (the kernel route)."""
    return mrc_logw
