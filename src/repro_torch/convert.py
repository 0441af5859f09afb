"""Carry the reference package's arrays across into the port, value for value.

The reference's arrays arrive as numpy (``np.asarray`` of a JAX array); these
helpers build the port's counterparts with identical values, so that both
packages can be made to compute the same thing on the same inputs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fl.data import Dataset
from repro_torch.fl.nets import MLP, flatten_weights
from repro_torch.fl.tasks import MaskTask


def tensor(arr, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A float32 (or ``dtype``) tensor with the array's exact values: a model
    ``theta`` (d,), estimates ``theta_hat`` (n, d), a payload ``q``."""
    return torch.tensor(np.asarray(arr), dtype=dtype, device=resolve_device(device))


def key(arr, device="cuda") -> torch.Tensor:
    """A reference ``uint32[..., 2]`` threefry key as the port's int64 key."""
    return tensor(np.asarray(arr).astype(np.int64), device, torch.int64)


def dataset(x, y, device="cuda") -> Dataset:
    """A reference ``Dataset`` (x NHWC float32, y int32) as the port's."""
    return Dataset(x=tensor(x, device), y=tensor(y, device, torch.int64))


def mask_task(w0_flat, x_test, y_test, *, dims: Sequence[int],
              signed_constant: bool = True, device="cuda", **kw) -> MaskTask:
    """A ``MaskTask`` over an MLP of layer ``dims`` with the reference's
    flattened frozen weights ``w0_flat`` (``ravel_pytree`` order)."""
    net = MLP(dims, signed_constant=signed_constant, device=device)
    w0 = tensor(w0_flat, device)
    _, unravel = flatten_weights(net.frozen_weights())
    with torch.no_grad():
        for buf, w in zip(net.frozen_weights(), unravel(w0)):
            buf.copy_(w)
    return MaskTask(net=net, w0_flat=w0, unravel=unravel,
                    x_test=tensor(x_test, device),
                    y_test=tensor(y_test, device, torch.int64), **kw)
