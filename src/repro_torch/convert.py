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
from repro_torch.fl.tasks import CFLTask, MaskTask


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


def cfl_task(theta0, x_test, y_test, *, dims: Sequence[int], device="cuda", **kw):
    """``(CFLTask, theta0)`` over an MLP of layer ``dims`` from the
    reference's flattened initial weights ``theta0`` (``ravel_pytree``
    order).  The port's own ``make_cfl_task`` draws its Kaiming normals with
    ``prng.normal``, which agrees with ``jax.random.normal`` only to a few
    ulp, so parity runs start from the reference's ``theta0`` instead."""
    net = MLP(dims, device=device)
    _, unravel = flatten_weights(net.frozen_weights())
    theta = tensor(theta0, device)
    if theta.shape != (sum(a * b for a, b in net.shapes),):
        raise ValueError(f"theta0 of shape {tuple(theta.shape)} is not an MLP {tuple(dims)}")
    task = CFLTask(net=net, unravel=unravel, d=int(theta.shape[0]),
                   x_test=tensor(x_test, device),
                   y_test=tensor(y_test, device, torch.int64), **kw)
    return task, theta


def _array_tensor(arr, device) -> torch.Tensor:
    """A tensor of the array's dtype and values (bf16 via its bit pattern)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(np.array(arr)).to(resolve_device(device))


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node


def model_params(cfg, ref_params, device="cuda"):
    """The reference's ``transformer.init_params`` tree (numpy leaves, as
    ``jax.tree.map(np.asarray, params)``) as the port's parameters.

    Values and layouts are kept (projections stay ``(d_in, d_out)``); the
    stacked ``pattern`` leaves are unstacked along axis 0 into one layer
    each (their leading axis is ``n_rep``), in the order
    ``transformer.layer_plans`` runs them.  A tree without ``embed`` (a
    config with frame inputs) gives parameters without one.
    """
    conv = lambda a: _array_tensor(a, device)  # noqa: E731
    layers = [_tree(p, conv) for p in ref_params["prefix"]]
    for stacked in ref_params["pattern"]:
        n_rep = np.asarray(_first_leaf(stacked)).shape[0]
        layers += [_tree(stacked, lambda a, r=r: conv(np.asarray(a)[r]))
                   for r in range(n_rep)]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(layers)} layers, "
                         f"the config {cfg.n_layers}")
    out = {"embed": conv(ref_params["embed"])} if "embed" in ref_params else {}
    return {**out, "layers": layers, "final_norm": conv(ref_params["final_norm"]),
            "head": conv(ref_params["head"])}
