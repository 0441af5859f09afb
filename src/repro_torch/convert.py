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
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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
    layers = [tree_map(conv, p) for p in ref_params["prefix"]]
    for stacked in ref_params["pattern"]:
        n_rep = np.asarray(tree_leaves(stacked)[0]).shape[0]
        layers += [tree_map(lambda a, r=r: conv(np.asarray(a)[r]), stacked)
                   for r in range(n_rep)]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(layers)} layers, "
                         f"the config {cfg.n_layers}")
    out = {"embed": conv(ref_params["embed"])} if "embed" in ref_params else {}
    return {**out, "layers": layers, "final_norm": conv(ref_params["final_norm"]),
            "head": conv(ref_params["head"])}


def stacked_params(ref_params, device="cuda"):
    """The reference's ``init_params`` tree (numpy leaves) as tensors in its
    own layout: ``{embed, final_norm, head, prefix, pattern}`` with the
    pattern leaves stacked over ``n_rep`` -- what the trainer holds."""
    return tree_map(lambda a: _array_tensor(a, device), ref_params)


def stack_model_params(model, params):
    """The port's parameters (``params["layers"]``, one dict per layer in
    ``transformer.layer_plans`` order) in the reference's layout, the
    inverse of ``model_params``: the prefix layers as a list, and for each
    pattern position one tree whose leaves stack its ``n_rep`` layers along
    a new axis 0.  The leaves are new tensors (``torch.stack``)."""
    n_pre, n_rep = len(model.prefix), model.n_rep
    layers = params["layers"]
    if len(layers) != n_pre + len(model.pattern) * n_rep:
        raise ValueError(f"{len(layers)} layers do not make a prefix of {n_pre} and "
                         f"{len(model.pattern)} pattern positions x {n_rep}")

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(nodes)

    pattern = [stack(*layers[n_pre + j * n_rep:n_pre + (j + 1) * n_rep])
               for j in range(len(model.pattern))]
    out = {"embed": params["embed"]} if "embed" in params else {}
    return {**out, "prefix": list(layers[:n_pre]), "pattern": pattern,
            "final_norm": params["final_norm"], "head": params["head"]}


def layer_views(model, stacked):
    """The port's ``params["layers"]`` over the reference's stacked tree:
    the prefix layers as they are, then for each pattern position its
    ``n_rep`` layers as views ``leaf[r]`` (no copy; autograd carries a
    layer's gradient back into its slice of the stacked leaf).  Build the
    views anew for each forward pass."""
    layers = list(stacked["prefix"])
    for tree in stacked["pattern"]:
        # one unbind a leaf: its backward stacks the layers' gradients once,
        # where n_rep indexings would each add a full-size zero-padded one
        unbound = [leaf.unbind(0) for leaf in tree_leaves(tree)]
        layers += [tree_unflatten(tree, [u[r] for u in unbound]) for r in range(model.n_rep)]
    return layers


def params_view(model, stacked):
    """The port's parameter dict over the reference's stacked tree, as
    ``transformer.forward`` and the losses take it (``layer_views``)."""
    out = {"embed": stacked["embed"]} if "embed" in stacked else {}
    return {**out, "layers": layer_views(model, stacked),
            "final_norm": stacked["final_norm"], "head": stacked["head"]}
