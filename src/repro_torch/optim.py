"""Minimal functional optimizers (port of ``repro.optim``): sgd, momentum,
adam and adafactor_like, tree-generic.

Each optimizer is a pair (init_fn, update_fn):

    state  = init_fn(params)
    params, state = update_fn(grads, params, state)

``params`` is a tree of tensors: nested dicts, lists and tuples, or a bare
tensor (a one-leaf tree, as ``fl/tasks.py`` uses it).  Written expression
for expression as the reference (including the order of Adam's bias
corrections and the dtypes its arithmetic promotes to), not with
``torch.optim``, whose updates round differently.  Call ``update`` under
``torch.no_grad()`` when the parameters require grad.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt: torch's float32 sqrt on the CPU
    is not correctly rounded (one ulp off on some inputs); XLA's is.  The
    float64 sqrt rounded once to float32 is, on every device."""
    return torch.sqrt(x.double()).to(torch.float32)


# ---------------------------------------------------------------------------
# The optimizers.
# ---------------------------------------------------------------------------


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, params, state):
        return tree_map(lambda p, g: p - lr * g, params, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, params, vel):
        vel = tree_map(lambda v, g: beta * v + g, vel, grads)
        return tree_map(lambda p, v: p - lr * v, params, vel), vel

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    step: int


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return AdamState(mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params), step=0)

    def update(grads, params, state):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        # float32 powers, as the reference's ``b ** step.astype(float32)``
        dev = tree_leaves(params)[0].device
        t = torch.full((), float(step), dtype=torch.float32, device=dev)
        bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=dev) ** t
        bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=dev) ** t
        new = tree_map(lambda p, m, v: p - lr * (m / bc1) / (_sqrt(v / bc2) + eps),
                       params, mu, nu)
        return new, AdamState(mu=mu, nu=nu, step=step)

    return Optimizer(init, update)


def adafactor_like(lr: float, eps: float = 1e-30) -> Optimizer:
    """Memory-lean second-moment-factored optimizer for huge-model training.

    Keeps row/col second-moment factors for matrices (>=2D leaves; the
    factors reduce over the last two axes only, so a stacked leaf's layers
    share nothing but the row factor's mean) and full second moments for
    vectors.  The update is cast back to the parameter's dtype.
    """
    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return (torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                    device=p.device))
            return torch.zeros_like(p, dtype=torch.float32)

        return tree_map(leaf, params)

    def update(grads, params, state):
        out = []

        def leaf(p, g, s):
            g = g.to(torch.float32)
            if p.dim() >= 2:
                r, c = s
                r = 0.999 * r + 0.001 * (g * g).mean(-1)
                c = 0.999 * c + 0.001 * (g * g).mean(-2)
                denom = _sqrt(r[..., :, None] * c[..., None, :]
                              / (r.mean(-1)[..., None, None] + eps) + eps)
                upd = g / denom
                out.append((r, c))
                return (p - lr * upd).to(p.dtype)
            v = 0.999 * s + 0.001 * g * g
            out.append(v)
            return (p - lr * g / (_sqrt(v) + 1e-8)).to(p.dtype)

        new = tree_map(leaf, params, grads, state)
        states = iter(out)
        return new, tree_map(lambda _: next(states), params)

    return Optimizer(init, update)
