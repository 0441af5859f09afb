"""Minimal functional optimizers (port of ``repro.optim``): sgd and adam.

Each optimizer is a pair (init_fn, update_fn) over one parameter tensor:

    state  = init_fn(params)
    params, state = update_fn(grads, params, state)

Written expression for expression as the reference (including the order of
Adam's bias corrections), not with ``torch.optim.Adam``, whose update rounds
differently.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, params, state):
        return params - lr * grads, state

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    step: int


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return AdamState(mu=torch.zeros_like(params), nu=torch.zeros_like(params),
                         step=0)

    def update(grads, params, state):
        step = state.step + 1
        mu = b1 * state.mu + (1 - b1) * grads
        nu = b2 * state.nu + (1 - b2) * grads * grads
        # float32 powers, as the reference's ``b ** step.astype(float32)``
        t = torch.full((), float(step), dtype=torch.float32, device=params.device)
        bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=params.device) ** t
        bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=params.device) ** t
        # torch's float32 sqrt on the CPU is not correctly rounded (one ulp
        # off on some inputs); XLA's is.  The float64 sqrt rounded once to
        # float32 is the correctly rounded float32 sqrt on every device.
        root = torch.sqrt((nu / bc2).double()).to(torch.float32)
        new = params - lr * (mu / bc1) / (root + eps)
        return new, AdamState(mu=mu, nu=nu, step=step)

    return Optimizer(init, update)
