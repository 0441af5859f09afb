"""Bernoulli-distribution utilities (port of ``repro.core.bernoulli``).

A model of dimension d is a vector of d independent Bernoulli parameters
theta in [0, 1] (FedPM-style probabilistic masks).
"""
from __future__ import annotations

import math

import torch

# Numerical floor keeping log-ratios finite (the paper's p_j > zeta);
# every Bernoulli parameter is clipped to [EPS, 1 - EPS].
EPS = 1e-6


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clip a Bernoulli parameter into the open interval (0, 1)."""
    return torch.clamp(x, EPS, 1.0 - EPS)


def bern_kl(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Elementwise d_KL(q || p) between Bernoulli parameters (natural log)."""
    q = clip01(q)
    p = clip01(p)
    return q * torch.log(q / p) + (1.0 - q) * torch.log((1.0 - q) / (1.0 - p))


def bern_kl_bits(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Elementwise KL in bits (the unit the MRC cost model uses)."""
    return bern_kl(q, p) / math.log(2.0)


def log_ratio_coeffs(q: torch.Tensor, p: torch.Tensor):
    """Coefficients (a, b) with log(Q(x)/P(x)) = sum_e x_e * a_e + b_e.

    a = log(q/p) - log((1-q)/(1-p)) and b = log((1-q)/(1-p)), so the MRC
    importance weights are the matvec X @ a + sum(b) (``kernels.ops``).
    """
    q = clip01(q)
    p = clip01(p)
    llr1 = torch.log(q) - torch.log(p)
    llr0 = torch.log1p(-q) - torch.log1p(-p)
    return llr1 - llr0, llr0


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def inv_sigmoid(theta: torch.Tensor) -> torch.Tensor:
    """Map primal Bernoulli parameters to dual-space scores (mirror map)."""
    theta = clip01(theta)
    return torch.log(theta) - torch.log1p(-theta)
