"""Stochastic quantizers and baseline compressors (port of ``repro.core.quantizers``).

The CFL path of BiCompFL composes a stochastic quantizer -- which turns a
real gradient into a vector of Bernoulli posteriors -- with MRC:

* ``stochastic_sign``: the paper's stochastic SignSGD posterior
  q_e = sigmoid(g_e / K), values {+1, -1};
* ``qsgd``: the Q_s of Alistarh et al. (2017) with s levels; the
  fractional part is the Bernoulli posterior;
* the deterministic compressors of the baselines: ``sign_compress``,
  ``topk_compress`` and ``randk_compress``, and their bit costs.

Every function works on the last axis and is batched over the leading ones
(the reference's ``vmap`` over clients); on a flat vector it is the
reference's function.  Means over a vector are the sum times the float32
reciprocal of its length, as XLA rounds ``jnp.mean``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import prng
from .bernoulli import clip01


def mean_abs(g: torch.Tensor) -> torch.Tensor:
    """``mean(|g|)`` over the last axis (kept), rounded as the reference's
    ``jnp.mean``: the sum times the float32 reciprocal of the length.  The
    sum runs in torch's order, so it agrees with XLA's to a few ulp."""
    return torch.abs(g).sum(dim=-1, keepdim=True) * torch.full(
        (), 1.0 / g.shape[-1], dtype=g.dtype, device=g.device)


# ---------------------------------------------------------------------------
# Stochastic quantizers (gradient -> Bernoulli posterior).
# ---------------------------------------------------------------------------


class SignPosterior(NamedTuple):
    q: torch.Tensor  # Bernoulli parameter of "take +1"

    def value(self, bits: torch.Tensor) -> torch.Tensor:
        """Map MRC bits {0, 1} (or their mean in [0, 1]) to gradient values."""
        return 2.0 * bits - 1.0


def stochastic_sign(g: torch.Tensor, *, temperature=1.0) -> SignPosterior:
    """Stochastic SignSGD: q_e = sigmoid(g_e / K); ``temperature`` K is a
    number or a tensor that broadcasts against ``g``."""
    return SignPosterior(q=clip01(torch.sigmoid(g / temperature)))


class QsgdPosterior(NamedTuple):
    q: torch.Tensor      # Bernoulli parameter ("round up")
    norm: torch.Tensor   # ||g|| (scalar side information; kept axis)
    sign: torch.Tensor   # sign(g), ternary
    tau: torch.Tensor    # lower level index per entry
    s: int               # number of quantization levels

    def value(self, bits: torch.Tensor) -> torch.Tensor:
        """Reconstruct ||g|| * sign(g) * (tau + bits) / s."""
        return self.norm * self.sign * (self.tau + bits) / self.s


def qsgd(g: torch.Tensor, *, s: int) -> QsgdPosterior:
    """Q_s of Alistarh et al.: unbiased stochastic quantization to s levels."""
    norm = torch.sqrt((g * g).sum(dim=-1, keepdim=True)) + 1e-12
    r = torch.abs(g) / norm * s            # in [0, s]
    tau = torch.clamp(torch.floor(r), 0, s - 1)
    return QsgdPosterior(q=clip01(r - tau), norm=norm, sign=torch.sign(g), tau=tau, s=s)


def qsgd_sample(key: torch.Tensor, post: QsgdPosterior) -> torch.Tensor:
    """Draw the native (non-MRC) Q_s sample: ``bernoulli(key, q)`` mapped back."""
    bits = prng.bernoulli(key, post.q).to(torch.float32)
    return post.value(bits)


# ---------------------------------------------------------------------------
# Deterministic baseline compressors.
# ---------------------------------------------------------------------------


def sign_compress(g: torch.Tensor) -> torch.Tensor:
    """1-bit SignSGD with magnitude scaling (mean-|g| scale, as in MemSGD).

    The sign is *binary* (zero maps to +1), not ternary ``torch.sign``: the
    booked rate is 1 bit/param + one scale, and only a two-valued sign is
    representable at that rate.
    """
    return mean_abs(g) * torch.where(g >= 0, 1.0, -1.0)


def topk_indices(g: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest |g| on the last axis, ties to the lower
    index first, as ``lax.top_k`` breaks them (a stable descending sort)."""
    order = torch.sort(torch.abs(g), dim=-1, descending=True, stable=True).indices
    return order[..., :min(k, g.shape[-1])]


def topk_compress(g: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest-magnitude entries (biased, contractive)."""
    idx = topk_indices(g, k)
    return torch.zeros_like(g).scatter(-1, idx, torch.gather(g, -1, idx))


def randk_compress(key: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Keep k uniformly random entries, rescaled by d/k (unbiased); ``key``
    ``(K..., 2)`` draws the entries of the row it is batched with."""
    d = g.shape[-1]
    idx = prng.choice(key, d, (k,), replace=False)
    return torch.zeros_like(g).scatter(-1, idx, torch.gather(g, -1, idx) * (d / k))


# Bit costs of the baseline compressors (32-bit floats, index cost
# ceil(log2 d) for sparse methods), booked by the channels.
FLOAT_BITS = 32


def sign_bits(d: int) -> float:
    return float(d) + FLOAT_BITS  # 1 bit/param + one scale


def dense_bits(d: int) -> float:
    return float(d) * FLOAT_BITS


def topk_bits(d: int, k: int) -> float:
    return k * (FLOAT_BITS + math.ceil(math.log2(max(d, 2))))
