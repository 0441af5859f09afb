"""Mamba (S6 selective state-space) block for the Jamba hybrid (port of
``repro.models.mamba``).

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t     (per channel, d_state wide)
    y_t = C_t h_t + D x_t

with input-dependent (selective) dt, B, C.  ``mamba_block`` runs a whole
sequence from a state, ``decode_step`` one token; decode carries (conv
window, ssm state), O(1) per token.

The reference's ``lax.scan`` over the sequence is a Python loop over tokens
here, the same recurrence in the same order.  The step's elementwise inputs
(``exp(dt A)`` and ``dt B x``) are formed for ``SCAN_CHUNK`` tokens at a
time, so that a token costs the update ``h = exp(dt A) h + dt B x`` and the
read-out ``C h`` (``_ssm_step``, which ``decode_step`` runs too).  No TPU
kernel stands behind the scan.  On the ``meta`` device (the dry run) one
token step of each chunk is traced and counted as the chunk's steps
(``kernels.cost.repeated``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import cost
from .config import ArchConfig
from .layers import dtype_of, normal, uniform
from .sharding import P

SCAN_CHUNK = 256


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) trailing inputs for the conv
    ssm: torch.Tensor   # (B, d_inner, d_state) recurrent state, float32


def dt_rank(cfg: ArchConfig) -> int:
    return max(cfg.d_model // 16, 1)


def init_mamba(gen: torch.Generator, cfg: ArchConfig):
    """The reference's names and layouts; ``dt_proj_b``, ``A_log`` and ``D``
    are float32 in every model dtype."""
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    r = dt_rank(cfg)
    dt = dtype_of(cfg)
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = lo + (hi - lo) * uniform(gen, (di,))
    return {
        "in_proj": normal(gen, (d, 2 * di), d ** -0.5, dt),
        "conv_w": normal(gen, (dc, di), dc ** -0.5, dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": normal(gen, (di, r + 2 * ds), di ** -0.5, dt),
        "dt_proj_w": normal(gen, (r, di), r ** -0.5, dt),
        "dt_proj_b": torch.log(torch.exp(torch.exp(u) - 1.0) + 1e-9),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
                           .expand(di, ds).contiguous()),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": normal(gen, (di, d), di ** -0.5, dt),
    }


def mamba_specs(cfg: ArchConfig):
    """``init_mamba``'s specs: d_inner over ``model`` (the inner channels
    are independent, so the scan needs no cross-shard communication)."""
    return {
        "in_proj": P(None, "model"), "conv_w": P(None, "model"),
        "conv_b": P("model"), "x_proj": P("model", None),
        "dt_proj_w": P(None, "model"), "dt_proj_b": P("model"),
        "A_log": P("model", None), "D": P("model"),
        "out_proj": P("model", None),
    }


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state), dtype=torch.float32,
                        device=device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` (``F.softplus`` rounds
    differently in a few percent of float32 inputs)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _selective(cfg: ArchConfig, params, xc: torch.Tensor):
    """dt, B, C streams from the conv output.  xc: (..., d_inner)."""
    r, ds = dt_rank(cfg), cfg.mamba_d_state
    proj = xc @ params["x_proj"]
    dt_in, bb, cc = torch.split(proj, [r, ds, ds], dim=-1)
    dt = softplus((dt_in @ params["dt_proj_w"]).to(torch.float32) + params["dt_proj_b"])
    return dt, bb.to(torch.float32), cc.to(torch.float32)


def _discretize(dt, a, x, b):
    """exp(dt A) and dt B x for one token or a run of them: dt, x (..., di),
    a (di, ds), b (..., ds) -> two (..., di, ds) float32 tensors."""
    return torch.exp(dt[..., None] * a), (dt * x)[..., None] * b[..., None, :]


def _ssm_step(h, da, dbx, c):
    """h (B, di, ds) -> (da h + dbx, its read-out C h (B, di))."""
    h = torch.addcmul(dbx, da, h)
    return h, torch.bmm(h, c[..., None])[..., 0]


def mamba_block(cfg: ArchConfig, params, x: torch.Tensor, state: MambaState):
    """Full-sequence Mamba.  x: (B, S, d) -> (y, new_state)."""
    b, s, d = x.shape
    dc = cfg.mamba_d_conv

    xz = x @ params["in_proj"]                                    # (B, S, 2*di)
    xi, z = xz.chunk(2, dim=-1)

    # depthwise causal conv over time, warm-started from state.conv; the
    # taps are summed in the order decode_step sums them
    xpad = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    conv = sum(xpad[:, i:i + s] * params["conv_w"][i] for i in range(dc))
    xc = F.silu(conv + params["conv_b"])

    dt, bb, cc = _selective(cfg, params, xc)                      # (B,S,di),(B,S,ds)x2
    a = -torch.exp(params["A_log"])                               # (di, ds)
    xf = xc.to(torch.float32)

    h = state.ssm
    ys = []
    for t0 in range(0, s, SCAN_CHUNK):
        t1 = min(t0 + SCAN_CHUNK, s)
        da, dbx = _discretize(dt[:, t0:t1], a, xf[:, t0:t1], bb[:, t0:t1])
        if x.device.type == "meta":
            # only shapes flow: one token step traced, counted t1 - t0 times
            h, y_t = cost.repeated(_ssm_step, t1 - t0, h, da[:, 0], dbx[:, 0], cc[:, t0])
            ys.append(y_t[:, None].expand(b, t1 - t0, y_t.shape[-1]))
            continue
        for t in range(t1 - t0):
            h, y_t = _ssm_step(h, da[:, t], dbx[:, t], cc[:, t0 + t])
            ys.append(y_t[:, None])
    y = torch.cat(ys, dim=1) + xf * params["D"]
    y = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    if s >= dc - 1:
        conv_state = xi[:, s - (dc - 1):].to(state.conv.dtype)
    else:
        conv_state = torch.cat([state.conv, xi], dim=1)[:, -(dc - 1):]
    return y, MambaState(conv=conv_state, ssm=h)


def decode_step(cfg: ArchConfig, params, x: torch.Tensor, state: MambaState):
    """One-token Mamba step.  x: (B, 1, d)."""
    dc = cfg.mamba_d_conv
    xz = x[:, 0] @ params["in_proj"]
    xi, z = xz.chunk(2, dim=-1)                                   # (B, di)

    window = torch.cat([state.conv.to(xi.dtype), xi[:, None]], dim=1)   # (B, dc, di)
    # Same multiply-add order as mamba_block's sliced sum: prefill and
    # decode must agree bitwise, or the top-k MoE routing downstream turns
    # the rounding gap into different expert choices.
    conv = sum(window[:, i] * params["conv_w"][i] for i in range(dc))
    xc = F.silu(conv + params["conv_b"])

    dt, bb, cc = _selective(cfg, params, xc)
    a = -torch.exp(params["A_log"])
    xf = xc.to(torch.float32)
    h, y = _ssm_step(state.ssm, *_discretize(dt, a, xf, bb), cc)
    y = y + xf * params["D"]
    y = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return y[:, None], MambaState(conv=window[:, 1:].to(state.conv.dtype), ssm=h)
