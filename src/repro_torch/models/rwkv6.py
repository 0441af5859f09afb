"""RWKV-6 "Finch" block: data-dependent-decay linear attention + channel mix
(port of ``repro.models.rwkv6``).

Per head h with key/value dim Dh, the time-mix recurrence over tokens t is

    S_t = diag(w_t) S_{t-1} + k_t v_t^T            (state S: (Dh, Dh))
    o_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})

with data-dependent decay w_t = exp(-exp(dd_t)) from a LoRA-style
projection of the token and a learned bonus u for the current token.

Three entry points run the mix:

* ``time_mix_prefill``: a whole prompt from the zero state, what
  ``transformer.apply_layer`` runs.  One ``kernels.ops.rwkv_time_mix`` call
  (the CUDA chunked kernel on the card).  It returns no final state: the
  kernel, like the TPU kernel it replaces, does not produce one, and
  nothing on the prefill path reads it.
* ``time_mix_chunk``: a sequence from an explicit state, returning the new
  state (plain PyTorch, per token or chunked, as the reference).
* ``decode_step``: one token, carrying the state.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_chunk import time_mix_chunked as _time_mix_chunked
from repro_torch.kernels.rwkv_chunk import time_mix_sequential as _time_mix_sequential
from .config import ArchConfig
from .layers import dtype_of, normal
from .sharding import P

DECAY_LORA = 64


class RWKVState(NamedTuple):
    s: torch.Tensor          # (B, H, Dh, Dh) time-mix matrix state, f32
    x_prev_tm: torch.Tensor  # (B, d) previous token input (time-mix shift)
    x_prev_cm: torch.Tensor  # (B, d) previous token input (channel-mix shift)


def head_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_heads, head_dim) for the RWKV time-mix (64-dim heads)."""
    dh = 64
    return cfg.d_model // dh, dh


def init_rwkv(gen: torch.Generator, cfg: ArchConfig):
    d = cfg.d_model
    h, dh = head_layout(cfg)
    dt = dtype_of(cfg)
    std = d ** -0.5
    dev = gen.device
    return {
        "mu": torch.full((5, d), 0.5, dtype=dt, device=dev),
        "mu_cm": torch.full((1, d), 0.5, dtype=dt, device=dev),
        "w_r": normal(gen, (d, d), std, dt),
        "w_k": normal(gen, (d, d), std, dt),
        "w_v": normal(gen, (d, d), std, dt),
        "w_g": normal(gen, (d, d), std, dt),
        "w_o": normal(gen, (d, d), std, dt),
        "decay_w1": normal(gen, (d, DECAY_LORA), std, dt),
        "decay_w2": normal(gen, (DECAY_LORA, d), 0.01, dt),
        "decay_bias": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "bonus_u": normal(gen, (h, dh), 0.1, torch.float32),
        "ln_x": torch.zeros((d,), dtype=dt, device=dev),
        "cm_k": normal(gen, (d, cfg.d_ff), std, dt),
        "cm_v": normal(gen, (cfg.d_ff, d), cfg.d_ff ** -0.5, dt),
    }


def rwkv_specs(cfg: ArchConfig):
    """``init_rwkv``'s specs: heads over ``model``, the FFN hidden too."""
    return {
        "mu": P(None, None), "mu_cm": P(None, None),
        "w_r": P(None, "model"), "w_k": P(None, "model"),
        "w_v": P(None, "model"), "w_g": P(None, "model"),
        "w_o": P("model", None),
        "decay_w1": P(None, None), "decay_w2": P(None, "model"),
        "decay_bias": P("model"), "bonus_u": P("model", None),
        "ln_x": P(None),
        "cm_k": P(None, "model"), "cm_v": P("model", None),
    }


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                    device="cuda") -> RWKVState:
    h, dh = head_layout(cfg)
    return RWKVState(
        s=torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        x_prev_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        x_prev_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    )


def _projections(cfg: ArchConfig, params, x: torch.Tensor, x_shift: torch.Tensor):
    """r, k, v, g, decay(w) streams for time-mix.  x: (..., d).

    The reference's formulation: the five token-shift lerps share
    ``lerp_i @ W_i = x @ W_i + ((x_shift - x) * mu_i) @ W_i``, so r/k/v/g
    are two wide (d -> 4d) matmuls.
    """
    mu = params["mu"].to(x.dtype)
    delta = x_shift - x
    ws = (params["w_r"], params["w_k"], params["w_v"], params["w_g"])
    base = x @ torch.cat(ws, dim=-1)                                 # (..., 4d)
    mu_block = torch.cat([mu[i][:, None] * w for i, w in zip((0, 1, 2, 4), ws)], dim=-1)
    r, k, v, g = (base + delta @ mu_block).chunk(4, dim=-1)
    g = F.silu(g)
    lerp_w = x + mu[3] * delta
    dd = torch.tanh(lerp_w @ params["decay_w1"]) @ params["decay_w2"]
    logw = -torch.exp(torch.clamp(dd.to(torch.float32) + params["decay_bias"], -20.0, 8.0))
    return r, k, v, g, logw  # decay w = exp(logw) in (0, 1), per channel


def _heads(x: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (h, dh))


def _group_norm(o: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head normalisation over the last axis, in f32."""
    of = o.to(torch.float32)
    mean = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, unbiased=False)
    return (o - mean) * torch.rsqrt(var + eps)


def _time_mix_out(cfg: ArchConfig, params, outs: torch.Tensor, g: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Group norm, gate and output projection of the mix ``outs`` (B, S, H, Dh)."""
    b, s, d = x.shape
    h, dh = head_layout(cfg)
    out = outs.reshape(b, s, d).to(x.dtype).reshape(b, s, h, dh)
    out = _group_norm(out).to(x.dtype).reshape(b, s, d) * (1.0 + params["ln_x"])
    return (out * g) @ params["w_o"]


def _streams(cfg: ArchConfig, params, x: torch.Tensor, x_prev: torch.Tensor):
    h, dh = head_layout(cfg)
    x_shift = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    r, k, v, g, logw = _projections(cfg, params, x, x_shift)
    rf, kf, vf = (_heads(t, h, dh).to(torch.float32) for t in (r, k, v))
    return rf, kf, vf, _heads(logw, h, dh), g


def time_mix_prefill(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Time-mix over a whole prompt from the zero state: x (B, S, d) -> out.

    The zero state's previous token is 0.  One ``ops.rwkv_time_mix`` call;
    the final state is not computed (see the module docstring).
    """
    zero = torch.zeros_like(x[:, 0])
    rf, kf, vf, logw, g = _streams(cfg, params, x, zero)
    outs = ops.rwkv_time_mix(rf, kf, vf, logw, params["bonus_u"])
    return _time_mix_out(cfg, params, outs, g, x)


def time_mix_chunk(cfg: ArchConfig, params, x: torch.Tensor, state: RWKVState,
                   *, chunk: int = 0):
    """Time-mix over a sequence from ``state``: x (B, S, d) -> (out, new_state).

    ``chunk`` (or cfg.scan_chunk) > 0 selects the chunked closed form; 0 runs
    the per-token recurrence.  Plain PyTorch: the kernel has no state input.
    """
    chunk = chunk or cfg.scan_chunk
    rf, kf, vf, logw, g = _streams(cfg, params, x, state.x_prev_tm)
    u = params["bonus_u"]
    if chunk and x.shape[1] > 1:
        outs, s_fin = _time_mix_chunked(rf, kf, vf, logw, u, state.s, chunk=chunk)
    else:
        outs, s_fin = _time_mix_sequential(rf, kf, vf, logw, u, state.s)
    out = _time_mix_out(cfg, params, outs, g, x)
    return out, RWKVState(s=s_fin, x_prev_tm=x[:, -1], x_prev_cm=state.x_prev_cm)


def channel_mix(cfg: ArchConfig, params, x: torch.Tensor, state: RWKVState):
    """RWKV channel-mix (squared-ReLU FFN with token shift)."""
    x_shift = torch.cat([state.x_prev_cm[:, None], x[:, :-1]], dim=1)
    mu = params["mu_cm"][0].to(x.dtype)
    xk = x + mu * (x_shift - x)
    out = torch.relu(xk @ params["cm_k"]).square() @ params["cm_v"]
    return out, RWKVState(s=state.s, x_prev_tm=state.x_prev_tm, x_prev_cm=x[:, -1])


def decode_step(cfg: ArchConfig, params, x: torch.Tensor, state: RWKVState):
    """One-token time-mix.  x: (B, 1, d)."""
    b = x.shape[0]
    h, dh = head_layout(cfg)
    xt = x[:, 0]
    r, k, v, g, logw = _projections(cfg, params, xt, state.x_prev_tm)
    w = torch.exp(logw)
    r, k, v, w = (_heads(t, h, dh) for t in (r, k, v, w))
    u = params["bonus_u"]
    kv = torch.einsum("bhk,bhv->bhkv", k.to(torch.float32), v.to(torch.float32))
    o = torch.einsum("bhk,bhkv->bhv", r.to(torch.float32),
                     state.s + u[None, :, :, None] * kv)
    s_new = w.to(torch.float32)[..., None] * state.s + kv
    o = _group_norm(o).to(x.dtype)
    o = o.reshape(b, cfg.d_model) * (1.0 + params["ln_x"])
    tm_out = (o * g) @ params["w_o"]
    return tm_out[:, None], RWKVState(s=s_new, x_prev_tm=xt, x_prev_cm=state.x_prev_cm)


def decode_channel_mix(cfg: ArchConfig, params, x: torch.Tensor, state: RWKVState):
    xt = x[:, 0]
    mu = params["mu_cm"][0].to(x.dtype)
    xk = xt + mu * (state.x_prev_cm - xt)
    out = torch.relu(xk @ params["cm_k"]).square() @ params["cm_v"]
    return out[:, None], RWKVState(s=state.s, x_prev_tm=state.x_prev_tm, x_prev_cm=xt)
