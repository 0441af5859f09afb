"""Transformer building blocks: norms, RoPE, GQA attention, FFN (port of
``repro.models.layers``).

Parameters are plain dictionaries of tensors with the reference's names
and layouts (a projection ``w`` is ``(d_in, d_out)`` and applies as
``x @ w``), so ``convert.model_params`` carries the reference's values
across as they are.  Each ``init_*`` has a ``*_specs`` beside it that
gives the reference's partition specs for its parameters
(``models.sharding``; the dry run reads them).  The reference's
``sharding.constraint`` layout hints do no arithmetic and have no
counterpart: the port runs on one card.

``attention`` (training and prefill) goes through ``kernels.ops
.flash_attention``, once per call: the CUDA kernel on the card, the port of
the reference's chunked lazy-softmax scan on the CPU; its backward is that
scan's, recomputed.  ``decode_attention``
is plain PyTorch, as the reference computes it outside any Pallas kernel;
so are M-RoPE (Qwen2-VL's three position streams) and the int8 KV cache
(``quantize_kv``/``dequantize_kv``: int8 payloads, f16 scales per group of
16 channels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import NEG_INF
from .config import ArchConfig
from .sharding import P


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class MetaGenerator:
    """Stands in for a ``torch.Generator`` in the inits to build parameters
    on the ``meta`` device: ``normal`` and ``uniform`` draw nothing from it
    and give storage-less tensors of the shape and dtype (torch has no meta
    generator)."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
    """``N(0, std^2)`` drawn in f32 from ``gen`` on its device, then cast."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """``U[0, 1)`` f32 drawn from ``gen`` on its device."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # theta as an f32 tensor made on the device: no host-to-device copy
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, Dh); positions: broadcastable (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv            # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (..., S, H, Dh); positions3: (..., S, 3) -- (t, h, w) position ids.
    The Dh/2 frequency slots are partitioned into three contiguous sections
    (temporal / height / width); each section rotates by its own position id.
    """
    dh = x.shape[-1]
    half = dh // 2
    assert sum(sections) == half, (sections, half)
    inv = rope_freqs(dh, theta, x.device)
    # section id per frequency slot -> pick the matching position stream
    sect = torch.cat([torch.full((n,), i, dtype=torch.int64, device=x.device)
                      for i, n in enumerate(sections)])
    pos = positions3.to(torch.float32)[..., sect]                 # (..., S, Dh/2)
    ang = pos * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rotate(cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_kind == "none":
        return x
    if cfg.rope_kind == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attn(gen: torch.Generator, cfg: ArchConfig):
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    std = d ** -0.5
    params = {
        "wq": normal(gen, (d, h * dh), std, dt),
        "wk": normal(gen, (d, hk * dh), std, dt),
        "wv": normal(gen, (d, hk * dh), std, dt),
        "wo": normal(gen, (h * dh, d), std, dt),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((dh,), dtype=dt, device=gen.device)
        params["k_norm"] = torch.zeros((dh,), dtype=dt, device=gen.device)
    return params


def attn_specs(cfg: ArchConfig):
    """``init_attn``'s specs: q/k/v outputs and o's input over ``model``."""
    specs = {"wq": P(None, "model"), "wk": P(None, "model"),
             "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qk_norm:
        specs["q_norm"] = P(None)
        specs["k_norm"] = P(None)
    return specs


def kv_head_spec(cfg: ArchConfig, model_size: int, *, for_cache: bool = False) -> P:
    """Spec for a (..., Hkv, Dh) pair of trailing axes.

    GQA kv-head counts (8) are often smaller than the model axis (16).  For
    the decode cache (memory-bound) head_dim is sharded instead; training
    and prefill activations replicate the kv heads.
    """
    if cfg.n_kv_heads % max(model_size, 1) == 0:
        return P("model", None)
    if for_cache and cfg.head_dim % max(model_size, 1) == 0:
        return P(None, "model")
    return P(None, None)


def _qkv(cfg: ArchConfig, params, x: torch.Tensor):
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, hk, dh)
    v = (x @ params["wv"]).reshape(b, s, hk, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    return q, k, v


def attention(cfg: ArchConfig, params, x: torch.Tensor, positions: torch.Tensor,
              *, kv_chunk: int = 1024) -> torch.Tensor:
    """Multi-head GQA self attention (training / prefill).

    x: (B, S, d); positions: (B, S) or (1, S) (or (B, S, 3) for M-RoPE).
    One ``ops.flash_attention`` call per layer; its CPU route and its
    backward scan KV in chunks of ``min(kv_chunk, S)``, as the reference.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, params, x)
    q = rotate(cfg, q, positions)
    k = rotate(cfg, k, positions)
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window,
                              scale=cfg.head_dim ** -0.5, kv_chunk=kv_chunk)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"]


# Symmetric int8 KV quantization per group of KV_QUANT_GROUP channels, with
# f16 scales: 0.5625x of the bf16 cache footprint at Dh 128.
KV_QUANT_GROUP = 16


def _kv_groups(dh: int) -> int:
    return KV_QUANT_GROUP if dh % KV_QUANT_GROUP == 0 else dh


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int8 quantization of (B, S, Hkv, Dh).

    Returns (int8 payload (B, S, Hkv, Dh), f16 scales (B, S, Hkv, Dh/G)).
    As in the reference, the f32 scale quantizes and only its f16 rounding
    is stored (``dequantize_kv`` multiplies by that); ``torch.round``
    rounds half to even, as ``jnp.round`` does.
    """
    g = _kv_groups(t.shape[-1])
    tg = t.to(torch.float32).reshape(*t.shape[:-1], -1, g)
    scale = tg.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(tg / scale[..., None]), -127, 127)
    return q.reshape(t.shape).to(torch.int8), scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    g = _kv_groups(q.shape[-1])
    qg = q.to(torch.float32).reshape(*q.shape[:-1], -1, g)
    return (qg * scale.to(torch.float32)[..., None]).reshape(q.shape)


def decode_attention(cfg: ArchConfig, params, x: torch.Tensor, pos: int, kv_cache):
    """Single-token decode attention with an explicit validity mask.

    x: (B, 1, d); pos: the current absolute position (== tokens so far).
    kv_cache: (k, v), each (B, S_max, Hkv, Dh) -- or, with
    ``cfg.kv_cache_quant``, (k_i8, v_i8, k_scale, v_scale) with int8
    payloads and (B, S_max, Hkv, Dh/KV_QUANT_GROUP) f16 group scales --
    written in place at ``pos`` (the reference returns updated copies; in
    place saves a cache copy per layer and step) and returned in that
    order.  Positions > pos are masked.  For sliding-window configs the
    cache holds only the window and is written at ``pos % S_max`` (ring
    buffer).
    """
    b, s, _ = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = kv_cache[:2]
    s_max = ck.shape[1]
    ring = cfg.sliding_window > 0

    q, k, v = _qkv(cfg, params, x)
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    if cfg.rope_kind == "mrope":
        posv = posv[..., None].expand(b, 1, 3)
    q = rotate(cfg, q, posv)
    k = rotate(cfg, k, posv)

    # lax.dynamic_update_slice clamps its start index into the array.
    slot = pos % s_max if ring else min(pos, s_max - 1)
    at = slice(slot, slot + 1)
    if cfg.kv_cache_quant:
        ck_s, cv_s = kv_cache[2:]
        ck[:, at], ck_s[:, at] = quantize_kv(k)
        cv[:, at], cv_s[:, at] = quantize_kv(v)
        kk = dequantize_kv(ck, ck_s)
        vv = dequantize_kv(cv, cv_s)
        # The current token's k and v are still at hand in full precision;
        # only past positions pay the int8 round trip.
        kk[:, at] = k.to(torch.float32)
        vv[:, at] = v.to(torch.float32)
    else:
        ck[:, at] = k.to(ck.dtype)
        cv[:, at] = v.to(cv.dtype)
        kk, vv = ck.to(torch.float32), cv.to(torch.float32)

    rep = h // hk
    kk = kk.repeat_interleave(rep, dim=2)
    vv = vv.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * dh ** -0.5, kk)
    kpos = torch.arange(s_max, device=x.device)
    valid = kpos < min(pos + 1, s_max) if ring else kpos <= min(pos, s_max - 1)
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv).to(x.dtype)
    return out.reshape(b, s, h * dh) @ params["wo"], tuple(kv_cache)


# ---------------------------------------------------------------------------
# Dense (SwiGLU) FFN
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg: ArchConfig, d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "w_gate": normal(gen, (d, ff), d ** -0.5, dt),
        "w_up": normal(gen, (d, ff), d ** -0.5, dt),
        "w_down": normal(gen, (ff, d), ff ** -0.5, dt),
    }


def ffn_specs(cfg: ArchConfig):
    """``init_ffn``'s specs: the hidden dim over ``model``."""
    return {"w_gate": P(None, "model"), "w_up": P(None, "model"),
            "w_down": P("model", None)}


def ffn(params, x: torch.Tensor) -> torch.Tensor:
    hidden = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return hidden @ params["w_down"]
